"""A cell cut to a size a CPU test run holds: the program's own small
variant of the configuration at the file's sizes (two layers, float32) with the configuration
file's sizes rewritten to match, short traffic and a short window."""
import copy

from bench.common import find_cell
from bench.weights import program_config


def small_cell(name: str):
    """(cell, port config) of ``name`` at the small size."""
    cell = copy.deepcopy(find_cell(name))
    cfg = cell["config"]
    full = program_config(cfg)
    pc = full.reduced(tie_embeddings=full.tie_embeddings)
    cfg.update(hidden_size=pc.d_model, intermediate_size=pc.d_ff,
               num_hidden_layers=pc.num_layers,
               num_attention_heads=pc.num_heads,
               num_key_value_heads=pc.num_kv_heads, head_dim=pc.head_dim,
               vocab_size=pc.vocab_size, rms_norm_eps=pc.rms_eps,
               torch_dtype="float32")
    mix = cell["traffic"]
    if mix["kind"] == "serve":
        # two layers keep a token's own signal with a smaller embedding
        cfg["init"]["embed_std"] = 0.25
        cfg["serve"].update(max_batch=4, cache_len=256,
                            kv_num_pages=None, cache_max_bytes=1 << 28)
        cfg["checks"].update(logit_gap=1e-3, sample_min=8, sample_tokens=40)
        mix.update(clients=4, stratum=8, warm_s=0.5, grace_s=20, ramp_s=0.2)
        mix["context"]["tokens"] = 64
        mix["suffix"].update(min=8, max=32)
        mix["max_tokens"].update(min=4, max=12)
    else:
        cfg["eos_token_id"] = 3
        cfg["checks"].update(grad_gap=1e-3, change_gap=1e-2)
        mix.update(batch=2, seq=32, max_steps=16)
        mix["doc_len"].update(median=8, min=2, max=40)
    return cell, pc
