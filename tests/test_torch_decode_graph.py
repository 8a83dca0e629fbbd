"""The decode block's step over static buffers (``core/decode_graph.py``).

On the CPU (no JAX needed): the block leaves the engine's state, the KV
cache, its tokens and its logprobs exactly as the per-step loop it replaced
did, across K, the sampler's variants and mid-block stops; a CPU engine
replays no graph and serves the graph counters in ``/stats``; DTensor
parameters stay eager; recovery, which rebinds the arena, drops the runner;
a capture's launches are recorded apart from the wrappers' counters, and
only from a capturing stream.

On the card (``-m gpu``; skips without one): engines that replay captured
graphs against engines that run the same steps eagerly, request for
request — tokens identical, logprobs within 1e-3, the decode state equal
after every step, the kernel wrappers' launch counts equal — over K 1, 3
and 8, greedy and masked sampling with and without logprobs, slots frozen
and admitted between blocks, COW splits and new tail pages between replays
(an ``n`` = 2 group on paged KV), int8 pages, the dense ring, a small MoE
and a small SSM; and recovery, after which the engine captures again.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import decode_graph
from repro_torch.core.decode_graph import ADVANCED, DecodeGraphs
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import (FinishReason, GenerationRequest,
                                      Request, SamplingParams)
from repro_torch.core.sampling import masked_sample_inner
from repro_torch.kernels import build
from repro_torch.models.model import Model, tree_leaves, tree_map
from repro_torch.serving.tokenizer import ByteTokenizer
from torch_threads import one_torch_thread  # noqa: F401


def _prompts(n, seed=0, lens=(5, 40, 70, 17, 3, 33, 21, 9)):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 256, size=lens[i % len(lens)])]
            for i in range(n)]


def _old_block(eng, num_steps, want_logprobs, any_stochastic, any_mask):
    """The decode block as a per-step loop that rebinds the state's fields:
    the engine's code before the static buffers, kept as the reference."""
    st, n_top = eng.state, eng.max_top_logprobs
    page_table = eng.pool.cache["page_table"] if eng._paged else None
    ctx_valid = st.ctx_valid if eng.media_kind != "none" else None
    toks, lp_c, lp_v, lp_i = [], [], [], []
    for _ in range(num_steps):
        out = eng.model.apply(
            eng.params, st.last_token[:, None], mode="decode",
            positions=st.positions[:, None], cache=eng.pool.cache,
            slot_active=st.active, page_table=page_table,
            ctx_valid=ctx_valid)
        logits = out.logits[:, 0]
        act = st.active
        nxt = masked_sample_inner(
            logits, st.sample_key, st.positions + 1, st.temps * act,
            torch.where(act, st.top_p, 1.0),
            torch.where(act, st.top_k, 0),
            torch.where(act, st.min_p, 0.0),
            any_stochastic=any_stochastic, any_mask=any_mask)
        nxt = torch.where(act, nxt, st.last_token)
        toks.append(torch.where(act, nxt, -1))
        alive = act.long()
        st.budget = st.budget - alive
        hit_stop = (nxt[:, None] == st.stop_tokens).any(-1)
        finished = act & (hit_stop | (st.budget <= 0))
        st.last_token = nxt
        st.positions = st.positions + alive
        st.active = act & ~finished
        if want_logprobs:
            lp = torch.log_softmax(logits.float(), dim=-1)
            lp_c.append(torch.gather(lp, 1, nxt[:, None])[:, 0])
            top = torch.topk(lp, n_top, dim=-1)
            lp_v.append(top.values)
            lp_i.append(top.indices)
    lps = ((torch.stack(lp_c), torch.stack(lp_v), torch.stack(lp_i))
           if want_logprobs else None)
    return torch.stack(toks), lps


def _state_copy(eng):
    return {f.name: getattr(eng.state, f.name).clone()
            for f in dataclasses.fields(eng.state)}


# --------------------------------------------------------------------------- #
# on the CPU
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def small():
    cfg = get_config("qwen2-0.5b").reduced()
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    return cfg, params


def _live_engine(small, layout, sampling):
    """An engine with four live slots of different budgets (two end inside
    an 8-step block) and stop tokens, after its admissions committed."""
    cfg, params = small
    kw = {"kv_layout": "paged"} if layout == "paged" else {}
    eng = InferenceEngine(cfg, params, device="cpu", max_batch=5,
                          cache_len=128, max_decode_block=8,
                          speculative_fill=False, **kw)
    for i, p in enumerate(_prompts(4)):
        eng.add_request(Request(prompt_tokens=p, sampling=SamplingParams(
            max_tokens=(3, 20, 6, 20)[i], stop_token_ids=(7, 300),
            **sampling)))
    while len(eng._live_slots) < 4:
        eng.step()
    return eng


SAMPLING = {
    "greedy": ({}, (False, False, False)),
    "greedy-logprobs": ({"logprobs": True, "top_logprobs": 3},
                        (True, False, False)),
    "sampled-masked-logprobs": ({"temperature": 0.8, "top_p": 0.9,
                                 "top_k": 40, "logprobs": True,
                                 "top_logprobs": 2}, (True, True, True)),
    "sampled": ({"temperature": 1.1}, (False, True, False)),
}


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_block_matches_the_per_step_loop(small, layout, k, sampling):
    """From one engine state: the static-buffer block and the old loop give
    the same tokens (frozen slots -1), logprobs, decode state and KV
    cache, bit for bit, with slots stopping inside the block."""
    kw, variant = SAMPLING[sampling]
    eng = _live_engine(small, layout, kw)
    state0 = _state_copy(eng)
    cache0 = tree_map(torch.clone, eng.pool.cache)
    toks, lps = eng._decode_block(k, *variant)
    toks, lps = toks.clone(), lps and tuple(a.clone() for a in lps)
    state, cache = _state_copy(eng), tree_map(torch.clone, eng.pool.cache)
    for name, value in state0.items():
        getattr(eng.state, name).copy_(value)
    for dst, src in zip(tree_leaves(eng.pool.cache), tree_leaves(cache0)):
        dst.copy_(src)
    ref_toks, ref_lps = _old_block(eng, k, *variant)
    assert torch.equal(toks, ref_toks)
    if k == 8:
        assert (toks == -1).any()          # a slot froze inside the block
    assert (lps is None) == (ref_lps is None)
    for a, b in zip(lps or (), ref_lps or ()):
        assert torch.equal(a, b)
    for name, value in state.items():
        assert torch.equal(value, getattr(eng.state, name)), name
    for a, b in zip(tree_leaves(cache), tree_leaves(eng.pool.cache)):
        assert torch.equal(a, b)


def test_block_writes_the_state_in_place(small):
    """The advanced fields are the engine's own tensors, written in place
    (an admission's scatter into them reaches the next block), and the
    returned block is a view of the runner's block buffer."""
    eng = _live_engine(small, "dense", {})
    held = {n: getattr(eng.state, n) for n in ADVANCED}
    toks, _ = eng._decode_block(2, False, False, False)
    assert all(getattr(eng.state, n) is t for n, t in held.items())
    assert toks.data_ptr() == eng._decode_graphs.block[0].data_ptr()


def test_cpu_engine_replays_nothing_and_serves_the_counters(small):
    from repro_torch.serving.api import OpenAIServer
    from repro_torch.serving.client import EngineClient
    cfg, params = small
    eng = InferenceEngine(cfg, params, device="cpu", max_batch=2,
                          cache_len=128, max_decode_block=4)
    eng.generate([Request(prompt_tokens=p,
                          sampling=SamplingParams(max_tokens=6))
                  for p in _prompts(3)])
    st = eng.scheduler.stats
    assert st.device_steps > 0
    assert (st.decode_graph_steps, st.decode_graph_captures) == (0, 0)
    assert not eng._decode_graphs.use_graphs
    stats = OpenAIServer(EngineClient(eng)).stats()
    assert stats["decode_graph_steps"] == 0
    assert stats["decode_graph_captures"] == 0
    assert stats["device_steps"] == st.device_steps


def test_graphs_need_cuda_and_plain_parameters(small):
    """Capture is chosen from what the engine observes: the device and
    whether a parameter is a DTensor (those runs stay eager)."""
    from torch.distributed.tensor import Replicate, distribute_tensor
    from repro_torch.launch.mesh import make_host_mesh
    _, params = small
    cuda = torch.device("cuda")
    assert decode_graph.graphs_usable(cuda, params)
    assert not decode_graph.graphs_usable(torch.device("cpu"), params)
    with make_host_mesh(device="cpu") as mesh:
        sharded = dict(params, embed=distribute_tensor(
            params["embed"], mesh, [Replicate(), Replicate()]))
        assert not decode_graph.graphs_usable(cuda, sharded)


def test_recovery_and_rebound_parameters_drop_the_runner(small):
    cfg, params = small
    eng = InferenceEngine(cfg, params, device="cpu", max_batch=2,
                          cache_len=64, kv_layout="paged")
    reqs = [Request(prompt_tokens=p, sampling=SamplingParams(max_tokens=8))
            for p in _prompts(2)]
    for r in reqs:
        eng.add_request(r)
    while eng._decode_graphs is None:
        eng.step()
    old = eng._decode_graphs
    assert old.cache is eng.pool.cache and old.params is eng.params
    eng._recover_decode_block(RuntimeError("injected"))
    assert eng._decode_graphs is None
    assert all(r.finish_reason is FinishReason.ERROR for r in reqs)
    fresh = [Request(prompt_tokens=p, sampling=SamplingParams(max_tokens=5))
             for p in _prompts(2, seed=1)]
    eng.generate(fresh)
    runner = eng._decode_graphs
    # the rebound arena is the one the new runner reads
    assert runner is not old and runner.cache is eng.pool.cache
    assert old.cache is not eng.pool.cache
    alone = InferenceEngine(cfg, params, device="cpu", max_batch=2,
                            cache_len=64, kv_layout="paged")
    again = [Request(prompt_tokens=p, sampling=SamplingParams(max_tokens=5))
             for p in _prompts(2, seed=1)]
    alone.generate(again)
    assert [r.output_tokens for r in fresh] == \
        [r.output_tokens for r in again]
    eng.generate([Request(prompt_tokens=[5, 6, 7],
                          sampling=SamplingParams(max_tokens=3))])
    assert eng._decode_graphs is runner        # kept while the arena is


def test_recorded_launches_stay_off_the_counters(monkeypatch):
    """Inside ``recording_launches`` a thread's launches go to its table
    while its stream captures, and raise while it does not (the launch
    would not be in the graph); another thread's still count;
    ``add_launches`` adds the table."""
    def wrapper():
        pass
    wrapper.launches = 0
    with build.recording_launches() as table:
        with pytest.raises(RuntimeError, match="does not capture"):
            build.count_launch(wrapper)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        build.count_launch(wrapper)
        build.count_launch(wrapper)
        other = threading.Thread(target=build.count_launch, args=(wrapper,))
        other.start()
        other.join()
    assert table == {wrapper: 2} and wrapper.launches == 1
    build.count_launch(wrapper)
    build.add_launches(table)
    build.add_launches(table)
    assert wrapper.launches == 6


def test_chip_smoke_tallies_each_phases_decode_steps(small, monkeypatch,
                                                    capsys):
    """``chip_smoke.py`` counts every runner's steps (here eager: the CPU)
    and prints the tally at the next phase header, then starts afresh."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    eng = _live_engine(small, "dense", {})
    monkeypatch.setattr(DecodeGraphs, "_one_step", DecodeGraphs._one_step)
    cs.tally_decode_graphs(DecodeGraphs)
    eng._decode_block(3, False, False, False)
    assert cs.GRAPHS == {"captures": 0, "replays": 0, "eager": 3}
    cs.log("== next phase")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("  decode graphs in the phase above: "
                      "{'captures': 0, 'replays': 0, 'eager': 3}")
    assert out[1].startswith("== next phase [")
    assert not any(cs.GRAPHS.values())


# --------------------------------------------------------------------------- #
# on the card: replayed graphs against the same steps run eagerly
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _wrappers():
    from repro_torch.kernels import ops
    return (ops.decode_attention_cuda, ops.paged_attention_cuda,
            ops.flash_attention_cuda, ops.rmsnorm_cuda, ops.categorical_cuda)


def _card_run(cfg, params, arrivals, *, eager, monkeypatch, **kw):
    """Serve ``arrivals`` ([(step, GenerationRequest)]) step by step: the
    requests, the decode state after every step, the wrappers' launches
    and the scheduler's stats."""
    with monkeypatch.context() as m:
        if eager:
            m.setattr(decode_graph, "graphs_usable", lambda *a: False)
        eng = InferenceEngine(cfg, params, device="cuda",
                              speculative_fill=False, **kw)
        for w in _wrappers():
            w.launches = 0
        pending = list(arrivals)
        reqs, states, step = [], [], 0
        while pending or eng.scheduler.has_work:
            for at, g in [a for a in pending if a[0] <= step]:
                pending.remove((at, g))
                for r in g.to_requests(ByteTokenizer()):
                    reqs.append(r)
                    eng.add_request(r)
            eng.step()
            states.append({n: getattr(eng.state, n).cpu()
                           for n in ADVANCED})
            step += 1
        launches = [w.launches for w in _wrappers()]
    return eng, reqs, states, launches


def _arrivals(n_top_kw, *, group=False):
    """Eight requests over 24 steps: budgets 2-40 and stop tokens (slots
    freeze inside blocks and are re-admitted); with ``group``, the second
    is an ``n`` = 2 group sharing its prompt's pages, whose 40 tokens
    wrap a 64-cell ring onto them (COW splits between replays)."""
    prompts = _prompts(8, seed=3, lens=(5, 40, 33, 17, 3, 21, 9, 12))
    out = []
    for i, p in enumerate(prompts):
        s = SamplingParams(max_tokens=(2, 40, 9, 16, 5, 24, 12, 3)[i],
                           stop_token_ids=(11, 200), **n_top_kw[i % 2])
        n = 2 if group and i == 1 else 1
        out.append(((0, 0, 1, 4, 6, 9, 15, 24)[i],
                    GenerationRequest(prompt=p, sampling=s, n=n)))
    return out


GREEDY = [{}, {"logprobs": True, "top_logprobs": 3}]
SAMPLED = [{"temperature": 0.7, "top_p": 0.9, "top_k": 30},
           {"temperature": 1.0, "min_p": 0.05, "logprobs": True,
            "top_logprobs": 2}]

CARD_CASES = {
    # name: (config, engine knobs, sampling, n = 2 group)
    "dense-k1": ("qwen2-0.5b", {"max_decode_block": 1}, GREEDY, False),
    "dense-k3": ("qwen2-0.5b", {"max_decode_block": 3}, SAMPLED, False),
    "dense-k8": ("qwen2-0.5b", {"max_decode_block": 8}, GREEDY, False),
    "paged-fp-k8-cow": ("qwen2-0.5b", {"max_decode_block": 8,
                                       "kv_layout": "paged"}, SAMPLED, True),
    "paged-int8-k3": ("qwen2-0.5b", {"max_decode_block": 3,
                                     "kv_layout": "paged",
                                     "kv_dtype": "int8"}, GREEDY, True),
    "paged-bf16-k8": ("qwen2-0.5b-bf16", {"max_decode_block": 8,
                                          "kv_layout": "paged"}, GREEDY,
                      False),
    "moe-paged-k3": ("deepseek-moe-16b", {"max_decode_block": 3,
                                          "kv_layout": "paged"}, SAMPLED,
                     False),
    "ssm-k8": ("mamba2-780m", {"max_decode_block": 8}, GREEDY, False),
}


def _card_config(name):
    if name == "qwen2-0.5b-bf16":
        return dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                                   dtype="bfloat16")
    return get_config(name).reduced()


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_card_graph_blocks_match_eager(cuda, monkeypatch, case):
    arch, knobs, sampling, group = CARD_CASES[case]
    cfg = _card_config(arch)
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0),
                             "cuda")
    kw = dict(max_batch=4, cache_len=64, **knobs)
    arrivals = _arrivals(sampling, group=group)
    _, ref, ref_states, ref_launches = _card_run(
        cfg, params, arrivals, eager=True, monkeypatch=monkeypatch, **kw)
    eng, got, states, launches = _card_run(
        cfg, params, _arrivals(sampling, group=group), eager=False,
        monkeypatch=monkeypatch, **kw)
    st = eng.scheduler.stats
    # every step replays but each variant's first, its warm-up
    assert st.decode_graph_captures >= 1 and st.decode_graph_steps > 0
    assert st.decode_graph_steps == st.device_steps - st.decode_graph_captures
    for a, b in zip(ref, got):
        assert b.output_tokens == a.output_tokens
        assert b.finish_reason == a.finish_reason
        for (la, ta), (lb, tb) in zip(a.output_logprobs, b.output_logprobs):
            assert lb == pytest.approx(la, abs=1e-3)
            assert [t for t, _ in tb] == [t for t, _ in ta]
            np.testing.assert_allclose([v for _, v in tb],
                                       [v for _, v in ta], atol=1e-3)
    for sa, sb in zip(ref_states, states):
        for n in ADVANCED:
            assert torch.equal(sa[n], sb[n]), n
    assert launches == ref_launches
    if group and knobs.get("kv_layout") == "paged":
        assert eng.pool.allocator.stats.cow_splits > 0


@pytest.mark.gpu
def test_card_recovery_drops_the_graphs_and_captures_again(cuda,
                                                           monkeypatch):
    cfg = get_config("qwen2-0.5b").reduced()
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0),
                             "cuda")
    eng = InferenceEngine(cfg, params, device="cuda", max_batch=3,
                          cache_len=128, kv_layout="paged")
    for p in _prompts(3):
        eng.add_request(Request(prompt_tokens=p,
                                sampling=SamplingParams(max_tokens=30)))
    while eng.scheduler.stats.decode_graph_steps < 3:
        eng.step()
    assert eng.scheduler.stats.decode_graph_captures == 1
    eng._recover_decode_block(RuntimeError("injected"))
    assert eng._decode_graphs is None
    fresh = [Request(prompt_tokens=p, sampling=SamplingParams(max_tokens=9))
             for p in _prompts(2, seed=5)]
    eng.generate(fresh)
    assert eng.scheduler.stats.decode_graph_captures == 2
    assert eng._decode_graphs.cache is eng.pool.cache
    with monkeypatch.context() as m:
        m.setattr(decode_graph, "graphs_usable", lambda *a: False)
        alone = InferenceEngine(cfg, params, device="cuda", max_batch=3,
                                cache_len=128, kv_layout="paged")
        again = [Request(prompt_tokens=p,
                         sampling=SamplingParams(max_tokens=9))
                 for p in _prompts(2, seed=5)]
        alone.generate(again)
    assert [r.output_tokens for r in fresh] == \
        [r.output_tokens for r in again]


@pytest.mark.gpu
def test_card_runner_buffers_and_pool(cuda):
    """One runner per engine: a graph per variant, in one pool; the block
    buffers hold ``max_decode_block`` rows."""
    cfg = get_config("qwen2-0.5b").reduced()
    eng = InferenceEngine(cfg, device="cuda", max_batch=2, cache_len=64,
                          max_decode_block=4)
    eng.generate([Request(prompt_tokens=[1, 2, 3], sampling=SamplingParams(
        max_tokens=6, logprobs=True, top_logprobs=1))])
    eng.generate([Request(prompt_tokens=[4, 5, 6], sampling=SamplingParams(
        max_tokens=6))])
    runner = eng._decode_graphs
    assert isinstance(runner, DecodeGraphs) and runner.use_graphs
    assert sorted(runner.graphs) == [(False, False, False),
                                     (True, False, False)]
    # each replay credits the kernels its capture recorded
    assert all(launches for _, launches in runner.graphs.values())
    assert runner.block[0].shape == (4, 2)
