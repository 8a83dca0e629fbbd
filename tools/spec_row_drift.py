"""Which bf16 product makes a speculative verify row differ from the
one-token decode step on the card.

An n-gram verify round emits the spec-off tokens only if each row of its
``[B, spec_k + 1]`` forward computes what the decode step computes for that
row alone ``[B, 1]``.  This script reads, on ``qwen2-0.5b`` (bf16, 24
layers, published widths, seeded random weights):

1. each weight product of a layer and the LM head on 8 rows alone against
   the same rows inside 40 (a verify round's rows at ``max_batch`` 8 and
   ``spec_k`` 4): max |Δ|;
2. ``torch.mean`` over the last dimension in float32 (the variance inside
   the plain ``rmsnorm``) on 8 rows alone against the same rows inside 40:
   how many rows get another value; and the same through
   ``layers.rmsnorm`` (the row-invariant ``rmsnorm`` kernel, bf16);
3. the 8 greedy requests of ``chip_smoke.py`` 4i-c served with n-gram
   speculation and with it off, with the port's ``rmsnorm`` (the kernel)
   and with an ``rmsnorm`` that reduces each row in a call of its own:
   how many outputs are equal.

Run from the repository root on a machine with one H100::

    python3 tools/spec_row_drift.py

It prints one line a reading, the card's ``nvidia-smi`` name and power
limit, and one JSON object of the readings as the last line.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("spec_row_drift: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.request import Request, SamplingParams
    from repro_torch.kernels import build
    from repro_torch.models import layers
    from repro_torch.models.model import Model
    from repro_torch.serving.tokenizer import ByteTokenizer

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    cfg = get_config("qwen2-0.5b")
    params = Model(cfg).init(torch.Generator(device="cuda").manual_seed(0))
    out = {"products_max_abs": cs.row_drift(torch, params, cfg)}
    print(f"weight products, 8 rows alone vs inside 40, max|Δ|: "
          f"{out['products_max_abs']}", flush=True)

    g = torch.Generator(device="cuda").manual_seed(3)
    differ = rows = 0
    for _ in range(200):
        x = torch.randn((8, 5, cfg.d_model), generator=g, device="cuda")
        alone = torch.mean(x[:, :1].contiguous() ** 2, dim=-1)
        inside = torch.mean(x * x, dim=-1)[:, :1]
        differ += int((alone != inside).sum())
        rows += alone.numel()
    out["mean_rows_differing"] = [differ, rows]
    print(f"float32 mean over {cfg.d_model}: {differ} of {rows} rows differ "
          "between 8 rows alone and inside 40", flush=True)
    w = params["final_ln"]
    differ = rows = 0
    for _ in range(200):
        x = torch.randn((8, 5, cfg.d_model), generator=g,
                        device="cuda").to(w.dtype)
        alone = layers.rmsnorm(x[:, :1].contiguous(), w, cfg.rms_eps)
        inside = layers.rmsnorm(x, w, cfg.rms_eps)[:, :1]
        differ += int((alone != inside).any(-1).sum())
        rows += 8
    out["rmsnorm_kernel_rows_differing"] = [differ, rows]
    print(f"layers.rmsnorm (the kernel, bf16) over {cfg.d_model}: {differ} "
          f"of {rows} rows differ between 8 rows alone and inside 40",
          flush=True)

    tok = ByteTokenizer()
    texts = [cs.prompt_text(k, b) for k, b in
             (cs.serve_requests()[3:5] + cs.repetition_bodies())]

    def serve(**kw):
        eng = InferenceEngine(cfg, params, device="cuda", max_batch=8,
                              cache_len=2048, prefill_chunk=512, seed=0,
                              enable_prefix_cache=False, **kw)
        reqs = [Request(prompt_tokens=tok.encode(t),
                        sampling=SamplingParams(max_tokens=64))
                for t in texts]
        return [r.output_tokens for r in eng.generate(reqs)]

    def row_alone(x, w, eps=1e-5):
        xf = x.float()
        flat = xf.reshape(-1, xf.shape[-1])
        var = torch.stack([torch.mean(r * r) for r in flat.unbind(0)])
        return ((xf * torch.rsqrt(var.reshape(xf.shape[:-1] + (1,)) + eps))
                * w.float()).to(x.dtype)

    for label, norm in (("port", layers.rmsnorm), ("row_alone", row_alone)):
        saved, layers.rmsnorm = layers.rmsnorm, norm
        try:
            same = sum(a == b for a, b in
                       zip(serve(), serve(spec_mode="ngram", spec_k=4)))
        finally:
            layers.rmsnorm = saved
        out[f"ngram_equal_to_off_{label}_rmsnorm"] = same
        print(f"n-gram outputs equal to spec off, {label} rmsnorm: {same}/8",
              flush=True)
    card = cs.smi()
    out["card"] = card
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
