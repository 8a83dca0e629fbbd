"""Where the bf16 flash backward's time goes: at ``chip_smoke.py``'s
training shapes (``BWD_FORMS``, at 6a's B 8 x S 512 first), the backward
given the forward's LSE, device alone (``chip_smoke.py``'s timer over
input sets together larger than L2), and each of its three kernels' device
time (the delta pass, dK/dV, dQ) from ``torch.profiler`` over the same
calls; SDPA's backward device alone beside it where one SDPA call computes
the same function (no window).

Run from the repository root on a machine with one H100::

    python3 tools/flash_bwd_profile.py

It prints one line a shape, the card's ``nvidia-smi`` name and power
limit, and one JSON object of the readings as the last line.
"""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def kernel_ms(torch, fn, n_sets: int) -> dict:
    """{kernel name: device ms a call} over one pass through the sets."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(n_sets):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            name = re.search(r"(\w+)<", ev.name)
            key = name.group(1) if name else ev.name[:40]
            dur = (ev.time_range.end - ev.time_range.start) / 1e3
            out[key] = out.get(key, 0.0) + dur / n_sets
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_profile: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fla
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, hkv, d = (cs.BWD_TRAIN[k] for k in ("b", "s", "h", "hkv", "d"))
    forms = (("6a B8 S512", b, s, s, h, hkv, d, True, 0),) + cs.BWD_FORMS
    out = {}
    for label, *shape in forms:
        causal, window = shape[-2:]
        one, lse = cs.bwd_case(torch, fla, torch.bfloat16, *shape)
        n_sets = min(8, max(2, 2 * cs.L2_BYTES // cs.nbytes(*one, lse) + 1))
        sets = [cs.bwd_case(torch, fla, torch.bfloat16, *shape, seed=i)
                for i in range(n_sets)]
        run = lambda i: fla.flash_attention_bwd_cuda(  # noqa: E731
            *sets[i][0], lse=sets[i][1], causal=causal, window=window)
        res = out[label] = {"device_ms": cs.device_ms(torch, run, n_sets),
                            "kernels_ms": kernel_ms(torch, run, n_sets)}
        if window == 0:
            graphs = []
            for (q, k, v, _, do), _ in sets:
                qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                              for t in (q, k, v))
                o = F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal,
                                                   enable_gqa=True)
                graphs.append((o, (qt, kt, vt),
                               do.transpose(1, 2).contiguous()))
            lib = lambda i: torch.autograd.grad(  # noqa: E731
                graphs[i][0], graphs[i][1], graphs[i][2], retain_graph=True)
            res["sdpa_device_ms"] = cs.device_ms(torch, lib, n_sets)
            del graphs
        parts = ", ".join(f"{k} {v:.4f}" for k, v in
                          res["kernels_ms"].items())
        sdpa = res.get("sdpa_device_ms")
        cs.log(f"flash_attention_bwd bf16 {label:18s} device alone "
               f"{res['device_ms']:.4f} ms ({parts})"
               + (f"; SDPA backward {sdpa:.4f} ms" if sdpa else ""))
        del sets, one, lse
        torch.cuda.empty_cache()
    cs.log(cs.smi())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
