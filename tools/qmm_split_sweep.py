"""The bf16 ``quant_matmul`` kernel at the decode rows (M 8) of both MLP
shapes of ``llama-3.2-vision-90b`` against its number of K splits: 1 and
the splits that give 4, 8 (``quant_matmul.BLOCKS_PER_SM``, the wrapper's
plan) and 16 blocks per SM, through the wrapper's own launch with each
count.  Times a call and device alone with ``chip_smoke.py``'s timers over
two weight sets (together larger than L2).  The readings that chose
``BLOCKS_PER_SM`` come from this script.

Run from the repository root on a machine with one H100::

    python3 tools/qmm_split_sweep.py

It prints one line a count, the card's ``nvidia-smi`` name and power limit,
and one JSON object of the readings as the last line.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("qmm_split_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import quant_matmul as qm
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for k, n in cs.MLP_SHAPES:
        sets = [cs.qmm_case(torch, qm, torch.bfloat16, 8, k, n, seed=i)[0]
                for i in range(2)]
        bm, bn, bk, _ = qm.tensor_core_tile(sets[0][0], sets[0][1])
        tiles, steps = -(-n // bn), -(-k // bk)
        res = out[f"8x{k}x{n}"] = {"plan": qm.planned_splits(*sets[0][:2])}
        for ns in sorted({1, *(min(steps, -(-w * sms // tiles))
                               for w in (4, 8, 16))}):
            run = lambda i, ns=ns: qm._launch(*sets[i], ns)  # noqa: E731
            res[ns] = {"ms": cs.time_ms(torch, run, 2),
                       "device_ms": cs.device_ms(torch, run, 2)}
            cs.log(f"quant_matmul 8x{k}x{n} K splits {ns:3d}: "
                   f"{res[ns]['ms']:.4f} ms a call, device "
                   f"{res[ns]['device_ms']:.4f} ms"
                   f"{' (the plan)' if ns == res['plan'] else ''}")
        del sets
        torch.cuda.empty_cache()
    cs.log(cs.smi())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
