"""The ``categorical`` draw kernel against the elements a block takes (its
``chunk``: 256 to 8192) at B 8 and B 1 over ``qwen2-0.5b``'s 151936-entry
vocabulary, device alone with ``chip_smoke.py``'s timer; the draws must
not change with the chunk.  The readings behind
``categorical.MAX_CHUNK`` come from this script.

Run from the repository root on a machine with one H100::

    python3 tools/categorical_chunk_sweep.py

It prints one line a chunk, the card's ``nvidia-smi`` name and power limit,
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
        print("categorical_chunk_sweep: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.core import sampling
    from repro_torch.kernels import categorical as cat
    v = cs.CAT_WIDTHS[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for b in (8, 1):
        # categorical_case needs 3 rows: take row 3 (a plain one) for B 1
        keys, pos, logits = cs.categorical_case(torch, sampling, 8, v)
        if b == 1:
            keys, pos, logits = (t[3:4].clone() for t in (keys, pos, logits))
        res = out[f"B{b}"] = {"plan": cat.plan_chunk(b, v, sms)}
        want = cat.categorical_plain(logits, keys, pos)
        for chunk in (256, 512, 1024, 2048, 4096, 8192):
            def draw(i, chunk=chunk):
                return cat.categorical_cuda(logits, keys, pos, chunk=chunk)
            same = bool(torch.equal(draw(0), want))
            ms = cs.device_ms(torch, draw, 16)
            res[str(chunk)] = {"device_ms": ms, "draws_equal_plain": same}
            print(f"B {b} chunk {chunk:5d}: {ms:.4f} ms device alone, "
                  f"{b * -(-v // chunk)} blocks, draws equal to plain "
                  f"{same}", flush=True)
            if not same:
                raise AssertionError(f"B {b} chunk {chunk}: draws differ")
    card = cs.smi()
    print(card)
    print(json.dumps({"categorical_chunk_sweep": out, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
