"""The readings that the limits of ``correct`` are set from, on the chip at a
cell's own sizes.  Not part of a run; ``PERF.md`` keeps what it printed.

    python3 bench/control.py --workload <name> --seeds 1,2,3 --seconds 10 \
        [--fault <name>]

For each seed, one run of the cell as the benchmark runs it, then:

* serving: the program's widest gap (what the run compares) and the
  control's: the reference with float8 matrix products put in the
  program's place at the same prompts and served tokens, read as the gap
  of the token it puts first at each position; and two faults planted in
  the program's output: every checked token altered (+1), and every token
  repeating the one before it; and the share of distinct tokens among
  those served (a model whose outputs collapse to a few tokens gives the
  check nothing to compare);
* training: the program's three numbers, the control's (the float8
  reference in the program's place), and the fault of half the batch left
  out (the reference on the first half of each batch's rows).  A state
  left unchanged reads 1 on ``change_gap`` and needs no run.

With ``--fault`` a fault of :mod:`bench.faults` is planted in the program
first, and the program's readings are reported under the fault's name.

One JSON line a seed, then a summary line: per number, the largest sound
reading and the smallest reading of the control and of each fault."""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def serve_readings(keep, cell, seed):
    from bench import correct
    from bench.reference import dense_lm
    cfg, mix = cell["config"], cell["traffic"]
    seqs, rows, toks = correct.served_inputs(
        mix, seed, cfg["vocab_size"], keep["sample"], keep["served"])
    ref = dense_lm.served_logits(keep["params"], cfg, seqs, rows)
    low = dense_lm.served_logits(keep["params"], cfg, seqs, rows,
                                 quant="fp8")
    v = cfg["vocab_size"]
    out = {"program": 0.0, "control": 0.0, "altered": 0.0, "repeated": 0.0}
    flat = [x for t in toks for x in t]
    out["distinct_share"] = len(set(flat)) / max(1, len(flat))
    for r, lo, t in zip(ref, low, toks):
        out["program"] = max(out["program"],
                             float(correct.serve_gaps(r, t).max()))
        first = lo.argmax(dim=-1).tolist()
        out["control"] = max(out["control"],
                             float(correct.serve_gaps(r, first).max()))
        alt = [(x + 1) % v for x in t]
        out["altered"] = max(out["altered"],
                             float(correct.serve_gaps(r, alt).max()))
        rep = [t[0]] + t[:-1]
        out["repeated"] = max(out["repeated"],
                              float(correct.serve_gaps(r, rep).max()))
    return out


def train_readings(keep, cell):
    from bench import correct
    cfg = cell["config"]
    ref = keep["ref"]
    out = {"program": correct.train_numbers(keep["prog"], ref)}
    low = correct.reference_train(keep["start"], cfg, keep["batches"],
                                  quant="fp8")
    out["control"] = correct.train_numbers(low, ref)
    half = [{k: v[: v.shape[0] // 2] for k, v in b.items()}
            for b in keep["batches"]]
    out["half_batch"] = correct.train_numbers(
        correct.reference_train(keep["start"], cfg, half), ref)
    return out


def main(argv=None) -> int:
    from bench.common import find_cell, set_run_env
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)
    set_run_env()
    import torch
    from bench.faults import FAULTS
    if args.fault:
        setattr(*FAULTS[args.fault]())
    from bench.run import run_cell
    cell = find_cell(args.workload)
    device = torch.device("cuda", 0)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        keep = {}
        t0 = time.monotonic()
        result, checks = run_cell(cell, seed, args.seconds, False, device,
                                  time.monotonic(), keep=keep)
        if cell["traffic"]["kind"] == "serve":
            got = serve_readings(keep, cell, seed)
        else:
            got = train_readings(keep, cell)
        if args.fault:
            got[args.fault] = got.pop("program")
        keep.clear()
        torch.cuda.empty_cache()
        row = {"seed": seed, "correct": result["correct"],
               "checks": checks, "readings": got,
               "metrics": result["metrics"],
               "wall_s": time.monotonic() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"summary": summarize(rows)}), flush=True)
    return 0


def summarize(rows):
    """Per number: the largest sound reading, the smallest of the control
    and of each fault."""
    out = {}
    for row in rows:
        got = row["readings"]
        flat = ({f"{k}": v for k, v in got.items()}
                if not isinstance(got.get("program"), dict) else
                {f"{side}.{n}": v for side, nums in got.items()
                 for n, v in nums.items()})
        for k, v in flat.items():
            pick = max if k.startswith("program") else min
            out[k] = v if k not in out else pick(out[k], v)
    return out


if __name__ == "__main__":
    sys.exit(main())
