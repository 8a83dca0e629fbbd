"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell is found by its name in
``BENCHMARK.json``; its configuration, traffic mix and per-layer readers by
their names under ``bench/`` (see ``bench/README.md``).  The run needs as
many CUDA cards as the cell names and exits with an error, printing no
result, without them, or when a module of JAX or of the JAX package is
loaded once the window has closed."""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    from bench.common import (emit_result, find_cell, forbidden_modules,
                              set_run_env)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    set_run_env()
    cell = find_cell(args.workload)
    import torch
    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result, checks = run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, T_START)
    bad = forbidden_modules(list(sys.modules))
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    emit_result(result, checks)
    return 0


def run_cell(cell, seed, seconds, trace, device, t_start, port_cfg=None,
             keep=None):
    """One run of ``cell`` on ``device``: (result line without ``checks``,
    checks).  ``port_cfg`` stands in for the program's configuration of
    the cell (the tests' small sizes); ``keep`` receives what the control's
    readings need."""
    import torch
    from bench import serve, train
    kind = cell["traffic"]["kind"]
    mod = {"serve": serve, "train": train}[kind]
    out, checks = mod.run(cell, seed, seconds, trace, device, t_start,
                          port_cfg=port_cfg, keep=keep)
    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": 1, "memory_peak_bytes": int(out["peak"])}
    else:
        dev = {"platform": device.type, "kind": device.type, "count": 1,
               "memory_peak_bytes": 0}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"]}
    if trace:
        dev["busy_s"] = out["busy_s"]
        dev["window_s"] = out["window_s"]
        metrics = per_layer(out, cell["per_layer"])
    else:
        metrics = {}
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        for name, value in out["metrics"].items():
            if name in units:
                metrics[name] = {"value": value, "unit": units[name]}
        metrics["setup_s"] = {"value": out["setup_s"], "unit": "s"}
    result["metrics"] = metrics
    result["device"] = dev
    if trace:
        result["breakdown"] = out["breakdown"]
    return result, checks


def per_layer(out, metrics):
    from bench.common import load_reader
    import math
    rec = out["per_layer_rec"]
    got = {}
    for m in metrics:
        v = load_reader(m["name"])(rec)
        if v is not None and math.isfinite(v):
            got[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return got


if __name__ == "__main__":
    sys.exit(main())
