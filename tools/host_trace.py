"""Where the host's time goes in one cell of the port's benchmark, read from
the program's own spans and counters (``repro_torch/tracing.py``) on the card.

    python3 tools/host_trace.py --workload <cell> --seed <n>
    python3 tools/host_trace.py --workload <cell> --seed <n> --always

From the root of a checkout, on a machine with a CUDA card.

The first form runs the cell as ``bench/run.py --trace 1`` does, with the
program's tracer on until the profiler stops and the engine's new counters
beside the benchmark's own, and prints one JSON line, read over the
profiler's stretch: the benchmark's per-layer metrics, the program's
(:data:`READERS`), a table of the program's spans by name (count, wall,
CPU and self time) and the ten longest idle gaps of the card, each named by
the innermost program span open on the thread that launches the kernels
(the engine's loop thread, or the caller's in training) when the card went
idle.

The second form runs the cell as ``--trace 0`` does, with the tracer on from
start to end, and prints the end-to-end metrics — set beside a plain
``bench/run.py --trace 0`` run of the same seed, the tracer's cost — and
the readers of spans alone over the run's last ``--seconds``
(:func:`untraced_readers`).  No profiler is attached there, so they leave
out its cost; the first form's include it, and it is largest on a CUDA
graph's launch, which the profiler traces kernel by kernel.

Each reader takes the traced run's record with ``rec["program"]`` added
(``{"records": [Record, ...], "thread": <launching thread id>}``) and
returns None where it finds nothing to read."""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

T_START = time.monotonic()

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def _inside(rec, r) -> bool:
    """``r`` lies whole inside the traced stretch (a span that straddles
    the profiler's start or stop holds its stall)."""
    return rec["t0_ns"] <= r.start and r.end <= rec["t1_ns"]


def _in_window(rec, name: str) -> Optional[list]:
    """The program's ``name`` spans inside the traced stretch; None without
    a program section."""
    prog = rec.get("program")
    if prog is None:
        return None
    return [r for r in prog["records"] if r.name == name and _inside(rec, r)]


def _wall_ms(spans) -> float:
    return sum(r.end - r.start for r in spans) / 1e6


def _delta(rec, key: str) -> Optional[int]:
    a, b = rec.get("counters", ({}, {}))
    if key not in a or key not in b:
        return None
    return b[key] - a[key]


def _ratio(num, den, scale: float = 1.0) -> Optional[float]:
    if num is None or not den:
        return None
    return scale * num / den


def dispatch_ms_per_step(rec) -> Optional[float]:
    """Wall ms of ``engine.decode_dispatch`` over the decode steps (K) it
    launched."""
    s = _in_window(rec, "engine.decode_dispatch")
    return None if not s else _ratio(_wall_ms(s), sum(r.n for r in s))


def dispatch_offcpu_share(rec) -> Optional[float]:
    """% of ``engine.decode_dispatch``'s wall time its thread was off the
    CPU (blocked, or waiting for the interpreter lock)."""
    s = _in_window(rec, "engine.decode_dispatch")
    if not s:
        return None
    wall = sum(r.end - r.start for r in s)
    return _ratio(wall - sum(r.cpu for r in s), wall, 100.0)


def sync_wait_ms_per_block(rec) -> Optional[float]:
    """Mean wall ms of ``engine.block_sync``: the host waiting on the card
    for a block's tokens (near 0: the host paces the card)."""
    s = _in_window(rec, "engine.block_sync")
    return None if not s else _wall_ms(s) / len(s)


def emit_ms_per_token(rec) -> Optional[float]:
    s = _in_window(rec, "engine.emit")
    return None if not s else _ratio(_wall_ms(s), sum(r.n for r in s))


def decode_graph_share(rec) -> Optional[float]:
    """% of the stretch's decode steps run as a replay of a captured CUDA
    graph (``SchedulerStats.decode_graph_steps`` over ``device_steps``)."""
    return _ratio(_delta(rec, "decode_graph_steps"),
                  _delta(rec, "device_steps"), 100.0)


def blocks_collapsed_share(rec) -> Optional[float]:
    """% of the stretch's decode blocks cut to K=1 by waiting work."""
    return _ratio(_delta(rec, "blocks_collapsed"), _delta(rec, "steps"),
                  100.0)


def queue_wait_p95_ms(rec) -> Optional[float]:
    """Nearest-rank p95 of ``request.queue`` (arrival to slot) over the
    requests whose wait ended inside the stretch."""
    prog = rec.get("program")
    if prog is None:
        return None
    waits = sorted((r.end - r.start) / 1e6 for r in prog["records"]
                   if r.name == "request.queue"
                   and rec["t0_ns"] <= r.end < rec["t1_ns"])
    if not waits:
        return None
    return waits[max(1, math.ceil(0.95 * len(waits))) - 1]


def codec_ms_per_token(rec) -> Optional[float]:
    """Wall ms of the HTTP front's ``api.encode`` + ``http.write`` over the
    tokens the encoded events carried."""
    enc = _in_window(rec, "api.encode")
    if not enc:
        return None
    return _ratio(_wall_ms(enc) + _wall_ms(_in_window(rec, "http.write")),
                  sum(r.n for r in enc))


def hit_token_share(rec) -> Optional[float]:
    """% of the prompt tokens opened for prefill that the prefix cache
    served."""
    return _ratio(_delta(rec, "hit_tokens"), _delta(rec, "prompt_tokens"),
                  100.0)


def _per_train_step(rec, names) -> Optional[float]:
    steps = _in_window(rec, "train.step")
    if not steps:
        return None
    return sum(_wall_ms(_in_window(rec, n)) for n in names) / len(steps)


def train_dispatch_ms_per_step(rec) -> Optional[float]:
    return _per_train_step(rec, ("train.forward", "train.backward",
                                 "train.optimizer"))


def train_sync_wait_ms_per_step(rec) -> Optional[float]:
    return _per_train_step(rec, ("train.metrics_sync",))


#: the program's per-layer figures, by the names a benchmark would give them
READERS = {
    "engine.dispatch_ms_per_step": dispatch_ms_per_step,
    "engine.dispatch_offcpu_share": dispatch_offcpu_share,
    "engine.sync_wait_ms_per_block": sync_wait_ms_per_block,
    "engine.emit_ms_per_token": emit_ms_per_token,
    "engine.decode_graph_share": decode_graph_share,
    "engine.blocks_collapsed_share": blocks_collapsed_share,
    "engine.queue_wait_p95_ms": queue_wait_p95_ms,
    "serving.codec_ms_per_token": codec_ms_per_token,
    "prefix_cache.hit_token_share": hit_token_share,
    "train.dispatch_ms_per_step": train_dispatch_ms_per_step,
    "train.sync_wait_ms_per_step": train_sync_wait_ms_per_step,
}


def untraced_readers(records, seconds: float) -> Dict[str, float]:
    """:data:`READERS` over the spans of the last ``seconds`` before the
    last engine or training step ended (no counters: those readers give
    nothing)."""
    ends = [r.end for r in records if r.name in ("engine.step", "train.step")]
    if not ends:
        return {}
    t1 = max(ends)
    rec = {"t0_ns": t1 - int(seconds * 1e9), "t1_ns": t1,
           "program": {"records": records, "thread": None}}
    out = {k: f(rec) for k, f in READERS.items()}
    return {k: v for k, v in out.items() if v is not None}


def span_table(rec) -> Optional[Dict[str, List[float]]]:
    """Per span name in the stretch: [count, wall ms, CPU ms, self ms], self
    time being the wall time its children on the same thread do not
    cover."""
    prog = rec.get("program")
    if prog is None:
        return None
    spans = [r for r in prog["records"] if _inside(rec, r)]
    child_ns: Dict[int, int] = {}
    for r in spans:
        if r.parent != -1:
            child_ns[r.parent] = child_ns.get(r.parent, 0) + r.end - r.start
    out: Dict[str, List[float]] = {}
    for r in spans:
        row = out.setdefault(r.name, [0, 0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += (r.end - r.start) / 1e6
        row[2] += r.cpu / 1e6
        row[3] += (r.end - r.start - child_ns.get(r.id, 0)) / 1e6
    return out


def idle_gaps(rec, top: int = 10) -> Optional[List[list]]:
    """The ``top`` longest idle gaps of the card in the stretch, each named
    by the innermost program span open on the launching thread when it
    began (spans of other threads, the HTTP handlers', name none, nor do a
    request's ``request.*`` spans, which cover its waits)."""
    from bench.trace import busy_intervals
    prog = rec.get("program")
    if prog is None:
        return None
    mine = [r for r in prog["records"] if r.thread == prog["thread"]
            and not r.name.startswith("request.")]
    gaps, prev = [], rec["t0_ns"]
    for s, e in busy_intervals(rec["kernels"]) + [(rec["t1_ns"],) * 2]:
        if s > prev:
            gaps.append((prev, s - prev))
        prev = max(prev, e)
    gaps.sort(key=lambda g: -g[1])

    def label(t):
        inside = [(r.end - r.start, r.name) for r in mine
                  if r.start <= t < r.end]
        return min(inside)[1] if inside else "outside the program's spans"

    return [[f"idle in {label(t)}", d / 1e9] for t, d in gaps[:top]]


def _launching_thread(records, name: str) -> Optional[int]:
    threads = {r.thread for r in records if r.name == name}
    return threads.pop() if len(threads) == 1 else None


def _patch_bench():
    """The tracer stops with the benchmark's profiler, and the engine's new
    counters join the benchmark's counter snapshots."""
    from bench import serve, train
    from repro_torch.tracing import TRACER

    class TracedProfile(serve.Profile):
        def stop(self):
            super().stop()
            TRACER.stop()

    serve.Profile = train.Profile = TracedProfile
    base = serve._counters

    def counters(engine):
        out = base(engine)
        st = engine.scheduler.stats
        out.update(blocks_collapsed=st.blocks_collapsed,
                   prompt_tokens=st.prompt_tokens,
                   decode_graph_steps=st.decode_graph_steps)
        if engine.prefix_cache is not None:
            out["hit_tokens"] = engine.prefix_cache.lookup_stats.hit_tokens
        return out

    serve._counters = counters


def traced_run(cell, seed: int, seconds: float, device, t_start: float,
               port_cfg=None) -> Dict[str, Any]:
    """One ``--trace 1`` run of ``cell`` with the program's tracer over the
    profiler's stretch: the benchmark's per-layer metrics and gaps beside
    the program's."""
    from bench import run as bench_run, serve, train
    from repro_torch.tracing import TRACER
    _patch_bench()
    kind = cell["traffic"]["kind"]
    mod = {"serve": serve, "train": train}[kind]
    # on from the start, so that the spans open when the profiler starts
    # are recorded and name the stretch's first gaps
    TRACER.start()
    out, _ = mod.run(cell, seed, seconds, True, device, t_start,
                     port_cfg=port_cfg)
    rec = out["per_layer_rec"]
    records = TRACER.records()
    rec["program"] = {"records": records, "thread": _launching_thread(
        records, {"serve": "engine.step", "train": "train.step"}[kind])}
    ours = {k: f(rec) for k, f in READERS.items()}
    return {"correct": out["correct"],
            "benchmark": {k: v["value"] for k, v in bench_run.per_layer(
                out, cell["per_layer"]).items()},
            "program": {k: v for k, v in ours.items() if v is not None},
            "spans": span_table(rec), "program_gaps": idle_gaps(rec),
            "benchmark_gaps": out["breakdown"]["idle_gaps"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--always", action="store_true",
                    help="--trace 0 with the tracer on throughout")
    args = ap.parse_args(argv)

    from bench.common import find_cell, finite, set_run_env
    set_run_env()
    import torch
    from bench.run import run_cell
    from repro_torch.tracing import TRACER
    cell = find_cell(args.workload)
    if not torch.cuda.is_available():
        print("host_trace needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line: Dict[str, Any] = {"workload": args.workload, "seed": args.seed,
                            "device": torch.cuda.get_device_name(device)}
    if args.always:
        TRACER.start()
        result, _ = run_cell(cell, args.seed, args.seconds, False, device,
                             T_START)
        TRACER.stop()
        line.update(tracer="on throughout", correct=result["correct"],
                    metrics=result["metrics"], spans=len(TRACER.records()),
                    program=untraced_readers(TRACER.records(),
                                             args.seconds))
    else:
        line.update(traced_run(cell, args.seed, args.seconds, device,
                               T_START))
    print(json.dumps(finite(line)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
