"""Plumbing shared by every cell: the checkout's root, ``BENCHMARK.json`` and
the files a cell is found by, the environment a run sets, nearest-rank
percentiles, the check against imports of the JAX package, and the result
line.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` names a configuration
and a traffic mix; the harness reads ``bench/configs/<config>.json`` and
``bench/traffic/<traffic>.json`` and, for each per-layer metric, the reader
``bench/metrics/<metric>.py``.  Nothing here imports torch."""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from pathlib import Path
from typing import Any, Callable, Dict, Iterable, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"

#: top-level module names a run may not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, bench: Optional[Dict[str, Any]] = None
              ) -> Dict[str, Any]:
    """The cell ``name`` with its configuration, traffic mix and the metrics
    that it reports: ``end_to_end`` and ``per_layer`` entries that list it
    under ``workloads`` or list no cells at all."""
    bench = load_benchmark() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}

    def reports(metric):
        return name in metric.get("workloads", [name])

    return {
        "workload": cell,
        "config": load_json(ROOT / configs[cell["config"]]["file"]),
        "traffic": load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def load_reader(metric: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    """``read(rec)`` of ``bench/metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def set_run_env(root: Path = ROOT) -> None:
    """Build and kernel caches at fixed paths inside the checkout, and no
    library that could load JAX behind the port's back."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    # the prefill rows are large and of few sizes: segments that grow in
    # place keep the caching allocator from fragmenting between them
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """Loaded modules whose top-level name (the part before the first dot)
    is one of :data:`FORBIDDEN`, compared whole: ``repro_torch`` is not
    ``repro``."""
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def nearest_rank(values: List[float], q: float) -> float:
    """The ``q``-th percentile by nearest rank (``inf`` entries, missing
    answers, sort last and count)."""
    if not values:
        return math.inf
    vals = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[k - 1]


#: what an infinite reading (a percentile over missing answers, a gap with
#: nothing to compare) is printed as: strict JSON has no infinity
MISSING = 1e18


def finite(obj: Any) -> Any:
    """``obj`` with every infinite or NaN float replaced by :data:`MISSING`."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return MISSING
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    return obj


def emit_result(result: Dict[str, Any], checks: Dict[str, Dict[str, Any]]
                ) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result line, with ``checks`` its last key, as the last
    line of standard output."""
    checks = finite(checks)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    out = finite(dict(result))
    out["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(out, allow_nan=False), flush=True)
