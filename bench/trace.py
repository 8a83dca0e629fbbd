"""The traced window: ``torch.profiler`` (CUPTI) over a fixed stretch of the
measured window, read into device-busy time, kernel times by name and the
longest idle gaps, each labelled with the benchmark's own span that the
host was in when the card went idle.

The profiler's events are read raw (``kineto_results.events()``), not
through ``key_averages``, which would build an event tree of every launch.
Host spans are stamped with ``time.time_ns()``, the profiler's own time
base."""
from __future__ import annotations

import re
import time
from typing import Any, Dict, List, Optional, Tuple

import torch


def _ns(ev, which: str) -> int:
    f = getattr(ev, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{which}_us")() * 1000)


def _on_device(ev) -> bool:
    return str(ev.device_type()).endswith("CUDA")


class Profile:
    """Start with :meth:`start`, end with :meth:`stop`, read with
    :meth:`collect`; then ``kernels`` (name, start_ns, dur_ns, correlation
    id), ``launches`` (host start_ns, correlation id) and
    ``t0_ns``/``t1_ns``."""

    def __init__(self):
        self._prof: Optional[torch.profiler.profile] = None
        self.kernels: List[Tuple[str, int, int, int]] = []
        self.launches: List[Tuple[int, int]] = []
        self.t0_ns = self.t1_ns = 0

    def start(self) -> None:
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.start()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self._prof.stop()

    def collect(self) -> None:
        """Read the stopped profiler's events (kept apart from :meth:`stop`,
        so that the reading, seconds of Python, can wait for the window's
        end)."""
        for ev in self._prof.profiler.kineto_results.events():
            if _on_device(ev):
                self.kernels.append((ev.name(), _ns(ev, "start"),
                                     int(ev.duration_ns()), ev.correlation_id()))
            elif "launch" in ev.name().lower():
                self.launches.append((_ns(ev, "start"), ev.correlation_id()))
        self._prof = None

    @staticmethod
    def warm_up(device) -> None:
        """Profile one small kernel, so that the profiler's first start (which
        can take seconds on a busy host) falls in set-up."""
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        torch.ones(1, device=device).add_(1)
        torch.cuda.synchronize()
        prof.stop()

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9


def busy_intervals(kernels) -> List[Tuple[int, int]]:
    """The union of the device's activity as sorted ``(start, end)`` ns."""
    out: List[List[int]] = []
    for _, s, d, _ in sorted(kernels, key=lambda k: k[1]):
        e = s + d
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(kernels) -> float:
    return sum(e - s for s, e in busy_intervals(kernels)) / 1e9


def kernel_seconds(kernels, pattern: str) -> Optional[float]:
    """Device seconds of the kernels whose name matches ``pattern`` (a
    regular expression searched in the name); None when none ran."""
    rx = re.compile(pattern)
    hits = [d for name, _, d, _ in kernels if rx.search(name)]
    return sum(hits) / 1e9 if hits else None


def _short(name: str) -> str:
    name = re.sub(r"^void ", "", name)
    return name[:100]


def breakdown(kernels, spans: List[Tuple[str, int, int]],
              t0_ns: int, t1_ns: int, top: int = 10) -> Dict[str, Any]:
    """The ``top`` device operations by time, and the ``top`` longest idle
    gaps of the traced window, each named by the innermost host span it
    began in."""
    per: Dict[str, int] = {}
    for name, _, d, _ in kernels:
        per[_short(name)] = per.get(_short(name), 0) + d
    ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    prev = t0_ns
    for s, e in busy_intervals(kernels) + [(t1_ns, t1_ns)]:
        if s > prev:
            gaps.append((prev, s - prev))
        prev = max(prev, e)
    gaps.sort(key=lambda g: -g[1])

    def label(t):
        inside = [(e - s, name) for name, s, e in spans if s <= t < e]
        return min(inside)[1] if inside else "host outside the benchmark's spans"

    idle = [[f"idle in {label(t)}", d / 1e9] for t, d in gaps[:top]]
    return {"device_ops": [[n, d / 1e9] for n, d in ops], "idle_gaps": idle}


def kernels_launched_in(kernels, launches, spans) -> float:
    """Device seconds of the kernels launched from inside ``spans`` (host
    ``(start_ns, end_ns)``), matched by correlation id."""
    ids = set()
    spans = sorted(spans)
    for t, corr in launches:
        for s, e in spans:
            if s <= t < e:
                ids.add(corr)
                break
    return sum(d for _, _, d, c in kernels if c in ids) / 1e9
