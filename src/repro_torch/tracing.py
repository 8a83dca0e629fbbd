"""The port's host-side tracer: spans at the layer boundaries, kept in memory.

One process-wide :data:`TRACER`.  While it is on, ``with TRACER.span(name,
rid=-1, n=0):`` records a :class:`Record` when the block ends: its name,
start and end on ``time.time_ns()`` (the clock ``torch.profiler`` stamps
host events with, so a span lines up with the card's kernels), the CPU time
its thread consumed inside it (``time.thread_time_ns()``: wall minus CPU is
the time the thread was blocked or waiting for the interpreter lock), its
id, the id of the innermost span open on the same thread when it began
(-1 for none), the thread, a request id and one count ``n`` the span's work
carries (K, rows, tokens, bytes).  A span may set ``n`` before it ends
(``with TRACER.span(...) as sp: ...; sp.n = rows``).

While it is off, :meth:`Tracer.span` returns one shared no-op after a
single attribute check: no clock is read and nothing is allocated or
appended.  Call sites whose own bookkeeping costs something test
``TRACER.on`` first.

Counters are not kept here: each layer counts on its own stats object,
always, and serves them on ``GET /stats``.

    from repro_torch.tracing import TRACER
    TRACER.start()
    ...                      # serve or train
    TRACER.stop()
    spans = TRACER.records()
"""
from __future__ import annotations

import itertools
import threading
from time import monotonic_ns, thread_time_ns, time_ns
from typing import List, NamedTuple


class Record(NamedTuple):
    """One finished span; times in ns on ``time.time_ns()``'s clock."""

    name: str
    start: int
    end: int
    cpu: int          # thread CPU time inside the span; 0 where not measured
    id: int
    parent: int       # innermost span open on the same thread, or -1
    thread: int       # threading.get_ident() of the recording thread
    rid: int          # request id, or -1
    n: int


class _Stack(threading.local):
    def __init__(self):
        self.open: List["_Span"] = []


class _Off:
    """The shared span handed out while the tracer is off."""

    __slots__ = ("n",)

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("tracer", "name", "rid", "n", "id", "parent", "t0", "c0")

    def __init__(self, tracer: "Tracer", name: str, rid: int, n: int):
        self.tracer, self.name, self.rid, self.n = tracer, name, rid, n

    def __enter__(self) -> "_Span":
        tr = self.tracer
        stack = tr._stack.open
        self.parent = stack[-1].id if stack else -1
        self.id = next(tr._ids)
        stack.append(self)
        self.c0 = thread_time_ns()
        self.t0 = time_ns()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time_ns()
        c1 = thread_time_ns()
        tr = self.tracer
        tr._stack.open.pop()
        tr._records.append(Record(
            self.name, self.t0, t1, c1 - self.c0, self.id, self.parent,
            threading.get_ident(), self.rid, self.n))


class Tracer:
    """Spans in memory between :meth:`start` and :meth:`stop`."""

    def __init__(self):
        self.on = False
        self._records: List[Record] = []
        self._stack = _Stack()
        self._ids = itertools.count()
        self._offset = 0      # time_ns() - monotonic_ns(), taken at start

    def start(self) -> None:
        """Drop what an earlier stretch recorded and begin recording."""
        self._records = []
        self._offset = time_ns() - monotonic_ns()
        self.on = True

    def stop(self) -> None:
        """Stop recording; spans still open are kept when they end."""
        self.on = False

    def records(self) -> List[Record]:
        return list(self._records)

    def span(self, name: str, rid: int = -1, n: int = 0):
        if not self.on:
            return _OFF
        return _Span(self, name, rid, n)

    def record(self, name: str, start_s: float, end_s: float,
               rid: int = -1, n: int = 0) -> None:
        """A span between two ``time.monotonic()`` stamps the caller already
        holds (a request's arrival, a job's open), moved onto the spans'
        clock with the offset taken at :meth:`start`.  Its CPU time is not
        measured, and it has no parent."""
        self._records.append(Record(
            name, int(start_s * 1e9) + self._offset,
            int(end_s * 1e9) + self._offset, 0, next(self._ids), -1,
            threading.get_ident(), rid, n))


#: the process's tracer
TRACER = Tracer()
