"""EngineClient: the thread-safe request-lifecycle API over the engine (the
port of the reference package's ``serving/client.py``).

``submit(GenerationRequest) -> RequestHandle`` returns immediately; the
handle exposes the lifecycle of one *logical* request (``n`` engine
requests for OpenAI-style multi-choice sampling):

* ``handle.stream()`` — typed :class:`TokenEvent` / :class:`FinishEvent`
  stream, a plain iterator **and** an async iterator (``async for`` parks
  on an ``asyncio.Event`` the engine thread sets through
  ``loop.call_soon_threadsafe``, so one event loop holds many open streams
  without a worker thread each);
* ``handle.result()`` / ``await handle.result_async()`` — wait until every
  choice finished, then return a :class:`GenerationResult`;
* ``handle.abort()`` / ``await handle.abort_async()`` — cancellation,
  applied by the engine thread at the next block boundary (the live slot
  is freed and its device row frozen);
* ``handle.status`` / ``handle.statuses`` — coarsest in-flight choice state
  and each choice's.

No torch call runs on an event loop's thread: the loop thread owns the
engine, and the async surface only waits on events it delivers.

One loop thread owns the engine and drives ``engine.step()``; submissions
and aborts are thread-safe and land at block boundaries.  With an
:class:`~repro_torch.core.admission.AdmissionController` attached,
``submit`` goes through it — a rate-limited or shed request raises the
typed 429/503 :class:`~repro_torch.core.admission.AdmissionError` — and the
loop thread releases admitted requests into the engine once per iteration,
in weighted-fair order, finishing the ones whose queue wait expired with a
typed ``timeout`` event.

Operations: a ``watchdog_timeout_s`` arms a sidecar thread that flips
readiness while one ``engine.step()`` overruns it; :meth:`EngineClient.drain`
stops admission (new submits get the 503 ``draining`` error), lets the
in-flight requests finish and, past its timeout, snapshots the live slots
and aborts the rest; :meth:`EngineClient.handoff_export` /
:meth:`EngineClient.handoff_import` move every open request, with its
handle, to another client (what :meth:`repro_torch.serving.router.Router.
drain_replica` is built on).
"""
from __future__ import annotations

import asyncio
import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.admission import (LEVEL_SHED_ALL, AdmissionController,
                                        Overloaded)
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import (FinishReason, GenerationRequest,
                                      Request, RequestStatus, StreamEvent)
from repro_torch.tracing import TRACER

log = logging.getLogger("repro_torch.client")

# lifecycle progress order used to aggregate a handle's per-choice states
_PROGRESS = {
    RequestStatus.QUEUED: 0,
    RequestStatus.PREFILLING: 1,
    RequestStatus.DECODING: 2,
    RequestStatus.FINISHED: 3,
    RequestStatus.ABORTED: 3,
    RequestStatus.FAILED: 3,
}


@dataclass
class TokenEvent:
    """One generated token for one choice of a handle."""

    index: int                    # choice index (0..n-1)
    token: int
    text: str                     # stop-sequence-filtered incremental text
    logprob: Optional[float] = None
    top_logprobs: Optional[List[Tuple[int, float]]] = None


@dataclass
class FinishEvent:
    """Terminal event for one choice; ``text`` carries any held-back tail."""

    index: int
    finish_reason: str    # "stop" | "length" | "abort" | "timeout" | "error"
    text: str = ""


@dataclass
class ChoiceResult:
    index: int
    text: str
    tokens: List[int]
    finish_reason: Optional[str]
    logprobs: List[Tuple[float, List[Tuple[int, float]]]] = field(default_factory=list)
    # completions `echo`: the prompt token ids and — when the request also
    # asked for logprobs — their teacher-forced logprobs (first entry None)
    prompt_token_ids: List[int] = field(default_factory=list)
    prompt_logprobs: Optional[List[Optional[float]]] = None


@dataclass
class GenerationResult:
    """Aggregate of all ``n`` choices of one handle."""

    choices: List[ChoiceResult]
    prompt_tokens: int

    @property
    def text(self) -> str:
        return self.choices[0].text

    @property
    def completion_tokens(self) -> int:
        return sum(len(c.tokens) for c in self.choices)

    def usage(self) -> Dict[str, int]:
        return {
            "prompt_tokens": self.prompt_tokens,
            "completion_tokens": self.completion_tokens,
            "total_tokens": self.prompt_tokens + self.completion_tokens,
        }


@dataclass
class HandoffRecord:
    """One open request leaving a draining client: the engine's record
    (the live request, an optional cache snapshot, the streaming codec
    state) and the client handle that moves with it.  Made by
    :meth:`EngineClient.handoff_export`, taken by
    :meth:`EngineClient.handoff_import`; in-process only (it carries live
    objects, not bytes)."""

    record: Dict[str, object]
    handle: Optional["RequestHandle"] = None

    @property
    def request(self) -> Request:
        return self.record["req"]  # type: ignore[return-value]


class HandleStream:
    """Single-consumer event stream of a handle: iterate synchronously or
    with ``async for``.  The async path waits on a per-consumer
    ``asyncio.Event`` that the engine thread sets with
    ``call_soon_threadsafe`` on every delivered event, so no worker thread
    is parked per open stream."""

    def __init__(self, q: "queue.Queue[Optional[object]]",
                 handle: "RequestHandle") -> None:
        self._q = q
        self._handle = handle
        self._ended = False

    def __iter__(self) -> "HandleStream":
        return self

    def __next__(self) -> object:
        if self._ended:
            raise StopIteration
        ev = self._q.get()
        if ev is None:
            self._ended = True
            raise StopIteration
        return ev

    def __aiter__(self):
        return self._agen()

    async def _agen(self):
        waker = self._handle._register_waker()
        try:
            while True:
                try:
                    ev = self._q.get_nowait()
                except queue.Empty:
                    waker.clear()
                    # check again after the clear: an event put between
                    # get_nowait and clear would otherwise be missed
                    try:
                        ev = self._q.get_nowait()
                    except queue.Empty:
                        await waker.wait()
                        continue
                if ev is None:
                    return
                yield ev
        finally:
            self._handle._unregister_waker(waker)


class RequestHandle:
    """Lifecycle handle for one submitted :class:`GenerationRequest`."""

    def __init__(self, client: "EngineClient", requests: List[Request]):
        self._client = client
        self._requests = requests
        self._index = {r.request_id: i for i, r in enumerate(requests)}
        self._queue: "queue.Queue[Optional[object]]" = queue.Queue()
        self._done = threading.Event()
        self._open = len(requests)
        self._lock = threading.Lock()
        # asyncio consumers: (loop, Event) pairs the engine thread wakes on
        # every delivered event (see HandleStream._agen)
        self._wakers: List[Tuple[asyncio.AbstractEventLoop,
                                 asyncio.Event]] = []

    @property
    def request_ids(self) -> List[int]:
        return [r.request_id for r in self._requests]

    @property
    def n(self) -> int:
        return len(self._requests)

    @property
    def prompt_tokens(self) -> int:
        return len(self._requests[0].prompt_tokens)

    @property
    def statuses(self) -> List[RequestStatus]:
        """Each choice's state."""
        return [r.status for r in self._requests]

    @property
    def status(self) -> RequestStatus:
        """Aggregate state: the least-advanced unfinished choice; terminal
        only when every choice is (ABORTED if any was aborted)."""
        states = self.statuses
        running = [s for s in states if _PROGRESS[s] < 3]
        if running:
            return min(running, key=lambda s: _PROGRESS[s])
        for terminal in (RequestStatus.ABORTED, RequestStatus.FAILED):
            if terminal in states:
                return terminal
        return RequestStatus.FINISHED

    @property
    def finished(self) -> bool:
        return self._done.is_set()

    def stream(self) -> HandleStream:
        """The handle's typed event stream (single consumer), sync or
        async."""
        return HandleStream(self._queue, self)

    def result(self, timeout: Optional[float] = None) -> GenerationResult:
        """Block until every choice finished (or aborted)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request not finished within {timeout}s")
        return self._result()

    async def result_async(self) -> GenerationResult:
        """Await completion without blocking a thread: the engine thread
        wakes this coroutine through the handle's waker list."""
        if not self._done.is_set():
            waker = self._register_waker()
            try:
                while not self._done.is_set():
                    waker.clear()
                    if self._done.is_set():
                        break
                    await waker.wait()
            finally:
                self._unregister_waker(waker)
        return self._result()

    # -- asyncio wakers (engine thread -> event loops) ------------------- #
    def _register_waker(self) -> asyncio.Event:
        loop = asyncio.get_running_loop()
        waker = asyncio.Event()
        with self._lock:
            self._wakers.append((loop, waker))
            waker.set()                  # force a first look at the queue
        return waker

    def _unregister_waker(self, waker: asyncio.Event) -> None:
        with self._lock:
            self._wakers = [(lp, w) for lp, w in self._wakers
                            if w is not waker]

    def _wake(self) -> None:
        with self._lock:
            wakers = list(self._wakers)
        for loop, waker in wakers:
            try:
                loop.call_soon_threadsafe(waker.set)
            except RuntimeError:         # the consumer's loop is closed
                pass

    def _result(self) -> GenerationResult:
        choices = [
            ChoiceResult(index=i, text=r.output_text,
                         tokens=list(r.output_tokens),
                         finish_reason=(r.finish_reason.value
                                        if r.finish_reason else None),
                         logprobs=list(r.output_logprobs),
                         prompt_token_ids=list(r.prompt_tokens),
                         prompt_logprobs=(None if r.prompt_logprobs is None
                                          else list(r.prompt_logprobs)))
            for i, r in enumerate(self._requests)]
        return GenerationResult(choices=choices,
                                prompt_tokens=self.prompt_tokens)

    def usage(self) -> Dict[str, int]:
        """OpenAI-style usage counts (prompt counted once across choices)."""
        done = sum(r.num_generated for r in self._requests)
        return {"prompt_tokens": self.prompt_tokens,
                "completion_tokens": done,
                "total_tokens": self.prompt_tokens + done}

    def abort(self, wait: bool = True, timeout: Optional[float] = 30.0) -> bool:
        """Cancel every unfinished choice at the next block boundary; with
        ``wait=True`` return once the ABORT finish events arrived."""
        if self._done.is_set():
            return True
        self._client._request_abort(self.request_ids)
        if not wait:
            return True
        return self._done.wait(timeout)

    async def abort_async(self) -> bool:
        """:meth:`abort` (waiting for the ABORT events) off the event
        loop's thread."""
        return await asyncio.to_thread(self.abort)

    def _on_event(self, ev: StreamEvent) -> None:
        """Fan one engine event into the typed stream (engine thread)."""
        idx = self._index[ev.request_id]
        if ev.finished:
            reason = (ev.finish_reason or FinishReason.ABORT).value
            self._queue.put(FinishEvent(idx, reason, ev.text))
            with self._lock:
                self._open -= 1
                last = self._open == 0
            if last:
                self._queue.put(None)          # stream sentinel
                self._done.set()
        elif ev.token is not None:
            self._queue.put(TokenEvent(idx, ev.token, ev.text, ev.logprob,
                                       ev.top_logprobs))
        else:
            return
        self._wake()


class EngineClient:
    """Thread-safe request-lifecycle front end that owns the engine, with an
    optional admission controller in front of it.  The loop thread never
    dies: request-scoped failures stay inside the engine's fault
    boundaries, and an exception escaping ``engine.step()`` fails the
    requests the engine holds with typed ERROR events and is logged."""

    def __init__(self, engine: InferenceEngine, *,
                 admission: Optional[AdmissionController] = None,
                 watchdog_timeout_s: Optional[float] = None,
                 auto_start: bool = True):
        self.engine = engine
        self._admission = admission
        self._cv = threading.Condition()
        self._handles: Dict[int, RequestHandle] = {}
        self._aborts: List[int] = []
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._loop_errors = 0
        # drain: _draining stops admission, _drain_cutoff runs the
        # snapshot-and-abort path, _drained tells drain() the loop is done
        self._draining = False
        self._drain_cutoff = False
        self._drained = threading.Event()
        # handoff: the loop thread exports every open request at a block
        # boundary, then ends (see handoff_export)
        self._handoff_requested = False
        self._handoff_records: List[HandoffRecord] = []
        self._handoff_done = threading.Event()
        # watchdog: _step_started is stamped around every loop body, and
        # the sidecar thread sets _wedged while one body overruns
        self.watchdog_timeout_s = watchdog_timeout_s
        self._step_started: Optional[float] = None
        self._wedged = False
        self._watchdog_trips = 0
        self._watchdog_thread: Optional[threading.Thread] = None
        # collapse the decode block to K=1 while an abort waits at the
        # boundary, so its slot is reclaimed after one device step
        engine.reclaim_hint = lambda: bool(self._aborts)
        # the degradation ladder's capacity probe, unless the caller gave one
        if admission is not None and admission.headroom_fn is None:
            admission.headroom_fn = self._headroom
        if auto_start:
            self.start()

    def _headroom(self) -> float:
        """Fraction of serving capacity still free: decode slots plus one
        engine queue's worth, bounded under the paged layout by the arena's
        free + reclaimable (cache-held) pages — long sequences can exhaust
        the arena while slots remain free."""
        sched = self.engine.scheduler
        cap = max(1, 2 * sched.max_batch)
        slots = max(0.0, 1.0 - (sched.num_active + len(sched.pending)) / cap)
        probe = getattr(self.engine.pool, "page_occupancy", None)
        if probe is None:
            return slots
        occ = probe()
        return min(slots, (occ["free"] + occ["reclaimable"])
                   / max(1, occ["total"]))

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        if self.watchdog_timeout_s is not None and self._watchdog_thread is None:
            self._watchdog_thread = threading.Thread(target=self._watchdog_run,
                                                     daemon=True)
            self._watchdog_thread.start()

    def submit(self, request: Union[GenerationRequest, Request]) -> RequestHandle:
        """Validate + enqueue; returns the lifecycle handle immediately.
        Invalid requests raise here, before anything is enqueued; with
        admission control, a rate-limited or shed request raises the typed
        :class:`~repro_torch.core.admission.AdmissionError` (429/503 with
        ``retry_after``) instead of queueing."""
        if isinstance(request, Request):
            reqs = [request]
        else:
            reqs = request.to_requests(self.engine.tokenizer)
        handle = RequestHandle(self, reqs)
        with self._cv:
            if self._stop:
                raise RuntimeError("EngineClient is stopped")
            if self._draining and self._admission is None:
                raise Overloaded("server is draining; retry against "
                                 "another replica", retry_after=1.0,
                                 code="draining")
            admitted: List[Request] = []
            try:
                if self._admission is not None:
                    # validation errors raise here, not later on the loop
                    # thread, so validate before the admission queue
                    for r in reqs:
                        self.engine.validate_request(r)
                    for r in reqs:
                        self._admission.submit(r)
                        admitted.append(r)
                else:
                    for r in reqs:
                        self.engine.add_request(r)
                        admitted.append(r)
            except BaseException:
                # roll back the partial fan-out so no orphan choice decodes
                for r in admitted:
                    if self._admission is not None:
                        self._admission.drop(r.request_id)
                    else:
                        self._aborts.append(r.request_id)
                self._cv.notify()
                raise
            for r in reqs:
                self._handles[r.request_id] = handle
            self._cv.notify()
        return handle

    def generate(self, request: Union[GenerationRequest, Request]) -> GenerationResult:
        """Blocking convenience: submit + wait."""
        return self.submit(request).result()

    def stats(self) -> Dict[str, object]:
        out = dict(self.engine.scheduler.snapshot())
        out["loop_errors"] = self._loop_errors
        out["content_cache"] = self.engine.content_cache_stats()
        out["speculation"] = self.engine.speculation_stats()
        out["prefill_groups"] = dict(self.engine.group_stats)
        out["draining"] = self._draining
        out["watchdog"] = {"timeout_s": self.watchdog_timeout_s,
                           "wedged": self._wedged,
                           "trips": self._watchdog_trips}
        if self._admission is not None:
            out["admission"] = self._admission.snapshot()
        if self.engine.faults is not None:
            out["faults"] = self.engine.faults.snapshot()
        return out

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def ready(self) -> bool:
        """Readiness: alive, not wedged past the watchdog, not draining and
        not shedding all traffic (load balancers route away before clients
        see 503 bodies)."""
        if not self.alive or self._wedged or self._draining:
            return False
        return (self._admission is None
                or self._admission.level < LEVEL_SHED_ALL)

    @property
    def draining(self) -> bool:
        return self._draining

    def _request_abort(self, request_ids: List[int]) -> None:
        with self._cv:
            self._aborts.extend(request_ids)
            self._cv.notify()

    def _has_work(self) -> bool:
        return self.engine.scheduler.has_work or (
            self._admission is not None and self._admission.queue_depth > 0)

    def _run(self) -> None:
        while True:
            with TRACER.span("client.loop"):
                if not self._iteration():
                    return

    def _iteration(self) -> bool:
        """One turn of the loop thread, traced as ``client.loop``: wait for
        work (``client.wait``), apply aborts and release admitted requests
        (``client.admission``), step the engine, deliver the events
        (``client.deliver``, n = events).  False once the loop ends."""
        engine = self.engine
        with self._cv:
            while (not self._has_work() and not self._aborts
                   and not self._stop and not self._drain_cutoff
                   and not self._draining):
                with TRACER.span("client.wait"):
                    self._cv.wait(timeout=0.5)
            if self._stop:
                self._shutdown_locked()
                self._drained.set()
                self._handoff_done.set()
                return False
            if self._handoff_requested:
                # block boundary: the engine is quiescent, so export
                # every open request and end the loop; the handles
                # move with the records (no finish events)
                self._handoff_requested = False
                self._handoff_export_locked()
                self._stop = True
                self._drained.set()
                self._handoff_done.set()
                return False
            if (self._draining and not self._drain_cutoff
                    and not self._has_work() and not self._aborts):
                # drained: everything in flight finished and the
                # admission queue is empty — park and tell drain()
                self._drained.set()
                self._cv.wait(timeout=0.5)
                return True
            cutoff, self._drain_cutoff = self._drain_cutoff, False
            aborts, self._aborts = self._aborts, []
        events: List[StreamEvent] = []
        self._step_started = time.monotonic()
        try:
            with TRACER.span("client.admission"):
                # aborts land at the block boundary, before the next
                # admission plan: the freed slot is reusable in this step;
                # a request still waiting at admission is dropped there
                for rid in aborts:
                    dropped = (self._admission.drop(rid)
                               if self._admission is not None else None)
                    if dropped is not None:
                        events.extend(self._finish_unstarted(
                            dropped, FinishReason.ABORT,
                            RequestStatus.ABORTED))
                    else:
                        events.extend(engine.abort(rid))
                if self._admission is not None:
                    events.extend(self._admission_round())
            if cutoff:
                events.extend(self._drain_cutoff_events())
            elif engine.scheduler.has_work:
                events.extend(engine.step())
        except Exception:
            log.exception("engine loop error: failing in-flight requests")
            self._loop_errors += 1
            events.extend(self._fail_all())
        finally:
            self._step_started = None
        with self._cv, TRACER.span("client.deliver", n=len(events)):
            for ev in events:
                handle = self._handles.get(ev.request_id)
                if handle is not None:
                    handle._on_event(ev)
                    if ev.finished:
                        del self._handles[ev.request_id]
            if cutoff:
                self._drained.set()
        return not cutoff

    @staticmethod
    def _finish_unstarted(req: Request, reason: FinishReason,
                          status: RequestStatus,
                          error: Optional[str] = None) -> List[StreamEvent]:
        """Terminal event of a request that never reached the engine (still
        in the admission queue): a queue-wait timeout or an abort."""
        req.finish_reason = reason
        req.status = status
        req.finish_time = time.monotonic()
        req.error = error
        return [StreamEvent(req.request_id, None, "", finished=True,
                            finish_reason=reason)]

    def _admission_round(self) -> List[StreamEvent]:
        """One fair-release round: expire overdue waiters (typed
        ``timeout`` finishes) and release up to the engine queue's
        headroom in weighted-fair order."""
        sched = self.engine.scheduler
        ready, expired = self._admission.poll(
            max(0, sched.max_batch - len(sched.pending)))
        events: List[StreamEvent] = []
        for req in expired:
            events.extend(self._finish_unstarted(
                req, FinishReason.TIMEOUT, RequestStatus.FAILED,
                error=(f"queue-wait timeout after "
                       f"{self._admission.queue_timeout_s:g}s")))
        for req in ready:
            self.engine.add_request(req)       # validated at submit
        return events

    def _drain_cutoff_events(self) -> List[StreamEvent]:
        """The drain timed out: snapshot + abort everything in the engine,
        and finish whatever still waits at admission."""
        events = list(self.engine.drain_snapshot())
        if self._admission is not None:
            ready, expired = self._admission.poll(1 << 30)
            for req in expired:
                events.extend(self._finish_unstarted(
                    req, FinishReason.TIMEOUT, RequestStatus.FAILED,
                    error="queue-wait timeout at drain"))
            for req in ready:
                events.extend(self._finish_unstarted(
                    req, FinishReason.ABORT, RequestStatus.ABORTED))
        return events

    def _watchdog_run(self) -> None:
        """Sidecar thread: detect a wedged ``engine.step()`` (one loop body
        overrunning ``watchdog_timeout_s``).  A thread cannot be killed
        safely, so the watchdog's contract is visibility: flip readiness,
        log, and recover once the step completes."""
        timeout = self.watchdog_timeout_s
        interval = max(0.005, min(0.5, timeout / 4))
        while not self._stop:
            t0 = self._step_started
            if t0 is not None and time.monotonic() - t0 > timeout:
                if not self._wedged:
                    self._wedged = True
                    self._watchdog_trips += 1
                    log.error("engine step wedged for > %.3fs (watchdog): "
                              "readiness flips until the step completes",
                              timeout)
            else:
                self._wedged = False
            time.sleep(interval)

    def drain(self, timeout: Optional[float] = 30.0) -> bool:
        """Graceful drain (``POST /admin/drain``, SIGTERM): stop admitting
        (``submit`` raises the 503 ``draining`` error, ``/readyz`` flips),
        let the in-flight requests finish, then stop the loop.  Past
        ``timeout`` seconds the live slots are snapshotted to the prefix
        cache and every open request ends with its typed event.  True when
        the drain finished without the cutoff.  Idempotent."""
        with self._cv:
            if not self._draining:
                self._draining = True
                if self._admission is not None:
                    self._admission.start_drain()
            self._cv.notify_all()
        finished = self._drained.wait(timeout)
        if not finished:
            with self._cv:
                self._drain_cutoff = True
                self._cv.notify_all()
            self._drained.wait(10.0)
        self.stop()
        return finished

    # ------------------------------------------------------------------ #
    # handoff to another client (a rolling restart)
    # ------------------------------------------------------------------ #
    def handoff_export(self, timeout: Optional[float] = 30.0
                       ) -> List[HandoffRecord]:
        """Drain this client *into records*: stop admitting, let the loop
        reach its next block boundary, export every open request (live
        slots as cache snapshots, the rest as re-prefill records — see
        :meth:`InferenceEngine.export_handoff`) and end the loop.  The
        records carry the requests and their handles; a successor's
        :meth:`handoff_import` resumes every stream, and no consumer sees
        a finish event for the hop.  The client is stopped afterwards."""
        with self._cv:
            if self._stop:
                return []
            self._draining = True
            if self._admission is not None:
                self._admission.start_drain()
            self._handoff_requested = True
            self._cv.notify_all()
        if not self._handoff_done.wait(timeout):
            raise TimeoutError(f"handoff export not finished in {timeout}s")
        records, self._handoff_records = self._handoff_records, []
        return records

    def _handoff_export_locked(self) -> None:
        """The loop thread's half of :meth:`handoff_export` (holds _cv)."""
        records: List[HandoffRecord] = []
        # admission waiters first: overdue ones expire with their typed
        # timeout, the rest become re-prefill records
        if self._admission is not None:
            ready, expired = self._admission.poll(1 << 30)
            for req in expired:
                for ev in self._finish_unstarted(
                        req, FinishReason.TIMEOUT, RequestStatus.FAILED,
                        error="queue-wait timeout at handoff"):
                    handle = self._handles.pop(ev.request_id, None)
                    if handle is not None:
                        handle._on_event(ev)
            for req in ready:
                records.append(HandoffRecord(record={
                    "req": req, "cache": None, "ctx_valid": None,
                    "streamer": None, "stopchk": None}))
        for rec in self.engine.export_handoff():
            records.append(HandoffRecord(record=rec))
        for hr in records:
            hr.handle = self._handles.pop(hr.request.request_id, None)
        self._handoff_records = records

    def handoff_import(self, records: List[HandoffRecord]) -> int:
        """Adopt another client's exported requests: the engine seeds its
        resume tables (a cache snapshot restores through the preemption
        resume path), and each handle re-binds to this client, so its
        consumer keeps iterating the same stream.  Admission control is
        bypassed (they were admitted once).  Returns the number adopted."""
        adopted = 0
        with self._cv:
            if self._stop:
                raise RuntimeError("EngineClient is stopped")
            for hr in records:
                req = hr.request
                if req.is_finished:
                    continue
                self.engine.import_handoff(hr.record)
                if hr.handle is not None:
                    hr.handle._client = self
                    self._handles[req.request_id] = hr.handle
                adopted += 1
            self._cv.notify_all()
        return adopted

    def _fail_all(self) -> List[StreamEvent]:
        """After an unexpected engine error the device state of every slot
        is suspect: abort everything the engine holds and report each
        request as failed."""
        events: List[StreamEvent] = []
        sched = self.engine.scheduler
        for req in list(sched.active.values()) + list(sched.pending):
            for ev in self.engine.abort(req.request_id):
                req.finish_reason = ev.finish_reason = FinishReason.ERROR
                req.status = RequestStatus.FAILED
                req.error = "engine step failed"
                events.append(ev)
        return events

    def _shutdown_locked(self) -> None:
        """Terminate every in-flight consumer with an ABORT finish event."""
        for rid, handle in list(self._handles.items()):
            for r in handle._requests:
                if r.request_id == rid and not r.is_finished:
                    r.finish_reason = FinishReason.ABORT
                    r.status = RequestStatus.ABORTED
            handle._on_event(StreamEvent(rid, None, "", finished=True,
                                         finish_reason=FinishReason.ABORT))
        self._handles.clear()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5)

    close = stop

    def __enter__(self) -> "EngineClient":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
