"""EngineClient: the thread-safe request-lifecycle API over the engine (the
port of the reference package's ``serving/client.py``, without admission
control, watchdog, drain or handoff — it behaves as the reference server
does under ``--no-admission``).

``submit(GenerationRequest) -> RequestHandle`` returns immediately; the
handle exposes the lifecycle of one *logical* request (``n`` engine
requests for OpenAI-style multi-choice sampling):

* ``handle.stream()`` — typed :class:`TokenEvent` / :class:`FinishEvent`
  stream (a plain iterator);
* ``handle.result()`` — block until every choice finished, then return a
  :class:`GenerationResult`;
* ``handle.abort()`` — cancellation, applied by the engine thread at the
  next block boundary (the live slot is freed and its device row frozen);
* ``handle.status`` — coarsest in-flight choice state.

One loop thread owns the engine and drives ``engine.step()``; submissions
and aborts are thread-safe and land at block boundaries.
"""
from __future__ import annotations

import logging
import queue
import threading
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple, Union

from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import (FinishReason, GenerationRequest,
                                      Request, RequestStatus, StreamEvent)

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
    finish_reason: str    # "stop" | "length" | "abort" | "error"
    text: str = ""


@dataclass
class ChoiceResult:
    index: int
    text: str
    tokens: List[int]
    finish_reason: Optional[str]
    logprobs: List[Tuple[float, List[Tuple[int, float]]]] = field(default_factory=list)


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
    def status(self) -> RequestStatus:
        """Aggregate state: the least-advanced unfinished choice; terminal
        only when every choice is (ABORTED if any was aborted)."""
        states = [r.status for r in self._requests]
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

    def stream(self) -> Iterator[object]:
        """The handle's typed event stream (single consumer)."""
        while True:
            ev = self._queue.get()
            if ev is None:
                return
            yield ev

    def result(self, timeout: Optional[float] = None) -> GenerationResult:
        """Block until every choice finished (or aborted)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request not finished within {timeout}s")
        choices = [
            ChoiceResult(index=i, text=r.output_text,
                         tokens=list(r.output_tokens),
                         finish_reason=(r.finish_reason.value
                                        if r.finish_reason else None),
                         logprobs=list(r.output_logprobs))
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


class EngineClient:
    """Thread-safe request-lifecycle front end that owns the engine.  The
    loop thread never dies: an exception escaping ``engine.step()`` fails
    the requests the engine holds with typed ERROR events and is logged."""

    def __init__(self, engine: InferenceEngine, *, auto_start: bool = True):
        self.engine = engine
        self._cv = threading.Condition()
        self._handles: Dict[int, RequestHandle] = {}
        self._aborts: List[int] = []
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._loop_errors = 0
        # collapse the decode block to K=1 while an abort waits at the
        # boundary, so its slot is reclaimed after one device step
        engine.reclaim_hint = lambda: bool(self._aborts)
        if auto_start:
            self.start()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, request: Union[GenerationRequest, Request]) -> RequestHandle:
        """Validate + enqueue; returns the lifecycle handle immediately.
        Invalid requests raise here, before anything is enqueued."""
        if isinstance(request, Request):
            reqs = [request]
        else:
            reqs = request.to_requests(self.engine.tokenizer)
        handle = RequestHandle(self, reqs)
        with self._cv:
            if self._stop:
                raise RuntimeError("EngineClient is stopped")
            admitted: List[Request] = []
            try:
                for r in reqs:
                    self.engine.add_request(r)
                    admitted.append(r)
            except BaseException:
                # roll back the partial fan-out so no orphan choice decodes
                self._aborts.extend(r.request_id for r in admitted)
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
        return out

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _request_abort(self, request_ids: List[int]) -> None:
        with self._cv:
            self._aborts.extend(request_ids)
            self._cv.notify()

    def _run(self) -> None:
        engine = self.engine
        while True:
            with self._cv:
                while (not engine.scheduler.has_work and not self._aborts
                       and not self._stop):
                    self._cv.wait(timeout=0.5)
                if self._stop:
                    self._shutdown_locked()
                    return
                aborts, self._aborts = self._aborts, []
            events: List[StreamEvent] = []
            try:
                # aborts land at the block boundary, before the next
                # admission plan: the freed slot is reusable in this step
                for rid in aborts:
                    events.extend(engine.abort(rid))
                if engine.scheduler.has_work:
                    events.extend(engine.step())
            except Exception:
                log.exception("engine loop error: failing in-flight requests")
                self._loop_errors += 1
                events.extend(self._fail_all())
            with self._cv:
                for ev in events:
                    handle = self._handles.get(ev.request_id)
                    if handle is not None:
                        handle._on_event(ev)
                        if ev.finished:
                            del self._handles[ev.request_id]

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
