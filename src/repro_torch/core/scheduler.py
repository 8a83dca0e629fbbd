"""Continuous batching scheduler — paper Algorithm 1, slot-based for TPU,
with pluggable scheduling policies, speculative-fill hooks, and preemption.

The paper's loop:  admit pending requests while |B| < M at token boundaries;
generate one token for every active request; retire completed requests
immediately.  On TPU the batch is a fixed set of ``max_batch`` slots (static
shapes — DESIGN.md §2); admission binds a request to a free slot, retirement
frees it.  The scheduler owns request bookkeeping only — the engine owns the
compiled step functions and cache pool.

Beyond Alg.1, the scheduler owns the *prefill chunk queue*: a request whose
prompt is split into fixed-size prefill chunks parks a chunk job here between
engine steps, and :meth:`plan_decode_block` collapses the decode block to one
token while any chunk (or pending request) is waiting — the interleave policy
that keeps TTFT flat while long prompts prefill piecewise behind in-flight
decode blocks.

Ordering is policy-driven (:class:`SchedulingPolicy`): a policy defines one
total order over requests (smaller key = more urgent) that is applied to
**admission** (which pending request binds to a freed slot), to the **chunk
queue** (which prefill job's rows lead a wave, and therefore commit/TTFT
order), and to **preemption** (an urgent pending request may evict the
worst active slot — see ``InferenceEngine._plan_preemptions``).  FIFO is the
default and is never preemptive; ``priority`` orders by the request's
integer priority; ``edf`` is earliest-deadline-first (deadline-less requests
sort behind every deadline and fall back to priority/arrival order)."""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple, Union

from repro_torch.core.request import Request


# --------------------------------------------------------------------------- #
# scheduling policies
# --------------------------------------------------------------------------- #
class SchedulingPolicy:
    """Total order over requests: ``key(a) < key(b)`` means a is more
    urgent.  Keys must be static per request *within one planning pass* so
    preemption decisions cannot oscillate: anti-starvation aging uses a
    clock frozen by :meth:`tick` (called once per engine step), never a
    live ``time.monotonic()`` read inside ``key``."""

    name = "base"
    #: whether an urgent pending request may evict an active slot (the
    #: engine additionally gates this behind its ``preemption`` knob)
    preemptive = False
    #: lazy anti-starvation aging quantum in seconds (0 = off): every
    #: ``aging_s`` of queue wait adds one effective priority level, so a
    #: deadline-less batch request under sustained interactive load
    #: eventually outranks fresh arrivals (worst-case wait is bounded by
    #: ``aging_s * priority_gap`` — pinned in tests/test_sched_policy.py)
    aging_s: float = 0.0

    def __init__(self, aging_s: Optional[float] = None):
        if aging_s is not None:
            self.aging_s = aging_s
        # frozen planning clock: -inf until the first tick, so aging is a
        # no-op for callers that never tick (pure-ordering tests, seeds)
        self._now = -math.inf

    def tick(self, now: float) -> None:
        """Freeze the aging clock for the next planning pass."""
        self._now = now

    def _age_boost(self, req: Request) -> int:
        """Whole priority levels gained by queue wait (lazy: derived from
        the frozen clock at key time — nothing is stored per request)."""
        if self.aging_s <= 0 or self._now == -math.inf:
            return 0
        return max(0, int((self._now - req.arrival_time) / self.aging_s))

    def key(self, req: Request) -> Tuple:
        raise NotImplementedError

    def more_urgent(self, a: Request, b: Request) -> bool:
        return self.key(a) < self.key(b)


class FIFOPolicy(SchedulingPolicy):
    """Strict arrival order (the seed behaviour).  Never preempts: an
    earlier arrival is by definition at least as urgent as anything that
    could ask for its slot.  Aging is meaningless under FIFO (arrival
    order already is the age order)."""

    name = "fifo"
    preemptive = False

    def key(self, req: Request) -> Tuple:
        return (req.arrival_time, req.request_id)


class PriorityPolicy(SchedulingPolicy):
    """Higher ``Request.priority`` first; FIFO within a priority level.
    With aging on (default one level per ``aging_s=30``), a long-waiting
    low-priority request climbs one level per quantum waited, so sustained
    high-priority load cannot starve it forever: a priority-0 request
    outranks fresh priority-p arrivals after at most ``p * aging_s``."""

    name = "priority"
    preemptive = True
    aging_s = 30.0

    def key(self, req: Request) -> Tuple:
        return (-(req.priority + self._age_boost(req)), req.arrival_time,
                req.request_id)


class EDFPolicy(SchedulingPolicy):
    """Earliest-deadline-first.  Deadline-less requests used to sort at
    ``+inf`` (behind every deadline — unbounded starvation under sustained
    deadline load); they now carry a *virtual deadline* of
    ``arrival + aging_horizon_s``, so a batch request that has waited
    close to the horizon sorts ahead of fresh tight-deadline arrivals.
    The worst-case wait bound is therefore ``aging_horizon_s`` plus one
    admission round.  Ties fall back to (aged) priority, then arrival."""

    name = "edf"
    preemptive = True
    aging_s = 30.0
    #: virtual deadline for deadline-less requests, seconds after arrival
    #: (math.inf restores the pre-aging sort-behind-everything behaviour)
    aging_horizon_s = 60.0

    def __init__(self, aging_s: Optional[float] = None,
                 aging_horizon_s: Optional[float] = None):
        super().__init__(aging_s)
        if aging_horizon_s is not None:
            self.aging_horizon_s = aging_horizon_s

    def key(self, req: Request) -> Tuple:
        d = req.deadline_at
        if d is None:
            d = req.arrival_time + self.aging_horizon_s
        return (d, -(req.priority + self._age_boost(req)),
                req.arrival_time, req.request_id)


POLICIES = {p.name: p for p in (FIFOPolicy, PriorityPolicy, EDFPolicy)}


def make_policy(policy: Union[str, SchedulingPolicy, None],
                aging_s: Optional[float] = None) -> SchedulingPolicy:
    if isinstance(policy, SchedulingPolicy):
        return policy
    if policy is None:
        return FIFOPolicy()
    try:
        cls = POLICIES[policy]
    except KeyError:
        raise ValueError(f"unknown scheduling policy {policy!r} "
                         f"(have: {sorted(POLICIES)})") from None
    return cls(aging_s)


# --------------------------------------------------------------------------- #
def _percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile without a numpy dependency in the core."""
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, round(q / 100.0 * (len(vs) - 1))))
    return vs[idx]


@dataclass
class SchedulerStats:
    admitted: int = 0
    retired: int = 0
    steps: int = 0               # host-loop iterations (one per decode block)
    device_steps: int = 0        # decode iterations run on-device (sum of K)
    tokens_generated: int = 0
    peak_batch: int = 0
    prefill_waves: int = 0       # batched prefill dispatches (≥1 row each)
    prefill_chunks: int = 0      # chunk forward passes (= rows) in the waves
    spec_jobs: int = 0           # speculative prefill jobs opened
    spec_chunks: int = 0         # wave rows that carried speculative chunks
    spec_admitted: int = 0       # admissions that reused speculative progress
    preemptions: int = 0         # active slots evicted for urgent requests
    resumed: int = 0             # evicted requests resumed from a snapshot
    aborted: int = 0             # requests cancelled before finishing
    failed: int = 0              # requests failed by per-request fault
                                 # isolation (prefill/decode/codec errors)

    @property
    def host_syncs_per_token(self) -> float:
        """Host↔device round-trips per generated token (1.0 in the
        single-step engine; ~1/K with block decode)."""
        return self.steps / max(self.tokens_generated, 1)

    @property
    def rows_per_wave(self) -> float:
        """Mean admission-wave width (1.0 = the sequential pre-wave path)."""
        return self.prefill_chunks / max(self.prefill_waves, 1)


#: per-class latency window: enough for stable p95 without unbounded memory
_LAT_WINDOW = 512


class ContinuousBatchingScheduler:
    def __init__(self, max_batch: int,
                 policy: Union[str, SchedulingPolicy, None] = None,
                 aging_s: Optional[float] = None):
        self.max_batch = max_batch
        self.policy = make_policy(policy, aging_s)
        # pending is kept in arrival order; admission selects the policy
        # minimum (O(n) per admit — queues here are tens of requests, and a
        # heap would pessimise the dominant FIFO case for no measurable win)
        self.pending: List[Request] = []
        self.active: Dict[int, Request] = {}       # slot -> request
        # prefill chunk jobs (opaque engine payloads) waiting for their next
        # chunk forward pass; one chunk per job per engine step, drained in
        # policy order each wave
        self.chunk_queue: Deque[Any] = deque()
        self.stats = SchedulerStats()
        # per-class latency accounting (read by /stats handler threads while
        # the engine loop appends — guarded by a lock so a snapshot is
        # internally consistent)
        self._lat_lock = threading.Lock()
        self._lat: Dict[str, Deque[Tuple[float, float]]] = {}
        self._lat_count: Dict[str, int] = {}
        self._lat_miss: Dict[str, int] = {}

    # ------------------------------------------------------------------ #
    def add(self, request: Request) -> None:
        self.pending.append(request)

    def _pop_next(self, eligible: Optional[Callable[[Request], bool]] = None
                  ) -> Optional[Request]:
        cand = (self.pending if eligible is None
                else [r for r in list(self.pending) if eligible(r)])
        if not cand:
            return None
        req = min(cand, key=self.policy.key)
        self.pending.remove(req)
        return req

    def peek_pending(self,
                     eligible: Optional[Callable[[Request], bool]] = None
                     ) -> Optional[Request]:
        """Most urgent pending request under the policy (None if empty).
        ``eligible`` filters candidates — the engine passes its media
        -admissibility predicate so requests still waiting on an in-flight
        encode wave never block the admission head.  Tolerates concurrent
        appends from submission threads."""
        snapshot = list(self.pending)
        if eligible is not None:
            snapshot = [r for r in snapshot if eligible(r)]
        if not snapshot:
            return None
        return min(snapshot, key=self.policy.key)

    def pending_in_order(self) -> List[Request]:
        """Pending requests sorted most-urgent-first (a snapshot; used by
        the engine to pick speculative-prefill candidates)."""
        return sorted(list(self.pending), key=self.policy.key)

    def admit(self, free_slots: List[int],
              eligible: Optional[Callable[[Request], bool]] = None
              ) -> List[Tuple[int, Request]]:
        """Alg.1 lines 3-6: fill free slots from the pending queue in policy
        order (called at a token boundary, before the next step).
        ``eligible`` mirrors :meth:`peek_pending` — ineligible requests stay
        queued without losing their policy-order position."""
        admitted = []
        for slot in free_slots:
            if len(self.active) >= self.max_batch:
                break
            req = self._pop_next(eligible)
            if req is None:
                break
            self.active[slot] = req
            admitted.append((slot, req))
            self.stats.admitted += 1
        self.stats.peak_batch = max(self.stats.peak_batch, len(self.active))
        return admitted

    def retire(self, slot: int) -> Request:
        """Alg.1 lines 12-16: remove a completed request immediately."""
        req = self.active.pop(slot)
        self.stats.retired += 1
        self.record_latency(req)
        return req

    # ------------------------------------------------------------------ #
    # cancellation (engine.abort bookkeeping; see DESIGN_engine_client.md)
    # ------------------------------------------------------------------ #
    def abort_pending(self, request_id: int) -> Optional[Request]:
        """Drop a not-yet-admitted request from the pending queue."""
        for req in list(self.pending):
            if req.request_id == request_id:
                self.pending.remove(req)
                return req
        return None

    def abort_slot(self, slot: int) -> Request:
        """Release an active slot whose request was cancelled.  Unlike
        :meth:`retire`, the request does not count as served and is kept out
        of the per-class latency window (an abort is not a latency sample —
        it would poison the p95 the window exists to track)."""
        return self.active.pop(slot)

    def drop_prefill_jobs(self, request_id: int) -> List[Any]:
        """Remove (and return) the chunk-queue jobs of a cancelled request
        so its remaining prompt chunks never ride another wave."""
        dropped = [job for job in self.chunk_queue
                   if getattr(getattr(job, "req", None), "request_id", None)
                   == request_id]
        for job in dropped:
            self.chunk_queue.remove(job)
        return dropped

    # ------------------------------------------------------------------ #
    # preemption (policy-gated; mechanics live in the engine)
    # ------------------------------------------------------------------ #
    def select_victim(self, eligible_slots, max_preemptions: int
                      ) -> Optional[Tuple[int, Request]]:
        """Least urgent active request among ``eligible_slots`` (the engine
        passes its live-decode slot set: mid-prefill slots are not worth
        evicting — their cache is partial and their slot frees soonest by
        just finishing).  Requests already evicted ``max_preemptions`` times
        are exempt, bounding re-eviction churn."""
        candidates = [(slot, req) for slot, req in self.active.items()
                      if slot in eligible_slots
                      and req.preempt_count < max_preemptions]
        if not candidates:
            return None
        return max(candidates, key=lambda sr: self.policy.key(sr[1]))

    def requeue(self, slot: int) -> Request:
        """Evict the slot's request back to the pending queue (preemption).
        The engine owns the cache/decode-state snapshot that makes the
        eviction resumable; here it is pure bookkeeping."""
        req = self.active.pop(slot)
        req.preempt_count += 1
        self.stats.preemptions += 1
        self.pending.append(req)
        return req

    # ------------------------------------------------------------------ #
    # prefill chunk queue (batched/chunked admission pipeline)
    # ------------------------------------------------------------------ #
    def enqueue_prefill(self, job: Any) -> None:
        """Park a prefill chunk job until the engine's next wave dispatch."""
        self.chunk_queue.append(job)

    def pop_prefill_wave(self) -> List[Any]:
        """Drain the chunk queue for one wave in policy order (every
        in-flight job advances one chunk per engine step; the policy decides
        which job's rows lead the wave and therefore commit first).  Jobs
        without a ``req`` attribute (opaque payloads in tests) keep FIFO
        order ahead of the rest."""
        wave = list(self.chunk_queue)
        self.chunk_queue.clear()
        key = self.policy.key

        def job_key(job):
            req = getattr(job, "req", None)
            return (0,) if req is None else (1,) + tuple(key(req))

        wave.sort(key=job_key)
        return wave

    @property
    def has_prefill_work(self) -> bool:
        return bool(self.chunk_queue)

    def plan_decode_block(self, max_block: int,
                          reclaim_queued: bool = False) -> int:
        """Adaptive decode-block size K (tokens generated per host sync).

        K collapses to 1 while requests are waiting on free slots — or while
        prefill chunks are queued — so a retire is noticed (and the slot
        re-admitted) at the next token boundary, and a chunked prompt gets a
        prefill chunk between every pair of decode tokens: admission / TTFT
        latency never grows with blocking.  ``reclaim_queued`` collapses K
        the same way while an abort or a preemption reclaim is waiting to
        be applied (the EngineClient installs this hint — see
        ``InferenceEngine.reclaim_hint``): a cancelled slot is then freed
        within ~1 decode step instead of riding out a full block.
        Otherwise K is bounded by the smallest remaining token budget
        across active slots (finished slots would just burn masked decode
        steps) and by ``max_block``, rounded down to a power of two so the
        engine compiles at most log2(max_block)+1 block variants."""
        if max_block <= 1 or self.pending or self.chunk_queue \
                or reclaim_queued or not self.active:
            return 1
        rem = min(r.sampling.max_tokens - r.num_generated
                  for r in self.active.values())
        k = max(1, min(max_block, rem))
        return 1 << (k.bit_length() - 1)

    def plan_spec_k(self, max_k: int, acceptance: float,
                    reclaim_queued: bool = False) -> int:
        """Acceptance-rate-aware draft length for a speculative round.

        Returns 0 (speculation off this round) under exactly the pressure
        conditions that collapse the decode block to K=1 — waiting
        admissions, queued prefill chunks, a pending abort/reclaim — plus
        when the acceptance signal is below the probation low-water mark
        (0.15, enforced by ``SpecController.tick`` returning 0.0): a
        draft-verify round costs a wider forward than a single decode step,
        so it must never delay admission latency or burn bandwidth on
        streams that reject everything.  Between the low-water mark and 0.5
        the draft length halves — mediocre acceptance still profits from
        short drafts, long ones mostly roll back."""
        if max_k <= 0 or self.pending or self.chunk_queue \
                or reclaim_queued or not self.active:
            return 0
        if acceptance < 0.15:
            return 0
        if acceptance < 0.5:
            return max(1, max_k // 2)
        return max_k

    # ------------------------------------------------------------------ #
    # observability
    # ------------------------------------------------------------------ #
    def record_latency(self, req: Request) -> None:
        """Fold a finished request into the per-class latency window
        (called at retire; preempted-then-resumed requests record once,
        with their original arrival time)."""
        if req.finish_time is None:
            return
        cls = req.latency_class
        ttft = req.ttft if req.ttft is not None else 0.0
        e2e = req.finish_time - req.arrival_time
        with self._lat_lock:
            dq = self._lat.setdefault(cls, deque(maxlen=_LAT_WINDOW))
            dq.append((ttft, e2e))
            self._lat_count[cls] = self._lat_count.get(cls, 0) + 1
            if req.missed_deadline:
                self._lat_miss[cls] = self._lat_miss.get(cls, 0) + 1

    def latency_by_class(self) -> Dict[str, Dict[str, float]]:
        """Per-class TTFT/e2e percentiles over the rolling window, plus
        lifetime counts and deadline misses."""
        with self._lat_lock:
            snap = {cls: list(dq) for cls, dq in self._lat.items()}
            counts = dict(self._lat_count)
            misses = dict(self._lat_miss)
        out: Dict[str, Dict[str, float]] = {}
        for cls, rows in snap.items():
            ttfts = [t * 1e3 for t, _ in rows]
            e2es = [e * 1e3 for _, e in rows]
            out[cls] = {
                "count": counts.get(cls, 0),
                "window": len(rows),
                "ttft_p50_ms": _percentile(ttfts, 50),
                "ttft_p95_ms": _percentile(ttfts, 95),
                "e2e_p50_ms": _percentile(e2es, 50),
                "e2e_p95_ms": _percentile(e2es, 95),
                "deadline_missed": misses.get(cls, 0),
            }
        return out

    @property
    def queue_depth(self) -> int:
        """Requests waiting for admission (starvation surface)."""
        return len(self.pending)

    @property
    def oldest_wait_s(self) -> float:
        """Age of the oldest pending request (0.0 with an empty queue).
        Read from HTTP handler threads while the engine loop mutates the
        queue, so it works on a snapshot and tolerates a concurrent
        drain."""
        arrivals = [r.arrival_time for r in list(self.pending)]
        if not arrivals:
            return 0.0
        return max(0.0, time.monotonic() - min(arrivals))

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time stats dict for the server's ``/stats`` endpoint."""
        s = self.stats
        return {
            "policy": self.policy.name,
            "queue_depth": self.queue_depth,
            "oldest_wait_s": self.oldest_wait_s,
            "active": len(self.active),
            "prefill_chunks_queued": len(self.chunk_queue),
            "admitted": s.admitted,
            "retired": s.retired,
            "steps": s.steps,
            "device_steps": s.device_steps,
            "tokens_generated": s.tokens_generated,
            "peak_batch": s.peak_batch,
            "prefill_waves": s.prefill_waves,
            "prefill_chunks": s.prefill_chunks,
            "rows_per_wave": s.rows_per_wave,
            "host_syncs_per_token": s.host_syncs_per_token,
            "spec_jobs": s.spec_jobs,
            "spec_chunks": s.spec_chunks,
            "spec_admitted": s.spec_admitted,
            "preemptions": s.preemptions,
            "resumed": s.resumed,
            "aborted": s.aborted,
            "failed": s.failed,
            "aging_s": self.policy.aging_s,
            "latency_by_class": self.latency_by_class(),
        }

    # ------------------------------------------------------------------ #
    @property
    def has_work(self) -> bool:
        return bool(self.pending or self.active or self.chunk_queue)

    @property
    def num_active(self) -> int:
        return len(self.active)

    def active_slots(self) -> List[int]:
        return sorted(self.active.keys())
