"""Admission control and graceful degradation: the layer between the
serving front end and the engine's scheduler (a copy of the reference
package's ``core/admission.py``).

The engine (core/engine.py) assumes a well-behaved pending queue: nothing
bounds it, nothing distinguishes tenants, and nothing ever expires.  Under
production overload that is the whole failure mode — one bulk client
floods the queue, interactive users starve behind it, and every request
"succeeds" minutes too late.  This module owns the missing policy:

* **Per-tenant token buckets** — requests/s and prompt-tokens/s, burst-
  capped.  A tenant over its rate gets a structured 429 with
  ``Retry-After`` computed from the bucket, not a queue slot.
* **Weighted fair queueing** — each tenant has its own FIFO; release
  order is start-time fair queueing over tenant virtual time (cost =
  prompt tokens / weight), so a tenant submitting 10x the traffic still
  gets ~its weight share of admissions, and an idle tenant's first
  request never waits behind a bulk backlog.
* **Bounded queue + queue-wait timeouts** — the queue has a hard depth
  bound (global and per-tenant); a request that waits longer than
  ``queue_timeout_s`` is *expired* with a typed ``timeout`` finish event
  instead of hanging forever.
* **Load shedding / degradation ladder** — NORMAL → SHED_BULK (batch-
  class requests get 503, interactive still admitted) → SHED_ALL (every
  new request 503) → DRAINING (terminal; ``/readyz`` flips, in-flight
  work finishes).  Level is derived from queue depth, estimated queue
  wait (EWMA of observed release rate), and KV-pool headroom.

The controller is intentionally engine-agnostic: it holds plain
:class:`~repro_torch.core.request.Request` objects and releases them in fair
order when the engine has capacity (``EngineClient`` drives ``poll`` from
the engine loop thread).  All public methods are thread-safe — ``submit``
is called from HTTP handler threads while ``poll`` runs on the loop.

See DESIGN_overload_and_faults.md for thresholds and the full ladder.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.request import Request

# degradation-ladder levels (snapshot()/``/stats`` expose the name)
LEVEL_NORMAL = 0
LEVEL_SHED_BULK = 1
LEVEL_SHED_ALL = 2
LEVEL_DRAINING = 3
LEVEL_NAMES = {
    LEVEL_NORMAL: "normal",
    LEVEL_SHED_BULK: "shed_bulk",
    LEVEL_SHED_ALL: "shed_all",
    LEVEL_DRAINING: "draining",
}


class AdmissionError(Exception):
    """A request rejected at admission: carries the HTTP status, a machine
    code, and a ``Retry-After`` hint in seconds (the serving codec maps it
    to the structured OpenAI error envelope + header)."""

    def __init__(self, message: str, *, status: int, code: str,
                 retry_after: float):
        super().__init__(message)
        self.status = status
        self.code = code
        self.retry_after = max(0.0, retry_after)


class RateLimited(AdmissionError):
    """Tenant over its requests/s or prompt-tokens/s budget (HTTP 429)."""

    def __init__(self, message: str, retry_after: float):
        super().__init__(message, status=429, code="rate_limited",
                         retry_after=retry_after)


class Overloaded(AdmissionError):
    """Queue bound / degradation ladder / drain rejection (HTTP 503)."""

    def __init__(self, message: str, retry_after: float,
                 code: str = "overloaded"):
        super().__init__(message, status=503, code=code,
                         retry_after=retry_after)


class TokenBucket:
    """Classic token bucket: ``rate`` units/s refill up to ``burst``.
    ``rate <= 0`` disables the bucket (always admits).  Not thread-safe on
    its own — the controller's lock covers it."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)
        self._t = None  # lazily bound to the first observed clock value

    def _refill(self, now: float) -> None:
        if self._t is None:
            self._t = now
        self.level = min(self.burst, self.level + (now - self._t) * self.rate)
        self._t = now

    def try_take(self, cost: float, now: float) -> bool:
        if self.rate <= 0:
            return True
        self._refill(now)
        if self.level >= cost:
            self.level -= cost
            return True
        return False

    def time_until(self, cost: float, now: float) -> float:
        """Seconds until ``cost`` units will be available (0 if now)."""
        if self.rate <= 0:
            return 0.0
        self._refill(now)
        deficit = min(cost, self.burst) - self.level
        return max(0.0, deficit / self.rate)


@dataclass
class TenantConfig:
    """Per-tenant admission knobs.  ``rps``/``tps`` <= 0 disable that
    bucket.  ``weight`` scales the tenant's fair share (2.0 = twice the
    admissions of a weight-1 tenant under contention).  ``max_queue``
    bounds this tenant's waiting requests (None = global default)."""

    weight: float = 1.0
    rps: float = 0.0                  # requests/s (0 = unlimited)
    tps: float = 0.0                  # prompt tokens/s (0 = unlimited)
    burst_requests: float = 8.0
    burst_tokens: float = 8192.0
    max_queue: Optional[int] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0, got {self.weight}")


@dataclass
class _Tenant:
    name: str
    cfg: TenantConfig
    rps_bucket: TokenBucket
    tps_bucket: TokenBucket
    queue: Deque[Tuple[Request, float]] = field(default_factory=deque)
    vtime: float = 0.0                # fair-queueing virtual finish time
    submitted: int = 0
    released: int = 0
    shed_rate: int = 0                # 429s
    shed_load: int = 0                # 503s (ladder / bounds / drain)
    timeouts: int = 0                 # queue-wait expirations
    released_tokens: int = 0          # prompt tokens released (service)


class AdmissionController:
    """Fair, bounded, sheddable admission queue in front of the engine."""

    def __init__(
        self,
        *,
        default_tenant: Optional[TenantConfig] = None,
        tenants: Optional[Dict[str, TenantConfig]] = None,
        max_queue_depth: int = 256,
        queue_timeout_s: float = 30.0,
        shed_queue_depth: Optional[int] = None,
        shed_wait_s: float = 10.0,
        headroom_fn: Optional[Callable[[], float]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1")
        self.default_cfg = default_tenant or TenantConfig()
        self.tenant_cfgs = dict(tenants or {})
        self.max_queue_depth = max_queue_depth
        self.queue_timeout_s = queue_timeout_s
        # soft threshold where batch-class work starts shedding; the hard
        # bound (max_queue_depth) always sheds everything
        self.shed_queue_depth = (max(1, max_queue_depth // 2)
                                 if shed_queue_depth is None
                                 else shed_queue_depth)
        self.shed_wait_s = shed_wait_s
        # optional engine-side signal: fraction of serving capacity free
        # (decode slots + engine-side queue headroom); 0.0 = saturated.
        # Only ever *escalates* the ladder — a missing probe never sheds.
        self.headroom_fn = headroom_fn
        self._clock = clock
        self._lock = threading.Lock()
        self._tenants: Dict[str, _Tenant] = {}
        self._draining = False
        self._depth = 0
        # observed release throughput (EWMA of releases/s) feeding the
        # estimated-wait shed signal; seeded pessimistically low so a cold
        # controller does not shed on its first burst (est_wait uses it
        # only once releases have actually happened)
        self._release_rate = 0.0
        self._last_release: Optional[float] = None
        self.total_timeouts = 0
        self.total_shed_rate = 0
        self.total_shed_load = 0
        self.total_released = 0

    # ------------------------------------------------------------------ #
    def _tenant(self, name: str) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            cfg = self.tenant_cfgs.get(name, self.default_cfg)
            t = _Tenant(
                name, cfg,
                rps_bucket=TokenBucket(cfg.rps, cfg.burst_requests),
                tps_bucket=TokenBucket(cfg.tps, cfg.burst_tokens))
            # a tenant joining (or re-activating) starts at the current
            # minimum virtual time: it gets its fair share from now on but
            # no credit for the time it was idle (classic SFQ join rule)
            t.vtime = self._min_vtime()
            self._tenants[name] = t
        return t

    def _min_vtime(self) -> float:
        backlogged = [t.vtime for t in self._tenants.values() if t.queue]
        return min(backlogged) if backlogged else max(
            (t.vtime for t in self._tenants.values()), default=0.0)

    # ------------------------------------------------------------------ #
    # degradation ladder
    # ------------------------------------------------------------------ #
    def _est_wait_s(self) -> float:
        """Estimated queue wait for a new arrival: depth over the observed
        release rate (inf while saturated with no releases ever seen —
        that case is governed by the depth thresholds instead)."""
        if self._depth == 0:
            return 0.0
        if self._release_rate <= 1e-9:
            return math.inf if self._last_release is not None else 0.0
        return self._depth / self._release_rate

    def _level_locked(self) -> int:
        if self._draining:
            return LEVEL_DRAINING
        if self._depth >= self.max_queue_depth:
            return LEVEL_SHED_ALL
        est = self._est_wait_s()
        soft = (self._depth >= self.shed_queue_depth
                or (self.shed_wait_s > 0 and est > self.shed_wait_s))
        if soft and self.shed_wait_s > 0 and est > 2 * self.shed_wait_s:
            return LEVEL_SHED_ALL
        if soft:
            # a saturated engine (no KV headroom) escalates soft shedding
            # to everything: queued work cannot start anyway
            if self.headroom_fn is not None:
                try:
                    if self.headroom_fn() <= 0.0:
                        return LEVEL_SHED_ALL
                except Exception:  # noqa: BLE001 — probe must never shed
                    pass
            return LEVEL_SHED_BULK
        return LEVEL_NORMAL

    @property
    def level(self) -> int:
        with self._lock:
            return self._level_locked()

    @property
    def draining(self) -> bool:
        with self._lock:
            return self._draining

    def start_drain(self) -> None:
        """Terminal: stop admitting (every submit 503s with code
        ``draining``); queued requests still release and in-flight work
        finishes.  Idempotent."""
        with self._lock:
            self._draining = True

    # ------------------------------------------------------------------ #
    # submit (HTTP handler threads)
    # ------------------------------------------------------------------ #
    def submit(self, req: Request) -> None:
        """Admit ``req`` into its tenant's queue or raise a typed
        :class:`AdmissionError` (429/503 + Retry-After).  Shedding is
        decided *before* buckets are charged, so a shed request does not
        burn the tenant's budget."""
        now = self._clock()
        tenant_name = req.tenant
        cost = max(1, len(req.prompt_tokens))
        with self._lock:
            t = self._tenant(tenant_name)
            t.submitted += 1
            level = self._level_locked()
            if level >= LEVEL_DRAINING:
                t.shed_load += 1
                self.total_shed_load += 1
                raise Overloaded("server is draining; retry against another "
                                 "replica", retry_after=1.0, code="draining")
            if level >= LEVEL_SHED_ALL:
                t.shed_load += 1
                self.total_shed_load += 1
                raise Overloaded(
                    "server overloaded: admission queue is full",
                    retry_after=self._retry_after_locked())
            if level >= LEVEL_SHED_BULK and req.latency_class == "batch":
                t.shed_load += 1
                self.total_shed_load += 1
                raise Overloaded(
                    "server under load: batch-class requests are being "
                    "shed (interactive traffic is still admitted)",
                    retry_after=self._retry_after_locked())
            per_tenant_cap = (t.cfg.max_queue if t.cfg.max_queue is not None
                              else self.max_queue_depth)
            if len(t.queue) >= per_tenant_cap:
                t.shed_load += 1
                self.total_shed_load += 1
                raise Overloaded(
                    f"tenant {tenant_name!r} queue is full "
                    f"({per_tenant_cap} waiting)",
                    retry_after=self._retry_after_locked())
            # rate limits: require BOTH buckets; check before charging so a
            # request rejected on tokens/s does not consume a request slot
            rps_wait = t.rps_bucket.time_until(1.0, now)
            tps_wait = t.tps_bucket.time_until(float(cost), now)
            if rps_wait > 0 or tps_wait > 0:
                t.shed_rate += 1
                self.total_shed_rate += 1
                limit = "requests/s" if rps_wait >= tps_wait else "prompt tokens/s"
                raise RateLimited(
                    f"tenant {tenant_name!r} over its {limit} limit",
                    retry_after=max(rps_wait, tps_wait))
            t.rps_bucket.try_take(1.0, now)
            t.tps_bucket.try_take(float(cost), now)
            t.queue.append((req, now))
            self._depth += 1

    def _retry_after_locked(self) -> float:
        est = self._est_wait_s()
        if not math.isfinite(est) or est <= 0:
            return max(1.0, self.queue_timeout_s / 4)
        return min(max(1.0, est / 2), self.queue_timeout_s)

    # ------------------------------------------------------------------ #
    # poll (engine loop thread)
    # ------------------------------------------------------------------ #
    def poll(self, capacity: int) -> Tuple[List[Request], List[Request]]:
        """One admission round: expire requests whose queue wait exceeded
        ``queue_timeout_s`` (returned second — the caller finishes them
        with a typed ``timeout`` event), then release up to ``capacity``
        requests in weighted-fair order (smallest tenant virtual time
        first; a released request advances its tenant's virtual time by
        ``prompt_tokens / weight``)."""
        now = self._clock()
        ready: List[Request] = []
        expired: List[Request] = []
        with self._lock:
            if self.queue_timeout_s > 0:
                for t in self._tenants.values():
                    kept: Deque[Tuple[Request, float]] = deque()
                    for req, t_in in t.queue:
                        if now - t_in > self.queue_timeout_s:
                            expired.append(req)
                            t.timeouts += 1
                            self.total_timeouts += 1
                            self._depth -= 1
                        else:
                            kept.append((req, t_in))
                    t.queue = kept
            for _ in range(max(0, capacity)):
                backlogged = [t for t in self._tenants.values() if t.queue]
                if not backlogged:
                    break
                t = min(backlogged, key=lambda t: (t.vtime, t.name))
                req, _t_in = t.queue.popleft()
                cost = max(1, len(req.prompt_tokens))
                t.vtime += cost / t.cfg.weight
                t.released += 1
                t.released_tokens += cost
                self.total_released += 1
                self._depth -= 1
                self._note_release_locked(now)
                ready.append(req)
        return ready, expired

    def _note_release_locked(self, now: float) -> None:
        if self._last_release is not None:
            gap = max(1e-6, now - self._last_release)
            inst = 1.0 / gap
            alpha = 0.1
            self._release_rate = ((1 - alpha) * self._release_rate
                                  + alpha * inst)
        self._last_release = now

    def drop(self, request_id: int) -> Optional[Request]:
        """Remove a queued request (client-side abort before release)."""
        with self._lock:
            for t in self._tenants.values():
                for pair in t.queue:
                    if pair[0].request_id == request_id:
                        t.queue.remove(pair)
                        self._depth -= 1
                        return pair[0]
        return None

    # ------------------------------------------------------------------ #
    # observability
    # ------------------------------------------------------------------ #
    @property
    def queue_depth(self) -> int:
        with self._lock:
            return self._depth

    def snapshot(self) -> Dict[str, Any]:
        """Point-in-time view for ``GET /stats`` (same lock-guarded
        snapshot discipline as ``Scheduler.snapshot``)."""
        with self._lock:
            level = self._level_locked()
            est = self._est_wait_s()
            tenants = {
                t.name: {
                    "queued": len(t.queue),
                    "weight": t.cfg.weight,
                    "submitted": t.submitted,
                    "released": t.released,
                    "released_tokens": t.released_tokens,
                    "shed_rate_limited": t.shed_rate,
                    "shed_overload": t.shed_load,
                    "timeouts": t.timeouts,
                }
                for t in self._tenants.values()
            }
            return {
                "level": level,
                "level_name": LEVEL_NAMES[level],
                "draining": self._draining,
                "queue_depth": self._depth,
                "max_queue_depth": self.max_queue_depth,
                "shed_queue_depth": self.shed_queue_depth,
                "queue_timeout_s": self.queue_timeout_s,
                "est_wait_s": (est if math.isfinite(est) else None),
                "released": self.total_released,
                "shed_rate_limited": self.total_shed_rate,
                "shed_overload": self.total_shed_load,
                "timeouts": self.total_timeouts,
                "tenants": tenants,
            }


def jain_index(values: List[float]) -> float:
    """Jain's fairness index over per-tenant service shares: 1.0 =
    perfectly fair, 1/n = one tenant takes everything.  Used by the
    load-trace benchmark's fairness gate."""
    vals = [v for v in values if v >= 0]
    if not vals or all(v == 0 for v in vals):
        return 1.0
    s = sum(vals)
    return (s * s) / (len(vals) * sum(v * v for v in vals))
