"""Multi-replica router of the port: prefix-cache-aware placement over N
in-process engine replicas (the reference package's ``serving/router.py``,
host code copied with its imports pointed at the port; its design is
``DESIGN_router.md``).

The :class:`Router` duck-types the slice of :class:`EngineClient` the
OpenAI codec uses (``submit`` / ``stats`` / health / drain), so
``OpenAIServer(Router([...]))`` serves N engines behind one API surface
with no codec changes.  Placement for each submit walks a fixed ladder:

1. **Session affinity** — a request carrying ``session`` (body field or
   ``x-session`` header) goes to the replica its session is pinned to, so
   multi-turn chat keeps hitting the replica whose prefix cache holds the
   conversation so far.
2. **Prefix affinity** — otherwise the router scores each replica against
   a router-side *digest index*: a bounded per-replica set of block hash
   chains over the prompts it has served (the same ``h_i = H(h_{i-1} ||
   block_i)`` idiom as the engine's prefix cache, but replica-keyed and
   content-only — the router never sees KV).  The replica with the
   longest matching prefix wins when it matches at least one block.
3. **Load fallback** — least outstanding tokens (admitted budget minus
   generated) among eligible replicas.

Eligibility is degradation-ladder aware: a replica at ``SHED_BULK`` stops
receiving batch-class traffic while alternatives exist (its own admission
controller would shed it anyway — routing around it keeps the 503s down),
and draining/stopped replicas receive nothing.  When *every* replica is
draining the router raises :class:`Overloaded` with ``code="draining"``,
which the codec maps to the structured 503 + ``Retry-After`` envelope —
a post-drain SSE open gets a typed error, never a connection reset.

Rolling restarts use :meth:`Router.drain_replica`: the victim's open
requests export as handoff records (live slots as exact cache snapshots —
see ``EngineClient.handoff_export``) and a successor replica adopts them,
resuming every stream bit-identically; the victim's session pins move to
the successor.
"""
from __future__ import annotations

import random
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from hashlib import sha256
from typing import Any, Dict, List, Optional, Sequence, Union

from repro_torch.core.admission import LEVEL_SHED_BULK, Overloaded, RateLimited
from repro_torch.core.request import GenerationRequest
from repro_torch.serving.client import EngineClient, RequestHandle

_SCHEME = b"router-digest-v1:"

#: prompt-chunk sizes for the digest chain: prompts are hashed as raw
#: content (characters for string prompts, ids for pre-tokenised ones), so
#: the index needs no tokenizer round-trip on the routing hot path
_CHAR_BLOCK = 64
_TOKEN_BLOCK = 16

ROUTER_POLICIES = ("affinity", "least_loaded", "round_robin", "random")


def _digest_chain(prompt: Union[str, Sequence[int]],
                  max_blocks: int = 64) -> List[bytes]:
    """Block hash chain over prompt *content*.  Chains (not independent
    block hashes) make a match at block i imply blocks 0..i match too, so
    the affinity score is simply the longest shared chain prefix."""
    if isinstance(prompt, str):
        units: Sequence[Any] = prompt
        bs = _CHAR_BLOCK
        enc = lambda block: block.encode("utf-8", "surrogatepass")  # noqa: E731
    else:
        units = list(prompt)
        bs = _TOKEN_BLOCK
        enc = lambda block: b",".join(str(t).encode() for t in block)  # noqa: E731
    prev = sha256(_SCHEME).digest()
    chain: List[bytes] = []
    for i in range(0, len(units) - len(units) % bs, bs):
        prev = sha256(prev + enc(units[i:i + bs])).digest()
        chain.append(prev)
        if len(chain) >= max_blocks:
            break
    return chain


class _DigestIndex:
    """Bounded per-replica LRU set of prompt-chain digests."""

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self._seen: "OrderedDict[bytes, None]" = OrderedDict()

    def add(self, chain: Sequence[bytes]) -> None:
        for d in chain:
            self._seen[d] = None
            self._seen.move_to_end(d)
        while len(self._seen) > self.max_entries:
            self._seen.popitem(last=False)

    def score(self, chain: Sequence[bytes]) -> int:
        """Longest matching chain prefix, in blocks."""
        n = 0
        for d in chain:
            if d not in self._seen:
                break
            self._seen.move_to_end(d)
            n += 1
        return n

    def __len__(self) -> int:
        return len(self._seen)


@dataclass
class ReplicaStats:
    """Typed per-replica view for the ``GET /stats`` v2 envelope."""

    name: str
    state: str                       # "up" | "draining" | "stopped"
    alive: bool
    ready: bool
    draining: bool
    level: Optional[str]             # admission ladder level name, if any
    queue_depth: int
    outstanding_tokens: int
    open_requests: int
    submitted: int                   # requests routed here, lifetime
    digest_blocks: int               # router-side prefix index footprint
    raw: Dict[str, Any] = field(default_factory=dict, repr=False)

    def to_dict(self) -> Dict[str, Any]:
        out = dict(self.raw)
        out.update(
            name=self.name, state=self.state, alive=self.alive,
            ready=self.ready, draining=self.draining, level=self.level,
            queue_depth=self.queue_depth,
            outstanding_tokens=self.outstanding_tokens,
            open_requests=self.open_requests,
            submitted=self.submitted,
            digest_blocks=self.digest_blocks,
        )
        return out


@dataclass
class RouterStats:
    """Typed router-section view for the ``GET /stats`` v2 envelope."""

    policy: str
    replicas: int
    placements: Dict[str, int]       # reason -> count
    failovers: int
    handoffs: int
    handoff_requests: int            # requests migrated across replicas
    sessions_pinned: int
    rejected_draining: int

    def to_dict(self) -> Dict[str, Any]:
        return {
            "policy": self.policy,
            "replicas": self.replicas,
            "placements": dict(self.placements),
            "failovers": self.failovers,
            "handoffs": self.handoffs,
            "handoff_requests": self.handoff_requests,
            "sessions_pinned": self.sessions_pinned,
            "rejected_draining": self.rejected_draining,
        }


class _Replica:
    """One engine replica plus the router's bookkeeping about it."""

    def __init__(self, name: str, client: EngineClient):
        self.name = name
        self.client = client
        self.state = "up"
        self.index = _DigestIndex()
        self.submitted = 0            # requests routed here, lifetime
        # open handles with their admitted token budget; pruned lazily
        self.open: List[tuple] = []   # (RequestHandle, budget_tokens)

    def outstanding_tokens(self) -> int:
        self.open = [(h, b) for h, b in self.open if not h.finished]
        done = 0
        for h, _budget in self.open:
            done += sum(r.num_generated for r in h._requests)
        return sum(b for _h, b in self.open) - done

    @property
    def eligible(self) -> bool:
        c = self.client
        return (self.state == "up" and c.alive and not c.draining)

    def sheds_batch(self) -> bool:
        adm = self.client._admission
        return adm is not None and adm.level >= LEVEL_SHED_BULK


class Router:
    """Prefix-cache-aware request router over in-process engine replicas.

    Duck-types the :class:`EngineClient` surface the OpenAI codec needs,
    so it drops into ``OpenAIServer`` / the HTTP transports unchanged."""

    def __init__(self, replicas: Sequence[EngineClient],
                 policy: str = "affinity", seed: int = 0,
                 max_sessions: int = 8192):
        if not replicas:
            raise ValueError("Router needs at least one replica")
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; "
                             f"choose from {ROUTER_POLICIES}")
        self.policy = policy
        self.replicas: List[_Replica] = [
            _Replica(f"replica-{i}", c) for i, c in enumerate(replicas)
        ]
        self._lock = threading.Lock()
        self._rng = random.Random(seed)
        self._rr = 0
        self._sessions: "OrderedDict[str, int]" = OrderedDict()
        self._max_sessions = max_sessions
        self._placements: Dict[str, int] = {
            "session": 0, "prefix": 0, "least_loaded": 0,
            "round_robin": 0, "random": 0,
        }
        self._failovers = 0
        self._handoffs = 0
        self._handoff_requests = 0
        self._rejected_draining = 0

    # ------------------------------------------------------------------ #
    # placement
    # ------------------------------------------------------------------ #
    def _eligible(self, batch_class: bool) -> List[int]:
        up = [i for i, r in enumerate(self.replicas) if r.eligible]
        if batch_class:
            # degradation-ladder awareness: a SHED_BULK replica stops
            # taking batch traffic while alternatives exist (its own
            # admission would shed it — route around the 503)
            accepting = [i for i in up if not self.replicas[i].sheds_batch()]
            if accepting:
                return accepting
        return up

    def _least_loaded(self, candidates: List[int]) -> int:
        return min(candidates,
                   key=lambda i: (self.replicas[i].outstanding_tokens(), i))

    def _place_locked(self, greq: GenerationRequest, chain: List[bytes],
                      exclude: Sequence[int] = ()) -> tuple:
        """Pick a replica index for one request; returns (index, reason).
        ``exclude`` holds replicas that already refused this request
        (failover must not retry them)."""
        batch_class = greq.priority == 0 and greq.deadline_ms is None
        candidates = [i for i in self._eligible(batch_class)
                      if i not in exclude]
        if not candidates:
            self._rejected_draining += 1
            raise Overloaded(
                "all replicas are draining; retry shortly",
                retry_after=1.0, code="draining")
        if self.policy == "round_robin":
            self._rr += 1
            return candidates[self._rr % len(candidates)], "round_robin"
        if self.policy == "random":
            return self._rng.choice(candidates), "random"
        if self.policy == "affinity":
            if greq.session is not None:
                pinned = self._sessions.get(greq.session)
                if pinned is not None and pinned in candidates:
                    self._sessions.move_to_end(greq.session)
                    return pinned, "session"
            if chain:
                scored = [(self.replicas[i].index.score(chain), i)
                          for i in candidates]
                best_score, best = max(scored, key=lambda s: (s[0], -s[1]))
                if best_score > 0:
                    return best, "prefix"
        return self._least_loaded(candidates), "least_loaded"

    # ------------------------------------------------------------------ #
    # the client surface the codec uses
    # ------------------------------------------------------------------ #
    def submit(self, greq: GenerationRequest) -> RequestHandle:
        chain = _digest_chain(greq.prompt)
        tried: List[int] = []
        while True:
            with self._lock:
                idx, reason = self._place_locked(greq, chain, exclude=tried)
            rep = self.replicas[idx]
            try:
                handle = rep.client.submit(greq)
            except RateLimited:
                # tenant budget rejection is a policy decision, not a
                # replica fault — retrying elsewhere would double-spend
                # the tenant's budget
                raise
            except (Overloaded, RuntimeError) as e:
                # replica-local refusal (drain raced us, queue full, loop
                # stopped): fail over to the next-best replica
                tried.append(idx)
                with self._lock:
                    self._failovers += 1
                    if isinstance(e, RuntimeError) or rep.client.draining:
                        if rep.state == "up":
                            rep.state = ("draining" if rep.client.draining
                                         and rep.client.alive else "stopped")
                continue
            with self._lock:
                self._placements[reason] += 1
                rep.submitted += 1
                rep.index.add(chain)
                rep.open.append((handle, self._budget(greq, handle)))
                if greq.session is not None:
                    self._sessions[greq.session] = idx
                    self._sessions.move_to_end(greq.session)
                    while len(self._sessions) > self._max_sessions:
                        self._sessions.popitem(last=False)
            return handle

    @staticmethod
    def _budget(greq: GenerationRequest, handle: RequestHandle) -> int:
        return handle.prompt_tokens + greq.sampling.max_tokens * greq.n

    # ------------------------------------------------------------------ #
    # rolling restart: drain one replica into a successor
    # ------------------------------------------------------------------ #
    def drain_replica(self, index: int, successor: Optional[int] = None,
                      timeout: float = 30.0) -> Dict[str, Any]:
        """Drain ``replicas[index]`` by handing its open requests to a
        successor replica: live decode slots move as exact cache
        snapshots and resume bit-identically; queued work re-prefills.
        Migrated handles keep streaming without a gap; the victim's
        session pins move to the successor.  The victim's client is
        stopped afterwards (its digest index is dropped — the successor
        earns its own prefix hits as it serves)."""
        if not 0 <= index < len(self.replicas):
            raise ValueError(f"no replica {index}")
        victim = self.replicas[index]
        with self._lock:
            if victim.state != "up":
                raise ValueError(f"{victim.name} is {victim.state}")
            victim.state = "draining"
            live = [i for i, r in enumerate(self.replicas)
                    if i != index and r.eligible]
            if successor is None:
                if not live:
                    victim.state = "up"
                    raise RuntimeError("no successor replica available")
                successor = self._least_loaded(live)
            elif successor == index or successor not in live:
                victim.state = "up"
                raise ValueError(f"successor {successor} not eligible")
        records = victim.client.handoff_export(timeout=timeout)
        succ = self.replicas[successor]
        adopted = succ.client.handoff_import(records)
        with self._lock:
            victim.state = "stopped"
            self._handoffs += 1
            self._handoff_requests += adopted
            # migrated handles now count against the successor's load
            moved = [(h, b) for h, b in victim.open if not h.finished]
            victim.open = []
            succ.open.extend(moved)
            for sess, pin in list(self._sessions.items()):
                if pin == index:
                    self._sessions[sess] = successor
        return {"drained": victim.name, "successor": succ.name,
                "exported": len(records), "adopted": adopted}

    # ------------------------------------------------------------------ #
    # stats / health / lifecycle (duck-typing EngineClient)
    # ------------------------------------------------------------------ #
    def replica_stats(self) -> List[ReplicaStats]:
        out = []
        for rep in self.replicas:
            c = rep.client
            alive = c.alive
            raw = c.stats() if alive else {}
            adm = c._admission
            snap = adm.snapshot() if adm is not None else None
            out.append(ReplicaStats(
                name=rep.name, state=rep.state, alive=alive,
                ready=c.ready, draining=c.draining,
                level=(snap["level_name"] if snap else None),
                queue_depth=(snap["queue_depth"] if snap
                             else raw.get("pending", 0)),
                outstanding_tokens=rep.outstanding_tokens(),
                open_requests=len(rep.open),
                submitted=rep.submitted,
                digest_blocks=len(rep.index),
                raw=raw,
            ))
        return out

    def router_stats(self) -> RouterStats:
        with self._lock:
            return RouterStats(
                policy=self.policy,
                replicas=len(self.replicas),
                placements=dict(self._placements),
                failovers=self._failovers,
                handoffs=self._handoffs,
                handoff_requests=self._handoff_requests,
                sessions_pinned=len(self._sessions),
                rejected_draining=self._rejected_draining,
            )

    def stats_v2(self) -> Dict[str, Any]:
        """The namespaced ``GET /stats`` v2 sections."""
        return {
            "router": self.router_stats().to_dict(),
            "replicas": [r.to_dict() for r in self.replica_stats()],
        }

    def stats(self) -> Dict[str, Any]:
        """Legacy flat payload: numeric counters summed across replicas,
        everything else from the first live replica (kept one release —
        see ``OpenAIServer.stats``)."""
        snaps = [r.client.stats() for r in self.replicas if r.client.alive]
        if not snaps:
            return {"replicas": len(self.replicas)}
        return _merge_numeric(snaps)

    @property
    def engine(self):
        """Primary engine (tokenizer / fingerprint identity): replicas are
        homogeneous, so the first one speaks for all."""
        return self.replicas[0].client.engine

    @property
    def _admission(self):
        for rep in self.replicas:
            if rep.eligible and rep.client._admission is not None:
                return rep.client._admission
        return None

    @property
    def alive(self) -> bool:
        return any(r.client.alive for r in self.replicas)

    @property
    def ready(self) -> bool:
        return any(r.state == "up" and r.client.ready
                   for r in self.replicas)

    @property
    def draining(self) -> bool:
        return all(r.state != "up" or r.client.draining
                   for r in self.replicas)

    def drain(self, timeout: float = 30.0) -> bool:
        """Full-fleet drain (SIGTERM path): every replica drains in
        parallel; True when all finished their in-flight work in time."""
        threads, results = [], {}

        def _one(i: int, rep: _Replica) -> None:
            results[i] = rep.client.drain(timeout=timeout)

        for i, rep in enumerate(self.replicas):
            with self._lock:
                if rep.state == "up":
                    rep.state = "draining"
            t = threading.Thread(target=_one, args=(i, rep), daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=timeout + 15.0)
        with self._lock:
            for rep in self.replicas:
                rep.state = "stopped"
        return all(results.get(i, False) for i in range(len(self.replicas)))

    def stop(self) -> None:
        for rep in self.replicas:
            rep.client.stop()
            rep.state = "stopped"

    close = stop

    def __enter__(self) -> "Router":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def _merge_numeric(snaps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-replica stats dicts: ints/floats sum, nested dicts merge
    recursively, anything else (strings, lists, bools) comes from the
    first replica.  Good enough for the deprecated flat mirror — typed
    consumers read ``replicas[]`` instead."""
    out: Dict[str, Any] = {}
    for key in snaps[0]:
        vals = [s[key] for s in snaps if key in s]
        first = vals[0]
        if isinstance(first, bool):
            out[key] = first
        elif isinstance(first, (int, float)) and all(
                isinstance(v, (int, float)) and not isinstance(v, bool)
                for v in vals):
            out[key] = sum(vals)
        elif isinstance(first, dict) and all(isinstance(v, dict)
                                             for v in vals):
            out[key] = _merge_numeric(vals)
        else:
            out[key] = first
    return out
