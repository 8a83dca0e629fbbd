"""Deterministic fault injection for the serving engine (chaos harness): a
copy of the reference package's ``core/faults.py`` (pure Python).

The engine calls :meth:`FaultInjector.fires` at a fixed set of *injection
sites*; whether a given call fires is a pure function of ``(seed, site,
keys)``, so a chaos run replays bit-identically: the same requests fail at
the same points every time, which is what lets the chaos tests assert that
*survivors* are bit-identical to a fault-free run (tests/test_faults.py).

Sites (see DESIGN_overload_and_faults.md for the taxonomy):

* ``prefill``  — keyed by request_id: the request's prefill job blows up
  at open (media pipeline / prefix lookup).  Fails that request with a
  typed ``error`` finish; nothing else is touched.
* ``decode``   — keyed by (request_id, position): the slot's sampled token
  is treated as corrupt (the NaN-in-logits scenario).  Fails that request;
  the other slots of the same compiled block continue bit-identically.
* ``codec``    — keyed by (request_id, position): the detokenise/stream
  step for one token raises.  Fails that request.
* ``slow_step``— keyed by step counter: the engine step stalls for
  ``slow_step_s`` (drives the client watchdog).
* ``pool``     — keyed by (request_id, attempt): slot allocation for an
  admission transiently fails; the request stays pending and is retried
  next step (never dropped, never wedged).

``rate`` is the per-call firing probability.  An injector with no rates is
inert and costs one dict lookup per site call, so the hooks can stay in the
production code path unconditionally.
"""
from __future__ import annotations

import hashlib
import threading
from typing import Dict, Optional, Tuple

#: the injection sites the engine exposes, in one place so tests and the
#: CLI can validate ``--fault-rate site=p`` specs against it
SITES = ("prefill", "decode", "codec", "slow_step", "pool")


class InjectedFault(RuntimeError):
    """Raised at an injection site that fired (carries the site name)."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected {site} fault{': ' + detail if detail else ''}")
        self.site = site


class FaultInjector:
    """Seeded, replayable fault source.

    ``rates`` maps site name -> firing probability in [0, 1].  ``fires``
    hashes ``(seed, site, *keys)`` into a uniform [0, 1) draw — no global
    RNG state, so concurrent callers and re-runs see identical decisions.
    Per-site fired/checked counters are lock-guarded (the engine loop and
    ``/stats`` handler threads both read them).
    """

    def __init__(self, seed: int = 0, rates: Optional[Dict[str, float]] = None,
                 slow_step_s: float = 0.05):
        rates = dict(rates or {})
        for site, rate in rates.items():
            if site not in SITES:
                raise ValueError(f"unknown fault site {site!r} (have: {SITES})")
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"fault rate for {site!r} must be in [0, 1], got {rate}")
        self.seed = seed
        self.rates = rates
        self.slow_step_s = slow_step_s
        self._lock = threading.Lock()
        self._fired: Dict[str, int] = {s: 0 for s in SITES}
        self._checked: Dict[str, int] = {s: 0 for s in SITES}

    # ------------------------------------------------------------------ #
    def _draw(self, site: str, keys: Tuple) -> float:
        ident = ":".join([str(self.seed), site] + [str(k) for k in keys])
        digest = hashlib.sha256(ident.encode()).digest()
        return int.from_bytes(digest[:8], "big") / float(1 << 64)

    def fires(self, site: str, *keys) -> bool:
        """Whether the injection site fires for this call (deterministic in
        ``(seed, site, keys)``)."""
        rate = self.rates.get(site, 0.0)
        if rate <= 0.0:
            return False
        hit = self._draw(site, keys) < rate
        with self._lock:
            self._checked[site] += 1
            if hit:
                self._fired[site] += 1
        return hit

    def check(self, site: str, *keys, detail: str = "") -> None:
        """Raise :class:`InjectedFault` if the site fires."""
        if self.fires(site, *keys):
            raise InjectedFault(site, detail)

    # ------------------------------------------------------------------ #
    def snapshot(self) -> Dict[str, Dict[str, int]]:
        """Per-site fired/checked counters (``/stats`` payload)."""
        with self._lock:
            return {
                site: {"fired": self._fired[site], "checked": self._checked[site]}
                for site in SITES
                if self._checked[site] or self.rates.get(site)
            }

    @property
    def active(self) -> bool:
        return any(r > 0 for r in self.rates.values())


def parse_fault_rates(specs) -> Dict[str, float]:
    """Parse CLI ``site=rate`` specs (e.g. ``--fault-rate decode=0.05``)."""
    rates: Dict[str, float] = {}
    for spec in specs or ():
        if "=" not in spec:
            raise ValueError(f"fault spec {spec!r} must look like site=rate")
        site, _, val = spec.partition("=")
        rates[site.strip()] = float(val)
    return rates
