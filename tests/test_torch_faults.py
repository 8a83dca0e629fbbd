"""Faults, recovery, the watchdog, drain and handoff of the port on the CPU:
the scenarios of ``tests/test_faults.py`` and ``tests/test_router.py``,
held to the JAX package's engine on the same weights (``qwen2-0.5b``
reduced, float32) where the two can be stepped in lockstep.

* The copied :class:`FaultInjector` draws exactly the reference's.
* Chaos at the ``prefill``, ``decode``, ``codec`` and ``pool`` sites on the
  dense ring and on pages: both engines fail the same request ids (the
  draws are a pure hash), step by step with the same counters and page
  bookkeeping; each failed request has one typed ``error`` finish naming
  an injected fault; the survivors' tokens equal a fault-free run's; no
  page stays pinned.
* A decode block that raises: the live requests fail, the pending ones
  finish, the pool is rebuilt (prefix cache cleared on pages) and the same
  engine serves clean traffic after — the same ids as the JAX engine's.
* Through the client: a slow step flips readiness; a drain finishes
  in-flight work and answers new work with the 503 ``draining`` error; a
  drain cutoff publishes the live slots and leaves nothing pinned; a
  handoff from one client to another, dense, fp pages and int8 pages, is
  token-identical to an undrained run, its snapshots resume with no
  prefill and its int8 cells arrive bit for bit.
* Over HTTP on a launcher-built server: the new flags, ``POST
  /admin/drain``, ``/readyz`` and the ``draining`` envelope.
"""
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import faults as port_faults
from repro_torch.core.admission import AdmissionController, Overloaded
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.faults import FaultInjector
from repro_torch.core.request import (FinishReason, GenerationRequest, Request,
                                      SamplingParams)
from repro_torch.launch import serve
from repro_torch.serving.client import EngineClient
from repro_torch.serving.tokenizer import ByteTokenizer
from test_torch_fill_groups_echo import (LAYOUTS, Pair, jx,  # noqa: F401
                                         quiet, weights)
from torch_threads import one_torch_thread  # noqa: F401

TOK = ByteTokenizer()
# per-site rates that split the six requests into failed and survivors
RATES = {"prefill": 0.3, "decode": 0.08, "codec": 0.08, "pool": 0.3}
SITES = tuple(RATES)
INT8 = dict(LAYOUTS["paged"], kv_dtype="int8")


def _prompts(n):
    return [TOK.encode(f"chaos prompt {i} " + "pad " * (3 * i))
            for i in range(n)]


# --------------------------------------------------------------------------- #
# the injector
# --------------------------------------------------------------------------- #
def test_injector_matches_reference():
    """The copy draws, counts and validates exactly as the reference's."""
    from repro.core import faults as ref
    rates = {"prefill": 0.3, "decode": 0.5, "codec": 0.1, "pool": 0.2,
             "slow_step": 0.4}
    a, b = port_faults.FaultInjector(7, rates), ref.FaultInjector(7, rates)
    keys = [(site, rid, pos) for site in port_faults.SITES
            for rid in range(30) for pos in range(4)]
    assert [a.fires(*k) for k in keys] == [b.fires(*k) for k in keys]
    assert a.snapshot() == b.snapshot() and port_faults.SITES == ref.SITES
    assert port_faults.parse_fault_rates(["decode=0.05", "pool = 0.2"]) == \
        ref.parse_fault_rates(["decode=0.05", "pool = 0.2"])
    for bad in ({"nonsense": 0.5}, {"decode": 1.5}):
        with pytest.raises(ValueError):
            port_faults.FaultInjector(rates=bad)
    with pytest.raises(port_faults.InjectedFault, match="injected prefill"):
        port_faults.FaultInjector(rates={"prefill": 1.0}).check("prefill", 1)


# --------------------------------------------------------------------------- #
# chaos against the JAX engine
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def chaos_pairs(jx, weights):
    """One engine pair per layout, reused across the sites (prefix cache
    off, so each run starts clean), with its fault-free tokens."""
    pairs = {}
    for layout in LAYOUTS:
        p = Pair(jx, weights, max_batch=3, cache_len=128, prefill_chunk=32,
                 enable_prefix_cache=False, **LAYOUTS[layout])
        reqs = [p.req(9000 + i, t, 6) for i, t in enumerate(_prompts(6))]
        p.add(reqs)
        p.run()
        pairs[layout] = (p, [tr.output_tokens for _, tr in reqs])
    return pairs


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_chaos_fails_the_same_ids_as_jax(chaos_pairs, layout, site):
    p, baseline = chaos_pairs[layout]
    base = 10_000 + 1000 * SITES.index(site)
    p.je.faults = _ref_injector(site)
    p.te.faults = FaultInjector(seed=3, rates={site: RATES[site]})
    reqs = [p.req(base + i, t, 6) for i, t in enumerate(_prompts(6))]
    p.add(reqs)
    finishes = {}
    try:
        while p.te.scheduler.has_work or p.je.scheduler.has_work:
            p.je.step()
            for ev in p.te.step():
                if ev.finished:
                    finishes.setdefault(ev.request_id, []).append(ev)
            p.check()
    finally:
        p.je.faults = p.te.faults = None
    failed = {tr.request_id for _, tr in reqs
              if tr.finish_reason is FinishReason.ERROR}
    assert failed == {jr.request_id for jr, _ in reqs
                      if jr.finish_reason.value == "error"}
    if site == "pool":
        assert not failed
    else:
        assert failed and len(failed) < len(reqs)
    for i, (_, tr) in enumerate(reqs):
        assert len(finishes[tr.request_id]) == 1
        if tr.request_id in failed:
            assert "injected" in tr.error
        else:
            assert tr.output_tokens == baseline[i]
    if p.te._paged:
        assert p.te.pool.page_occupancy()["pinned"] == 0


def _ref_injector(site):
    from repro.core.faults import FaultInjector as RefInjector
    return RefInjector(seed=3, rates={site: RATES[site]})


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_decode_block_failure_recovers(jx, weights, layout):
    """A decode block that raises fails the live requests with typed
    errors, rebuilds the device buffers (on pages the prefix cache's
    leases died with the arena) and keeps serving: the pending requests
    finish, as in the JAX engine, and the same engine serves again."""
    p = Pair(jx, weights, max_batch=2, cache_len=128, **LAYOUTS[layout])
    reqs = [p.req(11_000 + i, t, 6) for i, t in enumerate(_prompts(4))]
    p.add(reqs)
    while not p.te._live_slots:
        p.step()
    real_j, real_t = p.je._decode_block_fn, p.te._decode_block

    def boom(real):
        def block(*a, **k):
            out = real(*a, **k)       # the block ran (and wrote) first
            raise RuntimeError("injected device failure")
        return block
    p.je._decode_block_fn, p.te._decode_block = boom(real_j), boom(real_t)
    p.step()
    p.je._decode_block_fn, p.te._decode_block = real_j, real_t
    p.run()
    for jr, tr in reqs:
        assert tr.finish_reason.value == jr.finish_reason.value
        assert tr.output_tokens == jr.output_tokens
    errored = [tr for _, tr in reqs if tr.finish_reason is FinishReason.ERROR]
    assert len(errored) == 2 and len(reqs) - len(errored) == 2
    assert all("decode block failed" in r.error for r in errored)
    again = [p.req(11_100 + i, t, 4) for i, t in enumerate(_prompts(2))]
    p.add(again)
    p.run()
    assert all(tr.output_tokens == jr.output_tokens and
               tr.finish_reason.value == "length" for jr, tr in again)


# --------------------------------------------------------------------------- #
# the client: watchdog, drain, handoff
# --------------------------------------------------------------------------- #
def _engine(weights, **kw):
    kw.setdefault("max_batch", 3)
    kw.setdefault("cache_len", 128)
    return InferenceEngine(weights[1], weights[3], device="cpu", **kw)


def _greq(text, max_tokens=4):
    return GenerationRequest(prompt=text,
                             sampling=SamplingParams(max_tokens=max_tokens))


def test_slow_step_trips_watchdog_readiness(weights):
    """An injected wedged step flips ``ready`` while it overruns the
    watchdog, and readiness recovers once steps are fast again."""
    inj = FaultInjector(seed=0, rates={"slow_step": 1.0}, slow_step_s=0.6)
    eng = _engine(weights, faults=inj)
    with EngineClient(eng, watchdog_timeout_s=0.1) as client:
        h = client.submit(_greq("wedge me", 3))
        saw_unready = False
        while not h.finished:
            saw_unready |= client.alive and not client.ready
            time.sleep(0.01)
        assert saw_unready and client.stats()["watchdog"]["trips"] >= 1
        eng.faults = None
        client.submit(_greq("fast again")).result(timeout=30)
        time.sleep(0.3)
        assert client.ready


def test_drain_finishes_in_flight_and_rejects_new_work(weights):
    client = EngineClient(_engine(weights), admission=AdmissionController())
    h = client.submit(_greq("finish me before the lights go out", 24))
    outcome = {}
    t = threading.Thread(target=lambda: outcome.setdefault(
        "clean", client.drain(timeout=60.0)))
    t.start()
    while not client.draining:
        time.sleep(0.001)
    assert not client.ready
    with pytest.raises(Overloaded) as err:
        client.submit(_greq("too late"))
    assert err.value.code == "draining" and err.value.retry_after > 0
    t.join(timeout=90.0)
    assert outcome["clean"]
    assert h.result(timeout=10).choices[0].finish_reason == "length"
    assert not client.alive
    with pytest.raises(RuntimeError):
        client.submit(_greq("way too late"))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_drain_cutoff_publishes_live_slots(weights, layout):
    """A drain that times out publishes the live slots' exact sequences
    (on pages by incref'd reference), aborts every open request with its
    typed event, and leaves no page pinned."""
    eng = _engine(weights, **LAYOUTS[layout])
    client = EngineClient(eng)
    handles = [client.submit(_greq(f"long job {i} " * 4, 100))
               for i in range(4)]                  # 3 live, 1 pending
    while sum(len(r.output_tokens) > 2 for h in handles
              for r in h._requests) < 3:
        time.sleep(0.01)
    assert not client.drain(timeout=0.0)
    reasons = [h.result(timeout=10).choices[0].finish_reason for h in handles]
    assert reasons == ["abort"] * 4
    live = [r for h in handles for r in h._requests if r.output_tokens]
    for r in live:
        value = eng.prefix_cache.take_exact(r.prompt_tokens + r.output_tokens)
        assert value is not None
        eng._release_snapshot_value(value)
    if layout == "paged":
        occ = eng.pool.page_occupancy()
        assert occ["pinned"] == 0 and occ["free"] + occ["reclaimable"] == \
            occ["total"]


def _cells(eng, slot, n):
    """The cache cells of a slot's first n positions, leaf by leaf (on
    pages the raw page contents: int8 values and their scales)."""
    pool, out = eng.pool, []
    subs = [(sub, False) for sub in pool.cache["prefix"]]
    subs += [(sub, True) for sub in (pool.cache.get("block") or {}).values()]
    for sub, stacked in subs:
        for name in sorted(sub):
            leaf = sub[name]
            if eng._paged:
                ids = torch.tensor(pool.slot_pages(slot))
                rows = (leaf[:, ids] if stacked else leaf[ids]).flatten(
                    int(stacked), int(stacked) + 1)
            else:
                rows = leaf[:, slot] if stacked else leaf[slot]
            out.append((rows[:, :n] if stacked else rows[:n]).clone())
    return out


def _outputs(handles):
    return [tuple(h.result(timeout=120).choices[0].tokens) for h in handles]


@pytest.mark.parametrize("layout", ["dense", "paged", "int8"])
def test_handoff_is_token_identical(weights, layout):
    """Export mid-decode from client A, import into client B: B's
    continuations equal an undrained run, B resumes the snapshotted slots
    with no prefill (the queued request re-prefills), and on int8 pages
    B's cells of each resumed slot equal A's bit for bit."""
    kw = {"dense": {}, "paged": LAYOUTS["paged"], "int8": INT8}[layout]
    prompts = [f"handoff identity prompt {i} with several words"
               for i in range(4)]
    with EngineClient(_engine(weights, **kw)) as ref:
        expected = _outputs([ref.submit(_greq(p, 16)) for p in prompts])

    a_eng, b_eng = _engine(weights, **kw), _engine(weights, **kw)
    cells = {}
    export = a_eng.export_handoff

    def recorded():
        # A's cells of every live slot, just before they leave
        for slot in a_eng._live_slots:
            r = a_eng.scheduler.active[slot]
            n = len(r.prompt_tokens) + r.num_generated - 1
            cells[r.request_id] = (n, _cells(a_eng, slot, n))
        return export()
    a_eng.export_handoff = recorded
    a = EngineClient(a_eng)
    handles = [a.submit(_greq(p, 16)) for p in prompts]   # 3 live, 1 queued
    while sum(len(h._requests[0].output_tokens) >= 2 for h in handles) < 3:
        time.sleep(0.005)
    recs = a.handoff_export()
    assert not a.alive and not a_eng.scheduler.has_work
    assert sorted(hr.request.request_id for hr in recs
                  if hr.record["cache"] is not None) == sorted(cells)
    assert len(cells) == 3 and len(recs) == 4
    waves = []
    real = b_eng._prefill
    b_eng._prefill = lambda *x, **k: waves.append(x[0].shape[0]) or \
        real(*x, **k)
    b = EngineClient(b_eng, auto_start=False)
    assert b.handoff_import(recs) == 4
    b_eng._plan_admissions()          # the resumes land; nothing decoded yet
    for slot, r in b_eng.scheduler.active.items():
        if r.request_id in cells:
            n, want = cells[r.request_id]
            got = _cells(b_eng, slot, n)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
    b.start()
    try:
        assert _outputs(handles) == expected
        assert b_eng.scheduler.stats.resumed == 3
        assert waves and all(k == 1 for k in waves)   # the queued one only
    finally:
        b.stop()


def test_launcher_flags_and_http_drain():
    """The launcher's new flags reach the engine, client and server; over
    HTTP ``POST /admin/drain`` answers 202, ``/readyz`` turns 503 with
    ``draining``, and a new request gets the 503 ``draining`` envelope
    with ``Retry-After``."""
    args = serve.parse_args([
        "--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
        "--cache-len", "128", "--max-batch", "2", "--port", "0",
        "--no-spec-fill", "--fault-rate", "pool=0.1", "--fault-seed", "4",
        "--watchdog-timeout", "5", "--drain-timeout", "30", "--no-admission"])
    srv = serve.build_server(args)
    api = srv.api
    assert not api.engine.speculative_fill
    assert api.engine.faults.rates == {"pool": 0.1}
    assert api.engine.faults.seed == 4
    assert api.client.watchdog_timeout_s == 5.0
    assert api.drain_timeout_s == 30.0
    srv.start()
    base = f"http://127.0.0.1:{srv.port}"

    def call(path, body=None):
        req = urllib.request.Request(
            base + path, data=None if body is None else json.dumps(body)
            .encode(), headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, dict(resp.headers), json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, dict(e.headers), json.loads(e.read())

    chat = {"messages": [{"role": "user", "content": "hi"}], "max_tokens": 2}
    try:
        assert call("/readyz")[0] == 200
        assert call("/v1/chat/completions", chat)[0] == 200
        stats = call("/stats")[2]
        assert stats["speculative_fill"] is False
        assert stats["watchdog"]["timeout_s"] == 5.0 and not stats["draining"]
        status, _, body = call("/admin/drain", {})
        assert status == 202 and body["status"] == "draining"
        assert body["timeout_s"] == 30.0
        status, _, body = call("/readyz")
        assert status == 503 and body["draining"]
        status, headers, body = call("/v1/chat/completions", chat)
        assert status == 503 and "Retry-After" in headers
        assert body["error"]["code"] in ("draining", "shutting_down")
    finally:
        srv.stop()
        api.client.stop()
