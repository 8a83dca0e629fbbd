"""The port's admission control against the JAX package's on the CPU.

``repro_torch.core.admission`` is a copy of the reference module: both
controllers run the same submit / poll / drop sequences under one injected
fake clock — the cases of ``tests/test_admission.py`` and one more on the
estimated-wait signal — and must give the same trace: release order,
expiries, rejections with their type, status, code and ``retry_after``,
ladder levels and ``snapshot()``.  The concurrent case runs each package's
controller alone (thread timing makes no trace to compare) under the same
invariants.

Then the port's serving path with admission on: ``EngineClient`` releases
into the engine and finishes queue-wait expiries with ``timeout``, and the
HTTP server answers 429 / 503 with the structured envelope and a
``Retry-After`` header, ``/readyz`` 200 when idle and 503 at SHED_ALL,
``/stats`` with the admission snapshot, and the tenant from ``user`` or an
``x-tenant`` header; the launcher builds the controller by default.
"""
import json
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from repro.core import admission as jadm
from repro.core import request as jreq
from repro_torch.configs import get_config
from repro_torch.core import admission as tadm
from repro_torch.core import request as treq
from repro_torch.core.engine import InferenceEngine
from repro_torch.launch import serve
from repro_torch.serving.api import OpenAIServer
from repro_torch.serving.client import EngineClient
from repro_torch.serving.server import ApiServer
from torch_threads import one_torch_thread  # noqa: F401

PACKAGES = {"jax": (jadm, jreq), "torch": (tadm, treq)}


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class Harness:
    """One package's controller under a fake clock, recording a trace in
    package-neutral terms (requests by the order they were made)."""

    def __init__(self, package):
        self.adm, self.req_mod = PACKAGES[package]
        self.clock = FakeClock()
        self.trace = []
        self._label = {}
        self.ctl = None

    def make(self, **kw):
        kw.setdefault("max_queue_depth", 64)
        kw.setdefault("queue_timeout_s", 10.0)
        tenants = kw.pop("tenants", {})
        self.ctl = self.adm.AdmissionController(
            clock=self.clock, tenants={
                k: self.adm.TenantConfig(**v) for k, v in tenants.items()},
            **kw)
        return self.ctl

    def req(self, tenant="default", prompt_len=8, interactive=False):
        r = self.req_mod.Request(
            prompt_tokens=list(range(prompt_len)),
            sampling=self.req_mod.SamplingParams(max_tokens=4),
            tenant=tenant, priority=5 if interactive else 0,
            deadline_ms=500.0 if interactive else None)
        self._label[r.request_id] = len(self._label)
        return r

    def label(self, r):
        return self._label[r.request_id]

    def submit(self, r):
        """Submit; returns None, or the rejection (also traced)."""
        try:
            self.ctl.submit(r)
        except self.adm.AdmissionError as e:
            self.trace.append(("reject", self.label(r), type(e).__name__,
                               e.status, e.code, e.retry_after, str(e)))
            return e
        self.trace.append(("queued", self.label(r)))
        return None

    def poll(self, capacity):
        ready, expired = self.ctl.poll(capacity)
        self.trace.append(("poll", capacity, [self.label(r) for r in ready],
                           [self.label(r) for r in expired]))
        return ready, expired

    def level(self):
        lvl = self.ctl.level
        self.trace.append(("level", lvl))
        return lvl

    def snapshot(self):
        snap = self.ctl.snapshot()
        self.trace.append(("snapshot", snap))
        return snap


# --------------------------------------------------------------------------- #
# the cases of tests/test_admission.py, each a function of one harness
# --------------------------------------------------------------------------- #
def token_bucket_refills_at_rate(h):
    b = h.adm.TokenBucket(rate=2.0, burst=4.0)
    assert b.try_take(4.0, now=0.0)
    assert not b.try_take(1.0, now=0.0)
    assert b.time_until(1.0, now=0.0) == pytest.approx(0.5)
    assert b.try_take(1.0, now=0.5)
    assert h.adm.TokenBucket(rate=0.0, burst=0.0).try_take(1e9, now=0.0)
    h.trace.append(("bucket", b.level, b.time_until(3.0, now=0.75)))


def rps_limit_rejects_with_retry_after(h):
    h.make(tenants={"t": dict(rps=1.0, burst_requests=2.0)})
    assert h.submit(h.req("t")) is None
    assert h.submit(h.req("t")) is None
    e = h.submit(h.req("t"))
    assert e.status == 429 and e.code == "rate_limited"
    assert 0 < e.retry_after <= 1.0
    h.clock.advance(1.0)
    assert h.submit(h.req("t")) is None
    h.snapshot()


def tps_limit_counts_prompt_tokens(h):
    h.make(tenants={"t": dict(tps=10.0, burst_tokens=10.0)})
    assert h.submit(h.req("t", prompt_len=8)) is None
    e = h.submit(h.req("t", prompt_len=8))
    assert isinstance(e, h.adm.RateLimited) and "tokens/s" in str(e)
    h.clock.advance(0.7)
    assert h.submit(h.req("t", prompt_len=8)) is None
    h.snapshot()


def rate_limits_are_per_tenant(h):
    h.make(tenants={"limited": dict(rps=1.0, burst_requests=1.0)})
    assert h.submit(h.req("limited")) is None
    assert isinstance(h.submit(h.req("limited")), h.adm.RateLimited)
    assert h.submit(h.req("free")) is None
    h.snapshot()


def release_order_tracks_weights(h):
    h.make(tenants={"a": dict(weight=2.0), "b": dict(weight=1.0)})
    for _ in range(12):
        h.submit(h.req("a"))
        h.submit(h.req("b"))
    ready, expired = h.poll(9)
    assert not expired
    by = {"a": 0, "b": 0}
    for r in ready:
        by[r.tenant] += 1
    assert by == {"a": 6, "b": 3}
    assert h.adm.jain_index([by["a"] / 2.0, by["b"] / 1.0]) == \
        pytest.approx(1.0)
    h.snapshot()


def idle_tenant_joins_at_current_vtime(h):
    h.make()
    for _ in range(16):
        h.submit(h.req("bulk", prompt_len=32))
    h.poll(8)
    h.submit(h.req("newcomer", prompt_len=8))
    ready, _ = h.poll(2)
    assert "newcomer" in {r.tenant for r in ready}
    h.snapshot()


def fair_share_under_flood_vs_trickle(h):
    h.make(max_queue_depth=512)
    for _ in range(100):
        h.submit(h.req("flood"))
    for _ in range(10):
        h.submit(h.req("trickle"))
    ready, _ = h.poll(20)
    by = {"flood": 0, "trickle": 0}
    for r in ready:
        by[r.tenant] += 1
    assert by == {"flood": 10, "trickle": 10}
    h.snapshot()


def queue_timeout_expires_instead_of_hanging(h):
    h.make(queue_timeout_s=5.0)
    stale = h.req("t")
    h.submit(stale)
    h.clock.advance(6.0)
    fresh = h.req("t")
    h.submit(fresh)
    ready, expired = h.poll(4)
    assert [r.request_id for r in expired] == [stale.request_id]
    assert [r.request_id for r in ready] == [fresh.request_id]
    assert h.ctl.queue_depth == 0
    snap = h.snapshot()
    assert snap["timeouts"] == 1 and snap["tenants"]["t"]["timeouts"] == 1


def global_depth_bound_sheds_everything(h):
    h.make(max_queue_depth=4, shed_queue_depth=4)
    for _ in range(4):
        h.submit(h.req("t", interactive=True))
    assert h.level() == h.adm.LEVEL_SHED_ALL
    for interactive in (False, True):
        e = h.submit(h.req("t", interactive=interactive))
        assert isinstance(e, h.adm.Overloaded)
        assert e.status == 503 and e.retry_after >= 1.0
    h.snapshot()


def per_tenant_queue_bound(h):
    h.make(tenants={"small": dict(max_queue=2)})
    h.submit(h.req("small"))
    h.submit(h.req("small"))
    assert isinstance(h.submit(h.req("small")), h.adm.Overloaded)
    assert h.submit(h.req("other")) is None
    h.snapshot()


def shed_bulk_keeps_interactive_traffic(h):
    h.make(max_queue_depth=16, shed_queue_depth=4)
    for _ in range(4):
        h.submit(h.req("t", interactive=True))
    assert h.level() == h.adm.LEVEL_SHED_BULK
    assert h.submit(h.req("t")).status == 503
    assert h.submit(h.req("t", interactive=True)) is None
    h.snapshot()


def saturated_headroom_escalates_soft_shed(h):
    h.make(max_queue_depth=16, shed_queue_depth=2, headroom_fn=lambda: 0.0)
    h.submit(h.req("t", interactive=True))
    assert h.level() == h.adm.LEVEL_NORMAL
    h.submit(h.req("t", interactive=True))
    assert h.level() == h.adm.LEVEL_SHED_ALL
    assert isinstance(h.submit(h.req("t", interactive=True)),
                      h.adm.Overloaded)
    h.snapshot()


def drain_is_terminal_and_finishes_queued_work(h):
    h.make()
    queued = h.req("t")
    h.submit(queued)
    h.ctl.start_drain()
    assert h.level() == h.adm.LEVEL_DRAINING
    assert h.submit(h.req("t")).code == "draining"
    ready, _ = h.poll(4)
    assert [r.request_id for r in ready] == [queued.request_id]
    h.snapshot()


def drop_removes_queued_request(h):
    h.make()
    a, b = h.req("t"), h.req("t")
    h.submit(a)
    h.submit(b)
    assert h.ctl.drop(a.request_id) is a
    assert h.ctl.drop(a.request_id) is None
    ready, _ = h.poll(4)
    assert [r.request_id for r in ready] == [b.request_id]
    h.snapshot()


def jain_index_bounds(h):
    values = ([1.0, 1.0, 1.0], [1.0, 0.0, 0.0], [], [0.0, 0.0], [3.0, 1.0])
    got = [h.adm.jain_index(v) for v in values]
    assert got[0] == pytest.approx(1.0) and got[1] == pytest.approx(1 / 3)
    assert got[2] == 1.0 and got[3] == 1.0
    h.trace.append(("jain", got))


def estimated_wait_ladder_and_retry_after(h):
    """Beyond the reference's cases: the estimated-wait signal (releases
    observed over time) drives the ladder and every ``retry_after``."""
    h.make(max_queue_depth=64, shed_queue_depth=32, shed_wait_s=2.0,
           queue_timeout_s=30.0)
    for step in range(6):
        for _ in range(4):
            h.submit(h.req("t", interactive=step % 2 == 0))
        h.clock.advance(1.5)
        h.poll(1)
        h.level()
    h.snapshot()


CASES = [token_bucket_refills_at_rate, rps_limit_rejects_with_retry_after,
         tps_limit_counts_prompt_tokens, rate_limits_are_per_tenant,
         release_order_tracks_weights, idle_tenant_joins_at_current_vtime,
         fair_share_under_flood_vs_trickle,
         queue_timeout_expires_instead_of_hanging,
         global_depth_bound_sheds_everything, per_tenant_queue_bound,
         shed_bulk_keeps_interactive_traffic,
         saturated_headroom_escalates_soft_shed,
         drain_is_terminal_and_finishes_queued_work,
         drop_removes_queued_request, jain_index_bounds,
         estimated_wait_ladder_and_retry_after]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_controller_trace_matches_reference(case):
    traces = []
    for package in ("jax", "torch"):
        h = Harness(package)
        case(h)
        traces.append(h.trace)
    assert traces[0], "the case recorded nothing"
    assert traces[1] == traces[0]


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_snapshot_consistent_under_concurrent_mutation(package):
    """Handler threads submit while a loop thread polls and another
    snapshots: every submit ends released, shed or still queued; each
    snapshot's totals are its tenants' sums; counters only grow."""
    adm, req_mod = PACKAGES[package]
    ctl = adm.AdmissionController(
        max_queue_depth=32, queue_timeout_s=30.0,
        tenants={"a": adm.TenantConfig(weight=2.0),
                 "b": adm.TenantConfig(rps=200.0, burst_requests=4.0)})
    n = 200
    outcomes = {"admitted": 0, "rejected": 0}
    lock = threading.Lock()
    stop = threading.Event()
    snaps, released = [], []

    def submitter(tenant):
        for i in range(n):
            r = req_mod.Request(prompt_tokens=list(range(8)),
                                sampling=req_mod.SamplingParams(max_tokens=4),
                                tenant=tenant, priority=5 * (i % 2 == 0))
            try:
                ctl.submit(r)
                key = "admitted"
            except adm.AdmissionError:
                key = "rejected"
            with lock:
                outcomes[key] += 1

    def poller():
        while not stop.is_set():
            ready, expired = ctl.poll(capacity=4)
            released.extend(ready)
            assert not expired

    def snapshotter():
        while not stop.is_set():
            snap = ctl.snapshot()
            snaps.append(snap)
            for key in ("shed_rate_limited", "shed_overload", "timeouts"):
                assert snap[key] == sum(t[key]
                                        for t in snap["tenants"].values())

    threads = [threading.Thread(target=submitter, args=(t,))
               for t in ("a", "b", "c")]
    aux = [threading.Thread(target=poller),
           threading.Thread(target=snapshotter)]
    for t in aux + threads:
        t.start()
    for t in threads:
        t.join()
    stop.set()
    for t in aux:
        t.join()
    released.extend(ctl.poll(capacity=10_000)[0])
    assert outcomes["admitted"] + outcomes["rejected"] == 3 * n
    assert len({r.request_id for r in released}) == len(released) == \
        outcomes["admitted"]
    final = ctl.snapshot()
    assert final["queue_depth"] == 0
    assert final["shed_rate_limited"] + final["shed_overload"] == \
        outcomes["rejected"]
    assert snaps
    for a, b in zip(snaps, snaps[1:]):
        assert b["released"] >= a["released"]


# --------------------------------------------------------------------------- #
# the serving path with admission on (CPU)
# --------------------------------------------------------------------------- #
def _gated_engine():
    """A toy engine whose steps wait on a gate: the test holds it shut, so
    the client's loop thread stays inside one step and releases nothing
    more — every later submit waits at admission — then opens it."""
    engine = InferenceEngine(get_config("qwen3-0.6b-toy"), device="cpu",
                             max_batch=2, cache_len=128)
    gate = threading.Event()
    step = engine.step

    def gated_step():
        gate.wait()
        return step()

    engine.step = gated_step
    return engine, gate


def _request(port, path, body=None, headers=None):
    """(status, headers, parsed body) of one HTTP call."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _chat_body(text, **extra):
    return {"messages": [{"role": "user", "content": text}],
            "max_tokens": 3, **extra}


@pytest.fixture
def gated_server():
    servers = []

    def make(**adm_kw):
        engine, gate = _gated_engine()
        ctl = tadm.AdmissionController(**adm_kw)
        client = EngineClient(engine, admission=ctl)
        srv = ApiServer(OpenAIServer(client, "toy"), port=0)
        srv.start()
        servers.append((srv, client, gate))
        return types.SimpleNamespace(port=srv.port, client=client, ctl=ctl,
                                     gate=gate, engine=engine)

    yield make
    for srv, client, gate in servers:
        gate.set()
        srv.stop()
        client.stop()


def _fire(port, bodies, headers=None):
    """All bodies concurrently; returns their (status, headers, body)."""
    out = [None] * len(bodies)

    def one(i):
        out[i] = _request(port, "/v1/chat/completions", bodies[i], headers)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    return threads, out


def _wait(cond, timeout=60.0):
    t0 = time.monotonic()
    while not cond():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("condition not reached")
        time.sleep(0.01)


def test_rate_limit_gives_429_with_retry_after(gated_server):
    # shed_wait_s=0: the ladder reads queue depth alone (after the first
    # release, with no release rate observed yet, the estimated wait is
    # infinite and a concurrent burst would be shed before its rate check)
    s = gated_server(shed_wait_s=0, tenants={"bulk": tadm.TenantConfig(
        rps=0.1, burst_requests=2.0)})
    s.gate.set()
    threads, results = _fire(s.port, [_chat_body(f"q{i}") for i in range(6)],
                             {"x-tenant": "bulk"})
    for t in threads:
        t.join(timeout=120)
    codes = [code for code, _, _ in results]
    assert codes.count(200) == 2 and codes.count(429) == 4
    for code, headers, body in results:
        if code == 429:
            assert body["error"]["type"] == "rate_limit_error"
            assert body["error"]["code"] == "rate_limited"
            assert int(headers["Retry-After"]) >= 1
        else:
            assert body["choices"][0]["finish_reason"] in ("stop", "length")
    # another tenant (the body's `user` field) is not limited
    code, _, _ = _request(s.port, "/v1/chat/completions",
                          _chat_body("other", user="someone"))
    assert code == 200
    snap = _request(s.port, "/stats")[2]["admission"]
    assert snap["tenants"]["bulk"]["shed_rate_limited"] == codes.count(429)


def test_overload_gives_503_and_readyz_flips(gated_server):
    """The engine held inside a step with one request: 4 of 16 concurrent
    requests wait at admission and the other 12 get 503 ``overloaded``
    envelopes; ``/readyz`` reads 503 at SHED_ALL and 200 again once the
    gate opens and every admitted request completes."""
    s = gated_server(max_queue_depth=4, shed_queue_depth=4, shed_wait_s=0)
    assert _request(s.port, "/readyz")[0] == 200
    first, out1 = _fire(s.port, [_chat_body("hog")])
    _wait(lambda: len(s.engine.scheduler.pending) == 1)
    threads, out = _fire(s.port, [_chat_body(f"burst {i}")
                                  for i in range(16)])
    _wait(lambda: sum(o is not None for o in out) >= 12)
    code, _, ready = _request(s.port, "/readyz")
    assert code == 503 and ready["level"] == "shed_all"
    assert _request(s.port, "/stats")[2]["admission"]["queue_depth"] == 4
    s.gate.set()
    for t in first + threads:
        t.join(timeout=120)
    codes = [o[0] for o in out]
    assert codes.count(503) == 12 and codes.count(200) == 4
    for code, headers, body in out1 + out:
        if code == 503:
            assert body["error"]["type"] == "overloaded_error"
            assert body["error"]["code"] == "overloaded"
            assert int(headers["Retry-After"]) >= 1
        else:
            assert code == 200
            assert body["choices"][0]["finish_reason"] in ("stop", "length")
    _wait(lambda: _request(s.port, "/readyz")[0] == 200)


def test_shed_bulk_admits_interactive_only(gated_server):
    s = gated_server(max_queue_depth=16, shed_queue_depth=2, shed_wait_s=0)
    first, _ = _fire(s.port, [_chat_body("hog")])
    _wait(lambda: len(s.engine.scheduler.pending) == 1)
    urgent = [_chat_body(f"urgent {i}", deadline_ms=5000.0) for i in range(2)]
    more, _ = _fire(s.port, urgent)
    _wait(lambda: s.ctl.queue_depth == 2)
    assert s.ctl.level == tadm.LEVEL_SHED_BULK
    code, headers, body = _request(s.port, "/v1/chat/completions",
                                   _chat_body("batch work"))
    assert code == 503 and body["error"]["code"] == "overloaded"
    assert "batch-class" in body["error"]["message"]
    assert int(headers["Retry-After"]) >= 1
    last, out = _fire(s.port, [_chat_body("interactive", priority=3)])
    _wait(lambda: s.ctl.queue_depth == 3)
    s.gate.set()
    for t in first + more + last:
        t.join(timeout=120)
    assert out[0][0] == 200


def test_queue_wait_expiry_finishes_with_timeout(gated_server):
    s = gated_server(queue_timeout_s=0.2)
    first, _ = _fire(s.port, [_chat_body("hog")])
    _wait(lambda: len(s.engine.scheduler.pending) == 1)
    late, out = _fire(s.port, [_chat_body("waits too long")])
    _wait(lambda: s.ctl.queue_depth == 1)
    time.sleep(0.4)
    s.gate.set()
    for t in first + late:
        t.join(timeout=120)
    code, _, body = out[0]
    assert code == 200
    assert body["choices"][0]["finish_reason"] == "timeout"
    assert body["usage"]["completion_tokens"] == 0
    assert s.ctl.snapshot()["timeouts"] == 1


def test_client_abort_drops_a_queued_request(gated_server):
    s = gated_server()

    def submit(text):
        return s.client.submit(treq.GenerationRequest(
            prompt=text, sampling=treq.SamplingParams(max_tokens=2)))

    handles = [submit("hog")]
    _wait(lambda: len(s.engine.scheduler.pending) == 1)
    handles.append(submit("queued"))
    assert s.ctl.queue_depth == 1
    # the abort lands at the loop's next iteration, ahead of its admission
    # round: the request leaves the admission queue without ever running
    handles[-1].abort(wait=False)
    s.gate.set()
    _wait(lambda: handles[-1].finished)
    assert handles[-1].result().choices[0].finish_reason == "abort"
    assert s.ctl.queue_depth == 0
    assert s.ctl.snapshot()["released"] == 1
    for h in handles[:-1]:
        assert h.result(timeout=120).choices[0].finish_reason in (
            "stop", "length")


def test_launcher_builds_admission_by_default():
    args = serve.parse_args(["--arch", "qwen2-0.5b", "--smoke", "--device",
                             "cpu", "--cache-len", "64", "--max-batch", "2",
                             "--port", "0", "--tenant", "bulk=2:3:100",
                             "--max-queue-depth", "8", "--queue-timeout",
                             "5", "--kv-layout", "paged", "--kv-num-pages",
                             "6", "--sched-policy", "edf", "--preemption"])
    srv = serve.build_server(args)
    try:
        ctl = srv.api.client._admission
        assert ctl.max_queue_depth == 8 and ctl.queue_timeout_s == 5.0
        assert ctl.shed_queue_depth == 4 and ctl.shed_wait_s == 10.0
        bulk = ctl.tenant_cfgs["bulk"]
        assert (bulk.weight, bulk.rps, bulk.tps) == (2.0, 3.0, 100.0)
        assert ctl.headroom_fn is not None and 0 <= ctl.headroom_fn() <= 1
        eng = srv.api.engine
        assert eng.preemption and eng.pool.num_pages == 6
        srv.start()
        code, _, body = _request(srv.port, "/v1/chat/completions",
                                 _chat_body("hello", max_tokens=4))
        assert code == 200 and body["usage"]["completion_tokens"] >= 1
        stats = _request(srv.port, "/stats")[2]
        assert stats["admission"]["released"] == 1
        assert stats["preemption"] is True
    finally:
        srv.stop()
        srv.api.client.stop()
    off = serve.build_server(serve.parse_args(
        ["--smoke", "--device", "cpu", "--cache-len", "64", "--port", "0",
         "--no-admission"]))
    off.start()
    try:
        assert off.api.client._admission is None
        assert off.api.readyz() == ({"status": "ok", "ok": True,
                                     "draining": False}, 200)
    finally:
        off.stop()
        off.api.client.stop()
