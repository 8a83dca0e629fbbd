"""The port's multi-replica router on the CPU: the functions of
``tests/test_router.py`` over the port's engines (``qwen3-0.6b-toy``,
weights bridged from one JAX init), plus placement and ``stats_v2`` step by
step against the JAX package's ``Router`` on the same request sequence.

Drain / handoff: the live slots of a drained replica resume on its
successor with the greedy tokens of the JAX engine serving the same
prompts undrained, on the dense ring and on 16-token pages.  No test
sleeps a fixed time: each waits for the state it needs (a handle's first
tokens) against a deadline, and holds the victim's loop at a step
boundary while the drain is requested.
"""
import threading
import time

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.admission import AdmissionController as JaxAdmission
from repro.core.engine import InferenceEngine as JaxEngine
from repro.core.request import GenerationRequest as JaxGenerationRequest
from repro.core.request import Request as JaxRequest
from repro.core.request import SamplingParams as JaxSampling
from repro.models import build_model
from repro.serving.client import EngineClient as JaxClient
from repro.serving.router import Router as JaxRouter
from repro_torch.configs import get_config
from repro_torch.core.admission import (AdmissionController, Overloaded,
                                        RateLimited, TenantConfig)
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import GenerationRequest, SamplingParams
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.api import OpenAIServer
from repro_torch.serving.client import EngineClient
from repro_torch.serving.router import (ReplicaStats, Router, RouterStats,
                                        _digest_chain)
from repro_torch.serving.tokenizer import ByteTokenizer
from torch_threads import one_torch_thread  # noqa: F401

LONG = "a shared system prompt that spans multiple digest blocks " * 3
TOK = ByteTokenizer()


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("qwen3-0.6b-toy")
    tcfg = get_config("qwen3-0.6b-toy")
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                          "cpu")


def mk_engine(weights, *, layout="dense", **kw):
    kw.setdefault("max_batch", 4)
    return InferenceEngine(weights[1], weights[3], device="cpu",
                           cache_len=256, seed=0, kv_layout=layout,
                           kv_page_size=16, **kw)


def mk_client(weights, *, admission=True, layout="dense", **adm_kw):
    adm = AdmissionController(**adm_kw) if admission else None
    return EngineClient(mk_engine(weights, layout=layout), admission=adm)


def greq(prompt, max_tokens=4, **kw):
    return GenerationRequest(prompt=prompt,
                             sampling=SamplingParams(max_tokens=max_tokens),
                             **kw)


def wait_for(cond, what, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def gate_steps(client):
    """Make the client's engine steps wait on the returned event while it
    is clear (the loop holds at a step boundary)."""
    gate = threading.Event()
    gate.set()
    step = client.engine.step

    def held():
        gate.wait()
        return step()

    client.engine.step = held
    return gate


# --------------------------------------------------------------------- #
# shared-prefix n>1 groups
# --------------------------------------------------------------------- #
def test_n_fanout_shares_prefix_with_zero_full_copies(weights):
    """n=4 admits as one group: one prefill, three shared admissions, no
    full-cache copy, and the choices equal an n=1 run (greedy).  Prefix
    cache off: sharing comes from the engine's group table."""
    eng = mk_engine(weights, layout="paged", max_batch=8,
                    enable_prefix_cache=False)
    with EngineClient(eng) as client:
        res = client.submit(greq(LONG, max_tokens=8, n=4)).result(timeout=120)
        texts = [c.text for c in res.choices]
    assert len(texts) == 4 and len(set(texts)) == 1
    assert eng.group_stats["groups"] == 1
    assert eng.group_stats["shared_admits"] == 3
    assert eng.pool.stats.full_copies == 0
    eng2 = mk_engine(weights, layout="paged", max_batch=8,
                     enable_prefix_cache=False)
    with EngineClient(eng2) as solo:
        ref = solo.submit(greq(LONG, max_tokens=8, n=1)).result(timeout=120)
    assert texts[0] == ref.choices[0].text


def test_n_fanout_group_dense_layout(weights):
    eng = mk_engine(weights, max_batch=8, enable_prefix_cache=False)
    with EngineClient(eng) as client:
        res = client.submit(greq(LONG, max_tokens=6, n=3)).result(timeout=120)
        texts = [c.text for c in res.choices]
    assert len(set(texts)) == 1
    assert eng.group_stats["shared_admits"] == 2


# --------------------------------------------------------------------- #
# placement
# --------------------------------------------------------------------- #
def test_session_affinity_pins_to_one_replica(weights):
    with Router([mk_client(weights), mk_client(weights)]) as router:
        for turn in range(3):
            router.submit(greq(f"turn {turn} of the conversation",
                               session="chat-1")).result(timeout=120)
        stats = router.router_stats()
        assert isinstance(stats, RouterStats)
        assert stats.placements["session"] == 2
        assert stats.sessions_pinned == 1


def test_prefix_affinity_routes_to_warm_replica(weights):
    with Router([mk_client(weights), mk_client(weights)]) as router:
        router.submit(greq(LONG + " question one")).result(timeout=120)
        first = next(i for i, r in enumerate(router.replicas) if r.submitted)
        router.submit(greq(LONG + " question two")).result(timeout=120)
        assert router.router_stats().placements["prefix"] == 1
        assert router.replicas[first].submitted == 2


def test_digest_chain_properties():
    a = _digest_chain(LONG + "suffix one")
    b = _digest_chain(LONG + "suffix two")
    c = _digest_chain("completely different prompt " * 4)
    shared = sum(1 for x, y in zip(a, b) if x == y)
    assert shared >= 1
    assert a[:shared] == b[:shared]
    assert not set(a) & set(c)
    assert _digest_chain(list(range(64))) != _digest_chain(list(range(64, 128)))


def test_round_robin_and_random_policies(weights):
    with Router([mk_client(weights), mk_client(weights)],
                policy="round_robin") as router:
        for i in range(4):
            router.submit(greq(f"rr {i}", max_tokens=2)).result(timeout=120)
        assert router.router_stats().placements["round_robin"] == 4
        assert all(r.submitted > 0 for r in router.replicas)
    with Router([mk_client(weights), mk_client(weights)], policy="random",
                seed=7) as router:
        for i in range(4):
            router.submit(greq(f"rnd {i}", max_tokens=2)).result(timeout=120)
        assert router.router_stats().placements["random"] == 4


def test_shed_bulk_replica_stops_taking_batch_traffic(weights):
    shedding = mk_client(weights, shed_queue_depth=0, shed_wait_s=0)
    with Router([shedding, mk_client(weights)]) as router:
        assert router.replicas[0].sheds_batch()
        for i in range(3):
            router.submit(greq(f"batch job {i}", max_tokens=2)).result(
                timeout=120)
        assert router.replicas[0].submitted == 0
        assert router.replicas[1].submitted == 3


def test_rate_limited_propagates_without_failover(weights):
    limited = mk_client(weights, tenants={"t1": TenantConfig(
        weight=1, rps=0.001, burst_requests=1.0)})
    with Router([limited, mk_client(weights)]) as router:
        router.submit(greq("first", max_tokens=2, tenant="t1",
                           session="pin")).result(timeout=120)
        with pytest.raises(RateLimited):
            router.submit(greq("second", max_tokens=2, tenant="t1",
                               session="pin"))
        assert router.router_stats().failovers == 0


def test_failover_on_refusing_replica(weights):
    a, b = mk_client(weights), mk_client(weights)
    with Router([a, b], policy="round_robin") as router:
        a._admission.start_drain()
        for i in range(4):
            router.submit(greq(f"after refusal {i}", max_tokens=2,
                               priority=1)).result(timeout=120)
        assert router.router_stats().failovers >= 1
        assert router.replicas[0].submitted == 0
        assert router.replicas[1].submitted == 4


def test_all_draining_rejects_with_structured_503(weights):
    with Router([mk_client(weights), mk_client(weights)]) as router:
        for rep in router.replicas:
            rep.client._draining = True
        with pytest.raises(Overloaded) as ei:
            router.submit(greq("too late"))
        assert ei.value.code == "draining"
        assert ei.value.status == 503
        assert ei.value.retry_after > 0


# --------------------------------------------------------------------- #
# drain / handoff
# --------------------------------------------------------------------- #
PROMPTS = [f"handoff identity prompt {i} with several words" for i in range(3)]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_drain_handoff_bit_identity(weights, layout):
    """Mid-decode drain of replica 0: the live slots move as cache
    snapshots and finish on replica 1 with the JAX engine's undrained
    greedy tokens; handles keep streaming with no finish event for the
    hop, and the victim ends stopped."""
    je = JaxEngine(weights[0], weights[2], max_batch=4, cache_len=256, seed=0,
                   kv_layout=layout, kv_page_size=16)
    jr = [JaxRequest(prompt_tokens=TOK.encode(p),
                     sampling=JaxSampling(max_tokens=40)) for p in PROMPTS]
    je.generate(jr)
    expected = [tuple(r.output_tokens) for r in jr]

    a = mk_client(weights, admission=False, layout=layout)
    b = mk_client(weights, admission=False, layout=layout)
    with Router([a, b], policy="round_robin") as router:
        handles = [a.submit(greq(p, max_tokens=40)) for p in PROMPTS]
        router.replicas[0].open = [(h, 1000) for h in handles]
        wait_for(lambda: all(h._requests[0].num_generated >= 1
                             for h in handles), "first tokens")
        gate = gate_steps(a)
        gate.clear()
        threading.Timer(0.05, gate.set).start()
        info = router.drain_replica(0)
        assert info["adopted"] == info["exported"] > 0
        outs = [tuple(h._requests[0].output_tokens)
                for h in handles if h.result(timeout=120)]
        assert outs == expected
        events = [list(h.stream()) for h in handles]
        assert all(sum(type(e).__name__ == "FinishEvent" for e in ev) == 1
                   for ev in events)
        assert router.replicas[0].state == "stopped"
        assert router.router_stats().handoffs == 1
        assert b.engine.scheduler.stats.resumed > 0


def test_session_affinity_survives_drain(weights):
    with Router([mk_client(weights), mk_client(weights)]) as router:
        h = router.submit(greq("long running turn with words",
                               max_tokens=32, session="sticky"))
        wait_for(lambda: h._requests[0].num_generated >= 1, "a token")
        pinned = router._sessions["sticky"]
        router.drain_replica(pinned)
        assert h.result(timeout=120).choices[0].finish_reason in (
            "length", "stop")
        router.submit(greq("the next turn", max_tokens=2,
                           session="sticky")).result(timeout=120)
        assert router._sessions["sticky"] != pinned
        assert router.router_stats().placements["session"] >= 1


def test_drain_replica_rejects_bad_successor(weights):
    with Router([mk_client(weights), mk_client(weights)]) as router:
        with pytest.raises(ValueError):
            router.drain_replica(0, successor=0)
        assert router.replicas[0].state == "up"
        router.replicas[1].client.stop()
        with pytest.raises(RuntimeError):
            router.drain_replica(0)
        assert router.replicas[0].state == "up"


# --------------------------------------------------------------------- #
# stats v2 envelope
# --------------------------------------------------------------------- #
def test_stats_v2_envelope_and_typed_accessors(weights):
    with Router([mk_client(weights), mk_client(weights)]) as router:
        router.submit(greq("warm up", max_tokens=2)).result(timeout=120)
        out = OpenAIServer(router, "toy").stats()
        assert out["schema_version"] == OpenAIServer.STATS_SCHEMA_VERSION
        assert out["router"]["policy"] == "affinity"
        assert [r["name"] for r in out["replicas"]] == ["replica-0",
                                                        "replica-1"]
        assert "max_batch" in out and "retired" in out
        assert "deprecation" in out
        for rs in router.replica_stats():
            assert isinstance(rs, ReplicaStats)
            assert rs.state == "up" and rs.alive
        assert isinstance(router.router_stats(), RouterStats)


def test_stats_v2_single_replica_shape(weights):
    with mk_client(weights) as client:
        out = OpenAIServer(client, "toy").stats()
        assert out["schema_version"] == 2
        assert out["router"] is None
        assert len(out["replicas"]) == 1
        assert out["replicas"][0]["name"] == "replica-0"
        assert "max_batch" in out


def test_router_health_surface(weights):
    a, b = mk_client(weights), mk_client(weights)
    with Router([a, b]) as router:
        assert router.alive and router.ready and not router.draining
        assert router.engine is a.engine
        assert router._admission is a._admission
        a.stop()
        assert router.alive and router.ready
        b._draining = True
        assert not router.ready


# --------------------------------------------------------------------- #
# step by step against the JAX package's router
# --------------------------------------------------------------------- #
def test_placement_and_stats_step_by_step_against_jax_router(weights):
    """The same sequence (sessions, a shared long prefix, token prompts,
    plain load) through both routers, one request at a time: the same
    replica, placement reason counts, session pins, per-replica
    submissions and digest footprints after every request, the same
    greedy tokens, and equal ``router`` sections of ``stats_v2``."""
    jcfg, _, jp, _ = weights

    def jax_client():
        return JaxClient(JaxEngine(jcfg, jp, max_batch=4, cache_len=256,
                                   seed=0), admission=JaxAdmission())

    seq = [dict(prompt="hello one", session="s1"),
           dict(prompt=LONG + " first question"),
           dict(prompt="hello two", session="s2"),
           dict(prompt=LONG + " second question"),
           dict(prompt="turn two of s1", session="s1"),
           dict(prompt=list(range(3, 40))),
           dict(prompt=list(range(3, 40)) + [7, 8]),
           dict(prompt="unrelated traffic", priority=1),
           dict(prompt="turn two of s2", session="s2"),
           dict(prompt=LONG + " third question", session="s3")]
    with JaxRouter([jax_client(), jax_client()]) as jr, \
            Router([mk_client(weights), mk_client(weights)]) as tr:
        for kw in seq:
            jh = jr.submit(JaxGenerationRequest(
                sampling=JaxSampling(max_tokens=3), **kw))
            th = tr.submit(greq(max_tokens=3, **kw))
            assert th.result(timeout=120).choices[0].tokens == \
                jh.result(timeout=120).choices[0].tokens
            assert tr._placements == jr._placements
            assert dict(tr._sessions) == dict(jr._sessions)
            assert [r.submitted for r in tr.replicas] == \
                [r.submitted for r in jr.replicas]
            assert [len(r.index) for r in tr.replicas] == \
                [len(r.index) for r in jr.replicas]
        assert tr.stats_v2()["router"] == jr.stats_v2()["router"]
        keys = ("name", "state", "alive", "ready", "draining", "level",
                "queue_depth", "outstanding_tokens", "open_requests",
                "submitted", "digest_blocks", "retired", "submitted")
        for t, j in zip(tr.stats_v2()["replicas"], jr.stats_v2()["replicas"]):
            assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
