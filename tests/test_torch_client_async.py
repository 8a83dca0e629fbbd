"""The port client's async surface and ``OpenAIServer.batch`` on the CPU,
against the JAX package where the two can be compared (weights of
``qwen3-0.6b-toy`` bridged from one JAX init):

* ``async for`` over a handle and ``await result_async()`` (the tests of
  ``tests/test_engine_client.py``), with the JAX client's tokens;
* many handles awaited on one event loop at once, no worker thread each;
* ``statuses`` per choice, ``abort_async`` freeing the slot;
* the async codec methods equal their sync twins;
* ``batch`` (``tests/test_system.py:48``): 8 bodies equal 8 single calls,
  and the JAX server's ``batch`` texts.

Nothing sleeps a fixed time: waits poll against a deadline.
"""
import asyncio
import threading
import time

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.core.engine import InferenceEngine as JaxEngine
from repro.core.request import GenerationRequest as JaxGenerationRequest
from repro.core.request import SamplingParams as JaxSampling
from repro.models import build_model
from repro.serving.api import OpenAIServer as JaxOpenAIServer
from repro.serving.client import EngineClient as JaxClient
from repro_torch.configs import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import (GenerationRequest, RequestStatus,
                                      SamplingParams)
from repro_torch.models.convert import params_from_jax
from repro_torch.serving.api import OpenAIServer
from repro_torch.serving.client import EngineClient, FinishEvent, TokenEvent
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_get_config("qwen3-0.6b-toy")
    tcfg = get_config("qwen3-0.6b-toy")
    jp = build_model(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), tcfg,
                                          "cpu")


def engine(weights, **kw):
    kw.setdefault("max_batch", 4)
    return InferenceEngine(weights[1], weights[3], device="cpu",
                           cache_len=128, seed=0, **kw)


def jax_engine(weights, **kw):
    kw.setdefault("max_batch", 4)
    return JaxEngine(weights[0], weights[2], cache_len=128, seed=0, **kw)


def wait_for(cond, what, timeout=120.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def test_handle_async_stream_and_result(weights):
    """``async for`` over the stream, then ``await result_async()``: the
    JAX client's tokens and finish reason."""
    async def drive(client, req):
        h = client.submit(req)
        toks = []
        async for ev in h.stream():
            if isinstance(ev, TokenEvent):
                toks.append(ev.token)
        result = await h.result_async()
        return toks, result.choices[0].tokens, result.choices[0].finish_reason

    with EngineClient(engine(weights)) as client:
        toks, res_toks, reason = asyncio.run(drive(client, GenerationRequest(
            prompt="async", sampling=SamplingParams(max_tokens=6))))
    with JaxClient(jax_engine(weights)) as jclient:
        _, jtoks, jreason = asyncio.run(drive(jclient, JaxGenerationRequest(
            prompt="async", sampling=JaxSampling(max_tokens=6))))
    assert toks == res_toks == jtoks and len(toks) == 6
    assert reason == jreason == "length"


def test_many_handles_on_one_event_loop(weights):
    """16 handles streamed concurrently by one event loop: each stream
    ends with its one finish event and equals ``result()``; no thread is
    started for the open streams (the waker path parks none)."""
    before = threading.active_count()

    async def one(client, i):
        h = client.submit(GenerationRequest(
            prompt=f"concurrent {i}", sampling=SamplingParams(max_tokens=5)))
        events = [ev async for ev in h.stream()]
        res = await h.result_async()
        return events, res

    async def drive(client):
        out = await asyncio.gather(*(one(client, i) for i in range(16)))
        return out, threading.active_count()

    with EngineClient(engine(weights)) as client:
        out, during = asyncio.run(drive(client))
    assert during <= before + 1        # the client's loop thread alone
    for events, res in out:
        toks = [e.token for e in events if isinstance(e, TokenEvent)]
        fins = [e for e in events if isinstance(e, FinishEvent)]
        assert toks == res.choices[0].tokens and len(fins) == 1


def test_statuses_per_choice(weights):
    """``statuses`` lists each choice's state: queued before the loop
    takes them, then terminal for all three choices of an n = 3 group."""
    eng = engine(weights)
    client = EngineClient(eng)
    try:
        gate = threading.Event()
        step = eng.step

        def held():
            gate.wait()
            return step()

        eng.step = held
        h = client.submit(GenerationRequest(
            prompt="fan out", n=3, sampling=SamplingParams(max_tokens=4)))
        assert len(h.statuses) == 3
        assert all(s in (RequestStatus.QUEUED, RequestStatus.PREFILLING)
                   for s in h.statuses)
        gate.set()
        h.result(timeout=120)
        assert h.statuses == [RequestStatus.FINISHED] * 3
        assert h.status is RequestStatus.FINISHED
    finally:
        client.stop()


def test_abort_async_frees_the_slot(weights):
    """``await abort_async()`` returns once the slot is reclaimed; the
    stream ends with one ``abort`` finish and the engine serves on."""
    eng = engine(weights, max_batch=2)

    async def drive(client):
        h = client.submit(GenerationRequest(
            prompt="unbounded", sampling=SamplingParams(max_tokens=4000)))
        first = None
        async for ev in h.stream():
            first = ev
            break
        assert isinstance(first, TokenEvent)
        assert await h.abort_async()
        return h

    with EngineClient(eng) as client:
        h = asyncio.run(drive(client))
        assert h.status is RequestStatus.ABORTED
        assert [e.finish_reason for e in h.stream()
                if isinstance(e, FinishEvent)] == ["abort"]
        wait_for(lambda: eng.pool.num_free == 2, "the freed slot")
        after = client.generate(GenerationRequest(
            prompt="after", sampling=SamplingParams(max_tokens=3)))
        assert after.choices[0].finish_reason == "length"
    assert eng.scheduler.stats.aborted == 1


def test_async_codecs_equal_their_sync_twins(weights):
    api = OpenAIServer(engine(weights), "toy")
    chat = {"messages": [{"role": "user", "content": "twins"}],
            "max_tokens": 5}
    comp = {"prompt": ["one", "two"], "max_tokens": 4}
    try:
        def strip(out):
            return [(c.get("message") or c.get("text"), c["finish_reason"])
                    for c in out["choices"]], out["usage"]

        async def drive():
            a = await api.chat_completion_async(chat)
            b = await api.completion_async(comp)
            sc = [c async for c in api.chat_completion_stream_async(
                dict(chat, stream=True))]
            sp = [c async for c in api.completion_stream_async(
                dict(comp, stream=True))]
            return a, b, sc, sp

        a, b, sc, sp = asyncio.run(drive())
        assert strip(a) == strip(api.chat_completion(chat))
        assert strip(b) == strip(api.completion(comp))

        def deltas(chunks):
            return [(c["choices"][0].get("delta", c["choices"][0].get("text")),
                     c["choices"][0]["finish_reason"]) for c in chunks]

        assert deltas(sc) == deltas(list(api.chat_completion_stream(
            dict(chat, stream=True))))
        assert deltas(sp) == deltas(list(api.completion_stream(
            dict(comp, stream=True))))
    finally:
        api.client.stop()


def test_batch_endpoint_concurrency(weights):
    """``batch`` of 8 bodies: every request runs concurrently (the peak
    batch fills the 4 slots), each answer equals a single call's, and the
    texts equal the JAX server's ``batch``."""
    bodies = [{"messages": [{"role": "user", "content": f"q{i}"}],
               "max_tokens": 4} for i in range(8)]
    eng = engine(weights)
    api = OpenAIServer(eng, "toy")
    jeng = jax_engine(weights)
    japi = JaxOpenAIServer(jeng, "toy")
    try:
        out = api.batch(bodies)
        assert len(out) == 8
        assert all(o["usage"]["completion_tokens"] >= 1 for o in out)
        assert eng.scheduler.stats.peak_batch == 4
        singles = [api.chat_completion(b) for b in bodies]
        assert [o["choices"][0]["message"] for o in out] == \
            [s["choices"][0]["message"] for s in singles]
        assert [o["usage"] for o in out] == [s["usage"] for s in singles]
        jout = japi.batch(bodies)
        assert [o["choices"][0]["message"]["content"] for o in out] == \
            [o["choices"][0]["message"]["content"] for o in jout]
    finally:
        api.client.stop()
        japi.client.stop()
