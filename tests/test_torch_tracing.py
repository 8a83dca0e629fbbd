"""The port's tracer (``repro_torch/tracing.py``) and the counters beside it,
on the CPU: the shared no-op while off (no clock read on any span site),
nesting and request ids while on, the engine's, the HTTP front's and the
train step's spans, the prefix cache's per-lookup counts and the
scheduler's collapsed blocks."""
import http.client
import json
import threading
import time

import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.prefix_cache import TextPrefixCache
from repro_torch.core.request import Request, SamplingParams
from repro_torch.core.scheduler import ContinuousBatchingScheduler
from repro_torch.serving.api import OpenAIServer
from repro_torch.serving.server import ApiServer
from repro_torch.serving.tokenizer import ByteTokenizer
from repro_torch.tracing import TRACER
from repro_torch.training import train_step as tts
from repro_torch.training.data import BigramDataPipeline
from repro_torch.training.optimizer import AdamWConfig
from torch_threads import one_torch_thread  # noqa: F401

TRAIN_SPANS = {"train.step", "train.batch_to", "train.forward",
               "train.backward", "train.optimizer", "train.metrics_sync"}


@pytest.fixture
def traced():
    """The tracer on for the test, off and emptied after it."""
    TRACER.start()
    try:
        yield TRACER
    finally:
        TRACER.stop()
        TRACER.start()
        TRACER.stop()


@pytest.fixture(scope="module")
def engine():
    return InferenceEngine(get_config("qwen3-0.6b-toy"), device="cpu",
                           max_batch=2, cache_len=128, max_decode_block=4)


def _requests(n, max_tokens):
    tok = ByteTokenizer()
    return [Request(prompt_tokens=tok.encode(f"trace me {i} " * 3),
                    sampling=SamplingParams(max_tokens=max_tokens))
            for i in range(n)]


def _train_once():
    cfg = get_config("qwen3-0.6b-toy")
    data = BigramDataPipeline(256, seq_len=16, batch_size=2)
    state = tts.init_train_state(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    step = tts.make_train_step(cfg, AdamWConfig(), remat=False)
    step(state, data.batch(0))


def _serve_one_stream():
    """One streamed completion through the threaded server, then ``/stats``:
    (the SSE body, the stats)."""
    engine = InferenceEngine(get_config("qwen3-0.6b-toy"), device="cpu",
                             max_batch=2, cache_len=128)
    api = OpenAIServer(engine, "toy")
    srv = ApiServer(api, port=0)
    srv.start()
    try:
        body = json.dumps({"prompt": "stream me", "max_tokens": 5,
                           "stream": True, "logprobs": 1}).encode()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("POST", "/v1/completions", body,
                     {"Content-Type": "application/json"})
        raw = conn.getresponse().read()
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        srv.stop()
        api.client.stop()
    return raw, stats


def _by_name(records, name):
    return [r for r in records if r.name == name]


def test_off_span_is_the_shared_no_op_and_records_nothing():
    assert not TRACER.on
    before = TRACER.records()
    a, b = TRACER.span("x"), TRACER.span("y", rid=3, n=4)
    assert a is b
    with a as sp:
        sp.n = 7
    assert TRACER.records() == before


def test_off_reads_no_clock_on_any_span_site(engine, monkeypatch):
    """A short generate, a served stream and a train step with the tracer
    off: no call reaches the tracer's clocks and nothing is appended."""
    calls = []

    def counting(clock):
        def read():
            calls.append(clock.__name__)
            return clock()
        return read

    for name in ("time_ns", "thread_time_ns", "monotonic_ns"):
        monkeypatch.setattr(tracing, name, counting(getattr(time, name)))
    TRACER.start()
    TRACER.stop()
    calls.clear()
    engine.generate(_requests(2, 6))
    raw, _ = _serve_one_stream()
    _train_once()
    assert raw.endswith(b"data: [DONE]\n\n")
    assert calls == [] and TRACER.records() == []


def test_spans_nest_and_one_request_shares_its_id(traced):
    with traced.span("outer"):
        with traced.span("inner", rid=5, n=3):
            pass
    t0 = time.monotonic()
    traced.record("request.queue", t0 - 0.002, t0, rid=5)
    inner, outer, queue = traced.records()
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.parent == outer.id and outer.parent == -1
    assert inner.thread == outer.thread == threading.get_ident()
    assert (inner.rid, inner.n) == (5, 3) and queue.rid == inner.rid
    assert outer.start <= inner.start <= inner.end <= outer.end
    assert queue.end - queue.start == pytest.approx(2e6, abs=1e3)
    assert queue.parent == -1 and queue.cpu == 0


def test_a_span_lies_between_two_clock_reads(traced):
    a = time.time_ns()
    with traced.span("between"):
        sum(range(1000))
    b = time.time_ns()
    (r,) = traced.records()
    assert a <= r.start <= r.end <= b
    assert 0 <= r.cpu


def test_generate_records_one_decode_dispatch_per_block(engine, traced):
    st = engine.scheduler.stats
    steps, device_steps, tokens = (st.steps, st.device_steps,
                                   st.tokens_generated)
    prompts = st.prompt_tokens
    reqs = _requests(2, 9)
    engine.generate(reqs)
    recs = traced.records()
    steps_by_id = {r.id: r for r in _by_name(recs, "engine.step")}
    dispatch = _by_name(recs, "engine.decode_dispatch")
    assert len(dispatch) == st.steps - steps
    assert sum(r.n for r in dispatch) == st.device_steps - device_steps
    assert max(r.n for r in dispatch) > 1
    for r in dispatch:
        step = steps_by_id[r.parent]
        assert step.start <= r.start <= r.end <= step.end
    assert len(_by_name(recs, "engine.block_sync")) == len(dispatch)
    assert sum(r.n for r in _by_name(recs, "engine.emit")) \
        == st.tokens_generated - tokens
    assert sum(r.n for r in _by_name(recs, "engine.commit")) == len(reqs)
    assert st.prompt_tokens - prompts == sum(len(r.prompt_tokens)
                                            for r in reqs)
    for name in ("request.queue", "request.prefill"):
        assert sorted(r.rid for r in _by_name(recs, name)) \
            == sorted(r.request_id for r in reqs)


def test_stream_spans_land_on_handler_threads(traced):
    raw, stats = _serve_one_stream()
    assert raw.endswith(b"data: [DONE]\n\n")
    recs = traced.records()
    by_id = {r.id: r for r in recs}
    loop = {r.thread for r in _by_name(recs, "engine.step")}
    front = _by_name(recs, "api.encode") + _by_name(recs, "http.write")
    assert len(loop) == 1 and front
    assert all(r.thread not in loop for r in front)
    assert sum(r.n for r in _by_name(recs, "api.encode")) == 5
    assert all(r.n > 0 for r in _by_name(recs, "http.write"))
    for r in recs:
        if r.parent != -1:
            assert by_id[r.parent].thread == r.thread
    for r in recs:
        if r.name.startswith(("engine.", "client.")) and r.parent != -1:
            assert not by_id[r.parent].name.startswith(("api.", "http."))
    assert stats["prompt_tokens"] == len(ByteTokenizer().encode("stream me"))
    assert {"lookups", "lookup_hits", "hit_tokens"} <= set(
        stats["prefix_cache"])


def test_train_step_records_its_six_spans(traced):
    _train_once()
    recs = traced.records()
    assert sorted(r.name for r in recs) == sorted(TRAIN_SPANS)
    (step,) = _by_name(recs, "train.step")
    assert all(r.parent == step.id for r in recs if r is not step)


def test_prefix_cache_counts_one_per_lookup():
    """One hit after a 3-block miss: the LRU counts 3 missed probes and 1
    hit; the lookup counts 1 lookup, 1 hit and the hit's 16 tokens."""
    cache = TextPrefixCache(block_size=16)
    tokens = list(range(64))
    cache.insert(tokens[:16], "value", nbytes=1)
    assert cache.lookup(tokens) == ("value", 16)
    assert (cache.stats.hits, cache.stats.misses) == (1, 3)
    st = cache.lookup_stats
    assert (st.lookups, st.lookup_hits, st.hit_tokens) == (1, 1, 16)
    assert cache.lookup([7] * 40) == (None, 0)
    assert (st.lookups, st.lookup_hits, st.hit_tokens) == (2, 1, 16)


def test_blocks_collapsed_counts_waiting_work_not_short_budgets():
    s = ContinuousBatchingScheduler(max_batch=2)
    s.add(Request(prompt_tokens=[1, 2], sampling=SamplingParams(
        max_tokens=100)))
    s.admit([0])
    assert s.plan_decode_block(8) == 8 and s.stats.blocks_collapsed == 0
    s.add(Request(prompt_tokens=[3], sampling=SamplingParams(max_tokens=1)))
    assert s.plan_decode_block(8) == 1 and s.stats.blocks_collapsed == 1
    s.admit([1])
    assert s.plan_decode_block(8) == 1 and s.stats.blocks_collapsed == 1
    assert s.plan_decode_block(8, reclaim_queued=True) == 1
    assert s.stats.blocks_collapsed == 2
    assert s.snapshot()["blocks_collapsed"] == 2
