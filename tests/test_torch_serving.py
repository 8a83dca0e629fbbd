"""The port's OpenAI server over HTTP on the CPU: the text-only golden
fixtures of ``tests/golden_openai`` (the image, echo and multimodal-stop
fixtures belong to slices not ported yet), chat, completions, SSE, ``n=2``,
and the launcher."""
import json

import pytest

from repro_torch.configs import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.launch import serve
from repro_torch.serving.api import OpenAIServer
from repro_torch.serving.server import ApiServer
from test_openai_surface import GOLDEN, _request_json, _request_sse, match

TEXT_GOLDEN = [p for p in GOLDEN if not any(
    word in p.stem for word in ("image", "echo", "stop_multimodal"))]


@pytest.fixture(scope="module")
def server():
    engine = InferenceEngine(get_config("qwen3-0.6b-toy"), device="cpu",
                             max_batch=4, cache_len=128)
    api = OpenAIServer(engine, "toy")
    srv = ApiServer(api, port=0)
    srv.start()
    yield srv
    srv.stop()
    api.client.stop()


def _chat(server, content, **extra):
    return _request_json(server, {
        "method": "POST", "path": "/v1/chat/completions",
        "request": {"messages": [{"role": "user", "content": content}],
                    **extra}})


@pytest.mark.parametrize("path", TEXT_GOLDEN, ids=lambda p: p.stem)
def test_golden_fixture(server, path):
    fixture = json.loads(path.read_text())
    if fixture.get("stream"):
        status, chunks = _request_sse(server, fixture)
        assert status == fixture["status"] and chunks
        errs = []
        if "first_chunk" in fixture:
            errs += match(fixture["first_chunk"], chunks[0], "first")
        if "last_chunk" in fixture:
            errs += match(fixture["last_chunk"], chunks[-1], "last")
        for i, chunk in enumerate(chunks if "all_chunks" in fixture else []):
            errs += match(fixture["all_chunks"], chunk, f"chunk[{i}]")
        assert not errs, errs[:8]
    else:
        status, body = _request_json(server, fixture)
        assert status == fixture["status"], body
        errs = match(fixture["response"], body)
        assert not errs, errs[:8]


def test_stream_text_equals_blocking_text_and_usage(server):
    req = {"messages": [{"role": "user", "content": "stream parity"}],
           "max_tokens": 7}
    _, blocking = _request_json(server, {
        "method": "POST", "path": "/v1/chat/completions", "request": req})
    _, chunks = _request_sse(server, {
        "path": "/v1/chat/completions",
        "request": {**req, "stream": True,
                    "stream_options": {"include_usage": True}}})
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks if c["choices"])
    assert text == blocking["choices"][0]["message"]["content"]
    assert chunks[-1]["usage"] == blocking["usage"]
    assert blocking["usage"]["completion_tokens"] == 7


def test_n2_greedy_choices_identical_and_counted(server):
    status, body = _chat(server, "same", max_tokens=4, n=2)
    assert status == 200 and len(body["choices"]) == 2
    assert len({c["message"]["content"] for c in body["choices"]}) == 1
    assert body["usage"]["completion_tokens"] == 8


def test_completion_logprobs_and_prompt_count(server):
    status, body = _request_json(server, {
        "method": "POST", "path": "/v1/completions",
        "request": {"prompt": "count me", "max_tokens": 3, "logprobs": 2}})
    assert status == 200
    usage, lp = body["usage"], body["choices"][0]["logprobs"]
    assert usage["prompt_tokens"] == len("count me") + 1          # + BOS
    assert len(lp["token_logprobs"]) == usage["completion_tokens"] == 3
    assert all(v <= 0.0 for v in lp["token_logprobs"])
    # keyed by decoded text: two ids that decode alike share one key
    assert all(1 <= len(t) <= 2 for t in lp["top_logprobs"])


def test_requests_outside_the_slice_get_the_error_envelope(server):
    status, body = _chat(server, [{"type": "image_url",
                                   "image_url": {"url": "synthetic://x"}}],
                         max_tokens=2)
    assert status == 400 and "text only" in body["error"]["message"]
    status, body = _request_json(server, {
        "method": "POST", "path": "/v1/completions",
        "request": {"prompt": "x", "max_tokens": 2, "echo": True}})
    assert status == 400 and "echo" in body["error"]["message"]


def test_stats_and_health(server):
    _chat(server, "counted", max_tokens=2)
    _, stats = _request_json(server, {"method": "GET", "path": "/stats"})
    assert stats["device"] == "cpu" and stats["retired"] >= 1
    assert stats["tokens_generated"] >= 1 and stats["aborted"] == 0
    for absent in ("prefix_cache", "admission", "speculation", "router"):
        assert absent not in stats
    _, health = _request_json(server, {"method": "GET", "path": "/healthz"})
    assert health["ok"] is True


def test_launcher_serves_on_the_cpu():
    args = serve.parse_args(["--arch", "qwen2-0.5b", "--smoke", "--device",
                             "cpu", "--port", "0", "--cache-len", "64",
                             "--max-batch", "2"])
    srv = serve.build_server(args)
    srv.start()
    try:
        status, body = _chat(srv, "launcher", max_tokens=3)
        assert status == 200 and body["model"] == "qwen2-0.5b-smoke"
        assert body["usage"]["completion_tokens"] == 3
    finally:
        srv.stop()
        srv.api.client.stop()


def test_client_abort_and_engine_failure_finish_every_handle():
    """A handle aborted mid-stream finishes with "abort" and frees its slot;
    an exception escaping engine.step() fails every in-flight handle with
    "error" and the loop keeps serving."""
    from repro_torch.core.request import GenerationRequest, SamplingParams
    from repro_torch.serving.client import EngineClient, FinishEvent

    engine = InferenceEngine(get_config("qwen2-0.5b").reduced(), device="cpu",
                             max_batch=2, cache_len=256, max_decode_block=1)
    with EngineClient(engine) as client:
        handle = client.submit(GenerationRequest(
            "abort me", SamplingParams(max_tokens=200)))
        stream = handle.stream()
        next(stream)
        assert handle.abort(timeout=30)
        assert [e.finish_reason for e in stream
                if isinstance(e, FinishEvent)] == ["abort"]
        assert engine.pool.num_free == 2

        def broken_step():
            raise RuntimeError("injected")

        engine.step = broken_step
        failed = client.submit(GenerationRequest(
            "fail me", SamplingParams(max_tokens=4), n=2))
        result = failed.result(timeout=30)
        assert [c.finish_reason for c in result.choices] == ["error"] * 2
        del engine.step
        ok = client.generate(GenerationRequest(
            "after", SamplingParams(max_tokens=3)))
        assert ok.choices[0].finish_reason == "length"
        assert client.stats()["loop_errors"] == 1
