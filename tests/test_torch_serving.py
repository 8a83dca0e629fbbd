"""The port's OpenAI server over HTTP on the CPU: the golden fixtures of
``tests/golden_openai`` (the ``chat_image_*`` ones against a vision model,
as the reference's suite runs them), chat,
completions, SSE, ``n=2``, ``/stats`` with its ``content_cache`` block, and
the launcher, dense, paged and on a vision model."""
import json

import numpy as np
import pytest

from repro_torch.configs import get_config
from repro_torch.core.engine import InferenceEngine
from repro_torch.launch import serve
from repro_torch.serving import media
from repro_torch.serving.api import OpenAIServer
from repro_torch.serving.server import ApiServer
from test_openai_surface import GOLDEN, _request_json, _request_sse, match
from torch_threads import one_torch_thread  # noqa: F401


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


@pytest.fixture(scope="module")
def vl_server():
    """Vision-model server for the ``chat_image_*`` fixtures (cheap encoder
    work), the fixture's synthetic URL registered in the port's store."""
    engine = InferenceEngine(get_config("qwen3-vl-toy"), device="cpu",
                             max_batch=4, cache_len=256, vision_work_iters=1)
    media.register_url("synthetic://golden-image",
                       (np.arange(8 * 8 * 3) % 251)
                       .reshape(8, 8, 3).astype(np.uint8))
    api = OpenAIServer(engine, "toy-vl")
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


@pytest.mark.parametrize("path", GOLDEN, ids=lambda p: p.stem)
def test_golden_fixture(request, path):
    server = request.getfixturevalue(
        "vl_server" if path.stem.startswith("chat_image") else "server")
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
    """An image sent to a text-only model is ignored, as the reference
    answers it: 200, and the text of the same chat without the image.
    ``echo`` returns the prompt ahead of the text; with ``stream`` it gets
    the 400 envelope."""
    status, body = _chat(server, [{"type": "image_url",
                                   "image_url": {"url": "synthetic://x"}}],
                         max_tokens=2)
    _, text_only = _chat(server, [], max_tokens=2)
    assert status == 200
    assert body["choices"][0]["message"] == \
        text_only["choices"][0]["message"]
    assert body["usage"] == text_only["usage"]
    status, body = _request_json(server, {
        "method": "POST", "path": "/v1/completions",
        "request": {"prompt": "x", "max_tokens": 2, "echo": True}})
    assert status == 200 and body["choices"][0]["text"].startswith("x")
    status, body = _request_json(server, {
        "method": "POST", "path": "/v1/completions",
        "request": {"prompt": "x", "max_tokens": 2, "echo": True,
                    "stream": True}})
    assert status == 400 and "echo" in body["error"]["message"]


def test_stats_and_health(server):
    _chat(server, "counted", max_tokens=2)
    _, stats = _request_json(server, {"method": "GET", "path": "/stats"})
    assert stats["device"] == "cpu" and stats["retired"] >= 1
    assert stats["tokens_generated"] >= 1 and stats["aborted"] == 0
    assert set(stats["prefix_cache"]) == {"entries", "hits", "misses",
                                          "lookups", "lookup_hits",
                                          "hit_tokens"}
    assert stats["content_cache"]["encoder_invocations"] == 0
    for absent in ("kv_pages", "admission"):
        assert absent not in stats
    assert stats["schema_version"] == 2 and stats["router"] is None
    assert [r["name"] for r in stats["replicas"]] == ["replica-0"]
    assert stats["speculation"]["mode"] == "off"
    assert stats["speculation"]["rounds"] == 0
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


def test_launcher_serves_the_moe_model_on_the_cpu():
    """``--arch deepseek-moe-16b --smoke``: the reduced MoE model (a dense
    first layer, then MoE) answers through the launcher."""
    args = serve.parse_args(["--arch", "deepseek-moe-16b", "--smoke",
                             "--device", "cpu", "--port", "0",
                             "--cache-len", "64", "--max-batch", "2"])
    srv = serve.build_server(args)
    srv.start()
    try:
        assert srv.api.engine.cfg.layer_kinds() == ("attn", "moe")
        status, body = _chat(srv, "route me", max_tokens=3)
        assert status == 200 and body["model"] == "deepseek-moe-16b-smoke"
        assert body["usage"]["completion_tokens"] == 3
    finally:
        srv.stop()
        srv.api.client.stop()


def test_launcher_serves_paged_on_the_cpu():
    """``--kv-layout paged``: a request is served and ``/stats`` carries the
    ``kv_pages`` block; the same prompt again hits the prefix cache and
    maps its pages copy-on-write."""
    args = serve.parse_args(["--arch", "qwen2-0.5b", "--smoke", "--device",
                             "cpu", "--port", "0", "--cache-len", "64",
                             "--max-batch", "2", "--kv-layout", "paged"])
    srv = serve.build_server(args)
    srv.start()
    try:
        prompt = "a paged prompt long enough for two pages"
        for _ in range(2):
            status, body = _chat(srv, prompt, max_tokens=3)
            assert status == 200 and body["usage"]["completion_tokens"] == 3
        _, stats = _request_json(srv, {"method": "GET", "path": "/stats"})
        pages = stats["kv_pages"]
        assert pages["page_size"] == 16 and pages["kv_dtype"] == "fp"
        assert pages["total"] == 2 * 4 and pages["pinned"] == 0
        assert pages["shares"] > 0 and pages["full_copies"] == 0
        assert stats["prefix_cache"]["hits"] >= 1
    finally:
        srv.stop()
        srv.api.client.stop()
    no_cache = serve.parse_args(["--no-prefix-cache", "--kv-dtype", "int8",
                                 "--kv-layout", "paged"])
    assert no_cache.no_prefix_cache and no_cache.kv_dtype == "int8"


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


def test_image_requests_hit_the_content_cache_over_http(vl_server):
    """The same image twice over HTTP (as a data URL, then as a registered
    URL of the same pixels): one encoder invocation, an embedding hit and a
    cross-KV hit, and identical greedy text."""
    pixels = np.full((12, 12, 3), 7, np.uint8)
    media.register_url("synthetic://same-pixels", pixels)
    b64 = media.encode_b64(pixels)["base64"]
    texts = []
    _, before = _request_json(vl_server, {"method": "GET", "path": "/stats"})
    for url in ("data:application/octet-stream;base64," + b64,
                "synthetic://same-pixels"):
        status, body = _chat(vl_server, [
            {"type": "text", "text": "what is it"},
            {"type": "image_url", "image_url": {"url": url}}], max_tokens=4)
        assert status == 200, body
        texts.append(body["choices"][0]["message"]["content"])
    _, after = _request_json(vl_server, {"method": "GET", "path": "/stats"})
    delta = {k: after["content_cache"][k] - before["content_cache"][k]
             for k in ("encoder_invocations", "embed_hits", "xkv_hits")}
    assert delta == {"encoder_invocations": 1, "embed_hits": 1,
                     "xkv_hits": 1}
    assert texts[0] == texts[1]


def test_launcher_serves_a_vision_model_on_the_cpu():
    """``--arch qwen3-vl-toy``: an image request is served; with
    ``--no-vision-kv-cache`` the repeat hits the embedding cache only."""
    args = serve.parse_args(["--arch", "qwen3-vl-toy", "--device", "cpu",
                             "--port", "0", "--cache-len", "128",
                             "--max-batch", "2", "--vision-work-iters", "1",
                             "--no-vision-kv-cache"])
    srv = serve.build_server(args)
    srv.start()
    try:
        b64 = media.encode_b64(np.zeros((8, 8, 3), np.uint8))["base64"]
        part = {"type": "image_url", "image_url": {
            "url": "data:application/octet-stream;base64," + b64}}
        for _ in range(2):
            status, body = _chat(srv, [part], max_tokens=3)
            assert status == 200 and body["model"] == "qwen3-vl-toy"
        _, stats = _request_json(srv, {"method": "GET", "path": "/stats"})
        cc = stats["content_cache"]
        assert cc["encoder_invocations"] == 1 and cc["embed_hits"] == 1
        assert cc["xkv_hits"] == 0 and cc["xkv_misses"] == 2
    finally:
        srv.stop()
        srv.api.client.stop()
    off = serve.parse_args(["--no-content-cache", "--no-vision-embed-cache",
                            "--content-cache-mb", "64"])
    assert off.no_content_cache and off.no_vision_embed_cache
    assert off.content_cache_mb == 64 and off.vision_work_iters == 8
