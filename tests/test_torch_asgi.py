"""The port's asyncio ASGI transport on the CPU: the tests of
``tests/test_asgi.py`` over the port's engines (``qwen3-0.6b-toy``,
seeded weights) behind its router.

Everything runs on the bundled asyncio HTTP/1.1 server (uvicorn is not a
dependency of the repository; only its gate is ported).  Every
rejection (bad JSON, unknown route, all-replicas-draining) is the OpenAI
``{"error": {...}}`` envelope, and a *streaming* request rejected at submit
time gets that envelope with ``Retry-After`` instead of a connection reset,
because the SSE response only starts after the codec admitted the request.
The disconnect test polls against a deadline; nothing sleeps a fixed
time."""
import http.client
import json
import socket
import threading
import time

import pytest

from repro_torch.configs import get_config
from repro_torch.core.admission import AdmissionController
from repro_torch.core.engine import InferenceEngine
from repro_torch.serving.api import OpenAIServer
from repro_torch.serving.asgi import AsgiServer, build_app, uvicorn_available
from repro_torch.serving.client import EngineClient
from repro_torch.serving.router import Router
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def cfg():
    return get_config("qwen3-0.6b-toy")


def mk_client(cfg, *, admission=True, max_batch=4):
    eng = InferenceEngine(cfg, device="cpu", max_batch=max_batch,
                          cache_len=256, seed=0)
    adm = AdmissionController() if admission else None
    return EngineClient(eng, admission=adm)


class _Stack:
    """A running bundled-transport server over a client or router."""

    def __init__(self, client, model="toy"):
        self.client = client
        self.api = OpenAIServer(client, model)
        self.server = AsgiServer(self.api, port=0, transport="bundled")
        self.server.start()
        self.port = self.server.port

    def close(self):
        self.server.stop()
        self.client.stop()


@pytest.fixture(scope="module")
def stack(cfg):
    """Module-shared 2-replica router behind the ASGI transport (tests
    here only read or add load — drain tests build their own stack)."""
    s = _Stack(Router([mk_client(cfg), mk_client(cfg)]))
    yield s
    s.close()


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        payload = json.dumps(body).encode() if body is not None else None
        conn.request(method, path, body=payload, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        # the bundled server emits lowercase header names (ASGI idiom)
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
        return resp.status, hdrs, data
    finally:
        conn.close()


def _json(port, method, path, body=None, headers=None):
    status, hdrs, data = _request(port, method, path, body, headers)
    return status, hdrs, json.loads(data)


def _sse_events(data: bytes):
    """Parse a complete close-delimited SSE body into its data payloads."""
    events = []
    for block in data.decode().split("\n\n"):
        if block.startswith("data: "):
            events.append(block[len("data: "):])
    return events


def _chat_body(prompt, max_tokens=4, **kw):
    return {"model": "toy", "max_tokens": max_tokens,
            "messages": [{"role": "user", "content": prompt}], **kw}


# --------------------------------------------------------------------- #
# routes
# --------------------------------------------------------------------- #
def test_get_routes(stack):
    status, _, models = _json(stack.port, "GET", "/v1/models")
    assert status == 200
    assert models["data"][0]["id"] == "toy"

    status, _, stats = _json(stack.port, "GET", "/stats")
    assert status == 200
    assert stats["schema_version"] == OpenAIServer.STATS_SCHEMA_VERSION
    assert len(stats["replicas"]) == 2

    status, _, health = _json(stack.port, "GET", "/healthz")
    assert status == 200 and health["status"] == "ok"
    status, _, ready = _json(stack.port, "GET", "/readyz")
    assert status == 200 and ready["ok"]


def test_unknown_route_and_method_are_envelopes(stack):
    status, _, out = _json(stack.port, "GET", "/nope")
    assert status == 404 and out["error"]["code"] == "not_found"
    status, _, out = _json(stack.port, "POST", "/nope", body={})
    assert status == 404 and out["error"]["code"] == "not_found"
    status, _, out = _json(stack.port, "PUT", "/v1/models", body={})
    assert status == 405 and out["error"]["code"] == "method_not_allowed"


def test_bad_json_is_envelope(stack):
    conn = http.client.HTTPConnection("127.0.0.1", stack.port, timeout=30)
    try:
        conn.request("POST", "/v1/chat/completions", body=b"{not json")
        resp = conn.getresponse()
        out = json.loads(resp.read())
        assert resp.status == 400
        assert out["error"]["code"] == "invalid_json"
    finally:
        conn.close()


# --------------------------------------------------------------------- #
# completions
# --------------------------------------------------------------------- #
def test_chat_completion_roundtrip(stack):
    status, _, out = _json(stack.port, "POST", "/v1/chat/completions",
                           body=_chat_body("hello there"))
    assert status == 200
    assert out["object"] == "chat.completion"
    assert out["choices"][0]["finish_reason"] in ("stop", "length")
    assert isinstance(out["choices"][0]["message"]["content"], str)
    assert out["usage"]["completion_tokens"] >= 1


def test_chat_stream_sse(stack):
    status, hdrs, data = _request(stack.port, "POST", "/v1/chat/completions",
                                  body=_chat_body("stream me", stream=True))
    assert status == 200
    assert hdrs.get("content-type") == "text/event-stream"
    events = _sse_events(data)
    assert events[-1] == "[DONE]"
    chunks = [json.loads(e) for e in events[:-1]]
    assert chunks[0]["object"] == "chat.completion.chunk"
    assert chunks[-1]["choices"][0]["finish_reason"] in ("stop", "length")


def test_completion_nonstream_and_stream(stack):
    body = {"model": "toy", "prompt": "complete this", "max_tokens": 4}
    status, _, out = _json(stack.port, "POST", "/v1/completions", body=body)
    assert status == 200 and out["object"] == "text_completion"

    status, _, data = _request(stack.port, "POST", "/v1/completions",
                               body={**body, "stream": True})
    assert status == 200
    events = _sse_events(data)
    assert events[-1] == "[DONE]"
    assert json.loads(events[0])["object"] == "text_completion"


def test_session_header_pins_replica(stack):
    """x-session maps to the router's affinity key: the second request
    with the same header lands on the pinned replica."""
    before = stack.client.router_stats().placements.get("session", 0)
    for _ in range(2):
        status, _, _out = _json(
            stack.port, "POST", "/v1/chat/completions",
            body=_chat_body("sticky chat", max_tokens=2),
            headers={"x-session": "asgi-sess-1"})
        assert status == 200
    assert stack.client.router_stats().placements["session"] >= before + 1
    assert "asgi-sess-1" in stack.client._sessions


def test_tenant_header_maps_to_user(stack):
    status, _, _out = _json(
        stack.port, "POST", "/v1/chat/completions",
        body=_chat_body("tenant traffic", max_tokens=2),
        headers={"x-tenant": "acme"})
    assert status == 200
    _, _, stats = _json(stack.port, "GET", "/stats")
    # the tenant shows up on whichever replica served it — read the
    # typed envelope, not the merged flat mirror
    seen = set()
    for rep in stats["replicas"]:
        seen |= set(rep["admission"]["tenants"])
    assert "acme" in seen


# --------------------------------------------------------------------- #
# the post-drain SSE bugfix
# --------------------------------------------------------------------- #
def test_post_drain_sse_gets_structured_503(cfg):
    """The post-drain bugfix: opening an SSE stream against a fully draining
    router returns the structured 503 ``draining`` envelope with
    Retry-After — never a connection reset.  The ASGI app only starts
    the event-stream response after submit succeeded."""
    s = _Stack(Router([mk_client(cfg), mk_client(cfg)]))
    try:
        for rep in s.client.replicas:
            rep.client._draining = True
        status, hdrs, data = _request(
            s.port, "POST", "/v1/chat/completions",
            body=_chat_body("too late", stream=True))
        assert status == 503
        out = json.loads(data)  # JSON envelope, not an SSE frame
        assert out["error"]["code"] == "draining"
        assert int(hdrs["retry-after"]) >= 1
        assert hdrs.get("content-type") == "application/json"
    finally:
        s.close()


def test_mid_stream_disconnect_aborts_request(cfg):
    """Dropping the socket mid-SSE closes the chunk generator, which
    aborts the in-flight request and reclaims the decode slot."""
    s = _Stack(mk_client(cfg))
    try:
        payload = json.dumps(_chat_body("long one", max_tokens=200,
                                        stream=True)).encode()
        sock = socket.create_connection(("127.0.0.1", s.port), timeout=30)
        req = (b"POST /v1/chat/completions HTTP/1.1\r\n"
               b"host: x\r\ncontent-type: application/json\r\n"
               b"content-length: " + str(len(payload)).encode() + b"\r\n\r\n")
        sock.sendall(req + payload)
        sock.recv(1)  # wait until the stream actually started
        sock.close()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if s.client.stats()["aborted"] >= 1:
                break
            time.sleep(0.01)
        assert s.client.stats()["aborted"] >= 1
        assert s.client.engine.pool.num_free == 4
    finally:
        s.close()


# --------------------------------------------------------------------- #
# concurrency
# --------------------------------------------------------------------- #
def test_many_concurrent_sse_streams(stack):
    """Dozens of concurrent SSE streams over the event loop (the full
    256-stream sustain is benchmarks/router.py's gate)."""
    n, results, errors = 24, [], []

    def worker(i):
        try:
            status, _, data = _request(
                stack.port, "POST", "/v1/chat/completions",
                body=_chat_body(f"concurrent {i}", max_tokens=2, stream=True))
            events = _sse_events(data)
            results.append((status, events[-1]))
        except Exception as e:  # noqa: BLE001 — collected for the assert
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not errors
    assert len(results) == n
    assert all(status == 200 and last == "[DONE]" for status, last in results)


# --------------------------------------------------------------------- #
# the app object itself
# --------------------------------------------------------------------- #
def test_lifespan_protocol(stack):
    """The app speaks the ASGI lifespan protocol (what uvicorn drives)."""
    import asyncio

    app = build_app(stack.api)
    sent = []
    msgs = iter([{"type": "lifespan.startup"}, {"type": "lifespan.shutdown"}])

    async def receive():
        return next(msgs)

    async def send(msg):
        sent.append(msg["type"])

    asyncio.run(app({"type": "lifespan"}, receive, send))
    assert sent == ["lifespan.startup.complete", "lifespan.shutdown.complete"]


def test_uvicorn_transport_is_gated():
    """Requiring uvicorn fails loudly (the port serves the bundled server
    only, and uvicorn is not installed), and an unknown transport is a
    ValueError."""
    assert uvicorn_available() in (True, False)
    with pytest.raises(RuntimeError, match="uvicorn"):
        AsgiServer(api=None, transport="uvicorn")
    with pytest.raises(ValueError, match="transport"):
        AsgiServer(api=None, transport="nope")
