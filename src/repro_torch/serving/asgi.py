"""Asyncio-native ASGI transport for the port's OpenAI-compatible API (the
reference package's ``serving/asgi.py``).

``build_app(api)`` returns a standard ASGI-3 application over
:class:`~repro_torch.serving.api.OpenAIServer`'s *async* codec methods — every
in-flight request parks on the engine-thread waker instead of a worker
thread, so one event loop holds hundreds of concurrent SSE streams where
the threaded ``http.server`` transport (serving/server.py) pays a thread
per connection.  The app is uvicorn-compatible, but uvicorn is not
installed (the repository adds no dependencies): :class:`AsgiServer` runs
it on a bundled minimal HTTP/1.1 server on ``asyncio.start_server``.

Routes match the threaded transport exactly: ``POST /v1/chat/completions``
and ``POST /v1/completions`` (``"stream": true`` → SSE), ``GET
/v1/models`` / ``/stats`` / ``/healthz`` / ``/readyz``, ``POST
/admin/drain``.  The ``x-tenant`` header maps to the OpenAI ``user``
field (admission tenant) and ``x-session`` to the router's ``session``
affinity key; explicit body fields win.

Failure envelopes are identical too: every rejection — including the
router's all-replicas-draining 503 — is raised by the codec *before* the
response starts, so a post-drain SSE open receives the structured
``{"error": {...}}`` body with ``Retry-After``, never a connection
reset.  A client that disconnects mid-stream is noticed eagerly — the
stream races the transport's ``http.disconnect`` message — which closes
the chunk generator and aborts the in-flight request (same cancellation
contract as the threaded transport, but without waiting for a write to
fail).

The bundled server is deliberately small: one request per connection
(``Connection: close``), close-delimited SSE bodies, no keep-alive — the
concurrency win comes from the event loop, not connection reuse.
"""
from __future__ import annotations

import asyncio
import json
import logging
import threading
from http.client import responses as _http_reasons
from typing import Any, Awaitable, Callable, Dict, Optional

from repro_torch.serving.api import OpenAIError, OpenAIServer

log = logging.getLogger("repro_torch.asgi")

Scope = Dict[str, Any]
Receive = Callable[[], Awaitable[Dict[str, Any]]]
Send = Callable[[Dict[str, Any]], Awaitable[None]]


def uvicorn_available() -> bool:
    try:
        import uvicorn  # noqa: F401
        return True
    except ImportError:
        return False


# --------------------------------------------------------------------- #
# the ASGI application
# --------------------------------------------------------------------- #
def build_app(api: OpenAIServer) -> Callable[[Scope, Receive, Send], Awaitable[None]]:
    """ASGI-3 app over the codec's async methods."""

    async def _read_json_body(receive: Receive) -> Dict[str, Any]:
        chunks = []
        while True:
            msg = await receive()
            if msg["type"] == "http.disconnect":
                raise ConnectionResetError("client disconnected")
            chunks.append(msg.get("body", b""))
            if not msg.get("more_body"):
                break
        raw = b"".join(chunks) or b"{}"
        try:
            body = json.loads(raw)
        except json.JSONDecodeError as e:
            raise OpenAIError(
                f"request body is not valid JSON: {e}", code="invalid_json"
            ) from e
        if not isinstance(body, dict):
            raise OpenAIError("request body must be a JSON object")
        return body

    async def _send_json(send: Send, obj: Any, status: int = 200,
                         extra_headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(obj).encode()
        headers = [(b"content-type", b"application/json"),
                   (b"content-length", str(len(body)).encode())]
        for k, v in (extra_headers or {}).items():
            headers.append((k.encode(), v.encode()))
        await send({"type": "http.response.start", "status": status,
                    "headers": headers})
        await send({"type": "http.response.body", "body": body})

    async def _send_error(send: Send, err: OpenAIError) -> None:
        extra = {}
        if err.retry_after is not None:
            extra["retry-after"] = str(max(1, int(err.retry_after + 0.5)))
        await _send_json(send, err.to_dict(), err.status, extra)

    async def _wait_disconnect(receive: Receive) -> None:
        while True:
            msg = await receive()
            if msg["type"] == "http.disconnect":
                return

    async def _send_sse(send: Send, agen, receive: Receive) -> None:
        """Stream chunk dicts as SSE.  The response only starts here —
        submit-time rejections (overload, draining, bad request) were
        already raised and became JSON envelopes.  Cancellation is
        *eager*: the stream races the transport's ``http.disconnect``
        message, so a client that drops mid-stream aborts the engine
        request within one event-loop tick — a small decode burst fits
        entirely in the socket buffer, so waiting for a failed write
        (the threaded transport's contract) can miss the disconnect."""
        await send({"type": "http.response.start", "status": 200,
                    "headers": [(b"content-type", b"text/event-stream"),
                                (b"cache-control", b"no-cache")]})
        disc = asyncio.ensure_future(_wait_disconnect(receive))
        try:
            it = agen.__aiter__()
            while True:
                nxt = asyncio.ensure_future(it.__anext__())
                done, _ = await asyncio.wait(
                    {nxt, disc}, return_when=asyncio.FIRST_COMPLETED)
                if disc in done and nxt not in done:
                    nxt.cancel()
                    try:
                        await nxt
                    except (asyncio.CancelledError, StopAsyncIteration):
                        pass
                    return  # finally: aclose() aborts the engine request
                try:
                    chunk = nxt.result()
                except StopAsyncIteration:
                    break
                await send({"type": "http.response.body",
                            "body": b"data: " + json.dumps(chunk).encode() + b"\n\n",
                            "more_body": True})
            await send({"type": "http.response.body",
                        "body": b"data: [DONE]\n\n", "more_body": False})
        finally:
            disc.cancel()
            try:
                await disc
            except (asyncio.CancelledError, Exception):  # noqa: B014,BLE001
                pass
            await agen.aclose()

    async def app(scope: Scope, receive: Receive, send: Send) -> None:
        if scope["type"] == "lifespan":
            while True:
                msg = await receive()
                if msg["type"] == "lifespan.startup":
                    await send({"type": "lifespan.startup.complete"})
                elif msg["type"] == "lifespan.shutdown":
                    await send({"type": "lifespan.shutdown.complete"})
                    return
            return
        if scope["type"] != "http":
            return
        method = scope["method"].upper()
        path = scope["path"]
        headers = {k.decode("latin-1").lower(): v.decode("latin-1")
                   for k, v in scope.get("headers", [])}
        try:
            if method == "GET":
                if path == "/v1/models":
                    await _send_json(send, api.models())
                elif path == "/stats":
                    await _send_json(send, api.stats())
                elif path == "/healthz":
                    payload, code = api.healthz()
                    await _send_json(send, payload, code)
                elif path == "/readyz":
                    payload, code = api.readyz()
                    await _send_json(send, payload, code)
                else:
                    raise OpenAIError(f"unknown route {path}",
                                      code="not_found", status=404)
                return
            if method != "POST":
                raise OpenAIError(f"method {method} not allowed",
                                  code="method_not_allowed", status=405)
            body = await _read_json_body(receive)
            if path == "/admin/drain":
                timeout = body.get("timeout_s")
                try:
                    timeout = None if timeout is None else float(timeout)
                except (TypeError, ValueError) as e:
                    raise OpenAIError(str(e), param="timeout_s") from e
                await _send_json(send, api.drain(timeout), 202)
                return
            routes = {
                "/v1/chat/completions": (api.chat_completion_async,
                                         api.chat_completion_stream_async),
                "/v1/completions": (api.completion_async,
                                    api.completion_stream_async),
            }
            route = routes.get(path)
            if route is None:
                raise OpenAIError(f"unknown route {path}",
                                  code="not_found", status=404)
            blocking, streaming = route
            tenant = headers.get("x-tenant")
            if tenant and "user" not in body:
                body["user"] = tenant
            session = headers.get("x-session")
            if session and "session" not in body:
                body["session"] = session
            if body.get("stream"):
                await _send_sse(send, streaming(body), receive)
            else:
                await _send_json(send, await blocking(body))
        except OpenAIError as e:
            await _send_error(send, e)
        except ValueError as e:
            # engine rejection that escaped the codec: still an envelope
            await _send_error(send, OpenAIError(str(e)))
        except (ConnectionResetError, BrokenPipeError):
            pass  # client went away; generator cleanup aborted the work

    return app


# --------------------------------------------------------------------- #
# bundled asyncio HTTP/1.1 server (no-dependency uvicorn stand-in)
# --------------------------------------------------------------------- #
_MAX_HEAD = 64 * 1024
_MAX_BODY = 32 * 1024 * 1024


async def _handle_connection(app, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter) -> None:
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except (asyncio.IncompleteReadError, asyncio.LimitOverrunError,
            ConnectionError):
        writer.close()
        return
    try:
        lines = head.decode("latin-1").split("\r\n")
        method, target, _version = lines[0].split(" ", 2)
        headers = []
        for line in lines[1:]:
            if not line:
                continue
            name, _, value = line.partition(":")
            headers.append((name.strip().lower().encode("latin-1"),
                            value.strip().encode("latin-1")))
        hmap = {k: v for k, v in headers}
        clen = int(hmap.get(b"content-length", b"0"))
        if clen > _MAX_BODY:
            writer.write(b"HTTP/1.1 413 Payload Too Large\r\n"
                         b"connection: close\r\n\r\n")
            await writer.drain()
            writer.close()
            return
        body = await reader.readexactly(clen) if clen else b""
    except (ValueError, asyncio.IncompleteReadError, ConnectionError):
        writer.close()
        return

    path, _, query = target.partition("?")
    scope: Scope = {
        "type": "http", "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1", "method": method.upper(), "scheme": "http",
        "path": path, "raw_path": target.encode("latin-1"),
        "query_string": query.encode("latin-1"), "headers": headers,
        "client": writer.get_extra_info("peername"),
        "server": writer.get_extra_info("sockname"),
    }

    delivered = {"body": False}

    async def receive() -> Dict[str, Any]:
        if not delivered["body"]:
            delivered["body"] = True
            return {"type": "http.request", "body": body, "more_body": False}
        # after the body the only further message is the disconnect; wait
        # for EOF so apps that poll for it see the client leave
        try:
            await reader.read()
        except ConnectionError:
            pass
        return {"type": "http.disconnect"}

    started = {"done": False}

    async def send(msg: Dict[str, Any]) -> None:
        if msg["type"] == "http.response.start":
            status = msg["status"]
            reason = _http_reasons.get(status, "")
            out = [f"HTTP/1.1 {status} {reason}".encode("latin-1")]
            for k, v in msg.get("headers", []):
                # the app's lowercase names, written in their usual case
                out.append(bytes(k).title() + b": " + bytes(v))
            # one response per connection: the body is close-delimited,
            # which is also what makes unbounded SSE correct here
            out.append(b"connection: close")
            writer.write(b"\r\n".join(out) + b"\r\n\r\n")
            started["done"] = True
        elif msg["type"] == "http.response.body":
            writer.write(msg.get("body", b""))
            await writer.drain()

    try:
        await app(scope, receive, send)
        if not started["done"]:
            writer.write(b"HTTP/1.1 500 Internal Server Error\r\n"
                         b"connection: close\r\ncontent-length: 0\r\n\r\n")
    except (ConnectionResetError, BrokenPipeError, ConnectionError):
        pass
    except Exception:  # noqa: BLE001 — transport must outlive app bugs
        log.exception("ASGI app raised")
        if not started["done"]:
            try:
                writer.write(b"HTTP/1.1 500 Internal Server Error\r\n"
                             b"connection: close\r\ncontent-length: 0\r\n\r\n")
            except ConnectionError:
                pass
    finally:
        try:
            if writer.can_write_eof():
                writer.write_eof()
        except (OSError, RuntimeError):
            pass
        writer.close()


class AsgiServer:
    """Threaded lifecycle wrapper: serve an :class:`OpenAIServer` over the
    ASGI app on a dedicated event-loop thread, with the bundled asyncio
    server.  Of the reference's uvicorn transport only its gate is ported:
    ``transport="uvicorn"`` raises (uvicorn is not a dependency of the
    repository), and ``"auto"`` is the bundled server."""

    def __init__(self, api: OpenAIServer, host: str = "127.0.0.1",
                 port: int = 0, transport: str = "auto"):
        if transport not in ("auto", "uvicorn", "bundled"):
            raise ValueError(f"unknown transport {transport!r}")
        if transport == "uvicorn":
            raise RuntimeError(
                "transport='uvicorn' is not served by the port"
                + ("" if uvicorn_available() else " and uvicorn is not "
                   "installed") + "; use 'auto' or 'bundled'")
        self.api = api
        self.app = build_app(api)
        self.host = host
        self._port_req = port
        self.port: Optional[int] = None
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._stop_ev: Optional[asyncio.Event] = None
        self._started = threading.Event()

    # -- lifecycle ------------------------------------------------------ #
    def start(self) -> None:
        self._thread = threading.Thread(
            target=lambda: asyncio.run(self._serve_bundled()), daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError("ASGI server failed to start within 30s")

    async def _serve_bundled(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop_ev = asyncio.Event()
        server = await asyncio.start_server(
            lambda r, w: _handle_connection(self.app, r, w),
            self.host, self._port_req, limit=_MAX_HEAD)
        self.port = server.sockets[0].getsockname()[1]
        self._started.set()
        async with server:
            await self._stop_ev.wait()

    def stop(self) -> None:
        if self._loop is not None and self._stop_ev is not None:
            try:
                self._loop.call_soon_threadsafe(self._stop_ev.set)
            except RuntimeError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)
