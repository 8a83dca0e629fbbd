"""Minimal stdlib HTTP server exposing the port's OpenAI-compatible API (the
reference package's threaded ``serving/server.py`` transport).

Routes: ``POST /v1/chat/completions`` and ``POST /v1/completions`` (with
``"stream": true`` -> SSE; the OpenAI ``user`` field or an ``x-tenant``
header selects the admission tenant, an ``x-session`` header the
router's session), ``GET /v1/models``, ``GET /stats``,
``GET /healthz`` (liveness), ``GET /readyz`` (readiness: 503 while
draining, wedged or shedding all traffic) and ``POST /admin/drain``
(graceful drain, body ``{"timeout_s": ...}`` optional; returns 202 at
once).  Every error is the structured OpenAI envelope
``{"error": {message, type, param, code}}`` with the matching HTTP status;
an overload rejection (429/503) also carries a ``Retry-After`` header.  A client
that disconnects during an SSE stream closes the chunk generator, which
aborts the in-flight request."""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.serving.api import OpenAIError, OpenAIServer
from repro_torch.tracing import TRACER


def make_handler(api: OpenAIServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send_json(self, obj, code=200, headers=None):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _send_error(self, err: OpenAIError):
            headers = {}
            if err.retry_after is not None:
                headers["Retry-After"] = str(max(1, int(err.retry_after
                                                        + 0.5)))
            self._send_json(err.to_dict(), err.status, headers)

        def _not_found(self):
            self._send_error(OpenAIError(f"unknown route {self.path}",
                                         code="not_found", status=404))

        def do_GET(self):
            if self.path == "/v1/models":
                self._send_json(api.models())
            elif self.path == "/stats":
                self._send_json(api.stats())
            elif self.path == "/healthz":
                payload, code = api.healthz()
                self._send_json(payload, code)
            elif self.path == "/readyz":
                payload, code = api.readyz()
                self._send_json(payload, code)
            else:
                self._not_found()

        def _read_body(self):
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length) or b"{}"
            try:
                body = json.loads(raw)
            except json.JSONDecodeError as e:
                raise OpenAIError(f"request body is not valid JSON: {e}",
                                  code="invalid_json") from e
            if not isinstance(body, dict):
                raise OpenAIError("request body must be a JSON object")
            return body

        def _stream_sse(self, chunks):
            """Write SSE chunks, each traced as ``http.write`` (n = bytes);
            a dropped connection closes the generator, whose ``finally``
            aborts the in-flight request."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            try:
                for chunk in chunks:
                    with TRACER.span("http.write") as span:
                        data = b"data: " + json.dumps(chunk).encode() + b"\n\n"
                        self.wfile.write(data)
                        self.wfile.flush()
                        span.n = len(data)
                self.wfile.write(b"data: [DONE]\n\n")
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass  # client went away; generator cleanup aborted the work
            finally:
                chunks.close()

        def do_POST(self):
            if self.path == "/admin/drain":
                try:
                    body = self._read_body()
                    timeout = body.get("timeout_s")
                    self._send_json(api.drain(
                        None if timeout is None else float(timeout)), 202)
                except OpenAIError as e:
                    self._send_error(e)
                except (TypeError, ValueError) as e:
                    self._send_error(OpenAIError(str(e), param="timeout_s"))
                return
            routes = {
                "/v1/chat/completions": (api.chat_completion,
                                         api.chat_completion_stream),
                "/v1/completions": (api.completion, api.completion_stream),
            }
            route = routes.get(self.path)
            if route is None:
                self._not_found()
                return
            blocking, streaming = route
            try:
                body = self._read_body()
                # the x-tenant header maps to the OpenAI `user` field (the
                # admission tenant); an explicit body field wins
                tenant = self.headers.get("x-tenant")
                if tenant and "user" not in body:
                    body["user"] = tenant
                # the x-session header maps to the router's `session`
                # affinity key (a conversation pins to one replica)
                session = self.headers.get("x-session")
                if session and "session" not in body:
                    body["session"] = session
                if body.get("stream"):
                    self._stream_sse(streaming(body))
                else:
                    self._send_json(blocking(body))
            except OpenAIError as e:
                self._send_error(e)
            except ValueError as e:
                self._send_error(OpenAIError(str(e)))

    return Handler


class ApiServer:
    def __init__(self, api: OpenAIServer, host: str = "127.0.0.1",
                 port: int = 8177):
        self.api = api
        self._httpd = ThreadingHTTPServer((host, port), make_handler(api))
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop serving and close the listening socket."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
