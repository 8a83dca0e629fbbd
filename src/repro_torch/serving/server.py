"""Minimal stdlib HTTP server exposing the port's OpenAI-compatible API (the
reference package's threaded ``serving/server.py`` transport).

Routes: ``POST /v1/chat/completions`` and ``POST /v1/completions`` (with
``"stream": true`` -> SSE), ``GET /v1/models``, ``GET /stats`` and ``GET
/healthz``.  Every error is the structured OpenAI envelope ``{"error":
{message, type, param, code}}`` with the matching HTTP status.  A client
that disconnects during an SSE stream closes the chunk generator, which
aborts the in-flight request."""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from repro_torch.serving.api import OpenAIError, OpenAIServer


def make_handler(api: OpenAIServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send_json(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_error(self, err: OpenAIError):
            self._send_json(err.to_dict(), err.status)

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
            """Write SSE chunks; a dropped connection closes the generator,
            whose ``finally`` aborts the in-flight request."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.end_headers()
            try:
                for chunk in chunks:
                    self.wfile.write(b"data: " + json.dumps(chunk).encode()
                                     + b"\n\n")
                    self.wfile.flush()
                self.wfile.write(b"data: [DONE]\n\n")
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass  # client went away; generator cleanup aborted the work
            finally:
                chunks.close()

        def do_POST(self):
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
