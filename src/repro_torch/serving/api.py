"""OpenAI-compatible API surface of the port: chat completions, legacy
completions and model listing, as a pure *codec* over
:class:`repro_torch.serving.client.EngineClient` (the port of the reference
package's ``serving/api.py``).

Request bodies decode to :class:`~repro_torch.core.request.GenerationRequest`,
handle events encode to response / SSE chunk dicts, and every rejection
raises :class:`OpenAIError` with the structured ``{"error": {message, type,
param, code}}`` envelope and an HTTP status.  Streaming generators abort
their handle on early close (a dropped SSE connection cancels the request).

Not ported in this slice: admission control (429/503 shedding), drain and
readiness, the router, and ``echo`` (rejected by the engine with a 400);
``/stats`` carries no block for those subsystems.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
import uuid
from typing import Any, Dict, Iterator, List, Tuple, Union

import torch

from repro_torch.core.engine import InferenceEngine
from repro_torch.core.paged_kv import PagedKVPool
from repro_torch.core.request import (GenerationRequest, PromptTooLongError,
                                      SamplingParams)
from repro_torch.core.sampling import (SamplingParamError,
                                       validate_sampling_params)
from repro_torch.serving.client import (EngineClient, FinishEvent,
                                        RequestHandle, TokenEvent)

#: OpenAI caps `stop` at 4 sequences; mirrored so error behaviour matches
MAX_STOP_SEQUENCES = 4
MAX_N = 16


class OpenAIError(Exception):
    """Structured OpenAI-style API error: ``{"error": {...}}`` + status."""

    def __init__(self, message: str, *, etype: str = "invalid_request_error",
                 param: Union[str, None] = None, code: Union[str, None] = None,
                 status: int = 400):
        super().__init__(message)
        self.message = message
        self.etype = etype
        self.param = param
        self.code = code
        self.status = status

    def to_dict(self) -> Dict[str, Any]:
        return {"error": {"message": self.message, "type": self.etype,
                          "param": self.param, "code": self.code}}


def _as_int(body: Dict[str, Any], key: str, default: int) -> int:
    val = body.get(key, default)
    if isinstance(val, bool) or not isinstance(val, (int, float)) or int(val) != val:
        raise OpenAIError(f"'{key}' must be an integer", param=key)
    return int(val)


def _as_float(body: Dict[str, Any], key: str, default: float) -> float:
    val = body.get(key, default)
    if isinstance(val, bool) or not isinstance(val, (int, float)):
        raise OpenAIError(f"'{key}' must be a number", param=key)
    return float(val)


def _opt_int(body: Dict[str, Any], key: str):
    return None if body.get(key) is None else _as_int(body, key, 0)


def _opt_float(body: Dict[str, Any], key: str):
    return None if body.get(key) is None else _as_float(body, key, 0.0)


def _parse_stop(body: Dict[str, Any]) -> Tuple[str, ...]:
    stop = body.get("stop")
    if stop is None:
        return ()
    if isinstance(stop, str):
        stops: Tuple[str, ...] = (stop,)
    elif isinstance(stop, list) and all(isinstance(s, str) for s in stop):
        stops = tuple(stop)
    else:
        raise OpenAIError("'stop' must be a string or a list of strings", param="stop")
    if len(stops) > MAX_STOP_SEQUENCES:
        raise OpenAIError(f"'stop' supports at most {MAX_STOP_SEQUENCES} sequences",
                          param="stop")
    if any(not s for s in stops):
        raise OpenAIError("'stop' sequences must be non-empty", param="stop")
    return stops


def _parse_content(content: Any, param: str = "content") -> Dict[str, Any]:
    """OpenAI message content: plain string or a list of typed parts.
    ``None``/missing content and malformed parts raise :class:`OpenAIError`
    (never ``KeyError`` through the handler); an ``image_url`` part becomes
    a media payload (a ``data:`` URL's base64 body, else the URL)."""
    text_parts: List[str] = []
    images: List[Any] = []
    if content is None:
        raise OpenAIError(f"'{param}' is required", param=param)
    if isinstance(content, str):
        return {"text": content, "images": images}
    if not isinstance(content, list):
        raise OpenAIError(f"'{param}' must be a string or a list of content parts",
                          param=param)
    for i, part in enumerate(content):
        where = f"{param}[{i}]"
        if not isinstance(part, dict) or not isinstance(part.get("type"), str):
            raise OpenAIError(f"'{where}' must be an object with a string 'type'",
                              param=where)
        kind = part["type"]
        if kind == "text":
            if not isinstance(part.get("text"), str):
                raise OpenAIError(f"'{where}.text' must be a string", param=where)
            text_parts.append(part["text"])
        elif kind == "image_url":
            image_url = part.get("image_url")
            if not isinstance(image_url, dict) or not isinstance(image_url.get("url"), str):
                raise OpenAIError(
                    f"'{where}.image_url' must be an object with a string 'url'",
                    param=where)
            url = image_url["url"]
            if url.startswith("data:"):               # data:...;base64,XXX
                if "," not in url:
                    raise OpenAIError(
                        f"'{where}.image_url.url' is a malformed data: URL",
                        param=where)
                images.append({"base64": url.split(",", 1)[1]})
            else:
                images.append({"url": url})
        else:
            raise OpenAIError(f"unknown content part type {kind!r} in '{where}'",
                              param=where)
    return {"text": "".join(text_parts), "images": images}


def device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


class OpenAIServer:
    """OpenAI codec over the :class:`EngineClient` lifecycle API."""

    def __init__(self, client: Union[EngineClient, InferenceEngine],
                 model_name: str = "repro"):
        # a bare engine gets its own client: the codec never drives
        # engine.step() itself
        if isinstance(client, InferenceEngine):
            client = EngineClient(client)
        self.client = client
        self.engine = client.engine
        self.model_name = model_name
        # determinism echo: a seeded request replays identically while this
        # fingerprint is unchanged (model identity, weight seed, decode
        # shape, sampler fallbacks, torch build and device)
        eng = self.engine
        ident = ":".join(str(x) for x in (
            model_name, eng.cfg.name, eng.seed, eng.scheduler.max_batch,
            eng.pool.cache_len, eng.top_p, eng.top_k, eng.min_p,
            torch.__version__, device_name(eng.device)))
        self.system_fingerprint = "fp_" + hashlib.sha256(ident.encode()).hexdigest()[:10]

    # ------------------------------------------------------------------ #
    # request decoding
    # ------------------------------------------------------------------ #
    def _decode_common(self, body: Dict[str, Any], prompt: Union[str, List[int]],
                       images=None, echo: bool = False) -> GenerationRequest:
        logprobs = body.get("logprobs", False)
        top_logprobs = _as_int(body, "top_logprobs", 0)
        if not isinstance(logprobs, bool):
            raise OpenAIError("'logprobs' must be a boolean", param="logprobs")
        if top_logprobs and not logprobs:
            raise OpenAIError("'top_logprobs' requires 'logprobs' to be true",
                              param="top_logprobs")
        if top_logprobs < 0:
            raise OpenAIError("'top_logprobs' must be >= 0", param="top_logprobs")
        n = _as_int(body, "n", 1)
        if not 1 <= n <= MAX_N:
            raise OpenAIError(f"'n' must be between 1 and {MAX_N}", param="n")
        top_p, top_k = _opt_float(body, "top_p"), _opt_int(body, "top_k")
        min_p, seed = _opt_float(body, "min_p"), _opt_int(body, "seed")
        try:
            validate_sampling_params(top_p, top_k, min_p, seed)
        except SamplingParamError as e:
            raise OpenAIError(str(e), param=e.param) from e
        sampling = SamplingParams(
            temperature=_as_float(body, "temperature", 0.0),
            top_p=top_p, top_k=top_k, min_p=min_p,
            max_tokens=_as_int(body, "max_tokens", 64),
            stop_sequences=_parse_stop(body),
            logprobs=logprobs, top_logprobs=top_logprobs,
            echo=echo, seed=seed)
        if sampling.max_tokens < 1:
            raise OpenAIError("'max_tokens' must be >= 1", param="max_tokens")
        priority = _as_int(body, "priority", 0)
        deadline_ms = body.get("deadline_ms")
        if deadline_ms is not None:
            deadline_ms = _as_float(body, "deadline_ms", 0.0)
        return GenerationRequest(prompt=prompt, sampling=sampling, n=n,
                                 images=list(images or []), priority=priority,
                                 deadline_ms=deadline_ms)

    def _decode_chat(self, body: Dict[str, Any]) -> GenerationRequest:
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise OpenAIError("'messages' must be a non-empty list", param="messages")
        parts: List[str] = []
        images: List[Any] = []
        for i, msg in enumerate(messages):
            where = f"messages[{i}]"
            if not isinstance(msg, dict) or not isinstance(msg.get("role"), str):
                raise OpenAIError(f"'{where}' must be an object with a string 'role'",
                                  param=where)
            parsed = _parse_content(msg.get("content"), param=f"{where}.content")
            parts.append(f"<|{msg['role']}|>{parsed['text']}")
            images.extend(parsed["images"])
        return self._decode_common(body, "".join(parts) + "<|assistant|>", images)

    def _decode_completion(self, body: Dict[str, Any],
                           stream: bool = False) -> List[GenerationRequest]:
        if body.get("suffix"):
            raise OpenAIError("'suffix' is not supported", param="suffix",
                              code="unsupported_parameter")
        echo = body.get("echo", False)
        if not isinstance(echo, bool):
            raise OpenAIError("'echo' must be a boolean", param="echo")
        if echo and stream:
            raise OpenAIError("'echo' is not supported with 'stream'", param="echo",
                              code="unsupported_parameter")
        prompt = body.get("prompt")
        if isinstance(prompt, str):
            prompts: List[Union[str, List[int]]] = [prompt]
        elif isinstance(prompt, list) and prompt and all(isinstance(p, str) for p in prompt):
            prompts = list(prompt)
        elif isinstance(prompt, list) and prompt and all(
                isinstance(t, int) and not isinstance(t, bool) for t in prompt):
            prompts = [list(prompt)]
        else:
            raise OpenAIError(
                "'prompt' must be a string, a list of strings, or a list of token ids",
                param="prompt")
        # legacy integer `logprobs`: top-k count, chosen logprob included
        lp = body.get("logprobs")
        body = dict(body)
        if lp is not None:
            if isinstance(lp, bool) or not isinstance(lp, int) or lp < 0:
                raise OpenAIError("'logprobs' must be a non-negative integer",
                                  param="logprobs")
            body["logprobs"], body["top_logprobs"] = True, lp
        else:
            body["logprobs"], body["top_logprobs"] = False, 0
        body.setdefault("max_tokens", 16)
        return [self._decode_common(body, p, echo=echo) for p in prompts]

    def _submit(self, greq: GenerationRequest) -> RequestHandle:
        try:
            return self.client.submit(greq)
        except PromptTooLongError as e:
            raise OpenAIError(str(e), code="context_length_exceeded") from e
        except ValueError as e:
            raise OpenAIError(str(e)) from e
        except RuntimeError as e:
            raise OpenAIError("server is shutting down", etype="overloaded_error",
                              code="shutting_down", status=503) from e

    def _submit_all(self, greqs: List[GenerationRequest]) -> List[RequestHandle]:
        """Submit a multi-prompt fan-out; if a later prompt is rejected the
        already-running handles are aborted instead of leaking slots."""
        handles: List[RequestHandle] = []
        try:
            for g in greqs:
                handles.append(self._submit(g))
        except OpenAIError:
            for h in handles:
                h.abort(wait=False)
            raise
        return handles

    # ------------------------------------------------------------------ #
    # response encoding
    # ------------------------------------------------------------------ #
    def _token_repr(self, token: int) -> Dict[str, Any]:
        tok = self.engine.tokenizer
        return {"token": tok.decode([token]), "bytes": list(tok.token_bytes(token))}

    def _chat_logprobs(self, tokens: List[int], logprobs) -> Dict[str, Any]:
        content = []
        for token, (lp, top) in zip(tokens, logprobs):
            entry = self._token_repr(token)
            entry["logprob"] = lp
            entry["top_logprobs"] = [{**self._token_repr(t), "logprob": t_lp}
                                     for t, t_lp in top]
            content.append(entry)
        return {"content": content}

    def _completion_logprobs(self, tokens: List[int], logprobs) -> Dict[str, Any]:
        """Legacy completions logprobs block (offsets into the returned
        text)."""
        tok = self.engine.tokenizer
        out: Dict[str, List[Any]] = {"tokens": [], "token_logprobs": [],
                                     "top_logprobs": [], "text_offset": []}
        offset = 0
        for token, (lp, top) in zip(tokens, logprobs):
            text = tok.decode([token])
            out["tokens"].append(text)
            out["token_logprobs"].append(lp)
            out["top_logprobs"].append({tok.decode([t]): t_lp for t, t_lp in top})
            out["text_offset"].append(offset)
            offset += len(text)
        return out

    def _envelope(self, obj: str, cid: str, created: int, choices, **extra):
        return {"id": cid, "object": obj, "created": created,
                "model": self.model_name,
                "system_fingerprint": self.system_fingerprint,
                "choices": choices, **extra}

    @staticmethod
    def _include_usage(body: Dict[str, Any]) -> bool:
        opts = body.get("stream_options") or {}
        if not isinstance(opts, dict):
            raise OpenAIError("'stream_options' must be an object",
                              param="stream_options")
        return bool(opts.get("include_usage"))

    # ------------------------------------------------------------------ #
    # chat completions
    # ------------------------------------------------------------------ #
    def chat_completion(self, body: Dict[str, Any]) -> Dict[str, Any]:
        greq = self._decode_chat(body)
        result = self._submit(greq).result()
        choices = [{
            "index": c.index,
            "message": {"role": "assistant", "content": c.text},
            "logprobs": (self._chat_logprobs(c.tokens, c.logprobs)
                         if greq.sampling.logprobs else None),
            "finish_reason": c.finish_reason,
        } for c in result.choices]
        return self._envelope("chat.completion",
                              f"chatcmpl-{uuid.uuid4().hex[:12]}",
                              int(time.time()), choices, usage=result.usage())

    def chat_completion_stream(self, body: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        """SSE-style chunk dicts.  Closing the generator early (client
        disconnect) aborts the underlying request."""
        greq = self._decode_chat(body)
        include_usage = self._include_usage(body)
        handle = self._submit(greq)
        cid, created = f"chatcmpl-{uuid.uuid4().hex[:12]}", int(time.time())

        def chunk(index, delta, finish=None, logprobs=None):
            extra = {"usage": None} if include_usage else {}
            return self._envelope("chat.completion.chunk", cid, created, [{
                "index": index, "delta": delta, "logprobs": logprobs,
                "finish_reason": finish}], **extra)

        def gen() -> Iterator[Dict[str, Any]]:
            try:
                for i in range(greq.n):
                    yield chunk(i, {"role": "assistant", "content": ""})
                for ev in handle.stream():
                    if isinstance(ev, TokenEvent):
                        logprobs = None
                        if greq.sampling.logprobs:
                            logprobs = self._chat_logprobs(
                                [ev.token], [(ev.logprob, ev.top_logprobs or [])])
                        if ev.text or logprobs:
                            yield chunk(ev.index, {"content": ev.text},
                                        logprobs=logprobs)
                    elif isinstance(ev, FinishEvent):
                        delta = {"content": ev.text} if ev.text else {}
                        yield chunk(ev.index, delta, finish=ev.finish_reason)
                if include_usage:
                    yield {"id": cid, "object": "chat.completion.chunk",
                           "created": created, "model": self.model_name,
                           "choices": [], "usage": handle.usage()}
            finally:
                if not handle.finished:
                    handle.abort(wait=False)

        return gen()

    # ------------------------------------------------------------------ #
    # legacy completions
    # ------------------------------------------------------------------ #
    def completion(self, body: Dict[str, Any]) -> Dict[str, Any]:
        greqs = self._decode_completion(body)
        handles = self._submit_all(greqs)
        choices = []
        usage = {"prompt_tokens": 0, "completion_tokens": 0, "total_tokens": 0}
        for p, (greq, handle) in enumerate(zip(greqs, handles)):
            result = handle.result()
            for c in result.choices:
                choices.append({
                    "index": p * greq.n + c.index,
                    "text": c.text,
                    "logprobs": (self._completion_logprobs(c.tokens, c.logprobs)
                                 if greq.sampling.logprobs else None),
                    "finish_reason": c.finish_reason,
                })
            for key, val in result.usage().items():
                usage[key] += val
        return self._envelope("text_completion", f"cmpl-{uuid.uuid4().hex[:12]}",
                              int(time.time()), choices, usage=usage)

    def completion_stream(self, body: Dict[str, Any]) -> Iterator[Dict[str, Any]]:
        greqs = self._decode_completion(body, stream=True)
        include_usage = self._include_usage(body)
        handles = self._submit_all(greqs)
        cid, created = f"cmpl-{uuid.uuid4().hex[:12]}", int(time.time())

        def chunk(index, text, finish=None, logprobs=None):
            extra = {"usage": None} if include_usage else {}
            return self._envelope("text_completion", cid, created, [{
                "index": index, "text": text, "logprobs": logprobs,
                "finish_reason": finish}], **extra)

        def gen() -> Iterator[Dict[str, Any]]:
            try:
                for p, (greq, handle) in enumerate(zip(greqs, handles)):
                    base = p * greq.n
                    for ev in handle.stream():
                        if isinstance(ev, TokenEvent):
                            logprobs = None
                            if greq.sampling.logprobs:
                                logprobs = self._completion_logprobs(
                                    [ev.token], [(ev.logprob, ev.top_logprobs or [])])
                            if ev.text or logprobs:
                                yield chunk(base + ev.index, ev.text,
                                            logprobs=logprobs)
                        elif isinstance(ev, FinishEvent):
                            yield chunk(base + ev.index, ev.text,
                                        finish=ev.finish_reason)
                if include_usage:
                    usage = {"prompt_tokens": 0, "completion_tokens": 0,
                             "total_tokens": 0}
                    for handle in handles:
                        for key, val in handle.usage().items():
                            usage[key] += val
                    yield {"id": cid, "object": "text_completion",
                           "created": created, "model": self.model_name,
                           "choices": [], "usage": usage}
            finally:
                for handle in handles:
                    if not handle.finished:
                        handle.abort(wait=False)

        return gen()

    # ------------------------------------------------------------------ #
    # models / stats / health
    # ------------------------------------------------------------------ #
    def models(self) -> Dict[str, Any]:
        return {"object": "list", "data": [{
            "id": self.model_name, "object": "model",
            "created": int(time.time()), "owned_by": "repro"}]}

    def stats(self) -> Dict[str, Any]:
        """Serving observability (``GET /stats``): scheduler and client
        counters with the ``content_cache`` block (media pipeline and
        content-cache counters), the engine's knobs, the ``prefix_cache``
        block when the cache is on, and under the paged layout a
        ``kv_pages`` block (arena occupancy and allocator counters);
        subsystems not ported yet (admission, speculation, router) have no
        block."""
        eng = self.engine
        out = dict(self.client.stats())
        out.update({
            "model": self.model_name,
            "device": device_name(eng.device),
            "max_batch": eng.scheduler.max_batch,
            "free_slots": eng.pool.num_free,
            "cache_len": eng.pool.cache_len,
            "max_decode_block": eng.max_decode_block,
            "prefill_chunk": eng.prefill_chunk,
            "prefill_bucket_floor": eng._bucket_floor,
            "prefill_buckets_seen": sorted(eng._seen_buckets),
            "sched_policy": eng.scheduler.policy.name,
        })
        if eng.prefix_cache is not None:
            out["prefix_cache"] = {
                "entries": len(eng.prefix_cache),
                "hits": eng.prefix_cache.stats.hits,
                "misses": eng.prefix_cache.stats.misses,
            }
        if isinstance(eng.pool, PagedKVPool):
            out["kv_pages"] = {"page_size": eng.pool.page_size,
                               "kv_dtype": eng.pool.kv_dtype,
                               **eng.pool.page_occupancy(),
                               **dataclasses.asdict(eng.pool.stats)}
        return out

    def healthz(self) -> Tuple[Dict[str, Any], int]:
        """Liveness: 200 while the engine loop thread is alive."""
        ok = self.client.alive
        return {"status": "ok" if ok else "dead", "ok": ok}, (200 if ok else 503)
