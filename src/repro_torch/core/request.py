"""Request / sequence-state types shared by the scheduler, engine and the
request-lifecycle client (:mod:`repro_torch.serving.client`)."""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple, Union

_req_counter = itertools.count()


class FinishReason(str, Enum):
    STOP = "stop"  # EOS / stop token / stop sequence
    LENGTH = "length"  # max_tokens reached
    ABORT = "abort"
    # overload/fault terminals (PR 6): a request expired in the admission
    # queue, or blew up in prefill/decode/codec and was failed in isolation
    # (survivors continue) — both are typed events, never hangs
    TIMEOUT = "timeout"  # queue-wait timeout at admission
    ERROR = "error"  # per-request fault (see core/faults.py taxonomy)


class RequestStatus(str, Enum):
    """Lifecycle states of one engine request (see DESIGN_engine_client.md).

    QUEUED -> PREFILLING -> DECODING -> FINISHED | ABORTED, with
    DECODING -> QUEUED on preemption.  ``abort()`` is legal from any state
    and terminal; aborting a FINISHED request is a no-op."""

    QUEUED = "queued"  # pending admission (incl. speculative jobs)
    PREFILLING = "prefilling"  # slot bound, prompt chunks in flight
    DECODING = "decoding"  # live decode slot, tokens streaming
    FINISHED = "finished"  # stop / length — terminal
    ABORTED = "aborted"  # cancelled — terminal
    FAILED = "failed"  # timeout / per-request fault — terminal


class PromptTooLongError(ValueError):
    """Prompt does not fit the engine's KV cache (and the model has no
    sliding window to make ring-wrap semantically valid)."""


@dataclass
class SamplingParams:
    """Per-request sampling parameters.

    ``top_p`` / ``top_k`` / ``min_p`` default to ``None`` = "use the engine's
    default" (the engine knobs became per-request fallbacks when sampler state
    moved into the device-resident :class:`~repro_torch.core.kv_cache.DecodeState`);
    explicit values are validated at ``engine.add_request`` (hence at
    ``EngineClient.submit``): ``top_p`` ∈ (0, 1], ``top_k`` >= 0 (0 = off),
    ``min_p`` ∈ [0, 1), ``seed`` >= 0.  A ``seed`` pins the request's PRNG key
    stream (``fold_in(PRNGKey(seed), position)`` per token — see
    :mod:`repro_torch.core.sampling`), so seeded requests replay identically across
    runs, across batch compositions, and across preemption/resume."""

    temperature: float = 0.0  # 0 = greedy
    top_k: Optional[int] = None  # None = engine default; 0 = off
    top_p: Optional[float] = None  # None = engine default; 1 = off
    min_p: Optional[float] = None  # None = engine default; 0 = off
    max_tokens: int = 64
    stop_token_ids: tuple = ()
    # stop *sequences* (strings) are enforced host-side at block emit:
    # generation finishes with reason "stop" the moment the accumulated text
    # contains one, the match itself is truncated away, and text that could
    # still become a match is held back from the stream (core/streaming.py
    # StopSequenceChecker)
    stop_sequences: Tuple[str, ...] = ()
    # per-token logprob collection (OpenAI `logprobs` / `top_logprobs`):
    # when enabled the decode block also returns the sampled token's
    # logprob and the top-`top_logprobs` alternatives per step
    logprobs: bool = False
    top_logprobs: int = 0
    # OpenAI completions `echo`: return the prompt tokens (with logprobs,
    # when `logprobs` is set) ahead of the completion.  Prompt logprobs are
    # teacher-forced from one full-logits prefill pass at admission commit
    # (the first prompt token has no conditioning context, so its entry is
    # None — OpenAI semantics).  Rejected for streaming requests by the
    # OpenAI codec.
    echo: bool = False
    seed: Optional[int] = None


@dataclass
class Request:
    prompt_tokens: List[int]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    # multimodal inputs: list of image/audio/video payloads in any supported
    # format (ndarray | {'base64': ...} | {'url': ...}); see serving/media.py
    images: List[Any] = field(default_factory=list)
    video_frames: List[Any] = field(default_factory=list)
    audio: Optional[Any] = None
    request_id: int = field(default_factory=lambda: next(_req_counter))
    arrival_time: float = field(default_factory=time.monotonic)
    # scheduling class: higher priority = more urgent; deadline_ms is a
    # latency target relative to arrival (None = best-effort batch work).
    # Both are inputs to the scheduler's SchedulingPolicy ordering and to
    # slot preemption — see core/scheduler.py.
    priority: int = 0
    deadline_ms: Optional[float] = None
    # admission-control tenant (per-tenant rate limits + fair-share
    # queueing — core/admission.py); the OpenAI ``user`` field or the
    # ``x-tenant`` header map here
    tenant: str = "default"
    # shared-prefix admission group (OpenAI ``n`` fan-out): every choice of
    # one GenerationRequest carries the leader's request_id.  The engine
    # prefills the leader once and admits the followers by sharing the
    # leader's committed prompt cache (COW pages under the paged layout) —
    # see InferenceEngine._group_value.  None = independent request.
    group_leader: Optional[int] = None
    group_size: int = 1

    # -- filled in by the engine --------------------------------------- #
    status: RequestStatus = RequestStatus.QUEUED
    output_tokens: List[int] = field(default_factory=list)
    # emitted text after stop-sequence filtering — authoritative for user
    # -facing responses (equals decode(output_tokens) when no stop sequence
    # fired; shorter when one did, with the match truncated away)
    output_text: str = ""
    # per-token logprob data, populated only when sampling.logprobs: one
    # (logprob, top_logprobs) pair per emitted token, where top_logprobs is
    # a list of (token_id, logprob) pairs (len == sampling.top_logprobs)
    output_logprobs: List[Tuple[float, List[Tuple[int, float]]]] = field(default_factory=list)
    # prompt-token logprobs, populated when sampling.echo and
    # sampling.logprobs: one entry per prompt token — None for the first
    # (nothing to condition on), float for the rest
    prompt_logprobs: Optional[List[Optional[float]]] = None
    finish_reason: Optional[FinishReason] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    cached_prefix_len: int = 0  # tokens served from the prefix cache
    vision_cache_hits: int = 0
    vision_cache_misses: int = 0
    # media-set digest computed once during admission; reused at retire for
    # the prefix-cache salt (avoids re-decoding + re-hashing every frame)
    media_set_digest: Optional[str] = None
    # per-request base PRNG key ([2] uint32), assigned once at add_request:
    # PRNGKey(sampling.seed) for seeded requests, a split of the engine's
    # request-key chain otherwise.  Living on the request (not the slot), it
    # survives preemption/re-admission, so the stateless per-token fold_in
    # reproduces the exact key stream on resume.
    sample_key: Optional[Any] = None
    # times this request was evicted from a decode slot by a more urgent
    # request (scheduler preemption); bounds re-eviction churn
    preempt_count: int = 0
    # human-readable failure detail when finish_reason is ERROR/TIMEOUT
    # (carried on the terminal StreamEvent's text is user output, so the
    # diagnostic lives here instead)
    error: Optional[str] = None
    metadata: Dict[str, Any] = field(default_factory=dict)

    @property
    def is_finished(self) -> bool:
        return self.finish_reason is not None

    @property
    def deadline_at(self) -> Optional[float]:
        """Absolute monotonic deadline (None = no deadline)."""
        if self.deadline_ms is None:
            return None
        return self.arrival_time + self.deadline_ms / 1e3

    @property
    def latency_class(self) -> str:
        """Coarse workload class for per-class latency accounting
        (``GET /stats``): deadline- or priority-tagged requests are
        "interactive", everything else is best-effort "batch"."""
        if self.deadline_ms is not None or self.priority > 0:
            return "interactive"
        return "batch"

    @property
    def missed_deadline(self) -> Optional[bool]:
        """Whether the finished request blew its deadline (None while
        running or when no deadline was set)."""
        if self.deadline_at is None or self.finish_time is None:
            return None
        return self.finish_time > self.deadline_at

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    @property
    def num_generated(self) -> int:
        return len(self.output_tokens)


@dataclass
class StreamEvent:
    """One emission from the engine: a freshly decoded token (or final)."""

    request_id: int
    token: Optional[int]
    text: str = ""
    finished: bool = False
    finish_reason: Optional[FinishReason] = None
    # populated when the request asked for logprobs: the emitted token's
    # logprob and its top-k alternatives as (token_id, logprob) pairs
    logprob: Optional[float] = None
    top_logprobs: Optional[List[Tuple[int, float]]] = None


@dataclass
class GenerationRequest:
    """User-facing request spec for :class:`repro_torch.serving.client.EngineClient`.

    One ``GenerationRequest`` maps to ``n`` engine :class:`Request`\\ s (the
    OpenAI ``n`` fan-out: one handle, n decode slots, prompt prefills shared
    through the prefix cache).  ``prompt`` is either raw text (encoded with
    the engine's tokenizer at submit time) or pre-tokenised ids.  All ``n``
    choices share one :class:`SamplingParams`; with an explicit ``seed`` the
    choices are therefore identical (seeded replay is a per-request property,
    like greedy fan-out) — omit ``seed`` for per-choice randomness."""

    prompt: Union[str, List[int]]
    sampling: SamplingParams = field(default_factory=SamplingParams)
    n: int = 1
    images: List[Any] = field(default_factory=list)
    video_frames: List[Any] = field(default_factory=list)
    audio: Optional[Any] = None
    priority: int = 0
    deadline_ms: Optional[float] = None
    tenant: str = "default"
    # multi-turn session affinity hint (the ``session`` body extension /
    # ``x-session`` header): the router pins a session's turns to one
    # replica so its prefix cache stays warm.  None = no pin.
    session: Optional[str] = None
    metadata: Dict[str, Any] = field(default_factory=dict)

    def to_requests(self, tokenizer) -> List["Request"]:
        """Expand into ``n`` engine requests (choice index in metadata).

        With ``n > 1`` the choices form one shared-prefix admission group:
        the first choice is the group leader, the rest carry its
        ``request_id`` in ``group_leader`` so the engine prefills the
        prompt once and shares the committed cache (COW pages under the
        paged layout) instead of running n independent prefills."""
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        tokens = self.prompt if not isinstance(self.prompt, str) else tokenizer.encode(self.prompt)
        out: List[Request] = []
        for i in range(self.n):
            out.append(
                Request(
                    prompt_tokens=list(tokens),
                    sampling=self.sampling,
                    images=list(self.images),
                    video_frames=list(self.video_frames),
                    audio=self.audio,
                    priority=self.priority,
                    deadline_ms=self.deadline_ms,
                    tenant=self.tenant,
                    group_leader=(out[0].request_id if i else None),
                    group_size=self.n,
                    metadata={**self.metadata, "choice_index": i},
                )
            )
        return out
