"""The inference engine of the port: continuous batching over a dense ring
KV cache or a paged arena with copy-on-write prefix sharing, with a
device-resident K-step decode block, a chunked, batched prefill pipeline,
the text prefix cache (paper Alg.2) and, for vision and audio models,
batched encode waves with in-flight dedup and the content cache (paper
Alg.3) — the reference package's ``core/engine.py`` in eager PyTorch, for
every family it serves: dense, MoE, vision, Mamba-2 SSM, the Mamba +
attention hybrid and the audio encoder-decoder.

Flow per :meth:`InferenceEngine.step` (paper Alg.1 loop body):

  1. **Plan admissions**: pending requests bind to free decode slots; each
     opens a *prefill job* that parks in the scheduler's chunk queue, or —
     a preempted request — resumes its eviction snapshot.  A request with
     images or video frames is admissible only once its whole media set
     has an embedding (content-cache hits at job open, the rest from
     encode waves).  With ``preemption=True`` under a preemptive policy, a
     strictly more urgent pending request then evicts the least urgent
     live slot.
  2. **Dispatch a decode block** (if any slot is live): K decode+sample
     steps over device tensors, each one replay of a CUDA graph of the
     step on the card (:mod:`repro_torch.core.decode_graph`) — sampling,
     stop-token detection and budget accounting all stay on the device,
     and a slot that finishes is frozen by the on-device finished-mask
     (masked cache writes, no position advance).  K comes from
     ``scheduler.plan_decode_block`` and collapses to 1 while requests or
     prefill chunks wait.
  3. **Run an encode wave, then dispatch a prefill wave**: up to
     ``encode_wave`` unique pending encodes (singleflight on the content
     hash: N requests with one image cost one encoder call), then every
     queued job's next chunk, packed into right-padded ``[k, bucket]``
     forward passes (per-row positions and a ``seq_valid`` length mask),
     ``prefill_chunk`` tokens per job per step, grouped by bucket and by
     whether the rows' cross KV came from the content cache.
  4. **Sync + emit**: the host syncs **once per block** (the copy of the
     ``[K, B]`` token block), emits and retires, then commits finished
     prefills — one multi-slot cache copy, one decode-state scatter, one
     batched first-token sample.

Greedy outputs are invariant to K and to ``prefill_chunk``.

Preemption (``preemption=True``, ``sched_policy`` priority or edf): an
evicted slot's cache is snapshotted — by copy on the dense ring, by
reference (incref'd pages) on the paged arena — and published as an
exact-sequence prefix-cache entry (or held engine-side, at most
``max_batch`` of them, when the cache is off).  Resume restores the cache
and decode state bit for bit; a snapshot lost to the cache's LRU falls back
to re-prefilling the prompt + generated history as one sequence.  Slots
whose history reached ``cache_len`` (ring-wrapped) are never victims.

Prefix cache (``enable_prefix_cache``): a prefill opens at the longest
cached block-aligned prefix of its prompt; a chunked prefill publishes its
partial prefix at every chunk boundary (one rolling entry per job); the
dense layout publishes a slot's prompt at retire, the paged layout at
commit — as the slot's prompt pages, leased copy-on-write, beside a dense
shadow row that later prefills resume from.  Under ``kv_layout="paged"``
every decode block first makes the pages it will write exclusively owned
(:meth:`PagedKVPool.ensure_decode_capacity`) under the pressure ladder:
(1) evict prefix-cache (then cross-KV) entries, (2) preempt the live slot
holding the most pages without a snapshot, (3) fail the last holdout with a
typed error.  ``kv_num_pages`` may size the arena below full capacity.

Content cache (``enable_content_cache``): per-frame embedding entries skip
the encoder; per-media-set cross-KV entries (device clones, never views
into a wave cache) skip the context projection of every cross-attention
layer.  Under ``kv_layout="paged"`` a cross-KV entry leases accounting
pages of the arena, and the pressure ladder evicts it after the prefix
cache's entries.

Speculative decoding (``spec_mode`` ``"ngram"`` or ``"draft"``,
:mod:`repro_torch.core.spec_decode`): while no request or prefill chunk
waits, a step stages up to ``spec_k`` drafts per live slot — prompt-lookup
proposals from its own history, or ``spec_k`` steps of a draft model in its
own pool — and runs ONE verify forward over ``spec_k + 1`` positions in
place of the decode block, committing the longest accepted prefix plus one
token a slot and rolling back the KV cells of rejected drafts.  N-gram
rows emit exactly the spec-off stream; draft-model stochastic rows are
rejection-sampled.  A slot whose ring would wrap inside a round, or whose
budget leaves no draft, stages none; a step with nothing staged runs the
ordinary decode block.

Speculative wave filling (``speculative_fill``, on by default): a wave
group of k rows runs at the next power of two anyway, so its padding rows
carry chunks of not-yet-admitted pending requests (slotless jobs, at most
``max_spec_jobs``) in place of zero rows — no extra forward.  Their chunks
publish to the prefix cache; admission adopts the job, or commits it from
its staged logits when the whole prompt is already done.

Shared-prefix ``n`` groups: the choices of one ``n`` > 1 text request
prefill once — the leader — and the followers admit against the leader's
committed prompt cache (its pages by incref'd reference on the paged
arena, its row read back on the dense ring).  Media groups admit
independently.  ``echo`` with ``logprobs`` adds a teacher-forced pass over
the prompt at the first admission commit (``Request.prompt_logprobs``).

Faults (``faults=``, :mod:`repro_torch.core.faults`): injection sites
``pool``, ``prefill``, ``codec``, ``slow_step`` and ``decode``, and fault
boundaries that fail only the requests the reference fails — one request,
one wave group, one commit wave, or (a decode block or verify round that
raised) every live slot, after which the pool and decode state are rebuilt
and pending requests continue.  :meth:`drain_snapshot` publishes live
slots as exact-sequence entries and aborts the rest;
:meth:`export_handoff` / :meth:`import_handoff` move every open request to
another engine (live text slots as dense snapshots, the rest re-prefill).

Recurrent families (``ssm``/``ssm_moe`` layers) carry ``conv``/``state``
per slot beside the KV cache — dense on both layouts, in every snapshot,
handoff record and prefix-cache value — and refuse speculation, as the
reference does.  A prefix-cache value keeps the recurrent leaves at the
value's own length while a hit resumes at a shorter block boundary, as in
the reference (``ROADMAP.md`` §3, quirks kept).  An audio request's
waveform goes through the encode waves and the content cache as an image
does; its embedding feeds the model's encoder stack.  Training and
distribution are not ported.
"""
from __future__ import annotations

import logging
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.content_cache import (ContentCache, CrossKVEntry,
                                            EmbeddingEntry, MediaStats,
                                            content_hash, media_set_digest)
from repro_torch.core.decode_graph import DecodeGraphs
from repro_torch.core.faults import FaultInjector
from repro_torch.core.kv_cache import (SlotKVPool, admit_decode_state,
                                       concat_cache_rows, init_decode_state,
                                       slice_cache_row, tree_bytes)
from repro_torch.core.paged_kv import PagedKVPool, PagePoolExhausted
from repro_torch.core.prefix_cache import TextPrefixCache
from repro_torch.core.request import (FinishReason, PromptTooLongError,
                                      Request, RequestStatus, StreamEvent)
from repro_torch.core.sampling import (keys_array, masked_sample_inner,
                                       prng_key, request_base_key, split,
                                       validate_sampling_params)
from repro_torch.core.scheduler import (ContinuousBatchingScheduler,
                                        SchedulingPolicy)
from repro_torch.core.spec_decode import (DraftModelSource, DraftSource,
                                          NGramDraftSource, SpecController,
                                          SpecStats, build_spec_verify_fn,
                                          stage_drafts)
from repro_torch.core.streaming import StopSequenceChecker, TokenStreamDecoder
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model, init_cache, tree_map
from repro_torch.serving.media import (AudioEncoderStub, VisionEncoderStub,
                                      decode_media)
from repro_torch.serving.tokenizer import ByteTokenizer
from repro_torch.tracing import TRACER


log = logging.getLogger("repro_torch.engine")

MAX_MEDIA_ITEMS = 4     # images the cross-attention context window holds


def _next_bucket(n: int, floor: int = 16) -> int:
    """Smallest power-of-two bucket >= n (>= floor)."""
    b = floor
    while b < n:
        b *= 2
    return b


@dataclass
class _Admission:
    """One prefilled request, staged for the batched wave commit."""
    slot: int
    req: Request
    single_cache: Any
    first_token: int
    ctx_valid: Optional[np.ndarray]      # [T] bool or None
    seq_len: int                         # tokens materialised in the cache
    logprob: Optional[float] = None
    top_logprobs: Optional[List[Tuple[int, float]]] = None


@dataclass
class _PrefillJob:
    """One request's prefill in flight: the partial batch=1 cache is carried
    across chunks outside the pool, and the job re-enters the scheduler's
    chunk queue until the whole sequence is materialised.  ``tokens`` is
    the prompt, or prompt + generated history for a preempted request
    whose eviction snapshot was lost.

    ``slot is None`` marks a *speculative* job: its request is still
    pending, and its chunks ride the padding rows of admitted waves from
    the engine's ``_spec_jobs`` table.  Admission binds it to a slot; a job
    that finished its whole prompt first keeps its last-position
    ``logits``, which the commit samples with no extra pass."""
    slot: Optional[int]
    req: Request
    tokens: List[int]
    cache: Any
    consumed: int
    embeds: Optional[np.ndarray]         # [1, T, De] media embeddings | None
    ctx_valid: Optional[np.ndarray]      # [1, T] bool | None
    cross_cached: bool                   # cross KV restored from the cache
    publish_xkv: bool                    # publish cross KV after 1st chunk
    t0: float
    partial_key: Optional[str] = None    # rolling chunk-boundary prefix entry
    logits: Optional[torch.Tensor] = None   # staged last-row logits (a
                                            # speculative job done early)


@dataclass
class _MediaItem:
    """One media payload of a request, resolved to an embedding either by a
    content-cache hit at job open or by an encode wave."""
    hash: str
    ntok: int                            # context tokens this item occupies
    emb: Optional[np.ndarray] = None     # [ntok, De] once resolved


@dataclass
class _MediaJob:
    """A request's media set being resolved ahead of admission: payloads are
    decoded and hashed once at job open, embedding-cache hits resolve items
    at once, the rest wait on shared in-flight encode tasks.  The request
    stays pending until ``remaining == 0``, so a 64-frame video streams
    through encode waves across steps instead of stalling one."""
    req: Request
    items: List[_MediaItem]
    remaining: int                       # items still awaiting an embedding


@dataclass
class _EncodeTask:
    """One *unique* pending encode, keyed by content hash (singleflight):
    every request whose media set needs this hash waits on it, and the
    encode wave runs the encoder once for all of them."""
    hash: str
    pixels: np.ndarray
    encoder: Any
    ntok: int
    waiters: List[_MediaJob]


class InferenceEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Optional[Any] = None,
        *,
        device: DeviceLike = None,
        tokenizer: Optional[ByteTokenizer] = None,
        max_batch: int = 8,
        cache_len: int = 256,
        seed: int = 0,
        top_k: int = 0,
        top_p: float = 1.0,
        min_p: float = 0.0,
        max_decode_block: int = 8,
        max_stop_tokens: int = 8,
        max_top_logprobs: int = 5,
        truncate_long_prompts: bool = False,
        prefill_chunk: int = 512,
        max_prefill_buckets: int = 6,
        sched_policy: Union[str, SchedulingPolicy] = "fifo",
        preemption: bool = False,
        max_preemptions: int = 2,
        speculative_fill: bool = True,
        max_spec_jobs: Optional[int] = None,
        aging_s: Optional[float] = None,
        faults: Optional[FaultInjector] = None,
        enable_prefix_cache: bool = True,
        prefix_block_size: int = 16,
        cache_max_bytes: int = 512 * 1024 * 1024,
        kv_layout: str = "dense",        # 'dense' ring | 'paged' arena (COW)
        kv_page_size: int = 16,          # tokens per KV page (paged layout)
        kv_num_pages: Optional[int] = None,  # arena size; None = full capacity
        kv_dtype: str = "fp",            # 'fp' | 'int8' (paged layout only)
        enable_content_cache: bool = True,
        cache_vision_embeddings: bool = True,
        cache_vision_kv: bool = True,
        content_cache_bytes: Optional[int] = None,  # None = cache_max_bytes
        vision_work_iters: int = 8,
        encode_wave: int = 4,            # unique encodes per step (0 = all)
        spec_mode: str = "off",          # 'off' | 'ngram' | 'draft'
        spec_k: int = 4,                 # max drafted tokens per round
        spec_draft_config: Optional[Any] = None,  # name | ModelConfig
        spec_draft_params: Optional[Any] = None,  # None = seeded init
        spec_ngram_max: int = 3,         # longest lookup n-gram
    ):
        if spec_mode not in ("off", "ngram", "draft"):
            raise ValueError(f"spec_mode must be 'off', 'ngram' or 'draft', "
                             f"got {spec_mode!r}")
        self.spec_mode = spec_mode
        self.spec_k = max(1, spec_k) if spec_mode != "off" else 0
        if spec_mode != "off":
            if any(k.startswith("ssm") for k in cfg.layer_kinds()):
                raise ValueError(
                    "speculative decoding needs an attention decode path: "
                    f"family '{cfg.family}' decodes recurrent state strictly "
                    "one token at a time")
            if spec_mode == "draft" and spec_draft_config is None:
                raise ValueError("spec_mode='draft' requires "
                                 "spec_draft_config (a config name or "
                                 "ModelConfig for the draft model)")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got "
                             f"{kv_layout!r}")
        if kv_layout == "dense" and kv_dtype != "fp":
            raise ValueError("int8 KV requires kv_layout='paged'")
        self._paged = kv_layout == "paged"
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Model(cfg)
        self.seed = seed
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, self.device)
        self.params = params
        self.tokenizer = tokenizer or ByteTokenizer()
        # engine-level sampling knobs are per-request fallbacks
        validate_sampling_params(top_p, top_k, min_p, None)
        self.top_k, self.top_p, self.min_p = top_k, top_p, min_p
        self.max_decode_block = max(1, max_decode_block)
        self.max_stop_tokens = max_stop_tokens
        self.max_top_logprobs = max(1, max_top_logprobs)
        self.truncate_long_prompts = truncate_long_prompts
        self.prefill_chunk = max(0, prefill_chunk)
        self.preemption = preemption
        self.max_preemptions = max(0, max_preemptions)
        self.speculative_fill = speculative_fill
        self.max_spec_jobs = (max_batch if max_spec_jobs is None
                              else max(0, max_spec_jobs))
        # deterministic fault injection (None = every hook inert); the
        # step counter keys the slow_step and pool sites
        self.faults = faults
        self._fault_tick = 0

        # media geometry (the reference's defaults): the context window
        # holds MAX_MEDIA_ITEMS images; a video frame takes a quarter of an
        # image's slots; an audio model's context is its num_frames encoder
        # frames
        self.media_kind = ("vision" if cfg.vision is not None
                           else "audio" if cfg.audio is not None else "none")
        self.ctx_len = 0
        # unique media encodes per step (0 = all pending): a video's frames
        # stream across steps instead of monopolising one
        self.encode_wave = max(0, encode_wave)
        if self.media_kind == "vision":
            self.image_tokens = cfg.vision.num_image_tokens
            self.frame_tokens = max(4, self.image_tokens // 4)
            self.ctx_len = self.image_tokens * MAX_MEDIA_ITEMS
            self.embed_dim = cfg.vision.embed_dim
            self._img_encoder = VisionEncoderStub(
                self.image_tokens, self.embed_dim, work_iters=vision_work_iters)
            self._frame_encoder = VisionEncoderStub(
                self.frame_tokens, self.embed_dim, work_iters=vision_work_iters)
        elif self.media_kind == "audio":
            self.ctx_len = cfg.audio.num_frames
            self.embed_dim = cfg.audio.embed_dim
            self._audio_encoder = AudioEncoderStub(
                cfg.audio.num_frames, self.embed_dim,
                work_iters=vision_work_iters)

        if self._paged:
            self.pool: Any = PagedKVPool(
                cfg, max_batch, cache_len, ctx_len=self.ctx_len,
                page_size=kv_page_size, num_pages=kv_num_pages,
                kv_dtype=kv_dtype, device=self.device)
        else:
            self.pool = SlotKVPool(cfg, max_batch, cache_len,
                                   ctx_len=self.ctx_len, device=self.device)
        # COW page leases pinned by in-flight prefill jobs (request_id ->
        # page ids incref'd at prefix-cache lookup); ownership transfers to
        # the slot at commit, or is released when the request ends first
        self._job_leases: Dict[int, List[int]] = {}
        self.prefix_cache = (TextPrefixCache(prefix_block_size,
                                             cache_max_bytes,
                                             on_evict=(self._on_cache_evict
                                                       if self._paged
                                                       else None))
                             if enable_prefix_cache else None)
        self.content_cache = (ContentCache(
            cache_max_bytes if content_cache_bytes is None
            else content_cache_bytes,
            cache_embeddings=cache_vision_embeddings,
            cache_kv=cache_vision_kv,
            on_evict=self._on_content_evict if self._paged else None)
            if enable_content_cache else None)
        # batched vision encoding: per-request media jobs plus the
        # singleflight table of unique in-flight encodes (hash -> task),
        # bounded at 2 * max_batch plus the speculative jobs
        self.media_stats = MediaStats()
        self._media_jobs: Dict[int, _MediaJob] = {}
        self._encode_tasks: Dict[str, _EncodeTask] = {}
        self._max_media_jobs = 2 * max_batch + self.max_spec_jobs
        # terminal events of requests failed inside the admission predicate
        # (an undecodable media payload), drained at the end of step()
        self._fault_events: List[StreamEvent] = []
        self.scheduler = ContinuousBatchingScheduler(max_batch,
                                                     policy=sched_policy,
                                                     aging_s=aging_s)
        # installed by EngineClient: True while an abort waits at the block
        # boundary, so plan_decode_block collapses K to 1
        self.reclaim_hint: Optional[Callable[[], bool]] = None
        self.state = init_decode_state(max_batch, max_stop_tokens,
                                       ctx_len=self.ctx_len,
                                       spec_k=self.spec_k,
                                       device=self.device)
        # the decode step's static buffers and CUDA graphs, built at the
        # first block and dropped where the arena is rebuilt (recovery)
        self._decode_graphs: Optional[DecodeGraphs] = None
        # unseeded requests take their base key from this engine-owned key
        # chain, PRNGKey(seed + 1) split once per add (the reference's,
        # deterministic for a fixed engine seed + add order)
        self._request_rng = prng_key(seed + 1)
        self._streamers: Dict[int, TokenStreamDecoder] = {}
        self._stopchk: Dict[int, StopSequenceChecker] = {}
        self._live_slots: set = set()        # slots committed to DecodeState
        # preemption snapshots: request_id -> {"cache": snapshot value held
        # engine-side (prefix cache off) or None, "ctx_valid": row or None}.
        # With the prefix cache on, the snapshot value rides in it as an
        # exact-sequence entry, competing for its byte budget
        self._evicted: Dict[int, Dict[str, Any]] = {}
        # finished prefills whose pages the paged arena cannot take yet:
        # (job, last-position logits) in commit order, retried every step
        self._staged: List[Tuple[_PrefillJob, torch.Tensor]] = []
        # speculative prefill jobs of pending requests (request_id -> job),
        # at most max_spec_jobs; and those whose whole prompt finished
        # before their slot came, committed with the next wave
        self._spec_jobs: Dict[int, _PrefillJob] = {}
        self._ready_jobs: List[_PrefillJob] = []
        # shared-prefix admission groups (n > 1): leader request_id ->
        # {"value": the leader's committed prompt cache or None,
        # "remaining": followers still owed a share, "failed": the leader
        # died before its commit}
        self._prefill_groups: Dict[int, Dict[str, Any]] = {}
        self.group_stats = {"groups": 0, "shared_admits": 0,
                            "independent_fallbacks": 0}

        # power-of-two prefill buckets, floor raised until at most
        # max_prefill_buckets distinct shapes remain (reference :428-440)
        self._bucket_cap = max(1, max_prefill_buckets)
        b_max = _next_bucket(min(cache_len, self.prefill_chunk or cache_len),
                             floor=32)
        floor = 32
        while floor < b_max and \
                b_max.bit_length() - floor.bit_length() + 1 > self._bucket_cap:
            floor *= 2
        self._bucket_floor = min(floor, b_max)
        self._seen_buckets: frozenset = frozenset()

        # speculation: the counters and the controller exist when it is off
        # too (a stable /stats block); the verify function and the draft
        # source only when a mode is selected
        self.spec_stats = SpecStats()
        self.spec_controller = SpecController()
        self._draft_source: Optional[DraftSource] = None
        self._spec_verify_fn = None
        if self.spec_mode != "off":
            self._spec_verify_fn = build_spec_verify_fn(
                self.model, use_ctx=self.media_kind != "none",
                n_top=self.max_top_logprobs, paged=self._paged,
                cache_len=cache_len,
                page_size=self.pool.page_size if self._paged else 0)
            if self.spec_mode == "draft":
                self._draft_source = self._make_draft_source(
                    spec_draft_config, spec_draft_params, max_batch,
                    cache_len, seed)
            else:
                self._draft_source = NGramDraftSource(max_n=spec_ngram_max)

    def _make_draft_source(self, dcfg, params, max_batch: int,
                           cache_len: int, seed: int) -> DraftModelSource:
        """The draft-model rung, behind the reference's gates: the draft
        shares the target's vocab (its proposals are target token ids) and
        is a text-only attention config."""
        if isinstance(dcfg, str):
            from repro_torch.configs import get_config
            dcfg = get_config(dcfg)
        if dcfg.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {dcfg.vocab_size} != target vocab "
                f"{self.cfg.vocab_size}: draft proposals must be target "
                "token ids")
        if any(k.startswith("ssm") for k in dcfg.layer_kinds()) or \
                dcfg.vision is not None or dcfg.audio is not None:
            raise ValueError("the draft model must be a text-only "
                             "attention config")
        return DraftModelSource(dcfg, params, max_batch=max_batch,
                                cache_len=cache_len, seed=seed,
                                device=self.device)

    # ------------------------------------------------------------------ #
    # device steps
    # ------------------------------------------------------------------ #
    def _decode_block(self, num_steps: int, want_logprobs: bool,
                      any_stochastic: bool, any_mask: bool):
        """K decode+sample iterations over the device state, in place.  No
        host sync happens inside: the caller copies the returned token block
        (and logprobs) to the host once, before the next block.
        ``any_stochastic``/``any_mask`` come from the live requests'
        sampling parameters, known on the host, so the all-greedy block
        never touches the sampler's sort or noise.  The steps run in
        :class:`~repro_torch.core.decode_graph.DecodeGraphs`: each one
        replay of a captured CUDA graph on the card, eager elsewhere."""
        runner = self._decode_graphs
        if runner is None:
            runner = self._decode_graphs = DecodeGraphs(
                self.model, self.params, self.pool, self.state,
                paged=self._paged, use_ctx=self.media_kind != "none",
                n_top=self.max_top_logprobs, max_steps=self.max_decode_block)
        return runner.run(self.state, num_steps, want_logprobs,
                          any_stochastic, any_mask)

    def _plan_bucket(self, n: int) -> int:
        return _next_bucket(n, floor=self._bucket_floor)

    def _prefill(self, tokens, positions, single_caches, seq_valid, last_idx,
                 media, ctx_valid, cross_cached: bool):
        """Batched prefill for one wave group: k right-padded rows at one
        bucket, each resuming at its own offset (per-row positions) with its
        own length mask.  The rows' caches are concatenated into a fresh
        wave cache that the forward pass writes in place."""
        bucket = tokens.shape[1]
        if bucket not in self._seen_buckets:
            self._seen_buckets = self._seen_buckets | {bucket}
        cache = concat_cache_rows(single_caches)
        out = self.model.apply(self.params, tokens, mode="prefill",
                               positions=positions, cache=cache, resume=True,
                               seq_valid=seq_valid, last_idx=last_idx,
                               ctx_valid=ctx_valid, cross_cached=cross_cached,
                               **self._media_kw(media))
        return out.logits[:, 0], cache

    # ------------------------------------------------------------------ #
    # media pipeline (Alg.3 lines 1-10): batched encode waves + in-flight
    # dedup (singleflight on content hash) ahead of admission
    # ------------------------------------------------------------------ #
    def _has_media(self, req: Request) -> bool:
        return (self.media_kind != "none"
                and bool(req.images or req.video_frames
                         or req.audio is not None))

    def _media_kw(self, media) -> Dict[str, Any]:
        """The model's keyword for a wave's media context: image embeddings
        or audio frame embeddings."""
        return {"audio_frames" if self.media_kind == "audio"
                else "image_embeds": media}

    def _iter_media_payloads(self, req: Request):
        """(payload, encoder, ntok) triples in context order: images, then
        video frames on a vision model, the one waveform on an audio model
        (a payload of the other modality is ignored, as in the
        reference)."""
        if self.media_kind == "vision":
            for img in req.images:
                yield img, self._img_encoder, self.image_tokens
            for frame in req.video_frames:
                yield frame, self._frame_encoder, self.frame_tokens
        elif self.media_kind == "audio" and req.audio is not None:
            yield req.audio, self._audio_encoder, self.ctx_len

    def _open_media_job(self, req: Request) -> _MediaJob:
        """Decode + hash every payload once, resolve items straight from the
        embedding cache, and register the rest with the singleflight table:
        a hash already pending — from this job or a concurrent request —
        never spawns a second encode task."""
        ms = self.media_stats
        items: List[_MediaItem] = []
        job = _MediaJob(req, items, remaining=0)
        for payload, encoder, ntok in self._iter_media_payloads(req):
            pixels = decode_media(payload)
            h = content_hash(pixels)
            item = _MediaItem(h, ntok)
            items.append(item)
            entry = (self.content_cache.get_embedding(h)
                     if self.content_cache is not None else None)
            if entry is not None:
                item.emb = entry.embeddings
                req.vision_cache_hits += 1
                ms.embed_hits += 1
                continue
            req.vision_cache_misses += 1
            ms.embed_misses += 1
            job.remaining += 1
            task = self._encode_tasks.get(h)
            if task is None:
                self._encode_tasks[h] = _EncodeTask(h, pixels, encoder, ntok,
                                                    [job])
            elif job not in task.waiters:
                # joined a concurrent request's in-flight encode
                ms.dedup_joins += 1
                task.waiters.append(job)
        req.media_set_digest = (media_set_digest([it.hash for it in items])
                                if items else None)
        self._media_jobs[req.request_id] = job
        return job

    def _media_admissible(self, req: Request) -> bool:
        """Admission predicate (passed to the scheduler): a media request
        binds a slot only once its whole media set is resolved.  Opens the
        request's media job on first sight (bounded table); a payload that
        does not decode fails the request."""
        if not self._has_media(req):
            return True
        if req.preempt_count and req.request_id in self._evicted:
            # a snapshot resume restores the ctx rows from the snapshot (no
            # embeddings needed); a lost snapshot re-encodes synchronously
            # at prefill open (:meth:`_media_pipeline`)
            return True
        if req.request_id in self._spec_jobs:
            # its speculative job assembled the resolved media set at open
            # (the reference opens a second media job here, whose hits are
            # counted again and which nothing drops until the request ends)
            return True
        job = self._media_jobs.get(req.request_id)
        if job is None:
            if len(self._media_jobs) >= self._max_media_jobs:
                return False             # table full: stays queued
            try:
                job = self._open_media_job(req)
            except (KeyError, TypeError, ValueError, OSError) as e:
                self._fault_events.extend(self._fail_request(
                    req.request_id, f"media decode failed: {e!r}"))
                return False
        return job.remaining == 0

    # ------------------------------------------------------------------ #
    # shared-prefix admission groups (n > 1 fan-out)
    # ------------------------------------------------------------------ #
    def _admissible(self, req: Request) -> bool:
        """Admission predicate: media resolved and, for an ``n`` > 1
        follower, the group leader's prompt cache committed."""
        return self._media_admissible(req) and self._group_admissible(req)

    def _group_admissible(self, req: Request) -> bool:
        if req.group_leader is None or req.metadata.get("group_done"):
            return True
        if self._has_media(req):
            # media groups admit independently (the shared value carries
            # no context rows); the content cache dedups their encodes
            return True
        g = self._prefill_groups.get(req.group_leader)
        if g is None:
            # a leader this engine never saw (handoff, a direct add):
            # admit independently rather than wait forever
            return True
        return g["value"] is not None or g["failed"]

    def _group_value(self, req: Request) -> Optional[Dict[str, Any]]:
        """The leader's committed prompt cache for an admissible follower
        (None: prefill independently)."""
        if (req.group_leader is None or req.metadata.get("group_done")
                or req.num_generated or self._has_media(req)):
            return None
        g = self._prefill_groups.get(req.group_leader)
        return None if g is None else g["value"]

    def _group_consume(self, req: Request) -> None:
        """One follower leaves the group (shared admission, independent
        fallback or termination); the last one out releases the value's
        page refs."""
        if req.group_leader is None or req.metadata.get("group_done"):
            return
        req.metadata["group_done"] = True
        g = self._prefill_groups.get(req.group_leader)
        if g is None:
            return
        g["remaining"] -= 1
        if g["remaining"] <= 0:
            if g["value"] is not None:
                self._release_snapshot_value(g["value"])
            del self._prefill_groups[req.group_leader]

    def _group_on_terminate(self, req: Request) -> None:
        """A leader that dies before its commit turns the group to
        independent admission; a dying follower consumes its share."""
        if req.group_size > 1 and req.group_leader is None:
            g = self._prefill_groups.get(req.request_id)
            if g is not None and g["value"] is None:
                g["failed"] = True
        elif req.group_leader is not None:
            self._group_consume(req)

    def _group_publish(self, a: _Admission) -> None:
        """A group leader's first (prompt-only) commit stages its prompt
        cache as the group's shared value: the slot's prompt pages by
        incref'd reference on the paged arena (zero copies), the row read
        back from the pool on the dense ring (generated KV lands only in
        later blocks, so the row is exactly the prompt's)."""
        req = a.req
        g = self._prefill_groups.get(req.request_id)
        if (g is None or g["value"] is not None or g["remaining"] <= 0
                or a.seq_len != len(req.prompt_tokens)
                or self._has_media(req)):
            return
        if self._paged:
            pub = list(self.pool.slot_pages(a.slot)[:a.seq_len
                                                   // self.pool.page_size])
            self.pool.incref_pages(pub)
            # the dense shadow (followers resume their prefill from it) is
            # cloned out of the wave cache it is a view of
            g["value"] = {"pages": pub,
                          "dense": tree_map(torch.clone, a.single_cache),
                          "len": a.seq_len}
        else:
            g["value"] = {"cache": self.pool.read(a.slot), "len": a.seq_len}

    def _cancel_media_job(self, request_id: int) -> None:
        """Drop a request's media job (abort/failure): deregister it from
        every in-flight encode task; a task left with no waiters is dropped
        before it costs an encoder invocation."""
        job = self._media_jobs.pop(request_id, None)
        if job is None:
            return
        for h in {it.hash for it in job.items if it.emb is None}:
            task = self._encode_tasks.get(h)
            if task is None:
                continue
            task.waiters = [j for j in task.waiters if j is not job]
            if not task.waiters:
                del self._encode_tasks[h]

    def _dispatch_encode_wave(self) -> None:
        """Run up to ``encode_wave`` unique pending encodes (most urgent
        waiter first, policy order), delivering each embedding to *all*
        waiters.  Called between the decode-block dispatch and the token
        sync, so the host encoder work overlaps the device block."""
        if not self._encode_tasks:
            return
        key = self.scheduler.policy.key
        order = sorted(self._encode_tasks.values(),
                       key=lambda t: min(key(j.req) for j in t.waiters))
        self.media_stats.encode_waves += 1
        for task in order[:self.encode_wave or len(order)]:
            del self._encode_tasks[task.hash]
            if not task.waiters:
                continue
            try:
                emb = task.encoder(task.pixels)
            except Exception as e:       # per-request fault boundary
                for job in list(task.waiters):
                    self._fault_events.extend(self._fail_request(
                        job.req.request_id, f"media encode failed: {e}"))
                continue
            self.media_stats.encoder_invocations += 1
            if self.content_cache is not None:
                self.content_cache.put_embedding(
                    task.hash, EmbeddingEntry(emb, emb.nbytes))
            for job in task.waiters:
                for item in job.items:
                    if item.hash == task.hash and item.emb is None:
                        item.emb = emb
                        job.remaining -= 1

    def _assemble_media(self, items: List[_MediaItem]):
        """Pack resolved items' embeddings into the fixed context window
        (cursor walk in context order): (embeds [1, T, De], ctx_valid
        [1, T], set digest or None).  No items (a text request on a vision
        model) gives an empty, all-invalid window."""
        embeds = np.zeros((self.ctx_len, self.embed_dim), np.float32)
        valid = np.zeros((self.ctx_len,), bool)
        cursor = 0
        for item in items:
            take = min(item.ntok, self.ctx_len - cursor)
            embeds[cursor:cursor + take] = item.emb[:take]
            valid[cursor:cursor + take] = True
            cursor += take
        digest = media_set_digest([it.hash for it in items]) if items else None
        return embeds[None], valid[None], digest

    def _media_pipeline(self, req: Request):
        """Synchronous resolution of a request's media set (the re-prefill
        of a preempted request whose snapshot was lost, or a request
        without a media job): embedding-cache hits, else one encoder call
        per payload, counted as the encode waves count them; assembled as
        :meth:`_assemble_media` assembles a job's items."""
        ms = self.media_stats
        items: List[_MediaItem] = []
        for payload, encoder, ntok in self._iter_media_payloads(req):
            pixels = decode_media(payload)
            item = _MediaItem(content_hash(pixels), ntok)
            entry = (self.content_cache.get_embedding(item.hash)
                     if self.content_cache is not None else None)
            if entry is None:
                item.emb = encoder(pixels)
                ms.encoder_invocations += 1
                req.vision_cache_misses += 1
                ms.embed_misses += 1
                if self.content_cache is not None:
                    self.content_cache.put_embedding(
                        item.hash, EmbeddingEntry(item.emb, item.emb.nbytes))
            else:
                item.emb = entry.embeddings
                req.vision_cache_hits += 1
                ms.embed_hits += 1
            items.append(item)
        return self._assemble_media(items)

    # ------------------------------------------------------------------ #
    # cross-KV extraction / injection (content cache payloads)
    # ------------------------------------------------------------------ #
    @staticmethod
    def _extract_xkv(cache):
        """Every cross-attention layer's ``xk``/``xv`` of a batch=1 row, as
        device clones (an entry never pins or aliases a wave cache)."""
        def pick(sub):
            return {k: v.clone() for k, v in (sub or {}).items()
                    if k in ("xk", "xv")}

        block = {pos: pick(sub)
                 for pos, sub in (cache.get("block") or {}).items()}
        return {"prefix": [pick(c) for c in cache["prefix"]],
                "block": {pos: x for pos, x in block.items() if x}}

    @staticmethod
    def _inject_xkv(cache, xkv):
        """A new batch=1 cache tree whose cross-KV leaves are the entry's
        (read-only: the next wave concatenates them into fresh storage)."""
        cache = dict(cache)
        cache["prefix"] = [{**c, **x} for c, x in zip(cache["prefix"],
                                                      xkv["prefix"])]
        if cache.get("block"):
            cache["block"] = {pos: {**sub, **xkv["block"].get(pos, {})}
                              for pos, sub in cache["block"].items()}
        return cache

    # ------------------------------------------------------------------ #
    # admission pipeline
    # ------------------------------------------------------------------ #
    def _assign_sample_key(self, req: Request) -> None:
        """Bind the request's base key once, at add_request: a function of
        the seed alone for seeded requests, a split of the engine's key
        chain otherwise.  The key lives on the request, so a resume after
        preemption or a handoff replays the same per-token stream."""
        if req.sample_key is not None:
            return
        if req.sampling.seed is not None:
            req.sample_key = request_base_key(req.sampling.seed)
        else:
            self._request_rng, req.sample_key = split(self._request_rng)

    def _resolve_sampling(self, req: Request) -> Tuple[float, float, int, float]:
        """Effective (temperature, top_p, top_k, min_p): per-request values
        with the engine knobs as fallbacks."""
        sp = req.sampling
        return (sp.temperature,
                self.top_p if sp.top_p is None else float(sp.top_p),
                self.top_k if sp.top_k is None else int(sp.top_k),
                self.min_p if sp.min_p is None else float(sp.min_p))

    def _plan_admissions(self) -> None:
        """Alg.1 lines 3-6, policy-ordered: bind pending requests to free
        slots, then — with a preemptive policy — evict the least urgent
        live slot for each strictly more urgent pending request.  The
        policy's aging clock is frozen once per pass, so the keys the
        preemption loop compares stay still while it runs."""
        self.scheduler.policy.tick(time.monotonic())
        self._admit_into_free_slots()
        if (self.preemption and self.scheduler.policy.preemptive
                and self.scheduler.pending and not self.pool.num_free):
            self._plan_preemptions()

    def _admit_into_free_slots(self) -> None:
        while (self.pool.num_free and self.scheduler.pending
               and self.scheduler.num_active < self.scheduler.max_batch):
            # requests whose embeddings are still resolving (or whose group
            # leader has not committed) are skipped without losing their
            # queue position; peeking also opens new requests' media jobs
            head = self.scheduler.peek_pending(self._admissible)
            if head is None:
                break
            if (self.faults is not None
                    and self.faults.fires("pool", head.request_id,
                                          self._fault_tick)):
                # transient slot-allocation failure: the request stays
                # pending and retries next step (a fresh draw)
                break
            slot = self.pool.allocate()
            admitted = self.scheduler.admit([slot], self._admissible)
            if not admitted:
                self.pool.free(slot)
                break
            _, req = admitted[0]
            try:
                self._bind_slot(slot, req)
            except Exception as e:  # per-request fault boundary (prefill)
                self._fault_events.extend(self._fail_request(
                    req.request_id, f"prefill open failed: {e}"))

    def _bind_slot(self, slot: int, req: Request) -> None:
        """Attach an admitted request to its slot: restore its eviction
        snapshot (a preempted request), adopt its speculative prefill
        progress, or open a prefill job — of the prompt + generated history
        when the snapshot was lost (the commit then samples the next token
        from the last position).  A first binding ends the request's
        ``request.queue`` span, from its arrival."""
        if TRACER.on and not req.preempt_count:
            TRACER.record("request.queue", req.arrival_time,
                          time.monotonic(), rid=req.request_id)
        if ((req.preempt_count or req.request_id in self._evicted)
                and self._try_resume(slot, req)):
            return
        job = self._spec_jobs.pop(req.request_id, None)
        if job is not None:
            job.slot = slot
            req.status = RequestStatus.PREFILLING
            self.scheduler.stats.spec_admitted += 1
            if job.logits is not None:   # the whole prompt is materialised
                self._ready_jobs.append(job)
            else:
                self.scheduler.enqueue_prefill(job)
            return
        tokens = (req.prompt_tokens + req.output_tokens
                  if req.preempt_count else None)
        self.scheduler.enqueue_prefill(
            self._open_prefill(slot, req, tokens=tokens))

    def _open_prefill(self, slot: Optional[int], req: Request,
                      tokens: Optional[List[int]] = None) -> _PrefillJob:
        """Open a request's prefill job (``slot=None``: a speculative job
        for a request that is still pending)."""
        t0 = time.monotonic()
        if self.faults is not None:
            self.faults.check("prefill", req.request_id,
                              detail=f"request {req.request_id}")
        tokens = list(req.prompt_tokens if tokens is None else tokens)
        if not tokens:
            raise ValueError("empty prompt")
        self.scheduler.stats.prompt_tokens += len(tokens)
        if slot is not None:
            req.status = RequestStatus.PREFILLING
        embeds = ctx_valid = set_digest = None
        if self.media_kind != "none":
            # resolved by encode waves / embedding-cache hits ahead of
            # admission: assembly only, no encoder work on this path; a
            # request without a job (text, or a lost snapshot's re-prefill)
            # resolves synchronously
            job = self._media_jobs.pop(req.request_id, None)
            if job is None:
                embeds, ctx_valid, set_digest = self._media_pipeline(req)
            elif job.remaining:
                raise AssertionError(f"request {req.request_id} admitted "
                                     "with unresolved media")
            else:
                embeds, ctx_valid, set_digest = self._assemble_media(
                    job.items)
        req.media_set_digest = set_digest
        # n > 1 fan-out: a follower resumes from its group leader's
        # committed prompt cache (an identical prompt, so the longest
        # possible match, capped to leave >=1 token for the logits) — with
        # the prefix cache off too
        matched, single = 0, None
        gvalue = self._group_value(req)
        if gvalue is not None and len(tokens) == len(req.prompt_tokens):
            matched = min(gvalue["len"], len(tokens) - 1)
            single = self._lease_value(req, gvalue, matched)
            req.cached_prefix_len = matched
            self.group_stats["shared_admits"] += 1
            self._group_consume(req)
        elif req.group_leader is not None \
                and not req.metadata.get("group_done"):
            # the group is gone (leader died, value dropped): independent
            self.group_stats["independent_fallbacks"] += 1
            self._group_consume(req)
        # Alg.2: longest cached prefix (cap: leave >=1 token for logits)
        if single is None and self.prefix_cache is not None:
            value, matched = self.prefix_cache.lookup(
                tokens, salt=self._salt(req), max_len=len(tokens) - 1)
            if value is not None:
                single = self._lease_value(req, value, matched)
                req.cached_prefix_len = matched
            else:
                matched = 0
        if single is None:
            single = self.pool.single_cache_zeros()
        # Alg.3: cross-KV reuse (skip the context projection in every layer)
        cross_cached = False
        if set_digest is not None and self.content_cache is not None:
            entry = self.content_cache.get_cross_kv(set_digest)
            if entry is not None:
                single = self._inject_xkv(single, entry.xkv)
                cross_cached = True
                self.media_stats.xkv_hits += 1
            else:
                self.media_stats.xkv_misses += 1
        return _PrefillJob(
            slot=slot, req=req, tokens=tokens, cache=single, consumed=matched,
            embeds=embeds, ctx_valid=ctx_valid, cross_cached=cross_cached,
            publish_xkv=(set_digest is not None
                         and self.content_cache is not None
                         and not cross_cached),
            t0=t0)

    def _lease_value(self, req: Request, value: Dict[str, Any],
                     matched: int) -> Any:
        """The dense row a prefill resumes from, out of a prefix-cache or
        group value.  A paged value's full pages inside the match are
        leased COW — pinned against eviction until the commit transfers
        them to the slot (zero cache-copy admission)."""
        if "pages" not in value:
            return value["cache"]
        ps = self.pool.page_size
        shared = list(value["pages"][:min(matched // ps, len(value["pages"]))])
        if shared:
            self.pool.incref_pages(shared)
            self._release_lease(req.request_id)
            self._job_leases[req.request_id] = shared
        return value["dense"]

    def _dispatch_prefill_wave(self) -> List[Tuple[_PrefillJob, torch.Tensor]]:
        """Advance every queued prefill job by one chunk; returns (job,
        logits row) for jobs whose prompt is now fully materialised."""
        jobs = self.scheduler.pop_prefill_wave()
        if not jobs:
            return []
        groups: Dict[Tuple[int, bool], List[Tuple[_PrefillJob, int]]] = {}
        for job in jobs:
            remaining = len(job.tokens) - job.consumed
            take = (remaining if self.prefill_chunk == 0
                    else min(self.prefill_chunk, remaining))
            # every chunk fits the KV ring, and one row's slot indices stay
            # distinct mod cache_len (reference :1385-1393)
            take = min(take, self.pool.cache_len)
            bucket = min(self._plan_bucket(take), self.pool.cache_len)
            groups.setdefault((bucket, job.cross_cached),
                              []).append((job, take))
        if self.speculative_fill:
            self._backfill_groups(groups)
        completed: List[Tuple[_PrefillJob, torch.Tensor]] = []
        for (bucket, cross_cached), rows in groups.items():
            try:
                completed.extend(
                    self._run_wave_group(bucket, cross_cached, rows))
            except Exception as e:  # wave-group fault boundary
                self._fail_wave(rows, e)
        return completed

    def _fail_wave(self, rows: List[Tuple[_PrefillJob, int]],
                   exc: Exception) -> None:
        """One batched prefill pass raised: fail the slot-bound requests
        riding it (their partial caches are lost) with typed ERROR events,
        and drop its speculative rows back to pending — that work was
        optional, so those requests simply prefill again later.  Other wave
        groups and every decode slot are untouched."""
        log.warning("prefill wave group failed (%d rows): %s", len(rows), exc)
        for job, _ in rows:
            if job.slot is not None:
                self._fault_events.extend(self._fail_request(
                    job.req.request_id, f"prefill wave failed: {exc}"))
            else:
                self._spec_jobs.pop(job.req.request_id, None)
                self._release_lease(job.req.request_id)

    def _backfill_groups(
            self, groups: Dict[Tuple[int, bool],
                               List[Tuple[_PrefillJob, int]]]) -> None:
        """Speculative wave filling: a group of k rows runs at the next
        power of two anyway, so its kp - k padding rows are free compute —
        fill them with the next chunk of in-flight speculative jobs, then
        the *first* chunk of the most urgent not-yet-admitted pending
        requests (policy order).  A speculative chunk is capped at the
        group's bucket; the forward's shape never changes, only dummy rows
        are replaced."""
        key = self.scheduler.policy.key
        waiting = sorted((j for j in self._spec_jobs.values()
                          if j.logits is None), key=lambda j: key(j.req))
        fresh = [r for r in self.scheduler.pending_in_order()
                 if r.request_id not in self._spec_jobs
                 and not r.preempt_count and self._admissible(r)]
        for (bucket, cross_cached), rows in groups.items():
            kp = 1 << (len(rows) - 1).bit_length()
            while len(rows) < kp:
                job = next((j for j in waiting
                            if j.cross_cached == cross_cached), None)
                if job is not None:
                    waiting.remove(job)
                elif fresh and len(self._spec_jobs) < self.max_spec_jobs:
                    req = fresh.pop(0)
                    try:
                        cand = self._open_prefill(None, req)
                    except Exception as e:  # per-request fault boundary
                        self._fault_events.extend(self._fail_request(
                            req.request_id, f"prefill open failed: {e}"))
                        continue
                    self._spec_jobs[req.request_id] = cand
                    self.scheduler.stats.spec_jobs += 1
                    if cand.cross_cached != cross_cached:
                        # parked for a later matching wave; hunting on for
                        # a match could open a job per pending request
                        break
                    job = cand
                else:
                    break
                rows.append((job, min(len(job.tokens) - job.consumed,
                                      bucket)))
                self.scheduler.stats.spec_chunks += 1

    def _run_wave_group(self, bucket: int, cross_cached: bool,
                        rows: List[Tuple[_PrefillJob, int]]
                        ) -> List[Tuple[_PrefillJob, torch.Tensor]]:
        k = len(rows)
        kp = 1 << (k - 1).bit_length()               # pad rows to power of two
        toks = np.zeros((kp, bucket), np.int64)
        # dummy rows keep distinct positions so their (masked, no-op) cache
        # writes never index one cell twice
        poss = np.broadcast_to(np.arange(bucket, dtype=np.int64),
                               (kp, bucket)).copy()
        valid = np.zeros((kp, bucket), bool)
        last_idx = np.zeros((kp,), np.int64)
        singles = []
        for i, (job, take) in enumerate(rows):
            toks[i, :take] = job.tokens[job.consumed:job.consumed + take]
            poss[i] = job.consumed + np.arange(bucket, dtype=np.int64)
            valid[i, :take] = True
            last_idx[i] = take - 1
            singles.append(job.cache)
        singles.extend(self.pool.single_cache_zeros() for _ in range(kp - k))
        dev = self.device
        media = ctxv = None
        if self.media_kind != "none":
            zero_e = np.zeros((1, self.ctx_len, self.embed_dim), np.float32)
            zero_v = np.zeros((1, self.ctx_len), bool)
            media = torch.from_numpy(np.concatenate(
                [job.embeds for job, _ in rows] + [zero_e] * (kp - k))).to(dev)
            ctxv = torch.from_numpy(np.concatenate(
                [job.ctx_valid for job, _ in rows] + [zero_v] * (kp - k))
            ).to(dev)
        logits, out_cache = self._prefill(
            torch.from_numpy(toks).to(dev), torch.from_numpy(poss).to(dev),
            singles, torch.from_numpy(valid).to(dev),
            torch.from_numpy(last_idx).to(dev), media, ctxv, cross_cached)
        stats = self.scheduler.stats
        stats.prefill_waves += 1
        stats.prefill_chunks += k

        done: List[Tuple[_PrefillJob, torch.Tensor]] = []
        for i, (job, take) in enumerate(rows):
            job.cache = slice_cache_row(out_cache, i)
            job.consumed += take
            if job.publish_xkv:
                self._publish_xkv(job)
            if job.consumed >= len(job.tokens):
                if job.slot is None:
                    # a speculative job done before a slot freed: stage its
                    # last-position logits; admission commits it directly
                    job.logits = logits[i]
                else:
                    done.append((job, logits[i]))
                continue
            self._publish_partial(job)
            if job.slot is not None:
                self.scheduler.enqueue_prefill(job)
            # a speculative job stays in _spec_jobs and rides a later wave
        return done

    def _publish_xkv(self, job: _PrefillJob) -> None:
        """Publish the job's cross KV for future identical media sets (the
        first chunk materialises every layer's ``xk``/``xv``).  Under the
        paged layout the entry leases accounting pages of the arena, so the
        pressure ladder governs device-resident media like a slot's pages;
        if the arena cannot spare them the publication is skipped."""
        xkv = self._extract_xkv(job.cache)
        nbytes = tree_bytes(xkv)
        pages = self._lease_xkv_pages(nbytes)
        if pages is None:
            self.media_stats.xkv_publish_skipped += 1
        else:
            self.content_cache.put_cross_kv(
                job.req.media_set_digest,
                CrossKVEntry(xkv, self.ctx_len, nbytes, pages=pages))
        job.publish_xkv = False

    def _publish_partial(self, job: _PrefillJob) -> None:
        """Alg.2, per chunk: publish the partial prefix so an identical long
        prompt arriving behind this one resumes from finished chunks.
        Rolling: each boundary replaces the job's previous entry, so one
        in-flight prompt holds at most one partial cache in the byte
        budget.  The entry owns its row (a clone, not a view pinning the
        whole wave cache); the job continues from that same row, which
        nothing writes into (the next wave concatenates it afresh)."""
        if self.prefix_cache is None or \
                job.consumed < self.prefix_cache.block_size:
            return
        salt = self._salt(job.req)
        prefix = job.tokens[:job.consumed]
        new_key = self.prefix_cache.key_for(prefix, salt=salt)
        job.cache = tree_map(torch.clone, job.cache)
        self.prefix_cache.insert(
            prefix, {"cache": job.cache, "len": job.consumed},
            tree_bytes(job.cache), salt=salt)
        if job.partial_key and job.partial_key != new_key:
            self.prefix_cache.discard(job.partial_key)
        job.partial_key = new_key

    def _commit_jobs(self, completed: List[Tuple[_PrefillJob, torch.Tensor]]
                     ) -> List[StreamEvent]:
        """Sample first tokens for the finished wave (one batched call, one
        host sync) and land the admissions in pool + decode state."""
        if not completed:
            return []
        jobs = [j for j, _ in completed]
        logits = torch.stack([lg for _, lg in completed]).float()   # [k, V]
        # first tokens use the decode block's sampler: key = fold_in(base,
        # position-of-the-new-token), parameters through the same fallbacks
        samp = [self._resolve_sampling(j.req) for j in jobs]
        dev = self.device
        firsts = masked_sample_inner(
            logits,
            torch.from_numpy(keys_array([j.req.sample_key for j in jobs])
                             ).to(dev),
            torch.tensor([len(j.tokens) for j in jobs], device=dev),
            torch.tensor([s[0] for s in samp], device=dev),
            torch.tensor([s[1] for s in samp], device=dev),
            torch.tensor([s[2] for s in samp], device=dev),
            torch.tensor([s[3] for s in samp], device=dev),
            any_stochastic=any(s[0] > 0 for s in samp),
            any_mask=any(s[1] < 1.0 or s[2] > 0 or s[3] > 0 for s in samp)
        ).cpu().numpy()
        lp = (torch.log_softmax(logits, dim=-1).cpu().numpy()
              if any(j.req.sampling.logprobs for j in jobs) else None)
        now = time.monotonic()
        wave = []
        for i, (job, first) in enumerate(zip(jobs, firsts)):
            req = job.req
            if req.first_token_time is None:
                if TRACER.on:
                    TRACER.record("request.prefill", job.t0, now,
                                  rid=req.request_id)
                req.first_token_time = now
            req.output_tokens.append(int(first))
            logprob = top = None
            if lp is not None and req.sampling.logprobs:
                logprob, top = self._top_logprobs(lp[i], int(first),
                                                  req.sampling.top_logprobs)
            wave.append(_Admission(
                job.slot, req, job.cache, int(first),
                None if job.ctx_valid is None else job.ctx_valid[0],
                seq_len=len(job.tokens), logprob=logprob, top_logprobs=top))
        return self._commit_admissions(wave)

    @staticmethod
    def _top_logprobs(row: np.ndarray, token: int, n: int
                      ) -> Tuple[float, List[Tuple[int, float]]]:
        """(chosen logprob, top-n (token_id, logprob) pairs) from one [V]
        log-softmax row."""
        top: List[Tuple[int, float]] = []
        if n > 0:
            ids = np.argsort(row)[::-1][:n]
            top = [(int(t), float(row[t])) for t in ids]
        return float(row[token]), top

    def _commit_admissions(self, wave: List[_Admission]) -> List[StreamEvent]:
        """Land an admission wave: one cache copy into the pool, one
        decode-state scatter, then per-request stream/finish bookkeeping."""
        if self._paged:
            self._paged_insert_wave(wave)
        else:
            self.pool.insert_many([a.slot for a in wave],
                                  [a.single_cache for a in wave])
        self._live_slots.update(a.slot for a in wave)
        for a in wave:
            self._group_publish(a)
        events: List[StreamEvent] = []
        for a in wave:
            # a request resumed by re-prefill keeps its streamer (its
            # mid-UTF-8 decode state survives the eviction)
            if a.req.request_id not in self._streamers:
                self._streamers[a.req.request_id] = TokenStreamDecoder(
                    self.tokenizer)
                if a.req.sampling.stop_sequences:
                    self._stopchk[a.req.request_id] = StopSequenceChecker(
                        list(a.req.sampling.stop_sequences))
            a.req.status = RequestStatus.DECODING
            try:
                events.extend(self._emit_token(a.slot, a.req, a.first_token,
                                               a.logprob, a.top_logprobs))
            except Exception as e:  # per-request fault boundary (codec)
                self._fault_events.extend(self._fail_request(
                    a.req.request_id, f"codec failure: {e}"))
        self._admit_rows_to_state(
            [(a.slot, a.req, a.first_token, a.seq_len, a.ctx_valid,
              not a.req.is_finished) for a in wave])
        return events

    def _paged_insert_wave(self, wave: List[_Admission]) -> None:
        """Paged admission: each row's COW-leased prefix pages map into the
        slot's table with zero copies (the lease's refs transfer), fresh
        pages are allocated only past the shared prefix, and the dense
        prefill row is copied into those fresh pages alone.  On arena
        exhaustion, prefix-cache entries are evicted (freeing their leased
        pages) and the insert retried; leases are popped only after
        success, so an abort before then still releases them."""
        slots = [a.slot for a in wave]
        singles = [a.single_cache for a in wave]
        consumed = [a.seq_len for a in wave]
        shared = [self._job_leases.get(a.req.request_id, ())
                  for a in wave]
        while True:
            try:
                self.pool.insert_many(slots, singles, consumed=consumed,
                                      shared=shared)
                break
            except PagePoolExhausted:
                if self._evict_cache_entry():
                    continue
                raise
        for a in wave:                  # lease ownership moved to the slot
            self._job_leases.pop(a.req.request_id, None)
        # Alg.2 publication at *commit* (the dense pool publishes at retire):
        # the slot's full prompt pages are shared into the prefix cache now,
        # so an identical prompt admitted while this one still decodes maps
        # the same pages COW.  A ring wrap never corrupts the entry:
        # wrapping writes COW-split first.  The dense shadow row is cloned
        # out of the wave cache it is a view of.
        if self.prefix_cache is None:
            return
        ps = self.pool.page_size
        for a in wave:
            req = a.req
            toks = req.prompt_tokens + req.output_tokens[:-1]
            assert len(toks) == a.seq_len
            if len(toks) < self.prefix_cache.block_size:
                continue
            pub = list(self.pool.slot_pages(a.slot)[:a.seq_len // ps])
            self.pool.incref_pages(pub)
            dense = tree_map(torch.clone, a.single_cache)
            value = {"pages": pub, "dense": dense, "len": a.seq_len}
            nbytes = self.pool.pages_nbytes(len(pub)) + tree_bytes(dense)
            self.prefix_cache.insert(toks, value, nbytes,
                                     salt=self._salt(req))

    def _admit_rows_to_state(self, rows: List[Tuple[int, Request, int, int,
                                                    Optional[np.ndarray],
                                                    bool]]) -> None:
        """Scatter admission rows into the device decode state.  Each row:
        (slot, req, last_token, position-of-last_token, ctx_valid row or
        None, active)."""
        stops = np.full((len(rows), self.max_stop_tokens), -1, np.int64)
        ctx = np.zeros((len(rows), max(self.ctx_len, 1)), bool)
        for i, (_, req, _, _, ctx_valid, _) in enumerate(rows):
            ids = (self.tokenizer.EOS,) + tuple(req.sampling.stop_token_ids)
            stops[i, :len(ids)] = ids
            if ctx_valid is not None:
                ctx[i] = ctx_valid
        samp = [self._resolve_sampling(req) for _, req, *_ in rows]
        admit_decode_state(
            self.state, [slot for slot, *_ in rows],
            last_token=[last for _, _, last, *_ in rows],
            positions=[pos for _, _, _, pos, *_ in rows],
            temps=[s[0] for s in samp], top_p=[s[1] for s in samp],
            top_k=[s[2] for s in samp], min_p=[s[3] for s in samp],
            sample_key=[req.sample_key for _, req, *_ in rows],
            ctx_valid=ctx,
            budget=[req.sampling.max_tokens - req.num_generated
                    for _, req, *_ in rows],
            stop_tokens=stops,
            active=[act for *_, act in rows])
        for _, req, *_ in rows:
            # echo + logprobs: prompt-token logprobs are computed once, at
            # the first admission commit (a resume keeps the stored list)
            if (req.sampling.echo and req.sampling.logprobs
                    and req.prompt_logprobs is None):
                self._compute_prompt_logprobs(req)
        if self.spec_mode == "off":
            return
        # speculation joins at the same single admission point: the
        # acceptance EWMA resets optimistic, and the draft-model rung
        # re-primes its KV from the slot's committed history (a resume from
        # a preemption snapshot included)
        for slot, _, _, _, _, act in rows:
            if act:
                self.spec_controller.on_admit(slot)
        if isinstance(self._draft_source, DraftModelSource):
            for slot, req, last, pos, _, act in rows:
                base = req.prompt_tokens + req.output_tokens
                if act and len(base) >= pos:
                    self._draft_source.prime(slot, base[:pos] + [last])
                else:       # frozen, or no history: the slot never drafts
                    self._draft_source.release(slot)
            self._draft_source.admit(
                [slot for slot, *_ in rows],
                [last for _, _, last, *_ in rows],
                [pos for _, _, _, pos, *_ in rows],
                [s[0] for s in samp], [s[1] for s in samp],
                [s[2] for s in samp], [s[3] for s in samp],
                [req.sample_key for _, req, *_ in rows],
                [act for *_, act in rows])

    def _compute_prompt_logprobs(self, req: Request) -> None:
        """Teacher-forced prompt-token logprobs (OpenAI ``echo``): one
        batch=1 prefill-mode forward from position 0 over the padded prompt
        into a throwaway cache sized to the bucket — the admission
        prefill's forward, through the same attention path.  Entry i is
        log p(tok[i] | tok[:i]), gathered on the device so only the n - 1
        values reach the host (not the [bucket, vocab] log-softmax); the
        first entry is None."""
        toks = req.prompt_tokens
        n = len(toks)
        if n <= 1:
            req.prompt_logprobs = [None] * n
            return
        bucket = _next_bucket(n, floor=self._bucket_floor)
        dev = self.device
        padded = torch.zeros((1, bucket), dtype=torch.int64, device=dev)
        padded[0, :n] = torch.as_tensor(toks, device=dev)
        ar = torch.arange(bucket, device=dev)[None]
        kw = {}
        if self.media_kind != "none":    # text-only echo: an empty context
            kw = dict(ctx_valid=torch.zeros((1, self.ctx_len),
                                            dtype=torch.bool, device=dev),
                      **self._media_kw(torch.zeros(
                          (1, self.ctx_len, self.embed_dim), device=dev)))
        out = self.model.apply(
            self.params, padded, mode="prefill", positions=ar,
            cache=init_cache(self.cfg, 1, bucket, ctx_len=self.ctx_len,
                             device=dev),
            seq_valid=ar < n, **kw)
        lp = torch.log_softmax(out.logits[0, :n - 1].float(), dim=-1)
        tgt = torch.as_tensor(toks[1:], device=dev)[:, None]
        picked = torch.gather(lp, 1, tgt)[:, 0].cpu().tolist()
        req.prompt_logprobs = [None] + [float(v) for v in picked]

    # ------------------------------------------------------------------ #
    # emit / finish / abort (the host side of the request lifecycle)
    # ------------------------------------------------------------------ #
    def _emit_token(self, slot: int, req: Request, token: int,
                    logprob: Optional[float] = None,
                    top_logprobs: Optional[List[Tuple[int, float]]] = None
                    ) -> List[StreamEvent]:
        """Stream one sampled token: incremental detokenisation, host-side
        stop-sequence filtering, logprob attachment, and the finish checks."""
        if self.faults is not None:
            # keyed by (request, position): the same token of the same
            # request fails in every replay, nothing else does
            self.faults.check("codec", req.request_id, req.num_generated,
                              detail=f"request {req.request_id} "
                                     f"token {token}")
        text = self._streamers[req.request_id].push_token(token)
        chk = self._stopchk.get(req.request_id)
        stopped = False
        if chk is not None:
            text, stopped = chk.push(text)
        req.output_text += text
        if req.sampling.logprobs:
            req.output_logprobs.append((logprob, top_logprobs or []))
        events = [StreamEvent(req.request_id, token, text,
                              logprob=logprob, top_logprobs=top_logprobs)]
        if stopped:
            # host-detected finish: the device row is still live and must
            # be frozen before the slot is reused; buffered text follows
            # the match and is discarded
            events.extend(self._finish(slot, req, FinishReason.STOP,
                                       publish=False, deactivate=True,
                                       drop_tail=True))
        else:
            events.extend(self._maybe_finish(slot, req, token))
        return events

    def _maybe_finish(self, slot: int, req: Request, token: int
                      ) -> List[StreamEvent]:
        stop_ids = set(req.sampling.stop_token_ids) | {self.tokenizer.EOS}
        reason = None
        if token in stop_ids:
            reason = FinishReason.STOP
        elif req.num_generated >= req.sampling.max_tokens:
            reason = FinishReason.LENGTH
        if reason is None:
            return []
        return self._finish(slot, req, reason)

    def _finish(self, slot: int, req: Request, reason: FinishReason, *,
                publish: bool = True, deactivate: bool = False,
                drop_tail: bool = False) -> List[StreamEvent]:
        """Terminal transition: flush the streamer (through the stop
        checker), retire the slot, and emit the finished event."""
        req.finish_reason = reason
        req.finish_time = time.monotonic()
        req.status = RequestStatus.FINISHED
        tail = self._streamers.pop(req.request_id).flush()
        chk = self._stopchk.pop(req.request_id, None)
        if drop_tail:
            tail = ""
        elif chk is not None:
            safe, stopped = chk.push(tail)
            tail = safe if stopped else safe + chk.flush()
        req.output_text += tail
        self._retire(slot, req, publish=publish)
        if deactivate:
            self._deactivate_slot(slot)
        return [StreamEvent(req.request_id, None, tail,
                            finished=True, finish_reason=reason)]

    def _retire(self, slot: int, req: Request, *, publish: bool = True
                ) -> None:
        # dense layout: publish the prompt's KV to the prefix cache (Alg.2
        # insert).  Skipped if generation ring-wrapped the cache (prompt
        # cells were overwritten by generated-token KV) and for host-side
        # stop-sequence finishes (publish=False: the device kept writing
        # past the stop point for the rest of the block)
        wrapped = (len(req.prompt_tokens) + req.num_generated - 1
                   > self.pool.cache_len)
        if publish and self.prefix_cache is not None and not wrapped and \
                not self._paged and \
                len(req.prompt_tokens) >= self.prefix_cache.block_size:
            single = self.pool.read(slot)
            value = {"cache": single, "len": len(req.prompt_tokens)}
            self.prefix_cache.insert(req.prompt_tokens, value,
                                     tree_bytes(single), salt=self._salt(req))
        self.scheduler.retire(slot)
        self.pool.free(slot)
        self._live_slots.discard(slot)
        self._spec_release(slot)

    def _spec_release(self, slot: int) -> None:
        """Drop a slot's speculation state (EWMA entry, draft-pool primed
        mark) when it detaches from its request — retire, eviction, abort
        or failure; a resumed request re-primes at admission."""
        if self.spec_mode != "off":
            self.spec_controller.release(slot)
            self._draft_source.release(slot)

    def _deactivate_slot(self, slot: int) -> None:
        """Freeze a slot's device row: the next decode block masks its
        cache writes and stops advancing its position."""
        self.state.active[slot] = False

    def abort(self, request_id: int) -> List[StreamEvent]:
        """Cancel a request wherever it lives — pending queue (its media
        job and its share of in-flight encodes included), prefill chunk
        queue, eviction-snapshot table (the snapshot is released), or a
        live decode slot (freed at once, device row frozen).
        Returns the final ABORT event (empty if unknown or finished).  Not
        thread-safe: callers off the engine thread go through
        :meth:`repro_torch.serving.client.EngineClient.abort`."""
        return self._terminate(request_id, FinishReason.ABORT)

    def _fail_request(self, request_id: int, detail: str
                      ) -> List[StreamEvent]:
        """Fail ONE request with a typed ERROR finish wherever it lives
        (:meth:`abort`'s cleanup); every other request is untouched."""
        log.warning("request %d failed: %s", request_id, detail)
        return self._terminate(request_id, FinishReason.ERROR, detail)

    def _terminate(self, request_id: int, reason: FinishReason,
                   detail: Optional[str] = None) -> List[StreamEvent]:
        """Abort (``reason`` ABORT) or fail (ERROR, with ``detail``) one
        request wherever it lives; every other request is untouched."""
        req = self._release_request(request_id)
        if req is None or req.is_finished:
            return []
        self._group_on_terminate(req)
        self._cancel_media_job(request_id)
        self._drop_snapshot(req)
        req.finish_reason = reason
        req.finish_time = time.monotonic()
        if reason is FinishReason.ABORT:
            req.status = RequestStatus.ABORTED
            self.scheduler.stats.aborted += 1
        else:
            req.status = RequestStatus.FAILED
            req.error = detail
            self.scheduler.stats.failed += 1
        self._streamers.pop(request_id, None)
        self._stopchk.pop(request_id, None)
        return [StreamEvent(request_id, None, "", finished=True,
                            finish_reason=reason)]

    def _release_request(self, request_id: int) -> Optional[Request]:
        """Free what a request holds wherever it lives — its slot (freed,
        device row frozen), its queued or staged prefill, its speculative
        job, or its pending entry — and its page lease; returns the request
        (None if unknown).  Shared by :meth:`_terminate` and
        :meth:`_detach`."""
        slot = next((s for s, r in self.scheduler.active.items()
                     if r.request_id == request_id), None)
        if slot is not None:
            req = self.scheduler.active[slot]
            self.scheduler.drop_prefill_jobs(request_id)
            self._staged = [(j, lg) for j, lg in self._staged
                            if j.req.request_id != request_id]
            self._ready_jobs = [j for j in self._ready_jobs
                                if j.req.request_id != request_id]
            self.scheduler.abort_slot(slot)
            self.pool.free(slot)
            self._live_slots.discard(slot)
            self._spec_release(slot)
            self._deactivate_slot(slot)
        else:
            req = self.scheduler.abort_pending(request_id)
            job = self._spec_jobs.pop(request_id, None)
            if job is not None:
                req = req or job.req
        self._release_lease(request_id)
        return req

    def _drop_snapshot(self, req: Request) -> None:
        """Release a request's preemption snapshot (byte budget, page
        leases), if it has one."""
        meta = self._evicted.pop(req.request_id, None)
        if meta is None:
            return
        self._release_snapshot_value(meta["cache"])
        if self.prefix_cache is not None:
            self._release_snapshot_value(self.prefix_cache.take_exact(
                req.prompt_tokens + req.output_tokens, salt=self._salt(req)))

    def _recover_decode_block(self, exc: Exception) -> None:
        """A decode block or verify round raised (not a per-request fault).
        It writes the pool's cache, the decode state and the draft pool in
        place, so all three are garbage now: every live request fails with
        a typed ERROR event, the buffers are rebuilt from scratch, and
        pending and mid-prefill requests — whose partial caches ride on
        their jobs, outside the pool — continue.  Every reference to the
        old arena is dropped before the fresh one is built, so the device
        never holds two."""
        log.error("decode block failed: %s — failing %d live request(s) "
                  "and rebuilding device buffers", exc,
                  len(self._live_slots))
        # the raising frames hold the old cache: drop them first, and the
        # decode graphs, which hold it and read it by address
        traceback.clear_frames(exc.__traceback__)
        exc.__traceback__ = None
        self._decode_graphs = None
        old, self.pool.cache = self.pool, None
        self.state = init_decode_state(old.max_batch, self.max_stop_tokens,
                                       ctx_len=self.ctx_len,
                                       spec_k=self.spec_k, device=self.device)
        if isinstance(self._draft_source, DraftModelSource):
            # the draft pool was written by the failed round too; slots
            # re-prime at re-admission
            self._draft_source.reset()
        for slot in sorted(self._live_slots):
            req = self.scheduler.active.get(slot)
            if req is not None:
                self._fault_events.extend(self._fail_request(
                    req.request_id, f"decode block failed: {exc}"))
        if self._paged:
            # every page lease died with the arena: prefix-cache entries
            # and job leases point into the old allocator, so they drop
            # without release callbacks (clear() fires none); cross-KV
            # entries keep their own buffers and lose only their leases;
            # paged snapshots and group values lose their pages
            if self.prefix_cache is not None:
                self.prefix_cache.clear()
            self._job_leases.clear()
            if self.content_cache is not None:
                self.content_cache.detach_page_leases()
            self.media_stats.xkv_lease_pages = 0
            for m in self._evicted.values():
                if isinstance(m.get("cache"), dict) and \
                        m["cache"].get("pages"):
                    m["cache"] = None
            for g in self._prefill_groups.values():
                if isinstance(g.get("value"), dict) and \
                        "pages" in g["value"]:
                    g["value"]["pages"] = []
            self.pool = PagedKVPool(
                self.cfg, old.max_batch, old.cache_len, ctx_len=self.ctx_len,
                page_size=old.page_size, num_pages=old.num_pages,
                kv_dtype=old.kv_dtype, device=self.device)
        else:
            self.pool = SlotKVPool(self.cfg, old.max_batch, old.cache_len,
                                   ctx_len=self.ctx_len, device=self.device)
        # slot bookkeeping carries over: slots of mid-prefill requests stay
        # used, and their commit lands in the fresh buffers
        self.pool._free = list(old._free)
        self.pool._used = set(old._used)

    def drain_snapshot(self) -> List[StreamEvent]:
        """The drain cutoff (:meth:`EngineClient.drain` timed out): publish
        every live slot's exact sequence to the prefix cache — the entry a
        preemption writes, on pages by incref'd reference — so a warm
        restart resumes the work, then abort everything still open.  Every
        open request gets its terminal ABORT event."""
        if self.prefix_cache is not None:
            for slot in sorted(self._live_slots):
                req = self.scheduler.active[slot]
                seq = req.prompt_tokens + req.output_tokens
                if self._paged:
                    pages = list(self.pool.slot_pages(slot))
                    nonkv = self.pool.read_nonkv(slot)
                    self.pool.incref_pages(pages)
                    self.prefix_cache.insert_exact(
                        seq, {"pages": pages, "nonkv": nonkv,
                              "len": len(seq)},
                        self.pool.pages_nbytes(len(pages))
                        + tree_bytes(nonkv), salt=self._salt(req))
                else:
                    single = self.pool.read(slot)
                    self.prefix_cache.insert_exact(
                        seq, {"cache": single}, tree_bytes(single),
                        salt=self._salt(req))
        open_ids = [r.request_id for r in self.scheduler.active.values()]
        open_ids += [r.request_id for r in self.scheduler.pending_in_order()]
        open_ids += list(self._spec_jobs)
        events: List[StreamEvent] = []
        for rid in dict.fromkeys(open_ids):
            events.extend(self.abort(rid))
        events.extend(self._fault_events)
        self._fault_events.clear()
        return events

    # ------------------------------------------------------------------ #
    # handoff between engines (a rolling restart)
    # ------------------------------------------------------------------ #
    def export_handoff(self) -> List[Dict[str, Any]]:
        """Capture every open request as a record another engine resumes
        bit-identically, then detach them all without finish events (the
        requests stay alive; their handles move with the records).

        A live text slot exports a dense snapshot (``pool.read``: a paged
        slot's pages gathered into one row) and its codec state
        (mid-UTF-8 decoder, stop-sequence holdback); the successor restores
        it through :meth:`_try_resume`, as a preemption resume.  Everything
        else — pending, mid-prefill, speculative, preempted and media
        requests — exports as a queue record that re-prefills its prompt +
        history.  The sample key travels on the request itself."""
        records: List[Dict[str, Any]] = []
        for slot in sorted(self._live_slots):
            req = self.scheduler.active.get(slot)
            if req is None or req.is_finished or self._has_media(req):
                continue                 # a media slot: a queue record
            records.append({
                "req": req, "cache": {"cache": self.pool.read(slot)},
                "ctx_valid": None,
                "streamer": self._streamers.get(req.request_id),
                "stopchk": self._stopchk.get(req.request_id)})
        seen = {r["req"].request_id for r in records}
        others = list(self.scheduler.active.values())
        others += self.scheduler.pending_in_order()
        others += [j.req for j in self._spec_jobs.values()]
        for req in others:
            if req.request_id in seen or req.is_finished:
                continue
            seen.add(req.request_id)
            records.append({
                "req": req, "cache": None, "ctx_valid": None,
                "streamer": self._streamers.get(req.request_id),
                "stopchk": self._stopchk.get(req.request_id)})
        for rec in records:
            self._detach(rec["req"])
        return records

    def _detach(self, req: Request) -> None:
        """Release everything a request holds — :meth:`abort`'s cleanup —
        WITHOUT finishing it: no terminal event, status back to QUEUED."""
        rid = req.request_id
        self._release_request(rid)
        self._group_on_terminate(req)
        self._cancel_media_job(rid)
        self._drop_snapshot(req)
        self._streamers.pop(rid, None)
        self._stopchk.pop(rid, None)
        req.status = RequestStatus.QUEUED

    def import_handoff(self, rec: Dict[str, Any]) -> None:
        """Adopt one exported record: a record with a cache snapshot seeds
        the eviction-resume table, so :meth:`_bind_slot` restores the slot
        through :meth:`_try_resume` (no re-prefill); a record without one
        re-prefills prompt + history.  The codec state is installed ahead
        of admission; the request's sample key survives the hop."""
        req = rec["req"]
        rid = req.request_id
        self._assign_sample_key(req)
        if rec.get("streamer") is not None:
            self._streamers[rid] = rec["streamer"]
        if rec.get("stopchk") is not None:
            self._stopchk[rid] = rec["stopchk"]
        if rec.get("cache") is not None:
            self._evicted[rid] = {"cache": rec["cache"],
                                  "ctx_valid": rec.get("ctx_valid")}
        elif req.output_tokens:
            # mid-generation without a snapshot: re-prefill the history
            req.preempt_count = max(1, req.preempt_count)
        req.status = RequestStatus.QUEUED
        self.scheduler.add(req)

    # ------------------------------------------------------------------ #
    # slot preemption (policy-gated eviction of live decode slots)
    # ------------------------------------------------------------------ #
    def _rebuildable(self, slot: int) -> bool:
        """A victim must be exactly rebuildable if its snapshot is later
        lost: re-prefill can only represent a history that fits the ring
        without wrapping, so a slot whose prompt + generated history
        reached ``cache_len`` is exempt (it also frees soonest by just
        finishing)."""
        req = self.scheduler.active[slot]
        return (len(req.prompt_tokens) + req.num_generated
                <= self.pool.cache_len)

    def _plan_preemptions(self) -> None:
        """Evict the least urgent live slot while the most urgent pending
        request is *strictly* more urgent than it.  Keys are static per
        request, so each eviction strictly improves the active set and the
        loop ends; ``max_preemptions`` caps each request's evictions."""
        key = self.scheduler.policy.key
        while self.scheduler.pending and not self.pool.num_free:
            head = self.scheduler.peek_pending(self._admissible)
            eligible = {s for s in self._live_slots if self._rebuildable(s)}
            victim = self.scheduler.select_victim(eligible,
                                                  self.max_preemptions)
            if head is None or victim is None:
                return
            vslot, vreq = victim
            if not key(head) < key(vreq):
                return
            self._evict(vslot)
            self._admit_into_free_slots()

    def _evict(self, slot: int, *, snapshot: bool = True) -> None:
        """Evict a live decode slot back to the pending queue.  The
        snapshot — a copy of the slot's row on the dense ring, the slot's
        pages by reference (incref'd, zero copy) plus its dense per-slot
        leaves on the paged arena — is published as an exact-sequence
        prefix-cache entry keyed by the prompt + generated history, or held
        engine-side when the cache is off (at most ``max_batch`` of them,
        the oldest dropped to the re-prefill path).  ``snapshot=False``
        (page-pressure preemption) keeps none, so the pages really free."""
        req = self.scheduler.active[slot]
        meta: Dict[str, Any] = {
            "cache": None,
            "ctx_valid": (self.state.ctx_valid[slot].cpu().numpy()
                          if self.media_kind != "none" else None),
        }
        value = None
        if self._paged:
            if snapshot:
                pages = list(self.pool.slot_pages(slot))
                value = {"pages": pages, "nonkv": self.pool.read_nonkv(slot),
                         "len": len(req.prompt_tokens) + req.num_generated}
                nbytes = (self.pool.pages_nbytes(len(pages))
                          + tree_bytes(value["nonkv"]))
                self.pool.incref_pages(pages)
        else:
            value = {"cache": self.pool.read(slot)}
            nbytes = tree_bytes(value["cache"])
        if value is not None:
            if self.prefix_cache is not None:
                self.prefix_cache.insert_exact(
                    req.prompt_tokens + req.output_tokens, value, nbytes,
                    salt=self._salt(req))
            else:
                meta["cache"] = value
        self._evicted[req.request_id] = meta
        req.status = RequestStatus.QUEUED
        if self.prefix_cache is None:
            holders = [rid for rid, m in self._evicted.items()
                       if m["cache"] is not None]
            for rid in holders[:-self.pool.max_batch]:
                self._release_snapshot_value(self._evicted[rid]["cache"])
                self._evicted[rid]["cache"] = None
        self.scheduler.requeue(slot)
        self.pool.free(slot)
        self._live_slots.discard(slot)
        self._spec_release(slot)
        # freeze the row so no decode block advances it before the next
        # admission lands in the slot
        self._deactivate_slot(slot)

    def _try_resume(self, slot: int, req: Request) -> bool:
        """Restore a preempted request's slot from its eviction snapshot;
        False (the caller re-prefills) if the snapshot was lost to the
        prefix cache's LRU meanwhile."""
        meta = self._evicted.pop(req.request_id, None)
        if meta is None:
            return False
        value = meta["cache"]
        if value is None and self.prefix_cache is not None:
            value = self.prefix_cache.take_exact(
                req.prompt_tokens + req.output_tokens, salt=self._salt(req))
        if value is None:
            return False
        if self._paged and "pages" in value:
            # zero-copy resume: the snapshot's page refs move to the slot
            # (take_exact popped the entry without firing on_evict)
            self.pool.adopt(slot, value["pages"], value["nonkv"])
        else:
            # a dense snapshot (the dense ring's eviction, or a handoff
            # record imported into either layout)
            self.pool.insert(slot, value["cache"])
        self._admit_rows_to_state(
            [(slot, req, req.output_tokens[-1],
              len(req.prompt_tokens) + req.num_generated - 1,
              meta["ctx_valid"], True)])
        self._live_slots.add(slot)
        req.status = RequestStatus.DECODING
        self.scheduler.stats.resumed += 1
        return True

    def _release_snapshot_value(self, value: Any) -> None:
        """Release a snapshot value that will NOT be adopted into a slot
        (a terminated request, or an engine-side snapshot dropped)."""
        if self._paged and isinstance(value, dict) and value.get("pages"):
            self.pool.release_pages(value["pages"])

    # ------------------------------------------------------------------ #
    # prefix-cache salt and paged-KV bookkeeping
    # ------------------------------------------------------------------ #
    @staticmethod
    def _salt(req: Request) -> bytes:
        """Prefix-cache salt from the admission-time media digest: ``b""``
        for the text requests this engine serves."""
        return (bytes.fromhex(req.media_set_digest)
                if req.media_set_digest else b"")

    def _on_cache_evict(self, key: str, value: Any) -> None:
        """Prefix-cache entry displaced (LRU squeeze, replacement, or forced
        page-pressure eviction): release the device pages it leased."""
        if isinstance(value, dict) and value.get("pages"):
            self.pool.release_pages(value["pages"])

    def _on_content_evict(self, key: str, value: Any) -> None:
        """Content-cache entry displaced (LRU squeeze, replacement, or a
        forced page-pressure eviction): release the arena pages its cross
        KV leased.  Embedding entries carry no lease."""
        pages = getattr(value, "pages", None)
        if pages:
            self.pool.release_pages(pages)
            self.media_stats.xkv_lease_pages -= len(pages)
            value.pages = None

    def _lease_xkv_pages(self, nbytes: int) -> Optional[List[int]]:
        """Charge a cross-KV entry's bytes against the paged arena: lease
        ceil(nbytes / page_bytes) accounting pages, evicting prefix-cache
        entries if the arena is tight.  None (publication skipped) if it
        cannot spare them — serving capacity outranks media caching.  The
        dense layout has no arena: nothing to lease."""
        if not self._paged:
            return []
        npages = -(-nbytes // self.pool.page_bytes)
        while self.pool.allocator.num_free < npages:
            if self.prefix_cache is not None and \
                    self.prefix_cache.evict_lru():
                continue
            return None
        pages = [self.pool.allocator.alloc() for _ in range(npages)]
        self.media_stats.xkv_lease_pages += npages
        return pages

    def _evict_cache_entry(self) -> bool:
        """Rung 1 of the pressure ladder: evict one prefix-cache entry, else
        one cross-KV entry (media caching never outranks decode); False
        when neither cache holds an entry."""
        return bool((self.prefix_cache is not None
                     and self.prefix_cache.evict_lru())
                    or (self.content_cache is not None
                        and self.content_cache.evict_cross_kv_lru()))

    def _fit_commits(self, completed: List[Tuple[_PrefillJob, torch.Tensor]]
                     ) -> List[Tuple[_PrefillJob, torch.Tensor]]:
        """Paged layout: the finished prefills, in order, whose fresh pages
        the arena can take now, evicting cache entries to make room (as
        many as the reference's commit retry evicts).  The first that does
        not fit and everything behind it stay staged until retirements
        free pages; where the reference would fail such a wave, the port
        makes it wait — a rung-2 victim re-prefilled at once would
        otherwise fail on the very pages its eviction freed.  A prefill
        that cannot fit while no slot decodes (nothing will free a page)
        fails with a typed error."""
        ps, cap = self.pool.page_size, self.pool.pages_per_slot
        fit: List[Tuple[_PrefillJob, torch.Tensor]] = []
        need = 0
        for i, (job, logits) in enumerate(completed):
            fresh = (min(-(-len(job.tokens) // ps), cap)
                     - len(self._job_leases.get(job.req.request_id, ())))
            while self.pool.allocator.num_free < need + fresh and \
                    self._evict_cache_entry():
                pass
            if self.pool.allocator.num_free >= need + fresh:
                fit.append((job, logits))
                need += fresh
            elif fit or self._live_slots:
                self._staged = completed[i:]
                break
            else:
                self._fault_events.extend(self._fail_request(
                    job.req.request_id,
                    f"admission commit failed: {fresh} pages needed, "
                    f"{self.pool.allocator.num_free} free of "
                    f"{self.pool.allocator.num_allocatable}"))
        return fit

    def _release_lease(self, request_id: int) -> None:
        pages = self._job_leases.pop(request_id, None)
        if pages:
            self.pool.release_pages(pages)

    def _live_positions(self) -> Dict[int, int]:
        """slot -> absolute position of its last sampled token (where the
        next decode step writes KV) for every live slot."""
        out = {}
        for slot in self._live_slots:
            req = self.scheduler.active.get(slot)
            if req is not None:
                out[slot] = len(req.prompt_tokens) + req.num_generated - 1
        return out

    def _ensure_paged_capacity(self, k_steps: int) -> None:
        """Pressure ladder before a decode block: make the pages it will
        write exclusively owned (lazy tail allocation + COW splits).  On
        exhaustion, reclaim in escalating order — (1) evict prefix-cache
        entries (their leases free real pages), then cross-KV entries, (2)
        preempt the rebuildable live slot holding the most pages *without*
        a snapshot (a snapshot would pin the very pages needed), (3) fail
        the last holdout with a typed error.  Every rung frees pages or
        shrinks the live set, so the loop ends."""
        while not self.pool.ensure_decode_capacity(self._live_positions(),
                                                   k_steps):
            if self._evict_cache_entry():
                continue
            live = self._live_positions()
            if not live:
                return
            eligible = [s for s in live if self._rebuildable(s)]
            if len(live) > 1 and eligible:
                victim = max(eligible,
                             key=lambda s: len(self.pool.slot_pages(s)))
                log.warning("KV page pressure: preempting slot %d (request "
                            "%d, %d pages) without snapshot", victim,
                            self.scheduler.active[victim].request_id,
                            len(self.pool.slot_pages(victim)))
                self._evict(victim, snapshot=False)
                continue
            slot = max(live, key=lambda s: len(self.pool.slot_pages(s)))
            self._fault_events.extend(self._fail_request(
                self.scheduler.active[slot].request_id,
                f"KV page pool exhausted ({self.pool.num_pages} pages)"))

    def validate_request(self, req: Request) -> None:
        """Validate + normalise a request without enqueueing it: prompt
        length (truncate or raise), stop tokens / sequences, logprobs and
        sampler ranges, echo (text only), base-key binding, and an ``n`` >
        1 leader's group entry.  Idempotent."""
        n = len(req.prompt_tokens)
        if not self.cfg.sliding_window and n > self.pool.cache_len:
            if not self.truncate_long_prompts:
                raise PromptTooLongError(
                    f"prompt has {n} tokens but the KV cache holds "
                    f"{self.pool.cache_len}; raise cache_len or pass "
                    "truncate_long_prompts=True")
            req.metadata["truncated_prompt_from"] = n
            req.prompt_tokens = list(req.prompt_tokens[-self.pool.cache_len:])
        if len(req.sampling.stop_token_ids) + 1 > self.max_stop_tokens:
            raise ValueError(
                f"{len(req.sampling.stop_token_ids)} stop tokens exceed "
                f"max_stop_tokens={self.max_stop_tokens}")
        if any(not isinstance(s, str) or not s
               for s in req.sampling.stop_sequences):
            raise ValueError("stop sequences must be non-empty strings")
        if not 0 <= req.sampling.top_logprobs <= self.max_top_logprobs:
            raise ValueError(
                f"top_logprobs={req.sampling.top_logprobs} out of range "
                f"[0, max_top_logprobs={self.max_top_logprobs}]")
        validate_sampling_params(req.sampling.top_p, req.sampling.top_k,
                                 req.sampling.min_p, req.sampling.seed)
        if req.sampling.echo and (req.images or req.video_frames
                                  or req.audio is not None):
            raise ValueError(
                "echo is supported for text-only prompts (prompt logprobs "
                "are teacher-forced over the token sequence alone)")
        self._assign_sample_key(req)
        # an n > 1 leader opens its group here (at EngineClient.submit), so
        # followers released later — maybe in another admission round —
        # find it and wait for the shared value
        if (req.group_size > 1 and req.group_leader is None
                and req.request_id not in self._prefill_groups):
            self._prefill_groups[req.request_id] = {
                "value": None, "remaining": req.group_size - 1,
                "failed": False}
            self.group_stats["groups"] += 1

    def add_request(self, req: Request) -> None:
        self.validate_request(req)
        req.status = RequestStatus.QUEUED
        self.scheduler.add(req)

    # ------------------------------------------------------------------ #
    # speculative decoding rounds
    # ------------------------------------------------------------------ #
    def _plan_spec_lens(self, reclaim_queued: bool
                        ) -> Optional[Tuple[np.ndarray, Optional[np.ndarray]]]:
        """Host-side staging plan for one draft-verify round: per-slot draft
        lengths and (n-gram rung) the proposals ``[B, spec_k]``, or None to
        run the ordinary decode block instead.

        A slot stages no draft when (guards, in order): the scheduler is
        under pressure or acceptance is on probation (``plan_spec_k`` = 0);
        its ring would wrap inside the round (``pos + spec_k >= cache_len``
        — a wrapped mask would let a verify query see cells written for
        later queries of the same forward); its budget leaves no draft; or
        (draft rung) its draft KV is not primed.  An all-zero plan returns
        None, so an unspeculable batch keeps the K-step block."""
        acceptance = self.spec_controller.tick()
        k_cap = self.scheduler.plan_spec_k(self.spec_k, acceptance,
                                           reclaim_queued=reclaim_queued)
        if k_cap <= 0:
            return None
        lens = np.zeros((self.pool.max_batch,), np.int64)
        draft_rung = isinstance(self._draft_source, DraftModelSource)
        props = (None if draft_rung else
                 np.zeros((self.pool.max_batch, self.spec_k), np.int64))
        for slot, pos in self._live_positions().items():
            req = self.scheduler.active[slot]
            if pos + self.spec_k >= self.pool.cache_len:
                continue
            kmax = min(k_cap, req.sampling.max_tokens - req.num_generated - 1)
            if kmax <= 0:
                continue
            if draft_rung:
                if self._draft_source.primed(slot):
                    lens[slot] = kmax
            else:
                p = self._draft_source.propose(
                    req.prompt_tokens + req.output_tokens, kmax)
                if p:
                    props[slot, :len(p)] = p
                    lens[slot] = len(p)
        if not lens.any():
            return None
        return lens, props

    def _dispatch_spec_round(self, lens: np.ndarray,
                             drafts: Optional[np.ndarray], want_lp: bool,
                             any_stochastic: bool, any_mask: bool
                             ) -> Optional[Dict[str, Any]]:
        """Stage the drafts (the n-gram proposals, or a draft-model round's)
        and run one verify round (in place); returns the block plan and the
        per-slot accounting tensors, or None when the round raised (the
        recovery already ran)."""
        fix = q = None
        if self._paged:
            # the verify forward writes up to spec_k + 1 positions a slot
            self._ensure_paged_capacity(self.spec_k + 1)
        try:
            if isinstance(self._draft_source, DraftModelSource):
                snap, start_pos, drafts, q = \
                    self._draft_source.draft_round(self.spec_k)
                fix = (snap, start_pos)
            stage_drafts(self.state, drafts, lens)
            toks, n_acc, n_emit, lps = self._spec_verify_fn(
                self.params, self.pool.cache, self.state, q,
                spec_k=self.spec_k, want_logprobs=want_lp,
                use_q=self._draft_source.uses_q,
                any_stochastic=any_stochastic, any_mask=any_mask)
        except Exception as e:      # the round raised: every live slot fails
            self._recover_decode_block(e)
            return None
        if fix is not None:
            self._draft_source.fixup(self.spec_k, *fix, self.state)
        return {"plan": (self.spec_k + 1, toks, lps),
                "lens": lens, "n_acc": n_acc, "n_emit": n_emit}

    def _account_spec_round(self, meta: Dict[str, Any]) -> None:
        lens = meta["lens"]
        n_acc = meta["n_acc"].cpu().numpy()
        n_emit = meta["n_emit"].cpu().numpy()
        st = self.spec_stats
        st.rounds += 1
        st.emitted += int(n_emit.sum())
        for slot in np.nonzero(lens)[0]:
            d = int(lens[slot])
            a = int(min(n_acc[slot], d))
            st.drafted += d
            st.accepted += a
            st.rejected += d - a
            self.spec_controller.observe(int(slot), d, a)

    def speculation_stats(self) -> Dict[str, Any]:
        """The speculation block of ``GET /stats`` (plain-int reads, the
        concurrency contract of ``scheduler.snapshot``)."""
        out: Dict[str, Any] = {"mode": self.spec_mode, "k": self.spec_k}
        out.update(self.spec_stats.snapshot())
        out["slot_acceptance_ewma"] = self.spec_controller.snapshot()
        out["draft_pool_bytes"] = (
            self._draft_source.nbytes
            if isinstance(self._draft_source, DraftModelSource) else 0)
        return out

    # ------------------------------------------------------------------ #
    def step(self) -> List[StreamEvent]:
        """One scheduler iteration (paper Alg.1 loop body, K tokens): the
        decode block is dispatched first and the prefill wave second, and
        only then does the host wait on the block's tokens.  Traced as
        ``engine.step``, its phases as children: ``engine.plan``,
        ``engine.decode_dispatch`` (n = K), ``engine.prefill_dispatch`` (n =
        wave rows), ``engine.block_sync`` (the host waiting on the card),
        ``engine.emit`` (n = tokens) and ``engine.commit`` (n = jobs)."""
        with TRACER.span("engine.step"):
            return self._step()

    def _step(self) -> List[StreamEvent]:
        events: List[StreamEvent] = []
        stats = self.scheduler.stats
        self._fault_tick += 1
        if (self.faults is not None
                and self.faults.fires("slow_step", self._fault_tick)):
            # an injected wedged step (drives the client watchdog)
            time.sleep(self.faults.slow_step_s)
        with TRACER.span("engine.plan"):
            self._plan_admissions()

        block_plan = spec_meta = None
        if self._live_slots:
            reclaim_q = bool(self.reclaim_hint is not None
                             and self.reclaim_hint())
            live_reqs = [r for s, r in self.scheduler.active.items()
                         if s in self._live_slots]
            samp = [self._resolve_sampling(r) for r in live_reqs]
            want_lp = any(r.sampling.logprobs for r in live_reqs)
            any_stochastic = any(s[0] > 0 for s in samp)
            any_mask = any(s[1] < 1.0 or s[2] > 0 or s[3] > 0
                           for s in samp if s[0] > 0)
            spec_plan = (self._plan_spec_lens(reclaim_q)
                         if self._spec_verify_fn is not None else None)
            if spec_plan is not None:
                # draft-verify round: one wider forward commits up to
                # spec_k + 1 tokens per slot
                spec_meta = self._dispatch_spec_round(
                    *spec_plan, want_lp, any_stochastic, any_mask)
                if spec_meta is not None:
                    block_plan = spec_meta["plan"]
            else:
                num_steps = self.scheduler.plan_decode_block(
                    self.max_decode_block, reclaim_queued=reclaim_q)
                if self._paged:
                    # the block's KV writes must land on exclusively-owned
                    # pages, under the pressure ladder (which can shrink
                    # the live set)
                    self._ensure_paged_capacity(num_steps)
                try:
                    with TRACER.span("engine.decode_dispatch", n=num_steps):
                        toks, lps = self._decode_block(
                            num_steps, want_logprobs=want_lp,
                            any_stochastic=any_stochastic, any_mask=any_mask)
                except Exception as e:  # the block raised
                    self._recover_decode_block(e)
                else:
                    block_plan = (num_steps, toks, lps)

        # the encode wave and the prefill wave run behind the dispatched
        # block; encodes resolved here make requests admissible next step
        with TRACER.span("engine.prefill_dispatch") as span:
            rows = stats.prefill_chunks
            self._dispatch_encode_wave()
            completed = self._dispatch_prefill_wave()
            span.n = stats.prefill_chunks - rows

        if block_plan is not None:
            num_steps, toks, lps = block_plan
            with TRACER.span("engine.block_sync"):
                block = toks.cpu().numpy()         # [K, B]: the block's sync
                lp_c = lp_v = lp_i = None
                if lps is not None:
                    lp_c, lp_v, lp_i = (a.cpu().numpy() for a in lps)
            stats.steps += 1
            # a spec round is ONE forward however many rows it commits
            stats.device_steps += 1 if spec_meta is not None else num_steps
            if spec_meta is None and self._decode_graphs is not None:
                replayed, captured = self._decode_graphs.take_counts()
                stats.decode_graph_steps += replayed
                stats.decode_graph_captures += captured
            if spec_meta is not None:
                self._account_spec_round(spec_meta)
            with TRACER.span("engine.emit") as span:
                emitted = stats.tokens_generated
                events.extend(self._emit_block(num_steps, block,
                                               lp_c, lp_v, lp_i))
                span.n = stats.tokens_generated - emitted

        # finished prefills land (the next block picks the new slots up);
        # speculative jobs whose slot came this step commit in the same
        # call, their staged logits standing in for a wave row
        ready = [(j, j.logits) for j in self._ready_jobs]
        self._ready_jobs.clear()
        completed, self._staged = self._staged + ready + completed, []
        try:
            with TRACER.span("engine.commit") as span:
                if self._paged:
                    completed = self._fit_commits(completed)
                span.n = len(completed)
                events.extend(self._commit_jobs(completed))
        except Exception as e:  # commit-wave fault boundary
            log.warning("admission commit failed (%d jobs): %s",
                        len(completed), e)
            for job, _ in completed:
                self._fault_events.extend(self._fail_request(
                    job.req.request_id, f"admission commit failed: {e}"))
        if self._fault_events:
            events.extend(self._fault_events)
            self._fault_events.clear()
        return events

    def _emit_block(self, num_steps: int, block: np.ndarray, lp_c, lp_v,
                    lp_i) -> List[StreamEvent]:
        """Stream the synced ``[K, B]`` token block (with its logprobs) to
        the live slots' requests, step by step, slot by slot."""
        events: List[StreamEvent] = []
        live = {s: r for s, r in self.scheduler.active.items()
                if s in self._live_slots}
        for k in range(num_steps):
            for slot in sorted(live):
                req = live[slot]
                if req.is_finished:
                    continue
                tok = int(block[k, slot])
                if tok < 0:                    # frozen-slot sentinel
                    continue
                corrupt = tok >= self.cfg.vocab_size
                if corrupt or (self.faults is not None
                               and self.faults.fires(
                                   "decode", req.request_id,
                                   req.num_generated)):
                    # a corrupt sampled token (or its injected stand-in)
                    # fails this request only: neighbour slots are
                    # independent and continue bit-identically
                    self._fault_events.extend(self._fail_request(
                        req.request_id,
                        f"corrupt token {tok} at position "
                        f"{req.num_generated}"
                        + ("" if corrupt else " (injected decode fault)")))
                    continue
                req.output_tokens.append(tok)
                self.scheduler.stats.tokens_generated += 1
                logprob = top = None
                if lp_c is not None and req.sampling.logprobs:
                    logprob = float(lp_c[k, slot])
                    ntop = req.sampling.top_logprobs
                    top = list(zip(lp_i[k, slot, :ntop].tolist(),
                                   lp_v[k, slot, :ntop].tolist()))
                try:
                    events.extend(self._emit_token(slot, req, tok,
                                                   logprob, top))
                except Exception as e:  # per-request boundary (codec)
                    self._fault_events.extend(self._fail_request(
                        req.request_id, f"codec failure: {e}"))
        return events

    def content_cache_stats(self) -> Dict[str, Any]:
        """Content-cache and media-pipeline counters for ``GET /stats``
        (plain-int reads; handler threads may call this while the engine
        loop runs).  The media counters exist with the cache disabled."""
        ms = self.media_stats
        out: Dict[str, Any] = {
            "enabled": self.content_cache is not None,
            "encoder_invocations": ms.encoder_invocations,
            "encode_waves": ms.encode_waves,
            "encode_queue_depth": len(self._encode_tasks),
            "dedup_joins": ms.dedup_joins,
            "embed_hits": ms.embed_hits,
            "embed_misses": ms.embed_misses,
            "xkv_hits": ms.xkv_hits,
            "xkv_misses": ms.xkv_misses,
            "xkv_lease_pages": ms.xkv_lease_pages,
            "xkv_publish_skipped": ms.xkv_publish_skipped,
        }
        if self.content_cache is not None:
            st = self.content_cache.stats
            out.update(bytes=self.content_cache.nbytes,
                       entries=len(self.content_cache),
                       insertions=st.insertions, evictions=st.evictions,
                       bytes_evicted=st.bytes_evicted)
        return out

    def run(self) -> List[StreamEvent]:
        events = []
        while self.scheduler.has_work:
            events.extend(self.step())
        return events

    def generate(self, requests: List[Request]) -> List[Request]:
        for r in requests:
            self.add_request(r)
        self.run()
        return requests
