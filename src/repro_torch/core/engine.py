"""The inference engine of the port: continuous batching over a dense ring
KV cache or a paged arena with copy-on-write prefix sharing, with a
device-resident K-step decode block, a chunked, batched prefill pipeline,
the text prefix cache (paper Alg.2) and, for vision models, batched encode
waves with in-flight dedup and the content cache (paper Alg.3) — the
reference package's ``core/engine.py`` less what the port queue still
holds, in eager PyTorch.

Flow per :meth:`InferenceEngine.step` (paper Alg.1 loop body):

  1. **Plan admissions**: pending requests bind to free decode slots; each
     opens a *prefill job* that parks in the scheduler's chunk queue.  A
     request with images or video frames is admissible only once its whole
     media set has an embedding (content-cache hits at job open, the rest
     from encode waves).
  2. **Dispatch a decode block** (if any slot is live): K decode+sample
     iterations as a Python loop over device tensors — sampling, stop-token
     detection and budget accounting all stay on the device, and a slot
     that finishes is frozen by the on-device finished-mask (masked cache
     writes, no position advance).  K comes from
     ``scheduler.plan_decode_block`` and collapses to 1 while requests or
     prefill chunks wait.
  3. **Run an encode wave, then dispatch a prefill wave**: up to
     ``ENCODE_WAVE`` unique pending encodes (singleflight on the content
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

Prefix cache (``enable_prefix_cache``): a prefill opens at the longest
cached block-aligned prefix of its prompt; a chunked prefill publishes its
partial prefix at every chunk boundary (one rolling entry per job); the
dense layout publishes a slot's prompt at retire, the paged layout at
commit — as the slot's prompt pages, leased copy-on-write, beside a dense
shadow row that later prefills resume from.  Under ``kv_layout="paged"``
every decode block first makes the pages it will write exclusively owned
(:meth:`PagedKVPool.ensure_decode_capacity`), evicting prefix-cache entries
when the arena runs short.

Content cache (``enable_content_cache``): per-frame embedding entries skip
the encoder; per-media-set cross-KV entries (device clones, never views
into a wave cache) skip the context projection of every cross-attention
layer.  Under ``kv_layout="paged"`` a cross-KV entry leases accounting
pages of the arena, and the pressure ladder evicts it after the prefix
cache's entries.

Not ported yet (refused with ``NotImplementedError`` or ``ValueError``
naming the ROADMAP item, or simply absent from ``/stats``): arenas below
full capacity (they need preemption), speculative decoding, audio models,
preemption, fault injection, drain and handoff, shared-prefix ``n`` groups
(``n`` > 1 runs independent prefills; refused for media requests),
speculative wave filling, and echo / prompt logprobs.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.content_cache import (ContentCache, CrossKVEntry,
                                            EmbeddingEntry, MediaStats,
                                            content_hash, media_set_digest)
from repro_torch.core.kv_cache import (SlotKVPool, admit_decode_state,
                                       concat_cache_rows, init_decode_state,
                                       slice_cache_row, tree_bytes)
from repro_torch.core.paged_kv import PagedKVPool, PagePoolExhausted
from repro_torch.core.prefix_cache import TextPrefixCache
from repro_torch.core.request import (FinishReason, PromptTooLongError,
                                      Request, RequestStatus, StreamEvent)
from repro_torch.core.sampling import (masked_sample_inner, request_base_key,
                                       validate_sampling_params)
from repro_torch.core.scheduler import (ContinuousBatchingScheduler,
                                        SchedulingPolicy)
from repro_torch.core.streaming import StopSequenceChecker, TokenStreamDecoder
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import not_ported
from repro_torch.models.model import Model, tree_map
from repro_torch.serving.media import VisionEncoderStub, decode_media
from repro_torch.serving.tokenizer import ByteTokenizer


MAX_MEDIA_ITEMS = 4     # images the cross-attention context window holds
ENCODE_WAVE = 4         # unique encodes per step: a video streams across


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
    chunk queue until the whole prompt is materialised."""
    slot: int
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
        aging_s: Optional[float] = None,
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
    ):
        if cfg.audio is not None:
            raise not_ported("audio models (Model._encode_audio)",
                             "multimodal (audio)")
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', got "
                             f"{kv_layout!r}")
        if kv_layout == "dense" and kv_dtype != "fp":
            raise ValueError("int8 KV requires kv_layout='paged'")
        self._paged = kv_layout == "paged"
        if self._paged and kv_num_pages is not None and kv_num_pages < \
                PagedKVPool.full_capacity(max_batch, cache_len, kv_page_size):
            # the reference's pressure ladder preempts a slot when evicting
            # prefix-cache entries is not enough; without preemption the
            # port would fail requests the reference finishes
            raise not_ported(
                f"a KV page arena below full capacity (kv_num_pages="
                f"{kv_num_pages})", "preemption")
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

        # media geometry (the reference's defaults): the context window
        # holds MAX_MEDIA_ITEMS images; a video frame takes a quarter of an
        # image's slots
        self.media_kind = "vision" if cfg.vision is not None else "none"
        self.ctx_len = 0
        if self.media_kind == "vision":
            self.image_tokens = cfg.vision.num_image_tokens
            self.frame_tokens = max(4, self.image_tokens // 4)
            self.ctx_len = self.image_tokens * MAX_MEDIA_ITEMS
            self.embed_dim = cfg.vision.embed_dim
            self._img_encoder = VisionEncoderStub(
                self.image_tokens, self.embed_dim, work_iters=vision_work_iters)
            self._frame_encoder = VisionEncoderStub(
                self.frame_tokens, self.embed_dim, work_iters=vision_work_iters)

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
        # singleflight table of unique in-flight encodes (hash -> task).
        # The jobs' table bound is the reference's: 2 * max_batch plus its
        # max_batch speculative jobs, so jobs open at the same steps
        self.media_stats = MediaStats()
        self._media_jobs: Dict[int, _MediaJob] = {}
        self._encode_tasks: Dict[str, _EncodeTask] = {}
        self._max_media_jobs = 3 * max_batch
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
                                       device=self.device)
        # unseeded requests draw their base key from this engine-owned
        # stream (deterministic for a fixed engine seed + add order)
        self._request_rng = np.random.default_rng(seed + 1)
        self._streamers: Dict[int, TokenStreamDecoder] = {}
        self._stopchk: Dict[int, StopSequenceChecker] = {}
        self._live_slots: set = set()        # slots committed to DecodeState

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

    # ------------------------------------------------------------------ #
    # device steps
    # ------------------------------------------------------------------ #
    def _decode_block(self, num_steps: int, want_logprobs: bool,
                      any_stochastic: bool, any_mask: bool):
        """K decode+sample iterations over the device state, in place.  No
        host sync happens inside: the caller copies the returned token block
        (and logprobs) to the host once.  ``any_stochastic``/``any_mask``
        come from the live requests' sampling parameters, known on the host,
        so the all-greedy block never touches the sampler's sort or noise."""
        st, n_top = self.state, self.max_top_logprobs
        page_table = self.pool.cache["page_table"] if self._paged else None
        ctx_valid = st.ctx_valid if self.media_kind != "none" else None
        toks, lp_c, lp_v, lp_i = [], [], [], []
        for _ in range(num_steps):
            out = self.model.apply(
                self.params, st.last_token[:, None], mode="decode",
                positions=st.positions[:, None], cache=self.pool.cache,
                slot_active=st.active, page_table=page_table,
                ctx_valid=ctx_valid)
            logits = out.logits[:, 0]
            # frozen slots' sampler fields are neutralised, as in the
            # reference, so a finished request's knobs cannot matter
            act = st.active
            nxt = masked_sample_inner(
                logits, st.sample_key, st.positions + 1, st.temps * act,
                torch.where(act, st.top_p, 1.0),
                torch.where(act, st.top_k, 0),
                torch.where(act, st.min_p, 0.0),
                any_stochastic=any_stochastic, any_mask=any_mask)
            nxt = torch.where(act, nxt, st.last_token)
            toks.append(torch.where(act, nxt, -1))    # -1 = frozen
            alive = act.long()
            st.budget = st.budget - alive
            hit_stop = (nxt[:, None] == st.stop_tokens).any(-1)
            finished = act & (hit_stop | (st.budget <= 0))
            st.last_token = nxt
            st.positions = st.positions + alive
            st.active = act & ~finished
            if want_logprobs:
                lp = torch.log_softmax(logits.float(), dim=-1)
                lp_c.append(torch.gather(lp, 1, nxt[:, None])[:, 0])
                top = torch.topk(lp, n_top, dim=-1)
                lp_v.append(top.values)
                lp_i.append(top.indices)
        lps = ((torch.stack(lp_c), torch.stack(lp_v), torch.stack(lp_i))
               if want_logprobs else None)
        return torch.stack(toks), lps

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
                               image_embeds=media, ctx_valid=ctx_valid,
                               cross_cached=cross_cached)
        return out.logits[:, 0], cache

    # ------------------------------------------------------------------ #
    # media pipeline (Alg.3 lines 1-10): batched encode waves + in-flight
    # dedup (singleflight on content hash) ahead of admission
    # ------------------------------------------------------------------ #
    def _has_media(self, req: Request) -> bool:
        return (self.media_kind != "none"
                and bool(req.images or req.video_frames
                         or req.audio is not None))

    def _iter_media_payloads(self, req: Request):
        """(payload, encoder, ntok) triples in context order: images, then
        video frames (an audio payload on a vision model is ignored, as in
        the reference)."""
        for img in req.images:
            yield img, self._img_encoder, self.image_tokens
        for frame in req.video_frames:
            yield frame, self._frame_encoder, self.frame_tokens

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
        job = self._media_jobs.get(req.request_id)
        if job is None:
            if len(self._media_jobs) >= self._max_media_jobs:
                return False             # table full: stays queued
            try:
                job = self._open_media_job(req)
            except (KeyError, TypeError, ValueError, OSError) as e:
                self._fault_events.extend(self._terminate(
                    req.request_id, FinishReason.ERROR,
                    f"media decode failed: {e!r}"))
                return False
        return job.remaining == 0

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
        """Run up to ``ENCODE_WAVE`` unique pending encodes (most urgent
        waiter first, policy order), delivering each embedding to *all*
        waiters.  Called between the decode-block dispatch and the token
        sync, so the host encoder work overlaps the device block."""
        if not self._encode_tasks:
            return
        key = self.scheduler.policy.key
        order = sorted(self._encode_tasks.values(),
                       key=lambda t: min(key(j.req) for j in t.waiters))
        self.media_stats.encode_waves += 1
        for task in order[:ENCODE_WAVE]:
            del self._encode_tasks[task.hash]
            if not task.waiters:
                continue
            emb = task.encoder(task.pixels)
            self.media_stats.encoder_invocations += 1
            if self.content_cache is not None:
                self.content_cache.put_embedding(
                    task.hash, EmbeddingEntry(emb, emb.nbytes))
            for job in task.waiters:
                for item in job.items:
                    if item.hash == task.hash and item.emb is None:
                        item.emb = emb
                        job.remaining -= 1

    def _assemble_media(self, job: Optional[_MediaJob]):
        """Pack a resolved job's embeddings into the fixed context window
        (cursor walk in context order): (embeds [1, T, De], ctx_valid
        [1, T], set digest or None).  ``None`` (a text request on a vision
        model) gives an empty, all-invalid window."""
        embeds = np.zeros((self.ctx_len, self.embed_dim), np.float32)
        valid = np.zeros((self.ctx_len,), bool)
        items = job.items if job is not None else []
        cursor = 0
        for item in items:
            take = min(item.ntok, self.ctx_len - cursor)
            embeds[cursor:cursor + take] = item.emb[:take]
            valid[cursor:cursor + take] = True
            cursor += take
        digest = media_set_digest([it.hash for it in items]) if items else None
        return embeds[None], valid[None], digest

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
        """Bind the request's base key once, at add_request: the seed for
        seeded requests, a draw from the engine's stream otherwise."""
        if req.sample_key is not None:
            return
        if req.sampling.seed is not None:
            req.sample_key = request_base_key(req.sampling.seed)
        else:
            req.sample_key = int(self._request_rng.integers(0, 2**63 - 1))

    def _resolve_sampling(self, req: Request) -> Tuple[float, float, int, float]:
        """Effective (temperature, top_p, top_k, min_p): per-request values
        with the engine knobs as fallbacks."""
        sp = req.sampling
        return (sp.temperature,
                self.top_p if sp.top_p is None else float(sp.top_p),
                self.top_k if sp.top_k is None else int(sp.top_k),
                self.min_p if sp.min_p is None else float(sp.min_p))

    def _admit_into_free_slots(self) -> None:
        self.scheduler.policy.tick(time.monotonic())
        while (self.pool.num_free and self.scheduler.pending
               and self.scheduler.num_active < self.scheduler.max_batch):
            # requests whose embeddings are still resolving are skipped
            # without losing their queue position; peeking also opens the
            # media jobs of newly seen requests
            if self.scheduler.peek_pending(self._media_admissible) is None:
                break
            slot = self.pool.allocate()
            admitted = self.scheduler.admit([slot], self._media_admissible)
            if not admitted:
                self.pool.free(slot)
                break
            _, req = admitted[0]
            self.scheduler.enqueue_prefill(self._open_prefill(slot, req))

    def _open_prefill(self, slot: int, req: Request) -> _PrefillJob:
        tokens = list(req.prompt_tokens)
        if not tokens:
            raise ValueError("empty prompt")
        t0 = time.monotonic()
        req.status = RequestStatus.PREFILLING
        embeds = ctx_valid = set_digest = None
        if self.media_kind != "none":
            # resolved by encode waves / embedding-cache hits ahead of
            # admission: assembly only, no encoder work on this path
            job = self._media_jobs.pop(req.request_id, None)
            if job is not None and job.remaining:
                raise AssertionError(f"request {req.request_id} admitted "
                                     "with unresolved media")
            embeds, ctx_valid, set_digest = self._assemble_media(job)
        req.media_set_digest = set_digest
        # Alg.2: longest cached prefix (cap: leave >=1 token for logits)
        matched, single = 0, None
        if self.prefix_cache is not None:
            value, matched = self.prefix_cache.lookup(
                tokens, salt=self._salt(req), max_len=len(tokens) - 1)
            if value is not None:
                if "pages" in value:
                    # paged entry: the dense shadow row resumes the prefill,
                    # while the entry's full pages inside the match are
                    # leased COW — pinned against eviction until the commit
                    # transfers them to the slot (zero cache-copy admission)
                    single = value["dense"]
                    ps = self.pool.page_size
                    shared = list(value["pages"][:min(matched // ps,
                                                      len(value["pages"]))])
                    if shared:
                        self.pool.incref_pages(shared)
                        self._release_lease(req.request_id)
                        self._job_leases[req.request_id] = shared
                else:
                    single = value["cache"]
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

    def _dispatch_prefill_wave(self) -> List[Tuple[_PrefillJob, torch.Tensor]]:
        """Advance every queued prefill job by one chunk; returns (job,
        logits row) for jobs whose prompt is now fully materialised."""
        jobs = self.scheduler.pop_prefill_wave()
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
        completed: List[Tuple[_PrefillJob, torch.Tensor]] = []
        for (bucket, cross_cached), rows in groups.items():
            completed.extend(self._run_wave_group(bucket, cross_cached, rows))
        return completed

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
                done.append((job, logits[i]))
                continue
            self._publish_partial(job)
            self.scheduler.enqueue_prefill(job)
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
        # first tokens use the decode block's sampler: key = hash(base,
        # position-of-the-new-token), parameters through the same fallbacks
        samp = [self._resolve_sampling(j.req) for j in jobs]
        dev = self.device
        firsts = masked_sample_inner(
            logits,
            torch.tensor([j.req.sample_key for j in jobs], device=dev),
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
            if req.prefill_time is None:
                req.prefill_time = now - job.t0
            if req.first_token_time is None:
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
        events: List[StreamEvent] = []
        for a in wave:
            self._streamers[a.req.request_id] = TokenStreamDecoder(
                self.tokenizer)
            if a.req.sampling.stop_sequences:
                self._stopchk[a.req.request_id] = StopSequenceChecker(
                    list(a.req.sampling.stop_sequences))
            a.req.status = RequestStatus.DECODING
            events.extend(self._emit_token(a.slot, a.req, a.first_token,
                                           a.logprob, a.top_logprobs))
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
                if self.prefix_cache is not None and \
                        self.prefix_cache.evict_lru():
                    continue
                if self.content_cache is not None and \
                        self.content_cache.evict_cross_kv_lru():
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

    # ------------------------------------------------------------------ #
    # emit / finish / abort (the host side of the request lifecycle)
    # ------------------------------------------------------------------ #
    def _emit_token(self, slot: int, req: Request, token: int,
                    logprob: Optional[float] = None,
                    top_logprobs: Optional[List[Tuple[int, float]]] = None
                    ) -> List[StreamEvent]:
        """Stream one sampled token: incremental detokenisation, host-side
        stop-sequence filtering, logprob attachment, and the finish checks."""
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

    def _deactivate_slot(self, slot: int) -> None:
        """Freeze a slot's device row: the next decode block masks its
        cache writes and stops advancing its position."""
        self.state.active[slot] = False

    def abort(self, request_id: int) -> List[StreamEvent]:
        """Cancel a request wherever it lives — pending queue (its media
        job and its share of in-flight encodes included), prefill chunk
        queue, or a live decode slot (freed at once, device row frozen).
        Returns the final ABORT event (empty if unknown or finished).  Not
        thread-safe: callers off the engine thread go through
        :meth:`repro_torch.serving.client.EngineClient.abort`."""
        return self._terminate(request_id, FinishReason.ABORT)

    def _terminate(self, request_id: int, reason: FinishReason,
                   detail: Optional[str] = None) -> List[StreamEvent]:
        """Abort (``reason`` ABORT) or fail (ERROR, with ``detail``) one
        request wherever it lives; every other request is untouched."""
        slot = next((s for s, r in self.scheduler.active.items()
                     if r.request_id == request_id), None)
        if slot is not None:
            req = self.scheduler.active[slot]
            self.scheduler.drop_prefill_jobs(request_id)
            self.scheduler.abort_slot(slot)
            self.pool.free(slot)
            self._live_slots.discard(slot)
            self._deactivate_slot(slot)
        else:
            req = self.scheduler.abort_pending(request_id)
        self._release_lease(request_id)
        if req is None or req.is_finished:
            return []
        self._cancel_media_job(request_id)
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
        """Before a decode block: make the pages it will write exclusively
        owned (lazy tail allocation + COW splits).  On exhaustion, evict
        prefix-cache entries (their leases free real pages) — rung 1 of the
        reference's pressure ladder.  Its later rungs preempt or fail a
        slot; the port refuses arenas below full capacity instead, where
        rung 1 always frees enough, so running out here is a broken
        invariant and raises."""
        while not self.pool.ensure_decode_capacity(self._live_positions(),
                                                   k_steps):
            if self.prefix_cache is not None and \
                    self.prefix_cache.evict_lru():
                continue
            # cached cross-KV entries surrender their leases before any
            # live request would (media caching never outranks decode)
            if self.content_cache is not None and \
                    self.content_cache.evict_cross_kv_lru():
                continue
            raise RuntimeError(
                f"KV page arena exhausted with nothing left to evict "
                f"({self.pool.page_occupancy()}): a full-capacity arena "
                "should never run out")

    def validate_request(self, req: Request) -> None:
        """Validate + normalise a request without enqueueing it: prompt
        length (truncate or raise), stop tokens / sequences, logprobs and
        sampler ranges, and base-key binding.  Idempotent."""
        if self._has_media(req) and req.group_size > 1:
            raise ValueError("n > 1 with media is not ported yet (ROADMAP.md,"
                             " port queue: shared-prefix groups and n "
                             "sharing)")
        if req.sampling.echo:
            raise ValueError("echo (prompt logprobs) is not ported yet")
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
        self._assign_sample_key(req)

    def add_request(self, req: Request) -> None:
        self.validate_request(req)
        req.status = RequestStatus.QUEUED
        self.scheduler.add(req)

    # ------------------------------------------------------------------ #
    def step(self) -> List[StreamEvent]:
        """One scheduler iteration (paper Alg.1 loop body, K tokens): the
        decode block is dispatched first and the prefill wave second, and
        only then does the host wait on the block's tokens."""
        events: List[StreamEvent] = []
        self._admit_into_free_slots()

        block_plan = None
        if self._live_slots:
            reclaim_q = bool(self.reclaim_hint is not None
                             and self.reclaim_hint())
            live_reqs = [r for s, r in self.scheduler.active.items()
                         if s in self._live_slots]
            samp = [self._resolve_sampling(r) for r in live_reqs]
            num_steps = self.scheduler.plan_decode_block(
                self.max_decode_block, reclaim_queued=reclaim_q)
            if self._paged:
                # the block's KV writes must land on exclusively-owned pages
                self._ensure_paged_capacity(num_steps)
            toks, lps = self._decode_block(
                num_steps,
                want_logprobs=any(r.sampling.logprobs for r in live_reqs),
                any_stochastic=any(s[0] > 0 for s in samp),
                any_mask=any(s[1] < 1.0 or s[2] > 0 or s[3] > 0
                             for s in samp if s[0] > 0))
            block_plan = (num_steps, toks, lps)

        # the encode wave and the prefill wave run behind the dispatched
        # block; encodes resolved here make requests admissible next step
        self._dispatch_encode_wave()
        completed = self._dispatch_prefill_wave()

        if block_plan is not None:
            num_steps, toks, lps = block_plan
            block = toks.cpu().numpy()             # [K, B]: the block's sync
            lp_c = lp_v = lp_i = None
            if lps is not None:
                lp_c, lp_v, lp_i = (a.cpu().numpy() for a in lps)
            self.scheduler.stats.steps += 1
            self.scheduler.stats.device_steps += num_steps
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
                    req.output_tokens.append(tok)
                    self.scheduler.stats.tokens_generated += 1
                    logprob = top = None
                    if lp_c is not None and req.sampling.logprobs:
                        logprob = float(lp_c[k, slot])
                        ntop = req.sampling.top_logprobs
                        top = list(zip(lp_i[k, slot, :ntop].tolist(),
                                       lp_v[k, slot, :ntop].tolist()))
                    events.extend(self._emit_token(slot, req, tok, logprob,
                                                   top))

        events.extend(self._commit_jobs(completed))
        if self._fault_events:
            events.extend(self._fault_events)
            self._fault_events.clear()
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
