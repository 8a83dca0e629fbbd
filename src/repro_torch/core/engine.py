"""The inference engine of the port: continuous batching over a dense ring
KV cache, with a device-resident K-step decode block and a chunked, batched
prefill pipeline — the dense-text subset of the reference package's
``core/engine.py``, in eager PyTorch.

Flow per :meth:`InferenceEngine.step` (paper Alg.1 loop body):

  1. **Plan admissions**: pending requests bind to free decode slots; each
     opens a *prefill job* that parks in the scheduler's chunk queue.
  2. **Dispatch a decode block** (if any slot is live): K decode+sample
     iterations as a Python loop over device tensors — sampling, stop-token
     detection and budget accounting all stay on the device, and a slot
     that finishes is frozen by the on-device finished-mask (masked cache
     writes, no position advance).  K comes from
     ``scheduler.plan_decode_block`` and collapses to 1 while requests or
     prefill chunks wait.
  3. **Dispatch a prefill wave**: every queued job's next chunk, packed into
     right-padded ``[k, bucket]`` forward passes (per-row positions and a
     ``seq_valid`` length mask), ``prefill_chunk`` tokens per job per step.
  4. **Sync + emit**: the host syncs **once per block** (the copy of the
     ``[K, B]`` token block), emits and retires, then commits finished
     prefills — one multi-slot cache copy, one decode-state scatter, one
     batched first-token sample.

Greedy outputs are invariant to K and to ``prefill_chunk``.

Not ported in this slice (refused with ``NotImplementedError`` naming the
ROADMAP item, or simply absent from ``/stats``): the prefix cache, paged
KV, speculative decoding, media and the content cache, preemption, fault
injection, drain and handoff, shared-prefix ``n`` groups (``n`` > 1 runs
independent prefills), speculative wave filling, and echo / prompt
logprobs.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.kv_cache import (SlotKVPool, admit_decode_state,
                                       concat_cache_rows, init_decode_state,
                                       slice_cache_row)
from repro_torch.core.request import (FinishReason, PromptTooLongError,
                                      Request, RequestStatus, StreamEvent)
from repro_torch.core.sampling import (masked_sample_inner, request_base_key,
                                       validate_sampling_params)
from repro_torch.core.scheduler import (ContinuousBatchingScheduler,
                                        SchedulingPolicy)
from repro_torch.core.streaming import StopSequenceChecker, TokenStreamDecoder
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import not_ported
from repro_torch.models.model import Model
from repro_torch.serving.tokenizer import ByteTokenizer


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
    t0: float


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
    ):
        if cfg.vision is not None or cfg.audio is not None:
            raise not_ported("media models", "multimodal")
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

        self.pool = SlotKVPool(cfg, max_batch, cache_len, device=self.device)
        self.scheduler = ContinuousBatchingScheduler(max_batch,
                                                     policy=sched_policy,
                                                     aging_s=aging_s)
        # installed by EngineClient: True while an abort waits at the block
        # boundary, so plan_decode_block collapses K to 1
        self.reclaim_hint: Optional[Callable[[], bool]] = None
        self.state = init_decode_state(max_batch, max_stop_tokens,
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
        toks, lp_c, lp_v, lp_i = [], [], [], []
        for _ in range(num_steps):
            out = self.model.apply(
                self.params, st.last_token[:, None], mode="decode",
                positions=st.positions[:, None], cache=self.pool.cache,
                slot_active=st.active)
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

    def _prefill(self, tokens, positions, single_caches, seq_valid, last_idx):
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
                               seq_valid=seq_valid, last_idx=last_idx)
        return out.logits[:, 0], cache

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
            slot = self.pool.allocate()
            admitted = self.scheduler.admit([slot])
            if not admitted:
                self.pool.free(slot)
                break
            _, req = admitted[0]
            self.scheduler.enqueue_prefill(self._open_prefill(slot, req))

    def _open_prefill(self, slot: int, req: Request) -> _PrefillJob:
        tokens = list(req.prompt_tokens)
        if not tokens:
            raise ValueError("empty prompt")
        req.status = RequestStatus.PREFILLING
        return _PrefillJob(slot=slot, req=req, tokens=tokens,
                           cache=self.pool.single_cache_zeros(), consumed=0,
                           t0=time.monotonic())

    def _dispatch_prefill_wave(self) -> List[Tuple[_PrefillJob, torch.Tensor]]:
        """Advance every queued prefill job by one chunk; returns (job,
        logits row) for jobs whose prompt is now fully materialised."""
        jobs = self.scheduler.pop_prefill_wave()
        groups: Dict[int, List[Tuple[_PrefillJob, int]]] = {}
        for job in jobs:
            remaining = len(job.tokens) - job.consumed
            take = (remaining if self.prefill_chunk == 0
                    else min(self.prefill_chunk, remaining))
            # every chunk fits the KV ring, and one row's slot indices stay
            # distinct mod cache_len (reference :1385-1393)
            take = min(take, self.pool.cache_len)
            bucket = min(self._plan_bucket(take), self.pool.cache_len)
            groups.setdefault(bucket, []).append((job, take))
        completed: List[Tuple[_PrefillJob, torch.Tensor]] = []
        for bucket, rows in groups.items():
            completed.extend(self._run_wave_group(bucket, rows))
        return completed

    def _run_wave_group(self, bucket: int, rows: List[Tuple[_PrefillJob, int]]
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
        logits, out_cache = self._prefill(
            torch.from_numpy(toks).to(dev), torch.from_numpy(poss).to(dev),
            singles, torch.from_numpy(valid).to(dev),
            torch.from_numpy(last_idx).to(dev))
        stats = self.scheduler.stats
        stats.prefill_waves += 1
        stats.prefill_chunks += k

        done: List[Tuple[_PrefillJob, torch.Tensor]] = []
        for i, (job, take) in enumerate(rows):
            job.cache = slice_cache_row(out_cache, i)
            job.consumed += take
            if job.consumed >= len(job.tokens):
                done.append((job, logits[i]))
            else:
                self.scheduler.enqueue_prefill(job)
        return done

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
            wave.append(_Admission(job.slot, req, job.cache, int(first),
                                   seq_len=len(job.tokens), logprob=logprob,
                                   top_logprobs=top))
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
            [(a.slot, a.req, a.first_token, a.seq_len, not a.req.is_finished)
             for a in wave])
        return events

    def _admit_rows_to_state(self, rows: List[Tuple[int, Request, int, int,
                                                    bool]]) -> None:
        """Scatter admission rows into the device decode state.  Each row:
        (slot, req, last_token, position-of-last_token, active)."""
        stops = np.full((len(rows), self.max_stop_tokens), -1, np.int64)
        for i, (_, req, *_) in enumerate(rows):
            ids = (self.tokenizer.EOS,) + tuple(req.sampling.stop_token_ids)
            stops[i, :len(ids)] = ids
        samp = [self._resolve_sampling(req) for _, req, *_ in rows]
        admit_decode_state(
            self.state, [slot for slot, *_ in rows],
            last_token=[last for _, _, last, *_ in rows],
            positions=[pos for _, _, _, pos, _ in rows],
            temps=[s[0] for s in samp], top_p=[s[1] for s in samp],
            top_k=[s[2] for s in samp], min_p=[s[3] for s in samp],
            sample_key=[req.sample_key for _, req, *_ in rows],
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
                                       deactivate=True, drop_tail=True))
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
                deactivate: bool = False, drop_tail: bool = False
                ) -> List[StreamEvent]:
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
        self._retire(slot)
        if deactivate:
            self._deactivate_slot(slot)
        return [StreamEvent(req.request_id, None, tail,
                            finished=True, finish_reason=reason)]

    def _retire(self, slot: int) -> None:
        self.scheduler.retire(slot)
        self.pool.free(slot)
        self._live_slots.discard(slot)

    def _deactivate_slot(self, slot: int) -> None:
        """Freeze a slot's device row: the next decode block masks its
        cache writes and stops advancing its position."""
        self.state.active[slot] = False

    def abort(self, request_id: int) -> List[StreamEvent]:
        """Cancel a request wherever it lives — pending queue, prefill chunk
        queue, or a live decode slot (freed at once, device row frozen).
        Returns the final ABORT event (empty if unknown or finished).  Not
        thread-safe: callers off the engine thread go through
        :meth:`repro_torch.serving.client.EngineClient.abort`."""
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
        if req is None or req.is_finished:
            return []
        req.finish_reason = FinishReason.ABORT
        req.finish_time = time.monotonic()
        req.status = RequestStatus.ABORTED
        self.scheduler.stats.aborted += 1
        self._streamers.pop(request_id, None)
        self._stopchk.pop(request_id, None)
        return [StreamEvent(request_id, None, "", finished=True,
                            finish_reason=FinishReason.ABORT)]

    def validate_request(self, req: Request) -> None:
        """Validate + normalise a request without enqueueing it: prompt
        length (truncate or raise), stop tokens / sequences, logprobs and
        sampler ranges, and base-key binding.  Idempotent."""
        if req.images or req.video_frames or req.audio is not None:
            raise ValueError("this engine serves text only (media requests "
                             "are not ported yet)")
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
            toks, lps = self._decode_block(
                num_steps,
                want_logprobs=any(r.sampling.logprobs for r in live_reqs),
                any_stochastic=any(s[0] > 0 for s in samp),
                any_mask=any(s[1] < 1.0 or s[2] > 0 or s[3] > 0
                             for s in samp if s[0] > 0))
            block_plan = (num_steps, toks, lps)

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
        return events

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
