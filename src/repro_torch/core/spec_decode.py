"""Speculative decoding of the port: the two draft rungs and the batched
verifier of the reference package's ``core/spec_decode.py``, in eager
PyTorch on the engine's device.

* **Self-speculative (ngram)** — :class:`NGramProposer` drafts from the
  slot's own context by prompt lookup (host-side, no device cost); the
  proposals are staged into ``DecodeState.draft_tokens``.
* **Draft model** — :class:`DraftModelSource` runs a second config ahead of
  the target in its own dense pool, returning the drafted tokens and the
  draft distributions ``q`` the rejection test needs.
* **Batched verification** — :func:`build_spec_verify_fn` runs one target
  forward over ``[batch, spec_k + 1]`` positions (one decode- or
  paged-kernel call per position and layer), selects the longest accepted
  prefix, runs the rejection test and the residual correction for
  stochastic draft-model rows, and rolls back the KV cells of rejected
  drafts (``gather/restore_ring_cells`` on the dense ring,
  ``gather/restore_page_cells`` on the paged arena).

Determinism contract (the reference's): verification samples the target
token at every position ``j`` from the *plain* per-token stream at position
``p0 + 1 + j`` — the stream non-speculative decode draws from.  An ngram row
(greedy or seeded stochastic) accepts a draft iff it equals that sample, so
its emitted stream is the spec-off stream token for token; speculation
changes only how many tokens one forward commits.  Draft-model stochastic
rows run the accept test ``u · q(d) < p(d)`` on *salted* streams
(:data:`ACCEPT_SALT` and the others, :func:`repro_torch.core.sampling.
fold_salted_keys`), never the plain one, which stays reserved for the
tokens.  Every stream is JAX's threefry stream
(:mod:`repro_torch.core.sampling`), so seeded rows draw the reference's
tokens on every rung.

What differs from the reference: the state and caches are updated in place
(no donation).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.kv_cache import (DecodeState, SlotKVPool,
                                       admit_decode_state, gather_ring_cells,
                                       init_decode_state, restore_ring_cells)
from repro_torch.core.paged_kv import gather_page_cells, restore_page_cells
from repro_torch.core.sampling import (fold_in, gumbel, keep_set_reference,
                                       masked_probs, masked_sample_inner,
                                       salted_categorical, salted_uniform)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.model import Model, init_cache

# Salts of the auxiliary streams (accept test, correction draw, draft-model
# sampling), the reference's values: each is folded into the request's base
# key before the token position, so no auxiliary draw shares a value with
# the plain per-token stream.
ACCEPT_SALT = 0x5BEC0001
CORRECTION_SALT = 0x5BEC0002
DRAFT_SALT = 0x5BEC0003


# --------------------------------------------------------------------------- #
# self-speculative drafting: host-side prompt lookup
# --------------------------------------------------------------------------- #
class NGramProposer:
    """Prompt-lookup drafting (self-speculative): propose the continuation of
    the most recent previous occurrence of the context's trailing n-gram.

    Longest n first (``max_n`` down to ``min_n``), most recent occurrence
    wins — repetition-heavy text (code, structured output, quoted context)
    accepts long runs, random text simply proposes nothing and the round
    degenerates to ordinary decode.  Pure host-side bookkeeping: the device
    never sees the history scan, only the staged proposals."""

    def __init__(self, max_n: int = 3, min_n: int = 1):
        assert 1 <= min_n <= max_n
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        hist = list(history)
        ln = len(hist)
        if k <= 0 or ln < self.min_n + 1:
            return []
        for n in range(min(self.max_n, ln - 1), self.min_n - 1, -1):
            pat = hist[-n:]
            # backward scan: latest previous occurrence ending before the end
            for start in range(ln - n - 1, -1, -1):
                if hist[start:start + n] == pat:
                    cont = hist[start + n:start + n + k]
                    if cont:
                        return cont
        return []


# --------------------------------------------------------------------------- #
# accounting + K adaptation
# --------------------------------------------------------------------------- #
@dataclass
class SpecStats:
    """Engine-level speculation counters (distinct from the scheduler's
    ``spec_*`` fields, which count speculative *prefill* jobs)."""

    rounds: int = 0      # spec verify rounds dispatched
    drafted: int = 0     # tokens staged for verification
    accepted: int = 0    # drafted tokens accepted by the target
    rejected: int = 0    # drafted tokens rejected (drafted - accepted)
    emitted: int = 0     # tokens emitted by spec rounds (accepted + bonus)

    def snapshot(self) -> Dict[str, Any]:
        drafted = max(self.drafted, 1)
        return {
            "rounds": self.rounds,
            "tokens_drafted": self.drafted,
            "tokens_accepted": self.accepted,
            "tokens_rejected": self.rejected,
            "tokens_emitted": self.emitted,
            "acceptance_rate": self.accepted / drafted if self.drafted else None,
        }


class SpecController:
    """Per-slot acceptance EWMA driving the scheduler's K adaptation.

    Freshly admitted slots start optimistic (EWMA 1.0) so speculation gets a
    chance; sustained rejection drags the mean acceptance below the
    scheduler's low-water mark, which zeroes K (probation).  Probation lasts
    ``probation_rounds`` decode rounds, after which every tracked slot
    resets optimistic — cheap periodic re-probing, so a phase change in the
    stream re-enables drafting without host tuning."""

    def __init__(self, alpha: float = 0.3, probation_rounds: int = 16):
        self.alpha = alpha
        self.probation_rounds = probation_rounds
        self._ewma: Dict[int, float] = {}
        self._cooldown = 0

    def on_admit(self, slot: int) -> None:
        self._ewma[slot] = 1.0

    def release(self, slot: int) -> None:
        self._ewma.pop(slot, None)
        if not self._ewma:
            # probation belongs to the current workload: once every tracked
            # slot has drained, a fresh batch gets a fresh probe
            self._cooldown = 0

    def observe(self, slot: int, drafted: int, accepted: int) -> None:
        if drafted <= 0:
            return
        rate = accepted / drafted
        prev = self._ewma.get(slot, 1.0)
        self._ewma[slot] = (1.0 - self.alpha) * prev + self.alpha * rate

    def round_acceptance(self) -> float:
        """Mean EWMA over tracked slots (1.0 when nothing is tracked)."""
        if not self._ewma:
            return 1.0
        return sum(self._ewma.values()) / len(self._ewma)

    def tick(self, low_water: float = 0.15) -> float:
        """Per-round acceptance signal for ``plan_spec_k``, with probation:
        0.0 while on probation (spec stays off), otherwise the mean
        acceptance — entering probation when it sinks below ``low_water``."""
        if self._cooldown > 0:
            self._cooldown -= 1
            if self._cooldown == 0:
                for s in self._ewma:
                    self._ewma[s] = 1.0
            return 0.0
        acc = self.round_acceptance()
        if self._ewma and acc < low_water:
            self._cooldown = self.probation_rounds
            return 0.0
        return acc

    def snapshot(self) -> Dict[str, float]:
        return {str(slot): round(rate, 4)
                for slot, rate in sorted(self._ewma.items())}


def stage_drafts(state: DecodeState, drafts, draft_len) -> None:
    """Stage one round of proposals ([B, k] tokens, host or device, and the
    per-slot lengths) into the decode state in place.  ``draft_len`` is
    host-built and already carries the guards (wrap, budget, unprimed slot,
    scheduler pressure = 0)."""
    dev = state.draft_tokens.device
    drafts = torch.as_tensor(drafts, dtype=torch.int64, device=dev)
    state.draft_tokens[:, :drafts.shape[1]] = drafts
    state.draft_len.copy_(torch.as_tensor(draft_len, dtype=torch.int64))


# --------------------------------------------------------------------------- #
# batched verification
# --------------------------------------------------------------------------- #
def build_spec_verify_fn(model, *, use_ctx: bool, n_top: int, paged: bool,
                         cache_len: int, page_size: int = 0):
    """The draft-verify round: one target forward over the S = ``spec_k +
    1`` staged inputs of every slot, per-position target sampling with the
    plain per-token stream, longest-accepted-prefix selection, emission
    bookkeeping (stop tokens, budget) matching the sequential block step for
    step, and rollback of the KV cells of rejected drafts.

    The returned function updates ``cache`` and ``state`` in place and
    returns ``(emit [S, B], n_acc [B], n_emit [B], lps)`` — ``emit`` has the decode block's [steps, batch] layout with -1 for frozen
    rows, so the engine's host emit loop consumes it unchanged.

    Why row j = 0 and every emitted row are the spec-off tokens: slot b's
    inputs are ``[last_token, d_0 .. d_{k-1}]`` at positions ``p0 .. p0+k``;
    position j's logits condition on inputs < j, and position j is emitted
    only while every earlier draft equalled the plain-stream sample at its
    position — while the inputs are exactly the tokens non-speculative
    decode would have fed.  Attention for each query row is one
    ``ops.decode_attention`` (or ``ops.paged_attention``) call, never
    flash.  A slot whose ring would wrap inside the round is staged with
    ``draft_len = 0`` by the host; such a row is an exact single decode
    step."""

    def spec_verify(params, cache, state: DecodeState,
                    q_probs: Optional[torch.Tensor] = None, *, spec_k: int,
                    want_logprobs: bool = False, use_q: bool = False,
                    any_stochastic: bool = True, any_mask: bool = True):
        st = state
        b = st.last_token.shape[0]
        s = spec_k + 1
        dev = st.last_token.device
        jidx = torch.arange(s, device=dev)[None, :]                 # [1, S]
        bidx = torch.arange(b, device=dev)[:, None]
        inp = torch.cat([st.last_token[:, None],
                         st.draft_tokens[:, :spec_k]], dim=1)
        pos = st.positions[:, None] + jidx                          # [B, S]
        seq_valid = st.active[:, None] & (jidx <= st.draft_len[:, None])

        # snapshot the cells this forward may write, before it runs
        ring = pos % cache_len
        if paged:
            page = cache["page_table"][bidx, ring // page_size].long()
            off = ring % page_size
            # frozen rows redirect to the slot's reserved trash cell (their
            # page-table rows may name pages another slot owns now); a live
            # row's cells are all backed — the engine ensured capacity for
            # spec_k + 1 steps before the round
            act_cell = st.active[:, None].expand_as(page)
            bgrid = bidx.expand_as(page)
            page = torch.where(act_cell, page, bgrid // page_size)
            off = torch.where(act_cell, off, bgrid % page_size)
            snap = gather_page_cells(cache, page, off)
        else:
            snap = gather_ring_cells(cache, ring)

        out = model.apply(
            params, inp, mode="decode", positions=pos, cache=cache,
            ctx_valid=st.ctx_valid if use_ctx else None,
            seq_valid=seq_valid,
            page_table=cache["page_table"] if paged else None,
            slot_active=st.active if paged else None)
        logits = out.logits.float()                                 # [B,S,V]

        # target samples at every position with the plain per-token stream
        act = st.active
        temps = st.temps * act
        tp = torch.where(act, st.top_p, 1.0)
        tk = torch.where(act, st.top_k, 0)
        mp = torch.where(act, st.min_p, 0.0)
        x = torch.stack(
            [masked_sample_inner(logits[:, j], st.sample_key,
                                 st.positions + 1 + j, temps, tp, tk, mp,
                                 any_stochastic=any_stochastic,
                                 any_mask=any_mask)
             for j in range(s)], dim=1)                             # [B, S]

        drafts = st.draft_tokens[:, :spec_k]
        staged = jidx[:, :spec_k] < st.draft_len[:, None]
        match = (drafts == x[:, :spec_k]) & staged
        if use_q:
            # draft-model rung, stochastic rows: the rejection test
            # u·q(d) < p(d) on salted streams; greedy rows keep the match
            # rule (their p is a point mass, so the tests coincide)
            stoch = temps > 0
            acc_cols, corr_cols = [], []
            for j in range(spec_k):
                p_j = masked_probs(logits[:, j], temps, tp, tk, mp)
                q_j = q_probs[:, j].float()
                d_j = drafts[:, j:j + 1]
                pd = torch.gather(p_j, 1, d_j)[:, 0]
                qd = torch.gather(q_j, 1, d_j)[:, 0]
                step = st.positions + 1 + j
                u = salted_uniform(st.sample_key, ACCEPT_SALT, step)
                acc_cols.append(torch.where(stoch, u * qd < pd, match[:, j])
                                & staged[:, j])
                # correction ~ max(p - q, 0); an all-zero residual (q covers
                # p) falls back to p
                resid = (p_j - q_j).clamp_min(0.0)
                degenerate = (resid.sum(-1) <= 0.0)[:, None]
                target = torch.where(degenerate, torch.log(p_j),
                                     torch.log(resid))
                corr_cols.append(salted_categorical(
                    st.sample_key, CORRECTION_SALT, step, target))
            accept = torch.stack(acc_cols, dim=1)
            correction = torch.stack(corr_cols, dim=1)              # [B, k]
        else:
            accept = match

        n_acc = torch.cumprod(accept.long(), dim=1).sum(dim=1)      # [B]

        # token grid: j < n_acc -> accepted draft; j == n_acc -> correction
        # (a staged draft was rejected there) or the plain target sample;
        # match rows emit the plain target stream x verbatim
        if use_q:
            zeros = torch.zeros((b, 1), dtype=torch.int64, device=dev)
            drafts_pad = torch.cat([drafts, zeros], dim=1)
            corr_pad = torch.cat([correction, zeros], dim=1)
            rejected_at = ((jidx == n_acc[:, None])
                           & (n_acc[:, None] < st.draft_len[:, None]))
            tok = torch.where(jidx < n_acc[:, None], drafts_pad,
                              torch.where(rejected_at, corr_pad, x))
            tok = torch.where(stoch[:, None], tok, x)
        else:
            tok = x

        # emission bookkeeping, as in the sequential block: up to and
        # including the first stop, never past the budget, never past the
        # accepted prefix + 1
        is_stop = (tok[..., None] == st.stop_tokens[:, None, :]).any(-1)
        prior_ok = torch.cat(
            [torch.ones((b, 1), dtype=torch.bool, device=dev),
             torch.cumprod((~is_stop).long(), dim=1)[:, :-1].bool()], dim=1)
        emit = (act[:, None] & (jidx <= n_acc[:, None])
                & (jidx < st.budget[:, None]) & prior_ok)
        n_emit = emit.sum(dim=1)                                # >= 1 if live
        new_budget = st.budget - n_emit
        finished = act & ((emit & is_stop).any(dim=1) | (new_budget <= 0))
        new_last = torch.gather(tok, 1, (n_emit - 1).clamp_min(0)[:, None])
        new_last = torch.where(act, new_last[:, 0], st.last_token)

        # KV rollback: input j's cell is committed history iff j < n_emit
        # (j = 0 is last_token, j >= 1 the draft d_{j-1} = emitted token
        # x_{j-1}); the last emitted token's own KV is not written — it is
        # the next round's last_token, as in block decode
        keep = act[:, None] & (jidx < n_emit[:, None])
        if paged:
            restore_page_cells(cache, snap, page, off, keep)
        else:
            restore_ring_cells(cache, snap, ring, keep)

        st.last_token = new_last
        st.positions = st.positions + n_emit
        st.budget = new_budget
        st.active = act & ~finished
        st.draft_len = torch.zeros_like(st.draft_len)
        emit_toks = torch.where(emit, tok, -1).T                    # [S, B]
        lps = None
        if want_logprobs:
            lp = torch.log_softmax(logits, dim=-1)
            chosen = torch.gather(lp, 2, tok[..., None])[..., 0]    # [B, S]
            top = torch.topk(lp, n_top, dim=-1)                     # [B,S,n]
            lps = (chosen.T, top.values.transpose(0, 1),
                   top.indices.transpose(0, 1))
        return emit_toks, n_acc, n_emit, lps

    return spec_verify


# --------------------------------------------------------------------------- #
# draft sources
# --------------------------------------------------------------------------- #
class DraftSource:
    """Where proposals come from.  ``uses_q = True`` sources return draft
    distributions beside the tokens and opt stochastic rows into the
    rejection test; ``uses_q = False`` sources verify every row with the
    exact-match rule (the spec-off stream)."""

    mode = "off"
    uses_q = False

    def release(self, slot: int) -> None:
        """Forget a slot's draft state when it detaches from its request."""


class NGramDraftSource(DraftSource):
    """Self-speculative rung: host-side prompt lookup, no device state."""

    mode = "ngram"
    uses_q = False

    def __init__(self, max_n: int = 3, min_n: int = 1):
        self.proposer = NGramProposer(max_n=max_n, min_n=min_n)

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        return self.proposer.propose(history, k)


class DraftModelSource(DraftSource):
    """Draft-model rung: a second config decodes ``spec_k`` tokens ahead of
    the target in its own dense pool on the engine's device, which mirrors
    the target's slot layout (same slot indices and ring length, so the
    host's wrap guard covers both pools).

    A round is ``spec_k`` chained single-token decode steps sampling from
    the draft's masked distribution at the target row's sampler knobs
    (salted stream; greedy rows take the draft's argmax), returning the
    drafts, their distributions ``q`` and a pre-round snapshot of the ring
    cells written, so :meth:`fixup` can roll back rejected cells after the
    verify.  No host sync in the round.  ``prefills`` counts the prime
    prefills run (each one flash call per draft layer)."""

    mode = "draft"
    uses_q = True

    def __init__(self, cfg, params=None, *, max_batch: int, cache_len: int,
                 seed: int = 0, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = Model(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init(gen, self.device)
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.pool = SlotKVPool(cfg, max_batch, cache_len, device=self.device)
        self.state = init_decode_state(max_batch, 1, device=self.device)
        # slots whose draft KV mirrors the target history; a slot whose
        # history no longer fits one prime prefill stays unprimed and never
        # drafts (the reference's known limit)
        self._primed = np.zeros((max_batch,), bool)
        self.prefills = 0

    # -- admission ----------------------------------------------------- #
    def admit(self, slots, last, positions, temps, top_p, top_k, min_p,
              keys, active) -> None:
        primed = self._primed[np.asarray(slots)]
        admit_decode_state(
            self.state, slots, last_token=last, positions=positions,
            temps=temps, top_p=top_p, top_k=top_k, min_p=min_p,
            sample_key=keys, active=np.asarray(active, bool) & primed)

    def prime(self, slot: int, history: Sequence[int]) -> None:
        """Prefill the draft pool with the slot's committed history (every
        token but the pending last one): one padded-bucket batch=1 forward
        into a fresh cache, installed into the slot."""
        ln = len(history) - 1
        if ln > self.cache_len:
            self._primed[slot] = False
            return
        if ln > 0:
            bucket = 32
            while bucket < ln:
                bucket *= 2
            bucket = min(bucket, self.cache_len)
            toks = torch.zeros((1, bucket), dtype=torch.int64)
            toks[0, :ln] = torch.as_tensor(list(history[:ln]))
            ar = torch.arange(bucket, device=self.device)[None]
            cache = init_cache(self.cfg, 1, self.cache_len,
                               device=self.device)
            self.model.apply(self.params, toks.to(self.device),
                             mode="prefill", positions=ar, cache=cache,
                             seq_valid=ar < ln, logits_mode="last")
            self.pool.insert(slot, cache)
            self.prefills += 1
        self._primed[slot] = True

    def release(self, slot: int) -> None:
        self._primed[slot] = False

    def primed(self, slot: int) -> bool:
        return bool(self._primed[slot])

    def reset(self) -> None:
        """Rebuild the draft pool and state; every slot re-primes at its
        next admission."""
        self.pool = SlotKVPool(self.cfg, self.max_batch, self.cache_len,
                               device=self.device)
        self.state = init_decode_state(self.max_batch, 1, device=self.device)
        self._primed[:] = False

    # -- per-round flow -------------------------------------------------- #
    def _grid(self, start_pos: torch.Tensor, spec_k: int) -> torch.Tensor:
        return (start_pos[:, None]
                + torch.arange(spec_k, device=start_pos.device)[None, :]
                ) % self.cache_len

    def draft_round(self, spec_k: int):
        """Run the draft block; returns ``(snap, start_pos, drafts, q)``
        with drafts/q on the device ([B, k] / [B, k, V])."""
        st = self.state
        start_pos = st.positions.clone()
        snap = gather_ring_cells(self.pool.cache, self._grid(start_pos, spec_k))
        act = st.active
        temps = st.temps * act
        tp = torch.where(act, st.top_p, 1.0)
        tk = torch.where(act, st.top_k, 0)
        mp = torch.where(act, st.min_p, 0.0)
        last, pos = st.last_token, start_pos
        ds, qs = [], []
        for _ in range(spec_k):
            out = self.model.apply(self.params, last[:, None], mode="decode",
                                   positions=pos[:, None],
                                   cache=self.pool.cache, slot_active=act)
            q = masked_probs(out.logits[:, 0], temps, tp, tk, mp)
            d = salted_categorical(st.sample_key, DRAFT_SALT, pos + 1,
                                   torch.log(q))
            ds.append(d)
            qs.append(q)
            last = torch.where(act, d, last)
            pos = pos + act.long()
        return snap, start_pos, torch.stack(ds, dim=1), torch.stack(qs, dim=1)

    def fixup(self, spec_k: int, snap, start_pos: torch.Tensor,
              target_state: DecodeState) -> None:
        """Roll back the rejected draft cells and sync the draft state to
        the verified target state.  The synced leaves are *copies*: the
        engine scatters admissions into its state tensors in place, which
        would otherwise reach the draft state through shared storage."""
        n_emit = target_state.positions - start_pos
        keep = self.state.active[:, None] & (
            torch.arange(spec_k, device=start_pos.device)[None, :]
            < n_emit[:, None])
        restore_ring_cells(self.pool.cache, snap,
                           self._grid(start_pos, spec_k), keep)
        primed = torch.as_tensor(self._primed, device=self.device)
        self.state.last_token = target_state.last_token.clone()
        self.state.positions = target_state.positions.clone()
        self.state.active = target_state.active & primed

    @property
    def nbytes(self) -> int:
        return self.pool.nbytes


# --------------------------------------------------------------------------- #
# host reference (property tests)
# --------------------------------------------------------------------------- #
def verify_reference(logits_rows: np.ndarray, drafts: Sequence[int],
                     q_rows: Optional[np.ndarray], base_key,
                     start_pos: int, temperature: float, top_p: float,
                     top_k: int, min_p: float, use_q: bool) -> List[int]:
    """Host mirror of one verify round for ONE slot, given the target's
    per-position logits rows [S, V] (from running the target one token at
    a time): the emitted tokens before stop/budget bookkeeping.

    An independent implementation of the acceptance math (match rule, or
    the rejection test + residual correction when ``use_q``) on numpy, with
    the keep-set of :func:`keep_set_reference`; only the random streams
    themselves (plain, and salted with the same salts as the device round)
    are the port's functions."""
    s = logits_rows.shape[0]
    k = s - 1
    key = torch.from_numpy(np.asarray(base_key, np.int64).reshape(1, 2))

    def at(j):
        return torch.tensor([start_pos + 1 + j], dtype=torch.int64)

    def dist(row):
        if temperature <= 0:
            out = np.zeros(row.shape, np.float32)
            out[int(np.argmax(row))] = 1.0
            return out
        keep = keep_set_reference(row, temperature, top_p, top_k, min_p)
        scaled = np.asarray(row, np.float32) / np.float32(max(temperature,
                                                              1e-6))
        e = np.where(keep, np.exp(scaled - scaled[keep].max()), 0.0)
        return (e / e.sum()).astype(np.float32)

    def plain_sample(j):
        row = np.asarray(logits_rows[j], np.float32)
        if temperature <= 0:
            return int(np.argmax(row))
        keep = keep_set_reference(row, temperature, top_p, top_k, min_p)
        scaled = row / np.float32(max(temperature, 1e-6))
        noise = gumbel(fold_in(key, at(j)), row.size)[0].numpy()
        return int(np.argmax(np.where(keep, noise + scaled, -np.inf)))

    x = [plain_sample(j) for j in range(s)]
    emitted: List[int] = []
    for j in range(k):
        d = int(drafts[j])
        if use_q and temperature > 0:
            p_j, q_j = dist(logits_rows[j]), np.asarray(q_rows[j], np.float32)
            u = float(salted_uniform(key, ACCEPT_SALT, at(j))[0])
            if u * q_j[d] < p_j[d]:
                emitted.append(d)
                continue
            resid = np.maximum(p_j - q_j, 0.0)
            target = p_j if resid.sum() <= 0 else resid
            with np.errstate(divide="ignore"):
                logt = torch.from_numpy(np.log(target)[None])
            emitted.append(int(salted_categorical(key, CORRECTION_SALT,
                                                  at(j), logt)[0]))
            return emitted
        emitted.append(x[j])
        if d != x[j]:
            return emitted
    emitted.append(x[k])
    return emitted
