"""The engine's decode step over static buffers, replayed as a CUDA graph.

:class:`DecodeGraphs` owns one decode step's inputs and outputs as device
buffers of fixed address: the :class:`~repro_torch.core.kv_cache.DecodeState`
fields a step reads, and the step's token row (with logprobs, the chosen
token's logprob and the ``[B, n_top]`` top values and ids).
:meth:`DecodeGraphs.step` is one decode step over them — the forward, the
sampler, stop and budget accounting — and writes the fields it advances
(``last_token``, ``positions``, ``budget``, ``active``) in place.
:meth:`DecodeGraphs.run` copies the engine's state in, runs K steps, copies
each step's outputs into row k of ``[max_steps, B, ...]`` block buffers, and
copies the advanced fields back.  Every other writer of the engine's state
(admissions, the speculative round, recovery, preemption) is left as it is.

On a CUDA engine whose parameters are plain tensors, the first block of each
variant ``(want_logprobs, any_stochastic, any_mask)`` runs its first step
eagerly on a side stream (the warm-up), then captures the step into a
:class:`torch.cuda.CUDAGraph`, in one memory pool for the runner's graphs;
every later step of that variant is one replay.  A capture that fails
raises.  Elsewhere — CPU engines, DTensor parameters — the same step runs
eagerly over the same buffers.  A graph reads the arena, its page table and
the parameters at the addresses they had at capture, so the engine drops
the runner before it rebuilds the arena.

The kernel wrappers' ``launches`` counters stay what the card ran: a
capture's launches are recorded apart (:func:`repro_torch.kernels.build.
recording_launches`) and added at every replay.
"""
from __future__ import annotations

import threading
from types import SimpleNamespace
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.kv_cache import DecodeState
from repro_torch.core.sampling import masked_sample_inner
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels import build
from repro_torch.models.model import tree_leaves
from repro_torch.tracing import TRACER

#: the state fields a step reads, and those it advances
READ = ("last_token", "positions", "temps", "top_p", "top_k", "min_p",
        "sample_key", "ctx_valid", "budget", "stop_tokens", "active")
ADVANCED = ("last_token", "positions", "budget", "active")

Variant = Tuple[bool, bool, bool]   # want_logprobs, any_stochastic, any_mask

# one capture at a time in the process: replicas of the engine, each on its
# own loop thread, reach their first blocks together
_CAPTURE_LOCK = threading.Lock()


def graphs_usable(device: torch.device, params: Any) -> bool:
    """Whether a decode step can be captured: a CUDA device and plain
    tensors (a DTensor's collectives and redistributions stay eager)."""
    return device.type == "cuda" and not any(
        is_dtensor(t) for t in tree_leaves(params))


class DecodeGraphs:
    """The decode step's buffers and graphs for one engine's model,
    parameters and pool (see the module docstring)."""

    def __init__(self, model, params, pool, state: DecodeState, *,
                 paged: bool, use_ctx: bool, n_top: int, max_steps: int):
        self.model, self.params, self.cache = model, params, pool.cache
        self.paged, self.use_ctx, self.n_top = paged, use_ctx, n_top
        dev = state.active.device
        self.use_graphs = graphs_usable(dev, params)
        self.buf = SimpleNamespace(**{n: getattr(state, n).clone()
                                      for n in READ})
        b = state.active.shape[0]
        i64, f32 = dict(dtype=torch.int64, device=dev), dict(device=dev)
        self.tok = torch.empty((b,), **i64)
        self.lp_c = torch.empty((b,), **f32)
        self.lp_v = torch.empty((b, n_top), **f32)
        self.lp_i = torch.empty((b, n_top), **i64)
        self.block = (torch.empty((max_steps, b), **i64),
                      torch.empty((max_steps, b), **f32),
                      torch.empty((max_steps, b, n_top), **f32),
                      torch.empty((max_steps, b, n_top), **i64))
        # variant -> (graph, launches a replay adds)
        self.graphs: Dict[Variant, Tuple[Any, Dict]] = {}
        self.mempool = torch.cuda.graph_pool_handle() if self.use_graphs \
            else None
        self.replayed = self.captured = 0     # since the last take_counts

    def step(self, want_logprobs: bool, any_stochastic: bool,
             any_mask: bool) -> None:
        """One decode+sample step over the buffers, in place.  Frozen slots'
        sampler fields are neutralised, as in the reference, so a finished
        request's knobs cannot matter; a frozen slot's token is -1."""
        s = self.buf
        out = self.model.apply(
            self.params, s.last_token[:, None], mode="decode",
            positions=s.positions[:, None], cache=self.cache,
            slot_active=s.active,
            page_table=self.cache["page_table"] if self.paged else None,
            ctx_valid=s.ctx_valid if self.use_ctx else None)
        logits = out.logits[:, 0]
        act = s.active
        nxt = masked_sample_inner(
            logits, s.sample_key, s.positions + 1, s.temps * act,
            torch.where(act, s.top_p, 1.0), torch.where(act, s.top_k, 0),
            torch.where(act, s.min_p, 0.0),
            any_stochastic=any_stochastic, any_mask=any_mask)
        nxt = torch.where(act, nxt, s.last_token)
        self.tok.copy_(torch.where(act, nxt, -1))
        alive = act.long()
        s.budget.sub_(alive)
        hit_stop = (nxt[:, None] == s.stop_tokens).any(-1)
        finished = act & (hit_stop | (s.budget <= 0))
        if want_logprobs:
            lp = torch.log_softmax(logits.float(), dim=-1)
            self.lp_c.copy_(torch.gather(lp, 1, nxt[:, None])[:, 0])
            top = torch.topk(lp, self.n_top, dim=-1)
            self.lp_v.copy_(top.values)
            self.lp_i.copy_(top.indices)
        s.last_token.copy_(nxt)
        s.positions.add_(alive)
        s.active.copy_(act & ~finished)

    def run(self, state: DecodeState, num_steps: int, want_logprobs: bool,
            any_stochastic: bool, any_mask: bool):
        """K steps from ``state``, which ends advanced as the steps left the
        buffers.  Returns the ``[K, B]`` token block and, with logprobs,
        ``([K, B], [K, B, n_top], [K, B, n_top])``: views of the block
        buffers, valid until the next run.  The copies go one list a call:
        each torch call from Python gives up the interpreter lock, which the
        serving front's threads then hold."""
        torch._foreach_copy_([getattr(self.buf, n) for n in READ],
                             [getattr(state, n) for n in READ])
        variant = (want_logprobs, any_stochastic, any_mask)
        outs = ([self.tok, self.lp_c, self.lp_v, self.lp_i] if want_logprobs
                else [self.tok])
        for k in range(num_steps):
            self._one_step(variant)
            torch._foreach_copy_([b[k] for b in self.block[:len(outs)]], outs)
        torch._foreach_copy_([getattr(state, n) for n in ADVANCED],
                             [getattr(self.buf, n) for n in ADVANCED])
        toks, lp_c, lp_v, lp_i = (b[:num_steps] for b in self.block)
        return toks, ((lp_c, lp_v, lp_i) if want_logprobs else None)

    def take_counts(self) -> Tuple[int, int]:
        """Steps replayed and steps captured since the last call: the engine
        counts them when it counts the block's device steps."""
        counts, self.replayed, self.captured = \
            (self.replayed, self.captured), 0, 0
        return counts

    def _one_step(self, variant: Variant) -> None:
        if not self.use_graphs:
            self.step(*variant)
            return
        if variant not in self.graphs:
            self._warm_up_and_capture(variant)     # its warm-up is the step
            return
        graph, launches = self.graphs[variant]
        graph.replay()
        build.add_launches(launches)
        self.replayed += 1

    def _warm_up_and_capture(self, variant: Variant) -> None:
        """Run the step eagerly on a side stream (a real step: it advances
        the buffers), then capture it, which runs nothing."""
        side, main = torch.cuda.Stream(), torch.cuda.current_stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.step(*variant)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, TRACER.span("engine.graph_capture"), \
                build.recording_launches() as launches, \
                torch.cuda.graph(graph, pool=self.mempool,
                                 capture_error_mode="thread_local"):
            self.step(*variant)
        self.graphs[variant] = (graph, launches)
        self.captured += 1
