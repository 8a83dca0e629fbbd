"""Preemption, a lost snapshot, handoff and the speculation gate of the
port's engine on the recurrent families, against the JAX package's engine
on the CPU with the same weights (bridged, float32), on ``mamba2-780m`` and
``jamba-1.5-large-398b`` reduced (the harness of
``tests/test_torch_ssm_engine.py``).

A policy preemption restores ``conv``/``state`` from its snapshot (a dense
copy; on pages the dense per-slot leaves ride beside the page refs,
``read_nonkv``), a snapshot lost to the LRU re-prefills prompt + history, a
handoff moves live slots as dense snapshots, and speculative decoding is
refused with the reference's message.  Tokens and the preemption counters
identical.
"""
import numpy as np
import pytest

from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import Request, SamplingParams
from test_torch_preemption import (LAYOUTS, _preempt_scenario,  # noqa: F401
                                   _same, jx)
from test_torch_ssm_engine import MODELS, _prompts, bridged  # noqa: F401
from test_torch_ssm_engine import quiet_ladder  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("layout,prefix_cache", [("dense", True),
                                                 ("paged-fp", False)])
def test_preemption_restores_recurrent_state(bridged, layout, prefix_cache):
    """The urgent request evicts the batch one on ``mamba2-780m``; it
    resumes from its snapshot (``conv``/``state`` copied out and back):
    step for step as the JAX engine, and the batch request's tokens equal
    the port's own FIFO run of the same traffic."""
    w = bridged("mamba2-780m")
    p, (jb, tb), (ju, tu) = _preempt_scenario(
        w, prefix_cache=prefix_cache, **LAYOUTS[layout])
    _same(jb, tb)
    _same(ju, tu)
    stats = p.te.scheduler.stats
    assert stats.preemptions >= 1 and stats.resumed >= 1
    _, (_, fb), (_, fu) = _preempt_scenario(
        w, policy="fifo", preemption=False, prefix_cache=prefix_cache,
        with_jax=False, **LAYOUTS[layout])
    assert tb.output_tokens == fb.output_tokens
    assert tu.output_tokens == fu.output_tokens


@pytest.mark.parametrize("name", MODELS)
def test_lost_snapshot_reprefills_as_the_reference(bridged, name):
    """A snapshot squeezed out of the prefix cache's byte budget: the batch
    request re-prefills its prompt + history (the recurrent state rebuilt
    from the tokens), as the JAX engine does."""
    p, (jb, tb), (ju, tu) = _preempt_scenario(bridged(name),
                                              cache_max_bytes=1)
    _same(jb, tb)
    _same(ju, tu)
    assert p.te.scheduler.stats.preemptions >= 1
    assert p.te.scheduler.stats.resumed == 0
    assert tb.num_generated == 24 and tu.num_generated == 6


def _handoff(engine_cls, cfg, params, req_cls, samp_cls, prompts, kw,
             device):
    a = engine_cls(cfg, params, **device, **kw)
    reqs = [req_cls(prompt_tokens=t, sampling=samp_cls(max_tokens=12))
            for t in prompts]
    for r in reqs:
        a.add_request(r)
    for _ in range(4):
        a.step()
    live = len(a._live_slots)
    records = a.export_handoff()
    b = engine_cls(cfg, params, **device, **kw)
    for rec in records:
        b.import_handoff(rec)
    while b.scheduler.has_work:
        b.step()
    return reqs, live, b.scheduler.stats.resumed


@pytest.mark.parametrize("name,layout", [("mamba2-780m", "dense"),
                                         ("jamba-1.5-large-398b",
                                          "paged-fp")])
def test_handoff_matches_reference(bridged, name, layout):
    """Export mid-decode from one engine and import into another: live
    slots move as dense snapshots (their ``conv``/``state`` with them), the
    rest re-prefill; tokens equal the JAX engine's through the same
    handoff and an uninterrupted run."""
    jcfg, tcfg, jp, tp, jx = bridged(name)
    kw = dict(max_batch=2, cache_len=128, prefill_chunk=32,
              speculative_fill=False, **LAYOUTS[layout])
    prompts = _prompts()[:3]
    jr, jlive, jres = _handoff(jx.Engine, jcfg, jp, jx.Request,
                               jx.SamplingParams, prompts, kw, {})
    tr, tlive, tres = _handoff(InferenceEngine, tcfg, tp, Request,
                               SamplingParams, prompts, kw,
                               {"device": "cpu"})
    assert (tlive, tres) == (jlive, jres) and tres >= 1
    for a, b in zip(jr, tr):
        _same(a, b)
    ref = InferenceEngine(tcfg, tp, device="cpu", **kw)
    whole = [Request(prompt_tokens=t, sampling=SamplingParams(max_tokens=12))
             for t in prompts]
    ref.generate(whole)
    assert [r.output_tokens for r in whole] == [r.output_tokens for r in tr]


@pytest.mark.parametrize("name", MODELS)
def test_speculation_is_refused_as_the_reference_refuses_it(bridged, name):
    jcfg, tcfg, jp, tp, jx = bridged(name)
    with pytest.raises(ValueError) as want:
        jx.Engine(jcfg, jp, spec_mode="ngram")
    with pytest.raises(ValueError) as got:
        InferenceEngine(tcfg, tp, device="cpu", spec_mode="ngram")
    assert str(got.value) == str(want.value)
    assert "recurrent state" in str(got.value)
