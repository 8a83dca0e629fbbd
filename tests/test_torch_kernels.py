"""The port's kernels (attention and the int8-weight matmul): plain PyTorch
versions held to the JAX package's functions on the CPU, and (on a CUDA
card, marker ``gpu``) each hand-written CUDA kernel held to its plain
version.

Inputs come from numpy seeds and pass to both frameworks as numpy arrays.
The JAX package is imported inside the CPU tests only, so the ``gpu`` tests
also run on a machine that has no JAX::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels.py

Tolerances: float32 plain vs JAX atol 2e-5 / rtol 1e-3 (as
``tests/test_kernels.py``), the split-S mirror of the decode kernel vs JAX
atol 1e-5 (summation order only); kernel vs plain on the card bf16 atol 2e-2 (one
bf16 rounding of an O(1) output), float32 atol 1e-4 (summation order only).
``quant_matmul``, whose outputs grow with K, is held relative to the
output's largest magnitude: 1e-4 in float32 (summation order, and the
reference's oracle scales the weights before the sum, the kernel after) and
1e-2 in bf16 (one bf16 rounding, 2**-7, of the largest output); the
split-K mirror with bf16-valued inputs in float32 is held at 1e-5 (its
products are exact, only the order of the sums differs).
"""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.decode_attention import (MIN_SPLIT_KEYS,
                                                  decode_attention_cuda,
                                                  decode_attention_plain,
                                                  decode_attention_split_plain,
                                                  plan_splits, split_bounds)
from repro_torch.kernels.flash_attention import (TILE_KEYS, TILE_ROWS,
                                                 dead_rows, fill_dead_rows,
                                                 flash_attention_cuda,
                                                 flash_attention_plain,
                                                 live_mask, packed_rows,
                                                 tile_range)
from repro_torch.kernels import paged_attention as pag
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)
from repro_torch.kernels.quant_matmul import (k_split_bounds, plan_k_splits,
                                              quant_matmul_cuda,
                                              quant_matmul_plain,
                                              quant_matmul_split_plain,
                                              quantize_int8, quantize_kv_int8)
from torch_threads import one_torch_thread  # noqa: F401

F32 = dict(atol=2e-5, rtol=1e-3)
CARD_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
QMM_REL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# (M, K, N): ragged M, K and N, M on both sides of the kernel's 8-row split
QMM_SHAPES = [(16, 64, 32), (5, 100, 40), (24, 96, 130), (9, 33, 48)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernel modules (CPU tests only)."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import decode_attention_pallas
    from repro.kernels.flash_attention import flash_attention_pallas
    from repro.kernels.quant_matmul import (quant_matmul_pallas,
                                            quantize_int8)
    return dict(jnp=jnp, ops=jops, ref=jref,
                decode_pallas=decode_attention_pallas,
                flash_pallas=flash_attention_pallas,
                qmm_pallas=quant_matmul_pallas, quantize_int8=quantize_int8)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _flash_inputs(seed, b, sq, skv, h, hkv, d):
    return _np(seed, b, sq, h, d), _np(seed + 1, b, skv, hkv, d), \
        _np(seed + 2, b, skv, hkv, d)


def _engine_rows(seed, b, sq, skv):
    """Per-row resume offsets as the engine's prefill waves give them:
    row i continues at ``start[i]`` over a cache whose live cells are
    ``[0, start[i] + sq)``; every query row sees at least one key."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, skv - sq + 1, size=b)
    qpos = (start[:, None] + np.arange(sq)[None]).astype(np.int32)
    kv_valid = np.arange(skv)[None] < (start + sq)[:, None]
    return qpos, kv_valid


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------- #
# oracles: the torch ref.py against the JAX package's ref.py
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (False, 0, 0), (True, 24, 0), (True, 0, 7)])
def test_flash_ref_matches_jax_ref(jx, causal, window, q_offset):
    q, k, v = _flash_inputs(0, 2, 24, 48, 14, 2, 64)
    want = jx["ref"].flash_attention_ref(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                  window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_decode_ref_matches_jax_ref(jx):
    q, kc, vc = _np(1, 3, 14, 64), _np(2, 3, 100, 2, 64), _np(3, 3, 100, 2, 64)
    valid = np.arange(100)[None] < np.array([[1], [37], [100]])
    want = jx["ref"].decode_attention_ref(q, kc, vc, valid)
    got = ref.decode_attention_ref(_t(q), _t(kc), _t(vc), _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    assert ref.NEG_INF == jx["ref"].NEG_INF
    np.testing.assert_array_equal(
        ref.repeat_kv(_t(kc), 14).numpy(),
        np.asarray(jx["ref"].repeat_kv(kc, 14)))


# --------------------------------------------------------------------------- #
# plain versions against the JAX package's jnp paths
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,window,q_offset", [
    (2, 24, 40, 14, 2, 64, True, 0, 0),       # G = 7, ragged S
    (1, 16, 48, 4, 4, 32, True, 0, 32),       # q_offset (chunked prefill)
    (2, 33, 70, 6, 2, 128, True, 20, 5),      # window + q_offset
    (2, 20, 20, 8, 2, 64, False, 0, 0),       # non-causal
])
def test_flash_plain_matches_jax(jx, b, sq, skv, h, hkv, d, causal, window,
                                 q_offset):
    q, k, v = _flash_inputs(10, b, sq, skv, h, hkv, d)
    want = jx["ops"]._flash_jnp(q, k, v, causal=causal, window=window,
                                q_offset=q_offset, chunk=16)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                window=window, q_offset=q_offset, chunk=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("window", [0, 9])
def test_flash_plain_engine_form_matches_jax(jx, window):
    """The engine's resume-prefill call: per-row q_positions and kv_valid."""
    b, sq, skv, h, hkv, d = 3, 16, 64, 14, 2, 64
    q, k, v = _flash_inputs(20, b, sq, skv, h, hkv, d)
    qpos, kv_valid = _engine_rows(21, b, sq, skv)
    want = jx["ops"].flash_attention(q, k, v, causal=True, window=window,
                                     q_positions=qpos, kv_valid=kv_valid,
                                     chunk=32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              window=window, q_positions=_t(qpos),
                              kv_valid=_t(kv_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("window", [8, 16])
def test_flash_plain_rows_with_no_live_key_match_jax(jx, window):
    """Queries past ``Skv + window - 2`` over a 16-slot ring see no key:
    the plain version gives the reference's value there (the mean of V),
    and :func:`fill_dead_rows` gives the same on rows a kernel left at 0."""
    b, sq, ring, h, hkv, d = 3, 16, 16, 4, 2, 32
    q, k, v = _flash_inputs(30, b, sq, ring, h, hkv, d)
    # rows resume at 0, 16 and 32 over a ring whose every cell is written
    qpos = (np.array([0, 16, 32])[:, None] + np.arange(sq)).astype(np.int32)
    kv_valid = np.ones((b, ring), bool)
    want = np.asarray(jx["ops"].flash_attention(
        q, k, v, causal=True, window=window, q_positions=qpos,
        kv_valid=kv_valid))
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                window=window, q_positions=_t(qpos),
                                kv_valid=_t(kv_valid))
    np.testing.assert_allclose(got.numpy(), want, **F32)
    dead = dead_rows(_t(qpos), ring, causal=True, window=window,
                     kv_valid=_t(kv_valid))
    assert bool(dead[2].all()) and not bool(dead[0].any())
    zeroed = torch.where(dead[:, :, None, None], 0.0, got)
    filled = fill_dead_rows(zeroed, _t(v), _t(qpos), causal=True,
                            window=window, kv_valid=_t(kv_valid))
    np.testing.assert_allclose(filled.numpy(), want, **F32)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 5, 20])
def test_dead_rows_are_the_rows_live_mask_leaves_empty(causal, window):
    rng = np.random.default_rng(window + causal)
    qpos = _t(rng.integers(-2, 45, (3, 30)))
    kv_valid = _t(rng.random((3, 16)) > 0.6)
    for kv in (None, kv_valid):
        want = ~live_mask(qpos, 16, causal=causal, window=window,
                          kv_valid=kv).any(-1)
        assert torch.equal(dead_rows(qpos, 16, causal=causal, window=window,
                                     kv_valid=kv), want)


@pytest.mark.parametrize("b,s,h,hkv,d", [
    (3, 100, 14, 2, 64),                      # G = 7, S not a tile multiple
    (2, 48, 8, 2, 32),
    (2, 64, 4, 1, 128),
])
def test_decode_plain_matches_jax(jx, b, s, h, hkv, d):
    q, kc, vc = _np(30, b, h, d), _np(31, b, s, hkv, d), _np(32, b, s, hkv, d)
    lengths = np.random.default_rng(33).integers(1, s + 1, size=b)
    lengths[0] = s                            # one wrapped (all-valid) row
    valid = np.arange(s)[None] < lengths[:, None]
    want = jx["ops"]._decode_jnp(q, kc, vc, valid)
    got = ops.decode_attention(_t(q), _t(kc), _t(vc), _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_decode_plain_all_masked_row_is_zero(jx):
    q, kc, vc = _np(34, 2, 14, 64), _np(35, 2, 32, 2, 64), _np(36, 2, 32, 2, 64)
    valid = np.zeros((2, 32), bool)
    valid[1, :5] = True
    got = decode_attention_plain(_t(q), _t(kc), _t(vc), _t(valid)).numpy()
    want = np.asarray(jx["ops"]._decode_jnp(q, kc, vc, valid))
    assert not got[0].any()
    np.testing.assert_allclose(got, want, **F32)


def test_flash_plain_cross_attention_form_matches_jax(jx):
    """Cross-attention prefill: non-causal at D = 128, query group 8, with a
    per-row context liveness mask (one row keeps a single live key)."""
    b, sq, skv, h, hkv, d = 3, 12, 72, 16, 2, 128
    q, k, v = _flash_inputs(24, b, sq, skv, h, hkv, d)
    kv_valid = np.arange(skv)[None] < np.array([[72], [36], [1]])
    want = jx["ops"]._flash_jnp(q, k, v, causal=False, window=0, q_offset=0,
                                kv_valid=kv_valid, chunk=32)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False,
                              kv_valid=_t(kv_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# --------------------------------------------------------------------------- #
# the decode kernel's split-S algorithm and its plan of splits
# --------------------------------------------------------------------------- #
def _decode_mask(kind, b, s):
    """``masked``: row 0 all masked, row 1 live on its first 5 keys only
    (every later split all-masked); ``ring``: a wrapped ring with random
    dead cells; ``ragged``: per-row lengths with one full row."""
    rng = np.random.default_rng(37)
    if kind == "ring":
        return rng.random((b, s)) > 0.35
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = s
    valid = np.arange(s)[None] < lengths[:, None]
    if kind == "masked":
        valid[0] = False
        valid[1] = np.arange(s) < 5
    return valid


@pytest.mark.parametrize("mask", ["masked", "ring", "ragged"])
@pytest.mark.parametrize("splits", ["one", "three", "every key"])
def test_decode_split_plain_matches_jax(jx, mask, splits):
    """Partials and then the combine, in the kernel's order, against the
    reference's one-contraction ``_decode_jnp`` and its oracle."""
    b, s, h, hkv, d = 4, 70, 14, 2, 32
    q, kc, vc = _np(70, b, h, d), _np(71, b, s, hkv, d), _np(72, b, s, hkv, d)
    valid = _decode_mask(mask, b, s)
    n = {"one": 1, "three": 3, "every key": s}[splits]
    got = decode_attention_split_plain(_t(q), _t(kc), _t(vc), _t(valid),
                                       n).numpy()
    for want in (jx["ops"]._decode_jnp(q, kc, vc, valid),
                 jx["ref"].decode_attention_ref(q, kc, vc, valid)):
        want = np.asarray(want)
        if mask == "masked":                  # the reference's oracle gives
            want = want.copy()                # a uniform mean there; the
            want[0] = 0.0                     # contract (and _decode_jnp) 0
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if mask == "masked":
        assert not got[0].any()


@pytest.mark.parametrize("s,bh", [(2048, 16), (2304, 64), (1000, 6),
                                  (777, 10), (63, 16), (1, 4), (64, 1),
                                  (100000, 512)])
def test_plan_splits_covers_every_key_once(s, bh):
    n = plan_splits(s, bh, 132)
    bounds = split_bounds(s, n)
    owner = np.zeros(s, int)
    for lo, hi in bounds:
        owner[lo:hi] += 1
        assert hi - lo >= min(MIN_SPLIT_KEYS, s)
    assert (owner == 1).all()
    assert n == 1 or n * bh >= 2 * 132 or n == s // MIN_SPLIT_KEYS


@pytest.mark.parametrize("shape", ["text", "cross"])
def test_plan_splits_fills_the_card_at_the_serving_shapes(shape):
    """Text decode (B8 Hkv2, S2048) and cross decode (B8 Hkv8, 2304 slots)
    on a 132-SM H100: at least two blocks per SM."""
    s, bh = {"text": (2048, 16), "cross": (2304, 64)}[shape]
    assert plan_splits(s, bh, 132) * bh >= 264


# --------------------------------------------------------------------------- #
# the bf16 flash kernel's row packing and tile skipping, mirrored
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("g", [1, 7, 8])
def test_flash_packed_rows_are_a_bijection(g):
    rows = packed_rows(g)
    tokens = TILE_ROWS // g
    used = [rc for rc in rows if rc is not None]
    assert len(rows) == TILE_ROWS and len(used) == tokens * g
    assert sorted(used) == [(t, h) for t in range(tokens) for h in range(g)]
    assert all(rc is None for rc in rows[tokens * g:])


def _flash_form(form):
    """(qpos [B, Sq], kv_valid [B, Skv] or None, causal, window, G)."""
    b, sq, skv = 3, 50, 300
    if form == "engine":
        qpos, kv_valid = _engine_rows(80, b, sq, skv)
        return qpos, kv_valid, True, 0, 7
    if form == "window":
        qpos, kv_valid = _engine_rows(81, b, sq, skv)
        return qpos, kv_valid, True, 70, 7
    qpos = np.zeros((b, sq), np.int32)                 # cross: non-causal
    kv_valid = np.arange(skv)[None] < np.array([[300], [130], [1]])
    return qpos, kv_valid, False, 0, 8


@pytest.mark.parametrize("form", ["engine", "window", "cross"])
def test_flash_tile_skip_never_drops_a_live_pair(form):
    """Every (query, key) pair that ``live_mask`` holds live lies in a KV
    tile the kernel visits for the query's packed CTA."""
    qpos, kv_valid, causal, window, g = _flash_form(form)
    b, sq = qpos.shape
    skv = kv_valid.shape[1]
    mask = live_mask(_t(qpos), skv, causal=causal, window=window,
                     kv_valid=_t(kv_valid)).numpy()
    tpb = TILE_ROWS // g
    visited_any = False
    for row in range(b):
        for t0 in range(0, sq, tpb):
            tiles = tile_range(qpos[row, t0:t0 + tpb], skv, causal=causal,
                               window=window)
            seen = np.zeros(skv, bool)
            for kt in tiles:
                seen[kt * TILE_KEYS:(kt + 1) * TILE_KEYS] = True
            assert not mask[row, t0:t0 + tpb][:, ~seen].any()
            visited_any |= len(tiles) < -(-skv // TILE_KEYS)
    assert visited_any or not causal          # causal forms do skip tiles


# --------------------------------------------------------------------------- #
# int8-weight matmul: quantiser bit-identical, plain version vs JAX
# --------------------------------------------------------------------------- #
def _qmm_inputs(seed, m, k, n):
    return _np(seed, m, k), _np(seed + 1, k, n) * 0.2


def _rel_close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, f"max |got - want| / max |want| = {err}"


@pytest.mark.parametrize("shape", [(64, 32), (100, 40), (7, 130)])
def test_quantize_int8_bit_identical_to_jax(jx, shape):
    w = _np(60, *shape) * 0.3
    w[0, :3] = [0.0, 127.5 / 127.0, -2.5]      # zero and round-half columns
    jq, js = jx["quantize_int8"](w)
    tq, ts = quantize_int8(_t(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("m,k,n", QMM_SHAPES)
def test_quant_matmul_plain_matches_pallas_interpret_and_ref(jx, m, k, n):
    """Plain version and ``ops.quant_matmul`` on the CPU against the Pallas
    kernel in interpret mode (as ``tests/test_kernels.py`` runs it) and
    the reference's oracle; the port's oracle against the reference's."""
    x, w = _qmm_inputs(61, m, k, n)
    wq, sc = jx["quantize_int8"](w)
    wq, sc = np.asarray(wq), np.asarray(sc)
    pallas = jx["qmm_pallas"](x, wq, sc, block_m=8, block_n=128, block_k=32,
                              interpret=True)
    jref = jx["ref"].quant_matmul_ref(x, wq, sc)
    plain = quant_matmul_plain(_t(x), _t(wq), _t(sc))
    dispatched = ops.quant_matmul(_t(x), _t(wq), _t(sc))
    assert plain.dtype == torch.float32 and plain.shape == (m, n)
    torch.testing.assert_close(dispatched, plain, atol=0, rtol=0)
    for want in (pallas, jref):
        _rel_close(plain.numpy(), want, QMM_REL[torch.float32])
    _rel_close(ref.quant_matmul_ref(_t(x), _t(wq), _t(sc)).numpy(), jref,
               QMM_REL[torch.float32])


# (M, K, N) of the split-K mirror: decode rows and prefill rows, ragged K
# (not a multiple of the K step) and N
QMM_SPLIT_SHAPES = [(8, 640, 48), (16, 1000, 64), (13, 520, 32),
                    (40, 400, 48)]
# the planner's input for M <= 16 and M > 16: (BM, BN, BK, bytes-bound) as
# the library reports them (quant_matmul_tile; the card test
# test_quant_matmul_tiles_are_the_libraries checks these against it)
QMM_TILES = {"decode": (16, 128, 64, 1), "prefill": (128, 128, 32, 0)}


def _qmm_tile(m):
    return QMM_TILES["decode" if m <= 16 else "prefill"]


@pytest.mark.parametrize("m,k,n", QMM_SPLIT_SHAPES)
@pytest.mark.parametrize("splits", ["one", "planned", "most"])
def test_quant_matmul_split_plain_matches_pallas_interpret_and_ref(
        jx, m, k, n, splits):
    """bf16-valued x: the tensor-core kernel's split-K arithmetic (K cut by
    the plan on whole K steps, float32 partials, the scales once) against
    the Pallas kernel in interpret mode and the reference's oracle, in
    float32 (summation order only) and with bf16 x and output (one bf16
    rounding)."""
    jnp = jx["jnp"]
    x, w = _qmm_inputs(63, m, k, n)
    x = _t(x).to(torch.bfloat16).float().numpy()     # bf16-representable
    wq, sc = (np.asarray(a) for a in jx["quantize_int8"](w))
    bk = _qmm_tile(m)[2]
    n_splits = {"one": 1, "planned": plan_k_splits(m, k, n, 132,
                                                   _qmm_tile(m)),
                "most": -(-k // bk)}[splits]
    assert splits == "one" or n_splits > 1
    got = quant_matmul_split_plain(_t(x), _t(wq), _t(sc), n_splits, bk)
    for want in (jx["qmm_pallas"](x, wq, sc, block_m=8, block_n=128,
                                  block_k=32, interpret=True),
                 jx["ref"].quant_matmul_ref(x, wq, sc)):
        _rel_close(got.numpy(), want, 1e-5)
    got16 = quant_matmul_split_plain(_t(x).to(torch.bfloat16), _t(wq),
                                     _t(sc), n_splits, bk)
    assert got16.dtype == torch.bfloat16
    want16 = jx["qmm_pallas"](jnp.asarray(x, jnp.bfloat16), wq, sc,
                              block_m=8, block_n=128, block_k=32,
                              interpret=True)
    _rel_close(got16.float().numpy(), np.asarray(want16, np.float32),
               QMM_REL[torch.bfloat16])


@pytest.mark.parametrize("m,k,n", [(8, 8192, 28672), (8, 28672, 8192),
                                   (512, 8192, 28672), (512, 28672, 8192),
                                   (77, 1000, 1040), (12, 1024, 4096),
                                   (16, 64, 32), (1, 8, 16)])
def test_k_split_plan_covers_every_k_row_once(m, k, n):
    """The plan at the serving and test shapes on a 132-SM H100: whole K
    steps, each K row in exactly one split, no split shorter than the
    minimum (unless K is), and decode rows filling the card."""
    n_splits = plan_k_splits(m, k, n, 132, _qmm_tile(m))
    bm, bn, bk, bytes_bound = _qmm_tile(m)
    owner = np.zeros(k, int)
    for lo, hi in k_split_bounds(k, n_splits, bk):
        assert lo % bk == 0 and (hi % bk == 0 or hi == k)
        owner[lo:hi] += 1
        assert n_splits == 1 or -(-(hi - lo) // bk) >= qmm.MIN_SPLIT_STEPS
    assert (owner == 1).all()
    tiles = -(-m // bm) * -(-n // bn)
    if (m, k, n) in ((8, 8192, 28672), (8, 28672, 8192)):
        assert tiles * n_splits >= qmm.BLOCKS_PER_SM * 132
    if not bytes_bound and tiles >= 132:
        assert n_splits == 1


def test_quant_matmul_plain_keeps_bf16(jx):
    """bf16 activations: the output is bf16, the product float32 inside."""
    x, w = _qmm_inputs(62, 5, 100, 40)
    wq, sc = quantize_int8(_t(w))
    xb = _t(x).to(torch.bfloat16)
    got = ops.quant_matmul(xb, wq, sc)
    want = (xb.float() @ wq.float() * sc).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, want, atol=0, rtol=0)


# --------------------------------------------------------------------------- #
# plain versions against the Pallas kernels (interpret mode)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("window,q_offset", [(0, 0), (24, 0), (0, 16)])
def test_flash_plain_matches_pallas_interpret(jx, window, q_offset):
    q, k, v = _flash_inputs(40, 1, 32, 48, 14, 2, 64)
    want = jx["flash_pallas"](q, k, v, causal=True, window=window,
                              q_offset=q_offset, block_q=16, block_k=16,
                              interpret=True)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_decode_plain_matches_pallas_interpret(jx):
    q, kc, vc = _np(41, 2, 14, 64), _np(42, 2, 40, 2, 64), _np(43, 2, 40, 2, 64)
    valid = np.arange(40)[None] < np.array([[13], [40]])
    want = jx["decode_pallas"](q, kc, vc, valid, block_k=16, interpret=True)
    got = decode_attention_plain(_t(q), _t(kc), _t(vc), _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# --------------------------------------------------------------------------- #
# dispatch: CPU tensors take the plain version, wrappers refuse CPU tensors
# --------------------------------------------------------------------------- #
def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    q, k, v = (_t(a) for a in _flash_inputs(50, 1, 8, 8, 4, 2, 32))
    before = (flash_attention_cuda.launches, decode_attention_cuda.launches)
    out = ops.flash_attention(q, k, v)
    torch.testing.assert_close(out, flash_attention_plain(q, k, v),
                               atol=0, rtol=0)
    valid = torch.ones((1, 8), dtype=torch.bool)
    ops.decode_attention(q[:, 0], k, v, valid)
    assert (flash_attention_cuda.launches,
            decode_attention_cuda.launches) == before
    n = quant_matmul_cuda.launches
    ops.quant_matmul(q[0, :, 0], *quantize_int8(k[0, :, 0].T))
    assert quant_matmul_cuda.launches == n


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v = (_t(a) for a in _flash_inputs(51, 1, 8, 8, 4, 2, 32))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        decode_attention_cuda(q[:, 0], k, v, torch.ones((1, 8), dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        quant_matmul_cuda(q[0, :, 0], *quantize_int8(k[0, :, 0].T))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler means an error, never a quiet fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "CUDA_HOMES", (str(tmp_path),))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


def test_lib_path_hashes_the_included_headers(monkeypatch, tmp_path):
    """An edited header gives the library another name: no stale load."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n#include <stdint.h>\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.sources("k")] == ["k.cu", "h.cuh"]
    before = build._lib_path("k")
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build._lib_path("k") != before


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ptxas_report_names_plain_and_templated_kernels(tmp_path):
    """The register report lists every ``__global__`` function, templated
    or not, from the build's ``-Xptxas -v`` log, named by the toolkit's
    ``cu++filt`` (a stand-in here that knows the three symbols)."""
    cs = _chip_smoke()
    syms = {
        "_ZN12_GLOBAL__N_123decode_attention_kernelI13__nv_bfloat16Li128ELi8"
        "EEEvPKT_S4_":
            "<unnamed>::decode_attention_kernel<__nv_bfloat16, (int)128, "
            "(int)8>",
        "_ZN14flash_decoding21combine_splits_kernelIfEEvPKfPT_iiii":
            "flash_decoding::combine_splits_kernel<float>",
        "_Z12plain_kernelPfi": "plain_kernel"}
    log = "".join(
        f"ptxas info    : Compiling entry function '{sym}' for 'sm_90a'\n"
        f"    0 bytes stack frame, {st} bytes spill stores, {ld} bytes "
        f"spill loads\nptxas info    : Used {regs} registers\n"
        for sym, (regs, st, ld) in zip(syms, [(72, 0, 0), (20, 8, 4),
                                              (8, 0, 0)]))
    (tmp_path / "k.log").write_text(log)
    filt = tmp_path / "cu++filt"
    filt.write_text(f"#!{sys.executable}\nimport sys\n"
                    f"assert sys.argv[1] == '-p'\nnames = {syms!r}\n"
                    "print('\\n'.join(names[a] for a in sys.argv[2:]))\n")
    filt.chmod(0o755)
    fake = type("B", (), {"KERNELS": ("k",), "BUILD": tmp_path,
                          "nvcc_path": staticmethod(
                              lambda: str(tmp_path / "nvcc"))})
    assert cs.ptxas_report(fake) == [
        ("<unnamed>::decode_attention_kernel<__nv_bfloat16, (int)128, "
         "(int)8>", 72, 0, 0),
        ("flash_decoding::combine_splits_kernel<float>", 20, 8, 4),
        ("plain_kernel", 8, 0, 0)]


@pytest.mark.parametrize("name,layers", [
    ("qwen2-0.5b", 2), ("mamba2-780m", 2), ("jamba-1.5-large-398b", 5),
    ("seamless-m4t-medium", 2)])
def test_rmsnorm_launch_count_matches_a_forward(name, layers, monkeypatch):
    """``chip_smoke.rmsnorm_per_forward``, which the card's launch checks
    hold the rmsnorm kernel's count to, against the norms one forward of
    the family runs (counted here through ``ops.rmsnorm`` on the CPU): a
    decode step, and a prefill wave that runs the audio encoder."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, init_cache
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config(name).reduced(), num_layers=layers)
    calls = []
    real = ops.rmsnorm
    monkeypatch.setattr(ops, "rmsnorm",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    ctx = cfg.audio.num_frames if cfg.audio else 0
    cache = init_cache(cfg, 1, 8, ctx_len=ctx, device="cpu")
    kw = ({"audio_frames": torch.zeros((1, ctx, cfg.audio.embed_dim))}
          if cfg.audio else {})
    with torch.no_grad():
        model.apply(params, torch.ones((1, 4), dtype=torch.long),
                    mode="prefill", cache=cache, **kw)
        prefill, calls[:] = len(calls), []
        model.apply(params, torch.ones((1, 1), dtype=torch.long),
                    mode="decode", positions=torch.full((1, 1), 4),
                    cache=cache)
    assert len(calls) == cs.rmsnorm_per_forward(cfg)
    assert prefill == cs.rmsnorm_per_forward(cfg, encoder=bool(cfg.audio))


def test_jamba_wrong_paths_break_what_they_name(monkeypatch):
    """The card's deliberately wrong plain paths for the jamba check:
    ``skipped_norm`` at ``input_norm_index`` skips the attention layer's
    input norm and no other call, ``scaled_queries`` scales the queries of
    each attention entry point, and both put ``ops`` back."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model, init_cache
    cs = _chip_smoke()
    cfg = dataclasses.replace(get_config("jamba-1.5-large-398b").reduced(),
                              num_layers=5)
    params = Model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    attn = cfg.layer_kinds().index("attn")
    seen, real = [], ops.rmsnorm
    monkeypatch.setattr(ops, "rmsnorm",
                        lambda x, w, eps=1e-5: seen.append(w) or real(x, w,
                                                                      eps))
    per = cs.rmsnorm_per_forward(cfg)
    cache = init_cache(cfg, 1, 8, device="cpu")
    with torch.no_grad(), cs.skipped_norm(
            ops, cs.input_norm_index(cfg, attn), per):
        for mode, n in (("prefill", 4), ("decode", 1)):
            Model(cfg).apply(params, torch.ones((1, n), dtype=torch.long),
                             mode=mode, positions=torch.full((1, n), 4)
                             if mode == "decode" else None, cache=cache)
    skipped = params["prefix_layers"][attn]["attn"]["ln"]
    assert len(seen) == 2 * (per - 1)
    assert not any(w is skipped for w in seen)
    assert ops.rmsnorm.__name__ == "<lambda>"          # the recorder is back
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 5, 2, 8), generator=g) for _ in range(3))
    before = ops.flash_attention
    with cs.scaled_queries(ops, 1.5):
        got = ops.flash_attention(q, k, v, causal=True)
    assert ops.flash_attention is before
    torch.testing.assert_close(got, before(q * 1.5, k, v, causal=True))


def test_near_tie_compare_excuses_ties_only():
    """The jamba check's bf16 comparison: within the limit an argmax flip
    at a near tie passes and is counted; an error past the limit fails."""
    cs = _chip_smoke()
    records = {}
    cmp = cs.near_tie_compare(0.02, records)
    want = torch.tensor([[[5.0, 4.95, 0.0], [5.0, 3.0, 0.0]]])
    got = want.clone()
    got[0, 0, 1] += 0.08                               # a flip at a tie
    cmp(torch, "tie", got, want)
    assert records["tie"]["near_ties"] == 1
    assert records["tie"]["argmax_agree"] == 1
    got[0, 1, 1] += 2.5                                # a flip past the limit
    with pytest.raises(AssertionError):
        cmp(torch, "wrong", got, want)


def test_segsum_in_float64_routes_and_restores():
    """The decay matrix read in float64 for the card's mamba2 check: the
    float32 cancellation of the cumulative sums is gone (equal to the
    float64 form cast once), and ``ops._segsum`` is put back."""
    cs = _chip_smoke()
    g = torch.Generator().manual_seed(0)
    x = -torch.rand((3, 256), generator=g) * 20
    inner = ops._segsum
    with cs.segsum_in_float64(ops):
        got = ops._segsum(x)
    assert ops._segsum is inner and got.dtype == torch.float32
    assert torch.equal(got, inner(x.double()).float())


# --------------------------------------------------------------------------- #
# on the card: each CUDA kernel against its plain version
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= CARD_ATOL[dtype], f"max |kernel - plain| = {err}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hkv,d", [
    (8, 2048, 14, 2, 64),                     # the main path's shape
    (3, 1000, 14, 2, 64),                     # S not a tile multiple
    (2, 300, 8, 2, 32), (2, 257, 16, 1, 128), (2, 64, 4, 4, 64)])
def test_decode_kernel_matches_plain(cuda, dtype, b, s, h, hkv, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, h, d), generator=g, device=cuda).to(dtype)
    kc = torch.randn((b, s, hkv, d), generator=g, device=cuda).to(dtype)
    vc = torch.randn((b, s, hkv, d), generator=g, device=cuda).to(dtype)
    lengths = torch.randint(1, s + 1, (b,), generator=g, device=cuda)
    lengths[0] = s
    valid = torch.arange(s, device=cuda)[None] < lengths[:, None]
    got = decode_attention_cuda(q, kc, vc, valid)
    torch.cuda.synchronize()
    _close(got, decode_attention_plain(q, kc, vc, valid), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["masked", "ring", "s1", "s777", "g1",
                                  "g16"])
def test_decode_kernel_split_edge_cases(cuda, dtype, form):
    """All-masked rows and splits, a wrapped ring with holes, S = 1, S not
    a multiple of the split, G = 1 and 16."""
    b, s, h, hkv, d = {"masked": (4, 2048, 14, 2, 64),
                       "ring": (4, 1500, 14, 2, 64),
                       "s1": (4, 1, 14, 2, 64),
                       "s777": (5, 777, 16, 2, 32),
                       "g1": (4, 600, 8, 8, 64),
                       "g16": (2, 900, 32, 2, 128)}[form]
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn((b, h, d), generator=g, device=cuda).to(dtype)
    kc = torch.randn((b, s, hkv, d), generator=g, device=cuda).to(dtype)
    vc = torch.randn((b, s, hkv, d), generator=g, device=cuda).to(dtype)
    valid = _t(_decode_mask("ring" if form == "ring" else
                            "masked" if form == "masked" else "ragged",
                            b, s)).to(cuda)
    got = decode_attention_cuda(q, kc, vc, valid)
    torch.cuda.synchronize()
    _close(got, decode_attention_plain(q, kc, vc, valid), dtype)
    assert not got[~valid.any(1)].any()


@pytest.mark.gpu
def test_decode_kernel_reads_a_layer_of_a_stacked_cache(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    stacked = torch.randn((3, 4, 512, 2, 64), generator=g, device=cuda)
    q = torch.randn((4, 14, 64), generator=g, device=cuda)
    valid = torch.arange(512, device=cuda)[None] < torch.tensor(
        [[1], [100], [511], [512]], device=cuda)
    k, v = stacked[1], stacked[2]
    got = decode_attention_cuda(q, k, v, valid)
    want = decode_attention_plain(q, k.contiguous(), v.contiguous(), valid)
    _close(got, want, torch.float32)
    valid[0] = False                          # all-masked row yields 0
    assert not decode_attention_cuda(q, k, v, valid)[0].any()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["engine", "causal_offset", "window",
                                  "ragged", "d32", "d128", "noncausal",
                                  "g7_ragged_tiles", "window_qpos",
                                  "last_tile"])
def test_flash_kernel_matches_plain(cuda, dtype, form):
    b, sq, skv, h, hkv, d = {
        "engine": (4, 512, 2048, 14, 2, 64),
        "g7_ragged_tiles": (2, 100, 600, 14, 2, 64),   # Sq % 18 != 0
        "window_qpos": (3, 256, 1024, 14, 2, 64),
        "last_tile": (3, 40, 300, 14, 2, 64),
        "causal_offset": (2, 256, 1024, 14, 2, 64),
        "window": (2, 512, 512, 14, 2, 64),
        "ragged": (3, 100, 1000, 14, 2, 64),
        "d32": (2, 70, 130, 8, 2, 32),
        "d128": (2, 65, 200, 16, 4, 128),
        "noncausal": (2, 64, 96, 14, 2, 64),
    }[form]
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(dtype)
    kw = dict(causal=form != "noncausal", window=256 if form == "window" else 0,
              q_offset=skv - sq if form in ("causal_offset", "ragged") else 0)
    if form in ("engine", "window_qpos"):
        qpos, kv_valid = _engine_rows(3, b, sq, skv)
        kw = dict(causal=True, q_positions=_t(qpos).to(cuda),
                  kv_valid=_t(kv_valid).to(cuda),
                  window=200 if form == "window_qpos" else 0)
    elif form == "g7_ragged_tiles":
        kw = dict(causal=True, q_offset=skv - sq)
    elif form == "last_tile":                 # only keys of the last tile
        idx = torch.arange(skv, device=cuda)
        kw = dict(causal=False, kv_valid=torch.stack(
            [idx >= skv - 10, idx == skv - 1, idx >= 0]))
    got = flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    _close(got, flash_attention_plain(q, k, v, **kw), dtype)


def _paged_case(device, dtype, *, b=8, ps=16, p=128, reserved=1, h=14,
                hkv=2, d=64, int8=False, seed=0, stacked=0):
    """An arena of ``reserved + b * p`` pages, rows 0 and 1 sharing their
    first pages, row 2 wrapped, ragged positions, and every table entry past
    a row's allocation pointing at reserved page 0 (filled with noise).  With
    ``stacked`` layers the pages are one layer of an ``[N, L, ...]`` arena, a
    view whose page stride is not its page size."""
    g = torch.Generator(device=device).manual_seed(seed)
    n = reserved + b * p
    lead = (stacked,) if stacked else ()

    def arena():
        """(pages, scales or None), both one layer of the stack if any."""
        x = torch.randn((n,) + lead + (ps, hkv, d), generator=g, device=device)
        x, sc = quantize_kv_int8(x) if int8 else (x.to(dtype), None)
        if stacked:
            return (x[:, stacked // 2],
                    None if sc is None else sc[:, stacked // 2])
        return x, sc

    q = torch.randn((b, h, d), generator=g, device=device).to(dtype)
    (k, ks), (v, vs) = arena(), arena()
    kw = dict(k_scale=ks, v_scale=vs) if int8 else {}
    pos = torch.randint(0, p * ps, (b,), generator=g, device=device)
    pos[2] = p * ps + 37                      # wrapped ring: every cell live
    pos[:2] = pos[:2].clamp_min(min(5, p - 1) * ps)   # rows 0, 1: many pages
    table = torch.zeros((b, p), dtype=torch.int32, device=device)
    perm = torch.randperm(b * p, generator=g, device=device) + reserved
    for row in range(b):
        live = p if row == 2 else int(pos[row]) // ps + 1
        table[row, :live] = perm[row * p:row * p + live].int()
    table[1, :4] = table[0, :4]               # shared prefix pages
    return (q, k, v, table, pos.int()), kw


@pytest.mark.gpu
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8-q-float32",
                                "int8-q-bfloat16"])
@pytest.mark.parametrize("ps,p,h,hkv,d", [
    (16, 128, 14, 2, 64),                     # the main path's shape
    (16, 8, 14, 2, 64), (4, 20, 8, 2, 32), (32, 6, 16, 1, 128),
    (8, 10, 4, 4, 64),
    # G 1 and 16 at each head dim, pages of 4 and 32
    (4, 40, 8, 8, 32), (4, 30, 32, 2, 32), (16, 12, 8, 8, 64),
    (32, 10, 16, 1, 64), (16, 20, 16, 16, 128)])
def test_paged_kernel_matches_plain(cuda, kv, ps, p, h, hkv, d):
    int8 = kv.startswith("int8")
    dtype = getattr(torch, kv.split("-")[-1])
    args, kw = _paged_case(cuda, dtype, ps=ps, p=p, h=h, hkv=hkv, d=d,
                           int8=int8)
    got = paged_attention_cuda(*args, **kw)
    torch.cuda.synchronize()
    _close(got, paged_attention_plain(*args, **kw), dtype)


PAGED_KV = ["float32", "bfloat16", "int8-q-float32", "int8-q-bfloat16"]


def _paged_kv(kv):
    """(q dtype, int8 pages) of a ``PAGED_KV`` label."""
    return getattr(torch, kv.split("-")[-1]), kv.startswith("int8")


@pytest.mark.gpu
@pytest.mark.parametrize("kv", PAGED_KV)
@pytest.mark.parametrize("form", ["one live cell", "one split live",
                                  "stacked"])
def test_paged_kernel_split_edge_cases(cuda, kv, form):
    """A row with one live cell; a row whose every split but one is empty
    (20 live cells under the plan's splits); a layer of a stacked arena."""
    dtype, int8 = _paged_kv(kv)
    args, kw = _paged_case(cuda, dtype, b=4, int8=int8,
                           stacked=3 if form == "stacked" else 0)
    pos = args[4]
    if form == "one live cell":
        pos[3] = 0
    elif form == "one split live":
        pos[3] = 19
    got = paged_attention_cuda(*args, **kw)
    torch.cuda.synchronize()
    _close(got, paged_attention_plain(*args, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kv", PAGED_KV)
def test_paged_launch_split_counts_agree(cuda, kv):
    """One split (the kernel writes the output), three, and the plan's
    count (partials and the combine) give the same result."""
    dtype, int8 = _paged_kv(kv)
    args, kw = _paged_case(cuda, dtype, int8=int8)
    q, k = args[0], args[1]
    planned = pag.plan_splits(args[3].shape[1] * k.shape[1],
                              q.shape[0] * k.shape[2], pag.sm_count(q.device))
    assert planned > 3
    want = paged_attention_plain(*args, **kw)
    for n in (1, 3, planned):
        got = pag._launch(*args, kw.get("k_scale"), kw.get("v_scale"), n)
        torch.cuda.synchronize()
        _close(got, want, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_paged_kernel_reads_a_layer_of_a_stacked_arena(cuda, int8):
    args, kw = _paged_case(cuda, torch.float32, b=4, p=16, int8=int8,
                           stacked=3)
    assert not args[1].is_contiguous()
    assert not int8 or not kw["k_scale"].is_contiguous()
    got = paged_attention_cuda(*args, **kw)
    want = paged_attention_plain(*args, **kw)
    _close(got, want, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", QMM_SHAPES + [
    (8, 8192, 28672),                         # decode rows, the MLP's up
    (8, 28672, 8192),                         # the down one (split-K)
    (12, 1024, 4096),                         # M 9-16: the decode tile
    (77, 1000, 1040),                         # ragged M, K and N tiles
    (13, 256, 1000),                          # N % 16 != 0: CUDA cores
    (512, 1024, 4096),                        # prefill rows
])
def test_quant_matmul_kernel_matches_plain(cuda, dtype, m, k, n):
    g = torch.Generator(device="cuda").manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    wq, sc = quantize_int8(torch.randn((k, n), generator=g, device="cuda"))
    before = quant_matmul_cuda.launches
    got = quant_matmul_cuda(x, wq, sc)
    torch.cuda.synchronize()
    assert quant_matmul_cuda.launches == before + 1 and got.dtype == dtype
    _rel_close(got.float().cpu(), quant_matmul_plain(x, wq, sc).float().cpu(),
               QMM_REL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 100])
def test_quant_matmul_split_counts_agree(cuda, m):
    """bf16 on the tensor cores with one split, three and the plan's."""
    g = torch.Generator(device="cuda").manual_seed(m)
    x = torch.randn((m, 4096), generator=g, device="cuda").to(torch.bfloat16)
    wq, sc = quantize_int8(torch.randn((4096, 1024), generator=g,
                                       device="cuda"))
    want = quant_matmul_plain(x, wq, sc).float().cpu()
    for n in (1, 3, qmm.planned_splits(x, wq)):
        got = qmm._launch(x, wq, sc, n)
        torch.cuda.synchronize()
        _rel_close(got.float().cpu(), want, QMM_REL[torch.bfloat16])


@pytest.mark.gpu
def test_quant_matmul_tiles_are_the_libraries(cuda):
    """The library's tile choice: the tiles the CPU tests plan on for
    bf16 decode and prefill rows, and the CUDA cores for float32, a ragged
    N and an unaligned x."""
    g = torch.Generator(device="cuda").manual_seed(3)
    wq, _ = quantize_int8(torch.randn((256, 1024), generator=g,
                                      device="cuda"))
    for m in (1, 16, 17, 512):
        x = torch.randn((m, 256), generator=g, device="cuda")
        assert qmm.tensor_core_tile(x.to(torch.bfloat16), wq) == _qmm_tile(m)
        assert qmm.tensor_core_tile(x, wq) is None
    x = torch.randn((8, 257), generator=g, device="cuda").to(torch.bfloat16)
    assert qmm.tensor_core_tile(x[:, 1:].contiguous(), wq[:, :1000]
                                .contiguous()) is None
    assert qmm.tensor_core_tile(x.view(-1)[1:2049].view(8, 256), wq) is None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_match_plain_at_the_cross_attention_shapes(cuda,
                                                                     dtype):
    """Cross attention of llama-3.2-vision-90b: non-causal flash and decode
    at D = 128, G = 8 over a 2304-slot context with ragged liveness."""
    g = torch.Generator(device="cuda").manual_seed(7)
    ctx = torch.tensor([2304, 576, 1152, 1], device="cuda")
    valid = torch.arange(2304, device="cuda")[None] < ctx[:, None]
    k, v = (torch.randn((4, 2304, 8, 128), generator=g, device="cuda")
            .to(dtype) for _ in range(2))
    q = torch.randn((4, 64, 64, 128), generator=g, device="cuda").to(dtype)
    _close(flash_attention_cuda(q, k, v, causal=False, kv_valid=valid),
           flash_attention_plain(q, k, v, causal=False, kv_valid=valid),
           dtype)
    q0 = q[:, 0].contiguous()                 # the wrapper takes q [B,H,D]
    _close(decode_attention_cuda(q0, k, v, valid),            # contiguous
           decode_attention_plain(q0, k, v, valid), dtype)


# (H, Hkv) of the serving shapes of the MoE and dense-family models, D 128
FAMILY_HEADS = {"deepseek-moe-16b": (16, 16), "glm4-9b": (32, 2),
                "yi-34b": (56, 8)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", sorted(FAMILY_HEADS))
@pytest.mark.parametrize("form", ["flash", "flash window ring", "decode",
                                  "paged", "paged int8"])
def test_attention_kernels_match_plain_at_the_family_shapes(cuda, dtype, arch,
                                                            form):
    """G 1 (deepseek-moe-16b), 16 (glm4-9b) and 7 (yi-34b) at D 128: flash
    in the engine form over a 2048-slot ring, and windowed (256) over a
    256-slot ring with rows past the window's reach (no live key); decode
    at S 2048; paged at 16-token pages, 128 a row, fp and int8 pages."""
    h, hkv = FAMILY_HEADS[arch]
    d = 128
    g = torch.Generator(device=cuda).manual_seed(8)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    if form.startswith("flash"):
        b, sq, skv = (4, 512, 2048) if form == "flash" else (3, 256, 256)
        q, k, v = randn(b, sq, h, d), randn(b, skv, hkv, d), randn(b, skv,
                                                                    hkv, d)
        if form == "flash":
            qpos, kv_valid = (_t(a).to(cuda) for a in _engine_rows(
                5, b, sq, skv))
            kw = dict(causal=True, q_positions=qpos, kv_valid=kv_valid)
        else:
            qpos = (torch.tensor([[0], [256], [512]], device=cuda)
                    + torch.arange(sq, device=cuda)).int()
            kw = dict(causal=True, window=256, q_positions=qpos)
            assert bool(dead_rows(qpos, skv, causal=True, window=256)[2].all())
        got = flash_attention_cuda(q, k, v, **kw)
        want = flash_attention_plain(q, k, v, **kw)
    elif form == "decode":
        b, s = 8, 2048
        q, k, v = randn(b, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        lengths = torch.randint(1, s + 1, (b,), generator=g, device=cuda)
        valid = torch.arange(s, device=cuda)[None] < lengths[:, None]
        got = decode_attention_cuda(q, k, v, valid)
        want = decode_attention_plain(q, k, v, valid)
    else:
        args, kw = _paged_case(cuda, dtype, h=h, hkv=hkv, d=d,
                               int8=form == "paged int8")
        got = paged_attention_cuda(*args, **kw)
        want = paged_attention_plain(*args, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    _close(got, want, dtype)


def _gated_vision_case():
    """A reduced ``llama-3.2-vision-90b`` (float32, 5 layers) whose one cross
    layer is a prefix layer, its gates at 0.5, and a batch with images."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    base = get_config("llama-3.2-vision-90b")
    red = base.reduced()
    cfg = dataclasses.replace(red, num_layers=5, dtype="float32",
                              vision=dataclasses.replace(
                                  red.vision, cross_attn_every=base.vision
                                  .cross_attn_every))
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    for sub in params["prefix_layers"]:
        if "cross" in sub:
            sub["xgate_ffn"].fill_(0.5)
            sub["cross"]["xgate_attn"].fill_(0.5)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    batch = {"tokens": toks, "labels": toks.roll(-1, 1),
             "mask": torch.ones((2, 16)),
             "image_embeds": torch.rand((2, cfg.vision.num_image_tokens,
                                         cfg.vision.embed_dim),
                                        generator=g) * 2 - 1}
    return cfg, params, batch


def test_gate_terms_bound_the_gate_gradient():
    """``chip_smoke.traced_gate_terms``, the scale 6d holds the bf16
    cross-attention gates' gradients to: on the CPU it traces both gates,
    each sum of absolute terms bounds its gate's gradient from autograd,
    and ``layers._gate`` comes back untouched."""
    from repro_torch.models import layers
    from repro_torch.training import train_step as tts
    from repro_torch.training.optimizer import tree_flatten_with_path
    cs = _chip_smoke()
    cfg, params, batch = _gated_vision_case()
    flat = tree_flatten_with_path(params)
    names = {id(t): "/".join(map(str, p)) for p, t in flat if t.dim() == 0}
    assert sorted(names.values()) == ["prefix_layers/4/cross/xgate_attn",
                                      "prefix_layers/4/xgate_ffn"]
    real, sums = layers._gate, {}
    with cs.traced_gate_terms(torch, layers, names, sums):
        _, _, grads = tts.loss_and_grads(params, batch, cfg=cfg, remat=True)
    assert layers._gate is real and set(sums) == set(names.values())
    for (path, _), grad in zip(flat, grads):
        key = "/".join(map(str, path))
        if key in sums:
            assert 0 < abs(float(grad)) <= sums[key] * (1 + 1e-6)


def test_grads_vs_plain_holds_the_gates_to_their_terms(monkeypatch):
    """``chip_smoke.grads_vs_plain`` with ``gate_tol`` on the CPU (both
    runs plain, equal to float32 noise): each gate is read against its sum of terms and
    the matrices as before; a first run whose gate gradients are doubled
    fails once ``gate_tol`` lies under the gates' control (what a 2x error
    reads)."""
    import types
    from repro_torch.models import layers
    from repro_torch.training import train_step as tts
    from repro_torch.training.optimizer import tree_flatten_with_path
    cs = _chip_smoke()
    cfg, params, batch = _gated_vision_case()
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    ns = types.SimpleNamespace(
        ops=ops, layers=layers, tts=tts,
        wrappers={"flash_attention": types.SimpleNamespace(launches=0)},
        tree_flatten_with_path=tree_flatten_with_path)
    res = cs.grads_vs_plain(torch, ns, cfg, params, batch, "cpu",
                            gate_tol=1e-6, remat=True)
    gates = res["gates"]
    assert sorted(gates) == ["prefix_layers/4/cross/xgate_attn",
                             "prefix_layers/4/xgate_ffn"]
    assert all(v["rel_to_terms"] < 1e-6 and 0 < v["control"] <= 1
               for v in gates.values())
    assert res["worst_leaf"] not in gates
    real = tts.loss_and_grads
    calls = []

    def doubled_first(p, b, **kw):
        loss, parts, grads = real(p, b, **kw)
        calls.append(1)
        if len(calls) == 1:
            grads = [g * 2 if g.dim() == 0 else g for g in grads]
        return loss, parts, grads

    ns.tts = types.SimpleNamespace(loss_and_grads=doubled_first)
    control = min(v["control"] for v in gates.values())
    with pytest.raises(AssertionError, match="gates"):
        cs.grads_vs_plain(torch, ns, cfg, params, batch, "cpu",
                          gate_tol=control / 2, remat=True)
