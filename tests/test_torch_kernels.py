"""The port's attention kernels: plain PyTorch versions held to the JAX
package's functions on the CPU, and (on a CUDA card, marker ``gpu``) each
hand-written CUDA kernel held to its plain version.

Inputs come from numpy seeds and pass to both frameworks as numpy arrays.
The JAX package is imported inside the CPU tests only, so the ``gpu`` tests
also run on a machine that has no JAX::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels.py

Tolerances: float32 plain vs JAX atol 2e-5 / rtol 1e-3 (as
``tests/test_kernels.py``); kernel vs plain on the card bf16 atol 2e-2 (one
bf16 rounding of an O(1) output), float32 atol 1e-4 (summation order only).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                 paged_attention_plain)
from repro_torch.kernels.quant_matmul import quantize_kv_int8

F32 = dict(atol=2e-5, rtol=1e-3)
CARD_ATOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernel modules (CPU tests only)."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import decode_attention_pallas
    from repro.kernels.flash_attention import flash_attention_pallas
    return dict(jnp=jnp, ops=jops, ref=jref,
                decode_pallas=decode_attention_pallas,
                flash_pallas=flash_attention_pallas)


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


def test_cuda_wrappers_refuse_cpu_tensors():
    q, k, v = (_t(a) for a in _flash_inputs(51, 1, 8, 8, 4, 2, 32))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        decode_attention_cuda(q[:, 0], k, v, torch.ones((1, 8), dtype=torch.bool))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No compiler means an error, never a quiet fallback."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "CUDA_HOMES", (str(tmp_path),))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()


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
                                  "ragged", "d32", "d128", "noncausal"])
def test_flash_kernel_matches_plain(cuda, dtype, form):
    b, sq, skv, h, hkv, d = {
        "engine": (4, 512, 2048, 14, 2, 64),
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
    if form == "engine":
        qpos, kv_valid = _engine_rows(3, b, sq, skv)
        kw = dict(causal=True, q_positions=_t(qpos).to(cuda),
                  kv_valid=_t(kv_valid).to(cuda))
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
    (8, 10, 4, 4, 64)])
def test_paged_kernel_matches_plain(cuda, kv, ps, p, h, hkv, d):
    int8 = kv.startswith("int8")
    dtype = getattr(torch, kv.split("-")[-1])
    args, kw = _paged_case(cuda, dtype, ps=ps, p=p, h=h, hkv=hkv, d=d,
                           int8=int8)
    got = paged_attention_cuda(*args, **kw)
    torch.cuda.synchronize()
    _close(got, paged_attention_plain(*args, **kw), dtype)


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
