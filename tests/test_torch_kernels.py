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
