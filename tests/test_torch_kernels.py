"""The port's kernels (attention and the int8-weight matmul): plain PyTorch
versions held to the JAX package's functions on the CPU, and (on a CUDA
card, marker ``gpu``) each hand-written CUDA kernel held to its plain
version.

Inputs come from numpy seeds and pass to both frameworks as numpy arrays.
The JAX package is imported inside the CPU tests only, so the ``gpu`` tests
also run on a machine that has no JAX::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels.py

Tolerances: float32 plain vs JAX atol 2e-5 / rtol 1e-3 (as
``tests/test_kernels.py``); kernel vs plain on the card bf16 atol 2e-2 (one
bf16 rounding of an O(1) output), float32 atol 1e-4 (summation order only).
``quant_matmul``, whose outputs grow with K, is held relative to the
output's largest magnitude: 1e-4 in float32 (summation order, and the
reference's oracle scales the weights before the sum, the kernel after) and
1e-2 in bf16 (one bf16 rounding, 2**-7, of the largest output).
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
from repro_torch.kernels.quant_matmul import (quant_matmul_cuda,
                                              quant_matmul_plain,
                                              quantize_int8, quantize_kv_int8)

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", QMM_SHAPES + [
    (8, 8192, 28672),                         # decode rows, the MLP's up
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
    _close(decode_attention_cuda(q[:, 0], k, v, valid),
           decode_attention_plain(q[:, 0], k, v, valid), dtype)
