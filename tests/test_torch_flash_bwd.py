"""The port's gradient path through attention and rmsnorm: the flash
backward's plain version (``flash_attention_bwd_plain``) against autograd
through ``flash_attention_plain`` and against ``jax.vjp`` of the JAX
package's ``_flash_jnp`` (the reference's gradient on the CPU: its Pallas
kernel has no transpose rule), the autograd nodes ``FlashAttentionFn`` and
``RmsnormFn`` run with the plain implementations against plain autograd,
``ops.ssd`` serving outputs unchanged by its differentiable path, the
backward wrapper's refusals, and (on a CUDA card, marker ``gpu``) the
backward kernel against its plain version.

The JAX package is imported inside the CPU tests only, so the ``gpu``
tests also run where there is no JAX::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_flash_bwd.py

Tolerances: float32 gradients relative to the largest gradient 2e-5
against autograd and JAX (the same float32 products summed in another
order; readings ~1e-6); the autograd nodes 1e-5; on the card float32 1e-5
and bf16 1e-2 of the largest gradient (the kernel and the plain version
each round once to bf16 at the store; readings up to 2.2e-3 on the H100);
``ops.ssd`` bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (dead_rows,
                                                 first_dead_row,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import (rmsnorm_bwd_plain, rmsnorm_cuda,
                                         rmsnorm_plain)
from torch_threads import one_torch_thread  # noqa: F401

REL = 2e-5
CARD_REL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# (b, sq, skv, h, hkv, d, causal, window): causal, window, non-causal
# cross shapes, G 1 / 7 / 16, Sq not a multiple of the 64-row tile
FORMS = {
    "causal_g7": (2, 70, 70, 14, 2, 32, True, 0),
    "window_g7": (2, 90, 90, 14, 2, 32, True, 24),
    "cross_g8": (2, 40, 100, 16, 2, 64, False, 0),
    "g1": (1, 65, 65, 4, 4, 32, True, 0),
    "g16": (1, 33, 33, 16, 1, 32, True, 0),
    "ragged_window": (1, 129, 129, 8, 1, 32, True, 64),
    "noncausal_window": (1, 50, 50, 4, 2, 32, False, 16),
}


@pytest.fixture(scope="module")
def jx():
    """jax, jax.numpy and the JAX package's kernel entry points (CPU tests
    only)."""
    import jax
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    return dict(jax=jax, jnp=jnp, ops=jops)


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _inputs(seed, b, sq, skv, h, hkv, d):
    return (_np(seed, b, sq, h, d), _np(seed + 1, b, skv, hkv, d),
            _np(seed + 2, b, skv, hkv, d), _np(seed + 3, b, sq, h, d))


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _autograd_plain(q, k, v, do, causal, window):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    return out.detach(), torch.autograd.grad(out, (qt, kt, vt),
                                             torch.from_numpy(do))


@pytest.mark.parametrize("chunk", [1024, 16])
@pytest.mark.parametrize("form", list(FORMS))
def test_bwd_plain_matches_autograd_of_plain(form, chunk):
    b, sq, skv, h, hkv, d, causal, window = FORMS[form]
    q, k, v, do = _inputs(0, b, sq, skv, h, hkv, d)
    out, want = _autograd_plain(q, k, v, do, causal, window)
    got = flash_attention_bwd_plain(*map(torch.from_numpy, (q, k, v)), out,
                                    torch.from_numpy(do), causal=causal,
                                    window=window, chunk=chunk)
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _rel(g.numpy(), w.numpy()) < REL, name


@pytest.mark.parametrize("form", list(FORMS))
def test_bwd_plain_matches_jax_vjp_of_flash_jnp(jx, form):
    b, sq, skv, h, hkv, d, causal, window = FORMS[form]
    q, k, v, do = _inputs(1, b, sq, skv, h, hkv, d)
    jnp = jx["jnp"]
    out, vjp = jx["jax"].vjp(
        lambda a, b_, c: jx["ops"]._flash_jnp(a, b_, c, causal=causal,
                                              window=window, q_offset=0,
                                              chunk=1024),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v)), torch.from_numpy(np.array(out)),
        torch.from_numpy(do), causal=causal, window=window)
    for g, w, name in zip(got, want, "qkv"):
        assert _rel(g.numpy(), w) < REL, name


@pytest.mark.parametrize("form", ["causal_g7", "window_g7", "cross_g8"])
def test_flash_fn_with_plain_implementations_matches_plain_autograd(form):
    """FlashAttentionFn (plain forward, plain backward) against autograd
    through the plain forward: the same output, gradients within REL."""
    b, sq, skv, h, hkv, d, causal, window = FORMS[form]
    q, k, v, do = _inputs(2, b, sq, skv, h, hkv, d)
    out_want, want = _autograd_plain(q, k, v, do, causal, window)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.FlashAttentionFn.apply(qt, kt, vt, causal, window,
                                     flash_attention_plain,
                                     flash_attention_bwd_plain)
    assert out.grad_fn is not None
    assert torch.equal(out.detach(), out_want)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) < REL


def test_ops_flash_attention_with_grad_on_the_cpu():
    """ops.flash_attention with grad: the training form goes through
    FlashAttentionFn; a form the backward does not take differentiates
    through the plain version (on the CPU only: on the card it raises)."""
    q, k, v, _ = _inputs(3, 1, 20, 20, 4, 2, 32)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, causal=True, window=5)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    valid = torch.ones((1, 20), dtype=torch.bool)
    out = ops.flash_attention(qt, kt, vt, causal=False, kv_valid=valid)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ != "FlashAttentionFnBackward"
    with torch.no_grad():
        assert ops.flash_attention(qt, kt, vt).grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_fn_matches_plain_autograd(dtype, wdtype):
    """RmsnormFn (plain forward, the explicit float32 backward) against
    autograd through rmsnorm_plain, on [2, 7, 96] rows."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 7, 96)).astype(np.float32)
                         * 3).to(dtype)
    w = torch.from_numpy(1 + 0.1 * rng.standard_normal(96).astype(
        np.float32)).to(wdtype)
    dy = torch.from_numpy(rng.standard_normal((2, 7, 96)).astype(
        np.float32)).to(dtype)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(rmsnorm_plain(xa, wa, 1e-6), (xa, wa), dy)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = ops.RmsnormFn.apply(xb, wb, 1e-6, rmsnorm_plain)
    assert torch.equal(out.detach(), rmsnorm_plain(x, w, 1e-6))
    got = torch.autograd.grad(out, (xb, wb), dy)
    tol = 1e-5 if dtype == wdtype == torch.float32 else 1e-2
    for g, wnt in zip(got, want):
        assert g.dtype == wnt.dtype
        assert _rel(g.float().numpy(), wnt.float().numpy()) < tol
    assert [g.dtype for g in rmsnorm_bwd_plain(x, w, dy, 1e-6)] == [dtype,
                                                                    wdtype]


def test_ops_rmsnorm_with_grad_runs_the_autograd_node():
    x = torch.randn(3, 16, requires_grad=True)
    w = torch.ones(16)
    assert type(ops.rmsnorm(x, w).grad_fn).__name__ == "RmsnormFnBackward"
    assert ops.rmsnorm(x.detach(), w).grad_fn is None


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("s,chunk", [(64, 16), (50, 16), (8, 8)])
def test_ssd_serving_unchanged_by_its_differentiable_path(s, chunk,
                                                          with_init):
    """ops.ssd without grad (the decay matrix scaled in place) and with
    inputs that require grad (out of place) give the same bits, and the
    differentiable path has a gradient."""
    rng = np.random.default_rng(5)
    b, h, p, g, n = 2, 4, 8, 2, 16
    x = torch.from_numpy(rng.standard_normal((b, s, h, p)).astype(np.float32))
    dt = torch.from_numpy(np.log1p(np.exp(0.3 * rng.standard_normal(
        (b, s, h)))).astype(np.float32))
    a = -torch.from_numpy(np.linspace(1, 4, h).astype(np.float32))
    bm = torch.from_numpy(rng.standard_normal((b, s, g, n)).astype(
        np.float32) / 4)
    cm = torch.from_numpy(rng.standard_normal((b, s, g, n)).astype(
        np.float32) / 4)
    init = (torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(
        np.float32)) if with_init else None)
    y0, st0 = ops.ssd(x, dt, a, bm, cm, init_state=init, chunk=chunk)
    xg = x.clone().requires_grad_()
    y1, st1 = ops.ssd(xg, dt, a, bm, cm, init_state=init, chunk=chunk)
    assert torch.equal(y0, y1.detach()) and torch.equal(st0, st1.detach())
    (gx,) = torch.autograd.grad(y1.sum() + st1.sum(), (xg,))
    assert torch.isfinite(gx).all() and gx.abs().max() > 0


@pytest.mark.parametrize("sq,skv,causal,window", [
    (10, 10, True, 0), (10, 10, True, 4), (10, 3, True, 4), (10, 6, True, 4),
    (10, 7, True, 4), (10, 3, False, 4), (10, 0, True, 0), (5, 9, False, 0),
    (12, 5, False, 8), (12, 4, False, 8)])
def test_first_dead_row_matches_dead_rows(sq, skv, causal, window):
    qpos = torch.arange(sq)[None]
    if skv == 0:
        assert first_dead_row(sq, skv, causal=causal, window=window) == 0
        return
    dead = dead_rows(qpos, skv, causal=causal, window=window)[0]
    want = int(dead.nonzero()[0]) if dead.any() else None
    assert first_dead_row(sq, skv, causal=causal, window=window) == want


@pytest.mark.parametrize("kw", [
    {"q_positions": torch.zeros((1, 4), dtype=torch.int32)},
    {"kv_valid": torch.ones((1, 4), dtype=torch.bool)}, {"q_offset": 2}])
def test_bwd_cuda_refuses_what_it_does_not_take(kw):
    """The backward wrapper raises on the forms its kernel does not take
    (before it looks for a card), and on CPU tensors."""
    t = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="training form"):
        flash_attention_bwd_cuda(t, t, t, t, t, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_cuda(t, t, t, t, t)


# --------------------------------------------------------------------------- #
# on the card: the backward kernel against its plain version
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_case(cuda, dtype, b, sq, skv, h, hkv, d, causal, window, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, skv, hkv, d), generator=g, device=cuda).to(dtype)
    do = torch.randn((b, sq, h, d), generator=g, device=cuda).to(dtype)
    out = flash_attention_cuda(q, k, v, causal=causal, window=window)
    return q, k, v, out, do


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 512, 512, 14, 2, 64, True, 0),        # qwen2-0.5b
    (1, 300, 300, 32, 2, 128, True, 256),     # glm4-9b, a 256 window
    (2, 256, 256, 16, 16, 128, True, 0),      # deepseek-moe-16b
    (1, 100, 2304, 64, 8, 128, False, 0),     # the vision cross shape
    (1, 129, 129, 8, 1, 32, True, 30),        # ragged Sq, G 8, D 32
    (1, 90, 60, 4, 2, 64, False, 0)])
def test_bwd_kernel_matches_plain(cuda, dtype, shape):
    causal, window = shape[6], shape[7]
    args = _card_case(cuda, dtype, *shape)
    got = flash_attention_bwd_cuda(*args, causal=causal, window=window)
    again = flash_attention_bwd_cuda(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    want = flash_attention_bwd_plain(*args, causal=causal, window=window)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and torch.equal(g, a)
        err = (g.float() - w.float()).abs().max() / w.float().abs().max()
        assert err <= CARD_REL[dtype], float(err)


@pytest.mark.gpu
def test_bwd_kernel_refuses_a_dead_row(cuda):
    args = _card_case(cuda, torch.float32, 1, 40, 8, 4, 2, 32, True, 0)
    with pytest.raises(ValueError, match="sees no key"):
        flash_attention_bwd_cuda(*args, causal=True, window=16)


@pytest.mark.gpu
def test_ops_on_the_card_keep_the_graph(cuda):
    """With grad, ops.flash_attention and ops.rmsnorm on the card return
    tensors with a grad_fn; a form the backward does not take raises."""
    q, k, v, _, _ = _card_case(cuda, torch.bfloat16, 1, 64, 64, 4, 2, 64,
                               True, 0)
    q.requires_grad_()
    out = ops.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    before = flash_attention_bwd_cuda.launches
    out.float().sum().backward()
    assert flash_attention_bwd_cuda.launches == before + 1
    with pytest.raises(ValueError, match="training form"):
        ops.flash_attention(q, k, v, kv_valid=torch.ones(
            (1, 64), dtype=torch.bool, device=cuda))
    x = torch.randn((8, 896), device=cuda, requires_grad=True)
    w = torch.ones((896,), device=cuda)
    before = rmsnorm_cuda.launches
    y = ops.rmsnorm(x, w)
    assert rmsnorm_cuda.launches == before + 1
    assert type(y.grad_fn).__name__ == "RmsnormFnBackward"
