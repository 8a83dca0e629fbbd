"""The flash backward with the forward's log-sum-exp, and the tile plan of
its bf16 tensor-core kernels (``csrc/flash_attention_bwd.cu``).

On the CPU: ``flash_attention_plain(return_lse=True)`` against a float64
logsumexp of the masked scaled scores; the plain backward given that LSE
against the plain backward computing its own; ``FlashAttentionFn`` saving
and passing the LSE (the plain pair) against ``jax.vjp`` of the JAX
package's ``_flash_jnp``; ``bwd_tile_plan``, the mirror of the bf16
kernels' tile plan, held to ``live_mask`` (every live (query, key) pair of
every head visited once by the dK/dV plan and once by the dQ plan, no
visited tile wholly dead); dK / dV summed over the query heads in the
order the plan names against the plain backward; the ``lse`` refusals.

On a CUDA card (marker ``gpu``; these need no JAX, which is imported
inside the CPU tests only)::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_flash_bwd_tc.py

the forward's output with and without ``return_lse`` bit for bit, its LSE
against the plain LSE, the backward given the LSE against the same call
without one bit for bit, one forward and one backward launch for each
training attention call, and the ``lse`` refusals.

Tolerances: the plain LSE against float64 atol 2e-5 (float32 scores and
sums over at most 2304 keys; readings ~1e-6); the plain backward with and
without a given LSE 1e-6 of the largest gradient (the same float32
formula: only how the LSE was summed differs); against JAX 2e-5 of the
largest gradient, as ``tests/test_torch_flash_bwd.py``; the plan-ordered
sums 2e-5 (float32 sums in another order); the kernel's LSE against the
plain LSE atol 1e-4 in float32 and bf16 (both sum the same bf16-valued
products in float32, in another order; readings up to 2e-6).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (TILE_KEYS, bwd_tile_plan,
                                                 dkdv_query_rows,
                                                 dkdv_warpgroups,
                                                 flash_attention_bwd_cuda,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_cuda,
                                                 flash_attention_plain,
                                                 live_mask)
from torch_threads import one_torch_thread  # noqa: F401

LSE_ATOL = 2e-5
GIVEN_REL = 1e-6
REL = 2e-5
CARD_LSE_ATOL = 1e-4
# (b, sq, skv, h, hkv, d, causal, window): the forms of
# tests/test_torch_flash_bwd.py
FORMS = {
    "causal_g7": (2, 70, 70, 14, 2, 32, True, 0),
    "window_g7": (2, 90, 90, 14, 2, 32, True, 24),
    "cross_g8": (2, 40, 100, 16, 2, 64, False, 0),
    "g1": (1, 65, 65, 4, 4, 32, True, 0),
    "g16": (1, 33, 33, 16, 1, 32, True, 0),
    "ragged_window": (1, 129, 129, 8, 1, 32, True, 64),
    "noncausal_window": (1, 50, 50, 4, 2, 32, False, 16),
}
# (sq, skv, g, d, causal, window): the plan's forms — causal, windows,
# Sq != Skv both ways, ragged tiles, non-causal, G 1 / 7 / 8, one and two
# dK/dV warpgroups
PLANS = {
    "causal_g7": (512, 512, 7, 64, True, 0),
    "causal_g1_d128": (200, 200, 1, 128, True, 0),
    "window_g8": (300, 300, 8, 32, True, 100),
    "window_g7_d128": (333, 333, 7, 128, True, 64),
    "ragged_g7": (129, 129, 7, 64, True, 0),
    "sq_lt_skv_g8": (100, 260, 8, 64, True, 0),
    "sq_gt_skv_g1": (260, 100, 1, 64, True, 0),
    "noncausal_g8": (90, 150, 8, 128, False, 0),
    "noncausal_window_g7": (150, 150, 7, 32, False, 40),
    "cross_g8": (70, 2304, 8, 128, False, 0),
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
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _lse64(q, k, causal, window):
    """[B, H, Sq] float64 logsumexp of each row's scaled live scores."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    kk = np.repeat(k.astype(np.float64), h // hkv, axis=2)
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kk) / np.sqrt(d)
    mask = live_mask(torch.arange(sq)[None].expand(b, sq), skv, causal=causal,
                     window=window).numpy()[:, None]
    s = np.where(mask, s, -np.inf)
    m = s.max(-1, keepdims=True)
    return (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("form", list(FORMS))
def test_plain_lse_matches_float64_logsumexp(form):
    b, sq, skv, h, hkv, d, causal, window = FORMS[form]
    q, k, v, _ = _inputs(0, b, sq, skv, h, hkv, d)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out, lse = flash_attention_plain(qt, kt, vt, causal=causal, window=window,
                                     return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    assert torch.equal(out, flash_attention_plain(qt, kt, vt, causal=causal,
                                                  window=window))
    np.testing.assert_allclose(lse.numpy(), _lse64(q, k, causal, window),
                               atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("form", list(FORMS))
def test_bwd_plain_given_lse_matches_its_own(form):
    b, sq, skv, h, hkv, d, causal, window = FORMS[form]
    q, k, v, do = map(torch.from_numpy, _inputs(1, b, sq, skv, h, hkv, d))
    out, lse = flash_attention_plain(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    got = flash_attention_bwd_plain(q, k, v, out, do, causal=causal,
                                    window=window, lse=lse)
    want = flash_attention_bwd_plain(q, k, v, out, do, causal=causal,
                                     window=window)
    for g, w, name in zip(got, want, "qkv"):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _rel(g.numpy(), w.numpy()) <= GIVEN_REL, name


@pytest.mark.parametrize("form", list(FORMS))
def test_flash_fn_passes_the_lse_and_matches_jax_vjp(jx, form):
    """FlashAttentionFn with the plain pair: the forward is asked for the
    LSE, the backward gets that very tensor, and the gradients match
    jax.vjp of the JAX package's _flash_jnp."""
    b, sq, skv, h, hkv, d, causal, window = FORMS[form]
    q, k, v, do = _inputs(2, b, sq, skv, h, hkv, d)
    seen = {}

    def fwd(*args, **kw):
        res = flash_attention_plain(*args, **kw)
        seen["fwd_lse"] = res[1] if kw.get("return_lse") else None
        return res

    def bwd(*args, **kw):
        seen["bwd_lse"] = kw.get("lse")
        return flash_attention_bwd_plain(*args, **kw)

    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.FlashAttentionFn.apply(qt, kt, vt, causal, window, fwd, bwd)
    got = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    assert seen["fwd_lse"] is not None and seen["bwd_lse"] is seen["fwd_lse"]
    jnp = jx["jnp"]
    _, vjp = jx["jax"].vjp(
        lambda a, b_, c: jx["ops"]._flash_jnp(a, b_, c, causal=causal,
                                              window=window, q_offset=0,
                                              chunk=1024),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, w, name in zip(got, vjp(jnp.asarray(do)), "qkv"):
        assert _rel(g.numpy(), np.asarray(w)) < REL, name


def _live(sq, skv, causal, window):
    return live_mask(torch.arange(sq)[None], skv, causal=causal,
                     window=window)[0].numpy()


@pytest.mark.parametrize("plan", list(PLANS))
def test_bwd_tile_plan_visits_every_live_pair_once(plan):
    """Both plans cover every live (head, query, key) pair exactly once and
    visit no tile (or packed tile x key tile) without a live pair."""
    sq, skv, g, d, causal, window = PLANS[plan]
    live = _live(sq, skv, causal, window)
    tp = bwd_tile_plan(sq, skv, g, d, causal=causal, window=window)
    assert len(tp["dkdv"]) == -(-skv // TILE_KEYS)
    qn = dkdv_query_rows(d)
    dkdv = np.zeros((g, sq, skv), np.int32)
    for kt, per_wg in enumerate(tp["dkdv"]):
        assert len(per_wg) == dkdv_warpgroups(d)
        ks = slice(kt * TILE_KEYS, (kt + 1) * TILE_KEYS)
        for items in per_wg:
            for head, qt in items:
                qs = slice(qt * qn, (qt + 1) * qn)
                assert live[qs, ks].any(), (kt, head, qt)
                dkdv[head, qs, ks] += live[qs, ks]
    dq = np.zeros((g, sq, skv), np.int32)
    rows = 0
    for t0, nt, tiles in tp["dq"]:
        rows += nt
        for kt in tiles:
            ks = slice(kt * TILE_KEYS, (kt + 1) * TILE_KEYS)
            assert live[t0:t0 + nt, ks].any(), (t0, kt)
            dq[:, t0:t0 + nt, ks] += live[t0:t0 + nt, ks]
    assert rows == sq
    want = np.broadcast_to(live, (g, sq, skv)).astype(np.int32)
    np.testing.assert_array_equal(dkdv, want)
    np.testing.assert_array_equal(dq, want)


def test_bwd_tile_plan_splits_items_between_warpgroups():
    """Warpgroup w sums items w, w + n, ... of one head-major sequence, so
    at G 7, S 512 and causal key tile 0 of 4 query tiles of 128 the two
    warpgroups get 14 items each, interleaved; at D 128 one warpgroup takes
    all 56 items of 64 queries."""
    tp = bwd_tile_plan(512, 512, 7, 64, causal=True, window=0)
    wg0, wg1 = tp["dkdv"][0]
    items = [(g, qt) for g in range(7) for qt in range(4)]
    assert wg0 == items[0::2] and wg1 == items[1::2]
    last = [(g, 3) for g in range(7)]
    assert tp["dkdv"][7] == [last[0::2], last[1::2]]
    assert bwd_tile_plan(512, 512, 7, 128, causal=True,
                         window=0)["dkdv"][0] == [
        [(g, qt) for g in range(7) for qt in range(8)]]


@pytest.mark.parametrize("form", ["causal_g7", "window_g7", "cross_g8",
                                  "ragged_window"])
def test_gqa_heads_summed_in_plan_order(form):
    """dK and dV walked as the bf16 kernel walks them — per key tile, each
    warpgroup's items in the plan's order, then warpgroup 1's sums added to
    warpgroup 0's — in float32 with the forward's LSE, against the plain
    backward."""
    b, sq, skv, h, hkv, d, causal, window = FORMS[form]
    q, k, v, do = map(torch.from_numpy, _inputs(3, b, sq, skv, h, hkv, d))
    g, scale = h // hkv, 1.0 / d ** 0.5
    out, lse = flash_attention_plain(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    delta = (do * out).sum(-1).permute(0, 2, 1)                # [B, H, Sq]
    live = torch.from_numpy(_live(sq, skv, causal, window))
    tp = bwd_tile_plan(sq, skv, g, d, causal=causal, window=window)
    qn = dkdv_query_rows(d)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for kt, per_wg in enumerate(tp["dkdv"]):
        ks = slice(kt * TILE_KEYS, (kt + 1) * TILE_KEYS)
        for kvh in range(hkv):
            sums = []
            for items in per_wg:
                acc_k = torch.zeros((b, k[:, ks].shape[1], d))
                acc_v = torch.zeros_like(acc_k)
                for head, qt in items:
                    hh = kvh * g + head
                    qs = slice(qt * qn, (qt + 1) * qn)
                    st = torch.einsum("bkd,bqd->bkq", k[:, ks, kvh],
                                      q[:, qs, hh])
                    p = torch.where(live[qs, ks].T, torch.exp(
                        st * scale - lse[:, hh, None, qs]), 0.0)
                    dpt = torch.einsum("bkd,bqd->bkq", v[:, ks, kvh],
                                       do[:, qs, hh])
                    ds = p * (dpt - delta[:, hh, None, qs])
                    acc_v += torch.einsum("bkq,bqd->bkd", p, do[:, qs, hh])
                    acc_k += torch.einsum("bkq,bqd->bkd", ds, q[:, qs, hh])
                sums.append((acc_k, acc_v))
            tot_k, tot_v = sums[0]
            for acc_k, acc_v in sums[1:]:
                tot_k, tot_v = tot_k + acc_k, tot_v + acc_v
            dk[:, ks, kvh], dv[:, ks, kvh] = tot_k * scale, tot_v
    _, want_k, want_v = flash_attention_bwd_plain(q, k, v, out, do,
                                                  causal=causal,
                                                  window=window)
    assert _rel(dk.numpy(), want_k.numpy()) < REL
    assert _rel(dv.numpy(), want_v.numpy()) < REL


@pytest.mark.parametrize("lse", [
    torch.zeros((1, 2, 4), dtype=torch.float64),
    torch.zeros((1, 4, 2)), torch.zeros((1, 2, 5)), torch.zeros((2, 4))])
def test_bwd_cuda_refuses_a_wrong_lse(lse):
    """An lse that is not float32 [B, H, Sq] is refused before anything
    else is looked at."""
    t = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="lse must be"):
        flash_attention_bwd_cuda(t, t, t, t, t, lse=lse)


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_SHAPES = [
    (2, 512, 512, 14, 2, 64, True, 0),        # qwen2-0.5b
    (1, 300, 300, 32, 2, 128, True, 256),     # glm4-9b, a 256 window
    (1, 100, 2304, 64, 8, 128, False, 0),     # the vision cross shape
    (1, 129, 129, 8, 1, 32, True, 30),        # ragged Sq, G 8, D 32
    (1, 90, 60, 4, 2, 64, False, 0)]


def _card_inputs(cuda, dtype, b, sq, skv, h, hkv, d, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=cuda).to(dtype)
            for shape in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d),
                          (b, sq, h, d))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_forward_lse_on_the_card(cuda, dtype, shape):
    """out with and without return_lse bit for bit; the kernel's LSE
    against the plain version's."""
    causal, window = shape[6], shape[7]
    q, k, v, _ = _card_inputs(cuda, dtype, *shape[:6])
    out0 = flash_attention_cuda(q, k, v, causal=causal, window=window)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    torch.cuda.synchronize()
    _, want = flash_attention_plain(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    assert torch.equal(out, out0)
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    assert (lse - want).abs().max().item() <= CARD_LSE_ATOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_bwd_given_lse_is_bit_for_bit_without(cuda, dtype, shape):
    causal, window = shape[6], shape[7]
    q, k, v, do = _card_inputs(cuda, dtype, *shape[:6])
    out, lse = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    return_lse=True)
    got = flash_attention_bwd_cuda(q, k, v, out, do, causal=causal,
                                   window=window, lse=lse)
    again = flash_attention_bwd_cuda(q, k, v, out, do, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    for a, c in zip(got, again):
        assert torch.equal(a, c)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_forward_and_one_backward_launch_a_call(cuda, dtype):
    q, k, v, do = _card_inputs(cuda, dtype, 2, 128, 128, 14, 2, 64)
    q.requires_grad_()
    f0, b0 = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches
    out = ops.flash_attention(q, k, v, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == f0 + 1
    assert flash_attention_bwd_cuda.launches == b0 + 1


@pytest.mark.gpu
def test_bwd_cuda_refuses_a_wrong_lse_on_the_card(cuda):
    q, k, v, do = _card_inputs(cuda, torch.bfloat16, 1, 64, 64, 4, 2, 64)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True)
    for bad in (lse.double(), lse[:, :2], lse.transpose(1, 2), lse[..., :-1]):
        with pytest.raises(ValueError, match="lse must be"):
            flash_attention_bwd_cuda(q, k, v, out, do, lse=bad)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_bwd_cuda(q, k, v, out, do, lse=lse.cpu())
