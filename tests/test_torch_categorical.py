"""The sampler's draw (``ops.categorical``): JAX's threefry Gumbel noise
plus the argmax of noise + logits, one CUDA kernel on the card
(``csrc/categorical.cu``) beside its plain version.

On the CPU (JAX imported inside these tests only):

* ``ops.categorical`` (the plain version) against
  ``vmap(jax.random.categorical)(vmap(fold_in)(keys, pos), logits)``,
  unsalted and salted (``fold_in(fold_in(key, salt), pos)``), B 4 at V
  151936 and 1000: -inf masks, a row with one live entry, an all -inf row
  (draws 0), seeds >= 2**32 (through ``request_base_key``) and a position
  >= 2**32 (its low 32 bits folded in); exact;
* ``masked_sample_inner`` against the JAX package's ``masked_sample`` at
  the same widths, temperature alone and with top-p; exact;
* the sampler's draws go through ``ops.categorical`` (so the engine and
  the speculative verifier reach the kernel on the card);
* the wrapper refuses CPU tensors; the chunk plan.

On a CUDA card (marker ``gpu``; no JAX needed)::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_categorical.py

* the kernel's draws equal the plain version's over the sweep above and at
  V 102400 and 128256, unsalted and salted, on a side stream too;
* ``gumbel_noise`` equals ``sampling.gumbel`` of the folded keys bit for
  bit (libdevice ``logf`` on both sides);
* a row alone equals the same row inside 8 and 40 rows; the draws do not
  depend on the chunk a block takes; positions >= 2**32 are truncated as
  the plain ``fold_in`` truncates them;
* the wrapper refuses wrong dtypes, shapes and strides.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import sampling, spec_decode
from repro_torch.kernels import categorical as cat
from repro_torch.kernels import ops
from torch_threads import one_torch_thread  # noqa: F401

SEEDS = (5, 2**32 + 3, 2**40 + 11, 2**63 - 1)
POSITIONS = (0, 2047, 70000, 2**32 + 5)
SALTS = (None, spec_decode.CORRECTION_SALT, spec_decode.DRAFT_SALT)
WIDTHS = (1000, 151936)
CARD_WIDTHS = WIDTHS + (102400, 128256)


def _case(b, v, seed=0):
    """Base keys (seeded requests), positions and logits [b, v]: row 0
    masks every third entry, row 1 keeps one live entry, row 2 is all -inf
    (when b > 2), the rest are plain."""
    rng = np.random.default_rng(seed)
    keys = np.stack([sampling.request_base_key(SEEDS[i % len(SEEDS)] + i //
                                               len(SEEDS))
                     for i in range(b)]).astype(np.int64)
    pos = np.asarray([POSITIONS[i % len(POSITIONS)] + i // len(POSITIONS)
                      for i in range(b)], np.int64)
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    logits[0, ::3] = -np.inf
    if b > 1:
        live = logits[1, v // 2]
        logits[1] = -np.inf
        logits[1, v // 2] = live
    if b > 2:
        logits[2] = -np.inf
    return keys, pos, logits


def _jax_draws(keys, pos, logits, salt):
    import jax
    import jax.numpy as jnp
    k = jnp.asarray(keys.astype(np.uint32))
    if salt is not None:
        k = jax.vmap(lambda kk: jax.random.fold_in(kk, salt))(k)
    step = jax.vmap(jax.random.fold_in)(
        k, jnp.asarray((pos & 0xFFFFFFFF).astype(np.uint32)))
    return np.asarray(jax.vmap(jax.random.categorical)(step,
                                                       jnp.asarray(logits)))


# --------------------------------------------------------------------------- #
# CPU: the plain version against JAX
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("v", WIDTHS)
def test_ops_categorical_matches_jax(v, salt):
    keys, pos, logits = _case(4, v, seed=v)
    got = ops.categorical(torch.from_numpy(logits), torch.from_numpy(keys),
                          torch.from_numpy(pos), salt).numpy()
    want = _jax_draws(keys, pos, logits, salt)
    np.testing.assert_array_equal(got, want)
    assert got[2] == 0                          # the all -inf row
    assert got[1] == v // 2                     # the one live entry
    assert np.all(np.isfinite(logits[0, got[0]]))


@pytest.mark.parametrize("mask", [False, True])
@pytest.mark.parametrize("v", WIDTHS)
def test_masked_sample_inner_matches_jax(v, mask):
    """The batched sampler, temperature alone and with top-p, against the
    JAX package's ``masked_sample``: rows with -inf entries and one live
    entry, a greedy row."""
    import jax.numpy as jnp

    from repro.core import sampling as jsampling
    keys, pos, logits = _case(2, v, seed=v + 1)
    _, _, more = _case(2, v, seed=v + 2)
    logits = np.concatenate([logits, more[::-1]])
    keys = np.concatenate([keys, keys[::-1] ^ 1])
    pos = np.concatenate([pos, pos[::-1] + 3]) & 0x7FFFFFFF
    temps = np.asarray([0.8, 1.3, 0.0, 0.8], np.float32)
    top_p = np.asarray([0.95, 1.0, 1.0, 0.9] if mask else [1.0] * 4,
                       np.float32)
    top_k = np.zeros(4, np.int32)
    min_p = np.zeros(4, np.float32)
    ours = sampling.masked_sample_inner(
        torch.from_numpy(logits), torch.from_numpy(keys),
        torch.from_numpy(pos), torch.from_numpy(temps),
        torch.from_numpy(top_p), torch.from_numpy(top_k).long(),
        torch.from_numpy(min_p), any_stochastic=True, any_mask=mask).numpy()
    ref = np.asarray(jsampling.masked_sample(
        jnp.asarray(logits), jnp.asarray(keys.astype(np.uint32)),
        jnp.asarray(pos.astype(np.int32)), jnp.asarray(temps),
        jnp.asarray(top_p), jnp.asarray(top_k), jnp.asarray(min_p)))
    np.testing.assert_array_equal(ours, ref)


def test_sampler_draws_go_through_ops_categorical(monkeypatch):
    """``masked_sample_inner`` and ``salted_categorical`` draw through
    ``ops.categorical`` (the kernel's entry on the card), with the salt
    only on the salted stream, and return what it returns."""
    calls = []
    plain = ops.categorical

    def recording(logits, base_keys, positions, salt=None):
        calls.append(salt)
        return plain(logits, base_keys, positions, salt)

    monkeypatch.setattr(ops, "categorical", recording)
    keys, pos, logits = _case(3, 1000)
    kt, pt, lt = (torch.from_numpy(a) for a in (keys, pos, logits))
    ones = torch.ones(3)
    drawn = sampling.masked_sample_inner(
        lt, kt, pt, ones, ones, torch.zeros(3, dtype=torch.int64),
        torch.zeros(3), any_stochastic=True, any_mask=False)
    salted = sampling.salted_categorical(kt, spec_decode.DRAFT_SALT, pt, lt)
    assert calls == [None, spec_decode.DRAFT_SALT]
    assert torch.equal(drawn, sampling.categorical(
        sampling.fold_step_keys(kt, pt), lt))
    assert torch.equal(salted, sampling.categorical(
        sampling.fold_salted_keys(kt, spec_decode.DRAFT_SALT, pt), lt))


def test_kernel_wrapper_refuses_cpu_tensors():
    keys, pos, logits = _case(2, 300)
    kt, pt, lt = (torch.from_numpy(a) for a in (keys, pos, logits))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cat.categorical_cuda(lt, kt, pt)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cat.categorical_cuda(lt, kt, pt, salt=7)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cat.gumbel_noise(kt, pt, 300)


@pytest.mark.parametrize("b,v,sms,want", [(8, 151936, 132, 2048),
                                          (1, 151936, 132, 512),
                                          (40, 151936, 132, 2048),
                                          (1, 1000, 132, 256)])
def test_chunk_plan_fills_the_card(b, v, sms, want):
    """The largest chunk that leaves two blocks an SM, a multiple of the
    block's 256 threads, never below 256."""
    chunk = cat.plan_chunk(b, v, sms)
    assert chunk == want and chunk % cat.THREADS == 0
    assert chunk == cat.THREADS or b * -(-v // chunk) >= 2 * sms


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("v", CARD_WIDTHS)
def test_kernel_draws_equal_plain(cuda, v, salt):
    keys, pos, logits = _case(8, v, seed=v)
    kt, pt, lt = _on(cuda, keys, pos, logits)
    got = cat.categorical_cuda(lt, kt, pt, salt)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and got.shape == (8,)
    assert torch.equal(got, cat.categorical_plain(lt, kt, pt, salt))
    assert got[2].item() == 0 and got[1].item() == v // 2


@pytest.mark.gpu
@pytest.mark.parametrize("salt", SALTS)
def test_gumbel_noise_bit_for_bit(cuda, salt):
    keys, pos, _ = _case(8, 8)
    kt, pt = _on(cuda, keys, pos)
    got = cat.gumbel_noise(kt, pt, 151936, salt)
    step = (sampling.fold_step_keys(kt, pt) if salt is None
            else sampling.fold_salted_keys(kt, salt, pt))
    want = sampling.gumbel(step, 151936)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_row_alone_equals_row_inside_8_and_40(cuda):
    keys, pos, logits = _case(40, 151936, seed=3)
    kt, pt, lt = _on(cuda, keys, pos, logits)
    inside40 = cat.categorical_cuda(lt, kt, pt)
    inside8 = cat.categorical_cuda(lt[:8].clone(), kt[:8].clone(),
                                   pt[:8].clone())
    for r in (0, 3, 7):
        alone = cat.categorical_cuda(lt[r:r + 1].clone(), kt[r:r + 1].clone(),
                                     pt[r:r + 1].clone())
        assert alone.item() == inside8[r].item() == inside40[r].item()
    torch.cuda.synchronize()
    assert torch.equal(inside40, cat.categorical_plain(lt, kt, pt))


@pytest.mark.gpu
def test_draws_do_not_depend_on_the_chunk(cuda):
    keys, pos, logits = _case(8, 151936, seed=9)
    kt, pt, lt = _on(cuda, keys, pos, logits)
    draws = [cat.categorical_cuda(lt, kt, pt, 11, chunk=c)
             for c in (256, 1024, 4096, 8192)]
    torch.cuda.synchronize()
    assert all(torch.equal(d, draws[0]) for d in draws)


@pytest.mark.gpu
def test_positions_past_2_32_truncate(cuda):
    """A position p >= 2**32 draws what p & 0xFFFFFFFF draws, on the
    kernel and in the plain ``fold_in``."""
    keys, pos, logits = _case(4, 32000, seed=4)
    kt, pt, lt = _on(cuda, keys, pos, logits)
    high = pt + (7 << 32)
    assert torch.equal(cat.categorical_cuda(lt, kt, high),
                       cat.categorical_cuda(lt, kt, pt))
    assert torch.equal(cat.categorical_cuda(lt, kt, high),
                       cat.categorical_plain(lt, kt, high))


@pytest.mark.gpu
def test_kernel_on_a_side_stream(cuda):
    keys, pos, logits = _case(8, 151936, seed=6)
    kt, pt, lt = _on(cuda, keys, pos, logits)
    want = cat.categorical_plain(lt, kt, pt, spec_decode.ACCEPT_SALT)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = cat.categorical_cuda(lt, kt, pt, spec_decode.ACCEPT_SALT)
        noise = cat.gumbel_noise(kt, pt, 151936)
    side.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(noise, sampling.gumbel(
        sampling.fold_step_keys(kt, pt), 151936))


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    keys, pos, logits = _case(4, 512)
    kt, pt, lt = _on(cuda, keys, pos, logits)
    with pytest.raises(ValueError, match="float32 logits"):
        cat.categorical_cuda(lt.bfloat16(), kt, pt)
    with pytest.raises(ValueError, match="float32 logits"):
        cat.categorical_cuda(lt.t().contiguous().t(), kt, pt)
    with pytest.raises(ValueError, match="int64"):
        cat.categorical_cuda(lt, kt.int(), pt)
    with pytest.raises(ValueError, match="int64"):
        cat.categorical_cuda(lt, kt, pt.int())
    with pytest.raises(ValueError, match="must be"):
        cat.categorical_cuda(lt, kt[:3], pt)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cat.categorical_cuda(lt, kt.cpu(), pt)
