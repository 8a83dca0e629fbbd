"""The port's ``rmsnorm`` (a kernel of its own) and what else this
repository only checks on the card: the threefry streams on CUDA, and a
race of two threads on a kernel's first build.

On the CPU: ``ops.rmsnorm`` (the plain version) against the JAX package's
``layers.rmsnorm`` (float32 atol 1e-6; bf16 within one bf16 rounding,
2e-2), row-invariant across call sizes, and the wrapper's refusals.

On a CUDA card (marker ``gpu``; the file imports JAX only inside the CPU
tests, so these run where JAX is not installed)::

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_rmsnorm.py

* the kernel against its plain version: bf16 atol 2e-2, float32 1e-5;
* the kernel against itself across row counts, bit for bit: rows 0-7 of
  an 8-row call equal the same rows inside 40 and inside 512, at D 896
  (``qwen2-0.5b``) and 2048 (``deepseek-moe-16b``), float32 and bf16;
* the lean launch path (one test, one packed call) on a side stream,
  counting once a call, beside the refusals it still raises;
* threefry bits, uniforms and categorical draws on the card equal the
  same functions on the CPU (held to JAX by ``test_torch_threefry.py``)
  bit for bit;
* two threads reaching ``build.load`` of one kernel together build one
  library with one ``nvcc`` and get the same entry point.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import sampling
from repro_torch.kernels import build, ops
from repro_torch.kernels.rmsnorm import rmsnorm_cuda, rmsnorm_plain
from torch_threads import one_torch_thread  # noqa: F401

CARD_ATOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
WIDTHS = (896, 2048)


def _x(rows, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, d)) * 2).astype(np.float32), \
        (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)


# --------------------------------------------------------------------------- #
# CPU: the plain version against the JAX package
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_layers_rmsnorm(d, dtype):
    import jax.numpy as jnp

    from repro.models import layers as jlayers
    x, w = _x(12, d)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = np.asarray(jlayers.rmsnorm(jnp.asarray(x).astype(jd),
                                      jnp.asarray(w).astype(jd), 1e-6)
                      .astype(jnp.float32))
    got = ops.rmsnorm(torch.from_numpy(x).to(td), torch.from_numpy(w).to(td),
                      1e-6).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 if dtype == "float32" else 2e-2)


def test_ops_rmsnorm_takes_any_leading_shape_on_cpu():
    x, w = _x(24, 896, seed=1)
    x3 = torch.from_numpy(x).reshape(2, 3, 4, 896)
    got = ops.rmsnorm(x3, torch.from_numpy(w))
    assert got.shape == x3.shape
    torch.testing.assert_close(got.reshape(24, 896),
                               rmsnorm_plain(torch.from_numpy(x),
                                             torch.from_numpy(w)),
                               rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    x, w = _x(2, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rmsnorm_cuda(torch.from_numpy(x), torch.from_numpy(w))


# --------------------------------------------------------------------------- #
# on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("d", WIDTHS + (64, 1000))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(cuda, d, dtype):
    x, w = _x(40, d, seed=d)
    xt = torch.from_numpy(x).to(cuda, dtype).reshape(8, 5, d)
    wt = torch.from_numpy(w).to(cuda, dtype)
    got = rmsnorm_cuda(xt, wt, 1e-6)
    torch.cuda.synchronize()
    assert got.shape == xt.shape and got.dtype == dtype
    err = (got.float() - rmsnorm_plain(xt, wt, 1e-6).float()).abs().max()
    assert err.item() <= CARD_ATOL[dtype]
    # a float32 weight under bf16 activations, and a strided row view
    got = rmsnorm_cuda(xt.reshape(40, d)[::2], wt.float())
    torch.cuda.synchronize()
    err = (got.float() - rmsnorm_plain(xt.reshape(40, d)[::2],
                                       wt.float()).float()).abs().max()
    assert err.item() <= CARD_ATOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_is_row_invariant(cuda, d, dtype):
    """Rows 0-7 alone, inside 40 and inside 512: the same bits."""
    x, w = _x(512, d, seed=7)
    xt = torch.from_numpy(x).to(cuda, dtype)
    wt = torch.from_numpy(w).to(cuda, dtype)
    alone = rmsnorm_cuda(xt[:8].clone(), wt)
    for rows in (40, 512):
        inside = rmsnorm_cuda(xt[:rows].clone(), wt)[:8]
        torch.cuda.synchronize()
        assert torch.equal(alone, inside), f"8 rows vs {rows} rows"


@pytest.mark.gpu
def test_rmsnorm_kernel_refuses_what_it_does_not_take(cuda):
    x = torch.randn((4, 6, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm_cuda(x[:, ::2], torch.ones(64, device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rmsnorm_cuda(x.half(), torch.ones(64, device=cuda))
    with pytest.raises(ValueError, match="contiguous \\[64\\]"):
        rmsnorm_cuda(x, torch.ones(128, device=cuda)[::2])


@pytest.mark.gpu
def test_rmsnorm_lean_path_on_a_side_stream(cuda):
    """The common case (contiguous x and w) launches on the current
    stream, a side stream here, and counts once a call; off it, the
    refusals above still raise and a strided view still launches."""
    x, w = _x(40, 896, seed=2)
    xt = torch.from_numpy(x).to(cuda, torch.bfloat16)
    wt = torch.from_numpy(w).to(cuda, torch.bfloat16)
    want = rmsnorm_plain(xt, wt)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = rmsnorm_cuda.launches
    with torch.cuda.stream(side):
        got = rmsnorm_cuda(xt, wt)
        strided = rmsnorm_cuda(xt[::2], wt.float())
        with pytest.raises(ValueError, match="contiguous"):
            rmsnorm_cuda(xt.reshape(8, 5, 896)[:, ::2], wt)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            rmsnorm_cuda(xt.half(), wt)
        with pytest.raises(ValueError, match="contiguous \\[896\\]"):
            rmsnorm_cuda(xt, torch.ones(1792, device=cuda)[::2])
        with pytest.raises(ValueError, match="CUDA tensors"):
            rmsnorm_cuda(xt, wt.cpu())
    side.synchronize()
    assert rmsnorm_cuda.launches == before + 2
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert torch.equal(got[::2], rmsnorm_cuda(xt[::2].contiguous(), wt))
    assert (strided.float() - rmsnorm_plain(xt[::2], wt.float()).float()
            ).abs().max().item() <= 2e-2


@pytest.mark.gpu
def test_threefry_on_cuda_equals_cpu(cuda):
    """Bits, uniforms and categorical draws over the full vocabulary, and
    the folded step keys: CUDA against CPU, bit for bit."""
    keys = np.stack([sampling.request_base_key(s) for s in
                     (0, 1234, 2**32 + 9, 2**63 - 1)]).astype(np.int64)
    kc, kg = torch.from_numpy(keys), torch.from_numpy(keys).to(cuda)
    v = 151936
    assert torch.equal(sampling.random_bits(kg, v).cpu(),
                       sampling.random_bits(kc, v))
    assert torch.equal(sampling.uniform(kg, v).cpu().view(torch.int32),
                       sampling.uniform(kc, v).view(torch.int32))
    pos = torch.tensor([0, 5, 2047, 70000])
    assert torch.equal(sampling.fold_step_keys(kg, pos.to(cuda)).cpu(),
                       sampling.fold_step_keys(kc, pos))
    logits = torch.randn((4, v), generator=torch.Generator().manual_seed(0))
    assert torch.equal(sampling.categorical(kg, logits.to(cuda)).cpu(),
                       sampling.categorical(kc, logits))


@pytest.mark.gpu
def test_two_threads_race_to_first_build(cuda, tmp_path, monkeypatch):
    """Two threads call ``build.load`` of one kernel at once, with nothing
    built: one nvcc runs, both get the same library."""
    monkeypatch.setattr(build, "BUILD", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    runs = []
    popen = build.subprocess.Popen

    def counting(*a, **kw):
        runs.append(a)
        return popen(*a, **kw)

    monkeypatch.setattr(build.subprocess, "Popen", counting)
    gate = threading.Barrier(2)
    got = [None, None]

    def first_use(i):
        gate.wait()
        got[i] = build.load("rmsnorm")

    threads = [threading.Thread(target=first_use, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(runs) == 1
    assert got[0][1] is got[1][1]
    assert len(list(tmp_path.glob("librmsnorm-*.so"))) == 1
