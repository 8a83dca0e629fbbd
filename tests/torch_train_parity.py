"""Shared check of the train-mode gradient parity tests
(``tests/test_torch_train_grads*.py``): one numpy-seeded batch through the
JAX package's ``loss_fn`` under ``jax.value_and_grad`` and through the
port's ``loss_and_grads``, weights bridged with ``params_from_jax``, both in
float32.

Tolerance: loss, lm loss and aux loss rtol 1e-5; every gradient leaf within
1e-4 of the largest entry of the reference's leaf (the same float32
products summed in another order; readings up to ~1e-5).  A leaf the loss
does not reach must be all zeros in the reference.
"""
import dataclasses

import numpy as np
import torch

LEAF_REL = 1e-4


def _jpath(path):
    return tuple(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def check_grads(name, *, reduced, remat=False, b=2, s=24, seed=0):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.models import model as jmodel
    from repro.training import train_step as jts
    from repro_torch.configs import get_config
    from repro_torch.models.convert import params_from_jax
    from repro_torch.training import train_step as tts
    from repro_torch.training.optimizer import tree_flatten_with_path

    jcfg, tcfg = jax_get_config(name), get_config(name)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    jcfg = dataclasses.replace(jcfg, dtype="float32")
    tcfg = dataclasses.replace(tcfg, dtype="float32")
    jp = jmodel.build_model(jcfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1),
             "mask": (rng.random((b, s)) < 0.8).astype(np.float32)}
    if jcfg.vision is not None:
        batch["image_embeds"] = rng.standard_normal(
            (b, jcfg.vision.num_image_tokens, jcfg.vision.embed_dim)
        ).astype(np.float32)
    if jcfg.audio is not None:
        batch["audio_frames"] = rng.standard_normal(
            (b, jcfg.audio.num_frames, jcfg.audio.embed_dim)
        ).astype(np.float32)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, bt: jts.loss_fn(p, bt, cfg=jcfg, remat=remat),
        has_aux=True))
    (jloss, jparts), jgrads = grad_fn(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})

    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    loss, parts, grads = tts.loss_and_grads(
        tp, tts.batch_to(batch, "cpu"), cfg=tcfg, remat=remat)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("lm_loss", "aux_loss"):
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    tflat = tree_flatten_with_path(tp)
    assert [_jpath(p) for p, _ in jflat] == [tuple(map(str, p))
                                             for p, _ in tflat]
    worst = 0.0
    for (path, want), (_, leaf), got in zip(jflat, tflat, grads):
        want = np.asarray(want)
        if got is None:
            assert not want.any(), f"{_jpath(path)}: no gradient in the port"
            continue
        assert got.shape == leaf.shape and got.dtype == leaf.dtype
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.numpy() - want).max()) / scale
        worst = max(worst, err)
        assert err <= LEAF_REL, (_jpath(path), err)
    return {"loss": float(loss), "aux_loss": float(parts["aux_loss"]),
            "worst_leaf_rel": worst, "leaves": len(tflat)}
