"""Train-mode loss and every gradient leaf of the port against
``jax.value_and_grad`` of the JAX package's ``loss_fn`` on the CPU, for the
recurrent, vision and audio families: ``mamba2-780m`` and
``jamba-1.5-large-398b`` reduced (the differentiable SSD; jamba's MoE aux
loss), ``qwen3-vl-toy`` (gated cross-attention over image embeddings) and
``seamless-m4t-medium`` reduced (the audio encoder and the decoder's
cross-attention), float32.  Tolerances in ``tests/torch_train_parity.py``."""
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from torch_train_parity import check_grads

CASES = [("mamba2-780m", True), ("jamba-1.5-large-398b", True),
         ("qwen3-vl-toy", False), ("seamless-m4t-medium", True)]


@pytest.mark.parametrize("name,reduced", CASES)
def test_loss_and_every_grad_leaf_match_jax(name, reduced):
    out = check_grads(name, reduced=reduced)
    if name == "jamba-1.5-large-398b":
        assert out["aux_loss"] > 0
