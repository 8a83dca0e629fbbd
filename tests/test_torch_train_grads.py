"""Train-mode loss and every gradient leaf of the port against
``jax.value_and_grad`` of the JAX package's ``loss_fn`` on the CPU, for the
dense and MoE families: ``qwen2-0.5b`` reduced, ``qwen3-0.6b-toy`` and
``qwen3-30b-a3b-toy`` (its MoE aux loss in the loss), float32; the port's
attention gradient is ``flash_attention_bwd_plain`` (the backward kernel's
algorithm), its norm gradient ``rmsnorm_bwd_plain``.  Tolerances in
``tests/torch_train_parity.py``."""
import pytest

from torch_threads import one_torch_thread  # noqa: F401
from torch_train_parity import check_grads

CASES = [("qwen2-0.5b", True), ("qwen3-0.6b-toy", False),
         ("qwen3-30b-a3b-toy", False)]


@pytest.mark.parametrize("name,reduced", CASES)
def test_loss_and_every_grad_leaf_match_jax(name, reduced):
    out = check_grads(name, reduced=reduced)
    if name == "qwen3-30b-a3b-toy":
        assert out["aux_loss"] > 0


def test_grads_match_jax_with_remat():
    """remat on both sides (``jax.checkpoint`` per scan group, the port's
    ``torch.utils.checkpoint`` per repeat group)."""
    check_grads("qwen2-0.5b", reduced=True, remat=True, seed=1)
