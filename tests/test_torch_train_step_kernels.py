"""The port's training step in the two kernel arms against the JAX
package's, on the CPU: the head-kernel arm (``head_backend="pallas"``: the
``nin_head`` autograd Function, K2' forward and K3 backward twins) and the
conv-kernel arm (``conv_backend="pallas"``: ``fused_shifted_conv``, K1's
twin under the JAX package's custom backward). The JAX side runs its
Pallas kernels in interpret mode (K1 on its own off the TPU, the head
through ``nin_head.INTERPRET``).

Same inputs, weights and bars as ``test_torch_train_step.py``: the loss at
1e-5 relative, each leaf's gradient at 1e-4 of that leaf's max abs.
"""

import pytest

import ssdn_tpu.ops.pallas.nin_head as NH
from test_torch_train_step import PIPELINES, assert_loss_and_grads_match


@pytest.fixture(autouse=True)
def _nh_interpret():
    NH.INTERPRET = True
    yield
    NH.INTERPRET = False


@pytest.mark.parametrize("name", list(PIPELINES))
def test_loss_and_grads_match_jax_head_kernel_arm(name):
    assert_loss_and_grads_match(name, "head_pallas")


@pytest.mark.parametrize("name", list(PIPELINES))
def test_loss_and_grads_match_jax_conv_kernel_arm(name):
    assert_loss_and_grads_match(name, "conv_pallas")
