"""Hand-written CUDA kernels (ports of the JAX package's Pallas kernels).

K1 ``shifted_conv.shifted_conv3x3_bias_act``; K2 ``nin_head.fused_nin_head``
(inference) and ``nin_head.nin_head_fwd`` (training, saves h1); K3
``nin_head.nin_head_bwd``; and one with no TPU counterpart, the bf16 trunk
conv's epilogue ``conv_epilogue.epilogue_fwd`` / ``epilogue_bwd``. Each
wrapper launches its kernel on CUDA tensors (building it on first use
through ``_build``) or raises, and computes its plain PyTorch twin on CPU
tensors. The differentiable entry points are
``shifted_conv.fused_shifted_conv`` and ``nin_head.nin_head`` (autograd
Functions with the JAX package's custom backwards) and
``conv_epilogue.conv_bias_act`` / ``bias_act``. Importing this package
builds nothing.
"""

import torch


def refuse_graph_cut(kernel: str, *tensors: torch.Tensor) -> None:
    """A kernel launch returns a fresh tensor with no ``grad_fn``: called
    where autograd is recording, it would silently give no gradient to
    anything below it. Raise instead; training goes through the kernel's
    ``autograd.Function``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad and grad mode is on, but a "
            "kernel launch is not recorded by autograd; call the "
            "differentiable entry point (fused_shifted_conv / nin_head / "
            "conv_bias_act / bias_act)"
        )
