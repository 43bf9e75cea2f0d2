"""Hand-written CUDA kernels (ports of the JAX package's Pallas kernels).

K1 ``shifted_conv.shifted_conv3x3_bias_act`` and K2 ``nin_head.fused_nin_head``.
Each wrapper launches its kernel on CUDA tensors (building it on first use
through ``_build``) or raises, and computes its plain PyTorch twin
``torch_reference`` on CPU tensors. Importing this package builds nothing.
"""
