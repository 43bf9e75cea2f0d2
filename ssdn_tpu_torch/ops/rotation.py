"""Rotation fold/unfold for the four blind-spot branches (port of
``ssdn_tpu/ops/rotation.py``).

The four 90-degree rotations are folded into the batch dimension — one
(4B, C, H, W) tensor through one conv stack — so weight sharing holds by
construction. Tensors are NCHW; rotations act on the (H, W) plane, dims
(2, 3), with the same direction as the JAX package's NHWC axes (1, 2).
"""

from __future__ import annotations

import torch


def rot90(x: torch.Tensor, k: int) -> torch.Tensor:
    """Rotate NCHW images counter-clockwise by k*90 degrees in (H, W)."""
    k %= 4
    if k == 0:
        return x
    return torch.rot90(x, k, dims=(2, 3))


def rotation_stack(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (4B, C, H, W): branch-major stack of the 4
    rotations (branch k holds the input rotated by k*90 deg CCW); requires
    H == W."""
    if x.shape[2] != x.shape[3]:
        raise ValueError(
            f"rotation_stack requires square inputs, got {x.shape[2]}x{x.shape[3]}"
        )
    return torch.cat([rot90(x, k) for k in range(4)], dim=0)


def rotation_unstack(y: torch.Tensor) -> torch.Tensor:
    """(4B, C, H, W) -> (B, 4C, H, W): inverse-rotate each branch back to
    the input frame and concatenate along channels (SURVEY.md §2.4)."""
    b4 = y.shape[0]
    if b4 % 4:
        raise ValueError(f"leading dim {b4} not divisible by 4")
    b = b4 // 4
    branches = [rot90(y[k * b : (k + 1) * b], -k) for k in range(4)]
    return torch.cat(branches, dim=1)
