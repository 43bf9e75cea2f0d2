"""Rotation fold/unfold for the four blind-spot branches (port of
``ssdn_tpu/ops/rotation.py``).

The four 90-degree rotations are folded into the batch dimension — one
(4B, C, H, W) tensor through one conv stack — so weight sharing holds by
construction. Tensors are NCHW; rotations act on the (H, W) plane, dims
(2, 3), with the same direction as the JAX package's NHWC axes (1, 2).

Layout: ``rotation_fold`` writes the branch batch into one buffer of the
memory format it is given (``trunk_memory_format``: channels_last for the
bf16 trunk, contiguous NCHW for fp32), and ``rotation_unfold`` derotates
the trunk's output into the head's operands, with a backward that writes
each branch's gradient rotated back into one buffer of the trunk's own
layout. Both only move data. The unfold moves each pixel once in each
direction, by an index; the fold, which reads the network's few input
channels, rotates through ``torch.rot90``. The JAX functions' forms,
``rotation_stack`` / ``rotation_unstack``, are built on them.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from ssdn_tpu_torch.numerics import layout_of


def rot90(x: torch.Tensor, k: int) -> torch.Tensor:
    """Rotate NCHW images counter-clockwise by k*90 degrees in (H, W)."""
    k %= 4
    if k == 0:
        return x
    return torch.rot90(x, k, dims=(2, 3))


def trunk_memory_format(dtype: torch.dtype) -> torch.memory_format:
    """The trunk's layout for a compute dtype: channels_last (NHWC-dense)
    for bf16, whose cuDNN tensor-core engines compute in NHWC; contiguous
    NCHW for fp32, whose FFT and ``wgrad_alg0`` algorithms run on NCHW."""
    if dtype == torch.float32:
        return torch.contiguous_format
    return torch.channels_last


class _Fold(torch.autograd.Function):
    """x -> the rotations ``ks`` of x stacked branch-major in one buffer;
    the backward sums the slices rotated back."""

    @staticmethod
    def forward(ctx, x, ks, dtype, memory_format):
        b = x.shape[0]
        shape = rot90(x, ks[0]).shape
        out = torch.empty((len(ks) * b, *shape[1:]), dtype=dtype,
                          device=x.device, memory_format=memory_format)
        for i, k in enumerate(ks):
            out[i * b:(i + 1) * b].copy_(rot90(x, k))
        ctx.ks, ctx.x_dtype = ks, x.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        b = g.shape[0] // len(ctx.ks)
        dx = None
        for i, k in enumerate(ctx.ks):
            d = rot90(g[i * b:(i + 1) * b], -k).to(ctx.x_dtype)
            dx = d if dx is None else dx + d
        return dx, None, None, None


def rotation_fold(x: torch.Tensor, ks: Sequence[int], *,
                  dtype: torch.dtype | None = None,
                  memory_format: torch.memory_format = torch.contiguous_format
                  ) -> torch.Tensor:
    """(B, C, H, W) -> (len(ks) * B, C, H', W'): branch i holds x rotated
    by ks[i] * 90 deg CCW (every k must give the same (H', W')), cast to
    ``dtype`` (default x's) and written once into one buffer of
    ``memory_format`` — ``torch.cat`` of the rotated views would return a
    contiguous tensor whatever the input's layout."""
    return _Fold.apply(x, tuple(ks), dtype or x.dtype, memory_format)


@functools.lru_cache(maxsize=8)  # a full-HD index is 17 MB
def _rotation_index(h: int, w: int, k: int,
                    device: torch.device) -> torch.Tensor:
    """The gather index of a rotation in pixel order: for x of (..., h, w),
    ``rot90(x, k)`` flattened over its (H, W) is x flattened over (h, w)
    at these positions."""
    idx = torch.arange(h * w, device=device).view(1, 1, h, w)
    return rot90(idx, k).reshape(-1)


def _pixels(t: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H*W, C); a view where t is dense over (H, W),
    as a batch or channel slice of an NCHW or channels_last buffer is."""
    n, c, h, w = t.shape
    return t.permute(0, 2, 3, 1).reshape(n, h * w, c)


class _Unfold(torch.autograd.Function):
    """Trunk outputs -> the derotated branches, as per-branch NHWC rows or
    one channel concat; the backward writes every branch's gradient
    rotated back into one buffer per trunk output, in that output's
    layout (no zero-filled buffers per slice, no sums of them). A rotation
    moves whole pixels (C values each) by an index in one pass:
    ``torch.rot90`` would flip into a copy first."""

    @staticmethod
    def forward(ctx, groups, rows, *ys):
        b, c, h, w = ys[0].shape  # ys[0] holds branch 0, unrotated
        b //= len(groups[0])
        order = sorted(k for ks in groups for k in ks)
        src = {k: y[j * b:(j + 1) * b]
               for y, ks in zip(ys, groups) for j, k in enumerate(ks)}
        ctx.groups, ctx.rows, ctx.order = groups, rows, order
        ctx.like = [(y.shape, y.dtype, y.device, layout_of(y))
                    for y in ys]
        dev = ys[0].device
        if rows:
            # fresh (M, C) rows for every branch, branch 0 too: a view of
            # the trunk output would keep all of it alive until the head's
            # backward
            return tuple(
                (_pixels(src[k]).clone(memory_format=torch.contiguous_format)
                 if k == 0 else
                 _pixels(src[k]).index_select(
                     1, _rotation_index(*src[k].shape[2:], -k, dev))
                 ).view(-1, c) for k in order)
        out = torch.empty((b, c * len(order), h, w), dtype=ys[0].dtype,
                          device=dev, memory_format=layout_of(ys[0]))
        for i, k in enumerate(order):
            dst = _pixels(out[:, i * c:(i + 1) * c])
            if k == 0:
                dst.copy_(_pixels(src[k]))
            else:  # dst rotated by k is src: scatter src's pixels
                dst.index_copy_(1, _rotation_index(h, w, k, dev),
                                _pixels(src[k]))
        return out

    @staticmethod
    def backward(ctx, *gs):
        order = ctx.order
        dys = []
        for ks, (shape, dtype, device, fmt) in zip(ctx.groups, ctx.like):
            dy = torch.empty(shape, dtype=dtype, device=device,
                             memory_format=fmt)
            b = shape[0] // len(ks)
            c = shape[1]
            for j, k in enumerate(ks):
                dst = _pixels(dy[j * b:(j + 1) * b])
                i = order.index(k)
                if ctx.rows:
                    g = gs[i].reshape(b, -1, c)
                else:
                    g = _pixels(gs[0][:, i * c:(i + 1) * c])
                if k == 0:
                    dst.copy_(g)
                else:  # the forward's gather, reversed
                    dst.index_copy_(1, _rotation_index(*shape[2:], -k,
                                                       device), g)
            dys.append(dy)
        return (None, None, *dys)


def rotation_unfold(ys: Sequence[torch.Tensor],
                    groups: Sequence[Sequence[int]], *, rows: bool = False):
    """The inverse of ``rotation_fold`` for the trunk's outputs:
    ``ys[i]`` holds the branches rotated by ``groups[i]`` (B rows each),
    and branch k is rotated back by -k * 90 deg. ``rows=True`` returns the
    branches in order of k as (B * H * W, C) rows in NHWC order (the fused
    head's operands); otherwise one (B, C * n_branches, H, W) channel
    concat in ys[0]'s layout. The backward gives each ``ys[i]`` one
    gradient in its own layout. One unrotated branch (``groups`` [(0,)])
    moves nothing: it is returned as it is, or as a view of rows where
    its layout is NHWC-dense."""
    groups = tuple(tuple(ks) for ks in groups)
    if groups == ((0,),):
        y = ys[0]
        if not rows:
            return y
        return [y.permute(0, 2, 3, 1).reshape(-1, y.shape[1]).contiguous()]
    out = _Unfold.apply(groups, rows, *ys)
    return list(out) if rows else out


def rotation_stack(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (4B, C, H, W): branch-major stack of the 4
    rotations (branch k holds the input rotated by k*90 deg CCW);
    requires H == W."""
    if x.shape[2] != x.shape[3]:
        raise ValueError(
            f"rotation_stack requires square inputs, got {x.shape[2]}x{x.shape[3]}"
        )
    return rotation_fold(x, range(4))


def rotation_unstack(y: torch.Tensor) -> torch.Tensor:
    """(4B, C, H, W) -> (B, 4C, H, W): inverse-rotate each branch back to
    the input frame and concatenate along channels (SURVEY.md §2.4)."""
    if y.shape[0] % 4:
        raise ValueError(f"leading dim {y.shape[0]} not divisible by 4")
    return rotation_unfold([y], [range(4)])
