"""The blind-spot U-Net (reference ``NoiseNetwork`` [R]; SURVEY.md §2.4), in
PyTorch — port of ``ssdn_tpu/models/blindspot_unet.py``.

A weight-shared U-Net over four 90-degree-rotated inputs, every 3x3 conv
causal-upward (ops.conv2d shifted=True), offset max-pools, nearest
upsamples; after the shared trunk each branch is shifted down 1 px (the
blind spot), inverse-rotated, and the four are combined by three 1x1 convs
(nin_a 4*96 -> 384, nin_b 384 -> 96, nin_c 96 -> n_out, the last linear).
The four branches ride the batch dimension; the trunk runs in the compute
dtype (bf16 or fp32) and the head output is fp32.

Parameters are a plain dict ``{layer: {"w": OIHW tensor, "b": tensor}}``
(plus ``noise_scalar/raw`` for constant-blind models); ``params_from_jax``
and ``params_to_jax`` carry weights to and from the JAX package's HWIO tree
and the zoo artifacts. ``apply`` takes and returns NHWC, as the JAX
function does; inside, tensors are NCHW, and their memory layout follows
the compute dtype (``ops.trunk_memory_format``): a bf16 trunk runs in
channels_last (NHWC-dense) at every conv, forward and backward, as cuDNN's
tensor-core engines compute it; an fp32 trunk runs in contiguous NCHW, as
its FFT and ``wgrad_alg0`` algorithms do. The rotation fold writes the
branch batch in that layout, every op of the trunk keeps it, and the
unfold's backward hands it back (``ops.rotation``).

Backends keep the config's names: ``conv_backend`` / ``head_backend``
``"lax"`` runs torch ops (cuDNN / cuBLAS on the GPU), ``"pallas"`` the
hand-written CUDA kernels K1 (``kernels.shifted_conv``) and K2/K2'/K3
(``kernels.nin_head``), through their differentiable entry points, so
``apply`` is differentiable in every arm.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ssdn_tpu_torch.kernels.nin_head import nin_head
from ssdn_tpu_torch.kernels.shifted_conv import fused_shifted_conv
from ssdn_tpu_torch.ops import (
    conv2d,
    leaky_relu,
    rotation_fold,
    rotation_unfold,
    shift_down,
    shifted_maxpool_2x2,
    trunk_memory_format,
    upsample_2x_nearest,
)
from ssdn_tpu_torch.ops.shifted import (
    matmul_acc_f32,
    maxpool_2x2,
    shifted_upsample_concat_conv,
)
from ssdn_tpu_torch.utils.device import resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]

N_POOLS = 5
STRIDE = 2 ** N_POOLS  # spatial dims must be divisible by 32


def one_sided_causal_reach(alignment: int | None = None) -> int:
    """Exact worst-case one-sided reach (in pixels) of the shifted trunk,
    by forward interval propagation through the literal layer sequence of
    ``_branch`` (a copy of the JAX package's derivation: 315 px worst case
    over the STRIDE pool alignments; ``alignment`` selects one).

    Per-layer interval semantics (causal frame): shifted 3x3 conv
    ``[a, b+2]``; shifted 2x2 max-pool ``[ceil(a/2), ceil(b/2)]``; nearest
    2x upsample ``[2a, 2b+1]``; skip concat: union with the stored encoder
    interval; the final +1 px blind-spot shift ``[a+1, b+1]``.
    """
    conv = lambda iv: (iv[0], iv[1] + 2)
    spool = lambda iv: (-(-iv[0] // 2), -(-iv[1] // 2))
    up = lambda iv: (2 * iv[0], 2 * iv[1] + 1)

    def reach(start: int) -> int:
        iv = (start, start)
        skips = [iv]
        iv = spool(conv(conv(iv)))            # enc0, enc1, pool1
        skips.append(iv)
        for _ in range(2, N_POOLS):
            iv = spool(conv(iv))              # enc2..4 + pool2..4
            skips.append(iv)
        iv = conv(spool(conv(iv)))            # enc5 + pool5, enc6
        for skip in reversed(skips):          # dec5..dec1
            u = up(iv)
            iv = conv(conv((min(u[0], skip[0]), max(u[1], skip[1]))))
        return iv[1] + 1 - start              # final shift_down(1)

    if alignment is not None:
        return reach(STRIDE * 2 + alignment % STRIDE)
    return max(reach(STRIDE * 2 + s) for s in range(STRIDE))


def layer_shapes(in_channels: int, *, blindspot: bool = True,
                 n_out: int = 3, enc: int = 48, dec: int = 96,
                 nin_a: int = 384, nin_b: int = 96) -> Dict[str, tuple]:
    """(kh, kw, cin, cout) for every layer — the JAX package's table, so
    both sides agree on names and sizes."""
    c = in_channels
    shapes = {
        "enc0": (3, 3, c, enc),
        "enc1": (3, 3, enc, enc),
        "enc2": (3, 3, enc, enc),
        "enc3": (3, 3, enc, enc),
        "enc4": (3, 3, enc, enc),
        "enc5": (3, 3, enc, enc),
        "enc6": (3, 3, enc, enc),
        "dec5a": (3, 3, enc + enc, dec),
        "dec5b": (3, 3, dec, dec),
        "dec4a": (3, 3, dec + enc, dec),
        "dec4b": (3, 3, dec, dec),
        "dec3a": (3, 3, dec + enc, dec),
        "dec3b": (3, 3, dec, dec),
        "dec2a": (3, 3, dec + enc, dec),
        "dec2b": (3, 3, dec, dec),
        "dec1a": (3, 3, dec + c, dec),
        "dec1b": (3, 3, dec, dec),
    }
    combined = 4 * dec if blindspot else dec
    shapes["nin_a"] = (1, 1, combined, nin_a)
    shapes["nin_b"] = (1, 1, nin_a, nin_b)
    shapes["nin_c"] = (1, 1, nin_b, n_out)
    return shapes


def init_params(generator: torch.Generator, in_channels: int, n_out: int,
                *, blindspot: bool = True, enc: int = 48, dec: int = 96,
                nin_a: int = 384, nin_b: int = 96,
                dtype=torch.float32, device=None) -> Params:
    """He/Kaiming-normal weights (N2N convention, SURVEY.md §2.4), zero
    biases, drawn from ``generator`` (on the generator's device) and placed
    on ``device`` (default: the generator's). torch and jax.random draw
    different numbers from the same seed; parity tests carry one side's
    weights to the other with ``params_from_jax``."""
    shapes = layer_shapes(in_channels, blindspot=blindspot, n_out=n_out,
                          enc=enc, dec=dec, nin_a=nin_a, nin_b=nin_b)
    params = {}
    for name, (kh, kw, cin, cout) in shapes.items():
        std = math.sqrt(2.0 / (kh * kw * cin))
        w = torch.randn((cout, cin, kh, kw), generator=generator,
                        dtype=dtype, device=generator.device) * std
        params[name] = {
            "w": w.to(device or generator.device),
            "b": torch.zeros((cout,), dtype=dtype,
                             device=device or generator.device),
        }
    return params


def param_count(params: Params) -> int:
    return sum(int(x.numel()) for leaf in params.values() for x in leaf.values())


def params_from_jax(tree, *, device=None) -> Params:
    """The JAX package's params tree (``zoo.load``'s numpy arrays or
    ``np.asarray`` of JAX params: conv weights HWIO) -> the port's tensors
    (conv weights OIHW) on ``device`` (default cuda, see resolve_device).
    Leaves that are not 4-D conv weights (biases, ``noise_scalar/raw`` of
    constant-blind models) carry over as they are."""
    dev = resolve_device(device)
    out: Params = {}
    for name, leaf in tree.items():
        out[name] = {}
        for key, v in leaf.items():
            t = torch.from_numpy(np.array(v, copy=True))
            if key == "w" and t.dim() == 4:
                t = t.permute(3, 2, 0, 1).contiguous()
            out[name][key] = t.to(dev)
    return out


def params_to_jax(params: Params) -> Dict[str, Dict[str, np.ndarray]]:
    """Inverse of ``params_from_jax``: host numpy, conv weights HWIO."""
    out = {}
    for name, leaf in params.items():
        out[name] = {}
        for key, t in leaf.items():
            t = t.detach().cpu()
            if key == "w" and t.dim() == 4:
                t = t.permute(2, 3, 1, 0)
            out[name][key] = t.contiguous().numpy()
    return out


def _branch(params: Params, x: torch.Tensor, *, shifted: bool,
            compute_dtype: torch.dtype, conv_backend: str = "lax",
            conv_precision: str = "highest",
            decoder_mode: str = "fused",
            fold_shift_down: bool = False,
            emit_preact: bool = False) -> torch.Tensor:
    """The shared U-Net trunk on a (possibly rotation-folded) NCHW batch,
    which keeps x's memory layout at every conv (K1 takes channels_last
    whatever the dtype: its arm converts where x is NCHW).

    fold_shift_down=True (blind-spot torch-ops path) absorbs the final
    shift_down(out, 1) into dec1b's conv padding (conv2d down_shift).
    emit_preact=True skips dec1b's LeakyReLU (the fused head kernel
    absorbs it — elementwise, so it commutes with derotation).
    """
    pool = shifted_maxpool_2x2 if shifted else maxpool_2x2
    use_pallas = conv_backend == "pallas" and shifted
    # the phase-decomposed decoder is derived for the shifted geometry;
    # the plain-U-Net baselines keep the literal path
    fuse_dec = decoder_mode == "fused" and shifted

    def conv(name, h, down_shift=0):
        p = params[name]
        if use_pallas:
            # the kernel writes its input dtype: cast to the compute dtype
            h = h.to(compute_dtype).contiguous(memory_format=torch.channels_last)
            return fused_shifted_conv(h, p["w"], p["b"], negative_slope=0.1)
        return conv2d(h, p["w"], p["b"], shifted=shifted,
                      down_shift=down_shift, negative_slope=0.1,
                      out_dtype=compute_dtype, precision=conv_precision)

    def conv_pool(name, h):
        """pool(lrelu(conv)) computed as lrelu(pool(conv)): LeakyReLU is
        strictly monotone, so it commutes with the window max exactly and
        runs on the 4x-smaller pooled tensor. The kernel path keeps the
        literal order (its kernel fuses the activation)."""
        if use_pallas:
            return pool(conv(name, h))
        p = params[name]
        pre = conv2d(h, p["w"], p["b"], shifted=shifted,
                     out_dtype=compute_dtype, precision=conv_precision)
        return leaky_relu(pool(pre))

    x = x.to(compute_dtype)
    skips = [x]
    h = conv_pool("enc1", conv("enc0", x))   # pool1
    skips.append(h)
    for i in (2, 3, 4):
        h = conv_pool(f"enc{i}", h)          # pool2..4
        skips.append(h)
    h = conv_pool("enc5", h)                 # pool5
    h = conv("enc6", h)
    # skips = [input, pool1, pool2, pool3, pool4]; decode coarse -> fine
    for stage, skip in zip((5, 4, 3, 2, 1), reversed(skips)):
        if fuse_dec:
            p = params[f"dec{stage}a"]
            h = shifted_upsample_concat_conv(
                h, skip.to(compute_dtype), p["w"], p["b"],
                negative_slope=0.1, out_dtype=compute_dtype,
                precision=conv_precision,
            )
        else:
            h = upsample_2x_nearest(h)
            h = torch.cat([h, skip.to(compute_dtype)], dim=1)
            h = conv(f"dec{stage}a", h)
        ds = 1 if (fold_shift_down and stage == 1 and not use_pallas) else 0
        if stage == 1 and emit_preact and not use_pallas:
            p = params["dec1b"]
            h = conv2d(h, p["w"], p["b"], shifted=shifted, down_shift=ds,
                       out_dtype=compute_dtype, precision=conv_precision)
        else:
            h = conv(f"dec{stage}b", h, down_shift=ds)
    return h


def _matrix(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """1x1 conv weight (Cout, Cin, 1, 1) -> contiguous (Cin, Cout) matrix."""
    return w[:, :, 0, 0].t().to(dtype).contiguous()


def apply(params: Params, x: torch.Tensor, *, blindspot: bool = True,
          compute_dtype: torch.dtype = torch.bfloat16,
          conv_backend: str = "lax", conv_precision: str = "highest",
          decoder_mode: str = "fused",
          head_backend: str = "lax") -> torch.Tensor:
    """Forward pass: (B, H, W, C) -> (B, H, W, n_out) in fp32 (NHWC, as the
    JAX function). H, W % 32 == 0. Square inputs fold all four rotations
    into one 4x batch; non-square inputs use two 2x-batched trunk calls
    (rot0/180 and rot90/270) — identical math, no square padding needed."""
    b, h, w, _ = x.shape
    if h % STRIDE or w % STRIDE:
        raise ValueError(f"H, W must be multiples of {STRIDE}, got {h}x{w}")
    # the +1 px blind-spot shift rides dec1b's conv padding on the torch-ops
    # path (free); the kernel path keeps the explicit shift_down
    fold_shift = conv_backend != "pallas"
    # the head kernel absorbs dec1b's LeakyReLU (commutes with derotation):
    # the trunk emits pre-activations in that mode. It runs for every M
    # (the TPU kernel's M % 256 tiling rule has no counterpart here).
    use_fused_head = head_backend == "pallas" and conv_backend != "pallas"
    # the trunk's layout follows the compute dtype: channels_last for bf16
    # (cuDNN computes it in NHWC), NCHW for fp32; every op of the trunk
    # keeps the layout it is given
    fmt = trunk_memory_format(compute_dtype)
    xc = x.permute(0, 3, 1, 2)  # NCHW view; channels_last if x is NHWC-dense

    def trunk(g):
        f = _branch(params, g, shifted=True, compute_dtype=compute_dtype,
                    conv_backend=conv_backend, conv_precision=conv_precision,
                    decoder_mode=decoder_mode, fold_shift_down=fold_shift,
                    emit_preact=use_fused_head)
        # The JAX package puts an optimization_barrier here on its kernel
        # path, against an XLA/Mosaic miscompile of the section downstream
        # of the TPU kernels. Eager PyTorch does not fuse across the
        # kernel boundary, so there is nothing to pin.
        return f if fold_shift else shift_down(f, 1)

    if blindspot:
        # square: all four rotations ride one 4x batch; non-square:
        # rot0/rot180 share (H, W), rot90/rot270 share (W, H) — two batched
        # trunk calls, same shared weights. Each group is written once into
        # one buffer of the trunk's layout.
        groups = [(0, 1, 2, 3)] if h == w else [(0, 2), (1, 3)]
        ys = [trunk(rotation_fold(xc, ks, dtype=compute_dtype,
                                  memory_format=fmt)) for ks in groups]
    else:
        groups = [(0,)]
        ys = [_branch(params, xc.to(compute_dtype, memory_format=fmt),
                      shifted=False, compute_dtype=compute_dtype,
                      conv_backend=conv_backend,
                      conv_precision=conv_precision,
                      decoder_mode=decoder_mode, emit_preact=use_fused_head)]
    if use_fused_head:
        # the derotated branches as (B*H*W, C) rows, one per branch (the
        # head kernel never builds the concat); they are dec1b
        # PRE-activations (emit_preact): the kernel applies their LeakyReLU
        xs = rotation_unfold(ys, groups, rows=True)
        wa = _matrix(params["nin_a"]["w"], compute_dtype)
        offs = np.cumsum([0] + [t.shape[1] for t in xs])
        was = [wa[o:e] for o, e in zip(offs[:-1], offs[1:])]
        out = nin_head(
            xs, was,
            params["nin_a"]["b"].float(),
            _matrix(params["nin_b"]["w"], compute_dtype),
            params["nin_b"]["b"].float(),
            _matrix(params["nin_c"]["w"], compute_dtype),
            params["nin_c"]["b"].float(),
        )
        return out.reshape(b, h, w, -1)
    # torch-ops head: nin_a/nin_b in the compute dtype; nin_c accumulates in
    # fp32 (matmul_acc_f32) so mu/Sigma leave the network as fp32
    f = rotation_unfold(ys, groups)
    f = conv2d(f, params["nin_a"]["w"], params["nin_a"]["b"],
               negative_slope=0.1, out_dtype=compute_dtype,
               precision=conv_precision)
    f = conv2d(f, params["nin_b"]["w"], params["nin_b"]["b"],
               negative_slope=0.1, out_dtype=compute_dtype,
               precision=conv_precision)
    p = params["nin_c"]
    # the fp32 matrix: matmul_acc_f32 casts it to the compute dtype and
    # returns its grad in fp32, as the JAX custom VJP does
    out = matmul_acc_f32(f.permute(0, 2, 3, 1), _matrix(p["w"], p["w"].dtype))
    return out + p["b"].float()
