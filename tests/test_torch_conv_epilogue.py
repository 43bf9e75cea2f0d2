"""The bf16 trunk conv's epilogue (``kernels.conv_epilogue``) on the CPU,
where its wrappers compute their plain twins. No JAX here.

- The twins against the torch ops the trunk runs without them (the bias
  add, dec1b's row mask, ``ops.leaky_relu`` and autograd's backward of
  them), on the same conv output: the same bits (``torch.equal``).
- The differentiable entry points (the folded conv: cuDNN's symmetric
  padding, then rows [0, H); the decoder's bias + activation) against
  ``ops.shifted.conv2d`` / ``shifted_upsample_concat_conv`` as the CPU runs
  them: bf16 bits where every sum is exact (small whole numbers), float64
  to 1e-12 (the two convs sum in different orders).
- The model with the epilogue taken wherever its input allows, against the
  model as the CPU runs it: which convs take it, and the same result.
"""

import pytest
import torch
import torch.nn.functional as F

from ssdn_tpu_torch.kernels import conv_epilogue as E
from ssdn_tpu_torch.models import blindspot_unet as bu
from ssdn_tpu_torch.ops import shifted as S

CL = torch.channels_last
BF16 = torch.bfloat16
SLOPE = 0.1
# (shifted, down_shift, negative_slope): the trunk's convs that end in
# LeakyReLU (enc0, enc6, dec5b..dec2b), dec1b under the torch-ops head
# and under the fused head (pre-activation), the plain U-Net's convs
VARIANTS = {"shifted": (True, 0, SLOPE), "dec1b": (True, 1, SLOPE),
            "dec1b_preact": (True, 1, None), "unshifted": (False, 0, SLOPE)}
# (n, h, w): a training patch, and a full-HD strip cut to a few rows
SHAPES = {"64x64": (1, 64, 64), "strip_1920": (1, 6, 1920)}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _ints(shape, lo, hi, seed, scale=1):
    """Small whole numbers (times ``scale``): every sum of their products
    is exact in fp32, so any summation order gives the same bits."""
    t = torch.randint(lo, hi + 1, shape, generator=_gen(seed)).float()
    return (t * scale).to(BF16)


def _cl(t):
    return t.contiguous(memory_format=CL)


@pytest.mark.parametrize("c", [3, 48, 96])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_twins_are_the_torch_ops_on_the_same_conv_output(variant, c):
    """Forward: out equal to the bias add, row mask and LeakyReLU on the
    conv output (rows [0, H - shift) of the folded conv, shifted down);
    backward: the conv output's gradient equal to autograd's through
    those ops (zeros in the rows no output reads). Values include -0, +0
    and ties of the compare."""
    shifted, shift, slope = VARIANTS[variant]
    n, h, w = 2, 10, 12
    hc = h + 2 if shifted else h
    c0 = torch.randn(n, c, hc, w, generator=_gen(c)).to(BF16)
    c0[0, :, 0, 0] = -0.0
    c0[0, :, 1, 1] = 0.0
    c0 = _cl(c0).requires_grad_(True)
    b = torch.randn(c, generator=_gen(c + 1)) * 0.5
    b[0] = 0.0
    g = _cl(torch.randn(n, c, h, w, generator=_gen(c + 2)).to(BF16))

    y = F.pad(c0[:, :, :h - shift], (0, 0, shift, 0)) + b.to(BF16).view(
        1, -1, 1, 1)
    if shift:
        row = torch.arange(h)
        y = y * (row >= shift).to(BF16).view(1, 1, -1, 1)
    if slope is not None:
        y = S.leaky_relu(y, slope)
    (dc,) = torch.autograd.grad(y, c0, g)

    out = E.epilogue_fwd(c0.detach(), b, h, shift, slope)
    dpre = E.epilogue_bwd(g, out, hc, shift, slope)
    assert out.is_contiguous(memory_format=CL)
    assert dpre.is_contiguous(memory_format=CL) and dpre.shape == c0.shape
    assert torch.equal(out, y)
    assert torch.equal(dpre, dc)
    assert not dpre[:, :, h - shift:].any()


def _fold_padding(shifted, kh, kw):
    return (kh - 1 if shifted else (kh - 1) // 2, (kw - 1) // 2)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("cin", [3, 48, 96])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_folded_conv_is_the_trunks_conv_in_bf16(variant, cin, shape):
    """``conv_bias_act`` (the conv with cuDNN's own padding, the epilogue
    twin, ``convolution_backward`` with the same padding) against
    ``ops.shifted.conv2d`` with the slope (``F.pad``, VALID conv, bias,
    mask, ``leaky_relu``): out, dx and dW bit for bit, db to the parity
    tolerance. Whole numbers keep every sum exact, so the two convs'
    summation orders cannot move a bit; g is a multiple of 10, so
    LeakyReLU's backward (g * 0.1, rounded) is whole too."""
    shifted, shift, slope = VARIANTS[variant]
    n, h, w = SHAPES[shape]
    cout = max(cin, 48)
    x0 = _cl(_ints((n, cin, h, w), -4, 4, seed=cin + h))
    w0 = _ints((cout, cin, 3, 3), -2, 2, seed=cin + 1).float()
    b0 = torch.randn(cout, generator=_gen(cin + 2)) * 0.5
    g = _cl(_ints((n, cout, h, w), -3, 3, seed=cin + 3, scale=10))

    def run(fn):
        x = x0.clone().requires_grad_(True)
        wt = w0.clone().requires_grad_(True)
        b = b0.clone().requires_grad_(True)
        out = fn(x, wt, b)
        return (out, *torch.autograd.grad(out, (x, wt, b), g))

    got = run(lambda x, wt, b: E.conv_bias_act(
        x, wt, b, padding=_fold_padding(shifted, 3, 3), shift=shift,
        negative_slope=slope))
    ref = run(lambda x, wt, b: S.conv2d(
        x, wt, b, shifted=shifted, down_shift=shift, negative_slope=slope))
    assert got[0].is_contiguous(memory_format=CL)
    assert got[1].shape == x0.shape and got[2].dtype == torch.float32
    for a, r in zip(got[:3], ref[:3]):
        assert a.dtype == r.dtype and torch.equal(a, r)
    torch.testing.assert_close(got[3], ref[3])


@pytest.mark.parametrize("variant,k", [(v, 3) for v in VARIANTS]
                         + [("unshifted", 1)])
def test_folded_conv_is_the_padded_conv_in_float64(variant, k):
    """The same sums in float64, where the two convs need not share bits:
    out, dx, dW and db to 1e-12 (the fold's crop and shift, and the
    cropped rows' zero gradient, are exact). 1x1: the torch-ops head's
    nin_a / nin_b, unshifted."""
    shifted, shift, slope = VARIANTS[variant]
    x0 = torch.randn(2, 5, 9, 7, generator=_gen(k), dtype=torch.float64)
    w0 = torch.randn(6, 5, k, k, generator=_gen(k + 1), dtype=torch.float64)
    b0 = torch.randn(6, generator=_gen(k + 2), dtype=torch.float64)
    g = torch.randn(2, 6, 9, 7, generator=_gen(k + 3), dtype=torch.float64)

    def run(fn):
        x, wt, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        out = fn(x, wt, b)
        return (out, *torch.autograd.grad(out, (x, wt, b), g))

    got = run(lambda x, wt, b: E.conv_bias_act(
        x, wt, b, padding=_fold_padding(shifted, k, k), shift=shift,
        negative_slope=slope))
    ref = run(lambda x, wt, b: S.conv2d(
        x, wt, b, shifted=shifted, down_shift=shift, negative_slope=slope))
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_decoder_bias_act_is_the_torch_ops_in_bf16(shape):
    """The fused decoder's up + skip sum through ``bias_act`` against
    ``leaky_relu(shifted_upsample_concat_conv(h, skip, w, b))``: the same
    sum, so out, dh, dskip and dW bit for bit, db to the parity
    tolerance."""
    n, hh, ww = SHAPES[shape]
    hh, ww = hh + hh % 2, ww
    h0 = _cl(torch.randn(n, 96, hh // 2, ww // 2, generator=_gen(1)).to(BF16))
    s0 = _cl(torch.randn(n, 48, hh, ww, generator=_gen(2)).to(BF16))
    w0 = torch.randn(96, 144, 3, 3, generator=_gen(3)) * 0.05
    b0 = torch.randn(96, generator=_gen(4)) * 0.5
    g = _cl(torch.randn(n, 96, hh, ww, generator=_gen(5)).to(BF16))

    def run(fn):
        hx, sk, wt, b = (t.clone().requires_grad_(True)
                         for t in (h0, s0, w0, b0))
        out = fn(hx, sk, wt, b)
        return (out, *torch.autograd.grad(out, (hx, sk, wt, b), g))

    got = run(lambda hx, sk, wt, b: E.bias_act(
        S.shifted_upsample_concat_conv(hx, sk, wt), b, SLOPE))
    ref = run(lambda hx, sk, wt, b: S.leaky_relu(
        S.shifted_upsample_concat_conv(hx, sk, wt, b), SLOPE))
    assert got[0].is_contiguous(memory_format=CL)
    for a, r in zip(got[:4], ref[:4]):
        assert a.dtype == r.dtype and torch.equal(a, r)
    torch.testing.assert_close(got[4], ref[4])


def _slope_and_after(op, args):
    """(op(*args, negative_slope), leaky_relu(op(*args))), each with the
    gradients of every argument for one output gradient."""
    runs = []
    for fused in (True, False):
        ts = [t.clone().requires_grad_(True) for t in args]
        out = (op(*ts, negative_slope=SLOPE) if fused
               else S.leaky_relu(op(*ts), SLOPE))
        g = torch.randn(out.shape, generator=_gen(9)).to(out)
        runs.append((out, *torch.autograd.grad(out, ts, g)))
    return runs


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_slope_argument_is_leaky_relu_after_the_op(dtype):
    """Without a card the slope keeps the ops' results: conv2d and the
    decoder op with ``negative_slope`` are ``leaky_relu`` of them without,
    in the output and the gradient of every operand."""
    x = torch.randn(2, 8, 8, 8, generator=_gen(0)).to(dtype)
    w = torch.randn(16, 8, 3, 3, generator=_gen(1)).to(dtype)
    b = torch.randn(16, generator=_gen(2)).to(dtype)
    for kw in (dict(shifted=True), dict(shifted=True, down_shift=1), {}):
        got, ref = _slope_and_after(
            lambda *a, **o: S.conv2d(*a, **kw, **o), (x, w, b))
        assert all(torch.equal(a, r) for a, r in zip(got, ref))
    skip = torch.randn(2, 4, 16, 16, generator=_gen(3)).to(dtype)
    wd = torch.randn(16, 12, 3, 3, generator=_gen(4)).to(dtype)
    got, ref = _slope_and_after(S.shifted_upsample_concat_conv,
                                (x, skip, wd, b))
    assert all(torch.equal(a, r) for a, r in zip(got, ref))


def test_kernel_wrappers_take_only_bf16_channels_last_cuda():
    """``takes`` is false for every CPU tensor: the CPU runs the torch ops
    (the model's bits there do not move)."""
    for t in (torch.zeros(1, 8, 4, 4, dtype=BF16).contiguous(memory_format=CL),
              torch.zeros(1, 8, 4, 4)):
        assert not E.takes(t, 48)


def test_misaligned_gradient_view_is_copied_for_the_kernel():
    """The backward hands the kernel gradients on a 16-byte boundary: a
    channels_last view that starts one element into its allocation is
    copied, an aligned one is passed on as it is."""
    ref = torch.zeros(2, 16, 4, 6, dtype=BF16).contiguous(memory_format=CL)
    buf = torch.randn(ref.numel() + 1, generator=_gen(0)).to(BF16)
    off = buf[1:].view(2, 4, 6, 16).permute(0, 3, 1, 2)
    assert off.is_contiguous(memory_format=CL) and off.data_ptr() % 16
    got = E._like(off, ref)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, off)
    assert got.is_contiguous(memory_format=CL)
    assert E._like(ref, ref) is ref


def test_kernels_import_nothing_of_ops():
    """The dependency runs one way, ops -> kernels: the kernel modules and
    what they share with ops (``numerics``) import nothing of ``ops``."""
    import os
    import subprocess
    import sys

    code = ("import sys\n"
            "import ssdn_tpu_torch.kernels.conv_epilogue\n"
            "import ssdn_tpu_torch.kernels.shifted_conv\n"
            "import ssdn_tpu_torch.kernels.nin_head\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.startswith('ssdn_tpu_torch.ops')))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=root).stdout
    assert out.strip() == "[]"


# trunk convs that take the epilogue: enc0, enc6, dec5b..dec1b, dec5a..dec1a
EPILOGUE_CONVS = 2 + 5 + 5


@pytest.fixture
def epilogue_everywhere(monkeypatch):
    """The epilogue taken for every bf16 channels_last tensor (its twins on
    the CPU), its forward and backward calls counted."""
    calls = {"fwd": 0, "bwd": 0}

    def counted(fn, key):
        def call(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(E, "takes", lambda t, c: t.dtype == BF16 and c % 8 == 0
                        and t.is_contiguous(memory_format=CL))
    monkeypatch.setattr(E, "epilogue_fwd", counted(E.epilogue_fwd, "fwd"))
    monkeypatch.setattr(E, "epilogue_bwd", counted(E.epilogue_bwd, "bwd"))
    return calls


def _model_run(head, shape):
    params = bu.init_params(_gen(2), 3, 9, enc=8, dec=16, nin_a=32, nin_b=16)
    for i, leaf in enumerate(params.values()):
        for key in leaf:
            leaf[key] = (leaf[key] + 0.05 * torch.randn(
                leaf[key].shape, generator=_gen(10 + i))).requires_grad_(True)
    leaves = [t for leaf in params.values() for t in leaf.values()]
    x = torch.randn(shape, generator=_gen(3))
    out = bu.apply(params, x, compute_dtype=BF16, head_backend=head)
    return out, torch.autograd.grad(out.square().sum(), leaves)


@pytest.mark.parametrize("head,shape,calls", [
    ("pallas", (2, 64, 64, 3), EPILOGUE_CONVS),
    ("lax", (2, 64, 64, 3), EPILOGUE_CONVS + 2),   # + nin_a, nin_b
    ("pallas", (1, 32, 64, 3), 2 * EPILOGUE_CONVS),  # two trunk calls
], ids=["fused_head", "torch_ops_head", "non_square"])
def test_model_takes_the_epilogue_at_the_covered_convs(epilogue_everywhere,
                                                       head, shape, calls):
    """Where the epilogue runs, the model takes it at enc0, enc6, dec5a..
    dec1a and dec5b..dec1b (and the torch-ops head's nin_a / nin_b), once
    forward and once backward each, and gives the result and gradients of
    the torch ops (bf16: the folded conv sums in another order)."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(E, "takes", lambda t, c: False)
        ref, ref_grads = _model_run(head, shape)
    got, grads = _model_run(head, shape)
    assert epilogue_everywhere == {"fwd": calls, "bwd": calls}
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)
    for a, r in zip(grads, ref_grads):
        torch.testing.assert_close(a, r, rtol=2e-2,
                                   atol=2e-2 * float(r.abs().max()) + 1e-6)
