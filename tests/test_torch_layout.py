"""The trunk's memory layout, on the CPU: the bf16 trunk hands every
convolution channels_last (NHWC-dense) operands, forward and backward, and
the fp32 trunk NCHW-contiguous ones (``utils.debug.conv_layouts``). The
rotation fold / unfold and the pixel shuffle that keep the layout only
move data: bit-equal to the ``torch.rot90`` / ``torch.cat`` /
``permute().contiguous()`` / ``F.pixel_shuffle`` compositions, in values
and gradients. No JAX here."""

import pytest
import torch
import torch.nn.functional as F

from ssdn_tpu_torch.config import ModelConfig, TrainConfig, parse_noise_style
from ssdn_tpu_torch.models import blindspot_unet as bu
from ssdn_tpu_torch.ops import rotation_fold, rotation_unfold
from ssdn_tpu_torch.ops.shifted import pixel_shuffle
from ssdn_tpu_torch.train.step import init_state, make_train_step
from ssdn_tpu_torch.utils import debug

CL = torch.channels_last
NCHW = torch.contiguous_format
TINY = dict(enc_features=8, dec_features=16, nin_a_features=32,
            nin_b_features=16)
# trunk convs: enc0..enc6, two per fused decoder "a" layer, dec{5..1}b
TRUNK_CONVS = 7 + 2 * 5 + 5


def _step_census(dtype: str, head: str, batch: int = 2, size: int = 64):
    """Census of one training step's forward (noise, model, loss) and
    backward (``autograd.grad`` over the params)."""
    cfg = TrainConfig(noise=parse_noise_style("gauss25"),
                      model=ModelConfig(in_channels=3, compute_dtype=dtype,
                                        head_backend=head, **TINY),
                      patch_size=size, batch_size=batch, seed=5)
    step = make_train_step(cfg, device="cpu")
    state = init_state(cfg, device="cpu")
    batch_u8 = torch.randint(0, 256, (batch, size, size, 3),
                             generator=torch.Generator().manual_seed(1),
                             dtype=torch.uint8).numpy()
    x, y, noise_params, _ = step.noisy_batch(batch_u8, 0)
    with debug.conv_layouts() as n:
        step.loss_and_grads(state.params, x, y, noise_params)
    return n


def _only(n, layout, calls):
    want = {k: 0 for k in debug.LAYOUTS}
    want[layout] = calls
    assert n == {"convolution": want, "convolution_backward": want}


@pytest.mark.parametrize("dtype,head,layout,calls", [
    ("bfloat16", "pallas", "channels_last", TRUNK_CONVS),
    ("bfloat16", "lax", "channels_last", TRUNK_CONVS + 2),  # + nin_a, nin_b
    ("float32", "pallas", "nchw", TRUNK_CONVS),
    ("float32", "lax", "nchw", TRUNK_CONVS + 2),
])
def test_training_step_convs_see_the_dtype_layout(dtype, head, layout, calls):
    """bf16: every conv and conv backward of the square step gets
    channels_last activations and gradients (the fused head's CPU path
    and the torch-ops head); fp32: NCHW-contiguous, as before."""
    _only(_step_census(dtype, head), layout, calls)


@pytest.mark.parametrize("head,calls", [("pallas", 2 * TRUNK_CONVS),
                                        ("lax", 2 * TRUNK_CONVS + 2)])
def test_non_square_bf16_convs_see_channels_last(head, calls):
    """Non-square input (two trunk calls: rot0/180 and rot90/270): every
    conv, and every conv backward (dec1b's included), in channels_last."""
    params = bu.init_params(torch.Generator().manual_seed(2), 3, 9,
                            enc=8, dec=16, nin_a=32, nin_b=16)
    leaves = [t.requires_grad_(True) for leaf in params.values()
              for t in leaf.values()]
    x = torch.randn(1, 64, 96, 3, generator=torch.Generator().manual_seed(3))
    with debug.conv_layouts() as n:
        out = bu.apply(params, x, compute_dtype=torch.bfloat16,
                       head_backend=head)
        torch.autograd.grad(out.square().sum(), leaves)
    _only(n, "channels_last", calls)


def test_conv_layouts_classifies_each_call():
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    x = torch.randn(2, 3, 8, 8)
    with debug.conv_layouts() as n:
        F.conv2d(x, w)                                   # nchw
        F.conv2d(x.contiguous(memory_format=CL), w)      # channels_last
        F.conv2d(x[:, :, ::2], w)                        # strided
        y = F.conv2d(x.contiguous(memory_format=CL), w)
        y.backward(torch.ones(y.shape))  # gradient NCHW, input channels_last
    assert n["convolution"] == {"channels_last": 2, "nchw": 1, "strided": 1}
    assert n["convolution_backward"] == {"channels_last": 0, "nchw": 0,
                                         "strided": 1}
    with debug.conv_layouts() as n2:
        pass
    assert sum(n2["convolution"].values()) == 0


def _ints(*shape, seed):
    """Small whole numbers: every sum of them is exact in bf16 and fp32,
    so two orders of the same gradient sum give the same bits."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-8, 9, shape, generator=g).float()


def _bits_equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


GROUPS = {"square": [(0, 1, 2, 3)], "wide": [(0, 2), (1, 3)]}
SHAPES = {"square": (2, 3, 6, 6), "wide": (2, 3, 4, 6)}


@pytest.mark.parametrize("fmt", [CL, NCHW], ids=["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(GROUPS))
def test_fold_is_the_rotated_concat(case, dtype, fmt):
    x0 = _ints(*SHAPES[case], seed=1).permute(0, 2, 3, 1).contiguous()
    x0 = x0.permute(0, 3, 1, 2)  # the model's view of an NHWC input
    xa = x0.clone().requires_grad_(True)
    xb = x0.clone().requires_grad_(True)
    for ks in GROUPS[case]:
        got = rotation_fold(xa, ks, dtype=dtype, memory_format=fmt)
        ref = torch.cat([torch.rot90(xb, k, dims=(2, 3)) for k in ks]
                        ).to(dtype)
        assert got.is_contiguous(memory_format=fmt)
        _bits_equal(got, ref)
        g = _ints(*got.shape, seed=sum(ks) + 2).to(dtype)
        got.backward(g)
        ref.backward(g)
    _bits_equal(xa.grad, xb.grad)


@pytest.mark.parametrize("fmt", [CL, NCHW], ids=["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(GROUPS))
@pytest.mark.parametrize("rows", [True, False], ids=["rows", "concat"])
def test_unfold_is_the_derotated_pack(rows, case, dtype, fmt):
    """The unfold against the model's old composition (rot90 views of the
    trunk's slices, then the head's permute().contiguous() rows or the
    channel cat): the same values, and its backward the same gradient of
    the trunk output, in the trunk's layout."""
    b, c, h, w = SHAPES[case]
    groups = GROUPS[case]
    ys0 = [torch.randn(len(ks) * b, c, *((h, w) if i == 0 else (w, h)),
                       generator=torch.Generator().manual_seed(i)
                       ).to(dtype).contiguous(memory_format=fmt)
           for i, ks in enumerate(groups)]
    ya = [y.clone().requires_grad_(True) for y in ys0]
    yb = [y.clone().requires_grad_(True) for y in ys0]
    parts = {k: torch.rot90(y[j * b:(j + 1) * b], -k, dims=(2, 3))
             for y, ks in zip(yb, groups) for j, k in enumerate(ks)}
    parts = [parts[k] for k in sorted(parts)]
    got = rotation_unfold(ya, groups, rows=rows)
    if rows:
        ref = [p.permute(0, 2, 3, 1).reshape(-1, c).contiguous()
               for p in parts]
        assert len(got) == 4
        for t, r in zip(got, ref):
            assert t.is_contiguous()
            _bits_equal(t, r)
        # fresh rows, branch 0 too: the head keeps its operands for the
        # backward, and a view would keep the whole trunk output alive
        assert all(t.untyped_storage().data_ptr()
                   != ya[0].untyped_storage().data_ptr() for t in got)
        gs = [torch.randn(r.shape, generator=torch.Generator().manual_seed(
            9 + i)).to(dtype) for i, r in enumerate(ref)]
        torch.autograd.backward(got, gs)
        torch.autograd.backward(ref, gs)
    else:
        ref = torch.cat(parts, dim=1)
        assert got.is_contiguous(memory_format=fmt)
        _bits_equal(got, ref)
        g = torch.randn(ref.shape, generator=torch.Generator().manual_seed(
            9)).to(dtype)
        got.backward(g)
        ref.backward(g)
    for a, r in zip(ya, yb):
        assert a.grad.is_contiguous(memory_format=fmt)
        _bits_equal(a.grad, r.grad)


@pytest.mark.parametrize("fmt", [CL, NCHW], ids=["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pixel_shuffle_keeps_the_layout(dtype, fmt):
    x0 = torch.randn(2, 12, 3, 5, generator=torch.Generator().manual_seed(4)
                     ).to(dtype).contiguous(memory_format=fmt)
    xa = x0.clone().requires_grad_(True)
    xb = x0.clone().requires_grad_(True)
    got, ref = pixel_shuffle(xa, 2), F.pixel_shuffle(xb, 2)
    assert got.is_contiguous(memory_format=fmt)
    _bits_equal(got, ref)
    g = torch.randn(ref.shape, generator=torch.Generator().manual_seed(5)
                    ).to(dtype).contiguous(memory_format=fmt)
    got.backward(g)
    ref.backward(g)
    assert xa.grad.is_contiguous(memory_format=fmt)
    _bits_equal(xa.grad, xb.grad)
