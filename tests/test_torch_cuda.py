"""The port's CUDA kernels on the card, against their plain PyTorch twins.

Every test here needs an NVIDIA GPU (``sm_90a``) and the CUDA toolkit: it
carries the ``cuda`` marker and skips without a card. The file imports no
JAX, so it runs on a GPU machine that has none:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

TF32 is off for every comparison, so fp32 means true fp32 on both sides.
"""

import numpy as np
import pytest
import torch

from ssdn_tpu_torch.kernels import nin_head as K2
from ssdn_tpu_torch.kernels import shifted_conv as K1
from ssdn_tpu_torch.models import blindspot_unet as bu

pytestmark = pytest.mark.cuda

# fp32: both sides accumulate in fp32 and differ only in summation order
TOL32 = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


def _k1_operands(seed, n, h, w, cin, cout, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, cin, h, w)).astype(np.float32))
    wt = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3)) * 0.2
                           ).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal(cout) * 0.1).astype(np.float32))
    x = x.to("cuda", dtype).contiguous(memory_format=torch.channels_last)
    return x, wt.cuda(), b.cuda()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,h,w", [(3, 48, 64, 96), (48, 48, 32, 32),
                                          (96, 96, 16, 24), (1, 48, 8, 40),
                                          (48, 96, 5, 7)])
def test_k1_cuda_matches_twin(cuda, dtype, cin, cout, h, w):
    x, wt, b = _k1_operands(cin + h, 2, h, w, cin, cout, dtype)
    before = K1.launches
    got = K1.shifted_conv3x3_bias_act(x, wt, b)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    assert got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    ref = K1.torch_reference(x, wt, b)
    # bf16: one rounding of an fp32 sum on each side, so a different
    # summation order moves a value by at most one bf16 ulp (2**-7 relative)
    tol = TOL32 if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-5)
    torch.testing.assert_close(got.float(), ref.float(), **tol)


def test_k1_cuda_raises_instead_of_falling_back(cuda):
    x, wt, b = _k1_operands(0, 1, 8, 8, 3, 48, torch.float32)
    before = K1.launches
    with pytest.raises(ValueError, match="channels_last"):
        K1.shifted_conv3x3_bias_act(x.contiguous(), wt, b)
    with pytest.raises(TypeError):
        K1.shifted_conv3x3_bias_act(x.half(), wt, b)
    assert K1.launches == before


# The 12 K1 layers of a batch-384 training step (four rotations folded into
# batch 1536, 64x64 patches: enc0-enc6, dec5b-dec1b), and layers of a
# 768x512 request's trunk calls (batch 2): enc0, enc1 and dec1b at full
# resolution, and dec4b, enc5 and enc6, whose widths (96, 48, 24) leave a
# tile partly filled; as (n, cin, h, w, cout)
K1_TRAIN_SHAPES = [(1536, 3, 64, 64, 48), (1536, 48, 64, 64, 48),
                   (1536, 48, 32, 32, 48), (1536, 48, 16, 16, 48),
                   (1536, 48, 8, 8, 48), (1536, 48, 4, 4, 48),
                   (1536, 48, 2, 2, 48), (1536, 96, 4, 4, 96),
                   (1536, 96, 8, 8, 96), (1536, 96, 16, 16, 96),
                   (1536, 96, 32, 32, 96), (1536, 96, 64, 64, 96)]
K1_REQUEST_SHAPES = [(2, 3, 512, 768, 48), (2, 48, 768, 512, 48),
                     (2, 96, 512, 768, 96), (2, 96, 64, 96, 96),
                     (2, 48, 32, 48, 48), (2, 48, 16, 24, 48)]
# shapes the model's defaults do not reach on the fused decoder: the gray
# models' Cin 1, the naive decoder's dec*a (Cin 144, 99, 97), narrow
# widths, W of 2, 4 and 7, and BSD68's 481x321 padded to 512x352 (both
# orientations)
K1_ODD_SHAPES = [(2, 1, 64, 96, 48), (2, 144, 32, 48, 96), (2, 99, 64, 64, 96),
                 (2, 97, 16, 16, 96), (3, 3, 6, 2, 48), (2, 48, 4, 4, 96),
                 (2, 96, 7, 7, 48), (2, 48, 5, 7, 96), (1, 8, 9, 7, 16),
                 (2, 5, 3, 4, 100), (2, 3, 352, 512, 48),
                 (2, 96, 512, 352, 96), (2, 48, 11, 8, 48), (1, 96, 1, 1, 96)]


def _k1_bf16_matches_twin(shape, seed):
    """The bar is chip_smoke's (``k1_error``): within 2 bf16 ulps of the
    twin's value, with 1e-5 of the output's range as the floor near zero.
    Each side rounds one fp32 sum of 9*Cin products once, and the two sums
    differ only in order; at the model's sizes (hundreds of millions of
    outputs) some sum cancels to near zero, where two fp32 orders differ
    by about 1e-5 absolute, so a fixed 1e-5 floor would not hold there for
    any summation order."""
    n, cin, h, w, cout = shape
    x, wt, b = _k1_operands(seed, n, h, w, cin, cout, torch.bfloat16)
    x[0, 0, 0, 0] = -0.0
    before = K1.launches
    got = K1.shifted_conv3x3_bias_act(x, wt, b)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (n, cout, h, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    ref = K1.torch_reference(x, wt, b).float()
    d = (got.float() - ref).abs()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2 ** -126))) - 7)
    bar = 2 * ulp + 1e-5 * ref.abs().max()
    assert (d <= bar).all(), (
        f"{int((d > bar).sum())} outputs off the bar, max |err| "
        f"{d.max().item():.3e}, range {ref.abs().max().item():.3e}")


@pytest.mark.parametrize("shape", K1_TRAIN_SHAPES + K1_REQUEST_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_bf16_matches_twin_at_the_model_shapes(cuda, shape):
    """bf16 K1 on the tensor cores at every training layer shape and at
    request layer shapes, against the twin at chip_smoke's bar."""
    _k1_bf16_matches_twin(shape, sum(shape))


@pytest.mark.parametrize("shape", K1_ODD_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_bf16_matches_twin_at_odd_shapes(cuda, shape):
    """bf16 K1 where Cin is not a multiple of 8 (scalar staging), Cin
    over one pass (144, 99, 97), Cout not 48 or 96, W narrower than a tile
    (tiles span images) or not a multiple of the tile width."""
    _k1_bf16_matches_twin(shape, 7 + sum(shape))


def test_k1_bf16_keeps_the_sign_of_a_negative_zero(cuda):
    """A negative pre-activation whose LeakyReLU rounds to zero in bf16
    gives -0.0, as in the twin: the backward takes its mask from
    signbit(out). Zero input, bias -1e-42: lrelu gives -1e-43, below
    bf16's least subnormal."""
    for cin, cout in ((96, 96), (3, 48)):
        x, wt, b = _k1_operands(1, 2, 8, 16, cin, cout, torch.bfloat16)
        x.zero_()
        b = torch.full_like(b, -1e-42)
        got = K1.shifted_conv3x3_bias_act(x, wt, b)
        ref = K1.torch_reference(x, wt, b)
        torch.cuda.synchronize()
        assert torch.signbit(ref).all() and (ref == 0).all()
        assert torch.equal(torch.signbit(got), torch.signbit(ref))
        assert (got == 0).all()


def test_k1_bf16_is_bitwise_repeatable(cuda):
    """At a dec1b-sized call (batch 1536, 64x64, 96 -> 96: 49,152 tiles)
    two launches give the same bits: no atomics, a fixed summation order."""
    x, wt, b = _k1_operands(5, 1536, 64, 64, 96, 96, torch.bfloat16)
    a = K1.shifted_conv3x3_bias_act(x, wt, b)
    c = K1.shifted_conv3x3_bias_act(x, wt, b)
    torch.cuda.synchronize()
    assert torch.equal(a, c)


# fp32 K1 where its plan stages the halo'd tile in passes over Cin (Cin
# 512; Cin 144 at W 1, a tile of one column)
K1_FP32_PASSES_SHAPES = [(2, 512, 16, 24, 96), (2, 512, 11, 7, 48),
                         (4, 144, 40, 1, 96)]


def _k1_fp32_matches_twin(shape, seed):
    """fp32 K1 on the FMA pipes against the twin (cuDNN with TF32 off).
    Both sides accumulate 9*Cin products in fp32 and differ only in
    summation order, and two orders differ in proportion to the products'
    magnitudes, not the sum's: where the products cancel, the difference
    outgrows ``TOL32`` taken against |ref| (at dec1b's 6 x 10^8 outputs,
    about 1 in 10^5 for any two orders, the first fp32 kernel's bits
    included). So the bar is ``TOL32`` with its relative part taken
    against sum |x w| + |b| at each output; a missing or misplaced product
    (about 0.1 here) is far above it."""
    n, cin, h, w, cout = shape
    x, wt, b = _k1_operands(seed, n, h, w, cin, cout, torch.float32)
    x[0, 0, 0, 0] = -0.0
    before = K1.launches
    got = K1.shifted_conv3x3_bias_act(x, wt, b)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (n, cout, h, w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    d = (got - K1.torch_reference(x, wt, b)).abs()
    mag = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x.abs(), (1, 1, 2, 0)), wt.abs())
    bar = TOL32["atol"] + TOL32["rtol"] * (mag + b.abs().view(1, -1, 1, 1))
    assert (d <= bar).all(), (
        f"{int((d > bar).sum())} outputs off the bar, max |err| "
        f"{d.max().item():.3e}, max |err| / bar {(d / bar).max().item():.3f}")


@pytest.mark.parametrize("shape", K1_TRAIN_SHAPES + K1_REQUEST_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_fp32_matches_twin_at_the_model_shapes(cuda, shape):
    """fp32 K1 at every training layer shape and at request layer shapes."""
    _k1_fp32_matches_twin(shape, sum(shape))


@pytest.mark.parametrize("shape", K1_ODD_SHAPES + K1_FP32_PASSES_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_k1_fp32_matches_twin_at_odd_shapes(cuda, shape):
    """fp32 K1 where Cin is not a multiple of 4 (padded to one, staged in
    4-byte copies), Cout not 48 or 96, W narrower than a tile (tiles span
    images) or not a multiple of the tile width, and where the tile is
    staged in passes over Cin."""
    _k1_fp32_matches_twin(shape, 7 + sum(shape))


def test_k1_fp32_is_bitwise_repeatable(cuda):
    """At a dec1b-sized call (batch 1536, 64x64, 96 -> 96: 49,152 tiles)
    two launches give the same bit patterns: no atomics, a fixed summation
    order (-0.0 and +0.0 told apart)."""
    x, wt, b = _k1_operands(5, 1536, 64, 64, 96, 96, torch.float32)
    a = K1.shifted_conv3x3_bias_act(x, wt, b)
    c = K1.shifted_conv3x3_bias_act(x, wt, b)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int32), c.view(torch.int32))


def test_k1_refuses_before_launching(cuda, monkeypatch):
    """What K1's plan does not fit raises before any launch, and launches
    nothing (no shape of the model is refused: the limit is lowered here)."""
    x, wt, b = _k1_operands(0, 2, 16, 64, 96, 96, torch.bfloat16)
    monkeypatch.setattr(K1, "SMEM_LIMIT", 48 * 1024)
    before = K1.launches
    with pytest.raises(ValueError, match="shared memory"):
        K1.shifted_conv3x3_bias_act(x, wt, b)
    assert K1.launches == before


def _k2_operands(seed, m, k, n_out, dtype, c=96, na=384, nb=96):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale: torch.from_numpy(
        (rng.standard_normal(s) * scale).astype(np.float32)).cuda()
    xs = [f(m, c, scale=0.5).to(dtype) for _ in range(k)]
    xs[0][0, 0] = -0.0
    was = [f(c, na, scale=0.05).to(dtype) for _ in range(k)]
    return (xs, was, f(na, scale=0.1), f(na, nb, scale=0.05).to(dtype),
            f(nb, scale=0.1), f(nb, n_out, scale=0.1).to(dtype),
            f(n_out, scale=0.1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n_out", [(4096, 4, 9), (1000, 4, 10),
                                       (77, 1, 2), (31, 2, 3)])
def test_k2_cuda_matches_twin(cuda, dtype, m, k, n_out):
    args = _k2_operands(m + k, m, k, n_out, dtype)
    before = K2.launches
    got = K2.fused_nin_head(*args)
    torch.cuda.synchronize()
    assert K2.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, n_out)
    ref = K2.torch_reference(*args)
    # bf16: h1 and h2 are rounded to bf16 on both sides; a sum taken in
    # another order can flip one rounding (2**-8). Bar: 2**-6 of the range
    atol = 1e-5 if dtype == torch.float32 else 2 ** -6 * ref.abs().max().item()
    torch.testing.assert_close(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("conv,head,k1_calls,k2_calls", [
    ("lax", "lax", 0, 0), ("lax", "pallas", 0, 1), ("pallas", "lax", 24, 0)])
def test_apply_on_the_card_matches_the_cpu(cuda, conv, head, k1_calls,
                                           k2_calls):
    """The whole forward in each backend arm on the card, against the torch
    ops on the CPU, fp32 at narrow widths: 1e-4 (17 convs and the head,
    summation order only). A non-square input runs two trunk calls."""
    widths = dict(enc=8, dec=16, nin_a=32, nin_b=16)
    params = bu.init_params(torch.Generator().manual_seed(0), 3, 9, **widths)
    for leaf in params.values():
        leaf["b"] += 0.05
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 32, 64, 3)).astype(np.float32))
    ref = bu.apply(params, x, compute_dtype=torch.float32)
    gpu = {n: {k: v.cuda() for k, v in leaf.items()}
           for n, leaf in params.items()}
    k1_0, k2_0 = K1.launches, K2.launches
    got = bu.apply(gpu, x.cuda(), compute_dtype=torch.float32,
                   conv_backend=conv, head_backend=head)
    torch.cuda.synchronize()
    assert (K1.launches - k1_0, K2.launches - k2_0) == (k1_calls, k2_calls)
    torch.testing.assert_close(got.cpu(), ref, rtol=1e-4, atol=1e-4)


# ------------------------- training: K2', K3, autograd -------------------------


def _head_twin_bar(ref, dtype):
    # bf16: h1, h2, dpre1 and dpre2 are rounded on both sides, and a sum
    # taken in another order can flip one rounding (2**-8): 2**-6 of the
    # range. fp32: order only, 1e-5 of the range (sums over up to 4096 rows)
    return (1e-5 if dtype == torch.float32 else 2 ** -6) * max(
        ref.abs().max().item(), 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n_out", [(4096, 4, 9), (1000, 4, 10), (77, 1, 2)])
def test_k2_save_h1_cuda_matches_twin(cuda, dtype, m, k, n_out):
    args = _k2_operands(m + 2 * k, m, k, n_out, dtype)
    before = (K2.launches, K2.launches_save_h1)
    out, h1 = K2.nin_head_fwd(*args, save_h1=True)
    torch.cuda.synchronize()
    assert (K2.launches, K2.launches_save_h1) == (before[0], before[1] + 1)
    ref, ref_h1 = K2.torch_reference_fwd(*args)
    assert h1.dtype == dtype and h1.shape == (m, 384)
    torch.testing.assert_close(out, ref, rtol=0, atol=_head_twin_bar(ref, dtype))
    # h1: one rounding of the same fp32 sum on each side (one bf16 ulp)
    tol = TOL32 if dtype == torch.float32 else dict(rtol=2 ** -7, atol=1e-5)
    torch.testing.assert_close(h1.float(), ref_h1.float(), **tol)


# ------------------- bf16 K2 / K2' on the tensor cores -------------------

# widths that are not multiples of 16 (C 40, Na 72, Nb 24, Nc 3) and the
# narrow model config's head (C 16, Na 32, Nb 16, Nc 9)
K2_NARROW = {"c40-na72-nb24-nc3": dict(c=40, na=72, nb=24, n_out=3),
             "c16-na32-nb16-nc9": dict(c=16, na=32, nb=16, n_out=9)}


def _k2_bf16_matches_twin(args, save_h1):
    before = (K2.launches, K2.launches_save_h1)
    out, h1 = K2.nin_head_fwd(*args, save_h1=save_h1)
    torch.cuda.synchronize()
    assert (K2.launches, K2.launches_save_h1) == (before[0] + (not save_h1),
                                                  before[1] + save_h1)
    ref, ref_h1 = K2.torch_reference_fwd(*args)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=_head_twin_bar(ref, torch.bfloat16))
    if not save_h1:
        assert h1 is None
        return
    assert h1.dtype == torch.bfloat16 and h1.shape == ref_h1.shape
    # one rounding of the same fp32 sum on each side (one bf16 ulp)
    torch.testing.assert_close(h1.float(), ref_h1.float(), rtol=2 ** -7,
                               atol=1e-5)


@pytest.mark.parametrize("save_h1", [False, True])
@pytest.mark.parametrize("m", [1, 63, 65, 127, 129, 4133])
def test_k2_bf16_ragged_rows_match_twin(cuda, m, save_h1):
    """The tensor-core kernel at ragged M: a tile of 128 rows (16 per
    warp) part-filled, the rest zero and masked."""
    _k2_bf16_matches_twin(_k2_operands(m + 3, m, 4, 10, torch.bfloat16),
                          save_h1)


@pytest.mark.parametrize("save_h1", [False, True])
@pytest.mark.parametrize("widths", list(K2_NARROW.values()), ids=list(K2_NARROW))
@pytest.mark.parametrize("m,k", [(1000, 4), (77, 1)])
def test_k2_bf16_narrow_widths_match_twin(cuda, m, k, widths, save_h1):
    """The generic instantiation: padded columns zero in shared memory,
    a part-filled last chunk of Na, masked on store."""
    w = dict(widths)
    n_out = w.pop("n_out")
    _k2_bf16_matches_twin(_k2_operands(m + k, m, k, n_out, torch.bfloat16,
                                       **w), save_h1)


def test_k2_bf16_refuses_what_it_does_not_take(cuda):
    """bf16 K2 raises, and launches nothing, for widths that are not
    multiples of 8, C over its limit, Nc over 16, operands off a 16-byte
    boundary and widths whose tiles exceed a block's shared memory (k 4 of
    C 128 at the model's Na and Nb: the launcher refuses them)."""
    before = (K2.launches, K2.launches_save_h1)
    bf = torch.bfloat16
    for k, widths, n_out, match in (
            (1, dict(c=20, na=72, nb=24), 3, "multiples of 8"),
            (1, dict(c=264, na=72, nb=24), 3, "input channels"),
            (1, dict(c=40, na=72, nb=24), 17, "Nc <= 16"),
            (4, dict(c=128), 10, "launcher refuses bf16 at k 4, C 128")):
        args = _k2_operands(3, 64, k, n_out, bf, **widths)
        for save_h1 in (False, True):
            with pytest.raises(ValueError, match=match):
                K2.nin_head_fwd(*args, save_h1=save_h1)
    xs, was, *rest = _k2_operands(3, 64, 1, 3, bf)
    off = torch.empty(64 * 96 + 1, dtype=bf, device="cuda")[1:]
    off = off.view(64, 96).copy_(xs[0])
    for save_h1 in (False, True):
        with pytest.raises(ValueError, match="16-byte"):
            K2.nin_head_fwd([off], was, *rest, save_h1=save_h1)
    assert (K2.launches, K2.launches_save_h1) == before


def test_k2_bf16_is_bitwise_repeatable_and_one_kernel(cuda):
    """At M = 262,144 (2,048 tiles over persistent blocks) two launches of
    K2 give the same bits, two of K2' too, and K2 and K2' (one kernel, h1
    stores aside) give the same `out` bits."""
    args = _k2_operands(13, 262_144, 4, 10, torch.bfloat16)
    a, b = K2.fused_nin_head(*args), K2.fused_nin_head(*args)
    (c, h1c), (d, h1d) = (K2.nin_head_fwd(*args, save_h1=True),
                          K2.nin_head_fwd(*args, save_h1=True))
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d) and torch.equal(h1c, h1d)
    assert torch.equal(a, c)


# ------------------- fp32 K2 / K2' on the FMA pipes -------------------


def _k2_fp32_matches_twin(args, save_h1):
    """out within 1e-5 of the twin (fp32, summation order only), h1 at
    ``TOL32``; the launch is counted on its own counter."""
    before = (K2.launches, K2.launches_save_h1)
    out, h1 = K2.nin_head_fwd(*args, save_h1=save_h1)
    torch.cuda.synchronize()
    assert (K2.launches, K2.launches_save_h1) == (before[0] + (not save_h1),
                                                  before[1] + save_h1)
    ref, ref_h1 = K2.torch_reference_fwd(*args)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    if not save_h1:
        assert h1 is None
        return
    assert h1.dtype == torch.float32 and h1.shape == ref_h1.shape
    torch.testing.assert_close(h1, ref_h1, **TOL32)


@pytest.mark.parametrize("save_h1", [False, True])
@pytest.mark.parametrize("m", [1, 63, 65, 127, 129, 4133])
def test_k2_fp32_ragged_rows_match_twin(cuda, m, save_h1):
    """The FMA kernel at ragged M: a 128-row tile part-filled, the rest
    zero and masked."""
    _k2_fp32_matches_twin(_k2_operands(m + 5, m, 4, 10, torch.float32),
                          save_h1)


@pytest.mark.parametrize("save_h1", [False, True])
@pytest.mark.parametrize("widths", list(K2_NARROW.values()), ids=list(K2_NARROW))
def test_k2_fp32_narrow_widths_match_twin(cuda, widths, save_h1):
    """A part-filled chunk of Na, slice of C and pass of Nb: the pads are
    zero in shared memory and masked on store."""
    w = dict(widths)
    n_out = w.pop("n_out")
    _k2_fp32_matches_twin(_k2_operands(7, 1000, 4, n_out, torch.float32,
                                       **w), save_h1)


# C 3 and 99: x rows off 16-byte boundaries (4-byte pieces); Na MAX_NA and
# past it (fp32 K2 walks Na in chunks of 128: 520 ends in a part-filled
# chunk of a width not a multiple of 4); Nb 200 and Nc 40: three passes
# over Nb (out's partial sum carried in out) and three groups of 16 columns
K2_FP32_WIDE = {"c3": dict(c=3), "c99": dict(c=99),
                "na512": dict(na=K2.MAX_NA), "na520": dict(na=K2.MAX_NA + 8),
                "nb200-nc40": dict(nb=200, n_out=40)}


@pytest.mark.parametrize("save_h1", [False, True])
@pytest.mark.parametrize("widths", list(K2_FP32_WIDE.values()),
                         ids=list(K2_FP32_WIDE))
def test_k2_fp32_odd_widths_match_twin(cuda, widths, save_h1):
    w = dict(widths)
    n_out = w.pop("n_out", 10)
    _k2_fp32_matches_twin(_k2_operands(11, 1000, 4, n_out, torch.float32,
                                       **w), save_h1)


def test_k2_fp32_is_bitwise_repeatable_and_one_kernel(cuda):
    """At M = 262,144 (2,048 tiles over persistent blocks) two launches of
    fp32 K2 give the same bits, two of K2' too, and K2 and K2' (one kernel,
    h1 stores aside) give the same `out` bits."""
    args = _k2_operands(17, 262_144, 4, 10, torch.float32)
    a, b = K2.fused_nin_head(*args), K2.fused_nin_head(*args)
    (c, h1c), (d, h1d) = (K2.nin_head_fwd(*args, save_h1=True),
                          K2.nin_head_fwd(*args, save_h1=True))
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(c, d) and torch.equal(h1c, h1d)
    assert torch.equal(a, c)


def _k3_operands(seed, m, k, n_out, dtype, **widths):
    args = _k2_operands(seed, m, k, n_out, dtype, **widths)
    xs, was, ba, wb, bb, wc, bc = args
    _, h1 = K2.torch_reference_fwd(*args)
    g = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (m, n_out)).astype(np.float32)).cuda()
    return xs, was, h1, wb, bb, wc, g


def _k3_matches_twin(args, dtype):
    before = K2.launches_bwd
    got = K2.nin_head_bwd(*args)
    torch.cuda.synchronize()
    assert K2.launches_bwd == before + 1
    ref = K2.torch_reference_bwd(*args)
    flat = lambda r: [*r[0], *r[1], *r[2:]]
    for i, (a, b) in enumerate(zip(flat(got), flat(ref))):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.isfinite(a).all(), i
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=_head_twin_bar(b.float(), dtype),
                                   msg=lambda s, i=i: f"output {i}: {s}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n_out", [(4096, 4, 9), (4133, 4, 10), (77, 1, 2)])
def test_k3_cuda_matches_twin(cuda, dtype, m, k, n_out):
    _k3_matches_twin(_k3_operands(m + k, m, k, n_out, dtype), dtype)


@pytest.mark.parametrize("m", [1, 63, 65, 4133])
def test_k3_bf16_ragged_rows_match_twin(cuda, m):
    """The tensor-core kernels at ragged M: a tile of 128 rows (a) and a
    stage of 64 rows (b) part-filled, the rest zero and masked."""
    _k3_matches_twin(_k3_operands(m, m, 4, 10, torch.bfloat16),
                     torch.bfloat16)


@pytest.mark.parametrize("m", [127, 129, 255, 257])
def test_k3_bf16_tile_edges_match_twin(cuda, m):
    """The wgmma kernels at the edges of (a)'s 128-row tiles and its
    warpgroups' 64 rows: a tile or a warpgroup's rows part-filled or empty
    (TMA zero-fills the loads past M and clips the stores); (b)'s one split
    of whole 64-row stages, the last part-filled."""
    _k3_matches_twin(_k3_operands(m + 7, m, 4, 10, torch.bfloat16),
                     torch.bfloat16)


# Na MAX_NA (eight K blocks of h1: one warpgroup per block, dpre1's A
# fragments 128 registers); C 200 (three passes of 96 over dx_i's columns)
# with Nc 40 (three K steps of dh2, two column tiles of dWc); Nb 128 at the
# model's Na (two passes of pre2, the second of 32 columns; dh1 reads the
# second pass's dpre2 back); Nb 600 at Na 64 (seven passes; dWb^T, dWc and
# dbb in five row tiles of 128); Nb 200 with Nc 40 (Wc^T's window rewritten
# per pass); Nc 100 (the window rewritten per 64 columns of Nc)
K3_BF16_WIDE = {"na512": dict(na=K2.MAX_NA), "c200-nc40": dict(c=200, n_out=40),
                "nb128": dict(nb=128), "na64-nb600": dict(na=64, nb=600),
                "nb200-nc40": dict(nb=200, n_out=40), "nc100": dict(n_out=100)}


@pytest.mark.parametrize("widths", list(K3_BF16_WIDE.values()),
                         ids=list(K3_BF16_WIDE))
def test_k3_bf16_wide_widths_match_twin(cuda, widths):
    w = dict(widths)
    n_out = w.pop("n_out", 10)
    _k3_matches_twin(_k3_operands(17, 4133, 4, n_out, torch.bfloat16, **w),
                     torch.bfloat16)


def _k3_bf16_step_matches_twin(args):
    """bf16 K3 against the twin at a training step's M: every output within
    ``_head_twin_bar``; dx_i on the rows whose dpre2 mask is no tie (an
    element of pre2 = h1 Wb + bb within 2**-20 of its range of zero, where
    the tensor cores' and the twin's sums may round to opposite signs; at
    most one row in 1,000). The weight grads, sums over every row, keep the
    tie rows."""
    xs, was, h1, wb, bb, wc, g = args
    got = K2.nin_head_bwd(*args)
    torch.cuda.synchronize()
    ref = K2.torch_reference_bwd(*args)
    ties = torch.zeros(h1.shape[0], dtype=torch.bool, device=h1.device)
    pre_max = 0.0
    for pass_ in (0, 1):
        for r in range(0, h1.shape[0], 1 << 18):
            pre2 = h1[r:r + (1 << 18)].float() @ wb.float() + bb.float()
            if pass_ == 0:
                pre_max = max(pre_max, pre2.abs().max().item())
            else:
                ties[r:r + (1 << 18)] = (pre2.abs() <= 2 ** -20 * pre_max).any(1)
    assert int(ties.sum()) <= max(1, h1.shape[0] // 1000)
    flat = lambda r: [*r[0], *r[1], *r[2:]]
    for i, (a, b) in enumerate(zip(flat(got), flat(ref))):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        if i < len(xs):
            a, b = a[~ties], b[~ties]
        assert torch.isfinite(a).all(), i
        torch.testing.assert_close(a.float(), b.float(), rtol=0,
                                   atol=_head_twin_bar(b.float(), torch.bfloat16),
                                   msg=lambda s, i=i: f"output {i}: {s}")
    return got


@pytest.mark.parametrize("m", [262_144, 1_572_864])
def test_k3_bf16_training_step_matches_twin(cuda, m):
    """The model's head at the Trainer's 128 x 128 batch 16 (M 262,144) and
    the benchmark's 64 x 64 batch 384 (M 1,572,864): k 4, Nc 10; 64 splits
    of the weight grads, 2,048 or 12,288 row tiles over persistent blocks."""
    _k3_bf16_step_matches_twin(_k3_operands(23, m, 4, 10, torch.bfloat16))


def test_k3_bf16_training_step_is_bitwise_repeatable(cuda):
    """At the benchmark's M (1,572,864): two launches give the same bits (no
    float atomics; a split count fixed by M; every block walks its tiles
    and items in a fixed order)."""
    args = _k3_operands(29, 1_572_864, 4, 10, torch.bfloat16)
    a, b = K2.nin_head_bwd(*args), K2.nin_head_bwd(*args)
    torch.cuda.synchronize()
    for x, y in zip([*a[0], *a[1], *a[2:]], [*b[0], *b[1], *b[2:]]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("m,k", [(1000, 4), (77, 1), (4133, 2)])
def test_k3_bf16_narrow_widths_match_twin(cuda, m, k):
    """Widths that are not multiples of 16 (C 40, Na 72, Nb 24, Nc 3): the
    padded columns are zero in shared memory and masked on store."""
    args = _k3_operands(m + 5, m, k, 3, torch.bfloat16, c=40, na=72, nb=24)
    _k3_matches_twin(args, torch.bfloat16)


@pytest.mark.parametrize("m", [1, 63, 65, 127, 129, 4133])
def test_k3_fp32_ragged_rows_match_twin(cuda, m):
    """The fp32 FMA kernels at ragged M: a 128-row tile part-filled in both
    row launches, a stage of 32 rows in (b); the rest zero and masked."""
    _k3_matches_twin(_k3_operands(m + 1, m, 4, 10, torch.float32),
                     torch.float32)


# C 3 and 99: x rows off 16-byte boundaries (4-byte pieces; dx chunks of
# 128 columns straddle branches at 99); Na MAX_NA (four chunks of Na); Nb
# 200 and Nc 40: three passes over Nb (dh1's partial sum carried in the
# workspace) and three groups of Nc; the narrow widths (part-filled slices,
# chunks and passes); C, Na and Nb not multiples of 4 (h1, Wb, Wb^T, the
# workspace and dx in 4-byte pieces)
K3_FP32_ODD = {"c3": dict(c=3), "c99": dict(c=99), "na512": dict(na=K2.MAX_NA),
               "nb200-nc40": dict(nb=200, n_out=40),
               "c40-na72-nb24": dict(c=40, na=72, nb=24, n_out=3),
               "c16-na32-nb16": dict(c=16, na=32, nb=16, n_out=9),
               "c5-na70-nb30": dict(c=5, na=70, nb=30, n_out=3)}


@pytest.mark.parametrize("widths", list(K3_FP32_ODD.values()),
                         ids=list(K3_FP32_ODD))
def test_k3_fp32_odd_widths_match_twin(cuda, widths):
    w = dict(widths)
    n_out = w.pop("n_out", 10)
    _k3_matches_twin(_k3_operands(13, 1000, 4, n_out, torch.float32, **w),
                     torch.float32)


@pytest.mark.parametrize("m", [4095, 4097, 8193, 262_145])
def test_k3_fp32_split_boundaries_match_twin(cuda, m):
    """(b) at M on the weight grads' split boundaries, where a split is not
    a multiple of its 32-row stage: one split of 4,095 rows, 2,049 + 2,048,
    3 x 2,731 and 64 x 4,097 (the last 4,034); a tile's work items end in a
    part-filled stage, and the next item's first stages load meanwhile.
    Two launches give the same bits."""
    args = _k3_operands(m + 3, m, 4, 10, torch.float32)
    _k3_matches_twin(args, torch.float32)
    a, b = K2.nin_head_bwd(*args), K2.nin_head_bwd(*args)
    torch.cuda.synchronize()
    for x, y in zip([*a[0], *a[1], *a[2:]], [*b[0], *b[1], *b[2:]]):
        assert torch.equal(x, y)


def test_k3_fp32_is_bitwise_repeatable(cuda):
    """The fp32 FMA kernels at M = 262,144 (2,048 row tiles over persistent
    blocks, 64 splits of the weight grads): two launches give the same
    bits."""
    args = _k3_operands(19, 262_144, 4, 10, torch.float32)
    a, b = K2.nin_head_bwd(*args), K2.nin_head_bwd(*args)
    torch.cuda.synchronize()
    for x, y in zip([*a[0], *a[1], *a[2:]], [*b[0], *b[1], *b[2:]]):
        assert torch.equal(x, y)


def test_k3_bf16_refuses_what_it_does_not_take(cuda):
    """bf16 K3 raises, and launches nothing, for widths that are not
    multiples of 8, for operands off a 16-byte boundary and for widths
    whose tiles exceed a block's shared memory (Na 512 with Nb 12,000:
    bb's floats beside h1's boxes and the ring; the launcher refuses
    them)."""
    before = K2.launches_bwd
    args = _k3_operands(3, 64, 1, 3, torch.bfloat16, c=20, na=72, nb=24)
    with pytest.raises(ValueError, match="multiples of 8"):
        K2.nin_head_bwd(*args)
    args = _k3_operands(3, 64, 4, 10, torch.bfloat16, na=K2.MAX_NA, nb=12_000)
    with pytest.raises(ValueError, match="launcher refuses bf16 at k 4, C 96, "
                                         "Na 512, Nb 12000"):
        K2.nin_head_bwd(*args)
    xs, was, h1, wb, bb, wc, g = _k3_operands(3, 64, 1, 3, torch.bfloat16)
    off = torch.empty(64 * 96 + 1, dtype=torch.bfloat16, device="cuda")[1:]
    off = off.view(64, 96).copy_(xs[0])
    with pytest.raises(ValueError, match="16-byte"):
        K2.nin_head_bwd([off], was, h1, wb, bb, wc, g)
    assert K2.launches_bwd == before


def test_k3_bf16_is_bitwise_repeatable_at_scale(cuda):
    """The tensor-core path at M = 262,144 (64 splits of the weight grads,
    4,096 row tiles): two launches give the same bits."""
    args = _k3_operands(11, 262_144, 4, 10, torch.bfloat16)
    a, b = K2.nin_head_bwd(*args), K2.nin_head_bwd(*args)
    torch.cuda.synchronize()
    for x, y in zip([*a[0], *a[1], *a[2:]], [*b[0], *b[1], *b[2:]]):
        assert torch.equal(x, y)


def test_k3_cuda_is_bitwise_repeatable(cuda):
    """No float atomics and a split count fixed by M: two launches on the
    same inputs give the same bits."""
    args = _k3_operands(9, 50_000, 4, 9, torch.bfloat16)
    a, b = K2.nin_head_bwd(*args), K2.nin_head_bwd(*args)
    torch.cuda.synchronize()
    for x, y in zip([*a[0], *a[1], *a[2:]], [*b[0], *b[1], *b[2:]]):
        assert torch.equal(x, y)


def test_kernel_wrappers_refuse_to_cut_the_graph(cuda):
    """On the card a plain wrapper raises where autograd records and an
    input requires grad; the autograd entry points run, and give grads."""
    x, wt, b = _k1_operands(1, 1, 8, 8, 3, 48, torch.float32)
    wt.requires_grad_(True)
    with pytest.raises(RuntimeError, match="fused_shifted_conv / nin_head"):
        K1.shifted_conv3x3_bias_act(x, wt, b)
    with torch.no_grad():
        K1.shifted_conv3x3_bias_act(x, wt, b)
    K1.fused_shifted_conv(x, wt, b).sum().backward()
    assert wt.grad is not None and wt.grad.abs().max() > 0
    args = _k2_operands(2, 64, 2, 9, torch.float32)
    args[3].requires_grad_(True)
    with pytest.raises(RuntimeError, match="fused_shifted_conv / nin_head"):
        K2.fused_nin_head(*args)
    with pytest.raises(RuntimeError, match="fused_shifted_conv / nin_head"):
        K2.nin_head_fwd(*args, save_h1=True)
    before = (K2.launches_save_h1, K2.launches_bwd)
    K2.nin_head(*args).square().sum().backward()
    torch.cuda.synchronize()
    assert (K2.launches_save_h1, K2.launches_bwd) == (before[0] + 1,
                                                      before[1] + 1)
    assert args[3].grad is not None and args[3].grad.abs().max() > 0


def _training_case(conv, head, shape):
    """The whole forward + backward (SSDN gauss25 NLL, the stabilized
    objective) in one backend arm on the card, against the torch ops on
    the CPU, fp32 at narrow widths: the loss at 1e-5 relative, each leaf's
    grad at 1e-4 of its max abs. The kernel arms count their launches."""
    from ssdn_tpu_torch.config import (ModelConfig, TrainConfig,
                                       parse_noise_style)
    from ssdn_tpu_torch.train import make_train_step

    def cfg(c, h):
        return TrainConfig(noise=parse_noise_style("gauss25"), model=ModelConfig(
            compute_dtype="float32", enc_features=8, dec_features=16,
            nin_a_features=32, nin_b_features=16, conv_backend=c,
            head_backend=h))

    params = bu.init_params(torch.Generator().manual_seed(0), 3, 9,
                            enc=8, dec=16, nin_a=32, nin_b=16)
    for leaf in params.values():
        leaf["b"] += 0.05
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    y = (x + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    sig = np.full((shape[0],), 0.1, np.float32)

    def run(device, c, h):
        t = lambda a: torch.from_numpy(a).to(device)
        p = {n: {k: v.to(device) for k, v in leaf.items()}
             for n, leaf in params.items()}
        return make_train_step(cfg(c, h), device=device).loss_and_grads(
            p, t(x), t(y), {"sigma": t(sig)})

    ref_loss, _, ref_grads = run("cpu", "lax", "lax")
    counts = (K1.launches, K2.launches_save_h1, K2.launches_bwd)
    loss, _, grads = run("cuda", conv, head)
    torch.cuda.synchronize()
    trunks = 1 if shape[1] == shape[2] else 2
    want = {"lax": (0, 0, 0), "pallas": (12 * trunks, 0, 0)}[conv] if \
        head == "lax" else (0, 1, 1)
    assert (K1.launches - counts[0], K2.launches_save_h1 - counts[1],
            K2.launches_bwd - counts[2]) == want
    torch.testing.assert_close(loss.cpu(), ref_loss, rtol=1e-5, atol=0)
    for name, leaf in ref_grads.items():
        for key, ref in leaf.items():
            torch.testing.assert_close(
                grads[name][key].cpu(), ref, rtol=0,
                atol=1e-4 * max(ref.abs().max().item(), 1e-30),
                msg=lambda s, n=name, k=key: f"{n}.{k}: {s}")


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 32, 64, 3)])
@pytest.mark.parametrize("conv,head", [("lax", "lax"), ("lax", "pallas"),
                                       ("pallas", "lax")])
def test_training_loss_and_grads_on_the_card_match_the_cpu(cuda, conv, head,
                                                           shape):
    _training_case(conv, head, shape)


@pytest.fixture
def tf32_on():
    """Both TF32 flags set to True (cuDNN's default for convs; a process
    that asked for TF32 matmuls too), restored afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 32, 64, 3)])
def test_fp32_torch_ops_grads_are_true_fp32_with_tf32_on(tf32_on, shape):
    """The torch-ops arm's fp32 step (conv_precision "highest") in a process
    whose TF32 flags are True: its conv grads run at the forward's
    precision and the head's ``matmul_acc_f32`` products with TF32 off, so
    loss and grads still match the CPU at the bar of the case above."""
    _training_case("lax", "lax", shape)


# ------------------------------ the Trainer path ------------------------------


def test_prefetcher_device_copy_delivers_the_samplers_bytes(cuda):
    """200 steps through a Prefetcher whose workers copy each batch to the
    card on streams of their own (depth 12, 4 threads): every batch is the
    sampler's, in step order, once the consumer has waited on its copy.
    The consumer's stream is kept busy between batches, so a copy or a
    reuse that is not ordered against it would show."""
    from ssdn_tpu_torch.data import Prefetcher, synthetic_dataset, to_device
    from ssdn_tpu_torch.native import make_sampler

    sampler = make_sampler(synthetic_dataset(n=16, size=128, seed=4), 64,
                           96, seed=2, backend="native")
    busy = torch.randn(2048, 2048, device=cuda)
    seen = []
    for step, item in enumerate(Prefetcher(sampler, 0, 200, depth=12,
                                           n_threads=4,
                                           transform=to_device(cuda))):
        batch = item.wait()
        assert batch.device.type == "cuda" and batch.dtype == torch.uint8
        busy = busy @ busy * 1e-3
        seen.append(batch.sum(dtype=torch.int64))
        assert torch.equal(batch.cpu(), torch.from_numpy(sampler.sample(step)))
    assert len(seen) == 200
    torch.cuda.synchronize()


@pytest.mark.parametrize("arm", ["conv_pallas", "head_pallas"])
def test_trainer_runs_on_the_card_through_the_kernels(cuda, arm, tmp_path):
    """A 4-step Trainer run at a small width in each kernel arm: the loss
    and the params stay finite, and the kernels launch once per step (K1
    12 times per trunk; K2' and K3 once per step, K2 once per eval)."""
    import json

    from ssdn_tpu_torch.config import ModelConfig, TrainConfig, parse_noise_style
    from ssdn_tpu_torch.train.loop import Trainer

    conv, head = {"conv_pallas": ("pallas", "lax"),
                  "head_pallas": ("lax", "pallas")}[arm]
    cfg = TrainConfig(
        noise=parse_noise_style("gauss25"),
        model=ModelConfig(in_channels=3, enc_features=16, dec_features=32,
                          nin_a_features=64, nin_b_features=32,
                          conv_backend=conv, head_backend=head),
        patch_size=64, batch_size=8, iterations=4, eval_interval=4,
        snapshot_interval=4, seed=1)
    k1, k2, k2p, k3 = (K1.launches, K2.launches, K2.launches_save_h1,
                       K2.launches_bwd)
    state = Trainer(cfg, str(tmp_path), train_data="synthetic:8:128",
                    eval_data="synthetic:2:64", log_interval=2).train()
    counts = (K1.launches - k1, K2.launches - k2,
              K2.launches_save_h1 - k2p, K2.launches_bwd - k3)
    want = {"conv_pallas": (12 * (4 + 1), 0, 0, 0),
            "head_pallas": (0, 1, 4, 4)}[arm]
    assert counts == want
    assert state.step == 4
    assert all(bool(torch.isfinite(t).all()) for leaf in state.params.values()
               for t in leaf.values())
    with open(tmp_path / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert all(np.isfinite(r["loss"]) for r in rows if r["prefix"] == "train")


@pytest.mark.parametrize("arm", ["lax", "head_pallas", "conv_pallas"])
def test_sequential_tiling_equals_full_on_the_card(cuda, arm):
    """Sequential tiled denoise (tile_w 128, the exact halo) of a 32x1024
    image against the full-image path in each arm, fp32 at narrow widths:
    8 windows of 32x768, so K1 launches 24 times per window in the conv arm
    (two trunk calls: the window is not square) and K2 once per window in
    the head arm."""
    from ssdn_tpu_torch.config import ModelConfig, TrainConfig, parse_noise_style
    from ssdn_tpu_torch.infer import full
    from ssdn_tpu_torch.infer.tiled import tiled_denoise_sequential

    conv, head = {"lax": ("lax", "lax"), "head_pallas": ("lax", "pallas"),
                  "conv_pallas": ("pallas", "lax")}[arm]
    cfg = TrainConfig(noise=parse_noise_style("gauss25"), model=ModelConfig(
        in_channels=3, compute_dtype="float32", enc_features=16,
        dec_features=32, nin_a_features=64, nin_b_features=32,
        conv_backend=conv, head_backend=head))
    params = bu.init_params(torch.Generator().manual_seed(0), 3, 9, enc=16,
                            dec=32, nin_a=64, nin_b=32, device="cuda")
    noisy = np.random.default_rng(3).uniform(
        -0.5, 0.5, (32, 1024, 3)).astype(np.float32)
    sigma = np.full((1,), 25 / 255, np.float32)
    k1, k2 = K1.launches, K2.launches
    tiled = tiled_denoise_sequential(cfg, params, noisy, sigma, tile_w=128)
    counts = (K1.launches - k1, K2.launches - k2)
    whole = full.denoise_image(full.make_denoise_fn(cfg), params, noisy, sigma)
    assert counts == {"lax": (0, 0), "head_pallas": (0, 8),
                      "conv_pallas": (24 * 8, 0)}[arm]
    np.testing.assert_allclose(tiled, whole, rtol=0, atol=1e-4)


@pytest.fixture
def nccl_group(cuda):
    """A process group of world size 1 over NCCL in this process (no
    launcher: ``init_group`` keeps its store in the process)."""
    from ssdn_tpu_torch import parallel

    group = parallel.init_group()
    assert (group.world, group.backend) == (1, "nccl")
    yield group
    parallel.destroy_group()


def _small_cfg(conv, head, **over):
    from ssdn_tpu_torch.config import ModelConfig, TrainConfig, parse_noise_style

    return TrainConfig(noise=parse_noise_style("gauss25"), model=ModelConfig(
        in_channels=3, compute_dtype="float32", enc_features=16,
        dec_features=32, nin_a_features=64, nin_b_features=32,
        conv_backend=conv, head_backend=head), patch_size=64, batch_size=4,
        **over)


def test_ppermute_over_nccl_at_world_size_one(nccl_group):
    from ssdn_tpu_torch.parallel import all_gather_w, pmean, ppermute

    t = torch.arange(24, dtype=torch.float32, device="cuda").reshape(1, 2, 4, 3)
    torch.testing.assert_close(ppermute(t[:, :, -1:], [(0, 0)], nccl_group),
                               t[:, :, -1:])
    assert not ppermute(t, [], nccl_group).any()
    torch.testing.assert_close(all_gather_w(t, nccl_group), t)
    torch.testing.assert_close(pmean(t, nccl_group), t)


@pytest.mark.parametrize("arm", ["conv_pallas", "head_pallas"])
def test_dp_step_at_world_size_one_is_the_plain_step(nccl_group, arm,
                                                     monkeypatch):
    """Two data-parallel steps over NCCL at world size 1 against the plain
    step on the same uint8 batches, with cuDNN held to its deterministic
    algorithms (its default backward need not repeat its bits from call to
    call): the collectives are sums of one rank, so the arithmetic is the
    same and the losses and params must be equal bit for bit. K1 12
    launches per step in the conv arm, K2' and K3 one each in the head
    arm."""
    from ssdn_tpu_torch.train import step as tstep

    conv, head = {"conv_pallas": ("pallas", "lax"),
                  "head_pallas": ("lax", "pallas")}[arm]
    cfg = _small_cfg(conv, head)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8)
               for _ in range(2)]
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    runs = []
    init = tstep.init_state(cfg).params
    for group in (None, nccl_group):
        ts = tstep.make_train_step(cfg, group=group)
        state = tstep.init_state(cfg)
        before = (K1.launches, K2.launches_save_h1, K2.launches_bwd)
        losses = []
        for b in batches:
            state, m = ts(state, b)
            losses.append(float(m["loss"]))
        counts = (K1.launches - before[0], K2.launches_save_h1 - before[1],
                  K2.launches_bwd - before[2])
        assert counts == {"conv_pallas": (24, 0, 0),
                          "head_pallas": (0, 2, 2)}[arm]
        runs.append((losses, state.params))
    assert runs[1][0] == runs[0][0]
    for k in init:
        for n in init[k]:
            assert torch.equal(runs[1][1][k][n], runs[0][1][k][n]), f"{k}.{n}"
            assert not torch.equal(runs[0][1][k][n], init[k][n]), f"{k}.{n}"


@pytest.mark.parametrize("arm,strategy", [
    ("lax", "perlevel"), ("lax", "window"), ("head_pallas", "auto"),
    ("conv_pallas", "auto")])
def test_sharded_tiling_at_world_size_one_on_the_card(nccl_group, arm,
                                                      strategy):
    """``tiled_denoise_sharded`` over NCCL at world size 1 against the
    full-image path, fp32 at narrow widths on a 32x1024 image: the window
    modes evaluate one window (the whole image: K1 24 launches in the conv
    arm, K2 one in the head arm), the per-level program none."""
    from ssdn_tpu_torch.infer import full
    from ssdn_tpu_torch.infer.tiled import tiled_denoise_sharded

    conv, head = {"lax": ("lax", "lax"), "head_pallas": ("lax", "pallas"),
                  "conv_pallas": ("pallas", "lax")}[arm]
    cfg = _small_cfg(conv, head)
    params = bu.init_params(torch.Generator().manual_seed(0), 3, 9, enc=16,
                            dec=32, nin_a=64, nin_b=32, device="cuda")
    noisy = np.random.default_rng(3).uniform(
        -0.5, 0.5, (32, 1024, 3)).astype(np.float32)
    sigma = np.full((1,), 25 / 255, np.float32)
    k1, k2 = K1.launches, K2.launches
    out = tiled_denoise_sharded(cfg, params, noisy, sigma, nccl_group,
                                strategy=strategy)
    counts = (K1.launches - k1, K2.launches - k2)
    whole = full.denoise_image(full.make_denoise_fn(cfg), params, noisy, sigma)
    assert counts == {"lax": (0, 0), "head_pallas": (0, 1),
                      "conv_pallas": (24, 0)}[arm]
    np.testing.assert_allclose(out, whole, rtol=0, atol=1e-4)


# ------------------------- the trunk's layout on the card -------------------------

# trunk convs: enc0..enc6, two per fused decoder "a" layer, dec{5..1}b
TRUNK_CONVS = 7 + 2 * 5 + 5


def _conv_census(dtype, shape, backward):
    """``debug.conv_layouts`` of one forward of the published widths (conv
    lax, head pallas: K2' and K3 with grads, K2 without) on the card, and
    with ``backward`` the gradients of every parameter."""
    from ssdn_tpu_torch.utils import debug

    params = bu.init_params(torch.Generator().manual_seed(0), 3, 9,
                            device="cuda")
    leaves = [t.requires_grad_(backward) for leaf in params.values()
              for t in leaf.values()]
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1)
                    ).cuda()
    with debug.conv_layouts() as n, torch.set_grad_enabled(backward):
        out = bu.apply(params, x, compute_dtype=dtype, head_backend="pallas")
        if backward:
            torch.autograd.grad(out.square().sum(), leaves)
    torch.cuda.synchronize()
    return n


@pytest.mark.parametrize("dtype,shape,backward,layout,calls", [
    (torch.bfloat16, (8, 64, 64, 3), True, "channels_last", TRUNK_CONVS),
    (torch.bfloat16, (1, 1088, 1920, 3), False, "channels_last",
     2 * TRUNK_CONVS),
    (torch.float32, (8, 64, 64, 3), True, "nchw", TRUNK_CONVS),
], ids=["bf16_train", "bf16_full_hd", "fp32_train"])
def test_trunk_convs_see_the_dtype_layout_on_the_card(cuda, dtype, shape,
                                                      backward, layout,
                                                      calls):
    """cuDNN gets channels_last activations and gradients at every bf16
    trunk conv (a training step's forward and backward; a full-HD
    request's two trunk calls), NCHW at every fp32 one. The census reads
    the backward's convs on the autograd engine's device thread too."""
    n = _conv_census(dtype, shape, backward)
    want = dict.fromkeys(("channels_last", "nchw", "strided"), 0)
    want[layout] = calls
    assert n["convolution"] == want
    assert n["convolution_backward"] == (want if backward else
                                         dict.fromkeys(want, 0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pixel_shuffle_keeps_channels_last_on_the_card(cuda, dtype):
    """``ops.shifted.pixel_shuffle`` returns channels_last, and a
    channels_last input gradient, where ``F.pixel_shuffle`` on CUDA need
    not; same bits as the library op both ways."""
    import torch.nn.functional as F

    from ssdn_tpu_torch.ops.shifted import pixel_shuffle

    x0 = torch.randn(4, 384, 8, 12, device="cuda").to(dtype).contiguous(
        memory_format=torch.channels_last)
    xa = x0.clone().requires_grad_(True)
    xb = x0.clone().requires_grad_(True)
    got, ref = pixel_shuffle(xa, 2), F.pixel_shuffle(xb, 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, ref)
    g = torch.randn(ref.shape, device="cuda").to(dtype).contiguous(
        memory_format=torch.channels_last)
    got.backward(g)
    ref.backward(g)
    assert xa.grad.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(xa.grad, xb.grad)


# ------------------------- the bf16 trunk conv's epilogue -------------------------

# (n, hc, h, w, c, shift, act): a step's crops (hc = h + 2) and dec1b's
# shift, the decoder's bias + activation (hc = h), the torch-ops head's
# 1x1 convs; ragged sizes (N*H*W*C not a multiple of a block's vectors),
# the narrowest widths the kernel takes (C 8, 16, 24: one to three
# vectors a pixel) and rows shorter than the shift's
EPI_CASES = [(3, 7, 5, 7, 48, 0, True), (2, 18, 16, 16, 96, 0, True),
             (2, 66, 64, 64, 96, 1, True), (2, 66, 64, 64, 96, 1, False),
             (5, 9, 9, 11, 96, 0, True), (1, 6, 4, 1920, 48, 0, True),
             (2, 13, 11, 3, 8, 0, True), (3, 7, 5, 9, 24, 1, True),
             (2, 4, 2, 2, 48, 0, True), (1, 3, 1, 5, 16, 1, False),
             (1536, 4, 2, 2, 48, 0, True)]


def _epi_operands(case, seed):
    n, hc, h, w, c, shift, act = case
    g = torch.Generator(device="cuda").manual_seed(seed)
    cl = torch.channels_last
    c0 = torch.randn((n, c, hc, w), generator=g, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=cl)
    c0[0, :, 0, 0] = -0.0
    c0[-1, :, -1, -1] = 0.0
    b = torch.randn((c,), generator=g, device="cuda") * 0.5
    b[0] = -0.0
    gr = torch.randn((n, c, h, w), generator=g, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=cl)
    gr[0, :, -1, 0] = -0.0
    return c0, b, gr


def _bits(t):
    return t.contiguous().view(torch.int16)


@pytest.mark.parametrize("case", EPI_CASES, ids=lambda c: "x".join(
    str(int(v)) for v in c))
def test_conv_epilogue_matches_twin_bit_for_bit(cuda, case):
    """The kernel pair against its twins (the torch ops, on the card) on
    the same c and g: the same bit patterns (signs of zero included),
    forward and backward, each launch counted once."""
    from ssdn_tpu_torch.kernels import conv_epilogue as E

    n, hc, h, w, c, shift, act = case
    slope = 0.1 if act else None
    c0, b, gr = _epi_operands(case, sum(case))
    before = (E.launches, E.launches_bwd)
    out = E.epilogue_fwd(c0, b, h, shift, slope)
    dpre = E.epilogue_bwd(gr, out, hc, shift, slope)
    torch.cuda.synchronize()
    assert (E.launches, E.launches_bwd) == (before[0] + 1, before[1] + 1)
    assert out.shape == (n, c, h, w) and dpre.shape == c0.shape
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert dpre.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(_bits(out),
                       _bits(E.torch_reference(c0, b, h, shift, slope)))
    assert torch.equal(_bits(dpre), _bits(
        E.torch_reference_bwd(gr, out, hc, shift, slope)))


def test_conv_epilogue_refuses_what_it_does_not_take(cuda):
    """NCHW, fp32 and a bias of the wrong size raise before launching; the
    launcher refuses C % 8 != 0 and an operand off a 16-byte boundary (no
    narrower path runs unseen), and ``takes`` keeps such widths on the
    torch ops; a kernel launch refuses to cut the autograd graph."""
    from ssdn_tpu_torch.kernels import conv_epilogue as E

    c0, b, gr = _epi_operands((2, 6, 4, 8, 16, 0, True), 0)
    c20, b20, g20 = _epi_operands((2, 6, 4, 8, 20, 0, True), 0)

    def off(t):
        """t as a channels_last view one element past an allocation's start."""
        n, c, h, w = t.shape
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        v = buf[1:].view(n, h, w, c).permute(0, 3, 1, 2)
        v.copy_(t)
        assert v.is_contiguous(memory_format=torch.channels_last)
        assert v.data_ptr() % 16
        return v

    assert E.takes(c0, 16) and E.takes(c0, 96)
    assert not any(E.takes(t, ch) for t, ch in (
        (c0, 20), (c0, 3), (c0.contiguous(), 16), (c0.float(), 16)))
    before = (E.launches, E.launches_bwd)
    with pytest.raises(ValueError, match="launcher refuses"):
        E.epilogue_fwd(c20, b20, 4)
    with pytest.raises(ValueError, match="launcher refuses"):
        E.epilogue_bwd(g20, g20, 6, 0, 0.1)
    with pytest.raises(ValueError, match="launcher refuses"):
        E.epilogue_fwd(off(c0), b, 4)
    with pytest.raises(ValueError, match="launcher refuses"):
        E.epilogue_bwd(gr, off(gr), 6, 0, 0.1)
    aligned = E._like(off(c0), c0)
    assert aligned.data_ptr() % 16 == 0 and torch.equal(aligned, c0)
    with pytest.raises(ValueError, match="channels_last"):
        E.epilogue_fwd(c0.contiguous(), b, 4)
    with pytest.raises(ValueError, match="bf16"):
        E.epilogue_fwd(c0.float(), b, 4)
    with pytest.raises(ValueError):
        E.epilogue_fwd(c0, b[:8], 4)
    with pytest.raises(ValueError, match="channels_last"):
        E.epilogue_bwd(gr.contiguous(), gr, 6, 0, 0.1)
    with pytest.raises(RuntimeError, match="kernel launch"):
        E.epilogue_fwd(c0.requires_grad_(True), b, 4)
    assert (E.launches, E.launches_bwd) == before


def _epilogue_model(dtype, shape, backward, head="pallas"):
    """Launches of the epilogue in one forward of the published widths on
    the card (and, with ``backward``, the gradients of every parameter),
    and the output and gradients."""
    from ssdn_tpu_torch.kernels import conv_epilogue as E

    params = bu.init_params(torch.Generator().manual_seed(0), 3, 9,
                            device="cuda")
    leaves = [t.requires_grad_(backward) for leaf in params.values()
              for t in leaf.values()]
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1)).cuda()
    before = (E.launches, E.launches_bwd)
    with torch.set_grad_enabled(backward):
        out = bu.apply(params, x, compute_dtype=dtype, head_backend=head)
        grads = (torch.autograd.grad(out.square().sum(), leaves)
                 if backward else ())
    torch.cuda.synchronize()
    return (E.launches - before[0], E.launches_bwd - before[1]), out, grads


@pytest.mark.parametrize("dtype,shape,backward,head,launches", [
    (torch.bfloat16, (8, 64, 64, 3), True, "pallas", (12, 12)),
    (torch.bfloat16, (2, 64, 64, 3), True, "lax", (14, 14)),
    (torch.bfloat16, (1, 1088, 1920, 3), False, "pallas", (24, 0)),
    (torch.float32, (8, 64, 64, 3), True, "pallas", (0, 0)),
], ids=["bf16_train", "bf16_torch_ops_head", "bf16_full_hd", "fp32_train"])
def test_conv_epilogue_launches_at_every_covered_conv(cuda, dtype, shape,
                                                      backward, head,
                                                      launches):
    """enc0, enc6, dec5a..dec1a and dec5b..dec1b (and the torch-ops head's
    nin_a / nin_b) take the epilogue once forward and once backward in a
    bf16 step; a full-HD request's two trunk calls take it 24 times; fp32
    never."""
    assert _epilogue_model(dtype, shape, backward, head)[0] == launches


def test_bf16_model_with_the_epilogue_matches_the_torch_ops(cuda,
                                                            monkeypatch):
    """The bf16 model's output and gradients with the epilogue against the
    torch ops it replaces on the card (``takes`` false): the folded convs
    sum in other orders, so within bf16's parity tolerance, not bits."""
    from ssdn_tpu_torch.kernels import conv_epilogue as E

    _, got, got_g = _epilogue_model(torch.bfloat16, (4, 64, 64, 3), True)
    monkeypatch.setattr(E, "takes", lambda t, c: False)
    n, ref, ref_g = _epilogue_model(torch.bfloat16, (4, 64, 64, 3), True)
    assert n == (0, 0)
    torch.testing.assert_close(got, ref, rtol=2e-2, atol=2e-2)
    for a, r in zip(got_g, ref_g):
        torch.testing.assert_close(a, r, rtol=2e-2,
                                   atol=2e-2 * float(r.abs().max()) + 1e-6)


def _slope_vs_leaky_relu(op, args, dtype, fmt):
    """(op(*args, negative_slope=0.1), leaky_relu(op(*args))), each with
    the gradients of every argument, on the card in ``dtype`` and ``fmt``
    under cuDNN's deterministic algorithms."""
    from ssdn_tpu_torch.ops import shifted as S

    runs = []
    for fused in (True, False):
        ts = [(t.to(dtype) if t.dim() < 4 else t.to(dtype).contiguous(
            memory_format=fmt)).cuda().requires_grad_(True) for t in args]
        out = (op(*ts, negative_slope=0.1) if fused
               else S.leaky_relu(op(*ts), 0.1))
        gout = torch.randn(out.shape,
                           generator=torch.Generator().manual_seed(5)).to(out)
        runs.append((out, torch.autograd.grad(out, ts, gout)))
    return runs


@pytest.mark.parametrize("dtype,fmt", [
    (torch.float32, "nchw"), (torch.float32, "channels_last"),
    (torch.bfloat16, "nchw")], ids=["fp32_nchw", "fp32_cl", "bf16_nchw"])
@pytest.mark.parametrize("site", ["shifted", "dec1b", "unshifted", "1x1",
                                  "decoder"])
def test_fp32_step_takes_no_epilogue_and_keeps_its_bits(cuda, site, dtype,
                                                        fmt):
    """Where the kernel does not run (fp32 in either layout, bf16 NCHW),
    ``conv2d`` and the fused decoder op with ``negative_slope`` give the
    bits of ``leaky_relu`` applied after the op without it: the output and
    the gradient of every operand, under cuDNN's deterministic algorithms,
    with no epilogue launch. (bf16 channels_last takes the kernel: its
    bits are held to the twin's by ``test_conv_epilogue_matches_twin_bit_
    for_bit``.) The ref_fp32 step's state against the parent tree's is a
    chip run of its own, recorded in PERF.md."""
    from ssdn_tpu_torch.kernels import conv_epilogue as E
    from ssdn_tpu_torch.ops import shifted as S

    fmt = {"nchw": torch.contiguous_format,
           "channels_last": torch.channels_last}[fmt]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 16, 24, generator=g)
    b = torch.randn(32, generator=g)
    if site == "decoder":
        skip = torch.randn(2, 8, 32, 48, generator=g)
        w = torch.randn(32, 24, 3, 3, generator=g) * 0.1
        args = (x, skip, w, b)
        op = S.shifted_upsample_concat_conv
    else:
        kw = {"shifted": dict(shifted=True),
              "dec1b": dict(shifted=True, down_shift=1),
              "unshifted": {}, "1x1": {}}[site]
        k = 1 if site == "1x1" else 3
        args = (x, torch.randn(32, 16, k, k, generator=g) * 0.1, b)
        op = lambda *a, **o: S.conv2d(*a, **kw, **o)
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    before = (E.launches, E.launches_bwd)
    try:
        (got, got_g), (ref, ref_g) = _slope_vs_leaky_relu(op, args, dtype,
                                                          fmt)
    finally:
        torch.backends.cudnn.deterministic = prev
    assert (E.launches, E.launches_bwd) == before
    assert got.dtype == ref.dtype and torch.equal(_bits32(got), _bits32(ref))
    for a, r in zip(got_g, ref_g):
        assert a.dtype == r.dtype and torch.equal(_bits32(a), _bits32(r))


def _bits32(t):
    """t's bit patterns (signs of zero included) as integers."""
    t = t.contiguous()
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)
