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
    multiples of 8, C over its limit, Nc over 16 and operands off a 16-byte
    boundary."""
    before = (K2.launches, K2.launches_save_h1)
    bf = torch.bfloat16
    for widths, n_out, match in ((dict(c=20, na=72, nb=24), 3, "multiples of 8"),
                                 (dict(c=264, na=72, nb=24), 3, "input channels"),
                                 (dict(c=40, na=72, nb=24), 17, "Nc <= 16")):
        args = _k2_operands(3, 64, 1, n_out, bf, **widths)
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
    """The tensor-core kernels at ragged M: a tile of 64 rows (a) and a
    stage of 32 rows (b) part-filled, the rest zero and masked."""
    _k3_matches_twin(_k3_operands(m, m, 4, 10, torch.bfloat16),
                     torch.bfloat16)


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
    multiples of 8 and for operands off a 16-byte boundary."""
    before = K2.launches_bwd
    args = _k3_operands(3, 64, 1, 3, torch.bfloat16, c=20, na=72, nb=24)
    with pytest.raises(ValueError, match="multiples of 8"):
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
