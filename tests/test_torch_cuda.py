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


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (1, 32, 64, 3)])
@pytest.mark.parametrize("conv,head", [("lax", "lax"), ("lax", "pallas"),
                                       ("pallas", "lax")])
def test_training_loss_and_grads_on_the_card_match_the_cpu(cuda, conv, head,
                                                           shape):
    """The whole forward + backward (SSDN gauss25 NLL, the stabilized
    objective) in each backend arm on the card, against the torch ops on
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
