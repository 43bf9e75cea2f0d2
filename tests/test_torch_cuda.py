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
