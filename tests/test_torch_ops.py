"""Parity of the port's ops (ssdn_tpu_torch.ops) with the JAX package's
(ssdn_tpu.ops), on the CPU in fp32.

The same numpy arrays (from np.random.default_rng) go to both sides:
NHWC / HWIO to JAX, NCHW / OIHW views of them to torch. The bar is 1e-5
(rtol and atol): the JAX convs are pinned to true fp32 (Precision.HIGHEST)
and torch's CPU convs are fp32, so only the summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssdn_tpu.ops as jops
import ssdn_tpu.ops.shifted as jshifted
import ssdn_tpu_torch.ops as tops
import ssdn_tpu_torch.ops.shifted as tshifted

TOL = dict(rtol=1e-5, atol=1e-5)


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def _oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio)).permute(3, 2, 0, 1)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).detach().numpy()


def _close(got_torch_nchw, ref_jax_nhwc, **tol):
    np.testing.assert_allclose(_nhwc(got_torch_nchw), np.asarray(ref_jax_nhwc),
                               **(tol or TOL))


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_leaky_relu_and_shift_down():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 8, 12, 3)
    x[0, 0, 0, 0] = -0.0
    _close(tops.leaky_relu(_nchw(x)), jops.leaky_relu(jnp.asarray(x)))
    for rows in (0, 1, 3):
        _close(tops.shift_down(_nchw(x), rows),
               jops.shift_down(jnp.asarray(x), rows))


@pytest.mark.parametrize("kh,kw,shifted", [(3, 3, True), (3, 3, False),
                                           (1, 1, False)])
def test_conv2d(kh, kw, shifted):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 8, 12, 5)
    w = _rand(rng, kh, kw, 5, 7, scale=0.3)
    b = _rand(rng, 7, scale=0.1)
    got = tops.conv2d(_nchw(x), _oihw(w), torch.from_numpy(b),
                      shifted=shifted)
    ref = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      shifted=shifted)
    _close(got, ref)


def test_conv2d_down_shift_zeroes_top_row():
    """down_shift=1 folds shift_down into the conv: the top row is zero
    (bias included), and the rest equals shift_down of the plain conv."""
    rng = np.random.default_rng(2)
    x = _rand(rng, 1, 8, 8, 4)
    w = _rand(rng, 3, 3, 4, 6, scale=0.3)
    b = _rand(rng, 6, scale=0.5) + 1.0  # a non-zero bias the mask must clear
    got = tops.conv2d(_nchw(x), _oihw(w), torch.from_numpy(b), shifted=True,
                      down_shift=1)
    ref = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                      shifted=True, down_shift=1)
    _close(got, ref)
    assert torch.all(got[:, :, 0] == 0)
    plain = tops.conv2d(_nchw(x), _oihw(w), torch.from_numpy(b), shifted=True)
    torch.testing.assert_close(got, tops.shift_down(plain, 1), **TOL)
    with pytest.raises(ValueError):
        tops.conv2d(_nchw(x), _oihw(w), shifted=False, down_shift=1)


def test_pools_and_upsample():
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 8, 12, 3)
    _close(tops.maxpool_2x2(_nchw(x)), jops.maxpool_2x2(jnp.asarray(x)))
    _close(tops.shifted_maxpool_2x2(_nchw(x)),
           jops.shifted_maxpool_2x2(jnp.asarray(x)))
    # the -inf pad row never wins: an all-negative input stays finite
    neg = -np.abs(x) - 1.0
    assert torch.isfinite(tops.shifted_maxpool_2x2(_nchw(neg))).all()
    _close(tops.upsample_2x_nearest(_nchw(x)),
           jops.upsample_2x_nearest(jnp.asarray(x)))


def test_matmul_acc_f32():
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 4, 4, 16)
    w = _rand(rng, 16, 5, scale=0.3)
    got = tshifted.matmul_acc_f32(torch.from_numpy(x), torch.from_numpy(w))
    ref = jshifted.matmul_acc_f32(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # bf16 operands, fp32 accumulation and output on both sides
    xb, wb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    ref = jshifted.matmul_acc_f32(xb, wb)
    got = tshifted.matmul_acc_f32(torch.from_numpy(np.asarray(xb, np.float32))
                                  .bfloat16(),
                                  torch.from_numpy(np.asarray(wb, np.float32))
                                  .bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_collapse_upsample_kernel_matches_jax_phases():
    """The port orders the 4 phases (co, pr, pc) for pixel_shuffle, the JAX
    package (pr, pc, co); the taps must be the same."""
    rng = np.random.default_rng(5)
    w = _rand(rng, 3, 3, 4, 6)
    kj = np.asarray(jshifted._collapse_upsample_kernel(jnp.asarray(w)))
    kt = tshifted._collapse_upsample_kernel(_oihw(w)).numpy()  # (4Co,Ci,2,3)
    co = w.shape[3]
    kj = kj.reshape(2, 3, 4, 2, 2, co)          # (a, b, Ci, pr, pc, Co)
    kj = kj.transpose(5, 3, 4, 2, 0, 1)         # (Co, pr, pc, Ci, a, b)
    np.testing.assert_array_equal(kt, kj.reshape(4 * co, 4, 2, 3))


@pytest.mark.parametrize("hc,wc", [(4, 6), (5, 3)])
def test_shifted_upsample_concat_conv(hc, wc):
    """Against the JAX op AND against the literal upsample -> concat ->
    shifted conv, at even and odd coarse sizes."""
    rng = np.random.default_rng(6 + hc)
    cup, cskip, cout = 6, 4, 5
    h = _rand(rng, 2, hc, wc, cup)
    skip = _rand(rng, 2, 2 * hc, 2 * wc, cskip)
    w = _rand(rng, 3, 3, cup + cskip, cout, scale=0.3)
    b = _rand(rng, cout, scale=0.1)
    got = tops.shifted_upsample_concat_conv(
        _nchw(h), _nchw(skip), _oihw(w), torch.from_numpy(b))
    ref = jops.shifted_upsample_concat_conv(
        jnp.asarray(h), jnp.asarray(skip), jnp.asarray(w), jnp.asarray(b))
    _close(got, ref)
    naive = tops.conv2d(
        torch.cat([tops.upsample_2x_nearest(_nchw(h)), _nchw(skip)], dim=1),
        _oihw(w), torch.from_numpy(b), shifted=True)
    torch.testing.assert_close(got, naive, **TOL)


@pytest.mark.parametrize("k", [0, 1, 2, 3, -1, 5])
def test_rot90_non_square(k):
    rng = np.random.default_rng(7)
    x = _rand(rng, 2, 4, 6, 3)
    _close(tops.rot90(_nchw(x), k), jops.rot90(jnp.asarray(x), k))


def test_rotation_stack_unstack():
    rng = np.random.default_rng(8)
    x = _rand(rng, 2, 6, 6, 3)
    s = tops.rotation_stack(_nchw(x))
    _close(s, jops.rotation_stack(jnp.asarray(x)))
    y = _rand(rng, 8, 6, 6, 2)
    _close(tops.rotation_unstack(_nchw(y)),
           jops.rotation_unstack(jnp.asarray(y)))
    # stack then unstack returns four copies of the input along channels
    torch.testing.assert_close(tops.rotation_unstack(s),
                               torch.cat([_nchw(x)] * 4, dim=1))
    with pytest.raises(ValueError):
        tops.rotation_stack(_nchw(_rand(rng, 1, 4, 6, 1)))
    with pytest.raises(ValueError):
        tops.rotation_unstack(_nchw(_rand(rng, 3, 4, 4, 1)))


def test_conv2d_bf16_rounds_like_jax():
    """bf16 inputs: the conv output rounds to bf16, then the bias adds in
    bf16 — the JAX op's rounding points. Bar: one bf16 ulp of the output
    (2**-8 relative), as the two sides sum the taps in another order."""
    rng = np.random.default_rng(9)
    x = jnp.asarray(_rand(rng, 1, 8, 8, 8), jnp.bfloat16)
    w = _rand(rng, 3, 3, 8, 4, scale=0.3)
    b = _rand(rng, 4, scale=0.1)
    ref = jops.conv2d(x, jnp.asarray(w), jnp.asarray(b), shifted=True)
    xt = _nchw(np.asarray(x, np.float32)).bfloat16()
    got = tops.conv2d(xt, _oihw(w), torch.from_numpy(b), shifted=True)
    assert got.dtype == torch.bfloat16
    ref32 = np.asarray(ref, np.float32)
    np.testing.assert_allclose(_nhwc(got.float()), ref32, rtol=2 ** -8,
                               atol=2 ** -8 * np.abs(ref32).max())
