"""The port's kernels K1 (shifted conv) and K2 (fused 1x1 head), and K3
(the head's backward) at ragged M.

On the CPU each wrapper computes its plain PyTorch twin, and the twins are
held here against the JAX package's Pallas kernels run in interpret mode —
the same inputs, from np.random.default_rng, on both sides. The CUDA
kernels themselves run only on the card, where ``tests/test_torch_cuda.py``
holds them against their twins. Nothing in ssdn_tpu changes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssdn_tpu.ops.pallas.nin_head as NH
from ssdn_tpu.ops.pallas import shifted_conv3x3_bias_act as jax_k1
from ssdn_tpu_torch.kernels import nin_head as K2
from ssdn_tpu_torch.kernels import shifted_conv as K1

# fp32 twins vs the interpret-mode kernels: both accumulate in fp32, only
# the summation order differs
TOL32 = dict(rtol=1e-5, atol=1e-5)
# bf16 K1 output: one rounding of an fp32 sum on both sides, so a different
# summation order moves a value by at most one bf16 ulp (2**-7 relative)
K1_BF16 = dict(rtol=2 ** -7, atol=1e-5)


@pytest.fixture
def nh_interpret():
    NH.INTERPRET = True
    yield
    NH.INTERPRET = False


def _k1_inputs(seed, n, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, wt, b


def _k1_torch(x, wt, b, dtype=torch.float32, device="cpu"):
    xt = torch.from_numpy(x).to(device, dtype).permute(0, 3, 1, 2)
    xt = xt.contiguous(memory_format=torch.channels_last)
    return (xt, torch.from_numpy(wt).permute(3, 2, 0, 1).to(device),
            torch.from_numpy(b).to(device))


@pytest.mark.parametrize("cin,cout,h,w", [(1, 8, 8, 12), (3, 16, 12, 8),
                                          (48, 24, 8, 16)])
def test_k1_twin_matches_pallas_fp32(cin, cout, h, w):
    x, wt, b = _k1_inputs(cin, 2, h, w, cin, cout)
    ref = np.asarray(jax_k1(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
                            interpret=True))
    before = K1.launches
    got = K1.shifted_conv3x3_bias_act(*_k1_torch(x, wt, b))
    assert K1.launches == before  # a CPU tensor never reaches the kernel
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, **TOL32)


@pytest.mark.parametrize("cin", [3, 48])
def test_k1_twin_matches_pallas_bf16(cin):
    x, wt, b = _k1_inputs(10 + cin, 2, 8, 12, cin, 16)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax_k1(xb, jnp.asarray(wt), jnp.asarray(b),
                            interpret=True), np.float32)
    got = K1.torch_reference(
        *_k1_torch(np.asarray(xb, np.float32), wt, b, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(), ref,
                               **K1_BF16)


def test_k1_causal_up_geometry():
    """A bump on row 5 changes no output row above it (rows r-2..r only)."""
    x, wt, b = _k1_inputs(3, 1, 8, 8, 2, 3)
    base = K1.torch_reference(*_k1_torch(x, wt, b))
    x[0, 5] += 100.0
    out = K1.torch_reference(*_k1_torch(x, wt, b))
    diff = (out - base).abs().amax(dim=(0, 1, 3))
    assert torch.all(diff[:5] == 0) and torch.all(diff[5:] > 0)


def test_k1_wrapper_validation():
    x, wt, b = _k1_torch(*_k1_inputs(4, 1, 4, 4, 3, 5))
    K1._check(x, wt, b)  # a valid call passes
    with pytest.raises(TypeError):
        K1._check(x.double(), wt, b)
    with pytest.raises(ValueError):
        K1._check(x.contiguous(), wt, b)  # NCHW memory
    with pytest.raises(ValueError):
        K1._check(x, wt[:, :2], b)
    with pytest.raises(ValueError):
        K1._check(x, wt, b[:3])
    with pytest.raises(ValueError, match="cuda or cpu"):
        K1.shifted_conv3x3_bias_act(x.to("meta"), wt.to("meta"),
                                    b.to("meta"))


def _k2_inputs(seed, m, k, n_out, c=96, na=384, nb=96):
    rng = np.random.default_rng(seed)
    xs = [(rng.standard_normal((m, c)) * 0.5).astype(np.float32)
          for _ in range(k)]
    was = [(rng.standard_normal((c, na)) * 0.05).astype(np.float32)
           for _ in range(k)]
    ba = (rng.standard_normal(na) * 0.1).astype(np.float32)
    wb = (rng.standard_normal((na, nb)) * 0.05).astype(np.float32)
    bb = (rng.standard_normal(nb) * 0.1).astype(np.float32)
    wc = (rng.standard_normal((nb, n_out)) * 0.1).astype(np.float32)
    bc = (rng.standard_normal(n_out) * 0.1).astype(np.float32)
    xs[0][0, 0] = -0.0  # the LeakyReLU compare must send -0.0 the JAX way
    return xs, was, ba, wb, bb, wc, bc


def _k2_jax(args, dtype=jnp.float32):
    xs, was, ba, wb, bb, wc, bc = args
    lp = lambda a: jnp.asarray(a, dtype)
    return ((tuple(lp(x) for x in xs), tuple(lp(w) for w in was),
             jnp.asarray(ba), lp(wb), jnp.asarray(bb), lp(wc),
             jnp.asarray(bc)))


def _k2_torch(jargs, device="cpu"):
    """The JAX operands, value for value, as torch tensors (so bf16 inputs
    are the same rounded numbers on both sides)."""
    xs, was, ba, wb, bb, wc, bc = jargs
    lp = torch.bfloat16 if xs[0].dtype == jnp.bfloat16 else torch.float32
    conv = lambda a, dt: torch.from_numpy(np.array(a, np.float32)).to(
        device, dt).contiguous()
    return ([conv(x, lp) for x in xs], [conv(w, lp) for w in was],
            conv(ba, torch.float32), conv(wb, lp), conv(bb, torch.float32),
            conv(wc, lp), conv(bc, torch.float32))


@pytest.mark.parametrize("k,n_out", [(1, 2), (4, 9), (4, 10), (1, 10)])
def test_k2_twin_matches_pallas_fp32(nh_interpret, k, n_out):
    jargs = _k2_jax(_k2_inputs(k * 10 + n_out, 512, k, n_out))
    ref = np.asarray(NH.fused_nin_head(*jargs))
    before = K2.launches
    got = K2.fused_nin_head(*_k2_torch(jargs))
    assert K2.launches == before
    assert got.dtype == torch.float32 and got.shape == (512, n_out)
    np.testing.assert_allclose(got.numpy(), ref, **TOL32)


@pytest.mark.parametrize("k,n_out", [(4, 9), (1, 2)])
def test_k2_twin_matches_pallas_bf16(nh_interpret, k, n_out):
    """bf16: h1 and h2 are rounded to bf16 on both sides, and JAX scales
    the input LeakyReLU by bf16(0.1) where torch uses fp32 0.1 before its
    one rounding, so single elements of lrelu(x), h1 and h2 can differ by
    one bf16 ulp (2**-8 relative). Bar: 2**-6 of the output's range."""
    jargs = _k2_jax(_k2_inputs(50 + k, 512, k, n_out), jnp.bfloat16)
    ref = np.asarray(NH.fused_nin_head(*jargs))
    got = K2.fused_nin_head(*_k2_torch(jargs)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2 ** -6 * np.abs(ref).max())


# ragged M the card tests run the head kernels at: part-filled 128-row
# tiles (1 to 129, 1,000, 4,133), one weight-grad split of 4,095 rows and
# two of 2,049 + 2,048 (K3); none is a multiple of 256, the Pallas kernel's
# tile rule
RAGGED_M = [1, 63, 65, 127, 129, 300, 1000, 4133]
K3_RAGGED_M = [1, 63, 65, 127, 129, 4095, 4097, 4133]


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("m", RAGGED_M)
def test_k2_twin_ragged_m_matches_lax_reference(m, k):
    """An M that is no multiple of 256 (the Pallas kernel's tile rule):
    the twin against the JAX oracle ``lax_reference`` at fp32."""
    jargs = _k2_jax(_k2_inputs(m, m, k, 10))
    ref = np.asarray(NH.lax_reference(*jargs))
    got = K2.fused_nin_head(*_k2_torch(jargs))
    np.testing.assert_allclose(got.numpy(), ref, **TOL32)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("m", K3_RAGGED_M)
def test_k3_twin_ragged_m_matches_lax_reference(m, k):
    """The twin of K3 at ragged M: dx_i, the weight grads and the bias
    grads against ``jax.vjp`` of the JAX oracle ``lax_reference`` at fp32
    (summation order only). The twin is fed h1 as ``lax_reference``
    computes it, so both sides mask the same elements of pre1 (the twin of
    K2''s h1 sums in another order, and one element near zero flips a row
    of dx_i by a factor 10). dx_i, sums over one row, at ``TOL32``; the
    weight and bias grads, sums over M rows, at 1e-5 of each one's range
    (``test_torch_train_kernels.py``'s fp32 bar: over 4,000 rows the order
    moves an element near zero by ~2e-5)."""
    jargs = _k2_jax(_k2_inputs(m + k, m, k, 10))
    g = np.random.default_rng(m).standard_normal((m, 10)).astype(np.float32)
    _, vjp = jax.vjp(NH.lax_reference, *jargs)
    jdx, jdwa, *jrest = vjp(jnp.asarray(g))
    jxs, jwas, jba = jargs[:3]
    h1 = NH._lrelu(jnp.dot(NH._lrelu(jnp.concatenate(jxs, axis=-1)),
                           jnp.concatenate(jwas, axis=0)) + jba)
    xs, was, _, wb, bb, wc, _ = _k2_torch(jargs)
    before = K2.launches_bwd
    dxs, dwas, dba, dwb, dbb, dwc, dbc = K2.nin_head_bwd(
        xs, was, torch.from_numpy(np.array(h1)), wb, bb, wc,
        torch.from_numpy(g))
    assert K2.launches_bwd == before  # CPU: the twin
    got = [*dxs, *dwas, dba, dwb, dbb, dwc, dbc]
    ref = [*jdx, *jdwa, *jrest]
    assert len(got) == len(ref) == 2 * k + 5
    for i, (t, r) in enumerate(zip(got, ref)):
        assert t.dtype == torch.float32 and t.shape == r.shape, i
        r = np.asarray(r)
        tol = TOL32 if i < k else dict(rtol=0, atol=1e-5 * np.abs(r).max())
        np.testing.assert_allclose(t.numpy(), r, **tol, err_msg=str(i))


def test_k2_wrapper_validation():
    xs, was, ba, wb, bb, wc, bc = _k2_torch(_k2_jax(_k2_inputs(7, 64, 2, 3)))
    K2._check(xs, was, ba, wb, bb, wc, bc)  # a valid call passes
    with pytest.raises(ValueError, match="branches"):
        K2._check(xs * 3, was * 3, ba, wb, bb, wc, bc)
    with pytest.raises(ValueError):
        K2._check(xs, was, ba.bfloat16(), wb, bb, wc, bc)
    with pytest.raises(ValueError):
        K2._check(xs, was, ba, wb.t(), bb, wc, bc)  # wrong shape
    with pytest.raises(ValueError, match="contiguous"):
        K2._check([x.t().contiguous().t() for x in xs], was, ba, wb, bb,
                  wc, bc)
    with pytest.raises(TypeError):
        K2._check([x.double() for x in xs], was, ba, wb, bb, wc, bc)

