"""The port's training-path kernels and custom backwards against the JAX
package, on the CPU:

- K1's backward (``fused_shifted_conv``, torch ops on both devices)
  against ``jax.vjp`` of the JAX ``fused_shifted_conv``;
- the twins of K2' (the forward that saves h1) and K3 (the head backward)
  against ``_fwd_call(save_h1=True)`` and ``_bwd_call`` in interpret mode;
- the ``nin_head`` autograd Function against ``jax.vjp(fused_nin_head)``;
- ``matmul_acc_f32``'s custom backward against JAX's, in bf16 operands;
- the check that a kernel launch never cuts the autograd graph.

The same numpy inputs go to both sides. fp32 bars are 1e-5: both sides
accumulate in fp32 and differ in summation order only. bf16 bars are
stated where they are used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssdn_tpu.ops.pallas.nin_head as NH
from ssdn_tpu.ops.pallas.shifted_conv import _fused_bwd
from ssdn_tpu.ops.pallas.shifted_conv import fused_shifted_conv as jax_fsc
from ssdn_tpu.ops.shifted import matmul_acc_f32 as jax_mm
from ssdn_tpu_torch.kernels import nin_head as K2
from ssdn_tpu_torch.kernels import refuse_graph_cut
from ssdn_tpu_torch.kernels import shifted_conv as K1
from ssdn_tpu_torch.models import blindspot_unet as tbu
from ssdn_tpu_torch.ops.shifted import matmul_acc_f32

TOL32 = dict(rtol=1e-5, atol=1e-5)
# bf16 tensors rounded once from an fp32 sum on each side: a different
# summation order moves a value by at most one bf16 ulp (2**-7 relative)
ULP_BF16 = dict(rtol=2 ** -7, atol=1e-6)


@pytest.fixture
def nh_interpret():
    NH.INTERPRET = True
    yield
    NH.INTERPRET = False


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype).permute(
        0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


# ------------------------------ K1 backward ------------------------------


@pytest.mark.parametrize("cin,cout,h,w", [(3, 8, 8, 12), (8, 8, 16, 8),
                                          (16, 24, 4, 4)])
def test_k1_backward_matches_jax_vjp(cin, cout, h, w):
    rng = np.random.default_rng(cin * 100 + h)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    g = rng.standard_normal((2, h, w, cout)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, k, c: jax_fsc(a, k, c), jnp.asarray(x),
                       jnp.asarray(wt), jnp.asarray(b))
    dx, dw, db = (np.asarray(t) for t in vjp(jnp.asarray(g)))

    xt = _nchw(x).requires_grad_()
    w_t = torch.from_numpy(wt).permute(3, 2, 0, 1).contiguous().requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    got = K1.fused_shifted_conv(xt, w_t, bt)
    assert got.grad_fn is not None
    got.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(got), np.asarray(out), **TOL32)
    np.testing.assert_allclose(_nhwc(xt.grad), dx, **TOL32)
    np.testing.assert_allclose(w_t.grad.permute(2, 3, 1, 0).numpy(), dw,
                               rtol=1e-5, atol=1e-5 * np.abs(dw).max())
    np.testing.assert_allclose(bt.grad.numpy(), db,
                               rtol=1e-5, atol=1e-5 * np.abs(db).max())
    assert w_t.grad.dtype == torch.float32 and xt.grad.dtype == torch.float32


def test_k1_backward_bf16_negative_zero_takes_the_slope():
    """bf16: a negative pre-activation whose LeakyReLU rounds to -0.0 must
    take the slope side of the mask (signbit, not ``out >= 0``). Both
    backwards get the same (x, w, out, g); out holds such -0.0 values.
    dx is bf16 (one ulp), dw and db fp32 (1e-5)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    x[..., 0] = rng.uniform(0.5, 2.0, (2, 8, 8))
    wt = (rng.standard_normal((3, 3, 4, 6)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(6) * 0.1).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    x = xb.float().numpy()  # the bf16 values, on both sides
    # output channel 0 reads only x[..., 0] through tap (2, 1), with a
    # weight of -2**-133 (the least bf16 subnormal): its pre-activation is
    # -x * 2**-133 (x in [0.5, 2]), and 0.1 of that rounds to -0.0 in bf16
    wt[:, :, :, 0] = 0.0
    wt[2, 1, 0, 0] = -(2.0 ** -133)
    b[0] = 0.0
    xt = _nchw(x, torch.bfloat16)
    w_t = torch.from_numpy(wt).permute(3, 2, 0, 1).contiguous()
    out = K1.torch_reference(xt, w_t, torch.from_numpy(b))
    zero = out[:, 0]
    assert (zero == 0).all() and torch.signbit(zero).all()  # the scenario
    g = rng.standard_normal((2, 8, 8, 6)).astype(np.float32)

    dx, dw, db = K1.shifted_conv_bwd(xt, w_t, out, _nchw(g))
    ref = _fused_bwd(0.1, None, False,
                     (jnp.asarray(x, jnp.bfloat16), jnp.asarray(wt),
                      jnp.asarray(_nhwc(out), jnp.bfloat16)),
                     jnp.asarray(g))
    rdx, rdw, rdb = (np.asarray(t, np.float32) for t in ref)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(dx), rdx, **ULP_BF16)
    np.testing.assert_allclose(dw.permute(2, 3, 1, 0).numpy(), rdw,
                               rtol=1e-5, atol=1e-5 * np.abs(rdw).max())
    np.testing.assert_allclose(db.numpy(), rdb, rtol=1e-5, atol=1e-6)
    # every output of channel 0 is -0.0, so its whole cotangent takes the
    # slope: db[0] is the sum of bf16(0.1 g)
    slope_g = (0.1 * torch.from_numpy(g[..., 0])).to(torch.bfloat16)
    np.testing.assert_allclose(db[0].item(), slope_g.float().sum().item(),
                               rtol=1e-5)


def test_fused_shifted_conv_inference_path_is_the_wrapper():
    rng = np.random.default_rng(2)
    xt = _nchw(rng.standard_normal((1, 8, 8, 3)))
    w_t = torch.from_numpy(rng.standard_normal((4, 3, 3, 3)).astype(
        np.float32))
    b = torch.zeros(4)
    with torch.no_grad():
        got = K1.fused_shifted_conv(xt, w_t.requires_grad_(), b)
    assert got.grad_fn is None
    torch.testing.assert_close(got, K1.torch_reference(xt, w_t, b))


# ------------------------------ K2' and K3 ------------------------------

M, C, NA, NB = 512, 16, 48, 16


def _head_inputs(seed, k, n_out, m=M, c=C, na=NA, nb=NB):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)
    xs = [f(m, c, scale=0.5) for _ in range(k)]
    xs[0][0, 0] = -0.0
    was = [f(c, na, scale=0.2) for _ in range(k)]
    return (xs, was, f(na, scale=0.1), f(na, nb, scale=0.2), f(nb, scale=0.1),
            f(nb, n_out, scale=0.2), f(n_out, scale=0.1),
            f(m, n_out, scale=1.0))


def _jax_head(args, dt):
    xs, was, ba, wb, bb, wc, bc, g = args
    lp = lambda a: jnp.asarray(a, dt)
    return (tuple(lp(x) for x in xs), tuple(lp(w) for w in was),
            jnp.asarray(ba), lp(wb), jnp.asarray(bb), lp(wc), jnp.asarray(bc),
            jnp.asarray(g))


def _torch_of(a):
    """A JAX array as a torch tensor of the same dtype and values."""
    dt = torch.bfloat16 if a.dtype == jnp.bfloat16 else torch.float32
    return torch.from_numpy(np.array(a, np.float32)).to(dt).contiguous()


def _head_bar(ref, dtype):
    """fp32: 1e-5 of the tensor's range. bf16: h1, h2, dpre1, dpre2 and
    lrelu(x) are rounded to bf16 on both sides, and JAX scales the input
    LeakyReLU by bf16(0.1) where the port uses fp32 0.1 before its one
    rounding; one flipped rounding (2**-8) moves a result, so the bar is
    2**-6 of the tensor's range (PR 1's K2 bar)."""
    return (1e-5 if dtype == jnp.float32 else 2 ** -6) * max(
        float(np.abs(ref).max()), 1e-30)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("k", [1, 4])
def test_k2_save_h1_twin_matches_pallas(nh_interpret, dtype, k):
    xs, was, ba, wb, bb, wc, bc, _ = _jax_head(_head_inputs(k, k, 9), dtype)
    out, h1 = NH._fwd_call(xs, was, ba[None], wb, bb[None], wc, bc[None],
                           tm=256, interpret=True, save_h1=True)
    tx, tw = [_torch_of(x) for x in xs], [_torch_of(w) for w in was]
    before = (K2.launches, K2.launches_save_h1)
    got, got_h1 = K2.nin_head_fwd(tx, tw, _torch_of(ba), _torch_of(wb),
                                  _torch_of(bb), _torch_of(wc), _torch_of(bc),
                                  save_h1=True)
    assert (K2.launches, K2.launches_save_h1) == before  # CPU: the twin
    assert got_h1.dtype == tx[0].dtype and got_h1.shape == (M, NA)
    ref_h1 = np.asarray(h1, np.float32)
    np.testing.assert_allclose(got_h1.float().numpy(), ref_h1, rtol=0,
                               atol=_head_bar(ref_h1, dtype))
    ref = np.asarray(out)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=_head_bar(ref, dtype))
    _, none = K2.nin_head_fwd(tx, tw, _torch_of(ba), _torch_of(wb),
                              _torch_of(bb), _torch_of(wc), _torch_of(bc),
                              save_h1=False)
    assert none is None


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("k", [1, 4])
def test_k3_twin_matches_pallas(nh_interpret, dtype, k):
    """Every output of the head backward against the TPU kernel, both fed
    the same h1 (the JAX forward's)."""
    xs, was, ba, wb, bb, wc, bc, g = _jax_head(_head_inputs(10 + k, k, 9),
                                               dtype)
    _, h1 = NH._fwd_call(xs, was, ba[None], wb, bb[None], wc, bc[None],
                         tm=256, interpret=True, save_h1=True)
    ref = NH._bwd_call(xs, was, h1, wb, bb[None], wc, g, tm=256,
                       interpret=True)
    before = K2.launches_bwd
    dxs, dwas, dba, dwb, dbb, dwc, dbc = K2.nin_head_bwd(
        [_torch_of(x) for x in xs], [_torch_of(w) for w in was],
        _torch_of(h1), _torch_of(wb), _torch_of(bb), _torch_of(wc),
        _torch_of(g))
    assert K2.launches_bwd == before
    got = [*dxs, *dwas, dba, dwb, dbb, dwc, dbc]
    assert len(got) == len(ref)
    for i, (t, r) in enumerate(zip(got, ref)):
        r = np.asarray(r, np.float32).reshape(t.shape)
        want = xs[0].dtype if i < k else jnp.float32
        assert (t.dtype == torch.bfloat16) == (want == jnp.bfloat16), i
        np.testing.assert_allclose(t.float().numpy(), r, rtol=0,
                                   atol=_head_bar(r, dtype), err_msg=str(i))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_k3_twin_matches_pallas_at_narrow_widths(nh_interpret, dtype):
    """The head backward at widths that are not multiples of 16 (C 40,
    Na 72, Nb 24, Nc 3; k 2), which the bf16 tensor-core kernels pad in
    shared memory: the twin against the TPU kernel, at
    ``test_k3_twin_matches_pallas``'s bars."""
    k, c, na, nb = 2, 40, 72, 24
    xs, was, ba, wb, bb, wc, bc, g = _jax_head(
        _head_inputs(30, k, 3, c=c, na=na, nb=nb), dtype)
    _, h1 = NH._fwd_call(xs, was, ba[None], wb, bb[None], wc, bc[None],
                         tm=256, interpret=True, save_h1=True)
    ref = NH._bwd_call(xs, was, h1, wb, bb[None], wc, g, tm=256,
                       interpret=True)
    got = K2.nin_head_bwd(
        [_torch_of(x) for x in xs], [_torch_of(w) for w in was],
        _torch_of(h1), _torch_of(wb), _torch_of(bb), _torch_of(wc),
        _torch_of(g))
    got = [*got[0], *got[1], *got[2:]]
    shapes = [(M, c)] * k + [(c, na)] * k + [(na,), (na, nb), (nb,),
                                             (nb, 3), (3,)]
    assert [tuple(t.shape) for t in got] == shapes
    for i, (t, r) in enumerate(zip(got, ref)):
        r = np.asarray(r, np.float32).reshape(t.shape)
        np.testing.assert_allclose(t.float().numpy(), r, rtol=0,
                                   atol=_head_bar(r, dtype), err_msg=str(i))


@pytest.mark.parametrize("widths", [dict(c=3), dict(c=99),
                                    dict(nb=200, n_out=40),
                                    dict(c=5, na=70, nb=30, n_out=3)],
                         ids=["c3", "c99", "nb200-nc40", "c5-na70-nb30"])
def test_k3_twin_matches_pallas_fp32_at_unaligned_widths(nh_interpret,
                                                        widths):
    """The fp32 twin of K3 against ``_bwd_call`` in interpret mode at the
    widths the fp32 FMA kernels take in their slow ways (the card tests hold
    the kernels against this twin there): C 3 and 99, whose rows move in
    4-byte pieces and whose dx chunks straddle branches, Nb 200 with Nc 40
    (three passes over Nb, three groups of Nc), and C, Na, Nb that are not
    multiples of 4 (every operand in 4-byte pieces). Every output at 1e-5
    of its range (summation order only)."""
    w = dict(dict(c=C, na=NA, nb=NB, n_out=9), **widths)
    n_out = w.pop("n_out")
    k = 2
    xs, was, ba, wb, bb, wc, bc, g = _jax_head(
        _head_inputs(40 + w["c"], k, n_out, **w), jnp.float32)
    _, h1 = NH._fwd_call(xs, was, ba[None], wb, bb[None], wc, bc[None],
                         tm=256, interpret=True, save_h1=True)
    ref = NH._bwd_call(xs, was, h1, wb, bb[None], wc, g, tm=256,
                       interpret=True)
    got = K2.nin_head_bwd(
        [_torch_of(x) for x in xs], [_torch_of(v) for v in was],
        _torch_of(h1), _torch_of(wb), _torch_of(bb), _torch_of(wc),
        _torch_of(g))
    got = [*got[0], *got[1], *got[2:]]
    c, na, nb = w["c"], w["na"], w["nb"]
    shapes = [(M, c)] * k + [(c, na)] * k + [(na,), (na, nb), (nb,),
                                             (nb, n_out), (n_out,)]
    assert [tuple(t.shape) for t in got] == shapes
    for i, (t, r) in enumerate(zip(got, ref)):
        r = np.asarray(r, np.float32).reshape(t.shape)
        assert t.dtype == torch.float32, i
        np.testing.assert_allclose(t.numpy(), r, rtol=0,
                                   atol=_head_bar(r, jnp.float32),
                                   err_msg=str(i))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("k", [1, 4])
def test_nin_head_function_matches_jax_vjp(nh_interpret, dtype, k):
    """The autograd Function against jax.vjp of the JAX custom VJP: the
    output, dx_i in x's dtype, the weight grads in the weights' dtype
    (``_head_bwd`` casts them), the bias grads in fp32. fp32: 1e-5 of each
    tensor's range. bf16: each side runs its own forward, and where the
    two round h1 differently a near-zero h1 can fall on the other side of
    the backward's mask (a factor 10 on that element); the bar is a
    relative L2 error of 2**-5 per tensor."""
    args = _jax_head(_head_inputs(20 + k, k, 9), dtype)
    xs, was, ba, wb, bb, wc, bc, g = args
    out, vjp = jax.vjp(NH.fused_nin_head, xs, was, ba, wb, bb, wc, bc)
    jdx, jdwa, jdba, jdwb, jdbb, jdwc, jdbc = vjp(g)
    leaves = ([_torch_of(x) for x in xs], [_torch_of(w) for w in was],
              *[_torch_of(a) for a in (ba, wb, bb, wc, bc)])
    for t in (*leaves[0], *leaves[1], *leaves[2:]):
        t.requires_grad_(True)
    before = K2.launches
    got = K2.nin_head(*leaves)
    assert got.grad_fn is not None and K2.launches == before
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=0,
                               atol=_head_bar(np.asarray(out), dtype))
    got.backward(_torch_of(g))
    pairs = (list(zip(leaves[0], jdx)) + list(zip(leaves[1], jdwa))
             + list(zip(leaves[2:], (jdba, jdwb, jdbb, jdwc, jdbc))))
    for i, (t, r) in enumerate(pairs):
        assert t.grad.dtype == t.dtype, i
        r = np.asarray(r, np.float32)
        got_i = t.grad.float().numpy()
        if dtype == jnp.float32:
            np.testing.assert_allclose(got_i, r, rtol=0,
                                       atol=_head_bar(r, dtype),
                                       err_msg=str(i))
        else:
            err = np.linalg.norm(got_i - r) / np.linalg.norm(r)
            assert err <= 2 ** -5, (i, err)


def test_nin_head_without_grad_is_the_inference_forward():
    xs, was, ba, wb, bb, wc, bc, _ = (
        [torch.from_numpy(a) for a in v] if isinstance(v, list)
        else torch.from_numpy(v) for v in _head_inputs(3, 2, 4))
    with torch.no_grad():
        got = K2.nin_head(xs, was, ba, wb.requires_grad_(), bb, wc, bc)
    assert got.grad_fn is None
    torch.testing.assert_close(got, K2.torch_reference(xs, was, ba, wb, bb,
                                                       wc, bc))


def test_k3_wrapper_validation():
    xs, was, ba, wb, bb, wc, bc, g = (
        [torch.from_numpy(a) for a in v] if isinstance(v, list)
        else torch.from_numpy(v) for v in _head_inputs(4, 2, 3, m=64))
    h1 = torch.zeros(64, NA)
    K2._check(xs, was, None, wb, bb, wc, None, h1=h1, g=g)  # valid
    with pytest.raises(ValueError):
        K2._check(xs, was, None, wb, bb, wc, None, h1=h1[:, :8], g=g)
    with pytest.raises(ValueError):
        K2._check(xs, was, None, wb, bb, wc, None, h1=h1, g=g.double())
    with pytest.raises(ValueError):
        K2._check(xs, was, None, wb, bb, wc, None, h1=h1.bfloat16(), g=g)
    with pytest.raises(ValueError, match="cuda or cpu"):
        K2.nin_head_bwd([x.to("meta") for x in xs], was, h1, wb, bb, wc, g)
    assert K2.bwd_splits(1) == 1 and K2.bwd_splits(4097) == 2
    assert K2.bwd_splits(64 * 64 * 384) == 64


# ------------------------- matmul_acc_f32 and graph -------------------------


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
def test_matmul_acc_f32_grads_match_jax(dtype):
    """The custom backward: the cotangent cast to x's dtype, dx in x's
    dtype (bf16: one ulp), dw accumulated in fp32 (1e-5). w is handed over
    in its low-precision values, so both sides multiply the same numbers;
    on the port's side it stays an fp32 leaf, as the model's parameter."""
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.standard_normal((2, 4, 4, 24)), dtype)
    w = jnp.asarray(rng.standard_normal((24, 9)) * 0.2, dtype)
    g = rng.standard_normal((2, 4, 4, 9)).astype(np.float32)
    out, vjp = jax.vjp(jax_mm, x, w)
    dx, dw = vjp(jnp.asarray(g))
    assert out.dtype == jnp.float32 and dw.dtype == jnp.float32
    xt = _torch_of(x).requires_grad_()
    wt = torch.from_numpy(np.asarray(w, np.float32)).requires_grad_()
    got = matmul_acc_f32(xt, wt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL32)
    got.backward(torch.from_numpy(g))
    assert xt.grad.dtype == xt.dtype and wt.grad.dtype == torch.float32
    bar = ULP_BF16 if dtype == jnp.bfloat16 else TOL32
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(dx, np.float32), **bar)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw), **TOL32)


def test_refuse_graph_cut_logic():
    """The check the CUDA wrappers run before a launch: refuse when
    autograd records and an input requires grad, allow otherwise."""
    a, b = torch.zeros(3), torch.zeros(3, requires_grad=True)
    refuse_graph_cut("K", a)  # nothing requires grad
    with pytest.raises(RuntimeError, match="fused_shifted_conv / nin_head"):
        refuse_graph_cut("K", a, b)
    with torch.no_grad():
        refuse_graph_cut("K", a, b)  # grad mode off
    with torch.inference_mode():
        refuse_graph_cut("K", a, b)


@pytest.mark.parametrize("conv,head", [("lax", "lax"), ("lax", "pallas"),
                                       ("pallas", "lax")])
def test_apply_gives_every_leaf_a_gradient(conv, head):
    """Through every arm, loss.backward() reaches every parameter: no
    kernel arm cuts the graph (each leaf's grad is finite and non-zero)."""
    params = tbu.init_params(torch.Generator().manual_seed(1), 3, 9,
                             enc=8, dec=16, nin_a=32, nin_b=16)
    for leaf in params.values():
        leaf["b"] += 0.05
        for t in leaf.values():
            t.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 32, 32, 3)).astype(np.float32))
    out = tbu.apply(params, x, compute_dtype=torch.float32,
                    conv_backend=conv, head_backend=head)
    (out ** 2).mean().backward()
    for name, leaf in params.items():
        for key, t in leaf.items():
            assert t.grad is not None, (name, key)
            assert torch.isfinite(t.grad).all() and t.grad.abs().max() > 0, \
                (name, key)
