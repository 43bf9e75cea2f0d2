"""The port's blind-spot U-Net (ssdn_tpu_torch.models.blindspot_unet)
against the JAX package's, on the CPU at narrow widths.

Both sides get the same numpy weights (the JAX HWIO tree, carried to the
port by ``params_from_jax``) and the same numpy input. The bar on the
output is 1e-4 (rtol and atol) in fp32: 17 stacked convs and the head,
each fp32 on both sides, differ only in summation order. The JAX side
runs its Pallas kernels in interpret mode (K1 interprets on its own off
the TPU; K2 through ``nin_head.INTERPRET``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ssdn_tpu.ops.pallas.nin_head as NH
from ssdn_tpu.models import blindspot_unet as jbu
from ssdn_tpu_torch.kernels import nin_head as K2
from ssdn_tpu_torch.kernels import shifted_conv as K1
from ssdn_tpu_torch.models import blindspot_unet as tbu

NARROW = dict(enc=8, dec=16, nin_a=32, nin_b=16)
TOL = dict(rtol=1e-4, atol=1e-4)
ARMS = {  # (conv_backend, head_backend)
    "lax": ("lax", "lax"),
    "head_pallas": ("lax", "pallas"),
    "conv_pallas": ("pallas", "lax"),
}


@pytest.fixture(autouse=True)
def _nh_interpret():
    NH.INTERPRET = True
    yield
    NH.INTERPRET = False


def numpy_tree(seed, c, n_out, blindspot=True, **widths):
    """He-normal weights and small non-zero biases, as the JAX HWIO tree."""
    rng = np.random.default_rng(seed)
    shapes = jbu.layer_shapes(c, blindspot=blindspot, n_out=n_out,
                              **(widths or NARROW))
    tree = {}
    for name, (kh, kw, cin, cout) in shapes.items():
        std = np.sqrt(2.0 / (kh * kw * cin))
        tree[name] = {
            "w": (rng.standard_normal((kh, kw, cin, cout)) * std
                  ).astype(np.float32),
            "b": (rng.standard_normal(cout) * 0.05).astype(np.float32),
        }
    return tree


def run_both(tree, x, **kw):
    jp = {k: {n: jnp.asarray(v) for n, v in leaf.items()}
          for k, leaf in tree.items()}
    ref = np.asarray(jbu.apply(jp, jnp.asarray(x), compute_dtype=jnp.float32,
                               **kw))
    tp = tbu.params_from_jax(tree, device="cpu")
    got = tbu.apply(tp, torch.from_numpy(x), compute_dtype=torch.float32, **kw)
    return got.numpy(), ref


CASES = [
    # arm, (B, H, W, C), blindspot, decoder_mode
    ("lax", (1, 32, 32, 3), True, "fused"),
    ("lax", (1, 32, 64, 1), True, "fused"),
    ("lax", (1, 32, 32, 1), True, "naive"),
    ("lax", (1, 64, 32, 3), False, "fused"),
    ("head_pallas", (1, 32, 32, 1), True, "fused"),
    ("head_pallas", (1, 32, 64, 3), True, "fused"),
    ("head_pallas", (1, 32, 32, 3), False, "fused"),
    ("head_pallas", (2, 32, 32, 1), True, "naive"),
    ("conv_pallas", (2, 32, 32, 3), True, "fused"),
    ("conv_pallas", (1, 64, 32, 1), True, "fused"),
    ("conv_pallas", (1, 32, 32, 3), True, "naive"),
    ("conv_pallas", (1, 32, 32, 1), False, "naive"),
]


@pytest.mark.parametrize("arm,shape,blindspot,decoder_mode", CASES)
def test_apply_matches_jax(arm, shape, blindspot, decoder_mode):
    c = shape[-1]
    n_out = 2 if c == 1 else 9
    tree = numpy_tree(sum(shape) + len(arm), c, n_out, blindspot)
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    conv_backend, head_backend = ARMS[arm]
    got, ref = run_both(tree, x, blindspot=blindspot,
                        conv_backend=conv_backend, head_backend=head_backend,
                        decoder_mode=decoder_mode)
    assert got.shape == shape[:3] + (n_out,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, **TOL)


def test_apply_bf16_trunk_close_to_jax():
    """bf16 trunk with the fp32 nin_c: the two frameworks round at the same
    points but sum in another order, and 17 bf16 layers compound one-ulp
    (2**-8) differences. Bar: 5% of the output's range."""
    tree = numpy_tree(3, 3, 9)
    x = np.random.default_rng(2).standard_normal((1, 32, 32, 3)
                                                 ).astype(np.float32)
    jp = {k: {n: jnp.asarray(v) for n, v in leaf.items()}
          for k, leaf in tree.items()}
    ref = np.asarray(jbu.apply(jp, jnp.asarray(x),
                               compute_dtype=jnp.bfloat16))
    got = tbu.apply(tbu.params_from_jax(tree, device="cpu"),
                    torch.from_numpy(x), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=0.05 * np.abs(ref).max())


@pytest.mark.parametrize("arm", list(ARMS))
def test_blindspot_invariant(arm):
    """Finite +100 bumps (not gradients: max-pool gradients are argmax-
    sparse): the output at a bumped pixel is bit-identical, the bump moves
    some output, and each 4-neighbour of an interior pixel has influence."""
    conv_backend, head_backend = ARMS[arm]
    params = tbu.params_from_jax(numpy_tree(4, 1, 2), device="cpu")

    def fn(x):
        return tbu.apply(params, torch.from_numpy(x), compute_dtype=torch.float32,
                         conv_backend=conv_backend,
                         head_backend=head_backend).numpy()

    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 32, 32, 1)).astype(np.float32)
    base = fn(x)
    assert np.isfinite(base).all()
    pixels = [(0, 0), (0, 31), (31, 0), (31, 31), (15, 17), (16, 16)]
    pixels += [tuple(rng.integers(0, 32, 2)) for _ in range(4)]
    for r, c in pixels:
        xb = x.copy()
        xb[0, r, c, 0] += 100.0
        out = fn(xb)
        assert np.all(out[0, r, c] == base[0, r, c]), f"leak at {(r, c)}"
        assert np.any(out != base), f"bump at {(r, c)} had no effect"
    r, c = 15, 17
    for dr, dc in [(-1, 0), (1, 0), (0, -1), (0, 1)]:
        xb = x.copy()
        xb[0, r + dr, c + dc, 0] += 100.0
        assert np.any(fn(xb)[0, r, c] != base[0, r, c]), (dr, dc)


def test_routing_rules():
    """apply's backend routing, read from the kernels' dispatch: the head
    kernel only off the pallas conv path, 12 shifted convs per trunk call
    on it, and the two-trunk fold for non-square inputs. On the CPU the
    wrappers run their twins, so the calls are counted by wrapping them."""
    params = tbu.params_from_jax(numpy_tree(5, 1, 2), device="cpu")
    calls = {"k1": 0, "k2": 0}
    k1, k2 = tbu.fused_shifted_conv, tbu.nin_head

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    tbu.fused_shifted_conv = count("k1", k1)
    tbu.nin_head = count("k2", k2)
    try:
        for shape, conv, head, k1_calls, k2_calls in [
            ((1, 32, 32, 1), "pallas", "pallas", 12, 0),
            ((1, 32, 64, 1), "pallas", "lax", 24, 0),
            ((1, 32, 32, 1), "lax", "pallas", 0, 1),
            ((1, 64, 32, 1), "lax", "lax", 0, 0),
        ]:
            calls.update(k1=0, k2=0)
            tbu.apply(params, torch.zeros(shape), compute_dtype=torch.float32,
                      conv_backend=conv, head_backend=head)
            assert (calls["k1"], calls["k2"]) == (k1_calls, k2_calls), shape
    finally:
        tbu.fused_shifted_conv, tbu.nin_head = k1, k2
    assert K1.launches == 0 and K2.launches == 0  # no CUDA launch on the CPU


def test_shapes_counts_and_reach_match_jax():
    for c, n_out, bs in [(3, 9, True), (1, 2, True), (3, 3, False)]:
        assert tbu.layer_shapes(c, blindspot=bs, n_out=n_out) == \
            jbu.layer_shapes(c, blindspot=bs, n_out=n_out)
    params = tbu.init_params(torch.Generator().manual_seed(0), 3, 9)
    assert tbu.param_count(params) == sum(
        int(np.prod(s)) + s[-1]
        for s in jbu.layer_shapes(3, n_out=9).values())
    assert 1_000_000 <= tbu.param_count(params) <= 1_300_000
    assert params["enc0"]["w"].shape == (48, 3, 3, 3)  # OIHW
    assert tbu.STRIDE == jbu.STRIDE == 32
    assert tbu.one_sided_causal_reach() == jbu.one_sided_causal_reach() == 315
    for a in (0, 7, 31):
        assert tbu.one_sided_causal_reach(a) == jbu.one_sided_causal_reach(a)


def test_params_round_trip():
    tree = numpy_tree(6, 3, 10)
    tree["noise_scalar"] = {"raw": np.float32(-1.5)}
    params = tbu.params_from_jax(tree, device="cpu")
    assert params["dec1b"]["w"].shape == (16, 16, 3, 3)
    assert params["noise_scalar"]["raw"].item() == -1.5
    back = tbu.params_to_jax(params)
    for name, leaf in tree.items():
        for key, v in leaf.items():
            np.testing.assert_array_equal(back[name][key], v)


def test_init_params_generator_and_device():
    g = torch.Generator().manual_seed(7)
    a = tbu.init_params(g, 1, 2, **NARROW)
    b = tbu.init_params(torch.Generator().manual_seed(7), 1, 2, **NARROW)
    for name in a:
        torch.testing.assert_close(a[name]["w"], b[name]["w"], rtol=0, atol=0)
        assert torch.all(a[name]["b"] == 0)
    std = a["enc1"]["w"].std().item()
    assert 0.5 * np.sqrt(2 / 72) < std < 1.5 * np.sqrt(2 / 72)


def test_rejects_bad_spatial_dims_and_missing_gpu():
    params = tbu.params_from_jax(numpy_tree(8, 1, 2), device="cpu")
    with pytest.raises(ValueError):
        tbu.apply(params, torch.zeros(1, 48, 48, 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tbu.params_from_jax(numpy_tree(8, 1, 2))
