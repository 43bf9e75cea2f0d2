"""K1's launch plan (``kernels.shifted_conv.k1_plan``), the checks the K1
wrapper runs before a launch, and the bf16 kernel's weight packing, on the
CPU: the numbers the wrapper passes to ``csrc/shifted_conv.cu`` (which
computes the shared bytes the same way), at the layer shapes of a batch-384
training step and of a 768x512 request, at the odd input widths (Cin 1, 3,
97, 99, 144) and over a sweep of widths; then the bf16 twin against the JAX
package's Pallas kernel in interpret mode at those odd widths. The kernels
themselves run on the card (``tests/test_torch_cuda.py``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k1_probe
from ssdn_tpu.ops.pallas import shifted_conv3x3_bias_act as jax_k1
from ssdn_tpu_torch.kernels import shifted_conv as K1

BF16, F32 = torch.bfloat16, torch.float32
TRAIN = k1_probe.PATHS["train step"]     # 12 layers, batch 1536, 64x64
REQUEST = k1_probe.PATHS["request"]      # 24 layers, batch 2, 512x768, 768x512


def _covered(plan, n, h, w):
    """Pixels covered by the plan's tiles (each tile: th rows of the batch's
    n*h rows x tw columns, clipped at the edges); tiles never overlap."""
    nh = n * h
    row_tiles, col_tiles = -(-nh // plan.tile_h), -(-w // plan.tile_w)
    assert plan.tiles == row_tiles * col_tiles
    rows = sum(min(plan.tile_h, nh - r * plan.tile_h) for r in range(row_tiles))
    cols = sum(min(plan.tile_w, w - c * plan.tile_w) for c in range(col_tiles))
    return rows * cols


def _check_bf16_plan(shape):
    n, cin, h, w, cout = shape
    plan = K1.k1_plan(n, h, w, cin, cout, BF16)
    assert plan.smem <= K1.SMEM_LIMIT
    assert plan.threads == 256
    assert plan.tile_h * plan.tile_w <= plan.pixels
    assert plan.tile_w == min(w, 64) and plan.tile_h == plan.pixels // plan.tile_w
    assert _covered(plan, n, h, w) == n * h * w
    assert plan.passes * plan.cc >= cin > (plan.passes - 1) * plan.cc
    assert plan.col_blocks * plan.cols >= cout > (plan.col_blocks - 1) * plan.cols
    # one block covers up to 96 output channels: 128 pixels, else 256
    assert (plan.cols, plan.pixels) == ((48, 256) if cout <= 48 else (96, 128))
    return plan


@pytest.mark.parametrize("name,shape", TRAIN, ids=[n for n, _ in TRAIN])
def test_plan_at_the_training_shapes(name, shape):
    plan = _check_bf16_plan(shape)
    n, cin, h, w, cout = shape
    if name == "enc0":  # Cin 3: one 16-channel pass, scalar staging
        assert (plan.instantiation, plan.cc, plan.passes) == ("generic", 16, 1)
    else:  # the model's pairs: one pass over Cin, widths fixed
        assert (plan.instantiation, plan.cc, plan.passes) == ("fixed", cin, 1)
    if h == 64:  # full tiles: the tile is whole rows of the 64-wide patch
        assert plan.tile_w == 64 and plan.tile_h * 64 == plan.pixels
        assert plan.tiles == n * h // plan.tile_h
    # the two instantiations that carry 75% of the work fit two blocks per
    # SM (228 KB of shared memory, 1 KB reserved per block)
    if (cin, cout, h) in ((96, 96, 64), (48, 48, 64), (96, 96, 32)):
        assert 2 * (plan.smem + 1024) <= 228 * 1024


def test_plan_numbers_of_the_main_instantiation():
    """dec1b, 60% of the step's work: a 2 x 64 tile staged with its halo,
    4 x 66 slots of 96 + 8 bf16, the epilogue's 128 x 104 rows over it, a
    2-stage ring of 96 x 104 weight slices and a zero row."""
    plan = K1.k1_plan(1536, 64, 64, 96, 96, BF16)
    assert (plan.tile_h, plan.tile_w, plan.tiles, plan.col_blocks) == (
        2, 64, 49_152, 1)
    assert plan.smem == 2 * (4 * 66 * 104 + 2 * 96 * 104 + 104) == 95_056


@pytest.mark.parametrize("name,shape", REQUEST, ids=[n for n, _ in REQUEST])
def test_plan_at_the_request_shapes(name, shape):
    plan = _check_bf16_plan(shape)
    assert plan.instantiation == ("generic" if name.startswith("enc0")
                                  else "fixed")


@pytest.mark.parametrize("cin,cc,passes", [(1, 16, 1), (3, 16, 1),
                                           (97, 32, 4), (99, 32, 4),
                                           (144, 48, 3)])
@pytest.mark.parametrize("h,w", [(64, 64), (352, 512), (5, 7), (2, 2)])
def test_plan_at_odd_input_widths(cin, cc, passes, h, w):
    """The gray models' Cin 1, enc0's 3 and the naive decoder's dec*a (97,
    99, 144) run the generic instantiation, several passes over Cin."""
    plan = _check_bf16_plan((2, cin, h, w, 96))
    assert (plan.instantiation, plan.cc, plan.passes) == ("generic", cc, passes)


def test_no_shape_is_refused_for_shared_memory():
    """Every width and Cin/Cout K1 takes fits one block: the largest tile
    is W 1 (a column of 128 or 256 rows). Nothing the parent's kernel ran
    starts to raise."""
    for w in (*range(1, 70), 96, 127, 128, 129, 352, 768, 4096):
        for cin in (1, 3, 8, 16, 17, 48, 96, 97, 144, 512):
            for cout in (1, 16, 48, 49, 96, 200):
                plan = _check_bf16_plan((1, cin, 8, w, cout))
                K1._check_k1_launch(plan)


def test_fp32_plan_is_the_fma_kernel():
    plan = K1.k1_plan(2, 512, 768, 96, 96, F32)
    assert plan.instantiation == "fma" and plan.threads == 128
    assert plan.tiles == -(-2 * 512 * 768 // 64) and plan.col_blocks == 2
    # As[32][65] + Bs[32][48] floats and the pixel row / column tables
    assert plan.smem == 4 * (32 * 65 + 32 * 48 + 2 * 64) == 14_976


def test_launch_checks_raise_and_count_nothing():
    plan = K1.k1_plan(1536, 64, 64, 96, 96, BF16)
    before = K1.launches
    K1._check_k1_launch(plan)
    with pytest.raises(ValueError, match="shared memory"):
        K1._check_k1_launch(dataclasses.replace(plan, smem=K1.SMEM_LIMIT + 1))
    with pytest.raises(ValueError, match="grid"):
        K1._check_k1_launch(dataclasses.replace(plan, tiles=2 ** 31))
    with pytest.raises(ValueError, match="grid"):
        K1._check_k1_launch(dataclasses.replace(plan, col_blocks=65_536))
    assert K1.launches == before


@pytest.mark.parametrize("cin,cout", [(48, 48), (96, 96), (3, 48), (99, 100),
                                      (144, 96), (5, 16)])
def test_pack_weights(cin, cout):
    """The bf16 kernel's weights: slice (column block, pass, tap) is the
    (cc, cols) block of tap (dh, dw)'s (Cin, Cout) matrix, zero past Cin
    and Cout; at the model's pairs, (3, 3, Cin, Cout) as it stands."""
    plan = K1.k1_plan(2, 8, 8, cin, cout, BF16)
    w = torch.randn(cout, cin, 3, 3, generator=torch.Generator().manual_seed(0))
    packed = K1.pack_weights(w, plan)
    taps = w.to(BF16).permute(2, 3, 1, 0).reshape(9, cin, cout)
    if plan.instantiation == "fixed":
        assert packed.shape == (3, 3, cin, cout) and packed.is_contiguous()
        assert torch.equal(packed.reshape(9, cin, cout), taps)
        return
    assert packed.shape == (plan.col_blocks, plan.passes, 9, plan.cc,
                            plan.cols) and packed.is_contiguous()
    full = torch.zeros(9, plan.passes * plan.cc, plan.col_blocks * plan.cols,
                       dtype=BF16)
    full[:, :cin, :cout] = taps
    for cb in range(plan.col_blocks):
        for p in range(plan.passes):
            assert torch.equal(packed[cb, p], full[
                :, p * plan.cc:(p + 1) * plan.cc,
                cb * plan.cols:(cb + 1) * plan.cols])


# ------------------- the bf16 twin against the TPU kernel -------------------


@pytest.mark.parametrize("cin", [1, 99, 144])
def test_twin_matches_pallas_bf16_at_odd_widths(cin):
    """The twin at the widths the generic instantiation takes, against
    ``shifted_conv3x3_bias_act`` in interpret mode: one rounding of an fp32
    sum on both sides, so one bf16 ulp (2**-7 relative)."""
    rng = np.random.default_rng(20 + cin)
    x = rng.standard_normal((2, 8, 12, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, 16)) * 0.2).astype(np.float32)
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax_k1(xb, jnp.asarray(wt), jnp.asarray(b),
                            interpret=True), np.float32)
    xt = torch.from_numpy(np.asarray(xb, np.float32)).to(BF16)
    xt = xt.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    before = K1.launches
    got = K1.shifted_conv3x3_bias_act(xt, torch.from_numpy(wt).permute(3, 2, 0, 1),
                                      torch.from_numpy(b))
    assert K1.launches == before  # a CPU tensor never reaches the kernel
    assert got.dtype == BF16
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(), ref,
                               rtol=2 ** -7, atol=1e-5)
