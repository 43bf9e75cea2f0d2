"""K1's launch plan (``kernels.shifted_conv.k1_plan``), the checks the K1
wrapper runs before a launch, and both kernels' weight packing, on the
CPU: the numbers the wrapper passes to ``csrc/shifted_conv.cu`` (which
computes the shared bytes the same way), at the layer shapes of a batch-384
training step and of a 768x512 request, at the odd input widths (Cin 1, 3,
97, 99, 144) and over a sweep of widths, in both dtypes; then the bf16 twin
against the JAX package's Pallas kernel in interpret mode at those odd
widths. The kernels themselves run on the card
(``tests/test_torch_cuda.py``)."""

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
    """dec1b of a request: one block covers all 96 output channels (128
    pixels as an 8 x 16 tile), staged with its halo: 10 x 18 slots of 96 +
    4 floats, a 3-stage ring of 32 x 96 weight rows and a zero row; two
    blocks share an SM."""
    plan = K1.k1_plan(2, 512, 768, 96, 96, F32)
    assert plan.instantiation == "fma" and plan.threads == 256
    assert (plan.cols, plan.col_blocks, plan.pixels) == (96, 1, 128)
    assert (plan.tile_h, plan.tile_w) == (8, 16)
    assert plan.tiles == (2 * 512 // 8) * (768 // 16) == 6144
    assert (plan.cc, plan.passes, plan.kr) == (96, 1, 32)
    assert plan.smem == 4 * (10 * 18 * 100 + 3 * 32 * 96 + 100) == 109_264
    assert plan.blocks_per_sm == 2


def _check_fp32_plan(shape):
    """The fp32 plan's invariants: one block holds its halo'd tile, ring
    and zero row, as many blocks share an SM as the plan says, the grid is
    within CUDA's limits, the passes cover Cin rounded up to 4 in channels
    that are a multiple of 4, and the block covers all of Cout up to 96."""
    n, cin, h, w, cout = shape
    plan = K1.k1_plan(n, h, w, cin, cout, F32)
    K1._check_k1_launch(plan)
    assert plan.instantiation == "fma" and plan.threads == 256
    assert plan.smem <= K1.SMEM_LIMIT
    assert plan.blocks_per_sm * (plan.smem + 1024) <= 228 * 1024
    assert plan.tiles <= 2 ** 31 - 1 and plan.col_blocks <= 65_535
    cin4 = -(-cin // 4) * 4
    assert plan.cc % 4 == 0 and plan.passes * plan.cc >= cin4
    assert (plan.passes - 1) * plan.cc < cin4
    assert (plan.cols, plan.pixels) == ((48, 256) if cout <= 48 else (96, 128))
    assert plan.col_blocks * plan.cols >= cout > (plan.col_blocks - 1) * plan.cols
    assert plan.tile_w == min(w, 16) and plan.tile_h == plan.pixels // plan.tile_w
    assert _covered(plan, n, h, w) == n * h * w
    return plan


@pytest.mark.parametrize("name,shape", TRAIN, ids=[n for n, _ in TRAIN])
def test_fp32_plan_at_the_training_shapes(name, shape):
    """Every layer of a batch-384 step stages all of Cin in one pass; the
    layers of 8 pixels or more per row fit two blocks per SM."""
    plan = _check_fp32_plan(shape)
    assert plan.passes == 1
    if shape[3] >= 8:
        assert plan.blocks_per_sm == 2


@pytest.mark.parametrize("name,shape", REQUEST, ids=[n for n, _ in REQUEST])
def test_fp32_plan_at_the_request_shapes(name, shape):
    """A request's layers (rows 16 wide or more): one pass, two blocks per
    SM, tiles 16 columns wide."""
    plan = _check_fp32_plan(shape)
    assert (plan.passes, plan.blocks_per_sm, plan.tile_w) == (1, 2, 16)


@pytest.mark.parametrize("cin", [1, 3, 97, 99, 144, 512])
@pytest.mark.parametrize("h,w", [(64, 64), (352, 512), (5, 7), (2, 2), (9, 1)])
def test_fp32_plan_at_odd_input_widths(cin, h, w):
    """Cin padded to a multiple of 4 (1 and 3 to 4, 97 and 99 to 100); the
    tile of Cin 512, and of Cin 144 at W 1 (130 x 3 slots), is staged in
    passes; everything else in one."""
    plan = _check_fp32_plan((2, cin, h, w, 96))
    assert (plan.passes > 1) == (cin == 512 or (cin == 144 and w == 1))


def test_fp32_no_shape_is_refused_for_shared_memory():
    """Every width and Cin/Cout the parent's fp32 kernel took still runs:
    where the halo'd tile of all of Cin would not fit one block, the plan
    stages it in passes."""
    for w in (*range(1, 70), 352, 768, 4096):
        for cin in (1, 3, 5, 8, 16, 17, 48, 96, 97, 99, 144, 256, 512):
            for cout in (1, 4, 16, 48, 49, 96, 97, 100, 200):
                _check_fp32_plan((1, cin, 8, w, cout))


def _fp32_thread_map(plan):
    """(pixel in tile, output channel in block) of every thread's 8 x 6
    micro-tile, as ``conv_fma_kernel`` lays them out: thread (ty, tx) of
    the block's cols / 6 x (256 / (cols / 6)) owns pixels ty + TY i and
    channels 4 tx .. 4 tx + 3 and 4 TX + 2 tx, 4 TX + 2 tx + 1."""
    tx_n = plan.cols // 6
    ty_n = plan.threads // tx_n
    ty, tx = np.divmod(np.arange(plan.threads), tx_n)
    pix = ty[:, None] + ty_n * np.arange(8)[None, :]           # (threads, 8)
    ch = np.concatenate([4 * tx[:, None] + np.arange(4)[None, :],
                         4 * tx_n + 2 * tx[:, None] + np.arange(2)[None, :]],
                        axis=1)                                 # (threads, 6)
    return pix, ch


@pytest.mark.parametrize("shape", [(2, 3, 5, 7, 48), (3, 48, 9, 17, 96),
                                   (1, 96, 1, 1, 100), (2, 8, 4, 2, 200),
                                   (1, 4, 13, 33, 49), (2, 16, 3, 20, 1)])
def test_fp32_tiles_and_threads_cover_every_output_once(shape):
    """The plan's tiles (tile_h of the batch's rows x tile_w columns) and
    column blocks, and each block's threads, write every (pixel, channel)
    of the output exactly once."""
    n, cin, h, w, cout = shape
    plan = K1.k1_plan(n, h, w, cin, cout, F32)
    pix, ch = _fp32_thread_map(plan)
    count = np.zeros((n * h, w, cout), np.int64)
    col_tiles = -(-w // plan.tile_w)
    for t in range(plan.tiles):
        r0 = t // col_tiles * plan.tile_h
        c0 = t % col_tiles * plan.tile_w
        pr, pc = np.divmod(pix, plan.tile_w)
        rows, cols = r0 + pr, c0 + pc
        ok_px = (pr < plan.tile_h) & (rows < n * h) & (cols < w)
        for cb in range(plan.col_blocks):
            co = cb * plan.cols + ch
            for i in range(8):
                for j in range(6):
                    m = ok_px[:, i] & (co[:, j] < cout)
                    np.add.at(count, (rows[m, i], cols[m, i], co[m, j]), 1)
    assert (count == 1).all()


@pytest.mark.parametrize("cin,cout", [(48, 48), (96, 96), (3, 48), (99, 100),
                                      (144, 96), (5, 16)])
def test_pack_weights_f32(cin, cout):
    """The fp32 kernel's weights: block cb's row k' = tap * cin4 + ci is
    tap (dh, dw)'s row ci of the (Cin, Cout) matrix, columns cb * cols ..,
    zero past Cin and Cout; at the model's widths, (3, 3, Cin, Cout) as it
    stands."""
    plan = K1.k1_plan(2, 8, 8, cin, cout, F32)
    w = torch.randn(cout, cin, 3, 3, generator=torch.Generator().manual_seed(1))
    packed = K1.pack_weights_f32(w, plan)
    taps = w.permute(2, 3, 1, 0).reshape(9, cin, cout)
    cin4 = -(-cin // 4) * 4
    if cin4 == cin and plan.col_blocks * plan.cols == cout:
        assert packed.shape == (3, 3, cin, cout) and packed.is_contiguous()
        assert torch.equal(packed.reshape(9, cin, cout), taps)
        return
    assert packed.dtype == F32 and packed.is_contiguous()
    assert packed.shape == (plan.col_blocks, 9 * cin4, plan.cols)
    full = torch.zeros(9, cin4, plan.col_blocks * plan.cols)
    full[:, :cin, :cout] = taps
    for cb in range(plan.col_blocks):
        assert torch.equal(packed[cb], full[:, :, cb * plan.cols:
                                            (cb + 1) * plan.cols].reshape(
                                                9 * cin4, plan.cols))


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


@pytest.mark.parametrize("name", sorted(k1_probe.F32_VARIANTS))
def test_probe_variants_match_the_source(name):
    """``k1_probe.py --variants`` times fp32 K1's design choices as textual
    edits of ``csrc/shifted_conv.cu`` and overrides of the plan's constants:
    each edit's text must occur in the committed source exactly once, and
    each override must name a constant of ``kernels/shifted_conv.py`` and
    change it, or the probe would time something other than what it names;
    every variant's plan still fits one block at the training shapes."""
    edits, overrides = k1_probe.F32_VARIANTS[name]
    assert edits or overrides
    with open(k1_probe.SOURCE) as f:
        src = f.read()
    for old, new in edits:
        assert src.count(old) == 1, old
        assert old != new
    for const, value in overrides.items():
        assert getattr(K1, const) != value
    saved = {c: getattr(K1, c) for c in overrides}
    try:
        for c, v in overrides.items():
            setattr(K1, c, v)
        for _, (n, cin, h, w, cout) in TRAIN:
            K1._check_k1_launch(K1.k1_plan(n, h, w, cin, cout, F32))
    finally:
        for c, v in saved.items():
            setattr(K1, c, v)
