"""K3's launch plan (``kernels.nin_head.k3_plan``) and the checks the K3
wrapper runs before a launch, on the CPU: the numbers the wrapper allocates
with and that ``csrc/nin_head_bwd.cu`` computes the same way, at the
model's widths, at Na 512, at ragged M and at widths that are not
multiples of 16; and the probe's textual edits of the source. The kernels
themselves run on the card (``tests/test_torch_cuda.py``)."""

import pytest
import torch

import k2_probe
import k3_probe
from ssdn_tpu_torch.kernels import nin_head as K2

BF16, F32 = torch.bfloat16, torch.float32
MODEL = dict(c=96, na=384, nb=96, nc=10, k=4)  # the blind flagship's head
NARROW = dict(c=40, na=72, nb=24, nc=3, k=4)


def _plan(m, dtype, c, na, nb, nc, k):
    return K2.k3_plan(m, c, na, nb, nc, k, dtype)


@pytest.mark.parametrize("dtype", [BF16, F32])
@pytest.mark.parametrize("na", [384, K2.MAX_NA])
def test_shared_memory_fits_one_block(dtype, na):
    plan = _plan(1_572_864, dtype, **dict(MODEL, na=na))
    assert plan.rows_smem <= K2.SMEM_LIMIT
    if dtype == BF16:
        assert plan.wgrad_smem <= K2.SMEM_LIMIT // 3  # (b): two blocks per SM
    else:
        # (b): two blocks per SM in the H100 SM's 228 KB, 1 KB reserved per
        # block; 2 stages of 32 rows x (128 + 128) floats and two claimed
        # item numbers, fixed
        launch = plan.wgrad_launch
        assert launch.blocks_per_sm * (plan.wgrad_smem + 1024) <= 228 * 1024
        assert plan.wgrad_smem == launch.smem == 2 * 32 * 256 * 4 + 16
    if dtype == F32:
        # (a1), the larger launch: the ring 3 x (128 x (32 + 4) + 32 x 128),
        # dpre2 96 x 132, g's group 2 x 128 x (16 + 4), Wc^T's group 16 x 96
        # floats, and h1's signs, 2 x 128 rows x 512 bits; fixed, it does
        # not grow with Na
        assert plan.rows_smem == 4 * (3 * (128 * 36 + 32 * 128) + 96 * 132
                                      + 2 * 128 * 20 + 16 * 96) + 2 * 128 * 64
        assert plan.rows_smem == 198_144
    if dtype == BF16 and na == 384:
        # Wb 384 x 104, h1 64 x 392, dpre2/dx 64 x 104, g 64 x 24, Wc 96 x 24,
        # the Wa ring 4 x 96 x 40: bf16 elements, 16-column pads + skew 8
        assert plan.rows_smem == 2 * (384 * 104 + 64 * 392 + 64 * 104
                                      + 64 * 24 + 96 * 24 + 4 * 96 * 40)
        # (b): 4 stages of 32 rows x (96 + 8 + 128 + 8) bf16
        assert plan.wgrad_smem == 4 * 32 * 240 * 2


def test_splits_are_a_function_of_m_alone():
    for m in (1, 63, 4096, 4097, 50_000, 262_144, 1_572_864):
        got = {_plan(m, dt, **w).splits for dt in (BF16, F32)
               for w in (MODEL, NARROW, dict(MODEL, k=1, nc=9))}
        assert got == {K2.bwd_splits(m)}, m
    assert K2.bwd_splits(262_144) == K2.bwd_splits(1_572_864) == 64


def test_workspace_and_flat_output():
    m = 1_572_864
    plan = _plan(m, BF16, **MODEL)
    assert plan.workspace == m * (2 * 96 + 384 + 16)  # h2, dpre2, dpre1, g
    assert _plan(m, F32, **MODEL).workspace == m * (2 * 96 + 384)
    c, na, nb, nc = 96, 384, 96, 10
    assert plan.dw_sizes == (c * na, na, c * na, c * na, c * na,
                             na * nb, nb, nb * nc, nc)
    assert plan.partial == 64 * sum(plan.dw_sizes)
    # the bf16 workspace's four parts start on 16-byte boundaries
    assert all(m * w * 2 % 16 == 0 for w in (nb, 2 * nb, 2 * nb + na))


@pytest.mark.parametrize("m,bf16_blocks,f32_blocks",
                         [(1, 1, 1), (63, 1, 1), (65, 2, 1), (4097, 65, 33)])
def test_row_blocks_at_ragged_m(m, bf16_blocks, f32_blocks):
    assert _plan(m, BF16, **MODEL).row_blocks == bf16_blocks
    assert _plan(m, F32, **MODEL).row_blocks == f32_blocks
    assert _plan(m, BF16, **MODEL).rows_per_block == 64


def test_tiles_at_model_and_narrow_widths():
    # bf16 (b): 96 x 128 tiles of dWa_i (96 x 384), dWb^T (96 x 384), dWc,
    # and one block of dbc's column sums
    assert _plan(4133, BF16, **MODEL).wgrad_tiles == 4 * 3 + 3 + 1 + 1
    assert _plan(4133, BF16, **MODEL).wgrad_blocks == 17 * 2
    # fp32 (b): the four dWa_i as one 384 x 384 product in 128 x 128 tiles,
    # dWb (384 x 96) in 128 x 96, dWc (96 x 10) in one 128 x 16; the bias
    # sums ride in the tiles of row 0
    assert _plan(4133, F32, **MODEL).wgrad_tiles == 9 + 3 + 1
    assert _plan(4133, F32, **MODEL).wgrad_blocks == 13 * 2
    narrow = _plan(1000, BF16, **NARROW)
    assert narrow.wgrad_tiles == 4 + 1 + 1 + 1
    # C 40, Na 72, Nb 24, Nc 3 pad to 48, 80, 32, 16 (dpre2/dx: 48 + 8)
    assert narrow.rows_smem == 2 * (80 * 40 + 64 * 88 + 64 * 56 + 64 * 24
                                    + 32 * 24 + 4 * 48 * 40)


def test_launch_checks():
    t = torch.zeros(16, dtype=BF16)
    ok = _plan(64, BF16, **NARROW)
    K2._check_k3_launch(ok, (t,), 40, 72, 24, BF16)  # valid
    with pytest.raises(ValueError, match="multiples of 8"):
        K2._check_k3_launch(_plan(64, BF16, **dict(NARROW, c=20)), (t,),
                            20, 72, 24, BF16)
    K2._check_k3_launch(_plan(64, F32, **dict(NARROW, c=20)), (t.float(),),
                        20, 72, 24, F32)  # the fp32 kernel takes any width
    with pytest.raises(ValueError, match="input channels"):
        K2._check_k3_launch(_plan(64, BF16, **dict(NARROW, c=264)), (t,),
                            264, 72, 24, BF16)
    with pytest.raises(ValueError, match="16-byte"):
        K2._check_k3_launch(ok, (t[1:],), 40, 72, 24, BF16)
    # fp32's shared bytes are fixed: Nb 1000 runs in passes (the first fp32
    # kernel's Na- and Nb-sized tiles refused it)
    big = _plan(64, F32, **dict(MODEL, na=512, nb=1000))
    K2._check_k3_launch(big, (t.float(),), 96, 512, 1000, F32)
    assert big.row_launches[0].passes == 11


# ------------------- fp32 (a): the two FMA launches -------------------

FP32_WIDTHS = {"model": MODEL, "max-na": dict(MODEL, na=K2.MAX_NA),
               "c40-na72-nb24-nc3": NARROW,
               "c16-na32-nb16-nc9": dict(c=16, na=32, nb=16, nc=9, k=4)}


@pytest.mark.parametrize("widths", list(FP32_WIDTHS.values()),
                         ids=list(FP32_WIDTHS))
def test_fp32_row_launches_at_model_and_narrow_widths(widths):
    """(a1) "rows": dh1 in chunks of 128 columns of Na, one pass over Nb <=
    96, a 3-stage ring; (a2) "dx": chunks of 128 columns of k C (3 at the
    model's 4 x 96), a 2-stage ring; both: 128-row tiles, K in slices of
    32, 256 threads, one block per SM, fixed shared bytes."""
    plan = _plan(4133, F32, **widths)
    rows, dx = plan.row_launches
    assert (rows.kernel, dx.kernel) == ("rows", "dx")
    for launch in (rows, dx):
        assert (launch.rows_per_tile, launch.row_tiles) == (128, 33)
        assert (launch.slice, launch.threads, launch.blocks_per_sm) == (
            32, 256, 1)
    assert (rows.stages, dx.stages) == (3, 2)
    assert rows.chunk == 128 and rows.chunks == -(-widths["na"] // 128)
    assert rows.passes == 1
    assert dx.chunk == 128 and dx.chunks == -(-4 * widths["c"] // 128)
    assert dx.passes == 1
    assert (rows.smem, dx.smem) == (198_144, 4 * 2 * 32 * (132 + 128))
    assert (plan.rows_per_block, plan.row_blocks) == (128, 33)
    assert plan.rows_smem == rows.smem
    if widths is MODEL:
        assert dx.chunks == 3 and rows.chunks == 3


@pytest.mark.parametrize("m", [1, 63, 65, 127, 129, 4133])
def test_fp32_row_tiles_at_ragged_m(m):
    plan = _plan(m, F32, **MODEL)
    assert plan.row_blocks == -(-m // 128)
    assert all(launch.row_tiles == -(-m // 128)
               for launch in plan.row_launches)
    # (b)'s tiles and the workspace do not depend on (a)'s geometry
    assert plan.wgrad_tiles == 9 + 3 + 1
    assert plan.workspace == m * (2 * 96 + 384)


@pytest.mark.parametrize("na", [384, K2.MAX_NA])
def test_fp32_row_launches_fit_one_block_per_sm(na):
    plan = _plan(1_572_864, F32, **dict(MODEL, na=na))
    for launch in plan.row_launches:
        # the H100 SM's 228 KB of shared memory, 1 KB reserved per block
        assert launch.smem <= K2.SMEM_LIMIT
        assert launch.blocks_per_sm * (launch.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("m,rows_gb,dx_gb", [(1_572_864, 3.62, 7.25),
                                             (393_216, 0.91, 1.81)])
def test_fp32_weight_stream_per_call(m, rows_gb, dx_gb):
    """Each 128-row tile streams its weights from L2 once: (a1) Wb and
    Wb^T (294,912 bytes at the model's widths), (a2) the four Wa_i^T
    (589,824): 10.87 GB per batch-384 step, where the first fp32 kernel's
    32-row blocks read all three per block (43.49 GB)."""
    rows, dx = _plan(m, F32, **MODEL).row_launches
    assert rows.weight_bytes == rows.row_tiles * 4 * 2 * 384 * 96
    assert dx.weight_bytes == dx.row_tiles * 4 * 4 * 96 * 384
    assert (round(rows.weight_bytes / 1e9, 2), round(dx.weight_bytes / 1e9, 2)) \
        == (rows_gb, dx_gb)
    old = -(-m // 32) * 4 * (4 * 96 * 384 + 2 * 384 * 96)
    assert (rows.weight_bytes + dx.weight_bytes) * 4 == old
    if m == 1_572_864:
        assert round(old / 1e9, 2) == 43.49


@pytest.mark.parametrize("widths", [
    dict(MODEL, c=3), dict(MODEL, c=99), dict(MODEL, na=K2.MAX_NA),
    dict(MODEL, nb=200, nc=40), dict(MODEL, nc=17), NARROW,
    dict(NARROW, k=1), dict(c=16, na=32, nb=16, nc=9, k=4),
    dict(c=5, na=70, nb=30, nc=3, k=4)],
    ids=["c3", "c99", "na512", "nb200-nc40", "nc17", "narrow", "narrow-k1",
         "c16-na32-nb16", "c5-na70-nb30"])
def test_fp32_takes_every_width_the_parent_took(widths):
    """No width the first fp32 kernel took is refused (its limit was Na <=
    MAX_NA within 4 x 36 x (2 Na + Nb + Nc) bytes): C or Na not a multiple
    of 4 move in 4-byte pieces, Nb over 96 runs in passes, Nc over 16 in
    groups; unaligned operands too."""
    plan = _plan(1000, F32, **widths)
    rows, dx = plan.row_launches
    assert rows.passes == -(-widths["nb"] // 96)
    assert dx.chunks == -(-widths["k"] * widths["c"] // 128)
    off = torch.zeros(17)[1:]  # 4 bytes past an allocation's start
    K2._check_k3_launch(plan, (off,), widths["c"], widths["na"],
                        widths["nb"], F32)


# ------------------- fp32 (b): the weight-grad partials -------------------

WGRAD_PRODUCTS = {
    # (name, P, Q, tile rows, tile columns, tiles)
    "model": (("dWa", 384, 384, 128, 128, 9), ("dWb", 384, 96, 128, 96, 3),
              ("dWc", 96, 10, 128, 16, 1)),
    "max-na": (("dWa", 384, 512, 128, 128, 12), ("dWb", 512, 96, 128, 96, 4),
               ("dWc", 96, 10, 128, 16, 1)),
    "c40-na72-nb24-nc3": (("dWa", 160, 72, 128, 96, 2),
                          ("dWb", 72, 24, 128, 96, 1),
                          ("dWc", 24, 3, 128, 16, 1)),
    "c16-na32-nb16-nc9": (("dWa", 64, 32, 128, 96, 1),
                          ("dWb", 32, 16, 128, 16, 1),
                          ("dWc", 16, 9, 128, 16, 1)),
}


@pytest.mark.parametrize("name", list(FP32_WIDTHS))
def test_fp32_wgrad_launch_at_model_and_narrow_widths(name):
    """(b) is one launch: the k branches' dWa_i as one product (k C x Na)
    whose 128-row tiles straddle branches, dWb and dWc; tile columns 128,
    96 or 16 by the product's Q; 32-row stages through a 2-stage ring, 256
    threads, two blocks per SM; the bias sums as a row of the tile that
    holds row 0, so no product pads P by one."""
    plan = _plan(4133, F32, **FP32_WIDTHS[name])
    launch = plan.wgrad_launch
    assert launch.products == WGRAD_PRODUCTS[name]
    assert (launch.stage_rows, launch.stages, launch.threads,
            launch.blocks_per_sm) == (32, 2, 256, 2)
    assert plan.wgrad_tiles == sum(p[-1] for p in launch.products)
    assert launch.items == plan.wgrad_tiles * 2
    assert plan.wgrad_blocks == launch.blocks == launch.items  # < 2 x 132
    assert plan.partial == 2 * sum(plan.dw_sizes) + 1  # and the item counter
    assert _plan(4133, BF16, **FP32_WIDTHS[name]).wgrad_launch is None


@pytest.mark.parametrize("m,splits,chunk,last", [
    (1, 1, 1, 1), (63, 1, 63, 63), (4095, 1, 4095, 4095),
    (4097, 2, 2049, 2048), (262_145, 64, 4097, 4034),
    (1_572_851, 64, 24_576, 24_563)])
def test_fp32_wgrad_items_at_ragged_m(m, splits, chunk, last):
    """Work items are (tile, split) pairs, bwd_splits(M) splits of
    ceil(M / S) rows each, the last one shorter: no split is empty, and a
    split's last 32-row stage is part-filled where its rows are not a
    multiple of 32 (zero past its end); the items' rows cover M once."""
    plan = _plan(m, F32, **MODEL)
    assert plan.splits == splits == K2.bwd_splits(m)
    assert plan.wgrad_launch.items == 13 * splits
    assert plan.wgrad_blocks == min(13 * splits, 2 * 132)
    assert -(-m // splits) == chunk
    rows = [min(m, (s + 1) * chunk) - s * chunk for s in range(splits)]
    assert min(rows) >= 1 and sum(rows) == m and rows[-1] == last
    # a ragged M does not change the tiles, only the items' rows
    assert plan.wgrad_launch.products == WGRAD_PRODUCTS["model"]


@pytest.mark.parametrize("m,items,blocks,bf16_blocks", [
    (4133, 26, 26, 34), (1_572_864, 832, 264, 1088)])
def test_fp32_wgrad_grid_is_the_blocks_launched(m, items, blocks, bf16_blocks):
    """``wgrad_blocks`` is the grid the launcher starts: in fp32 min(work
    items, 2 blocks per SM x the H100 SXM's 132 SMs), persistent blocks
    that claim the items past the first grid's; in bf16 one block per tile
    and split."""
    launch = _plan(m, F32, **MODEL).wgrad_launch
    assert (launch.items, launch.blocks) == (items, blocks)
    assert _plan(m, F32, **MODEL).wgrad_blocks == blocks
    assert _plan(m, BF16, **MODEL).wgrad_blocks == bf16_blocks


@pytest.mark.parametrize("widths", [MODEL, dict(MODEL, na=K2.MAX_NA),
                                    dict(MODEL, nb=200, nc=40)],
                         ids=["model", "max-na", "nb200-nc40"])
def test_fp32_wgrad_shared_memory_fits(widths):
    """(b)'s shared bytes are fixed (2 stages of 32 x 128 floats of A and of
    B, and two claimed item numbers), whatever the widths: the ring fits
    one H100 block, and two beside each other on one SM."""
    launch = _plan(1_572_864, F32, **widths).wgrad_launch
    assert launch.smem == 65_552 <= K2.SMEM_LIMIT
    assert launch.blocks_per_sm == 2
    assert 2 * (launch.smem + 1024) <= 228 * 1024


def _old_wgrad_l2_bytes(m, c, na, nb, nc, k):
    """The bytes the first fp32 kernel's 64 x 64 tiles streamed per call:
    each tile read its 64 columns of A and of B (the bias rows, a row of
    ones appended to A, read nothing)."""
    per_row = 0
    for p, ones, q, n in ((c, 1, na, 1), (c, 0, na, k - 1), (na, 1, nb, 1),
                          (nb, 0, nc, 1), (0, 1, nc, 1)):
        per_row += n * (-(-q // 64) * p + -(-(p + ones) // 64) * q)
    return 4 * m * per_row


@pytest.mark.parametrize("m,new_gb,old_gb", [(1_572_864, 19.39, 43.68),
                                             (393_216, 4.85, 10.92)])
def test_fp32_wgrad_l2_stream_below_the_old_tiling(m, new_gb, old_gb):
    """Per row, (b) streams dWa's A (384 columns) once per 128-column tile
    of Na and dpre1 once per 128-row tile of k C (3 + 3), dWb's h1 once and
    dpre2 three times, dWc's h2 and g once: 3,082 floats, 19.39 GB per
    batch-384 step, from 6,942 (43.68 GB) in 64 x 64 tiles."""
    launch = _plan(m, F32, **MODEL).wgrad_launch
    assert launch.l2_bytes == 4 * m * (3 * 384 + 3 * 384 + 384 + 3 * 96 + 96 + 10)
    old = _old_wgrad_l2_bytes(m, **MODEL)
    assert old == 4 * m * 6942
    assert (round(launch.l2_bytes / 1e9, 2), round(old / 1e9, 2)) == (
        new_gb, old_gb)
    for widths in FP32_WIDTHS.values():
        assert (_plan(m, F32, **widths).wgrad_launch.l2_bytes
                < _old_wgrad_l2_bytes(m, **widths))


@pytest.mark.parametrize("name", list(k3_probe.F32_VARIANTS))
def test_probe_edits_match_the_source(name):
    """``k3_probe.py --fp32`` times the design's variants as textual edits
    of ``csrc/nin_head_bwd.cu``: each edit's text must occur in the
    committed source exactly once, or the probe would time a copy that
    differs from what it names."""
    edits = k3_probe.F32_VARIANTS[name]
    with open(k3_probe.SOURCE) as f:
        src = f.read()
    for old, new in edits:
        assert src.count(old) == 1, old
        assert old != new
    assert k2_probe.edited_source(edits, k3_probe.SOURCE) != src
