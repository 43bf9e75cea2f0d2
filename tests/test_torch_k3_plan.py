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
        # (b): 5 stages of 64 rows x (2 x 64 + 192) bf16 and their two
        # mbarriers, one persistent block per SM; fixed
        assert plan.wgrad_smem == 5 * (64 * 320 * 2 + 16) + 1024
        assert plan.wgrad_smem <= K2.SMEM_LIMIT
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
    if dtype == BF16:
        # (a): h1's boxes of 64 x 64 (Na / 64 per warpgroup; two
        # warpgroups, one at Na 512), the ring (10 slots of 96 x 64 bf16),
        # Wc^T (96 x 16), bb (96 floats), 22 mbarriers and 1 KB of
        # alignment slack: bytes
        wgs = 2 if na == 384 else 1
        assert plan.rows_per_block == 64 * wgs
        assert plan.rows_smem == (na // 64 * wgs * 8192 + 10 * 96 * 64 * 2
                                  + 96 * 16 * 2 + 96 * 4 + 22 * 8 + 1024)
        if na == 384:
            assert plan.rows_smem == 225_840

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
                         [(1, 1, 1), (63, 1, 1), (65, 1, 1), (4097, 33, 33)])
def test_row_blocks_at_ragged_m(m, bf16_blocks, f32_blocks):
    assert _plan(m, BF16, **MODEL).row_blocks == bf16_blocks
    assert _plan(m, F32, **MODEL).row_blocks == f32_blocks
    # bf16: two warpgroups of 64 rows at the model's widths
    assert _plan(m, BF16, **MODEL).rows_per_block == 128


def test_tiles_at_model_and_narrow_widths():
    # bf16 (b): items of 128 x 192 of dWa_i (96 x 384: one row tile, two
    # column tiles each) and dWb^T (96 x 384: two), one of dWc (96 x 10)
    # and one of dbc's column sums, per split; two splits at M 4133; the
    # launcher's grid is min(items, the device's SMs)
    bf = _plan(4133, BF16, **MODEL)
    assert bf.wgrad_tiles == 4 * 2 + 2 + 1 + 1
    assert bf.wgrad_tiles * bf.splits == 12 * 2
    assert bf.wgrad_blocks is None
    # Nb 200: dWb^T and dWc in two row tiles of 128
    assert _plan(4133, BF16, **dict(MODEL, nb=200)).wgrad_tiles == (
        4 * 2 + 2 * 2 + 2 * 1 + 1)
    # fp32 (b): the four dWa_i as one 384 x 384 product in 128 x 128 tiles,
    # dWb (384 x 96) in 128 x 96, dWc (96 x 10) in one 128 x 16; the bias
    # sums ride in the tiles of row 0
    assert _plan(4133, F32, **MODEL).wgrad_tiles == 9 + 3 + 1
    assert _plan(4133, F32, **MODEL).wgrad_blocks == 13 * 2
    narrow = _plan(1000, BF16, **NARROW)
    assert narrow.wgrad_tiles == 4 + 1 + 1 + 1
    # Na 72: two K blocks of h1 per warpgroup; Nc 3 pads to 16
    assert narrow.rows_smem == (2 * 2 * 8192 + 10 * 12288 + 96 * 16 * 2
                                + 96 * 4 + 22 * 8 + 1024)


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
    # bf16: pre2, dh2 and dpre2 run in passes of 96 columns of Nb, so a
    # wide Nb runs; only bb's Nb floats beside h1's boxes and the ring can
    # outgrow a block
    for nb in (104, 600):
        K2._check_k3_launch(_plan(64, BF16, **dict(NARROW, nb=nb)), (t,),
                            40, 72, nb, BF16)
    with pytest.raises(ValueError, match="bytes of shared memory"):
        K2._check_k3_launch(_plan(64, BF16, **dict(MODEL, na=512, nb=12_000)),
                            (t,), 96, 512, 12_000, BF16)
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


@pytest.mark.parametrize("m,items,blocks", [
    (4133, 26, 26), (1_572_864, 832, 264)])
def test_fp32_wgrad_grid_is_the_blocks_launched(m, items, blocks):
    """``wgrad_blocks`` is the grid the launcher starts: min(work items, 2
    blocks per SM x the H100 SXM's 132 SMs), persistent blocks that claim
    the items past the first grid's."""
    launch = _plan(m, F32, **MODEL).wgrad_launch
    assert (launch.items, launch.blocks) == (items, blocks)
    assert _plan(m, F32, **MODEL).wgrad_blocks == blocks


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


# ------------------- bf16 on wgmma and TMA -------------------

def _mma_sync_rows_smem(c, na, nb, nc):
    """The shared bytes of the bf16 rows kernel that ran on ``mma.sync``
    before the wgmma design (its only limit on the widths beside C, Na, Nb
    multiples of 8, C <= 256 and Na <= MAX_NA): Wb, h1's tile, dpre2 / dx,
    g's tile, Wc and a 4-stage Wa_i ring, bf16, widths padded to 16 and
    rows skewed by 8."""
    p16 = lambda v: -(-v // 16) * 16
    cp, nap, nbp, ncp = p16(c), p16(na), p16(nb), p16(nc)
    return 2 * (nap * (nbp + 8) + 64 * (nap + 8) + 64 * (max(nbp, cp) + 8)
                + 64 * (ncp + 8) + nbp * (ncp + 8) + 4 * cp * 40)


@pytest.mark.parametrize("na", [8, 32, 64, 72, 128, 200, 384, 448, K2.MAX_NA])
def test_bf16_takes_every_width_the_mma_sync_kernel_took(na):
    """Every width the mma.sync kernel took still runs: at C 8, 96 and 256,
    Nc from 1 to 824 and Nb in multiples of 8 up to 1,024, wherever the old
    kernel's shared memory fitted one block, the wgmma kernel's check
    passes (pre2 in passes of 96 columns of Nb; Wc^T in a window of 96 x
    64 columns, rewritten as dh2 moves on)."""
    t = torch.zeros(16, dtype=BF16)
    taken = 0
    for c in (8, 96, 256):
        for nc in (1, 3, 9, 10, 16, 17, 40, 49, 64, 65, 100, 150, 200, 300,
                   500, 824):
            for nb in range(8, 1025, 8):
                if _mma_sync_rows_smem(c, na, nb, nc) > K2.SMEM_LIMIT:
                    continue
                plan = _plan(64, BF16, c=c, na=na, nb=nb, nc=nc, k=4)
                K2._check_k3_launch(plan, (t,), c, na, nb, BF16)
                taken += 1
    assert taken > 0
    if na == 384:  # the model's Na: the old kernel took Nb up to 144
        assert _mma_sync_rows_smem(96, 384, 144, 10) <= K2.SMEM_LIMIT
        assert _mma_sync_rows_smem(96, 384, 152, 10) > K2.SMEM_LIMIT


# (Nb, Nc, Na): warpgroups and (a)'s shared bytes: h1's boxes, the ring
# (10 x 12 KB), the window of Wc^T (96 x min(Nc rounded up to 16, 64)
# bf16), bb (Nb rounded up to 96 floats), 22 mbarriers, 1 KB of slack. Two
# warpgroups where Wc^T is one window and their boxes fit; one where Nb >
# 96 or Nc > 64 (passes over Nb, windows of Nc)
TC_SMEM = {"model": (96, 10, 384, 2, 6 * 2 * 8192 + 3072 + 384),
           "nc40": (96, 40, 384, 2, 6 * 2 * 8192 + 9216 + 384),
           "nc64": (96, 64, 384, 1, 6 * 8192 + 12288 + 384),
           "nb128": (128, 10, 384, 1, 6 * 8192 + 3072 + 768),
           "nb200-nc40": (200, 40, 384, 1, 6 * 8192 + 9216 + 1152),
           "na64-nb600": (600, 10, 64, 1, 8192 + 3072 + 2688),
           "na512-nc500": (96, 500, 512, 1, 8 * 8192 + 12288 + 384)}


@pytest.mark.parametrize("name", list(TC_SMEM))
def test_bf16_shared_memory_at_wide_nb_and_nc(name):
    nb, nc, na, wgs, part = TC_SMEM[name]
    plan = _plan(4133, BF16, **dict(MODEL, na=na, nb=nb, nc=nc))
    assert plan.rows_per_block == 64 * wgs
    assert plan.rows_smem == part + 10 * 12288 + 22 * 8 + 1024
    assert plan.rows_smem <= K2.SMEM_LIMIT
    if name == "nc64":  # two warpgroups' boxes would not fit
        assert plan.rows_smem + 6 * 8192 > K2.SMEM_LIMIT


def test_bf16_workspace_and_partials_do_not_grow():
    """The workspace (h2, dpre2, dpre1, g_lp: M x (2 Nb + Na + Nc rounded up
    to 16) bf16) and the partial sums (S x the flat output) are the sizes
    the mma.sync kernels used, and the workspace's parts start on 16-byte
    boundaries, which TMA needs."""
    for m in (1, 4133, 262_144, 1_572_864):
        plan = _plan(m, BF16, **MODEL)
        assert plan.workspace == m * (2 * 96 + 384 + 16)
        assert plan.partial == plan.splits * sum(plan.dw_sizes)
        assert all(m * w * 2 % 16 == 0 for w in (96, 2 * 96, 2 * 96 + 384))


def _global_names(path):
    """The name of every ``__global__`` function in a CUDA source (past
    ``void`` and attributes such as ``__launch_bounds__(...)``, whose
    parentheses may nest)."""
    import re
    with open(path) as f:
        src = f.read()
    names = []
    for at in re.finditer(r"__global__\s+void\s+", src):
        i = at.end()
        while True:
            attr = re.match(r"(__\w+__)\s*\(", src[i:])
            if not attr:
                break
            i = src.index("(", i)
            depth = 0
            while True:
                depth += {"(": 1, ")": -1}.get(src[i], 0)
                i += 1
                if depth == 0:
                    break
            i += len(src[i:]) - len(src[i:].lstrip())
        names.append(re.match(r"\s*(\w+)", src[i:]).group(1))
    return names


def test_every_k3_kernel_is_named_for_the_roofline():
    """``k3_roofline.train`` sums K3's device time over kernels whose names
    contain one of its needles (``K3_KERNELS``, read here, not imported);
    a K3 kernel outside them would drop out of the denominator. Every
    ``__global__`` function of ``csrc/nin_head_bwd.cu`` carries one."""
    import ast
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    metric = os.path.join(root, "h100_bench", "metrics", "k3_roofline.train.py")
    with open(metric) as f:
        tree = ast.parse(f.read())
    needles = next(ast.literal_eval(node.value) for node in ast.walk(tree)
                   if isinstance(node, ast.Assign)
                   and any(getattr(t, "id", None) == "K3_KERNELS"
                           for t in node.targets))
    names = _global_names(k3_probe.SOURCE)
    assert {"bwd_rows_tc_kernel", "wgrad_tc_kernel",
            "reduce_splits_kernel"} <= set(names)
    for name in names:
        assert any(n in name for n in needles), name
