"""K3's launch plan (``kernels.nin_head.k3_plan``) and the checks the K3
wrapper runs before a launch, on the CPU: the numbers the wrapper allocates
with and that ``csrc/nin_head_bwd.cu`` computes the same way, at the
model's widths, at Na 512, at ragged M and at widths that are not
multiples of 16. The kernels themselves run on the card
(``tests/test_torch_cuda.py``)."""

import pytest
import torch

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
    assert plan.wgrad_smem <= K2.SMEM_LIMIT // 3  # (b): two blocks per SM
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
                         [(1, 1, 1), (63, 1, 2), (65, 2, 3), (4097, 65, 129)])
def test_row_blocks_at_ragged_m(m, bf16_blocks, f32_blocks):
    assert _plan(m, BF16, **MODEL).row_blocks == bf16_blocks
    assert _plan(m, F32, **MODEL).row_blocks == f32_blocks
    assert _plan(m, BF16, **MODEL).rows_per_block == 64


def test_tiles_at_model_and_narrow_widths():
    # bf16 (b): 96 x 128 tiles of dWa_i (96 x 384), dWb^T (96 x 384), dWc,
    # and one block of dbc's column sums
    assert _plan(4133, BF16, **MODEL).wgrad_tiles == 4 * 3 + 3 + 1 + 1
    assert _plan(4133, BF16, **MODEL).wgrad_blocks == 17 * 2
    # fp32 (b): 64 x 64 tiles, bias rows appended to dWa_0 and dWb, and dbc
    assert _plan(4133, F32, **MODEL).wgrad_tiles == 12 + 3 * 12 + 14 + 2 + 1
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
    big = _plan(64, F32, **dict(MODEL, na=512, nb=1000))
    with pytest.raises(ValueError, match="shared memory"):
        K2._check_k3_launch(big, (t.float(),), 96, 512, 1000, F32)
