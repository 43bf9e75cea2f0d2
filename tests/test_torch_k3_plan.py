"""K3 (the fused head's backward) on the CPU: the width rules the wrapper
checks before a launch and the buffers it allocates (``_k3_buffers``: the
workspace, the partial sums and the flat output, which
``csrc/nin_head_bwd.cu``'s launcher carves up; the launch geometry and its
shared-memory limit are the launcher's alone, and its refusals are tested
on the card); the probe's textual edits of the source; and the names the
roofline metric reads. The kernels themselves run on the card
(``tests/test_torch_cuda.py``)."""

import pytest
import torch

import k2_probe
import k3_probe
from ssdn_tpu_torch.kernels import nin_head as K2

BF16, F32 = torch.bfloat16, torch.float32
MODEL = dict(c=96, na=384, nb=96, nc=10, k=4)  # the blind flagship's head
NARROW = dict(c=40, na=72, nb=24, nc=3, k=4)


def _buffers(m, dtype, c, na, nb, nc, k):
    """(workspace, partial, dw_sizes) of ``_k3_buffers``."""
    return K2._k3_buffers(m, c, na, nb, nc, k, dtype)


def _check(w, tensors, dt):
    K2._check_k3_widths(tensors, w["c"], w["na"], w["nb"], dt)


def test_splits_are_a_function_of_m_alone():
    """The partial sums hold bwd_splits(M) copies of the flat output (and,
    in fp32, (b)'s item counter), whatever the widths."""
    for m in (1, 63, 4096, 4097, 50_000, 262_144, 1_572_864):
        for dt in (BF16, F32):
            for w in (MODEL, NARROW, dict(MODEL, k=1, nc=9)):
                _, partial, sizes = _buffers(m, dt, **w)
                assert partial == K2.bwd_splits(m) * sum(sizes) + (dt == F32)
    assert K2.bwd_splits(262_144) == K2.bwd_splits(1_572_864) == 64


def test_workspace_and_flat_output():
    m = 1_572_864
    ws, partial, sizes = _buffers(m, BF16, **MODEL)
    assert ws == m * (2 * 96 + 384 + 16)  # h2, dpre2, dpre1, g
    assert _buffers(m, F32, **MODEL)[0] == m * (2 * 96 + 384)
    c, na, nb, nc = 96, 384, 96, 10
    assert sizes == (c * na, na, c * na, c * na, c * na,
                     na * nb, nb, nb * nc, nc)
    assert partial == 64 * sum(sizes)
    # fp32: one more float, (b)'s work-item counter
    assert _buffers(m, F32, **MODEL)[1] == 64 * sum(sizes) + 1
    # the bf16 workspace's four parts start on 16-byte boundaries
    assert all(m * w * 2 % 16 == 0 for w in (nb, 2 * nb, 2 * nb + na))


def test_launch_checks():
    t = torch.zeros(16, dtype=BF16)
    _check(NARROW, (t,), BF16)  # valid
    with pytest.raises(ValueError, match="multiples of 8"):
        _check(dict(NARROW, c=20), (t,), BF16)
    _check(dict(NARROW, c=20), (t.float(),), F32)  # fp32 takes any width
    with pytest.raises(ValueError, match="input channels"):
        _check(dict(NARROW, c=264), (t,), BF16)
    with pytest.raises(ValueError, match="16-byte"):
        _check(NARROW, (t[1:],), BF16)
    for dt, tensor in ((BF16, t), (F32, t.float())):
        with pytest.raises(ValueError, match="layer-a columns"):
            _check(dict(MODEL, na=K2.MAX_NA + 8), (tensor,), dt)


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
    off = torch.zeros(17)[1:]  # 4 bytes past an allocation's start
    _check(widths, (off,), F32)


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

# The shared bytes one H100 block may use: the mma.sync kernel's limit, kept
# here as the record of which widths it took.
MMA_SYNC_SMEM_LIMIT = 232_448


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
    """Every width the mma.sync kernel took passes the wrapper's checks: at
    C 8, 96 and 256, Nc from 1 to 824 and Nb in multiples of 8 up to 1,024,
    wherever the old kernel's shared memory fitted one block (the wgmma
    kernels run them: pre2 in passes of 96 columns of Nb, Wc^T in a window
    of 96 x 64 columns; the card tests run the widest)."""
    t = torch.zeros(16, dtype=BF16)
    taken = 0
    for c in (8, 96, 256):
        for nc in (1, 3, 9, 10, 16, 17, 40, 49, 64, 65, 100, 150, 200, 300,
                   500, 824):
            for nb in range(8, 1025, 8):
                if _mma_sync_rows_smem(c, na, nb, nc) > MMA_SYNC_SMEM_LIMIT:
                    continue
                _check(dict(c=c, na=na, nb=nb), (t,), BF16)
                taken += 1
    assert taken > 0
    if na == 384:  # the model's Na: the old kernel took Nb up to 144
        assert _mma_sync_rows_smem(96, 384, 144, 10) <= MMA_SYNC_SMEM_LIMIT
        assert _mma_sync_rows_smem(96, 384, 152, 10) > MMA_SYNC_SMEM_LIMIT


def test_bf16_workspace_and_partials_do_not_grow():
    """The workspace (h2, dpre2, dpre1, g_lp: M x (2 Nb + Na + Nc rounded up
    to 16) bf16) and the partial sums (S x the flat output) are the sizes
    the mma.sync kernels used, and the workspace's parts start on 16-byte
    boundaries, which TMA needs."""
    for m in (1, 4133, 262_144, 1_572_864):
        ws, partial, sizes = _buffers(m, BF16, **MODEL)
        assert ws == m * (2 * 96 + 384 + 16)
        assert partial == K2.bwd_splits(m) * sum(sizes)
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
