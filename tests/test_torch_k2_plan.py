"""K2/K2' (the fused head's forward) on the CPU: the width rules the
wrapper checks before a launch (the launch geometry and its shared-memory
limit are ``csrc/nin_head.cu``'s alone, and its refusals are tested on the
card); the twin against the JAX package's ``_fwd_call`` in interpret mode
at widths the bf16 tensor-core kernel pads, at its widest Na, Nb and Nc,
and at channel counts the fp32 FMA kernel moves in 4-byte pieces; the
probe's textual edits of the source; and the kernel build's cache key,
which must change with any header the sources include. The kernels
themselves run on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import k2_probe
import ssdn_tpu.ops.pallas.nin_head as NH
from ssdn_tpu_torch.kernels import _build
from ssdn_tpu_torch.kernels import nin_head as K2

BF16, F32 = torch.bfloat16, torch.float32
MODEL = dict(c=96, na=384, nb=96, nc=10, k=4)  # the blind flagship's head
NARROW = {"c40-na72-nb24-nc3": dict(c=40, na=72, nb=24, nc=3, k=4),
          "c16-na32-nb16-nc9": dict(c=16, na=32, nb=16, nc=9, k=4)}


def _check(w, tensors, dt):
    K2._check_k2_widths(tensors, w["c"], w["na"], w["nb"], w["nc"], dt)


def test_launch_checks():
    t = torch.zeros(16, dtype=BF16)
    check = lambda w, tensors=(t,), dt=BF16: _check(w, tensors, dt)
    narrow = NARROW["c40-na72-nb24-nc3"]
    check(narrow)  # valid
    check(dict(MODEL, na=1024))  # bf16 walks Na in chunks: no MAX_NA
    with pytest.raises(ValueError, match="multiples of 8"):
        check(dict(narrow, c=20))
    with pytest.raises(ValueError, match="multiples of 8"):
        check(dict(narrow, na=76))
    check(dict(narrow, c=20), (t.float(),), F32)  # fp32 takes any width
    with pytest.raises(ValueError, match="input channels"):
        check(dict(narrow, c=264, k=1))
    with pytest.raises(ValueError, match="Nc <= 16"):
        check(dict(narrow, nc=17))
    with pytest.raises(ValueError, match="Nc <= 16"):
        check(dict(narrow, nb=136))
    with pytest.raises(ValueError, match="16-byte"):
        check(narrow, (t[1:],))
    # fp32 walks Na in chunks too: MAX_NA binds K3 only
    check(dict(MODEL, na=K2.MAX_NA + 8), (t.float(),), F32)


def test_launcher_refusals_are_value_errors():
    """A launcher's cudaErrorInvalidValue (1), returned before it launches
    (its tiles exceed a block's shared memory, or a width rule), raises
    ValueError naming the kernel, the dtype and the widths; any other
    error RuntimeError; 0 nothing."""
    K2._check_launch(0, "K2 nin_head_fwd", BF16, 4, 96, 384, 96, 10)
    with pytest.raises(ValueError, match="K2 nin_head_fwd's launcher refuses "
                                         "bf16 at k 4, C 128, Na 384, Nb 96, "
                                         "Nc 10"):
        K2._check_launch(1, "K2 nin_head_fwd", BF16, 4, 128, 384, 96, 10)
    with pytest.raises(ValueError, match="refuses fp32 at k 1"):
        K2._check_launch(1, "K3 nin_head_bwd", F32, 1, 3, 512, 96, 10)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        K2._check_launch(700, "K3 nin_head_bwd", BF16, 4, 96, 384, 96, 10)


@pytest.mark.parametrize("widths", [
    dict(MODEL, c=3), dict(MODEL, c=99), dict(MODEL, na=K2.MAX_NA + 8),
    dict(MODEL, na=1024), dict(MODEL, nb=200, nc=40), dict(MODEL, nc=17),
    dict(NARROW["c40-na72-nb24-nc3"], k=1)],
    ids=["c3", "c99", "na520", "na1024", "nb200-nc40", "nc17", "narrow-k1"])
def test_fp32_takes_every_width(widths):
    """No width is refused in fp32 (its shared bytes are fixed): C not a
    multiple of 4 moves in 4-byte pieces, Na in chunks, Nb over 96 in
    passes, Nc over 16 in groups; unaligned operands too."""
    off = torch.zeros(17)[1:]  # 4 bytes past an allocation's start
    _check(widths, (off,), F32)


# ------------------- the twin against the TPU kernel -------------------


def _inputs(seed, k, c, na, nb, nc, m=512):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale: (rng.standard_normal(s) * scale).astype(np.float32)
    xs = [f(m, c, scale=0.5) for _ in range(k)]
    xs[0][0, 0] = -0.0
    return (xs, [f(c, na, scale=0.2) for _ in range(k)], f(na, scale=0.1),
            f(na, nb, scale=0.2), f(nb, scale=0.1), f(nb, nc, scale=0.2),
            f(nc, scale=0.1))


@pytest.fixture
def nh_interpret():
    NH.INTERPRET = True
    yield
    NH.INTERPRET = False


# the narrow widths, and the bf16 kernel's widest: Na MAX_NA (16 chunks of
# 32 columns), Nb 128 with Nc 16 (its limits on pre2's and out's columns)
TWIN_WIDTHS = {**NARROW, "na512": dict(MODEL, na=K2.MAX_NA),
               "nb128-nc16": dict(MODEL, nb=128, nc=16)}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("save_h1", [False, True])
@pytest.mark.parametrize("widths", list(TWIN_WIDTHS.values()),
                         ids=list(TWIN_WIDTHS))
def test_twin_matches_pallas_at_narrow_widths(nh_interpret, widths, save_h1,
                                              dtype):
    """The twin of K2 / K2' against ``_fwd_call`` in interpret mode at
    widths the bf16 tensor-core kernel pads and at its widest (M 512:
    ``_pick_tile`` takes multiples of 256). fp32: 1e-5 of the range
    (summation order). bf16:
    h1 and h2 are rounded on both sides and JAX scales the input LeakyReLU
    by bf16(0.1) where the port uses fp32 0.1 before its one rounding, so
    one flipped rounding (2**-8) moves a result: 2**-6 of the range."""
    w = dict(widths)
    k, nc = w.pop("k"), w.pop("nc")
    xs, was, ba, wb, bb, wc, bc = _inputs(7 + nc, k, nc=nc, **w)
    lp = lambda a: jnp.asarray(a, dtype)
    jx, jw = [lp(x) for x in xs], [lp(v) for v in was]
    out, h1 = NH._fwd_call(jx, jw, jnp.asarray(ba)[None], lp(wb),
                           jnp.asarray(bb)[None], lp(wc), jnp.asarray(bc)[None],
                           tm=256, interpret=True, save_h1=save_h1)
    tdt = BF16 if dtype == jnp.bfloat16 else F32
    tt = lambda a, dt=tdt: torch.from_numpy(np.array(a, np.float32)).to(dt)
    before = (K2.launches, K2.launches_save_h1)
    got, got_h1 = K2.nin_head_fwd([tt(x) for x in jx], [tt(v) for v in jw],
                                  tt(ba, F32), tt(lp(wb)), tt(bb, F32),
                                  tt(lp(wc)), tt(bc, F32), save_h1=save_h1)
    assert (K2.launches, K2.launches_save_h1) == before  # CPU: the twin
    bar = lambda r: (1e-5 if dtype == jnp.float32 else 2 ** -6) * max(
        float(np.abs(r).max()), 1e-30)
    ref = np.asarray(out)
    assert got.dtype == F32 and got.shape == ref.shape == (512, nc)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=bar(ref))
    if not save_h1:
        assert got_h1 is None and h1 is None
        return
    ref_h1 = np.asarray(h1, np.float32)
    assert got_h1.dtype == tdt and got_h1.shape == ref_h1.shape
    np.testing.assert_allclose(got_h1.float().numpy(), ref_h1, rtol=0,
                               atol=bar(ref_h1))


# C 3 and 99 (x rows in 4-byte pieces) at narrow widths; at the model's
# other widths, Na 520 (a part-filled chunk of a width not a multiple of 4),
# Nb 200 with Nc 40 (three passes over Nb, three groups of Nc) and Nc 17
FP32_UNALIGNED = {"3": dict(c=3, na=72, nb=24, nc=3),
                  "99": dict(c=99, na=72, nb=24, nc=3),
                  "na520": dict(MODEL, na=K2.MAX_NA + 8),
                  "nb200-nc40": dict(MODEL, nb=200, nc=40),
                  "nc17": dict(MODEL, nc=17)}


@pytest.mark.parametrize("save_h1", [False, True])
@pytest.mark.parametrize("widths", list(FP32_UNALIGNED.values()),
                         ids=list(FP32_UNALIGNED))
def test_twin_matches_pallas_fp32_at_unaligned_channels(nh_interpret, widths,
                                                        save_h1):
    """The fp32 twin against ``_fwd_call`` in interpret mode at the widths
    the fp32 kernel takes in its slow ways (``FP32_UNALIGNED``; the card
    tests hold the kernel against this twin there): out and h1 at 1e-5 of
    their range (summation order only)."""
    w = dict(widths)
    w.pop("k", None)
    xs, was, ba, wb, bb, wc, bc = _inputs(w["c"], 2, **w)
    j = lambda a: jnp.asarray(a)
    out, h1 = NH._fwd_call([j(x) for x in xs], [j(v) for v in was],
                           j(ba)[None], j(wb), j(bb)[None], j(wc), j(bc)[None],
                           tm=256, interpret=True, save_h1=save_h1)
    tt = lambda a: torch.from_numpy(np.array(a, np.float32))
    got, got_h1 = K2.nin_head_fwd([tt(x) for x in xs], [tt(v) for v in was],
                                  tt(ba), tt(wb), tt(bb), tt(wc), tt(bc),
                                  save_h1=save_h1)
    for g, r in ((got, out), (got_h1, h1)) if save_h1 else ((got, out),):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * float(np.abs(r).max()))
    assert (got_h1 is None) == (not save_h1)


# ------------------- the probe's edits of the source -------------------


PROBE_EDITS = {**k2_probe.VARIANTS, **k2_probe.ABLATIONS,
               **{f"f32_{n}": e for n, e in {**k2_probe.F32_VARIANTS,
                                             **k2_probe.F32_ABLATIONS}.items()}}


@pytest.mark.parametrize("name", list(PROBE_EDITS))
def test_probe_edits_match_the_source(name):
    """``k2_probe.py`` times the design's variants and ablations (bf16 and
    fp32) as textual edits of ``csrc/nin_head.cu``: each edit's text must
    occur in the committed source exactly once, or the probe would time a
    copy that differs from what it names."""
    edits = PROBE_EDITS[name]
    with open(k2_probe.SOURCE) as f:
        src = f.read()
    for old, new in edits:
        assert src.count(old) == 1, old
        assert old != new
    edited = k2_probe.edited_source(edits)
    assert (edited == src) == (not edits)


# ------------------- the build's cache key -------------------


def test_editing_a_header_changes_the_library_path(tmp_path, monkeypatch):
    """A source may include any header in ``csrc/``: the built library's
    name hashes them all, so an edited header never loads a stale
    library. Needs no nvcc: ``_paths`` only hashes."""
    (tmp_path / "nin_head.cu").write_text('#include "tc_bf16.cuh"\n')
    (tmp_path / "tc_bf16.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build._paths("nin_head")[1]
    assert _build._paths("nin_head")[1] == first  # a pure function of bytes
    (tmp_path / "tc_bf16.cuh").write_text("// two\n")
    second = _build._paths("nin_head")[1]
    (tmp_path / "other.cuh").write_text("// new\n")
    third = _build._paths("nin_head")[1]
    (tmp_path / "nin_head.cu").write_text('#include "tc_bf16.cuh"\n// x\n')
    fourth = _build._paths("nin_head")[1]
    assert len({first, second, third, fourth}) == 4
    # the committed sources: every library's key covers the shared header
    monkeypatch.undo()
    assert all(_build._paths(n)[1].startswith(_build.BUILD_DIR)
               for n in _build.SOURCES)
