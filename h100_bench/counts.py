"""The yardstick's operations and bytes, computed from shapes, and the
published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit).

Model FLOPs count the published architecture literally: every 3x3 conv of
the four rotated trunks at its own resolution, the decoder as upsample,
concat, conv, and the 1x1 head; one multiply-add is two operations. Work
that an implementation skips or adds (a fused decoder, padding to a
multiple of 32) does not change the count. A training step is three times
the forward.

The head kernels' counts are frozen copies of ``chip_smoke.py``'s
``k2_cost`` and ``k3_cost``: each input byte read once, each output byte
written once, the operations the shapes need.
"""

from __future__ import annotations

PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}  # tensor bf16; fp32 FMA
PEAK_BYTES = 3.35e12
BYTES = {"bfloat16": 2, "float32": 4}

ENC, DEC, NIN_A, NIN_B, CHANNELS = 48, 96, 384, 96, 3
N_POOLS = 5


def conv_flops(h: int, w: int, cin: int, cout: int, k: int = 3) -> float:
    """One k x k conv over an h x w map: 2 * h * w * k * k * cin * cout."""
    return 2.0 * h * w * k * k * cin * cout


def trunk_flops(h: float, w: float, c: int = CHANNELS, enc: int = ENC,
                dec: int = DEC) -> float:
    """One trunk over an h x w input (the pyramid's maps at h / 2^i)."""
    s = lambda i: (h / 2 ** i, w / 2 ** i)
    f = conv_flops(*s(0), c, enc) + conv_flops(*s(0), enc, enc)   # enc0, enc1
    for i in range(1, 5):                                          # enc2..enc5
        f += conv_flops(*s(i), enc, enc)
    f += conv_flops(*s(5), enc, enc)                               # enc6
    skip_c = {4: enc, 3: enc, 2: enc, 1: enc, 0: c}
    up_c = enc
    for i in (4, 3, 2, 1, 0):                                      # dec5..dec1
        f += conv_flops(*s(i), up_c + skip_c[i], dec)
        f += conv_flops(*s(i), dec, dec)
        up_c = dec
    return f


def head_flops_per_pixel(n_out: int, dec: int = DEC, nin_a: int = NIN_A,
                         nin_b: int = NIN_B) -> float:
    return 2.0 * (4 * dec * nin_a + nin_a * nin_b + nin_b * n_out)


def n_outputs(blind: bool, c: int = CHANNELS) -> int:
    return c + c * (c + 1) // 2 + (1 if blind else 0)


def forward_flops(h: float, w: float, blind: bool) -> float:
    """The model's forward over one h x w image: four trunks and the head."""
    return 4 * trunk_flops(h, w) + h * w * head_flops_per_pixel(
        n_outputs(blind))


def step_flops(batch: int, patch: int, blind: bool) -> float:
    """One training step: three times the forward of the batch."""
    return 3.0 * batch * forward_flops(patch, patch, blind)


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    """The least time on the published peaks, in seconds."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_OPS[dtype])


def k2_cost(m: int, dtype: str, n_out: int, k: int = 4, c: int = DEC,
            na: int = NIN_A, nb: int = NIN_B, save_h1: bool = False):
    """(bytes, operations) of the fused head forward over m rows of k
    branches (``chip_smoke.k2_cost``)."""
    es = BYTES[dtype]
    nbytes = (k * m * c * es + (k * c * na + na * nb + nb * n_out) * es
              + (na + nb + n_out) * 4 + m * n_out * 4
              + (m * na * es if save_h1 else 0))
    ops = 2 * m * (k * c * na + na * nb + nb * n_out)
    return nbytes, ops


def k3_cost(m: int, dtype: str, n_out: int, k: int = 4, c: int = DEC,
            na: int = NIN_A, nb: int = NIN_B):
    """(bytes, operations) of the fused head backward over m rows
    (``chip_smoke.k3_cost``)."""
    es = BYTES[dtype]
    nbytes = (2 * k * m * c * es + m * na * es + m * n_out * 4
              + (k * c * na + na * nb + nb * n_out) * es + nb * 4
              + (k * c * na + na + na * nb + nb + nb * n_out + n_out) * 4)
    ops = 2 * m * (3 * na * nb + 2 * nb * n_out + 2 * k * c * na)
    return nbytes, ops


def padded(n: int, multiple: int = 2 ** N_POOLS) -> int:
    return -(-n // multiple) * multiple
