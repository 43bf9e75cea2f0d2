"""Per-pixel 3x3 SPD linear algebra in closed form (port of
``ssdn_tpu/estimator/spd3.py``).

The RGB estimator needs, per pixel: Sigma_x = A^T A from 6 network outputs,
Cholesky of Sigma_y, logdet, solves, and a matvec (SURVEY.md §2.5). Every
quantity is kept as separate (B, H, W) channel planes and the factorization
is written in closed form — elementwise fp32 code, no batched tiny-matrix
linear algebra.

Symmetric matrices are 6-tuples (s11, s12, s13, s22, s23, s33); vectors are
3-tuples. A is upper-triangular from channels (a11, a12, a13, a22, a23, a33).
"""

from __future__ import annotations

import torch

Sym3 = tuple  # (s11, s12, s13, s22, s23, s33)
Vec3 = tuple  # (v1, v2, v3)

_EPS = 1e-9


def sym3_from_tri(a: torch.Tensor) -> Sym3:
    """Sigma_x = A^T A for upper-triangular A packed in the last axis of `a`
    as (a11, a12, a13, a22, a23, a33). PSD by construction [P §3.1]."""
    a11, a12, a13, a22, a23, a33 = [a[..., i] for i in range(6)]
    return (
        a11 * a11,
        a11 * a12,
        a11 * a13,
        a12 * a12 + a22 * a22,
        a12 * a13 + a22 * a23,
        a13 * a13 + a23 * a23 + a33 * a33,
    )


def sym3_add_diag(s: Sym3, d: Vec3) -> Sym3:
    s11, s12, s13, s22, s23, s33 = s
    return (s11 + d[0], s12, s13, s22 + d[1], s23, s33 + d[2])


def sym3_matvec(s: Sym3, v: Vec3) -> Vec3:
    s11, s12, s13, s22, s23, s33 = s
    return (
        s11 * v[0] + s12 * v[1] + s13 * v[2],
        s12 * v[0] + s22 * v[1] + s23 * v[2],
        s13 * v[0] + s23 * v[1] + s33 * v[2],
    )


def chol3(s: Sym3):
    """Closed-form lower Cholesky L of an SPD 3x3; sqrt args clamped at a
    tiny floor so near-singular pixels stay finite (SURVEY.md §7.4 item 4)."""
    s11, s12, s13, s22, s23, s33 = s
    l11 = torch.sqrt(torch.clamp(s11, min=_EPS))
    l21 = s12 / l11
    l31 = s13 / l11
    l22 = torch.sqrt(torch.clamp(s22 - l21 * l21, min=_EPS))
    l32 = (s23 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(s33 - l31 * l31 - l32 * l32, min=_EPS))
    return l11, l21, l31, l22, l32, l33


def chol3_logdet(L) -> torch.Tensor:
    l11, _, _, l22, _, l33 = L
    return 2.0 * (torch.log(l11) + torch.log(l22) + torch.log(l33))


def chol3_forward_sub(L, d: Vec3) -> Vec3:
    """Solve L z = d."""
    l11, l21, l31, l22, l32, l33 = L
    z1 = d[0] / l11
    z2 = (d[1] - l21 * z1) / l22
    z3 = (d[2] - l31 * z1 - l32 * z2) / l33
    return z1, z2, z3


def chol3_back_sub(L, z: Vec3) -> Vec3:
    """Solve L^T w = z (so w = (L L^T)^{-1} d when z = L^{-1} d)."""
    l11, l21, l31, l22, l32, l33 = L
    w3 = z[2] / l33
    w2 = (z[1] - l32 * w3) / l22
    w1 = (z[0] - l21 * w2 - l31 * w3) / l11
    return w1, w2, w3


def sym3_solve_quad_logdet(s: Sym3, d: Vec3):
    """Returns (w = S^{-1} d, quad = d^T S^{-1} d, logdet S)."""
    L = chol3(s)
    z = chol3_forward_sub(L, d)
    quad = z[0] * z[0] + z[1] * z[1] + z[2] * z[2]
    w = chol3_back_sub(L, z)
    return w, quad, chol3_logdet(L)
