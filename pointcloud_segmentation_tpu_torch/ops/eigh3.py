"""Closed-form symmetric 3x3 eigendecomposition on torch tensors.

Twin of the JAX package's ops/eigh3.py (trigonometric method): the same
operations in the same order.  Eigenvalues are DESCENDING.
"""

from __future__ import annotations

import torch

_TWO_PI_3 = 2.0943951023931953  # 2*pi/3


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of a symmetric (..., 3, 3) matrix, descending."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = d0 * d0 + d1 * d1 + d2 * d2 + 2.0 * p1
    p = torch.sqrt(torch.clamp_min(p2, 0.0) / 6.0)

    safe_p = torch.where(p > 0, p, torch.ones_like(p))
    b00, b11, b22 = d0 / safe_p, d1 / safe_p, d2 / safe_p
    b01, b02, b12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)
    e2 = 3.0 * q - e1 - e3
    # p == 0 -> A = q*I
    e1 = torch.where(p > 0, e1, q)
    e2 = torch.where(p > 0, e2, q)
    e3 = torch.where(p > 0, e3, q)
    return torch.stack([e1, e2, e3], dim=-1)


def _eigvec_for(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of symmetric 3x3 A for (approximately) simple
    eigenvalue lam, via the largest cross product of rows of (A - lam I).
    Falls back to e_x for fully degenerate inputs."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = A - lam[..., None, None] * eye
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c0 = torch.linalg.cross(r0, r1)
    c1 = torch.linalg.cross(r0, r2)
    c2 = torch.linalg.cross(r1, r2)
    ns = torch.stack([(c0 * c0).sum(-1), (c1 * c1).sum(-1), (c2 * c2).sum(-1)], dim=-1)
    cs = torch.stack([c0, c1, c2], dim=-2)
    best = torch.argmax(ns, dim=-1)
    v = torch.take_along_dim(cs, best[..., None, None].expand(*best.shape, 1, 3),
                             dim=-2)[..., 0, :]
    nbest = torch.take_along_dim(ns, best[..., None], dim=-1)[..., 0]
    v = torch.where((nbest > 0)[..., None], v, eye[0])
    denom = torch.sqrt(torch.clamp_min((v * v).sum(-1), 1e-38))
    return v / denom[..., None]


def principal_eigenvector3(A: torch.Tensor):
    """(largest eigenvalue, its unit eigenvector) of a symmetric 3x3 batch."""
    w = eigvalsh3(A)
    lam = w[..., 0]
    return lam, _eigvec_for(A, lam)


def eigh3(A: torch.Tensor):
    """(eigenvalues descending (..., 3), eigenvectors (..., 3, 3) in rows,
    row k for eigenvalue k)."""
    w = eigvalsh3(A)
    v0 = _eigvec_for(A, w[..., 0])
    v2 = _eigvec_for(A, w[..., 2])
    v1 = torch.linalg.cross(v2, v0)
    n1 = torch.sqrt(torch.clamp_min((v1 * v1).sum(-1), 1e-38))
    v1 = v1 / n1[..., None]
    return w, torch.stack([v0, v1, v2], dim=-2)
