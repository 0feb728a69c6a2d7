"""Segment geometry on torch tensors.

The JAX package's `geometry.canonicalize_direction` computes ``1 - pos - neg``
on boolean masks, which torch refuses; this is its twin.  `quat_to_rot` is
pure arithmetic on scalars or tensors, the same expression as the JAX
package's.
"""

from __future__ import annotations

import torch

__all__ = ["canonicalize_direction", "quat_to_rot"]


def quat_to_rot(qw, qx, qy, qz):
    """Rotation matrix of a unit quaternion (w, x, y, z), Eigen's convention
    (node.cpp:432 ``toRotationMatrix``), as a 3x3 nested tuple of whatever
    the components are (floats, numpy or torch scalars)."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return (
        (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
        (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
        (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)),
    )


def _sign_nonzero(v, fallback, eps):
    pos = v > eps
    neg = v < -eps
    return torch.where(pos, 1.0, torch.where(neg, -1.0, fallback))


def canonicalize_direction(b: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Flip b (..., 3) so its first nonzero component (x, then y, then z) is
    positive (D-SIGN, README).  An all-zero b is returned as it is."""
    x, y, z = b[..., 0], b[..., 1], b[..., 2]
    one = torch.ones_like(z)
    sign = _sign_nonzero(x, _sign_nonzero(y, _sign_nonzero(z, one, eps), eps), eps)
    return b * sign[..., None]
