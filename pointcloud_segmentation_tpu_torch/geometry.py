"""Segment geometry on torch tensors.

The JAX package's `geometry.canonicalize_direction` computes ``1 - pos - neg``
on boolean masks, which torch refuses; this is its twin.  `quat_to_rot` is
pure arithmetic and is used from the JAX package's module as it is.
"""

from __future__ import annotations

import torch

from pointcloud_segmentation_tpu.geometry import quat_to_rot

__all__ = ["canonicalize_direction", "quat_to_rot"]


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
