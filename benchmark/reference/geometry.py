"""Line and segment geometry on numpy arrays, for the benchmark's
reference: a frozen copy of the port's ``oracle/_geometry.py`` and of its
``geometry.quat_to_rot``, the same expressions on numpy arrays or scalars.
"""

from __future__ import annotations


def quat_to_rot(qw, qx, qy, qz):
    """Rotation matrix of a unit quaternion (w, x, y, z), Eigen's convention
    (node.cpp:432 ``toRotationMatrix``), as a 3x3 nested tuple."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return (
        (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
        (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
        (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)),
    )


__all__ = ["dot3", "norm3", "find_proj", "point_line_distance",
           "segment_endpoints", "quat_to_rot", "canonicalize_direction"]


def dot3(u, v):
    """Row-wise 3-vector dot product; works on (..., 3) arrays."""
    return (u * v).sum(-1)


def norm3(u):
    return dot3(u, u) ** 0.5


def find_proj(a, b, p):
    """Orthogonal projection of p onto the line a + t*b (b need not be unit).

    Reference: hough_3d_lines.h:78-85.
    """
    d = p - a
    bb = dot3(b, b)
    t = dot3(d, b) / bb
    if hasattr(t, "ndim") and getattr(t, "ndim", 0) > 0:
        t = t[..., None]
    return a + t * b


def point_line_distance(a, b_unit, p):
    """Distance from p to the line a + t*b for UNIT direction b."""
    d = p - a
    along = dot3(d, b_unit)
    if hasattr(along, "ndim") and getattr(along, "ndim", 0) > 0:
        along = along[..., None]
    perp = d - along * b_unit
    return norm3(perp)


def segment_endpoints(a, b, t_min, t_max):
    """(p1, p2) = (t_min*b + a, t_max*b + a)  (node.cpp:461-462)."""
    if hasattr(t_min, "ndim") and getattr(t_min, "ndim", 0) > 0:
        t_min = t_min[..., None]
        t_max = t_max[..., None]
    return t_min * b + a, t_max * b + a


def canonicalize_direction(b, eps=0.0):
    """Flip b so its first nonzero component (x, then y, then z) is positive
    (D-SIGN, README).  Works on a single (3,) numpy vector."""
    x, y, z = b[..., 0], b[..., 1], b[..., 2]
    sign = _sign_nonzero(x, _sign_nonzero(y, _sign_nonzero(z, 1.0, eps), eps), eps)
    if hasattr(sign, "ndim") and getattr(sign, "ndim", 0) > 0:
        sign = sign[..., None]
    return b * sign


def _sign_nonzero(v, fallback, eps):
    pos = v > eps
    neg = v < -eps
    return pos * 1.0 + neg * (-1.0) + (1 - pos - neg) * fallback
