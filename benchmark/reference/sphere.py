"""Direction-sphere discretization of the 3D Hough transform (numpy): a
frozen copy of the port's ``sphere.py``, for the benchmark's reference.

The direction table is the vertex set of a repeatedly subdivided
icosahedron: level g has 10*4^g + 2 vertices, and levels >= 1 keep one
direction per antipodal pair (level 0 keeps its 12 raw vertices), which gives
the reference's counts {12, 21, 81, 321, 1281, 5121, 20481}
(hough_3d_lines.h:192).  For each direction b the plane orthogonal to it gets
an orthonormal basis (c1, c2): a candidate line is a + t*b with anchor
a = x'*c1 + y'*c2, and a point p votes at x' = p . c1, y' = p . c2.

Everything is computed in float64 on the host, once per granularity (the
reference's ``initHoughSpace``), and must be bit-equal to the port's
``sphere.hough_space``: the same directions in the same order fix the
voting argmax's tie-break.
"""

from __future__ import annotations

import functools

import numpy as np

from .config import NUM_DIRECTIONS

_GOLDEN = (1.0 + np.sqrt(5.0)) / 2.0


def _icosahedron() -> tuple[np.ndarray, np.ndarray]:
    """Unit icosahedron vertices (12, 3) and faces (20, 3)."""
    p = _GOLDEN
    verts = np.array(
        [
            (-1, p, 0), (1, p, 0), (-1, -p, 0), (1, -p, 0),
            (0, -1, p), (0, 1, p), (0, -1, -p), (0, 1, -p),
            (p, 0, -1), (p, 0, 1), (-p, 0, -1), (-p, 0, 1),
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
        ],
        dtype=np.int64,
    )
    return verts, faces


def _subdivide(verts: np.ndarray, faces: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One 4-to-1 triangle subdivision with edge-midpoint vertices on the sphere."""
    edge_mid: dict[tuple[int, int], int] = {}
    verts_list = list(verts)

    def midpoint(i: int, j: int) -> int:
        key = (min(i, j), max(i, j))
        idx = edge_mid.get(key)
        if idx is None:
            m = verts_list[i] + verts_list[j]
            m = m / np.linalg.norm(m)
            idx = len(verts_list)
            verts_list.append(m)
            edge_mid[key] = idx
        return idx

    new_faces = []
    for a, b, c in faces:
        ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
        new_faces.extend([(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)])
    return np.array(verts_list), np.array(new_faces, dtype=np.int64)


def _canonical_hemisphere(verts: np.ndarray, eps: float = 1e-9) -> np.ndarray:
    """One representative per antipodal pair: v is kept iff z > 0, or
    (z == 0 and x > 0), or (z == 0 and x == 0 and y > 0); the result is
    sorted lexicographically by (z, x, y)."""
    z, x, y = verts[:, 2], verts[:, 0], verts[:, 1]
    keep = (z > eps) | ((np.abs(z) <= eps) & ((x > eps) | ((np.abs(x) <= eps) & (y > eps))))
    kept = verts[keep]
    order = np.lexsort((kept[:, 1], kept[:, 0], kept[:, 2]))
    return kept[order]


def _directions(granularity: int) -> np.ndarray:
    """(B, 3) float64 unit direction table of a granularity level in [0, 6]."""
    if not 0 <= granularity <= 6:
        raise ValueError("granularity must be in [0, 6]")
    verts, faces = _icosahedron()
    for _ in range(granularity):
        verts, faces = _subdivide(verts, faces)
    if granularity == 0:
        out = verts[np.lexsort((verts[:, 1], verts[:, 0], verts[:, 2]))]
    else:
        out = _canonical_hemisphere(verts)
    if out.shape[0] != NUM_DIRECTIONS[granularity]:
        raise AssertionError(
            f"granularity {granularity}: got {out.shape[0]} directions, "
            f"expected {NUM_DIRECTIONS[granularity]}")
    return out / np.linalg.norm(out, axis=1, keepdims=True)


def _plane_bases_for(b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """For b = (x, y, z) with z > -1:
        c1 = (1 - x^2/(1+z), -x*y/(1+z), -x)
        c2 = (-x*y/(1+z),    1 - y^2/(1+z), -y)
    and the xy-plane basis at the (unreached) pole z == -1."""
    x, y, z = b[:, 0], b[:, 1], b[:, 2]
    denom = 1.0 + z
    safe = np.abs(denom) > 1e-12
    inv = np.where(safe, 1.0 / np.where(safe, denom, 1.0), 0.0)
    c1 = np.stack([1.0 - x * x * inv, -x * y * inv, -x], axis=1)
    c2 = np.stack([-x * y * inv, 1.0 - y * y * inv, -y], axis=1)
    fb1 = np.broadcast_to(np.array([1.0, 0.0, 0.0]), c1.shape)
    fb2 = np.broadcast_to(np.array([0.0, -1.0, 0.0]), c2.shape)
    c1 = np.where(safe[:, None], c1, fb1)
    c2 = np.where(safe[:, None], c2, fb2)
    return c1, c2


@functools.lru_cache(maxsize=None)
def hough_space(granularity: int):
    """(directions, c1, c2), each a read-only (B, 3) float64 array."""
    b = _directions(granularity)
    c1, c2 = _plane_bases_for(b)
    for t in (b, c1, c2):
        t.setflags(write=False)
    return b, c1, c2
