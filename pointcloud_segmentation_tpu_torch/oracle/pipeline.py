"""Faithful numpy reference implementation ("the oracle").

The port's own copy of the JAX package's oracle/pipeline.py: the same code,
importing the port's config, sphere and geometry.  It is a from-scratch
reimplementation of the reference pipeline's *documented intent* (reference:
src/pointcloud_segmentation_node.cpp,
include/pointcloud_segmentation/hough_3d_lines.h, and the report's algorithm
spec), written in vectorized float64 numpy.  It plays three roles:

  1. the CPU baseline (the reference C++ needs ROS and PCL, and its Hough
     submodule is missing from the snapshot);
  2. the golden source for the PyTorch pipeline's parity tests
     (compute_dtype="float64" agrees with it within 1e-4);
  3. the executable specification of every algorithmic decision.

Known deliberate deviations from the reference C++ (each flagged D-<name>
here and summarized in README.md):

  D-GRAN   granularity actually selects the direction count.  In the
           reference the fork's initHoughSpace() fixes the sphere at startup
           and the per-call `granularity` only feeds a memory-estimate log
           line (SURVEY.md §2.3); the documented intent (config.yaml:22-23,
           README.md:44) is a 0..6 search granularity.
  D-WEIGHT fusion weight uses float division.  node.cpp:617 divides two ints
           (`points_size`), which truncates to 0 and pins the weight at
           min_weight; the report §3.2.6 formula is real-valued.
  D-FUSE   checkSimilarity's fused `points_size`, `pca_coeff`,
           `pca_eigenvalues` blend the *world* segment's values
           (node.cpp:652-655 reads uninitialized target_seg fields; the
           report §3.2.6 blends old/new).
  D-NEWIDX newly appended world segments trigger intersection recomputation
           at their actual indices (node.cpp:508 records
           `new_world_segments.size() + i`, past the matrix), including the
           first wholesale-assigned frame (node.cpp:487-488 records none).
  D-SIGN   extracted line directions are sign-canonicalized
           (geometry.canonicalize_direction); the reference keeps Eigen's
           arbitrary eigenvector sign.
  D-POSE   a failed pose lookup skips the frame; node.cpp:281-283 `return`s,
           permanently killing the worker thread.
  D-ITER   opt_nlines == 0 ("extract until points run out") is bounded by
           shapes.max_iters (default 24; the device loop keeps a static
           trip bound, and the oracle mirrors it for parity).  The
           reference iterates unbounded while >= opt_minvotes points
           remain (h:341-342).  Escape hatch: raise max_iters; shipped
           configs use opt_nlines = 10 and are unaffected.

Reference quirks *reproduced* on purpose (they are observable behavior):
  * t computed from x components only; b.x == 0 aborts the frame's extraction
    keeping earlier lines and reporting nblines = 0 (h:43-45, h:276-279).
  * radius measured from the first/last inlier in cloud order, not the
    extremes (h:295).
  * `max_radius` gate folds raw radius values into a difference
    (h:298-307).
  * nlines counts every refined candidate, including gate failures (h:259).
  * stale intersection entries persist until a touched-pair recheck
    overwrites them (node.cpp:484, 531-534).
  * two new segments matching the same world segment both fuse against the
    *old* world segment; the later result wins (node.cpp:495-498).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from ..config import PipelineConfig
from ..sphere import hough_space
from . import _geometry as geometry


# --------------------------------------------------------------------------
# Pre-processing (reference: node.cpp:386-421)
# --------------------------------------------------------------------------

def passthrough_filter(points: np.ndarray, window_size: float) -> np.ndarray:
    """PCL PassThrough x3: keep x in [0, w/2], y in [-w/2, w/2], z in [-w/2, w/2].

    Inclusive bounds; NaN/Inf coordinates fail every comparison and drop out
    (node.cpp:392-407).
    """
    half = window_size / 2.0
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    with np.errstate(invalid="ignore"):
        keep = (
            (x >= 0.0) & (x <= half)
            & (y >= -half) & (y <= half)
            & (z >= -half) & (z <= half)
        )
    return points[keep]


def voxel_grid(points: np.ndarray, leaf: float) -> np.ndarray:
    """PCL VoxelGrid with cubic leaf: centroid per occupied voxel.

    Output ordered by ascending linear voxel index, which for PCL's
    divb_mul = (1, dx, dx*dy) layout is lexicographic (iz, iy, ix)
    (node.cpp:410-413; PCL VoxelGrid semantics).
    """
    if len(points) == 0:
        return points.reshape(0, 3)
    ijk = np.floor(points / leaf).astype(np.int64)
    # Lexicographic (z, y, x) sort == ascending PCL linear index.
    order = np.lexsort((ijk[:, 0], ijk[:, 1], ijk[:, 2]))
    ijk_s = ijk[order]
    pts_s = points[order]
    new_group = np.ones(len(pts_s), dtype=bool)
    new_group[1:] = np.any(ijk_s[1:] != ijk_s[:-1], axis=1)
    group_id = np.cumsum(new_group) - 1
    n_groups = group_id[-1] + 1
    sums = np.zeros((n_groups, 3), dtype=np.float64)
    np.add.at(sums, group_id, pts_s)
    counts = np.bincount(group_id, minlength=n_groups).astype(np.float64)
    return sums / counts[:, None]


def cloud_filtering(points: np.ndarray, cfg: PipelineConfig) -> np.ndarray:
    """Window crop + voxel downsample (node.cpp:386-421)."""
    return voxel_grid(passthrough_filter(points, cfg.window_size), cfg.leaf_size)


# --------------------------------------------------------------------------
# Segment container (reference: hough_3d_lines.h:21-29 `struct segment`)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Segment:
    a: np.ndarray                 # line anchor (3,)
    b: np.ndarray                 # line direction (3,)
    t_min: float
    t_max: float
    radius: float
    points: np.ndarray            # inlier points (n, 3)
    points_size: int
    pca_coeff: float
    pca_eigenvalues: np.ndarray   # (3,) descending

    def copy(self) -> "Segment":
        return Segment(self.a.copy(), self.b.copy(), self.t_min, self.t_max,
                       self.radius, self.points.copy(), self.points_size,
                       self.pca_coeff, self.pca_eigenvalues.copy())

    def endpoints(self) -> Tuple[np.ndarray, np.ndarray]:
        return geometry.segment_endpoints(self.a, self.b, self.t_min, self.t_max)


# --------------------------------------------------------------------------
# Orthogonal least squares + PCA (hough_3d_lines.h:94-150)
# --------------------------------------------------------------------------

def orthogonal_lsq(points: np.ndarray) -> Tuple[float, np.ndarray, np.ndarray]:
    """Anchor = centroid; direction = principal scatter eigenvector.

    Returns (largest eigenvalue, a, b).  The reference computes the scatter
    eigendecomposition in float32 (h:129 MatrixXf) — reproduced.
    """
    a = points.mean(axis=0)
    pts32 = points.astype(np.float32)
    centered = pts32 - pts32.mean(axis=0)
    scatter = centered.T @ centered
    w, v = np.linalg.eigh(scatter.astype(np.float32))
    b = v[:, 2].astype(np.float64)
    return float(w[2]), a, b


def seg_pca_eigenvalues(points: np.ndarray) -> np.ndarray:
    """Eigenvalues (descending) of the inlier covariance (h:94-110 segPCA).

    Only the ratio lambda0/sum is consumed downstream, so the covariance
    normalization (n-1, as in PCL's PCA) is recorded but non-critical.
    """
    n = len(points)
    pts32 = points.astype(np.float32)
    centered = pts32 - pts32.mean(axis=0)
    denom = max(n - 1, 1)
    cov = (centered.T @ centered) / denom
    w = np.linalg.eigvalsh(cov)
    return w[::-1].astype(np.float64)


# --------------------------------------------------------------------------
# Hough voting core (rebuilt from the submodule contract, SURVEY.md §2.3)
# --------------------------------------------------------------------------

class HoughSpace:
    """Accumulator-equivalent voting over the direction sphere.

    Instead of materializing the (B, num_x, num_x) accumulator and mutating
    it with add/subtract (the reference's Hough class), the oracle recomputes
    votes from the *currently active* point set each round — mathematically
    identical because the reference's subtract(Y)/removePoints(Y) keep the
    accumulator equal to the votes of the remaining points (node add at
    h:228, subtract at h:241, removal at h:339).

    Cell convention (the submodule is missing, so this is our canonical
    definition, shared bit-for-bit with the device pipeline):
      num_x = floor(d / dx + 0.5)              (h:214's estimate)
      x'    = p . c1(b),  y' = p . c2(b)       (shifted coords)
      xi    = clip(floor((x' + d/2) / dx), 0, num_x - 1)
      decode: x'_c = (xi + 0.5) * dx - d/2
    Argmax tie-break: lexicographically smallest (b, xi, yi).
    """

    def __init__(self, granularity: int, dx: float, d: float):
        self.directions, self.c1, self.c2 = hough_space(granularity)
        self.c1_32 = self.c1.astype(np.float32)
        self.c2_32 = self.c2.astype(np.float32)
        self.dx = dx
        self.d = d
        self.num_x = max(int(math.floor(d / dx + 0.5)), 1)

    def bin_indices(self, pts: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(n, B) xi and yi bins for shifted points.

        Binning arithmetic is float32 BY SPEC, with the fixed association
        order (p0*c + p1*c) + p2*c, so the oracle and the device pipeline land
        points in identical cells (the kernels bin in f32; a matmul here would
        leave the summation order/precision to the backend).
        """
        p32 = pts.astype(np.float32)
        x0, x1, x2 = p32[:, 0:1], p32[:, 1:2], p32[:, 2:3]
        c1, c2 = self.c1_32, self.c2_32
        xp = (x0 * c1[None, :, 0] + x1 * c1[None, :, 1]) + x2 * c1[None, :, 2]
        yp = (x0 * c2[None, :, 0] + x1 * c2[None, :, 1]) + x2 * c2[None, :, 2]
        half = np.float32(self.d / 2.0)
        dx32 = np.float32(self.dx)
        xi = np.clip(np.floor((xp + half) / dx32).astype(np.int64), 0, self.num_x - 1)
        yi = np.clip(np.floor((yp + half) / dx32).astype(np.int64), 0, self.num_x - 1)
        return xi, yi

    def get_line(self, pts: np.ndarray) -> Tuple[int, np.ndarray, np.ndarray]:
        """Global argmax cell over the active points -> (votes, a, b)."""
        num_b = len(self.directions)
        cells = self.num_x * self.num_x
        xi, yi = self.bin_indices(pts)
        # flat key per (point, direction): b * num_x^2 + xi * num_x + yi
        base = np.arange(num_b, dtype=np.int64) * cells
        keys = base[None, :] + xi * self.num_x + yi
        # chunk over directions to bound BOTH the keys slice (chunk * n) and
        # the bincount output (chunk * cells) — at granularity 6 a small
        # cloud would otherwise pull every direction into one chunk and
        # bincount would allocate num_b * num_x^2 int64s (multi-GB).
        best_count, best_key = 0, -1
        chunk = max(1, int(2e7) // max(len(pts), cells, 1))
        for b0 in range(0, num_b, chunk):
            b1 = min(b0 + chunk, num_b)
            sub = keys[:, b0:b1] - base[b0]
            counts = np.bincount(sub.ravel(), minlength=(b1 - b0) * cells)
            idx = int(np.argmax(counts))          # first max == smallest key
            cnt = int(counts[idx])
            if cnt > best_count:                  # strict: earlier chunk wins ties
                best_count, best_key = cnt, idx + base[b0]
        b_idx, rem = divmod(best_key, cells)
        xi_c, yi_c = divmod(rem, self.num_x)
        # decode in float32 BY SPEC (shared with the device path)
        half = np.float32(self.d / 2.0)
        dx32 = np.float32(self.dx)
        xc = (np.float32(xi_c) + np.float32(0.5)) * dx32 - half
        yc = (np.float32(yi_c) + np.float32(0.5)) * dx32 - half
        a = (xc * self.c1_32[b_idx] + yc * self.c2_32[b_idx]).astype(np.float64)
        return best_count, a, self.directions[b_idx].copy()


def points_close_to_line(pts: np.ndarray, a: np.ndarray, b: np.ndarray,
                         dx: float) -> np.ndarray:
    """Mask of points within distance dx of the line (inclusive, unit b)."""
    bu = b / np.linalg.norm(b)
    return geometry.point_line_distance(a, bu, pts) <= dx


# --------------------------------------------------------------------------
# Iterative Hough line extraction (hough_3d_lines.h:167-349)
# --------------------------------------------------------------------------

STATUS_OK = 0
STATUS_DEGENERATE = 1      # empty cloud / all points identical (h:202)
STATUS_DX_TOO_LARGE = 2    # opt_dx >= cloud diagonal (h:209)
STATUS_BX_ZERO = 3         # find_t failure: refined b.x == 0 (h:43-45, 276-279)


def hough3dlines(points: np.ndarray, cfg: PipelineConfig,
                 max_iters: Optional[int] = None) -> Tuple[List[Segment], int, int]:
    """Extract line segments from one (already pre-filtered) cloud.

    Returns (segments, nblines_extracted, status).  The reference collapses
    every abort path into a single nonzero return; the rebuild keeps an
    explicit taxonomy (STATUS_*) so callers can tell sensor dropouts from
    parameter errors — the failure-detection upgrade called out in
    SURVEY.md §5.  STATUS_BX_ZERO keeps already-extracted segments and
    reports 0 lines, matching the caller's untouched counter at node.cpp:293.
    """
    # NaN/Inf scrub (h:175-189)
    finite = np.isfinite(points).all(axis=1)
    X = points[finite].astype(np.float64)

    segments: List[Segment] = []
    nlines = 0
    if len(X) == 0:
        return segments, 0, STATUS_DEGENERATE

    minP, maxP = X.min(axis=0), X.max(axis=0)
    d = float(np.linalg.norm(maxP - minP))
    if d == 0.0:
        return segments, 0, STATUS_DEGENERATE    # "All points identical"
    if cfg.opt_dx >= d:
        return segments, 0, STATUS_DX_TOO_LARGE  # "dx too large"

    shift = (minP + maxP) / 2.0                   # shiftToOrigin (h:206)
    Xs = X - shift
    hs = HoughSpace(cfg.granularity, cfg.opt_dx, d)

    active = np.ones(len(Xs), dtype=bool)
    if max_iters is None:
        max_iters = cfg.opt_nlines if cfg.opt_nlines > 0 else cfg.shapes.max_iters

    it = 0
    while active.sum() > 1 and (cfg.opt_nlines == 0 or nlines < cfg.opt_nlines):
        it += 1
        if it > max_iters:
            break
        _, a, b = hs.get_line(Xs[active])

        # refinement #1 (h:245-248)
        m1 = active & points_close_to_line(Xs, a, b, cfg.opt_dx)
        if not m1.any():
            break
        rc, a, b = orthogonal_lsq(Xs[m1])
        if rc == 0.0:
            break

        # refinement #2 + vote gate (h:250-255)
        m2 = active & points_close_to_line(Xs, a, b, cfg.opt_dx)
        nvotes = int(m2.sum())
        if nvotes < cfg.opt_minvotes:
            break
        rc, a, b = orthogonal_lsq(Xs[m2])
        if rc == 0.0:
            break

        b = geometry.canonicalize_direction(b)    # D-SIGN
        a = a + shift                             # back to input frame (h:257)
        nlines += 1                               # counts gate failures too (h:259)

        pts = Xs[m2] + shift                      # inliers, original cloud order
        proj = geometry.find_proj(a[None, :], b[None, :], pts)
        p_radius = np.linalg.norm(proj - pts, axis=1)
        if b[0] == 0.0:                           # find_t failure (h:43-45)
            return segments, 0, STATUS_BX_ZERO
        t = (proj[:, 0] - a[0]) / b[0]

        # sorted-t ordering; gap check uses ||a + t*b|| over that order
        order = np.argsort(t, kind="stable")
        ts = t[order]
        p_norm = np.linalg.norm(a[None, :] + ts[:, None] * b[None, :], axis=1)
        max_gap = float(np.abs(np.diff(p_norm)).max()) if len(p_norm) > 1 else 0.0

        # radius: first/last inlier in cloud order (h:295)
        radius = max(p_radius[0], p_radius[-1])
        rs = np.asarray(cfg.radius_sizes)
        diffs = np.abs(radius - rs)
        k = int(np.argmin(diffs))                 # first strict min (h:299-304)
        closest_radius = float(rs[k])
        min_radius_diff = float(diffs[k])
        max_radius = max(float(diffs[0]), float(rs.max()))  # quirk (h:298-307)

        if (min_radius_diff < cfg.diag_voxel and max_radius <= closest_radius
                and max_gap < 2 * cfg.diag_voxel):
            eig = seg_pca_eigenvalues(pts)
            pca_coeff = float(eig[0] / eig.sum())
            p1 = ts[0] * b + a
            p2 = ts[-1] * b + a
            length = float(np.linalg.norm(p2 - p1))
            min_nb = int(2.0 * closest_radius * length
                         / (cfg.rad_2_leaf_ratio * (2 * cfg.diag_voxel) ** 2))
            if pca_coeff > cfg.min_pca_coeff and len(pts) > min_nb:
                segments.append(Segment(
                    a=a, b=b, t_min=float(ts[0]), t_max=float(ts[-1]),
                    radius=closest_radius, points=pts, points_size=len(pts),
                    pca_coeff=pca_coeff, pca_eigenvalues=eig,
                ))

        active &= ~m2                             # removePoints (h:339)

    return segments, nlines, 0


# --------------------------------------------------------------------------
# Frame transform + floor cutoff (node.cpp:429-470)
# --------------------------------------------------------------------------

def surface_offset_correction(segments: List[Segment]) -> None:
    """In-place opt-in accuracy extension (E-OFFSET, beyond the reference):
    undo the report's §6.3 "Ground Truth Offset" — ToF returns lie on the
    beam SURFACE facing the sensor, biasing the fitted axis toward the
    sensor by ~one radius.  Drone frame (sensor at origin): shift each axis
    by its matched radius along the sensor->line perpendicular.  Lines
    through the origin are left untouched.  Mirrors
    pipeline.surface_offset_correction (the device path)."""
    for s in segments:
        bn = s.b / max(np.linalg.norm(s.b), 1e-12)
        perp = s.a - (s.a @ bn) * bn
        nrm = np.linalg.norm(perp)
        if nrm > 1e-6:
            s.a = s.a + s.radius * perp / nrm


def drone_to_world(segments: List[Segment], position: np.ndarray,
                   quat_wxyz: np.ndarray) -> None:
    """In-place a <- R a + p, b <- R b, points <- R pts + p (node.cpp:429-446)."""
    R = np.array(geometry.quat_to_rot(*quat_wxyz), dtype=np.float64)
    for s in segments:
        s.a = R @ s.a + position
        s.b = R @ s.b
        s.points = s.points @ R.T + position


def height_cutoff(segments: List[Segment], floor_trim_height: float) -> List[Segment]:
    """Keep a segment iff either endpoint is above the floor (node.cpp:454-470)."""
    out = []
    for s in segments:
        p1, p2 = s.endpoints()
        if p1[2] > floor_trim_height or p2[2] > floor_trim_height:
            out.append(s)
    return out


# --------------------------------------------------------------------------
# World-map fusion + intersections (node.cpp:479-667)
# --------------------------------------------------------------------------

def check_similarity(drone_seg: Segment, world_seg: Segment,
                     cfg: PipelineConfig) -> Tuple[bool, Optional[Segment]]:
    """Projection similarity + weighted fusion (node.cpp:596-667).

    Returns (similar, fused_segment).  D-WEIGHT and D-FUSE apply (see module
    docstring).
    """
    w_p1, w_p2 = world_seg.endpoints()
    d_p1, d_p2 = drone_seg.endpoints()
    proj1 = geometry.find_proj(world_seg.a, world_seg.b, d_p1)
    proj2 = geometry.find_proj(world_seg.a, world_seg.b, d_p2)

    epsilon = drone_seg.radius + world_seg.radius + 2 * (2 * cfg.diag_voxel)
    if not (np.linalg.norm(proj1 - d_p1) < epsilon
            and np.linalg.norm(proj2 - d_p2) < epsilon
            and drone_seg.radius == world_seg.radius):
        return False, None

    # D-WEIGHT: real-valued ratio (report §3.2.6); reference divides ints.
    weight = drone_seg.points_size / (world_seg.points_size + drone_seg.points_size)
    weight = max(cfg.min_weight, weight)
    coeff_fusion = (drone_seg.pca_coeff * weight) / (
        world_seg.pca_coeff * (1 - weight) + drone_seg.pca_coeff * weight)

    new_a = proj1 + coeff_fusion * (d_p1 - proj1)
    new_b = (proj2 - proj1) + coeff_fusion * ((d_p2 - proj2) - (d_p1 - proj1))

    t_proj = []
    with np.errstate(divide="ignore", invalid="ignore"):
        for p in (d_p1, d_p2, w_p1, w_p2):
            pp = geometry.find_proj(new_a, new_b, p)
            t_proj.append((pp[0] - new_a[0]) / new_b[0])   # x-division quirk
    t_proj = np.array(t_proj)
    if not np.isfinite(t_proj).all():
        return False, None                                  # b.x == 0 -> NaN -> no match

    # overlap check (node.cpp:642-643)
    if (min(t_proj[0], t_proj[1]) > max(t_proj[2], t_proj[3])
            or max(t_proj[0], t_proj[1]) < min(t_proj[2], t_proj[3])):
        return False, None

    fused = Segment(
        a=new_a,
        b=new_b,
        t_min=float(t_proj.min()),
        t_max=float(t_proj.max()),
        radius=drone_seg.radius,
        # D-FUSE: blend against the world segment's fields (report §3.2.6).
        points=np.concatenate([world_seg.points, drone_seg.points], axis=0),
        points_size=world_seg.points_size + drone_seg.points_size,
        pca_coeff=world_seg.pca_coeff * (1 - weight) + drone_seg.pca_coeff * weight,
        pca_eigenvalues=(world_seg.pca_eigenvalues * (1 - weight)
                         + drone_seg.pca_eigenvalues * weight),
    )
    return True, fused


def check_connections(seg_i: Segment, seg_j: Segment,
                      cfg: PipelineConfig) -> Tuple[bool, Optional[np.ndarray]]:
    """Pairwise intersection test (node.cpp:554-584).

    seg_i plays the reference's `drone_seg` role, seg_j the `world_seg` role
    (call order at node.cpp:529).  Returns (connected, sol) where sol =
    (t_i_offset, t_j_offset, signed_distance).
    """
    p1_i = seg_i.t_min * seg_i.b + seg_i.a
    p1_j = seg_j.t_min * seg_j.b + seg_j.a

    cross = np.cross(seg_j.b, seg_i.b)
    if np.linalg.norm(cross) < 1e-2:
        return False, None
    cross = cross / np.linalg.norm(cross)

    LHS = np.stack([seg_i.b, -seg_j.b, cross], axis=1)
    RHS = p1_j - p1_i
    try:
        sol = np.linalg.solve(LHS, RHS)
    except np.linalg.LinAlgError:
        return False, None
    dist = abs(sol[2])

    eps = 2 * cfg.diag_voxel + seg_i.radius + seg_j.radius
    if (seg_i.t_min <= sol[0] + seg_i.t_min <= seg_i.t_max
            and seg_j.t_min <= sol[1] + seg_j.t_min <= seg_j.t_max
            and dist < eps):
        return True, sol
    return False, None


class WorldMap:
    """Persistent world segment set + triangular intersection matrix.

    Mirrors PtCdProcessing's `world_segments` / `intersection_matrix` state
    and segFiltering (node.cpp:479-542), with D-NEWIDX applied.
    """

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.segments: List[Segment] = []
        # intersection_matrix[i][j] for j < i, sentinel (-1, -1)
        self.inter: np.ndarray = np.full((0, 0, 2), -1.0)

    def _resize_inter(self, n: int) -> None:
        old = self.inter
        new = np.full((n, n, 2), -1.0)
        k = old.shape[0]
        if k:
            new[:k, :k] = old
        self.inter = new

    def step(self, drone_segments: List[Segment]) -> None:
        old_world = self.segments
        new_world = [s for s in old_world]
        modified: List[int] = []
        new_idx: List[int] = []

        if not old_world:
            new_world = [s.copy() for s in drone_segments]
            new_idx = list(range(len(new_world)))         # D-NEWIDX
        else:
            for dseg in drone_segments:
                found = False
                for j, wseg in enumerate(old_world):       # match vs OLD world
                    similar, fused = check_similarity(dseg, wseg, self.cfg)
                    if similar:
                        new_world[j] = fused               # later match overwrites
                        modified.append(j)
                        found = True
                        break
                if not found:
                    new_world.append(dseg.copy())
                    new_idx.append(len(new_world) - 1)     # D-NEWIDX

        self._resize_inter(len(new_world))
        touched = set(modified) | set(new_idx)
        for i in range(len(new_world)):
            for j in range(i):
                if i in touched or j in touched:
                    ok, sol = check_connections(new_world[i], new_world[j], self.cfg)
                    if ok:
                        self.inter[i, j] = (new_world[i].t_min + sol[0],
                                            new_world[j].t_min + sol[1])
                    # else: stale value persists (node.cpp:531-534)

        self.segments = new_world

    def intersections_rows(self) -> List[Tuple[int, float, int, float]]:
        """(seg1, t1, seg2, t2) rows, upper-triangular scan (node.cpp:858-868)."""
        rows = []
        for i in range(len(self.segments)):
            for j in range(i):
                t1, t2 = self.inter[i, j]
                if t1 != -1.0 and t2 != -1.0:
                    rows.append((i, float(t1), j, float(t2)))
        return rows


# --------------------------------------------------------------------------
# Full per-frame step (node.cpp:267-348 processData body)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class FrameResult:
    segments_in_frame: List[Segment]
    nblines: int
    status: int


def process_frame(world: WorldMap, points: np.ndarray, position: np.ndarray,
                  quat_wxyz: np.ndarray, cfg: PipelineConfig) -> FrameResult:
    """One frame: filter -> hough -> transform -> cutoff -> fuse (+intersections)."""
    filtered = cloud_filtering(np.asarray(points, dtype=np.float64), cfg)
    segs, nlines, status = hough3dlines(filtered, cfg)
    if cfg.surface_offset_correction:
        surface_offset_correction(segs)
    drone_to_world(segs, np.asarray(position, dtype=np.float64),
                   np.asarray(quat_wxyz, dtype=np.float64))
    segs = height_cutoff(segs, cfg.floor_trim_height)
    world.step(segs)
    return FrameResult(segments_in_frame=segs, nblines=nlines, status=status)
