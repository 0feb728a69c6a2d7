"""Ray-cast ToF simulator (numpy): the replay frames the port is driven with.

A pinhole depth camera is ray-cast against a cylinder-beam scene and a
ground plane.  The sensor envelope is the reference drone's ToF RangeFinder
(webots_project/protos/starling.proto:598-606): 64x64 rays, horizontal FOV
2.04 rad, range 0.1-4.0 m, gaussian depth noise with sigma =
noise_frac * max_range.  The camera looks along +x of the drone frame, y to
the left, z up; a world point q maps to the drone frame as R^T (q - p).
From the same seed the frames are bit-equal to the JAX package's
`io.simulator`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..geometry import quat_to_rot
from .scene import Cylinder


@dataclasses.dataclass(frozen=True)
class TofSpec:
    width: int = 64
    height: int = 64
    fov: float = 2.04          # horizontal field of view, radians
    min_range: float = 0.1
    max_range: float = 4.0
    noise_frac: float = 0.01   # sigma = noise_frac * max_range


def ray_directions(spec: TofSpec) -> np.ndarray:
    """(H*W, 3) unit ray directions in the drone frame (+x forward)."""
    half_w = np.tan(spec.fov / 2.0)
    half_h = half_w * (spec.height / spec.width)
    ys = np.linspace(half_w - half_w / spec.width, -half_w + half_w / spec.width, spec.width)
    zs = np.linspace(half_h - half_h / spec.height, -half_h + half_h / spec.height, spec.height)
    yy, zz = np.meshgrid(ys, zs)
    dirs = np.stack([np.ones_like(yy), yy, zz], axis=-1).reshape(-1, 3)
    return dirs / np.linalg.norm(dirs, axis=1, keepdims=True)


def _ray_cylinder(origins: np.ndarray, dirs: np.ndarray,
                  cyl_c: np.ndarray, cyl_u: np.ndarray,
                  radius: float, half: float) -> np.ndarray:
    """Smallest positive hit distance per ray against one finite cylinder
    (+inf where there is none)."""
    oc = origins - cyl_c
    d_par = dirs @ cyl_u
    oc_par = oc @ cyl_u
    d_perp = dirs - d_par[:, None] * cyl_u
    oc_perp = oc - oc_par[:, None] * cyl_u

    a = (d_perp * d_perp).sum(1)
    b = 2.0 * (d_perp * oc_perp).sum(1)
    c = (oc_perp * oc_perp).sum(1) - radius * radius

    disc = b * b - 4 * a * c
    hit = np.full(len(dirs), np.inf)
    ok = (disc >= 0) & (a > 1e-12)
    if not ok.any():
        return hit
    sq = np.sqrt(np.where(ok, disc, 0.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-b - sq) / (2 * a)
        t2 = (-b + sq) / (2 * a)
    for t in (t1, t2):
        axial = oc_par + t * d_par
        good = ok & (t > 0) & (np.abs(axial) <= half) & (t < hit)
        hit = np.where(good, t, hit)
    return hit


def render_depth(position: np.ndarray, quat_wxyz: np.ndarray,
                 scene: Sequence[Cylinder], spec: TofSpec = TofSpec(),
                 ground_plane: bool = True,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """One simulated ToF frame: (H*W, 3) float32 points in the drone frame,
    NaN where a ray has no hit inside [min_range, max_range]."""
    R = np.array(quat_to_rot(*np.asarray(quat_wxyz, dtype=np.float64)))
    p = np.asarray(position, dtype=np.float64)

    dirs_d = ray_directions(spec)
    dirs_w = dirs_d @ R.T
    origin_w = np.broadcast_to(p, dirs_w.shape)

    t_hit = np.full(len(dirs_w), np.inf)
    for cyl in scene:
        t = _ray_cylinder(origin_w, dirs_w, np.asarray(cyl.center),
                          np.asarray(cyl.axis), cyl.radius, cyl.half)
        t_hit = np.minimum(t_hit, t)

    if ground_plane:
        dz = dirs_w[:, 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            t_floor = np.where(dz < -1e-9, -p[2] / dz, np.inf)
        t_hit = np.minimum(t_hit, np.where(t_floor > 0, t_floor, np.inf))

    if rng is not None and spec.noise_frac > 0:
        noise = rng.normal(0.0, spec.noise_frac * spec.max_range, size=t_hit.shape)
        t_hit = np.where(np.isfinite(t_hit), t_hit + noise, t_hit)

    valid = np.isfinite(t_hit) & (t_hit >= spec.min_range) & (t_hit <= spec.max_range)
    pts_d = dirs_d * t_hit[:, None]
    pts_d = np.where(valid[:, None], pts_d, np.nan)
    return pts_d.astype(np.float32)


@dataclasses.dataclass
class Frame:
    """One replay frame: timestamp, drone pose, raw cloud (drone frame)."""

    t: float
    position: np.ndarray        # (3,)
    quat_wxyz: np.ndarray       # (4,)
    points: np.ndarray          # (N, 3) float32, NaN for invalid returns


def simulate_trajectory(scene: Sequence[Cylinder],
                        poses: Sequence[Tuple[float, np.ndarray, np.ndarray]],
                        spec: TofSpec = TofSpec(),
                        seed: Optional[int] = 0,
                        ground_plane: bool = True) -> List[Frame]:
    """Render one frame per pose, the noise drawn from one generator seeded
    with `seed` (no noise when seed is None)."""
    rng = np.random.default_rng(seed) if seed is not None else None
    return [Frame(t=t, position=np.asarray(pos, dtype=np.float64),
                  quat_wxyz=np.asarray(quat, dtype=np.float64),
                  points=render_depth(pos, quat, scene, spec, ground_plane, rng))
            for (t, pos, quat) in poses]


def cylinder_surface_cloud(cyl: Cylinder, n: int, seed: int = 0,
                           noise: float = 0.0) -> np.ndarray:
    """Uniform samples on a cylinder's lateral surface (property-test helper)."""
    rng = np.random.default_rng(seed)
    u = np.asarray(cyl.axis)
    # orthonormal frame around the axis
    ref = np.array([1.0, 0.0, 0.0]) if abs(u[0]) < 0.9 else np.array([0.0, 1.0, 0.0])
    v1 = np.cross(u, ref)
    v1 /= np.linalg.norm(v1)
    v2 = np.cross(u, v1)
    h = rng.uniform(-cyl.half, cyl.half, size=n)
    th = rng.uniform(0, 2 * np.pi, size=n)
    pts = (np.asarray(cyl.center)[None, :]
           + h[:, None] * u[None, :]
           + cyl.radius * (np.cos(th)[:, None] * v1[None, :]
                           + np.sin(th)[:, None] * v2[None, :]))
    if noise > 0:
        pts = pts + rng.normal(0, noise, size=pts.shape)
    return pts
