"""Ray-cast ToF simulator (numpy): a frozen copy of the port's
``io/simulator.py``.

A pinhole depth camera is ray-cast against a cylinder-beam scene and a
ground plane.  The sensor envelope is the reference drone's ToF RangeFinder
(webots_project/protos/starling.proto:598-606): 64x64 rays, horizontal FOV
2.04 rad, range 0.1-4.0 m, gaussian depth noise with sigma =
noise_frac * max_range.  The camera looks along +x of the drone frame, y to
the left, z up; a world point q maps to the drone frame as R^T (q - p).

`render_flight` renders a whole flight in worker processes: the noise of
every frame is drawn first, in frame order, from one generator, so the
frames are bit-equal to `simulate_trajectory`'s
(`benchmark/tests/test_bench_frozen.py` holds both equal to the port's).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .scene import Cylinder


def quat_to_rot(qw, qx, qy, qz):
    """Rotation matrix of a unit quaternion (w, x, y, z), Eigen's convention,
    as a 3x3 nested tuple."""
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return (
        (1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
        (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
        (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)),
    )


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
                 rng: Optional[np.random.Generator] = None,
                 noise: Optional[np.ndarray] = None) -> np.ndarray:
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

    if noise is None and rng is not None and spec.noise_frac > 0:
        noise = rng.normal(0.0, spec.noise_frac * spec.max_range, size=t_hit.shape)
    if noise is not None:
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


def _render_chunk(args) -> List[np.ndarray]:
    scene, poses, spec, ground_plane, noise = args
    return [render_depth(pos, quat, scene, spec, ground_plane,
                         noise=None if noise is None else noise[k])
            for k, (_, pos, quat) in enumerate(poses)]


def render_flight(scene: Sequence[Cylinder],
                  poses: Sequence[Tuple[float, np.ndarray, np.ndarray]],
                  spec: TofSpec = TofSpec(), seed: Optional[int] = 0,
                  ground_plane: bool = True, workers: int = 1) -> List[Frame]:
    """`simulate_trajectory`'s frames, rendered in `workers` spawned
    processes (1: in this one).  Every worker has ended when it returns."""
    noise = None
    if seed is not None and spec.noise_frac > 0:
        rng = np.random.default_rng(seed)
        noise = rng.normal(0.0, spec.noise_frac * spec.max_range,
                           size=(len(poses), spec.width * spec.height))
    poses = list(poses)
    n_chunks = max(1, min(len(poses), 4 * workers))
    bounds = np.linspace(0, len(poses), n_chunks + 1).astype(int)
    tasks = [(tuple(scene), poses[lo:hi], spec, ground_plane,
              None if noise is None else noise[lo:hi])
             for lo, hi in zip(bounds[:-1], bounds[1:]) if hi > lo]
    if workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        # a worker that dies raises here (BrokenProcessPool), never hangs
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            chunks = list(ex.map(_render_chunk, tasks, timeout=300))
    else:
        chunks = [_render_chunk(t) for t in tasks]
    points = [p for chunk in chunks for p in chunk]
    return [Frame(t=t, position=np.asarray(pos, dtype=np.float64),
                  quat_wxyz=np.asarray(quat, dtype=np.float64), points=pts)
            for (t, pos, quat), pts in zip(poses, points)]
