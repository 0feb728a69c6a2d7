"""Cylinder-beam scenes and waypoint trajectories (numpy): a frozen copy.

The expressions of the port's ``io/scene.py`` (`axis_angle_to_rot`,
`Cylinder`, `_cyl`, `yaw_to_quat_wxyz`, `trajectory_poses`), kept here so
that a later change to the port cannot move the benchmark's frames; the
port's `OBS_TESTS_SCENE` and `WP_TESTS` are data in
``configs/tests_g6.json``.  `benchmark/tests/test_bench_frozen.py` holds
them equal to the port's.

`scene_from(spec)` and `waypoints_from(spec)` build a configuration file's
``scene`` and ``waypoints`` entries, so a new deployment is a data file.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np


def axis_angle_to_rot(axis: Sequence[float], angle: float) -> np.ndarray:
    """Rodrigues rotation matrix from a (not necessarily unit) axis and angle."""
    u = np.asarray(axis, dtype=np.float64)
    u = u / np.linalg.norm(u)
    c, s = np.cos(angle), np.sin(angle)
    ux, uy, uz = u
    K = np.array([[0, -uz, uy], [uz, 0, -ux], [-uy, ux, 0]])
    return c * np.eye(3) + s * K + (1 - c) * np.outer(u, u)


@dataclasses.dataclass(frozen=True)
class Cylinder:
    """A finite cylinder beam: center, unit axis, radius, full height."""

    center: Tuple[float, float, float]
    axis: Tuple[float, float, float]
    radius: float
    height: float

    @property
    def half(self) -> float:
        return self.height / 2.0


def _cyl(translation, rotation_axis_angle, radius=0.05, height=2.0) -> Cylinder:
    ax, ay, az, angle = rotation_axis_angle
    axis = axis_angle_to_rot((ax, ay, az), angle) @ np.array([0.0, 0.0, 1.0])
    axis = axis / np.linalg.norm(axis)
    return Cylinder(tuple(float(v) for v in translation),
                    tuple(float(v) for v in axis), radius, height)


def yaw_to_quat_wxyz(yaw: float) -> np.ndarray:
    """Quaternion (w, x, y, z) of a pure-yaw drone orientation."""
    return np.array([np.cos(yaw / 2.0), 0.0, 0.0, np.sin(yaw / 2.0)])


def trajectory_poses(waypoints: Sequence[Sequence[float]], hz: float = 5.0,
                     velocity: float = 0.1) -> List[Tuple[float, np.ndarray, np.ndarray]]:
    """(t, position, quat_wxyz) poses along a waypoint path, sampled at `hz`:
    straight lines between consecutive waypoints at constant speed, yaw
    turned along the shortest arc."""
    poses = []
    t = 0.0
    prev = np.asarray(waypoints[0][:3], dtype=np.float64)
    prev_yaw = float(waypoints[0][3])
    poses.append((t, prev.copy(), yaw_to_quat_wxyz(prev_yaw)))
    for wp in list(waypoints[1:]):
        target = np.asarray(wp[:3], dtype=np.float64)
        yaw = float(wp[3])
        dist = float(np.linalg.norm(target - prev))
        steps = max(int(np.ceil(dist / velocity * hz)), 1)
        dyaw = (yaw - prev_yaw + np.pi) % (2 * np.pi) - np.pi
        for k in range(1, steps + 1):
            frac = k / steps
            t += 1.0 / hz
            pos = prev + frac * (target - prev)
            yw = prev_yaw + frac * dyaw
            poses.append((t, pos, yaw_to_quat_wxyz(yw)))
        prev, prev_yaw = target, prev_yaw + dyaw
    return poses


def scene_from(spec: dict) -> Tuple[Cylinder, ...]:
    """A configuration's ``scene``: {"solids": [[tx, ty, tz, ax, ay, az,
    angle, radius, height], ...]}, Webots solids as `_cyl` reads them."""
    return tuple(_cyl(s[0:3], s[3:7], radius=s[7], height=s[8])
                 for s in spec["solids"])


def waypoints_from(spec) -> Tuple[Tuple[float, ...], ...]:
    """A configuration's ``waypoints``: a list of (x, y, z, yaw, duration)
    rows."""
    return tuple(tuple(float(v) for v in row) for row in spec)
