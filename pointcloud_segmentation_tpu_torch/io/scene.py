"""Cylinder-beam scenes, ground truth and waypoint trajectories (numpy).

The benchmark scene is the 7 `DEF SEGn Solid` cylinder nodes of the
reference's `webots_project/worlds/flying_arena_ros_obs_tests.wbt:57-168`
(radius 0.05 m, Webots' default cylinder height 2 m, axis = the solid's
rotated z-axis), flown along `config_auto_pilot/wp_tests.csv`.  The values
equal the JAX package's `io.scene`, so both packages replay the same frames.
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


# The 7-beam benchmark scene (flying_arena_ros_obs_tests.wbt:57-168).
OBS_TESTS_SCENE: Tuple[Cylinder, ...] = (
    _cyl((0.140955, 0.444511, 1.3316),
         (-0.11970795319198484, 0.9793766170456991, -0.1627619363570842, 3.04251)),
    _cyl((0.300618, -0.213726, 1.33593),
         (0.12940996646263506, -0.9659257496745788, -0.22414394191176013, 3.14159)),
    _cyl((0.192667, -0.853663, 1.41041),
         (0.12507095630529586, -0.9915816535817087, 0.03351238829213484, -3.074595307179586)),
    _cyl((0.271216, -0.103092, 2.58827),
         (0.030414214506646418, 0.686090327244019, -0.7268803466996057, 3.09612)),
    _cyl((0.0865667, 0.899984, 1.16655),
         (0.0367934994702426, 0.35562299487969573, -0.9339049865535194, 3.12286)),
    _cyl((-0.178779, -0.25669, 1.20063),
         (-0.045615321329020145, 0.8478743964529802, -0.5282312469927775, 2.85945)),
    _cyl((-0.105909, 0.704094, 2.24618),
         (0.021813100871077736, -0.3748000149671498, 0.9268490370125075, 2.11988)),
)

# wp_tests.csv: the 3-waypoint vertical scan of the benchmark runs
# (x, y, z, yaw, duration).
WP_TESTS = (
    (1.0, 0.0, 0.3, 3.14, 5.0),
    (1.0, 0.0, 2.0, 3.14, 15.0),
    (1.0, 0.0, 0.1, 3.14, 100.0),
)


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
