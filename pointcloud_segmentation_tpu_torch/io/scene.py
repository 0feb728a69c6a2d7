"""Cylinder-beam scenes, ground truth and waypoint trajectories (numpy).

The benchmark scene is the 7 `DEF SEGn Solid` cylinder nodes of the
reference's `webots_project/worlds/flying_arena_ros_obs_tests.wbt:57-168`
(radius 0.05 m, Webots' default cylinder height 2 m, axis = the solid's
rotated z-axis), flown along `config_auto_pilot/wp_tests.csv`; the other scenes are the
CLI's registry (`--scene`) and `parse_wbt_scene` reads ground truth from a
Webots world file.  The values equal the JAX package's `io.scene`, so both
packages replay the same frames and evaluate against the same truth.
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

    def endpoints(self) -> Tuple[np.ndarray, np.ndarray]:
        c = np.asarray(self.center)
        u = np.asarray(self.axis)
        return c - self.half * u, c + self.half * u

    def as_truth(self) -> dict:
        """Ground-truth record in the reference's tests_structure.py schema."""
        return {
            "a": list(self.center),
            "b": list(self.axis),
            "endpoints": [-self.half, self.half],
        }


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

# The 9-beam development scene (flying_arena_ros_obs.wbt "solid(2..10)"
# nodes: radius 0.1 m, Webots default cylinder height 2 m; solid(1) is a
# vertical pole at z=6.89, far above the flight envelope, and is excluded
# exactly as the report's §5.1 "9 beams" count does).  Flown with a
# figure-eight trajectory in the reference (launch/trajectory.launch:4
# `trajectory default="eight"`).
OBS_DEV_SCENE: Tuple[Cylinder, ...] = (
    _cyl((2.75375, 0.89336, 1.52202),
         (0.7823670356685052, 0.2383310108656302, -0.5754130262333681,
          -0.4186153071795866), radius=0.1),
    _cyl((-2.45592, -0.45415, 1.2094),
         (0.7823670356685052, 0.2383310108656302, -0.5754130262333681,
          -0.4186153071795866), radius=0.1),
    _cyl((-2.189, 0.93272, 1.30273),
         (0.596377737329658, -0.10475895385966225, 0.7958386494785148,
          0.32385), radius=0.1),
    _cyl((-0.971105, 2.09014, 1.54241),
         (0.596377737329658, -0.10475895385966225, 0.7958386494785148,
          0.32385), radius=0.1),
    _cyl((1.15464, 1.83805, 1.51149),
         (0.596377737329658, -0.10475895385966225, 0.7958386494785148,
          0.32385), radius=0.1),
    _cyl((-1.52756, -2.84853, 1.11555),
         (-0.5081508748422008, 0.8521297901200324, 0.1251299691804298,
          0.791712), radius=0.1),
    _cyl((-0.0203899, -1.82842, 2.92987),
         (-0.5081508748422008, 0.8521297901200324, 0.1251299691804298,
          0.791712), radius=0.1),
    _cyl((2.03084, -1.93608, 1.63957),
         (-0.16522405819258446, 0.97735434422817, -0.13221004656491542,
          2.5301), radius=0.1),
    _cyl((-0.619799, 1.9117, 1.48107),
         (0.44078619725885604, 0.8971194014752457, 0.029737313307922165,
          -1.7407453071795862), radius=0.1),
)


def mockup_scene(radius: float = 0.05) -> Tuple[Cylinder, ...]:
    """A tall scaffold mockup — stand-in for the mockup world's STL mesh
    (`flying_arena_ros_mockup.wbt:57-76` references
    `meshes/mockup_config_lin_1.stl`, which is a missing large blob in the
    snapshot — .MISSING_LARGE_BLOBS:1-3 — so the geometry here is original;
    the structure is sized/placed to match the wp_mockup.csv scan pattern:
    a tall frame near (0, 0.75) scanned from four sides).

    4 corner posts (3.5 m) + cross beams at 3 levels + 4 diagonal braces.
    """
    cx, cy = 0.0, 0.75
    half = 0.5
    h = 3.5
    beams: List[Cylinder] = []
    for (x, y) in ((cx - half, cy - half), (cx + half, cy - half),
                   (cx + half, cy + half), (cx - half, cy + half)):
        beams.append(Cylinder((x, y, h / 2), (0.0, 0.0, 1.0), radius, h))
    for z in (1.0, 2.0, 3.0):
        beams.append(Cylinder((cx, cy - half, z), (1.0, 0.0, 0.0), radius, 2 * half))
        beams.append(Cylinder((cx, cy + half, z), (1.0, 0.0, 0.0), radius, 2 * half))
        beams.append(Cylinder((cx - half, cy, z), (0.0, 1.0, 0.0), radius, 2 * half))
        beams.append(Cylinder((cx + half, cy, z), (0.0, 1.0, 0.0), radius, 2 * half))
    # diagonal braces on the two long faces (steel-lattice signature)
    diag = np.array([1.0, 0.0, 1.0]) / np.sqrt(2.0)
    for (y, s) in ((cy - half, 1.0), (cy + half, -1.0)):
        beams.append(Cylinder((cx, y, 1.5), (s * diag[0], 0.0, diag[2]),
                              radius, np.sqrt(2.0)))
        beams.append(Cylinder((cx, y, 2.5), (-s * diag[0], 0.0, diag[2]),
                              radius, np.sqrt(2.0)))
    return tuple(beams)


# wp_mockup.csv — four-sided vertical scan strips around the mockup
# structure (config_auto_pilot/wp_mockup.csv, schema x,y,z,yaw,duration).
WP_MOCKUP = (
    (0.5, 2.0, 0.1, -1.57, 5.0), (0.5, 2.0, 4.0, -1.57, 15.0),
    (-0.5, 2.0, 4.0, -1.57, 5.0), (-0.5, 2.0, 0.3, -1.57, 15.0),
    (-1.5, 1.0, 0.3, 0.0, 5.0), (-1.5, 1.0, 4.0, 0.0, 15.0),
    (-1.5, 0.0, 4.0, 0.0, 5.0), (-1.5, 0.0, 0.3, 0.0, 15.0),
    (-0.5, -0.5, 0.3, 1.57, 5.0), (-0.5, -0.5, 4.0, 1.57, 15.0),
    (0.5, -0.5, 4.0, 1.57, 5.0), (0.5, -0.5, 0.3, 1.57, 15.0),
    (1.5, 0.0, 0.3, 3.14, 5.0), (1.5, 0.0, 4.0, 3.14, 15.0),
    (1.5, 1.0, 4.0, 3.14, 5.0), (1.5, 1.0, 0.3, 3.14, 15.0),
)


def figure_eight_waypoints(a: float = 1.8, z: float = 1.5, n: int = 48,
                           duration: float = 4.0) -> Tuple[Tuple[float, ...], ...]:
    """A lemniscate (figure-eight) waypoint loop at constant height — the
    dev world's `trajectory:=eight` pattern (launch/trajectory.launch:4),
    yaw following the direction of travel."""
    ts = np.linspace(0, 2 * np.pi, n, endpoint=False)
    xs = a * np.sin(ts)
    ys = a * np.sin(ts) * np.cos(ts)
    wps = []
    for k in range(n):
        k2 = (k + 1) % n
        yaw = float(np.arctan2(ys[k2] - ys[k], xs[k2] - xs[k]))
        wps.append((float(xs[k]), float(ys[k]), z, yaw, duration))
    return tuple(wps)


def simple_scene(n_beams: int = 3, radius: float = 0.05, seed: int = 0) -> Tuple[Cylinder, ...]:
    """A small randomized beam scene for property tests."""
    rng = np.random.default_rng(seed)
    beams = []
    for _ in range(n_beams):
        center = rng.uniform([-0.5, -0.8, 1.0], [0.5, 0.8, 2.5])
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        beams.append(Cylinder(tuple(center), tuple(axis), radius, 2.0))
    return tuple(beams)


def scene_truth(scene: Sequence[Cylinder]) -> List[dict]:
    return [c.as_truth() for c in scene]


def parse_wbt_scene(path: str) -> Tuple[Cylinder, ...]:
    """Extract the `DEF SEGn Solid` ground-truth cylinders from a Webots
    world file — the file-level equivalent of tests_structure.py:10-31's
    live scene-graph walk (Webots Cylinder defaults: height 2, radius 1)."""
    import re

    text = open(path).read()
    beams = []
    i = 1
    while True:
        m = re.search(rf"DEF SEG{i} Solid\s*{{", text)
        if not m:
            break
        # take the block up to the next DEF or EOF (flat enough for .wbt);
        # search FROM the end of this block's header — SEG defs are not
        # guaranteed to appear in ascending file order, and a SEG{i+1}
        # located earlier would slice an empty block (all field regexes
        # miss -> silently fabricated ground truth at the origin)
        nxt = re.compile(rf"DEF SEG{i + 1} Solid").search(text, m.end())
        block = text[m.start(): nxt.start() if nxt else len(text)]
        tr = re.search(r"translation\s+(\S+)\s+(\S+)\s+(\S+)", block)
        rot = re.search(r"rotation\s+(\S+)\s+(\S+)\s+(\S+)\s+(\S+)", block)
        rad = re.search(r"radius\s+(\S+)", block)
        hgt = re.search(r"height\s+(\S+)", block)
        translation = tuple(float(v) for v in tr.groups()) if tr else (0.0, 0.0, 0.0)
        rotation = (tuple(float(v) for v in rot.groups())
                    if rot else (0.0, 0.0, 1.0, 0.0))
        beams.append(_cyl(translation, rotation,
                          radius=float(rad.group(1)) if rad else 1.0,
                          height=float(hgt.group(1)) if hgt else 2.0))
        i += 1
    return tuple(beams)


def tower_scene(levels: int = 3, width: float = 1.0,
                level_height: float = 0.8, radius: float = 0.05,
                z0: float = 0.0) -> Tuple[Cylinder, ...]:
    """A lattice-tower scene: 4 vertical corner posts + horizontal cross
    beams per level (the `flying_arena_ros_obs_tower.wbt` whole-structure
    mapping scenario, whose STL mesh is missing from the snapshot)."""
    h = levels * level_height
    half = width / 2.0
    beams: List[Cylinder] = []
    corners = [(-half, -half), (half, -half), (half, half), (-half, half)]
    for (x, y) in corners:
        beams.append(Cylinder((x, y, z0 + h / 2), (0.0, 0.0, 1.0), radius, h))
    for lv in range(1, levels + 1):
        z = z0 + lv * level_height
        beams.append(Cylinder((0.0, -half, z), (1.0, 0.0, 0.0), radius, width))
        beams.append(Cylinder((0.0, half, z), (1.0, 0.0, 0.0), radius, width))
        beams.append(Cylinder((-half, 0.0, z), (0.0, 1.0, 0.0), radius, width))
        beams.append(Cylinder((half, 0.0, z), (0.0, 1.0, 0.0), radius, width))
    return tuple(beams)


def spiral_waypoints(radius: float = 2.0, z0: float = 0.3, z1: float = 2.5,
                     turns: float = 1.5, n: int = 40,
                     duration: float = 4.0) -> Tuple[Tuple[float, ...], ...]:
    """An orbiting-climb waypoint path facing the structure center — the
    wp_tower.csv flight pattern (53 waypoints climbing the tower)."""
    wps = []
    for k in range(n):
        frac = k / max(n - 1, 1)
        ang = 2 * np.pi * turns * frac
        x = radius * np.cos(ang)
        y = radius * np.sin(ang)
        z = z0 + (z1 - z0) * frac
        yaw = float(np.arctan2(-y, -x))  # face the center
        wps.append((float(x), float(y), float(z), yaw, duration))
    return tuple(wps)


# wp_tests.csv: the 3-waypoint vertical scan of the benchmark runs
# (x, y, z, yaw, duration).
WP_TESTS = (
    (1.0, 0.0, 0.3, 3.14, 5.0),
    (1.0, 0.0, 2.0, 3.14, 15.0),
    (1.0, 0.0, 0.1, 3.14, 100.0),
)


def load_waypoints_csv(path: str) -> Tuple[Tuple[float, ...], ...]:
    """Parse a reference-format waypoint CSV (header x,y,z,yaw,duration)."""
    rows = []
    with open(path) as f:
        header = f.readline()
        if "x" not in header:
            # a real error, not an assert: python -O would strip an assert
            # and silently consume the first WAYPOINT as a header
            raise ValueError(
                f"{path}: expected a waypoint CSV header containing 'x' "
                f"(x,y,z,yaw,duration), got {header.strip()!r}")
        for line in f:
            line = line.strip()
            if not line:
                continue
            vals = [float(v) for v in line.split(",")]
            rows.append(tuple(vals))
    return tuple(rows)


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
