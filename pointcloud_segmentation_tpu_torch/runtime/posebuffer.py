"""Time-stamped pose buffer: the TF2 lookup of the reference node.

The reference broadcasts the drone pose as a TF transform
(pointcloud_tfbr.cpp:18-35) and looks it up at each cloud's timestamp with a
1 s timeout (node.cpp:357-376).  Here a host-side buffer stores
(t, position, quaternion) and a lookup interpolates between the bracketing
samples as tf2 does (linear position, slerp orientation).  A failed lookup
returns None, so the caller skips the frame (README deviation D-POSE).
"""

from __future__ import annotations

import bisect
import threading
from typing import Optional, Tuple

import numpy as np


def slerp(q0: np.ndarray, q1: np.ndarray, u: float) -> np.ndarray:
    """Spherical interpolation of (w, x, y, z) unit quaternions."""
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1 = -q1
        d = -d
    if d > 0.9995:
        out = q0 + u * (q1 - q0)
        return out / np.linalg.norm(out)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    s = np.sin(th)
    return (np.sin((1 - u) * th) / s) * q0 + (np.sin(u * th) / s) * q1


class PoseBuffer:
    """Thread-safe time-ordered pose store with an interpolating lookup."""

    def __init__(self, capacity: int = 4096, timeout: float = 1.0):
        self.capacity = capacity
        self.timeout = timeout
        self._lock = threading.Lock()
        self._t: list[float] = []
        self._pos: list[np.ndarray] = []
        self._quat: list[np.ndarray] = []

    def push(self, t: float, position, quat_wxyz) -> None:
        position = np.asarray(position, dtype=np.float64)
        quat = np.asarray(quat_wxyz, dtype=np.float64)
        quat = quat / np.linalg.norm(quat)
        with self._lock:
            i = bisect.bisect(self._t, t)
            self._t.insert(i, t)
            self._pos.insert(i, position)
            self._quat.insert(i, quat)
            if len(self._t) > self.capacity:
                self._t.pop(0)
                self._pos.pop(0)
                self._quat.pop(0)

    def lookup(self, t: float) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Pose at time t, or None (the reference's TransformException path).

        Interpolates between bracketing samples; takes the nearest sample when
        t lies outside the buffer's range by at most `timeout`, else fails.
        """
        with self._lock:
            if not self._t:
                return None
            i = bisect.bisect(self._t, t)
            if i == 0:
                if self._t[0] - t > self.timeout:
                    return None
                return self._pos[0].copy(), self._quat[0].copy()
            if i == len(self._t):
                if t - self._t[-1] > self.timeout:
                    return None
                return self._pos[-1].copy(), self._quat[-1].copy()
            t0, t1 = self._t[i - 1], self._t[i]
            u = 0.0 if t1 == t0 else (t - t0) / (t1 - t0)
            pos = (1 - u) * self._pos[i - 1] + u * self._pos[i]
            quat = slerp(self._quat[i - 1], self._quat[i], u)
            return pos, quat

    def __len__(self) -> int:
        with self._lock:
            return len(self._t)
