"""Recorded frame logs (PCSL): save and load replay streams.

The layout is the JAX package's and its native runtime's, so a log written
by either package reads back identically in the other:

    file   := "PCSL" version:u32 record*
    record := t:f64 position:3xf64 quat_wxyz:4xf64 n:u32 points:n*3xf32

all little-endian.
"""

from __future__ import annotations

import struct
from typing import Iterable, List

import numpy as np

from .simulator import Frame

_MAGIC = b"PCSL"
_VERSION = 1


def save_frames(path: str, frames: Iterable[Frame]) -> int:
    """Write a replay log; returns the frame count."""
    n = 0
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", _VERSION))
        for fr in frames:
            pts = np.ascontiguousarray(fr.points, dtype=np.float32).reshape(-1, 3)
            f.write(struct.pack("<d", float(fr.t)))
            f.write(np.ascontiguousarray(fr.position, np.float64).tobytes())
            f.write(np.ascontiguousarray(fr.quat_wxyz, np.float64).tobytes())
            f.write(struct.pack("<I", len(pts)))
            f.write(pts.tobytes())
            n += 1
    return n


def load_frames(path: str) -> List[Frame]:
    """Read a replay log back into Frame objects."""
    out = []
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise IOError(f"{path}: not a PCSL frame log")
        (version,) = struct.unpack("<I", f.read(4))
        if version != _VERSION:
            raise IOError(f"{path}: unsupported version {version}")
        while True:
            head = f.read(8)
            if len(head) < 8:
                return out
            (t,) = struct.unpack("<d", head)
            pos = np.frombuffer(f.read(24), np.float64).copy()
            quat = np.frombuffer(f.read(32), np.float64).copy()
            (n,) = struct.unpack("<I", f.read(4))
            pts = np.frombuffer(f.read(n * 12), np.float32).reshape(n, 3).copy()
            out.append(Frame(t=t, position=pos, quat_wxyz=quat, points=pts))
