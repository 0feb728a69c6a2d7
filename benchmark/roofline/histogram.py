"""Bytes and operations of one launch of the carry-vote histogram kernel
(`pcs_vote_histogram`), and the least time the card could take for it.

A launch is described by (directions, points, active points, NX): the
directions it votes, the points it is handed, those of them that are
active, and the cells a side of each direction's grid.  What the algorithm
needs, counted as `voting.py` counts the state kernel:

* bytes: each input byte read once (the points, 12 bytes each, and their
  one-byte active mask; two (directions, 3) float32 plane bases; half, dx
  and num_x, 12 bytes) and each output byte written once (the
  (directions, NX, NX) int32 histogram);
* operations: the same 24 float32 operations a (active point, direction)
  pair as the state kernel (`voting.OPS_PER_PAIR`): the kernels share one
  body, and the binning is its float work.

Directions are the configuration's (1,281 at granularity 4), not the
padded table's rows (1,408), whose extra rows are work no answer needs.
Peaks: those of `voting.py` (H100 SXM at 700 W).
"""

from __future__ import annotations

import math
from typing import Tuple

from .voting import OPS_PER_PAIR, PEAK_BYTES_PER_S, PEAK_LANE_OPS_PER_S


def grid_side(window_size: float, opt_dx: float) -> int:
    """NX, the cells a side of the histogram's grid: the bin count of the
    largest cloud the window crop lets through (its box's diagonal d,
    floor(d / opt_dx + 0.5), hough_3d_lines.h:214), plus one."""
    half = window_size / 2.0
    d_max = math.sqrt(half * half + window_size ** 2 * 2.0)
    return int(math.floor(d_max / opt_dx + 0.5)) + 1


def launch_bytes(directions: int, points: int, nx: int) -> int:
    return points * 12 + points + directions * 24 + 12 + directions * nx * nx * 4


def launch_ops(directions: int, active: int) -> int:
    return OPS_PER_PAIR * directions * active


def least_seconds(directions: int, points: int, active: int, nx: int) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the two bounds."""
    t_bytes = launch_bytes(directions, points, nx) / PEAK_BYTES_PER_S
    t_ops = launch_ops(directions, active) / PEAK_LANE_OPS_PER_S
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def least_seconds_at(directions: int, nx: int) -> float:
    """A launch's least time at (directions, nx) whatever points it is
    handed: the bytes of its tables and its histogram.  Where the bytes
    bound rules (at granularity 4 and NX 79, at every active count up to
    4,096: the tests) this is at most `least_seconds`, short of it by the
    points' 13 bytes each (53,248 at 4,096 points, 0.17% of that shape)."""
    return launch_bytes(directions, 0, nx) / PEAK_BYTES_PER_S
