"""Bytes and operations of one launch of the lazy-vote state kernel, and
the least time the card could take for it.

A launch is described by (rows, points, active points): the directions it
votes, the points it is handed and those of them that are active.  What
the algorithm needs, counted from the kernel's arithmetic (``csrc/voting.cu``,
built with ``--fmad=false``, so every product and sum is its own lane
operation):

* bytes: each input byte read once (the points, 12 bytes each, and their
  one-byte active mask; two (rows, 3) float32 plane bases; half, dx and
  num_x, 12 bytes) and each output byte written once ((best, key, bound),
  12 bytes a row);
* operations: the float32 work of binning one (active point, direction)
  pair on each of the two axes: the projection, 3 products and 2 sums; the
  shift by half, 1 sum; the correctly rounded quotient by dx, 1 product and
  4 fused multiply-adds (`quotient_rn`); the floor, 1.  12 an axis, 24 a
  pair.  The integer work (conversion, clamp, key, vote) runs on other
  units and is left out, so the bound is a lower bound.

Peaks: NVIDIA's data sheet for the H100 SXM, at its 700 W power limit:
3.35 TB/s of HBM3, and 67 TFLOP/s in float32 outside the tensor cores,
counting a fused multiply-add as two operations, which is 33.5 T lane
operations a second.
"""

from __future__ import annotations

from typing import Iterable, Tuple

PEAK_BYTES_PER_S = 3.35e12
PEAK_LANE_OPS_PER_S = 33.5e12
OPS_PER_PAIR = 2 * (3 + 2 + 1 + 5 + 1)


def launch_bytes(rows: int, points: int) -> int:
    return points * 12 + points + rows * 24 + 12 + rows * 12


def launch_ops(rows: int, active: int) -> int:
    return OPS_PER_PAIR * rows * active


def least_seconds(rows: int, points: int, active: int) -> Tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of the two bounds."""
    t_bytes = launch_bytes(rows, points) / PEAK_BYTES_PER_S
    t_ops = launch_ops(rows, active) / PEAK_LANE_OPS_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def least_total(launches: Iterable[tuple]) -> float:
    """Summed least seconds of launches, each (rows, points, active)."""
    return sum(least_seconds(r, p, a)[0] for r, p, a in launches)
