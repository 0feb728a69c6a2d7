"""Bytes of one call of the voxel grid's kernel (`pcs_voxel_sums`: its two
launches, `voxel_starts_kernel` and `voxel_sums_kernel`), and the least
time the card could take for it.

A call is described by (N, n_out): the sorted raw rows it is handed (the
raw buffer, max_raw_points) and the voxels it writes (max_points).  What
the algorithm needs:

* bytes: each input byte read once (the N sorted int32 keys and the N
  sorted points, 12 bytes each in float32) and each output byte written
  once (n_out centroids of 12 bytes, n_out one-byte valid flags and the
  int32 count);
* operations: three float32 sums a point and three divisions a voxel,
  below the bytes at any shape (0.05 operations a byte), so left out.

Peak: HBM3 at 3.35 TB/s (`voting.py`, H100 SXM at 700 W).
"""

from __future__ import annotations

from .voting import PEAK_BYTES_PER_S


def call_bytes(n: int, n_out: int) -> int:
    return n * 4 + n * 12 + n_out * 12 + n_out + 4


def least_seconds(n: int, n_out: int) -> float:
    return call_bytes(n, n_out) / PEAK_BYTES_PER_S
