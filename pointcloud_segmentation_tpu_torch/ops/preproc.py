"""Static-shape pre-processing on torch tensors: NaN scrub, window crop and
voxel-grid downsample in PCL order.

Twin of the JAX package's ops/preproc.py.  The voxel grid is a stable sort
by linear voxel index, then `voxel_sums`: each voxel is a run of equal keys
in sorted order, summed from zero point by point in that order (PCL
VoxelGrid's accumulation order) and divided by its count.  On a card that
is one kernel (``csrc/voxel.cu``, two launches), whose work is linear in
the cloud; on the CPU its plain version, bit-equal to it.  The JAX
package's one-hot (max_points, max_raw_points) matrix product sums the same
points in another order.

Voxels past ``max_points`` are dropped (the first ``max_points`` in key
order are kept) and counted on the device: `voxel_overflow()`, which the
tracer exports as ``preproc.voxel_overflow``.
"""

from __future__ import annotations

import math

import torch

from .. import trace
from ..config import PipelineConfig


def window_mask(points: torch.Tensor, window_size: float) -> torch.Tensor:
    """Finite & inside the crop box: x in [0, w/2], y,z in [-w/2, w/2]."""
    half = window_size / 2.0
    finite = torch.isfinite(points).all(dim=-1)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    inside = ((x >= 0.0) & (x <= half)
              & (y >= -half) & (y <= half)
              & (z >= -half) & (z <= half))
    return finite & inside


def _grid_constants(cfg: PipelineConfig) -> tuple[int, int, int]:
    """Static voxel-grid index offset and stride for the crop window (the
    ORDER of linear indices is offset-invariant, so a static offset keeps
    PCL's order with static shapes)."""
    half = cfg.window_size / 2.0
    leaf = cfg.leaf_size
    lo = math.floor(-half / leaf) - 1
    hi = math.floor(half / leaf) + 1
    return lo, hi, hi - lo + 1


def voxel_keys(points: torch.Tensor, valid: torch.Tensor,
               cfg: PipelineConfig) -> torch.Tensor:
    """int32 sort key per point: linear voxel index, invalid -> +BIG."""
    lo, _, span = _grid_constants(cfg)
    # a tensor divisor: PyTorch turns a division of a CUDA tensor by a Python
    # float into a product with the reciprocal, which moves voxel edges
    leaf = torch.full((), cfg.leaf_size, dtype=points.dtype, device=points.device)
    ijk = torch.floor(torch.where(valid[..., None], points, 0.0) / leaf)
    ijk = torch.clamp(ijk.to(torch.int32) - lo, 0, span - 1)
    key = (ijk[..., 2] * span + ijk[..., 1]) * span + ijk[..., 0]
    return torch.where(valid, key, span * span * span + 1)


def voxel_sums_plain(keys_s: torch.Tensor, pts_s: torch.Tensor, n_out: int,
                     key_limit: int):
    """`voxel_sums` in plain PyTorch, and the number of voxels past n_out.
    The runs' sums advance one point a step, every run at once, for as many
    steps as the longest run has points: the kernel's order."""
    n = keys_s.shape[0]
    dev = pts_s.device
    isnew = torch.ones(n, dtype=torch.bool, device=dev)
    isnew[1:] = keys_s[1:] != keys_s[:-1]
    inside = keys_s < key_limit
    starts = torch.nonzero(isnew & inside).flatten()      # host read: the count
    total = starts.numel()
    ends = torch.cat([starts[1:], inside.sum().reshape(1)])[:total]
    starts, ends = starts[:n_out], ends[:n_out]
    lens = ends - starts
    m = starts.numel()
    acc = torch.zeros((m, 3), dtype=pts_s.dtype, device=dev)
    for k in range(int(lens.max()) if m else 0):
        live = (k < lens)[:, None]
        row = pts_s[torch.clamp_max(starts + k, n - 1)]
        acc = torch.where(live, acc + row, acc)
    centroids = torch.zeros((n_out, 3), dtype=pts_s.dtype, device=dev)
    centroids[:m] = acc / lens.to(pts_s.dtype)[:, None]
    valid = torch.arange(n_out, device=dev) < m
    count = torch.tensor(m, dtype=torch.int32, device=dev)
    return centroids, valid, count, max(total - n_out, 0)


def voxel_sums(keys_s: torch.Tensor, pts_s: torch.Tensor, n_out: int, key_limit: int):
    """The voxel grid from a stable sort: (centroids (n_out, 3), valid (n_out,)
    bool, count 0-dim int32).

    keys_s: (N,) int32 voxel keys, ascending; a key at or above `key_limit`
    marks an invalid point.  pts_s: (N, 3) float32 or float64, the points in
    the keys' order (an invalid point's row is never read).  Each run of
    equal valid keys is a voxel; its centroid is its points summed from zero
    in sorted order, over their count.  Row g holds the g-th voxel in key
    order for g < count = min(voxels, n_out), 0 past it.  The voxels past
    n_out add to `voxel_overflow()`.

    A CPU tensor takes `voxel_sums_plain`; a CUDA tensor launches
    ``pcs_voxel_sums`` or raises."""
    from .voting import _count, _counter, _raise_on, pinned

    dev = pinned(pts_s.device)
    if not pts_s.is_cuda:
        centroids, valid, count, over = voxel_sums_plain(keys_s, pts_s, n_out, key_limit)
        dropped = voxel_sums.dropped.setdefault(dev, torch.zeros((), dtype=torch.int64))
        dropped.add_(over)
        return centroids, valid, count
    from .._build import load_library

    N = keys_s.shape[0]
    if keys_s.dtype != torch.int32 or keys_s.shape != (N,) or not keys_s.is_contiguous():
        raise ValueError("keys_s must be a contiguous (N,) int32 tensor")
    if (pts_s.dtype not in (torch.float32, torch.float64) or pts_s.shape != (N, 3)
            or not pts_s.is_contiguous()):
        raise ValueError(f"pts_s must be a contiguous ({N}, 3) float32 or float64 tensor")
    if pinned(keys_s.device) != dev:
        raise ValueError(f"keys_s is on {keys_s.device}, pts_s on {dev}")
    tiles = torch.empty(max(1, -(-N // 1024)), dtype=torch.int32, device=dev)
    centroids = torch.empty((n_out, 3), dtype=pts_s.dtype, device=dev)
    valid = torch.empty(n_out, dtype=torch.bool, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    ran = _counter(voxel_sums, voxel_sums.counts, dev)
    dropped = _counter(voxel_sums, voxel_sums.dropped, dev)
    err = load_library().pcs_voxel_sums(
        int(pts_s.dtype == torch.float64), keys_s.data_ptr(), pts_s.data_ptr(), N,
        key_limit, n_out, tiles.data_ptr(), centroids.data_ptr(), valid.data_ptr(),
        count.data_ptr(), dropped.data_ptr(), ran.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "voxel_sums")
    _count(voxel_sums, dev, on_card=True)
    return centroids, valid, count


voxel_sums.launches = voxel_sums.captured = 0
voxel_sums.counts = {}      # device -> 0-dim int64: the launches that ran
voxel_sums.dropped = {}     # device -> 0-dim int64: the voxels past n_out


def voxel_overflow() -> int:
    """The voxels dropped past max_points since the last
    `ops.voting.reset_counts()`, on every device.  Reads the card."""
    from .voting import ran_launches

    return ran_launches(voxel_sums, voxel_sums.dropped)


def preprocess(points: torch.Tensor, cfg: PipelineConfig):
    """Window crop + voxel-grid downsample.

    Args:
      points: (N_raw, 3) float32 or float64; NaN rows mark invalid returns.
    Returns:
      (centroids (N_out, 3), valid (N_out,) bool, count 0-dim int32) with
      N_out = cfg.shapes.max_points, centroids ordered by ascending voxel
      index (PCL order).  Voxels beyond capacity are dropped and counted
      (`voxel_overflow`).
    """
    trace.stamp("preproc.begin")
    valid = window_mask(points, cfg.window_size)
    keys = voxel_keys(points, valid, cfg)
    keys_s, order = torch.sort(keys, stable=True)
    trace.stamp("preproc.sorted")           # the sort above, the sums below
    span = _grid_constants(cfg)[2]
    return voxel_sums(keys_s, points[order], cfg.shapes.max_points, span ** 3)
