"""Static-shape pre-processing on torch tensors: NaN scrub, window crop and
voxel-grid downsample in PCL order.

Twin of the JAX package's ops/preproc.py.  The voxel grid is a stable sort
by linear voxel index followed by a segmented mean; the per-voxel sums are
one dense one-hot matrix product, which is deterministic on the card (float
atomics such as ``index_add_`` are not).
"""

from __future__ import annotations

import math

import torch

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


def preprocess(points: torch.Tensor, cfg: PipelineConfig):
    """Window crop + voxel-grid downsample.

    Args:
      points: (N_raw, 3) float32; NaN rows mark invalid returns.
    Returns:
      (centroids (N_out, 3), valid (N_out,) bool, count 0-dim int32) with
      N_out = cfg.shapes.max_points, centroids ordered by ascending voxel
      index (PCL order).  Overflow beyond capacity is dropped.
    """
    if points.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("preprocess needs full float32 matrix products: "
                           "set torch.backends.cuda.matmul.allow_tf32 = False")
    n_out = cfg.shapes.max_points
    dev = points.device
    valid = window_mask(points, cfg.window_size)
    keys = voxel_keys(points, valid, cfg)

    keys_s, order = torch.sort(keys, stable=True)
    valid_s = valid[order]
    pts_s = torch.where(valid_s[:, None], points[order], 0.0)

    # groups are contiguous runs in sorted order with all valid rows first
    isnew = torch.ones_like(valid_s)
    isnew[1:] = keys_s[1:] != keys_s[:-1]
    first = isnew & valid_s
    group = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    group = torch.where(valid_s, group, n_out)             # invalid -> dropped

    g_iota = torch.arange(n_out, dtype=torch.int32, device=dev)[:, None]
    onehot = (group[None, :] == g_iota).to(points.dtype)   # (n_out, N)
    sums = onehot @ pts_s
    cnts = onehot.sum(dim=1)

    count = torch.clamp_max(first.sum().to(torch.int32), n_out)
    out_valid = torch.arange(n_out, dtype=torch.int32, device=dev) < count
    centroids = sums / torch.clamp_min(cnts, 1.0)[:, None]
    centroids = torch.where(out_valid[:, None], centroids, 0.0)
    return centroids, out_valid, count
