"""The per-frame pipeline on torch tensors: cloud in -> world map + outputs out.

Twin of the JAX package's pipeline.py: filter -> Hough -> drone-to-world
transform -> floor cutoff -> world-map fusion + intersections.  It runs
eagerly; the only host reads are the Hough loop's, once per round.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import PipelineConfig
from .geometry import quat_to_rot
from .ops.hough import KERNELS, SegmentBatch, Voting, extract_lines
from .ops.preproc import preprocess
from .worldmap import WorldState, init_world, world_step


class FrameOutput(NamedTuple):
    """Per-frame results (the node's published topics + timing record inputs)."""

    filtered: torch.Tensor        # (N, 3)
    filtered_valid: torch.Tensor  # (N,)
    filtered_count: torch.Tensor  # int32
    segments: SegmentBatch        # frame segments, world frame, post-cutoff
    slots: torch.Tensor           # (L,) int32 world slot per frame segment
    nlines: torch.Tensor          # int32 nblines_extracted
    status: torch.Tensor          # int32 (0 ok; see ops/hough.py)
    world_count: torch.Tensor     # int32 `seg_vec_size` column
    overflow: torch.Tensor        # int32 valid segments dropped at capacity (D-CAP)


def rotation_from_quat(quat_wxyz: torch.Tensor) -> torch.Tensor:
    rows = quat_to_rot(quat_wxyz[0], quat_wxyz[1], quat_wxyz[2], quat_wxyz[3])
    return torch.stack([torch.stack(r) for r in rows])


def transform_segments(segs: SegmentBatch, position: torch.Tensor,
                       quat_wxyz: torch.Tensor) -> SegmentBatch:
    """drone2WorldSeg (node.cpp:429-446): a <- R a + p, b <- R b.  The 3x3
    products are written elementwise, so no TF32 can enter them."""
    R = rotation_from_quat(quat_wxyz).to(segs.a.dtype)
    p = position.to(segs.a.dtype)

    def rot(v):
        return (v[:, None, :] * R[None, :, :]).sum(-1)

    return segs._replace(a=rot(segs.a) + p, b=rot(segs.b))


def surface_offset_correction(segs: SegmentBatch) -> SegmentBatch:
    """Opt-in E-OFFSET (README): shift each accepted axis by its matched
    radius along the sensor-to-line perpendicular, away from the sensor."""
    bn = segs.b / torch.clamp_min(torch.linalg.norm(segs.b, dim=1, keepdim=True), 1e-12)
    perp = segs.a - torch.sum(segs.a * bn, dim=1, keepdim=True) * bn
    nrm = torch.linalg.norm(perp, dim=1, keepdim=True)
    shift = segs.radius[:, None] * perp / torch.clamp_min(nrm, 1e-12)
    ok = (segs.valid & (nrm[:, 0] > 1e-6))[:, None]
    return segs._replace(a=torch.where(ok, segs.a + shift, segs.a))


def height_cutoff(segs: SegmentBatch, floor_trim_height: float) -> SegmentBatch:
    """heighSegmentCutoff (node.cpp:454-470): keep iff either endpoint above."""
    p1 = segs.t_min[:, None] * segs.b + segs.a
    p2 = segs.t_max[:, None] * segs.b + segs.a
    keep = (p1[:, 2] > floor_trim_height) | (p2[:, 2] > floor_trim_height)
    return segs._replace(valid=segs.valid & keep)


def process_frame(state: WorldState, raw_points: torch.Tensor,
                  position: torch.Tensor, quat_wxyz: torch.Tensor,
                  cfg: PipelineConfig, dir_tables: tuple | None = None,
                  voting: Voting = KERNELS) -> tuple[WorldState, FrameOutput]:
    """One full frame.  raw_points: (N_raw, 3) float32, NaN = invalid return;
    every tensor on the world state's device."""
    if cfg.compute_dtype != "float32":
        raise NotImplementedError("the PyTorch port runs float32 only")
    raw_points = raw_points.to(torch.float32)
    filtered, fvalid, fcount = preprocess(raw_points, cfg)
    hough = extract_lines(filtered, fvalid, cfg, dir_tables, voting)

    frame_segs = hough.segments
    if cfg.surface_offset_correction:
        frame_segs = surface_offset_correction(frame_segs)
    segs = transform_segments(frame_segs, position, quat_wxyz)
    segs = height_cutoff(segs, cfg.floor_trim_height)

    state, slots = world_step(state, segs, cfg)

    overflow = (segs.valid & (slots == -1)).sum().to(torch.int32)
    out = FrameOutput(
        filtered=filtered, filtered_valid=fvalid, filtered_count=fcount,
        segments=segs, slots=slots, nlines=hough.nlines, status=hough.status,
        world_count=state.count, overflow=overflow)
    return state, out


__all__ = [
    "FrameOutput", "WorldState", "init_world", "process_frame",
    "transform_segments", "height_cutoff", "surface_offset_correction",
]
