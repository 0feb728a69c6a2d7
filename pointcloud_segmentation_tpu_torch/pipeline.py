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
from .ops.hough import KERNELS, AxisGroup, SegmentBatch, Voting, extract_lines
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


def compute_dtype(cfg: PipelineConfig) -> torch.dtype:
    """The pipeline's float type: float32, or float64 in the parity mode (the
    float32-by-spec stages stay float32, see ops/hough.py)."""
    return torch.float64 if cfg.compute_dtype == "float64" else torch.float32


def frame_segments(raw_points: torch.Tensor, position: torch.Tensor,
                   quat_wxyz: torch.Tensor, cfg: PipelineConfig,
                   dir_tables: tuple | None = None, voting: Voting = KERNELS,
                   shard: AxisGroup | None = None):
    """The per-frame stages, which touch no world state: filter -> Hough ->
    drone-to-world transform -> floor cutoff.  Returns (filtered, fvalid,
    fcount, hough result, world-frame segments).  With a `shard`, `dir_tables`
    is this rank's slice of the direction table and every rank of the
    shard's group calls with the same frame (ops/hough.py)."""
    raw_points = raw_points.to(compute_dtype(cfg))
    filtered, fvalid, fcount = preprocess(raw_points, cfg)
    hough = extract_lines(filtered, fvalid, cfg, dir_tables, voting, shard)

    frame_segs = hough.segments
    if cfg.surface_offset_correction:
        frame_segs = surface_offset_correction(frame_segs)
    segs = transform_segments(frame_segs, position, quat_wxyz)
    segs = height_cutoff(segs, cfg.floor_trim_height)
    return filtered, fvalid, fcount, hough, segs


def process_frame(state: WorldState, raw_points: torch.Tensor,
                  position: torch.Tensor, quat_wxyz: torch.Tensor,
                  cfg: PipelineConfig, dir_tables: tuple | None = None,
                  voting: Voting = KERNELS,
                  shard: AxisGroup | None = None) -> tuple[WorldState, FrameOutput]:
    """One full frame.  raw_points: (N_raw, 3), NaN = invalid return, cast to
    the config's compute_dtype; every tensor on the world state's device."""
    filtered, fvalid, fcount, hough, segs = frame_segments(
        raw_points, position, quat_wxyz, cfg, dir_tables, voting, shard)

    state, slots = world_step(state, segs, cfg)

    overflow = (segs.valid & (slots == -1)).sum().to(torch.int32)
    out = FrameOutput(
        filtered=filtered, filtered_valid=fvalid, filtered_count=fcount,
        segments=segs, slots=slots, nlines=hough.nlines, status=hough.status,
        world_count=state.count, overflow=overflow)
    return state, out


def process_frame_packed(state: WorldState, raw_points: torch.Tensor,
                         position: torch.Tensor, quat_wxyz: torch.Tensor,
                         cfg: PipelineConfig, dir_tables: tuple | None = None,
                         voting: Voting = KERNELS, shard: AxisGroup | None = None):
    """`process_frame`, also returning the frame's host-bound scalars
    (world_count, nlines, status, overflow) as one (4,) int32 tensor, so the
    runtime reads the host once per frame.  Twin of the JAX package's
    `make_process_frame_packed`."""
    state, out = process_frame(state, raw_points, position, quat_wxyz, cfg,
                               dir_tables, voting, shard)
    scalars = torch.stack([out.world_count, out.nlines, out.status, out.overflow])
    return state, out, scalars


def batched_process(state: WorldState, clouds: torch.Tensor,
                    positions: torch.Tensor, quats: torch.Tensor,
                    cfg: PipelineConfig, dir_tables: tuple | None = None,
                    voting: Voting = KERNELS, shard: AxisGroup | None = None):
    """A chunk of F frames in one call: the per-frame stages for each frame,
    then the order-dependent world fusion (node.cpp:491-510) in frame order.
    Twin of the JAX package's `make_batched_process`, which vmaps the
    per-frame stages and scans the fusion.  PyTorch has no vmap over the
    Hough loop, whose trip count and branches depend on the data, so the
    frames run in a Python loop: the same operations in the same order as F
    calls of `process_frame`, hence the same world state bit for bit.  What
    the chunk saves is host reads: the per-frame scalars come back as four
    tensors of length F, which the caller reads once per chunk.

    clouds (F, N_raw, 3), positions (F, 3), quats (F, 4) -> (state', nlines
    (F,), statuses (F,), world_counts (F,), the world size after each frame's
    fusion, overflows (F,), segments dropped at max_world_segments, D-CAP),
    all int32 on the state's device.
    """
    per_frame = [frame_segments(clouds[i], positions[i], quats[i], cfg,
                                dir_tables, voting, shard)
                 for i in range(clouds.shape[0])]
    nlines, statuses, counts, overflows = [], [], [], []
    for _, _, _, hough, segs in per_frame:
        state, slots = world_step(state, segs, cfg)
        nlines.append(hough.nlines)
        statuses.append(hough.status)
        counts.append(state.count)
        overflows.append((segs.valid & (slots == -1)).sum().to(torch.int32))
    return (state, torch.stack(nlines), torch.stack(statuses),
            torch.stack(counts), torch.stack(overflows))


__all__ = [
    "FrameOutput", "WorldState", "init_world", "process_frame",
    "process_frame_packed", "batched_process", "frame_segments",
    "transform_segments", "height_cutoff", "surface_offset_correction",
    "compute_dtype",
]
