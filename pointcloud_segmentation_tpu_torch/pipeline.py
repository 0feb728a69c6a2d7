"""The per-frame pipeline on torch tensors: cloud in -> world map + outputs out.

Twin of the JAX package's pipeline.py: filter -> Hough -> drone-to-world
transform -> floor cutoff -> world-map fusion + intersections.
`process_frame` runs eagerly, driven from the host: its only host reads
are the Hough loop's, one a `run_if` node of a live round (ops/hough.py).
`make_process_frame` and `make_process_frame_packed` are the JAX package's
compiled frame: on a card, a step that captures the whole frame into one
CUDA graph and replays it once a frame, the world map updated in place in
the graph's own tensors (the JAX step donates its state), the Hough loop's
rounds and branches conditional nodes that the card decides; on the CPU
the same step runs eagerly.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import torch

from . import trace
from .config import PipelineConfig
from .geometry import quat_to_rot
from .ops import hough as H
from .ops import voting as V
from .ops.hough import (KERNELS, AxisGroup, SegmentBatch, Voting,
                        direction_tables, extract_lines)
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
    trace.stamp("preproc.end")
    hough = extract_lines(filtered, fvalid, cfg, dir_tables, voting, shard)

    frame_segs = hough.segments
    if cfg.surface_offset_correction:
        frame_segs = surface_offset_correction(frame_segs)
    segs = transform_segments(frame_segs, position, quat_wxyz)
    segs = height_cutoff(segs, cfg.floor_trim_height)
    trace.stamp("segments.end")
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
    trace.stamp("world.end")

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
    runtime reads the host once per frame.  The eager body of
    `make_process_frame_packed`."""
    state, out = process_frame(state, raw_points, position, quat_wxyz, cfg,
                               dir_tables, voting, shard)
    scalars = torch.stack([out.world_count, out.nlines, out.status, out.overflow])
    return state, out, scalars


def _copy_state(dst: WorldState, src: WorldState) -> None:
    for d, s in zip(dst, src):
        d.copy_(s)


def _clone_state(state: WorldState) -> WorldState:
    return WorldState(*(t.clone() for t in state))


class _Captured(NamedTuple):
    """One captured frame: its graph, its static input (the raw points, the
    position and the quaternion in one flat buffer) and outputs, the
    kernel launches it holds, by wrapper (those inside conditional nodes
    included, whether or not a replay runs them), and the ring its stamps
    write (None when it was captured with tracing off and holds none)."""

    graph: object
    inputs: torch.Tensor
    out: FrameOutput
    scalars: torch.Tensor
    launches: dict
    ring: trace.Ring | None


class FrameStep:
    """`make_process_frame(_packed)`'s step: ``step(state, raw_points,
    position, quat_wxyz)`` -> (state', FrameOutput[, scalars]).

    On a card, the first call with a raw shape and type captures the frame
    (preprocess -> Hough, its rounds and branches conditional nodes ->
    offset correction -> transform -> floor cutoff -> world fusion ->
    packed scalars) into one `torch.cuda.CUDAGraph`, and every call replays
    it once.  The world state lives in the step's own tensors
    (`self.state`): a call with another state copies it in first, as the
    JAX step takes a donated state, and every call returns `self.state`,
    updated in place, with the graph's static outputs, which the next replay
    overwrites: a caller takes what it needs from them before its next
    call.  Inputs may lie on the host (one flat pinned copy a frame) or on
    the card.  A replay runs on the step's own stream, which waits for the
    caller's current stream before and makes it wait after, so work the
    caller queues after a call sees the frame.

    Capture: the frame is run once on the step's stream (the warm-up, which
    builds the kernels and sets up each library's workspace for that
    stream) and captured on it, both on the state as it is at the call;
    the state is then restored from a copy taken before them, so the first
    frame is fused once, by its replay.  The warm-up runs only the bodies
    its frame takes, so the frame is also captured once in
    ``capture_error_mode="relaxed"`` and thrown away: every body's first
    launch (a kernel's shared-memory ceiling and occupancy lookup, a
    library's workspace) happens there, outside the real capture.  Both
    captures go through `ops.hough.cond_capture`, one at a time in the
    process.  A capture or replay that fails raises, and a step whose
    capture failed raises at every later call: nothing falls back to the
    eager frame.

    Launch counts: each replay adds the kernel launches its graph holds to
    the wrappers' `launches`; the launches that ran (inside conditional
    nodes only those whose flag held) are a device count,
    `ops.voting.ran_launches`.

    Tracing (trace.py): a frame captured while tracing is on holds a stamp
    kernel at each stage boundary, writing a ring made before the capture,
    and every replay of it notes its frame in the ring; one captured with
    tracing off holds none.  Each call is the host span ``step.launch``.

    On the CPU the step is the eager frame, `process_frame_packed`: no graph,
    no state of its own; with tracing on its stages stamp the host clock
    into the step's own ring.  The tables are the step's: one step, one
    table.
    """

    def __init__(self, cfg: PipelineConfig, device, dir_tables: tuple | None = None,
                 packed: bool = True):
        self.cfg = cfg
        self.device = V.pinned(device)
        self.packed = packed
        if dir_tables is None:
            dir_tables = direction_tables(cfg.granularity, self.device, compute_dtype(cfg))
        self.dir_tables = dir_tables
        self.on_card = self.device.type == "cuda"
        self.state: WorldState | None = None   # the card's static world state
        self.stream = torch.cuda.Stream(self.device) if self.on_card else None
        self.replays = 0
        # one record a captured graph: its key, the seconds of the warm-up and
        # capture, the bytes the capture added to torch.cuda.memory_reserved
        # (the graph's private pool, with the caching allocator emptied first),
        # memory_reserved after it, the conditional nodes the graph holds, all
        # its nodes (its bodies' included) and its stamp kernels (trace.py; 0
        # when captured with tracing off)
        self.captures: list = []
        self._graphs: dict = {}
        self._failed: BaseException | None = None
        self._lock = threading.Lock()
        self._host_ring: trace.Ring | None = None    # the CPU step's stamps

    def _frame(self, state, raw_points, position, quat_wxyz):
        return process_frame_packed(state, raw_points, position, quat_wxyz, self.cfg,
                                    self.dir_tables, KERNELS)

    def _result(self, state, out, scalars):
        return (state, out, scalars) if self.packed else (state, out)

    def __call__(self, state: WorldState, raw_points: torch.Tensor,
                 position: torch.Tensor, quat_wxyz: torch.Tensor):
        with trace.span("step.launch"):
            if self.on_card:
                return self._replay(state, raw_points, position, quat_wxyz)
            ring = None
            if trace.enabled():
                if self._host_ring is None:
                    self._host_ring = trace.Ring()
                ring = self._host_ring
            dev = self.device
            with trace.stamping(ring):
                trace.stamp("frame.begin")
                res = self._frame(state, raw_points.to(dev), position.to(dev),
                                  quat_wxyz.to(dev))
                trace.stamp("frame.end")
            return self._result(*res)

    def _replay(self, state, raw_points, position, quat_wxyz):
        with self._lock, torch.cuda.device(self.device):
            if self._failed is not None:
                raise RuntimeError("this frame step's capture failed; it does not "
                                   "run the frame eagerly instead") from self._failed
            dt = compute_dtype(self.cfg)
            flat = torch.cat([raw_points.reshape(-1).to(dt), position.reshape(-1).to(dt),
                              quat_wxyz.reshape(-1).to(dt)])
            if not flat.is_cuda:
                flat = flat.pin_memory()
            key = (tuple(raw_points.shape), raw_points.dtype)
            caller = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(caller)
            with torch.cuda.stream(self.stream):
                cap = self._graphs.get(key)
                if cap is None:
                    try:
                        cap = self._capture(key, state, flat)
                    except BaseException as e:
                        self._failed = e
                        raise
                if state is not self.state:
                    _copy_state(self.state, state)
                cap.inputs.copy_(flat, non_blocking=True)
                cap.graph.replay()
            caller.wait_stream(self.stream)
            if cap.ring is not None:
                cap.ring.replayed(self.replays)
            self.replays += 1
            for fn, n in cap.launches.items():
                fn.launches += n
            return self._result(self.state, cap.out, cap.scalars)

    def _capture(self, key, state: WorldState, flat: torch.Tensor) -> _Captured:
        """Warm up and capture the frame for `key` on the step's stream (the
        current one here)."""
        t0 = time.perf_counter()
        V.prepare_counts(self.device)
        if self.state is None:
            self.state = _clone_state(state)
        saved = _clone_state(state)
        inputs = torch.empty(flat.shape, dtype=flat.dtype, device=self.device)
        inputs.copy_(flat, non_blocking=True)
        shape = key[0]
        n_raw = inputs.numel() - 7
        static = self.state
        ring = trace.Ring(self.device) if trace.enabled() else None

        def frame():
            trace.stamp("frame.begin")
            raw = inputs[:n_raw].view(shape)
            new, out, scalars = self._frame(static, raw, inputs[n_raw:n_raw + 3],
                                            inputs[n_raw + 3:])
            _copy_state(static, new)       # the map updates in place
            trace.stamp("frame.end")
            return out, scalars

        frame()                            # the warm-up (no ring: no stamps)
        with H.cond_capture(torch.cuda.CUDAGraph(), self.stream, "relaxed"), \
                trace.stamping(ring):
            frame()                        # every body's first launch, thrown away
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        fns = V.COUNTED
        before = [fn.captured for fn in fns]
        graph = torch.cuda.CUDAGraph()
        stamps0 = ring.captured if ring is not None else 0
        with H.cond_capture(graph, self.stream, "thread_local") as cc, trace.stamping(ring):
            out, scalars = frame()
            cc.graph_nodes += H.captured_nodes(self.stream)
        launches = {fn: fn.captured - n for fn, n in zip(fns, before)}
        _copy_state(static, saved)         # undo the warm-up's fusion
        cap = _Captured(graph, inputs, out, scalars, launches, ring)
        self._graphs[key] = cap
        after = torch.cuda.memory_reserved(self.device)
        self.captures.append({"key": key, "seconds": time.perf_counter() - t0,
                              "pool_bytes": after - reserved, "reserved_after": after,
                              "cond_nodes": cc.nodes, "graph_nodes": cc.graph_nodes,
                              "stamps": (ring.captured - stamps0) if ring is not None else 0})
        return cap


def make_process_frame(cfg: PipelineConfig, device, dir_tables: tuple | None = None):
    """The JAX package's `make_process_frame`: a `FrameStep` returning
    (state', FrameOutput), one CUDA graph a frame on a card."""
    return FrameStep(cfg, device, dir_tables, packed=False)


def make_process_frame_packed(cfg: PipelineConfig, device,
                              dir_tables: tuple | None = None):
    """The JAX package's `make_process_frame_packed`: a `FrameStep` that also
    returns the frame's (world_count, nlines, status, overflow) as one (4,)
    int32 tensor, so the caller reads the host once a frame."""
    return FrameStep(cfg, device, dir_tables, packed=True)


__all__ = [
    "FrameOutput", "FrameStep", "WorldState", "init_world", "process_frame",
    "process_frame_packed", "make_process_frame", "make_process_frame_packed",
    "frame_segments",
    "transform_segments", "height_cutoff", "surface_offset_correction",
    "compute_dtype",
]
