"""Host runtime around the PyTorch pipeline: the node shell.

Twin of the JAX package's runtime/engine.py: a pose stream in (the tfbr
node's mocap->world broadcast), ToF clouds in, the persistent world map on
the device, one timing record per frame, and the three reference CSVs on
`finalize` (node.cpp:78-80).  Two ingestion modes:
  * synchronous replay, `process_frame` / `run_replay`: every frame is
    processed (deterministic; tests, evaluation);
  * streaming, `start` / `submit_cloud` / `drain` / `stop`: a worker thread
    consumes a latest-wins depth-1 mailbox and drops stale frames under
    load, as the reference's SharedData slot does (node.cpp:167-173,
    267-276).
The mailbox, the pose buffer, `run_streaming_from_log`'s feeder and
`finalize`'s CSV writers are the native runtime's (``native/``, C++ without
the GIL) where it builds, as in the JAX engine, else their Python twins.  The
native mailbox carries clouds as float32.

Backends: "torch" (the default: the PyTorch pipeline with the CUDA kernels)
or "oracle" (the port's copy of the numpy reference, oracle/pipeline.py, on
the host: it needs no card, touches no CUDA and builds no kernel).

The torch backend's device defaults to "cuda" and is never guessed: "cuda"
without a CUDA device raises, so nothing carries on on the CPU unnoticed.
The CPU runs only when the caller asks for it (``device="cpu"``), with the
plain PyTorch versions of the kernels.  The pipeline's float type is the
config's ``compute_dtype``: float32, or float64 in the parity mode.

The frame's loop (``loop``): whether a graph runs the frame.  The Hough
loop is one (ops/hough.py); ``loop`` decides only who drives it.  With
``loop="cond"`` (the default on a card with the kernels) the engine runs
every frame through `pipeline.make_process_frame_packed`: the whole frame is
one CUDA graph, captured at the first frame and replayed once a frame, the
world map held in the graph's own tensors and updated in place, each Hough
round and each branch of its update a conditional node that the card runs
only when its flag holds, and the one host read a frame is its four packed
scalars.  ``loop="eager"`` issues the same frame's ops from the host with
no graph, each node's flag read on the host: the comparison on the card, and
the only form for any voting but KERNELS ("cond" with another raises, since
the step captures the kernels).  On the CPU ``loop`` defaults to "eager";
"cond" runs the step's eager body.

The streaming worker has the JAX engine's two read-back modes.  Deferred (the
default: ``stream_sync_every`` > 1, no per-frame consumer of the frame's own
values): a frame is dispatched and its four scalars (world count, nlines,
status, overflow) are parked, on a card as a non-blocking copy into pinned
memory with a CUDA event behind it; the record carries -1 in `seg_vec_size`
and `nblines` until a second thread, the flusher, reads a whole batch at once
and backfills it.  Synchronous (``stream_sync_every`` <= 1, or whenever
per-frame viz, inlier collection or verbose logging needs the frame's
values): one read per frame, as `process_frame` does.  `run_replay(...,
pipelined=True)` is the replay's form of the same idea: one stacked read at
the end.

What the deferred mode is worth here: with the graph step a frame reads the
host only for its scalars, so a deferred stream queues replays without
waiting for any of them; with ``loop="eager"`` the Hough loop reads the host
at each node of a live round and only the world-map fusion after its last
read can overlap (PERF.md has the card's numbers).  It is ported for what it changes in
behaviour too, which callers of the JAX engine rely on (the same constructor
keys, -1 until the flush, checkpoints at flush boundaries, one viz record a
flush).  Not ported, because each guards
against a fault of the JAX testbed's remote device link that a local CUDA
device does not have: the break-out and shedding of batches behind a read
that hangs for minutes, starting reads only while the worker is idle, padding
a batch to a fixed length against recompiles, and the periodic reset of that
link's journal.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import queue
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import _build, native, trace
from .._malloc import cap_malloc_arenas as _cap_malloc_arenas
from ..config import VERBOSE_INFO, VERBOSE_NONE, PipelineConfig
from ..convert import (read_checkpoint, read_oracle_checkpoint,
                       world_state_from_numpy, world_state_to_numpy,
                       write_checkpoint, write_oracle_checkpoint)
from ..geometry import quat_to_rot
from ..ops.hough import KERNELS, Voting, direction_tables
from ..pipeline import compute_dtype, make_process_frame_packed, process_frame_packed
from ..worldmap import init_world
from . import csvio
from .mailbox import LatestWinsMailbox
from .posebuffer import PoseBuffer

logger = logging.getLogger("pointcloud_segmentation_tpu_torch")

# the engine's frame loops: one CUDA graph a frame, or the frame from the host
LOOPS = ("cond", "eager")

# points a viz record carries at most in each point cloud
_VIZ_POINTS_CAP = 4096


def intersection_pairs(inter: np.ndarray, n: int) -> List[tuple]:
    """(i, t1, j, t2) rows of the (S, S, 2) intersection-parameter plane,
    upper-triangular scan order (node.cpp:858), skipping the (-1, -1)
    sentinel of an empty pair (worldmap.update_intersections)."""
    rows = []
    for i in range(n):
        for j in range(i):
            t1, t2 = inter[i, j]
            if t1 != -1.0 and t2 != -1.0:
                rows.append((i, float(t1), j, float(t2)))
    return rows


def _waterfill_quotas(lens, cap):
    """Waterfill a total point budget across per-slot lengths, favoring no
    slot.  Every non-empty slot gets an equal share; shares a short slot
    can't use are redistributed to longer ones, so the cap is met exactly
    whenever sum(lens) >= cap and no slot is starved."""
    quota = [0] * len(lens)
    remaining = min(cap, sum(lens))
    active = [i for i, n in enumerate(lens) if n > 0]
    while remaining > 0 and active:
        share = max(remaining // len(active), 1)
        still = []
        for i in active:
            take = min(share, lens[i] - quota[i], remaining)
            quota[i] += take
            remaining -= take
            if quota[i] < lens[i]:
                still.append(i)
            if remaining <= 0:
                break
        active = still
    return quota


def _cap_points_per_slot(arrs, cap):
    """Waterfill `cap` across per-segment arrays, keeping each slot's newest
    points."""
    quota = _waterfill_quotas([len(a) for a in arrs], cap)
    return [a[len(a) - q:] for a, q in zip(arrs, quota) if q]


def _tail_points(chunks, q):
    """Newest `q` points from a slot's chunk list (per-frame appended
    arrays), touching only the tail chunks actually needed: the accumulated
    history grows without bound over a stream, and copying it for every
    viz record would be quadratic."""
    out = []
    need = q
    for arr in reversed(chunks):
        if need <= 0:
            break
        take = min(len(arr), need)
        out.append(arr[len(arr) - take:])
        need -= take
    out.reverse()
    return out[0] if len(out) == 1 else np.concatenate(out, axis=0)


def _rotation(quat) -> np.ndarray:
    return np.array(quat_to_rot(*np.asarray(quat, np.float64)))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class SegmentationEngine:
    def __init__(self, cfg: PipelineConfig, device="cuda", voting: Voting = KERNELS,
                 backend: str = "torch",
                 collect_inlier_points: bool = False,
                 checkpoint_every: int = 0,
                 checkpoint_path: Optional[str] = None,
                 viz_stream: Optional[object] = None,
                 viz_points: bool = False,
                 viz_every_frame: bool = False,
                 stream_sync_every: int = 64,
                 loop: Optional[str] = None):
        """device: where the world map and every frame's tensors live
        ("cuda", the default, "cuda:1", "cpu").  voting: ops.hough.KERNELS
        (default) or ops.hough.PLAIN, the plain PyTorch versions of the
        kernels, which `chip_smoke.py` runs on the card to hold the kernels
        against.

        loop: "cond" (the default on a card with voting=KERNELS: one CUDA
        graph a frame, its rounds and branches conditional nodes, see the
        module's docstring) or "eager" (the default otherwise: the same
        frame issued from the host, no graph).  "cond" needs voting=KERNELS
        and raises with any other.

        backend: "torch" (default) or "oracle", the numpy reference on the
        host, which ignores `device` and `voting` and needs no card.

        checkpoint_every / checkpoint_path: save a checkpoint every this
        many processed frames (0: never).

        viz_stream: per-frame visualization feed (the RViz re-publish loop
        analog, node.cpp:676-842).  A str/path gets one JSON line per
        processed frame (frame counters, the drone pose and the marker
        structures of ``visualization()``), truncated on the engine's first
        write and appended to after a restart; a callable receives the same
        dict instead.

        viz_points: also embed the frame's world-frame point clouds in each
        viz record: ``filtered_points`` (the `filtered_pointcloud` topic,
        node.cpp:417-420) and ``hough_points`` (the `hough_pointcloud`
        topic).  The reference republishes every world segment's accumulated
        inlier points each frame (node.cpp:823-829); enable
        ``collect_inlier_points`` too for that (the newest 4096 points of a
        record, shared fairly across segments), else ``hough_points`` holds
        the current frame's accepted inliers only (node.cpp:833-841).

        viz_every_frame: by default a deferred stream (see stream_sync_every)
        emits one viz record per read-back batch, built by the flusher from
        one snapshot of the world map and marked ``"viz_cadence": "flush"``
        with ``"frames_in_batch"``.  True forces one record per processed
        frame, on the synchronous path.  viz_points implies it: the point
        clouds exist only in the frame's own output.  Replay and synchronous
        processing always emit per frame.

        stream_sync_every: the streaming worker parks each frame's scalars
        and a flusher thread backfills the records with one batched read
        every this many frames, or when the oldest parked record is
        `_STREAM_FLUSH_AGE_S` old and the mailbox is idle.  At most
        `_STREAM_MAX_UNREAD_BATCHES` batches wait unread: an overfed stream
        then waits for the flusher while the mailbox goes on dropping.  <= 1
        forces the per-frame read.  Deferral is also off when per-frame host
        work needs the frame's own values (viz_every_frame / viz_points with
        a viz_stream, collect_inlier_points, verbose_level > 0) and for the
        oracle backend; a plain viz_stream stays deferred."""
        if backend not in ("torch", "oracle"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.device = torch.device("cpu" if backend == "oracle" else device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {device!r} asked for, but "
                                   "torch.cuda.is_available() is False")
            if self.device.index is None:
                # pinned now: another thread's current device may differ
                self.device = torch.device("cuda", torch.cuda.current_device())
            # built and loaded here, on the caller's thread: the first frame
            # of a stream runs on the worker, which would otherwise run nvcc
            _build.load_library()
            # no float32 matrix product of the port may run in TF32
            # (README §Precision contract)
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.voting = voting
        self.poses = self._make_pose_buffer()
        self.mailbox = self._make_mailbox()
        self.records: List[dict] = []
        self.frames_submitted = 0       # clouds entered through submit_cloud
        self.frames_processed = 0
        self.frames_skipped_no_pose = 0
        self.frames_failed = 0          # streaming frames that raised
        self.world_overflow_frames = 0  # frames that dropped segments at
                                        # max_world_segments capacity (D-CAP)
        self.raw_truncated = 0          # clouds cut to max_raw_points
        self.collect_inlier_points = collect_inlier_points
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = checkpoint_path
        self._last_checkpoint_k = 0
        self._inlier_points: dict[int, list[np.ndarray]] = {}
        self._viz_stream = viz_stream
        self._viz_points = viz_points
        self._viz_every_frame = bool(viz_every_frame or viz_points)
        self.stream_sync_every = stream_sync_every
        # (record, parked scalars, event, viz meta) of frames dispatched but
        # not yet handed to the flusher; the worker thread's own
        self._pending: List[tuple] = []
        self._pending_t0 = 0.0
        self._stream_deferred = (
            backend == "torch" and stream_sync_every > 1
            and not collect_inlier_points
            and not (viz_stream is not None and self._viz_every_frame)
            and cfg.verbose_level == VERBOSE_NONE)
        # flush-cadence live viz: a deferred stream with a viz stream
        self._viz_flush = self._stream_deferred and viz_stream is not None
        self._flush_q: Optional[queue.Queue] = None
        self._flusher: Optional[threading.Thread] = None
        self._viz_file = None
        self._viz_file_opened = False   # first open truncates, reopens append
        # Held by each frame's step and by every reader of the world state,
        # records and counters that a checkpoint or snapshot must see
        # together (a server thread answering a query mid-stream).
        self._state_lock = threading.Lock()
        self._submit_lock = threading.Lock()
        # notified by the worker after each frame it accounts for, so that
        # drain() wakes at once instead of polling the worker's GIL away
        self._progress = threading.Condition()
        self._program_start: Optional[float] = None
        self._worker: Optional[threading.Thread] = None
        self._running = False
        self._dropped_before = 0        # drops of the mailboxes of past runs
        # pop_stall_max's maxima: the slowest worker step and flusher read
        # (ms) since the last call, and when the flusher's read in flight
        # began (None when it is not reading)
        self._stall_step_ms = 0.0
        self._stall_read_ms = 0.0
        self._read_started_mono: Optional[float] = None
        self._atexit_registered = False
        trace.watch(self)                # its mailbox counts, at trace.export()

        # configuration dump, as the node logs at startup (node.cpp:245-257)
        if cfg.verbose_level > VERBOSE_NONE:
            logger.info("Configuration: %s", json.dumps(cfg.to_dict()))
        self._dtype = compute_dtype(cfg)
        self._npdt = np.float64 if cfg.compute_dtype == "float64" else np.float32
        self._step = None       # the frame step (pipeline.FrameStep)
        if backend == "oracle":
            from .. import oracle

            self._oracle = oracle
            self._wm = oracle.WorldMap(cfg)
            self._tables = self._state = None
            self.loop = None
        else:
            if loop is None:
                loop = ("cond" if self.device.type == "cuda" and voting is KERNELS
                        else "eager")
            if loop not in LOOPS:
                raise ValueError(f"loop must be one of {LOOPS}, got {loop!r}")
            if loop != "eager" and voting is not KERNELS:
                raise ValueError(f"loop={loop!r} captures the kernels (voting=KERNELS); "
                                 "other voting functions run with loop='eager'")
            self.loop = loop
            self._tables = direction_tables(cfg.granularity, self.device, self._dtype)
            self._state = init_world(cfg, self.device)
            if loop != "eager":
                self._step = make_process_frame_packed(cfg, self.device, self._tables)

    def _make_mailbox(self):
        """The native (C++) latest-wins mailbox where the native runtime is
        available, else the Python one.  It holds clouds of up to
        max(max_raw_points, 4096) points, as float32."""
        if native.available():
            return native.NativeMailbox(
                max_points=max(self.cfg.shapes.max_raw_points, 4096))
        return LatestWinsMailbox()

    @staticmethod
    def _make_pose_buffer():
        """The native (C++) pose ring buffer where the native runtime is
        available (same lookups as runtime.posebuffer.PoseBuffer), else the
        Python one."""
        if native.available():
            return native.NativePoseBuffer()
        return PoseBuffer()

    def _on_device(self):
        """Make the engine's card current for the calling thread: the kernels
        launch on the current device, whichever thread calls them."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # ---------------------------------------------------------------- inputs

    def push_pose(self, t: float, position, quat_wxyz) -> None:
        """Pose stream input (the tfbr node's mocap->world broadcast)."""
        self.poses.push(t, position, quat_wxyz)

    def submit_cloud(self, t: float, points: np.ndarray) -> None:
        """Streaming input: latest-wins; stale unprocessed frames are dropped."""
        with self._submit_lock:     # server connections submit concurrently
            self.frames_submitted += 1
        trace.mark("runtime.mailbox", t)     # ended when the worker takes it
        self.mailbox.put((t, points))

    def trace_counters(self) -> dict:
        """The counts trace.export() reports: the mailbox's own."""
        return {"runtime.submitted": self.frames_submitted,
                "runtime.dropped": self.dropped_frames,
                "engine.raw_truncated": self.raw_truncated}

    # ---------------------------------------------------------------- core

    def _pad_raw_host(self, points: np.ndarray) -> np.ndarray:
        """(max_raw_points, 3) in the compute type, NaN rows past the cloud.
        A larger cloud keeps its first max_raw_points rows; each such frame
        counts in `raw_truncated`, and the first one is logged."""
        with trace.span("engine.pad"):
            n_raw = self.cfg.shapes.max_raw_points
            pts = np.asarray(points, dtype=self._npdt).reshape(-1, 3)
            out = np.full((n_raw, 3), np.nan, dtype=self._npdt)
            k = min(len(pts), n_raw)
            out[:k] = pts[:k]
            if len(pts) > n_raw:
                self.raw_truncated += 1
                if self.raw_truncated == 1:
                    logger.warning(
                        "cloud of %d points cut to max_raw_points=%d: the map "
                        "leaves out the rest (set max_raw_points to the sensor's "
                        "pixel count); later cuts are counted in raw_truncated",
                        len(pts), n_raw)
            return out

    def _pad_raw(self, points: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(self._pad_raw_host(points)).to(self.device)

    def _dispatch(self, points, position, quat):
        """One frame's step on the world state; caller holds _state_lock and
        the device.  Returns the frame's FrameOutput and its four host-bound
        scalars as one tensor.  With the graph step both are the graph's
        static outputs, which the next frame overwrites: the caller takes
        what it needs first (on the card, queued work of its own stream is
        ordered before the next replay)."""
        dev = self.device
        pos = torch.as_tensor(position, dtype=self._dtype)
        q = torch.as_tensor(quat, dtype=self._dtype)
        if self._step is not None:
            # the step copies the frame to the card itself, in one piece
            self._state, out, scalars = self._step(
                self._state, torch.from_numpy(self._pad_raw_host(points)), pos, q)
            return out, scalars
        self._state, out, scalars = process_frame_packed(
            self._state, self._pad_raw(points), pos.to(dev), q.to(dev),
            self.cfg, self._tables, self.voting)
        return out, scalars

    def _process_oracle(self, points, position, quat):
        """One frame through the numpy oracle; caller holds _state_lock, which
        gives readers of the oracle's world map a consistent view.  Returns
        (world_count, nlines, status, frame points or None)."""
        pts = np.asarray(points, np.float64).reshape(-1, 3)
        res = self._oracle.process_frame(self._wm, pts, np.asarray(position),
                                         np.asarray(quat), self.cfg)
        frame_points = None
        if self._viz_stream is not None and self._viz_points:
            filtered = self._oracle.cloud_filtering(pts, self.cfg)
            accepted = [s.points for s in res.segments_in_frame if len(s.points)]
            frame_points = {
                "filtered": filtered @ _rotation(quat).T + np.asarray(position),
                "hough": (np.concatenate(accepted, axis=0) if accepted
                          else np.zeros((0, 3)))}
        return len(self._wm.segments), res.nblines, res.status, frame_points

    def process_frame(self, t: float, points: np.ndarray) -> Optional[dict]:
        """Synchronously process one cloud.  Returns the per-frame record, or
        None if the pose lookup failed (frame skipped, D-POSE)."""
        if self._program_start is None:
            self._program_start = time.perf_counter()
        pose = self.poses.lookup(t)
        if pose is None:
            self.frames_skipped_no_pose += 1
            return None
        position, quat = pose

        start = time.perf_counter_ns()
        end = 0
        span = trace.begin("engine.frame", t, start)     # processing_time's reads
        frame_points = None
        try:
            with self._state_lock, self._on_device():
                if self.backend == "oracle":
                    # the oracle's world map grows without a capacity: no D-CAP
                    overflow = 0
                    wc, nl, st, frame_points = self._process_oracle(points, position, quat)
                else:
                    out, scalars = self._dispatch(points, position, quat)
                    # one device->host read per frame, which also waits for the frame
                    with trace.span("engine.read"):
                        wc, nl, st, overflow = scalars.tolist()
                    if self.collect_inlier_points:
                        self._collect_points(out, position, quat)
                    if self._viz_stream is not None and self._viz_points:
                        frame_points = self._frame_points_of(out, position, quat)
                end = time.perf_counter_ns()
                record = {
                    "wall_time": (end / 1e9 - self._program_start) * 1e6,
                    "processing_time": (end - start) / 1e3,
                    "seg_vec_size": wc,
                    "nblines": nl,
                }
                self.records.append(record)
                self.frames_processed += 1
                if overflow:
                    self.world_overflow_frames += 1
        finally:
            trace.end(span, end or None)
        if overflow:
            logger.warning(
                "world map full (max_world_segments=%d): dropped %d "
                "segment(s) this frame (D-CAP)",
                self.cfg.shapes.max_world_segments, overflow)

        # verbose reporting, mirroring the node's levels (node.cpp:309-346)
        if self.cfg.verbose_level > VERBOSE_NONE:
            logger.info("Callback execution time: %d us",
                        int(record["processing_time"]))
        if self.cfg.verbose_level > VERBOSE_INFO:
            segs, inter = self.world_snapshot()
            for i, t1, j, t2 in inter:
                logger.info("intersection_matrix[%d][%d] = (%f, %f)", i, j, t1, t2)
            for i, s in enumerate(segs):
                logger.info("Segment %d: a = (%f, %f, %f), t_min = %f, t_max = %f",
                            i, s["a"][0], s["a"][1], s["a"][2],
                            s["t_min"], s["t_max"])

        self._maybe_checkpoint()

        info = {"world_count": wc, "nlines": nl, "status": st}
        if self._viz_stream is not None:
            with trace.span("engine.viz", t):
                self._emit_viz_frame(t, info, position, quat, frame_points)
        return dict(record, status=st, t=t)

    def _maybe_checkpoint(self) -> None:
        """Save once per crossed multiple of checkpoint_every."""
        if self.checkpoint_every and self.checkpoint_path:
            k = self.frames_processed // self.checkpoint_every
            if k > self._last_checkpoint_k:
                self._last_checkpoint_k = k
                self.save_checkpoint(self.checkpoint_path)

    def _frame_points_of(self, out, position, quat) -> dict:
        """World-frame per-frame clouds for the viz stream: the filtered
        cloud and the accepted lines' inlier points (the reference's
        `filtered_pointcloud` / `hough_pointcloud` topics)."""
        filtered = _host(out.filtered)
        fvalid = _host(out.filtered_valid)
        masks = _host(out.segments.point_mask)
        svalid = _host(out.segments.valid)
        R = _rotation(quat)
        pos = np.asarray(position, np.float64)
        world = filtered[fvalid] @ R.T + pos
        if svalid.any():
            inl = masks[svalid].any(axis=0) & fvalid
            hough = filtered[inl] @ R.T + pos
        else:
            hough = np.zeros((0, 3))
        return {"filtered": world, "hough": hough}

    def _collect_points(self, out, position, quat) -> None:
        filtered = _host(out.filtered)
        masks = _host(out.segments.point_mask)
        valid = _host(out.segments.valid)
        slots = _host(out.slots)
        R = _rotation(quat)
        # last writer wins per world slot: when two frame segments fuse into
        # the same slot in one frame, the world map keeps only the later
        # fusion, so the earlier one's points never enter the reference's
        # accumulated store (node.cpp:823-829) — collect the winner's only
        winner: dict[int, int] = {}
        for i in np.nonzero(valid)[0]:
            slot = int(slots[i])
            if slot >= 0:
                winner[slot] = int(i)
        for slot, i in winner.items():
            pts = filtered[masks[i]] @ R.T + np.asarray(position)
            self._inlier_points.setdefault(slot, []).append(pts)

    def _viz_record(self, frame_no: int, t: float, nlines: int, status: int,
                    position, quat_wxyz) -> dict:
        """A viz record of the world map as it is now: the node's marker
        re-publish (node.cpp:676-842) with a frame's counters and drone pose,
        which the reference shows in RViz beside the markers
        (rviz/drone_pc.rviz pose/path displays).  `world_count` is the
        snapshot's own, so it always equals the cylinder list's length."""
        viz = self.visualization(include_points=False)
        return {
            "frame": frame_no,
            "t": t,
            "nlines": nlines,
            "status": status,
            "world_count": len(viz["cylinders"]),
            "cylinders": [
                {"id": c["id"], "p1": [float(v) for v in c["p1"]],
                 "p2": [float(v) for v in c["p2"]],
                 "radius": float(c["radius"])}
                for c in viz["cylinders"]],
            "intersections": [
                {"position": [float(v) for v in s["position"]],
                 "text": s["text"]}
                for s in viz["intersections"]],
            "drone": {
                "position": [float(v) for v in np.asarray(position)],
                "quat_wxyz": [float(v) for v in np.asarray(quat_wxyz)],
            },
        }

    def _emit_viz_frame(self, t: float, info: dict, position, quat_wxyz,
                        frame_points: Optional[dict]) -> None:
        """One per-frame visualization record, with the frame's point clouds
        (`_frame_points_of`) when given."""
        rec = self._viz_record(self.frames_processed, t, info["nlines"],
                               info["status"], position, quat_wxyz)
        rec["world_count"] = info["world_count"]
        if frame_points is not None:
            cap = _VIZ_POINTS_CAP
            rec["filtered_points"] = np.round(
                frame_points["filtered"][:cap], 4).tolist()
            if self.collect_inlier_points:
                acc = self._accumulated_inliers(cap)
                rec["hough_points"] = np.round(acc, 4).tolist()
                rec["hough_points_world_accumulated"] = True
            else:
                rec["hough_points"] = np.round(
                    frame_points["hough"][:cap], 4).tolist()
        self._write_viz_record(rec)

    def _accumulated_inliers(self, cap: int) -> np.ndarray:
        """The newest accumulated inlier points of every world slot, `cap` in
        all, shared fairly: a tail of the slot-ordered concatenation would
        starve the low-numbered segments once the total passes the cap."""
        if self.backend == "oracle":
            # the oracle's Segment.points are the accumulated world-frame
            # inlier store: republish straight from it
            with self._state_lock:
                arrs = [np.asarray(s.points) for s in self._wm.segments
                        if len(s.points)]
            parts = _cap_points_per_slot(arrs, cap)
        else:
            slot_lists = [lst for lst in self._inlier_points.values() if lst]
            lens = [sum(len(a) for a in lst) for lst in slot_lists]
            quotas = _waterfill_quotas(lens, cap)
            parts = [_tail_points(lst, q)
                     for lst, q in zip(slot_lists, quotas) if q]
        return np.concatenate(parts, axis=0) if parts else np.zeros((0, 3))

    def _write_viz_record(self, rec: dict) -> None:
        """Deliver one viz record to the callable or append it to the JSONL.
        There is one writer at a time: the thread that processes frames, or
        in a deferred stream the flusher alone."""
        if callable(self._viz_stream):
            self._viz_stream(rec)
            return
        if self._viz_file is None:
            parent = os.path.dirname(os.path.abspath(self._viz_stream))
            os.makedirs(parent, exist_ok=True)
            # truncate only on the first open of this engine's lifetime: a
            # restart after stop() + finalize() (which closes the file)
            # appends, as records and CSVs are cumulative across restarts
            mode = "a" if self._viz_file_opened else "w"
            self._viz_file = open(self._viz_stream, mode)
            self._viz_file_opened = True
        self._viz_file.write(json.dumps(rec) + "\n")
        self._viz_file.flush()

    def run_replay(self, frames, pipelined: bool = False,
                   batch: int = 0) -> List[dict]:
        """Process every frame of an io.simulator replay (poses auto-pushed).

        pipelined=True (torch backend only): every frame is dispatched with
        no read of its own, its four scalars stay on the device, and one
        stacked read at the end backfills the records, which then equal the
        synchronous replay's column for column.  `processing_time` is each
        frame's dispatch (which, in this port, includes the Hough loop's own
        host reads), the final read is added to the last frame's, and no
        checkpoint, viz record or inlier store is made on this path.

        batch=k>1 (torch backend only; the oracle backend runs frame by
        frame): frames go in chunks of k, each frame with a pose dispatched
        as on the synchronous path and the per-frame scalars read once per
        chunk.  The world map is the synchronous replay's bit for bit;
        `processing_time` is the chunk's time shared evenly among its
        frames, and no checkpoint, viz record or inlier store is made on
        this path."""
        if batch > 1 and self.backend == "torch":
            return self._run_replay_batched(frames, batch)
        if pipelined and self.backend == "torch":
            return self._run_replay_pipelined(frames)
        out = []
        for fr in frames:
            self.push_pose(fr.t, fr.position, fr.quat_wxyz)
            rec = self.process_frame(fr.t, fr.points)
            if rec is not None:
                out.append(rec)
        return out

    def _warn_overflow(self, dropped: int, n_frames: int) -> None:
        logger.warning(
            "world map full (max_world_segments=%d): dropped %d "
            "segment(s) across %d frame(s) (D-CAP)",
            self.cfg.shapes.max_world_segments, dropped, n_frames)

    def _run_replay_pipelined(self, frames) -> List[dict]:
        if self._program_start is None:
            self._program_start = time.perf_counter()
        out, counters = [], []
        with self._on_device():
            for fr in frames:
                self.push_pose(fr.t, fr.position, fr.quat_wxyz)
                pose = self.poses.lookup(fr.t)
                if pose is None:
                    self.frames_skipped_no_pose += 1
                    continue
                start = time.perf_counter()
                with self._state_lock:
                    _, scalars = self._dispatch(fr.points, *pose)
                    if self._step is not None:
                        scalars = scalars.clone()   # the next replay overwrites them
                    end = time.perf_counter()
                    rec = {"wall_time": (end - self._program_start) * 1e6,
                           "processing_time": (end - start) * 1e6,
                           "seg_vec_size": -1, "nblines": -1}
                    self.records.append(rec)
                    self.frames_processed += 1
                counters.append(scalars)
                out.append(dict(rec, t=fr.t))
            if not counters:
                return out
            t0 = time.perf_counter()
            vals = torch.stack(counters).tolist()     # the one read
            sync_us = (time.perf_counter() - t0) * 1e6
        first = len(self.records) - len(out)
        with self._state_lock:
            for rec, own, (wc, nl, st, _) in zip(out, self.records[first:], vals):
                own["seg_vec_size"] = rec["seg_vec_size"] = wc
                own["nblines"] = rec["nblines"] = nl
                rec["status"] = st
            out[-1]["processing_time"] += sync_us
            self.records[-1]["processing_time"] += sync_us
            full = [ov for _, _, _, ov in vals if ov > 0]
            self.world_overflow_frames += len(full)
        if full:
            self._warn_overflow(sum(full), len(full))
        return out

    def _run_replay_batched(self, frames, batch: int) -> List[dict]:
        if self._program_start is None:
            self._program_start = time.perf_counter()
        out = []
        for c0 in range(0, len(frames), batch):
            chunk = frames[c0: c0 + batch]
            live = []                       # (frame, pose) of each frame with a pose
            for fr in chunk:
                self.push_pose(fr.t, fr.position, fr.quat_wxyz)
                pose = self.poses.lookup(fr.t)
                if pose is None:
                    self.frames_skipped_no_pose += 1
                    continue
                live.append((fr, pose))
            start = time.perf_counter()
            with self._state_lock, self._on_device():
                rows = torch.zeros((len(live), 4), dtype=torch.int32, device=self.device)
                for i, (fr, pose) in enumerate(live):
                    _, rows[i] = self._dispatch(fr.points, *pose)
                wc, nl, st, ov = rows.T.tolist()    # one read per chunk
                end = time.perf_counter()
                per = (end - start) / max(len(live), 1)
                for i, (fr, _) in enumerate(live):
                    rec = {
                        "wall_time": (end - self._program_start) * 1e6,
                        "processing_time": per * 1e6,
                        "seg_vec_size": wc[i],
                        "nblines": nl[i],
                    }
                    self.records.append(rec)
                    out.append(dict(rec, status=st[i], t=fr.t))
                    self.frames_processed += 1
                # D-CAP accounting, as on the synchronous path
                full = [n for n in ov if n > 0]
                self.world_overflow_frames += len(full)
            if full:
                self._warn_overflow(sum(full), len(full))
        return out

    # ---------------------------------------------------------------- streaming

    def start(self) -> None:
        """Start the consumer thread (the reference's processingThread).
        Restart-safe: a mailbox closed by an earlier stop() is replaced."""
        if self._worker is not None:
            return
        _cap_malloc_arenas()   # a no-op if the package import did it
        if self.mailbox.closed:
            # dropped_frames stays cumulative across restarts
            self._dropped_before = self.dropped_frames
            self.mailbox = self._make_mailbox()
        self._running = True
        if not self._atexit_registered:
            # An engine abandoned without stop() would leave the interpreter
            # to kill the daemon worker in the middle of a frame at exit;
            # atexit runs before that, so stop() joins it first.  The weak
            # reference lets a dropped engine be collected.
            import atexit
            import weakref

            ref = weakref.ref(self)

            def _cleanup():
                eng = ref()
                if eng is not None and eng._running:
                    try:
                        eng.stop()
                    except Exception:       # pragma: no cover - exit path
                        logger.exception("atexit engine stop failed")

            atexit.register(_cleanup)
            self._atexit_registered = True
        if self._stream_deferred:
            # the batched reads run on a thread of their own, so the worker
            # never waits for one
            self._flush_q = queue.Queue()
            self._flusher = threading.Thread(target=self._flusher_loop, daemon=True,
                                             name="pcs-torch-flusher")
            self._flusher.start()
        self._worker = threading.Thread(target=self._worker_loop, daemon=True,
                                        name="pcs-torch-worker")
        self._worker.start()

    # Mailbox-empty wait before the worker looks at its pending records again
    # (shorter than a 30 Hz frame period, so low rates stay responsive).
    _STREAM_IDLE_FLUSH_S = 0.02
    # Age of the oldest unflushed record at which an idle worker flushes: it
    # bounds how long a record waits for its values at low feed rates.
    _STREAM_FLUSH_AGE_S = 0.5
    # Batches handed to the flusher but not yet read at which the worker
    # stops dispatching: in-flight frames stay below about (this + 1) *
    # stream_sync_every however hard the stream is fed.
    _STREAM_MAX_UNREAD_BATCHES = 2

    def _process_frame_deferred(self, t: float, points: np.ndarray) -> bool:
        """The streaming fast path: dispatch the frame without reading its
        scalars.  They are parked (on a card: copied without blocking into
        pinned memory, with an event recorded behind the copy on the worker's
        stream) and the record carries -1 until `_backfill_batch` fills it
        in.  Returns False iff the pose lookup failed (D-POSE)."""
        if self._program_start is None:
            self._program_start = time.perf_counter()
        pose = self.poses.lookup(t)
        if pose is None:
            self.frames_skipped_no_pose += 1
            return False
        position, quat = pose
        start = time.perf_counter_ns()
        end = 0
        span = trace.begin("engine.frame", t, start)     # processing_time's reads
        try:
            with self._state_lock:
                _, scalars = self._dispatch(points, position, quat)
                event = None
                if scalars.is_cuda:
                    # a fresh pinned row per frame: none is written again, so no
                    # copy can land in a row the flusher has yet to read
                    parked = torch.empty(4, dtype=torch.int32, pin_memory=True)
                    parked.copy_(scalars, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                else:
                    parked = scalars
                end = time.perf_counter_ns()
                rec = {"wall_time": (end / 1e9 - self._program_start) * 1e6,
                       "processing_time": (end - start) / 1e3,
                       "seg_vec_size": -1, "nblines": -1}
                self.records.append(rec)
                self.frames_processed += 1
                frame_no = self.frames_processed
        finally:
            trace.end(span, end or None)
        if not self._pending:
            self._pending_t0 = end / 1e9      # the oldest pending record's age
        meta = (frame_no, t, position, quat) if self._viz_flush else None
        self._pending.append((rec, parked, event, meta))
        return True

    def _flush_pending(self) -> None:
        """Hand the pending batch to the flusher thread, which does the
        waiting and the reading."""
        if not self._pending:
            return
        batch, self._pending = self._pending, []
        self._flush_q.put(batch)

    def _backfill_batch(self, batch) -> list:
        """The flusher's half of a flush: wait for the batch's last copy
        (the copies are ordered on the worker's stream, so the earlier ones
        are done too), read every parked row at once and backfill the
        records.  The wait's time is added to the batch's last
        `processing_time`, as the pipelined replay adds its one read.  D-CAP
        counts are exact.  Returns the (k, 4) rows."""
        t0 = time.perf_counter_ns()
        self._read_started_mono = time.monotonic()
        try:
            if batch[-1][2] is not None:
                batch[-1][2].synchronize()
            vals = torch.stack([parked for _, parked, _, _ in batch]).tolist()
        finally:
            self._read_started_mono = None
        t1 = time.perf_counter_ns()
        trace.add("runtime.flush_read", t0, t1)
        sync_us = (t1 - t0) / 1e3
        self._stall_read_ms = max(self._stall_read_ms, sync_us / 1e3)
        with self._state_lock:
            for (rec, _, _, _), (wc, nl, _, _) in zip(batch, vals):
                rec["seg_vec_size"] = wc
                rec["nblines"] = nl
            batch[-1][0]["processing_time"] += sync_us
            full = [ov for _, _, _, ov in vals if ov > 0]
            self.world_overflow_frames += len(full)
        if full:
            self._warn_overflow(sum(full), len(full))
        # checkpoints at flush boundaries, once per crossed multiple of
        # checkpoint_every: only here are the records known to be filled in
        self._maybe_checkpoint()
        return vals

    def _flusher_loop(self) -> None:
        with self._on_device():
            while True:
                batch = self._flush_q.get()
                if batch is None:
                    return
                try:
                    vals = self._backfill_batch(batch)
                    if self._viz_flush:
                        with trace.span("engine.viz"):
                            self._emit_viz_flush(batch, vals)
                except Exception:
                    logger.exception("flush backfill failed; records keep "
                                     "their -1 sentinels for this batch")

    def _emit_viz_flush(self, batch, vals) -> None:
        """Flush-cadence live viz (flusher thread): one record of the world
        map as it is now, stamped with the batch's newest frame and pose, so
        a follower tracks the map at read-back cadence as the reference's
        RViz view tracks the node (node.cpp:676-842).  The worker may have
        fused later frames already; `world_count` and the cylinders come from
        one snapshot.  A viz failure must not end the flusher."""
        try:
            frame_no, t, position, quat = batch[-1][3]
            _, nl, st, _ = vals[-1]
            rec = self._viz_record(frame_no, t, nl, st, position, quat)
            # one record stands for the batch: the frames since the last
            # record share its view of the world
            rec["viz_cadence"] = "flush"
            rec["frames_in_batch"] = len(batch)
            self._write_viz_record(rec)
        except Exception:
            logger.exception("flush-cadence viz emit failed; stream continues")

    def _bound_unread_batches(self) -> None:
        """Backpressure, after every flush: with the reads on their own
        thread an overfed stream would otherwise run ahead of them without
        limit.  The worker waits here until the flusher has caught up; the
        mailbox keeps dropping stale frames meanwhile, as the reference does
        under load."""
        while (self._running
               and self._flush_q.qsize() >= self._STREAM_MAX_UNREAD_BATCHES):
            time.sleep(0.005)

    def _flush_and_bound(self, what: str) -> None:
        # A failed flush is a lost read-back batch (its records keep -1 until
        # the next flush takes them along), not a failed frame: every frame
        # of it was processed, and drain()'s accounting must stay exact.
        try:
            self._flush_pending()
        except Exception:
            logger.exception("%s failed; records keep their -1 sentinels "
                             "until the next flush", what)
        self._bound_unread_batches()

    def _worker_loop(self) -> None:
        # A frame that raises is counted and the worker goes on (the
        # reference's worker dies on the first TF failure, node.cpp:281-283,
        # a quirk this runtime fixes: skip and continue).
        deferred = self._stream_deferred
        with self._on_device():
            while self._running:
                timeout = (self._STREAM_IDLE_FLUSH_S
                           if deferred and self._pending else 0.1)
                item = self.mailbox.take(timeout=timeout)
                if item is None:
                    if (deferred and self._pending
                            and time.perf_counter() - self._pending_t0
                            >= self._STREAM_FLUSH_AGE_S):
                        self._flush_and_bound("idle flush")
                    continue
                t, points = item
                t0 = time.perf_counter_ns()
                trace.marked("runtime.mailbox", t, t0)
                step = trace.begin("runtime.step", t, t0)
                try:
                    if deferred:
                        self._process_frame_deferred(t, points)
                    else:
                        self.process_frame(t, points)
                except Exception:
                    self.frames_failed += 1
                    logger.exception("frame at t=%s failed; worker continues", t)
                t1 = time.perf_counter_ns()
                trace.end(step, t1)
                self._stall_step_ms = max(self._stall_step_ms, (t1 - t0) / 1e6)
                if deferred and len(self._pending) >= self.stream_sync_every:
                    self._flush_and_bound("flush")
                with self._progress:
                    self._progress.notify_all()
            if deferred and self._pending:
                try:
                    self._flush_pending()
                except Exception:
                    logger.exception("final pending flush failed")

    def pop_stall_max(self) -> dict:
        """Return and reset the slowest worker step and the slowest flusher
        read (ms) since the last call: the sampling of soak monitors
        (tools/endurance_torch.py).  A window with a large ``step_ms`` had a
        slow frame; a large ``flush_read_ms`` a slow device read; neither
        large points at the feed or the host.  A read still in flight
        reports its age so far.  Racy by design: a lost update only shrinks
        a maximum."""
        read_ms = self._stall_read_ms
        s = self._read_started_mono
        if s is not None:
            read_ms = max(read_ms, (time.monotonic() - s) * 1e3)
        out = {"step_ms": round(self._stall_step_ms, 1),
               "flush_read_ms": round(read_ms, 1)}
        self._stall_step_ms = 0.0
        self._stall_read_ms = 0.0
        return out

    def drain(self, target_total: Optional[int] = None,
              timeout: float = 60.0, poll_s: float = 0.05) -> bool:
        """Wait until every submitted cloud is accounted for (processed,
        failed, skipped, or dropped by latest-wins).  ``target_total``
        defaults to ``frames_submitted``.  The wait wakes when the worker
        finishes a frame, and every ``poll_s`` for drops, which happen on the
        submitting thread.  The window extends while the worker makes
        progress.  Returns True if drained."""
        if target_total is None:
            target_total = self.frames_submitted

        def accounted():
            return (self.frames_processed + self.frames_failed
                    + self.frames_skipped_no_pose)

        deadline = time.monotonic() + timeout
        while True:
            with self._progress:
                # checked under the condition: the worker's notify after
                # this check cannot be missed
                before = accounted()
                if before + self.dropped_frames >= target_total:
                    return True
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._progress.wait(min(poll_s, left))
            if accounted() != before:
                deadline = time.monotonic() + timeout

    def stop(self) -> None:
        self._running = False
        self.mailbox.close()
        if self._worker is not None:
            # block until the worker really exits: finalize() must not read
            # the world state while a frame is still being fused into it
            self._worker.join(timeout=10.0)
            while self._worker.is_alive():
                logger.warning("worker still busy; waiting for a clean stop")
                self._worker.join(timeout=30.0)
            self._worker = None
        if self._flusher is not None:
            # the worker's last batch is in the queue by now, so the sentinel
            # comes after every real flush; no deadline, as for the worker
            self._flush_q.put(None)
            self._flusher.join(timeout=30.0)
            while self._flusher.is_alive():
                logger.warning("flusher still reading back; waiting")
                self._flusher.join(timeout=30.0)
            self._flusher = None

    def run_streaming_from_log(self, log_path: str, rate_hz: float = 30.0,
                               loops: int = 1, poll_s: float = 0.05) -> dict:
        """Stream a recorded frame log through the live runtime: a feeder
        paces clouds into the latest-wins mailbox and poses into the pose
        buffer at `rate_hz` (0: as fast as it can) while the worker
        processes; frames are dropped, not queued, when processing falls
        behind, as on the reference's depth-1 /tof_pc subscription.  With a
        native mailbox and pose buffer the feeder is a C++ thread that holds
        no GIL and keeps a fixed schedule; otherwise this thread replays the
        log, sleeping a period after each frame.  Either feeder offsets each
        loop's timestamps past the last one's, so the stream's clock never
        rewinds.

        Returns ``{"fed": n, "processed": n, "dropped": n, "skipped": n,
        "failed": n, "drained": bool, "feed_s": s, "drain_s": s}`` for this
        run, each count from its own counter (``dropped`` is the mailbox's),
        so a frame lost between them shows as ``fed`` exceeding their sum:
        feed_s is the paced feed, drain_s the wait after it until every
        frame is accounted for, and ``drained`` False if that wait timed
        out."""
        from ..io.replay import load_frames

        use_native = (isinstance(self.mailbox, native.NativeMailbox)
                      and isinstance(self.poses, native.NativePoseBuffer))
        frames = None if use_native else load_frames(log_path)
        self.start()
        t_feed0 = time.perf_counter()
        # per-run accounting baseline: counters are cumulative across runs
        base_total = (self.frames_processed + self.frames_failed
                      + self.frames_skipped_no_pose + self.dropped_frames)
        base_processed = self.frames_processed
        base_dropped = self.dropped_frames
        base_skipped = self.frames_skipped_no_pose
        base_failed = self.frames_failed
        if use_native:
            feeder = native.NativeFeeder(log_path, self.mailbox, self.poses,
                                         rate_hz=rate_hz, loops=loops,
                                         close_on_end=False)
            try:
                while not feeder.done:
                    time.sleep(min(poll_s, 0.005))    # feed_s to 5 ms
            finally:
                fed = feeder.stop()
        else:
            fed = self._feed_from_python(frames, rate_hz, loops)
        t_drain0 = time.perf_counter()
        drained = self.drain(target_total=base_total + fed, poll_s=poll_s)
        self.stop()
        t_end = time.perf_counter()
        return {"fed": fed,
                "processed": self.frames_processed - base_processed,
                "dropped": self.dropped_frames - base_dropped,
                "skipped": self.frames_skipped_no_pose - base_skipped,
                "failed": self.frames_failed - base_failed,
                "drained": drained,
                "feed_s": round(t_drain0 - t_feed0, 3),
                "drain_s": round(t_end - t_drain0, 3)}

    def _feed_from_python(self, frames, rate_hz: float, loops: int) -> int:
        """run_streaming_from_log's feeder without the native runtime: this
        thread pushes each frame's pose and submits its cloud, then sleeps
        one period.  Returns the frames fed."""
        period = 1.0 / rate_hz if rate_hz > 0 else 0.0
        # Per-loop time offset: replaying the raw timestamps every loop would
        # rewind the clock, and the sorted pose buffer would then evict all
        # but the newest timestamps until every lookup of a fresh frame fails.
        gaps = [b.t - a.t for a, b in zip(frames, frames[1:]) if b.t > a.t]
        span = ((frames[-1].t - frames[0].t) if frames else 0.0) + (
            period or (gaps[-1] if gaps else 1e-3))
        fed = 0
        for loop in range(max(loops, 1)):
            off = loop * span
            for fr in frames:
                self.push_pose(fr.t + off, fr.position, fr.quat_wxyz)
                self.submit_cloud(fr.t + off, fr.points)
                fed += 1
                if period:
                    time.sleep(period)
        return fed

    @property
    def dropped_frames(self) -> int:
        return self._dropped_before + self.mailbox.dropped

    # ---------------------------------------------------------------- outputs

    @property
    def state(self):
        """The world map on the device (a WorldState of tensors); None for
        the oracle backend, whose map is a list of segments on the host."""
        return self._state

    def _world_snapshot_locked(self) -> Tuple[List[dict], List[tuple]]:
        if self.backend == "oracle":
            segs = [{"a": s.a, "b": s.b, "t_min": s.t_min, "t_max": s.t_max,
                     "radius": s.radius, "points_size": s.points_size,
                     "pca_coeff": s.pca_coeff} for s in self._wm.segments]
            return segs, self._wm.intersections_rows()
        st = self._state
        n = int(st.count)
        f = {k: _host(getattr(st, k)[:n])
             for k in ("a", "b", "t_min", "t_max", "radius", "points_size",
                       "pca_coeff")}
        segs = [{"a": f["a"][i], "b": f["b"][i],
                 "t_min": float(f["t_min"][i]), "t_max": float(f["t_max"][i]),
                 "radius": float(f["radius"][i]),
                 "points_size": int(f["points_size"][i]),
                 "pca_coeff": float(f["pca_coeff"][i])}
                for i in range(n)]
        return segs, intersection_pairs(_host(st.inter[:n, :n]), n)

    def world_snapshot(self) -> Tuple[List[dict], List[tuple]]:
        """(world_segments, intersections_rows) as one mutually consistent
        pair: a frame fused between two separate calls could otherwise give
        intersection rows that name segments absent from the list
        (concurrent readers: server queries, live viz pollers)."""
        with self._state_lock:
            return self._world_snapshot_locked()

    def world_segments(self) -> List[dict]:
        """Current world map as host dicts (segments.csv row source)."""
        return self.world_snapshot()[0]

    def intersections_rows(self) -> List[tuple]:
        """(seg1, t1, seg2, t2) rows, upper-triangular order (node.cpp:858)."""
        return self.world_snapshot()[1]

    def visualization(self, include_points: bool = True) -> dict:
        """Marker-style structured viz (the RViz MarkerArray analog):
        cylinders per world segment, spheres per intersection, text labels
        (node.cpp:676-842).  `include_points=False` skips the accumulated
        inlier points, which grow without bound over a stream."""
        cylinders, texts, spheres = [], [], []
        segs, inter_rows = self.world_snapshot()
        for i, s in enumerate(segs):
            p1 = np.asarray(s["a"]) + s["t_min"] * np.asarray(s["b"])
            p2 = np.asarray(s["a"]) + s["t_max"] * np.asarray(s["b"])
            mid = (p1 + p2) / 2
            cylinders.append({"id": i, "p1": p1, "p2": p2, "center": mid,
                              "radius": s["radius"],
                              "height": float(np.linalg.norm(p2 - p1))})
            texts.append({"id": i, "position": mid, "text": str(i)})
        for (i, t1, j, t2) in inter_rows:
            s = segs[i]
            p = np.asarray(s["a"]) + t1 * np.asarray(s["b"])
            r = 1.5 * max(self.cfg.radius_sizes[0], self.cfg.radius_sizes[-1])
            spheres.append({"position": p, "radius": r,
                            "text": f"Intersection: {i} & {j}"})
        out = {"cylinders": cylinders, "segment_texts": texts,
               "intersections": spheres}
        if include_points and self.collect_inlier_points:
            # the worker appends chunks under the lock
            with self._state_lock:
                if self.backend == "oracle":
                    pts = {k: np.asarray(s.points)
                           for k, s in enumerate(self._wm.segments) if len(s.points)}
                    if pts:
                        out["hough_points"] = pts
                elif self._inlier_points:
                    out["hough_points"] = {
                        k: np.concatenate(v, axis=0)
                        for k, v in self._inlier_points.items()}
        return out

    # ---------------------------------------------------------------- checkpoint

    def save_checkpoint(self, path: str) -> None:
        """Write the world map, the records and the counters to one npz
        (convert.write_checkpoint, backend "torch", or
        convert.write_oracle_checkpoint): checkpoint and resume, which the
        reference, whose map lives only in RAM, lacks."""
        with self._state_lock:
            records = list(self.records)
            frames, overflow = self.frames_processed, self.world_overflow_frames
            if self.backend == "oracle":
                # written under the lock: the oracle's map mutates in place
                write_oracle_checkpoint(path, self._wm, frames, records, overflow)
                return
            state = world_state_to_numpy(self._state)
        write_checkpoint(path, state, frames, records, overflow)

    def load_checkpoint(self, path: str) -> None:
        """Resume the world map, records and counters.  The torch backend
        reads a checkpoint of the port or of the JAX engine in its own
        compute type; the oracle backend reads an oracle checkpoint of either
        package.  Anything else raises ValueError."""
        if self.backend == "oracle":
            data = read_oracle_checkpoint(path)
        else:
            data = read_checkpoint(path, self.cfg.compute_dtype)
            state = world_state_from_numpy(data, self.device, self._dtype)
        with self._state_lock:
            if self.backend == "oracle":
                self._wm.segments = data["segments"]
                self._wm.inter = data["inter"]
            else:
                # with the graph step, the next frame copies it into the
                # step's own tensors (pipeline.FrameStep)
                self._state = state
            self.frames_processed = data["frames_processed"]
            self.records = [
                {"wall_time": r[0], "processing_time": r[1],
                 "seg_vec_size": int(r[2]), "nblines": int(r[3])}
                for r in data["records"]]
            self.world_overflow_frames = data["world_overflow_frames"]
        # re-anchor the cadence to the restored frame count: a resumed
        # engine neither re-saves the checkpoint it loaded nor skips the
        # next boundary
        self._last_checkpoint_k = (
            self.frames_processed // self.checkpoint_every
            if self.checkpoint_every else 0)

    def finalize(self, outdir: Optional[str] = None) -> dict:
        """Write the three reference CSVs (the node-destructor flush) and
        close the viz stream's file."""
        if self._viz_file is not None:
            self._viz_file.close()
            self._viz_file = None
        outdir = csvio.ensure_outdir(outdir or self.cfg.path_to_output)
        paths = {
            "intersections": os.path.join(outdir, "intersections.csv"),
            "segments": os.path.join(outdir, "segments.csv"),
            "processing_time": os.path.join(outdir, "processing_time.csv"),
        }
        with self._state_lock:
            segs, inter = self._world_snapshot_locked()
            records = list(self.records)
        # the native writers where available: byte-identical to csvio's
        # (printf %.6g is the C++ ofstream default the reference writes
        # with, node.cpp:850-919)
        writers = native if native.available() else csvio
        writers.write_intersections_csv(paths["intersections"], inter)
        writers.write_segments_csv(paths["segments"], segs)
        writers.write_processing_time_csv(paths["processing_time"], records)
        return paths
