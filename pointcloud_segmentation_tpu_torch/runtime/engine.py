"""Host runtime around the PyTorch pipeline: synchronous replay.

Twin of the JAX package's runtime/engine.py for its synchronous path: a pose
stream in, ToF clouds in, the persistent world map on the device, one timing
record per frame, and the three reference CSVs on `finalize`.  The device is
named by the caller and never guessed: "cuda" without a CUDA device raises,
so nothing carries on on the CPU unnoticed.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import PipelineConfig
from ..convert import load_jax_checkpoint, world_state_from_numpy
from ..ops.hough import KERNELS, Voting, direction_tables
from ..pipeline import process_frame
from ..worldmap import init_world
from . import csvio
from .posebuffer import PoseBuffer


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


class SegmentationEngine:
    def __init__(self, cfg: PipelineConfig, device, voting: Voting = KERNELS):
        """device: where the world map and every frame's tensors live
        ("cuda", "cuda:1", "cpu").  voting: ops.hough.KERNELS (default) or
        ops.hough.PLAIN, the plain PyTorch versions of the kernels, which
        `chip_smoke.py` runs on the card to hold the kernels against."""
        if cfg.compute_dtype != "float32":
            raise NotImplementedError("the PyTorch port runs float32 only")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"device {device!r} asked for, but "
                                   "torch.cuda.is_available() is False")
            # the voxel-grid sums are a float32 matrix product (ops/preproc.py)
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.voting = voting
        self.poses = PoseBuffer()
        self.records: List[dict] = []
        self.frames_processed = 0
        self.frames_skipped_no_pose = 0
        self.world_overflow_frames = 0
        self._program_start: Optional[float] = None
        self._tables = direction_tables(cfg.granularity, self.device)
        self._state = init_world(cfg, self.device)

    # ---------------------------------------------------------------- inputs

    def push_pose(self, t: float, position, quat_wxyz) -> None:
        """Pose stream input (the tfbr node's mocap->world broadcast)."""
        self.poses.push(t, position, quat_wxyz)

    # ---------------------------------------------------------------- core

    def _pad_raw(self, points: np.ndarray) -> torch.Tensor:
        n_raw = self.cfg.shapes.max_raw_points
        pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
        out = np.full((n_raw, 3), np.nan, dtype=np.float32)
        k = min(len(pts), n_raw)
        out[:k] = pts[:k]
        return torch.from_numpy(out).to(self.device)

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

        start = time.perf_counter()
        dev = self.device
        self._state, out = process_frame(
            self._state, self._pad_raw(points),
            torch.as_tensor(position, dtype=torch.float32).to(dev),
            torch.as_tensor(quat, dtype=torch.float32).to(dev),
            self.cfg, self._tables, self.voting)
        # one device->host read per frame, which also waits for the frame
        wc, nl, st, overflow = torch.stack([
            out.world_count, out.nlines, out.status, out.overflow]).tolist()
        end = time.perf_counter()

        if overflow:
            self.world_overflow_frames += 1
        record = {
            "wall_time": (end - self._program_start) * 1e6,
            "processing_time": (end - start) * 1e6,
            "seg_vec_size": wc,
            "nblines": nl,
        }
        self.records.append(record)
        self.frames_processed += 1
        return dict(record, status=st, t=t)

    def run_replay(self, frames) -> List[dict]:
        """Process every frame of an io.simulator replay (poses auto-pushed)."""
        out = []
        for fr in frames:
            self.push_pose(fr.t, fr.position, fr.quat_wxyz)
            rec = self.process_frame(fr.t, fr.points)
            if rec is not None:
                out.append(rec)
        return out

    # ---------------------------------------------------------------- outputs

    @property
    def state(self):
        """The world map on the device (a WorldState of tensors)."""
        return self._state

    def world_segments(self) -> List[dict]:
        """Current world map as host dicts (segments.csv row source)."""
        st = self._state
        n = int(st.count)
        f = {k: getattr(st, k)[:n].cpu().numpy()
             for k in ("a", "b", "t_min", "t_max", "radius", "points_size",
                       "pca_coeff")}
        return [{"a": f["a"][i], "b": f["b"][i],
                 "t_min": float(f["t_min"][i]), "t_max": float(f["t_max"][i]),
                 "radius": float(f["radius"][i]),
                 "points_size": int(f["points_size"][i]),
                 "pca_coeff": float(f["pca_coeff"][i])}
                for i in range(n)]

    def intersections_rows(self) -> List[tuple]:
        """(seg1, t1, seg2, t2) rows, upper-triangular order (node.cpp:858)."""
        n = int(self._state.count)
        return intersection_pairs(self._state.inter[:n, :n].cpu().numpy(), n)

    def load_checkpoint(self, path: str) -> None:
        """Resume the world map and records from a JAX engine's checkpoint."""
        data = load_jax_checkpoint(path)
        self._state = world_state_from_numpy(data, self.device)
        self.frames_processed = data["frames_processed"]
        self.records = [
            {"wall_time": r[0], "processing_time": r[1],
             "seg_vec_size": int(r[2]), "nblines": int(r[3])}
            for r in data["records"]]
        self.world_overflow_frames = data["world_overflow_frames"]

    def finalize(self, outdir: Optional[str] = None) -> dict:
        """Write the three reference CSVs (the node-destructor flush)."""
        outdir = csvio.ensure_outdir(outdir or self.cfg.path_to_output)
        paths = {
            "intersections": os.path.join(outdir, "intersections.csv"),
            "segments": os.path.join(outdir, "segments.csv"),
            "processing_time": os.path.join(outdir, "processing_time.csv"),
        }
        csvio.write_intersections_csv(paths["intersections"],
                                      self.intersections_rows())
        csvio.write_segments_csv(paths["segments"], self.world_segments())
        csvio.write_processing_time_csv(paths["processing_time"], self.records)
        return paths
