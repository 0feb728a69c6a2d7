"""Smoke run of the PyTorch port on one CUDA card: builds the voting kernels,
holds each against its plain PyTorch version at every shape the main path
gives it (NX 79 and NX 261) and at edge cases, drives the replay main path,
checks what comes out, and times the kernels beside their bounds.  Then it
drives the live node loop at the shipped config on the card: a lockstep
stream through the worker, paced and unpaced streams of a recorded log, the
TCP server, the CLI in subprocesses, and a checkpoint resume, each held to
the synchronous replay or to its own accounting, and each counting its
vote_state launches.  Last the parity stack, on the card with the hand
kernels: the float64 mode against the numpy oracle on the host (g6 lazy and
g4 carry on the 31-frame replay, both kernels launched, float64 lazy equal
to float64 carry), the
kernels against their plain versions on the float32 inputs a float64 frame
hands them, batched replay against synchronous, sequential fusion against
vectorised, seeds of tools/parity_soak_torch.py, and the oracle backend.
Between the node loop and the parity stack, the sensor-data and display
surfaces at the shipped config: the 31 frames written as ROS1 bags (none,
bz2) and MCAP files (plain, one chunk, one zstd chunk where zstandard
imports), decoded again and replayed on the card against the replay of the
source frames (g6, and g4 on 12 frames); an ambiguous and a truncated bag
refused before a frame reaches the engine; the frames as PointCloud2 and
PoseStamped objects through the ROS bridge's callbacks; record --bag, run
--bag, bag-info, viz and inspect in subprocesses; and the live player
following a running stream.
After those, sharded execution and the deferred read-back: both kernels
against their plain versions at the shapes a direction shard gives them (half
and a quarter of the g6 table, half of the g4 table); parallel.spawn's ranks
on the one card (1 rank over NCCL; 2 and 4 ranks over gloo, sharing the card)
running the g6 replay through make_tp_process_frame with the table split 1, 2
and 4 ways, the g4 replay split 2 ways, and a 2x2 mesh through
make_multichip_step and make_batched_extract, every rank bit-equal to the
one-rank run and launching the kernels itself; a rank that raises fails the
call; then deferred streams (stream_sync_every 64, 8 and 1, lockstep and at
30 Hz, three times each) and the pipelined replay against the synchronous
replay.

    python3 chip_smoke.py [--earlier path/to/an/earlier/voting.cu]
                          [--parity-only | --sensor-only | --shard-only]

Needs one CUDA card and nvcc; exits non-zero on any failure.  With
--earlier, the kernels of that source (same C entries) are built too and
timed beside this checkout's at the NX 79 main-path shapes.  With
--parity-only, the kernel table, the golden fixtures and the node loop are
left out (for work on the parity stack; the last lines are printed only by a
whole run); --sensor-only does the same for the sensor-data and display
phases, and --shard-only for the sharded and deferred phases.  It prints the
card's name and power limit, one line per check and time, then a JSON line
of the kernels, the card line again, and last the JSON line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import types
import urllib.request
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed

# H100 SXM peaks (NVIDIA's data sheet): float32 outside the tensor cores, an
# FMA counted as two operations; HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# lane instructions a second: 128 lanes a clock on each of 132 SMs at
# 1.98 GHz, half the float32 peak, since that counts an FMA as two
PEAK_LANE_INSTRUCTIONS = PEAK_F32_FLOPS / 2
REPO = Path(__file__).resolve().parent
# keys of a viz-stream record of the JAX engine (runtime/engine.py
# _emit_viz_frame), without point clouds
VIZ_KEYS = {"frame", "t", "nlines", "status", "world_count", "cylinders",
            "intersections", "drone"}
CSV_HEADERS = {"segments.csv": "segment,a_x,a_y,a_z,b_x,b_y,b_z,t_min,t_max",
               "intersections.csv": "seg1,t1,seg2,t2",
               "processing_time.csv": "wall_time,processing_time,seg_vec_size,nblines"}
# instructions one point needs in one direction with no product+sum
# contraction (the bins must equal the plain float32 bins): per bin three
# products, three sums, the quotient (a product and four FMAs), a floor, a
# conversion and a two-sided clamp; then the cell index and one atomic vote
VOTE_INSTRUCTIONS = 2 * (3 + 3 + 5 + 1 + 1 + 2) + 2


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)
    print(f"ok    {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, reps: int) -> float:
    """Mean ms of fn over reps calls, CUDA events around the run, after one
    warm-up call (host time between launches included)."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device ms of one fn call: reps calls captured in a CUDA graph and
    replayed, so host time between launches does not count."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(replays):
        g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (reps * replays)


def bound(kind: str, n: int, n_active: int, rows: int, nxs: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one voting call: each input
    read once (points, mask, plane bases, scalars) and each output written
    once, against the instructions that bin and vote this call's active
    points."""
    in_bytes = n * 12 + n + rows * 24 + 12
    out_bytes = rows * 12 if kind == "vote_state" else rows * nxs * nxs * 4
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    t_ops = VOTE_INSTRUCTIONS * n_active * rows / PEAK_LANE_INSTRUCTIONS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def launcher(lib, name, Xs, act, c1, c2, half, dx, nx, NX):
    """One launch of `name`'s kernel from the library `lib`, with the
    wrapper's outputs and scalars made once: the kernel alone, so that two
    libraries with the same C entries are timed alike."""
    from pointcloud_segmentation_tpu_torch.ops import voting as V

    B, N = c1.shape[0], Xs.shape[0]
    half_dx, nxt, _ = V._launch_args(Xs, half, dx, nx)
    if name == "vote_state":
        outs = [torch.empty(B, dtype=torch.int32, device=Xs.device) for _ in range(3)]
        entry = lib.pcs_vote_state
    else:
        outs = [torch.empty((B, NX, NX), dtype=torch.int32, device=Xs.device)]
        entry = lib.pcs_vote_histogram
    args = (Xs.data_ptr(), act.data_ptr(), N, c1.data_ptr(), c2.data_ptr(), B,
            half_dx.data_ptr(), nxt.data_ptr(), NX, *(o.data_ptr() for o in outs))

    def run(keep=(half_dx, nxt, outs)):   # keep: the tensors behind args
        err = entry(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"{name} launch failed: CUDA error {err}")

    return run


def frames_of(scene, poses, spec, seed):
    from pointcloud_segmentation_tpu_torch.io.simulator import simulate_trajectory

    return simulate_trajectory(scene, poses, spec, seed=seed)


def voting_problem(cfg, frame, dev):
    """A real frame's voting inputs at cfg: (Xs, active, half, dx, num_x)."""
    from pointcloud_segmentation_tpu_torch.ops.hough import center_cloud
    from pointcloud_segmentation_tpu_torch.ops.preproc import preprocess

    raw = np.full((cfg.shapes.max_raw_points, 3), np.nan, np.float32)
    raw[: len(frame.points)] = frame.points[: len(raw)]
    pts, valid, _ = preprocess(torch.from_numpy(raw).to(dev), cfg)
    dx = torch.full((), cfg.opt_dx, dtype=torch.float32, device=dev)
    Xs, _, _, half, num_x = center_cloud(pts, valid, dx)
    return Xs, valid, half, dx, num_x


def max_err(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def gathered(c1, c2, rows, gen):
    """`rows` rows of the table as the lazy re-exam gathers them: sorted
    suspects, then copies of the last row as padding."""
    B = c1.shape[0]
    k = rows * 3 // 4
    idx = torch.randperm(B, generator=gen)[:k].sort().values
    idx = torch.cat([idx, torch.full((rows - k,), B - 1, dtype=torch.int64)]).to(c1.device)
    return c1[idx].contiguous(), c2[idx].contiguous()


class Shapes:
    """The kernels' checks and times, shape by shape."""

    def __init__(self, card, earlier=None):
        from pointcloud_segmentation_tpu_torch._build import load_library

        self.card = card
        self.lib = load_library()
        self.earlier = earlier   # an earlier library, timed beside this one
        self.errs = {"vote_state": 0, "vote_histogram": 0}
        self.times = []

    def state(self, label, p, c1, c2, active=None, timed=False):
        from pointcloud_segmentation_tpu_torch.ops import voting as V

        Xs, act, half, dx, nx, NX = p
        act = p[1] if active is None else active
        k = V.vote_state(Xs, act, c1, c2, half, dx, nx, NX)
        q = V.vote_state_plain(Xs, act, c1, c2, half, dx, nx, NX)
        e = max(max_err(a, b) for a, b in zip(k, q))
        self.errs["vote_state"] = max(self.errs["vote_state"], e)
        check(e == 0, f"vote_state == plain, {label} ({c1.shape[0]} rows, "
                      f"{int(act.sum())} active, NX {NX}): max err {e}")
        if timed:
            self.time("vote_state", label, Xs, act, c1, c2, half, dx, nx, NX, compare=True)
        return k

    def histogram(self, label, p, c1, c2, active=None, timed=False):
        from pointcloud_segmentation_tpu_torch.ops import voting as V

        Xs, act, half, dx, nx, NX = p
        act = p[1] if active is None else active
        k = V.vote_histogram(Xs, act, c1, c2, half, dx, nx, NX)
        q = V.vote_histogram_plain(Xs, act, c1, c2, half, dx, nx, NX)
        e = max_err(k, q)
        self.errs["vote_histogram"] = max(self.errs["vote_histogram"], e)
        check(e == 0, f"vote_histogram == plain, {label} ({c1.shape[0]} rows, "
                      f"{int(act.sum())} active, NX {NX}): max err {e}")
        del k, q
        if timed:
            self.time("vote_histogram", label, Xs, act, c1, c2, half, dx, nx, NX,
                      compare=True)

    def time(self, name, label, Xs, act, c1, c2, half, dx, nx, NX, compare=False):
        """Kernel ms (CUDA-graph replays of the kernel's launch alone), plain
        and library ms, and the bound.  With an earlier library and
        `compare`, the two kernels are timed earlier, this, this, earlier."""
        from pointcloud_segmentation_tpu_torch.ops import voting as V

        plain = getattr(V, name + "_plain")
        this = launcher(self.lib, name, Xs, act, c1, c2, half, dx, nx, NX)
        earlier_ms, readings = None, ""
        if compare and self.earlier is not None:
            before = launcher(self.earlier, name, Xs, act, c1, c2, half, dx, nx, NX)
            e1, t1, t2, e2 = (graph_ms(f) for f in (before, this, this, before))
            ms, earlier_ms = (t1 + t2) / 2, (e1 + e2) / 2
            readings = (f", earlier kernel {earlier_ms:.4f} ms ({ms / earlier_ms:.1%} of it; "
                        f"earlier, this, this, earlier: {e1:.4f} {t1:.4f} {t2:.4f} {e2:.4f})")
        else:
            ms = graph_ms(this)
        plain_ms = event_ms(lambda: plain(Xs, act, c1, c2, half, dx, nx, NX), 3)
        library_ms = None
        if name == "vote_histogram":
            # count-only yardstick: one bincount over precomputed flat keys
            B, cells = c1.shape[0], NX * NX
            xi, yi = V.vote_bins(Xs[act], c1, c2, half, dx, nx)
            keys = (torch.arange(B, device=Xs.device)[:, None] * cells
                    + xi.to(torch.int64) * NX + yi).reshape(-1)
            library_ms = event_ms(lambda: torch.bincount(keys, minlength=B * cells), 10)
            del xi, yi, keys
        n_act = int(act.sum())
        b_ms, b_by = bound(name, Xs.shape[0], n_act, c1.shape[0], NX)
        rec = {"name": name, "shape": label, "rows": c1.shape[0], "n": Xs.shape[0],
               "active": n_act, "nx": NX, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": b_ms, "bound_by": b_by,
               "earlier_ms": earlier_ms}
        self.times.append(rec)
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"time  {name}, {label} ({c1.shape[0]} rows, N {Xs.shape[0]}, {n_act} active, "
              f"NX {NX}): kernel {ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}, "
              f"{b_ms / ms:.1%} of it), plain {plain_ms:.4f} ms, library {lib}{readings} "
              f"[{self.card}]", flush=True)


def kernel_checks(dev, frame, card, earlier=None):
    """Each kernel against its plain version on the card, at the shapes the
    main path gives it at NX 79 and NX 261, and at edge cases."""
    from pointcloud_segmentation_tpu_torch.config import default_config
    from pointcloud_segmentation_tpu_torch.ops import voting as V
    from pointcloud_segmentation_tpu_torch.ops.hough import (
        _compact_removed, _pad_dirs_to_tile, center_cloud, direction_tables)

    sh = Shapes(card, earlier)
    g = torch.Generator().manual_seed(0)
    dirs6, c16, c26 = _pad_dirs_to_tile(*direction_tables(6, dev))
    _, c14, c24 = _pad_dirs_to_tile(*direction_tables(4, dev))
    for radius in (0.05, 0.015):
        cfg6 = default_config(radius_sizes=(radius,))
        cfg4 = default_config(granularity=4, radius_sizes=(radius,))
        NX = cfg6.num_x_max
        p6 = voting_problem(cfg6, frame, dev) + (NX,)
        p4 = voting_problem(cfg4, frame, dev) + (NX,)
        timed = radius == 0.05
        Xs, act, half, dx, nx, _ = p6
        print(f"frame at radius {radius}: {int(act.sum())} voxel points of {Xs.shape[0]}, "
              f"num_x {int(nx)}, NX {NX}, {c16.shape[0]} directions", flush=True)

        xk, yk = V.vote_bins_kernel(Xs, c16, c26, half, dx, nx)
        xp, yp = V.vote_bins(Xs, c16, c26, half, dx, nx)
        n_bad = int((xk != xp).sum() + (yk != yp).sum())
        check(n_bad == 0, f"bins bit-equal on a g6 frame at NX {NX}: "
                          f"{2 * xk.numel()} bins, {n_bad} differ")
        del xk, yk, xp, yp

        sh.state("the full g6 table", p6, c16, c26, timed=timed)
        for rows in (2048, 256):
            sh.state(f"{rows} gathered rows", p6, *gathered(c16, c26, rows, g), timed=timed)
        removed = act & (torch.rand(act.shape, generator=g).to(dev) < 0.3)
        sh.state("the rebuild (30% of points removed)", p6, c16, c26, active=act & ~removed)

        X4, act4, half4, dx4, nx4, _ = p4
        sh.histogram("g4", p4, c14, c24, timed=timed)
        n_rem = min(512, int(act4.sum()))
        rem = act4 & (torch.cumsum(act4.to(torch.int32), 0) <= n_rem)
        Xr = _compact_removed(X4, rem, n_rem).contiguous()
        live = torch.ones(n_rem, dtype=torch.bool, device=dev)
        sh.histogram(f"a {n_rem}-column delta", (Xr, live, half4, dx4, nx4, NX),
                     c14, c24, timed=timed)
        if timed:
            shard_shape_checks(sh, cfg6, cfg4, p6, p4, dev)
        if radius == 0.015:
            sh.time("vote_state", "the full g6 table", Xs, act, c16, c26, half, dx, nx, NX)
            sh.time("vote_histogram", "g4", X4, act4, c14, c24, half4, dx4, nx4, NX)

    # edge cases at NX 79
    cfg6 = default_config()
    NX = cfg6.num_x_max
    p6 = voting_problem(cfg6, frame, dev) + (NX,)
    Xs, act, half, dx, nx, _ = p6
    none = torch.zeros_like(act)
    best, key, ub = sh.state("an all-false mask", p6, c16, c26, active=none)
    check(int(best.abs().max() + key.abs().max() + ub.abs().max()) == 0,
          "an all-false mask gives (0, 0, 0) in every direction")
    sh.histogram("an all-false mask", p6, c14, c24, active=none)
    everyone = torch.ones_like(act)
    sh.state("N = 4096 all active", p6, c16, c26, active=everyone)
    sh.histogram("N = 4096 all active", p6, c14, c24, active=everyone)
    t = torch.linspace(-1.0, 1.0, Xs.shape[0], device=dev)[:, None]
    line = (t * dirs6[1000][None, :] + torch.tensor([0.2, -0.1, 0.3], device=dev)).contiguous()
    Xl, _, _, half_l, nx_l = center_cloud(line, everyone, dx)
    pl = (Xl, everyone, half_l, dx, nx_l, NX)
    best, _, _ = sh.state("4096 points on one line along direction 1000", pl, c16, c26)
    print(f"      the line's own direction: {int(best[1000])} of {Xs.shape[0]} points "
          f"in its best cell", flush=True)
    sh.histogram("4096 points on one line", pl, c14, c24)

    # the chunked staging: points that do not fit beside one histogram
    big = V.MAX_NX
    sh.state(f"NX {big}, the largest grid (points staged in chunks)", p6[:5] + (big,), c16, c26)
    sh.histogram(f"NX {big}, the largest grid (points staged in chunks)", p6[:5] + (big,),
                 *gathered(c14, c24, 256, g))
    gen = torch.Generator().manual_seed(1)
    cloud = (torch.rand(20_000, 3, generator=gen) * 2.4 - 1.2).to(dev)
    Xc, _, _, half_c, nx_c = center_cloud(cloud, torch.ones(20_000, dtype=torch.bool,
                                                            device=dev), dx)
    pc = (Xc, torch.ones(20_000, dtype=torch.bool, device=dev), half_c, dx, nx_c, NX)
    sh.state("N = 20,000 (points staged in chunks)", pc, c16, c26)
    sh.histogram("N = 20,000 (points staged in chunks)", pc, c14, c24)
    return sh


SHARD_LABEL = "a direction shard, {gran}, 1 of {n}"


def shard_shape_checks(sh, cfg6, cfg4, p6, p4, dev):
    """Each kernel against its plain version at the row counts a direction
    shard gives it: the table padded to a multiple of n_dir with copies of
    direction 0, cut into n_dir slices, each padded to a multiple of 128.
    The last slice is the one that holds the copies."""
    from pointcloud_segmentation_tpu_torch.ops.hough import _pad_dirs_to_tile
    from pointcloud_segmentation_tpu_torch.parallel.sharding import _padded_dir_tables

    for cfg, p, n_dir, check in ((cfg6, p6, 2, sh.state), (cfg6, p6, 4, sh.state),
                                 (cfg4, p4, 2, sh.histogram)):
        tables = _padded_dir_tables(cfg, n_dir, dev)
        rows = tables[0].shape[0] // n_dir
        for k in (0, n_dir - 1):
            _, c1, c2 = _pad_dirs_to_tile(*(t[k * rows:(k + 1) * rows].contiguous()
                                            for t in tables))
            label = SHARD_LABEL.format(gran=f"g{cfg.granularity}", n=n_dir)
            if k:
                label += " (the last slice)"
            check(label, p, c1.contiguous(), c2.contiguous(), timed=(k == 0))
        print(f"      g{cfg.granularity} table of {tables[0].shape[0]} rows over n_dir "
              f"{n_dir}: {rows} rows a rank, {c1.shape[0]} after tile padding", flush=True)


def endpoints(s):
    a, b = np.asarray(s["a"], np.float64), np.asarray(s["b"], np.float64)
    t0, t1 = (s["t_min"], s["t_max"]) if "t_min" in s else s["endpoints"]
    return a + t0 * b, a + t1 * b


def endpoint_gap(s, g) -> float:
    (p1, p2), (g1, g2) = endpoints(s), endpoints(g)
    return min(np.linalg.norm(p1 - g1) + np.linalg.norm(p2 - g2),
               np.linalg.norm(p1 - g2) + np.linalg.norm(p2 - g1))


def golden_checks(dev):
    """Both golden fixtures of tests/test_golden.py, through the kernels."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.config import StaticShapes, default_config
    from pointcloud_segmentation_tpu_torch.io.scene import OBS_TESTS_SCENE, WP_TESTS, trajectory_poses
    from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec
    from pointcloud_segmentation_tpu_torch.runtime.csvio import read_segments_csv

    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)
    cases = (
        ("golden_segments.csv", 2, StaticShapes(max_raw_points=4096, max_points=2048,
                                                max_world_segments=32),
         frames_of(OBS_TESTS_SCENE, poses[:6], TofSpec(noise_frac=0.001), 7)),
        ("golden_segments_g6.csv", 6, StaticShapes(max_raw_points=2048, max_points=1024,
                                                   max_world_segments=32),
         frames_of(OBS_TESTS_SCENE, poses[:4],
                   TofSpec(width=32, height=32, noise_frac=0.001), 7)),
    )
    for name, gran, shapes, frames in cases:
        cfg = default_config(granularity=gran, shapes=shapes)
        eng = SegmentationEngine(cfg, dev)
        eng.run_replay(frames)
        segs = eng.world_segments()
        golden = read_segments_csv(f"tests/fixtures/{name}")
        check(len(segs) == len(golden),
              f"{name} ({cfg.voting_mode}): {len(segs)} segments, fixture {len(golden)}")
        worst = max(endpoint_gap(s, g) for s, g in zip(segs, golden))
        check(worst < 2e-2, f"{name} ({cfg.voting_mode}): endpoints within 2e-2 (worst {worst:.3g})")


class Counted:
    """A voting function that counts its calls by (rows, points); the
    carry subtract's removed points (at most 512) count as one shape."""

    def __init__(self, fn):
        self.fn = fn
        self.shapes = collections.Counter()

    def __call__(self, Xs, active, c1, *args):
        n = Xs.shape[0]
        self.shapes[(c1.shape[0], n if n > 512 else "<= 512")] += 1
        return self.fn(Xs, active, c1, *args)


def replay(cfg, frames, dev, voting):
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy

    eng = SegmentationEngine(cfg, dev, voting=voting)
    recs = eng.run_replay(frames)
    torch.cuda.synchronize()
    return {"records": recs, "segments": eng.world_segments(),
            "state": world_state_to_numpy(eng.state)}


def beams_matched(segs) -> int:
    """Beams of the 7-beam scene matched by a world segment within 0.1 rad
    of the beam's axis whose midpoint lies within 0.5 m of its centre."""
    from pointcloud_segmentation_tpu_torch.io.scene import OBS_TESTS_SCENE

    matched = 0
    for c in OBS_TESTS_SCENE:
        ax, ctr = np.asarray(c.axis), np.asarray(c.center)
        for s in segs:
            bn = np.asarray(s["b"]) / np.linalg.norm(s["b"])
            p1, p2 = endpoints(s)
            if (np.arccos(np.clip(abs(bn @ ax), -1, 1)) < 0.1
                    and np.linalg.norm((p1 + p2) / 2 - ctr) < 0.5):
                matched += 1
                break
    return matched


def same_extraction(run, ref, label):
    got = [(r["nblines"], r["status"]) for r in run["records"]]
    want = [(r["nblines"], r["status"]) for r in ref["records"]]
    check(got == want, f"{label}: per-frame nlines and status equal ({len(got)} frames)")
    ps = [s["points_size"] for s in run["segments"]]
    check(ps == [s["points_size"] for s in ref["segments"]],
          f"{label}: world segments' points_size equal ({len(ps)} segments)")
    worst = max((endpoint_gap(s, g) for s, g in zip(run["segments"], ref["segments"])),
                default=0.0)
    check(worst <= 5e-3, f"{label}: endpoints within 5e-3 (worst {worst:.3g})")


def counted_voting():
    """Voting functions that count their calls, with every launch count set
    to 0: call just before a path is driven, and `launches_of` just after."""
    from pointcloud_segmentation_tpu_torch.ops import voting as V
    from pointcloud_segmentation_tpu_torch.ops.hough import Voting

    V.vote_state.launches = 0
    V.vote_histogram.launches = 0
    return Voting(Counted(V.vote_state), Counted(V.vote_histogram))


def launches_of(label, voting, name="vote_state") -> int:
    """The launches of `name`'s kernel since counted_voting(); fails unless
    the path launched it, and launched it on every call."""
    from pointcloud_segmentation_tpu_torch.ops import voting as V

    launches = {"vote_state": V.vote_state.launches,
                "vote_histogram": V.vote_histogram.launches}
    shapes = dict(sorted(getattr(voting, name).shapes.items(), key=str))
    print(f"launches, {label}: vote_state {launches['vote_state']}, vote_histogram "
          f"{launches['vote_histogram']}; {name} calls by (rows, points) {shapes}", flush=True)
    check(launches[name] > 0, f"{label} launched {name} {launches[name]} times")
    check(launches[name] == sum(shapes.values()),
          f"{label}: every {name} call of the path launched the kernel")
    return launches[name]


def counted_run(label, cfg, frames, dev, name):
    """One path of the main path, its kernel's launch count set to 0 just
    before and read just after; returns (run, launches).  The run keeps its
    calls by (rows, points) under "shapes"."""
    voting = counted_voting()
    run = replay(cfg, frames, dev, voting)
    n = launches_of(label, voting, name)
    run["shapes"] = dict(getattr(voting, name).shapes)
    return run, n


def same_state(a, b) -> bool:
    return all(np.array_equal(a[f], b[f], equal_nan=True) for f in a)


def no_sentinels(records) -> bool:
    return all(r["seg_vec_size"] >= 0 and r["nblines"] >= 0 for r in records)


def lockstep_stream(cfg, frames, ref, tmp, card):
    """The recorded replay through the streaming worker, one frame at a
    time (drain after each submit): nothing may drop, and the world state
    must equal the synchronous replay's bit for bit.  Returns the log."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy
    from pointcloud_segmentation_tpu_torch.io.replay import load_frames, save_frames

    log = os.path.join(tmp, "replay.pcsl")
    save_frames(log, frames)
    back = load_frames(log)
    check(len(back) == len(frames) and all(
        a.t == b.t and a.points.tobytes() == b.points.tobytes()
        and a.position.tobytes() == b.position.tobytes()
        and a.quat_wxyz.tobytes() == b.quat_wxyz.tobytes() for a, b in zip(back, frames)),
        f"the replay written to a .pcsl log and read back: {len(back)} frames, bit-equal")
    viz = os.path.join(tmp, "lockstep_viz.jsonl")
    voting = counted_voting()
    # one viz record a frame (the synchronous worker); deferred_phase holds
    # the default, one record a read-back batch
    eng = SegmentationEngine(cfg, voting=voting, viz_stream=viz, viz_every_frame=True)
    eng.start()
    t0 = time.perf_counter()
    try:
        for i, fr in enumerate(back):
            eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
            eng.submit_cloud(fr.t, fr.points)
            # drain wakes when the worker finishes the frame; it does not poll
            if not eng.drain(target_total=i + 1, timeout=120.0):
                fail(f"lockstep stream: frame {i} not accounted for in 120 s")
    finally:
        wall = time.perf_counter() - t0
        eng.stop()
    launches_of("lockstep stream", voting)
    eng.finalize(os.path.join(tmp, "lockstep"))
    n = len(frames)
    check((eng.frames_processed, eng.dropped_frames, eng.frames_failed,
           eng.frames_skipped_no_pose) == (n, 0, 0, 0),
          f"lockstep stream: {eng.frames_processed} processed, {eng.dropped_frames} dropped, "
          f"{eng.frames_failed} failed, {eng.frames_skipped_no_pose} skipped")
    check(no_sentinels(eng.records), "lockstep stream: no record holds -1")
    check([(r["seg_vec_size"], r["nblines"]) for r in eng.records]
          == [(r["seg_vec_size"], r["nblines"]) for r in ref["records"]],
          "lockstep stream: per-frame world count and nlines equal the g6 replay's")
    check(same_state(world_state_to_numpy(eng.state), ref["state"]),
          "lockstep stream: world state bit-identical to the synchronous g6 replay")
    with open(viz) as f:
        recs = [json.loads(line) for line in f]
    check(len(recs) == n and [r["frame"] for r in recs] == list(range(1, n + 1))
          and all(set(r) == VIZ_KEYS for r in recs)
          and all(len(r["cylinders"]) == r["world_count"] for r in recs),
          f"lockstep stream: {len(recs)} viz records, one per frame, with the JAX "
          f"record's keys")
    print(f"time  lockstep stream, {n} frames: {eng.frames_processed / wall:.3f} processed "
          f"frames/s, the worker's sustained rate, from the first submit to the last "
          f"drain ({wall:.3f} s), median "
          f"processing_time {statistics.median(r['processing_time'] for r in eng.records) / 1e3:.3f}"
          f" ms [{card}]", flush=True)
    return log


def paced_streams(cfg, log, n, card):
    """run_streaming_from_log at the CLI's default 30 Hz, then unpaced.  Each
    count is its own counter (dropped is the mailbox's), so a frame lost
    between them, or a drain that timed out, fails the run."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy

    for rate in (30.0, 0.0):
        label = f"stream at {rate:g} Hz" if rate else "unpaced stream"
        voting = counted_voting()
        eng = SegmentationEngine(cfg, voting=voting)
        s = eng.run_streaming_from_log(log, rate_hz=rate)
        launches_of(label, voting)
        check(s["drained"] is True, f"{label}: every frame accounted for before stop "
              f"(drain {s['drain_s']} s)")
        check(s["fed"] == n and s["fed"] == s["processed"] + s["dropped"] + s["skipped"]
              + s["failed"] and s["dropped"] == eng.dropped_frames,
              f"{label}: fed {s['fed']} = {s['processed']} processed + {s['dropped']} "
              f"dropped by the mailbox + {s['skipped']} skipped + {s['failed']} failed")
        check(s["failed"] == 0 and s["processed"] >= 1 and no_sentinels(eng.records),
              f"{label}: none failed, no record holds -1")
        state = world_state_to_numpy(eng.state)
        check(all(np.isfinite(state[f]).all() for f in ("a", "b", "t_min", "t_max")),
              f"{label}: world state finite ({int(state['count'])} segments)")
        median = statistics.median(r['processing_time'] for r in eng.records) / 1e3
        if rate:
            wall = s["feed_s"] + s["drain_s"]
            print(f"time  {label}, {n} frames: dropped share {s['dropped'] / s['fed']:.3f}, "
                  f"{s['processed']} processed in feed_s + drain_s ({s['feed_s']} + "
                  f"{s['drain_s']} s, {s['processed'] / wall:.3f} frames/s), median "
                  f"processing_time {median:.3f} ms [{card}]", flush=True)
        else:
            # the feed ends before the worker wakes, so this times one frame
            print(f"time  {label}, {n} frames: {s['processed']} processed, dropped share "
                  f"{s['dropped'] / s['fed']:.3f}, latency of the last frame after the "
                  f"feed (drain_s) {s['drain_s']} s, median processing_time {median:.3f} ms "
                  f"[{card}]", flush=True)


def serve_phase(cfg, frames, tmp):
    """The TCP server on the card engine: a client streams the replay at
    30 Hz and queries; the served snapshot equals the engine's."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.runtime.csvio import read_segments_csv
    from pointcloud_segmentation_tpu_torch.runtime.server import (
        SegmentationClient, SegmentationServer)

    voting = counted_voting()
    eng = SegmentationEngine(cfg, voting=voting)
    srv = SegmentationServer(eng, host="127.0.0.1", port=0,
                             outdir=os.path.join(tmp, "serve")).start()
    try:
        cli = SegmentationClient(srv.host, srv.port, timeout=120.0)
        for fr in frames:
            cli.send_frame(fr.t, fr.position, fr.quat_wxyz, fr.points)
            time.sleep(1 / 30)
        deadline = time.monotonic() + 120.0
        while True:
            snap = cli.query()
            done = (snap["frames_processed"] + snap["frames_dropped"]
                    + snap["frames_skipped_no_pose"] + eng.frames_failed)
            if done >= len(frames) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        segs, inter = eng.world_snapshot()
        served = [(s["a"], s["b"], s["t_min"], s["t_max"], s["radius"], s["points_size"],
                   s["pca_coeff"]) for s in snap["world_segments"]]
        local = [([float(v) for v in s["a"]], [float(v) for v in s["b"]], s["t_min"],
                  s["t_max"], s["radius"], s["points_size"], s["pca_coeff"]) for s in segs]
        check(served == local and [tuple(r) for r in snap["intersections"]] == inter,
              f"serve: the snapshot's {len(served)} world segments and {len(inter)} "
              f"intersections equal engine.world_snapshot()")
        check(done == len(frames) and eng.frames_failed == 0,
              f"serve: {len(frames)} frames = {snap['frames_processed']} processed + "
              f"{snap['frames_dropped']} dropped + {snap['frames_skipped_no_pose']} skipped, "
              f"none failed")
        out = cli.finalize()
        cli.close()
    finally:
        srv.stop()
    launches_of("serve", voting)
    check(out.get("drained") is True, "serve: finalize drained")
    for name, path in (("segments.csv", out["outputs"]["segments"]),
                       ("intersections.csv", out["outputs"]["intersections"]),
                       ("processing_time.csv", out["outputs"]["processing_time"])):
        with open(path) as f:
            check(f.readline().strip() == CSV_HEADERS[name], f"serve: {name} has the reference header")
    rows = read_segments_csv(out["outputs"]["segments"])
    check(len(rows) == len(eng.world_segments()) == len(segs),
          f"serve: segments.csv has {len(rows)} rows, as many as the final snapshot")


def cli(*args):
    """One CLI subprocess on the default device; its standard output."""
    cmd = [sys.executable, "-m", "pointcloud_segmentation_tpu_torch", *args]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    label = " ".join(a for a in args[:2] if a.startswith("--") or a is args[0])
    if out.returncode != 0:
        fail(f"cli {label} exited {out.returncode}:\n{out.stdout}\n{out.stderr}")
    check(True, f"cli {label} exited 0 in {time.perf_counter() - t0:.1f} s")
    return out.stdout


def cli_phase(tmp):
    """The CLI in subprocesses with the default device: run + eval + timing,
    record + stream."""
    def headers(outdir, label):
        for name, header in CSV_HEADERS.items():
            with open(os.path.join(outdir, name)) as f:
                check(f.readline().strip() == header, f"cli {label}: {name} has the reference header")

    run_out = os.path.join(tmp, "cli_run")
    text = cli("run", "--max-frames", "12", "--out", run_out)
    print("      " + text.splitlines()[0], flush=True)
    headers(run_out, "run")
    rep = json.loads(cli("eval", os.path.join(run_out, "segments.csv")))
    check(rep["n_truth_matched"] >= 1,
          f"cli eval: {rep['n_truth_matched']} of {rep['n_truth']} beams matched")
    summ = json.loads(cli("timing", os.path.join(run_out, "processing_time.csv")))
    check(summ["n_frames"] == 12, f"cli timing: {summ['n_frames']} frames")
    log = os.path.join(tmp, "cli.pcsl")
    cli("record", log, "--max-frames", "31")
    stream_out = os.path.join(tmp, "cli_stream")
    text = cli("stream", log, "--rate", "30", "--out", stream_out)
    print("      " + text.splitlines()[0], flush=True)
    headers(stream_out, "stream")


def checkpoint_phase(cfg, frames, ref, tmp):
    """Save after frame 15, load into a fresh engine, run the rest: the world
    state must equal the straight replay's bit for bit."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy

    ckpt = os.path.join(tmp, "state.npz")
    voting = counted_voting()
    first = SegmentationEngine(cfg, voting=voting)
    first.run_replay(frames[:15])
    launches_of("checkpoint, frames 1-15", voting)
    first.save_checkpoint(ckpt)
    voting = counted_voting()
    resumed = SegmentationEngine(cfg, voting=voting)
    resumed.load_checkpoint(ckpt)
    resumed.run_replay(frames[15:])
    launches_of("checkpoint resume", voting)
    check(resumed.frames_processed == len(frames) and len(resumed.records) == len(frames),
          f"checkpoint: resumed at 15, {resumed.frames_processed} frames, "
          f"{len(resumed.records)} records")
    check(same_state(world_state_to_numpy(resumed.state), ref["state"]),
          "checkpoint: resume after frame 15 gives a world state bit-identical to "
          "the straight g6 replay")


# ------------------------------------------------- sensor data and display

def same_frames(a, b) -> bool:
    """Two frame lists equal bit for bit: times, clouds and poses."""
    return len(a) == len(b) and all(
        x.t == y.t and np.asarray(x.points).tobytes() == np.asarray(y.points).tobytes()
        and np.asarray(x.position).tobytes() == np.asarray(y.position).tobytes()
        and np.asarray(x.quat_wxyz).tobytes() == np.asarray(y.quat_wxyz).tobytes()
        for x, y in zip(a, b))


def chunked_mcap(plain: str, path: str, compression: str) -> None:
    """rosbag2's default layout from a plain MCAP file: its message records
    rewrapped into one CHUNK record ("" or "zstd") that carries their CRC."""
    from pointcloud_segmentation_tpu_torch.io import mcap as M

    with open(plain, "rb") as f:
        src = f.read()
    keep, blob, off = [], [], len(M.MAGIC)
    while off + 9 <= len(src):
        op = src[off]
        (clen,) = struct.unpack_from("<Q", src, off + 1)
        rec = src[off: off + 9 + clen]
        off += 9 + clen
        if op == M._OP_MESSAGE:
            blob.append(rec)
        elif op in (M._OP_HEADER, M._OP_SCHEMA, M._OP_CHANNEL):
            keep.append(rec)
    blob = b"".join(blob)
    if compression == "zstd":
        import zstandard

        packed = zstandard.ZstdCompressor().compress(blob)
    else:
        packed = blob
    name = compression.encode()
    chunk = (struct.pack("<QQQI", 0, 0, len(blob), zlib.crc32(blob))
             + struct.pack("<I", len(name)) + name + struct.pack("<Q", len(packed)) + packed)
    with open(path, "wb") as f:
        f.write(M.MAGIC + b"".join(keep) + M._rec(M._OP_CHUNK, chunk)
                + M._rec(M._OP_FOOTER, struct.pack("<QQI", 0, 0, 0)) + M.MAGIC)


def two_cloud_topic_bag(path: str, frames) -> None:
    """A record-everything ROS1 capture of `frames`: /tof_pc, the node's
    republished /filtered_pointcloud (the same clouds) and one pose topic."""
    from pointcloud_segmentation_tpu_torch.io import rosbag as R

    def conn(i, topic, mtype):
        hdr = (R._field("op", bytes([0x07])) + R._field("conn", struct.pack("<I", i))
               + R._field("topic", topic))
        return R._record(hdr, R._field("topic", topic) + R._field("type", mtype))

    def msg(i, t, payload):
        return R._record(R._field("op", bytes([0x02])) + R._field("conn", struct.pack("<I", i))
                         + R._field("time", R._enc_time(t)), payload)

    with open(path, "wb") as f:
        f.write(R._MAGIC)
        f.write(conn(0, b"/tof_pc", b"sensor_msgs/PointCloud2"))
        f.write(conn(1, b"/filtered_pointcloud", b"sensor_msgs/PointCloud2"))
        f.write(conn(2, b"/mavros/local_position/pose", b"geometry_msgs/PoseStamped"))
        for k, fr in enumerate(frames):
            f.write(msg(2, fr.t, R._ser_posestamped(fr.t, fr.position, fr.quat_wxyz, k)))
            for i in (0, 1):
                f.write(msg(i, fr.t, R._ser_pointcloud2(fr.t, fr.points, k)))


def fed_replay(label, cfg, decoded, ref, source_equal, dev, kernel):
    """A replay of decoded frames on the card against the replay of the
    source frames: integers exact, endpoints within 5e-3, and the world
    state bit for bit where the decoded frames equal the source's."""
    run, _ = counted_run(label, cfg, decoded, dev, kernel)
    same_extraction(run, ref, label)
    counts = [r["seg_vec_size"] for r in run["records"]]
    check(counts == [r["seg_vec_size"] for r in ref["records"]],
          f"{label}: per-frame world count equal ({counts[-1]} segments at the end)")
    if source_equal:
        check(same_state(run["state"], ref["state"]),
              f"{label}: world state bit-identical to the replay of the source frames")
    return run


def bag_phase(cfg6, cfg4, frames, k6, dev, card, tmp):
    """The frames through every container and back, then through the card."""
    from pointcloud_segmentation_tpu_torch.io import mcap, rosbag
    from pointcloud_segmentation_tpu_torch.ops.hough import KERNELS

    def path(name):
        return os.path.join(tmp, name)

    n = len(frames)
    writers = [("ROS1 bag", path("flight.bag"), lambda p: rosbag.frames_to_bag(p, frames)),
               ("ROS1 bag, bz2", path("flight_bz2.bag"),
                lambda p: rosbag.frames_to_bag(p, frames, compression="bz2")),
               ("MCAP", path("flight.mcap"), lambda p: mcap.frames_to_mcap(p, frames)),
               ("MCAP, one chunk", path("flight_chunk.mcap"),
                lambda p: chunked_mcap(path("flight.mcap"), p, ""))]
    if importlib.util.find_spec("zstandard") is not None:
        writers.append(("MCAP, one zstd chunk", path("flight_zstd.mcap"),
                        lambda p: chunked_mcap(path("flight.mcap"), p, "zstd")))
    else:
        print("      zstandard does not import here: no zstd chunk", flush=True)
    decoded = {}
    for label, p, write in writers:
        write(p)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            back = rosbag.bag_to_frames(p)
            times.append((time.perf_counter() - t0) * 1e3 / n)
        decoded[label] = back
        check(len(back) == n and all(a.points.tobytes() == b.points.tobytes()
                                     for a, b in zip(back, frames)),
              f"{label}: {len(back)} frames decoded, every cloud bit-equal to its source")
        print(f"time  {label}, {n} frames: bag_to_frames {min(times):.4f} ms a frame on the "
              f"host (best of 3), file {os.path.getsize(p)} bytes [{card}]", flush=True)
    first = decoded["ROS1 bag"]
    check(all(same_frames(first, d) for d in decoded.values()),
          f"the {len(decoded)} decoded frame lists are equal to each other bit for bit")
    source_equal = same_frames(first, frames)
    print(f"      decoded poses and stamps {'equal' if source_equal else 'differ from'} the "
          f"source frames' bit for bit", flush=True)
    last = list(decoded)[-1]
    runs = [fed_replay(f"g6 replay fed from the {label}", cfg6, decoded[label], k6,
                       source_equal, dev, "vote_state")
            for label in ("ROS1 bag, bz2", last)]
    ref4 = replay(cfg4, frames[:12], dev, KERNELS)
    fed_replay("g4 replay of 12 frames fed from the MCAP", cfg4, decoded["MCAP"][:12], ref4,
               source_equal, dev, "vote_histogram")

    def ms_per_frame(run):
        return statistics.median(r["processing_time"] for r in run["records"]) / 1e3

    print(f"time  replay g6 fed from decoded frames, {n} frames, median ms/frame: "
          f"{ms_per_frame(runs[0]):.3f} (bz2 bag), {ms_per_frame(runs[1]):.3f} ({last}); the "
          f"replay of the source frames {ms_per_frame(k6):.3f} [{card}]", flush=True)
    return path("flight_bz2.bag")


def refusal_phase(cfg6, frames, k6, dev, tmp):
    """Ambiguous and broken recordings on the card's path: refused before a
    frame reaches the engine, or run once the caller has picked a topic."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.io import rosbag

    two = os.path.join(tmp, "two_topics.bag")
    two_cloud_topic_bag(two, frames)
    eng = SegmentationEngine(cfg6, dev)
    try:
        eng.run_replay(rosbag.bag_to_frames(two))
        fail("a bag with two cloud topics was read")
    except IOError as e:
        check("/tof_pc" in str(e) and "/filtered_pointcloud" in str(e)
              and "--cloud-topic" in str(e) and eng.frames_processed == 0,
              f"a bag with two cloud topics is refused and names both: {e}")
    picked = rosbag.bag_to_frames(two, cloud_topic="/tof_pc")
    check(same_frames(picked, rosbag.bag_to_frames(os.path.join(tmp, "flight.bag"))),
          f"with cloud_topic='/tof_pc' the same bag gives the {len(picked)} frames of the "
          f"plain bag bit for bit")
    voting = counted_voting()
    eng = SegmentationEngine(cfg6, dev, voting=voting)
    recs = eng.run_replay(picked[:8])
    launches_of("g6 replay of 8 frames of the picked topic", voting)
    check([(r["nblines"], r["status"], r["seg_vec_size"]) for r in recs]
          == [(r["nblines"], r["status"], r["seg_vec_size"]) for r in k6["records"][:8]],
          "the picked topic runs: nlines, status and world count of the replay's first 8 frames")

    with open(os.path.join(tmp, "flight.bag"), "rb") as f:
        src = f.read()
    # 13 bytes of magic and a bag header padded to 4096: the chunk starts at 4109
    cut = os.path.join(tmp, "cut.bag")
    with open(cut, "wb") as f:
        f.write(src[: 4109 + (len(src) - 4109) // 2])
    with open(cut, "rb") as f:
        f.seek(len(rosbag._MAGIC))
        try:
            while rosbag._read_record(f) is not None:
                pass
            fail("a bag cut in the middle of its chunk read to its end")
        except rosbag.TruncatedBag as e:
            check(True, f"a bag cut in the middle of its chunk: the record reader raises "
                        f"TruncatedBag ({e})")
    eng = SegmentationEngine(cfg6, dev)
    try:
        eng.run_replay(rosbag.bag_to_frames(cut))
        fail("a closed bag cut in the middle of its chunk was read")
    except IOError as e:
        check("corrupt, not merely truncated" in str(e) and eng.frames_processed == 0,
              f"bag_to_frames refuses it before a frame reaches the engine, since its header "
              f"says the recording was closed: {e}")
    j = src.index(b"index_pos=") + len(b"index_pos=")
    with open(cut, "wb") as f:
        f.write((src[:j] + b"\x00" * 8 + src[j + 8:])[: 4109 + (len(src) - 4109) // 2])
    check(rosbag.bag_to_frames(cut) == [],
          "the same cut in an unclosed recording (index_pos 0) is a torn tail: a warning, "
          "no frame from the half chunk")


def cloud_message(fr):
    """A duck-typed sensor_msgs/PointCloud2 of one frame: x, y, z float32 and
    an intensity field, 16 bytes a point."""
    rec = np.zeros((len(fr.points), 4), np.float32)
    rec[:, :3] = fr.points
    secs = int(fr.t)
    return types.SimpleNamespace(
        fields=[types.SimpleNamespace(name=name, offset=4 * i)
                for i, name in enumerate(("x", "y", "z", "intensity"))],
        point_step=16, is_bigendian=False, data=rec.tobytes(),
        header=types.SimpleNamespace(stamp=types.SimpleNamespace(
            secs=secs, nsecs=int(round((fr.t - secs) * 1e9)))))


def pose_message(fr):
    secs = int(fr.t)
    p, q = fr.position, fr.quat_wxyz
    return types.SimpleNamespace(
        header=types.SimpleNamespace(stamp=types.SimpleNamespace(
            secs=secs, nsecs=int(round((fr.t - secs) * 1e9)))),
        pose=types.SimpleNamespace(
            position=types.SimpleNamespace(x=p[0], y=p[1], z=p[2]),
            orientation=types.SimpleNamespace(w=q[0], x=q[1], y=q[2], z=q[3])))


def bridge_phase(cfg6, frames, k6):
    """The frames as ROS messages through RosBridge.on_pose / on_cloud, each
    drained before the next; the bridge is made without rospy."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy
    from pointcloud_segmentation_tpu_torch.io.ros_bridge import RosBridge

    voting = counted_voting()
    eng = SegmentationEngine(cfg6, voting=voting)    # built on this thread
    if importlib.util.find_spec("rospy") is None:
        try:
            RosBridge(eng)
            fail("RosBridge was made without rospy")
        except ImportError as e:
            check("rospy" in str(e) and eng._worker is None,
                  "RosBridge without rospy raises ImportError and starts nothing")
    bridge = RosBridge.__new__(RosBridge)
    bridge.engine = eng
    eng.start()
    try:
        for i, fr in enumerate(frames):
            bridge.on_pose(pose_message(fr))
            bridge.on_cloud(cloud_message(fr))
            if not eng.drain(target_total=i + 1, timeout=120.0):
                fail(f"ROS bridge: frame {i} not accounted for in 120 s")
    finally:
        bridge.shutdown()
    launches_of("ROS bridge", voting)
    check((eng.frames_processed, eng.dropped_frames, eng.frames_failed,
           eng.frames_skipped_no_pose) == (len(frames), 0, 0, 0) and eng._worker is None,
          f"ROS bridge: {eng.frames_processed} processed, {eng.dropped_frames} dropped, "
          f"{eng.frames_failed} failed, {eng.frames_skipped_no_pose} skipped; worker stopped")
    check(same_state(world_state_to_numpy(eng.state), k6["state"]),
          "ROS bridge: world state bit-identical to the synchronous g6 replay (and so to "
          "the lockstep stream's)")


def sensor_cli_phase(bag, tmp, card):
    """record --bag, run --bag, bag-info, viz and inspect in subprocesses, on
    the default device."""
    log = os.path.join(tmp, "from_bag.pcsl")
    text = cli("record", log, "--bag", bag)
    check(text.strip() == f"recorded 31 frames -> {log}", "cli record --bag: " + text.strip())
    plots = importlib.util.find_spec("matplotlib") is not None
    out, stream = os.path.join(tmp, "cli_bag"), os.path.join(tmp, "cli_bag.jsonl")
    text = cli("run", "--bag", bag, "--max-frames", "12", "--viz-stream", stream, "--out", out,
               *(["--plots"] if plots else []))
    check(text.startswith("12 frames ->") and f"viz stream: {stream}" in text,
          "cli run --bag: " + text.splitlines()[0])
    for name, header in CSV_HEADERS.items():
        with open(os.path.join(out, name)) as f:
            check(f.readline().strip() == header,
                  f"cli run --bag: {name} has the reference header")
    if plots:
        with open(os.path.join(out, "world.png"), "rb") as f:
            check(f.read(4) == b"\x89PNG", "cli run --bag --plots wrote world.png")
    else:
        print("      matplotlib does not import here: --plots skipped", flush=True)
    text = cli("bag-info", bag)
    check("clouds: /tof_pc" in text and "poses: /mavros/local_position/pose" in text
          and "31 msgs" in text, "cli bag-info picks one cloud and one pose topic of 31 messages")
    text = cli("viz", stream)
    html = os.path.splitext(stream)[0] + ".html"
    with open(html) as f:
        line = next(ln for ln in f if ln.startswith("const FRAMES = "))
    held = json.loads(line[len("const FRAMES = "):].rstrip().rstrip(";"))
    check(text.strip() == f"12 frames -> {html}" and [r["frame"] for r in held]
          == list(range(1, 13)), "cli viz: the HTML player holds the stream's 12 frames")
    info = json.loads(cli("inspect"))
    check(info["backend"] == "torch" and info["device"] == torch.cuda.get_device_name(0)
          and (info["granularity"], info["num_directions"], info["num_x_max"],
               info["max_points"], info["max_world_segments"]) == (6, 20481, 79, 4096, 64),
          f"cli inspect: the shipped config's shape facts on {info['device']}")
    check(info["vote_state_launches"] > 0 and info["kernel_launches"] > info["vote_state_launches"]
          and info["device_us"] > 0 and info["nlines"] >= 1,
          f"cli inspect: frame {info['frame']} launched vote_state "
          f"{info['vote_state_launches']} times among {info['kernel_launches']} kernel launches")
    print(f"time  cli inspect, frame {info['frame']} of the 4 Hz flight after one warm-up "
          f"frame, under torch.profiler: kernel_launches {info['kernel_launches']}, device_us "
          f"{info['device_us']}, wall_ms {info['wall_ms']:.3f}, vote_state_launches "
          f"{info['vote_state_launches']}, vote_histogram_launches "
          f"{info['vote_histogram_launches']}, nlines {info['nlines']} [{card}]", flush=True)


def live_player_phase(cfg6, frames, tmp):
    """VizStreamServer following the JSONL of a running lockstep stream: one
    GET in mid-stream returns the records written so far."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.viz import VizStreamServer

    def get(url):
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.read()

    stream = os.path.join(tmp, "live.jsonl")
    voting = counted_voting()
    eng = SegmentationEngine(cfg6, voting=voting, viz_stream=stream, viz_every_frame=True)
    srv = VizStreamServer(stream)
    th = srv.start_background()
    part = frames[:10]
    eng.start()
    try:
        check(b"poll()" in get(srv.url), f"live player: the page is served at {srv.url}")
        for i, fr in enumerate(part):
            eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
            eng.submit_cloud(fr.t, fr.points)
            if not eng.drain(target_total=i + 1, timeout=120.0):
                fail(f"live player: frame {i} not accounted for in 120 s")
            if i == 5:
                mid = json.loads(get(srv.url + "stream?from=0"))
        rest = json.loads(get(srv.url + f"stream?from={mid['next']}&gen={mid['gen']}"))
    finally:
        eng.stop()
        srv.shutdown()
        th.join(timeout=30.0)
    launches_of("live player's stream", voting)
    eng.finalize(os.path.join(tmp, "live"))
    check([r["frame"] for r in mid["frames"]] == list(range(1, 7)) and mid["next"] == 6
          and all(set(r) == VIZ_KEYS for r in mid["frames"]),
          "live player: a GET of /stream after 6 frames returns the 6 records written so far")
    check([r["frame"] for r in rest["frames"]] == list(range(7, 11)) and rest["next"] == 10,
          "live player: the next poll returns the 4 records that followed, and no other")
    check(not th.is_alive() and eng._worker is None,
          "live player: server thread and worker both ended")


def sensor_stack(cfg6, cfg4, frames, k6, dev, card, tmp):
    t0 = time.perf_counter()
    bag = bag_phase(cfg6, cfg4, frames, k6, dev, card, tmp)
    refusal_phase(cfg6, frames, k6, dev, tmp)
    bridge_phase(cfg6, frames, k6)
    sensor_cli_phase(bag, tmp, card)
    live_player_phase(cfg6, frames, tmp)
    print(f"time  the sensor-data and display phases: {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)


# ------------------------------------------------------------------ parity stack

PARITY_TOL = 1e-4       # float64 mode against the oracle, on endpoints
# frames of the full-size replay that the g6 float64 phase holds against the
# oracle, which takes 5-12 s a frame on the host at 20,481 directions (all 31
# took 370 s): the 16 in mid-flight, where every beam is in view.  Cut the
# frames here, never the width, if the host is slower still
G6_PARITY_FRAMES = slice(8, 24)
# (mode, first seed, count) of tools/parity_soak_torch.py; the g6 seeds draw
# NX 79 grids and 3-4 frames
SOAK_SEEDS = (("base", 3000, 4), ("g6", 3100, 1), ("g6", 3102, 1))


def f64_parity(label, cfg, frames, kernel, card):
    """The float64 mode on the card against the oracle backend on the host,
    frame by frame: nlines, status, world count and every world segment's
    points_size and radius exact, endpoints and intersection parameters
    within 1e-4.  Returns (torch engine, oracle engine)."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine

    voting = counted_voting()
    eng = SegmentationEngine(cfg, voting=voting)
    ref = SegmentationEngine(cfg, backend="oracle")
    check(eng.state.a.dtype == torch.float64 and eng.state.inter.dtype == torch.float64
          and eng._tables[0].dtype == torch.float64 and eng._tables[1].dtype == torch.float32,
          f"{label}: float64 world map and direction vectors, float32 plane bases")
    worst, t_port, t_ref, nlines = 0.0, [], [], []
    for k, fr in enumerate(frames):
        for e in (eng, ref):
            e.push_pose(fr.t, fr.position, fr.quat_wxyz)
        got, want = eng.process_frame(fr.t, fr.points), ref.process_frame(fr.t, fr.points)
        t_port.append(got["processing_time"] / 1e3)
        t_ref.append(want["processing_time"] / 1e3)
        nlines.append(got["nblines"])
        for f in ("nblines", "status", "seg_vec_size"):
            if got[f] != want[f]:
                fail(f"{label}, frame {k}: {f} {got[f]} against the oracle's {want[f]}")
        (segs, inter), (osegs, ointer) = eng.world_snapshot(), ref.world_snapshot()
        for i, (s, o) in enumerate(zip(segs, osegs)):
            if (s["points_size"], s["radius"]) != (o["points_size"], o["radius"]):
                fail(f"{label}, frame {k}, segment {i}: points_size and radius "
                     f"{s['points_size']}, {s['radius']} against {o['points_size']}, {o['radius']}")
            (p1, p2), (q1, q2) = endpoints(s), endpoints(o)
            worst = max(worst, np.linalg.norm(p1 - q1), np.linalg.norm(p2 - q2),
                        abs(s["pca_coeff"] - o["pca_coeff"]))
        if [(i, j) for i, _, j, _ in inter] != [(i, j) for i, _, j, _ in ointer]:
            fail(f"{label}, frame {k}: intersections {inter} against {ointer}")
        for (_, a1, _, a2), (_, b1, _, b2) in zip(inter, ointer):
            worst = max(worst, abs(a1 - b1), abs(a2 - b2))
    launches_of(label, voting, kernel)
    n_seg, n_int = len(eng.world_segments()), len(eng.intersections_rows())
    check(sum(nlines) > 0 and n_seg >= 3,
          f"{label}: nlines, status, world count, points_size and radius equal the "
          f"oracle's on each of {len(frames)} frames ({sum(nlines)} lines, {n_seg} world "
          f"segments, {n_int} intersections)")
    check(worst <= PARITY_TOL, f"{label}: endpoints, pca_coeff and intersection "
          f"parameters within {PARITY_TOL} of the oracle's on every frame (worst {worst:.3g})")
    print(f"time  {label}, {len(frames)} frames, median ms/frame: float64 on the card "
          f"{statistics.median(t_port):.3f}, the oracle on the host "
          f"{statistics.median(t_ref):.3f} [{card}]", flush=True)
    return eng, ref


def f64_kernel_checks(dev, frame, card):
    """On one float64 frame, the float32 copy that ops/hough.py hands the
    voting layer gives the same bins, vote_state and vote_histogram outputs
    through the kernels as through their plain versions, and the oracle's
    bins."""
    from pointcloud_segmentation_tpu_torch.config import default_config
    from pointcloud_segmentation_tpu_torch.oracle.pipeline import HoughSpace
    from pointcloud_segmentation_tpu_torch.ops import voting as V
    from pointcloud_segmentation_tpu_torch.ops.hough import (
        _pad_dirs_to_tile, center_cloud, direction_tables, vote_inputs)
    from pointcloud_segmentation_tpu_torch.ops.preproc import preprocess

    sh = Shapes(card)
    for gran, name in ((6, "vote_state"), (4, "vote_histogram")):
        cfg = default_config(granularity=gran, compute_dtype="float64")
        NX = cfg.num_x_max
        raw = np.full((cfg.shapes.max_raw_points, 3), np.nan, np.float64)
        raw[: len(frame.points)] = frame.points[: len(raw)]
        pts, valid, _ = preprocess(torch.from_numpy(raw).to(dev), cfg)
        dx = torch.full((), cfg.opt_dx, dtype=torch.float64, device=dev)
        Xs, _, d, half, nx = center_cloud(pts, valid, dx)
        Xv, half32, dx32 = vote_inputs(Xs, half, dx)
        check(Xs.dtype == torch.float64 and Xv.dtype == half32.dtype == dx32.dtype
              == torch.float32 and Xv.is_contiguous(),
              f"float64 g{gran} frame: a float64 centred cloud, one contiguous float32 "
              f"copy and float32 half and dx for the voting layer")
        dirs, c1, c2 = _pad_dirs_to_tile(*direction_tables(gran, dev, torch.float64))
        xk, yk = V.vote_bins_kernel(Xv, c1, c2, half32, dx32, nx)
        xp, yp = V.vote_bins(Xv, c1, c2, half32, dx32, nx)
        n_bad = int((xk != xp).sum() + (yk != yp).sum())
        check(n_bad == 0, f"float64 g{gran} frame: kernel bins bit-equal to the plain "
                          f"bins ({2 * xk.numel()} bins, {n_bad} differ)")
        # the oracle bins the float64 points it casts itself, (n, B)
        hs = HoughSpace(gran, cfg.opt_dx, float(d))
        live = valid.cpu().numpy()
        xo, yo = hs.bin_indices(Xs.cpu().numpy()[live])
        B = hs.c1.shape[0]
        n_bad = int((xk[:B].cpu().numpy()[:, live] != xo.T).sum()
                    + (yk[:B].cpu().numpy()[:, live] != yo.T).sum())
        check(hs.num_x == int(nx) and n_bad == 0,
              f"float64 g{gran} frame: kernel bins equal the oracle's bins "
              f"({2 * xo.size} bins, {n_bad} differ, num_x {hs.num_x})")
        del xk, yk, xp, yp, xo, yo
        p = (Xv, valid, half32, dx32, nx, NX)
        if name == "vote_state":
            sh.state("float64 frame, the full g6 table", p, c1, c2)
        else:
            sh.histogram("float64 frame, g4", p, c1, c2)
        for wrapper in (V.vote_state, V.vote_histogram):
            try:
                wrapper(Xs, valid, c1, c2, half32, dx32, nx, NX)
            except ValueError:
                continue
            fail(f"{wrapper.__name__} took a float64 cloud on the card")
    check(True, "a float64 cloud on the card is refused by both wrappers, not converted")
    return sh


def lazy_equals_carry_f64(cfg4, frames, carry_engine, dev):
    import dataclasses

    from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy

    lazy, _ = counted_run("float64 g4 replay with lazy voting",
                          dataclasses.replace(cfg4, voting="lazy"), frames, dev, "vote_state")
    check(same_state(lazy["state"], world_state_to_numpy(carry_engine.state)),
          "float64 g4: lazy voting gives the carry replay's world state bit for bit")


def batched_phase(cfg, frames, ref, dev, card):
    """run_replay(batch=4) against the synchronous replay: bit-identical
    world state and the same per-frame nblines; sync, batched, batched, sync
    timed by the host clock around each whole replay."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy

    def timed(batch):
        voting = counted_voting()
        eng = SegmentationEngine(cfg, dev, voting=voting)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recs = eng.run_replay(frames, batch=batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(frames)
        return eng, recs, ms, voting

    _, _, s1, _ = timed(0)
    eng, recs, b1, voting = timed(4)
    launches_of("batched g6 replay", voting)
    _, _, b2, _ = timed(4)
    _, _, s2, _ = timed(0)
    check(same_state(world_state_to_numpy(eng.state), ref["state"]),
          "batched replay (batch 4): world state bit-identical to the synchronous g6 replay")
    check([(r["nblines"], r["status"], r["seg_vec_size"]) for r in recs]
          == [(r["nblines"], r["status"], r["seg_vec_size"]) for r in ref["records"]]
          and eng.frames_processed == len(frames) and no_sentinels(eng.records),
          f"batched replay: per-frame nblines, status and world count equal the "
          f"synchronous replay's ({len(recs)} frames, {-(-len(frames) // 4)} host reads)")
    print(f"time  replay g6, {len(frames)} frames, whole-replay ms/frame: batched (4) "
          f"{(b1 + b2) / 2:.3f}, synchronous {(s1 + s2) / 2:.3f} (sync, batched, batched, "
          f"sync: {s1:.3f} {b1:.3f} {b2:.3f} {s2:.3f}) [{card}]", flush=True)


def sequential_fusion_phase(cfg, frames, dev):
    """fuse_frame_sequential against fuse_frame on the card, on each frame's
    segments of the g6 replay and the world map they meet."""
    from pointcloud_segmentation_tpu_torch.ops.hough import direction_tables
    from pointcloud_segmentation_tpu_torch.pipeline import frame_segments
    from pointcloud_segmentation_tpu_torch.worldmap import (
        fuse_frame, fuse_frame_sequential, init_world, world_step)

    tables = direction_tables(cfg.granularity, dev)
    state = init_world(cfg, dev)
    fused = appended = 0
    for k, fr in enumerate(frames):
        raw = np.full((cfg.shapes.max_raw_points, 3), np.nan, np.float32)
        raw[: len(fr.points)] = fr.points[: len(raw)]
        segs = frame_segments(
            torch.from_numpy(raw).to(dev),
            torch.tensor(fr.position, dtype=torch.float32, device=dev),
            torch.tensor(fr.quat_wxyz, dtype=torch.float32, device=dev), cfg, tables)[4]
        vec, seq = fuse_frame(state, segs, cfg), fuse_frame_sequential(state, segs, cfg)
        for name, v, q in zip(("fields", "count", "valid", "modified", "new_flags", "slots"),
                              vec, seq):
            pairs = [(v[f], q[f]) for f in v] if isinstance(v, dict) else [(v, q)]
            if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
                fail(f"sequential fusion differs from the vectorised, frame {k}: {name}")
        fused += int(vec[3].sum())
        appended += int(vec[4].sum())
        state, _ = world_step(state, segs, cfg)
    check(fused > 0 and appended > 0,
          f"fuse_frame_sequential == fuse_frame bit for bit on the card, {len(frames)} "
          f"frames of the g6 replay ({fused} fusions, {appended} appends)")


def load_soak():
    spec = importlib.util.spec_from_file_location(
        "parity_soak_torch", REPO / "tools" / "parity_soak_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def soak_phase(card):
    """Fixed seeds of tools/parity_soak_torch.py on the card: the oracle
    against the torch backend, no unexplained divergence."""
    from pointcloud_segmentation_tpu_torch.ops import voting as V

    soak = load_soak()
    V.vote_state.launches = V.vote_histogram.launches = 0
    t0 = time.perf_counter()
    counts, n = collections.Counter(), 0
    for mode, seed, k in SOAK_SEEDS:
        if mode == "g6":
            cfg, _ = soak.random_case(seed, mode)
            check(cfg.num_x_max <= 105, f"soak seed {seed} ({mode}) draws a grid the oracle "
                                        f"bins in seconds (NX {cfg.num_x_max})")
        batch = soak.run_batch(k, seed, mode, False, "cuda")
        counts.update(batch["counts"])
        n += k
    check(counts.get("real", 0) == 0,
          f"soak: {n} seeds on cuda, 0 unexplained; diverging by class {dict(counts)}")
    check(V.vote_state.launches > 0 and V.vote_histogram.launches > 0,
          f"soak: launched vote_state {V.vote_state.launches} and vote_histogram "
          f"{V.vote_histogram.launches} times")
    print(f"time  soak, {n} seeds, both backends: {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)


def oracle_backend_phase(ref, tmp):
    """The oracle-backend engine of the g4 parity phase writes CSVs that
    parse, and the CLI runs with --backend oracle."""
    from pointcloud_segmentation_tpu_torch.runtime.csvio import read_segments_csv

    paths = ref.finalize(os.path.join(tmp, "oracle_engine"))
    for name, header in CSV_HEADERS.items():
        with open(paths[name[:-4]]) as f:
            check(f.readline().strip() == header, f"oracle backend: {name} has the reference header")
    rows, segs = read_segments_csv(paths["segments"]), ref.world_segments()
    worst = max(endpoint_gap(r, s) for r, s in zip(rows, segs))
    check(len(rows) == len(segs) >= 3 and worst < 1e-4,
          f"oracle backend: segments.csv parses to the engine's {len(segs)} world "
          f"segments (worst endpoint gap {worst:.3g}, 6 digits kept)")
    out = os.path.join(tmp, "cli_oracle")
    cmd = [sys.executable, "-m", "pointcloud_segmentation_tpu_torch", "run", "--backend",
           "oracle", "--granularity", "4", "--max-frames", "8", "--out", out]
    t0 = time.perf_counter()
    done = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        fail(f"cli run --backend oracle exited {done.returncode}:\n{done.stdout}\n{done.stderr}")
    check(len(read_segments_csv(os.path.join(out, "segments.csv"))) >= 1,
          f"cli run --backend oracle exited 0 in {time.perf_counter() - t0:.1f} s: "
          + done.stdout.splitlines()[0])


def parity_stack(cfg6, cfg4, frames, k6, dev, card, tmp):
    import dataclasses

    t0 = time.perf_counter()
    f64_kernel_checks(dev, frames[len(frames) // 2], card)
    part = frames[G6_PARITY_FRAMES]
    f64_parity("float64 g6 lazy against the oracle",
               dataclasses.replace(cfg6, compute_dtype="float64"), part, "vote_state", card)
    cfg4_64 = dataclasses.replace(cfg4, compute_dtype="float64")
    eng4, ref4 = f64_parity("float64 g4 carry against the oracle", cfg4_64, frames,
                            "vote_histogram", card)
    lazy_equals_carry_f64(cfg4_64, frames, eng4, dev)
    batched_phase(cfg6, frames, k6, dev, card)
    sequential_fusion_phase(cfg6, frames, dev)
    soak_phase(card)
    oracle_backend_phase(ref4, tmp)
    print(f"time  the parity stack's phases: {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)


# ------------------------------------------- sharded execution, deferred read-back

SEG_FIELDS = ("a", "b", "t_min", "t_max", "radius", "points_size", "valid")


def rank_inputs(cfg, frames, dev):
    """The frames as the engine hands them to process_frame: clouds padded
    with NaN rows to max_raw_points, poses in float32, on the rank's card."""
    n_raw = cfg.shapes.max_raw_points
    clouds = np.full((len(frames), n_raw, 3), np.nan, np.float32)
    for i, fr in enumerate(frames):
        k = min(len(fr.points), n_raw)
        clouds[i, :k] = fr.points[:k]
    poss = np.stack([np.asarray(fr.position, np.float32) for fr in frames])
    quats = np.stack([np.asarray(fr.quat_wxyz, np.float32) for fr in frames])
    return tuple(torch.from_numpy(a).to(dev) for a in (clouds, poss, quats))


def rank_tp_replay(cfg, frames, n_dir, dev, kernel):
    """One rank's share of a replay through make_tp_process_frame on a
    1 x n_dir mesh: the world state, each frame's counters and segments, the
    rank's own launches and ms a frame."""
    from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy
    from pointcloud_segmentation_tpu_torch.parallel import make_mesh, make_tp_process_frame
    from pointcloud_segmentation_tpu_torch.worldmap import init_world

    mesh = make_mesh(1, n_dir, dev)
    voting = counted_voting()
    step = make_tp_process_frame(cfg, mesh, voting)
    clouds, poss, quats = rank_inputs(cfg, frames, dev)
    state, counters, segs, ms = init_world(cfg, dev), [], [], []
    for i in range(len(frames)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, out = step(state, clouds[i], poss[i], quats[i])
        counters.append(torch.stack([out.nlines, out.status, out.world_count]).tolist())
        ms.append((time.perf_counter() - t0) * 1e3)
        segs.append({f: getattr(out.segments, f).cpu().numpy() for f in SEG_FIELDS})
    from pointcloud_segmentation_tpu_torch.ops import voting as V

    calls = getattr(voting, kernel).shapes
    launches = getattr(V, kernel).launches
    if launches != sum(calls.values()):
        fail(f"{kernel}: {launches} launches for {sum(calls.values())} calls")
    return {"state": world_state_to_numpy(state), "counters": np.array(counters),
            "segs": {f: np.stack([s[f] for s in segs]) for f in SEG_FIELDS},
            "launches": launches, "shapes": {str(k): v for k, v in calls.items()},
            "ms": ms, "backend": torch.distributed.get_backend(),
            "collectives": 0 if mesh.dir_group is None else mesh.dir_group.collectives}


def rank_mesh_2x2(cfg, frames, dev):
    """make_multichip_step and make_batched_extract on a 2 x 2 mesh."""
    from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy
    from pointcloud_segmentation_tpu_torch.ops import voting as V
    from pointcloud_segmentation_tpu_torch.parallel import (
        make_batched_extract, make_mesh, make_multichip_step)
    from pointcloud_segmentation_tpu_torch.worldmap import init_world

    mesh = make_mesh(2, 2, dev)
    inputs = rank_inputs(cfg, frames, dev)
    V.vote_state.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, nlines, statuses = make_multichip_step(cfg, mesh)(init_world(cfg, dev), *inputs)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    step_launches, V.vote_state.launches = V.vote_state.launches, 0
    segs, nl2, st2 = make_batched_extract(cfg, mesh)(*inputs)
    return {"state": world_state_to_numpy(state), "nlines": nlines.cpu().numpy(),
            "status": statuses.cpu().numpy(), "step_ms": step_ms,
            "segs": {f: getattr(segs, f).cpu().numpy() for f in SEG_FIELDS},
            "extract_nlines": nl2.cpu().numpy(), "extract_status": st2.cpu().numpy(),
            "launches": step_launches, "extract_launches": V.vote_state.launches}


def sharded_rank(rank, dev, jobs):
    """What each spawned rank runs: the jobs in order, by name."""
    out = {}
    for name, kind, kw in jobs:
        if kind == "tp":
            out[name] = rank_tp_replay(dev=dev, **kw)
        elif kind == "mesh":
            out[name] = rank_mesh_2x2(dev=dev, **kw)
        elif kind == "raise" and rank == kw["rank"]:
            raise ZeroDivisionError("a rank that fails on purpose")
        elif kind == "raise":
            torch.distributed.barrier()
    return out


def same_rank_run(got, want, label):
    """One rank's replay against the one-rank run's: world state bit for
    bit, counters and every frame's segments equal."""
    check(same_state(got["state"], want["state"]), f"{label}: world state bit-identical "
          f"to the one-rank run's")
    check(np.array_equal(got["counters"], want["counters"])
          and all(np.array_equal(got["segs"][f], want["segs"][f], equal_nan=True)
                  for f in SEG_FIELDS),
          f"{label}: nlines, status, world count and every frame segment (points_size "
          f"among them) equal on each of {len(got['counters'])} frames")


def shard_phase(cfg6, cfg4, frames, k6, dev, card, sh):
    """parallel.spawn's 1, 2 and 4 ranks on the cards there are.  Ranks that
    outnumber the cards share them over gloo, their collectives copied
    through the host (2 and 4 ranks on one card); ranks with a card each run
    over NCCL (1 rank always; 2 and 4 ranks where there are that many cards).
    Every check is the same under both."""
    from pointcloud_segmentation_tpu_torch.parallel import spawn
    from pointcloud_segmentation_tpu_torch.parallel.sharding import backend_for

    n_cards = torch.cuda.device_count()
    g4_frames = frames[:12]
    tp6 = dict(cfg=cfg6, frames=frames, kernel="vote_state")
    tp4 = dict(cfg=cfg4, frames=g4_frames, kernel="vote_histogram")
    t0 = time.perf_counter()
    one = spawn(sharded_rank, 1, "cuda", args=([
        ("g6", "tp", dict(tp6, n_dir=1)), ("g4", "tp", dict(tp4, n_dir=1))],))[0]
    check(one["g6"]["backend"] == backend_for("cuda", 1) == "nccl",
          "one rank on a 1x1 mesh runs over NCCL")
    check(same_state(one["g6"]["state"], k6["state"]),
          f"1 rank, make_tp_process_frame over {len(frames)} frames: world state "
          f"bit-identical to the g6 replay's")
    check([tuple(c) for c in one["g6"]["counters"]]
          == [(r["nblines"], r["status"], r["seg_vec_size"]) for r in k6["records"]],
          "1 rank: per-frame nlines, status and world count equal the g6 replay's")
    ref4 = replay(cfg4, g4_frames, dev, counted_voting())
    check(same_state(one["g4"]["state"], ref4["state"]),
          "1 rank, g4 carry over 12 frames: world state bit-identical to the g4 replay's")

    two = spawn(sharded_rank, 2, "cuda", args=([
        ("g6", "tp", dict(tp6, n_dir=2)), ("g4", "tp", dict(tp4, n_dir=2))],))
    four = spawn(sharded_rank, 4, "cuda", args=([
        ("g6", "tp", dict(tp6, n_dir=4)),
        ("mesh", "mesh", dict(cfg=cfg6, frames=frames[:8]))],))
    want_backend = "nccl" if n_cards >= 4 else "gloo"
    check(two[0]["g6"]["backend"] == backend_for("cuda", 2)
          and four[0]["g6"]["backend"] == backend_for("cuda", 4) == want_backend,
          f"{n_cards} card(s): 2 ranks run over {two[0]['g6']['backend']}, 4 over "
          f"{four[0]['g6']['backend']}, chosen from the rank and card counts")
    launches = {}
    for n_dir, runs in ((2, two), (4, four)):
        for r, run in enumerate(runs):
            same_rank_run(run["g6"], one["g6"], f"g6, n_dir {n_dir}, rank {r}")
            check(run["g6"]["launches"] > 0,
                  f"g6, n_dir {n_dir}, rank {r} launched vote_state {run['g6']['launches']} "
                  f"times, on every call; by (rows, points) {run['g6']['shapes']}")
        launches[("vote_state", n_dir)] = runs[0]["g6"]["shapes"]
    for r, run in enumerate(two):
        same_rank_run(run["g4"], one["g4"], f"g4 carry, n_dir 2, rank {r}")
        check(run["g4"]["launches"] > 0,
              f"g4, n_dir 2, rank {r} launched vote_histogram {run['g4']['launches']} times, "
              f"on every call; by (rows, points) {run['g4']['shapes']}")
    launches[("vote_histogram", 2)] = two[0]["g4"]["shapes"]

    ref8 = replay(cfg6, frames[:8], dev, counted_voting())
    for r, run in enumerate(four):
        m = run["mesh"]
        check(same_state(m["state"], ref8["state"])
              and m["nlines"].tolist() == [x["nblines"] for x in ref8["records"]]
              and m["status"].tolist() == [x["status"] for x in ref8["records"]],
              f"2x2 mesh, rank {r}: make_multichip_step on 8 frames gives the sequential "
              f"replay's world state bit for bit, nlines and status ({m['launches']} "
              f"vote_state launches)")
        check(all(np.array_equal(m["segs"][f], one["g6"]["segs"][f][:8], equal_nan=True)
                  for f in SEG_FIELDS)
              and np.array_equal(m["extract_nlines"], one["g6"]["counters"][:8, 0])
              and m["launches"] > 0 and m["extract_launches"] > 0,
              f"2x2 mesh, rank {r}: make_batched_extract returns each of the 8 frames' "
              f"segments, equal to the one-rank run's")

    try:
        spawn(sharded_rank, 2, "cuda", args=([("boom", "raise", {"rank": 1})],),
              timeout_s=180.0)
        fail("a rank that raised did not fail parallel.spawn")
    except RuntimeError as e:
        check("rank 1 failed" in str(e) and "ZeroDivisionError" in str(e),
              "a rank that raises fails parallel.spawn in the parent, with its traceback")

    def med(run):
        return statistics.median(run["ms"][5:])

    rounds = one["g6"]["launches"]
    print(f"time  g6 replay through make_tp_process_frame, {len(frames)} frames, median "
          f"ms/frame of rank 0 after 5 warm-up frames: 1 rank {med(one['g6']):.3f}, n_dir 2 "
          f"{med(two[0]['g6']):.3f}, n_dir 4 {med(four[0]['g6']):.3f}; g4 carry, 12 frames: "
          f"1 rank {med(one['g4']):.3f}, n_dir 2 {med(two[0]['g4']):.3f}; 2x2 "
          f"make_multichip_step, 8 frames: {four[0]['mesh']['step_ms'] / 8:.3f} ms/frame. "
          f"{n_cards} card(s): 2 ranks over {two[0]['g6']['backend']}, 4 over "
          f"{four[0]['g6']['backend']}; over gloo the ranks share cards and their words "
          f"go through the host, so that is what sharing costs, not a scaling figure "
          f"[{card}]", flush=True)
    print(f"      collectives of rank 0 over the replay: n_dir 2 {two[0]['g6']['collectives']}, "
          f"n_dir 4 {four[0]['g6']['collectives']} (one a round, one more in a lazy "
          f"incremental round; the one-rank run launched vote_state {rounds} times); g4 "
          f"n_dir 2 {two[0]['g4']['collectives']}", flush=True)
    print(f"time  the sharded phases: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    # launches at the shard shapes, for the kernels line
    for rec in sh.times:
        for (name, n_dir), shapes in launches.items():
            gran = "g6" if name == "vote_state" else "g4"
            if rec["name"] == name and rec["shape"] == SHARD_LABEL.format(gran=gran, n=n_dir):
                rec["launches"] = shapes.get(str((rec["rows"], rec["n"])), 0)
                check(rec["launches"] > 0, f"{name} ran {rec['launches']} times at the "
                      f"{rec['rows']}-row shard shape that the kernel checks held")


def deferred_lockstep(cfg, frames, ref, sync_every, tmp, tag):
    """One lockstep stream with a plain viz stream; returns frames/s."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy

    viz = os.path.join(tmp, f"deferred_{tag}.jsonl")
    voting = counted_voting()
    eng = SegmentationEngine(cfg, voting=voting, viz_stream=viz,
                             stream_sync_every=sync_every)
    label = f"deferred lockstep, stream_sync_every {sync_every}, run {tag}"
    check(eng._stream_deferred == (sync_every > 1), f"{label}: deferred "
          f"{eng._stream_deferred}")
    eng.start()
    t0 = time.perf_counter()
    held = 0
    try:
        for i, fr in enumerate(frames):
            eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
            eng.submit_cloud(fr.t, fr.points)
            if not eng.drain(target_total=i + 1, timeout=120.0):
                fail(f"{label}: frame {i} not accounted for in 120 s")
            held = max(held, sum(r["seg_vec_size"] < 0 for r in list(eng.records)))
    finally:
        wall = time.perf_counter() - t0
        eng.stop()
    launches_of(label, voting)
    eng.finalize(os.path.join(tmp, f"deferred_{tag}"))
    n = len(frames)
    check((eng.frames_processed, eng.dropped_frames, eng.frames_failed) == (n, 0, 0)
          and no_sentinels(eng.records) and eng._flusher is None,
          f"{label}: {n} processed, none dropped; up to {held} records held -1 in "
          f"mid-stream, none after stop()")
    check([(r["seg_vec_size"], r["nblines"]) for r in eng.records]
          == [(r["seg_vec_size"], r["nblines"]) for r in ref["records"]]
          and same_state(world_state_to_numpy(eng.state), ref["state"]),
          f"{label}: seg_vec_size and nblines equal the replay's frame for frame, world "
          f"state bit-identical")
    with open(viz) as f:
        recs = [json.loads(line) for line in f]
    if sync_every > 1:
        check(held > 0 and recs and all(r.get("viz_cadence") == "flush" for r in recs)
              and sum(r["frames_in_batch"] for r in recs) == n
              and all(len(r["cylinders"]) == r["world_count"] for r in recs)
              and set(recs[-1]) == VIZ_KEYS | {"viz_cadence", "frames_in_batch"},
              f"{label}: {len(recs)} flush-cadence viz record(s) covering all {n} frames")
    else:
        check(held == 0 and len(recs) == n and all(set(r) == VIZ_KEYS for r in recs),
              f"{label}: {len(recs)} per-frame viz records, no record ever held -1")
    return eng.frames_processed / wall


def deferred_phase(cfg, frames, ref, log, dev, card, tmp):
    """The deferred read-back on the card against the synchronous one, each
    three times in turn, and the pipelined replay."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy

    t0 = time.perf_counter()
    n = len(frames)
    rates = {64: [], 8: [], 1: []}
    for rep in range(3):
        for sync_every in (64, 8, 1):
            rates[sync_every].append(
                deferred_lockstep(cfg, frames, ref, sync_every, tmp, f"{sync_every}_{rep}"))

    def spread(v):
        return f"median {statistics.median(v):.3f}, {min(v):.3f} to {max(v):.3f}"

    print(f"time  deferred lockstep stream, {n} frames, processed frames/s over 3 runs "
          f"each, in turns: stream_sync_every 64 {spread(rates[64])}; 8 {spread(rates[8])}; "
          f"1 (synchronous) {spread(rates[1])} [{card}]", flush=True)

    shares = {64: [], 1: []}
    fps = {64: [], 1: []}
    for rep in range(3):
        for sync_every in (64, 1):
            label = f"stream at 30 Hz, stream_sync_every {sync_every}, run {rep}"
            voting = counted_voting()
            eng = SegmentationEngine(cfg, voting=voting, stream_sync_every=sync_every)
            s = eng.run_streaming_from_log(log, rate_hz=30.0)
            launches_of(label, voting)
            check(s["drained"] is True and s["fed"] == n == s["processed"] + s["dropped"]
                  + s["skipped"] + s["failed"] and s["failed"] == 0
                  and no_sentinels(eng.records) and len(eng.records) == s["processed"],
                  f"{label}: fed {s['fed']} = {s['processed']} processed + {s['dropped']} "
                  f"dropped; no record holds -1 after stop()")
            shares[sync_every].append(s["dropped"] / s["fed"])
            fps[sync_every].append(s["processed"] / (s["feed_s"] + s["drain_s"]))
    print(f"time  stream at 30 Hz, {n} frames, 3 runs each, in turns: dropped share at "
          f"stream_sync_every 64 {spread(shares[64])}, at 1 {spread(shares[1])}; processed "
          f"frames/s 64 {spread(fps[64])}, 1 {spread(fps[1])} [{card}]", flush=True)

    times = {"pipelined": [], "synchronous": []}
    for pipelined in (False, True, True, False):
        voting = counted_voting()
        eng = SegmentationEngine(cfg, dev, voting=voting)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        recs = eng.run_replay(frames, pipelined=pipelined)
        torch.cuda.synchronize()
        times["pipelined" if pipelined else "synchronous"].append(
            (time.perf_counter() - t1) * 1e3 / n)
        if pipelined:
            launches_of("pipelined g6 replay", voting)
            check([(r["seg_vec_size"], r["nblines"], r["status"]) for r in recs]
                  == [(r["seg_vec_size"], r["nblines"], r["status"]) for r in ref["records"]]
                  and no_sentinels(eng.records)
                  and same_state(world_state_to_numpy(eng.state), ref["state"]),
                  "pipelined replay: records equal the synchronous replay's column for "
                  "column after one read, world state bit-identical")
    p, q = times["pipelined"], times["synchronous"]
    print(f"time  replay g6, {n} frames, whole-replay ms/frame: pipelined "
          f"{sum(p) / 2:.3f}, synchronous {sum(q) / 2:.3f} (sync, pipelined, pipelined, "
          f"sync: {q[0]:.3f} {p[0]:.3f} {p[1]:.3f} {q[1]:.3f}) [{card}]", flush=True)
    print(f"time  the deferred phases: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)


def shard_stack(cfg6, cfg4, frames, k6, dev, card, tmp, sh, log=None):
    from pointcloud_segmentation_tpu_torch.io.replay import save_frames

    if log is None:
        log = os.path.join(tmp, "replay_deferred.pcsl")
        save_frames(log, frames)
    shard_phase(cfg6, cfg4, frames, k6, dev, card, sh)
    deferred_phase(cfg6, frames, k6, log, dev, card, tmp)


def main() -> None:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port on one CUDA card.")
    ap.add_argument("--earlier", metavar="VOTING_CU",
                    help="an earlier csrc/voting.cu whose kernels are timed beside these")
    ap.add_argument("--parity-only", action="store_true",
                    help="the g6 replay and the parity stack's phases only; "
                         "prints no result lines")
    ap.add_argument("--sensor-only", action="store_true",
                    help="the g6 replay and the sensor-data and display phases "
                         "only; prints no result lines")
    ap.add_argument("--shard-only", action="store_true",
                    help="the g6 replay, the kernel checks and the sharded and "
                         "deferred phases only; prints no result lines")
    ap.add_argument("--ranks-only", action="store_true",
                    help="as --shard-only without the deferred phases: on a host "
                         "with 2 or 4 cards the ranks' collectives run over NCCL")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from pointcloud_segmentation_tpu_torch import _build
    from pointcloud_segmentation_tpu_torch.config import default_config
    from pointcloud_segmentation_tpu_torch.io.scene import OBS_TESTS_SCENE, WP_TESTS, trajectory_poses
    from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec
    from pointcloud_segmentation_tpu_torch.ops.hough import KERNELS, PLAIN

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s to build and load "
          f"({_build.BuildInfo.seconds:.2f} s in nvcc) -> {_build.BuildInfo.path}", flush=True)
    for line in _build.BuildInfo.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("ptxas " + line.strip(), flush=True)
    earlier = None
    if args.earlier:
        earlier = _build.load_library(Path(args.earlier).resolve())
        print(f"build: the earlier {args.earlier} -> {_build.BuildInfo.path}", flush=True)

    # the full-size replay: shipped config, default StaticShapes, 64x64 ToF
    poses = trajectory_poses(WP_TESTS, hz=2.0, velocity=0.25)
    frames = frames_of(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.002), 0)
    check(len(frames) == 31, f"{len(frames)} frames in the full-size replay")

    cfg6 = default_config()
    cfg4 = default_config(granularity=4)
    if args.parity_only or args.sensor_only:
        k6, _ = counted_run("g6 replay", cfg6, frames, dev, "vote_state")
        stack = parity_stack if args.parity_only else sensor_stack
        with tempfile.TemporaryDirectory(prefix="pcs_chip_smoke_") as tmp:
            stack(cfg6, cfg4, frames, k6, dev, card, tmp)
        print("one stack only: no result lines", flush=True)
        sys.exit(3)
    if args.shard_only or args.ranks_only:
        sh = kernel_checks(dev, frames[len(frames) // 2], card)
        k6, _ = counted_run("g6 replay", cfg6, frames, dev, "vote_state")
        with tempfile.TemporaryDirectory(prefix="pcs_chip_smoke_") as tmp:
            if args.ranks_only:
                shard_phase(cfg6, cfg4, frames, k6, dev, card, sh)
            else:
                shard_stack(cfg6, cfg4, frames, k6, dev, card, tmp, sh)
        print(json.dumps({"shapes": [r for r in sh.times if "shard" in r["shape"]]}),
              flush=True)
        print("one stack only: no result lines", flush=True)
        sys.exit(3)

    sh = kernel_checks(dev, frames[len(frames) // 2], card, earlier)
    golden_checks(dev)

    cfg6s = default_config(radius_sizes=(0.015,))
    check(cfg6.voting_mode == "lazy" and cfg4.voting_mode == "carry"
          and cfg6s.voting_mode == "lazy" and cfg6s.num_x_max == 261,
          "g6 resolves to lazy voting, g4 to carry; radius 0.015 gives NX 261")

    # the main path, counted path by path: the shipped g6 replay (lazy,
    # vote_state), the g4 replay (carry, vote_histogram), and a short g6
    # replay at radius 0.015 (NX 261)
    k6, n_state = counted_run("g6 replay", cfg6, frames, dev, "vote_state")
    k4, n_hist = counted_run("g4 replay", cfg4, frames, dev, "vote_histogram")
    short = frames[10:15]
    k6s, _ = counted_run("g6 replay at radius 0.015", cfg6s, short, dev, "vote_state")

    for label, run in (("g6", k6), ("g4", k4)):
        statuses = [r["status"] for r in run["records"]]
        check(all(np.isfinite(run["state"][f]).all() for f in ("a", "b", "t_min", "t_max")),
              f"{label}: world state finite ({len(run['segments'])} segments, "
              f"statuses {sorted(set(statuses))})")
        m = beams_matched(run["segments"])
        check(m >= 6, f"{label}: {m} of 7 beams matched")

    p6 = replay(cfg6, frames, dev, PLAIN)
    same_extraction(k6, p6, "g6 kernels vs plain on the card")
    p4 = replay(cfg4, frames, dev, PLAIN)
    same_extraction(k4, p4, "g4 kernels vs plain on the card")
    p6s = replay(cfg6s, short, dev, PLAIN)
    same_extraction(k6s, p6s, "g6 radius 0.015 kernels vs plain on the card")

    k6b = replay(cfg6, frames, dev, KERNELS)
    check(same_state(k6["state"], k6b["state"]),
          "g6 replay run twice: bit-identical world state (deterministic)")

    def ms_per_frame(run):
        return statistics.median(r["processing_time"] for r in run["records"]) / 1e3

    for label, kr, pr, kr2 in (("g6 lazy", k6, p6, k6b), ("g4 carry", k4, p4, None)):
        extra = f", second kernel run {ms_per_frame(kr2):.3f}" if kr2 else ""
        print(f"time  replay {label}, {len(frames)} frames, median ms/frame: kernels "
              f"{ms_per_frame(kr):.3f}{extra}, plain {ms_per_frame(pr):.3f} [{card}]",
              flush=True)

    # the live node loop at the shipped config, on the default device
    with tempfile.TemporaryDirectory(prefix="pcs_chip_smoke_") as tmp:
        log = lockstep_stream(cfg6, frames, k6, tmp, card)
        paced_streams(cfg6, log, len(frames), card)
        serve_phase(cfg6, frames, tmp)
        cli_phase(tmp)
        checkpoint_phase(cfg6, frames, k6, tmp)
        sensor_stack(cfg6, cfg4, frames, k6, dev, card, tmp)
        parity_stack(cfg6, cfg4, frames, k6, dev, card, tmp)
        shard_stack(cfg6, cfg4, frames, k6, dev, card, tmp, sh, log)

    sources = {"vote_state": "tools/exp_g6_pallas.py:156",
               "vote_histogram": "pointcloud_segmentation_tpu/ops/voting_pallas.py:49"}
    main_shape = {"vote_state": "the full g6 table", "vote_histogram": "g4"}
    launches = {"vote_state": n_state, "vote_histogram": n_hist}
    # each timed shape's launches: on its replay of the main path, or (set by
    # shard_phase) on rank 0 of its sharded replay
    paths = {("vote_state", 79): k6["shapes"], ("vote_state", 261): k6s["shapes"],
             ("vote_histogram", 79): k4["shapes"]}
    kernels = []
    for name in ("vote_state", "vote_histogram"):
        shapes = [r for r in sh.times if r["name"] == name]
        for r in shapes:
            key = (r["rows"], r["n"] if r["n"] > 512 else "<= 512")
            r.setdefault("launches", paths.get((name, r["nx"]), {}).get(key, 0))
        head = next(r for r in shapes if r["shape"] == main_shape[name] and r["nx"] == 79)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pointcloud_segmentation_tpu_torch/csrc/voting.cu",
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": sh.errs[name], "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shapes": [{k: r[k] for k in ("shape", "rows", "n", "active", "nx", "launches",
                                          "ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by", "earlier_ms")}
                       for r in shapes]})

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
