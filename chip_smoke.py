"""Smoke run of the PyTorch port on one CUDA card: builds the CUDA sources (the
voting kernels and the conditional nodes of the captured frame, in one nvcc
call), holds each kernel against its plain PyTorch version at every shape
the main path gives it (NX 79 and NX 261) and at edge cases, drives the
replay main path, checks what comes out, and times the kernels beside their
bounds (the benchmark's count, benchmark/roofline).  The main path is the
engine's default on the card: one CUDA graph a frame whose Hough rounds and
update branches are conditional nodes (loop "cond"); it is held frame by
frame against the host-driven engine (loop "eager": the same frame issued
from the host) on the g6, g4, radius-0.015, float64 g6 and mockup replays,
through the batched, pipelined, checkpointed and streamed engine, and
profiled (launches, host reads, conditional nodes, device ms of a frame and
of a dead round, ms/frame of the graph and the host-driven engine in turns).
Then it drives the live node loop at the shipped config on the card: a
lockstep stream through the worker, paced and unpaced streams of a recorded
log, the TCP server, the CLI in subprocesses, and a checkpoint resume, each
held to the synchronous replay or to its own accounting, and each counting
its vote_state launches.  Last the parity stack, on the card with the hand
kernels: the float64 mode against the numpy oracle on the host (g6 lazy on
16 frames, whose oracle runs in a process of its own from the start of the
script, through the host-driven and the cond engine, and g4 carry on the
31-frame replay; both kernels launched, float64 lazy equal to float64
carry), the kernels against their plain versions on the float32 inputs a
float64 frame hands them, batched replay against synchronous, sequential
fusion against vectorised, seeds of tools/parity_soak_torch.py, and the
oracle backend.
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
The node loop runs on the native host runtime (csrc/pcs_runtime.cpp, built
with g++ beside the kernels): the lockstep stream through the C++ mailbox and
pose buffer, bit-identical to the replay, with finalize's C++ CSV writers
byte-equal to the Python ones; the paced streams through the C++ feeder, then
an A/B at 30 Hz of the C++ feeder against the Python one, three runs each in
turns; and a 90 s endurance stream of tools/endurance_torch.py at g6 and 30 Hz,
held to exact accounting and a flat memory floor.  The soak includes one
seed of 128x128 frames, and every base-mode seed (float32 and float64) that
the JAX soak's SOAK.json lists as divergent, compared with that record seed
for seed; the seeds divergent in SOAK_torch.json's card batches (g6 aside)
are traced frame by frame, each b.x the Hough loop refines beside the
oracle's, those divergent on the card alone in float64 too; the four g6 seeds
are read from the witness tools/parity_soak_torch.py --witness-stored stored
in SOAK_torch.json, and the b.x of every refinement where the two sides
agree is summed up beside the knife-edge limit.  The parity stack also holds
the float32 replays (g4 on 31 frames, g6 on the 16 parity frames) against
the oracle runs of the float64 phases: integers exact, endpoints within 5e-3,
the drift's max, median and p90 printed.
Then the structure flights of tools/structure_torch.py: the tower, the
mockup and the dev world's figure eight at g4 and g6 on the kernels, each
held to its record in STRUCTURE_torch.json (which must cover every flight and
granularity on the card, every check holding), the multi-radius flight at
g6, the g6 tower against the plain versions, the g4 flights against the host
oracle (run in processes of their own meanwhile), both kernels against their
plain versions and timed at every shape the flights launch that the table
lacks, and examples/map_a_structure_torch.py in a subprocess.

    python3 chip_smoke.py [--earlier path/to/an/earlier/voting.cu]
                          [--parity-only | --sensor-only | --shard-only |
                           --native-only | --structure-only | --graph-only |
                           --ranks-only]

Needs one CUDA card and nvcc; exits non-zero on any failure.  With
--earlier, the kernels of that source (same C entries) are built too and
timed beside this checkout's at the NX 79 main-path shapes.  With
--parity-only, the kernel table, the golden fixtures and the node loop are
left out (for work on the parity stack; the last lines are printed only by a
whole run); --sensor-only does the same for the sensor-data and display
phases, --shard-only for the sharded and deferred phases, and --native-only
for the node loop's native-runtime phases, the endurance stream, the CLI and
the soak, --structure-only for the structure flights and the g6 float32
drift against the oracle, and --graph-only for the captured frame (cond)
against the host-driven engine.  It prints the
card's name and power limit, one line per check and time, then a JSON line
of the kernels, the card line again, and last the JSON line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import collections
import csv
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

# the voting kernels' bytes, operations and H100 SXM peaks, as the benchmark
# counts them: one count for the kernel table and the ledger's rooflines
from benchmark.roofline import histogram as roofline_histogram
from benchmark.roofline import voting as roofline_voting

REPO = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = roofline_voting.PEAK_BYTES_PER_S
# float32 operations a second outside the tensor cores, an FMA counted as two
PEAK_F32_FLOPS = 2 * roofline_voting.PEAK_LANE_OPS_PER_S
# keys of a viz-stream record of the JAX engine (runtime/engine.py
# _emit_viz_frame), without point clouds
VIZ_KEYS = {"frame", "t", "nlines", "status", "world_count", "cylinders",
            "intersections", "drone"}
CSV_HEADERS = {"segments.csv": "segment,a_x,a_y,a_z,b_x,b_y,b_z,t_min,t_max",
               "intersections.csv": "seg1,t1,seg2,t2",
               "processing_time.csv": "wall_time,processing_time,seg_vec_size,nblines"}
# nodes of the captured g6 frame while the decrement was a chain of PyTorch
# ops over a (20,608, 512) tensor (an H100, tracing off)
CHAIN_GRAPH_NODES_G6 = 7_268
# nodes of the captured frames while each round's gates were a chain of
# ~460 PyTorch ops (an H100, tracing off): the new frames hold at least
# GATES_NODES_SAVED fewer
GATES_CHAIN_GRAPH_NODES = {"g6 lazy": 6_848, "g4 carry": 6_307}
GATES_NODES_SAVED = 3_000
# float32 operations of the gates a point, counted from the chain: two
# distance tests on each active point (22 each), the first fit's count, sum
# and scatter on each of its points (19), and on each inlier the second fit's
# and the covariance's sums and scatters, t, radius and two pn (about 60)
GATES_OPS_ACTIVE, GATES_OPS_FIT, GATES_OPS_INLIER = 44, 19, 60


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
    """(bound ms, "bytes" or "operations") of one voting call, the
    benchmark's count (benchmark/roofline): each input read and each output
    written once, against the float32 operations that bin this call's
    active points."""
    if kind == "vote_state":
        seconds, by = roofline_voting.least_seconds(rows, n, n_active)
    else:
        seconds, by = roofline_histogram.least_seconds(rows, n, n_active, nxs)
    return seconds * 1e3, by


def launcher(lib, name, Xs, act, c1, c2, half, dx, nx, NX):
    """One launch of `name`'s kernel from the library `lib`, with the
    wrapper's outputs and scalars made once: the kernel alone, so that two
    libraries with the same C entries are timed alike."""
    from pointcloud_segmentation_tpu_torch.ops import voting as V

    B, N = c1.shape[0], Xs.shape[0]
    half_dx, nxt, _ = V._launch_args(Xs, half, dx, nx)
    shape = (B,) if name == "vote_state" else (B, NX, NX)
    outs = [torch.empty(shape, dtype=torch.int32, device=Xs.device)
            for _ in range(3 if name == "vote_state" else 1)]
    entry = lib.pcs_vote_state if name == "vote_state" else lib.pcs_vote_histogram
    args = [Xs.data_ptr(), act.data_ptr(), N, c1.data_ptr(), c2.data_ptr(), B,
            half_dx.data_ptr(), nxt.data_ptr(), NX, *(o.data_ptr() for o in outs)]

    def run(keep=(half_dx, nxt, outs)):   # keep: the tensors behind args
        err = entry(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"{name} launch failed: CUDA error {err}")

    return run


def decrement_launcher(lib, Xs, removed, c1, c2, half, dx, nx, NX, key, best):
    """One launch of the decrement kernel from `lib`, its output and
    scalars made once (see `launcher`)."""
    from pointcloud_segmentation_tpu_torch.ops import voting as V

    B, N = c1.shape[0], Xs.shape[0]
    half_dx, nxt, _ = V._launch_args(Xs, half, dx, nx)
    out = torch.empty_like(best)
    args = [Xs.data_ptr(), removed.data_ptr(), N, c1.data_ptr(), c2.data_ptr(), B,
            half_dx.data_ptr(), nxt.data_ptr(), NX, key.data_ptr(), best.data_ptr(),
            out.data_ptr()]

    def run(keep=(half_dx, nxt, out)):     # keep: the tensors behind args
        err = lib.pcs_vote_decrement(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"vote_decrement launch failed: CUDA error {err}")

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
        self.errs = {"vote_state": 0, "vote_histogram": 0, "vote_decrement": 0,
                     "vote_reexam": 0, "round_gates": 0.0}
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

    def decrement(self, label, p, c1, c2, state, removed, timed=False):
        """The decrement kernel against its plain version, with `state`
        (best, key, _) of the table; with `timed`, its kernel ms (CUDA-graph
        replays of the launch alone), plain ms and operations bound."""
        from pointcloud_segmentation_tpu_torch.ops import voting as V

        Xs, _, half, dx, nx, NX = p
        best, key = state[0], state[1]
        k = V.vote_decrement(Xs, removed, c1, c2, half, dx, nx, NX, key, best)
        q = V.vote_decrement_plain(Xs, removed, c1, c2, half, dx, nx, NX, key, best)
        e = max_err(k, q)
        n_rem = int(removed.sum())
        self.errs["vote_decrement"] = max(self.errs["vote_decrement"], e)
        check(e == 0, f"vote_decrement == plain, {label} ({c1.shape[0]} rows, {n_rem} "
                      f"removed of {Xs.shape[0]}, NX {NX}; {int((k < best).sum())} best "
                      f"cells lose votes): max err {e}")
        if not timed:
            return
        ms = graph_ms(decrement_launcher(self.lib, Xs, removed, c1, c2, half, dx, nx, NX,
                                         key, best))
        plain_ms = event_ms(lambda: V.vote_decrement_plain(Xs, removed, c1, c2, half, dx,
                                                           nx, NX, key, best), 3)
        # the decrement's least work: a pair whose x bin rules the key out
        # skips its y bin, so it is the benchmark's binning of both axes
        b_ms = roofline_voting.launch_ops(c1.shape[0], n_rem) \
            / roofline_voting.PEAK_LANE_OPS_PER_S * 1e3
        rec = {"name": "vote_decrement", "shape": label, "rows": c1.shape[0],
               "n": Xs.shape[0], "active": n_rem, "nx": NX, "ms": ms, "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": b_ms, "bound_by": "operations",
               "earlier_ms": None}
        self.times.append(rec)
        print(f"time  vote_decrement, {label} ({c1.shape[0]} rows, N {Xs.shape[0]}, "
              f"{n_rem} removed, NX {NX}): kernel {ms:.4f} ms, bound {b_ms:.5f} ms "
              f"(operations, {b_ms / ms:.1%} of it), plain {plain_ms:.4f} ms, library none "
              f"[{self.card}]", flush=True)

    def gates(self, label, args, nv):
        """The gates kernel's ms on one round (CUDA-graph replays of its
        launch alone), the chain's ms in a graph (what a captured frame paid
        for it), and both bounds: each input read and each output written
        once, and the float32 operations of the chain (GATES_OPS_*)."""
        from pointcloud_segmentation_tpu_torch.ops import gates as G

        Xs, act = args[0], args[2]
        N, n_act, item = Xs.shape[0], int(act.sum()), Xs.element_size()
        ms = graph_ms(gates_launcher(self.lib, args))
        plain_ms = graph_ms(lambda: G.round_gates_plain(*args), reps=5, replays=3)
        b_bytes = (2 * N * 3 * item + 2 * N + 64 * item) / PEAK_BYTES_PER_S * 1e3
        b_ops = (GATES_OPS_ACTIVE * n_act + (GATES_OPS_FIT + GATES_OPS_INLIER) * nv) \
            / PEAK_F32_FLOPS * 1e3
        b_ms, b_by = (b_ops, "operations") if b_ops >= b_bytes else (b_bytes, "bytes")
        rec = {"name": "round_gates", "shape": label, "rows": 1, "n": N, "active": n_act,
               "inliers": nv, "nx": args[-1], "ms": ms, "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "bytes_bound_ms": b_bytes, "operations_bound_ms": b_ops, "earlier_ms": None}
        self.times.append(rec)
        print(f"time  round_gates, {label} (N {N}, {n_act} active, {nv} inliers, NX "
              f"{args[-1]}): kernel {ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}, "
              f"{b_ms / ms:.2%} of it; bytes {b_bytes:.6f}, operations {b_ops:.6f}), plain "
              f"chain {plain_ms:.4f} ms in a graph, library none [{self.card}]", flush=True)

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

        full = sh.state("the full g6 table", p6, c16, c26, timed=timed)
        # the lazy decrement at the removed counts of the main path's rounds
        for n_rem in (37, 300, 512):
            rem = act & (torch.cumsum(act.to(torch.int32), 0) <= n_rem)
            sh.decrement(f"{n_rem} removed points", p6, c16, c26, full, rem, timed=timed)
        for rows in (2048, 256):
            sh.state(f"{rows} gathered rows", p6, *gathered(c16, c26, rows, g), timed=timed)
        removed = act & (torch.rand(act.shape, generator=g).to(dev) < 0.3)
        sh.state("the rebuild (30% of points removed)", p6, c16, c26, active=act & ~removed)

        X4, act4, half4, dx4, nx4, _ = p4
        sh.histogram("g4", p4, c14, c24, timed=timed)
        n_rem = min(512, int(act4.sum()))
        rem = act4 & (torch.cumsum(act4.to(torch.int32), 0) <= n_rem)
        Xr, live = _compact_removed(X4, rem, n_rem, 512)
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
    full = V.vote_state(Xs, act, c16, c26, half, dx, nx, NX)
    sh.decrement("no point removed", p6, c16, c26, full, none)
    sh.decrement("every point removed (staged in chunks)", p6, c16, c26, full, act)
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


def record_gates(cfg, frames, dev) -> list:
    """The arguments of every round's gates over the host-driven kernel replay of
    `frames` at `cfg` (the main path's rounds), each tensor copied."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.ops import gates as G
    from pointcloud_segmentation_tpu_torch.ops import voting as V
    from pointcloud_segmentation_tpu_torch.ops.hough import Voting

    rounds = []

    def record(*args):
        rounds.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return G.round_gates(*args)

    voting = Voting(V.vote_state, V.vote_histogram, V.vote_decrement, record)
    SegmentationEngine(cfg, dev, voting=voting, loop="eager").run_replay(frames)
    return rounds


def gates_gap(k, p) -> tuple:
    """(the exact outputs equal, the largest difference of the float ones)
    of the gates kernel's outputs `k` against the chain's `p`: the inliers,
    their count and the three flags; a_w, bc, the eigenvalues, both
    endpoints a_w + t * bc (which carry t_min and t_max), the radius size
    and the PCA coefficient."""
    exact = all(torch.equal(getattr(k, f), getattr(p, f))
                for f in ("m2", "nv", "ok3", "bx_zero", "accept"))

    def floats(g):
        return torch.cat([g.a_w, g.bc, g.eig, g.a_w + g.t_min * g.bc, g.a_w + g.t_max * g.bc,
                          g.closest.reshape(1), g.pca_coeff.reshape(1)]).double()

    return exact, float((floats(k) - floats(p)).abs().max())


def gates_launcher(lib, args):
    """One launch of the gates kernel from `lib` on a round's `args`, its
    outputs made once: the kernel alone, without the launch counter."""
    from pointcloud_segmentation_tpu_torch.ops import gates as G

    outs = G._outputs(args[0])

    def run(keep=outs):                    # keep: the tensors behind the launch
        err = G._launch(lib, outs, *args)
        if err:
            fail(f"round_gates launch failed: CUDA error {err}")

    return run


def gates_phase(dev, frames, card, sh):
    """The gates kernel against its plain chain on every round of the main
    path's g6 and g4 replays (exact: the inliers, their count and the three
    flags; floats within 5e-3 on the rounds that found a line), then timed
    beside the chain (both in a CUDA graph) at the rounds of median and of
    largest inlier count, with bounds in bytes and in operations."""
    from pointcloud_segmentation_tpu_torch.config import default_config
    from pointcloud_segmentation_tpu_torch.ops import gates as G

    for label, cfg in (("g6", default_config()), ("g4", default_config(granularity=4))):
        rounds = record_gates(cfg, frames, dev)
        worst, bad, nvs = 0.0, [], []
        for k, args in enumerate(rounds):
            got, want = G.round_gates(*args), G.round_gates_plain(*args)
            exact, gap = gates_gap(got, want)
            if not exact:
                bad.append(k)
            if bool(want.ok3):
                worst = max(worst, gap)
            nvs.append(int(want.nv))
        sh.errs["round_gates"] = max(sh.errs["round_gates"], worst)
        n_ok = sum(1 for a in rounds if bool(G.round_gates_plain(*a).ok3))
        check(not bad and worst <= 5e-3,
              f"round_gates == plain chain on every round of the {label} replay "
              f"({len(rounds)} rounds, N {rounds[0][0].shape[0]}, {n_ok} found a line, "
              f"inliers {min(nvs)}-{max(nvs)}): m2, nv, ok3, bx_zero and accept equal "
              f"(rounds that differ {bad}); floats within 5e-3, largest {worst:.3g}")
        order = sorted(range(len(rounds)), key=lambda k: nvs[k])
        for tag, k in (("median", order[len(order) // 2]), ("largest", order[-1])):
            sh.gates(f"{label} replay, the round of {tag} inlier count", rounds[k], nvs[k])


def reexam_phase(dev, frames, card, sh):
    """The re-exam kernel against its plain version on every lazy increment
    of the main path's g6 replay (best, key, ub and the overflow flag exact),
    then timed at the increments of median and of largest suspect count:
    CUDA-graph replays of the state's restore and the launch, less those of
    the restore alone; the bound is the state kernel's over the suspect
    rows."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.config import default_config
    from pointcloud_segmentation_tpu_torch.ops import voting as V
    from pointcloud_segmentation_tpu_torch.ops.hough import Voting

    calls = []

    def record(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return V.vote_reexam(*args)

    SegmentationEngine(default_config(), dev, voting=Voting(
        V.vote_state, V.vote_histogram, vote_reexam=record), loop="eager").run_replay(frames)
    bad, suspects = [], []
    for k, args in enumerate(calls):
        X, a, c1, c2, half, dx, nx, NX, best, key, ub, s_cap, m_lb = args
        outs = []
        for fn in (V.vote_reexam, V.vote_reexam_plain):
            state = [t.clone() for t in (best, key, ub)]
            outs.append(state + [fn(X, a, c1, c2, half, dx, nx, NX, *state, s_cap, m_lb)])
        if not all(torch.equal(x, y) for x, y in zip(*outs)):
            bad.append(k)
        suspects.append(int((ub >= best.max()).sum()))
    sh.errs["vote_reexam"] = len(bad)
    check(not bad and max(suspects) > 0,
          f"vote_reexam == plain on every lazy increment of the g6 replay ({len(calls)} "
          f"re-exams, {calls[0][8].shape[0]} rows, suspects {min(suspects)}-"
          f"{max(suspects)}, {sum(n > calls[0][11] for n in suspects)} past the cap of "
          f"{calls[0][11]}): best, key, ub and the overflow flag equal (calls that "
          f"differ {bad})")
    order = sorted(range(len(calls)), key=lambda k: suspects[k])
    for tag, k in (("median", order[len(order) // 2]), ("largest", order[-1])):
        X, a, c1, c2, half, dx, nx, NX, best, key, ub, s_cap, m_lb = calls[k]
        state = [t.clone() for t in (best, key, ub)]

        def restore():
            for t, t0 in zip(state, (best, key, ub)):
                t.copy_(t0)

        def restore_and_launch():
            restore()
            V.vote_reexam(X, a, c1, c2, half, dx, nx, NX, *state, s_cap, m_lb)

        ms = graph_ms(restore_and_launch) - graph_ms(restore)
        plain_ms = event_ms(lambda: V.vote_reexam_plain(X, a, c1, c2, half, dx, nx, NX,
                                                        *[t.clone() for t in state], s_cap,
                                                        m_lb), 3)
        n, n_act = suspects[k], int(a.sum())
        b_ms, b_by = bound("vote_state", X.shape[0], n_act, max(n, 1), NX)
        label = f"g6 replay, the increment of {tag} suspect count"
        sh.times.append({"name": "vote_reexam", "shape": label, "rows": n, "n": X.shape[0],
                         "active": n_act, "nx": NX, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                         "earlier_ms": None})
        print(f"time  vote_reexam, {label} ({c1.shape[0]} rows, {n} suspect, N "
              f"{X.shape[0]}, {n_act} active, NX {NX}): kernel {ms:.4f} ms (restore "
              f"and launch less restore, in a graph), bound {b_ms:.5f} ms ({b_by}, "
              f"{b_ms / ms:.1%} of it), plain {plain_ms:.4f} ms, library none [{card}]",
              flush=True)


TOF224 = (224, 172)          # the drone's own ToF, 38,528 returns a frame


def voxel_problem(points, cfg, dev, dtype):
    """The voxel sums' inputs from one frame padded to max_raw_points: the
    sorted keys, the points in their order and the key limit."""
    from pointcloud_segmentation_tpu_torch.ops.preproc import (_grid_constants, voxel_keys,
                                                               window_mask)

    raw = np.full((cfg.shapes.max_raw_points, 3), np.nan)
    raw[: len(points)] = points
    pts = torch.from_numpy(raw).to(dev, dtype)
    keys = voxel_keys(pts, window_mask(pts, cfg.window_size), cfg)
    keys_s, order = torch.sort(keys, stable=True)
    return keys_s, pts[order].contiguous(), _grid_constants(cfg)[2] ** 3


def onehot_sums(keys_s, pts_s, n_out, key_limit):
    """The voxel sums as the port made them before pcs_voxel_sums: a dense
    (n_out, N) one-hot product (timed as the yardstick, never on a path)."""
    valid_s = keys_s < key_limit
    isnew = torch.ones_like(valid_s)
    isnew[1:] = keys_s[1:] != keys_s[:-1]
    first = isnew & valid_s
    group = torch.where(valid_s, torch.cumsum(first.int(), 0, dtype=torch.int32) - 1, n_out)
    onehot = (group[None, :] == torch.arange(n_out, dtype=torch.int32,
                                             device=keys_s.device)[:, None]).to(pts_s.dtype)
    pts = torch.where(valid_s[:, None], pts_s, 0.0)
    return onehot @ pts, onehot.sum(dim=1)


def voxel_phase(dev, frames64, frames224, card):
    """pcs_voxel_sums against its plain version (on the host) on every frame
    of the 64x64 replay at (4,096 x 8,192) and of the 224x172 flight at
    (8,192 x 38,528), float32, and on 4 frames of each in float64: bit for
    bit, the dropped voxels counted; then timed at the frame of most voxels
    beside its bound (benchmark/roofline/voxel.py), its plain version and
    the one-hot product it replaced."""
    from pointcloud_segmentation_tpu_torch.config import StaticShapes, default_config
    from pointcloud_segmentation_tpu_torch.ops import preproc as P

    from benchmark.roofline import voxel as roofline_voxel

    for label, frames, (n_raw, n_out) in (("64x64", frames64, (8192, 4096)),
                                          ("224x172", frames224, (38_528, 8192))):
        cfg = default_config(shapes=StaticShapes(max_raw_points=n_raw, max_points=n_out))
        bad, counts = [], []
        for k, fr in enumerate(frames):
            for dtype in (torch.float32, torch.float64) if k % 8 == 0 else (torch.float32,):
                keys_s, pts_s, lim = voxel_problem(fr.points, cfg, dev, dtype)
                got = P.voxel_sums(keys_s, pts_s, n_out, lim)
                *want, over = P.voxel_sums_plain(keys_s.cpu(), pts_s.cpu(), n_out, lim)
                if over or not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
                    bad.append((k, str(dtype)))
                if dtype == torch.float32:
                    counts.append(int(want[2]))
        check(not bad, f"voxel_sums == plain on every {label} frame ({len(frames)} frames, "
                       f"({n_out:,} x {n_raw:,}), voxels {min(counts)}-{max(counts)}, "
                       f"float32 and float64 on every 8th): centroids, valid and count "
                       f"bit for bit, none dropped (frames that differ {bad})")
        fr = frames[max(range(len(frames)), key=counts.__getitem__)]
        keys_s, pts_s, lim = voxel_problem(fr.points, cfg, dev, torch.float32)
        ms = graph_ms(lambda: P.voxel_sums(keys_s, pts_s, n_out, lim))
        plain_ms = event_ms(lambda: P.voxel_sums_plain(keys_s, pts_s, n_out, lim), 3)
        onehot_ms = event_ms(lambda: onehot_sums(keys_s, pts_s, n_out, lim), 3)
        b_ms = roofline_voxel.least_seconds(n_raw, n_out) * 1e3
        print(f"time  voxel_sums, {label} frame of {max(counts)} voxels ({n_out:,} x "
              f"{n_raw:,}): kernel {ms:.4f} ms (two launches, in a graph), bound "
              f"{b_ms:.5f} ms (bytes, {b_ms / ms:.1%} of it), plain {plain_ms:.4f} ms, "
              f"the one-hot product it replaced {onehot_ms:.4f} ms [{card}]", flush=True)
    keys_s, pts_s, lim = voxel_problem(frames224[0].points, cfg, dev, torch.float32)
    V0 = P.voxel_overflow()
    P.voxel_sums(keys_s, pts_s, 64, lim)
    *_, over = P.voxel_sums_plain(keys_s.cpu(), pts_s.cpu(), 64, lim)
    check(P.voxel_overflow() - V0 == over > 0,
          f"voxel_sums at 64 voxels drops {over} and counts them on the card")


def tof224_phase(dev, frames224, card):
    """The 7-beam flight seen by the 224x172 sensor, sized by the
    configuration's keys (max_raw_points 38,528, max_points 8,192): the
    lazy voting and gates kernels against their plain versions on every
    call of a host-driven replay; the captured frame against the
    host-driven engine frame by frame; no cloud cut, no voxel dropped; the
    graph's nodes and ms/frame."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.config import PipelineConfig
    from pointcloud_segmentation_tpu_torch.ops import gates as G
    from pointcloud_segmentation_tpu_torch.ops import voting as V
    from pointcloud_segmentation_tpu_torch.ops.hough import Voting
    from pointcloud_segmentation_tpu_torch.ops.preproc import voxel_overflow

    cfg = PipelineConfig.from_dict({"max_raw_points": 38_528, "max_points": 8192})
    calls = {"state": [], "decrement": [], "reexam": [], "gates": []}

    def recorder(name, fn):
        def record(*args):
            calls[name].append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return fn(*args)
        return record

    voting = Voting(recorder("state", V.vote_state), V.vote_histogram,
                    recorder("decrement", V.vote_decrement), recorder("gates", G.round_gates),
                    recorder("reexam", V.vote_reexam))
    V.reset_counts()
    eager = SegmentationEngine(cfg, dev, voting=voting, loop="eager")
    eager.run_replay(frames224)
    active = [int(a[1].sum()) for a in calls["state"]]
    bad = {name: [] for name in calls}
    for k, args in enumerate(calls["state"]):
        if not all(torch.equal(x, y) for x, y in zip(V.vote_state(*args),
                                                      V.vote_state_plain(*args))):
            bad["state"].append(k)
    for k, args in enumerate(calls["decrement"]):
        if not torch.equal(V.vote_decrement(*args[:10]), V.vote_decrement_plain(*args[:10])):
            bad["decrement"].append(k)
    for k, args in enumerate(calls["reexam"]):
        X, a, c1, c2, half, dx, nx, NX, best, key, ub, s_cap, m_lb = args
        outs = []
        for fn in (V.vote_reexam, V.vote_reexam_plain):
            state = [t.clone() for t in (best, key, ub)]
            outs.append(state + [fn(X, a, c1, c2, half, dx, nx, NX, *state, s_cap, m_lb)])
        if not all(torch.equal(x, y) for x, y in zip(*outs)):
            bad["reexam"].append(k)
    worst = 0.0
    for k, args in enumerate(calls["gates"]):
        got, want = G.round_gates(*args), G.round_gates_plain(*args)
        exact, gap = gates_gap(got, want)
        if not exact:
            bad["gates"].append(k)
        if bool(want.ok3):                 # a round that found a line
            worst = max(worst, gap)
    check(not any(bad.values()) and worst <= 5e-3 and max(active) > 4096,
          f"224x172 flight ({len(frames224)} frames): vote_state ({len(calls['state'])} calls, "
          f"{min(active)}-{max(active)} active of 8,192), vote_decrement "
          f"({len(calls['decrement'])}), vote_reexam ({len(calls['reexam'])}) == plain bit for "
          f"bit, round_gates ({len(calls['gates'])}) flags exact, floats within 5e-3 (largest "
          f"{worst:.3g}); calls that differ {bad}")
    check(eager.raw_truncated == 0 and voxel_overflow() == 0,
          "224x172 flight: no cloud cut (engine.raw_truncated 0), no voxel dropped "
          "(preproc.voxel_overflow 0)")
    lockstep_loops("224x172 flight", cfg, frames224, dev)
    ms, engs = {}, {}
    for loop in ("cond", "eager"):
        engs[loop] = SegmentationEngine(cfg, dev, loop=loop)
        ms[loop] = statistics.median(r["processing_time"] / 1e3
                                     for r in engs[loop].run_replay(frames224))
    cap = engs["cond"]._step.captures[0]
    print(f"time  224x172 flight, {len(frames224)} frames, median ms/frame: cond step "
          f"{ms['cond']:.3f}, host-driven {ms['eager']:.3f}; captured frame "
          f"{cap['graph_nodes']} nodes, {cap['cond_nodes']} conditional, pool "
          f"{cap['pool_bytes']} B [{card}]", flush=True)


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


def replay(cfg, frames, dev, voting, per_frame=False, loop=None):
    """One engine (`loop`, or its default loop for `voting`) over the frames:
    records, world segments and state at the end, the engine, and with
    `per_frame` the world state after each frame and the decrement's and
    the gates' launches issued so far after each frame."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy
    from pointcloud_segmentation_tpu_torch.ops import voting as V

    eng = SegmentationEngine(cfg, dev, voting=voting, loop=loop)
    if per_frame:
        recs, states, decrements, gates = [], [], [], []
        for fr in frames:
            recs += eng.run_replay([fr])
            states.append(world_state_to_numpy(eng.state))
            decrements.append(V.vote_decrement.launches)
            gates.append(V.round_gates.launches)
    else:
        recs = eng.run_replay(frames)
    torch.cuda.synchronize()
    out = {"records": recs, "segments": eng.world_segments(),
           "state": world_state_to_numpy(eng.state), "engine": eng}
    if per_frame:
        out["states"], out["decrements"], out["gates"] = states, decrements, gates
    return out


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
    V.vote_decrement.launches = 0
    V.round_gates.launches = 0
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


def counted_run(label, cfg, frames, dev, name, per_frame=False):
    """One path of the main path on the host-driven engine, its kernel's launch
    count set to 0 just before and read just after; returns (run,
    launches).  The run keeps its calls by (rows, points) under "shapes"."""
    from pointcloud_segmentation_tpu_torch.ops import voting as V

    voting = counted_voting()
    run = replay(cfg, frames, dev, voting, per_frame)
    n = launches_of(label, voting, name)
    run["shapes"] = dict(getattr(voting, name).shapes)
    run["decrement_launches"] = V.vote_decrement.launches    # one an increment round
    run["gates_launches"] = V.round_gates.launches           # one a live round
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
    check(on_native_runtime(eng), "lockstep stream: the engine's mailbox and pose buffer "
                                  "are the native runtime's")
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
    native_csvs_equal_python(eng, os.path.join(tmp, "lockstep"), "lockstep stream")
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


def on_native_runtime(eng) -> bool:
    from pointcloud_segmentation_tpu_torch import native

    return (isinstance(eng.mailbox, native.NativeMailbox)
            and isinstance(eng.poses, native.NativePoseBuffer))


def native_csvs_equal_python(eng, outdir, label):
    """finalize's CSVs (the native writers) against the Python csvio
    writers on the same rows, byte for byte."""
    from pointcloud_segmentation_tpu_torch.runtime import csvio

    paths = eng.finalize(outdir)
    segs, inter = eng.world_snapshot()
    rows = {"segments": (csvio.write_segments_csv, segs),
            "intersections": (csvio.write_intersections_csv, inter),
            "processing_time": (csvio.write_processing_time_csv, eng.records)}
    for name, (write, data) in rows.items():
        mine = paths[name] + ".python"
        write(mine, data)
        with open(paths[name], "rb") as a, open(mine, "rb") as b:
            check(a.read() == b.read(), f"{label}: finalize's native {name}.csv is "
                  f"byte-equal to csvio's on the same {len(data)} rows")


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
        check(on_native_runtime(eng), f"{label}: fed by the native feeder into the native "
                                      f"mailbox and pose buffer")
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


def feeder_ab(cfg, log, n, card):
    """run_streaming_from_log at 30 Hz fed by the native (C++) feeder and by
    the Python one, three runs each in turns, native first.  The Python runs
    put the Python mailbox and pose buffer in a fresh engine before the call,
    which then paces the feed from its own thread."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.runtime.mailbox import LatestWinsMailbox
    from pointcloud_segmentation_tpu_torch.runtime.posebuffer import PoseBuffer

    runs = {"native": [], "python": []}
    for rep in range(3):
        for feeder in ("native", "python"):
            label = f"stream at 30 Hz, {feeder} feeder, run {rep}"
            voting = counted_voting()
            eng = SegmentationEngine(cfg, voting=voting)
            if feeder == "python":
                eng.mailbox, eng.poses = LatestWinsMailbox(), PoseBuffer()
            check(on_native_runtime(eng) == (feeder == "native"),
                  f"{label}: {feeder} mailbox and pose buffer")
            eng.pop_stall_max()
            s = eng.run_streaming_from_log(log, rate_hz=30.0)
            launches_of(label, voting)
            check(s["drained"] is True and s["fed"] == n == s["processed"] + s["dropped"]
                  + s["skipped"] + s["failed"] and s["failed"] == 0
                  and s["dropped"] == eng.dropped_frames and no_sentinels(eng.records),
                  f"{label}: fed {s['fed']} = {s['processed']} processed + {s['dropped']} "
                  f"dropped + {s['skipped']} skipped + {s['failed']} failed")
            runs[feeder].append(dict(s, step_ms=eng.pop_stall_max()["step_ms"]))

    def each_run(key, fmt="{:.3f}"):
        return {f: " ".join(fmt.format(key(r)) for r in rs) for f, rs in runs.items()}

    feed = each_run(lambda r: r["feed_s"])
    fps = each_run(lambda r: r["processed"] / (r["feed_s"] + r["drain_s"]))
    share = each_run(lambda r: r["dropped"] / r["fed"])
    step = each_run(lambda r: r["step_ms"], "{:.1f}")
    for f in runs:
        print(f"time  stream at 30 Hz, {n} frames, {f} feeder, runs 0-2 in turns: feed_s "
              f"{feed[f]} (the schedule is {n / 30:.3f} s), processed frames/s {fps[f]}, "
              f"dropped share {share[f]}, max step ms {step[f]} [{card}]", flush=True)


def endurance_phase(card):
    """tools/endurance_torch.py at g6 and 30 Hz for 90 s in windows of 10 s,
    on the card, through the native feeder: every frame accounted for, none
    failed, the memory floor flat, vote_state launched."""
    from pointcloud_segmentation_tpu_torch.ops import voting as V

    spec = importlib.util.spec_from_file_location(
        "endurance_torch", REPO / "tools" / "endurance_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    V.reset_counts()
    s = tool.run(minutes=1.5, rate_hz=30.0, granularity=6, device="cuda", window_s=10.0)
    launches = V.ran_launches(V.vote_state)
    check(launches > 0, f"endurance: vote_state ran {launches} times (the engine's default "
                        f"loop, its launches in conditional nodes counted where they ran)")
    check(s["native_runtime"] and s["accounted"] and s["failed"] == 0,
          f"endurance: fed {s['fed']} = {s['processed']} processed + {s['dropped']} dropped "
          f"+ {s['skipped']} skipped + {s['failed']} failed, drained {s['drained']}")
    check(s["windows"] >= 8, f"endurance: {s['windows']} windows of 10 s")
    check(not s["leaked"], f"endurance: memory floor flat, RSS minima "
          f"{s['rss_mb_min_first_half']} MB (first half) and {s['rss_mb_min_last_half']} "
          f"MB (second half)")
    w = s["windows_detail"]
    print(f"time  endurance, 90 s at 30 Hz, g6, {s['windows']} windows of 10 s: verdict "
          f"degraded {s['degraded']}, leaked {s['leaked']} (degraded is not gated at this "
          f"length); median {s['median_processed_per_sec']} processed frames/s (min "
          f"{s['min_processed_per_sec']}, max {s['max_processed_per_sec']}), dropped share "
          f"{s['drop_fraction_overall']}, RSS floor {s['rss_mb_min_first_half']} / "
          f"{s['rss_mb_min_last_half']} MB by half, cuda memory_allocated "
          f"{w[0]['cuda_allocated_mb']} MB in the first window and {w[-1]['cuda_allocated_mb']} "
          f"in the last, max step ms {max(c['max_step_ms'] for c in w)}, max flush read ms "
          f"{max(c['max_flush_read_ms'] for c in w)}, {s['world_segments_final']} world "
          f"segments at the end [{card}]", flush=True)


def native_stack(cfg, frames, ref, tmp, card):
    """The node loop's streams on the native runtime, then the endurance
    stream; returns the recorded log."""
    t0 = time.perf_counter()
    log = lockstep_stream(cfg, frames, ref, tmp, card)
    paced_streams(cfg, log, len(frames), card)
    feeder_ab(cfg, log, len(frames), card)
    endurance_phase(card)
    print(f"time  the native-runtime and endurance phases: {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    return log


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


def cli_phase(tmp, card):
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
    with open(os.path.join(stream_out, "processing_time.csv")) as f:
        ms = [float(r["processing_time"]) / 1e3 for r in csv.DictReader(f)]
    print(f"time  cli stream, a fresh process at 30 Hz: the first record's processing_time "
          f"{ms[0]:.3f} ms, the median of its {len(ms)} records {statistics.median(ms):.3f} ms "
          f"[{card}]", flush=True)


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


# ------------------------------------------------ the captured frame's loops

# the engine's two loops, each with its label in the printouts: one CUDA
# graph a frame, and the same frame issued from the host
LOOP_LABEL = {"cond": "graph", "eager": "host-driven"}
LOOPS_TIMED = tuple(LOOP_LABEL)
LOOP_REPEATS = 5        # interleaved replays of each loop for ms/frame
LOOP_TIMED = slice(8, 24)    # the frames of each timed replay, in mid-flight


def lockstep_loops(label, cfg, frames, dev, keep=False):
    """The cond engine (the card's default) and the host-driven engine side
    by side, frame by frame: each frame's record (world count, nlines, status)
    and the world state after it bit-equal.  With `keep`, returns the cond
    engine's per-frame (record, snapshot)."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy

    engs = {"cond": SegmentationEngine(cfg, dev),
            "eager": SegmentationEngine(cfg, dev, loop="eager")}
    check([e.loop for e in engs.values()] == list(engs),
          f"{label}: the engine's default on the card is the cond step")
    bad, kept = {"cond": []}, []
    for k, fr in enumerate(frames):
        recs, states = {}, {}
        for loop, eng in engs.items():
            eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
            r = eng.process_frame(fr.t, fr.points)
            recs[loop] = (r["seg_vec_size"], r["nblines"], r["status"])
            states[loop] = world_state_to_numpy(eng.state)
            if keep and loop == "cond":
                kept.append((r, eng.world_snapshot()))
        for loop in bad:
            if recs[loop] != recs["eager"] or not same_state(states[loop], states["eager"]):
                bad[loop].append(k)
    for loop in bad:
        step = engs[loop]._step
        check(not bad[loop] and step.replays == len(frames) and len(step.captures) == 1,
              f"{label}: {loop} engine == host-driven engine on every frame ({len(frames)} frames: "
              f"records and world state bit for bit; frames that differ {bad[loop]}), one "
              f"capture, {step.replays} replays")
    return kept


def loop_counts(fn) -> tuple:
    """fn's launches since reset_counts(): (captured, ran)."""
    from pointcloud_segmentation_tpu_torch.ops import voting as V

    return fn.launches, V.ran_launches(fn)


def main_path(cfg6, cfg4, frames, dev, k6, k4, card):
    """The main path as a user drives it: the engine's default on the card,
    one CUDA graph a frame whose Hough rounds and branches are conditional
    nodes, over the g6 lazy and g4 carry replays, every count set to 0 just
    before each and read just after.  Each frame's record and world state
    is held bit for bit against the host-driven engine's (k6, k4: counted runs
    with per-frame states).  Returns ({label: {loop: run}}, {kernel:
    (captured, ran)} of the cond replays)."""
    from pointcloud_segmentation_tpu_torch.ops import voting as V
    from pointcloud_segmentation_tpu_torch.ops.hough import KERNELS, round_count

    runs, launches = {}, {}
    for label, name, cfg, eager in (("g6 lazy", "vote_state", cfg6, k6),
                                    ("g4 carry", "vote_histogram", cfg4, k4)):
        runs[label] = {"eager": eager}
        V.reset_counts()
        run = replay(cfg, frames, dev, KERNELS, per_frame=True)
        fn = getattr(V, name)
        captured, ran = launches[name] = loop_counts(fn)
        other = V.vote_histogram if fn is V.vote_state else V.vote_state
        print(f"launches, {label} replay through the cond step: {name} {captured} "
              f"captured (once a replay), {ran} ran, each of which voted; "
              f"{other.__name__} {loop_counts(other)}", flush=True)
        eng = run["engine"]
        step = eng._step
        check(eng.loop == "cond" and step.replays == len(frames) and len(step.captures) == 1,
              f"{label} replay: the cond step (the engine's default on the card), one "
              f"capture and {step.replays} replays")
        check(0 < ran < captured,
              f"{label} replay through the cond step: {name} ran (and voted) in {ran} of "
              f"the {captured} launches its graphs hold")
        if name == "vote_state":
            # the capture's warm-up runs frame 0 on the card once more
            dec_captured, dec_ran = launches["vote_decrement"] = loop_counts(V.vote_decrement)
            n_inc, first = eager["decrement_launches"], eager["decrements"][0]
            check(0 < dec_ran == n_inc + first < dec_captured,
                  f"{label} replay through the cond step: vote_decrement ran in {dec_ran} of "
                  f"the {dec_captured} launches its graphs hold: the host-driven replay's {n_inc} "
                  f"increment rounds and frame 0's {first} again in the capture's warm-up")
            # one re-exam an increment round, after its decrement
            rx_captured, rx_ran = launches["vote_reexam"] = loop_counts(V.vote_reexam)
            check(rx_ran == dec_ran < rx_captured,
                  f"{label} replay through the cond step: vote_reexam ran in {rx_ran} of "
                  f"the {rx_captured} launches its graphs hold, once a decrement; "
                  f"{V.reexamined_rows()} rows re-examined")
        # one gates launch a live round, each of which ran
        gates_captured, gates_ran = loop_counts(V.round_gates)
        launches[f"round_gates {label}"] = (gates_captured, gates_ran)
        n_rounds, first = eager["gates_launches"], eager["gates"][0]
        check(0 < gates_ran == n_rounds + first < gates_captured,
              f"{label} replay through the cond step: round_gates ran in {gates_ran} of the "
              f"{gates_captured} launches its graphs hold: the host-driven replay's {n_rounds} "
              f"rounds and frame 0's {first} again in the capture's warm-up")
        bad = [k for k, (r, e, a, b) in enumerate(zip(run["records"], eager["records"],
                                                       run["states"], eager["states"]))
               if (r["seg_vec_size"], r["nblines"]) != (e["seg_vec_size"], e["nblines"])
               or not same_state(a, b)]
        check(len(run["records"]) == len(eager["records"]) == len(frames) and not bad,
              f"cond {label}: cond engine == host-driven engine on every frame ({len(frames)} "
              f"frames: records and world state bit for bit; frames that differ {bad})")
        cap = step.captures[0]
        print(f"time  cond {label}: capture {cap['seconds']:.3f} s (warm-up frame, thrown-"
              f"away capture and capture), the graph's pool {cap['pool_bytes'] / 2**20:.1f} "
              f"MiB of memory_reserved ({cap['reserved_after'] / 2**20:.1f} MiB reserved "
              f"after the capture), {round_count(cfg)} rounds a frame, {cap['cond_nodes']} "
              f"conditional nodes [{card}]", flush=True)
        check(cap["cond_nodes"] > round_count(cfg),
              f"{label}: the cond graph holds a node a round and more for the branches")
        chain = (f", {CHAIN_GRAPH_NODES_G6:,} with the decrement as a chain of ops"
                 if name == "vote_state" else "")
        before = GATES_CHAIN_GRAPH_NODES[label]
        check(cap["graph_nodes"] <= before - GATES_NODES_SAVED,
              f"cond {label}: the captured frame holds {cap['graph_nodes']:,} graph nodes, its "
              f"bodies' included ({before:,} with the gates as a chain of ops{chain})")
        runs[label]["cond"] = run
    return runs, launches


def profile_frame(eng, fr) -> dict:
    """One frame of `eng` under torch.profiler: launch counts
    (cli.launch_counts), the kernels' device ms (those inside a replayed
    graph included) and wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pointcloud_segmentation_tpu_torch.cli import launch_counts

    eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.process_frame(fr.t, fr.points)
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    out = launch_counts(events)
    kernels = sorted(((getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)) / 1e3, e.count, e.key)
                      for e in events if e.device_type == DeviceType.CUDA), reverse=True)
    out["device_ms"] = sum(ms for ms, _, _ in kernels)
    out["top"] = kernels[:5]          # (device ms, launches, kernel name)
    out["wall_ms"] = wall
    return out


def loop_phase(cfg6, cfg4, frames, dev, card, tmp, runs, k6s):
    """The cond step (pipeline.make_process_frame_packed, the engine's
    default on the card) against the host-driven engine, beyond the main
    path's g6 and g4 replays (`runs`, from main_path): bit for bit on the
    radius-0.015 frames (against `k6s`, the host-driven replay of them), the float64 g6 parity frames and the mockup
    flight at g4 (held to its record); the batched and pipelined replays, a
    checkpoint resume and a lockstep and an unpaced stream through the cond
    engine; the launches, host reads and device time of one frame each way
    and of a frame whose every round is dead; ms/frame in turns.  Returns
    the cond engine's per-frame (record, snapshot) on the float64 parity
    frames, which the parity stack holds against the oracle."""
    import dataclasses

    from pointcloud_segmentation_tpu_torch import SegmentationEngine
    from pointcloud_segmentation_tpu_torch.config import default_config
    from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy
    from pointcloud_segmentation_tpu_torch.io.replay import save_frames
    from pointcloud_segmentation_tpu_torch.ops.hough import KERNELS, round_count

    t_phase = time.perf_counter()
    cfg6s = default_config(radius_sizes=(0.015,))
    short = frames[10:15]
    run = replay(cfg6s, short, dev, KERNELS, per_frame=True)
    check(run["engine"].loop == "cond"
          and [(r["nblines"], r["status"]) for r in run["records"]]
          == [(r["nblines"], r["status"]) for r in k6s["records"]]
          and all(same_state(a, b) for a, b in zip(run["states"], k6s["states"])),
          "cond g6 radius 0.015, frames 10-14: cond engine == host-driven engine on every frame "
          "(records and world state bit for bit)")
    part = frames[G6_PARITY_FRAMES]
    f64_cond = lockstep_loops(f"float64 g6, frames {G6_PARITY_FRAMES.start}-"
                              f"{G6_PARITY_FRAMES.stop - 1}",
                              dataclasses.replace(cfg6, compute_dtype="float64"), part, dev,
                              keep=True)

    # the mockup flight at g4 on both loops, the cond flight against the
    # host-driven one and held to its record
    st = load_structure()
    recs = structure_records(st)
    scene, mframes = st.flight_frames("mockup")
    mcfg = st.flight_config("mockup", 4)
    flown = {loop: st.fly(mcfg, scene, mframes, device=dev, loop=loop)
             for loop in LOOPS_TIMED}
    cmp = st.compare(flown["cond"], flown["eager"], len(mframes), False)
    check(cmp["frame_integers_equal"] and cmp["world_equal"]
          and cmp["drift"]["max"] == 0.0
          and flown["cond"]["endpoints_by_frame"] == flown["eager"]["endpoints_by_frame"],
          f"cond mockup g4: per-frame integers and every frame's world endpoints equal "
          f"the host-driven flight's ({len(mframes)} frames)")
    rec = recs[("mockup", 4)]
    held_to_record("cond mockup g4", flown["cond"], rec)
    # against the record's oracle side: the same segment beyond the
    # tolerance, by the same error, as the structure phase's known line
    cmp = st.compare(flown["cond"], rec["oracle"], len(mframes), True)
    recorded = rec["card_vs_oracle"]["beyond"]
    check([b["segment"] for b in cmp["beyond"]] == [b["segment"] for b in recorded]
          and all(abs(b["error"] - c["error"]) <= 1e-9
                  for b, c in zip(cmp["beyond"], recorded)),
          "cond mockup g4 against the record's oracle: the endpoints beyond "
          f"{st.ENDPOINT_TOL} are the record's")
    known_failure("cond mockup g4 against the record's oracle",
                  f"card_vs_oracle: endpoints within {st.ENDPOINT_TOL}", cmp["beyond"])

    # the batched and pipelined replays, a checkpoint resume and the streams
    # through the cond engine, each against the host-driven g6 replay
    ref = runs["g6 lazy"]["eager"]
    want = ref["state"]
    for kw in ({"batch": 4}, {"pipelined": True}):
        eng = SegmentationEngine(cfg6, dev)
        recs = eng.run_replay(frames, **kw)
        check(eng.loop == "cond" and eng._step.replays == len(frames)
              and [(r["seg_vec_size"], r["nblines"]) for r in recs]
              == [(r["seg_vec_size"], r["nblines"]) for r in ref["records"]]
              and same_state(world_state_to_numpy(eng.state), want),
              f"cond run_replay({', '.join(f'{k}={v}' for k, v in kw.items())}): "
              f"{eng._step.replays} replays, records and world state equal the host-driven "
              f"replay's")
    ckpt = os.path.join(tmp, "cond_state.npz")
    first = SegmentationEngine(cfg6, dev)
    first.run_replay(frames[:15])
    first.save_checkpoint(ckpt)
    resumed = SegmentationEngine(cfg6, dev)
    resumed.run_replay(frames[:3])              # a captured graph and a map to replace
    resumed.load_checkpoint(ckpt)
    resumed.run_replay(frames[15:])
    check(same_state(world_state_to_numpy(resumed.state), want)
          and resumed._step.state is resumed.state and resumed.loop == "cond",
          "cond checkpoint: resumed after frame 15 into a running cond engine, the world "
          "state bit-identical to the host-driven g6 replay")
    log = os.path.join(tmp, "cond_replay.pcsl")
    save_frames(log, frames)
    eng = SegmentationEngine(cfg6, dev)
    eng.start()
    try:
        for i, fr in enumerate(frames):
            eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
            eng.submit_cloud(fr.t, fr.points)
            if not eng.drain(target_total=i + 1, timeout=120.0):
                fail(f"cond lockstep stream: frame {i} not accounted for in 120 s")
    finally:
        eng.stop()
    check(eng.frames_processed == len(frames) and no_sentinels(eng.records)
          and [(r["seg_vec_size"], r["nblines"]) for r in eng.records]
          == [(r["seg_vec_size"], r["nblines"]) for r in ref["records"]]
          and same_state(world_state_to_numpy(eng.state), want),
          f"cond lockstep stream (deferred read-back): {eng.frames_processed} frames, "
          f"records and world state equal the host-driven replay's")
    out = eng.run_streaming_from_log(log, rate_hz=0.0)
    check(out["drained"] and out["failed"] == 0 and out["fed"] == out["processed"]
          + out["dropped"] + out["skipped"],
          f"cond unpaced stream: {out['processed']} processed, {out['dropped']} dropped of "
          f"{out['fed']} fed, drained")

    # one frame of each loop under the profiler, after the replay: frame 10
    # again, and a frame of NaN points (degenerate: every round dead)
    later = frames[-1].t + 1.0
    fr10 = dataclasses.replace(frames[10], t=later)
    nan = dataclasses.replace(frames[10], t=later + 1.0, points=np.zeros((0, 3), np.float32))
    engines = {label: {loop: r["engine"] for loop, r in by_loop.items()}
               for label, by_loop in runs.items()}
    for label, engs in engines.items():
        prof = {}
        for loop in LOOPS_TIMED:
            for what, f in (("frame 10", fr10), ("a NaN frame", nan)):
                prof[(loop, what)] = p = profile_frame(engs[loop], f)
                nodes = ("" if loop == "eager" else
                         f", {engs[loop]._step.captures[0]['cond_nodes']} conditional nodes "
                         f"in the graph")
                print(f"time  {LOOP_LABEL[loop]} {label}, {what} under the profiler: "
                      f"{p['graph_launches']} cudaGraphLaunch, {p['kernel_launches']} "
                      f"cudaLaunchKernel, {p['host_reads']} host reads{nodes}, device "
                      f"{p['device_ms']:.3f} ms, wall {p['wall_ms']:.3f} ms [{card}]",
                      flush=True)
        gp = prof[("cond", "frame 10")]
        for ms, n, name in gp["top"]:
            print(f"      cond {label}, frame 10: {ms:.3f} ms ({ms / gp['device_ms']:.1%}) "
                  f"in {n} launches of {name[:90]}", flush=True)
        check(gp["graph_launches"] == 1 and gp["kernel_launches"] <= 20
              and gp["host_reads"] == 1,
              f"cond {label}: one frame is 1 cudaGraphLaunch, {gp['kernel_launches']} "
              f"cudaLaunchKernel (<= 20) and {gp['host_reads']} host read")
        # a dead round against a live one: all the NaN frame's rounds beyond
        # the host-driven NaN frame's time (which runs none), against frame 10's
        # time beyond the NaN frame's over the most rounds it can run
        R = round_count(engs["cond"].cfg)
        nan_ms = prof[("cond", "a NaN frame")]["device_ms"]
        dead = nan_ms - prof[("eager", "a NaN frame")]["device_ms"]
        live = (gp["device_ms"] - nan_ms) / R
        print(f"time  cond {label}: {R} dead rounds of a NaN frame take {dead:.3f} ms of "
              f"device time beyond the host-driven NaN frame's, {dead / R:.4f} ms a round; "
              f"a live round of frame 10 at least {live:.3f} ms [{card}]", flush=True)
        check(dead < live,
              f"{label}: the cond graph's {R} dead rounds together cost less than one live "
              f"round ({dead:.3f} against {live:.3f} ms)")

    # ms/frame in turns: graph, host-driven, host-driven, graph, ... on fresh maps
    timed = frames[LOOP_TIMED]
    blank = os.path.join(tmp, "loops_blank.npz")
    for label, engs in engines.items():
        SegmentationEngine(engs["cond"].cfg, dev, loop="eager").save_checkpoint(blank)
        times = {loop: [] for loop in LOOPS_TIMED}
        order = (list(LOOPS_TIMED) + list(reversed(LOOPS_TIMED))) * ((LOOP_REPEATS + 1) // 2)
        for loop in order[:len(LOOPS_TIMED) * LOOP_REPEATS]:
            eng = engs[loop]
            eng.load_checkpoint(blank)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs = eng.run_replay(timed)
            torch.cuda.synchronize()
            if len(recs) != len(timed):
                fail(f"{LOOP_LABEL[loop]} {label}: {len(recs)} of {len(timed)} timed frames "
                     f"processed")
            wall = (time.perf_counter() - t0) * 1e3 / len(timed)
            times[loop].append((statistics.median(r["processing_time"] for r in recs) / 1e3,
                                wall))
        for loop, vals in times.items():
            med = [m for m, _ in vals]
            walls = [w for _, w in vals]
            print(f"time  {LOOP_LABEL[loop]} engine {label}, frames {LOOP_TIMED.start}-"
                  f"{LOOP_TIMED.stop - 1} x {len(vals)} replays in turns (graph, host-driven, "
                  f"host-driven, graph): "
                  f"median ms/frame {statistics.median(med):.3f} "
                  f"(spread {min(med):.3f}-{max(med):.3f}), wall ms/frame "
                  f"{statistics.median(walls):.3f} (spread {min(walls):.3f}-{max(walls):.3f}) "
                  f"[{card}]", flush=True)
    print(f"time  loop phase {time.perf_counter() - t_phase:.1f} s [{card}]", flush=True)
    return f64_cond


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
    check(info["loop"] == "cond" and info["graph_launches"] == 1
          and info["kernel_launches"] <= 20 and info["host_reads"] == 1
          and info["vote_state_launches"] >= info["vote_state_launches_ran"] > 0
          and info["device_us"] > 0
          and info["nlines"] >= 1,
          f"cli inspect: frame {info['frame']} is 1 cudaGraphLaunch, "
          f"{info['kernel_launches']} cudaLaunchKernel and {info['host_reads']} host read; "
          f"vote_state {info['vote_state_launches']} launches in the cond graph, "
          f"{info['vote_state_launches_ran']} of them ran and voted")
    print(f"time  cli inspect, frame {info['frame']} of the 4 Hz flight after one warm-up "
          f"frame, under torch.profiler: loop {info['loop']}, graph_launches "
          f"{info['graph_launches']}, kernel_launches {info['kernel_launches']}, host_reads "
          f"{info['host_reads']}, device_us {info['device_us']}, wall_ms "
          f"{info['wall_ms']:.3f}, vote_state_launches {info['vote_state_launches']} "
          f"(ran {info['vote_state_launches_ran']}), vote_histogram_launches "
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
# NX 79 grids and 3-4 frames, the sensor128 seed 128x128 frames at g3
SOAK_SEEDS = (("base", 3000, 4), ("g6", 3100, 1), ("g6", 3102, 1), ("sensor128", 3206, 1))


class OracleRun:
    """The oracle backend's replay of some frames on the host (`oracle_run`):
    each frame's record and world snapshot, and, like the engine's, the
    world segments at the end."""

    def __init__(self, records, snapshots, segments, engine=None):
        self.records, self.snapshots, self.segments = records, snapshots, segments
        self.engine = engine

    def world_segments(self):
        return self.segments


def oracle_run(cfg, frames, keep_engine=False) -> dict:
    """The oracle backend over `frames` on the host, frame by frame: the
    fields of an OracleRun.  Runs in a process of its own (`start_oracle`)
    or here; `keep_engine` keeps the engine (here only: it does not
    pickle)."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine

    ref = SegmentationEngine(cfg, backend="oracle")
    records, snapshots = [], []
    for fr in frames:
        ref.push_pose(fr.t, fr.position, fr.quat_wxyz)
        records.append(ref.process_frame(fr.t, fr.points))
        snapshots.append(ref.world_snapshot())
    return {"records": records, "snapshots": snapshots, "segments": ref.world_segments(),
            "engine": ref if keep_engine else None}


def start_oracle(cfg, frames):
    """`oracle_run(cfg, frames)` in a spawned process of its own, beside the
    card's phases, with two threads for numpy: (pool, its AsyncResult).
    The caller terminates the pool, done or not."""
    import multiprocessing

    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS",
                                            "MKL_NUM_THREADS")}
    os.environ.update({k: "2" for k in saved})
    try:
        pool = multiprocessing.get_context("spawn").Pool(1)    # the process starts here
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return pool, pool.apply_async(oracle_run, (cfg, frames))


def held_to_oracle(label, got, want: OracleRun) -> float:
    """A float64 run's frames (record, world snapshot) against the oracle's:
    nlines, status and world count, every world segment's points_size and
    radius exact, intersections' pairs equal; returns the worst gap of an
    endpoint, a pca_coeff or an intersection parameter."""
    worst = 0.0
    for k, ((g, (segs, inter)), w, (osegs, ointer)) in enumerate(
            zip(got, want.records, want.snapshots)):
        for f in ("nblines", "status", "seg_vec_size"):
            if g[f] != w[f]:
                fail(f"{label}, frame {k}: {f} {g[f]} against the oracle's {w[f]}")
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
    check(len(got) == len(want.records) and worst <= PARITY_TOL,
          f"{label}: nlines, status, world count, points_size and radius equal the oracle's "
          f"on each of {len(got)} frames; endpoints, pca_coeff and intersection parameters "
          f"within {PARITY_TOL} (worst {worst:.3g})")
    return worst


def f64_parity(label, cfg, frames, kernel, card, oracle=None):
    """The float64 mode on the card (the host-driven engine, its voting counted)
    against the oracle backend on the host, frame by frame (held_to_oracle).
    `oracle`: the oracle's run of these frames (an OracleRun, from a process
    of its own), or None to run it here.  Returns (torch engine, the
    oracle's run, the oracle's per-frame records)."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine

    voting = counted_voting()
    eng = SegmentationEngine(cfg, voting=voting)
    check(eng.state.a.dtype == torch.float64 and eng.state.inter.dtype == torch.float64
          and eng._tables[0].dtype == torch.float64 and eng._tables[1].dtype == torch.float32,
          f"{label}: float64 world map and direction vectors, float32 plane bases")
    got = []
    for fr in frames:
        eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
        got.append((eng.process_frame(fr.t, fr.points), eng.world_snapshot()))
    launches_of(label, voting, kernel)
    if oracle is None:
        oracle = OracleRun(**oracle_run(cfg, frames, keep_engine=True))
    held_to_oracle(label, got, oracle)
    nlines = sum(r["nblines"] for r, _ in got)
    n_seg, n_int = len(eng.world_segments()), len(eng.intersections_rows())
    check(nlines > 0 and n_seg >= 3,
          f"{label}: {nlines} lines, {n_seg} world segments, {n_int} intersections")
    t_port = [r["processing_time"] / 1e3 for r, _ in got]
    t_ref = [r["processing_time"] / 1e3 for r in oracle.records]
    print(f"time  {label}, {len(frames)} frames, median ms/frame: float64 on the card "
          f"{statistics.median(t_port):.3f}, the oracle on the host "
          f"{statistics.median(t_ref):.3f} [{card}]", flush=True)
    return eng, oracle, oracle.records


# the float32 drift against the oracle of the same replays on a CPU: the
# port's plain path, and the JAX package's float32 path (ROADMAP.md section 3)
F32_CPU_DRIFT = {"g4": "CPU: port max 6.02e-6, median 6.4e-7, p90 3.0e-6; JAX max 2.81e-6, "
                       "median 4.2e-7",
                 "g6": "CPU: not measured"}


def f32_against_oracle(label, gran, run, ref, want_records, card):
    """A float32 replay on the card (`run`: its records and world segments)
    against the oracle engine `ref` that ran the same frames on the host,
    with its per-frame records: nblines, status and world count exact on
    every frame, the world's count, points_size and radius (the float32 of
    the oracle's table value) exact, every world endpoint within 5e-3.
    Prints the endpoint error's max, median and p90."""
    st = load_structure()
    got = [tuple(r[f] for f in st.FRAME_INTS) for r in run["records"]]
    want = [tuple(r[f] for f in st.FRAME_INTS) for r in want_records]
    check(got == want, f"{label}: per-frame nblines, status and world count equal the "
                       f"oracle's ({len(got)} frames)")
    segs, osegs = run["segments"], ref.world_segments()
    check([(s["points_size"], s["radius"]) for s in segs]
          == [(o["points_size"], float(np.float32(o["radius"]))) for o in osegs],
          f"{label}: world count ({len(segs)}), points_size and radius (float32 of the "
          f"oracle's) equal")
    errs = st.endpoint_errors([endpoints(s) for s in segs], [endpoints(o) for o in osegs])
    d = st.drift(errs)
    check(d["max"] <= st.ENDPOINT_TOL,
          f"{label}: world endpoints within {st.ENDPOINT_TOL} of the oracle's")
    print(f"drift {label}: endpoint error against the oracle max {d['max']:.3g} median "
          f"{d['median']:.3g} p90 {d['p90']:.3g} m over {d['n']} endpoints [{card}]; "
          f"{F32_CPU_DRIFT[gran]}", flush=True)


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


def jax_divergent_seeds(soak) -> int:
    """The base-mode seeds (float32 and float64) that SOAK.json, the JAX
    soak's record, lists as divergent, on the card, each compared with that
    record: no seed unexplained.  The card's set need not equal the JAX one,
    since eigensolver noise decides the knife edge.  Returns the seeds run."""
    record = soak.load_jax_soak()
    sets = collections.defaultdict(list)
    n = 0
    for b in record["batches"]:
        if b["mode"] != "base":
            continue
        for d in b["diverging"]:
            batch = soak.run_batch(1, d["seed"], "base", b["f64"], "cuda")
            cmp = soak.compare_with_jax(batch, record)
            for key in ("both", "only_port", "only_jax", "class_differs", "unexplained"):
                sets[key] += [(x if key == "unexplained" else x["seed"]) for x in cmp[key]]
            n += 1
    print("soak against SOAK.json: " + json.dumps({k: sets[k] for k in (
        "both", "only_port", "only_jax", "class_differs", "unexplained")}), flush=True)
    check(n > 0 and not sets["unexplained"],
          f"soak: the JAX soak's {n} divergent base seeds on cuda, {len(sets['both'])} "
          f"divergent here too, 0 unexplained")
    return n


def knife_edge_witness(soak) -> int:
    """Every seed that SOAK_torch.json's card batches hold divergent, g6 ones
    aside (the host oracle takes ~24 s a g6 seed), traced on the card frame
    by frame; those divergent on one side only or under another class than
    SOAK.json's also in the float64 parity mode.  Each trace's worlds agree,
    or every frame where the oracle and the port part starts at a
    refinement whose b.x is exactly 0.0 on one side and rounding noise on
    the other.  Returns the traces run."""
    with open(soak.ARTIFACT) as f:
        batches = json.load(f)["batches"]
    seeds = {}
    for b in batches:
        if b["device"] != "cuda" or "jax_soak" not in b or b["mode"] == "g6":
            continue
        for d in b["diverging"]:
            seeds.setdefault((d["seed"], b["mode"], b["f64"]), False)
        for key in ("only_port", "only_jax", "class_differs"):
            for d in b["jax_soak"][key]:
                seeds[(d["seed"], b["mode"], b["f64"])] = True
    n, worst, stats = 0, 0.0, []
    for (seed, mode, f64), one_sided in sorted(seeds.items()):
        for f64_run in sorted({f64, f64 or one_sided}):
            tr = soak.knife_edge_trace(seed, mode, f64_run, "cuda")
            stats.append(soak.bx_stats(soak.agreeing_bx(tr)))
            flips = [(v["frame"], v["round"], float(f"{v['other_bx']:.3g}"))
                     for v in soak.knife_edge_frames(tr) if v["verdict"] == "knife-edge"]
            what = f"knife edge: seed {seed} ({mode}, {'float64' if f64_run else 'float32'}) on cuda"
            print(f"{what}: statuses oracle {tr['oracle']['status']} port "
                  f"{tr['torch']['status']}; world errors {tr['errors'] or 'none'}; "
                  f"flips (frame, round, |b.x| on the other side) {flips}", flush=True)
            check(soak.knife_edge_explained(tr),
                  f"{what}: {'worlds agree' if not tr['errors'] else 'every part is a flip'}")
            worst = max([worst] + [x for _, _, x in flips])
            n += 1
    check(n >= len(seeds) > 0, f"knife edge: {n} traces of {len(seeds)} divergent seeds on "
                               f"cuda, other side's |b.x| at most {worst:.3g} at a flip")
    stored = stored_g6_witness(batches, soak)
    bx = soak.merge_bx_stats(stats + [w["bx"] for w in stored])
    g = {k: "none" if v is None else f"{v:.3g}" for k, v in bx.items()}
    print(f"knife edge: {bx['agreeing']} refinements where the two sides agree, over {n} "
          f"traces and {len(stored)} stored g6 witnesses: smallest nonzero |b.x| "
          f"{g['min_nonzero']}, smallest at or above BX_NOISE {g['min_above_noise']}, "
          f"largest gap between the sides where the oracle's |b.x| < BX_NOISE "
          f"{g['max_inplane_gap']}; BX_NOISE {soak.BX_NOISE:g}", flush=True)
    check((bx["max_inplane_gap"] or 0.0) >= soak.BX_NOISE,
          f"knife edge: BX_NOISE ({soak.BX_NOISE:g}) lies within how far the two sides' b.x "
          f"part at agreeing refinements of directions the oracle puts in the y-z plane (up "
          f"to {g['max_inplane_gap']}): a flip it admits lies inside that disagreement")
    return n


def stored_g6_witness(batches, soak) -> list:
    """The witnesses that tools/parity_soak_torch.py --witness-stored stored
    for SOAK_torch.json's g6 card batches: one for every seed a batch holds
    divergent, each explained, every part a flip."""
    out = []
    for b in batches:
        if b["device"] != "cuda" or b["mode"] != "g6" or not b["diverging"]:
            continue
        ws = {w["seed"]: w for w in b.get("witness", [])}
        for d in b["diverging"]:
            w = ws.get(d["seed"])
            flips = [(f["frame"], f["round"], float(f"{f['other_bx']:.3g}"))
                     for f in (w or {}).get("flips", [])]
            check(w is not None and w["explained"] and flips and not w["unexplained_frames"]
                  and all(x < soak.BX_NOISE for _, _, x in flips),
                  f"knife edge: seed {d['seed']} (g6) on cuda, stored witness: every part is "
                  f"a flip (frame, round, |b.x| on the other side) {flips}")
            out.append(w)
    return out


def soak_phase(card):
    """Fixed seeds of tools/parity_soak_torch.py on the card: the oracle
    against the torch backend, no unexplained divergence."""
    from pointcloud_segmentation_tpu_torch.ops import voting as V

    soak = load_soak()
    V.reset_counts()

    def ran():
        return V.ran_launches(V.vote_state) + V.ran_launches(V.vote_histogram)

    t0 = time.perf_counter()
    counts, n = collections.Counter(), 0
    for mode, seed, k in SOAK_SEEDS:
        if mode == "g6":
            cfg, _ = soak.random_case(seed, mode)
            check(cfg.num_x_max <= 105, f"soak seed {seed} ({mode}) draws a grid the oracle "
                                        f"bins in seconds (NX {cfg.num_x_max})")
        before = ran()
        batch = soak.run_batch(k, seed, mode, False, "cuda")
        if mode == "sensor128":
            cfg, fr = soak.random_case(seed, mode)
            launched = ran() - before
            check(batch["counts"].get("real", 0) == 0 and len(fr[0].points) == 128 * 128
                  and launched > 0,
                  f"soak seed {seed} ({mode}): {len(fr)} frames of {len(fr[0].points)} rays "
                  f"at g{cfg.granularity} ({cfg.voting_mode}) on cuda, 0 unexplained, "
                  f"{launched} voting launches")
        counts.update(batch["counts"])
        n += k
    check(counts.get("real", 0) == 0,
          f"soak: {n} seeds on cuda, 0 unexplained; diverging by class {dict(counts)}")
    n += jax_divergent_seeds(soak)
    n_traced = knife_edge_witness(soak)
    n_state, n_hist = V.ran_launches(V.vote_state), V.ran_launches(V.vote_histogram)
    check(n_state > 0 and n_hist > 0,
          f"soak: vote_state ran {n_state} and vote_histogram {n_hist} times")
    print(f"time  soak, {n} seeds and {n_traced} knife-edge traces, both backends: "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)


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


def parity_stack(cfg6, cfg4, frames, k6, dev, card, tmp, k4=None, oracle6=None,
                 f64_cond=None):
    """The parity stack.  oracle6: the g6 float64 oracle's run of the parity
    frames (started with start_oracle), or None to run it here; f64_cond:
    the cond engine's float64 parity frames (loop_phase), held against it
    too."""
    import dataclasses

    from pointcloud_segmentation_tpu_torch.ops.hough import KERNELS

    t0 = time.perf_counter()
    f64_kernel_checks(dev, frames[len(frames) // 2], card)
    part = frames[G6_PARITY_FRAMES]
    label6 = f"frames {G6_PARITY_FRAMES.start}-{G6_PARITY_FRAMES.stop - 1}"
    _, ref6, want6 = f64_parity("float64 g6 lazy against the oracle",
                                dataclasses.replace(cfg6, compute_dtype="float64"), part,
                                "vote_state", card, oracle6)
    if f64_cond is not None:
        held_to_oracle(f"float64 g6 lazy through the cond step, {label6}, against the "
                       f"oracle", f64_cond, ref6)
    f32_against_oracle(f"f32 g6 lazy, {label6}", "g6", replay(cfg6, part, dev, KERNELS),
                       ref6, want6, card)
    cfg4_64 = dataclasses.replace(cfg4, compute_dtype="float64")
    eng4, run4, want4 = f64_parity("float64 g4 carry against the oracle", cfg4_64, frames,
                                   "vote_histogram", card)
    ref4 = run4.engine
    f32_against_oracle(f"f32 g4 carry, {len(frames)} frames", "g4",
                       k4 if k4 is not None else replay(cfg4, frames, dev, KERNELS),
                       ref4, want4, card)
    lazy_equals_carry_f64(cfg4_64, frames, eng4, dev)
    batched_phase(cfg6, frames, k6, dev, card)
    sequential_fusion_phase(cfg6, frames, dev)
    soak_phase(card)
    oracle_backend_phase(ref4, tmp)
    print(f"time  the parity stack's phases: {time.perf_counter() - t0:.1f} s [{card}]",
          flush=True)


# ------------------------------------------------------------ structure flights

# flights of tools/structure_torch.py flown here at g4 and g6 on the kernels
# and held against the record of STRUCTURE_torch.json; the g4 ones also
# against the host oracle, which flies them in processes of its own meanwhile
STRUCTURE_FLIGHTS = ("tower", "mockup", "dev_r01")


def load_structure():
    """tools/structure_torch.py, importable by name, so that the oracle's
    processes can unpickle its functions."""
    tools = str(REPO / "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import structure_torch

    return structure_torch


def structure_records(st) -> dict:
    """STRUCTURE_torch.json's records on the card, by (flight, granularity):
    it covers every flight and granularity of the tool, and every check of
    every record, recomputed from its fields, holds."""
    with open(st.ARTIFACT) as f:
        recs = {(r["flight"], r["granularity"]): r for r in json.load(f)["records"]
                if r["device"] == "cuda"}
    want = [(n, g) for n, fl in st.FLIGHTS.items() for g in fl.granularities]
    missing = [k for k in want if k not in recs]
    check(not missing, f"STRUCTURE_torch.json holds every flight and granularity on cuda "
                       f"({len(want)} records; missing {missing or 'none'})")
    for key in want:
        r = recs[key]
        bad = st.unexplained(r)
        check(not bad and r["oracle_frames"] == r["frames"] and r["plain"] is not None,
              f"STRUCTURE_torch.json {key[0]} g{key[1]}: kernels against plain and the card "
              f"against the oracle over {r['oracle_frames']} of {r['frames']} frames, every "
              f"check holds but known ones ({r['card']}){'; failing: ' + str(bad) if bad else ''}")
        for c in (c for c, ok in st.checks_of(r).items() if not ok):
            known_failure(f"STRUCTURE_torch.json {key[0]} g{key[1]}", c,
                          r[c.split(":")[0]]["beyond"])
    return recs


def known_failure(label, check_name, beyond):
    """Print a failing check that tools/structure_torch.py's KNOWN_FAILURES
    lists (README §Precision contract): it stays failing, and is reported
    on every run."""
    segs = ", ".join(f"segment {b['segment']} {b['error']:.4g} m at b.x {b['b_x'][1]:.3g}"
                     for b in beyond)
    print(f"known {label}: FAILS {check_name} ({segs}; the x-division of README "
          f"§Precision contract)", flush=True)


def held_to_record(label, run, rec):
    """A flight on the kernels against its record's kernels side: per-frame
    integers, world count, points_size and radius exact, beams matched and
    intersections equal to the record's (and so to the oracle's)."""
    st = load_structure()
    kern, w = rec["kernels"], run["world"]
    check(all(run[f] == kern[f] for f in st.FRAME_INTS),
          f"{label}: per-frame nblines, status and world count equal the record's "
          f"({len(run['nblines'])} frames)")
    check((w["count"], w["points_size"], w["radius"])
          == (kern["world"]["count"], kern["world"]["points_size"], kern["world"]["radius"]),
          f"{label}: world count ({w['count']}), points_size and radius equal the record's")
    orc = rec["card_vs_oracle"]
    check(w["recall"] == kern["world"]["recall"] == orc["recall"][1]
          and w["intersections"] == kern["world"]["intersections"] == orc["intersections"][1]
          and run["world_overflow_frames"] == 0,
          f"{label}: {w['recall']} beams matched and {w['intersections']} intersections, as "
          f"the record's kernels and oracle; no frame overflowed the world map")


def structure_flights(st, recs, dev, card):
    """Every flight of STRUCTURE_FLIGHTS at g4 and g6 and dev_multi_radius at
    g6 on the kernels, each counted from 0 and held to its record; the g6
    tower on the plain versions too; the g4 flights against the oracle.
    Returns (runs by (flight, granularity), launches by (kernel, rows,
    points, NX) with the flight that gave them)."""
    import concurrent.futures
    import multiprocessing

    from pointcloud_segmentation_tpu_torch.ops import voting as V
    from pointcloud_segmentation_tpu_torch.ops.hough import PLAIN, Voting

    runs, launched = {}, {}
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(len(STRUCTURE_FLIGHTS), mp_context=ctx) as pool:
        oracle = {n: pool.submit(st.fly_flight, n, 4, "oracle") for n in STRUCTURE_FLIGHTS}
        jobs = [(n, g) for n in STRUCTURE_FLIGHTS for g in (4, 6)] + [("dev_multi_radius", 6)]
        for name, gran in jobs:
            cfg = st.flight_config(name, gran)
            scene, frames = st.flight_frames(name)
            kernel = "vote_state" if cfg.voting_mode == "lazy" else "vote_histogram"
            V.vote_state.launches = V.vote_histogram.launches = 0
            voting = Voting(st.Counted(V.vote_state), st.Counted(V.vote_histogram))
            run = st.fly(cfg, scene, frames, device=dev, voting=voting)
            n = getattr(V, kernel).launches
            calls = getattr(voting, kernel).shapes
            label = f"structure {name} g{gran} ({cfg.voting_mode})"
            check(n > 0 and n == sum(calls.values()),
                  f"{label}: launched {kernel} {n} times, on every call "
                  f"({len(calls)} shapes)")
            for (rows, pts, nx), c in calls.items():
                k = (kernel, rows, pts if pts > 512 else "<= 512", nx)
                launched.setdefault(k, [name, gran, 0])[2] += c
            held_to_record(label, run, recs[(name, gran)])
            runs[(name, gran)] = run
        cfg = st.flight_config("tower", 6)
        scene, frames = st.flight_frames("tower")
        plain = st.fly(cfg, scene, frames, device=dev, voting=PLAIN)
        cmp = st.compare(runs[("tower", 6)], plain, len(frames), False)
        check(cmp["frame_integers_equal"] and cmp["world_equal"]
              and cmp["drift"]["max"] <= st.ENDPOINT_TOL,
              f"structure tower g6: kernels against plain on the card, per-frame integers, "
              f"world count, points_size and radius exact, endpoints within "
              f"{st.ENDPOINT_TOL} (worst {cmp['drift']['max']:.3g}; plain "
              f"{plain['seconds']:.1f} s)")
        for name in STRUCTURE_FLIGHTS:
            ref = oracle[name].result()
            cmp = st.compare(runs[(name, 4)], ref, len(ref["nblines"]), True)
            d, label = cmp["drift"], f"structure {name} g4 against the oracle on the host"
            check(cmp["frame_integers_equal"] and cmp["world_equal"]
                  and cmp["recall"][0] == cmp["recall"][1]
                  and cmp["intersections"][0] == cmp["intersections"][1],
                  f"{label}: per-frame integers, world count, points_size and radius exact, "
                  f"beams matched and intersections equal (oracle {ref['seconds']:.1f} s)")
            tol = f"card_vs_oracle: endpoints within {st.ENDPOINT_TOL}"
            if d["max"] > st.ENDPOINT_TOL and tol in st.KNOWN_FAILURES.get((name, 4), ()):
                recorded = recs[(name, 4)]["card_vs_oracle"]["beyond"]
                check(st.x_division(cmp) and [b["segment"] for b in cmp["beyond"]]
                      == [b["segment"] for b in recorded]
                      and all(abs(b["error"] - c["error"]) <= 1e-9
                              for b, c in zip(cmp["beyond"], recorded)),
                      f"{label}: the endpoints beyond {st.ENDPOINT_TOL} are the record's, "
                      f"each in the y-z plane to within {st.X_DIVISION_BX}")
                known_failure(label, tol, cmp["beyond"])
            else:
                check(d["max"] <= st.ENDPOINT_TOL,
                      f"{label}: endpoints within {st.ENDPOINT_TOL} (worst {d['max']:.3g})")
            runs[(name, 4)]["drift"] = d
    return runs, launched


def start_example(tmp):
    """examples/map_a_structure_torch.py started in a process of its own on
    the card, writing into tmp: (process, its out_dir, start time)."""
    out = os.path.join(tmp, "example_tower")
    proc = subprocess.Popen([sys.executable, str(REPO / "examples" / "map_a_structure_torch.py"),
                             out], cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, out, time.perf_counter()


def example_on_the_card(recs, started):
    """The example's process: exit 0, the three CSVs with the reference
    headers, and the world map of the tool's record of its flight."""
    proc, out, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        fail(f"examples/map_a_structure_torch.py exited {proc.returncode}:\n{stdout}\n{stderr}")
    secs = time.perf_counter() - t0
    for name, header in CSV_HEADERS.items():
        with open(os.path.join(out, name)) as f:
            check(f.readline().strip() == header,
                  f"example map_a_structure_torch: {name} has the reference header")
    line = next(ln for ln in stdout.splitlines() if ln.startswith("world map:"))
    w = recs[("example", 4)]["kernels"]["world"]
    want = (f"world map: {w['count']} segments, {w['intersections']} intersections; "
            f"recall {w['recall']}/12 beams")
    check(line == want, f"example map_a_structure_torch on cuda: '{line}' as the record of "
                        f"its flight, in {secs:.1f} s")


def structure_shapes(sh, st, launched, dev):
    """Each kernel against its plain version, and timed, at every (rows,
    points, NX) the flights launched that the kernel table lacks, on the
    busiest of every fourth frame (the most voxel points) of a flight that
    launched it; the launches are the flights'."""
    from pointcloud_segmentation_tpu_torch.ops.hough import (
        _compact_removed, _pad_dirs_to_tile, direction_tables)

    have = {(r["name"], r["rows"], r["n"] if r["n"] > 512 else "<= 512", r["nx"])
            for r in sh.times}
    g = torch.Generator().manual_seed(2)
    for key, (name, gran, count) in sorted(launched.items(), key=str):
        if key in have:
            continue
        kernel, rows, pts, nx = key
        cfg = st.flight_config(name, gran)
        _, frames = st.flight_frames(name)
        p = max((voting_problem(cfg, fr, dev) for fr in frames[::4]),
                key=lambda q: int(q[1].sum())) + (nx,)
        _, c1, c2 = _pad_dirs_to_tile(*direction_tables(gran, dev))
        if rows != c1.shape[0]:
            c1, c2 = gathered(c1, c2, rows, g)
        label = f"the {name} flight, g{gran}"
        if kernel == "vote_state":
            sh.state(label, p, c1, c2, timed=True)
        elif pts == "<= 512":
            Xs, act, half, dx, nxt, _ = p
            n_rem = min(512, int(act.sum()))
            rem = act & (torch.cumsum(act.to(torch.int32), 0) <= n_rem)
            Xr, live = _compact_removed(Xs, rem, n_rem, 512)
            sh.histogram(f"{label}, a {n_rem}-column delta", (Xr, live, half, dx, nxt, nx),
                         c1, c2, timed=True)
        else:
            sh.histogram(label, p, c1, c2, timed=True)
        sh.times[-1]["launches"] = count


def structure_stack(dev, card, sh, tmp):
    """The structure flights of tools/structure_torch.py on the card."""
    t0 = time.perf_counter()
    st = load_structure()
    recs = structure_records(st)
    example = start_example(tmp)
    try:
        runs, launched = structure_flights(st, recs, dev, card)
    except BaseException:
        example[0].kill()
        example[0].wait()
        raise
    example_on_the_card(recs, example)
    structure_shapes(sh, st, launched, dev)
    for (name, gran), run in runs.items():
        rec, w = recs[(name, gran)], run["world"]
        d, whose = run.get("drift"), "here"
        if d is None:
            d, whose = rec["card_vs_oracle"]["drift"], "recorded"
        print(f"structure: {name} g{gran} ({rec['voting']}): {len(run['nblines'])} frames, "
              f"world {w['count']}, recall {w['recall']}, intersections {w['intersections']}, "
              f"drift against the oracle ({whose}) max {d['max']:.3g} median {d['median']:.3g} "
              f"p90 {d['p90']:.3g} m, {run['seconds']:.1f} s [{card}]", flush=True)
    print(f"time  the structure phases: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)


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
    ap.add_argument("--native-only", action="store_true",
                    help="the g6 replay, the node loop's native-runtime phases, the "
                         "endurance stream, the CLI and the soak only; prints no "
                         "result lines")
    ap.add_argument("--structure-only", action="store_true",
                    help="the kernel checks, the parity stack's f32 drift against the "
                         "oracle and the structure flights only; prints no result lines")
    ap.add_argument("--graph-only", action="store_true",
                    help="the kernel checks and the captured frame (cond) against "
                         "the host-driven engine only; prints no result lines")
    ap.add_argument("--tof224-only", action="store_true",
                    help="the voxel kernel's checks and the 224x172 flight's phase only; "
                         "prints no result lines")
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
    _build.load_library()          # voting.cu and graph_cond.cu, one nvcc call
    info = _build.BuildInfo
    print(f"build: {time.perf_counter() - t0:.2f} s to build and load the CUDA sources "
          f"({info.seconds:.2f} s in nvcc) -> {info.path}", flush=True)
    for line in info.log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print("ptxas " + line.strip(), flush=True)
    from pointcloud_segmentation_tpu_torch import native
    from pointcloud_segmentation_tpu_torch.native import build as native_build

    t0 = time.perf_counter()
    if not native.available():
        fail("the native runtime did not build or load (see the warning above)")
    print(f"build: native runtime {time.perf_counter() - t0:.2f} s to build and load "
          f"({native_build.BuildInfo.seconds:.2f} s in g++) -> {native_build.BuildInfo.path}",
          flush=True)
    earlier = None
    if args.earlier:
        earlier_src = Path(args.earlier).resolve()
        earlier = _build.load_library(earlier_src)
        print(f"build: the earlier {args.earlier} -> {_build.BuildInfo.path}", flush=True)

    # the full-size replay: shipped config, default StaticShapes, 64x64 ToF
    poses = trajectory_poses(WP_TESTS, hz=2.0, velocity=0.25)
    frames = frames_of(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.002), 0)
    check(len(frames) == 31, f"{len(frames)} frames in the full-size replay")

    cfg6 = default_config()
    cfg4 = default_config(granularity=4)
    frames224 = frames_of(OBS_TESTS_SCENE, poses, TofSpec(width=TOF224[0], height=TOF224[1],
                                                          noise_frac=0.01), 1)
    if args.tof224_only:
        voxel_phase(dev, frames, frames224, card)
        tof224_phase(dev, frames224, card)
        print("one stack only: no result lines", flush=True)
        sys.exit(3)
    if args.parity_only or args.sensor_only:
        k6, _ = counted_run("g6 replay", cfg6, frames, dev, "vote_state")
        stack = parity_stack if args.parity_only else sensor_stack
        with tempfile.TemporaryDirectory(prefix="pcs_chip_smoke_") as tmp:
            stack(cfg6, cfg4, frames, k6, dev, card, tmp)
        print("one stack only: no result lines", flush=True)
        sys.exit(3)
    if args.native_only:
        k6, _ = counted_run("g6 replay", cfg6, frames, dev, "vote_state")
        with tempfile.TemporaryDirectory(prefix="pcs_chip_smoke_") as tmp:
            native_stack(cfg6, frames, k6, tmp, card)
            cli_phase(tmp, card)
        soak_phase(card)
        print("one stack only: no result lines", flush=True)
        sys.exit(3)
    if args.structure_only:
        import dataclasses

        from pointcloud_segmentation_tpu_torch.ops.hough import KERNELS

        sh = kernel_checks(dev, frames[len(frames) // 2], card)
        with tempfile.TemporaryDirectory(prefix="pcs_chip_smoke_") as tmp:
            structure_stack(dev, card, sh, tmp)
        part = frames[G6_PARITY_FRAMES]
        _, ref6, want6 = f64_parity("float64 g6 lazy against the oracle",
                                    dataclasses.replace(cfg6, compute_dtype="float64"),
                                    part, "vote_state", card)
        f32_against_oracle("f32 g6 lazy, the parity frames", "g6",
                           replay(cfg6, part, dev, KERNELS), ref6, want6, card)
        print(json.dumps({"shapes": [r for r in sh.times if "flight" in r["shape"]]}),
              flush=True)
        print("one stack only: no result lines", flush=True)
        sys.exit(3)
    if args.graph_only:
        sh = kernel_checks(dev, frames[len(frames) // 2], card)
        gates_phase(dev, frames, card, sh)
        reexam_phase(dev, frames, card, sh)
        k6, _ = counted_run("g6 replay", cfg6, frames, dev, "vote_state", per_frame=True)
        k4, _ = counted_run("g4 replay", cfg4, frames, dev, "vote_histogram", per_frame=True)
        k6s, _ = counted_run("g6 replay at radius 0.015", default_config(radius_sizes=(0.015,)),
                             frames[10:15], dev, "vote_state", per_frame=True)
        runs, _ = main_path(cfg6, cfg4, frames, dev, k6, k4, card)
        with tempfile.TemporaryDirectory(prefix="pcs_chip_smoke_") as tmp:
            loop_phase(cfg6, cfg4, frames, dev, card, tmp, runs, k6s)
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

    # the float64 g6 oracle of the parity stack, in a process of its own
    # beside the card's phases
    import dataclasses

    oracle_pool, oracle6 = start_oracle(dataclasses.replace(cfg6, compute_dtype="float64"),
                                        frames[G6_PARITY_FRAMES])
    try:
        whole_run(cfg6, cfg4, frames, frames224, dev, card, earlier, oracle6)
    finally:
        oracle_pool.terminate()
        oracle_pool.join()


def whole_run(cfg6, cfg4, frames, frames224, dev, card, earlier, oracle6):
    """Every phase, then the result lines.  oracle6: the float64 g6 oracle's
    run of the parity frames, coming from a process of its own."""
    from pointcloud_segmentation_tpu_torch.config import default_config
    from pointcloud_segmentation_tpu_torch.ops.hough import PLAIN

    sh = kernel_checks(dev, frames[len(frames) // 2], card, earlier)
    gates_phase(dev, frames, card, sh)
    reexam_phase(dev, frames, card, sh)
    voxel_phase(dev, frames, frames224, card)
    tof224_phase(dev, frames224, card)
    golden_checks(dev)

    cfg6s = default_config(radius_sizes=(0.015,))
    check(cfg6.voting_mode == "lazy" and cfg4.voting_mode == "carry"
          and cfg6s.voting_mode == "lazy" and cfg6s.num_x_max == 261,
          "g6 resolves to lazy voting, g4 to carry; radius 0.015 gives NX 261")

    # the main path, counted path by path: the shipped g6 replay (lazy,
    # vote_state), the g4 replay (carry, vote_histogram), and a short g6
    # replay at radius 0.015 (NX 261)
    k6, n_state = counted_run("g6 replay", cfg6, frames, dev, "vote_state", per_frame=True)
    k4, n_hist = counted_run("g4 replay", cfg4, frames, dev, "vote_histogram",
                             per_frame=True)
    short = frames[10:15]
    k6s, _ = counted_run("g6 replay at radius 0.015", cfg6s, short, dev, "vote_state",
                         per_frame=True)

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

    # the main path as a user drives it: the engine's default, one CUDA graph
    # a frame with its rounds and branches as conditional nodes (the counted
    # runs above are the host-driven engine's)
    runs, launches = main_path(cfg6, cfg4, frames, dev, k6, k4, card)

    def ms_per_frame(run):
        return statistics.median(r["processing_time"] for r in run["records"]) / 1e3

    for label, pr in (("g6 lazy", p6), ("g4 carry", p4)):
        r = runs[label]
        print(f"time  replay {label}, {len(frames)} frames, median ms/frame: kernels "
              f"(host-driven) {ms_per_frame(r['eager']):.3f}, cond step "
              f"{ms_per_frame(r['cond']):.3f}, "
              f"plain {ms_per_frame(pr):.3f} [{card}]", flush=True)

    # the live node loop at the shipped config, on the default device
    with tempfile.TemporaryDirectory(prefix="pcs_chip_smoke_") as tmp:
        f64_cond = loop_phase(cfg6, cfg4, frames, dev, card, tmp, runs, k6s)
        log = native_stack(cfg6, frames, k6, tmp, card)
        serve_phase(cfg6, frames, tmp)
        cli_phase(tmp, card)
        checkpoint_phase(cfg6, frames, k6, tmp)
        sensor_stack(cfg6, cfg4, frames, k6, dev, card, tmp)
        t0 = time.perf_counter()
        got6 = OracleRun(**oracle6.get())
        print(f"time  waited {time.perf_counter() - t0:.1f} s for the float64 g6 oracle's "
              f"process [{card}]", flush=True)
        parity_stack(cfg6, cfg4, frames, k6, dev, card, tmp, k4, got6, f64_cond)
        structure_stack(dev, card, sh, tmp)
        shard_stack(cfg6, cfg4, frames, k6, dev, card, tmp, sh, log)

    sources = {"vote_state": "tools/exp_g6_pallas.py:156",
               "vote_histogram": "pointcloud_segmentation_tpu/ops/voting_pallas.py:49",
               "vote_decrement": "none (the XLA chain of pointcloud_segmentation_tpu/ops/"
                                 "hough.py _removed_cell_keys, compare and sum)"}
    main_shape = {"vote_state": "the full g6 table", "vote_histogram": "g4",
                  "vote_decrement": "512 removed points"}
    # each timed shape's launches: on its replay of the main path, or (set by
    # shard_phase) on rank 0 of its sharded replay
    paths = {("vote_state", 79): k6["shapes"], ("vote_state", 261): k6s["shapes"],
             ("vote_histogram", 79): k4["shapes"]}
    kernels = []
    for name in ("vote_state", "vote_histogram", "vote_decrement"):
        shapes = [r for r in sh.times if r["name"] == name]
        for r in shapes:
            key = (r["rows"], r["n"] if r["n"] > 512 else "<= 512")
            # the decrement's launches are counted a replay, not by shape
            r.setdefault("launches", None if name == "vote_decrement" else
                         paths.get((name, r["nx"]), {}).get(key, 0))
        head = next(r for r in shapes if r["shape"] == main_shape[name] and r["nx"] == 79)
        kernels.append({
            "name": name, "route": "cuda",
            "source": "pointcloud_segmentation_tpu_torch/csrc/voting.cu",
            "replaces": sources[name], "launches": launches[name][1],
            "launches_captured": launches[name][0], "launches_ran": launches[name][1],
            "max_abs_err": sh.errs[name], "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shapes": [{k: r[k] for k in ("shape", "rows", "n", "active", "nx", "launches",
                                          "ms", "plain_ms", "library_ms", "bound_ms",
                                          "bound_by", "earlier_ms")}
                       for r in shapes]})

    gshapes = [r for r in sh.times if r["name"] == "round_gates"]
    head = gshapes[0]                      # the g6 replay's round of median inliers
    captured, ran = launches["round_gates g6 lazy"]
    kernels.append({
        "name": "round_gates", "route": "cuda",
        "source": "pointcloud_segmentation_tpu_torch/csrc/gates.cu",
        "replaces": "none (the XLA gate chain of pointcloud_segmentation_tpu/ops/hough.py "
                    "_round)", "launches": ran, "launches_captured": captured,
        "launches_ran": ran, "max_abs_err": sh.errs["round_gates"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None, "shapes": gshapes})
    rshapes = [r for r in sh.times if r["name"] == "vote_reexam"]
    head = rshapes[0]                      # the g6 replay's increment of median suspects
    captured, ran = launches["vote_reexam"]
    kernels.append({
        "name": "vote_reexam", "route": "cuda",
        "source": "pointcloud_segmentation_tpu_torch/csrc/voting.cu",
        "replaces": "none (the tiered suspect re-exam of pointcloud_segmentation_tpu/ops/"
                    "hough.py: gathers, _vote_state_tiles, scatters)", "launches": ran,
        "launches_captured": captured, "launches_ran": ran,
        "max_abs_err": sh.errs["vote_reexam"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None, "shapes": rshapes})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
