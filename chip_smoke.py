"""Smoke run of the PyTorch port on one CUDA card: builds the voting kernels,
holds each against its plain PyTorch version, drives the replay main path at
the shipped configuration, checks what comes out, and times it.

    python3 chip_smoke.py

Needs one CUDA card and nvcc; exits non-zero on any failure.  It prints the
card's name and power limit, one line per check and time, then a JSON line
of the kernels, and last the JSON line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch


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


def cuda_ms(fn, reps: int) -> float:
    """Mean device ms of fn over reps launches, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def frames_of(scene, poses, spec, seed):
    from pointcloud_segmentation_tpu.io.simulator import simulate_trajectory

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


def kernel_checks(dev, frame, card):
    """Each kernel against its plain version on the card, at the shapes the
    main path gives it; returns the kernels' error and time records."""
    from pointcloud_segmentation_tpu.config import default_config
    from pointcloud_segmentation_tpu_torch.ops import voting as V
    from pointcloud_segmentation_tpu_torch.ops.hough import (
        _compact_removed, _pad_dirs_to_tile, direction_tables)

    cfg6 = default_config()
    NX = cfg6.num_x_max
    Xs, act, half, dx, nx = voting_problem(cfg6, frame, dev)
    _, c1, c2 = _pad_dirs_to_tile(*direction_tables(6, dev))
    B = c1.shape[0]
    print(f"frame: {int(act.sum())} voxel points of {Xs.shape[0]}, num_x "
          f"{int(nx)}, NX {NX}, {B} directions", flush=True)

    xk, yk = V.vote_bins_kernel(Xs, c1, c2, half, dx, nx)
    xp, yp = V.vote_bins(Xs, c1, c2, half, dx, nx)
    n_bad = int((xk != xp).sum() + (yk != yp).sum())
    check(n_bad == 0, f"bins bit-equal on a g6 frame: {2 * xk.numel()} bins, {n_bad} differ")
    del xk, yk, xp, yp

    errs = {"vote_state": 0, "vote_histogram": 0}

    def state_case(label, c1_, c2_, active):
        k = V.vote_state(Xs, active, c1_, c2_, half, dx, nx, NX)
        p = V.vote_state_plain(Xs, active, c1_, c2_, half, dx, nx, NX)
        e = max(max_err(a, b) for a, b in zip(k, p))
        errs["vote_state"] = max(errs["vote_state"], e)
        check(e == 0, f"vote_state == plain at {label} ({c1_.shape[0]} rows): max err {e}")

    state_case("the full g6 table", c1, c2, act)
    g = torch.Generator().manual_seed(0)
    for rows in (256, 2048):
        idx = torch.randperm(B, generator=g)[:rows].sort().values.to(dev)
        state_case(f"{rows} gathered rows", c1[idx].contiguous(), c2[idx].contiguous(), act)
    removed = act & (torch.rand(act.shape, generator=g).to(dev) < 0.3)
    state_case("the rebuild (30% of points removed)", c1, c2, act & ~removed)

    cfg4 = default_config(granularity=4)
    X4, act4, half4, dx4, nx4 = voting_problem(cfg4, frame, dev)
    _, c14, c24 = _pad_dirs_to_tile(*direction_tables(4, dev))
    hk = V.vote_histogram(X4, act4, c14, c24, half4, dx4, nx4, NX)
    hp = V.vote_histogram_plain(X4, act4, c14, c24, half4, dx4, nx4, NX)
    e = max_err(hk, hp)
    check(e == 0, f"vote_histogram == plain at g4 ({c14.shape[0]} rows): max err {e}")
    errs["vote_histogram"] = e
    n_rem = min(512, int(act4.sum()))
    rem = act4 & (torch.cumsum(act4.to(torch.int32), 0) <= n_rem)
    Xr = _compact_removed(X4, rem, n_rem).contiguous()
    live = torch.ones(n_rem, dtype=torch.bool, device=dev)
    hk = V.vote_histogram(Xr, live, c14, c24, half4, dx4, nx4, NX)
    hp = V.vote_histogram_plain(Xr, live, c14, c24, half4, dx4, nx4, NX)
    e = max_err(hk, hp)
    check(e == 0, f"vote_histogram == plain on a {n_rem}-column delta: max err {e}")
    errs["vote_histogram"] = max(errs["vote_histogram"], e)

    times = {
        "vote_state": (
            cuda_ms(lambda: V.vote_state(Xs, act, c1, c2, half, dx, nx, NX), 20),
            cuda_ms(lambda: V.vote_state_plain(Xs, act, c1, c2, half, dx, nx, NX), 3)),
        "vote_histogram": (
            cuda_ms(lambda: V.vote_histogram(X4, act4, c14, c24, half4, dx4, nx4, NX), 20),
            cuda_ms(lambda: V.vote_histogram_plain(X4, act4, c14, c24, half4, dx4, nx4, NX), 3)),
    }
    print(f"time  vote_state, full g6 table ({B} rows, N {Xs.shape[0]}): kernel "
          f"{times['vote_state'][0]:.4f} ms, plain {times['vote_state'][1]:.4f} ms "
          f"[{card}]", flush=True)
    print(f"time  vote_histogram, g4 ({c14.shape[0]} rows, N {X4.shape[0]}): kernel "
          f"{times['vote_histogram'][0]:.4f} ms, plain {times['vote_histogram'][1]:.4f} ms "
          f"[{card}]", flush=True)
    return errs, times


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
    from pointcloud_segmentation_tpu.config import default_config, StaticShapes
    from pointcloud_segmentation_tpu.io.scene import OBS_TESTS_SCENE, WP_TESTS, trajectory_poses
    from pointcloud_segmentation_tpu.io.simulator import TofSpec
    from pointcloud_segmentation_tpu.runtime.csvio import read_segments_csv
    from pointcloud_segmentation_tpu_torch import SegmentationEngine

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
    from pointcloud_segmentation_tpu.io.scene import OBS_TESTS_SCENE

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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: chip_smoke needs a CUDA card")
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    from pointcloud_segmentation_tpu.config import default_config
    from pointcloud_segmentation_tpu.io.scene import OBS_TESTS_SCENE, WP_TESTS, trajectory_poses
    from pointcloud_segmentation_tpu.io.simulator import TofSpec
    from pointcloud_segmentation_tpu_torch import _build
    from pointcloud_segmentation_tpu_torch.ops import voting as V
    from pointcloud_segmentation_tpu_torch.ops.hough import KERNELS, PLAIN

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s to build and load "
          f"({_build.BuildInfo.seconds:.2f} s in nvcc) -> {_build.BuildInfo.path}", flush=True)
    for line in _build.BuildInfo.log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("ptxas " + line.strip(), flush=True)

    # the full-size replay: shipped config, default StaticShapes, 64x64 ToF
    poses = trajectory_poses(WP_TESTS, hz=2.0, velocity=0.25)
    frames = frames_of(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.002), 0)
    check(len(frames) == 31, f"{len(frames)} frames in the full-size replay")

    errs, times = kernel_checks(dev, frames[len(frames) // 2], card)
    golden_checks(dev)

    cfg6 = default_config()
    cfg4 = default_config(granularity=4)
    check(cfg6.voting_mode == "lazy" and cfg4.voting_mode == "carry",
          "g6 resolves to lazy voting, g4 to carry")

    # the main path, counted: the shipped g6 replay (lazy, vote_state), then
    # the g4 replay (carry, vote_histogram)
    V.vote_state.launches = 0
    V.vote_histogram.launches = 0
    k6 = replay(cfg6, frames, dev, KERNELS)
    n_state_g6, n_hist_g6 = V.vote_state.launches, V.vote_histogram.launches
    k4 = replay(cfg4, frames, dev, KERNELS)
    launches = {"vote_state": V.vote_state.launches,
                "vote_histogram": V.vote_histogram.launches}
    print(f"launches on the main path: g6 vote_state {n_state_g6}, vote_histogram "
          f"{n_hist_g6}; g4 vote_histogram {launches['vote_histogram'] - n_hist_g6}",
          flush=True)
    check(n_state_g6 > 0, f"g6 replay launched vote_state {n_state_g6} times")
    check(launches["vote_histogram"] > n_hist_g6,
          f"g4 replay launched vote_histogram {launches['vote_histogram'] - n_hist_g6} times")

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

    k6b = replay(cfg6, frames, dev, KERNELS)
    same = all(np.array_equal(k6["state"][f], k6b["state"][f], equal_nan=True)
               for f in k6["state"])
    check(same, "g6 replay run twice: bit-identical world state (deterministic)")

    def ms_per_frame(run):
        return statistics.median(r["processing_time"] for r in run["records"]) / 1e3

    for label, kr, pr, kr2 in (("g6 lazy", k6, p6, k6b), ("g4 carry", k4, p4, None)):
        extra = f", second kernel run {ms_per_frame(kr2):.3f}" if kr2 else ""
        print(f"time  replay {label}, {len(frames)} frames, median ms/frame: kernels "
              f"{ms_per_frame(kr):.3f}{extra}, plain {ms_per_frame(pr):.3f} [{card}]",
              flush=True)

    sources = {"vote_state": "tools/exp_g6_pallas.py:156",
               "vote_histogram": "pointcloud_segmentation_tpu/ops/voting_pallas.py:49"}
    kernels = [{"name": name, "route": "cuda",
                "source": "pointcloud_segmentation_tpu_torch/csrc/voting.cu",
                "replaces": sources[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": times[name][0],
                "plain_ms": times[name][1]}
               for name in ("vote_state", "vote_histogram")]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
