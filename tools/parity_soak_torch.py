"""Randomized end-to-end parity soak of the PyTorch port: numpy oracle vs the
port's pipeline.

Twin of tools/parity_soak.py for `pointcloud_segmentation_tpu_torch`: the
same randomly drawn configurations and scenes for the same seeds (the draws
are made in the same order), full replays on the port's oracle backend and on
its torch backend, and the same comparison of the resulting world maps
(segment count, matched endpoints, radii, intersection topology).  Any
mismatch prints a self-contained repro line.  It imports torch and numpy,
never jax.

    python tools/parity_soak_torch.py [n_iters] [start_seed] --device cpu
    python tools/parity_soak_torch.py 6 3000 --device cuda        # on a card

``--device`` is the torch backend's device: ``cuda`` (the default, the hand
kernels; raises without a card) or ``cpu`` (the kernels' plain versions).

Coverage modes (mutually exclusive flags; default draws granularity 1-3 on a
32x32 sensor, which resolves to carry voting and the vote_histogram kernel):

    --g6         granularity-6 configs (20,481 directions, the shipped
                 count), which resolve to lazy voting and the vote_state
                 kernel; smaller clouds and frame budgets keep the oracle
                 tractable on the host
    --sensor128  128x128 ToF frames (16,384 rays)
    --f64        run the port in its float64 parity mode

Results are appended to SOAK_torch.json at the repo's root (``--no-artifact``
skips that), in the layout of the JAX soak's SOAK.json, which this tool never
touches.

Mismatches are CLASSIFIED, into the two classes the JAX soak documents; any
other is ``real``, is reported with its seed and fails the soak:

* ``bx-knife-edge``: the reference's frame abort on exact ``b.x == 0.0``
  (hough_3d_lines.h:43-45) on zero-noise, axis-aligned synthetic scenes, where
  which iteration rounds to exactly 0.0 is decided by eigensolver float noise.
  Detected when either side reports the BX_ZERO status anywhere in the run.
* ``f32-gate-boundary``: adversarial random configs put candidates exactly on
  acceptance-gate thresholds where the float32 pipeline and the float64
  oracle legitimately flip.  The seed is rerun in the float64 parity mode (in
  this process: the port needs no global switch for it) and belongs to this
  class only if that run matches the oracle exactly.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

STATUS_BX_ZERO = 3
ARTIFACT = os.path.join(ROOT, "SOAK_torch.json")


def random_cfg(rng, mode: str = "base", f64: bool = False):
    """The JAX soak's `random_cfg`, draw for draw, as a config of the port."""
    from pointcloud_segmentation_tpu_torch.config import StaticShapes, default_config

    dtype = "float64" if f64 else "float32"
    if mode == "g6":
        # every such config resolves voting to "lazy".  Every 8th draw pins a
        # min radius of 0.012 (num_x = 326), which costs the oracle tens of
        # CPU-minutes a seed, so it is rationed rather than drawn uniformly.
        if rng.integers(0, 8) == 0:
            radii = [0.012, float(rng.choice([0.05, 0.08, 0.1]))]
        else:
            nrad = int(rng.integers(1, 3))
            radii = sorted(rng.choice([0.03, 0.05, 0.08, 0.1], size=nrad,
                                      replace=False).tolist())
        radii = sorted(radii)
        cfg = default_config(
            granularity=6,
            opt_minvotes=int(rng.integers(6, 14)),
            opt_nlines=int(rng.choice([0, 4, 10])),
            min_pca_coeff=float(rng.choice([0.9, 0.95, 0.995])),
            rad_2_leaf_ratio=float(rng.choice([1.5, 2.0])),
            floor_trim_height=float(rng.choice([0.0, 0.3])),
            radius_sizes=tuple(radii),
            surface_offset_correction=bool(rng.integers(0, 2)),
            shapes=StaticShapes(max_raw_points=1024, max_points=512,
                                max_world_segments=32),
            compute_dtype=dtype,
        )
        assert cfg.voting_mode == "lazy"
        return cfg
    nrad = rng.integers(1, 3)
    radii = sorted(rng.choice([0.03, 0.05, 0.08, 0.1], size=nrad,
                              replace=False).tolist())
    shapes = (StaticShapes(max_raw_points=16384, max_points=6144,
                           max_world_segments=32) if mode == "sensor128"
              else StaticShapes(max_raw_points=2048, max_points=1024,
                                max_world_segments=32))
    return default_config(
        granularity=int(rng.integers(1, 4)),
        opt_minvotes=int(rng.integers(6, 16)),
        opt_nlines=int(rng.choice([0, 4, 10])),
        min_pca_coeff=float(rng.choice([0.9, 0.95, 0.995])),
        rad_2_leaf_ratio=float(rng.choice([1.5, 2.0])),
        floor_trim_height=float(rng.choice([0.0, 0.3])),
        radius_sizes=tuple(radii),
        surface_offset_correction=bool(rng.integers(0, 2)),
        shapes=shapes,
        compute_dtype=dtype,
    )


def random_case(seed: int, mode: str = "base", f64: bool = False):
    """(cfg, frames) of one seed: the config, then the scene and the flight,
    drawn from one generator in the JAX soak's order."""
    from pointcloud_segmentation_tpu_torch.io.scene import simple_scene
    from pointcloud_segmentation_tpu_torch.io.simulator import (TofSpec,
                                                                simulate_trajectory)

    rng = np.random.default_rng(seed)
    cfg = random_cfg(rng, mode, f64)
    # beams at ANY drawn radius (not always the smallest): multi-radius
    # configs must exercise radius matching against every table entry
    scene = simple_scene(n_beams=int(rng.integers(2, 6)),
                         radius=float(rng.choice(cfg.radius_sizes)),
                         seed=seed)
    n = int(rng.integers(3, 6)) if mode == "g6" else int(rng.integers(4, 10))
    poses = [(float(i), np.array([0.0, 0.0, 0.5 + 0.15 * i]),
              np.array([1.0, 0.0, 0.0, 0.0])) for i in range(n)]
    side = 128 if mode == "sensor128" else 32
    frames = simulate_trajectory(
        scene, poses,
        TofSpec(width=side, height=side,
                noise_frac=float(rng.choice([0.0, 0.002]))),
        seed=seed + 1)
    return cfg, frames


def compare_worlds(oracle_out, port_out) -> list:
    """The soak's comparison of two (world_segments, intersections_rows)
    pairs: a list of error strings, empty when they agree."""
    errs = []
    so, sj = oracle_out[0], port_out[0]
    if len(so) != len(sj):
        errs.append(f"segment count {len(so)} vs {len(sj)}")
    for i, (a, b) in enumerate(zip(so, sj)):
        for k in ("t_min", "t_max", "radius"):
            if abs(a[k] - b[k]) > 5e-2:
                errs.append(f"seg{i}.{k}: {a[k]:.6g} vs {b[k]:.6g}")
        pa1 = np.asarray(a["a"]) + a["t_min"] * np.asarray(a["b"])
        pb1 = np.asarray(b["a"]) + b["t_min"] * np.asarray(b["b"])
        pa2 = np.asarray(a["a"]) + a["t_max"] * np.asarray(a["b"])
        pb2 = np.asarray(b["a"]) + b["t_max"] * np.asarray(b["b"])
        d = max(np.linalg.norm(pa1 - pb1), np.linalg.norm(pa2 - pb2))
        dr = max(np.linalg.norm(pa1 - pb2), np.linalg.norm(pa2 - pb1))
        if min(d, dr) > 5e-2:
            errs.append(f"seg{i} endpoints drift {min(d, dr):.4g}")
    io_ = set((r[0], r[2]) for r in oracle_out[1])
    ij = set((r[0], r[2]) for r in port_out[1])
    if io_ != ij:
        errs.append(f"intersection topology {sorted(io_)} vs {sorted(ij)}")
    return errs


def run_pair(seed: int, mode: str = "base", f64: bool = False,
             device: str = "cuda") -> tuple:
    """One seed on both backends: (errors, class).  The class is "real"
    unless a documented divergence explains the errors."""
    from pointcloud_segmentation_tpu_torch.runtime import SegmentationEngine

    cfg, frames = random_case(seed, mode, f64)
    print(f"seed {seed} cfg: g{cfg.granularity} radii={cfg.radius_sizes} "
          f"nlines={cfg.opt_nlines} minvotes={cfg.opt_minvotes} "
          f"voting={cfg.voting_mode} dtype={cfg.compute_dtype}", flush=True)

    outs = {}
    statuses = {}
    for backend in ("oracle", "torch"):
        eng = SegmentationEngine(cfg, backend=backend, device=device)
        recs = eng.run_replay(frames)
        statuses[backend] = [r.get("status") for r in recs]
        outs[backend] = eng.world_snapshot()

    errs = compare_worlds(outs["oracle"], outs["torch"])
    klass = "real"
    if errs and (STATUS_BX_ZERO in statuses["oracle"]
                 or STATUS_BX_ZERO in statuses["torch"]):
        # any aborted frame taints the run: WHICH iteration hits the exact
        # b.x == 0 (and hence which already-accepted segments survive the
        # abort) is eigensolver-noise-determined, even when the per-frame
        # status columns agree
        klass = "bx-knife-edge"
    elif errs and not f64:
        klass = "f32-gate-boundary?"  # to be verified in float64
    return errs, klass


def classify(seed: int, mode: str, f64: bool, device: str, verify: bool) -> tuple:
    """run_pair with the f32-gate-boundary suspects verified: (errors, class,
    f64_matches_oracle or None).  A crash on either backend is a finding."""
    try:
        errs, klass = run_pair(seed, mode, f64, device)
    except Exception as e:
        return [f"EXCEPTION {type(e).__name__}: {e}"], "real", None
    f64_ok = None
    if errs and klass == "f32-gate-boundary?" and verify:
        # a suspect that still mismatches in float64 is a real divergence
        try:
            f64_ok = not run_pair(seed, mode, True, device)[0]
        except Exception:
            f64_ok = False
        klass = "f32-gate-boundary" if f64_ok else "real"
    return errs, klass, f64_ok


def merge_batch(data: dict, batch: dict) -> dict:
    """Pure: append one soak batch to the cumulative payload and recompute
    the totals block.  Totals sum across batches; ``unexplained`` is the
    cross-batch sum of class ``real``, the only class that fails a soak."""
    data = dict(data or {})
    batches = list(data.get("batches", [])) + [batch]
    per_class = {}
    for b in batches:
        for k, v in b.get("counts", {}).items():
            per_class[k] = per_class.get(k, 0) + v
    data["batches"] = batches
    data["totals"] = {
        "seeds_run": sum(b["n"] for b in batches),
        "diverging_by_class": per_class,
        "unexplained": per_class.get("real", 0),
    }
    return data


def persist_batch(batch: dict, path: str) -> dict:
    """Append ``batch`` to the cumulative soak artifact at `path`.  The
    read-modify-write holds an flock on ``<path>.lock`` (batches of different
    modes may run as parallel processes) and the result lands by
    write-to-temp and os.replace, so a crash cannot leave a torn file."""
    import fcntl

    with open(path + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        data = merge_batch(data, batch)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
    return data


def run_batch(n: int, s0: int, mode: str = "base", f64: bool = False,
              device: str = "cuda", verify: bool = True) -> dict:
    """Seeds s0 .. s0+n-1 as one batch record (see `merge_batch`)."""
    counts = {}
    diverging = []
    t0 = time.time()
    for seed in range(s0, s0 + n):
        errs, klass, f64_ok = classify(seed, mode, f64, device,
                                       verify and not f64)
        if errs:
            counts[klass] = counts.get(klass, 0) + 1
            diverging.append({"seed": seed, "class": klass,
                              "f64_matches_oracle": f64_ok, "errors": errs})
            print(f"SEED {seed} MISMATCH [{klass}]: " + "; ".join(errs), flush=True)
        else:
            print(f"seed {seed} ok", flush=True)
    print(f"done: {sum(counts.values())}/{n} diverging seeds by class: "
          f"{counts or '{}'}", flush=True)
    return {
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "mode": mode, "f64": f64, "device": device,
        "seed_start": s0, "n": n,
        "duration_s": round(time.time() - t0, 1),
        "counts": counts, "diverging": diverging,
    }


def _device_name(device: str) -> str:
    if not device.startswith("cuda"):
        return "cpu"
    import torch

    return torch.cuda.get_device_name(torch.device(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_iters", nargs="?", type=int, default=50)
    ap.add_argument("start_seed", nargs="?", type=int, default=1000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--f64", action="store_true")
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--g6", action="store_true")
    group.add_argument("--sensor128", action="store_true")
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--no-artifact", action="store_true")
    args = ap.parse_args(argv)
    mode = "g6" if args.g6 else "sensor128" if args.sensor128 else "base"

    batch = run_batch(args.n_iters, args.start_seed, mode, args.f64,
                      args.device, not args.no_verify)
    if not args.no_artifact:
        try:
            rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                                 capture_output=True, text=True,
                                 cwd=ROOT).stdout.strip()
        except OSError:
            rev = ""
        batch = dict(batch, rev=rev, device_name=_device_name(args.device))
        data = persist_batch(batch, ARTIFACT)
        print(f"SOAK_torch.json: {data['totals']}", flush=True)
    # only unexplained ("real") divergences fail the soak
    return 1 if batch["counts"].get("real") else 0


if __name__ == "__main__":
    sys.exit(main())
