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

Results are appended to SOAK_torch.json at the repo's root (``--artifact``
names another file, ``--no-artifact`` skips it), in the layout of the JAX
soak's SOAK.json, which this tool only ever reads.

Against the JAX soak's record, seed for seed:

    python tools/parity_soak_torch.py 30 5000 --device cpu --against-jax
    python tools/parity_soak_torch.py --jax-batches --g6 --device cuda

``--against-jax`` stores `compare_with_jax`'s sets (seeds divergent on both
sides, on one side only, under different classes) as the batch's
``"jax_soak"`` field; the seeds must lie in SOAK.json's batches of the same
mode.  ``--jax-batches`` runs SOAK.json's batches in turn (each one's mode,
f64, first seed and count) with ``--against-jax``: every batch, or with
``--g6``, ``--sensor128`` or ``--f64`` only the batches of that mode or of
the float64 parity mode, so that modes can run as parallel processes.

Witnesses of the knife edge:

    python tools/parity_soak_torch.py 1 5011 --device cpu --witness
    python tools/parity_soak_torch.py --witness-stored --g6 --device cuda

``--witness`` traces each divergent seed of the batches it runs frame by
frame (`knife_edge_trace`) and stores the verdicts (`witness`: each flip's
frame, round and other side's |b.x|, and `bx_stats` of the refinements where
the sides agree) as the batch's ``"witness"`` field; ``--witness-stored``
runs no batch and does the same for the artifact's stored batches on
``--device`` that have none.

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
JAX_SOAK = os.path.join(ROOT, "SOAK.json")
# the classes of a divergence that the soak documents; any other is a fault
DOCUMENTED = ("bx-knife-edge", "f32-gate-boundary")
# a refined direction with |b.x| below this lies in the y-z plane to within
# the rounding of float32 input coordinates: whether b.x comes out as exactly
# 0.0 there is eigensolver noise
BX_NOISE = 1e-6
# two refined directions further apart than this (rad) belong to different
# lines: more than float32 rounding, well under the g6 grid's spacing
SAME_DIRECTION = 1e-3


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


def knife_edge_trace(seed: int, mode: str = "base", f64: bool = False,
                     device: str = "cuda") -> dict:
    """One seed on both backends, frame by frame.  For each backend: every
    frame's status and line count, and the b.x of every direction its Hough
    loop refined, in order (the value the reference aborts on when it is
    exactly 0.0), and that direction whole (``b``): the oracle's read by
    tapping its canonicalize_direction for the run, the torch backend's from
    each round's gates (ops/gates.py, the kernel on a card), which its
    host-driven frame (``loop="eager"``) calls as the rounds run, ending
    with the frame's last live round.  ``errors`` is `compare_worlds` of the two world maps."""
    from pointcloud_segmentation_tpu_torch.ops.hough import KERNELS, Voting
    from pointcloud_segmentation_tpu_torch.oracle import _geometry
    from pointcloud_segmentation_tpu_torch.runtime import SegmentationEngine

    cfg, frames = random_case(seed, mode, f64)
    out = {}
    orig = _geometry.canonicalize_direction
    for backend in ("oracle", "torch"):
        bx, bs = [], []

        def note(b, _bx=bx, _bs=bs):
            _bx[-1].append(float(b[0]))
            _bs[-1].append([float(v) for v in b])

        def tap(b, *a, **k):
            b = orig(b, *a, **k)
            note(b)
            return b

        def gates(*args):
            g = KERNELS.round_gates(*args)
            note(g.bc)
            return g

        kw = {"voting": Voting(*KERNELS[:3], gates)} if backend == "torch" else {}
        _geometry.canonicalize_direction = tap if backend == "oracle" else orig
        try:
            eng = SegmentationEngine(cfg, backend=backend, device=device, loop="eager", **kw)
            recs = []
            for fr in frames:
                bx.append([])
                bs.append([])
                eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
                recs.append(eng.process_frame(fr.t, fr.points))
        finally:
            _geometry.canonicalize_direction = orig
        out[backend] = {"status": [r["status"] for r in recs],
                        "nblines": [r["nblines"] for r in recs],
                        "bx": bx, "b": bs, "world": eng.world_snapshot()}
    out["errors"] = compare_worlds(out["oracle"]["world"], out["torch"]["world"])
    return out


def knife_edge_frames(trace: dict) -> list:
    """Each frame of a `knife_edge_trace`, judged: ``same`` when no refined
    direction's b.x is 0.0 on one side only and status and line count agree;
    ``knife-edge`` when the first refinement with b.x == 0.0 on one side only
    has |b.x| < BX_NOISE on the other, a direction that differs from one
    with b.x == 0.0 by rounding alone; ``unexplained`` otherwise."""
    o, t = trace["oracle"], trace["torch"]
    out = []
    for i, (bo, bt) in enumerate(zip(o["bx"], t["bx"])):
        flip = next((k for k, (x, y) in enumerate(zip(bo, bt))
                     if (x == 0.0) != (y == 0.0)), None)
        v = {"frame": i, "status": [o["status"][i], t["status"][i]]}
        if flip is not None:
            other = max(abs(bo[flip]), abs(bt[flip]))
            v.update(verdict="knife-edge" if other < BX_NOISE else "unexplained",
                     round=flip, other_bx=other)
        elif o["status"][i] == t["status"][i] and o["nblines"][i] == t["nblines"][i]:
            v.update(verdict="same")
        else:
            v.update(verdict="unexplained")
        out.append(v)
    return out


def knife_edge_explained(trace: dict) -> bool:
    """The seed's worlds agree, or their divergence has its witness: no
    frame unexplained and at least one frame on the knife edge."""
    verdicts = [v["verdict"] for v in knife_edge_frames(trace)]
    return not trace["errors"] or ("unexplained" not in verdicts
                                   and "knife-edge" in verdicts)


def agreeing_bx(trace: dict) -> list:
    """(oracle b.x, port b.x) of each refinement where the two sides agree:
    on the abort (b.x exactly 0.0 on both or on neither), and on the
    direction (within SAME_DIRECTION rad, where the trace holds the whole
    directions; two loops that picked different lines are no measure of
    rounding), frame by frame up to the frame's first flip."""
    o, t = trace["oracle"], trace["torch"]
    pairs = []
    for k, (bo, bt) in enumerate(zip(o["bx"], t["bx"])):
        for j, (x, y) in enumerate(zip(bo, bt)):
            if (x == 0.0) != (y == 0.0):
                break
            if "b" in o and "b" in t:
                u, v = np.asarray(o["b"][k][j]), np.asarray(t["b"][k][j])
                cos = abs(u @ v) / (np.linalg.norm(u) * np.linalg.norm(v))
                if np.arccos(min(cos, 1.0)) > SAME_DIRECTION:
                    continue
            pairs.append((x, y))
    return pairs


def bx_stats(pairs: list) -> dict:
    """Of (oracle b.x, port b.x) pairs at agreeing refinements: the smallest
    nonzero |b.x| on either side, the smallest at or above BX_NOISE, and the
    largest gap between the sides where the oracle's |b.x| is below
    BX_NOISE (how far the sides part on a direction the oracle puts in the
    y-z plane).  None where no pair qualifies."""
    vals = [abs(v) for p in pairs for v in p if v != 0.0]
    gaps = [abs(x - y) for x, y in pairs if abs(x) < BX_NOISE]
    return {"agreeing": len(pairs),
            "min_nonzero": min(vals, default=None),
            "min_above_noise": min((v for v in vals if v >= BX_NOISE), default=None),
            "max_inplane_gap": max(gaps, default=None)}


def merge_bx_stats(stats: list) -> dict:
    """`bx_stats` of several traces as one."""
    def pick(key, fn):
        vals = [s[key] for s in stats if s[key] is not None]
        return fn(vals) if vals else None

    return {"agreeing": sum(s["agreeing"] for s in stats),
            "min_nonzero": pick("min_nonzero", min),
            "min_above_noise": pick("min_above_noise", min),
            "max_inplane_gap": pick("max_inplane_gap", max)}


def witness(seed: int, mode: str, f64: bool, device: str) -> dict:
    """One seed's `knife_edge_trace`, judged and kept small: the statuses,
    the world errors, each flip (frame, round, the other side's |b.x|),
    the frames left unexplained, whether the divergence is explained, and
    the trace's `bx_stats`."""
    tr = knife_edge_trace(seed, mode, f64, device)
    frames = knife_edge_frames(tr)
    return {"seed": seed, "f64": f64,
            "status": {"oracle": tr["oracle"]["status"], "torch": tr["torch"]["status"]},
            "errors": tr["errors"],
            "flips": [{"frame": v["frame"], "round": v["round"], "other_bx": v["other_bx"]}
                      for v in frames if v["verdict"] == "knife-edge"],
            "unexplained_frames": [v["frame"] for v in frames
                                   if v["verdict"] == "unexplained"],
            "explained": knife_edge_explained(tr),
            "bx": bx_stats(agreeing_bx(tr))}


def witness_batch(batch: dict, device: str) -> list:
    """`witness` of every seed the batch holds divergent."""
    out = []
    for d in batch["diverging"]:
        w = witness(d["seed"], batch["mode"], batch["f64"], device)
        print(f"witness: seed {d['seed']} ({batch['mode']}, f64={batch['f64']}) on {device}: "
              f"{'explained' if w['explained'] else 'UNEXPLAINED'}; flips (frame, round, "
              f"other side's |b.x|) {[(f['frame'], f['round'], f['other_bx']) for f in w['flips']]}",
              flush=True)
        out.append(w)
    return out


def witness_stored(path: str, device: str, mode=None, f64_only: bool = False) -> bool:
    """Trace the divergent seeds of every batch stored in `path` that ran on
    `device` (of `mode`, and float64 only with f64_only, when given) and has
    no ``"witness"`` yet, and store each batch's witnesses in place.  True
    iff a seed is left unexplained."""
    import fcntl

    def key(b):
        return (b["mode"], bool(b["f64"]), b["device"], b["seed_start"], b["n"])

    with open(path) as f:
        todo = [b for b in json.load(f).get("batches", [])
                if b["device"] == device and b["diverging"] and "witness" not in b
                and (mode is None or b["mode"] == mode) and (b["f64"] or not f64_only)]
    done = {key(b): witness_batch(b, device) for b in todo}
    with open(path + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        with open(path) as f:
            data = json.load(f)
        for b in data["batches"]:
            if key(b) in done and "witness" not in b:
                b["witness"] = done[key(b)]
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
    print(f"witness: {sum(map(len, done.values()))} seeds of {len(done)} stored batches "
          f"on {device}", flush=True)
    return any(not w["explained"] for ws in done.values() for w in ws)


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


def load_jax_soak() -> dict:
    """The JAX soak's record, `JAX_SOAK`, read as JSON, never written."""
    with open(JAX_SOAK) as f:
        return json.load(f)


def jax_batches_for(mode: str, f64: bool, s0: int, n: int, jax_soak: dict) -> list:
    """The JAX soak's batches of `mode` and `f64` that hold seeds s0 ..
    s0+n-1, in seed order.  Raises ValueError when one of those seeds is in
    none of them: there is nothing to compare it with."""
    left = set(range(s0, s0 + n))
    found = []
    for b in sorted(jax_soak.get("batches", []), key=lambda b: b["seed_start"]):
        if b["mode"] != mode or bool(b["f64"]) != bool(f64):
            continue
        held = left & set(range(b["seed_start"], b["seed_start"] + b["n"]))
        if held:
            found.append(b)
            left -= held
    if left:
        raise ValueError(f"SOAK.json holds no {mode} batch (f64={f64}) with seeds "
                         f"{sorted(left)}")
    return found


def compare_with_jax(batch: dict, jax_soak: dict) -> dict:
    """A soak batch of this tool beside the JAX soak's record of the same
    seeds, mode and f64: ``both`` lists the seeds divergent on both sides
    with each side's class, ``only_port`` and ``only_jax`` those divergent on
    one side, ``class_differs`` those of ``both`` whose classes differ.  A
    seed is ``unexplained`` when a divergent side's class is not one the
    soak documents: a port class of ``real`` is always so.  A seed
    divergent in the JAX soak alone is explained by the JAX class, since the
    port matched the oracle there."""
    s0, n = batch["seed_start"], batch["n"]
    jbs = jax_batches_for(batch["mode"], batch["f64"], s0, n, jax_soak)
    seeds = range(s0, s0 + n)
    jax = {d["seed"]: d["class"] for b in jbs for d in b["diverging"] if d["seed"] in seeds}
    port = {d["seed"]: d["class"] for d in batch["diverging"]}
    both = [{"seed": s, "port": port[s], "jax": jax[s]}
            for s in sorted(port.keys() & jax.keys())]
    only_port = [{"seed": s, "port": port[s]} for s in sorted(port.keys() - jax.keys())]
    only_jax = [{"seed": s, "jax": jax[s]} for s in sorted(jax.keys() - port.keys())]
    unexplained = sorted({s for s, k in port.items() if k not in DOCUMENTED}
                         | {d["seed"] for d in only_jax if d["jax"] not in DOCUMENTED})
    return {
        "jax_batch": [{"rev": b.get("rev", ""), "seed_start": b["seed_start"],
                       "n": b["n"]} for b in jbs],
        "both": both, "only_port": only_port, "only_jax": only_jax,
        "class_differs": [d for d in both if d["port"] != d["jax"]],
        "unexplained": unexplained,
    }


def _device_name(device: str) -> str:
    if not device.startswith("cuda"):
        return "cpu"
    import torch

    return torch.cuda.get_device_name(torch.device(device))


def _rev() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True, cwd=ROOT).stdout.strip()
    except OSError:
        return ""


def soak_batch(n: int, s0: int, mode: str, f64: bool, device: str, verify: bool,
               jax_soak, artifact, with_witness: bool = False) -> bool:
    """One batch: run it, compare it with the JAX soak's record when one is
    given, trace its divergent seeds when `with_witness`, append it to
    `artifact` unless that is None.  True iff it holds an unexplained
    divergence."""
    batch = run_batch(n, s0, mode, f64, device, verify)
    bad = bool(batch["counts"].get("real"))
    extra = {}
    if with_witness:
        extra["witness"] = witness_batch(batch, device)
        bad = bad or not all(w["explained"] for w in extra["witness"])
    if jax_soak is not None:
        cmp = compare_with_jax(batch, jax_soak)
        extra["jax_soak"] = cmp
        bad = bad or bool(cmp["unexplained"])
        seeds = {k: [d["seed"] for d in cmp[k]]
                 for k in ("both", "only_port", "only_jax", "class_differs")}
        print(f"against SOAK.json ({mode}, f64={f64}, seeds {s0}-{s0 + n - 1}): "
              + ", ".join(f"{k} {v}" for k, v in seeds.items())
              + f", unexplained {cmp['unexplained']}", flush=True)
    if artifact is not None:
        batch = dict(batch, rev=_rev(), device_name=_device_name(device), **extra)
        data = persist_batch(batch, artifact)
        print(f"{os.path.basename(artifact)}: {data['totals']}", flush=True)
    return bad


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
    ap.add_argument("--artifact", help="the file batches are appended to "
                                       "(default: SOAK_torch.json at the repo's root)")
    ap.add_argument("--against-jax", action="store_true",
                    help="store the comparison with SOAK.json's batch as \"jax_soak\"")
    ap.add_argument("--jax-batches", action="store_true",
                    help="run SOAK.json's batches, with --against-jax: every "
                         "one, or those of the mode or dtype the flags name")
    ap.add_argument("--witness", action="store_true",
                    help="trace each divergent seed of the batches run and store "
                         "the verdicts as the batch's \"witness\"")
    ap.add_argument("--witness-stored", action="store_true",
                    help="run no batch: trace the divergent seeds of the artifact's "
                         "batches on --device that have no witness (those of the "
                         "mode or dtype the flags name) and store it in place")
    args = ap.parse_args(argv)
    mode = "g6" if args.g6 else "sensor128" if args.sensor128 else "base"
    if args.witness_stored:
        named = "g6" if args.g6 else "sensor128" if args.sensor128 else None
        return 1 if witness_stored(args.artifact or ARTIFACT, args.device, named,
                                   args.f64) else 0

    jax_soak = load_jax_soak() if args.jax_batches or args.against_jax else None
    if args.jax_batches:
        jobs = [(b["n"], b["seed_start"], b["mode"], b["f64"])
                for b in jax_soak["batches"]
                if (b["mode"] == mode or not (args.g6 or args.sensor128))
                and (b["f64"] or not args.f64)]
    else:
        jobs = [(args.n_iters, args.start_seed, mode, args.f64)]
        if jax_soak is not None:     # refuse seeds SOAK.json never ran, before running
            try:
                jax_batches_for(mode, args.f64, args.start_seed, args.n_iters, jax_soak)
            except ValueError as e:
                ap.error(str(e))
    artifact = None if args.no_artifact else (args.artifact or ARTIFACT)
    bad = [soak_batch(n, s0, m, f64, args.device, not args.no_verify, jax_soak, artifact,
                      args.witness)
           for n, s0, m, f64 in jobs]
    # only unexplained divergences fail the soak
    return 1 if any(bad) else 0


if __name__ == "__main__":
    sys.exit(main())
