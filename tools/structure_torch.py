"""Whole-structure flights of the PyTorch port, held frame by frame against
the numpy oracle.

Each flight maps a steel structure the way the JAX package's own code flies
it (`FLIGHTS`: the lattice tower of bench.py's tower replay, the 20-beam
mockup of tests/test_mockup.py, the dev world's figure eight of
tests/test_devworld.py, its multi-radius quirk, and the flight of
examples/map_a_structure_torch.py), rebuilt from the port's own io.scene and
io.simulator.  A run of one flight at one granularity (4: carry voting and
the vote_histogram kernel; 6, the shipped one: lazy voting and the
vote_state kernel) drives three engines over the same frames:

1. ``SegmentationEngine(cfg, device)``: the hand kernels on a card;
2. the same with ``voting=PLAIN`` (on a card only): the kernels' plain
   PyTorch versions at the shapes these flights give them;
3. ``SegmentationEngine(cfg, backend="oracle")``: the numpy oracle on the
   host, over the first ``--oracle-frames`` frames (0: all of them; the
   world map is sequential, so a cut keeps a prefix whole).

It holds, on the kernels' run: against the plain run, per-frame nblines,
status and world count (seg_vec_size) exact, the world's count, points_size
and radius exact, endpoints within 5e-3; against the oracle, the same
integers exact over the oracle's frames (radius as the float32 of the
oracle's table value), every world endpoint within 5e-3; for both, the
intersection count and the beams matched (eval.match_report) equal, and no
frame that overflowed the world map (the oracle's map has no capacity).  The
voting calls are counted by (rows, points, NX).

    python tools/structure_torch.py --device cuda              # every flight
    python tools/structure_torch.py --flight tower --granularity 6
    python tools/structure_torch.py --device cpu --flight mockup \\
        --granularity 3 --max-frames 6 --no-artifact

Each record is written to STRUCTURE_torch.json at the repo's root
(``--artifact`` names another file, ``--no-artifact`` skips it), replacing
the record of the same flight, granularity and device.  Exits 1 if a check
fails.  It imports torch and numpy, never jax.
"""

import argparse
import collections
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Callable, Optional, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ARTIFACT = os.path.join(ROOT, "STRUCTURE_torch.json")
ENDPOINT_TOL = 5e-3     # README §Precision contract: f32 endpoints, per segment
NOISE = 0.002           # the sensor noise of bench.py and the JAX tests
SEED = 0
SHAPES = (4096, 2048, 64)   # StaticShapes(max_raw_points, max_points, max_world_segments)
# the per-frame integers of an engine's records, held exact
FRAME_INTS = ("nblines", "status", "seg_vec_size")
# Checks that fail, by (flight, granularity), for the reason README
# §Precision contract documents: a segment whose direction lies in the y-z
# plane to within X_DIVISION_BX gets its extent from t = (p.x - a.x) / b.x
# (the reference's find_t), which multiplies the float32 rounding of p.x by
# 1 / |b.x|.  The checks stay failing; `unexplained` leaves them out.
X_DIVISION_BX = 1e-4
KNOWN_FAILURES = {("mockup", 4): (f"card_vs_oracle: endpoints within {ENDPOINT_TOL}",)}


def _tower():
    from pointcloud_segmentation_tpu_torch.io.scene import tower_scene

    return tower_scene(levels=2, width=1.0)


def _spiral():
    from pointcloud_segmentation_tpu_torch.io.scene import spiral_waypoints

    return spiral_waypoints(radius=1.2, z0=0.4, z1=2.2, turns=2.0, n=40)


def _mockup():
    from pointcloud_segmentation_tpu_torch.io.scene import mockup_scene

    return mockup_scene()


def _wp_mockup():
    from pointcloud_segmentation_tpu_torch.io.scene import WP_MOCKUP

    return WP_MOCKUP


def _dev():
    from pointcloud_segmentation_tpu_torch.io.scene import OBS_DEV_SCENE

    return OBS_DEV_SCENE


def _eight():
    from pointcloud_segmentation_tpu_torch.io.scene import figure_eight_waypoints

    return figure_eight_waypoints(a=1.8, z=1.7, n=32)


@dataclasses.dataclass(frozen=True)
class Flight:
    """One structure flight: the scene, the waypoints flown at `hz` and
    `velocity`, the frames it gives (the first `first` only, when set), the
    config keys it sets over default_config, the granularities it is flown
    at, and where the JAX package defines it."""

    scene: Callable
    waypoints: Callable
    hz: float
    velocity: float
    n_frames: int
    config: dict
    source: str
    first: int = 0
    granularities: Tuple[int, ...] = (4, 6)


FLIGHTS = {
    "tower": Flight(_tower, _spiral, 4.0, 0.4, 157, {"min_pca_coeff": 0.99},
                    "bench.py:378-389 (build_tower_frames)"),
    "mockup": Flight(_mockup, _wp_mockup, 1.0, 0.6, 72, {"min_pca_coeff": 0.99},
                     "tests/test_mockup.py:38-47"),
    "dev_r01": Flight(_dev, _eight, 1.0, 0.5, 32,
                      {"radius_sizes": (0.1,), "min_pca_coeff": 0.95},
                      "tests/test_devworld.py:45-58"),
    "dev_multi_radius": Flight(_dev, _eight, 1.0, 0.5, 8,
                               {"radius_sizes": (0.05, 0.1), "min_pca_coeff": 0.95},
                               "tests/test_devworld.py:69-79", first=8),
    # the default flight of examples/map_a_structure_torch.py, at its default
    # granularity only: at 6 the host oracle would take ~40 minutes
    "example": Flight(_tower, _spiral, 3.0, 0.2, 235, {"min_pca_coeff": 0.99},
                      "examples/map_a_structure_torch.py:38-52", granularities=(4,)),
}


def flight_frames(name: str, max_frames: int = 0):
    """(scene, frames) of a flight: the poses along its waypoints, cut to
    its first frames (and to `max_frames` when given), simulated with the
    64x64 ToF sensor at noise 0.002 from seed 0."""
    from pointcloud_segmentation_tpu_torch.io.scene import trajectory_poses
    from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec, simulate_trajectory

    fl = FLIGHTS[name]
    scene = fl.scene()
    poses = trajectory_poses(fl.waypoints(), hz=fl.hz, velocity=fl.velocity)
    if fl.first:
        poses = poses[:fl.first]
    if max_frames:
        poses = poses[:max_frames]
    return scene, simulate_trajectory(scene, poses, TofSpec(noise_frac=NOISE), seed=SEED)


def flight_config(name: str, granularity: int):
    from pointcloud_segmentation_tpu_torch.config import StaticShapes, default_config

    return default_config(granularity=granularity, shapes=StaticShapes(*SHAPES),
                          **FLIGHTS[name].config)


class Counted:
    """A voting function that counts its calls by (rows, points, NX)."""

    def __init__(self, fn):
        self.fn = fn
        self.shapes = collections.Counter()

    def __call__(self, Xs, active, c1, c2, half, dx, num_x, num_x_static):
        self.shapes[(c1.shape[0], Xs.shape[0], num_x_static)] += 1
        return self.fn(Xs, active, c1, c2, half, dx, num_x, num_x_static)


def recall(scene, segs) -> int:
    """Beams of the scene matched by a world segment (eval.match_report)."""
    from pointcloud_segmentation_tpu_torch.eval import match_report
    from pointcloud_segmentation_tpu_torch.io.scene import scene_truth

    rep = match_report(scene_truth(scene),
                       [dict(s, endpoints=[s["t_min"], s["t_max"]]) for s in segs])
    return rep["n_truth_matched"]


def world_of(scene, snapshot) -> dict:
    """A world map's count, points_size, radii, unit directions' x
    components, endpoints, intersections and (given its scene) beams
    matched."""
    segs, inter = snapshot
    return {"count": len(segs),
            "points_size": [int(s["points_size"]) for s in segs],
            "radius": [float(s["radius"]) for s in segs],
            "b_x": [float(s["b"][0] / np.linalg.norm(np.asarray(s["b"], np.float64)))
                    for s in segs],
            "endpoints": [[list(map(float, np.asarray(s["a"], np.float64) + s[t]
                                    * np.asarray(s["b"], np.float64)))
                           for t in ("t_min", "t_max")] for s in segs],
            "intersections": len(inter),
            "topology": sorted([int(i), int(j)] for i, _, j, _ in inter),
            "recall": None if scene is None else recall(scene, segs)}


def fly(cfg, scene, frames, backend="torch", device="cpu", voting=None,
        snapshot_after: Optional[int] = None, loop: Optional[str] = None) -> dict:
    """One engine over the frames: each frame's integers, the world map at
    the end (and after the first `snapshot_after` frames, when that cuts
    the flight), the frames that overflowed the world map, and seconds;
    also, for `frame_drift`, the world's endpoints after each frame.
    `loop`: the engine's frame loop (its default when None)."""
    from pointcloud_segmentation_tpu_torch import SegmentationEngine

    kw = {} if voting is None else {"voting": voting}
    if loop is not None:
        kw["loop"] = loop
    eng = SegmentationEngine(cfg, device=device, backend=backend, **kw)
    out = {k: [] for k in FRAME_INTS + ("endpoints_by_frame",)}
    cut = None
    t0 = time.perf_counter()
    for k, fr in enumerate(frames):
        eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
        rec = eng.process_frame(fr.t, fr.points)
        for f in FRAME_INTS:
            out[f].append(int(rec[f]))
        out["endpoints_by_frame"].append(world_of(None, eng.world_snapshot())["endpoints"])
        if snapshot_after is not None and k + 1 == snapshot_after < len(frames):
            cut = world_of(scene, eng.world_snapshot())
    out["seconds"] = time.perf_counter() - t0
    out["world"] = world_of(scene, eng.world_snapshot())
    out["world_at_cut"] = cut
    out["world_overflow_frames"] = eng.world_overflow_frames
    return out


def fly_flight(name: str, granularity: int, backend: str) -> dict:
    """`fly` of a flight of `FLIGHTS` at a granularity on the CPU, by name
    (a function another process can run)."""
    scene, frames = flight_frames(name)
    return fly(flight_config(name, granularity), scene, frames, backend=backend)


def endpoint_errors(got: list, want: list) -> list:
    """Per segment, the errors of its two endpoints against the same
    segment of the other map, in the pairing (as stored or swapped) whose
    larger error is smaller."""
    errs = []
    for (p1, p2), (q1, q2) in zip(got, want):
        p1, p2, q1, q2 = (np.asarray(v, np.float64) for v in (p1, p2, q1, q2))
        same = [float(np.linalg.norm(p1 - q1)), float(np.linalg.norm(p2 - q2))]
        swap = [float(np.linalg.norm(p1 - q2)), float(np.linalg.norm(p2 - q1))]
        errs.append(same if max(same) <= max(swap) else swap)
    return errs


def drift(errors: list) -> dict:
    """Max, median and p90 of a list of per-segment endpoint errors."""
    flat = np.asarray([e for pair in errors for e in pair], np.float64)
    if not flat.size:
        return {"max": 0.0, "median": 0.0, "p90": 0.0, "n": 0}
    return {"max": float(flat.max()), "median": float(np.median(flat)),
            "p90": float(np.percentile(flat, 90)), "n": int(flat.size)}


def compare(run: dict, ref: dict, n_frames: int, radius_f32: bool) -> dict:
    """`run` against `ref` over the first n_frames frames, with `ref`'s
    world map after them: per-frame integers, the world's count,
    points_size and radius (radius_f32: `ref`'s radius rounded to float32,
    as the float32 port stores it), endpoint errors, intersections and
    recall; and each segment beyond ENDPOINT_TOL with both sides' b.x."""
    w = run["world"] if run["world_at_cut"] is None or n_frames == len(run["nblines"]) \
        else run["world_at_cut"]
    r = ref["world"]
    radius = [float(np.float32(x)) for x in r["radius"]] if radius_f32 else r["radius"]
    errors = endpoint_errors(w["endpoints"], r["endpoints"])
    return {
        "frames": n_frames,
        "frame_integers_equal": all(run[f][:n_frames] == ref[f][:n_frames] for f in FRAME_INTS),
        "world_equal": (w["count"], w["points_size"], w["radius"])
        == (r["count"], r["points_size"], radius),
        "endpoint_errors": errors,
        "drift": drift(errors),
        "beyond": [{"segment": i, "error": max(e), "b_x": [w["b_x"][i], r["b_x"][i]]}
                   for i, e in enumerate(errors) if max(e) > ENDPOINT_TOL],
        "intersections": [w["intersections"], r["intersections"]],
        "topology_equal": w["topology"] == r["topology"],
        "recall": [w["recall"], r["recall"]],
    }


def frame_drift(run: dict, ref: dict, n_frames: int) -> list:
    """The largest endpoint error of `run`'s world map against `ref`'s after
    each of the first n_frames frames (None where the counts differ): where
    a drift arose."""
    out = []
    for got, want in zip(run["endpoints_by_frame"][:n_frames], ref["endpoints_by_frame"]):
        out.append(drift(endpoint_errors(got, want))["max"] if len(got) == len(want) else None)
    return out


def checks_of(rec: dict) -> dict:
    """Every check of a record, recomputed from its fields: name -> bool."""
    out = {}
    for key in ("kernels_vs_plain", "card_vs_oracle"):
        c = rec.get(key)
        if c is None:
            continue
        out[f"{key}: per-frame nblines, status and seg_vec_size exact"] = c["frame_integers_equal"]
        out[f"{key}: world count, points_size and radius exact"] = c["world_equal"]
        out[f"{key}: endpoints within {ENDPOINT_TOL}"] = (
            max([e for pair in c["endpoint_errors"] for e in pair], default=0.0)
            <= ENDPOINT_TOL)
        out[f"{key}: intersections equal"] = c["intersections"][0] == c["intersections"][1]
        out[f"{key}: beams matched equal"] = c["recall"][0] == c["recall"][1]
    for side in ("kernels", "plain"):
        if rec.get(side) is not None:
            out[f"{side}: no frame overflowed the world map"] = \
                rec[side]["world_overflow_frames"] == 0
    return out


def x_division(cmp: dict) -> bool:
    """A comparison's endpoint failure has the x-division's signature: some
    segment lies beyond ENDPOINT_TOL, and every such one lies in the y-z
    plane to within X_DIVISION_BX on both sides, where the reference's
    extent t = (p.x - a.x) / b.x multiplies float32 rounding of p.x by
    1 / |b.x| (README §Precision contract)."""
    return bool(cmp["beyond"]) and all(max(abs(x) for x in s["b_x"]) < X_DIVISION_BX
                                       for s in cmp["beyond"])


def unexplained(rec: dict) -> list:
    """The failing checks of a record but those KNOWN_FAILURES lists for its
    flight and granularity whose failure has the x-division's signature."""
    known = KNOWN_FAILURES.get((rec["flight"], rec["granularity"]), ())
    return [c for c, ok in checks_of(rec).items()
            if not ok and not (c in known and x_division(rec[c.split(":")[0]]))]


def card_line(device: str) -> str:
    if not device.startswith("cuda"):
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _rev() -> str:
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True, cwd=ROOT).stdout.strip()
    except OSError:
        return ""


def run_flight(name: str, granularity: int, device: str = "cuda", oracle_frames: int = 0,
               max_frames: int = 0) -> dict:
    """One flight at one granularity through the three engines: the record
    (see the module's docstring) with its checks.  The plain versions run
    on a card only: on CPU tensors the wrappers already run them."""
    import torch

    from pointcloud_segmentation_tpu_torch.ops import voting as V
    from pointcloud_segmentation_tpu_torch.ops.hough import PLAIN, Voting

    cfg = flight_config(name, granularity)
    scene, frames = flight_frames(name, max_frames)
    n_oracle = min(oracle_frames or len(frames), len(frames))
    plain = device.startswith("cuda")
    print(f"{name} g{granularity} ({cfg.voting_mode}, NX {cfg.num_x_max}, radii "
          f"{cfg.radius_sizes}): {len(frames)} frames on {device}, the oracle over "
          f"{n_oracle}", flush=True)

    V.vote_state.launches = V.vote_histogram.launches = 0
    voting = Voting(Counted(V.vote_state), Counted(V.vote_histogram))
    kern = fly(cfg, scene, frames, device=device, voting=voting, snapshot_after=n_oracle)
    kern["launches"] = {"vote_state": V.vote_state.launches,
                        "vote_histogram": V.vote_histogram.launches}
    calls = [{"name": fn, "rows": r, "points": n, "nx": nx, "calls": c}
             for fn, counted in zip(("vote_state", "vote_histogram"), voting)
             for (r, n, nx), c in sorted(counted.shapes.items())]
    print(f"  kernels: {kern['seconds']:.1f} s, world {kern['world']['count']}, "
          f"recall {kern['world']['recall']}, launches {kern['launches']}", flush=True)
    rec = {"flight": name, "granularity": granularity, "voting": cfg.voting_mode,
           "nx": cfg.num_x_max, "radius_sizes": list(cfg.radius_sizes),
           "min_pca_coeff": cfg.min_pca_coeff, "device": device,
           "card": card_line(device), "torch": torch.__version__, "rev": _rev(),
           "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
           "frames": len(frames), "oracle_frames": n_oracle,
           "source": FLIGHTS[name].source, "voting_calls": calls,
           "kernels": kern, "plain": None, "oracle": None,
           "kernels_vs_plain": None, "card_vs_oracle": None}
    if plain:
        rec["plain"] = fly(cfg, scene, frames, device=device, voting=PLAIN)
        rec["kernels_vs_plain"] = compare(kern, rec["plain"], len(frames), False)
        print(f"  plain: {rec['plain']['seconds']:.1f} s", flush=True)
    rec["oracle"] = fly(cfg, scene, frames[:n_oracle], backend="oracle")
    rec["card_vs_oracle"] = compare(kern, rec["oracle"], n_oracle,
                                    cfg.compute_dtype == "float32")
    print(f"  oracle: {rec['oracle']['seconds']:.1f} s", flush=True)
    rec["drift_by_frame"] = {
        "kernels_vs_plain": frame_drift(kern, rec["plain"], len(frames)) if plain else None,
        "card_vs_oracle": frame_drift(kern, rec["oracle"], n_oracle)}
    for side in ("kernels", "plain", "oracle"):
        if rec[side] is not None:
            del rec[side]["endpoints_by_frame"]
    rec["checks"] = checks_of(rec)
    rec["ok"] = all(rec["checks"].values())
    return rec


def summary_line(rec: dict) -> str:
    d = rec["card_vs_oracle"]["drift"]
    w = rec["kernels"]["world"]
    return (f"structure: {rec['flight']} g{rec['granularity']} ({rec['voting']}) on "
            f"{rec['device']}: {rec['frames']} frames (oracle {rec['oracle_frames']}), "
            f"world {w['count']}, recall {w['recall']}, intersections {w['intersections']}, "
            f"drift against the oracle max {d['max']:.3g} median {d['median']:.3g} "
            f"p90 {d['p90']:.3g} m, kernels {rec['kernels']['seconds']:.1f} s, oracle "
            f"{rec['oracle']['seconds']:.1f} s, {'ok' if rec['ok'] else 'FAILED'} "
            f"[{rec['card']}]")


def persist(rec: dict, path: str) -> dict:
    """Write `rec` into the artifact at `path` in place of the record of the
    same flight, granularity and device, under an flock on ``<path>.lock``
    (flights run as parallel processes), by write-to-temp and os.replace."""
    import fcntl

    key = (rec["flight"], rec["granularity"], rec["device"])
    with open(path + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            data = {}
        recs = [r for r in data.get("records", [])
                if (r["flight"], r["granularity"], r["device"]) != key] + [rec]
        order = list(FLIGHTS)
        recs.sort(key=lambda r: (order.index(r["flight"]) if r["flight"] in order
                                 else len(order), r["granularity"], r["device"]))
        data = {"records": recs}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
            f.write("\n")
        os.replace(tmp, path)
    return data


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--flight", choices=sorted(FLIGHTS), action="append",
                    help="a flight (repeatable; default: every flight)")
    ap.add_argument("--granularity", type=int, action="append",
                    help="a granularity (repeatable; default: each flight's own)")
    ap.add_argument("--oracle-frames", type=int, default=0,
                    help="the oracle's frames, a prefix of the flight (0: all)")
    ap.add_argument("--max-frames", type=int, default=0,
                    help="cut every flight to its first frames (0: whole)")
    ap.add_argument("--artifact", help="the file records are written to "
                                       "(default: STRUCTURE_torch.json at the repo's root)")
    ap.add_argument("--no-artifact", action="store_true")
    args = ap.parse_args(argv)
    artifact = None if args.no_artifact else (args.artifact or ARTIFACT)
    bad = 0
    for name in args.flight or list(FLIGHTS):
        for g in args.granularity or FLIGHTS[name].granularities:
            rec = run_flight(name, g, args.device, args.oracle_frames, args.max_frames)
            for check, ok in rec["checks"].items():
                if not ok:
                    print(f"  FAILED {check}", flush=True)
            print(summary_line(rec), flush=True)
            bad += not rec["ok"]
            if artifact is not None:
                persist(rec, artifact)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
