"""The comparison that decides a run's ``correct``: the program's answers
against the plain reference's, from the same frames in the same order.

The answers of a run:
  * per frame processed: ``nblines`` and the world map's size after it, and
    its Hough status where the path reports one;
  * after the last frame: the world map (each segment's radius,
    ``points_size`` and endpoints) and its intersection pairs.

Five numbers, each beside its limit.  A cell's limits are
``benchmark/limits/<cell>.json``; each lies between the largest reading of
sound runs and the smallest reading of the control (PERF.md, section 2):
  * ``frames_off``: frames whose integers differ from the reference's;
  * ``world_off``: the difference in world size, plus the segments whose
    radius differs, plus the intersection pairs found on one side only;
  * ``points_size_gap``: the largest relative gap of a segment's
    accumulated ``points_size``, over the segments both maps hold.  A
    float32 distance test flips a point that lies within rounding of the
    inlier bound, so a map fused from a thousand frames gains or loses a
    few of its tens of thousands of points;
  * ``endpoint_off_line_m``: the largest distance of a segment's endpoint
    from the reference segment's line;
  * ``endpoint_gap_m``: the largest distance between a segment's endpoint
    and the reference's.  Along the line it is larger: the reference places
    an endpoint by t = (p.x - a.x) / b.x (the x-division, README's
    precision contract), which scales float32 rounding by 1 / |b.x|.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import pipeline as R
from .config import RefConfig

NUMBERS = ("frames_off", "world_off", "points_size_gap", "endpoint_off_line_m",
           "endpoint_gap_m")


def run_reference(yaml_cfg: dict, frames: Sequence[tuple], device,
                  precision: str = "float64", keys: Optional[Sequence] = None) -> dict:
    """The reference over (points, position, quat_wxyz) frames in order:
    per-frame (nblines, status, world size), the world's segments and its
    intersection pairs.  ``keys``, one a frame, name frames that are the
    same cloud (a looped flight), whose extraction is then made once."""
    cfg = RefConfig.from_yaml_dict(yaml_cfg)
    world = R.WorldMap(cfg)
    per_frame = []
    cache = {} if keys is not None else None
    for i, (pts, pos, quat) in enumerate(frames):
        res = R.process_frame(world, pts, np.asarray(pos, np.float64),
                              np.asarray(quat, np.float64), cfg, device, precision,
                              cache, None if keys is None else keys[i])
        per_frame.append((res.nblines, res.status, len(world.segments)))
    segs = [{"a": s.a, "b": s.b, "t_min": s.t_min, "t_max": s.t_max,
             "radius": s.radius, "points_size": s.points_size}
            for s in world.segments]
    return {"per_frame": per_frame, "segments": segs,
            "pairs": [(i, j) for i, _, j, _ in world.intersections_rows()]}


def _endpoints(s: dict) -> Tuple[np.ndarray, np.ndarray]:
    a, b = np.asarray(s["a"], np.float64), np.asarray(s["b"], np.float64)
    return a + float(s["t_min"]) * b, a + float(s["t_max"]) * b


def compare(program: dict, reference: dict, detail: Optional[list] = None
            ) -> Dict[str, float]:
    """The five numbers of the module's docstring.  ``program`` has the
    reference's keys; a per-frame status of None is not compared.  Each
    difference is described in ``detail`` when one is given."""
    detail = [] if detail is None else detail
    pf, rf = program["per_frame"], reference["per_frame"]
    frames_off = abs(len(pf) - len(rf))
    for i, ((nl, st, wc), (rnl, rst, rwc)) in enumerate(zip(pf, rf)):
        if nl != rnl or wc != rwc or (st is not None and st != rst):
            frames_off += 1
            detail.append(f"frame {i}: (nblines, status, world) {(nl, st, wc)} "
                          f"reference {(rnl, rst, rwc)}")
    ps, rs = program["segments"], reference["segments"]
    world_off = abs(len(ps) - len(rs))
    gap = off_line = size_gap = 0.0
    for i, (p, r) in enumerate(zip(ps, rs)):
        # the radius is one of radius_sizes, held in float32 on the card
        if np.float32(p["radius"]) != np.float32(r["radius"]):
            world_off += 1
        n, rn = int(p["points_size"]), int(r["points_size"])
        size_gap = max(size_gap, abs(n - rn) / max(rn, 1))
        if (n, np.float32(p["radius"])) != (rn, np.float32(r["radius"])):
            detail.append(f"segment {i}: (radius, points_size) {(float(p['radius']), n)} "
                          f"reference {(float(r['radius']), rn)}, b "
                          f"{np.round(np.asarray(p['b'], np.float64), 6).tolist()}")
        ra, rb = np.asarray(r["a"], np.float64), np.asarray(r["b"], np.float64)
        rb = rb / np.linalg.norm(rb)
        for u, v in zip(_endpoints(p), _endpoints(r)):
            gap = max(gap, float(np.linalg.norm(u - v)))
            d = u - ra
            off_line = max(off_line, float(np.linalg.norm(d - (d @ rb) * rb)))
    pairs = set(program["pairs"]) ^ set(reference["pairs"])
    world_off += len(pairs)
    if pairs or len(ps) != len(rs):
        detail.append(f"world size {len(ps)} reference {len(rs)}; intersection pairs "
                      f"on one side only {sorted(pairs)}")
    return {"frames_off": frames_off, "world_off": world_off, "points_size_gap": size_gap,
            "endpoint_off_line_m": off_line, "endpoint_gap_m": gap}


def load_limits(cell: str) -> Dict[str, float]:
    """The cell's limits, in NUMBERS' order.  A number the file leaves out
    is not compared in that cell (PERF.md says why)."""
    path = Path(__file__).resolve().parent.parent / "limits" / f"{cell}.json"
    raw = json.loads(path.read_text())
    if not raw or not set(raw) <= set(NUMBERS):
        raise ValueError(f"{path}: limits for {sorted(raw)}; the numbers are {NUMBERS}")
    return {k: raw[k] for k in NUMBERS if k in raw}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= v for k, v in limits.items())


def check_lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"{k} {numbers[k]!r} limit {v!r}" for k, v in limits.items()]
