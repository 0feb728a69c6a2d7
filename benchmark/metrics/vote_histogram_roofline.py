"""Voting kernels: the carry-vote histogram kernel's share of its roofline,
%: the launches of `vote_kernel<false>` when the harness's eager pass runs
the traced span's frames again under the profiler, each at its least time
at the shape of the cells this metric lists in BENCHMARK.json
(`benchmark/roofline/histogram.py`, `least_seconds_at`: the bound of its
tables and histogram, which holds whatever points a launch was handed),
over their device time.  The harness's counting wrapper notes state-kernel
launches only, so the launches are the trace's count.  None when the pass
ran none, or when the listed cells' shapes differ."""

import json
import re
from pathlib import Path

from benchmark.metrics._common import kernel_seconds
from benchmark.reference.config import NUM_DIRECTIONS, RefConfig
from benchmark.roofline.histogram import grid_side, least_seconds_at

HISTOGRAM = re.compile(r"vote_kernel<\s*(false|0)\s*>")
MOVES = "frame_ms_p95"
ROOT = Path(__file__).resolve().parent.parent.parent


def cell_shapes() -> set:
    """(directions, NX) of each cell the metric lists."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"] if m["name"] == "vote_histogram_roofline"]
    cells = {w["name"]: w["config"] for w in bench["workloads"]}
    files = {c["name"]: c["file"] for c in bench["configs"]}
    shapes = set()
    for cell in entry["workloads"]:
        yaml = json.loads((ROOT / files[cells[cell]]).read_text())["yaml"]
        cfg = RefConfig.from_yaml_dict(yaml)
        shapes.add((NUM_DIRECTIONS[cfg.granularity], grid_side(cfg.window_size, cfg.opt_dx)))
    return shapes


def read(ctx):
    trace = ctx["eager_trace"]
    if trace is None:
        return None
    sec, n = kernel_seconds(trace, HISTOGRAM)
    shapes = cell_shapes()
    if n == 0 or sec <= 0 or len(shapes) != 1:
        return None
    (directions, nx), = shapes
    return 100.0 * n * least_seconds_at(directions, nx) / sec
