"""Preprocess: the voxel grid's kernel's share of its roofline, %: the
calls of `pcs_voxel_sums` when the harness's eager pass runs the traced
span's frames again under the profiler, each at its least time at the
shape of the cells this metric lists in BENCHMARK.json
(`benchmark/roofline/voxel.py`: the sorted keys and points of the raw
buffer read once, the voxels written once), over the device time of its
two launches.  A call is one `voxel_sums_kernel` launch, beside one
`voxel_starts_kernel`.  None when the pass ran none (a program without the
kernel), or when the listed cells' shapes differ or are not set."""

import json
import re
from pathlib import Path

from benchmark.metrics._common import kernel_seconds
from benchmark.roofline.voxel import least_seconds

SUMS = re.compile(r"voxel_sums_kernel")
STARTS = re.compile(r"voxel_starts_kernel")
MOVES = "frames_per_s"
ROOT = Path(__file__).resolve().parent.parent.parent


def cell_shapes() -> set:
    """(max_raw_points, max_points) of each cell the metric lists, None
    where a configuration leaves them to the program."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"] if m["name"] == "voxel_sums_roofline"]
    cells = {w["name"]: w["config"] for w in bench["workloads"]}
    files = {c["name"]: c["file"] for c in bench["configs"]}
    shapes = set()
    for cell in entry["workloads"]:
        yaml = json.loads((ROOT / files[cells[cell]]).read_text())["yaml"]
        shapes.add((yaml.get("max_raw_points"), yaml.get("max_points")))
    return shapes


def read(ctx):
    trace = ctx["eager_trace"]
    if trace is None:
        return None
    sums_s, n = kernel_seconds(trace, SUMS)
    starts_s, n_starts = kernel_seconds(trace, STARTS)
    shapes = cell_shapes()
    if n == 0 or n_starts != n or len(shapes) != 1 or None in next(iter(shapes)):
        return None
    (n_raw, n_out), = shapes
    return 100.0 * n * least_seconds(n_raw, n_out) / (sums_s + starts_s)
