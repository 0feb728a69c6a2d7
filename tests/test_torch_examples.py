"""The port's twins of the two examples, each run on ``--device cpu`` in a
process of its own, at a granularity and a frame count that keep it to
seconds."""

import csv
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_example(name, *args, env=None):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", name), *args],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_map_a_structure_torch(tmp_path):
    out_dir = str(tmp_path / "tower")
    text = run_example("map_a_structure_torch.py", out_dir, "--device", "cpu",
                       "--granularity", "2", "--max-frames", "12")
    assert "simulating 12 ToF frames over a 12-beam tower" in text
    line = next(ln for ln in text.splitlines() if ln.startswith("world map:"))
    n_segs = int(line.split()[2])
    assert n_segs >= 1 and "/12 beams" in line
    assert len(rows(os.path.join(out_dir, "segments.csv"))) == n_segs
    assert len(rows(os.path.join(out_dir, "processing_time.csv"))) == 12


def test_serve_and_query_torch(tmp_path):
    text = run_example("serve_and_query_torch.py", "--device", "cpu", "--granularity", "2",
                       "--max-frames", "35", env={"TMPDIR": str(tmp_path)})
    assert "serving on 127.0.0.1:" in text and "processed=" in text
    final = next(ln for ln in text.splitlines() if ln.startswith("final:"))
    outdir = text.splitlines()[0].split("outputs -> ")[1]
    assert outdir.startswith(str(tmp_path))
    assert len(rows(os.path.join(outdir, "segments.csv"))) == int(final.split()[1]) >= 1
    # the served stream is deferred: by finalize every record has its values
    times = rows(os.path.join(outdir, "processing_time.csv"))
    assert times and all(int(r["seg_vec_size"]) >= 0 and int(r["nblines"]) >= 0 for r in times)
