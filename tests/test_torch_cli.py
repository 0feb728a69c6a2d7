"""The port's CLI (`python -m pointcloud_segmentation_tpu_torch`) on the CPU
(--device cpu, the plain versions of the kernels), held against the JAX
package's CLI on the same arguments: run/eval/timing, record + run --replay
with --max-frames, stream, serve, the scene flags and the orphan-flag
refusal."""

import contextlib
import io
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pointcloud_segmentation_tpu import cli as JCLI
from pointcloud_segmentation_tpu.io.replay import load_frames as jax_load_frames

from pointcloud_segmentation_tpu_torch import cli as TCLI
from pointcloud_segmentation_tpu_torch.io.replay import load_frames
from pointcloud_segmentation_tpu_torch.runtime.csvio import read_segments_csv
from pointcloud_segmentation_tpu_torch.runtime.server import SegmentationClient

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAJ = ["--hz", "1.0", "--velocity", "0.4"]
HEADERS = {"segments.csv": "segment,a_x,a_y,a_z,b_x,b_y,b_z,t_min,t_max",
           "intersections.csv": "seg1,t1,seg2,t2",
           "processing_time.csv": "wall_time,processing_time,seg_vec_size,nblines"}


def call(main, *argv):
    """One in-process CLI call: (exit code, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def port(*argv):
    return call(TCLI.main, *argv)


def endpoints(s):
    a, b = np.asarray(s["a"], np.float64), np.asarray(s["b"], np.float64)
    return a + s["t_min"] * b, a + s["t_max"] * b


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """`run` of both CLIs on the same arguments, 6 frames at granularity 2."""
    base = tmp_path_factory.mktemp("cli_runs")
    args = ["--granularity", "2", *TRAJ, "--max-frames", "6"]
    t_out, j_out = str(base / "torch"), str(base / "jax")
    t = port("run", "--device", "cpu", "--out", t_out, *args)
    j = call(JCLI.main, "run", "--backend", "jax", "--out", j_out, *args)
    return SimpleNamespace(torch=t, jax=j, t_out=t_out, j_out=j_out)


def test_cli_run_prints_and_writes_as_the_jax_cli(runs):
    (rc, text, _), (jrc, jtext, _) = runs.torch, runs.jax
    assert rc == jrc == 0
    assert text.splitlines()[0] == jtext.splitlines()[0]
    assert "6 frames ->" in text and "world segments" in text
    for name, header in HEADERS.items():
        with open(os.path.join(runs.t_out, name)) as f:
            assert f.readline().strip() == header
        assert os.path.join(runs.t_out, name) in text


def test_cli_run_segments_within_2e_2_of_the_jax_cli(runs):
    got = read_segments_csv(os.path.join(runs.t_out, "segments.csv"))
    want = read_segments_csv(os.path.join(runs.j_out, "segments.csv"))
    assert len(got) == len(want) >= 1
    for s, w in zip(got, want):
        (p1, p2), (q1, q2) = endpoints(s), endpoints(w)
        assert max(np.abs(p1 - q1).max(), np.abs(p2 - q2).max()) < 2e-2


@pytest.mark.parametrize("command", ["eval", "timing"])
def test_cli_eval_and_timing_equal_the_jax_cli(runs, command):
    name = "segments.csv" if command == "eval" else "processing_time.csv"
    path = os.path.join(runs.t_out, name)
    rc, text, _ = port(command, path)
    jrc, jtext, _ = call(JCLI.main, command, path)
    assert rc == jrc == 0
    assert json.loads(text) == json.loads(jtext)
    if command == "eval":
        assert json.loads(text)["n_truth_matched"] >= 2
    else:
        assert json.loads(text)["n_frames"] == 6


def test_cli_eval_scene_and_wbt_truth(runs, tmp_path):
    path = os.path.join(runs.t_out, "segments.csv")
    rc, text, _ = port("eval", path, "--scene", "mockup")
    assert json.loads(text)["n_truth"] == 20        # the mockup scaffold's beams
    wbt = tmp_path / "world.wbt"
    wbt.write_text("DEF SEG1 Solid {\n  translation 0.14 0.44 1.33\n"
                   "  rotation -0.1197 0.9794 -0.1628 3.04251\n"
                   "  children [ Shape { geometry Cylinder { height 1.5 radius 0.05 } } ]\n}\n")
    rc, text, _ = port("eval", path, "--wbt", str(wbt))
    jrc, jtext, _ = call(JCLI.main, "eval", path, "--wbt", str(wbt))
    assert rc == jrc and json.loads(text) == json.loads(jtext)
    assert json.loads(text)["n_truth"] == 1


def test_cli_record_then_replay_with_max_frames(tmp_path):
    log, jlog = str(tmp_path / "t.pcsl"), str(tmp_path / "j.pcsl")
    rc, text, _ = port("record", log, *TRAJ, "--max-frames", "4")
    assert rc == 0 and text.strip() == f"recorded 4 frames -> {log}"
    assert call(JCLI.main, "record", jlog, *TRAJ, "--max-frames", "4")[0] == 0
    mine, theirs = load_frames(log), jax_load_frames(jlog)
    assert len(mine) == len(theirs) == 4
    for a, b in zip(mine, theirs):
        assert a.t == b.t and a.points.tobytes() == b.points.tobytes()

    out = str(tmp_path / "out")
    rc, text, _ = port("run", "--granularity", "2", "--device", "cpu", "--replay", log,
                       "--out", out, "--max-frames", "2")
    assert rc == 0 and text.startswith("2 frames ->")
    with open(os.path.join(out, "processing_time.csv")) as f:
        rows = [ln for ln in f.read().splitlines() if ln.strip()]
    assert len(rows) - 1 == 2


def test_cli_stream_accounts_for_every_frame(tmp_path):
    log = str(tmp_path / "frames.pcsl")
    assert port("record", log, "--hz", "2.0", "--velocity", "0.4", "--max-frames", "5")[0] == 0
    out, viz = str(tmp_path / "out"), str(tmp_path / "viz.jsonl")
    rc, text, _ = port("stream", log, "--granularity", "2", "--device", "cpu", "--out", out,
                       "--rate", "15", "--viz-stream", viz)
    assert rc == 0
    line = text.splitlines()[0]
    assert line.startswith("fed 5 frames at 15.0 Hz -> processed ")
    nums = [int(w.strip(",;")) for w in line.split() if w.strip(",;").isdigit()]
    processed, dropped, skipped = nums[1:4]
    assert processed >= 1 and processed + dropped + skipped == 5
    for name, header in HEADERS.items():
        with open(os.path.join(out, name)) as f:
            assert f.readline().strip() == header
    with open(viz) as f:
        assert len(f.read().splitlines()) == processed


@pytest.mark.parametrize("command", ["run", "stream"])
def test_cli_rejects_orphan_viz_world_points(tmp_path, command):
    src = ["--max-frames", "1"] if command == "run" else [str(tmp_path / "absent.pcsl")]
    rc, _, err = port(command, "--device", "cpu", "--viz-world-points",
                      "--out", str(tmp_path), *src)
    assert rc == 2
    assert "--viz-stream" in err
    assert not os.path.exists(os.path.join(tmp_path, "segments.csv"))


def test_cli_run_viz_world_points(tmp_path):
    viz = str(tmp_path / "viz.jsonl")
    rc, text, _ = port("run", "--granularity", "2", "--device", "cpu", *TRAJ,
                       "--max-frames", "2", "--out", str(tmp_path / "o"),
                       "--viz-stream", viz, "--viz-world-points")
    assert rc == 0 and f"viz stream: {viz}" in text
    recs = [json.loads(line) for line in open(viz)]
    assert len(recs) == 2
    for r in recs:
        assert r["hough_points_world_accumulated"] is True
        pts = np.asarray(r["filtered_points"])
        assert pts.ndim == 2 and pts.shape[1] == 3 and np.isfinite(pts).all()


def test_cli_serve_as_a_module(tmp_path):
    """`python -m pointcloud_segmentation_tpu_torch serve`: a client streams
    two frames and finalizes; the process prints the outputs and exits 0."""
    log = str(tmp_path / "frames.pcsl")
    assert port("record", log, *TRAJ, "--max-frames", "2")[0] == 0
    frames = load_frames(log)
    out = str(tmp_path / "served")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pointcloud_segmentation_tpu_torch", "serve", "--device",
         "cpu", "--granularity", "2", "--port", "0", "--out", out],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()
        assert first.startswith("serving on 127.0.0.1:"), proc.stderr.read()
        cli = SegmentationClient("127.0.0.1", int(first.rsplit(":", 1)[1]), timeout=120.0)
        for fr in frames:
            cli.send_frame(fr.t, fr.position, fr.quat_wxyz, fr.points)
        reply = cli.finalize()
        cli.close()
        rest, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0
    assert reply["drained"] is True
    assert json.loads(rest.strip().splitlines()[-1]) == reply
    with open(reply["outputs"]["segments"]) as f:
        assert f.readline().strip() == HEADERS["segments.csv"]


# ------------------------------------------------------------------ parity stack

def test_cli_backend_oracle_equals_the_jax_cli(tmp_path):
    """`run --backend oracle` needs no card and no --device, and writes the
    JAX CLI's oracle CSVs byte for byte; `stream --backend oracle` runs the
    worker on the oracle."""
    args = ["--granularity", "2", *TRAJ, "--max-frames", "4"]
    t_out, j_out = str(tmp_path / "t"), str(tmp_path / "j")
    rc, text, _ = port("run", "--backend", "oracle", "--out", t_out, *args)
    jrc, jtext, _ = call(JCLI.main, "run", "--backend", "oracle", "--out", j_out, *args)
    assert rc == jrc == 0
    assert text.splitlines()[0] == jtext.splitlines()[0]
    for name in ("segments.csv", "intersections.csv"):
        with open(os.path.join(t_out, name), "rb") as a, \
                open(os.path.join(j_out, name), "rb") as b:
            assert a.read() == b.read(), name
    assert len(read_segments_csv(os.path.join(t_out, "segments.csv"))) >= 3

    log = str(tmp_path / "frames.pcsl")
    assert port("record", log, *TRAJ, "--max-frames", "3")[0] == 0
    rc, text, _ = port("stream", log, "--granularity", "2", "--backend", "oracle",
                       "--out", str(tmp_path / "s"), "--rate", "0")
    assert rc == 0 and text.startswith("fed 3 frames")
    with pytest.raises(SystemExit):
        port("run", "--backend", "jax", "--max-frames", "1")


def test_cli_runs_a_float64_yaml_end_to_end(tmp_path):
    """A YAML with compute_dtype: float64 runs the parity mode: its segments
    are the oracle's within 1e-4, which the float32 run's are not bound to."""
    cfg = tmp_path / "f64.yaml"
    cfg.write_text("granularity: 2\ncompute_dtype: float64\n")
    args = [*TRAJ, "--max-frames", "4", "--config", str(cfg)]
    out, ref = str(tmp_path / "f64"), str(tmp_path / "oracle")
    rc, text, _ = port("run", "--device", "cpu", "--out", out, *args)
    assert rc == 0 and text.startswith("4 frames ->")
    assert port("run", "--backend", "oracle", "--out", ref, *args)[0] == 0
    got = read_segments_csv(os.path.join(out, "segments.csv"))
    want = read_segments_csv(os.path.join(ref, "segments.csv"))
    assert len(got) == len(want) >= 3
    for s, w in zip(got, want):
        (p1, p2), (q1, q2) = endpoints(s), endpoints(w)
        # the CSV keeps 6 significant digits
        assert max(np.abs(p1 - q1).max(), np.abs(p2 - q2).max()) < 1e-4
    from pointcloud_segmentation_tpu_torch.config import PipelineConfig

    assert PipelineConfig.from_yaml(str(cfg)).compute_dtype == "float64"
    bad = tmp_path / "bad.yaml"
    bad.write_text("compute_dtype: float16\n")
    with pytest.raises(ValueError, match="compute_dtype"):
        PipelineConfig.from_yaml(str(bad))
