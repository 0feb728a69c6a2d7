"""The port's CLI (`python -m pointcloud_segmentation_tpu_torch`) on the CPU
(--device cpu, the plain versions of the kernels), held against the JAX
package's CLI on the same arguments: run/eval/timing, record + run --replay
with --max-frames, stream, serve, the scene flags and the orphan-flag
refusal; then run/record --bag with the topic flags, bag-info, viz, --plots
and inspect."""

import contextlib
import io
import json
import os
import struct
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
    # a plain --viz-stream on a stream: one record a read-back batch
    with open(viz) as f:
        recs = [json.loads(ln) for ln in f.read().splitlines()]
    assert recs and all(r["viz_cadence"] == "flush" for r in recs)
    assert sum(r["frames_in_batch"] for r in recs) == processed


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


# ------------------------------------------- recorded bags, viz, bag-info, inspect

def two_cloud_topic_bag(path, frames):
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
    return path


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    """Six simulated frames recorded to a .pcsl log, and written from it as a
    bz2 ROS1 bag, an MCAP file and a bag with two cloud topics."""
    from pointcloud_segmentation_tpu_torch.io import mcap, rosbag

    base = tmp_path_factory.mktemp("cli_bags")
    log = str(base / "sim.pcsl")
    assert port("record", log, "--hz", "1.5", "--velocity", "0.4", "--max-frames", "6")[0] == 0
    frames = load_frames(log)
    bag, mc, two = str(base / "flight.bag"), str(base / "flight.mcap"), str(base / "two.bag")
    assert rosbag.frames_to_bag(bag, frames, compression="bz2") == 12
    assert mcap.frames_to_mcap(mc, frames) == 12
    two_cloud_topic_bag(two, frames)
    return SimpleNamespace(base=base, log=log, frames=frames, bag=bag, mcap=mc, two=two)


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("container", ["bag", "mcap"])
def test_cli_run_bag_equals_run_replay_of_the_recorded_bag(bags, tmp_path, container):
    """`record --bag` converts the recording; `run --bag` of the recording
    and `run --replay` of the converted log write the same segments.csv and
    intersections.csv byte for byte."""
    src = getattr(bags, container)
    log = str(tmp_path / "from_bag.pcsl")
    rc, text, _ = port("record", log, "--bag", src)
    assert rc == 0 and text.strip() == f"recorded 6 frames -> {log}"
    back = load_frames(log)
    for a, b in zip(back, bags.frames):
        assert a.points.tobytes() == b.points.tobytes() and abs(a.t - b.t) < 1e-9
    o_bag, o_log = str(tmp_path / "bag"), str(tmp_path / "log")
    run = ["run", "--granularity", "2", "--device", "cpu"]
    rc, text, _ = port(*run, "--bag", src, "--out", o_bag)
    assert rc == 0 and text.startswith("6 frames ->")
    assert port(*run, "--replay", log, "--out", o_log)[0] == 0
    for name in ("segments.csv", "intersections.csv"):
        assert read_bytes(os.path.join(o_bag, name)) == read_bytes(os.path.join(o_log, name))
    assert len(read_segments_csv(os.path.join(o_bag, "segments.csv"))) >= 3


def test_cli_run_bag_within_2e_2_of_the_jax_cli(bags, tmp_path):
    t_out, j_out = str(tmp_path / "t"), str(tmp_path / "j")
    args = ["--granularity", "2", "--bag", bags.bag, "--max-frames", "5"]
    rc, text, _ = port("run", "--device", "cpu", "--out", t_out, *args)
    jrc, jtext, _ = call(JCLI.main, "run", "--backend", "jax", "--out", j_out, *args)
    assert rc == jrc == 0
    assert text.splitlines()[0] == jtext.splitlines()[0]
    assert text.startswith("5 frames ->")
    got = read_segments_csv(os.path.join(t_out, "segments.csv"))
    want = read_segments_csv(os.path.join(j_out, "segments.csv"))
    assert len(got) == len(want) >= 3
    for s, w in zip(got, want):
        (p1, p2), (q1, q2) = endpoints(s), endpoints(w)
        assert max(np.abs(p1 - q1).max(), np.abs(p2 - q2).max()) < 2e-2
    with open(os.path.join(t_out, "intersections.csv")) as a, \
            open(os.path.join(j_out, "intersections.csv")) as b:
        assert len(a.readlines()) == len(b.readlines())


def test_cli_record_bag_honours_max_frames_and_topic_flags(bags, tmp_path):
    log, jlog = str(tmp_path / "t.pcsl"), str(tmp_path / "j.pcsl")
    args = ["--bag", bags.two, "--cloud-topic", "/filtered_pointcloud",
            "--pose-topic", "/mavros/local_position/pose", "--max-frames", "4"]
    rc, text, _ = port("record", log, *args)
    assert rc == 0 and text.strip() == f"recorded 4 frames -> {log}"
    assert call(JCLI.main, "record", jlog, *args)[0] == 0
    assert read_bytes(log) == read_bytes(jlog)


@pytest.mark.parametrize("source", ["bag", "mcap", "two"])
def test_cli_bag_info_prints_the_jax_commands_lines(bags, source):
    path = getattr(bags, source)
    rc, text, _ = port("bag-info", path)
    jrc, jtext, _ = call(JCLI.main, "bag-info", path)
    assert rc == jrc == 0 and text == jtext
    assert "poses: /mavros/local_position/pose" in text
    if source == "two":
        assert "clouds: AMBIGUOUS — pass --cloud-topic (candidates: " \
               "/filtered_pointcloud, /tof_pc)" in text
    else:
        assert "clouds: /tof_pc" in text and "6 msgs" in text


def test_cli_cloud_topic_resolves_an_ambiguous_bag(bags, tmp_path):
    run = ["run", "--granularity", "2", "--device", "cpu", "--bag", bags.two]
    errs = []
    for main in (TCLI.main, JCLI.main):
        with pytest.raises(IOError, match="2 topics carry PointCloud2") as e:
            call(main, *run[:3], *run[5:], "--out", str(tmp_path / "no"))
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "/filtered_pointcloud" in errs[0] and "/tof_pc" in errs[0]
    assert not os.path.exists(tmp_path / "no")
    with pytest.raises(IOError, match="requested topic '/typo'"):
        port(*run, "--cloud-topic", "/typo", "--out", str(tmp_path / "no"))
    out, ref = str(tmp_path / "picked"), str(tmp_path / "plain")
    rc, text, _ = port(*run, "--cloud-topic", "/tof_pc", "--out", out)
    assert rc == 0 and text.startswith("6 frames ->")
    assert port("run", "--granularity", "2", "--device", "cpu", "--bag", bags.bag,
                "--out", ref)[0] == 0
    assert read_bytes(os.path.join(out, "segments.csv")) == \
        read_bytes(os.path.join(ref, "segments.csv"))


def test_cli_run_bag_on_the_default_device_raises_without_a_card(bags, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        port("run", "--bag", bags.bag, "--out", str(tmp_path / "o"))
    assert not os.path.exists(tmp_path / "o" / "segments.csv")


def test_cli_viz_renders_the_stream_of_run_bag(bags, tmp_path):
    stream = str(tmp_path / "flight.jsonl")
    rc, text, _ = port("run", "--granularity", "2", "--device", "cpu", "--bag", bags.mcap,
                       "--max-frames", "4", "--out", str(tmp_path / "o"),
                       "--viz-stream", stream)
    assert rc == 0 and f"  viz stream: {stream}" in text
    rc, text, _ = port("viz", stream)
    html = str(tmp_path / "flight.html")
    assert rc == 0 and text.strip() == f"4 frames -> {html}"
    jhtml = str(tmp_path / "j.html")
    jrc, jtext, _ = call(JCLI.main, "viz", stream, "-o", jhtml)
    assert jrc == 0 and jtext.strip() == f"4 frames -> {jhtml}"
    assert open(html).read() == open(jhtml).read().replace(
        "<title>pointcloud_segmentation_tpu</title>",
        "<title>pointcloud_segmentation_tpu_torch</title>")
    assert open(html).read().count('"frame": ') == 4


def test_cli_viz_follow_serves_the_live_player(tmp_path):
    import urllib.request

    stream = str(tmp_path / "live.jsonl")
    with open(stream, "w") as f:
        f.write(json.dumps({"frame": 1, "t": 0.0, "nlines": 0, "status": 0, "world_count": 0,
                            "cylinders": [], "intersections": []}) + "\n")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pointcloud_segmentation_tpu_torch", "viz", stream, "--follow"],
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="2"), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        first = proc.stdout.readline()
        assert first.startswith("live player: http://127.0.0.1:"), proc.stderr.read()
        url = first.split()[2]
        with urllib.request.urlopen(url + "stream?from=0", timeout=10) as r:
            resp = json.loads(r.read())
        assert resp["next"] == 1 and resp["frames"][0]["frame"] == 1
    finally:
        proc.kill()
        proc.communicate()


def test_cli_inspect_prints_the_jax_commands_shape_facts(capfd):
    """`inspect --device cpu`: the shape and capacity facts of the JAX
    command with equal values, the frame's wall time and lines, and none of
    the card's fields."""
    rc, text, _ = port("inspect", "--granularity", "2", "--device", "cpu")
    jrc, jtext, _ = call(JCLI.main, "inspect", "--granularity", "2")
    assert rc == jrc == 0
    info, jinfo = json.loads(text), json.loads(jtext)
    facts = ("granularity", "num_directions", "num_x_max", "max_points", "max_world_segments")
    assert {k: info[k] for k in facts} == {k: jinfo[k] for k in facts}
    assert info["granularity"] == 2 and info["num_directions"] == 81
    assert info["backend"] == "torch" and info["device"] == "cpu"
    assert info["frame"] == 10 and info["nlines"] >= 1 and info["wall_ms"] > 0
    for k in ("kernel_launches", "device_us", "vote_state_launches", "vote_histogram_launches",
              "flops", "bytes_accessed"):
        assert k not in info
    assert "flops" in jinfo


@pytest.mark.parametrize("command", ["run", "eval"])
def test_cli_plots_write_the_jax_clis_files(bags, tmp_path, command):
    pytest.importorskip("matplotlib")
    out = str(tmp_path / "o")
    args = ["run", "--granularity", "2", "--device", "cpu", "--replay", bags.log, "--out", out]
    rc, text, _ = port(*args, *(["--plots"] if command == "run" else []))
    assert rc == 0
    if command == "run":
        assert text.splitlines()[-1] == f"  plots: {out}/world.png"
        names = ("world.png", "errors.png")
    else:
        rc, text, _ = port("eval", os.path.join(out, "segments.csv"), "--plots")
        jrc, jtext, _ = call(JCLI.main, "eval", os.path.join(out, "segments.csv"), "--plots")
        assert rc == jrc == 0 and text == jtext
        assert text.splitlines()[-1] == f"plots: {out}/eval_world.png"
        names = ("eval_world.png", "eval_errors.png")
    for name in names:
        assert read_bytes(os.path.join(out, name))[:4] == b"\x89PNG"
