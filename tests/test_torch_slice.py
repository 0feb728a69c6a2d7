"""The PyTorch port's main path end to end: engine replay, golden fixtures,
frame-by-frame parity with the JAX pipeline, JAX checkpoints, and the
package's guarantees (no jax import, no silent CPU)."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointcloud_segmentation_tpu.config import default_config, StaticShapes
from pointcloud_segmentation_tpu.io.scene import OBS_TESTS_SCENE, WP_TESTS, trajectory_poses
from pointcloud_segmentation_tpu.io.simulator import simulate_trajectory, TofSpec
from pointcloud_segmentation_tpu.pipeline import (
    init_world as jax_init_world, make_process_frame)
from pointcloud_segmentation_tpu.runtime import SegmentationEngine as JaxEngine
from pointcloud_segmentation_tpu.runtime.csvio import read_segments_csv

from pointcloud_segmentation_tpu_torch import SegmentationEngine
from pointcloud_segmentation_tpu_torch.pipeline import init_world, process_frame

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures")

# the configurations and replays of tests/test_golden.py
CFG = default_config(
    granularity=2,
    shapes=StaticShapes(max_raw_points=4096, max_points=2048, max_world_segments=32))
CFG_G6 = default_config(
    granularity=6,
    shapes=StaticShapes(max_raw_points=2048, max_points=1024, max_world_segments=32))


def golden_frames():
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:6]
    return simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.001), seed=7)


def golden_frames_g6():
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:4]
    return simulate_trajectory(OBS_TESTS_SCENE, poses,
                               TofSpec(width=32, height=32, noise_frac=0.001), seed=7)


def endpoints(s):
    a, b = np.asarray(s["a"], np.float64), np.asarray(s["b"], np.float64)
    t0, t1 = (s["t_min"], s["t_max"]) if "t_min" in s else s["endpoints"]
    return a + t0 * b, a + t1 * b


def segments_match(segs, golden, atol_pt):
    assert len(segs) == len(golden), f"{len(segs)} segments vs {len(golden)}"
    for k, (s, g) in enumerate(zip(segs, golden)):
        (p1, p2), (g1, g2) = endpoints(s), endpoints(g)
        d = min(np.linalg.norm(p1 - g1) + np.linalg.norm(p2 - g2),
                np.linalg.norm(p1 - g2) + np.linalg.norm(p2 - g1))
        assert d < atol_pt, f"segment {k} endpoints differ by {d}"


@pytest.fixture(scope="module")
def g2_engine():
    eng = SegmentationEngine(CFG, device="cpu")
    eng.run_replay(golden_frames())
    return eng


def test_reproduces_golden_g2_carry(g2_engine):
    assert CFG.voting_mode == "carry"
    golden = read_segments_csv(os.path.join(FIXTURES, "golden_segments.csv"))
    segments_match(g2_engine.world_segments(), golden, atol_pt=2e-2)


def test_matches_golden_intersection_topology(g2_engine):
    rows = g2_engine.intersections_rows()
    with open(os.path.join(FIXTURES, "golden_intersections.csv")) as f:
        f.readline()
        golden = [ln.strip().split(",") for ln in f if ln.strip()]
    assert {(r[0], r[2]) for r in rows} == {(int(g[0]), int(g[2])) for g in golden}
    gmap = {(int(g[0]), int(g[2])): (float(g[1]), float(g[3])) for g in golden}
    for (i, t1, j, t2) in rows:
        g1, g2 = gmap[(i, j)]
        assert abs(t1 - g1) < 5e-2 and abs(t2 - g2) < 5e-2


def test_reproduces_golden_g6_lazy():
    """The shipped granularity, through the lazy voting state and the
    tiered suspect re-exam."""
    assert CFG_G6.voting_mode == "lazy"
    eng = SegmentationEngine(CFG_G6, device="cpu")
    recs = eng.run_replay(golden_frames_g6())
    assert len(recs) == 4 and all(r["status"] == 0 for r in recs)
    golden = read_segments_csv(os.path.join(FIXTURES, "golden_segments_g6.csv"))
    segments_match(eng.world_segments(), golden, atol_pt=2e-2)


def test_finalize_writes_reference_csvs(g2_engine, tmp_path):
    paths = g2_engine.finalize(str(tmp_path))
    segs = read_segments_csv(paths["segments"])
    assert len(segs) == len(g2_engine.world_segments())
    with open(paths["processing_time"]) as f:
        assert f.readline().strip() == "wall_time,processing_time,seg_vec_size,nblines"
        assert len(f.readlines()) == 6
    with open(paths["intersections"]) as f:
        assert f.readline().strip() == "seg1,t1,seg2,t2"


def test_process_frame_matches_jax_frame_by_frame():
    """Both pipelines run the same replay, each with its own world state;
    every frame's scalars are equal and its segments within 5e-3."""
    step = make_process_frame(CFG)
    js = jax_init_world(CFG)
    ts = init_world(CFG, "cpu")
    for fr in golden_frames():
        raw = np.full((CFG.shapes.max_raw_points, 3), np.nan, np.float32)
        raw[: len(fr.points)] = fr.points
        pos = np.asarray(fr.position, np.float32)
        quat = np.asarray(fr.quat_wxyz, np.float32)
        js, jo = step(js, jnp.asarray(raw), jnp.asarray(pos), jnp.asarray(quat))
        ts, to = process_frame(ts, torch.from_numpy(raw), torch.from_numpy(pos),
                               torch.from_numpy(quat), CFG)
        for f in ("filtered_count", "nlines", "status", "world_count", "overflow"):
            assert int(getattr(to, f)) == int(getattr(jo, f)), f
        np.testing.assert_array_equal(to.slots.numpy(), np.asarray(jo.slots))
        v = np.asarray(jo.segments.valid)
        np.testing.assert_array_equal(to.segments.valid.numpy(), v)
        np.testing.assert_array_equal(to.segments.points_size.numpy(),
                                      np.asarray(jo.segments.points_size))
        for f in ("a", "b", "t_min", "t_max"):
            np.testing.assert_allclose(getattr(to.segments, f).numpy()[v],
                                       np.asarray(getattr(jo.segments, f))[v],
                                       atol=5e-3, rtol=0)
    n = int(ts.count)
    assert n == int(js.count) >= 5
    for f in ("a", "b", "t_min", "t_max"):
        np.testing.assert_allclose(getattr(ts, f).numpy()[:n],
                                   np.asarray(getattr(js, f))[:n], atol=5e-3, rtol=0)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """A JAX engine's checkpoint loads into the torch engine, and both give
    the same world map on the frames that follow."""
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:8]
    frames = simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.002), seed=1)
    ckpt = str(tmp_path / "state.npz")
    jeng = JaxEngine(CFG, backend="jax")
    jeng.run_replay(frames[:4])
    jeng.save_checkpoint(ckpt)

    teng = SegmentationEngine(CFG, device="cpu")
    teng.load_checkpoint(ckpt)
    assert teng.frames_processed == 4 and len(teng.records) == 4
    segments_match(teng.world_segments(), jeng.world_segments(), atol_pt=1e-6)

    jeng.run_replay(frames[4:])
    teng.run_replay(frames[4:])
    js, ts = jeng.world_segments(), teng.world_segments()
    assert [s["points_size"] for s in ts] == [s["points_size"] for s in js]
    segments_match(ts, js, atol_pt=5e-3)
    assert {(r[0], r[2]) for r in teng.intersections_rows()} == \
        {(r[0], r[2]) for r in jeng.intersections_rows()}
    assert len(teng.records) == 8


def test_oracle_checkpoint_is_refused(tmp_path):
    ckpt = str(tmp_path / "o.npz")
    e = JaxEngine(CFG, backend="oracle")
    e.run_replay(golden_frames()[:1])
    e.save_checkpoint(ckpt)
    with pytest.raises(ValueError):
        SegmentationEngine(CFG, device="cpu").load_checkpoint(ckpt)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pointcloud_segmentation_tpu_torch as P\n"
        "mods = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "assert len(mods) >= 12, mods\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        SegmentationEngine(CFG, device="cuda")


def test_float64_is_refused():
    """The port once refused compute_dtype="float64"; it now runs it (the
    parity mode, tests/test_torch_f64.py).  What stays refused is a checkpoint
    of the other float type."""
    eng = SegmentationEngine(CFG.replace(compute_dtype="float64"), device="cpu")
    assert eng.state.a.dtype == eng.state.inter.dtype == torch.float64
    assert eng._tables[0].dtype == torch.float64 and eng._tables[1].dtype == torch.float32
    assert SegmentationEngine(CFG, device="cpu").state.a.dtype == torch.float32
