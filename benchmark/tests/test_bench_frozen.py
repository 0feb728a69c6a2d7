"""The benchmark's frozen copies held to the port's originals: the
simulator and scene bit for bit, the reference to the port's numpy
oracle on short g2 and g4 replays."""

import json
from pathlib import Path

import numpy as np
import pytest

from benchmark.reference import pipeline as R
from benchmark.reference.compare import compare, run_reference
from benchmark.reference.config import RefConfig
from benchmark.sim import scene as SC
from benchmark.sim import simulator as S

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def _port_flight():
    from pointcloud_segmentation_tpu_torch.io import scene as PS

    return PS.OBS_TESTS_SCENE, PS.WP_TESTS


def test_scene_and_waypoints_equal_the_ports():
    cfg = _config("tests_g6")
    scene, wps = _port_flight()
    ours = SC.scene_from(cfg["scene"])
    assert len(ours) == len(scene)
    for a, b in zip(ours, scene):
        assert a.center == b.center and a.axis == b.axis
        assert a.radius == b.radius and a.height == b.height
    assert SC.waypoints_from(cfg["waypoints"]) == tuple(tuple(w) for w in wps)


def test_poses_and_frames_bit_equal_the_ports():
    from pointcloud_segmentation_tpu_torch.io import scene as PS
    from pointcloud_segmentation_tpu_torch.io import simulator as PSim

    cfg = _config("tests_g6")
    fl = cfg["flight"]
    scene, wps = _port_flight()
    theirs = PS.trajectory_poses(wps, hz=fl["hz"], velocity=fl["velocity"])
    ours = SC.trajectory_poses(SC.waypoints_from(cfg["waypoints"]), hz=fl["hz"],
                               velocity=fl["velocity"])
    assert len(ours) == len(theirs) == 1081
    for (t, p, q), (u, r, s) in zip(ours, theirs):
        assert t == u and np.array_equal(p, r) and np.array_equal(q, s)
    pick = [0, 1, 400, len(ours) - 1]
    seed = 2**31 + 11
    want = PSim.simulate_trajectory(scene, [theirs[i] for i in pick],
                                    PSim.TofSpec(**cfg["sensor"]), seed=seed)
    got = S.render_flight(SC.scene_from(cfg["scene"]), [ours[i] for i in pick],
                          S.TofSpec(**cfg["sensor"]), seed=seed, workers=1)
    for a, b in zip(got, want):
        assert a.points.dtype == np.float32
        assert np.array_equal(a.points.view(np.uint32), b.points.view(np.uint32))


def test_render_in_workers_equals_one_process():
    cfg = _config("tests_g6")
    poses = SC.trajectory_poses(SC.waypoints_from(cfg["waypoints"]), hz=30.0,
                                velocity=0.1)[::120]
    spec = S.TofSpec(**cfg["sensor"])
    scene = SC.scene_from(cfg["scene"])
    one = S.simulate_trajectory(scene, poses, spec, seed=7)
    two = S.render_flight(scene, poses, spec, seed=7, workers=2)
    for a, b in zip(one, two):
        assert np.array_equal(a.points.view(np.uint32), b.points.view(np.uint32))


def test_reference_config_derives_as_the_ports():
    from pointcloud_segmentation_tpu_torch.config import PipelineConfig

    for g in (6, 4):
        yaml = dict(_config("tests_g6")["yaml"], granularity=g)
        ours, theirs = RefConfig.from_yaml_dict(yaml), PipelineConfig.from_dict(yaml)
        for k in ("leaf_size", "diag_voxel", "opt_dx", "granularity", "opt_nlines",
                  "min_pca_coeff", "min_weight", "opt_minvotes", "floor_trim_height",
                  "rad_2_leaf_ratio", "radius_sizes", "window_size"):
            assert getattr(ours, k) == getattr(theirs, k), k
        assert ours.shapes.max_iters == theirs.shapes.max_iters


def test_reference_sphere_equals_the_ports():
    from pointcloud_segmentation_tpu_torch.sphere import hough_space

    from benchmark.reference.sphere import hough_space as ours

    for g in (2, 4):
        for a, b in zip(ours(g), hough_space(g)):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("g,n", [(2, 10), (4, 6)])
def test_reference_equals_the_ports_oracle(g, n):
    from pointcloud_segmentation_tpu_torch import oracle
    from pointcloud_segmentation_tpu_torch.config import PipelineConfig

    cfg = _config("tests_g6")
    yaml = dict(cfg["yaml"], granularity=g)
    fl = cfg["flight"]
    poses = SC.trajectory_poses(SC.waypoints_from(cfg["waypoints"]), hz=fl["hz"],
                                velocity=fl["velocity"])[::40][:n]
    frames = S.render_flight(SC.scene_from(cfg["scene"]), poses,
                             S.TofSpec(**cfg["sensor"]), seed=2**31 + 5)
    pcfg = PipelineConfig.from_dict(yaml)
    wm = oracle.WorldMap(pcfg)
    per_frame = []
    for f in frames:
        res = oracle.process_frame(wm, f.points, f.position, f.quat_wxyz, pcfg)
        per_frame.append((res.nblines, res.status, len(wm.segments)))
    ref = run_reference(yaml, [(f.points, f.position, f.quat_wxyz) for f in frames], "cpu")
    assert ref["per_frame"] == per_frame
    assert len(ref["segments"]) == len(wm.segments) > 0
    for s, o in zip(ref["segments"], wm.segments):
        assert np.array_equal(s["a"], o.a) and np.array_equal(s["b"], o.b)
        assert (s["t_min"], s["t_max"], s["radius"], s["points_size"]) == (
            o.t_min, o.t_max, o.radius, o.points_size)
    assert ref["pairs"] == [(i, j) for i, _, j, _ in wm.intersections_rows()]


def test_tf32_rounding():
    x = np.array([1.0, 1.0 + 2**-11, 1.0 + 2**-12, -3.0000001, np.nan], np.float32)
    got = R._tf32(x)
    assert got[0] == 1.0 and got[1] == np.float32(1.0 + 2**-10) and got[2] == 1.0
    assert got[3] == -3.0 and np.isnan(got[4])


def test_compare_counts_each_difference():
    seg = {"a": np.zeros(3), "b": np.array([1.0, 0, 0]), "t_min": 0.0, "t_max": 1.0,
           "radius": 0.05, "points_size": 10}
    ref = {"per_frame": [(10, 0, 1), (10, 0, 1)], "segments": [seg], "pairs": []}
    same = {"per_frame": [(10, 0, 1), (10, None, 1)],
            "segments": [dict(seg, radius=np.float32(0.05))], "pairs": []}
    assert compare(same, ref) == {"frames_off": 0, "world_off": 0, "points_size_gap": 0.0,
                                  "endpoint_off_line_m": 0.0, "endpoint_gap_m": 0.0}
    off = {"per_frame": [(9, 0, 1), (10, 0, 1)],
           "segments": [dict(seg, points_size=11, t_max=1.5)], "pairs": [(1, 0)]}
    got = compare(off, ref)
    assert got["frames_off"] == 1 and got["world_off"] == 1
    assert got["points_size_gap"] == pytest.approx(0.1)
    assert got["endpoint_gap_m"] == pytest.approx(0.5)
    assert got["endpoint_off_line_m"] == 0.0          # t_max moved along the line
    moved = dict(seg, a=np.array([0.0, 0.001, 0.0]))
    got = compare({"per_frame": ref["per_frame"], "segments": [moved], "pairs": []}, ref)
    assert got["endpoint_off_line_m"] == pytest.approx(0.001)
