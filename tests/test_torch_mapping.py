"""Whole-structure mapping recall of the port on the CPU: twins of the
recall tests of tests/test_tower.py, tests/test_devworld.py and
tests/test_mockup.py, each flight also through the JAX engine.

Tolerances: beams matched and intersections at or above the JAX tests' own
gates; against the JAX engine on the same frames, per-frame world count and
nlines exact, matched beams equal, world endpoints within 2e-2.
"""

import numpy as np
import pytest
import torch

from pointcloud_segmentation_tpu import config as JC
from pointcloud_segmentation_tpu.runtime import SegmentationEngine as JaxEngine
from pointcloud_segmentation_tpu_torch import config as TC
from pointcloud_segmentation_tpu_torch import SegmentationEngine, oracle
from pointcloud_segmentation_tpu_torch.eval import match_report
from pointcloud_segmentation_tpu_torch.io.scene import (
    OBS_DEV_SCENE, WP_MOCKUP, figure_eight_waypoints, mockup_scene, scene_truth,
    spiral_waypoints, tower_scene, trajectory_poses)
from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec, simulate_trajectory

torch.set_num_threads(2)

SHAPES = dict(max_raw_points=4096, max_points=2048, max_world_segments=64)


def fly(scene, poses, **kw):
    """The flight through the port and through the JAX engine: (port
    engine, port match report, JAX match report); the two maps compared on
    the way."""
    frames = simulate_trajectory(scene, poses, TofSpec(noise_frac=0.002), seed=0)
    eng = SegmentationEngine(TC.default_config(shapes=TC.StaticShapes(**SHAPES), **kw),
                             device="cpu")
    jeng = JaxEngine(JC.default_config(shapes=JC.StaticShapes(**SHAPES), **kw), backend="jax")
    recs, jrecs = eng.run_replay(frames), jeng.run_replay(frames)
    assert [(r["seg_vec_size"], r["nblines"]) for r in recs] == \
        [(r["seg_vec_size"], r["nblines"]) for r in jrecs]
    segs, jsegs = eng.world_segments(), jeng.world_segments()
    assert [s["points_size"] for s in segs] == [s["points_size"] for s in jsegs]
    for s, j in zip(segs, jsegs):
        for t in ("t_min", "t_max"):
            p = np.asarray(s["a"]) + s[t] * np.asarray(s["b"])
            q = np.asarray(j["a"]) + j[t] * np.asarray(j["b"])
            assert np.linalg.norm(p - q) < 2e-2
    assert len(eng.intersections_rows()) == len(jeng.intersections_rows())
    truth = scene_truth(scene)
    rep, jrep = (match_report(truth, [dict(s, endpoints=[s["t_min"], s["t_max"]])
                                      for s in ss]) for ss in (segs, jsegs))
    assert rep["n_truth_matched"] == jrep["n_truth_matched"]
    return eng, rep


def test_tower_mapping_recall():
    scene = tower_scene(levels=2, width=1.0)
    poses = trajectory_poses(
        spiral_waypoints(radius=1.2, z0=0.4, z1=2.2, turns=2.0, n=32), hz=2.0, velocity=0.4)
    eng, rep = fly(scene, poses, granularity=3, min_pca_coeff=0.99)
    assert rep["n_truth_matched"] >= 10
    assert len(eng.intersections_rows()) >= 4


@pytest.fixture(scope="module")
def dev_poses():
    return trajectory_poses(figure_eight_waypoints(a=1.8, z=1.7, n=32), hz=1.0, velocity=0.5)


def test_devworld_recall_r01(dev_poses):
    eng, rep = fly(OBS_DEV_SCENE, dev_poses, granularity=3, radius_sizes=(0.1,),
                   min_pca_coeff=0.95)
    assert rep["n_truth_matched"] >= 6
    assert all(s["radius"] == pytest.approx(0.1) for s in eng.world_segments())


def test_multi_radius_list_rejects_smaller_radius(dev_poses):
    """radius_sizes=(0.05, 0.1): the reference's max_radius quirk rejects
    every candidate that snaps to the smaller radius; the port, the JAX
    engine and the oracle map nothing."""
    kw = dict(granularity=3, radius_sizes=(0.05, 0.1), min_pca_coeff=0.95)
    eng, _ = fly(OBS_DEV_SCENE, dev_poses[:8], **kw)
    assert eng.world_segments() == []
    cfg = TC.default_config(shapes=TC.StaticShapes(**SHAPES), **kw)
    wm = oracle.WorldMap(cfg)
    for fr in simulate_trajectory(OBS_DEV_SCENE, dev_poses[:4], TofSpec(noise_frac=0.002),
                                  seed=0):
        oracle.process_frame(wm, fr.points, fr.position, fr.quat_wxyz, cfg)
    assert wm.segments == []


def test_mockup_mapping_recall():
    scene = mockup_scene()
    eng, rep = fly(scene, trajectory_poses(WP_MOCKUP, hz=1.0, velocity=0.6),
                   granularity=3, min_pca_coeff=0.99)
    assert rep["n_truth_matched"] >= 18
    assert len(eng.intersections_rows()) >= 15
