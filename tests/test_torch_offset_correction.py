"""E-OFFSET, the opt-in surface-offset correction, on the port's device path
(device="cpu"): twins of tests/test_offset_correction.py, held against the
port's oracle and against the JAX package.

Tolerances: the unit shifts within 1e-6 (float32) of the closed form and of
the JAX function; end to end, matched beams and the error reductions as the
JAX test states them, world endpoints within 2e-2 of the JAX engine's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointcloud_segmentation_tpu import config as JC
from pointcloud_segmentation_tpu.ops.hough import SegmentBatch as JSegmentBatch
from pointcloud_segmentation_tpu.pipeline import (
    surface_offset_correction as jax_surface_offset_correction)
from pointcloud_segmentation_tpu.runtime import SegmentationEngine as JaxEngine
from pointcloud_segmentation_tpu_torch import config as TC
from pointcloud_segmentation_tpu_torch import SegmentationEngine
from pointcloud_segmentation_tpu_torch.eval import match_report
from pointcloud_segmentation_tpu_torch.io.scene import (
    OBS_TESTS_SCENE, WP_TESTS, scene_truth, trajectory_poses)
from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec, simulate_trajectory
from pointcloud_segmentation_tpu_torch.ops.hough import SegmentBatch
from pointcloud_segmentation_tpu_torch.pipeline import surface_offset_correction

torch.set_num_threads(2)

SHAPES = dict(max_raw_points=4096, max_points=2048, max_world_segments=32)


def test_unit_shift_matches_oracle_and_jax():
    a = np.array([[1.0, 0.0, 0.3], [0.0, 0.0, 0.0], [0.0, 2.0, 0.7]], np.float32)
    b = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]], np.float32)
    radius = np.array([0.05, 0.05, 0.1], np.float32)

    def batch(cls, arr, valid):
        return cls(a=arr(a), b=arr(b), t_min=arr(np.zeros(3, np.float32)),
                   t_max=arr(np.ones(3, np.float32)), radius=arr(radius),
                   points_size=arr(np.full(3, 4, np.int32)),
                   pca_coeff=arr(np.ones(3, np.float32)),
                   pca_eigenvalues=arr(np.zeros((3, 3), np.float32)),
                   point_mask=arr(np.zeros((3, 8), bool)), valid=arr(np.array(valid)))

    for valid in ([True, True, True], [False, True, True]):
        out = surface_offset_correction(batch(SegmentBatch, torch.from_numpy, valid))
        jout = jax_surface_offset_correction(batch(JSegmentBatch, jnp.asarray, valid))
        np.testing.assert_allclose(out.a.numpy(), np.asarray(jout.a), atol=1e-6)
        # row 3: the sensor-to-line perpendicular is (0, 2, 0.7)/|.|; a line
        # through the sensor (row 2) and an invalid row keep their axis
        u = np.array([0.0, 2.0, 0.7]) / np.linalg.norm([0.0, 2.0, 0.7])
        first = [1.05, 0.0, 0.3] if valid[0] else [1.0, 0.0, 0.3]
        np.testing.assert_allclose(
            out.a.numpy(), [first, [0.0, 0.0, 0.0], np.array([0.0, 2.0, 0.7]) + 0.1 * u],
            atol=1e-6)


@pytest.mark.parametrize("backend", ["torch", "oracle"])
def test_end_to_end_distance_error_reduced(backend):
    """With the correction on, the mean midpoint distance error on the
    7-beam benchmark drops well below the bias of about one beam radius."""
    poses = trajectory_poses(WP_TESTS, hz=2.0, velocity=0.25)
    frames = simulate_trajectory(
        OBS_TESTS_SCENE, poses, TofSpec(width=48, height=48, noise_frac=0.002), seed=3)
    truth = scene_truth(OBS_TESTS_SCENE)

    def report(eng):
        eng.run_replay(frames)
        segs = eng.world_segments()
        return segs, match_report(truth, [dict(s, endpoints=[s["t_min"], s["t_max"]])
                                          for s in segs])

    def run(corr):
        cfg = TC.default_config(granularity=3, shapes=TC.StaticShapes(**SHAPES),
                                surface_offset_correction=corr)
        return report(SegmentationEngine(cfg, device="cpu", backend=backend))

    (_, base), (segs, corr) = run(False), run(True)
    assert corr["n_truth_matched"] >= base["n_truth_matched"] >= 6
    assert base["mean_distance_error"] > 0.03
    assert corr["mean_distance_error"] < base["mean_distance_error"] * 0.6
    assert base["mean_radial_error"] > 0.025
    assert corr["mean_radial_error"] < base["mean_radial_error"] * 0.5
    if backend == "torch":
        jcfg = JC.default_config(granularity=3, shapes=JC.StaticShapes(**SHAPES),
                                 surface_offset_correction=True)
        jsegs, jrep = report(JaxEngine(jcfg, backend="jax"))
        assert jrep["n_truth_matched"] == corr["n_truth_matched"]
        assert len(jsegs) == len(segs)
        assert [s["points_size"] for s in segs] == [s["points_size"] for s in jsegs]
        for s, j in zip(segs, jsegs):
            for t in ("t_min", "t_max"):
                p = np.asarray(s["a"]) + s[t] * np.asarray(s["b"])
                q = np.asarray(j["a"]) + j[t] * np.asarray(j["b"])
                assert np.linalg.norm(p - q) < 2e-2
