"""A 128x128 ToF frame through the port on the CPU: twins of
tests/test_large_sensor.py, held against the port's oracle and against the
JAX package on the same frame.

Tolerances: voxel count, status, nlines, the number of segments and their
points_size exact against both.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointcloud_segmentation_tpu import config as JC
from pointcloud_segmentation_tpu.ops.hough import extract_lines as jax_extract_lines
from pointcloud_segmentation_tpu.ops.preproc import preprocess as jax_preprocess
from pointcloud_segmentation_tpu_torch import config as TC
from pointcloud_segmentation_tpu_torch import oracle
from pointcloud_segmentation_tpu_torch.io.scene import OBS_TESTS_SCENE, yaw_to_quat_wxyz
from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec, render_depth
from pointcloud_segmentation_tpu_torch.ops.hough import PLAIN, extract_lines
from pointcloud_segmentation_tpu_torch.ops.preproc import preprocess

torch.set_num_threads(2)


def configs(n_raw, n_pts):
    shapes = dict(max_raw_points=n_raw, max_points=n_pts, max_world_segments=32)
    return (TC.default_config(granularity=2, shapes=TC.StaticShapes(**shapes)),
            JC.default_config(granularity=2, shapes=JC.StaticShapes(**shapes)))


def _frame_128():
    pts = render_depth(np.array([1.0, 0.0, 1.2]), yaw_to_quat_wxyz(3.14), OBS_TESTS_SCENE,
                       TofSpec(width=128, height=128, noise_frac=0.002),
                       rng=np.random.default_rng(3))
    return pts.astype(np.float32)


def test_128_frame_oracle_parity():
    cfg, jcfg = configs(16384, 4096)
    pts = _frame_128()
    assert len(pts) > 2100
    vox = oracle.voxel_grid(oracle.passthrough_filter(pts.astype(np.float64),
                                                      cfg.window_size), cfg.leaf_size)
    ref_segs, ref_nlines, ref_status = oracle.hough3dlines(vox, cfg)
    raw = np.full((cfg.shapes.max_raw_points, 3), np.nan, np.float32)
    raw[: len(pts)] = pts
    f, v, _ = preprocess(torch.from_numpy(raw), cfg)
    assert int(v.sum()) == len(vox)
    res = extract_lines(f, v, cfg, voting=PLAIN)
    assert (int(res.status), int(res.nlines)) == (ref_status, ref_nlines)
    valid = res.segments.valid.numpy()
    assert int(valid.sum()) == len(ref_segs) >= 1
    assert res.segments.points_size.numpy()[valid].tolist() == \
        [s.points_size for s in ref_segs]
    jf, jv, _ = jax_preprocess(jnp.asarray(raw), jcfg)
    jres = jax_extract_lines(jf, jv, jcfg)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert (int(jres.status), int(jres.nlines)) == (ref_status, ref_nlines)
    np.testing.assert_array_equal(valid, np.asarray(jres.segments.valid))
    np.testing.assert_array_equal(res.segments.points_size.numpy()[valid],
                                  np.asarray(jres.segments.points_size)[valid])


@pytest.mark.parametrize("n_pad", [4096, 4224])
def test_gap_check_sort_equals_rank_matrix(n_pad):
    """The same cloud padded to 4096 (where the JAX package checks gaps with
    a rank matrix) and above it (where it sorts, as the port always does)
    extracts identically, a real gap included."""
    rng = np.random.default_rng(5)
    t = np.linspace(0, 1.3, 300)
    b = np.array([0.3, 1.0, 0.15])
    b /= np.linalg.norm(b)
    pts = (np.array([0.4, -0.5, 0.6]) + t[:, None] * b
           + rng.normal(0, 0.004, (300, 3))).astype(np.float32)
    pts = pts[(t < 0.5) | (t > 0.78)]
    cfg, jcfg = configs(2 * n_pad, n_pad)
    padded = np.zeros((n_pad, 3), np.float32)
    padded[: len(pts)] = pts
    valid = np.zeros(n_pad, bool)
    valid[: len(pts)] = True
    res = extract_lines(torch.from_numpy(padded), torch.from_numpy(valid), cfg, voting=PLAIN)
    ref_segs, ref_nlines, ref_status = oracle.hough3dlines(pts.astype(np.float64), cfg)
    assert (int(res.nlines), int(res.status)) == (ref_nlines, ref_status)
    assert int(res.segments.valid.sum()) == len(ref_segs)
    jres = jax_extract_lines(jnp.asarray(padded), jnp.asarray(valid), jcfg)
    assert (int(jres.nlines), int(jres.status)) == (ref_nlines, ref_status)
    np.testing.assert_array_equal(res.segments.valid.numpy(), np.asarray(jres.segments.valid))
