"""The drone's own 224x172 ToF through the port on the CPU: capacities from
the configuration file, no silent cut of a cloud or of the voxel grid, the
voxel grid's run sums against the one-hot product they replace, and a
224x172 frame through the engine against the port's oracle.

Tolerances: integers (counts, voxel count, status, nlines, points_size)
exact.  The run sums add a voxel's points in sorted order; the one-hot
product adds them in the matrix product's order, so their centroids agree
to float32 rounding (1e-6 m in a 3-m window), and bit for bit where every
sum is exact.
"""

import logging

import numpy as np
import pytest
import torch

from pointcloud_segmentation_tpu_torch import SegmentationEngine, oracle
from pointcloud_segmentation_tpu_torch.config import PipelineConfig, StaticShapes, default_config
from pointcloud_segmentation_tpu_torch.io.scene import OBS_TESTS_SCENE, WP_TESTS, trajectory_poses
from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec, simulate_trajectory
from pointcloud_segmentation_tpu_torch.ops import preproc as P
from pointcloud_segmentation_tpu_torch.ops import voting as V

torch.set_num_threads(2)

TOF224 = {"max_raw_points": 224 * 172, "max_points": 8192}


def test_the_capacities_come_from_the_configuration(tmp_path):
    cfg = PipelineConfig.from_dict(dict(TOF224, granularity=4))
    assert cfg.shapes == StaticShapes(max_raw_points=38_528, max_points=8192)
    assert cfg.granularity == 4 and cfg.to_dict() == default_config(granularity=4).to_dict()
    path = tmp_path / "tof224.yaml"
    path.write_text("granularity: 6\nmax_raw_points: 38528\nmax_points: 8192\n")
    assert PipelineConfig.from_yaml(str(path)).shapes == cfg.shapes
    assert PipelineConfig.from_dict({"max_points": 2048}).shapes == StaticShapes(max_points=2048)
    # without them, today's capacities; an explicit override wins
    assert PipelineConfig.from_dict({"granularity": 6}).shapes == StaticShapes()
    small = StaticShapes(max_raw_points=64, max_points=32)
    assert PipelineConfig.from_dict(TOF224, shapes=small).shapes == small
    with pytest.raises(ValueError):
        PipelineConfig.from_dict({"max_points": 0})


def frames_224(idx, seed=1):
    poses = trajectory_poses(WP_TESTS, hz=2.0, velocity=0.25)
    return simulate_trajectory(OBS_TESTS_SCENE, [poses[i] for i in idx],
                               TofSpec(width=224, height=172, noise_frac=0.01), seed=seed)


def test_a_cloud_past_the_raw_buffer_is_counted_and_logged_once(caplog):
    cfg = default_config(granularity=2, shapes=StaticShapes(max_raw_points=2048,
                                                            max_points=1024))
    eng = SegmentationEngine(cfg, device="cpu")
    rng = np.random.default_rng(0)
    with caplog.at_level(logging.WARNING, logger="pointcloud_segmentation_tpu_torch"):
        for k, n in enumerate((2048, 3000, 5000, 100)):
            eng.push_pose(float(k), [0.0, 0.0, 1.0], [1.0, 0.0, 0.0, 0.0])
            eng.process_frame(float(k), rng.uniform(0.2, 1.2, (n, 3)).astype(np.float32))
    assert eng.raw_truncated == 2
    assert eng.trace_counters()["engine.raw_truncated"] == 2
    cut = [r for r in caplog.records if "max_raw_points=2048" in r.getMessage()]
    assert len(cut) == 1 and "3000 points" in cut[0].getMessage()


def onehot_sums(keys_s, pts_s, n_out, key_limit):
    """The voxel sums as the port computed them before the run sums (and as
    the JAX package does): one dense (n_out, N) one-hot product."""
    valid_s = keys_s < key_limit
    isnew = torch.ones_like(valid_s)
    isnew[1:] = keys_s[1:] != keys_s[:-1]
    first = isnew & valid_s
    group = torch.cumsum(first.to(torch.int32), 0, dtype=torch.int32) - 1
    group = torch.where(valid_s, group, n_out)
    onehot = (group[None, :] == torch.arange(n_out, dtype=torch.int32)[:, None]).to(pts_s.dtype)
    pts = torch.where(valid_s[:, None], pts_s, 0.0)
    sums, cnts = onehot @ pts, onehot.sum(dim=1)
    count = torch.clamp_max(first.sum().to(torch.int32), n_out)
    valid = torch.arange(n_out, dtype=torch.int32) < count
    centroids = torch.where(valid[:, None], sums / torch.clamp_min(cnts, 1.0)[:, None], 0.0)
    return centroids, valid, count, max(int(first.sum()) - n_out, 0)


def run_cloud(n, rng, exact):
    """A sorted cloud of n rows: a few voxels holding many points each, the
    rest one or two, and some invalid rows last.  `exact`: coordinates on a
    1/64 grid, so every sum is exact in any order."""
    keys = np.sort(rng.integers(0, 40, n // 2).tolist() * 2 + [7] * (n - n // 2 * 2))
    pts = rng.uniform(-1.0, 1.0, (n, 3))
    if exact:
        pts = np.round(pts * 64) / 64
    invalid = rng.random(n) < 0.1
    keys = np.where(invalid, 1000, keys)
    order = np.argsort(keys, kind="stable")
    pts = np.where(invalid[:, None], np.nan, pts)[order]
    return torch.from_numpy(keys[order].astype(np.int32)), torch.from_numpy(pts.astype(np.float32))


@pytest.mark.parametrize("case", ["many_in_one", "no_valid_point", "exactly_full",
                                  "overflowing", "rounding"])
def test_the_run_sums_equal_the_one_hot_product(case):
    rng = np.random.default_rng(11)
    keys, pts = run_cloud(600, rng, exact=case != "rounding")
    lim = 1000
    if case == "many_in_one":
        keys = torch.where(keys < lim, 5, keys)          # one voxel of ~540 points
    if case == "no_valid_point":
        keys = torch.full_like(keys, lim + 1)
    n_voxels = len(torch.unique(keys[keys < lim]))
    n_out = {"exactly_full": n_voxels, "overflowing": n_voxels - 7}.get(case, 64)
    got = P.voxel_sums_plain(keys, pts, n_out, lim)
    want = onehot_sums(keys, pts, n_out, lim)
    assert int(got[2]) == int(want[2]) == min(n_voxels, n_out)
    assert got[3] == want[3] == max(n_voxels - n_out, 0)
    assert torch.equal(got[1], want[1])
    if case == "rounding":
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    else:
        assert torch.equal(got[0], want[0])
    if case == "many_in_one":
        assert int(got[2]) == 1 and int((keys == 5).sum()) > 500


def test_the_dropped_voxels_are_counted():
    cfg = default_config(shapes=StaticShapes(max_raw_points=1024, max_points=64))
    rng = np.random.default_rng(5)
    raw = np.full((1024, 3), np.nan, np.float32)
    raw[:900] = rng.uniform([0.0, -1.0, -1.0], [1.4, 1.0, 1.0], size=(900, 3))
    V.reset_counts()
    _, valid, count = P.preprocess(torch.from_numpy(raw), cfg)
    n_voxels = len(np.unique(np.floor(raw[:900] / np.float32(cfg.leaf_size)), axis=0))
    assert int(count) == int(valid.sum()) == 64 < n_voxels
    assert P.voxel_overflow() == n_voxels - 64
    P.preprocess(torch.from_numpy(raw), cfg)
    assert P.voxel_overflow() == 2 * (n_voxels - 64)
    V.reset_counts()
    assert P.voxel_overflow() == 0


def test_a_224_frame_through_the_engine_equals_the_oracle():
    """Two frames of the flight at 224x172 and granularity 2, through the
    engine sized by the configuration's keys (38,528 raw rows, 8,192 voxels)
    and through the port's oracle: the voxel count, each frame's status,
    nlines and map size, and the map's points_size exact; nothing cut."""
    cfg = PipelineConfig.from_dict(dict(TOF224, granularity=2))
    frames = frames_224([12, 20])
    assert all(len(fr.points) == 38_528 for fr in frames)
    fr = frames[0]
    raw = torch.from_numpy(fr.points.astype(np.float32))
    _, valid, _ = P.preprocess(raw, cfg)
    vox = oracle.voxel_grid(oracle.passthrough_filter(
        fr.points[np.isfinite(fr.points).all(1)].astype(np.float64), cfg.window_size),
        cfg.leaf_size)
    assert int(valid.sum()) == len(vox) > 4096
    V.reset_counts()
    eng = SegmentationEngine(cfg, device="cpu")
    ref = SegmentationEngine(cfg, backend="oracle")
    for fr in frames:
        for e in (eng, ref):
            e.push_pose(fr.t, fr.position, fr.quat_wxyz)
        got, want = eng.process_frame(fr.t, fr.points), ref.process_frame(fr.t, fr.points)
        assert (got["nblines"], got["status"], got["seg_vec_size"]) == \
            (want["nblines"], want["status"], want["seg_vec_size"])
        assert got["nblines"] >= 1
    assert [s["points_size"] for s in eng.world_segments()] == \
        [s["points_size"] for s in ref.world_segments()]
    assert eng.raw_truncated == 0 and P.voxel_overflow() == 0
