"""The port's `extract_lines` on the inputs of tests/test_hough_extra.py:
multi-radius configs, unbounded opt_nlines, radius gating, capacity bounds,
grids above 256 cells a side.  Each case runs in carry and in lazy voting
mode on the CPU (the kernels' plain versions) and is held against the port's
numpy oracle and against the JAX package's `extract_lines_jit` on the same
points.

Tolerances: nlines, status, the number of valid segments, their radii and
points_size exact against both; the histogram identity bit-equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcloud_segmentation_tpu.config import StaticShapes as JStaticShapes
from pointcloud_segmentation_tpu.config import default_config as jax_default_config
from pointcloud_segmentation_tpu.ops import hough as JH
from pointcloud_segmentation_tpu_torch import oracle
from pointcloud_segmentation_tpu_torch.config import StaticShapes, default_config
from pointcloud_segmentation_tpu_torch.io.scene import Cylinder
from pointcloud_segmentation_tpu_torch.io.simulator import cylinder_surface_cloud
from pointcloud_segmentation_tpu_torch.ops import voting as V
from pointcloud_segmentation_tpu_torch.ops.hough import (
    PLAIN, _compact_removed, extract_lines)
from pointcloud_segmentation_tpu_torch.sphere import hough_space

torch.set_num_threads(2)


def pad(pts, n):
    out = np.zeros((n, 3), np.float32)
    out[: len(pts)] = pts
    valid = np.zeros(n, bool)
    valid[: len(pts)] = True
    return out, valid


def configs(shapes: dict, **kw):
    """The same configuration in both packages."""
    return (default_config(shapes=StaticShapes(**shapes), **kw),
            jax_default_config(shapes=JStaticShapes(**shapes), **kw))


def run_all(pts, cfg, jcfg):
    """(oracle result, port results by voting mode).  The port's carry and
    lazy runs must agree with each other field for field, and with the JAX
    package's extraction in every integer."""
    ref = oracle.hough3dlines(np.asarray(pts, np.float64), cfg)
    padded, valid = pad(pts, cfg.shapes.max_points)
    out = {}
    for mode in ("carry", "lazy"):
        out[mode] = extract_lines(torch.from_numpy(padded), torch.from_numpy(valid),
                                  dataclasses.replace(cfg, voting=mode), voting=PLAIN)
    for a, b in zip(out["carry"].segments, out["lazy"].segments):
        assert torch.equal(a, b)
    assert int(out["carry"].nlines) == int(out["lazy"].nlines)
    jres = JH.extract_lines_jit(jnp.asarray(padded), jnp.asarray(valid), jcfg)
    res = out["carry"]
    v = res.segments.valid.numpy()
    assert (int(res.nlines), int(res.status)) == (int(jres.nlines), int(jres.status))
    np.testing.assert_array_equal(v, np.asarray(jres.segments.valid))
    np.testing.assert_array_equal(res.segments.points_size.numpy()[v],
                                  np.asarray(jres.segments.points_size)[v])
    np.testing.assert_array_equal(res.segments.radius.numpy()[v],
                                  np.asarray(jres.segments.radius)[v])
    return ref, res


def tube(radius, center, axis, n=1200, seed=0, noise=0.002):
    cyl = Cylinder(center=tuple(center), axis=tuple(axis), radius=radius, height=1.6)
    return cylinder_surface_cloud(cyl, n, seed=seed, noise=noise).astype(np.float32)


def beams(rng, specs, n, noise, t_max):
    clouds = []
    for a, b in specs:
        t = np.linspace(0, t_max, n)
        b = np.asarray(b) / np.linalg.norm(b)
        clouds.append(np.asarray(a) + t[:, None] * b + rng.normal(0, noise, (n, 3)))
    return np.concatenate(clouds).astype(np.float32)


def same_counts(ref, res):
    ref_segs, ref_nlines, ref_status = ref
    assert int(res.nlines) == ref_nlines and int(res.status) == ref_status
    v = res.segments.valid.numpy()
    assert int(v.sum()) == len(ref_segs)
    assert res.segments.points_size.numpy()[v].tolist() == [s.points_size for s in ref_segs]


def test_single_radius_per_run_and_multi_radius_quirk():
    shapes = dict(max_raw_points=2048, max_points=2048)
    kw = dict(granularity=2, opt_minvotes=10, min_pca_coeff=0.9)
    pts = tube(0.1, [0.6, 0.0, 1.0], [0, 1, 0], seed=2)
    ref, res = run_all(pts, *configs(shapes, radius_sizes=(0.1,), **kw))
    same_counts(ref, res)
    v = res.segments.valid.numpy()
    assert len(ref[0]) >= 1 and ref[0][0].radius == pytest.approx(0.1)
    assert float(res.segments.radius.numpy()[v][0]) == pytest.approx(0.1)
    # (0.1, 0.05): the leaf shrinks to the smaller radius and the max_radius
    # quirk (hough_3d_lines.h:298-307) rejects the same tube, in both
    ref, res = run_all(pts, *configs(shapes, radius_sizes=(0.1, 0.05), **kw))
    assert len(ref[0]) == 0 and not res.segments.valid.any()


def test_fat_tube_decomposes_into_surface_strips():
    cfg, jcfg = configs(dict(max_raw_points=2048, max_points=2048), granularity=2,
                        opt_minvotes=10, min_pca_coeff=0.5, radius_sizes=(0.05,))
    ref, res = run_all(tube(0.3, [0.7, 0.0, 1.0], [0, 1, 0], seed=3), cfg, jcfg)
    same_counts(ref, res)
    v = res.segments.valid.numpy()
    assert v.sum() >= 2
    for b in res.segments.b.numpy()[v]:
        assert abs(b @ np.array([0.0, 1.0, 0.0])) / np.linalg.norm(b) > 0.99


def test_opt_nlines_zero_unbounded():
    cfg, jcfg = configs(dict(max_raw_points=2048, max_points=1024, max_iters=12),
                        granularity=2, opt_nlines=0, opt_minvotes=10, min_pca_coeff=0.9)
    rng = np.random.default_rng(4)
    pts = beams(rng, (([0.2, -0.4, 0.6], [1.0, 0, 0]), ([0.1, 0.3, 1.1], [0, 1.0, 0.2])),
                300, 0.004, 1.4)
    ref, res = run_all(pts, cfg, jcfg)
    same_counts(ref, res)
    assert ref[1] >= 2


def test_segment_capacity_respected():
    cfg, jcfg = configs(dict(max_raw_points=2048, max_points=1024), granularity=1,
                        opt_nlines=3, opt_minvotes=8, min_pca_coeff=0.5)
    rng = np.random.default_rng(5)
    clouds = []
    for i in range(5):
        t = np.linspace(0, 1.2, 150)
        a = rng.uniform([-0.3, -0.8, 0.3], [0.8, 0.8, 1.5])
        b = rng.normal(size=3)
        b /= np.linalg.norm(b)
        clouds.append(a + t[:, None] * b + rng.normal(0, 0.004, (150, 3)))
    ref, res = run_all(np.concatenate(clouds).astype(np.float32), cfg, jcfg)
    assert ref[1] <= 3 and int(res.segments.valid.sum()) <= 3
    assert int(res.nlines) == ref[1]


def test_small_point_capacity_regression():
    """max_points below the 512 removed-point columns of one update."""
    cfg, jcfg = configs(dict(max_raw_points=256, max_points=128), granularity=1,
                        opt_minvotes=5, min_pca_coeff=0.9)
    rng = np.random.default_rng(0)
    t = np.linspace(0, 1.2, 100)
    pts = (np.array([0.3, -0.4, 0.6]) + t[:, None] * np.array([0.0, 1.0, 0.2])
           + rng.normal(0, 0.004, (100, 3))).astype(np.float32)
    ref, res = run_all(pts, cfg, jcfg)
    same_counts(ref, res)


def test_granularity_zero_antipodal_dirs():
    cfg, jcfg = configs(dict(max_raw_points=1024, max_points=512), granularity=0,
                        opt_minvotes=8, min_pca_coeff=0.9)
    rng = np.random.default_rng(1)
    t = np.linspace(0, 1.4, 250)
    pts = (np.array([0.4, 0.0, 0.8]) + t[:, None] * hough_space(0)[0][3]
           + rng.normal(0, 0.004, (250, 3))).astype(np.float32)
    ref, res = run_all(pts, cfg, jcfg)
    same_counts(ref, res)
    assert len(ref[0]) >= 1


def test_delta_histogram_exact_at_large_num_x():
    """The carry subtract's delta against the difference of two full
    histograms, bit-exact at 300 cells a side, and each equal to the JAX
    package's histogram."""
    rng = np.random.default_rng(7)
    N, NX = 512, 300
    _, c1, c2 = hough_space(1)
    c1t, c2t = torch.tensor(c1, dtype=torch.float32), torch.tensor(c2, dtype=torch.float32)
    d, dx = torch.tensor(3.0), torch.tensor(3.0 / NX)
    half, nx = d / 2.0, torch.tensor(NX, dtype=torch.int32)
    X = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    active = rng.random(N) < 0.9
    removed = active & (rng.random(N) < 0.3)
    Xs = torch.from_numpy(X)
    xi, _ = V.vote_bins(Xs, c1t, c2t, half, dx, nx)
    assert int(xi.max()) > 256

    def hist(mask):
        return V.vote_histogram(Xs, torch.from_numpy(mask), c1t, c2t, half, dx, nx, NX)

    n_rem = int(removed.sum())
    Xr = _compact_removed(Xs, torch.from_numpy(removed), n_rem).contiguous()
    delta = V.vote_histogram(Xr, torch.ones(n_rem, dtype=torch.bool), c1t, c2t, half, dx,
                             nx, NX)
    full, remaining = hist(active), hist(active & ~removed)
    assert torch.equal(full - delta, remaining)
    jfull = JH._vote_histogram(jnp.asarray(X), jnp.asarray(c1, jnp.float32),
                               jnp.asarray(c2, jnp.float32), jnp.float32(3.0),
                               jnp.float32(3.0 / NX), NX, jnp.asarray(active), NX)
    np.testing.assert_array_equal(full.numpy(), np.asarray(jfull))


def test_small_radius_num_x_gt_256_parity():
    cfg, jcfg = configs(dict(max_raw_points=4096, max_points=2048), granularity=2,
                        opt_minvotes=12, min_pca_coeff=0.9, opt_nlines=5,
                        radius_sizes=(0.015,))
    assert cfg.num_x_max == jcfg.num_x_max > 256
    pts = beams(np.random.default_rng(11), (([0.2, -0.6, 0.3], [0.1, 1.0, 0.2]),
                                            ([0.8, 0.5, 1.1], [1.0, -0.2, 0.1])),
                400, 0.003, 1.3)
    ref, res = run_all(pts, cfg, jcfg)
    same_counts(ref, res)
    assert len(ref[0]) >= 2


def test_opt_nlines_above_max_iters_not_truncated():
    cfg, jcfg = configs(dict(max_raw_points=4096, max_points=2048, max_iters=3),
                        granularity=1, opt_minvotes=8, min_pca_coeff=0.8, opt_nlines=6)
    rng = np.random.default_rng(5)
    clouds = []
    for i in range(5):
        a = rng.uniform([-0.4, -0.8, 0.2], [0.8, 0.8, 1.4])
        b = rng.normal(size=3)
        b /= np.linalg.norm(b)
        t = np.linspace(0, 1.2, 200)
        clouds.append(a + t[:, None] * b + rng.normal(0, 0.004, (200, 3)))
    ref, res = run_all(np.concatenate(clouds).astype(np.float32), cfg, jcfg)
    same_counts(ref, res)
    assert ref[1] > 3       # a bound of max_iters would have stopped at 3


def test_large_sensor_sort_gap_path():
    """8,192 points, where the JAX package switches its gap check from the
    rank matrix to the sort the port always uses."""
    cfg, jcfg = configs(dict(max_raw_points=16384, max_points=8192), granularity=2,
                        opt_nlines=4, opt_minvotes=12, min_pca_coeff=0.9)
    assert jcfg.shapes.max_points > JH._GAP_RANK_MAX_N
    pts = beams(np.random.default_rng(21), (([0.2, -0.6, 0.3], [0.1, 1.0, 0.2]),
                                            ([0.9, 0.5, 1.1], [1.0, -0.2, 0.1])),
                500, 0.003, 1.3)
    ref, res = run_all(pts, cfg, jcfg)
    same_counts(ref, res)
    assert len(ref[0]) == 2
