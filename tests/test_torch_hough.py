"""The PyTorch port's Hough extraction vs the JAX package's, carry and lazy.

Inputs are made from numpy seeds and go through `extract_lines_jit` and the
port's `extract_lines` on the CPU (where the port's voting takes its plain
versions).  nlines, status and inlier counts are exact; line parameters are
held at 5e-3, the README's per-segment tolerance, which absorbs rare
inlier-boundary flips from sums that XLA contracts into FMAs.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointcloud_segmentation_tpu import oracle
from pointcloud_segmentation_tpu.config import default_config, StaticShapes
from pointcloud_segmentation_tpu.ops.hough import extract_lines_jit

from pointcloud_segmentation_tpu_torch import config as TC
from pointcloud_segmentation_tpu_torch.ops import hough as TH
from pointcloud_segmentation_tpu_torch.ops.hough import extract_lines

torch.set_num_threads(2)

BASE = default_config(
    granularity=2,
    shapes=StaticShapes(max_raw_points=2048, max_points=1024),
)


def pad(pts, n):
    out = np.zeros((n, 3), np.float32)
    out[: len(pts)] = pts
    valid = np.zeros(n, bool)
    valid[: len(pts)] = True
    return out, valid


def line_cloud(rng, a, b, n=200, jitter=0.004, t_span=1.4):
    b = np.asarray(b, float)
    b /= np.linalg.norm(b)
    t = np.linspace(0, t_span, n)
    pts = np.asarray(a)[None] + t[:, None] * b[None]
    return (pts + rng.normal(0, jitter, pts.shape)).astype(np.float32)


def random_scene(seed, max_lines=5):
    rng = np.random.default_rng(seed)
    clouds = [line_cloud(rng, rng.uniform([-0.3, -0.8, 0.2], [0.8, 0.8, 1.5]),
                         rng.normal(size=3), n=int(rng.integers(100, 250)))
              for _ in range(int(rng.integers(1, max_lines)))]
    return np.concatenate(clouds)


def run_both(pts, cfg):
    padded, valid = pad(pts, cfg.shapes.max_points)
    rj = extract_lines_jit(jnp.asarray(padded), jnp.asarray(valid), cfg)
    rt = extract_lines(torch.from_numpy(padded), torch.from_numpy(valid), cfg)
    return rj, rt


def assert_same_extraction(rj, rt, atol=5e-3):
    assert int(rt.nlines) == int(rj.nlines)
    assert int(rt.status) == int(rj.status)
    sj, st = rj.segments, rt.segments
    np.testing.assert_array_equal(st.valid.numpy(), np.asarray(sj.valid))
    np.testing.assert_array_equal(st.points_size.numpy(), np.asarray(sj.points_size))
    v = np.asarray(sj.valid)
    for f in ("a", "b", "t_min", "t_max"):
        np.testing.assert_allclose(getattr(st, f).numpy()[v],
                                   np.asarray(getattr(sj, f))[v], atol=atol, rtol=0)
    np.testing.assert_array_equal(st.radius.numpy()[v], np.asarray(sj.radius)[v])


@pytest.mark.parametrize("mode", ["carry", "lazy"])
@pytest.mark.parametrize("seed", range(5))
def test_extract_lines_matches_jax(seed, mode):
    cfg = BASE.replace(voting=mode, opt_nlines=6)
    rj, rt = run_both(random_scene(seed + 200), cfg)
    assert_same_extraction(rj, rt)


@pytest.mark.parametrize("seed", range(4))
def test_lazy_equals_carry_in_the_port(seed):
    """Both modes of the port extract bit-identical lines, over random
    configurations (granularity 0-4, radii, gates, iteration bounds)."""
    rng = np.random.default_rng(seed + 1000)
    cfg = default_config(
        granularity=int(rng.integers(0, 5)),
        opt_nlines=int(rng.integers(0, 8)),
        opt_minvotes=int(rng.integers(4, 20)),
        min_pca_coeff=float(rng.uniform(0.4, 0.99)),
        rad_2_leaf_ratio=float(rng.choice([1.0, 1.5, 2.0])),
        radius_sizes=[(0.05,), (0.1,), (0.05, 0.1)][int(rng.integers(0, 3))],
        shapes=StaticShapes(max_raw_points=2048, max_points=1024, max_iters=10))
    clouds = [rng.normal(0, 0.2, (int(rng.integers(5, 60)), 3)) + [0.5, 0, 1]]
    for _ in range(int(rng.integers(1, 4))):
        a = rng.uniform([-0.4, -0.8, 0.2], [0.9, 0.8, 1.4])
        clouds.append(line_cloud(rng, a, rng.normal(size=3),
                                 n=int(rng.integers(40, 220)),
                                 jitter=float(rng.uniform(0.002, 0.01))))
    padded, valid = pad(np.concatenate(clouds).astype(np.float32), 1024)
    p, v = torch.from_numpy(padded), torch.from_numpy(valid)
    rc = extract_lines(p, v, cfg.replace(voting="carry"))
    rl = extract_lines(p, v, cfg.replace(voting="lazy"))
    assert int(rc.nlines) == int(rl.nlines) and int(rc.status) == int(rl.status)
    for f in rc.segments._fields:
        assert torch.equal(getattr(rc.segments, f), getattr(rl.segments, f)), f


@pytest.mark.parametrize("mode", ["carry", "lazy"])
def test_radius_0015_matches_jax(mode):
    """The NX 261 grid of radius_sizes=(0.015,) end to end, in both voting
    modes (the case of tests/test_hough_extra.py's num_x > 256 parity):
    each package built from its own config of the same keys."""
    keys = dict(granularity=2, opt_minvotes=12, min_pca_coeff=0.9, opt_nlines=5,
                radius_sizes=(0.015,), voting=mode)
    jcfg = default_config(**keys, shapes=StaticShapes(max_raw_points=4096, max_points=2048))
    tcfg = TC.default_config(**keys, shapes=TC.StaticShapes(max_raw_points=4096,
                                                            max_points=2048))
    assert tcfg.num_x_max == jcfg.num_x_max == 261
    rng = np.random.default_rng(11)
    clouds = []
    for a, b in (([0.2, -0.6, 0.3], [0.1, 1.0, 0.2]), ([0.8, 0.5, 1.1], [1.0, -0.2, 0.1])):
        t = np.linspace(0, 1.3, 400)
        b = np.asarray(b) / np.linalg.norm(b)
        clouds.append(np.asarray(a) + t[:, None] * b + rng.normal(0, 0.003, (400, 3)))
    padded, valid = pad(np.concatenate(clouds).astype(np.float32), 2048)
    rj = extract_lines_jit(jnp.asarray(padded), jnp.asarray(valid), jcfg)
    rt = extract_lines(torch.from_numpy(padded), torch.from_numpy(valid), tcfg)
    assert_same_extraction(rj, rt)
    assert int(rt.segments.valid.sum()) >= 2


def test_spill_branch_matches_jax():
    """A fat line removing more than 512 points takes the exact-rebuild
    branch in both modes."""
    rng = np.random.default_rng(9)
    cfg = default_config(granularity=2, opt_nlines=4, opt_minvotes=12,
                         min_pca_coeff=0.9,
                         shapes=StaticShapes(max_raw_points=2048, max_points=1024))
    pts = np.concatenate([
        line_cloud(rng, [0.2, -0.6, 0.3], [0.1, 1.0, 0.2], n=700, jitter=0.003),
        line_cloud(rng, [0.9, 0.5, 1.1], [1.0, -0.2, 0.1], n=150, jitter=0.003)])
    for mode in ("carry", "lazy"):
        rj, rt = run_both(pts, cfg.replace(voting=mode))
        assert_same_extraction(rj, rt)
        assert int(rt.segments.points_size[0]) > 512


def test_ties_match_jax():
    """Two identical parallel lines: equal-count cells, first-max tie-break."""
    cfg = default_config(granularity=1, opt_nlines=6, opt_minvotes=4,
                         min_pca_coeff=0.5,
                         shapes=StaticShapes(max_raw_points=512, max_points=256))
    t = np.linspace(0, 1.0, 40)
    l1 = np.stack([t, np.zeros_like(t), np.zeros_like(t)], 1)
    l2 = np.stack([t, np.full_like(t, 0.4), np.zeros_like(t)], 1)
    pts = np.concatenate([l1, l2]).astype(np.float32) + np.array([0.1, 0.1, 0.5], np.float32)
    for mode in ("carry", "lazy"):
        rj, rt = run_both(pts, cfg.replace(voting=mode))
        assert_same_extraction(rj, rt)     # the lines lie 0.4 apart


def test_suspect_overflow_takes_the_rebuild(monkeypatch):
    """A suspect capacity of one tile makes busy rounds overflow into the
    exact full rebuild; the lazy result must still equal carry's."""
    monkeypatch.setattr(TH, "_SUSPECT_CAP", 128)
    cfg = default_config(granularity=4, opt_nlines=8, opt_minvotes=10,
                         min_pca_coeff=0.8,
                         shapes=StaticShapes(max_raw_points=4096, max_points=2048))
    rng = np.random.default_rng(31)
    clouds = []
    for _ in range(6):
        a = rng.uniform([-0.4, -0.8, 0.2], [0.9, 0.8, 1.4])
        b = rng.normal(size=3)
        b /= np.linalg.norm(b)
        t = np.linspace(0, 1.2, 220)
        clouds.append(a + t[:, None] * b + rng.normal(0, 0.004, (220, 3)))
    padded, valid = pad(np.concatenate(clouds).astype(np.float32), 2048)
    p, v = torch.from_numpy(padded), torch.from_numpy(valid)
    rl = extract_lines(p, v, cfg.replace(voting="lazy"))
    rc = extract_lines(p, v, cfg.replace(voting="carry"))
    assert int(rl.nlines) == int(rc.nlines) >= 4
    assert torch.equal(rl.segments.points_size, rc.segments.points_size)
    assert torch.equal(rl.segments.a, rc.segments.a)


def test_g6_lazy_matches_oracle():
    """The shipped 20,481-direction table in lazy mode (radius 0.1 keeps the
    grid small), against the numpy oracle's counts."""
    rng = np.random.default_rng(77)
    cfg = default_config(granularity=6, opt_nlines=4, opt_minvotes=10,
                         min_pca_coeff=0.9, radius_sizes=(0.1,),
                         shapes=StaticShapes(max_raw_points=1024, max_points=512))
    assert cfg.voting_mode == "lazy"
    pts = np.concatenate([
        line_cloud(rng, [0.2, -0.6, 0.4], [0.2, 1.0, 0.1], n=180, jitter=0.006),
        line_cloud(rng, [0.9, 0.4, 0.3], [0.0, -0.3, 1.0], n=140, jitter=0.006)])
    ref_segs, ref_nlines, ref_status = oracle.hough3dlines(
        np.asarray(pts, np.float64), cfg)
    padded, valid = pad(pts, 512)
    rt = extract_lines(torch.from_numpy(padded), torch.from_numpy(valid), cfg)
    assert int(rt.nlines) == ref_nlines and int(rt.status) == ref_status
    v = rt.segments.valid.numpy()
    assert int(v.sum()) == len(ref_segs) >= 2
    ps = rt.segments.points_size.numpy()[v]
    for k, rs in enumerate(ref_segs):
        assert ps[k] == rs.points_size


@pytest.mark.parametrize("case", ["empty", "one_point", "tiny"])
def test_precheck_statuses_match_jax(case):
    pts = {"empty": np.zeros((0, 3), np.float32),
           "one_point": np.array([[0.3, 0.1, 1.0]], np.float32),
           "tiny": np.array([[0.3, 0.1, 1.0], [0.31, 0.1, 1.0]], np.float32)}[case]
    rj, rt = run_both(pts, BASE)
    assert_same_extraction(rj, rt, atol=0.0)
    assert int(rt.status) in (1, 2)


def test_float64_is_not_ported():
    """It is ported now: the extraction follows the points' type, float64
    clouds give float64 segments (tests/test_torch_f64.py holds them against
    the oracle), and an empty float64 cloud is the degenerate status."""
    cfg = BASE.replace(compute_dtype="float64")
    res = extract_lines(torch.zeros(4, 3, dtype=torch.float64),
                        torch.zeros(4, dtype=torch.bool), cfg)
    assert res.segments.a.dtype == res.segments.pca_eigenvalues.dtype == torch.float64
    assert (int(res.status), int(res.nlines)) == (1, 0)
    res32 = extract_lines(torch.zeros(4, 3), torch.zeros(4, dtype=torch.bool), cfg)
    assert res32.segments.a.dtype == torch.float32
