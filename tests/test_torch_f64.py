"""The port's float64 parity mode on the CPU (the kernels' plain versions):
twins of tests/test_parity_f64.py at the same small sizes.

The port in compute_dtype="float64" against its own copy of the numpy oracle
within 1e-4, with nlines, status and points_size exact; against the JAX
package under jax.enable_x64 on the same numpy-seeded inputs within 1e-6,
integers exact (the scatter and covariance eigensolves are float32 by spec in
both, and the two sum their float32 scatter matrices in different orders, so
the float64 fields agree to float32 rounding of a unit direction, ~1e-7, and
not to 1e-9; 2e-8 is the most seen); lazy voting equal to carry voting in float64; and
the float32 default unchanged: bit-equal to results the port gave before it
learned float64, kept in tests/fixtures/torch_f32_before_f64.npz.
"""

import dataclasses
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloud_segmentation_tpu import config as JC
from pointcloud_segmentation_tpu import pipeline as JP
from pointcloud_segmentation_tpu.ops.hough import extract_lines as jax_extract_lines

from pointcloud_segmentation_tpu_torch import SegmentationEngine, oracle
from pointcloud_segmentation_tpu_torch import config as TC
from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy
from pointcloud_segmentation_tpu_torch.io.scene import (OBS_TESTS_SCENE, WP_TESTS,
                                                        trajectory_poses)
from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec, simulate_trajectory
from pointcloud_segmentation_tpu_torch.ops.hough import direction_tables, extract_lines
from pointcloud_segmentation_tpu_torch.pipeline import process_frame
from pointcloud_segmentation_tpu_torch.worldmap import init_world

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4          # port f64 vs the oracle, as tests/test_parity_f64.py
JAX_TOL = 1e-6      # port f64 vs JAX f64: float64 but for the float32 eigensolves
# the two small covariance eigenvalues come out of the float32 closed-form
# solver's cancellation (1e-5 beside a largest eigenvalue of 0.17); nothing
# downstream reads them (pca_coeff needs the largest and the trace)
JAX_TOL_BY_FIELD = {"pca_eigenvalues": 1e-4}

SHAPES = dict(max_raw_points=4096, max_points=2048, max_world_segments=32)
CFG = TC.default_config(granularity=2, compute_dtype="float64",
                        shapes=TC.StaticShapes(**SHAPES))
JCFG = JC.default_config(granularity=2, compute_dtype="float64",
                         shapes=JC.StaticShapes(**SHAPES))


def pad(pts, n):
    out = np.full((n, 3), np.nan, np.float64)
    out[: len(pts)] = pts
    return out


def world_rows(state):
    w = world_state_to_numpy(state)
    n = int(w["count"])
    rows = {k: w[k][:n] for k in ("a", "b", "t_min", "t_max", "radius",
                                  "points_size", "pca_coeff")}
    inter = [(i, float(w["inter"][i, j, 0]), j, float(w["inter"][i, j, 1]))
             for i in range(n) for j in range(i)
             if w["inter"][i, j, 0] != -1.0 and w["inter"][i, j, 1] != -1.0]
    return n, rows, inter


def port_replay(cfg, frames):
    """(state, per-frame nlines, per-frame status) of process_frame in the
    config's compute type on the CPU."""
    dt = torch.float64 if cfg.compute_dtype == "float64" else torch.float32
    tables = direction_tables(cfg.granularity, "cpu", dt)
    state = init_world(cfg, "cpu")
    nlines, status = [], []
    for f in frames:
        state, out = process_frame(
            state, torch.from_numpy(pad(f.points, cfg.shapes.max_raw_points)),
            torch.tensor(f.position, dtype=dt), torch.tensor(f.quat_wxyz, dtype=dt),
            cfg, tables)
        nlines.append(int(out.nlines))
        status.append(int(out.status))
    return state, nlines, status


def oracle_replay(cfg, frames):
    wm = oracle.WorldMap(cfg)
    res = [oracle.process_frame(wm, f.points, f.position, f.quat_wxyz, cfg)
           for f in frames]
    return wm, [r.nblines for r in res], [r.status for r in res]


def assert_world_matches_oracle(state, wm):
    n, rows, inter = world_rows(state)
    assert state.a.dtype == torch.float64
    assert n == len(wm.segments)
    for k, rs in enumerate(wm.segments):
        p1r, p2r = rs.endpoints()
        p1 = rows["t_min"][k] * rows["b"][k] + rows["a"][k]
        p2 = rows["t_max"][k] * rows["b"][k] + rows["a"][k]
        assert np.linalg.norm(p1 - p1r) <= TOL, f"seg {k} endpoint 1"
        assert np.linalg.norm(p2 - p2r) <= TOL, f"seg {k} endpoint 2"
        assert rows["radius"][k] == rs.radius
        assert rows["points_size"][k] == rs.points_size
        assert abs(rows["pca_coeff"][k] - rs.pca_coeff) <= TOL
    ref = wm.intersections_rows()
    assert [(i, j) for i, _, j, _ in inter] == [(i, j) for i, _, j, _ in ref]
    for (_, t1, _, t2), (_, r1, _, r2) in zip(inter, ref):
        assert abs(t1 - r1) <= TOL and abs(t2 - r2) <= TOL


@pytest.fixture(scope="module")
def obs_frames():
    poses = trajectory_poses(WP_TESTS, hz=1.5, velocity=0.3)
    return simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.002), seed=0)


@pytest.fixture(scope="module")
def obs_port(obs_frames):
    return port_replay(CFG, obs_frames)


def test_f64_end_to_end_parity_obs_scene(obs_frames, obs_port):
    """Full replay of the 7-beam benchmark scene: world segments, per-frame
    nlines and status, and intersections agree with the oracle <= 1e-4."""
    state, nlines, status = obs_port
    wm, ref_nlines, ref_status = oracle_replay(CFG, obs_frames)
    assert nlines == ref_nlines and status == ref_status
    assert len(wm.segments) >= 5
    assert_world_matches_oracle(state, wm)


def test_f64_end_to_end_matches_jax_f64(obs_frames, obs_port):
    """The same replay through the JAX package in float64: integers exact,
    every float of the world map within 1e-6 (pca_eigenvalues 1e-4)."""
    state, nlines, status = obs_port
    with jax.enable_x64(True):
        step = jax.jit(lambda s, r, p, q: JP.process_frame(s, r, p, q, JCFG))
        js = JP.init_world(JCFG)
        jn, jst = [], []
        for f in obs_frames:
            js, out = step(js, jnp.asarray(pad(f.points, SHAPES["max_raw_points"])),
                           jnp.asarray(f.position, jnp.float64),
                           jnp.asarray(f.quat_wxyz, jnp.float64))
            jn.append(int(out.nlines))
            jst.append(int(out.status))
        assert js.a.dtype == jnp.float64
        ref = {k: np.asarray(getattr(js, k)) for k in js._fields}
    assert nlines == jn and status == jst
    got = world_state_to_numpy(state)
    for k, want in ref.items():
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], want, err_msg=k)
        else:
            assert got[k].dtype == np.float64
            np.testing.assert_allclose(got[k], want, rtol=0, err_msg=k,
                                       atol=JAX_TOL_BY_FIELD.get(k, JAX_TOL))


def line_cloud(rng, n_lo, n_hi, t_hi):
    clouds = []
    for _ in range(int(rng.integers(1, 4))):
        a = rng.uniform([-0.3, -0.8, 0.2], [0.8, 0.8, 1.5])
        b = rng.normal(size=3)
        b /= np.linalg.norm(b)
        t = np.linspace(0, t_hi, int(rng.integers(n_lo, n_hi)))
        clouds.append(a + t[:, None] * b + rng.normal(0, 0.005, (len(t), 3)))
    return np.concatenate(clouds)


def padded_cloud(pts, n, dtype):
    padded = np.zeros((n, 3), dtype)
    padded[: len(pts)] = pts
    valid = np.zeros(n, bool)
    valid[: len(pts)] = True
    return padded, valid


def port_extract(pts, cfg, dtype=np.float64):
    padded, valid = padded_cloud(pts, cfg.shapes.max_points, dtype)
    return extract_lines(torch.from_numpy(padded), torch.from_numpy(valid), cfg)


@pytest.mark.parametrize("seed", range(3))
def test_f64_hough_parity_random_scenes(seed):
    """Standalone extraction on random multi-line scenes at <= 1e-4."""
    pts = line_cloud(np.random.default_rng(seed + 77), 150, 300, 1.4)
    cfg = dataclasses.replace(CFG, opt_nlines=6)
    ref_segs, ref_nlines, ref_status = oracle.hough3dlines(pts, cfg)
    res = port_extract(pts, cfg)
    v = res.segments.valid.numpy()
    assert res.segments.a.dtype == torch.float64
    assert int(res.status) == ref_status
    assert int(res.nlines) == ref_nlines
    assert int(v.sum()) == len(ref_segs) >= 1
    a, b = res.segments.a.numpy()[v], res.segments.b.numpy()[v]
    t0, t1 = res.segments.t_min.numpy()[v], res.segments.t_max.numpy()[v]
    for k, rs in enumerate(ref_segs):
        p1r, p2r = rs.endpoints()
        assert np.linalg.norm(t0[k] * b[k] + a[k] - p1r) <= TOL
        assert np.linalg.norm(t1[k] * b[k] + a[k] - p2r) <= TOL
        assert res.segments.points_size.numpy()[v][k] == rs.points_size
        assert abs(res.segments.pca_coeff.numpy()[v][k] - rs.pca_coeff) <= TOL


@pytest.mark.parametrize("seed", range(3))
def test_f64_hough_matches_jax_f64(seed):
    """The same extraction through the JAX package in float64: valid,
    points_size, point masks, nlines and status exact, floats within 1e-6
    (pca_eigenvalues 1e-4)."""
    pts = line_cloud(np.random.default_rng(seed + 77), 150, 300, 1.4)
    res = port_extract(pts, dataclasses.replace(CFG, opt_nlines=6))
    jcfg = JCFG.replace(opt_nlines=6)
    padded, valid = padded_cloud(pts, jcfg.shapes.max_points, np.float64)
    with jax.enable_x64(True):
        jres = jax.jit(lambda p, v: jax_extract_lines(p, v, jcfg))(
            jnp.asarray(padded, jnp.float64), jnp.asarray(valid))
        ref = {k: np.asarray(getattr(jres.segments, k)) for k in jres.segments._fields}
        jn, jst = int(jres.nlines), int(jres.status)
    assert (int(res.nlines), int(res.status)) == (jn, jst)
    for k, want in ref.items():
        got = getattr(res.segments, k).numpy()
        if want.dtype.kind in "biu":
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            assert got.dtype == np.float64
            np.testing.assert_allclose(got, want, rtol=0, err_msg=k,
                                       atol=JAX_TOL_BY_FIELD.get(k, JAX_TOL))


def test_f64_end_to_end_parity_shipped_g6_lazy():
    """<= 1e-4 parity on the shipped direction count: granularity 6 resolves
    voting to the lazy path (vote_state, the tiered re-exam), which the g2
    replay never touches.  A 32x32 ToF and 4 frames keep the oracle and the
    plain voting tractable on the CPU."""
    cfg = TC.default_config(
        granularity=6, compute_dtype="float64",
        shapes=TC.StaticShapes(max_raw_points=2048, max_points=1024,
                               max_world_segments=32))
    assert cfg.voting_mode == "lazy"
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:4]
    frames = simulate_trajectory(OBS_TESTS_SCENE, poses,
                                 TofSpec(width=32, height=32, noise_frac=0.002), seed=3)
    wm, ref_nlines, ref_status = oracle_replay(cfg, frames)
    state, nlines, status = port_replay(cfg, frames)
    assert nlines == ref_nlines and status == ref_status
    assert len(wm.segments) >= 3
    assert_world_matches_oracle(state, wm)


@pytest.mark.parametrize("seed", range(3))
def test_f64_lazy_equals_carry(seed):
    """The lazy voting state stays bit-equivalent to the carried accumulator
    in the float64 mode too: a float64 cloud, float32-by-spec bins, through
    both voting states."""
    rng = np.random.default_rng(seed + 4200)
    cfg = TC.default_config(
        granularity=int(rng.integers(1, 5)),
        opt_nlines=6, opt_minvotes=int(rng.integers(6, 16)),
        min_pca_coeff=float(rng.uniform(0.5, 0.95)),
        compute_dtype="float64",
        shapes=TC.StaticShapes(max_raw_points=2048, max_points=1024))
    pts = line_cloud(rng, 100, 250, 1.3)
    rl = port_extract(pts, dataclasses.replace(cfg, voting="lazy"))
    rc = port_extract(pts, dataclasses.replace(cfg, voting="carry"))
    assert rl.segments.a.dtype == torch.float64
    assert int(rl.nlines) == int(rc.nlines) >= 1
    assert int(rl.status) == int(rc.status)
    for k in rl.segments._fields:
        assert torch.equal(getattr(rl.segments, k), getattr(rc.segments, k)), k


# ------------------------------------------------------------------ float32

F32_SHAPES = dict(max_raw_points=4096, max_points=2048, max_world_segments=32)
F32_FIXTURE = os.path.join(HERE, "fixtures", "torch_f32_before_f64.npz")


def f32_case():
    """float32 results of the port on seeded inputs: a 6-frame g2 replay
    (carry voting) and one g3 extraction with lazy voting.  The fixture holds
    what this function returned before the port had a float64 mode."""
    cfg = TC.default_config(granularity=2, shapes=TC.StaticShapes(**F32_SHAPES))
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:6]
    frames = simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.002), seed=1)
    eng = SegmentationEngine(cfg, device="cpu")
    recs = eng.run_replay(frames)
    out = {f"world_{k}": v for k, v in world_state_to_numpy(eng.state).items()}
    out["nblines"] = np.array([r["nblines"] for r in recs])
    out["status"] = np.array([r["status"] for r in recs])

    lcfg = TC.default_config(granularity=3, opt_nlines=6, voting="lazy",
                             shapes=TC.StaticShapes(max_raw_points=2048, max_points=1024))
    res = port_extract(line_cloud(np.random.default_rng(80), 150, 300, 1.4), lcfg,
                       np.float32)
    for k in ("a", "b", "t_min", "t_max", "radius", "points_size", "pca_coeff",
              "pca_eigenvalues", "valid"):
        out[f"lazy_{k}"] = getattr(res.segments, k).numpy()
    out["lazy_nlines"] = res.nlines.numpy()
    out["lazy_status"] = res.status.numpy()
    return out


def test_f32_default_unchanged():
    """The default stays float32, state and outputs, and every float32 result
    is what it was before the float64 mode: bit-equal to the committed
    fixture.  The fixture names the CPU's vector capability it was made on
    (PyTorch's reductions sum in an order that depends on it); on another
    capability the floats are held to 1e-6 and the integers stay exact."""
    got = f32_case()
    assert got["world_a"].dtype == np.float32 and got["lazy_a"].dtype == np.float32
    assert int(got["world_count"]) >= 5 and int(got["lazy_valid"].sum()) >= 2
    with np.load(F32_FIXTURE) as want:
        same_cpu = str(want["cpu_capability"]) == torch.backends.cpu.get_cpu_capability()
        assert set(got) == set(want.files) - {"cpu_capability"}
        for k, v in got.items():
            assert v.dtype == want[k].dtype, k
            if same_cpu or v.dtype.kind in "biu":
                np.testing.assert_array_equal(v, want[k], err_msg=k)
            else:
                np.testing.assert_allclose(v, want[k], atol=1e-6, rtol=0, err_msg=k)


def test_f64_tables_and_tensors_never_pass_through_float32():
    """The direction vectors come straight from the float64 table, the plane
    bases are float32 by spec, and a float32 table is refused for a float64
    cloud instead of being widened."""
    from pointcloud_segmentation_tpu_torch.sphere import hough_space

    dirs, c1, c2 = direction_tables(3, "cpu", torch.float64)
    ref = hough_space(3)
    assert dirs.dtype == torch.float64 and c1.dtype == c2.dtype == torch.float32
    np.testing.assert_array_equal(dirs.numpy(), ref[0])
    np.testing.assert_array_equal(c1.numpy(), ref[1].astype(np.float32))
    pts = line_cloud(np.random.default_rng(5), 100, 150, 1.0)
    padded, valid = padded_cloud(pts, 1024, np.float64)
    cfg = dataclasses.replace(CFG, granularity=3)
    with pytest.raises(ValueError, match="direction table"):
        extract_lines(torch.from_numpy(padded), torch.from_numpy(valid), cfg,
                      direction_tables(3, "cpu", torch.float32))


def test_adversarial_random_config_f64_matches_oracle():
    """Soak-derived regression (seed 2023 of the parity soak): parallel 0.03 m
    beams a few cm apart with an inlier window of 0.026 m flip float32
    acceptance gates in the JAX package.  In the float64 mode the port's
    replay matches the oracle's world map and intersection topology."""
    spec = importlib.util.spec_from_file_location(
        "parity_soak_torch", os.path.join(HERE, "..", "tools", "parity_soak_torch.py"))
    ps = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ps)
    errs, klass = ps.run_pair(2023, f64=True, device="cpu")
    assert not errs, f"f64 mismatch ({klass}): {errs}"
