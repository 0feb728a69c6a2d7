"""The port's sharded execution against its own one-rank run and against the
JAX package: twins of tests/test_sharding.py, case for case.

One group of 8 gloo processes on the CPU (the JAX tests' 8 virtual devices)
is spawned once for the file and works through every case (tests/_torch_ranks.py);
the meshes 4x2, 8x1, 2x4 and 1x8 are sub-groups of it.  The port's ranks use
the kernels' plain versions, as every CPU test does.

Tolerances.  Port against port (n ranks against one rank in this process):
bit-equal, every field, every rank.  Port against the JAX package's
single-device `make_process_frame` / `extract_lines` on the same frames (what
the JAX sharding tests hold their own meshes to): nlines, status, counts and
points_size exact; float32 endpoints within 5e-3 a frame segment and 2e-2 on
the world map; float64 within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from pointcloud_segmentation_tpu.config import StaticShapes as JStaticShapes
from pointcloud_segmentation_tpu.config import default_config as jax_default_config
from pointcloud_segmentation_tpu.ops.hough import _global_argmax_winner
from pointcloud_segmentation_tpu.ops.hough import extract_lines as jax_extract_lines
from pointcloud_segmentation_tpu.ops.preproc import preprocess as jax_preprocess
from pointcloud_segmentation_tpu.pipeline import init_world as jax_init_world
from pointcloud_segmentation_tpu.pipeline import make_process_frame
from pointcloud_segmentation_tpu_torch.config import StaticShapes, default_config
from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy
from pointcloud_segmentation_tpu_torch.io.scene import (
    OBS_TESTS_SCENE, WP_TESTS, trajectory_poses)
from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec, simulate_trajectory
from pointcloud_segmentation_tpu_torch.ops.hough import PLAIN, SegmentBatch, pick_winner
from pointcloud_segmentation_tpu_torch.parallel import make_mesh, spawn
from pointcloud_segmentation_tpu_torch.pipeline import (
    frame_segments, process_frame, process_frame_packed, transform_segments)
from pointcloud_segmentation_tpu_torch.worldmap import init_world

SHAPES = dict(max_raw_points=1024, max_points=512, max_world_segments=16)
CFG = default_config(granularity=1, shapes=StaticShapes(**SHAPES))
CFG_LAZY = dataclasses.replace(CFG, voting="lazy")
CFG_CARRY = dataclasses.replace(CFG, voting="carry")
CFG_OFFSET = dataclasses.replace(CFG, surface_offset_correction=True)
CFG_F64 = default_config(granularity=1, compute_dtype="float64",
                         shapes=StaticShapes(**SHAPES))
# floor_trim_height 0: the default 0.3 cuts every accepted line of this low
# trajectory at granularity 6 (tests/test_sharding.py)
CFG_G6 = default_config(granularity=6, floor_trim_height=0.0,
                        shapes=StaticShapes(**SHAPES))

# the int32-overflow case of tests/test_sharding.py: counts tie at 7 on ranks
# 2, 5 and 6; a flat b*cells+cell key of rank 6 wraps negative
WIN_M = [1, 3, 7, 2, 0, 7, 7, 4]
WIN_B = [100, 3000, 20400, 9000, 11000, 19000, 20100, 15000]
WIN_CELL = [5, 17, 106275, 40, 8, 99000, 1, 106000]


def make_frames(n, cfg=CFG):
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:n]
    frames = simulate_trajectory(
        OBS_TESTS_SCENE, poses, TofSpec(width=32, height=32, noise_frac=0.002), seed=5)
    clouds = np.full((n, cfg.shapes.max_raw_points, 3), np.nan, np.float32)
    poss = np.zeros((n, 3), np.float32)
    quats = np.zeros((n, 4), np.float32)
    for i, fr in enumerate(frames):
        k = min(len(fr.points), cfg.shapes.max_raw_points)
        clouds[i, :k] = fr.points[:k]
        poss[i] = fr.position
        quats[i] = fr.quat_wxyz
    return clouds, poss, quats


F8, F4, F2 = make_frames(8), make_frames(4), make_frames(2)


def _cases():
    mc = [(f"multichip_{b}x{d}", "multichip", dict(cfg=CFG, n_batch=b, n_dir=d, frames=F8))
          for b, d in ((4, 2), (8, 1), (2, 4))]
    return [("world", "world", {})] + mc + [
        ("extract_4x2", "extract", dict(cfg=CFG, n_batch=4, n_dir=2, frames=F4)),
        ("extract_2x4", "extract", dict(cfg=CFG, n_batch=2, n_dir=4, frames=F4)),
        ("extract_4x1", "extract", dict(cfg=CFG, n_batch=4, n_dir=1, frames=F4)),
        ("extract_lazy_2x4", "extract", dict(cfg=CFG_LAZY, n_batch=2, n_dir=4, frames=F4)),
        ("tp_1x8", "tp", dict(cfg=CFG, n_dir=8, frames=F4)),
        ("tp_f64_1x8", "tp", dict(cfg=CFG_F64, n_dir=8, frames=F4)),
        ("winner", "winner", dict(M=WIN_M, b_idx=WIN_B, cell=WIN_CELL)),
        ("refusal", "refusal", dict(cfg=CFG, frames=make_frames(6))),
        ("offset_4x1", "multichip", dict(cfg=CFG_OFFSET, n_batch=4, n_dir=1, frames=F4)),
        ("extract_g6_lazy_2x4", "extract", dict(cfg=CFG_G6, n_batch=2, n_dir=4, frames=F2)),
    ]


@pytest.fixture(scope="module")
def pool():
    """Every case's result from each of the 8 ranks: pool[rank][case]."""
    return spawn(ranks.run_cases, 8, "cpu", args=(_cases(),), timeout_s=900.0)


def case(pool, name, rank=0):
    out = pool[rank][name]
    assert "error" not in out, out["error"]
    return out


def same_arrays(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k], equal_nan=True) for k in a)


def every_rank_equal(pool, name, key):
    first = case(pool, name)[key]
    for r in range(1, 8):
        other = case(pool, name, r)
        if other.get("member") is False:
            continue
        got = other[key]
        assert same_arrays(first, got) if isinstance(first, dict) \
            else np.array_equal(first, got), f"{name}: rank {r} differs in {key}"


# ------------------------------------------------------------- references

def tensors(cfg, frames):
    clouds, poss, quats = frames
    dt = torch.float64 if cfg.compute_dtype == "float64" else torch.float32
    return torch.from_numpy(clouds), torch.from_numpy(poss).to(dt), \
        torch.from_numpy(quats).to(dt)


def one_rank_world(cfg, frames):
    """The port's one-rank run in this process: (state dict, per-frame
    (nlines, status, world count))."""
    clouds, poss, quats = tensors(cfg, frames)
    state, outs = init_world(cfg, "cpu"), []
    for i in range(clouds.shape[0]):
        state, out = process_frame(state, clouds[i], poss[i], quats[i], cfg, voting=PLAIN)
        outs.append((int(out.nlines), int(out.status), int(out.world_count)))
    return world_state_to_numpy(state), np.array(outs)


def one_rank_extract(cfg, frames):
    clouds, poss, quats = tensors(cfg, frames)
    per = [frame_segments(clouds[i], poss[i], quats[i], cfg, voting=PLAIN)
           for i in range(clouds.shape[0])]
    segs = {k: np.stack([getattr(p[4], k).numpy() for p in per]) for k in per[0][4]._fields}
    return (segs, np.array([int(p[3].nlines) for p in per], np.int32),
            np.array([int(p[3].status) for p in per], np.int32))


def jax_cfg(cfg):
    kw = {k: getattr(cfg, k) for k in ("granularity", "voting", "compute_dtype",
                                       "surface_offset_correction", "floor_trim_height")}
    return jax_default_config(shapes=JStaticShapes(**SHAPES), **kw)


def jax_world(cfg, frames):
    """The JAX package's single-device run of the same frames."""
    jcfg = jax_cfg(cfg)
    clouds, poss, quats = frames
    f64 = cfg.compute_dtype == "float64"
    with jax.enable_x64(f64):
        pdt = jnp.float64 if f64 else jnp.float32
        step, st, outs = make_process_frame(jcfg), jax_init_world(jcfg), []
        for i in range(len(clouds)):
            st, out = step(st, jnp.asarray(clouds[i]), jnp.asarray(poss[i], pdt),
                           jnp.asarray(quats[i], pdt))
            outs.append((int(out.nlines), int(out.status), int(out.world_count)))
        return {k: np.asarray(getattr(st, k)) for k in ("a", "b", "t_min", "t_max", "radius",
                                                       "points_size", "count", "inter")}, \
            np.array(outs)


def jax_extract(cfg, frames):
    """The JAX package's unsharded extraction of each frame (drone frame)."""
    jcfg = jax_cfg(cfg)

    @jax.jit
    def run(raw):
        pts, valid, _ = jax_preprocess(raw, jcfg)
        return jax_extract_lines(pts, valid, jcfg)

    return [run(jnp.asarray(c)) for c in frames[0]]


def endpoints(a, b, t_min, t_max):
    return a + t_min[:, None] * b, a + t_max[:, None] * b


def world_close_to_jax(got, outs, cfg, frames, tol):
    want, jouts = jax_world(cfg, frames)
    np.testing.assert_array_equal(outs, jouts)      # nlines, status, count: exact
    n = int(want["count"])
    assert int(got["count"]) == n and n >= 1
    np.testing.assert_array_equal(got["points_size"][:n], want["points_size"][:n])
    np.testing.assert_array_equal(got["radius"][:n], want["radius"][:n].astype(got["radius"].dtype))
    for p, q in zip(endpoints(*(got[k][:n] for k in ("a", "b", "t_min", "t_max"))),
                    endpoints(*(want[k][:n] for k in ("a", "b", "t_min", "t_max")))):
        assert np.abs(p - q).max() <= tol
    np.testing.assert_array_equal((got["inter"][:n, :n] != -1).all(-1),
                                  (want["inter"][:n, :n] != -1).all(-1))


def extract_close_to_jax(segs, nlines, status, cfg, frames):
    """The sharded frame segments (world frame) against the JAX package's
    unsharded extraction of the same clouds (drone frame) put through the
    port's frame transform: integers exact, both endpoints a + t*b of every
    segment within 5e-3."""
    _, poss, quats = tensors(cfg, frames)
    for i, res in enumerate(jax_extract(cfg, frames)):
        assert int(res.nlines) == nlines[i] and int(res.status) == status[i]
        js = res.segments
        jv = np.asarray(js.valid)
        # the JAX result has no floor cutoff yet: the port's valid rows are among its
        v = segs["valid"][i]
        assert not (v & ~jv).any()
        np.testing.assert_array_equal(segs["points_size"][i][v],
                                      np.asarray(js.points_size)[v])
        moved = transform_segments(
            SegmentBatch(*(torch.from_numpy(np.array(getattr(js, k)))
                           for k in SegmentBatch._fields)), poss[i], quats[i])
        want = endpoints(*(getattr(moved, k).numpy() for k in ("a", "b", "t_min", "t_max")))
        got = endpoints(*(segs[k][i] for k in ("a", "b", "t_min", "t_max")))
        for p, q in zip(got, want):
            assert np.abs(p - q)[v].max(initial=0.0) <= 5e-3


# ------------------------------------------------------------------ the twins

def test_eight_ranks(pool):
    for r in range(8):
        assert case(pool, "world", r) == {"world": 8, "backend": "gloo"}


@pytest.mark.parametrize("n_batch,n_dir", [(4, 2), (8, 1), (2, 4)])
def test_multichip_step_matches_single_device(pool, n_batch, n_dir):
    name = f"multichip_{n_batch}x{n_dir}"
    ref_state, ref_outs = one_rank_world(CFG, F8)
    got = case(pool, name)
    assert same_arrays(got["state"], ref_state)              # bit for bit
    np.testing.assert_array_equal(got["nlines"], ref_outs[:, 0])
    np.testing.assert_array_equal(got["status"], ref_outs[:, 1])
    every_rank_equal(pool, name, "state")
    every_rank_equal(pool, name, "nlines")
    assert (got["collectives"] > 0) == (n_dir > 1)
    if (n_batch, n_dir) == (4, 2):      # one JAX run serves the three meshes
        world_close_to_jax(got["state"], ref_outs, CFG, F8, 2e-2)
        # frame after frame through the packed frame gives the same map
        st = init_world(CFG, "cpu")
        for cloud, pos, quat in zip(*tensors(CFG, F8)):
            st, _, _ = process_frame_packed(st, cloud, pos, quat, CFG, voting=PLAIN)
        assert same_arrays(world_state_to_numpy(st), ref_state)


def test_batched_extract_runs_sharded(pool):
    got = case(pool, "extract_4x2")
    assert got["segs"]["a"].shape[0] == 4 and got["status"].shape == (4,)
    assert got["segs"]["valid"].any()
    every_rank_equal(pool, "extract_4x2", "segs")
    extract_close_to_jax(got["segs"], got["nlines"], got["status"], CFG, F4)


def test_dir_sharding_parity_with_unsharded(pool):
    segs, nlines, status = one_rank_extract(CFG, F4)
    for name in ("extract_4x1", "extract_2x4", "extract_4x2"):
        got = case(pool, name)
        assert same_arrays(got["segs"], segs), name
        np.testing.assert_array_equal(got["nlines"], nlines)
        np.testing.assert_array_equal(got["status"], status)
    assert case(pool, "extract_4x1", 7) == {"member": False}   # ranks 4-7 sit out
    every_rank_equal(pool, "extract_2x4", "segs")


def test_tp_process_frame_matches_single_device(pool):
    ref_state, ref_outs = one_rank_world(CFG, F4)
    got = case(pool, "tp_1x8")
    assert same_arrays(got["state"], ref_state)
    np.testing.assert_array_equal(got["frames"], ref_outs)
    every_rank_equal(pool, "tp_1x8", "state")
    assert got["rows"] == 24        # 21 directions padded to a multiple of 8
    world_close_to_jax(got["state"], got["frames"], CFG, F4, 2e-2)


def test_dir_sharding_lazy_voting_parity(pool):
    """Lazy voting on direction shards (the suspect bound is the maximum
    over the ranks) equals the unsharded carry extraction."""
    segs, nlines, status = one_rank_extract(CFG_CARRY, F4)
    got = case(pool, "extract_lazy_2x4")
    assert same_arrays(got["segs"], segs)
    np.testing.assert_array_equal(got["nlines"], nlines)
    every_rank_equal(pool, "extract_lazy_2x4", "segs")


def test_dir_sharding_lazy_voting_parity_g6_full_table(pool):
    """The sharded lazy path at the real granularity-6 table: 20,481
    directions pad to 20,484 and each of 4 ranks pads its 5,121 to 5,248, so
    the suspect tiers, the tile padding and the bound across ranks all
    engage.  Equal to the one-rank lazy run and to the unsharded carry run."""
    got = case(pool, "extract_g6_lazy_2x4")
    assert got["segs"]["valid"].any(), "scene must extract at least one line at g6"
    for cfg in (dataclasses.replace(CFG_G6, voting="lazy"),
                dataclasses.replace(CFG_G6, voting="carry")):
        segs, nlines, status = one_rank_extract(cfg, F2)
        assert same_arrays(got["segs"], segs), cfg.voting
        np.testing.assert_array_equal(got["nlines"], nlines)
    every_rank_equal(pool, "extract_g6_lazy_2x4", "segs")
    extract_close_to_jax(got["segs"], got["nlines"], got["status"],
                         dataclasses.replace(CFG_G6, voting="lazy"), F2)


def test_global_argmax_winner_no_int32_overflow(pool):
    for r in range(8):
        got = case(pool, "winner", r)
        assert got["cell"] == 99000 and got["bound"] == 7
        # the rows are rank 5's, bit for bit: its -0.0 is still -0.0
        assert np.signbit(got["b0"]).all() and (got["b0"] == 0).all()
        np.testing.assert_array_equal(got["c1row"], np.full(3, 5.0, np.float32))
        np.testing.assert_array_equal(got["c2row"], np.full(3, 5.5, np.float32))
    row = pick_winner(torch.tensor([WIN_M, WIN_B, WIN_CELL], dtype=torch.int32).T)
    assert row.tolist() == [7, 19000, 99000]
    # the JAX function on the same winners
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:8]), ("dir",))
    run = shard_map(lambda m, b, c: _global_argmax_winner(m[0], b[0], c[0], "dir"),
                    mesh=mesh, in_specs=(P("dir"),) * 3, out_specs=(P(),) * 3)
    Mg, bg, cg = jax.jit(run)(jnp.array(WIN_M, jnp.float32), jnp.array(WIN_B, jnp.int32),
                              jnp.array(WIN_CELL, jnp.int32))
    assert (int(Mg), int(bg), int(cg)) == tuple(row.tolist())


def test_tp_process_frame_f64_parity_exact(pool):
    """float64 on the sharded path: float64 directions, float32 clouds cast
    by the step, and n ranks bit-equal to one."""
    got = case(pool, "tp_f64_1x8")
    assert got["dirs_dtype"] == "torch.float64" and got["c1_dtype"] == "torch.float32"
    ref_state, ref_outs = one_rank_world(CFG_F64, F4)
    assert ref_state["a"].dtype == np.float64 and int(ref_state["count"]) >= 1
    assert same_arrays(got["state"], ref_state)
    every_rank_equal(pool, "tp_f64_1x8", "state")
    world_close_to_jax(got["state"], got["frames"], CFG_F64, F4, 1e-4)


def test_make_mesh_refusals(pool):
    with pytest.raises(ValueError, match="n_dir"):
        make_mesh(n_dir=0)
    with pytest.raises(ValueError, match="parallel.spawn"):
        make_mesh(n_batch=2, n_dir=2)       # no process group in this process
    for r in range(8):
        got = case(pool, "refusal", r)
        assert "need 16x1=16 ranks, have 8 (gloo)" in got["too_few"]
        assert "n_dir must be >= 1" in got["n_dir_0"]
        assert "6 frames do not divide" in got["odd_batch"]
        if not torch.cuda.is_available():
            assert "torch.cuda.is_available() is False" in got["no_device"]


def test_sharded_paths_apply_surface_offset_correction(pool):
    ref_state, ref_outs = one_rank_world(CFG_OFFSET, F4)
    plain_state, _ = one_rank_world(CFG, F4)
    got = case(pool, "offset_4x1")
    assert same_arrays(got["state"], ref_state)
    n = int(ref_state["count"])
    assert n >= 1 and not np.array_equal(ref_state["a"][:n], plain_state["a"][:n])
    world_close_to_jax(got["state"], ref_outs, CFG_OFFSET, F4, 2e-2)


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*ZeroDivisionError"):
        spawn(ranks.fail_on_rank_one, 2, "cpu", timeout_s=120.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            spawn(ranks.run_cases, 2, "cuda", args=([],))
