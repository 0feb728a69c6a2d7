"""The PyTorch port's world-map fusion and intersections vs the JAX package's."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointcloud_segmentation_tpu.config import default_config, StaticShapes
from pointcloud_segmentation_tpu.ops.hough import SegmentBatch as JSegmentBatch
from pointcloud_segmentation_tpu import worldmap as JW

from pointcloud_segmentation_tpu_torch import worldmap as TW
from pointcloud_segmentation_tpu_torch.convert import (
    world_state_from_numpy, world_state_to_numpy)
from pointcloud_segmentation_tpu_torch.ops.hough import SegmentBatch

torch.set_num_threads(2)

CFG = default_config(granularity=2, opt_nlines=6,
                     shapes=StaticShapes(max_world_segments=12))
S, L, N = 12, 6, 8


def random_world(rng, count):
    a = rng.uniform(-1, 1, (S, 3))
    b = rng.normal(size=(S, 3))
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    inter = np.full((S, S, 2), -1.0)
    stale = rng.random((S, S)) < 0.2
    inter[stale] = rng.uniform(-1, 1, (int(stale.sum()), 2))
    valid = np.arange(S) < count
    return {
        "a": a, "b": b, "t_min": rng.uniform(-0.6, -0.1, S),
        "t_max": rng.uniform(0.4, 1.0, S), "radius": np.full(S, 0.05),
        "points_size": rng.integers(20, 200, S).astype(np.int32),
        "pca_coeff": rng.uniform(0.995, 1.0, S),
        "pca_eigenvalues": rng.uniform(0, 1, (S, 3)),
        "valid": valid, "count": np.int32(count), "inter": inter,
    }


def frame_from_world(rng, w, sources, n_valid):
    """Frame segments near the world segments `sources` (-1: a new random
    segment); rows from n_valid on are invalid."""
    f = {k: np.zeros((L,) + np.shape(w[k])[1:]) for k in
         ("a", "b", "t_min", "t_max", "radius", "pca_coeff", "pca_eigenvalues")}
    f["points_size"] = rng.integers(15, 90, L).astype(np.int32)
    for i, src in enumerate(sources):
        if src >= 0:
            f["a"][i] = w["a"][src] + rng.normal(0, 0.005, 3)
            f["b"][i] = w["b"][src] + rng.normal(0, 0.005, 3)
            f["t_min"][i] = w["t_min"][src] + 0.05
            f["t_max"][i] = w["t_max"][src] + 0.1
        else:
            f["a"][i] = rng.uniform(-1, 1, 3) + 3.0
            f["b"][i] = rng.normal(size=3)
            f["t_min"][i], f["t_max"][i] = -0.3, 0.5
    f["radius"][:] = 0.05
    f["pca_coeff"] = rng.uniform(0.995, 1.0, L)
    f["pca_eigenvalues"] = rng.uniform(0, 1, (L, 3))
    f["point_mask"] = np.zeros((L, N), bool)
    f["valid"] = np.arange(L) < n_valid
    return f


def to_jax_world(w):
    return JW.WorldState(**{k: jnp.asarray(np.asarray(w[k]).astype(
        np.float32 if np.asarray(w[k]).dtype == np.float64 else np.asarray(w[k]).dtype))
        for k in JW.WorldState._fields})


def to_jax_segs(f):
    return JSegmentBatch(**{k: jnp.asarray(np.asarray(f[k]).astype(
        np.float32 if np.asarray(f[k]).dtype == np.float64 else np.asarray(f[k]).dtype))
        for k in JSegmentBatch._fields})


def to_torch_segs(f):
    return SegmentBatch(**{k: torch.from_numpy(np.asarray(f[k]).astype(
        np.float32 if np.asarray(f[k]).dtype == np.float64 else np.asarray(f[k]).dtype))
        for k in SegmentBatch._fields})


def assert_states_close(ts, js):
    tn = world_state_to_numpy(ts)
    for k in JW.WorldState._fields:
        ref = np.asarray(getattr(js, k))
        if ref.dtype.kind in "biu":
            np.testing.assert_array_equal(tn[k], ref, err_msg=k)
        else:
            np.testing.assert_allclose(tn[k], ref, atol=1e-5, rtol=1e-5, err_msg=k)


# world-segment sources per frame row: same-slot collisions (two rows near one
# world segment), fuses, appends, and a frame that fills the map to capacity
SCENARIOS = {
    "collision": ([2, 2, 4, -1, -1, 0], 5, 6),
    "all_new": ([-1, -1, -1, -1, -1, -1], 6, 3),
    "capacity": ([-1, -1, -1, 1, -1, -1], 6, 10),
    "empty_world": ([-1, -1, -1, -1, -1, -1], 4, 0),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_world_step_matches_jax(name):
    sources, n_valid, count = SCENARIOS[name]
    rng = np.random.default_rng(sorted(SCENARIOS).index(name))
    w = random_world(rng, count)
    f = frame_from_world(rng, w, sources, n_valid)
    js, jslots = JW.world_step(to_jax_world(w), to_jax_segs(f), CFG)
    ts, tslots = TW.world_step(world_state_from_numpy(w, "cpu"), to_torch_segs(f), CFG)
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    assert_states_close(ts, js)


def test_collision_fuses_last_writer_into_one_slot():
    sources, n_valid, count = SCENARIOS["collision"]
    rng = np.random.default_rng(0)
    w = random_world(rng, count)
    f = frame_from_world(rng, w, sources, n_valid)
    new, cnt, valid, modified, new_flags, slots = TW.fuse_frame(
        world_state_from_numpy(w, "cpu"), to_torch_segs(f), CFG)
    jnew, jcnt, jvalid, jmod, jflags, jslots = JW.fuse_frame(
        to_jax_world(w), to_jax_segs(f), CFG)
    assert slots[:2].tolist() == [2, 2]
    np.testing.assert_array_equal(modified.numpy(), np.asarray(jmod))
    np.testing.assert_array_equal(new_flags.numpy(), np.asarray(jflags))
    assert int(cnt) == int(jcnt) == count + 2
    np.testing.assert_allclose(new["a"][2].numpy(), np.asarray(jnew["a"])[2], atol=1e-5)


def test_update_intersections_matches_jax():
    """Intersecting pairs written, stale entries kept, parallel pairs skipped."""
    rng = np.random.default_rng(4)
    w = random_world(rng, 8)
    # make a few pairs cross: segment k passes through a point of segment k-1
    for k in (1, 3, 5):
        p = w["a"][k - 1] + 0.2 * w["b"][k - 1]
        w["a"][k] = p - 0.3 * w["b"][k]
    w["b"][7] = w["b"][6]                         # a parallel pair
    touched = np.zeros(S, bool)
    touched[[1, 3, 5, 7]] = True
    fields = {k: w[k] for k in ("a", "b", "t_min", "t_max", "radius")}
    ref = np.asarray(JW.update_intersections(
        {k: jnp.asarray(v, jnp.float32) for k, v in fields.items()},
        jnp.asarray(w["valid"]), jnp.asarray(w["inter"], jnp.float32),
        jnp.asarray(touched), CFG))
    out = TW.update_intersections(
        {k: torch.tensor(v, dtype=torch.float32) for k, v in fields.items()},
        torch.from_numpy(w["valid"]), torch.tensor(w["inter"], dtype=torch.float32),
        torch.from_numpy(touched), CFG).numpy()
    np.testing.assert_array_equal(out == -1.0, ref == -1.0)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=1e-5)
    fresh = (ref != np.float32(w["inter"])).any(-1)
    assert fresh.sum() >= 3


def test_multi_frame_sequence_matches_jax():
    rng = np.random.default_rng(9)
    w = random_world(rng, 0)
    js, ts = to_jax_world(w), world_state_from_numpy(w, "cpu")
    for step in range(5):
        cur = world_state_to_numpy(ts)
        n = int(cur["count"])
        sources = [int(rng.integers(0, n)) if n and rng.random() < 0.6 else -1
                   for _ in range(L)]
        f = frame_from_world(rng, cur, sources, int(rng.integers(2, L + 1)))
        js, _ = JW.world_step(js, to_jax_segs(f), CFG)
        ts, _ = TW.world_step(ts, to_torch_segs(f), CFG)
        assert_states_close(ts, js)
    assert int(ts.count) >= 4


# ------------------------------------------------------------------ sequential

FUZZ_CFG = default_config(
    granularity=2,
    shapes=StaticShapes(max_raw_points=4096, max_points=2048,
                        max_world_segments=6))      # tiny: forces overflow
FUZZ_FIELDS = ("a", "b", "t_min", "t_max", "radius", "points_size", "pca_coeff",
               "pca_eigenvalues")


def fuzz_batch(segs, L, dtype):
    """A frame's SegmentBatch fields as numpy arrays from a list of dicts."""
    f = {"a": np.zeros((L, 3), dtype), "b": np.zeros((L, 3), dtype),
         "t_min": np.zeros(L, dtype), "t_max": np.zeros(L, dtype),
         "radius": np.zeros(L, dtype), "points_size": np.zeros(L, np.int32),
         "pca_coeff": np.zeros(L, dtype), "pca_eigenvalues": np.zeros((L, 3), dtype),
         "point_mask": np.zeros((L, N), bool), "valid": np.zeros(L, bool)}
    for i, s in enumerate(segs):
        for k in FUZZ_FIELDS:
            f[k][i] = s[k]
        f["valid"][i] = True
    return f


def fuzz_seg(rng, a, b, t_min, t_max, n=50):
    return {"a": np.asarray(a, np.float64), "b": np.asarray(b, np.float64),
            "t_min": t_min, "t_max": t_max, "radius": 0.05, "points_size": n,
            "pca_coeff": 0.999, "pca_eigenvalues": np.array([1.0, 1e-3, 1e-3])}


def random_line(rng):
    b = rng.normal(0, 1, 3)
    return rng.normal(0, 0.5, 3), b / max(np.linalg.norm(b), 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fuse_frame_vectorized_matches_sequential(dtype):
    """The fuzz of tests/test_worldmap_jax.py on the port: the vectorized
    last-writer-wins fusion is bit-identical to the literal sequential loop
    (slot collisions, capacity overflow, invalid frame segments), in both
    compute types; in float32 both also give the JAX package's sequential
    loop's slots, counts and flags, and its fields within 1e-5."""
    rng = np.random.default_rng(1234)
    cfg = FUZZ_CFG
    npdt = np.dtype(dtype)
    tdt = getattr(torch, dtype)
    L = cfg.max_lines
    collisions = overflows = 0
    for trial in range(20):
        ts = TW.init_world(cfg, "cpu", tdt)
        js = JW.init_world(cfg)
        seeds = [fuzz_seg(rng, *random_line(rng), -1.0, 1.0)
                 for _ in range(int(rng.integers(0, 5)))]
        if seeds:
            f0 = fuzz_batch(seeds, L, npdt)
            ts, _ = TW.world_step(ts, SegmentBatch(**{k: torch.from_numpy(v) for k, v in f0.items()}), cfg)
            js, _ = JW.world_step(js, JSegmentBatch(**{k: jnp.asarray(v) for k, v in f0.items()}), cfg)
        segs = []
        for _ in range(int(rng.integers(1, 8))):
            if seeds and rng.random() < 0.5:
                base = seeds[int(rng.integers(0, len(seeds)))]
                segs.append(fuzz_seg(rng, base["a"] + rng.normal(0, 0.002, 3), base["b"],
                                     -1.0 + rng.random() * 0.1, 1.0,
                                     n=int(rng.integers(20, 90))))
            else:
                segs.append(fuzz_seg(rng, *random_line(rng), -1.0, 1.0))
        f = fuzz_batch(segs, L, npdt)
        if rng.random() < 0.5:          # an invalid row in the middle
            f["valid"][int(rng.integers(0, len(segs)))] = False
        batch = SegmentBatch(**{k: torch.from_numpy(v) for k, v in f.items()})

        out_v = TW.fuse_frame(ts, batch, cfg)
        out_s = TW.fuse_frame_sequential(ts, batch, cfg)
        for xv, xs in zip(out_v, out_s):
            if isinstance(xv, dict):
                for key in xv:
                    assert xv[key].dtype == xs[key].dtype
                    assert torch.equal(xv[key], xs[key]), f"trial {trial} field {key}"
            else:
                assert xv.dtype == xs.dtype
                assert torch.equal(xv, xs), f"trial {trial}"
        slots = out_s[5]
        live = slots[slots >= 0]
        collisions += int(len(live) != len(set(live.tolist())))
        overflows += int((torch.from_numpy(f["valid"]) & (slots == -1)).any())

        if dtype == "float32":
            jout = JW.fuse_frame_sequential(
                js, JSegmentBatch(**{k: jnp.asarray(v) for k, v in f.items()}), cfg)
            for got, want in zip(out_s[1:], jout[1:]):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            for key in FUZZ_FIELDS:
                np.testing.assert_allclose(out_s[0][key].numpy(), np.asarray(jout[0][key]),
                                           atol=1e-5, rtol=1e-5, err_msg=key)
    assert collisions >= 2 and overflows >= 2


def test_sequential_fusion_reads_no_host_value(monkeypatch):
    """fuse_frame_sequential decides with torch.where on device flags: it
    never turns a tensor into a Python number."""
    def refuse(*a, **k):
        raise AssertionError("host read in fuse_frame_sequential")

    rng = np.random.default_rng(2)
    w = random_world(rng, 5)
    f = frame_from_world(rng, w, [2, 2, 4, -1, -1, 0], 5)
    state, segs = world_state_from_numpy(w, "cpu"), to_torch_segs(f)
    want = TW.fuse_frame(state, segs, CFG)
    for name in ("item", "tolist", "__bool__", "__int__", "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = TW.fuse_frame_sequential(state, segs, CFG)
    monkeypatch.undo()
    assert torch.equal(got[5], want[5]) and torch.equal(got[0]["a"], want[0]["a"])
