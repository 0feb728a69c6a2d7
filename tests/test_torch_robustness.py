"""Hostile inputs through the port's engine on the CPU: twins of
tests/test_robustness.py, held against the port's oracle backend and against
the JAX engine on the same streams.

Tolerances: per-frame world count, nlines and status exact against the JAX
engine; world endpoints within 2e-2 of the JAX engine's and within 5e-2 of
the oracle's (the JAX test's own bound on such streams).
"""

import numpy as np
import pytest
import torch

from pointcloud_segmentation_tpu import config as JC
from pointcloud_segmentation_tpu.runtime import SegmentationEngine as JaxEngine
from pointcloud_segmentation_tpu_torch import config as TC
from pointcloud_segmentation_tpu_torch import SegmentationEngine

torch.set_num_threads(2)

SHAPES = dict(max_raw_points=1024, max_points=512, max_world_segments=16)
CFG = TC.default_config(granularity=1, shapes=TC.StaticShapes(**SHAPES))
JCFG = JC.default_config(granularity=1, shapes=JC.StaticShapes(**SHAPES))


def random_hostile_frame(rng, n=400):
    """Clouds with NaN/Inf bursts, out-of-window points, duplicates."""
    pts = rng.uniform([-2, -3, -3], [3, 3, 3], size=(n, 3)).astype(np.float32)
    k = rng.integers(0, n // 4)
    pts[rng.choice(n, k, replace=False)] = np.nan
    if rng.random() < 0.5:
        pts[rng.choice(n, 3)] = np.inf
    if rng.random() < 0.5:
        dup = pts[rng.integers(0, n)]
        pts[rng.choice(n, n // 8)] = dup
    return pts


def engine(backend, cfg=CFG):
    return SegmentationEngine(cfg, device="cpu", backend=backend)


def endpoint_gap(a, b):
    p1a = np.asarray(a["a"]) + a["t_min"] * np.asarray(a["b"])
    p2a = np.asarray(a["a"]) + a["t_max"] * np.asarray(a["b"])
    p1b = np.asarray(b["a"]) + b["t_min"] * np.asarray(b["b"])
    p2b = np.asarray(b["a"]) + b["t_max"] * np.asarray(b["b"])
    return min(np.linalg.norm(p1a - p1b) + np.linalg.norm(p2a - p2b),
               np.linalg.norm(p1a - p2b) + np.linalg.norm(p2a - p1b))


@pytest.mark.parametrize("backend", ["torch", "oracle"])
def test_engine_survives_hostile_stream(backend):
    rng = np.random.default_rng(42)
    eng = engine(backend)
    for i in range(12):
        eng.push_pose(float(i), rng.normal(0, 0.5, 3), [1.0, 0, 0, 0])
        rec = eng.process_frame(float(i), random_hostile_frame(rng))
        assert rec is not None and np.isfinite(rec["processing_time"])
    segs = eng.world_segments()
    assert len(segs) <= CFG.shapes.max_world_segments
    for s in segs:
        assert np.isfinite(s["a"]).all() and np.isfinite(s["b"]).all()
        assert np.isfinite([s["t_min"], s["t_max"]]).all()


def test_backends_agree_on_hostile_stream():
    rng = np.random.default_rng(7)
    frames = [random_hostile_frame(rng) for _ in range(8)]
    poses = [(float(i), rng.normal(0, 0.3, 3), np.array([1.0, 0, 0, 0])) for i in range(8)]
    engines = {"torch": engine("torch"), "oracle": engine("oracle"),
               "jax": JaxEngine(JCFG, backend="jax")}
    recs = {b: [] for b in engines}
    for b, eng in engines.items():
        for (t, p, q), pts in zip(poses, frames):
            eng.push_pose(t, p, q)
            r = eng.process_frame(t, pts)
            recs[b].append((r["seg_vec_size"], r["nblines"], r["status"]))
    assert recs["torch"] == recs["jax"] == recs["oracle"]
    st = engines["torch"].world_segments()
    for other, tol in (("jax", 2e-2), ("oracle", 5e-2)):
        so = engines[other].world_segments()
        assert len(st) == len(so)
        for a, b in zip(st, so):
            assert endpoint_gap(a, b) < tol


def test_world_capacity_overflow_drops_gracefully():
    """More distinct segments than capacity: extras dropped and counted."""
    shapes = dict(SHAPES, max_world_segments=4)
    cfg = TC.default_config(granularity=1, shapes=TC.StaticShapes(**shapes))
    jeng = JaxEngine(JC.default_config(granularity=1, shapes=JC.StaticShapes(**shapes)),
                     backend="jax")
    rng = np.random.default_rng(3)
    eng = engine("torch", cfg)
    for i in range(8):
        # a distinct parallel beam per frame, spaced far apart
        t = np.linspace(0, 1.4, 300)
        a = np.array([0.2, -1.2 + 0.35 * i, 0.8])
        pts = (a + t[:, None] * np.array([1.0, 0, 0])
               + rng.normal(0, 0.004, (300, 3))).astype(np.float32)
        for e in (eng, jeng):
            e.push_pose(float(i), np.zeros(3), [1.0, 0, 0, 0])
            e.process_frame(float(i), pts)
    assert len(eng.world_segments()) == len(jeng.world_segments()) == 4
    assert eng.world_overflow_frames == jeng.world_overflow_frames >= 1
    assert [r["seg_vec_size"] for r in eng.records] == \
        [r["seg_vec_size"] for r in jeng.records]


def test_frame_larger_than_capacity_truncates():
    rng = np.random.default_rng(5)
    big = rng.uniform([0, -1, -1], [1.4, 1, 1],
                      size=(CFG.shapes.max_raw_points * 3, 3)).astype(np.float32)
    eng, jeng = engine("torch"), JaxEngine(JCFG, backend="jax")
    out = []
    for e in (eng, jeng):
        e.push_pose(0.0, np.zeros(3), [1.0, 0, 0, 0])
        out.append(e.process_frame(0.0, big))
    assert out[0] is not None
    assert [out[0][k] for k in ("seg_vec_size", "nblines", "status")] == \
        [out[1][k] for k in ("seg_vec_size", "nblines", "status")]


def test_package_exports():
    import pointcloud_segmentation_tpu_torch as pkg

    assert pkg.SegmentationEngine is SegmentationEngine
    assert callable(pkg.process_frame) and callable(pkg.init_world)
    with pytest.raises(AttributeError):
        pkg.not_a_thing
