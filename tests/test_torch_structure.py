"""tools/structure_torch.py on the CPU: its flights are the JAX package's,
a short run of each holds the port to the numpy oracle and to the JAX
engine, and the committed STRUCTURE_torch.json covers every flight on the
card with summaries that recompute from their per-frame fields.  Also the
knife-edge witness of tools/parity_soak_torch.py and its b.x statistics.

Tolerances: per-frame nblines, status and world count, the world's count
and points_size exact; world endpoints within 5e-3 (README §Precision
contract, per segment) of the oracle's and of the JAX engine's.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from pointcloud_segmentation_tpu import config as JC
from pointcloud_segmentation_tpu.io import scene as JSC
from pointcloud_segmentation_tpu.io.simulator import TofSpec, simulate_trajectory
from pointcloud_segmentation_tpu.runtime import SegmentationEngine as JaxEngine
from pointcloud_segmentation_tpu_torch.io.scene import trajectory_poses

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def st():
    return _load(("tools", "structure_torch.py"), "structure_torch")


@pytest.fixture(scope="module")
def soak():
    return _load(("tools", "parity_soak_torch.py"), "parity_soak_torch")


def _tower_poses(hz, velocity):
    return JSC.trajectory_poses(
        JSC.spiral_waypoints(radius=1.2, z0=0.4, z1=2.2, turns=2.0, n=40),
        hz=hz, velocity=velocity)


def _dev_poses():
    return JSC.trajectory_poses(JSC.figure_eight_waypoints(a=1.8, z=1.7, n=32),
                                hz=1.0, velocity=0.5)


# each flight as the JAX package defines it: (scene, poses, config keys),
# from bench.py:369-389, tests/test_mockup.py:38-47, tests/test_devworld.py
# :45-79 and examples/map_a_structure.py:24-36
JAX_FLIGHTS = {
    "tower": lambda: (JSC.tower_scene(levels=2, width=1.0), _tower_poses(4.0, 0.4),
                      {"min_pca_coeff": 0.99}),
    "mockup": lambda: (JSC.mockup_scene(),
                       JSC.trajectory_poses(JSC.WP_MOCKUP, hz=1.0, velocity=0.6),
                       {"min_pca_coeff": 0.99}),
    "dev_r01": lambda: (JSC.OBS_DEV_SCENE, _dev_poses(),
                        {"radius_sizes": (0.1,), "min_pca_coeff": 0.95}),
    "dev_multi_radius": lambda: (JSC.OBS_DEV_SCENE, _dev_poses()[:8],
                                 {"radius_sizes": (0.05, 0.1), "min_pca_coeff": 0.95}),
    "example": lambda: (JSC.tower_scene(levels=2, width=1.0), _tower_poses(3.0, 0.2),
                        {"min_pca_coeff": 0.99}),
}


@pytest.mark.parametrize("name", sorted(JAX_FLIGHTS))
def test_flight_is_the_jax_packages(st, name):
    scene, poses, keys = JAX_FLIGHTS[name]()
    fl = st.FLIGHTS[name]
    port_scene, frames = st.flight_frames(name, max_frames=2)
    assert [(c.center, c.axis, c.radius, c.height) for c in port_scene] == \
        [(c.center, c.axis, c.radius, c.height) for c in scene]
    assert fl.config == keys and fl.n_frames == len(poses)
    mine = trajectory_poses(fl.waypoints(), hz=fl.hz, velocity=fl.velocity)
    mine = mine[:fl.first] if fl.first else mine
    assert len(mine) == len(poses)
    for (t, p, q), (tj, pj, qj) in zip(mine, poses):
        assert t == tj and np.array_equal(p, pj) and np.array_equal(q, qj)
    jframes = simulate_trajectory(scene, poses[:2], TofSpec(noise_frac=0.002), seed=0)
    for f, j in zip(frames, jframes):
        assert np.array_equal(f.points, j.points, equal_nan=True) and f.t == j.t
    cfg = st.flight_config(name, 4)
    jcfg = JC.default_config(granularity=4, shapes=JC.StaticShapes(4096, 2048, 64), **keys)
    assert (cfg.radius_sizes, cfg.min_pca_coeff, cfg.num_x_max) == \
        (jcfg.radius_sizes, jcfg.min_pca_coeff, jcfg.num_x_max)


def test_tower_is_the_benchmarks_tower_replay(st):
    """bench.py's build_tower_frames: the whole spiral, 157 frames; the
    tool's first and last frames equal the bench's."""
    bench = _load(("bench.py",), "bench")
    jframes = bench.build_tower_frames(None, 0)
    _, frames = st.flight_frames("tower")
    assert len(frames) == len(jframes) == st.FLIGHTS["tower"].n_frames == 157
    for k in (0, 156):
        assert np.array_equal(frames[k].points, jframes[k].points, equal_nan=True)


def _jax_run(name, granularity, frames):
    _, _, keys = JAX_FLIGHTS[name]()
    cfg = JC.default_config(granularity=granularity, shapes=JC.StaticShapes(4096, 2048, 64),
                            **keys)
    eng = JaxEngine(cfg, backend="jax")
    recs = eng.run_replay(frames)
    return recs, eng.world_segments()


@pytest.mark.parametrize("name,granularity,n", [("tower", 3, 6), ("mockup", 3, 5),
                                                ("dev_r01", 2, 6),
                                                ("dev_multi_radius", 3, 4)])
def test_short_flight_holds_to_the_oracle_and_the_jax_engine(st, name, granularity, n):
    rec = st.run_flight(name, granularity, "cpu", max_frames=n)
    assert rec["plain"] is None and rec["oracle_frames"] == rec["frames"] == n
    assert rec["ok"], {k: v for k, v in rec["checks"].items() if not v}
    assert rec["kernels"]["world_overflow_frames"] == 0
    _, frames = st.flight_frames(name, max_frames=n)
    jrecs, jsegs = _jax_run(name, granularity, frames)
    for f in ("nblines", "seg_vec_size"):
        assert rec["kernels"][f] == [int(r[f]) for r in jrecs]
    w = rec["kernels"]["world"]
    assert w["points_size"] == [int(s["points_size"]) for s in jsegs]
    jends = st.world_of(st.FLIGHTS[name].scene(), (jsegs, []))["endpoints"]
    assert st.drift(st.endpoint_errors(w["endpoints"], jends))["max"] <= st.ENDPOINT_TOL
    if name == "dev_multi_radius":
        assert w["count"] == 0 and rec["oracle"]["world"]["count"] == 0


def test_main_without_artifact(st, tmp_path, monkeypatch):
    monkeypatch.setattr(st, "ARTIFACT", str(tmp_path / "S.json"))
    assert st.main(["--device", "cpu", "--flight", "dev_multi_radius", "--granularity", "2",
                    "--max-frames", "2", "--no-artifact"]) == 0
    assert not os.listdir(tmp_path)
    out = str(tmp_path / "mine.json")
    assert st.main(["--device", "cpu", "--flight", "dev_r01", "--granularity", "2",
                    "--max-frames", "3", "--oracle-frames", "2", "--artifact", out]) == 0
    assert st.main(["--device", "cpu", "--flight", "dev_r01", "--granularity", "2",
                    "--max-frames", "3", "--artifact", out]) == 0
    recs = json.load(open(out))["records"]
    assert len(recs) == 1 and recs[0]["oracle_frames"] == 3    # replaced, not appended


def test_a_cut_oracle_compares_the_world_at_the_cut(st):
    rec = st.run_flight("dev_r01", 2, "cpu", oracle_frames=3, max_frames=5)
    assert rec["oracle_frames"] == 3 and len(rec["oracle"]["nblines"]) == 3
    cut = rec["kernels"]["world_at_cut"]
    assert cut is not None and rec["card_vs_oracle"]["world_equal"]
    assert cut["count"] == rec["oracle"]["world"]["count"]


def test_checks_catch_a_changed_record(st):
    """checks_of fails a record whose integers, world, endpoints, recall or
    overflow count part from the reference side."""
    run = {"nblines": [3, 4], "status": [0, 0], "seg_vec_size": [2, 3],
           "world": {"count": 1, "points_size": [40], "radius": [0.05], "b_x": [1.0],
                     "endpoints": [[[0, 0, 0], [1, 0, 0]]], "intersections": 0,
                     "topology": [], "recall": 1},
           "world_at_cut": None, "world_overflow_frames": 0}
    ref = json.loads(json.dumps(run))
    ok = {"kernels": run, "card_vs_oracle": st.compare(run, ref, 2, False)}
    assert all(st.checks_of(ok).values())
    bad = json.loads(json.dumps(ref))
    bad["nblines"][1] = 5
    bad["world"]["endpoints"][0][1] = [1, 0.006, 0]
    bad["world"]["recall"] = 0
    rec = {"kernels": dict(run, world_overflow_frames=1),
           "card_vs_oracle": st.compare(run, bad, 2, False)}
    failed = sorted(k for k, v in st.checks_of(rec).items() if not v)
    assert failed == ["card_vs_oracle: beams matched equal",
                      "card_vs_oracle: endpoints within 0.005",
                      "card_vs_oracle: per-frame nblines, status and seg_vec_size exact",
                      "kernels: no frame overflowed the world map"]
    # a float32 world against the oracle's table radius
    r32 = json.loads(json.dumps(run))
    r32["world"]["radius"] = [float(np.float32(0.05))]
    assert st.compare(r32, ref, 2, True)["world_equal"]
    assert not st.compare(r32, ref, 2, False)["world_equal"]


def _committed():
    with open(os.path.join(REPO, "STRUCTURE_torch.json")) as f:
        return json.load(f)["records"]


def _wanted():
    st = _load(("tools", "structure_torch.py"), "structure_torch")
    return [(n, g) for n, fl in st.FLIGHTS.items() for g in fl.granularities]


def test_committed_records_cover_every_flight_on_the_card(st):
    have = {(r["flight"], r["granularity"]) for r in _committed() if r["device"] == "cuda"}
    assert set(_wanted()) <= have
    for r in _committed():
        assert r["card"].startswith("NVIDIA H100") and r["plain"] is not None


@pytest.mark.parametrize("key", _wanted(), ids=lambda k: f"{k[0]}-g{k[1]}"
                         if isinstance(k, tuple) else str(k))
def test_committed_record_recomputes(st, key):
    """Each summary of a card record recomputes from its per-frame fields:
    the comparisons of kernels with plain and of the card with the oracle,
    the drift, the checks and the verdict."""
    rec = next(r for r in _committed()
               if (r["flight"], r["granularity"]) == key and r["device"] == "cuda")
    fl = st.FLIGHTS[key[0]]
    assert rec["frames"] == fl.n_frames == len(rec["kernels"]["nblines"])
    assert len(rec["oracle"]["nblines"]) == rec["oracle_frames"]
    for side, ref, n, f32 in (("kernels_vs_plain", rec["plain"], rec["frames"], False),
                              ("card_vs_oracle", rec["oracle"], rec["oracle_frames"], True)):
        again = st.compare(rec["kernels"], ref, n, f32)
        assert again == rec[side], side
        assert again["drift"] == st.drift(again["endpoint_errors"])
    assert st.checks_of(rec) == rec["checks"]
    assert rec["ok"] == all(rec["checks"].values())
    kernel = "vote_state" if rec["voting"] == "lazy" else "vote_histogram"
    assert rec["kernels"]["launches"][kernel] == sum(
        c["calls"] for c in rec["voting_calls"] if c["name"] == kernel) > 0


def test_witness_stores_verdicts(soak, tmp_path):
    """--witness on a batch of a divergent base seed stores its flips;
    --witness-stored adds them to a stored batch that has none."""
    art = str(tmp_path / "S.json")
    assert soak.main(["1", "5011", "--device", "cpu", "--witness", "--artifact", art]) == 0
    b = json.load(open(art))["batches"][0]
    (w,) = b["witness"]
    assert w["seed"] == 5011 and w["explained"] and not w["unexplained_frames"]
    assert w["flips"] and all(f["other_bx"] < soak.BX_NOISE for f in w["flips"])
    assert w["bx"]["agreeing"] > 0 and w["bx"]["min_above_noise"] > soak.BX_NOISE
    # the same batch stored without its witness gets it back in place
    data = json.load(open(art))
    del data["batches"][0]["witness"]
    json.dump(data, open(art, "w"))
    assert soak.main(["--witness-stored", "--device", "cpu", "--artifact", art]) == 0
    again = json.load(open(art))
    assert again["batches"][0]["witness"] == b["witness"]
    assert again["totals"] == data["totals"]


def test_bx_stats_on_hand_made_traces(soak):
    def trace(bo, bt):
        return {"oracle": {"bx": bo}, "torch": {"bx": bt}}

    # frame 0 agrees throughout; frame 1 flips at round 1, so its round 2
    # pairs refinements of different lines and is left out
    tr = trace([[0.5, 1e-12, 0.0], [0.3, 0.0, 0.7]],
               [[0.5, 3e-7, 0.0], [0.3, 4e-7, 2e-9]])
    assert soak.agreeing_bx(tr) == [(0.5, 0.5), (1e-12, 3e-7), (0.0, 0.0), (0.3, 0.3)]
    s = soak.bx_stats(soak.agreeing_bx(tr))
    assert s == {"agreeing": 4, "min_nonzero": 1e-12, "min_above_noise": 0.3,
                 "max_inplane_gap": pytest.approx(3e-7 - 1e-12)}
    empty = soak.bx_stats([])
    assert empty == {"agreeing": 0, "min_nonzero": None, "min_above_noise": None,
                     "max_inplane_gap": None}
    both = soak.merge_bx_stats([s, empty, soak.bx_stats([(2e-6, 9e-6)])])
    assert both == {"agreeing": 5, "min_nonzero": 1e-12, "min_above_noise": 2e-6,
                    "max_inplane_gap": pytest.approx(3e-7 - 1e-12)}
    # with whole directions, a refinement of another line on one side is no pair
    tr["oracle"]["b"] = [[[0.5, 0.0, 0.866], [1e-12, 1.0, 0.0], [0.0, 0.6, 0.8]],
                         [[0.3, 0.0, 0.954], [0.0, 1.0, 0.0], [0.7, 0.0, 0.714]]]
    tr["torch"]["b"] = [[[0.5, 0.0, 0.866], [3e-7, 0.0, 1.0], [0.0, 0.6, 0.8]],
                        [[0.3, 0.0, 0.954], [4e-7, 1.0, 0.0], [2e-9, 1.0, 0.0]]]
    assert soak.agreeing_bx(tr) == [(0.5, 0.5), (0.0, 0.0), (0.3, 0.3)]


def test_committed_g6_witness(soak):
    """SOAK_torch.json's g6 batches on the card carry a witness of every
    seed they hold divergent, each explained, every part a flip."""
    with open(os.path.join(REPO, "SOAK_torch.json")) as f:
        batches = json.load(f)["batches"]
    g6 = [b for b in batches if b["mode"] == "g6" and b["device"] == "cuda" and b["diverging"]]
    seeds = sorted(d["seed"] for b in g6 for d in b["diverging"])
    assert seeds == [6013, 6018, 6020, 6108]
    for b in g6:
        assert [w["seed"] for w in b["witness"]] == [d["seed"] for d in b["diverging"]]
        for w in b["witness"]:
            assert w["explained"] and w["flips"] and not w["unexplained_frames"]
            assert all(f["other_bx"] < soak.BX_NOISE for f in w["flips"])



def test_mockup_g4_drift_is_the_x_division_in_both_packages(st):
    """The mockup's g4 world drifts from the oracle beyond 5e-3 on one
    segment, every integer exact (STRUCTURE_torch.json, README §Precision
    contract).  Its source, on frame 67 alone: the reference computes a
    segment's extent as t = (p.x - a.x) / b.x, so a direction within 1e-4 of
    the y-z plane multiplies float32 rounding of p.x by 1 / |b.x|.  The
    port's and the JAX package's float32 frame segments part from the
    oracle's alike there (|b.x| 1.45e-5: ~1.9e-3 m each, 3e-6 between
    them), and nowhere else."""
    import jax.numpy as jnp

    from pointcloud_segmentation_tpu import pipeline as JP
    from pointcloud_segmentation_tpu import worldmap as JW
    from pointcloud_segmentation_tpu_torch.ops.hough import direction_tables
    from pointcloud_segmentation_tpu_torch.oracle import pipeline as OP
    from pointcloud_segmentation_tpu_torch.pipeline import frame_segments

    _, frames = st.flight_frames("mockup")
    fr = frames[67]
    cfg = st.flight_config("mockup", 4)
    jcfg = JC.default_config(granularity=4, shapes=JC.StaticShapes(4096, 2048, 64),
                             **st.FLIGHTS["mockup"].config)
    raw = np.full((cfg.shapes.max_raw_points, 3), np.nan, np.float32)
    raw[:len(fr.points)] = fr.points
    pos, quat = (np.asarray(v, np.float32) for v in (fr.position, fr.quat_wxyz))
    port = frame_segments(torch.from_numpy(raw), torch.from_numpy(pos), torch.from_numpy(quat),
                          cfg, direction_tables(4, "cpu"))[4]
    _, out = JP.process_frame(JW.init_world(jcfg), jnp.asarray(raw), jnp.asarray(pos),
                              jnp.asarray(quat), jcfg)
    jax = out.segments
    segs, _, _ = OP.hough3dlines(OP.cloud_filtering(np.asarray(fr.points, np.float64), cfg), cfg)
    OP.drone_to_world(segs, np.asarray(fr.position, np.float64),
                      np.asarray(fr.quat_wxyz, np.float64))
    segs = OP.height_cutoff(segs, cfg.floor_trim_height)
    assert len(segs) == int(port.valid.sum()) == int(np.asarray(jax.valid).sum()) == 5

    def ends(s, i):
        a, b = np.asarray(s.a[i], np.float64), np.asarray(s.b[i], np.float64)
        return [a + float(s.t_min[i]) * b, a + float(s.t_max[i]) * b]

    for i, o in enumerate(segs):
        want = [o.a + o.t_min * o.b, o.a + o.t_max * o.b]
        gap_port, gap_jax, between = (
            max(st.endpoint_errors([x], [y])[0]) for x, y in
            ((ends(port, i), want), (ends(jax, i), want), (ends(port, i), ends(jax, i))))
        bx = abs(o.b[0]) / np.linalg.norm(o.b)
        if bx < st.X_DIVISION_BX:
            assert bx == pytest.approx(1.445e-5, rel=1e-3)
            assert 1e-3 < gap_port < st.ENDPOINT_TOL and 1e-3 < gap_jax < st.ENDPOINT_TOL
            assert between < 1e-5
        else:
            assert gap_port < 1e-4 and gap_jax < 1e-4
