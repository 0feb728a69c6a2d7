"""The port's streaming runtime on the CPU (device="cpu", the plain versions
of the kernels), held against its own synchronous replay and against the
JAX engine on the same frames: the latest-wins worker, drain/stop/restart,
concurrent readers, D-CAP, verbose logs, checkpoints, the viz stream,
run_replay(pipelined=True), and the repairs of the engine's constructor and the
kernel build."""

import json
import logging
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pointcloud_segmentation_tpu import config as JC
from pointcloud_segmentation_tpu.io.scene import OBS_TESTS_SCENE, WP_TESTS, trajectory_poses
from pointcloud_segmentation_tpu.io.simulator import simulate_trajectory, TofSpec
from pointcloud_segmentation_tpu.runtime import SegmentationEngine as JaxEngine

from pointcloud_segmentation_tpu_torch import _build
from pointcloud_segmentation_tpu_torch import config as TC
from pointcloud_segmentation_tpu_torch import SegmentationEngine
from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy
from pointcloud_segmentation_tpu_torch.io.replay import save_frames

torch.set_num_threads(2)

SHAPES = dict(max_raw_points=4096, max_points=2048, max_world_segments=32)
# the g2 golden configuration (tests/test_golden.py), in both packages
CFG = TC.default_config(granularity=2, shapes=TC.StaticShapes(**SHAPES))
JCFG = JC.default_config(granularity=2, shapes=JC.StaticShapes(**SHAPES))
VIZ_KEYS = {"frame", "t", "nlines", "status", "world_count", "cylinders",
            "intersections", "drone"}


@pytest.fixture(scope="module")
def frames():
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:8]
    return simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.002), seed=1)


@pytest.fixture(scope="module")
def sync(frames):
    """The port's synchronous replay, with its viz records."""
    viz = []
    eng = SegmentationEngine(CFG, device="cpu", viz_stream=viz.append)
    recs = eng.run_replay(frames)
    return SimpleNamespace(eng=eng, recs=recs, viz=viz, state=world_state_to_numpy(eng.state))


@pytest.fixture(scope="module")
def jax_sync(frames):
    """The JAX engine's synchronous replay of the same frames."""
    viz = []
    eng = JaxEngine(JCFG, backend="jax", viz_stream=viz.append)
    recs = eng.run_replay(frames)
    return SimpleNamespace(eng=eng, recs=recs, viz=viz, segs=eng.world_segments())


def lockstep(eng, frames, t_off=0.0):
    """Submit each frame and wait until the worker has accounted for it, so
    the latest-wins mailbox drops nothing."""
    base = eng.frames_processed + eng.frames_failed + eng.frames_skipped_no_pose \
        + eng.dropped_frames
    for i, fr in enumerate(frames):
        eng.push_pose(fr.t + t_off, fr.position, fr.quat_wxyz)
        eng.submit_cloud(fr.t + t_off, fr.points)
        assert eng.drain(target_total=base + i + 1, timeout=60.0)


def endpoints(s):
    a, b = np.asarray(s["a"], np.float64), np.asarray(s["b"], np.float64)
    return a + s["t_min"] * b, a + s["t_max"] * b


def assert_segments_close(got, want, tol):
    assert len(got) == len(want)
    assert [s["points_size"] for s in got] == [s["points_size"] for s in want]
    for s, w in zip(got, want):
        (p1, p2), (q1, q2) = endpoints(s), endpoints(w)
        assert min(np.linalg.norm(p1 - q1) + np.linalg.norm(p2 - q2),
                   np.linalg.norm(p1 - q2) + np.linalg.norm(p2 - q1)) < tol


def no_sentinels(records):
    return all(r["seg_vec_size"] >= 0 and r["nblines"] >= 0 for r in records)


# ------------------------------------------------------------------ streaming

def test_lockstep_stream_equals_the_replay_and_the_jax_engine(frames, sync, jax_sync):
    viz = []
    # one viz record a frame: the default, one a flush, is held by
    # tests/test_torch_deferred.py
    eng = SegmentationEngine(CFG, device="cpu", viz_stream=viz.append, viz_every_frame=True)
    assert not eng._stream_deferred
    eng.start()
    try:
        lockstep(eng, frames)
    finally:
        eng.stop()
    assert (eng.frames_processed, eng.dropped_frames, eng.frames_failed) == (len(frames), 0, 0)
    assert no_sentinels(eng.records)
    state = world_state_to_numpy(eng.state)
    assert all(np.array_equal(state[k], sync.state[k], equal_nan=True) for k in state)
    key = [(r["seg_vec_size"], r["nblines"]) for r in eng.records]
    assert key == [(r["seg_vec_size"], r["nblines"]) for r in sync.eng.records]
    # nlines and status exact against the JAX engine, endpoints within 5e-3
    assert [(v["nlines"], v["status"]) for v in viz] == \
        [(r["nblines"], r["status"]) for r in jax_sync.recs]
    assert_segments_close(eng.world_segments(), jax_sync.segs, 5e-3)


def test_viz_records_match_the_jax_engine(sync, jax_sync, frames):
    assert len(sync.viz) == len(jax_sync.viz) == len(frames)
    for t, j in zip(sync.viz, jax_sync.viz):
        assert set(t) == set(j) == VIZ_KEYS
        for k in ("frame", "t", "nlines", "status", "world_count"):
            assert t[k] == j[k], k
        np.testing.assert_allclose(t["drone"]["position"], j["drone"]["position"], atol=1e-12)
        assert len(t["cylinders"]) == len(j["cylinders"])
        for a, b in zip(t["cylinders"], j["cylinders"]):
            assert a["id"] == b["id"] and a["radius"] == pytest.approx(b["radius"])
            np.testing.assert_allclose(a["p1"], b["p1"], atol=5e-3)
            np.testing.assert_allclose(a["p2"], b["p2"], atol=5e-3)
        assert [s["text"] for s in t["intersections"]] == [s["text"] for s in j["intersections"]]


@pytest.mark.parametrize("world_points", [False, True])
def test_viz_point_records_have_the_jax_keys(frames, world_points):
    got, want = [], []
    SegmentationEngine(CFG, device="cpu", viz_stream=got.append, viz_points=True,
                       collect_inlier_points=world_points).run_replay(frames[:3])
    JaxEngine(JCFG, backend="jax", viz_stream=want.append, viz_points=True,
              collect_inlier_points=world_points).run_replay(frames[:3])
    for t, j in zip(got, want):
        assert set(t) == set(j)
        for k in ("filtered_points", "hough_points"):
            assert len(t[k]) == len(j[k]), k
            if t[k]:
                np.testing.assert_allclose(np.sort(np.asarray(t[k]), axis=0),
                                           np.sort(np.asarray(j[k]), axis=0), atol=5e-3)


def test_collect_inlier_points_is_last_writer_wins_as_in_jax():
    """Two frame segments fusing into the same world slot in one frame: only
    the later one's points enter the store, as in the JAX engine."""
    filtered = np.arange(12, dtype=np.float32).reshape(4, 3)
    masks = np.array([[True, True, False, False], [False, False, True, True]])
    valid, slots = np.array([True, True]), np.array([5, 5], np.int32)
    pos, quat = np.array([0.5, -1.0, 2.0]), np.array([0.9, 0.1, -0.3, 0.2])
    quat /= np.linalg.norm(quat)
    eng = SegmentationEngine(CFG, device="cpu", collect_inlier_points=True)
    eng._collect_points(SimpleNamespace(
        filtered=torch.from_numpy(filtered),
        segments=SimpleNamespace(point_mask=torch.from_numpy(masks),
                                 valid=torch.from_numpy(valid)),
        slots=torch.from_numpy(slots)), pos, quat)
    jeng = JaxEngine(JCFG, backend="oracle", collect_inlier_points=True)
    jeng._collect_points_jax(SimpleNamespace(
        filtered=filtered, segments=SimpleNamespace(point_mask=masks, valid=valid),
        slots=slots), pos, quat)
    assert list(eng._inlier_points) == list(jeng._inlier_points) == [5]
    assert len(eng._inlier_points[5]) == 1
    np.testing.assert_array_equal(eng._inlier_points[5][0], jeng._inlier_points[5][0])


def test_overfeed_accounts_for_every_frame(frames, tmp_path):
    eng = SegmentationEngine(CFG, device="cpu")
    for fr in frames:
        eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
    eng.start()
    try:
        for fr in frames:
            eng.submit_cloud(fr.t, fr.points)      # faster than the worker
        assert eng.drain(timeout=60.0)
    finally:
        eng.stop()
    assert eng.frames_processed >= 1 and eng.dropped_frames >= 1
    assert (eng.frames_processed + eng.dropped_frames + eng.frames_failed
            + eng.frames_skipped_no_pose) == eng.frames_submitted == len(frames)
    assert no_sentinels(eng.records)

    log = str(tmp_path / "r.pcsl")
    save_frames(log, frames)
    eng = SegmentationEngine(CFG, device="cpu")
    s = eng.run_streaming_from_log(log, rate_hz=0.0, loops=2)
    assert s["drained"] is True and s["fed"] == 2 * len(frames)
    assert s["fed"] == s["processed"] + s["dropped"] + s["skipped"] + s["failed"]
    assert (s["dropped"], s["skipped"], s["failed"]) == (
        eng.dropped_frames, eng.frames_skipped_no_pose, eng.frames_failed)
    assert s["processed"] >= 1 and no_sentinels(eng.records)
    assert set(s) == {"fed", "processed", "dropped", "skipped", "failed", "drained",
                      "feed_s", "drain_s"}


def test_a_lost_frame_fails_the_drain_and_the_accounting(frames):
    """A frame the worker takes and never accounts for is not hidden among the
    drops: drain times out and the counters fall short of the submits."""
    eng = SegmentationEngine(CFG, device="cpu")
    # takes the frame, counts nothing (the deferred worker's entry and the
    # synchronous one)
    eng.process_frame = eng._process_frame_deferred = lambda t, points: None
    eng.push_pose(frames[0].t, frames[0].position, frames[0].quat_wxyz)
    eng.start()
    try:
        eng.submit_cloud(frames[0].t, frames[0].points)
        assert not eng.drain(timeout=0.5, poll_s=0.05)
    finally:
        eng.stop()
    assert eng.frames_submitted == 1
    assert (eng.frames_processed + eng.dropped_frames + eng.frames_failed
            + eng.frames_skipped_no_pose) == 0


def test_drain_wakes_when_the_worker_finishes_a_frame(frames):
    """drain waits on the worker's notification, not on its poll period."""
    eng = SegmentationEngine(CFG, device="cpu")
    fr = frames[0]
    eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
    eng.start()
    try:
        eng.submit_cloud(fr.t, fr.points)
        t0 = time.monotonic()
        assert eng.drain(timeout=120.0, poll_s=60.0)
        waited = time.monotonic() - t0
    finally:
        eng.stop()
    assert eng.frames_processed == 1 and waited < 60.0


def test_poisoned_frame_is_counted_and_the_worker_goes_on(frames):
    eng = SegmentationEngine(CFG, device="cpu")
    boom = {"armed": True}
    orig = eng._dispatch

    def exploding(*args):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("poisoned frame")
        return orig(*args)

    eng._dispatch = exploding
    eng.start()
    try:
        lockstep(eng, frames[:3])
    finally:
        eng.stop()
    assert eng.frames_failed == 1 and eng.frames_processed == 2
    assert len(eng.records) == 2 and no_sentinels(eng.records)


def test_frame_without_a_pose_is_skipped(frames):
    eng = SegmentationEngine(CFG, device="cpu")
    assert eng.process_frame(5.0, frames[0].points) is None
    eng.start()
    try:
        eng.submit_cloud(frames[0].t, frames[0].points)     # no pose pushed
        assert eng.drain(target_total=2, timeout=60.0)      # both skips
        lockstep(eng, frames[:1])
    finally:
        eng.stop()
    assert eng.frames_skipped_no_pose == 2 and eng.frames_processed == 1
    assert len(eng.records) == 1


def test_restart_after_stop_continues_counts_and_viz(frames, tmp_path):
    viz = tmp_path / "viz.jsonl"
    eng = SegmentationEngine(CFG, device="cpu", viz_stream=str(viz), viz_every_frame=True)
    for fr in frames[:2]:
        eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
        eng.submit_cloud(fr.t, fr.points)      # before start: the first drops
    eng.start()
    eng.start()                                  # a second start is a no-op
    try:
        assert eng.drain(timeout=60.0)
    finally:
        eng.stop()
    eng.finalize(str(tmp_path / "a"))
    assert (eng.frames_processed, eng.dropped_frames) == (1, 1)
    assert eng.mailbox.closed
    eng.start()
    try:
        lockstep(eng, frames[2:4])
    finally:
        eng.stop()
    eng.finalize(str(tmp_path / "b"))
    recs = [json.loads(line) for line in viz.read_text().splitlines()]
    assert [r["frame"] for r in recs] == [1, 2, 3]
    assert [r["t"] for r in recs] == [fr.t for fr in frames[1:4]]
    assert (eng.frames_processed, eng.dropped_frames, eng.frames_submitted) == (3, 1, 4)
    assert len(eng.records) == 3


def test_concurrent_snapshots_are_consistent(frames):
    """Readers querying the world map while the worker fuses frames get
    pairs in which every intersection names a listed segment, and never a
    map that shrinks."""
    eng = SegmentationEngine(CFG, device="cpu")
    seen, errors = [[] for _ in range(4)], []
    stop = threading.Event()

    def reader(counts):
        try:
            while not stop.is_set():
                segs, inter = eng.world_snapshot()
                assert all(i < len(segs) and j < len(segs) for i, _, j, _ in inter)
                counts.append(len(segs))
        except Exception as e:                  # reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    readers = [threading.Thread(target=reader, args=(c,)) for c in seen]
    try:
        for r in readers:
            r.start()
        eng.start()
        lockstep(eng, frames)
    finally:
        eng.stop()
        stop.set()
        for r in readers:
            r.join(timeout=30.0)
        sys.setswitchinterval(old)
    assert not any(r.is_alive() for r in readers)
    assert not errors, errors
    for counts in seen:
        assert counts and counts == sorted(counts)
    assert max(c[-1] for c in seen) == len(eng.world_segments())


def test_concurrent_submitters_are_all_counted(frames):
    """Server connections call submit_cloud from several threads at once:
    every submission is counted, and each is dropped or still in the slot."""
    eng = SegmentationEngine(CFG, device="cpu")
    pts = frames[0].points[:4]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    submitters = [threading.Thread(target=lambda: [eng.submit_cloud(0.0, pts)
                                                   for _ in range(2000)])
                  for _ in range(16)]
    try:
        for s in submitters:
            s.start()
        for s in submitters:
            s.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(s.is_alive() for s in submitters)
    assert eng.frames_submitted == 16 * 2000
    assert eng.dropped_frames == 16 * 2000 - 1


# ------------------------------------------------------------------ D-CAP, logs

def test_world_full_warning_matches_the_jax_engine(caplog):
    def cfg(mod):
        return mod.default_config(
            granularity=1, opt_minvotes=8, min_pca_coeff=0.8, opt_nlines=4,
            floor_trim_height=-10.0,
            shapes=mod.StaticShapes(max_raw_points=2048, max_points=1024,
                                    max_world_segments=2))

    rng = np.random.default_rng(3)
    clouds = []
    for i in range(4):                       # 4 well-separated beams, 2 fit
        a = np.array([0.2 + 0.35 * i, -0.7, 0.4])
        b = np.array([0.0, 1.0, 0.15 * (i + 1)])
        b /= np.linalg.norm(b)
        t = np.linspace(0, 1.2, 200)
        clouds.append(a + t[:, None] * b + rng.normal(0, 0.004, (200, 3)))
    pts = np.concatenate(clouds).astype(np.float32)
    msgs = {}
    for name, eng in (("pointcloud_segmentation_tpu_torch",
                       SegmentationEngine(cfg(TC), device="cpu")),
                      ("pointcloud_segmentation_tpu", JaxEngine(cfg(JC), backend="jax"))):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=name):
            eng.push_pose(0.0, np.zeros(3), np.array([1.0, 0, 0, 0]))
            rec = eng.process_frame(0.0, pts)
        assert rec["seg_vec_size"] == 2 and eng.world_overflow_frames == 1
        msgs[name] = [r.getMessage() for r in caplog.records if r.name == name]
    assert msgs["pointcloud_segmentation_tpu_torch"] == msgs["pointcloud_segmentation_tpu"]
    assert "D-CAP" in msgs["pointcloud_segmentation_tpu"][0]


def test_verbose_log_lines_match_the_jax_engine(frames, caplog):
    got = {}
    for name, make in (("pointcloud_segmentation_tpu_torch",
                        lambda: SegmentationEngine(TC.default_config(
                            granularity=2, verbose_level=2,
                            shapes=TC.StaticShapes(**SHAPES)), device="cpu")),
                       ("pointcloud_segmentation_tpu",
                        lambda: JaxEngine(JCFG.replace(verbose_level=2), backend="jax"))):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=name):
            make().run_replay(frames[:2])
        got[name] = [r for r in caplog.records if r.name == name]
    t, j = got["pointcloud_segmentation_tpu_torch"], got["pointcloud_segmentation_tpu"]
    assert [r.msg for r in t] == [r.msg for r in j]
    assert t[0].getMessage() == j[0].getMessage() and "Configuration" in t[0].msg
    assert sum("Segment %d" in r.msg for r in t) >= 1
    for a, b in zip(t[1:], j[1:]):
        if "Callback" in a.msg:
            continue
        ints = [(x, y) for x, y in zip(a.args, b.args) if isinstance(x, int)]
        assert all(x == y for x, y in ints)
        np.testing.assert_allclose([float(x) for x in a.args], [float(y) for y in b.args],
                                   atol=5e-3)


# ------------------------------------------------------------------ checkpoints

def test_checkpoint_resume_equals_a_straight_run(frames, sync, tmp_path):
    ckpt = str(tmp_path / "state.npz")
    first = SegmentationEngine(CFG, device="cpu")
    first.run_replay(frames[:4])
    first.save_checkpoint(ckpt)
    assert not (tmp_path / "state.npz.tmp.npz").exists()
    with np.load(ckpt) as data:
        assert str(data["backend"]) == "torch"
        assert {"world_overflow_frames", "frames_processed", "records_pending",
                "records", "world_count", "world_inter"} <= set(data.files)
    resumed = SegmentationEngine(CFG, device="cpu")
    resumed.load_checkpoint(ckpt)
    assert resumed.frames_processed == 4 and len(resumed.records) == 4
    resumed.run_replay(frames[4:])
    state = world_state_to_numpy(resumed.state)
    assert all(np.array_equal(state[k], sync.state[k], equal_nan=True) for k in state)
    assert resumed.intersections_rows() == sync.eng.intersections_rows()
    assert [r["nblines"] for r in resumed.records] == [r["nblines"] for r in sync.eng.records]


def test_checkpoint_cadence_and_its_anchor_on_load(frames, tmp_path):
    ckpt = str(tmp_path / "auto.npz")
    eng = SegmentationEngine(CFG, device="cpu", checkpoint_every=3, checkpoint_path=ckpt)
    eng.run_replay(frames[:7])
    probe = SegmentationEngine(CFG, device="cpu")
    probe.load_checkpoint(ckpt)
    assert probe.frames_processed == 6

    # a resumed engine at 6 with a cadence of 4 saves next at 8, not at 7
    resumed = SegmentationEngine(CFG, device="cpu", checkpoint_every=4,
                                 checkpoint_path=str(tmp_path / "next.npz"))
    resumed.load_checkpoint(ckpt)
    assert resumed._last_checkpoint_k == 1
    resumed.run_replay(frames[6:7])
    assert not (tmp_path / "next.npz").exists()
    resumed.run_replay(frames[7:8])
    probe.load_checkpoint(str(tmp_path / "next.npz"))
    assert probe.frames_processed == 8


def test_jax_checkpoint_loads_with_its_counters(frames, tmp_path):
    ckpt = str(tmp_path / "jax.npz")
    jeng = JaxEngine(JCFG, backend="jax")
    jeng.run_replay(frames[:2])
    jeng.world_overflow_frames = 3
    jeng.save_checkpoint(ckpt)
    eng = SegmentationEngine(CFG, device="cpu", checkpoint_every=2, checkpoint_path=ckpt)
    eng.load_checkpoint(ckpt)
    assert (eng.frames_processed, eng.world_overflow_frames, eng._last_checkpoint_k) == (2, 3, 1)
    assert_segments_close(eng.world_segments(), jeng.world_segments(), 1e-6)


# ------------------------------------------------------------------ replay modes

def test_pipelined_replay_records_equal_the_synchronous_ones(frames, sync):
    eng = SegmentationEngine(CFG, device="cpu")
    recs = eng.run_replay(frames, pipelined=True)
    assert len(recs) == len(frames) and no_sentinels(recs)
    for f in ("seg_vec_size", "nblines"):
        assert [r[f] for r in recs] == [r[f] for r in sync.recs]
    state = world_state_to_numpy(eng.state)
    assert all(np.array_equal(state[k], sync.state[k], equal_nan=True) for k in state)


# ------------------------------------------------------------------ repairs

def test_the_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        SegmentationEngine(CFG)


def test_the_engine_loads_the_kernels_in_its_constructor(monkeypatch):
    """On a CUDA device the constructor builds and loads the kernels on the
    caller's thread, before a streaming worker could launch one."""
    class Loaded(Exception):
        pass

    def load_library():
        raise Loaded(threading.current_thread().name)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "load_library", load_library)
    with pytest.raises(Loaded, match=threading.current_thread().name):
        SegmentationEngine(CFG)


def test_load_library_builds_once_under_concurrent_callers(monkeypatch, tmp_path):
    builds = []

    def build(source):
        builds.append(source)
        time.sleep(0.05)
        return object()

    monkeypatch.setattr(_build, "_build_and_load", build)
    source = tmp_path / "voting.cu"
    got = []
    threads = [threading.Thread(target=lambda: got.append(_build.load_library(source)))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    _build._loaded.pop(source, None)
    assert not any(t.is_alive() for t in threads)
    assert builds == [source] and len(got) == 8 and all(g is got[0] for g in got)


# ------------------------------------------------------------------ batched replay

def assert_same_state(a, b):
    sa, sb = world_state_to_numpy(a.state), world_state_to_numpy(b.state)
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        assert np.array_equal(sa[k], sb[k], equal_nan=True), k


@pytest.mark.parametrize("batch", [2, 4])
def test_batched_replay_equals_the_synchronous_replay(frames, sync, batch):
    """run_replay(batch=k): the world state bit-equal to the synchronous
    replay's, the same per-frame records, one amortised processing_time per
    chunk; 7 frames leave a short last chunk."""
    eng = SegmentationEngine(CFG, device="cpu")
    recs = eng.run_replay(frames[:7], batch=batch)
    ref = SegmentationEngine(CFG, device="cpu")
    want = ref.run_replay(frames[:7])
    assert_same_state(eng, ref)
    assert eng.frames_processed == 7 and len(eng.records) == 7 and no_sentinels(recs)
    for f in ("seg_vec_size", "nblines", "status", "t"):
        assert [r[f] for r in recs] == [r[f] for r in want], f
    assert set(recs[0]) == set(want[0])
    chunk_times = [r["processing_time"] for r in recs[:batch]]
    assert len(set(chunk_times)) == 1 and chunk_times[0] > 0
    assert eng.intersections_rows() == ref.intersections_rows()
    # and the batched engine carries on frame by frame from where it stands
    eng.run_replay(frames[7:])
    assert_same_state(eng, sync.eng)


def test_batched_replay_skips_a_frame_without_a_pose(frames):
    """A frame of a chunk whose pose lookup fails is counted as skipped and
    leaves no record and no trace in the world map, as on the synchronous
    path."""
    def engine():
        eng = SegmentationEngine(CFG, device="cpu")
        lookup = eng.poses.lookup
        eng.poses.lookup = lambda t: None if t == frames[2].t else lookup(t)
        return eng

    eng, ref = engine(), engine()
    recs = eng.run_replay(frames[:6], batch=4)
    want = ref.run_replay(frames[:6])
    assert eng.frames_skipped_no_pose == ref.frames_skipped_no_pose == 1
    assert eng.frames_processed == ref.frames_processed == 5
    assert [r["t"] for r in recs] == [r["t"] for r in want]
    assert frames[2].t not in [r["t"] for r in recs]
    assert [r["nblines"] for r in recs] == [r["nblines"] for r in want]
    assert_same_state(eng, ref)


def test_batched_replay_accounts_for_d_cap_overflow(caplog):
    cfg = TC.default_config(
        granularity=1, opt_minvotes=8, min_pca_coeff=0.8, opt_nlines=4,
        floor_trim_height=-10.0,
        shapes=TC.StaticShapes(max_raw_points=2048, max_points=1024,
                               max_world_segments=2))
    rng = np.random.default_rng(3)
    clouds = []
    for i in range(4):                       # 4 well-separated beams, 2 fit
        a = np.array([0.2 + 0.35 * i, -0.7, 0.4])
        b = np.array([0.0, 1.0, 0.15 * (i + 1)])
        b /= np.linalg.norm(b)
        t = np.linspace(0, 1.2, 200)
        clouds.append(a + t[:, None] * b + rng.normal(0, 0.004, (200, 3)))
    pts = np.concatenate(clouds).astype(np.float32)
    replay = [SimpleNamespace(t=float(i), position=np.zeros(3),
                              quat_wxyz=np.array([1.0, 0, 0, 0]), points=pts)
              for i in range(3)]
    ref = SegmentationEngine(cfg, device="cpu")
    ref.run_replay(replay)
    eng = SegmentationEngine(cfg, device="cpu")
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="pointcloud_segmentation_tpu_torch"):
        recs = eng.run_replay(replay, batch=4)
    assert eng.world_overflow_frames == ref.world_overflow_frames == 3
    assert [r["seg_vec_size"] for r in recs] == [2, 2, 2]
    assert_same_state(eng, ref)
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 1 and "D-CAP" in msgs[0] and "across 3 frame(s)" in msgs[0]


def test_batched_process_returns_device_tensors_of_length_f(frames):
    from pointcloud_segmentation_tpu_torch.ops.hough import direction_tables
    from pointcloud_segmentation_tpu_torch.pipeline import (batched_process,
                                                            process_frame_packed)
    from pointcloud_segmentation_tpu_torch.worldmap import init_world

    eng = SegmentationEngine(CFG, device="cpu")
    clouds = torch.stack([eng._pad_raw(f.points) for f in frames[:3]])
    pos = torch.tensor(np.stack([f.position for f in frames[:3]]), dtype=torch.float32)
    quat = torch.tensor(np.stack([f.quat_wxyz for f in frames[:3]]), dtype=torch.float32)
    tables = direction_tables(CFG.granularity, "cpu")
    state, nl, st, wc, ov = batched_process(init_world(CFG, "cpu"), clouds, pos, quat,
                                            CFG, tables)
    assert all(t.shape == (3,) and t.dtype == torch.int32 for t in (nl, st, wc, ov))
    one = init_world(CFG, "cpu")
    for i in range(3):
        one, out, scalars = process_frame_packed(one, clouds[i], pos[i], quat[i], CFG, tables)
        assert scalars.dtype == torch.int32
        assert scalars.tolist() == [int(wc[i]), int(nl[i]), int(st[i]), int(ov[i])]
    assert all(torch.equal(getattr(state, k), getattr(one, k)) for k in state._fields)


# ------------------------------------------------------------------ float64 engine

F64 = TC.default_config(granularity=2, compute_dtype="float64",
                        shapes=TC.StaticShapes(**SHAPES))


def test_float64_engine_replay_batched_and_checkpoints(frames, tmp_path):
    """compute_dtype="float64" through the engine: a float64 world map,
    batched = synchronous, a checkpoint that names its type and resumes bit
    for bit, and a refusal to cross compute types."""
    eng = SegmentationEngine(F64, device="cpu")
    eng.run_replay(frames[:3])
    ckpt = str(tmp_path / "f64.npz")
    eng.save_checkpoint(ckpt)
    eng.run_replay(frames[3:6])
    assert eng.state.a.dtype == eng.state.inter.dtype == torch.float64
    batched = SegmentationEngine(F64, device="cpu")
    batched.run_replay(frames[:6], batch=4)
    assert_same_state(eng, batched)

    with np.load(ckpt) as data:
        assert str(data["compute_dtype"]) == "float64"
        assert data["world_a"].dtype == np.float64
    resumed = SegmentationEngine(F64, device="cpu")
    resumed.load_checkpoint(ckpt)
    resumed.run_replay(frames[3:6])
    assert_same_state(eng, resumed)
    with pytest.raises(ValueError, match="float64 world map"):
        SegmentationEngine(CFG, device="cpu").load_checkpoint(ckpt)
    f32 = str(tmp_path / "f32.npz")
    SegmentationEngine(CFG, device="cpu").save_checkpoint(f32)
    with pytest.raises(ValueError, match="float32 world map"):
        resumed.load_checkpoint(f32)


def test_jax_float64_checkpoint_loads_into_a_float64_engine(frames, tmp_path):
    import jax

    ckpt = str(tmp_path / "jax64.npz")
    with jax.enable_x64(True):
        jeng = JaxEngine(JCFG.replace(compute_dtype="float64"), backend="jax")
        jeng.run_replay(frames[:2])
        jeng.save_checkpoint(ckpt)
        want = jeng.world_segments()
    eng = SegmentationEngine(F64, device="cpu")
    eng.load_checkpoint(ckpt)
    assert eng.state.a.dtype == torch.float64 and eng.frames_processed == 2
    assert_segments_close(eng.world_segments(), want, 1e-12)
    with pytest.raises(ValueError, match="float64 world map"):
        SegmentationEngine(CFG, device="cpu").load_checkpoint(ckpt)


# ------------------------------------------------------------------ oracle backend

def same_rows(got, want):
    assert len(got) == len(want)
    for s, w in zip(got, want):
        assert s.keys() == w.keys()
        for k in s:
            assert np.array_equal(np.asarray(s[k]), np.asarray(w[k])), k


def test_oracle_backend_equals_the_jax_engines_oracle_backend(frames, tmp_path):
    """backend="oracle" runs the port's copy of the numpy oracle: segments,
    intersections, records, viz records and CSVs are the JAX engine's oracle
    backend's, value for value."""
    viz, jviz = [], []
    eng = SegmentationEngine(CFG, backend="oracle", viz_stream=viz.append,
                             viz_points=True, collect_inlier_points=True)
    jeng = JaxEngine(JCFG, backend="oracle", viz_stream=jviz.append,
                     viz_points=True, collect_inlier_points=True)
    recs, jrecs = eng.run_replay(frames[:5]), jeng.run_replay(frames[:5])
    assert eng.device.type == "cpu" and eng.state is None
    for f in ("seg_vec_size", "nblines", "status", "t"):
        assert [r[f] for r in recs] == [r[f] for r in jrecs], f
    segs, inter = eng.world_snapshot()
    same_rows(segs, jeng.world_segments())
    assert inter == jeng.intersections_rows() and len(segs) >= 5
    same_rows(eng.world_segments(), segs)
    assert len(viz) == len(jviz) == 5
    for t, j in zip(viz, jviz):
        assert t == j
    assert viz[-1]["hough_points_world_accumulated"] and viz[-1]["hough_points"]
    pts = eng.visualization()["hough_points"]
    assert sorted(pts) == list(range(len(segs)))
    paths, jpaths = eng.finalize(str(tmp_path / "t")), jeng.finalize(str(tmp_path / "j"))
    for k in ("segments", "intersections"):
        with open(paths[k], "rb") as a, open(jpaths[k], "rb") as b:
            assert a.read() == b.read(), k


def test_oracle_checkpoints_cross_between_the_packages_and_are_refused_by_torch(
        frames, tmp_path):
    eng = SegmentationEngine(CFG, backend="oracle")
    eng.run_replay(frames[:3])
    ckpt, jckpt = str(tmp_path / "o.npz"), str(tmp_path / "jo.npz")
    eng.save_checkpoint(ckpt)
    jeng = JaxEngine(JCFG, backend="oracle")
    jeng.load_checkpoint(ckpt)                    # the JAX engine reads the port's
    same_rows(jeng.world_segments(), eng.world_segments())
    jeng.run_replay(frames[3:5])
    jeng.save_checkpoint(jckpt)
    resumed = SegmentationEngine(CFG, backend="oracle", checkpoint_every=2)
    resumed.load_checkpoint(jckpt)                # and the port the JAX engine's
    assert (resumed.frames_processed, resumed._last_checkpoint_k) == (5, 2)
    eng.run_replay(frames[3:5])
    same_rows(resumed.world_segments(), eng.world_segments())
    assert resumed.intersections_rows() == eng.intersections_rows()
    assert [r["nblines"] for r in resumed.records] == [r["nblines"] for r in eng.records]

    with pytest.raises(ValueError, match="backend='oracle'"):
        SegmentationEngine(CFG, device="cpu").load_checkpoint(ckpt)
    torch_ckpt = str(tmp_path / "t.npz")
    SegmentationEngine(CFG, device="cpu").save_checkpoint(torch_ckpt)
    with pytest.raises(ValueError, match="oracle checkpoints only"):
        eng.load_checkpoint(torch_ckpt)


def test_oracle_backend_needs_no_card_and_streams(frames, monkeypatch):
    """The oracle backend never asks for CUDA or the kernel library, whatever
    `device` says; the streaming worker runs it like the torch backend."""
    def refuse(*a, **k):
        raise AssertionError("the oracle backend touched CUDA or the kernels")

    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    monkeypatch.setattr(torch.cuda, "current_device", refuse)
    monkeypatch.setattr(_build, "load_library", refuse)
    eng = SegmentationEngine(CFG, backend="oracle")         # device="cuda" by default
    eng.start()
    try:
        lockstep(eng, frames[:3])
    finally:
        eng.stop()
    ref = SegmentationEngine(CFG, backend="oracle", device="cuda:3")
    ref.run_replay(frames[:3], batch=4)                     # batch: frame by frame
    assert eng.frames_processed == 3 and eng.dropped_frames == 0
    same_rows(eng.world_segments(), ref.world_segments())
    with pytest.raises(ValueError, match="unknown backend"):
        SegmentationEngine(CFG, backend="jax")
