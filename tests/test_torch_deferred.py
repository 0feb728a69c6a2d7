"""The port's deferred read-back on the CPU (device="cpu"): twins of the JAX
engine's deferred-streaming and pipelined-replay tests (tests/test_runtime.py,
tests/test_viz_live.py), each also held against the JAX engine on the same
frames.

On the CPU the same code path runs as on a card, with plain tensors parked
and no event.  Tolerances: deferred against synchronous (port against port)
bit-equal world state and equal records; against the JAX engine
`seg_vec_size` and `nblines` exact, endpoints within 5e-3.

No twin: `test_stream_rides_through_wedged_flusher_read` and
`test_idle_age_flush_also_sheds_past_wedge_cap` (tests/test_runtime.py) test
the break-out and the shedding of batches behind a read that hangs for
minutes on the JAX testbed's remote device link; the port has neither (see
runtime/engine.py's module docstring).
"""

import json
import os
import subprocess
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

from pointcloud_segmentation_tpu_torch import config as TC
from pointcloud_segmentation_tpu_torch import SegmentationEngine
from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy
from pointcloud_segmentation_tpu_torch.io.replay import save_frames

torch.set_num_threads(2)

SHAPES = dict(max_raw_points=4096, max_points=2048, max_world_segments=32)
CFG = TC.default_config(granularity=2, shapes=TC.StaticShapes(**SHAPES))
JCFG = JC.default_config(granularity=2, shapes=JC.StaticShapes(**SHAPES))
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def frames():
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:8]
    return simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.002), seed=1)


@pytest.fixture(scope="module")
def sync(frames):
    eng = SegmentationEngine(CFG, device="cpu")
    recs = eng.run_replay(frames)
    return SimpleNamespace(eng=eng, recs=recs, state=world_state_to_numpy(eng.state))


@pytest.fixture(scope="module")
def jax_sync(frames):
    eng = JaxEngine(JCFG, backend="jax")
    recs = eng.run_replay(frames)
    return SimpleNamespace(recs=recs, segs=eng.world_segments())


def submit_and_wait(eng, fr, deadline_s=60.0):
    """Submit one frame and wait until the worker has accounted for it, so
    the mailbox drops nothing and the records line up with a replay's."""
    target = eng.frames_processed + eng.frames_skipped_no_pose + eng.frames_failed + 1
    eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
    eng.submit_cloud(fr.t, fr.points)
    deadline = time.time() + deadline_s
    while (eng.frames_processed + eng.frames_skipped_no_pose
           + eng.frames_failed) < target and time.time() < deadline:
        time.sleep(0.002)


def no_sentinels(records):
    return all(r["seg_vec_size"] >= 0 and r["nblines"] >= 0 for r in records)


def columns(records):
    return [(r["seg_vec_size"], r["nblines"]) for r in records]


def same_state(eng, state):
    got = world_state_to_numpy(eng.state)
    return all(np.array_equal(got[k], state[k], equal_nan=True) for k in state)


def endpoints(s):
    a, b = np.asarray(s["a"], np.float64), np.asarray(s["b"], np.float64)
    return a + s["t_min"] * b, a + s["t_max"] * b


# ------------------------------------------------------------------ the rule

def test_when_the_stream_is_deferred():
    """The JAX constructor's rule, key for key."""
    def deferred(**kw):
        cfg = kw.pop("cfg", CFG)
        return SegmentationEngine(cfg, device="cpu", **kw)._stream_deferred

    assert deferred() and SegmentationEngine(CFG, device="cpu").stream_sync_every == 64
    assert not deferred(stream_sync_every=1)
    assert not deferred(collect_inlier_points=True)
    assert deferred(viz_stream=lambda r: None)              # a plain viz stream stays
    assert not deferred(viz_stream=lambda r: None, viz_every_frame=True)
    assert not deferred(viz_stream=lambda r: None, viz_points=True)
    assert deferred(viz_every_frame=True)                   # no stream, nothing to emit
    assert not deferred(cfg=TC.default_config(granularity=2, verbose_level=1,
                                              shapes=TC.StaticShapes(**SHAPES)))
    assert not deferred(backend="oracle")
    for kw in ({}, {"stream_sync_every": 1}, {"viz_stream": print, "viz_every_frame": True}):
        assert deferred(**kw) == JaxEngine(JCFG, backend="jax", **kw)._stream_deferred
    eng = SegmentationEngine(CFG, device="cpu", viz_stream=lambda r: None)
    assert eng._viz_flush and not SegmentationEngine(CFG, device="cpu")._viz_flush


# ------------------------------------------------------------------ replay

def test_engine_pipelined_replay(frames, sync):
    """One stacked read at the end; the map of the synchronous path."""
    eng = SegmentationEngine(CFG, device="cpu")
    reads = []
    orig = torch.stack

    def counting_stack(tensors, *a, **k):
        if len(tensors) == len(frames) and tensors[0].shape == (4,):
            reads.append(len(tensors))
        return orig(tensors, *a, **k)

    torch.stack = counting_stack
    try:
        recs = eng.run_replay(frames, pipelined=True)
    finally:
        torch.stack = orig
    assert reads == [len(frames)]                  # read once, all frames
    assert len(recs) == len(frames) and no_sentinels(recs) and no_sentinels(eng.records)
    assert same_state(eng, sync.state)


def test_engine_pipelined_records_match_synchronous(frames, sync, jax_sync):
    eng = SegmentationEngine(CFG, device="cpu")
    recs = eng.run_replay(frames, pipelined=True)
    assert columns(recs) == columns(sync.recs) == columns(eng.records)
    assert [r["status"] for r in recs] == [r["status"] for r in sync.recs]
    assert [r["t"] for r in recs] == [fr.t for fr in frames]
    assert columns(recs) == columns(jax_sync.recs)          # the JAX engine's, exact
    # the oracle backend has nothing to defer and runs frame by frame
    ora = SegmentationEngine(CFG, backend="oracle")
    assert no_sentinels(ora.run_replay(frames[:2], pipelined=True))


def test_pipelined_replay_counts_overflow():
    """D-CAP on the pipelined path, as on the synchronous one."""
    cfg = TC.default_config(
        granularity=1, opt_minvotes=8, min_pca_coeff=0.8, opt_nlines=4,
        floor_trim_height=-10.0,
        shapes=TC.StaticShapes(max_raw_points=2048, max_points=1024, max_world_segments=2))
    rng = np.random.default_rng(3)
    clouds = []
    for i in range(4):      # 4 well-separated beams in one frame: 2 fit, 2 overflow
        a = np.array([0.2 + 0.35 * i, -0.7, 0.4])
        b = np.array([0.0, 1.0, 0.15 * (i + 1)])
        b /= np.linalg.norm(b)
        t = np.linspace(0, 1.2, 200)
        clouds.append(a + t[:, None] * b + rng.normal(0, 0.004, (200, 3)))
    fr = SimpleNamespace(t=0.0, points=np.concatenate(clouds).astype(np.float32),
                         position=np.zeros(3), quat_wxyz=np.array([1.0, 0, 0, 0]))
    eng = SegmentationEngine(cfg, device="cpu")
    recs = eng.run_replay([fr], pipelined=True)
    assert recs[0]["seg_vec_size"] == 2 and eng.world_overflow_frames == 1
    # and on the deferred stream
    eng = SegmentationEngine(cfg, device="cpu", stream_sync_every=2)
    eng.start()
    submit_and_wait(eng, fr)
    eng.stop()
    assert eng.records[0]["seg_vec_size"] == 2 and eng.world_overflow_frames == 1


# ------------------------------------------------------------------ streams

def test_engine_streaming_deferred_records_truthful(frames, sync, jax_sync):
    """stream_sync_every=3 forces several flushes in mid-run and a final one:
    records hold -1 until their batch is read, and afterwards each frame's
    own values."""
    eng = SegmentationEngine(CFG, device="cpu", stream_sync_every=3)
    assert eng._stream_deferred
    held = []
    orig = eng._backfill_batch

    def watching(batch):
        held.append([dict(rec) for rec, _, _, _ in batch])
        return orig(batch)

    eng._backfill_batch = watching
    eng.start()
    for fr in frames:
        submit_and_wait(eng, fr)
    eng.stop()
    assert eng._pending == [] and eng._flusher is None      # final flush ran
    assert eng.frames_processed == len(frames)
    assert [len(b) for b in held] == [3, 3, 2]
    assert all(r["seg_vec_size"] == -1 and r["nblines"] == -1 for b in held for r in b)
    assert no_sentinels(eng.records)
    assert columns(eng.records) == columns(sync.recs) == columns(jax_sync.recs)
    assert same_state(eng, sync.state)                      # bit for bit
    segs = eng.world_segments()
    assert len(segs) == len(jax_sync.segs)
    for s, w in zip(segs, jax_sync.segs):
        (p1, p2), (q1, q2) = endpoints(s), endpoints(w)
        assert min(np.linalg.norm(p1 - q1) + np.linalg.norm(p2 - q2),
                   np.linalg.norm(p1 - q2) + np.linalg.norm(p2 - q1)) < 5e-3


def test_idle_flush_by_the_age_of_the_oldest_record(frames):
    """Fewer frames than a batch: the worker flushes once the oldest parked
    record is `_STREAM_FLUSH_AGE_S` old and the mailbox is idle."""
    eng = SegmentationEngine(CFG, device="cpu")             # batches of 64
    eng._STREAM_FLUSH_AGE_S = 0.2
    eng.start()
    try:
        submit_and_wait(eng, frames[0])
        submit_and_wait(eng, frames[1])
        assert eng.frames_processed == 2
        deadline = time.time() + 30.0
        while not no_sentinels(eng.records) and time.time() < deadline:
            time.sleep(0.01)
        assert no_sentinels(eng.records) and eng._running   # before stop()
    finally:
        eng.stop()


def test_engine_streaming_deferred_poison(frames):
    """A frame whose dispatch raises is counted; the stream goes on."""
    eng = SegmentationEngine(CFG, device="cpu", stream_sync_every=4)
    assert eng._stream_deferred
    boom = {"armed": True}
    orig = eng._dispatch

    def exploding(points, position, quat):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("poisoned frame")
        return orig(points, position, quat)

    eng._dispatch = exploding
    eng.start()
    for fr in frames[:3]:
        submit_and_wait(eng, fr)
    eng.stop()
    assert eng.frames_failed == 1 and eng.frames_processed == 2
    assert len(eng.records) == 2 and no_sentinels(eng.records)


def test_engine_streaming_deferred_checkpoints(frames, sync, tmp_path):
    """Checkpoints at flush boundaries, once per crossed multiple of
    checkpoint_every, resuming into the same world map."""
    ckpt = str(tmp_path / "ck.npz")
    eng = SegmentationEngine(CFG, device="cpu", stream_sync_every=3,
                             checkpoint_every=4, checkpoint_path=ckpt)
    assert eng._stream_deferred
    saves = []
    orig = eng.save_checkpoint
    eng.save_checkpoint = lambda path: (saves.append(eng.frames_processed), orig(path))
    # The gate waits for the flusher too: a flush checkpoints with the
    # worker's frames_processed at that moment, so a flusher that lagged two
    # frames behind would take the flush of frames 4-6 at 8 and cover both
    # multiples of 4 with one save.
    handed, backfilled = [0], [0]
    orig_flush, orig_backfill = eng._flush_pending, eng._backfill_batch

    def flush_pending():
        handed[0] += bool(eng._pending)
        orig_flush()

    def backfill_batch(batch):
        vals = orig_backfill(batch)
        backfilled[0] += 1
        return vals

    eng._flush_pending, eng._backfill_batch = flush_pending, backfill_batch
    eng.start()
    for fr in frames:
        submit_and_wait(eng, fr)
        # a full batch handed to the flusher, and every handed batch read
        deadline = time.time() + 60.0
        while ((len(eng._pending) >= eng.stream_sync_every or handed[0] != backfilled[0])
               and time.time() < deadline):
            time.sleep(0.002)
    eng.stop()
    assert os.path.exists(ckpt)
    # batches end at frames 3, 6 and 8, and the worker may be a frame ahead
    # of a flush: the multiple 4 is crossed at the first or the second flush,
    # 8 at the last
    assert len(saves) == 2 and 4 <= saves[0] <= 7 and saves[1] == 8
    eng2 = SegmentationEngine(CFG, device="cpu")
    eng2.load_checkpoint(ckpt)
    assert eng2.frames_processed == 8 and no_sentinels(eng2.records)
    assert same_state(eng2, sync.state)


def test_checkpoint_skips_sentinel_records(tmp_path):
    """A checkpoint can race records that still hold -1: they are counted,
    not written, as in the JAX engine's checkpoints."""
    ckpt = str(tmp_path / "ck.npz")
    recs = [{"wall_time": 1.0, "processing_time": 2.0, "seg_vec_size": 3, "nblines": 1},
            {"wall_time": 2.0, "processing_time": 2.5, "seg_vec_size": -1, "nblines": -1}]
    eng = SegmentationEngine(CFG, device="cpu")
    eng.records = [dict(r) for r in recs]
    eng.frames_processed = 2
    eng.save_checkpoint(ckpt)
    eng2 = SegmentationEngine(CFG, device="cpu")
    eng2.load_checkpoint(ckpt)
    assert [r["seg_vec_size"] for r in eng2.records] == [3]
    assert eng2.frames_processed == 2
    assert int(np.load(ckpt)["records_pending"]) == 1
    jeng = JaxEngine(JCFG, backend="jax")
    jeng.records, jeng.frames_processed = [dict(r) for r in recs], 2
    jeng.save_checkpoint(str(tmp_path / "j.npz"))
    with np.load(str(tmp_path / "j.npz")) as j, np.load(ckpt) as t:
        for k in ("records", "records_pending", "frames_processed"):
            np.testing.assert_array_equal(j[k], t[k])


def test_engine_streaming_deferred_concurrent_queries(frames, sync):
    """Readers of the world map while the deferred stream runs and the
    flusher backfills: no error, a map that never shrinks, the replay's map
    at the end."""
    eng = SegmentationEngine(CFG, device="cpu", stream_sync_every=2)
    assert eng._stream_deferred
    eng.start()
    stop_flag, snap_counts, errors = threading.Event(), [], []

    def reader():
        while not stop_flag.is_set():
            try:
                segs, inter = eng.world_snapshot()
                assert all(i < len(segs) and j < len(segs) for i, _, j, _ in inter)
                snap_counts.append(len(segs))
            except Exception as e:        # pragma: no cover - failure path
                errors.append(e)
                return
            time.sleep(0.003)

    rt = threading.Thread(target=reader)
    rt.start()
    try:
        for fr in frames:
            submit_and_wait(eng, fr)
    finally:
        stop_flag.set()
        rt.join(timeout=30.0)
        eng.stop()
    assert not rt.is_alive() and not errors
    assert snap_counts, "reader thread never got a snapshot"
    assert all(b >= a for a, b in zip(snap_counts, snap_counts[1:]))
    assert no_sentinels(eng.records) and same_state(eng, sync.state)


def test_engine_deferred_restart_after_stop(frames, sync):
    """A second deferred stream after stop() gets a fresh flusher and
    queue; both streams' records are backfilled and the map is one
    continuous replay's."""
    half = len(frames) // 2
    eng = SegmentationEngine(CFG, device="cpu", stream_sync_every=3)
    eng.start()
    for fr in frames[:half]:
        submit_and_wait(eng, fr)
    first_q = eng._flush_q
    eng.stop()
    assert eng._flusher is None and eng._worker is None     # joined at stop
    eng.start()
    assert eng._flush_q is not first_q and eng._flusher.is_alive()
    for fr in frames[half:]:
        submit_and_wait(eng, fr)
    eng.stop()
    assert eng.frames_processed == len(frames)
    assert columns(eng.records) == columns(sync.recs)
    assert same_state(eng, sync.state)


def test_engine_deferred_overfeed_bounded_inflight(frames):
    """An overfed stream does not run ahead of its read-backs without bound:
    with `_STREAM_MAX_UNREAD_BATCHES` batches unread the worker waits for the
    flusher.  The first backfill is held until the worker has queued batches
    up to the cap, however long a frame takes, and then for a few frames'
    time more, in which a worker that did not wait would pass the cap."""
    eng = SegmentationEngine(CFG, device="cpu", stream_sync_every=2)
    assert eng._stream_deferred
    cap = eng._STREAM_MAX_UNREAD_BATCHES
    seen = {"max_q": 0, "max_ahead": 0}
    held = threading.Event()
    orig = eng._backfill_batch

    def sample():
        seen["max_q"] = max(seen["max_q"], eng._flush_q.qsize())
        unread = sum(r["seg_vec_size"] < 0 for r in list(eng.records))
        seen["max_ahead"] = max(seen["max_ahead"], unread)

    def slow_backfill(batch):
        if not held.is_set():
            t0 = time.time()
            while eng._flush_q.qsize() < cap and time.time() < t0 + 30.0:
                time.sleep(0.005)
            # four batches' time at the pace seen so far, at least 0.5 s
            frame_s = (time.time() - t_start) / max(eng.frames_processed, 1)
            t_hold = time.time() + min(max(0.5, 4 * eng.stream_sync_every * frame_s), 10.0)
            while time.time() < t_hold and eng._flush_q.qsize() <= cap:
                sample()
                time.sleep(0.005)
            held.set()
        sample()
        return orig(batch)

    eng._backfill_batch = slow_backfill
    t_start = time.time()
    eng.start()
    for fr in frames:
        eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
    t_end, i = time.time() + 4.0, 0
    while time.time() < t_end or (not held.is_set() and time.time() < t_end + 45.0):
        fr = frames[i % len(frames)]
        eng.submit_cloud(fr.t, fr.points)
        i += 1
        time.sleep(0.002)
    deadline = time.time() + 60.0
    while eng._flush_q.qsize() > 0 and time.time() < deadline:
        time.sleep(0.05)
    eng.stop()
    # a batch was still queued when a backfill began, and never more than
    # the cap (qsize is sampled after the flusher has taken its batch)
    assert 1 <= seen["max_q"] <= cap
    # frames in flight: the batch being read, the queued ones, the pending one
    assert seen["max_ahead"] <= (cap + 2) * eng.stream_sync_every
    assert eng.frames_processed >= 1 and no_sentinels(eng.records)
    assert eng.dropped_frames > 0                  # the mailbox went on dropping


def test_engine_streaming_flush_failure_not_a_failed_frame(frames):
    """A flush that fails loses no frame: it is not counted in
    frames_failed, the batch stays pending and the next flush takes it."""
    eng = SegmentationEngine(CFG, device="cpu", stream_sync_every=2)
    orig = eng._flush_pending
    boom = {"armed": True}

    def exploding_flush():
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("flush hiccup")
        orig()

    eng._flush_pending = exploding_flush
    eng.start()
    for fr in frames[:4]:
        submit_and_wait(eng, fr)
    eng.stop()
    assert not boom["armed"]
    assert eng.frames_failed == 0 and eng.frames_processed == 4
    assert no_sentinels(eng.records)


def test_a_failed_backfill_keeps_the_flusher_alive(frames, caplog):
    """A read-back that raises leaves its batch's records at -1 and the
    flusher running for the next batch."""
    eng = SegmentationEngine(CFG, device="cpu", stream_sync_every=2)
    orig = eng._backfill_batch
    boom = {"armed": True}

    def exploding(batch):
        if boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("read-back hiccup")
        return orig(batch)

    eng._backfill_batch = exploding
    eng.start()
    for fr in frames[:4]:
        submit_and_wait(eng, fr)
    eng.stop()
    assert eng.frames_failed == 0 and eng.frames_processed == 4
    assert columns(eng.records[:2]) == [(-1, -1), (-1, -1)]
    assert no_sentinels(eng.records[2:])
    assert "flush backfill failed" in caplog.text


# ------------------------------------------------------------------ viz

def test_deferred_stream_viz_flush_cadence(frames):
    """A plain viz stream does not push a deferred stream back to the
    per-frame path: the flusher emits one record a batch, from one snapshot
    of the map, with the JAX flush record's keys."""
    got, jgot = [], []
    eng = SegmentationEngine(CFG, device="cpu", viz_stream=got.append, stream_sync_every=3)
    assert eng._stream_deferred and eng._viz_flush
    jeng = JaxEngine(JCFG, backend="jax", viz_stream=jgot.append, stream_sync_every=3)
    for e in (eng, jeng):
        e.start()
        for fr in frames[:6]:
            submit_and_wait(e, fr)
        e.stop()
    assert eng.frames_processed == 6
    assert got and all(r["viz_cadence"] == "flush" for r in got)
    assert sum(r["frames_in_batch"] for r in got) == 6       # every frame covered
    fnos = [r["frame"] for r in got]
    assert fnos == sorted(fnos) and fnos[-1] == 6
    last, segs = got[-1], eng.world_segments()
    assert last["world_count"] == len(segs) == len(last["cylinders"])
    for c, s in zip(last["cylinders"], segs):
        np.testing.assert_allclose(
            c["p1"], np.asarray(s["a"]) + s["t_min"] * np.asarray(s["b"]), atol=1e-6)
        assert c["radius"] == pytest.approx(s["radius"])
    assert len(last["intersections"]) == len(eng.intersections_rows())
    for r in got:
        assert r["world_count"] == len(r["cylinders"]), r["frame"]
    # key for key the JAX engine's flush record, and its last view of the map
    assert jgot and set(got[-1]) == set(jgot[-1])
    assert set(got[-1]["drone"]) == set(jgot[-1]["drone"])
    assert (last["frame"], last["nlines"], last["status"], last["world_count"]) == tuple(
        jgot[-1][k] for k in ("frame", "nlines", "status", "world_count"))
    for c, j in zip(last["cylinders"], jgot[-1]["cylinders"]):
        np.testing.assert_allclose(c["p1"], j["p1"], atol=5e-3)


def test_viz_every_frame_forces_per_frame_records(frames):
    got = []
    eng = SegmentationEngine(CFG, device="cpu", viz_stream=got.append,
                             viz_every_frame=True, stream_sync_every=3)
    assert not eng._stream_deferred
    eng.start()
    for fr in frames[:3]:
        submit_and_wait(eng, fr)
    eng.stop()
    assert len(got) == 3 and all("viz_cadence" not in r for r in got)
    assert [r["frame"] for r in got] == [1, 2, 3]


def test_cli_viz_every_frame(frames, tmp_path, capsys):
    """`stream --viz-every-frame`: one record a processed frame; `serve` has
    the flag too."""
    log, viz = str(tmp_path / "f.pcsl"), str(tmp_path / "viz.jsonl")
    save_frames(log, frames[:4])
    cmd = [sys.executable, "-m", "pointcloud_segmentation_tpu_torch"]
    out = subprocess.run(
        cmd + ["stream", log, "--granularity", "2", "--device", "cpu", "--rate", "10",
               "--out", str(tmp_path / "out"), "--viz-stream", viz, "--viz-every-frame"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    nums = [int(w.strip(",;")) for w in out.stdout.splitlines()[0].split()
            if w.strip(",;").isdigit()]
    with open(viz) as f:
        recs = [json.loads(ln) for ln in f.read().splitlines()]
    assert len(recs) == nums[1] >= 1 and all("viz_cadence" not in r for r in recs)
    from pointcloud_segmentation_tpu_torch.cli import main

    with pytest.raises(SystemExit):
        main(["serve", "--help"])
    assert "--viz-every-frame" in capsys.readouterr().out
