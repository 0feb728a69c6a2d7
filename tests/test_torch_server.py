"""The port's TCP server (runtime/server.py) on the CPU engine, held against
the JAX package's server on the same frames: serve, query and finalize, the
wire protocol across the two packages, a bad client followed by a good one,
a hostile message length, and a finalize that drains in-flight frames."""

import csv
import os
import socket
import struct
import time

import numpy as np
import pytest
import torch

from pointcloud_segmentation_tpu import config as JC
from pointcloud_segmentation_tpu.io.scene import OBS_TESTS_SCENE, WP_TESTS, trajectory_poses
from pointcloud_segmentation_tpu.io.simulator import simulate_trajectory, TofSpec
from pointcloud_segmentation_tpu.runtime import SegmentationEngine as JaxEngine
from pointcloud_segmentation_tpu.runtime import server as JSRV

from pointcloud_segmentation_tpu_torch import config as TC
from pointcloud_segmentation_tpu_torch import SegmentationEngine
from pointcloud_segmentation_tpu_torch.io.replay import save_frames
from pointcloud_segmentation_tpu_torch.runtime.server import (
    SegmentationClient, SegmentationServer)

torch.set_num_threads(2)

SHAPES = dict(max_raw_points=4096, max_points=2048, max_world_segments=32)
CFG = TC.default_config(granularity=2, shapes=TC.StaticShapes(**SHAPES))
JCFG = JC.default_config(granularity=2, shapes=JC.StaticShapes(**SHAPES))
HEADERS = {"segments": "segment,a_x,a_y,a_z,b_x,b_y,b_z,t_min,t_max",
           "intersections": "seg1,t1,seg2,t2",
           "processing_time": "wall_time,processing_time,seg_vec_size,nblines"}


@pytest.fixture(scope="module")
def frames():
    poses = trajectory_poses(WP_TESTS, hz=1.5, velocity=0.3)[:8]
    return simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.002), seed=11)


def serve_lockstep(srv, client_cls, frames):
    """Send each frame and query until the server has accounted for it, so
    nothing drops; returns the last snapshot and the finalize reply."""
    cli = client_cls(srv.host, srv.port, timeout=120.0)
    try:
        for i, fr in enumerate(frames):
            cli.send_frame(fr.t, fr.position, fr.quat_wxyz, fr.points)
            deadline = time.monotonic() + 60.0
            while True:
                snap = cli.query()
                done = (snap["frames_processed"] + snap["frames_dropped"]
                        + snap["frames_skipped_no_pose"])
                if done >= i + 1 or time.monotonic() > deadline:
                    break
                time.sleep(0.01)
        return snap, cli.finalize()
    finally:
        cli.close()


def endpoints(s):
    a, b = np.asarray(s["a"], np.float64), np.asarray(s["b"], np.float64)
    return a + s["t_min"] * b, a + s["t_max"] * b


@pytest.fixture(scope="module")
def jax_served(frames, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_serve"))
    srv = JSRV.SegmentationServer(JaxEngine(JCFG, backend="jax"), outdir=out).start()
    try:
        return serve_lockstep(srv, JSRV.SegmentationClient, frames)
    finally:
        srv.stop()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_serve_query_finalize_matches_the_jax_server(frames, jax_served, tmp_path, client):
    """The port's server, talked to by the port's client and by the JAX
    package's (the wire format is one), ends with the JAX server's map."""
    eng = SegmentationEngine(CFG, device="cpu")
    srv = SegmentationServer(eng, outdir=str(tmp_path)).start()
    try:
        cls = SegmentationClient if client == "port" else JSRV.SegmentationClient
        snap, out = serve_lockstep(srv, cls, frames)
    finally:
        srv.stop()
    jsnap, _ = jax_served
    assert snap["frames_processed"] == jsnap["frames_processed"] == len(frames)
    assert snap["frames_dropped"] == 0
    segs, jsegs = snap["world_segments"], jsnap["world_segments"]
    assert len(segs) == len(jsegs) >= 1
    assert [s["points_size"] for s in segs] == [s["points_size"] for s in jsegs]
    for s, j in zip(segs, jsegs):
        (p1, p2), (q1, q2) = endpoints(s), endpoints(j)
        assert np.linalg.norm(p1 - q1) + np.linalg.norm(p2 - q2) < 5e-3
    assert [r[::2] for r in snap["intersections"]] == [r[::2] for r in jsnap["intersections"]]
    assert out["drained"] is True
    for key, header in HEADERS.items():
        with open(out["outputs"][key]) as f:
            assert f.readline().strip() == header
    with open(out["outputs"]["processing_time"]) as f:
        assert len(list(csv.DictReader(f))) == len(frames)
    assert not srv._running and eng._worker is None


def test_bad_client_then_a_good_one(frames, tmp_path):
    srv = SegmentationServer(SegmentationEngine(CFG, device="cpu"), outdir=str(tmp_path)).start()
    try:
        raw = socket.create_connection((srv.host, srv.port), timeout=5.0)
        raw.sendall(b"\xde\xad\xbe\xef" * 4)          # unknown message type
        raw.close()
        time.sleep(0.2)
        cli = SegmentationClient(srv.host, srv.port)
        fr = frames[0]
        cli.send_frame(fr.t, fr.position, fr.quat_wxyz, fr.points)
        assert "world_segments" in cli.query()
        cli.close()
    finally:
        srv.stop()


def test_a_hostile_message_length_is_capped(frames, tmp_path):
    eng = SegmentationEngine(CFG, device="cpu")
    srv = SegmentationServer(eng, outdir=str(tmp_path)).start()
    try:
        assert srv._max_msg == JSRV.SegmentationServer(
            JaxEngine(JCFG, backend="oracle"), port=0)._max_msg < 0xFFFFFFFF
        raw = socket.create_connection((srv.host, srv.port), timeout=5.0)
        raw.sendall(struct.pack("<BI", ord("F"), 0xFFFFFFFF))
        raw.sendall(b"x" * 4096)                      # never buffered to 4 GiB
        time.sleep(0.3)
        raw.close()
        cli = SegmentationClient(srv.host, srv.port)
        fr = frames[0]
        cli.send_frame(fr.t, fr.position, fr.quat_wxyz, fr.points)
        out = cli.finalize()
        assert out["drained"] is True
        cli.close()
    finally:
        srv.stop()
    assert eng.frames_processed + eng.dropped_frames == 1


def test_finalize_drains_in_flight_frames(frames, tmp_path):
    eng = SegmentationEngine(CFG, device="cpu")
    srv = SegmentationServer(eng, outdir=str(tmp_path)).start()
    try:
        cli = SegmentationClient(srv.host, srv.port, timeout=120.0)
        for fr in frames[:4]:
            cli.send_frame(fr.t, fr.position, fr.quat_wxyz, fr.points)
        out = cli.finalize()                           # no drain by the client
        cli.close()
    finally:
        srv.stop()
    assert (eng.frames_processed + eng.dropped_frames + eng.frames_skipped_no_pose
            + eng.frames_failed) == 4
    with open(out["outputs"]["processing_time"]) as f:
        assert len(list(csv.DictReader(f))) == eng.frames_processed >= 1


def test_stream_twice_from_a_log_counts_each_run(frames, tmp_path):
    log = str(tmp_path / "r.pcsl")
    save_frames(log, frames[:5])
    eng = SegmentationEngine(CFG, device="cpu")
    s1 = eng.run_streaming_from_log(log, rate_hz=0.0)
    s2 = eng.run_streaming_from_log(log, rate_hz=0.0)
    for s in (s1, s2):
        assert s["drained"] is True
        assert s["fed"] == 5 == s["processed"] + s["dropped"]
        assert s["processed"] >= 1
    assert eng.frames_processed == s1["processed"] + s2["processed"]
    assert eng.dropped_frames == s1["dropped"] + s2["dropped"]
