"""The port's ROS bridge (io/ros_bridge.py) without a roscore: message
decoding equal to the JAX package's, the ImportError without rospy, and the
callbacks feeding the port's engine on the CPU beside the JAX engine."""

import types

import numpy as np
import pytest
import torch

from pointcloud_segmentation_tpu import config as JC
from pointcloud_segmentation_tpu.io import ros_bridge as JB
from pointcloud_segmentation_tpu.runtime import SegmentationEngine as JaxEngine

from pointcloud_segmentation_tpu_torch import SegmentationEngine
from pointcloud_segmentation_tpu_torch import config as TC
from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy
from pointcloud_segmentation_tpu_torch.io import ros_bridge as TB
from pointcloud_segmentation_tpu_torch.io.scene import (OBS_TESTS_SCENE, WP_TESTS,
                                                        trajectory_poses)
from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec, simulate_trajectory

torch.set_num_threads(2)

SHAPES = dict(max_raw_points=4096, max_points=2048, max_world_segments=32)
CFG = TC.default_config(granularity=2, shapes=TC.StaticShapes(**SHAPES))
JCFG = JC.default_config(granularity=2, shapes=JC.StaticShapes(**SHAPES))


def stamp_of(t):
    secs = int(t)
    return types.SimpleNamespace(secs=secs, nsecs=int(round((t - secs) * 1e9)))


def cloud_msg(points, t=12.5, point_step=12, bigendian=False, as_dicts=False):
    """A duck-typed sensor_msgs/PointCloud2: x, y, z float32 at offsets 0, 4,
    8 of a point_step-byte record, the rest of the record filled with 0xAB."""
    pts = np.asarray(points, np.float32)
    rec = np.full((len(pts), point_step), 0xAB, np.uint8)
    rec[:, :12] = pts.astype(">f4" if bigendian else "<f4").view(np.uint8).reshape(-1, 12)
    fields = [{"name": n, "offset": o} if as_dicts else types.SimpleNamespace(name=n, offset=o)
              for n, o in (("x", 0), ("y", 4), ("z", 8))]
    return types.SimpleNamespace(
        fields=fields, point_step=point_step, is_bigendian=bigendian, data=rec.tobytes(),
        header=types.SimpleNamespace(stamp=stamp_of(t)))


def pose_msg(t, pos, quat_wxyz):
    p = types.SimpleNamespace(x=pos[0], y=pos[1], z=pos[2])
    q = types.SimpleNamespace(w=quat_wxyz[0], x=quat_wxyz[1], y=quat_wxyz[2], z=quat_wxyz[3])
    return types.SimpleNamespace(header=types.SimpleNamespace(stamp=stamp_of(t)),
                                 pose=types.SimpleNamespace(position=p, orientation=q))


@pytest.mark.parametrize("layout", ["packed", "padded_point_step", "big_endian",
                                    "big_endian_padded", "fields_as_dicts", "empty"])
def test_decode_pointcloud2_equals_the_jax_decoder(layout):
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(0 if layout == "empty" else 37, 3)).astype(np.float32)
    msg = cloud_msg(pts, point_step=20 if "padded" in layout else 12,
                    bigendian="big_endian" in layout, as_dicts=layout == "fields_as_dicts")
    got, want = TB.decode_pointcloud2(msg), JB.decode_pointcloud2(msg)
    assert got.dtype == want.dtype == np.float32 and got.shape == (len(pts), 3)
    assert got.tobytes() == want.tobytes() == pts.tobytes()


def test_decode_pointcloud2_without_xyz_raises_as_the_jax_decoder():
    msg = cloud_msg(np.zeros((2, 3)))
    msg.fields = msg.fields[:2]
    errs = []
    for mod in (TB, JB):
        with pytest.raises(ValueError, match="without x/y/z") as e:
            mod.decode_pointcloud2(msg)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_stamp_to_sec_equals_the_jax_function():
    for stamp in (types.SimpleNamespace(secs=12, nsecs=500_000_000),
                  types.SimpleNamespace(secs=0, nsecs=1),
                  types.SimpleNamespace(secs=1_700_000_000, nsecs=999_999_999),
                  types.SimpleNamespace(to_sec=lambda: 3.25, secs=9, nsecs=9)):
        assert TB.stamp_to_sec(stamp) == JB.stamp_to_sec(stamp)
    assert TB.stamp_to_sec(types.SimpleNamespace(secs=12, nsecs=500_000_000)) == 12.5


def test_bridge_requires_rospy_with_the_jax_bridges_message():
    eng = SegmentationEngine(CFG, backend="oracle")
    jeng = JaxEngine(JCFG, backend="oracle")
    with pytest.raises(ImportError, match="rospy") as mine:
        TB.RosBridge(eng)
    with pytest.raises(ImportError, match="rospy") as theirs:
        JB.RosBridge(jeng)
    assert str(mine.value) == str(theirs.value)
    assert eng._worker is None          # nothing started before the refusal


def bridged(bridge_cls, eng):
    bridge = bridge_cls.__new__(bridge_cls)     # skip the rospy wiring
    bridge.engine = eng
    return bridge


def test_bridge_callbacks_put_pose_and_cloud_where_the_jax_bridge_does():
    eng, jeng = SegmentationEngine(CFG, backend="oracle"), JaxEngine(JCFG, backend="oracle")
    pts = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    taken = []
    for cls, e in ((TB.RosBridge, eng), (JB.RosBridge, jeng)):
        b = bridged(cls, e)
        b.on_pose(pose_msg(12.4, (1.0, 2.0, 0.5), (1.0, 0, 0, 0)))
        assert len(e.poses) == 1
        b.on_cloud(cloud_msg(pts, point_step=16))
        taken.append(e.mailbox.take(timeout=0.5))
    (t, got), (jt, jgot) = taken
    assert t == jt == 12.5 and got.tobytes() == jgot.tobytes() == pts.tobytes()
    assert eng.frames_submitted == 1
    a, b = eng.poses.lookup(12.4), jeng.poses.lookup(12.4)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def endpoints(s):
    a, b = np.asarray(s["a"], np.float64), np.asarray(s["b"], np.float64)
    return a + s["t_min"] * b, a + s["t_max"] * b


def test_bridge_feeds_both_engines_to_the_same_world():
    """Six frames as PointCloud2/PoseStamped objects through on_pose/on_cloud
    of each package's bridge, each drained before the next: all processed,
    the port's state bit-equal to its own synchronous replay, and the world
    segments within 2e-2 of the JAX engine's with equal counts."""
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:6]
    frames = simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.002), seed=1)
    eng = SegmentationEngine(CFG, device="cpu")
    jeng = JaxEngine(JCFG, backend="jax")
    for cls, e in ((TB.RosBridge, eng), (JB.RosBridge, jeng)):
        bridge = bridged(cls, e)
        e.start()
        try:
            for i, fr in enumerate(frames):
                bridge.on_pose(pose_msg(fr.t, fr.position, fr.quat_wxyz))
                bridge.on_cloud(cloud_msg(fr.points, t=fr.t, point_step=16))
                assert e.drain(target_total=i + 1, timeout=120.0)
        finally:
            bridge.shutdown()
        assert e._worker is None
        assert (e.frames_processed, e.dropped_frames, e.frames_skipped_no_pose) == (6, 0, 0)

    ref = SegmentationEngine(CFG, device="cpu")
    ref.run_replay(frames)
    mine, want = world_state_to_numpy(eng.state), world_state_to_numpy(ref.state)
    assert all(np.array_equal(mine[f], want[f], equal_nan=True) for f in mine)

    got, theirs = eng.world_segments(), jeng.world_segments()
    assert len(got) == len(theirs) >= 3
    assert [r["nblines"] for r in eng.records] == [r["nblines"] for r in jeng.records]
    for s, w in zip(got, theirs):
        (p1, p2), (q1, q2) = endpoints(s), endpoints(w)
        assert max(np.abs(p1 - q1).max(), np.abs(p2 - q2).max()) < 2e-2
    assert len(eng.intersections_rows()) == len(jeng.intersections_rows())
