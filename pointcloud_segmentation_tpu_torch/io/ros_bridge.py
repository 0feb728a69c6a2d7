"""Optional ROS 1 bridge — drop-in replacement for the reference node pair.

Maps the reference's topics onto a SegmentationEngine, keeping ROS entirely
off the hot path (the engine's mailbox drops stale frames exactly like the
node's depth-1 subscriber, node.cpp:64):

  subscribe /tof_pc                        -> engine.submit_cloud
  subscribe /mavros/local_position/pose    -> engine.push_pose
                                              (the pointcloud_tfbr.cpp
                                              mocap->world broadcast is this
                                              pose stream verbatim, so the
                                              TF hop is folded away)

rospy and ros_numpy-style decoding are imported lazily; constructing the
bridge without ROS installed raises ImportError with a clear message.  This
module is exercised against the fake transport in tests (no roscore).  The
port's own copy of the JAX package's io/ros_bridge.py (same code), on the
port's engine.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from ..runtime.engine import SegmentationEngine


def decode_pointcloud2(msg) -> np.ndarray:
    """Extract (N, 3) float32 xyz from a sensor_msgs/PointCloud2-like object.

    Works with any object exposing the standard fields (fields, point_step,
    is_bigendian, data) — duck-typed so tests can use a plain namespace.
    """
    offsets = {}
    for f in msg.fields:
        name = f.name if hasattr(f, "name") else f["name"]
        off = f.offset if hasattr(f, "offset") else f["offset"]
        offsets[name] = off
    if not all(k in offsets for k in ("x", "y", "z")):
        raise ValueError("PointCloud2 without x/y/z fields")
    n = len(msg.data) // msg.point_step
    raw = np.frombuffer(bytes(msg.data), dtype=np.uint8).reshape(n, msg.point_step)
    dt = ">f4" if getattr(msg, "is_bigendian", False) else "<f4"
    out = np.empty((n, 3), np.float32)
    for k, name in enumerate(("x", "y", "z")):
        o = offsets[name]
        out[:, k] = raw[:, o:o + 4].copy().view(dt)[:, 0]
    return out


def stamp_to_sec(stamp) -> float:
    if hasattr(stamp, "to_sec"):
        return float(stamp.to_sec())
    return float(stamp.secs) + float(stamp.nsecs) * 1e-9


class RosBridge:
    """Wire a live ROS graph to the engine (the node-pair replacement)."""

    def __init__(self, engine: SegmentationEngine,
                 cloud_topic: str = "/tof_pc",
                 pose_topic: str = "/mavros/local_position/pose"):
        try:
            import rospy  # noqa: F401
            from sensor_msgs.msg import PointCloud2
            from geometry_msgs.msg import PoseStamped
        except ImportError as e:
            raise ImportError(
                "RosBridge requires rospy (ROS 1). Use SegmentationEngine "
                "directly with push_pose/submit_cloud for ROS-free "
                "deployments.") from e
        self._rospy = rospy
        self.engine = engine
        engine.start()
        self._pose_sub = rospy.Subscriber(pose_topic, PoseStamped,
                                          self.on_pose, queue_size=64)
        self._cloud_sub = rospy.Subscriber(cloud_topic, PointCloud2,
                                           self.on_cloud, queue_size=1)

    # callbacks are transport-agnostic: tests invoke them with fakes
    def on_pose(self, msg) -> None:
        p = msg.pose.position
        q = msg.pose.orientation
        self.engine.push_pose(stamp_to_sec(msg.header.stamp),
                              (p.x, p.y, p.z), (q.w, q.x, q.y, q.z))

    def on_cloud(self, msg) -> None:
        pts = decode_pointcloud2(msg)
        self.engine.submit_cloud(stamp_to_sec(msg.header.stamp), pts)

    def shutdown(self) -> None:
        self.engine.stop()
