"""Scenes, trajectories, the ToF simulator and the recorded-data readers (ROS1
bags, MCAP) the port is replayed with."""

from .scene import (
    Cylinder,
    OBS_TESTS_SCENE,
    WP_TESTS,
    simple_scene,
    scene_truth,
    trajectory_poses,
    yaw_to_quat_wxyz,
    load_waypoints_csv,
)
from .simulator import TofSpec, Frame, render_depth, simulate_trajectory, cylinder_surface_cloud
from .rosbag import bag_to_frames, read_bag, write_bag, frames_to_bag

__all__ = [
    "Cylinder", "OBS_TESTS_SCENE", "WP_TESTS", "simple_scene", "scene_truth",
    "trajectory_poses", "yaw_to_quat_wxyz", "load_waypoints_csv",
    "TofSpec", "Frame", "render_depth", "simulate_trajectory",
    "cylinder_surface_cloud",
    "bag_to_frames", "read_bag", "write_bag", "frames_to_bag",
]
