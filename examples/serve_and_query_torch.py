"""Serving-mode demo on the PyTorch port: the engine behind TCP, a client
that streams frames and queries the map.

    python examples/serve_and_query_torch.py [--device cpu] [--granularity 4]
        [--max-frames N]

Starts a server on an ephemeral port, streams a simulated flight past the
7-beam scene through it at sensor rate, polls the world map in mid-flight,
then finalizes (CSV flush): what the reference's ROS loop does
(pointcloud_segmentation_node.cpp:64-67), without a ROS stack.  The server's
engine streams in its default deferred mode: a frame's record gets its
values at the next batched read-back, and everything is read by the time
`finalize` answers.
"""

import argparse
import tempfile
import time

from pointcloud_segmentation_tpu_torch.config import default_config
from pointcloud_segmentation_tpu_torch.io.scene import (OBS_TESTS_SCENE, WP_TESTS,
                                                        trajectory_poses)
from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec, simulate_trajectory
from pointcloud_segmentation_tpu_torch.runtime import SegmentationEngine
from pointcloud_segmentation_tpu_torch.runtime.server import (SegmentationClient,
                                                              SegmentationServer)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--granularity", type=int, default=4)
    ap.add_argument("--max-frames", type=int, default=0, help="0: the whole flight")
    args = ap.parse_args(argv)

    outdir = tempfile.mkdtemp(prefix="pcs_served_")
    cfg = default_config(granularity=args.granularity, path_to_output=outdir)
    server = SegmentationServer(SegmentationEngine(cfg, device=args.device),
                                outdir=outdir).start()
    print(f"serving on {server.host}:{server.port}; outputs -> {outdir}")
    try:
        poses = trajectory_poses(WP_TESTS, hz=3.0, velocity=0.2)
        frames = simulate_trajectory(
            OBS_TESTS_SCENE, poses[:args.max_frames] if args.max_frames else poses,
            TofSpec(noise_frac=0.002), seed=0)
        client = SegmentationClient(server.host, server.port, timeout=300.0)
        for i, fr in enumerate(frames):
            client.send_frame(fr.t, fr.position, fr.quat_wxyz, fr.points)
            time.sleep(1 / 30)                      # sensor pacing
            if i % 30 == 29:
                snap = client.query()
                print(f"  t={fr.t:6.2f}  processed={snap['frames_processed']:3d} "
                      f"dropped={snap['frames_dropped']:3d} "
                      f"world={len(snap['world_segments'])}")

        # drain, then flush
        while True:
            snap = client.query()
            done = (snap["frames_processed"] + snap["frames_dropped"]
                    + snap["frames_skipped_no_pose"])
            if done >= len(frames):
                break
            time.sleep(0.2)
        out = client.finalize()
        print(f"final: {len(snap['world_segments'])} world segments, "
              f"{len(snap['intersections'])} intersections")
        for k, v in out["outputs"].items():
            print(f"  {k}: {v}")
        client.close()
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
