#!/usr/bin/env python
"""End-to-end example on the PyTorch port: map a steel structure from
simulated ToF frames.

Simulates a drone climbing in an orbit around a lattice tower, runs the
frames through the port's pipeline, evaluates against ground truth with the
reference's match criteria, and writes the CSVs and, where matplotlib is
installed, a plot.

    python examples/map_a_structure_torch.py [out_dir] [--device cpu]
        [--granularity 4] [--max-frames N]

The default device is the CUDA card, with the hand-written voting kernels;
``--device cpu`` runs their plain PyTorch versions (slow at granularity 4:
lower it, or cut the frames).
"""

import argparse
import importlib.util
import sys

from pointcloud_segmentation_tpu_torch import SegmentationEngine, default_config
from pointcloud_segmentation_tpu_torch.config import StaticShapes
from pointcloud_segmentation_tpu_torch.eval import match_report
from pointcloud_segmentation_tpu_torch.io.scene import (
    scene_truth, spiral_waypoints, tower_scene, trajectory_poses)
from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec, simulate_trajectory


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir", nargs="?", default="./tower_output")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--granularity", type=int, default=4)
    ap.add_argument("--max-frames", type=int, default=0, help="0: the whole flight")
    args = ap.parse_args(argv)

    scene = tower_scene(levels=2, width=1.0)
    poses = trajectory_poses(
        spiral_waypoints(radius=1.2, z0=0.4, z1=2.2, turns=2.0, n=40),
        hz=3.0, velocity=0.2)
    if args.max_frames:
        poses = poses[:args.max_frames]
    print(f"simulating {len(poses)} ToF frames over a {len(scene)}-beam tower ...")
    frames = simulate_trajectory(scene, poses, TofSpec(noise_frac=0.002), seed=0)

    cfg = default_config(
        granularity=args.granularity, path_to_output=args.out_dir,
        min_pca_coeff=0.99,  # report §5.2 benchmark value; the shipped
                             # 0.995 rejects oblique beam views (~9/12)
        shapes=StaticShapes(max_raw_points=4096, max_points=2048,
                            max_world_segments=64))
    eng = SegmentationEngine(cfg, device=args.device)
    eng.run_replay(frames)

    segs = eng.world_segments()
    proc = [dict(s, endpoints=[s["t_min"], s["t_max"]]) for s in segs]
    rep = match_report(scene_truth(scene), proc)
    print(f"world map: {len(segs)} segments, "
          f"{len(eng.intersections_rows())} intersections; "
          f"recall {rep['n_truth_matched']}/{rep['n_truth']} beams")

    paths = eng.finalize()
    print("outputs:")
    for k, v in paths.items():
        print(f"  {k}: {v}")
    if importlib.util.find_spec("matplotlib") is not None:
        from pointcloud_segmentation_tpu_torch import viz

        viz.plot_world(proc, scene_truth(scene), rep["matches"],
                       out_path=f"{args.out_dir}/world.png")
        print(f"  plot: {args.out_dir}/world.png")
    else:
        print("  plot: skipped, matplotlib is not installed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
