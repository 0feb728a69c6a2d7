"""Command-line interface of the PyTorch port, the `roslaunch` analog.

Subcommands:
  run      simulate (or replay) a trajectory through the pipeline, write the
           three reference CSVs
  record   simulate a trajectory and save a binary replay log
  stream   replay a recorded log through the live runtime at sensor rate
           (feeder -> latest-wins mailbox -> worker thread)
  serve    put the engine behind a TCP endpoint: binary frame stream in,
           world-map queries / CSV flush out (the deployable node loop)
  eval     compare a segments.csv against the benchmark scene's ground truth
           with the reference match criteria (tests_structure.py analog)
  timing   analyze a processing_time.csv (proc_time_analysis.py analog)

The commands, flags and output are the JAX package's CLI's, with --backend
torch (the default) or oracle (the numpy reference on the host, which needs
no card), and --device for the torch backend (default cuda, which raises
without a card).  A config whose compute_dtype is float64 runs the parity
mode end to end.

Examples:
  python -m pointcloud_segmentation_tpu_torch run --out ./output_data
  python -m pointcloud_segmentation_tpu_torch run --granularity 2 --device cpu
  python -m pointcloud_segmentation_tpu_torch run --replay log.pcsl --backend oracle
  python -m pointcloud_segmentation_tpu_torch record log.pcsl --max-frames 100
  python -m pointcloud_segmentation_tpu_torch stream log.pcsl --rate 30 --out ./o
  python -m pointcloud_segmentation_tpu_torch eval ./output_data/segments.csv
  python -m pointcloud_segmentation_tpu_torch timing ./output_data/processing_time.csv
"""

from __future__ import annotations

import argparse
import json
import os
import sys

SCENES = ["obs_tests", "dev", "tower", "mockup"]


def _add_common(p):
    p.add_argument("--config", help="reference-format config.yaml")
    p.add_argument("--granularity", type=int, default=None)
    p.add_argument("--opt-nlines", type=int, default=None)
    p.add_argument("--backend", choices=["torch", "oracle"], default="torch")
    p.add_argument("--device", default="cuda",
                   help="torch device of the pipeline (cuda, cuda:N or cpu); "
                        "the oracle backend runs on the host whatever it says")
    p.add_argument("--out", default=None, help="output dir (path_to_output)")


def _build_cfg(args):
    from .config import PipelineConfig, default_config

    overrides = {}
    if args.granularity is not None:
        overrides["granularity"] = args.granularity
    if getattr(args, "opt_nlines", None) is not None:
        overrides["opt_nlines"] = args.opt_nlines
    if getattr(args, "surface_offset", False):
        overrides["surface_offset_correction"] = True
    if args.out:
        overrides["path_to_output"] = args.out
    if args.config:
        return PipelineConfig.from_yaml(args.config, **overrides)
    return default_config(**overrides)


def _scene_and_waypoints(name: str):
    """Scene registry: each named scenario = (beam scene, default flight).

    obs_tests = the 7-beam benchmark world + wp_tests vertical scan;
    dev       = the 9-beam r=0.1 development world + figure-eight;
    tower     = the 2-level lattice tower + orbiting climb (wp_tower-style);
    mockup    = the tall scaffold + wp_mockup four-sided scan.
    """
    from .io import scene as S

    if name == "obs_tests":
        return S.OBS_TESTS_SCENE, S.WP_TESTS
    if name == "dev":
        return S.OBS_DEV_SCENE, S.figure_eight_waypoints(a=1.8, z=1.7)
    if name == "tower":
        return (S.tower_scene(levels=2, width=1.0),
                S.spiral_waypoints(radius=1.2, z0=0.4, z1=2.2, turns=2.0, n=40))
    if name == "mockup":
        return S.mockup_scene(), S.WP_MOCKUP
    raise SystemExit(f"unknown scene {name!r} "
                     f"(choose obs_tests, dev, tower, mockup)")


def _resolve_scene(args):
    """Scene from --wbt (a Webots world file, e.g. the reference's
    flying_arena_ros_obs_tests.wbt — SEGn cylinders parsed as ground truth)
    or from the named --scene registry."""
    from .io import scene as S

    if getattr(args, "wbt", None):
        beams = S.parse_wbt_scene(args.wbt)
        if not beams:
            raise SystemExit(f"{args.wbt}: no DEF SEGn cylinders found")
        return beams, S.WP_TESTS
    return _scene_and_waypoints(getattr(args, "scene", "obs_tests"))


def _frames(args):
    from .io.scene import load_waypoints_csv, trajectory_poses
    from .io.simulator import TofSpec, simulate_trajectory

    if getattr(args, "replay", None):
        from .io.replay import load_frames

        frames = load_frames(args.replay)
        return frames[: args.max_frames] if args.max_frames else frames
    scene, wps_default = _resolve_scene(args)
    wps = (load_waypoints_csv(args.waypoints)
           if getattr(args, "waypoints", None) else wps_default)
    poses = trajectory_poses(wps, hz=args.hz, velocity=args.velocity)
    if args.max_frames:
        poses = poses[: args.max_frames]
    return simulate_trajectory(scene, poses,
                               TofSpec(noise_frac=args.noise), seed=args.seed)


def _reject_orphan_world_points(args) -> bool:
    """--viz-world-points only feeds the viz stream's `hough_points`; with
    no --viz-stream it would accumulate every frame's inlier points on the
    host without bound, for no output.  Refuse instead."""
    if getattr(args, "viz_world_points", False) and not args.viz_stream:
        print("error: --viz-world-points requires --viz-stream FILE "
              "(it only populates the viz stream's hough_points)",
              file=sys.stderr)
        return True
    return False


def cmd_run(args) -> int:
    from .runtime import SegmentationEngine

    if _reject_orphan_world_points(args):
        return 2
    cfg = _build_cfg(args)
    frames = _frames(args)
    eng = SegmentationEngine(
        cfg, device=args.device, backend=args.backend, viz_stream=args.viz_stream,
        viz_points=args.viz_points or args.viz_world_points,
        collect_inlier_points=args.viz_world_points)
    eng.run_replay(frames)
    outdir = args.out or cfg.path_to_output
    paths = eng.finalize(outdir)
    segs, inter = eng.world_snapshot()
    print(f"{len(frames)} frames -> {len(segs)} world segments, "
          f"{len(inter)} intersections")
    for k, v in paths.items():
        print(f"  {k}: {v}")
    if args.viz_stream:
        print(f"  viz stream: {args.viz_stream}")
    return 0


def cmd_record(args) -> int:
    from .io.replay import save_frames

    n = save_frames(args.log, _frames(args))
    print(f"recorded {n} frames -> {args.log}")
    return 0


def cmd_stream(args) -> int:
    """Stream a recorded log through the live runtime (feeder -> latest-wins
    mailbox + pose buffer -> worker thread) at sensor rate: the closest
    analog of the live ROS node loop."""
    from .runtime import SegmentationEngine

    if _reject_orphan_world_points(args):
        return 2
    cfg = _build_cfg(args)
    eng = SegmentationEngine(
        cfg, device=args.device, backend=args.backend, viz_stream=args.viz_stream,
        viz_points=args.viz_points or args.viz_world_points,
        collect_inlier_points=args.viz_world_points)
    stats = eng.run_streaming_from_log(args.log, rate_hz=args.rate,
                                       loops=args.loops)
    outdir = args.out or cfg.path_to_output
    paths = eng.finalize(outdir)
    segs = eng.world_segments()
    print(f"fed {stats['fed']} frames at {args.rate} Hz -> processed "
          f"{stats['processed']}, dropped {stats['dropped']} (latest-wins), "
          f"skipped {eng.frames_skipped_no_pose} (no pose); "
          f"{len(segs)} world segments")
    for k, v in paths.items():
        print(f"  {k}: {v}")
    return 0


def cmd_serve(args) -> int:
    """Serve the engine over TCP (runtime/server.py): clients stream binary
    frames (the PCSL record format) and query/flush the world map."""
    from .runtime import SegmentationEngine
    from .runtime.server import SegmentationServer

    cfg = _build_cfg(args)
    eng = SegmentationEngine(cfg, device=args.device, backend=args.backend,
                             viz_stream=args.viz_stream)
    srv = SegmentationServer(eng, host=args.host, port=args.port,
                             outdir=args.out or cfg.path_to_output)
    print(f"serving on {srv.host}:{srv.port}", flush=True)
    if args.viz_stream:
        print(f"viz stream: {args.viz_stream}", flush=True)
    out = srv.serve_forever()
    print(json.dumps(out))
    return 0


def cmd_eval(args) -> int:
    from .eval import match_report
    from .io.scene import scene_truth
    from .runtime.csvio import read_segments_csv

    proc = read_segments_csv(args.segments_csv)
    scene, _ = _resolve_scene(args)
    rep = match_report(scene_truth(scene), proc, args.angle_threshold,
                       args.distance_threshold)
    print(json.dumps({k: v for k, v in rep.items() if k != "matches"}, indent=2))
    return 0 if rep["n_truth_matched"] else 1


def cmd_timing(args) -> int:
    from .eval import load_processing_time_csv, summarize

    data = load_processing_time_csv(args.processing_time_csv)
    print(json.dumps(summarize(data), indent=2))
    if args.plots:
        from .eval.timing import plot_boxplots

        base = os.path.dirname(os.path.abspath(args.processing_time_csv))
        plot_boxplots(data, os.path.join(base, "timing.png"))
        print(f"plots: {base}/timing.png")
    return 0


def _add_trajectory(p):
    p.add_argument("--scene", default="obs_tests", choices=SCENES,
                   help="simulated world + default flight pattern")
    p.add_argument("--wbt", help="Webots world file: fly the simulated "
                                 "trajectory against its DEF SEGn cylinders "
                                 "(e.g. the reference's obs_tests world)")
    p.add_argument("--waypoints", help="reference-format waypoint CSV")
    p.add_argument("--hz", type=float, default=4.0)
    p.add_argument("--velocity", type=float, default=0.25)
    p.add_argument("--noise", type=float, default=0.002)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=0)


def _add_viz_points(p):
    p.add_argument("--viz-points", action="store_true",
                   help="embed per-frame filtered/hough point clouds in the "
                        "viz stream (filtered_pointcloud / hough_pointcloud "
                        "topics analog)")
    p.add_argument("--viz-world-points", action="store_true",
                   help="like --viz-points, but hough_points carries ALL "
                        "world segments' accumulated inliers each frame (the "
                        "reference's republish-everything hough_pointcloud "
                        "semantics, node.cpp:823-829; capped at the most "
                        "recent 4096 points)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pointcloud_segmentation_tpu_torch",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run the pipeline over a trajectory")
    _add_common(pr)
    _add_trajectory(pr)
    pr.add_argument("--replay", help="replay a recorded .pcsl frame log")
    pr.add_argument("--surface-offset", action="store_true",
                    help="enable the E-OFFSET axis-bias correction "
                         "(report §6.3 ground-truth offset; opt-in "
                         "accuracy extension beyond the reference)")
    _add_viz_points(pr)
    pr.add_argument("--viz-stream", default=None, metavar="JSONL",
                    help="write a per-frame marker stream (the RViz "
                         "re-publish loop analog) to this JSONL file")
    pr.set_defaults(fn=cmd_run)

    pc = sub.add_parser("record", help="simulate + save a replay log")
    _add_common(pc)
    pc.add_argument("log", help="output .pcsl path")
    _add_trajectory(pc)
    pc.set_defaults(fn=cmd_record)

    ps = sub.add_parser("stream",
                        help="stream a .pcsl log through the live runtime "
                             "(feeder -> mailbox -> worker) at sensor rate")
    _add_common(ps)
    ps.add_argument("log", help="input .pcsl path (see `record`)")
    ps.add_argument("--rate", type=float, default=30.0,
                    help="feed rate in Hz (0 = as fast as possible)")
    ps.add_argument("--loops", type=int, default=1)
    ps.add_argument("--viz-stream", default=None, metavar="JSONL",
                    help="per-frame marker stream, one record per processed "
                         "frame")
    _add_viz_points(ps)
    ps.set_defaults(fn=cmd_stream)

    px = sub.add_parser("serve", help="serve the engine over TCP "
                        "(binary frame stream in, world-map queries out)")
    _add_common(px)
    px.add_argument("--host", default="127.0.0.1")
    px.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral, printed at startup)")
    px.add_argument("--viz-stream", default=None, metavar="JSONL",
                    help="also write the per-frame marker stream")
    px.set_defaults(fn=cmd_serve)

    pe = sub.add_parser("eval", help="ground-truth accuracy of a segments.csv")
    pe.add_argument("segments_csv")
    pe.add_argument("--scene", default="obs_tests", choices=SCENES)
    pe.add_argument("--wbt", help="ground truth from a Webots world file")
    pe.add_argument("--angle-threshold", type=float, default=0.1)
    pe.add_argument("--distance-threshold", type=float, default=0.5)
    pe.set_defaults(fn=cmd_eval)

    pt = sub.add_parser("timing", help="analyze a processing_time.csv")
    pt.add_argument("processing_time_csv")
    pt.add_argument("--plots", action="store_true")
    pt.set_defaults(fn=cmd_timing)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
