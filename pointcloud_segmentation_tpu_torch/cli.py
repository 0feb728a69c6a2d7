"""Command-line interface of the PyTorch port, the `roslaunch` analog.

Subcommands:
  run      simulate (or replay) a trajectory through the pipeline, write the
           three reference CSVs (+ optional plots)
  record   simulate a trajectory (or read a recorded bag) and save a binary
           replay log
  stream   replay a recorded log through the live runtime at sensor rate
           (feeder -> latest-wins mailbox -> worker thread)
  serve    put the engine behind a TCP endpoint: binary frame stream in,
           world-map queries / CSV flush out (the deployable node loop)
  viz      render a per-frame viz stream into an interactive HTML player
  eval     compare a segments.csv against the benchmark scene's ground truth
           with the reference match criteria (tests_structure.py analog)
  timing   analyze a processing_time.csv (proc_time_analysis.py analog)
  bag-info per-topic summary of a recorded ROS1 .bag / ROS2 .mcap
  inspect  run one frame under the profiler: kernel launches and device time
           beside the shape and capacity facts

The commands, flags and output are the JAX package's CLI's, with --backend
torch (the default) or oracle (the numpy reference on the host, which needs
no card), and --device for the torch backend (default cuda, which raises
without a card).  A config whose compute_dtype is float64 runs the parity
mode end to end.

Examples:
  python -m pointcloud_segmentation_tpu_torch run --out ./output_data
  python -m pointcloud_segmentation_tpu_torch run --granularity 2 --device cpu
  python -m pointcloud_segmentation_tpu_torch run --replay log.pcsl --backend oracle
  python -m pointcloud_segmentation_tpu_torch run --bag flight.bag --out ./o
  python -m pointcloud_segmentation_tpu_torch record log.pcsl --max-frames 100
  python -m pointcloud_segmentation_tpu_torch stream log.pcsl --rate 30 --out ./o
  python -m pointcloud_segmentation_tpu_torch eval ./output_data/segments.csv --plots
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

    if getattr(args, "bag", None):
        from .io.rosbag import bag_to_frames

        # recorded ROS data (the reference's /tof_pc + pose topics,
        # node.cpp:64-67) — poses associated via the TF2-analog buffer
        frames = bag_to_frames(args.bag,
                               cloud_topic=getattr(args, "cloud_topic", None),
                               pose_topic=getattr(args, "pose_topic", None))
        return frames[: args.max_frames] if getattr(args, "max_frames", 0) \
            else frames
    if getattr(args, "replay", None):
        from .io.replay import load_frames

        frames = load_frames(args.replay)
        # --max-frames applies to replayed logs too, not only simulated
        # trajectories
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
    if args.plots:
        from . import viz
        from .eval import match_report
        from .io.scene import scene_truth

        scene, _ = _resolve_scene(args)
        truth = scene_truth(scene)
        proc = [dict(s, endpoints=[s["t_min"], s["t_max"]]) for s in segs]
        rep = match_report(truth, proc)
        viz.plot_world(proc, truth, rep["matches"],
                       out_path=os.path.join(outdir, "world.png"))
        if rep["matches"]:
            viz.plot_distance_vs_angle(
                rep["matches"], out_path=os.path.join(outdir, "errors.png"))
        print(f"  plots: {outdir}/world.png")
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
        viz_every_frame=args.viz_every_frame,
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
                             viz_stream=args.viz_stream,
                             viz_every_frame=args.viz_every_frame)
    srv = SegmentationServer(eng, host=args.host, port=args.port,
                             outdir=args.out or cfg.path_to_output)
    print(f"serving on {srv.host}:{srv.port}", flush=True)
    if args.viz_stream:
        print(f"viz stream: {args.viz_stream}  (watch live with "
              f"`pcs-torch viz {args.viz_stream} --follow`)", flush=True)
    out = srv.serve_forever()
    print(json.dumps(out))
    return 0


def cmd_viz(args) -> int:
    """Render a per-frame viz-stream JSONL (from `run --viz-stream`) into a
    self-contained interactive HTML player — the offline RViz stand-in.
    With --follow, serve a live player instead that tails the (growing)
    JSONL, so a concurrent run/stream/serve process is watched as it maps."""
    if args.follow:
        from .viz import VizStreamServer

        srv = VizStreamServer(args.stream, host=args.host, port=args.port)
        print(f"live player: {srv.url}  (following {args.stream}; Ctrl-C "
              f"to stop)", flush=True)
        try:
            srv.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0
    from .viz import render_viz_stream_html

    out = args.out or (os.path.splitext(args.stream)[0] + ".html")
    n = render_viz_stream_html(args.stream, out)
    print(f"{n} frames -> {out}")
    return 0


def cmd_eval(args) -> int:
    from .eval import match_report
    from .io.scene import scene_truth
    from .runtime.csvio import read_segments_csv

    proc = read_segments_csv(args.segments_csv)
    scene, _ = _resolve_scene(args)
    truth = scene_truth(scene)
    rep = match_report(truth, proc, args.angle_threshold, args.distance_threshold)
    print(json.dumps({k: v for k, v in rep.items() if k != "matches"}, indent=2))
    if args.plots:
        from . import viz

        base = os.path.dirname(os.path.abspath(args.segments_csv))
        viz.plot_world(proc, truth, rep["matches"],
                       out_path=os.path.join(base, "eval_world.png"))
        if rep["matches"]:
            viz.plot_distance_vs_angle(
                rep["matches"], out_path=os.path.join(base, "eval_errors.png"))
        print(f"plots: {base}/eval_world.png")
    return 0 if rep["n_truth_matched"] else 1


# frame of the flight that `inspect` profiles, after the frame before it as
# a warm-up: by then the drone has beams in view
INSPECT_FRAME = 10


def cmd_inspect(args) -> int:
    """Run one real frame under torch.profiler and print what it cost beside
    the shape and capacity facts — the profiling/observability hook.  Eager
    PyTorch has no compiled step to ask for FLOPs and bytes, so the frame's
    kernel launches (the profiler's CUDA-runtime launch events), its device
    time (the kernels' own time, summed) and its wall time (with the profiler
    on) take their place.  On the CPU the card's fields are left out."""
    import contextlib
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .io.scene import trajectory_poses
    from .io.simulator import TofSpec, simulate_trajectory
    from .ops import voting as V
    from .runtime import SegmentationEngine

    cfg = _build_cfg(args)
    scene, wps = _scene_and_waypoints(args.scene)
    poses = trajectory_poses(wps, hz=4.0, velocity=0.25)[: INSPECT_FRAME + 1]
    frames = simulate_trajectory(scene, poses, TofSpec(noise_frac=0.002),
                                 seed=args.seed)
    eng = SegmentationEngine(cfg, device=args.device)
    on_card = eng.device.type == "cuda"

    def profiler():
        if not on_card:
            return contextlib.nullcontext()
        return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    # the warm-up frame pays the process's lazy start-up, the profiler's too
    with profiler():
        eng.run_replay(frames[-2:-1])
    V.vote_state.launches = V.vote_histogram.launches = 0
    with profiler() as prof:
        t0 = time.perf_counter()
        (rec,) = eng.run_replay(frames[-1:])
        if on_card:
            torch.cuda.synchronize(eng.device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = device_us = None
    if on_card:
        events = prof.key_averages()
        launches = sum(e.count for e in events
                       if e.key.startswith(("cudaLaunchKernel", "cuLaunchKernel")))
        # device rows only: a host row's device time is its kernels' time
        # over again
        device_us = sum(getattr(e, "self_device_time_total",
                                getattr(e, "self_cuda_time_total", 0))
                        for e in events if e.device_type == DeviceType.CUDA)
    info = {
        "backend": "torch",
        "device": torch.cuda.get_device_name(eng.device) if on_card else "cpu",
        "granularity": cfg.granularity,
        "num_directions": cfg.num_directions,
        "num_x_max": cfg.num_x_max,
        "max_points": cfg.shapes.max_points,
        "max_world_segments": cfg.shapes.max_world_segments,
        "frame": INSPECT_FRAME,
        "nlines": rec["nblines"],
        "wall_ms": wall_ms,
        "kernel_launches": launches,
        "device_us": device_us,
        "vote_state_launches": V.vote_state.launches if on_card else None,
        "vote_histogram_launches": V.vote_histogram.launches if on_card else None,
    }
    print(json.dumps({k: v for k, v in info.items() if v is not None}, indent=2))
    return 0


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


def cmd_baginfo(args) -> int:
    """`rosbag info` analog for --bag inputs: per-topic type/count/time
    span, plus which topics the ingestion would pick (or why it would
    refuse — see io.rosbag.require_single_topic)."""
    from .io import mcap as _mcap
    from .io.rosbag import CLOUD_TYPE, POSE_TYPES, bag_info

    info = bag_info(args.bag)
    topics = info["topics"]
    print(f"{args.bag}: {info['format']}, {len(topics)} topics")
    for topic in sorted(topics):
        d = topics[topic]
        enc = f" [{d['encoding']}]" if d.get("encoding") else ""
        print(f"  {topic}  {d['type']}{enc}  {d['count']} msgs  "
              f"t=[{d['t_min']:.3f}, {d['t_max']:.3f}]")
    cloud_types = set(_mcap.CLOUD_TYPES) | {CLOUD_TYPE}
    pose_types = set(_mcap.POSE_TYPES) | set(POSE_TYPES)
    clouds = sorted(t for t, d in topics.items() if d["type"] in cloud_types)
    poses = sorted(t for t, d in topics.items() if d["type"] in pose_types)
    for kind, flag, names in (("clouds", "--cloud-topic", clouds),
                              ("poses", "--pose-topic", poses)):
        if len(names) == 1:
            print(f"{kind}: {names[0]}")
        elif not names:
            print(f"{kind}: NONE (no matching topic)")
        else:
            print(f"{kind}: AMBIGUOUS — pass {flag} "
                  f"(candidates: {', '.join(names)})")
    return 0


def _add_bag(p, what):
    p.add_argument("--bag", help=what)
    p.add_argument("--cloud-topic", default=None, metavar="TOPIC",
                   help="PointCloud2 topic to read from --bag (required "
                        "when several topics carry clouds, e.g. a "
                        "record-everything capture that also holds the "
                        "node's republished filtered/hough clouds)")
    p.add_argument("--pose-topic", default=None, metavar="TOPIC",
                   help="pose topic (PoseStamped/Odometry) to read from "
                        "--bag when several match")


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
    _add_bag(pr, "replay a recorded ROS1 .bag or ROS2 .mcap "
                 "(sensor_msgs/PointCloud2 + pose topic — the reference's "
                 "rosbag recordings, read without a ROS install; container "
                 "auto-detected)")
    pr.add_argument("--plots", action="store_true")
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
    _add_bag(pc, "convert a recorded ROS1 .bag / ROS2 .mcap into the .pcsl "
                 "log instead of simulating")
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
                    help="marker stream, one record per read-back batch of "
                         "the deferred stream (watch with `pcs-torch viz "
                         "<JSONL> --follow`)")
    ps.add_argument("--viz-every-frame", action="store_true",
                    help="one viz record per processed frame instead of per "
                         "read-back batch (the synchronous per-frame path); "
                         "--viz-points implies it")
    _add_viz_points(ps)
    ps.set_defaults(fn=cmd_stream)

    px = sub.add_parser("serve", help="serve the engine over TCP "
                        "(binary frame stream in, world-map queries out)")
    _add_common(px)
    px.add_argument("--host", default="127.0.0.1")
    px.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral, printed at startup)")
    px.add_argument("--viz-stream", default=None, metavar="JSONL",
                    help="also write the per-frame marker stream; pair with "
                         "`pcs-torch viz <JSONL> --follow` in another terminal "
                         "to watch the served stream live (one record per "
                         "read-back batch; --viz-every-frame for one per frame)")
    px.add_argument("--viz-every-frame", action="store_true",
                    help="see `stream --viz-every-frame`")
    px.set_defaults(fn=cmd_serve)

    pe = sub.add_parser("eval", help="ground-truth accuracy of a segments.csv")
    pe.add_argument("segments_csv")
    pe.add_argument("--scene", default="obs_tests", choices=SCENES)
    pe.add_argument("--wbt", help="ground truth from a Webots world file")
    pe.add_argument("--angle-threshold", type=float, default=0.1)
    pe.add_argument("--distance-threshold", type=float, default=0.5)
    pe.add_argument("--plots", action="store_true")
    pe.set_defaults(fn=cmd_eval)

    pv = sub.add_parser("viz", help="viz-stream JSONL -> interactive HTML player")
    pv.add_argument("stream", help="JSONL file from `run --viz-stream`")
    pv.add_argument("-o", "--out", default=None, help="output .html path")
    pv.add_argument("--follow", action="store_true",
                    help="serve a live player that tails the JSONL while "
                         "another process writes it (RViz-style live view)")
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=0,
                    help="HTTP port for --follow (0 = ephemeral)")
    pv.set_defaults(fn=cmd_viz)

    pi = sub.add_parser("inspect", help="one frame under the profiler: kernel "
                                        "launches, device time, shape facts")
    _add_common(pi)
    pi.add_argument("--scene", default="obs_tests", choices=SCENES,
                    help="simulated world whose default flight gives the frame")
    pi.add_argument("--seed", type=int, default=0)
    pi.set_defaults(fn=cmd_inspect)

    pt = sub.add_parser("timing", help="analyze a processing_time.csv")
    pt.add_argument("processing_time_csv")
    pt.add_argument("--plots", action="store_true")
    pt.set_defaults(fn=cmd_timing)

    pb = sub.add_parser("bag-info", help="per-topic summary of a recorded "
                                         "ROS1 .bag / ROS2 .mcap "
                                         "(`rosbag info` analog)")
    pb.add_argument("bag")
    pb.set_defaults(fn=cmd_baginfo)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
