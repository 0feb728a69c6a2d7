"""A benchmark cell run with the port's tracer on: the captured frame's
device time by stage, its live Hough rounds, the card's idle gaps between
frames named by the host span that covers them, and the readers of
``benchmark/metrics/`` that take the program's trace.

    python tools/trace_bench_torch.py --workload tests_g6.replay --seed N
        [--seconds 20] [--profile 0|1] [--tracer 0|1] [--check 0|1]
        [--write PATH]

It drives ``benchmark/harness.py``'s `Run` as a ``--trace 1`` run would with
the tracer wired in: the tracer on before the engine is built (so the
captured graph holds its stamps) and exported right after the window.
``--profile 1`` also runs the profiler's span, whose frames the readers
skip; ``--tracer 0`` runs the same window untraced (the base of the
tracer's cost); ``--check 1`` runs the reference check afterwards;
``--write`` writes the trace (Chrome trace-event JSON, which Perfetto
opens).  Needs a CUDA card.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import statistics
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

READERS = ("step.device_ms.replay", "hough.round_ms.replay", "engine.host_ms.replay",
           "device.idle_share.replay", "runtime.mailbox_ms_p95.stream",
           "engine.viz_ms_p95.stream")


def _kind(stage: str) -> str:
    return re.sub(r"round\[\d+\]", "round[r]", stage)


def stage_split(frames: list) -> dict:
    """Mean device ms a frame between each pair of consecutive stamps (the
    rounds taken together), which sums to the frame's device time."""
    sums: dict = {}
    for f in frames:
        order = sorted(f["device_ns"].items(), key=lambda kv: kv[1])
        for (a, ta), (b, tb) in zip(order, order[1:]):
            key = f"{_kind(a)} -> {_kind(b)}"
            sums[key] = sums.get(key, 0) + (tb - ta)
    return {k: v / len(frames) / 1e6 for k, v in sums.items()} if frames else {}


def named_gaps(prog: dict, frames: list) -> dict:
    """The host-clock gaps from one frame's ``frame.end`` to the next
    replay's ``frame.begin``, each instant put down to the innermost (the
    shortest) host span that covers it, or to the caller where none does:
    ms a gap, by name."""
    from benchmark.metrics._program import host_spans

    names = {e["name"] for e in prog["trace"]["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "host"}
    spans = [(s, e, n) for n in names for s, e, *_ in host_spans(prog, n)]
    totals: dict = {}
    n_gaps = 0
    for f, g in zip(frames, frames[1:]):
        if (g["ring"], g["replay"]) != (f["ring"], f["replay"] + 1):
            continue
        g0, g1 = f["stamps"]["frame.end"], g["stamps"]["frame.begin"]
        if g1 <= g0:
            continue
        n_gaps += 1
        cover = [(s, e, n) for s, e, n in spans if s < g1 and e > g0]
        cuts = sorted({g0, g1} | {max(g0, min(g1, x)) for s, e, _ in cover for x in (s, e)})
        for a, b in zip(cuts, cuts[1:]):
            inside = [(e - s, n) for s, e, n in cover if s <= a and e >= b]
            name = min(inside)[1] if inside else "caller (no span)"
            totals[name] = totals.get(name, 0) + (b - a)
    return {"gaps": n_gaps,
            "ms_a_gap": {k: v / n_gaps / 1e6 for k, v in
                         sorted(totals.items(), key=lambda kv: -kv[1])} if n_gaps else {}}


def breakdown(prog: dict) -> dict:
    from benchmark.metrics._program import device_frames, host_spans, read_frames

    frames = device_frames(prog)
    out: dict = {"device_frames": len(frames)}
    if frames:
        ms = [(f["device_ns"]["frame.end"] - f["device_ns"]["frame.begin"]) / 1e6 for f in frames]
        live = [f["live_rounds"] for f in frames]
        step = 0
        for f in frames:
            ts = list(f["device_ns"].values())
            step = math.gcd(step, *(t - ts[0] for t in ts))
        out.update(frame_device_ms={"median": statistics.median(ms), "min": min(ms),
                                    "max": max(ms)},
                   live_rounds={"mean": statistics.mean(live), "min": min(live),
                                "max": max(live)},
                   stage_ms=stage_split(frames),
                   globaltimer_step_ns=step,
                   idle=named_gaps(prog, frames))
        # the card's two speeds: frames either side of the middle of the range
        if max(ms) - min(ms) > 1.0:
            mid = (max(ms) + min(ms)) / 2
            out["by_mode"] = {
                mode: {"frames": len(sel), "stage_ms": stage_split(sel)}
                for mode, sel in (("fast", [f for f, m in zip(frames, ms) if m < mid]),
                                  ("slow", [f for f, m in zip(frames, ms) if m >= mid]))}
    read = read_frames(prog)
    span = prog.get("span_ns")
    phases = {"all": {f[2] for f in read}}
    if span is not None:
        phases["before_span"] = {f[2] for f in read if f[0] < span[0]}
        phases["after_span"] = {f[2] for f in read if f[0] > span[1]}
    for phase, frames_in in phases.items():
        for name in ("engine.frame", "engine.pad", "step.launch", "engine.read", "engine.viz",
                     "runtime.mailbox", "runtime.step"):
            d = [(e - s) / 1e6 for s, e, frame, _, _ in host_spans(prog, name)
                 if not frames_in or frame in frames_in]
            if d:
                out.setdefault("host_ms_median", {}).setdefault(phase, {})[name] = \
                    statistics.median(d)
    out["clock"] = prog["trace"]["clock"]
    out["counters"] = prog["trace"]["counters"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tools/trace_bench_torch.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=0)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--check", type=int, choices=(0, 1), default=0)
    ap.add_argument("--write", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import Cell, Run, _card_state, metric_reader
    from pointcloud_segmentation_tpu_torch import trace

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    run = Run(cell, args.seed, args.seconds, bool(args.profile), "cuda", T_START)
    if args.tracer:
        trace.enable()
    run.build()
    w0 = time.perf_counter_ns()
    win = run.window()
    w1 = time.perf_counter_ns()
    out = {"workload": args.workload, "seed": args.seed, "tracer": args.tracer,
           "profile": args.profile, "attempted": win["attempted"], "failed": win["failed"],
           "window_s": win["window_s"], "metrics": win["metrics"], "setup_s": run.setup_s}
    if args.tracer:
        tr = trace.export()
        trace.disable()
        span = run.span
        span_ns = ((int(span._t0 * 1e9), int(span._t1 * 1e9))
                   if span is not None and span._prof is not None else None)
        prog = {"trace": tr, "span_ns": span_ns, "window_ns": (w0, w1)}
        out["readers"] = {name: metric_reader(name)({"program": prog}) for name in READERS}
        out["frames_read"] = prog.get("frames_read", {})
        out.update(breakdown(prog))
        if args.write:
            with open(args.write, "w") as f:
                json.dump(tr, f)
    out["card"] = _card_state()
    if args.check:
        from benchmark.reference import compare

        program = run.program_answers()
        program["per_frame"] = [(-1, -1, -1) if a is None else a for a in program["per_frame"]]
        run.eng = None
        gc.collect()
        torch.cuda.empty_cache()
        numbers = compare.compare(program, run.reference(), [])
        limits = compare.load_limits(cell.name)
        out["correct"] = compare.judge(numbers, limits)
        out["checks"] = {k: [numbers[k], v] for k, v in limits.items()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
