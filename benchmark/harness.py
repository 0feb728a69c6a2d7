"""One run of one cell: set-up, the measured window, the optional traced
span, the reference check and the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in ``benchmark/configs/<config>.json``, its traffic mix in
``benchmark/traffic/<traffic>.json``, the limits of its reference check in
``benchmark/limits/<cell>.json`` and each per-layer metric's reader in
``benchmark/metrics/<metric>.py``.  The traffic's ``mode`` is one of the
drivers below: ``replay`` (closed loop, one frame in flight, the flight
looped) or ``stream`` (frames offered on an absolute schedule through the
engine's streaming worker).

Only the system under test is the program's: the engine, its streaming
API and its launch counters.  The frames, the timing, the trace reduction,
the roofline counts and the reference are the benchmark's own.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# top-level module names the process may not hold once the window closes
BANNED = ("jax", "jaxlib", "flax", "pointcloud_segmentation_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc), so set-up counts
    the interpreter's start too."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ------------------------------------------------------------------ the cell

class Cell:
    """A cell of BENCHMARK.json with its configuration, traffic and metrics."""

    def __init__(self, name: str, bench: Optional[dict] = None):
        bench = bench if bench is not None else json.loads((ROOT / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        self.name = name
        self.chips = int(w["chips"])
        cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
        self.config = json.loads((ROOT / cfg_entry["file"]).read_text())
        self.traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())

        def ours(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if ours(m)]
        self.per_layer = [m for m in bench["per_layer"] if ours(m)]


def metric_reader(name: str):
    """The `read(ctx)` of benchmark/metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------------ frames

def make_frames(config: dict, seed: int, workers: int = 1, every: int = 1):
    """The configuration's flight, rendered from `seed` (the sensor noise)."""
    from .sim import scene as SC
    from .sim import simulator as S

    fl = config["flight"]
    poses = SC.trajectory_poses(SC.waypoints_from(config["waypoints"]),
                                hz=fl["hz"], velocity=fl["velocity"])
    poses = poses[::every]
    spec = S.TofSpec(**config["sensor"])
    return S.render_flight(SC.scene_from(config["scene"]), poses, spec, seed=seed,
                           workers=workers)


def _counting_voting(launches: list):
    """The program's voting kernels, each launch of the state kernel noted
    as (rows, points, active points): the work of the roofline counts."""
    from pointcloud_segmentation_tpu_torch.ops import voting as V
    from pointcloud_segmentation_tpu_torch.ops.hough import Voting

    def counted(Xs, active, c1, c2, half, dx, num_x, num_x_static):
        launches.append((int(c1.shape[0]), int(Xs.shape[0]), int(active.sum())))
        return V.vote_state(Xs, active, c1, c2, half, dx, num_x, num_x_static)

    return Voting(counted, V.vote_histogram)


def percentile(values, q: float) -> Optional[float]:
    return float(np.percentile(np.asarray(values, np.float64), q)) if len(values) else None


# ------------------------------------------------------------------ a run

class Run:
    """One run of a cell.  `device` is "cuda" in a benchmark run; the tests
    drive the same run on "cpu" at a small size, where `yaml_overrides` and
    `every` shrink it and `fault` may break the timed path."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_start: Optional[float] = None,
                 yaml_overrides: Optional[dict] = None,
                 fault: Optional[Callable] = None, workers: int = 6,
                 every: int = 1):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device = device
        self.t_start = time.perf_counter() if t_start is None else t_start
        # the process's age at t_start: interpreter start-up counts as set-up
        self.age0 = (process_age_s() - (time.perf_counter() - t_start)
                     if t_start is not None else 0.0)
        self.yaml = dict(cell.config["yaml"], **(yaml_overrides or {}))
        self.fault = fault
        self.workers = workers
        self.every = every
        self.traffic = cell.traffic
        self.setup: Dict[str, float] = {}
        self.notes: List[str] = []

    # -- set-up ----------------------------------------------------------

    def _lap(self, key: str, t0: float) -> float:
        t1 = time.perf_counter()
        self.setup[key] = t1 - t0
        return t1

    def build(self) -> None:
        t = time.perf_counter()
        self.frames = make_frames(self.cell.config, self.seed,
                                  self.workers if self.device == "cuda" else 1, self.every)
        self.hz = float(self.cell.config["flight"]["hz"])
        t = self._lap("frames_rendered", t)
        import torch

        from pointcloud_segmentation_tpu_torch import SegmentationEngine, _build
        from pointcloud_segmentation_tpu_torch.config import PipelineConfig

        self.torch = torch
        t = self._lap("import", t)
        if self.device == "cuda":
            _build.load_library()
            torch.cuda.reset_peak_memory_stats()
        t = self._lap("library_load", t)
        self.cfg = PipelineConfig.from_dict(self.yaml)
        tr = self.traffic
        self.viz: List[tuple] = []
        viz = None
        if tr.get("viz"):
            def viz(rec, arrivals=self.viz):
                arrivals.append((time.perf_counter(), rec))
        self.eng = SegmentationEngine(self.cfg, device=self.device, viz_stream=viz,
                                      stream_sync_every=int(tr.get("stream_sync_every", 64)))
        if self.fault is not None:
            self.fault(self.eng)
        t = self._lap("tables_and_world", t)
        if self.trace:
            # the profiler's first start (CUPTI's) is slow: not in the window
            from .trace import Span

            warm = Span(self.device == "cuda")
            warm.start()
            warm.stop()
            t = self._lap("profiler_start", t)
        # warm-up: the first frames of the flight, through the timed call
        self.answers: List[tuple] = []    # (nblines, status, world size)
        self.order: List[int] = []        # flight frame index of each answer
        for k in range(int(tr["warmup_frames"])):
            self._replay_frame(k)
        if self.device == "cuda":
            torch.cuda.synchronize()
        self.k = int(tr["warmup_frames"])
        self._lap("warmup_and_capture", t)

    def _replay_frame(self, k: int) -> float:
        fr = self.frames[k % len(self.frames)]
        t = k / self.hz
        self.eng.push_pose(t, fr.position, fr.quat_wxyz)
        t0 = time.perf_counter()
        rec = self.eng.process_frame(t, fr.points)
        t1 = time.perf_counter()
        if rec is None:
            self.answers.append(None)
        else:
            self.answers.append((rec["nblines"], rec["status"], rec["seg_vec_size"]))
        self.order.append(k % len(self.frames))
        return t1 - t0

    # -- the window ------------------------------------------------------

    def window(self) -> dict:
        mode = self.traffic["mode"]
        if mode == "replay":
            return self._window_replay()
        if mode == "stream":
            return self._window_stream()
        raise ValueError(f"unknown traffic mode {mode!r}")

    def _window_replay(self) -> dict:
        from .trace import Span

        skip, n_span = int(self.traffic["trace_skip_frames"]), int(self.traffic["trace_frames"])
        span = Span(self.device == "cuda") if self.trace else None
        lat = []
        t_first = time.perf_counter()
        self.setup_s = self.age0 + (t_first - self.t_start)
        end = t_first + self.seconds
        t_last = t_first
        j = 0
        self.span_frames: List[int] = []
        while time.perf_counter() < end:
            if span is not None and j == skip:
                span.start()
            lat.append(self._replay_frame(self.k))
            if span is not None and skip <= j < skip + n_span:
                self.span_frames.append(self.k % len(self.frames))
                span.frames += 1
                if j == skip + n_span - 1:
                    span.stop()
            t_last = time.perf_counter()
            self.k += 1
            j += 1
        if span is not None and skip <= j - 1 < skip + n_span - 1:
            span.stop()          # the window closed inside the span
        self.span = span
        window_s = t_last - t_first
        failed = sum(1 for a in self.answers[-j:] if a is None) if j else 0
        return {"attempted": j, "failed": failed, "window_s": window_s,
                "metrics": {"frames_per_s": (j - failed) / window_s if j else None,
                            "frame_ms_p95": percentile([x * 1e3 for x in lat], 95)}}

    def _window_stream(self) -> dict:
        from .trace import Span

        tr = self.traffic
        if not tr.get("viz"):
            raise ValueError("a stream mix needs viz: its records give each frame's "
                             "answer, order and arrival")
        rate = float(tr["rate_hz"])
        eng = self.eng
        n_warm = len(self.answers)
        n_viz_warm = len(self.viz)
        n_rec_warm = len(eng.records)
        eng.start()
        offered = int(self.seconds * rate)
        due: List[float] = []
        late: List[float] = []
        k0 = self.k
        t0 = time.perf_counter() + 0.05
        self.setup_s = self.age0 + (t0 - self.t_start)

        def feed():
            for j in range(offered):
                d = t0 + j / rate
                now = time.perf_counter()
                if d > now:
                    time.sleep(d - now)
                k = k0 + j
                fr = self.frames[k % len(self.frames)]
                t = k / self.hz
                eng.push_pose(t, fr.position, fr.quat_wxyz)
                eng.submit_cloud(t, fr.points)
                due.append(d)
                late.append(time.perf_counter() - d)

        feeder = threading.Thread(target=feed, name="bench-feeder")
        feeder.start()
        span = None
        span_at = float("inf")      # frames due from here on wait for the profiler
        if self.trace:
            span = Span(self.device == "cuda")
            start_at = span_at = t0 + float(tr["trace_start_s"])
            time.sleep(max(0.0, start_at - time.perf_counter()))
            n0 = len(eng.records)
            span.start()
            time.sleep(float(tr["trace_span_s"]))
            span.stop()
            span.frames = len(eng.records) - n0
        self.span = span
        feeder.join()
        drained = eng.drain(timeout=60.0)
        if self.device == "cuda":
            self.torch.cuda.synchronize()
        t_done = time.perf_counter()
        eng.stop()
        self.k = k0 + offered
        self.notes.append(
            f"feeder: {offered} frames at {rate} Hz, lateness p50 "
            f"{percentile(late, 50) * 1e3:.3f} ms max {max(late) * 1e3:.3f} ms; drained {drained}; "
            f"dropped {eng.dropped_frames} skipped {eng.frames_skipped_no_pose} "
            f"failed {eng.frames_failed}")
        # which frames the worker processed, in order, and their answers:
        # each viz record carries its frame's stamp
        vizs = self.viz[n_viz_warm:]
        taken = [round(r["t"] * self.hz) for _, r in vizs]
        got = [(r["nlines"], r["status"], r["world_count"]) for _, r in vizs]
        arrival = dict(zip(taken, (a for a, _ in vizs)))
        recs = eng.records[n_rec_warm:]
        self.answers = self.answers[:n_warm] + got
        self.order = self.order[:n_warm] + [k % len(self.frames) for k in taken]
        if len(recs) != len(got):
            self.notes.append(f"records {len(recs)} != viz records {len(got)}")
        # every frame offered: from its due time to its record reaching the
        # viewer; one that never arrived waits until the run ended
        proc = {k: r["processing_time"] / 1e3 for k, r in zip(taken, recs)}
        # the per-layer host readings: the frames due before the traced span,
        # whose start and stop stall the process
        stream_ms, wait_ms = [], []
        for j, d in enumerate(due):
            k = k0 + j
            a = arrival.get(k)
            ms = ((a if a is not None else t_done) - d) * 1e3
            stream_ms.append(ms)
            if a is not None and k in proc and d < span_at:
                wait_ms.append(ms - proc[k])
        failed = offered - len(arrival)
        self.stream_ctx = {"wait_ms": wait_ms}
        return {"attempted": offered, "failed": failed, "window_s": t_done - t0,
                "metrics": {"stream_ms_p95": percentile(stream_ms, 95)}}

    # -- after the window --------------------------------------------------

    def roofline_launches(self):
        """(launches, trace) of an eager pass over the span's frames: each
        voting launch's shape through a counting wrapper, and the kernels'
        device time under the profiler.  The captured frame runs the same
        launches, frame for frame; the eager pass launches each kernel on
        its own, where the profiler's count of a kernel's launches equals
        the wrapper's (inside the graph's conditional nodes it reads more
        launches than ran: PERF.md)."""
        if self.device != "cuda" or not getattr(self, "span_frames", None):
            return None, None
        from pointcloud_segmentation_tpu_torch import SegmentationEngine

        from .metrics._common import STATE, kernel_seconds
        from .trace import Span

        # a pass whose trace lost records of the kernel (the counts differ)
        # is made once more, from a fresh engine
        for _ in range(2):
            launches: list = []
            eng = SegmentationEngine(self.cfg, device=self.device, loop="eager",
                                     voting=_counting_voting(launches))
            fr = self.frames[self.span_frames[0]]
            eng.push_pose(0.0, fr.position, fr.quat_wxyz)
            eng.process_frame(0.0, fr.points)          # warm-up, not counted
            launches.clear()
            span = Span(cuda=True, host_ops=True)
            span.start()
            for i, idx in enumerate(self.span_frames, start=1):
                fr = self.frames[idx]
                eng.push_pose(float(i), fr.position, fr.quat_wxyz)
                eng.process_frame(float(i), fr.points)
                span.frames += 1
            span.stop()
            del eng
            trace = span.summary()
            if trace is not None and kernel_seconds(trace, STATE)[1] == len(launches):
                break
            self.notes.append(f"roofline: the eager pass's trace holds "
                              f"{kernel_seconds(trace, STATE)[1] if trace else 0} state-kernel "
                              f"launches of {len(launches)}")
        return launches, trace

    def program_answers(self) -> dict:
        segs, inter = self.eng.world_snapshot()
        return {"per_frame": self.answers, "segments": segs,
                "pairs": [(i, j) for i, _, j, _ in inter]}

    def reference(self, precision: str = "float64") -> dict:
        from .reference.compare import run_reference

        frames = [(self.frames[i].points, self.frames[i].position, self.frames[i].quat_wxyz)
                  for i in self.order]
        return run_reference(self.yaml, frames, self.device, precision, keys=self.order)


# ------------------------------------------------------------------ main

def execute(run: Run) -> dict:
    """Set-up, window, trace readers and the reference check: the result
    line's fields, and the check lines."""
    from .reference import compare

    run.build()
    win = run.window()
    torch = run.torch
    peak = torch.cuda.max_memory_allocated() if run.device == "cuda" else 0
    if run.device == "cuda":
        run.notes.append("card after the window: " + _card_state()
                         + "; host load average %.2f %.2f %.2f" % os.getloadavg())
    result: dict = {"attempted": win["attempted"], "failed": win["failed"]}
    metrics: Dict[str, dict] = {}
    units = {m["name"]: m["unit"] for m in run.cell.end_to_end + run.cell.per_layer}
    summary = None
    if run.trace:
        summary = run.span.summary() if run.span is not None else None
        launches, eager = (run.roofline_launches() if run.traffic["mode"] == "replay"
                           else (None, None))
        if launches is not None:
            from .metrics._common import STATE, kernel_seconds

            line = f"roofline: vote_state counted {len(launches)} launches"
            for where, t in (("traced span", summary), ("eager pass", eager)):
                if t is not None:
                    sec, n = kernel_seconds(t, STATE)
                    line += f"; {where} {n} launches, {sec * 1e3:.4f} ms"
            run.notes.append(line)
        ctx = {"trace": summary, "launches": launches, "eager_trace": eager,
               "stream": getattr(run, "stream_ctx", None), "window": win}
        for m in run.cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    else:
        for m in run.cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": run.setup_s, "unit": "s"}
            elif win["metrics"].get(m["name"]) is not None:
                metrics[m["name"]] = {"value": win["metrics"][m["name"]], "unit": m["unit"]}
    program = run.program_answers()
    n_frames = len(program["per_frame"])
    run.eng = None
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # a frame the engine skipped (no pose) has no answer: it differs
    program["per_frame"] = [(-1, -1, -1) if a is None else a for a in program["per_frame"]]
    detail: list = []
    numbers = compare.compare(program, run.reference(), detail)
    run.notes.extend("differs: " + d for d in detail[:20])
    ref_s = time.perf_counter() - t0
    limits = compare.load_limits(run.cell.name)
    correct = compare.judge(numbers, limits)
    result.update(correct=correct, metrics=metrics)
    device = {"platform": "gpu" if run.device == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(0) if run.device == "cuda" else "cpu",
              "count": run.cell.chips, "memory_peak_bytes": int(peak)}
    if run.trace:
        device["busy_s"] = summary.busy_s if summary else 0.0
        device["window_s"] = summary.window_s if summary else 0.0
    result["device"] = device
    if run.trace and summary is not None:
        run.notes.append(f"trace span: {summary.frames} frames, device busy "
                         f"{summary.busy_s:.6f} s of {summary.window_s:.6f} s")
        top = sorted(summary.kernels.items(), key=lambda kv: -kv[1][0])[:10]
        result["breakdown"] = {"device_ops": [[n, s] for n, (s, _) in top],
                               "idle_gaps": [[n, s] for n, s in summary.gaps]}
    result["checks"] = {k: {"value": numbers[k], "limit": v} for k, v in limits.items()}
    run.notes.append("setup: " + " ".join(f"{k} {v:.3f} s" for k, v in run.setup.items())
                     + f"; total {run.setup_s:.3f} s")
    run.notes.append(f"window: {win['attempted']} attempted, {win['failed']} failed, "
                     f"{win['window_s']:.3f} s; memory: max_memory_allocated {peak}")
    run.notes.append(f"reference: {n_frames} frames in {ref_s:.1f} s")
    result["_check_lines"] = compare.check_lines(numbers, limits)
    return result


def _card_state() -> str:
    """The card's clocks, power and throttle reasons, read by nvidia-smi."""
    import subprocess

    q = "name,power.limit,clocks.sm,clocks.mem,power.draw,temperature.gpu,clocks_throttle_reasons.active"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


def main(argv: List[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    run = Run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    result = execute(run)
    found = banned_modules()
    if found:
        log(f"modules that must not be loaded: {found}")
        return 3
    lines = result.pop("_check_lines")
    for note in run.notes:
        log(note)
    print(json.dumps(result), flush=True)
    for line in lines:
        log(line)
    return 0
