"""The port's tracer (trace.py): off, it records nothing and the frame is
unchanged; on, the CPU step's stages stamp in order, the engine's spans nest,
the live rounds are the loop's, a span maps onto the profiler's clock, and
the benchmark's readers of the program's trace read what they say.  The
tests marked ``cuda`` hold the captured frame's device stamps against CUDA
events and the device launch counters on the card.

Imports only torch, numpy and the port (and the benchmark's readers):
    python -m pytest tests/test_torch_trace.py -q
"""

import json
import math
import statistics
import time

import numpy as np
import pytest
import torch

from benchmark.harness import metric_reader
from pointcloud_segmentation_tpu_torch import SegmentationEngine, trace
from pointcloud_segmentation_tpu_torch.config import StaticShapes, default_config
from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy
from pointcloud_segmentation_tpu_torch.io.scene import (OBS_TESTS_SCENE, WP_TESTS,
                                                        trajectory_poses)
from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec, simulate_trajectory
from pointcloud_segmentation_tpu_torch.ops import hough as H
from pointcloud_segmentation_tpu_torch.ops import voting as V

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    yield
    trace.disable()


def small_cfg(granularity=2, **kw):
    return default_config(granularity=granularity, shapes=StaticShapes(
        max_raw_points=1024, max_points=512, max_world_segments=32), **kw)


def small_frames(n, width=32):
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:n]
    return simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(width=width, height=width,
                                                               noise_frac=0.001), seed=7)


def run(eng, frames):
    recs = []
    for fr in frames:
        eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
        recs.append(eng.process_frame(fr.t, fr.points))
    return recs


def host_events(tr):
    return [e for e in tr["traceEvents"] if e["ph"] == "X" and e["cat"] == "host"]


def test_off_the_span_is_the_shared_noop_and_frames_leave_the_tracer_empty():
    assert not trace.enabled()
    assert trace.span("engine.frame") is trace.NOOP is trace.span("x", 1.0)
    assert trace.begin("engine.frame") == -1
    assert trace.stamp("frame.begin") is None and trace.count("n") is None
    eng = SegmentationEngine(small_cfg(), device="cpu", loop="cond")
    run(eng, small_frames(2))
    assert eng._step._host_ring is None
    out = trace.export()
    assert out["traceEvents"] == [] and out["frames"] == [] and out["counters"] == {}


def stage_order(live):
    names = ["frame.begin", "preproc.begin", "preproc.sorted", "preproc.end",
             "hough.init.end"]
    for r in range(live):
        names += [f"round[{r}].begin", f"round[{r}].gates.end", f"round[{r}].vote.begin",
                  f"round[{r}].end"]
    return names + ["segments.end", "world.end", "frame.end"]


def test_on_a_cpu_frame_stamps_its_stages_in_order_and_the_engine_spans_nest():
    frames = small_frames(3)
    trace.enable()
    eng = SegmentationEngine(small_cfg(), device="cpu", loop="cond")
    run(eng, frames)
    out = trace.export()
    assert [f["t"] for f in out["frames"]] == [fr.t for fr in frames]
    for f in out["frames"]:
        order = [k for k, _ in sorted(f["stamps"].items(), key=lambda kv: kv[1])]
        assert f["live_rounds"] > 0 and order == stage_order(f["live_rounds"])
        assert "device_ns" not in f and f["device"] == "host clock"
    ev = host_events(out)
    frames_ev = {e["args"]["id"]: e for e in ev if e["name"] == "engine.frame"}
    assert len(frames_ev) == len(frames)
    for name in ("engine.pad", "step.launch", "engine.read"):
        kids = [e for e in ev if e["name"] == name]
        assert len(kids) == len(frames)
        for e in kids:
            p = frames_ev[e["args"]["parent"]]
            assert p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
            assert e["args"]["frame"] == p["args"]["frame"]
    # each frame's stamps lie inside its step.launch
    launches = sorted((e["ts"], e["ts"] + e["dur"]) for e in ev if e["name"] == "step.launch")
    origin = out["clock"]["origin_ns"]
    for f, (a, b) in zip(out["frames"], launches):
        assert a <= (f["stamps"]["frame.begin"] - origin) / 1e3
        assert (f["stamps"]["frame.end"] - origin) / 1e3 <= b
    dev = [e for e in out["traceEvents"] if e["ph"] == "X" and e["cat"] == "device"]
    assert {e["name"] for e in dev} >= {"frame", "preproc", "hough.init", "round[0]",
                                        "round[0].gates", "segments", "world"}
    assert out["counters"]["hough.live_rounds"] == sum(f["live_rounds"] for f in out["frames"])


@pytest.mark.parametrize("opt_nlines", [0, 3])
def test_live_rounds_are_the_rounds_the_eager_loop_runs(opt_nlines, monkeypatch):
    """The step's stamped rounds against an independent count of the rounds
    the same frames ran: every round refines its line twice
    (`_line_distance2` of the plain gates, ops/gates.py, which a CPU tensor
    takes)."""
    from pointcloud_segmentation_tpu_torch.ops import gates as G

    frames = small_frames(4)
    cfg = small_cfg(opt_nlines=opt_nlines)
    calls = []
    real = G._line_distance2
    monkeypatch.setattr(G, "_line_distance2", lambda *a: calls.append(1) or real(*a))
    trace.enable()
    eng = SegmentationEngine(cfg, device="cpu", loop="cond")
    rounds = []
    for fr in frames:
        n = len(calls)
        run(eng, [fr])
        rounds.append((len(calls) - n) // 2)
    out = trace.export()
    assert [f["live_rounds"] for f in out["frames"]] == rounds
    assert max(rounds) > 0
    if opt_nlines:
        assert max(rounds) <= opt_nlines


class CountedVoting:
    """The plain voting functions, which the kernels' wrappers call on CPU
    tensors, each call recorded: ("state", whole table or not), ("hist",
    rows handed), ("dec", rows handed)."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.table = None
        state = V.vote_state_plain

        def counted_state(Xs, active, c1, *a):
            if self.table is None:
                self.table = c1.data_ptr()   # the first call: the initial state
            self.calls.append(("state", c1.data_ptr() == self.table))
            return state(Xs, active, c1, *a)

        def counted(name, fn):
            return lambda Xs, *a: self.calls.append((name, Xs.shape[0])) or fn(Xs, *a)

        monkeypatch.setattr(V, "vote_state_plain", counted_state)
        monkeypatch.setattr(V, "vote_histogram_plain", counted("hist", V.vote_histogram_plain))
        monkeypatch.setattr(V, "vote_decrement_plain", counted("dec", V.vote_decrement_plain))

    def branches(self, cfg, n_points):
        """(increment rounds, rebuild rounds) of the calls since the last
        `clear`: a carry frame votes a histogram of every point at its init
        and at each rebuild, and one of `_SUB_CHUNK` compacted columns a
        subtract; a lazy frame decrements once an increment, and votes the
        whole table at its init and at each rebuild."""
        if cfg.voting_mode == "carry":
            rows = [n for name, n in self.calls if name == "hist"]
            inc = rows.count(min(H._SUB_CHUNK, n_points))
            return inc, rows.count(n_points) - 1
        inc = sum(1 for name, _ in self.calls if name == "dec")
        return inc, sum(1 for name, whole in self.calls if name == "state" and whole) - 1

    def clear(self):
        self.calls.clear()
        self.table = None


@pytest.mark.parametrize("voting", ["carry", "lazy"])
def test_the_update_tallies_are_the_branches_the_eager_loop_read(voting, monkeypatch):
    """A traced CPU replay's per-frame tallies of increment and rebuild rounds
    equal the branches counted from the voting calls the same frames made,
    their sums are the exported counters and the live rounds less each
    frame's last, and every live round stamps one ``round[r].vote.begin``.
    A 48-column update makes a round that removes more points rebuild, so
    both branches run."""
    monkeypatch.setattr(H, "_SUB_CHUNK", 48)
    frames = small_frames(4)
    cfg = small_cfg(voting=voting)
    assert cfg.voting_mode == voting
    counted = CountedVoting(monkeypatch)
    trace.enable()
    eng = SegmentationEngine(cfg, device="cpu", loop="cond")
    want = []
    for fr in frames:
        counted.clear()
        run(eng, [fr])
        want.append(counted.branches(cfg, cfg.shapes.max_points))
    assert sum(i for i, _ in want) > 0 and sum(r for _, r in want) > 0
    out = trace.export()
    got = [(f["tallies"]["hough.increment_rounds"], f["tallies"]["hough.rebuild_rounds"])
           for f in out["frames"]]
    assert got == want
    c = out["counters"]
    assert c["hough.increment_rounds"] == sum(i for i, _ in want)
    assert c["hough.rebuild_rounds"] == sum(r for _, r in want)
    for f, (i, r) in zip(out["frames"], want):
        assert i + r == f["live_rounds"] - 1
        votes = [k for k in f["stamps"] if k.endswith("].vote.begin")]
        assert len(votes) == f["live_rounds"]
    # no lazy re-exam overflows at g2, whose whole table is the suspect cap:
    # that tally is exported as 0 and has no per-frame event
    assert c["hough.suspect_overflow_rounds"] == 0
    assert {e["name"] for e in out["traceEvents"] if e["ph"] == "C"} == {
        "hough.live_rounds", *H.TALLIES[:2]}


def test_the_overflow_tally_is_the_re_exams_that_overflowed(monkeypatch):
    """Lazy voting at g4 with a suspect cap of one tile (128 of 1,408
    directions): each frame's ``hough.suspect_overflow_rounds`` is the number
    of its re-exams that returned the overflow, some frame has one, and
    every overflow rebuilt the table (one more whole-table vote_state call
    than the frame's rebuild rounds and its init)."""
    monkeypatch.setattr(H, "_SUSPECT_CAP", 128)
    frames = small_frames(3)
    cfg = small_cfg(granularity=4, voting="lazy")
    counted = CountedVoting(monkeypatch)
    overs = []
    reexam = V.vote_reexam_plain

    def recorded(*a):
        over = reexam(*a)
        overs.append(bool(over))
        return over

    monkeypatch.setattr(V, "vote_reexam_plain", recorded)
    trace.enable()
    eng = SegmentationEngine(cfg, device="cpu", loop="cond")
    want = []
    for fr in frames:
        counted.clear()
        overs.clear()
        run(eng, [fr])
        inc, whole = counted.branches(cfg, cfg.shapes.max_points)
        assert len(overs) == inc
        want.append((sum(overs), whole))
    out = trace.export()
    got = [f["tallies"].get("hough.suspect_overflow_rounds", 0) for f in out["frames"]]
    assert got == [n for n, _ in want] and sum(got) > 0
    rebuilds = [f["tallies"].get("hough.rebuild_rounds", 0) for f in out["frames"]]
    assert [w for _, w in want] == [n + r for n, r in zip(got, rebuilds)]
    assert out["counters"]["hough.suspect_overflow_rounds"] == sum(got)


def test_a_frame_with_no_update_exports_its_tallies_as_zero():
    """Tallies no round made are exported as 0 (one live round a frame: the
    last round takes no update)."""
    trace.enable()
    run(SegmentationEngine(small_cfg(opt_nlines=1), device="cpu", loop="cond"),
        small_frames(2))
    out = trace.export()
    assert [f["live_rounds"] for f in out["frames"]] == [1, 1]
    assert all(f["tallies"] == {} for f in out["frames"])
    assert out["counters"]["hough.increment_rounds"] == 0
    assert out["counters"]["hough.rebuild_rounds"] == 0


def test_answers_records_and_world_are_the_same_with_tracing_on_and_off():
    frames = small_frames(4)
    cfg = small_cfg()
    off = SegmentationEngine(cfg, device="cpu", loop="cond")
    a = run(off, frames)
    trace.enable()
    on = SegmentationEngine(cfg, device="cpu", loop="cond")
    b = run(on, frames)
    assert len(trace.export()["frames"]) == len(frames)
    keys = ("seg_vec_size", "nblines", "status", "t")
    assert [tuple(r[k] for k in keys) for r in a] == [tuple(r[k] for k in keys) for r in b]
    wa, wb = world_state_to_numpy(off.state), world_state_to_numpy(on.state)
    assert all(np.array_equal(wa[k], wb[k], equal_nan=True) for k in wa)
    assert off.world_snapshot()[1] == on.world_snapshot()[1]


def test_a_span_maps_onto_the_profilers_clock():
    """torch.profiler stamps its events on the Unix clock: the export's
    (perf_counter_ns, time_ns) pair puts a span around the profiler's record
    of the work inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("probe.outer"):
            time.sleep(0.002)
            with record_function("probe.inner"):
                torch.ones(64).sum()
            time.sleep(0.002)
    out = trace.export()
    (ev,) = [e for e in host_events(out) if e["name"] == "probe.outer"]
    perf, unix = out["clock"]["unix"][0]
    origin = out["clock"]["origin_ns"]
    start = origin + ev["ts"] * 1e3 - perf + unix
    stop = start + ev["dur"] * 1e3
    (inner,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe.inner"]
    assert start < inner.start_ns() and inner.start_ns() + inner.duration_ns() < stop


def test_spans_from_two_threads_keep_their_own_parents():
    import threading

    trace.enable()
    barrier = threading.Barrier(2)

    def work(k):
        with trace.span("outer", float(k)):
            barrier.wait(timeout=10)
            with trace.span("inner"):
                barrier.wait(timeout=10)

    th = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in th:
        t.start()
    for t in th:
        t.join(timeout=10)
        assert not t.is_alive()
    ev = host_events(trace.export())
    outer = {e["args"]["id"]: e for e in ev if e["name"] == "outer"}
    for e in ev:
        if e["name"] == "inner":
            p = outer[e["args"]["parent"]]
            assert p["tid"] == e["tid"] and p["args"]["frame"] == e["args"]["frame"]


def test_a_mailbox_span_runs_from_submit_to_take():
    trace.enable()
    trace.mark("runtime.mailbox", 2.5)
    trace.mark("runtime.mailbox", 3.0)          # dropped: never taken
    trace.marked("runtime.mailbox", 1.0, time.perf_counter_ns())   # never marked
    trace.marked("runtime.mailbox", 2.5, time.perf_counter_ns())
    (e,) = [e for e in host_events(trace.export()) if e["name"] == "runtime.mailbox"]
    assert e["args"]["frame"] == 2.5 and e["args"]["parent"] == -1 and e["dur"] >= 0


def test_full_span_buffers_count_what_they_drop(monkeypatch):
    monkeypatch.setattr(trace, "SPAN_CAPACITY", 3)
    trace.enable()
    for _ in range(5):
        with trace.span("s"):
            pass
    out = trace.export()
    assert len(host_events(out)) == 3 and out["counters"]["trace.spans_dropped"] == 2


def test_a_stream_records_its_mailbox_step_and_viz_spans():
    frames = small_frames(4)
    trace.enable()
    got = []
    eng = SegmentationEngine(small_cfg(), device="cpu", loop="cond",
                             viz_stream=got.append, stream_sync_every=1)
    eng.start()
    try:
        for fr in frames:
            eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
            eng.submit_cloud(fr.t, fr.points)
            assert eng.drain(timeout=60.0)
    finally:
        eng.stop()
    out = trace.export()
    ev = host_events(out)
    steps = {e["args"]["id"]: e for e in ev if e["name"] == "runtime.step"}
    by_name = {n: [e for e in ev if e["name"] == n]
               for n in ("runtime.mailbox", "engine.frame", "engine.viz")}
    assert all(len(v) == len(got) == len(frames) for v in by_name.values())
    for e in by_name["engine.frame"] + by_name["engine.viz"]:
        assert steps[e["args"]["parent"]]["args"]["frame"] == e["args"]["frame"]
    assert out["counters"]["runtime.submitted"] >= len(frames)
    assert out["counters"]["runtime.dropped"] >= 0


def test_inspect_prints_the_frames_stages_and_live_rounds(capsys):
    """`inspect` turns the tracer on: the CPU step's stages on the host clock
    beside the profiler's figures (none on the CPU), and off again after."""
    from pointcloud_segmentation_tpu_torch import cli

    assert cli.main(["inspect", "--granularity", "2", "--device", "cpu", "--loop", "cond"]) == 0
    info = json.loads(capsys.readouterr().out)
    stages = info["host_stage_ms"]
    assert info["live_rounds"] >= 1 and "device_stage_ms" not in info
    assert {"preproc", "hough.init", "round[0]", "segments", "world", "frame"} <= stages.keys()
    assert stages["frame"] <= info["wall_ms"]
    assert not trace.enabled()


# ------------------------------------------------------------------ readers

READERS = ["step.device_ms.replay", "hough.round_ms.replay", "engine.host_ms.replay",
           "device.idle_share.replay", "runtime.mailbox_ms_p95.stream",
           "engine.viz_ms_p95.stream"]
ORIGIN = 10**12
MS = 10**6


def synthetic_program():
    """20 replayed frames 10 ms apart on both clocks: frame k's device time
    8 + 0.1 k ms with two live rounds of 1 and 2 ms, its engine.frame 9 ms
    with a 7 ms read; 20 streamed frames 33 ms apart, frame k in the mailbox
    0.1 (k + 1) ms and its viz record 1 (k + 1) ms.  The profiler's span
    covers the starts of frames 3 and 4."""
    events, frames = [], []
    sid = 0

    def host(name, start, dur, frame, parent=-1):
        nonlocal sid
        sid += 1
        events.append({"ph": "X", "cat": "host", "name": name, "pid": 1, "tid": 1,
                       "ts": (start - ORIGIN) / 1e3, "dur": dur / 1e3,
                       "args": {"id": sid, "parent": parent, "frame": frame}})
        return sid

    for k in range(20):
        t, begin = k / 30, ORIGIN + 10 * MS * k
        dev = {"frame.begin": begin, "round[0].begin": begin + 1 * MS,
               "round[0].end": begin + 2 * MS, "round[1].begin": begin + 2 * MS,
               "round[1].end": begin + 4 * MS, "frame.end": begin + 8 * MS + k * MS // 10}
        frames.append({"ring": 1, "device": "cuda:0", "seq": k, "t": t, "replay": k,
                       "live_rounds": 2, "stamps": dict(dev), "device_ns": dev})
        i = host("engine.frame", begin, 9 * MS, t)
        host("engine.read", begin + MS, 7 * MS, t, i)
    for k in range(20):
        t, put = 100 + k / 30, ORIGIN + 10**9 + 33 * MS * k
        host("runtime.mailbox", put, MS * (k + 1) // 10, t)
        host("engine.viz", put + 5 * MS, MS * (k + 1), t)
    tr = {"traceEvents": events, "clock": {"origin_ns": ORIGIN}, "frames": frames,
          "counters": {}}
    return {"trace": tr, "span_ns": (ORIGIN + 25 * MS, ORIGIN + 45 * MS),
            "window_ns": None}


def test_the_program_readers_read_a_synthetic_trace():
    p = synthetic_program()
    got = {name: metric_reader(name)({"program": p}) for name in READERS}
    read = [k for k in range(20) if k not in range(3, 10)]    # span + the 5 after
    dev_ms = [8 + 0.1 * k for k in read]
    assert got["step.device_ms.replay"] == pytest.approx(statistics.median(dev_ms))
    assert got["hough.round_ms.replay"] == pytest.approx(1.5)
    assert got["engine.host_ms.replay"] == pytest.approx(2.0)
    run = range(10, 20)                                       # the longest consecutive run
    busy = sum(8 + 0.1 * k for k in run)
    span = (19 * 10 + 8 + 1.9) - 10 * 10
    assert got["device.idle_share.replay"] == pytest.approx(100 * (1 - busy / span))
    # every streamed frame entered the mailbox after the replay's span
    assert got["runtime.mailbox_ms_p95.stream"] is None
    assert got["engine.viz_ms_p95.stream"] is None
    p["span_ns"] = (ORIGIN + 10**9 + 33 * MS * 10, ORIGIN + 10**9 + 33 * MS * 12)
    stream = {name: metric_reader(name)({"program": p}) for name in READERS[4:]}
    assert stream["runtime.mailbox_ms_p95.stream"] == pytest.approx(
        float(np.percentile([0.1 * (k + 1) for k in range(10)], 95)))
    assert stream["engine.viz_ms_p95.stream"] == pytest.approx(
        float(np.percentile([1.0 * (k + 1) for k in range(10)], 95)))
    assert p["frames_read"]["step.device_ms.replay"] == len(read)
    assert p["frames_read"]["device.idle_share.replay"] == 10
    assert p["frames_read"]["runtime.mailbox_ms_p95.stream"] == 10


@pytest.mark.parametrize("name", READERS)
def test_a_program_reader_without_a_program_trace_reads_nothing(name):
    read = metric_reader(name)
    assert read({"trace": None, "stream": None}) is None
    assert read({"program": None}) is None
    empty = {"traceEvents": [], "clock": {"origin_ns": 0}, "frames": [], "counters": {}}
    assert read({"program": {"trace": empty, "span_ns": None, "window_ns": None}}) is None


def test_the_replay_readers_take_no_host_clock_frames_as_device_time():
    """A CPU run's stamps are host ns: the device readers read nothing."""
    trace.enable()
    run(SegmentationEngine(small_cfg(), device="cpu", loop="cond"), small_frames(2))
    p = {"trace": trace.export(), "span_ns": None, "window_ns": None}
    for name in ("step.device_ms.replay", "hough.round_ms.replay", "device.idle_share.replay"):
        assert metric_reader(name)({"program": p}) is None
    assert metric_reader("engine.host_ms.replay")({"program": p}) > 0


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device stamps are a CUDA kernel")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def g6_small():
    return default_config(granularity=6, shapes=StaticShapes(
        max_raw_points=2048, max_points=1024, max_world_segments=32))


@pytest.mark.cuda
def test_a_traced_capture_stamps_in_order_and_times_the_replay(cuda):
    """Stamps of a captured frame are non-decreasing in the frame's order;
    frame.end less frame.begin is within 2% of CUDA events around the
    replay; the rounds stamped are the rounds that ran, by the voting
    wrappers' device counters (one launch a live round: the init, then
    each round but the last its re-exam or rebuild; a re-exam that
    overflowed also launched the rebuild, which the overflow tally
    counts)."""
    frames = small_frames(12, width=64)
    trace.enable()
    eng = SegmentationEngine(g6_small(), device=cuda)
    run(eng, frames[:1])                                   # the capture
    (cap,) = eng._step._graphs.values()
    assert cap.ring is not None and eng._step.captures[0]["stamps"] > 0
    events = []
    replay = cap.graph.replay

    def timed():
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        replay()
        e1.record()
        events.append((e0, e1))

    cap.graph.replay = timed
    V.reset_counts()
    trace.enable()                          # only the timed frames
    run(eng, frames[1:])
    torch.cuda.synchronize()
    ran = (V.ran_launches(V.vote_state) + V.ran_launches(V.vote_histogram)
           + V.ran_launches(V.vote_reexam))
    out = trace.export()
    ran -= out["counters"]["hough.suspect_overflow_rounds"]
    fr = out["frames"]
    assert len(fr) == len(events) == len(frames) - 1
    names = cap.ring.names
    for f, (e0, e1) in zip(fr, events):
        d = f["device_ns"]
        ts = [d[n] for n in names if n in d]
        assert ts == sorted(ts)
        stamp_ms = (d["frame.end"] - d["frame.begin"]) / 1e6
        assert abs(stamp_ms - e0.elapsed_time(e1)) <= 0.02 * e0.elapsed_time(e1)
    assert ran == sum(f["live_rounds"] for f in fr) > 0
    assert out["clock"]["devices"] and all(len(p) == 2 for p in out["clock"]["devices"].values())


@pytest.mark.cuda
def test_an_untraced_capture_holds_no_stamp(cuda):
    """The graph of an engine built with tracing off holds the traced one's
    nodes less its stamp kernels, and the same conditional nodes."""
    frames = small_frames(2, width=64)
    got = {}
    for traced in (False, True):
        if traced:
            trace.enable()
        eng = SegmentationEngine(g6_small(), device=cuda)
        run(eng, frames)
        (cap,) = eng._step._graphs.values()
        got[traced] = (eng._step.captures[0], cap.ring)
        trace.disable()
    (c0, ring0), (c1, ring1) = got[False], got[True]
    assert ring0 is None and ring1 is not None and c0["stamps"] == 0 and c1["stamps"] > 6
    assert c0["cond_nodes"] == c1["cond_nodes"] > 0
    assert c0["graph_nodes"] == c1["graph_nodes"] - c1["stamps"] > 0


@pytest.mark.cuda
def test_write_gives_json_with_a_host_and_a_device_track(cuda, tmp_path):
    trace.enable()
    run(SegmentationEngine(g6_small(), device=cuda), small_frames(3, width=64))
    path = tmp_path / "trace.json"
    trace.write(str(path))
    out = json.loads(path.read_text())
    names = {e["pid"]: e["args"]["name"] for e in out["traceEvents"] if e["ph"] == "M"}
    cats = {(names[e["pid"]].split(" ")[0], e["cat"])
            for e in out["traceEvents"] if e["ph"] == "X"}
    assert ("host", "host") in cats and ("frame", "device") in cats
    assert any("cuda" in n for n in names.values())
    assert all(not math.isnan(e["ts"]) for e in out["traceEvents"] if "ts" in e)
