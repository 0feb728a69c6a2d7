"""Helpers of the readers that take the program's own trace (not a metric:
no file of ``metrics/`` is named from it in BENCHMARK.json).

``ctx["program"]``, in a run that traced the program (the tracer on before
the engine is built, so that the captured frame holds its stamps, and
exported right after the window):

    {"trace": pointcloud_segmentation_tpu_torch.trace.export(),
     "span_ns": (start, stop) of the profiler's span, or None,
     "window_ns": (first, last) of the measured window, or None}

every bound on ``time.perf_counter_ns()``, the tracer's clock.  A reader
reads the frames of the window but those inside the profiler's span and
the `SKIP_AFTER` after it (the profiler's start and stop stall them), and
notes how many it read in ``ctx["program"]["frames_read"][<metric>]``.
Without ``ctx["program"]``, or with nothing of its kind in the trace, a
reader returns None.
"""

import numpy as np

SKIP_AFTER = 5


def program(ctx):
    p = ctx.get("program")
    return p if p and p.get("trace") else None


def note(p, metric: str, n: int) -> None:
    p.setdefault("frames_read", {})[metric] = n


def host_spans(p, name: str) -> list:
    """(start_ns, end_ns, frame, id, parent) of the trace's host spans called
    `name`, in start order."""
    tr = p["trace"]
    origin = tr["clock"]["origin_ns"]
    out = []
    for e in tr["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "host" and e["name"] == name:
            s = origin + round(e["ts"] * 1e3)
            out.append((s, s + round(e["dur"] * 1e3), e["args"]["frame"], e["args"]["id"],
                        e["args"]["parent"]))
    return sorted(out)


def in_window(p, ns: int) -> bool:
    w = p.get("window_ns")
    return w is None or w[0] <= ns <= w[1]


def skipped(p) -> set:
    """The frames (by stamp) inside the profiler's span and the SKIP_AFTER
    after it, by their ``engine.frame`` spans' starts."""
    span = p.get("span_ns")
    if span is None:
        return set()
    out, after = set(), 0
    for s, _, frame, _, _ in host_spans(p, "engine.frame"):
        if span[0] <= s <= span[1]:
            out.add(frame)
        elif s > span[1] and after < SKIP_AFTER:
            out.add(frame)
            after += 1
    return out


def read_frames(p) -> list:
    """The engine.frame spans that a replay reader reads."""
    skip = skipped(p)
    return [f for f in host_spans(p, "engine.frame")
            if f[2] not in skip and in_window(p, f[0])]


def device_frames(p) -> list:
    """The frames stamped on a card (``device_ns``, raw device ns) that a
    replay reader reads, in replay order."""
    skip = skipped(p)
    out = [f for f in p["trace"]["frames"]
           if "device_ns" in f and f["t"] not in skip
           and {"frame.begin", "frame.end"} <= f["device_ns"].keys()
           and in_window(p, f["stamps"]["frame.begin"])]
    return sorted(out, key=lambda f: (f["ring"], f["replay"]))


def due_before_span(p) -> set:
    """The frames (by stamp) of a stream that entered the mailbox inside the
    window and before the profiler's span."""
    span = p.get("span_ns")
    return {frame for s, _, frame, _, _ in host_spans(p, "runtime.mailbox")
            if in_window(p, s) and (span is None or s < span[0])}


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))
