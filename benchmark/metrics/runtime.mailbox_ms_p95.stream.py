"""Runtime: 95th percentile of ``runtime.mailbox``, from
``SegmentationEngine.submit_cloud`` to the streaming worker's take of that
frame, ms, over the frames that entered the mailbox before the profiler's
span (a dropped frame is never taken and has no span)."""

from benchmark.metrics._program import due_before_span, host_spans, note, p95, program

MOVES = "stream_ms_p95"


def read(ctx):
    p = program(ctx)
    if p is None:
        return None
    due = due_before_span(p)
    ms = [(e - s) / 1e6 for s, e, frame, _, _ in host_spans(p, "runtime.mailbox")
          if frame in due]
    note(p, "runtime.mailbox_ms_p95.stream", len(ms))
    return p95(ms) if ms else None
