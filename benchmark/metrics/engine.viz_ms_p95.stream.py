"""Engine: 95th percentile of ``engine.viz``, the engine's build and
delivery of a frame's viz record after its ``processing_time`` stops, ms,
over the frames that entered the mailbox before the profiler's span."""

from benchmark.metrics._program import due_before_span, host_spans, note, p95, program

MOVES = "stream_ms_p95"


def read(ctx):
    p = program(ctx)
    if p is None:
        return None
    due = due_before_span(p)
    ms = [(e - s) / 1e6 for s, e, frame, _, _ in host_spans(p, "engine.viz") if frame in due]
    note(p, "engine.viz_ms_p95.stream", len(ms))
    return p95(ms) if ms else None
