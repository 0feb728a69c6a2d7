"""Engine: the median over the frames read of the host time of
``SegmentationEngine.process_frame`` (its ``engine.frame`` span, the reads
its ``processing_time`` is built from) less its ``engine.read`` (the packed
read, which waits for the card), ms."""

import statistics

from benchmark.metrics._program import host_spans, note, program, read_frames

MOVES = "frame_ms_p95"


def read(ctx):
    p = program(ctx)
    if p is None:
        return None
    reads: dict = {}
    for s, e, _, _, parent in host_spans(p, "engine.read"):
        reads[parent] = reads.get(parent, 0) + (e - s)
    frames = read_frames(p)
    note(p, "engine.host_ms.replay", len(frames))
    if not frames:
        return None
    return statistics.median((e - s - reads.get(i, 0)) / 1e6 for s, e, _, i, _ in frames)
