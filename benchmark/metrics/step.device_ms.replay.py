"""Captured frame step: the median over the frames read of the frame's
device time, ``frame.end`` less ``frame.begin`` of the stamps the captured
graph writes on the card (``%globaltimer``), ms."""

import statistics

from benchmark.metrics._program import device_frames, note, program

MOVES = "frames_per_s"


def read(ctx):
    p = program(ctx)
    if p is None:
        return None
    frames = device_frames(p)
    note(p, "step.device_ms.replay", len(frames))
    if not frames:
        return None
    return statistics.median((f["device_ns"]["frame.end"] - f["device_ns"]["frame.begin"]) / 1e6
                             for f in frames)
