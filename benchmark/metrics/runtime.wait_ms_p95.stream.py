"""Runtime: 95th percentile, over the frames that reached the viewer, of
the frame's stream ms less its record's `processing_time` (host clock
around the frame's work, which ends in its read on this synchronous
path): the time the frame waited in the feeder, the mailbox and the
worker's wake."""

import numpy as np

MOVES = "stream_ms_p95"


def read(ctx):
    s = ctx["stream"]
    if not s or not s.get("wait_ms"):
        return None
    return float(np.percentile(s["wait_ms"], 95))
