"""Device: the share of the card's time between frames, %: over the longest
run of consecutive replays among the frames read, 100 x (1 - the frames'
device time (``frame.end`` less ``frame.begin``) / (the last ``frame.end``
less the first ``frame.begin``)), all on the card's clock."""

from benchmark.metrics._program import device_frames, note, program

MOVES = "frames_per_s"


def read(ctx):
    p = program(ctx)
    if p is None:
        return None
    best, run = [], []
    for f in device_frames(p):
        if run and (f["ring"], f["replay"]) != (run[-1]["ring"], run[-1]["replay"] + 1):
            run = []
        run.append(f)
        if len(run) > len(best):
            best = list(run)
    note(p, "device.idle_share.replay", len(best))
    if len(best) < 2:
        return None
    busy = sum(f["device_ns"]["frame.end"] - f["device_ns"]["frame.begin"] for f in best)
    span = best[-1]["device_ns"]["frame.end"] - best[0]["device_ns"]["frame.begin"]
    return 100.0 * (1.0 - busy / span)
