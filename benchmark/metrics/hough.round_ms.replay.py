"""Captured frame step (Hough): the device ms of a live Hough round, from
``round[r].begin`` to ``round[r].end`` on the card, summed over the frames
read and their live rounds and divided by the live rounds (a round whose
conditional node did not run has no stamps)."""

from benchmark.metrics._program import device_frames, note, program

MOVES = "frames_per_s"


def read(ctx):
    p = program(ctx)
    if p is None:
        return None
    frames = device_frames(p)
    note(p, "hough.round_ms.replay", len(frames))
    total_ns, rounds = 0, 0
    for f in frames:
        d = f["device_ns"]
        for name, begin in d.items():
            if name.startswith("round[") and name.endswith("].begin"):
                end = d.get(name[:-len("begin")] + "end")
                if end is not None:
                    total_ns += end - begin
                    rounds += 1
    return total_ns / rounds / 1e6 if rounds else None
