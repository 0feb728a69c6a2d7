"""The port's own tracer: host spans in the engine and the streaming runtime,
device stamps inside the captured frame, exported on one clock.

Off by default.  While it is off, `span()` returns one shared no-op object,
`stamp()`, `tally()`, `count()`, `begin()` and `mark()` return at once, and nothing is
allocated a frame.  `enable()` turns it on for the whole process:

  * Host spans: a name, a start and an end on ``time.perf_counter_ns()``
    (CLOCK_MONOTONIC), the span that was open on the same thread when it
    began (its parent) and the frame it belongs to (the frame's sensor
    stamp ``t``, inherited from the parent when not given).  They are kept
    in arrays made at `enable()` (`SPAN_CAPACITY` spans; later ones are
    counted as dropped) and written out only by `export()` / `write()`.
  * Device stamps: a frame step captured while tracing is on
    (pipeline.FrameStep) holds, at each stage boundary of the frame, a
    one-thread kernel that writes the card's ``%globaltimer`` into that
    frame's row of a `Ring` on the card (csrc/trace.cu).  A round whose
    conditional node does not run leaves its slots 0, so the nonzero
    ``round[r].begin`` slots are the frame's live Hough rounds
    (``hough.live_rounds``).  A step captured with tracing off holds no
    stamp.  On the CPU, where the step runs the frame eagerly, `stamp()`
    writes ``perf_counter_ns()`` at the same call sites into a host `Ring`.
  * Device tallies: beside its stamps, a frame's row holds counts that
    `tally()` adds to, each from a one-thread kernel in the captured frame
    (inside a conditional node, a count of the replays whose flag held;
    on the CPU a host add).  The Hough loop tallies each round that took
    the increment branch and each that rebuilt (`ops.hough.TALLIES`).
    Read only at export, with the stamps.
  * One clock: at `enable()` and at `export()` the tracer brackets an eager
    stamp and a synchronise between two ``perf_counter_ns()`` reads, 16
    times a card, keeps the tightest pair, and maps every device stamp to
    host ns by the line through the two pairs.  It also keeps a
    ``(perf_counter_ns, time_ns)`` pair at both moments: torch.profiler
    (Kineto) stamps its events on the Unix clock, so a profiler's trace
    maps onto the same timeline.

`export()` returns Chrome trace-event JSON as a dict (Perfetto opens it): an
``"X"`` event per span (process "host", one track a thread) and per device
stage (one process a ring), a ``"C"`` event of each frame's live rounds and
of each of its tallies, and beside ``traceEvents`` the clock block, the
frames' stamps on host ns and tallies, and the counters (a tally's is its
sum over the frames).  `write(path)` writes the same dict.

The stages of a frame (slot order): ``frame.begin``, ``preproc.begin``,
``preproc.sorted`` (the voxel keys' sort ends and the voxel sums begin),
``preproc.end``, ``hough.init.end``, for each round r that runs
``round[r].begin``, ``round[r].gates.end``, ``round[r].vote.begin`` (the
segment write ends and the voting state's update begins) and
``round[r].end``, then ``segments.end``, ``world.end`` and ``frame.end``.
A stage ``X`` is the interval that ends at ``X.end``: from ``X.begin``
where there is one, else from the stamp before it.
"""

from __future__ import annotations

import json
import math
import threading
import time
import weakref
from array import array
from typing import Optional

SPAN_CAPACITY = 1 << 16   # host spans kept from enable() to export()
RING_ROWS = 4096          # frames a ring keeps: 80 s at 50 frames/s
RING_WIDTH = 128          # slots a row: stamps in all but the last, the row's tag there
CALIBRATION_TRIES = 16    # bracketed eager stamps a calibration keeps the tightest of
_MARKS_CAP = 1024         # open cross-thread spans (`mark`) kept at once


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()

_on = False
_buf: Optional["_Buffers"] = None
_lock = threading.Lock()
_tl = threading.local()          # .stack (open span indices), .gen, .ring
_rings: "weakref.WeakSet[Ring]" = weakref.WeakSet()
_watched: "weakref.WeakSet" = weakref.WeakSet()
_stage_names: dict = {}          # (pattern, index) -> stage name
_ring_ids = iter(range(1, 1 << 62))


class _Buffers:
    """What one enable() records, until disable()."""

    def __init__(self, capacity: int, gen: int):
        self.capacity, self.gen = capacity, gen
        self.n = 0
        self.dropped = 0
        self.name = array("i", bytes(4 * capacity))
        self.parent = array("i", bytes(4 * capacity))
        self.start = array("q", bytes(8 * capacity))
        self.end = array("q", bytes(8 * capacity))
        self.tid = array("q", bytes(8 * capacity))
        self.frame = array("d", bytes(8 * capacity))
        self.names: list = []
        self.name_ids: dict = {}
        self.counters: dict = {}
        self.marks: dict = {}
        self.rings: list = []            # every ring stamped since enable(), held
        self.calibrations: dict = {}     # device -> [pair at enable, pair at export]
        self.unix: list = []             # [perf_counter_ns, time_ns] at both moments
        self.stamps_dropped = 0

    def name_id(self, name: str) -> int:
        i = self.name_ids.get(name)
        if i is None:
            with _lock:
                i = self.name_ids.setdefault(name, len(self.names))
                if i == len(self.names):
                    self.names.append(name)
        return i


def enabled() -> bool:
    return _on


def enable() -> None:
    """Turn tracing on, dropping what an earlier enable() recorded, and take
    the first calibration (of the current card, where there is one)."""
    global _buf, _on
    gen = (_buf.gen + 1) if _buf is not None else 1
    buf = _Buffers(SPAN_CAPACITY, gen)
    buf.unix.append(_unix_pair())
    for ring in list(_rings):
        ring.first = ring.seq
        buf.rings.append(ring)
    dev = _current_card()
    if dev is not None:
        buf.calibrations[dev] = [_calibrate(dev)]
    _buf = buf
    _on = True


def disable() -> None:
    """Turn tracing off and drop what was recorded.  A graph captured while
    it was on goes on stamping its ring; a later enable() reads it again."""
    global _buf, _on
    _on = False
    _buf = None


def _stack() -> list:
    """This thread's open spans (indices into the current buffers)."""
    if getattr(_tl, "gen", None) != _buf.gen:
        _tl.stack = []
        _tl.gen = _buf.gen
    return _tl.stack


def begin(name: str, frame=None, t0: Optional[int] = None) -> int:
    """Open a span on this thread from `t0` (perf_counter_ns, now if None);
    returns its index for `end`, or -1 when tracing is off."""
    if not _on:
        return -1
    buf = _buf
    with _lock:
        i = buf.n
        if i == buf.capacity:
            buf.dropped += 1
            return -1
        buf.n = i + 1
    stack = _stack()
    parent = stack[-1] if stack else -1
    if frame is None:
        frame = buf.frame[parent] if parent >= 0 else math.nan
    buf.name[i] = buf.name_id(name)
    buf.parent[i] = parent
    buf.start[i] = time.perf_counter_ns() if t0 is None else t0
    buf.end[i] = 0
    buf.tid[i] = threading.get_native_id()
    buf.frame[i] = frame
    stack.append(i)
    return i


def end(i: int, t1: Optional[int] = None) -> None:
    """Close the span `begin` opened at `t1` (perf_counter_ns, now if None)."""
    if i < 0 or _buf is None:
        return
    _buf.end[i] = time.perf_counter_ns() if t1 is None else t1
    stack = _stack()
    if stack and stack[-1] == i:
        stack.pop()
    elif i in stack:
        stack.remove(i)


class _Span:
    __slots__ = ("name", "frame", "i")

    def __init__(self, name, frame):
        self.name, self.frame, self.i = name, frame, -1

    def __enter__(self):
        self.i = begin(self.name, self.frame)
        return self

    def __exit__(self, *exc):
        end(self.i)
        return False


def span(name: str, frame=None):
    """A context manager timing its body as a span: the shared `NOOP` when
    tracing is off."""
    if not _on:
        return NOOP
    return _Span(name, frame)


def add(name: str, t0: int, t1: int, frame=None) -> None:
    """A span already measured (perf_counter_ns bounds), a child of the span
    open on this thread."""
    i = begin(name, frame, t0)
    end(i, t1)


def mark(name: str, key) -> None:
    """Start a span that another thread ends (`marked`), keyed by `key`, the
    frame's stamp."""
    if not _on:
        return
    marks = _buf.marks
    with _lock:
        marks[(name, key)] = time.perf_counter_ns()
        if len(marks) > _MARKS_CAP:      # keys never ended: frames dropped
            del marks[next(iter(marks))]


def marked(name: str, key, t1: int) -> None:
    """End the span `mark(name, key)` started, at `t1`, as a span of this
    thread with no parent; nothing when none was started."""
    if not _on:
        return
    buf = _buf
    with _lock:
        t0 = buf.marks.pop((name, key), None)
    if t0 is None:
        return
    i = begin(name, key, t0)
    if i >= 0:
        buf.parent[i] = -1
        end(i, t1)


def count(name: str, n: int = 1) -> None:
    if not _on:
        return
    with _lock:
        _buf.counters[name] = _buf.counters.get(name, 0) + n


def watch(obj) -> None:
    """Export `obj.trace_counters()` (a dict of counts) with the trace, summed
    over the live objects watched; the tracer keeps no reference."""
    _watched.add(obj)


def _current_frame() -> float:
    if not _on:
        return math.nan
    stack = _stack()
    return _buf.frame[stack[-1]] if stack else math.nan


# ------------------------------------------------------------------ stamps

class Ring:
    """The stamps of one captured frame (`device` a card) or of one eager
    step on the CPU (`device` None, host clock): `RING_ROWS` rows of
    `RING_WIDTH` slots, one row a frame, one slot a stage, the slots named
    in the order of their first stamp.  A card's ring is made before any
    capture (a tensor made during one would be the graph's); `replayed`
    notes each replay's frame on the host.  `seq` counts the frames stamped,
    the card's counter's host mirror.  A slot named by `tally` holds a count
    of the frame, not a time (`tallies`, in slot order)."""

    def __init__(self, device=None):
        import numpy as np
        import torch

        self.id = next(_ring_ids)
        self.device = device
        self.names = ["frame.begin"]
        self.slots = {"frame.begin": 0}
        self.seq = self.first = 0
        self.captured = 0                  # stamp and tally kernels captured
        self.tallies: list = []
        self.t = array("d", [math.nan]) * RING_ROWS
        self.replay = array("q", [-1]) * RING_ROWS
        if device is None:
            self.rows = np.zeros((RING_ROWS, RING_WIDTH), np.int64)
            self.counter = None
        else:
            self.rows = torch.zeros((RING_ROWS, RING_WIDTH), dtype=torch.int64, device=device)
            self.counter = torch.zeros((), dtype=torch.int64, device=device)
        _rings.add(self)
        if _buf is not None:
            _buf.rings.append(self)     # its frames outlive its step until export

    def slot(self, stage: str) -> int:
        s = self.slots.get(stage)
        if s is None:
            if len(self.names) == RING_WIDTH - 1:
                if _buf is not None:
                    _buf.stamps_dropped += 1
                return -1
            s = self.slots[stage] = len(self.names)
            self.names.append(stage)
        return s

    def stamp(self, stage: str) -> None:
        slot = self.slot(stage)
        if slot < 0:
            return
        if self.device is None:
            now = time.perf_counter_ns()
            if slot == 0:
                k = self.seq % RING_ROWS
                row = self.rows[k]
                row[:] = 0
                row[-1] = self.seq + 1
                self.t[k] = _current_frame()
                self.replay[k] = self.seq
                self.seq += 1
            else:
                row = self.rows[(self.seq - 1) % RING_ROWS]
            row[slot] = now
            return
        import torch

        from ._build import load_library

        if not torch.cuda.is_current_stream_capturing():
            return                          # the card stamps only its graph's frames
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = load_library().pcs_trace_stamp(self.rows.data_ptr(), self.counter.data_ptr(),
                                             RING_ROWS, RING_WIDTH, slot, stream)
        if err != 0:
            raise RuntimeError(f"trace stamp launch failed: CUDA error {err}")
        self.captured += 1

    def tally(self, name: str) -> None:
        """One more `name` in the frame's row (the frame stamped last)."""
        slot = self.slot(name)
        if slot < 0:
            return
        if name not in self.tallies:
            self.tallies.append(name)
        if self.device is None:
            if self.seq:
                self.rows[(self.seq - 1) % RING_ROWS, slot] += 1
            return
        import torch

        from ._build import load_library

        if not torch.cuda.is_current_stream_capturing():
            return
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = load_library().pcs_trace_tally(self.rows.data_ptr(), self.counter.data_ptr(),
                                             RING_ROWS, RING_WIDTH, slot, stream)
        if err != 0:
            raise RuntimeError(f"trace tally launch failed: CUDA error {err}")
        self.captured += 1

    def replayed(self, replay: int) -> None:
        """One replay of the ring's graph was queued: its frame is the one
        the thread's open span belongs to."""
        k = self.seq % RING_ROWS
        self.t[k] = _current_frame()
        self.replay[k] = replay
        self.seq += 1

    def frames(self) -> list:
        """(seq, t, replay, {stage: raw ns}, {tally: count}) of the frames
        stamped since the last enable() that the ring still holds."""
        import torch

        if self.device is None:
            rows = self.rows
        else:
            torch.cuda.synchronize(self.device)
            rows = self.rows.cpu().numpy()
        out = []
        for seq in range(max(self.first, self.seq - RING_ROWS), self.seq):
            k = seq % RING_ROWS
            row = rows[k]
            if int(row[-1]) != seq + 1:
                continue                    # not stamped, or written over
            stamps = {self.names[s]: int(row[s]) for s in range(len(self.names))
                      if row[s] and self.names[s] not in self.tallies}
            counts = {name: int(row[self.slots[name]]) for name in self.tallies}
            t = self.t[k]
            out.append((seq, None if math.isnan(t) else t, int(self.replay[k]), stamps, counts))
        return out


class _Stamping:
    __slots__ = ("ring", "prev")

    def __init__(self, ring):
        self.ring, self.prev = ring, None

    def __enter__(self):
        self.prev = getattr(_tl, "ring", None)
        _tl.ring = self.ring
        return self

    def __exit__(self, *exc):
        _tl.ring = self.prev
        return False


def stamping(ring: Optional[Ring]):
    """Send this thread's stamps to `ring` inside the block (nothing when
    `ring` is None)."""
    return NOOP if ring is None else _Stamping(ring)


def tally(name: str) -> None:
    """One more `name` in the frame being stamped: into the thread's ring,
    when tracing is on and a frame step set one (module docstring)."""
    if not _on:
        return
    ring = getattr(_tl, "ring", None)
    if ring is not None:
        ring.tally(name)


def stamp(stage: str, index: Optional[int] = None) -> None:
    """A stamp at a stage boundary of the frame: into the thread's ring, when
    tracing is on and a frame step set one.  With an `index`, the stage is
    ``stage.format(index)`` (``"round[{}].begin"``), formatted only then."""
    if not _on:
        return
    ring = getattr(_tl, "ring", None)
    if ring is None:
        return
    if index is not None:
        key = (stage, index)
        name = _stage_names.get(key)
        if name is None:
            name = _stage_names[key] = stage.format(index)
        stage = name
    ring.stamp(stage)


# ------------------------------------------------------------------ the clock

def _unix_pair() -> list:
    a = time.perf_counter_ns()
    u = time.time_ns()
    b = time.perf_counter_ns()
    return [(a + b) // 2, u]


def _current_card():
    import torch

    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device())


def _calibrate(device) -> dict:
    """The tightest of `CALIBRATION_TRIES` brackets of an eager stamp and a
    synchronise by two perf_counter_ns reads: the host ns at the bracket's
    middle, the stamp's device ns and the bracket's width."""
    import torch

    from ._build import load_library

    lib = load_library()
    with torch.cuda.device(device):
        out = torch.zeros(CALIBRATION_TRIES, dtype=torch.int64, device=device)
        stream = torch.cuda.current_stream(device)
        stream.synchronize()
        brackets = []
        for i in range(CALIBRATION_TRIES):
            h0 = time.perf_counter_ns()
            err = lib.pcs_trace_now(out.data_ptr() + 8 * i, stream.cuda_stream)
            stream.synchronize()
            h1 = time.perf_counter_ns()
            if err != 0:
                raise RuntimeError(f"trace clock stamp failed: CUDA error {err}")
            brackets.append((h0, h1))
        dev_ns = out.tolist()
    i = min(range(CALIBRATION_TRIES), key=lambda k: brackets[k][1] - brackets[k][0])
    h0, h1 = brackets[i]
    return {"host_ns": (h0 + h1) // 2, "device_ns": dev_ns[i], "round_trip_ns": h1 - h0}


def to_host(pairs: list, device_ns: int) -> int:
    """Device ns on host perf_counter ns: the line through the first and
    last calibration pairs (an offset alone with one)."""
    a, b = pairs[0], pairs[-1]
    h = a["host_ns"] + (device_ns - a["device_ns"])
    if b["device_ns"] != a["device_ns"]:
        slope = (b["host_ns"] - a["host_ns"]) / (b["device_ns"] - a["device_ns"])
        h = a["host_ns"] + round((device_ns - a["device_ns"]) * slope)
    return h


# ------------------------------------------------------------------ export

def stages(stamps: dict) -> list:
    """(stage, start, end) of one frame's stamps, in time order: a stage X
    ends at ``X.end`` and starts at ``X.begin`` where there is one, else at
    the stamp before."""
    order = sorted(stamps.items(), key=lambda kv: kv[1])
    out = []
    for k, (name, t) in enumerate(order):
        if not name.endswith(".end") or k == 0:
            continue
        base = name[:-4]
        start = stamps.get(base + ".begin", order[k - 1][1])
        out.append((base, start, t))
    return out


def live_rounds(stamps: dict) -> int:
    """The Hough rounds that ran: those with a ``round[r].begin`` stamp."""
    return sum(1 for name in stamps if name.startswith("round[") and name.endswith("].begin"))


def _counters(buf: _Buffers) -> dict:
    out = dict(buf.counters)
    for obj in list(_watched):
        for name, v in obj.trace_counters().items():
            out[name] = out.get(name, 0) + v
    import sys

    V = sys.modules.get(__package__ + ".ops.voting")
    if V is not None:
        for fn in V.COUNTED:
            out[f"{fn.__name__}.ran_launches"] = V.ran_launches(fn)
        out["vote_reexam.rows"] = V.reexamined_rows()
    P = sys.modules.get(__package__ + ".ops.preproc")
    if P is not None:
        out["preproc.voxel_overflow"] = P.voxel_overflow()
    H = sys.modules.get(__package__ + ".ops.hough")
    if H is not None:
        for name in H.TALLIES:           # 0 where no frame ran the branch
            out.setdefault(name, 0)
    out["trace.spans_dropped"] = buf.dropped
    out["trace.stamps_dropped"] = buf.stamps_dropped
    return out


def export() -> dict:
    """The trace recorded since enable(), as a Chrome trace-event dict (the
    module docstring); an empty one when tracing is off.  Takes the second
    calibration of each card that stamped."""
    buf = _buf
    if buf is None:
        return {"traceEvents": [], "displayTimeUnit": "ms", "clock": {}, "frames": [],
                "counters": {}}
    rings = sorted(set(buf.rings) | set(_rings), key=lambda r: r.id)
    cards = {r.device for r in rings if r.device is not None} | set(buf.calibrations)
    for dev in cards:
        buf.calibrations.setdefault(dev, []).append(_calibrate(dev))
    buf.unix.append(_unix_pair())
    origin = buf.unix[0][0]

    def us(ns):
        return (ns - origin) / 1e3

    events = [{"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "host"}}]
    n = buf.n
    for i in range(n):
        t0, t1 = buf.start[i], buf.end[i]
        if t1 == 0:
            continue                        # still open
        f = buf.frame[i]
        events.append({"ph": "X", "name": buf.names[buf.name[i]], "cat": "host", "pid": 1,
                       "tid": buf.tid[i], "ts": us(t0), "dur": (t1 - t0) / 1e3,
                       "args": {"id": i, "parent": buf.parent[i],
                                "frame": None if math.isnan(f) else f}})
    frames = []
    live_total = 0
    tallied: dict = {}
    for ring in rings:
        pid = 1 + ring.id
        where = "host clock" if ring.device is None else str(ring.device)
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": f"frame stages ({where}), ring {ring.id}"}})
        pairs = buf.calibrations.get(ring.device)
        for seq, t, replay, raw, counts in ring.frames():
            host = raw if ring.device is None else {k: to_host(pairs, v) for k, v in raw.items()}
            live = live_rounds(raw)
            live_total += live
            for name, n in counts.items():
                tallied[name] = tallied.get(name, 0) + n
            rec = {"ring": ring.id, "device": where, "seq": seq, "t": t, "replay": replay,
                   "live_rounds": live, "stamps": host, "tallies": counts}
            if ring.device is not None:
                rec["device_ns"] = raw
            frames.append(rec)
            args = {"frame": t, "replay": replay}
            for name, s, e in stages(host):
                events.append({"ph": "X", "name": name, "cat": "device", "pid": pid, "tid": 1,
                               "ts": us(s), "dur": (e - s) / 1e3, "args": args})
            if "frame.begin" in host:
                for name, n in [("hough.live_rounds", live), *counts.items()]:
                    events.append({"ph": "C", "name": name, "pid": pid,
                                   "ts": us(host["frame.begin"]), "args": {"value": n}})
    counters = _counters(buf)
    counters.update(tallied)
    counters["hough.live_rounds"] = live_total
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "clock": {"host": "time.perf_counter_ns (CLOCK_MONOTONIC)", "origin_ns": origin,
                  "unix": [list(p) for p in buf.unix],
                  "devices": {str(d): list(p) for d, p in buf.calibrations.items()}},
        "frames": frames,
        "counters": counters,
    }


def write(path: str) -> dict:
    """`export()` written to `path` as JSON; returns it."""
    out = export()
    with open(path, "w") as f:
        json.dump(out, f)
    return out
