"""The traced span of a ``--trace 1`` run: torch.profiler over a bounded
span of steady frames, reduced to what the per-layer readers take.

On the card the span records CUDA activity only: CUPTI's kernel, copy and
runtime-call records, from every thread of the process.  The roofline's
eager pass records host operators too (`host_ops`): with CUDA activity
alone, one eager pass of three lost 15 of its 240 state-kernel records.

Only the reduction lives here: device busy time (the union of the device
activities' intervals), time by kernel name, and the idle gaps between
device activities, each named by the host call (on the card, a CUDA
runtime call) it overlaps most.  No chrome trace is written.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class TraceSummary:
    window_s: float                     # the span's wall time
    frames: int                         # frames whose step ran inside it
    busy_s: float                       # union of device activity intervals
    kernels: Dict[str, Tuple[float, int]]   # name -> (seconds, launches)
    gaps: List[Tuple[str, float]]       # (host op, idle seconds), by total


class Span:
    """Profiles from `start()` to `stop()`; `summary()` reduces it."""

    def __init__(self, cuda: bool = True, host_ops: bool = False):
        self.cuda = cuda
        self.host_ops = host_ops or not cuda
        self._prof = None
        self._t0 = self._t1 = 0.0
        self.frames = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        if self.cuda:
            torch.cuda.synchronize()
        acts = ([ProfilerActivity.CPU] if self.host_ops else []) + (
            [ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self._t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)

    def summary(self) -> Optional[TraceSummary]:
        if self._prof is None:          # never started: the window was shorter
            return None
        return reduce_events(_raw_events(self._prof), self._t1 - self._t0, self.frames)


def _raw_events(prof) -> List[tuple]:
    """(on_device, name, start_ns, end_ns) of every event, user annotations
    left out (their device-side copies span whole regions)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            continue
        start = e.start_ns()
        out.append((e.device_type() == DeviceType.CUDA, e.name(), start,
                    start + e.duration_ns()))
    return out


def reduce_events(events: List[tuple], window_s: float, frames: int,
                  n_gaps: int = 10) -> Optional[TraceSummary]:
    """The span's summary from raw (on_device, name, start_ns, end_ns)
    events; None when the device ran nothing."""
    dev = sorted((s, e, n) for on, n, s, e in events if on and e > s)
    if not dev:
        return None
    kernels: Dict[str, Tuple[float, int]] = {}
    for s, e, n in dev:
        sec, cnt = kernels.get(n, (0.0, 0))
        kernels[n] = (sec + (e - s) / 1e9, cnt + 1)
    # union of the intervals, and the gaps between them
    busy_ns = 0
    gaps = []
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _ in dev[1:]:
        if s > cur_e:
            busy_ns += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_ns += cur_e - cur_s
    host = sorted((s, e, n) for on, n, s, e in events if not on and e > s)
    return TraceSummary(window_s=window_s, frames=frames, busy_s=busy_ns / 1e9,
                        kernels=kernels,
                        gaps=_name_gaps(gaps, host, n_gaps))


def _name_gaps(gaps: List[tuple], host: List[tuple], n: int,
               named: int = 500) -> List[Tuple[str, float]]:
    """Idle seconds by the host operation that overlaps each gap most (the
    shorter of two equal overlaps, so the innermost), largest totals first.
    The `named` longest gaps are named; the rest are summed as one entry."""
    import numpy as np

    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    totals: Dict[str, float] = {}
    hs = np.array([s for s, _, _ in host], dtype=np.int64)
    he = np.array([e for _, e, _ in host], dtype=np.int64)
    for g0, g1 in gaps[:named]:
        name = "no host op"
        if len(hs):
            ov = np.minimum(he, g1) - np.maximum(hs, g0)
            best = ov.max()
            if best > 0:
                cand = np.nonzero(ov == best)[0]
                name = host[int(cand[np.argmin((he - hs)[cand])])][2]
        totals[name] = totals.get(name, 0.0) + (g1 - g0) / 1e9
    rest = gaps[named:]
    if rest:
        totals[f"{len(rest)} shorter gaps"] = sum(g1 - g0 for g0, g1 in rest) / 1e9
    return sorted(totals.items(), key=lambda kv: -kv[1])[:n]
