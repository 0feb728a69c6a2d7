"""Voting kernels: the lazy-vote state kernel's share of its roofline, %:
the least time of the traced span's launches (benchmark/roofline/voting.py)
over the device time of `vote_kernel<true>` when an eager pass runs the
span's frames again under the profiler.  None when they ran none, or when
the profiler's count of the kernel's launches is not the counting
wrapper's (the share would be of other work)."""

from benchmark.metrics._common import STATE, kernel_seconds
from benchmark.roofline.voting import least_total

MOVES = "frames_per_s"


def read(ctx):
    trace, launches = ctx["eager_trace"], ctx["launches"]
    if trace is None or not launches:
        return None
    sec, n = kernel_seconds(trace, STATE)
    if n != len(launches) or sec <= 0:
        return None
    return 100.0 * least_total(launches) / sec
