"""Helpers the per-layer readers share (not a metric: no file of
``metrics/`` is named from it in BENCHMARK.json)."""

import re

STATE = re.compile(r"vote_kernel<\s*(true|1)\s*>")


def kernel_seconds(trace, pattern):
    """(seconds, launches) of the kernels whose name matches `pattern`."""
    sec, n = 0.0, 0
    for name, (s, c) in trace.kernels.items():
        if pattern.search(name):
            sec += s
            n += c
    return sec, n
