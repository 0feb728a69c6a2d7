"""glibc malloc arena cap for long-lived streaming deployments.

Each restarted engine worker or feeder thread otherwise lands on a fresh
glibc arena whose freed blocks are retained by the allocator and never
returned to the OS, so a process that starts and stops the streaming worker
many times grows with every restart.  With `M_ARENA_MAX` set before the
threads are created, the threads share the capped arenas and that growth
stops; set late (after a library's thread pools exist), the arenas that
already exist are each visited once and the size then levels off.

The cap is applied at package import (the earliest point the package
controls) and again from `SegmentationEngine.start()`.  Tune or disable it
with `PCS_MALLOC_ARENA_MAX` (0 disables; default 2).  The frame path's
allocations are numpy and torch buffers large enough to be mapped, so two
arenas do not contend.  Platforms without glibc's `mallopt` are a silent
no-op.  The port's own copy of the JAX package's _malloc.py (same code).
"""

import logging
import os

logger = logging.getLogger("pointcloud_segmentation_tpu_torch")

_M_ARENA_MAX = -8
_applied = False


def cap_malloc_arenas() -> None:
    """Bound glibc malloc arenas, once per process (see module docstring)."""
    global _applied
    if _applied:
        return
    _applied = True
    try:
        n = int(os.environ.get("PCS_MALLOC_ARENA_MAX", "2"))
    except ValueError:
        n = 2
    if n <= 0:
        return
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.mallopt(ctypes.c_int(_M_ARENA_MAX), ctypes.c_int(n))
    except Exception:  # pragma: no cover - non-glibc platforms
        logger.debug("mallopt(M_ARENA_MAX) unavailable; arena growth "
                     "across engine restarts is unbounded on this libc")
