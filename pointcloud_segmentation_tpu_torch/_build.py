"""Builds the CUDA sources under ``csrc/`` with nvcc and loads them with ctypes.

One library, from five sources in one nvcc call: ``voting.cu`` (the voting
kernels), ``gates.cu`` (a Hough round's gates, ops/gates.py), ``voxel.cu``
(the voxel grid's sums, ops/preproc.py), ``graph_cond.cu`` (the
conditional nodes of the captured frame, ops/hough.py `run_if`) and
``trace.cu`` (the tracer's device stamps and tallies, trace.py).  It has a
plain C interface (no PyTorch headers), so nvcc builds it in seconds.  It
is built at first use into ``build/torch_kernels/`` beside the package,
keyed by a hash of the sources and the flags, so unchanged sources are
built once per checkout.  Nothing here runs at import time.  One lock
serialises the build and the load, so two threads that launch a kernel at
once build it once (the engine loads it in its constructor, on the
caller's thread, before a streaming worker starts).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCE = _CSRC / "voting.cu"
_GATES = _CSRC / "gates.cu"
_VOXEL = _CSRC / "voxel.cu"
_GRAPH_COND = _CSRC / "graph_cond.cu"
_TRACE = _CSRC / "trace.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # bins must be bit-equal to the float32 expression of ops/hough.py
    # _vote_bins: no product+sum contraction (the source also spells every
    # operation as a round-to-nearest intrinsic)
    "--fmad=false",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # xs, active, n, c1, c2, nb, half_dx, num_x, nxs, best, key, ub, stream
    "pcs_vote_state": (_P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P),
    # xs, active, n, c1, c2, nb, half_dx, num_x, nxs, out, stream
    "pcs_vote_histogram": (_P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P),
    # xs, n, c1, c2, nb, half_dx, num_x, xi, yi, stream
    "pcs_vote_bins": (_P, _I, _P, _P, _I, _P, _P, _P, _P, _P),
    # xs, removed, n, c1, c2, nb, half_dx, num_x, nxs, key, best, best_d, stream
    "pcs_vote_decrement": (_P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P),
    # xs, active, n, c1, c2, nb, half_dx, num_x, nxs, best, key, ub, m_lb,
    # s_cap, list, over, ran, rows_ran, stream
    "pcs_vote_reexam": (_P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P,
                        _P, _P),
    # is64, xs, p2, active, n, cell, cell64, b0, c1row, c2row, dx, dv, half32,
    # dx32, min_nb_denom, rs, nrs, shift, minvotes, min_pca, rs_max, nxs, keys,
    # m2, nv, flags, out, stream
    "pcs_round_gates": (_I, _P, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                        _P, _I, ctypes.c_double, ctypes.c_double, _I, _P, _P, _P, _P, _P, _P),
    # is64, keys, pts, n, key_limit, n_out, tile_starts, centroids, valid, count,
    # dropped, ran, stream
    "pcs_voxel_sums": (_I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    # stream, flag (one byte on the card), body stream
    "pcs_if_begin": (_P, _P, _P),
    # body stream
    "pcs_if_end": (_P,),
    # out: a new stream
    "pcs_stream_create": (ctypes.POINTER(ctypes.c_void_p),),
    # capturing stream, out: the nodes its graph holds so far
    "pcs_capture_nodes": (_P, ctypes.POINTER(ctypes.c_ulonglong)),
    # rows, counter, n_rows, width, slot, stream
    "pcs_trace_stamp": (_P, _P, _I, _I, _I, _P),
    # rows, counter, n_rows, width, slot, stream
    "pcs_trace_tally": (_P, _P, _I, _I, _I, _P),
    # out (one int64 on the card), stream
    "pcs_trace_now": (_P, _P),
}


class BuildInfo:
    """What the last build did: the library path, the seconds nvcc took
    (0.0 when the library was already there) and ptxas's resource report."""

    path: Path | None = None
    seconds: float = 0.0
    log: str = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the CUDA sources")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library_path(sources: tuple) -> Path:
    h = hashlib.sha256()
    for source in sources:
        h.update(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpcs_voting_{h.hexdigest()[:16]}.so"


_lock = threading.Lock()
_loaded: dict = {}       # source path -> its loaded library, for the process


def load_library(source: Path = _SOURCE) -> ctypes.CDLL:
    """Build (if needed) and load the library; raises on failure.  `source`
    may name another copy of ``voting.cu`` with the same C entries, such as
    an earlier version to time beside this one (built with this
    ``gates.cu``, ``voxel.cu``, ``graph_cond.cu`` and ``trace.cu``)."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = _loaded[source] = _build_and_load(source)
        return lib


def _build_and_load(source: Path) -> ctypes.CDLL:
    sources = (source, _GATES, _VOXEL, _GRAPH_COND, _TRACE)
    path = _library_path(sources)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources)],
                              capture_output=True, text=True)
        BuildInfo.seconds = time.perf_counter() - t0
        BuildInfo.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BuildInfo.log}")
        os.replace(tmp, path)   # atomic: a concurrent build sees old or new
    else:
        BuildInfo.seconds = 0.0
    BuildInfo.path = path
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if source != _SOURCE and not hasattr(lib, name):
            continue                 # an earlier voting.cu, without a later entry
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
