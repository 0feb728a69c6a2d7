"""Builds the CUDA sources under ``csrc/`` with nvcc and loads them with ctypes.

The library has a plain C interface (no PyTorch headers), so nvcc builds it
in seconds.  It is built at first use into ``build/torch_kernels/`` beside the
package, keyed by a hash of the source and the flags, so an unchanged source
is built once per checkout.  Nothing here runs at import time.  One lock
serialises the build and the load, so two threads that launch a kernel at
once build it once (the engine loads it in its constructor, on the caller's
thread, before a streaming worker starts).
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
                           "the voting kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libpcs_voting_{h.hexdigest()[:16]}.so"


_lock = threading.Lock()
_loaded: dict = {}       # source path -> its loaded library, for the process


def load_library(source: Path = _SOURCE) -> ctypes.CDLL:
    """Build (if needed) and load the voting library; raises on failure.
    `source` may name another copy of ``voting.cu`` with the same C entries,
    such as an earlier version to time beside this one."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = _loaded[source] = _build_and_load(source)
        return lib


def _build_and_load(source: Path) -> ctypes.CDLL:
    path = _library_path(source)
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        BuildInfo.seconds = time.perf_counter() - t0
        BuildInfo.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BuildInfo.log}")
        os.replace(tmp, path)   # atomic: a concurrent build sees old or new
    BuildInfo.path = path
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
