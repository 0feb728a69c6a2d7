"""The voting layer: vote bins, the lazy voting state and the vote histogram.

Each wrapper holds its CUDA launch (``csrc/voting.cu``) and its plain PyTorch
version.  A tensor on the CPU takes the plain version; a CUDA tensor launches
the kernel or raises.  There is no fallback from one to the other.  Each
wrapper counts its kernel launches in a plain integer attribute
(``vote_state.launches``, ``vote_histogram.launches``), so a run can show that
it went through the kernels.

Shapes and types at every public function:
  Xs (N, 3) float32 shifted coordinates; active (N,) bool;
  c1, c2 (B, 3) float32 plane bases; half, dx 0-dim float32 tensors;
  num_x 0-dim int32 tensor; num_x_static a Python int (NX).

The bins are float32 by spec in both compute types.  In the float64 parity
mode the caller (ops/hough.py) hands every function here one contiguous
float32 copy of the centred cloud and float32 ``half`` and ``dx``, so the
kernels and their plain versions see the same values; there is no float64
kernel, and a float64 tensor on the card is refused, not converted.
"""

from __future__ import annotations

import torch

_TILE = 128                # directions per tile of the plain versions

# The kernels' shared-memory budget (csrc/voting.cu): one histogram of
# 16-bit counts, padded to 16 bytes, beside a staging chunk of 256 points
# (12 bytes each) and 1 KB of static shared memory must fit in one Hopper
# block's 232,448 bytes.
_SHARED_BYTES = 232_448
MAX_NX = max(n for n in range(1, 512)
             if ((n * n + 1) // 2 + 3) // 4 * 16 + 256 * 12 + 1_024 <= _SHARED_BYTES)
_MAX_POINTS = 65_535       # a 16-bit count holds at most this many votes


def vote_bins(Xs, c1, c2, half, dx, num_x):
    """(B, N) int32 xi and yi bins: the twin of ops/hough.py `_vote_bins`.

    float32 with the fixed association order (c0*x0 + c1*x1) + c2*x2.  `half`
    and `dx` must be tensors on the points' device: on a CUDA tensor PyTorch
    turns a division by a Python float into a product with its reciprocal,
    which moves bins.
    """
    x0, x1, x2 = Xs[:, 0][None, :], Xs[:, 1][None, :], Xs[:, 2][None, :]
    xp = (c1[:, 0:1] * x0 + c1[:, 1:2] * x1) + c1[:, 2:3] * x2
    yp = (c2[:, 0:1] * x0 + c2[:, 1:2] * x1) + c2[:, 2:3] * x2
    hi = (num_x - 1).to(torch.int32)
    xi = torch.minimum(torch.floor((xp + half) / dx).to(torch.int32).clamp_min(0), hi)
    yi = torch.minimum(torch.floor((yp + half) / dx).to(torch.int32).clamp_min(0), hi)
    return xi, yi


def _tile_counts(Xa, c1t, c2t, half, dx, num_x, nxs):
    """(T, NX*NX) int64 counts of one tile of directions over the active
    points Xa (plain version).  A point binned at or beyond NX is dropped,
    as the one-hot histogram of the JAX package drops it."""
    cells = nxs * nxs
    T = c1t.shape[0]
    xi, yi = vote_bins(Xa, c1t, c2t, half, dx, num_x)
    keep = (xi < nxs) & (yi < nxs)
    t = torch.arange(T, device=Xa.device, dtype=torch.int64)[:, None]
    keys = t * cells + xi.to(torch.int64) * nxs + yi.to(torch.int64)
    keys = torch.where(keep, keys, T * cells)          # sentinel bin, dropped
    counts = torch.bincount(keys.reshape(-1), minlength=T * cells + 1)
    return counts[: T * cells].reshape(T, cells)


def _state_of(counts):
    """(best, key, ub) of (T, cells) counts: key is the first max, ub the max
    over every other cell (-1 when there is none), as ops/hough.py:279-282."""
    best = counts.max(dim=1).values
    key = torch.argmax((counts == best[:, None]).to(torch.int8), dim=1)
    iota = torch.arange(counts.shape[1], device=counts.device)
    ub = torch.where(iota[None, :] == key[:, None], -1, counts).max(dim=1).values
    return best.to(torch.int32), key.to(torch.int32), ub.to(torch.int32)


def vote_state_plain(Xs, active, c1, c2, half, dx, num_x, num_x_static):
    Xa = Xs[active]
    outs = [_state_of(_tile_counts(Xa, c1[i:i + _TILE], c2[i:i + _TILE],
                                   half, dx, num_x, num_x_static))
            for i in range(0, c1.shape[0], _TILE)]
    if not outs:
        z = torch.zeros(0, dtype=torch.int32, device=Xs.device)
        return z, z, z
    return tuple(torch.cat(parts) for parts in zip(*outs))


def vote_histogram_plain(Xs, active, c1, c2, half, dx, num_x, num_x_static):
    nxs = num_x_static
    Xa = Xs[active]
    parts = [_tile_counts(Xa, c1[i:i + _TILE], c2[i:i + _TILE],
                          half, dx, num_x, nxs)
             for i in range(0, c1.shape[0], _TILE)]
    if not parts:
        return torch.zeros((0, nxs, nxs), dtype=torch.int32, device=Xs.device)
    return torch.cat(parts).to(torch.int32).reshape(-1, nxs, nxs)


def _check_cuda_args(Xs, active, c1, c2, half, dx, num_x, num_x_static):
    dev = Xs.device
    for name, t in (("Xs", Xs), ("active", active), ("c1", c1), ("c2", c2),
                    ("half", half), ("dx", dx), ("num_x", num_x)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, Xs on {dev}")
    if Xs.dtype != torch.float32 or Xs.dim() != 2 or Xs.shape[1] != 3:
        raise ValueError(f"Xs must be (N, 3) float32, got {tuple(Xs.shape)} {Xs.dtype}")
    if active.dtype != torch.bool or active.shape != (Xs.shape[0],):
        raise ValueError("active must be (N,) bool")
    for name, c in (("c1", c1), ("c2", c2)):
        if c.dtype != torch.float32 or c.dim() != 2 or c.shape[1] != 3:
            raise ValueError(f"{name} must be (B, 3) float32")
    if c1.shape != c2.shape:
        raise ValueError("c1 and c2 must have the same shape")
    if half.dtype != torch.float32 or dx.dtype != torch.float32:
        raise ValueError("half and dx must be float32")
    if half.numel() != 1 or dx.numel() != 1 or num_x.numel() != 1:
        raise ValueError("half, dx and num_x must hold one value each")
    if num_x.dtype != torch.int32:
        raise ValueError("num_x must be int32")
    for name, t in (("Xs", Xs), ("active", active), ("c1", c1), ("c2", c2)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if num_x_static is None:   # bins only: no histogram, no count
        return
    if not 1 <= num_x_static <= MAX_NX:
        raise ValueError(
            f"num_x_static={num_x_static}: a {num_x_static}x{num_x_static} histogram "
            f"of 16-bit counts beside a 256-point staging chunk does not fit in "
            f"one block's shared memory ({_SHARED_BYTES} bytes); the largest is "
            f"{MAX_NX}")
    if Xs.shape[0] > _MAX_POINTS:
        raise ValueError(
            f"{Xs.shape[0]} points: the kernels count in 16 bits, so N must stay "
            f"below 65,536")


def _launch_args(Xs, half, dx, num_x):
    half_dx = torch.stack([half.reshape(()), dx.reshape(())]).contiguous()
    nx = num_x.reshape(1).contiguous()
    stream = torch.cuda.current_stream(Xs.device).cuda_stream
    return half_dx, nx, stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def vote_state(Xs, active, c1, c2, half, dx, num_x, num_x_static):
    """Per-direction (best count, first flat cell at it, max count over every
    other cell), each (B,) int32: the values of ops/hough.py
    `_vote_state_tiles`.  The flat cell is x*NX + y."""
    if not Xs.is_cuda:
        return vote_state_plain(Xs, active, c1, c2, half, dx, num_x, num_x_static)
    from .._build import load_library

    _check_cuda_args(Xs, active, c1, c2, half, dx, num_x, num_x_static)
    B, N = c1.shape[0], Xs.shape[0]
    best, key, ub = (torch.empty(B, dtype=torch.int32, device=Xs.device)
                     for _ in range(3))
    half_dx, nx, stream = _launch_args(Xs, half, dx, num_x)
    err = load_library().pcs_vote_state(
        Xs.data_ptr(), active.data_ptr(), N, c1.data_ptr(), c2.data_ptr(), B,
        half_dx.data_ptr(), nx.data_ptr(), num_x_static,
        best.data_ptr(), key.data_ptr(), ub.data_ptr(), stream)
    _raise_on(err, "vote_state")
    vote_state.launches += 1
    return best, key, ub


vote_state.launches = 0


def vote_histogram(Xs, active, c1, c2, half, dx, num_x, num_x_static):
    """(B, NX, NX) int32 exact vote counts of the active points: the values of
    ops/hough.py `_vote_histogram` (and, on gathered points, of
    `_vote_histogram_delta`) and of `vote_histogram_pallas`."""
    if not Xs.is_cuda:
        return vote_histogram_plain(Xs, active, c1, c2, half, dx, num_x,
                                    num_x_static)
    from .._build import load_library

    _check_cuda_args(Xs, active, c1, c2, half, dx, num_x, num_x_static)
    B, N = c1.shape[0], Xs.shape[0]
    out = torch.empty((B, num_x_static, num_x_static), dtype=torch.int32,
                      device=Xs.device)
    half_dx, nx, stream = _launch_args(Xs, half, dx, num_x)
    err = load_library().pcs_vote_histogram(
        Xs.data_ptr(), active.data_ptr(), N, c1.data_ptr(), c2.data_ptr(), B,
        half_dx.data_ptr(), nx.data_ptr(), num_x_static, out.data_ptr(), stream)
    _raise_on(err, "vote_histogram")
    vote_histogram.launches += 1
    return out


vote_histogram.launches = 0


def vote_bins_kernel(Xs, c1, c2, half, dx, num_x):
    """The kernels' own bins, (B, N) int32 each, for holding them against
    `vote_bins` on the card.  CUDA tensors only; the main path never calls
    it, and it counts no launches."""
    if not Xs.is_cuda:
        raise ValueError("vote_bins_kernel needs CUDA tensors")
    from .._build import load_library

    active = torch.ones(Xs.shape[0], dtype=torch.bool, device=Xs.device)
    _check_cuda_args(Xs, active, c1, c2, half, dx, num_x, None)
    B, N = c1.shape[0], Xs.shape[0]
    xi = torch.empty((B, N), dtype=torch.int32, device=Xs.device)
    yi = torch.empty_like(xi)
    half_dx, nx, stream = _launch_args(Xs, half, dx, num_x)
    err = load_library().pcs_vote_bins(
        Xs.data_ptr(), N, c1.data_ptr(), c2.data_ptr(), B, half_dx.data_ptr(),
        nx.data_ptr(), xi.data_ptr(), yi.data_ptr(), stream)
    _raise_on(err, "vote_bins")
    return xi, yi
