"""The voting layer: vote bins, the lazy voting state, its decrement and its
suspect re-exam, and the vote histogram.

Each wrapper holds its CUDA launch (``csrc/voting.cu``) and its plain PyTorch
version.  A tensor on the CPU takes the plain version; a CUDA tensor launches
the kernel or raises.  There is no fallback from one to the other.  Each
wrapper counts its kernel launches in a plain integer attribute
(``vote_state.launches``, ``vote_histogram.launches``,
``vote_decrement.launches``, ``vote_reexam.launches``), so a run can show
that it went through the kernels.  The gates kernel of ops/gates.py
(``round_gates``) and the voxel grid's of ops/preproc.py (``voxel_sums``)
are counted here too, in `COUNTED`.

A wrapper's counts, two figures apart:
  * ``launches``: launches issued, those recorded into a CUDA graph counted
    once a replay (the graph's owner, pipeline.FrameStep, adds them; while
    a stream captures, a launch adds to ``captured`` instead);
  * `ran_launches(fn)`: the launches that ran on the card, each of which
    voted.  Inside a conditional node of a graph (ops/hough.py `run_if`) a
    launch runs only when the node's flag holds, which only the card knows,
    so each launch adds one to a device counter of its own, beside the
    kernel, in the graph too (the re-exam's kernel adds to its own, and
    to `reexamined_rows()`, the rows it re-examined).
`reset_counts()` sets them to 0, the device counter in place (``captured``
stays: it describes graphs already made).  The device counters of a card
exist before a graph is captured on it (`prepare_counts`).

Shapes and types at every public function:
  Xs (N, 3) float32 shifted coordinates; active (N,) bool;
  c1, c2 (B, 3) float32 plane bases; half, dx 0-dim float32 tensors;
  num_x 0-dim int32 tensor; num_x_static a Python int (NX); the decrement's
  removed (N,) bool and key, best (B,) int32; the re-exam's best, key, ub
  (B,) int32, rewritten in place.

The bins are float32 by spec in both compute types.  In the float64 parity
mode the caller (ops/hough.py) hands every function here one contiguous
float32 copy of the centred cloud and float32 ``half`` and ``dx``, so the
kernels and their plain versions see the same values; there is no float64
kernel, and a float64 tensor on the card is refused, not converted.
"""

from __future__ import annotations

import torch

from .gates import round_gates
from .preproc import voxel_sums

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


def _compact_removed(Xs, removed, n_rem, sub_chunk: int):
    """Gather the removed points into `sub_chunk` rows, in index order, with
    the JAX package's fixed width: returns (Xr (sub_chunk, 3), col_live
    (sub_chunk,) bool), col_live = arange(sub_chunk) < n_rem, where n_rem is
    the removed count (a 0-dim device tensor, or an int).  A dead column
    holds point 0.  The one compaction that the carry subtract and the lazy
    decrement's plain version share, so both bin the removed points
    identically.

    A removed point past sub_chunk (n_rem > sub_chunk: the round takes the
    rebuild and discards this) is placed in the sentinel column sub_chunk,
    which is cut off: JAX drops an out-of-range scatter index, where
    `index_copy_` on a card would fault."""
    N = removed.shape[0]
    dev = Xs.device
    pos = torch.cumsum(removed.to(torch.int32), 0, dtype=torch.int32) - 1
    pos = torch.where(removed, torch.clamp_max(pos, sub_chunk), sub_chunk)
    perm = torch.zeros(sub_chunk + 1, dtype=torch.int64, device=dev)
    perm.index_copy_(0, pos.to(torch.int64), torch.arange(N, dtype=torch.int64, device=dev))
    col_live = torch.arange(sub_chunk, device=dev) < n_rem
    return Xs[perm[:sub_chunk]], col_live


def _removed_cell_keys(Xs, c1, c2, half, dx, num_x, removed, n_rem, sub_chunk: int,
                       num_x_static):
    """(B, sub_chunk) flat cell keys x*NX + y of the removed points, binned by
    `vote_bins`, the expression the kernels use; a dead column holds the
    sentinel NX*NX, which matches no direction's key."""
    Xr, col_live = _compact_removed(Xs, removed, n_rem, sub_chunk)
    xt, yt = vote_bins(Xr, c1, c2, half, dx, num_x)
    keys = xt * num_x_static + yt
    return torch.where(col_live[None, :], keys, num_x_static * num_x_static)


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


def pinned(device) -> torch.device:
    """`device` with its index: "cuda" is the current card, as a tensor made
    there reports it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _tables():
    """Every device-counter table: each counted wrapper's launches, the rows
    the re-exam re-examined and the voxels the voxel grid dropped."""
    return [fn.counts for fn in COUNTED] + [vote_reexam.rows, voxel_sums.dropped]


def prepare_counts(device) -> None:
    """Every device counter on `device`, made now if missing: a counter made
    inside a capture would be the graph's, refilled with 0 at every
    replay."""
    device = pinned(device)
    for table in _tables():
        if device not in table:
            table[device] = torch.zeros((), dtype=torch.int64, device=device)


def _counter(fn, table, device) -> torch.Tensor:
    """fn's device counter in `table` on `device`, made now outside a capture."""
    counts = table.get(device)
    if counts is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{fn.__name__}: a launch captured on {device} before "
                               f"its counters were made; call prepare_counts first")
        prepare_counts(device)
        counts = table[device]
    return counts


def _count(fn, device, on_card: bool = False) -> None:
    """One launch of fn's kernel on `device`, or one captured into a graph
    (see the module's docstring): the device counter gains 1 when it runs,
    from an add beside the launch, or from the kernel itself (`on_card`)."""
    counts = _counter(fn, fn.counts, device)
    if not on_card:
        counts.add_(1)
    if torch.cuda.is_current_stream_capturing():
        fn.captured += 1
    else:
        fn.launches += 1


def ran_launches(fn, table=None) -> int:
    """fn's launches that ran since the last `reset_counts()` (or the sum of
    another of its device-counter tables).  Reads the card (after a
    synchronise of each device counted on)."""
    total = 0
    for dev, t in (fn.counts if table is None else table).items():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        total += int(t)
    return total


def reexamined_rows() -> int:
    """The rows the re-exam re-examined (ran) since the last `reset_counts()`.
    Reads the card, as `ran_launches`."""
    return ran_launches(vote_reexam, vote_reexam.rows)


def reset_counts() -> None:
    """Every counted wrapper's launch counts to 0, the device counters in
    place, so a captured graph goes on adding to them."""
    for fn in COUNTED:
        fn.launches = 0
    for table in _tables():
        for t in table.values():
            t.zero_()


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
    _count(vote_state, Xs.device)
    return best, key, ub


vote_state.launches = vote_state.captured = 0
vote_state.counts = {}      # device -> 0-dim int64: the launches that ran


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
    _count(vote_histogram, Xs.device)
    return out


vote_histogram.launches = vote_histogram.captured = 0
vote_histogram.counts = {}


def vote_decrement_plain(Xs, removed, c1, c2, half, dx, num_x, num_x_static, key, best,
                         out=None):
    n_rem = int(removed.sum())           # host read: the width
    keys_r = _removed_cell_keys(Xs, c1, c2, half, dx, num_x, removed, n_rem, n_rem,
                                num_x_static)
    best_d = best - (keys_r == key[:, None]).sum(dim=1, dtype=torch.int32)
    return best_d if out is None else out.copy_(best_d)


def vote_decrement(Xs, removed, c1, c2, half, dx, num_x, num_x_static, key, best,
                   out=None):
    """(B,) int32: each direction's best count less the votes the removed
    points cast in its best cell, the flat cell `key` (x*NX + y), as the
    lazy increment of ops/hough.py and of the JAX package computes it.
    Written into `out` when given, which may be `best` itself (in place)."""
    if not Xs.is_cuda:
        return vote_decrement_plain(Xs, removed, c1, c2, half, dx, num_x, num_x_static,
                                    key, best, out)
    from .._build import load_library

    _check_cuda_args(Xs, removed, c1, c2, half, dx, num_x, None)
    B, N = c1.shape[0], Xs.shape[0]
    _check_rows(Xs, B, key=key, best=best)
    if not 1 <= num_x_static <= MAX_NX:
        raise ValueError(f"num_x_static={num_x_static} must lie in [1, {MAX_NX}]")
    if out is not None:
        _check_rows(Xs, B, out=out)
    best_d = torch.empty_like(best) if out is None else out
    half_dx, nx, stream = _launch_args(Xs, half, dx, num_x)
    err = load_library().pcs_vote_decrement(
        Xs.data_ptr(), removed.data_ptr(), N, c1.data_ptr(), c2.data_ptr(), B,
        half_dx.data_ptr(), nx.data_ptr(), num_x_static, key.data_ptr(), best.data_ptr(),
        best_d.data_ptr(), stream)
    _raise_on(err, "vote_decrement")
    _count(vote_decrement, Xs.device)
    return best_d


vote_decrement.launches = vote_decrement.captured = 0
vote_decrement.counts = {}


def _check_rows(Xs, B, **rows) -> None:
    """Each named tensor a contiguous (B,) int32 tensor on the points' card."""
    for name, t in rows.items():
        if (t.device != Xs.device or t.dtype != torch.int32 or t.shape != (B,)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({B},) int32 tensor on {Xs.device}")


def vote_reexam_plain(Xs, active, c1, c2, half, dx, num_x, num_x_static, best, key, ub,
                      s_cap, m_lb=None):
    suspect = ub >= (best.max() if m_lb is None else m_lb)
    rows = torch.nonzero(suspect).flatten()          # host read: the count
    over = rows.numel() > s_cap
    if not over and rows.numel():
        state = vote_state_plain(Xs, active, c1[rows].contiguous(), c2[rows].contiguous(),
                                 half, dx, num_x, num_x_static)
        for dst, src in zip((best, key, ub), state):
            dst[rows] = src
    return torch.tensor(over, device=best.device)


def vote_reexam(Xs, active, c1, c2, half, dx, num_x, num_x_static, best, key, ub, s_cap,
                m_lb=None):
    """The lazy increment's suspect re-exam, in place.  (best, key, ub) are a
    table's decremented state, (B,) int32 each; M_lb is the largest best
    (or `m_lb`, a 0-dim int32 tensor: a sharded table's maximum over its
    ranks).  Each direction with ub >= M_lb (a cell other than its key could
    now hold the maximum) gets the (best, key, ub) that `vote_state` gives it
    over the `active` points, written into its row; the others keep theirs.
    More than `s_cap` such directions and no row changes.  Returns that
    overflow as a 0-dim bool tensor (the caller then rebuilds the table):
    the values of the JAX package's tiered `lax.switch` of the lazy
    increment.  On the card the count of suspects never leaves it."""
    if not Xs.is_cuda:
        return vote_reexam_plain(Xs, active, c1, c2, half, dx, num_x, num_x_static,
                                 best, key, ub, s_cap, m_lb)
    from .._build import load_library

    _check_cuda_args(Xs, active, c1, c2, half, dx, num_x, num_x_static)
    B, N = c1.shape[0], Xs.shape[0]
    _check_rows(Xs, B, best=best, key=key, ub=ub)
    if not 1 <= s_cap <= B:
        raise ValueError(f"s_cap={s_cap} must lie in [1, {B}]")
    if m_lb is not None and (m_lb.device != Xs.device or m_lb.dtype != torch.int32
                             or m_lb.numel() != 1):
        raise ValueError(f"m_lb must be one int32 value on {Xs.device}")
    dev = pinned(Xs.device)
    listed = torch.empty(s_cap + 1, dtype=torch.int32, device=Xs.device)
    over = torch.empty((), dtype=torch.bool, device=Xs.device)
    ran = _counter(vote_reexam, vote_reexam.counts, dev)
    rows_ran = _counter(vote_reexam, vote_reexam.rows, dev)
    half_dx, nx, stream = _launch_args(Xs, half, dx, num_x)
    err = load_library().pcs_vote_reexam(
        Xs.data_ptr(), active.data_ptr(), N, c1.data_ptr(), c2.data_ptr(), B,
        half_dx.data_ptr(), nx.data_ptr(), num_x_static, best.data_ptr(), key.data_ptr(),
        ub.data_ptr(), None if m_lb is None else m_lb.contiguous().data_ptr(), s_cap,
        listed.data_ptr(), over.data_ptr(), ran.data_ptr(), rows_ran.data_ptr(), stream)
    _raise_on(err, "vote_reexam")
    _count(vote_reexam, dev, on_card=True)
    return over


vote_reexam.launches = vote_reexam.captured = 0
vote_reexam.counts = {}
vote_reexam.rows = {}       # device -> 0-dim int64: the rows re-examined

# the wrappers whose launches are counted: the voting kernels', a Hough
# round's gates kernel (ops/gates.py) and the voxel grid's (ops/preproc.py)
COUNTED = (vote_state, vote_histogram, vote_decrement, vote_reexam, round_gates, voxel_sums)


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
