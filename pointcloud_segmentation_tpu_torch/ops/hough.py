"""Iterative 3D Hough line extraction on torch tensors.

Twin of the JAX package's ops/hough.py, mode for mode: "carry" keeps the
exact (B, NX, NX) accumulator and subtracts each extracted line's inliers;
"lazy" keeps only (best, key, ub) per direction, decrements each best cell by
the removed points' votes (one kernel, `vote_decrement`) and re-examines the
directions whose bound could reach the global max (one kernel,
`vote_reexam`).  The voting itself goes through ops/voting.py, and each
round's gates (winner's line, refinements, acceptance tests) through
ops/gates.py: the CUDA kernels for CUDA tensors, the plain versions for CPU
tensors (or for CUDA tensors, when a caller passes ``voting=PLAIN`` to
compare the two).

The loop is the JAX package's: one function, `_round`, is the body of the
JAX ``lax.while_loop``, masked by a device flag ``live`` (the loop's
condition), so a round that is not live changes nothing.  `round_count(cfg)`
rounds are issued, each inside `run_if` on its ``live`` flag, and each
``lax.switch`` branch of the update (keep / increment or subtract / rebuild,
and the lazy re-exam's overflow into a rebuild) inside a nested `run_if` on
its own flag, so only the rounds and branches the JAX program runs issue
their ops.  While a
CUDA graph is captured (pipeline.make_process_frame) each `run_if` is a
conditional node, the device deciding at replay; anywhere else (the CPU, or
the card outside a capture: the host-driven engine, the plain voting
functions, whose bincount reads the host, and a shard, whose collectives
are not captured) it reads its flag on the host, which is the node's
meaning.  The loop state lives in tensors made before the first node, and
each body writes its results into them; the carry subtract compacts the
removed points to a fixed `_SUB_CHUNK` columns with a live-column mask,
since a shape is fixed at capture (the lazy decrement reads the removed
mask itself).

With an `AxisGroup` over the direction axis (the counterpart of the JAX
``dir_axis``) the direction table is one rank's contiguous slice of the
sphere and the cloud is replicated: each round gathers every rank's winner and its table rows in one
``all_gather`` of a few int32 words, and a lazy incremental round gathers
the ranks' best counts once more for the suspect bound.  Everything after the
winner is computed from replicated tensors, so every rank takes the same
branches and makes the same collectives.

The float type follows the points': float32, or float64 in the parity mode
(``compute_dtype="float64"``).  In both, the stages that are float32 by spec
stay float32, as in the numpy oracle: the vote bins (the plane bases c1/c2,
``half = d/2`` and ``dx``, each computed in the points' type and then cast,
and one float32 copy of the centred cloud, which kernel, plain version,
re-exam, rebuild and decrement all bin), the decoded cell centre, and the
scatter and covariance eigensolves.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import trace
from ..config import PipelineConfig
from ..sphere import hough_space
from . import gates as G
from . import voting as V
from .gates import _first_true, _row
from .voting import _compact_removed


class Voting(NamedTuple):
    """The voting functions extract_lines calls (see ops/voting.py), and a
    round's gates (ops/gates.py).  A caller that names only the first two
    gets the decrement, gates and re-exam kernels."""

    vote_state: object
    vote_histogram: object
    vote_decrement: object = V.vote_decrement
    round_gates: object = G.round_gates
    vote_reexam: object = V.vote_reexam


KERNELS = Voting(V.vote_state, V.vote_histogram, V.vote_decrement, G.round_gates,
                 V.vote_reexam)
PLAIN = Voting(V.vote_state_plain, V.vote_histogram_plain, V.vote_decrement_plain,
               G.round_gates_plain, V.vote_reexam_plain)

_VOTE_TILE = 128       # direction tables are padded to a multiple of this
_SUB_CHUNK = 512       # removed-point columns of the incremental update
_SUSPECT_CAP = 2048    # lazy voting: most directions re-examined per round
# the tracer's per-frame counts of the update's branches (trace.tally): the
# rounds that took the increment (carry subtract, lazy decrement), those
# that rebuilt the voting state, and the lazy increments whose suspects
# overflowed the re-exam into a rebuild
TALLIES = ("hough.increment_rounds", "hough.rebuild_rounds",
           "hough.suspect_overflow_rounds")


class SegmentBatch(NamedTuple):
    """Fixed-capacity per-frame extracted segments (structure of arrays)."""

    a: torch.Tensor            # (L, 3)
    b: torch.Tensor            # (L, 3)
    t_min: torch.Tensor        # (L,)
    t_max: torch.Tensor        # (L,)
    radius: torch.Tensor       # (L,)
    points_size: torch.Tensor  # (L,) int32
    pca_coeff: torch.Tensor    # (L,)
    pca_eigenvalues: torch.Tensor  # (L, 3)
    point_mask: torch.Tensor   # (L, N) bool
    valid: torch.Tensor        # (L,) bool

    @property
    def capacity(self) -> int:
        return self.a.shape[0]


class HoughResult(NamedTuple):
    segments: SegmentBatch
    nlines: torch.Tensor       # int32 — nblines_extracted (0 on frame abort)
    status: torch.Tensor       # int32: 0 ok, 1 degenerate, 2 dx>=d, 3 b.x==0


def pick_winner(gathered: torch.Tensor) -> torch.Tensor:
    """The winning rank's row of (ranks, K) int32 rows ``[M, b, cell, ...]``:
    the largest vote count M, and among the ranks at it the smallest global
    direction index b, as the oracle's flat argmax breaks ties (the ranks'
    direction ranges are disjoint, so that rank is unique and its cell is
    already its direction's smallest).  Twin of the JAX package's
    `_global_argmax_winner`; like it, this never forms ``b * cells + cell``,
    which overflows int32 once directions times cells pass 2^31 (granularity
    6 with a radius near 0.012)."""
    M_all, b_all = gathered[:, 0], gathered[:, 1]
    bkey = torch.where(M_all == M_all.max(), b_all, torch.iinfo(torch.int32).max)
    return _row(gathered, _first_true(bkey == bkey.min()))


class AxisGroup:
    """One rank's place on one axis of a mesh: the axis's process group, the
    rank in it and the group's size.  On the direction axis it is the `shard`
    that `extract_lines` takes, and every collective of the sharded
    extraction is this class's `all_gather`; on the batch axis it gathers the
    frames' segments (parallel/sharding.py).

    via_host: the group's backend moves CPU tensors only (gloo, which ranks
    sharing one card use, since NCCL refuses two ranks on one GPU): the few
    words of a gather are copied to the host, gathered there and copied back.
    The group's timeout (set where it is made, parallel.make_mesh) bounds
    every call, so ranks that disagree fail instead of waiting for ever."""

    def __init__(self, group, rank: int, size: int, via_host: bool = False):
        self.group, self.rank, self.size, self.via_host = group, rank, size, via_host
        self.collectives = 0      # gathers made so far

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(K,) on every rank -> (size, K), rank r's words in row r."""
        self.collectives += 1
        src = t.cpu() if self.via_host else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.size)]
        dist.all_gather(parts, src, group=self.group)
        return torch.stack(parts).to(t.device)

    def winner(self, M, b_global, cell, b0, c1row, c2row):
        """The global winner's (cell, direction, c1 row, c2 row) from each
        rank's own.  The rows travel as their bit patterns, so a -0.0 stays
        -0.0 (a masked float sum would make it +0.0) and n ranks give one
        rank's bits."""
        nb = b0.view(torch.int32).numel()        # 3 words, 6 in float64
        words = torch.cat([
            torch.stack([M, b_global, cell]).to(torch.int32),
            b0.view(torch.int32), c1row.view(torch.int32), c2row.view(torch.int32)])
        row = pick_winner(self.all_gather(words))
        return (row[2], row[3:3 + nb].clone().view(b0.dtype),
                row[3 + nb:6 + nb].clone().view(torch.float32),
                row[6 + nb:9 + nb].clone().view(torch.float32))

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The maximum over the ranks of a 0-dim tensor."""
        return self.all_gather(t.reshape(1)).max()


def empty_segments(L: int, N: int, dtype=torch.float32, device=None) -> SegmentBatch:
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return SegmentBatch(
        a=z(L, 3), b=z(L, 3), t_min=z(L), t_max=z(L), radius=z(L),
        points_size=z(L, dt=torch.int32), pca_coeff=z(L),
        pca_eigenvalues=z(L, 3), point_mask=z(L, N, dt=torch.bool),
        valid=z(L, dt=torch.bool))


def direction_tables(granularity: int, device, dtype=torch.float32) -> tuple:
    """(dirs, c1, c2) of the direction sphere (sphere.hough_space): dirs in
    `dtype`, straight from the float64 table; the plane bases c1 and c2 are
    float32 by spec."""
    dirs, c1, c2 = hough_space(granularity)
    return (torch.tensor(dirs, dtype=dtype, device=device),
            torch.tensor(c1, dtype=torch.float32, device=device),
            torch.tensor(c2, dtype=torch.float32, device=device))


def _masked_minmax(points, valid):
    p_min = torch.where(valid[:, None], points, torch.inf).amin(dim=0)
    p_max = torch.where(valid[:, None], points, -torch.inf).amax(dim=0)
    return p_min, p_max


def _pad_dirs_to_tile(dirs, c1, c2):
    """Pad the direction table to a _VOTE_TILE multiple with copies of
    direction 0, which never win the smallest-index tie-break."""
    pad = (-dirs.shape[0]) % _VOTE_TILE
    if pad == 0:
        return dirs, c1, c2
    return tuple(torch.cat([t, t[:1].expand(pad, 3)]) for t in (dirs, c1, c2))


def scatter_rows(dst, idx, rows):
    """dst with dst[idx[k]] = rows[k]; an index equal to len(dst) is dropped
    (JAX's `.at[].set(mode="drop")`).  Kept indices must be unique."""
    buf = torch.cat([dst, dst[:1]])
    buf.index_copy_(0, idx.to(torch.int64), rows)
    return buf[:-1]


_BODY_DEPTH = 4            # nested run_if bodies a capture may hold
_body_streams: dict = {}   # device -> the streams that capture bodies, one a depth
_capture_lock = threading.Lock()
_capturing = threading.local()   # .capture: this thread's CondCapture, if any


class CondCapture:
    """One capture's conditional nodes: the body streams of its card, the
    nesting depth of the body being captured, `nodes`, the conditional nodes
    added so far, and `graph_nodes`, the nodes of the bodies captured so far
    (the capturer adds the graph's own, `captured_nodes`, before it ends)."""

    def __init__(self, device, streams):
        self.device, self.streams = device, streams
        self.depth = self.nodes = self.graph_nodes = 0


def captured_nodes(stream) -> int:
    """The nodes of the graph `stream` is capturing so far, an IF node
    counting one (csrc/graph_cond.cu)."""
    from .._build import load_library

    n = ctypes.c_ulonglong()
    err = load_library().pcs_capture_nodes(stream.cuda_stream, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"counting a capture's nodes failed (error {err})")
    return n.value


def _streams_of(device) -> list:
    """The body streams of `device`, made at its first capture.  They are the
    library's own (csrc/graph_cond.cu), never PyTorch's pooled ones, which
    `torch.cuda.Stream()` hands out round-robin: one of those would in time
    be the stream that captures the frame (a frame step's), and a capture
    cannot begin on a stream that is already capturing."""
    from .._build import load_library

    streams = _body_streams.get(device)
    if streams is None:
        lib = load_library()
        streams = []
        with torch.cuda.device(device):
            for _ in range(_BODY_DEPTH):
                handle = ctypes.c_void_p()
                err = lib.pcs_stream_create(ctypes.byref(handle))
                if err != 0:
                    raise RuntimeError(f"cudaStreamCreate failed ({err})")
                streams.append(torch.cuda.ExternalStream(handle.value, device=device))
        _body_streams[device] = streams
    return streams


@contextlib.contextmanager
def cond_capture(graph, stream, capture_error_mode: str):
    """``torch.cuda.graph(graph, stream=stream, ...)`` with a memory pool of
    its own, for code whose `run_if` calls become conditional nodes of the
    graph; yields the capture's `CondCapture`.

    The body streams are shared by the card's captures, so one such capture
    runs at a time in the process: the lock is taken before the capture
    begins, and two engines whose streaming workers capture their first
    frames at once take turns.

    A body's tensors come from the graph's pool, as the frame's others do.
    A body is captured on a body stream, which the pool's own filter (this
    capture's streams) does not take, so the pool takes every allocation of
    this thread until the capture ends, which removes the filter; the pool's
    extra reference is released on the way out.  This leans on private
    allocator calls (``torch._C._cuda_*Pool``) and on their order against
    `torch.cuda.graph`'s own capture end; a card test frees a captured
    step and sees its pool returned."""
    device = V.pinned(stream.device)
    index = device.index
    with _capture_lock:
        cap = CondCapture(device, _streams_of(device))
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.graph(graph, pool=pool, stream=stream,
                              capture_error_mode=capture_error_mode):
            torch._C._cuda_endAllocateToPool(index, pool)
            torch._C._cuda_beginAllocateCurrentThreadToPool(index, pool)
            _capturing.capture = cap
            try:
                yield cap
            finally:
                _capturing.capture = None
                torch._C._cuda_releasePool(index, pool)


def run_if(flag, body) -> None:
    """``body()`` where the 0-dim bool `flag` holds: the one place that knows
    about conditional nodes.  While this thread captures a CUDA graph in
    `cond_capture`, the body is captured into an IF node of that graph
    (csrc/graph_cond.cu): at replay the card reads the flag and runs the
    body or skips it.  Anywhere else (the CPU, or the card outside a
    capture) the flag is read on the host and the body run or skipped
    there.  A body returns nothing: what it makes, it writes into tensors
    made before the node."""
    if flag.device.type != "cuda" or not torch.cuda.is_current_stream_capturing():
        if bool(flag):                  # host read
            body()
        return
    from .._build import load_library

    cap = getattr(_capturing, "capture", None)
    if cap is None or cap.device != flag.device:
        raise RuntimeError(f"run_if: a capture on {flag.device} outside cond_capture")
    if cap.depth == _BODY_DEPTH:
        raise RuntimeError(f"run_if: more than {_BODY_DEPTH} nested bodies")
    stream = cap.streams[cap.depth]
    lib = load_library()
    outer = torch.cuda.current_stream(flag.device)
    pred = flag.reshape(()).to(torch.bool)
    err = lib.pcs_if_begin(outer.cuda_stream, pred.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"run_if: adding the conditional node failed (error {err}: "
                           f"-1 is a stream not capturing, else a CUDA error)")
    cap.nodes += 1
    cap.depth += 1
    try:
        with torch.cuda.stream(stream):
            body()
        cap.graph_nodes += captured_nodes(stream)
    finally:
        cap.depth -= 1
        err = lib.pcs_if_end(stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"run_if: ending the body's capture failed (CUDA error {err})")


def center_cloud(points, valid, dx):
    """The frame's voting inputs: (Xs (N, 3) cloud shifted to its bbox centre
    with invalid rows zeroed, shift (3,), bbox diagonal d, half = d/2, grid
    size num_x int32).  dx is a 0-dim tensor on the points' device."""
    count_in = valid.sum()
    p_min, p_max = _masked_minmax(points, valid)
    g = p_max - p_min
    # one fixed order, elementwise: (x² + y²) + z², as the numpy oracle (a
    # reduction's order is unspecified, and d sets every bin)
    d = torch.sqrt(torch.clamp_min((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2], 0.0))
    d = torch.where(count_in > 0, d, 0.0)
    shift = torch.where(count_in > 0, (p_min + p_max) / 2.0, 0.0)
    Xs = torch.where(valid[:, None], points - shift, 0.0).contiguous()
    num_x = torch.clamp_min(torch.floor(d / dx + 0.5).to(torch.int32), 1)
    return Xs, shift, d, d / 2.0, num_x


def vote_inputs(Xs, half, dx):
    """The float32-by-spec inputs of the voting layer and of the cell decode,
    from `center_cloud`'s outputs in the pipeline's type: one contiguous
    float32 copy of the centred cloud, and `half` and `dx` cast after being
    computed in that type.  No-ops in float32."""
    return (Xs.to(torch.float32).contiguous(), half.to(torch.float32),
            dx.to(torch.float32))


class _LoopState(NamedTuple):
    """What one round of the extraction hands the next (the JAX package's
    `_LoopState`, with its `stop` folded into `live`)."""

    it: torch.Tensor          # int32: rounds run so far
    active: torch.Tensor      # (N,) bool
    vstate: tuple             # carry: (votes (B, NX, NX), row_max (B,));
                              # lazy: (best (B,), key (B,), ub (B,))
    nlines: torch.Tensor      # int32
    nout: torch.Tensor        # int32: segments written
    fail: torch.Tensor        # bool: the b.x == 0 abort
    segs: SegmentBatch
    live: torch.Tensor        # bool: this round runs (the JAX loop's cond)


def _loop_tensors(s: _LoopState) -> list:
    """The tensors of a loop state but its voting state, in field order."""
    return [s.it, s.active, s.nlines, s.nout, s.fail, *s.segs, s.live]


def iteration_bound(cfg: PipelineConfig) -> int:
    """The JAX loop's `it_bound`: with opt_nlines > 0 every round either adds
    one to nlines or ends the loop, so opt_nlines + 1 is itself a bound and
    shapes.max_iters must not cut a larger opt_nlines short."""
    return (max(cfg.shapes.max_iters, cfg.opt_nlines + 1)
            if cfg.opt_nlines > 0 else cfg.shapes.max_iters)


def round_count(cfg: PipelineConfig) -> int:
    """The rounds the loop issues: every round that lets the next
    one run has proceeded (ok3) and so added one to nlines, and a round runs
    only while nlines < opt_nlines, so at most opt_nlines rounds run when
    opt_nlines > 0 (10 at the shipped config); else the iteration bound.
    tests/test_torch_graph_loop.py holds a frame to it."""
    it_bound = iteration_bound(cfg)
    return min(it_bound, cfg.opt_nlines) if cfg.opt_nlines > 0 else it_bound


def extract_lines(points: torch.Tensor, valid: torch.Tensor,
                  cfg: PipelineConfig, dir_tables: tuple | None = None,
                  voting: Voting = KERNELS,
                  shard: AxisGroup | None = None) -> HoughResult:
    """Run the iterative Hough extraction on one pre-filtered cloud.

    Args:
      points: (N, 3) float32 or float64 cloud (drone frame, post voxel grid);
        its type is the type of every stage that is not float32 by spec.
      valid:  (N,) bool validity mask.
      cfg: the pipeline config; its voting_mode picks carry or lazy.
      dir_tables: (dirs, c1, c2) on the points' device, as
        `direction_tables(granularity, device, points.dtype)` gives them;
        built from the config when None (which a graph capture cannot do:
        it copies the table from the host).
      voting: the voting functions, KERNELS (default) or PLAIN.
      shard: None for one rank.  Else `dir_tables` is this rank's slice of
        the table (every rank's of one length, as parallel/sharding.py cuts it),
        `points` and `valid` are the same on every rank, and every rank of
        the shard's group makes this call together.
    """
    dev = points.device
    N = points.shape[0]
    L = cfg.max_lines
    dt = points.dtype
    if dir_tables is None:
        if shard is not None:
            raise ValueError("a sharded extraction needs its rank's dir_tables")
        dir_tables = direction_tables(cfg.granularity, dev, dt)
    if dir_tables[0].dtype != dt:
        # a float64 run must not take its directions through float32
        raise ValueError(f"direction table is {dir_tables[0].dtype}, the cloud "
                         f"{dt}: build it with direction_tables(g, device, {dt})")
    if dir_tables[1].dtype != torch.float32 or dir_tables[2].dtype != torch.float32:
        raise ValueError("the plane bases c1 and c2 must be float32")
    dirs, c1, c2 = _pad_dirs_to_tile(*dir_tables)
    B = dirs.shape[0]
    # global index of this rank's first direction, after tile padding
    dir_offset = shard.rank * B if shard is not None else 0
    NX = cfg.num_x_max
    cells = NX * NX

    def const(v):
        # device scalars made on the device (a fill, which a graph captures):
        # a Python float divisor on a CUDA tensor becomes a reciprocal
        # product, which moves bins and integer truncations
        return torch.full((), v, dtype=dt, device=dev)

    dx = const(cfg.opt_dx)
    dv = const(cfg.diag_voxel)
    min_nb_denom = const(cfg.rad_2_leaf_ratio * (2 * cfg.diag_voxel) ** 2)
    rs = torch.stack([const(r) for r in cfg.radius_sizes])
    rs_max = max(cfg.radius_sizes)

    Xs, shift, d, half, num_x = center_cloud(points, valid, dx)
    Xv, half32, dx32 = vote_inputs(Xs, half, dx)

    degenerate = (valid.sum() == 0) | (d == 0.0)
    dx_too_large = ~degenerate & (dx >= d)
    precheck_fail = degenerate | dx_too_large

    lazy = cfg.voting_mode == "lazy"
    sub_chunk = min(_SUB_CHUNK, N)
    s_cap = max(_VOTE_TILE, (min(B, _SUSPECT_CAP) // _VOTE_TILE) * _VOTE_TILE)
    it_bound = iteration_bound(cfg)

    def vstate_init(active0):
        if lazy:
            return voting.vote_state(Xv, active0, c1, c2, half32, dx32, num_x, NX)
        v0 = voting.vote_histogram(Xv, active0, c1, c2, half32, dx32, num_x, NX)
        return v0, v0.amax(dim=(1, 2))

    def vstate_winner(vs):
        """(M, b_win, cell_win) of this rank's max; the first max is the
        smallest (b, xi, yi), as the oracle's flat argmax."""
        if lazy:
            best, key, _ = vs
            M = best.max()
            b_win = _first_true(best == M)
            return M, b_win, _row(key, b_win)
        votes, row_max = vs
        M = row_max.max()
        b_win = _first_true(row_max == M)
        cell_win = _first_true(_row(votes, b_win).reshape(cells) == M)
        return M, b_win, cell_win

    def store(dst, src):
        """A body's results into the loop's tensors."""
        for d, x in zip(dst, src):
            d.copy_(x)

    def vstate_update(vs, branch, m2, n_rem, active_next):
        """The JAX `lax.switch(branch, [keep, increment/subtract, rebuild])`
        with each branch, and the lazy re-exam's overflow, in a `run_if` node
        of its own, writing the new state into `vs` in place: branch 0 keeps
        the state (the loop is ending), 1 removes the n_rem points of m2
        incrementally, 2 rebuilds it from active_next (more than sub_chunk
        points removed).  Only the branch taken issues its ops, kernels and
        the carry compaction included."""
        inc, rebuild = branch == 1, branch == 2

        def rebuild_state(tally=TALLIES[1]):
            trace.tally(tally)
            store(vs, vstate_init(active_next))

        if lazy:
            def increment():
                # each direction's best count less the removed points' votes
                # in its best cell, in place (one kernel); then the directions
                # whose bound could still reach the new maximum re-examined
                # in place (one kernel: their count never leaves the card),
                # or, past s_cap of them, the overflow flag (the last branch
                # of the JAX tiered `lax.switch`)
                trace.tally(TALLIES[0])
                best, key, ub = vs
                voting.vote_decrement(Xv, m2, c1, c2, half32, dx32, num_x, NX, key, best,
                                      best)
                m_lb = None if shard is None else shard.max(best.max())
                run_if(voting.vote_reexam(Xv, active_next, c1, c2, half32, dx32, num_x, NX,
                                          best, key, ub, s_cap, m_lb),
                       lambda: rebuild_state(TALLIES[2]))

            run_if(inc, increment)
            run_if(rebuild, rebuild_state)
            return
        votes, row_max = vs

        def subtract():
            trace.tally(TALLIES[0])
            Xr, col_live = _compact_removed(Xv, m2, n_rem, sub_chunk)
            votes.sub_(voting.vote_histogram(Xr.contiguous(), col_live, c1, c2, half32,
                                             dx32, num_x, NX))
            row_max.copy_(votes.amax(dim=(1, 2)))

        run_if(inc, subtract)
        run_if(rebuild, rebuild_state)

    slot_iota = torch.arange(L, device=dev)
    P2 = Xs + shift                                   # inliers in input frame

    def _round(s: _LoopState, rnd: int):
        """Round `rnd` of the JAX loop's body, masked by s.live: a round that
        is not live changes nothing.  Returns the next state; the update
        writes the voting state `s.vstate` in place, and the next state
        holds those same tensors."""
        M, b_win, cell_win = vstate_winner(s.vstate)
        b0, c1row, c2row = _row(dirs, b_win), _row(c1, b_win), _row(c2, b_win)
        if shard is not None:
            cell_win, b0, c1row, c2row = shard.winner(
                M, b_win + dir_offset, cell_win, b0, c1row, c2row)
        g = voting.round_gates(Xs, P2, s.active, cell_win, b0, c1row, c2row, dx, dv,
                               half32, dx32, min_nb_denom, rs, shift, cfg.opt_minvotes,
                               cfg.min_pca_coeff, rs_max, NX)
        trace.stamp("round[{}].gates.end", rnd)

        m2, nv, ok3 = g.m2, g.nv, g.ok3
        failx = s.live & ok3 & g.bx_zero
        proceed = s.live & ok3 & ~g.bx_zero
        write = proceed & g.accept & (s.nout < L)
        sel = (slot_iota == s.nout) & write

        def upd(arr, val):
            m = sel.reshape((L,) + (1,) * (arr.dim() - 1))
            return torch.where(m, val, arr)

        segs = s.segs
        segs = SegmentBatch(
            a=upd(segs.a, g.a_w), b=upd(segs.b, g.bc),
            t_min=upd(segs.t_min, g.t_min), t_max=upd(segs.t_max, g.t_max),
            radius=upd(segs.radius, g.closest),
            points_size=upd(segs.points_size, nv),
            pca_coeff=upd(segs.pca_coeff, g.pca_coeff),
            pca_eigenvalues=upd(segs.pca_eigenvalues, g.eig),
            point_mask=upd(segs.point_mask, m2),
            valid=upd(segs.valid, True))

        counted = (s.live & ok3).to(torch.int32)   # nlines counts gate failures (h:259)
        active_next = s.active & ~m2
        # The JAX loop's cond for the next round: this round proceeded and is
        # not the last.  The update is skipped (branch 0) in a last round, as
        # nothing reads the voting state after it.
        ending = (active_next.sum() <= 1) | (s.it + 1 >= it_bound)
        if cfg.opt_nlines > 0:
            ending = ending | (s.nlines + counted >= cfg.opt_nlines)
        live_next = proceed & ~ending
        branch = torch.where(live_next, torch.where(nv <= sub_chunk, 1, 2), 0)
        trace.stamp("round[{}].vote.begin", rnd)
        vstate_update(s.vstate, branch, m2, nv, active_next)
        return _LoopState(
            it=s.it + s.live.to(torch.int32),
            active=torch.where(proceed, active_next, s.active),
            vstate=s.vstate,
            nlines=s.nlines + counted,
            nout=s.nout + write.to(torch.int32),
            fail=s.fail | failx,
            segs=segs,
            live=live_next)

    active0 = valid & ~precheck_fail
    live0 = active0.sum() > 1          # the loop's condition at round 0
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def start(vstate):
        return _LoopState(it=zero, active=active0, vstate=vstate, nlines=zero,
                          nout=zero, fail=torch.zeros((), dtype=torch.bool, device=dev),
                          segs=empty_segments(L, N, dt, dev), live=live0)

    # the loop's tensors, made before the first node; each node's body
    # writes into them
    if lazy:
        vs = tuple(torch.zeros(B, dtype=torch.int32, device=dev) for _ in range(3))
    else:
        vs = (torch.zeros((B, NX, NX), dtype=torch.int32, device=dev),
              torch.zeros(B, dtype=torch.int32, device=dev))
    s = start(vs)
    s = s._replace(**{f: getattr(s, f).clone()          # one tensor each
                      for f in ("it", "active", "nlines", "nout", "live")})
    run_if(live0, lambda: store(vs, vstate_init(active0)))
    trace.stamp("hough.init.end")

    def one_round():
        # run_if runs its body at once: `rnd` is the loop's round
        trace.stamp("round[{}].begin", rnd)
        nxt = _round(s, rnd)
        store(_loop_tensors(s), _loop_tensors(nxt))
        trace.stamp("round[{}].end", rnd)

    for rnd in range(round_count(cfg)):
        run_if(s.live, one_round)

    nlines = torch.where(s.fail, 0, s.nlines).to(torch.int32)
    status = torch.where(degenerate, 1,
                         torch.where(dx_too_large, 2,
                                     torch.where(s.fail, 3, 0))).to(torch.int32)
    return HoughResult(segments=s.segs, nlines=nlines, status=status)
