"""Iterative 3D Hough line extraction on torch tensors.

Twin of the JAX package's ops/hough.py, mode for mode: "carry" keeps the
exact (B, NX, NX) accumulator and subtracts each extracted line's inliers;
"lazy" keeps only (best, key, ub) per direction, decrements each best cell by
the removed points' votes and re-examines the directions whose bound could
reach the global max.  The voting itself goes through ops/voting.py: the
CUDA kernels for CUDA tensors, the plain versions for CPU tensors (or for
CUDA tensors, when a caller passes ``voting=PLAIN`` to compare the two).

JAX's ``lax.while_loop``/``switch`` become a host loop.  Each round reads one
scalar (the update branch, which also decides whether the loop goes on) and,
in a lazy incremental round, the suspect count that picks the re-exam tier.

With an `AxisGroup` over the direction axis (the counterpart of the JAX
``dir_axis``) the direction table is one rank's contiguous slice of the
sphere and the cloud is replicated: each round gathers every rank's winner and its table rows in one
``all_gather`` of a few int32 words, and a lazy incremental round gathers the
ranks' best counts once more for the suspect bound.  Everything after the
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

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..config import PipelineConfig
from ..geometry import canonicalize_direction
from ..sphere import hough_space
from .eigh3 import eigvalsh3, principal_eigenvector3
from . import voting as V


class Voting(NamedTuple):
    """The two voting functions extract_lines calls (see ops/voting.py)."""

    vote_state: object
    vote_histogram: object


KERNELS = Voting(V.vote_state, V.vote_histogram)
PLAIN = Voting(V.vote_state_plain, V.vote_histogram_plain)

_VOTE_TILE = 128       # direction tables are padded to a multiple of this
_SUB_CHUNK = 512       # removed-point columns of the incremental update
_SUSPECT_CAP = 2048    # lazy voting: most directions re-examined per round


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


def _line_distance2(pts, a, b_unit):
    # geometry.point_line_distance's op sequence (elementwise-product dots)
    d = pts - a
    along = (d * b_unit[None, :]).sum(-1)
    perp = d - along[:, None] * b_unit[None, :]
    return (perp * perp).sum(-1)


def _masked_scatter(c):
    """c.T @ c of (N, 3) float32 rows, as an elementwise sum: no matrix
    product, so no TF32 question on the card."""
    return (c[:, :, None] * c[:, None, :]).sum(0)


def _masked_lsq(pts, mask):
    """Orthogonal LSQ over masked points: (largest scatter eigenvalue,
    centroid, unit direction).  The eigensolve runs in float32."""
    dt = pts.dtype
    m = mask.to(dt)
    cnt = torch.clamp_min(m.sum(), 1.0)
    mean = (pts * m[:, None]).sum(0) / cnt
    c = torch.where(mask[:, None], pts - mean, 0.0).to(torch.float32)
    rc, bvec = principal_eigenvector3(_masked_scatter(c))
    return rc.to(dt), mean, bvec.to(dt)


def _masked_cov_eigs(pts, mask):
    """Descending covariance eigenvalues over masked points (float32)."""
    dt = pts.dtype
    m = mask.to(dt)
    cnt = torch.clamp_min(m.sum(), 1.0)
    mean = (pts * m[:, None]).sum(0) / cnt
    c = torch.where(mask[:, None], pts - mean, 0.0).to(torch.float32)
    denom = torch.clamp_min(cnt.to(torch.float32) - 1.0, 1.0)
    return eigvalsh3(_masked_scatter(c) / denom).to(dt)


def _pad_dirs_to_tile(dirs, c1, c2):
    """Pad the direction table to a _VOTE_TILE multiple with copies of
    direction 0, which never win the smallest-index tie-break."""
    pad = (-dirs.shape[0]) % _VOTE_TILE
    if pad == 0:
        return dirs, c1, c2
    return tuple(torch.cat([t, t[:1].expand(pad, 3)]) for t in (dirs, c1, c2))


def _compact_removed(Xs, removed, n_rem: int):
    """The n_rem removed points, in index order, as (n_rem, 3) rows.  The one
    compaction that the carry subtract and the lazy decrement share, so both
    bin the removed points identically.  The JAX package pads this to
    _SUB_CHUNK static columns; here n_rem is known on the host (it is read
    with the round's branch), and the dead columns would count nothing."""
    N = removed.shape[0]
    pos = torch.cumsum(removed.to(torch.int32), 0, dtype=torch.int32) - 1
    pos = torch.where(removed & (pos < n_rem), pos, n_rem)
    perm = torch.zeros(n_rem + 1, dtype=torch.int64, device=Xs.device)
    perm.index_copy_(0, pos.to(torch.int64),
                     torch.arange(N, dtype=torch.int64, device=Xs.device))
    return Xs[perm[:n_rem]]


def _removed_cell_keys(Xs, c1, c2, half, dx, num_x, removed, n_rem: int,
                       num_x_static):
    """(B, n_rem) flat cell keys x*NX + y of the removed points, binned by
    ops/voting.vote_bins, the expression the kernels use."""
    xt, yt = V.vote_bins(_compact_removed(Xs, removed, n_rem), c1, c2,
                         half, dx, num_x)
    return xt * num_x_static + yt


def scatter_rows(dst, idx, rows):
    """dst with dst[idx[k]] = rows[k]; an index equal to len(dst) is dropped
    (JAX's `.at[].set(mode="drop")`).  Kept indices must be unique."""
    buf = torch.cat([dst, dst[:1]])
    buf.index_copy_(0, idx.to(torch.int64), rows)
    return buf[:-1]


def _first_true(mask):
    return torch.argmax(mask.to(torch.int8))


def _row(t, i):
    """t[i] for a 0-dim index tensor, without a host read."""
    return t.index_select(0, i.reshape(1))[0]


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
        built from the config when None.
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
        # device scalars: a Python float divisor on a CUDA tensor becomes a
        # reciprocal product, which moves bins and integer truncations
        return torch.full((), v, dtype=dt, device=dev)

    dx = const(cfg.opt_dx)
    dv = const(cfg.diag_voxel)
    min_nb_denom = const(cfg.rad_2_leaf_ratio * (2 * cfg.diag_voxel) ** 2)
    rs = torch.tensor(cfg.radius_sizes, dtype=dt, device=dev)
    rs_max = max(cfg.radius_sizes)

    Xs, shift, d, half, num_x = center_cloud(points, valid, dx)
    Xv, half32, dx32 = vote_inputs(Xs, half, dx)

    degenerate = (valid.sum() == 0) | (d == 0.0)
    dx_too_large = ~degenerate & (dx >= d)
    precheck_fail = degenerate | dx_too_large

    lazy = cfg.voting_mode == "lazy"
    sub_chunk = min(_SUB_CHUNK, N)
    s_cap = max(_VOTE_TILE, (min(B, _SUSPECT_CAP) // _VOTE_TILE) * _VOTE_TILE)
    s_tier = min(s_cap, 2 * _VOTE_TILE)
    it_bound = (max(cfg.shapes.max_iters, cfg.opt_nlines + 1)
                if cfg.opt_nlines > 0 else cfg.shapes.max_iters)

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

    def exam(vs, suspect, cap, active_next):
        """Recompute (best, key, ub) of <= cap suspect directions."""
        best, key, ub = vs
        spos = torch.cumsum(suspect.to(torch.int32), 0, dtype=torch.int32) - 1
        spos = torch.where(suspect, spos, cap).to(torch.int64)
        idx = torch.full((cap + 1,), B, dtype=torch.int64, device=dev)
        idx.index_copy_(0, spos, torch.arange(B, device=dev))
        idx = idx[:cap]
        idx_c = torch.clamp_max(idx, B - 1)
        bs, ks, us = voting.vote_state(Xv, active_next, c1[idx_c].contiguous(),
                                       c2[idx_c].contiguous(), half32, dx32, num_x, NX)
        return (scatter_rows(best, idx, bs), scatter_rows(key, idx, ks),
                scatter_rows(ub, idx, us))

    def vstate_update(vs, branch, m2, n_rem: int, active_next):
        """branch 1 = incremental removal of the n_rem points of m2; 2 = exact
        rebuild (more than sub_chunk points removed)."""
        if branch == 2:
            return vstate_init(active_next)
        if lazy:
            best, key, ub = vs
            keys_r = _removed_cell_keys(Xv, c1, c2, half32, dx32, num_x, m2, n_rem, NX)
            best = best - (keys_r == key[:, None]).sum(dim=1, dtype=torch.int32)
            M_lb = best.max()
            if shard is not None:
                M_lb = shard.max(M_lb)
            suspect = ub >= M_lb                 # other cells could win
            n_sus = int(suspect.sum())           # host read: picks the tier
            if n_sus <= s_tier:
                return exam((best, key, ub), suspect, s_tier, active_next)
            if n_sus <= s_cap:
                return exam((best, key, ub), suspect, s_cap, active_next)
            return vstate_init(active_next)
        votes, _ = vs
        Xr = _compact_removed(Xv, m2, n_rem).contiguous()
        all_live = torch.ones(n_rem, dtype=torch.bool, device=dev)
        vn = votes - voting.vote_histogram(Xr, all_live, c1, c2, half32, dx32,
                                           num_x, NX)
        return vn, vn.amax(dim=(1, 2))

    active = valid & ~precheck_fail
    nlines = torch.zeros((), dtype=torch.int32, device=dev)
    nout = torch.zeros((), dtype=torch.int32, device=dev)
    fail = torch.zeros((), dtype=torch.bool, device=dev)
    segs = empty_segments(L, N, dt, dev)
    slot_iota = torch.arange(L, device=dev)
    P2 = Xs + shift                                   # inliers in input frame

    go = bool(active.sum() > 1)       # the loop's condition at round 0
    vstate = vstate_init(active) if go else None
    it = 0
    while go:
        M, b_win, cell_win = vstate_winner(vstate)
        b0, c1row, c2row = _row(dirs, b_win), _row(c1, b_win), _row(c2, b_win)
        if shard is not None:
            cell_win, b0, c1row, c2row = shard.winner(
                M, b_win + dir_offset, cell_win, b0, c1row, c2row)
        xi = (cell_win // NX).to(torch.float32)
        yi = (cell_win % NX).to(torch.float32)
        xc = (xi + 0.5) * dx32 - half32
        yc = (yi + 0.5) * dx32 - half32
        a0 = (xc * c1row + yc * c2row).to(dt)

        # refinement #1: the direction is renormalised first, as the oracle's
        # points_close_to_line does, and the sqrt'd distance compared to dx
        b0u = b0 / torch.sqrt((b0 * b0).sum())
        m1 = active & (torch.sqrt(_line_distance2(Xs, a0, b0u)) <= dx)
        ok0 = m1.any()
        rc1, a1, b1 = _masked_lsq(Xs, m1)
        ok1 = ok0 & (rc1 > 0.0)

        # refinement #2 + vote gate
        b1u = b1 / torch.sqrt((b1 * b1).sum())
        m2 = active & (torch.sqrt(_line_distance2(Xs, a1, b1u)) <= dx)
        nv = m2.sum().to(torch.int32)
        ok2 = ok1 & (nv >= cfg.opt_minvotes)
        rc2, a2, b2 = _masked_lsq(Xs, m2)
        ok3 = ok2 & (rc2 > 0.0)

        bc = canonicalize_direction(b2)               # D-SIGN
        a_w = a2 + shift

        # per-point t / radius / gaps
        dvec = P2 - a_w
        bb = torch.clamp_min((bc * bc).sum(), 1e-30)
        t_all = (dvec * bc).sum(-1) / bb
        proj = a_w[None, :] + t_all[:, None] * bc[None, :]
        prad = torch.sqrt(torch.clamp_min(((proj - P2) ** 2).sum(-1), 0.0))
        bx_zero = bc[0] == 0.0                        # find_t failure
        t = (proj[:, 0] - a_w[0]) / torch.where(bx_zero, 1.0, bc[0])

        # gap check over t-sorted order; the stable sort gives the same
        # adjacent-gap maximum as the JAX package's rank-matrix form
        tv = torch.where(m2, t, torch.inf)
        pn_all = torch.sqrt(((a_w[None, :] + t[:, None] * bc[None, :]) ** 2).sum(-1))
        order = torch.sort(tv, stable=True).indices
        pn_s = pn_all[order]
        pair_ok = (torch.arange(1, N, device=dev)) < nv
        gaps = torch.where(pair_ok, torch.abs(pn_s[1:] - pn_s[:-1]), -torch.inf)
        max_gap = torch.where(nv > 1, gaps.max(), 0.0) if N > 1 else \
            torch.zeros((), dtype=dt, device=dev)

        ifirst = _first_true(m2)
        ilast = N - 1 - _first_true(m2.flip(0))
        radius = torch.maximum(_row(prad, ifirst), _row(prad, ilast))

        t_min = torch.where(m2, t, torch.inf).min()
        t_max = torch.where(m2, t, -torch.inf).max()
        t_min = torch.where(nv > 0, t_min, 0.0)
        t_max = torch.where(nv > 0, t_max, 0.0)

        # acceptance gates
        diffs = torch.abs(radius - rs)
        k = torch.argmin(diffs)                       # first strict min
        closest = _row(rs, k)
        min_diff = _row(diffs, k)
        max_radius = torch.clamp_min(diffs[0], rs_max)   # reference quirk h:298-307
        gate_r = (min_diff < dv) & (max_radius <= closest) & (max_gap < 2.0 * dv)

        eig = _masked_cov_eigs(P2, m2)
        pca_coeff = eig[0] / torch.clamp_min(eig.sum(), 1e-30)
        # the oracle's form: endpoints first, then the difference
        p1g = t_min * bc + a_w
        p2g = t_max * bc + a_w
        seg_len = torch.sqrt(((p2g - p1g) ** 2).sum())
        min_nb = (2.0 * closest * seg_len / min_nb_denom).to(torch.int32)
        accept = gate_r & (pca_coeff > cfg.min_pca_coeff) & (nv > min_nb)

        failx = ok3 & bx_zero
        proceed = ok3 & ~bx_zero
        write = proceed & accept & (nout < L)
        sel = (slot_iota == nout) & write

        def upd(arr, val):
            s = sel.reshape((L,) + (1,) * (arr.dim() - 1))
            return torch.where(s, val, arr)

        segs = SegmentBatch(
            a=upd(segs.a, a_w), b=upd(segs.b, bc),
            t_min=upd(segs.t_min, t_min), t_max=upd(segs.t_max, t_max),
            radius=upd(segs.radius, closest),
            points_size=upd(segs.points_size, nv),
            pca_coeff=upd(segs.pca_coeff, pca_coeff),
            pca_eigenvalues=upd(segs.pca_eigenvalues, eig),
            point_mask=upd(segs.point_mask, m2),
            valid=upd(segs.valid, True))

        active_next = active & ~m2
        # skip the update when this round is the last: the loop is about to
        # exit and nothing reads the voting state after it
        ending = (active_next.sum() <= 1) | (it + 1 >= it_bound)
        if cfg.opt_nlines > 0:
            ending = ending | (nlines + ok3.to(torch.int32) >= cfg.opt_nlines)
        branch_t = torch.where(proceed & ~ending,
                               torch.where(nv <= sub_chunk, 1, 2), 0)

        nlines = nlines + ok3.to(torch.int32)      # counts gate failures (h:259)
        nout = nout + write.to(torch.int32)
        fail = fail | failx
        active = torch.where(proceed, active_next, active)
        it += 1

        # The next round runs exactly when this round proceeded and is not
        # the last one, i.e. when branch != 0 (host read, once per round).
        branch, n_rem = torch.stack([branch_t, nv]).tolist()
        go = branch != 0
        if go:
            vstate = vstate_update(vstate, branch, m2, n_rem, active_next)

    nlines = torch.where(fail, 0, nlines).to(torch.int32)
    status = torch.where(degenerate, 1,
                         torch.where(dx_too_large, 2,
                                     torch.where(fail, 3, 0))).to(torch.int32)
    return HoughResult(segments=segs, nlines=nlines, status=status)
