"""Persistent world-map state on torch tensors: segment fusion and pairwise
intersections.

Twin of the JAX package's worldmap.py.  Each frame's segments are matched
against the FRAME-START world set, so the similarity and candidate fusion
of all L frame segments against all S world slots is one batched (L, S)
computation; the order-dependent slot bookkeeping is closed form (append
slots by an exclusive prefix sum, repeated fuses into one slot resolved so
that the last writer wins).  Intersections are one (S, S) component-plane
Cramer solve, and stale entries persist until overwritten.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import PipelineConfig
from .ops.hough import SegmentBatch, scatter_rows


class WorldState(NamedTuple):
    """World segment store + intersection matrix (field names as in the JAX
    package's WorldState, so checkpoints carry across)."""

    a: torch.Tensor               # (S, 3)
    b: torch.Tensor               # (S, 3)  (not necessarily unit after fusion)
    t_min: torch.Tensor           # (S,)
    t_max: torch.Tensor           # (S,)
    radius: torch.Tensor          # (S,)
    points_size: torch.Tensor     # (S,) int32
    pca_coeff: torch.Tensor       # (S,)
    pca_eigenvalues: torch.Tensor  # (S, 3)
    valid: torch.Tensor           # (S,) bool
    count: torch.Tensor           # 0-dim int32
    inter: torch.Tensor           # (S, S, 2), sentinel (-1, -1)

    @property
    def capacity(self) -> int:
        return self.a.shape[0]


def init_world(cfg: PipelineConfig, device, dtype=None) -> WorldState:
    """An empty world map on `device`; its float type is `dtype`, or the
    config's compute_dtype when None."""
    if dtype is None:
        dtype = torch.float64 if cfg.compute_dtype == "float64" else torch.float32
    S = cfg.shapes.max_world_segments

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return WorldState(
        a=z(S, 3), b=z(S, 3), t_min=z(S), t_max=z(S), radius=z(S),
        points_size=z(S, dt=torch.int32), pca_coeff=z(S),
        pca_eigenvalues=z(S, 3), valid=z(S, dt=torch.bool),
        count=z(dt=torch.int32),
        inter=torch.full((S, S, 2), -1.0, dtype=dtype, device=device))


def _endpoints(a, b, t_min, t_max):
    return t_min[..., None] * b + a, t_max[..., None] * b + a


def _proj_onto(a, b, p):
    """Project p onto line(s) a + t*b (broadcasting); safe for b == 0."""
    bb = torch.clamp_min((b * b).sum(-1), 1e-30)
    t = ((p - a) * b).sum(-1) / bb
    return a + t[..., None] * b


_FUSE_KEYS = ("a", "b", "t_min", "t_max", "radius", "points_size",
              "pca_coeff", "pca_eigenvalues")


def _similarity_one(cfg: PipelineConfig, d: dict, w: dict):
    """checkSimilarity of drone segments against world slots (node.cpp:
    596-667).  `d` holds (L, ...) fields, `w` (S, ...) fields; returns
    (sim (L, S), fused dict of (L, S, ...)).  With L = 1 it is the JAX
    package's `_similarity_one` for one drone segment."""
    w_p1, w_p2 = _endpoints(w["a"], w["b"], w["t_min"], w["t_max"])  # (S, 3)
    d_p1 = (d["t_min"][:, None] * d["b"] + d["a"])[:, None, :]       # (L, 1, 3)
    d_p2 = (d["t_max"][:, None] * d["b"] + d["a"])[:, None, :]
    wa, wb = w["a"][None], w["b"][None]                              # (1, S, 3)

    proj1 = _proj_onto(wa, wb, d_p1)                                 # (L, S, 3)
    proj2 = _proj_onto(wa, wb, d_p2)

    d_rad = d["radius"][:, None]
    eps = d_rad + w["radius"][None] + 2.0 * (2.0 * cfg.diag_voxel)
    dist1 = torch.sqrt(torch.clamp_min(((proj1 - d_p1) ** 2).sum(-1), 0.0))
    dist2 = torch.sqrt(torch.clamp_min(((proj2 - d_p2) ** 2).sum(-1), 0.0))
    cond1 = (dist1 < eps) & (dist2 < eps) & (d_rad == w["radius"][None])

    # D-WEIGHT: real-valued ratio
    ft = w["pca_coeff"].dtype
    d_ps = d["points_size"][:, None]
    wt = d_ps.to(ft) / torch.clamp_min((w["points_size"][None] + d_ps).to(ft), 1.0)
    wt = torch.clamp_min(wt, cfg.min_weight)
    d_pca = d["pca_coeff"][:, None]
    denom = w["pca_coeff"][None] * (1.0 - wt) + d_pca * wt
    coeff = (d_pca * wt) / torch.where(denom != 0, denom, 1.0)

    new_a = proj1 + coeff[..., None] * (d_p1 - proj1)
    new_b = (proj2 - proj1) + coeff[..., None] * ((d_p2 - proj2) - (d_p1 - proj1))

    # t of the 4 endpoint projections on the candidate line, x-division quirk
    def t_of(p):
        pp = _proj_onto(new_a, new_b, p)
        bx = new_b[..., 0]
        return (pp[..., 0] - new_a[..., 0]) / torch.where(bx != 0, bx, torch.nan)

    t1, t2 = t_of(d_p1), t_of(d_p2)
    t3, t4 = t_of(w_p1[None]), t_of(w_p2[None])
    finite = (torch.isfinite(t1) & torch.isfinite(t2)
              & torch.isfinite(t3) & torch.isfinite(t4))
    no_overlap = (torch.minimum(t1, t2) > torch.maximum(t3, t4)) | (
        torch.maximum(t1, t2) < torch.minimum(t3, t4))
    sim = cond1 & finite & ~no_overlap

    ts = torch.stack([t1, t2, t3, t4], dim=-1)
    fused = {
        "a": new_a,
        "b": new_b,
        "t_min": torch.where(finite, ts.amin(-1), 0.0),
        "t_max": torch.where(finite, ts.amax(-1), 0.0),
        "radius": d_rad.expand(sim.shape),
        # D-FUSE: blend against the world segment's fields
        "points_size": w["points_size"][None] + d_ps,
        "pca_coeff": w["pca_coeff"][None] * (1.0 - wt) + d_pca * wt,
        "pca_eigenvalues": (w["pca_eigenvalues"][None] * (1.0 - wt[..., None])
                            + d["pca_eigenvalues"][:, None, :] * wt[..., None]),
    }
    return sim, fused


def _drop_flags(S, idx, device):
    """(S,) bool, True at idx; idx == S is dropped."""
    buf = torch.zeros(S + 1, dtype=torch.bool, device=device)
    buf.index_fill_(0, idx.to(torch.int64), True)
    return buf[:S]


def fuse_frame(state: WorldState, segs: SegmentBatch, cfg: PipelineConfig):
    """First-match-wins fusion of a frame's segments against the frame-start
    world set.  Returns (new fields dict, count, valid, modified (S,) bool,
    new_flags (S,) bool, slots (L,) int32)."""
    S = state.capacity
    L = segs.capacity
    dev = state.a.device

    old = {k: getattr(state, k) for k in _FUSE_KEYS}
    d_all = {k: getattr(segs, k) for k in _FUSE_KEYS}
    sim_all, fused_all = _similarity_one(cfg, d_all, old)         # (L, S)
    sim_all = sim_all & state.valid[None, :]

    dvalid = segs.valid
    found = sim_all.any(dim=1) & dvalid
    j = torch.argmax(sim_all.to(torch.int8), dim=1).to(torch.int32)  # first match

    # appends: an exclusive prefix sum below S reproduces the sequential count
    append_flag = dvalid & ~found
    inc = append_flag.to(torch.int32)
    counts_before = state.count + torch.cumsum(inc, 0, dtype=torch.int32) - inc
    can_append = append_flag & (counts_before < S)
    k = torch.clamp_max(counts_before, S - 1)
    count = state.count + can_append.sum().to(torch.int32)

    slot = torch.where(found, j, torch.where(can_append, k, -1)).to(torch.int32)
    write = found | can_append

    # two frame segments fused into one slot: the last writer wins
    ii = torch.arange(L, device=dev)
    later_same = ((slot[None, :] == slot[:, None]) & (ii[None, :] > ii[:, None])
                  & write[None, :])
    winner = write & ~later_same.any(dim=1)
    tgt = torch.where(winner, slot, S)

    new = {}
    for key in _FUSE_KEYS:
        fused_rows = fused_all[key][ii, j.to(torch.int64)]         # (L,) / (L, 3)
        f = found if fused_rows.dim() == 1 else found[:, None]
        new[key] = scatter_rows(old[key], tgt, torch.where(f, fused_rows, d_all[key]))

    modified = _drop_flags(S, torch.where(found, j, S), dev)
    new_flags = _drop_flags(S, torch.where(can_append, k, S), dev)
    valid = state.valid | new_flags
    return new, count, valid, modified, new_flags, slot


def fuse_frame_sequential(state: WorldState, segs: SegmentBatch,
                          cfg: PipelineConfig):
    """The literal sequential fusion loop (node.cpp:491-510 semantics), twin
    of the JAX package's `fuse_frame_sequential`: the executable spec that
    `fuse_frame` is held against bit for bit.  Not on the main path.  Every
    decision is a `torch.where` on a device flag; nothing reads the host.
    Same return as `fuse_frame`."""
    S = state.capacity
    L = segs.capacity
    dev = state.a.device

    old = {k: getattr(state, k) for k in _FUSE_KEYS}
    old_valid = state.valid
    new = dict(old)
    count = state.count
    modified = torch.zeros(S, dtype=torch.bool, device=dev)
    new_flags = torch.zeros(S, dtype=torch.bool, device=dev)
    slots = torch.full((L,), -1, dtype=torch.int32, device=dev)

    iota = torch.arange(S, device=dev)

    def set_row(arr, at, row):
        """arr with arr[s] = row where the (S,) bool `at` is set."""
        return torch.where(at.reshape((S,) + (1,) * (arr.dim() - 1)), row, arr)

    for i in range(L):
        d = {k: getattr(segs, k)[i:i + 1] for k in _FUSE_KEYS}
        dvalid = segs.valid[i]
        sim, fused = _similarity_one(cfg, d, old)   # match vs frame-start world
        sim = sim[0] & old_valid
        found = sim.any() & dvalid
        j = torch.argmax(sim.to(torch.int8))
        at_j = (iota == j) & found                  # fuse in place at j

        can_append = dvalid & ~found & (count < S)  # or append at `count`
        k = torch.clamp_max(count, S - 1)
        at_k = (iota == k) & can_append

        for key in _FUSE_KEYS:
            # row s of fused[key][0] is the fusion with world slot s
            new[key] = set_row(set_row(new[key], at_j, fused[key][0]),
                               at_k, d[key][0])
        modified = modified | at_j
        new_flags = new_flags | at_k
        slots[i] = torch.where(found, j, torch.where(can_append, k, -1))
        count = count + can_append.to(torch.int32)
    valid = old_valid | new_flags
    return new, count, valid, modified, new_flags, slots


def update_intersections(state_fields: dict, valid, inter_old, touched,
                         cfg: PipelineConfig):
    """Batched checkConnections over touched pairs (node.cpp:519-537,
    554-584).  Pair (i, j), j < i: seg_i plays `drone_seg`, seg_j plays
    `world_seg`.  Written on (S, S) component planes in the JAX package's
    operation order."""
    a, b = state_fields["a"], state_fields["b"]
    t_min, t_max = state_fields["t_min"], state_fields["t_max"]
    radius = state_fields["radius"]
    S = a.shape[0]
    dev = a.device

    p1 = t_min[:, None] * b + a
    p1x, p1y, p1z = p1[:, 0], p1[:, 1], p1[:, 2]

    def pair_planes(u):
        return u[:, None], u[None, :]               # value at seg_i / seg_j

    bix, bjx = pair_planes(b[:, 0])
    biy, bjy = pair_planes(b[:, 1])
    biz, bjz = pair_planes(b[:, 2])

    # cross[i, j] = b_j x b_i
    cx = bjy * biz - bjz * biy
    cy = bjz * bix - bjx * biz
    cz = bjx * biy - bjy * bix
    cn = torch.sqrt(torch.clamp_min((cx * cx + cy * cy) + cz * cz, 0.0))
    parallel = cn < 1e-2
    cns = torch.clamp_min(cn, 1e-30)
    nx, ny, nz = cx / cns, cy / cns, cz / cns       # nhat

    i_idx = torch.arange(S, device=dev)[:, None]
    j_idx = torch.arange(S, device=dev)[None, :]
    pair = ((j_idx < i_idx) & valid[:, None] & valid[None, :]
            & (touched[:, None] | touched[None, :]) & ~parallel)

    # Cramer solve of [b_i, -b_j, nhat] [t_i, t_j, d]^T = p1_j - p1_i
    rx = p1x[None, :] - p1x[:, None]
    ry = p1y[None, :] - p1y[:, None]
    rz = p1z[None, :] - p1z[:, None]

    # c12 = (-b_j) x nhat
    c12x = (-bjy) * nz - (-bjz) * ny
    c12y = (-bjz) * nx - (-bjx) * nz
    c12z = (-bjx) * ny - (-bjy) * nx
    det = (bix * c12x + biy * c12y) + biz * c12z
    ok = pair & (det != 0.0)
    inv = torch.where(ok, 1.0, torch.nan) / torch.where(det != 0.0, det, 1.0)
    x0 = ((rx * c12x + ry * c12y) + rz * c12z) * inv
    # c20 = nhat x b_i
    c20x = ny * biz - nz * biy
    c20y = nz * bix - nx * biz
    c20z = nx * biy - ny * bix
    x1 = ((rx * c20x + ry * c20y) + rz * c20z) * inv
    # c01 = b_i x (-b_j)
    c01x = biy * (-bjz) - biz * (-bjy)
    c01y = biz * (-bjx) - bix * (-bjz)
    c01z = bix * (-bjy) - biy * (-bjx)
    x2 = ((rx * c01x + ry * c01y) + rz * c01z) * inv

    dist = torch.abs(x2)
    tmin_i, tmax_i = t_min[:, None], t_max[:, None]
    tmin_j, tmax_j = t_min[None, :], t_max[None, :]
    eps = 2.0 * cfg.diag_voxel + radius[:, None] + radius[None, :]
    in_i = (x0 + tmin_i >= tmin_i) & (x0 + tmin_i <= tmax_i)
    in_j = (x1 + tmin_j >= tmin_j) & (x1 + tmin_j <= tmax_j)
    finite = torch.isfinite(x0) & torch.isfinite(x1) & torch.isfinite(x2)
    conn = pair & in_i & in_j & (dist < eps) & finite

    vals = torch.stack([tmin_i + x0, tmin_j + x1], dim=-1)
    # write only on connection; stale entries persist (node.cpp:531-534)
    return torch.where(conn[..., None], vals, inter_old)


def world_step(state: WorldState, segs: SegmentBatch, cfg: PipelineConfig):
    """One segFiltering pass: fuse the frame's segments, refresh
    intersections.  Returns (state, slots (L,) int32, -1 = dropped)."""
    fields, count, valid, modified, new_flags, slots = fuse_frame(state, segs, cfg)
    inter = update_intersections(fields, valid, state.inter, modified | new_flags, cfg)
    return WorldState(valid=valid, count=count, inter=inter, **fields), slots
