"""The gates of one Hough round: from the winning cell to the acceptance
tests, the part of ops/hough.py `_round` between ``round[r].begin`` and
``round[r].gates.end``.

From the winner's cell and direction: the first distance mask about the
cell's line and its least-squares line, the inlier mask about that line and
its least-squares line, the canonical direction, each inlier's t, the
largest gap between t-adjacent inliers, the radius gate, the PCA and length
gates (the JAX package's `_round`, pointcloud_segmentation_tpu/ops/hough.py).

`round_gates` launches one CUDA kernel a round (``csrc/gates.cu``,
`pcs_round_gates`) on CUDA tensors and raises on what it does not take;
`round_gates_plain` is the same chain in plain PyTorch ops, which a CPU
tensor takes (and a caller may ask for on the card, to compare the two).
The kernel's launches are counted as the voting kernels' are
(ops/voting.py: ``launches``, ``captured``, `ran_launches`).

Types at both functions: Xs, P2 (N, 3), b0 (3,), dx, dv, min_nb_denom 0-dim,
rs (R,) and shift (3,) in the points' type (float32, or float64 in the parity
mode); active (N,) bool; cell_win a 0-dim int32 or int64; c1row, c2row (3,)
and half32, dx32 0-dim float32; the rest Python numbers.  The scatter and
covariance eigensolves are float32 in both types.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import canonicalize_direction
from .eigh3 import eigvalsh3, principal_eigenvector3

# The kernel keeps a round's inlier keys (a power of two at or above N of the
# points' type) in shared memory up to this many bytes, else in a scratch
# buffer from the wrapper (csrc/gates.cu kKeysShared).
_KEYS_SHARED = 131_072
_MAX_POINTS = 65_535


class Gates(NamedTuple):
    """What `_round` reads of its gates after ``gates.end``."""

    m2: torch.Tensor          # (N,) bool: the inliers
    nv: torch.Tensor          # int32: their count
    ok3: torch.Tensor         # bool: both fits held (the round counts a line)
    bx_zero: torch.Tensor     # bool: the direction's x is 0 (find_t fails)
    accept: torch.Tensor      # bool: radius, gap, PCA and length gates held
    a_w: torch.Tensor         # (3,) the line's point, input frame
    bc: torch.Tensor          # (3,) its canonical direction
    eig: torch.Tensor         # (3,) covariance eigenvalues, descending
    t_min: torch.Tensor
    t_max: torch.Tensor
    closest: torch.Tensor     # the radius size nearest the line's radius
    pca_coeff: torch.Tensor


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


def _first_true(mask):
    return torch.argmax(mask.to(torch.int8))


def _row(t, i):
    """t[i] for a 0-dim index tensor, without a host read."""
    return t.index_select(0, i.reshape(1))[0]


def round_gates_plain(Xs, P2, active, cell_win, b0, c1row, c2row, dx, dv, half32, dx32,
                      min_nb_denom, rs, shift, minvotes: int, min_pca_coeff: float,
                      rs_max: float, num_x_static: int) -> Gates:
    """The gates as a chain of PyTorch ops (the JAX package's `_round`, op for
    op): ~460 ops a round, each a kernel of its own on the card."""
    _check(Xs, P2, active, cell_win, b0, c1row, c2row, dx, dv, half32, dx32,
           min_nb_denom, rs, shift)
    dev, dt, N, NX = Xs.device, Xs.dtype, Xs.shape[0], num_x_static
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
    ok2 = ok1 & (nv >= minvotes)
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
    accept = gate_r & (pca_coeff > min_pca_coeff) & (nv > min_nb)
    return Gates(m2, nv, ok3, bx_zero, accept, a_w, bc, eig, t_min, t_max, closest,
                 pca_coeff)


def _check(Xs, P2, active, cell_win, b0, c1row, c2row, dx, dv, half32, dx32,
           min_nb_denom, rs, shift) -> None:
    """Raises on what the gates do not take (the same for both versions)."""
    dev, dt = Xs.device, Xs.dtype
    if dt not in (torch.float32, torch.float64) or Xs.dim() != 2 or Xs.shape[1] != 3:
        raise ValueError(f"Xs must be (N, 3) float32 or float64, got "
                         f"{tuple(Xs.shape)} {dt}")
    N = Xs.shape[0]
    if not 1 <= N <= _MAX_POINTS:
        raise ValueError(f"{N} points: the gates take 1 to {_MAX_POINTS}")
    want = {"Xs": (Xs, dt, (N, 3)), "P2": (P2, dt, (N, 3)),
            "active": (active, torch.bool, (N,)), "b0": (b0, dt, (3,)),
            "c1row": (c1row, torch.float32, (3,)), "c2row": (c2row, torch.float32, (3,)),
            "dx": (dx, dt, ()), "dv": (dv, dt, ()), "half32": (half32, torch.float32, ()),
            "dx32": (dx32, torch.float32, ()), "min_nb_denom": (min_nb_denom, dt, ()),
            "shift": (shift, dt, (3,))}
    for name, (t, t_dt, shape) in want.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, Xs on {dev}")
        if t.dtype != t_dt or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} {t_dt}, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if rs.device != dev or rs.dtype != dt or rs.dim() != 1 or rs.numel() < 1 \
            or not rs.is_contiguous():
        raise ValueError(f"rs must be a contiguous (R,) {dt} tensor with R >= 1 on {dev}")
    if (cell_win.device != dev or cell_win.dtype not in (torch.int32, torch.int64)
            or cell_win.numel() != 1):
        raise ValueError(f"cell_win must be one int32 or int64 on {dev}")


def _outputs(Xs) -> tuple:
    """One launch's outputs, made with `torch.empty`: (the inlier keys'
    scratch, or None where the kernel's shared memory takes them; flags
    (N + 3,) bool: m2, ok3, bx_zero, accept; nv; the 13 float outputs)."""
    dev, dt, N = Xs.device, Xs.dtype, Xs.shape[0]
    size = 1 << (N - 1).bit_length()
    keys = (torch.empty(size, dtype=dt, device=dev)
            if size * Xs.element_size() > _KEYS_SHARED else None)
    return (keys, torch.empty(N + 3, dtype=torch.bool, device=dev),
            torch.empty((), dtype=torch.int32, device=dev),
            torch.empty(13, dtype=dt, device=dev))


def _launch(lib, outs, Xs, P2, active, cell_win, b0, c1row, c2row, dx, dv, half32, dx32,
            min_nb_denom, rs, shift, minvotes, min_pca_coeff, rs_max, num_x_static) -> int:
    """One ``pcs_round_gates`` launch from `lib` into `outs` (`_outputs`) on
    the current stream; returns its CUDA error code."""
    keys, flags, nv, vals = outs
    N = Xs.shape[0]
    return lib.pcs_round_gates(
        int(Xs.dtype == torch.float64), Xs.data_ptr(), P2.data_ptr(), active.data_ptr(), N,
        cell_win.data_ptr(), int(cell_win.dtype == torch.int64), b0.data_ptr(),
        c1row.data_ptr(), c2row.data_ptr(), dx.data_ptr(), dv.data_ptr(), half32.data_ptr(),
        dx32.data_ptr(), min_nb_denom.data_ptr(), rs.data_ptr(), rs.numel(),
        shift.data_ptr(), int(minvotes), float(min_pca_coeff), float(rs_max),
        int(num_x_static), keys.data_ptr() if keys is not None else None,
        flags.data_ptr(), nv.data_ptr(), flags[N:].data_ptr(), vals.data_ptr(),
        torch.cuda.current_stream(Xs.device).cuda_stream)


def round_gates(Xs, P2, active, cell_win, b0, c1row, c2row, dx, dv, half32, dx32,
                min_nb_denom, rs, shift, minvotes: int, min_pca_coeff: float,
                rs_max: float, num_x_static: int) -> Gates:
    """`round_gates_plain`'s values in one launch of ``pcs_round_gates`` on a
    CUDA tensor (the order of the masked sums aside); a CPU tensor takes
    `round_gates_plain`."""
    args = (Xs, P2, active, cell_win, b0, c1row, c2row, dx, dv, half32, dx32,
            min_nb_denom, rs, shift, minvotes, min_pca_coeff, rs_max, num_x_static)
    if not Xs.is_cuda:
        return round_gates_plain(*args)
    from .._build import load_library
    from .voting import _count, _raise_on

    _check(*args[:14])
    outs = _outputs(Xs)
    _raise_on(_launch(load_library(), outs, *args), "round_gates")
    _count(round_gates, Xs.device)
    _, flags, nv, vals = outs
    N = Xs.shape[0]
    return Gates(flags[:N], nv, flags[N], flags[N + 1], flags[N + 2], vals[0:3], vals[3:6],
                 vals[6:9], vals[9], vals[10], vals[11], vals[12])


round_gates.launches = round_gates.captured = 0
round_gates.counts = {}     # device -> 0-dim int64: the launches that ran
