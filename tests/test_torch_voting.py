"""The PyTorch port's voting layer vs the JAX package's voting functions.

Bins, histograms and the lazy (best, key, ub) state are integers, so every
comparison here is exact.  On the CPU the port's wrappers take their plain
versions; tests/test_torch_cuda.py holds the CUDA kernels against those plain
versions on the card.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointcloud_segmentation_tpu.config import default_config
from pointcloud_segmentation_tpu.ops import hough as H
from pointcloud_segmentation_tpu.ops.voting_pallas import vote_histogram_pallas
from pointcloud_segmentation_tpu.sphere import hough_space

from pointcloud_segmentation_tpu_torch.ops import voting as V
from pointcloud_segmentation_tpu_torch.ops.hough import (
    _compact_removed, _removed_cell_keys)

torch.set_num_threads(2)

DX = np.float32(default_config().opt_dx)


def problem(seed, n, granularity, rows=None, extent=1.2, active_frac=0.8, dx=DX):
    """Shifted cloud + direction rows + (d, dx, num_x), as numpy."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    _, c1, c2 = hough_space(granularity)
    c1 = c1.astype(np.float32)
    c2 = c2.astype(np.float32)
    if rows is not None:
        sel = rng.choice(len(c1), rows, replace=False)
        c1, c2 = c1[sel], c2[sel]
    g = pts.max(0) - pts.min(0)
    d = np.float32(np.sqrt((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]))
    num_x = np.int32(max(np.floor(d / dx + np.float32(0.5)), 1))
    active = rng.random(n) < active_frac
    return pts, active, c1, c2, d, num_x


def to_torch(pts, active, c1, c2, d, num_x, dx=DX):
    return (torch.from_numpy(pts), torch.from_numpy(active),
            torch.from_numpy(c1), torch.from_numpy(c2),
            torch.tensor(d / np.float32(2.0)), torch.tensor(np.float32(dx)),
            torch.tensor(num_x))


def to_jax(pts, active, c1, c2, d, num_x, dx=DX):
    return (jnp.asarray(pts), jnp.asarray(active), jnp.asarray(c1),
            jnp.asarray(c2), jnp.float32(d), jnp.float32(dx), jnp.int32(num_x))


@pytest.mark.parametrize("granularity,rows", [(2, None), (6, 512)])
def test_vote_bins_bitwise(granularity, rows):
    p = problem(3, 700, granularity, rows)
    X, _, c1, c2, half, dx, nx = to_torch(*p)
    Xj, _, c1j, c2j, dj, dxj, nxj = to_jax(*p)
    xi, yi = V.vote_bins(X, c1, c2, half, dx, nx)
    xj, yj = H._vote_bins(Xj, c1j, c2j, dj, dxj, nxj)
    assert xi.dtype == torch.int32
    np.testing.assert_array_equal(xi.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yi.numpy(), np.asarray(yj))


@pytest.mark.parametrize("seed,B,N,NX", [(0, 32, 256, 79), (1, 128, 512, 40)])
def test_vote_histogram_matches_pallas_interpret(seed, B, N, NX):
    """The cases of tests/test_voting_pallas.py, fed by real bins."""
    extent = 1.25 if NX == 79 else 0.6
    p = problem(seed, N, 4, rows=B, extent=extent, active_frac=0.7)
    assert p[5] <= NX
    X, a, c1, c2, half, dx, nx = to_torch(*p)
    Xj, aj, c1j, c2j, dj, dxj, nxj = to_jax(*p)
    xb, yb = H._vote_bins(Xj, c1j, c2j, dj, dxj, nxj)
    xi_m = jnp.where(aj[None, :], xb, NX)
    ref = np.asarray(vote_histogram_pallas(xi_m, yb, NX, interpret=True))
    out = V.vote_histogram(X, a, c1, c2, half, dx, nx, NX)
    assert out.shape == (B, NX, NX) and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy().astype(np.float32), ref)


def test_vote_histogram_matches_xla_and_delta():
    NX = default_config(granularity=2).num_x_max
    p = problem(5, 600, 2)
    X, a, c1, c2, half, dx, nx = to_torch(*p)
    Xj, aj, c1j, c2j, dj, dxj, nxj = to_jax(*p)
    c1p, c2p = H._pad_dirs_to_tile(c1j, c1j, c2j)[1:]
    full = np.asarray(H._vote_histogram(Xj, c1p, c2p, dj, dxj, nxj, aj, NX))
    out = V.vote_histogram(X, a, torch.tensor(np.asarray(c1p)),
                           torch.tensor(np.asarray(c2p)), half, dx, nx, NX)
    np.testing.assert_array_equal(out.numpy().astype(np.float32), full)

    # the incremental subtract: the removed points' histogram
    removed = p[1] & (np.arange(600) % 3 == 0)
    n_rem = int(removed.sum())
    delta = np.asarray(H._vote_histogram_delta(
        Xj, c1j, c2j, dj, dxj, nxj, jnp.asarray(removed), jnp.int32(n_rem),
        512, NX))
    Xr = _compact_removed(X, torch.from_numpy(removed), n_rem)
    live = torch.ones(n_rem, dtype=torch.bool)
    out = V.vote_histogram(Xr, live, c1, c2, half, dx, nx, NX)
    np.testing.assert_array_equal(out.numpy().astype(np.float32), delta)


@pytest.mark.parametrize("granularity,rows", [(2, None), (6, 512)])
def test_vote_state_matches_xla(granularity, rows):
    NX = default_config(granularity=granularity).num_x_max
    p = problem(7, 900, granularity, rows)
    X, a, c1, c2, half, dx, nx = to_torch(*p)
    Xj, aj, c1j, c2j, dj, dxj, nxj = to_jax(*p)
    _, c1p, c2p = H._pad_dirs_to_tile(c1j, c1j, c2j)
    bj, kj, uj = H._vote_state_tiles(Xj, c1p, c2p, dj, dxj, nxj, aj, NX)
    best, key, ub = V.vote_state(X, a, torch.tensor(np.asarray(c1p)),
                                 torch.tensor(np.asarray(c2p)), half, dx, nx, NX)
    np.testing.assert_array_equal(best.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(key.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(ub.numpy(), np.asarray(uj))


def test_state_reduction_tie_break():
    """key is the first cell at the max; ub is the max over the other cells,
    so it equals best when the max is shared."""
    counts = torch.tensor([[0, 3, 3, 1], [0, 0, 0, 0], [5, 1, 1, 2]])
    best, key, ub = V._state_of(counts)
    assert best.tolist() == [3, 0, 5]
    assert key.tolist() == [1, 0, 0]
    assert ub.tolist() == [3, 0, 2]


def test_vote_state_all_zero_direction():
    p = problem(1, 64, 2)
    X, a, c1, c2, half, dx, nx = to_torch(*p)
    best, key, ub = V.vote_state(X, torch.zeros_like(a), c1, c2, half, dx, nx, 40)
    assert (best == 0).all() and (key == 0).all() and (ub == 0).all()


def test_removed_cell_keys_match_xla():
    NX = 79
    p = problem(11, 400, 2)
    X, a, c1, c2, half, dx, nx = to_torch(*p)
    Xj, aj, c1j, c2j, dj, dxj, nxj = to_jax(*p)
    removed = p[1] & (np.arange(400) % 5 == 1)
    n_rem = int(removed.sum())
    kj = np.asarray(H._removed_cell_keys(
        Xj, c1j, c2j, dj, dxj, nxj, jnp.asarray(removed), jnp.int32(n_rem),
        400, NX))
    kt = _removed_cell_keys(X, c1, c2, half, dx, nx, torch.from_numpy(removed),
                            n_rem, NX)
    np.testing.assert_array_equal(kt.numpy(), kj[:, :n_rem])
    assert (kj[:, n_rem:] == NX * NX).all()


@pytest.mark.parametrize("granularity", [2, 6])
def test_plain_matches_jax_at_nx_261(granularity):
    """radius_sizes=(0.015,) gives NX 261, the largest grid a shipped
    option reaches; a 2.4 m cloud spans ~140 of its bins."""
    cfg = default_config(granularity=granularity, radius_sizes=(0.015,))
    NX, dx = cfg.num_x_max, np.float32(cfg.opt_dx)
    assert NX == 261
    p = problem(13, 700, granularity, rows=None if granularity == 2 else 256, dx=dx)
    X, a, c1, c2, half, dxt, nx = to_torch(*p, dx=dx)
    Xj, aj, c1j, c2j, dj, dxj, nxj = to_jax(*p, dx=dx)
    assert 100 < int(nx) <= NX
    _, c1p, c2p = H._pad_dirs_to_tile(c1j, c1j, c2j)
    c1t, c2t = torch.tensor(np.asarray(c1p)), torch.tensor(np.asarray(c2p))
    bj, kj, uj = H._vote_state_tiles(Xj, c1p, c2p, dj, dxj, nxj, aj, NX)
    best, key, ub = V.vote_state_plain(X, a, c1t, c2t, half, dxt, nx, NX)
    np.testing.assert_array_equal(best.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(key.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(ub.numpy(), np.asarray(uj))
    hj = np.asarray(H._vote_histogram(Xj, c1p[:128], c2p[:128], dj, dxj, nxj, aj, NX))
    ht = V.vote_histogram_plain(X, a, c1t[:128], c2t[:128], half, dxt, nx, NX)
    assert ht.shape == (128, NX, NX)
    np.testing.assert_array_equal(ht.numpy().astype(np.float32), hj)


@pytest.mark.parametrize("nxs,fits", [(79, True), (241, True), (261, True),
                                      (V.MAX_NX, True), (V.MAX_NX + 1, False)])
def test_shared_memory_bound(nxs, fits):
    """A num_x_static whose packed 16-bit histogram, beside a 256-point
    staging chunk, exceeds one block's 227 KB of shared memory is refused
    before any launch; 337 is the largest that fits."""
    assert V.MAX_NX == 337
    X, a, c1, c2, half, dx, nx = to_torch(*problem(0, 8, 0))
    if fits:
        V._check_cuda_args(X, a, c1, c2, half, dx, nx, nxs)
    else:
        with pytest.raises(ValueError, match="shared memory.*the largest is 337"):
            V._check_cuda_args(X, a, c1, c2, half, dx, nx, nxs)


@pytest.mark.parametrize("n,fits", [(65_535, True), (65_536, False)])
def test_point_count_bound(n, fits):
    """Counts are 16 bits in the kernels, so N must stay below 65,536."""
    X, a, c1, c2, half, dx, nx = to_torch(*problem(0, n, 0))
    if fits:
        V._check_cuda_args(X, a, c1, c2, half, dx, nx, 79)
    else:
        with pytest.raises(ValueError, match="65,536"):
            V._check_cuda_args(X, a, c1, c2, half, dx, nx, 79)


def test_kernel_checks_refuse_bad_inputs():
    X, a, c1, c2, half, dx, nx = to_torch(*problem(0, 8, 0))
    with pytest.raises(ValueError):
        V._check_cuda_args(X.double(), a, c1, c2, half, dx, nx, 40)
    with pytest.raises(ValueError):
        V._check_cuda_args(X, a, c1, c2, half, dx, nx.long(), 40)
    with pytest.raises(ValueError):
        V._check_cuda_args(torch.cat([X, X], 1)[:, :3], a, c1, c2, half, dx, nx, 40)
