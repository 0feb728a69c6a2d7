"""A Hough round's gates (ops/gates.py) on the CPU: the plain chain gives,
bit for bit, what the in-line chain of `_round` gave before it became a
function of its own; a CPU tensor takes it through the wrapper, which counts
no launch; the wrapper refuses what the kernel does not take; the voting
sets name their gates.  The kernel itself (csrc/gates.cu) runs only on a
card: tests/test_torch_cuda.py holds it against the chain there.

Imports only torch, numpy and the port:
    python -m pytest tests/test_torch_gates.py -q
"""

import dataclasses
import re
from pathlib import Path

import pytest
import torch

from pointcloud_segmentation_tpu_torch import SegmentationEngine
from pointcloud_segmentation_tpu_torch.config import StaticShapes, default_config
from pointcloud_segmentation_tpu_torch.geometry import canonicalize_direction
from pointcloud_segmentation_tpu_torch.io.scene import (OBS_TESTS_SCENE, WP_TESTS,
                                                        trajectory_poses)
from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec, simulate_trajectory
from pointcloud_segmentation_tpu_torch.ops import gates as G
from pointcloud_segmentation_tpu_torch.ops import hough as H
from pointcloud_segmentation_tpu_torch.ops import voting as V

torch.set_num_threads(2)


def frozen_chain(Xs, P2, active, cell_win, b0, c1row, c2row, dx, dv, half32, dx32,
                 min_nb_denom, rs, shift, minvotes, min_pca_coeff, rs_max, NX):
    """The gates as `_round` computed them in line before ops/gates.py, op for
    op (its `_masked_lsq` and `_masked_cov_eigs` written out), as a tuple in
    `Gates` order."""
    from pointcloud_segmentation_tpu_torch.ops.eigh3 import (eigvalsh3,
                                                             principal_eigenvector3)

    dev, dt, N = Xs.device, Xs.dtype, Xs.shape[0]

    def dist2(pts, a, b_unit):
        d = pts - a
        along = (d * b_unit[None, :]).sum(-1)
        perp = d - along[:, None] * b_unit[None, :]
        return (perp * perp).sum(-1)

    def centred(pts, mask):
        m = mask.to(dt)
        cnt = torch.clamp_min(m.sum(), 1.0)
        mean = (pts * m[:, None]).sum(0) / cnt
        c = torch.where(mask[:, None], pts - mean, 0.0).to(torch.float32)
        return cnt, mean, (c[:, :, None] * c[:, None, :]).sum(0)

    def lsq(pts, mask):
        _, mean, S = centred(pts, mask)
        rc, bvec = principal_eigenvector3(S)
        return rc.to(dt), mean, bvec.to(dt)

    def first(mask):
        return torch.argmax(mask.to(torch.int8))

    def row(t, i):
        return t.index_select(0, i.reshape(1))[0]

    xi = (cell_win // NX).to(torch.float32)
    yi = (cell_win % NX).to(torch.float32)
    xc = (xi + 0.5) * dx32 - half32
    yc = (yi + 0.5) * dx32 - half32
    a0 = (xc * c1row + yc * c2row).to(dt)
    b0u = b0 / torch.sqrt((b0 * b0).sum())
    m1 = active & (torch.sqrt(dist2(Xs, a0, b0u)) <= dx)
    ok0 = m1.any()
    rc1, a1, b1 = lsq(Xs, m1)
    ok1 = ok0 & (rc1 > 0.0)
    b1u = b1 / torch.sqrt((b1 * b1).sum())
    m2 = active & (torch.sqrt(dist2(Xs, a1, b1u)) <= dx)
    nv = m2.sum().to(torch.int32)
    ok2 = ok1 & (nv >= minvotes)
    rc2, a2, b2 = lsq(Xs, m2)
    ok3 = ok2 & (rc2 > 0.0)
    bc = canonicalize_direction(b2)
    a_w = a2 + shift
    dvec = P2 - a_w
    bb = torch.clamp_min((bc * bc).sum(), 1e-30)
    t_all = (dvec * bc).sum(-1) / bb
    proj = a_w[None, :] + t_all[:, None] * bc[None, :]
    prad = torch.sqrt(torch.clamp_min(((proj - P2) ** 2).sum(-1), 0.0))
    bx_zero = bc[0] == 0.0
    t = (proj[:, 0] - a_w[0]) / torch.where(bx_zero, 1.0, bc[0])
    tv = torch.where(m2, t, torch.inf)
    pn_all = torch.sqrt(((a_w[None, :] + t[:, None] * bc[None, :]) ** 2).sum(-1))
    pn_s = pn_all[torch.sort(tv, stable=True).indices]
    pair_ok = (torch.arange(1, N, device=dev)) < nv
    gaps = torch.where(pair_ok, torch.abs(pn_s[1:] - pn_s[:-1]), -torch.inf)
    max_gap = torch.where(nv > 1, gaps.max(), 0.0) if N > 1 else \
        torch.zeros((), dtype=dt, device=dev)
    radius = torch.maximum(row(prad, first(m2)), row(prad, N - 1 - first(m2.flip(0))))
    t_min = torch.where(nv > 0, torch.where(m2, t, torch.inf).min(), 0.0)
    t_max = torch.where(nv > 0, torch.where(m2, t, -torch.inf).max(), 0.0)
    diffs = torch.abs(radius - rs)
    k = torch.argmin(diffs)
    closest = row(rs, k)
    max_radius = torch.clamp_min(diffs[0], rs_max)
    gate_r = (row(diffs, k) < dv) & (max_radius <= closest) & (max_gap < 2.0 * dv)
    cnt, _, S = centred(P2, m2)
    eig = eigvalsh3(S / torch.clamp_min(cnt.to(torch.float32) - 1.0, 1.0)).to(dt)
    pca_coeff = eig[0] / torch.clamp_min(eig.sum(), 1e-30)
    seg_len = torch.sqrt((((t_max * bc + a_w) - (t_min * bc + a_w)) ** 2).sum())
    min_nb = (2.0 * closest * seg_len / min_nb_denom).to(torch.int32)
    accept = gate_r & (pca_coeff > min_pca_coeff) & (nv > min_nb)
    return (m2, nv, ok3, bx_zero, accept, a_w, bc, eig, t_min, t_max, closest, pca_coeff)


def recorded_rounds(cfg, frames, gates=G.round_gates_plain):
    """The arguments of every round's gates over a host-driven CPU replay of
    `frames`, recorded by a gates function that passes them on to `gates`;
    each tensor is copied, since the loop writes its state in place."""
    rounds = []

    def record(*args):
        rounds.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return gates(*args)

    voting = H.Voting(V.vote_state, V.vote_histogram, V.vote_decrement, record)
    eng = SegmentationEngine(cfg, device="cpu", loop="eager", voting=voting)
    for fr in frames:
        eng.push_pose(fr.t, fr.position, fr.quat_wxyz)
        eng.process_frame(fr.t, fr.points)
    return rounds


def small_frames(n):
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:n]
    return simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(width=32, height=32,
                                                               noise_frac=0.001), seed=7)


def small_cfg(granularity, **kw):
    return default_config(granularity=granularity, shapes=StaticShapes(
        max_raw_points=1024, max_points=512, max_world_segments=32), **kw)


@pytest.mark.parametrize("granularity,voting_mode,dtype", [
    (2, "carry", "float32"), (3, "lazy", "float32"), (2, "lazy", "float64")])
def test_the_plain_gates_are_the_chain_that_was_in_line(granularity, voting_mode, dtype):
    """Every round of a CPU replay: `round_gates_plain` gives the in-line
    chain's outputs bit for bit."""
    cfg = dataclasses.replace(small_cfg(granularity), voting=voting_mode,
                              compute_dtype=dtype)
    assert cfg.voting_mode == voting_mode
    rounds = recorded_rounds(cfg, small_frames(3))
    assert len(rounds) > 6
    assert any(bool(G.round_gates_plain(*r).ok3) for r in rounds)
    for r in rounds:
        got, want = G.round_gates_plain(*r), frozen_chain(*r)
        assert r[0].dtype == getattr(torch, dtype)
        for name, a, b in zip(G.Gates._fields, got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b) or (a.isnan().all() and b.isnan().all()), name


def test_a_cpu_tensor_takes_the_plain_gates_and_counts_no_launch():
    rounds = recorded_rounds(small_cfg(2), small_frames(2), gates=G.round_gates)
    n0, c0 = G.round_gates.launches, G.round_gates.captured
    for r in rounds[:4]:
        for a, b in zip(G.round_gates(*r), G.round_gates_plain(*r)):
            assert torch.equal(a, b)
    assert rounds and (G.round_gates.launches, G.round_gates.captured) == (n0, c0)


def test_the_voting_sets_name_their_gates():
    assert H.PLAIN.round_gates is G.round_gates_plain
    assert H.KERNELS.round_gates is G.round_gates
    assert H.Voting(V.vote_state, V.vote_histogram).round_gates is G.round_gates
    assert G.round_gates in V.COUNTED


def test_the_gates_counter_is_made_and_reset_with_the_voting_counters(monkeypatch):
    """`prepare_counts` makes the gates kernel's device counter beside the
    voting kernels', `ran_launches` reads it and `reset_counts` zeroes it
    in place (on the CPU, standing in for a card)."""
    cpu = torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    for fn in V.COUNTED:
        monkeypatch.setattr(fn, "counts", {})
        monkeypatch.setattr(fn, "launches", 0)
    V.prepare_counts(cpu)
    counter = G.round_gates.counts[cpu]
    for _ in range(3):
        V._count(G.round_gates, cpu)
    assert (G.round_gates.launches, V.ran_launches(G.round_gates)) == (3, 3)
    V.reset_counts()
    assert (G.round_gates.launches, V.ran_launches(G.round_gates)) == (0, 0)
    assert G.round_gates.counts[cpu] is counter


def one_round():
    rounds = recorded_rounds(small_cfg(2), small_frames(1))
    return list(rounds[0])


# (argument index, a wrong value made from the right one, what the error names)
BAD = {
    "Xs float16": (0, lambda t: t.half(), "Xs"),
    "Xs (N, 4)": (0, lambda t: torch.cat([t, t[:, :1]], 1), "Xs"),
    "P2 float64": (1, lambda t: t.double(), "P2"),
    "P2 not contiguous": (1, lambda t: t.t().contiguous().t(), "P2"),
    "active uint8": (2, lambda t: t.to(torch.uint8), "active"),
    "active short": (2, lambda t: t[:-1], "active"),
    "cell float": (3, lambda t: t.float(), "cell_win"),
    "b0 (4,)": (4, lambda t: torch.cat([t, t[:1]]), "b0"),
    "b0 not contiguous": (4, lambda t: torch.stack([t, t], 1)[:, 0], "b0"),
    "c1row float64": (5, lambda t: t.double(), "c1row"),
    "dx (1,)": (7, lambda t: t.reshape(1), "dx"),
    "half32 float64": (9, lambda t: t.double(), "half32"),
    "rs empty": (12, lambda t: t[:0], "rs"),
    "rs 2-d": (12, lambda t: t.reshape(1, -1), "rs"),
    "shift float64": (13, lambda t: t.double(), "shift"),
}


@pytest.mark.parametrize("case", sorted(BAD))
@pytest.mark.parametrize("fn", ["round_gates", "round_gates_plain"])
def test_the_gates_refuse_what_the_kernel_does_not_take(case, fn):
    args = one_round()
    assert len(G.round_gates(*args).m2) == args[0].shape[0]
    k, wrong, name = BAD[case]
    args[k] = wrong(args[k])
    with pytest.raises(ValueError, match=name):
        getattr(G, fn)(*args)


def test_the_gates_refuse_more_points_than_the_kernel_counts():
    args = one_round()
    n = G._MAX_POINTS + 1
    args[0] = torch.zeros((n, 3))
    with pytest.raises(ValueError, match="points"):
        G.round_gates(*args)


def test_the_key_buffer_rule_is_the_kernels():
    """The wrapper allocates the kernel's scratch for the inlier keys exactly
    when the kernel's shared memory does not take them: the two sides share
    one constant, and the largest N in shared memory is 32,768 points of
    float32 and 16,384 of float64."""
    src = (Path(G.__file__).resolve().parent.parent / "csrc" / "gates.cu").read_text()
    (shared,) = re.findall(r"constexpr size_t kKeysShared = (\d+);", src)
    assert int(shared) == G._KEYS_SHARED
    for item, largest in ((4, 32_768), (8, 16_384)):
        assert largest * item <= G._KEYS_SHARED < 2 * largest * item
    (most,) = re.findall(r"g\.n > (\d+)", src)
    assert int(most) == G._MAX_POINTS
