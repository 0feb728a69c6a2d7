"""The port's Hough loop, the one a card captures into one CUDA graph, and
the frame step that captures it.

On the CPU, `extract_lines` runs the very bodies a graph captures, each
`run_if` node reading its flag on the host as the card's IF node does at
replay.  It is held in carry and lazy mode over every branch of the loop
against the JAX package's `extract_lines` (integers exact, endpoints within
5e-3, README §Precision contract) and against each case's status, line
count and rounds, absolute numbers; over the lazy re-exam, with and without
its overflow into a rebuild, against its suspects and against carry
voting.  The
fixed-width compaction is held against the JAX one column for column.
`make_process_frame_packed` runs eagerly here and is held against the JAX
step over a short replay with a NaN frame in it: scalars exact, world
endpoints within 2e-2, the golden fixtures' tolerance.  Inputs are made
from numpy seeds with tests/test_torch_hough.py's helpers.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointcloud_segmentation_tpu.config import StaticShapes, default_config
from pointcloud_segmentation_tpu.io.scene import OBS_TESTS_SCENE, WP_TESTS, trajectory_poses
from pointcloud_segmentation_tpu.io.simulator import TofSpec, simulate_trajectory
from pointcloud_segmentation_tpu.ops import hough as JH
from pointcloud_segmentation_tpu.ops.hough import extract_lines_jit
from pointcloud_segmentation_tpu.pipeline import init_world as jax_init_world
from pointcloud_segmentation_tpu.pipeline import (
    make_process_frame_packed as jax_make_process_frame_packed)
from pointcloud_segmentation_tpu.sphere import hough_space

from pointcloud_segmentation_tpu_torch import SegmentationEngine
from pointcloud_segmentation_tpu_torch.cli import launch_counts
from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy
from pointcloud_segmentation_tpu_torch.ops import hough as TH
from pointcloud_segmentation_tpu_torch.ops import voting as V
from pointcloud_segmentation_tpu_torch.pipeline import (
    init_world, make_process_frame, make_process_frame_packed, process_frame_packed)

from test_torch_hough import BASE, assert_same_extraction, line_cloud, pad, random_scene

torch.set_num_threads(2)

FIELDS = TH.SegmentBatch._fields


# ---------------------------------------------------------------- inputs


def cloud_case(name):
    """(points (n, 3) float32, config) of one named case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("scene"):
        return random_scene(int(name[5:]) + 200), BASE.replace(opt_nlines=6)
    if name == "spill":
        pts = np.concatenate([
            line_cloud(rng, [0.2, -0.6, 0.3], [0.1, 1.0, 0.2], n=700, jitter=0.003),
            line_cloud(rng, [0.9, 0.5, 1.1], [1.0, -0.2, 0.1], n=150, jitter=0.003)])
        return pts, default_config(granularity=2, opt_nlines=4, opt_minvotes=12,
                                   min_pca_coeff=0.9,
                                   shapes=StaticShapes(max_raw_points=2048, max_points=1024))
    if name == "empty":
        return np.zeros((0, 3), np.float32), BASE
    if name == "one_point":
        return np.array([[0.3, 0.1, 1.0]], np.float32), BASE
    if name == "tiny":             # two points 1 cm apart: dx >= d
        return np.array([[0.3, 0.1, 1.0], [0.31, 0.1, 1.0]], np.float32), BASE
    if name == "bx_zero":
        # a line in the plane x = 0.5: the centred x column is exactly 0, so
        # the fitted direction's x is exactly 0 and the frame aborts (h:276)
        t = np.linspace(-0.5, 0.5, 160)
        pts = np.stack([np.full_like(t, 0.5), t, 1.0 + 0.3 * t], 1)
        pts[:, 1:] += rng.normal(0, 0.002, (len(t), 2))
        return pts.astype(np.float32), BASE.replace(opt_nlines=3)
    if name == "no_line":           # round 0 runs, finds nothing, ends the loop
        pts = rng.uniform([0.0, -0.8, 0.2], [1.0, 0.8, 1.6], (300, 3))
        return pts.astype(np.float32), BASE.replace(opt_minvotes=250)
    four_lines = np.concatenate([line_cloud(rng, a, b, n=160) for a, b in (
        ([0.1, -0.6, 0.3], [0.1, 1.0, 0.2]), ([0.9, 0.5, 1.1], [1.0, -0.2, 0.1]),
        ([0.2, 0.4, 0.4], [0.3, 0.1, 1.0]), ([0.5, -0.3, 1.2], [1.0, 1.0, 0.0]))])
    if name == "reaches_opt_nlines":
        return four_lines, BASE.replace(opt_nlines=2)
    if name == "max_iters":         # opt_nlines = 0: max_iters bounds the rounds
        return four_lines, BASE.replace(opt_nlines=0, shapes=StaticShapes(
            max_raw_points=2048, max_points=1024, max_iters=3))
    raise KeyError(name)


CASES = ["scene0", "scene1", "scene2", "spill", "empty", "one_point", "tiny",
         "bx_zero", "no_line", "reaches_opt_nlines", "max_iters"]
# each case's (status, nlines, rounds run), the same in carry and lazy mode:
# status 1 degenerate, 2 dx >= d, 3 the b.x == 0 abort (nlines reported 0);
# a round that finds no line ends the loop, one more round than lines
EXPECTED = {"scene0": (0, 1, 1), "scene1": (0, 2, 2), "scene2": (0, 1, 1),
            "spill": (0, 2, 2), "empty": (1, 0, 0), "one_point": (1, 0, 0),
            "tiny": (2, 0, 0), "bx_zero": (3, 0, 1), "no_line": (0, 0, 1),
            "reaches_opt_nlines": (0, 2, 2), "max_iters": (0, 3, 3)}


def torch_inputs(pts, cfg):
    padded, valid = pad(pts, cfg.shapes.max_points)
    return torch.from_numpy(padded), torch.from_numpy(valid)


def assert_bit_equal(a, b):
    assert int(a.nlines) == int(b.nlines) and int(a.status) == int(b.status)
    for f in FIELDS:
        x, y = getattr(a.segments, f), getattr(b.segments, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


class Rounds:
    """Counts the rounds a loop runs: `_round` fits one direction per
    round, through the gates' canonicalize_direction (ops/gates.py, the
    plain gates a CPU tensor takes)."""

    def __init__(self, monkeypatch):
        from pointcloud_segmentation_tpu_torch.ops import gates as TG

        self.n = 0
        inner = TG.canonicalize_direction

        def counted(b):
            self.n += 1
            return inner(b)

        monkeypatch.setattr(TG, "canonicalize_direction", counted)

    def run(self, *args, **kw):
        self.n = 0
        res = TH.extract_lines(*args, **kw)
        return res, self.n


class Calls:
    """A voting function that records each call: "table" for a call on the
    whole direction table (the initial state, a rebuild), else the rows of a
    re-exam's gathered table."""

    def __init__(self, fn):
        self.fn, self.calls, self.table = fn, [], None

    def __call__(self, Xs, active, c1, c2, half, dx, num_x, nxs):
        if self.table is None:
            self.table = c1.data_ptr()       # the first call: the initial state
        self.calls.append("table" if c1.data_ptr() == self.table else c1.shape[0])
        return self.fn(Xs, active, c1, c2, half, dx, num_x, nxs)


# ---------------------------------------------------------------- compaction


def compaction_problem(n_rem, N=1024):
    rng = np.random.default_rng(n_rem)
    X = rng.uniform(-1.2, 1.2, (N, 3)).astype(np.float32)
    removed = np.zeros(N, bool)
    removed[rng.choice(N, n_rem, replace=False)] = True
    return X, removed


@pytest.mark.parametrize("n_rem", [100, 512, 700])
def test_compact_removed_matches_jax(n_rem):
    """Below, at and above the 512 columns: every column, dead ones (point
    0, not live) included, equals the JAX compaction."""
    X, removed = compaction_problem(n_rem)
    Xj, lj = JH._compact_removed(jnp.asarray(X), jnp.asarray(removed), jnp.int32(n_rem), 512)
    Xt, lt = TH._compact_removed(torch.from_numpy(X), torch.from_numpy(removed),
                                 torch.tensor(n_rem, dtype=torch.int32), 512)
    assert Xt.shape == (512, 3) and lt.shape == (512,)
    np.testing.assert_array_equal(Xt.numpy(), np.asarray(Xj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert int(lt.sum()) == min(n_rem, 512)


@pytest.mark.parametrize("n_rem", [100, 512, 700])
def test_removed_cell_keys_match_jax_at_sub_chunk(n_rem):
    """(B, 512) keys with the sentinel NX*NX in every dead column."""
    NX = 79
    X, removed = compaction_problem(n_rem)
    _, c1, c2 = (t.astype(np.float32) for t in hough_space(2))
    g = X.max(0) - X.min(0)
    d = np.float32(np.sqrt((g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]))
    dx = np.float32(default_config().opt_dx)
    num_x = np.int32(max(np.floor(d / dx + np.float32(0.5)), 1))
    kj = np.asarray(JH._removed_cell_keys(
        jnp.asarray(X), jnp.asarray(c1), jnp.asarray(c2), jnp.float32(d), jnp.float32(dx),
        jnp.int32(num_x), jnp.asarray(removed), jnp.int32(n_rem), 512, NX))
    kt = V._removed_cell_keys(
        torch.from_numpy(X), torch.from_numpy(c1), torch.from_numpy(c2),
        torch.tensor(d / np.float32(2.0)), torch.tensor(dx), torch.tensor(num_x),
        torch.from_numpy(removed), torch.tensor(n_rem), 512, NX)
    assert kt.shape == (c1.shape[0], 512)
    np.testing.assert_array_equal(kt.numpy(), kj)
    assert (kj[:, min(n_rem, 512):] == NX * NX).all()


# ---------------------------------------------------------------- the loop


@pytest.mark.parametrize("mode", ["carry", "lazy"])
@pytest.mark.parametrize("case", CASES)
def test_graph_loop_equals_eager_and_jax(case, mode, monkeypatch):
    """The loop == JAX within the precision contract, and the case's status,
    line count and rounds are its expected ones, at most round_count(cfg),
    the rounds the loop issues."""
    pts, cfg = cloud_case(case)
    cfg = cfg.replace(voting=mode)
    p, v = torch_inputs(pts, cfg)
    rg, n_rounds = Rounds(monkeypatch).run(p, v, cfg)
    rj = extract_lines_jit(jnp.asarray(p.numpy()), jnp.asarray(v.numpy()), cfg)
    assert_same_extraction(rj, rg)
    R = TH.round_count(cfg)
    assert (int(rg.status), int(rg.nlines), n_rounds) == EXPECTED[case]
    assert n_rounds <= R
    if case == "reaches_opt_nlines":
        assert n_rounds == cfg.opt_nlines == R               # the bound is tight
    elif case == "max_iters":
        assert cfg.opt_nlines == 0 and n_rounds == R == 3
    elif case == "spill":
        assert int(rg.segments.points_size[0]) > 512


def test_round_count_of_the_shipped_config():
    from pointcloud_segmentation_tpu_torch.config import default_config as tcfg

    cfg = tcfg()
    assert (cfg.opt_nlines, TH.iteration_bound(cfg), TH.round_count(cfg)) == (10, 24, 10)
    assert TH.round_count(tcfg(opt_nlines=0)) == cfg.shapes.max_iters == 24
    assert TH.round_count(tcfg(opt_nlines=40)) == 40


SUSPECT_SCENES = range(2)


def suspect_scene(seed):
    rng = np.random.default_rng(31 + seed)
    clouds = []
    for _ in range(6):
        a = rng.uniform([-0.4, -0.8, 0.2], [0.9, 0.8, 1.4])
        b = rng.normal(size=3)
        b /= np.linalg.norm(b)
        t = np.linspace(0, 1.2, 220)
        clouds.append(a + t[:, None] * b + rng.normal(0, 0.004, (220, 3)))
    clouds.append(rng.uniform([-0.4, -0.8, 0.2], [0.9, 0.8, 1.4], (200, 3)))
    return np.concatenate(clouds).astype(np.float32)


class Reexams:
    """A lazy re-exam (`vote_reexam`) held to its inputs at each call: the
    rows it rewrites are the suspects (ub at or above the largest decremented
    best), each as `vote_state` gives it over the active points, and every
    other row stays; past the cap no row changes and the overflow flag is
    set.  Appends ("reexam", suspects, overflow) to `log`, which a `Calls` of
    vote_state may share, so that a rebuild's place shows."""

    def __init__(self, fn, log):
        self.fn, self.log = fn, log

    def __call__(self, Xs, active, c1, c2, half, dx, num_x, nxs, best, key, ub, s_cap,
                 m_lb=None):
        want = [t.clone() for t in (best, key, ub)]
        rows = torch.nonzero(ub >= (best.max() if m_lb is None else m_lb)).flatten()
        over = self.fn(Xs, active, c1, c2, half, dx, num_x, nxs, best, key, ub, s_cap, m_lb)
        if 0 < rows.numel() <= s_cap:
            state = V.vote_state_plain(Xs, active, c1[rows].contiguous(),
                                       c2[rows].contiguous(), half, dx, num_x, nxs)
            for w, r in zip(want, state):
                w[rows] = r
        assert bool(over) == (rows.numel() > s_cap)
        for got, w in zip((best, key, ub), want):
            assert torch.equal(got, w)
        self.log.append(("reexam", rows.numel(), bool(over)))
        return over


@pytest.mark.parametrize("cap", [128, 2048])
def test_every_suspect_tier_graph_equals_eager(cap, monkeypatch):
    """Lazy mode at g4 (1,408 directions after padding), the suspect
    capacity as shipped (2048, the whole table: every suspect count is
    re-examined) and monkeypatched to 128 as
    test_suspect_overflow_takes_the_rebuild does (one tile, then the
    rebuild).  These scenes' increment rounds have either no suspect or all
    1,408.  In every scene the loop's first vote_state call is the whole
    table, each re-exam rewrites exactly its suspects' rows up to the cap
    (`Reexams`), an overflow is followed by the whole table's rebuild and by
    no other vote_state call (the gathered tiers are gone), the suspect
    counts and overflows seen are those, and the lines equal carry's."""
    monkeypatch.setattr(TH, "_SUSPECT_CAP", cap)
    cfg = default_config(granularity=4, opt_nlines=8, opt_minvotes=10, min_pca_coeff=0.8,
                         shapes=StaticShapes(max_raw_points=4096, max_points=2048))
    want = {128: {(0, False), (1408, True)}, 2048: {(0, False), (1408, False)}}[cap]
    seen = set()
    for seed in SUSPECT_SCENES:
        p, v = torch_inputs(suspect_scene(seed), cfg)
        st = Calls(V.vote_state)
        rx = Reexams(V.vote_reexam, st.calls)
        rl = TH.extract_lines(p, v, cfg.replace(voting="lazy"),
                              voting=TH.Voting(st, V.vote_histogram, vote_reexam=rx))
        calls = st.calls
        assert calls[0] == "table"
        assert all(c == "table" or c[0] == "reexam" for c in calls), calls
        for k, c in enumerate(calls):
            if c != "table" and c[2]:
                assert calls[k + 1] == "table"
        seen |= {c[1:] for c in calls if c != "table"}
        assert_bit_equal(rl, TH.extract_lines(p, v, cfg.replace(voting="carry")))
    assert seen == want, (want, seen)


# ---------------------------------------------------------------- refusals


def test_graph_loop_refuses_plain_and_shards():
    """The engine refuses a loop it does not have (the masked "graph" loop
    is gone) and the captured step with voting functions it does not
    capture; uncaptured, the plain voting functions run the one loop, equal
    to the kernels' (the plain versions, on CPU tensors)."""
    pts, cfg = cloud_case("scene0")
    p, v = torch_inputs(pts, cfg)
    for loop in ("while", "graph"):
        with pytest.raises(ValueError, match="loop"):
            SegmentationEngine(cfg, device="cpu", loop=loop)
    with pytest.raises(ValueError, match="KERNELS"):
        SegmentationEngine(cfg, device="cpu", voting=TH.PLAIN, loop="cond")
    for mode in ("carry", "lazy"):
        c = cfg.replace(voting=mode)
        rp = TH.extract_lines(p, v, c, voting=TH.PLAIN)
        assert int(rp.nlines) > 0
        assert_bit_equal(rp, TH.extract_lines(p, v, c))


# ---------------------------------------------------------------- the frame step


def replay_frames(n):
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:n]
    return simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.001), seed=7)


def raw_of(fr, cfg):
    raw = np.full((cfg.shapes.max_raw_points, 3), np.nan, np.float32)
    raw[: len(fr.points)] = fr.points
    return raw


@pytest.mark.parametrize("voting", ["carry", "lazy"])
def test_frame_step_matches_jax_step(voting):
    """The port's make_process_frame_packed (eager on the CPU) against the
    JAX one over the golden g2 replay with a
    NaN frame third: the packed scalars exact each frame, the world map's
    endpoints within 2e-2 at the end; make_process_frame gives the same
    frame without the scalars."""
    cfg = default_config(granularity=2, voting=voting, shapes=StaticShapes(
        max_raw_points=4096, max_points=2048, max_world_segments=32))
    jstep = jax_make_process_frame_packed(cfg)
    step = make_process_frame_packed(cfg, "cpu")
    plain_step = make_process_frame(cfg, "cpu")
    js, ts, us = jax_init_world(cfg), init_world(cfg, "cpu"), init_world(cfg, "cpu")
    frames = replay_frames(6)
    seq = [(raw_of(fr, cfg), fr) for fr in frames]
    seq.insert(2, (np.full_like(seq[0][0], np.nan), frames[2]))
    for k, (raw, fr) in enumerate(seq):
        pos = np.asarray(fr.position, np.float32)
        quat = np.asarray(fr.quat_wxyz, np.float32)
        js, _, jsc = jstep(js, jnp.asarray(raw), jnp.asarray(pos), jnp.asarray(quat))
        args = (torch.from_numpy(raw), torch.from_numpy(pos), torch.from_numpy(quat))
        ts, out, sc = step(ts, *args)
        us, uout = plain_step(us, *args)
        assert sc.tolist() == np.asarray(jsc).tolist()
        assert sc.tolist() == [int(uout.world_count), int(uout.nlines), int(uout.status),
                               int(uout.overflow)]
        assert all(torch.equal(a, b) for a, b in zip(ts, us))
        if k == 2:
            assert sc.tolist()[1:3] == [0, 1]          # the NaN frame: degenerate
    n = int(ts.count)
    assert n == int(js.count) >= 3
    for f in ("a", "b", "t_min", "t_max"):
        np.testing.assert_allclose(getattr(ts, f).numpy()[:n],
                                   np.asarray(getattr(js, f))[:n], atol=2e-2, rtol=0)


def test_frame_step_equals_eager_frame():
    """On the CPU the step is the eager frame: the same world map, outputs
    and scalars as a direct call of process_frame_packed."""
    cfg = default_config(granularity=3, voting="lazy", shapes=StaticShapes(
        max_raw_points=4096, max_points=2048, max_world_segments=32))
    step = make_process_frame_packed(cfg, "cpu")
    gs, es = init_world(cfg, "cpu"), init_world(cfg, "cpu")
    for fr in replay_frames(4):
        args = (torch.from_numpy(raw_of(fr, cfg)), torch.tensor(fr.position, dtype=torch.float32),
                torch.tensor(fr.quat_wxyz, dtype=torch.float32))
        gs, gout, gsc = step(gs, *args)
        es, eout, esc = process_frame_packed(es, *args, cfg)
        assert torch.equal(gsc, esc)
        assert all(torch.equal(a, b) for a, b in zip(gs, es))
        assert all(torch.equal(a, b) for a, b in zip(gout.segments, eout.segments))


def test_engine_graph_loop_on_the_cpu_equals_eager(tmp_path):
    """The engine with loop="cond" on the CPU (the step's eager body)
    against loop="eager" (process_frame_packed called directly): records
    and world map equal, through a pipelined replay, a checkpoint resume and
    a batched replay."""
    cfg = default_config(granularity=2, shapes=StaticShapes(
        max_raw_points=4096, max_points=2048, max_world_segments=32))
    frames = replay_frames(6)
    g = SegmentationEngine(cfg, device="cpu", loop="cond")
    e = SegmentationEngine(cfg, device="cpu")
    assert (g.loop, e.loop) == ("cond", "eager")
    rg, re = g.run_replay(frames[:2]), e.run_replay(frames[:2])
    rg += g.run_replay(frames[2:3], pipelined=True)
    re += e.run_replay(frames[2:3])
    ckpt = str(tmp_path / "c.npz")
    g.save_checkpoint(ckpt)
    resumed = SegmentationEngine(cfg, device="cpu", loop="cond")
    resumed.load_checkpoint(ckpt)
    rg += resumed.run_replay(frames[3:], batch=2)
    re += e.run_replay(frames[3:])
    key = [(r["seg_vec_size"], r["nblines"], r["status"]) for r in rg]
    assert key == [(r["seg_vec_size"], r["nblines"], r["status"]) for r in re]
    a, b = world_state_to_numpy(resumed.state), world_state_to_numpy(e.state)
    assert all(np.array_equal(a[k], b[k], equal_nan=True) for k in a)


# ---------------------------------------------------------------- inspect


class Event:
    def __init__(self, key, count):
        self.key, self.count = key, count


def test_inspect_counts_graph_launches_apart():
    """The launch count of `inspect` on a profiler's event names: graph
    launches apart from kernel launches, host reads from the syncs of a
    copy to the host, and aten rows (the CPU profiler's) counted in none."""
    events = [Event("cudaGraphLaunch", 1), Event("cudaLaunchKernel", 7),
              Event("cuLaunchKernel", 2), Event("cudaLaunchKernelExC", 1),
              Event("cudaStreamSynchronize", 1), Event("cudaMemcpyAsync", 2),
              Event("aten::copy_", 3), Event("aten::sort", 1)]
    assert launch_counts(events) == {"graph_launches": 1, "kernel_launches": 10,
                                     "host_reads": 1}
    assert launch_counts([Event("aten::add", 4)]) == {
        "graph_launches": 0, "kernel_launches": 0, "host_reads": 0}
