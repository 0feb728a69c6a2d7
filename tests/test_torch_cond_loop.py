"""The port's Hough loop with each round and branch in a conditional node
(`extract_lines`): what tests/test_torch_graph_loop.py does not cover.

On the CPU, `run_if` reads each node's flag on the host, which is what the
card's IF node does at replay, so the CPU runs the very bodies a capture
records.  Here: `run_if` itself; a NaN frame, which runs no round and
launches no kernel; the float64 parity mode on every case of the graph-loop
file, against the JAX package in float64; the launch counts; the one nvcc
call that builds the library; and `cond_capture`'s turns, one capture at a
time in the process, each with its own node count.  Inputs are made from
numpy seeds.
"""

import contextlib
import subprocess
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pointcloud_segmentation_tpu.ops.hough import extract_lines as jax_extract_lines
from pointcloud_segmentation_tpu.ops.hough import extract_lines_jit

from pointcloud_segmentation_tpu_torch import _build
from pointcloud_segmentation_tpu_torch.ops import hough as TH
from pointcloud_segmentation_tpu_torch.ops import voting as V

from test_torch_graph_loop import CASES, Calls, Rounds, cloud_case, torch_inputs

# the port in float64 against the JAX package in float64, as
# tests/test_torch_f64.py holds them: float64 but for the float32
# eigensolves, whose two small eigenvalues carry the solver's cancellation
JAX_TOL = 1e-6
JAX_TOL_BY_FIELD = {"pca_eigenvalues": 1e-4}

torch.set_num_threads(2)


# ---------------------------------------------------------------- run_if


def test_run_if_on_the_host_runs_the_body_where_the_flag_holds():
    """Off a capture, run_if reads the flag: true runs the body once, false
    skips it, nested nodes read their own flags; a 0-dim bool or int works."""
    ran = []
    for flag in (torch.tensor(True), torch.tensor(1, dtype=torch.int32)):
        TH.run_if(flag, lambda: ran.append("outer"))
    TH.run_if(torch.tensor(False), lambda: ran.append("never"))

    def outer():
        ran.append("a")
        TH.run_if(torch.tensor(False), lambda: ran.append("never"))
        TH.run_if(torch.tensor(True), lambda: ran.append("b"))

    TH.run_if(torch.tensor(True), outer)
    assert ran == ["outer", "outer", "a", "b"]


def nan_inputs(cfg):
    """A cloud of NaN returns after the voxel filter: every row invalid."""
    n = cfg.shapes.max_points
    return torch.full((n, 3), float("nan")), torch.zeros(n, dtype=torch.bool)


@pytest.mark.parametrize("mode", ["carry", "lazy"])
def test_cond_loop_on_a_nan_frame_runs_no_round(mode, monkeypatch):
    """A frame of NaN points: status degenerate, no line, no segment, no
    round run and no kernel launched, as JAX."""
    _, cfg = cloud_case("scene0")
    cfg = cfg.replace(voting=mode)
    p, v = nan_inputs(cfg)
    st, hi = Calls(V.vote_state), Calls(V.vote_histogram)
    rc, n_rounds = Rounds(monkeypatch).run(p, v, cfg, voting=TH.Voting(st, hi))
    assert (int(rc.status), int(rc.nlines), n_rounds, st.calls, hi.calls) == (1, 0, 0, [], [])
    assert not bool(rc.segments.valid.any()) and not bool(rc.segments.point_mask.any())
    rj = extract_lines_jit(jnp.asarray(p.numpy()), jnp.asarray(v.numpy()), cfg)
    assert (int(rj.status), int(rj.nlines)) == (1, 0)


@pytest.mark.parametrize("case", CASES)
def test_cond_loop_in_float64_equals_eager(case):
    """The float64 parity mode on every case: the loop's state and bodies
    follow the points' type, and in carry and lazy mode its result is the
    JAX package's in float64 (tests/test_torch_f64.py's tolerances):
    nlines, status, valid, points_size and point masks exact, floats within
    1e-6."""
    pts, cfg = cloud_case(case)
    p, v = torch_inputs(pts, cfg)
    p = p.double()
    tables = TH.direction_tables(cfg.granularity, "cpu", torch.float64)
    for mode in ("carry", "lazy"):
        c = cfg.replace(voting=mode, compute_dtype="float64")
        rc = TH.extract_lines(p, v, c, tables)
        assert rc.segments.a.dtype == torch.float64
        with jax.enable_x64(True):
            rj = jax.jit(lambda p, v: jax_extract_lines(p, v, c))(
                jnp.asarray(p.numpy()), jnp.asarray(v.numpy()))
            ref = {k: np.asarray(getattr(rj.segments, k)) for k in rj.segments._fields}
            want = (int(rj.nlines), int(rj.status))
        assert (int(rc.nlines), int(rc.status)) == want
        for k, w in ref.items():
            got = getattr(rc.segments, k).numpy()
            if w.dtype.kind in "biu":
                np.testing.assert_array_equal(got, w, err_msg=k)
            else:
                assert got.dtype == w.dtype == np.float64, k
                np.testing.assert_allclose(got, w, rtol=0, err_msg=k,
                                           atol=JAX_TOL_BY_FIELD.get(k, JAX_TOL))
        if case.startswith("scene"):
            assert int(rc.nlines) > 0


# ---------------------------------------------------------------- counts and build


def test_launch_counts_issued_captured_and_ran(monkeypatch):
    """The device counter behind ran_launches gains one a launch, captured
    or not; a launch recorded while a stream captures adds to `captured`,
    not `launches`, and needs its counter made before (prepare_counts);
    reset_counts zeroes the counts, the device counter in place (a captured
    graph keeps adding to the same tensor)."""
    fn = V.vote_histogram
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "captured", 0)
    monkeypatch.setattr(fn, "counts", {})
    monkeypatch.setattr(V.vote_state, "counts", {})
    monkeypatch.setattr(V.vote_decrement, "counts", {})
    monkeypatch.setattr(V.round_gates, "counts", {})
    cpu = torch.device("cpu")
    capturing = [True]
    # a CPU build of torch cannot ask whether a stream is capturing
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing[0])
    with pytest.raises(RuntimeError, match="prepare_counts"):
        V._count(fn, cpu)
    V.prepare_counts(cpu)
    assert set(V.vote_state.counts) == set(V.vote_decrement.counts) == {cpu}
    for _ in range(2):
        V._count(fn, cpu)
    capturing[0] = False
    for _ in range(3):
        V._count(fn, cpu)
    assert (fn.captured, fn.launches, V.ran_launches(fn)) == (2, 3, 5)
    counter = fn.counts[cpu]
    V.reset_counts()
    assert (fn.launches, V.ran_launches(fn), fn.captured) == (0, 0, 2)
    assert fn.counts[cpu] is counter


def test_the_library_is_built_from_both_sources_in_one_nvcc_call(monkeypatch, tmp_path):
    """One nvcc call compiles voting.cu, gates.cu, voxel.cu, graph_cond.cu and
    trace.cu into one library, named by a hash of the sources and the flags: another
    graph_cond.cu is another library."""
    calls = []

    def nvcc(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", nvcc)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLibrary(path))
    lib = _build._build_and_load(_build._SOURCE)
    (cmd,) = calls
    assert cmd[0] == "nvcc" and cmd[-5:] == [str(_build._SOURCE), str(_build._GATES),
                                             str(_build._VOXEL), str(_build._GRAPH_COND),
                                             str(_build._TRACE)]
    assert lib.path == str(_build.BuildInfo.path) and _build.BuildInfo.path.exists()
    assert {"pcs_vote_state", "pcs_vote_histogram", "pcs_round_gates", "pcs_if_begin",
            "pcs_if_end", "pcs_stream_create", "pcs_trace_stamp",
            "pcs_trace_now", "pcs_voxel_sums"} <= set(lib.entries)
    _build._build_and_load(_build._SOURCE)         # built: loaded, no nvcc
    assert len(calls) == 1 and _build.BuildInfo.seconds == 0.0
    other = tmp_path / "graph_cond.cu"
    other.write_text(_build._GRAPH_COND.read_text() + "// another\n")
    monkeypatch.setattr(_build, "_GRAPH_COND", other)
    assert _build._library_path((_build._SOURCE, _build._GATES, _build._VOXEL, other,
                                 _build._TRACE)) != lib.path
    _build._build_and_load(_build._SOURCE)
    assert len(calls) == 2


class FakeLibrary:
    """ctypes.CDLL's stand-in: records the entries whose signature is set."""

    def __init__(self, path):
        self.path, self.entries = path, {}

    def __getattr__(self, name):
        return self.entries.setdefault(name, type("Entry", (), {})())


def test_cond_captures_take_turns_across_threads(monkeypatch):
    """Two threads in cond_capture at once (two engines whose streaming
    workers capture their first frames together): the captures run one
    after the other, since they share the card's body streams, and each
    thread sees its own capture and counts its own nodes."""
    inside, overlaps, seen = [0], [], {}
    state = threading.Lock()

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode=None):
        with state:
            inside[0] += 1
            overlaps.append(inside[0])
        try:
            yield
        finally:
            with state:
                inside[0] -= 1

    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 0))
    monkeypatch.setattr(TH, "_streams_of", lambda device: ["body"] * TH._BODY_DEPTH)
    for name in ("_cuda_endAllocateToPool", "_cuda_beginAllocateCurrentThreadToPool",
                 "_cuda_releasePool"):
        monkeypatch.setattr(torch._C, name, lambda *a: None, raising=False)

    class Stream:
        device = torch.device("cuda", 0)

    def capture(k):
        with TH.cond_capture(object(), Stream(), "thread_local") as cap:
            assert TH._capturing.capture is cap and cap.nodes == 0
            time.sleep(0.05)
            cap.nodes += k                   # as run_if does, once a node
            seen[k] = TH._capturing.capture
        assert TH._capturing.capture is None

    threads = [threading.Thread(target=capture, args=(k,)) for k in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in threads)
    assert overlaps == [1, 1]
    assert seen[1] is not seen[2] and (seen[1].nodes, seen[2].nodes) == (1, 2)
