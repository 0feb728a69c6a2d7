"""The rest of a run, on the CPU at a small size (granularity 3 with
min_pca_coeff 0.99, so the 7-beam map grows at that size, every
20th frame of the flight, a 2-second window), with the timed path sound
and then broken underneath: `correct` must come out true, then false once
for each fault a cell can have.  (One chip: no exchange between chips to
leave out.)"""

import pytest
import torch

from benchmark.harness import Cell, Run, execute

CELLS = ["tests_g6.replay", "tests_g6.stream30"]


def _state_unchanged(eng):
    """Each frame's step hands back the state it was given."""
    inner = eng._dispatch

    def dispatch(points, position, quat):
        before = eng._state
        out = inner(points, position, quat)
        eng._state = before
        return out
    eng._dispatch = dispatch


def _half_the_points(eng):
    """Each frame's step sees the first half of its cloud only."""
    inner = eng._dispatch

    def dispatch(points, position, quat):
        return inner(points[: len(points) // 2], position, quat)
    eng._dispatch = dispatch


def _answer_altered(eng):
    """Each frame's nblines is one more than the step found."""
    inner = eng._dispatch

    def dispatch(points, position, quat):
        out, scalars = inner(points, position, quat)
        return out, scalars + torch.tensor([0, 1, 0, 0], dtype=scalars.dtype)
    eng._dispatch = dispatch


def _run(name, fault=None):
    cell = Cell(name)
    tr = dict(cell.traffic, trace_skip_frames=2, trace_frames=2)
    if tr["mode"] == "stream":
        tr["rate_hz"] = 10.0
    cell.traffic = tr
    run = Run(cell, 2**31 + 21, 2.0, False, "cpu", fault=fault, every=20,
              yaml_overrides={"granularity": 3, "min_pca_coeff": 0.99})
    res = execute(run)
    res["world"] = [a[2] for a in run.answers if a is not None]
    return res


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    assert max(res["world"]) > 0        # the map grows: a fault has something to break


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_points, _answer_altered])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_is_not_correct(name, fault):
    res = _run(name, fault)
    assert not res["correct"], res["checks"]
