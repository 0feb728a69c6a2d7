"""The `tests_g4` configuration and its cell `tests_g4.replay`: the 7-beam
flight of `tests_g6` at the Hough library's granularity 4, which the port
votes by carry.  On the CPU, at granularity 4 itself on 8 frames of the
flight (every 136th), a run is `correct`, a broken one is not, and the
control fails; the histogram kernel's roofline count on hand-worked shapes.

On the card, at the cell's own size on the control's three seeds, printing
the numbers each limit was set above:

    python -m pytest benchmark/tests/test_bench_tests_g4.py -m cuda -q -s
"""

import json
from pathlib import Path

import pytest

from benchmark.harness import Cell, Run, execute
from benchmark.reference.compare import NUMBERS, judge, load_limits
from benchmark.roofline import histogram as RH
from benchmark.tests.test_bench_control import SEEDS, control_numbers
from benchmark.tests.test_bench_faults import _answer_altered
from benchmark.trace import TraceSummary

CELL = "tests_g4.replay"
CONFIGS = Path(__file__).resolve().parent.parent / "configs"
EVERY = 136              # 8 frames of the 1,081-frame flight
# frames a run of the cell processes (warm-up and window; PERF.md)
CELL_FRAMES = 1890
DIFFERENT = ("name", "source", "deployment", "why", "assumed")


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_the_configuration_is_tests_g6_at_granularity_4():
    g4, g6 = _config("tests_g4"), _config("tests_g6")
    assert set(g4) - set(DIFFERENT) == set(g6) - set(DIFFERENT)
    for key in set(g4) - set(DIFFERENT):
        if key == "yaml":
            assert dict(g4[key], granularity=6) == g6[key]
        else:
            assert g4[key] == g6[key], key
    assert g4["yaml"]["granularity"] == 4 and g4["reduced"] == []
    assert g4["assumed"][:len(g6["assumed"])] == g6["assumed"]
    assert len(g4["assumed"]) == len(g6["assumed"]) + 1


def test_the_port_votes_the_configuration_by_carry():
    from pointcloud_segmentation_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig.from_dict(Cell(CELL).config["yaml"])
    assert cfg.num_directions == 1281 and cfg.num_x_max == 79
    assert cfg.voting_mode == "carry"


def _run(fault=None):
    cell = Cell(CELL)
    cell.traffic = dict(cell.traffic, trace_skip_frames=2, trace_frames=2)
    run = Run(cell, 2**31 + 21, 2.0, False, "cpu", fault=fault, every=EVERY)
    res = execute(run)
    res["world"] = [a[2] for a in run.answers if a is not None]
    return res


@pytest.mark.parametrize("fault", [None, _answer_altered])
def test_a_run_at_granularity_4_is_correct_and_a_broken_one_is_not(fault):
    res = _run(fault)
    assert res["attempted"] > 0
    if fault is None:
        assert res["correct"], res["checks"]
        assert max(res["world"]) > 0
    else:
        assert not res["correct"], res["checks"]


def test_the_control_fails_at_granularity_4_on_the_cpu():
    numbers = control_numbers(CELL, 2**31 + 7, 8, "cpu", every=EVERY)
    assert not judge(numbers, load_limits(CELL)), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_fails_on_the_card(seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    numbers = control_numbers(CELL, seed, CELL_FRAMES, "cuda", workers=6)
    limits = load_limits(CELL)
    print(f"control {CELL} seed {seed}: " + " ".join(
        f"{k} {numbers[k]!r} (limit {limits.get(k)!r})" for k in NUMBERS))
    assert not judge(numbers, limits), numbers


# ------------------------------------------------------------------ roofline

def test_the_grid_side_is_the_ports_at_the_cells_window():
    from benchmark.reference.config import RefConfig

    cfg = RefConfig.from_yaml_dict(_config("tests_g4")["yaml"])
    assert RH.grid_side(cfg.window_size, cfg.opt_dx) == 79
    assert RH.grid_side(3.0, 0.1) == 46            # floor(4.5 / 0.1 + 0.5) + 1


def test_a_g4_launch_is_bound_by_its_bytes():
    # 1,281 directions, 4,096 points, all active, 79 x 79 cells
    b = 4096 * 12 + 4096 + 1281 * 24 + 12 + 1281 * 79 * 79 * 4
    assert RH.launch_bytes(1281, 4096, 79) == b == 32_062_888
    assert RH.launch_ops(1281, 4096) == 24 * 1281 * 4096 == 125_927_424
    sec, kind = RH.least_seconds(1281, 4096, 4096, 79)
    assert kind == "bytes" and sec == pytest.approx(32_062_888 / 3.35e12, rel=1e-12)
    assert RH.least_seconds_at(1281, 79) == pytest.approx(32_009_640 / 3.35e12, rel=1e-12)


def test_at_the_cells_shape_the_operations_never_rule():
    floor = RH.least_seconds_at(1281, 79)
    for active in range(0, 4097):
        sec, kind = RH.least_seconds(1281, 4096, active, 79)
        assert kind == "bytes" and floor <= sec <= floor * 1.0017
    # a small grid with many points is bound by operations
    assert RH.least_seconds(1281, 4096, 4096, 10)[1] == "operations"


def _summary(kernels):
    return TraceSummary(window_s=1.0, frames=1, busy_s=1.0, kernels=kernels, gaps=[])


def test_the_reader_takes_the_histogram_launches_of_the_eager_trace():
    from benchmark.harness import metric_reader

    read = metric_reader("vote_histogram_roofline")
    hist = "void (anonymous namespace)::vote_kernel<false>(float const*, unsigned char const*)"
    state = "void (anonymous namespace)::vote_kernel<true>(float const*, unsigned char const*)"
    trace = _summary({hist: (10 * 19.1102e-6, 10), state: (1.0, 3)})
    want = 100.0 * 10 * (32_009_640 / 3.35e12) / (10 * 19.1102e-6)
    assert read({"eager_trace": trace, "launches": []}) == pytest.approx(want, rel=1e-12)
    assert read({"eager_trace": _summary({state: (1.0, 3)}), "launches": []}) is None
    assert read({"eager_trace": None, "launches": None}) is None
