"""The `tests_g6_tof224` configuration and its cell `tests_g6_tof224.replay`:
the 7-beam flight of `tests_g6` seen by the drone's own 224x172 ToF, with
the capacities that sensor needs.  On the CPU, at granularity 3 (with
min_pca_coeff 0.99, so the 7-beam map grows at that size) on 8 frames of
the flight (every 136th), a run is `correct`, a broken one is not, and
the control fails; the voxel kernel's roofline count on hand-worked
shapes.

On the card, at the cell's own size on the control's three seeds, printing
the numbers each limit was set above:

    python -m pytest benchmark/tests/test_bench_tests_g6_tof224.py -m cuda -q -s
"""

import json
from pathlib import Path

import pytest

from benchmark.harness import Cell, Run, execute
from benchmark.reference.compare import NUMBERS, judge, load_limits
from benchmark.roofline import voxel as RV
from benchmark.tests.test_bench_control import SEEDS, control_numbers
from benchmark.tests.test_bench_faults import _answer_altered
from benchmark.trace import TraceSummary

CELL = "tests_g6_tof224.replay"
CONFIGS = Path(__file__).resolve().parent.parent / "configs"
EVERY = 136              # 8 frames of the 1,081-frame flight
SMALL = {"granularity": 3, "min_pca_coeff": 0.99}
# frames a run of the cell processes (warm-up and window; PERF.md)
CELL_FRAMES = 2960
DIFFERENT = ("name", "source", "deployment", "assumed")


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_the_configuration_is_tests_g6_with_the_224x172_sensor():
    new, g6 = _config("tests_g6_tof224"), _config("tests_g6")
    assert set(new) == set(g6)
    for key in set(new) - set(DIFFERENT):
        if key == "yaml":
            assert {k: v for k, v in new[key].items()
                    if k not in ("max_raw_points", "max_points")} == g6[key]
        elif key == "sensor":
            assert dict(new[key], width=64, height=64) == g6[key]
        else:
            assert new[key] == g6[key], key
    assert (new["sensor"]["width"], new["sensor"]["height"]) == (224, 172)
    assert new["yaml"]["max_raw_points"] == 224 * 172
    assert new["yaml"]["max_points"] % 1024 == 0 and new["yaml"]["max_points"] < 65_536
    assert new["reduced"] == [] and new["assumed"][:len(g6["assumed"])] == g6["assumed"]


def test_the_port_is_sized_by_the_configuration():
    from pointcloud_segmentation_tpu_torch.config import PipelineConfig

    from benchmark.reference.config import RefConfig

    yaml = Cell(CELL).config["yaml"]
    cfg = PipelineConfig.from_dict(yaml)
    assert (cfg.shapes.max_raw_points, cfg.shapes.max_points) == (38_528, 8192)
    assert cfg.voting_mode == "lazy" and cfg.num_directions == 20_481
    # the reference reads only its own keys: the same map as tests_g6's
    assert RefConfig.from_yaml_dict(yaml) == RefConfig.from_yaml_dict(_config("tests_g6")["yaml"])


def _run(fault=None):
    cell = Cell(CELL)
    cell.traffic = dict(cell.traffic, trace_skip_frames=2, trace_frames=2)
    run = Run(cell, 2**31 + 23, 2.0, False, "cpu", yaml_overrides=SMALL, fault=fault,
              every=EVERY)
    res = execute(run)
    res["world"] = [a[2] for a in run.answers if a is not None]
    res["rows"] = {len(run.frames[i].points) for i in run.order}
    return res


@pytest.mark.parametrize("fault", [None, _answer_altered])
def test_a_run_at_224x172_is_correct_and_a_broken_one_is_not(fault):
    res = _run(fault)
    assert res["attempted"] > 0 and res["rows"] == {38_528}
    if fault is None:
        assert res["correct"], res["checks"]
        assert max(res["world"]) > 0
    else:
        assert not res["correct"], res["checks"]


def test_the_control_fails_at_224x172_on_the_cpu():
    numbers = control_numbers(CELL, 2**31 + 7, 20, "cpu", SMALL, every=20)
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

def test_a_call_moves_its_keys_points_and_voxels_once():
    # 38,528 sorted rows (4-byte key, 12-byte point), 8,192 voxels (12-byte
    # centroid, 1-byte flag), the 4-byte count
    assert RV.call_bytes(38_528, 8192) == 38_528 * 16 + 8192 * 13 + 4 == 722_948
    assert RV.call_bytes(8192, 4096) == 184_324
    assert RV.least_seconds(38_528, 8192) == pytest.approx(722_948 / 3.35e12, rel=1e-12)


def _summary(kernels):
    return TraceSummary(window_s=1.0, frames=1, busy_s=1.0, kernels=kernels, gaps=[])


def test_the_reader_takes_both_launches_of_each_call():
    from benchmark.harness import metric_reader

    read = metric_reader("voxel_sums_roofline")
    sums = ("void (anonymous namespace)::voxel_sums_kernel<float>(int const*, float const*, "
            "int, int, int const*, int, int, float*, bool*, int*, long long*, long long*)")
    starts = "(anonymous namespace)::voxel_starts_kernel(int const*, int, int, int*)"
    state = "void (anonymous namespace)::vote_kernel<true>(float const*, unsigned char const*)"
    trace = _summary({sums: (24 * 6e-6, 24), starts: (24 * 2e-6, 24), state: (1.0, 3)})
    want = 100.0 * 24 * (722_948 / 3.35e12) / (24 * 8e-6)
    assert read({"eager_trace": trace, "launches": []}) == pytest.approx(want, rel=1e-12)
    # a program without the kernel (the parent of the kernel's change): nothing to read
    assert read({"eager_trace": _summary({state: (1.0, 3)}), "launches": []}) is None
    assert read({"eager_trace": None, "launches": None}) is None
