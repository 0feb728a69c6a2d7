"""The control of the reference check: the reference itself, put in the
program's place and computed one step below the configuration's float32
(TF32 for the voxel grid's float32 matrix product, which the program runs
with TF32 off), must come out as not correct.

On the card, at each cell's own size (the frames a run processes) and on
three seeds, printing the numbers each limit was set above:

    python -m pytest benchmark/tests/test_bench_control.py -m cuda -q -s

On the CPU, at a size a test run holds (granularity 3, every 20th frame).
"""

import pytest

from benchmark.harness import Cell, make_frames
from benchmark.reference.compare import NUMBERS, compare, judge, load_limits, run_reference

# frames a run of each cell processes (warm-up and window; PERF.md)
CELL_FRAMES = {"tests_g6.replay": 1000, "tests_g6.stream30": 600}
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def control_numbers(name, seed, n_frames, device, yaml_overrides=None, every=1,
                    workers=1):
    cell = Cell(name)
    yaml = dict(cell.config["yaml"], **(yaml_overrides or {}))
    frames = make_frames(cell.config, seed, workers, every)
    keys = [k % len(frames) for k in range(n_frames)]
    seq = [(frames[i].points, frames[i].position, frames[i].quat_wxyz) for i in keys]
    ref = run_reference(yaml, seq, device, keys=keys)
    control = run_reference(yaml, seq, device, precision="tf32", keys=keys)
    return compare(control, ref)


@pytest.mark.parametrize("name", ["tests_g6.replay", "tests_g6.stream30"])
def test_control_fails_on_the_cpu(name):
    numbers = control_numbers(name, 2**31 + 7, 20, "cpu",
                              {"granularity": 3, "min_pca_coeff": 0.99}, every=20)
    assert not judge(numbers, load_limits(name)), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", list(CELL_FRAMES))
def test_control_fails_on_the_card(name, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    numbers = control_numbers(name, seed, CELL_FRAMES[name], "cuda", workers=6)
    limits = load_limits(name)
    print(f"control {name} seed {seed}: " + " ".join(
        f"{k} {numbers[k]!r} (limit {limits.get(k)!r})" for k in NUMBERS))
    assert not judge(numbers, limits), numbers
