"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Names are compared whole, by
the part before the first dot: the port's name begins with the JAX
package's."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
JAX_NAMES = {"jax", "jaxlib", "flax", "pointcloud_segmentation_tpu"}
PROGRAM = "pointcloud_segmentation_tpu_torch"


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def _sources(sub=""):
    return [p for p in (BENCH / sub).rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_no_source_of_the_harness_imports_jax():
    for path in _sources():
        assert not (_top_level_imports(path) & JAX_NAMES), path


def test_the_reference_and_frames_import_nothing_of_the_program():
    for sub in ("reference", "sim", "roofline"):
        for path in _sources(sub):
            assert PROGRAM not in _top_level_imports(path), path


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return set(out.stdout.split())


def test_a_run_loads_no_jax_in_its_process():
    mods = _modules_after(
        "from benchmark import harness\n"
        "from benchmark.harness import Cell, Run, metric_reader\n"
        "import pointcloud_segmentation_tpu_torch\n"
        "from pointcloud_segmentation_tpu_torch import SegmentationEngine\n"
        "import json\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "[metric_reader(m['name']) for m in b['per_layer']]\n"
        "from benchmark import trace\n"
        "from benchmark.reference import compare")
    assert not (mods & JAX_NAMES), mods & JAX_NAMES
    assert PROGRAM in mods


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules_after("from benchmark.reference import compare, pipeline\n"
                          "from benchmark.sim import simulator\n"
                          "from benchmark.roofline import voting")
    assert PROGRAM not in mods and not (mods & JAX_NAMES)


def test_banned_modules_compares_whole_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "pointcloud_segmentation_tpu_torch_fake", object())
    assert "pointcloud_segmentation_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.banned_modules() == ["jax"]


def test_a_run_without_a_card_fails_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "tests_g6.replay",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
