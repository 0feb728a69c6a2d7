"""tools/parity_soak_torch.py on the CPU (--device cpu, the kernels' plain
versions) at the soak's smallest configs: a few seeds end to end, the
classification of divergences, and the artifact's bookkeeping."""

import importlib.util
import json
import os

import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def soak():
    spec = importlib.util.spec_from_file_location(
        "parity_soak_torch", os.path.join(REPO, "tools", "parity_soak_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [2020, 2021, 2022])
def test_soak_seed_matches_the_oracle(soak, seed):
    """Oracle backend against torch backend on one randomly drawn config and
    scene (granularity 1-3, a 32x32 sensor, 4-9 frames): no divergence, or one
    of the two documented classes, never an unexplained one."""
    errs, klass, _ = soak.classify(seed, "base", False, "cpu", True)
    assert not errs or klass in ("bx-knife-edge", "f32-gate-boundary"), (klass, errs)


def test_soak_seed_in_float64_matches_the_oracle(soak):
    errs, klass = soak.run_pair(2021, f64=True, device="cpu")
    assert not errs, (klass, errs)


def test_soak_classifies_divergences(soak, monkeypatch):
    """A mismatch with a BX_ZERO status is the knife edge; a float32 mismatch
    that float64 repairs is the gate boundary; one that float64 keeps, and a
    crash, are real and fail the batch."""
    calls = []

    def fake(outcomes):
        def run_pair(seed, mode, f64, device):
            calls.append((seed, f64))
            return outcomes[(seed, f64)]
        return run_pair

    monkeypatch.setattr(soak, "run_pair", fake({
        (1, False): ([], "real"),
        (2, False): (["segment count 1 vs 2"], "bx-knife-edge"),
        (3, False): (["segment count 1 vs 2"], "f32-gate-boundary?"),
        (3, True): ([], "real"),
        (4, False): (["segment count 1 vs 2"], "f32-gate-boundary?"),
        (4, True): (["segment count 1 vs 2"], "real"),
    }))
    batch = soak.run_batch(4, 1, device="cpu")
    assert batch["counts"] == {"bx-knife-edge": 1, "f32-gate-boundary": 1, "real": 1}
    assert [(d["seed"], d["class"], d["f64_matches_oracle"]) for d in batch["diverging"]] == [
        (2, "bx-knife-edge", None), (3, "f32-gate-boundary", True), (4, "real", False)]
    assert (3, True) in calls and (2, True) not in calls

    def boom(*a):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(soak, "run_pair", boom)
    errs, klass, _ = soak.classify(9, "base", False, "cpu", True)
    assert klass == "real" and "RuntimeError" in errs[0]


def test_soak_main_writes_its_own_artifact(soak, monkeypatch, tmp_path):
    """main appends a batch to SOAK_torch.json (here redirected), never to the
    JAX soak's SOAK.json, and exits 1 only on an unexplained divergence."""
    path = str(tmp_path / "SOAK_torch.json")
    monkeypatch.setattr(soak, "ARTIFACT", path)
    before = os.stat(os.path.join(REPO, "SOAK.json")).st_mtime_ns
    assert soak.main(["2", "2020", "--device", "cpu"]) == 0
    assert soak.main(["1", "2022", "--device", "cpu", "--f64"]) == 0
    with open(path) as f:
        data = json.load(f)
    assert data["totals"]["seeds_run"] == 3 and data["totals"]["unexplained"] == 0
    assert [(b["device"], b["device_name"], b["f64"], b["mode"]) for b in data["batches"]] == [
        ("cpu", "cpu", False, "base"), ("cpu", "cpu", True, "base")]
    assert os.stat(os.path.join(REPO, "SOAK.json")).st_mtime_ns == before
    monkeypatch.setattr(soak, "run_pair", lambda *a: (["seg0 endpoints drift 1"], "real"))
    assert soak.main(["1", "7", "--device", "cpu", "--f64", "--no-artifact"]) == 1
