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


# ---------------------------------------------- seed for seed against SOAK.json

def jax_soak_record():
    with open(os.path.join(REPO, "SOAK.json")) as f:
        return json.load(f)


def jax_class(seed, f64):
    """SOAK.json's class for `seed` in the base mode, None if it matched."""
    for b in jax_soak_record()["batches"]:
        if (b["mode"] == "base" and b["f64"] == f64
                and b["seed_start"] <= seed < b["seed_start"] + b["n"]):
            return next((d["class"] for d in b["diverging"] if d["seed"] == seed), None)
    raise AssertionError(f"SOAK.json never ran base seed {seed} (f64={f64})")


@pytest.mark.parametrize("seed,f64", [(5011, False), (5018, False), (5023, False),
                                      (5024, False), (5309, True), (5316, True)])
def test_soak_jax_divergent_seed_is_the_knife_edge(soak, seed, f64):
    """Seeds the JAX soak found divergent diverge on the port's plain path
    too, in the same class: the reference's abort on b.x == 0.0."""
    errs, klass, _ = soak.classify(seed, "base", f64, "cpu", True)
    assert jax_class(seed, f64) == "bx-knife-edge"
    assert errs and klass == "bx-knife-edge", (klass, errs)


@pytest.mark.parametrize("seed,f64", [(5019, False), (5020, False), (5305, True)])
def test_soak_jax_clean_seed_matches_the_oracle(soak, seed, f64):
    errs, klass = soak.run_pair(seed, "base", f64, "cpu")
    assert jax_class(seed, f64) is None
    assert not errs, (klass, errs)


def fake_jax_soak():
    """Two adjacent base batches and one f64 batch, as SOAK.json lays them out."""
    def div(seed, klass="bx-knife-edge"):
        return {"seed": seed, "class": klass, "f64_matches_oracle": None, "errors": ["x"]}
    return {"batches": [
        {"rev": "r1", "mode": "base", "f64": False, "seed_start": 100, "n": 10,
         "diverging": [div(101), div(104), div(108)]},
        {"rev": "r2", "mode": "base", "f64": False, "seed_start": 110, "n": 10,
         "diverging": [div(111)]},
        {"rev": "r3", "mode": "base", "f64": True, "seed_start": 100, "n": 10,
         "diverging": [div(102)]},
    ]}


def port_batch(s0, n, diverging, f64=False, mode="base"):
    return {"mode": mode, "f64": f64, "seed_start": s0, "n": n,
            "diverging": [{"seed": s, "class": k} for s, k in diverging]}


def test_compare_with_jax_sets(soak):
    """both (each side's class), only-port, only-jax and class-differs, on
    hand-made records; a port class of real is unexplained, a seed the JAX
    soak alone found divergent is explained by its class."""
    cmp = soak.compare_with_jax(
        port_batch(100, 10, [(101, "bx-knife-edge"), (103, "bx-knife-edge"),
                             (108, "f32-gate-boundary")]), fake_jax_soak())
    assert cmp["jax_batch"] == [{"rev": "r1", "seed_start": 100, "n": 10}]
    assert cmp["both"] == [{"seed": 101, "port": "bx-knife-edge", "jax": "bx-knife-edge"},
                           {"seed": 108, "port": "f32-gate-boundary", "jax": "bx-knife-edge"}]
    assert cmp["only_port"] == [{"seed": 103, "port": "bx-knife-edge"}]
    assert cmp["only_jax"] == [{"seed": 104, "jax": "bx-knife-edge"}]
    assert cmp["class_differs"] == [{"seed": 108, "port": "f32-gate-boundary",
                                     "jax": "bx-knife-edge"}]
    assert cmp["unexplained"] == []
    real = soak.compare_with_jax(port_batch(100, 10, [(105, "real"), (101, "real")]),
                                 fake_jax_soak())
    assert real["unexplained"] == [101, 105]
    f64 = soak.compare_with_jax(port_batch(100, 10, [], f64=True), fake_jax_soak())
    assert f64["jax_batch"][0]["rev"] == "r3" and f64["only_jax"] == [
        {"seed": 102, "jax": "bx-knife-edge"}]


def test_compare_with_jax_spans_batches(soak):
    """A range across two JAX batches is compared with both, seeds outside
    the range are left out, and a seed no JAX batch ran is refused."""
    cmp = soak.compare_with_jax(port_batch(105, 10, [(111, "bx-knife-edge")]),
                                fake_jax_soak())
    assert [b["rev"] for b in cmp["jax_batch"]] == ["r1", "r2"]
    assert cmp["both"] == [{"seed": 111, "port": "bx-knife-edge", "jax": "bx-knife-edge"}]
    assert cmp["only_jax"] == [{"seed": 108, "jax": "bx-knife-edge"}]
    assert cmp["only_port"] == [] and cmp["unexplained"] == []
    with pytest.raises(ValueError, match=r"\[120, 121\]"):
        soak.compare_with_jax(port_batch(118, 4, []), fake_jax_soak())
    with pytest.raises(ValueError):
        soak.compare_with_jax(port_batch(100, 2, [], mode="g6"), fake_jax_soak())


def test_soak_main_against_jax(soak, monkeypatch, tmp_path):
    """--against-jax stores the comparison as the batch's "jax_soak" field;
    --jax-batches runs the JAX record's batches seed for seed, all of them
    or those of the mode or dtype its flags name; a range the JAX soak never
    ran is refused before it runs."""
    jax_path = tmp_path / "SOAK.json"
    jax_path.write_text(json.dumps(fake_jax_soak()))
    monkeypatch.setattr(soak, "JAX_SOAK", str(jax_path))
    ran = []

    def run_pair(seed, mode, f64, device):
        ran.append((seed, f64))
        return (["seg0 endpoints drift 1"], "bx-knife-edge") if seed in (101, 103) else ([], "real")

    monkeypatch.setattr(soak, "run_pair", run_pair)
    out = str(tmp_path / "out.json")
    assert soak.main(["5", "100", "--device", "cpu", "--against-jax", "--artifact", out]) == 0
    assert soak.main(["--jax-batches", "--f64", "--device", "cpu",
                      "--artifact", out]) == 0
    assert ran[5:] == [(s, True) for s in range(100, 110)]
    with open(out) as f:
        data = json.load(f)
    first, second = data["batches"]
    assert first["jax_soak"]["both"] == [{"seed": 101, "port": "bx-knife-edge",
                                          "jax": "bx-knife-edge"}]
    assert first["jax_soak"]["only_port"] == [{"seed": 103, "port": "bx-knife-edge"}]
    assert first["jax_soak"]["only_jax"] == [{"seed": 104, "jax": "bx-knife-edge"}]
    assert (second["f64"], second["seed_start"], second["n"]) == (True, 100, 10)
    assert second["jax_soak"]["only_jax"] == [{"seed": 102, "jax": "bx-knife-edge"}]
    assert set(first) - {"jax_soak"} == set(soak.run_batch(0, 0, device="cpu")) | {
        "rev", "device_name"}
    with pytest.raises(SystemExit):
        soak.main(["2", "130", "--device", "cpu", "--against-jax", "--no-artifact"])
    assert len(ran) == 15
    assert soak.main(["--jax-batches", "--device", "cpu", "--no-artifact"]) == 0
    assert ran[15:] == [(s, False) for s in range(100, 120)] + [(s, True) for s in range(100, 110)]
    assert soak.main(["--jax-batches", "--g6", "--device", "cpu", "--no-artifact"]) == 0
    assert len(ran) == 45
    monkeypatch.setattr(soak, "run_pair", lambda *a: (["seg0 endpoints drift 1"], "real"))
    assert soak.main(["1", "100", "--device", "cpu", "--f64", "--no-verify",
                      "--against-jax", "--no-artifact"]) == 1


def card_batches():
    with open(os.path.join(REPO, "SOAK_torch.json")) as f:
        return [b for b in json.load(f)["batches"] if "jax_soak" in b]


def test_soak_torch_jax_comparisons_recompute(soak):
    """Every "jax_soak" field of SOAK_torch.json is what compare_with_jax
    makes of the two committed records, and none leaves a seed unexplained."""
    record = jax_soak_record()
    batches = card_batches()
    assert batches
    for b in batches:
        assert soak.compare_with_jax(b, record) == b["jax_soak"], b["seed_start"]
        assert b["jax_soak"]["unexplained"] == [] and not b["counts"].get("real")


def test_soak_torch_covers_the_jax_soak_on_the_card(soak):
    """The card's batches hold every seed of SOAK.json, mode for mode."""
    ran = {}
    for b in card_batches():
        if b["device"] == "cuda" and b["device_name"].startswith("NVIDIA H100"):
            ran.setdefault((b["mode"], b["f64"]), set()).update(
                range(b["seed_start"], b["seed_start"] + b["n"]))
    for b in jax_soak_record()["batches"]:
        seeds = set(range(b["seed_start"], b["seed_start"] + b["n"]))
        assert seeds <= ran.get((b["mode"], b["f64"]), set()), (b["mode"], b["seed_start"])


# ------------------------------------------- the seeds divergent on the card only

def fake_trace(oracle_bx, torch_bx, oracle_st, torch_st, errors=("seg0 endpoints drift 1",)):
    side = lambda bx, st: {"bx": bx, "status": st, "nblines": [len(x) for x in bx]}
    return {"oracle": side(oracle_bx, oracle_st), "torch": side(torch_bx, torch_st),
            "errors": list(errors)}


def test_knife_edge_frames_on_hand_made_traces(soak):
    """A frame is the knife edge when the first refinement with b.x == 0.0
    on one side only has rounding noise on the other, the same when no such
    refinement is there and status and line count agree, unexplained else;
    a divergent seed is explained only with no frame unexplained."""
    tr = fake_trace([[0.3, 2e-10, 0.4], [0.5], [0.2, 0.0]],
                    [[0.3, 0.0], [0.5], [0.2, 0.0]], [0, 0, 3], [3, 0, 3])
    assert [(v["verdict"], v.get("round")) for v in soak.knife_edge_frames(tr)] == [
        ("knife-edge", 1), ("same", None), ("same", None)]
    assert soak.knife_edge_frames(tr)[0]["other_bx"] == 2e-10
    assert soak.knife_edge_explained(tr)
    tilted = fake_trace([[0.3, 0.01]], [[0.3, 0.0]], [0], [3])
    assert soak.knife_edge_frames(tilted)[0]["verdict"] == "unexplained"
    assert not soak.knife_edge_explained(tilted)
    gate = fake_trace([[0.3], [0.0]], [[0.3, 0.2], [0.0]], [0, 3], [0, 3])
    assert [v["verdict"] for v in soak.knife_edge_frames(gate)] == ["unexplained", "same"]
    assert not soak.knife_edge_explained(fake_trace([[0.3]], [[0.3]], [0], [0]))
    assert soak.knife_edge_explained(fake_trace([[0.3]], [[0.3]], [0], [0], errors=()))


@pytest.mark.parametrize("seed,f64", [(5013, False), (5131, False), (5400, True)])
def test_soak_card_only_seed_beside_the_jax_package(soak, monkeypatch, seed, f64):
    """The seeds the card alone finds divergent, on the CPU beside the JAX
    package's own per-frame statuses on the JAX soak's draw of the seed: the
    two packages' oracles agree frame for frame; where the JAX package and
    the port part, one aborts on b.x == 0.0 and the other does not; and
    every frame where the port and the oracle part starts at a refinement
    whose b.x is 0.0 on one side and rounding noise on the other."""
    import jax
    import numpy as np

    from pointcloud_segmentation_tpu.runtime import SegmentationEngine
    from tools import parity_soak as jax_tool

    trace = soak.knife_edge_trace(seed, "base", f64, "cpu")
    cfg_port, frames = soak.random_case(seed, "base", f64)
    monkeypatch.setattr(jax_tool, "F64", f64)
    monkeypatch.setattr(jax_tool, "MODE", "base")
    statuses = {}
    with jax.enable_x64(f64):
        cfg = jax_tool.random_cfg(np.random.default_rng(seed))
        assert (cfg.granularity, cfg.radius_sizes, cfg.opt_nlines, cfg.opt_minvotes,
                cfg.compute_dtype) == (cfg_port.granularity, cfg_port.radius_sizes,
                                       cfg_port.opt_nlines, cfg_port.opt_minvotes,
                                       cfg_port.compute_dtype)
        for backend in ("oracle", "jax"):
            recs = SegmentationEngine(cfg, backend=backend).run_replay(frames)
            statuses[backend] = [r["status"] for r in recs]
    assert statuses["oracle"] == trace["oracle"]["status"]
    for j, p in zip(statuses["jax"], trace["torch"]["status"], strict=True):
        assert j == p or {j, p} == {0, soak.STATUS_BX_ZERO}, (statuses["jax"], j, p)
    verdicts = soak.knife_edge_frames(trace)
    assert all(v["verdict"] == "knife-edge" for v in verdicts if v["status"][0] != v["status"][1])
    assert "unexplained" not in [v["verdict"] for v in verdicts], verdicts
    assert soak.knife_edge_explained(trace)
