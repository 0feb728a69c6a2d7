"""What the ranks of tests/test_torch_sharding.py run: one spawned group of
gloo processes on the CPU works through a list of cases and hands numpy
results back.  Kept apart from the test file so that a rank imports torch and
the port only (the test file imports JAX too)."""

import traceback

import numpy as np
import torch
import torch.distributed as dist

from pointcloud_segmentation_tpu_torch.convert import world_state_to_numpy
from pointcloud_segmentation_tpu_torch.ops.hough import PLAIN
from pointcloud_segmentation_tpu_torch.parallel import (
    make_batched_extract, make_mesh, make_multichip_step, make_tp_process_frame)
from pointcloud_segmentation_tpu_torch.parallel.sharding import _padded_dir_tables
from pointcloud_segmentation_tpu_torch.pipeline import compute_dtype
from pointcloud_segmentation_tpu_torch.worldmap import init_world

def segs_to_numpy(segs) -> dict:
    return {k: getattr(segs, k).numpy() for k in segs._fields}


def _inputs(cfg, frames, device):
    clouds, poss, quats = frames
    dt = compute_dtype(cfg)
    return (torch.from_numpy(clouds).to(device), torch.from_numpy(poss).to(device, dt),
            torch.from_numpy(quats).to(device, dt))


def case_world(rank, device, **kw):
    return {"world": dist.get_world_size(), "backend": dist.get_backend()}


def case_multichip(rank, device, cfg, n_batch, n_dir, frames):
    mesh = make_mesh(n_batch, n_dir, device)
    if not mesh.member:
        return {"member": False}
    step = make_multichip_step(cfg, mesh, PLAIN)
    state, nlines, statuses = step(init_world(cfg, device), *_inputs(cfg, frames, device))
    return {"state": world_state_to_numpy(state), "nlines": nlines.numpy(),
            "status": statuses.numpy(),
            "collectives": 0 if mesh.dir_group is None else mesh.dir_group.collectives}


def case_extract(rank, device, cfg, n_batch, n_dir, frames):
    mesh = make_mesh(n_batch, n_dir, device)
    if not mesh.member:
        return {"member": False}
    segs, nlines, statuses = make_batched_extract(cfg, mesh, PLAIN)(
        *_inputs(cfg, frames, device))
    return {"segs": segs_to_numpy(segs), "nlines": nlines.numpy(),
            "status": statuses.numpy()}


def case_tp(rank, device, cfg, n_dir, frames):
    mesh = make_mesh(1, n_dir, device)
    step = make_tp_process_frame(cfg, mesh, PLAIN)
    clouds, poss, quats = _inputs(cfg, frames, device)
    state, outs = init_world(cfg, device), []
    for i in range(clouds.shape[0]):
        state, out = step(state, clouds[i], poss[i], quats[i])
        outs.append((int(out.nlines), int(out.status), int(out.world_count)))
    tables = _padded_dir_tables(cfg, n_dir, device)
    return {"state": world_state_to_numpy(state), "frames": np.array(outs),
            "dirs_dtype": str(tables[0].dtype), "c1_dtype": str(tables[1].dtype),
            "rows": tables[0].shape[0]}


def case_winner(rank, device, M, b_idx, cell):
    """Each rank holds one (M, b, cell) and a row that names it."""
    mesh = make_mesh(1, len(M), device)
    mark = torch.full((3,), float(rank))
    c, b0, c1row, c2row = mesh.dir_group.winner(
        torch.tensor(M[rank], dtype=torch.int32), torch.tensor(b_idx[rank], dtype=torch.int32),
        torch.tensor(cell[rank], dtype=torch.int32), -mark * 0.0, mark, mark + 0.5)
    return {"cell": int(c), "b0": b0.numpy(), "c1row": c1row.numpy(),
            "c2row": c2row.numpy(),
            "bound": int(mesh.dir_group.max(torch.tensor(M[rank], dtype=torch.int32)))}


def case_refusal(rank, device, **kw):
    out = {}
    for name, args in (("too_few", (16, 1)), ("n_dir_0", (None, 0))):
        try:
            make_mesh(*args, device)
            out[name] = "no error"
        except ValueError as e:
            out[name] = str(e)
    # the card is the default: without one, a mesh that names no device
    # raises and is never a CPU mesh
    try:
        out["no_device"] = f"a mesh on {make_mesh(4, 2).device}"
    except RuntimeError as e:
        out["no_device"] = str(e)
    try:
        make_multichip_step(kw["cfg"], make_mesh(4, 2, device), PLAIN)(
            init_world(kw["cfg"], device), *_inputs(kw["cfg"], kw["frames"], device))
        out["odd_batch"] = "no error"
    except ValueError as e:
        out["odd_batch"] = str(e)
    return out


def fail_on_rank_one(rank, device):
    if rank == 1:
        return 1 // 0
    dist.barrier()      # waits for rank 1, which never comes
    return rank


CASES = {"world": case_world, "multichip": case_multichip, "extract": case_extract,
         "tp": case_tp, "winner": case_winner, "refusal": case_refusal}


def run_cases(rank, device, cases):
    """cases: (name, kind, kwargs) triples -> {name: result dict}; a case that
    raises gives {"error": traceback} and the next one still runs."""
    out = {}
    for name, kind, kw in cases:
        try:
            out[name] = CASES[kind](rank, device, **kw)
        except Exception:
            out[name] = {"error": traceback.format_exc()}
    return out
