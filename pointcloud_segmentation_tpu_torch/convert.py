"""World state on its way between the device and numpy, and checkpoints.

Both packages name the world-state fields alike (WorldState), so a state is
a dict of numpy arrays keyed by those names on its way across.  A checkpoint
is one npz: the world state as ``world_<field>`` arrays beside
``frames_processed``, ``records`` (rows of wall_time, processing_time,
seg_vec_size, nblines), ``records_pending`` and ``world_overflow_frames``,
tagged with the ``backend`` that wrote it.  The port writes ``"torch"`` and
reads its own checkpoints and the JAX engine's (``"jax"``), which have the
same layout.  The direction tables are not state: both packages build them
from `sphere.hough_space`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .worldmap import WorldState

__all__ = ["world_state_from_numpy", "world_state_to_numpy", "read_checkpoint",
           "write_checkpoint", "BACKEND"]

BACKEND = "torch"           # the tag of the port's checkpoints
_READABLE = (BACKEND, "jax")

_DTYPES = {"points_size": torch.int32, "count": torch.int32, "valid": torch.bool}


def world_state_from_numpy(arrays: dict, device) -> WorldState:
    """WorldState on `device` from numpy arrays keyed by field name."""
    return WorldState(**{
        k: torch.as_tensor(np.asarray(arrays[k])).to(
            device=device, dtype=_DTYPES.get(k, torch.float32))
        for k in WorldState._fields})


def world_state_to_numpy(state: WorldState) -> dict:
    return {k: getattr(state, k).cpu().numpy() for k in WorldState._fields}


def write_checkpoint(path: str, state: dict, frames_processed: int,
                     records: list, world_overflow_frames: int) -> None:
    """Write a checkpoint of the port: `state` as world_state_to_numpy gives
    it, `records` the engine's per-frame dicts.  The file is written beside
    `path` and renamed over it, so a reader sees the old file or the new."""
    payload = {
        "backend": np.array(BACKEND),
        "world_overflow_frames": np.array(world_overflow_frames),
        "frames_processed": np.array(frames_processed),
        # the port reads every record's values before it keeps the record
        "records_pending": np.array(0),
        "records": np.array(
            [[r["wall_time"], r["processing_time"], r["seg_vec_size"],
              r["nblines"]] for r in records], dtype=np.float64).reshape(-1, 4),
    }
    payload.update({f"world_{k}": v for k, v in state.items()})
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)


def read_checkpoint(path: str) -> dict:
    """A checkpoint of the port or of the JAX engine as a dict: the world
    state's arrays by field name, plus ``frames_processed``, ``records`` and
    ``world_overflow_frames``.  Any other backend (the numpy oracle's
    checkpoints hold segments, not a world state) raises ValueError."""
    with np.load(path, allow_pickle=False) as data:
        backend = str(data["backend"])
        if backend not in _READABLE:
            raise ValueError(f"checkpoint of backend {backend!r}, not one of "
                             f"{_READABLE}")
        out = {k: data[f"world_{k}"] for k in WorldState._fields}
        out["frames_processed"] = int(data["frames_processed"])
        out["records"] = data["records"]
        out["world_overflow_frames"] = (int(data["world_overflow_frames"])
                                        if "world_overflow_frames" in data else 0)
    return out
