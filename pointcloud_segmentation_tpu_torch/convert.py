"""World state carried between the JAX package and the PyTorch port.

Both packages name the world-state fields alike (WorldState), so a state is
a dict of numpy arrays keyed by those names on its way across.  A checkpoint
written by the JAX engine (`SegmentationEngine.save_checkpoint`, backend
"jax") holds them as ``world_<field>`` arrays.  The direction tables are not
state: both packages build them from `sphere.hough_space`.
"""

from __future__ import annotations

import numpy as np
import torch

from .worldmap import WorldState

__all__ = ["world_state_from_numpy", "world_state_to_numpy", "load_jax_checkpoint"]

_DTYPES = {"points_size": torch.int32, "count": torch.int32, "valid": torch.bool}


def world_state_from_numpy(arrays: dict, device) -> WorldState:
    """WorldState on `device` from numpy arrays keyed by field name."""
    return WorldState(**{
        k: torch.as_tensor(np.asarray(arrays[k])).to(
            device=device, dtype=_DTYPES.get(k, torch.float32))
        for k in WorldState._fields})


def world_state_to_numpy(state: WorldState) -> dict:
    return {k: getattr(state, k).cpu().numpy() for k in WorldState._fields}


def load_jax_checkpoint(path: str) -> dict:
    """The checkpoint of a JAX engine as a dict: the world state's arrays by
    field name, plus ``frames_processed``, ``records`` (rows of wall_time,
    processing_time, seg_vec_size, nblines) and ``world_overflow_frames``."""
    with np.load(path, allow_pickle=False) as data:
        backend = str(data["backend"])
        if backend != "jax":
            raise ValueError(f"checkpoint of backend {backend!r}, not 'jax'")
        out = {k: data[f"world_{k}"] for k in WorldState._fields}
        out["frames_processed"] = int(data["frames_processed"])
        out["records"] = data["records"]
        out["world_overflow_frames"] = (int(data["world_overflow_frames"])
                                        if "world_overflow_frames" in data else 0)
    return out
