"""World state on its way between the device and numpy, and checkpoints.

Both packages name the world-state fields alike (WorldState), so a state is
a dict of numpy arrays keyed by those names on its way across.  A checkpoint
is one npz, tagged with the ``backend`` that wrote it, holding
``frames_processed``, ``records`` (rows of wall_time, processing_time,
seg_vec_size, nblines), ``records_pending`` and ``world_overflow_frames``
beside the world map:

  * backend ``"torch"`` (the port) or ``"jax"`` (the JAX engine): the world
    state as ``world_<field>`` arrays, in the float type it ran in.  The
    port's also name that type (``compute_dtype``).  The port reads both into
    an engine of the same compute type;
  * backend ``"oracle"`` (either package's numpy-oracle engine): the world
    segments as ``seg_<field>`` arrays, their accumulated inlier points, and
    the intersection matrix.  Only an oracle-backend engine reads it.

The direction tables are not state: both packages build them from
`sphere.hough_space`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .worldmap import WorldState

__all__ = ["world_state_from_numpy", "world_state_to_numpy", "read_checkpoint",
           "write_checkpoint", "write_oracle_checkpoint", "read_oracle_checkpoint",
           "BACKEND", "ORACLE_BACKEND"]

BACKEND = "torch"           # the tag of the port's checkpoints
ORACLE_BACKEND = "oracle"   # the tag of an oracle-backend engine's, in both packages
_READABLE = (BACKEND, "jax")

_DTYPES = {"points_size": torch.int32, "count": torch.int32, "valid": torch.bool}
_SEG_FIELDS = ("a", "b", "t_min", "t_max", "radius", "points_size", "pca_coeff",
               "pca_eigenvalues")


def world_state_from_numpy(arrays: dict, device, dtype=torch.float32) -> WorldState:
    """WorldState on `device` from numpy arrays keyed by field name, its
    float fields in `dtype`."""
    return WorldState(**{
        k: torch.as_tensor(np.asarray(arrays[k])).to(
            device=device, dtype=_DTYPES.get(k, dtype))
        for k in WorldState._fields})


def world_state_to_numpy(state: WorldState) -> dict:
    """The state's fields as numpy arrays, each in the type it has."""
    return {k: getattr(state, k).cpu().numpy() for k in WorldState._fields}


def _common_payload(backend: str, frames_processed: int, records: list,
                    world_overflow_frames: int) -> dict:
    # A deferred stream dispatches ahead of its read-backs: records that
    # still carry the -1 sentinel are counted, not written (the world map
    # ahead of them is saved all the same; it is the device's truth)
    done = [r for r in records if r["seg_vec_size"] >= 0]
    return {
        "backend": np.array(backend),
        "world_overflow_frames": np.array(world_overflow_frames),
        "frames_processed": np.array(frames_processed),
        "records_pending": np.array(len(records) - len(done)),
        "records": np.array(
            [[r["wall_time"], r["processing_time"], r["seg_vec_size"],
              r["nblines"]] for r in done], dtype=np.float64).reshape(-1, 4),
    }


def _save(path: str, payload: dict) -> None:
    """Written beside `path` and renamed over it, so a reader sees the old
    file or the new."""
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)


def _common_fields(data) -> dict:
    return {
        "frames_processed": int(data["frames_processed"]),
        "records": data["records"],
        "world_overflow_frames": (int(data["world_overflow_frames"])
                                  if "world_overflow_frames" in data else 0),
    }


def write_checkpoint(path: str, state: dict, frames_processed: int,
                     records: list, world_overflow_frames: int) -> None:
    """Write a checkpoint of the port: `state` as world_state_to_numpy gives
    it, `records` the engine's per-frame dicts."""
    payload = _common_payload(BACKEND, frames_processed, records,
                              world_overflow_frames)
    payload["compute_dtype"] = np.array(str(state["a"].dtype))
    payload.update({f"world_{k}": v for k, v in state.items()})
    _save(path, payload)


def read_checkpoint(path: str, compute_dtype: str) -> dict:
    """A checkpoint of the port or of the JAX engine as a dict: the world
    state's arrays by field name, plus ``frames_processed``, ``records`` and
    ``world_overflow_frames``.  ValueError for an oracle checkpoint (it holds
    segments, not a world state), for any other backend, and for a state in
    another float type than `compute_dtype` ("float32" or "float64")."""
    with np.load(path, allow_pickle=False) as data:
        backend = str(data["backend"])
        if backend == ORACLE_BACKEND:
            raise ValueError(
                f"{path} is a checkpoint of the numpy oracle (its world map is "
                "a list of segments): load it into an engine made with "
                "backend='oracle'")
        if backend not in _READABLE:
            raise ValueError(f"checkpoint of backend {backend!r}, not one of "
                             f"{_READABLE}")
        out = {k: data[f"world_{k}"] for k in WorldState._fields}
        wrote = (str(data["compute_dtype"]) if "compute_dtype" in data
                 else str(out["a"].dtype))
        if wrote != compute_dtype:
            raise ValueError(f"checkpoint holds a {wrote} world map, the engine "
                             f"runs compute_dtype={compute_dtype!r}")
        out.update(_common_fields(data))
    return out


def write_oracle_checkpoint(path: str, world, frames_processed: int,
                            records: list, world_overflow_frames: int) -> None:
    """Write an oracle-backend checkpoint of `world` (an oracle.WorldMap), in
    the layout of the JAX engine's oracle backend."""
    segs = world.segments
    payload = _common_payload(ORACLE_BACKEND, frames_processed, records,
                              world_overflow_frames)
    payload["world_count"] = np.array(len(segs))
    for name in _SEG_FIELDS:
        payload[f"seg_{name}"] = np.array([getattr(s, name) for s in segs])
    payload["seg_points"] = (np.concatenate([s.points for s in segs])
                             if segs else np.zeros((0, 3)))
    payload["seg_points_offsets"] = np.cumsum([0] + [len(s.points) for s in segs])
    payload["inter"] = world.inter
    _save(path, payload)


def read_oracle_checkpoint(path: str) -> dict:
    """An oracle-backend checkpoint as a dict: ``segments`` (oracle.Segment
    list), ``inter``, ``frames_processed``, ``records`` and
    ``world_overflow_frames``.  ValueError for any other backend."""
    from .oracle import Segment

    with np.load(path, allow_pickle=False) as data:
        backend = str(data["backend"])
        if backend != ORACLE_BACKEND:
            raise ValueError(f"checkpoint of backend {backend!r}: an engine made "
                             "with backend='oracle' reads oracle checkpoints only")
        offs = data["seg_points_offsets"]
        segs = [Segment(
            a=data["seg_a"][i], b=data["seg_b"][i],
            t_min=float(data["seg_t_min"][i]), t_max=float(data["seg_t_max"][i]),
            radius=float(data["seg_radius"][i]),
            points=data["seg_points"][offs[i]:offs[i + 1]],
            points_size=int(data["seg_points_size"][i]),
            pca_coeff=float(data["seg_pca_coeff"][i]),
            pca_eigenvalues=data["seg_pca_eigenvalues"][i])
            for i in range(int(data["world_count"]))]
        out = {"segments": segs, "inter": data["inter"]}
        out.update(_common_fields(data))
    return out
