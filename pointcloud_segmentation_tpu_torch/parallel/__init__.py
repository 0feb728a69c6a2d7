from .sharding import (
    Mesh,
    make_mesh,
    make_multichip_step,
    make_batched_extract,
    make_tp_process_frame,
    spawn,
)

__all__ = ["Mesh", "make_mesh", "make_multichip_step", "make_batched_extract",
           "make_tp_process_frame", "spawn"]
