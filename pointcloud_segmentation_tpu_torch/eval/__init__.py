"""Ground-truth structure accuracy and latency analysis of a run's CSVs
(the reference's testings/ scripts, offline); the same code as the JAX
package's ``eval``."""

from .structure import (get_similar_segments, match_report, direction_angle,
                        midpoint, radial_error)
from .timing import load_processing_time_csv, summarize

__all__ = [
    "get_similar_segments", "match_report", "direction_angle", "midpoint",
    "radial_error",
    "load_processing_time_csv", "summarize",
]
