"""Structure-accuracy evaluation — the tests_structure.py harness, offline.

Reimplements the reference's ground-truth comparison
(testings/tests_structure.py:55-87) without Webots: a processed segment
matches a ground-truth beam iff the direction angle (mod pi) is below
`angle_threshold` (0.1 rad) and the distance between segment midpoints is
below `distance_threshold` (0.5 m).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def direction_angle(b1, b2) -> Tuple[float, float]:
    """(folded_angle, raw_angle) with antiparallel handling
    (tests_structure.py:55-66).

    ``folded_angle`` is min(|angle|, |angle - pi|) — the line-direction
    angle mod pi that callers compare against ``angle_threshold``;
    ``raw_angle`` is the unfolded arccos of the unit dot product.
    """
    b1 = np.asarray(b1, float)
    b2 = np.asarray(b2, float)
    b1 = b1 / np.linalg.norm(b1)
    b2 = b2 / np.linalg.norm(b2)
    angle = float(np.arccos(np.clip(np.dot(b1, b2), -1.0, 1.0)))
    return min(abs(angle), abs(angle - np.pi)), angle


def midpoint(seg: dict) -> np.ndarray:
    a = np.asarray(seg["a"], float)
    b = np.asarray(seg["b"], float)
    e = seg["endpoints"] if "endpoints" in seg else [seg["t_min"], seg["t_max"]]
    return a + b * (e[0] + e[1]) / 2.0


def get_similar_segments(truth: Sequence[dict], processed: Sequence[dict],
                         angle_threshold: float = 0.1,
                         distance_threshold: float = 0.5) -> List[tuple]:
    """(i_truth, j_proc, distance, angle, angle*distance) matches
    (tests_structure.py:76-87)."""
    out = []
    for i, tseg in enumerate(truth):
        for j, pseg in enumerate(processed):
            ang, _ = direction_angle(tseg["b"], pseg["b"])
            if ang < angle_threshold:
                dist = float(np.linalg.norm(midpoint(tseg) - midpoint(pseg)))
                if dist < distance_threshold:
                    out.append((i, j, dist, ang, ang * dist))
    return out


def radial_error(tseg: dict, pseg: dict) -> float:
    """Midpoint error perpendicular to the TRUTH axis — the component the
    report's §6.3 surface-sampling bias (and E-OFFSET) lives in; the axial
    remainder reflects observed-extent mismatch, not axis accuracy."""
    bt = np.asarray(tseg["b"], float)
    bt = bt / np.linalg.norm(bt)
    d = midpoint(pseg) - midpoint(tseg)
    return float(np.linalg.norm(d - (d @ bt) * bt))


def match_report(truth: Sequence[dict], processed: Sequence[dict],
                 angle_threshold: float = 0.1,
                 distance_threshold: float = 0.5) -> dict:
    """Aggregate accuracy metrics for a run."""
    matches = get_similar_segments(truth, processed, angle_threshold,
                                   distance_threshold)
    matched_truth = sorted({m[0] for m in matches})
    matched_proc = sorted({m[1] for m in matches})
    radial = [radial_error(truth[m[0]], processed[m[1]]) for m in matches]
    return {
        "matches": matches,
        "n_truth": len(truth),
        "n_processed": len(processed),
        "n_truth_matched": len(matched_truth),
        "n_processed_matched": len(matched_proc),
        "recall": len(matched_truth) / len(truth) if truth else 0.0,
        "mean_angle_error": float(np.mean([m[3] for m in matches])) if matches else float("nan"),
        "mean_distance_error": float(np.mean([m[2] for m in matches])) if matches else float("nan"),
        "mean_radial_error": float(np.mean(radial)) if radial else float("nan"),
    }
