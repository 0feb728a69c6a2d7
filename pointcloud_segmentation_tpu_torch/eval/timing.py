"""Latency analysis — proc_time_analysis.py parity (with the unit fix).

The reference's script divides microseconds by 10e6 (= 1e7), a 10x unit
error (testings/proc_time_analysis.py:25-26); here the conversion is the
correct 1e6 (documented deviation D-UNITS).
"""

from __future__ import annotations

import csv
from typing import Optional

import numpy as np


def load_processing_time_csv(path: str) -> dict:
    wall, proc, segs, nblines = [], [], [], []
    with open(path) as f:
        r = csv.DictReader(f)
        for row in r:
            wall.append(float(row["wall_time"]))
            proc.append(float(row["processing_time"]))
            segs.append(int(row["seg_vec_size"]))
            nblines.append(int(row["nblines"]))
    return {
        "wall_time_s": np.asarray(wall) / 1e6,       # D-UNITS: 1e6, not 10e6
        "processing_time_s": np.asarray(proc) / 1e6,
        "seg_vec_size": np.asarray(segs),
        "nblines": np.asarray(nblines),
    }


def summarize(data: dict) -> dict:
    p = data["processing_time_s"]
    out = {
        "n_frames": int(len(p)),
        "p50_ms": float(np.percentile(p, 50) * 1e3) if len(p) else float("nan"),
        "p95_ms": float(np.percentile(p, 95) * 1e3) if len(p) else float("nan"),
        "mean_ms": float(p.mean() * 1e3) if len(p) else float("nan"),
        "clouds_per_sec": float(1.0 / p.mean()) if len(p) and p.mean() > 0 else float("nan"),
        "by_nblines": {},
    }
    for k in sorted(set(data["nblines"].tolist())):
        sel = p[data["nblines"] == k]
        out["by_nblines"][int(k)] = {
            "n": int(len(sel)), "mean_ms": float(sel.mean() * 1e3)}
    return out


def plot_boxplots(data: dict, out_path: Optional[str] = None):
    """Box plots matching the reference's figures (overall + by nblines).
    Import-gated so matplotlib stays optional."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(12, 5))
    axes[0].boxplot(data["processing_time_s"])
    axes[0].set_ylabel("Processing Time [s]")
    groups = sorted(set(data["nblines"].tolist()))
    axes[1].boxplot([data["processing_time_s"][data["nblines"] == g] for g in groups],
                    tick_labels=[str(g) for g in groups])
    axes[1].set_xlabel("Number of Lines")
    axes[1].set_ylabel("Processing Time [s]")
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=120)
    return fig
