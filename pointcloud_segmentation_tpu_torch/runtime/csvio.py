"""CSV outputs with the reference node's schemas and number formatting.

Schemas (node.cpp:850-919):
  intersections.csv:   seg1,t1,seg2,t2
  segments.csv:        segment,a_x,a_y,a_z,b_x,b_y,b_z,t_min,t_max
  processing_time.csv: wall_time,processing_time,seg_vec_size,nblines

Doubles are written as C++ ``ofstream << double`` prints them: 6 significant
digits (printf %g), e.g. ``0.123457`` / ``5.12346e+06``.  The bytes equal the
JAX package's writers, so the reference's analysis scripts read both.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence


def fmt_double(v: float) -> str:
    """C++ ostream default double formatting (%.6g)."""
    return f"{float(v):.6g}"


def write_segments_csv(path: str, segments: Iterable[dict]) -> None:
    """segments: iterable of dicts with a (3,), b (3,), t_min, t_max."""
    with open(path, "w") as f:
        f.write("segment,a_x,a_y,a_z,b_x,b_y,b_z,t_min,t_max\n")
        for i, s in enumerate(segments):
            a, b = s["a"], s["b"]
            vals = (a[0], a[1], a[2], b[0], b[1], b[2], s["t_min"], s["t_max"])
            f.write(",".join([str(i)] + [fmt_double(v) for v in vals]) + "\n")


def write_intersections_csv(path: str, rows: Iterable[Sequence]) -> None:
    """rows: (seg1, t1, seg2, t2) in upper-triangular scan order."""
    with open(path, "w") as f:
        f.write("seg1,t1,seg2,t2\n")
        for (i, t1, j, t2) in rows:
            f.write(f"{int(i)},{fmt_double(t1)},{int(j)},{fmt_double(t2)}\n")


def write_processing_time_csv(path: str, records: Iterable[dict]) -> None:
    """records: dicts with wall_time (us), processing_time (us),
    seg_vec_size, nblines."""
    with open(path, "w") as f:
        f.write("wall_time,processing_time,seg_vec_size,nblines\n")
        for r in records:
            f.write(f"{fmt_double(r['wall_time'])},{fmt_double(r['processing_time'])},"
                    f"{int(r['seg_vec_size'])},{int(r['nblines'])}\n")


def read_segments_csv(path: str) -> list[dict]:
    """Inverse of write_segments_csv."""
    out = []
    with open(path) as f:
        header = f.readline().strip().split(",")
        if header[0] != "segment":
            raise ValueError(f"{path}: not a segments.csv (header {header})")
        for line in f:
            vals = line.strip().split(",")
            if vals == [""]:
                continue
            fv = [float(v) for v in vals[1:]]
            out.append({"a": fv[0:3], "b": fv[3:6],
                        "t_min": fv[6], "t_max": fv[7],
                        "endpoints": [fv[6], fv[7]]})
    return out


def ensure_outdir(path: str) -> str:
    """The reference asserts the output directory exists (node.cpp:193);
    here it is created."""
    os.makedirs(path, exist_ok=True)
    return path
