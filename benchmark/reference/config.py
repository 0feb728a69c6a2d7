"""The configuration the reference reads: the reference node's
``config.yaml`` keys and the derived parameters, as the port's
``config.py`` defines them (node.cpp:241-243):

    leaf_size  = min(radius_sizes[0], radius_sizes[-1]) / rad_2_leaf_ratio
    diag_voxel = sqrt(3) * leaf_size
    opt_dx     = sqrt(3) * leaf_size

Only what `reference.pipeline` reads is here.  It is made from a
configuration file's ``yaml`` entry and owes nothing to the program.
"""

from __future__ import annotations

import dataclasses
import math

NUM_DIRECTIONS = (12, 21, 81, 321, 1281, 5121, 20481)
WINDOW_FILTERING_SIZE = 3.0    # node.cpp:25


@dataclasses.dataclass(frozen=True)
class RefShapes:
    max_iters: int = 24


@dataclasses.dataclass(frozen=True)
class RefConfig:
    floor_trim_height: float = 0.3
    min_pca_coeff: float = 0.995
    min_weight: float = 0.01
    rad_2_leaf_ratio: float = 1.5
    opt_minvotes: int = 12
    granularity: int = 6
    opt_nlines: int = 10
    radius_sizes: tuple = (0.05,)
    window_size: float = WINDOW_FILTERING_SIZE
    surface_offset_correction: bool = False
    shapes: RefShapes = dataclasses.field(default_factory=RefShapes)

    @classmethod
    def from_yaml_dict(cls, raw: dict) -> "RefConfig":
        keys = ("floor_trim_height", "min_pca_coeff", "min_weight",
                "rad_2_leaf_ratio", "opt_minvotes", "granularity", "opt_nlines")
        kw = {k: raw[k] for k in keys if k in raw}
        if "radius_sizes" in raw:
            kw["radius_sizes"] = tuple(float(r) for r in raw["radius_sizes"])
        return cls(**kw)

    @property
    def leaf_size(self) -> float:
        return min(self.radius_sizes[0], self.radius_sizes[-1]) / self.rad_2_leaf_ratio

    @property
    def diag_voxel(self) -> float:
        return math.sqrt(3.0) * self.leaf_size

    @property
    def opt_dx(self) -> float:
        return math.sqrt(3.0) * self.leaf_size
