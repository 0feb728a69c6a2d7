"""Configuration of the PyTorch port: the reference node's config keys plus
the fixed capacities the pipeline is sized by.

Key-for-key compatible with the reference node's ``config_pc_seg/config.yaml``
and with the JAX package's ``PipelineConfig`` (same fields, same derived
parameters, same YAML schema), so one YAML file configures both packages.
Derived parameters follow the reference node (node.cpp:241-243):

    leaf_size  = min(radius_sizes[0], radius_sizes[-1]) / rad_2_leaf_ratio
    diag_voxel = sqrt(3) * leaf_size
    opt_dx     = sqrt(3) * leaf_size
"""

from __future__ import annotations

import dataclasses
import math

# Direction counts per granularity level of the tessellated-icosahedron
# direction discretization (reference: hough_3d_lines.h:192).
NUM_DIRECTIONS = (12, 21, 81, 321, 1281, 5121, 20481)

# Side length of the pre-processing crop window in metres
# (reference: node.cpp:25 `WINDOW_FILTERING_SIZE`).
WINDOW_FILTERING_SIZE = 3.0

# verbose_level values of the reference node (node.cpp:309-346)
VERBOSE_NONE, VERBOSE_INFO, VERBOSE_WARN = 0, 1, 2

_YAML_KEYS = ("verbose_level", "path_to_output", "floor_trim_height",
              "min_pca_coeff", "min_weight", "rad_2_leaf_ratio",
              "opt_minvotes", "granularity", "opt_nlines")

# keys beyond the reference's schema that size `StaticShapes`: a sensor
# larger than the shipped 64x64 needs a raw buffer of its pixel count
_SHAPE_KEYS = ("max_raw_points", "max_points")


@dataclasses.dataclass(frozen=True)
class StaticShapes:
    """Fixed capacities of the device pipeline: point clouds, the world map
    and the Hough loop are padded to these, with validity masks."""

    max_raw_points: int = 8192     # capacity of the raw ToF cloud buffer
    max_points: int = 4096         # capacity after window crop + voxel grid
    max_world_segments: int = 64   # capacity of the persistent world map
    max_iters: int = 24            # bound on Hough extraction iterations
                                   # (used when opt_nlines == 0, which the
                                   # reference runs unbounded)

    def __post_init__(self):
        if self.max_raw_points <= 0 or self.max_points <= 0:
            raise ValueError("point capacities must be positive")
        if self.max_world_segments <= 0 or self.max_iters <= 0:
            raise ValueError("segment/iteration capacities must be positive")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Full pipeline configuration (reference-compatible keys + capacities)."""

    # --- reference config.yaml keys (identical names & semantics) ---
    verbose_level: int = 0
    path_to_output: str = "."
    floor_trim_height: float = 0.3
    min_pca_coeff: float = 0.995
    min_weight: float = 0.01
    rad_2_leaf_ratio: float = 1.5
    opt_minvotes: int = 12
    granularity: int = 6
    opt_nlines: int = 10
    radius_sizes: tuple = (0.05,)

    # --- additions beyond the reference ---
    shapes: StaticShapes = dataclasses.field(default_factory=StaticShapes)
    window_size: float = WINDOW_FILTERING_SIZE
    # "float64" is the parity mode: the pipeline runs in float64 and only the
    # float32-by-spec stages (vote bins, cell decode, scatter and covariance
    # eigensolves) stay float32, as in the numpy oracle.
    compute_dtype: str = "float32"
    # Voting accumulator (ops/hough.py): "carry" keeps the exact
    # (B, num_x, num_x) histogram; "lazy" keeps only (best, key, bound) per
    # direction and re-examines the directions whose bound could beat the
    # global max.  None = lazy when the carry would exceed 48 MiB.
    voting: str | None = None
    # Opt-in: shift each accepted axis by its matched radius along the
    # sensor->line perpendicular (README deviation E-OFFSET).
    surface_offset_correction: bool = False

    def __post_init__(self):
        object.__setattr__(self, "radius_sizes", tuple(float(r) for r in self.radius_sizes))
        if not self.radius_sizes:
            raise ValueError("radius_sizes must be non-empty")
        if not 0 <= self.granularity <= 6:
            raise ValueError("granularity must be in [0, 6]")
        if self.rad_2_leaf_ratio <= 0:
            raise ValueError("rad_2_leaf_ratio must be positive")
        if self.compute_dtype not in ("float32", "float64"):
            raise ValueError("compute_dtype must be 'float32' or 'float64'")
        if self.voting not in (None, "carry", "lazy"):
            raise ValueError("voting must be None, 'carry' or 'lazy'")

    # The reference takes min(first, last) of radius_sizes, not the global
    # min (node.cpp:241-243).
    @property
    def leaf_size(self) -> float:
        return min(self.radius_sizes[0], self.radius_sizes[-1]) / self.rad_2_leaf_ratio

    @property
    def diag_voxel(self) -> float:
        return math.sqrt(3.0) * self.leaf_size

    @property
    def opt_dx(self) -> float:
        return math.sqrt(3.0) * self.leaf_size

    @property
    def num_directions(self) -> int:
        return NUM_DIRECTIONS[self.granularity]

    @property
    def voting_mode(self) -> str:
        """Resolved voting strategy ("carry" or "lazy"); see `voting`."""
        if self.voting in ("carry", "lazy"):
            return self.voting
        carry_bytes = self.num_directions * self.num_x_max ** 2 * 4
        return "lazy" if carry_bytes > 48 * 2 ** 20 else "carry"

    @property
    def max_lines(self) -> int:
        """Bound on Hough iterations / per-frame output segments."""
        if self.opt_nlines > 0:
            return self.opt_nlines
        return self.shapes.max_iters

    @property
    def num_x_max(self) -> int:
        """Upper bound on the accumulator's x'/y' bin count.

        The bin count is num_x = floor(d / opt_dx + 0.5) for the cloud's bbox
        diagonal d (reference: hough_3d_lines.h:214); after the window crop
        d is bounded by the crop box's diagonal.
        """
        half = self.window_size / 2.0
        d_max = math.sqrt(half * half + self.window_size**2 * 2.0)
        return int(math.floor(d_max / self.opt_dx + 0.5)) + 1

    # --- YAML loading with the reference's schema ---
    @classmethod
    def from_yaml(cls, path: str, **overrides) -> "PipelineConfig":
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        return cls.from_dict(raw, **overrides)

    @classmethod
    def from_dict(cls, raw: dict, **overrides) -> "PipelineConfig":
        # every missing key falls back to its default, as the reference's
        # parameter loader does (node.cpp:181-239)
        kw = {key: raw[key] for key in _YAML_KEYS if key in raw}
        if "radius_sizes" in raw:
            kw["radius_sizes"] = tuple(float(r) for r in raw["radius_sizes"])
        if "compute_dtype" in raw:      # beyond the reference: the parity mode
            kw["compute_dtype"] = str(raw["compute_dtype"])
        caps = {key: int(raw[key]) for key in _SHAPE_KEYS if key in raw}
        if caps:                        # beyond the reference: the capacities
            kw["shapes"] = StaticShapes(**caps)
        kw.update(overrides)
        return cls(**kw)

    def to_dict(self) -> dict:
        """The reference's YAML keys and their values (the engine logs them
        at startup, as the node does, node.cpp:245-257)."""
        out = {key: getattr(self, key) for key in _YAML_KEYS}
        out["radius_sizes"] = list(self.radius_sizes)
        return out


def default_config(**overrides) -> PipelineConfig:
    """The shipped reference configuration (config_pc_seg/config.yaml)."""
    return PipelineConfig(**overrides)
