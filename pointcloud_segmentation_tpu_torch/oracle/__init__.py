from .pipeline import (
    Segment,
    WorldMap,
    FrameResult,
    cloud_filtering,
    passthrough_filter,
    voxel_grid,
    hough3dlines,
    orthogonal_lsq,
    seg_pca_eigenvalues,
    drone_to_world,
    surface_offset_correction,
    height_cutoff,
    check_similarity,
    check_connections,
    process_frame,
)

__all__ = [
    "Segment", "WorldMap", "FrameResult", "cloud_filtering",
    "passthrough_filter", "voxel_grid", "hough3dlines", "orthogonal_lsq",
    "seg_pca_eigenvalues", "drone_to_world", "surface_offset_correction",
    "height_cutoff",
    "check_similarity", "check_connections", "process_frame",
]
