"""PyTorch/CUDA port of the point-cloud segmentation pipeline.

The package beside ``pointcloud_segmentation_tpu`` (the JAX reference, which
it is tested against).  It imports torch and never jax: the framework-free
modules (config, sphere, io, oracle, runtime.csvio, runtime.posebuffer) are
used from the JAX package as they are, and importing them pulls in no jax.
The Hough voting runs in two kernels written in CUDA C++ for Hopper
(``csrc/voting.cu``), built with nvcc at first use.
"""

from pointcloud_segmentation_tpu.config import (NUM_DIRECTIONS, PipelineConfig,
                                                StaticShapes, default_config)

from .pipeline import FrameOutput, init_world, process_frame
from .runtime.engine import SegmentationEngine

__all__ = [
    "PipelineConfig", "StaticShapes", "default_config", "NUM_DIRECTIONS",
    "SegmentationEngine", "process_frame", "init_world", "FrameOutput",
]
