"""PyTorch/CUDA port of the point-cloud segmentation pipeline.

The package beside ``pointcloud_segmentation_tpu`` (the JAX reference, which
it is tested against).  It imports torch and never jax, and nothing of the
JAX package: it keeps its own copies of the framework-free code it needs
(config, sphere, io.scene, io.simulator, io.rosbag, io.mcap, io.ros_bridge,
viz, runtime.csvio, runtime.posebuffer).
The Hough voting runs in two kernels written in CUDA C++ for Hopper
(``csrc/voting.cu``), built with nvcc at first use.
"""

from ._malloc import cap_malloc_arenas as _cap_malloc_arenas

# applied before torch's thread pools can create extra arenas (_malloc.py)
_cap_malloc_arenas()

from .config import NUM_DIRECTIONS, PipelineConfig, StaticShapes, default_config
from .pipeline import FrameOutput, init_world, process_frame
from .runtime.engine import SegmentationEngine
from . import viz

__version__ = "0.1.0"

__all__ = [
    "PipelineConfig", "StaticShapes", "default_config", "NUM_DIRECTIONS",
    "SegmentationEngine", "process_frame", "init_world", "FrameOutput",
    "viz", "__version__",
]
