from .engine import SegmentationEngine

__all__ = ["SegmentationEngine"]
