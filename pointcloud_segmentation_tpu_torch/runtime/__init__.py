from .engine import SegmentationEngine
from .mailbox import LatestWinsMailbox

__all__ = ["SegmentationEngine", "LatestWinsMailbox"]
