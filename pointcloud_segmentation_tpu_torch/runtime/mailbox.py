"""Latest-wins depth-1 mailbox: the reference node's producer/consumer slot.

Mirrors the node's SharedData + mutex + condition_variable design
(node.cpp:36-39, 117-122, 167-173, 268-276): the producer overwrites the
single slot, so frames are dropped, not queued, under load; the consumer
blocks until data is there.  The same class as the JAX package's
``runtime/mailbox.py``.
"""

from __future__ import annotations

import threading
from typing import Any, Optional


class LatestWinsMailbox:
    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._value: Any = None
        self._fresh = False
        self._closed = False
        self._dropped = 0

    def put(self, value: Any) -> None:
        """Overwrite the slot (latest wins); wakes one waiting consumer."""
        with self._cv:
            if self._fresh:
                self._dropped += 1
            self._value = value
            self._fresh = True
            self._cv.notify()

    def take(self, timeout: Optional[float] = None) -> Optional[Any]:
        """Block until fresh data (or close/timeout); clears the flag."""
        with self._cv:
            ok = self._cv.wait_for(lambda: self._fresh or self._closed, timeout)
            if not ok or (self._closed and not self._fresh):
                return None
            self._fresh = False
            return self._value

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed
