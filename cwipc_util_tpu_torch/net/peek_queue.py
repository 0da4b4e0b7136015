"""A queue with non-destructive wait: dont_get() blocks until an item is
present without removing it (used by available(wait=True) implementations;
reference: python/cwipc/net/peek_queue.py:7-38).

Copied from cwipc_util_tpu/net/peek_queue.py.
"""

from __future__ import annotations

import queue
import time
from queue import Empty, Full  # re-exported like the reference  # noqa: F401
from typing import Generic, Optional, TypeVar

T = TypeVar("T")


class PeekQueue(queue.Queue, Generic[T]):
    def dont_get(self, timeout: Optional[float] = None) -> Optional[T]:
        """Wait until an item is available and return it WITHOUT removing it.

        Returns None on timeout.  Waits on the queue's own ``not_empty``
        condition (which shares ``self.mutex``), so the emptiness check and
        the wait are one critical section — a separate condition would lose
        wakeups from put() calls landing between check and wait and stall
        for the whole timeout.

        CRITICAL: because a peek does not consume the item, it must pass
        the wakeup on — put() notifies ONE waiter, and if that waiter is
        this peek, a concurrently blocked get() would otherwise sleep
        forever next to a non-empty queue (observed as a decoder thread
        never draining its raw queue).
        """
        deadline = None if timeout is None else time.time() + timeout
        with self.not_empty:
            while not self._qsize():
                if deadline is None:
                    self.not_empty.wait()
                else:
                    remaining = deadline - time.time()
                    if remaining <= 0:
                        return None
                    self.not_empty.wait(remaining)
            item = self.queue[0]
            self.not_empty.notify()
            return item
