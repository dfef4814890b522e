"""The harness's job queue: the worker's QueueHub, holding only the leaf
jobs of the cell's family, in plan order.

The worker pops jobs with ``receive``, acks them with ``ack`` and, as a
completion releases the jobs that wait on it, hands them to ``dispatch``.
Those (aggregations, block parts, the other family's jobs) are set aside
and never proven: the cell measures the leaf level. A job popped and never
acked, or acked without its proof in the store, is a failure of the run.
"""

from __future__ import annotations

from collections import deque


class LeafQueue:
    def __init__(self, leaf_jobs: list[bytes], job_topic: str):
        self.topic = job_topic
        self._ready = deque(enumerate(leaf_jobs))
        self.leaf_set = set(leaf_jobs)
        self.received: dict[int, bytes] = {}     # mid -> job, in pop order
        self.acked: list[int] = []
        self.set_aside: list[bytes] = []
        self._next_mid = len(leaf_jobs)

    def __len__(self) -> int:
        return len(self._ready)

    def dispatch(self, topic: str, msg: bytes) -> int:
        mid = self._next_mid
        self._next_mid += 1
        if topic == self.topic and msg in self.leaf_set:
            # a leaf handed back (a worker that does not take it): in front
            self._ready.appendleft((mid, msg))
        else:
            self.set_aside.append(msg)
        return mid

    def receive(self, topic: str):
        if topic != self.topic or not self._ready:
            return None
        mid, msg = self._ready.popleft()
        self.received[mid] = msg
        return mid, msg

    def ack(self, topic: str, mid: int) -> bool:
        if topic != self.topic or mid not in self.received:
            return False
        self.acked.append(mid)
        return True
