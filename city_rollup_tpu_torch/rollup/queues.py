"""Work queues: MPMC job dispatch with visibility-timeout (at-least-once)
semantics.

Reference role: city_rollup_worker_dispatch's Redis/RSMQ queues — topics
Q_JOB / Q_CMD / Q_NOTIFICATIONS + RPC ingress queues, 600 s visibility
timeout (SURVEY.md §2.1 row 10). The in-memory implementation keeps the same
at-least-once contract (a popped-but-unacked message reappears after the
hidden window) so the worker/orchestrator code paths are identical in tests
and production, exactly like the reference swaps Redis for VecDeque fakes.

Counterpart of the reference's ``rollup/queues.py``: a copy.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

# Queue topics (redis/mod.rs:26-33 twin)
Q_JOB = "q_job"
Q_CMD = "q_cmd"
Q_NOTIFICATIONS = "q_notifications"
Q_RPC_REGISTER_USER = "q_rpc_register_user"
Q_RPC_CLAIM_DEPOSIT = "q_rpc_claim_deposit"
Q_RPC_TOKEN_TRANSFER = "q_rpc_token_transfer"
Q_RPC_ADD_WITHDRAWAL = "q_rpc_add_withdrawal"

DEFAULT_VISIBILITY_TIMEOUT_S = 600.0


class MemoryQueue:
    """One topic: FIFO with visibility timeout + explicit ack."""

    def __init__(self, visibility_timeout_s: float =
                 DEFAULT_VISIBILITY_TIMEOUT_S):
        self._lock = threading.Lock()
        self._ready: deque[tuple[int, bytes]] = deque()
        self._inflight: dict[int, tuple[float, bytes]] = {}
        self._next_id = 0
        self.vt = visibility_timeout_s

    def send(self, msg: bytes) -> int:
        with self._lock:
            mid = self._next_id
            self._next_id += 1
            self._ready.append((mid, msg))
            return mid

    def _requeue_expired(self, now: float):
        expired = [mid for mid, (t, _) in self._inflight.items()
                   if now - t > self.vt]
        for mid in expired:
            _, msg = self._inflight.pop(mid)
            self._ready.appendleft((mid, msg))

    def receive(self) -> Optional[tuple[int, bytes]]:
        """Pop with visibility timeout: message hides until ack or timeout."""
        now = time.monotonic()
        with self._lock:
            self._requeue_expired(now)
            if not self._ready:
                return None
            mid, msg = self._ready.popleft()
            self._inflight[mid] = (now, msg)
            return mid, msg

    def ack(self, mid: int) -> bool:
        with self._lock:
            return self._inflight.pop(mid, None) is not None

    def pop(self) -> Optional[bytes]:
        """Destructive pop (no redelivery) — reference pop_one."""
        with self._lock:
            self._requeue_expired(time.monotonic())
            if not self._ready:
                return None
            return self._ready.popleft()[1]

    def __len__(self):
        with self._lock:
            return len(self._ready) + len(self._inflight)


class QueueHub:
    """Topic -> MemoryQueue registry (ProvingDispatcher/Listener twin)."""

    def __init__(self, visibility_timeout_s: float =
                 DEFAULT_VISIBILITY_TIMEOUT_S):
        self._queues: dict[str, MemoryQueue] = {}
        self._lock = threading.Lock()
        self.vt = visibility_timeout_s

    def queue(self, topic: str) -> MemoryQueue:
        with self._lock:
            if topic not in self._queues:
                self._queues[topic] = MemoryQueue(self.vt)
            return self._queues[topic]

    def dispatch(self, topic: str, msg: bytes) -> int:
        return self.queue(topic).send(msg)

    def receive(self, topic: str):
        return self.queue(topic).receive()

    def ack(self, topic: str, mid: int) -> bool:
        return self.queue(topic).ack(mid)
