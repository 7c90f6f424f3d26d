"""Token-bucket rate limiter for background I/O.

Capability parity with the reference's compaction/flush rate limiter
(ref: src/yb/rocksdb/util/rate_limiter.cc GenericRateLimiter — a token
bucket refilled at bytes_per_second, acquired by compaction writers so
background I/O cannot starve foreground reads/writes of disk bandwidth).
"""

from __future__ import annotations

import threading
import time


class RateLimiter:
    def __init__(self, bytes_per_second: int, burst_seconds: float = 0.5):
        self.rate = max(1, int(bytes_per_second))
        self.capacity = max(1.0, self.rate * burst_seconds)
        self._tokens = self.capacity
        self._last = time.monotonic()
        self._lock = threading.Lock()
        self.total_through = 0

    def _refill_locked(self, now: float) -> None:
        self._tokens = min(self.capacity,
                           self._tokens + (now - self._last) * self.rate)
        self._last = now

    def acquire(self, nbytes: int) -> float:
        """Block until nbytes of budget is available; returns seconds
        slept. Requests larger than the bucket drain it and debt-sleep —
        a single oversized SST write still paces correctly."""
        slept = 0.0
        with self._lock:
            now = time.monotonic()
            self._refill_locked(now)
            self._tokens -= nbytes
            self.total_through += nbytes
            deficit = -self._tokens
        if deficit > 0:
            wait = deficit / self.rate
            time.sleep(wait)
            slept = wait
        return slept
