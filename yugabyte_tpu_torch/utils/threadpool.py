"""Thread pools: plain pool + shared priority pool for flush/compaction.

Capability parity with yb::ThreadPool (ref: src/yb/util/threadpool.h:223) and
the server-wide PriorityThreadPool that runs all tablets' compactions/flushes
(ref: src/yb/util/priority_thread_pool.h:61; db_impl.cc:201-440). Tasks carry
a priority; higher runs first. The device dispatch queue for compactions layers
on top of this (one device, serialized launches, priority-ordered).

The port's copy of yugabyte_tpu/utils/threadpool.py: `DBOptions.
compaction_pool` runs the DB's scheduled compactions.
"""

from __future__ import annotations

import heapq
import itertools
import threading
from typing import Callable, Optional


class PriorityThreadPool:
    def __init__(self, max_threads: int = 1, name: str = "pool"):
        from yugabyte_tpu_torch.utils import lock_rank
        self.name = name
        self._heap = []  # (-priority, seq, fn)  # guarded-by: _cv
        self._seq = itertools.count()
        self._lock = lock_rank.tracked(threading.Lock(),
                                       f"threadpool.{name}._lock")
        self._cv = threading.Condition(self._lock)
        self._shutdown = False  # guarded-by: _cv
        self._active = 0        # guarded-by: _cv
        self._threads = [threading.Thread(target=self._worker, daemon=True,
                                          name=f"{name}-{i}")
                         for i in range(max_threads)]
        for t in self._threads:
            t.start()

    def submit(self, fn: Callable[[], None], priority: int = 0) -> None:
        with self._cv:
            if self._shutdown:
                raise RuntimeError("pool shut down")
            heapq.heappush(self._heap, (-priority, next(self._seq), fn))
            self._cv.notify()

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._heap and not self._shutdown:
                    self._cv.wait()
                if self._shutdown and not self._heap:
                    return
                _, _, fn = heapq.heappop(self._heap)
                self._active += 1
            try:
                fn()
            except Exception:  # background task failure must not kill the worker
                import logging
                logging.exception("background task failed in pool %s", self.name)
            finally:
                with self._cv:
                    self._active -= 1
                    self._cv.notify_all()

    def queue_depth(self) -> int:
        """Queued (not yet running) tasks — the backlog metric the
        reference exposes for its priority pool."""
        with self._lock:
            return len(self._heap)

    def active_count(self) -> int:
        with self._lock:
            return self._active

    def wait_idle(self) -> None:
        with self._cv:
            while self._heap or self._active:
                self._cv.wait()

    def shutdown(self, wait: bool = True) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        if wait:
            for t in self._threads:
                t.join()
