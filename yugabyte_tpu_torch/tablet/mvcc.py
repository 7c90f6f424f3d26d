"""MvccManager: in-flight hybrid-time tracking and safe-time computation.

Counterpart of yugabyte_tpu/tablet/mvcc.py, with the imports renamed.

Capability parity with the reference (ref: src/yb/tablet/mvcc.h:83
`MvccManager`, :135 `SafeTime`; safe-time sources enum :52). The invariant:
every write is registered (`add_pending`) BEFORE it can become visible, and
hybrid times are registered in non-decreasing order. SafeTime is then the
largest timestamp `T` such that no future write can commit with time <= T:

    safe_time = min(in-flight) - 1           if any writes are in flight
              = max(last_replicated, clock)  otherwise (leader; clock "now"
                                             is safe because future writes
                                             get a later hybrid time)

Followers cannot use their own clock: their safe time advances only via the
leader's *propagated* safe time piggybacked on replication traffic
(`SetPropagatedSafeTimeOnFollower`, ref mvcc.h:93).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from yugabyte_tpu_torch.common.hybrid_time import HybridClock, HybridTime


class MvccManager:
    def __init__(self, clock: HybridClock):
        self._clock = clock
        self._cv = threading.Condition()
        self._queue: deque = deque()          # in-flight HTs, non-decreasing
        self._done: set = set()               # completed but not yet drained
        self._last_replicated = HybridTime.kMin
        self._max_safe_time_returned = HybridTime.kMin
        self._propagated_safe_time: Optional[HybridTime] = None  # follower mode
        self._is_leader = True

    # ------------------------------------------------------------- lifecycle
    def add_pending(self, ht: HybridTime) -> None:
        """Register a write about to be applied (ref mvcc.cc AddPending)."""
        with self._cv:
            if self._queue and ht.value < self._queue[-1].value:
                raise ValueError(
                    f"hybrid times must be registered in order: {ht} < {self._queue[-1]}")
            if ht.value <= self._max_safe_time_returned.value:
                raise ValueError(
                    f"write at {ht} would violate safe time {self._max_safe_time_returned}")
            self._queue.append(ht)

    def add_pending_now(self) -> HybridTime:
        """Atomically pick a hybrid time from the clock AND register it.

        The clock read must happen under the MVCC lock: a reader calling
        safe_time() between a writer's clock read and its registration would
        otherwise fence the writer's (already-drawn, lower) hybrid time out
        (the reference ties AddPending to the clock the same way)."""
        with self._cv:
            # Safe time can run ahead of the local clock when seeded from an
            # external source (bootstrap frontier, propagated leader safe
            # time): fold that bound into the clock so the drawn ht always
            # lands above every previously returned safe time.
            floor = self._max_safe_time_returned
            if self._last_replicated.value > floor.value:
                floor = self._last_replicated
            if self._queue and self._queue[-1].value > floor.value:
                floor = self._queue[-1]
            if floor.value > 0:
                self._clock.update(floor)
            ht = self._clock.now()
            if ht.value <= self._max_safe_time_returned.value or (
                    self._queue and ht.value < self._queue[-1].value):
                raise RuntimeError(
                    f"clock produced non-monotonic hybrid time {ht} "
                    f"(safe time {self._max_safe_time_returned})")
            self._queue.append(ht)
            return ht

    def replicated(self, ht: HybridTime) -> None:
        """The write at `ht` is durably replicated + applied.

        Completions may arrive out of order (concurrent appliers): they are
        buffered and the queue drains strictly in hybrid-time order, so safe
        time never jumps over a still-pending earlier write."""
        with self._cv:
            if ht not in self._queue:
                raise ValueError(f"Replicated({ht}) was never registered")
            self._done.add(ht.value)
            self._drain_done()

    def aborted(self, ht: HybridTime) -> None:
        """The write at `ht` was aborted before applying (leader change)."""
        with self._cv:
            self._queue.remove(ht)
            self._drain_done()

    def _drain_done(self) -> None:
        while self._queue and self._queue[0].value in self._done:
            head = self._queue.popleft()
            self._done.remove(head.value)
            if head.value > self._last_replicated.value:
                self._last_replicated = head
        self._cv.notify_all()

    # ------------------------------------------------------------- safe time
    def safe_time(self, min_allowed: Optional[HybridTime] = None,
                  timeout_s: float = 10.0) -> HybridTime:
        """Largest HT at which a read is repeatable. Blocks until it reaches
        `min_allowed` (ref mvcc.h:135 SafeTime(min_allowed, deadline))."""
        min_allowed = min_allowed or HybridTime.kMin
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._safe_time_unlocked().value >= min_allowed.value,
                timeout=timeout_s)
            if not ok:
                raise TimeoutError(
                    f"safe time did not reach {min_allowed} in {timeout_s}s")
            st = self._safe_time_unlocked()
            if st.value > self._max_safe_time_returned.value:
                self._max_safe_time_returned = st
            return st

    def _safe_time_unlocked(self) -> HybridTime:
        if self._queue:
            return self._queue[0].decremented()
        if not self._is_leader:
            # ONLY the leader-propagated value is safe: last_replicated is
            # the max applied HT, but Raft index order can diverge from
            # hybrid-time order across concurrent writers, so a pending
            # lower-HT entry may still arrive below it.
            return self._propagated_safe_time or HybridTime.kMin
        now = self._clock.now()
        return now if now.value > self._last_replicated.value else self._last_replicated

    def peek_safe_time(self) -> HybridTime:
        """Non-blocking safe-time read for propagation to followers. The
        value is recorded as returned (a follower may serve a read at it),
        so later writes are fenced above it — same invariant as safe_time()."""
        with self._cv:
            st = self._safe_time_unlocked()
            if st.value > self._max_safe_time_returned.value:
                self._max_safe_time_returned = st
            return st

    def safe_time_for_follower(self) -> HybridTime:
        with self._cv:
            return self._propagated_safe_time or HybridTime.kMin

    def set_propagated_safe_time(self, ht: HybridTime) -> None:
        """Follower: adopt the leader's safe time (ref mvcc.h:93)."""
        with self._cv:
            if self._propagated_safe_time is None or \
                    ht.value > self._propagated_safe_time.value:
                self._propagated_safe_time = ht
            self._cv.notify_all()

    def set_leader_mode(self, is_leader: bool) -> None:
        with self._cv:
            self._is_leader = is_leader
            self._cv.notify_all()

    @property
    def last_replicated(self) -> HybridTime:
        with self._cv:
            return self._last_replicated

    def set_last_replicated(self, ht: HybridTime) -> None:
        """Used at bootstrap to seed from the WAL replay frontier."""
        with self._cv:
            if ht.value > self._last_replicated.value:
                self._last_replicated = ht
            self._cv.notify_all()
