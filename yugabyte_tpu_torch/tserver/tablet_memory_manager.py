"""TabletMemoryManager: server-wide memstore arbitration + cache GC.

Counterpart of yugabyte_tpu/tserver/tablet_memory_manager.py, with the
imports renamed.

Capability parity with the reference (ref:
src/yb/tserver/tablet_memory_manager.h:39 — block-cache tracking with a
GarbageCollector, log-cache GC, and a background task that flushes the
tablet holding the OLDEST mutable memtable once the *global* memstore
limit is exceeded, tablet_memory_manager.cc:214-283 TabletToFlush /
FlushTabletIfLimitExceeded).

Design here: each tablet already flushes itself when its own memtable
crosses memstore_size_bytes (storage/db.py write_batch); this manager adds
the cross-tablet dimension — many tablets each slightly under their local
limit can still exhaust the server, so a background arbiter sums memstore
bytes across all hosted tablets and force-flushes oldest-first until under
the global limit. Trackers hang off the process root
(utils/mem_tracker.py) so /memz shows one coherent tree.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils.mem_tracker import MemTracker, root_tracker
from yugabyte_tpu_torch.utils.trace import TRACE

flags.define_flag("global_memstore_limit_bytes", 0,
                  "server-wide bound on summed memstore bytes; 0 = "
                  "global_memstore_fraction of the root tracker limit, "
                  "capped at 2 GiB (ref global_memstore_size_percentage / "
                  "global_memstore_size_mb_max)")
flags.define_flag("global_memstore_fraction", 0.10,
                  "fraction of the root memory limit given to the global "
                  "memstore when global_memstore_limit_bytes is 0")
flags.define_flag("memstore_arbitration_interval_s", 1.0,
                  "period of the background global-memstore check")


def _global_memstore_limit(root_limit: int) -> int:
    explicit = flags.get_flag("global_memstore_limit_bytes")
    if explicit:
        return explicit
    derived = int(root_limit * flags.get_flag("global_memstore_fraction"))
    # an unlimited root (limit<=0) must not derive a ZERO budget — 0 would
    # read as "flush everything always"; fall back to the 2 GiB cap
    return min(derived, 2 << 30) if derived > 0 else 2 << 30


class TabletMemoryManager:  # yblint: disable=ybsan-coverage (trackers/config are frozen before the arbiter thread starts — HB via Thread.start — and mutable accounting lives in MemTracker, which locks internally)
    """One per TabletServer. peers_fn returns the live TabletPeer list."""

    def __init__(self, peers_fn: Callable[[], List],
                 block_cache=None, log_cache_bytes_fn=None,
                 log_cache_evict=None, server_tracker: Optional[MemTracker] = None,
                 metric_entity=None, server_id: str = ""):
        self._peers_fn = peers_fn
        root = server_tracker or root_tracker()
        # id scoped by server: MiniCluster runs several tservers in one
        # process and each needs its own subtree under the process root
        self.server_tracker = root.find_or_create_child(
            f"tserver_{server_id}" if server_id else "tserver")
        self.memstore_tracker = MemTracker(
            _global_memstore_limit(root.limit), "memstore",
            parent=self.server_tracker,
            consumption_fn=self._total_memstore_bytes)
        self._root = root
        self.block_cache_tracker = None
        self._root_gc = None
        if block_cache is not None:
            self.block_cache_tracker = MemTracker(
                block_cache.capacity, "block_cache",
                parent=self.server_tracker,
                consumption_fn=lambda: block_cache.used)
            self.block_cache_tracker.add_gc_function(block_cache.evict)
            # process-level pressure sheds cache too (ref: InitBlockCache
            # registers the GC on the server tracker so root-limit checks
            # reach it); the arbiter loop drives root.limit_exceeded()
            self._root_gc = block_cache.evict
            root.add_gc_function(self._root_gc)
        self.log_cache_tracker = None
        if log_cache_bytes_fn is not None:
            self.log_cache_tracker = MemTracker(
                0, "log_cache", parent=self.server_tracker,
                consumption_fn=log_cache_bytes_fn)
            if log_cache_evict is not None:
                self.log_cache_tracker.add_gc_function(log_cache_evict)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._c_forced = None
        if metric_entity is not None:
            self._c_forced = metric_entity.counter(
                "global_memstore_forced_flushes_total",
                "tablet flushes forced by the global memstore limit")
        # observability hook mirroring TEST_listeners (ref header :65)
        self.flush_listeners: List[Callable[[str], None]] = []

    # ------------------------------------------------------------- lifecycle
    def init(self) -> None:
        self.bind_admission()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="memstore-arbiter")
        self._thread.start()

    def bind_admission(self) -> None:
        """Hand the server-wide memstore tracker to every hosted
        tablet's write-admission state machine (tablet/admission.py) so
        write entry points shed on memstore pressure. Idempotent;
        re-applied every arbiter round so tablets created after init()
        get bound within one arbitration interval."""
        for peer in self._peers_fn():
            tablet = getattr(peer, "tablet", peer)
            admission = getattr(tablet, "admission", None)
            if admission is not None:
                admission.bind_memstore(self.memstore_tracker)

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # sever this server's subtree so an in-process restart with the
        # same server_id starts clean and /memz drops the dead trackers
        if self._root_gc is not None:
            self._root.remove_gc_function(self._root_gc)
        self.server_tracker.unregister_from_parent()

    def _loop(self) -> None:
        period = flags.get_flag("memstore_arbitration_interval_s")
        while not self._stop.wait(period):
            try:
                self.bind_admission()
                self.flush_tablet_if_limit_exceeded()
                # process-level pressure check: RSS over the root limit
                # sheds cache memory via the registered GC hooks
                self._root.limit_exceeded()
            except Exception as e:
                TRACE("memstore arbiter error: %s", e)

    # ------------------------------------------------------------ arbitration
    def _total_memstore_bytes(self) -> int:
        total = 0
        for peer in self._peers_fn():
            tablet = getattr(peer, "tablet", peer)
            try:
                total += tablet.memstore_bytes()
            except Exception:
                pass
        return total

    def flush_tablet_if_limit_exceeded(self) -> int:
        """Flush oldest-first until the global memstore is under its limit
        (ref tablet_memory_manager.cc:253 TabletToFlush picks the oldest
        mutable memtable write across peers). One scan per round: sizes and
        ages are snapshotted once, then tablets are flushed in age order
        with a running total — each tablet is attempted at most once, so a
        flush that no-ops (already in progress) cannot stall the round."""
        limit = self.memstore_tracker.limit
        if limit <= 0:      # unlimited (MemTracker convention)
            return 0
        total = 0
        candidates = []
        for peer in self._peers_fn():
            tablet = getattr(peer, "tablet", peer)
            try:
                nbytes = tablet.memstore_bytes()
                oldest = tablet.oldest_memstore_write_s()
            except Exception:  # yblint: contained(peer torn down mid-scan — it has no memstore left to count; next arbiter round re-snapshots)
                continue
            total += nbytes
            if nbytes and oldest is not None:
                candidates.append((oldest, nbytes, tablet))
        if total <= limit:
            return 0
        candidates.sort(key=lambda c: c[0])
        flushed = 0
        for oldest, nbytes, tablet in candidates:
            if total <= limit:
                break
            tid = getattr(tablet, "tablet_id", "?")
            TRACE("global memstore %d > %d: flushing tablet %s",
                  total, limit, tid)
            for listener in self.flush_listeners:
                listener(tid)
            tablet.flush()
            total -= nbytes
            flushed += 1
            if self._c_forced is not None:
                self._c_forced.increment()
        return flushed
