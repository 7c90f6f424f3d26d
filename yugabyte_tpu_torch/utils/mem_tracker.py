"""MemTracker: hierarchical memory accounting with limits and GC hooks.

Counterpart of yugabyte_tpu/utils/mem_tracker.py, with the imports
renamed.

Capability parity with the reference's MemTracker tree (ref:
src/yb/util/mem_tracker.h:139 — consumption propagates from a tracker up
through its ancestors to a process root; limits are checked root-down on
TryConsume; GarbageCollectors registered on a tracker are invoked to shed
cache memory before a consume is rejected; soft-limit checks give early
backpressure below the hard limit, ref mem_tracker.cc:557-589).

Differences from the reference: the process root's consumption functor
reads the OS RSS (the reference polls tcmalloc's
generic.current_allocated_bytes, mem_tracker.h:163 — no tcmalloc here),
and device-memory budgets (DeviceSlabCache) hang off their own subtree so
host-RAM arbitration never counts device bytes against the host limit.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional

from yugabyte_tpu_torch.utils import flags

flags.define_flag("memory_limit_bytes", 0,
                  "hard memory limit for the process root tracker; 0 = "
                  "derive from memory_limit_fraction of total RAM "
                  "(ref flag memory_limit_hard_bytes)")
flags.define_flag("memory_limit_fraction", 0.85,
                  "fraction of total system RAM used when "
                  "memory_limit_bytes is 0 (ref default_memory_limit_to_ram_ratio)")
flags.define_flag("memory_limit_soft_percentage", 85,
                  "percentage of the hard limit where soft-limit "
                  "backpressure begins (ref memory_limit_soft_percentage)")


def _total_system_ram() -> int:
    try:
        import os
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError, AttributeError):
        return 8 << 30


def _process_rss() -> int:
    """Resident set size of this process (the root consumption functor)."""
    try:
        with open("/proc/self/statm", "rb") as f:
            pages = int(f.read().split()[1])
        import os
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


class MemTracker:
    """One node in the tracker tree. Thread-safe.

    consumption is either the local tally maintained by consume()/release()
    plus all children (tally mode), or the value of ``consumption_fn``
    (functor mode, used for the process root and for caches that know
    their own usage, ref mem_tracker.h:107-112).
    """

    def __init__(self, limit: int, tracker_id: str,
                 parent: Optional["MemTracker"] = None,
                 consumption_fn: Optional[Callable[[], int]] = None,
                 add_to_parent: bool = True,
                 metric_entity=None):
        self.id = tracker_id
        self.limit = limit          # < 0 or 0 = unlimited
        self.parent = parent if add_to_parent else None
        self._consumption_fn = consumption_fn
        self._consumed = 0
        self._peak = 0
        self._lock = threading.Lock()
        self._create_lock = threading.Lock()  # serializes child creation
        self._children: Dict[str, "MemTracker"] = {}
        self._gc_fns: List[Callable[[int], None]] = []
        # ancestor chain (self first) — limits are enforced along it
        self._chain: List["MemTracker"] = [self]
        p = self.parent
        while p is not None:
            self._chain.append(p)
            p = p.parent
        if self.parent is not None:
            with self.parent._lock:
                self.parent._children[tracker_id] = self
        self._gauge = None
        if metric_entity is not None:
            self._gauge = metric_entity.gauge(
                f"mem_tracker_{tracker_id}_bytes",
                f"bytes tracked by {tracker_id}")

    # ------------------------------------------------------------ hierarchy
    def find_child(self, tracker_id: str) -> Optional["MemTracker"]:
        with self._lock:
            return self._children.get(tracker_id)

    def find_or_create_child(self, tracker_id: str, limit: int = 0,
                             consumption_fn=None) -> "MemTracker":
        # _create_lock (not _lock) spans check+create: MemTracker.__init__
        # itself takes self._lock to insert, so holding _lock here would
        # deadlock, but without serialization two racing callers would each
        # construct a child and one would be silently overwritten
        with self._create_lock:
            with self._lock:
                existing = self._children.get(tracker_id)
            if existing is not None:
                return existing
            return MemTracker(limit, tracker_id, parent=self,
                              consumption_fn=consumption_fn)

    def unregister_from_parent(self) -> None:
        """Drop the parent's reference (ref mem_tracker.h:192): the tracker
        keeps functioning standalone and a new same-id child may be created.
        Releases this subtree's tally from all ancestors and SEVERS the
        ancestor chain, so later consume/release on the orphan can no longer
        touch ex-ancestor accounting."""
        if self.parent is None:
            return
        with self._lock:
            tally = self._consumed
        if tally:
            for t in self._chain[1:]:
                t._add(-tally)
        with self.parent._lock:
            if self.parent._children.get(self.id) is self:
                del self.parent._children[self.id]
        self.parent = None
        self._chain = [self]
        self._reroot_descendants()

    def _reroot_descendants(self) -> None:
        """Truncate every descendant's ancestor chain at this tracker, so
        the whole detached subtree stops propagating into ex-ancestors."""
        with self._lock:
            children = list(self._children.values())
        for c in children:
            c._chain = [c] + self._chain
            c._reroot_descendants()

    # ---------------------------------------------------------- accounting
    def _add(self, n: int) -> None:
        with self._lock:
            self._consumed += n
            if self._consumed > self._peak:
                self._peak = self._consumed
        if self._gauge is not None:
            self._gauge.set(self._consumed)

    def consume(self, n: int) -> None:
        if n == 0:
            return
        for t in self._chain:
            t._add(n)

    def release(self, n: int) -> None:
        self.consume(-n)

    def _functor_extra(self) -> int:
        """Bytes visible only through functor-mode descendants. Tally-mode
        descendants already propagated into this tracker's _consumed via
        consume(); functor-mode ones (caches, memstores) never call it."""
        with self._lock:
            children = list(self._children.values())
        total = 0
        for c in children:
            if c._consumption_fn is not None:
                total += c.consumption()
            else:
                total += c._functor_extra()
        return total

    def consumption(self) -> int:
        if self._consumption_fn is not None:
            return int(self._consumption_fn())
        with self._lock:
            tally = self._consumed
        return tally + self._functor_extra()

    def peak_consumption(self) -> int:
        with self._lock:
            return self._peak

    def spare_capacity(self) -> int:
        """Bytes left before the tightest limit along the ancestor chain."""
        spare = None
        for t in self._chain:
            if t.limit > 0:
                s = t.limit - t.consumption()
                spare = s if spare is None else min(spare, s)
        return spare if spare is not None else (1 << 62)

    def try_consume(self, n: int) -> bool:
        """Atomically-enough consume n, honouring every ancestor limit.

        On a would-exceed, runs GC functions on the offending tracker and
        rechecks once (ref mem_tracker.cc LimitExceeded -> GcMemory)."""
        if n <= 0:
            self.consume(n)
            return True
        for t in self._chain:
            if t.limit > 0 and t.consumption() + n > t.limit:
                t._gc(t.consumption() + n - t.limit)
                if t.consumption() + n > t.limit:
                    return False
        self.consume(n)
        return True

    def limit_exceeded(self) -> bool:
        for t in self._chain:
            if t.limit > 0 and t.consumption() > t.limit:
                t._gc(t.consumption() - t.limit)
                if t.consumption() > t.limit:
                    return True
        return False

    def soft_limit_exceeded(self) -> "SoftLimitResult":
        """Early backpressure below the hard limit (ref mem_tracker.cc:557).

        Deterministic design (the reference rejects *probabilistically*
        between soft and hard): exceeded once consumption crosses
        soft_pct% of the limit; callers shed load or flush."""
        soft_pct = flags.get_flag("memory_limit_soft_percentage") / 100.0
        worst = SoftLimitResult(False, 0.0)
        for t in self._chain:
            if t.limit > 0:
                pct = t.consumption() / t.limit
                if pct > worst.current_capacity_pct:
                    worst = SoftLimitResult(pct >= soft_pct, pct)
        return worst

    # ------------------------------------------------------------------ GC
    def add_gc_function(self, fn: Callable[[int], None]) -> None:
        """fn(required_bytes) should free at least required_bytes if it can
        (ref GarbageCollector::CollectGarbage, mem_tracker.h:66)."""
        with self._lock:
            self._gc_fns.append(fn)

    def remove_gc_function(self, fn: Callable[[int], None]) -> None:
        with self._lock:
            if fn in self._gc_fns:
                self._gc_fns.remove(fn)

    def _gc(self, required: int) -> None:
        with self._lock:
            fns = list(self._gc_fns)
        for fn in fns:
            try:
                fn(required)
            except Exception:
                pass

    # ------------------------------------------------------------ reporting
    def log_usage(self, indent: int = 0) -> str:
        lines = [f"{' ' * indent}{self.id}: consumption={self.consumption()} "
                 f"peak={self.peak_consumption()} "
                 f"limit={self.limit if self.limit > 0 else 'none'}"]
        with self._lock:
            children = list(self._children.values())
        for c in children:
            lines.append(c.log_usage(indent + 2))
        return "\n".join(lines)

    def tree_json(self) -> dict:
        with self._lock:
            children = list(self._children.values())
        return {"id": self.id, "consumption": self.consumption(),
                "peak": self.peak_consumption(),
                "limit": self.limit if self.limit > 0 else None,
                "children": [c.tree_json() for c in children]}


class SoftLimitResult:
    __slots__ = ("exceeded", "current_capacity_pct")

    def __init__(self, exceeded: bool, pct: float):
        self.exceeded = exceeded
        self.current_capacity_pct = pct


class ScopedTrackedConsumption:
    """RAII consumption guard (ref mem_tracker.h ScopedTrackedConsumption):
    use as a context manager, or keep + reset(new_size) as it changes."""

    def __init__(self, tracker: MemTracker, n: int):
        self._tracker = tracker
        self._n = n
        tracker.consume(n)

    def reset(self, new_n: int) -> None:
        self._tracker.consume(new_n - self._n)
        self._n = new_n

    def release(self) -> None:
        if self._tracker is not None:
            self._tracker.release(self._n)
            self._tracker = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


_root_lock = threading.Lock()
_root: Optional[MemTracker] = None


def root_tracker() -> MemTracker:
    """The process root, lazily created; limit from flags, consumption from
    RSS (the reference's root polls tcmalloc, mem_tracker.cc:239-260)."""
    global _root
    with _root_lock:
        if _root is None:
            limit = flags.get_flag("memory_limit_bytes")
            if not limit:
                limit = int(_total_system_ram()
                            * flags.get_flag("memory_limit_fraction"))
            _root = MemTracker(limit, "root", consumption_fn=_process_rss)
        return _root


def reset_root_for_tests() -> None:
    global _root
    with _root_lock:
        _root = None
