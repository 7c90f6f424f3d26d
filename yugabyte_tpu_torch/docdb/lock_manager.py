"""SharedLockManager / LockBatch: in-memory row+prefix intent locks.

Counterpart of yugabyte_tpu/docdb/lock_manager.py, with the imports renamed.

Capability parity with the reference (ref: src/yb/docdb/shared_lock_manager.h,
src/yb/docdb/lock_batch.h, intent types in src/yb/docdb/intent.h). Four
intent lock modes: weak/strong x read/write. A write to a document path takes
a STRONG lock on the full path and WEAK locks on every prefix, so that
operations on disjoint subpaths of one document don't serialize, while a
whole-document operation conflicts with any write below it.

Conflict rule (ref shared_lock_manager.cc conflict matrix): two intent types
conflict iff at least one of them is STRONG and at least one of them is WRITE.
(read/read never conflicts; weak/weak never conflicts.)
"""

from __future__ import annotations

import enum
import threading
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple


class IntentType(enum.IntEnum):
    kWeakRead = 0
    kWeakWrite = 1
    kStrongRead = 2
    kStrongWrite = 3

    @property
    def is_strong(self) -> bool:
        return self >= IntentType.kStrongRead

    @property
    def is_write(self) -> bool:
        return self in (IntentType.kWeakWrite, IntentType.kStrongWrite)


def intents_conflict(a: IntentType, b: IntentType) -> bool:
    return (a.is_strong or b.is_strong) and (a.is_write or b.is_write)


# For each held-type bitmask, which intent types may NOT newly enter.
_CONFLICTS: Dict[IntentType, Tuple[IntentType, ...]] = {
    t: tuple(u for u in IntentType if intents_conflict(t, u)) for t in IntentType
}


class LockBatch:
    """A set of (key, intent_type) entries acquired and released atomically
    (ref lock_batch.h:61). Duplicate (key, intent_type) pairs collapse to one
    entry; distinct intent types on one key are all kept."""

    def __init__(self, entries: Iterable[Tuple[bytes, IntentType]] = ()):
        self.entries: List[Tuple[bytes, IntentType]] = sorted(set(entries))
        self._manager = None

    def __len__(self) -> int:
        return len(self.entries)

    def release(self) -> None:
        if self._manager is not None:
            self._manager._release(self)
            self._manager = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class SharedLockManager:
    """Grants LockBatches; blocks while any entry conflicts with held locks."""

    def __init__(self):
        self._cv = threading.Condition()
        # key -> [ref counts per IntentType]
        self._held: Dict[bytes, List[int]] = defaultdict(lambda: [0, 0, 0, 0])

    def lock(self, batch: LockBatch, timeout_s: float = 10.0) -> LockBatch:
        with self._cv:
            ok = self._cv.wait_for(lambda: self._grantable(batch), timeout=timeout_s)
            if not ok:
                raise TimeoutError("lock batch acquisition timed out "
                                   f"({len(batch)} entries)")
            for key, it in batch.entries:
                self._held[key][it] += 1
        batch._manager = self
        return batch

    def try_lock(self, batch: LockBatch) -> bool:
        with self._cv:
            if not self._grantable(batch):
                return False
            for key, it in batch.entries:
                self._held[key][it] += 1
        batch._manager = self
        return True

    def _grantable(self, batch: LockBatch) -> bool:
        for key, it in batch.entries:
            counts = self._held.get(key)
            if not counts:
                continue
            for other in _CONFLICTS[it]:
                if counts[other]:
                    return False
        return True

    def _release(self, batch: LockBatch) -> None:
        with self._cv:
            for key, it in batch.entries:
                counts = self._held[key]
                counts[it] -= 1
                if not any(counts):
                    del self._held[key]
            self._cv.notify_all()

    def held_count(self) -> int:
        with self._cv:
            return len(self._held)


def doc_path_lock_entries(full_key: bytes, prefixes: Sequence[bytes],
                          is_write: bool) -> List[Tuple[bytes, IntentType]]:
    """Strong lock on the full doc path, weak locks on every prefix
    (ref: docdb/docdb.cc DetermineKeysToLock)."""
    strong = IntentType.kStrongWrite if is_write else IntentType.kStrongRead
    weak = IntentType.kWeakWrite if is_write else IntentType.kWeakRead
    entries = [(p, weak) for p in prefixes if p != full_key]
    entries.append((full_key, strong))
    return entries
