"""Host-RAM packed-run cache: compaction inputs retained decoded.

Counterpart of yugabyte_tpu/storage/run_cache.py, over the port's own
native library (storage/native_engine.py, built from
native/compaction_engine.cc into the port's build directory). Every flush
and compaction output is exported ONCE from the native shell as decoded
SoA columns (ce_runcache_export) and retained keyed by SST file id; the
next compaction over all-cached inputs skips file read, block decode and
the CRC pass entirely (ce_job_prepare_cached), so on a warm compaction
chain the disk file is for durability only.

Memory lives in C++ (one registry per process); this class is the LRU
accountant over it, namespaced per DB exactly like DeviceSlabCache. Hits
and misses are plain per-instance ints (the JAX package's registry
counters come with the metrics registry: ROADMAP queue A, health-board
routing and device-fault containment).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

from yugabyte_tpu_torch.utils import flags

flags.define_flag("compaction_run_cache_mb", 512,
                  "host RAM budget for the packed-run cache (0 disables); "
                  "holds flush/compaction outputs decoded so steady-state "
                  "compactions skip input read+decode")

CacheKey = Tuple[str, int]  # (namespace, file_id), as DeviceSlabCache


class NativeRunCache:
    """Process-wide LRU over native run-cache ids."""

    def __init__(self, capacity_bytes: Optional[int] = None):
        self._cap_override = capacity_bytes
        self._map: "OrderedDict[CacheKey, Tuple[int, int]]" = \
            OrderedDict()                  # guarded-by: _lock
        self._used = 0                     # guarded-by: _lock
        self._lock = threading.Lock()
        self.hits = 0                      # guarded-by: _lock
        self.misses = 0                    # guarded-by: _lock

    @property
    def capacity(self) -> int:
        if self._cap_override is not None:
            return self._cap_override
        return flags.get_flag("compaction_run_cache_mb") << 20

    def get(self, key: CacheKey) -> Optional[int]:
        with self._lock:
            ent = self._map.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._map.move_to_end(key)
            self.hits += 1
            return ent[0]

    def contains(self, key: CacheKey) -> bool:
        with self._lock:
            return key in self._map

    def put(self, key: CacheKey, run_id: int, nbytes: int) -> None:
        from yugabyte_tpu_torch.storage import native_engine
        dead = []
        with self._lock:
            prior = self._map.pop(key, None)
            if prior is not None:
                # replace, never shadow: a reused file id must not serve
                # stale rows (same rule as DeviceSlabCache.put)
                self._used -= prior[1]
                dead.append(prior[0])
            self._map[key] = (run_id, nbytes)
            self._used += nbytes
            # may evict the entry just inserted: a single run larger than
            # the whole budget must not pin RAM past the configured cap
            while self._used > self.capacity and self._map:
                _, (old_id, old_bytes) = self._map.popitem(last=False)
                self._used -= old_bytes
                dead.append(old_id)
        for rid in dead:
            native_engine.runcache_drop(rid)

    def drop(self, key: CacheKey) -> None:
        from yugabyte_tpu_torch.storage import native_engine
        with self._lock:
            ent = self._map.pop(key, None)
            if ent is not None:
                self._used -= ent[1]
        if ent is not None:
            native_engine.runcache_drop(ent[0])

    def drop_namespace(self, namespace: str) -> None:
        from yugabyte_tpu_torch.storage import native_engine
        with self._lock:
            ids = []
            for k in [k for k in self._map if k[0] == namespace]:
                rid, nbytes = self._map.pop(k)
                self._used -= nbytes
                ids.append(rid)
        for rid in ids:
            native_engine.runcache_drop(rid)

    @property
    def used_bytes(self) -> int:
        with self._lock:
            return self._used


def export_reader(run_cache, file_id: int, reader) -> None:
    """Retain one on-disk SST decoded in the run cache: what flush
    write-through does for a freshly written file (used to reconstruct the
    steady state for files that already exist)."""
    from yugabyte_tpu_torch.storage import native_engine
    with native_engine.NativeCompactionJob() as job:
        with open(reader.data_path, "rb") as f:
            job.add_input(f.read(), reader.block_handles)
        n = job.prepare()
        job.sort_all()  # identity survivors: the file is one sorted run
        rid = job.export_run(0, n, b"X")
        run_cache.put(file_id, rid, native_engine.runcache_entry_bytes(rid))


_shared: Optional[NativeRunCache] = None  # guarded-by: _shared_lock
_shared_lock = threading.Lock()


def shared_run_cache() -> Optional[NativeRunCache]:
    """The process-wide cache, or None when disabled / no native engine."""
    from yugabyte_tpu_torch.storage import native_engine
    if flags.get_flag("compaction_run_cache_mb") <= 0:
        return None
    if not native_engine.available():
        return None
    global _shared
    with _shared_lock:
        if _shared is None:
            _shared = NativeRunCache()
        return _shared


class NamespacedRunCache:
    """Per-DB view (bare file ids), mirroring NamespacedSlabCache."""

    def __init__(self, shared: NativeRunCache, namespace: str):
        self._shared = shared
        self.namespace = namespace

    def get(self, file_id: int) -> Optional[int]:
        return self._shared.get((self.namespace, file_id))

    def contains(self, file_id: int) -> bool:
        return self._shared.contains((self.namespace, file_id))

    def put(self, file_id: int, run_id: int, nbytes: int) -> None:
        self._shared.put((self.namespace, file_id), run_id, nbytes)

    def drop(self, file_id: int) -> None:
        self._shared.drop((self.namespace, file_id))

    def drop_all(self) -> None:
        self._shared.drop_namespace(self.namespace)

    @property
    def hits(self) -> int:
        return self._shared.hits

    @property
    def misses(self) -> int:
        return self._shared.misses
