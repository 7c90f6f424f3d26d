"""Device-resident slab cache: SST key columns kept on the card.

Counterpart of yugabyte_tpu/storage/device_cache.py. The cache keeps
*staged key-column matrices* (ops/merge_gc.StagedCols, int32 [8+w, n_pad])
in device memory so that a read or a compaction over a resident file
skips the host decode and the upload. Flush writes through
(storage/db.py); compaction writes through too: each output file's
survivor span is gathered on the card (kernels D and E) and installed
under the output id as the file hits disk (storage/compaction.
_ResidentSpanInstaller), so a chained L0->L1->L2 job starts resident. The
batched point read stages a file on a miss (`stage(..., for_read=True)`);
the device codec's miss path decodes raw blocks on the card
(`stage_from_raw`, kernel C).

Residency is a multi-level set, not a flat LRU: entries carry the LSM
level of the file they stage (flush outputs are level 0, a compaction
output one above its deepest input), capacity eviction prefers the
shallow levels (LRU within a level), and entries pinned by an in-flight
job are never evicted. Values stay on the host, except the pushdown's
small value-word matrix (`stage(include_vals=True)`, `attach_vals`).

`DeviceSlabCache(device=None)` resolves through
`torch_setup.resolve_device`: `cuda`, or the CPU only when the caller
passes `device="cpu"`. `ShardPartition` is a per-mesh-shard view whose
staging commits to that shard's device; `HostStagingPool` recycles the
host arrays of run_merge.stage_runs_from_slabs (pinned on a card).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from yugabyte_tpu_torch.ops.merge_gc import (_ROW_WORDS, StagedCols,
                                             bucket_size, build_sort_schedule,
                                             stage_slab)
from yugabyte_tpu_torch.ops.slabs import KVSlab
from yugabyte_tpu_torch.utils import flags, torch_setup

flags.define_flag("device_cache_capacity_bytes", 4 << 30,
                  "device-memory budget for the resident slab cache "
                  "(staged SST key columns); eviction prefers shallow "
                  "levels and never touches pinned entries")

CacheKey = Tuple[str, int]  # (namespace, file_id) — file ids are per-DB

@dataclass
class _Resident:
    """One cache entry: the staged columns plus residency metadata."""
    staged: StagedCols
    level: int = 0      # LSM level of the staged file (0 = flush output)
    pins: int = 0       # in-flight jobs reading this entry
    bytes: int = 0      # nbytes RECORDED in _used (value-word staging
    #                     grows an entry in place; eviction must subtract
    #                     what was added, not what is there now)


class DeviceSlabCache:
    """Server-wide cache; keys are namespaced per DB because VersionSet file
    ids are only unique within one DB (like the reference's per-DB file
    numbers under a shared block cache)."""

    def __init__(self, device=None, capacity_bytes: Optional[int] = None):
        self.device = torch_setup.resolve_device(device)
        self.capacity = (capacity_bytes if capacity_bytes is not None
                         else flags.get_flag("device_cache_capacity_bytes"))
        self._lock = threading.Lock()
        self._map: "OrderedDict[CacheKey, _Resident]" = \
            OrderedDict()                  # guarded-by: _lock
        self._used = 0                     # guarded-by: _lock
        # per-instance ints (tests diff fresh caches); the tablet
        # server's /compactionz reads them through snapshot(). The JAX
        # package's process-wide registry mirrors are not copied
        self.hits = 0                      # guarded-by: _lock
        self.misses = 0                    # guarded-by: _lock
        self.evictions = 0                 # guarded-by: _lock
        self.read_stages = 0               # guarded-by: _lock

    def get(self, key: CacheKey) -> Optional[StagedCols]:
        with self._lock:
            ent = self._map.get(key)
            if ent is None:
                self.misses += 1
                return None
            self._map.move_to_end(key)
            self.hits += 1
            return ent.staged

    def contains(self, key: CacheKey) -> bool:
        """Metrics-neutral probe."""
        with self._lock:
            return key in self._map

    def level_of(self, key: CacheKey) -> Optional[int]:
        """Resident entry's LSM level, or None when absent (metrics-neutral:
        compaction derives its output level from the input levels)."""
        with self._lock:
            ent = self._map.get(key)
            return None if ent is None else ent.level

    # ------------------------------------------------------------- pinning
    def pin(self, key: CacheKey) -> bool:
        """Pin an entry for an in-flight job: capacity eviction skips it.
        Returns False when the key is not resident (nothing to pin)."""
        with self._lock:
            ent = self._map.get(key)
            if ent is None:
                return False
            ent.pins += 1
            return True

    def unpin(self, key: CacheKey) -> None:
        with self._lock:
            ent = self._map.get(key)
            if ent is not None and ent.pins > 0:
                ent.pins -= 1

    def pinned_count(self) -> int:
        """Entries with at least one pin: drains to zero after every job,
        a failed one included."""
        with self._lock:
            return sum(1 for e in self._map.values() if e.pins > 0)

    # ----------------------------------------------------------- mutation
    def put(self, key: CacheKey, staged: StagedCols, level: int = 0) -> None:
        with self._lock:
            prior = self._map.pop(key, None)
            pins = 0
            if prior is not None:
                # replace, not refuse: a stale entry under a reused id must
                # never shadow fresh data (correctness, not just freshness)
                self._used -= prior.bytes
                pins = prior.pins
            self._map[key] = _Resident(staged, level=level, pins=pins,
                                       bytes=staged.nbytes)
            self._used += staged.nbytes
            self._evict_unlocked(protect=key)

    def attach_vals(self, key: CacheKey, vals_dev) -> None:
        """Attach staged value words to a resident entry (the pushdown's
        write-through): the entry grows in place and the growth is
        accounted so eviction stays balanced. A missing key is a no-op."""
        with self._lock:
            ent = self._map.get(key)
            if ent is None:
                return
            ent.staged.vals_dev = vals_dev
            delta = ent.staged.nbytes - ent.bytes
            ent.bytes += delta
            self._used += delta
            self._evict_unlocked(protect=key)

    def _evict_unlocked(self, protect: Optional[CacheKey] = None) -> None:
        """Capacity eviction, shallow levels first, LRU within a level.
        Pinned entries are never touched; if only pinned entries remain
        over budget, residency exceeds capacity rather than racing the
        job."""
        while self._used > self.capacity:
            victim = None
            best = None
            for age, (k, ent) in enumerate(self._map.items()):
                if ent.pins > 0 or k == protect:
                    continue
                rank = (ent.level, age)
                if best is None or rank < best:
                    best = rank
                    victim = k
            if victim is None:
                break
            self._used -= self._map.pop(victim).bytes
            self.evictions += 1

    def drop(self, key: CacheKey) -> None:
        with self._lock:
            ent = self._map.pop(key, None)
            if ent is not None:
                self._used -= ent.bytes

    def drop_namespace(self, namespace: str) -> None:
        """Evict everything a closed DB staged, freeing its residency."""
        with self._lock:
            for k in [k for k in self._map if k[0] == namespace]:
                self._used -= self._map.pop(k).bytes

    def stage_from_raw(self, key: CacheKey, rfb,
                       level: int = 0) -> StagedCols:
        """Raw-block staging (the device codec's miss path): decode one
        parsed file's raw block regions on the card (ops/block_codec.
        decode_file_to_staged, kernel C) and install the cols. No host
        block decode runs."""
        from yugabyte_tpu_torch.ops.block_codec import decode_file_to_staged
        staged = decode_file_to_staged(rfb, self.device)
        self.put(key, staged, level=level)
        return staged

    def stage(self, key: CacheKey, slab: KVSlab,
              level: int = 0, for_read: bool = False,
              include_vals: bool = False, device=None) -> StagedCols:
        dev = device if device is not None else self.device
        staged = stage_slab(slab, dev)
        if include_vals:
            # the pushdown's write-through: the value words ride along so
            # the next filtered / aggregating scan is fully resident
            from yugabyte_tpu_torch.ops.merge_gc import u32_to_device
            from yugabyte_tpu_torch.ops.scan import pack_vals
            staged.vals_dev = u32_to_device(pack_vals(slab, staged.n_pad),
                                            staged.cols_dev.device)
        self.put(key, staged, level=level)
        if for_read:
            # a read had to decode and upload what write-through was
            # supposed to have left resident
            with self._lock:
                self.read_stages += 1
        return staged

    def snapshot(self) -> dict:
        """Residency totals plus the per-level breakdown the eviction
        policy acts on."""
        with self._lock:
            levels: Dict[int, dict] = {}
            for ent in self._map.values():
                lv = levels.setdefault(ent.level,
                                       {"entries": 0, "bytes": 0,
                                        "pinned": 0})
                lv["entries"] += 1
                lv["bytes"] += ent.staged.nbytes
                if ent.pins > 0:
                    lv["pinned"] += 1
            return {
                "capacity_bytes": self.capacity,
                "used_bytes": self._used,
                "entries": len(self._map),
                "pinned": sum(1 for e in self._map.values() if e.pins > 0),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "levels": {f"L{k}": v for k, v in sorted(levels.items())},
            }


class NamespacedSlabCache:
    """Per-DB view over a shared DeviceSlabCache: callers use bare file ids."""

    def __init__(self, shared: DeviceSlabCache, namespace: str):
        self._shared = shared
        self.namespace = namespace

    @property
    def device(self):
        return self._shared.device

    @property
    def hits(self):
        return self._shared.hits

    @property
    def misses(self):
        return self._shared.misses

    def get(self, file_id: int):
        return self._shared.get((self.namespace, file_id))

    def contains(self, file_id: int) -> bool:
        return self._shared.contains((self.namespace, file_id))

    def level_of(self, file_id: int) -> Optional[int]:
        return self._shared.level_of((self.namespace, file_id))

    def pin(self, file_id: int) -> bool:
        return self._shared.pin((self.namespace, file_id))

    def unpin(self, file_id: int) -> None:
        self._shared.unpin((self.namespace, file_id))

    def pinned_count(self) -> int:
        return self._shared.pinned_count()

    def put(self, file_id: int, staged: StagedCols, level: int = 0) -> None:
        self._shared.put((self.namespace, file_id), staged, level=level)

    def attach_vals(self, file_id: int, vals_dev) -> None:
        self._shared.attach_vals((self.namespace, file_id), vals_dev)

    def drop(self, file_id: int) -> None:
        self._shared.drop((self.namespace, file_id))

    def drop_all(self) -> None:
        self._shared.drop_namespace(self.namespace)

    def stage(self, file_id: int, slab: KVSlab,
              level: int = 0, for_read: bool = False,
              include_vals: bool = False) -> StagedCols:
        return self._shared.stage((self.namespace, file_id), slab,
                                  level=level, for_read=for_read,
                                  include_vals=include_vals)

    def stage_from_raw(self, file_id: int, rfb, level: int = 0
                       ) -> StagedCols:
        return self._shared.stage_from_raw((self.namespace, file_id), rfb,
                                           level=level)


class ShardPartition(NamespacedSlabCache):
    """Per-mesh-shard partition of the shared cache: keys carry the shard
    in the namespace (``<ns>/shard<i>``) and staging commits to that
    shard's device, so a pooled tablet's resident chain lives on the mesh
    slot that compacts it. Pins, eviction, levels and counters are the
    shared cache's; only key spelling and device placement change."""

    def __init__(self, shared: DeviceSlabCache, namespace: str,
                 shard: int, device=None):
        super().__init__(shared, f"{namespace}/shard{shard}")
        self.shard = shard
        self._device = (torch_setup.resolve_device(device)
                        if device is not None else None)

    @property
    def device(self):
        return self._device if self._device is not None \
            else self._shared.device

    def stage(self, file_id: int, slab: KVSlab,
              level: int = 0, for_read: bool = False,
              include_vals: bool = False) -> StagedCols:
        return self._shared.stage((self.namespace, file_id), slab,
                                  level=level, for_read=for_read,
                                  include_vals=include_vals,
                                  device=self._device)


class HostStagingPool:
    """Reusable host staging arrays of run_merge.stage_runs_from_slabs
    (stage A packs the run-major cols matrix into one before the upload).

    Shape buckets make reuse effective: the jobs of a tablet mostly stage
    the same [r, k_pad*m] shape, so after warm-up the host allocates
    nothing. For a card the arrays are views of pinned torch host
    buffers (`pinned=True`), which the upload reads directly; for the
    CPU they are plain numpy arrays.

    A caller releases an array only once the upload has COPIED it (a
    card); a CPU upload aliases the host memory, so its caller `forget`s
    the array instead and it is garbage-collected."""

    def __init__(self, max_per_shape: int = 2, max_bytes: int = 1 << 30):
        self._free: dict = {}              # guarded-by: _lock
        self._bytes = 0                    # guarded-by: _lock
        # ids of arrays acquired and not yet released or forgotten: after
        # every job, a failed one included, this drains back to 0
        self._leases: set = set()          # guarded-by: _lock
        self._max_per_shape = max_per_shape
        self._max_bytes = max_bytes
        self._lock = threading.Lock()

    def acquire(self, shape: Tuple[int, int], dtype=np.uint32,
                pinned: bool = False) -> np.ndarray:
        key = (tuple(shape), np.dtype(dtype).str, pinned)
        with self._lock:
            bucket = self._free.get(key)
            if bucket:
                arr = bucket.pop()
                self._bytes -= arr.nbytes
                self._leases.add(id(arr))
                return arr
        if pinned:
            import torch
            # the numpy view keeps its pinned torch buffer alive
            nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            arr = buf.numpy().view(dtype).reshape(shape)
        else:
            arr = np.empty(shape, dtype=dtype)
        with self._lock:
            self._leases.add(id(arr))
        return arr

    def release(self, arr: np.ndarray, pinned: bool = False) -> None:
        key = (arr.shape, arr.dtype.str, pinned)
        with self._lock:
            self._leases.discard(id(arr))
            bucket = self._free.setdefault(key, [])
            if (len(bucket) < self._max_per_shape
                    and self._bytes + arr.nbytes <= self._max_bytes):
                bucket.append(arr)
                self._bytes += arr.nbytes

    def forget(self, arr: np.ndarray) -> None:
        """End a lease WITHOUT recycling the memory: a CPU upload aliases
        the array, so it is handed off for garbage collection. Not a
        leak: the lease is accounted done."""
        with self._lock:
            self._leases.discard(id(arr))

    def outstanding(self) -> int:
        """Leases neither released nor forgotten."""
        with self._lock:
            return len(self._leases)


_staging_pool: Optional[HostStagingPool] = None  # guarded-by: _staging_pool_lock
_staging_pool_lock = threading.Lock()


def host_staging_pool() -> HostStagingPool:
    """Process-wide staging pool (one per process, like the slab cache)."""
    global _staging_pool
    with _staging_pool_lock:
        if _staging_pool is None:
            _staging_pool = HostStagingPool()
        return _staging_pool


def merged_column_stats(staged_list: Sequence[StagedCols], w: int
                        ) -> np.ndarray:
    """Cross-input is_const vector over staged inputs: a row prunes from
    the sort schedule only when it is constant WITH THE SAME VALUE across
    every input (constant-per-input with differing values still orders the
    merge). Inputs narrower than w expose their extra word rows as
    constant zero; inputs without column stats poison every row they
    cover as non-constant."""
    r_total = _ROW_WORDS + w
    k = len(staged_list)
    consts = np.zeros((k, r_total), dtype=bool)
    firsts = np.zeros((k, r_total), dtype=np.uint32)
    for i, s in enumerate(staged_list):
        rs = min(_ROW_WORDS + s.w, r_total)
        consts[i, rs:] = True              # implicit zero-pad word rows
        if s.col_const is not None:
            consts[i, :rs] = s.col_const[:rs]
            firsts[i, :rs] = s.col_first[:rs]
    return consts.all(axis=0) & (firsts == firsts[0:1]).all(axis=0)


def concat_staged(staged_list: Sequence[StagedCols]) -> StagedCols:
    """Concatenate staged inputs ON THE DEVICE into one padded cols matrix
    (kernel H through run_merge._concat_staged_fused): each input's width
    padded to the max, the real rows laid out back to back, the tail
    padded to the bucket size. The merged sort schedule prunes rows by the
    cross-input column stats."""
    from yugabyte_tpu_torch.ops.run_merge import _concat_staged_fused

    w = max(s.w for s in staged_list)
    n = sum(s.n for s in staged_list)
    n_pad = bucket_size(n)
    cat = _concat_staged_fused([s.cols_dev for s in staged_list],
                               [s.n for s in staged_list], w=w, n_pad=n_pad)
    sort_rows, n_sort = build_sort_schedule(
        w, merged_column_stats(staged_list, w))
    return StagedCols(cat, n, n_pad, w, sort_rows=sort_rows, n_sort=n_sort)
