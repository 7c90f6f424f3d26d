"""Device-resident slab cache: SST key columns kept on the card.

Counterpart of yugabyte_tpu/storage/device_cache.py (:40-360 and the two
functions at the end). The cache keeps *staged key-column matrices*
(ops/merge_gc.StagedCols, int32 [8+w, n_pad]) in device memory so that a
read or a compaction over a resident file skips the host decode and the
upload. Flush writes through (storage/db.py); the batched point read
stages a file on a miss (`stage(..., for_read=True)`).

Residency is a multi-level set, not a flat LRU: entries carry the LSM
level of the file they stage, capacity eviction prefers the shallow
levels (LRU within a level), and entries pinned by an in-flight job are
never evicted. Values stay on the host.

`DeviceSlabCache(device=None)` resolves through
`torch_setup.resolve_device`: `cuda`, or the CPU only when the caller
passes `device="cpu"`.

Not ported yet (ROADMAP item 4): `ShardPartition`, `HostStagingPool`,
the value words (`attach_vals`, `stage(include_vals=True)`),
`stage_from_raw`, and the compaction write-through that installs
resident outputs. Each of the first four raises NotImplementedError.
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

_NOT_PORTED = ("{what} is not ported yet (ROADMAP item 4: the device "
               "cache's second half)")


@dataclass
class _Resident:
    """One cache entry: the staged columns plus residency metadata."""
    staged: StagedCols
    level: int = 0      # LSM level of the staged file (0 = flush output)
    pins: int = 0       # in-flight jobs reading this entry
    bytes: int = 0      # nbytes recorded in _used


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
        # per-instance ints (tests diff fresh caches); the JAX package's
        # registry counters come with the metrics registry (ROADMAP item 6)
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
        raise NotImplementedError(_NOT_PORTED.format(what="attach_vals"))

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
        raise NotImplementedError(_NOT_PORTED.format(what="stage_from_raw"))

    def stage(self, key: CacheKey, slab: KVSlab,
              level: int = 0, for_read: bool = False,
              include_vals: bool = False, device=None) -> StagedCols:
        if include_vals:
            raise NotImplementedError(
                _NOT_PORTED.format(what="stage(include_vals=True)"))
        staged = stage_slab(slab, device if device is not None
                            else self.device)
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

    def get(self, file_id: int):
        return self._shared.get((self.namespace, file_id))

    def contains(self, file_id: int) -> bool:
        return self._shared.contains((self.namespace, file_id))

    def pin(self, file_id: int) -> bool:
        return self._shared.pin((self.namespace, file_id))

    def unpin(self, file_id: int) -> None:
        self._shared.unpin((self.namespace, file_id))

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
    """Per-mesh-shard partition of the shared cache (not ported yet)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format(what="ShardPartition"))


class HostStagingPool:
    """Reusable host staging arrays of the compaction pipeline (not
    ported yet)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_NOT_PORTED.format(what="HostStagingPool"))


def host_staging_pool() -> HostStagingPool:
    return HostStagingPool()


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
