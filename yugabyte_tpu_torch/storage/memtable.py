"""MemTable: the in-memory sorted run.

Copy of yugabyte_tpu/storage/memtable.py with the imports renamed;
the native arena is built from native/memtable_arena.cc into this
package's build directory.

Capability parity with the reference's skiplist memtable (ref:
src/yb/rocksdb/db/memtable.cc, memtable/skiplistrep.cc). Python design:
an append log + lazily-sorted key list — appends are O(1), and sorting a
mostly-sorted list on first read after a write burst is near-linear
(timsort). Entries are keyed by full internal key (key_prefix + HT suffix),
which is unique per write. Flush emits a KVSlab directly (the flush job's
entire output path stays columnar).
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime
from yugabyte_tpu_torch.docdb.doc_key import split_key_and_ht
from yugabyte_tpu_torch.docdb.value_type import ValueType
from yugabyte_tpu_torch.ops.slabs import KVSlab, pack_doc_ht, pack_kvs


def make_internal_key(key_prefix: bytes, dht: DocHybridTime) -> bytes:
    return key_prefix + bytes([ValueType.kHybridTime]) + dht.encoded()


class MemTable:
    def __init__(self):
        self._data: Dict[bytes, bytes] = {}
        self._keys: List[bytes] = []
        self._sorted_upto = 0
        self._dups_possible = False
        self._bytes = 0
        self.version = 0  # bumped per mutation: packed-run cache key
        self._lock = threading.Lock()
        # monotonic time of the first write — the global-memstore arbiter
        # flushes the tablet holding the OLDEST mutable data first
        # (ref: tserver/tablet_memory_manager.cc TabletToFlush)
        self._first_write_s: Optional[float] = None

    def add(self, key_prefix: bytes, dht: DocHybridTime, value: bytes) -> None:
        ikey = make_internal_key(key_prefix, dht)
        with self._lock:
            if ikey not in self._data:
                self._keys.append(ikey)
            self._data[ikey] = value
            self._bytes += len(ikey) + len(value)
            self.version += 1
            if self._first_write_s is None:
                self._first_write_s = time.monotonic()

    def add_batch(self, items) -> None:
        """Bulk insert of (key_prefix, dht, value) triples — one lock
        acquisition, C-speed dict.update, and deferred key dedup (the
        sorted-snapshot pass dedups; the write-path hot loop, ref:
        db/memtable.cc Add)."""
        ikeys = [make_internal_key(k, dht) for k, dht, _ in items]
        vals = [v for _, _, v in items]
        nbytes = sum(map(len, ikeys)) + sum(map(len, vals))
        with self._lock:
            self._data.update(zip(ikeys, vals))
            # may append keys already present; _sorted_snapshot dedups
            self._keys.extend(ikeys)
            self._dups_possible = True
            self._bytes += nbytes
            self.version += 1
            if self._first_write_s is None:
                self._first_write_s = time.monotonic()

    def point_get(self, seek: bytes, boundary: bytes
                  ) -> Optional[Tuple[bytes, bytes]]:
        """First (internal_key, value) at or after `seek` that still starts
        with `boundary`, without copying the key list (the per-point-read
        snapshot copy dominated hot gets on large memtables)."""
        with self._lock:
            self._ensure_sorted_locked()
            idx = bisect.bisect_left(self._keys, seek)
            if idx < len(self._keys):
                k = self._keys[idx]
                if k.startswith(boundary):
                    return k, self._data[k]
        return None

    def entries_range(self, lower: bytes,
                      upper: bytes) -> List[Tuple[bytes, bytes]]:
        """(internal_key, value) with lower <= key < upper (the bounded
        per-row probe of the batched read path; same contract as
        NativeMemTable.entries_range)."""
        with self._lock:
            self._ensure_sorted_locked()
            lo = bisect.bisect_left(self._keys, lower)
            hi = bisect.bisect_left(self._keys, upper)
            return [(k, self._data[k]) for k in self._keys[lo:hi]]

    def point_get_many(self, probes) -> List[Optional[Tuple[bytes, bytes]]]:
        """Batched point_get over [(seek, boundary), ...]: one lock/sort
        for the whole probe list (the batched read path's per-key probe)."""
        out: List[Optional[Tuple[bytes, bytes]]] = [None] * len(probes)
        with self._lock:
            self._ensure_sorted_locked()
            keys = self._keys
            n = len(keys)
            for j, (seek, boundary) in enumerate(probes):
                idx = bisect.bisect_left(keys, seek)
                if idx < n and keys[idx].startswith(boundary):
                    out[j] = (keys[idx], self._data[keys[idx]])
        return out

    def _ensure_sorted_locked(self) -> None:
        if self._sorted_upto != len(self._keys):
            # add_batch defers duplicate-key suppression to here: one
            # set() pass at sort time beats a per-row `in` probe per write
            self._keys = sorted(set(self._keys)) if self._dups_possible \
                else sorted(self._keys)
            self._dups_possible = False
            self._sorted_upto = len(self._keys)

    @property
    def oldest_write_s(self) -> Optional[float]:
        return self._first_write_s

    @property
    def n_entries(self) -> int:
        return len(self._data)

    @property
    def approximate_bytes(self) -> int:
        return self._bytes

    @property
    def empty(self) -> bool:
        return not self._data

    def _sorted_snapshot(self) -> List[bytes]:
        """Sorted key list safe to iterate without the lock.

        Sorting REPLACES the list (never in-place), so earlier snapshots are
        never mutated; concurrent adds append to the current list but the
        snapshot's returned length bound hides them.
        """
        with self._lock:
            self._ensure_sorted_locked()
            return self._keys[:]  # cheap vs re-sort; isolates from appends

    def iter_from(self, seek_key: bytes = b"") -> Iterator[Tuple[bytes, bytes]]:
        """Yield (internal_key, value) in memcmp order from seek_key."""
        snap = self._sorted_snapshot()
        idx = bisect.bisect_left(snap, seek_key)
        for i in range(idx, len(snap)):
            k = snap[i]
            yield k, self._data[k]

    def to_slab(self) -> KVSlab:
        """Flush path: produce a sorted slab (ref: db/flush_job.cc)."""
        snap = self._sorted_snapshot()
        triples = []
        for ikey in snap:
            prefix, dht = split_key_and_ht(ikey)
            triples.append((prefix, pack_doc_ht(dht), self._data[ikey]))
        return pack_kvs(triples)

    def to_packed(self):
        """Sorted packed-run arrays for the native flush encoder
        (native/compaction_engine.cc ce_job_add_raw): (keys_blob, key_offs,
        ht, wid, vals_blob, val_offs). The 13-byte internal-key suffix is
        fixed width, so the split is pure slicing and the DocHybridTime
        columns decode in two vectorized complement passes."""
        import numpy as np
        from yugabyte_tpu_torch.common.hybrid_time import ENCODED_DOC_HT_SIZE
        snap = self._sorted_snapshot()
        n = len(snap)
        s = ENCODED_DOC_HT_SIZE + 1  # kHybridTime byte + 12-byte suffix
        prefixes = [k[:-s] for k in snap]
        keys_blob = b"".join(prefixes)
        key_offs = np.zeros(n + 1, dtype=np.int64)
        if n:
            np.cumsum([len(p) for p in prefixes], out=key_offs[1:])
        suffix = b"".join(k[-ENCODED_DOC_HT_SIZE:] for k in snap)
        rec = (np.frombuffer(suffix, dtype=np.uint8).reshape(n, 12)
               if n else np.zeros((0, 12), dtype=np.uint8))
        ht = (np.ascontiguousarray(rec[:, :8]).view(">u8").ravel()
              ^ np.uint64(0xFFFFFFFFFFFFFFFF)).astype(np.uint64)
        wid = (np.ascontiguousarray(rec[:, 8:]).view(">u4").ravel()
               ^ np.uint32(0xFFFFFFFF)).astype(np.uint32)
        data = self._data
        vals = [data[k] for k in snap]
        vals_blob = b"".join(vals)
        val_offs = np.zeros(n + 1, dtype=np.int64)
        if n:
            np.cumsum([len(v) for v in vals], out=val_offs[1:])
        return keys_blob, key_offs, ht, wid, vals_blob, val_offs


# --------------------------------------------------------------------------
# Native memtable arena (native/memtable_arena.cc): the same interface at
# memcpy speed — append-only C++ arena of full internal keys, sort-on-
# demand index, latest-insert-wins dedup (ref: db/memtable.cc arena).

import ctypes as _ct

import numpy as _np

_U64 = 0xFFFFFFFFFFFFFFFF
_U32 = 0xFFFFFFFF
_mt_lib = None
_mt_lib_lock = threading.Lock()
_i64p = _ct.POINTER(_ct.c_int64)
_u64p = _ct.POINTER(_ct.c_uint64)
_u32p = _ct.POINTER(_ct.c_uint32)
_u8p = _ct.POINTER(_ct.c_uint8)


def _load_mt_lib():
    global _mt_lib
    with _mt_lib_lock:
        if _mt_lib is not None:
            return _mt_lib
        from yugabyte_tpu_torch.utils.native_build import build_native_lib
        path = build_native_lib("memtable_arena.cc", "libmemtable_arena.so",
                                deps=())
        lib = _ct.CDLL(path)
        lib.mt_new.restype = _ct.c_void_p
        lib.mt_free.argtypes = [_ct.c_void_p]
        lib.mt_add_batch.argtypes = [_ct.c_void_p, _ct.c_char_p, _i64p,
                                     _ct.c_char_p, _ct.c_char_p, _i64p,
                                     _ct.c_int64]
        lib.mt_n.restype = _ct.c_int64
        lib.mt_n.argtypes = [_ct.c_void_p]
        lib.mt_bytes.restype = _ct.c_int64
        lib.mt_bytes.argtypes = [_ct.c_void_p]
        lib.mt_raw_n.restype = _ct.c_int64
        lib.mt_raw_n.argtypes = [_ct.c_void_p]
        lib.mt_lower_bound.restype = _ct.c_int64
        lib.mt_lower_bound.argtypes = [_ct.c_void_p, _ct.c_char_p,
                                       _ct.c_int32]
        lib.mt_range_sizes.argtypes = [_ct.c_void_p, _ct.c_int64,
                                       _ct.c_int64, _ct.c_int32, _i64p,
                                       _i64p]
        lib.mt_export_range.argtypes = [_ct.c_void_p, _ct.c_int64,
                                        _ct.c_int64, _ct.c_int32, _u8p,
                                        _i64p, _u64p, _u32p, _u8p, _i64p]
        _mt_lib = lib
        return lib


def native_memtable_available() -> bool:
    try:
        _load_mt_lib()
        return True
    except Exception:  # noqa: BLE001  # yblint: contained(feature probe — no toolchain means the Python memtable)
        return False


def _encode_suffixes(ht_vals: _np.ndarray, wids: _np.ndarray) -> bytes:
    """Vectorized DocHybridTime.encoded() for a column: 12 bytes/row of
    big-endian complement (desc order), concatenated."""
    n = len(ht_vals)
    out = _np.empty((n, 12), dtype=_np.uint8)
    out[:, :8] = (
        (ht_vals.astype(_np.uint64) ^ _np.uint64(_U64))
        .astype(">u8").view(_np.uint8).reshape(n, 8))
    out[:, 8:] = (
        (wids.astype(_np.uint32) ^ _np.uint32(_U32))
        .astype(">u4").view(_np.uint8).reshape(n, 4))
    return out.tobytes()


class NativeMemTable:
    """Drop-in MemTable twin backed by the C++ arena."""

    def __init__(self):
        self._lib = _load_mt_lib()
        self._h = self._lib.mt_new()
        self._lock = threading.Lock()
        self.version = 0
        self._first_write_s: Optional[float] = None
        # reusable export buffers + pre-cast pointers for the batched
        # point-probe path (per-call numpy allocation + ctypes casts
        # dominated multi-row reads); guarded-by: _lock
        self._scratch = None

    def __del__(self):
        try:
            if self._h:
                self._lib.mt_free(self._h)
                self._h = None
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    # ------------------------------------------------------------- write
    def add(self, key_prefix: bytes, dht: DocHybridTime, value: bytes) -> None:
        self.add_batch([(key_prefix, dht, value)])

    def add_batch(self, items) -> None:
        keys = [k for k, _d, _v in items]
        vals = [v for _k, _d, v in items]
        n = len(items)
        ht = _np.fromiter((d.ht.value for _k, d, _v in items),
                          dtype=_np.uint64, count=n)
        wid = _np.fromiter((d.write_id for _k, d, _v in items),
                           dtype=_np.uint32, count=n)
        self._add_packed(keys, ht, wid, vals)

    def add_columns(self, keys: List[bytes], ht: _np.ndarray,
                    wid: _np.ndarray, values: List[bytes]) -> None:
        """Columnar bulk write (the batched-RPC apply / bulk-load shape):
        parallel lists/arrays, one native call."""
        self._add_packed(keys, _np.asarray(ht, dtype=_np.uint64),
                         _np.asarray(wid, dtype=_np.uint32), values)

    def _add_packed(self, keys, ht, wid, vals) -> None:
        n = len(keys)
        if n == 0:
            return
        if not (len(ht) == len(wid) == len(vals) == n):
            # the C side trusts n: a mismatch would read past the suffix
            # buffer and store garbage MVCC timestamps
            raise ValueError(
                f"column length mismatch: keys={n} ht={len(ht)} "
                f"wid={len(wid)} values={len(vals)}")
        keys_blob = b"".join(keys)
        koffs = _np.zeros(n + 1, dtype=_np.int64)
        _np.cumsum([len(k) for k in keys], out=koffs[1:])
        vals_blob = b"".join(vals)
        voffs = _np.zeros(n + 1, dtype=_np.int64)
        _np.cumsum([len(v) for v in vals], out=voffs[1:])
        sfx = _encode_suffixes(ht, wid)
        with self._lock:
            self._lib.mt_add_batch(
                self._h, keys_blob, koffs.ctypes.data_as(_i64p), sfx,
                vals_blob, voffs.ctypes.data_as(_i64p), _ct.c_int64(n))
            self.version += 1
            if self._first_write_s is None:
                self._first_write_s = time.monotonic()

    # -------------------------------------------------------------- read
    def _export(self, start: int, end: int, include_suffix: bool):
        kb = _ct.c_int64()
        vb = _ct.c_int64()
        inc = _ct.c_int32(1 if include_suffix else 0)
        self._lib.mt_range_sizes(self._h, start, end, inc,
                                 _ct.byref(kb), _ct.byref(vb))
        n = end - start
        keys = _np.empty(max(1, kb.value), dtype=_np.uint8)
        koffs = _np.zeros(n + 1, dtype=_np.int64)
        ht = _np.empty(max(1, n), dtype=_np.uint64)
        wid = _np.empty(max(1, n), dtype=_np.uint32)
        vals = _np.empty(max(1, vb.value), dtype=_np.uint8)
        voffs = _np.zeros(n + 1, dtype=_np.int64)
        self._lib.mt_export_range(
            self._h, start, end, inc, keys.ctypes.data_as(_u8p),
            koffs.ctypes.data_as(_i64p), ht.ctypes.data_as(_u64p),
            wid.ctypes.data_as(_u32p), vals.ctypes.data_as(_u8p),
            voffs.ctypes.data_as(_i64p))
        return keys, koffs, ht, wid, vals, voffs

    def _export_one_locked(self, idx: int) -> Tuple[bytes, bytes]:
        """Single-entry export through the reusable scratch buffers;
        caller holds _lock. Returns (internal_key, value) copies."""
        kb = _ct.c_int64()
        vb = _ct.c_int64()
        self._lib.mt_range_sizes(self._h, idx, idx + 1, _ct.c_int32(1),
                                 _ct.byref(kb), _ct.byref(vb))
        sc = self._scratch
        if sc is None or sc[0].size < kb.value or sc[2].size < vb.value:
            keys = _np.empty(max(4096, kb.value * 2), dtype=_np.uint8)
            koffs = _np.zeros(2, dtype=_np.int64)
            vals = _np.empty(max(65536, vb.value * 2), dtype=_np.uint8)
            voffs = _np.zeros(2, dtype=_np.int64)
            ht = _np.empty(1, dtype=_np.uint64)
            wid = _np.empty(1, dtype=_np.uint32)
            sc = self._scratch = (
                keys, koffs, vals, voffs, ht, wid,
                (keys.ctypes.data_as(_u8p), koffs.ctypes.data_as(_i64p),
                 ht.ctypes.data_as(_u64p), wid.ctypes.data_as(_u32p),
                 vals.ctypes.data_as(_u8p), voffs.ctypes.data_as(_i64p)))
        kp, kop, htp, widp, vp, vop = sc[6]
        self._lib.mt_export_range(self._h, idx, idx + 1, _ct.c_int32(1),
                                  kp, kop, htp, widp, vp, vop)
        return (sc[0][: sc[1][1]].tobytes(), sc[2][: sc[3][1]].tobytes())

    def point_get(self, seek: bytes, boundary: bytes
                  ) -> Optional[Tuple[bytes, bytes]]:
        with self._lock:
            idx = int(self._lib.mt_lower_bound(self._h, seek, len(seek)))
            if idx >= int(self._lib.mt_n(self._h)):
                return None
            ikey, val = self._export_one_locked(idx)
        if not ikey.startswith(boundary):
            return None
        return ikey, val

    def point_get_many(self, probes) -> List[Optional[Tuple[bytes, bytes]]]:
        """Batched point_get over [(seek, boundary), ...]: ONE lock
        acquisition and scratch-buffer exports for the whole probe list
        (the batched row read probes the memtable once per enumerated
        key; per-call locking + allocation dominated it)."""
        out: List[Optional[Tuple[bytes, bytes]]] = [None] * len(probes)
        with self._lock:
            total = int(self._lib.mt_n(self._h))
            if total == 0:
                return out
            for j, (seek, boundary) in enumerate(probes):
                idx = int(self._lib.mt_lower_bound(self._h, seek,
                                                   len(seek)))
                if idx >= total:
                    continue
                ikey, val = self._export_one_locked(idx)
                if ikey.startswith(boundary):
                    out[j] = (ikey, val)
        return out

    def entries_range(self, lower: bytes,
                      upper: bytes) -> List[Tuple[bytes, bytes]]:
        """(internal_key, value) with lower <= key < upper in ONE bounded
        export. The batched row probe calls this once per row; iter_from
        would export a full 4096-entry batch to answer a range that holds
        a handful of entries, which dominated the multi-row read wall
        time."""
        with self._lock:
            lo = int(self._lib.mt_lower_bound(self._h, lower, len(lower)))
            hi = int(self._lib.mt_lower_bound(self._h, upper, len(upper)))
            if lo >= hi:
                return []
            keys, koffs, _ht, _wid, vals, voffs = \
                self._export(lo, hi, True)
        return [(keys[koffs[i]: koffs[i + 1]].tobytes(),
                 vals[voffs[i]: voffs[i + 1]].tobytes())
                for i in range(hi - lo)]

    def iter_from(self, seek_key: bytes = b""
                  ) -> Iterator[Tuple[bytes, bytes]]:
        """(internal_key, value) in memcmp order from seek_key; batched
        exports re-seek by last key, so concurrent adds never tear."""
        batch = 4096
        seek = seek_key
        strict = False
        while True:
            with self._lock:
                idx = int(self._lib.mt_lower_bound(self._h, seek, len(seek)))
                total = int(self._lib.mt_n(self._h))
                end = min(idx + batch, total)
                if idx >= end:
                    return
                keys, koffs, _ht, _wid, vals, voffs = \
                    self._export(idx, end, True)
            last = None
            for i in range(end - idx):
                ikey = keys[koffs[i]: koffs[i + 1]].tobytes()
                if strict and ikey == seek:
                    continue
                yield ikey, vals[voffs[i]: voffs[i + 1]].tobytes()
                last = ikey
            if end >= total and last is None:
                return
            if last is not None:
                seek = last
                strict = True
            if end >= total:
                # may have grown concurrently; one more probe past `last`
                with self._lock:
                    if int(self._lib.mt_lower_bound(
                            self._h, seek, len(seek))) + 1 >= \
                            int(self._lib.mt_n(self._h)):
                        return

    # ------------------------------------------------------------- stats
    @property
    def oldest_write_s(self) -> Optional[float]:
        return self._first_write_s

    @property
    def n_entries(self) -> int:
        with self._lock:
            return int(self._lib.mt_n(self._h))

    @property
    def approximate_bytes(self) -> int:
        with self._lock:
            return int(self._lib.mt_bytes(self._h))

    @property
    def empty(self) -> bool:
        with self._lock:
            return int(self._lib.mt_raw_n(self._h)) == 0

    # ------------------------------------------------------------- flush
    def to_packed(self):
        """Sorted packed-run columns for the native flush encoder — one
        C++ export, no Python joins (ref: db/flush_job.cc)."""
        with self._lock:
            n = int(self._lib.mt_n(self._h))
            keys, koffs, ht, wid, vals, voffs = self._export(0, n, False)
        return keys.tobytes(), koffs, ht, wid, vals.tobytes(), voffs

    def to_slab(self) -> KVSlab:
        with self._lock:
            n = int(self._lib.mt_n(self._h))
            keys, koffs, ht, wid, vals, voffs = self._export(0, n, False)
        triples = []
        for i in range(n):
            packed = (int(ht[i]) << 32) | int(wid[i])
            triples.append((keys[koffs[i]: koffs[i + 1]].tobytes(), packed,
                            vals[voffs[i]: voffs[i + 1]].tobytes()))
        return pack_kvs(triples)


def new_memtable():
    """Factory: the native arena when the toolchain is available, else the
    Python MemTable."""
    if native_memtable_available():
        return NativeMemTable()
    return MemTable()
