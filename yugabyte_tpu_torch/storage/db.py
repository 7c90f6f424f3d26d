"""DB: the LSM storage engine facade, its read half.

Counterpart of yugabyte_tpu/storage/db.py (ref: src/yb/rocksdb/db/
db_impl.cc): WAL-less writes into the memtable, flush to L0 SSTs, bulk
ingest of packed runs, manifest recovery, and the reads: `get` (native
per-key engine, or the Python merged iterator), `iter_from`, and the
batched `multi_get`. On a DB with a device (and its `DeviceSlabCache`),
`multi_get` resolves the SST half of each 1024-key chunk on the card
(ops/point_read.py: kernels P1 hash, P2 bloom probe and P3 locate +
gather over the resident staged cols; the learned per-SST index seeds P3
when the file carries one) while the memtable probes and the winners'
value fetch stay on the host. Its answers are byte-identical to
`[db.get(k, read_ht) for k in keys]`.

`DBOptions.device` is `cuda` by default (`torch_setup.resolve_device`:
it raises without CUDA), or "cpu" when asked, and the kernels run on the
device cache's device (a DB given no cache makes its own). "native" is a
DB without a device path, the oracle's configuration: it takes no cache.
A learned-index misprediction is resolved by a second, exact P3 launch
and a stale resident entry is restaged: on a DB with a device, the SST
half of every key is resolved there, never on the host behind the
caller's back.

A DB with a device cache also keeps a run cache (storage/run_cache.py):
flush exports each new L0 file's decoded run into it, so the first
compaction over the file starts zero-decode; the obsolete-file purge and
`close` drop both caches' entries.

Not ported yet, each raising NotImplementedError that names its ROADMAP
queue A item: compaction scheduling (`auto_compact=True`, `compact_all`,
`maybe_schedule_compaction`), the scans (`scan_visible`,
`scan_filtered`, `scan_aggregate`, `scan_native`) and `checkpoint`: the
DB's remaining entry points; the health-board gate and device-fault
containment of `_multi_get_device`, the background-error slot and its
retry, and the read-corruption routing: health-board routing and
device-fault containment (here a kernel error propagates to the caller);
`scrub`: the sampled shadow verifier. `pre_flush_hook` comes with the
device-free rest.
"""

from __future__ import annotations

import heapq
import os
import threading
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime, HybridTime
from yugabyte_tpu_torch.docdb.doc_key import split_key_and_ht
from yugabyte_tpu_torch.docdb.value_type import ValueType
from yugabyte_tpu_torch.storage.memtable import (MemTable, make_internal_key,
                                                 new_memtable)
from yugabyte_tpu_torch.storage.sst import (
    BlockCache, Frontier, SSTReader, SSTWriter, data_file_name)
from yugabyte_tpu_torch.storage.version_set import VersionSet
from yugabyte_tpu_torch.utils import flags, torch_setup

flags.define_flag("memstore_size_bytes", 128 * 1024 * 1024,
                  "flush memtable at this size (ref docdb_rocksdb_util.cc:113)")
flags.define_flag("read_native", True,
                  "serve point reads and scans through the native read "
                  "engine (native/read_engine.cc) when it builds; the "
                  "Python merge path remains the fallback (ref: "
                  "block_based_table_reader.cc:1144-1286)")
flags.define_flag("point_read_batched", True,
                  "resolve DB.multi_get through the batched device "
                  "kernels (ops/point_read.py) when a device + slab "
                  "cache are configured; the native per-key path is the "
                  "byte-identical alternative")
flags.define_flag("point_read_learned_index", True,
                  "seed the batched locate kernel with persisted "
                  "learned per-SST indexes (advisory; mispredictions "
                  "fall back to the exact seek)")

_CHUNK = 1024   # keys per device chunk (the larger batch bucket)


_ENTRY_POINTS = "the DB's remaining entry points"
_HEALTH = "health-board routing and device-fault containment"
_SHADOW = "the sampled shadow verifier"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"DB.{what} is not ported yet (ROADMAP queue A: {item})")


@dataclass
class DBOptions:
    block_entries: Optional[int] = None
    block_cache: Optional[BlockCache] = None
    # device for the batched point-read kernels: None = "cuda", "cpu"
    # only when asked, "native" = no device path (and no device cache)
    device: object = None
    # device-resident slab cache (storage/device_cache.py); shared across
    # DBs like the reference's server-wide block cache
    device_cache: object = None
    memstore_size_bytes: Optional[int] = None
    auto_compact: bool = True


class DB:
    def __init__(self, db_dir: str, options: Optional[DBOptions] = None):
        self.db_dir = db_dir
        self.opts = options or DBOptions()
        if self.opts.auto_compact:
            raise NotImplementedError(
                "DBOptions(auto_compact=True): compaction scheduling is not "
                f"ported yet (ROADMAP queue A: {_ENTRY_POINTS}); pass "
                "auto_compact=False")
        self._device = self._device_cache = None
        # (staged_by, FileTable) of the last batched read (_file_table)
        self._point_table = None
        if self.opts.device == "native":
            if self.opts.device_cache is not None:
                raise ValueError("DBOptions(device='native') runs no "
                                 "kernels and takes no device cache")
        else:
            from yugabyte_tpu_torch.storage.device_cache import (
                DeviceSlabCache, NamespacedSlabCache)
            self._device = torch_setup.resolve_device(self.opts.device)
            cache = self.opts.device_cache
            if cache is None:
                cache = DeviceSlabCache(self._device)
            if cache.device.type != self._device.type:
                raise ValueError(
                    f"DBOptions.device {self._device} differs from the "
                    f"device cache's {cache.device}")
            # namespace file ids per DB under the shared server-wide cache
            self._device_cache = (
                NamespacedSlabCache(cache, os.path.abspath(db_dir))
                if isinstance(cache, DeviceSlabCache) else cache)
        # the host packed-run cache: flush outputs retained decoded so the
        # device-native compaction over them skips read + decode. Only
        # that job reads it, so a DB without a device path pays nothing
        # for it (the JAX DB's guard, db.py:195-196 there, in the port's
        # meaning of DBOptions.device: any device but "native")
        self._run_cache = None
        if self._device_cache is not None and self.opts.device != "native":
            from yugabyte_tpu_torch.storage.run_cache import (
                NamespacedRunCache, shared_run_cache)
            shared = shared_run_cache()
            if shared is not None:
                self._run_cache = NamespacedRunCache(
                    shared, os.path.abspath(db_dir))
        os.makedirs(db_dir, exist_ok=True)
        self.versions = VersionSet(db_dir)
        self.versions.recover()
        self.mem = new_memtable()
        self._imm: Optional[MemTable] = None   # guarded-by: _lock
        self._readers: dict = {}
        self._lock = threading.RLock()
        self._pins: dict = {}       # file_id -> active read count
        self._obsolete: dict = {}   # file_id -> reader awaiting unpin+delete
        self._last_op_id: Tuple[int, int] = (0, 0)
        # native read engine state: per-SST native handles + a frozen
        # ReaderSet snapshot, both rebuilt when the live-file set changes
        self._native_readers: dict = {}
        self._rset = None
        self._rset_gen = 0  # bumped on every invalidation: a ReaderSet
        #                     built against gen G installs only if still G
        for fm in self.versions.live_files():
            self._readers[fm.file_id] = SSTReader(fm.path,
                                                  self.opts.block_cache)

    # ------------------------------------------------------------------ write
    def _post_write_locked(self, op_id: Tuple[int, int]) -> bool:
        """Shared writer tail (lock held): op-id tracking + flush trigger."""
        self._last_op_id = max(self._last_op_id, op_id)
        limit = self.opts.memstore_size_bytes or \
            flags.get_flag("memstore_size_bytes")
        return self.mem.approximate_bytes >= limit

    def write_batch(self, items: List[Tuple[bytes, DocHybridTime, bytes]],
                    op_id: Tuple[int, int] = (0, 0)) -> None:
        """Apply a batch (already carrying DocHybridTimes). WAL-less: durability
        comes from the Raft log above (ref: tablet.cc:1247 WriteToRocksDB)."""
        with self._lock:
            mem = self.mem
            if len(items) > 8 or hasattr(mem, "add_columns"):
                # the native arena always takes the batch call (its add()
                # would pay a full ctypes round trip PER ROW)
                mem.add_batch(items)
            else:
                for key_prefix, dht, value in items:
                    mem.add(key_prefix, dht, value)
            need_flush = self._post_write_locked(op_id)
        # flush outside the lock: concurrent writers keep inserting into the
        # fresh memtable while the immutable one packs + writes its SST
        if need_flush:
            self.flush()

    def write_batch_columns(self, keys: List[bytes], ht, wid,
                            values: List[bytes],
                            op_id: Tuple[int, int] = (0, 0)) -> None:
        """Columnar bulk write: parallel key/value lists + uint64 HT and
        uint32 write-id arrays — one native memtable call instead of
        per-row tuple assembly (ref: db/memtable.cc Add)."""
        with self._lock:
            mem = self.mem
            if hasattr(mem, "add_columns"):
                mem.add_columns(keys, ht, wid, values)
            else:
                mem.add_batch([
                    (k, DocHybridTime(HybridTime(int(h)), int(w)), v)
                    for k, h, w, v in zip(keys, ht, wid, values)])
            need_flush = self._post_write_locked(op_id)
        if need_flush:
            self.flush()

    def ingest_packed(self, keys_blob: bytes, key_offs, ht, wid,
                      vals_blob: bytes, val_offs,
                      op_id: Tuple[int, int] = (0, 0)) -> Optional[int]:
        """Bulk-load one packed run directly as an L0 SST, bypassing the
        memtable (ref: src/yb/tools/yb_bulk_load.cc,
        rocksdb/db/external_sst_file_ingestion_job.cc). Rows need not be
        pre-sorted — the native encoder orders them. The file is not
        staged on the device (a later read stages it on a miss). Returns
        the file id, or None for an empty run. Requires the native
        engine."""
        from yugabyte_tpu_torch.storage import native_engine
        from yugabyte_tpu_torch.storage.sst import write_sst_from_packed
        from yugabyte_tpu_torch.utils.env import get_env
        if not (native_engine.available() and not get_env().encrypted):
            raise RuntimeError("ingest_packed requires the native engine")
        n = len(key_offs) - 1
        if n == 0:
            return None
        with self._lock:
            fid = self.versions.new_file_id()
            self._last_op_id = max(self._last_op_id, op_id)
        path = os.path.join(self.db_dir, f"{fid:06d}.sst")
        frontier = Frontier(op_id_min=op_id, op_id_max=op_id,
                            history_cutoff=0)
        props = write_sst_from_packed(
            path, keys_blob, key_offs, ht, wid, vals_blob, val_offs,
            frontier=frontier, block_entries=self.opts.block_entries)
        with self._lock:
            self.versions.add_file(fid, path, props)
            self._readers[fid] = SSTReader(path, self.opts.block_cache)
            self._rset = None
            self._rset_gen += 1
        return fid

    def flush(self) -> Optional[int]:
        """Memtable -> L0 SST (ref: db/flush_job.cc), with write-through
        of the new file's key columns to the device cache.

        The lock is held only to swap the memtable and to install the
        result; the SST write runs unlocked while reads serve from the
        immutable memtable. On failure the un-flushed entries go back
        into the live memtable, partial outputs are removed, and the
        error propagates (the background-error slot is ROADMAP queue A:
        health-board routing and device-fault containment).
        """
        with self._lock:
            if self._imm is not None:
                return None  # a flush is already in progress
            if self.mem.empty:
                return None
            self._imm, self.mem = self.mem, new_memtable()
            imm = self._imm
            last_op = self._last_op_id
        fid = path = None
        try:
            fid = self.versions.new_file_id()
            path = os.path.join(self.db_dir, f"{fid:06d}.sst")
            slab = None
            from yugabyte_tpu_torch.storage import native_engine
            from yugabyte_tpu_torch.utils.env import get_env
            if native_engine.available() and not get_env().encrypted:
                # native flush encoder: block encode + bloom + doc-key
                # parsing in C++ (ref: db/flush_job.cc WriteLevel0Table);
                # device staging still needs the slab form
                packed = imm.to_packed()
                frontier = Frontier(op_id_min=last_op, op_id_max=last_op,
                                    history_cutoff=0)
                from yugabyte_tpu_torch.storage.sst import (
                    write_sst_from_packed)
                props = write_sst_from_packed(
                    path, *packed, frontier=frontier,
                    block_entries=self.opts.block_entries,
                    run_cache=self._run_cache, file_id=fid)
                if self._device_cache is not None:
                    slab = imm.to_slab()
            else:
                slab = imm.to_slab()
                ht = slab.ht_hi.astype("u8") << 32 | slab.ht_lo
                frontier = Frontier(op_id_min=last_op, op_id_max=last_op,
                                    ht_min=int(ht.min()) if slab.n else 0,
                                    ht_max=int(ht.max()) if slab.n else 0,
                                    history_cutoff=0)
                props = SSTWriter(path, block_entries=self.opts.block_entries
                                  ).write(slab, frontier)
            if self._device_cache is not None and slab is not None:
                self._device_cache.stage(fid, slab)  # write-through
            with self._lock:
                self.versions.add_file(fid, path, props)
                self.versions.set_flushed_frontier(frontier)
                self._readers[fid] = SSTReader(path, self.opts.block_cache)
                self._imm = None
                self._rset = None  # native snapshot is stale
                self._rset_gen += 1
        except BaseException:
            with self._lock:
                # restore un-flushed entries into the live memtable
                for k, v in imm.iter_from():
                    prefix, dht = split_key_and_ht(k)
                    self.mem.add(prefix, dht, v)
                self._imm = None
                installed = fid is not None and fid in self.versions.files
            if path is not None and not installed:
                _delete_sst_files(path)
                if fid is not None:
                    self._drop_cached(fid)
            raise
        return fid

    # ---------------------------------------------------- native read engine
    def _native_rset(self):
        """Frozen native ReaderSet over the live SSTs, or None when the
        native read engine is disabled/unavailable. Snapshots outlive
        installs: in-flight reads keep the old set alive by reference."""
        if not flags.get_flag("read_native"):
            return None
        rset = self._rset
        if rset is not None:  # lock-free hot path (stale snapshots are
            return rset       # safe, see docstring)
        from yugabyte_tpu_torch.storage import native_read
        if not native_read.available():
            return None
        with self._lock:
            if self._rset is not None:
                return self._rset
            gen = self._rset_gen
            readers = dict(self._readers)
            existing = dict(self._native_readers)
        built = {}
        for fid, r in readers.items():
            nr = existing.get(fid)
            built[fid] = nr if nr is not None else \
                native_read.NativeSSTReader(r)
        rset = native_read.ReaderSet(list(built.values()))
        with self._lock:
            if self._rset_gen != gen:
                # an install landed while we built: serve this snapshot
                # for THIS call only, do not cache it
                return rset if self._rset is None else self._rset
            self._native_readers = built
            self._rset = rset
        return rset

    # ------------------------------------------------------------------ read
    def get(self, key_prefix: bytes, read_ht: Optional[HybridTime] = None
            ) -> Optional[Tuple[DocHybridTime, bytes]]:
        """Latest version of key_prefix visible at read_ht (raw KV semantics;
        document semantics layer above in docdb)."""
        return self._get_inner(key_prefix, read_ht)

    def _mem_snapshot(self):
        with self._lock:
            return [self.mem] + ([self._imm] if self._imm is not None
                                 else [])

    def _get_inner(self, key_prefix: bytes,
                   read_ht: Optional[HybridTime] = None
                   ) -> Optional[Tuple[DocHybridTime, bytes]]:
        read_ht = read_ht or HybridTime.kMax
        seek = make_internal_key(key_prefix, DocHybridTime(read_ht, 0xFFFFFFFF))
        boundary = key_prefix + bytes([ValueType.kHybridTime])
        # memtable snapshot BEFORE the reader set: a flush landing between
        # the two at worst double-covers a row (newest version wins)
        mems = self._mem_snapshot()
        rset = self._native_rset()
        if rset is not None:
            # native fast path: memtable probes in Python, SSTs in one
            # native call; newest visible version wins across sources
            best = None  # (ht_value, wid, value)
            for mem in mems:
                hit = mem.point_get(seek, boundary)
                if hit is not None:
                    _, dht = split_key_and_ht(hit[0])
                    cand = (dht.ht.value, dht.write_id, hit[1])
                    if best is None or cand[:2] > best[:2]:
                        best = cand
            if rset.n:
                hit = rset.multi_get(key_prefix, -1, read_ht.value)
                if hit is not None:
                    ht_v, wid, _fl, val = hit
                    if best is None or (ht_v, wid) > best[:2]:
                        best = (ht_v, wid, val)
            if best is None:
                return None
            return DocHybridTime(HybridTime(best[0]), best[1]), best[2]
        # Bloom filters hold DOC key prefixes (storage/bloom.py): probe with
        # the DocKey portion, not the full subdoc key.
        from yugabyte_tpu_torch.ops.slabs import _doc_key_len
        try:
            bloom_key = key_prefix[: _doc_key_len(key_prefix)]
        except Exception:  # noqa: BLE001 — unparseable key: no bloom gate
            bloom_key = None
        for ikey, value in self.iter_from(seek, check_bloom_doc=bloom_key):
            if not ikey.startswith(boundary):
                return None
            prefix, dht = split_key_and_ht(ikey)
            if prefix == key_prefix and dht.ht.value <= read_ht.value:
                return dht, value
            return None
        return None

    # ------------------------------------------------------- batched read
    def multi_get(self, keys: List[bytes],
                  read_ht: Optional[HybridTime] = None,
                  doc_key_lens: Optional[List[int]] = None
                  ) -> List[Optional[Tuple[DocHybridTime, bytes]]]:
        """Batched point reads: byte-identical to
        ``[self.get(k, read_ht) for k in keys]``. On a DB with a device
        the SST layer resolves each 1024-key chunk in the device kernels
        (ops/point_read.py) over the resident staged cols; the memtable
        probes and the winners' value fetch stay host-side. A "native" DB
        (or `point_read_batched` off) serves through the native per-key
        path.

        doc_key_lens: optional per-key DocKey prefix lengths (the bloom
        probe's filter keys); callers that built the keys pass them to
        skip per-key host parsing."""
        keys = list(keys)
        read_ht = read_ht or HybridTime.kMax
        if not keys:
            return []
        if self._device is not None and flags.get_flag("point_read_batched"):
            return self._multi_get_device(keys, read_ht, doc_key_lens)
        return self._multi_get_native(keys, read_ht)

    def _multi_get_native(self, keys, read_ht):
        """One native multi_get per key over a single reader-set snapshot
        (storage/native_read.py), memtable probes in Python — the loop
        body of _get_inner without the per-call snapshot overhead."""
        mems = self._mem_snapshot()
        rset = self._native_rset()
        if rset is None:
            return [self._get_inner(k, read_ht) for k in keys]
        mems = [m for m in mems if not m.empty]
        sst_hits = (rset.multi_get_many(keys, read_ht.value)
                    if rset.n else [None] * len(keys))
        mem_hits = self._mem_probe_many(mems, keys, read_ht)
        out = []
        for sh, best in zip(sst_hits, mem_hits):
            if sh is not None:
                ht_v, wid, _fl, val = sh
                if best is None or (ht_v, wid) > best[:2]:
                    best = (ht_v, wid, val)
            out.append(None if best is None else
                       (DocHybridTime(HybridTime(best[0]), best[1]),
                        best[2]))
        return out

    @staticmethod
    def _mem_probe_many(mems, keys, read_ht):
        """Newest memtable candidate per key as (ht_value, wid, value),
        via each memtable's batched probe (one lock acquisition per
        memtable)."""
        if not mems:
            return [None] * len(keys)
        probes = [(make_internal_key(k, DocHybridTime(read_ht, 0xFFFFFFFF)),
                   k + bytes([ValueType.kHybridTime])) for k in keys]
        best = [None] * len(keys)
        for mem in mems:
            for i, hit in enumerate(mem.point_get_many(probes)):
                if hit is None:
                    continue
                _, dht = split_key_and_ht(hit[0])
                cand = (dht.ht.value, dht.write_id, hit[1])
                if best[i] is None or cand[:2] > best[i][:2]:
                    best[i] = cand
        return best

    def _stage_live(self, readers):
        """(file id, reader, staged cols) of every non-empty live file,
        staging a file on a miss (write-through: the next batch finds it
        resident). A resident entry whose n differs from its file's is
        stale: it is dropped and the file staged anew."""
        staged_by = []
        for fid, r in readers:
            if r.props.n_entries == 0:
                continue
            st = self._device_cache.get(fid)
            if st is not None and st.n != r.props.n_entries:
                self._device_cache.drop(fid)
                st = None
            if st is None:
                st = self._device_cache.stage(fid, r.read_all(),
                                              for_read=True)
            staged_by.append((fid, r, st))
        return staged_by

    def _multi_get_device(self, keys, read_ht, doc_key_lens=None):
        """The batched device path. A kernel error propagates (the
        reference's health-board gate and fault containment are ROADMAP
        queue A: health-board routing and device-fault containment)."""
        # memtable snapshot BEFORE the reader set (see _get_inner)
        with self._lock:
            mems = [self.mem] + ([self._imm] if self._imm is not None
                                 else [])
            readers = list(self._readers.items())
            for fid, _ in readers:
                self._pins[fid] = self._pins.get(fid, 0) + 1
        try:
            staged_by = self._stage_live(readers)
            results: List = [None] * len(keys)
            mems = [m for m in mems if not m.empty]
            for start in range(0, len(keys), _CHUNK):
                chunk = keys[start: start + _CHUNK]
                dkls = (doc_key_lens[start: start + _CHUNK]
                        if doc_key_lens is not None else None)
                best = self._device_chunk(chunk, dkls, read_ht, staged_by)
                mem_hits = self._mem_probe_many(mems, chunk, read_ht)
                self._combine_device_chunk(chunk, start, mem_hits,
                                           staged_by, best, results)
            return results
        finally:
            with self._lock:
                for fid, _ in readers:
                    self._pins[fid] -= 1
                    if not self._pins[fid]:
                        del self._pins[fid]
                self._purge_obsolete_unlocked()

    def _device_chunk(self, chunk, dkls, read_ht, staged_by):
        """One chunk through the kernels: P1 + P2 over every live SST
        (each file hashes the doc-key prefixes and probes its bloom; a
        file whose bloom rejects every key is not located), then P3 with
        the newest (ht, wid) hit kept per key, one launch each, and one
        download; no launch without a live SST. Returns None when no file
        was located, else arrays (ht u64, wid u32, row, file index, hit)."""
        from yugabyte_tpu_torch.ops import point_read
        point_read.count("batches")
        point_read.count("keys", len(chunk))
        table = self._file_table(staged_by)
        if not table.files:
            return None
        hw, dk, qbuf, ql = self._pack_chunk(chunk, dkls, table)
        b, b_pad = len(chunk), ql.shape[0]
        _maybe, located, _h1, _h2 = point_read.hash_probe_files(hw, dk,
                                                                table, b)
        model_on = flags.get_flag("point_read_learned_index")
        out = point_read.locate_fold(table, qbuf, ql, b, read_ht.value >> 32,
                                     read_ht.value & 0xFFFFFFFF, model_on,
                                     located)
        best, located, misses = point_read.fold_arrays(
            out.cpu().numpy(), b_pad, len(table.files))
        point_read.count("bloom_skips", int((~located).sum()))
        if model_on:
            point_read.count("learned_hits", sum(
                1 for f, loc in zip(table.files, located)
                if loc and f.model is not None))
            point_read.count("learned_fallbacks", int(misses.sum()))
        return best if located.any() else None

    def _file_table(self, staged_by):
        """The reader set's FileTable (ops/point_read.py), rebuilt only
        when a live file or its staged matrix changed."""
        from yugabyte_tpu_torch.ops import point_read
        cached = self._point_table
        if cached is not None and len(cached[0]) == len(staged_by) and all(
                a[1] is b[1] and a[2] is b[2]
                for a, b in zip(cached[0], staged_by)):
            return cached[1]
        table = point_read.file_table(staged_by, self._device_cache.device)
        self._point_table = (list(staged_by), table)
        return table

    def _pack_chunk(self, chunk, dkls, table):
        """The host half of a chunk in one upload: the padded doc-key
        prefixes and their lengths (the hash's operands), the queries of
        every key width of the live files and their true lengths (P3's).
        Returns (hash words [b_pad, w], doc-key lengths, query buffer,
        query lengths), views of one device buffer."""
        from yugabyte_tpu_torch.ops import point_read
        from yugabyte_tpu_torch.ops.run_merge import quantize_width
        from yugabyte_tpu_torch.ops.slabs import _doc_key_len
        if dkls is None:
            dkls = [_doc_key_len(k) for k in chunk]
        w_hash = quantize_width(max(1, -(-max(dkls) // 4)))
        hw, _hl = point_read.pack_query_batch(chunk, w_hash)
        b_pad = len(hw)
        dk = np.zeros(b_pad, dtype=np.int32)
        dk[:len(chunk)] = dkls
        qbuf, ql = table.queries(chunk)
        host = np.concatenate([hw.reshape(-1), dk.view(np.uint32),
                               ql.view(np.uint32), qbuf])
        buf = point_read.to_device(host, self._device_cache.device)
        n_hw = hw.size
        return (buf[:n_hw].view(b_pad, w_hash),
                buf[n_hw:n_hw + b_pad], buf[n_hw + 2 * b_pad:],
                buf[n_hw + b_pad:n_hw + 2 * b_pad])

    def _combine_device_chunk(self, chunk, start, mem_hits, staged_by, best,
                              results):
        """Merge the device SST winners with the host memtable candidates
        per key — newest (ht, wid) wins, exactly get()'s compare — and
        fetch the winning SST values."""
        for i in range(len(chunk)):
            mem_best = mem_hits[i]
            if best is not None and best[4][i]:
                ht_v = int(best[0][i])
                wid_v = int(best[1][i])
                if mem_best is None or (ht_v, wid_v) > mem_best[:2]:
                    value = self._fetch_staged_value(
                        staged_by[int(best[3][i])], int(best[2][i]))
                    results[start + i] = (
                        DocHybridTime(HybridTime(ht_v), wid_v), value)
                    continue
            results[start + i] = (
                None if mem_best is None else
                (DocHybridTime(HybridTime(mem_best[0]), mem_best[1]),
                 mem_best[2]))

    @staticmethod
    def _fetch_staged_value(entry, row: int) -> bytes:
        """Value bytes of staged entry `row` (sorted order): decode only
        the winner's block (values never live on the device)."""
        _fid, r, _st = entry
        offs = getattr(r, "_row_offs_pr", None)
        if offs is None:
            offs = np.concatenate(
                ([0], np.cumsum([h[2] for h in r.block_handles])))
            r._row_offs_pr = offs
        blk = int(np.searchsorted(offs, row, side="right") - 1)
        slab = r.read_block(blk)
        j = row - int(offs[blk])
        return slab.values[int(slab.value_idx[j])]

    def iter_from(self, seek_internal_key: bytes = b"",
                  check_bloom_doc: Optional[bytes] = None
                  ) -> Iterator[Tuple[bytes, bytes]]:
        """Merged (internal_key, value) stream in memcmp order (the
        MergingIterator equivalent). SSTs stream through the native read
        engine when available, merged lazily with the memtable iterators;
        the Python heap merge remains the alternative and the oracle."""
        if check_bloom_doc is None and flags.get_flag("read_native"):
            from yugabyte_tpu_torch.storage import native_read
            if native_read.available():
                mems = self._mem_snapshot()
                rset = self._native_rset()
                if rset is not None:
                    prefix_seek, _ = split_key_and_ht(seek_internal_key)
                    scan = native_read.NativeScan(rset, lower=prefix_seek,
                                                  mode=2)
                    sources = [m.iter_from(seek_internal_key) for m in mems]
                    sources.append(
                        self._native_iter(scan, seek_internal_key))
                    return _dedup_ikeys(heapq.merge(*sources))
        with self._lock:
            sources = [self.mem.iter_from(seek_internal_key)]
            if self._imm is not None:
                sources.append(self._imm.iter_from(seek_internal_key))
            readers = list(self._readers.values())
        for r in readers:
            if check_bloom_doc is not None and \
                    not r.may_contain_doc(check_bloom_doc):
                continue
            sources.append(_sst_iter_from(r, seek_internal_key))
        return heapq.merge(*sources)

    @staticmethod
    def _native_iter(scan, seek_internal_key: bytes
                     ) -> Iterator[Tuple[bytes, bytes]]:
        """Adapt a mode-2 NativeScan to the iter_from contract. The native
        seek is by key PREFIX (any version); when the seek carried an HT
        suffix, drop the leading newer-version entries it excludes."""
        skipping = bool(seek_internal_key)
        for batch in scan.batches():
            koffs, voffs = batch.key_offs, batch.val_offs
            keys, vals = batch.keys, batch.vals
            for i in range(batch.n):
                ikey = keys[koffs[i]: koffs[i + 1]].tobytes()
                if skipping:
                    if ikey < seek_internal_key:
                        continue
                    skipping = False
                yield ikey, vals[voffs[i]: voffs[i + 1]].tobytes()

    # ------------------------------------------------------- not ported yet
    def scan_visible(self, *args, **kwargs):
        raise _not_ported("scan_visible", _ENTRY_POINTS)

    def scan_filtered(self, *args, **kwargs):
        raise _not_ported("scan_filtered", _ENTRY_POINTS)

    def scan_aggregate(self, *args, **kwargs):
        raise _not_ported("scan_aggregate", _ENTRY_POINTS)

    def scan_native(self, *args, **kwargs):
        raise _not_ported("scan_native", _ENTRY_POINTS)

    def maybe_schedule_compaction(self) -> bool:
        raise _not_ported("maybe_schedule_compaction", _ENTRY_POINTS)

    def compact_all(self) -> None:
        raise _not_ported("compact_all", _ENTRY_POINTS)

    def retry_background_work(self) -> bool:
        raise _not_ported("retry_background_work", _HEALTH)

    def scrub(self, *args, **kwargs) -> dict:
        raise _not_ported("scrub", _SHADOW)

    def checkpoint(self, out_dir: str) -> None:
        raise _not_ported("checkpoint", _ENTRY_POINTS)

    # ------------------------------------------------------------ lifecycle
    def _drop_cached(self, fid: int) -> None:
        """Drop a file's entries from both caches (its file is gone or
        never installed)."""
        if self._device_cache is not None:
            self._device_cache.drop(fid)
        if self._run_cache is not None:
            self._run_cache.drop(fid)

    def _purge_obsolete_unlocked(self) -> None:
        for fid in [f for f in self._obsolete if not self._pins.get(f)]:
            r = self._obsolete.pop(fid)
            r.close()
            _delete_sst_files(r.base_path)
            self._drop_cached(fid)

    def close(self) -> None:
        with self._lock:
            # native handles free via refcount (in-flight reads may still
            # hold the snapshot)
            self._native_readers = {}
            self._rset = None
            self._rset_gen += 1
            self._purge_obsolete_unlocked()
            for r in self._obsolete.values():
                r.close()  # still pinned: close the handle, leave the files
            self._obsolete.clear()
            for r in self._readers.values():
                r.close()
            self._readers.clear()
            if self._device_cache is not None and \
                    hasattr(self._device_cache, "drop_all"):
                self._device_cache.drop_all()  # free this DB's residency
            if self._run_cache is not None:
                self._run_cache.drop_all()

    @property
    def n_live_files(self) -> int:
        return len(self.versions.files)


def _dedup_ikeys(stream: Iterator[Tuple[bytes, bytes]]
                 ) -> Iterator[Tuple[bytes, bytes]]:
    """Suppress adjacent duplicate internal keys: a flush racing the
    memtable snapshot can surface one row from both the memtable and the
    fresh SST; legitimate data never repeats a full internal key."""
    prev = None
    for kv in stream:
        if kv[0] == prev:
            continue
        prev = kv[0]
        yield kv


def _sst_iter_from(reader: SSTReader, seek: bytes
                   ) -> Iterator[Tuple[bytes, bytes]]:
    """Merged-stream source over one SST from `seek` (internal-key order).
    The first block is entered by binary search on the reconstructed
    internal keys (ref: rocksdb/table/block.cc Seek)."""
    prefix_seek, _ = split_key_and_ht(seek)
    b = reader.seek_block(prefix_seek if prefix_seek else seek)
    # the block index is on key PREFIXES while seek carries the HT
    # suffix, so a version chain spilling across blocks can leave whole
    # candidate blocks below seek: search until a block holds an entry
    while b < reader.n_blocks:
        slab = reader.read_block(b)
        raw = slab.key_words.astype(">u4").tobytes()
        stride = slab.width_words * 4

        def ikey(i: int) -> bytes:
            kp = raw[i * stride: i * stride + int(slab.key_len[i])]
            return make_internal_key(kp, slab.doc_ht(i))

        lo, hi = 0, slab.n
        while lo < hi:
            mid = (lo + hi) // 2
            if ikey(mid) < seek:
                lo = mid + 1
            else:
                hi = mid
        b += 1
        if lo < slab.n:
            for i in range(lo, slab.n):
                yield ikey(i), slab.values[int(slab.value_idx[i])]
            break
    # every later block is entirely >= seek
    for kp, dht, value, _fl in reader.iter_entries(b):
        yield make_internal_key(kp, dht), value


def _delete_sst_files(base_path: str) -> None:
    for p in (base_path, data_file_name(base_path)):
        try:
            os.remove(p)
        except FileNotFoundError:
            pass
