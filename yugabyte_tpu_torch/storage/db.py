"""DB: the LSM storage engine facade.

Counterpart of yugabyte_tpu/storage/db.py (ref: src/yb/rocksdb/db/
db_impl.cc): WAL-less writes into the memtable, flush to L0 SSTs, bulk
ingest of packed runs, manifest recovery, universal compaction that the
DB schedules itself, checkpoints, and the reads: `get` (native per-key
engine, or the Python merged iterator), `iter_from`, the batched
`multi_get`, the native streaming scan `scan_native` and the device
scans `scan_visible`, `scan_filtered` and `scan_aggregate`. On a DB
with a device (and its `DeviceSlabCache`), `multi_get` resolves the SST
half of each 1024-key chunk on the card (ops/point_read.py: kernels P1
hash, P2 bloom probe and P3 locate + gather over the resident staged
cols; the learned per-SST index seeds P3 when the file carries one)
while the memtable probes and the winners' value fetch stay on the
host. Its answers are byte-identical to
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

Compaction, as the JAX DB schedules it (db.py:1322-1485 there): with
`auto_compact` (the default) every flush, ingest and successful retry
calls `maybe_schedule_compaction`, which asks `compaction.pick_universal`
for a pick and runs it inline, or on `DBOptions.compaction_pool` (a
utils.threadpool.PriorityThreadPool). `_dispatch_compaction` sends a
picked job to `DBOptions.mesh_pool` (tserver/compaction_pool.
CompactionPool: one slot of a pooled wave, kernels A + B) where the board
(`offload_policy`) would send it to the device anyway, else runs
`compaction.run_compaction_job` on the DB's device (the device-native
job: kernels A-F, H and the resident chain's D/E and P4 through the
device cache; M1-M3 through `DBOptions.mesh` at mesh size). The install
swaps the inputs for the outputs in the version set, drops the inputs'
cache entries, and defers the close and delete of an input a scan still
pins. `compact_all` runs a major compaction of every live file.
`close()` and `cancel_background_work` trip the DB's cancellation token
first: an in-flight job aborts at its next stage boundary, unwinds, and
the DB sweeps any orphan output (never a file a writer still owns) and
stays healthy. `checkpoint` hard-links the live files and copies the
MANIFEST.

The scans pin their input files for the generator's life:
`scan_visible` resolves MVCC visibility over the memtables and every SST
on the device (ops/scan.py: kernels G, H, I.1, B, and I.2 for a bounded
scan), an SST the device cache holds as a ResidentSource (no decode to
stage it), a miss staged into the cache; `scan_filtered` /
`scan_aggregate` run the query pushdown (kernels J and K beside them).
A "native" DB resolves `scan_visible` on the host (the native merge in
snapshot shape) and refuses the pushdown (PushdownUnsupported("native"):
the caller serves the query on its host path).

Containment, as in the JAX package:

  - `_multi_get_device` gates every batch on the health board's
    point_read_locate (1, n_pad) record of each live file (a parked
    bucket serves the batch natively) and contains a device fault
    mid-batch: the bucket is parked (the first live file's, the file the
    JAX loop locates first), the fallback counted and TRACEd, and the
    batch served by `_multi_get_native`, byte-identical. A stale resident
    entry is still restaged (ROADMAP C.3): the native path is for device
    faults only.
  - The background-error slot (`background_error`,
    `on_background_error`, `retry_background_work`): a failed flush
    (OSError / StatusError) restores the memtable and parks the DB
    read-only — writes refuse retryably, reads serve the installed
    state — until a retry flushes; a Corruption park is sticky.
  - Read-corruption routing: a `get` or `multi_get` that hits corrupt
    SST bytes parks the DB with a sticky Corruption and re-raises
    ServiceUnavailable (retry on a healthy replica).
  - `scrub`: every live SST deep-verified (storage/integrity.verify_sst)
    at a throttled rate and checked against `cancel` between files, a
    corrupt one quarantined (`*.corrupt`) and the DB parked with a sticky
    Corruption.
  - A failed compaction (OSError / StatusError) sweeps its orphan
    outputs and parks the DB like a failed flush (a Corruption sticky); a
    cancelled one (OperationCancelled) sweeps and does not park.
  - Read-corruption routing covers the scans: a corrupt block met while
    staging or streaming parks the DB and re-raises ServiceUnavailable.

The tablet's entry points (tablet/tablet.py, as the JAX DB's
db.py:229-300 and :1238-1239 there): `pre_flush_hook` runs after the
memtable swap and before the new SST is written (the tablet points the
intents DB's hook at the regular DB's flush, so the intents' flushed
frontier never persists ahead of the regular DB's); `memstore_bytes`,
`oldest_memstore_write_s`, `approx_entry_count` (the intent overlay's
emptiness probe), `approx_row_entries` (the pushdown's size gate),
`has_deep_files` and `mem_entries_range` (the batched row read's gates).

`DBOptions(device=..., device_cache=None, own_cache=False)` is the JAX
DB's device without a cache (the tablet's intents DB): compactions run
on the device (the device-native job without residency), while
`multi_get` reads natively and the scans stage nothing.
"""

from __future__ import annotations

import heapq
import os
import threading
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime, HybridTime
from yugabyte_tpu_torch.docdb.doc_key import split_key_and_ht
from yugabyte_tpu_torch.docdb.value_type import ValueType
from yugabyte_tpu_torch.storage.memtable import (MemTable, make_internal_key,
                                                 new_memtable)
from yugabyte_tpu_torch.storage.sst import (
    BlockCache, Frontier, SSTReader, SSTWriter, data_file_name)
from yugabyte_tpu_torch.storage import compaction as compaction_mod
from yugabyte_tpu_torch.storage.version_set import VersionSet
from yugabyte_tpu_torch.utils import flags, lock_rank, sync_point, torch_setup
from yugabyte_tpu_torch.utils.cancellation import (CancellationToken,
                                                   OperationCancelled)
from yugabyte_tpu_torch.utils.status import Code, Status, StatusError
from yugabyte_tpu_torch.utils.threadpool import PriorityThreadPool
from yugabyte_tpu_torch.utils.trace import TRACE

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

_OVERLAY_TOO_BIG = object()  # sentinel: memtable too large to repack


class CompactionStats:
    """Per-DB compaction and flush accounting (ref: rocksdb/db/
    internal_stats.cc). Running write amplification is (flush bytes +
    compaction bytes written) / flush bytes."""

    def __init__(self):
        self._lock = threading.Lock()
        self.flushes = 0
        self.flush_bytes_written = 0
        self.flush_rows = 0
        self.compactions = 0
        self.compaction_bytes_read = 0
        self.compaction_bytes_written = 0
        self.compaction_files_in = 0
        self.compaction_files_out = 0
        self.compaction_rows_in = 0
        self.compaction_rows_out = 0
        self.versions_gcd = 0          # input entries dropped by MVCC GC
        self.tombstones_written = 0    # TTL expiries rewritten as tombstones

    def record_flush(self, nbytes: int, rows: int) -> None:
        with self._lock:
            self.flushes += 1
            self.flush_bytes_written += nbytes
            self.flush_rows += rows

    def record_compaction(self, bytes_read: int, bytes_written: int,
                          files_in: int, files_out: int,
                          rows_in: int, rows_out: int,
                          tombstones_written: int = 0) -> None:
        with self._lock:
            self.compactions += 1
            self.compaction_bytes_read += bytes_read
            self.compaction_bytes_written += bytes_written
            self.compaction_files_in += files_in
            self.compaction_files_out += files_out
            self.compaction_rows_in += rows_in
            self.compaction_rows_out += rows_out
            self.versions_gcd += max(0, rows_in - rows_out)
            self.tombstones_written += tombstones_written

    def to_dict(self) -> dict:
        with self._lock:
            ingested = self.flush_bytes_written
            write_amp = ((ingested + self.compaction_bytes_written)
                         / ingested if ingested else 0.0)
            return {
                "flushes": self.flushes,
                "flush_bytes_written": self.flush_bytes_written,
                "flush_rows": self.flush_rows,
                "compactions": self.compactions,
                "compaction_bytes_read": self.compaction_bytes_read,
                "compaction_bytes_written": self.compaction_bytes_written,
                "compaction_files_in": self.compaction_files_in,
                "compaction_files_out": self.compaction_files_out,
                "compaction_rows_in": self.compaction_rows_in,
                "compaction_rows_out": self.compaction_rows_out,
                "versions_gcd": self.versions_gcd,
                "tombstones_written": self.tombstones_written,
                "write_amplification": round(write_amp, 3),
            }


@dataclass
class DBOptions:
    block_entries: Optional[int] = None
    block_cache: Optional[BlockCache] = None
    # runs the DB's scheduled compactions (None: inline on the caller)
    compaction_pool: Optional[PriorityThreadPool] = None
    # device of the DB's kernels: None = "cuda", "cpu" only when asked,
    # "native" = no device path (and no device cache)
    device: object = None
    # parallel.mesh.Mesh of more than one shard: mesh-sized compactions
    # fan their subcompactions across it (parallel/dist_compact.py)
    mesh: object = None
    # tserver/compaction_pool.CompactionPool: device-routed compactions
    # ride its pooled waves (or whole-mesh jobs) instead of running
    # inline on this DB's compaction thread
    mesh_pool: object = None
    # the bucket-health board (storage/bucket_health.health_board()):
    # routes each job device or native by the measured rates
    offload_policy: object = None
    # device-resident slab cache (storage/device_cache.py); shared across
    # DBs like the reference's server-wide block cache
    device_cache: object = None
    # returns the current history cutoff HT value (ref:
    # tablet_retention_policy.h:29)
    retention_policy: Callable[[], int] = lambda: 0
    memstore_size_bytes: Optional[int] = None
    auto_compact: bool = True
    # a DB with a device and no device_cache makes its own cache; False
    # keeps it without one, as the JAX DB given a device and no cache:
    # compactions on the device, point reads native, scans unstaged
    own_cache: bool = True


class DB:
    def __init__(self, db_dir: str, options: Optional[DBOptions] = None):
        self.db_dir = db_dir
        self.opts = options or DBOptions()
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
            if cache is None and self.opts.own_cache:
                cache = DeviceSlabCache(self._device)
            if cache is not None and cache.device.type != self._device.type:
                raise ValueError(
                    f"DBOptions.device {self._device} differs from the "
                    f"device cache's {cache.device}")
            # namespace file ids per DB under the shared server-wide cache
            self._device_cache = (
                NamespacedSlabCache(cache, os.path.abspath(db_dir))
                if isinstance(cache, DeviceSlabCache) else cache)
        # runs after the memtable swap, before this DB's SST is written:
        # the tablet points the intents DB's hook at the regular DB's
        # flush, so the intents' flushed frontier never persists ahead of
        # the regular DB's for ops spanning both (bootstrap replays from
        # the min frontier)
        self.pre_flush_hook: Optional[Callable[[], None]] = None
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
        self.compaction_stats = CompactionStats()
        self.versions = VersionSet(db_dir)
        self.versions.recover()
        self.mem = new_memtable()
        self._imm: Optional[MemTable] = None   # guarded-by: _lock
        self._readers: dict = {}
        self._lock = lock_rank.tracked(threading.RLock(), "db._lock")
        self._compacting = False  # guarded-by: _lock
        self._closed = False      # guarded-by: _lock
        self._writing: set = set()  # SST paths mid-write (orphan-sweep guard)
        # the cancellation seam of in-flight background work: close() and
        # cancel_background_work trip it, and the compaction job checks it
        # at every stage boundary (it unwinds; nothing is installed)
        self._cancel = CancellationToken(f"compaction@{db_dir}")
        self._pins: dict = {}       # file_id -> active read count
        self._obsolete: dict = {}   # file_id -> reader awaiting unpin+delete
        self._last_op_id: Tuple[int, int] = (0, 0)
        # RocksDB-style background-error slot (ref: db_impl.cc
        # error_handler_): a failed flush parks the DB in degraded
        # read-only mode — writes reject retryably, reads keep serving the
        # installed state — until retry_background_work() clears it. The
        # hook tells the owner (a tablet peer) to fail the tablet.
        self._bg_error: Optional[Status] = None
        self.on_background_error: Optional[Callable[[object], None]] = None
        # native read engine state: per-SST native handles + a frozen
        # ReaderSet snapshot, both rebuilt when the live-file set changes
        self._native_readers: dict = {}
        self._rset = None
        self._rset_gen = 0  # bumped on every invalidation: a ReaderSet
        #                     built against gen G installs only if still G
        # (memtable versions, packed overlay) of the last native scan
        self._mem_run_cache: Optional[Tuple[tuple, object]] = None
        for fm in self.versions.live_files():
            self._readers[fm.file_id] = SSTReader(fm.path,
                                                  self.opts.block_cache)

    # ------------------------------------------------- the tablet's probes
    def memstore_bytes(self) -> int:
        """Mutable + flushing memtable bytes (global-memstore arbitration)."""
        with self._lock:
            total = self.mem.approximate_bytes
            if self._imm is not None:
                total += self._imm.approximate_bytes
            return total

    def oldest_memstore_write_s(self) -> Optional[float]:
        with self._lock:
            times = [self.mem.oldest_write_s]
            if self._imm is not None:
                times.append(self._imm.oldest_write_s)
        times = [t for t in times if t is not None]
        return min(times) if times else None

    def approx_entry_count(self) -> int:
        """Cheap emptiness probe (the tablet skips the intent overlay on
        an empty intents DB). Zero means definitely empty."""
        with self._lock:
            if self.mem.approximate_bytes or self._imm is not None:
                return 1
            return len(self._readers)

    def approx_row_entries(self) -> int:
        """Rough live-entry count (SST props + ~32 bytes an entry of the
        memtables): the pushdown's size gate."""
        with self._lock:
            n = sum(r.props.n_entries for r in self._readers.values())
            n += self.mem.approximate_bytes // 32
            if self._imm is not None:
                n += self._imm.approximate_bytes // 32
            return n

    def has_deep_files(self) -> bool:
        """Any live SST holding documents deeper than row + column: the
        tablet's gate of the batched row read (deep rows cannot be
        rebuilt from probes of the enumerated schema columns)."""
        with self._lock:
            return any(r.props.has_deep for r in self._readers.values())

    def mem_entries_range(self, lower: bytes, upper: bytes
                          ) -> List[Tuple[bytes, bytes]]:
        """Memtable (+ the flushing one) entries with lower <= internal
        key < upper: the batched row read's host probe for recent writes
        off the enumerated key set."""
        with self._lock:
            mems = [self.mem] + ([self._imm] if self._imm is not None
                                 else [])
        out: List[Tuple[bytes, bytes]] = []
        for m in mems:
            out.extend(m.entries_range(lower, upper))
        return out

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
        self._require_writable()
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
        self._require_writable()
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
        self._require_writable()
        n = len(key_offs) - 1
        if n == 0:
            return None
        with self._lock:
            fid = self.versions.new_file_id()
            self._last_op_id = max(self._last_op_id, op_id)
            path = os.path.join(self.db_dir, f"{fid:06d}.sst")
            # a failed compaction's orphan sweep must spare this file
            # until the version set lists it
            self._writing.add(path)
        frontier = Frontier(op_id_min=op_id, op_id_max=op_id,
                            history_cutoff=0)
        try:
            props = write_sst_from_packed(
                path, keys_blob, key_offs, ht, wid, vals_blob, val_offs,
                frontier=frontier, block_entries=self.opts.block_entries)
            with self._lock:
                self.versions.add_file(fid, path, props)
                self._readers[fid] = SSTReader(path, self.opts.block_cache)
                self._rset = None
                self._rset_gen += 1
        finally:
            with self._lock:
                self._writing.discard(path)
        if self.opts.auto_compact:
            self.maybe_schedule_compaction()
        return fid

    def flush(self) -> Optional[int]:
        """Memtable -> L0 SST (ref: db/flush_job.cc), with write-through
        of the new file's key columns to the device cache.

        The lock is held only to swap the memtable and to install the
        result; the SST write runs unlocked while reads serve from the
        immutable memtable. On failure the un-flushed entries go back
        into the live memtable and partial outputs are removed; an
        OSError or StatusError then parks the DB (the background-error
        slot; retry_background_work re-drives the flush) and returns
        None, as the JAX flush does; any other error propagates.
        """
        with self._lock:
            if self._imm is not None:
                return None  # a flush is already in progress
            if self._bg_error is not None:
                return None  # parked: retry_background_work re-drives
            if self.mem.empty:
                return None
            self._imm, self.mem = self.mem, new_memtable()
            imm = self._imm
            last_op = self._last_op_id
        fid = path = None
        try:
            if self.pre_flush_hook is not None:
                self.pre_flush_hook()
            fid = self.versions.new_file_id()
            path = os.path.join(self.db_dir, f"{fid:06d}.sst")
            with self._lock:
                self._writing.add(path)
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
                n_flushed = len(packed[1]) - 1
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
                n_flushed = slab.n
            sync_point.hit("db.flush:before_manifest")
            if self._device_cache is not None and slab is not None:
                self._device_cache.stage(fid, slab)  # write-through
            with self._lock:
                self.versions.add_file(fid, path, props)
                self.versions.set_flushed_frontier(frontier)
                self._readers[fid] = SSTReader(path, self.opts.block_cache)
                self._imm = None
                self._rset = None  # native snapshot is stale
                self._rset_gen += 1
                self._mem_run_cache = None
            self.compaction_stats.record_flush(
                props.data_size + props.base_size, n_flushed)
            TRACE("flushed %d entries to %s", n_flushed, path)
        except BaseException as e:
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
            if isinstance(e, (OSError, StatusError)):
                # contained: the version set untouched, no rows lost (the
                # memtable restored); park read-only until a retry
                self._set_background_error("flush", e)
                return None
            raise
        finally:
            if path is not None:
                with self._lock:
                    self._writing.discard(path)
        if self.opts.auto_compact:
            self.maybe_schedule_compaction()
        return fid

    # ------------------------------------------------------- background error
    @property
    def background_error(self):
        """The parked Status, or None when healthy."""
        return self._bg_error

    def _require_writable(self) -> None:
        err = self._bg_error
        if err is not None:
            raise StatusError(Status.ServiceUnavailable(
                f"DB {self.db_dir} is read-only after a background error "
                f"({err}); retry later"))

    def _set_background_error(self, where: str, exc: BaseException,
                              corruption: bool = False) -> None:
        if corruption:
            st = Status.Corruption(
                f"{where} detected corrupt data in {self.db_dir}: {exc}")
        else:
            st = Status.IoError(f"{where} failed in {self.db_dir}: {exc}")
        with self._lock:
            if self._bg_error is not None:
                # first error wins — except corruption, which UPGRADES a
                # retryable I/O park: lost bytes need a rebuild, and the
                # sticky corruption code is what blocks in-place retry
                if not corruption or \
                        self._bg_error.code == Code.CORRUPTION:
                    return
            self._bg_error = st
        TRACE("db %s: background error (%s): %s", self.db_dir, where, exc)
        cb = self.on_background_error
        if cb is not None:
            cb(st)

    def cancel_background_work(self, reason: str = "shutdown") -> None:
        """Abort in-flight background compactions at their next stage
        boundary (tablet-FAILED transition, shutdown). One-way until
        retry_background_work re-arms a fresh token."""
        self._cancel.cancel(reason)

    def retry_background_work(self) -> bool:
        """Clear the parked error and retry the failed work (ref
        DBImpl::Resume). Returns True when the DB is healthy again; a
        failing retry re-parks it. A CORRUPTION error is STICKY: lost
        bytes cannot be retried back into existence — the replica must
        be rebuilt from a healthy peer. A tripped cancellation token is
        replaced by a fresh one (unless the DB is closed)."""
        with self._lock:
            if self._bg_error is not None \
                    and self._bg_error.code == Code.CORRUPTION:
                return False
            if self._cancel.cancelled and not self._closed:
                # the old token is tripped for good: the retried work
                # gets a fresh one
                self._cancel = CancellationToken(
                    f"compaction@{self.db_dir}")
            if self._bg_error is None:
                return True
            self._bg_error = None
        try:
            self.flush()
        except (OSError, StatusError):
            return False  # flush's failure path re-set the background error
        if self.opts.auto_compact:
            self.maybe_schedule_compaction()
        return self._bg_error is None

    def _sweep_orphan_outputs_unlocked(self) -> None:
        """Remove SST files on disk that no version references and no
        in-flight writer owns — the partial outputs of a failed or
        cancelled flush/compaction (ref: PurgeObsoleteFiles)."""
        try:
            names = os.listdir(self.db_dir)
        except OSError as e:
            TRACE("db %s: orphan sweep cannot list dir: %s",
                  self.db_dir, e)
            return
        live = set(self.versions.files)
        writing = {os.path.basename(p) for p in self._writing}
        for name in names:
            stem = name.split(".", 1)[0]
            if not (name.endswith(".sst") or name.endswith(".sblock.0")) \
                    or not stem.isdigit():
                continue
            if int(stem) in live or stem + ".sst" in writing:
                continue
            try:
                os.remove(os.path.join(self.db_dir, name))
            except OSError as e:
                # a later sweep tries again; say so
                TRACE("db %s: orphan sweep cannot remove %s: %s",
                      self.db_dir, name, e)

    def _route_read_corruption(self, e: StatusError) -> None:
        """A read that hit corrupt SST bytes (block CRC / footer
        mismatch) must not surface as a raw Corruption to the client:
        route it to the background-error slot — parking the DB — and
        re-raise RETRYABLY so the client walks to a healthy replica."""
        if e.status.code != Code.CORRUPTION:
            return
        self._set_background_error("read", e, corruption=True)
        raise StatusError(Status.ServiceUnavailable(
            f"read hit corrupt SST data in {self.db_dir} "
            f"({e.status.message}); replica is being repaired — retry "
            f"on another replica")) from e

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
        try:
            return self._get_inner(key_prefix, read_ht)
        except StatusError as e:
            self._route_read_corruption(e)
            raise

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
        try:
            if self._device_cache is not None \
                    and flags.get_flag("point_read_batched"):
                out = self._multi_get_device(keys, read_ht, doc_key_lens)
                if out is not None:
                    return out
            return self._multi_get_native(keys, read_ht)
        except StatusError as e:
            self._route_read_corruption(e)
            raise

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
        """The batched device path, or None when this batch must take the
        native path (a parked shape bucket, or a device fault mid-batch:
        both byte-identical). Any other error propagates."""
        import time
        from yugabyte_tpu_torch.ops import device_faults, point_read
        from yugabyte_tpu_torch.storage.bucket_health import health_board
        from yugabyte_tpu_torch.storage.offload_policy import (
            point_read_bucket_key)
        # memtable snapshot BEFORE the reader set (see _get_inner)
        with self._lock:
            mems = [self.mem] + ([self._imm] if self._imm is not None
                                 else [])
            readers = list(self._readers.items())
            for fid, _ in readers:
                self._pins[fid] = self._pins.get(fid, 0) + 1
        try:
            staged_by = self._stage_live(readers)
            board = health_board()
            if any(not board.allow_device(
                    "point_read_locate", point_read_bucket_key(st.n_pad))
                   for _fid, _r, st in staged_by):
                return None
            results: List = [None] * len(keys)
            mems = [m for m in mems if not m.empty]
            t0 = time.monotonic()
            try:
                for start in range(0, len(keys), _CHUNK):
                    chunk = keys[start: start + _CHUNK]
                    dkls = (doc_key_lens[start: start + _CHUNK]
                            if doc_key_lens is not None else None)
                    best = self._device_chunk(chunk, dkls, read_ht,
                                              staged_by)
                    mem_hits = self._mem_probe_many(mems, chunk, read_ht)
                    self._combine_device_chunk(chunk, start, mem_hits,
                                               staged_by, best, results)
                if staged_by:
                    # the last live file's bucket, as the JAX loop's
                    # running bucket ends there
                    board.record_device(
                        "point_read_locate",
                        point_read_bucket_key(staged_by[-1][2].n_pad),
                        len(keys), time.monotonic() - t0)
            except Exception as e:  # noqa: BLE001 — device-fault containment
                if not device_faults.is_device_fault(e):
                    raise
                # park the bucket and serve this batch (and the window)
                # natively, byte-identical: the compaction fallback's twin
                n_pad = staged_by[0][2].n_pad
                board.record_fault(
                    "point_read_locate", point_read_bucket_key(n_pad),
                    reason=f"point-read {type(e).__name__}: {e}")
                point_read.point_read_metrics()[
                    "device_fallbacks"].increment()
                TRACE("multi_get: device fault mid-batch (%r) — shape "
                      "bucket (1, %d) quarantined; serving natively",
                      e, n_pad)
                return None
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
        import time
        from yugabyte_tpu_torch.ops import device_faults, point_read
        from yugabyte_tpu_torch.utils.metrics import record_kernel_dispatch
        m = point_read.point_read_metrics()
        m["batches"].increment()
        m["keys"].increment(len(chunk))
        m["batch_rows"].increment(len(chunk))
        table = self._file_table(staged_by)
        if not table.files:
            return None
        hw, dk, qbuf, ql = self._pack_chunk(chunk, dkls, table)
        b, b_pad = len(chunk), ql.shape[0]
        t0 = time.monotonic()
        _maybe, located, _h1, _h2 = point_read.hash_probe_files(hw, dk,
                                                                table, b)
        model_on = flags.get_flag("point_read_learned_index")
        # the JAX package's locate fault sites (point_read.py:478, :487
        # there), around the one locate launch and its download
        device_faults.maybe_fault("dispatch")
        out = point_read.locate_fold(table, qbuf, ql, b, read_ht.value >> 32,
                                     read_ht.value & 0xFFFFFFFF, model_on,
                                     located)
        device_faults.maybe_fault("result")
        best, located, misses = point_read.fold_arrays(
            out.cpu().numpy(), b_pad, len(table.files))
        record_kernel_dispatch("kernel_point_locate", b, b,
                               (time.monotonic() - t0) * 1e3)
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

    # ------------------------------------------------------- native scan
    def _memtable_run(self):
        """Packed memtable(+imm) overlay for native scans, cached per
        memtable version (repacking per scan would re-pay the per-entry
        packing on every read of a write-hot tablet)."""
        from yugabyte_tpu_torch.docdb.value import decode_control_fields
        from yugabyte_tpu_torch.storage.native_read import PackedRun
        with self._lock:
            mem, imm = self.mem, self._imm
        key = (id(mem), mem.version, id(imm),
               imm.version if imm is not None else -1)
        cached = self._mem_run_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        if mem.empty and (imm is None or imm.empty):
            run = None
        elif (mem.n_entries
              + (imm.n_entries if imm is not None else 0)) > 200_000:
            # write-hot tablet near its flush threshold: repacking the
            # whole memtable per scan costs more than the Python merge
            return _OVERLAY_TOO_BIG
        else:
            sources = [mem.iter_from(b"")]
            if imm is not None:
                sources.append(imm.iter_from(b""))
            entries = []
            for ikey, value in heapq.merge(*sources):
                prefix, dht = split_key_and_ht(ikey)
                fl = ttl = 0
                try:
                    _, ttl_ms, off = decode_control_fields(value)
                    tag = value[off] if off < len(value) else 0
                    if tag == ValueType.kTombstone:
                        fl |= 1
                    elif tag == ValueType.kObject:
                        fl |= 2
                    if ttl_ms is not None:
                        fl |= 4
                        ttl = ttl_ms
                except (IndexError, ValueError):
                    pass
                entries.append((prefix, dht.ht.value, dht.write_id, fl, ttl,
                                value))
            run = PackedRun(entries)
        self._mem_run_cache = (key, run)
        return run

    def scan_native(self, lower: bytes = b"", upper: Optional[bytes] = None,
                    read_ht_value: Optional[int] = None,
                    visible: bool = False, batch_rows: int = 65536,
                    internal_keys: bool = False):
        """Native streaming scan (storage/native_read.NativeScan) over the
        SSTs and the memtable overlay, or None when the native engine is
        unavailable (or the memtable is too large to repack).
        visible=True resolves MVCC visibility in C++; internal_keys=True
        emits full internal keys."""
        from yugabyte_tpu_torch.storage.native_read import NativeScan
        # overlay snapshot BEFORE the reader set (see _get_inner: double
        # coverage is safe, a hidden row is not)
        overlay = self._memtable_run()
        if overlay is _OVERLAY_TOO_BIG:
            return None
        rset = self._native_rset()
        if rset is None:
            return None
        mode = 1 if visible else (2 if internal_keys else 0)
        return NativeScan(
            rset, lower, upper,
            read_ht_value if read_ht_value is not None else (2**64 - 1),
            overlay=overlay, batch_rows=batch_rows, mode=mode)

    # -------------------------------------------------------- device scans
    def _pin_sources(self):
        """Snapshot the memtable slabs and the live readers, pinning every
        reader's file against a concurrent install's delete."""
        with self._lock:
            slabs = [self.mem.to_slab()]
            if self._imm is not None:
                slabs.append(self._imm.to_slab())
            readers = list(self._readers.items())
            for fid, _ in readers:
                self._pins[fid] = self._pins.get(fid, 0) + 1
        return slabs, readers

    def scan_visible(self, read_ht_value: int,
                     lower_key: Optional[bytes] = None,
                     upper_key: Optional[bytes] = None):
        """Yield (key_prefix, value_bytes, ht_value) of every entry
        visible at read_ht in [lower_key, upper_key), in key order.

        One device pass resolves merge + MVCC visibility + the range for
        every input (ops/scan.py): an SST the device cache holds enters as
        a ResidentSource (no block decode to stage it; only the blocks
        holding survivors are decoded), a miss is staged into the cache
        (write-through), the memtables as slabs. A "native" DB resolves
        the same answer on the host. The input files stay PINNED for the
        generator's life, so a concurrent compaction defers their delete
        (the reference's Version refcounting, ref: db/version_set.cc)."""
        from yugabyte_tpu_torch.ops.scan import (
            ResidentSource, SlabSource, _visible_entries_host,
            visible_entries_sources)
        slabs, readers = self._pin_sources()
        try:
            if self._device is None:
                yield from _visible_entries_host(
                    slabs + [self._read_all_contained(r)
                             for _fid, r in readers],
                    read_ht_value, lower_key, upper_key)
                return
            sources = [SlabSource(sl) for sl in slabs]
            cache = self._device_cache
            for fid, r in readers:
                st = cache.get(fid) if cache is not None else None
                if st is not None and st.n != r.props.n_entries:
                    cache.drop(fid)   # stale entry: restage
                    st = None
                if st is not None and not r.props.has_deep:
                    sources.append(ResidentSource(r, st))
                    continue
                sl = self._read_all_contained(r)
                if cache is not None and not r.props.has_deep:
                    st = self._device_cache.stage(fid, sl, for_read=True)
                    sources.append(SlabSource(sl, st))
                else:
                    sources.append(SlabSource(sl))
            try:
                yield from visible_entries_sources(
                    sources, read_ht_value, lower_key, upper_key,
                    device=self._device)
            except StatusError as e:
                # a resident source decodes survivor blocks lazily: a
                # corrupt block mid-stream takes the same containment
                self._route_read_corruption(e)
                raise
        finally:
            self._release_scan_pins(readers)

    # ----------------------------------------------------- query pushdown
    def _pushdown_sources(self, spec):
        """The pushdown's source list, with pins held and value words
        staged. Returns (sources, readers); the caller releases the pins
        (_release_scan_pins). Raises PushdownUnsupported("deep") on a
        deep-document file and ("native") on a DB without a device path,
        so the caller serves the query on its host path."""
        from yugabyte_tpu_torch.docdb.scan_spec import PushdownUnsupported
        from yugabyte_tpu_torch.ops.merge_gc import u32_to_device
        from yugabyte_tpu_torch.ops.scan import (ResidentSource, SlabSource,
                                                 pack_vals, pushdown_metrics)
        if self._device is None:
            raise PushdownUnsupported("native")
        slabs, readers = self._pin_sources()
        try:
            sources = [SlabSource(sl) for sl in slabs]
            for fid, r in readers:
                if r.props.has_deep:
                    raise PushdownUnsupported("deep")
                if self._device_cache is None:
                    sources.append(SlabSource(self._read_all_contained(r),
                                              sorted_source=True))
                    continue
                st = self._device_cache.get(fid)
                if st is not None and st.n != r.props.n_entries:
                    self._device_cache.drop(fid)   # stale entry: restage
                    st = None
                if st is None:
                    sl = self._read_all_contained(r)
                    st = self._device_cache.stage(
                        fid, sl, for_read=True,
                        include_vals=spec.needs_vals)
                    sources.append(ResidentSource(r, st))
                    continue
                if spec.needs_vals and st.vals_dev is None:
                    # resident cols without value words: decode once and
                    # attach; every later pushdown scan is resident
                    sl = self._read_all_contained(r)
                    self._device_cache.attach_vals(fid, u32_to_device(
                        pack_vals(sl, st.n_pad), self._device_cache.device))
                    pushdown_metrics()["vals_staged"].increment()
                sources.append(ResidentSource(r, st))
            return sources, readers
        except BaseException:
            self._release_scan_pins(readers)
            raise

    def _read_all_contained(self, r):
        try:
            return r.read_all()
        except StatusError as e:
            self._route_read_corruption(e)
            raise

    def _release_scan_pins(self, readers) -> None:
        with self._lock:
            for fid, _ in readers:
                self._pins[fid] -= 1
                if not self._pins[fid]:
                    del self._pins[fid]
            self._purge_obsolete_unlocked()

    def scan_filtered(self, read_ht_value: int, spec,
                      lower_key: Optional[bytes] = None,
                      upper_key: Optional[bytes] = None):
        """Filtered scan: the visible entries of exactly the rows that
        satisfy spec.predicates, resolved in one device pass over the
        resident matrices (ops/scan.filtered_entries_sources). The device
        work runs EAGERLY: a parked bucket or a device fault surfaces here
        as PushdownUnsupported with no row emitted and no pin held, so the
        caller can serve the same query on its host path."""
        from yugabyte_tpu_torch.ops.scan import (ResidentSource,
                                                 filtered_entries_sources,
                                                 pushdown_metrics)
        sources, readers = self._pushdown_sources(spec)
        try:
            it = filtered_entries_sources(
                sources, read_ht_value, spec, lower_key, upper_key,
                device=self._device)
        except BaseException:
            self._release_scan_pins(readers)
            raise

        def entries():
            try:
                yield from it
            except StatusError as e:
                # a corrupt winner block mid-stream: the plain scan's
                # containment
                self._route_read_corruption(e)
                raise
            finally:
                blocks = sum(s.decoded_blocks for s in sources
                             if isinstance(s, ResidentSource))
                pushdown_metrics()["blocks"].increment(max(blocks, 0))
                self._release_scan_pins(readers)

        return entries()

    def scan_aggregate(self, read_ht_value: int, spec,
                       lower_key: Optional[bytes] = None,
                       upper_key: Optional[bytes] = None) -> dict:
        """Aggregating scan: one device pass returns the aggregate partial
        of this DB's whole source set ({"rows", "cols"}), with exact MVCC
        visibility across the memtables and the SSTs."""
        from yugabyte_tpu_torch.ops.scan import aggregate_sources
        sources, readers = self._pushdown_sources(spec)
        try:
            return aggregate_sources(sources, read_ht_value, spec,
                                     lower_key, upper_key,
                                     device=self._device)
        finally:
            self._release_scan_pins(readers)

    # ------------------------------------------------------------ compaction
    def maybe_schedule_compaction(self) -> bool:
        """Pick and run (or queue on `compaction_pool`) one universal
        compaction; False when one is running, the DB is closed or
        parked, or nothing is due (ref: DBImpl::
        MaybeScheduleFlushOrCompaction db_impl.cc:2127)."""
        with self._lock:
            if self._compacting or self._closed or \
                    self._bg_error is not None:
                return False
            pick = compaction_mod.pick_universal(self.versions.live_files())
            if pick is None:
                return False
            self._compacting = True
            for fm in pick.inputs:
                fm.being_compacted = True
        if self.opts.compaction_pool is not None:
            self.opts.compaction_pool.submit(
                lambda: self._run_compaction(pick), priority=0)
        else:
            self._run_compaction(pick)
        return True

    def _run_compaction(self, pick) -> None:
        try:
            self._run_compaction_inner(pick)
        except BaseException as e:
            if isinstance(e, OperationCancelled):
                # a clean abort (shutdown / tablet failed): nothing was
                # installed and the job unwound its partials; sweep any
                # straggler, and do not park the DB — no storage fault
                with self._lock:
                    self._sweep_orphan_outputs_unlocked()
                TRACE("db %s: compaction aborted: %s", self.db_dir, e)
                return
            if not isinstance(e, (OSError, StatusError)):
                raise
            # contained like a failed flush: the version set still points
            # at the inputs, partial outputs are swept, and the DB parks
            # for the retry; a Corruption (a corrupt input block) parks
            # sticky
            with self._lock:
                self._sweep_orphan_outputs_unlocked()
            self._set_background_error(
                "compaction", e,
                corruption=isinstance(e, StatusError)
                and e.status.code == Code.CORRUPTION)

    def _run_compaction_inner(self, pick) -> None:
        try:
            inputs = [self._readers[fm.file_id] for fm in pick.inputs]
            cutoff = self.opts.retention_policy()
            # the job's own token: a retry_background_work that swaps in
            # a fresh one must not un-cancel this job
            token = self._cancel
            result = self._dispatch_compaction(pick, inputs, cutoff, token)
            sync_point.hit("db.compaction:before_install")
            if token.cancelled:
                # closed or cancelled as the job ended: install nothing
                # (the caller sweeps the files; their entries go here)
                for fid, _p, _props in result.outputs:
                    self._drop_cached(fid)
                token.check()
            with self._lock:
                removed = [fm.file_id for fm in pick.inputs]
                self.versions.install_compaction(
                    removed, [(fid, p, props)
                              for fid, p, props in result.outputs])
                self._rset = None  # native snapshot is stale
                self._rset_gen += 1
                for fid, path, props in result.outputs:
                    self._readers[fid] = SSTReader(path,
                                                   self.opts.block_cache)
                for fid in removed:
                    self._native_readers.pop(fid, None)
                    r = self._readers.pop(fid, None)
                    if r is not None:
                        if self._pins.get(fid):
                            # a scan still reads this SST: defer the
                            # close + delete until its pin drops
                            self._obsolete[fid] = r
                        else:
                            r.close()
                            _delete_sst_files(r.base_path)
                    # a resident scan holds its entry's tensors itself
                    self._drop_cached(fid)
            self.compaction_stats.record_compaction(
                bytes_read=sum(fm.total_size for fm in pick.inputs),
                bytes_written=sum(p.data_size + p.base_size
                                  for _fid, _path, p in result.outputs),
                files_in=len(pick.inputs), files_out=len(result.outputs),
                rows_in=result.rows_in, rows_out=result.rows_out,
                tombstones_written=result.tombstones_written)
            TRACE("compaction: %d files -> %d rows (%d in)",
                  len(pick.inputs), result.rows_out, result.rows_in)
        finally:
            with self._lock:
                self._compacting = False
                # on failure the inputs stay live: pickable again
                for fm in pick.inputs:
                    fm.being_compacted = False
                # reap deferred readers whose scans finished meanwhile
                self._purge_obsolete_unlocked()
        # cascade while still over the trigger
        if self.opts.auto_compact:
            self.maybe_schedule_compaction()

    def _dispatch_compaction(self, pick, inputs, cutoff, cancel):
        """Route one picked job: through the mesh pool when the DB has one
        AND the job would take the device path anyway (the board's
        decision, asked with probe=False: the pool thread that launches
        claims any probe slot itself; the pool is a scheduling choice,
        never a routing override), else `run_compaction_job` inline on the
        DB's device ("native" without one)."""
        pool = self.opts.mesh_pool
        ids = [fm.file_id for fm in pick.inputs]
        if pool is not None and self._device is not None:
            est = sum(r.props.n_entries for r in inputs)
            board = self.opts.offload_policy
            use = True
            if board is not None:
                from yugabyte_tpu_torch.ops.run_merge import packed_run_ns
                from yugabyte_tpu_torch.storage.offload_policy import (
                    bucket_key)
                cached = bool(self._device_cache is not None and all(
                    self._device_cache.contains(fid) for fid in ids))
                qkey = bucket_key(packed_run_ns(
                    [r.props.n_entries for r in inputs
                     if r.props.n_entries]))
                use = board.use_device("run_merge_fused", qkey,
                                       est_rows=est, cached=cached,
                                       probe=False)
            if use and not any(r.props.has_deep for r in inputs):
                return pool.submit_compaction(
                    self.db_dir, inputs=inputs, out_dir=self.db_dir,
                    new_file_id=self.versions.new_file_id,
                    history_cutoff_ht=cutoff, is_major=pick.is_major,
                    block_entries=self.opts.block_entries, input_ids=ids,
                    device_cache=self._device_cache, est_rows=est,
                    cancel=cancel).result()
        return compaction_mod.run_compaction_job(
            inputs, self.db_dir, self.versions.new_file_id, cutoff,
            pick.is_major,
            device=self._device if self._device is not None else "native",
            block_entries=self.opts.block_entries,
            device_cache=self._device_cache, input_ids=ids,
            mesh=self.opts.mesh, offload_policy=self.opts.offload_policy,
            run_cache=self._run_cache, cancel=cancel)

    def compact_all(self) -> None:
        """Force a full (major) compaction of every live file."""
        with self._lock:
            files = [f for f in self.versions.live_files()
                     if not f.being_compacted]
            if len(files) < 2:
                return
            for fm in files:
                fm.being_compacted = True
            pick = compaction_mod.CompactionPick(files, is_major=True)
            self._compacting = True
        self._run_compaction(pick)

    # ------------------------------------------------------------------ scrub
    def scrub(self, limiter=None, cancel=None) -> dict:
        """At-rest integrity scrub: deep-verify every live SST (block
        CRCs, footer, index/bloom consistency — storage/integrity.py) at
        a throttled byte rate (`limiter`, a utils.rate_limiter
        .RateLimiter; integrity.scrub_rate_limiter() is the process-wide
        one). Files are PINNED while verified. A corrupt file is
        quarantined (renamed ``*.corrupt``) and the DB parks with a
        STICKY Corruption background error; in-place retry is refused.
        cancel (a CancellationToken) is checked before each file and
        inside verify_sst: a tripped token raises OperationCancelled,
        pins released."""
        from yugabyte_tpu_torch.storage import integrity
        with self._lock:
            targets = [(fid, r.base_path)
                       for fid, r in self._readers.items()]
            for fid, _ in targets:
                self._pins[fid] = self._pins.get(fid, 0) + 1
        report = {"files": 0, "blocks": 0, "entries": 0, "bytes": 0,
                  "corrupt": []}
        try:
            for fid, base_path in targets:
                if cancel is not None:
                    cancel.check()
                rep = integrity.verify_sst(base_path, limiter=limiter,
                                           cancel=cancel)
                report["files"] += 1
                report["blocks"] += rep.n_blocks
                report["entries"] += rep.n_entries
                report["bytes"] += rep.bytes_verified
                if rep.errors:
                    report["corrupt"].append(
                        {"path": base_path, "errors": rep.errors[:4]})
                    integrity.quarantine_sst(base_path,
                                             reason=rep.errors[0])
                    self._set_background_error(
                        "scrub",
                        StatusError(Status.Corruption(
                            f"{base_path}: {rep.errors[0]}")),
                        corruption=True)
        finally:
            with self._lock:
                for fid, _ in targets:
                    self._pins[fid] -= 1
                    if not self._pins[fid]:
                        del self._pins[fid]
                self._purge_obsolete_unlocked()
        integrity.record_scrub(report["files"], report["blocks"],
                               report["bytes"], len(report["corrupt"]))
        return report

    # ------------------------------------------------------------ checkpoint
    def checkpoint(self, out_dir: str) -> None:
        """Hard-link snapshot of the live files and a copy of the
        MANIFEST (ref: utilities/checkpoint/checkpoint.cc:56): a DB
        opened over out_dir answers as this one did."""
        import shutil
        os.makedirs(out_dir, exist_ok=True)
        with self._lock:
            for fm in self.versions.live_files():
                for p in (fm.path, data_file_name(fm.path)):
                    os.link(p, os.path.join(out_dir, os.path.basename(p)))
            if os.path.exists(self.versions.manifest_path):
                shutil.copy(self.versions.manifest_path,
                            os.path.join(out_dir, "MANIFEST"))

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
        # trip the cancellation seam FIRST: an in-flight compaction aborts
        # at its next stage boundary instead of writing into a directory
        # whose readers are about to close
        self._cancel.cancel("db closed")
        with self._lock:
            self._closed = True
            # native handles free via refcount (in-flight reads may still
            # hold the snapshot)
            self._native_readers = {}
            self._rset = None
            self._rset_gen += 1
            self._mem_run_cache = None
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
