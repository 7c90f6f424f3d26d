"""ctypes bindings for the native compaction shell (native/compaction_engine.cc).

The byte path of the compaction job (block decode, merge+GC, survivor
gather, block encode+write — ref: rocksdb/db/compaction_job.cc:442 and hot
loop #3 at :958-1024) runs in C++; Python keeps metadata authority: index
block, bloom filter and props assembly, frontier merge, VersionSet wiring.

Two modes share the engine:
  - full native: ce_job_merge runs the shared heap-merge + GC filter
    (native/merge_gc_core.h),
  - device decisions: the CUDA kernels' (perm, keep, mk) are injected via
    ce_job_append_survivors and the engine only materializes output bytes.

The library is built from the repository's unchanged native/*.cc into this
package's own build directory (utils/native_build.py).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

from yugabyte_tpu_torch.utils import flags

flags.define_flag("compaction_native_threads",
                  min(4, os.cpu_count() or 1),
                  "worker threads for native block decode/encode "
                  "(the reference runs multiple subcompaction threads, "
                  "compaction_job.cc:456-468); capped at the core count — "
                  "oversubscribing memory-bound encode threads on a "
                  "1-core box only adds contention")

_lib = None
_lib_lock = threading.Lock()

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u64p = ctypes.POINTER(ctypes.c_uint64)


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from yugabyte_tpu_torch.utils.native_build import build_native_lib
        lib_path = build_native_lib("compaction_engine.cc",
                                    "libcompaction_engine.so",
                                    extra_args=("-lz", "-lpthread"))
        lib = ctypes.CDLL(lib_path)
        lib.ce_job_new.restype = ctypes.c_void_p
        lib.ce_job_new.argtypes = [ctypes.c_int32]
        lib.ce_job_free.argtypes = [ctypes.c_void_p]
        lib.ce_job_error.restype = ctypes.c_char_p
        lib.ce_job_error.argtypes = [ctypes.c_void_p]
        lib.ce_job_add_input.argtypes = [
            ctypes.c_void_p, _u8p, ctypes.c_int64, _i64p, _i32p, _i32p,
            ctypes.c_int32]
        lib.ce_job_prepare.restype = ctypes.c_int64
        lib.ce_job_prepare.argtypes = [ctypes.c_void_p]
        lib.ce_job_add_raw.argtypes = [
            ctypes.c_void_p, _u8p, _i64p, ctypes.c_int64, _u64p,
            ctypes.POINTER(ctypes.c_uint32), _u8p, _i64p]
        lib.ce_job_sort_all.restype = ctypes.c_int64
        lib.ce_job_sort_all.argtypes = [ctypes.c_void_p]
        lib.ce_job_props.argtypes = [ctypes.c_void_p, _u64p,
                                     _i32p]
        lib.ce_job_merge.restype = ctypes.c_int64
        lib.ce_job_merge.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32]
        lib.ce_job_set_survivors.argtypes = [
            ctypes.c_void_p, _i64p, _u8p, ctypes.c_int64]
        lib.ce_job_append_survivors.argtypes = [
            ctypes.c_void_p, _i64p, _u8p, ctypes.c_int64]
        lib.ce_job_rows.restype = ctypes.c_int64
        lib.ce_job_rows.argtypes = [ctypes.c_void_p]
        lib.ce_job_n_survivors.restype = ctypes.c_int64
        lib.ce_job_n_survivors.argtypes = [ctypes.c_void_p]
        lib.ce_job_write_output.restype = ctypes.c_int64
        lib.ce_job_write_output.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int32, ctypes.c_int32, _u8p, ctypes.c_int32]
        lib.ce_out_n_blocks.restype = ctypes.c_int32
        lib.ce_out_n_blocks.argtypes = [ctypes.c_void_p]
        lib.ce_out_block_meta.argtypes = [ctypes.c_void_p, _i64p, _i32p,
                                          _i32p, _i32p]
        lib.ce_out_last_keys.argtypes = [ctypes.c_void_p, _u8p]
        lib.ce_out_bloom_hashes.argtypes = [ctypes.c_void_p, _u64p]
        lib.ce_out_first_key.restype = ctypes.c_int32
        lib.ce_out_first_key.argtypes = [ctypes.c_void_p, _u8p,
                                         ctypes.c_int32]
        lib.ce_out_last_key.restype = ctypes.c_int32
        lib.ce_out_last_key.argtypes = [ctypes.c_void_p, _u8p,
                                        ctypes.c_int32]
        lib.ce_bloom_build.argtypes = [
            _u64p, ctypes.c_int64, _u8p, ctypes.c_uint64, ctypes.c_int32]
        lib.ce_runcache_export.restype = ctypes.c_int64
        lib.ce_runcache_export.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, _u8p,
            ctypes.c_int32]
        lib.ce_runcache_entry_bytes.restype = ctypes.c_int64
        lib.ce_runcache_entry_bytes.argtypes = [ctypes.c_int64]
        lib.ce_runcache_drop.argtypes = [ctypes.c_int64]
        lib.ce_runcache_bytes.restype = ctypes.c_int64
        lib.ce_job_add_cached.restype = ctypes.c_int32
        lib.ce_job_add_cached.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.ce_job_prepare_cached.restype = ctypes.c_int64
        lib.ce_job_prepare_cached.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


_available: Optional[bool] = None


def available() -> bool:
    """Build-once probe; a failed compile is cached so the hot path does
    not re-spawn a doomed g++ per compaction pick."""
    global _available
    if _available is None:
        try:
            _load()
            _available = True
        except Exception:  # yblint: contained(build probe — cached False routes every job to the Python shell)
            _available = False
    return _available


def bloom_build(hashes: np.ndarray, bits: np.ndarray,
                m_bits: int, k: int) -> None:
    """Scatter bloom bits natively (storage/bloom.py hot path)."""
    lib = _load()
    h = np.ascontiguousarray(hashes, dtype=np.uint64)
    lib.ce_bloom_build(h.ctypes.data_as(_u64p),
                       ctypes.c_int64(len(h)),
                       bits.ctypes.data_as(_u8p),
                       ctypes.c_uint64(m_bits), ctypes.c_int32(k))


def runcache_drop(run_id: int) -> None:
    """Drop one entry from the native run cache (jobs holding it keep a
    reference until they free)."""
    _load().ce_runcache_drop(ctypes.c_int64(run_id))


def runcache_bytes() -> int:
    """Total host RAM held by the native run cache."""
    return int(_load().ce_runcache_bytes())


def runcache_entry_bytes(run_id: int) -> int:
    return int(_load().ce_runcache_entry_bytes(ctypes.c_int64(run_id)))


class NativeCompactionJob:
    """One compaction: add inputs -> prepare -> merge (or inject) -> write.

    Inputs are SSTReader-level artifacts: the raw data-file bytes plus the
    parsed block handles (Python already holds both — the base-file index
    stays Python-authority).
    """

    def __init__(self, n_threads: Optional[int] = None):
        self._lib = _load()
        nt = n_threads if n_threads is not None else \
            flags.get_flag("compaction_native_threads")
        self._job = self._lib.ce_job_new(ctypes.c_int32(nt))
        self._keepalive: List[object] = []   # input byte buffers
        self.rows_in = 0
        self.n_survivors = 0

    def close(self):
        if self._job:
            self._lib.ce_job_free(self._job)
            self._job = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _err(self) -> str:
        return self._lib.ce_job_error(self._job).decode()

    def add_input(self, data: bytes,
                  handles: Sequence[Tuple[int, int, int]]) -> None:
        self._keepalive.append(data)
        nb = len(handles)
        offs = np.asarray([h[0] for h in handles], dtype=np.int64)
        sizes = np.asarray([h[1] for h in handles], dtype=np.int32)
        counts = np.asarray([h[2] for h in handles], dtype=np.int32)
        self._keepalive += [offs, sizes, counts]
        # zero-copy: point straight at the bytes object's buffer (kept alive
        # in _keepalive until ce_job_free)
        ptr = ctypes.cast(ctypes.c_char_p(data), _u8p)
        self._lib.ce_job_add_input(
            self._job, ptr, ctypes.c_int64(len(data)),
            offs.ctypes.data_as(_i64p), sizes.ctypes.data_as(_i32p),
            counts.ctypes.data_as(_i32p), ctypes.c_int32(nb))

    def prepare(self) -> int:
        n = int(self._lib.ce_job_prepare(self._job))
        if n < 0:
            # prepare fails only in block decode (magic/CRC/size checks,
            # native/compaction_engine.cc): the input bytes are corrupt.
            # Typed as Corruption so the DB parks STICKY and the replica
            # is rebuilt instead of retrying into the same bad bytes.
            from yugabyte_tpu_torch.utils.status import Status, StatusError
            raise StatusError(Status.Corruption(
                f"native compaction prepare: {self._err()}"))
        self.rows_in = n
        return n

    def add_raw(self, keys_blob: bytes, key_offs: np.ndarray,
                ht: np.ndarray, wid: np.ndarray, vals_blob: bytes,
                val_offs: np.ndarray) -> int:
        """Ingest one packed run (the flush/bulk-load path): flags, TTL and
        doc_key_len are derived natively from the value control fields and
        key structure (ref: db/flush_job.cc WriteLevel0Table)."""
        n = len(key_offs) - 1
        key_offs = np.ascontiguousarray(key_offs, dtype=np.int64)
        ht = np.ascontiguousarray(ht, dtype=np.uint64)
        wid = np.ascontiguousarray(wid, dtype=np.uint32)
        val_offs = np.ascontiguousarray(val_offs, dtype=np.int64)
        self._keepalive += [keys_blob, key_offs, ht, wid, vals_blob, val_offs]
        self._lib.ce_job_add_raw(
            self._job, ctypes.cast(ctypes.c_char_p(keys_blob), _u8p),
            key_offs.ctypes.data_as(_i64p), ctypes.c_int64(n),
            ht.ctypes.data_as(_u64p),
            wid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            ctypes.cast(ctypes.c_char_p(vals_blob), _u8p),
            val_offs.ctypes.data_as(_i64p))
        self.rows_in = n
        return n

    def sort_all(self) -> int:
        """Order the raw run by internal key (no-op scan when pre-sorted)
        and mark every row a survivor — flush keeps all versions."""
        self.n_survivors = int(self._lib.ce_job_sort_all(self._job))
        return self.n_survivors

    def props(self):
        """(max_expire_us, has_deep) for the base-file props."""
        mx = ctypes.c_uint64()
        deep = ctypes.c_int32()
        self._lib.ce_job_props(self._job, ctypes.byref(mx),
                               ctypes.byref(deep))
        return int(mx.value), bool(deep.value)

    def merge(self, cutoff_ht: int, is_major: bool,
              retain_deletes: bool = False) -> int:
        self.n_survivors = int(self._lib.ce_job_merge(
            self._job, ctypes.c_uint64(cutoff_ht),
            ctypes.c_int32(int(is_major)),
            ctypes.c_int32(int(retain_deletes))))
        return self.n_survivors

    def set_survivors(self, surv: np.ndarray, make_tomb: np.ndarray) -> None:
        surv = np.ascontiguousarray(surv, dtype=np.int64)
        mk = np.ascontiguousarray(make_tomb, dtype=np.uint8)
        self._lib.ce_job_set_survivors(
            self._job, surv.ctypes.data_as(_i64p), mk.ctypes.data_as(_u8p),
            ctypes.c_int64(len(surv)))
        self.n_survivors = len(surv)

    def append_survivors(self, surv: np.ndarray,
                         make_tomb: np.ndarray) -> None:
        """Stage-C streaming injection: append one pipeline chunk's
        survivors (already in global merged order — chunks are route-
        partitioned) so output spans covered by appended survivors can be
        written while later chunks still compute or transfer."""
        surv = np.ascontiguousarray(surv, dtype=np.int64)
        mk = np.ascontiguousarray(make_tomb, dtype=np.uint8)
        self._lib.ce_job_append_survivors(
            self._job, surv.ctypes.data_as(_i64p), mk.ctypes.data_as(_u8p),
            ctypes.c_int64(len(surv)))
        self.n_survivors += len(surv)

    def export_run(self, start: int, end: int,
                   tombstone_value: bytes) -> int:
        """Export survivors [start, end) into the native run cache —
        byte-equivalent to re-decoding the output file written for that
        range. Returns the run id (see storage/run_cache.py)."""
        tomb = np.ascontiguousarray(
            np.frombuffer(tombstone_value, dtype=np.uint8))
        rid = int(self._lib.ce_runcache_export(
            self._job, ctypes.c_int64(start), ctypes.c_int64(end),
            tomb.ctypes.data_as(_u8p), ctypes.c_int32(len(tombstone_value))))
        if rid < 0:
            raise RuntimeError(f"run cache export: {self._err()}")
        return rid

    def add_cached(self, run_id: int) -> None:
        """Append a run-cache entry as a job input (zero-decode path)."""
        if int(self._lib.ce_job_add_cached(
                self._job, ctypes.c_int64(run_id))) != 0:
            raise KeyError(f"run cache id {run_id} not present")

    def prepare_cached(self) -> int:
        """prepare() for all-cached inputs: no file read, no block decode."""
        n = int(self._lib.ce_job_prepare_cached(self._job))
        if n < 0:
            raise RuntimeError(f"native prepare_cached: {self._err()}")
        self.rows_in = n
        return n

    def write_output(self, start: int, end: int, data_path: str,
                     block_entries: int, compress: bool,
                     tombstone_value: bytes):
        """Write one output data file; returns (data_size, index_entries,
        bloom_hashes, first_key, last_key) for Python-side base assembly."""
        tomb = np.frombuffer(tombstone_value, dtype=np.uint8)
        size = int(self._lib.ce_job_write_output(
            self._job, ctypes.c_int64(start), ctypes.c_int64(end),
            data_path.encode(), ctypes.c_int32(block_entries),
            ctypes.c_int32(int(compress)),
            np.ascontiguousarray(tomb).ctypes.data_as(_u8p),
            ctypes.c_int32(len(tombstone_value))))
        if size < 0:
            raise RuntimeError(f"native compaction write: {self._err()}")
        nb = int(self._lib.ce_out_n_blocks(self._job))
        offs = np.zeros(nb, dtype=np.int64)
        sizes = np.zeros(nb, dtype=np.int32)
        counts = np.zeros(nb, dtype=np.int32)
        lk_lens = np.zeros(nb, dtype=np.int32)
        if nb:
            self._lib.ce_out_block_meta(
                self._job, offs.ctypes.data_as(_i64p),
                sizes.ctypes.data_as(_i32p), counts.ctypes.data_as(_i32p),
                lk_lens.ctypes.data_as(_i32p))
        lk_buf = np.zeros(max(1, int(lk_lens.sum())), dtype=np.uint8)
        if nb:
            self._lib.ce_out_last_keys(self._job,
                                       lk_buf.ctypes.data_as(_u8p))
        last_keys: List[bytes] = []
        p = 0
        for ln in lk_lens:
            last_keys.append(lk_buf[p: p + int(ln)].tobytes())
            p += int(ln)
        n_rows = end - start
        hashes = np.zeros(max(1, n_rows), dtype=np.uint64)
        if n_rows:
            self._lib.ce_out_bloom_hashes(self._job,
                                          hashes.ctypes.data_as(_u64p))
        def _fetch_key(fn):
            cap = 4096
            while True:
                kb = np.zeros(cap, dtype=np.uint8)
                ln = int(fn(self._job, kb.ctypes.data_as(_u8p),
                            ctypes.c_int32(cap)))
                if ln <= cap:
                    return kb[:ln].tobytes()
                cap = ln  # key longer than the guess: retry exact-sized

        first_key = _fetch_key(self._lib.ce_out_first_key)
        last_key = _fetch_key(self._lib.ce_out_last_key)
        index = list(zip(last_keys, offs.tolist(), sizes.tolist(),
                         counts.tolist()))
        return size, index, hashes[:n_rows], first_key, last_key
