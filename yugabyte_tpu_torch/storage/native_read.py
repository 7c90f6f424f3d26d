"""ctypes bindings for the native read engine (native/read_engine.cc).

Copy of yugabyte_tpu/storage/native_read.py with the imports renamed;
native/read_engine.cc is built into this package's build directory.

The serving read path's byte work — index seek, bloom gate, in-place block
views, k-way merge, MVCC visibility — runs in C++ (ref:
src/yb/rocksdb/table/block_based_table_reader.cc:1144-1286,
table/merger.cc:51); Python keeps orchestration: which SSTs are live, the
memtable overlay, row assembly above the entry stream.

Three surfaces:
  - NativeSSTReader: per-SST handle over the raw data-file bytes (read once
    through the Env so encryption-at-rest stays transparent).
  - multi_get: one native call resolving a point read across all SSTs.
  - NativeScan: streaming batches of merged (key, value, ht, ...) arrays,
    raw (iter_from twin) or MVCC-visible (_resolve_visible twin).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_lib = None
_lib_lock = threading.Lock()

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_vpp = ctypes.POINTER(ctypes.c_void_p)


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        from yugabyte_tpu_torch.utils.native_build import build_native_lib
        lib_path = build_native_lib("read_engine.cc", "libread_engine.so",
                                    extra_args=("-lz",))
        lib = ctypes.CDLL(lib_path)
        lib.rs_open.restype = ctypes.c_void_p
        lib.rs_open.argtypes = [_u8p, ctypes.c_int64, _i64p, _i32p, _i32p,
                                ctypes.c_int32, _u8p, _i32p, _u8p,
                                ctypes.c_int64]
        lib.rs_close.argtypes = [ctypes.c_void_p]
        lib.rs_error.restype = ctypes.c_char_p
        lib.rs_error.argtypes = [ctypes.c_void_p]
        lib.rs_doc_key_len.restype = ctypes.c_int32
        lib.rs_doc_key_len.argtypes = [_u8p, ctypes.c_int32]
        lib.rs_multi_get.restype = ctypes.c_int64
        # key as c_char_p: ctypes passes the bytes object's buffer pointer
        # directly (length travels separately), skipping a per-call cast on
        # the hottest serving call
        lib.rs_multi_get.argtypes = [_vpp, ctypes.c_int32, ctypes.c_char_p,
                                     ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_uint64, _u8p, ctypes.c_int64,
                                     _u64p, _u32p, _u8p]
        lib.rs_scan_new.restype = ctypes.c_void_p
        lib.rs_scan_new.argtypes = [_vpp, ctypes.c_int32, _u8p, _i64p, _u64p,
                                    _u32p, _u8p, _i64p, _i32p, _u8p, _i64p,
                                    ctypes.c_int64, _u8p, ctypes.c_int32,
                                    _u8p, ctypes.c_int32, ctypes.c_uint64,
                                    ctypes.c_int32]
        lib.rs_scan_free.argtypes = [ctypes.c_void_p]
        lib.rs_scan_error.restype = ctypes.c_char_p
        lib.rs_scan_error.argtypes = [ctypes.c_void_p]
        lib.rs_scan_next.restype = ctypes.c_int64
        lib.rs_scan_next.argtypes = [ctypes.c_void_p, ctypes.c_int64, _u8p,
                                     ctypes.c_int64, _i32p, _u8p,
                                     ctypes.c_int64, _i64p, _u64p, _u32p,
                                     _u8p, _i32p]
        _lib = lib
        return lib


_available: Optional[bool] = None


def available() -> bool:
    global _available
    if _available is None:
        try:
            _load()
            _available = True
        except Exception:
            _available = False
    return _available


def _u8ptr(b) -> _u8p:
    return ctypes.cast(ctypes.c_char_p(b), _u8p) if b else \
        ctypes.cast(None, _u8p)


class NativeSSTReader:
    """Native handle over one SST's data file + index + bloom.

    The data-file bytes are read ONCE through the Env (decrypting at rest
    transparently) and pinned for the handle's lifetime — the native twin
    of the reference's table-cache-resident BlockBasedTable.
    """

    def __init__(self, sst_reader):
        """sst_reader: storage.sst.SSTReader (Python authority for the
        base-file metadata)."""
        self._lib = _load()
        from yugabyte_tpu_torch.utils.env import get_env
        data = get_env().read_file(sst_reader.data_path)
        handles = sst_reader.block_handles
        nb = len(handles)
        offs = np.asarray([h[0] for h in handles], dtype=np.int64)
        sizes = np.asarray([h[1] for h in handles], dtype=np.int32)
        counts = np.asarray([h[2] for h in handles], dtype=np.int32)
        index_blob = b"".join(sst_reader.index_keys)
        index_offs = np.zeros(nb + 1, dtype=np.int32)
        if nb:
            np.cumsum([len(k) for k in sst_reader.index_keys],
                      out=index_offs[1:])
        bloom = sst_reader.bloom_raw
        # keepalive: native holds raw pointers into all of these
        self._keep = (data, offs, sizes, counts, index_blob, index_offs, bloom)
        self.handle = self._lib.rs_open(
            _u8ptr(data), ctypes.c_int64(len(data)),
            offs.ctypes.data_as(_i64p), sizes.ctypes.data_as(_i32p),
            counts.ctypes.data_as(_i32p), ctypes.c_int32(nb),
            _u8ptr(index_blob), index_offs.ctypes.data_as(_i32p),
            _u8ptr(bloom), ctypes.c_int64(len(bloom)))
        self.data_bytes = len(data)

    def close(self):
        if self.handle:
            self._lib.rs_close(self.handle)
            self.handle = None

    def __del__(self):  # last-resort; DB closes explicitly
        try:
            self.close()
        except Exception:
            pass


def doc_key_len_native(key: bytes) -> int:
    lib = _load()
    return int(lib.rs_doc_key_len(_u8ptr(key), ctypes.c_int32(len(key))))


class _GetBufs(threading.local):
    """Per-thread reusable out-buffers for multi_get: concurrent server
    threads still run the GIL-releasing native lookup truly in parallel
    (each thread owns its buffers), without paying a 64K allocation +
    three ctypes object constructions per point read."""

    def __init__(self):
        self.cap = 65536
        self.val = ctypes.create_string_buffer(self.cap)
        self.vptr = ctypes.cast(self.val, _u8p)
        self.ht = ctypes.c_uint64()
        self.wid = ctypes.c_uint32()
        self.fl = ctypes.c_uint8()
        self.ht_ref = ctypes.byref(self.ht)
        self.wid_ref = ctypes.byref(self.wid)
        self.fl_ref = ctypes.byref(self.fl)

    _DEFAULT_CAP = 65536

    def grow(self, need: int) -> None:
        self.cap = max(need, self._DEFAULT_CAP)
        self.val = ctypes.create_string_buffer(self.cap)
        self.vptr = ctypes.cast(self.val, _u8p)

    def shrink(self) -> None:
        """Drop back to the default scratch size after an oversized value:
        a rare multi-MB read must not pin MBs per server thread forever."""
        if self.cap > self._DEFAULT_CAP:
            self.grow(self._DEFAULT_CAP)


_get_bufs = _GetBufs()


class ReaderSet:
    """A frozen set of native readers, pre-marshalled for per-call reuse."""

    def __init__(self, readers: Sequence[NativeSSTReader]):
        self._lib = _load()
        self.readers = list(readers)
        n = len(self.readers)
        self._arr = (ctypes.c_void_p * n)(*[r.handle for r in self.readers])
        self.n = n
        self._mg = self._lib.rs_multi_get

    def multi_get(self, key: bytes, dkl: int, read_ht: int
                  ) -> Optional[Tuple[int, int, int, bytes]]:
        """(ht, wid, flags, value) of the newest visible version, or None."""
        b = _get_bufs
        n = self._mg(self._arr, self.n, key, len(key), dkl, read_ht,
                     b.vptr, b.cap, b.ht_ref, b.wid_ref, b.fl_ref)
        if n > b.cap:  # value larger than the buffer: grow, retry, shrink
            b.grow(n)
            try:
                n = self._mg(self._arr, self.n, key, len(key), dkl, read_ht,
                             b.vptr, b.cap, b.ht_ref, b.wid_ref, b.fl_ref)
                if n == -2:
                    raise RuntimeError(
                        "native point get: block corruption: "
                        + "; ".join(self.errors()))
                if n < 0 or n > b.cap:
                    # the rset is frozen: the same key cannot change size
                    raise RuntimeError(
                        "native point get: unstable value size")
                return b.ht.value, b.wid.value, b.fl.value, \
                    ctypes.string_at(b.val, n)
            finally:
                b.shrink()
        if n == -2:
            raise RuntimeError("native point get: block corruption: "
                               + "; ".join(self.errors()))
        if n < 0:
            return None
        return b.ht.value, b.wid.value, b.fl.value, \
            ctypes.string_at(b.val, n)

    def multi_get_many(self, keys: Sequence[bytes], read_ht: int
                       ) -> List[Optional[Tuple[int, int, int, bytes]]]:
        """The batched CPU fallback of DB.multi_get: one native lookup
        per key over this frozen snapshot, amortizing the per-call
        Python (buffer setup, attribute walks) across the batch. Each
        element mirrors multi_get()'s (ht, wid, flags, value) or None —
        byte-identical to per-key calls by construction."""
        mg = self._mg
        arr, n_readers = self._arr, self.n
        b = _get_bufs
        out: List[Optional[Tuple[int, int, int, bytes]]] = []
        for key in keys:
            n = mg(arr, n_readers, key, len(key), -1, read_ht,
                   b.vptr, b.cap, b.ht_ref, b.wid_ref, b.fl_ref)
            if n > b.cap or n == -2:
                # oversized value / corruption: the slow path has the
                # grow-retry + error plumbing — stay byte-identical
                out.append(self.multi_get(key, -1, read_ht))
                continue
            if n < 0:
                out.append(None)
                continue
            out.append((b.ht.value, b.wid.value, b.fl.value,
                        ctypes.string_at(b.val, n)))
        return out

    def errors(self) -> List[str]:
        out = []
        for r in self.readers:
            msg = self._lib.rs_error(r.handle).decode()
            if msg:
                out.append(msg)
        return out


class ScanBatch:
    """One batch of scan output as numpy views (no per-row objects)."""

    __slots__ = ("n", "keys", "key_offs", "vals", "val_offs", "ht", "wid",
                 "flags", "dkl")

    def __init__(self, n, keys, key_offs, vals, val_offs, ht, wid, flags, dkl):
        self.n = n
        self.keys = keys          # uint8 blob
        self.key_offs = key_offs  # int32 [n+1]
        self.vals = vals
        self.val_offs = val_offs  # int64 [n+1]
        self.ht = ht              # uint64 [n]
        self.wid = wid
        self.flags = flags
        self.dkl = dkl

    def key(self, i: int) -> bytes:
        return self.keys[self.key_offs[i]: self.key_offs[i + 1]].tobytes()

    def value(self, i: int) -> bytes:
        return self.vals[self.val_offs[i]: self.val_offs[i + 1]].tobytes()

    @property
    def key_bytes_total(self) -> int:
        return int(self.key_offs[self.n])

    @property
    def val_bytes_total(self) -> int:
        return int(self.val_offs[self.n])


class PackedRun:
    """Memtable overlay in the packed layout rs_scan_new consumes."""

    __slots__ = ("keys", "koffs", "ht", "wid", "flags", "ttl", "dkl",
                 "vals", "voffs", "n")

    def __init__(self, entries: List[Tuple[bytes, int, int, int, int, bytes]]):
        """entries: sorted (prefix, ht, wid, flags, ttl_ms, value)."""
        n = len(entries)
        self.n = n
        self.keys = np.frombuffer(
            b"".join(e[0] for e in entries), dtype=np.uint8) if n else \
            np.zeros(0, dtype=np.uint8)
        self.koffs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(e[0]) for e in entries], out=self.koffs[1:])
        self.ht = np.fromiter((e[1] for e in entries), dtype=np.uint64,
                              count=n)
        self.wid = np.fromiter((e[2] for e in entries), dtype=np.uint32,
                               count=n)
        self.flags = np.fromiter((e[3] for e in entries), dtype=np.uint8,
                                 count=n)
        self.ttl = np.fromiter((e[4] for e in entries), dtype=np.int64,
                               count=n)
        from yugabyte_tpu_torch.ops.slabs import _doc_key_len
        self.dkl = np.fromiter((_doc_key_len(e[0]) for e in entries),
                               dtype=np.int32, count=n)
        self.vals = np.frombuffer(
            b"".join(e[5] for e in entries), dtype=np.uint8) if n else \
            np.zeros(0, dtype=np.uint8)
        self.voffs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(e[5]) for e in entries], out=self.voffs[1:])


_EMPTY_I64 = np.zeros(1, dtype=np.int64)


class NativeScan:
    """Streaming merged scan over a ReaderSet (+ optional PackedRun)."""

    def __init__(self, rset: ReaderSet, lower: bytes = b"",
                 upper: Optional[bytes] = None, read_ht: int = 2**64 - 1,
                 visible: bool = False, overlay: Optional[PackedRun] = None,
                 batch_rows: int = 65536, key_cap: int = 8 << 20,
                 val_cap: int = 24 << 20, mode: Optional[int] = None):
        """mode: 0 raw merged stream, 1 MVCC-visible, 2 raw with full
        internal keys emitted (kHybridTime + 12-byte desc DocHybridTime
        appended in C++). `visible` is shorthand for mode 1."""
        self._lib = _load()
        self._rset = rset  # keepalive (readers own the mapped bytes)
        self._overlay = overlay
        self.batch_rows = batch_rows
        self.key_cap = key_cap
        self.val_cap = val_cap
        ov = overlay
        xn = ov.n if ov is not None else 0
        self.handle = self._lib.rs_scan_new(
            rset._arr, rset.n,
            ov.keys.ctypes.data_as(_u8p) if xn else ctypes.cast(None, _u8p),
            ov.koffs.ctypes.data_as(_i64p) if xn else ctypes.cast(None, _i64p),
            ov.ht.ctypes.data_as(_u64p) if xn else ctypes.cast(None, _u64p),
            ov.wid.ctypes.data_as(_u32p) if xn else ctypes.cast(None, _u32p),
            ov.flags.ctypes.data_as(_u8p) if xn else ctypes.cast(None, _u8p),
            ov.ttl.ctypes.data_as(_i64p) if xn else ctypes.cast(None, _i64p),
            ov.dkl.ctypes.data_as(_i32p) if xn else ctypes.cast(None, _i32p),
            ov.vals.ctypes.data_as(_u8p) if xn else ctypes.cast(None, _u8p),
            ov.voffs.ctypes.data_as(_i64p) if xn else ctypes.cast(None, _i64p),
            ctypes.c_int64(xn),
            _u8ptr(lower), ctypes.c_int32(len(lower)),
            _u8ptr(upper or b""), ctypes.c_int32(len(upper or b"")),
            ctypes.c_uint64(read_ht),
            ctypes.c_int32(mode if mode is not None
                           else (1 if visible else 0)))

    def close(self):
        if self.handle:
            self._lib.rs_scan_free(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def batches(self):
        """Yield ScanBatch objects until exhaustion.

        Batches grow geometrically (64 rows up to batch_rows): short-range
        consumers — point-row iterators, intent probes — that abandon the
        generator after a few rows never pay for a 64K-row merge, while
        full scans reach the big batches within four calls."""
        lib = self._lib
        rows = min(64, self.batch_rows)
        kcap = 64 << 10
        vcap = 128 << 10
        while True:
            keys = np.empty(kcap, dtype=np.uint8)
            koffs = np.empty(rows + 1, dtype=np.int32)
            vals = np.empty(vcap, dtype=np.uint8)
            voffs = np.empty(rows + 1, dtype=np.int64)
            ht = np.empty(rows, dtype=np.uint64)
            wid = np.empty(rows, dtype=np.uint32)
            flags = np.empty(rows, dtype=np.uint8)
            dkl = np.empty(rows, dtype=np.int32)
            n = int(lib.rs_scan_next(
                self.handle, ctypes.c_int64(rows),
                keys.ctypes.data_as(_u8p), ctypes.c_int64(kcap),
                koffs.ctypes.data_as(_i32p),
                vals.ctypes.data_as(_u8p), ctypes.c_int64(vcap),
                voffs.ctypes.data_as(_i64p),
                ht.ctypes.data_as(_u64p), wid.ctypes.data_as(_u32p),
                flags.ctypes.data_as(_u8p), dkl.ctypes.data_as(_i32p)))
            if n == -3 and vcap < (1 << 30):
                kcap *= 4
                vcap *= 4  # one huge entry: retry with room for it
                continue
            if n < 0:
                raise RuntimeError(
                    "native scan: "
                    + self._lib.rs_scan_error(self.handle).decode())
            if n == 0:
                self.close()
                return
            yield ScanBatch(n, keys, koffs, vals, voffs, ht, wid, flags, dkl)
            if rows < self.batch_rows:
                rows = min(rows * 8, self.batch_rows)
                kcap = min(kcap * 8, self.key_cap)
                vcap = min(vcap * 8, self.val_cap)

    def entries(self):
        """Per-entry iterator: (key_prefix, value, ht, wid, flags, dkl).
        Row-assembly seams consume this; bulk paths should use batches()."""
        for b in self.batches():
            koffs, voffs = b.key_offs, b.val_offs
            keys, vals = b.keys, b.vals
            ht, wid, flags, dkl = b.ht, b.wid, b.flags, b.dkl
            for i in range(b.n):
                yield (keys[koffs[i]: koffs[i + 1]].tobytes(),
                       vals[voffs[i]: voffs[i + 1]].tobytes(),
                       int(ht[i]), int(wid[i]), int(flags[i]), int(dkl[i]))
