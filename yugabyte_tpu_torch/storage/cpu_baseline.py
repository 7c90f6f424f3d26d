"""ctypes bridge to the native CPU compaction baseline.

Builds the repository's native/compaction_baseline.cc on first use (g++ -O3,
into this package's build directory). The baseline is the reference's
architecture — heap merge + sequential filter — and serves as the oracle
the device decisions are held against (chip_smoke.py, the tests).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from yugabyte_tpu_torch.ops.slabs import KVSlab

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    from yugabyte_tpu_torch.utils.native_build import build_native_lib
    _lib = ctypes.CDLL(build_native_lib("compaction_baseline.cc",
                                        "libcompaction_baseline.so"))
    _lib.compact_baseline.restype = ctypes.c_int64
    return _lib


def compact_cpu_baseline(slab: KVSlab, run_offsets: Sequence[int],
                         history_cutoff_ht: int, is_major: bool,
                         retain_deletes: bool = False
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Run the native baseline. Runs are [run_offsets[i], run_offsets[i+1])
    slices of the slab, each already sorted in internal-key order.

    Returns (order, keep, make_tombstone) over the merged order (no
    padding)."""
    lib = _load()
    n = slab.n
    stride = slab.width_words * 4
    keys = np.ascontiguousarray(slab.key_words).astype(">u4").tobytes()
    keys_buf = np.frombuffer(keys, dtype=np.uint8)
    key_len = np.ascontiguousarray(slab.key_len, dtype=np.int32)
    dkl = np.ascontiguousarray(slab.doc_key_len, dtype=np.int32)
    ht = np.ascontiguousarray(
        (slab.ht_hi.astype(np.uint64) << 32) | slab.ht_lo.astype(np.uint64))
    wid = np.ascontiguousarray(slab.write_id, dtype=np.uint32)
    flags = np.ascontiguousarray(slab.flags, dtype=np.uint8)
    ttl = np.ascontiguousarray(slab.ttl_ms, dtype=np.int64)
    offs = np.ascontiguousarray(run_offsets, dtype=np.int64)
    keep = np.zeros(n, dtype=np.uint8)
    mk = np.zeros(n, dtype=np.uint8)
    order = np.zeros(n, dtype=np.int64)

    def p(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.compact_baseline(
        ctypes.c_int32(len(offs) - 1), p(offs, ctypes.c_int64),
        ctypes.c_int64(n), ctypes.c_int32(stride),
        p(keys_buf, ctypes.c_uint8), p(key_len, ctypes.c_int32),
        p(dkl, ctypes.c_int32), p(ht, ctypes.c_uint64),
        p(wid, ctypes.c_uint32), p(flags, ctypes.c_uint8),
        p(ttl, ctypes.c_int64),
        ctypes.c_uint64(history_cutoff_ht), ctypes.c_int32(int(is_major)),
        ctypes.c_int32(int(retain_deletes)),
        p(keep, ctypes.c_uint8), p(mk, ctypes.c_uint8),
        p(order, ctypes.c_int64))
    return order, keep.astype(bool), mk.astype(bool)
