"""Snapshot scan: batched MVCC resolution + range filter on the device.

Counterpart of the snapshot half of yugabyte_tpu/ops/scan.py. Where the
reference resolves MVCC visibility one iterator step at a time (a
MergingIterator over block iterators, ref: rocksdb/table/merger.cc:51),
the scan resolves a whole key range in one device pass over every input:

  1. the inputs' staged cols concatenated on the device (kernel H,
     storage/device_cache.concat_staged);
  2. the radix merge (kernel G) and the sorted payload (kernel I.1), both
     in ops/radix.py, through merge_gc.sort_and_gc;
  3. snapshot GC with cutoff = read_ht (kernel B in snapshot mode): one
     surviving version per key, the one visible at the read time, with
     tombstones, TTL-expired values and root-overwrite-covered entries
     dropped;
  4. the lexicographic range mask over the sorted key words, packed
     (kernel I.2, `bound_pack`).

The host downloads perm and the packed keep and gathers the surviving
(key, value) pairs from the slabs: values never cross to the device.

Ported: `SlabSource` inputs (memtables, SSTs read with `read_all`).
Not ported yet: `ResidentSource` (the device slab cache) and the query
pushdown (`scan_filtered`, `scan_agg`); they raise NotImplementedError.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from yugabyte_tpu_torch.ops.merge_gc import (
    _ROW_KEY_LEN, _ROW_WORDS, GCParams, StagedCols, _u, _unpack_bits,
    pack_bits_u32, sort_and_gc, u32_to_device)
from yugabyte_tpu_torch.ops.slabs import KVSlab, _pad_keys_to_words
from yugabyte_tpu_torch.utils import torch_setup


def _pack_bound(key: Optional[bytes], w: int) -> Tuple[np.ndarray, int]:
    if not key:
        return np.zeros(w, dtype=np.uint32), 0
    words, lens = _pad_keys_to_words([key], width_words=w)
    return words[0], int(lens[0])


# --------------------------------------------------------------------------
# Kernel I.2 (csrc/scan.cu; I.1 is ops/radix.sorted_payload, before B)

def bound_pack_plain(p_mat: torch.Tensor, keep: torch.Tensor, w: int,
                     lo_words: np.ndarray, lo_len: int, hi_words: np.ndarray,
                     hi_len: int, has_lower: bool, has_upper: bool,
                     upper_truncated: bool = False) -> torch.Tensor:
    """Plain PyTorch version of kernel I.2 (scan.py:59-88 of the JAX
    package): keep AND the bound tests over the sorted key words and
    key_len, packed little-endian into int32 [n/32]."""
    n = p_mat.shape[1]
    dev = p_mat.device
    s_words = _u(p_mat[_ROW_WORDS:_ROW_WORDS + w])
    s_len = p_mat[_ROW_KEY_LEN].long()      # int32, as the JAX function

    def cmp_bound(b_words, b_len):
        lt = torch.zeros(n, dtype=torch.bool, device=dev)
        eq = torch.ones(n, dtype=torch.bool, device=dev)
        for i in range(w):
            bw = int(b_words[i])
            lt = lt | (eq & (s_words[i] < bw))
            eq = eq & (s_words[i] == bw)
        lt = lt | (eq & (s_len < b_len))
        eq = eq & (s_len == b_len)
        return lt, eq

    keep = keep.bool()
    if has_lower:
        lt, _ = cmp_bound(lo_words, lo_len)
        keep = keep & ~lt
    if has_upper:
        lt, eq = cmp_bound(hi_words, hi_len)
        # a truncated bound keeps keys EQUAL to the truncated prefix: their
        # full bytes can still be below the full bound (host re-check)
        keep = keep & ((lt | eq) if upper_truncated else lt)
    return pack_bits_u32(keep, n)


_scan_lib = None


def _lib():
    global _scan_lib
    if _scan_lib is None:
        lib = torch_setup.load_cuda_lib("scan.cu")
        lib.ybt_bound_pack.restype = ctypes.c_int
        lib.ybt_bound_pack.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p] + [ctypes.c_int] * 5
            + [ctypes.c_void_p, ctypes.c_void_p])
        _scan_lib = lib
    return _scan_lib


def bound_pack(p_mat: torch.Tensor, keep: torch.Tensor, w: int,
               lo_words: np.ndarray, lo_len: int, hi_words: np.ndarray,
               hi_len: int, has_lower: bool, has_upper: bool,
               upper_truncated: bool = False) -> torch.Tensor:
    """Kernel I.2 wrapper (see bound_pack_plain). CPU tensor: the plain
    version. CUDA tensor: csrc/scan.cu, counted in `bound_pack.launches`."""
    if not p_mat.is_cuda:
        return bound_pack_plain(p_mat, keep, w, lo_words, lo_len, hi_words,
                                hi_len, has_lower, has_upper, upper_truncated)
    torch_setup.check_u32_matrix(p_mat, "bound_pack")
    n = p_mat.shape[1]
    if p_mat.shape[0] < _ROW_WORDS + w or n % 32 or keep.dtype != torch.bool \
            or keep.shape != (n,) or not keep.is_contiguous():
        raise ValueError(f"bound_pack: bad shapes p_mat {tuple(p_mat.shape)},"
                         f" keep {tuple(keep.shape)} for w={w}")
    dev = p_mat.device
    bounds = u32_to_device(np.stack([np.asarray(lo_words, np.uint32),
                                     np.asarray(hi_words, np.uint32)]), dev)
    packed = torch.empty(n // 32, dtype=torch.int32, device=dev)
    rc = _lib().ybt_bound_pack(
        p_mat.data_ptr(), n, w, keep.data_ptr(), bounds.data_ptr(),
        int(lo_len), int(hi_len), int(has_lower), int(has_upper),
        int(upper_truncated), packed.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "bound_pack")
    bound_pack.launches += 1
    return packed


bound_pack.launches = 0


# --------------------------------------------------------------------------
# The scan


def _scan_fused(cols: torch.Tensor, sort_rows, n_sort: int,
                read_ht_value: int, lo_words: np.ndarray, lo_len: int,
                hi_words: np.ndarray, hi_len: int, w: int, has_lower: bool,
                has_upper: bool, upper_truncated: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(perm int32 [n_pad], packed keep int32 [n_pad/32]) of the snapshot
    scan over one cols matrix: kernels G, I.1, B (snapshot) and I.2. Pad
    rows are never kept (the JAX function keeps the first pad row when
    there is no upper bound; scan_visible masks it with perm < n)."""
    perm, keep, _mk, p_mat, _packed = sort_and_gc(
        cols, GCParams(read_ht_value, True), w, sort_rows, n_sort,
        snapshot=True)
    keep_p = bound_pack(p_mat, keep, w, lo_words, lo_len, hi_words, hi_len,
                        has_lower, has_upper, upper_truncated)
    return perm, keep_p


def scan_visible(staged: StagedCols, read_ht_value: int,
                 lower_key: Optional[bytes] = None,
                 upper_key: Optional[bytes] = None,
                 upper_truncated: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Run the scan over a staged cols matrix.

    Returns (perm, keep) as host arrays over the merged order: entry
    perm[i] of the staged input survives iff keep[i]; surviving entries are
    exactly the versions visible at read_ht within [lower_key, upper_key).
    """
    lo_w, lo_l = _pack_bound(lower_key, staged.w)
    hi_w, hi_l = _pack_bound(upper_key, staged.w)
    perm, keep_p = _scan_fused(
        staged.cols_dev, staged.sort_rows, staged.n_sort, read_ht_value,
        lo_w, lo_l, hi_w, hi_l, staged.w, lower_key is not None,
        upper_key is not None, upper_truncated)
    perm = perm.cpu().numpy()
    keep = _unpack_bits(keep_p.cpu().numpy(), staged.n_pad) & (perm < staged.n)
    return perm, keep


class SlabSource:
    """Scan input backed by a decoded host slab (memtables, SSTs read with
    `read_all`): keys and values come straight from the slab arrays."""

    def __init__(self, slab: KVSlab):
        self.slab = slab
        self.n = slab.n

    def to_slab(self) -> KVSlab:
        return self.slab

    def entry(self, i: int) -> Tuple[bytes, bytes, int]:
        sl = self.slab
        ht = (int(sl.ht_hi[i]) << 32) | int(sl.ht_lo[i])
        return sl.key_bytes(i), sl.values[int(sl.value_idx[i])], ht


def visible_entries_sources(sources, read_ht_value: int,
                            lower_key: Optional[bytes] = None,
                            upper_key: Optional[bytes] = None,
                            device=None
                            ) -> Iterator[Tuple[bytes, bytes, int]]:
    """Yield (key_prefix, value_bytes, ht_value) for every entry visible
    at read_ht in [lower_key, upper_key), in key order, over SlabSource
    inputs (on `device`: cuda unless the caller passes device='cpu')."""
    from yugabyte_tpu_torch.ops.merge_gc import stage_slab
    from yugabyte_tpu_torch.ops.slabs import FLAG_DEEP
    from yugabyte_tpu_torch.storage.device_cache import concat_staged

    for s in sources:
        if not isinstance(s, SlabSource):
            raise NotImplementedError(
                f"visible_entries_sources: {type(s).__name__} inputs (the "
                f"device slab cache) belong to a later slice of the port; "
                f"this slice scans SlabSource inputs")
    live = [s for s in sources if s.n]
    if not live:
        return
    if any(bool((s.slab.flags & FLAG_DEEP).any()) for s in live):
        # Deep documents: the device snapshot mode is depth-2 only —
        # resolve visibility on the host with the full overwrite stack.
        yield from _visible_entries_host([s.to_slab() for s in live],
                                         read_ht_value, lower_key,
                                         upper_key)
        return
    staged_list = [stage_slab(s.slab, device) for s in live]
    staged = (staged_list[0] if len(staged_list) == 1
              else concat_staged(staged_list))
    del staged_list
    # the device compare sees only the first w*4 key bytes; longer bounds
    # are truncated there and enforced exactly on the host below
    stride = staged.w * 4
    lo_exact = lower_key if lower_key and len(lower_key) > stride else None
    hi_exact = upper_key if upper_key and len(upper_key) > stride else None
    perm, keep = scan_visible(staged, read_ht_value,
                              lower_key[:stride] if lower_key else None,
                              upper_key[:stride] if upper_key else None,
                              upper_truncated=hi_exact is not None)
    del staged
    yield from survivor_entries(live, perm, keep, lo_exact, hi_exact)


def survivor_entries(live: Sequence[SlabSource], perm: np.ndarray,
                     keep: np.ndarray, lo_exact: Optional[bytes] = None,
                     hi_exact: Optional[bytes] = None
                     ) -> Iterator[Tuple[bytes, bytes, int]]:
    """The host drain of a scan: map the kept merged indices back to
    (source, local index) and yield their entries, re-checking the bounds
    the device saw truncated."""
    offsets = np.cumsum([0] + [s.n for s in live])
    sel = perm[keep]
    src_idx = np.searchsorted(offsets, sel, side="right") - 1
    local_idx = sel - offsets[src_idx]
    for j, li in zip(src_idx.tolist(), local_idx.tolist()):
        key, value, ht = live[j].entry(li)
        if lo_exact is not None and key < lo_exact:
            continue
        if hi_exact is not None and key >= hi_exact:
            continue
        yield key, value, ht


def visible_entries(slabs: Sequence[KVSlab], read_ht_value: int,
                    lower_key: Optional[bytes] = None,
                    upper_key: Optional[bytes] = None,
                    device=None) -> Iterator[Tuple[bytes, bytes, int]]:
    """Slab-list form of visible_entries_sources (every input decoded on
    the host)."""
    sources = [SlabSource(sl) for sl in slabs]
    yield from visible_entries_sources(sources, read_ht_value, lower_key,
                                       upper_key, device=device)


def _visible_entries_host(slabs: Sequence[KVSlab], read_ht_value: int,
                          lower_key: Optional[bytes],
                          upper_key: Optional[bytes]
                          ) -> Iterator[Tuple[bytes, bytes, int]]:
    """Host-side snapshot resolution with FULL overwrite-stack semantics
    (deep documents, and the native reference of the scan). Uses the
    native merge+GC in snapshot shape: a major compaction at
    cutoff=read_ht keeps exactly one surviving version per visible key
    (plus retained history above the read time, filtered here), with
    tombstones dropped and subtree overwrites applied. Each slab must be
    sorted in internal-key order."""
    from yugabyte_tpu_torch.ops.slabs import concat_slabs
    from yugabyte_tpu_torch.storage.cpu_baseline import compact_cpu_baseline

    merged = concat_slabs(slabs)
    offsets = np.cumsum([0] + [s.n for s in slabs]).tolist()
    order, keep, _ = compact_cpu_baseline(merged, offsets, read_ht_value,
                                          True)
    read_ht = int(read_ht_value)
    for i in order[keep].tolist():
        ht = (int(merged.ht_hi[i]) << 32) | int(merged.ht_lo[i])
        if ht > read_ht:
            continue  # history above the read time is not visible
        key = merged.key_bytes(i)
        if lower_key is not None and key < lower_key:
            continue
        if upper_key is not None and key >= upper_key:
            break
        yield key, merged.values[int(merged.value_idx[i])], ht


def filtered_entries_sources(*_args, **_kwargs):
    """The filtering pushdown scan (scan.py:857 of the JAX package)."""
    raise NotImplementedError("filtered_entries_sources (query pushdown) "
                              "belongs to the next slice of the port")


def aggregate_sources(*_args, **_kwargs):
    """The aggregating pushdown scan (scan.py:924 of the JAX package)."""
    raise NotImplementedError("aggregate_sources (query pushdown) belongs to "
                              "the next slice of the port")
