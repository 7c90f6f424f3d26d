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
  4. for a bounded scan, the lexicographic range mask over the sorted key
     words, packed (kernel I.2, `bound_pack`); an unbounded scan takes
     kernel B's packed keep as it is.

The host downloads perm and the packed keep and gathers the surviving
(key, value) pairs from the slabs: values never cross to the device.

The query pushdown (`filtered_entries_sources`, `aggregate_sources`)
extends it with row-level predicates and COUNT/SUM/MIN/MAX over a small
per-entry value-word matrix (`pack_vals`: the payload byte length and the
first 12 payload bytes, control fields stripped), concatenated beside the
cols by kernel H with a zero template and gathered through the same perm
by kernel I.1; kernels J and K (ops/pushdown.py) evaluate the predicates
per document and reduce. A single sorted source (`SlabSource(...,
sorted_source=True)`, an SST) takes the presorted route: no G, no I.1,
kernel B over its own cols.

Inputs are `SlabSource`s (memtables, SSTs read with `read_all`) and
`ResidentSource`s: an SST whose staged cols (and, for the pushdown, value
words) the device slab cache holds. A resident input is neither decoded
nor uploaded to stage the scan; the entries of its survivors are read
block by block from the file (`decoded_blocks` counts the blocks). Pad
rows are masked (perm < n) on every route.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from yugabyte_tpu_torch.ops import key_bounds, pushdown, radix
from yugabyte_tpu_torch.ops.merge_gc import (
    _ROW_KEY_LEN, _ROW_WORDS, GCParams, StagedCols, _u, _unpack_bits,
    bucket_size, gc_pack, pack_bits_u32, sort_and_gc, u32_to_device)
from yugabyte_tpu_torch.ops.slabs import KVSlab, ValueArray, _pad_keys_to_words
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
        lib.ybt_key_bounds_size.restype = ctypes.c_int
        lib.ybt_key_bounds_size.argtypes = []
        key_bounds.check_layout(lib)
        lib.ybt_bound_pack.restype = ctypes.c_int
        lib.ybt_bound_pack.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
             ctypes.POINTER(key_bounds.KeyBounds)] + [ctypes.c_int] * 3
            + [ctypes.c_void_p, ctypes.c_void_p])
        _scan_lib = lib
    return _scan_lib


def bound_pack(p_mat: torch.Tensor, keep: torch.Tensor, w: int,
               lo_words: np.ndarray, lo_len: int, hi_words: np.ndarray,
               hi_len: int, has_lower: bool, has_upper: bool,
               upper_truncated: bool = False) -> torch.Tensor:
    """Kernel I.2 wrapper (see bound_pack_plain). CPU tensor: the plain
    version. CUDA tensor: csrc/scan.cu, one launch with the bounds in its
    parameters (ops/key_bounds.py), counted in `bound_pack.launches`;
    p_mat and keep must start 16-byte aligned (the kernel reads 16-byte
    vectors)."""
    if not p_mat.is_cuda:
        return bound_pack_plain(p_mat, keep, w, lo_words, lo_len, hi_words,
                                hi_len, has_lower, has_upper, upper_truncated)
    torch_setup.check_u32_matrix(p_mat, "bound_pack")
    n = p_mat.shape[1]
    if p_mat.shape[0] < _ROW_WORDS + w or n % 32 or keep.dtype != torch.bool \
            or keep.shape != (n,) or not keep.is_contiguous():
        raise ValueError(f"bound_pack: bad shapes p_mat {tuple(p_mat.shape)},"
                         f" keep {tuple(keep.shape)} for w={w}")
    if p_mat.data_ptr() % 16 or keep.data_ptr() % 16:
        raise ValueError("bound_pack: p_mat and keep must start 16-byte "
                         "aligned")
    dev = p_mat.device
    kb, _dev_words = key_bounds.key_bounds(lo_words, lo_len, hi_words,
                                           hi_len, w, dev)
    packed = torch.empty(n // 32, dtype=torch.int32, device=dev)
    rc = _lib().ybt_bound_pack(
        p_mat.data_ptr(), n, w, keep.data_ptr(), ctypes.byref(kb),
        int(has_lower), int(has_upper), int(upper_truncated),
        packed.data_ptr(), torch_setup.stream_ptr(dev))
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
    scan over one cols matrix: kernels G, I.1, B (snapshot) and, for a
    bounded scan, I.2. Without bounds the answer is plane 0 of kernel B's
    packed buffer (B's keep of real rows, packed as I.2 would pack it), so
    no I.2 runs. Pad rows are never kept (the JAX function keeps the first
    pad row when there is no upper bound; scan_visible masks it with
    perm < n)."""
    perm, keep, _mk, p_mat, packed = sort_and_gc(
        cols, GCParams(read_ht_value, True), w, sort_rows, n_sort,
        snapshot=True)
    if not (has_lower or has_upper):
        return perm, packed[:, 0].contiguous()
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
    `read_all`): keys and values come straight from the slab arrays.

    sorted_source: the slab came from a SORTED file (an SST); a single
    sorted source takes the pushdown's presorted route (no merge sort and
    no permutation gather)."""

    staged = None   # a slab source is staged by the scan that reads it

    def __init__(self, slab: KVSlab, sorted_source: bool = False):
        self.slab = slab
        self.n = slab.n
        self.sorted_source = sorted_source

    def to_slab(self) -> KVSlab:
        return self.slab

    def entry(self, i: int) -> Tuple[bytes, bytes, int]:
        sl = self.slab
        ht = (int(sl.ht_hi[i]) << 32) | int(sl.ht_lo[i])
        return sl.key_bytes(i), sl.values[int(sl.value_idx[i])], ht


class ResidentSource:
    """Scan input served from the device slab cache: the device filter
    runs over the RESIDENT cols matrix (no host decode and no upload to
    stage it), and the keys and values of SURVIVORS are read lazily from
    the SST reader's blocks, so a block is decoded only when it holds a
    visible entry (a narrow range touches one block of a resident file).

    Caller contract: the file holds no deep documents (the resident path
    is depth-2 only: check reader.props.has_deep)."""

    def __init__(self, reader, staged: StagedCols):
        self.slab = None
        self.reader = reader
        self.staged = staged
        self.n = staged.n
        self.sorted_source = True   # SSTs are sorted by construction
        # per-block first-row offsets: the block handles record their
        # entry counts (storage/sst.py index format)
        self._row_offs = np.concatenate(
            ([0], np.cumsum([h[2] for h in reader.block_handles])))
        self._blk_idx = -1
        self._blk = None
        self.decoded_blocks = 0   # survivor-block decodes of this source

    def to_slab(self) -> KVSlab:
        return self.reader.read_all()

    def entry(self, i: int) -> Tuple[bytes, bytes, int]:
        b = int(np.searchsorted(self._row_offs, i, side="right") - 1)
        if b != self._blk_idx:
            self._blk = self.reader.read_block(b)
            self._blk_idx = b
            self.decoded_blocks += 1
        sl = self._blk
        j = i - int(self._row_offs[b])
        ht = (int(sl.ht_hi[j]) << 32) | int(sl.ht_lo[j])
        return sl.key_bytes(j), sl.values[int(sl.value_idx[j])], ht


def visible_entries_sources(sources, read_ht_value: int,
                            lower_key: Optional[bytes] = None,
                            upper_key: Optional[bytes] = None,
                            device=None
                            ) -> Iterator[Tuple[bytes, bytes, int]]:
    """Yield (key_prefix, value_bytes, ht_value) for every entry visible
    at read_ht in [lower_key, upper_key), in key order, over a mixed list
    of SlabSource / ResidentSource inputs (slabs staged on `device`: cuda
    unless the caller passes device='cpu'; resident inputs are used where
    they lie)."""
    from yugabyte_tpu_torch.ops.merge_gc import stage_slab
    from yugabyte_tpu_torch.ops.slabs import FLAG_DEEP
    from yugabyte_tpu_torch.storage.device_cache import concat_staged

    live = [s for s in sources if s.n]
    if not live:
        return
    if any(s.slab is not None and bool((s.slab.flags & FLAG_DEEP).any())
           for s in live):
        # Deep documents: the device snapshot mode is depth-2 only —
        # resolve visibility on the host with the full overwrite stack
        # (a resident source is depth-2, but the host path needs every
        # input as a slab)
        yield from _visible_entries_host([s.to_slab() for s in live],
                                         read_ht_value, lower_key,
                                         upper_key)
        return
    staged_list = [s.staged if s.staged is not None
                   else stage_slab(s.slab, device) for s in live]
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


def survivor_entries(live: Sequence, perm: np.ndarray,
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


# ---------------------------------------------------------------------------
# Query pushdown: filtered and aggregating scans (scan.py:258-995 of the JAX
# package). Predicates and aggregate column selectors are operand data on
# small slot lattices; bounds are operands too (an empty lower bound and
# the up_inf flag cover the no-bound cases).

VAL_WORDS = pushdown.VAL_WORDS      # value payload words staged per entry
_VAL_ROWS = 1 + VAL_WORDS           # + the payload byte-length row
PRED_SLOTS = (1, 2, 4)              # predicate-slot lattice
AGG_SLOTS = (1, 2)                  # aggregate-column-slot lattice
# byte-column SUM accumulators are exact only while n * 255 < 2^32
PUSHDOWN_MAX_NPAD = 1 << 24

_TAG_MERGE_FLAGS = 0x6B             # ValueType.kMergeFlags
_TAG_TTL = 0x74                     # ValueType.kTTL


def pred_slot_bucket(n: int) -> Optional[int]:
    """Smallest predicate-slot lattice point holding n predicates, or
    None when the conjunction is too wide for the kernels."""
    for p in PRED_SLOTS:
        if n <= p:
            return p
    return None


def agg_slot_bucket(n: int) -> Optional[int]:
    for c in AGG_SLOTS:
        if n <= c:
            return c
    return None


def pack_vals(slab: KVSlab, n_pad: int) -> np.ndarray:
    """Pack a slab's value payloads into the [1+VAL_WORDS, n_pad] uint32
    vals matrix: row 0 = payload byte length (the kMergeFlags and kTTL
    control fields stripped), rows 1.. = the first VAL_WORDS*4 payload
    bytes as big-endian words. One vectorized pass over the value blob."""
    va = slab.values if isinstance(slab.values, ValueArray) \
        else ValueArray.from_list(list(slab.values))
    n = slab.n
    stride = VAL_WORDS * 4
    out = np.zeros((_VAL_ROWS, n_pad), dtype=np.uint32)
    if n == 0:
        return out
    idx = slab.value_idx.astype(np.int64)
    starts = va.offsets[idx]
    ends = va.offsets[idx + 1]
    # guard-padded blob: every speculative gather below stays in bounds
    data = np.concatenate([va.data, np.zeros(stride, dtype=np.uint8)])
    first = np.where(starts < ends, data[starts], 0)
    skip = np.where(first == _TAG_MERGE_FLAGS, 5, 0).astype(np.int64)
    p2 = starts + skip
    second = np.where(p2 < ends, data[np.minimum(p2, len(data) - 1)], 0)
    skip += np.where(second == _TAG_TTL, 9, 0)
    pstart = starts + skip
    plen = np.maximum(ends - pstart, 0)
    # each payload's first `stride` bytes as one row of a window view (no
    # per-byte index matrix), the bytes past its length zeroed
    b = np.lib.stride_tricks.sliding_window_view(data, stride)[
        np.minimum(pstart, len(va.data))]
    b[np.arange(stride)[None, :] >= np.minimum(plen, stride)[:, None]] = 0
    out[0, :n] = plen.astype(np.uint32)
    out[1:, :n] = b.view(">u4").T
    return out


def concat_vals(vals_list, ns: Sequence[int], n_pad: int) -> torch.Tensor:
    """Per-source vals matrices -> one [1+VAL_WORDS, n_pad] matrix (kernel
    H with a zero template), laid out at exactly the lanes
    device_cache.concat_staged gives the cols: the two matrices stay
    row-aligned through the shared sort permutation. A single source
    passes through untouched."""
    from yugabyte_tpu_torch.ops.run_merge import staged_concat
    if len(vals_list) == 1:
        return vals_list[0]
    offsets = np.concatenate(([0], np.cumsum(ns)[:-1])).astype(np.int64)
    return staged_concat(vals_list, ns, offsets.tolist(), n_pad,
                         np.zeros(_VAL_ROWS, dtype=np.uint32))


def _pushdown_base(cols: torch.Tensor, sort_rows, n_sort: int,
                   read_ht_value: int, w: int, presorted: bool):
    """Snapshot resolution shared by both pushdown scans: (perm, the
    sorted matrix, kernel B's keep). presorted: a single SST source is
    already in internal-key order (pad rows sort to its tail), so the
    radix merge (G) and the sorted payload (I.1) drop out and kernel B
    runs over the cols themselves with an identity perm."""
    params = GCParams(read_ht_value, True)
    if presorted:
        n = cols.shape[1]
        perm = torch.arange(n, dtype=torch.int32, device=cols.device)
        _packed, keep, _mk = gc_pack(cols, _ROW_WORDS + w, w, params, 1, n,
                                     snapshot=True, perm=perm)
        return perm, cols, keep
    perm, keep, _mk, s, _packed = sort_and_gc(cols, params, w, sort_rows,
                                              n_sort, snapshot=True)
    return perm, s, keep


def _sorted_vals(vals: torch.Tensor, perm: torch.Tensor,
                 presorted: bool) -> torch.Tensor:
    """vals[:, perm] (kernel I.1's gather; perm rides as its last row)."""
    return vals if presorted else radix.sorted_payload(vals, perm)


def _scan_filtered_fused(cols, vals, sort_rows, n_sort, read_ht_value: int,
                         bounds, p_ops, w: int, presorted: bool = False):
    """(perm, packed keep) of the filtered scan: snapshot resolution,
    bounds and the row-level predicates. The keep marks EVERY visible
    entry of the rows that pass (the host assembles rows from them)."""
    perm, s, keep = _pushdown_base(cols, sort_rows, n_sort, read_ht_value,
                                   w, presorted)
    sv = None if vals is None else _sorted_vals(vals, perm, presorted)
    flags = pushdown.row_flags(s, keep, sv, w, bounds, p_ops)
    del s, keep, sv
    seg = pushdown.segment_or(flags)
    return perm, pushdown.row_pass_pack(flags, seg, p_ops[1], p_ops[2])


def _scan_agg_fused(cols, vals, sort_rows, n_sort, read_ht_value: int,
                    bounds, p_ops, a_ops, w: int, c_pad: int,
                    has_vals: bool, presorted: bool = False):
    """Kernel K's (acc, ext) of the aggregating scan (pushdown.decode_agg
    reads them): the passing rows' count and, per aggregate slot, over
    entries of passing rows whose payload tag is acceptable (NULLs
    excluded), the nonnull count, 8 byte-column sums of the biased int
    payload and its min / max limbs. A row exists iff a visible bare
    DocKey marker or column entry survives (VisibleEntryRowAssembler)."""
    perm, s, keep = _pushdown_base(cols, sort_rows, n_sort, read_ht_value,
                                   w, presorted)
    sv = _sorted_vals(vals, perm, presorted) if has_vals else None
    del perm
    flags = pushdown.row_flags(s, keep, sv, w, bounds, p_ops, a_ops)
    del s, keep
    seg = pushdown.segment_or(flags)
    return pushdown.agg_reduce(flags, seg, sv, p_ops[1], p_ops[2],
                               c_pad if has_vals else 0, c_pad)


def _pack_predicate_operands(spec, p_pad: int,
                             wire_ne_semantics: bool = False):
    """wire_ne_semantics: pack != as NOT(exists equal entry) — the
    common/wire.FILTER_OPS contract where NULL/absent columns PASS !=
    (row-scan mode). False = the CQL _match contract (exists a non-equal
    entry; NULL fails) — the aggregate mode, which has no per-row
    re-check."""
    from yugabyte_tpu_torch.docdb.doc_operations import column_key_suffix
    from yugabyte_tpu_torch.docdb.scan_spec import OP_CODES
    p_sub = np.zeros(p_pad, np.uint32)
    p_op = np.zeros(p_pad, np.int32)
    p_neg = np.zeros(p_pad, np.int32)
    p_ta = np.zeros(p_pad, np.uint32)
    p_tb = np.zeros(p_pad, np.uint32)
    p_words = np.zeros((p_pad, VAL_WORDS), np.uint32)
    p_len = np.zeros(p_pad, np.int32)
    for i, p in enumerate(spec.predicates):
        suf = column_key_suffix(p.cid)
        assert len(suf) == 3 and len(p.enc) <= VAL_WORDS * 4
        p_sub[i] = (suf[0] << 16) | (suf[1] << 8) | suf[2]
        if wire_ne_semantics and p.op == "!=":
            p_op[i] = OP_CODES["="]
            p_neg[i] = 1
        else:
            p_op[i] = OP_CODES[p.op]
        p_ta[i] = p.tag_a
        p_tb[i] = p.tag_b
        w4 = np.zeros(VAL_WORDS * 4, np.uint8)
        w4[: len(p.enc)] = np.frombuffer(p.enc, dtype=np.uint8)
        w4 = w4.reshape(VAL_WORDS, 4).astype(np.uint32)
        p_words[i] = (w4[:, 0] << 24) | (w4[:, 1] << 16) \
            | (w4[:, 2] << 8) | w4[:, 3]
        p_len[i] = len(p.enc)
    return p_sub, p_op, p_neg, p_ta, p_tb, p_words, p_len


def _pack_agg_operands(spec, c_pad: int):
    from yugabyte_tpu_torch.docdb.doc_operations import column_key_suffix
    a_sub = np.zeros(c_pad, np.uint32)
    a_ta = np.zeros(c_pad, np.uint32)
    a_tb = np.zeros(c_pad, np.uint32)
    by_cid = {a.cid: a for a in spec.aggregates if a.cid is not None}
    for c, cid in enumerate(spec.agg_cids):
        suf = column_key_suffix(cid)
        a_sub[c] = (suf[0] << 16) | (suf[1] << 8) | suf[2]
        a_ta[c] = by_cid[cid].tag_a
        a_tb[c] = by_cid[cid].tag_b
    return a_sub, a_ta, a_tb


def _bound_operands(staged: StagedCols, lower_key, upper_key):
    """(bounds, lo_exact, hi_exact): the kernels' bound operands (see
    ops/pushdown.py) and the exact host re-check residue. Bounds longer
    than the key stride are truncated for the device compare; the caller
    re-checks winners against the exact bytes (filtered mode) or must
    refuse (aggregate mode)."""
    stride = staged.w * 4
    lo_exact = lower_key if lower_key and len(lower_key) > stride else None
    hi_exact = upper_key if upper_key and len(upper_key) > stride else None
    lo_w, lo_l = _pack_bound(lower_key[:stride] if lower_key else None,
                             staged.w)
    hi_w, hi_l = _pack_bound(upper_key[:stride] if upper_key else None,
                             staged.w)
    return ((lo_w, lo_l, hi_w, hi_l, upper_key is None,
             hi_exact is not None), lo_exact, hi_exact)


def _stage_pushdown(sources, spec, device):
    """Stage (cols, vals) for a mixed source list: one merged matrix
    pair, row-aligned, resident inputs (their cols and value words) used
    where they lie on the device. Raises PushdownUnsupported on deep
    documents, slot overflow, a resident source without value words, or
    an oversized batch (callers serve the query on the host)."""
    from yugabyte_tpu_torch.docdb.scan_spec import PushdownUnsupported
    from yugabyte_tpu_torch.ops.merge_gc import stage_slab
    from yugabyte_tpu_torch.ops.slabs import FLAG_DEEP
    from yugabyte_tpu_torch.storage.device_cache import concat_staged

    live = [s for s in sources if s.n]
    if not live:
        return None, None, [], False
    if any(s.slab is not None and bool((s.slab.flags & FLAG_DEEP).any())
           for s in live):
        raise PushdownUnsupported("deep")
    if pred_slot_bucket(len(spec.predicates)) is None:
        raise PushdownUnsupported("predicates")
    if spec.agg_cids and agg_slot_bucket(len(spec.agg_cids)) is None:
        raise PushdownUnsupported("agg_width")
    if spec.needs_vals and any(
            s.slab is None and getattr(s.staged, "vals_dev", None) is None
            for s in live):
        # a resident source without staged value words: the caller stages
        # it with include_vals=True (or attach_vals) first
        raise PushdownUnsupported("vals")
    if bucket_size(sum(s.n for s in live)) > PUSHDOWN_MAX_NPAD:
        raise PushdownUnsupported("batch_size")
    staged_list = [s.staged if s.staged is not None
                   else stage_slab(s.slab, device) for s in live]
    staged = (staged_list[0] if len(staged_list) == 1
              else concat_staged(staged_list))
    vals = None
    if spec.needs_vals:
        vals_list = [st.vals_dev if st.vals_dev is not None
                     else u32_to_device(pack_vals(s.slab, st.n_pad),
                                        st.cols_dev.device)
                     for s, st in zip(live, staged_list)]
        vals = concat_vals(vals_list, [st.n for st in staged_list],
                           staged.n_pad)
    presorted = len(live) == 1 and live[0].sorted_source
    return staged, vals, live, presorted


def filtered_entries_sources(sources, read_ht_value: int, spec,
                             lower_key: Optional[bytes] = None,
                             upper_key: Optional[bytes] = None,
                             device=None
                             ) -> Iterator[Tuple[bytes, bytes, int]]:
    """Pushdown twin of visible_entries_sources: the visible entries of
    exactly the rows satisfying spec.predicates (the wire filter contract:
    a NULL or absent column passes `!=`), in key order, over SlabSource /
    ResidentSource inputs (slabs staged on `device`: cuda unless the
    caller passes device='cpu'). The
    device work and its decision download happen EAGERLY, before the
    first entry is yielded."""
    staged, vals, live, presorted = _stage_pushdown(sources, spec, device)
    if staged is None:
        return iter(())
    p_ops = _pack_predicate_operands(
        spec, pred_slot_bucket(len(spec.predicates)), wire_ne_semantics=True)
    bounds, lo_exact, hi_exact = _bound_operands(staged, lower_key,
                                                 upper_key)
    perm, keep_p = _scan_filtered_fused(
        staged.cols_dev, vals, staged.sort_rows, staged.n_sort,
        read_ht_value, bounds, p_ops, staged.w, presorted)
    del vals
    perm = perm.cpu().numpy()
    keep = _unpack_bits(keep_p.cpu().numpy(), staged.n_pad) & (perm < staged.n)
    return survivor_entries(live, perm, keep, lo_exact, hi_exact)


def aggregate_sources(sources, read_ht_value: int, spec,
                      lower_key: Optional[bytes] = None,
                      upper_key: Optional[bytes] = None,
                      device=None) -> dict:
    """The aggregate partial of the source set (the CQL _match contract:
    a NULL or absent column fails every operator): {"rows": <count of
    passing rows>, "cols": {cid: {"nonnull", "sum", "min", "max"}}}.
    Sums and extremes are exact arbitrary-precision ints reconstructed
    from the device's byte-column sums and biased limbs."""
    from yugabyte_tpu_torch.docdb.scan_spec import PushdownUnsupported

    staged, vals, _live, presorted = _stage_pushdown(sources, spec, device)
    if staged is None:
        return {"rows": 0,
                "cols": {cid: {"nonnull": 0, "sum": 0, "min": None,
                               "max": None} for cid in spec.agg_cids}}
    stride = staged.w * 4
    if (lower_key and len(lower_key) > stride) or \
            (upper_key and len(upper_key) > stride):
        # no per-row host re-check exists for a scalar result: refuse
        # bounds the device compare cannot represent exactly
        raise PushdownUnsupported("bound_width")
    c_pad = agg_slot_bucket(max(len(spec.agg_cids), 1))
    p_ops = _pack_predicate_operands(spec,
                                     pred_slot_bucket(len(spec.predicates)))
    a_ops = _pack_agg_operands(spec, c_pad)
    bounds, _lo, _hi = _bound_operands(staged, lower_key, upper_key)
    acc, ext = _scan_agg_fused(
        staged.cols_dev, vals, staged.sort_rows, staged.n_sort,
        read_ht_value, bounds, p_ops, a_ops, staged.w, c_pad,
        spec.needs_vals, presorted)
    return agg_partial(spec, acc, ext, c_pad)


def agg_partial(spec, acc: torch.Tensor, ext: torch.Tensor,
                c_pad: int) -> dict:
    """Kernel K's outputs (downloaded here) -> the aggregate partial of
    aggregate_sources."""
    rows_count, nonnull, sums, min_hi, min_lo, max_hi, max_lo = \
        pushdown.decode_agg(acc, ext, c_pad)
    bias = 1 << 63
    cols = {}
    for c, cid in enumerate(spec.agg_cids):
        nn = int(nonnull[c])
        total = sum(int(sums[c][j]) << (8 * (7 - j)) for j in range(8))
        cols[cid] = {
            "nonnull": nn,
            "sum": total - nn * bias,
            "min": None if nn == 0 else
            (((int(min_hi[c]) << 32) | int(min_lo[c])) - bias),
            "max": None if nn == 0 else
            (((int(max_hi[c]) << 32) | int(max_lo[c])) - bias),
        }
    return {"rows": rows_count, "cols": cols}
