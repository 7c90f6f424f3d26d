"""Pre-sorted-run K-way merge + MVCC-GC: the compaction decision program.

Counterpart of yugabyte_tpu/ops/run_merge.py. Compaction inputs are K
already-sorted runs. They are laid out run-major as one int32 (u32 bits)
matrix [8+w, k_pad*m] on the device — each run padded to a common
power-of-two length m with all-0xFF sentinel columns that sort to the
tail, k_pad runs padded with all-sentinel runs — and merged pairwise in
log2(k_pad) merge-path levels (kernel A, ops/merge_path.py). GC and the
packed decision buffer follow (kernel B, ops/merge_gc.gc_pack).

The comparator is the internal-key order (key words asc, key_len asc,
hybrid time desc, write id desc — ops/slabs.py) over the host-pruned
non-constant columns, with the global index as final tiebreak, so the
order is total and decisions are bit-identical to the JAX package.

The decision buffer packs, per 32 merged positions, a keep word, a
make-tombstone word and ceil(log2 k_pad) source-run bit-planes. Because
the merge consumes each run in order, the host reconstructs the exact
permutation from the source codes (`_decode_packed`), so only ~0.5 byte
per row leaves the device. The download rides a CUDA stream into pinned
host memory, and `MergeGCHandle.result()` waits on its event.

Write-through staging (kernels D and E, csrc/write_through.cu) reads the
merge products the handle keeps on the device: `survivor_positions` scans
the keep bytes once per job, and `gather_staged_output_span` gathers one
output file's survivor span of cols from the merged payload.

Kernel H (`staged_concat`, csrc/concat.cu) lays per-file staged cols out
into one matrix: run-major for the merge (`_restage_concat`), back to
back for the radix merge and the scan (`_concat_staged_fused`).
"""

from __future__ import annotations

import ctypes
import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from yugabyte_tpu_torch.ops.merge_gc import (
    _ROW_FLAGS, _ROW_HT_HI, _ROW_HT_LO, _ROW_KEY_LEN, _ROW_WID, _ROW_WORDS,
    GCParams, StagedCols, bucket_size, column_stats, gc_pack, pack_cols,
    pad_template, u32_to_device)
from yugabyte_tpu_torch.ops.merge_path import merge_level
from yugabyte_tpu_torch.ops.slabs import FLAG_TOMBSTONE, KVSlab
from yugabyte_tpu_torch.utils import torch_setup


@dataclass
class StagedRuns:
    """K sorted runs laid out run-major on the device: [8+w, k_pad*m]."""
    cols_dev: torch.Tensor
    m: int                 # per-run padded length (power of two)
    k_pad: int             # run slots (power of two)
    w: int                 # key words
    run_ns: List[int]      # real rows per run (len = real run count)
    cmp_rows: np.ndarray   # pruned compare row ids, MSB-first, int32
    n_cmp: int
    # greedy run-packing (pack_runs_greedy): slot i's rows map to input
    # rows run_maps[i][slot_position] over the concatenation of the
    # ORIGINAL live runs; None = identity (slot == run)
    run_maps: Optional[List[np.ndarray]] = None

    @property
    def n(self) -> int:
        return int(sum(self.run_ns))

    @property
    def n_pad(self) -> int:
        return self.m * self.k_pad


# --------------------------------------------------------------------------
# Shape lattice: w and n_cmp are quantized exactly as in the JAX package,
# so both packages pick the same layout and comparator for the same runs.

_CMP_LATTICE = (2, 4, 6, 8, 12, 16, 24, 32)


def quantize_width(w: int) -> int:
    """Key-word width bucket: power of two, >= 4."""
    return 1 << max(2, (w - 1).bit_length() if w > 1 else 1)


def _quantize_cmp(used: List[int]) -> List[int]:
    """Pad the compare schedule to the next lattice point by repeating its
    last row (a no-op for the lexicographic comparator)."""
    for q in _CMP_LATTICE:
        if len(used) <= q:
            return used + [used[-1]] * (q - len(used))
    return used


def _merge_const_stats(per_run: Sequence[Tuple[np.ndarray, np.ndarray]],
                       r: int) -> np.ndarray:
    """Cross-run is_const vector: a row is prunable from the comparator
    only if it is constant WITH THE SAME VALUE across every input."""
    consts = np.stack([c for c, _f in per_run]).astype(bool)
    firsts = np.stack([f for _c, f in per_run]).astype(np.uint32)
    return consts.all(axis=0) & (firsts == firsts[0:1]).all(axis=0)


def _cmp_schedule(w: int, is_const: np.ndarray) -> Tuple[np.ndarray, int]:
    """Most-significant-first compare rows with constants pruned, padded to
    the n_cmp lattice. Order: key words 0..w-1, key_len, ht_hi, ht_lo,
    write_id (complements for the descending rows are applied on device)."""
    full = [_ROW_WORDS + j for j in range(w)] + [
        _ROW_KEY_LEN, _ROW_HT_HI, _ROW_HT_LO, _ROW_WID]
    used = [r for r in full if not is_const[r]]
    if not used:
        used = [_ROW_KEY_LEN]  # degenerate: all constant; any row works
    used = _quantize_cmp(used)
    return np.asarray(used, dtype=np.int32), len(used)


def run_bucket(n: int) -> int:
    """Per-run padded length: power of two, >= 256."""
    return 1 << max(8, (n - 1).bit_length() if n > 1 else 1)


def plan_run_packing(run_ns: Sequence[int]) -> Optional[List[List[int]]]:
    """Greedy (first-fit-decreasing) packing of small runs into shared
    m-slots: bins of combined size <= m (the largest run's bucket).
    Returns the bins (lists of run indices, input order preserved within a
    bin), or None when packing would not shrink k_pad."""
    k = len(run_ns)
    if k < 2:
        return None
    m = max(run_bucket(n) for n in run_ns)
    order = sorted(range(k), key=lambda i: -run_ns[i])
    bins: List[List[object]] = []          # [free_slots, [run indices]]
    for i in order:
        for b in bins:
            if b[0] >= run_ns[i]:
                b[0] -= run_ns[i]
                b[1].append(i)
                break
        else:
            bins.append([m - run_ns[i], [i]])
    k_pad_orig = 1 << max(0, (k - 1).bit_length())
    k_new = len(bins)
    k_pad_new = 1 << max(0, (k_new - 1).bit_length()) if k_new > 1 else 1
    if k_pad_new >= k_pad_orig:
        return None
    return [sorted(b[1]) for b in bins]


def _slab_sort_order(slab: KVSlab) -> np.ndarray:
    """Merged order of a concatenated slab under the kernel comparator
    (stable: ties keep concatenation order, matching the global-index
    tiebreak over the slot layout)."""
    inv = np.uint32(0xFFFFFFFF)
    keys = [slab.write_id ^ inv, slab.ht_lo ^ inv, slab.ht_hi ^ inv,
            slab.key_len.astype(np.uint32)]
    for j in range(slab.width_words - 1, -1, -1):
        keys.append(slab.key_words[:, j])
    return np.lexsort(tuple(keys))


def _gather_slab_keys(slab: KVSlab, order: np.ndarray) -> KVSlab:
    """Key-column gather of a slab (staging only reads key columns)."""
    from yugabyte_tpu_torch.ops.slabs import ValueArray
    return KVSlab(
        key_words=slab.key_words[order], key_len=slab.key_len[order],
        doc_key_len=slab.doc_key_len[order], ht_hi=slab.ht_hi[order],
        ht_lo=slab.ht_lo[order], write_id=slab.write_id[order],
        flags=slab.flags[order], ttl_ms=slab.ttl_ms[order],
        value_idx=np.arange(len(order), dtype=np.int32),
        values=ValueArray.empty_rows(len(order)))


def pack_runs_greedy(live: Sequence[KVSlab]
                     ) -> Tuple[List[KVSlab], Optional[List[np.ndarray]]]:
    """Apply plan_run_packing to live slabs: bins with >1 run are
    pre-merged on the host into one sorted slot slab, with a per-slot map
    from slot position to global input row."""
    from yugabyte_tpu_torch.ops.slabs import concat_slabs
    bins = plan_run_packing([s.n for s in live])
    if bins is None:
        return list(live), None
    bases = np.concatenate(([0], np.cumsum([s.n for s in live])))
    slot_slabs: List[KVSlab] = []
    run_maps: List[np.ndarray] = []
    for idxs in bins:
        if len(idxs) == 1:
            i = idxs[0]
            slot_slabs.append(live[i])
            run_maps.append(np.arange(bases[i], bases[i] + live[i].n,
                                      dtype=np.int64))
            continue
        cat = concat_slabs([live[i] for i in idxs])
        gidx = np.concatenate([np.arange(bases[i], bases[i] + live[i].n,
                                         dtype=np.int64) for i in idxs])
        order = _slab_sort_order(cat)
        slot_slabs.append(_gather_slab_keys(cat, order))
        run_maps.append(gidx[order])
    return slot_slabs, run_maps


def _layout(ns: Sequence[int]) -> Tuple[int, int]:
    """(k_pad, m) of the run-major layout for real run sizes ns."""
    k = len(ns)
    k_pad = 1 << max(0, (k - 1).bit_length()) if k > 1 else 1
    return k_pad, max(run_bucket(n) for n in ns)


def stage_runs_from_slabs(slabs: Sequence[KVSlab], device=None,
                          pack_runs: bool = True) -> StagedRuns:
    """Pack K sorted slabs into the run-major layout on the host and upload
    it once (cuda unless the caller passes device='cpu').

    pack_runs: greedily pack small runs into shared m-slots first."""
    dev = torch_setup.resolve_device(device)
    live = [s for s in slabs if s.n]
    run_maps = None
    if pack_runs:
        live, run_maps = pack_runs_greedy(live)
    k_pad, m = _layout([s.n for s in live])
    w = quantize_width(max(int(s.width_words) for s in live))
    r = _ROW_WORDS + w
    cols = np.empty((r, k_pad * m), dtype=np.uint32)
    cols[:] = pad_template(r)[:, None]
    stats = []
    for i, s in enumerate(live):
        sub, n_s, _, _ = pack_cols(s, n_pad_override=s.n, w_pad_override=w)
        cols[:, i * m: i * m + n_s] = sub
        stats.append(column_stats(sub, n_s))
    cmp_rows, n_cmp = _cmp_schedule(w, _merge_const_stats(stats, r))
    return StagedRuns(u32_to_device(cols, dev), m, k_pad, w,
                      [s.n for s in live], cmp_rows, n_cmp,
                      run_maps=run_maps)


# --------------------------------------------------------------------------
# Staged concat (kernel H, csrc/concat.cu): per-SST staged cols laid out
# into one matrix on the device, for the run-major merge (_restage_concat)
# and for the radix / scan input (_concat_staged_fused).

def staged_concat_plain(parts: Sequence[torch.Tensor], ns: Sequence[int],
                        offsets: Sequence[int], n_out: int,
                        template: np.ndarray) -> torch.Tensor:
    """Plain PyTorch version of kernel H. Part i (int32 [r_i, >= n_i])
    puts its first n_i lanes at output lane offsets[i]; word rows a narrow
    part lacks are zero there; every lane no part covers carries the
    template column (u32 [rows]). Returns int32 [rows, n_out]."""
    r = len(template)
    dev = parts[0].device
    out = u32_to_device(template, dev)[:, None].repeat(1, n_out)
    for cols, n_i, off in zip(parts, ns, offsets):
        r_i = min(cols.shape[0], r)
        out[:r_i, off:off + n_i] = cols[:r_i, :n_i]
        out[r_i:, off:off + n_i] = 0
    return out


_concat_lib = None


def _concat():
    global _concat_lib
    if _concat_lib is None:
        lib = torch_setup.load_cuda_lib("concat.cu")
        lib.ybt_staged_concat.restype = ctypes.c_int
        lib.ybt_staged_concat.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _concat_lib = lib
    return _concat_lib


def staged_concat(parts: Sequence[torch.Tensor], ns: Sequence[int],
                  offsets: Sequence[int], n_out: int,
                  template: np.ndarray) -> torch.Tensor:
    """Kernel H wrapper (see staged_concat_plain for the contract). CPU
    tensors: the plain version. CUDA tensors: csrc/concat.cu, counted in
    `staged_concat.launches`."""
    if not parts[0].is_cuda:
        return staged_concat_plain(parts, ns, offsets, n_out, template)
    r = len(template)
    dev = parts[0].device
    if not len(parts) == len(ns) == len(offsets):
        raise ValueError("staged_concat: one count and one offset per part")
    end = 0
    desc = []
    for cols, n_i, off in zip(parts, ns, offsets):
        torch_setup.check_u32_matrix(cols, "staged_concat")
        if cols.device != dev or cols.dim() != 2 or off < end \
                or not 0 <= n_i <= cols.shape[1]:
            raise ValueError(f"staged_concat: part {tuple(cols.shape)} with "
                             f"n={n_i} at lane {off} overlaps or does not "
                             f"fit")
        end = off + n_i
        desc.append([cols.data_ptr(), cols.shape[1], n_i, off,
                     min(cols.shape[0], r)])
    if end > n_out:
        raise ValueError(f"staged_concat: parts reach lane {end} of {n_out}")
    desc_dev = torch.tensor(desc, dtype=torch.int64).to(dev)
    tmpl = u32_to_device(template, dev)
    out = torch.empty((r, n_out), dtype=torch.int32, device=dev)
    rc = _concat().ybt_staged_concat(
        desc_dev.data_ptr(), len(desc), r, n_out, tmpl.data_ptr(),
        out.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "staged_concat")
    staged_concat.launches += 1
    return out


staged_concat.launches = 0


def _restage_concat(parts: Sequence[torch.Tensor], ns: Sequence[int],
                    w: int, m: int, k_pad: int) -> torch.Tensor:
    """Per-SST staged cols -> the run-major [8+w, k_pad*m] merge layout
    (kernel H). Real rows land at the head of slot i, narrow inputs expose
    their extra word rows as zero, and every padding lane (slot tails + the
    k_pad-k empty slots) carries the pad template so it sorts to the
    tail."""
    return staged_concat(parts, ns, [i * m for i in range(len(parts))],
                         k_pad * m, pad_template(_ROW_WORDS + w))


def _concat_staged_fused(parts: Sequence[torch.Tensor], ns: Sequence[int],
                         w: int, n_pad: int) -> torch.Tensor:
    """Per-SST staged cols -> ONE contiguous padded cols matrix [8+w,
    n_pad] (kernel H; the radix input of storage/device_cache.py
    concat_staged): real rows of every input back to back, the tail
    padded with the template."""
    offsets = np.concatenate(([0], np.cumsum(ns)[:-1])).astype(np.int64)
    return staged_concat(parts, ns, offsets.tolist(), n_pad,
                         pad_template(_ROW_WORDS + w))


def stage_runs_from_staged(staged_list: Sequence[StagedCols]) -> StagedRuns:
    """Device-side re-layout of per-SST staged cols into the run-major
    matrix — no host->device transfer."""
    live = [s for s in staged_list if s.n]
    k_pad, m = _layout([s.n for s in live])
    w = quantize_width(max(s.w for s in live))
    r = _ROW_WORDS + w
    cat = _restage_concat([s.cols_dev for s in live], [s.n for s in live],
                          w=w, m=m, k_pad=k_pad)
    stats = []
    for s in live:
        c_i = np.zeros(r, dtype=bool)
        f_i = np.zeros(r, dtype=np.uint32)
        rs = min(_ROW_WORDS + s.w, r)
        c_i[rs:] = True                  # implicit zero-pad word rows
        if s.col_const is not None:
            c_i[:rs] = s.col_const[:rs]
            f_i[:rs] = s.col_first[:rs]
        stats.append((c_i, f_i))
    cmp_rows, n_cmp = _cmp_schedule(w, _merge_const_stats(stats, r))
    return StagedRuns(cat, m, k_pad, w, [s.n for s in live], cmp_rows, n_cmp)


class MergeGCHandle:
    """In-flight merge+GC launch: the packed decisions ride a non-blocking
    copy into pinned host memory; result() waits on the copy's event.

    The handle also keeps the device-resident merge products that
    write-through staging reads (survivor_positions,
    gather_staged_output_span): the merged payload `_p_mat` [r+1, n_pad]
    (its last row is the merged run-major index, `_perm_dev`), and the
    keep / make-tombstone bytes `_keep_dev` / `_mk_dev` in merged order.
    It holds the staged runs' metadata only, not their cols matrix: the
    span gather reads the merged cols from `_p_mat`."""

    def __init__(self, packed_dev: torch.Tensor, staged: StagedRuns,
                 p_mat: Optional[torch.Tensor] = None,
                 keep_dev: Optional[torch.Tensor] = None,
                 mk_dev: Optional[torch.Tensor] = None):
        self._packed_dev = packed_dev
        self._staged = dataclasses.replace(staged, cols_dev=None)
        self._p_mat = p_mat
        self._keep_dev = keep_dev
        self._mk_dev = mk_dev
        self._result = None
        self._host = None
        self._event = None
        if packed_dev.is_cuda:
            self._host = torch.empty(packed_dev.shape, dtype=packed_dev.dtype,
                                     pin_memory=True)
            self._host.copy_(packed_dev, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()

    def _download(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            return self._host.numpy()
        return self._packed_dev.cpu().numpy()

    def result(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(perm, keep, make_tombstone) host arrays over the merged order.

        perm indexes the CONCATENATION of the live runs in input order
        (padding excluded): merged position i came from input row perm[i].
        Arrays cover exactly the real rows (length n = sum(run_ns))."""
        if self._result is None:
            packed = self._download().view(np.uint32)
            self._result = _decode_packed(packed, self._staged)
        return self._result

    def result_iter(self):
        """Streaming form of result(): one item for an unchunked launch."""
        yield self.result()

    @property
    def _perm_dev(self) -> torch.Tensor:
        return self._p_mat[-1]


def _decode_packed(packed: np.ndarray, staged: StagedRuns
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host decode of one launch's packed decision words -> (perm, keep,
    make_tombstone) over the merged order (see MergeGCHandle.result)."""
    n = staged.n
    n_grp = (n + 31) // 32
    grp = packed[:n_grp]
    keep = _unpack_words(grp[:, 0], n)
    mk = _unpack_words(grp[:, 1], n)
    if staged.k_pad == 1:
        if staged.run_maps is not None:
            return staged.run_maps[0][:n].copy(), keep, mk
        return np.arange(n, dtype=np.int64), keep, mk
    b = max(1, (staged.k_pad - 1).bit_length())
    src = np.zeros(n, dtype=np.uint32)
    for t in range(b):
        src |= _unpack_words(grp[:, 2 + t], n).astype(np.uint32) << t
    # reconstruct the permutation: the merge consumes each run in order,
    # so output position i with source run r maps to the next unconsumed
    # row of r. Padding sorts after every real key, so positions [0, n)
    # are exactly the real rows.
    perm = np.zeros(n, dtype=np.int64)
    base = np.concatenate(([0], np.cumsum(staged.run_ns)))
    for r_i in range(len(staged.run_ns)):
        sel = src == r_i
        cnt = int(sel.sum())
        if staged.run_maps is not None:
            perm[sel] = staged.run_maps[r_i][:cnt]
        else:
            perm[sel] = base[r_i] + np.arange(cnt, dtype=np.int64)
    return perm, keep, mk


def _unpack_words(words: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                         bitorder="little")[:n].astype(bool)


# --------------------------------------------------------------------------
# Write-through staging: survivor spans gathered on the device (kernels D
# and E, csrc/write_through.cu). The device-codec job encodes each output
# span from them without the cols ever leaving the card.

_wt_lib = None


def _wt():
    global _wt_lib
    if _wt_lib is None:
        lib = torch_setup.load_cuda_lib("write_through.cu")
        lib.ybt_survivor_scan_scratch_words.restype = ctypes.c_int64
        lib.ybt_survivor_scan_scratch_words.argtypes = [ctypes.c_int64]
        lib.ybt_survivor_scan.restype = ctypes.c_int
        lib.ybt_survivor_scan.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.ybt_span_gather.restype = ctypes.c_int
        lib.ybt_span_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        _wt_lib = lib
    return _wt_lib


def survivor_scan_plain(keep: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel D (`_survivor_positions_impl`):
    int32 [n] positions of the kept lanes in increasing order, then n-1 in
    every remaining slot (a padding row: padding sorts to the tail and is
    never kept, so n-1 sits beyond every real survivor)."""
    n = keep.shape[0]
    k = keep.bool()
    rank = torch.cumsum(k.long(), 0) - 1
    out = torch.full((n,), n - 1, dtype=torch.int32, device=keep.device)
    out[rank[k]] = torch.arange(n, dtype=torch.int32, device=keep.device)[k]
    return out


def survivor_scan(keep: torch.Tensor) -> torch.Tensor:
    """Kernel D wrapper (see survivor_scan_plain). CPU tensor: the plain
    version. CUDA tensor: csrc/write_through.cu (three launches, counted
    as one in `survivor_scan.launches`)."""
    if not keep.is_cuda:
        return survivor_scan_plain(keep)
    n = keep.shape[0]
    if keep.dtype != torch.bool or keep.dim() != 1 \
            or not keep.is_contiguous() or n % 16 or keep.data_ptr() % 16:
        raise ValueError("survivor_scan: expected a contiguous, 16-byte "
                         "aligned bool vector whose length is a multiple "
                         f"of 16, got {keep.dtype} {tuple(keep.shape)}")
    lib = _wt()
    dev = keep.device
    scratch = torch.empty(int(lib.ybt_survivor_scan_scratch_words(n)),
                          dtype=torch.int32, device=dev)
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    rc = lib.ybt_survivor_scan(keep.data_ptr(), n, scratch.data_ptr(),
                               pos.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "survivor_scan")
    survivor_scan.launches += 1
    return pos


survivor_scan.launches = 0


def span_gather_plain(p_mat: torch.Tensor, r: int, pos: torch.Tensor,
                      mk: torch.Tensor, start: int, end: int,
                      n_out_pad: int) -> torch.Tensor:
    """Plain PyTorch version of kernel E (`_gather_staged_output`).

    p_mat: the merged payload [>= r, n_pad] (int32 u32 bits); pos: the
    survivor positions (kernel D); mk: make-tombstone bool [n_pad], merged
    order. Returns int32 [r, n_out_pad]: survivors [start, end) in merged
    order, FLAG_TOMBSTONE OR'd into the flags row where mk is set (the
    byte shell's TTL-expiry rewrite), the pad template beyond end.
    p_mat[:r, pos] is the JAX function's cols[:, perm[pos]]: the merge
    carried every cols row along with the index row."""
    n_pad = p_mat.shape[1]
    dev = p_mat.device
    idx = start + torch.arange(n_out_pad, device=dev)
    valid = idx < end
    p = pos[idx.clamp(0, n_pad - 1)].long()
    sub = p_mat[:r, p]
    sub[_ROW_FLAGS] |= (mk[p] & valid).to(torch.int32) * FLAG_TOMBSTONE
    pad_col = u32_to_device(pad_template(r), dev)
    return torch.where(valid[None, :], sub, pad_col[:, None])


def span_gather(p_mat: torch.Tensor, r: int, pos: torch.Tensor,
                mk: torch.Tensor, start: int, end: int,
                n_out_pad: int) -> torch.Tensor:
    """Kernel E wrapper (see span_gather_plain). CPU tensor: the plain
    version. CUDA tensor: csrc/write_through.cu, counted in
    `span_gather.launches`."""
    if not p_mat.is_cuda:
        return span_gather_plain(p_mat, r, pos, mk, start, end, n_out_pad)
    torch_setup.check_u32_matrix(p_mat, "span_gather")
    n_pad = p_mat.shape[1]
    if not (_ROW_WORDS < r <= p_mat.shape[0]
            and pos.dtype == torch.int32 and pos.shape == (n_pad,)
            and mk.dtype == torch.bool and mk.shape == (n_pad,)
            and pos.is_contiguous() and mk.is_contiguous()
            and 0 <= start <= end and n_out_pad > 0):
        raise ValueError(f"span_gather: bad arguments for p_mat "
                         f"{tuple(p_mat.shape)}, r={r}, span "
                         f"[{start}, {end}), n_out_pad={n_out_pad}")
    dev = p_mat.device
    out = torch.empty((r, n_out_pad), dtype=torch.int32, device=dev)
    rc = _wt().ybt_span_gather(
        p_mat.data_ptr(), n_pad, r, pos.data_ptr(), mk.data_ptr(), start,
        end, n_out_pad, out.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "span_gather")
    span_gather.launches += 1
    return out


span_gather.launches = 0


def survivor_positions(handle: MergeGCHandle) -> torch.Tensor:
    """Survivor-position scan (kernel D) over a finished merge's keep
    bytes: the first half of write-through staging, once per job. The keep
    bytes have no later reader, so the handle lets go of them."""
    keep = handle._keep_dev
    if keep is None:
        raise RuntimeError("survivor_positions: the keep mask of this "
                           "merge was already scanned or never kept")
    pos = survivor_scan(keep)
    handle._keep_dev = None
    return pos


def gather_staged_output_span(handle: MergeGCHandle, pos_all: torch.Tensor,
                              start: int, end: int) -> StagedCols:
    """Stage ONE output file's [start, end) survivor span on the device
    (kernel E): the span's cols, padded to its power-of-two bucket.
    Column stats are left absent (every column treated as non-constant),
    so nothing is read back to the host."""
    staged = handle._staged
    r = _ROW_WORDS + staged.w
    n_out = end - start
    n_out_pad = bucket_size(n_out)
    cols_out = span_gather(handle._p_mat, r, pos_all, handle._mk_dev,
                           start, end, n_out_pad)
    return StagedCols(cols_out, n_out, n_out_pad, staged.w, None, None)


def gather_staged_outputs(handle: MergeGCHandle,
                          ranges: Sequence[Tuple[int, int]]
                          ) -> List[StagedCols]:
    """Stage every output file of a finished merge on the device: ranges
    are the [start, end) survivor spans the writer wrote. One survivor
    scan serves every span."""
    pos_all = survivor_positions(handle)
    return [gather_staged_output_span(handle, pos_all, start, end)
            for start, end in ranges]


def merge_payload(staged: StagedRuns) -> torch.Tensor:
    """The run-major cols plus the global index row, merged through
    log2(k_pad) levels of kernel A: int32 [8+w+1, n_pad]."""
    cols = staged.cols_dev
    pos = torch.arange(staged.n_pad, dtype=torch.int32, device=cols.device)
    p_mat = torch.cat([cols, pos[None]], dim=0)
    length = staged.m
    while length < staged.n_pad:
        p_mat = merge_level(p_mat, length, staged.cmp_rows)
        length *= 2
    return p_mat


def launch_merge_gc(staged: StagedRuns, params: GCParams,
                    snapshot: bool = False) -> MergeGCHandle:
    """Merge (kernel A, k_pad >= 2) + GC and packing (kernel B), enqueued
    on the current stream of the staged matrix's device. k_pad == 1 runs
    no merge: the single run is already sorted."""
    p_mat = merge_payload(staged)
    r = _ROW_WORDS + staged.w
    packed, keep, mk = gc_pack(p_mat, r, staged.w, params, staged.k_pad,
                               staged.m, snapshot=snapshot)
    return MergeGCHandle(packed, staged, p_mat, keep, mk)


def run_layout_inflation(run_ns: Sequence[int]) -> float:
    """Padded-slot inflation of the run-major layout vs one radix bucket:
    k_pad * max(run_bucket) over bucket_size(sum). Past 2x the JAX package
    takes its radix re-sort, which this package has not ported yet."""
    from yugabyte_tpu_torch.ops.merge_gc import bucket_size
    k_pad, m = _layout(run_ns)
    return (k_pad * m) / bucket_size(int(sum(run_ns)))
