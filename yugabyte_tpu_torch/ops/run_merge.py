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
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yugabyte_tpu_torch.ops.merge_gc import (
    _ROW_DKL, _ROW_FLAGS, _ROW_HT_HI, _ROW_HT_LO, _ROW_KEY_LEN, _ROW_WID,
    _ROW_WORDS, PAD_SENTINEL, GCParams, StagedCols, _u, bucket_size,
    column_stats, gc_pack, pack_cols, pad_template, route_word_mask,
    u32_to_device)
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


def packed_run_ns(run_ns: Sequence[int]) -> List[int]:
    """Slot sizes after greedy run packing: the layout the job would
    actually stage."""
    bins = plan_run_packing(run_ns)
    if bins is None:
        return list(run_ns)
    return [sum(run_ns[i] for i in b) for b in bins]


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
    """Pack K sorted slabs into the run-major layout on the host (in a
    device_cache.HostStagingPool array) and upload it once (cuda unless
    the caller passes device='cpu').

    pack_runs: greedily pack small runs into shared m-slots first."""
    from yugabyte_tpu_torch.ops.merge_gc import count_key_col_upload
    from yugabyte_tpu_torch.storage.device_cache import host_staging_pool
    dev = torch_setup.resolve_device(device)
    live = [s for s in slabs if s.n]
    run_maps = None
    if pack_runs:
        live, run_maps = pack_runs_greedy(live)
    k_pad, m = _layout([s.n for s in live])
    w = quantize_width(max(int(s.width_words) for s in live))
    r = _ROW_WORDS + w
    # the host matrix comes from the staging pool: pinned pages on a card,
    # recycled once the upload has copied them
    pool = host_staging_pool()
    pinned = dev.type == "cuda"
    cols = pool.acquire((r, k_pad * m), pinned=pinned)
    try:
        cols[:] = pad_template(r)[:, None]
        stats = []
        for i, s in enumerate(live):
            sub, n_s, _, _ = pack_cols(s, n_pad_override=s.n,
                                       w_pad_override=w)
            cols[:, i * m: i * m + n_s] = sub
            stats.append(column_stats(sub, n_s))
        cmp_rows, n_cmp = _cmp_schedule(w, _merge_const_stats(stats, r))
    except BaseException:
        # no upload started, so nothing can alias these pages: recycle
        pool.release(cols, pinned=pinned)
        raise
    count_key_col_upload()
    cols_dev = u32_to_device(cols, dev)
    if pinned:
        # the copy owns its bytes once it completes: wait for it, then
        # recycle the pages for the next job's stage A
        torch.cuda.current_stream(dev).synchronize()
        pool.release(cols, pinned=True)
    else:
        pool.forget(cols)   # the CPU tensor aliases the array
    return StagedRuns(cols_dev, m, k_pad, w, [s.n for s in live], cmp_rows,
                      n_cmp, run_maps=run_maps)


# --------------------------------------------------------------------------
# Staged concat (kernel H, csrc/concat.cu): per-SST staged cols laid out
# into one matrix on the device, for the run-major merge (_restage_concat)
# and for the radix / scan input (_concat_staged_fused).

def staged_concat_plain(parts: Sequence[torch.Tensor], ns: Sequence[int],
                        offsets: Sequence[int], n_out: int,
                        template: np.ndarray,
                        starts: Optional[Sequence[int]] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of kernel H. Part i (int32 [r_i, >= starts[i]
    + n_i]) puts its lanes [starts[i], starts[i] + n_i) (starts: 0 for
    every part when None) at output lane offsets[i]; word rows a narrow
    part lacks are zero there; every lane no part covers carries the
    template column (u32 [rows]). Returns int32 [rows, n_out]."""
    r = len(template)
    dev = parts[0].device
    if starts is None:
        starts = [0] * len(parts)
    out = u32_to_device(template, dev)[:, None].repeat(1, n_out)
    for cols, n_i, off, st in zip(parts, ns, offsets, starts):
        r_i = min(cols.shape[0], r)
        out[:r_i, off:off + n_i] = cols[:r_i, st:st + n_i]
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


# kernel H's pad templates on the card, by (template words, device)
_templates: Dict[Tuple[bytes, str], torch.Tensor] = {}


def _template_on(template: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = np.ascontiguousarray(template, dtype=np.uint32)
    key = (t.tobytes(), str(dev))
    if key not in _templates:
        _templates[key] = u32_to_device(t, dev)
    return _templates[key]


def _concat_launch(desc: List[List[int]], n_out: int, template: np.ndarray,
                   dev: torch.device, what: str) -> torch.Tensor:
    """One launch of kernel H over descriptors (pointer at the part's
    first lane, row stride, n, output offset, rows), offsets increasing.
    The descriptors go up as one pinned, non-blocking copy; the template
    is uploaded once per (template, device)."""
    r = len(template)
    desc_dev = torch.tensor(desc, dtype=torch.int64, pin_memory=True).to(
        dev, non_blocking=True)
    tmpl = _template_on(template, dev)
    out = torch.empty((r, n_out), dtype=torch.int32, device=dev)
    rc = _concat().ybt_staged_concat(
        desc_dev.data_ptr(), len(desc), r, n_out, tmpl.data_ptr(),
        out.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, what)
    return out


def _concat_desc(parts: Sequence[torch.Tensor], ns: Sequence[int],
                 offsets: Sequence[int], starts: Sequence[int], n_out: int,
                 r: int, what: str) -> List[List[int]]:
    """Kernel H's descriptors, checked: part i's lanes [starts[i], starts[i]
    + ns[i]) at output lane offsets[i]. A window's pointer is its first
    lane, and its row stride stays the part's own (a view would carry the
    wrong one)."""
    dev = parts[0].device
    if not len(parts) == len(ns) == len(offsets) == len(starts):
        raise ValueError(f"{what}: one count, one offset and one start per "
                         f"part")
    end = 0
    desc = []
    for cols, n_i, off, st in zip(parts, ns, offsets, starts):
        torch_setup.check_u32_matrix(cols, what)
        n_i, off, st = int(n_i), int(off), int(st)
        if cols.device != dev or cols.dim() != 2 or off < end \
                or n_i < 0 or not 0 <= st <= cols.shape[1] - n_i:
            raise ValueError(f"{what}: part {tuple(cols.shape)} with lanes "
                             f"[{st}, {st + n_i}) at lane {off} overlaps or "
                             f"does not fit")
        end = off + n_i
        desc.append([cols.data_ptr() + 4 * st, cols.shape[1], n_i, off,
                     min(cols.shape[0], r)])
    if end > n_out:
        raise ValueError(f"{what}: parts reach lane {end} of {n_out}")
    return desc


def staged_concat(parts: Sequence[torch.Tensor], ns: Sequence[int],
                  offsets: Sequence[int], n_out: int,
                  template: np.ndarray) -> torch.Tensor:
    """Kernel H wrapper (see staged_concat_plain for the contract). CPU
    tensors: the plain version. CUDA tensors: csrc/concat.cu, counted in
    `staged_concat.launches`."""
    if not parts[0].is_cuda:
        return staged_concat_plain(parts, ns, offsets, n_out, template)
    desc = _concat_desc(parts, ns, offsets, [0] * len(parts), n_out,
                        len(template), "staged_concat")
    out = _concat_launch(desc, n_out, template, parts[0].device,
                         "staged_concat")
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


# positions per CTA tile of kernel D (kTile in csrc/write_through.cu)
SURVIVOR_SCAN_TILE = 16384


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
    version. CUDA tensor: csrc/write_through.cu (one launch after one
    memset of its scratch, counted in `survivor_scan.launches`)."""
    if not keep.is_cuda:
        return survivor_scan_plain(keep)
    n = keep.shape[0]
    if keep.dtype != torch.bool or keep.dim() != 1 \
            or not keep.is_contiguous() or n % 16 or keep.data_ptr() % 16:
        raise ValueError("survivor_scan: expected a contiguous, 16-byte "
                         "aligned bool vector whose length is a multiple "
                         f"of 16, got {keep.dtype} {tuple(keep.shape)}")
    dev = keep.device
    # one allocation: pos, then the scratch's 8-byte words (4n is a
    # multiple of 64, so they stay aligned)
    buf = torch.empty(n + 2 * (-(-n // SURVIVOR_SCAN_TILE) + 1),
                      dtype=torch.int32, device=dev)
    ptr = buf.data_ptr()
    rc = _wt().ybt_survivor_scan(keep.data_ptr(), n, ptr + 4 * n, ptr,
                                 torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "survivor_scan")
    survivor_scan.launches += 1
    return buf[:n]


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
    bytes have no later reader, so the handle lets go of them. A chunked
    handle first builds its parent-domain products."""
    if isinstance(handle, _ChunkedMergeGCHandle):
        handle.to_parent_products()
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


# --------------------------------------------------------------------------
# Chunked subcompactions (JAX run_merge.py:980-1330; ref:
# GenSubcompactionBoundaries, rocksdb/db/compaction_job.cc:330): one large
# staged job split into key-range chunks, each merged by its own launch of
# kernels A and B on a smaller run-major matrix.
#
# Chunk boundaries are doc-key ROUTE prefixes (the first _W_ROUTE_CHUNK key
# words masked to doc_key_len, merge_gc.route_word_mask): every version of
# one document shares its route, and encoded doc keys are prefix-free, so
# the route is monotone within each sorted run and a binary search per run
# (kernel L, csrc/chunk.cu) gives slice bounds that never split a document.
# The GC segments never straddle chunks, and the chunks in order ARE the
# global merged order. Each chunk's matrix is carved from the parent by
# one launch of kernel H with a descriptor per run window.

_W_ROUTE_CHUNK = 4


def _chunk_target_rows() -> int:
    """YBTPU_MERGE_CHUNK_ROWS: target padded rows per chunk launch. Unset,
    malformed or below 1024: chunking is off. The JAX package turns it on
    by default on the TPU only, to bound its compiled shapes; a CUDA kernel
    has no compiled shape to bound."""
    try:
        t = int(os.environ.get("YBTPU_MERGE_CHUNK_ROWS", "0"))
    except ValueError:
        return 0
    return t if t >= 1024 else 0


def _mask_route_host(words: np.ndarray, dkl: np.ndarray) -> np.ndarray:
    """words u32 [w_route, s], dkl int32 [s] -> the doc-key-masked routes
    (host wrapper over merge_gc.route_word_mask)."""
    msk = route_word_mask(torch.from_numpy(np.asarray(dkl, np.int32)),
                          words.shape[0])
    return words & msk.numpy().view(np.uint32)


def chunk_split_search_plain(cols: torch.Tensor, run_ns: torch.Tensor,
                             splitters: torch.Tensor, k_pad: int, m: int,
                             w_route: int, n_iters: int) -> torch.Tensor:
    """Plain PyTorch version of kernel L (`_chunk_split_search`): for each
    (run, splitter) lane, the first row of run i's [0, run_ns[i]) whose
    route key (the first w_route key words, masked by route_word_mask) is
    >= the splitter, by n_iters vectorized bisection steps.

    cols: int32 (u32 bits) [8+w, k_pad*m]; run_ns: int32 [k_pad];
    splitters: int32 (u32 bits) [n_split, w_route]. Returns int32 [k_pad,
    n_split]. Only real rows decide a step (mid < run_ns[i])."""
    dev = cols.device
    n_pad = cols.shape[1]
    n_split = splitters.shape[0]
    lo = torch.zeros((k_pad, n_split), dtype=torch.int64, device=dev)
    hi = run_ns.long()[:, None].expand(k_pad, n_split)
    base = torch.arange(k_pad, device=dev)[:, None] * m
    words = cols[_ROW_WORDS:_ROW_WORDS + w_route]
    sp = _u(splitters)[None]                              # [1, ns, w]
    for _ in range(n_iters):
        live = lo < hi
        mid = (lo + hi) >> 1
        idx = (base + mid).clamp(max=n_pad - 1)           # [k, ns]
        kr = (_u(words[:, idx]).permute(1, 2, 0)          # [k, ns, w]
              & _u(route_word_mask(cols[_ROW_DKL][idx], w_route,
                                   leading=False)))
        lt = torch.zeros_like(live)
        eq = torch.ones_like(live)
        for i in range(w_route):
            lt = lt | (eq & (kr[..., i] < sp[..., i]))
            eq = eq & (kr[..., i] == sp[..., i])
        hi = torch.where(live & ~lt, mid, hi)
        lo = torch.where(live & lt, mid + 1, lo)
    return lo.to(torch.int32)


_chunk_lib = None


def _chunk():
    global _chunk_lib
    if _chunk_lib is None:
        lib = torch_setup.load_cuda_lib("chunk.cu")
        lib.ybt_chunk_split_search.restype = ctypes.c_int
        lib.ybt_chunk_split_search.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        _chunk_lib = lib
    return _chunk_lib


def chunk_split_search(cols: torch.Tensor, run_ns: torch.Tensor,
                       splitters: torch.Tensor, k_pad: int, m: int,
                       w_route: int, n_iters: int) -> torch.Tensor:
    """Kernel L wrapper (see chunk_split_search_plain). CPU tensors: the
    plain version. CUDA tensors: csrc/chunk.cu, counted in
    `chunk_split_search.launches`."""
    if not cols.is_cuda:
        return chunk_split_search_plain(cols, run_ns, splitters, k_pad, m,
                                        w_route, n_iters)
    torch_setup.check_u32_matrix(cols, "chunk_split_search")
    n_split = splitters.shape[0]
    dev = cols.device
    if not (1 <= w_route <= 4 and cols.shape[0] >= _ROW_WORDS + w_route
            and cols.shape[1] == k_pad * m and n_split >= 1
            and run_ns.dtype == splitters.dtype == torch.int32
            and run_ns.device == splitters.device == dev
            and run_ns.shape == (k_pad,) and run_ns.is_contiguous()
            and splitters.shape == (n_split, w_route)
            and splitters.is_contiguous()):
        raise ValueError(f"chunk_split_search: bad arguments for cols "
                         f"{tuple(cols.shape)}, run_ns "
                         f"{tuple(run_ns.shape)}, splitters "
                         f"{tuple(splitters.shape)}, k_pad={k_pad}, m={m}, "
                         f"w_route={w_route}")
    out = torch.empty((k_pad, n_split), dtype=torch.int32, device=dev)
    rc = _chunk().ybt_chunk_split_search(
        cols.data_ptr(), cols.shape[1], run_ns.data_ptr(),
        splitters.data_ptr(), k_pad, n_split, m, w_route, n_iters,
        out.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "chunk_split_search")
    chunk_split_search.launches += 1
    return out


chunk_split_search.launches = 0


def _carve_parts(cols: torch.Tensor, starts: Sequence[int],
                 lens: Sequence[int], m: int, m_c: int, k_pad: int):
    """Kernel H's parts of one carve: run i's window [i*m + starts[i], +
    lens[i]) of the parent at output lane i*m_c."""
    return ([cols] * k_pad, [int(x) for x in lens[:k_pad]],
            [i * m_c for i in range(k_pad)],
            [i * m + int(starts[i]) for i in range(k_pad)])


def carve_chunk_plain(cols: torch.Tensor, starts: Sequence[int],
                      lens: Sequence[int], m: int, m_c: int, k_pad: int
                      ) -> torch.Tensor:
    """Plain PyTorch version of the carve (`_carve_chunk`): a fresh
    run-major int32 [r, k_pad*m_c] with out[:, i*m_c + j] = cols[:, i*m +
    starts[i] + j] for j < lens[i] and the pad template elsewhere
    (kernel H's plain version over the run windows)."""
    parts, ns, offs, sts = _carve_parts(cols, starts, lens, m, m_c, k_pad)
    return staged_concat_plain(parts, ns, offs, k_pad * m_c,
                               pad_template(cols.shape[0]), sts)


def carve_chunk(cols: torch.Tensor, starts: Sequence[int],
                lens: Sequence[int], m: int, m_c: int, k_pad: int
                ) -> torch.Tensor:
    """The carve wrapper (see carve_chunk_plain): one launch of kernel H
    (csrc/concat.cu) with a descriptor per run window, each at the
    window's first lane with the parent's row stride. CPU tensors: the
    plain version. CUDA tensors: counted in `carve_chunk.launches`."""
    if not cols.is_cuda:
        return carve_chunk_plain(cols, starts, lens, m, m_c, k_pad)
    # _concat_desc checks the windows against the parent and each other;
    # each must also stay inside its run's slot
    if cols.dim() != 2 or cols.shape[1] != k_pad * m or any(
            int(starts[i]) + int(lens[i]) > m for i in range(k_pad)):
        raise ValueError(f"carve_chunk: windows starts={list(starts)} "
                         f"lens={list(lens)} do not fit m={m}, m_c={m_c}, "
                         f"cols {tuple(cols.shape)}")
    parts, ns, offs, sts = _carve_parts(cols, starts, lens, m, m_c, k_pad)
    tmpl = pad_template(cols.shape[0])
    desc = _concat_desc(parts, ns, offs, sts, k_pad * m_c, len(tmpl),
                        "carve_chunk")
    out = _concat_launch(desc, k_pad * m_c, tmpl, cols.device, "carve_chunk")
    carve_chunk.launches += 1
    return out


carve_chunk.launches = 0


class _ChunkedMergeGCHandle:
    """Per-chunk merge + GC launches, in global merged order.

    Chunks are range-partitioned by route, so chunk-order concatenation IS
    the global merged order; each chunk's perm (over its own live-run
    concatenation) remaps through the slice offsets and the parent's
    run_maps. Like MergeGCHandle it holds the parent's metadata only.

    Write-through staging (kernels D and E) reads the parent-domain merge
    products that to_parent_products builds on the device from the chunks'
    merged payloads: `_p_mat` [r+1, n_pad], `_keep_dev`, `_mk_dev`. A
    device error propagates; the JAX package's re-carve retry and its
    fused download are not ported (ROADMAP queue A: health-board routing
    and device-fault containment)."""

    def __init__(self, handles, metas, staged: StagedRuns):
        self._handles = handles          # one per chunk, in key order
        self._metas = metas              # (starts[k_live], lens[k_live])
        self._staged = dataclasses.replace(staged, cols_dev=None)
        self._result = None
        self._parent_built = False
        self._p_mat = self._keep_dev = self._mk_dev = None

    def _remap_perm(self, p: np.ndarray, starts: np.ndarray,
                    lens: np.ndarray) -> np.ndarray:
        """Chunk-local perm (over the chunk's slot concatenation) ->
        global input-row indices, through the slice offsets and, when the
        slots were greedily packed, the per-slot run_maps."""
        staged = self._staged
        k_live = len(staged.run_ns)
        lb = np.concatenate(([0], np.cumsum(lens)))
        run_of = np.searchsorted(lb[1:], p, side="right")
        slot_pos = p - lb[run_of] + starts[run_of]
        if staged.run_maps is None:
            grb = np.concatenate(([0], np.cumsum(staged.run_ns)))
            return grb[:k_live][run_of] + slot_pos
        out = np.empty(len(p), dtype=np.int64)
        for r_i in range(k_live):
            selr = run_of == r_i
            if selr.any():
                out[selr] = staged.run_maps[r_i][slot_pos[selr]]
        return out

    def result_iter(self):
        """Stream per-chunk (perm, keep, make_tombstone) in global merged
        order: the shell writes chunk i's survivors while chunks i+1...
        still compute. The full result is memoized."""
        if self._result is not None:
            yield self._result
            return
        perms, keeps, mks = [], [], []
        for h, (starts, lens) in zip(self._handles, self._metas):
            p, keep, mk = h.result()
            perm_g = self._remap_perm(p, starts, lens)
            perms.append(perm_g)
            keeps.append(keep)
            mks.append(mk)
            yield perm_g, keep, mk
        self._result = (np.concatenate(perms), np.concatenate(keeps),
                        np.concatenate(mks))

    def result(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(perm, keep, make_tombstone) host arrays over the merged order,
        as MergeGCHandle.result."""
        if self._result is None:
            for _ in self.result_iter():
                pass
        return self._result

    def to_parent_products(self) -> None:
        """Build the parent-domain device products kernels D and E read:
        the merged payload [r+1, n_pad] from each chunk's merged prefix of
        n_c lanes at lane sum(n_<c) (one kernel-H launch, the pad template
        beyond n), its index row remapped to parent run-major lanes (slot*m
        + starts[slot] + j), and keep / make-tombstone concatenated the
        same way. The chunks' own products are released."""
        if self._parent_built:
            return
        staged = self._staged
        r = _ROW_WORDS + staged.w
        parts, ns, offs, remaps = [], [], [], []
        off = 0
        for h, (starts, lens) in zip(self._handles, self._metas):
            if isinstance(h, _ChunkedMergeGCHandle):
                h.to_parent_products()
            n_c = int(lens.sum())
            parts.append(h._p_mat)
            ns.append(n_c)
            offs.append(off)
            remaps.append((h._staged.m, starts))
            off += n_c
        dev = parts[0].device
        tmpl = np.concatenate([pad_template(r), [PAD_SENTINEL]]).astype(
            np.uint32)
        p_mat = staged_concat(parts, ns, offs, staged.n_pad, tmpl)
        keep = torch.zeros(staged.n_pad, dtype=torch.bool, device=dev)
        mk = torch.zeros(staged.n_pad, dtype=torch.bool, device=dev)
        for h, n_c, o, (m_c, starts) in zip(self._handles, ns, offs,
                                            remaps):
            idx = p_mat[-1, o:o + n_c].long()
            slot = idx // m_c
            st = torch.from_numpy(np.asarray(starts, np.int64)).to(dev)
            p_mat[-1, o:o + n_c] = (slot * staged.m + st[slot]
                                    + idx % m_c).to(torch.int32)
            keep[o:o + n_c] = h._keep_dev[:n_c]
            mk[o:o + n_c] = h._mk_dev[:n_c]
            h._p_mat = h._keep_dev = h._mk_dev = None
        self._p_mat, self._keep_dev, self._mk_dev = p_mat, keep, mk
        self._parent_built = True

    @property
    def _perm_dev(self) -> torch.Tensor:
        return self._p_mat[-1]


def _chunk_plan(staged: StagedRuns, target: int
                ) -> Tuple[int, int, np.ndarray, np.ndarray]:
    """(nc, w_route, run_ns [k_pad] int32, splitters u32 [nc-1, w_route])
    of a chunked job: nc chunks of about target/2 real rows, split at the
    route quantiles of 256 strided samples per run (a small download,
    sorted on the host)."""
    m, w = staged.m, staged.w
    cols = staged.cols_dev
    w_route = min(_W_ROUTE_CHUNK, w)
    nc = max(2, -(-staged.n // max(1, target // 2)))
    run_ns_arr = np.zeros(staged.k_pad, dtype=np.int32)
    run_ns_arr[:len(staged.run_ns)] = staged.run_ns
    s_per = 256
    idx = np.concatenate([
        i * m + (np.arange(s_per, dtype=np.int64) * rn) // s_per
        for i, rn in enumerate(staged.run_ns) if rn > 0])
    idx_t = torch.from_numpy(idx).to(cols.device)
    words = cols[_ROW_WORDS:_ROW_WORDS + w_route][:, idx_t].cpu().numpy()
    dkl = cols[_ROW_DKL][idx_t].cpu().numpy()
    routes = _mask_route_host(words.view(np.uint32), dkl).T   # [s, w]
    order = np.lexsort(tuple(routes[:, i]
                             for i in range(w_route - 1, -1, -1)))
    routes = routes[order]
    q = (np.arange(1, nc, dtype=np.int64) * len(routes)) // nc
    return nc, w_route, run_ns_arr, np.ascontiguousarray(routes[q])


def _launch_chunked(staged: StagedRuns, params: GCParams, snapshot: bool,
                    target: int) -> Optional[_ChunkedMergeGCHandle]:
    """Split one staged job into route-partitioned chunk launches.

    Returns the handle, or None when chunking cannot help (the chunk
    bucket would not shrink below the parent's m): the caller then
    launches the one big merge."""
    k_live = len(staged.run_ns)
    if k_live < 1 or staged.n == 0:
        return None
    m, k_pad, w = staged.m, staged.k_pad, staged.w
    cols = staged.cols_dev
    dev = cols.device
    nc, w_route, run_ns_arr, splitters = _chunk_plan(staged, target)
    bounds = chunk_split_search(
        cols, torch.from_numpy(run_ns_arr).to(dev),
        torch.from_numpy(splitters.view(np.int32)).to(dev), k_pad, m,
        w_route, int(m).bit_length() + 1).cpu().numpy()
    bounds = np.concatenate(
        [np.zeros((k_pad, 1), np.int32), bounds,
         run_ns_arr[:, None]], axis=1)                     # [k_pad, nc+1]
    bounds = np.maximum.accumulate(bounds, axis=1)
    lens_all = np.diff(bounds, axis=1)                     # [k_pad, nc]
    m_c = run_bucket(int(lens_all.max()))
    if m_c >= m:
        return None                                        # skew: no win
    handles, metas = [], []
    for c in range(nc):
        starts = bounds[:, c]
        lens = lens_all[:, c]
        if int(lens.sum()) == 0:
            continue                                       # dup splitter
        carved = carve_chunk(cols, starts, lens, m, m_c, k_pad)
        sub = StagedRuns(carved, m_c, k_pad, w,
                         [int(x) for x in lens[:k_live]],
                         staged.cmp_rows, staged.n_cmp)
        handles.append(launch_merge_gc(sub, params, snapshot=snapshot))
        metas.append((starts[:k_live].astype(np.int64),
                      lens[:k_live].astype(np.int64)))
    if not handles:
        return None
    return _ChunkedMergeGCHandle(handles, metas, staged)


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
    no merge: the single run is already sorted.

    With YBTPU_MERGE_CHUNK_ROWS set (>= 1024) a job larger than it is
    split into route-partitioned chunk launches (_launch_chunked), as in
    the JAX package; unset, chunking is off."""
    target = _chunk_target_rows()
    if (target and staged.k_pad >= 2 and staged.n_pad > target
            and staged.m >= 512):
        h = _launch_chunked(staged, params, snapshot, target)
        if h is not None:
            return h
    return launch_unchunked(staged, params, snapshot)


def launch_unchunked(staged: StagedRuns, params: GCParams,
                     snapshot: bool = False) -> MergeGCHandle:
    """The one big merge + GC of launch_merge_gc (kernel A's levels, then
    kernel B), never chunked: the counterpart of `_merge_gc_runs_impl`,
    which the pooled wave runs per slot."""
    p_mat = merge_payload(staged)
    r = _ROW_WORDS + staged.w
    packed, keep, mk = gc_pack(p_mat, r, staged.w, params, staged.k_pad,
                               staged.m, snapshot=snapshot)
    return MergeGCHandle(packed, staged, p_mat, keep, mk)


def merge_and_gc_runs(slabs: Sequence[KVSlab], params: GCParams, device=None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Blocking wrapper: stage, run, decode: (perm, keep, make_tombstone)
    over the merged order of the real rows.

    A skewed run layout (inflation past 2x, see run_layout_inflation) or
    YBTPU_FORCE_RADIX takes the radix re-sort instead: the live slabs
    concatenated on the host and sorted + GC'd by
    merge_gc.merge_and_gc_device (kernels G, I.1, B), masked to perm < n.
    Empty input returns empty arrays."""
    live = [s for s in slabs if s.n]
    if not live:
        z = np.zeros(0, dtype=np.int64)
        zb = np.zeros(0, dtype=bool)
        return z, zb, zb
    if run_layout_inflation([s.n for s in live]) > 2.0 or force_radix():
        from yugabyte_tpu_torch.ops.merge_gc import merge_and_gc_device
        from yugabyte_tpu_torch.ops.slabs import concat_slabs
        merged = concat_slabs(live)
        perm, keep, mk = merge_and_gc_device(merged, params, device=device)
        real = perm < merged.n
        return perm[real].astype(np.int64), keep[real], mk[real]
    staged = stage_runs_from_slabs(live, device)
    return launch_merge_gc(staged, params).result()


def force_radix() -> bool:
    """YBTPU_FORCE_RADIX: route every run merge to the radix re-sort."""
    return os.environ.get("YBTPU_FORCE_RADIX", "").lower() not in (
        "", "0", "false")


def run_layout_inflation(run_ns: Sequence[int]) -> float:
    """Padded-slot inflation of the run-major layout vs one radix bucket:
    k_pad * max(run_bucket) over bucket_size(sum). Skewed picks (one huge
    base run + small L0s) inflate about k times; past 2x the job takes the
    radix re-sort (merge_and_gc_runs, storage/compaction.py)."""
    from yugabyte_tpu_torch.ops.merge_gc import bucket_size
    k_pad, m = _layout(run_ns)
    return (k_pad * m) / bucket_size(int(sum(run_ns)))
