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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from yugabyte_tpu_torch.ops.merge_gc import (
    _ROW_HT_HI, _ROW_HT_LO, _ROW_KEY_LEN, _ROW_WID, _ROW_WORDS, GCParams,
    StagedCols, column_stats, gc_pack, pack_cols, pad_template, u32_to_device)
from yugabyte_tpu_torch.ops.merge_path import merge_level
from yugabyte_tpu_torch.ops.slabs import KVSlab
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


def _restage_concat(parts: Sequence[torch.Tensor], ns: Sequence[int],
                    w: int, m: int, k_pad: int) -> torch.Tensor:
    """Per-SST staged cols -> the run-major [8+w, k_pad*m] merge layout, on
    the device of the parts (torch indexing; the XLA program
    `_restage_concat` of the JAX package).

    Real rows land at the head of slot i, narrow inputs expose their extra
    word rows as zero, and every padding lane (slot tails + the k_pad-k
    empty slots) carries the pad template so it sorts to the tail."""
    r = _ROW_WORDS + w
    dev = parts[0].device
    pad_col = u32_to_device(pad_template(r), dev)
    out = pad_col[:, None].repeat(1, k_pad * m)
    for i, (cols, n_i) in enumerate(zip(parts, ns)):
        lo = i * m
        r_i = min(cols.shape[0], r)
        out[:r_i, lo:lo + n_i] = cols[:r_i, :n_i]
        out[r_i:, lo:lo + n_i] = 0
    return out


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
    copy into pinned host memory; result() waits on the copy's event."""

    def __init__(self, packed_dev: torch.Tensor, staged: StagedRuns):
        self._packed_dev = packed_dev
        self._staged = staged
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
    packed, _keep, _mk = gc_pack(p_mat, r, staged.w, params, staged.k_pad,
                                 staged.m, snapshot=snapshot)
    return MergeGCHandle(packed, staged)


def run_layout_inflation(run_ns: Sequence[int]) -> float:
    """Padded-slot inflation of the run-major layout vs one radix bucket:
    k_pad * max(run_bucket) over bucket_size(sum). Past 2x the JAX package
    takes its radix re-sort, which this package has not ported yet."""
    from yugabyte_tpu_torch.ops.merge_gc import bucket_size
    k_pad, m = _layout(run_ns)
    return (k_pad * m) / bucket_size(int(sum(run_ns)))
