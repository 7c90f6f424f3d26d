"""MVCC-GC over a merged key-column matrix, and the host staging it needs.

Counterpart of yugabyte_tpu/ops/merge_gc.py. The GC semantics are the
reference's (ref: docdb/docdb_compaction_filter.cc):
  - version visibility within full-key segments (:166): every version with
    ht > history_cutoff is retained history; among versions <= cutoff only
    the FIRST (visible at cutoff) survives;
  - TTL expiry -> tombstone conversion / drop at major (:260-279);
  - root-subtree overwrite truncation, depth-2 (:104-123);
  - visible-tombstone drop at major compactions (:316-319).

Device matrices are torch.int32 tensors that carry u32 bit patterns (the
row layout below): int32 has every tensor op on both the CPU and CUDA,
while torch's uint32 lacks add, shifts, ordered compares, cummax and max
on the CPU. The plain PyTorch versions widen to int64 (`_u`) wherever the
unsigned order or arithmetic matters; the CUDA kernel reads the same
memory as raw uint32.

Fixed row layout of `cols` (rows R = 8 + W):
    0 key_len | 1 doc_key_len | 2 ht_hi | 3 ht_lo | 4 write_id
    5 entry_flags | 6 ttl_hi | 7 ttl_lo | 8.. key words 0..W-1

`gc_pack` is the wrapper of kernel B (csrc/gc_pack.cu): GC + decision
packing in one call. On a CPU tensor it runs `gc_pack_plain`; on a CUDA
tensor it launches the kernel or raises — it never falls back.

`sort_and_gc` / `merge_and_gc_device` are the radix merge + GC over one
unsorted matrix (skewed picks, the scan): kernel G (ops/radix.py) sorts,
kernel I.1 (ops/radix.py) gathers the sorted payload, kernel B decides.
"""

from __future__ import annotations

import ctypes
import threading
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from yugabyte_tpu_torch.ops import radix
from yugabyte_tpu_torch.ops.slabs import (FLAG_HAS_TTL, FLAG_TOMBSTONE,
                                          KVSlab)
from yugabyte_tpu_torch.utils import torch_setup

_ROW_KEY_LEN, _ROW_DKL, _ROW_HT_HI, _ROW_HT_LO, _ROW_WID = 0, 1, 2, 3, 4
_ROW_FLAGS, _ROW_TTL_HI, _ROW_TTL_LO, _ROW_WORDS = 5, 6, 7, 8

PAD_SENTINEL = 0xFFFFFFFF  # key_len/dkl value marking padding rows
_U32 = 0xFFFFFFFF


@dataclass(frozen=True)
class GCParams:
    history_cutoff_ht: int      # HybridTime.value; versions above stay
    is_major_compaction: bool   # bottommost level: tombstones can vanish
    retain_deletes: bool = False  # e.g. during index backfill (ref :288)

    def limbs(self) -> Tuple[int, int, int, int]:
        """(cutoff_hi, cutoff_lo, cutoff_phys_hi, cutoff_phys_lo): the
        cutoff as two u32 limbs, and its physical microseconds as 20-bit
        low / high limbs (the TTL arithmetic's representation)."""
        cutoff = self.history_cutoff_ht
        phys = cutoff >> 12
        return (cutoff >> 32, cutoff & _U32, phys >> 20, phys & 0xFFFFF)


def _u(x: torch.Tensor) -> torch.Tensor:
    """u32 bits held in int32 -> their unsigned value as int64."""
    return x.long() & _U32


def to_u32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor holding the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def u32_to_device(arr: np.ndarray, device) -> torch.Tensor:
    """Host uint32 array -> int32 device tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.uint32)
                            .view(np.int32)).to(device)


# host->device uploads of key columns (stage_slab, run_merge.
# stage_runs_from_slabs, the codec's raw column regions), process-wide: a
# job whose inputs are all resident must add none
_upload_lock = threading.Lock()
_key_col_uploads = 0   # guarded-by: _upload_lock


def key_col_uploads() -> int:
    """Key-column uploads so far in this process."""
    with _upload_lock:
        return _key_col_uploads


def count_key_col_upload() -> None:
    global _key_col_uploads
    with _upload_lock:
        _key_col_uploads += 1


def gc_over_sorted(s: torch.Tensor, w: int, cutoff_hi: int, cutoff_lo: int,
                   cutoff_phys_hi: int, cutoff_phys_lo: int,
                   is_major: bool, retain_deletes: bool,
                   snapshot: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MVCC-GC decisions over an ALREADY-MERGED cols matrix `s` [R, n]
    (int32 bits). The plain PyTorch version: widened to int64 throughout.
    Returns (keep, make_tombstone) bool tensors [n]."""
    n = s.shape[1]
    dev = s.device
    s_len = s[_ROW_KEY_LEN].long()          # int32 view, as the reference
    s_dkl = s[_ROW_DKL].long()
    hi, lo, wid = _u(s[_ROW_HT_HI]), _u(s[_ROW_HT_LO]), _u(s[_ROW_WID])
    flags = _u(s[_ROW_FLAGS])
    ttl_hi, ttl_lo = _u(s[_ROW_TTL_HI]), _u(s[_ROW_TTL_LO])
    words = _u(s[_ROW_WORDS:_ROW_WORDS + w])        # [w, n]

    # ---- segment structure ------------------------------------------------
    new_seg = torch.ones(n, dtype=torch.bool, device=dev)
    new_seg[1:] = ~((words[:, 1:] == words[:, :-1]).all(dim=0)
                    & (s_len[1:] == s_len[:-1]))
    word_idx = torch.arange(w, device=dev)[:, None]
    nbytes = (s_dkl[None, :] - word_idx * 4).clamp(0, 4)
    ones = torch.full_like(nbytes, _U32)
    mask = torch.where(nbytes == 0, 0,
                       (ones << ((4 - nbytes) * 8)) & _U32)
    doc_words = words & mask
    new_doc = torch.ones(n, dtype=torch.bool, device=dev)
    new_doc[1:] = ~((doc_words[:, 1:] == doc_words[:, :-1]).all(dim=0)
                    & (s_dkl[1:] == s_dkl[:-1]))
    doc_seg_id = torch.cumsum(new_doc.long(), 0)

    # ---- version visibility within full-key segments ----------------------
    c = (hi < cutoff_hi) | ((hi == cutoff_hi) & (lo <= cutoff_lo))
    c_i = c.long()
    total = torch.cumsum(c_i, 0)
    base = torch.cummax(torch.where(new_seg, total - c_i, 0), 0).values
    visible_slot = c & ((total - base) == 1)
    keep_version = ~c | visible_slot

    # ---- TTL expiry (u32 limb arithmetic, wrapped as the device does) -----
    has_ttl = (flags & FLAG_HAS_TTL) != 0
    sum_lo = ((lo >> 12) + ttl_lo) & _U32
    carry = sum_lo >> 20
    sum_hi = (hi + ttl_hi + carry) & _U32
    sum_lo = sum_lo & 0xFFFFF
    expired = has_ttl & ((sum_hi < cutoff_phys_hi)
                         | ((sum_hi == cutoff_phys_hi)
                            & (sum_lo <= cutoff_phys_lo)))
    already_tomb = (flags & FLAG_TOMBSTONE) != 0
    is_tomb = already_tomb | (expired & c)

    # ---- root-subtree overwrite: forward-fill the last visible root write -
    is_root = s_len == s_dkl
    ov_flag = is_root & visible_slot
    pos = torch.arange(n, device=dev)
    last = torch.cummax(torch.where(ov_flag, pos, -1), 0).values
    ov_valid = last >= 0
    src = last.clamp(min=0)
    in_same_doc = ov_valid & (doc_seg_id[src] == doc_seg_id)
    ov_hi, ov_lo, ov_wid = hi[src], lo[src], wid[src]
    # strict <, matching the reference's obsolete check (ref :166)
    dht_lt = (hi < ov_hi) | ((hi == ov_hi) & (
        (lo < ov_lo) | ((lo == ov_lo) & (wid < ov_wid))))
    covered = (~is_root) & in_same_doc & dht_lt

    # ---- tombstone GC + result -------------------------------------------
    if snapshot:
        keep = visible_slot & ~covered & ~is_tomb
        return keep, torch.zeros_like(keep)
    drop_tomb = visible_slot & is_tomb & bool(is_major) \
        & bool(not retain_deletes)
    keep = keep_version & ~covered & ~drop_tomb
    make_tombstone = expired & keep & c & ~already_tomb & bool(not is_major)
    return keep, make_tombstone


def pack_bits_u32(bits: torch.Tensor, n: int) -> torch.Tensor:
    """bool [n] -> u32 bits [n//32] (int32 tensor), little-endian lanes
    (np.unpackbits' bitorder='little' inverse)."""
    b = bits.reshape(n // 32, 32).long() \
        << torch.arange(32, device=bits.device)[None, :]
    return to_u32_bits(b.sum(dim=1))


def n_src_planes(k_pad: int) -> int:
    """b: source-run bit-planes in the packed decision buffer."""
    return max(1, (k_pad - 1).bit_length())


def gc_pack_plain(p_mat: torch.Tensor, r: int, w: int, params: GCParams,
                  k_pad: int, m: int, snapshot: bool = False,
                  perm: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel B. p_mat: int32 [>= r+1, n] merged
    payload, rows 0..r-1 the cols layout, row r the perm (run-major input
    index); or [>= r, n] with the perm given apart (`perm`, int32 [n]: the
    pushdown's presorted route runs B on a sorted input's own cols).
    Returns (packed int32 [n//32, 2+b], keep, make_tombstone)."""
    n = p_mat.shape[1]
    s = p_mat[:r]
    keep, mk = gc_over_sorted(s, w, *params.limbs(),
                              is_major=params.is_major_compaction,
                              retain_deletes=params.retain_deletes,
                              snapshot=snapshot)
    keep = keep & (_u(s[_ROW_KEY_LEN]) != PAD_SENTINEL)
    src = _u(p_mat[r] if perm is None else perm) >> (int(m).bit_length() - 1)
    groups = [pack_bits_u32(keep, n), pack_bits_u32(mk, n)]
    for t in range(n_src_planes(k_pad)):
        groups.append(pack_bits_u32(((src >> t) & 1).bool(), n))
    return torch.stack(groups, dim=1), keep, mk


_gc_lib = None


def _lib():
    global _gc_lib
    if _gc_lib is None:
        lib = torch_setup.load_cuda_lib("gc_pack.cu")
        lib.ybt_gc_pack_scratch_bytes.restype = ctypes.c_int64
        lib.ybt_gc_pack_scratch_bytes.argtypes = [ctypes.c_int64]
        lib.ybt_gc_pack.restype = ctypes.c_int
        lib.ybt_gc_pack.argtypes = (
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
            + [ctypes.c_uint32] * 4 + [ctypes.c_int] * 5
            + [ctypes.c_void_p] * 5)
        _gc_lib = lib
    return _gc_lib


def gc_pack(p_mat: torch.Tensor, r: int, w: int, params: GCParams,
            k_pad: int, m: int, snapshot: bool = False,
            perm: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel B wrapper: GC + decision packing over the merged payload
    (see gc_pack_plain for the contract). CPU tensor: the plain version.
    CUDA tensor: csrc/gc_pack.cu, one memset and one single-pass launch,
    counted in `gc_pack.launches`; p_mat and perm must start 16-byte
    aligned (the kernel reads 16-byte vectors)."""
    if not p_mat.is_cuda:
        return gc_pack_plain(p_mat, r, w, params, k_pad, m, snapshot, perm)
    torch_setup.check_u32_matrix(p_mat, "gc_pack")
    n = p_mat.shape[1]
    if p_mat.shape[0] < r + (perm is None) or r != _ROW_WORDS + w or n % 32:
        raise ValueError(f"gc_pack: bad shape {tuple(p_mat.shape)} for "
                         f"r={r} w={w} (n must be a multiple of 32)")
    if perm is not None and (perm.dtype != torch.int32 or perm.shape != (n,)
                             or not perm.is_contiguous()
                             or perm.device != p_mat.device):
        raise ValueError("gc_pack: perm must be a contiguous int32 [n] "
                         "tensor beside p_mat")
    if p_mat.data_ptr() % 16 or (perm is not None and perm.data_ptr() % 16):
        raise ValueError("gc_pack: p_mat and perm must start 16-byte "
                         "aligned")
    lib = _lib()
    b = n_src_planes(k_pad)
    dev = p_mat.device
    scratch = torch.empty(int(lib.ybt_gc_pack_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    packed = torch.empty((n // 32, 2 + b), dtype=torch.int32, device=dev)
    keep = torch.empty(n, dtype=torch.bool, device=dev)
    mk = torch.empty(n, dtype=torch.bool, device=dev)
    base = p_mat.data_ptr()
    rc = lib.ybt_gc_pack(
        base, base + r * n * 4 if perm is None else perm.data_ptr(), n, w,
        *params.limbs(),
        int(params.is_major_compaction), int(params.retain_deletes),
        int(snapshot), int(m).bit_length() - 1, b,
        scratch.data_ptr(), packed.data_ptr(), keep.data_ptr(),
        mk.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "gc_pack")
    gc_pack.launches += 1
    return packed, keep, mk


gc_pack.launches = 0


def route_word_mask(dkl: torch.Tensor, w_route: int,
                    leading: bool = True) -> torch.Tensor:
    """Per-word doc-key mask of route prefixes: word i keeps
    clip(dkl - 4*i, 0, 4) leading bytes (big-endian packed keys).

    The single definition of route masking: chunk boundaries and the host
    splitter sampling (ops/run_merge.py) and the mesh's shard routing must
    agree bit for bit, or a document splits across partitions; kernel L
    (csrc/chunk.cu) inlines the same arithmetic. dkl: int32 [...]; returns
    the mask as int32 (u32 bits) with the word index on the LEADING axis
    (leading=True: [w_route, *dkl.shape]) or the TRAILING one ([...,
    w_route])."""
    wi = torch.arange(w_route, dtype=torch.int64, device=dkl.device) * 4
    d = dkl.long()
    nb = (d[None] - wi.reshape((w_route,) + (1,) * d.dim()) if leading
          else d[..., None] - wi).clamp(0, 4)
    # nb = 0 shifts every bit out of the low 32: the mask is 0
    return to_u32_bits((_U32 << ((4 - nb) * 8)) & _U32)


def bucket_size(n: int) -> int:
    """Power-of-two shape bucket."""
    return 1 << max(8, (n - 1).bit_length() if n > 1 else 1)


def pad_template(r: int) -> np.ndarray:
    """One padding column for a cols matrix with r rows: all-0xFF key words
    (sort after every real key — real keys zero-pad their final word),
    PAD_SENTINEL lens, zero ht/wid/flags/ttl."""
    col = np.zeros(r, dtype=np.uint32)
    col[_ROW_KEY_LEN] = PAD_SENTINEL
    col[_ROW_DKL] = PAD_SENTINEL
    col[_ROW_WORDS:] = 0xFFFFFFFF
    return col


def column_stats(cols: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """(is_const[R], first_val[R]) over the real rows of a cols matrix."""
    r = cols.shape[0]
    if n == 0:
        return np.ones(r, bool), np.zeros(r, np.uint32)
    first = cols[:, 0].copy()
    is_const = (cols[:, :n] == first[:, None]).all(axis=1)
    return is_const, first


def pack_cols(slab: KVSlab, n_pad_override: Optional[int] = None,
              w_pad_override: Optional[int] = None
              ) -> Tuple[np.ndarray, int, int, int]:
    """Pack a slab into the contiguous u32 cols matrix (host side).

    Padding rows carry all-0xFF keys (greater than any real key: real keys
    zero-pad their final word) so they sort to the tail.

    n_pad_override / w_pad_override: callers building a composite layout
    (ops/run_merge.py run-major packing) pick their own padded dimensions.
    """
    n = slab.n
    n_pad = n_pad_override if n_pad_override is not None else bucket_size(n)
    w = slab.width_words
    if w_pad_override is not None:
        w_pad = w_pad_override
    else:
        w_pad = 1 << max(2, (w - 1).bit_length() if w > 1 else 1)
    ttl_us = slab.ttl_ms * 1000
    cols = np.empty((_ROW_WORDS + w_pad, n_pad), dtype=np.uint32)
    cols[:, n:] = pad_template(_ROW_WORDS + w_pad)[:, None]
    cols[_ROW_KEY_LEN, :n] = slab.key_len
    cols[_ROW_DKL, :n] = slab.doc_key_len
    cols[_ROW_HT_HI, :n] = slab.ht_hi
    cols[_ROW_HT_LO, :n] = slab.ht_lo
    cols[_ROW_WID, :n] = slab.write_id
    cols[_ROW_FLAGS, :n] = slab.flags
    cols[_ROW_TTL_HI, :n] = (ttl_us >> 20).astype(np.uint32)
    cols[_ROW_TTL_LO, :n] = (ttl_us & 0xFFFFF).astype(np.uint32)
    cols[_ROW_WORDS: _ROW_WORDS + w, :n] = slab.key_words.T
    cols[_ROW_WORDS + w:, :n] = 0
    return cols, n, n_pad, w_pad


def full_sort_sequence(w: int) -> list:
    """The complete LSD radix schedule for key width w (least-sig first):
    write_id, ht_lo, ht_hi (descending), key_len, key words w-1..0."""
    return [_ROW_WID, _ROW_HT_LO, _ROW_HT_HI, _ROW_KEY_LEN] + \
        [_ROW_WORDS + j for j in range(w - 1, -1, -1)]


def build_sort_schedule(w: int, is_const: np.ndarray
                        ) -> Tuple[np.ndarray, int]:
    """Prune constant columns from the radix schedule (host side): a column
    identical across all real rows carries no ordering information.
    Returns (sort_rows padded with 0 to 4+w, n_sort)."""
    full = full_sort_sequence(w)
    used = [row for row in full if not is_const[row]]
    n_sort = len(used)
    padded = np.asarray(used + [0] * (len(full) - n_sort), dtype=np.int32)
    return padded, n_sort


@dataclass
class StagedCols:
    """A slab's key columns staged on the device: int32 [8+w, n_pad].

    sort_rows / n_sort: the radix schedule of the scan and of
    merge_and_gc_device (build_sort_schedule over col_const; the full
    schedule when the stats are absent). vals_dev: the pushdown's value
    words (ops/scan.pack_vals, int32 [1+VAL_WORDS, n_pad]) when the cache
    staged them beside the cols."""
    cols_dev: torch.Tensor
    n: int
    n_pad: int
    w: int
    col_const: Optional[np.ndarray] = None   # is_const per row (real rows)
    col_first: Optional[np.ndarray] = None   # first value per row
    sort_rows: Optional[np.ndarray] = None
    n_sort: int = 0
    vals_dev: Optional[torch.Tensor] = None

    @property
    def nbytes(self) -> int:
        """Device bytes of the staged matrices (the cache's accounting)."""
        n = self.cols_dev.numel() * 4
        if self.vals_dev is not None:
            n += self.vals_dev.numel() * 4
        return n

    def __post_init__(self):
        if self.sort_rows is None:
            const = (self.col_const if self.col_const is not None
                     else np.zeros(_ROW_WORDS + self.w, dtype=bool))
            self.sort_rows, self.n_sort = build_sort_schedule(self.w, const)


def stage_slab(slab: KVSlab, device=None) -> StagedCols:
    """Pack a slab on the host and upload it once (cuda unless the caller
    passes device='cpu')."""
    dev = torch_setup.resolve_device(device)
    cols, n, n_pad, w = pack_cols(slab)
    is_const, first = column_stats(cols, n)
    count_key_col_upload()
    return StagedCols(u32_to_device(cols, dev), n, n_pad, w, is_const, first)


# --------------------------------------------------------------------------
# The radix merge + GC (merge_gc.py:181-405 of the JAX package): kernel G
# sorts, kernel I.1 gathers the sorted payload, kernel B runs the GC and
# packs. Pad rows are never kept (kernel B masks PAD_SENTINEL rows); every
# caller of the JAX functions masks them with `perm < n` anyway.


def sort_and_gc(cols: torch.Tensor, params: GCParams, w: int,
                sort_rows=None, n_sort: Optional[int] = None,
                snapshot: bool = False):
    """Radix merge + GC over one cols matrix int32 [8+w, n_pad]: kernel G
    sorts, kernel I.1 gathers the sorted payload, kernel B decides.

    Returns (perm, keep, make_tombstone, p_mat, packed) on the device of
    `cols`; the first three are the JAX function's: perm int32 [n_pad]
    (input index of each merged position), keep and make_tombstone bool
    [n_pad] over the merged order. p_mat is kernel B's input (the sorted
    matrix, perm as its last row; the scan's bound mask reads its key
    words) and packed B's int32 [n_pad/32, 2] bit-packed keep and
    make_tombstone. sort_rows/n_sort: the pruned schedule (None: the full
    schedule). snapshot: scan mode, the cutoff is a read time (see
    gc_over_sorted)."""
    if sort_rows is None:
        sort_rows, n_sort = np.asarray(full_sort_sequence(w)), 4 + w
    perm = radix.radix_sort(cols, sort_rows, n_sort)       # kernel G
    p_mat = radix.sorted_payload(cols, perm)               # kernel I.1
    packed, keep, mk = gc_pack(p_mat, _ROW_WORDS + w, w, params, 1,
                               cols.shape[1], snapshot)    # kernel B
    return perm, keep, mk, p_mat, packed


def _merge_gc_fused(cols: torch.Tensor, sort_rows, n_sort: int,
                    params: GCParams, w: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(perm, packed keep, packed make_tombstone) of the compaction-mode
    radix merge + GC: int32 [n_pad], [n_pad/32], [n_pad/32]."""
    perm, _keep, _mk, _p_mat, packed = sort_and_gc(cols, params, w,
                                                   sort_rows, n_sort)
    return perm, packed[:, 0], packed[:, 1]


def _unpack_bits(packed: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(packed).view(np.uint8),
                         bitorder="little")[:n].astype(bool)


def merge_and_gc_device(slab: Optional[KVSlab], params: GCParams,
                        device=None, staged: Optional[StagedCols] = None
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The radix merge + GC of one slab (skewed picks; any input order) on
    `device` (cuda unless the caller passes device='cpu').

    Returns (perm, keep, make_tombstone) as host arrays of the padded
    length n_pad; padding rows sort after all real rows and have
    keep=False. staged: a slab already on the device (skips the pack and
    upload)."""
    if staged is None:
        if slab.n == 0:
            z = np.zeros(0, dtype=np.int32)
            zb = np.zeros(0, dtype=bool)
            return z, zb, zb
        staged = stage_slab(slab, device)
    perm, keep_p, mk_p = _merge_gc_fused(staged.cols_dev, staged.sort_rows,
                                         staged.n_sort, params, staged.w)
    perm = perm.cpu().numpy()
    keep = _unpack_bits(keep_p.cpu().numpy(), staged.n_pad) & (perm < staged.n)
    mk = _unpack_bits(mk_p.cpu().numpy(), staged.n_pad)
    return perm, keep, mk
