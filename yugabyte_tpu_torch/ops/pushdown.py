"""The query pushdown's device work after snapshot resolution: the wrappers
of kernels J (J.1 `row_flags`, J.2 `segment_or`, J.3 `row_pass_pack`) and
K (`agg_reduce`), all in csrc/pushdown.cu, each with its plain twin.

Counterpart of yugabyte_tpu/ops/scan.py `_pushdown_base`'s structural
tail (:522-542), `_row_pass` (:545), `_segment_any` (:435),
`_doc_segments` (:445), `_key_byte_at` (:470), `_cmp_words` (:481), the
packing of `_scan_filtered_fused` (:606) and the reductions of
`_scan_agg_fused` (:651-695). The kernels' inputs are kernel B's: the
sorted matrix s (rows key_len | dkl | ... | key words), B's keep bytes,
and the sorted value words sv ([>= 4, n]: the payload byte length, then
the first 12 payload bytes as big-endian words).

J.1's per-entry flag word:
    bits 0-3  predicate slot k matches on this entry
    bit  4    row liveness (base and a bare doc key or a column key)
    bits 5-6  aggregate slot c qualifies on this entry
    bit  7    base (kept by B, a real row, inside the bounds)
    bit  8    the entry starts a document
J.2 ORs bits 0-4 over each document segment; J.3 and K read a row's
verdict from that OR. The plain versions repeat the JAX arithmetic on
int32 tensors holding u32 bits, widened to int64 (`_u`) wherever the
unsigned order matters. On a CPU tensor a wrapper runs its plain version;
on a CUDA tensor it launches its kernel or raises.

Predicate operands are the 7-tuple of ops/scan.py `_pack_predicate_operands`
(p_sub, p_op, p_neg, p_tag_a, p_tag_b, p_words [p, 3], p_len), aggregate
operands the 3-tuple of `_pack_agg_operands` (a_sub, a_tag_a, a_tag_b);
bounds the 6-tuple (lo_words, lo_len, hi_words, hi_len, up_inf,
up_trunc).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from yugabyte_tpu_torch.ops import key_bounds
from yugabyte_tpu_torch.ops.merge_gc import (
    _ROW_DKL, _ROW_KEY_LEN, _ROW_WORDS, _U32, PAD_SENTINEL, _u,
    pack_bits_u32)
from yugabyte_tpu_torch.utils import torch_setup

VAL_WORDS = 3
MAX_PRED, MAX_AGG = 4, 2
LIVE_BIT, BASE_BIT, NEW_DOC_BIT = 4, 7, 8
_AGG_BIT0 = 5
_SEG_BITS = 5                       # bits 0-4 are OR'ed over a document
_ACC_PER_SLOT = 9                   # nonnull, 8 byte sums
_TAG_COLUMN_ID = 0x4B               # ValueType.kColumnId
_TAG_SYS_COLUMN_ID = 0x4A           # ValueType.kSystemColumnId
# entries a CTA of kernel J.2 takes (csrc/pushdown.cu kSegTile)
SEGMENT_OR_TILE = 2048

Bounds = Tuple[np.ndarray, int, np.ndarray, int, bool, bool]


def _cmp_words(v_words, v_len, b_words, b_len: int):
    """Lexicographic (u32 words, int32 byte length) compare of per-entry
    word rows (int64, unsigned values) against one bound: (lt, eq)."""
    n = v_len.shape[0]
    lt = torch.zeros(n, dtype=torch.bool, device=v_len.device)
    eq = torch.ones(n, dtype=torch.bool, device=v_len.device)
    for j in range(len(b_words)):
        bw = int(b_words[j])
        lt = lt | (eq & (v_words[j] < bw))
        eq = eq & (v_words[j] == bw)
    lt = lt | (eq & (v_len < int(b_len)))
    eq = eq & (v_len == int(b_len))
    return lt, eq


def _key_byte_at(words, off, w: int):
    """Byte of the packed big-endian key at a per-entry byte offset; 0
    outside the w words (off is int64, arithmetic shifts as int32)."""
    wi = off >> 2
    sh = (3 - (off & 3)) * 8
    b = torch.zeros_like(off)
    for j in range(w):
        b = torch.where(wi == j, words[j], b)
    return (b >> sh) & 0xFF


def _int32_wrap(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & _U32) - (1 << 31)


def row_flags_plain(s: torch.Tensor, keep: torch.Tensor,
                    sv: Optional[torch.Tensor], w: int, bounds: Bounds,
                    p_ops, a_ops=None) -> torch.Tensor:
    """Plain PyTorch version of kernel J.1: the flag word of every entry
    (see the module docstring), int32 [n]. sv None: no value words, so no
    predicate or aggregate bits."""
    lo_w, lo_l, hi_w, hi_l, up_inf, up_trunc = bounds
    s_len_u = _u(s[_ROW_KEY_LEN])
    s_len = s[_ROW_KEY_LEN].long()          # int32, as the JAX function
    s_dkl = s[_ROW_DKL].long()
    words = _u(s[_ROW_WORDS:_ROW_WORDS + w])
    lo_lt, _ = _cmp_words(words, s_len, lo_w, lo_l)
    hi_lt, hi_eq = _cmp_words(words, s_len, hi_w, hi_l)
    in_hi = (hi_lt | hi_eq) if up_trunc else hi_lt
    if up_inf:
        in_hi = torch.ones_like(in_hi)
    base = keep.bool() & (s_len_u != PAD_SENTINEL) & ~lo_lt & in_hi
    # document starts: dkl-masked key words against the previous lane
    word_idx = torch.arange(w, device=s.device)[:, None]
    nbytes = (s_dkl[None, :] - word_idx * 4).clamp(0, 4)
    mask = torch.where(nbytes == 0, 0,
                       (torch.full_like(nbytes, _U32) << ((4 - nbytes) * 8))
                       & _U32)
    doc_words = words & mask
    new_doc = torch.ones_like(base)
    new_doc[1:] = ~((doc_words[:, 1:] == doc_words[:, :-1]).all(dim=0)
                    & (s_dkl[1:] == s_dkl[:-1]))
    sub_len = _int32_wrap(s_len - s_dkl)
    b0 = _key_byte_at(words, s_dkl, w)
    b1 = _key_byte_at(words, s_dkl + 1, w)
    b2 = _key_byte_at(words, s_dkl + 2, w)
    sub3 = (b0 << 16) | (b1 << 8) | b2
    is_len3 = sub_len == 3
    is_colkey = is_len3 & ((b0 == _TAG_COLUMN_ID) | (b0 == _TAG_SYS_COLUMN_ID))
    flags = ((base & ((s_len == s_dkl) | is_colkey)).long() << LIVE_BIT) \
        | (base.long() << BASE_BIT) | (new_doc.long() << NEW_DOC_BIT)
    if sv is not None:
        v_len = sv[0].long()
        v_words = _u(sv[1:1 + VAL_WORDS])
        tag = v_words[0] >> 24
        p_sub, p_op, _p_neg, p_ta, p_tb, p_words, p_len = p_ops
        for k in range(len(p_op)):
            lt, eq = _cmp_words(v_words, v_len, p_words[k], p_len[k])
            m = {1: eq, 2: ~eq, 3: lt, 4: lt | eq,
                 5: ~(lt | eq)}.get(int(p_op[k]), ~lt)
            tag_ok = (tag == int(p_ta[k])) | (tag == int(p_tb[k]))
            match = base & is_len3 & (sub3 == int(p_sub[k])) & tag_ok & m
            flags = flags | (match.long() << k)
        if a_ops is not None:
            a_sub, a_ta, a_tb = a_ops
            for c in range(len(a_sub)):
                aq = base & is_len3 & (sub3 == int(a_sub[c])) \
                    & ((tag == int(a_ta[c])) | (tag == int(a_tb[c])))
                flags = flags | (aq.long() << (_AGG_BIT0 + c))
    return flags.to(torch.int32)


def segment_or_plain(flags: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel J.2: bits 0-4 of the flag words
    OR'ed over each document segment (the JAX `_segment_any` per bit),
    int32 [n]. Lanes before the first start flag form a segment of their
    own, as in the JAX scans."""
    f = flags.long()
    starts = (f >> NEW_DOC_BIT) & 1
    starts[0] = 1
    seg = torch.cumsum(starts, 0) - 1
    nseg = int(seg[-1]) + 1
    out = torch.zeros_like(f)
    for b in range(_SEG_BITS):
        cnt = torch.zeros(nseg, dtype=torch.long, device=f.device) \
            .index_add_(0, seg, (f >> b) & 1)
        out = out | ((cnt > 0).long()[seg] << b)
    return out.to(torch.int32)


def _row_pass(seg: torch.Tensor, p_op, p_neg) -> torch.Tensor:
    """AND over active slots of the slot's segment bit, negated where
    p_neg is set (the two NULL contracts share one kernel)."""
    rowpass = torch.ones(seg.shape[0], dtype=torch.bool, device=seg.device)
    for k, (code, neg) in enumerate(zip(p_op, p_neg)):
        if int(code):
            passed = ((seg >> k) & 1).bool()
            rowpass = rowpass & (~passed if int(neg) else passed)
    return rowpass


def row_pass_pack_plain(flags: torch.Tensor, seg_or: torch.Tensor, p_op,
                        p_neg) -> torch.Tensor:
    """Plain PyTorch version of kernel J.3: keep = base AND the row's
    verdict, packed little-endian into int32 [n/32]."""
    f = flags.long()
    keep = ((f >> BASE_BIT) & 1).bool() & _row_pass(seg_or.long(), p_op, p_neg)
    return pack_bits_u32(keep, f.shape[0])


def agg_reduce_plain(flags: torch.Tensor, seg_or: torch.Tensor,
                     sv: Optional[torch.Tensor], p_op, p_neg, c: int,
                     c_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel K over the first c aggregate slots
    (c = 0 without value words). Returns (acc int32 [1 + 9 c_pad] u32
    bits: the row count, then per slot nonnull and the 8 byte sums;
    ext int64 [2 c_pad] u64 bits: per slot min and max of the payload's
    (hi, lo) limbs; slots >= c are zero), the JAX two-step min/max."""
    f, seg = flags.long(), seg_or.long()
    rowpass = _row_pass(seg, p_op, p_neg)
    acc = [0] * (1 + _ACC_PER_SLOT * c_pad)
    ext = [0] * (2 * c_pad)
    acc[0] = int((((f >> NEW_DOC_BIT) & 1).bool()
                  & ((seg >> LIVE_BIT) & 1).bool() & rowpass).sum())
    if c:
        v0, v1, v2 = (_u(sv[1 + j]) for j in range(VAL_WORDS))
        hi = ((v0 & 0xFFFFFF) << 8) | (v1 >> 24)
        lo = ((v1 << 8) & _U32) | (v2 >> 24)
        byte_rows = [(v0 >> 16) & 0xFF, (v0 >> 8) & 0xFF, v0 & 0xFF, v1 >> 24,
                     (v1 >> 16) & 0xFF, (v1 >> 8) & 0xFF, v1 & 0xFF, v2 >> 24]
    for slot in range(c):
        qual = ((f >> (_AGG_BIT0 + slot)) & 1).bool() & rowpass
        a0 = 1 + _ACC_PER_SLOT * slot
        acc[a0] = int(qual.sum())
        for j, b in enumerate(byte_rows):
            acc[a0 + 1 + j] = int(torch.where(qual, b, 0).sum()) & _U32
        min_hi = int(torch.where(qual, hi, _U32).min())
        min_lo = int(torch.where(qual & (hi == min_hi), lo, _U32).min())
        max_hi = int(torch.where(qual, hi, 0).max())
        max_lo = int(torch.where(qual & (hi == max_hi), lo, 0).max())
        ext[2 * slot] = (min_hi << 32) | min_lo
        ext[2 * slot + 1] = (max_hi << 32) | max_lo
    dev = flags.device
    acc_t = torch.tensor([x - (1 << 32) if x >> 31 else x for x in acc],
                         dtype=torch.int32, device=dev)
    ext_t = torch.tensor([x - (1 << 64) if x >> 63 else x for x in ext],
                         dtype=torch.int64, device=dev)
    return acc_t, ext_t


def decode_agg(acc: torch.Tensor, ext: torch.Tensor, c_pad: int):
    """K's outputs as the JAX function's (rows_count, nonnull [c],
    byte sums [c, 8], min_hi, min_lo, max_hi, max_lo [c]) host arrays."""
    a = acc.cpu().numpy().view(np.uint32).astype(np.int64)
    e = ext.cpu().numpy().view(np.uint64)
    slots = a[1:1 + _ACC_PER_SLOT * c_pad].reshape(c_pad, _ACC_PER_SLOT)
    mins, maxs = e[0::2], e[1::2]
    return (int(a[0]), slots[:, 0], slots[:, 1:],
            (mins >> np.uint64(32)).astype(np.int64),
            (mins & np.uint64(_U32)).astype(np.int64),
            (maxs >> np.uint64(32)).astype(np.int64),
            (maxs & np.uint64(_U32)).astype(np.int64))


# --------------------------------------------------------------------------
# The kernels (csrc/pushdown.cu)


def _ops_array(p_ops, a_ops=None) -> np.ndarray:
    """The kernels' host operand array (csrc/pushdown.cu `unpack_ops`)."""
    out = np.zeros(6 * MAX_PRED + MAX_PRED * VAL_WORDS + 3 * MAX_AGG,
                   dtype=np.uint32)
    p_sub, p_op, p_neg, p_ta, p_tb, p_words, p_len = p_ops
    p = len(p_op)
    for i, arr in enumerate((p_sub, p_op, p_neg, p_ta, p_tb, p_len)):
        out[i * MAX_PRED:i * MAX_PRED + p] = \
            np.asarray(arr, dtype=np.int64).astype(np.uint32)
    w0 = 6 * MAX_PRED
    out[w0:w0 + p * VAL_WORDS] = np.asarray(p_words, np.uint32).reshape(-1)
    if a_ops is not None:
        a0 = w0 + MAX_PRED * VAL_WORDS
        for i, arr in enumerate(a_ops):
            out[a0 + i * MAX_AGG:a0 + i * MAX_AGG + len(arr)] = arr
    return out


_lib_cache = None


def _lib():
    global _lib_cache
    if _lib_cache is None:
        lib = torch_setup.load_cuda_lib("pushdown.cu")
        u32p = ctypes.POINTER(ctypes.c_uint32)
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.ybt_pushdown_ops_len.restype = ci
        lib.ybt_pushdown_ops_len.argtypes = []
        lib.ybt_key_bounds_size.restype = ci
        lib.ybt_key_bounds_size.argtypes = []
        key_bounds.check_layout(lib)
        lib.ybt_row_flags.restype = ci
        lib.ybt_row_flags.argtypes = [vp, i64, ci, vp, vp,
                                      ctypes.POINTER(key_bounds.KeyBounds),
                                      ci, ci, ci, u32p, ci, ci, vp, vp]
        lib.ybt_segment_or_tile.restype = ci
        lib.ybt_segment_or_tile.argtypes = []
        lib.ybt_segment_or.restype = ci
        lib.ybt_segment_or.argtypes = [vp, i64, vp, vp, vp]
        lib.ybt_row_pass_pack.restype = ci
        lib.ybt_row_pass_pack.argtypes = [vp, vp, i64, ctypes.c_uint32,
                                          ctypes.c_uint32, vp, vp]
        lib.ybt_agg_reduce_scratch_bytes.restype = i64
        lib.ybt_agg_reduce_scratch_bytes.argtypes = []
        lib.ybt_agg_reduce.restype = ci
        lib.ybt_agg_reduce.argtypes = [vp, vp, vp, i64, ctypes.c_uint32,
                                       ctypes.c_uint32, ci, ci, vp, vp, vp,
                                       vp]
        if lib.ybt_pushdown_ops_len() != len(_ops_array(_EMPTY_P)):
            raise RuntimeError("pushdown.cu: operand layout differs")
        if lib.ybt_segment_or_tile() != SEGMENT_OR_TILE:
            raise RuntimeError("pushdown.cu: J.2's tile differs")
        _lib_cache = lib
    return _lib_cache


_EMPTY_P = (np.zeros(0), np.zeros(0), np.zeros(0), np.zeros(0), np.zeros(0),
            np.zeros((0, VAL_WORDS)), np.zeros(0))


def _host_ops(p_ops, a_ops=None):
    arr = _ops_array(p_ops, a_ops)
    return (ctypes.c_uint32 * len(arr))(*arr.tolist())


def _check_rows(t: torch.Tensor, rows: int, n: int, what: str) -> None:
    torch_setup.check_u32_matrix(t, what)
    if t.dim() != 2 or t.shape[0] < rows or t.shape[1] != n:
        raise ValueError(f"{what}: expected [>= {rows}, {n}], got "
                         f"{tuple(t.shape)}")


def _check_vec(t: torch.Tensor, n: int, dtype, what: str) -> None:
    if not t.is_cuda or t.dtype != dtype or t.shape != (n,) \
            or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {dtype} [{n}] CUDA "
                         f"tensor, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def row_flags(s: torch.Tensor, keep: torch.Tensor,
              sv: Optional[torch.Tensor], w: int, bounds: Bounds, p_ops,
              a_ops=None) -> torch.Tensor:
    """Kernel J.1 wrapper (see row_flags_plain). CPU tensor: the plain
    version. CUDA tensor: csrc/pushdown.cu, one launch with the bounds in
    its parameters (ops/key_bounds.py), counted in `row_flags.launches`;
    n a multiple of 32, s and sv 16-byte aligned, keep 4-byte aligned
    (the kernel reads 16-byte vectors)."""
    if not s.is_cuda:
        return row_flags_plain(s, keep, sv, w, bounds, p_ops, a_ops)
    n = s.shape[1]
    _check_rows(s, _ROW_WORDS + w, n, "row_flags")
    _check_vec(keep, n, torch.bool, "row_flags keep")
    if sv is not None:
        _check_rows(sv, 1 + VAL_WORDS, n, "row_flags sv")
    p = len(p_ops[1])
    c = 0 if a_ops is None else len(a_ops[0])
    if p > MAX_PRED or c > MAX_AGG or n % 32:
        raise ValueError(f"row_flags: {p} predicate / {c} aggregate slots, "
                         f"n={n} (a multiple of 32)")
    if s.data_ptr() % 16 or keep.data_ptr() % 4 \
            or (sv is not None and sv.data_ptr() % 16):
        raise ValueError("row_flags: s and sv must start 16-byte aligned, "
                         "keep 4-byte aligned")
    lo_w, lo_l, hi_w, hi_l, up_inf, up_trunc = bounds
    lo_empty = int(lo_l) == 0 and not np.asarray(lo_w, np.uint32).any()
    dev = s.device
    kb, _dev_words = key_bounds.key_bounds(lo_w, lo_l, hi_w, hi_l, w, dev)
    flags = torch.empty(n, dtype=torch.int32, device=dev)
    rc = _lib().ybt_row_flags(
        s.data_ptr(), n, w, keep.data_ptr(),
        None if sv is None else sv.data_ptr(), ctypes.byref(kb),
        int(lo_empty), int(up_inf), int(up_trunc), _host_ops(p_ops, a_ops),
        p, c, flags.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "row_flags")
    row_flags.launches += 1
    return flags


row_flags.launches = 0


def segment_or_layout(n: int) -> Tuple[int, int]:
    """Kernel J.2's one allocation over n entries, in int32 words: the
    output rounded up to 16 bytes, then the scratch the kernel zeroes
    (three 64-bit words per SEGMENT_OR_TILE entries: the forward chain's
    status, the tail chain's status and the tile's record; then the
    ticket). Returns (words before the scratch, words in all)."""
    out = -(-n // 4) * 4
    return out, out + 2 * (3 * -(-n // SEGMENT_OR_TILE) + 1)


def segment_or(flags: torch.Tensor) -> torch.Tensor:
    """Kernel J.2 wrapper (see segment_or_plain). CPU tensor: the plain
    version. CUDA tensor: csrc/pushdown.cu, one launch after one memset of
    its scratch, counted in `segment_or.launches`; flags 16-byte aligned."""
    if not flags.is_cuda:
        return segment_or_plain(flags)
    n = flags.shape[0]
    _check_vec(flags, n, torch.int32, "segment_or")
    if flags.data_ptr() % 16:
        raise ValueError("segment_or: flags must start 16-byte aligned")
    dev = flags.device
    out_words, words = segment_or_layout(n)
    buf = torch.empty(words, dtype=torch.int32, device=dev)
    ptr = buf.data_ptr()
    rc = _lib().ybt_segment_or(flags.data_ptr(), n, ptr + 4 * out_words, ptr,
                               torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "segment_or")
    segment_or.launches += 1
    return buf[:n]


segment_or.launches = 0


def row_pass_pack(flags: torch.Tensor, seg_or: torch.Tensor, p_op,
                  p_neg) -> torch.Tensor:
    """Kernel J.3 wrapper (see row_pass_pack_plain). CPU tensor: the plain
    version. CUDA tensor: csrc/pushdown.cu, one launch and no memset, the
    verdict as K takes it (verdict_masks), counted in
    `row_pass_pack.launches`; n a multiple of 32, flags and seg_or 16-byte
    aligned (the kernel reads 16-byte vectors)."""
    if not flags.is_cuda:
        return row_pass_pack_plain(flags, seg_or, p_op, p_neg)
    n = flags.shape[0]
    _check_vec(flags, n, torch.int32, "row_pass_pack flags")
    _check_vec(seg_or, n, torch.int32, "row_pass_pack seg_or")
    if n % 32 or len(p_op) > MAX_PRED:
        raise ValueError(f"row_pass_pack: n={n} (a multiple of 32), "
                         f"{len(p_op)} slots")
    if flags.data_ptr() % 16 or seg_or.data_ptr() % 16:
        raise ValueError("row_pass_pack: flags and seg_or must start "
                         "16-byte aligned")
    dev = flags.device
    packed = torch.empty(n // 32, dtype=torch.int32, device=dev)
    need, want = verdict_masks(p_op, p_neg)
    rc = _lib().ybt_row_pass_pack(
        flags.data_ptr(), seg_or.data_ptr(), n, need, want, packed.data_ptr(),
        torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "row_pass_pack")
    row_pass_pack.launches += 1
    return packed


row_pass_pack.launches = 0


def verdict_masks(p_op, p_neg) -> Tuple[int, int]:
    """Kernels J.3's and K's row verdict as one masked compare: a row
    passes when (seg & need) == want, which is `_row_pass` (need: the
    active slots, want: those whose segment bit must be set, where p_neg
    is clear)."""
    need = want = 0
    for k, (code, neg) in enumerate(zip(p_op, p_neg)):
        if int(code):
            need |= 1 << k
            if not int(neg):
                want |= 1 << k
    return need, want


# K's scratch, one zeroed buffer per (device, stream): the completion
# ticket, which each launch leaves at 0, and the CTAs' partials
_agg_scratch = {}


def _agg_scratch_for(dev: torch.device) -> torch.Tensor:
    key = (dev.index, torch_setup.stream_ptr(dev))
    buf = _agg_scratch.get(key)
    if buf is None:
        buf = torch.zeros(int(_lib().ybt_agg_reduce_scratch_bytes()),
                          dtype=torch.uint8, device=dev)
        _agg_scratch[key] = buf
    return buf


def agg_reduce(flags: torch.Tensor, seg_or: torch.Tensor,
               sv: Optional[torch.Tensor], p_op, p_neg, c: int,
               c_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K wrapper (see agg_reduce_plain). CPU tensor: the plain
    version. CUDA tensor: csrc/pushdown.cu, one launch, counted in
    `agg_reduce.launches`; n a multiple of 4, flags, seg_or and sv 16-byte
    aligned (the kernel reads 16-byte vectors)."""
    if not flags.is_cuda:
        return agg_reduce_plain(flags, seg_or, sv, p_op, p_neg, c, c_pad)
    n = flags.shape[0]
    _check_vec(flags, n, torch.int32, "agg_reduce flags")
    _check_vec(seg_or, n, torch.int32, "agg_reduce seg_or")
    if c:
        _check_rows(sv, 1 + VAL_WORDS, n, "agg_reduce sv")
    if len(p_op) > MAX_PRED or not 0 <= c <= c_pad <= MAX_AGG or n % 4:
        raise ValueError(f"agg_reduce: {len(p_op)} predicate slots, c={c}, "
                         f"c_pad={c_pad}, n={n} (a multiple of 4)")
    if flags.data_ptr() % 16 or seg_or.data_ptr() % 16 \
            or (c and sv.data_ptr() % 16):
        raise ValueError("agg_reduce: flags, seg_or and sv must start "
                         "16-byte aligned")
    dev = flags.device
    acc = torch.empty(1 + _ACC_PER_SLOT * c_pad, dtype=torch.int32,
                      device=dev)
    ext = torch.empty(2 * c_pad, dtype=torch.int64, device=dev)
    need, want = verdict_masks(p_op, p_neg)
    rc = _lib().ybt_agg_reduce(
        flags.data_ptr(), seg_or.data_ptr(), sv.data_ptr() if c else None, n,
        need, want, c, c_pad, _agg_scratch_for(dev).data_ptr(),
        acc.data_ptr(), ext.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "agg_reduce")
    agg_reduce.launches += 1
    return acc, ext


agg_reduce.launches = 0
