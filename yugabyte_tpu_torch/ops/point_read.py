"""Batched point reads on the device: FNV hash, bloom probe, locate +
gather, and the learned-index fit.

Counterpart of yugabyte_tpu/ops/point_read.py. The SST half of a batch of
point reads (`storage/db.DB.multi_get`) runs as four CUDA kernels in
csrc/point_read.cu, each beside its plain PyTorch version:

  P1 `fnv64` (replaces `_fnv64_fused`, :150): FNV-1a-64 over the doc-key
     prefix of every query, as (h1, h2) = (low word, high word | 1), the
     twin of storage/bloom.fnv64_masked;
  P2 `bloom_probe` (replaces `_bloom_probe_fused`, :171): the double-
     hashed probe of one SST's bloom bits for the whole batch;
  P3 `locate_gather` (replaces `_locate_gather_fused`, :317): per query a
     binary seek over the staged cols [8+w, n_pad] to the first entry
     with key == q and ht <= read_ht, then the gather of its (ht, wid);
     optionally inside the window of a learned per-SST index, with the
     search invariant checked on both sides so that a misprediction is
     flagged (`miss`) and never picks another entry;
  P4 `index_fit` (replaces `_index_fit_fused`, :257): the learned index
     over staged cols (prefix skip p, 17 exact anchor limbs, max_err
     measured with the inference arithmetic).

Device matrices are int32 tensors holding u32 bits. On a CPU tensor a
wrapper runs its plain version; on a CUDA tensor it launches its kernel
or raises. Each wrapper counts its launches in `<wrapper>.launches`.

Host wrappers (`pack_query_batch`, `bloom_device_words`, `hash_batch`,
`probe_bloom`, `locate_batch`, `fit_learned_index_device`) follow the
JAX module; `probe_bloom` and `locate_batch` download their result per
SST, as the JAX ones do. Not ported yet (ROADMAP queue A: health-board
routing and device-fault containment):
`device_faults.maybe_fault`, `record_kernel_dispatch`,
`prewarm_point_read`, `point_read_snapshot`; `point_read_metrics()` is a
dict of plain module counters.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from yugabyte_tpu_torch.ops.merge_gc import (
    _ROW_HT_HI, _ROW_HT_LO, _ROW_KEY_LEN, _ROW_WID, _ROW_WORDS, _U32,
    StagedCols, _u, bucket_size, to_u32_bits, u32_to_device)
from yugabyte_tpu_torch.storage.learned_index import (
    LINDEX_MAX_ERR, LINDEX_MAX_P, LINDEX_MIN_ENTRIES, LINDEX_SEGMENTS)
from yugabyte_tpu_torch.utils import torch_setup

# the learned window is resolved in _LG_WINDOW halvings: 2*err+1 < 2^15
_LG_WINDOW = 15
assert LINDEX_MAX_ERR == (1 << (_LG_WINDOW - 1)) - 2

_K_MAX = 12                 # BloomFilterBuilder clamps k to [1, 12]
# the probe arithmetic needs h1 + i*h2 < 2^36 and positions < 2^28
BLOOM_PROBE_MAX_BITS = 1 << 28

BATCH_BUCKETS = (64, 1024)

_FNV_OFFSET_HI = 0xCBF29CE4
_FNV_OFFSET_LO = 0x84222325
# FNV prime 0x100000001B3 = 2^40 + 0x1B3; the multiply below decomposes
# h*P mod 2^64 into shift/add limbs so no intermediate needs 64 bits
_FNV_PRIME_LOW = 0x1B3

_METRICS = {"batches": 0, "keys": 0, "bloom_skips": 0, "learned_hits": 0,
            "learned_fallbacks": 0}


def point_read_metrics() -> dict:
    """Process-wide batched-read counters (plain ints; the JAX package's
    registry metrics come with ROADMAP queue A: health-board routing and
    device-fault containment): batches and keys through
    the device path, per-SST locates skipped by the bloom, locates seeded
    by a learned index, and keys re-resolved exactly after a learned-index
    misprediction."""
    return _METRICS


def count(name: str, n: int = 1) -> None:
    _METRICS[name] += n


def batch_bucket(n: int) -> int:
    """Padded batch size: a two-point lattice, as the JAX package's."""
    return BATCH_BUCKETS[0] if n <= BATCH_BUCKETS[0] else BATCH_BUCKETS[1]


def _mul64_by_prime(hi: torch.Tensor, lo: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) * 0x100000001B3 mod 2^64 on int32 tensors holding u32 bits.

    h*P = h*2^40 + h*0x1B3 (mod 2^64): h*2^40 contributes (lo << 8) to the
    high limb; h*0x1B3 goes through a 16-bit split of `lo` so no partial
    product exceeds 2^25. The limbs are widened to int64 and every sum is
    wrapped to 32 bits, as u32 arithmetic wraps."""
    hi, lo = _u(hi), _u(lo)
    p = _FNV_PRIME_LOW
    t = (lo >> 16) * p                      # < 2^25
    u = (lo & 0xFFFF) * p                   # < 2^25
    s1 = (t << 16) & _U32
    new_lo = (s1 + u) & _U32
    carry = (new_lo < s1).long()
    new_hi = (((lo << 8) & _U32) + hi * p + (t >> 16) + carry) & _U32
    return to_u32_bits(new_hi), to_u32_bits(new_lo)


# ---------------------------------------------------------------------------
# Plain versions (the JAX arithmetic on int32 tensors holding u32 bits)
# ---------------------------------------------------------------------------

def fnv64_plain(qwords: torch.Tensor, qlens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FNV-1a over the first qlens[i] bytes of each query's big-endian key
    words qwords [B, w]. Returns (h1, h2) [B]: h1 = low word, h2 = high
    word | 1."""
    b, w = qwords.shape
    dev = qwords.device
    hi = torch.full((b,), _FNV_OFFSET_HI, dtype=torch.int64, device=dev)
    lo = torch.full((b,), _FNV_OFFSET_LO, dtype=torch.int64, device=dev)
    qw, ql = _u(qwords), qlens.long()
    for j in range(w * 4):
        byte = (qw[:, j // 4] >> (8 * (3 - j % 4))) & 0xFF
        nhi, nlo = _mul64_by_prime(hi, lo ^ byte)
        active = ql > j
        hi = torch.where(active, _u(nhi), hi)
        lo = torch.where(active, _u(nlo), lo)
    return to_u32_bits(lo), to_u32_bits(hi | 1)


def bloom_probe_plain(h1: torch.Tensor, h2: torch.Tensor,
                      bloom_words: torch.Tensor, m_bits: int, k: int
                      ) -> torch.Tensor:
    """Double-hashed probe: bit (h1 + i*h2) % m_bits of the little-endian
    bit words for i < k, every intermediate < 2^32 by the modular
    identity ((h1%m) + (i*(h2%m)) % m) % m. Returns bool [B]."""
    m = int(m_bits)
    h1m, h2m = _u(h1) % m, _u(h2) % m
    words = _u(bloom_words)
    ok = torch.ones(h1.shape, dtype=torch.bool, device=h1.device)
    for i in range(min(int(k), _K_MAX)):
        pos = (h1m + (i * h2m) % m) % m
        ok = ok & (((words[pos >> 5] >> (pos & 31)) & 1) == 1)
    return ok


def _ge64(x_hi, x_lo, y_hi, y_lo):
    return (x_hi > y_hi) | ((x_hi == y_hi) & (x_lo >= y_lo))


def _sub64(x_hi, x_lo, y_hi, y_lo):
    """(x - y) as two u32 limbs, wrapping (callers mask x < y)."""
    borrow = (x_lo < y_lo).long()
    return (x_hi - y_hi - borrow) & _U32, (x_lo - y_lo) & _U32


def _f64ish(hi, lo):
    """float32 value of a two-limb difference: hi * 2^32 (exact) + lo."""
    return hi.to(torch.float32) * 4294967296.0 + lo.to(torch.float32)


def _predict_pos(x_hi, x_lo, a_hi, a_lo, anchor_pos):
    """Piecewise-linear position prediction from exact two-limb anchors
    (int64 u32 values; anchor_pos int64 [S+1]). Segment selection and
    differences are integer-exact; float32 only interpolates."""
    seg = torch.zeros(x_hi.shape, dtype=torch.int64, device=x_hi.device)
    for i in range(1, a_hi.shape[0] - 1):
        seg = seg + _ge64(x_hi, x_lo, a_hi[i], a_lo[i]).long()
    a0h, a0l = a_hi[seg], a_lo[seg]
    a1h, a1l = a_hi[seg + 1], a_lo[seg + 1]
    p0 = anchor_pos[seg].to(torch.float32)
    p1 = anchor_pos[seg + 1].to(torch.float32)
    ge0 = _ge64(x_hi, x_lo, a0h, a0l)
    dx = _f64ish(*_sub64(x_hi, x_lo, a0h, a0l))
    da = _f64ish(*_sub64(a1h, a1l, a0h, a0l))
    pos_da = da > 0
    t = torch.where(ge0 & pos_da, dx / torch.where(pos_da, da, 1.0), 0.0)
    t = torch.clamp(t, 0.0, 1.0)
    return p0 + t * (p1 - p0)


def _anchor_positions(n: int, device) -> torch.Tensor:
    return (torch.arange(LINDEX_SEGMENTS + 1, dtype=torch.int64,
                         device=device) * (n - 1)) // LINDEX_SEGMENTS


def index_fit_plain(cols: torch.Tensor, n: int, w: int):
    """The learned index over sorted staged cols [8+w, n_pad]: prefix skip
    p (leading key words shared by entries 0 and n-1, at most
    LINDEX_MAX_P), anchors at (arange(17)*(n-1))//16 as exact limbs of key
    words pp, pp+1 (pp = clip(p, 0, w-2)), and max_err = max over the real
    entries of |round(pred) - i|. Returns (a_hi [17], a_lo [17], p,
    max_err), int32 tensors (p and max_err 0-d)."""
    n_pad = cols.shape[1]
    dev = cols.device
    last = min(max(n - 1, 0), n_pad - 1)
    run = torch.ones((), dtype=torch.int64, device=dev)
    p = torch.zeros((), dtype=torch.int64, device=dev)
    for j in range(min(w - 2, LINDEX_MAX_P)):
        run = run * (cols[_ROW_WORDS + j, 0]
                     == cols[_ROW_WORDS + j, last]).long()
        p = p + run
    pp = torch.clamp(p, 0, w - 2)
    x_hi = _u(cols[_ROW_WORDS + pp])
    x_lo = _u(cols[_ROW_WORDS + 1 + pp])
    anchor_pos = _anchor_positions(n, dev)
    a_hi, a_lo = x_hi[anchor_pos], x_lo[anchor_pos]
    pred = _predict_pos(x_hi, x_lo, a_hi, a_lo, anchor_pos)
    idx = torch.arange(n_pad, dtype=torch.int64, device=dev)
    err = (torch.round(pred).to(torch.int64) - idx).abs()
    max_err = torch.where(idx < n, err, 0).max()
    return (to_u32_bits(a_hi), to_u32_bits(a_lo), p.to(torch.int32),
            max_err.to(torch.int32))


def _seek_pred(cols, i, n: int, qw, ql, rhi: int, rlo: int, w: int,
               trace: Optional[list] = None):
    """P(i) [B]: entry i is at or after the query's seek point — key_i > q,
    or key_i == q with ht_i <= read_ht; P(i) := True for i >= n. Keys
    compare as u32 words, then key_len as u32 (pad columns hold the
    sentinel and compare greater). With `trace`, appends (i, the rows of
    column i the kernel's compare reads [B, 8+w] bool): none for i >= n,
    else the key words up to the first that differs, key_len when every
    word is equal, and the two ht limbs when key_len is equal too."""
    ii = torch.clamp(i, 0, cols.shape[1] - 1)
    g = _u(cols[:, ii])
    gt = torch.zeros(i.shape, dtype=torch.bool, device=i.device)
    eq = torch.ones(i.shape, dtype=torch.bool, device=i.device)
    read = (torch.zeros((i.shape[0], cols.shape[0]), dtype=torch.bool,
                        device=i.device) if trace is not None else None)
    for j in range(w):
        if read is not None:
            read[:, _ROW_WORDS + j] = eq
        c = g[_ROW_WORDS + j]
        gt = gt | (eq & (c > qw[:, j]))
        eq = eq & (c == qw[:, j])
    if read is not None:
        read[:, _ROW_KEY_LEN] = eq
    klen = g[_ROW_KEY_LEN]
    gt = gt | (eq & (klen > ql))
    eq = eq & (klen == ql)
    if read is not None:
        read[:, _ROW_HT_HI] = read[:, _ROW_HT_LO] = eq
        trace.append((ii, read & (i < n)[:, None]))
    hh, hl = g[_ROW_HT_HI], g[_ROW_HT_LO]
    le = (hh < rhi) | ((hh == rhi) & (hl <= rlo))
    return torch.where(i >= n, True, gt | (eq & le))


Model = Tuple[np.ndarray, np.ndarray, np.ndarray, int, int]


def locate_gather_plain(cols: torch.Tensor, n: int, qwords: torch.Tensor,
                        qlens: torch.Tensor, rhi: int, rlo: int,
                        model: Optional[Model], w: int,
                        trace: Optional[list] = None):
    """Batched seek + gather over one staged SST (see locate_gather).
    Exact mode: n_pad.bit_length() halvings of [0, n]. Model mode: 15
    halvings of the learned window [pi - max_err, pi + max_err + 1]
    clipped to [0, n], then the invariant (r == 0 or not P(r-1)) and
    (r == n or P(r)); a lane that fails it is a miss. With `trace`,
    appends per probe and for the gather the (column, rows read) of each
    lane that the kernel reads (see _seek_pred), in the kernel's order:
    the cells the function must move and each lane's load chain."""
    n_pad = cols.shape[1]
    b = qwords.shape[0]
    dev = cols.device
    qw, ql = _u(qwords), _u(qlens)

    def pred(i, active):
        t = [] if trace is not None else None
        p = _seek_pred(cols, i, n, qw, ql, rhi, rlo, w, t)
        if t:
            trace.append((t[0][0], t[0][1] & active[:, None]))
        return p

    if model is not None:
        a_hi, a_lo, anchor_pos, p, max_err = model
        pp = min(max(int(p), 0), w - 2)
        pi = torch.round(_predict_pos(
            qw[:, pp], qw[:, pp + 1],
            torch.as_tensor(np.asarray(a_hi, np.int64), device=dev),
            torch.as_tensor(np.asarray(a_lo, np.int64), device=dev),
            torch.as_tensor(np.asarray(anchor_pos, np.int64), device=dev))
        ).to(torch.int64)
        lo = torch.clamp(pi - int(max_err), 0, n)
        hi = torch.clamp(pi + int(max_err) + 1, 0, n)
        steps = _LG_WINDOW
    else:
        lo = torch.zeros(b, dtype=torch.int64, device=dev)
        hi = torch.full((b,), n, dtype=torch.int64, device=dev)
        steps = int(n_pad).bit_length()
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) >> 1
        pm = pred(mid, active)
        lo = torch.where(active & ~pm, mid + 1, lo)
        hi = torch.where(active & pm, mid, hi)
    r = lo
    if model is not None:
        ok_left = (r == 0) | ~pred(torch.clamp(r - 1, min=0), r > 0)
        ok_right = (r >= n) | pred(r, r < n)
        miss = ~(ok_left & ok_right)
    else:
        miss = torch.zeros(b, dtype=torch.bool, device=dev)
    rr = torch.clamp(r, 0, n_pad - 1)
    g = _u(cols[:, rr])
    eq = torch.ones(b, dtype=torch.bool, device=dev)
    read = (torch.zeros((b, cols.shape[0]), dtype=torch.bool, device=dev)
            if trace is not None else None)
    for j in range(w):
        if read is not None:
            read[:, _ROW_WORDS + j] = eq
        eq = eq & (g[_ROW_WORDS + j] == qw[:, j])
    if read is not None:
        read[:, _ROW_KEY_LEN] = eq
        read[:, _ROW_HT_HI] = read[:, _ROW_HT_LO] = read[:, _ROW_WID] = True
        trace.append((rr, read))
    eq = eq & (g[_ROW_KEY_LEN] == ql)
    hh, hl = g[_ROW_HT_HI], g[_ROW_HT_LO]
    le = (hh < rhi) | ((hh == rhi) & (hl <= rlo))
    hit = (r < n) & eq & le & ~miss
    return (r.to(torch.int32), hit, to_u32_bits(hh), to_u32_bits(hl),
            to_u32_bits(g[_ROW_WID]), miss)


# ---------------------------------------------------------------------------
# Kernel wrappers (csrc/point_read.cu)
# ---------------------------------------------------------------------------

_lib_cache = None


def _lib():
    global _lib_cache
    if _lib_cache is None:
        lib = torch_setup.load_cuda_lib("point_read.cu")
        vp, ci, i64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                            ctypes.c_uint32)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.ybt_point_fnv64.restype = ci
        lib.ybt_point_fnv64.argtypes = [vp, vp, ci, ci, vp, vp, vp]
        lib.ybt_point_bloom.restype = ci
        lib.ybt_point_bloom.argtypes = [vp, vp, vp, u32, ci, ci, vp, vp]
        lib.ybt_point_locate.restype = ci
        lib.ybt_point_locate.argtypes = [vp, i64, ci, vp, vp, ci, ci, u32,
                                         u32, u32p, u32p, i32p, ci, ci, ci,
                                         ci, vp, vp, vp]
        lib.ybt_point_index_fit.restype = ci
        lib.ybt_point_index_fit.argtypes = [vp, i64, ci, ci, vp, vp, vp, vp,
                                            vp]
        _lib_cache = lib
    return _lib_cache


def _check(t: torch.Tensor, shape, what: str) -> None:
    if not t.is_cuda or t.dtype != torch.int32 or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous int32 {shape} CUDA "
                         f"tensor, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def fnv64(qwords: torch.Tensor, qlens: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel P1 wrapper (see fnv64_plain). CPU tensor: the plain version.
    CUDA tensor: csrc/point_read.cu, counted in `fnv64.launches`."""
    if not qwords.is_cuda:
        return fnv64_plain(qwords, qlens)
    b, w = qwords.shape
    _check(qwords, (b, w), "fnv64 qwords")
    _check(qlens, (b,), "fnv64 qlens")
    dev = qwords.device
    h = torch.empty((2, b), dtype=torch.int32, device=dev)
    rc = _lib().ybt_point_fnv64(qwords.data_ptr(), qlens.data_ptr(), b, w,
                                h[0].data_ptr(), h[1].data_ptr(),
                                torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "fnv64")
    fnv64.launches += 1
    return h[0], h[1]


fnv64.launches = 0


def bloom_probe(h1: torch.Tensor, h2: torch.Tensor, bloom_words: torch.Tensor,
                m_bits: int, k: int) -> torch.Tensor:
    """Kernel P2 wrapper (see bloom_probe_plain). CPU tensor: the plain
    version. CUDA tensor: csrc/point_read.cu, counted in
    `bloom_probe.launches`."""
    if not h1.is_cuda:
        return bloom_probe_plain(h1, h2, bloom_words, m_bits, k)
    b = h1.shape[0]
    _check(h1, (b,), "bloom_probe h1")
    _check(h2, (b,), "bloom_probe h2")
    _check(bloom_words, (bloom_words.shape[0],), "bloom_probe words")
    if not 0 < m_bits <= min(32 * bloom_words.shape[0],
                             BLOOM_PROBE_MAX_BITS - 1):
        raise ValueError(f"bloom_probe: m_bits {m_bits} outside (0, "
                         f"min(32 * words, 2^28))")
    dev = h1.device
    ok = torch.empty(b, dtype=torch.bool, device=dev)
    rc = _lib().ybt_point_bloom(h1.data_ptr(), h2.data_ptr(),
                                bloom_words.data_ptr(), int(m_bits), int(k),
                                b, ok.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "bloom_probe")
    bloom_probe.launches += 1
    return ok


bloom_probe.launches = 0


def _locate_launch(cols, n, qwords, qlens, rhi, rlo, model, w):
    """Launch P3: returns its two output buffers, int32 [4, B] (idx,
    ht_hi, ht_lo, wid) and bool [2, B] (hit, miss)."""
    n_pad = cols.shape[1]
    b = qwords.shape[0]
    _check(cols, (_ROW_WORDS + w, n_pad), "locate_gather cols")
    _check(qwords, (b, w), "locate_gather qwords")
    _check(qlens, (b,), "locate_gather qlens")
    if not 0 < n <= n_pad < (1 << 30):
        raise ValueError(f"locate_gather: n {n}, n_pad {n_pad}")
    if model is not None:
        if w < 2:
            raise ValueError("locate_gather: a model needs w >= 2")
        a_hi, a_lo, anchor_pos, p, max_err = model
        steps = _LG_WINDOW
    else:
        a_hi = a_lo = np.zeros(LINDEX_SEGMENTS + 1, np.uint32)
        anchor_pos = np.zeros(LINDEX_SEGMENTS + 1, np.int32)
        p = max_err = 0
        steps = int(n_pad).bit_length()
    a_hi = np.ascontiguousarray(a_hi, dtype=np.uint32)
    a_lo = np.ascontiguousarray(a_lo, dtype=np.uint32)
    anchor_pos = np.ascontiguousarray(anchor_pos, dtype=np.int32)
    if a_hi.shape != (LINDEX_SEGMENTS + 1,) or a_lo.shape != a_hi.shape \
            or anchor_pos.shape != a_hi.shape:
        raise ValueError("locate_gather: model anchors must be [17]")
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    dev = cols.device
    out = torch.empty((4, b), dtype=torch.int32, device=dev)
    flags = torch.empty((2, b), dtype=torch.bool, device=dev)
    rc = _lib().ybt_point_locate(
        cols.data_ptr(), n_pad, n, qwords.data_ptr(), qlens.data_ptr(), b, w,
        rhi & _U32, rlo & _U32, a_hi.ctypes.data_as(u32p),
        a_lo.ctypes.data_as(u32p), anchor_pos.ctypes.data_as(i32p), int(p),
        int(max_err), int(model is not None), steps, out.data_ptr(),
        flags.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "locate_gather")
    locate_gather.launches += 1
    return out, flags


def locate_gather(cols: torch.Tensor, n: int, qwords: torch.Tensor,
                  qlens: torch.Tensor, rhi: int, rlo: int,
                  model: Optional[Model], w: int):
    """Kernel P3 wrapper (see locate_gather_plain). Returns (idx i32, hit
    bool, ht_hi, ht_lo, wid (u32 bits in int32), miss bool), all [B].
    CPU tensor: the plain version. CUDA tensor: csrc/point_read.cu,
    counted in `locate_gather.launches`."""
    if not cols.is_cuda:
        return locate_gather_plain(cols, n, qwords, qlens, rhi, rlo, model,
                                   w)
    out, flags = _locate_launch(cols, n, qwords, qlens, rhi, rlo, model, w)
    return out[0], flags[0], out[1], out[2], out[3], flags[1]


locate_gather.launches = 0


def index_fit(cols: torch.Tensor, n: int, w: int):
    """Kernel P4 wrapper (see index_fit_plain). CPU tensor: the plain
    version. CUDA tensor: csrc/point_read.cu (one launch), counted in
    `index_fit.launches`."""
    if not cols.is_cuda:
        return index_fit_plain(cols, n, w)
    n_pad = cols.shape[1]
    _check(cols, (_ROW_WORDS + w, n_pad), "index_fit cols")
    if w < 2 or not 0 < n <= n_pad < (1 << 30):
        raise ValueError(f"index_fit: w {w}, n {n}, n_pad {n_pad}")
    dev = cols.device
    anchors = torch.empty((2, LINDEX_SEGMENTS + 1), dtype=torch.int32,
                          device=dev)
    scalars = torch.zeros(2, dtype=torch.int32, device=dev)  # p, max_err
    rc = _lib().ybt_point_index_fit(
        cols.data_ptr(), n_pad, n, w, anchors[0].data_ptr(),
        anchors[1].data_ptr(), scalars[0].data_ptr(), scalars[1].data_ptr(),
        torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "index_fit")
    index_fit.launches += 1
    return anchors[0], anchors[1], scalars[0], scalars[1]


index_fit.launches = 0


# ---------------------------------------------------------------------------
# Host wrappers (padding, per-reader bloom residency, downloads)
# ---------------------------------------------------------------------------

def pack_query_batch(keys: Sequence[bytes], w: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a key batch to (batch_bucket(B), w) uint32 words + int32 lens.
    Keys longer than w*4 bytes are truncated in the word matrix but keep
    their true length, so the exact-match compare can never accept them
    (no entry of a w-wide SST has key_len > w*4)."""
    from yugabyte_tpu_torch.ops.slabs import _pad_keys_to_words
    b_pad = batch_bucket(len(keys))
    clipped = [k[: w * 4] for k in keys]
    words, _lens = _pad_keys_to_words(clipped, width_words=w)
    out_w = np.zeros((b_pad, w), dtype=np.uint32)
    out_w[: len(keys)] = words
    out_l = np.zeros(b_pad, dtype=np.int32)
    out_l[: len(keys)] = [len(k) for k in keys]
    return out_w, out_l


def to_device(arr, device) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr
    if arr.dtype == np.uint32:
        return u32_to_device(arr, device)
    return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(device)


def bloom_device_words(reader, device):
    """The SST's bloom bit array as a padded device int32 vector (u32
    bits), cached on the reader per device for its lifetime. Returns
    (words, m_bits, k), or None when the filter is too large for the
    probe arithmetic or empty."""
    dev = torch.device(device)
    cache = reader.__dict__.setdefault("_bloom_dev", {})
    cached = cache.get(str(dev))
    if cached is not None:
        return cached
    bloom = reader.bloom
    if bloom.m_bits >= BLOOM_PROBE_MAX_BITS or bloom.m_bits == 0:
        return None
    words = np.frombuffer(bloom.bits.tobytes(), dtype="<u4")
    padded = np.zeros(bucket_size(len(words)), dtype=np.uint32)
    padded[: len(words)] = words
    cache[str(dev)] = (u32_to_device(padded, dev), int(bloom.m_bits),
                       int(bloom.k))
    return cache[str(dev)]


def hash_batch(qwords, dkls, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """P1 over the doc-key prefix of each padded query (upload + launch)."""
    return fnv64(to_device(qwords, device), to_device(dkls, device))


def probe_bloom(reader, h1: torch.Tensor, h2: torch.Tensor
                ) -> Optional[np.ndarray]:
    """Probe one SST's bloom for the batch (P2 + download); None = no
    usable filter (every key is a maybe — the bloom is advisory)."""
    bd = bloom_device_words(reader, h1.device)
    if bd is None:
        return None
    words, m_bits, k = bd
    return bloom_probe(h1, h2, words, m_bits, k).cpu().numpy()


def locate_batch(staged: StagedCols, qwords, qlens, read_ht_value: int,
                 model_ops: Optional[Model] = None):
    """P3 over one staged SST, then the download. qwords/qlens: numpy or
    tensors on the staged matrix's device. model_ops: (a_hi, a_lo,
    anchor_pos, p, max_err) from storage/learned_index.model_operands, or
    None for the exact full seek. Returns numpy (idx, hit, ht_hi u32,
    ht_lo u32, wid u32, miss)."""
    cols = staged.cols_dev
    args = (cols, staged.n, to_device(qwords, cols.device),
            to_device(qlens, cols.device), read_ht_value >> 32,
            read_ht_value & _U32, model_ops, staged.w)
    if cols.is_cuda:
        # two downloads (the kernel's two buffers) instead of six
        out, flags = _locate_launch(*args)
        (idx, hhi, hlo, wid), (hit, miss) = (out.cpu().numpy(),
                                             flags.cpu().numpy())
    else:
        idx, hit, hhi, hlo, wid, miss = (
            x.numpy() for x in locate_gather_plain(*args))
    return (idx, hit, hhi.view(np.uint32), hlo.view(np.uint32),
            wid.view(np.uint32), miss)


def fit_learned_index_device(staged: StagedCols) -> Optional[dict]:
    """Fit the learned index over an already-staged cols matrix (P4).
    Returns the persistable model dict, or None when the span is too
    small or the bound too loose to help."""
    from yugabyte_tpu_torch.storage import learned_index
    if staged.n < LINDEX_MIN_ENTRIES or staged.w < 2:
        return None
    a_hi, a_lo, p, max_err = index_fit(staged.cols_dev, staged.n, staged.w)
    return learned_index.finish_model(
        a_hi.cpu().numpy().view(np.uint32), a_lo.cpu().numpy().view(np.uint32),
        int(p), int(max_err), staged.n)
