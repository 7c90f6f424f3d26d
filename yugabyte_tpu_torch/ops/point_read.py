"""Batched point reads on the device: FNV hash, bloom probe, locate +
gather, and the learned-index fit.

Counterpart of yugabyte_tpu/ops/point_read.py. The SST half of a batch of
point reads (`storage/db.DB.multi_get`) runs as CUDA kernels in
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
     measured with the inference arithmetic), one launch that writes the
     whole answer as one [36] buffer, which `fit_learned_index_device`
     downloads once.

`DB.multi_get` makes two launches per chunk over every live SST (none for
a chunk with no live SST), through a `FileTable` of the reader set (each
file's bloom, staged cols and learned-index operands; on the card a
descriptor table uploaded once):

  P1 + P2 `hash_probe_files` (the JAX DB's `hash_batch`, then its loop of
     `_bloom_probe_fused` per SST, storage/db.py:881-891): each (lane,
     file) thread of a file with a usable filter hashes the lane's
     doc-key prefix and probes the file; the maybe mask [files, b_pad],
     each file's flag (a real lane passes, or the file has no usable
     filter) and the hashes (h1, h2), which file 0's threads write;
  P3 `locate_fold` (the JAX DB's loop of `_locate_gather_fused` per
     located SST and its newest-wins fold, db.py:895-920): every lane on
     every located file, a learned-index misprediction re-sought exactly
     in the same launch, the fold in file order on the card, and one
     [5, b_pad] buffer with the per-file counters, downloaded once.

The per-query `fnv64`, the per-file `bloom_probe` and `locate_gather` are
the kernels' first designs, off the read path.

Device matrices are int32 tensors holding u32 bits. On a CPU tensor a
wrapper runs its plain version; on a CUDA tensor it launches its kernel
or raises. Each wrapper counts its launches in `<wrapper>.launches`.

Host wrappers (`pack_query_batch`, `bloom_device_words`, `probe_bloom`,
`file_table`, `fit_learned_index_device`) follow the JAX module;
`probe_bloom` probes one SST and downloads its result, as the JAX one
does. `point_read_metrics()` are the JAX package's registry counters,
`point_read_snapshot` its page block, and `prewarm_point_read` launches
the read path's kernels once at the declared buckets. The fault sites
and the health-board gate of the JAX package's per-file locate
(point_read.py:478-487 there) sit around the port's one locate launch a
chunk, in storage/db.DB._device_chunk.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

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

def point_read_metrics():
    """Process-wide batched-read observability (the JAX package's
    registry counters, entity server:point_read): batches and keys
    through the device path, the batch-size histogram, per-SST locates
    skipped by the bloom, locates seeded by a learned index, keys
    re-resolved exactly after a learned-index misprediction, batches
    completed natively after a device fault, and the latest fitted
    model's error bound."""
    from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
    e = ROOT_REGISTRY.entity("server", "point_read")
    return {
        "batches": e.counter(
            "point_read_batches_total",
            "multi_get batches resolved through the device kernels"),
        "keys": e.counter(
            "point_read_batched_keys_total",
            "keys resolved through the batched device path"),
        "batch_rows": e.histogram(
            "point_read_batch_rows",
            "multi_get batch sizes reaching the device path"),
        "bloom_skips": e.counter(
            "point_read_bloom_skipped_sst_total",
            "per-SST locate dispatches skipped because the bloom probe "
            "rejected every key in the batch"),
        "learned_hits": e.counter(
            "point_read_learned_hit_total",
            "locate dispatches that used a learned per-SST index"),
        "learned_fallbacks": e.counter(
            "point_read_learned_fallback_total",
            "keys re-resolved exactly after a learned-index "
            "misprediction beyond the recorded error bound"),
        "device_fallbacks": e.counter(
            "point_read_device_fallback_total",
            "multi_get batches completed via the native per-key path "
            "after a device fault"),
        "max_error": e.gauge(
            "learned_index_max_error_rows",
            "recorded max-error bound (entry positions) of the most "
            "recently fitted learned per-SST index"),
    }


def count(name: str, n: int = 1) -> None:
    point_read_metrics()[name].increment(n)


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


class TableFile(NamedTuple):
    """One live SST as P2 and P3 over every file see it."""
    bloom: Optional[Tuple[torch.Tensor, int, int]]  # (words, m_bits, k)
    cols: torch.Tensor      # staged cols [8 + w, n_pad]
    n: int
    w: int
    model: Optional[Model]  # learned-index operands
    q_off: int              # its queries: qbuf[q_off * b_pad:][:w * b_pad]


# csrc/point_read.cu FileDesc (ybt_point_file_desc_bytes)
_DESC = np.dtype({
    "names": ["words", "cols", "n_pad", "m_bits", "k", "n", "w", "q_off",
              "has_model", "a_hi", "a_lo", "pos", "p", "max_err"],
    "formats": [np.uint64, np.uint64, np.int64, np.uint32, np.int32,
                np.int32, np.int32, np.int32, np.int32,
                (np.uint32, LINDEX_SEGMENTS + 1),
                (np.uint32, LINDEX_SEGMENTS + 1),
                (np.int32, LINDEX_SEGMENTS + 1), np.int32, np.int32],
    "offsets": [0, 8, 16, 24, 28, 32, 36, 40, 44, 48, 116, 184, 252, 256],
    "itemsize": 264})


class FileTable:
    """The live SSTs of a reader set, in file order, for P2 and P3 over
    every file: per file its bloom (None: no usable filter, every lane a
    maybe), staged cols, n, w, learned-index operands (None: the exact
    seek) and the offset of its width's queries in the chunk's query
    buffer (the distinct widths in `widths`, one [b_pad, w] block each).
    On a CUDA device `desc` holds the descriptors on the card (uint8
    [files, 264]), uploaded once; the table keeps every tensor it points
    to alive."""

    def __init__(self, files: Sequence[Tuple], device):
        self.widths: List[int] = []
        for f in files:
            if f[3] not in self.widths:
                self.widths.append(f[3])
        offs = {w: sum(self.widths[:i]) for i, w in enumerate(self.widths)}
        self.files = [TableFile(bloom, cols, n, w,
                                model if w >= 2 else None, offs[w])
                      for bloom, cols, n, w, model in files]
        for f in self.files:
            if not 0 < f.n <= f.cols.shape[1] < (1 << 30):
                raise ValueError(f"FileTable: n {f.n}, n_pad "
                                 f"{f.cols.shape[1]}")
        self.desc = None
        if torch.device(device).type == "cuda" and self.files:
            self.desc = self._pack().to(device)

    def _pack(self) -> torch.Tensor:
        d = np.zeros(len(self.files), dtype=_DESC)
        for i, f in enumerate(self.files):
            if f.bloom is not None:
                words, m_bits, k = f.bloom
                d[i]["words"], d[i]["m_bits"], d[i]["k"] = (
                    words.data_ptr(), m_bits, k)
            d[i]["cols"], d[i]["n_pad"] = f.cols.data_ptr(), f.cols.shape[1]
            d[i]["n"], d[i]["w"], d[i]["q_off"] = f.n, f.w, f.q_off
            if f.model is not None:
                a_hi, a_lo, pos, p, max_err = f.model
                d[i]["has_model"] = 1
                d[i]["a_hi"], d[i]["a_lo"], d[i]["pos"] = a_hi, a_lo, pos
                d[i]["p"], d[i]["max_err"] = p, max_err
        return torch.from_numpy(d.view(np.uint8).reshape(len(self.files),
                                                         _DESC.itemsize))

    def queries(self, chunk: Sequence[bytes]) -> Tuple[np.ndarray, np.ndarray]:
        """The chunk's query buffer (every width's padded [b_pad, w] words,
        one block after the other, flat u32) and its true key lengths."""
        packs = [pack_query_batch(chunk, w) for w in self.widths]
        if not packs:
            return (np.zeros(0, np.uint32),
                    pack_query_batch(chunk, 1)[1])
        return (np.concatenate([qw.reshape(-1) for qw, _ in packs]),
                packs[0][1])

    def file_queries(self, qbuf: torch.Tensor, f: TableFile, b_pad: int
                     ) -> torch.Tensor:
        return qbuf[f.q_off * b_pad:(f.q_off + f.w) * b_pad].view(b_pad, f.w)


def bloom_probe_files_plain(h1: torch.Tensor, h2: torch.Tensor,
                            table: FileTable, b: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """P2 over every file of the table: bloom_probe_plain per file in file
    order. Returns (maybe bool [files, b_pad], flag bool [files]): a file
    without a usable filter is a maybe on every lane; a file's flag is
    whether one of the first b lanes is a maybe."""
    maybe = torch.ones((len(table.files), h1.shape[0]), dtype=torch.bool,
                       device=h1.device)
    for i, f in enumerate(table.files):
        if f.bloom is not None:
            words, m_bits, k = f.bloom
            maybe[i] = bloom_probe_plain(h1, h2, words, m_bits, k)
    return maybe, maybe[:, :b].any(dim=1)


def hash_probe_files_plain(hw: torch.Tensor, dk: torch.Tensor,
                           table: FileTable, b: int):
    """P1 + P2 over every file of the table: fnv64_plain over the doc-key
    words hw [b_pad, w_hash] and lengths dk [b_pad], then
    bloom_probe_files_plain. Returns (maybe bool [files, b_pad], flag bool
    [files], h1, h2 int32 [b_pad] (u32 bits))."""
    h1, h2 = fnv64_plain(hw, dk)
    maybe, flag = bloom_probe_files_plain(h1, h2, table, b)
    return maybe, flag, h1, h2


def locate_fold_plain(table: FileTable, qbuf: torch.Tensor,
                      qlens: torch.Tensor, b: int, rhi: int, rlo: int,
                      model_on: bool, located: torch.Tensor) -> torch.Tensor:
    """P3 over every located file of the table and the newest-wins fold,
    in file order: locate_gather_plain on every lane (learned-index mode
    where the file has a model and model_on), the lanes whose model
    invariant failed taken from an exact locate_gather_plain, then per
    lane the hit with the largest (ht, wid) by a strict compare (a tie
    keeps the earlier file). Returns int32 [5 * b_pad + 2 * files]: rows
    ht_hi, ht_lo, wid (u32 bits), row and file (-1: no hit) of the lane's
    winner (0 where none), then each file's located flag and its count of
    mispredicted lanes among the first b."""
    b_pad = qlens.shape[0]
    dev = qlens.device
    nf = len(table.files)
    best = torch.zeros((4, b_pad), dtype=torch.int64, device=dev)
    bfile = torch.full((b_pad,), -1, dtype=torch.int64, device=dev)
    misses = torch.zeros(nf, dtype=torch.int64, device=dev)
    for i, f in enumerate(table.files):
        if not bool(located[i]):
            continue
        qw = table.file_queries(qbuf, f, b_pad)
        model = f.model if model_on else None
        idx, hit, hh, hl, wid, miss = locate_gather_plain(
            f.cols, f.n, qw, qlens, rhi, rlo, model, f.w)
        if model is not None:
            misses[i] = int(miss[:b].sum())
            if bool(miss.any()):
                exact = locate_gather_plain(f.cols, f.n, qw, qlens, rhi, rlo,
                                            None, f.w)
                idx, hit, hh, hl, wid = (
                    torch.where(miss, e, m) for m, e in
                    zip((idx, hit, hh, hl, wid), exact[:5]))
        hh, hl, wid = _u(hh), _u(hl), _u(wid)
        bh, bl, bw = best[0], best[1], best[2]
        upd = hit & ((bfile < 0) | (hh > bh) | ((hh == bh) & (
            (hl > bl) | ((hl == bl) & (wid > bw)))))
        best = torch.where(upd, torch.stack([hh, hl, wid, idx.long()]), best)
        bfile = torch.where(upd, i, bfile)
    return torch.cat([to_u32_bits(best[:3]).reshape(-1),
                      best[3].to(torch.int32), bfile.to(torch.int32),
                      located.to(torch.int32), misses.to(torch.int32)])


def fold_arrays(out: np.ndarray, b_pad: int, files: int):
    """The host view of one downloaded locate_fold buffer: the fold as the
    sequential host fold leaves it, [ht u64, wid u32, row i64, file i64,
    hit bool] per lane (zeros where no file hit), each file's located
    flag and its mispredicted lanes."""
    u = out.view(np.uint32)
    file_ = out[4 * b_pad:5 * b_pad].astype(np.int64)
    ht = (u[:b_pad].astype(np.uint64) << np.uint64(32)) \
        | u[b_pad:2 * b_pad].astype(np.uint64)
    best = [ht, u[2 * b_pad:3 * b_pad].copy(),
            out[3 * b_pad:4 * b_pad].astype(np.int64),
            np.maximum(file_, 0), file_ >= 0]
    tail = out[5 * b_pad:]
    return best, tail[:files] != 0, tail[files:2 * files].astype(np.int64)


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
        lib.ybt_point_index_fit.argtypes = [vp, i64, ci, ci, vp, vp, vp]
        lib.ybt_point_index_fit_words.restype = ci
        lib.ybt_point_file_desc_bytes.restype = ci
        lib.ybt_point_hash_probe_files.restype = ci
        lib.ybt_point_hash_probe_files.argtypes = [vp, ci, vp, vp, ci, ci, ci,
                                                   vp, vp, vp, vp]
        lib.ybt_point_locate_fold_scratch.restype = i64
        lib.ybt_point_locate_fold_scratch.argtypes = [ci, ci]
        lib.ybt_point_locate_fold.restype = ci
        lib.ybt_point_locate_fold.argtypes = [vp, ci, vp, vp, ci, ci, u32, u32,
                                              ci, vp, vp, vp, vp, vp]
        if lib.ybt_point_file_desc_bytes() != _DESC.itemsize:
            raise RuntimeError("point_read.cu FileDesc is not _DESC")
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
    return out[0], flags[0], out[1], out[2], out[3], flags[1]


locate_gather.launches = 0


def _check_table(table: FileTable, dev) -> None:
    if table.desc is None or table.desc.device != dev:
        raise ValueError(f"FileTable: no descriptors on {dev}")


def hash_probe_files(hw: torch.Tensor, dk: torch.Tensor, table: FileTable,
                     b: int):
    """Kernels P1 + P2 over every file of the table (see
    hash_probe_files_plain). CPU tensor: the plain version. CUDA tensor:
    csrc/point_read.cu, one launch (b_pad <= 1024), counted in
    `hash_probe_files.launches`."""
    if not hw.is_cuda:
        return hash_probe_files_plain(hw, dk, table, b)
    b_pad, w_hash = hw.shape[0], hw.shape[-1]
    _check(hw, (b_pad, w_hash), "hash_probe_files hw")
    _check(dk, (b_pad,), "hash_probe_files dk")
    dev = hw.device
    _check_table(table, dev)
    nf = len(table.files)
    if not (0 < b <= b_pad <= BATCH_BUCKETS[-1] and w_hash > 0):
        raise ValueError(f"hash_probe_files: b {b}, b_pad {b_pad}, w_hash "
                         f"{w_hash}")
    out = torch.empty(8 * b_pad + nf * (b_pad + 1), dtype=torch.uint8,
                      device=dev)
    h = out[:8 * b_pad].view(torch.int32).view(2, b_pad)
    flags = out[8 * b_pad:].view(torch.bool)
    maybe, flag = flags[:nf * b_pad].view(nf, b_pad), flags[nf * b_pad:]
    rc = _lib().ybt_point_hash_probe_files(
        table.desc.data_ptr(), nf, hw.data_ptr(), dk.data_ptr(), w_hash,
        b_pad, b, maybe.data_ptr(), flag.data_ptr(), h.data_ptr(),
        torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "hash_probe_files")
    hash_probe_files.launches += 1
    return maybe, flag, h[0], h[1]


hash_probe_files.launches = 0

# the completion tickets of P3 over every file (word 0) and of P4 (word
# 1), zeroed u32s per (device, stream), which each launch leaves at 0
_tickets = {}
_FOLD_TICKET, _FIT_TICKET = 0, 1


def _ticket_for(dev: torch.device, word: int) -> torch.Tensor:
    key = (dev.index, torch_setup.stream_ptr(dev))
    buf = _tickets.get(key)
    if buf is None:
        buf = torch.zeros(4, dtype=torch.int32, device=dev)
        _tickets[key] = buf
    return buf[word]


def locate_fold(table: FileTable, qbuf: torch.Tensor, qlens: torch.Tensor,
                b: int, rhi: int, rlo: int, model_on: bool,
                located: torch.Tensor) -> torch.Tensor:
    """Kernel P3 + the newest-wins fold over every file of the table (see
    locate_fold_plain). CPU tensor: the plain version. CUDA tensor:
    csrc/point_read.cu, one launch, counted in `locate_fold.launches`."""
    if not qlens.is_cuda:
        return locate_fold_plain(table, qbuf, qlens, b, rhi, rlo, model_on,
                                 located)
    b_pad = qlens.shape[0]
    dev = qlens.device
    _check_table(table, dev)
    nf = len(table.files)
    _check(qbuf, (b_pad * sum(table.widths),), "locate_fold qbuf")
    _check(qlens, (b_pad,), "locate_fold qlens")
    if not located.is_cuda or located.dtype != torch.bool \
            or tuple(located.shape) != (nf,) or not located.is_contiguous():
        raise ValueError("locate_fold: located must be a contiguous bool "
                         f"[{nf}] CUDA tensor")
    if not 0 < b <= b_pad:
        raise ValueError(f"locate_fold: b {b}, b_pad {b_pad}")
    lib = _lib()
    n_out = 5 * b_pad + 2 * nf
    buf = torch.empty(n_out + lib.ybt_point_locate_fold_scratch(nf, b_pad),
                      dtype=torch.int32, device=dev)
    rc = lib.ybt_point_locate_fold(
        table.desc.data_ptr(), nf, qbuf.data_ptr(), qlens.data_ptr(), b_pad,
        b, rhi & _U32, rlo & _U32, int(bool(model_on)), located.data_ptr(),
        buf[n_out:].data_ptr(), _ticket_for(dev, _FOLD_TICKET).data_ptr(),
        buf.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "locate_fold")
    locate_fold.launches += 1
    return buf[:n_out]


locate_fold.launches = 0


# P4's answer, int32: a_hi [17], a_lo [17], p, max_err
_FIT_WORDS = 2 * (LINDEX_SEGMENTS + 1) + 2


def _fit_parts(words):
    """(a_hi, a_lo, p, max_err) of P4's answer (a tensor or an array)."""
    k = LINDEX_SEGMENTS + 1
    return words[:k], words[k:2 * k], words[2 * k], words[2 * k + 1]


def _index_fit_words(cols: torch.Tensor, n: int, w: int) -> torch.Tensor:
    """P4's answer as one int32 [36] tensor (a_hi, a_lo, p, max_err). CPU
    tensor: the plain version's outputs side by side. CUDA tensor: one
    launch of csrc/point_read.cu (no memset, no copy), counted in
    `index_fit.launches`."""
    if not cols.is_cuda:
        a_hi, a_lo, p, max_err = index_fit_plain(cols, n, w)
        return torch.cat([a_hi, a_lo, p.reshape(1), max_err.reshape(1)])
    n_pad = cols.shape[1]
    _check(cols, (_ROW_WORDS + w, n_pad), "index_fit cols")
    if w < 2 or not 0 < n <= n_pad < (1 << 30):
        raise ValueError(f"index_fit: w {w}, n {n}, n_pad {n_pad}")
    dev = cols.device
    lib = _lib()
    out = torch.empty(lib.ybt_point_index_fit_words(), dtype=torch.int32,
                      device=dev)
    rc = lib.ybt_point_index_fit(
        cols.data_ptr(), n_pad, n, w,
        _ticket_for(dev, _FIT_TICKET).data_ptr(), out.data_ptr(),
        torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "index_fit")
    index_fit.launches += 1
    return out[:_FIT_WORDS]


def index_fit(cols: torch.Tensor, n: int, w: int):
    """Kernel P4 wrapper (see index_fit_plain): (a_hi, a_lo, p, max_err).
    CPU tensor: the plain version. CUDA tensor: csrc/point_read.cu, one
    launch, counted in `index_fit.launches`; the four are views of its
    one [36] answer. The staged span must be sorted (as every staged
    SST is): the kernel finds each segment by a binary search."""
    if not cols.is_cuda:
        return index_fit_plain(cols, n, w)
    return _fit_parts(_index_fit_words(cols, n, w))


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


def probe_bloom(reader, h1: torch.Tensor, h2: torch.Tensor
                ) -> Optional[np.ndarray]:
    """Probe one SST's bloom for the batch (P2 + download); None = no
    usable filter (every key is a maybe — the bloom is advisory)."""
    bd = bloom_device_words(reader, h1.device)
    if bd is None:
        return None
    words, m_bits, k = bd
    return bloom_probe(h1, h2, words, m_bits, k).cpu().numpy()


def file_table(staged_by, device) -> FileTable:
    """The FileTable of (file id, reader, staged cols) triples: each
    file's bloom words (bloom_device_words), staged matrix and validated
    learned-index operands (storage/learned_index.model_operands)."""
    from yugabyte_tpu_torch.storage import learned_index
    return FileTable(
        [(bloom_device_words(r, device), st.cols_dev, st.n, st.w,
          learned_index.model_operands(r.props.lindex, st.n))
         for _fid, r, st in staged_by], device)


def fit_learned_index_device(staged: StagedCols) -> Optional[dict]:
    """Fit the learned index over an already-staged cols matrix (P4: one
    launch and one download of its answer on the card). Returns the
    persistable model dict, or None when the span is too small or the
    bound too loose to help."""
    from yugabyte_tpu_torch.storage import learned_index
    if staged.n < LINDEX_MIN_ENTRIES or staged.w < 2:
        return None
    a_hi, a_lo, p, max_err = _fit_parts(_index_fit_words(
        staged.cols_dev, staged.n, staged.w).cpu().numpy())  # one download
    return learned_index.finish_model(a_hi.view(np.uint32),
                                      a_lo.view(np.uint32), int(p),
                                      int(max_err), staged.n)


# (n_pad, w) lattice points the manifest declares for locate / fit (the
# JAX package's _PREWARM_NPADS and _PREWARM_WIDTHS)
_PREWARM_NPADS = (1 << 16, 1 << 20)
_PREWARM_WIDTHS = (4, 8)


def prewarm_point_read(device=None) -> int:
    """Ahead-of-traffic warm of the declared point-read buckets (mirrors
    ops/run_merge.prewarm_buckets): builds the library, then for each
    (n_pad, w) one one-file table of pad columns and one chunk of each
    batch bucket through P1 + P2 (`hash_probe_files`) and P3 + the fold
    (`locate_fold`), model mode off and on, plus P4 (`index_fit`); each
    (1, n_pad) is marked prewarmed on the health board
    (point_read_locate). Returns the launches made; a failure is
    reported on stderr and never blocks."""
    from yugabyte_tpu_torch.ops.merge_gc import pad_template
    from yugabyte_tpu_torch.storage.bucket_health import health_board
    dev = torch_setup.resolve_device(device)
    board = health_board()
    launched = 0
    for n_pad in _PREWARM_NPADS:
        ok = True
        for w in _PREWARM_WIDTHS:
            r = _ROW_WORDS + w
            try:
                cols = u32_to_device(np.ascontiguousarray(np.broadcast_to(
                    pad_template(r)[:, None], (r, n_pad))), dev)
                index_fit(cols, n_pad, w)
                launched += 1
                # one file without a usable filter or a model
                table = FileTable([(None, cols, n_pad, w, None)], dev)
                for b in BATCH_BUCKETS:
                    keys = [b""] * b
                    hw, _hl = pack_query_batch(keys, w)
                    hw_d = to_device(hw, dev)
                    dk = torch.zeros(len(hw), dtype=torch.int32, device=dev)
                    qbuf, ql = table.queries(keys)
                    qbuf_d = to_device(qbuf, dev)
                    ql_d = to_device(ql.view(np.uint32), dev)
                    _maybe, located, _h1, _h2 = hash_probe_files(
                        hw_d, dk, table, b)
                    for model_on in (False, True):
                        locate_fold(table, qbuf_d, ql_d, b, 0, 0, model_on,
                                    located).cpu()
                    launched += 3
            except Exception as e:  # noqa: BLE001 — prewarm never blocks
                import sys as _sys
                print(f"[point_read] prewarm of (n_pad={n_pad} w={w}) "
                      f"failed: {e!r}", file=_sys.stderr, flush=True)
                ok = False
        if ok:
            board.record_prewarmed("point_read_locate", (1, n_pad))
    return launched


def point_read_snapshot() -> dict:
    """The batched point-read block of an operator's page."""
    m = point_read_metrics()
    return {
        "batches": m["batches"].value(),
        "batched_keys": m["keys"].value(),
        "bloom_skipped_ssts": m["bloom_skips"].value(),
        "learned_index_hits": m["learned_hits"].value(),
        "learned_index_fallbacks": m["learned_fallbacks"].value(),
        "device_fallbacks": m["device_fallbacks"].value(),
        "learned_index_max_error": m["max_error"].value(),
    }
