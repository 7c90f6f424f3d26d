"""KV slabs: the columnar host representation of sorted-run entries.

Counterpart of yugabyte_tpu/ops/slabs.py (host-side numpy, no device code):
a batch of KV entries is a structure-of-arrays "slab":

  key_words : uint32[N, W]  big-endian words of the key prefix (no HT suffix),
                            zero-padded to W*4 bytes. Because DocDB key
                            encoding is order-preserving bytewise
                            (docdb/doc_key.py), lexicographic order over
                            (key_words, key_len) == memcmp order over keys.
  key_len   : int32[N]      true byte length of the key prefix
  doc_key_len: int32[N]     byte length of the embedded DocKey (root prefix)
  ht_hi/ht_lo: uint32[N]    DocHybridTime.ht split into high/low words
  write_id  : uint32[N]
  flags     : uint32[N]     bit0 tombstone, bit1 object-init, bit2 has-TTL
  ttl_ms    : int64[N]      TTL in ms (0 = none)
  value_idx : int32[N]      index into the out-of-band value array

Values stay out-of-band because merge + GC only permute and drop entries —
value bytes move once, at output-write time.

Sorting a slab by (key_words..., key_len, ht_hi_desc, ht_lo_desc,
write_id_desc) reproduces exactly the reference's internal key order:
user key ascending, hybrid time descending (ref:
src/yb/rocksdb/db/dbformat.h internal key ordering + descending HT suffix,
common/doc_hybrid_time.cc:50).

`slab_from_arrays` is the state carry-over: it builds this package's
KVSlab from another package's slab fields given as numpy arrays, so that
differential tests feed both implementations the same state.
"""

from __future__ import annotations

import struct

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime, HybridTime
from yugabyte_tpu_torch.docdb.value import decode_control_fields
from yugabyte_tpu_torch.docdb.value_type import ValueType

FLAG_TOMBSTONE = 1
FLAG_OBJECT_INIT = 2
FLAG_HAS_TTL = 4
# Key addresses a document deeper than row+column (2+ subkey levels below
# the DocKey). The device GC implements only depth-2 overwrite truncation
# (ref: docdb/docdb_compaction_filter.cc:104-123 carries the full stack);
# this package's compaction job refuses deep inputs.
FLAG_DEEP = 8


class ValueArray:
    """Columnar value payloads: ONE contiguous byte buffer + row offsets.

    The slab counterpart of hot loop 3's output path (ref:
    rocksdb/db/compaction_job.cc:958-1024 block building): gather/concat
    are pure numpy offset arithmetic, so permuting a million values for an
    SST write costs two vectorized indexing passes instead of a
    per-row Python loop. Duck-types as a sequence of bytes rows
    (va[i] -> bytes), which keeps point-read paths unchanged.
    """

    __slots__ = ("data", "offsets")

    def __init__(self, data: np.ndarray, offsets: np.ndarray):
        self.data = data        # uint8 [total_bytes]
        self.offsets = offsets  # int64 [n_rows + 1]

    # ------------------------------------------------------------- construct
    @staticmethod
    def from_list(values) -> "ValueArray":
        if isinstance(values, ValueArray):
            return values
        n = len(values)
        lens = np.fromiter((len(v) for v in values), dtype=np.int64, count=n)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        data = (np.frombuffer(b"".join(values), dtype=np.uint8)
                if n else np.zeros(0, dtype=np.uint8))
        return ValueArray(data, offsets)

    @staticmethod
    def from_blob(blob, offsets) -> "ValueArray":
        """Zero-copy adoption of an already-contiguous layout (block
        decode path: the on-disk format IS blob + offsets)."""
        return ValueArray(np.frombuffer(blob, dtype=np.uint8),
                          np.asarray(offsets, dtype=np.int64))

    @staticmethod
    def empty_rows(n: int) -> "ValueArray":
        return ValueArray(np.zeros(0, dtype=np.uint8),
                          np.zeros(n + 1, dtype=np.int64))

    # ------------------------------------------------------------ sequence
    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i) -> bytes:
        i = int(i)
        if i < 0:
            i += len(self)
        return self.data[self.offsets[i]: self.offsets[i + 1]].tobytes()

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other):
        if isinstance(other, (list, tuple)):
            other = ValueArray.from_list(list(other))
        if not isinstance(other, ValueArray):
            return NotImplemented
        return (np.array_equal(self.offsets, other.offsets)
                and np.array_equal(self.data[: self.nbytes],
                                   other.data[: other.nbytes]))

    @property
    def nbytes(self) -> int:
        return int(self.offsets[-1])

    def lengths(self) -> np.ndarray:
        return self.offsets[1:] - self.offsets[:-1]

    def blob(self) -> bytes:
        return self.data[: self.nbytes].tobytes()

    # ---------------------------------------------------------- vectorized
    def gather(self, idx: np.ndarray, replace_mask: Optional[np.ndarray] = None,
               replacement: bytes = b"") -> "ValueArray":
        """Rows at `idx`, with rows under `replace_mask` substituted by
        `replacement` (the compaction TTL-expiry -> tombstone rewrite)."""
        idx = np.asarray(idx, dtype=np.int64)
        starts = self.offsets[idx]
        lens = self.offsets[idx + 1] - starts
        if replace_mask is not None and replacement is not None \
                and replace_mask.any():
            rep = np.frombuffer(replacement, dtype=np.uint8)
            data_all = np.concatenate([self.data, rep])
            starts = np.where(replace_mask, len(self.data), starts)
            lens = np.where(replace_mask, len(rep), lens)
        else:
            data_all = self.data
        n = len(idx)
        out_off = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=out_off[1:])
        if n and int(lens.min()) == int(lens.max()):
            # uniform stride (common: fixed-width rows, bench slabs): a 2-D
            # fancy index replaces the arange/repeat scatter — 2 passes
            stride = int(lens[0])
            if stride == 0:
                return ValueArray(np.zeros(0, dtype=np.uint8), out_off)
            pos2d = starts[:, None] + np.arange(stride, dtype=np.int64)[None, :]
            return ValueArray(data_all[pos2d].reshape(-1), out_off)
        total = int(out_off[-1])
        pos = (np.arange(total, dtype=np.int64)
               - np.repeat(out_off[:-1], lens)
               + np.repeat(starts, lens))
        return ValueArray(data_all[pos], out_off)

    def slice_rows(self, start: int, end: int) -> "ValueArray":
        """Zero-copy contiguous row range."""
        o = self.offsets[start: end + 1]
        base = o[0] if len(o) else 0
        return ValueArray(self.data[base: o[-1] if len(o) else 0], o - base)

    @staticmethod
    def concat(arrays: Sequence["ValueArray"]) -> "ValueArray":
        arrays = [ValueArray.from_list(a) for a in arrays]
        datas = [a.data[: a.nbytes] for a in arrays]
        n_total = sum(len(a) for a in arrays)
        offsets = np.zeros(n_total + 1, dtype=np.int64)
        pos = 0
        base = 0
        for a in arrays:
            n = len(a)
            offsets[pos + 1: pos + n + 1] = (a.offsets[1:] - a.offsets[0]) + base
            base += a.nbytes
            pos += n
        return ValueArray(
            np.concatenate(datas) if datas else np.zeros(0, dtype=np.uint8),
            offsets)


@dataclass
class KVSlab:
    key_words: np.ndarray   # uint32 [N, W]
    key_len: np.ndarray     # int32  [N]
    doc_key_len: np.ndarray  # int32 [N]
    ht_hi: np.ndarray       # uint32 [N]
    ht_lo: np.ndarray       # uint32 [N]
    write_id: np.ndarray    # uint32 [N]
    flags: np.ndarray       # uint32 [N]
    ttl_ms: np.ndarray      # int64  [N]
    value_idx: np.ndarray   # int32  [N]
    # out-of-band value payloads (indexed by value_idx): a ValueArray
    # (contiguous blob + offsets); plain lists of bytes are accepted at
    # construction seams and normalized by the vectorized paths
    values: "ValueArray"

    @property
    def n(self) -> int:
        return int(self.key_len.shape[0])

    @property
    def width_words(self) -> int:
        return int(self.key_words.shape[1])

    def key_bytes(self, i: int) -> bytes:
        return self.key_words[i].astype(">u4").tobytes()[: int(self.key_len[i])]

    def doc_ht(self, i: int) -> DocHybridTime:
        ht = (int(self.ht_hi[i]) << 32) | int(self.ht_lo[i])
        return DocHybridTime(HybridTime(ht), int(self.write_id[i]))


def _pad_keys_to_words(keys: Sequence[bytes], width_words: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized pack of variable-length key bytes into a zero-padded u32 word
    matrix. Avoids per-key Python in the inner loop (single-core host)."""
    n = len(keys)
    lens = np.fromiter((len(k) for k in keys), dtype=np.int64, count=n)
    w = width_words if width_words is not None else max(1, int(-(-int(lens.max(initial=1)) // 4)))
    stride = w * 4
    if lens.max(initial=0) > stride:
        raise ValueError(f"key longer than slab stride {stride}")
    out = np.zeros((n, stride), dtype=np.uint8)
    flat = np.frombuffer(b"".join(keys), dtype=np.uint8)
    starts = np.concatenate(([0], np.cumsum(lens)))[:-1]  # works for n == 0 too
    # target flat positions: row*stride + offset-within-key
    within = np.arange(lens.sum(), dtype=np.int64) - np.repeat(starts, lens)
    rows = np.repeat(np.arange(n, dtype=np.int64), lens)
    out.reshape(-1)[rows * stride + within] = flat
    words = out.reshape(n, w, 4)
    words = (words[:, :, 0].astype(np.uint32) << 24) | (words[:, :, 1].astype(np.uint32) << 16) \
        | (words[:, :, 2].astype(np.uint32) << 8) | words[:, :, 3].astype(np.uint32)
    return words, lens.astype(np.int32)


def pack_kvs(entries: Sequence[Tuple[bytes, int, bytes]],
             doc_key_lens: Optional[Sequence[int]] = None,
             width_words: Optional[int] = None) -> KVSlab:
    """Build a slab from (key_prefix_bytes, packed_doc_ht, value_bytes) triples.

    packed_doc_ht = (ht.value << 32) | write_id as a 96-bit concept; we pass
    (ht_value, write_id) packed as a single int for convenience:
    int = ht_value * 2^32 + write_id.
    """
    n = len(entries)
    keys = [e[0] for e in entries]
    key_words, key_len = _pad_keys_to_words(keys, width_words)
    ht_hi = np.empty(n, dtype=np.uint32)
    ht_lo = np.empty(n, dtype=np.uint32)
    write_id = np.empty(n, dtype=np.uint32)
    flags = np.zeros(n, dtype=np.uint32)
    ttl_ms = np.zeros(n, dtype=np.int64)
    value_idx = np.arange(n, dtype=np.int32)
    values: List[bytes] = []
    for i, (_, packed, val) in enumerate(entries):
        wid = packed & 0xFFFFFFFF
        ht = packed >> 32
        ht_hi[i] = ht >> 32
        ht_lo[i] = ht & 0xFFFFFFFF
        write_id[i] = wid
        mf, ttl, off = decode_control_fields(val)
        tag = val[off]
        if tag == ValueType.kTombstone:
            flags[i] |= FLAG_TOMBSTONE
        elif tag == ValueType.kObject:
            flags[i] |= FLAG_OBJECT_INIT
        if ttl is not None:
            flags[i] |= FLAG_HAS_TTL
            ttl_ms[i] = ttl
        values.append(val)
    if doc_key_lens is None:
        dkl = np.array([_doc_key_len(k) for k in keys], dtype=np.int32)
    else:
        dkl = np.asarray(doc_key_lens, dtype=np.int32)
    for i, k in enumerate(keys):
        if len(k) > dkl[i] and subkey_depth(k, int(dkl[i])) > 1:
            flags[i] |= FLAG_DEEP
    return KVSlab(key_words, key_len, dkl, ht_hi, ht_lo, write_id, flags,
                  ttl_ms, value_idx, ValueArray.from_list(values))


def subkey_depth(key_prefix: bytes, doc_key_len: int) -> int:
    """Number of subkey components below the DocKey (1 = row column,
    2+ = deep document: collections/jsonb paths)."""
    from yugabyte_tpu_torch.docdb.doc_key import PrimitiveValue
    pos = doc_key_len
    depth = 0
    n = len(key_prefix)
    try:
        while pos < n:
            _, pos = PrimitiveValue.decode(key_prefix, pos)
            depth += 1
    except (ValueError, IndexError, struct.error):  # yblint: contained(undecodable subkey tail is classified as deep — a conservative routing answer, not a swallowed durability error)
        return depth + 1  # undecodable tail: treat as deep (conservative)
    return depth


def subkey_bounds(key_prefix: bytes, doc_key_len: int) -> List[int]:
    """Component end offsets: [doc_key_len, end_of_subkey_1, ...] — the
    reference's sub_key_ends_ (ref: SubDocKey::DecodeDocKeyAndSubKeyEnds)."""
    from yugabyte_tpu_torch.docdb.doc_key import PrimitiveValue
    bounds = [doc_key_len]
    pos = doc_key_len
    n = len(key_prefix)
    while pos < n:
        _, pos = PrimitiveValue.decode(key_prefix, pos)
        bounds.append(pos)
    return bounds


def _doc_key_len(key_prefix: bytes) -> int:
    """Byte length of the DocKey portion (through the range-group kGroupEnd).

    Scans tag-structure: skips the hashed group's kGroupEnd if a hash prefix
    is present, then finds the range group's terminator. kGroupEnd bytes
    cannot appear inside components: every component encoding either escapes
    low bytes (strings escape only 0x00 — but '!' is 0x21; however string
    *content* can contain 0x21!). So we must parse, not scan.

    Keys that are NOT doc keys — intent reverse-index records and other
    system keys in the intents DB — count as one whole-key "document":
    they never share overwrite semantics with doc paths.
    """
    from yugabyte_tpu_torch.docdb.doc_key import DocKey
    try:
        _, pos = DocKey.decode(key_prefix, 0)
    except (ValueError, IndexError, struct.error):  # yblint: contained(non-doc system keys are by definition undecodable — whole key is the document, no error to route)
        return len(key_prefix)
    return pos


def pack_doc_ht(dht: DocHybridTime) -> int:
    return (dht.ht.value << 32) | dht.write_id


def unpack_keys(slab: KVSlab) -> List[bytes]:
    """Materialize key byte strings from a slab (host-side, for SST writing)."""
    raw = slab.key_words.astype(">u4").tobytes()
    stride = slab.width_words * 4
    return [raw[i * stride: i * stride + int(slab.key_len[i])] for i in range(slab.n)]


def concat_slabs(slabs: Sequence[KVSlab]) -> KVSlab:
    """Concatenate runs into one slab (vectorized, including values)."""
    w = max(s.width_words for s in slabs)
    parts_words = []
    value_offsets = []
    off = 0
    for s in slabs:
        kw = s.key_words
        if s.width_words < w:
            kw = np.pad(kw, ((0, 0), (0, w - s.width_words)))
        parts_words.append(kw)
        value_offsets.append(off)
        off += len(s.values)
    return KVSlab(
        key_words=np.concatenate(parts_words, axis=0),
        key_len=np.concatenate([s.key_len for s in slabs]),
        doc_key_len=np.concatenate([s.doc_key_len for s in slabs]),
        ht_hi=np.concatenate([s.ht_hi for s in slabs]),
        ht_lo=np.concatenate([s.ht_lo for s in slabs]),
        write_id=np.concatenate([s.write_id for s in slabs]),
        flags=np.concatenate([s.flags for s in slabs]),
        ttl_ms=np.concatenate([s.ttl_ms for s in slabs]),
        value_idx=np.concatenate(
            [s.value_idx + o for s, o in zip(slabs, value_offsets)]).astype(np.int32),
        values=ValueArray.concat([s.values for s in slabs]),
    )


_SLAB_DTYPES = (("key_words", np.uint32), ("key_len", np.int32),
                ("doc_key_len", np.int32), ("ht_hi", np.uint32),
                ("ht_lo", np.uint32), ("write_id", np.uint32),
                ("flags", np.uint32), ("ttl_ms", np.int64),
                ("value_idx", np.int32))


def slab_from_arrays(values=None, **fields) -> KVSlab:
    """State carry-over: a KVSlab from numpy field arrays (the field names
    of KVSlab; every array copied and cast to this package's dtypes).

    `values` is a ValueArray of either package (anything with `data` and
    `offsets`), a list of bytes, or None for empty payloads."""
    missing = [name for name, _ in _SLAB_DTYPES if name not in fields
               and name != "value_idx"]
    if missing:
        raise TypeError(f"slab_from_arrays: missing fields {missing}")
    n = int(np.asarray(fields["key_len"]).shape[0])
    if "value_idx" not in fields:
        fields["value_idx"] = np.arange(n, dtype=np.int32)
    arrs = {name: np.array(fields[name], dtype=dt, copy=True)
            for name, dt in _SLAB_DTYPES}
    arrs["key_words"] = arrs["key_words"].reshape(n, -1)
    if values is None:
        va = ValueArray.empty_rows(n)
    elif hasattr(values, "data") and hasattr(values, "offsets"):
        va = ValueArray(np.array(values.data, dtype=np.uint8, copy=True),
                        np.array(values.offsets, dtype=np.int64, copy=True))
    else:
        va = ValueArray.from_list(list(values))
    return KVSlab(values=va, **arrs)
