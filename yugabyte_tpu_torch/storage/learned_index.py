"""Learned per-SST index: fit, (de)serialization, base-file attachment.

The "Pragmatic Learned Indexing in RocksDB" recipe (PAPERS.md): one tiny
targeted model per SST, minimal system modification, exact-search fallback
on bounded misprediction. The model is a piecewise-linear map from a key
coordinate (first 8 key bytes as float32 — monotone in memcmp order) to
entry position, stored as S+1 anchor coordinates plus a measured max-error
bound. It is ADVISORY ONLY: the batched locate kernel
(ops/point_read._locate_gather_fused) uses it to narrow the binary-seek
window and verifies the answer against the search invariant; any
misprediction beyond the bound is detected and the key re-resolves
exactly, so correctness never depends on the model.

Fit sites:
  - device: ops/point_read.fit_learned_index_device (kernel P4,
    csrc/point_read.cu) over staged cols already on the card;
  - host (this module): the numpy twin over sorted key words, used by the
    Python SST writer and the native flush encoder. The twin mirrors the
    inference arithmetic so the recorded bound is self-consistent.

Counterpart of yugabyte_tpu/storage/learned_index.py (:27-237), copied;
the metrics-registry gauge of `finish_model` is left out.

Persistence: an optional ``lindex`` field in the SST properties block
(storage/sst.py). Format-compatible both ways: pre-PR readers ignore the
extra JSON key; post-PR readers treat its absence as "no model".
"""

from __future__ import annotations

from typing import Optional

import numpy as np

MODEL_VERSION = 1

# Model lattice — the CANONICAL definitions (ops/point_read.py imports
# them so its static search window stays in lock-step; this module must
# stay jax-free because every flush imports it for the host fit).
LINDEX_SEGMENTS = 16
# bound must fit the locate kernel's fixed window search: 2*err+1
# candidates resolved in point_read._LG_WINDOW halvings
LINDEX_MAX_ERR = (1 << 14) - 2
LINDEX_MIN_ENTRIES = 256   # below this a binary seek is already ~8 steps
# Prefix skip is capped at 2 words so the coordinate is a pure function
# of the first 16 KEY BYTES — independent of slab/staged padding width,
# which keeps fits byte-identical across every writer path (python,
# native-packed, device) for the same key set.
LINDEX_MAX_P = 2


def _anchor_positions(n: int, s: int = LINDEX_SEGMENTS) -> np.ndarray:
    """Deterministic anchor positions for an n-entry SST — recomputed at
    read time instead of persisted (the device fit uses the identical
    integer formula)."""
    return (np.arange(s + 1, dtype=np.int64) * (n - 1) // s
            ).astype(np.int32)


def _predict_host(x_hi: np.ndarray, x_lo: np.ndarray,
                  a_hi: np.ndarray, a_lo: np.ndarray,
                  anchor_pos: np.ndarray) -> np.ndarray:
    """Numpy twin of ops/point_read._predict_pos: exact two-limb segment
    selection and differences, float32 only for the interpolation."""
    s = len(a_hi) - 1
    seg = np.zeros(x_hi.shape, dtype=np.int32)
    for i in range(1, s):
        seg += ((x_hi > a_hi[i])
                | ((x_hi == a_hi[i]) & (x_lo >= a_lo[i]))
                ).astype(np.int32)
    a0h, a0l = a_hi[seg], a_lo[seg]
    a1h, a1l = a_hi[seg + 1], a_lo[seg + 1]
    p0 = anchor_pos[seg].astype(np.float32)
    p1 = anchor_pos[seg + 1].astype(np.float32)
    ge0 = (x_hi > a0h) | ((x_hi == a0h) & (x_lo >= a0l))
    x64 = (x_hi.astype(np.uint64) << np.uint64(32)) | x_lo
    a0 = (a0h.astype(np.uint64) << np.uint64(32)) | a0l
    a1 = (a1h.astype(np.uint64) << np.uint64(32)) | a1l
    dx64 = np.where(ge0, x64 - a0, 0)
    da64 = a1 - a0
    dx = (np.float32(4294967296.0)
          * (dx64 >> np.uint64(32)).astype(np.float32)
          + (dx64 & np.uint64(0xFFFFFFFF)).astype(np.float32))
    da = (np.float32(4294967296.0)
          * (da64 >> np.uint64(32)).astype(np.float32)
          + (da64 & np.uint64(0xFFFFFFFF)).astype(np.float32))
    t = np.where(ge0 & (da > 0), dx / np.where(da > 0, da,
                                               np.float32(1.0)),
                 np.float32(0.0))
    t = np.clip(t, np.float32(0.0), np.float32(1.0))
    return p0 + t * (p1 - p0)


def finish_model(a_hi: np.ndarray, a_lo: np.ndarray, p: int,
                 max_err: int, n: int) -> Optional[dict]:
    """Assemble the persistable dict from fitted anchors + measured
    bound; None when the bound is too loose for the fixed search window
    (the model would narrow nothing). All-integer: JSON round-trips the
    model exactly."""
    if max_err > LINDEX_MAX_ERR:
        return None
    return {
        "v": MODEL_VERSION,
        "s": LINDEX_SEGMENTS,
        "n": int(n),
        "p": int(p),
        "max_err": int(max_err),
        "a_hi": [int(a) for a in np.asarray(a_hi, dtype=np.uint32)],
        "a_lo": [int(a) for a in np.asarray(a_lo, dtype=np.uint32)],
    }


def fit_from_sorted_words(key_words: np.ndarray) -> Optional[dict]:
    """Host fit over SORTED key words (big-endian uint32 [n, w], entry
    order == key order). The numpy twin of _index_fit_fused: the same
    word-aligned prefix skip, exact anchors, and inference arithmetic
    for the measured bound."""
    n = int(key_words.shape[0])
    if n < LINDEX_MIN_ENTRIES:
        return None
    w = int(key_words.shape[1])
    if w != LINDEX_MAX_P + 2:
        # normalize to the first 16 key bytes (4 words): the model must
        # not depend on how wide a particular writer padded its slab
        fixed = np.zeros((n, LINDEX_MAX_P + 2), dtype=np.uint32)
        fixed[:, :min(w, LINDEX_MAX_P + 2)] = \
            key_words[:, :LINDEX_MAX_P + 2]
        key_words = fixed
    p = 0
    while p < LINDEX_MAX_P and key_words[0, p] == key_words[n - 1, p]:
        p += 1
    x_hi = np.ascontiguousarray(key_words[:, p], dtype=np.uint32)
    x_lo = np.ascontiguousarray(key_words[:, p + 1], dtype=np.uint32)
    pos = _anchor_positions(n)
    a_hi = x_hi[pos]
    a_lo = x_lo[pos]
    pred = _predict_host(x_hi, x_lo, a_hi, a_lo, pos)
    err = np.abs(np.round(pred).astype(np.int64)
                 - np.arange(n, dtype=np.int64))
    return finish_model(a_hi, a_lo, p, int(err.max(initial=0)), n)


def fit_from_packed_keys(keys_blob: bytes, key_offs) -> Optional[dict]:
    """Host fit from a packed key run in ANY order (the native flush /
    bulk-ingest path). The coordinate words are a monotone (non-strict)
    transform of memcmp order among keys sharing the prefix, so sorting
    the 16-byte prefixes reproduces the key-sorted coordinate sequence
    exactly — no need to sort the keys themselves."""
    offs = np.asarray(key_offs, dtype=np.int64)
    n = len(offs) - 1
    if n < LINDEX_MIN_ENTRIES:
        return None
    data = np.frombuffer(keys_blob, dtype=np.uint8)
    if not len(data):
        return None
    lens = offs[1:] - offs[:-1]
    pos16 = offs[:-1, None] + np.arange(16, dtype=np.int64)[None, :]
    valid = np.arange(16, dtype=np.int64)[None, :] < lens[:, None]
    b16 = np.where(valid, data[np.clip(pos16, 0, len(data) - 1)],
                   0).astype(np.uint32)
    words = np.zeros((n, 4), dtype=np.uint32)
    for j in range(4):
        words[:, j] = ((b16[:, 4 * j] << 24) | (b16[:, 4 * j + 1] << 16)
                       | (b16[:, 4 * j + 2] << 8) | b16[:, 4 * j + 3])
    # sort the 16-byte prefixes into key order (lexicographic over the
    # four words == memcmp over the first 16 bytes; ties beyond that
    # produce equal coordinates, so the sequence is still exact)
    order = np.lexsort((words[:, 3], words[:, 2], words[:, 1],
                        words[:, 0]))
    return fit_from_sorted_words(words[order])


def fit_from_slab(slab) -> Optional[dict]:
    """Host fit from an already-sorted slab (the Python SST writer)."""
    if slab.n < LINDEX_MIN_ENTRIES:
        return None
    return fit_from_sorted_words(np.asarray(slab.key_words,
                                            dtype=np.uint32))


def model_operands(lindex: Optional[dict], n_entries: int):
    """Validate a persisted model against the file it claims to index
    and return the kernel operands (a_hi, a_lo, anchor_pos, p, max_err),
    or None when the model is absent/stale/oversized — the locate kernel
    then runs the exact full seek (advisory-only contract)."""
    if not lindex or not isinstance(lindex, dict):
        return None
    try:
        if (int(lindex.get("v", 0)) != MODEL_VERSION
                or int(lindex.get("s", 0)) != LINDEX_SEGMENTS
                or int(lindex.get("n", -1)) != int(n_entries)
                or int(lindex["max_err"]) > LINDEX_MAX_ERR
                or int(lindex.get("p", -1)) < 0):
            return None
        a_hi = np.asarray(lindex["a_hi"], dtype=np.uint32)
        a_lo = np.asarray(lindex["a_lo"], dtype=np.uint32)
        if a_hi.shape != (LINDEX_SEGMENTS + 1,) \
                or a_lo.shape != (LINDEX_SEGMENTS + 1,):
            return None
    except (KeyError, TypeError, ValueError):  # yblint: contained(a malformed persisted model is advisory data — ignored, the exact seek serves)
        return None
    return a_hi, a_lo, _anchor_positions(int(n_entries)), \
        int(lindex["p"]), int(lindex["max_err"])


def attach_learned_index(base_path: str, lindex: dict) -> int:
    """Rewrite an SST base file with the model added to its properties
    block (CRC + footer recomputed). Used by the device-native compaction
    path, which fits AFTER the streaming writer produced the file but
    BEFORE the output installs/serves. Returns the new base-file size."""
    import json
    import zlib
    from yugabyte_tpu_torch.storage.sst import _FOOTER, SST_MAGIC
    from yugabyte_tpu_torch.utils.env import get_env
    raw = get_env().read_file(base_path)
    (index_off, index_len, bloom_off, bloom_len, props_off, props_len,
     data_size, _crc, magic) = _FOOTER.unpack_from(raw,
                                                   len(raw) - _FOOTER.size)
    if magic != SST_MAGIC:
        raise ValueError(f"not an SST base file: {base_path}")
    index_bytes = raw[index_off: index_off + index_len]
    bloom_bytes = raw[bloom_off: bloom_off + bloom_len]
    props = json.loads(raw[props_off: props_off + props_len])
    props["lindex"] = lindex
    props_bytes = json.dumps(props).encode()
    crc = (zlib.crc32(index_bytes) ^ zlib.crc32(bloom_bytes)
           ^ zlib.crc32(props_bytes))
    blob = (index_bytes + bloom_bytes + props_bytes
            + _FOOTER.pack(0, len(index_bytes), len(index_bytes),
                           len(bloom_bytes),
                           len(index_bytes) + len(bloom_bytes),
                           len(props_bytes), data_size, crc, SST_MAGIC))
    get_env().write_file(base_path, blob)
    return len(blob)
