"""SST block format: columnar KV slabs, directly device-shippable.

The device-first replacement for the reference's delta-encoded blocks with
restart points (ref: src/yb/rocksdb/table/block_builder.cc — prefix
compression + restart array). Rationale: restart-point blocks must be decoded
*sequentially* per entry; slab blocks decode with O(1) numpy reshapes and ship
to device HBM as-is, and binary search over fixed-stride keys vectorizes.

Block layout (little-endian header, big-endian key bytes for memcmp order):

    u32 magic          0x53425459 ("YTBS")
    u32 n_entries
    u32 key_stride     bytes per key row (multiple of 4)
    u32 flags          bit0: zlib-compressed body
    u32 body_len       compressed body bytes
    u32 raw_len        uncompressed body bytes
    body:
        key slab       n * key_stride bytes (zero-padded, memcmp order)
        key_len        u16[n]
        doc_key_len    u16[n]
        ht_hi, ht_lo   u32[n] each
        write_id       u32[n]
        entry_flags    u8[n]   (slabs.FLAG_*)
        ttl_ms         i64[n]
        val_offsets    u32[n+1]
        val bytes
    u32 crc32(header[4:24] + body-as-stored)
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from yugabyte_tpu_torch.ops.slabs import KVSlab
from yugabyte_tpu_torch.utils.status import Status, StatusError

BLOCK_MAGIC = 0x53425459
_HEADER = struct.Struct("<IIIIII")

# Fixed-width column bytes per row in the body, AFTER the key slab:
# key_len(2) + doc_key_len(2) + ht_hi(4) + ht_lo(4) + write_id(4) +
# entry_flags(1) + ttl_ms(8).  The device block codec (ops/block_codec.py)
# computes its gather/scatter offsets from this constant and the region
# order above — any layout change here MUST move the codec kernels too
# (both are fingerprinted together in the kernel manifest).
META_BYTES_PER_ROW = 25
HEADER_BYTES = _HEADER.size          # 24
TRAILER_BYTES = 4                    # u32 crc32


def fixed_region_bytes(n: int, stride: int) -> int:
    """Bytes of the body's fixed-width columns (key slab + metadata
    arrays) — everything before val_offsets."""
    return n * stride + META_BYTES_PER_ROW * n


def split_raw_block(data) -> Tuple[int, int, bytes]:
    """Parse + integrity-check one raw block WITHOUT decoding columns:
    returns (n_entries, key_stride, uncompressed body bytes).

    The device-codec ingest path: magic/CRC/size checks are identical to
    decode_block (typed Status.Corruption, never wrong bytes), but the
    column transforms stay undone — the body ships to the device as raw
    words and value rows are zero-copy slices of it.  `data` may be a
    memoryview over the whole data file (zero-copy slicing; the CRC runs
    incrementally over the buffer)."""
    if len(data) < _HEADER.size + TRAILER_BYTES:
        raise StatusError(Status.Corruption("block too small"))
    magic, n, stride, flags, body_len, raw_len = _HEADER.unpack_from(data, 0)
    if magic != BLOCK_MAGIC:
        raise StatusError(Status.Corruption("bad block magic"))
    off = _HEADER.size
    if len(data) < off + body_len + TRAILER_BYTES:
        raise StatusError(Status.Corruption("block truncated"))
    stored = data[off: off + body_len]
    (crc,) = struct.unpack_from("<I", data, off + body_len)
    if crc != zlib.crc32(stored, zlib.crc32(data[4: off])):
        raise StatusError(Status.Corruption("block checksum mismatch"))
    body = zlib.decompress(stored) if (flags & 1) else stored
    if len(body) != raw_len:
        raise StatusError(Status.Corruption("block size mismatch"))
    if stride % 4 or fixed_region_bytes(n, stride) + 4 * (n + 1) > raw_len:
        raise StatusError(Status.Corruption("block geometry mismatch"))
    return n, stride, body


def raw_block_values(n: int, stride: int, body: bytes):
    """Zero-copy value rows of one uncompressed block body (the on-disk
    layout IS blob + offsets; no column decode happens)."""
    from yugabyte_tpu_torch.ops.slabs import ValueArray
    p = fixed_region_bytes(n, stride)
    val_offsets = np.frombuffer(body, dtype="<u4", count=n + 1, offset=p)
    return ValueArray.from_blob(body[p + 4 * (n + 1):], val_offsets)


def encode_block(slab: KVSlab, start: int, end: int, compress: bool = False) -> bytes:
    """Serialize slab rows [start, end) into one block."""
    n = end - start
    kw = slab.key_words[start:end]
    stride = kw.shape[1] * 4
    key_bytes = kw.astype(">u4").tobytes()
    # values: one vectorized gather into (blob, offsets) — the disk layout.
    # Contiguous value_idx (the normal case after _gather_slab/pack_kvs
    # normalization) is a zero-copy slice.
    from yugabyte_tpu_torch.ops.slabs import ValueArray
    va = ValueArray.from_list(slab.values)
    vi = slab.value_idx[start:end]
    if n and int(vi[-1]) - int(vi[0]) == n - 1 \
            and np.array_equal(vi, np.arange(vi[0], vi[0] + n, dtype=vi.dtype)):
        vals = va.slice_rows(int(vi[0]), int(vi[0]) + n)
    else:
        vals = va.gather(vi)
    body = b"".join([
        key_bytes,
        slab.key_len[start:end].astype(np.uint16).tobytes(),
        slab.doc_key_len[start:end].astype(np.uint16).tobytes(),
        slab.ht_hi[start:end].astype(np.uint32).tobytes(),
        slab.ht_lo[start:end].astype(np.uint32).tobytes(),
        slab.write_id[start:end].astype(np.uint32).tobytes(),
        slab.flags[start:end].astype(np.uint8).tobytes(),
        slab.ttl_ms[start:end].astype(np.int64).tobytes(),
        vals.offsets.astype(np.uint32).tobytes(),
        vals.blob(),
    ])
    raw_len = len(body)
    flags = 0
    stored = body
    if compress:
        c = zlib.compress(body, 1)
        if len(c) < raw_len:
            stored = c
            flags |= 1
    header = _HEADER.pack(BLOCK_MAGIC, n, stride, flags, len(stored), raw_len)
    crc = zlib.crc32(header[4:] + stored)
    return header + stored + struct.pack("<I", crc)


def decode_block(data: bytes) -> KVSlab:
    magic, n, stride, flags, body_len, raw_len = _HEADER.unpack_from(data, 0)
    if magic != BLOCK_MAGIC:
        raise StatusError(Status.Corruption("bad block magic"))
    off = _HEADER.size
    stored = data[off: off + body_len]
    (crc,) = struct.unpack_from("<I", data, off + body_len)
    if crc != zlib.crc32(data[4: off] + stored):
        raise StatusError(Status.Corruption("block checksum mismatch"))
    body = zlib.decompress(stored) if (flags & 1) else stored
    if len(body) != raw_len:
        raise StatusError(Status.Corruption("block size mismatch"))
    p = 0
    w = stride // 4
    key_words = np.frombuffer(body, dtype=">u4", count=n * w, offset=p
                              ).reshape(n, w).astype(np.uint32)
    p += n * stride
    key_len = np.frombuffer(body, dtype=np.uint16, count=n, offset=p).astype(np.int32)
    p += 2 * n
    doc_key_len = np.frombuffer(body, dtype=np.uint16, count=n, offset=p).astype(np.int32)
    p += 2 * n
    ht_hi = np.frombuffer(body, dtype=np.uint32, count=n, offset=p).copy()
    p += 4 * n
    ht_lo = np.frombuffer(body, dtype=np.uint32, count=n, offset=p).copy()
    p += 4 * n
    write_id = np.frombuffer(body, dtype=np.uint32, count=n, offset=p).copy()
    p += 4 * n
    entry_flags = np.frombuffer(body, dtype=np.uint8, count=n, offset=p).astype(np.uint32)
    p += n
    ttl_ms = np.frombuffer(body, dtype=np.int64, count=n, offset=p).copy()
    p += 8 * n
    val_offsets = np.frombuffer(body, dtype=np.uint32, count=n + 1, offset=p)
    p += 4 * (n + 1)
    from yugabyte_tpu_torch.ops.slabs import ValueArray
    values = ValueArray.from_blob(body[p:], val_offsets)  # zero-copy
    return KVSlab(key_words, key_len, doc_key_len, ht_hi, ht_lo, write_id,
                  entry_flags, ttl_ms, np.arange(n, dtype=np.int32), values)


def block_overhead() -> int:
    return _HEADER.size + 4
