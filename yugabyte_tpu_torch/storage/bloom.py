"""DocDB-aware bloom filter: one probe per *document* key.

Capability parity with the reference's DocDbAwareFilterPolicy (ref:
src/yb/docdb/doc_key.h:811-866): the filter key is a prefix of the encoded
key, so one filter probe serves every subkey/version of a row. Divergence:
the reference filters on the hashed-components prefix; we filter on the full
DocKey prefix (doc_key_len), which is strictly more selective for point gets
and equally computable from slabs (doc_key_len is a slab column).

Build is vectorized over entries (byte-position loop is bounded by the key
stride); probes use FNV-64 split into two 32-bit halves, double-hashed.
Bloom bits must stay bit-identical to the JAX package's files, since the
compaction outputs of both packages are compared byte for byte.
"""

from __future__ import annotations

import struct

import numpy as np

_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def fnv64_masked(key_bytes_u8: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized FNV-1a over the first lengths[i] bytes of each row."""
    n, stride = key_bytes_u8.shape
    h = np.full(n, _FNV_OFFSET, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for j in range(stride):
            active = lengths > j
            hj = (h ^ key_bytes_u8[:, j].astype(np.uint64)) * _FNV_PRIME
            h = np.where(active, hj, h)
    return h


class BloomFilterBuilder:
    def __init__(self, n_keys_estimate: int, bits_per_key: int = 10):
        self.m_bits = max(64, n_keys_estimate * bits_per_key)
        self.m_bits = ((self.m_bits + 63) // 64) * 64
        self.k = max(1, min(12, int(round(bits_per_key * 0.69))))
        self.bits = np.zeros(self.m_bits // 8, dtype=np.uint8)

    def add_hashes(self, h: np.ndarray) -> None:
        # the numpy scatter below is an unbuffered ufunc.at; the native
        # path is the same schedule in C++
        from yugabyte_tpu_torch.storage import native_engine
        if native_engine.available():
            native_engine.bloom_build(h, self.bits, self.m_bits, self.k)
            return
        h1 = (h & np.uint64(0xFFFFFFFF)).astype(np.uint64)
        h2 = (h >> np.uint64(32)).astype(np.uint64) | np.uint64(1)
        with np.errstate(over="ignore"):
            for i in range(self.k):
                pos = (h1 + np.uint64(i) * h2) % np.uint64(self.m_bits)
                byte_idx = (pos >> np.uint64(3)).astype(np.int64)
                bit = (np.uint8(1) << (pos & np.uint64(7)).astype(np.uint8))
                np.bitwise_or.at(self.bits, byte_idx, bit)

    def finish(self) -> bytes:
        return struct.pack("<IQ", self.k, self.m_bits) + self.bits.tobytes()


class BloomFilter:
    def __init__(self, data: bytes):
        self.k, self.m_bits = struct.unpack_from("<IQ", data, 0)
        self.bits = np.frombuffer(data, dtype=np.uint8, offset=12)

    def may_contain_hash(self, h: int) -> bool:
        h1 = h & 0xFFFFFFFF
        h2 = (h >> 32) | 1
        for i in range(self.k):
            pos = (h1 + i * h2) % self.m_bits
            if not (self.bits[pos >> 3] >> (pos & 7)) & 1:
                return False
        return True

    def may_contain(self, filter_key: bytes) -> bool:
        arr = np.frombuffer(filter_key, dtype=np.uint8).reshape(1, -1)
        h = int(fnv64_masked(arr, np.array([len(filter_key)]))[0])
        return self.may_contain_hash(h)

    def may_contain_batch(self, h: np.ndarray) -> np.ndarray:
        """Vectorized probe for a batch of hashes — the CPU path of
        ops/point_read._bloom_probe_fused (bit-identical positions)."""
        h1 = (h & np.uint64(0xFFFFFFFF)).astype(np.uint64)
        h2 = (h >> np.uint64(32)).astype(np.uint64) | np.uint64(1)
        ok = np.ones(h.shape[0], dtype=bool)
        with np.errstate(over="ignore"):
            for i in range(self.k):
                pos = (h1 + np.uint64(i) * h2) % np.uint64(self.m_bits)
                byte_idx = (pos >> np.uint64(3)).astype(np.int64)
                ok &= ((self.bits[byte_idx] >> (pos & np.uint64(7)).astype(np.uint8)) & 1).astype(bool)
        return ok
