"""Hash/range partitioning of tables into tablets.

Capability parity with yb::PartitionSchema / Partition (ref:
src/yb/common/partition.h:73,185): tables shard by a 16-bit hash of the hashed
key columns (multi-tablet hash partitioning) and/or by range over the encoded
key. A Partition owns [start, end) of encoded-key space.

The hash function diverges from the reference (YB uses Jenkins-based
YBPartition::HashColumnCompoundValue): we use a splittable 64->16 bit mix that
is also trivially vectorizable for the device bloom/scan kernels.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Sequence

kMaxHashCode = 0xFFFF


def hash_column_compound_value(encoded_columns: bytes) -> int:
    """16-bit hash of the encoded hashed-column group. FNV-1a 64 folded to 16."""
    h = 0xCBF29CE484222325
    for b in encoded_columns:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    # xor-fold 64 -> 16
    h ^= h >> 32
    h ^= h >> 16
    return h & kMaxHashCode


@dataclass(frozen=True)
class Partition:
    """[partition_key_start, partition_key_end) over encoded partition keys."""

    start: bytes = b""
    end: bytes = b""  # b"" means +infinity

    def contains(self, partition_key: bytes) -> bool:
        if partition_key < self.start:
            return False
        return not self.end or partition_key < self.end

    def __repr__(self) -> str:
        return f"Partition[{self.start.hex()},{self.end.hex() or 'inf'})"


@dataclass
class PartitionSchema:
    """Describes how a table's rows map to partitions.

    hash_partitioning: partition key = 2-byte big-endian hash bucket.
    range partitioning: partition key = encoded doc key itself.
    """

    hash_partitioning: bool = True

    def partition_key(self, hash_code: Optional[int], encoded_key: bytes) -> bytes:
        if self.hash_partitioning:
            assert hash_code is not None
            return struct.pack(">H", hash_code)
        return encoded_key

    def create_partitions(self, num_tablets: int,
                          split_keys: Sequence[bytes] = ()) -> List[Partition]:
        if self.hash_partitioning:
            bounds = [struct.pack(">H", (i * (kMaxHashCode + 1)) // num_tablets)
                      for i in range(1, num_tablets)]
        else:
            bounds = sorted(split_keys)
        starts = [b""] + list(bounds)
        ends = list(bounds) + [b""]
        return [Partition(s, e) for s, e in zip(starts, ends)]


def doc_key_bounds(partition: Partition,
                   hash_partitioning: bool) -> "tuple[bytes, bytes | None]":
    """(lower_doc_key, upper_doc_key) clamping a tablet's scans to its
    partition. Hash partition keys are the 2-byte hash bucket, which appears
    in every encoded DocKey right after the kUInt16Hash tag byte, so the
    bound prefixes are directly comparable to encoded keys (ref: the
    reference derives the same bounds in Tablet::DocDbScanSpec)."""
    if not hash_partitioning:
        return partition.start, partition.end or None
    from yugabyte_tpu_torch.docdb.value_type import ValueType
    tag = bytes([ValueType.kUInt16Hash])
    lower = tag + partition.start if partition.start else b""
    upper = tag + partition.end if partition.end else None
    return lower, upper


def partition_for_key(partitions: Sequence[Partition], partition_key: bytes) -> int:
    """Index of the partition containing partition_key (meta-cache lookup)."""
    lo, hi = 0, len(partitions) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if partitions[mid].start <= partition_key:
            lo = mid
        else:
            hi = mid - 1
    return lo
