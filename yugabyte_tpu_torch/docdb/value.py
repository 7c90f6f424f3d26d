"""DocDB value encoding: control fields (TTL, merge flags) + primitive payload.

Capability parity with the reference's Value (ref: src/yb/docdb/value.h;
Value::DecodeControlFields used at docdb_compaction_filter.cc:222). An encoded
value is:

    [kMergeFlags + u32]?  [kTTL + i64 millis]?  <primitive payload>

where the payload is a PrimitiveValue encoding, kTombstone for deletes, or
kObject for an (empty) subdocument container marker.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional, Tuple

from yugabyte_tpu_torch.docdb.doc_key import PrimitiveType, PrimitiveValue
from yugabyte_tpu_torch.docdb.value_type import ValueType

kTtlFlag = 0x1  # merge flag marking a "TTL-only" merge record (redis EXPIRE)


@dataclass(frozen=True)
class Value:
    primitive: PrimitiveType = None           # payload (ignored for tombstone/object)
    is_tombstone: bool = False
    is_object: bool = False                   # object/subdocument init marker
    ttl_ms: Optional[int] = None              # relative TTL in milliseconds
    merge_flags: int = 0

    def encode(self) -> bytes:
        buf = bytearray()
        if self.merge_flags:
            buf.append(ValueType.kMergeFlags)
            buf += struct.pack(">I", self.merge_flags)
        if self.ttl_ms is not None:
            buf.append(ValueType.kTTL)
            buf += struct.pack(">q", self.ttl_ms)
        if self.is_tombstone:
            buf.append(ValueType.kTombstone)
        elif self.is_object:
            buf.append(ValueType.kObject)
        else:
            PrimitiveValue.encode(self.primitive, buf)
        return bytes(buf)

    @staticmethod
    def decode(data: bytes) -> "Value":
        merge_flags, ttl_ms, pos = decode_control_fields(data)
        if pos >= len(data):
            raise ValueError("empty value payload")
        tag = data[pos]
        if tag == ValueType.kTombstone:
            return Value(None, True, False, ttl_ms, merge_flags)
        if tag == ValueType.kObject:
            return Value(None, False, True, ttl_ms, merge_flags)
        prim, _ = PrimitiveValue.decode(data, pos)
        return Value(prim, False, False, ttl_ms, merge_flags)

    @staticmethod
    def tombstone() -> "Value":
        return Value(is_tombstone=True)


def decode_control_fields(data: bytes) -> Tuple[int, Optional[int], int]:
    """(merge_flags, ttl_ms, payload_offset) without decoding the payload.

    Mirrors Value::DecodeControlFields — the compaction filter peeks at TTL
    and merge flags without materializing values (docdb_compaction_filter.cc:222).
    """
    pos = 0
    merge_flags = 0
    ttl_ms = None
    if pos < len(data) and data[pos] == ValueType.kMergeFlags:
        (merge_flags,) = struct.unpack_from(">I", data, pos + 1)
        pos += 5
    if pos < len(data) and data[pos] == ValueType.kTTL:
        (ttl_ms,) = struct.unpack_from(">q", data, pos + 1)
        pos += 9
    return merge_flags, ttl_ms, pos
