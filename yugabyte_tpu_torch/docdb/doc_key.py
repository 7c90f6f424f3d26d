"""DocKey / SubDocKey: order-preserving document key encoding.

Capability parity with the reference (ref: src/yb/docdb/doc_key.h:42-82
DocKey, :467 SubDocKey; string zero-encoding per
src/yb/docdb/doc_kv_util.h:95 ZeroEncodeAndAppendStrToKey).

Layout of an encoded SubDocKey (matches the reference's structure):

    [kUInt16Hash][2B big-endian hash]        (hash-partitioned tables only)
    [hashed components]* [kGroupEnd]
    [range components]*  [kGroupEnd]
    [subkeys]*
    [kHybridTime][12-byte descending DocHybridTime]   (see common/hybrid_time.py)

Each component is an order-preserving PrimitiveValue encoding:
  - string: kString + zero-encoded bytes (\\x00 -> \\x00\\x01, terminator \\x00\\x00)
  - int32/int64: tag + big-endian with sign bit flipped
  - double/float: tag + IEEE bits with order-preserving transform
  - bool: kTrue / kFalse tag only;  null: kNullLow tag only
  - column id: kColumnId + 2B big-endian

Device note: because the hash prefix and all components are big-endian and
order-preserving, the raw key bytes sort with plain memcmp — which is exactly
what the device merge kernel does after packing keys into big-endian u32 word
slabs (ops/slabs.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime, ENCODED_DOC_HT_SIZE
from yugabyte_tpu_torch.common.partition import hash_column_compound_value
from yugabyte_tpu_torch.docdb.value_type import ValueType

PrimitiveType = Union[None, bool, int, float, str, bytes]

_I32_OFF = 1 << 31
_I64_OFF = 1 << 63


def zero_encode(data: bytes) -> bytes:
    """\\x00 -> \\x00\\x01; terminate with \\x00\\x00 (order-preserving, ref doc_kv_util.h:95)."""
    return data.replace(b"\x00", b"\x00\x01") + b"\x00\x00"


def zero_decode(data: bytes, pos: int) -> Tuple[bytes, int]:
    """Inverse of zero_encode, starting at pos; returns (decoded, new_pos)."""
    out = bytearray()
    n = len(data)
    while pos < n:
        b = data[pos]
        if b == 0:
            if pos + 1 >= n:
                raise ValueError("truncated zero-encoded string")
            nxt = data[pos + 1]
            if nxt == 0:
                return bytes(out), pos + 2
            if nxt == 1:
                out.append(0)
                pos += 2
                continue
            raise ValueError("corrupt zero-encoded string")
        out.append(b)
        pos += 1
    raise ValueError("unterminated zero-encoded string")


class PrimitiveValue:
    """Encode/decode one key component or primitive value payload."""

    @staticmethod
    def encode(v: PrimitiveType, buf: bytearray) -> None:
        if v is None:
            buf.append(ValueType.kNullLow)
        elif v is True:
            buf.append(ValueType.kTrue)
        elif v is False:
            buf.append(ValueType.kFalse)
        elif isinstance(v, int):
            # Always kInt64: a single tag keeps memcmp order == numeric order
            # for ALL ints in a column. (Tagging by magnitude would order any
            # int64-range value after every int32-range value.)
            buf.append(ValueType.kInt64)
            buf += struct.pack(">Q", v + _I64_OFF)
        elif isinstance(v, float):
            buf.append(ValueType.kDouble)
            bits = struct.unpack(">Q", struct.pack(">d", v))[0]
            # Order-preserving float transform: flip sign bit for positives,
            # flip all bits for negatives.
            bits = bits ^ _I64_OFF if not (bits >> 63) else bits ^ 0xFFFFFFFFFFFFFFFF
            buf += struct.pack(">Q", bits)
        elif isinstance(v, str):
            buf.append(ValueType.kString)
            buf += zero_encode(v.encode("utf-8"))
        elif isinstance(v, bytes):
            # Distinct tag so round-trips are type-stable (str stays str,
            # bytes stay bytes). BINARY and STRING are distinct schema types,
            # so they never share a column and relative order is irrelevant.
            buf.append(ValueType.kBinary)
            buf += zero_encode(v)
        else:
            raise TypeError(f"unsupported key component type: {type(v)}")

    @staticmethod
    def encode_column_id(cid: int, buf: bytearray) -> None:
        if cid < 0:
            buf.append(ValueType.kSystemColumnId)
            buf += struct.pack(">H", -cid)
        else:
            buf.append(ValueType.kColumnId)
            buf += struct.pack(">H", cid)

    @staticmethod
    def decode(data: bytes, pos: int) -> Tuple[PrimitiveType, int]:
        tag = data[pos]
        pos += 1
        if tag == ValueType.kNullLow:
            return None, pos
        if tag == ValueType.kTrue:
            return True, pos
        if tag == ValueType.kFalse:
            return False, pos
        if tag == ValueType.kInt32:
            (u,) = struct.unpack_from(">I", data, pos)
            return u - _I32_OFF, pos + 4
        if tag == ValueType.kInt64:
            (u,) = struct.unpack_from(">Q", data, pos)
            return u - _I64_OFF, pos + 8
        if tag == ValueType.kDouble:
            (bits,) = struct.unpack_from(">Q", data, pos)
            bits = bits ^ _I64_OFF if (bits >> 63) else bits ^ 0xFFFFFFFFFFFFFFFF
            return struct.unpack(">d", struct.pack(">Q", bits))[0], pos + 8
        if tag == ValueType.kString:
            raw, pos = zero_decode(data, pos)
            return raw.decode("utf-8"), pos
        if tag == ValueType.kBinary:
            raw, pos = zero_decode(data, pos)
            return raw, pos
        if tag == ValueType.kColumnId:
            (cid,) = struct.unpack_from(">H", data, pos)
            return ("col", cid), pos + 2
        if tag == ValueType.kSystemColumnId:
            (cid,) = struct.unpack_from(">H", data, pos)
            return ("col", -cid), pos + 2
        raise ValueError(f"unknown value tag {tag:#x} at {pos - 1}")


@dataclass(frozen=True)
class DocKey:
    """Primary key of one document: hashed group + range group.

    encode()/hash_code memoize on first use (the instance is frozen, so
    the encoding can never change): the client encodes every key once
    for partition routing and again for the wire/read path, and the
    hash-compound pass was the single hottest client-side line under
    batched load."""

    hash_components: Tuple[PrimitiveType, ...] = ()
    range_components: Tuple[PrimitiveType, ...] = ()
    use_hash: Optional[bool] = None  # default: hash iff hash_components present

    def encode(self) -> bytes:
        cached = self.__dict__.get("_enc")
        if cached is not None:
            return cached
        buf = bytearray()
        use_hash = self.use_hash if self.use_hash is not None else bool(self.hash_components)
        if use_hash:
            hbuf = bytearray()
            for c in self.hash_components:
                PrimitiveValue.encode(c, hbuf)
            hc = hash_column_compound_value(bytes(hbuf))
            object.__setattr__(self, "_hash_code", hc)
            buf.append(ValueType.kUInt16Hash)
            buf += struct.pack(">H", hc)
            buf += hbuf
            buf.append(ValueType.kGroupEnd)
        for c in self.range_components:
            PrimitiveValue.encode(c, buf)
        buf.append(ValueType.kGroupEnd)
        out = bytes(buf)
        object.__setattr__(self, "_enc", out)
        return out

    @property
    def hash_code(self) -> Optional[int]:
        if not self.hash_components:
            return None
        cached = self.__dict__.get("_hash_code")
        if cached is not None:
            return cached
        hbuf = bytearray()
        for c in self.hash_components:
            PrimitiveValue.encode(c, hbuf)
        hc = hash_column_compound_value(bytes(hbuf))
        object.__setattr__(self, "_hash_code", hc)
        return hc

    @staticmethod
    def decode(data: bytes, pos: int = 0) -> Tuple["DocKey", int]:
        hash_components: List[PrimitiveType] = []
        range_components: List[PrimitiveType] = []
        had_hash = False
        if pos < len(data) and data[pos] == ValueType.kUInt16Hash:
            had_hash = True
            pos += 3  # tag + 2-byte hash (recomputable from components)
            while pos < len(data) and data[pos] != ValueType.kGroupEnd:
                v, pos = PrimitiveValue.decode(data, pos)
                hash_components.append(v)
            if pos >= len(data):
                raise ValueError("truncated DocKey: unterminated hashed group")
            pos += 1
        while pos < len(data) and data[pos] != ValueType.kGroupEnd:
            v, pos = PrimitiveValue.decode(data, pos)
            range_components.append(v)
        if pos >= len(data):
            raise ValueError("truncated DocKey: unterminated range group")
        pos += 1  # range kGroupEnd
        return DocKey(tuple(hash_components), tuple(range_components), had_hash), pos


@dataclass(frozen=True)
class SubDocKey:
    """DocKey + subkeys + DocHybridTime: the full versioned KV key.

    (ref: doc_key.h:467). Subkeys address nested fields — for relational rows
    one subkey = the column id; deeper paths serve collections/jsonb.
    """

    doc_key: DocKey
    subkeys: Tuple[PrimitiveType, ...] = ()
    doc_ht: Optional[DocHybridTime] = None

    def encode(self, include_ht: bool = True) -> bytes:
        buf = bytearray(self.doc_key.encode())
        for sk in self.subkeys:
            if isinstance(sk, tuple) and len(sk) == 2 and sk[0] == "col":
                PrimitiveValue.encode_column_id(sk[1], buf)
            else:
                PrimitiveValue.encode(sk, buf)
        if include_ht and self.doc_ht is not None:
            buf.append(ValueType.kHybridTime)
            buf += self.doc_ht.encoded()
        return bytes(buf)

    @staticmethod
    def decode(data: bytes) -> "SubDocKey":
        doc_key, pos = DocKey.decode(data, 0)
        subkeys: List[PrimitiveType] = []
        doc_ht = None
        n = len(data)
        while pos < n:
            if data[pos] == ValueType.kHybridTime:
                doc_ht = DocHybridTime.decode(data[pos + 1: pos + 1 + ENCODED_DOC_HT_SIZE])
                pos += 1 + ENCODED_DOC_HT_SIZE
                break
            v, pos = PrimitiveValue.decode(data, pos)
            subkeys.append(v)
        return SubDocKey(doc_key, tuple(subkeys), doc_ht)


def split_key_and_ht(encoded: bytes) -> Tuple[bytes, Optional[DocHybridTime]]:
    """Split an encoded SubDocKey into (key prefix without HT, DocHybridTime).

    The fixed-width HT encoding makes this O(1) from the end of the key
    (ref: DecodeFromEnd usage, docdb_compaction_filter.cc:123).
    """
    ht_section = 1 + ENCODED_DOC_HT_SIZE
    if len(encoded) >= ht_section and encoded[-ht_section] == ValueType.kHybridTime:
        return encoded[:-ht_section], DocHybridTime.decode(encoded[-ENCODED_DOC_HT_SIZE:])
    return encoded, None
