"""DocDB value-type tag bytes.

Capability parity with the reference's ValueType enum (ref:
src/yb/docdb/value_type.h:56-150). Tag bytes are chosen with the same ordering
constraints the reference documents:
 - kGroupEnd ('!') sorts before everything, so a DocKey that is a prefix of
   another sorts first;
 - kHybridTime ('#') sorts below all primitive tags, so SubDocKeys with fewer
   subkeys sort above deeper ones;
 - ascending primitive tags are ordered Null < False < ... < numbers < string
   < True < Tombstone.
We keep only the tags the round-1 doc model needs; the byte values match the
reference where the tag exists there (so ordering reasoning transfers).
"""

from __future__ import annotations

import enum


class ValueType(enum.IntEnum):
    # Key structure markers
    kGroupEnd = ord("!")        # 33: end of hashed / range component group
    kHybridTime = ord("#")      # 35: DocHybridTime follows (end of key)
    # Primitive types, ascending order semantics
    kNullLow = ord("$")         # 36
    kFalse = ord("F")           # 70
    kUInt16Hash = ord("G")      # 71: 2-byte hash prefix of hash-partitioned keys
    kInt32 = ord("H")           # 72
    kInt64 = ord("I")           # 73
    kSystemColumnId = ord("J")  # 74: liveness column etc.
    kColumnId = ord("K")        # 75
    kDouble = ord("D")          # 68
    kFloat = ord("C")           # 67
    kString = ord("S")          # 83
    kTrue = ord("T")            # 84
    kBinary = ord("Y")          # 89: raw-bytes component (type-stable vs kString)
    kTombstone = ord("X")       # 88
    kArrayIndex = ord("[")      # 91
    kObject = ord("{")          # 123: subdocument container value
    kMergeFlags = ord("k")      # 107: value control field: merge flags
    kTTL = ord("t")             # 116: value control field: TTL follows
    kTransactionId = ord("x")   # 120: intent value: transaction id follows
    kWriteId = ord("w")         # 119: intent value control field
    kIntentTypeSet = ord("O")   # 79: intent key: intent type byte follows
    kMaxByte = 0xFF

    @property
    def is_primitive(self) -> bool:
        return self not in (ValueType.kGroupEnd, ValueType.kHybridTime,
                            ValueType.kMergeFlags, ValueType.kTTL,
                            ValueType.kTransactionId, ValueType.kWriteId,
                            ValueType.kIntentTypeSet, ValueType.kMaxByte)
