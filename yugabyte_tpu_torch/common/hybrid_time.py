"""HybridTime / DocHybridTime / HybridClock.

Capability parity with the reference's hybrid logical clocks:
 - HybridTime (ref: src/yb/common/hybrid_time.h:64): 64-bit value =
   physical microseconds << 12 | 12-bit logical component.
 - DocHybridTime (ref: src/yb/common/doc_hybrid_time.h:50): HybridTime +
   write_id (index of the write within one Raft batch), encoded *descending*
   at the end of each DocDB key.
 - HybridClock (ref: src/yb/server/hybrid_clock.h:88): monotonic hybrid clock
   combining wall time with a logical counter.

Device-first divergence: the reference encodes DocHybridTime with
descending-signed varints (doc_hybrid_time.cc:50, kNumBitsForHybridTimeSize).
We use a FIXED-WIDTH 12-byte encoding (8B ~hybrid_time, 4B ~write_id, both
big-endian bitwise complements) so that keys decompose into fixed-stride
integer slabs the device can sort/decode without byte-granular varint parsing.
Order semantics are identical: later times sort FIRST (descending).
"""

from __future__ import annotations

import struct
import threading
import time
from functools import total_ordering

kBitsForLogicalComponent = 12
_LOGICAL_MASK = (1 << kBitsForLogicalComponent) - 1
_U64 = (1 << 64) - 1
_U32 = (1 << 32) - 1

ENCODED_DOC_HT_SIZE = 12  # bytes: 8 (ht complement) + 4 (write_id complement)


@total_ordering
class HybridTime:
    """64-bit hybrid timestamp: (physical_micros << 12) | logical.

    A plain __slots__ class, not a dataclass: one HybridTime is built per
    KV on every write and read path, and frozen-dataclass __init__ was the
    single hottest line of the ingest profile. Value-semantics (eq / hash /
    total order) are preserved; treat instances as immutable."""

    __slots__ = ("value",)

    def __init__(self, value: int = 0):
        self.value = value

    @staticmethod
    def from_micros(micros: int, logical: int = 0) -> "HybridTime":
        return HybridTime((micros << kBitsForLogicalComponent) | logical)

    def __eq__(self, other) -> bool:
        return isinstance(other, HybridTime) and self.value == other.value

    def __hash__(self) -> int:
        return hash((HybridTime, self.value))

    @property
    def physical_micros(self) -> int:
        return self.value >> kBitsForLogicalComponent

    @property
    def logical(self) -> int:
        return self.value & _LOGICAL_MASK

    def incremented(self) -> "HybridTime":
        return HybridTime(self.value + 1)

    def decremented(self) -> "HybridTime":
        return HybridTime(self.value - 1)

    @property
    def is_valid(self) -> bool:
        return self.value != _U64

    def __lt__(self, other: "HybridTime") -> bool:
        return self.value < other.value

    def __repr__(self) -> str:
        return f"HT({self.physical_micros},{self.logical})"


HybridTime.kMin = HybridTime(0)
HybridTime.kMax = HybridTime(_U64 - 1)
HybridTime.kInvalid = HybridTime(_U64)


@total_ordering
class DocHybridTime:
    """HybridTime + write_id; sorts by (ht, write_id), encoded descending
    in keys. __slots__ value class for the same hot-path reason as
    HybridTime; treat instances as immutable."""

    __slots__ = ("ht", "write_id")

    def __init__(self, ht: HybridTime = None, write_id: int = 0):
        self.ht = ht if ht is not None else HybridTime(0)
        self.write_id = write_id

    def __eq__(self, other) -> bool:
        return (isinstance(other, DocHybridTime)
                and self.ht.value == other.ht.value
                and self.write_id == other.write_id)

    def __hash__(self) -> int:
        return hash((DocHybridTime, self.ht.value, self.write_id))

    def encoded(self) -> bytes:
        """Fixed 12-byte descending encoding (see module docstring)."""
        return struct.pack(">QI", self.ht.value ^ _U64, self.write_id ^ _U32)

    @staticmethod
    def decode(data: bytes) -> "DocHybridTime":
        ht_c, wid_c = struct.unpack(">QI", data[:ENCODED_DOC_HT_SIZE])
        return DocHybridTime(HybridTime(ht_c ^ _U64), wid_c ^ _U32)

    @staticmethod
    def decode_from_end(key: bytes) -> "DocHybridTime":
        """Decode from the tail of an encoded key (ref: ht.DecodeFromEnd,
        docdb_compaction_filter.cc:123). Fixed width makes this O(1)."""
        return DocHybridTime.decode(key[-ENCODED_DOC_HT_SIZE:])

    def _tuple(self):
        return (self.ht.value, self.write_id)

    def __lt__(self, other: "DocHybridTime") -> bool:
        return self._tuple() < other._tuple()

    def __repr__(self) -> str:
        return f"DocHT({self.ht!r},w{self.write_id})"


DocHybridTime.kMin = DocHybridTime(HybridTime.kMin, 0)
DocHybridTime.kMax = DocHybridTime(HybridTime.kMax, _U32 - 1)


class HybridClock:
    """Monotonic hybrid clock (ref: src/yb/server/hybrid_clock.h:88).

    now() returns a HybridTime that is strictly increasing: physical wall
    micros when wall time advances, else bumps the logical component.
    update(ht) incorporates a remote timestamp (message receipt), keeping the
    clock ahead of everything it has seen — the core HLC rule.
    """

    def __init__(self, time_source=None):
        self._time_source = time_source or (lambda: int(time.time() * 1e6))
        self._last = HybridTime(0)
        self._lock = threading.Lock()

    def now(self) -> HybridTime:
        with self._lock:
            physical = self._time_source()
            candidate = HybridTime.from_micros(physical)
            if candidate.value <= self._last.value:
                candidate = self._last.incremented()
            self._last = candidate
            return candidate

    def update(self, seen: HybridTime) -> None:
        with self._lock:
            if seen.value > self._last.value:
                self._last = seen

    def max_global_now(self) -> HybridTime:
        # Clock-skew bound for read-time selection; static 500ms like the
        # reference's max_clock_skew_usec default.
        return HybridTime.from_micros(self._time_source() + 500_000)
