"""Provisional records (intents) for distributed transactions.

Counterpart of yugabyte_tpu/docdb/intents.py, with the imports renamed.

Capability parity with the reference's intent format (ref:
src/yb/docdb/intent_aware_iterator.h:56 — `SubDocKey + IntentType +
HybridTime -> TxnId + value`; reverse index records keyed by transaction id
used by apply/cleanup, ref docdb/docdb.h:242 PrepareApplyIntentsBatch).

Layout here (internal keys get the write's DocHybridTime appended by the
storage layer, exactly like regular records):

  primary:  [subdoc_key][kIntentTypeSet][intent_type]  ->
            [kTransactionId][16B txn uuid][status_tablet utf8 len+bytes]
            [kWriteId][u32 write_id][value bytes]
  reverse:  [kTransactionId][16B txn uuid][u64 seq]    ->  [primary prefix]

Intent resolution (apply to regular DB at commit, or cleanup on abort)
writes TOMBSTONES over both records at the resolution hybrid time — the
storage layer has no point deletes (LSM + MVCC), and the normal compaction
GC reclaims resolved intents past the retention horizon.
"""

from __future__ import annotations

import struct
import uuid
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime, HybridTime
from yugabyte_tpu_torch.docdb.doc_key import split_key_and_ht
from yugabyte_tpu_torch.docdb.lock_manager import IntentType
from yugabyte_tpu_torch.docdb.value import Value
from yugabyte_tpu_torch.docdb.value_type import ValueType

_SEQ = struct.Struct(">Q")
_WRITE_ID = struct.Struct(">I")


@dataclass(frozen=True)
class TransactionMetadata:
    """Client-supplied txn identity attached to every transactional write
    (ref common/transaction.h TransactionMetadata)."""

    txn_id: bytes              # 16 raw bytes (uuid)
    status_tablet: str
    priority: int = 0
    read_ht: Optional[int] = None  # snapshot the txn reads at

    @staticmethod
    def new(status_tablet: str, read_ht: Optional[int] = None,
            priority: int = 0) -> "TransactionMetadata":
        return TransactionMetadata(uuid.uuid4().bytes, status_tablet,
                                   priority, read_ht)

    def to_wire(self) -> dict:
        return {"txn_id": self.txn_id, "status_tablet": self.status_tablet,
                "priority": self.priority, "read_ht": self.read_ht}

    @staticmethod
    def from_wire(w: dict) -> "TransactionMetadata":
        return TransactionMetadata(w["txn_id"], w["status_tablet"],
                                   w.get("priority", 0), w.get("read_ht"))


def make_status_cache(status_resolver, read_ht_value=None):
    """Memoizing wrapper over a status resolver — one coordinator lookup
    per transaction per operation. Resolver signature:
    (status_tablet, txn_id, read_ht=None) -> {"status", "commit_ht"};
    None resolves everything as conservatively pending."""
    statuses = {}

    def status_of(txn_id: bytes, status_tablet: str) -> dict:
        if txn_id not in statuses:
            if status_resolver is None:
                statuses[txn_id] = {"status": "pending", "commit_ht": None}
            else:
                statuses[txn_id] = status_resolver(status_tablet, txn_id,
                                                   read_ht_value)
        return statuses[txn_id]

    return status_of


# ------------------------------------------------------------------ encoding
def encode_intent_key(subdoc_key: bytes, intent_type: IntentType) -> bytes:
    return subdoc_key + bytes([ValueType.kIntentTypeSet, intent_type])


def decode_intent_key(key: bytes) -> Optional[Tuple[bytes, IntentType]]:
    """-> (subdoc_key, intent_type), or None if not an intent key."""
    if len(key) < 2 or key[-2] != ValueType.kIntentTypeSet:
        return None
    return key[:-2], IntentType(key[-1])


def encode_intent_value(meta: TransactionMetadata, write_id: int,
                        value_bytes: bytes) -> bytes:
    st = meta.status_tablet.encode("utf-8")
    return (bytes([ValueType.kTransactionId]) + meta.txn_id
            + struct.pack(">H", len(st)) + st
            + bytes([ValueType.kWriteId]) + _WRITE_ID.pack(write_id)
            + value_bytes)


def decode_intent_value(raw: bytes) -> Tuple[bytes, str, int, bytes]:
    """-> (txn_id, status_tablet, write_id, value_bytes)."""
    assert raw[0] == ValueType.kTransactionId, "not an intent value"
    txn_id = raw[1:17]
    (st_len,) = struct.unpack_from(">H", raw, 17)
    pos = 19
    status_tablet = raw[pos:pos + st_len].decode("utf-8")
    pos += st_len
    assert raw[pos] == ValueType.kWriteId
    (write_id,) = _WRITE_ID.unpack_from(raw, pos + 1)
    return txn_id, status_tablet, write_id, raw[pos + 5:]


def reverse_index_key(txn_id: bytes, seq: int) -> bytes:
    return bytes([ValueType.kTransactionId]) + txn_id + _SEQ.pack(seq)


def reverse_index_prefix(txn_id: bytes) -> bytes:
    return bytes([ValueType.kTransactionId]) + txn_id


def make_intent_batch(meta: TransactionMetadata,
                      kv_pairs: List[Tuple[bytes, bytes]],
                      lock_entries: List[Tuple[bytes, IntentType]],
                      write_id_base: int = 0
                      ) -> List[Tuple[bytes, bytes]]:
    """Flattened (key_prefix, value) pairs for the intents DB: one strong
    primary intent per written KV (carrying the provisional value), weak
    intents on the prefixes (empty payload), and a reverse-index record per
    primary intent. write_id_base + intra-batch index becomes the
    write_id: the base carries the transaction's STATEMENT sequence (the
    reference's IntraTxnWriteId), so a later statement's writes sort
    ABOVE an earlier statement's at the shared commit hybrid time — an
    UPDATE element must not be shadowed by the INSERT's collection
    marker (ref: docdb/intent.h IntraTxnWriteId)."""
    out: List[Tuple[bytes, bytes]] = []
    seq = 0
    for i, (subdoc_key, value_bytes) in enumerate(kv_pairs):
        write_id = write_id_base + i
        pk = encode_intent_key(subdoc_key, IntentType.kStrongWrite)
        out.append((pk, encode_intent_value(meta, write_id, value_bytes)))
        out.append((reverse_index_key(meta.txn_id, seq), pk))
        seq += 1
    seen = {k for k, _ in kv_pairs}
    for key, itype in lock_entries:
        if itype.is_strong or key in seen:
            continue
        wk = encode_intent_key(key, itype)
        out.append((wk, encode_intent_value(meta, 0xFFFFFFFF, b"")))
        out.append((reverse_index_key(meta.txn_id, seq), wk))
        seq += 1
    return out


# ----------------------------------------------------------------- scanning
def latest_intents_in_range(intents_db, lower: bytes,
                            upper: Optional[bytes] = None
                            ) -> Iterator[Tuple[bytes, IntentType,
                                                DocHybridTime, bytes]]:
    """Yield (subdoc_key, intent_type, write_dht, raw_intent_value) for the
    LATEST un-resolved version of every intent key in [lower, upper).
    Resolved intents (tombstoned by apply/cleanup) are skipped."""
    cur_prefix: Optional[bytes] = None
    for ikey, raw in intents_db.iter_from(lower):
        prefix, dht = split_key_and_ht(ikey)
        if dht is None:
            continue
        if prefix[:1] == bytes([ValueType.kTransactionId]):
            continue  # reverse-index region sorts separately
        if upper is not None and prefix >= upper:
            break
        if prefix == cur_prefix:
            continue  # older version of the same intent key
        cur_prefix = prefix
        decoded = decode_intent_key(prefix)
        if decoded is None:
            continue
        if raw[:1] == bytes([ValueType.kTombstone]):
            continue  # resolved (applied/cleaned up)
        subdoc_key, itype = decoded
        yield subdoc_key, itype, dht, raw


def txn_intents(intents_db, txn_id: bytes
                ) -> List[Tuple[bytes, DocHybridTime, bytes]]:
    """All unresolved primary/weak intents of one transaction, via the
    reverse index: (intent_key_prefix, write_dht, raw_intent_value)."""
    prefix = reverse_index_prefix(txn_id)
    upper = prefix + b"\xff" * 9
    out = []
    cur: Optional[bytes] = None
    for ikey, raw in intents_db.iter_from(prefix):
        rkey, dht = split_key_and_ht(ikey)
        if dht is None or not rkey.startswith(prefix) or rkey >= upper:
            break
        if rkey == cur:
            continue
        cur = rkey
        if raw[:1] == bytes([ValueType.kTombstone]):
            continue
        intent_key = raw
        got = intents_db.get(intent_key)
        if got is None:
            continue
        int_dht, int_raw = got
        if int_raw[:1] == bytes([ValueType.kTombstone]):
            continue
        # Ownership check: after this txn's intent at the key was resolved,
        # another txn may have legally written its own intent there
        # (conflict resolution permits overwriting aborted/committed
        # intents). Resolving that foreign intent as ours would tombstone
        # live data or publish uncommitted values — skip any record whose
        # embedded txn id is not ours.
        if (int_raw[:1] != bytes([ValueType.kTransactionId])
                or int_raw[1:17] != txn_id):
            continue
        out.append((intent_key, int_dht, int_raw))
    return out
