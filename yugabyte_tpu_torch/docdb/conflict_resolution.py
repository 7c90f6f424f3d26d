"""Optimistic conflict detection for transactional writes.

Counterpart of yugabyte_tpu/docdb/conflict_resolution.py, with the imports renamed.

Capability parity with the reference (ref: src/yb/docdb/conflict_resolution.h
:51,73 — before writing intents, a transaction checks (a) intents of OTHER
transactions that conflict with its own intent types on the same doc paths,
and (b) committed regular records newer than its read time). Divergence from
the reference, by design: the reference runs priority-based wound-wait
between live transactions; here the REQUESTOR fails with TransactionConflict
and the client retries with backoff — simpler, and the statuses of
conflicting transactions are still consulted so intents of aborted/committed
transactions don't block forever.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from yugabyte_tpu_torch.common.hybrid_time import HybridTime
from yugabyte_tpu_torch.docdb.intents import (
    TransactionMetadata, decode_intent_value, latest_intents_in_range,
    make_status_cache)
from yugabyte_tpu_torch.docdb.lock_manager import IntentType, intents_conflict
from yugabyte_tpu_torch.docdb.value_type import ValueType


class TransactionConflict(Exception):
    """The write conflicts with a live transaction or a newer committed
    write; the client should retry the whole transaction."""


# status_resolver(status_tablet, txn_id) -> {"status": str,
#                                            "commit_ht": int | None}
StatusResolver = Callable[[str, bytes], dict]


def resolve_write_conflicts(
        intents_db, regular_db,
        lock_entries: List[Tuple[bytes, IntentType]],
        meta: Optional[TransactionMetadata],
        status_resolver: Optional[StatusResolver] = None) -> None:
    """Raise TransactionConflict if the write described by lock_entries
    cannot proceed. `meta` is None for single-shard (non-transactional)
    writes, which still must not stomp on live intents."""
    own = meta.txn_id if meta is not None else None
    status_of = make_status_cache(status_resolver)

    for key, wanted in lock_entries:
        upper = key + bytes([ValueType.kMaxByte])
        for subdoc_key, held, _dht, raw in latest_intents_in_range(
                intents_db, key, upper):
            if subdoc_key != key and wanted in (IntentType.kWeakRead,
                                                IntentType.kWeakWrite):
                # A weak lock only guards the exact prefix node; children
                # are covered by their own strong entries in this batch.
                continue
            if not intents_conflict(wanted, held):
                continue
            txn_id, status_tablet, _wid, _val = decode_intent_value(raw)
            if txn_id == own:
                continue
            st = status_of(txn_id, status_tablet)
            if st["status"] == "aborted":
                continue  # dead intent awaiting cleanup
            if st["status"] == "committed":
                # Committed data, just not applied yet: overwriting is fine
                # unless it commits AFTER our snapshot (same rule as the
                # regular newer-committed-write check below).
                cht = st.get("commit_ht")
                if meta is None or meta.read_ht is None or \
                        (cht is not None and cht <= meta.read_ht):
                    continue
            raise TransactionConflict(
                f"conflicts with txn {txn_id.hex()[:8]} "
                f"({st['status']}) at {subdoc_key.hex()[:24]}")

    # Snapshot-isolation write check: a committed write newer than our read
    # snapshot on any doc path we are about to write (ref
    # conflict_resolution.cc read-time validation).
    if meta is not None and meta.read_ht is not None:
        read_ht = HybridTime(meta.read_ht)
        for key, wanted in lock_entries:
            if not (wanted.is_strong and wanted.is_write):
                continue
            got = regular_db.get(key)
            if got is not None and got[0].ht.value > read_ht.value:
                raise TransactionConflict(
                    f"committed write at {got[0].ht} is newer than txn "
                    f"read time {read_ht} on {key.hex()[:24]}")
