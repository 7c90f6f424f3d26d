"""IntentAwareIterator: merged read view over regular + intents DBs.

Counterpart of yugabyte_tpu/docdb/intent_aware_iterator.py, with the imports renamed.

Capability parity with the reference (ref: src/yb/docdb/
intent_aware_iterator.h:45-61 — reads see committed regular records PLUS
provisional records resolved at read time: the reading transaction's own
intents, and intents of transactions that already COMMITTED with a commit
hybrid time within the read snapshot but whose intents have not been moved
to the regular DB yet).

Implementation: the intents overlay for the scanned range is materialized
into synthetic internal-key entries (at the hybrid time each record becomes
visible — own write time for own intents, commit time for committed ones)
and merge-sorted with the regular DB's stream before the shared MVCC
resolution pass, so shadowing/tombstone semantics apply identically.
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime, HybridTime
from yugabyte_tpu_torch.storage.memtable import make_internal_key
from yugabyte_tpu_torch.docdb.intents import (
    decode_intent_value, latest_intents_in_range, make_status_cache)
from yugabyte_tpu_torch.docdb.lock_manager import IntentType
from yugabyte_tpu_torch.docdb.value_type import ValueType

StatusResolver = Callable[[str, bytes], dict]


def intent_overlay_entries(
        intents_db, read_ht: HybridTime,
        own_txn_id: Optional[bytes],
        status_resolver: Optional[StatusResolver],
        lower: bytes = b"",
        upper: Optional[bytes] = None) -> List[Tuple[bytes, bytes]]:
    """Synthetic (internal_key, value_bytes) entries for every provisional
    record visible at read_ht in [lower, upper)."""
    status_of = make_status_cache(status_resolver, read_ht.value)

    out: List[Tuple[bytes, bytes]] = []
    own: List[Tuple[DocHybridTime, bytes, bytes]] = []
    for subdoc_key, itype, dht, raw in latest_intents_in_range(
            intents_db, lower, upper):
        if itype != IntentType.kStrongWrite:
            continue  # weak intents carry no data
        txn_id, status_tablet, write_id, value_bytes = \
            decode_intent_value(raw)
        if own_txn_id is not None and txn_id == own_txn_id:
            own.append((dht, subdoc_key, value_bytes))
            continue
        st = status_of(txn_id, status_tablet)
        if st["status"] != "committed" or st.get("commit_ht") is None:
            continue  # pending/aborted: invisible to this snapshot
        if st["commit_ht"] > read_ht.value:
            continue
        visible_dht = DocHybridTime(HybridTime(st["commit_ht"]), write_id)
        out.append((make_internal_key(subdoc_key, visible_dht),
                    value_bytes))
    # Read-your-writes: a transaction sees ALL of its own provisional
    # records even though they were written after its read point (ref
    # intent_aware_iterator.h in_txn_limit semantics). Emit them AT the
    # read point, ordered by true write time via the write-id tiebreak, so
    # the MVCC resolver keeps them visible and the latest own write wins.
    own.sort(key=lambda e: e[0])
    for idx, (_true_dht, subdoc_key, value_bytes) in enumerate(own):
        out.append((make_internal_key(subdoc_key,
                                      DocHybridTime(read_ht, idx)),
                    value_bytes))
    out.sort()
    return out


def merged_entry_stream(regular_db, overlay: List[Tuple[bytes, bytes]],
                        lower: bytes = b""
                        ) -> Iterator[Tuple[bytes, bytes]]:
    """Regular DB stream merged with the intent overlay, in internal-key
    order (the reference's two-iterator seek dance collapses to a merge)."""
    return heapq.merge(regular_db.iter_from(lower), iter(overlay))
