"""QL-style document write operations -> flattened DocDB KV pairs.

Counterpart of yugabyte_tpu/docdb/doc_operations.py, with the imports renamed.

Capability parity with the reference's write-op application (ref:
src/yb/docdb/ql_operation.cc / pgsql_operation.cc:366 `PgsqlWriteOperation::
Apply`, docdb/doc_write_batch): a row INSERT writes a *liveness* system
column plus one KV per non-null value column; UPDATE writes only the touched
columns; row DELETE writes a tombstone at the bare DocKey which shadows every
older column write (ref: docdb semantics in docdb/doc.md).

Lock determination follows DetermineKeysToLock (ref: src/yb/docdb/docdb.cc):
strong intent on each written doc path, weak intents on its prefixes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

from yugabyte_tpu_torch.common.schema import Schema
from yugabyte_tpu_torch.docdb.doc_key import (DocKey, PrimitiveType,
                                              PrimitiveValue, SubDocKey)
from yugabyte_tpu_torch.docdb.lock_manager import (
    IntentType, LockBatch, doc_path_lock_entries)
from yugabyte_tpu_torch.docdb.value import Value


@lru_cache(maxsize=8192)
def column_key_suffix(cid: int) -> bytes:
    """Encoded column-id subkey (what SubDocKey appends after the doc
    key). Column ids repeat across every row of a table, so the batched
    encode path concatenates ``doc_key.encode() + column_key_suffix(cid)``
    — byte-identical to SubDocKey(dk, (("col", cid),)).encode(
    include_ht=False) without re-encoding (and re-hashing) the doc key
    once per column."""
    buf = bytearray()
    PrimitiveValue.encode_column_id(cid, buf)
    return bytes(buf)

# System column marking row liveness (ref: common/ql_value / SystemColumnIds::
# kLivenessColumn). Encoded with kSystemColumnId, so it sorts before all
# regular (kColumnId) columns of the row.
kLivenessColumnId = -1


class WriteOpKind(enum.Enum):
    INSERT = "insert"    # upsert full row + liveness marker
    UPDATE = "update"    # touched columns only, no liveness
    DELETE_ROW = "delete_row"
    DELETE_COLS = "delete_cols"


@dataclass
class QLWriteOp:
    """One row-level write. `values` maps value-column name -> primitive;
    a None value in an UPDATE means "delete this column" (CQL SET c = null)."""

    kind: WriteOpKind
    doc_key: DocKey
    values: Dict[str, PrimitiveType] = field(default_factory=dict)
    ttl_ms: Optional[int] = None
    columns_to_delete: Tuple[str, ...] = ()
    # YCQL collection ops per column, applied IN ORDER (storage rides
    # subdocuments — docdb/subdocument.py; ref doc_write_batch.cc
    # InsertSubDocument / ExtendSubDocument):
    #   ("replace", {k: v})  SET m = {...}  — init marker + entries
    #   ("merge",   {k: v})  SET m = m + {...} / m['k'] = v — no marker
    #   ("del_keys", [k..])  DELETE m['k'] / SET m = m - {...}
    # Value: a LIST of such ops per column (one UPDATE may mix element
    # writes and element deletes on the same column).
    collection_ops: Dict[str, List[Tuple[str, object]]] = field(
        default_factory=dict)
    # Index backfill only (ref: tablet.cc:2088 BackfillIndexes writing at
    # the backfill read time): entries are stamped with THIS hybrid time
    # instead of the op's, so concurrent index maintenance — which writes at
    # now() — always supersedes backfilled entries.
    backfill_ht: Optional[int] = None

    # ------------------------------------------------------------- KV pairs
    def to_kv_pairs(self, schema: Schema) -> List[Tuple[bytes, bytes]]:
        """Flattened (subdoc_key_without_ht, encoded_value) pairs, in the
        order they receive intra-batch write ids."""
        dk = self.doc_key
        # Encode the doc key ONCE per op (it includes the partition-hash
        # computation); every column key is a pure byte concat from it.
        # Byte-identical to the per-column SubDocKey encode — the batched
        # write path leans on this (one hash + one component encode per
        # ROW, not per KV).
        dk_enc = dk.encode()
        out: List[Tuple[bytes, bytes]] = []

        def col_key(cid: int) -> bytes:
            return dk_enc + column_key_suffix(cid)

        if self.kind == WriteOpKind.DELETE_ROW:
            out.append((dk_enc, Value.tombstone().encode()))
            return out
        if self.kind == WriteOpKind.DELETE_COLS:
            for name in self.columns_to_delete:
                out.append((col_key(schema.column_id(name)),
                            Value.tombstone().encode()))
            self._collection_kv_pairs(schema, out)
            return out
        if self.kind == WriteOpKind.INSERT:
            out.append((col_key(kLivenessColumnId),
                        Value(primitive=None, ttl_ms=self.ttl_ms).encode()))
        for name, v in self.values.items():
            cid = schema.column_id(name)
            if v is None and self.kind == WriteOpKind.UPDATE:
                out.append((col_key(cid), Value.tombstone().encode()))
            else:
                out.append((col_key(cid),
                            Value(primitive=v, ttl_ms=self.ttl_ms).encode()))
        self._collection_kv_pairs(schema, out)
        return out

    def _collection_kv_pairs(self, schema: Schema,
                             out: List[Tuple[bytes, bytes]]) -> None:
        dk = self.doc_key
        for name, ops in self.collection_ops.items():
            cid = schema.column_id(name)
            from yugabyte_tpu_torch.docdb.subdocument import subdocument_writes
            path = (("col", cid),)
            for op, payload in ops:
                if op == "replace":
                    out.extend(subdocument_writes(dk, path, dict(payload),
                                                  ttl_ms=self.ttl_ms))
                elif op == "merge":
                    # element writes WITHOUT the init marker: older
                    # entries at other keys survive (ExtendSubDocument)
                    for k, v in dict(payload).items():
                        out.extend(subdocument_writes(dk, path + (k,), v,
                                                      ttl_ms=self.ttl_ms))
                elif op == "del_keys":
                    for k in payload:
                        out.append((SubDocKey(dk, path + (k,)).encode(
                            include_ht=False), Value.tombstone().encode()))
                else:
                    raise ValueError(f"unknown collection op {op!r}")

    # ---------------------------------------------------------------- locks
    def lock_entries(self, schema: Schema,
                     kv_pairs: Optional[List[Tuple[bytes, bytes]]] = None
                     ) -> List[Tuple[bytes, IntentType]]:
        dk_encoded = self.doc_key.encode()
        if kv_pairs is None:
            kv_pairs = self.to_kv_pairs(schema)
        entries: List[Tuple[bytes, IntentType]] = []
        for full_key, _v in kv_pairs:
            prefixes = [dk_encoded] if full_key != dk_encoded else []
            entries.extend(doc_path_lock_entries(full_key, prefixes, is_write=True))
        return entries


def prepare_and_assemble(ops: Sequence[QLWriteOp], schema: Schema,
                         lock_manager, timeout_s: float = 10.0
                         ) -> Tuple[LockBatch, List[Tuple[bytes, bytes]]]:
    """Encode each op ONCE; derive both the lock batch and the flattened
    write batch from the same KV pairs (ref: docdb.h:109
    PrepareDocWriteOperation + :127 AssembleDocWriteBatch). The index in the
    returned list becomes the intra-batch write_id."""
    entries: List[Tuple[bytes, IntentType]] = []
    all_pairs: List[Tuple[bytes, bytes]] = []
    for op in ops:
        pairs = op.to_kv_pairs(schema)
        entries.extend(op.lock_entries(schema, pairs))
        if op.backfill_ht:
            all_pairs.extend((k, v, op.backfill_ht) for k, v in pairs)
        else:
            all_pairs.extend(pairs)
    batch = lock_manager.lock(LockBatch(entries), timeout_s=timeout_s)
    return batch, all_pairs
