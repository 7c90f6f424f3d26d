"""QL-style row writes -> flattened DocDB KV pairs (the part the pushdown
slice needs).

Counterpart of yugabyte_tpu/docdb/doc_operations.py (:30-116): a row
INSERT writes a *liveness* system column plus one KV per value column; an
UPDATE writes only the touched columns (a None value is a column
tombstone, CQL `SET c = null`); a row DELETE writes a tombstone at the
bare DocKey, which shadows every older column write. Collections,
DELETE_COLS and lock entries are not ported yet.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

from yugabyte_tpu_torch.common.schema import Schema
from yugabyte_tpu_torch.docdb.doc_key import (DocKey, PrimitiveType,
                                              PrimitiveValue)
from yugabyte_tpu_torch.docdb.value import Value


@lru_cache(maxsize=8192)
def column_key_suffix(cid: int) -> bytes:
    """Encoded column-id subkey (what SubDocKey appends after the doc
    key): `doc_key.encode() + column_key_suffix(cid)` is the column's
    key without the hybrid time."""
    buf = bytearray()
    PrimitiveValue.encode_column_id(cid, buf)
    return bytes(buf)


# System column marking row liveness; encoded with kSystemColumnId, so it
# sorts before all regular (kColumnId) columns of the row.
kLivenessColumnId = -1


class WriteOpKind(enum.Enum):
    INSERT = "insert"    # upsert full row + liveness marker
    UPDATE = "update"    # touched columns only, no liveness
    DELETE_ROW = "delete_row"


@dataclass
class QLWriteOp:
    """One row-level write. `values` maps value-column name -> primitive;
    a None value in an UPDATE deletes the column."""

    kind: WriteOpKind
    doc_key: DocKey
    values: Dict[str, PrimitiveType] = field(default_factory=dict)
    ttl_ms: Optional[int] = None

    def to_kv_pairs(self, schema: Schema) -> List[Tuple[bytes, bytes]]:
        """Flattened (subdoc_key_without_ht, encoded_value) pairs, in the
        order they receive intra-batch write ids."""
        dk_enc = self.doc_key.encode()
        if self.kind == WriteOpKind.DELETE_ROW:
            return [(dk_enc, Value.tombstone().encode())]
        out: List[Tuple[bytes, bytes]] = []
        if self.kind == WriteOpKind.INSERT:
            out.append((dk_enc + column_key_suffix(kLivenessColumnId),
                        Value(primitive=None, ttl_ms=self.ttl_ms).encode()))
        for name, v in self.values.items():
            key = dk_enc + column_key_suffix(schema.column_id(name))
            if v is None and self.kind == WriteOpKind.UPDATE:
                out.append((key, Value.tombstone().encode()))
            else:
                out.append((key,
                            Value(primitive=v, ttl_ms=self.ttl_ms).encode()))
        return out
