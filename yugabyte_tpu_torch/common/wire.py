"""Wire representations of common value objects (schema, doc keys, QL ops,
rows) shared by client, tserver and master.

Counterpart of yugabyte_tpu/common/wire.py, with the imports renamed. Its
dicts are the JAX package's, key for key, so a JAX Messenger and a port
server read each other's requests and answers.

The reference defines these as protobuf messages (ref: src/yb/common/
common.proto `SchemaPB`/`PartitionSchemaPB`, ql_protocol.proto
`QLWriteRequestPB`/`QLRowBlock`); here they are plain dicts over the RPC
codec's closed type set.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from yugabyte_tpu_torch.common import jsonb
from yugabyte_tpu_torch.common.partition import Partition, PartitionSchema
from yugabyte_tpu_torch.common.schema import (
    ColumnSchema, DataType, Schema, SortingType)
from yugabyte_tpu_torch.docdb.doc_key import DocKey
from yugabyte_tpu_torch.docdb.doc_operations import QLWriteOp, WriteOpKind


# ------------------------------------------------------------------ schema
def schema_to_wire(schema: Schema) -> dict:
    return {
        "columns": [[c.name, c.type.value, c.nullable, c.sorting.value,
                     c.dropped, list(c.collection) if c.collection else None,
                     c.default_seq]
                    for c in schema.columns],
        "num_hash": schema.num_hash_key_columns,
        "num_range": schema.num_range_key_columns,
    }


def schema_from_wire(w: dict) -> Schema:
    # elements 5 (dropped) and 6 (collection) are optional for wire /
    # sys-catalog back-compat
    return Schema(
        columns=[ColumnSchema(col[0], DataType(col[1]), col[2],
                              SortingType(col[3]),
                              bool(col[4]) if len(col) > 4 else False,
                              tuple(col[5]) if len(col) > 5 and col[5]
                              else None,
                              col[6] if len(col) > 6 else None)
                 for col in w["columns"]],
        num_hash_key_columns=w["num_hash"],
        num_range_key_columns=w["num_range"])


def partition_schema_to_wire(ps: PartitionSchema) -> dict:
    return {"hash_partitioning": ps.hash_partitioning}


def partition_schema_from_wire(w: dict) -> PartitionSchema:
    return PartitionSchema(hash_partitioning=w["hash_partitioning"])


def partition_to_wire(p: Partition) -> dict:
    return {"start": p.start, "end": p.end}


def partition_from_wire(w: dict) -> Partition:
    return Partition(start=w["start"], end=w["end"])


# ----------------------------------------------------------------- doc keys
def doc_key_to_wire(dk: DocKey) -> dict:
    return {"hash": list(dk.hash_components),
            "range": list(dk.range_components)}


def doc_key_from_wire(w: dict) -> DocKey:
    return DocKey(hash_components=tuple(w["hash"]),
                  range_components=tuple(w["range"]))


# ---------------------------------------------------------------- write ops
def write_op_to_wire(op: QLWriteOp) -> dict:
    w = {
        "kind": op.kind.value,
        "doc_key": doc_key_to_wire(op.doc_key),
        "values": dict(op.values),
        "ttl_ms": op.ttl_ms,
        "cols_to_delete": list(op.columns_to_delete),
    }
    if op.backfill_ht:
        w["backfill_ht"] = op.backfill_ht
    if op.collection_ops:
        # per column: ORDERED op list; ("replace"/"merge", {k: v}) ->
        # item list; ("del_keys", [k..])
        w["collection_ops"] = {
            c: [[o, sorted(p.items()) if isinstance(p, dict) else list(p)]
                for o, p in ops]
            for c, ops in op.collection_ops.items()}
    return w


def write_op_from_wire(w: dict) -> QLWriteOp:
    coll = {}
    for c, ops in (w.get("collection_ops") or {}).items():
        coll[c] = [(o, dict(p) if o in ("replace", "merge")
                    else [k for k in p]) for o, p in ops]
    return QLWriteOp(
        kind=WriteOpKind(w["kind"]),
        doc_key=doc_key_from_wire(w["doc_key"]),
        values=dict(w["values"]),
        ttl_ms=w["ttl_ms"],
        columns_to_delete=tuple(w["cols_to_delete"]),
        backfill_ht=w.get("backfill_ht"),
        collection_ops=coll)


# --------------------------------------------------------------------- rows
def row_to_wire(row) -> dict:
    """Row (docdb/doc_rowwise_iterator.Row) -> wire dict."""
    return {
        "doc_key": doc_key_to_wire(row.doc_key),
        "columns": {int(cid): v for cid, v in row.columns.items()},
        "write_ht": row.write_ht.value,
    }


def row_from_wire(w: Optional[dict]):
    if w is None:
        return None
    from yugabyte_tpu_torch.common.hybrid_time import HybridTime
    from yugabyte_tpu_torch.docdb.doc_rowwise_iterator import Row
    return Row(doc_key=doc_key_from_wire(w["doc_key"]),
               columns={int(c): v for c, v in w["columns"].items()},
               write_ht=HybridTime(w["write_ht"]))


# ------------------------------------------------------------------ filters
# Pushed-down WHERE predicates travel the wire as [col, op, value] triples;
# the SAME comparison semantics (incl. NULL handling: NULL matches nothing
# except !=) apply tserver-side (pushdown eval) and client-side (residual
# re-check), so the two can never diverge.
FILTER_OPS = {
    "=": lambda a, b: a == b,
    "!=": lambda a, b: a != b,
    "<": lambda a, b: a is not None and a < b,
    "<=": lambda a, b: a is not None and a <= b,
    ">": lambda a, b: a is not None and a > b,
    ">=": lambda a, b: a is not None and a >= b,
    # IN-list membership (b: sequence of literals). NULL never matches
    # either form, and NOT IN over a list containing NULL matches nothing
    # (PG three-valued logic; the executor pre-normalizes that case).
    "in": lambda a, b: a is not None and a in b,
    "not in": lambda a, b: a is not None and a not in b,
    # SQL LIKE (%/_ wildcards, full-string anchor); NULL never matches
    "like": lambda a, b: isinstance(a, str) and _like_match(b, a),
    "not like": lambda a, b: isinstance(a, str) and not _like_match(b, a),
    # IS [NOT] NULL (the filter value is ignored)
    "is null": lambda a, b: a is None,
    "is not null": lambda a, b: a is not None,
}


def _like_match(pattern: str, value: str) -> bool:
    """SQL LIKE evaluation: % = any run, _ = any one char, everything
    else literal (regex metacharacters escaped). Compiled patterns are
    cached — scans evaluate one pattern across many rows."""
    import re
    rx = _LIKE_CACHE.get(pattern)
    if rx is None:
        parts = []
        for ch in pattern:
            if ch == "%":
                parts.append(".*")
            elif ch == "_":
                parts.append(".")
            else:
                parts.append(re.escape(ch))
        rx = re.compile("^" + "".join(parts) + "$", re.DOTALL)
        if len(_LIKE_CACHE) > 256:
            _LIKE_CACHE.clear()
        _LIKE_CACHE[pattern] = rx
    return rx.match(value) is not None


_LIKE_CACHE: dict = {}


def row_matches(row_dict: dict, filters) -> bool:
    """Conjunction of [col, op, value] triples over a name->value dict.

    col is normally a column name; a ["jsonb", column, path, as_text]
    list applies a jsonb -> / ->> chain before comparing — the pushdown
    form of jsonb predicates (ref: pggate pushes jsonb operators to the
    tserver scan in PgDocOp; common/jsonb.cc evaluates them there)."""
    for col, op, value in filters:
        fn = FILTER_OPS.get(op)
        if fn is None:
            raise ValueError(f"unsupported filter op {op!r}")
        if isinstance(col, (list, tuple)) and len(col) == 4 \
                and col[0] == "jsonb":
            have = jsonb.navigate(row_dict.get(col[1]), col[2], col[3])
        else:
            have = row_dict.get(col)
        if not fn(have, value):
            return False
    return True
