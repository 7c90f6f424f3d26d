"""ScanSpec: the pushed-down query fragment a scan carries to storage.

A copy of yugabyte_tpu/docdb/scan_spec.py over this package's schema,
doc_key and value_type, plus `scan_spec_from_reference`. A query's WHERE
conjunction + aggregate list, classified into the device-compilable
subset, is this ScanSpec; `ops/scan.py`'s filtered and aggregating scans
evaluate it on the card (kernels J and K), so predicate checks and
COUNT/SUM/MIN/MAX reductions happen where the data sits instead of
surfacing every row to host Python.

The compilable subset is deliberately EXACT, never approximate: a
predicate compiles only when the device's encoded-byte comparison is
provably identical to the host path's decoded-Python comparison —
  - integer-family columns (INT32/INT64/TIMESTAMP): every int encodes as
    kInt64 + big-endian offset binary (docdb/doc_key.py), so memcmp
    order == numeric order and byte equality == value equality;
  - BOOL columns: the value IS the tag byte (kFalse=70 < kTrue=84,
    matching Python False < True).
Floats are excluded (the -0.0/NaN corners of IEEE comparison diverge
from the order-preserving byte transform), strings are excluded
(variable width exceeds the fixed value-word stride), collections/jsonb
are excluded (their "value" is a subdocument). Anything outside the
subset falls back to the host path per query, byte/result-identically.

NULL semantics are mode-exact: the AGGREGATE path implements the CQL
executor's `_match` (a NULL/absent column fails the row for EVERY
operator, `!=` included — there is no per-row re-check downstream of a
scalar), while the ROW-SCAN path implements the wire filter contract
(`common/wire.FILTER_OPS`, what the tserver's host fallback and the
pgsql pushdown evaluate): NULL fails everything EXCEPT `!=`, which it
passes — packed on device as NOT(exists an equal entry). On device the
NULL exclusion is the payload-tag check — a kNullLow payload never
matches a kInt64/kTrue/kFalse tag pair.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from yugabyte_tpu_torch.common.schema import DataType, Schema
from yugabyte_tpu_torch.docdb.doc_key import PrimitiveValue
from yugabyte_tpu_torch.docdb.value_type import ValueType


class PushdownUnsupported(Exception):
    """A compiled ScanSpec hit a storage-side blocker (deep documents,
    missing device, oversized batch, ...): the caller must serve the
    query through the host path. `reason` keys the fallback counter."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


# operators the fused kernel evaluates (op codes are kernel operand data)
PUSHDOWN_OPS = ("=", "!=", "<", "<=", ">", ">=")
OP_CODES = {op: i + 1 for i, op in enumerate(PUSHDOWN_OPS)}  # 0 = inactive

# integer-family column types: stored payloads are kInt64 + 8B biased BE
_INT_TYPES = (DataType.INT32, DataType.INT64, DataType.TIMESTAMP)

AGG_FNS = ("count", "sum", "avg", "min", "max")

# value words per entry staged for pushdown: 3 words = 12 bytes covers
# the widest compilable payload (kInt64 tag + 8 bytes = 9)
VAL_WORDS = 3


@dataclass(frozen=True)
class ColPredicate:
    """One compiled column comparison: `col op literal`."""
    col: str
    cid: int
    op: str
    value: object
    enc: bytes           # encoded payload bytes of the literal
    tag_a: int           # acceptable payload tag byte(s): a stored value
    tag_b: int           # outside {tag_a, tag_b} fails the row (NULLs)


@dataclass(frozen=True)
class AggSpec:
    """One aggregate over the filtered row set. col/cid are None for
    COUNT(*)."""
    fn: str
    col: Optional[str] = None
    cid: Optional[int] = None
    tag_a: int = 0
    tag_b: int = 0


@dataclass(frozen=True)
class ScanSpec:
    """Predicate conjunction + aggregate list the kernels evaluate."""
    predicates: Tuple[ColPredicate, ...] = ()
    aggregates: Tuple[AggSpec, ...] = ()

    @property
    def needs_vals(self) -> bool:
        """True when the dispatch needs the staged value words: any
        column predicate, or any aggregate naming a column (COUNT(col)
        checks the payload tag to exclude NULLs)."""
        return bool(self.predicates) or any(a.cid is not None
                                            for a in self.aggregates)

    @property
    def agg_cids(self) -> Tuple[int, ...]:
        """Distinct aggregated column ids, in first-appearance order."""
        seen: List[int] = []
        for a in self.aggregates:
            if a.cid is not None and a.cid not in seen:
                seen.append(a.cid)
        return tuple(seen)


def _column(schema: Schema, name):
    if not isinstance(name, str):
        return None
    try:
        return schema.column(name)
    except KeyError:
        return None


def _value_tags(col_type: DataType, value) -> Optional[Tuple[int, int]]:
    """(tag_a, tag_b) acceptable payload tags for a literal on a column,
    or None when the (type, literal) pair is outside the subset."""
    if col_type in _INT_TYPES:
        if isinstance(value, bool) or not isinstance(value, int):
            return None
        return (int(ValueType.kInt64), int(ValueType.kInt64))
    if col_type is DataType.BOOL:
        if not isinstance(value, bool):
            return None
        return (int(ValueType.kFalse), int(ValueType.kTrue))
    return None


def encode_literal(value) -> bytes:
    """Encoded DocValue payload bytes of a predicate literal — exactly
    what a stored (non-NULL, non-TTL'd) cell of that value holds."""
    buf = bytearray()
    PrimitiveValue.encode(value, buf)
    return bytes(buf)


def compile_predicate(schema: Schema, col, op: str,
                      value) -> Optional[ColPredicate]:
    """Compile one WHERE triple, or None when outside the subset (wrong
    op, key column, collection/jsonb/float/string column, mistyped or
    NULL literal)."""
    if op not in PUSHDOWN_OPS or value is None:
        return None
    c = _column(schema, col)
    if c is None or c.collection is not None:
        return None
    key_names = {k.name for k in schema.hash_columns} | \
        {k.name for k in schema.range_columns}
    if col in key_names:
        # key components are pushed as encoded byte BOUNDS by the scan
        # planner, not as value predicates (they have no column entry)
        return None
    tags = _value_tags(c.type, value)
    if tags is None:
        return None
    return ColPredicate(col=col, cid=schema.column_id(col), op=op,
                        value=value, enc=encode_literal(value),
                        tag_a=tags[0], tag_b=tags[1])


def compile_aggregate(schema: Schema, fn: str,
                      col: Optional[str]) -> Optional[AggSpec]:
    """Compile one aggregate, or None when outside the subset. SUM/AVG/
    MIN/MAX compile only over integer-family columns (exact byte-column
    sums + biased-limb min/max); COUNT(col) additionally over BOOL."""
    fn = fn.lower()
    if fn not in AGG_FNS:
        return None
    if col is None:
        return AggSpec(fn="count") if fn == "count" else None
    c = _column(schema, col)
    if c is None or c.collection is not None:
        return None
    key_names = {k.name for k in schema.hash_columns} | \
        {k.name for k in schema.range_columns}
    if col in key_names:
        # key components have no column entries to reduce over (and a
        # key is never NULL — the host path answers COUNT(key) exactly)
        return None
    if c.type in _INT_TYPES:
        tags = (int(ValueType.kInt64), int(ValueType.kInt64))
    elif c.type is DataType.BOOL and fn == "count":
        tags = (int(ValueType.kFalse), int(ValueType.kTrue))
    else:
        return None
    return AggSpec(fn=fn, col=col, cid=schema.column_id(col),
                   tag_a=tags[0], tag_b=tags[1])


def compile_filters(schema: Schema, filters: Optional[Sequence[Sequence]],
                    aggregates: Optional[Sequence[Sequence]] = None
                    ) -> Tuple[Optional[ScanSpec], List[List], str]:
    """Classify a wire filter conjunction (+ optional aggregate list)
    into (spec, leftover_filters, reason).

    spec is None — with `reason` naming the first blocker — when nothing
    is pushable, or when aggregates were requested but ANY aggregate or
    ANY filter is outside the subset (an aggregating scan cannot half-
    push: the scalar must be computed over exactly the filtered row
    set). For row scans partial pushdown is fine: leftover_filters are
    evaluated host-side after the fused filter."""
    filters = filters or ()
    preds: List[ColPredicate] = []
    leftover: List[List] = []
    reason = ""
    for f in filters:
        col, op, value = f[0], f[1], f[2]
        p = compile_predicate(schema, col, op, value)
        if p is None:
            leftover.append(list(f))
            reason = reason or ("op" if op not in PUSHDOWN_OPS else "type")
        else:
            preds.append(p)
    if aggregates:
        aggs: List[AggSpec] = []
        for a in aggregates:
            spec = compile_aggregate(schema, a[0], a[1])
            if spec is None:
                return None, [list(f) for f in filters], "agg_type"
            aggs.append(spec)
        if leftover:
            return None, [list(f) for f in filters], reason or "type"
        return ScanSpec(tuple(preds), tuple(aggs)), [], ""
    if not preds:
        return None, leftover, reason or "no_predicates"
    return ScanSpec(tuple(preds)), leftover, ""


def combine_agg_partials(partials: Sequence[dict]) -> dict:
    """Merge per-tablet aggregate partials (disjoint row sets): counts
    and sums add, mins/maxes reduce, None means "no qualifying rows"."""
    out = {"rows": 0, "cols": {}}
    for p in partials:
        out["rows"] += int(p.get("rows", 0))
        for cid, st in (p.get("cols") or {}).items():
            cid = int(cid)
            dst = out["cols"].setdefault(
                cid, {"nonnull": 0, "sum": 0, "min": None, "max": None})
            dst["nonnull"] += int(st.get("nonnull", 0))
            dst["sum"] += int(st.get("sum", 0))
            for k, pick in (("min", min), ("max", max)):
                v = st.get(k)
                if v is None:
                    continue
                dst[k] = v if dst[k] is None else pick(dst[k], v)
    return out


def scan_spec_from_reference(spec) -> ScanSpec:
    """State carry-over: this package's ScanSpec from another package's
    compiled ScanSpec, read as plain fields (predicates: col, cid, op,
    value, enc, tag_a, tag_b; aggregates: fn, col, cid, tag_a, tag_b), so
    that differential tests feed both implementations the same query."""
    preds = tuple(ColPredicate(col=p.col, cid=int(p.cid), op=str(p.op),
                               value=p.value, enc=bytes(p.enc),
                               tag_a=int(p.tag_a), tag_b=int(p.tag_b))
                  for p in spec.predicates)
    aggs = tuple(AggSpec(fn=str(a.fn), col=a.col,
                         cid=None if a.cid is None else int(a.cid),
                         tag_a=int(a.tag_a), tag_b=int(a.tag_b))
                 for a in spec.aggregates)
    return ScanSpec(preds, aggs)
