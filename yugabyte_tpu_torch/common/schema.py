"""Table schema: typed columns, hash/range key split.

Capability parity with yb::Schema / ColumnSchema (ref: src/yb/common/schema.h)
and the QL type system (ref: src/yb/common/ql_type.h), trimmed to the types the
doc store supports in round 1.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple


class DataType(enum.Enum):
    INT32 = "int32"
    INT64 = "int64"
    FLOAT = "float"
    DOUBLE = "double"
    STRING = "string"
    BINARY = "binary"
    BOOL = "bool"
    TIMESTAMP = "timestamp"
    # JSONB documents: stored as canonical compact JSON text (object keys
    # sorted) — the functional equivalent of the reference's binary jsonb
    # serialization, which also sorts object keys for searchability
    # (ref: src/yb/common/jsonb.h:40-44). Path navigation happens in the
    # query layer (-> / ->> operators).
    JSONB = "jsonb"


class SortingType(enum.Enum):
    ASC = "asc"
    DESC = "desc"


@dataclass(frozen=True)
class ColumnSchema:
    name: str
    type: DataType
    nullable: bool = True
    sorting: SortingType = SortingType.ASC
    # ALTER TABLE DROP COLUMN keeps the slot (PG's attisdropped): value
    # columns are addressed by POSITION-derived ids, so removing the slot
    # would shift every later column onto its neighbor's stored data
    dropped: bool = False
    # YCQL collection columns (LIST<T>/SET<T>/MAP<K,V>): ("list", "INT"),
    # ("set", "TEXT"), ("map", "TEXT", "INT"). Storage rides subdocuments
    # (docdb/subdocument.py); `type` stays the element-agnostic BINARY
    # (ref: common/ql_type.h collection types)
    collection: Optional[Tuple[str, ...]] = None
    # SERIAL columns: name of the master-backed sequence supplying the
    # default when an INSERT omits the column (ref: PG pg_attrdef +
    # sequence.c; YSQL's serial -> nextval default)
    default_seq: Optional[str] = None


@dataclass
class Schema:
    """Columns split into hash-key, range-key and value columns.

    Mirrors the reference's key layout: a 16-bit hash over the hashed columns
    prefixes the key, then hashed columns, then range columns, then value
    columns addressed by column id (ref: docdb/doc_key.h:42-82).
    """

    columns: List[ColumnSchema]
    num_hash_key_columns: int = 0
    num_range_key_columns: int = 0

    def __post_init__(self):
        names = [c.name for c in self.columns]
        if len(set(names)) != len(names):
            raise ValueError("duplicate column names")
        # Column ids: stable small ints, value columns only (keys are
        # positional). Dropped slots keep their position (so ids of later
        # columns never shift) but are not addressable by name.
        nk = self.num_key_columns
        self._column_ids: Dict[str, int] = {
            c.name: i - nk for i, c in enumerate(self.columns)
            if i >= nk and not c.dropped
        }

    @property
    def num_key_columns(self) -> int:
        return self.num_hash_key_columns + self.num_range_key_columns

    @property
    def hash_columns(self) -> List[ColumnSchema]:
        return self.columns[: self.num_hash_key_columns]

    @property
    def range_columns(self) -> List[ColumnSchema]:
        return self.columns[self.num_hash_key_columns: self.num_key_columns]

    @property
    def value_columns(self) -> List[ColumnSchema]:
        return [c for c in self.columns[self.num_key_columns:]
                if not c.dropped]

    def column_id(self, name: str) -> int:
        return self._column_ids[name]

    def column_by_id(self, cid: int) -> ColumnSchema:
        return self.columns[self.num_key_columns + cid]

    def column(self, name: str) -> ColumnSchema:
        for c in self.columns:
            if c.name == name and not c.dropped:
                return c
        raise KeyError(name)

    # ------------------------------------------------- schema evolution
    def with_added_column(self, name: str, type: DataType,
                          nullable: bool = True) -> "Schema":
        """ALTER TABLE ADD COLUMN: appended at the end — existing
        position-derived column ids are untouched, so no data rewrite
        (ref: the reference's online schema change, catalog_manager
        AlterTable + per-tablet schema version)."""
        if any(c.name == name and not c.dropped for c in self.columns):
            raise ValueError(f'column "{name}" already exists')
        return Schema(columns=self.columns + [ColumnSchema(name, type,
                                                           nullable)],
                      num_hash_key_columns=self.num_hash_key_columns,
                      num_range_key_columns=self.num_range_key_columns)

    def with_dropped_column(self, name: str) -> "Schema":
        """ALTER TABLE DROP COLUMN: the slot stays, tombstoned under a
        mangled unique name (PG attisdropped), so later columns keep their
        ids and a future ADD COLUMN may reuse the visible name."""
        from dataclasses import replace as _replace
        nk = self.num_key_columns
        out = list(self.columns)
        for i, c in enumerate(out):
            if c.name == name and not c.dropped:
                if i < nk:
                    raise ValueError(f'cannot drop key column "{name}"')
                out[i] = _replace(c, name=f"!dropped!{i}!{name}",
                                  dropped=True)
                return Schema(columns=out,
                              num_hash_key_columns=self.num_hash_key_columns,
                              num_range_key_columns=self.num_range_key_columns)
        raise KeyError(name)
