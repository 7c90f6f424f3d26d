"""DocRowwiseIterator: assemble rows from flattened MVCC KV pairs.

Counterpart of yugabyte_tpu/docdb/doc_rowwise_iterator.py (ref:
src/yb/docdb/doc_rowwise_iterator.cc:1036 Init, src/yb/docdb/doc_reader.h:73
DocDBTableReader, src/yb/docdb/subdoc_reader.h:80). Two stages, shared by the
host and device paths:

  RESOLVE — reduce the raw (internal_key, value) stream to exactly the
  visible version of each doc path at read_ht:
    * host: `DocRowwiseIterator._resolve_visible` walks the merged stream of
      a DB in memcmp order — key ascending, DocHybridTime DESCENDING — so
      for each distinct doc path the FIRST version with ht <= read_ht wins;
    * device: the scan kernels (ops/scan.py: G, H, I.1, B) compute the
      same set on the device for a whole key range at once.

  ASSEMBLE — `VisibleEntryRowAssembler` groups the resolved entries into
  rows (pure grouping; all visibility logic already happened).

Visibility rules implemented (matching docdb semantics):
  - a bare-DocKey entry (row tombstone OR object init marker) shadows every
    older subdocument write (init-marker overwrite semantics);
  - a column whose visible version is a tombstone is absent;
  - TTL: a value written at `t` with ttl expires at t + ttl — reads at or
    after the expiry treat it as absent (ref: docdb_compaction_filter.cc
    expiry rules :260-279 applied here at read time);
  - a row exists iff its liveness system column or any value column is
    visible (ref: doc_reader.cc row existence via liveness).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Sequence, Tuple

from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime, HybridTime
from yugabyte_tpu_torch.common.schema import Schema
from yugabyte_tpu_torch.docdb.doc_key import DocKey, SubDocKey, split_key_and_ht
from yugabyte_tpu_torch.docdb.doc_operations import kLivenessColumnId
from yugabyte_tpu_torch.docdb.value import Value
from yugabyte_tpu_torch.docdb.value_type import ValueType
from yugabyte_tpu_torch.ops.slabs import _doc_key_len


def _is_expired(value: Value, write_dht: DocHybridTime,
                read_ht: HybridTime) -> bool:
    if value.ttl_ms is None:
        return False
    expiry_micros = write_dht.ht.physical_micros + value.ttl_ms * 1000
    return read_ht.physical_micros >= expiry_micros


@dataclass
class Row:
    doc_key: DocKey
    columns: Dict[int, object]      # column id -> decoded primitive
    write_ht: HybridTime            # max HT contributing to this row

    def to_dict(self, schema: Schema) -> Dict[str, object]:
        out: Dict[str, object] = {}
        for c, v in zip(schema.hash_columns, self.doc_key.hash_components):
            out[c.name] = v
        for c, v in zip(schema.range_columns, self.doc_key.range_components):
            out[c.name] = v
        for c in schema.value_columns:
            cid = schema.column_id(c.name)
            out[c.name] = self.columns.get(cid)
        return out


class VisibleEntryRowAssembler:
    """Group an already-MVCC-resolved entry stream into rows.

    Input entries are (key_prefix, value_bytes, ht_value) in key order with
    exactly one visible version per doc path — no tombstones, no shadowed
    history (see module docstring). Paging interface: rows(limit) +
    next_doc_key (the resume key when a limit was hit).
    """

    def __init__(self, entries, schema: Schema,
                 projection: Optional[Sequence[int]] = None):
        self._entries = entries
        self._schema = schema
        # projection entries are column IDS; column NAMES (what the RPC
        # layer carries) translate here — ONE place, so the leader read,
        # follower read and scan paths all agree. Unknown names are
        # never matched (like projecting a just-dropped column).
        if projection is not None:
            ids = set()
            for c in projection:
                if isinstance(c, str):
                    try:
                        ids.add(schema.column_id(c))
                    except KeyError:
                        pass
                else:
                    ids.add(c)
            self._projection = ids
        else:
            self._projection = None
        self.next_doc_key: Optional[bytes] = None

    def __iter__(self) -> Iterator[Row]:
        return self.rows()

    def rows(self, limit: Optional[int] = None) -> Iterator[Row]:
        cur_doc: Optional[bytes] = None
        columns: Dict[int, object] = {}
        liveness = False  # row exists: liveness marker OR any visible column,
        #                   tracked independently of the projection
        max_ht = HybridTime.kMin
        emitted = 0

        def finish() -> Optional[Row]:
            if cur_doc is None or not liveness:
                return None
            dk, _ = DocKey.decode(cur_doc)
            return Row(dk, dict(columns), max_ht)

        col_marker: Dict[int, int] = {}  # cid -> overwrite point ht

        for key, raw_value, ht_value in self._entries:
            dk_len = _doc_key_len(key)
            doc = key[:dk_len]
            if doc != cur_doc:
                row = finish()
                if row is not None:
                    yield row
                    emitted += 1
                    if limit is not None and emitted >= limit:
                        self.next_doc_key = doc
                        return
                cur_doc = doc
                columns = {}
                col_marker = {}
                liveness = False
                max_ht = HybridTime.kMin
            ht = HybridTime(ht_value)
            if ht.value > max_ht.value:
                max_ht = ht
            if not key[dk_len:]:
                liveness = True  # visible init marker
                continue
            sdk = SubDocKey.decode(key)
            if not (sdk.subkeys
                    and isinstance(sdk.subkeys[0], tuple)
                    and sdk.subkeys[0][0] == "col"):
                continue  # non-column subdocument paths: not a row part
            cid = sdk.subkeys[0][1]
            liveness = True  # any visible column proves the row exists
            if cid == kLivenessColumnId:
                continue
            if self._projection is not None and cid not in self._projection:
                continue
            if len(sdk.subkeys) == 1:
                value = Value.decode(raw_value)
                col_marker[cid] = ht_value
                if value.is_object:
                    # collection init marker: an (empty) container that
                    # OVERWRITES the older subtree at this column
                    columns[cid] = {}
                else:
                    columns[cid] = value.primitive
                continue
            # collection element ((col,cid), k, ...) — the resolve stage
            # already picked the newest visible version per exact path;
            # cross-path shadowing by the column's overwrite point
            # (replace marker or primitive) applies here
            # (ref: subdoc_reader.cc overwrite stack)
            if cid in col_marker and ht_value < col_marker[cid]:
                continue  # older than the column's replace/overwrite
            container = columns.get(cid)
            if not isinstance(container, dict):
                # no marker (merge-without-marker) or a resurrected
                # collection over an older primitive
                container = {}
                columns[cid] = container
            node = container
            for comp in sdk.subkeys[1:-1]:
                nxt = node.get(comp)
                if not isinstance(nxt, dict):
                    nxt = {}
                    node[comp] = nxt
                node = nxt
            value = Value.decode(raw_value)
            node[sdk.subkeys[-1]] = {} if value.is_object \
                else value.primitive
        row = finish()
        if row is not None:
            yield row
        self.next_doc_key = None


class DocRowwiseIterator:
    """CPU scan path: resolve MVCC inline while walking the merged stream,
    then assemble through the shared VisibleEntryRowAssembler."""

    def __init__(self, db, schema: Schema, read_ht: HybridTime,
                 lower_doc_key: bytes = b"",
                 upper_doc_key: Optional[bytes] = None,
                 projection: Optional[Sequence[int]] = None,
                 entry_stream=None):
        """entry_stream: optional pre-merged (internal_key, value) iterator
        replacing the plain DB stream — the IntentAwareIterator overlays
        provisional records this way (ref intent_aware_iterator.h)."""
        self._db = db
        self._schema = schema
        self._read_ht = read_ht
        self._lower = lower_doc_key
        self._upper = upper_doc_key
        self._entry_stream = entry_stream
        self._assembler = VisibleEntryRowAssembler(
            self._visible_stream(), schema, projection=projection)

    def _visible_stream(self):
        """RESOLVE stage: the native read engine computes visibility in C++
        when available (native/read_engine.cc mode 1 — the same semantics
        as _resolve_visible, differentially tested); Python resolves
        otherwise or when an intent overlay stream is supplied."""
        if self._entry_stream is None and hasattr(self._db, "scan_native"):
            scan = self._db.scan_native(
                lower=self._lower, upper=self._upper,
                read_ht_value=self._read_ht.value, visible=True,
                batch_rows=8192)
            if scan is not None:
                return ((k, v, ht) for k, v, ht, _w, _f, _d
                        in scan.entries())
        return self._resolve_visible()

    @property
    def next_doc_key(self) -> Optional[bytes]:
        return self._assembler.next_doc_key

    def __iter__(self) -> Iterator[Row]:
        return self.rows()

    def rows(self, limit: Optional[int] = None) -> Iterator[Row]:
        return self._assembler.rows(limit)

    def _resolve_visible(self) -> Iterator[Tuple[bytes, bytes, int]]:
        """Yield (key, value_bytes, ht_value) of exactly the visible version
        of each doc path at read_ht (the stream the scan kernels produce on
        the device for the whole range at once)."""
        read_ht = self._read_ht
        cur_doc: Optional[bytes] = None
        # Overwrite-point STACK over subpath prefixes (the same rule
        # read_subdocument and the compaction model apply): EVERY newest-
        # visible entry — bare-DocKey marker/tombstone, column value or
        # tombstone, collection replace marker — replaces the older
        # subtree at its path, so strictly-older descendants are shadowed.
        ov_stack: list = []   # [(subpath, DocHybridTime)] prefix-nested
        seen_paths: set = set()
        stream = (self._entry_stream if self._entry_stream is not None
                  else self._db.iter_from(self._lower))
        for ikey, raw_value in stream:
            prefix, dht = split_key_and_ht(ikey)
            if dht is None:
                continue
            dk_len = _doc_key_len(prefix)
            doc = prefix[:dk_len]
            if self._upper is not None and doc >= self._upper:
                break
            if doc != cur_doc:
                cur_doc = doc
                ov_stack = []
                seen_paths = set()
            if dht.ht.value > read_ht.value:
                continue  # newer than the snapshot
            subpath = prefix[dk_len:]
            if subpath in seen_paths:
                continue  # older version of an already-resolved path
            seen_paths.add(subpath)
            while ov_stack and not subpath.startswith(ov_stack[-1][0]):
                ov_stack.pop()
            value = Value.decode(raw_value)
            shadowed = any(dht < ov for _p, ov in ov_stack)
            dead = (value.is_tombstone or shadowed
                    or _is_expired(value, dht, read_ht))
            ov_stack.append((subpath, dht))
            if not dead:
                yield prefix, raw_value, dht.ht.value


def read_row(db, schema: Schema, doc_key: DocKey, read_ht: HybridTime,
             projection: Optional[Sequence[int]] = None,
             entry_stream=None) -> Optional[Row]:
    """Point row lookup (the QL read-one path)."""
    encoded = doc_key.encode()
    it = DocRowwiseIterator(db, schema, read_ht, lower_doc_key=encoded,
                            upper_doc_key=encoded + bytes([ValueType.kMaxByte]),
                            projection=projection,
                            entry_stream=entry_stream)
    for row in it:
        return row
    return None
