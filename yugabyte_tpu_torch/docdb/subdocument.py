"""Arbitrary-depth subdocument write + read (ref: docdb SubDocument —
doc_writer SetPrimitive/InsertSubDocument in src/yb/docdb/doc_write_batch.cc
and assembly in subdoc_reader.cc / doc_reader.cc).

Counterpart of yugabyte_tpu/docdb/subdocument.py, with the imports renamed.

Writes flatten a nested dict into (SubDocKey, Value) pairs: every dict
level gets an OBJECT INIT MARKER at its own path, which OVERWRITES the
older subtree at that path (the overwrite-stack semantics the compaction
model and the FLAG_DEEP kernel routing already enforce for GC —
docdb/compaction_model.py carries the same stack).

Reads walk the merged entry stream under the path prefix once, maintain
the ancestor overwrite stack, pick the visible version of each path at
the read time, and assemble the nested Python value.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime, HybridTime
from yugabyte_tpu_torch.docdb.doc_key import DocKey, SubDocKey
from yugabyte_tpu_torch.docdb.value import Value
from yugabyte_tpu_torch.docdb.value_type import ValueType

PathType = Tuple[object, ...]


def subdocument_writes(doc_key: DocKey, path: PathType, doc,
                       ttl_ms: Optional[int] = None
                       ) -> List[Tuple[bytes, bytes]]:
    """Flatten `doc` rooted at doc_key/path into (key_prefix, value) pairs.

    A dict value emits an object init marker at its path — replacing any
    older subtree there (ref InsertSubDocument's init-marker write) —
    then recurses. A primitive emits one leaf. None emits a tombstone
    (subtree delete)."""
    out: List[Tuple[bytes, bytes]] = []

    def emit(p: PathType, v) -> None:
        key = SubDocKey(doc_key, tuple(p)).encode(include_ht=False)
        if v is None:
            out.append((key, Value.tombstone().encode()))
        elif isinstance(v, dict):
            out.append((key, Value(is_object=True, ttl_ms=ttl_ms).encode()))
            for k in v:
                emit(p + (k,), v[k])
        else:
            out.append((key, Value(primitive=v, ttl_ms=ttl_ms).encode()))

    emit(tuple(path), doc)
    return out


def delete_subdocument(doc_key: DocKey, path: PathType
                       ) -> List[Tuple[bytes, bytes]]:
    """A tombstone at the path shadows the whole older subtree."""
    key = SubDocKey(doc_key, tuple(path)).encode(include_ht=False)
    return [(key, Value.tombstone().encode())]


def read_subdocument(db, doc_key: DocKey, path: PathType = (),
                     read_ht: Optional[HybridTime] = None,
                     entry_stream=None):
    """Assemble the subdocument at doc_key/path visible at read_ht.

    Returns a nested dict / primitive, or None if absent or deleted.
    Semantics mirror the GC model's overwrite stack
    (docdb/compaction_model.py): for each path the FIRST version at or
    below read_ht is the visible one; it is dead if it is a tombstone or
    if ANY ancestor's visible overwrite (object marker or tombstone) is
    newer than it (strict >, exact ties are not covered — ref
    docdb_compaction_filter.cc:166)."""
    from yugabyte_tpu_torch.docdb.doc_key import split_key_and_ht

    read_ht = read_ht or HybridTime.kMax
    prefix = SubDocKey(doc_key, tuple(path)).encode(include_ht=False)
    upper = prefix + bytes([ValueType.kMaxByte])

    # Ancestors STRICTLY ABOVE the requested path sort before the scan
    # prefix and would never be seen — but their visible version
    # (tombstone, object marker, or primitive: each replaces the older
    # subtree) shadows strictly-older descendants. Point-resolve each and
    # seed the overwrite stack, or a deep-path read would return data a
    # parent-level delete already removed.
    stack: List[Tuple[bytes, DocHybridTime]] = []
    for i in range(len(path)):
        anc_key = SubDocKey(doc_key, tuple(path[:i])).encode(
            include_ht=False)
        got = db.get(anc_key, read_ht)
        if got is not None:
            # tombstone, object marker or primitive: each is an overwrite
            # point — strictly-older descendants are shadowed, newer ones
            # survive (resurrection), exactly the in-range stack rule
            stack.append((anc_key, got[0]))

    if entry_stream is None:
        entry_stream = db.iter_from(prefix)
    seen: set = set()
    result: List[Tuple[PathType, object]] = []   # visible leaves/objects

    for ikey, raw_value in entry_stream:
        kp, dht = split_key_and_ht(ikey)
        if kp < prefix:
            continue
        if kp >= upper:
            break
        if dht is None or dht.ht.value > read_ht.value:
            continue  # newer than the snapshot
        if kp in seen:
            continue  # older version of an already-resolved path
        seen.add(kp)
        # pop ancestors that are not a prefix of this key
        while stack and not kp.startswith(stack[-1][0]):
            stack.pop()
        shadowed = any(dht < ov for _p, ov in stack)
        value = Value.decode(raw_value)
        # EVERY visible entry — tombstone, object marker, or primitive —
        # replaces the older subtree at its path, so each becomes an
        # overwrite point (a primitive at 'a' obsoletes an older 'a.x';
        # a NEWER 'a.x' resurrects 'a' as an object)
        stack.append((kp, dht))
        if shadowed or value.is_tombstone:
            continue
        subpath = SubDocKey.decode(kp).subkeys
        rel = subpath[len(path):]
        if value.is_object:
            result.append((tuple(rel), {}))
        else:
            result.append((tuple(rel), value.primitive))

    if not result:
        return None
    # assemble: parents appear before children (key order)
    root: dict = {}
    root_set = [False, None]
    for rel, v in result:
        if not rel:
            if isinstance(v, dict):
                root_set[0] = True
            else:
                root_set[0] = True
                root_set[1] = v
            continue
        node = root
        for comp in rel[:-1]:
            nxt = node.get(comp)
            if not isinstance(nxt, dict):
                # a surviving child is provably NEWER than any visible
                # non-dict value at this level (the overwrite stack
                # filtered older ones): the subtree resurrects as an
                # object containing the child
                nxt = {}
                node[comp] = nxt
            node = nxt
        node[rel[-1]] = {} if isinstance(v, dict) else v
    if root_set[1] is not None and not root:
        # the path itself is a primitive AND nothing newer resurrected it
        # as an object (surviving descendants are provably newer than the
        # visible primitive — a newer primitive would have shadowed them)
        return root_set[1]
    if not root and not root_set[0]:
        return None
    return root
