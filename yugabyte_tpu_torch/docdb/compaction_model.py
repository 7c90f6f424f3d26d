"""Reference semantic model of compaction MVCC GC — the differential oracle.

Counterpart of yugabyte_tpu/docdb/compaction_model.py, with the imports renamed.

An intentionally simple, loop-based implementation of the same rules the device
kernels (ops/merge_gc.py: A, B) implement with segmented ops. Used by randomized
differential tests, mirroring the reference's model-check strategy
(ref: docdb/randomized_docdb-test.cc + docdb/in_mem_docdb.h) against the real
filter semantics (ref: docdb/docdb_compaction_filter.cc:74-320).

Entries: (key_prefix: bytes, doc_key_len: int, dht: DocHybridTime,
          is_tombstone, is_object_init, ttl_ms or None, payload_id)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime, HybridTime


@dataclass(frozen=True)
class ModelEntry:
    key: bytes
    doc_key_len: int
    dht: DocHybridTime
    is_tombstone: bool = False
    is_object_init: bool = False
    ttl_ms: Optional[int] = None
    payload_id: int = 0


@dataclass(frozen=True)
class ModelResult:
    entry: ModelEntry
    as_tombstone: bool = False  # value rewritten to tombstone (TTL expiry)


def sort_key(e: ModelEntry):
    """Internal key order: key asc, then DocHybridTime DESC."""
    return (e.key, -e.dht.ht.value, -e.dht.write_id)


def _common_bytes(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


def compact_model(entries: List[ModelEntry], history_cutoff_ht: int,
                  is_major: bool, retain_deletes: bool = False) -> List[ModelResult]:
    """Full overwrite-STACK semantics, mirroring the reference filter
    exactly (ref: docdb/docdb_compaction_filter.cc:104-198):

    - per-component overwrite hybrid-time stack (sub_key_ends_/overwrite_);
      a kept entry at or below the cutoff pushes max(parent_ov, own dht) for
      its subtree, so an overwrite/delete at ANY level covers strictly-older
      entries at every deeper level
    - obsolete check is strict (`ht < prev_overwrite_ht`); it also subsumes
      same-key shadowing (the stack top for a repeated key is its own newer
      version's overwrite entry)
    - entries above the cutoff are retained history and push their parent's
      overwrite unchanged
    - visible tombstones (incl. TTL-expired) drop at major compactions;
      at minor compactions expired values rewrite to tombstones
    """
    from yugabyte_tpu_torch.ops.slabs import subkey_bounds

    ordered = sorted(entries, key=sort_key)
    cutoff_phys_us = history_cutoff_ht >> 12

    def expired(e: ModelEntry) -> bool:
        if e.ttl_ms is None:
            return False
        return (e.dht.ht.physical_micros + e.ttl_ms * 1000) <= cutoff_phys_us

    MIN_OV = (-1, -1)
    out: List[ModelResult] = []
    sub_key_ends: List[int] = []
    overwrite: List[tuple] = []
    prev_key = b""
    for e in ordered:
        same = _common_bytes(e.key, prev_key)
        ns = len(sub_key_ends)
        while ns > 0 and sub_key_ends[ns - 1] > same:
            ns -= 1
        # Re-derive component ends for the current key (the reference
        # resumes decoding from the shared prefix; bounds depend only on
        # the key bytes, so a full parse is equivalent).
        try:
            sub_key_ends = subkey_bounds(e.key, e.doc_key_len)
        except (ValueError, IndexError, struct.error):
            # undecodable subkey tail (system keys): one trailing component
            sub_key_ends = ([e.doc_key_len, len(e.key)]
                            if e.doc_key_len < len(e.key)
                            else [len(e.key)])
        new_size = len(sub_key_ends)
        del overwrite[min(len(overwrite), ns):]
        prev_ov = overwrite[-1] if overwrite else MIN_OV
        dht_t = (e.dht.ht.value, e.dht.write_id)
        if dht_t < prev_ov:
            continue  # fully overwritten at/before the cutoff (strict <)
        if len(overwrite) < new_size - 1:
            overwrite.extend([prev_ov] * (new_size - 1 - len(overwrite)))
        if len(overwrite) == new_size:
            overwrite.pop()  # same key as previous: replace the stack top
        below = e.dht.ht.value <= history_cutoff_ht
        if not below:
            overwrite.append(prev_ov)
            prev_key = e.key
            out.append(ModelResult(e))  # retained history above the cutoff
            continue
        overwrite.append(max(prev_ov, dht_t))
        prev_key = e.key
        tomb = e.is_tombstone or expired(e)
        if tomb and is_major and not retain_deletes:
            continue  # visible tombstone at bottommost level: gone for good
        out.append(ModelResult(e, as_tombstone=(expired(e)
                                                and not e.is_tombstone
                                                and not is_major)))
    return out
