"""SST files: split base/data layout, slab blocks, bloom, frontiers.

Capability parity with the reference's BlockBasedTable (ref:
src/yb/rocksdb/table/block_based_table_reader.cc:387 Open,
block_based_table_builder.cc) including YB's split-SST layout — a small base
file with metadata/index/filter plus a separate data file
(ref: table/block_based_table_factory.h:65 IsSplitSstForWriteSupported,
db/filename.h:92 TableBaseToDataFileName) — and per-file UserFrontiers
(ref: rocksdb/metadata.h UserFrontier, docdb/consensus_frontier.h:35).

Base file layout:
    [index block][bloom bytes][props json]
    footer: <Q index_off><I index_len><Q bloom_off><I bloom_len>
            <Q props_off><I props_len><Q data_size><I crc><Q magic>

The index is itself a slab block whose keys are each data block's LAST key
and whose values pack (data_offset, size, n_entries). Data file is a plain
concatenation of slab blocks (block_format.py).
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime
from yugabyte_tpu_torch.ops.slabs import KVSlab, concat_slabs
from yugabyte_tpu_torch.storage import block_format
from yugabyte_tpu_torch.storage.bloom import BloomFilter, BloomFilterBuilder, fnv64_masked
from yugabyte_tpu_torch.utils import flags as _sst_flags
from yugabyte_tpu_torch.utils.status import Status, StatusError

_sst_flags.define_flag("sst_block_entries", 4096,
                       "rows per SST block (fixed row count, not byte "
                       "size: device transfers like uniform shapes; ref "
                       "block_size docdb_rocksdb_util.cc)")
_sst_flags.define_flag("sst_compression", "none",
                       "SST block compression: 'none' or 'zlib' (ref "
                       "compression_type)",
                       validator=lambda v: v in ("none", "zlib"))
_sst_flags.define_flag("sst_bloom_bits_per_key", 10,
                       "doc-key bloom filter density (ref "
                       "BlockBasedTableOptions::filter_policy)")
_sst_flags.define_flag("sst_learned_index", True,
                       "fit a learned per-SST index at write time "
                       "(storage/learned_index.py) and persist it in the "
                       "properties block; ADVISORY ONLY — readers verify "
                       "predictions and fall back to the exact seek")

# host block decodes (SSTReader.read_block cache misses), process-wide: a
# warm chained compaction must add none
_decode_lock = threading.Lock()
_blocks_decoded = 0   # guarded-by: _decode_lock


def blocks_decoded() -> int:
    """Host block decodes so far in this process (every SSTReader)."""
    with _decode_lock:
        return _blocks_decoded


def sst_compression_enabled() -> bool:
    """Single authority for the compression-flag read (three writer
    paths share it); the codec name validates at set time."""
    return _sst_flags.get_flag("sst_compression") == "zlib"

SST_MAGIC = 0x59425453535431  # "YBTSST1"
_FOOTER = struct.Struct("<QIQIQIQIQ")


def data_file_name(base_path: str) -> str:
    """ref: TableBaseToDataFileName (db/filename.h:92)."""
    return base_path + ".sblock.0"


@dataclass
class Frontier:
    """Per-SST consensus frontier (ref: docdb/consensus_frontier.h:35)."""
    op_id_min: Tuple[int, int] = (0, 0)  # (term, index)
    op_id_max: Tuple[int, int] = (0, 0)
    ht_min: int = 0
    ht_max: int = 0
    history_cutoff: int = 0

    def to_json(self) -> dict:
        return {"op_id_min": list(self.op_id_min), "op_id_max": list(self.op_id_max),
                "ht_min": self.ht_min, "ht_max": self.ht_max,
                "history_cutoff": self.history_cutoff}

    @staticmethod
    def from_json(d: dict) -> "Frontier":
        return Frontier(tuple(d["op_id_min"]), tuple(d["op_id_max"]),
                        d["ht_min"], d["ht_max"], d["history_cutoff"])


@dataclass
class SSTProps:
    n_entries: int = 0
    first_key: bytes = b""
    last_key: bytes = b""
    frontier: Frontier = field(default_factory=Frontier)
    data_size: int = 0
    base_size: int = 0
    # Whole-file TTL drop metadata (ref: docdb/compaction_file_filter.h:60):
    # microseconds-physical time at which the LAST entry expires, or 0 when
    # any entry lacks a TTL (file never fully expires).
    max_expire_us: int = 0
    # any entry addresses a document deeper than row+column (FLAG_DEEP):
    # lets the compaction dispatcher decide device routing WITHOUT
    # decoding the file (the fused kernel handles depth-2 only)
    has_deep: bool = False
    # learned per-SST index (storage/learned_index.py) — OPTIONAL and
    # advisory: absent in pre-model files (reads fall back to the exact
    # binary seek), ignored as an unknown JSON key by pre-model readers
    lindex: Optional[dict] = None

    def to_json(self) -> dict:
        d = {"n_entries": self.n_entries, "first_key": self.first_key.hex(),
             "last_key": self.last_key.hex(), "frontier": self.frontier.to_json(),
             "data_size": self.data_size, "base_size": self.base_size,
             "max_expire_us": self.max_expire_us,
             "has_deep": self.has_deep}
        if self.lindex is not None:
            d["lindex"] = self.lindex
        return d

    @staticmethod
    def from_json(d: dict) -> "SSTProps":
        return SSTProps(d["n_entries"], bytes.fromhex(d["first_key"]),
                        bytes.fromhex(d["last_key"]), Frontier.from_json(d["frontier"]),
                        d["data_size"], d["base_size"],
                        d.get("max_expire_us", 0),
                        # files from before this field conservatively count
                        # as deep (native routing is always correct)
                        bool(d.get("has_deep", True)),
                        d.get("lindex"))


class SSTWriter:
    """Writes one SST from an already-sorted slab.

    Blocks are cut every `block_entries` rows (slab blocks favor a fixed row
    count over the reference's fixed byte size: device transfers like uniform
    shapes; 4096 rows * ~20B keys ~ 100-200KB blocks).
    """

    def __init__(self, base_path: str, block_entries: Optional[int] = None,
                 compress: Optional[bool] = None,
                 bits_per_key: Optional[int] = None,
                 fit_lindex: bool = True):
        self.base_path = base_path
        # None = take the server-wide tuning flags (the reference's LSM
        # option surface, docdb_rocksdb_util.cc:62-140)
        self.block_entries = (block_entries if block_entries is not None
                              else _sst_flags.get_flag("sst_block_entries"))
        self.compress = (compress if compress is not None
                         else sst_compression_enabled())
        self.bits_per_key = (bits_per_key if bits_per_key is not None
                             else _sst_flags.get_flag(
                                 "sst_bloom_bits_per_key"))
        # compaction's Python-path writer passes False: its outputs stay
        # byte-identical to the native writer's, which fits no model
        self.fit_lindex = fit_lindex

    def write(self, slab: KVSlab, frontier: Optional[Frontier] = None) -> SSTProps:
        n = slab.n
        data_path = data_file_name(self.base_path)
        index_items: List[Tuple[bytes, int, int, int]] = []
        data_off = 0
        key_raw = slab.key_words.astype(">u4").tobytes()
        stride = slab.width_words * 4

        def key_at(i: int) -> bytes:
            return key_raw[i * stride: i * stride + int(slab.key_len[i])]

        from yugabyte_tpu_torch.utils.env import get_env
        if os.path.exists(data_path):
            os.remove(data_path)  # never append to a stale data file
        df = get_env().open_append(data_path)
        try:
            for start in range(0, n, self.block_entries):
                end = min(start + self.block_entries, n)
                blk = block_format.encode_block(slab, start, end, self.compress)
                df.append(blk)
                index_items.append((key_at(end - 1), data_off, len(blk),
                                    end - start))
                data_off += len(blk)
            df.flush(fsync=True)
        finally:
            df.close()
        if n:
            u8 = np.frombuffer(key_raw, dtype=np.uint8).reshape(n, stride)
            hashes = fnv64_masked(u8, slab.doc_key_len.astype(np.int64))
        else:
            hashes = np.zeros(0, dtype=np.uint64)
        # whole-file expiry: meaningful only if EVERY entry carries a TTL
        from yugabyte_tpu_torch.ops.slabs import FLAG_HAS_TTL
        max_expire_us = 0
        if n and bool(((slab.flags & FLAG_HAS_TTL) != 0).all()):
            ht_phys = ((slab.ht_hi.astype(np.uint64) << 32)
                       | slab.ht_lo.astype(np.uint64)) >> 12
            max_expire_us = int(
                (ht_phys + slab.ttl_ms.astype(np.uint64) * 1000).max())
        from yugabyte_tpu_torch.ops.slabs import FLAG_DEEP
        # the learned per-SST index (storage/learned_index.py), advisory:
        # readers verify its predictions
        from yugabyte_tpu_torch.storage import learned_index
        lindex = (learned_index.fit_from_slab(slab)
                  if self.fit_lindex
                  and _sst_flags.get_flag("sst_learned_index") else None)
        return write_base_file(
            self.base_path, index_items, n, hashes,
            key_at(0) if n else b"", key_at(n - 1) if n else b"",
            frontier, data_off, self.bits_per_key,
            max_expire_us=max_expire_us,
            has_deep=bool(n) and bool(((slab.flags & FLAG_DEEP) != 0).any()),
            lindex=lindex)


def write_sst_from_packed(base_path: str, keys_blob: bytes, key_offs,
                          ht, wid, vals_blob: bytes, val_offs,
                          frontier: Optional[Frontier] = None,
                          block_entries: Optional[int] = None,
                          compress: Optional[bool] = None,
                          run_cache=None,
                          file_id: Optional[int] = None) -> SSTProps:
    """Native-encoded SST from one packed run (the flush / bulk-load hot
    path, ref: db/flush_job.cc WriteLevel0Table + memtable.cc iteration).
    Block encode, bloom hashing and doc-key parsing run in C++
    (ce_job_add_raw → ce_job_sort_all → ce_job_write_output); Python
    assembles the base file as usual. Caller guarantees native_engine is
    available. run_cache + file_id: the flush-side run-cache write-through
    (storage/run_cache.py), so the first compaction over this file starts
    zero-decode."""
    from yugabyte_tpu_torch.storage import native_engine
    if block_entries is None:
        block_entries = _sst_flags.get_flag("sst_block_entries")
    if compress is None:
        compress = sst_compression_enabled()
    n = len(key_offs) - 1
    data_path = data_file_name(base_path)
    if os.path.exists(data_path):
        os.remove(data_path)  # never append to a stale data file
    with native_engine.NativeCompactionJob() as job:
        job.add_raw(keys_blob, key_offs, ht, wid, vals_blob, val_offs)
        job.sort_all()
        size, index, hashes, first_key, last_key = job.write_output(
            0, n, data_path, block_entries, compress, b"X")
        max_expire_us, has_deep = job.props()
        if run_cache is not None and file_id is not None and n:
            rid = job.export_run(0, n, b"X")
            run_cache.put(file_id, rid,
                          native_engine.runcache_entry_bytes(rid))
    ht_arr = np.asarray(ht, dtype=np.uint64)
    fr = frontier or Frontier()
    if n and fr.ht_min == 0 and fr.ht_max == 0:
        fr.ht_min = int(ht_arr.min())
        fr.ht_max = int(ht_arr.max())
    lindex = None
    if _sst_flags.get_flag("sst_learned_index"):
        # the packed run may arrive unsorted (bulk ingest) — the fit's key
        # coordinate is a monotone transform of memcmp order, so sorting
        # the coordinates reproduces the written-order sequence
        from yugabyte_tpu_torch.storage import learned_index
        lindex = learned_index.fit_from_packed_keys(keys_blob, key_offs)
    return write_base_file(base_path, index, n, hashes, first_key, last_key,
                           fr, size, max_expire_us=max_expire_us,
                           has_deep=has_deep, lindex=lindex)


def write_base_file(base_path: str,
                    index_items: List[Tuple[bytes, int, int, int]],
                    n_entries: int, bloom_hashes: np.ndarray,
                    first_key: bytes, last_key: bytes,
                    frontier: Optional[Frontier], data_size: int,
                    bits_per_key: Optional[int] = None,
                    max_expire_us: int = 0,
                    has_deep: bool = False,
                    lindex: Optional[dict] = None) -> SSTProps:
    """Assemble the base (metadata) file from precomputed parts.

    index_items: (last_key, data_offset, block_size, n_entries) per data
    block. Shared by the Python SSTWriter and the native compaction shell
    (storage/native_engine.py), which produces the parts in C++.
    """
    if bits_per_key is None:
        bits_per_key = _sst_flags.get_flag("sst_bloom_bits_per_key")
    bloom = BloomFilterBuilder(max(n_entries, 1), bits_per_key)
    if n_entries:
        bloom.add_hashes(np.asarray(bloom_hashes, dtype=np.uint64))
    bloom_bytes = bloom.finish()
    index_bytes = _encode_index(
        [it[0] for it in index_items],
        [struct.pack("<QII", it[1], it[2], it[3]) for it in index_items])
    props = SSTProps(
        n_entries=n_entries,
        first_key=first_key,
        last_key=last_key,
        frontier=frontier or Frontier(),
        data_size=data_size,
        max_expire_us=max_expire_us,
        has_deep=has_deep,
        lindex=lindex,
    )
    props_bytes = json.dumps(props.to_json()).encode()
    from yugabyte_tpu_torch.utils.env import get_env
    index_off = 0
    bloom_off = len(index_bytes)
    props_off = bloom_off + len(bloom_bytes)
    crc = zlib.crc32(index_bytes) ^ zlib.crc32(bloom_bytes) ^ zlib.crc32(props_bytes)
    blob = (index_bytes + bloom_bytes + props_bytes
            + _FOOTER.pack(index_off, len(index_bytes), bloom_off,
                           len(bloom_bytes), props_off, len(props_bytes),
                           data_size, crc, SST_MAGIC))
    get_env().write_file(base_path, blob)
    props.base_size = len(blob)
    return props


def _encode_index(keys: List[bytes], vals: List[bytes]) -> bytes:
    parts = [struct.pack("<I", len(keys))]
    for k, v in zip(keys, vals):
        parts.append(struct.pack("<HH", len(k), len(v)))
        parts.append(k)
        parts.append(v)
    return b"".join(parts)


def _decode_index(data: bytes) -> Tuple[List[bytes], List[Tuple[int, int, int]]]:
    (count,) = struct.unpack_from("<I", data, 0)
    off = 4
    keys, handles = [], []
    for _ in range(count):
        klen, vlen = struct.unpack_from("<HH", data, off)
        off += 4
        keys.append(data[off: off + klen])
        off += klen
        handles.append(struct.unpack_from("<QII", data, off))
        off += vlen
    return keys, handles


class SSTReader:
    """Random and sequential access to one SST (ref: BlockBasedTable::Open)."""

    def __init__(self, base_path: str,
                 block_cache: Optional["BlockCache"] = None):
        from yugabyte_tpu_torch.utils.env import get_env
        self.base_path = base_path
        self.block_cache = block_cache
        self.data_path = data_file_name(base_path)
        raw = get_env().read_file(base_path)
        if len(raw) < _FOOTER.size:
            raise StatusError(Status.Corruption(f"SST base file too small: {base_path}"))
        (index_off, index_len, bloom_off, bloom_len, props_off, props_len,
         data_size, crc, magic) = _FOOTER.unpack_from(raw, len(raw) - _FOOTER.size)
        if magic != SST_MAGIC:
            raise StatusError(Status.Corruption(f"bad SST magic: {base_path}"))
        index_bytes = raw[index_off: index_off + index_len]
        bloom_bytes = raw[bloom_off: bloom_off + bloom_len]
        props_bytes = raw[props_off: props_off + props_len]
        if crc != (zlib.crc32(index_bytes) ^ zlib.crc32(bloom_bytes) ^ zlib.crc32(props_bytes)):
            raise StatusError(Status.Corruption(f"SST base checksum mismatch: {base_path}"))
        self.index_keys, self.block_handles = _decode_index(index_bytes)
        self.bloom_raw = bloom_bytes  # native read engine parses it in place
        self.bloom = BloomFilter(bloom_bytes)
        self.props = SSTProps.from_json(json.loads(props_bytes))
        # Env random-access handle (position-less preads are safe under
        # concurrent readers)
        self._data = get_env().open_random(self.data_path)

    def close(self) -> None:
        if self._data is not None:
            self._data.close()
            self._data = None

    @property
    def n_blocks(self) -> int:
        return len(self.block_handles)

    def read_block(self, block_idx: int) -> KVSlab:
        if self.block_cache is not None:
            cached = self.block_cache.get((self.base_path, block_idx))
            if cached is not None:
                return cached
        global _blocks_decoded
        off, size, _ = self.block_handles[block_idx]
        slab = block_format.decode_block(self._data.pread(size, off))
        with _decode_lock:
            _blocks_decoded += 1
        if self.block_cache is not None:
            self.block_cache.put((self.base_path, block_idx), slab, size)
        return slab

    def read_all(self) -> KVSlab:
        """Whole-file slab (compaction input path)."""
        return concat_slabs([self.read_block(i) for i in range(self.n_blocks)]) \
            if self.n_blocks else _empty_slab()

    def read_raw(self) -> bytes:
        """Whole data-file bytes through the Env, no block decode: the
        device-codec ingest path (ops/block_codec.parse_raw_file splits
        them into CRC-checked raw blocks with self.block_handles)."""
        from yugabyte_tpu_torch.utils.env import get_env
        return get_env().read_file(self.data_path)

    def may_contain_doc(self, doc_key_prefix: bytes) -> bool:
        return self.bloom.may_contain(doc_key_prefix)

    def seek_block(self, key: bytes) -> int:
        """First block whose last_key >= key (binary search the index)."""
        lo, hi = 0, len(self.index_keys)
        while lo < hi:
            mid = (lo + hi) // 2
            if self.index_keys[mid] < key:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def iter_entries(self, start_block: int = 0) -> Iterator[Tuple[bytes, DocHybridTime, bytes, int]]:
        """Yield (key_prefix, doc_ht, value, flags) in slab order."""
        for b in range(start_block, self.n_blocks):
            slab = self.read_block(b)
            raw = slab.key_words.astype(">u4").tobytes()
            stride = slab.width_words * 4
            for i in range(slab.n):
                yield (raw[i * stride: i * stride + int(slab.key_len[i])],
                       slab.doc_ht(i), slab.values[int(slab.value_idx[i])],
                       int(slab.flags[i]))


def _empty_slab() -> KVSlab:
    from yugabyte_tpu_torch.ops.slabs import pack_kvs
    return pack_kvs([])


class BlockCache:
    """LRU cache of decoded blocks (ref: util/lru_cache.cc,
    db/table_cache.cc). Shared server-wide across all tablets' DBs (keys
    embed the SST path, so file-id collisions between DBs are impossible);
    locked because every tablet's read and compaction threads hit it."""

    def __init__(self, capacity_bytes: int = 256 * 1024 * 1024):
        import threading
        from collections import OrderedDict
        self.capacity = capacity_bytes
        self.used = 0
        self._map: "OrderedDict" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            item = self._map.get(key)
            if item is None:
                return None
            self._map.move_to_end(key)
            return item[0]

    def put(self, key, slab: KVSlab, size: int) -> None:
        with self._lock:
            if key in self._map:
                return
            self._map[key] = (slab, size)
            self.used += size
            while self.used > self.capacity and self._map:
                self._pop_lru_locked()

    def _pop_lru_locked(self) -> int:
        _, (_, sz) = self._map.popitem(last=False)
        self.used -= sz
        return sz

    def evict(self, required: int) -> int:
        """LRU-evict at least ``required`` bytes; the MemTracker GC hook
        (ref: tserver/tablet_memory_manager.cc InitBlockCache registers a
        GarbageCollector on the block-based-table tracker). Returns freed."""
        freed = 0
        with self._lock:
            while freed < required and self._map:
                freed += self._pop_lru_locked()
        return freed
