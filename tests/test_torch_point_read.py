"""The port's batched point read against the JAX package, on the CPU.

Kernels P1-P4 (ops/point_read.py) run here as their plain versions and
are held, bit for bit on every output lane, against the JAX package's
`_fnv64_fused`, `_bloom_probe_fused`, `_locate_gather_fused` (exact and
learned-index mode) and `_index_fit_fused`, and against the host twins
(`storage/bloom.fnv64_masked`, `learned_index.fit_from_slab`). The port's
`DB.multi_get` (device="cpu" with a DeviceSlabCache on the CPU) is held
against sequential `get`, the native per-key path and the JAX package's
`DB.multi_get` on the same writes; flush and bulk ingest must write SST
files byte-identical to the JAX package's, so that each package opens
the other's tablet. Inputs are made from seeds with numpy; outputs are
integers and bytes, compared exactly (tolerance 0).
"""

import json
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cuda import INDEX_FIT_CASES, index_fit_case
from tests.test_torch_env import require_reference_native
from yugabyte_tpu.common import hybrid_time as ref_ht
from yugabyte_tpu.ops import merge_gc as ref_mg
from yugabyte_tpu.ops import point_read as ref_pr
from yugabyte_tpu.ops import slabs as ref_slabs
from yugabyte_tpu.storage import db as ref_db
from yugabyte_tpu.storage import device_cache as ref_dc
from yugabyte_tpu.storage import learned_index as ref_li
from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime, HybridTime
from yugabyte_tpu_torch.docdb.value import Value
from yugabyte_tpu_torch.ops import point_read as pr
from yugabyte_tpu_torch.ops.merge_gc import (StagedCols, stage_slab,
                                             u32_to_device)
from yugabyte_tpu_torch.ops.slabs import _doc_key_len, _pad_keys_to_words
from yugabyte_tpu_torch.ops.slabs import pack_kvs as port_pack_kvs
from yugabyte_tpu_torch.storage import bloom, learned_index
from yugabyte_tpu_torch.storage.db import DB, DBOptions
from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
from yugabyte_tpu_torch.storage.sst import SSTProps, SSTReader
from yugabyte_tpu_torch.utils import flags

# The tier-1 run shares the host's cores among its workers.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native engine loads and its process Env is
    plaintext (tests/test_torch_env.require_reference_native): the twins
    here drive its ingest_packed or native jobs."""
    require_reference_native()


def _key(i: int, col: bool = False) -> bytes:
    k = b"Suser%08d\x00\x00!" % i
    return k + b"K\x00\x01" if col else k


def _tomb() -> bytes:
    return Value.tombstone().encode()


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32) if t.dtype == torch.int32 else t.numpy()


def _np(x) -> np.ndarray:
    return np.asarray(x)


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("b,w,seed", [(64, 4, 1), (1024, 8, 2), (64, 16, 3)])
def test_fnv64_plain_equals_jax_and_host(b, w, seed):
    rng = np.random.default_rng(seed)
    qwords = rng.integers(0, 2 ** 32, size=(b, w), dtype=np.uint32)
    qlens = rng.integers(-2, 4 * w + 6, size=b).astype(np.int32)
    qlens[:3] = (0, 4 * w, 4 * w + 5)
    h1, h2 = pr.fnv64_plain(u32_to_device(qwords, "cpu"),
                            torch.from_numpy(qlens))
    r1, r2 = ref_pr._fnv64_fused(jnp.asarray(qwords), jnp.asarray(qlens), w=w)
    assert np.array_equal(_u32(h1), _np(r1))
    assert np.array_equal(_u32(h2), _np(r2))
    # storage/bloom.fnv64_masked over the same bytes (big-endian words)
    u8 = qwords.astype(">u4").view(np.uint8).reshape(b, 4 * w)
    h = bloom.fnv64_masked(u8, np.maximum(qlens, 0).astype(np.int64))
    assert np.array_equal(_u32(h1), (h & 0xFFFFFFFF).astype(np.uint32))
    assert np.array_equal(_u32(h2), ((h >> 32) | 1).astype(np.uint32))


@pytest.mark.parametrize("m_bits,k,seed", [(4096, 7, 1), (1000, 1, 2),
                                           (64 * 37 + 13, 12, 3),
                                           (5, 3, 4)])
def test_bloom_probe_plain_equals_jax(m_bits, k, seed):
    rng = np.random.default_rng(seed)
    b = 1024
    h1 = rng.integers(0, 2 ** 32, size=b, dtype=np.uint32)
    h2 = rng.integers(0, 2 ** 32, size=b, dtype=np.uint32) | 1
    n_words = ref_mg.bucket_size(-(-m_bits // 32))
    # a dense filter so that both outcomes occur
    words = (rng.integers(0, 2 ** 32, size=n_words, dtype=np.uint32)
             | rng.integers(0, 2 ** 32, size=n_words, dtype=np.uint32))
    got = pr.bloom_probe_plain(u32_to_device(h1, "cpu"),
                               u32_to_device(h2, "cpu"),
                               u32_to_device(words, "cpu"), m_bits, k)
    want = ref_pr._bloom_probe_fused(jnp.asarray(h1), jnp.asarray(h2),
                                     jnp.asarray(words), jnp.uint32(m_bits),
                                     jnp.int32(k))
    assert np.array_equal(got.numpy(), _np(want))
    assert 0 < int(got.sum()) < b


def _sorted_entries(seed: int, n_ids: int = 700):
    """Row and column keys, 1-3 versions each, sorted by internal key."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(3 * n_ids, size=n_ids, replace=False))
    entries, wid = [], 0
    for i in ids:
        for col in (False, True):
            if rng.random() < 0.3:
                continue
            for v in range(int(rng.integers(1, 4))):
                ht = (1000 + int(i) * 10 + v) << 12
                wid += 1
                entries.append((_key(int(i), col), (ht << 32) | (wid & 7),
                                b"v%d" % wid))
    return ids, entries


def _cols(entries):
    """The staged cols of one sorted slab: the JAX package's pack_cols,
    handed to both packages as the same matrix."""
    slab = ref_slabs.pack_kvs(entries)
    cols, n, n_pad, w = ref_mg.pack_cols(slab)
    return slab, cols, n, n_pad, w


def _queries(ids, entries, rng, b=1024):
    present = [e[0] for e in entries]
    qs = [present[int(j)] for j in rng.integers(0, len(present), b // 2)]
    qs += [_key(int(i), bool(i % 2)) for i in rng.integers(0, 3 * len(ids),
                                                           b // 4)]
    qs += [_key(0)[:5], _key(3 * len(ids) + 5), _key(int(ids[0])) + b"\0" * 40]
    return qs[: b - 7]                       # 7 pad lanes


def _model_variants(slab, n):
    fit = ref_li.fit_from_slab(slab)
    assert fit is not None
    bad = dict(fit)
    bad["a_hi"] = list(reversed(fit["a_hi"]))
    bad["a_lo"] = list(reversed(fit["a_lo"]))
    bad["max_err"] = 0
    wide = dict(fit)
    wide["max_err"] = ref_li.LINDEX_MAX_ERR
    return {"fit": ref_li.model_operands(fit, n),
            "garbage": ref_li.model_operands(bad, n),
            "widest": ref_li.model_operands(wide, n)}


@pytest.mark.parametrize("mode", ["exact", "fit", "garbage", "widest"])
def test_locate_gather_plain_equals_jax(mode):
    ids, entries = _sorted_entries(5)
    slab, cols, n, n_pad, w = _cols(entries)
    assert n_pad > n                       # pad columns take part
    rng = np.random.default_rng(6)
    qs = _queries(ids, entries, rng)
    qw, ql = ref_pr.pack_query_batch(qs, w)
    model = None if mode == "exact" else _model_variants(slab, n)[mode]
    for read_ht in ((1000 + 1500 * 10 + 1) << 12, (1 << 64) - 1,
                    (1000 << 12) - 1):
        rhi, rlo = read_ht >> 32, read_ht & 0xFFFFFFFF
        got = pr.locate_gather_plain(
            u32_to_device(cols, "cpu"), n, u32_to_device(qw, "cpu"),
            torch.from_numpy(ql), rhi, rlo, model, w)
        ops = model if model is not None else (
            np.zeros(17, np.uint32), np.zeros(17, np.uint32),
            np.zeros(17, np.int32), 0, 0)
        want = ref_pr._locate_gather_fused(
            jnp.asarray(cols), jnp.int32(n), jnp.asarray(qw), jnp.asarray(ql),
            jnp.uint32(rhi), jnp.uint32(rlo), jnp.asarray(ops[0]),
            jnp.asarray(ops[1]), jnp.asarray(ops[2]), jnp.int32(ops[3]),
            jnp.int32(ops[4]), w=w, use_model=model is not None)
        for name, g, x in zip(("idx", "hit", "ht_hi", "ht_lo", "wid", "miss"),
                              got, want):
            assert np.array_equal(_u32(g), _np(x)), (mode, read_ht, name)
        hit, miss = got[1].numpy(), got[5].numpy()
        assert hit.any() == (read_ht >= (1000 << 12))
        if mode == "garbage":
            assert miss.any()
        elif mode != "exact":
            assert not miss.any()


@pytest.mark.parametrize("case", [7, 8, *sorted(INDEX_FIT_CASES)])
def test_index_fit_plain_equals_jax_and_host(case):
    """P4's plain version == the JAX `_index_fit_fused` == the host twin:
    over a sorted slab of two seeds, and over the card tests' layouts of
    kernel P4 (test_torch_cuda.INDEX_FIT_CASES: n not a multiple of 4, n =
    n_pad, w = 2, p = 0, 1 and 2, runs of equal keys over several anchors,
    a row stride not a multiple of 4)."""
    if isinstance(case, int):
        _ids, entries = _sorted_entries(case, n_ids=900)
        slab, cols, n, n_pad, w = _cols(entries)
    else:
        cols, n, w = index_fit_case(case)
        n_pad = cols.shape[1]
    a_hi, a_lo, p, err = pr.index_fit_plain(u32_to_device(cols, "cpu"), n, w)
    r = ref_pr._index_fit_fused(jnp.asarray(cols), jnp.int32(n),
                                n_segments=16, w=w)
    assert np.array_equal(_u32(a_hi), _np(r[0]))
    assert np.array_equal(_u32(a_lo), _np(r[1]))
    assert int(p) == int(r[2]) and int(err) == int(r[3])
    if isinstance(case, int):
        port_slab = port_pack_kvs(entries)
        host = learned_index.fit_from_slab(port_slab)
        assert host == ref_li.fit_from_slab(slab)
        staged = stage_slab(port_slab, "cpu")
    else:
        assert int(p) == INDEX_FIT_CASES[case][3]
        words = np.ascontiguousarray(cols[8:, :n].T)
        host = learned_index.fit_from_sorted_words(words)
        assert host == ref_li.fit_from_sorted_words(words)
        staged = StagedCols(u32_to_device(cols, "cpu"), n, n_pad, w, None,
                            None)
    dev = pr.fit_learned_index_device(staged)
    assert dev == host and (host["p"] >= 1 or not isinstance(case, int))


# -------------------------------------------- P2 and P3 over every file
_TOP = (1 << 64) - 1
_TIE_HT = 5_000_000 << 12           # above every other version


def _skey(i: int, col: bool = False) -> bytes:
    """A short key (10 or 12 bytes: a width-4 file)."""
    return b"S%08d!" % i + (b"K\x01" if col else b"")


def _file_entries(rng, f: int, tie_from=None):
    """One sorted SST: 400 random ids of 0-2999 as row and column keys
    with 1-3 versions (n_pad 2048, the width-8 files the shape of
    test_locate_gather_plain_equals_jax's); an odd file also holds
    28-byte keys (width 8). `tie_from`: entries copied with their (key,
    ht, wid) unchanged, each the newest version of its key in every
    file."""
    entries = []
    for i in np.sort(rng.choice(3000, size=400, replace=False)):
        for col in (False, True):
            for _v in range(int(rng.integers(1, 4))):
                ht = (1000 + int(i) * 10 + int(rng.integers(0, 8))) << 12
                entries.append((_skey(int(i), col), ht,
                                int(rng.integers(0, 4))))
    if f % 2:
        entries += [(b"Slong-key-%017d!" % i, (2000 + int(i)) << 12, f)
                    for i in rng.choice(3000, size=200, replace=False)]
    if tie_from:
        entries += tie_from
    uniq = {(k, ht, wid): None for k, ht, wid in entries}
    return sorted(uniq, key=lambda e: (e[0], -e[1], -e[2]))


def _every_file_set(n_files: int, seed: int):
    """n_files SSTs (widths 4 and 8 alternating) and their table rows:
    file 0 a dense filter and a fitted model; file 1 no usable filter and
    a copy of file 0's newest-of-all tie entries; file 2 a filter that
    rejects every lane; file 3 a model that mispredicts (`garbage`); file
    4 a dense filter and no model. Returns (JAX-side rows, port-side rows,
    tie keys)."""
    rng = np.random.default_rng(seed)
    tie = [(_skey(int(i)), _TIE_HT + (int(i) << 12), 3)
           for i in rng.choice(3000, size=60, replace=False)]
    m_bits, k = 64 * 37 + 13, 7
    n_words = ref_mg.bucket_size(-(-m_bits // 32))
    dense = (rng.integers(0, 2 ** 32, size=n_words, dtype=np.uint32)
             | rng.integers(0, 2 ** 32, size=n_words, dtype=np.uint32))
    blooms = [(dense, m_bits, k), None,
              (np.zeros(n_words, np.uint32), m_bits, k), (dense, m_bits, k),
              (dense, m_bits, k)]
    ref_rows, port_rows = [], []
    for f in range(n_files):
        ents = _file_entries(rng, f, tie if f < 2 else None)
        slab, cols, n, _n_pad, w = _cols([(kk, (ht << 32) | wid, b"v")
                                          for kk, ht, wid in ents])
        model = None
        if f in (0, 3):
            model = _model_variants(slab, n)["fit" if f == 0 else "garbage"]
        ref_rows.append((blooms[f], cols, n, w, model))
        bl = blooms[f]
        port_rows.append((None if bl is None else
                          (u32_to_device(bl[0], "cpu"), bl[1], bl[2]),
                          u32_to_device(cols, "cpu"), n, w, model))
    return ref_rows, port_rows, [t[0] for t in tie]


def _jax_every_file(rows, qs, h1, h2, b, read_ht, model_on):
    """The JAX package's per-file loop (storage/db.py:884-920): P2 per
    file, P3 per located file, the fold in file order; a lane that a
    model mispredicted takes the exact P3's answer (the port's, where the
    JAX DB re-reads the key on the host). Returns the maybe rows, located
    flags, the fold's five arrays and (bloom_skips, learned_hits,
    learned_fallbacks)."""
    b_pad = len(h1)
    rhi, rlo = jnp.uint32(read_ht >> 32), jnp.uint32(read_ht & 0xFFFFFFFF)
    maybes, located, best = [], [], None
    skips = hits = fallbacks = 0

    def locate(cols, n, w, qw, ql, ops):
        use = ops is not None
        ops = ops if use else (np.zeros(17, np.uint32),
                               np.zeros(17, np.uint32),
                               np.zeros(17, np.int32), 0, 0)
        return [np.asarray(x) for x in ref_pr._locate_gather_fused(
            jnp.asarray(cols), jnp.int32(n), jnp.asarray(qw),
            jnp.asarray(ql), rhi, rlo, jnp.asarray(ops[0]),
            jnp.asarray(ops[1]), jnp.asarray(ops[2]), jnp.int32(ops[3]),
            jnp.int32(ops[4]), w=w, use_model=use)]

    for fi, (bl, cols, n, w, model) in enumerate(rows):
        maybe = None if bl is None else np.asarray(ref_pr._bloom_probe_fused(
            jnp.asarray(h1), jnp.asarray(h2), jnp.asarray(bl[0]),
            jnp.uint32(bl[1]), jnp.int32(bl[2])))
        maybes.append(np.ones(b_pad, bool) if maybe is None else maybe)
        located.append(maybe is None or bool(maybe[:b].any()))
        if not located[-1]:
            skips += 1
            continue
        qw, ql = ref_pr.pack_query_batch(qs, w)
        model = model if model_on else None
        idx, hit, hhi, hlo, wid, miss = locate(cols, n, w, qw, ql, model)
        if model is not None:
            hits += 1
            fallbacks += int(miss[:b].sum())
            exact = locate(cols, n, w, qw, ql, None)
            idx, hit, hhi, hlo, wid = (np.where(miss, e, m) for m, e in
                                       zip((idx, hit, hhi, hlo, wid), exact))
        ht = (hhi.astype(np.uint64) << np.uint64(32)) | hlo.astype(np.uint64)
        if best is None:
            best = [np.zeros(b_pad, np.uint64), np.zeros(b_pad, np.uint32),
                    np.zeros(b_pad, np.int64), np.zeros(b_pad, np.int64),
                    np.zeros(b_pad, bool)]
        upd = hit & (~best[4] | (ht > best[0])
                     | ((ht == best[0]) & (wid > best[1])))
        best[0] = np.where(upd, ht, best[0])
        best[1] = np.where(upd, wid, best[1])
        best[2] = np.where(upd, idx.astype(np.int64), best[2])
        best[3] = np.where(upd, fi, best[3])
        best[4] = best[4] | hit
    if best is None:
        best = [np.zeros(b_pad, np.uint64), np.zeros(b_pad, np.uint32),
                np.zeros(b_pad, np.int64), np.zeros(b_pad, np.int64),
                np.zeros(b_pad, bool)]
    return np.stack(maybes), np.asarray(located), best, (skips, hits,
                                                         fallbacks)


@pytest.mark.parametrize("n_files,b", [(1, 1), (2, 64), (3, 65), (5, 1024)])
def test_every_file_plain_versions_equal_jax_loop_and_fold(n_files, b):
    """hash_probe_files + locate_fold (plain, on the CPU) == the JAX
    package's `hash_batch`, per-file P2 and P3 and its fold: the hashes
    (doc-key lengths 0, 1, 5 and 4 * w_hash among them, pad lanes too),
    maybe rows (file 1 has no filter), located flags, the five fold
    arrays on every lane (pad lanes too), and the counters the DB derives
    from them; ties in (ht, wid) go to the earlier file."""
    ref_rows, port_rows, tie_keys = _every_file_set(n_files, 40 + n_files)
    rng = np.random.default_rng(50 + b)
    pool = [_skey(int(i), bool(i % 3 == 0)) for i in rng.integers(0, 3300,
                                                                  2 * b)]
    qs = (tie_keys[:max(1, b // 8)] + [b"Slong-key-%017d!" % i
                                       for i in range(b // 8)] + pool)[:b]
    table = pr.FileTable(port_rows, "cpu")
    assert {f.w for f in table.files} == ({4, 8} if n_files > 1 else {4})
    qbuf, ql = table.queries(qs)
    b_pad = len(ql)
    assert b_pad == pr.batch_bucket(b)
    hw, _ = ref_pr.pack_query_batch(qs, 8)
    dk = np.zeros(b_pad, np.int32)
    dk[:b] = [_doc_key_len(q) for q in qs]
    dk[:4] = (0, 1, 5, 32)          # none, a byte, mid-word, 4 * w_hash
    # the JAX hash at test_fnv64_plain_equals_jax_and_host's [1024, 8]
    # program, over the chunk's lanes
    hw_j = np.zeros((1024, 8), np.uint32)
    dk_j = np.zeros(1024, np.int32)
    hw_j[:b_pad], dk_j[:b_pad] = hw, dk
    h1, h2 = (np.asarray(h)[:b_pad] for h in ref_pr.hash_batch(hw_j, dk_j))
    maybe, flag, g1, g2 = pr.hash_probe_files(
        u32_to_device(hw, "cpu"), torch.from_numpy(dk), table, b)
    assert np.array_equal(_u32(g1), h1) and np.array_equal(_u32(g2), h2)
    for read_ht, model_on in ((_TOP, True), (_TOP, False),
                              ((1000 + 15000) << 12, True)):
        out = pr.locate_fold(table, u32_to_device(qbuf, "cpu"),
                             torch.from_numpy(ql), b, read_ht >> 32,
                             read_ht & 0xFFFFFFFF, model_on, flag)
        best, located, misses = pr.fold_arrays(out.numpy(), b_pad, n_files)
        w_maybe, w_loc, w_best, (skips, hits, fallbacks) = _jax_every_file(
            ref_rows, qs, h1, h2, b, read_ht, model_on)
        assert np.array_equal(maybe.numpy(), w_maybe)
        assert np.array_equal(flag.numpy(), w_loc) \
            and np.array_equal(located, w_loc)
        for name, g, x in zip(("ht", "wid", "row", "file", "hit"), best,
                              w_best):
            assert np.array_equal(g, x), (read_ht, model_on, name)
        assert int((~located).sum()) == skips
        assert sum(1 for f, loc in zip(table.files, located)
                   if loc and model_on and f.model is not None) == hits
        assert int(misses.sum()) == fallbacks
        if n_files >= 3:
            assert not located[2] and located[1]
        if n_files >= 4 and model_on and read_ht == _TOP:
            assert fallbacks > 0
        if n_files >= 2 and read_ht == _TOP:    # the ties: file 0 wins
            ties = [i for i, q in enumerate(qs) if q in set(tie_keys)]
            assert ties and all(best[4][i] and best[3][i] == 0
                                for i in ties)


# ------------------------------------------------------------ DB helpers
def _fill(db, hyb, n_keys=1200, n_ssts=3, mem_overlay=True):
    """Keys across n_ssts flushed SSTs with 1-2 versions, some row
    tombstones, and a memtable overlay (the JAX suite's _fill_db)."""
    val = b"value-" + b"x" * 26
    for f in range(n_ssts):
        items = []
        for i in range(f, n_keys, n_ssts):
            v = _tomb() if i % 17 == 0 and f == 1 else val + b"%d" % f
            items.append((_key(i), hyb.DocHybridTime(
                hyb.HybridTime.from_micros(1000 + i + 7 * f), f), v))
        db.write_batch(items, op_id=(1, f + 1))
        db.flush()
    if mem_overlay:
        items = [(_key(i), hyb.DocHybridTime(
            hyb.HybridTime.from_micros(99_999), 1), b"memval%d" % i)
            for i in range(0, 120, 7)]
        db.write_batch(items, op_id=(1, n_ssts + 1))
    return db


class _PortHT:
    DocHybridTime = DocHybridTime
    HybridTime = HybridTime


def _port_db(path, device=True, **kw):
    opts = (DBOptions(device="cpu", device_cache=DeviceSlabCache("cpu"),
                      auto_compact=False) if device
            else DBOptions(device="native", auto_compact=False))
    return _fill(DB(str(path), opts), _PortHT, **kw)


def _ref_db(path, **kw):
    dev = jax.devices()[0]
    opts = ref_db.DBOptions(device=dev,
                            device_cache=ref_dc.DeviceSlabCache(device=dev),
                            auto_compact=False)
    return _fill(ref_db.DB(str(path), opts), ref_ht, **kw)


def _query_keys(n_keys, rng, m=400):
    return [_key(int(i)) for i in rng.integers(0, n_keys + 200, size=m)]


def _plain(results):
    return [None if r is None else (r[0].ht.value, r[0].write_id, r[1])
            for r in results]


class _CounterValues:
    """The registry counters of pr.point_read_metrics(), read as ints."""

    def __getitem__(self, name):
        return pr.point_read_metrics()[name].value()


@pytest.fixture
def metrics():
    return _CounterValues()


# ---------------------------------------------------------------- identity
class TestByteIdentity:
    def test_multi_get_equals_sequential_gets(self, tmp_path, metrics):
        db = _port_db(tmp_path / "db")
        keys = _query_keys(1200, np.random.default_rng(7))
        b0 = metrics["batches"]
        try:
            for read_ht in (None, HybridTime.from_micros(1400),
                            HybridTime.from_micros(50_000),
                            HybridTime.from_micros(100_000)):
                seq = [db.get(k, read_ht) for k in keys]
                assert db.multi_get(keys, read_ht) == seq, read_ht
            assert metrics["batches"] > b0
        finally:
            db.close()

    def test_multi_get_native_path_identical(self, tmp_path):
        db = _port_db(tmp_path / "db")
        keys = _query_keys(1200, np.random.default_rng(8))
        try:
            dev = db.multi_get(keys)
            flags.set_flag("point_read_batched", False)
            try:
                nat = db.multi_get(keys)
            finally:
                flags.set_flag("point_read_batched", True)
            assert dev == nat == db._multi_get_native(keys, HybridTime.kMax) \
                == [db.get(k) for k in keys]
        finally:
            db.close()

    def test_multi_get_no_device_db(self, tmp_path, metrics):
        db = _port_db(tmp_path / "db", device=False)
        keys = _query_keys(1200, np.random.default_rng(9))
        b0 = metrics["batches"]
        try:
            assert db.multi_get(keys) == [db.get(k) for k in keys]
            assert metrics["batches"] == b0
        finally:
            db.close()

    def test_multi_get_edge_shapes(self, tmp_path):
        db = _port_db(tmp_path / "db", n_keys=400, mem_overlay=False)
        try:
            assert db.multi_get([]) == []
            # a key longer than any SST's key stride can never match
            assert db.multi_get([_key(1) + b"\x00" * 64]) == [None]
            early = HybridTime.from_micros(1)
            assert db.multi_get([_key(3)], early) == [db.get(_key(3), early)]
            keys = [_key(5), _key(5), _key(9999), _key(5)]
            assert db.multi_get(keys) == [db.get(k) for k in keys]
        finally:
            db.close()

    def test_stale_residency_restaged(self, tmp_path, metrics):
        """A resident entry whose n differs from its file's is stale: it
        is dropped, the file staged anew, and the batch still runs on the
        device path."""
        db = _port_db(tmp_path / "db", mem_overlay=False)
        keys = _query_keys(1200, np.random.default_rng(10))
        try:
            want = [db.get(k) for k in keys]
            fid = next(iter(db._readers))
            db._device_cache.put(fid, stage_slab(port_pack_kvs(
                [(_key(1), 5 << 44, b"x")]), "cpu"))
            b0 = metrics["batches"]
            assert db.multi_get(keys) == want
            assert metrics["batches"] > b0
            assert db._device_cache.get(fid).n == \
                db._readers[fid].props.n_entries
        finally:
            db.close()


# ------------------------------------------------------------------ bloom
class TestBloom:
    def test_bloom_rejected_misses(self, tmp_path, metrics):
        db = _port_db(tmp_path / "db", mem_overlay=False)
        try:
            skips0 = metrics["bloom_skips"]
            miss = [_key(5000 + i) for i in range(128)]
            dkls = np.asarray([_doc_key_len(k) for k in miss], np.int32)
            words, _ = _pad_keys_to_words(miss, width_words=4)
            h1, h2 = pr.fnv64_plain(u32_to_device(words, "cpu"),
                                    torch.from_numpy(dkls))
            expected = sum(1 for r in db._readers.values()
                           if not pr.probe_bloom(r, h1, h2)[:128].any())
            assert db.multi_get(miss) == [None] * len(miss)
            assert metrics["bloom_skips"] == skips0 + expected
        finally:
            db.close()

    def test_device_probe_matches_cpu_bloom(self, tmp_path):
        db = _port_db(tmp_path / "db", n_keys=600, n_ssts=1,
                      mem_overlay=False)
        try:
            r = next(iter(db._readers.values()))
            keys = [_key(i) for i in range(0, 2000, 3)]
            dkls = np.asarray([_doc_key_len(k) for k in keys], np.int64)
            words, _ = _pad_keys_to_words(keys, width_words=4)
            h1, h2 = pr.fnv64_plain(u32_to_device(words, "cpu"),
                                    torch.from_numpy(dkls.astype(np.int32)))
            dev = pr.probe_bloom(r, h1, h2)
            u8 = np.zeros((len(keys), 16), np.uint8)
            for i, k in enumerate(keys):
                u8[i, :len(k)] = np.frombuffer(k, np.uint8)
            cpu = r.bloom.may_contain_batch(bloom.fnv64_masked(u8, dkls))
            assert np.array_equal(dev[:len(keys)], cpu)
        finally:
            db.close()


# ---------------------------------------------------------- learned index
class TestLearnedIndex:
    def test_models_persisted_at_flush(self, tmp_path):
        db = _port_db(tmp_path / "db", mem_overlay=False)
        try:
            models = [r.props.lindex for r in db._readers.values()]
            assert all(m is not None for m in models), models
            for m in models:
                assert m["v"] == learned_index.MODEL_VERSION
                assert m["max_err"] <= learned_index.LINDEX_MAX_ERR
                assert json.loads(json.dumps(m)) == m
        finally:
            db.close()

    def test_forced_mispredict_falls_back_exact(self, tmp_path, metrics):
        db = _port_db(tmp_path / "db")
        keys = _query_keys(1200, np.random.default_rng(11))
        try:
            expect = [db.get(k) for k in keys]
            fb0 = metrics["learned_fallbacks"]
            for fid, r in list(db._readers.items()):
                m = r.props.lindex
                bad = dict(m)
                bad["a_hi"] = list(reversed(m["a_hi"]))
                bad["a_lo"] = list(reversed(m["a_lo"]))
                bad["max_err"] = 0
                learned_index.attach_learned_index(r.base_path, bad)
                db._readers[fid] = SSTReader(r.base_path, db.opts.block_cache)
                r.close()
            calls = []
            locate_fold = pr.locate_fold

            def spy(table, qbuf, qlens, b, rhi, rlo, model_on, located):
                out = locate_fold(table, qbuf, qlens, b, rhi, rlo, model_on,
                                  located)
                _best, _loc, misses = pr.fold_arrays(
                    out.numpy(), qlens.shape[0], len(table.files))
                calls.append((model_on, int(misses.sum())))
                return out

            def no_host_read(*a, **kw):
                raise AssertionError("a mispredicted key went to the host")

            with mock.patch.object(pr, "locate_fold", spy), \
                    mock.patch.object(db, "_get_inner", no_host_read):
                assert db.multi_get(keys) == expect
            assert metrics["learned_fallbacks"] > fb0
            # one P3 launch a chunk, in learned-index mode: the
            # mispredicted keys were re-sought exactly inside it
            assert len(calls) == -(-len(keys) // 1024)
            assert all(m for m, _ in calls)
            assert sum(n for _, n in calls) == \
                metrics["learned_fallbacks"] - fb0
        finally:
            db.close()

    def test_model_disabled_results_unchanged(self, tmp_path, metrics):
        db = _port_db(tmp_path / "db")
        keys = _query_keys(1200, np.random.default_rng(12))
        try:
            h0 = metrics["learned_hits"]
            with_model = db.multi_get(keys)
            assert metrics["learned_hits"] > h0
            flags.set_flag("point_read_learned_index", False)
            try:
                h1 = metrics["learned_hits"]
                without = db.multi_get(keys)
                assert metrics["learned_hits"] == h1
            finally:
                flags.set_flag("point_read_learned_index", True)
            assert with_model == without == [db.get(k) for k in keys]
        finally:
            db.close()

    def test_model_bearing_sst_readable_by_pre_model_path(self, tmp_path):
        db = _port_db(tmp_path / "db", n_keys=600, n_ssts=1,
                      mem_overlay=False)
        try:
            r = next(iter(db._readers.values()))
            assert r.props.lindex is not None
            flags.set_flag("read_native", False)
            flags.set_flag("point_read_batched", False)
            try:
                assert db.get(_key(3)) is not None
                assert db.get(_key(9999)) is None
                assert sum(1 for _ in db.iter_from(b"")) == r.props.n_entries
            finally:
                flags.set_flag("read_native", True)
                flags.set_flag("point_read_batched", True)
            d = r.props.to_json()
            d.pop("lindex")
            assert SSTProps.from_json(d).lindex is None
        finally:
            db.close()

    def test_stale_model_ignored(self, tmp_path):
        db = _port_db(tmp_path / "db", n_keys=600, n_ssts=1,
                      mem_overlay=False)
        try:
            r = next(iter(db._readers.values()))
            m = dict(r.props.lindex)
            n = r.props.n_entries
            assert learned_index.model_operands(m, n) is not None
            m["n"] += 1
            assert learned_index.model_operands(m, n) is None
            assert learned_index.model_operands(None, 100) is None
            assert learned_index.model_operands({"v": 99}, 100) is None
        finally:
            db.close()

    def test_device_and_host_fits_agree(self):
        entries = [(_key(i), ((1000 + i) << 12 << 32), b"v%d" % i)
                   for i in range(800)]
        slab = port_pack_kvs(entries)
        host = learned_index.fit_from_slab(slab)
        dev = pr.fit_learned_index_device(stage_slab(slab, "cpu"))
        assert host == dev and host["p"] >= 1
        assert host == ref_li.fit_from_slab(ref_slabs.pack_kvs(entries))


# ------------------------------------------------- the port against JAX
@pytest.fixture(scope="module")
def twin_dbs(tmp_path_factory):
    """The same writes through the port's DB (device="cpu") and the JAX
    package's (a JAX CPU device and its DeviceSlabCache)."""
    root = tmp_path_factory.mktemp("twins")
    port = _port_db(root / "port", n_keys=2400, n_ssts=3)
    ref = _ref_db(root / "ref", n_keys=2400, n_ssts=3)
    yield port, ref
    port.close()
    ref.close()


@pytest.mark.parametrize("batch", [0, 1, 64, 65, 1024, 1025, 2100])
def test_multi_get_equals_jax(twin_dbs, batch):
    port, ref = twin_dbs
    rng = np.random.default_rng(100 + batch)
    keys = [_key(int(i), bool(i % 5 == 0))
            for i in rng.integers(0, 2600, size=batch)]
    for micros in (None, 1500, 3000, 99_999):
        got = port.multi_get(keys, None if micros is None
                             else HybridTime.from_micros(micros))
        want = ref.multi_get(keys, None if micros is None
                             else ref_ht.HybridTime.from_micros(micros))
        assert _plain(got) == _plain(want), (batch, micros)
        if batch >= 64:
            assert any(r is not None for r in got)


# ----------------------------------------------- files of both packages
def _sst_files(d):
    return sorted(f for f in os.listdir(d)
                  if f.endswith(".sst") or f.endswith(".sblock.0"))


def _ingest_run(seed, n=3000):
    """One unsorted packed run: row and column keys, values encoded as
    DocDB values (tombstones included), hybrid times from a seed."""
    rng = np.random.default_rng(seed)
    keys = [_key(int(i), bool(rng.random() < 0.5))
            for i in rng.permutation(n)]
    vals = [_tomb() if rng.random() < 0.05
            else Value(int(rng.integers(0, 1 << 40))).encode()
            for _ in range(n)]
    ht = (np.uint64(1000) + rng.permutation(n).astype(np.uint64)) \
        << np.uint64(12)
    wid = np.zeros(n, np.uint32)
    koffs = np.concatenate(([0], np.cumsum([len(k) for k in keys])))
    voffs = np.concatenate(([0], np.cumsum([len(v) for v in vals])))
    return b"".join(keys), koffs, ht, wid, b"".join(vals), voffs


def test_flush_and_ingest_byte_identical_to_jax(tmp_path):
    port = _port_db(tmp_path / "port", n_keys=900, n_ssts=2,
                    mem_overlay=False)
    ref = _ref_db(tmp_path / "ref", n_keys=900, n_ssts=2, mem_overlay=False)
    run = _ingest_run(3)
    try:
        assert port.ingest_packed(*run, op_id=(2, 1)) \
            == ref.ingest_packed(*run, op_id=(2, 1))
        for r in port._readers.values():
            assert r.props.lindex is not None
    finally:
        port.close()
        ref.close()
    pd, rd = str(tmp_path / "port"), str(tmp_path / "ref")
    assert _sst_files(pd) == _sst_files(rd) and len(_sst_files(pd)) == 6
    for f in _sst_files(pd) + ["MANIFEST"]:
        with open(os.path.join(pd, f), "rb") as a, \
                open(os.path.join(rd, f), "rb") as b:
            assert a.read() == b.read(), f


def test_each_package_opens_the_others_tablet(tmp_path):
    port = _port_db(tmp_path / "port", n_keys=900, n_ssts=2,
                    mem_overlay=False)
    ref = _ref_db(tmp_path / "ref", n_keys=900, n_ssts=2, mem_overlay=False)
    keys = _query_keys(900, np.random.default_rng(4), m=300)
    want = _plain(port.multi_get(keys))
    assert want == _plain(ref.multi_get(keys))
    port.close()
    ref.close()
    dev = jax.devices()[0]
    ref_opens_port = ref_db.DB(str(tmp_path / "port"), ref_db.DBOptions(
        device=dev, device_cache=ref_dc.DeviceSlabCache(device=dev),
        auto_compact=False))
    port_opens_ref = DB(str(tmp_path / "ref"), DBOptions(
        device="cpu", device_cache=DeviceSlabCache("cpu"),
        auto_compact=False))
    try:
        assert _plain(ref_opens_port.multi_get(keys)) == want
        assert _plain(port_opens_ref.multi_get(keys)) == want
    finally:
        ref_opens_port.close()
        port_opens_ref.close()


def test_cache_parts_not_ported_raise(tmp_path):
    """The device cache's second half, once refused: stage_from_raw
    (kernel C over the raw blocks) equals stage of read_all, bit for bit
    and with the same column stats; the value words ride along with
    include_vals=True and attach_vals grows an entry with its accounting;
    a ShardPartition stages under its shard's namespace on its device;
    the process staging pool hands out and takes back its arrays."""
    from yugabyte_tpu_torch.ops import block_codec, scan
    from yugabyte_tpu_torch.storage import device_cache as dc
    from yugabyte_tpu_torch.storage.sst import SSTWriter
    cache = DeviceSlabCache("cpu")
    slab = port_pack_kvs([(_key(i, col=i % 2 == 1), (5 + i) << 44,
                           b"$" + bytes([i % 251]) * (i % 9))
                          for i in range(300)])
    path = str(tmp_path / "000001.sst")
    SSTWriter(path, block_entries=64).write(slab)
    r = SSTReader(path)
    raw = cache.stage_from_raw(("ns", 1), block_codec.parse_raw_file(
        r.read_raw(), r.block_handles), level=1)
    host = stage_slab(r.read_all(), "cpu")
    assert torch.equal(raw.cols_dev, host.cols_dev)
    assert (raw.n, raw.n_pad, raw.w) == (host.n, host.n_pad, host.w)
    assert np.array_equal(raw.col_const, host.col_const)
    assert cache.get(("ns", 1)) is raw and cache.level_of(("ns", 1)) == 1
    used = cache.snapshot()["used_bytes"]
    vals = u32_to_device(scan.pack_vals(r.read_all(), raw.n_pad), "cpu")
    cache.attach_vals(("ns", 1), vals)
    assert cache.get(("ns", 1)).vals_dev is vals
    assert cache.snapshot()["used_bytes"] == used + vals.numel() * 4
    cache.attach_vals(("ns", 9), vals)             # absent: a no-op
    st = cache.stage(("ns", 2), slab, include_vals=True)
    assert torch.equal(st.vals_dev, u32_to_device(
        scan.pack_vals(slab, st.n_pad), "cpu"))
    assert cache.snapshot()["used_bytes"] == \
        used + vals.numel() * 4 + st.nbytes
    part = dc.ShardPartition(cache, "db", 3, device="cpu")
    sp = part.stage(7, slab, level=2)
    assert cache.get(("db/shard3", 7)) is sp and part.level_of(7) == 2
    assert part.device.type == "cpu" and part.shard == 3
    pool = dc.host_staging_pool()
    assert pool is dc.host_staging_pool()
    before = pool.outstanding()
    arr = pool.acquire((4, 64))
    assert arr.shape == (4, 64) and pool.outstanding() == before + 1
    pool.release(arr)
    assert pool.acquire((4, 64)) is arr
    pool.forget(arr)
    assert pool.outstanding() == before
    st = cache.stage(("ns", 3), slab, for_read=True)
    assert cache.get(("ns", 3)) is st and cache.read_stages == 1
    r.close()


def test_cache_evicts_shallow_levels_first_and_never_pinned():
    slab = port_pack_kvs([(_key(i), 5 << 44, b"x") for i in range(10)])
    one = stage_slab(slab, "cpu").nbytes
    cache = DeviceSlabCache("cpu", capacity_bytes=3 * one)
    cache.stage(("a", 1), slab, level=2)
    cache.stage(("a", 2), slab, level=0)
    cache.stage(("a", 3), slab, level=1)
    assert cache.pin(("a", 2)) and not cache.pin(("a", 9))
    cache.stage(("a", 4), slab, level=0)      # over budget: evict L1 (#2
    assert [cache.contains(("a", i)) for i in range(1, 5)] == \
        [True, True, False, True]             # is pinned)
    cache.unpin(("a", 2))
    cache.stage(("b", 1), slab, level=3)
    assert not cache.contains(("a", 2)) and cache.evictions == 2
    cache.drop_namespace("a")
    assert cache.snapshot()["entries"] == 1
    assert cache.snapshot()["levels"] == {
        "L3": {"entries": 1, "bytes": one, "pinned": 0}}


def test_db_without_cuda_and_unported_parts_raise(tmp_path):
    """The default DBOptions (auto_compact=True, device None = the card)
    now open where CUDA is: without it DB(path) raises, never quietly
    running on the CPU. The entry points once refused answer: on an empty
    DB nothing is due, and a scan over two flushes is the native scan's."""
    if not torch.cuda.is_available():
        for opts in (None, DBOptions(auto_compact=False)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                DB(str(tmp_path / "c"), opts)
    with pytest.raises(ValueError, match="no device cache"):
        DB(str(tmp_path / "d"), DBOptions(
            device="native", device_cache=DeviceSlabCache("cpu"),
            auto_compact=False))
    for dev in ("native", "cpu"):
        db = DB(str(tmp_path / dev), DBOptions(device=dev))
        try:
            assert db.compact_all() is None
            assert not db.maybe_schedule_compaction()
            assert list(db.scan_visible(1)) == []
            for f in range(2):
                db.write_batch([(_key(i), DocHybridTime(
                    HybridTime.from_micros(100 + 10 * i + f), 0),
                    b"v%d" % f) for i in range(f, 40, 2)])
                db.flush()
            got = list(db.scan_visible(HybridTime.kMax.value - 1))
            assert [(k, v) for k, v, _h in got] == [
                (_key(i), b"v%d" % (i % 2)) for i in range(40)]
            assert not db.maybe_schedule_compaction()   # 2 runs: not due
            db.compact_all()
            assert db.n_live_files == 1
            assert list(db.scan_visible(HybridTime.kMax.value - 1)) == got
        finally:
            db.close()


def test_db_given_a_device_and_no_cache_makes_its_own(tmp_path, metrics):
    db = _fill(DB(str(tmp_path / "db"), DBOptions(device="cpu",
                                                  auto_compact=False)),
               _PortHT, n_keys=600, n_ssts=2)
    keys = _query_keys(600, np.random.default_rng(13), m=200)
    try:
        assert db._device_cache is not None
        assert db._device_cache.device.type == "cpu"
        b0 = metrics["batches"]
        assert db.multi_get(keys) == [db.get(k) for k in keys]
        assert metrics["batches"] > b0
    finally:
        db.close()
