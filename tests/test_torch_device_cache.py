"""The port's device slab cache and compaction write-through, on the CPU.

Twin of tests/test_device_cache.py and tests/test_device_write_through.py.
The cache's staged cols feed the merge exactly as a fresh host staging
does (`concat_staged` + the radix merge, the run-major restage), and
the compaction write-through installs each output file's survivor span,
gathered on the device (kernels D and E), bit for bit what a host
re-stage of the written file gives (stage_slab over read_all), with the
pad template beyond n, on the codec and the shell route, through TTL
rewrites, file splits and chunked subcompactions; every case is held
against the JAX package's job over the same files. The host staging
pool stages byte-identical run-major matrices and leaks no lease.
Inputs are made from a seed with numpy; no internal key repeats across
runs.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_torch_resident_chain import (CUTOFF, Side, files, mk_runs,
                                             native, same_entries,
                                             write_runs)
from yugabyte_tpu.common.hybrid_time import HybridTime
from yugabyte_tpu.ops import merge_gc as ref_mg
from yugabyte_tpu.ops.slabs import concat_slabs
from yugabyte_tpu.storage import device_cache as ref_dc
from yugabyte_tpu.utils import flags as ref_flags
from yugabyte_tpu_torch.ops import merge_gc, run_merge
from yugabyte_tpu_torch.ops.slabs import slab_from_arrays
from yugabyte_tpu_torch.storage import compaction, native_engine
from yugabyte_tpu_torch.storage.device_cache import (DeviceSlabCache,
                                                     NamespacedSlabCache,
                                                     concat_staged,
                                                     host_staging_pool)
from yugabyte_tpu_torch.storage.sst import SSTReader
from yugabyte_tpu_torch.utils import flags

pytestmark = pytest.mark.skipif(not native_engine.available(),
                                reason="native engine unavailable")

# The tier-1 run shares the host's cores among its workers.
torch.set_num_threads(1)


def _port(slab):
    return slab_from_arrays(
        values=slab.values, key_words=slab.key_words, key_len=slab.key_len,
        doc_key_len=slab.doc_key_len, ht_hi=slab.ht_hi, ht_lo=slab.ht_lo,
        write_id=slab.write_id, flags=slab.flags, ttl_ms=slab.ttl_ms,
        value_idx=slab.value_idx)


def _kept(perm, keep):
    return sorted(int(perm[i]) for i in np.nonzero(keep)[0])


# ---------------------------------------------------------------------------
# the cache feeding the merge


@pytest.mark.parametrize("case", ["two_runs", "const_per_input"])
def test_concat_staged_matches_host_path(case):
    """concat_staged of cache entries + the radix merge == the merge of a
    fresh host staging == the JAX package's; a column constant within
    each input but differing across them still orders the merge (the
    run for the larger key concatenated first)."""
    if case == "two_runs":
        runs = mk_runs(1, 2, 500, 300)
        order = [0, 1]
    else:
        runs = mk_runs(2, 2, 10, 1)
        for g, s in enumerate(runs):   # one doc key per run
            s.key_words[:, :] = s.key_words[0]
            s.key_words[:, 1] = (np.uint32(g) << 16) | 0x2100
            s.key_len[:] = 7
        order = [1, 0]
    runs = [runs[i] for i in order]
    cache = DeviceSlabCache("cpu")
    staged = concat_staged([cache.stage(i, _port(s))
                            for i, s in enumerate(runs)])
    merged = concat_slabs(runs)
    params = merge_gc.GCParams(HybridTime.kMax.value, True)
    p1, k1, _m1 = merge_gc.merge_and_gc_device(
        concat_slabs([_port(s) for s in runs]), params, device="cpu")
    p2, k2, _m2 = merge_gc.merge_and_gc_device(None, params, staged=staged)
    rc = ref_dc.DeviceSlabCache()
    rp, rk, _rm = ref_mg.merge_and_gc_device(
        merged, ref_mg.GCParams(HybridTime.kMax.value, True),
        staged=ref_dc.concat_staged([rc.stage(i, s)
                                     for i, s in enumerate(runs)]))
    assert _kept(p1, k1) == _kept(p2, k2) == _kept(rp, rk)
    if case == "const_per_input":
        keys = [merged.key_bytes(int(p2[i])) for i in np.nonzero(k2)[0]]
        assert keys == sorted(keys) and len(keys) == 2


def test_lru_eviction():
    cache = DeviceSlabCache("cpu", capacity_bytes=1)   # evict aggressively
    s = _port(mk_runs(3, 1, 100, 1000)[0])
    cache.stage(1, s)
    cache.stage(2, s)
    assert cache.get(1) is None          # evicted
    assert cache.get(2) is not None      # the most recent stays
    assert (cache.hits, cache.misses, cache.evictions) == (1, 1, 1)


def test_namespaced_levels_and_pins():
    shared = DeviceSlabCache("cpu")
    ns = NamespacedSlabCache(shared, "db1")
    ns.stage(7, _port(mk_runs(4, 1, 50, 1000)[0]), level=2)
    assert ns.level_of(7) == 2 and shared.level_of(("db1", 7)) == 2
    assert ns.pin(7) and ns.pinned_count() == 1
    ns.unpin(7)
    assert ns.pinned_count() == 0
    assert ns.get(7) is not None and ns.hits == shared.hits == 1
    ns.drop_all()
    assert ns.level_of(7) is None


def test_compaction_uses_cache(tmp_path):
    """A DB's flushes write through; a compaction over its live files
    with its cache finds every input resident (four hits, no miss) and
    writes its output through under the DB's namespace."""
    from yugabyte_tpu_torch.common.hybrid_time import (DocHybridTime,
                                                       HybridTime as PHT)
    from yugabyte_tpu_torch.storage.db import DB, DBOptions
    cache = DeviceSlabCache("cpu")
    db = DB(str(tmp_path / "db"), DBOptions(
        device="cpu", device_cache=cache, block_entries=128,
        auto_compact=False))
    fids = []
    for gen in range(4):
        db.write_batch([(b"Suser%08d\x00\x00!" % r,
                         DocHybridTime(PHT((1000 * (gen + 1) + r) << 12), 0),
                         b"$g%d" % gen) for r in range(60)])
        fids.append(db.flush())
    assert cache.misses == 0 and cache.hits == 0
    os.makedirs(str(tmp_path / "out"))
    ids = iter(range(100, 200))
    res = compaction.run_compaction_job(
        [db._readers[f] for f in fids], str(tmp_path / "out"),
        lambda: next(ids), CUTOFF, True, device="cpu",
        device_cache=db._device_cache, input_ids=fids)
    assert cache.hits == 4 and cache.misses == 0
    (fid, _p, _pr), = res.outputs
    ns = os.path.abspath(str(tmp_path / "db"))
    assert cache.get((ns, fid)) is not None and cache.level_of((ns, fid)) == 1
    db.close()


# ---------------------------------------------------------------------------
# the write-through: entries == a host re-stage of the written files


CASES = {
    "plain": dict(seed=11, k=3, n=800, key_space=500),
    "ttl_rewrite": dict(seed=12, k=2, n=600, key_space=400, ttl_frac=0.5,
                        is_major=False),
    "split": dict(seed=14, k=2, n=900, key_space=4000, max_rows=500),
    "chunked": dict(seed=15, k=2, n=2000, key_space=8000, chunk_rows=2048),
}


@pytest.mark.parametrize("route", ["codec", "shell"])
@pytest.mark.parametrize("case", list(CASES))
def test_write_through_matches_host_restage(tmp_path, monkeypatch, case,
                                            route):
    """Every output's installed entry == stage_slab(read_all()) of the
    file written for it (cols[:, :n], n == the file's entries, the pad
    template beyond n), == the JAX package's entry; the files == the JAX
    package's and the data == the native job's. ttl_rewrite: survivors
    rewritten as tombstones carry the tombstone flag in the entry too;
    split: one entry per file of a multi-file output; chunked: the
    deferred spans install after the chunked stream drains."""
    c = dict(CASES[case])
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "1" if route == "codec"
                       else "0")
    if "chunk_rows" in c:
        monkeypatch.setenv("YBTPU_MERGE_CHUNK_ROWS", str(c["chunk_rows"]))
    paths = write_runs(str(tmp_path), mk_runs(
        c["seed"], c["k"], c["n"], c["key_space"],
        ttl_frac=c.get("ttl_frac", 0.0)))
    is_major = c.get("is_major", True)
    key = "compaction_max_output_entries_per_sst"
    old = flags.get_flag(key)
    for f in (flags, ref_flags):   # each package reads its own flag
        f.set_flag(key, c.get("max_rows", old))
    chunked = []
    real = run_merge._launch_chunked

    def spy(*a, **k):
        h = real(*a, **k)
        chunked.append(h is not None)
        return h
    monkeypatch.setattr(run_merge, "_launch_chunked", spy)
    out = {}
    try:
        for pkg in ("port", "ref"):
            side = Side(pkg, route)
            side.flush(range(len(paths)), paths)
            out[pkg] = (side, side.job(paths, str(tmp_path / pkg),
                                       list(range(len(paths))), 100,
                                       is_major=is_major))
        os.makedirs(str(tmp_path / "native"))
        want = compaction.run_compaction_job(
            [SSTReader(p) for p in paths], str(tmp_path / "native"),
            iter(range(900, 999)).__next__, CUTOFF, is_major,
            device="native")
    finally:
        for f in (flags, ref_flags):
            f.set_flag(key, old)
    (side, res), (ref_side, ref) = out["port"], out["ref"]
    assert res.outputs and files(res.outputs) == files(ref.outputs)
    assert files(res.outputs, True) == files(want.outputs, True)
    assert chunked == ([True] if "chunk_rows" in c else [])
    if case == "split":
        assert len(res.outputs) >= 2
    ids = [f for f, _p, _pr in res.outputs]
    same_entries(side.cache, ref_side.cache, ids)
    for fid, base, props in res.outputs:
        st = side.cache.get(fid)
        host = merge_gc.stage_slab(SSTReader(base).read_all(), "cpu")
        assert st.n == host.n == props.n_entries
        r = min(st.cols_dev.shape[0], host.cols_dev.shape[0])
        assert torch.equal(st.cols_dev[:r, :st.n], host.cols_dev[:r, :st.n])
        assert not st.cols_dev[r:, :st.n].any()
        pad = merge_gc.u32_to_device(
            merge_gc.pad_template(st.cols_dev.shape[0]), "cpu")
        assert torch.equal(st.cols_dev[:, st.n:],
                           pad[:, None].expand(-1, st.n_pad - st.n))
        if case == "ttl_rewrite":
            assert res.tombstones_written > 0


def test_chained_compaction_from_cache(tmp_path, monkeypatch):
    """A second compaction whose inputs are the first jobs' write-through
    entries == the native job over the same files (and the JAX chain's
    files)."""
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "0")
    runs = mk_runs(13, 4, 700, 450)
    paths_a = write_runs(str(tmp_path / "a"), runs[:2])
    paths_b = write_runs(str(tmp_path / "b"), runs[2:])
    out = {}
    for pkg in ("port", "ref"):
        side = Side(pkg, "shell")
        side.flush((0, 1), paths_a)
        side.flush((2, 3), paths_b)
        ra = side.job(paths_a, str(tmp_path / pkg / "oa"), [0, 1], 100)
        rb = side.job(paths_b, str(tmp_path / pkg / "ob"), [2, 3], 200)
        l1 = ra.outputs + rb.outputs
        out[pkg] = side.job([p for _f, p, _pr in l1],
                            str(tmp_path / pkg / "l1"),
                            [f for f, _p, _pr in l1], 300)
    l1_paths = [p for _f, p, _pr in ra.outputs + rb.outputs]
    assert files(out["port"].outputs) == files(out["ref"].outputs)
    assert files(out["port"].outputs, True) == files(
        native(l1_paths, str(tmp_path / "native")).outputs, True)


@pytest.mark.parametrize("deep", [False, True])
def test_production_db_routes_to_combined_path(tmp_path, monkeypatch, deep):
    """The router with an explicit device and a cache takes the
    device-native job (the production path) for depth-2 inputs, and the
    Python path with the native merge for deep ones; both write through
    at level 1."""
    from yugabyte_tpu_torch.ops.slabs import FLAG_DEEP
    from yugabyte_tpu_torch.storage.sst import SSTWriter
    calls = []
    real = compaction.run_compaction_job_device_native

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(compaction, "run_compaction_job_device_native", spy)
    runs = [_port(s) for s in mk_runs(16, 4, 200, 150)]
    paths = []
    for i, s in enumerate(runs):
        if deep:
            s.flags[::5] |= np.uint32(FLAG_DEEP)
        paths.append(str(tmp_path / f"{i:06d}.sst"))
        SSTWriter(paths[-1]).write(s)
    cache = DeviceSlabCache("cpu")
    os.makedirs(str(tmp_path / "out"))
    res = compaction.run_compaction_job(
        [SSTReader(p) for p in paths], str(tmp_path / "out"),
        iter(range(100, 200)).__next__, CUTOFF, True, device="cpu",
        device_cache=cache, input_ids=list(range(4)))
    assert bool(calls) == (not deep)
    assert res.outputs and all(cache.level_of(f) == 1
                               for f, _p, _pr in res.outputs)
    assert cache.pinned_count() == 0


# ---------------------------------------------------------------------------
# the host staging pool


def test_staging_pool_stages_identical_bytes():
    """stage_runs_from_slabs packs into a pooled host array: the staged
    matrix equals one packed afresh (the same layout, the same bytes),
    and every lease ends (a CPU upload aliases the array, so it is
    forgotten, not recycled)."""
    runs = [_port(s) for s in mk_runs(17, 3, 400, 300)]
    pool = host_staging_pool()
    before = pool.outstanding()
    staged = run_merge.stage_runs_from_slabs(runs, "cpu", pack_runs=False)
    assert pool.outstanding() == before
    k_pad, m = run_merge._layout([s.n for s in runs])
    r = merge_gc._ROW_WORDS + staged.w
    want = np.empty((r, k_pad * m), dtype=np.uint32)
    want[:] = merge_gc.pad_template(r)[:, None]
    for i, s in enumerate(runs):
        sub, n_s, _, _ = merge_gc.pack_cols(s, n_pad_override=s.n,
                                            w_pad_override=staged.w)
        want[:, i * m:i * m + n_s] = sub
    assert np.array_equal(staged.cols_dev.numpy().view(np.uint32), want)
    again = run_merge.stage_runs_from_slabs(runs, "cpu", pack_runs=False)
    assert torch.equal(again.cols_dev, staged.cols_dev)
    assert not np.shares_memory(again.cols_dev.numpy(),
                                staged.cols_dev.numpy())
    assert pool.outstanding() == before


def test_stage_from_raw_feeds_the_codec_miss(tmp_path, monkeypatch):
    """A cold codec job stages each miss from its raw blocks into the
    cache (kernel C's plain version): the entries equal stage_slab of
    read_all, and the job's files equal the warm job's and the JAX
    package's cold job's."""
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "1")
    paths = write_runs(str(tmp_path), mk_runs(18, 2, 600, 400))
    cold, ref_cold = Side("port", "codec"), Side("ref", "codec")
    warm = Side("port", "codec")
    warm.flush((0, 1), paths)
    res = cold.job(paths, str(tmp_path / "cold"), [0, 1], 100)
    ref = ref_cold.job(paths, str(tmp_path / "ref"), [0, 1], 100)
    res_w = warm.job(paths, str(tmp_path / "warm"), [0, 1], 100)
    assert files(res.outputs) == files(ref.outputs) == files(res_w.outputs)
    for fid, p in enumerate(paths):
        st = cold.cache.get(fid)
        host = merge_gc.stage_slab(SSTReader(p).read_all(), "cpu")
        assert torch.equal(st.cols_dev, host.cols_dev)
        assert cold.cache.level_of(fid) == 0
    same_entries(cold.cache, ref_cold.cache,
                 [0, 1] + [f for f, _p, _pr in res.outputs])

