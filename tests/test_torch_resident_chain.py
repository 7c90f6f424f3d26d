"""The port's resident chain against the JAX package, on the CPU.

Twin of tests/test_resident_chain.py. A chained L0->L1->L2 compaction
with a device slab cache, input_ids and (on the run-cached route) a run
cache runs through both packages' `run_compaction_job_device_native`
over the same input files: the port with device="cpu" (the plain
versions of its kernels), the JAX package on its CPU device. Per route
(the device codec, the native shell, and the shell fed from the run
cache) the two packages must write byte-identical data and base files
(learned indexes included), install equal entries (cols[:, :n], n, n_pad,
level) under every output id, and the data files must equal the native
CompactionJob's. The warm L1->L2 job must decode no block on the host and
upload no key column, by the port's own process counters
(sst.blocks_decoded, merge_gc.key_col_uploads, compaction.ingest_decodes),
which nothing of the JAX package touches. Inputs are made from a seed
with numpy; no internal key (key, hybrid time, write id) repeats across
runs.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_env import require_reference_native
from yugabyte_tpu.ops.slabs import FLAG_HAS_TTL, FLAG_TOMBSTONE, KVSlab
from yugabyte_tpu.ops.slabs import ValueArray
from yugabyte_tpu.ops import scan as ref_scan
from yugabyte_tpu.parallel.mesh import make_mesh as ref_mesh
from yugabyte_tpu.storage import compaction as ref_compaction
from yugabyte_tpu.storage import device_cache as ref_dc
from yugabyte_tpu.storage import integrity as ref_integrity  # noqa: F401
from yugabyte_tpu.storage import run_cache as ref_rc
from yugabyte_tpu.storage.sst import Frontier, SSTWriter
from yugabyte_tpu.storage.sst import SSTReader as RefSSTReader
from yugabyte_tpu.utils import flags as ref_flags
from yugabyte_tpu_torch.ops import merge_gc, scan
from yugabyte_tpu_torch.parallel.mesh import make_mesh
from yugabyte_tpu_torch.storage import compaction, integrity, native_engine
from yugabyte_tpu_torch.storage import sst as port_sst
from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
from yugabyte_tpu_torch.storage.run_cache import (NamespacedRunCache,
                                                  NativeRunCache,
                                                  export_reader)
from yugabyte_tpu_torch.storage.sst import SSTReader
from yugabyte_tpu_torch.utils import flags

pytestmark = pytest.mark.skipif(not native_engine.available(),
                                reason="native engine unavailable")

# The tier-1 run shares the host's cores among its workers.
torch.set_num_threads(1)

CUTOFF = (10_000_000 << 12)
ROUTES = ["codec", "shell", "run_cached"]


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native engine loads and its process Env is
    plaintext (tests/test_torch_env.require_reference_native): the twins
    here drive its ingest_packed or native jobs."""
    require_reference_native()


def mk_runs(seed, k, n, key_space, ttl_frac=0.0, tomb_frac=0.1,
            value_bytes=16):
    """k sorted runs of n entries (JAX package slabs) over key_space row
    keys, half root writes, half column writes. Hybrid times are one
    permutation over all k*n entries, so no internal key repeats across
    runs; ttl_frac of the entries carry a TTL."""
    rng = np.random.default_rng(seed)
    hts = (rng.permutation(k * n).astype(np.uint64) + 1) << 12
    runs = []
    for g in range(k):
        kid = rng.integers(0, key_space, size=n).astype(np.uint32)
        kw = np.zeros((n, 3), dtype=np.uint32)
        kw[:, 0] = 0x53000000 | (kid >> 16)
        kw[:, 1] = (kid << 16) | 0x2100
        key_len = np.full(n, 7, dtype=np.int32)
        is_col = rng.random(n) < 0.5
        kw[is_col, 1] |= 0x4B
        key_len[is_col] = 10
        ht = hts[g * n:(g + 1) * n]
        flg = np.where(rng.random(n) < tomb_frac, FLAG_TOMBSTONE,
                       0).astype(np.uint32)
        ttl = np.zeros(n, dtype=np.int64)
        if ttl_frac:
            has = rng.random(n) < ttl_frac
            flg[has] |= FLAG_HAS_TTL
            ttl[has] = rng.integers(1, 1000, size=int(has.sum()))
        wid = rng.integers(0, 4, size=n).astype(np.uint32)
        order = np.lexsort((~wid, ~ht, key_len) + tuple(
            kw[:, j] for j in range(2, -1, -1)))
        runs.append(KVSlab(
            key_words=kw[order], key_len=key_len[order],
            doc_key_len=np.full(n, 7, dtype=np.int32),
            ht_hi=(ht[order] >> 32).astype(np.uint32),
            ht_lo=(ht[order] & 0xFFFFFFFF).astype(np.uint32),
            write_id=wid[order], flags=flg[order], ttl_ms=ttl[order],
            value_idx=np.arange(n, dtype=np.int32),
            values=ValueArray(
                rng.integers(0, 256, size=n * value_bytes, dtype=np.uint8),
                np.arange(n + 1, dtype=np.int64) * value_bytes)))
    return runs


def write_runs(workdir, runs, tag="in"):
    """The runs as SST files (the JAX writer; both packages read them):
    their base paths."""
    os.makedirs(workdir, exist_ok=True)
    paths = []
    for i, slab in enumerate(runs):
        p = os.path.join(workdir, f"{tag}{i:03d}.sst")
        SSTWriter(p).write(slab, Frontier())
        paths.append(p)
    return paths


def files(outputs, data_only=False):
    """(name, bytes) of every output file, base and data; data_only: the
    data files' bytes alone (the native job names its files apart)."""
    out = []
    for _fid, base, _props in outputs:
        if data_only:
            with open(base + ".sblock.0", "rb") as f:
                out.append(f.read())
            continue
        for p in (base, base + ".sblock.0"):
            with open(p, "rb") as f:
                out.append((os.path.basename(p), f.read()))
    return out


def port_entry(cache, fid):
    st = cache.get(fid)
    cols = st.cols_dev.cpu().numpy().view(np.uint32)
    return cols[:, :st.n], st.n, st.n_pad, cache.level_of(fid)


def ref_entry(cache, fid):
    st = cache.get(fid)
    return (np.asarray(st.cols_dev).view(np.uint32)[:, :st.n], st.n,
            st.n_pad, cache.level_of(fid))


def same_entries(port_cache, ref_cache, ids):
    for fid in ids:
        p, r = port_entry(port_cache, fid), ref_entry(ref_cache, fid)
        assert np.array_equal(p[0], r[0]), fid
        assert p[1:] == r[1:], (fid, p[1:], r[1:])


def native(paths, out_dir, first_id=900):
    os.makedirs(out_dir, exist_ok=True)
    ids = iter(range(first_id, first_id + 500))
    return compaction._run_native_job(
        [SSTReader(p) for p in paths], out_dir, lambda: next(ids), CUTOFF,
        True, False, None)


class Side:
    """One package's chain state: its cache, run cache and job."""

    def __init__(self, pkg, route):
        self.pkg = pkg
        if pkg == "port":
            self.cache = DeviceSlabCache("cpu")
            self.rc = (NamespacedRunCache(NativeRunCache(1 << 30), "t")
                       if route == "run_cached" else None)
        else:
            self.cache = ref_dc.DeviceSlabCache(device=jax.devices("cpu")[0])
            self.rc = (ref_rc.NamespacedRunCache(
                ref_rc.NativeRunCache(capacity_bytes=1 << 30), "t")
                if route == "run_cached" else None)

    def reader(self, path):
        return SSTReader(path) if self.pkg == "port" else RefSSTReader(path)

    def flush(self, ids, paths):
        """Flush write-through: stage at level 0 (and export)."""
        for fid, p in zip(ids, paths):
            r = self.reader(p)
            self.cache.stage(fid, r.read_all(), level=0)
            if self.rc is not None:
                (export_reader if self.pkg == "port"
                 else ref_rc.export_reader)(self.rc, fid, r)

    def job(self, paths, out_dir, input_ids, first_id, is_major=True,
            cutoff=CUTOFF, cache=True):
        os.makedirs(out_dir, exist_ok=True)
        ids = iter(range(first_id, first_id + 500))
        readers = [self.reader(p) for p in paths]
        if self.pkg == "port":
            fn, dev = compaction.run_compaction_job_device_native, "cpu"
        else:
            fn = ref_compaction.run_compaction_job_device_native
            dev = jax.devices("cpu")[0]
        return fn(readers, out_dir, lambda: next(ids), cutoff, is_major,
                  device=dev, device_cache=self.cache if cache else None,
                  input_ids=input_ids if cache else None,
                  run_cache=self.rc if cache else None)


def chain(side, paths_a, paths_b, workdir, warm=True):
    """L0 -> L1 (two jobs) -> L2; returns (res_a, res_b, res_l2, the L1
    paths and ids, the port counters' deltas over the L1 -> L2 job)."""
    if warm:
        side.flush((0, 1), paths_a)
        side.flush((2, 3), paths_b)
    res_a = side.job(paths_a, os.path.join(workdir, "oa"), [0, 1], 100)
    res_b = side.job(paths_b, os.path.join(workdir, "ob"), [2, 3], 200)
    l1 = res_a.outputs + res_b.outputs
    l1_paths = [p for _f, p, _pr in l1]
    l1_ids = [f for f, _p, _pr in l1]
    before = counters()
    res_l2 = side.job(l1_paths, os.path.join(workdir, "l2"), l1_ids, 300)
    delta = {k: v - before[k] for k, v in counters().items()}
    return res_a, res_b, res_l2, l1_paths, l1_ids, delta


def counters():
    return {"blocks": port_sst.blocks_decoded(),
            "uploads": merge_gc.key_col_uploads(),
            "ingests": compaction.ingest_decodes()}


@pytest.fixture
def no_digest():
    """The sampled checks off in both packages: they decode host blocks
    when they fire."""
    old = (flags.get_flag("resident_digest_sample"),
           ref_flags.get_flag("resident_digest_sample"),
           ref_flags.get_flag("shadow_verify_sample"),
           flags.get_flag("shadow_verify_sample"))
    flags.set_flag("resident_digest_sample", 0.0)
    ref_flags.set_flag("resident_digest_sample", 0.0)
    ref_flags.set_flag("shadow_verify_sample", 0.0)
    flags.set_flag("shadow_verify_sample", 0.0)
    yield
    flags.set_flag("resident_digest_sample", old[0])
    ref_flags.set_flag("resident_digest_sample", old[1])
    ref_flags.set_flag("shadow_verify_sample", old[2])
    flags.set_flag("shadow_verify_sample", old[3])


def set_route(monkeypatch, route):
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "1" if route == "codec" else "0")


# ---------------------------------------------------------------------------
# the chain itself


@pytest.mark.parametrize("route", ROUTES)
def test_chained_l0_l1_l2_byte_identical_zero_decode(tmp_path, monkeypatch,
                                                     no_digest, route):
    """L0 -> L1 -> L2 with a warm cache: port == JAX file for file and
    entry for entry, L2 == the native job, residency levels 1 and 2, no
    pin left, and the warm L1 -> L2 job decodes no block on the host and
    uploads no key column (on the run-cached route the shell ingests no
    file either)."""
    set_route(monkeypatch, route)
    runs = mk_runs(21, 4, 700, 450)
    paths_a = write_runs(str(tmp_path / "a"), runs[:2])
    paths_b = write_runs(str(tmp_path / "b"), runs[2:])
    out = {}
    for pkg in ("port", "ref"):
        side = Side(pkg, route)
        out[pkg] = (side,) + chain(side, paths_a, paths_b,
                                   str(tmp_path / pkg))
    port, ref = out["port"], out["ref"]
    for i in (1, 2, 3):
        assert port[i].rows_out == ref[i].rows_out
        assert files(port[i].outputs) == files(ref[i].outputs)
    l1_ids, delta = port[5], port[6]
    same_entries(port[0].cache, ref[0].cache,
                 l1_ids + [f for f, _p, _pr in port[3].outputs])
    assert all(port[0].cache.level_of(f) == 1 for f in l1_ids)
    assert all(port[0].cache.level_of(f) == 2 for f, _p, _pr in
               port[3].outputs)
    assert port[0].cache.pinned_count() == 0
    # every output's learned index was fit on the device over its span
    assert all(pr.lindex is not None for i in (1, 2, 3)
               for _f, _p, pr in port[i].outputs)
    assert delta["blocks"] == 0 and delta["uploads"] == 0, delta
    if route == "run_cached":
        assert delta["ingests"] == 0, delta
        assert all(port[0].rc.contains(f) for f in l1_ids)
    ref_out = native(port[4], str(tmp_path / "native"))
    assert files(port[3].outputs, True) == files(ref_out.outputs, True)


@pytest.mark.parametrize("route", ["codec", "shell"])
def test_per_span_install_as_spans_complete(tmp_path, monkeypatch, route):
    """Each output file's entry is installed the moment its SST exists,
    observed from inside the writer's callback, before the job ends."""
    set_route(monkeypatch, route)
    paths = write_runs(str(tmp_path), mk_runs(22, 2, 900, 4000))
    side = Side("port", route)
    side.flush((0, 1), paths)
    seen = []
    orig = compaction._ResidentSpanInstaller.on_span

    def spy(self, fid, base_path, start, end):
        orig(self, fid, base_path, start, end)
        seen.append((fid, side.cache.contains(fid)))

    monkeypatch.setattr(compaction._ResidentSpanInstaller, "on_span", spy)
    old = flags.get_flag("compaction_max_output_entries_per_sst")
    flags.set_flag("compaction_max_output_entries_per_sst", 500)
    try:
        res = side.job(paths, str(tmp_path / "out"), [0, 1], 100)
    finally:
        flags.set_flag("compaction_max_output_entries_per_sst", old)
    assert len(res.outputs) >= 2, "expected a multi-file split"
    assert seen == [(f, True) for f, _p, _pr in res.outputs]


def test_digest_mismatch_drops_entry(tmp_path, monkeypatch):
    """A write-through entry that fails the sampled digest check is
    dropped, never installed, and counted; the job itself succeeds (the
    file bytes are host truth)."""
    paths = write_runs(str(tmp_path), mk_runs(23, 2, 600, 400))
    side = Side("port", "codec")
    side.flush((0, 1), paths)
    real = integrity.verify_resident_entry
    monkeypatch.setattr(integrity, "verify_resident_entry",
                        lambda st, p: real(st, p) + ["synthetic"])
    flags.set_flag("resident_digest_sample", 1.0)
    mm0 = integrity.resident_digest_snapshot()["mismatches"]
    try:
        res = side.job(paths, str(tmp_path / "out"), [0, 1], 100)
    finally:
        flags.set_flag("resident_digest_sample", 0.02)
    assert res.outputs
    assert not any(side.cache.contains(f) for f, _p, _pr in res.outputs)
    assert integrity.resident_digest_snapshot()["mismatches"] == \
        mm0 + len(res.outputs)
    assert side.cache.pinned_count() == 0


@pytest.mark.parametrize("route", ["codec", "shell"])
def test_digest_check_passes_clean_entries(tmp_path, monkeypatch, route):
    """With sampling forced to 1.0, every clean write-through entry is
    checked against its written file and installs."""
    set_route(monkeypatch, route)
    paths = write_runs(str(tmp_path), mk_runs(24, 2, 600, 400))
    side = Side("port", route)
    side.flush((0, 1), paths)
    flags.set_flag("resident_digest_sample", 1.0)
    snap0 = integrity.resident_digest_snapshot()
    try:
        res = side.job(paths, str(tmp_path / "out"), [0, 1], 100)
    finally:
        flags.set_flag("resident_digest_sample", 0.02)
    snap = integrity.resident_digest_snapshot()
    assert res.outputs and all(side.cache.contains(f)
                               for f, _p, _pr in res.outputs)
    assert snap["checked"] == snap0["checked"] + len(res.outputs)
    assert snap["mismatches"] == snap0["mismatches"]


def test_cold_chain_flat_decode_counters_with_device_codec(
        tmp_path, monkeypatch, no_digest):
    """A COLD chain (empty caches) on the codec route: no host block
    decode and no shell ingest anywhere; the four L0 files' raw columns
    are the only key-column uploads (stage_from_raw decodes them on the
    device), the L1 -> L2 job finds its inputs resident; files and
    entries == the JAX package's cold chain, L2 == the native job."""
    set_route(monkeypatch, "codec")
    runs = mk_runs(26, 4, 700, 450)
    paths_a = write_runs(str(tmp_path / "a"), runs[:2])
    paths_b = write_runs(str(tmp_path / "b"), runs[2:])
    port_side, ref_side = Side("port", "codec"), Side("ref", "codec")
    c0 = counters()
    port = chain(port_side, paths_a, paths_b, str(tmp_path / "port"),
                 warm=False)
    total = {k: v - c0[k] for k, v in counters().items()}
    ref = chain(ref_side, paths_a, paths_b, str(tmp_path / "ref"),
                warm=False)
    assert total == {"blocks": 0, "uploads": 4, "ingests": 0}, total
    assert port[5] == {"blocks": 0, "uploads": 0, "ingests": 0}
    assert [port_side.cache.level_of(f) for f in range(4)] == [0] * 4
    for i in (0, 1, 2):
        assert files(port[i].outputs) == files(ref[i].outputs)
    same_entries(port_side.cache, ref_side.cache,
                 port[4] + [f for f, _p, _pr in port[2].outputs])
    assert files(port[2].outputs, True) == files(
        native(port[3], str(tmp_path / "native")).outputs, True)


# ---------------------------------------------------------------------------
# residency policy: pins, levels, accounting


def _slab(n, seed=0):
    from yugabyte_tpu_torch.ops.slabs import slab_from_arrays
    s = mk_runs(seed, 1, n, 1 << 20)[0]
    return slab_from_arrays(
        values=s.values, key_words=s.key_words, key_len=s.key_len,
        doc_key_len=s.doc_key_len, ht_hi=s.ht_hi, ht_lo=s.ht_lo,
        write_id=s.write_id, flags=s.flags, ttl_ms=s.ttl_ms,
        value_idx=s.value_idx)


def test_eviction_never_evicts_pinned():
    cache = DeviceSlabCache("cpu", capacity_bytes=1)   # evict aggressively
    cache.stage(1, _slab(100))
    assert cache.pin(1)
    cache.stage(2, _slab(100))
    cache.stage(3, _slab(100))
    assert cache.contains(1)        # the pinned entry survives every pass
    cache.unpin(1)
    assert cache.pinned_count() == 0
    cache.stage(4, _slab(100))
    assert not cache.contains(1)    # unpinned: evictable again


def test_eviction_prefers_shallow_levels():
    cache = DeviceSlabCache("cpu", capacity_bytes=1 << 62)
    cache.stage(10, _slab(200), level=2)          # oldest, deep
    cache.stage(11, _slab(200), level=0)
    cache.stage(12, _slab(200), level=1)
    cache.capacity = cache.snapshot()["used_bytes"] - 1
    cache.stage(13, _slab(50), level=0)
    assert cache.contains(10), "the deep entry went before shallow ones"
    assert not cache.contains(11)   # the L0 entry went before the older L2


def test_pin_miss_returns_false():
    cache = DeviceSlabCache("cpu")
    assert not cache.pin(999)
    cache.unpin(999)                # a no-op, never raises
    assert cache.pinned_count() == 0


def test_used_bytes_tracks_every_mutation():
    """put, attach_vals, drop, drop_namespace and eviction all keep the
    used-bytes total equal to the entries' recorded bytes."""
    cache = DeviceSlabCache("cpu")

    def total():
        return sum(e.bytes for e in cache._map.values())

    cache.stage(("ns", 1), _slab(100))
    cache.stage(("ns", 2), _slab(100), include_vals=True)
    cache.stage(("other", 3), _slab(100))
    assert cache.snapshot()["used_bytes"] == total() > 0
    cache.attach_vals(("ns", 1), torch.zeros((4, 256), dtype=torch.int32))
    assert cache.snapshot()["used_bytes"] == total()
    cache.drop(("ns", 1))
    assert cache.snapshot()["used_bytes"] == total()
    cache.drop_namespace("ns")
    assert cache.snapshot()["used_bytes"] == total()
    cache.drop_namespace("other")
    assert cache.snapshot()["used_bytes"] == 0
    cache.capacity = 1
    cache.stage(("ns", 4), _slab(100))
    cache.stage(("ns", 5), _slab(100))
    assert cache.snapshot()["used_bytes"] == total() and cache.evictions > 0


def test_snapshot_levels_block():
    cache = DeviceSlabCache("cpu")
    cache.stage(1, _slab(50), level=0)
    cache.stage(2, _slab(50), level=1)
    cache.pin(2)
    snap = cache.snapshot()
    assert snap["entries"] == 2 and snap["pinned"] == 1
    assert snap["levels"]["L0"]["entries"] == 1
    assert snap["levels"]["L1"]["pinned"] == 1
    cache.unpin(2)


# ---------------------------------------------------------------------------
# lifecycle: the DB's flush, obsolete files and close


def test_obsolete_and_close_drop_slabs(tmp_path):
    """A DB with a device writes each flush through to both caches; the
    obsolete-file purge drops a file's entries from both, and close
    drops the DB's whole namespace from both."""
    from yugabyte_tpu_torch.common.hybrid_time import (DocHybridTime,
                                                       HybridTime)
    from yugabyte_tpu_torch.storage.db import DB, DBOptions
    cache = DeviceSlabCache("cpu")
    db = DB(str(tmp_path / "db"), DBOptions(device="cpu", device_cache=cache,
                                            auto_compact=False))
    assert db._run_cache is not None
    ns = os.path.abspath(str(tmp_path / "db"))
    fids = []
    for gen in range(3):
        db.write_batch([(b"Suser%08d\x00\x00!" % r,
                         DocHybridTime(HybridTime((1000 * gen + r + 1) << 12),
                                       0), b"$v%d" % gen)
                        for r in range(60)])
        fids.append(db.flush())
    assert all(cache.contains((ns, f)) and db._run_cache.contains(f)
               for f in fids)
    with db._lock:
        db._obsolete[fids[0]] = db._readers.pop(fids[0])
        db._purge_obsolete_unlocked()
    assert not cache.contains((ns, fids[0]))
    assert not db._run_cache.contains(fids[0])
    rc = db._run_cache
    db.close()
    assert not any(cache.contains((ns, f)) or rc.contains(f) for f in fids)
    assert cache.snapshot()["used_bytes"] == 0


# ---------------------------------------------------------------------------
# a failure inside the writer: clean unwind, coherent cache, zero pins


@pytest.mark.parametrize("route", ["codec", "shell"])
def test_fault_unwind_cache_coherent_zero_pins(tmp_path, monkeypatch, route):
    """An exception raised by the writer after its first output file:
    the attempt deletes every file it wrote, drops every entry it
    installed, keeps its inputs resident and leaks no pin; the job run
    again writes the native job's files."""
    set_route(monkeypatch, route)
    paths = write_runs(str(tmp_path), mk_runs(25, 2, 900, 4000))
    side = Side("port", route)
    side.flush((0, 1), paths)
    cls = (compaction._DeviceCodecWriter if route == "codec"
           else compaction._StreamingNativeWriter)
    real = cls._write_span
    calls = []

    def failing(self, *a, **k):
        if calls:
            raise OSError("injected writer failure")
        calls.append(1)
        return real(self, *a, **k)

    old = flags.get_flag("compaction_max_output_entries_per_sst")
    flags.set_flag("compaction_max_output_entries_per_sst", 500)
    try:
        monkeypatch.setattr(cls, "_write_span", failing)
        with pytest.raises(OSError, match="injected"):
            side.job(paths, str(tmp_path / "out"), [0, 1], 100)
        assert os.listdir(str(tmp_path / "out")) == []
        assert set(k for k in side.cache._map) == {0, 1}
        assert side.cache.pinned_count() == 0
        monkeypatch.setattr(cls, "_write_span", real)
        res = side.job(paths, str(tmp_path / "again"), [0, 1], 100)
        want = files(native(paths, str(tmp_path / "native")).outputs, True)
    finally:
        flags.set_flag("compaction_max_output_entries_per_sst", old)
    assert len(res.outputs) >= 2 and files(res.outputs, True) == want
    assert side.cache.pinned_count() == 0


# ---------------------------------------------------------------------------
# scans and the pushdown over the chain's resident outputs


def test_scan_over_resident_slabs_matches_and_skips_decode(tmp_path,
                                                           no_digest):
    """The L1 outputs of a chained job, read as ResidentSources of their
    write-through entries: the scan equals the SlabSource scan and the
    JAX package's scan of the same files, and a narrow range decodes
    only the blocks holding its survivors."""
    paths = write_runs(str(tmp_path), mk_runs(27, 2, 700, 450))
    side = Side("port", "codec")
    side.flush((0, 1), paths)
    old = port_sst._sst_flags.get_flag("sst_block_entries")
    port_sst._sst_flags.set_flag("sst_block_entries", 64)
    try:
        res = side.job(paths, str(tmp_path / "out"), [0, 1], 100)
    finally:
        port_sst._sst_flags.set_flag("sst_block_entries", old)
    outs = [(f, SSTReader(p)) for f, p, _pr in res.outputs]
    read_ht = CUTOFF + (1 << 40)
    want = list(ref_scan.visible_entries_sources(
        [ref_scan.SlabSource(RefSSTReader(r.base_path).read_all(),
                             sorted_source=True) for _f, r in outs],
        read_ht))
    src = [scan.ResidentSource(r, side.cache.get(f)) for f, r in outs]
    b0 = port_sst.blocks_decoded()
    assert list(scan.visible_entries_sources(src, read_ht,
                                             device="cpu")) == want
    assert port_sst.blocks_decoded() - b0 == sum(r.n_blocks
                                                  for _f, r in outs)
    keys = [k for k, _v, _h in want]
    lo, hi = keys[len(keys) // 3], keys[len(keys) // 3 + 5]
    one = [scan.ResidentSource(r, side.cache.get(f)) for f, r in outs]
    got = list(scan.visible_entries_sources(one, read_ht, lo, hi,
                                            device="cpu"))
    assert got == [e for e in want if lo <= e[0] < hi]
    assert 1 <= sum(s.decoded_blocks for s in one) <= 2


# ---------------------------------------------------------------------------
# the mesh job with a cache


def test_mesh_job_with_cache_matches_reference(tmp_path, no_digest):
    """run_compaction_job_dist_native with a device cache on 8 CPU shards
    == the JAX package's on its 8 host devices: the same files, and the
    same entries installed under every output id at level 1."""
    paths = write_runs(str(tmp_path), mk_runs(28, 4, 600, 500))
    out = {}
    for pkg in ("port", "ref"):
        side = Side(pkg, "shell")
        side.flush(range(4), paths)
        os.makedirs(str(tmp_path / pkg))
        ids = iter(range(100, 600))
        readers = [side.reader(p) for p in paths]
        if pkg == "port":
            res = compaction.run_compaction_job_dist_native(
                readers, str(tmp_path / pkg), lambda: next(ids), CUTOFF,
                True, device="cpu", device_cache=side.cache,
                input_ids=list(range(4)), mesh=make_mesh(8, ["cpu"] * 8))
        else:
            res = ref_compaction.run_compaction_job_dist_native(
                readers, str(tmp_path / pkg), lambda: next(ids), CUTOFF,
                True, device=jax.devices("cpu")[0], device_cache=side.cache,
                input_ids=list(range(4)), mesh=ref_mesh(8))
        out[pkg] = (side, res)
    (port_side, port), (ref_side, ref) = out["port"], out["ref"]
    assert files(port.outputs) == files(ref.outputs) and port.outputs
    ids = [f for f, _p, _pr in port.outputs]
    same_entries(port_side.cache, ref_side.cache, ids)
    assert all(port_side.cache.level_of(f) == 1 for f in ids)
    assert files(port.outputs, True) == files(
        native(paths, str(tmp_path / "native")).outputs, True)
