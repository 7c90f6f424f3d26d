"""The port's native run cache against the JAX package, on the CPU.

Twin of tests/test_run_cache.py. storage/run_cache.py over the port's
own native library: an output exported into the run cache must be
byte-equivalent to re-decoding the file written for the same survivor
range, so a job ingesting cached runs (prepare_cached) writes files
byte-identical to one decoding its inputs from disk, rewritten-as-
tombstone survivors included, and to the JAX package's cached job. The
cache is an LRU over immutable C++ entries whose byte accounting the
Python side must track. Inputs are made from a seed with numpy; no
internal key repeats across runs.
"""

import os

import pytest
import torch

from tests.test_torch_resident_chain import (Side, files, mk_runs, native,
                                             write_runs)
from yugabyte_tpu_torch.storage import native_engine, run_cache
from yugabyte_tpu_torch.storage.run_cache import NativeRunCache
from yugabyte_tpu_torch.storage.sst import SSTReader
from yugabyte_tpu_torch.utils import flags

pytestmark = pytest.mark.skipif(not native_engine.available(),
                                reason="native engine unavailable")

torch.set_num_threads(1)


@pytest.fixture
def workload(tmp_path, monkeypatch):
    """Four runs with TTLs, written once; the shell route (a run-cached
    job takes it anyway)."""
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "0")
    paths = write_runs(str(tmp_path), mk_runs(7, 4, 800, 500, ttl_frac=0.3))
    return str(tmp_path), paths


IDS = [10 ** 9 + i for i in range(4)]


def test_cached_job_matches_decode_job(workload):
    """The all-cached input path == the from-disk path == the JAX
    package's cached job, byte for byte; every input was a hit."""
    workdir, paths = workload
    out = {}
    for pkg in ("port", "ref"):
        side = Side(pkg, "run_cached")
        side.flush(IDS, paths)
        hits0 = side.rc.hits
        res = side.job(paths, os.path.join(workdir, pkg + "_rc"), IDS, 100,
                       cutoff=1 << 60)
        assert side.rc.hits == hits0 + len(paths)
        out[pkg] = res
        if pkg == "port":
            side.rc = None
            out["disk"] = side.job(paths, os.path.join(workdir, "disk"),
                                   IDS, 100, cutoff=1 << 60)
    assert files(out["port"].outputs) == files(out["ref"].outputs)
    assert files(out["port"].outputs, True) == files(out["disk"].outputs,
                                                     True)


def test_tombstone_rewrite_survives_chain(workload):
    """Survivors rewritten as tombstones (TTL-expired at a non-major
    compaction) round-trip the cache as tombstones: a chained job from
    the cached outputs equals one from the decoded outputs and the JAX
    package's chained job."""
    workdir, paths = workload
    cutoff = 1 << 62   # far future: TTLs expire, non-major rewrites them
    out = {}
    for pkg in ("port", "ref"):
        side = Side(pkg, "run_cached")
        side.flush(IDS, paths)
        res1 = side.job(paths, os.path.join(workdir, pkg + "1"), IDS, 100,
                        is_major=False, cutoff=cutoff)
        assert res1.rows_out and res1.tombstones_written
        ids1 = [f for f, _p, _pr in res1.outputs]
        assert all(side.rc.contains(f) for f in ids1), \
            "compaction outputs must be exported to the run cache"
        paths1 = [p for _f, p, _pr in res1.outputs]
        res_c = side.job(paths1, os.path.join(workdir, pkg + "2c"), ids1,
                         300, cutoff=cutoff)
        out[pkg] = (res1, res_c)
        if pkg == "port":
            side.rc = None
            out["decoded"] = side.job(
                paths1, os.path.join(workdir, "2d"), ids1, 300,
                cutoff=cutoff)
    assert files(out["port"][0].outputs) == files(out["ref"][0].outputs)
    assert files(out["port"][1].outputs) == files(out["ref"][1].outputs)
    assert files(out["port"][1].outputs, True) == files(
        out["decoded"].outputs, True)


def test_partial_hit_falls_back_to_decode(workload):
    """One missing input sends the whole job down the file path (the run
    order could not otherwise match the device's run-major indexes):
    no hit is counted, and the files equal the from-disk job's."""
    workdir, paths = workload
    side = Side("port", "run_cached")
    side.flush(IDS[:-1], paths[:-1])
    side.cache.stage(IDS[-1], SSTReader(paths[-1]).read_all())
    hits0 = side.rc.hits
    res = side.job(paths, os.path.join(workdir, "p"), IDS, 100,
                   cutoff=1 << 60)
    assert side.rc.hits == hits0
    side.rc = None
    res_no = side.job(paths, os.path.join(workdir, "q"), IDS, 100,
                      cutoff=1 << 60)
    assert res.rows_out == res_no.rows_out
    assert files(res.outputs, True) == files(res_no.outputs, True)


def test_lru_eviction_and_native_accounting(tmp_path):
    """Eviction keeps the Python and the C++ byte accounting in step;
    dropped ids are gone from the native registry; a run larger than the
    whole budget is evicted at once."""
    paths = write_runs(str(tmp_path), mk_runs(3, 3, 300, 200))
    ids, sizes = [], []
    for p in paths:
        r = SSTReader(p)
        with native_engine.NativeCompactionJob() as j:
            with open(r.data_path, "rb") as f:
                j.add_input(f.read(), r.block_handles)
            n = j.prepare()
            j.sort_all()
            rid = j.export_run(0, n, b"X")
        ids.append(rid)
        sizes.append(native_engine.runcache_entry_bytes(rid))
    base = native_engine.runcache_bytes()
    rc = NativeRunCache(capacity_bytes=sizes[0] + sizes[1] + 1)
    for i, (rid, nb) in enumerate(zip(ids, sizes)):
        rc.put(("t", i), rid, nb)
    assert not rc.contains(("t", 0)) and rc.contains(("t", 2))
    assert rc.used_bytes <= rc.capacity
    assert native_engine.runcache_entry_bytes(ids[0]) == -1   # dropped
    rc.drop_namespace("t")
    assert rc.used_bytes == 0
    assert native_engine.runcache_bytes() == base - sum(sizes)
    with native_engine.NativeCompactionJob() as j:
        r = SSTReader(paths[2])
        with open(r.data_path, "rb") as f:
            j.add_input(f.read(), r.block_handles)
        n = j.prepare()
        j.sort_all()
        rid = j.export_run(0, n, b"X")
    rc2 = NativeRunCache(capacity_bytes=sizes[2] - 1)
    rc2.put(("t", 9), rid, sizes[2])
    assert not rc2.contains(("t", 9)) and rc2.used_bytes == 0
    assert native_engine.runcache_entry_bytes(rid) == -1


def test_db_flush_exports_and_compaction_hits(tmp_path):
    """DB integration: each flush writes through to the run cache, and a
    device-native job over the flushed files starts all-cached (a hit per
    input, no shell ingest of a file), re-exports its outputs and writes
    the native job's files. The shared cache is off when its budget is 0
    (the DB then keeps none)."""
    from yugabyte_tpu_torch.common.hybrid_time import (DocHybridTime,
                                                       HybridTime)
    from yugabyte_tpu_torch.storage import compaction
    from yugabyte_tpu_torch.storage.db import DB, DBOptions
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    db = DB(str(tmp_path / "db"), DBOptions(
        device="cpu", device_cache=DeviceSlabCache("cpu"),
        auto_compact=False))
    assert db._run_cache is not None
    ht, fids = 1000, []
    for batch in range(4):
        items = []
        for i in range(200):
            k = b"Suser%08d\x00\x00!" % ((batch * 150 + i) % 400)
            items.append((k, DocHybridTime(HybridTime(ht << 12), 0),
                          b"$v%d-%d" % (batch, i)))
            ht += 1
        db.write_batch(items)
        fids.append(db.flush())
        assert db._run_cache.contains(fids[-1]), \
            "flush must write through to the run cache"
    readers = [db._readers[f] for f in fids]
    hits0, ingests0 = db._run_cache.hits, compaction.ingest_decodes()
    os.makedirs(str(tmp_path / "out"))
    ids = iter(range(500, 600))
    res = compaction.run_compaction_job(
        readers, str(tmp_path / "out"), lambda: next(ids), ht << 12, True,
        device="cpu", device_cache=db._device_cache, input_ids=fids,
        run_cache=db._run_cache)
    assert db._run_cache.hits == hits0 + len(fids)
    assert compaction.ingest_decodes() == ingests0
    assert all(db._run_cache.contains(f) for f, _p, _pr in res.outputs)
    want = native([r.base_path for r in readers], str(tmp_path / "native"))
    assert files(res.outputs, True) == files(want.outputs, True) \
        and res.outputs
    db.close()
    old = flags.get_flag("compaction_run_cache_mb")
    flags.set_flag("compaction_run_cache_mb", 0)
    try:
        assert run_cache.shared_run_cache() is None
        db2 = DB(str(tmp_path / "db2"), DBOptions(device="cpu",
                                                  auto_compact=False))
        assert db2._run_cache is None
        db2.close()
    finally:
        flags.set_flag("compaction_run_cache_mb", old)
