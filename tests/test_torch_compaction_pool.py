"""The port's mesh-sharded compaction pool against the JAX package's.

Twins of tests/test_compaction_pool.py's six cases. The port's
`CompactionPool` runs on `make_mesh(8, devices=["cpu"] * 8)` (the plain
versions of kernels A and B on every slot), the JAX pool on conftest's
8 virtual CPU devices, over the same SST files (chip_smoke's YCSB-A runs,
made from seeds): pooled outputs byte-identical to the JAX pool's, to a
sequential job and to the native job; deficit-fair scheduling under a
saturating tablet; merge-only decisions equal to a single-device launch;
cancellation mid-job sweeping the victim's partial outputs with zero pins
while its co-scheduled job completes; a wave fault quarantining the
bucket and completing every wave job natively, byte-identically; and a
demoted bucket routing its jobs native. Last, DBs whose DBOptions.mesh_pool
is the pool: their scheduled compactions ride one wave and write the
native DBs' files.
"""

import glob

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from yugabyte_tpu.parallel.mesh import make_mesh as ref_make_mesh
from yugabyte_tpu.storage import device_cache as ref_dc
from yugabyte_tpu.storage.sst import SSTReader as RefSSTReader
from yugabyte_tpu.tserver import compaction_pool as ref_pool
from yugabyte_tpu_torch.common.hybrid_time import HybridTime
from yugabyte_tpu_torch.ops import device_faults, run_merge
from yugabyte_tpu_torch.ops.merge_gc import GCParams
from yugabyte_tpu_torch.parallel.mesh import make_mesh
from yugabyte_tpu_torch.storage import native_engine, offload_policy
from yugabyte_tpu_torch.storage.bucket_health import health_board
from yugabyte_tpu_torch.storage.compaction import run_compaction_job
from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
from yugabyte_tpu_torch.storage.sst import SSTReader, data_file_name
from yugabyte_tpu_torch.tserver.compaction_pool import (CompactionPool,
                                                        PoolRequest)
from yugabyte_tpu_torch.utils import flags, lock_rank, sync_point
from yugabyte_tpu_torch.utils.cancellation import (CancellationToken,
                                                   OperationCancelled)

pytestmark = pytest.mark.skipif(not native_engine.available(),
                                reason="native engine unavailable")

# The tier-1 run shares the host's cores among its workers.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def lock_order():
    """The DB's, the thread pools' and the compaction pool's locks are
    order-tracked for each test: no acquisition order closes a cycle."""
    lock_rank.enable()
    yield
    lock_rank.enable(False)
    lock_rank.assert_no_cycles()

CUTOFF = 10_000_000 << 12


@pytest.fixture
def pool():
    health_board().reset()
    p = CompactionPool(make_mesh(8, devices=["cpu"] * 8))
    yield p
    p.shutdown()
    device_faults.disarm_all()
    offload_policy.bucket_quarantine().clear()
    health_board().reset()


def _tablet_inputs(tmp_path, tag, n=4000, k=4, seed=0):
    d = tmp_path / tag
    d.mkdir()
    runs = chip_smoke.synth_ycsb_runs(n, k, max(1, n // 2), seed,
                                      value_bytes=16)
    return [r.base_path for r in chip_smoke.write_inputs(runs, str(d))]


def _out_bytes(result):
    blobs = []
    for _fid, p, _props in result.outputs:
        for f in (p, data_file_name(p)):
            with open(f, "rb") as fh:
                blobs.append(fh.read())
    return blobs


def _merge_jobs(n_jobs, n=4000, seed0=0):
    return [chip_smoke.synth_ycsb_runs(n, 4, n // 2, seed0 + j,
                                       value_bytes=8)
            for j in range(n_jobs)]


def _submit_files(p, tid, paths, out_dir, request_cls, reader_cls, **kw):
    ids = iter(range(100, 10_000))
    readers = [reader_cls(x) for x in paths]
    return p.submit(tid, request_cls(
        inputs=readers, out_dir=str(out_dir), new_file_id=lambda: next(ids),
        history_cutoff_ht=CUTOFF, is_major=True, **kw)), readers


_COUNTS = ("waves", "wave_jobs", "native_completions", "wave_faults",
           "cancelled")


def _counts(p):
    """The pool counters (process-wide registry counters) of a snapshot."""
    snap = p.snapshot()
    return {k: snap[k] for k in _COUNTS}


def _moved(p, before):
    now = _counts(p)
    return {k: now[k] - before[k] for k in _COUNTS}


def _sequential(paths, out_dir, device):
    out_dir.mkdir()
    ids = iter(range(100, 10_000))
    return run_compaction_job([SSTReader(p) for p in paths], str(out_dir),
                              lambda: next(ids), CUTOFF, True, device=device)


def test_pool_differential_byte_identical(tmp_path, pool):
    """Concurrent pooled compactions (each tablet's inputs resident in its
    shard partition) == the JAX pool's outputs == a sequential job ==
    the native job, byte for byte; zero pins; the outputs installed into
    the shard partitions one level up."""
    shared = DeviceSlabCache("cpu", capacity_bytes=1 << 30)
    tablets = {f"t{t}": _tablet_inputs(tmp_path, f"in{t}", seed=t)
               for t in range(4)}
    c0 = _counts(pool)
    handles = {}
    for tid, paths in tablets.items():
        cache = pool.partition_for(shared, f"db-{tid}", tid)
        for fid, p in enumerate(paths):
            cache.stage(fid, SSTReader(p).read_all())
        (tmp_path / f"pool_{tid}").mkdir()
        handles[tid] = _submit_files(
            pool, tid, paths, tmp_path / f"pool_{tid}", PoolRequest,
            SSTReader, input_ids=list(range(len(paths))), device_cache=cache)
    results = {tid: h.result(timeout=300) for tid, (h, _r) in
               handles.items()}
    assert shared.pinned_count() == 0
    moved = _moved(pool, c0)
    assert moved["waves"] >= 1 and moved["wave_jobs"] == 4
    assert moved["native_completions"] == 0
    for tid, res in results.items():
        part = pool.partition_for(shared, f"db-{tid}", tid)
        for fid, _p, props in res.outputs:
            assert part.level_of(fid) == 1 and part.get(fid).n == \
                props.n_entries
    # the JAX pool over the same files
    rp = ref_pool.CompactionPool(ref_make_mesh(8))
    try:
        ref_shared = ref_dc.DeviceSlabCache(jax.devices()[0],
                                             capacity_bytes=1 << 30)
        ref_handles = {}
        for tid, paths in tablets.items():
            cache = rp.partition_for(ref_shared, f"db-{tid}", tid)
            for fid, p in enumerate(paths):
                cache.stage(fid, RefSSTReader(p).read_all())
            (tmp_path / f"ref_{tid}").mkdir()
            ref_handles[tid] = _submit_files(
                rp, tid, paths, tmp_path / f"ref_{tid}",
                ref_pool.PoolRequest, RefSSTReader,
                input_ids=list(range(len(paths))), device_cache=cache)
        ref_results = {tid: h.result(timeout=300)
                       for tid, (h, _r) in ref_handles.items()}
    finally:
        rp.shutdown()
    for tid, paths in tablets.items():
        seq = _sequential(paths, tmp_path / f"seq_{tid}", "cpu")
        nat = _sequential(paths, tmp_path / f"nat_{tid}", "native")
        got = _out_bytes(results[tid])
        assert got == _out_bytes(ref_results[tid]), tid
        assert got[1::2] == _out_bytes(seq)[1::2] == _out_bytes(nat)[1::2]
        assert results[tid].rows_out == seq.rows_out


def test_pool_fairness_under_saturation(pool):
    """A tablet saturating the queue does not starve a light tablet: the
    light tablet's jobs complete while a slice of the heavy backlog is
    still pending."""
    heavy = [pool.submit("heavy", PoolRequest(
        inputs=[], out_dir="", new_file_id=None, history_cutoff_ht=CUTOFF,
        is_major=True, slabs=runs)) for runs in _merge_jobs(24, n=2000)]
    light = [pool.submit("light", PoolRequest(
        inputs=[], out_dir="", new_file_id=None, history_cutoff_ht=CUTOFF,
        is_major=True, slabs=runs))
        for runs in _merge_jobs(2, n=2000, seed0=100)]
    for h in light + heavy:
        h.result(timeout=300)
    light_last = max(h.finished_at for h in light)
    assert sum(1 for h in heavy if h.finished_at > light_last) >= 8


def test_pool_merge_decisions_match_single_device(pool):
    """Merge-only pool jobs return the decisions of a single-device launch
    over the same runs, and of the JAX pool."""
    from yugabyte_tpu.ops.merge_gc import GCParams as RefParams
    from yugabyte_tpu.ops import run_merge as ref_run_merge
    from yugabyte_tpu.ops.slabs import KVSlab, ValueArray
    jobs = _merge_jobs(6, n=3000)
    handles = [pool.submit(f"t{i}", PoolRequest(
        inputs=[], out_dir="", new_file_id=None, history_cutoff_ht=CUTOFF,
        is_major=True, slabs=runs)) for i, runs in enumerate(jobs)]
    for h, runs in zip(handles, jobs):
        surv, mk_surv = h.result(timeout=300)
        perm, keep, mk = run_merge.merge_and_gc_runs(
            runs, GCParams(CUTOFF, True), device="cpu")
        assert np.array_equal(surv, perm[keep])
        assert np.array_equal(mk_surv, mk[keep])
    ref_runs = [KVSlab(s.key_words, s.key_len, s.doc_key_len, s.ht_hi,
                       s.ht_lo, s.write_id, s.flags, s.ttl_ms, s.value_idx,
                       ValueArray(s.values.data, s.values.offsets))
                for s in jobs[0]]
    perm, keep, mk = ref_run_merge.merge_and_gc_runs(
        ref_runs, RefParams(CUTOFF, True))
    surv, mk_surv = handles[0].result()
    assert np.array_equal(surv, np.asarray(perm)[np.asarray(keep)])
    assert np.array_equal(mk_surv, np.asarray(mk)[np.asarray(keep)])


def test_pool_cancellation_sweeps_partial_outputs(tmp_path, pool):
    """A job cancelled after its first output file (the
    compaction:output_written sync point) raises OperationCancelled with
    every partial output swept and zero pins; its co-scheduled job
    completes, byte-identical to the native job."""
    paths = _tablet_inputs(tmp_path, "in_victim", n=12000, seed=7)
    other = _tablet_inputs(tmp_path, "in_other", n=4000, seed=8)
    shared = DeviceSlabCache("cpu")
    cache = pool.partition_for(shared, "db-victim", "victim")
    for fid, p in enumerate(paths):
        cache.stage(fid, SSTReader(p).read_all())
    outd, outd2 = tmp_path / "out_victim", tmp_path / "out_other"
    outd.mkdir()
    outd2.mkdir()
    token = CancellationToken("victim")
    c0 = _counts(pool)

    def trip():
        if glob.glob(str(outd / "*.sst")):
            token.cancel("test cancel mid-write")
    flags.set_flag("compaction_max_output_entries_per_sst", 1000)
    sync_point.arm("compaction:output_written", trip)
    try:
        ids = iter(range(100, 10_000))
        h = pool.submit("victim", PoolRequest(
            inputs=[SSTReader(p) for p in paths], out_dir=str(outd),
            new_file_id=lambda: next(ids), history_cutoff_ht=CUTOFF,
            is_major=True, input_ids=list(range(4)), device_cache=cache),
            cancel=token)
        h2, _r = _submit_files(pool, "bystander", other, outd2, PoolRequest,
                               SSTReader)
        with pytest.raises(OperationCancelled):
            h.result(timeout=300)
        res2 = h2.result(timeout=300)
    finally:
        sync_point.disarm("compaction:output_written")
    nat = _sequential(other, tmp_path / "nat", "native")
    flags.reset_flag("compaction_max_output_entries_per_sst")
    assert glob.glob(str(outd / "*")) == []
    assert shared.pinned_count() == 0
    assert sorted(k[1] for k in shared._map) == [0, 1, 2, 3]
    assert _out_bytes(res2) == _out_bytes(nat) and res2.rows_out
    assert _moved(pool, c0)["cancelled"] == 1


def test_pool_wave_fault_quarantines_without_collateral(tmp_path, pool):
    """A device fault in a wave quarantines the bucket and completes every
    wave job natively, byte-identically: one bad slot never aborts the
    co-scheduled jobs."""
    tablets = {f"f{t}": _tablet_inputs(tmp_path, f"inf{t}", seed=20 + t)
               for t in range(2)}
    c0 = _counts(pool)
    device_faults.arm("runtime", site="dispatch", count=1)
    handles = {}
    for tid, paths in tablets.items():
        (tmp_path / f"pool_{tid}").mkdir()
        handles[tid] = _submit_files(pool, tid, paths, tmp_path / f"pool_{tid}",
                                     PoolRequest, SSTReader)
    results = {tid: h.result(timeout=300) for tid, (h, _r) in
               handles.items()}
    moved = _moved(pool, c0)
    assert moved["wave_faults"] == 1 and moved["waves"] == 0
    assert moved["native_completions"] == 2
    assert offload_policy.bucket_quarantine().snapshot()
    for tid, paths in tablets.items():
        nat = _sequential(paths, tmp_path / f"nat_{tid}", "native")
        assert _out_bytes(results[tid]) == _out_bytes(nat), tid


def test_pool_bucket_demotion_routes_native(pool):
    """A bucket the board demotes (measured native far faster) routes its
    next job native; the snapshot says so; the native decisions equal the
    kernels'."""
    board = health_board()
    jobs = _merge_jobs(2, n=2000)
    pool.submit("warm", PoolRequest(
        inputs=[], out_dir="", new_file_id=None, history_cutoff_ht=CUTOFF,
        is_major=True, slabs=jobs[0])).result(timeout=300)
    keys = [tuple(r["bucket"]) for r in board.snapshot()["keys"]
            if r["family"] == "run_merge_fused" and r["device_obs"] > 0]
    assert keys
    bucket = keys[0]
    board.record_native("run_merge_fused", bucket, 10**9, 1.0)
    for _ in range(int(flags.get_flag("bucket_health_warmup_obs"))):
        board.record_device("run_merge_fused", bucket, 1, 1.0)
    assert board.state("run_merge_fused", bucket) == "degraded"
    before = pool.snapshot()["native_completions"]
    surv, mk_surv = pool.submit("warm", PoolRequest(
        inputs=[], out_dir="", new_file_id=None, history_cutoff_ht=CUTOFF,
        is_major=True, slabs=jobs[1])).result(timeout=300)
    snap = pool.snapshot()
    assert snap["native_completions"] == before + 1
    assert snap["bucket_rates"][f"k{bucket[0]}_m{bucket[1]}"]["demoted"]
    perm, keep, mk = run_merge.merge_and_gc_runs(
        jobs[1], GCParams(CUTOFF, True), device="cpu")
    assert np.array_equal(surv, perm[keep])
    assert np.array_equal(mk_surv, mk[keep])


def test_db_mesh_pool_rides_one_wave(tmp_path):
    """8 tablet DBs with DBOptions.mesh_pool (their caches the pool's
    shard partitions, their scheduling on a compaction thread pool): the
    4th flush of each schedules a compaction, all 8 ride one wave (the
    pool's loop is held at compaction_pool:take_round until they are
    queued), and every DB's files equal its native twin's."""
    import threading
    from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime
    from yugabyte_tpu_torch.storage.db import DB, DBOptions
    from yugabyte_tpu_torch.utils.threadpool import PriorityThreadPool
    health_board().reset()
    release = threading.Event()
    sync_point.arm("compaction_pool:take_round",
                   lambda: release.wait(60))
    mp = CompactionPool(make_mesh(8, devices=["cpu"] * 8))
    c0 = _counts(mp)
    threads = PriorityThreadPool(8, name="tablet-compactions")
    shared = DeviceSlabCache("cpu")
    dbs = []
    try:
        for t in range(8):
            kw = dict(retention_policy=lambda: HybridTime.kMax.value,
                      block_entries=256)
            pooled = DB(str(tmp_path / f"t{t}"), DBOptions(
                device="cpu", mesh_pool=mp, compaction_pool=threads,
                device_cache=mp.partition_for(shared, f"t{t}", f"t{t}"),
                **kw))
            native = DB(str(tmp_path / f"n{t}"),
                        DBOptions(device="native", **kw))
            dbs.append((pooled, native))
        rng = np.random.default_rng(3)
        for gen in range(4):
            for t, pair in enumerate(dbs):
                ids = rng.integers(0, 400, size=300)
                for db in pair:
                    db.write_batch([(b"Suser%08d\x00\x00!" % k, DocHybridTime(
                        HybridTime.from_micros(10_000 * (gen + 1) + i), 0),
                        b"v%d-g%d-%d" % (t, gen, i))
                        for i, k in enumerate(ids.tolist())])
                    db.flush()
        deadline = 0
        while mp.snapshot()["queue_depth"] < 8 and deadline < 600:
            threading.Event().wait(0.05)
            deadline += 1
        release.set()
        threads.wait_idle()
        moved = _moved(mp, c0)
        assert (moved["waves"], moved["wave_jobs"]) == (1, 8)
        for pooled, native in dbs:
            assert pooled.compaction_stats.to_dict()["compactions"] == 1
            got = [open(data_file_name(fm.path), "rb").read() + open(
                fm.path, "rb").read() for fm in pooled.versions.live_files()]
            want = [open(data_file_name(fm.path), "rb").read() + open(
                fm.path, "rb").read() for fm in native.versions.live_files()]
            assert got == want and got
        assert shared.pinned_count() == 0
    finally:
        release.set()
        sync_point.disarm("compaction_pool:take_round")
        for pair in dbs:
            for db in pair:
                db.close()
        threads.shutdown()
        mp.shutdown()
        health_board().reset()
