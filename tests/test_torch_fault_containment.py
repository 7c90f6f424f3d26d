"""Device-fault containment of the port against the JAX package's.

For each fault site and kind, the same fault is armed in both packages
(ops/device_faults) and the same job runs in each: the port's job, the
JAX job and the native CompactionJob must write byte-identical files;
the two bucket-health boards must end in equal states (keys, states,
rates observed, faults, quarantine windows, transition log, tally), and
the fault-related registry counters (offload_policy, bucket_health,
integrity, the injected-fault and retry counters, the codec's encode
fallbacks, point_read, scan_pushdown) must have equal names and equal
values moved. A parked bucket's next job launches nothing: still-armed
faults do not fire. `multi_get` and the pushdown answer the same under a
fault, and the mesh job completes natively with equal files.

Cancellation is held the same way: a token tripped before the pipeline
starts, or after its first output file, aborts both packages' jobs with
no partial output, nothing on either board and no counter moved; DB
close and cancel_background_work trip each DB's token alike. The pool's
wave containment: a faulted wave quarantines its bucket and completes
its job natively in both packages' pools, with equal boards and
counters.

Jobs are a few hundred rows; the JAX jobs run on its CPU backend. The
prewarm op's case is in tests/test_torch_maintenance_manager.py; the
JAX package's containment cases that need a mini-cluster wait for
ROADMAP queue A item 7g.
"""

import os

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_compaction import _mk_run, _write_inputs, _files
from tests.test_torch_env import require_reference_native
from yugabyte_tpu.ops import device_faults as ref_df
from yugabyte_tpu.storage import bucket_health as ref_bh
from yugabyte_tpu.storage import compaction as ref_compaction
from yugabyte_tpu.storage import integrity as ref_integrity  # noqa: F401
from yugabyte_tpu.storage.sst import SSTReader as RefSSTReader
from yugabyte_tpu.utils import flags as ref_flags
from yugabyte_tpu.utils.metrics import ROOT_REGISTRY as REF_REGISTRY
from yugabyte_tpu_torch.ops import device_faults as port_df
from yugabyte_tpu_torch.storage import bucket_health as port_bh
from yugabyte_tpu_torch.storage import compaction as port_compaction
from yugabyte_tpu_torch.storage import integrity  # noqa: F401 (its flags)
from yugabyte_tpu_torch.storage.sst import SSTReader
from yugabyte_tpu_torch.utils import flags as port_flags
from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY as PORT_REGISTRY

torch.set_num_threads(1)

CUTOFF = (1 << 21) << 12
BUCKET = (4, 512)        # three 300-row runs: k_pad 4, m 512

_ENTITIES = ("offload_policy", "bucket_health", "integrity", "point_read",
             "scan_pushdown")


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native engine loads and its process Env is
    plaintext (tests/test_torch_env.require_reference_native): the twins
    here drive its ingest_packed or native jobs."""
    require_reference_native()


@pytest.fixture(autouse=True)
def _clean():
    """Both packages disarmed, the port's board fresh (the repo conftest
    resets the JAX one), and the sampled checks off unless a test turns
    them on: every test starts from the same state in both."""
    samples = {k: (port_flags.get_flag(k), ref_flags.get_flag(k))
               for k in ("shadow_verify_sample", "resident_digest_sample")}
    for k in samples:
        port_flags.set_flag(k, 0.0)
        ref_flags.set_flag(k, 0.0)
    for m in (ref_df, port_df):
        m.disarm_all()
    port_bh.health_board().reset()
    ref_bh.health_board().reset()
    yield
    for m in (ref_df, port_df):
        m.disarm_all()
    port_bh.health_board().reset()
    ref_bh.health_board().reset()
    for k, (p, r) in samples.items():
        port_flags.set_flag(k, p)
        ref_flags.set_flag(k, r)


def fault_counters(registry):
    """Every fault-related counter of one package's registry."""
    out = {}
    for ent in _ENTITIES:
        e = registry.entity("server", ent)
        for k, m in e.metrics_snapshot().items():
            if hasattr(m, "value") and "_total" in k \
                    and "_dispatch_total" not in k:
                out[(ent, k)] = m.value()
    kern = registry.entity("server", "kernels").metrics_snapshot()
    for k, m in kern.items():
        if k.startswith("kernel_injected_fault_") \
                or k == "kernel_chunk_retry_total":
            out[("kernels", k)] = m.value()
    st = registry.entity("server", "storage").metrics_snapshot()
    k = "compaction_block_encode_fallback_total"
    if k in st:
        out[("storage", k)] = st[k].value()
    return out


def moved(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def board_view(board):
    """A board's snapshot without its clock readings."""
    snap = board.snapshot()
    keys = [{k: v for k, v in rec.items()
             if k not in ("time_in_state_s", "last_transition_at",
                          "device_rows_per_sec", "native_rows_per_sec",
                          "probes")}
            for rec in snap["keys"]]
    quar = [{"bucket": q["bucket"], "reason": q["reason"],
             "faults": q["faults"]} for q in snap["quarantine"]]
    trans = [{k: t[k] for k in ("family", "bucket", "from", "to", "why")}
             for t in snap["transitions"]]
    return {"keys": keys, "states": snap["states"], "quarantine": quar,
            "transitions": trans, "counters": snap["counters"]}


def assert_boards_equal():
    assert board_view(port_bh.health_board()) == \
        board_view(ref_bh.health_board())


class Twin:
    """Counters of both packages around a step."""

    def __enter__(self):
        self.before = (fault_counters(REF_REGISTRY),
                       fault_counters(PORT_REGISTRY))
        return self

    def __exit__(self, *exc):
        self.ref = moved(self.before[0], fault_counters(REF_REGISTRY))
        self.port = moved(self.before[1], fault_counters(PORT_REGISTRY))


def arm(kind, site, count):
    for m in (ref_df, port_df):
        m.arm(kind, site=site, count=count)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fault_inputs")
    rng = np.random.default_rng(23)
    return _write_inputs(str(d), [_mk_run(rng, 300, 400) for _ in range(3)])


def run_job(pkg, paths, out_dir, **kw):
    os.makedirs(out_dir, exist_ok=True)
    ids = iter(range(100, 1000))
    if pkg == "ref":
        return ref_compaction.run_compaction_job_device_native(
            [RefSSTReader(p) for p in paths], out_dir, lambda: next(ids),
            CUTOFF, True, device=jax.devices("cpu")[0], **kw)
    if pkg == "port":
        return port_compaction.run_compaction_job_device_native(
            [SSTReader(p) for p in paths], out_dir, lambda: next(ids),
            CUTOFF, True, device="cpu", **kw)
    return port_compaction._run_native_job(
        [SSTReader(p) for p in paths], out_dir, lambda: next(ids), CUTOFF,
        True, False, None)


def twin_jobs(tmp_path, paths, tag, spec=None):
    """The JAX job, then the port's, each with `spec` armed; returns
    ((ref files, port files), counters moved (ref, port), armed left)."""
    files, left = {}, {}
    twin = Twin()
    with twin:
        for pkg, mod in (("ref", ref_df), ("port", port_df)):
            if spec is not None:
                mod.arm(*spec[:2], count=spec[2])
            res = run_job(pkg, paths, str(tmp_path / f"{tag}_{pkg}"))
            files[pkg] = _files(res.outputs)
            left[pkg] = mod.armed_count()
            mod.disarm_all()
    return files, (twin.ref, twin.port), left


CASES = [
    # count 1 at the download: the relaunch absorbs it, on the device
    ("oom", "result", 1, "retried"),
    # the retry fails too: contained, completed natively, quarantined
    ("oom", "result", 2, "contained"),
    ("runtime", "result", 3, "contained"),
    # a launch failure: no retry at dispatch
    ("runtime", "dispatch", 1, "contained"),
    ("compile", "dispatch", 1, "contained"),
]


@pytest.mark.parametrize("codec", ["0", "1"], ids=["shell", "codec"])
@pytest.mark.parametrize("kind,site,count,outcome", CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CASES])
def test_fault_matches_reference(tmp_path, inputs, monkeypatch, codec, kind,
                                 site, count, outcome):
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", codec)
    native = _files(run_job("native", inputs, str(tmp_path / "native"))
                    .outputs)
    files, (ref_moved, port_moved), left = twin_jobs(
        tmp_path, inputs, "faulted", (kind, site, count))
    assert files["port"] == files["ref"] == native and native
    assert left["port"] == left["ref"] == max(0, count - 2)
    assert port_moved == ref_moved
    assert_boards_equal()
    fallback = ("offload_policy", "compaction_device_fallback_total")
    state = port_bh.health_board().state("run_merge_fused", BUCKET)
    if outcome == "retried":
        assert port_moved.get(("kernels", "kernel_chunk_retry_total")) == 1
        assert fallback not in port_moved
        assert state != port_bh.QUARANTINED
        return
    assert port_moved[fallback] == 1
    assert state == port_bh.QUARANTINED
    # the parked bucket's next job launches nothing: armed faults stay;
    # the port counts the job the board sent native
    routed = port_bh.board_native_counter().value()
    files2, (ref2, port2), left2 = twin_jobs(
        tmp_path, inputs, "parked", (kind, site, 100))
    assert files2["port"] == files2["ref"] == native
    assert left2 == {"ref": 100, "port": 100}, "a parked job faulted"
    assert port2 == ref2 and fallback not in port2
    assert port_bh.board_native_counter().value() == routed + 1
    assert_boards_equal()


def test_chunked_retry_ladder_matches_reference(tmp_path, inputs,
                                                monkeypatch):
    """A chunked job (YBTPU_MERGE_CHUNK_ROWS): a chunk's download fault
    gets its own relaunch, then a re-carve from the parent (whose launch
    has its own relaunch); a fourth failure raises DeviceFaultError and
    the job completes natively — in both packages alike."""
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "0")
    monkeypatch.setenv("YBTPU_MERGE_CHUNK_ROWS", "1024")
    native = _files(run_job("native", inputs, str(tmp_path / "native"))
                    .outputs)
    for count, retries, contained in ((1, 1, False), (2, 2, False),
                                      (3, 3, False), (4, 3, True)):
        port_bh.health_board().reset()
        ref_bh.health_board().reset()
        files, (ref_moved, port_moved), _left = twin_jobs(
            tmp_path, inputs, f"chunked{count}", ("runtime", "result",
                                                   count))
        assert files["port"] == files["ref"] == native
        assert port_moved == ref_moved
        assert port_moved[("kernels", "kernel_chunk_retry_total")] == retries
        assert (("offload_policy", "compaction_device_fallback_total")
                in port_moved) == contained
        assert_boards_equal()


def test_quarantine_decays_to_probation_then_healthy(tmp_path, inputs,
                                                     monkeypatch):
    """A short quarantine window decays; the next job re-proves the
    bucket on the device (PROBATION), and probation_obs clean jobs make
    it HEALTHY — both packages alike."""
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "0")
    clock = {"t": 5000.0}
    from yugabyte_tpu.storage import offload_policy as ref_pol
    from yugabyte_tpu_torch.storage import offload_policy as port_pol
    import types
    fake = types.SimpleNamespace(monotonic=lambda: clock["t"],
                                 time=lambda: 1.7e9 + clock["t"])
    for mod in (ref_pol, port_pol):
        monkeypatch.setattr(mod, "time", fake)
    native = _files(run_job("native", inputs, str(tmp_path / "native"))
                    .outputs)
    for fl in (ref_flags, port_flags):
        fl.set_flag("device_fault_quarantine_s", 30.0)
    try:
        twin_jobs(tmp_path, inputs, "fault", ("oom", "dispatch", 1))
        states = [port_bh.health_board().state("run_merge_fused", BUCKET)]
        clock["t"] += 31.0
        for i in range(2):
            files, (rm, pm), _ = twin_jobs(tmp_path, inputs, f"re{i}")
            assert files["port"] == files["ref"] == native
            assert pm == rm
            states.append(port_bh.health_board().state("run_merge_fused",
                                                       BUCKET))
        assert states == [port_bh.QUARANTINED, port_bh.PROBATION,
                          port_bh.HEALTHY]
        assert_boards_equal()
    finally:
        for fl in (ref_flags, port_flags):
            fl.reset_flag("device_fault_quarantine_s")


def test_host_error_is_not_contained(tmp_path, inputs, monkeypatch):
    """A host-side failure of the attempt (here a failing file write)
    propagates: containment is for device faults only."""
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "0")

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(port_compaction._StreamingNativeWriter, "feed",
                        boom)
    monkeypatch.setattr(port_compaction._StreamingNativeWriter, "finish",
                        boom)
    with Twin() as twin:
        with pytest.raises(OSError, match="disk full"):
            run_job("port", inputs, str(tmp_path / "port"))
    assert not [k for k in twin.port
                if k[0] in ("bucket_health", "integrity")
                or "fallback_total" in k[1] and k[0] != "storage"
                or "quarantine" in k[1]], twin.port
    assert port_bh.health_board().state("run_merge_fused", BUCKET) != \
        port_bh.QUARANTINED
    assert not os.listdir(tmp_path / "port"), "partial outputs left"


def _sticky_errors():
    from yugabyte_tpu_torch.utils.torch_setup import CudaLaunchError
    return [torch.AcceleratorError(
                "CUDA error: an illegal memory access was encountered"),
            RuntimeError("CUDA error: unspecified launch failure"),
            CudaLaunchError("gc_pack", 700)]


@pytest.mark.parametrize("which", range(3),
                         ids=["accelerator", "runtime", "launch_700"])
def test_sticky_cuda_error_is_not_contained(tmp_path, inputs, monkeypatch,
                                            which):
    """A CUDA error that leaves the context unusable (an illegal address,
    a launch failure: what a kernel writing out of bounds gives) raises
    out of the job: no native completion, no parked bucket, no output."""
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "0")
    err = _sticky_errors()[which]

    def sticky(*a, **k):
        raise err
    from yugabyte_tpu_torch.ops import run_merge
    monkeypatch.setattr(run_merge, "gc_pack", sticky)
    with Twin() as twin:
        with pytest.raises(type(err)) as got:
            run_job("port", inputs, str(tmp_path / "port"))
    assert got.value is err
    assert not [k for k in twin.port
                if k[0] in ("bucket_health", "integrity")
                or "fallback_total" in k[1] and k[0] != "storage"
                or "quarantine" in k[1]], twin.port
    assert port_bh.health_board().state("run_merge_fused", BUCKET) != \
        port_bh.QUARANTINED
    assert not os.listdir(tmp_path / "port"), "partial outputs left"


# ------------------------------------------------------------ point reads

def test_multi_get_under_fault_matches_reference(tmp_path):
    from tests.test_torch_point_read import (_plain, _port_db, _query_keys,
                                             _ref_db)
    port = _port_db(tmp_path / "port")
    ref = _ref_db(tmp_path / "ref")
    keys = _query_keys(1200, np.random.default_rng(4))
    try:
        want = _plain(port._multi_get_native(keys,
                                             port_bh_ht_max()))
        with Twin() as twin:
            arm("oom", "result", 1)
            got = [_plain(db.multi_get(keys)) for db in (ref, port)]
        assert got[0] == got[1] == want
        assert twin.port == twin.ref
        assert twin.port[("point_read",
                          "point_read_device_fallback_total")] == 1
        assert_boards_equal()
        st = port_bh.health_board().snapshot()["states"]
        assert st["quarantined"] == 1
        # parked: the next batch is native, an armed fault stays armed
        arm("oom", "dispatch", 5)
        assert [_plain(db.multi_get(keys)) for db in (ref, port)] == \
            [want, want]
        assert [m.armed_count() for m in (ref_df, port_df)] == [5, 5]
    finally:
        port.close()
        ref.close()


def port_bh_ht_max():
    from yugabyte_tpu_torch.common.hybrid_time import HybridTime
    return HybridTime.kMax


# --------------------------------------------------------------- pushdown

@pytest.mark.parametrize("mode", ["agg", "filtered"])
def test_pushdown_fault_matches_reference(mode):
    from tests.test_torch_pushdown import (_as_host, _host_agg, _read_hts,
                                           _runs, _sources, _spec)
    from yugabyte_tpu.docdb.scan_spec import PushdownUnsupported as RefPU
    from yugabyte_tpu.ops import scan as ref_scan
    from yugabyte_tpu_torch.docdb.scan_spec import PushdownUnsupported
    from yugabyte_tpu_torch.ops import scan
    runs, ends = _runs(5)
    aggs = [("count", None), ("sum", "v")]
    preds = [("v", "<", 100)]
    ref_spec, port_spec = _spec(preds, aggs)
    ref_src, port_src = _sources(runs, sorted_source=False)
    read_ht = _read_hts(ends)[-1]

    def call(pkg):
        if mode == "agg":
            if pkg == "ref":
                return ref_scan.aggregate_sources(ref_src, read_ht, ref_spec)
            return scan.aggregate_sources(port_src, read_ht, port_spec,
                                          device="cpu")
        if pkg == "ref":
            return list(ref_scan.filtered_entries_sources(
                ref_src, read_ht, ref_spec))
        return list(scan.filtered_entries_sources(
            port_src, read_ht, port_spec, device="cpu"))

    healthy = [call("ref"), call("port")]
    assert healthy[0] == healthy[1]
    reasons = []
    with Twin() as twin:
        arm("runtime", "result", 1)
        for pkg, exc in (("ref", RefPU), ("port", PushdownUnsupported)):
            with pytest.raises(exc) as e:
                call(pkg)
            reasons.append(e.value.reason)
    assert reasons == ["fault", "fault"]
    assert twin.port == twin.ref
    assert_boards_equal()
    # the host path the caller takes answers as the device did
    if mode == "agg":
        assert _host_agg(runs, read_ht, preds, aggs) == \
            _as_host(healthy[1], aggs)
    # parked: the next call refuses before any launch
    arm("runtime", "dispatch", 3)
    for pkg, exc in (("ref", RefPU), ("port", PushdownUnsupported)):
        with pytest.raises(exc) as e:
            call(pkg)
        assert e.value.reason == "quarantined"
    assert [m.armed_count() for m in (ref_df, port_df)] == [3, 3]


# ------------------------------------------------------------------- mesh

def test_mesh_fault_completes_natively(tmp_path, low_min_rows):
    from tests.test_torch_dist_compact import (_files as dist_files, _mesh,
                                               _ycsb_tablet)
    from yugabyte_tpu.parallel.mesh import make_mesh as ref_mesh
    paths, cutoff = _ycsb_tablet(str(tmp_path / "in"), 2000, 9)
    outs = {}
    with Twin() as twin:
        arm("oom", "dispatch", 1)
        for tag in ("ref", "port", "native"):
            out_dir = tmp_path / tag
            out_dir.mkdir()
            ids = iter(range(1, 1000))
            if tag == "ref":
                res = ref_compaction.run_compaction_job(
                    [RefSSTReader(p) for p in paths], str(out_dir),
                    lambda: next(ids), cutoff, True,
                    device=jax.devices("cpu")[0], mesh=ref_mesh(8))
            elif tag == "port":
                res = port_compaction.run_compaction_job(
                    [SSTReader(p) for p in paths], str(out_dir),
                    lambda: next(ids), cutoff, True, device="cpu",
                    mesh=_mesh(8))
            else:
                res = port_compaction._run_native_job(
                    [SSTReader(p) for p in paths], str(out_dir),
                    lambda: next(ids), cutoff, True, False, None)
            outs[tag] = (res.rows_in, res.rows_out, dist_files(res.outputs))
    assert outs["port"] == outs["ref"] == outs["native"] and outs["port"][2]
    assert twin.port == twin.ref
    assert twin.port[("offload_policy",
                      "compaction_device_fallback_total")] == 1
    assert_boards_equal()
    snap = port_bh.health_board().snapshot()
    assert [k["family"] for k in snap["keys"]] == ["dist_compact"]
    assert snap["states"]["quarantined"] == 1


@pytest.fixture
def low_min_rows():
    key = "distributed_compaction_min_rows"
    old = (port_flags.get_flag(key), ref_flags.get_flag(key))
    port_flags.set_flag(key, 1000)
    ref_flags.set_flag(key, 1000)
    yield
    port_flags.set_flag(key, old[0])
    ref_flags.set_flag(key, old[1])


def test_containment_is_traced(tmp_path, inputs, monkeypatch):
    """A contained fault and a parked bucket each leave a TRACE in the
    job's trace, as the reference's do."""
    from yugabyte_tpu_torch.utils.trace import Trace
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "0")
    port_df.arm("runtime", site="dispatch", count=1)
    with Trace("contained") as t1:
        run_job("port", inputs, str(tmp_path / "contained"))
    with Trace("parked") as t2:
        run_job("port", inputs, str(tmp_path / "parked"))
    assert "quarantined; completing via the native merge" in t1.dump()
    assert "parked by the health board" in t2.dump()


# ------------------------------------------------------------ cancellation

@pytest.mark.parametrize("codec", ["0", "1"], ids=["shell", "codec"])
@pytest.mark.parametrize("when", ["before", "mid_stage_c"])
def test_cancellation_matches_reference(tmp_path, inputs, monkeypatch,
                                        codec, when):
    """tests/test_device_fault_containment.py's pipeline cancellation in
    both packages: OperationCancelled, no output left, the same counters
    moved (no fallback), equal boards with no job recorded; the port's
    cache pins drained."""
    from yugabyte_tpu.utils.cancellation import (
        CancellationToken as RefToken, OperationCancelled as RefCancelled)
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    from yugabyte_tpu_torch.utils import sync_point
    from yugabyte_tpu_torch.utils.cancellation import (CancellationToken,
                                                       OperationCancelled)
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", codec)
    key = "compaction_max_output_entries_per_sst"
    port_flags.set_flag(key, 200)
    ref_flags.set_flag(key, 200)
    tokens = {"ref": RefToken("job"), "port": CancellationToken("job")}
    if when == "before":
        for t in tokens.values():
            t.cancel("test shutdown")
    else:
        writer = (ref_compaction._DeviceCodecWriter if codec == "1"
                  else ref_compaction._StreamingNativeWriter)
        orig = writer._write_span

        def tripping(self, *a, **kw):
            orig(self, *a, **kw)
            tokens["ref"].cancel("mid-job")
        monkeypatch.setattr(writer, "_write_span", tripping)
        sync_point.arm("compaction:output_written",
                       lambda: tokens["port"].cancel("mid-job"))
    cache = DeviceSlabCache("cpu")
    try:
        with Twin() as twin:
            for pkg, exc in (("ref", RefCancelled),
                             ("port", OperationCancelled)):
                out = tmp_path / pkg
                kw = {"cancel": tokens[pkg]}
                if pkg == "port":
                    kw.update(device_cache=cache, input_ids=[0, 1, 2])
                with pytest.raises(exc):
                    run_job(pkg, inputs, str(out), **kw)
                assert os.listdir(out) == [], pkg
    finally:
        sync_point.disarm("compaction:output_written")
        port_flags.reset_flag(key)
        ref_flags.reset_flag(key)
    assert twin.port == twin.ref
    assert ("offload_policy", "compaction_device_fallback_total") \
        not in twin.port
    assert_boards_equal()
    # the codec's own launches (decode, encode) before the cancel are
    # timed under their families; the job is recorded nowhere
    assert all(k["faults"] == 0 and (
        k["family"] not in ("run_merge_fused", "dist_compact")
        or (k["device_obs"], k["native_obs"]) == (0, 0))
        for k in port_bh.health_board().snapshot()["keys"])
    assert cache.pinned_count() == 0
    assert sorted(cache._map) == ([] if when == "before" else [0, 1, 2])


def test_db_close_cancels_inflight_token_matches_reference(tmp_path):
    """DB.close trips the cancellation token, cancel_background_work trips
    it and retry_background_work re-arms it — in both packages' DBs."""
    from yugabyte_tpu.storage.db import DB as RefDB, DBOptions as RefOpts
    from yugabyte_tpu_torch.storage.db import DB, DBOptions
    seen = {}
    for pkg, db in (("ref", RefDB(str(tmp_path / "ref"),
                                  RefOpts(auto_compact=False))),
                    ("port", DB(str(tmp_path / "port"),
                                DBOptions(device="native",
                                          auto_compact=False)))):
        steps = [db._cancel.cancelled]
        db.cancel_background_work("tablet failed")
        steps.append(db._cancel.cancelled)
        steps.append(db.retry_background_work())
        steps.append(db._cancel.cancelled)
        db.close()
        steps.append(db._cancel.cancelled)
        steps.append(db.maybe_schedule_compaction())
        seen[pkg] = steps
    assert seen["port"] == seen["ref"] == [False, True, True, False, True,
                                           False]


def test_pool_wave_fault_matches_reference(tmp_path):
    """A device fault at a pool wave's dispatch, in both packages' pools
    (the port's on 8 CPU shards, the JAX one on 8 virtual CPU devices):
    the bucket is quarantined, the job completes natively with the
    native job's files, and the boards and the fault counters (the
    pool's own among them) move alike."""
    from tests.test_torch_dist_compact import _ycsb_tablet
    from yugabyte_tpu.parallel.mesh import make_mesh as ref_mesh
    from yugabyte_tpu.tserver import compaction_pool as ref_pool
    from yugabyte_tpu_torch.parallel.mesh import make_mesh
    from yugabyte_tpu_torch.tserver import compaction_pool
    paths, cutoff = _ycsb_tablet(str(tmp_path / "in"), 4000, 13)
    files = {}
    pool_moved = {}
    with Twin() as twin:
        for pkg, mod, mesh, reader, reg in (
                ("ref", ref_pool, lambda: ref_mesh(8), RefSSTReader,
                 REF_REGISTRY),
                ("port", compaction_pool,
                 lambda: make_mesh(8, devices=["cpu"] * 8), SSTReader,
                 PORT_REGISTRY)):
            ent = reg.entity("server", "compaction_pool")
            before = {k: m.value() for k, m in
                      ent.metrics_snapshot().items() if "_total" in k}
            (ref_df if pkg == "ref" else port_df).arm(
                "runtime", site="dispatch", count=1)
            pool = mod.CompactionPool(mesh())
            try:
                out = tmp_path / pkg
                out.mkdir()
                ids = iter(range(100, 1000))
                res = pool.submit("t0", mod.PoolRequest(
                    inputs=[reader(p) for p in paths], out_dir=str(out),
                    new_file_id=lambda: next(ids), history_cutoff_ht=cutoff,
                    is_major=True)).result(timeout=300)
            finally:
                pool.shutdown()
            files[pkg] = _files(res.outputs)
            pool_moved[pkg] = {k: m.value() - before.get(k, 0) for k, m in
                               ent.metrics_snapshot().items()
                               if "_total" in k}
    (tmp_path / "native").mkdir()
    nat = port_compaction._run_native_job(
        [SSTReader(p) for p in paths], str(tmp_path / "native"),
        iter(range(100, 1000)).__next__, cutoff, True, False, None)
    assert files["port"] == files["ref"] == _files(nat.outputs)
    assert twin.port == twin.ref
    assert pool_moved["port"] == pool_moved["ref"]
    assert pool_moved["port"]["compaction_pool_wave_faults_total"] == 1
    assert pool_moved["port"]["compaction_pool_native_completions_total"] \
        == 1
    assert_boards_equal()
    assert port_bh.health_board().snapshot()["states"]["quarantined"] == 1
