"""The port's DB entry points against the JAX package's DB, on the CPU.

Twins of tests/test_storage.py's compaction, checkpoint and auto-compaction
cases, test_run_cache.py's scheduled compaction, test_resident_chain.py's
DB-driven chain and resident scans, and the DB-level pushdown behind
test_scan_pushdown.py. The port's DB runs with device="cpu" (the plain
versions of its kernels) and a DeviceSlabCache on the CPU, the JAX DB on
its CPU device with its own cache, and a port DB with device="native"
(no device path) takes the same writes. After every step the live files
must be byte-identical between the port and the JAX package (base files,
learned indexes included, and data files), the data files byte-identical
to the native DB's, and every answer (get, scan_visible, scan_native,
scan_filtered, scan_aggregate, the compaction stats) equal. Beside the
twins: a scan pinned across a concurrent install, cancellation on every
compaction route (zero pins, no partial output, nothing installed, the
board untouched), the compaction rate limiter's pacing, and the mesh
through DBOptions.mesh. Writes are made from seeds; no internal key (key,
hybrid time, write id) repeats.
"""

import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_env import require_reference_native
from yugabyte_tpu.common import hybrid_time as ref_ht
from yugabyte_tpu.storage import compaction as ref_compaction
from yugabyte_tpu.storage import db as ref_db
from yugabyte_tpu.storage import device_cache as ref_dc
from yugabyte_tpu.utils import flags as ref_flags
from yugabyte_tpu.utils.cancellation import (
    CancellationToken as RefToken, OperationCancelled as RefCancelled)
from yugabyte_tpu_torch.common import hybrid_time as port_ht
from yugabyte_tpu_torch.common.hybrid_time import HybridTime
from yugabyte_tpu_torch.docdb.value import Value
from yugabyte_tpu_torch.storage import compaction, native_engine
from yugabyte_tpu_torch.storage.bucket_health import health_board
from yugabyte_tpu_torch.storage.db import DB, DBOptions
from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
from yugabyte_tpu_torch.storage.sst import SSTReader, data_file_name
from yugabyte_tpu_torch.utils import flags, lock_rank, sync_point
from yugabyte_tpu_torch.utils.cancellation import (CancellationToken,
                                                   OperationCancelled)

pytestmark = pytest.mark.skipif(not native_engine.available(),
                                reason="native engine unavailable")

# The tier-1 run shares the host's cores among its workers.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native engine loads and its process Env is
    plaintext (tests/test_torch_env.require_reference_native): the twins
    here drive its ingest_packed or native jobs."""
    require_reference_native()


@pytest.fixture(autouse=True)
def lock_order():
    """The DB's, the thread pools' and the compaction pool's locks are
    order-tracked for each test: no acquisition order closes a cycle."""
    lock_rank.enable()
    yield
    lock_rank.enable(False)
    lock_rank.assert_no_cycles()


def _key(i: int) -> bytes:
    return b"Suser%08d\x00\x00!" % i


def _ht(hyb, us: int, w: int = 0):
    return hyb.DocHybridTime(hyb.HybridTime.from_micros(us), w)


def _write_gen(db, hyb, gen: int, n: int = 300, step: int = 1,
               tomb_every: int = 0):
    """Generation gen: rows 0, step, ... < n at hybrid time 1000 * (gen +
    1) + row; every tomb_every-th row a tombstone."""
    items = []
    for r in range(0, n, step):
        v = (Value.tombstone().encode()
             if tomb_every and r % tomb_every == 0
             else b"v%d-%d" % (gen, r) + b"x" * (r % 13))
        items.append((_key(r), _ht(hyb, 1000 * (gen + 1) + r), v))
    db.write_batch(items, op_id=(1, gen + 1))


def _opts(kind, retention, **kw):
    """(DB class, options, hybrid-time module) of one of the three DBs."""
    if kind == "port":
        return DB, DBOptions(device="cpu", device_cache=DeviceSlabCache("cpu"),
                             retention_policy=retention, **kw), port_ht
    if kind == "native":
        return DB, DBOptions(device="native", retention_policy=retention,
                             **kw), port_ht
    dev = jax.devices()[0]
    return ref_db.DB, ref_db.DBOptions(
        device=dev, device_cache=ref_dc.DeviceSlabCache(device=dev),
        retention_policy=retention, **kw), ref_ht


class Trio:
    """The same writes into the port's device DB, the JAX DB and the
    port's native DB."""

    def __init__(self, tmp_path, retention=lambda: 0, kinds=("port", "ref",
                                                             "native"), **kw):
        self.dbs, self.hyb = {}, {}
        for k in kinds:
            cls, opts, hyb = _opts(k, retention, **kw)
            self.dbs[k] = cls(str(tmp_path / k), opts)
            self.hyb[k] = hyb

    def each(self, fn):
        return {k: fn(db, self.hyb[k]) for k, db in self.dbs.items()}

    def write(self, gen, flush=True, **kw):
        def go(db, hyb):
            _write_gen(db, hyb, gen, **kw)
            if flush:
                db.flush()
        self.each(go)

    def close(self):
        self.each(lambda db, _h: db.close())


def live_files(db, data_only=False):
    """(file id, base bytes, data bytes) of every live file."""
    out = []
    for fm in sorted(db.versions.live_files(), key=lambda f: f.file_id):
        with open(data_file_name(fm.path), "rb") as f:
            data = f.read()
        if data_only:
            out.append((fm.file_id, data))
            continue
        with open(fm.path, "rb") as f:
            out.append((fm.file_id, f.read(), data))
    return out


def assert_same_files(trio):
    port = trio.dbs["port"]
    if "ref" in trio.dbs:
        assert live_files(port) == live_files(trio.dbs["ref"])
    if "native" in trio.dbs:
        # the device job fits a learned index into its base files; the
        # native job cannot: the data files byte for byte
        assert live_files(port, True) == live_files(trio.dbs["native"], True)
    assert live_files(port)


def answers(db, n=400, read_us=None):
    got = []
    for r in range(n):
        if read_us is None:
            g = db.get(_key(r))
        else:
            cls = ref_ht.HybridTime if isinstance(db, ref_db.DB) \
                else port_ht.HybridTime
            g = db.get(_key(r), cls.from_micros(read_us))
        got.append(None if g is None else (g[0].ht.value, g[0].write_id,
                                           g[1]))
    return got


def assert_same_answers(trio, **kw):
    want = answers(trio.dbs["port"], **kw)
    for k, db in trio.dbs.items():
        assert answers(db, **kw) == want, k


def stats(db):
    return db.compaction_stats.to_dict()


# ------------------------------------------------ scheduled compaction
@pytest.fixture
def run_cache_off():
    for f in (flags, ref_flags):
        f.set_flag("compaction_run_cache_mb", 0)
    yield
    for f in (flags, ref_flags):
        f.reset_flag("compaction_run_cache_mb")


@pytest.mark.parametrize("route", ["run_cached", "codec"])
def test_auto_compaction_matches_reference(tmp_path, route, request):
    """auto_compact=True (test_storage.py's trigger case): the universal
    pick fires on the 4th flush in all three DBs, installs its outputs
    (the inputs' files deleted, their cache entries dropped, the outputs
    resident one level up) and the 5th flush does not pick again. With
    every flush run-cached the job takes the shell route, without the run
    cache the codec route."""
    if route == "codec":
        request.getfixturevalue("run_cache_off")
    trio = Trio(tmp_path, retention=lambda: HybridTime.kMax.value,
                block_entries=128)
    port = trio.dbs["port"]
    for gen in range(5):
        trio.write(gen, n=240, step=1 + gen % 2, tomb_every=23)
        if gen == 2:
            in_ids = sorted(port.versions.files)
            assert all(port._device_cache.contains(f) for f in in_ids)
        assert_same_files(trio)
    assert [stats(db)["compactions"] for db in trio.dbs.values()] == [1] * 3
    assert stats(port) == stats(trio.dbs["ref"])
    # inputs gone from disk and cache, the output resident at L1 (the new
    # L0 flush at L0)
    for f in in_ids:
        assert not os.path.exists(os.path.join(port.db_dir, f"{f:06d}.sst"))
        assert not port._device_cache.contains(f)
    assert [port._device_cache.level_of(f) for f in
            sorted(port.versions.files)] == [1, 0]
    assert port._device_cache.pinned_count() == 0
    if route == "run_cached":
        assert all(port._run_cache.contains(f) for f in port.versions.files)
    assert_same_answers(trio)
    trio.close()


COMPACT_ALL = {
    # test_storage.py:220-262: name -> (retention, generations)
    "merges_files": (lambda: HybridTime.from_micros(10**9).value, 4),
    "tombstones_gone_after_major": (lambda: HybridTime.kMax.value, 2),
    "history_retention": (lambda: HybridTime.from_micros(1500).value, 2),
}


@pytest.mark.parametrize("case", sorted(COMPACT_ALL))
def test_compact_all_matches_reference(tmp_path, case):
    retention, gens = COMPACT_ALL[case]
    trio = Trio(tmp_path, retention=retention, auto_compact=False)
    for gen in range(gens):
        trio.write(gen, n=120, tomb_every=(2 if case.startswith("tomb")
                                           and gen == gens - 1 else 0))
    trio.each(lambda db, _h: db.compact_all())
    assert [db.n_live_files for db in trio.dbs.values()] == [1] * 3
    assert_same_files(trio)
    assert stats(trio.dbs["port"]) == stats(trio.dbs["ref"])
    assert_same_answers(trio)
    assert_same_answers(trio, read_us=1200)
    n_iter = trio.each(lambda db, _h: sum(1 for _ in db.iter_from()))
    assert len(set(n_iter.values())) == 1
    want = {"merges_files": 120, "tombstones_gone_after_major": 60,
            "history_retention": 240}[case]
    assert n_iter["port"] == want
    trio.close()


def test_checkpoint_reopens_as_the_original(tmp_path):
    """test_storage.py's checkpoint case: the port's checkpoint opened by
    the port (native and device) and by the JAX package answers as the
    original."""
    db = DB(str(tmp_path / "db"), DBOptions(device="cpu", auto_compact=False,
                                            device_cache=DeviceSlabCache("cpu")))
    for gen in range(2):
        _write_gen(db, port_ht, gen, n=100, step=gen + 1)
        db.flush()
    _write_gen(db, port_ht, 2, n=10)      # a memtable write is not in it
    want = answers(db, n=100)
    ckpt = str(tmp_path / "ckpt")
    db.checkpoint(ckpt)
    db.flush()
    db.close()
    opened = [DB(ckpt, DBOptions(device="native", auto_compact=False)),
              DB(ckpt, DBOptions(device="cpu", auto_compact=False)),
              ref_db.DB(ckpt, ref_db.DBOptions(auto_compact=False))]
    got = [answers(o, n=100) for o in opened]
    for o in opened:
        o.close()
    assert got[1] == got[2] == got[0]
    assert got[0] != want and sum(g is not None for g in got[0]) == 100
    assert got[0][10:] == want[10:]


def test_maybe_schedule_compaction_takes_the_run_cache(tmp_path):
    """test_run_cache.py:237: flushes write through to the run cache; the
    scheduled compaction over them takes the all-cached path and
    re-exports its outputs; the JAX DB writes the same files."""
    trio = Trio(tmp_path, kinds=("port", "ref"), auto_compact=False)
    port = trio.dbs["port"]
    for batch in range(4):
        def go(db, hyb, batch=batch):
            items = [(b"k%04d" % ((batch * 150 + i) % 400),
                      hyb.DocHybridTime(hyb.HybridTime(
                          (1000 + batch * 200 + i) << 12), 0),
                      b"v%d-%d" % (batch, i)) for i in range(200)]
            db.write_batch(items)
            return db.flush()
        fids = trio.each(go)
        assert port._run_cache.contains(fids["port"])
    hits0 = port._run_cache.hits
    assert trio.each(lambda db, _h: db.maybe_schedule_compaction()) == \
        {"port": True, "ref": True}
    assert port._run_cache.hits >= hits0 + 4
    assert all(port._run_cache.contains(f) for f in port.versions.files)
    assert not port.maybe_schedule_compaction()     # nothing is due
    assert_same_files(trio)
    trio.close()


# ------------------------------------------------------------ the scans
def scan_native_visible(db, read_ht, lower=b"", upper=None):
    out = []
    for b in db.scan_native(lower, upper, read_ht, visible=True).batches():
        keys, vals = b.keys, b.vals
        for i in range(b.n):
            out.append((keys[b.key_offs[i]:b.key_offs[i + 1]].tobytes(),
                        vals[b.val_offs[i]:b.val_offs[i + 1]].tobytes()))
    return out


def test_db_driven_chain_and_resident_scans(tmp_path):
    """test_resident_chain.py:459 and :538-554 through the DB: every
    flush resident, compact_all drops the inputs' entries and installs
    the output at L1 (close frees the namespace); scan_visible full and
    narrow equal the JAX DB's, the native DB's scan_visible and
    scan_native(visible=True) (the memtable overlay included), and a
    narrow scan over a resident file decodes at most 2 of its blocks."""
    from yugabyte_tpu_torch.storage import sst as port_sst
    trio = Trio(tmp_path, retention=lambda: HybridTime.kMax.value,
                block_entries=64, auto_compact=False)
    port = trio.dbs["port"]
    for gen in range(4):
        trio.write(gen, n=512, step=1 + gen % 3, tomb_every=31)
    in_ids = sorted(port.versions.files)
    assert all(port._device_cache.contains(f) for f in in_ids)
    trio.each(lambda db, _h: db.compact_all())
    assert_same_files(trio)
    assert not any(port._device_cache.contains(f) for f in in_ids)
    (out_id,) = port.versions.files
    assert port._device_cache.level_of(out_id) == 1
    trio.write(4, flush=False, n=200, step=7)         # memtable overlay
    # read times above the compaction's cutoff (kMax: older versions
    # are gone) and inside the last generations' writes
    for read_us, lo, hi in ((10**9, None, None), (10**9, 100, 120),
                            (4100, 37, 300), (5100, 0, 512)):
        lower = _key(lo) if lo is not None else None
        upper = _key(hi) if hi is not None else None
        got = trio.each(lambda db, hyb: list(db.scan_visible(
            hyb.HybridTime.from_micros(read_us).value, lower, upper)))
        assert got["port"] == got["ref"] == got["native"] and got["port"]
        nat = scan_native_visible(
            trio.dbs["native"], HybridTime.from_micros(read_us).value,
            lower or b"", upper)
        assert [(k, v) for k, v, _h in got["port"]] == nat
    # the narrow scan over the resident output reads only survivor blocks
    trio.each(lambda db, _h: db.flush())
    b0 = port_sst.blocks_decoded()
    narrow = list(port.scan_visible(HybridTime.kMax.value - 1, _key(100),
                                    _key(120)))
    assert narrow and 0 < port_sst.blocks_decoded() - b0 <= 4
    ns = os.path.abspath(port.db_dir)
    shared = port.opts.device_cache
    port.close()
    assert not any(k[0] == ns for k in shared._map)
    trio.dbs.pop("port")
    trio.close()


def test_scan_pinned_across_a_concurrent_install(tmp_path):
    """A scan generator holds its pins while a compaction installs (the
    db.compaction:before_install sync point drains half of it there): the
    inputs' delete is deferred until the generator ends, its entries are
    those of the pre-install state, and a resident scan reads the entry
    the install dropped. The JAX DB under the same interleaving yields
    the same entries and ends with the same files."""
    from yugabyte_tpu.utils import sync_point as ref_sp
    trio = Trio(tmp_path, kinds=("port", "ref"),
                retention=lambda: HybridTime.kMax.value, block_entries=64,
                auto_compact=False)
    for gen in range(3):
        trio.write(gen, n=300, step=1 + gen)
    got = {}
    for k, db in trio.dbs.items():
        hyb, sp = trio.hyb[k], (sync_point if k == "port" else ref_sp)
        before = list(db.scan_visible(hyb.HybridTime.kMax.value - 1))
        it = db.scan_visible(hyb.HybridTime.kMax.value - 1)
        head = [next(it)]
        in_paths = [fm.path for fm in db.versions.live_files()]
        seen = {}

        def mid_install(db=db, it=it, head=head, seen=seen):
            head.extend(next(it) for _ in range(100))
            seen["pins"] = dict(db._pins)
        sp.arm("db.compaction:before_install", mid_install)
        try:
            db.compact_all()
        finally:
            sp.disarm("db.compaction:before_install")
        assert seen["pins"] and db.n_live_files == 1
        assert all(os.path.exists(p) for p in in_paths)   # deferred
        assert len(db._obsolete) == 3
        rest = list(it)
        assert head + rest == before
        assert not db._obsolete and not db._pins
        assert not any(os.path.exists(p) for p in in_paths)
        got[k] = head + rest
    assert got["port"] == got["ref"]
    assert_same_files(trio)
    trio.close()


def _lineitem_dbs(tmp_path, sf_orders=4000):
    """chip_smoke's lineitem tablet (4 SSTs) opened as a port DB and a JAX
    DB, each over hard links of the same files."""
    import chip_smoke as cs
    from yugabyte_tpu_torch.storage.version_set import VersionSet
    rows = cs.lineitem_rows(sf_orders, 7)
    runs, top_ht, mid_ht = cs.lineitem_runs(rows, cs.lineitem_ops(rows, 7), 7)
    src = tmp_path / "src"
    src.mkdir()
    cs.write_inputs(runs, str(src))
    out = {}
    for k in ("port", "ref"):
        d = tmp_path / k
        d.mkdir()
        vs = VersionSet(str(d))
        for name in sorted(os.listdir(src)):
            if not name.endswith(".sst"):
                continue
            fid = vs.new_file_id()
            path = str(d / f"{fid:06d}.sst")
            os.link(src / name, path)
            os.link(data_file_name(str(src / name)), data_file_name(path))
            r = SSTReader(path)
            vs.add_file(fid, path, r.props)
            r.close()
        cls, opts, _hyb = _opts(k, lambda: 0, auto_compact=False)
        out[k] = cls(str(d), opts)
    return out, top_ht, mid_ht


@pytest.mark.parametrize("name", ["q1_agg", "q6_agg", "q6_agg@mid",
                                  "filter_rows"])
def test_pushdown_matches_reference(tmp_path, name):
    """scan_aggregate / scan_filtered on the lineitem DB: the port's DB ==
    the JAX DB == chip_smoke's host oracle, a second (resident) call ==
    the first, no pin left; a native DB refuses the pushdown."""
    import chip_smoke as cs
    from tests.test_torch_lineitem import REF_SCHEMA
    from yugabyte_tpu.docdb import scan_spec as ref_ss
    from yugabyte_tpu_torch.docdb.scan_spec import PushdownUnsupported
    dbs, top_ht, mid_ht = _lineitem_dbs(tmp_path)
    schema = cs.lineitem_schema()
    mode, spec = cs.pushdown_queries(schema)[name.split("@")[0]]
    ref_spec = ref_ss.ScanSpec(
        tuple(ref_ss.compile_predicate(REF_SCHEMA, p.col, p.op, p.value)
              for p in spec.predicates),
        tuple(ref_ss.compile_aggregate(REF_SCHEMA, a.fn, a.col)
              for a in spec.aggregates))
    read_ht = mid_ht if name.endswith("@mid") else top_ht
    slabs = [r.read_all() for r in dbs["port"]._readers.values()]
    oracle = cs.LineitemOracle(slabs, read_ht)
    for _call in range(2):
        if mode == "aggregate":
            got = dbs["port"].scan_aggregate(read_ht, spec)
            assert got == dbs["ref"].scan_aggregate(read_ht, ref_spec)
            assert got == oracle.aggregate(spec, schema) and got["rows"]
        else:
            got = list(dbs["port"].scan_filtered(read_ht, spec))
            assert got == list(dbs["ref"].scan_filtered(read_ht, ref_spec))
            assert got == oracle.entries(spec) and got
        assert not dbs["port"]._pins
    assert all(dbs["port"]._device_cache.get(f).vals_dev is not None
               for f in dbs["port"]._readers)
    for db in dbs.values():
        db.close()
    nat = DB(str(tmp_path / "port"), DBOptions(device="native",
                                               auto_compact=False))
    with pytest.raises(PushdownUnsupported):
        nat.scan_aggregate(read_ht, spec)
    assert not nat._pins
    nat.close()


# ------------------------------------------------------- cancellation
ROUTES = ["router_python", "native", "shell", "codec", "resident_codec",
          "resident_shell", "chunked", "dist", "with_decisions"]


def _route_inputs(tmp_path):
    from tests.test_torch_resident_chain import mk_runs, write_runs
    return write_runs(str(tmp_path / "in"), mk_runs(11, 3, 600, 700))


def _run_route(route, paths, out_dir, cancel, monkeypatch, cache=None):
    """One compaction through `route`, with cancel; returns the result."""
    from yugabyte_tpu_torch.ops.slabs import concat_slabs
    from yugabyte_tpu_torch.parallel.mesh import make_mesh
    from yugabyte_tpu_torch.storage.cpu_baseline import compact_cpu_baseline
    readers = [SSTReader(p) for p in paths]
    ids = iter(range(100, 1000))
    new_id = lambda: next(ids)   # noqa: E731
    cutoff = 10_000_000 << 12
    monkeypatch.setenv("YBTPU_DEVICE_CODEC",
                       "0" if route.endswith("shell") else "1")
    if route == "chunked":
        monkeypatch.setenv("YBTPU_MERGE_CHUNK_ROWS", "1024")
    kw = {}
    if route.startswith("resident"):
        kw = {"device_cache": cache, "input_ids": [0, 1, 2]}
    if route == "router_python":
        return compaction.run_compaction_job(
            readers, out_dir, new_id, cutoff, True, device="cpu",
            _no_combined=True, cancel=cancel)
    if route == "native":
        return compaction.run_compaction_job(
            readers, out_dir, new_id, cutoff, True, device="native",
            cancel=cancel)
    if route == "dist":
        return compaction.run_compaction_job_dist_native(
            readers, out_dir, new_id, cutoff, True,
            mesh=make_mesh(2, devices=["cpu"] * 2), cancel=cancel)
    if route == "with_decisions":
        slabs = [r.read_all() for r in readers]
        merged = concat_slabs(slabs)
        offs = np.concatenate(([0], np.cumsum([s.n for s in slabs])))
        perm, keep, mk = compact_cpu_baseline(merged, offs.tolist(), cutoff,
                                              True, False)
        return compaction.run_compaction_job_with_decisions(
            readers, slabs, out_dir, new_id, cutoff, True, False, None,
            perm[keep], mk[keep], merged.n, cancel=cancel)
    return compaction.run_compaction_job(
        readers, out_dir, new_id, cutoff, True, device="cpu", cancel=cancel,
        **kw)


@pytest.fixture
def small_outputs():
    flags.set_flag("compaction_max_output_entries_per_sst", 300)
    yield
    flags.reset_flag("compaction_max_output_entries_per_sst")


@pytest.mark.parametrize("route", ROUTES)
def test_cancellation_on_every_route(tmp_path, route, monkeypatch,
                                     small_outputs):
    """A token tripped after the first output file (the
    compaction:output_written sync point) aborts the job at its next
    stage boundary: OperationCancelled, no output file left, no cache
    entry installed, zero pins, the input entries still resident, and the
    health board records nothing. The uncancelled job over the same
    inputs writes several files, equal to the native job's."""
    paths = _route_inputs(tmp_path)
    cache = DeviceSlabCache("cpu")
    for fid, p in enumerate(paths):
        cache.stage(fid, SSTReader(p).read_all())
    board = health_board()
    board.reset()
    token = CancellationToken("test job")
    sync_point.arm("compaction:output_written",
                   lambda: token.cancel("mid-job"))
    out = tmp_path / "out"
    out.mkdir()
    try:
        with pytest.raises(OperationCancelled):
            _run_route(route, paths, str(out), token, monkeypatch, cache)
    finally:
        sync_point.disarm("compaction:output_written")
    assert os.listdir(out) == []
    assert cache.pinned_count() == 0
    assert sorted(k for k in cache._map) == [0, 1, 2]
    # no fault anywhere, no job recorded (the codec's decode launches
    # before the cancel are timed under their own family)
    assert [r for r in board.snapshot()["keys"] if r["faults"] or (
        r["family"] in ("run_merge_fused", "dist_compact")
        and (r["device_obs"] or r["native_obs"]))] == []
    ok = tmp_path / "ok"
    ok.mkdir()
    res = _run_route(route, paths, str(ok), CancellationToken(), monkeypatch,
                     cache)
    (tmp_path / "nat").mkdir()
    nat = compaction._run_native_job(
        [SSTReader(p) for p in paths], str(tmp_path / "nat"),
        iter(range(100, 1000)).__next__, 10_000_000 << 12, True, False, None)
    assert len(res.outputs) > 1
    data = [open(data_file_name(p), "rb").read() for _f, p, _r in res.outputs]
    assert data == [open(data_file_name(p), "rb").read()
                    for _f, p, _r in nat.outputs]


@pytest.mark.parametrize("route", ["native", "device_native", "dist",
                                   "with_decisions"])
def test_cancelled_before_start_matches_reference(tmp_path, route):
    """A token cancelled before the job starts: both packages raise at the
    first boundary and write nothing."""
    from yugabyte_tpu.parallel.mesh import make_mesh as ref_mesh
    from yugabyte_tpu.storage.sst import SSTReader as RefReader
    from yugabyte_tpu_torch.parallel.mesh import make_mesh
    paths = _route_inputs(tmp_path)
    for pkg, mod, reader, tok, exc, dev, mesh in (
            ("port", compaction, SSTReader, CancellationToken,
             OperationCancelled, "cpu",
             lambda: make_mesh(2, devices=["cpu"] * 2)),
            ("ref", ref_compaction, RefReader, RefToken, RefCancelled,
             jax.devices()[0], lambda: ref_mesh(2))):
        token = tok("job")
        token.cancel("before start")
        out = tmp_path / pkg
        out.mkdir()
        readers = [reader(p) for p in paths]
        args = (readers, str(out), iter(range(100, 200)).__next__,
                10_000_000 << 12, True)
        with pytest.raises(exc):
            if route == "native":
                mod.run_compaction_job(*args, device="native", cancel=token)
            elif route == "device_native":
                mod.run_compaction_job_device_native(*args, device=dev,
                                                     cancel=token)
            elif route == "dist":
                mod.run_compaction_job_dist_native(*args, mesh=mesh(),
                                                   cancel=token)
            else:
                slabs = [r.read_all() for r in readers]
                n = sum(s.n for s in slabs)
                mod.run_compaction_job_with_decisions(
                    readers, slabs, *args[1:], False, None,
                    np.arange(n), np.zeros(n, bool), n, cancel=token)
        assert os.listdir(out) == []


def test_close_cancels_an_inflight_compaction(tmp_path):
    """close() while a DB-scheduled compaction runs on the compaction
    pool (held at its first output file by the sync point): the job
    unwinds, nothing is installed (the reopened DB has the inputs), no
    output file is left, zero pins; cancel_background_work on a second DB
    leaves it readable and healthy, and retry_background_work re-arms the
    token so the next compaction runs."""
    from yugabyte_tpu_torch.utils.threadpool import PriorityThreadPool
    flags.set_flag("compaction_max_output_entries_per_sst", 150)
    pool = PriorityThreadPool(1, name="test-compaction")
    shared = DeviceSlabCache("cpu")
    held, go = threading.Event(), threading.Event()

    def hold():
        held.set()
        assert go.wait(30)
    try:
        for what in ("close", "cancel"):
            db = DB(str(tmp_path / what), DBOptions(
                device="cpu", device_cache=shared, compaction_pool=pool,
                retention_policy=lambda: HybridTime.kMax.value))
            for gen in range(3):
                _write_gen(db, port_ht, gen, n=400)
                db.flush()
            in_ids = sorted(db.versions.files)
            want = answers(db)
            held.clear()
            go.clear()
            sync_point.arm("compaction:output_written", hold)
            _write_gen(db, port_ht, 3, n=400)
            db.flush()                       # the 4th flush picks
            assert held.wait(30)
            sync_point.disarm("compaction:output_written")
            if what == "close":
                db.close()
            else:
                db.cancel_background_work("tablet failed")
            go.set()
            pool.wait_idle()
            assert shared.pinned_count() == 0
            names = sorted(n for n in os.listdir(db.db_dir)
                           if n.endswith(".sst"))
            assert names == [f"{f:06d}.sst" for f in in_ids + [4]]
            if what == "close":
                reopened = DB(db.db_dir, DBOptions(device="native",
                                                   auto_compact=False))
                assert sorted(reopened.versions.files) == in_ids + [4]
                reopened.close()
                continue
            assert db.background_error is None
            assert sorted(db.versions.files) == in_ids + [4]
            assert answers(db) != want and answers(db)[1][2] == b"v3-1x"
            assert db.retry_background_work() and not db._cancel.cancelled
            assert db.maybe_schedule_compaction()
            pool.wait_idle()
            assert db.n_live_files < 4 and db.background_error is None
            db.close()
    finally:
        sync_point.disarm("compaction:output_written")
        go.set()
        pool.shutdown()
        flags.reset_flag("compaction_max_output_entries_per_sst")


def test_cancelled_compaction_spares_a_concurrent_ingest(tmp_path,
                                                        monkeypatch):
    """A pooled compaction (held at its first output file) is cancelled
    while ingest_packed has written its file but not yet installed it:
    the cancelled job's orphan sweep runs in that window and must spare
    the file, which the ingest then installs and reads back."""
    from yugabyte_tpu_torch.storage import sst as port_sst
    from yugabyte_tpu_torch.utils.threadpool import PriorityThreadPool
    flags.set_flag("compaction_max_output_entries_per_sst", 150)
    pool = PriorityThreadPool(1, name="test-compaction")
    held, go = threading.Event(), threading.Event()

    def hold():
        held.set()
        assert go.wait(30)
    db = DB(str(tmp_path / "db"), DBOptions(
        device="cpu", device_cache=DeviceSlabCache("cpu"),
        compaction_pool=pool,
        retention_policy=lambda: HybridTime.kMax.value))
    real_write = port_sst.write_sst_from_packed

    def write_then_sweep(*a, **kw):
        props = real_write(*a, **kw)
        db.cancel_background_work("tablet failed")
        go.set()
        pool.wait_idle()          # the aborted job has swept
        return props
    try:
        for gen in range(3):
            _write_gen(db, port_ht, gen, n=400)
            db.flush()
        sync_point.arm("compaction:output_written", hold)
        _write_gen(db, port_ht, 3, n=400)
        db.flush()                           # the 4th flush picks
        assert held.wait(30)
        sync_point.disarm("compaction:output_written")
        monkeypatch.setattr(port_sst, "write_sst_from_packed",
                            write_then_sweep)
        keys = [_key(1000 + i) for i in range(50)]
        vals = [b"ingested-%d" % i for i in range(50)]
        run = (b"".join(keys),
               np.concatenate(([0], np.cumsum([len(k) for k in keys]))),
               (np.uint64(900_000) + np.arange(50, dtype=np.uint64))
               << np.uint64(12),
               np.zeros(50, np.uint32), b"".join(vals),
               np.concatenate(([0], np.cumsum([len(v) for v in vals]))))
        fid = db.ingest_packed(*run, op_id=(2, 1))
        pool.wait_idle()
        assert fid in db.versions.files
        assert os.path.exists(db.versions.files[fid].path)
        assert db.get(keys[7])[1] == vals[7]
        assert db.background_error is None
    finally:
        sync_point.disarm("compaction:output_written")
        go.set()
        db.close()
        pool.shutdown()
        flags.reset_flag("compaction_max_output_entries_per_sst")


def test_cancel_then_retry_before_install_installs_nothing(tmp_path):
    """A job that ends as the DB is cancelled and at once re-armed
    (cancel_background_work, then retry_background_work, at the
    db.compaction:before_install sync point) still holds its own tripped
    token: nothing is installed, no output file is left, and the next
    pick, under the fresh token, compacts."""
    cache = DeviceSlabCache("cpu")
    db = DB(str(tmp_path / "db"), DBOptions(
        device="cpu", device_cache=cache, auto_compact=False,
        retention_policy=lambda: HybridTime.kMax.value))
    fired = []

    def cancel_and_rearm():
        if not fired:
            fired.append(1)
            db.cancel_background_work("tablet failed")
            assert db.retry_background_work()
    try:
        for gen in range(4):
            _write_gen(db, port_ht, gen, n=400)
            db.flush()
        in_ids = sorted(db.versions.files)
        want = answers(db)
        sync_point.arm("db.compaction:before_install", cancel_and_rearm)
        assert db.maybe_schedule_compaction()
        assert fired
        assert sorted(db.versions.files) == in_ids
        assert sorted(n for n in os.listdir(db.db_dir)
                      if n.endswith(".sst")) == [f"{f:06d}.sst"
                                                 for f in in_ids]
        assert sorted(f for _dir, f in cache._map) == in_ids
        assert cache.pinned_count() == 0
        assert db.background_error is None and not db._cancel.cancelled
        assert answers(db) == want
        assert db.maybe_schedule_compaction()
        assert db.n_live_files < len(in_ids) and answers(db) == want
    finally:
        sync_point.disarm("db.compaction:before_install")
        db.close()


def test_scrub_cancel(tmp_path):
    db = DB(str(tmp_path / "db"), DBOptions(device="native",
                                            auto_compact=False))
    for gen in range(2):
        _write_gen(db, port_ht, gen, n=100)
        db.flush()
    assert db.scrub(cancel=CancellationToken())["files"] == 2
    token = CancellationToken()
    token.cancel("shutdown")
    with pytest.raises(OperationCancelled):
        db.scrub(cancel=token)
    assert not db._pins
    db.close()


# ------------------------------------------------------------- pacing
@pytest.mark.parametrize("route", ["native", "shell", "codec",
                                   "router_python", "with_decisions"])
def test_rate_limiter_paces_like_the_reference(tmp_path, route,
                                               monkeypatch, small_outputs):
    """compaction_rate_bytes_per_sec paces each writer between output
    files and never after the last: the bytes through the port's limiter
    are those of every output but the last, what the JAX package's
    limiter takes for its native job over the same inputs, and the job
    takes at least (those bytes - the burst) / rate."""
    paths = _route_inputs(tmp_path)
    rate = 200_000
    flags.set_flag("compaction_rate_bytes_per_sec", rate)
    ref_flags.set_flag("compaction_rate_bytes_per_sec", rate)
    ref_flags.set_flag("compaction_max_output_entries_per_sst", 300)
    try:
        lim = compaction.compaction_rate_limiter()
        assert lim is compaction.compaction_rate_limiter()
        t0 = time.monotonic()
        through0 = lim.total_through
        res = _run_route(route, paths, str(tmp_path), CancellationToken(),
                         monkeypatch)
        secs = time.monotonic() - t0
        paced = lim.total_through - through0
        (tmp_path / "ref").mkdir()
        rlim = ref_compaction.compaction_rate_limiter()
        r0 = rlim.total_through
        from yugabyte_tpu.storage.sst import SSTReader as RefReader
        ref_compaction.run_compaction_job(
            [RefReader(p) for p in paths], str(tmp_path / "ref"),
            iter(range(100, 1000)).__next__, 10_000_000 << 12, True,
            device="native")
        assert paced == rlim.total_through - r0
    finally:
        flags.reset_flag("compaction_rate_bytes_per_sec")
        ref_flags.reset_flag("compaction_rate_bytes_per_sec")
        ref_flags.reset_flag("compaction_max_output_entries_per_sst")
    assert len(res.outputs) > 2
    assert paced == sum(p.data_size + p.base_size
                        for _f, _b, p in res.outputs[:-1])
    assert secs >= (paced - lim.capacity) / rate
    assert compaction.compaction_rate_limiter() is None


# --------------------------------------------------------------- mesh
def test_db_mesh_compaction_matches_native(tmp_path):
    """DBOptions.mesh: a mesh-sized scheduled compaction (min rows
    lowered) runs the dist-native job on a 2-shard CPU mesh and writes
    the native DB's data files."""
    from yugabyte_tpu_torch.parallel.mesh import make_mesh
    flags.set_flag("distributed_compaction_min_rows", 500)
    try:
        trio = Trio(tmp_path, kinds=("port", "native"),
                    retention=lambda: HybridTime.kMax.value,
                    mesh=make_mesh(2, devices=["cpu"] * 2))
        for gen in range(4):
            trio.write(gen, n=300, step=1 + gen % 2)
        assert stats(trio.dbs["port"])["compactions"] == 1
        assert_same_files(trio)
        assert_same_answers(trio)
        trio.close()
    finally:
        flags.reset_flag("distributed_compaction_min_rows")
