"""The port's data integrity against the JAX package's.

  - At rest: `verify_sst` gives the same report on a clean file, a data
    block bit flip and a base-file bit flip; `DB.scrub` gives the same
    report, quarantines the file (`*.corrupt`) and parks the DB with the
    same sticky Corruption; a `get` over corrupt bytes is routed to the
    background-error slot and re-raised retryably in both; a failed flush
    parks the DB read-only until `retry_background_work`.
  - Online: the sampled shadow verifier catches an armed `bitflip` before
    install in both packages (ShadowMismatch contained, the bucket
    sticky-quarantined, the files those of the native job, equal
    counters and boards); `clear_mismatch` re-opens the bucket on
    probation; a clean verified job counts its rows; without the verifier
    the flipped decision lands silently, alike in both.

The twin of ScrubTabletsOp's interval gating is in
tests/test_torch_maintenance_manager.py. The JAX package's cases that
need a mini-cluster (the cross-replica digest exchange and the rebuild
loop) and its tools (`sst_dump --verify`, `ldb verify`) wait for ROADMAP
queue A item 7g.
"""

import os

import pytest
import torch

from tests.test_torch_fault_containment import (BUCKET, Twin,
                                                assert_boards_equal,
                                                run_job)
from tests.test_torch_fault_containment import inputs  # noqa: F401
from yugabyte_tpu.common.hybrid_time import DocHybridTime as RefDHT
from yugabyte_tpu.common.hybrid_time import HybridTime as RefHT
from yugabyte_tpu.docdb.doc_key import DocKey, SubDocKey
from yugabyte_tpu.docdb.value import Value
from yugabyte_tpu.ops import device_faults as ref_df
from yugabyte_tpu.storage import bucket_health as ref_bh
from yugabyte_tpu.storage import db as ref_db
from yugabyte_tpu.storage import integrity as ref_integrity
from yugabyte_tpu.utils import flags as ref_flags
from yugabyte_tpu.utils.status import Code as RefCode
from yugabyte_tpu.utils.status import StatusError as RefStatusError
from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime, HybridTime
from yugabyte_tpu_torch.ops import device_faults as port_df
from yugabyte_tpu_torch.storage import bucket_health as port_bh
from yugabyte_tpu_torch.storage import db as port_db
from yugabyte_tpu_torch.storage import integrity
from yugabyte_tpu_torch.utils import flags as port_flags
from yugabyte_tpu_torch.utils.rate_limiter import RateLimiter
from yugabyte_tpu_torch.utils.status import Code, StatusError

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean():
    samples = {k: (port_flags.get_flag(k), ref_flags.get_flag(k))
               for k in ("shadow_verify_sample", "resident_digest_sample",
                         "device_fault_quarantine_s")}
    for k in ("shadow_verify_sample", "resident_digest_sample"):
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


def _key(i):
    return SubDocKey(DocKey(range_components=(f"r{i:04d}",)),
                     (("col", 0),)).encode(include_ht=False)


def _dbs(tmp_path, n=80):
    """A JAX DB and a port DB holding the same flushed rows; their SST
    bytes are equal."""
    vals = [Value(primitive=f"v{i}").encode() for i in range(n)]
    ref = ref_db.DB(str(tmp_path / "ref"), ref_db.DBOptions(
        auto_compact=False))
    ref.write_batch([(_key(i), RefDHT(RefHT((i + 1) << 12), 0), vals[i])
                     for i in range(n)])
    ref.flush()
    port = port_db.DB(str(tmp_path / "port"), port_db.DBOptions(
        device="native", auto_compact=False))
    port.write_batch([(_key(i), DocHybridTime(HybridTime((i + 1) << 12), 0),
                       vals[i]) for i in range(n)])
    port.flush()
    bases = [next(iter(db._readers.values())).base_path
             for db in (ref, port)]
    for suffix in ("", ".sblock.0"):
        a, b = (open(p + suffix, "rb").read() for p in bases)
        assert a == b
    return ref, port, bases


def _flip(path, offset, mask=0x5A):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ mask]))


def _report(rep, base):
    return (rep.n_blocks, rep.n_entries, rep.bytes_verified,
            [e.replace(base, "<sst>") for e in rep.errors])


@pytest.mark.parametrize("where", ["clean", "data_block", "base_file"])
def test_verify_sst_matches_reference(tmp_path, where):
    ref, port, bases = _dbs(tmp_path)
    try:
        for base in bases:
            if where == "data_block":
                _flip(base + ".sblock.0", 40)
            elif where == "base_file":
                _flip(base, 6)
        reps = [ref_integrity.verify_sst(bases[0]),
                integrity.verify_sst(bases[1])]
        assert _report(reps[0], bases[0]) == _report(reps[1], bases[1])
        assert reps[1].ok == (where == "clean")
        if where == "clean":
            assert reps[1].n_entries == 80 and reps[1].bytes_verified > 0
        else:
            key = "base" if where == "base_file" else "block"
            assert any(key in e for e in reps[1].errors), reps[1].errors
    finally:
        ref.close()
        port.close()


def test_scrub_matches_reference(tmp_path):
    ref, port, bases = _dbs(tmp_path)
    try:
        clean = [db.scrub() for db in (ref, port)]
        assert clean[0] == clean[1] and clean[1]["files"] == 1
        assert clean[1]["entries"] == 80 and not clean[1]["corrupt"]
        limiter = RateLimiter(1 << 30)
        port.scrub(limiter=limiter)
        assert limiter.total_through > 0
        for base in bases:
            _flip(base + ".sblock.0", 40)
        with Twin() as twin:
            reps = [db.scrub() for db in (ref, port)]
        for rep, base in zip(reps, bases):
            for c in rep["corrupt"]:
                assert c["path"] == base
                c["path"] = "<sst>"
                c["errors"] = [e.replace(base, "<sst>")
                               for e in c["errors"]]
        assert reps[0] == reps[1] and reps[1]["corrupt"]
        assert twin.port == twin.ref
        assert twin.port[("integrity", "sst_quarantine_total")] == 1
        for base in bases:
            assert os.path.exists(base + ".corrupt")
            assert os.path.exists(base + ".sblock.0.corrupt")
            assert not os.path.exists(base)
        assert any(q["path"] == bases[1]
                   for q in integrity.quarantined_files())
        assert ref.background_error.code == RefCode.CORRUPTION
        assert port.background_error.code == Code.CORRUPTION
        assert [db.retry_background_work() for db in (ref, port)] == \
            [False, False]
        assert integrity.scrub_snapshot()["corruption_detected"] >= 1
    finally:
        ref.close()
        port.close()


def test_read_corruption_routes_retryably(tmp_path):
    """A get over corrupt bytes parks the DB with a sticky Corruption
    and re-raises ServiceUnavailable, in both packages (the Python read
    path, as the JAX case runs it)."""
    olds = (port_flags.get_flag("read_native"),
            ref_flags.get_flag("read_native"))
    port_flags.set_flag("read_native", False)
    ref_flags.set_flag("read_native", False)
    ref, port, bases = _dbs(tmp_path)
    try:
        for base in bases:
            _flip(base + ".sblock.0", 40)
        codes = []
        for db, exc in ((ref, RefStatusError), (port, StatusError)):
            with pytest.raises(exc) as ei:
                db.get(_key(10))
            codes.append((ei.value.status.code.name,
                          db.background_error.code.name,
                          db.retry_background_work()))
        assert codes[0] == codes[1] == \
            ("SERVICE_UNAVAILABLE", "CORRUPTION", False)
    finally:
        ref.close()
        port.close()
        port_flags.set_flag("read_native", olds[0])
        ref_flags.set_flag("read_native", olds[1])


def test_failed_flush_parks_until_retry(tmp_path, monkeypatch):
    """A flush whose SST write fails restores the memtable and parks the
    DB read-only (writes refused retryably, reads served); a retry after
    the fault clears flushes and un-parks it."""
    from yugabyte_tpu_torch.storage import sst
    db = port_db.DB(str(tmp_path / "db"), port_db.DBOptions(
        device="native", auto_compact=False))
    items = [(_key(i), DocHybridTime(HybridTime((i + 1) << 12), 0),
              b"\x01v") for i in range(20)]
    db.write_batch(items)
    hook = []
    real = sst.write_sst_from_packed

    def failing(*a, **k):
        hook.append(1)
        raise OSError("disk full")
    monkeypatch.setattr(sst, "write_sst_from_packed", failing)
    monkeypatch.setattr(port_db.SSTWriter, "write",
                        lambda *a, **k: failing())
    seen = []
    db.on_background_error = seen.append
    try:
        assert db.flush() is None and hook
        assert db.background_error.code == Code.IO_ERROR and seen
        with pytest.raises(StatusError) as ei:
            db.write_batch(items[:1])
        assert ei.value.status.code == Code.SERVICE_UNAVAILABLE
        assert db.get(_key(3))[1] == b"\x01v"   # served from the memtable
        assert db.retry_background_work() is False
        monkeypatch.setattr(sst, "write_sst_from_packed", real)
        monkeypatch.undo()
        assert db.retry_background_work() is True
        assert db.background_error is None and db.n_live_files == 1
        assert db.get(_key(3))[1] == b"\x01v"
    finally:
        db.close()


# ------------------------------------------------------- shadow verifier

@pytest.mark.parametrize("codec", ["0", "1"], ids=["shell", "codec"])
def test_shadow_mismatch_sticky_matches_reference(tmp_path, inputs,
                                                  monkeypatch, codec):
    from tests.test_torch_fault_containment import _files, twin_jobs
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", codec)
    native = _files(run_job("native", inputs, str(tmp_path / "native"))
                    .outputs)
    for fl in (port_flags, ref_flags):
        fl.set_flag("shadow_verify_sample", 1.0)
        # the mismatch's timed window closes at once: what keeps the
        # bucket parked is the sticky mark alone
        fl.set_flag("device_fault_quarantine_s", 0.0)
    # a clean verified job counts its rows
    files, (rm, pm), _ = twin_jobs(tmp_path, inputs, "clean")
    assert files["port"] == files["ref"] == native
    assert pm == rm
    assert pm[("integrity", "shadow_verify_jobs_total")] == 1
    assert pm[("integrity", "shadow_verify_rows_total")] > 0
    # an armed bit flip is caught before install and contained
    files, (rm, pm), left = twin_jobs(tmp_path, inputs, "flip",
                                      ("bitflip", "survivor", 1))
    assert files["port"] == files["ref"] == native
    assert left == {"ref": 0, "port": 0}
    assert pm == rm
    assert pm[("integrity", "device_shadow_mismatch_total")] == 1
    assert pm[("offload_policy", "compaction_device_fallback_total")] == 1
    assert_boards_equal()
    board = port_bh.health_board()
    assert board.state("run_merge_fused", BUCKET) == port_bh.QUARANTINED
    # sticky: no decay re-opens it; the next job is native
    files, (rm, pm), _ = twin_jobs(tmp_path, inputs, "parked")
    assert files["port"] == native and pm == rm
    assert ("integrity", "shadow_verify_jobs_total") not in pm
    # an operator clear puts it on probation; a clean job re-proves it
    assert [b.clear_mismatch("run_merge_fused", BUCKET)
            for b in (ref_bh.health_board(), board)] == [1, 1]
    assert board.state("run_merge_fused", BUCKET) == port_bh.PROBATION
    files, (rm, pm), _ = twin_jobs(tmp_path, inputs, "reproved")
    assert files["port"] == files["ref"] == native
    assert pm[("integrity", "shadow_verify_jobs_total")] == 1
    assert_boards_equal()
    snap = integrity.shadow_snapshot()
    assert snap["sample"] == 1.0 and snap["mismatches"] >= 1


def test_unverified_bitflip_lands_silently_alike(tmp_path, inputs,
                                                 monkeypatch):
    """Without the verifier the flipped decision reaches the files: the
    defense is the verifier, not luck — and both packages flip alike."""
    from tests.test_torch_fault_containment import _files, twin_jobs
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "0")
    native = _files(run_job("native", inputs, str(tmp_path / "native"))
                    .outputs)
    files, (rm, pm), left = twin_jobs(tmp_path, inputs, "flip",
                                      ("bitflip", "survivor", 1))
    assert left == {"ref": 0, "port": 0}
    assert files["port"] == files["ref"] != native
    assert pm == rm
    assert port_bh.health_board().state("run_merge_fused", BUCKET) != \
        port_bh.QUARANTINED


@pytest.mark.parametrize("codec", ["0", "1"], ids=["shell", "codec"])
def test_verifier_wait_stays_off_the_device_rate(tmp_path, inputs,
                                                 monkeypatch, codec):
    """A verified job's wait for its oracle is the verifier's cost, not
    the device's: the seconds the job records on the board leave it out
    (here a 0.3 s oracle wait), and its files are those of the job."""
    import time
    from tests.test_torch_fault_containment import _files
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", codec)
    native = _files(run_job("native", inputs, str(tmp_path / "native"))
                    .outputs)
    join = integrity.ShadowVerifier._join

    def slow_join(self):
        time.sleep(0.3)
        return join(self)
    monkeypatch.setattr(integrity.ShadowVerifier, "_join", slow_join)
    board = port_bh.health_board()
    recorded = []
    record = board.record_device

    def spy(family, bucket, rows, seconds):
        recorded.append((family, seconds))
        return record(family, bucket, rows, seconds)
    monkeypatch.setattr(board, "record_device", spy)
    port_flags.set_flag("shadow_verify_sample", 1.0)
    w0 = integrity.shadow_wait_s()
    t0 = time.monotonic()
    res = run_job("port", inputs, str(tmp_path / "verified"))
    wall = time.monotonic() - t0
    waited = integrity.shadow_wait_s() - w0
    assert _files(res.outputs) == native
    assert integrity.shadow_snapshot()["jobs_verified"] >= 1
    # two joins at least (a chunk's check, then finish)
    assert waited >= 0.6
    secs = [s for f, s in recorded if f == "run_merge_fused"]
    assert len(secs) == 1 and 0 < secs[0] <= wall - waited + 1e-6
