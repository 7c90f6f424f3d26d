"""The port's tablet server against the JAX package's, on the CPU.

- `TSTabletManager`: create, restart (open_existing), split and remote
  bootstrap, each scenario run once in each package: equal meta.json /
  cmeta.json superblocks, reads and SST files. Remote bootstrap also
  across the packages (a port manager fetching from a JAX server and
  the other way round).
- Twins of tests/test_fault_injection.py::TestTabletFailedState (the
  flush fault parked, the WAL fault re-bootstrapped, the dropped fsyncs)
  and of tests/test_rpc.py::TestSidecars::test_remote_bootstrap_chunks_
  use_segment_path.
- A card-shaped server (its own ServerExecutionContext on device="cpu":
  the kernels' plain versions, a DeviceSlabCache) beside a JAX
  TabletServer under JAX_PLATFORMS=cpu, its tablets device-free: equal
  multi_read, scan and pushdown (filters, aggregates) answers through
  the `tserver` service, equal files after flush and compact (data files
  byte for byte, MANIFESTs edit for edit: the card-shaped compaction
  fits a learned index into its base files), equal maintenance picks.
- A JAX Messenger calling the port's `tserver` service over the wire, and
  a port Messenger calling the JAX one: equal answers.
- `test_default_server_refuses_without_cuda`: a default TabletServer
  raises torch_setup's error when it is built, binds no port and leaves
  no thread; `tserver_device="none"` serves device-free (ROADMAP C.8).

Each server or manager is started in a fixture-owned `Servers` that
shuts it down in a `finally`, and an autouse fixture asserts that no
thread a test started outlives it. Every scenario's clocks read one
`chip_smoke.StepTime` moved on at each write the test thread makes, so
both packages assign equal hybrid times. The port's device-free tablet
is TabletOptions(device="native"); the JAX package's default options are
device-free. Tolerance: exact.
"""

import importlib
import json
import os
import threading
import time
from types import SimpleNamespace

import jax  # noqa: F401 (the conftest pins JAX to the CPU)
import pytest

import chip_smoke
from tests.test_torch_consensus import elect_with_retry, wait_for
from tests.test_torch_env import dir_bytes, require_reference_native
from yugabyte_tpu_torch.storage import native_engine

pytestmark = pytest.mark.skipif(not native_engine.available(),
                                reason="native engine unavailable")

T0_US = 1_700_000_000_000_000


def package(root: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        name=root, ts=m("tserver.tablet_server"),
        tsm=m("tserver.ts_tablet_manager"), mm=m("tserver.maintenance_manager"),
        rb=m("tserver.remote_bootstrap"), ctx=m("tserver.server_context"),
        wire=m("common.wire"), schema=m("common.schema"),
        doc_key=m("docdb.doc_key"), ops=m("docdb.doc_operations"),
        ht=m("common.hybrid_time"), tablet=m("tablet.tablet"),
        peer=m("tablet.tablet_peer"), raft=m("consensus.raft"),
        transport=m("consensus.transport"), messenger=m("rpc.messenger"),
        flags=m("utils.flags"), env=m("utils.env"), status=m("utils.status"),
        bh=m("storage.bucket_health"), timeseries=m("utils.timeseries"),
        mt=m("utils.mem_tracker"))


REF = package("yugabyte_tpu")
PORT = package("yugabyte_tpu_torch")
BOTH = (REF, PORT)


@pytest.fixture(autouse=True)
def _isolated():
    """Fast raft heartbeats in both packages, the servers' background
    maintenance loops held (the tests pick ops with run_once), the port's
    process-wide board and time-series store fresh, and no thread left
    behind."""
    before = set(threading.enumerate())
    for P in BOTH:
        P.flags.set_flag("raft_heartbeat_interval_ms", 15)
        P.flags.set_flag("maintenance_manager_polling_interval_s", 3600)
    PORT.bh.health_board().reset()
    PORT.timeseries.reset_timeseries_store()
    try:
        yield
    finally:
        for P in BOTH:
            P.flags.reset_flag("raft_heartbeat_interval_ms")
            P.flags.reset_flag("maintenance_manager_polling_interval_s")
        PORT.bh.health_board().reset()
        PORT.timeseries.reset_timeseries_store()
    deadline = time.monotonic() + 15
    while True:
        left = [t for t in threading.enumerate()
                if t not in before and t.is_alive()]
        if not left:
            break
        assert time.monotonic() < deadline, \
            f"threads left behind: {sorted(t.name for t in left)}"
        time.sleep(0.05)


@pytest.fixture(autouse=True)
def _reference_native():
    require_reference_native()


class Servers:
    """Every server, manager and messenger a test starts; shut down in
    reverse order by the fixture's finally."""

    def __init__(self):
        self._items = []

    def add(self, x):
        self._items.append(x)
        return x

    def close(self, x):
        """Shut x down now (a test that reads what shutdown leaves)."""
        self._items.remove(x)
        x.shutdown()

    def shutdown(self):
        while self._items:
            x = self._items.pop()
            x.shutdown()


@pytest.fixture
def servers():
    s = Servers()
    try:
        yield s
    finally:
        s.shutdown()


def schema(P, hashed=False):
    S = P.schema
    return S.Schema(columns=[S.ColumnSchema("k", S.DataType.STRING),
                             S.ColumnSchema("v", S.DataType.INT64),
                             S.ColumnSchema("s", S.DataType.STRING)],
                    num_hash_key_columns=1 if hashed else 0,
                    num_range_key_columns=0 if hashed else 1)


def device_free(P):
    """The device-free tablet options: the JAX package's default, the
    port's device="native" (its default is the card)."""
    if P is PORT:
        return P.tablet.TabletOptions(device="native")
    return P.tablet.TabletOptions()


def dkey(P, k, hashed=False):
    if hashed:
        return P.doc_key.DocKey(hash_components=(k,))
    return P.doc_key.DocKey(range_components=(k,))


def op(P, k, v, hashed=False, kind="INSERT"):
    return P.ops.QLWriteOp(getattr(P.ops.WriteOpKind, kind),
                           dkey(P, k, hashed), {"v": v, "s": f"s{v % 7}"})


def elect(peer):
    elect_with_retry(peer.raft, peer.tablet_id)
    wait_for(lambda: peer.raft.leader_ready(), msg="leader ready")
    return peer


def row_tuple(r):
    return None if r is None else (r.doc_key.encode(),
                                   sorted(r.columns.items()),
                                   r.write_ht.value)


def new_server(P, root, servers, time_, **kw):
    """A started TabletServer of package P whose tablets' clocks read
    time_: device-free tablets, or, given `device`, the port's own
    execution context on it (the JAX server keeps device-free tablets)."""
    if P is REF or "device" not in kw:
        kw.pop("device", None)
        kw.setdefault("tablet_options_factory", lambda: device_free(P))
    ts = P.ts.TabletServer(P.ts.TabletServerOptions(
        server_id=kw.pop("server_id", "ts0"), fs_root=str(root), **kw))
    ts.clock = ts.tablet_manager.clock = P.ht.HybridClock(time_)
    return servers.add(ts.start())


def create(P, host, tid="t1", hashed=False, servers_=("ts0",)):
    """create_tablet through the service (or a bare manager) and elect."""
    mgr = getattr(host, "tablet_manager", host)
    mgr.create_tablet(tid, "tbl", P.wire.schema_to_wire(schema(P, hashed)),
                      list(servers_))
    return elect(mgr.get_tablet(tid))


def write_rows(P, service, time_, tid, rows, hashed=False, kind="INSERT"):
    time_.arm()
    return service.write(tid, [P.wire.write_op_to_wire(
        op(P, k, v, hashed, kind)) for k, v in rows])["propagated_ht"]


def bootstrap_and_join(src, dst, tid="t1"):
    """The replica-move flow: dst remote-bootstraps tid from src, src's
    leader adds dst to the Raft config (over RpcTransport), dst catches
    up and is elected (the leader moves). Returns dst's peer."""
    src.update_addr_map({dst.server_id: dst.address})
    dst.update_addr_map({src.server_id: src.address})
    dst.service.start_remote_bootstrap(tid, src.address)
    src.service.change_config(tid, add=[dst.server_id])
    lead = src.tablet_manager.get_tablet(tid)
    rep = dst.tablet_manager.get_tablet(tid)
    wait_for(lambda: len(rep.raft.config.peer_ids) == 2
             and rep.raft.last_applied >= lead.raft.commit_index,
             msg="the new replica to join and catch up")
    return elect(rep)


def twin(tmp_path, scenario):
    got = {}
    for P in BOTH:
        root = tmp_path / P.name
        root.mkdir()
        got[P.name] = scenario(P, root)
    assert got[PORT.name] == got[REF.name]
    return got[PORT.name]


def tablet_files(peer):
    return {part: dir_bytes(os.path.join(peer.data_dir, part))
            for part in ("regular", "intents")}


# ------------------------------------------------------------ TSTabletManager

def test_manager_create_restart_and_superblocks(tmp_path, servers):
    """create_tablet, writes, flush, shutdown, open_existing: equal
    meta.json, cmeta.json, reads and files; a retried create is a no-op."""
    def run(P, root):
        t = chip_smoke.StepTime(T0_US, 1000)
        mgr = P.tsm.TSTabletManager("ts0", str(root), P.transport.
                                    LocalTransport(), clock=P.ht.HybridClock(t),
                                    tablet_options_factory=lambda:
                                    device_free(P))
        try:
            peer = create(P, mgr)
            for b in range(3):
                t.arm()
                peer.write([op(P, f"k{b}{i:02d}", 10 * b + i)
                            for i in range(20)])
            peer.tablet.flush()
            mgr.create_tablet("t1", "tbl", P.wire.schema_to_wire(
                schema(P)), ["ts0"])                 # retried: a no-op
            report = mgr.generate_report()
        finally:
            mgr.shutdown()
        mgr2 = P.tsm.TSTabletManager("ts0", str(root), P.transport.
                                     LocalTransport(),
                                     clock=P.ht.HybridClock(t),
                                     tablet_options_factory=lambda:
                                     device_free(P))
        try:
            opened = mgr2.open_existing()
            peer2 = elect(mgr2.get_tablet("t1"))
            rows = [row_tuple(r) for r in peer2.multi_read(
                [dkey(P, f"k{b}{i:02d}") for b in range(3)
                 for i in (0, 7, 19)] + [dkey(P, "none")])]
            tdir = root / "tablets" / "t1"
            out = (opened, report, rows, mgr2.tablet_meta("t1"),
                   (tdir / "meta.json").read_text(),
                   sorted(os.listdir(tdir)), tablet_files(peer2))
        finally:
            mgr2.shutdown()
        return out
    opened, report, rows, meta, _raw, _ls, _files = twin(tmp_path, run)
    assert opened == 1 and rows[-1] is None and rows[0][1] == [(0, 0),
                                                               (1, "s0")]
    assert report[0]["role"] == "leader" and meta["table_id"] == "tbl"


def test_manager_split_tablet(tmp_path, servers):
    """split_tablet: the SPLIT op replicated, both children created from
    hard links of the parent with halved partitions, each child serving
    exactly its half; equal children, metas and rows."""
    def run(P, root):
        t = chip_smoke.StepTime(T0_US, 1000)
        mgr = servers.add(P.tsm.TSTabletManager(
            "ts0", str(root), P.transport.LocalTransport(),
            clock=P.ht.HybridClock(t),
            tablet_options_factory=lambda: device_free(P)))
        peer = create(P, mgr, hashed=True)
        t.arm()
        peer.write([op(P, f"k{i:03d}", i, hashed=True) for i in range(80)])
        children = mgr.split_tablet("t1")
        wait_for(lambda: all(c in mgr.tablet_ids() for c in children),
                 msg="children opened")
        out = {"children": children, "again": mgr.split_tablet("t1")}
        for c in children:
            cp = elect(mgr.get_tablet(c))
            out[c] = (mgr.tablet_meta(c),
                      sorted((r.doc_key.encode(), sorted(r.columns.items()))
                             for r in cp.tablet.scan()))
        return out
    out = twin(tmp_path, run)
    a, b = out["children"]
    assert out["again"] == [a, b]
    assert len(out[a][1]) + len(out[b][1]) == 80
    assert out[a][0]["partition"]["end"] == out[b][0]["partition"]["start"]


def test_manager_remote_bootstrap(tmp_path, servers):
    """start_remote_bootstrap from a TabletServer over the wire: the new
    replica's files equal the source's and its cmeta is a fresh vote
    record at the source's term; a repeat is a no-op; once the leader
    adds it and it is elected, its reads equal the source's."""
    def run(P, root):
        t = chip_smoke.StepTime(T0_US, 1000)
        src = new_server(P, root / "src", servers, t, webserver_port=None)
        peer = create(P, src)
        for b in range(2):
            write_rows(P, src.service, t, "t1",
                       [(f"k{b}{i:02d}", i) for i in range(30)])
        keys = [dkey(P, f"k{b}{i:02d}") for b in range(2) for i in range(30)]
        want = [row_tuple(r) for r in peer.multi_read(keys)]
        dst = new_server(P, root / "dst", servers, t, server_id="ts1",
                         webserver_port=None)
        dst.service.start_remote_bootstrap("t1", src.address)
        rep = dst.tablet_manager.get_tablet("t1")
        cmeta = json.loads(
            (root / "dst" / "tablets" / "t1" / "cmeta.json").read_text())
        files = dir_bytes(os.path.join(rep.data_dir, "regular"))
        assert files == dir_bytes(os.path.join(peer.data_dir, "regular"))
        dst.service.start_remote_bootstrap("t1", src.address)   # a no-op
        assert dst.tablet_manager.get_tablet("t1") is rep
        sessions = sorted(os.listdir(root / "src" / "rb_sessions"))
        meta = dst.tablet_manager.tablet_meta("t1")
        bootstrap_and_join(src, dst)
        rows = [row_tuple(r) for r in rep.multi_read(keys)]
        return (cmeta["term"], cmeta["voted_for"], cmeta["peer_ids"], meta,
                rows == want, rows, files, sessions)
    term, voted, peer_ids, meta, same, rows, _f, sessions = twin(tmp_path,
                                                                 run)
    assert term == 1 and voted is None and peer_ids == ["ts0/t1"]
    assert sessions == [] and meta["peer_server_ids"] == ["ts0"]
    assert same and None not in rows


@pytest.mark.parametrize("src_pkg,dst_pkg", [(REF, PORT), (PORT, REF)],
                         ids=["jax_source", "port_source"])
def test_remote_bootstrap_across_packages(tmp_path, servers, src_pkg,
                                          dst_pkg):
    """A server of one package bootstraps a tablet from a server of the
    other over the wire, joins its Raft group and takes the lead: the
    same files, the same rows."""
    t = chip_smoke.StepTime(T0_US, 1000)
    src = new_server(src_pkg, tmp_path / "src", servers, t,
                     webserver_port=None)
    peer = create(src_pkg, src)
    write_rows(src_pkg, src.service, t, "t1",
               [(f"k{i:03d}", i) for i in range(50)])
    want = [row_tuple(r) for r in peer.multi_read(
        [dkey(src_pkg, f"k{i:03d}") for i in range(50)])]
    dst = new_server(dst_pkg, tmp_path / "dst", servers, t, server_id="ts1",
                     webserver_port=None)
    rep = bootstrap_and_join(src, dst)
    assert dir_bytes(os.path.join(rep.data_dir, "regular")) == \
        dir_bytes(os.path.join(peer.data_dir, "regular"))
    assert [row_tuple(r) for r in rep.multi_read(
        [dkey(dst_pkg, f"k{i:03d}") for i in range(50)])] == want


def test_remote_bootstrap_chunks_use_segment_path(tmp_path, servers):
    """Twin of tests/test_rpc.py::TestSidecars::test_remote_bootstrap_
    chunks_use_segment_path on the port's messenger and FETCH_CHUNK, and
    the port's download_tablet over a port server: a bulk fetch rides
    sidecar segments, the bytes equal the source's; download_tablet's
    begin / fetch / end bring the tablet's files, and the ended session
    is gone."""
    M = PORT.messenger
    chunk = PORT.rb.FETCH_CHUNK
    assert chunk == REF.rb.FETCH_CHUNK

    class FileService:
        def fetch(self, path, offset, length):
            with open(path, "rb") as f:
                f.seek(offset)
                return f.read(min(length, chunk))

    server = servers.add(M.Messenger("src"))
    server.register_service("files", FileService())
    client = servers.add(M.Messenger("dst"))
    src = tmp_path / "tablet.sst"
    src.write_bytes(os.urandom(4 << 20))
    before_frames, before_bytes = M.sidecar_frames_sent, M.sidecar_bytes_sent
    out, off = bytearray(), 0
    while True:
        got = client.call(server.address, "files", "fetch", path=str(src),
                          offset=off, length=chunk)
        if not got:
            break
        out += got
        off += len(got)
    assert bytes(out) == src.read_bytes()
    assert M.sidecar_frames_sent > before_frames
    assert M.sidecar_bytes_sent - before_bytes >= 4 << 20
    # the tablet download itself: begin, chunked fetches, end
    t = chip_smoke.StepTime(T0_US, 1000)
    ts = new_server(PORT, tmp_path / "ts", servers, t, webserver_port=None)
    peer = create(PORT, ts)
    write_rows(PORT, ts.service, t, "t1", [(f"k{i}", i) for i in range(40)])
    resp = PORT.rb.download_tablet(client, ts.address, "t1",
                                   str(tmp_path / "dl"))
    assert dir_bytes(str(tmp_path / "dl" / "regular")) == \
        dir_bytes(os.path.join(peer.data_dir, "regular"))
    assert resp["term"] == 1 and resp["tablet_meta"]["table_id"] == "tbl"
    with pytest.raises(PORT.status.StatusError):
        client.call(ts.address, "tserver", "fetch_remote_bootstrap",
                    session_id=resp["session_id"], relpath="x", offset=0,
                    length=1)


# ------------------------------------------------ TestTabletFailedState twins

@pytest.fixture
def fault_managers(tmp_path, servers):
    """tests/test_fault_injection.py's `fenv` + `manager` in each package:
    FaultInjectionEnv installed, one elected tablet t1."""
    out = {}
    try:
        for P in BOTH:
            fi = P.env.enable_fault_injection(P.env.Env())
            mgr = servers.add(P.tsm.TSTabletManager(
                "ts0", str(tmp_path / P.name / "ts0"),
                P.transport.LocalTransport(),
                clock=P.ht.HybridClock(chip_smoke.StepTime(T0_US, 1000)),
                tablet_options_factory=lambda P=P: device_free(P)))
            create(P, mgr)
            out[P.name] = (fi, mgr)
        yield out
    finally:
        servers.shutdown()
        for P in BOTH:
            P.env.set_env(P.env.Env())


def test_flush_fault_fails_tablet_writes_reject_reads_drain(fault_managers):
    """Twin of TestTabletFailedState::test_flush_fault_fails_tablet_
    writes_reject_reads_drain."""
    got = {}
    for P in BOTH:
        fenv, manager = fault_managers[P.name]
        steps = []
        peer = manager.get_tablet("t1")
        for i in range(20):
            peer.write([op(P, f"k{i:03d}", i)])
        fenv.set_fault("enospc", path_filter=".sst")
        peer.tablet.flush()
        steps.append((peer.tablet.regular_db.background_error is not None,
                      peer.state))
        report = {t["tablet_id"]: t for t in manager.generate_report()}
        steps.append(report["t1"]["state"])
        with pytest.raises(P.status.StatusError) as ei:
            peer.write([op(P, "rejected", 1)])
        steps.append((ei.value.status.code.name,
                      bool(ei.value.extra.get("tablet_failed"))))
        steps.append(peer.read_row(dkey(P, "k003")).to_dict(
            schema(P))["v"])
        P.flags.set_flag("background_error_retry_initial_s", 0.02)
        try:
            mm = P.mm.MaintenanceManager(
                peers_fn=manager.peers,
                recover_fn=lambda p, m=manager: m.recover_failed_tablet(
                    p.tablet_id))
            steps.append((mm.run_once(), peer.state))
            sched = mm._recover_backoff["t1"]
            steps.append(sched.failures)
            fenv.clear_faults()
            wait_for(sched.ready, msg="backoff window")
            steps.append((mm.run_once(), peer.state,
                          peer.tablet.regular_db.background_error))
        finally:
            P.flags.reset_flag("background_error_retry_initial_s")
        peer.write([op(P, "after", 99)])
        steps.append([peer.read_row(dkey(P, k)).to_dict(schema(P))["v"]
                      for k in ("k000", "k019", "after")])
        got[P.name] = steps
    assert got[PORT.name] == got[REF.name]
    assert got[PORT.name][0] == (True, "FAILED")
    assert got[PORT.name][4] == ("recover:t1", "FAILED")
    assert got[PORT.name][6] == ("recover:t1", "RUNNING", None)


def test_wal_failure_fails_replicate_and_rebootstrap_recovers(
        fault_managers):
    """Twin of TestTabletFailedState::test_wal_failure_fails_replicate_
    and_rebootstrap_recovers."""
    got = {}
    for P in BOTH:
        fenv, manager = fault_managers[P.name]
        steps = []
        peer = manager.get_tablet("t1")
        for i in range(10):
            peer.write([op(P, f"w{i:02d}", i)])
        fenv.set_fault("append", path_filter="wal-")
        t0 = time.monotonic()
        with pytest.raises(P.raft.OperationOutcomeUnknown):
            peer.write([op(P, "doomed", -1)], timeout_s=30.0)
        steps.append(time.monotonic() - t0 < 10.0)
        wait_for(lambda: peer.state == "FAILED", msg="peer FAILED")
        steps.append(peer.log.io_error is not None)
        steps.append(peer.try_recover())
        fenv.clear_faults()
        steps.append(peer.try_recover())
        steps.append(manager.recover_failed_tablet("t1"))
        peer2 = manager.get_tablet("t1")
        steps.append((peer2 is not peer, peer2.state))
        elect(peer2)
        steps.append([peer2.read_row(dkey(P, f"w{i:02d}")).to_dict(
            schema(P))["v"] for i in range(10)])
        peer2.write([op(P, "fresh", 7)])
        steps.append(peer2.read_row(dkey(P, "fresh")).to_dict(
            schema(P))["v"])
        got[P.name] = steps
    assert got[PORT.name] == got[REF.name]
    assert got[PORT.name][:6] == [True, True, False, False, True,
                                  (True, "RUNNING")]


def test_dropped_wal_fsyncs_crash_recovers_synced_prefix(tmp_path,
                                                         servers):
    """Twin of TestTabletFailedState::test_dropped_wal_fsyncs_crash_
    recovers_synced_prefix."""
    got = {}
    for P in BOTH:
        fenv = P.env.enable_fault_injection(P.env.Env())
        try:
            root = str(tmp_path / P.name / "tsA")
            mgr = P.tsm.TSTabletManager(
                "tsA", root, P.transport.LocalTransport(),
                tablet_options_factory=lambda P=P: device_free(P))
            try:
                peer = create(P, mgr, tid="tw", servers_=("tsA",))
                for i in range(10):
                    peer.write([op(P, f"s{i:02d}", i)])
                fenv.set_drop_fsyncs(True, path_filter="wal-")
                for i in range(10, 20):
                    peer.write([op(P, f"s{i:02d}", i)])
            finally:
                mgr.shutdown()
            fenv.simulate_crash()
            mgr2 = servers.add(P.tsm.TSTabletManager(
                "tsA", root, P.transport.LocalTransport(),
                tablet_options_factory=lambda P=P: device_free(P)))
            opened = mgr2.open_existing()
            peer2 = elect(mgr2.get_tablet("tw"))
            got[P.name] = (opened, [
                peer2.read_row(dkey(P, f"s{i:02d}")) is not None
                for i in range(20)])
        finally:
            P.env.set_env(P.env.Env())
    assert got[PORT.name] == got[REF.name] == (1, [True] * 10 + [False] * 10)


# ------------------------------------------- the card-shaped server vs JAX

def _scan_answer(ans):
    """A scan response without its read point (each server's own) and
    its route flag (the card-shaped server pushes down where the JAX
    device-free one filters on the host)."""
    return {k: v for k, v in ans.items() if k not in ("read_ht", "pushdown")}


def _agg_answer(ans, col=0):
    """A scan-with-aggregates response as {"rows", "cols"}: the pushed-down
    partial as it is, a rows-mode answer (the caller aggregates, as the
    JAX device-free tablet answers) aggregated here over column `col`."""
    if "agg" in ans:
        return ans["agg"]
    vals = [r["columns"].get(col) for r in ans["rows"]]
    vals = [v for v in vals if v is not None]
    return {"rows": len(ans["rows"]), "cols": {col: {
        "nonnull": len(vals), "sum": sum(vals), "min": min(vals),
        "max": max(vals)}}}


def test_card_shaped_server_equals_jax_server(tmp_path, servers):
    """The port's server on a "cpu" execution context (plain kernels, a
    DeviceSlabCache) beside a JAX TabletServer with device-free tablets:
    through each package's `tserver` service, equal multi_read, scan,
    filtered scan and pushdown answers; equal files after flush and
    compact; equal maintenance picks; /healthz, /compactionz and /servez
    JSON naming the board and the caches."""
    import urllib.request
    from chip_smoke import same_db_files, same_dir_bytes, same_manifest
    got, peers, tss, routes = {}, {}, {}, {}
    for P in BOTH:
        P.flags.set_flag("scan_pushdown_min_rows", 1)
    try:
        for P in BOTH:
            t = chip_smoke.StepTime(T0_US, 1000)
            ts = new_server(P, tmp_path / P.name, servers, t, device="cpu")
            tss[P.name] = ts
            peer = peers[P.name] = create(P, ts)
            svc = ts.service
            out = {}
            for b in range(3):
                write_rows(P, svc, t, "t1",
                           [(f"k{i:03d}", i + 1000 * b)
                            for i in range(b * 40, b * 40 + 120)])
                if b < 2:
                    out[f"flush{b}"] = svc.flush_tablet("t1")
            write_rows(P, svc, t, "t1", [(f"k{i:03d}", -i)
                                         for i in range(0, 200, 9)],
                       kind="UPDATE")
            keys = [P.wire.doc_key_to_wire(dkey(P, f"k{i:03d}"))
                    for i in range(0, 260, 3)]
            out["multi_read"] = svc.multi_read("t1", keys)
            out["scan"] = _scan_answer(svc.scan("t1", limit=50))
            filtered = svc.scan("t1", filters=[["v", ">", 1040],
                                               ["s", "!=", "s3"]])
            out["scan_filtered"] = _scan_answer(filtered)
            agg = svc.scan("t1", filters=[["v", ">=", 0]],
                           aggregates=[["count", None], ["sum", "v"],
                                       ["max", "v"]])
            out["scan_agg"] = _agg_answer(agg)
            routes[P.name] = (filtered["pushdown"], "agg" in agg)
            out["flush"] = svc.flush_tablet("t1")
            out["maintenance"] = ts.maintenance_manager.run_once()
            out["compact"] = svc.compact_tablet("t1")
            out["after"] = svc.multi_read("t1", keys)
            out["status"] = svc.status()
            got[P.name] = out
        port, ref = got[PORT.name], got[REF.name]
        assert port == ref
        assert routes[PORT.name] == (True, True)     # J and K ran
        assert port["scan_agg"]["rows"] == 178   # 22 updated below 0
        assert port["scan"]["resume_key"] is not None
        dev = peers[PORT.name].tablet.regular_db
        nat = peers[REF.name].tablet.regular_db
        files = same_db_files(dev, nat, "card-shaped server compact")
        assert files["files"] >= 1
        assert same_manifest(dev, nat, "card-shaped server compact") > 0
        same_dir_bytes(peers[PORT.name].tablet.intents_db.db_dir,
                       peers[REF.name].tablet.intents_db.db_dir,
                       "intents") if os.listdir(
            peers[REF.name].tablet.intents_db.db_dir) else None
        ts = tss[PORT.name]
        assert ts.exec_context.device == "cpu"
        assert dev._device_cache is not None
        pages = {}
        for page in ("/healthz", "/compactionz", "/servez"):
            with urllib.request.urlopen(
                    f"http://{ts.webserver.address}{page}", timeout=10) as r:
                pages[page] = json.loads(r.read())
        assert pages["/healthz"]["status"] == "ok"
        assert "bucket_health" in pages["/healthz"]
        assert pages["/compactionz"]["device_cache"]["entries"] >= 1
        assert "point_reads" in pages["/servez"]
    finally:
        for P in BOTH:
            P.flags.reset_flag("scan_pushdown_min_rows")


# ------------------------------------------------------------------ the wire

def test_messengers_call_each_others_tserver_service(tmp_path, servers):
    """A JAX Messenger calls the port's `tserver` service and a port
    Messenger the JAX one: the same rows written in-process read back
    equal over the wire, a write over the wire lands on each, and the
    admin calls answer alike."""
    answers = {}
    for P, C in ((PORT, REF), (REF, PORT)):
        t = chip_smoke.StepTime(T0_US, 1000)
        ts = new_server(P, tmp_path / P.name, servers, t,
                        webserver_port=None)
        create(P, ts)
        write_rows(P, ts.service, t, "t1", [(f"k{i:02d}", i)
                                            for i in range(40)])
        client = servers.add(C.messenger.Messenger(f"client-{C.name}"))
        keys = [C.wire.doc_key_to_wire(dkey(C, f"k{i:02d}"))
                for i in (0, 5, 39, 77)]
        a = {"multi_read": client.call(ts.address, "tserver", "multi_read",
                                       tablet_id="t1", doc_keys=keys)}
        a["read_row"] = client.call(ts.address, "tserver", "read_row",
                                    tablet_id="t1", doc_key=keys[1])
        a["scan"] = _scan_answer(client.call(
            ts.address, "tserver", "scan", tablet_id="t1",
            filters=[["v", "<", 4]]))
        a["list"] = client.call(ts.address, "tserver", "list_tablets")
        w = client.call(ts.address, "tserver", "write", tablet_id="t1",
                        ops=[C.wire.write_op_to_wire(op(C, "wire", 5))])
        row = client.call(ts.address, "tserver", "read_row", tablet_id="t1",
                          doc_key=C.wire.doc_key_to_wire(dkey(C, "wire")))
        a["wire_write"] = (w["propagated_ht"] > 0, row["columns"])
        with pytest.raises(C.messenger.RemoteError) as ei:
            client.call(ts.address, "tserver", "multi_read",
                        tablet_id="nope", doc_keys=keys)
        a["not_found"] = ei.value.status.code.name
        answers[P.name] = a
    assert answers[PORT.name] == answers[REF.name]
    assert answers[PORT.name]["multi_read"]["rows"][3] is None
    assert answers[PORT.name]["not_found"] == "NOT_FOUND"


# ---------------------------------------------------------- the device (C.8)

def test_default_server_refuses_without_cuda(tmp_path, monkeypatch):
    """ROADMAP C.8: a default TabletServer's execution context takes the
    card; without CUDA it raises torch_setup's error when it is built,
    never falling back to native, and leaves no port or thread (the
    autouse fixture asserts the threads)."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        PORT.ts.TabletServer(PORT.ts.TabletServerOptions(
            server_id="ts0", fs_root=str(tmp_path / "ts")))
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        PORT.ctx.ServerExecutionContext()
    # the tablet manager's default factory is the card too (C.1)
    mgr = PORT.tsm.TSTabletManager("ts0", str(tmp_path / "m"),
                                   PORT.transport.LocalTransport())
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mgr.create_tablet("t1", "tbl", PORT.wire.schema_to_wire(
                schema(PORT)), ["ts0"])
    finally:
        mgr.shutdown()


def test_tserver_device_none_serves_device_free(tmp_path, servers,
                                                monkeypatch):
    """tserver_device="none" (and device="native") build a native context:
    no cache, no prewarm op, device-free tablets that serve without
    CUDA."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    PORT.flags.set_flag("tserver_device", "none")
    try:
        t = chip_smoke.StepTime(T0_US, 1000)
        ts = new_server(PORT, tmp_path / "ts", servers, t, device=None,
                        webserver_port=None)
    finally:
        PORT.flags.reset_flag("tserver_device")
    ctx = ts.exec_context
    assert (ctx.device, ctx.mesh, ctx.device_cache) == ("native", None, None)
    assert ctx.prewarm_op() is None
    peer = create(PORT, ts)
    write_rows(PORT, ts.service, t, "t1", [(f"k{i}", i) for i in range(9)])
    ts.service.flush_tablet("t1")
    assert peer.tablet.regular_db.opts.device == "native"
    assert [r["columns"][0] for r in ts.service.multi_read(
        "t1", [PORT.wire.doc_key_to_wire(dkey(PORT, f"k{i}"))
               for i in range(9)])["rows"]] == list(range(9))
    with pytest.raises(ValueError):
        PORT.ctx.resolve_device("bogus")


# ---------------------------------------------------- the heartbeater

class _StubMaster:
    """A `master` service: answers heartbeats with a scripted response
    and records each report; a follower redirects to its leader hint."""

    def __init__(self, P, leader_addr=None):
        self.P, self.leader_addr = P, leader_addr
        self.reports, self.responses = [], []

    def get_universe_keys(self):
        return []

    def heartbeat(self, server_id, server_addr, tablet_report):
        if self.leader_addr is not None:
            e = self.P.status.StatusError(
                self.P.status.Status.IllegalState("not the leader"))
            e.extra = {"not_leader": True, "leader_hint": self.leader_addr}
            raise e
        self.reports.append((server_id, tablet_report))
        return self.responses.pop(0) if self.responses else {}


def test_heartbeater_follows_the_leader_hint_and_applies_responses(
        tmp_path, servers):
    """A TabletServer with master_addrs (the first a follower master whose
    error hints the leader): start() registers through the hint, the
    report carries the hosted tablet, a response's addr_map, schema update
    and tablets_to_delete are applied; the same in both packages."""
    got = {}
    for P in BOTH:
        leader = _StubMaster(P)
        lm = servers.add(P.messenger.Messenger("master-leader"))
        lm.register_service("master", leader)
        fm = servers.add(P.messenger.Messenger("master-follower"))
        fm.register_service("master", _StubMaster(P, lm.address))
        t = chip_smoke.StepTime(T0_US, 1000)
        ts = new_server(P, tmp_path / P.name, servers, t,
                        webserver_port=None, master_addrs=[fm.address])
        steps = [len(leader.reports), ts.heartbeater._leader_addr ==
                 lm.address]
        create(P, ts)
        create(P, ts, tid="t2")
        wire = P.wire.schema_to_wire(schema(P))
        leader.responses.append({
            "addr_map": {"tsX": "127.0.0.1:1"},
            "schema_updates": [{"tablet_id": "t1", "schema": wire,
                                "version": 2}],
            "tablets_to_delete": ["t2"], "replication": [],
            "history_retention": {"t1": 60.0}})
        steps.append(ts.heartbeater.heartbeat_now())
        sid, report = leader.reports[-1]
        steps.append((sid, sorted((r["tablet_id"], r["role"], r["state"],
                                   r["schema_version"]) for r in report)))
        steps.append((ts._resolve_peer("tsX/t1"),
                      ts.tablet_manager.tablet_ids(),
                      ts.tablet_manager.tablet_meta("t1")["schema_version"],
                      ts.tablet_manager.get_tablet("t1").tablet
                      .retention_policy.override_s))
        got[P.name] = steps
    assert got[PORT.name] == got[REF.name]
    assert got[PORT.name][:3] == [1, True, True]
    assert got[PORT.name][4] == ("127.0.0.1:1", ["t1"], 2, 60.0)


def test_heartbeat_loop_backs_off_without_a_leader(tmp_path, servers):
    """No master answers: heartbeat_now is False, the loop keeps beating
    with its retry spacing, and shutdown stops it (both packages)."""
    for P in BOTH:
        P.flags.set_flag("heartbeat_interval_ms", 20)
        try:
            m = servers.add(P.messenger.Messenger("hb-client"))
            calls = []
            hb = P.ts.Heartbeater(m, ["127.0.0.1:1"], "tsZ", "x:0",
                                  report_provider=lambda: calls.append(1)
                                  or [], on_response=lambda r: None)
            assert hb.heartbeat_now() is False
            hb.start()
            time.sleep(0.15)
            hb.stop()
            hb._thread.join(timeout=10)
            assert not hb._thread.is_alive()
        finally:
            P.flags.reset_flag("heartbeat_interval_ms")
