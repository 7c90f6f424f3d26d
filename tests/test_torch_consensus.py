"""The port's Raft, WAL and TabletPeer against the JAX package's, on the CPU.

Twins of the 16 cases of tests/test_consensus.py (TestLog 4, TestRaft 7,
TestTabletPeer 5) and the raft half of tests/test_subdocument.py::
test_replicated_tablet_subdocument, plus a card-shaped group: three port
peers whose tablets take the kernels' plain versions (device="cpu" with
a device cache) beside a device-free JAX group.

Each case runs its scenario once in each package, in a directory of its
own, and compares end states, never timings: an election's timing is not
deterministic, so every group is driven through a forced leader
(`start_election(ignore_lease=True)`, as the reference's harnesses do)
and its end state is read once it has quiesced. Compared: the applied
entries in order, the WAL entries (term, index, op type, payload bytes),
cmeta.json, each replica's reads, and flushed SST bytes. A peer group's
clocks read one `chip_smoke.StepTime`: a fixed physical time the test
moves on at each write, so both packages' leaders assign equal hybrid
times (the raft threads' own readings only bump the logical part). The
port's device-free tablet is TabletOptions(device="native"): its default
is the card. Every wait has its own deadline. Tolerance: exact.
"""

import importlib
import json
import os
import time
from types import SimpleNamespace

import jax  # noqa: F401 (the conftest pins JAX to the CPU)
import pytest

import chip_smoke
from tests.test_torch_env import dir_bytes, require_reference_native
from yugabyte_tpu_torch.storage import native_engine

pytestmark = pytest.mark.skipif(not native_engine.available(),
                                reason="native engine unavailable")


def package(root: str) -> SimpleNamespace:
    """The modules a consensus twin drives, of one package."""
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        name=root, log=m("consensus.log"), raft=m("consensus.raft"),
        transport=m("consensus.transport"), peer=m("tablet.tablet_peer"),
        tablet=m("tablet.tablet"), schema=m("common.schema"),
        ht=m("common.hybrid_time"), doc_key=m("docdb.doc_key"),
        ops=m("docdb.doc_operations"), flags=m("utils.flags"),
        dc=m("storage.device_cache"), status=m("utils.status"))


REF = package("yugabyte_tpu")
PORT = package("yugabyte_tpu_torch")
BOTH = (REF, PORT)
T0_US = 1_700_000_000_000_000


def step_time():
    """A group's physical time (chip_smoke's StepTime): moved on by 1 ms
    at the first reading the test's thread takes after `arm()`; raft's
    own readings only bump the logical part of a clock."""
    return chip_smoke.StepTime(T0_US, 1000)


def wait_for(pred, timeout=20.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise TimeoutError(f"timed out waiting for {msg}")


def elect_with_retry(raft_like, name, timeout=30.0):
    """The reference's `_elect_with_retry`: exponentially backed-off
    re-elections until `raft_like` leads."""
    deadline = time.monotonic() + timeout
    window = 2.0
    while time.monotonic() < deadline:
        raft_like.start_election(ignore_lease=True)
        attempt_end = min(time.monotonic() + window, deadline)
        while time.monotonic() < attempt_end:
            if raft_like.is_leader():
                return
            time.sleep(0.005)
        window *= 2
    raise TimeoutError(f"timed out waiting for {name} leader")


@pytest.fixture(autouse=True)
def fast_raft():
    for P in BOTH:
        P.flags.set_flag("raft_heartbeat_interval_ms", 15)
        P.flags.set_flag("ht_lease_duration_ms", 1000)
    yield
    for P in BOTH:
        P.flags.reset_flag("raft_heartbeat_interval_ms")
        P.flags.reset_flag("ht_lease_duration_ms")


def twin(tmp_path, scenario):
    """scenario(P, root) in each package; both end states must be equal.
    Returns the port's."""
    got = {}
    for P in BOTH:
        root = tmp_path / P.name
        root.mkdir()
        got[P.name] = scenario(P, root)
    assert got[PORT.name] == got[REF.name]
    return got[PORT.name]


def wal_entries(P, wal_dir):
    """(term, index, op type, payload) of every WAL entry, in order."""
    return [(m.term, m.index, m.op_type, m.payload)
            for m in (P.raft.ReplicateMsg.from_log_entry(e)
                      for e in P.log.LogReader(str(wal_dir)).read_all())]


def cmeta(path):
    with open(path) as f:
        return json.load(f)


def applied_entries(msgs):
    return [(m.term, m.index, m.op_type, m.payload) for m in msgs]


# ---------------------------------------------------------------------- WAL

class TestLog:
    """Twins of tests/test_consensus.py::TestLog."""

    def test_roundtrip_and_recovery(self, tmp_path):
        def run(P, root):
            wal = str(root / "wal")
            log = P.log.Log(wal)
            log.append_sync([P.log.LogEntry(1, i, f"payload-{i}".encode())
                             for i in range(1, 51)])
            assert log.last_op_id == (1, 50)
            log.close()
            log2 = P.log.Log(wal)
            last = log2.last_op_id
            got = [(e.term, e.index, e.payload)
                   for e in P.log.LogReader(wal).read_all()]
            log2.close()
            return last, got, dir_files(wal)
        last, got, _files = twin(tmp_path, run)
        assert last == (1, 50) and [g[1] for g in got] == list(range(1, 51))
        assert got[10][2] == b"payload-11"

    def test_segment_rollover_and_gc(self, tmp_path):
        def run(P, root):
            P.flags.set_flag("log_segment_size_bytes", 512)
            try:
                wal = str(root / "wal")
                log = P.log.Log(wal)
                for i in range(1, 101):
                    log.append_sync([P.log.LogEntry(1, i, b"x" * 64)])
                segs = len(P.log.LogReader(wal).segments())
                removed = log.gc_up_to(60)
                remaining = [e.index for e in P.log.LogReader(wal).read_all()]
                log.close()
                return segs, removed, remaining, dir_files(wal)
            finally:
                P.flags.reset_flag("log_segment_size_bytes")
        segs, removed, remaining, _files = twin(tmp_path, run)
        assert segs > 3 and removed > 0 and 100 in remaining
        assert remaining == sorted(remaining)
        assert set(range(60, 101)) <= set(remaining)

    def test_torn_tail_dropped(self, tmp_path):
        def run(P, root):
            wal = str(root / "wal")
            log = P.log.Log(wal)
            log.append_sync([P.log.LogEntry(1, i, b"data") for i in (1, 2, 3)])
            log.close()
            seg = P.log.LogReader(wal).segments()[0]
            with open(seg, "ab") as f:
                f.write(b"\x01\x02\x03garbage-partial-record")
            log2 = P.log.Log(wal)
            last = log2.last_op_id
            log2.append_sync([P.log.LogEntry(1, 4, b"after")])
            got = [e.index for e in P.log.LogReader(wal).read_all()]
            log2.close()
            return last, got, dir_files(wal)
        last, got, _files = twin(tmp_path, run)
        assert last == (1, 3) and got == [1, 2, 3, 4]

    def test_truncate_after(self, tmp_path):
        def run(P, root):
            wal = str(root / "wal")
            log = P.log.Log(wal)
            log.append_sync([P.log.LogEntry(1, i, b"d") for i in range(1, 11)])
            log.truncate_after(6)
            last = log.last_op_id
            log.append_sync([P.log.LogEntry(2, 7, b"new7")])
            got = [e.op_id for e in P.log.LogReader(wal).read_all()]
            log.close()
            return last, got, dir_files(wal)
        last, got, _files = twin(tmp_path, run)
        assert last == (1, 6)
        assert got == [(1, i) for i in range(1, 7)] + [(2, 7)]


def dir_files(d):
    """{name: bytes} of every file in a directory."""
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


# --------------------------------------------------------------------- Raft

class RaftHarness:
    """tests/test_consensus.py's RaftHarness in package P, its clocks on
    one StepTime."""

    def __init__(self, P, root, n=3, timers=False):
        self.P, self.root = P, root
        self.time = step_time()
        self.transport = P.transport.LocalTransport()
        self.applied = {f"p{i}": [] for i in range(n)}
        self.nodes = {}
        ids = tuple(f"p{i}" for i in range(n))
        for pid in ids:
            d = root / pid
            os.makedirs(d, exist_ok=True)
            node = P.raft.RaftConsensus(
                P.raft.RaftConfig(pid, ids), P.log.Log(str(d / "wal")),
                self.transport,
                apply_cb=lambda m, p=pid: self.applied[p].append(m),
                meta_path=str(d / "cmeta.json"),
                clock=P.ht.HybridClock(self.time))
            self.transport.register(pid, node)
            node.start(election_timer=timers)
            self.nodes[pid] = node

    def leader(self):
        for n in self.nodes.values():
            if n.is_leader():
                return n
        return None

    def elect(self, pid):
        elect_with_retry(self.nodes[pid], pid)
        return self.nodes[pid]

    def replicate(self, node, payload, **kw):
        self.time.arm()
        return node.replicate(self.P.raft.OP_WRITE, self.time(), payload,
                              **kw)

    def quiesce(self, pids=None):
        """Every node of `pids` holds and applied the leader's log."""
        leader = self.leader()
        nodes = [self.nodes[p] for p in (pids or self.nodes)]
        wait_for(lambda: all(
            n.last_op_id == leader.last_op_id
            and n.last_applied == leader.commit_index for n in nodes),
            msg="the group to quiesce")

    def shutdown(self):
        for n in self.nodes.values():
            n.shutdown()
            n.log.close()

    def state(self, pids=None):
        """Each node's applied entries, WAL entries and cmeta.json."""
        return {p: {"applied": applied_entries(self.applied[p]),
                    "wal": wal_entries(self.P, self.root / p / "wal"),
                    "cmeta": cmeta(self.root / p / "cmeta.json")}
                for p in (pids or sorted(self.nodes))}


class TestRaft:
    """Twins of tests/test_consensus.py::TestRaft."""

    def test_election_and_replication(self, tmp_path):
        def run(P, root):
            h = RaftHarness(P, root)
            try:
                leader = h.elect("p0")
                for i in range(20):
                    h.replicate(leader, f"op{i}".encode())
                assert [m.payload for m in h.applied["p0"]] == \
                    [f"op{i}".encode() for i in range(20)]
                wait_for(lambda: len(h.applied["p1"]) == 20 and
                         len(h.applied["p2"]) == 20, msg="followers applied")
                h.quiesce()
            finally:
                h.shutdown()
            return h.state()
        state = twin(tmp_path, run)
        assert [e[1] for e in state["p1"]["applied"]] == \
            [e[1] for e in state["p0"]["applied"]]

    def test_not_leader_rejected(self, tmp_path):
        def run(P, root):
            h = RaftHarness(P, root)
            try:
                h.elect("p0")
                with pytest.raises(P.raft.NotLeader):
                    h.replicate(h.nodes["p1"], b"nope")
                h.quiesce()
            finally:
                h.shutdown()
            return h.state()
        twin(tmp_path, run)

    def test_follower_catchup_after_partition(self, tmp_path):
        def run(P, root):
            h = RaftHarness(P, root)
            try:
                leader = h.elect("p0")
                h.replicate(leader, b"a")
                h.transport.partition("p0", "p2")
                h.transport.partition("p1", "p2")
                for i in range(10):
                    h.replicate(leader, b"b%d" % i)
                assert len(h.applied["p2"]) <= 1
                h.transport.heal()
                wait_for(lambda: len(h.applied["p2"]) == 11,
                         msg="p2 catchup")
                h.quiesce()
            finally:
                h.shutdown()
            return h.state()
        twin(tmp_path, run)

    def test_leader_failover_and_divergent_truncation(self, tmp_path):
        def run(P, root):
            h = RaftHarness(P, root)
            try:
                old = h.elect("p0")
                h.replicate(old, b"committed")
                wait_for(lambda: len(h.applied["p1"]) == 1
                         and len(h.applied["p2"]) == 1, msg="replicated")
                h.transport.isolate("p0")
                with pytest.raises(P.raft.ReplicationTimedOut):
                    h.replicate(old, b"orphan", timeout_s=0.3)
                new = h.elect("p1")
                h.replicate(new, b"new-leader-op")
                wait_for(lambda: len(h.applied["p2"]) == 2,
                         msg="p2 got new op")
                h.transport.heal()
                wait_for(lambda: len(h.applied["p0"]) == 2,
                         msg="p0 converged")
                assert h.applied["p0"][1].payload == b"new-leader-op"
                assert not old.is_leader()
                h.quiesce()
            finally:
                h.shutdown()
            return h.state()
        state = twin(tmp_path, run)
        assert b"orphan" not in [e[3] for e in state["p0"]["wal"]]

    def test_auto_election_with_timers(self, tmp_path):
        """Which node the timers elect is not deterministic: compared are
        the one leader each package ends with and what it applied."""
        def run(P, root):
            h = RaftHarness(P, root, timers=True)
            try:
                wait_for(lambda: h.leader() is not None, msg="auto leader")
                leader = h.leader()
                h.replicate(leader, b"x")
                leaders = sum(1 for n in h.nodes.values() if n.is_leader())
                mine = [p for p, n in h.nodes.items() if n is leader][0]
                return leaders, [m.payload for m in h.applied[mine]]
            finally:
                h.shutdown()
        assert twin(tmp_path, run) == (1, [b"x"])

    def test_leader_lease(self, tmp_path):
        def run(P, root):
            P.flags.set_flag("ht_lease_duration_ms", 200)
            try:
                h = RaftHarness(P, root)
                try:
                    leader = h.elect("p0")
                    wait_for(leader.has_leader_lease, msg="lease acquired")
                    h.transport.isolate("p0")
                    time.sleep(0.4)
                    return leader.has_leader_lease(), leader.is_leader()
                finally:
                    h.shutdown()
            finally:
                P.flags.set_flag("ht_lease_duration_ms", 1000)
        assert twin(tmp_path, run) == (False, True)

    def test_restart_recovers_log(self, tmp_path):
        def run(P, root):
            h = RaftHarness(P, root)
            leader = h.elect("p0")
            for i in range(5):
                h.replicate(leader, b"v%d" % i)
            h.quiesce()
            h.shutdown()
            h2 = RaftHarness(P, root)
            try:
                n0 = h2.nodes["p0"]
                recovered = (n0.last_op_id, n0.current_term)
                leader = h2.elect("p1")
                h2.replicate(leader, b"after-restart")
                wait_for(lambda: any(m.payload == b"after-restart"
                                     for m in h2.applied["p2"]),
                         msg="p2 new op")
                h2.quiesce()
            finally:
                h2.shutdown()
            return recovered, h2.state()
        (last, term), _state = twin(tmp_path, run)
        assert last[1] >= 5 and term >= 1


# --------------------------------------------------------------- TabletPeer

def make_schema(P):
    S = P.schema
    return S.Schema(columns=[S.ColumnSchema("k", S.DataType.STRING),
                             S.ColumnSchema("v", S.DataType.INT64)],
                    num_hash_key_columns=0, num_range_key_columns=1)


def device_free(P, **kw):
    """The device-free tablet: the JAX package's default options, the
    port's device="native" (its default is the card)."""
    if P is PORT:
        kw.setdefault("device", "native")
    return P.tablet.TabletOptions(**kw)


class PeerHarness:
    """tests/test_consensus.py's PeerHarness in package P: a group of
    TabletPeers over a LocalTransport, its clocks on one StepTime."""

    def __init__(self, P, root, n=3, options=None, time_=None):
        self.P, self.root = P, root
        self.time = time_ or step_time()
        self.options = options or (lambda: device_free(P))
        self.transport = P.transport.LocalTransport()
        self.schema = make_schema(P)
        self.servers = tuple(f"ts{i}" for i in range(n))
        self.peers = {}
        for s in self.servers:
            self.peers[s] = self.open(s)

    def open(self, s):
        return self.P.peer.TabletPeer(
            "t1", str(self.root / s), self.schema, s, self.servers,
            self.transport, clock=self.P.ht.HybridClock(self.time),
            options=self.options()).start(election_timer=False)

    def elect(self, s):
        elect_with_retry(self.peers[s].raft, s)
        return self.peers[s]

    def key(self, k):
        return self.P.doc_key.DocKey(range_components=(k,))

    def op(self, k, v):
        return self.P.ops.QLWriteOp(self.P.ops.WriteOpKind.INSERT,
                                    self.key(k), {"v": v})

    def write(self, peer, ops, **kw):
        self.time.arm()
        return peer.write(ops, **kw).value

    def value(self, row):
        return None if row is None else row.to_dict(self.schema)["v"]

    def quiesce(self, servers=None):
        leader = next(p for p in self.peers.values() if p.raft.is_leader())
        peers = [self.peers[s] for s in (servers or self.peers)]
        wait_for(lambda: all(
            p.raft.last_op_id == leader.raft.last_op_id
            and p.raft.last_applied == leader.raft.commit_index
            for p in peers), msg="the group to quiesce")

    def reads(self, keys, read_ht):
        """Every replica's multi_read at read_ht (followers vouched)."""
        out = {}
        for s, p in sorted(self.peers.items()):
            if not p.raft.is_leader():
                p.grant_vouch(0)
            out[s] = [None if r is None else
                      (r.doc_key.encode(), sorted(r.columns.items()),
                       r.write_ht.value)
                      for r in p.multi_read([self.key(k) for k in keys],
                                            read_ht=read_ht,
                                            allow_follower=True)]
        return out

    def shutdown(self):
        for p in self.peers.values():
            p.shutdown()

    def state(self):
        """Each replica's WAL entries, cmeta.json and SST files."""
        return {s: {"wal": wal_entries(self.P, self.root / s / "wal"),
                    "cmeta": cmeta(self.root / s / "cmeta.json"),
                    "sst": dir_bytes(str(self.root / s / "regular"))}
                for s in self.servers}


@pytest.fixture
def _reference_native():
    require_reference_native()


class TestTabletPeer:
    """Twins of tests/test_consensus.py::TestTabletPeer."""

    def test_replicated_write_and_follower_read(self, tmp_path):
        def run(P, root):
            h = PeerHarness(P, root)
            try:
                leader = h.elect("ts0")
                ht = h.write(leader, [h.op(f"row{i}", i) for i in range(8)])
                got = [h.value(leader.read_row(h.key("row3")))]
                follower = h.peers["ts1"]
                follower.grant_vouch(0)
                wait_for(lambda: follower.tablet.mvcc
                         .safe_time_for_follower().value > 0,
                         msg="propagated safe time")
                wait_for(lambda: (follower.read_row(
                    h.key("row3"), allow_follower=True) or None) is not None,
                    msg="follower row visible")
                got.append(h.value(follower.read_row(h.key("row3"),
                                                     allow_follower=True)))
                with pytest.raises(P.raft.NotLeader):
                    follower.write([h.op("x", 1)])
                with pytest.raises(P.raft.NotLeader):
                    follower.read_row(h.key("row3"))
                h.quiesce()
                reads = h.reads([f"row{i}" for i in range(9)],
                                P.ht.HybridTime(ht))
            finally:
                h.shutdown()
            return got, reads, h.state()
        got, _reads, _state = twin(tmp_path, run)
        assert got == [3, 3]

    def test_restart_bootstrap_replays_wal(self, tmp_path):
        def run(P, root):
            h = PeerHarness(P, root)
            leader = h.elect("ts0")
            h.write(leader, [h.op(f"k{i}", 10 * i) for i in range(20)])
            h.quiesce()
            h.shutdown()
            h2 = PeerHarness(P, root, time_=h.time)
            try:
                leader = h2.elect("ts1")
                got = [h2.value(leader.read_row(h2.key("k7")))]
                ht = h2.write(leader, [h2.op("new", 999)])
                got.append(h2.value(leader.read_row(h2.key("new"))))
                h2.quiesce()
                reads = h2.reads(["k7", "new", "k19"], P.ht.HybridTime(ht))
            finally:
                h2.shutdown()
            return got, reads, h2.state()
        got, _reads, _state = twin(tmp_path, run)
        assert got == [70, 999]

    def test_flush_then_restart_and_wal_gc(self, tmp_path,
                                           _reference_native):
        def run(P, root):
            P.flags.set_flag("log_segment_size_bytes", 2048)
            try:
                h = PeerHarness(P, root)
                leader = h.elect("ts0")
                for i in range(30):
                    h.write(leader, [h.op(f"k{i:03d}", i)])
                removed = leader.flush_and_gc_wal()
                flushed = dir_bytes(str(root / "ts0" / "regular"))
                h.quiesce()
                h.shutdown()
                h2 = PeerHarness(P, root, time_=h.time)
                try:
                    leader = h2.elect("ts0")
                    got = [h2.value(leader.read_row(
                        h2.key(f"k{i:03d}"))) for i in (0, 15, 29)]
                    h2.quiesce()
                finally:
                    h2.shutdown()
                return removed, flushed, got, h2.state()
            finally:
                P.flags.reset_flag("log_segment_size_bytes")
        removed, flushed, got, _state = twin(tmp_path, run)
        assert removed >= 1 and got == [0, 15, 29]
        assert any(".sst" in name for name in flushed)

    def test_timed_out_write_fate_resolves(self, tmp_path):
        def run(P, root):
            h = PeerHarness(P, root)
            try:
                leader = h.elect("ts0")
                h.write(leader, [h.op("pre", 1)])
                h.transport.partition("ts0/t1", "ts1/t1")
                h.transport.partition("ts0/t1", "ts2/t1")
                h.time.arm()
                with pytest.raises(P.raft.OperationOutcomeUnknown):
                    leader.tablet.write([h.op("limbo", 42)], timeout_s=0.3)
                h.transport.heal()
                wait_for(lambda: leader.raft.op_fate(
                    (leader.raft.current_term, 3)) == "committed",
                    msg="limbo op committed")
                wait_for(lambda: (leader.read_row(h.key("limbo"))
                                  or None) is not None,
                         msg="limbo row visible")
                got = h.value(leader.read_row(h.key("limbo")))
                h.quiesce()
            finally:
                h.shutdown()
            return got, h.state()
        got, _state = twin(tmp_path, run)
        assert got == 42

    def test_failover_preserves_data(self, tmp_path):
        def run(P, root):
            h = PeerHarness(P, root)
            try:
                leader = h.elect("ts0")
                h.write(leader, [h.op("stable", 1)])
                h.transport.isolate("ts0/t1")
                new = h.elect("ts1")

                def caught_up():
                    ci, la = new.raft.commit_progress()
                    return la >= ci and ci >= 1
                wait_for(caught_up, msg="new leader caught up")
                got = [h.value(new.read_row(h.key("stable")))]
                ht = h.write(new, [h.op("after-failover", 2)])
                h.transport.heal()
                old = h.peers["ts0"]
                old.grant_vouch(0)
                wait_for(lambda: (old.read_row(
                    h.key("after-failover"), allow_follower=True)
                    or None) is not None, msg="old leader converged",
                    timeout=15)
                h.quiesce()
                reads = h.reads(["stable", "after-failover"],
                                P.ht.HybridTime(ht))
            finally:
                h.shutdown()
            return got, reads, h.state()
        got, reads, _state = twin(tmp_path, run)
        assert got == [1] and all(None not in r for r in reads.values())


def test_replicated_tablet_subdocument(tmp_path):
    """Twin of the raft half of tests/test_subdocument.py::
    test_replicated_tablet_subdocument: subdocuments written through the
    leader's tablet, replicated, read on a follower at its safe time."""
    def run(P, root):
        h = PeerHarness(P, root)
        try:
            leader = h.elect("ts0")
            t = leader.tablet
            key = h.key("userdoc")
            h.time.arm()
            t.write_subdocument(key, (), {"settings": {"theme": "dark",
                                                       "tabs": {"n": 4}}})
            got = [t.read_subdocument(key)]
            h.time.arm()
            t.write_subdocument(key, ("settings", "tabs"), {"n": 8})
            got.append(t.read_subdocument(key, ("settings", "tabs")))
            h.time.arm()
            t.delete_subdocument(key, ("settings",))
            got += [t.read_subdocument(key),
                    t.read_subdocument(key, ("settings",))]
            h.quiesce()
            f = h.peers["ts1"].tablet
            wait_for(lambda: f.mvcc.peek_safe_time().value
                     >= h.time.us << 12, msg="follower safe time")
            got.append(f.read_subdocument(key,
                                          read_ht=f.mvcc.peek_safe_time()))
        finally:
            h.shutdown()
        return got, h.state()
    got, _state = twin(tmp_path, run)
    assert got == [{"settings": {"theme": "dark", "tabs": {"n": 4}}},
                   {"n": 8}, {}, None, {}]


def test_card_shaped_group_on_the_cpu(tmp_path, _reference_native):
    """Three port peers whose tablets take the card's routing on the CPU
    (TabletOptions(device="cpu", DeviceSlabCache("cpu")): the kernels'
    plain versions) take the same writes as a device-free JAX group:
    every replica's multi_read answers, the WAL entries and cmeta.json
    are equal, the flushed files byte for byte, and after a compaction
    on every replica the data files byte for byte (the port's device job
    fits a learned index into its base files, the native job cannot)."""
    from yugabyte_tpu_torch.storage.sst import data_file_name

    def run(P, root):
        if P is PORT:
            def options():
                return P.tablet.TabletOptions(
                    device="cpu", device_cache=P.dc.DeviceSlabCache("cpu"),
                    auto_compact=False)
        else:
            def options():
                return P.tablet.TabletOptions(auto_compact=False)
        h = PeerHarness(P, root, options=options)
        try:
            leader = h.elect("ts0")
            ht = 0
            for f in range(3):
                for c in range(4):
                    ht = h.write(leader, [h.op(f"k{(7 * i + c) % 300:04d}",
                                               1000 * f + i)
                                          for i in range(100)])
                h.quiesce()
                for p in h.peers.values():
                    p.tablet.flush()
            keys = [f"k{i:04d}" for i in range(0, 310, 3)]
            reads = h.reads(keys, P.ht.HybridTime(ht))
            flushed = h.state()
            data = {}
            for s, p in sorted(h.peers.items()):
                p.tablet.compact()
                data[s] = [open(data_file_name(fm.path), "rb").read()
                           for fm in sorted(
                               p.tablet.regular_db.versions.live_files(),
                               key=lambda fm: fm.file_id)]
            after = h.reads(keys, P.ht.HybridTime(ht))
        finally:
            h.shutdown()
        return reads, flushed, data, after
    reads, _flushed, data, after = twin(tmp_path, run)
    assert reads == after and sum(r is not None for r in reads["ts0"]) > 50
    assert all(len(v) == 1 for v in data.values())
