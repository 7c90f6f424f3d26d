"""The port's exactly-once writes against the JAX package's, on the CPU.

Twins of the 5 cases of tests/test_retryable_requests.py: a write whose
first attempt replicated but whose ack was lost is retried with the same
(client id, request id) and applies exactly once, across leader changes
and WAL replay (ref: src/yb/consensus/retryable_requests.cc). Each
scenario runs once in each package (tests/test_torch_consensus.twin) on
a device-free peer group (the port's device="native") whose clocks read
one StepTime (chip_smoke's); compared are the hybrid times returned,
the raw entry counts, every replica's WAL entries, cmeta.json and SST
files. Every wait has its own deadline. Tolerance: exact.
"""

import pytest

from tests.test_torch_consensus import (PeerHarness, device_free, fast_raft,
                                        make_schema, step_time, twin,
                                        wait_for, wal_entries)

assert fast_raft  # the autouse fixture of the consensus twins, here too

CID = b"client-0123456789"[:16]


def _entry_count(peer):
    """Exact count of raw KV entries (every version) in the regular DB."""
    return sum(1 for _ in peer.tablet.regular_db.iter_from(b""))


def test_duplicate_request_returns_original_result(tmp_path):
    def run(P, root):
        h = PeerHarness(P, root)
        try:
            leader = h.elect("ts0")
            ht1 = h.write(leader, [h.op("k1", 1)], request=(CID, 7))
            n = _entry_count(leader)
            ht2 = h.write(leader, [h.op("k1", 1)], request=(CID, 7))
            n2 = _entry_count(leader)
            ht3 = h.write(leader, [h.op("k1", 2)], request=(CID, 8))
            h.quiesce()
            return (ht1, ht2, ht3, n, n2, _entry_count(leader)), h.state()
        finally:
            h.shutdown()
    (ht1, ht2, ht3, n, n2, n3), _state = twin(tmp_path, run)
    assert ht2 == ht1 and ht3 != ht1 and n2 == n and n3 == n + 2


def test_unknown_outcome_retry_applies_once(tmp_path):
    def run(P, root):
        h = PeerHarness(P, root)
        try:
            leader = h.elect("ts0")
            real_submit = leader.tablet.consensus.submit

            def flaky_submit(*a, **kw):
                real_submit(*a, **kw)
                raise P.raft.OperationOutcomeUnknown(
                    "ack lost after replication")

            leader.tablet.consensus.submit = flaky_submit
            with pytest.raises(P.raft.OperationOutcomeUnknown):
                h.write(leader, [h.op("kx", 5)], request=(CID, 20))
            leader.tablet.consensus.submit = real_submit
            n = _entry_count(leader)
            ht = h.write(leader, [h.op("kx", 5)], request=(CID, 20))
            h.quiesce()
            return (ht, n, _entry_count(leader)), h.state()
        finally:
            h.shutdown()
    (ht, n, n2), _state = twin(tmp_path, run)
    assert ht > 0 and n2 == n


def test_in_flight_duplicate_is_pushed_back(tmp_path):
    def run(P, root):
        h = PeerHarness(P, root)
        try:
            leader = h.elect("ts0")
            reg = leader.tablet.retryable
            states = [reg.check_or_track(CID, 33)[0],
                      reg.check_or_track(CID, 33)[0]]
            with pytest.raises(P.status.StatusError):
                h.write(leader, [h.op("ky", 1)], request=(CID, 33))
            reg.failed(CID, 33)
            ht = h.write(leader, [h.op("ky", 1)], request=(CID, 33))
            h.quiesce()
            return (states, ht), h.state()
        finally:
            h.shutdown()
    (states, _ht), _state = twin(tmp_path, run)
    assert states == ["new", "in_flight"]


def test_dedup_survives_leader_change(tmp_path):
    def run(P, root):
        h = PeerHarness(P, root)
        try:
            leader = h.elect("ts0")
            ht1 = h.write(leader, [h.op("kz", 9)], request=(CID, 40))
            wait_for(lambda: all(len(p.tablet.retryable) == 1
                                 for p in h.peers.values()),
                     msg="registry replicated everywhere")
            new_leader = h.elect("ts1")
            n = _entry_count(new_leader)
            ht2 = h.write(new_leader, [h.op("kz", 9)], request=(CID, 40))
            h.quiesce()
            return (ht1, ht2, n, _entry_count(new_leader)), h.state()
        finally:
            h.shutdown()
    (ht1, ht2, n, n2), _state = twin(tmp_path, run)
    assert ht2 == ht1 and n2 == n


def test_dedup_survives_restart_replay(tmp_path):
    def run(P, root):
        step = step_time()
        transport = P.transport.LocalTransport()
        schema = make_schema(P)
        key = P.doc_key.DocKey(range_components=("kr",))
        op = P.ops.QLWriteOp(P.ops.WriteOpKind.INSERT, key, {"v": 3})

        def solo():
            return P.peer.TabletPeer(
                "t1", str(root / "solo"), schema, "ts0", ("ts0",),
                transport, clock=P.ht.HybridClock(step),
                options=device_free(P)).start(election_timer=False)
        peer = solo()
        peer.raft.start_election(ignore_lease=True)
        wait_for(lambda: peer.raft.is_leader(), msg="leader")
        step.arm()
        ht1 = peer.write([op], request=(CID, 55)).value
        peer.shutdown()
        peer2 = solo()
        try:
            peer2.raft.start_election(ignore_lease=True)
            wait_for(lambda: peer2.raft.is_leader(),
                     msg="leader after restart")
            registry = len(peer2.tablet.retryable)
            n = _entry_count(peer2)
            step.arm()
            ht2 = peer2.write([op], request=(CID, 55)).value
            n2 = _entry_count(peer2)
        finally:
            peer2.shutdown()
        return (ht1, ht2, registry, n, n2,
                wal_entries(P, root / "solo" / "wal"))
    ht1, ht2, registry, n, n2, _wal = twin(tmp_path, run)
    assert registry == 1 and ht2 == ht1 and n2 == n
