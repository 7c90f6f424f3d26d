"""The port's TransactionCoordinator against the JAX package's, on the CPU.

Each scenario runs once in each package on a TabletServer of its own
(device-free tablets: the port's TabletOptions(device="native")) that
hosts a status tablet (`transaction_coordinator.TXN_STATUS_SCHEMA`) and a
data tablet, both elected, driven through the `tserver` service's txn_*
and participant calls:

- the status record's state machine (create, heartbeat, status, commit
  and its idempotent retry, abort, unknown and expired transactions):
  equal answers, error codes and hybrid times;
- a committed transaction's provisional writes applied on the
  participant by the coordinator's notification (apply_transaction over
  the wire), an aborted one's cleaned up: equal rows;
- a JAX Messenger driving the port's coordinator RPCs and a port
  Messenger the JAX one.

The status tablets' clocks read one `chip_smoke.StepTime` moved on at
each coordinator write the test thread makes, so both packages pick
equal read points and commit times. Tolerance: exact.
"""

import importlib
import time
from types import SimpleNamespace

import jax  # noqa: F401 (the conftest pins JAX to the CPU)
import numpy as np
import pytest

import chip_smoke
from tests.test_torch_consensus import wait_for
from tests.test_torch_tablet_server import (BOTH, PORT, REF, T0_US, Servers,
                                            create, device_free, dkey,
                                            elect, new_server, op)
from tests.test_torch_tablet_server import (  # noqa: F401 (fixtures)
    _isolated, _reference_native, servers)
from yugabyte_tpu_torch.storage import native_engine

pytestmark = pytest.mark.skipif(not native_engine.available(),
                                reason="native engine unavailable")


def txn_mod(P):
    return SimpleNamespace(
        tc=importlib.import_module(
            f"{P.name}.tserver.transaction_coordinator"),
        intents=importlib.import_module(f"{P.name}.docdb.intents"))


@pytest.fixture
def hosts(tmp_path):
    """{package: (server, StepTime)}: a started server per package with
    the status tablet "status" and the data tablet "t1" elected."""
    s = Servers()
    out = {}
    try:
        for P in BOTH:
            t = chip_smoke.StepTime(T0_US, 1000)
            ts = new_server(P, tmp_path / P.name, s, t, webserver_port=None)
            tc = txn_mod(P).tc
            ts.tablet_manager.create_tablet(
                "status", "txns", P.wire.schema_to_wire(tc.TXN_STATUS_SCHEMA),
                ["ts0"])
            elect(ts.tablet_manager.get_tablet("status"))
            create(P, ts)
            out[P.name] = (ts, t)
        yield out
    finally:
        s.shutdown()


def txn_ids(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
            for _ in range(n)]


def call(P, ts, t, method, **kw):
    """One service call in package P: its answer, or its error code."""
    t.arm()
    try:
        return getattr(ts.service, method)(**kw)
    except P.status.StatusError as e:
        return ("error", e.status.code.name)


def test_status_record_state_machine_equal(hosts):
    """create / heartbeat / status / commit (and its retry) / abort on
    one status tablet: equal answers and hybrid times."""
    a, b, unknown = txn_ids(3)
    got = {}
    for P in BOTH:
        ts, t = hosts[P.name]
        c = lambda m, **kw: call(P, ts, t, m, tablet_id="status", **kw)  # noqa: E731
        seq = [c("txn_create", txn_id=a), c("txn_heartbeat", txn_id=a),
               c("txn_status", txn_id=a), c("txn_create", txn_id=b)]
        seq.append(c("txn_commit", txn_id=a, participants=[]))
        seq.append(c("txn_commit", txn_id=a, participants=[]))   # retry
        seq += [c("txn_status", txn_id=a),
                c("txn_abort", txn_id=a, participants=[]),
                c("txn_heartbeat", txn_id=a),
                c("txn_status", txn_id=unknown),
                c("txn_abort", txn_id=b, participants=[]),
                c("txn_status", txn_id=b),
                c("txn_commit", txn_id=b, participants=[]),
                c("txn_commit", txn_id=unknown, participants=[])]
        got[P.name] = seq
    seq = got[PORT.name]
    assert seq == got[REF.name]
    assert seq[2] == {"status": "pending", "commit_ht": None}
    assert seq[4] == seq[5] and seq[6]["status"] == "committed"
    assert seq[7] == ("error", "ILLEGAL_STATE")
    assert seq[8] == ("error", "EXPIRED")
    assert seq[9] == seq[11] == {"status": "aborted", "commit_ht": None}
    assert seq[12] == ("error", "ABORTED") and seq[13] == ("error", "EXPIRED")


def test_expired_transaction_aborted_lazily(hosts):
    """A pending record whose heartbeat is older than
    transaction_timeout_ms reads as aborted (and is written so)."""
    (a,) = txn_ids(1, seed=9)
    got = {}
    for P in BOTH:
        ts, t = hosts[P.name]
        call(P, ts, t, "txn_create", tablet_id="status", txn_id=a)
        P.flags.set_flag("transaction_timeout_ms", 1)
        try:
            time.sleep(0.01)
            got[P.name] = [call(P, ts, t, "txn_status", tablet_id="status",
                                txn_id=a),
                           call(P, ts, t, "txn_heartbeat",
                                tablet_id="status", txn_id=a)]
        finally:
            P.flags.reset_flag("transaction_timeout_ms")
    assert got[PORT.name] == got[REF.name] == [
        {"status": "aborted", "commit_ht": None}, ("error", "EXPIRED")]


def _txn_rows(P, ts, keys):
    return [None if r is None else (sorted(r["columns"].items()),
                                    r["write_ht"])
            for r in ts.service.multi_read(
                "t1", [P.wire.doc_key_to_wire(dkey(P, k)) for k in keys])
            ["rows"]]


@pytest.mark.parametrize("outcome", ["commit", "abort"])
def test_participant_apply_and_cleanup(hosts, outcome):
    """Provisional writes on t1 under a transaction; commit applies them
    on the participant through the coordinator's apply_transaction call
    over the wire (at the commit time), abort cleans them up: equal rows
    before and after in both packages."""
    (a,) = txn_ids(1, seed=21 if outcome == "commit" else 22)
    keys = [f"x{i:02d}" for i in range(12)]
    got = {}
    for P in BOTH:
        ts, t = hosts[P.name]
        meta = txn_mod(P).intents.TransactionMetadata(a, "status")
        steps = [call(P, ts, t, "txn_create", tablet_id="status", txn_id=a)]
        t.arm()
        ts.service.write("t1", [P.wire.write_op_to_wire(op(P, k, i))
                                for i, k in enumerate(keys)],
                         txn=meta.to_wire())
        steps.append(_txn_rows(P, ts, keys))
        parts = [["t1", ts.address]]
        if outcome == "commit":
            done = call(P, ts, t, "txn_commit", tablet_id="status",
                        txn_id=a, participants=parts)
            steps.append(done)
            wait_for(lambda: None not in _txn_rows(P, ts, keys),
                     msg="the participant to apply")
        else:
            raft = ts.tablet_manager.get_tablet("t1").raft
            applied = raft.last_applied
            steps.append(call(P, ts, t, "txn_abort", tablet_id="status",
                              txn_id=a, participants=parts))
            wait_for(lambda: raft.last_applied > applied,
                     msg="the participant's cleanup to apply")
        steps.append(_txn_rows(P, ts, keys))
        got[P.name] = steps
    steps = got[PORT.name]
    assert steps == got[REF.name]
    assert steps[1] == [None] * len(keys)
    if outcome == "commit":
        commit_ht = steps[2]["commit_ht"]
        assert [r[1] for r in steps[3]] == [commit_ht] * len(keys)
        assert [r[0][0][1] for r in steps[3]] == list(range(len(keys)))
    else:
        assert steps[3] == [None] * len(keys)


def test_coordinator_rpcs_across_packages(hosts, servers):
    """A JAX Messenger drives the port's coordinator and a port Messenger
    the JAX one: the same answers."""
    a, b = txn_ids(2, seed=33)
    got = {}
    for P, C in ((PORT, REF), (REF, PORT)):
        ts, _t = hosts[P.name]
        client = servers.add(C.messenger.Messenger(f"client-{C.name}"))

        def rpc(m, **kw):
            return client.call(ts.address, "tserver", m,
                               tablet_id="status", **kw)
        rpc("txn_create", txn_id=a)
        rpc("txn_create", txn_id=b)
        ans = [rpc("txn_heartbeat", txn_id=a),
               rpc("txn_status", txn_id=a)["status"],
               rpc("txn_commit", txn_id=a, participants=[]) is not None,
               rpc("txn_status", txn_id=a)["status"],
               rpc("txn_abort", txn_id=b, participants=[]),
               rpc("txn_status", txn_id=b)]
        with pytest.raises(C.messenger.RemoteError) as ei:
            rpc("txn_heartbeat", txn_id=b)
        ans.append(ei.value.status.code.name)
        got[P.name] = ans
    assert got[PORT.name] == got[REF.name] == [
        True, "pending", True, "committed", True,
        {"status": "aborted", "commit_ht": None}, "EXPIRED"]


def test_coordinator_schema_and_flags_equal():
    """The status table's schema and the coordinator's flags are the JAX
    package's."""
    ref, port = txn_mod(REF).tc, txn_mod(PORT).tc
    assert PORT.wire.schema_to_wire(port.TXN_STATUS_SCHEMA) == \
        REF.wire.schema_to_wire(ref.TXN_STATUS_SCHEMA)
    assert (port.TRANSACTIONS_TABLE, port.SYSTEM_NAMESPACE) == \
        (ref.TRANSACTIONS_TABLE, ref.SYSTEM_NAMESPACE)
    for name in ("transaction_timeout_ms", "txn_notify_attempts"):
        assert PORT.flags.get_flag(name) == REF.flags.get_flag(name)
    assert device_free(PORT).device == "native"
