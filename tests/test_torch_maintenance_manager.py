"""The port's MaintenanceManager against the JAX package's, on the CPU.

- Twins of tests/test_maintenance_manager.py's policy cases (the
  reference's FindBestOp: memory pressure -> most RAM anchored, WAL debt
  above log_target_replay_size -> most log bytes, else the highest
  perf_improvement, then cheap log housekeeping): the same scripted ops
  in both packages, the same op chosen and performed.
- Its real-peer case: a three-replica TabletPeer group flushed and its
  WAL GC'd by the manager, equal in both packages; and the
  TabletServer-owned manager with its scrub op and, where the server has
  a device, its prewarm op.
- Twin of tests/test_data_integrity.py::TestScrubOp::test_interval_
  gating_and_rotation.
- The port's PrewarmKernelsOp on a "cpu" device at one bounded bucket:
  the plain kernels launched, the bucket marked prewarmed on the board
  (COLD -> WARMING), the compile-surface gauges published, one-shot (the
  JAX op's counterpart compiles XLA programs: tests/test_compaction_
  pipeline.py::test_prewarm_maintenance_op_one_shot).

The port's device-free tablet is TabletOptions(device="native").
Tolerance: exact.
"""

import importlib
import os
import time
from types import SimpleNamespace

import jax  # noqa: F401 (the conftest pins JAX to the CPU)
import pytest

import chip_smoke
from tests.test_torch_consensus import PeerHarness
from tests.test_torch_consensus import PORT as CPORT
from tests.test_torch_consensus import REF as CREF
from tests.test_torch_tablet_server import (BOTH, PORT, REF, T0_US, create,
                                            new_server, write_rows)
from tests.test_torch_tablet_server import (  # noqa: F401 (fixtures)
    _isolated, _reference_native, servers)
from yugabyte_tpu_torch.storage import native_engine

pytestmark = pytest.mark.skipif(not native_engine.available(),
                                reason="native engine unavailable")


def mm(P):
    return importlib.import_module(f"{P.name}.tserver.maintenance_manager")


def scripted(P):
    M = mm(P)

    class ScriptedOp(M.MaintenanceOp):
        def __init__(self, name, ram=0, logs=0, perf=0.0, runnable=True):
            super().__init__(name)
            self.ram, self.logs, self.perf = ram, logs, perf
            self.runnable = runnable
            self.performed = 0

        def update_stats(self, stats):
            stats.runnable = self.runnable
            stats.ram_anchored = self.ram
            stats.logs_retained_bytes = self.logs
            stats.perf_improvement = self.perf

        def perform(self):
            self.performed += 1
    return ScriptedOp


# name -> (ops as (name, kwargs), memory pressure, log target MB, unregister)
CASES = {
    "memory_pressure_prefers_ram_anchored": (
        [("small", dict(ram=10, perf=100.0)), ("big", dict(ram=1000,
                                                           perf=0.1))],
        True, None, ()),
    "log_debt_prefers_log_releasing_op": (
        [("loggy", dict(logs=2 << 20)), ("perfy", dict(perf=50.0))],
        False, 1, ()),
    "perf_improvement_otherwise": (
        [("a", dict(perf=1.0)), ("b", dict(perf=9.0)),
         ("idle", dict(runnable=False, perf=99.0))], False, None, ()),
    "small_log_debt_still_collected": (
        [("loggy", dict(logs=1024))], False, None, ()),
    "nothing_runnable": ([("x", dict(runnable=False))], False, None, ()),
    "unregister": ([("x", dict(perf=1.0))], False, None, ("x",)),
    "pressure_without_ram_falls_to_perf": (
        [("p", dict(perf=2.0)), ("q", dict(perf=1.0, logs=10))],
        True, None, ()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_find_best_op_policy_equal(case):
    """Twins of tests/test_maintenance_manager.py's policy cases: the same
    pick, the same ops performed, twice in a row."""
    specs, pressure, log_mb, drop = CASES[case]
    got = {}
    for P in BOTH:
        Op = scripted(P)
        ops = {n: Op(n, **kw) for n, kw in specs}
        m = mm(P).MaintenanceManager(peers_fn=lambda: [],
                                     memory_pressure_fn=lambda: pressure)
        for o in ops.values():
            m.register_op(o)
        for n in drop:
            m.unregister_op(ops[n])
        if log_mb is not None:
            P.flags.set_flag("log_target_replay_size_mb", log_mb)
        try:
            picks = [m.run_once(), m.run_once()]
        finally:
            if log_mb is not None:
                P.flags.reset_flag("log_target_replay_size_mb")
        got[P.name] = (picks, {n: o.performed for n, o in ops.items()},
                       m.last_op_name)
    assert got[PORT.name] == got[REF.name]


def test_failing_op_is_skipped_not_fatal():
    """An op whose update_stats or perform raises is TRACEd and skipped;
    the loop's next pick proceeds (both packages)."""
    got = {}
    for P in BOTH:
        Op = scripted(P)

        class Broken(Op):
            def update_stats(self, stats):
                raise RuntimeError("boom")

        class Boom(Op):
            def perform(self):
                raise RuntimeError("boom")
        m = mm(P).MaintenanceManager(peers_fn=lambda: [],
                                     memory_pressure_fn=lambda: False)
        ok = Op("ok", perf=1.0)
        for o in (Broken("broken", perf=5.0), Boom("boom", perf=3.0), ok):
            m.register_op(o)
        got[P.name] = [m.run_once(), m.run_once(), ok.performed]
    assert got[PORT.name] == got[REF.name] == [None, None, 0]


def test_wal_gc_end_to_end(tmp_path):
    """Twin of test_wal_gc_end_to_end: a three-replica group rolls WAL
    segments; under memory pressure the manager flushes the leader
    (flush + WAL GC) and nothing is left to collect."""
    got = {}
    for P in BOTH:
        CP = CPORT if P is PORT else CREF
        root = tmp_path / P.name
        root.mkdir()
        h = PeerHarness(CP, root)
        try:
            leader = h.elect("ts0")
            for batch in range(6):
                h.write(leader, [h.op(f"r{batch:02d}{i:03d}", i)
                                 for i in range(50)])
            h.quiesce()
            m = mm(P).MaintenanceManager(peers_fn=lambda: [leader],
                                         memory_pressure_fn=lambda: True)
            name = m.run_once()
            left = leader.log.gc_candidate_bytes(leader.wal_anchor())
            got[P.name] = (name, leader.tablet.memstore_bytes(), left,
                           chip_smoke._file_sha(os.path.join(
                               leader.tablet.regular_db.db_dir, "MANIFEST")))
        finally:
            h.shutdown()
    assert got[PORT.name] == got[REF.name]
    assert got[PORT.name][:3] == ("flush:t1", 0, 0)


def test_tablet_server_owns_maintenance_manager(tmp_path, servers):
    """Twin of test_tablet_server_owns_maintenance_manager, with a
    tablet: the server's manager picks nothing without tablets or
    pressure, flushes the tablet under memory pressure, and holds its
    scrub op, alike in both packages."""
    got = {}
    for P in BOTH:
        t = chip_smoke.StepTime(T0_US, 1000)
        ts = new_server(P, tmp_path / P.name, servers, t,
                        webserver_port=None)
        m = ts.maintenance_manager
        picks = [m.run_once()]                   # no tablets
        create(P, ts)
        write_rows(P, ts.service, t, "t1", [(f"k{i}", i)
                                            for i in range(30)])
        picks.append(m.run_once())   # RAM anchored, no pressure
        m._memory_pressure = lambda: True
        picks += [m.run_once(), m.run_once()]
        registered = [op.name for op in m._registered]
        got[P.name] = (picks, registered,
                       ts.tablet_manager.get_tablet(
                           "t1").tablet.memstore_bytes())
    assert got[PORT.name] == got[REF.name]
    assert got[PORT.name] == ([None, None, "flush:t1", None],
                              ["scrub_tablets"], 0)


class _StubTablet:
    def __init__(self):
        self.scrubbed = 0

    def scrub(self, limiter=None, cancel=None):
        self.scrubbed += 1
        return {"files": 1, "blocks": 2, "entries": 10, "bytes": 100,
                "corrupt": []}


class _StubPeer:
    def __init__(self, tid):
        self.tablet_id = tid
        self.state = "RUNNING"
        self.tablet = _StubTablet()
        self.raft = SimpleNamespace(is_leader=lambda: False)
        self.scrub_state = {}


def test_scrub_op_interval_gating_and_rotation():
    """Twin of tests/test_data_integrity.py::TestScrubOp::test_interval_
    gating_and_rotation."""
    got = {}
    for P in BOTH:
        importlib.import_module(f"{P.name}.storage.integrity")  # its flags
        P.flags.set_flag("scrub_interval_s", 0.05)
        steps = []
        try:
            peers = [_StubPeer("t1"), _StubPeer("t2")]
            op = mm(P).ScrubTabletsOp(peers_fn=lambda: peers)
            stats = mm(P).MaintenanceOpStats()
            op.update_stats(stats)
            steps.append(stats.runnable)
            time.sleep(0.08)
            op.update_stats(stats)
            steps.append(stats.runnable)
            op.perform()
            op.perform()
            steps.append((peers[0].tablet.scrubbed, peers[1].tablet.scrubbed,
                          peers[0].scrub_state["files"],
                          peers[0].scrub_state["last_scrub_ts"] > 0))
            op.update_stats(stats)
            steps.append(stats.runnable)
            time.sleep(0.08)
            peers[0].state = peers[1].state = "FAILED"
            op.update_stats(stats)
            steps.append(stats.runnable)
            peers[0].state = "RUNNING"
            P.flags.set_flag("scrub_interval_s", 0.0)
            op.update_stats(stats)
            steps.append(stats.runnable)
        finally:
            P.flags.reset_flag("scrub_interval_s")
        got[P.name] = steps
    assert got[PORT.name] == got[REF.name] == [
        False, True, (1, 1, 1, True), False, False, False]


def test_prewarm_op_on_the_cpu_device_one_shot():
    """The port's PrewarmKernelsOp at one bounded bucket on device="cpu":
    runnable once, launches both is_major merge variants and the
    point-read family's plain versions, marks the bucket prewarmed on the
    board and publishes the compile-surface gauges; then unrunnable."""
    from yugabyte_tpu_torch.storage.bucket_health import WARMING, health_board
    from yugabyte_tpu_torch.utils.metrics import kernel_metrics
    M = mm(PORT)
    op = M.PrewarmKernelsOp(shapes=[(2, 512, 4, 8)], enabled_fn=lambda: True,
                            device="cpu")
    s = M.MaintenanceOpStats()
    op.update_stats(s)
    assert s.runnable and s.perf_improvement == M.PrewarmKernelsOp.PREWARM_SCORE
    board = health_board()
    op.perform()
    assert op.done
    assert board.state("run_merge_fused", (2, 512)) == WARMING
    e = kernel_metrics()
    assert e.gauge("kernel_compile_surface_buckets_count").value() >= 0
    s2 = M.MaintenanceOpStats()
    op.update_stats(s2)
    assert not s2.runnable, "prewarm op must be one-shot"
    # gated by the flag by default, and absent on a native server
    assert not M.PrewarmKernelsOp().update_stats(s2) and not s2.runnable
    ctx = importlib.import_module(
        "yugabyte_tpu_torch.tserver.server_context").ServerExecutionContext
    c = ctx(device="native")
    try:
        assert c.prewarm_op() is None
    finally:
        c.shutdown()
    c = ctx(device="cpu")
    try:
        assert isinstance(c.prewarm_op(), M.PrewarmKernelsOp)
    finally:
        c.shutdown()
