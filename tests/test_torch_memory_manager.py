"""The port's TabletMemoryManager against the JAX package's, on the CPU.

- Twins of tests/test_memory_manager.py's arbiter cases (oldest-first
  flush of the global memstore, a no-op under the limit, flushing until
  under it, the block cache's GC hook, the DB's oldest-write clock) over
  the same fake tablets in both packages: the same flushes in the same
  order, the same listener calls, the same tracker trees.
- The server-owned arbiter: a TabletServer of each package with three
  tablets written unevenly; under a lowered global limit the arbiter
  flushes the tablets with the oldest writes first until the total is
  under it, and every tablet's write admission is bound to the server's
  memstore tracker; its `/memz` tree and its shutdown (the arbiter
  thread joined, the subtree unregistered) match.

The port's device-free tablet is TabletOptions(device="native").
Tolerance: exact.
"""

import importlib
import time

import jax  # noqa: F401 (the conftest pins JAX to the CPU)
import pytest

import chip_smoke
from tests.test_torch_tablet_server import (BOTH, PORT, REF, T0_US, create,
                                            new_server, write_rows)
from tests.test_torch_tablet_server import (  # noqa: F401 (fixtures)
    _isolated, _reference_native, servers)
from yugabyte_tpu_torch.storage import native_engine

pytestmark = pytest.mark.skipif(not native_engine.available(),
                                reason="native engine unavailable")


def tmm(P):
    return importlib.import_module(f"{P.name}.tserver.tablet_memory_manager")


def mt(P):
    return importlib.import_module(f"{P.name}.utils.mem_tracker")


class FakeTablet:
    def __init__(self, tablet_id, nbytes, first_write_s):
        self.tablet_id = tablet_id
        self._bytes = nbytes
        self._first = first_write_s
        self.flushes = 0

    def memstore_bytes(self):
        return self._bytes

    def oldest_memstore_write_s(self):
        return self._first if self._bytes else None

    def flush(self):
        self.flushes += 1
        self._bytes = 0
        self._first = None


class FakePeer:
    def __init__(self, tablet):
        self.tablet = tablet


def _mgr(P, peers, **kw):
    root = mt(P).MemTracker(1 << 40, "test_root")
    return tmm(P).TabletMemoryManager(lambda: peers, server_tracker=root,
                                      server_id="t0", **kw)


# name -> (limit, [(tablet id, bytes, age order)])
ARBITER = {
    "flushes_oldest_first": (1000, [("new", 600, 1), ("old", 600, 0)]),
    "noop_under_limit": (1000, [("a", 10, 0)]),
    "flushes_until_under_limit": (900, [(f"t{i}", 500, i) for i in range(4)]),
    "skips_empty_memstores": (100, [("e", 0, 0), ("f", 300, 1),
                                    ("g", 50, 2)]),
}


@pytest.mark.parametrize("case", sorted(ARBITER))
def test_arbiter_policy_equal(case):
    """Twins of test_arbiter_flushes_oldest_first, test_arbiter_noop_
    under_limit and test_arbiter_flushes_until_under_limit."""
    limit, specs = ARBITER[case]
    now = time.monotonic()
    got = {}
    for P in BOTH:
        tablets = [FakeTablet(tid, n, now + age) for tid, n, age in specs]
        tmm(P)                                   # defines the flags
        P.flags.set_flag("global_memstore_limit_bytes", limit)
        try:
            m = _mgr(P, [FakePeer(t) for t in tablets])
            seen = []
            m.flush_listeners.append(seen.append)
            flushed = m.flush_tablet_if_limit_exceeded()
            got[P.name] = (flushed, seen, [t.flushes for t in tablets],
                           m.memstore_tracker.limit,
                           m.memstore_tracker.consumption())
        finally:
            P.flags.reset_flag("global_memstore_limit_bytes")
    assert got[PORT.name] == got[REF.name]
    if case == "flushes_oldest_first":
        assert got[PORT.name][:3] == (1, ["old"], [0, 1])
    if case == "flushes_until_under_limit":
        assert got[PORT.name][:3] == (3, ["t0", "t1", "t2"], [1, 1, 1, 0])


def test_block_cache_gc_registered():
    """Twin of test_block_cache_gc_registered: the server's block cache
    under the tracker tree, its LRU evicted by the tracker's GC."""
    got = {}
    for P in BOTH:
        sst = importlib.import_module(f"{P.name}.storage.sst")
        bc = sst.BlockCache(capacity_bytes=1000)
        bc.put("a", object(), 400)
        bc.put("b", object(), 400)
        m = _mgr(P, [], block_cache=bc)
        before = m.block_cache_tracker.consumption()
        m.block_cache_tracker._gc(500)
        got[P.name] = (before, bc.used, bc.get("a") is None,
                       bc.get("b") is not None, bc.evict(1000), bc.used)
        m.shutdown()
    assert got[PORT.name] == got[REF.name] == (800, 0, True, False, 0, 0)


def test_memtable_and_db_report_oldest_write(tmp_path):
    """Twin of test_memtable_and_db_report_oldest_write: the JAX DB's
    default options and the port's device="native" DB."""
    got = {}
    for P in BOTH:
        db_mod = importlib.import_module(f"{P.name}.storage.db")
        ht = importlib.import_module(f"{P.name}.common.hybrid_time")
        opts = (db_mod.DBOptions(device="native") if P is PORT
                else db_mod.DBOptions())
        db = db_mod.DB(str(tmp_path / P.name), opts)
        try:
            steps = [db.memstore_bytes(), db.oldest_memstore_write_s()]
            db.write_batch([(b"k1", ht.DocHybridTime(ht.HybridTime(100), 0),
                             b"v1")])
            t0 = db.oldest_memstore_write_s()
            steps.append(db.memstore_bytes() > 0 and t0 is not None)
            db.write_batch([(b"k2", ht.DocHybridTime(ht.HybridTime(101), 0),
                             b"v2")])
            steps.append(db.oldest_memstore_write_s() == t0)
            steps.append(db.memstore_bytes())
            db.flush()
            steps += [db.memstore_bytes(), db.oldest_memstore_write_s()]
        finally:
            db.close()
        got[P.name] = steps
    assert got[PORT.name] == got[REF.name]
    assert got[PORT.name][:4] == [0, None, True, True]


def test_server_owned_arbiter_flushes_oldest_tablets(tmp_path, servers):
    """The TabletServer's own arbiter (twin of test_tablet_server_owns_
    memory_manager, with tablets): three tablets written oldest first;
    a global limit below their total flushes the oldest until under it;
    each tablet's admission is bound to the server's memstore tracker;
    the /memz tree names the server's subtree; shutdown unregisters it."""
    got = {}
    for P in BOTH:
        t = chip_smoke.StepTime(T0_US, 1000)
        ts = new_server(P, tmp_path / P.name, servers, t,
                        webserver_port=None)
        for i, tid in enumerate(("a", "b", "c")):
            create(P, ts, tid=tid)
            write_rows(P, ts.service, t, tid,
                       [(f"k{j:03d}", j) for j in range(40 * (i + 1))])
            time.sleep(0.002)       # distinct oldest-write stamps
        m = ts.memory_manager
        sizes = {p.tablet_id: p.tablet.memstore_bytes()
                 for p in ts.tablet_manager.peers()}
        # the server-wide budget lowered below the three memstores:
        # the oldest (a, then b) flush until c alone fits
        m.memstore_tracker.limit = sizes["c"] + 1
        seen = []
        m.flush_listeners.append(seen.append)
        flushed = (m.flush_tablet_if_limit_exceeded(), seen)
        m.bind_admission()
        bound = sorted(
            p.tablet_id for p in ts.tablet_manager.peers()
            if p.tablet.admission._memstore_tracker
            is m.memstore_tracker)
        tree = mt(P).root_tracker().tree_json()
        names = [c["id"] for c in tree["children"]]
        got[P.name] = (flushed, sorted(
            p.tablet_id for p in ts.tablet_manager.peers()
            if p.tablet.memstore_bytes() == 0), bound,
            "tserver_ts0" in names, m.memstore_tracker.limit > 0)
        servers.close(ts)
        tree = mt(P).root_tracker().tree_json()
        got[P.name] += ("tserver_ts0" in [c["id"] for c in
                                          tree["children"]],)
    assert got[PORT.name] == got[REF.name]
    assert got[PORT.name] == ((2, ["a", "b"]), ["a", "b"], ["a", "b", "c"],
                              True, True, False)
