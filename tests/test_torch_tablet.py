"""The port's tablet layer against the JAX package's, on the CPU.

Twins of tests/test_tablet.py (27 cases), tests/test_backpressure.py (6),
tests/test_subdocument.py (10) and tests/test_deep_documents.py (9). Each
tablet case runs the same operations on a JAX Tablet and a port Tablet,
in two variants: device-free (TabletOptions() in the JAX package, whose
DBs take no device, and TabletOptions(device="native") in the port,
whose default is the card) and on each package's CPU
device with a device cache (the port's kernels in their plain PyTorch
versions). Both tablets draw hybrid times from one deterministic clock
(a fixed physical time each test advances by hand), so a case's answers
must be equal and, after it, the regular and intents DBs' SST files and
MANIFESTs byte-identical. test_subdocument.py's replicated case is
twinned here on the tablet's local consensus seam, and its raft half
(replication to a follower through TabletPeer) in
tests/test_torch_consensus.py. Tolerance: exact (decisions and bytes).

Also the C.1 cases: a port Tablet with device="native" opens and serves
on a machine where the port's device default (the card) would raise,
and a default-options port Tablet refuses to be built there.
"""

import importlib
import os
import threading
import time
from types import SimpleNamespace

import jax
import pytest
import torch

from tests.test_torch_env import (BOTH, PORT, REF, dir_bytes,
                                  require_reference_native)
from yugabyte_tpu_torch.storage import native_engine

pytestmark = pytest.mark.skipif(not native_engine.available(),
                                reason="native engine unavailable")

torch.set_num_threads(1)

T0_US = 1_700_000_000_000_000


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native engine loads and its process Env is
    plaintext (tests/test_torch_env.require_reference_native): the twins
    here drive its ingest_packed or native jobs."""
    require_reference_native()


def _modules(P):
    def m(name):
        return importlib.import_module(f"{P.name}.{name}")
    return SimpleNamespace(
        schema=m("common.schema"), ops=m("docdb.doc_operations"),
        lock=m("docdb.lock_manager"), mvcc=m("tablet.mvcc"),
        tablet=m("tablet.tablet"), subdoc=m("docdb.subdocument"),
        model=m("docdb.compaction_model"), slabs=m("ops.slabs"),
        baseline=m("storage.cpu_baseline"), rate=m("utils.rate_limiter"))


for _P in BOTH:
    _P.t = _modules(_P)


def schema(P):
    S = P.t.schema
    return S.Schema(columns=[S.ColumnSchema("h", S.DataType.STRING),
                             S.ColumnSchema("r", S.DataType.INT64),
                             S.ColumnSchema("v1", S.DataType.STRING),
                             S.ColumnSchema("v2", S.DataType.INT64)],
                    num_hash_key_columns=1, num_range_key_columns=1)


def tablet_options(P, variant, **kw):
    """"free": the device-free tablet (TabletOptions() in the JAX
    package, device="native" in the port); "cpu": each package's CPU
    device and device cache."""
    kw.setdefault("auto_compact", False)
    if variant == "free":
        if P is PORT:
            kw.setdefault("device", "native")
        return P.t.tablet.TabletOptions(**kw)
    if P is REF:
        d = jax.devices("cpu")[0]
        return P.t.tablet.TabletOptions(
            device=d, device_cache=P.dc.DeviceSlabCache(device=d), **kw)
    return P.t.tablet.TabletOptions(
        device="cpu", device_cache=P.dc.DeviceSlabCache("cpu"), **kw)


class Ctx:
    """One package's side of a twin: its modules, a deterministic clock,
    and the tablet factory of the variant."""

    def __init__(self, P, root, variant):
        self.P, self.root, self.variant = P, root, variant
        self.now = [T0_US]
        self.clock = P.ht.HybridClock(lambda: self.now[0])
        self.schema = schema(P)
        self.tablets = []

    def advance(self, us):
        self.now[0] += us

    def make(self, sub="t", schema_=None, clock=None, **kw):
        t = self.P.t.tablet.Tablet(
            "t-test", os.path.join(self.root, sub), schema_ or self.schema,
            clock=clock or self.clock,
            options=tablet_options(self.P, self.variant, **kw))
        self.tablets.append(t)
        return t

    def dk(self, h, r):
        return self.P.doc_key.DocKey(hash_components=(h,),
                                     range_components=(r,))

    def op(self, kind, key, values=None, **kw):
        return self.P.t.ops.QLWriteOp(
            getattr(self.P.t.ops.WriteOpKind, kind), key, values or {}, **kw)

    def insert(self, t, h, r, v1=None, v2=None, ttl_ms=None):
        vals = {}
        if v1 is not None:
            vals["v1"] = v1
        if v2 is not None:
            vals["v2"] = v2
        return t.write([self.op("INSERT", self.dk(h, r), vals,
                                ttl_ms=ttl_ms)]).value

    def row(self, r):
        return None if r is None else r.to_dict(self.schema)

    def close(self):
        for t in self.tablets:
            t.close()


def tree_bytes(root):
    """{relative path: bytes} of every SST file and MANIFEST under root."""
    out = {}
    for d, _subs, names in os.walk(root):
        if any(".sst" in n or n == "MANIFEST" for n in names):
            for name, data in dir_bytes(d).items():
                out[os.path.relpath(os.path.join(d, name), root)] = data
    return out


def twin(tmp_path, variant, scenario, files=True):
    """Run scenario(ctx) in each package; equal answers, and (files) the
    same SST files and MANIFESTs byte for byte. Returns the answer."""
    got = {}
    for P in BOTH:
        ctx = Ctx(P, str(tmp_path / P.name), variant)
        try:
            got[P.name] = scenario(ctx)
        finally:
            ctx.close()
    assert got[REF.name] == got[PORT.name]
    if files:
        a = tree_bytes(str(tmp_path / REF.name))
        b = tree_bytes(str(tmp_path / PORT.name))
        assert sorted(a) == sorted(b)
        for name in a:
            assert a[name] == b[name], name
    return got[PORT.name]


VARIANTS = pytest.mark.parametrize("variant", ["free", "cpu"])


# ------------------------------------------------------------------- mvcc
def _mvcc(P):
    clock = P.ht.HybridClock(lambda: T0_US)
    return clock, P.t.mvcc.MvccManager(clock)


def _both(fn):
    """fn(P) in each package: equal results."""
    a, b = fn(REF), fn(PORT)
    assert a == b
    return b


def test_mvcc_safe_time_advances_with_clock_when_idle():
    def case(P):
        _c, m = _mvcc(P)
        st1, st2 = m.safe_time(), m.safe_time()
        assert st2.value >= st1.value
        return st1.value, st2.value
    _both(case)


def test_mvcc_pending_write_holds_back_safe_time():
    def case(P):
        clock, m = _mvcc(P)
        ht = clock.now()
        m.add_pending(ht)
        held = m._safe_time_unlocked().value
        assert held == ht.value - 1
        m.replicated(ht)
        return held, m.safe_time().value >= ht.value
    _both(case)


def test_mvcc_out_of_order_registration_rejected():
    def case(P):
        clock, m = _mvcc(P)
        ht = clock.now()
        m.add_pending(ht)
        with pytest.raises(ValueError):
            m.add_pending(P.ht.HybridTime(ht.value - 5))
        m.replicated(ht)
        return ht.value
    _both(case)


def test_mvcc_safe_time_blocks_until_replicated():
    def case(P):
        clock, m = _mvcc(P)
        ht = clock.now()
        m.add_pending(ht)
        result = {}
        th = threading.Thread(target=lambda: result.setdefault(
            "st", m.safe_time(min_allowed=ht)))
        th.start()
        time.sleep(0.05)
        blocked = "st" not in result
        m.replicated(ht)
        th.join(timeout=5)
        return blocked, result["st"].value >= ht.value
    assert _both(case) == (True, True)


def test_mvcc_follower_uses_propagated_safe_time():
    def case(P):
        _c, m = _mvcc(P)
        m.set_leader_mode(False)
        ht = P.ht.HybridTime.from_micros(12345)
        m.set_propagated_safe_time(ht)
        a = m.safe_time_for_follower().value
        m.set_propagated_safe_time(P.ht.HybridTime.from_micros(12))
        return a, m.safe_time_for_follower().value
    a, b = _both(case)
    assert a == b


# ------------------------------------------------------------------ locks
def test_lock_conflict_matrix():
    def case(P):
        IT, conflict = P.t.lock.IntentType, P.t.lock.intents_conflict
        return [conflict(getattr(IT, a), getattr(IT, b))
                for a in ("kWeakRead", "kWeakWrite", "kStrongRead",
                          "kStrongWrite")
                for b in ("kWeakRead", "kWeakWrite", "kStrongRead",
                          "kStrongWrite")]
    got = _both(case)
    assert got[0] is False and got[-1] is True


def test_lock_weak_locks_share_prefix():
    def case(P):
        L = P.t.lock
        lm = L.SharedLockManager()
        b1 = lm.lock(L.LockBatch([(b"doc", L.IntentType.kWeakWrite),
                                  (b"doc/c1", L.IntentType.kStrongWrite)]))
        b2 = lm.lock(L.LockBatch([(b"doc", L.IntentType.kWeakWrite),
                                  (b"doc/c2", L.IntentType.kStrongWrite)]))
        held = lm.held_count()
        b1.release()
        b2.release()
        return held, lm.held_count()
    assert _both(case)[1] == 0


def test_lock_strong_blocks_weak():
    def case(P):
        L = P.t.lock
        lm = L.SharedLockManager()
        b1 = lm.lock(L.LockBatch([(b"doc", L.IntentType.kStrongWrite)]))
        first = bool(lm.try_lock(L.LockBatch([(b"doc",
                                               L.IntentType.kWeakWrite)])))
        b1.release()
        return first, bool(lm.try_lock(L.LockBatch(
            [(b"doc", L.IntentType.kWeakWrite)])))
    assert _both(case) == (False, True)


def test_lock_blocked_lock_acquires_after_release():
    def case(P):
        L = P.t.lock
        lm = L.SharedLockManager()
        b1 = lm.lock(L.LockBatch([(b"k", L.IntentType.kStrongWrite)]))
        acquired = threading.Event()

        def taker():
            b = lm.lock(L.LockBatch([(b"k", L.IntentType.kStrongWrite)]))
            acquired.set()
            b.release()

        th = threading.Thread(target=taker)
        th.start()
        time.sleep(0.05)
        before = acquired.is_set()
        b1.release()
        th.join(timeout=5)
        return before, acquired.is_set()
    assert _both(case) == (False, True)


# ---------------------------------------------------------- tablet writes
@VARIANTS
def test_insert_and_point_read(tmp_path, variant):
    def case(c):
        t = c.make()
        c.insert(t, "alice", 1, v1="hello", v2=42)
        t.flush()
        return (c.row(t.read_row(c.dk("alice", 1))),
                c.row(t.read_row(c.dk("bob", 1))),
                [c.row(r) for r in t.multi_read([c.dk("alice", 1),
                                                 c.dk("bob", 1)])])
    got = twin(tmp_path, variant, case)
    assert got[0] == {"h": "alice", "r": 1, "v1": "hello", "v2": 42}
    assert got[1] is None and got[2] == [got[0], None]


@VARIANTS
def test_update_overwrites_only_touched_columns(tmp_path, variant):
    def case(c):
        t = c.make()
        c.insert(t, "a", 1, v1="x", v2=1)
        t.write([c.op("UPDATE", c.dk("a", 1), {"v2": 2})])
        return c.row(t.read_row(c.dk("a", 1)))
    got = twin(tmp_path, variant, case)
    assert got["v1"] == "x" and got["v2"] == 2


@VARIANTS
def test_update_to_null_deletes_column(tmp_path, variant):
    def case(c):
        t = c.make()
        c.insert(t, "a", 1, v1="x", v2=1)
        t.write([c.op("UPDATE", c.dk("a", 1), {"v1": None})])
        t.flush()
        return c.row(t.read_row(c.dk("a", 1)))
    got = twin(tmp_path, variant, case)
    assert got["v1"] is None and got["v2"] == 1


@VARIANTS
def test_delete_row_then_reinsert(tmp_path, variant):
    def case(c):
        t = c.make()
        c.insert(t, "a", 1, v1="x")
        t.write([c.op("DELETE_ROW", c.dk("a", 1))])
        gone = c.row(t.read_row(c.dk("a", 1)))
        c.insert(t, "a", 1, v2=7)
        return gone, c.row(t.read_row(c.dk("a", 1)))
    gone, row = twin(tmp_path, variant, case)
    assert gone is None and row["v1"] is None and row["v2"] == 7


@VARIANTS
def test_update_alone_does_not_create_row(tmp_path, variant):
    def case(c):
        t = c.make()
        t.write([c.op("UPDATE", c.dk("u", 1), {"v1": "only"})])
        seen = c.row(t.read_row(c.dk("u", 1)))
        t.write([c.op("DELETE_COLS", c.dk("u", 1),
                      columns_to_delete=("v1",))])
        return seen, c.row(t.read_row(c.dk("u", 1)))
    seen, gone = twin(tmp_path, variant, case)
    assert seen is not None and gone is None


@VARIANTS
def test_insert_survives_deleting_all_columns(tmp_path, variant):
    def case(c):
        t = c.make()
        c.insert(t, "a", 1, v1="x")
        t.write([c.op("DELETE_COLS", c.dk("a", 1),
                      columns_to_delete=("v1",))])
        return c.row(t.read_row(c.dk("a", 1)))
    row = twin(tmp_path, variant, case)
    assert row is not None and row["v1"] is None


@VARIANTS
def test_snapshot_read_at_past_ht(tmp_path, variant):
    def case(c):
        t = c.make()
        ht1 = c.insert(t, "a", 1, v1="old")
        t.write([c.op("UPDATE", c.dk("a", 1), {"v1": "new"})])
        return (c.row(t.read_row(c.dk("a", 1)))["v1"],
                c.row(t.read_row(c.dk("a", 1),
                                 read_ht=c.P.ht.HybridTime(ht1)))["v1"])
    assert twin(tmp_path, variant, case) == ("new", "old")


@VARIANTS
def test_read_after_flush_and_compact(tmp_path, variant):
    def case(c):
        t = c.make()
        for i in range(20):
            c.insert(t, "u", i, v1=f"val{i}", v2=i)
        t.flush()
        for i in range(0, 20, 2):
            t.write([c.op("UPDATE", c.dk("u", i), {"v1": f"upd{i}"})])
        t.flush()
        t.compact()
        keys = [c.dk("u", i) for i in range(22)]
        return ([c.row(t.read_row(k)) for k in keys],
                [c.row(r) for r in t.multi_read(keys)],
                [c.row(r) for r in t.scan()])
    rows, multi, scanned = twin(tmp_path, variant, case)
    assert rows == multi and [r for r in rows if r] == scanned
    assert [r["v1"] for r in scanned] == \
        [f"upd{i}" if i % 2 == 0 else f"val{i}" for i in range(20)]


@VARIANTS
def test_ttl_expiry(tmp_path, variant):
    def case(c):
        t = c.make()
        c.insert(t, "a", 1, v1="ephemeral", ttl_ms=1)
        c.insert(t, "a", 2, v1="persistent")
        c.advance(10_000)
        return (c.row(t.read_row(c.dk("a", 1))),
                c.row(t.read_row(c.dk("a", 2))),
                [c.row(r) for r in t.multi_read([c.dk("a", 1),
                                                 c.dk("a", 2)])])
    gone, kept, multi = twin(tmp_path, variant, case)
    assert gone is None and kept is not None and multi == [None, kept]


@VARIANTS
def test_scan_returns_rows_in_key_order(tmp_path, variant):
    def case(c):
        t = c.make()
        for i in range(10):
            c.insert(t, "scan", i, v2=i * 10)
        t.flush()
        return [c.row(r) for r in t.scan()]
    rows = twin(tmp_path, variant, case)
    assert [r["r"] for r in rows] == list(range(10))
    assert all(r["v2"] == r["r"] * 10 for r in rows)


@VARIANTS
def test_scan_with_limit_pages(tmp_path, variant):
    def case(c):
        t = c.make()
        for i in range(10):
            c.insert(t, "p", i, v2=i)
        it = t.scan()
        first = [c.row(r)["r"] for r in it.rows(limit=4)]
        resume = it.next_doc_key
        rest = [c.row(r)["r"] for r in t.scan(lower_doc_key=resume)]
        return first, resume, rest
    first, resume, rest = twin(tmp_path, variant, case)
    assert len(first) == 4 and resume is not None
    assert sorted(first + rest) == list(range(10))


@VARIANTS
def test_concurrent_writers_same_row_serialize(tmp_path, variant):
    def case(c):
        t = c.make()
        errors = []

        def writer(tid):
            try:
                for i in range(25):
                    t.write([c.op("UPDATE", c.dk("hot", 0),
                                  {"v2": tid * 1000 + i})])
            except Exception as e:  # pragma: no cover
                errors.append(e)

        ths = [threading.Thread(target=writer, args=(i,)) for i in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        row = c.row(t.read_row(c.dk("hot", 0)))
        return errors, row is not None and row["v2"] is not None
    # the interleaving differs run to run: answers only
    assert twin(tmp_path, variant, case, files=False) == ([], True)


@VARIANTS
def test_concurrent_disjoint_writers(tmp_path, variant):
    def case(c):
        t = c.make()
        errors = []

        def writer(tid):
            try:
                for i in range(30):
                    c.insert(t, f"w{tid}", i, v2=i)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        ths = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        return errors, sorted((r["h"], r["r"], r["v2"])
                              for r in map(c.row, t.scan()))
    errors, rows = twin(tmp_path, variant, case, files=False)
    assert errors == [] and len(rows) == 240


@VARIANTS
def test_concurrent_reads_during_writes(tmp_path, variant):
    def case(c):
        t = c.make()
        errors = []
        stop = threading.Event()

        def reader():
            try:
                while not stop.is_set():
                    list(t.scan())
            except Exception as e:  # pragma: no cover
                errors.append(e)

        def writer():
            try:
                for i in range(200):
                    c.insert(t, "rw", i, v2=i)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        rt = threading.Thread(target=reader)
        wts = [threading.Thread(target=writer) for _ in range(2)]
        rt.start()
        for w in wts:
            w.start()
        for w in wts:
            w.join()
        stop.set()
        rt.join(timeout=10)
        return errors, len(list(t.scan()))
    assert twin(tmp_path, variant, case, files=False) == ([], 200)


@VARIANTS
def test_projection_read_of_updateonly_row(tmp_path, variant):
    def case(c):
        t = c.make()
        t.write([c.op("UPDATE", c.dk("pj", 1), {"v1": "only"})])
        cid_v2 = c.schema.column_id("v2")
        row = t.read_row(c.dk("pj", 1), projection=[cid_v2])
        multi = t.multi_read([c.dk("pj", 1)], projection=[cid_v2])[0]
        return row is not None, row.columns, multi.columns
    assert twin(tmp_path, variant, case) == (True, {}, {})


@VARIANTS
def test_write_visible_at_returned_ht(tmp_path, variant):
    def case(c):
        t = c.make()
        ht = c.insert(t, "vis", 1, v1="x")
        H = c.P.ht.HybridTime
        return (c.row(t.read_row(c.dk("vis", 1), read_ht=H(ht))),
                c.row(t.read_row(c.dk("vis", 1), read_ht=H(ht - 1))))
    seen, unseen = twin(tmp_path, variant, case)
    assert seen is not None and unseen is None


@VARIANTS
def test_split_key_is_median_doc(tmp_path, variant):
    def case(c):
        t = c.make()
        for i in range(9):
            c.insert(t, "s", i, v2=i)
        t.flush()
        sk = t.split_key()
        lower = [c.row(r)["r"] for r in t.scan(upper_doc_key=sk)]
        upper = [c.row(r)["r"] for r in t.scan(lower_doc_key=sk)]
        return sk, lower, upper
    sk, lower, upper = twin(tmp_path, variant, case)
    assert sk is not None and sorted(lower + upper) == list(range(9))
    assert 3 <= len(lower) <= 6


@VARIANTS
def test_checkpoint_restores(tmp_path, variant):
    def case(c):
        t = c.make("src")
        for i in range(5):
            c.insert(t, "c", i, v1=f"v{i}")
        t.checkpoint(os.path.join(c.root, "ckpt"))
        t2 = c.make("ckpt")
        return [c.row(r) for r in t2.scan()]
    assert len(twin(tmp_path, variant, case)) == 5


# ------------------------------------------------------------ backpressure
class FlagScope:
    """Set flags in both packages; restore on exit."""

    def __init__(self, **kv):
        self.kv, self.old = kv, {}

    def __enter__(self):
        for P in BOTH:
            for k, v in self.kv.items():
                self.old[(P.name, k)] = P.flags.get_flag(k)
                P.flags.set_flag(k, v)

    def __exit__(self, *a):
        for (name, k), v in self.old.items():
            (REF if name == REF.name else PORT).flags.set_flag(k, v)


def _kv_schema(P):
    S = P.t.schema
    return S.Schema([S.ColumnSchema("k", S.DataType.STRING),
                     S.ColumnSchema("v", S.DataType.INT64)],
                    num_hash_key_columns=0, num_range_key_columns=1)


def _kv_op(c, k, v=1, ttl_ms=None):
    return c.op("INSERT", c.P.doc_key.DocKey(range_components=(k,)),
                {"v": v}, ttl_ms=ttl_ms)


@VARIANTS
def test_write_backpressure_delays_then_rejects(tmp_path, variant):
    def case(c):
        t = c.make(schema_=_kv_schema(c.P))
        steps = []
        t.write([_kv_op(c, "a")])
        t0 = time.monotonic()
        t.write([_kv_op(c, "b")])
        steps.append(time.monotonic() - t0 < 0.1)
        for i in range(4):
            t.write([_kv_op(c, f"f{i}")])
            t.regular_db.flush()
        t0 = time.monotonic()
        t.write([_kv_op(c, "slow")])
        steps.append(time.monotonic() - t0 >= 0.05)
        rejected = None
        for i in range(6):
            try:
                t.write([_kv_op(c, f"g{i}")])
            except c.P.status.StatusError as e:
                rejected = e
                break
            t.regular_db.flush()
        steps.append((rejected is not None, "retry later" in str(rejected),
                      getattr(rejected, "extra", {}).get("throttle")))
        steps.append(t.metric_write_rejections.value() >= 1)
        t.regular_db.compact_all()
        t.write([_kv_op(c, "ok-again")])
        steps.append(t.regular_db.n_live_files)
        return steps
    with FlagScope(sst_files_soft_limit=3, sst_files_hard_limit=6,
                   write_backpressure_max_delay_ms=120):
        steps = twin(tmp_path, variant, case)
    assert steps[:2] == [True, True] and steps[2][:2] == (True, True)


@VARIANTS
def test_backpressure_keeps_l0_bounded_under_sustained_load(tmp_path,
                                                            variant):
    def case(c):
        t = c.make(schema_=_kv_schema(c.P), auto_compact=True)
        max_seen = 0
        for i in range(200):
            while True:
                try:
                    t.write([_kv_op(c, f"k{i:05d}", i)])
                    break
                except c.P.status.StatusError:
                    time.sleep(0.02)
            if i % 10 == 0:
                t.regular_db.flush()
            max_seen = max(max_seen, t.regular_db.n_live_files)
        return max_seen, [r.to_dict(t.schema) for r in t.scan()][-1]
    with FlagScope(sst_files_soft_limit=4, sst_files_hard_limit=10,
                   write_backpressure_max_delay_ms=30):
        max_seen, last = twin(tmp_path, variant, case)
    assert max_seen <= 10 and last == {"k": "k00199", "v": 199}


def test_rate_limiter_paces_bytes():
    def case(P):
        rl = P.t.rate.RateLimiter(1_000_000)
        t0 = time.monotonic()
        for _ in range(4):
            rl.acquire(250_000)
        return time.monotonic() - t0 >= 0.3, rl.total_through
    assert _both(case) == (True, 1_000_000)


@VARIANTS
def test_compaction_rate_limit_flag(tmp_path, variant):
    from tests.test_torch_env import db_options

    def case(c):
        P = c.P
        db = P.db.DB(os.path.join(c.root, "db"), db_options(P, variant))
        ht = 1
        for _batch in range(4):
            items = []
            for i in range(300):
                key = P.doc_key.DocKey(range_components=(f"r{i:04d}",)
                                       ).encode()
                items.append((key, P.ht.DocHybridTime(
                    P.ht.HybridTime(ht << 12), 0), b"v" * 40))
                ht += 1
            db.write_batch(items)
            db.flush()
        lim = P.compaction.compaction_rate_limiter()
        through = lim.total_through
        db.compact_all()
        n = db.n_live_files
        db.close()
        return lim.total_through - through, n
    # the limiter paces every output file but the last: the paced bytes
    # (equal files, so equal in both packages) rather than the wall time,
    # which the JAX package's compiles inflate
    with FlagScope(compaction_rate_bytes_per_sec=200_000,
                   compaction_max_output_entries_per_sst=300):
        paced, n = twin(tmp_path, variant, case)
    assert n == 4 and paced > 0


def _ttl_sst(P, path, ttl_all, prefix):
    ops = []
    for i in range(50):
        v = P.value.Value(b"x", ttl_ms=1 if ttl_all else None).encode()
        key = P.doc_key.DocKey(range_components=(f"{prefix}{i:03d}",)
                               ).encode()
        ops.append((key, ((i + 1) << 12) << 32, v))
    P.sst.SSTWriter(str(path)).write(P.t.slabs.pack_kvs(ops),
                                     P.sst.Frontier())
    return P.sst.SSTReader(str(path))


def _device(P):
    return jax.devices("cpu")[0] if P is REF else "cpu"


def test_whole_file_ttl_drop(tmp_path):
    def case(P):
        d = tmp_path / P.name
        d.mkdir()
        expired = _ttl_sst(P, d / "exp.sst", True, "a")
        live = _ttl_sst(P, d / "live.sst", False, "k")
        cutoff = 10_000_000_000 << 12
        C = P.compaction
        kept, dropped = C.filter_expired_inputs(
            [expired, live], cutoff, is_major=True, retain_deletes=False)
        major = (kept == [live], dropped == [expired])
        _k, minor_dropped = C.filter_expired_inputs(
            [expired, live], cutoff, is_major=False, retain_deletes=False)
        ids = iter(range(1, 100))
        (d / "out").mkdir()
        res = C.run_compaction_job([expired, live], str(d / "out"),
                                   lambda: next(ids), cutoff, True,
                                   device=_device(P))
        out = (res.rows_in, res.rows_out)
        expired.close()
        live.close()
        return (expired.props.max_expire_us > 0, live.props.max_expire_us,
                major, minor_dropped, out, dir_bytes(str(d / "out")))
    got = _both(case)
    assert got[2] == (True, True) and got[3] == [] and got[4] == (100, 50)


def test_whole_file_ttl_drop_blocked_by_overlap(tmp_path):
    def case(P):
        d = tmp_path / P.name
        d.mkdir()
        key = P.doc_key.DocKey(range_components=("k000",)).encode()
        P.sst.SSTWriter(str(d / "old.sst")).write(P.t.slabs.pack_kvs(
            [(key, (1 << 12) << 32, P.value.Value(b"old").encode())]),
            P.sst.Frontier())
        P.sst.SSTWriter(str(d / "new.sst")).write(P.t.slabs.pack_kvs(
            [(key, (9 << 12) << 32,
              P.value.Value(b"new", ttl_ms=1).encode())]), P.sst.Frontier())
        r_old = P.sst.SSTReader(str(d / "old.sst"))
        r_new = P.sst.SSTReader(str(d / "new.sst"))
        cutoff = 10_000_000_000 << 12
        _kept, dropped = P.compaction.filter_expired_inputs(
            [r_new, r_old], cutoff, is_major=True, retain_deletes=False)
        ids = iter(range(1, 10))
        (d / "out").mkdir()
        res = P.compaction.run_compaction_job(
            [r_new, r_old], str(d / "out"), lambda: next(ids), cutoff,
            True, device=_device(P))
        r_old.close()
        r_new.close()
        return dropped, res.rows_out
    assert _both(case) == ([], 0)


# ------------------------------------------------------------ subdocuments
def _sdk(c, k="doc1"):
    return c.P.doc_key.DocKey(range_components=(k,))


def _sd_write(c, db, path, doc, micros, k="doc1"):
    kvs = c.P.t.subdoc.subdocument_writes(_sdk(c, k), path, doc)
    H = c.P.ht
    db.write_batch([(key, H.DocHybridTime(H.HybridTime.from_micros(micros),
                                          i), v)
                    for i, (key, v) in enumerate(kvs)])


def _sd_delete(c, db, path, micros):
    H = c.P.ht
    db.write_batch([(k, H.DocHybridTime(H.HybridTime.from_micros(micros), 0),
                     v) for k, v in
                    c.P.t.subdoc.delete_subdocument(_sdk(c), path)])


def _sd_read(c, db, path=(), at=None):
    ht = None if at is None else c.P.ht.HybridTime.from_micros(at)
    return c.P.t.subdoc.read_subdocument(db, _sdk(c), path, read_ht=ht)


def sd_twin(tmp_path, variant, body):
    """A subdocument case over the regular DB of each package's tablet."""
    def case(c):
        return body(c, c.make().regular_db)
    return twin(tmp_path, variant, case)


@VARIANTS
def test_subdoc_write_and_read_nested(tmp_path, variant):
    doc = {"profile": {"name": "ada", "langs": {"en": True, "fr": False}},
           "age": 36}

    def body(c, db):
        _sd_write(c, db, (), doc, 1000)
        return (_sd_read(c, db), _sd_read(c, db, ("profile", "langs")),
                _sd_read(c, db, ("age",)), _sd_read(c, db, ("missing",)))
    assert sd_twin(tmp_path, variant, body) == \
        (doc, {"en": True, "fr": False}, 36, None)


@VARIANTS
def test_subdoc_deep_overwrite_shadows_subtree(tmp_path, variant):
    def body(c, db):
        _sd_write(c, db, (), {"a": {"x": 1, "y": 2}, "b": 9}, 1000)
        _sd_write(c, db, ("a",), {"z": 3}, 2000)
        return _sd_read(c, db), _sd_read(c, db, at=1500)
    assert sd_twin(tmp_path, variant, body) == \
        ({"a": {"z": 3}, "b": 9}, {"a": {"x": 1, "y": 2}, "b": 9})


@VARIANTS
def test_subdoc_primitive_overwrites_subtree_and_back(tmp_path, variant):
    def body(c, db):
        _sd_write(c, db, (), {"a": {"x": 1}}, 1000)
        _sd_write(c, db, ("a",), 42, 2000)
        out = [_sd_read(c, db, ("a",)), _sd_read(c, db)]
        _sd_write(c, db, ("a",), {"fresh": True}, 3000)
        return out + [_sd_read(c, db), _sd_read(c, db, at=2500)]
    assert sd_twin(tmp_path, variant, body) == \
        [42, {"a": 42}, {"a": {"fresh": True}}, {"a": 42}]


@VARIANTS
def test_subdoc_tombstone_deletes_subtree(tmp_path, variant):
    def body(c, db):
        _sd_write(c, db, (), {"a": {"x": 1, "deep": {"q": 7}}, "b": 2}, 1000)
        _sd_delete(c, db, ("a",), 2000)
        out = [_sd_read(c, db), _sd_read(c, db, ("a",))]
        _sd_write(c, db, ("a", "x"), 5, 3000)
        return out + [_sd_read(c, db, ("a",))]
    assert sd_twin(tmp_path, variant, body) == [{"b": 2}, None, {"x": 5}]


@VARIANTS
def test_subdoc_depth_five(tmp_path, variant):
    doc = {"l1": {"l2": {"l3": {"l4": {"l5": "deep"}}}}}

    def body(c, db):
        _sd_write(c, db, (), doc, 1000)
        out = [_sd_read(c, db), _sd_read(c, db, ("l1", "l2", "l3", "l4",
                                                 "l5"))]
        _sd_write(c, db, ("l1", "l2", "l3"), {"leaf": 1}, 2000)
        return out + [_sd_read(c, db)]
    assert sd_twin(tmp_path, variant, body) == \
        [doc, "deep", {"l1": {"l2": {"l3": {"leaf": 1}}}}]


@VARIANTS
def test_subdoc_survives_flush_and_compaction(tmp_path, variant):
    def body(c, db):
        _sd_write(c, db, (), {"a": {"x": 1, "y": 2}}, 1000)
        db.flush()
        _sd_write(c, db, ("a", "x"), 10, 2000)
        db.flush()
        before = _sd_read(c, db)
        db.compact_all()
        return before, _sd_read(c, db), db.has_deep_files()
    assert sd_twin(tmp_path, variant, body) == \
        ({"a": {"x": 10, "y": 2}}, {"a": {"x": 10, "y": 2}}, True)


@VARIANTS
def test_subdoc_tablet_api(tmp_path, variant):
    """test_subdocument.py's replicated case on the tablet's local
    consensus seam (the raft half waits for tablet_peer)."""
    def case(c):
        t = c.make()
        key = c.P.doc_key.DocKey(range_components=("userdoc",))
        t.write_subdocument(key, (), {"settings": {"theme": "dark",
                                                   "tabs": {"n": 4}}})
        out = [t.read_subdocument(key)]
        t.write_subdocument(key, ("settings", "tabs"), {"n": 8})
        out.append(t.read_subdocument(key, ("settings", "tabs")))
        t.delete_subdocument(key, ("settings",))
        out += [t.read_subdocument(key), t.read_subdocument(key,
                                                            ("settings",))]
        t.flush()
        t.compact()
        out.append(t.read_subdocument(key))
        return out
    assert twin(tmp_path, variant, case) == [
        {"settings": {"theme": "dark", "tabs": {"n": 4}}}, {"n": 8}, {},
        None, {}]


@VARIANTS
def test_subdoc_deep_path_read_sees_ancestor_overwrites(tmp_path, variant):
    def body(c, db):
        _sd_write(c, db, (), {"a": {"x": 1}}, 1000)
        _sd_delete(c, db, ("a",), 2000)
        out = [_sd_read(c, db, ("a", "x"))]
        _sd_write(c, db, ("a",), 42, 3000)
        out.append(_sd_read(c, db, ("a", "x")))
        _sd_write(c, db, ("a", "x"), 9, 4000)
        return out + [_sd_read(c, db, ("a", "x"))]
    assert sd_twin(tmp_path, variant, body) == [None, None, 9]


@VARIANTS
def test_subdoc_root_read_sees_resurrected_subtree(tmp_path, variant):
    def body(c, db):
        _sd_write(c, db, (), {"a": {"x": 1}, "b": 2}, 1000)
        _sd_delete(c, db, ("a",), 2000)
        _sd_write(c, db, ("a", "x"), 5, 3000)
        out = [_sd_read(c, db, ("a",)), _sd_read(c, db)]
        _sd_write(c, db, ("a",), 42, 4000)
        return out + [_sd_read(c, db)]
    assert sd_twin(tmp_path, variant, body) == \
        [{"x": 5}, {"a": {"x": 5}, "b": 2}, {"a": 42, "b": 2}]


@VARIANTS
def test_subdoc_rooted_read_sees_resurrection_over_stale_primitive(
        tmp_path, variant):
    def body(c, db):
        _sd_write(c, db, (), {"b": 2}, 500)
        _sd_write(c, db, ("a",), 42, 2000)
        _sd_write(c, db, ("a", "x"), 5, 3000)
        out = [_sd_read(c, db, ("a",)), _sd_read(c, db)]
        _sd_write(c, db, ("a",), 43, 4000)
        return out + [_sd_read(c, db, ("a",))]
    assert sd_twin(tmp_path, variant, body) == \
        [{"x": 5}, {"a": {"x": 5}, "b": 2}, 43]


# --------------------------------------------------------- deep documents
def _dkey(P, row, *subkeys):
    return P.doc_key.SubDocKey(P.doc_key.DocKey(range_components=(row,)),
                               tuple(subkeys)).encode(include_ht=False)


def _dht(P, us, w=0):
    return P.ht.DocHybridTime(P.ht.HybridTime.from_micros(us), w)


def _model_out(P, entries, cutoff_us, is_major):
    out = P.t.model.compact_model(
        entries, P.ht.HybridTime.from_micros(cutoff_us).value,
        is_major=is_major)
    return [(r.entry.key, r.entry.dht.ht.value, r.entry.is_tombstone)
            for r in out]


def _depth3(P):
    M, n = P.t.model.ModelEntry, len(_dkey(P, "r1"))
    return [M(_dkey(P, "r1", "col", "m1"), n, _dht(P, 10)),
            M(_dkey(P, "r1", "col"), n, _dht(P, 20), is_tombstone=True)]


@pytest.mark.parametrize("case", ["tombstone_major", "tombstone_minor",
                                  "newer_child", "multi_level",
                                  "history_above_cutoff"])
def test_model_overwrite_stack(case):
    def run(P):
        M, n = P.t.model.ModelEntry, len(_dkey(P, "r1"))
        k = lambda *s: _dkey(P, "r1", *s)  # noqa: E731
        if case == "tombstone_major":
            return _model_out(P, _depth3(P), 100, True)
        if case == "tombstone_minor":
            return _model_out(P, _depth3(P), 100, False)
        if case == "newer_child":
            return _model_out(P, [
                M(k("col", "m1"), n, _dht(P, 30)),
                M(k("col"), n, _dht(P, 20), is_tombstone=True),
                M(k("col", "m1"), n, _dht(P, 10))], 100, True)
        if case == "multi_level":
            return sorted(_model_out(P, [
                M(k(), n, _dht(P, 50), is_tombstone=True),
                M(k("a", "x"), n, _dht(P, 10)),
                M(k("b", "y"), n, _dht(P, 40)),
                M(k("b", "y"), n, _dht(P, 60))], 100, True))
        return _model_out(P, [
            M(k("col"), n, _dht(P, 20), is_tombstone=True),
            M(k("col", "m1"), n, _dht(P, 10))], 5, True)
    got = _both(run)
    want_len = {"tombstone_major": 0, "tombstone_minor": 1,
                "newer_child": 1, "multi_level": 1,
                "history_above_cutoff": 2}[case]
    assert len(got) == want_len


def _deep_slab(P, entries):
    ordered = sorted(entries, key=P.t.model.sort_key)
    V = P.value.Value
    rows = [(e.key, P.t.slabs.pack_doc_ht(e.dht),
             (V.tombstone() if e.is_tombstone else V(primitive=1)).encode())
            for e in ordered]
    return P.t.slabs.pack_kvs(rows, doc_key_lens=[e.doc_key_len
                                                  for e in ordered])


def _random_deep(P, n=600, seed=11):
    import random
    rng = random.Random(seed)
    M, dk_len = P.t.model.ModelEntry, len(_dkey(P, "r0"))
    entries, seen = [], set()
    for _ in range(n):
        row = f"r{rng.randrange(4)}"
        depth = rng.randrange(4)
        subkeys = [("col", rng.randrange(3)), f"m{rng.randrange(3)}",
                   f"n{rng.randrange(2)}"][:depth]
        e = M(_dkey(P, row, *subkeys), dk_len,
              _dht(P, rng.randrange(1, 300), rng.randrange(3)),
              is_tombstone=rng.random() < 0.2)
        if (e.key, e.dht) not in seen:
            seen.add((e.key, e.dht))
            entries.append(e)
    return entries


def test_native_matches_model_depth3():
    def run(P):
        slab = _deep_slab(P, _depth3(P))
        _order, keep, _mk = P.t.baseline.compact_cpu_baseline(
            slab, [0, slab.n], P.ht.HybridTime.from_micros(100).value, True)
        return int(keep.sum())
    assert _both(run) == 0


def test_randomized_deep_native_vs_model():
    def run(P):
        entries = _random_deep(P)
        out = []
        for cutoff_us in (50, 150, 400):
            for is_major in (False, True):
                cutoff = P.ht.HybridTime.from_micros(cutoff_us).value
                want = [(k, h) for k, h, _t in
                        _model_out(P, entries, cutoff_us, is_major)]
                slab = _deep_slab(P, entries)
                order, keep, _mk = P.t.baseline.compact_cpu_baseline(
                    slab, [0, slab.n], cutoff, is_major)
                got = [(slab.key_bytes(int(i)), slab.doc_ht(int(i)).ht.value)
                       for i, k in zip(order, keep) if k]
                assert got == want, (cutoff_us, is_major)
                out.append(got)
        return out
    _both(run)


def test_pack_kvs_sets_deep_flag():
    def run(P):
        n = len(_dkey(P, "r1"))
        V, S = P.value.Value, P.t.slabs
        slab = S.pack_kvs([
            (_dkey(P, "r1", "a"), S.pack_doc_ht(_dht(P, 1)),
             V(primitive=1).encode()),
            (_dkey(P, "r1", "a", "b"), S.pack_doc_ht(_dht(P, 2)),
             V(primitive=2).encode())], doc_key_lens=[n, n])
        return [int(f & S.FLAG_DEEP != 0) for f in slab.flags]
    assert _both(run) == [0, 1]


@VARIANTS
def test_compaction_job_routes_deep_to_native(tmp_path, variant):
    """Deep inputs through the router apply the full overwrite stack even
    with a device configured, and through a tablet's compact."""
    def run(P):
        d = tmp_path / P.name
        d.mkdir()
        path = str(d / "000001.sst")
        P.sst.SSTWriter(path).write(_deep_slab(P, _depth3(P)),
                                    P.sst.Frontier())
        dev = "native" if variant == "free" else _device(P)
        res = P.compaction.run_compaction_job(
            [P.sst.SSTReader(path)], str(d), iter(range(2, 100)).__next__,
            P.ht.HybridTime.from_micros(100).value, True, device=dev)
        return res.rows_out
    assert _both(run) == 0


# ------------------------------------------------------------------- C.1
def test_native_tablet_serves_without_cuda(tmp_path, monkeypatch):
    """TabletOptions(device="native") is the device-free tablet (what the
    JAX package's device=None means): its DBs run "native", build no
    device cache, and it opens, writes, reads, scans, flushes and
    compacts while the port's device default (the card) would raise.
    DBOptions.device=None keeps meaning the card."""
    from yugabyte_tpu_torch.storage import db as port_db
    from yugabyte_tpu_torch.utils import torch_setup

    def no_device(device=None):
        raise AssertionError(f"resolve_device({device!r}) on a "
                             "device-free tablet")

    monkeypatch.setattr(torch_setup, "resolve_device", no_device)
    c = Ctx(PORT, str(tmp_path), "free")
    t = c.make()
    for i in range(30):
        c.insert(t, "d", i, v1=f"x{i}", v2=i)
    t.flush()
    t.compact()
    assert t.regular_db.opts.device == t.intents_db.opts.device == "native"
    assert t.regular_db._device_cache is None
    assert [c.row(r)["v2"] for r in t.scan()] == list(range(30))
    assert [c.row(r)["v2"] for r in t.multi_read(
        [c.dk("d", i) for i in range(30)])] == list(range(30))
    c.close()
    with pytest.raises(AssertionError, match="resolve_device"):
        port_db.DB(str(tmp_path / "card"), port_db.DBOptions())


def test_default_tablet_refuses_without_cuda(tmp_path, monkeypatch):
    """TabletOptions() is the card, as DBOptions() is (the port's chosen
    divergence from the JAX package's device-free None): without CUDA
    the Tablet raises torch_setup's error when it is built, and builds
    no DB, native or other, on the way."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = tmp_path / "t"
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        PORT.t.tablet.Tablet("t", str(d), schema(PORT),
                             options=PORT.t.tablet.TabletOptions())
    assert not (d / "regular").exists() and not (d / "intents").exists()


def test_intents_db_takes_the_device_without_a_cache(tmp_path):
    """The device tablet's intents DB routes as the JAX one: the device,
    no device cache (no provisional record staged, point reads native),
    while the regular DB keeps the tablet's cache."""
    c = Ctx(PORT, str(tmp_path), "cpu")
    t = c.make()
    assert str(t.intents_db._device) == "cpu"
    assert t.intents_db._device_cache is None
    assert t.regular_db._device_cache is not None
    c.close()
