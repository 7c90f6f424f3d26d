"""The port's tablet-server utilities against the JAX package's, on the CPU.

- `utils/backoff`: twins of tests/test_backoff.py's Backoff and
  RetrySchedule cases, and the delay sequences of both packages drawn
  from one seeded `random.Random` equal number for number; RetryBudget
  admits and denies alike. tests/test_backoff.py::TestClientOpDeadline::
  test_master_call_surfaces_deadline_exceeded waits for the port's
  `client/` (ROADMAP queue A item 7e).
- `utils/mem_tracker`: twins of tests/test_memory_manager.py's MemTracker
  cases, each driven alike in both packages with equal trees
  (`tree_json`) after every step.
- `utils/timeseries`: twins of tests/test_telemetry.py's TimeSeriesStore
  cases, and equal rings, rates and page counters from one scripted
  source.
- `common/jsonb`, `common/wire`, `utils/jsonutil`: values made from a
  seed with numpy (and hypothesis for jsonb) go through both packages:
  equal canonical text, navigations, wire dicts, RPC-codec bytes of
  those dicts, and filter verdicts; each package decodes the other's
  dicts.

Tolerance: exact.
"""

import importlib
import json
import math
import random
import time
from types import SimpleNamespace

import jax  # noqa: F401 (the conftest pins JAX to the CPU)
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st


def package(root: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        name=root, backoff=m("utils.backoff"), mt=m("utils.mem_tracker"),
        ts=m("utils.timeseries"), jsonb=m("common.jsonb"),
        wire=m("common.wire"), jsonutil=m("utils.jsonutil"),
        flags=m("utils.flags"), schema=m("common.schema"),
        doc_key=m("docdb.doc_key"), ops=m("docdb.doc_operations"),
        ht=m("common.hybrid_time"), rows=m("docdb.doc_rowwise_iterator"),
        codec=m("rpc.codec"), partition=m("common.partition"))


REF = package("yugabyte_tpu")
PORT = package("yugabyte_tpu_torch")
BOTH = (REF, PORT)


# ------------------------------------------------------------------ backoff

@pytest.mark.parametrize("seed", [1, 7, 1234])
def test_backoff_delays_equal_and_bounded(seed):
    """Twin of TestBackoff::test_delays_bounded_and_jittered: one seed,
    the same delays in both packages; a server hint floors one delay."""
    got = {}
    for P in BOTH:
        b = P.backoff.Backoff(base_s=0.05, cap_s=1.0,
                              rng=random.Random(seed))
        delays = [b.next_delay() for _ in range(30)]
        b.note_server_hint(5000)
        delays.append(b.next_delay())
        delays += [b.next_delay() for _ in range(19)]
        got[P.name] = (delays, b.attempts)
    delays, attempts = got[PORT.name]
    assert got[PORT.name] == got[REF.name]
    assert attempts == 50
    assert delays[30] == 5.0      # the hint exceeds the cap and wins once
    rest = delays[:30] + delays[31:]
    assert all(0.0 <= d <= 1.0 for d in rest)
    assert len({round(d, 6) for d in rest}) > 10


def test_two_backoffs_desynchronize():
    """Twin of TestBackoff::test_two_backoffs_desynchronize."""
    seqs = {}
    for P in BOTH:
        a = P.backoff.Backoff(base_s=0.05, cap_s=2.0, rng=random.Random(1))
        b = P.backoff.Backoff(base_s=0.05, cap_s=2.0, rng=random.Random(2))
        seqs[P.name] = ([a.next_delay() for _ in range(5)],
                        [b.next_delay() for _ in range(5)])
        assert seqs[P.name][0] != seqs[P.name][1]
    assert seqs[PORT.name] == seqs[REF.name]


@pytest.mark.parametrize("P", BOTH, ids=lambda P: P.name)
def test_backoff_deadline_clamps_and_expires(P):
    """Twin of TestBackoff::test_deadline_clamps_and_expires and
    test_sleep_returns_true_within_deadline, and TestClientOpDeadline::
    test_backoff_remaining_clamps, in each package."""
    b = P.backoff.Backoff(base_s=10.0, cap_s=60.0, deadline_s=0.1)
    assert b.next_delay() <= 0.1
    time.sleep(0.12)
    assert b.expired and not b.sleep()
    assert P.backoff.Backoff(base_s=0.001, cap_s=0.002,
                             deadline_s=5.0).sleep()
    r = P.backoff.Backoff(base_s=0.01, cap_s=0.02, deadline_s=0.5)
    assert 0 < r.remaining_s() <= 0.5
    assert P.backoff.Backoff(base_s=0.01).remaining_s() is None


@pytest.mark.parametrize("seed", [3, 11])
def test_retry_schedule_spacing_equal_and_capped(seed):
    """Twin of TestRetrySchedule::test_exponential_spacing_capped: equal
    delays from one seed, ~2x a failure up to the cap (+-25% jitter)."""
    got = {}
    for P in BOTH:
        s = P.backoff.RetrySchedule(initial_s=0.1, max_s=1.0,
                                    rng=random.Random(seed))
        assert s.ready()
        got[P.name] = [s.record_failure() for _ in range(8)]
        assert not s.ready() and s.failures == 8
    d = got[PORT.name]
    assert d == got[REF.name]
    assert d[0] <= 0.125 and d[1] <= 0.25
    assert all(x <= 1.25 for x in d) and d[-1] >= 0.75


@pytest.mark.parametrize("P", BOTH, ids=lambda P: P.name)
def test_retry_schedule_lifecycle(P):
    """Twins of TestRetrySchedule's reset, ready-after-delay, deadline
    and unbounded cases, in each package."""
    s = P.backoff.RetrySchedule(initial_s=5.0, max_s=30.0)
    s.record_failure()
    assert not s.ready()
    s.reset()
    assert s.ready() and s.failures == 0
    s = P.backoff.RetrySchedule(initial_s=0.01, max_s=0.02)
    s.record_failure()
    deadline = time.monotonic() + 2.0
    while not s.ready():
        assert time.monotonic() < deadline
        time.sleep(0.005)
    s = P.backoff.RetrySchedule(initial_s=100.0, max_s=200.0,
                                deadline_s=0.05)
    assert s.record_failure() <= 0.05 and s.remaining_s() is not None
    time.sleep(0.07)
    assert s.expired and not s.ready()
    s = P.backoff.RetrySchedule(initial_s=0.01)
    assert s.remaining_s() is None
    for _ in range(5):
        s.record_failure()
    assert not s.expired


def test_retry_budget_admits_and_denies_alike():
    """RetryBudget with no refill: the burst admits, then each package
    raises its typed RetryBudgetExhausted with the same extra."""
    got = {}
    for P in BOTH:
        b = P.backoff.RetryBudget(capacity=5, refill_per_s=0.0)
        admitted = [b.try_spend() for _ in range(8)]
        with pytest.raises(P.backoff.RetryBudgetExhausted) as ei:
            b.spend_or_raise("op", last_err="boom")
        got[P.name] = (admitted, b.spent_total, b.exhausted_total,
                       ei.value.extra, ei.value.status.code.name)
    assert got[PORT.name] == got[REF.name]
    assert got[PORT.name][0] == [True] * 5 + [False] * 3


# -------------------------------------------------------------- mem_tracker

def _tree(t):
    """tree_json as plain JSON (tuples as lists)."""
    return json.loads(json.dumps(t.tree_json()))


def test_mem_tracker_consumption_and_limits_equal():
    """Twins of test_consumption_propagates_to_ancestors,
    test_try_consume_enforces_chain_limits and test_gc_invoked_before_
    rejection: each step's results and trees equal across packages."""
    got = {}
    for P in BOTH:
        MT = P.mt.MemTracker
        out = []
        root = MT(0, "r")
        mid = MT(0, "m", parent=root)
        leaf = MT(0, "l", parent=mid)
        leaf.consume(100)
        mid.consume(50)
        out.append((leaf.consumption(), mid.consumption(),
                    root.consumption()))
        leaf.release(40)
        out.append((root.consumption(), leaf.peak_consumption(),
                    _tree(root)))
        lroot = MT(1000, "r")
        child = MT(0, "c", parent=lroot)
        out.append([child.try_consume(900), child.try_consume(200),
                    child.consumption(), child.try_consume(100),
                    lroot.consumption(), _tree(lroot)])
        cache = {"used": 800}
        tracker = MT(1000, "cache", consumption_fn=lambda: cache["used"])
        tracker.add_gc_function(
            lambda req: cache.__setitem__(
                "used", max(0, cache["used"] - max(req, 500))))
        out.append((tracker.try_consume(300), cache["used"]))
        got[P.name] = out
    assert got[PORT.name] == got[REF.name]
    assert got[PORT.name][0] == (100, 150, 150)
    assert got[PORT.name][3] == (True, 300)


def test_mem_tracker_soft_limit_scoped_and_unregister():
    """Twins of test_soft_limit and test_scoped_consumption_and_
    unregister."""
    got = {}
    for P in BOTH:
        P.flags.set_flag("memory_limit_soft_percentage", 85)
        try:
            t = P.mt.MemTracker(1000, "t")
            t.consume(800)
            r1 = t.soft_limit_exceeded()
            t.consume(100)
            r2 = t.soft_limit_exceeded()
        finally:
            P.flags.reset_flag("memory_limit_soft_percentage")
        root = P.mt.MemTracker(0, "r")
        child = root.find_or_create_child("c")
        with P.mt.ScopedTrackedConsumption(child, 64):
            inside = root.consumption()
        child.consume(10)
        child.unregister_from_parent()
        again = root.find_or_create_child("c")
        got[P.name] = (r1.exceeded, round(r1.current_capacity_pct, 9),
                       r2.exceeded, inside, root.consumption(),
                       again is not child, _tree(root))
    assert got[PORT.name] == got[REF.name]
    assert got[PORT.name][:5] == (False, 0.8, True, 64, 0)


@pytest.mark.parametrize("P", BOTH, ids=lambda P: P.name)
def test_root_tracker_reads_rss(P):
    """Twin of test_root_tracker_reads_rss in each package (each has its
    own process root)."""
    P.mt.reset_root_for_tests()
    r = P.mt.root_tracker()
    try:
        assert r.consumption() > 0 and r.limit > 0
        assert P.mt.root_tracker() is r
        sub = r.find_or_create_child("x")
        assert "x" in r.log_usage()
        assert any(c["id"] == "x" for c in r.tree_json()["children"])
        sub.unregister_from_parent()
    finally:
        P.mt.reset_root_for_tests()


# --------------------------------------------------------------- timeseries

def test_timeseries_memory_bound_equal():
    """Twin of TestTimeSeriesStore::test_memory_bound_capacity_times_
    metric_count: equal kept series, rings and drop counts."""
    got = {}
    for P in BOTH:
        s = P.ts.TimeSeriesStore(interval_s=5.0, capacity=8, max_metrics=5)
        tick = {"n": 0}

        def src():
            tick["n"] += 1
            return {f"m{i}": float(tick["n"] * i) for i in range(10)}
        s.register_source("t", src)
        for _ in range(50):
            s.sample_once()
        assert s.total_points() <= s.memory_bound_points() == 40
        page = s.page()
        got[P.name] = (s.metric_count(), s.series_names(),
                       [[v for _t, v in s.window(n)]
                        for n in s.series_names()],
                       page["dropped_series_total"],
                       page["scrape_errors_total"])
    assert got[PORT.name] == got[REF.name]
    assert got[PORT.name][0] == 5 and got[PORT.name][3] > 0


def test_timeseries_ring_rate_and_errors_equal():
    """Twins of test_ring_wraps_keeping_newest, test_rate_and_delta_units
    and test_source_error_is_contained_and_counted."""
    got = {}
    for P in BOTH:
        r = P.ts._Ring(4)
        for i in range(10):
            r.push(float(i), float(i * 100))
        s = P.ts.TimeSeriesStore(capacity=16)
        c = P.ts._Ring(16)
        c.push(1000.0, 100.0)
        c.push(1010.0, 150.0)
        s._rings["c"] = c
        e = P.ts.TimeSeriesStore(capacity=4)

        def broken():
            raise RuntimeError("scrape boom")
        e.register_source("ok", lambda: {"good": 1.0})
        e.register_source("bad", broken)
        e.sample_once()
        got[P.name] = (r.points(), s.delta("c"), s.rate("c"),
                       s.rate("c", window_s=5.0), e.series_names(),
                       e.page()["scrape_errors_total"])
    assert got[PORT.name] == got[REF.name]
    assert got[PORT.name][0] == [(6.0, 600.0), (7.0, 700.0), (8.0, 800.0),
                                 (9.0, 900.0)]
    assert got[PORT.name][1:4] == (50.0, 5.0, 0.0)


def test_timeseries_sampler_thread_refcounted():
    """The process store's sampler: ref-counted start/stop, a joined
    thread after the last stop (the tablet server's start and shutdown
    lean on it), in the port."""
    import threading
    store = PORT.ts.timeseries_store()
    try:
        store.start(interval_s=0.01)
        store.start()
        store.stop()
        assert any(t.name == "timeseries-sampler"
                   for t in threading.enumerate())
        time.sleep(0.05)
        store.stop()
        assert not any(t.name == "timeseries-sampler"
                       for t in threading.enumerate())
        assert store.page()["samples_total"] >= 1
    finally:
        PORT.ts.reset_timeseries_store()


# ----------------------------------------------------- jsonb, wire, jsonutil

json_values = st.recursive(
    st.none() | st.booleans() | st.integers(-2**40, 2**40)
    | st.floats(allow_nan=False, allow_infinity=False) | st.text(max_size=8),
    lambda c: st.lists(c, max_size=4)
    | st.dictionaries(st.text(max_size=4), c, max_size=4),
    max_leaves=12)


@settings(max_examples=150, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(json_values, st.lists(st.one_of(st.integers(-3, 3),
                                       st.text(max_size=2)), max_size=3),
       st.booleans())
def test_jsonb_canonical_and_navigate_equal(doc, path, as_text):
    """canonicalize of a value and of its JSON text, and a -> / ->> walk
    over the stored text: the same in both packages."""
    text = json.dumps(doc)
    a = PORT.jsonb.canonicalize(text)
    assert a == REF.jsonb.canonicalize(text)
    if not isinstance(doc, str):      # a str is read as JSON text
        assert PORT.jsonb.canonicalize(doc) == a == \
            REF.jsonb.canonicalize(doc)
    assert PORT.jsonb.navigate(a, path, as_text) == \
        REF.jsonb.navigate(a, path, as_text)


@pytest.mark.parametrize("bad", ["NaN", "[Infinity]", "{bad json", 1j])
def test_jsonb_rejects_alike(bad):
    for P in BOTH:
        with pytest.raises(ValueError):
            P.jsonb.canonicalize(bad)


def _schema(P):
    S = P.schema
    return S.Schema(columns=[
        S.ColumnSchema("h", S.DataType.INT64),
        S.ColumnSchema("r", S.DataType.STRING,
                       sorting=S.SortingType.DESC),
        S.ColumnSchema("v", S.DataType.DOUBLE),
        S.ColumnSchema("s", S.DataType.STRING),
        S.ColumnSchema("j", S.DataType.JSONB),
        S.ColumnSchema("m", S.DataType.BINARY,
                       collection=("map", "TEXT", "INT"))],
        num_hash_key_columns=1, num_range_key_columns=1)


def _ops(P, rng, n):
    """n write ops of every kind the wire carries, from numpy's rng."""
    ops = []
    kinds = list(P.ops.WriteOpKind)
    for i in range(n):
        dk = P.doc_key.DocKey(hash_components=(int(rng.integers(-50, 50)),),
                              range_components=(f"r{int(rng.integers(99))}",))
        kind = kinds[i % len(kinds)]
        vals = {"v": float(rng.normal()), "s": f"s{int(rng.integers(9))}",
                "j": json.dumps({"a": int(rng.integers(5))})}
        coll = {}
        if i % 3 == 0:
            coll = {"m": [("merge", {"k%d" % int(rng.integers(4)): int(i)}),
                          ("del_keys", ["k9"])]}
        ops.append(P.ops.QLWriteOp(
            kind, dk, vals, ttl_ms=(None if i % 2 else int(rng.integers(
                1, 10_000))), columns_to_delete=(("s",) if i % 4 == 1 else ()),
            backfill_ht=(12345 << 12 if i % 5 == 0 else None),
            collection_ops=coll))
    return ops


@pytest.mark.parametrize("seed", [0, 1])
def test_wire_dicts_equal_and_decode_across(seed):
    """schema, partition, doc keys, write ops and rows: equal wire dicts
    from equal inputs, equal RPC-codec bytes of them, and each package
    decodes the other's dict back to an equal object."""
    wires = {}
    for P in BOTH:
        rng = np.random.default_rng(seed)
        sch = _schema(P)
        ops = _ops(P, rng, 24)
        row = P.rows.Row(doc_key=ops[0].doc_key,
                         columns={0: 1.5, 1: "x", 3: None},
                         write_ht=P.ht.HybridTime(77 << 12))
        wires[P.name] = {
            "schema": P.wire.schema_to_wire(sch),
            "pschema": P.wire.partition_schema_to_wire(
                P.partition.PartitionSchema(hash_partitioning=True)),
            "partition": P.wire.partition_to_wire(
                P.partition.Partition(b"\x00\x10", b"\x80")),
            "ops": [P.wire.write_op_to_wire(o) for o in ops],
            "row": P.wire.row_to_wire(row)}
    w = wires[PORT.name]
    assert w == wires[REF.name]
    assert PORT.codec.dumps(w) == REF.codec.dumps(wires[REF.name])
    for A, B in ((PORT, REF), (REF, PORT)):
        src = wires[B.name]
        assert A.wire.schema_to_wire(A.wire.schema_from_wire(
            src["schema"])) == src["schema"]
        assert [A.wire.write_op_to_wire(A.wire.write_op_from_wire(o))
                for o in src["ops"]] == src["ops"]
        assert A.wire.row_to_wire(A.wire.row_from_wire(src["row"])) == \
            src["row"]
        assert A.wire.partition_to_wire(A.wire.partition_from_wire(
            src["partition"])) == src["partition"]
        assert A.wire.row_from_wire(None) is None


def test_row_matches_equal_over_random_rows_and_filters():
    """Every filter op (jsonb paths, IN lists, LIKE, IS NULL) over rows
    made from a seed: the same verdicts in both packages, and the same
    ValueError for an unknown op."""
    rng = np.random.default_rng(5)
    ops = sorted(REF.wire.FILTER_OPS)
    assert sorted(PORT.wire.FILTER_OPS) == ops
    patterns = ["a%", "_b", "%c_", "abc", "%", "a.c"]
    verdicts = {P.name: [] for P in BOTH}
    for _ in range(400):
        row = {"x": (None if rng.random() < 0.2 else int(rng.integers(-5, 5))),
               "s": (None if rng.random() < 0.2 else "".join(
                   rng.choice(list("abc."), size=int(rng.integers(0, 4))))),
               "j": json.dumps({"a": [int(rng.integers(3)), "t"],
                                "b": {"c": bool(rng.integers(2))}})}
        flt = []
        for _k in range(int(rng.integers(1, 3))):
            op = ops[int(rng.integers(len(ops)))]
            if op in ("like", "not like"):
                flt.append(["s", op, patterns[int(rng.integers(6))]])
            elif op in ("in", "not in"):
                flt.append(["x", op, [int(v) for v in rng.integers(-5, 5, 3)]])
            elif rng.random() < 0.3:
                path = [["a", int(rng.integers(-3, 3))], ["b", "c"],
                        ["zz"]][int(rng.integers(3))]
                flt.append([["jsonb", "j", path, bool(rng.integers(2))],
                            op, "t" if rng.random() < 0.5 else "0"])
            else:
                flt.append(["x", op, int(rng.integers(-5, 5))])
        for P in BOTH:
            try:
                verdicts[P.name].append(P.wire.row_matches(row, flt))
            except TypeError as e:
                verdicts[P.name].append(type(e).__name__)
    assert verdicts[PORT.name] == verdicts[REF.name]
    assert True in verdicts[PORT.name] and False in verdicts[PORT.name]
    for P in BOTH:
        with pytest.raises(ValueError):
            P.wire.row_matches({"x": 1}, [["x", "~", 1]])


def test_jsonutil_bytes_equal_and_cross_read(tmp_path):
    """Tagged-bytes JSON: equal text, each package reads the other's
    write_atomic file back to an equal object."""
    obj = {"start": b"\x00\xff", "peers": ["ts0", "ts1"],
           "nested": [{"k": b"", "n": 3, "f": 1.5, "none": None}]}
    text = PORT.jsonutil.dumps(obj, sort_keys=True)
    assert text == REF.jsonutil.dumps(obj, sort_keys=True)
    assert PORT.jsonutil.loads(text) == REF.jsonutil.loads(text) == obj
    for A, B in ((PORT, REF), (REF, PORT)):
        p = str(tmp_path / f"{A.name}.json")
        A.jsonutil.write_atomic(p, obj)
        assert B.jsonutil.read_file(p) == obj
    assert math.isfinite(obj["nested"][0]["f"])
