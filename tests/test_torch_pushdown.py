"""The port's query pushdown against the JAX package, on the CPU.

`filtered_entries_sources` and `aggregate_sources` of the port
(device="cpu": the plain versions of kernels G, H, I.1, B, J and K) are
held against the JAX package's functions on the same slabs and the same
compiled query, and against the host semantics: the visible entries of
the native host scan assembled into rows, then `common/wire.row_matches`
(the row-scan contract: a NULL or absent column passes `!=`) or the CQL
executor's `_match` (the aggregate contract: it fails every operator).
Every value is an integer, so equality is exact: entries in order,
aggregate dicts equal. The data are YCQL rows written by INSERT, UPDATE
(a None value is a column tombstone) and DELETE_ROW ops, with TTLs and
NULLs, flushed into sorted runs; made from a seed.
"""

import operator
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yugabyte_tpu.common.schema import ColumnSchema, DataType, Schema
from yugabyte_tpu.docdb import scan_spec as ref_ss
from yugabyte_tpu.docdb.doc_key import DocKey
from yugabyte_tpu.docdb.doc_operations import QLWriteOp, WriteOpKind
from yugabyte_tpu.docdb.doc_rowwise_iterator import VisibleEntryRowAssembler
from yugabyte_tpu.ops import merge_gc as ref_mg
from yugabyte_tpu.ops import scan as ref_scan
from yugabyte_tpu.ops.slabs import FLAG_DEEP, pack_kvs
from yugabyte_tpu_torch.common import schema as port_schema
from yugabyte_tpu_torch.docdb import scan_spec
from yugabyte_tpu_torch.ops import key_bounds, merge_gc, pushdown, scan
from yugabyte_tpu_torch.ops.slabs import slab_from_arrays
from yugabyte_tpu_torch.storage import device_cache

# The tier-1 run shares the host's cores among its workers.
torch.set_num_threads(1)

_COLS = [("h", "STRING"), ("r", "INT64"), ("v", "INT64"), ("w", "INT32"),
         ("b", "BOOL"), ("s", "STRING")]
SCHEMA = Schema([ColumnSchema(n, DataType[t]) for n, t in _COLS],
                num_hash_key_columns=1, num_range_key_columns=1)
PORT_SCHEMA = port_schema.Schema(
    [port_schema.ColumnSchema(n, port_schema.DataType[t]) for n, t in _COLS],
    num_hash_key_columns=1, num_range_key_columns=1)

_OPS = {"=": operator.eq, "!=": operator.ne, "<": operator.lt,
        ">": operator.gt, "<=": operator.le, ">=": operator.ge}
BIG = [0, 1, -1, 2 ** 40, -(2 ** 40), 2 ** 62, -(2 ** 62), 2 ** 63 - 1,
       -(2 ** 63)]
# physical microseconds between two writes, and the first write's
_STEP_US, _BASE_US = 100, 1000


def _dk(h, r):
    return DocKey(hash_components=(h,), range_components=(r,))


def _int(rng):
    return rng.choice(BIG) if rng.random() < 0.15 else rng.randint(-500, 500)


def _random_op(rng, n_docs):
    h, r = f"h{rng.randint(0, n_docs // 8)}", rng.randint(0, 7)
    roll = rng.random()
    if roll < 0.55:
        return QLWriteOp(
            WriteOpKind.INSERT, _dk(h, r),
            {"v": rng.choice([None, _int(rng), _int(rng), _int(rng)]),
             "w": rng.randint(-99, 99), "b": rng.random() < 0.5,
             "s": rng.choice([None, f"s{rng.randint(0, 9)}"])},
            ttl_ms=rng.choice([None] * 7 + [0, 5, 10 ** 9]))
    if roll < 0.85:
        vals = {}
        if rng.random() < 0.7:
            vals["v"] = rng.choice([None, _int(rng)])
        if rng.random() < 0.5:
            vals["b"] = rng.random() < 0.5
        if rng.random() < 0.3:
            vals["w"] = rng.choice([None, rng.randint(-99, 99)])
        return QLWriteOp(WriteOpKind.UPDATE, _dk(h, r), vals or {"w": 0})
    return QLWriteOp(WriteOpKind.DELETE_ROW, _dk(h, r))


def _runs(seed, n_ops=90, n_runs=3, n_docs=40, long_doc=0):
    """(JAX slabs of n_runs sorted runs, the read time after each run).
    Each op gets its own hybrid time and its entries write ids 0..k-1.
    long_doc: that many extra versions of one column of one row, so one
    document spans several kernel tiles."""
    rng = random.Random(seed)
    runs, ends = [], []
    t = 0
    for g in range(n_runs):
        entries = []
        ops = [_random_op(rng, n_docs) for _ in range(n_ops // n_runs)]
        if long_doc and g == 0:
            ops += [QLWriteOp(WriteOpKind.UPDATE, _dk("h0", 3),
                              {"v": rng.randint(-9, 9)})
                    for _ in range(long_doc)]
        for op in ops:
            t += 1
            ht = (_BASE_US + _STEP_US * t) << 12
            for wid, (k, v) in enumerate(op.to_kv_pairs(SCHEMA)):
                entries.append((k, (ht << 32) | wid, v))
        entries.sort(key=lambda e: (e[0], -e[1]))
        runs.append(pack_kvs(entries))
        ends.append((_BASE_US + _STEP_US * t) << 12)
    return runs, ends


def _port_slab(slab):
    return slab_from_arrays(
        values=slab.values, key_words=slab.key_words, key_len=slab.key_len,
        doc_key_len=slab.doc_key_len, ht_hi=slab.ht_hi, ht_lo=slab.ht_lo,
        write_id=slab.write_id, flags=slab.flags, ttl_ms=slab.ttl_ms,
        value_idx=slab.value_idx)


def _read_hts(ends):
    """Mid-run, end-of-run and above-every-write read times."""
    mid = (ends[0] + ends[-1]) // 2
    return [ends[0], mid, ends[-1] + (1 << 40)]


def _spec(preds=(), aggs=()):
    """The query compiled by the JAX package, and by the port from the
    same schema; the two must hold the same operands."""
    ref = ref_ss.ScanSpec(
        tuple(ref_ss.compile_predicate(SCHEMA, c, op, v)
              for c, op, v in preds),
        tuple(ref_ss.compile_aggregate(SCHEMA, f, c) for f, c in aggs))
    port = scan_spec.ScanSpec(
        tuple(scan_spec.compile_predicate(PORT_SCHEMA, c, op, v)
              for c, op, v in preds),
        tuple(scan_spec.compile_aggregate(PORT_SCHEMA, f, c) for f, c in aggs))
    assert port == scan_spec.scan_spec_from_reference(ref)
    return ref, port


def _sources(runs, sorted_source=True):
    ref = [ref_scan.SlabSource(s, sorted_source=sorted_source) for s in runs]
    port = [scan.SlabSource(_port_slab(s), sorted_source=sorted_source)
            for s in runs]
    return ref, port


def _rows(entries):
    return [(row.doc_key.encode(), sorted(row.columns.items()))
            for row in VisibleEntryRowAssembler(iter(entries), SCHEMA)]


def _host_rows(runs, read_ht, lower, upper):
    entries = ref_scan._visible_entries_host(runs, read_ht, lower, upper)
    return [(row, row.to_dict(SCHEMA))
            for row in VisibleEntryRowAssembler(entries, SCHEMA)]


def _wire_match(d, preds):
    from yugabyte_tpu.common.wire import row_matches
    return row_matches(d, [list(p) for p in preds])


def _host_match(d, preds):
    for c, op, val in preds:
        have = d.get(c)
        if have is None or not _OPS[op](have, val):
            return False
    return True


def _host_agg(runs, read_ht, preds, aggs, lower=None, upper=None):
    """The aggregate of the host rows under the _match contract. A BOOL
    column compiles for COUNT only: its entry holds the count alone."""
    dicts = [d for _r, d in _host_rows(runs, read_ht, lower, upper)
             if _host_match(d, preds)]
    out = {"rows": len(dicts), "cols": {}}
    for _f, c in aggs:
        if c is None:
            continue
        vals = [d[c] for d in dicts if d.get(c) is not None]
        st = {"nonnull": len(vals)}
        if SCHEMA.column(c).type is not DataType.BOOL:
            st.update(sum=sum(vals), min=min(vals) if vals else None,
                      max=max(vals) if vals else None)
        out["cols"][SCHEMA.column_id(c)] = st
    return out


def _as_host(got, aggs):
    """An aggregate partial with only what the host aggregate holds."""
    bools = {SCHEMA.column_id(c) for _f, c in aggs
             if c is not None and SCHEMA.column(c).type is DataType.BOOL}
    return {"rows": got["rows"],
            "cols": {cid: ({"nonnull": st["nonnull"]} if cid in bools
                           else st) for cid, st in got["cols"].items()}}


def _bounds(runs):
    """No bounds, each alone, both, and an upper and a lower bound longer
    than the key stride (truncated on the device)."""
    lo = _dk("h1", 0).encode()
    hi = _dk("h3", 5).encode()
    stride = 4 * merge_gc.pack_cols(_port_slab(runs[0]))[3]
    long_hi = _dk("h2", 4).encode() + b"K\x00\x02" + b"\xff" * stride
    long_lo = _dk("h0", 2).encode() + b"K\x00\x01" + b"\x00" * stride
    return [(None, None), (lo, None), (None, hi), (lo, hi), (None, long_hi),
            (long_lo, long_hi)]


# -------------------------------------------------- the filtered row scan

PRED_SETS = [
    [("v", "<", 100)],
    [("v", "=", 0)],
    [("v", "!=", 0)],
    [("v", ">", -(2 ** 40))],
    [("v", ">=", 2 ** 62)],
    [("v", "<=", -1), ("w", ">", 0)],
    [("b", "=", True)],
    [("b", "!=", False), ("w", "<", 50)],
    [("v", ">=", -50), ("v", "<", 250), ("w", "!=", 7)],
    [("w", ">", -80), ("w", "<", 80), ("v", "!=", 3), ("b", "=", False)],
    [("v", "<=", 2 ** 63 - 1), ("w", ">=", -99)],
]


@pytest.mark.parametrize("preds", PRED_SETS, ids=lambda p: repr(p)[:40])
def test_filtered_matches_reference(preds):
    runs, ends = _runs(11)
    ref_spec, port_spec = _spec(preds)
    ref_src, port_src = _sources(runs)
    for read_ht in _read_hts(ends):
        for lower, upper in _bounds(runs):
            want = list(ref_scan.filtered_entries_sources(
                ref_src, read_ht, ref_spec, lower, upper))
            got = list(scan.filtered_entries_sources(
                port_src, read_ht, port_spec, lower, upper, device="cpu"))
            assert got == want, (read_ht, lower, upper)
            host = [(r.doc_key.encode(), sorted(r.columns.items()))
                    for r, d in _host_rows(runs, read_ht, lower, upper)
                    if _wire_match(d, preds)]
            assert _rows(got) == host, (read_ht, lower, upper)


def test_filtered_without_predicates_is_the_scan():
    """No predicate (a spec the JAX package never builds for a row scan):
    every visible entry, as visible_entries_sources yields them."""
    runs, ends = _runs(12)
    _ref, port_spec = _spec()
    _r, port_src = _sources(runs)
    for read_ht in _read_hts(ends):
        for lower, upper in _bounds(runs):
            assert list(scan.filtered_entries_sources(
                port_src, read_ht, port_spec, lower, upper, device="cpu")) \
                == list(scan.visible_entries_sources(
                    port_src, read_ht, lower, upper, device="cpu"))


# ------------------------------------------------------- the aggregates

AGG_SETS = [
    [("count", None)],
    [("count", None), ("count", "v"), ("count", "b")],
    [("sum", "v"), ("min", "v"), ("max", "v")],
    [("sum", "w"), ("min", "w"), ("max", "w"), ("count", None)],
    [("sum", "v"), ("max", "w"), ("avg", "v")],
]
AGG_PREDS = [[], [("v", "<", 100)], [("b", "=", True)], [("v", "!=", 0)],
             [("w", ">=", -20), ("w", "<=", 20), ("v", ">", -(2 ** 62))]]


@pytest.mark.parametrize("aggs", AGG_SETS, ids=lambda a: repr(a)[:40])
@pytest.mark.parametrize("preds", AGG_PREDS, ids=lambda p: repr(p)[:40])
def test_aggregate_matches_reference(aggs, preds):
    runs, ends = _runs(5)
    ref_spec, port_spec = _spec(preds, aggs)
    ref_src, port_src = _sources(runs)
    for read_ht in _read_hts(ends)[1:]:
        want = ref_scan.aggregate_sources(ref_src, read_ht, ref_spec)
        got = scan.aggregate_sources(port_src, read_ht, port_spec,
                                     device="cpu")
        assert got == want
        assert _as_host(got, aggs) == _host_agg(runs, read_ht, preds, aggs)


@pytest.mark.parametrize("lower,upper", [(0, 2), (1, None), (None, 3)])
def test_aggregate_bounds(lower, upper):
    runs, ends = _runs(6)
    keys = [_dk(f"h{i}", 3).encode() for i in range(5)]
    lo = None if lower is None else keys[lower]
    hi = None if upper is None else keys[upper]
    preds, aggs = [("w", "<", 30)], [("count", None), ("sum", "v")]
    ref_spec, port_spec = _spec(preds, aggs)
    ref_src, port_src = _sources(runs)
    read_ht = ends[-1]
    want = ref_scan.aggregate_sources(ref_src, read_ht, ref_spec, lo, hi)
    got = scan.aggregate_sources(port_src, read_ht, port_spec, lo, hi,
                                 device="cpu")
    assert got == want == _host_agg(runs, read_ht, preds, aggs, lo, hi)


# ------------------------------------- sources: one, presorted or not, many


@pytest.mark.parametrize("sorted_source", [True, False])
@pytest.mark.parametrize("mode", ["filtered", "aggregate"])
def test_single_source_routes(sorted_source, mode):
    """One SST: the presorted route (no G, no I.1, B over the cols with an
    identity perm) and the merge route give the JAX answers, which are
    the same on both routes."""
    runs, ends = _runs(21, n_runs=1, n_ops=60)
    preds = [("v", "!=", 0), ("w", "<", 60)]
    aggs = [("count", None), ("sum", "v"), ("min", "w")]
    ref_spec, port_spec = _spec(preds, aggs if mode == "aggregate" else ())
    for read_ht in _read_hts(ends):
        outs = []
        for flag in (sorted_source, not sorted_source):
            ref_src, port_src = _sources(runs, sorted_source=flag)
            if mode == "filtered":
                want = list(ref_scan.filtered_entries_sources(
                    ref_src, read_ht, ref_spec))
                got = list(scan.filtered_entries_sources(
                    port_src, read_ht, port_spec, device="cpu"))
            else:
                want = ref_scan.aggregate_sources(ref_src, read_ht, ref_spec)
                got = scan.aggregate_sources(port_src, read_ht, port_spec,
                                             device="cpu")
            assert got == want
            outs.append(got)
        assert outs[0] == outs[1]


@pytest.mark.parametrize("n_runs", [2, 5])
def test_many_sources(n_runs):
    runs, ends = _runs(31 + n_runs, n_ops=30 * n_runs, n_runs=n_runs)
    preds = [("v", ">", -100)]
    ref_spec, port_spec = _spec(preds, [("count", None), ("max", "v")])
    ref_f, port_f = _spec(preds)
    ref_src, port_src = _sources(runs)
    read_ht = ends[-1]
    assert scan.aggregate_sources(port_src, read_ht, port_spec,
                                  device="cpu") \
        == ref_scan.aggregate_sources(ref_src, read_ht, ref_spec)
    assert list(scan.filtered_entries_sources(port_src, read_ht, port_f,
                                              device="cpu")) \
        == list(ref_scan.filtered_entries_sources(ref_src, read_ht, ref_f))


def test_long_document_spans_tiles():
    """One document with more entries than a kernel tile (1024) holds."""
    runs, ends = _runs(41, n_ops=60, long_doc=1500)
    preds = [("v", "<", 0)]
    aggs = [("count", None), ("sum", "v"), ("min", "v")]
    ref_a, port_a = _spec(preds, aggs)
    ref_f, port_f = _spec(preds)
    ref_src, port_src = _sources(runs)
    for read_ht in (ends[0], ends[-1]):
        assert scan.aggregate_sources(port_src, read_ht, port_a,
                                      device="cpu") \
            == ref_scan.aggregate_sources(ref_src, read_ht, ref_a)
        assert list(scan.filtered_entries_sources(port_src, read_ht, port_f,
                                                  device="cpu")) \
            == list(ref_scan.filtered_entries_sources(ref_src, read_ht,
                                                      ref_f))


def test_empty_sources():
    runs, _ends = _runs(3, n_runs=1)
    ref_spec, port_spec = _spec([], [("count", None), ("sum", "v")])
    empty = scan.SlabSource(_port_slab(runs[0]))
    empty.n = 0
    assert scan.aggregate_sources([empty], 1, port_spec, device="cpu") == \
        {"rows": 0, "cols": {port_spec.agg_cids[0]: {
            "nonnull": 0, "sum": 0, "min": None, "max": None}}}
    assert list(scan.filtered_entries_sources([], 1, port_spec,
                                              device="cpu")) == []


# ------------------------------------------------------------- refusals


def test_pushdown_unsupported_reasons():
    runs, ends = _runs(7)
    read_ht = ends[-1]
    wide = [("v", ">", i) for i in range(5)]
    three = [("sum", "v"), ("sum", "w"), ("count", "b")]
    cases = {"predicates": (wide, ()), "agg_width": ((), three)}
    for reason, (preds, aggs) in cases.items():
        ref_spec, port_spec = _spec(preds, aggs)
        ref_src, port_src = _sources(runs)
        for fn in ("filtered_entries_sources", "aggregate_sources"):
            if fn == "filtered_entries_sources" and aggs:
                continue
            with pytest.raises(ref_ss.PushdownUnsupported) as e_ref:
                getattr(ref_scan, fn)(ref_src, read_ht, ref_spec)
            with pytest.raises(scan_spec.PushdownUnsupported) as e:
                getattr(scan, fn)(port_src, read_ht, port_spec, device="cpu")
            assert e.value.reason == e_ref.value.reason == reason
    # deep documents
    deep = [pack_kvs([(b"k\x00", 5 << 44, b"I" + b"\x00" * 8)])]
    deep[0].flags[:] |= np.uint32(FLAG_DEEP)
    ref_spec, port_spec = _spec([("v", "<", 1)])
    with pytest.raises(scan_spec.PushdownUnsupported, match="deep"):
        scan.filtered_entries_sources(_sources(runs + deep)[1], read_ht,
                                      port_spec, device="cpu")
    with pytest.raises(ref_ss.PushdownUnsupported, match="deep"):
        ref_scan.filtered_entries_sources(_sources(runs + deep)[0], read_ht,
                                          ref_spec)
    # a bound wider than the key stride has no host re-check in aggregates
    long_hi = _bounds(runs)[-1][1]
    ref_spec, port_spec = _spec([], [("count", None)])
    with pytest.raises(scan_spec.PushdownUnsupported, match="bound_width"):
        scan.aggregate_sources(_sources(runs)[1], read_ht, port_spec,
                               upper_key=long_hi, device="cpu")
    with pytest.raises(ref_ss.PushdownUnsupported, match="bound_width"):
        ref_scan.aggregate_sources(_sources(runs)[0], read_ht, ref_spec,
                                   upper_key=long_hi)
    # a source without a host slab to stage values from
    src = _sources(runs)[1]
    src[0].slab = None
    _r, port_spec = _spec([("v", "<", 1)])
    with pytest.raises(scan_spec.PushdownUnsupported, match="vals"):
        scan.filtered_entries_sources(src, read_ht, port_spec, device="cpu")
    # more entries than the byte sums hold exactly (n_pad > 2^24)
    src = _sources(runs)[1]
    src[0].n = (1 << 24) + 1
    with pytest.raises(scan_spec.PushdownUnsupported, match="batch_size"):
        scan.aggregate_sources(src, read_ht, port_spec, device="cpu")


def test_resident_source_raises(tmp_path):
    """ResidentSource inputs (SSTs whose cols and value words the device
    cache holds, staged with include_vals=True) answer both pushdown
    scans exactly as SlabSource inputs and the JAX package, on the
    multi-source and the presorted route, with pad rows masked; a
    resident source without value words raises PushdownUnsupported("vals")
    for a query that reads values, and serves one that does not."""
    from yugabyte_tpu_torch.storage.sst import SSTReader, SSTWriter
    runs, ends = _runs(31)
    cache = device_cache.DeviceSlabCache("cpu")
    readers = []
    for i, s in enumerate(runs):
        path = str(tmp_path / f"{i:06d}.sst")
        SSTWriter(path).write(_port_slab(s))
        readers.append(SSTReader(path))
        cache.stage(i, readers[-1].read_all(), include_vals=True)
    res = [scan.ResidentSource(r, cache.get(i)) for i, r in enumerate(readers)]
    preds, aggs = [("v", "<", 100), ("w", ">", -60)], [("count", None),
                                                        ("sum", "v")]
    ref_f, port_f = _spec(preds)
    ref_a, port_a = _spec(preds, aggs)
    ref_src, port_src = _sources(runs)
    for k in (len(runs), 1):
        for read_ht in _read_hts(ends):
            want = list(ref_scan.filtered_entries_sources(
                ref_src[:k], read_ht, ref_f))
            assert list(scan.filtered_entries_sources(
                res[:k], read_ht, port_f, device="cpu")) == want == list(
                scan.filtered_entries_sources(port_src[:k], read_ht, port_f,
                                              device="cpu"))
            want = ref_scan.aggregate_sources(ref_src[:k], read_ht, ref_a)
            assert scan.aggregate_sources(res[:k], read_ht, port_a,
                                          device="cpu") == want
    bare = device_cache.DeviceSlabCache("cpu")
    st = bare.stage(0, readers[0].read_all())
    no_vals = [scan.ResidentSource(readers[0], st)]
    with pytest.raises(scan_spec.PushdownUnsupported, match="vals"):
        scan.aggregate_sources(no_vals, ends[-1], port_a, device="cpu")
    ref_c, port_c = _spec([], [("count", None)])
    assert scan.aggregate_sources(no_vals, ends[-1], port_c, device="cpu") \
        == ref_scan.aggregate_sources(ref_src[:1], ends[-1], ref_c)
    for r in readers:
        r.close()


# ---------------------------------------- the compiled query and operands


@pytest.mark.parametrize("wire", [True, False])
def test_operands_match_reference(wire):
    preds = [("v", "!=", -(2 ** 63)), ("w", "<=", 7), ("b", "=", False),
             ("v", ">", 2 ** 63 - 1)]
    aggs = [("sum", "v"), ("count", "b")]
    ref_spec, port_spec = _spec(preds, aggs)
    for p_pad in (4,):
        want = ref_scan._pack_predicate_operands(ref_spec, p_pad, wire)
        got = scan._pack_predicate_operands(port_spec, p_pad, wire)
        for g, w_ in zip(got, want):
            assert g.dtype == w_.dtype and np.array_equal(g, w_)
    for g, w_ in zip(scan._pack_agg_operands(port_spec, 2),
                     ref_scan._pack_agg_operands(ref_spec, 2)):
        assert np.array_equal(g, w_)


def test_compile_subset_matches_reference():
    for col, op, val in [("s", "=", "x"), ("v", "<", 1.5), ("v", "=", True),
                         ("v", "=", None), ("h", "=", "k"), ("b", "<", 1),
                         ("v", "like", 1), ("nope", "=", 1)]:
        assert ref_ss.compile_predicate(SCHEMA, col, op, val) is None
        assert scan_spec.compile_predicate(PORT_SCHEMA, col, op, val) is None
    for fn, col in [("sum", "s"), ("sum", "b"), ("median", "v"),
                    ("count", "r"), ("max", None)]:
        assert ref_ss.compile_aggregate(SCHEMA, fn, col) is None
        assert scan_spec.compile_aggregate(PORT_SCHEMA, fn, col) is None
    filters = [["v", "<", 3], ["s", "=", "x"]]
    ref = ref_ss.compile_filters(SCHEMA, filters)
    port = scan_spec.compile_filters(PORT_SCHEMA, filters)
    assert port[0] == scan_spec.scan_spec_from_reference(ref[0])
    assert port[1:] == ref[1:]
    parts = [{"rows": 2, "cols": {1: {"nonnull": 1, "sum": 5, "min": 5,
                                      "max": 5}}},
             {"rows": 1, "cols": {1: {"nonnull": 2, "sum": -1, "min": -3,
                                      "max": 2}}}]
    assert scan_spec.combine_agg_partials(parts) == \
        ref_ss.combine_agg_partials(parts)


def test_pack_vals_matches_reference():
    runs, _ends = _runs(13)
    for s in runs:
        n_pad = ref_mg.bucket_size(s.n)
        assert np.array_equal(scan.pack_vals(_port_slab(s), n_pad),
                              ref_scan.pack_vals(s, n_pad))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pack_vals_control_fields_match_reference(seed):
    """Payloads behind merge flags and a TTL, cut control fields, empty
    and long payloads, in a permuted value order."""
    rng = random.Random(seed)
    vals = []
    for _ in range(300):
        pre = b""
        if rng.random() < 0.3:
            pre += b"k" + bytes(rng.randrange(256) for _ in range(4))
        if rng.random() < 0.3:
            pre += b"t" + bytes(rng.randrange(256) for _ in range(8))
        if rng.random() < 0.1:
            pre = pre[:rng.randrange(len(pre) + 1)]
        vals.append(pre + bytes(rng.randrange(256)
                                for _ in range(rng.randrange(0, 20))))
    ref = pack_kvs([(b"k%05d" % i, 5 << 44, b"$") for i in range(300)])
    ref.values = vals
    ref.value_idx = np.array(rng.sample(range(300), 300), dtype=np.int32)
    assert np.array_equal(scan.pack_vals(_port_slab(ref), 512),
                          ref_scan.pack_vals(ref, 512))


def test_concat_vals_matches_reference():
    runs, _ends = _runs(14, n_runs=3)
    vals = [ref_scan.pack_vals(s, ref_mg.bucket_size(s.n)) for s in runs]
    ns = [s.n for s in runs]
    n_pad = ref_mg.bucket_size(sum(ns))
    want = np.asarray(ref_scan.concat_vals([jnp.asarray(v) for v in vals],
                                           ns, n_pad))
    got = scan.concat_vals([merge_gc.u32_to_device(v, "cpu") for v in vals],
                           ns, n_pad)
    assert np.array_equal(got.numpy().view(np.uint32), want)


# ------------------------- kernels J and K (plain) against the JAX programs


def _staged_inputs(runs):
    """The port's staged cols and vals of the runs (the JAX package's
    staging equals them: tests/test_torch_scan.py, test_concat_vals_*)."""
    port_st = [merge_gc.stage_slab(_port_slab(s), "cpu") for s in runs]
    port = device_cache.concat_staged(port_st) if len(runs) > 1 \
        else port_st[0]
    vals = scan.concat_vals(
        [merge_gc.u32_to_device(scan.pack_vals(_port_slab(s), st.n_pad),
                                "cpu") for s, st in zip(runs, port_st)],
        [st.n for st in port_st], port.n_pad)
    return port, vals


def _limbs(cutoff):
    phys = cutoff >> 12
    return (jnp.uint32(cutoff >> 32), jnp.uint32(cutoff & 0xFFFFFFFF),
            jnp.uint32(phys >> 20), jnp.uint32(phys & 0xFFFFF))


def _jax_bounds(bounds):
    lo_w, lo_l, hi_w, hi_l, up_inf, up_trunc = bounds
    return (jnp.asarray(lo_w), jnp.int32(lo_l), jnp.asarray(hi_w),
            jnp.int32(hi_l), jnp.bool_(up_inf), jnp.bool_(up_trunc))


@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("preds,aggs", [
    ([("v", "<", 10)], [("sum", "v")]),
    ([("v", "!=", 0), ("b", "=", True)], [("min", "w"), ("max", "v")]),
    ([("w", ">", 0), ("w", "<", 90), ("v", ">=", -(2 ** 62))],
     [("count", None)]),
    ([], [("count", None)])])
def test_kernel_plain_versions_match_jax_programs(presorted, preds, aggs):
    """J.1-J.3 and K's plain versions, chained as the scans chain them,
    equal the JAX `_scan_filtered_fused` / `_scan_agg_fused` on the same
    cols and vals, for every predicate-slot and aggregate-slot lattice
    size that holds the query."""
    runs, ends = _runs(51, n_runs=1 if presorted else 3)
    ref_spec, port_spec = _spec(preds, aggs)
    staged, vals = _staged_inputs(runs)
    cols_j = jnp.asarray(staged.cols_dev.numpy().view(np.uint32))
    vals_j = jnp.asarray(vals.numpy().view(np.uint32))
    sort_rows = jnp.asarray(staged.sort_rows)
    has_vals = port_spec.needs_vals
    bounds, _lo, _hi = scan._bound_operands(staged, _dk("h1", 2).encode(),
                                            None)
    for read_ht in _read_hts(ends):
        for p_pad in [p for p in scan.PRED_SLOTS if p >= len(preds)]:
            p_ops = scan._pack_predicate_operands(port_spec, p_pad, True)
            perm, keep_p = ref_scan._scan_filtered_fused(
                cols_j, vals_j, sort_rows, jnp.int32(staged.n_sort),
                *_limbs(read_ht), *_jax_bounds(bounds),
                *(jnp.asarray(a) for a in p_ops), w=staged.w, p_pad=p_pad,
                presorted=presorted)
            t_perm, t_keep = scan._scan_filtered_fused(
                staged.cols_dev, vals if preds else None, staged.sort_rows,
                staged.n_sort, read_ht, bounds, p_ops, staged.w, presorted)
            assert np.array_equal(t_perm.numpy(), np.asarray(perm))
            assert np.array_equal(t_keep.numpy().view(np.uint32),
                                  np.asarray(keep_p))
            p_ops = scan._pack_predicate_operands(port_spec, p_pad)
            for c_pad in [c for c in scan.AGG_SLOTS
                          if c >= len(port_spec.agg_cids)]:
                a_ops = scan._pack_agg_operands(port_spec, c_pad)
                want = ref_scan._scan_agg_fused(
                    cols_j, vals_j if has_vals else jnp.zeros((4, 1),
                                                              jnp.uint32),
                    sort_rows, jnp.int32(staged.n_sort), *_limbs(read_ht),
                    *_jax_bounds(bounds), *(jnp.asarray(a) for a in p_ops),
                    *(jnp.asarray(a) for a in a_ops), w=staged.w,
                    p_pad=p_pad, c_pad=c_pad, has_vals=has_vals,
                    presorted=presorted)
                acc, ext = scan._scan_agg_fused(
                    staged.cols_dev, vals if has_vals else None,
                    staged.sort_rows, staged.n_sort, read_ht, bounds, p_ops,
                    a_ops, staged.w, c_pad, has_vals, presorted)
                got = pushdown.decode_agg(acc, ext, c_pad)
                assert got[0] == int(want[0])
                for g, w_ in zip(got[1:], want[1:]):
                    assert np.array_equal(np.asarray(g, np.int64),
                                          np.asarray(w_).astype(np.int64))


def test_segment_or_crosses_documents_exactly():
    """J.2's plain version against a per-document loop and the JAX
    `_segment_any` per bit, with documents of one entry, of many entries,
    and a first lane without a start flag."""
    rng = np.random.default_rng(3)
    n = 3000
    starts = rng.random(n) < 0.05
    starts[0] = False
    flags = rng.integers(0, 1 << 9, size=n) & ~(1 << 8)
    flags |= starts.astype(np.int64) << 8
    got = pushdown.segment_or_plain(torch.from_numpy(flags).to(torch.int32))
    want = np.zeros(n, np.int64)
    bounds = [0] + list(np.flatnonzero(starts)) + [n]
    for a, b in zip(bounds[:-1], bounds[1:]):
        want[a:b] = np.bitwise_or.reduce(flags[a:b] & 0x1F)
    assert np.array_equal(got.numpy(), want)
    new_seg = jnp.asarray(starts)
    end_seg = jnp.asarray(np.append(starts[1:], True))
    # jitted as the JAX package's programs run it: one compile for the
    # five bits instead of each eager operation's
    segment_any = jax.jit(ref_scan._segment_any)
    for b in range(5):
        bit = segment_any(jnp.asarray((flags >> b) & 1 == 1), new_seg,
                          end_seg)
        assert np.array_equal((got.numpy() >> b) & 1 == 1, np.asarray(bit))


# ------------------------------------- the bounds as kernels I.2 and J.1 take them


def _bound_words(kb):
    """The (lo_words, lo_len, hi_words, hi_len) a by-value struct holds."""
    words = np.ctypeslib.as_array(kb.words)[:2 * kb.w].copy()
    return words[:kb.w], kb.lo_len, words[kb.w:], kb.hi_len


@pytest.mark.parametrize("w", [1, 2, 8, 64, key_bounds.BOUND_CAP])
@pytest.mark.parametrize("kind", ["empty", "zeros", "ones", "random"])
def test_key_bounds_by_value_round_trip(w, kind):
    """Every bound a key stride of w words can hold (any u32 words, any
    length from 0 to 4w bytes, both bounds set or empty) rides in the
    kernels' by-value struct and reads back unchanged, up to the cap."""
    rng = np.random.default_rng(w)
    for lo_l, hi_l in ((0, 0), (1, 4 * w), (4 * w, 4 * w - 1),
                       (int(rng.integers(0, 4 * w + 1)), 3)):
        if kind == "empty":
            lo, lo_l = np.zeros(w, np.uint32), 0
            hi = np.zeros(w, np.uint32)
        elif kind == "zeros":
            lo, hi = np.zeros(w, np.uint32), np.zeros(w, np.uint32)
        elif kind == "ones":
            lo = np.full(w, 0xFFFFFFFF, np.uint32)
            hi = np.full(w, 0xFFFFFFFF, np.uint32)
        else:
            lo = rng.integers(0, 1 << 32, size=w, dtype=np.uint64) \
                .astype(np.uint32)
            hi = rng.integers(0, 1 << 32, size=w, dtype=np.uint64) \
                .astype(np.uint32)
        kb, dev_words = key_bounds.key_bounds(lo, lo_l, hi, hi_l, w)
        assert dev_words is None and not kb.dev and kb.w == w
        got_lo, got_lo_l, got_hi, got_hi_l = _bound_words(kb)
        assert np.array_equal(got_lo, lo) and np.array_equal(got_hi, hi)
        assert (got_lo_l, got_hi_l) == (lo_l, hi_l)
        # the words past 2w stay zero
        assert not np.ctypeslib.as_array(kb.words)[2 * w:].any()


def test_key_bounds_from_the_scan_round_trip():
    """The scan's own packing (`_pack_bound`, a key of up to the stride)
    round-trips through the struct; a wrong word count is refused."""
    w = 8
    for key in (b"", b"S", b"Suser00001234\x00\x00!K\x00\x01",
                b"\xff" * (4 * w)):
        words, length = scan._pack_bound(key or None, w)
        kb, _ = key_bounds.key_bounds(words, length, words, length, w)
        got = _bound_words(kb)
        assert np.array_equal(got[0], words) and got[1] == length
        assert np.array_equal(got[2], words) and got[3] == length
    with pytest.raises(ValueError):
        key_bounds.key_bounds(np.zeros(3, np.uint32), 0,
                              np.zeros(4, np.uint32), 0, 4)


def test_key_bounds_fit_a_launch():
    """The struct holds both bounds' words up to the cap and fits, with
    J.1's operand struct and its other arguments, in a launch's 4 KB of
    parameters; the words sit where csrc/key_bounds.cuh puts them."""
    import ctypes
    kb = key_bounds.KeyBounds
    assert kb.words.offset == 0
    assert kb.dev.offset == 8 * key_bounds.BOUND_CAP
    assert ctypes.sizeof(kb) == 8 * key_bounds.BOUND_CAP + 24
    # J.1's operand struct holds, per slot, two 64-bit keys and six words,
    # per aggregate slot three words, and the two slot counts
    ops_bytes = pushdown.MAX_PRED * (2 * 8 + 6 * 4) \
        + pushdown.MAX_AGG * 3 * 4 + 8
    assert ctypes.sizeof(kb) + ops_bytes + 8 * 8 <= 4096


# ------------------- kernel J.2: its layouts, its tile decomposition, its host side

_J2_TILE = pushdown.SEGMENT_OR_TILE
_J2_N = 3 * _J2_TILE + 5            # neither a multiple of the tile nor of 4
_J2_LAYOUTS = ["dense", "sparse", "every_lane", "tile_edges", "tile_plus_one",
               "one_segment", "no_first_start", "ends_at_last"]


def _j2_flags(layout: str, n: int, tile: int, seed: int = 0) -> np.ndarray:
    """Flag words (int64) of J.2's adversarial layouts: random bits 0-7 (the
    OR'ed bits 0-4 and bits J.2 ignores) and the start bit 8 where the
    layout puts it: segments ending exactly at tile edges (`tile_edges`),
    a tile's first entry ending a segment begun in an earlier tile
    (`tile_plus_one`), one segment over every tile, a first lane with no
    start, and a last segment crossing a tile edge to lane n - 1."""
    rng = np.random.default_rng(seed)
    flags = rng.integers(0, 1 << 8, size=n, dtype=np.int64)
    if layout == "dense":
        starts = rng.random(n) < 0.3
    elif layout == "sparse":
        starts = rng.random(n) < 2e-3
    elif layout == "every_lane":
        starts = np.ones(n, bool)
    elif layout in ("tile_edges", "tile_plus_one"):
        starts = rng.random(n) < 0.01
        starts[(1 if layout == "tile_plus_one" else 0)::tile] = True
    elif layout == "one_segment":
        starts = np.zeros(n, bool)
        starts[0] = True
    elif layout == "no_first_start":
        starts = rng.random(n) < 0.01
        starts[0] = False
    else:  # ends_at_last
        starts = rng.random(n) < 0.05
        last = max(0, n - tile - 7)
        starts[last:] = False
        starts[last] = True
    return flags | (starts.astype(np.int64) << pushdown.NEW_DOC_BIT)


_segment_any_bits = jax.jit(jax.vmap(ref_scan._segment_any,
                                     in_axes=(0, None, None)))


def _jax_segment_or(flags: np.ndarray) -> np.ndarray:
    """Bits 0-4 of each entry's output by the JAX `_segment_any`, one call
    for all five bits (new_doc as the JAX `_doc_segments` gives it: lane 0
    always starts)."""
    starts = (flags >> pushdown.NEW_DOC_BIT) & 1 == 1
    starts[0] = True
    bits = np.stack([(flags >> b) & 1 == 1 for b in range(5)])
    got = np.asarray(_segment_any_bits(jnp.asarray(bits), jnp.asarray(starts),
                                       jnp.asarray(np.append(starts[1:],
                                                             True))))
    return sum(got[b].astype(np.int64) << b for b in range(5))


@pytest.mark.parametrize("layout,n", [(name, _J2_N) for name in _J2_LAYOUTS]
                         + [("dense", 32), ("one_segment", 32)])
def test_segment_or_layouts_match_jax(layout, n):
    """The J.2 wrapper on CPU tensors (its plain version) equals the JAX
    `_segment_any` on each adversarial layout."""
    flags = _j2_flags(layout, n, _J2_TILE)
    got = pushdown.segment_or(torch.from_numpy(flags).to(torch.int32))
    assert np.array_equal(got.numpy().astype(np.int64), _jax_segment_or(flags))


def _segment_or_model(flags: np.ndarray, tile: int):
    """A model of kernel J.2's decomposition (csrc/pushdown.cu
    segment_or_kernel): main CTAs over the tiles in ticket order, the
    forward OR chained with the carry (the OR since the last start); each
    entry with a segment end after it inside its tile written with the
    forward OR at the nearest such end; the tile's record (the nearest end
    from its first entry, where its tail starts); then the tail CTAs from
    the last tile down, chaining the nearest end beyond each tile, each
    writing its tile's tail. Returns the output and the number of writes
    of each entry."""
    n = len(flags)
    f = flags & 0x1F
    starts = (flags >> pushdown.NEW_DOC_BIT) & 1 == 1
    starts[0] = True
    ends = np.append(starts[1:], True)
    out = np.zeros(n, np.int64)
    writes = np.zeros(n, np.int64)
    records = []
    v = 0                           # the forward carry
    for t0 in range(0, n, tile):
        t1 = min(t0 + tile, n)
        fwd = np.zeros(t1 - t0, np.int64)
        for i in range(t0, t1):
            v = (0 if starts[i] else v) | int(f[i])
            fwd[i - t0] = v
        near, tail = None, t0       # the nearest end; the tail's start
        for i in range(t1 - 1, t0 - 1, -1):
            if ends[i]:
                if near is None:
                    tail = i + 1
                near = fwd[i - t0]
            if near is not None:
                out[i] = near
                writes[i] += 1
        records.append((near, tail, t1))
    after = None                    # the nearest end beyond the tile
    for near, tail, t1 in reversed(records):
        out[tail:t1] = -1 if after is None else after
        writes[tail:t1] += 1
        after = near if near is not None else after
    return out, writes


@pytest.mark.parametrize("tile", [64, _J2_TILE])
@pytest.mark.parametrize("layout", _J2_LAYOUTS)
def test_segment_or_tile_model(layout, tile):
    """J.2's decomposition over tiles (the main CTAs' writes, the tail
    CTAs' chain over the tiles' records) gives the plain version's output
    and writes every entry exactly once, at the kernel's tile and at a
    small one where most segments cross tiles."""
    flags = _j2_flags(layout, _J2_N, tile, seed=1)
    out, writes = _segment_or_model(flags, tile)
    want = pushdown.segment_or_plain(torch.from_numpy(flags).to(torch.int32))
    assert np.array_equal(out, want.numpy().astype(np.int64))
    assert (writes == 1).all()


@pytest.mark.parametrize("n", [1, 4, 32, _J2_TILE - 1, _J2_TILE, _J2_TILE + 1,
                               _J2_N, 1 << 24])
def test_segment_or_layout(n):
    """The wrapper's one allocation: the output from word 0, rounded up to
    16 bytes, then per tile three 64-bit words (two status words and a
    record) and the ticket, 8-byte aligned (csrc/pushdown.cu
    ybt_segment_or)."""
    out_words, words = pushdown.segment_or_layout(n)
    assert out_words >= n and out_words % 4 == 0 and out_words - n < 4
    tiles = -(-n // _J2_TILE)
    assert words - out_words == 2 * (3 * tiles + 1)


def test_segment_or_tile_mirrors_the_source():
    """SEGMENT_OR_TILE is csrc/pushdown.cu's kSegTile (its warps times its
    vectors of 4 lanes times 32 lanes), a multiple of 4 (the back-writes'
    16-byte stores start at a tile edge)."""
    import os
    import re
    src = open(os.path.join(os.path.dirname(pushdown.__file__), os.pardir,
                            "csrc", "pushdown.cu")).read()
    threads = int(re.search(r"kSegThreads = (\d+);", src).group(1))
    vec = int(re.search(r"kSegVec = (\d+);", src).group(1))
    assert threads // 32 * vec * 128 == _J2_TILE
    assert _J2_TILE % 4 == 0


# ------------------------------- kernel K: its layouts and its host side


@pytest.mark.parametrize("p", [0, 1, 2, 3, 4])
def test_verdict_masks_are_row_pass(p):
    """K's row verdict, (seg & need) == want, is `_row_pass` for every
    operator / negation choice of p slots (0 an inactive slot) and every
    value of the five OR'ed bits."""
    seg = torch.arange(32)
    for code in np.ndindex(*([2] * p)):
        for neg in np.ndindex(*([2] * p)):
            p_op = np.array(code, np.int32) * 3
            need, want = pushdown.verdict_masks(p_op, np.array(neg))
            assert torch.equal((seg & need) == want,
                               pushdown._row_pass(seg, p_op, np.array(neg)))


def _agg_runs(layout: str, seed: int, n_rows: int = 80):
    """Two sorted runs of INSERTs (the second overwrites a third of the
    rows) whose v / w values K's edge cases need: `none` both NULL in
    every row (no entry qualifies for an aggregate slot), `all` every row
    with both set, `limbs` v only at the biased payload's extremes (limbs
    0 and 0xFFFFFFFF: -2^63, -1, 0, 2^63 - 1) and w at +-99."""
    rng = random.Random(seed)
    pick = {"none": lambda: None,
            "all": lambda: rng.randint(-500, 500),
            "limbs": lambda: rng.choice([-(2 ** 63), -1, 0, 2 ** 63 - 1])}[
        layout]
    runs, ends, t = [], [], 0
    for g in range(2):
        entries = []
        for i in range(n_rows if g == 0 else n_rows // 3):
            t += 1
            ht = (_BASE_US + _STEP_US * t) << 12
            op = QLWriteOp(WriteOpKind.INSERT, _dk(f"h{i % 9}", i),
                           {"v": pick(),
                            "w": None if layout == "none"
                            else rng.choice([-99, 99]),
                            "b": rng.random() < 0.5, "s": None})
            for wid, (k, v) in enumerate(op.to_kv_pairs(SCHEMA)):
                entries.append((k, (ht << 32) | wid, v))
        entries.sort(key=lambda e: (e[0], -e[1]))
        runs.append(pack_kvs(entries))
        ends.append((_BASE_US + _STEP_US * t) << 12)
    return runs, ends


_K_AGGS = {0: [("count", None)],
           1: [("count", None), ("sum", "v"), ("min", "v"), ("max", "v")],
           2: [("sum", "v"), ("max", "v"), ("min", "w"), ("sum", "w")]}


@pytest.mark.parametrize("c", [0, 1, 2])
@pytest.mark.parametrize("case", ["none", "all", "limbs"])
def test_agg_reduce_layouts_match_jax(case, c):
    """Kernel K's edge cases through the aggregating scan on CPU tensors
    (the plain J.1, J.2 and K) against the JAX `_scan_agg_fused` and the
    host rows: no qualifying entry (min and max keep their identities),
    every entry qualifying, payload limbs at 0 and 0xFFFFFFFF; 0, 1 and 2
    aggregate slots (count(*) alone reads no value words: K's c = 0)."""
    runs, ends = _agg_runs(case, seed=7 + c)
    aggs = _K_AGGS[c]
    ref_spec, port_spec = _spec((), aggs)
    assert len(port_spec.agg_cids) == c
    ref_src, port_src = _sources(runs)
    read_ht = ends[-1]
    want = ref_scan.aggregate_sources(ref_src, read_ht, ref_spec)
    got = scan.aggregate_sources(port_src, read_ht, port_spec, device="cpu")
    assert got == want
    assert _as_host(got, aggs) == _host_agg(runs, read_ht, (), aggs)
    assert got["rows"] == 80
    if c and case == "none":
        assert all(st["nonnull"] == 0 and st["min"] is None
                   for st in got["cols"].values())
