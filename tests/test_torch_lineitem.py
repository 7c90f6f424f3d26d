"""chip_smoke.py's TPC-H lineitem tablet and pushdown queries, on the CPU.

The vectorized encoder of the phase's tablet writes what the JAX
package's `QLWriteOp.to_kv_pairs` writes for the same INSERT, UPDATE and
DELETE_ROW ops, its runs are what the JAX package's `pack_kvs` packs, and
at a small size every query of the phase answers the same through the
port (device="cpu"), the JAX package and the phase's host oracle. Every
value is an integer: equality is exact.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from yugabyte_tpu.common.schema import ColumnSchema, DataType, Schema
from yugabyte_tpu.docdb import scan_spec as ref_ss
from yugabyte_tpu.docdb.doc_key import DocKey
from yugabyte_tpu.docdb.doc_operations import QLWriteOp, WriteOpKind
from yugabyte_tpu.ops import scan as ref_scan
from yugabyte_tpu.ops.slabs import pack_kvs
from yugabyte_tpu_torch.docdb import scan_spec
from yugabyte_tpu_torch.ops import scan

# The tier-1 run shares the host's cores among its workers.
torch.set_num_threads(1)

REF_SCHEMA = Schema([ColumnSchema(n, DataType[t])
                     for n, t in cs.LINEITEM_COLS],
                    num_hash_key_columns=1, num_range_key_columns=1)


def _tablet(sf_orders, seed=7):
    rows = cs.lineitem_rows(sf_orders, seed)
    ops = cs.lineitem_ops(rows, seed)
    return rows, ops


def _reference_op(rows, ops, i):
    r = int(ops["row"][i])
    dk = DocKey((int(rows["orderkey"][r]),), (int(rows["linenumber"][r]),))
    kind = int(ops["kind"][i])
    if kind == cs.OP_INSERT:
        return QLWriteOp(WriteOpKind.INSERT, dk,
                         {c: int(rows[c][r]) for c in cs._VALUE_COLS})
    if kind == cs.OP_SET_QTY:
        return QLWriteOp(WriteOpKind.UPDATE, dk,
                         {"l_quantity": int(ops["value"][i])})
    if kind == cs.OP_NULL_DISC:
        return QLWriteOp(WriteOpKind.UPDATE, dk, {"l_discount": None})
    return QLWriteOp(WriteOpKind.DELETE_ROW, dk)


@pytest.mark.parametrize("kind", [cs.OP_INSERT, cs.OP_SET_QTY,
                                  cs.OP_NULL_DISC, cs.OP_DELETE])
def test_encoder_writes_what_to_kv_pairs_writes(kind):
    rows, ops = _tablet(3000)
    ent = cs.encode_lineitem(rows, ops)
    key_bytes = ent["key_words"].astype(">u4").view(np.uint8) \
        .reshape(len(ent["op"]), -1)
    got = {}
    for j in range(len(ent["op"])):
        got.setdefault(int(ent["op"][j]), []).append((
            int(ent["wid"][j]),
            bytes(key_bytes[j, :ent["key_len"][j]]),
            bytes(ent["val"][j, :ent["val_len"][j]])))
    ops_of_kind = np.flatnonzero(ops["kind"] == kind)
    assert len(ops_of_kind) > 0
    for i in ops_of_kind.tolist():
        want = _reference_op(rows, ops, i).to_kv_pairs(REF_SCHEMA)
        assert got[i] == [(w, k, v) for w, (k, v) in enumerate(want)]


def test_tablet_is_one_hash_tablet_of_dbgen_orders():
    rows, ops = _tablet(4000)
    okey = rows["orderkey"]
    assert ((okey - 1) % 32 < 8).all()
    for o in np.unique(okey)[:50].tolist():
        assert DocKey((o,), ()).hash_code < 0x8000
        lines = np.sort(rows["linenumber"][okey == o])
        assert lines.tolist() == list(range(1, len(lines) + 1))
        assert len(lines) <= 7
    assert rows["l_quantity"].min() >= 1 and rows["l_quantity"].max() <= 50
    assert rows["l_discount"].min() >= 0 and rows["l_discount"].max() <= 10
    assert (rows["l_shipdate"] >= cs.D_START + 1).all()
    assert (rows["l_shipdate"] <= cs.D_LAST_ORDER + 121).all()


def test_runs_are_what_pack_kvs_packs():
    rows, ops = _tablet(2000)
    runs, top_ht, mid_ht = cs.lineitem_runs(rows, ops, 7)
    assert len(runs) == 4 and mid_ht < top_ht
    seen = set()
    for g, sl in enumerate(runs):
        hts = (sl.ht_hi.astype(np.int64) << 32) | sl.ht_lo
        assert ((hts <= mid_ht) if g < 3 else (hts > mid_ht)).all()
        assert (hts < top_ht).all()
        entries = [(sl.key_bytes(i), (int(hts[i]) << 32) | int(sl.write_id[i]),
                    sl.values[i]) for i in range(sl.n)]
        assert entries == sorted(entries, key=lambda e: (e[0], -e[1]))
        seen.update(e[1] for e in entries)
        ref = pack_kvs(entries)
        for f in ("key_words", "key_len", "doc_key_len", "ht_hi", "ht_lo",
                  "write_id", "flags", "ttl_ms"):
            assert np.array_equal(getattr(ref, f), getattr(sl, f)), f
    assert len(seen) == sum(s.n for s in runs)     # unique (ht, write id)


def _ref_slab(sl):
    from yugabyte_tpu.ops.slabs import KVSlab, ValueArray
    return KVSlab(sl.key_words, sl.key_len, sl.doc_key_len, sl.ht_hi,
                  sl.ht_lo, sl.write_id, sl.flags, sl.ttl_ms, sl.value_idx,
                  ValueArray(sl.values.data, sl.values.offsets))


@pytest.mark.parametrize("name", ["q1_agg", "q6_agg", "q6_agg@mid",
                                  "filter_rows", "presorted_q1"])
def test_phase_queries_agree(name):
    """Each query of the phase: the port on the CPU == the JAX package ==
    the phase's host oracle."""
    rows, ops = _tablet(6000)
    runs, top_ht, mid_ht = cs.lineitem_runs(rows, ops, 7)
    schema = cs.lineitem_schema()
    qname = {"q6_agg@mid": "q6_agg", "presorted_q1": "q1_agg"}.get(name, name)
    mode, spec = cs.pushdown_queries(schema)[qname]
    ref_spec = ref_ss.ScanSpec(
        tuple(ref_ss.compile_predicate(REF_SCHEMA, p.col, p.op, p.value)
              for p in spec.predicates),
        tuple(ref_ss.compile_aggregate(REF_SCHEMA, a.fn, a.col)
              for a in spec.aggregates))
    assert scan_spec.scan_spec_from_reference(ref_spec) == spec
    read_ht = mid_ht if name.endswith("@mid") else top_ht
    inputs = runs[:1] if name.startswith("presorted") else runs
    port_src = [scan.SlabSource(s, sorted_source=True) for s in inputs]
    ref_src = [ref_scan.SlabSource(_ref_slab(s), sorted_source=True)
               for s in inputs]
    oracle = cs.LineitemOracle(inputs, read_ht)
    if mode == "aggregate":
        got = scan.aggregate_sources(port_src, read_ht, spec, device="cpu")
        assert got == ref_scan.aggregate_sources(ref_src, read_ht, ref_spec)
        assert got == oracle.aggregate(spec, schema)
        assert got["rows"] > 0
    else:
        got = list(scan.filtered_entries_sources(port_src, read_ht, spec,
                                                 device="cpu"))
        assert got == list(ref_scan.filtered_entries_sources(
            ref_src, read_ht, ref_spec))
        assert got == oracle.entries(spec)
        assert got

