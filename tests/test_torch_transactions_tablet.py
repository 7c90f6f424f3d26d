"""The port's tablet-level transactions against the JAX package's, on the
CPU: twins of tests/test_transactions_tablet.py's 11 cases (intents,
conflict detection, read-your-writes, commit apply, abort cleanup, the
late duplicate resolutions, the flush order of the two DBs).

Each case runs the same operations on a JAX Tablet and a port Tablet,
device-free and on each package's CPU device with a cache, with fixed
transaction ids and one deterministic clock, so the answers (rows, the
intents left, the conflicts raised) must be equal and the regular and
intents DBs' SST files and MANIFESTs byte-identical. Tolerance: exact.
"""

import importlib

import pytest

from tests.test_torch_env import PORT, require_reference_native
from tests.test_torch_tablet import VARIANTS, Ctx, twin


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native engine loads and its process Env is
    plaintext (tests/test_torch_env.require_reference_native): the twins
    here drive its ingest_packed or native jobs."""
    require_reference_native()


def _txn(c):
    def m(name):
        return importlib.import_module(f"{c.P.name}.{name}")
    return m("docdb.intents"), m("docdb.conflict_resolution")


class TxnCtx:
    """A twin side with the transaction schema, a status table the
    tablet's resolver reads, and fixed transaction ids."""

    def __init__(self, c):
        self.c = c
        self.intents, self.cr = _txn(c)
        S = c.P.t.schema
        self.schema = S.Schema(columns=[S.ColumnSchema("k", S.DataType.STRING),
                                        S.ColumnSchema("v", S.DataType.STRING)],
                               num_hash_key_columns=1)
        self.statuses = {}
        self._n = 0

    def tablet(self, sub="t"):
        t = self.c.make(sub, schema_=self.schema)
        t.status_resolver = lambda st, txn_id, read_ht=None: \
            self.statuses.get(txn_id, {"status": "pending",
                                       "commit_ht": None})
        return t

    def meta(self, read_ht=None):
        self._n += 1
        return self.intents.TransactionMetadata(
            bytes([self._n]) * 16, "status-tab", 0, read_ht)

    def dk(self, k):
        return self.c.P.doc_key.DocKey(hash_components=(k,))

    def ins(self, k, v):
        return self.c.op("INSERT", self.dk(k), {"v": v})

    def commit(self, t, meta):
        commit_ht = t.clock.now()
        self.statuses[meta.txn_id] = {"status": "committed",
                                      "commit_ht": commit_ht.value}
        return commit_ht

    def value(self, row):
        return None if row is None else row.columns[0]

    def n_intents(self, t, meta):
        return len(self.intents.txn_intents(t.intents_db, meta.txn_id))

    def conflicts(self, fn):
        try:
            fn()
            return False
        except self.cr.TransactionConflict:
            return True


def txn_twin(tmp_path, variant, body):
    return twin(tmp_path, variant, lambda c: body(TxnCtx(c)))


@VARIANTS
def test_txn_write_invisible_until_commit(tmp_path, variant):
    def body(x):
        t = x.tablet()
        meta = x.meta()
        t.write_transactional([x.ins("a", "txn-val")], meta)
        out = [x.value(t.read_row(x.dk("a"))),
               x.value(t.read_row(x.dk("a"), txn_id=meta.txn_id)),
               [x.value(r) for r in t.multi_read([x.dk("a")])]]
        x.commit(t, meta)
        out.append(x.value(t.read_row(x.dk("a"))))
        t.flush()
        return out
    assert txn_twin(tmp_path, variant, body) == \
        [None, "txn-val", [None], "txn-val"]


@VARIANTS
def test_apply_moves_intents_to_regular(tmp_path, variant):
    def body(x):
        t = x.tablet()
        meta = x.meta()
        t.write_transactional([x.ins("a", "v1"), x.ins("b", "v2")], meta)
        commit_ht = x.commit(t, meta)
        t.apply_txn_update("apply", meta.txn_id, commit_ht.value,
                           t.clock.now().value, (1, 100))
        out = [x.n_intents(t, meta)]
        for k in ("a", "b"):
            row = t.read_row(x.dk(k))
            out.append((x.value(row), row.write_ht.value == commit_ht.value))
        out.append(sorted(r.doc_key.hash_components[0]
                          for r in t.scan(use_device=False)))
        t.flush()
        return out
    assert txn_twin(tmp_path, variant, body) == \
        [0, ("v1", True), ("v2", True), ["a", "b"]]


@VARIANTS
def test_abort_cleanup(tmp_path, variant):
    def body(x):
        t = x.tablet()
        meta = x.meta()
        t.write_transactional([x.ins("a", "doomed")], meta)
        x.statuses[meta.txn_id] = {"status": "aborted", "commit_ht": None}
        t.apply_txn_update("cleanup", meta.txn_id, 0,
                           t.clock.now().value, (1, 101))
        t.flush()
        return (x.n_intents(t, meta), x.value(t.read_row(x.dk("a"))),
                x.value(t.read_row(x.dk("a"), txn_id=meta.txn_id)))
    assert txn_twin(tmp_path, variant, body) == (0, None, None)


@VARIANTS
def test_txn_conflict_with_pending_txn(tmp_path, variant):
    def body(x):
        t = x.tablet()
        m1, m2 = x.meta(), x.meta()
        t.write_transactional([x.ins("hot", "one")], m1)
        out = [x.conflicts(lambda: t.write_transactional(
                   [x.ins("hot", "two")], m2)),
               x.conflicts(lambda: t.write([x.ins("hot", "plain")])),
               x.conflicts(lambda: t.write_transactional(
                   [x.ins("cold", "fine")], m2))]
        t.flush()
        return out
    assert txn_twin(tmp_path, variant, body) == [True, True, False]


@VARIANTS
def test_conflict_clears_after_abort(tmp_path, variant):
    def body(x):
        t = x.tablet()
        m1, m2 = x.meta(), x.meta()
        t.write_transactional([x.ins("hot", "one")], m1)
        x.statuses[m1.txn_id] = {"status": "aborted", "commit_ht": None}
        t.write_transactional([x.ins("hot", "two")], m2)
        x.commit(t, m2)
        return x.value(t.read_row(x.dk("hot")))
    assert txn_twin(tmp_path, variant, body) == "two"


@VARIANTS
def test_snapshot_write_conflict(tmp_path, variant):
    def body(x):
        t = x.tablet()
        read_ht = t.clock.now()
        t.write([x.ins("k", "newer-committed")])
        meta = x.meta(read_ht=read_ht.value)
        return x.conflicts(lambda: t.write_transactional(
            [x.ins("k", "stale")], meta))
    assert txn_twin(tmp_path, variant, body) is True


@VARIANTS
def test_same_txn_multiple_batches(tmp_path, variant):
    def body(x):
        t = x.tablet()
        meta = x.meta()
        t.write_transactional([x.ins("x", "1")], meta)
        t.write_transactional([x.ins("y", "2")], meta)
        t.write_transactional([x.ins("x", "3")], meta)
        commit_ht = x.commit(t, meta)
        t.apply_txn_update("apply", meta.txn_id, commit_ht.value,
                           t.clock.now().value, (1, 102))
        t.flush()
        t.compact()
        return (x.value(t.read_row(x.dk("x"))),
                x.value(t.read_row(x.dk("y"))),
                [x.value(r) for r in t.multi_read([x.dk("x"), x.dk("y")])])
    assert txn_twin(tmp_path, variant, body) == ("3", "2", ["3", "2"])


@VARIANTS
def test_restart_preserves_unresolved_intents(tmp_path, variant):
    def body(x):
        t = x.tablet()
        meta = x.meta()
        t.write_transactional([x.ins("a", "pending")], meta)
        t.flush()
        t.close()
        t2 = x.tablet()
        out = [x.n_intents(t2, meta), x.value(t2.read_row(x.dk("a")))]
        commit_ht = x.commit(t2, meta)
        t2.apply_txn_update("apply", meta.txn_id, commit_ht.value,
                            t2.clock.now().value, (1, 103))
        out.append(x.value(t2.read_row(x.dk("a"))))
        return out
    assert txn_twin(tmp_path, variant, body) == [3, None, "pending"]


@VARIANTS
def test_late_cleanup_skips_foreign_intent(tmp_path, variant):
    def body(x):
        t = x.tablet()
        ma, mb = x.meta(), x.meta()
        t.write_transactional([x.ins("hot", "a-val")], ma)
        x.statuses[ma.txn_id] = {"status": "aborted", "commit_ht": None}
        t.apply_txn_update("cleanup", ma.txn_id, 0, t.clock.now().value,
                           (1, 200))
        t.write_transactional([x.ins("hot", "b-val")], mb)
        out = [x.n_intents(t, mb)]
        t.apply_txn_update("cleanup", ma.txn_id, 0, t.clock.now().value,
                           (1, 201))
        out.append(x.n_intents(t, mb))
        commit_ht = x.commit(t, mb)
        t.apply_txn_update("apply", mb.txn_id, commit_ht.value,
                           t.clock.now().value, (1, 202))
        out.append(x.value(t.read_row(x.dk("hot"))))
        t.flush()
        return out
    assert txn_twin(tmp_path, variant, body) == [3, 3, "b-val"]


@VARIANTS
def test_late_apply_does_not_publish_foreign_intent(tmp_path, variant):
    def body(x):
        t = x.tablet()
        ma, mb = x.meta(), x.meta()
        t.write_transactional([x.ins("hot", "a-val")], ma)
        commit_ht = x.commit(t, ma)
        t.apply_txn_update("apply", ma.txn_id, commit_ht.value,
                           t.clock.now().value, (1, 210))
        t.write_transactional([x.ins("hot", "b-uncommitted")], mb)
        t.apply_txn_update("apply", ma.txn_id, commit_ht.value,
                           t.clock.now().value, (1, 211))
        t.flush()
        return x.value(t.read_row(x.dk("hot"))), x.n_intents(t, mb)
    assert txn_twin(tmp_path, variant, body) == ("a-val", 3)


@VARIANTS
def test_intents_flush_persists_regular_first(tmp_path, variant):
    def body(x):
        t = x.tablet()
        meta = x.meta()
        t.write_transactional([x.ins("a", "v1")], meta)
        commit_ht = x.commit(t, meta)
        t.apply_txn_update("apply", meta.txn_id, commit_ht.value,
                           t.clock.now().value, (5, 500))
        t.intents_db.flush()
        reg_f = t.regular_db.versions.flushed_frontier
        int_f = t.intents_db.versions.flushed_frontier
        return (reg_f is not None and int_f is not None,
                reg_f.op_id_max >= int_f.op_id_max, reg_f.op_id_max)
    assert txn_twin(tmp_path, variant, body) == (True, True, (5, 500))


def test_port_only_routes_intents_reads_on_the_host(tmp_path):
    """While a tablet's intents DB holds records, multi_read serves every
    row through read_row (the intent-aware host merge: no point-read
    launch); a tablet whose intents DB is empty reads through one
    DB.multi_get."""
    from unittest import mock
    c = Ctx(PORT, str(tmp_path), "cpu")
    x = TxnCtx(c)
    t, plain = x.tablet("txn"), x.tablet("plain")
    meta = x.meta()
    t.write_transactional([x.ins(f"k{i}", f"v{i}") for i in range(8)], meta)
    plain.write([x.ins(f"k{i}", f"v{i}") for i in range(8)])
    keys = [x.dk(f"k{i}") for i in range(8)]
    with mock.patch.object(t.regular_db, "multi_get") as mg:
        assert [x.value(r) for r in t.multi_read(keys)] == [None] * 8
        commit_ht = x.commit(t, meta)
        t.apply_txn_update("apply", meta.txn_id, commit_ht.value,
                           t.clock.now().value, (1, 300))
        assert [x.value(r) for r in t.multi_read(keys)] == \
            [f"v{i}" for i in range(8)]
    assert mg.call_count == 0
    with mock.patch.object(plain.regular_db, "multi_get",
                           wraps=plain.regular_db.multi_get) as mg:
        assert [x.value(r) for r in plain.multi_read(keys)] == \
            [f"v{i}" for i in range(8)]
    assert mg.call_count == 1
    c.close()
