"""Tablet: one shard = two LSM instances + MVCC + locks + write pipeline.

Counterpart of yugabyte_tpu/tablet/tablet.py (ref: src/yb/tablet/tablet.h:124;
regular_db_/intents_db_ pair :856-857; apply path tablet.cc:1116
ApplyRowOperations -> :1198 ApplyKeyValueRowOperations -> :1247 WriteToRocksDB
where the Raft index becomes the storage frontier; read handlers :1290+).

The write pipeline here is WriteQuery (ref: tablet/write_query.cc): acquire
doc-path locks -> (txn conflict resolution) -> pick hybrid time and
register with MVCC -> submit through the consensus seam -> apply -> release.
The consensus seam is LocalConsensusContext (applies immediately,
monotonically numbering ops); a TabletPeer (tablet/tablet_peer.py)
replaces it with RaftWriteContext behind the same `submit()` interface.

`TabletOptions.device=None` means the card, as `DBOptions.device=None`
does: a default tablet puts its regular DB on CUDA with a device cache
of its own, and raises `utils/torch_setup`'s error when it is built
without CUDA. This is a divergence the port chose: the JAX package's
None is a device-free tablet. The device-free tablet is asked for with
`device="native"` (both DBs "native": C++ flush, compaction and reads,
no device cache, no CUDA needed); "cpu" runs the kernels' plain
versions. The intents DB takes the device without a cache
(`own_cache=False`), as the JAX one: its compactions run on the device,
its reads on the host.

The kernels each entry point reaches on a device tablet: `multi_read`
sends every flat row through one `DB.multi_get` (P1 + P2, P3 + fold a
1024-key chunk); a full-table `scan` takes `DB.scan_visible` (G, H, I.1,
B; a bounded scan, forced with use_device=True, adds I.2);
`scan_pushdown` / `scan_aggregate` take J and K beside them; `flush`
stages the new file (write-through) and `compact` runs the device-native
job (A-F, H, and P4 for the learned index). A row whose intents are
pending, a deep document or a write off the enumerated columns resolves
through `read_row` on the host.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from yugabyte_tpu_torch.common.hybrid_time import (
    DocHybridTime, HybridClock, HybridTime)
from yugabyte_tpu_torch.consensus.raft import OperationOutcomeUnknown
from yugabyte_tpu_torch.common.schema import Schema
from yugabyte_tpu_torch.docdb.doc_key import DocKey
from yugabyte_tpu_torch.docdb.doc_operations import QLWriteOp, prepare_and_assemble
from yugabyte_tpu_torch.docdb.doc_rowwise_iterator import (
    DocRowwiseIterator, Row, VisibleEntryRowAssembler, read_row)
from yugabyte_tpu_torch.docdb.lock_manager import SharedLockManager
from yugabyte_tpu_torch.docdb.value_type import ValueType
from yugabyte_tpu_torch.ops.slabs import _doc_key_len
from yugabyte_tpu_torch.storage.db import DB, DBOptions
from yugabyte_tpu_torch.tablet.mvcc import MvccManager
from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils.metrics import Counter, Histogram, MetricRegistry
from yugabyte_tpu_torch.utils.trace import TRACE

flags.define_flag(
    "timestamp_history_retention_interval_sec", 900,
    "how far back in time reads are repeatable; compaction keeps overwritten "
    "values younger than this (ref tablet_retention_policy.h:29)")
flags.define_flag("sst_files_soft_limit", 24,
                  "writes start delaying at this many live SST files "
                  "(ref sst_files_soft_limit)")
flags.define_flag("sst_files_hard_limit", 48,
                  "writes are rejected (retryably) at this many live SST "
                  "files (ref sst_files_hard_limit)")
flags.define_flag("write_backpressure_max_delay_ms", 100,
                  "max per-write delay as file pressure approaches the "
                  "hard limit (ref tablet_service.cc:1510 rejection score)")
flags.define_flag("scan_pushdown", True,
                  "run simple predicates + aggregates in the pushdown "
                  "kernels (J, K); off = every query takes "
                  "the per-row host path (results are identical either "
                  "way — the device subset is exact by construction)")
flags.define_flag("scan_pushdown_min_rows", 4096,
                  "minimum approximate entry count before a query rides "
                  "the fused pushdown kernels: below it the per-row host "
                  "path wins (a device dispatch and its first-use kernel "
                  "build must never stall a tiny scan inside an RPC "
                  "deadline); same size-class philosophy as the "
                  "compaction offload policy")


class TabletRetentionPolicy:
    """history_cutoff = now - retention interval (ref tablet_retention_policy.h).

    override_s: PITR snapshot schedules need MVCC history at least as deep
    as their snapshot interval — otherwise a compaction between the restore
    target time and the covering snapshot's barrier collapses the versions
    the restore must read, and import_snapshot silently reconstructs newer
    state.  The master computes the requirement from active schedules and
    ships it via heartbeat responses (ref: the snapshot coordinator feeding
    allowed history cutoff, master_snapshot_coordinator.cc /
    tablet_retention_policy.cc AllowedHistoryCutoff)."""

    def __init__(self, clock: HybridClock):
        self._clock = clock
        self.override_s: float = 0.0

    def set_override(self, seconds: float) -> None:
        self.override_s = float(seconds)

    def history_cutoff(self) -> int:
        retention_s = max(
            flags.get_flag("timestamp_history_retention_interval_sec"),
            self.override_s)
        now = self._clock.now()
        return max(0, HybridTime.from_micros(
            now.physical_micros - int(retention_s * 1_000_000)).value)


class TabletHasBeenSplit(Exception):
    """Writes to a split parent are rejected; the client re-routes to the
    children (ref tablet/operations/split_operation.h)."""

    def __init__(self, children):
        super().__init__(f"tablet split into {children}")
        self.children = children


class LocalConsensusContext:
    """Round-1 consensus seam: no replication, ops numbered monotonically.
    Same submit() surface RaftConsensus implements."""

    def __init__(self, tablet: "Tablet"):
        self._tablet = tablet
        self._index = 0
        self._lock = threading.Lock()

    def submit(self, kv_pairs, ht: HybridTime, timeout_s: float = 10.0,
               target_intents: bool = False, request=None) -> Tuple[int, int]:
        with self._lock:
            self._index += 1
            op_id = (1, self._index)  # (term, index)
        if target_intents:
            self._tablet.apply_intent_batch(kv_pairs, ht, op_id)
        else:
            self._tablet.apply_write_batch(kv_pairs, ht, op_id)
        if request is not None:
            self._tablet.retryable.replicated(request[0], request[1],
                                              ht.value)
        return op_id


@dataclass
class TabletOptions:
    block_entries: Optional[int] = None  # None = sst_block_entries flag
    # None = the card (as DBOptions.device=None; the JAX package's None
    # is device-free), "cuda", "cpu" (the kernels' plain versions) or
    # "native" (the device-free tablet)
    device: object = None
    mesh: object = None      # >1-device mesh for distributed compaction
    offload_policy: object = None   # measured device-vs-native router
    device_cache: object = None
    compaction_pool: object = None
    # tserver/compaction_pool.CompactionPool: the mesh-sharded multi-
    # tablet scheduler; device-routed compactions ride its batch slots
    mesh_pool: object = None
    # shared decoded-block cache (ref: db/table_cache.cc — one per server)
    block_cache: object = None
    auto_compact: bool = True
    memstore_size_bytes: Optional[int] = None
    # Doc-key-space clamp for split children, whose LSM initially holds the
    # whole parent key range (ref: post-split key-bounds filtering,
    # docdb/doc_db.h KeyBounds).
    lower_bound_key: bytes = b""
    upper_bound_key: Optional[bytes] = None


class Tablet:  # yblint: disable=ybsan-coverage (composition root: the .submit goes to the consensus seam, and all cross-thread mutable state lives in DB/RaftConsensus/ admission, each covered by its own guarded-by annotations)
    def __init__(self, tablet_id: str, data_dir: str, schema: Schema,
                 clock: Optional[HybridClock] = None,
                 options: Optional[TabletOptions] = None,
                 metrics: Optional[MetricRegistry] = None):
        self.tablet_id = tablet_id
        self.schema = schema
        self.clock = clock or HybridClock()
        self.opts = options or TabletOptions()
        self.retention_policy = TabletRetentionPolicy(self.clock)
        from yugabyte_tpu_torch.tablet.retryable_requests import RetryableRequests
        self.retryable = RetryableRequests()
        # device=None is the card, as DBOptions' (the JAX package's None
        # is device-free): without CUDA the regular DB raises before it
        # makes its directory
        db_device = self.opts.device
        db_opts = DBOptions(
            block_entries=self.opts.block_entries,
            device=db_device,
            mesh=self.opts.mesh,
            offload_policy=self.opts.offload_policy,
            device_cache=(self.opts.device_cache if db_device != "native"
                          else None),
            compaction_pool=self.opts.compaction_pool,
            mesh_pool=self.opts.mesh_pool,
            block_cache=self.opts.block_cache,
            retention_policy=self.retention_policy.history_cutoff,
            memstore_size_bytes=self.opts.memstore_size_bytes,
            auto_compact=self.opts.auto_compact)
        # Two DB instances, exactly like the reference (tablet.h:856-857):
        # committed data in regular_db, provisional records in intents_db.
        self.regular_db = DB(os.path.join(data_dir, "regular"), db_opts)
        # the JAX intents DB: the device, no cache (compactions on the
        # device, reads native, no provisional record staged)
        intents_opts = DBOptions(
            block_entries=self.opts.block_entries,
            device=db_device,
            own_cache=False,
            compaction_pool=self.opts.compaction_pool,
            block_cache=self.opts.block_cache,
            auto_compact=self.opts.auto_compact)
        self.intents_db = DB(os.path.join(data_dir, "intents"), intents_opts)
        # Flush-ordering invariant (ref: the reference flushes regular
        # before intents so intents cleanup never outlives the applied
        # rows): an intents flush first persists the regular DB, keeping
        # intents' flushed frontier <= regular's for txn-apply ops whose
        # effects span both DBs. Bootstrap replays from the min frontier,
        # so OP_UPDATE_TXN re-derivation always sees live intents.
        self.intents_db.pre_flush_hook = self._pre_intents_flush
        self.mvcc = MvccManager(self.clock)
        self.lock_manager = SharedLockManager()
        self.consensus = LocalConsensusContext(self)
        self.split_children = None  # (child0, child1) once split
        # status_resolver(status_tablet, txn_id) -> {"status", "commit_ht"}
        # — wired by the tserver to the transaction coordinator; None means
        # conservative resolution (pending).
        self.status_resolver = None
        # Write gate for splitting: the SPLIT op must be the last write-ish
        # entry the parent ever appends, so block_writes() drains in-flight
        # writes BEFORE the split appends (an acked write appended after the
        # SPLIT entry would apply to the parent after the children snapshot
        # it — silently lost when the parent retires).
        self._write_gate = threading.Condition()
        self._inflight_writes = 0
        self._writes_blocked = False
        metrics = metrics or MetricRegistry()
        entity = metrics.entity("tablet", tablet_id)
        self.metric_rows_inserted = entity.counter(
            "rows_inserted_total", "rows written via QL write ops")
        self.metric_write_latency = entity.histogram(
            "ql_write_latency_us", "end-to-end WriteQuery latency (us)")
        self.metric_reads = entity.counter("ql_reads_total",
                                           "row reads served")
        self.metric_write_rejections = entity.counter(
            "write_rejections_total",
            "writes rejected retryably by write-pressure backpressure "
            "(SST files / memstore tracker / WAL backlog)")
        # Unified write-pressure state machine (tablet/admission.py):
        # SST-file pressure is bound here; TabletPeer binds the WAL
        # appender backlog and TabletMemoryManager binds the server-wide
        # memstore MemTracker. Evaluated at every write entry point.
        from yugabyte_tpu_torch.tablet.admission import WriteAdmission
        self.admission = WriteAdmission(
            tablet_id, lambda: self.regular_db.n_live_files,
            rejection_counter=self.metric_write_rejections)

    def _pre_intents_flush(self) -> None:
        """Intents pre-flush hook. The regular flush contains I/O errors
        by parking its DB (it returns None, it does not raise), so the
        ordering invariant must be re-checked explicitly: if the regular
        DB failed to persist, the intents flush MUST abort too — an
        intents frontier ahead of the regular DB replays OP_UPDATE_TXN as
        a no-op after restart and loses rows."""
        from yugabyte_tpu_torch.utils.status import StatusError
        self.regular_db.flush()
        err = self.regular_db.background_error
        if err is not None:
            raise StatusError(err)

    # ------------------------------------------------------------------ write
    def write(self, ops: Sequence[QLWriteOp], timeout_s: float = 10.0,
              request=None) -> HybridTime:
        """The WriteQuery pipeline (ref write_query.cc:211-566). Returns the
        hybrid time at which the batch became visible.

        request: optional (client_id, request_id) for exactly-once dedup
        (ref consensus/retryable_requests.cc): a duplicate of an
        already-replicated request returns its original hybrid time without
        re-applying; a duplicate of an in-flight one is pushed back to the
        client retry loop until the first attempt's fate settles."""
        # dedup BEFORE backpressure: a retry of an already-replicated write
        # must return its stored result even under file pressure (else a
        # long stall could outlive the dedup record and double-apply)
        if request is not None:
            state, ht_value = self.retryable.check_or_track(*request)
            if state == "duplicate":
                return HybridTime(ht_value)
            if state == "in_flight":
                from yugabyte_tpu_torch.utils.status import Status, StatusError
                raise StatusError(Status.ServiceUnavailable(
                    "duplicate request still in flight"))
        try:
            self._check_write_backpressure()
        except BaseException:
            if request is not None:
                self.retryable.failed(*request)
            raise
        with self._write_gate:
            if self._writes_blocked or self.split_children is not None:
                if request is not None:
                    self.retryable.failed(*request)
                raise TabletHasBeenSplit(self.split_children or ())
            self._inflight_writes += 1
        try:
            return self._write_locked(ops, timeout_s, request=request)
        except OperationOutcomeUnknown:
            raise  # fate watcher resolves the in-flight registration
        except BaseException:
            if request is not None:
                self.retryable.failed(*request)
            raise
        finally:
            with self._write_gate:
                self._inflight_writes -= 1
                self._write_gate.notify_all()

    def _check_write_backpressure(self) -> None:
        """Unified score-based write throttling (ref:
        tserver/tablet_service.cc:1510 write-rejection score +
        sst_files_soft/hard_limit, plus the reference's memstore
        soft-limit rejection): the admission state machine
        (tablet/admission.py) scores SST-file, memstore-tracker and
        WAL-backlog pressure — between soft and hard each write is
        delayed proportionally, giving flushes/compactions bandwidth to
        catch up; at a hard limit writes are rejected retryably with
        typed Overloaded throttle extras."""
        self.admission.admit()

    def block_writes(self) -> None:
        """Reject new writes and drain in-flight ones (split prelude)."""
        with self._write_gate:
            self._writes_blocked = True
            while self._inflight_writes:
                self._write_gate.wait()

    def unblock_writes(self) -> None:
        with self._write_gate:
            self._writes_blocked = False

    def _write_locked(self, ops: Sequence[QLWriteOp],
                      timeout_s: float, request=None) -> HybridTime:
        t0 = time.monotonic()
        lock_batch, kv_pairs = prepare_and_assemble(
            ops, self.schema, self.lock_manager, timeout_s=timeout_s)
        try:
            # Even single-shard writes must not stomp on live provisional
            # records (ref write_query.cc:429 conflict resolution for
            # non-transactional writes). Skipped entirely while the intents
            # DB is empty — the overwhelmingly common case.
            if self.intents_db.approx_entry_count():
                from yugabyte_tpu_torch.docdb.conflict_resolution import (
                    resolve_write_conflicts)
                resolve_write_conflicts(self.intents_db, self.regular_db,
                                        lock_batch.entries, None,
                                        self.status_resolver)
            # Hybrid-time draw + registration is atomic inside MvccManager;
            # the apply itself runs concurrently across writers (each KV
            # carries its own DocHybridTime, so apply order is irrelevant)
            # and MvccManager drains completions in hybrid-time order.
            ht = self.mvcc.add_pending_now()
            try:
                self.consensus.submit(kv_pairs, ht, timeout_s=timeout_s,
                                      request=request)
            except OperationOutcomeUnknown:
                # Fate unknown: the consensus seam registered a fate watcher
                # that resolves the MVCC registration when the entry commits
                # or is overwritten. Aborting here would let safe time
                # advance past a write that may yet land.
                raise
            except BaseException:
                self.mvcc.aborted(ht)
                raise
            self.mvcc.replicated(ht)
        finally:
            lock_batch.release()
        self.metric_rows_inserted.increment(len(ops))
        self.metric_write_latency.increment((time.monotonic() - t0) * 1e6)
        # group-commit accounting: this batch rode ONE raft replicate /
        # WAL append / apply_write_batch regardless of its op count
        from yugabyte_tpu_torch.utils.metrics import serve_path_metrics
        m = serve_path_metrics()
        m.counter("write_group_commit_total",
                  "write batches replicated as ONE raft entry").increment()
        m.histogram("write_batch_rows",
                    "rows per group-committed write batch").increment(
            len(ops))
        if len(ops) > 1:
            m.counter("write_batch_coalesced_ops_total",
                      "ops that rode a multi-op group commit").increment(
                len(ops))
        return ht

    def apply_external_batch(self, kvs: Sequence[Sequence],
                             default_ht_value: int,
                             timeout_s: float = 30.0) -> HybridTime:
        """xCluster consumer apply: raw DocDB (key, value, ht_override)
        triples from a source cluster, replicated through THIS tablet's
        Raft with the source hybrid times preserved as per-entry overrides
        (ref: twodc_output_client.cc external hybrid times). Bypasses the
        QL write pipeline: entries are already DocDB-encoded and the
        target is passive for replicated ranges."""
        self._check_write_backpressure()  # replication also yields to
        # compactions — an unthrottled source would grow target L0 forever
        self.clock.update(HybridTime(default_ht_value))
        triples = [(bytes(k), bytes(v),
                    int(o) if o else default_ht_value)
                   for k, v, o in kvs]
        # same gate as every other write path: an apply racing a split's
        # write drain would land in the retiring parent and never reach
        # the children
        with self._write_gate:
            if self._writes_blocked or self.split_children is not None:
                raise TabletHasBeenSplit(self.split_children or ())
            self._inflight_writes += 1
        try:
            ht = self.mvcc.add_pending_now()
            try:
                self.consensus.submit(triples, ht, timeout_s=timeout_s)
            except OperationOutcomeUnknown:
                raise
            except BaseException:
                self.mvcc.aborted(ht)
                raise
            self.mvcc.replicated(ht)
            return ht
        finally:
            with self._write_gate:
                self._inflight_writes -= 1
                self._write_gate.notify_all()

    def apply_write_batch(self, kv_pairs: Sequence[Tuple],
                          ht: HybridTime, op_id: Tuple[int, int]) -> None:
        """Apply an already-replicated batch to regular_db. Position within
        the batch becomes the DocHybridTime write_id (ref tablet.cc:1198).
        An item may carry a per-entry hybrid-time override as a third
        element (index backfill, ref tablet.cc:2088)."""
        items = []
        for write_id, it in enumerate(kv_pairs):
            ht_i = HybridTime(it[2]) if len(it) == 3 and it[2] else ht
            items.append((it[0], DocHybridTime(ht_i, write_id), it[1]))
        self.regular_db.write_batch(items, op_id=op_id)
        TRACE("tablet %s applied %d kvs at %s", self.tablet_id, len(items), ht)

    # ------------------------------------------------------- transactions
    def write_transactional(self, ops: Sequence[QLWriteOp], txn_meta,
                            timeout_s: float = 10.0,
                            write_id_base: int = 0) -> HybridTime:
        """Transactional write: conflict-check, then replicate provisional
        records into the intents DB (ref write_query.cc:464 +
        docdb.h PrepareTransactionWriteBatch). Data becomes visible only
        when the coordinator commits and intents apply."""
        from yugabyte_tpu_torch.docdb.conflict_resolution import (
            resolve_write_conflicts)
        from yugabyte_tpu_torch.docdb.intents import make_intent_batch
        self._check_write_backpressure()  # both write entry points throttle
        with self._write_gate:
            if self._writes_blocked or self.split_children is not None:
                raise TabletHasBeenSplit(self.split_children or ())
            self._inflight_writes += 1
        try:
            lock_batch, kv_pairs = prepare_and_assemble(
                ops, self.schema, self.lock_manager, timeout_s=timeout_s)
            # backfill-ht overrides apply only to regular (non-transactional)
            # writes; intents are always stamped at commit time
            kv_pairs = [(p[0], p[1]) for p in kv_pairs]
            from yugabyte_tpu_torch.utils.status import Status, StatusError
            if write_id_base and len(kv_pairs) > (1 << 16):
                # each statement owns a 2^16 IntraTxnWriteId slot
                # (client/transaction.py); overflowing into the next
                # statement's slot would silently re-introduce the
                # same-commit-ht shadowing bug the slots prevent
                raise StatusError(Status.InvalidArgument(
                    f"transaction statement writes {len(kv_pairs)} "
                    f"sub-writes (max {1 << 16}); split the batch"))
            try:
                resolve_write_conflicts(self.intents_db, self.regular_db,
                                        lock_batch.entries, txn_meta,
                                        self.status_resolver)
                intent_items = make_intent_batch(txn_meta, kv_pairs,
                                                 lock_batch.entries,
                                                 write_id_base=write_id_base)
                ht = self.mvcc.add_pending_now()
                try:
                    self.consensus.submit(intent_items, ht,
                                          timeout_s=timeout_s,
                                          target_intents=True)
                except OperationOutcomeUnknown:
                    raise
                except BaseException:
                    self.mvcc.aborted(ht)
                    raise
                self.mvcc.replicated(ht)
                return ht
            finally:
                lock_batch.release()
        finally:
            with self._write_gate:
                self._inflight_writes -= 1
                self._write_gate.notify_all()

    def apply_intent_batch(self, kv_pairs: Sequence[Tuple[bytes, bytes]],
                           ht: HybridTime, op_id: Tuple[int, int]) -> None:
        """Replicated-apply of provisional records into intents_db."""
        items = [(key, DocHybridTime(ht, write_id), value)
                 for write_id, (key, value) in enumerate(kv_pairs)]
        self.intents_db.write_batch(items, op_id=op_id)

    def apply_txn_update(self, action: str, txn_id: bytes,
                         commit_ht_value: int, resolution_ht_value: int,
                         op_id: Tuple[int, int]) -> None:
        """Replicated-apply of a transaction resolution (ref
        tablet.cc:1670 ApplyIntents / :1735 RemoveIntents). `apply` moves
        committed intents into regular_db at the commit hybrid time;
        `cleanup` just tombstones them. Deterministic across replicas: all
        hybrid times come from the raft entry."""
        from yugabyte_tpu_torch.docdb.intents import (
            decode_intent_key, decode_intent_value, reverse_index_prefix,
            txn_intents)
        from yugabyte_tpu_torch.docdb.lock_manager import IntentType
        from yugabyte_tpu_torch.docdb.value import Value
        intents = txn_intents(self.intents_db, txn_id)
        regular_items = []
        tombstones = []
        tomb = Value.tombstone().encode()
        seq = 0
        for intent_key, _dht, raw in intents:
            decoded = decode_intent_key(intent_key)
            if decoded is None:
                continue
            subdoc_key, itype = decoded
            if action == "apply" and itype == IntentType.kStrongWrite:
                _txn, _st, write_id, value_bytes = decode_intent_value(raw)
                regular_items.append(
                    (subdoc_key,
                     DocHybridTime(HybridTime(commit_ht_value), write_id),
                     value_bytes))
            tombstones.append(
                (intent_key,
                 DocHybridTime(HybridTime(resolution_ht_value), seq), tomb))
            seq += 1
        # Reverse-index records get tombstoned too.
        prefix = reverse_index_prefix(txn_id)
        seen = set()
        for ikey, raw in self.intents_db.iter_from(prefix):
            from yugabyte_tpu_torch.docdb.doc_key import split_key_and_ht
            rkey, dht = split_key_and_ht(ikey)
            if dht is None or not rkey.startswith(prefix):
                break
            if rkey in seen:
                continue
            seen.add(rkey)
            tombstones.append(
                (rkey, DocHybridTime(HybridTime(resolution_ht_value), seq),
                 tomb))
            seq += 1
        from yugabyte_tpu_torch.utils import sync_point
        sync_point.hit("tablet.apply_txn:before_regular_write")
        if regular_items:
            self.regular_db.write_batch(regular_items, op_id=op_id)
        sync_point.hit("tablet.apply_txn:between_dbs")
        if tombstones:
            self.intents_db.write_batch(tombstones, op_id=op_id)
        TRACE("tablet %s: txn %s %s — %d applied, %d intents resolved",
              self.tablet_id, txn_id.hex()[:8], action, len(regular_items),
              len(tombstones))

    # ------------------------------------------------------------------- read
    def read_time(self, read_ht: Optional[HybridTime] = None,
                  timeout_s: float = 10.0) -> HybridTime:
        """Pick/validate a read point: wait until SafeTime >= read_ht (ref:
        read_query.cc:521 ScopedReadOperation + mvcc.h:135)."""
        if read_ht is None:
            return self.mvcc.safe_time(timeout_s=timeout_s)
        self.mvcc.safe_time(min_allowed=read_ht, timeout_s=timeout_s)
        return read_ht

    def read_row(self, doc_key: DocKey, read_ht: Optional[HybridTime] = None,
                 projection=None, txn_id: Optional[bytes] = None
                 ) -> Optional[Row]:
        ht = self.read_time(read_ht)
        self.metric_reads.increment()
        encoded = doc_key.encode()
        stream = self._entry_stream(ht, encoded,
                                    encoded + bytes([ValueType.kMaxByte]),
                                    txn_id)
        return read_row(self.regular_db, self.schema, doc_key, ht,
                        projection=projection, entry_stream=stream)

    def multi_read(self, doc_keys, read_ht: Optional[HybridTime] = None,
                   projection=None, txn_id: Optional[bytes] = None):
        """Batched point-row reads: one result per doc key, aligned with
        the input (None = row absent). Semantically N read_row calls at
        one shared read point, but the SST probes of every FLAT row go
        through ONE DB.multi_get batch (the device point-read kernels,
        ops/point_read.py) instead of a per-row iterator walk.

        Fast-path preconditions — any row outside them resolves through
        the exact read_row path: no transaction context, an empty intent
        overlay, no live SST holding deep documents (regular_db
        has_deep_files), and no memtable entry of the row off the
        enumerated (liveness + schema value columns) key set. Rows whose
        only surviving data lives at non-schema column ids inside SSTs
        (dropped columns) are the one documented divergence — they need
        the full iterator to prove existence."""
        ht = self.read_time(read_ht)
        if txn_id is not None \
                or self.intents_db.approx_entry_count() != 0 \
                or self.regular_db.has_deep_files():
            return [self.read_row(dk, ht, projection, txn_id=txn_id)
                    for dk in doc_keys]
        from yugabyte_tpu_torch.docdb.doc_operations import (column_key_suffix,
                                                             kLivenessColumnId)
        schema = self.schema
        cids = [kLivenessColumnId] + [schema.column_id(c.name)
                                      for c in schema.value_columns]
        suffixes = [column_key_suffix(cid) for cid in cids]
        cid_by_suffix = dict(zip(suffixes, cids))
        # projection names -> ids ONCE per batch (mirrors
        # VisibleEntryRowAssembler: unknown names never match)
        proj_ids = None
        if projection is not None:
            proj_ids = set()
            for cname in projection:
                try:
                    proj_ids.add(cname if isinstance(cname, int)
                                 else schema.column_id(cname))
                except KeyError:
                    pass
        keys: list = []
        dkls: list = []
        spans = []          # per doc key: (start, count) into keys
        row_keys_by = []
        fallback = set()    # row indexes that need the exact path
        encs = []
        for ri, dk in enumerate(doc_keys):
            self.metric_reads.increment()
            enc = dk.encode()
            encs.append(enc)
            upper = enc + bytes([ValueType.kMaxByte])
            enumerated = sorted([enc] + [enc + s for s in suffixes])
            enum_set = set(enumerated)
            # memtable probe: recent writes at non-enumerated subkeys
            # (deep documents, unknown cids) make this row non-flat
            from yugabyte_tpu_torch.docdb.doc_key import split_key_and_ht
            for ikey, _v in self.regular_db.mem_entries_range(enc, upper):
                prefix, dht = split_key_and_ht(ikey)
                if dht is None or prefix not in enum_set:
                    fallback.add(ri)
                    break
            row_keys_by.append(enumerated)
            spans.append((len(keys), len(enumerated)))
            keys.extend(enumerated)
            dkls.extend([len(enc)] * len(enumerated))
        results = self.regular_db.multi_get(keys, ht, doc_key_lens=dkls)
        from yugabyte_tpu_torch.utils import latency as _latency
        rows = []
        asm_s = fb_s = 0.0
        for ri, dk in enumerate(doc_keys):
            if ri in fallback:
                t0 = time.monotonic()
                rows.append(self.read_row(dk, ht, projection))
                fb_s += time.monotonic() - t0
                continue
            start, count = spans[ri]
            t0 = time.monotonic()
            rows.append(self._assemble_flat_row(
                dk, encs[ri], row_keys_by[ri],
                results[start: start + count], ht, proj_ids,
                cid_by_suffix))
            asm_s += time.monotonic() - t0
        _latency.record_stage(_latency.STAGE_ROW_ASSEMBLY, asm_s * 1e3)
        _latency.record_stage(_latency.STAGE_HOST_FALLBACK, fb_s * 1e3)
        return rows

    def _assemble_flat_row(self, doc_key, enc: bytes, row_keys,
                           row_results, ht: HybridTime, proj_ids,
                           cid_by_suffix):
        """RESOLVE + ASSEMBLE one flat row from exact-key probe results,
        mirroring DocRowwiseIterator._resolve_visible +
        VisibleEntryRowAssembler for depth <= 1: the newest visible
        version per path is already in hand (multi_get semantics); drop
        tombstones/expired values, apply the bare-DocKey overwrite
        point, then build the Row DIRECTLY — every probe key came from
        our own enumeration, so its column id is the suffix we appended
        (no SubDocKey re-decode per entry)."""
        from yugabyte_tpu_torch.docdb.doc_operations import kLivenessColumnId
        from yugabyte_tpu_torch.docdb.doc_rowwise_iterator import Row, _is_expired
        from yugabyte_tpu_torch.docdb.value import Value as DocValue
        bare_dht = None
        for k, res in zip(row_keys, row_results):
            if res is not None and k == enc:
                bare_dht = res[0]
        columns = {}
        liveness = False
        max_ht = 0
        n_enc = len(enc)
        for k, res in zip(row_keys, row_results):
            if res is None:
                continue
            dht, raw = res
            value = DocValue.decode(raw)
            if (value.is_tombstone or _is_expired(value, dht, ht)
                    or (k != enc and bare_dht is not None
                        and dht < bare_dht)):
                continue
            ht_value = dht.ht.value
            if ht_value > max_ht:
                max_ht = ht_value
            if k == enc:
                liveness = True  # visible init marker
                continue
            cid = cid_by_suffix[k[n_enc:]]
            liveness = True  # any visible column proves the row exists
            if cid == kLivenessColumnId:
                continue
            if proj_ids is not None and cid not in proj_ids:
                continue
            columns[cid] = {} if value.is_object else value.primitive
        if not liveness:
            return None
        return Row(doc_key, columns, HybridTime(max_ht))

    def _entry_stream(self, ht: HybridTime, lower: bytes,
                      upper: Optional[bytes], txn_id: Optional[bytes]):
        """Intent-aware merged stream, or None for the plain fast path when
        no provisional records can exist (ref intent_aware_iterator.h)."""
        from yugabyte_tpu_torch.docdb.intent_aware_iterator import (
            intent_overlay_entries, merged_entry_stream)
        if txn_id is None and self.intents_db.approx_entry_count() == 0:
            return None
        overlay = intent_overlay_entries(
            self.intents_db, ht, txn_id, self.status_resolver,
            lower=lower, upper=upper)
        if not overlay and txn_id is None:
            return None
        return merged_entry_stream(self.regular_db, overlay, lower=lower)

    def scan(self, read_ht: Optional[HybridTime] = None,
             lower_doc_key: bytes = b"", upper_doc_key: Optional[bytes] = None,
             projection=None, use_device: Optional[bool] = None,
             txn_id: Optional[bytes] = None):
        """Range scan. use_device: True forces the device scan kernels, False
        the host iterator, None auto-picks: device path only for FULL-table scans
        on a device-configured tablet — the kernel resolves the whole DB in
        one device pass (great for big scans), while bounded scans seek
        directly to their range on the host iterator (ref: the reference
        always walks DocRowwiseIterator; here ops/scan.py)."""
        ht = self.read_time(read_ht)
        # Clamp to this tablet's key bounds (split children share the
        # parent's LSM files until post-split compaction).
        if self.opts.lower_bound_key:
            lower_doc_key = max(lower_doc_key, self.opts.lower_bound_key)
        if self.opts.upper_bound_key is not None:
            upper_doc_key = (self.opts.upper_bound_key
                             if upper_doc_key is None
                             else min(upper_doc_key,
                                      self.opts.upper_bound_key))
        stream = self._entry_stream(ht, lower_doc_key, upper_doc_key,
                                    txn_id)
        if use_device is None:
            use_device = (self.opts.device != "native"
                          and not lower_doc_key and upper_doc_key is None
                          and stream is None)
        if use_device and stream is None:
            entries = self.regular_db.scan_visible(
                ht.value, lower_doc_key or None, upper_doc_key)
            return VisibleEntryRowAssembler(entries, self.schema,
                                            projection=projection)
        return DocRowwiseIterator(self.regular_db, self.schema, ht,
                                  lower_doc_key=lower_doc_key,
                                  upper_doc_key=upper_doc_key,
                                  projection=projection,
                                  entry_stream=stream)

    # ------------------------------------------------------ query pushdown
    def _pushdown_gate(self, ht: HybridTime, lower: bytes,
                       upper: Optional[bytes],
                       txn_id: Optional[bytes]) -> Optional[str]:
        """Why THIS scan cannot ride the fused pushdown kernels, or None
        when it can (flag off, no device, or provisional records that
        need the intent-aware host merge)."""
        if not flags.get_flag("scan_pushdown"):
            return "disabled"
        if self.opts.device == "native":
            return "device"
        if self.regular_db.approx_row_entries() \
                < flags.get_flag("scan_pushdown_min_rows"):
            return "small"
        if self._entry_stream(ht, lower, upper, txn_id) is not None:
            return "intents"
        return None

    def _clamp_scan_bounds(self, lower_doc_key: bytes,
                           upper_doc_key: Optional[bytes]):
        if self.opts.lower_bound_key:
            lower_doc_key = max(lower_doc_key, self.opts.lower_bound_key)
        if self.opts.upper_bound_key is not None:
            upper_doc_key = (self.opts.upper_bound_key
                             if upper_doc_key is None
                             else min(upper_doc_key,
                                      self.opts.upper_bound_key))
        return lower_doc_key, upper_doc_key

    def scan_pushdown(self, read_ht: Optional[HybridTime] = None,
                      lower_doc_key: bytes = b"",
                      upper_doc_key: Optional[bytes] = None,
                      projection=None, spec=None,
                      txn_id: Optional[bytes] = None):
        """Pushdown filtered scan (kernels J, K): rows satisfying
        spec.predicates assembled from one device dispatch, or None when
        this scan must fall back to the host path (reason counted in
        scan_pushdown_fallback_*_total; results identical either way)."""
        from yugabyte_tpu_torch.docdb.scan_spec import PushdownUnsupported
        from yugabyte_tpu_torch.ops.scan import count_pushdown_fallback
        if spec is None or not spec.predicates:
            return None
        ht = self.read_time(read_ht)
        lower_doc_key, upper_doc_key = self._clamp_scan_bounds(
            lower_doc_key, upper_doc_key)
        reason = self._pushdown_gate(ht, lower_doc_key, upper_doc_key,
                                     txn_id)
        if reason is not None:
            count_pushdown_fallback(reason)
            return None
        try:
            entries = self.regular_db.scan_filtered(
                ht.value, spec, lower_doc_key or None, upper_doc_key)
        except PushdownUnsupported as e:  # yblint: contained(typed refusal, not an error: the caller serves the SAME query through the byte-identical host path; the reason is counted for the offload policy)
            count_pushdown_fallback(e.reason)
            return None
        return VisibleEntryRowAssembler(entries, self.schema,
                                        projection=projection)

    def scan_aggregate(self, read_ht: Optional[HybridTime] = None,
                       lower_doc_key: bytes = b"",
                       upper_doc_key: Optional[bytes] = None,
                       spec=None,
                       txn_id: Optional[bytes] = None) -> Optional[dict]:
        """Fused aggregating scan: the aggregate partial for this
        tablet's row range ({"rows", "cols"}), or None when the query
        must fall back to the row path (the caller re-aggregates rows
        host-side — byte/result-identical by construction)."""
        from yugabyte_tpu_torch.docdb.scan_spec import PushdownUnsupported
        from yugabyte_tpu_torch.ops.scan import count_pushdown_fallback
        if spec is None or not spec.aggregates:
            return None
        ht = self.read_time(read_ht)
        lower_doc_key, upper_doc_key = self._clamp_scan_bounds(
            lower_doc_key, upper_doc_key)
        reason = self._pushdown_gate(ht, lower_doc_key, upper_doc_key,
                                     txn_id)
        if reason is not None:
            count_pushdown_fallback(reason)
            return None
        try:
            return self.regular_db.scan_aggregate(
                ht.value, spec, lower_doc_key or None, upper_doc_key)
        except PushdownUnsupported as e:  # yblint: contained(typed refusal: caller re-aggregates rows host-side, result-identical; reason counted)
            count_pushdown_fallback(e.reason)
            return None

    # ------------------------------------------------------------ maintenance
    def write_subdocument(self, doc_key: DocKey, path, doc,
                          timeout_s: float = 10.0):
        """Replicated arbitrary-depth subdocument write (ref
        doc_write_batch.cc InsertSubDocument): a dict becomes an object
        init marker + leaves; the marker overwrites the older subtree."""
        from yugabyte_tpu_torch.docdb.subdocument import subdocument_writes
        ht = self.clock.now()
        kvs = subdocument_writes(doc_key, tuple(path), doc)
        return self.consensus.submit(kvs, ht, timeout_s=timeout_s)

    def delete_subdocument(self, doc_key: DocKey, path,
                           timeout_s: float = 10.0):
        from yugabyte_tpu_torch.docdb.subdocument import delete_subdocument
        ht = self.clock.now()
        return self.consensus.submit(delete_subdocument(doc_key,
                                                        tuple(path)),
                                     ht, timeout_s=timeout_s)

    def read_subdocument(self, doc_key: DocKey, path=(),
                         read_ht=None):
        """Visible subdocument at read_ht (nested dict / primitive /
        None), honoring the ancestor overwrite stack."""
        from yugabyte_tpu_torch.docdb.subdocument import read_subdocument
        ht = self.read_time(read_ht)
        return read_subdocument(self.regular_db, doc_key, tuple(path), ht)

    def memstore_bytes(self) -> int:
        return (self.regular_db.memstore_bytes()
                + self.intents_db.memstore_bytes())

    def oldest_memstore_write_s(self):
        times = [self.regular_db.oldest_memstore_write_s(),
                 self.intents_db.oldest_memstore_write_s()]
        times = [t for t in times if t is not None]
        return min(times) if times else None

    def flush(self) -> None:
        self.regular_db.flush()
        self.intents_db.flush()

    def compact(self) -> None:
        self.regular_db.compact_all()

    def scrub(self, limiter=None, cancel=None) -> dict:
        """At-rest integrity scrub of both DBs (block CRCs + footer +
        index/bloom consistency, throttled; storage/integrity.py). A
        corrupt file parks its DB with a sticky Corruption error, which
        fails this tablet for rebuild-from-peer. Returns the merged
        report."""
        merged = {"files": 0, "blocks": 0, "entries": 0, "bytes": 0,
                  "corrupt": []}
        for db in (self.regular_db, self.intents_db):
            rep = db.scrub(limiter=limiter, cancel=cancel)
            for k in ("files", "blocks", "entries", "bytes"):
                merged[k] += rep[k]
            merged["corrupt"].extend(rep["corrupt"])
        return merged

    def checkpoint(self, out_dir: str) -> None:
        """Hard-link snapshot of both DBs (remote bootstrap / backup input)."""
        self.flush()
        self.regular_db.checkpoint(os.path.join(out_dir, "regular"))
        self.intents_db.checkpoint(os.path.join(out_dir, "intents"))

    # -------------------------------------------------------------- snapshots
    def snapshots_dir(self) -> str:
        return os.path.join(
            os.path.dirname(self.regular_db.db_dir), "snapshots")

    def create_snapshot(self, snapshot_id: str) -> str:
        """Raft-applied snapshot: every replica checkpoints the identical
        applied state under snapshots/<id> (ref tablet/
        snapshot_coordinator.h + ent tserver/backup_service.cc). Idempotent
        for replay."""
        sdir = os.path.join(self.snapshots_dir(), snapshot_id)
        if os.path.exists(sdir):
            return sdir
        tmp = sdir + ".tmp"
        import shutil as _sh
        _sh.rmtree(tmp, ignore_errors=True)
        self.flush()
        self.regular_db.checkpoint(os.path.join(tmp, "regular"))
        self.intents_db.checkpoint(os.path.join(tmp, "intents"))
        os.rename(tmp, sdir)
        TRACE("tablet %s: snapshot %s created", self.tablet_id, snapshot_id)
        return sdir

    def delete_snapshot(self, snapshot_id: str) -> None:
        import shutil as _sh
        _sh.rmtree(os.path.join(self.snapshots_dir(), snapshot_id),
                   ignore_errors=True)

    def list_snapshots(self) -> List[str]:
        d = self.snapshots_dir()
        if not os.path.isdir(d):
            return []
        return sorted(s for s in os.listdir(d) if not s.endswith(".tmp"))

    def split_partition_key(self, hash_partitioning: bool) -> Optional[bytes]:
        """Partition-key-space split point derived from the median doc key
        (hash partitioning: the 2-byte bucket right after the kUInt16Hash
        tag; range partitioning: the encoded doc key itself)."""
        median = self.split_key()
        if median is None:
            return None
        if hash_partitioning:
            return median[1:3] if len(median) >= 3 else None
        return median

    def split_key(self) -> Optional[bytes]:
        """Encoded middle DocKey for tablet splitting (ref tablet.cc:3427
        GetEncodedMiddleSplitKey): median doc key of the live data."""
        docs: List[bytes] = []
        last = None
        for ikey, _v in self.regular_db.iter_from(b""):
            from yugabyte_tpu_torch.docdb.doc_key import split_key_and_ht
            prefix, _ = split_key_and_ht(ikey)
            doc = prefix[:_doc_key_len(prefix)]
            if doc != last:
                docs.append(doc)
                last = doc
        if len(docs) < 2:
            return None
        return docs[len(docs) // 2]

    def cancel_background_work(self, reason: str = "tablet failed") -> None:
        """Abort in-flight background compactions of both DBs at their
        next pipeline-stage boundary (tablet-FAILED / shutdown): a dying
        tablet must not keep a device-offload job running against
        storage that is about to be torn down or re-bootstrapped."""
        self.regular_db.cancel_background_work(reason)
        self.intents_db.cancel_background_work(reason)

    def close(self) -> None:
        self.regular_db.close()
        self.intents_db.close()
