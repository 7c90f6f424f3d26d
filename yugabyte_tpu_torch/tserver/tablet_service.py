"""TabletServiceImpl: the RPC surface of one tablet server.

Counterpart of yugabyte_tpu/tserver/tablet_service.py, with the imports
renamed.

Capability parity with the reference (ref: src/yb/tserver/tablet_service.cc —
Write :1491, Read :1612, leader lookup + NOT_THE_LEADER error with hint; admin
ops CreateTablet/DeleteTablet live in TabletServerAdminService, merged here).
NotLeader errors carry the leader hint in the RPC error `extra` payload the
way the reference embeds TabletServerErrorPB::NOT_THE_LEADER + leader host.
"""

from __future__ import annotations

from typing import List, Optional

from yugabyte_tpu_torch.common.hybrid_time import HybridTime
from yugabyte_tpu_torch.common.wire import (
    doc_key_from_wire, row_to_wire, write_op_from_wire)
from yugabyte_tpu_torch.consensus.raft import (NotLeader, OperationOutcomeUnknown,
                                         ReplicationAborted)
from yugabyte_tpu_torch.tserver.ts_tablet_manager import TSTabletManager
from yugabyte_tpu_torch.utils import flags as _flags
from yugabyte_tpu_torch.utils.status import Code, Status, StatusError

_flags.define_flag(
    "scan_pushdown_pages", False,
    "route predicate-free scan RPC pages (the YCSB-E shape) through the "
    "fused device scan over resident slabs; default off — the per-page "
    "dispatch only wins once the working set is resident (bench.py "
    "enables it for the analytics/YCSB-E rungs)")


def _scan_page_counters(pushed: bool) -> None:
    """scan-RPC page accounting: total vs device-served — the numerator/
    denominator of the bench's ycsb_e_pushdown_ratio."""
    from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
    e = ROOT_REGISTRY.entity("server", "scan_pushdown")
    e.counter("scan_rpc_pages_total",
              "scan RPC pages served").increment()
    if pushed:
        e.counter("scan_rpc_pages_pushdown_total",
                  "scan RPC pages served through the fused device scan "
                  "path").increment()


class NotLeaderError(StatusError):
    def __init__(self, leader_hint: Optional[str]):
        super().__init__(Status(Code.ILLEGAL_STATE, "not the leader"))
        self.extra = {"not_leader": True, "leader_hint": leader_hint}


def _leader_server_hint(e: NotLeader) -> Optional[str]:
    """Raft leader hints are peer addresses '<server>/<tablet>'."""
    if e.leader_hint is None:
        return None
    return e.leader_hint.split("/", 1)[0]


def _row_matches(row_dict: dict, filters: List[List]) -> bool:
    from yugabyte_tpu_torch.common.wire import row_matches
    try:
        return row_matches(row_dict, filters)
    except ValueError as e:
        raise StatusError(Status.NotSupported(str(e))) from e


class TabletServiceImpl:
    def __init__(self, tablet_manager: TSTabletManager, addr_updater=None,
                 coordinator=None, client_provider=None,
                 overload_provider=None):
        self._tablets = tablet_manager
        self._addr_updater = addr_updater or (lambda m: None)
        self.coordinator = coordinator
        self._client_provider = client_provider or (lambda: None)
        self._overload_provider = overload_provider or (lambda: {})

    def _leader_peer(self, tablet_id: str):
        peer = self._tablets.get_tablet(tablet_id)
        try:
            # Lease-checked, not just is_leader(): a deposed leader behind a
            # partition must not serve (stale txn statuses would tear
            # snapshots; ref leader_lease.h).
            peer.check_leader_lease()
        except NotLeader as e:
            raise NotLeaderError(_leader_server_hint(e)) from e
        return peer

    # ---------------------------------------------------------------- writes
    def _check_schema_version(self, tablet_id: str,
                              client_version: Optional[int]) -> None:
        """Write/read ops encode columns by name against the TABLET's
        schema; a client ahead of this replica (its ALTER TABLE has not
        propagated here yet) must be rejected retryably — the client's
        backoff outlives the heartbeat that delivers the new schema (ref
        the tablet schema version mismatch error in the reference write
        path)."""
        if not client_version:
            return
        local = self._tablets.tablet_meta(tablet_id).get(
            "schema_version", 0)
        if client_version > local:
            raise StatusError(Status.ServiceUnavailable(
                f"tablet {tablet_id} schema version {local} behind "
                f"client {client_version}; retry"))

    def write(self, tablet_id: str, ops: List[dict],
              timeout_s: float = 15.0, txn: Optional[dict] = None,
              client_id: Optional[bytes] = None,
              request_id: Optional[int] = None,
              schema_version: Optional[int] = None,
              txn_write_id_base: int = 0) -> dict:
        from yugabyte_tpu_torch.docdb.conflict_resolution import (
            TransactionConflict)
        from yugabyte_tpu_torch.docdb.intents import TransactionMetadata
        from yugabyte_tpu_torch.tablet.tablet import TabletHasBeenSplit
        self._check_schema_version(tablet_id, schema_version)
        peer = self._tablets.get_tablet(tablet_id)
        decoded = [write_op_from_wire(w) for w in ops]
        # Key-bounds guard: after a split, a stale client batch may span
        # both children; accepting out-of-range keys would strand data in a
        # tablet that never serves them (ref CheckOperationAllowed key
        # bounds validation in the reference write path).
        lo = peer.tablet.opts.lower_bound_key
        hi = peer.tablet.opts.upper_bound_key
        if lo or hi is not None:
            for op in decoded:
                enc = op.doc_key.encode()
                if (lo and enc < lo) or (hi is not None and enc >= hi):
                    err = StatusError(Status.IllegalState(
                        f"key outside tablet range of {tablet_id}"))
                    err.extra = {"wrong_tablet": True}
                    raise err
        request = ((client_id, request_id)
                   if client_id is not None and request_id is not None
                   else None)
        try:
            if txn is not None:
                ht = peer.write_transactional(
                    decoded, TransactionMetadata.from_wire(txn),
                    timeout_s=timeout_s,
                    write_id_base=txn_write_id_base)
            else:
                ht = peer.write(decoded, timeout_s=timeout_s,
                                request=request)
        except TransactionConflict as e:
            err = StatusError(Status.TryAgain(str(e)))
            err.extra = {"txn_conflict": True}
            raise err from e
        except NotLeader as e:
            raise NotLeaderError(_leader_server_hint(e)) from e
        except TabletHasBeenSplit as e:
            err = StatusError(Status.IllegalState(str(e)))
            err.extra = {"tablet_split": True}
            raise err from e
        except OperationOutcomeUnknown as e:
            raise StatusError(Status.TimedOut(str(e))) from e
        except ReplicationAborted as e:
            # The op provably did NOT commit — its entry was overwritten by
            # a new leader's history. Safe to retry verbatim; the client's
            # retry loop re-resolves the (changed) leader. Tagged via extra
            # rather than bare Code.ABORTED: aborted is ALSO a terminal
            # transaction answer (txn_commit of an expired txn), which must
            # surface, not retry. ref: WriteQuery's retryable abort.
            err = StatusError(Status.Aborted(str(e)))
            err.extra = {"replication_aborted": True}
            raise err from e
        return {"propagated_ht": ht.value}

    # ----------------------------------------------------------------- reads
    def read_row(self, tablet_id: str, doc_key: dict,
                 read_ht: Optional[int] = None,
                 projection: Optional[List[str]] = None,
                 allow_follower: bool = False,
                 txn_id: Optional[bytes] = None,
                 schema_version: Optional[int] = None) -> Optional[dict]:
        self._check_schema_version(tablet_id, schema_version)
        peer = self._tablets.get_tablet(tablet_id)
        try:
            row = peer.read_row(
                doc_key_from_wire(doc_key),
                HybridTime(read_ht) if read_ht else None,
                projection=tuple(projection) if projection else None,
                allow_follower=allow_follower, txn_id=txn_id)
        except NotLeader as e:
            raise NotLeaderError(_leader_server_hint(e)) from e
        return None if row is None else row_to_wire(row)

    def multi_read(self, tablet_id: str, doc_keys: List[dict],
                   read_ht: Optional[int] = None,
                   projection: Optional[List[str]] = None,
                   allow_follower: bool = False,
                   schema_version: Optional[int] = None) -> dict:
        """Multi-key point-row read: one RPC, one lease check and one
        read-point resolution for the whole batch; the SST layer resolves
        the flat rows through the batched device kernels (DB.multi_get).
        Response rows align with the request keys (None = absent)."""
        self._check_schema_version(tablet_id, schema_version)
        peer = self._tablets.get_tablet(tablet_id)
        try:
            rows = peer.multi_read(
                [doc_key_from_wire(d) for d in doc_keys],
                HybridTime(read_ht) if read_ht else None,
                projection=tuple(projection) if projection else None,
                allow_follower=allow_follower)
        except NotLeader as e:
            raise NotLeaderError(_leader_server_hint(e)) from e
        return {"rows": [None if r is None else row_to_wire(r)
                         for r in rows]}

    def scan(self, tablet_id: str, lower_doc_key: bytes = b"",
             upper_doc_key: Optional[bytes] = None,
             read_ht: Optional[int] = None,
             projection: Optional[List[str]] = None,
             limit: int = 10_000,
             filters: Optional[List[List]] = None,
             txn_id: Optional[bytes] = None,
             aggregates: Optional[List[List]] = None) -> dict:
        """Bounded range scan; returns rows + a resume key when `limit` is
        hit (the reference pages exactly this way, ref
        pgsql_operation.cc:1040 paging state).

        filters: optional [[col, op, value], ...] conjunction evaluated
        before rows cross the wire — the pushed-down WHERE clause (ref:
        ybgate expression pushdown, pgsql_operation.cc:1088). Triples in
        the device-compilable subset (docdb/scan_spec.py) run inside the
        fused filtered kernel over the resident slab matrices; the rest
        evaluate host-side here. Results are identical either way.

        aggregates: optional [[fn, col_or_None], ...] — when the whole
        (filters, aggregates) pair is compilable, the response is
        {"agg": {rows, cols}, "read_ht"} computed by ONE fused device
        dispatch; otherwise rows return as usual and the caller
        aggregates them (the byte/result-identical fallback, counted by
        reason in scan_pushdown_fallback_*_total)."""
        from yugabyte_tpu_torch.docdb import scan_spec as SS
        from yugabyte_tpu_torch.ops.scan import count_pushdown_fallback
        peer = self._tablets.get_tablet(tablet_id)
        if not peer.raft.is_leader():
            raise NotLeaderError(_leader_server_hint(
                NotLeader(peer.raft.leader_hint())))
        try:
            peer.check_leader_lease()
        except NotLeader as e:
            raise NotLeaderError(_leader_server_hint(e)) from e
        # Pin the snapshot: resolve the read point ONCE and return it so the
        # client re-sends it for later pages and other tablets — otherwise a
        # multi-page scan is torn across concurrent writes (the reference
        # pins used_read_time in the paging state).
        ht = peer.tablet.read_time(HybridTime(read_ht) if read_ht else None)
        schema = peer.tablet.schema
        proj = tuple(projection) if projection else None
        spec = None
        host_filters = filters
        if filters or aggregates:
            spec, leftover, reason = SS.compile_filters(
                schema, filters, aggregates)
            if spec is None:
                count_pushdown_fallback(reason)
        if aggregates and spec is not None:
            partial = peer.tablet.scan_aggregate(
                ht, lower_doc_key=lower_doc_key,
                upper_doc_key=upper_doc_key, spec=spec, txn_id=txn_id)
            if partial is not None:
                return {"agg": partial, "read_ht": ht.value}
            spec = None  # rows-mode fallback: the caller aggregates
        it = None
        pushed = False
        if spec is not None and spec.predicates:
            it = peer.tablet.scan_pushdown(
                ht, lower_doc_key=lower_doc_key,
                upper_doc_key=upper_doc_key, projection=proj, spec=spec,
                txn_id=txn_id)
            if it is not None:
                pushed = True
                host_filters = leftover
        if it is None and not filters and not aggregates \
                and _flags.get_flag("scan_pushdown_pages") \
                and peer.tablet.regular_db.approx_row_entries() \
                >= _flags.get_flag("scan_pushdown_min_rows"):
            # predicate-free pages (the YCSB-E shape) ride the fused
            # scan kernel over resident slabs when eligible; the CPU
            # iterator stays the default (flag-gated: a per-page device
            # dispatch only wins once the working set is resident)
            it = peer.tablet.scan(
                ht, lower_doc_key=lower_doc_key,
                upper_doc_key=upper_doc_key, projection=proj,
                use_device=True, txn_id=txn_id)
            pushed = True
        if it is None:
            it = peer.tablet.scan(
                ht, lower_doc_key=lower_doc_key,
                upper_doc_key=upper_doc_key, projection=proj,
                use_device=False, txn_id=txn_id)
        _scan_page_counters(pushed)
        rows = []
        resume_key = None
        scanned = 0
        for row in it:
            scanned += 1
            if host_filters and not _row_matches(row.to_dict(schema),
                                                 host_filters):
                # a filtered-out row still advances the paging cursor so a
                # highly-selective predicate can't pin the scan in place
                if scanned >= limit * 4:
                    resume_key = row.doc_key.encode() + b"\xff"
                    break
                continue
            rows.append(row_to_wire(row))
            if len(rows) >= limit:
                resume_key = row.doc_key.encode() + b"\xff"
                break
        return {"rows": rows, "resume_key": resume_key, "read_ht": ht.value,
                "pushdown": pushed}

    def dump_tablet(self, tablet_id: str, read_ht: int,
                    limit: int = 100_000) -> dict:
        """Resolved rows of THIS replica at read_ht (leader or follower) —
        the row-level companion of checksum_tablet for divergence
        debugging (ysck deep mode / cluster_verifier forensics)."""
        peer = self._tablets.get_tablet(tablet_id)
        peer.tablet.mvcc.safe_time(min_allowed=HybridTime(read_ht))
        rows = []
        for row in peer.tablet.scan(HybridTime(read_ht), use_device=False):
            rows.append([row.doc_key.encode(),
                         repr(sorted(row.columns.items())),
                         row.write_ht.value])
            if len(rows) >= limit:
                break
        raft = peer.raft
        return {"rows": rows,
                "raft": {"role": raft.role.value,
                         "term": raft.current_term,
                         "commit_index": raft.commit_index,
                         "last_applied": raft.last_applied,
                         "last_index": raft._last_index}}

    def checksum_tablet(self, tablet_id: str, read_ht: int) -> dict:
        """Order-independent digest of the VISIBILITY-RESOLVED rows at
        read_ht on THIS replica (leader or follower) — the cross-replica
        consistency probe of the crash-fault harness (ref:
        integration-tests/cluster_verifier.h checksumming all replicas).

        Resolved rows, not raw entries: replicas at different compaction
        progress hold different physical version sets for identical
        logical state, and the normal scan path also pins SSTs against a
        concurrent compaction's file deletion. Waits until the propagated
        safe time covers read_ht so lagging followers converge."""
        import hashlib

        peer = self._tablets.get_tablet(tablet_id)
        peer.tablet.mvcc.safe_time(min_allowed=HybridTime(read_ht))
        total = 0
        digest = 0
        for row in peer.tablet.scan(HybridTime(read_ht), use_device=False):
            body = (row.doc_key.encode() + b"\x00"
                    + repr((sorted(row.columns.items()),
                            row.write_ht.value)).encode())
            h = hashlib.blake2b(body, digest_size=8).digest()
            digest ^= int.from_bytes(h, "little")  # order-independent
            total += 1
        return {"checksum": digest, "entries": total}

    # ------------------------------------------------------------------ CDC
    def cdc_get_changes(self, tablet_id: str, from_index: int,
                        max_records: int = 1000,
                        emit_after: Optional[int] = None,
                        stream_id: str = "default") -> dict:
        """Change stream for xCluster consumers (ref:
        ent/src/yb/cdc/cdc_service.cc GetChanges). WAL retention anchors
        at the MIN checkpoint across streams (cdc_min_replicated_index):
        one fast consumer must not let GC eat a slower one's backlog.
        The producer (cdc/producer.py) comes with ROADMAP queue A item
        7g: until then this raises."""
        raise NotImplementedError(
            "cdc_get_changes needs the port's cdc/ (ROADMAP queue A item "
            "7g)")

    # --------------------------------------------------------- index backfill
    def backfill_index_tablet(self, tablet_id: str, namespace: str,
                              index_table: str, column,
                              batch_rows: int = 1024) -> dict:
        """Scan this tablet at a snapshot and write index entries stamped
        at that read time (tablet-side backfill, ref tablet.cc:2088
        BackfillIndexes; chunked like backfill_index.cc BackfillChunk).
        Concurrent maintenance writes — stamped at now() — supersede these
        backfilled entries by MVCC. The index codec (common/index.py)
        comes with ROADMAP queue A item 7f: until then this raises."""
        raise NotImplementedError(
            "backfill_index_tablet needs the port's common/index (ROADMAP "
            "queue A item 7f)")

    # ----------------------------------------------------------- admin + ops
    def create_tablet(self, tablet_id: str, table_id: str, schema: dict,
                      peer_server_ids: List[str],
                      partition: Optional[dict] = None,
                      hash_partitioning: bool = True,
                      addr_map: Optional[dict] = None) -> bool:
        # The master ships the current address map with the request so the
        # new replica can reach its consensus peers before the first
        # heartbeat response refreshes it.
        if addr_map:
            self._addr_updater(addr_map)
        self._tablets.create_tablet(tablet_id, table_id, schema,
                                    peer_server_ids, partition,
                                    hash_partitioning)
        return True

    def delete_tablet(self, tablet_id: str) -> bool:
        self._tablets.delete_tablet(tablet_id)
        return True

    def alter_tablet_schema(self, tablet_id: str, schema: dict,
                            version: int) -> bool:
        return self._tablets.alter_tablet_schema(tablet_id, schema,
                                                 version)

    # ---------------------------------------------- replica movement (LB)
    def begin_remote_bootstrap(self, tablet_id: str) -> dict:
        peer = self._tablets.get_tablet(tablet_id)
        return self._tablets.rb_sessions.begin(
            peer, self._tablets.tablet_meta(tablet_id))

    def fetch_remote_bootstrap(self, session_id: str, relpath: str,
                               offset: int, length: int) -> bytes:
        return self._tablets.rb_sessions.fetch(session_id, relpath,
                                               offset, length)

    def end_remote_bootstrap(self, session_id: str) -> bool:
        self._tablets.rb_sessions.end(session_id)
        return True

    def start_remote_bootstrap(self, tablet_id: str,
                               source_addr: str) -> bool:
        self._tablets.start_remote_bootstrap(tablet_id, source_addr)
        return True

    def change_config(self, tablet_id: str, add: List[str] = (),
                      remove: List[str] = ()) -> bool:
        """Add/remove one replica server on this tablet's Raft group
        (leader-only; ref consensus ChangeConfig RPC)."""
        from yugabyte_tpu_torch.consensus.raft import (
            ConfigAlreadyApplied, ConfigChangeInProgress)
        from yugabyte_tpu_torch.tablet.tablet_peer import peer_address
        peer = self._tablets.get_tablet(tablet_id)
        try:
            peer.raft.change_config(
                add=[peer_address(s, tablet_id) for s in add],
                remove=[peer_address(s, tablet_id) for s in remove])
        except NotLeader as e:
            raise NotLeaderError(_leader_server_hint(e)) from e
        except ConfigAlreadyApplied:
            return True  # idempotent retry
        except ConfigChangeInProgress as e:
            raise StatusError(Status.TryAgain(str(e))) from e
        return True

    # ------------------------------------------- transaction coordinator
    # (status-tablet ops; ref transaction_coordinator.h. The RPC layer
    # leader-checks, the coordinator serializes check-and-set per txn.)
    def txn_create(self, tablet_id: str, txn_id: bytes) -> dict:
        return self.coordinator.create(self._leader_peer(tablet_id), txn_id)

    def txn_heartbeat(self, tablet_id: str, txn_id: bytes) -> bool:
        return self.coordinator.heartbeat(self._leader_peer(tablet_id),
                                          txn_id)

    def txn_status(self, tablet_id: str, txn_id: bytes,
                   observing_read_ht: Optional[int] = None) -> dict:
        return self.coordinator.status(self._leader_peer(tablet_id), txn_id,
                                       observing_read_ht)

    def txn_commit(self, tablet_id: str, txn_id: bytes,
                   participants: List[List]) -> dict:
        return self.coordinator.commit(self._leader_peer(tablet_id), txn_id,
                                       participants)

    def txn_abort(self, tablet_id: str, txn_id: bytes,
                  participants: List[List]) -> bool:
        return self.coordinator.abort(self._leader_peer(tablet_id), txn_id,
                                      participants)

    # ----------------------------------------- transaction participant
    def apply_transaction(self, tablet_id: str, txn_id: bytes,
                          commit_ht: int) -> bool:
        """Move committed intents into the regular DB (ref
        tablet.cc:1670 ApplyIntents, raft-replicated)."""
        from yugabyte_tpu_torch.consensus.raft import NotLeader as NL
        try:
            self._leader_peer(tablet_id).submit_txn_update(
                "apply", txn_id, commit_ht)
        except NL as e:
            raise NotLeaderError(_leader_server_hint(e)) from e
        return True

    def cleanup_transaction(self, tablet_id: str, txn_id: bytes,
                            commit_ht: int = 0) -> bool:
        from yugabyte_tpu_torch.consensus.raft import NotLeader as NL
        try:
            self._leader_peer(tablet_id).submit_txn_update(
                "cleanup", txn_id, 0)
        except NL as e:
            raise NotLeaderError(_leader_server_hint(e)) from e
        return True

    def split_tablet(self, tablet_id: str) -> List[str]:
        try:
            return self._tablets.split_tablet(tablet_id)
        except NotLeader as e:
            raise NotLeaderError(_leader_server_hint(e)) from e

    # -------------------------------------------------- snapshots / backup
    def snapshot_tablet(self, tablet_id: str, snapshot_id: str) -> bool:
        """Raft-replicated snapshot barrier (ref backup_service.cc
        TabletSnapshotOp)."""
        try:
            self._leader_peer(tablet_id).submit_snapshot(snapshot_id)
        except NotLeader as e:
            raise NotLeaderError(_leader_server_hint(e)) from e
        return True

    def list_tablet_snapshots(self, tablet_id: str) -> List[str]:
        return self._tablets.get_tablet(tablet_id).tablet.list_snapshots()

    def delete_tablet_snapshot(self, tablet_id: str,
                               snapshot_id: str) -> bool:
        self._tablets.get_tablet(tablet_id).tablet.delete_snapshot(
            snapshot_id)
        return True

    def snapshot_manifest(self, tablet_id: str,
                          snapshot_id: str) -> List[List]:
        """[(relpath, size)] of a snapshot's files, for export."""
        import os
        peer = self._tablets.get_tablet(tablet_id)
        sdir = os.path.join(peer.tablet.snapshots_dir(), snapshot_id)
        if not os.path.isdir(sdir):
            raise StatusError(Status.NotFound(
                f"snapshot {snapshot_id} of {tablet_id}"))
        out = []
        for dirpath, _d, filenames in os.walk(sdir):
            for fn in filenames:
                p = os.path.join(dirpath, fn)
                out.append([os.path.relpath(p, sdir), os.path.getsize(p)])
        return out

    def fetch_snapshot_file(self, tablet_id: str, snapshot_id: str,
                            relpath: str, offset: int,
                            length: int) -> bytes:
        import os
        peer = self._tablets.get_tablet(tablet_id)
        sdir = os.path.join(peer.tablet.snapshots_dir(), snapshot_id)
        p = os.path.normpath(os.path.join(sdir, relpath))
        if not p.startswith(os.path.normpath(sdir) + os.sep):
            raise StatusError(Status.InvalidArgument(
                f"path escape: {relpath!r}"))
        with open(p, "rb") as f:
            f.seek(offset)
            return f.read(min(length, 1 << 20))

    def flush_tablet(self, tablet_id: str) -> bool:
        self._tablets.get_tablet(tablet_id).tablet.flush()
        return True

    # ------------------------------------------------------ data integrity
    def scrub_status(self, tablet_id: str) -> dict:
        """Per-replica integrity state: at-rest scrub timestamp/totals +
        corruption flags (ysck surfaces these per tablet)."""
        peer = self._tablets.get_tablet(tablet_id)
        return {"tablet_id": tablet_id, "state": peer.state,
                "failed_corrupt": bool(getattr(peer, "failed_corrupt",
                                               False)),
                "scrub": dict(getattr(peer, "scrub_state", None) or {})}

    def scrub_tablet(self, tablet_id: str) -> dict:
        """On-demand at-rest scrub of one replica (operator/ysck hook;
        the background ScrubTabletsOp drives the same path on its
        interval)."""
        from yugabyte_tpu_torch.storage import integrity
        peer = self._tablets.get_tablet(tablet_id)
        return peer.tablet.scrub(limiter=integrity.scrub_rate_limiter())

    def vouch_tablet(self, tablet_id: str, read_ht: int = 0) -> bool:
        """Leader-driven follower-read license: the caller (the digest
        exchange on the tablet's leader, tablet_server.py
        _scrub_digest_check) verified this replica's resolved rows match
        the leader's at read_ht. Valid for follower_read_vouch_ttl_s;
        re-granted every clean exchange round."""
        self._tablets.get_tablet(tablet_id).grant_vouch(read_ht)
        return True

    def mark_tablet_failed(self, tablet_id: str, reason: str,
                           corrupt: bool = False) -> bool:
        """Externally-driven FAILED transition: the scrub digest
        exchange fails a diverged follower through this (corrupt=True,
        so the master rebuilds it from a healthy peer rather than
        retrying in place)."""
        peer = self._tablets.get_tablet(tablet_id)
        st = (Status.Corruption(reason) if corrupt
              else Status.IoError(reason))
        peer.mark_failed(st)
        return True

    def compact_tablet(self, tablet_id: str) -> bool:
        self._tablets.get_tablet(tablet_id).tablet.compact()
        return True

    def list_tablets(self) -> List[str]:
        return self._tablets.tablet_ids()

    def status(self) -> dict:
        return {"server_id": self._tablets.server_id,
                "tablets": self._tablets.generate_report()}

    def scan_pushdown_status(self) -> dict:
        """The /compactionz "scans" block over RPC (webserver-less
        external nodes): pushdown hit/fallback counters by reason,
        per-bucket dispatches, blocks-decoded histogram, and the scan-
        page routing counters the bench's ycsb_e_pushdown_ratio reads."""
        from yugabyte_tpu_torch.ops.scan import pushdown_snapshot
        from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
        e = ROOT_REGISTRY.entity("server", "scan_pushdown")
        snap = pushdown_snapshot()
        snap["scan_rpc_pages_total"] = e.counter(
            "scan_rpc_pages_total", "scan RPC pages served").value()
        snap["scan_rpc_pages_pushdown_total"] = e.counter(
            "scan_rpc_pages_pushdown_total",
            "scan RPC pages served through the fused device scan "
            "path").value()
        return {"server_id": self._tablets.server_id, "scans": snap}

    def overload_status(self) -> dict:
        """The /servez overload block over RPC: bounded-queue + shed
        counters + per-tablet write-pressure state. External-cluster
        benches and the overload soak scrape this per node (their
        tservers run webserver-less, so the RPC is the only window)."""
        return {"server_id": self._tablets.server_id,
                "overload": self._overload_provider()}
