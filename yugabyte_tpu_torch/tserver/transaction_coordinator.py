"""TransactionCoordinator: the status-tablet state machine.

Counterpart of yugabyte_tpu/tserver/transaction_coordinator.py, with the
imports renamed.

Capability parity with the reference (ref: src/yb/tablet/
transaction_coordinator.h:86 — per-status-tablet transaction records
PENDING/COMMITTED/ABORTED replicated through the tablet's Raft group,
client heartbeats keeping transactions alive, expired transactions aborted,
participants notified to apply/cleanup after resolution).

Status records are plain rows in the `system.transactions` table, written
through the ordinary WriteQuery/Raft/LSM pipeline — replication and
failover need no special handling. The coordinator layer adds the
check-and-set serialization (leader-local mutex per transaction) and the
participant notification fan-out.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from yugabyte_tpu_torch.common.hybrid_time import HybridTime
from yugabyte_tpu_torch.common.schema import ColumnSchema, DataType, Schema
from yugabyte_tpu_torch.docdb.doc_key import DocKey
from yugabyte_tpu_torch.docdb.doc_operations import QLWriteOp, WriteOpKind
from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils.status import Status, StatusError
from yugabyte_tpu_torch.utils.trace import TRACE
from yugabyte_tpu_torch.utils import lock_rank

flags.define_flag("transaction_timeout_ms", 10_000,
                  "a pending transaction whose last heartbeat is older than "
                  "this is aborted (ref transaction_abort_check_timeout_ms)")
flags.define_flag("txn_notify_attempts", 6,
                  "participant apply/cleanup notification retries")

TRANSACTIONS_TABLE = "transactions"
SYSTEM_NAMESPACE = "system"

TXN_STATUS_SCHEMA = Schema(
    columns=[
        ColumnSchema("txn_id", DataType.BINARY),
        ColumnSchema("status", DataType.STRING),
        ColumnSchema("commit_ht", DataType.INT64),
        ColumnSchema("participants", DataType.STRING),
        ColumnSchema("heartbeat_ms", DataType.INT64),
    ],
    num_hash_key_columns=1)

_COL_STATUS = TXN_STATUS_SCHEMA.column_id("status")
_COL_COMMIT_HT = TXN_STATUS_SCHEMA.column_id("commit_ht")
_COL_HEARTBEAT = TXN_STATUS_SCHEMA.column_id("heartbeat_ms")
_COL_PARTICIPANTS = TXN_STATUS_SCHEMA.column_id("participants")


def _now_ms() -> int:
    return int(time.time() * 1000)


class TransactionCoordinator:
    """Coordinator operations over locally hosted status tablets. Every
    method takes the status tablet's TabletPeer (leader-checked by the
    RPC layer above)."""

    def __init__(self, leader_resolver=None, messenger=None):
        # leader_resolver(tablet_id) -> addr for participant notification
        self._leader_resolver = leader_resolver or (lambda tid: None)
        self._messenger = messenger
        self._mutexes: Dict[bytes, threading.Lock] = {}  # guarded-by: _mutexes_lock
        self._mutexes_lock = lock_rank.tracked(
            threading.Lock(), "txn_coordinator._mutexes_lock")

    def _txn_mutex(self, txn_id: bytes) -> threading.Lock:
        with self._mutexes_lock:
            return self._mutexes.setdefault(txn_id, threading.Lock())

    def _drop_mutex(self, txn_id: bytes) -> None:
        """Terminal states prune the per-txn mutex (unbounded otherwise);
        a racing late op simply recreates it."""
        with self._mutexes_lock:
            self._mutexes.pop(txn_id, None)

    @staticmethod
    def _key(txn_id: bytes) -> DocKey:
        return DocKey(hash_components=(txn_id,))

    def _read(self, peer, txn_id: bytes) -> Optional[dict]:
        row = peer.tablet.read_row(self._key(txn_id))
        if row is None:
            return None
        return {"status": row.columns.get(_COL_STATUS),
                "commit_ht": row.columns.get(_COL_COMMIT_HT),
                "heartbeat_ms": row.columns.get(_COL_HEARTBEAT),
                "participants": row.columns.get(_COL_PARTICIPANTS)}

    # --------------------------------------------------------------- ops
    def create(self, peer, txn_id: bytes) -> dict:
        """Register a new pending transaction; returns its read point
        (the coordinator clock's now — all txn reads snapshot here)."""
        read_ht = peer.clock.now()
        peer.write([QLWriteOp(WriteOpKind.INSERT, self._key(txn_id),
                              {"status": "pending",
                               "heartbeat_ms": _now_ms()})])
        return {"read_ht": read_ht.value}

    def heartbeat(self, peer, txn_id: bytes) -> bool:
        with self._txn_mutex(txn_id):
            rec = self._read(peer, txn_id)
            if rec is None or rec["status"] != "pending":
                raise StatusError(Status.Expired(
                    f"txn {txn_id.hex()[:8]} is "
                    f"{rec['status'] if rec else 'unknown'}"))
            peer.write([QLWriteOp(WriteOpKind.UPDATE, self._key(txn_id),
                                  {"heartbeat_ms": _now_ms()})])
        return True

    def status(self, peer, txn_id: bytes,
               observing_read_ht: Optional[int] = None) -> dict:
        """Resolve a transaction's fate; lazily aborts expired pending
        transactions (ref coordinator expiration check).

        `observing_read_ht`: the reader's pinned snapshot. Folding it into
        this coordinator's hybrid clock BEFORE answering guarantees any
        LATER commit of this transaction gets commit_ht > the snapshot —
        so a 'pending' answer can never be torn by a subsequent commit
        landing inside the already-served snapshot (ref: the reference
        floors commit time above outstanding status-request times)."""
        if observing_read_ht:
            peer.clock.update(HybridTime(observing_read_ht))
        # The whole read runs under the per-txn mutex: commit() holds it
        # from picking commit_ht until the replicated write applies, so a
        # status read can never land inside that window and answer
        # 'pending' for a transaction about to commit at
        # commit_ht <= observing_read_ht (which would tear the snapshot —
        # the clock folding above only covers commits that START after us).
        with self._txn_mutex(txn_id):
            rec = self._read(peer, txn_id)
            if rec is None:
                # Never created here or already GC'd: treat as aborted
                # (the reference returns ABORTED for unknown transactions).
                return {"status": "aborted", "commit_ht": None}
            if rec["status"] == "pending":
                timeout = flags.get_flag("transaction_timeout_ms")
                if _now_ms() - (rec["heartbeat_ms"] or 0) > timeout:
                    # Lazy expiry: a concurrent heartbeat renewal can't be
                    # stomped by a stale-read abort — we hold the mutex.
                    self._abort_locked(peer, txn_id, [], rec)
                    self._drop_mutex(txn_id)
                    return {"status": "aborted", "commit_ht": None}
            return {"status": rec["status"], "commit_ht": rec["commit_ht"]}

    def commit(self, peer, txn_id: bytes,
               participants: List[List]) -> dict:
        """COMMIT: check-and-set pending -> committed with a commit hybrid
        time, then fan out apply notifications (ref
        TransactionCoordinator::ProcessReplicated COMMITTED branch)."""
        import json
        with self._txn_mutex(txn_id):
            rec = self._read(peer, txn_id)
            if rec is None:
                raise StatusError(Status.Expired(
                    f"txn {txn_id.hex()[:8]} unknown (expired?)"))
            if rec["status"] == "committed":
                return {"commit_ht": rec["commit_ht"]}  # idempotent retry
            if rec["status"] != "pending":
                raise StatusError(Status.Aborted(
                    f"txn {txn_id.hex()[:8]} already {rec['status']}"))
            commit_ht = peer.clock.now()
            peer.write([QLWriteOp(
                WriteOpKind.UPDATE, self._key(txn_id),
                {"status": "committed", "commit_ht": commit_ht.value,
                 "participants": json.dumps(participants)})])
        self._notify_async(txn_id, "apply_transaction", participants,
                           commit_ht.value)
        self._drop_mutex(txn_id)
        return {"commit_ht": commit_ht.value}

    def abort(self, peer, txn_id: bytes,
              participants: List[List]) -> bool:
        with self._txn_mutex(txn_id):
            rec = self._read(peer, txn_id)
            self._abort_locked(peer, txn_id, participants, rec)
        self._drop_mutex(txn_id)
        return True

    def _abort_locked(self, peer, txn_id: bytes,
                      participants: List[List],
                      rec: Optional[dict]) -> None:
        import json
        if rec is not None and rec["status"] == "committed":
            raise StatusError(Status.IllegalState(
                f"txn {txn_id.hex()[:8]} already committed"))
        if rec is not None and not participants and \
                rec.get("participants"):
            participants = json.loads(rec["participants"])
        peer.write([QLWriteOp(
            WriteOpKind.INSERT, self._key(txn_id),
            {"status": "aborted",
             "participants": json.dumps(participants or [])})])
        self._notify_async(txn_id, "cleanup_transaction", participants, 0)

    # -------------------------------------------------- participant fanout
    def _notify_async(self, txn_id: bytes, mth: str,
                      participants: List[List], commit_ht: int) -> None:
        if not participants or self._messenger is None:
            return
        threading.Thread(
            target=self._notify, daemon=True,
            name=f"txn-notify-{txn_id.hex()[:8]}",
            args=(txn_id, mth, participants, commit_ht)).start()

    def _notify(self, txn_id: bytes, mth: str, participants: List[List],
                commit_ht: int) -> None:
        pending = {tuple(p) for p in participants}
        for attempt in range(flags.get_flag("txn_notify_attempts")):
            for tablet_id, addr in list(pending):
                target = self._leader_resolver(tablet_id) or addr
                if target is None:
                    continue
                try:
                    self._messenger.call(
                        target, "tserver", mth, timeout_s=10.0,
                        tablet_id=tablet_id, txn_id=txn_id,
                        commit_ht=commit_ht)
                    pending.discard((tablet_id, addr))
                except StatusError:
                    pass
            if not pending:
                return
            time.sleep(0.3 * (attempt + 1))
        TRACE("txn %s: %s never reached %s", txn_id.hex()[:8], mth, pending)
