"""TabletPeer: a replicated tablet = Tablet + RaftConsensus + WAL.

Counterpart of yugabyte_tpu/tablet/tablet_peer.py, with the imports
renamed. Each replica's Tablet is built from the options it is given,
and the port's TabletOptions.device=None is the card: a default peer
applies into a card tablet (and raises without CUDA); device="native"
is the device-free replica.

Capability parity with the reference (ref: src/yb/tablet/tablet_peer.h:129 —
glue between Tablet, RaftConsensus and the Log; write submission
tablet_peer.cc:638 `WriteAsync`/:655 `Submit`; bootstrap = WAL replay,
ref tablet/tablet_bootstrap.cc:195 `ReplayState` and
`Tablet::MaxPersistentOpId` tablet.cc:2931).

Key flows:
- Leader write: Tablet.write -> RaftWriteContext.submit -> raft.replicate
  (WAL append + majority ack + in-order apply) -> returns op id. The apply
  callback feeds Tablet.apply_write_batch on every replica.
- Follower safety: writes are rejected with NotLeader; reads serve at the
  leader's propagated safe time (ref mvcc.h:93).
- Bootstrap: storage frontiers tell how far the DBs persisted; WAL entries
  above that (up to the durable committed floor) replay into the tablet,
  the rest stay pending in Raft until a leader commits or truncates them.
- Transport addressing: each peer of each tablet's Raft group registers as
  "<server_id>/<tablet_id>" so one fabric serves many tablets per server
  (the reference routes consensus RPCs by tablet id the same way).
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import List, Optional, Sequence, Tuple

from yugabyte_tpu_torch.common.hybrid_time import HybridClock, HybridTime
from yugabyte_tpu_torch.common.schema import Schema
from yugabyte_tpu_torch.consensus.log import Log, LogReader
from yugabyte_tpu_torch.consensus.raft import (
    OP_SNAPSHOT, OP_SPLIT, OP_UPDATE_TXN, OP_WRITE, NotLeader,
    OperationOutcomeUnknown, RaftConfig, RaftConsensus, ReplicateMsg,
    ReplicationTimedOut, Role)
from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils.status import Status, StatusError
from yugabyte_tpu_torch.utils.trace import TRACE
from yugabyte_tpu_torch.tablet.tablet import Tablet, TabletOptions

flags.define_flag(
    "follower_read_vouch_ttl_s", 900.0,
    "a digest-exchange vouch lets this replica serve follower reads for "
    "this long; must outlast the exchange cadence (scrub_interval_s) so "
    "a healthy follower stays continuously vouched, while a replica the "
    "exchange stops vouching for ages out")

# Tablet peer states (the reference's RaftGroupStatePB subset that matters
# for failure containment, ref tablet/metadata.proto + tablet_peer.cc
# state gating): RUNNING serves normally; FAILED rejects writes retryably
# while reads drain, is reported via heartbeat so the master re-replicates,
# and recovers via retry_background_work / re-bootstrap.
STATE_RUNNING = "RUNNING"
STATE_FAILED = "FAILED"


def encode_write_batch(kv_items: Sequence[Tuple],
                       target_intents: bool = False,
                       request: Optional[Tuple[bytes, int]] = None) -> bytes:
    """Leading flag byte routes the batch: bit0 -> intents DB (the reference
    splits these into separate WriteBatch sections, ref tablet.cc:1198
    ApplyKeyValueRowOperations); bit1 -> every entry carries a u64 hybrid
    time override (0 = none; index backfill writes at the backfill read
    time, ref tablet.cc:2088); bit2 -> a (client_id[16], request_id u64)
    retryable-request tag trails the entries (exactly-once dedup, ref
    consensus/retryable_requests.cc — replicated WITH the data so every
    replica rebuilds the registry). Items are (key, value) or
    (key, value, ht)."""
    has_ht = any(len(it) == 3 and it[2] for it in kv_items)
    flag = ((1 if target_intents else 0) | (2 if has_ht else 0)
            | (4 if request is not None else 0))
    out = [bytes([flag]), struct.pack("<I", len(kv_items))]
    for it in kv_items:
        k, v = it[0], it[1]
        out.append(struct.pack("<I", len(k)))
        out.append(k)
        out.append(struct.pack("<I", len(v)))
        out.append(v)
        if has_ht:
            out.append(struct.pack(
                "<Q", it[2] if len(it) == 3 and it[2] else 0))
    if request is not None:
        cid, rid = request
        out.append(cid[:16].ljust(16, b"\x00"))
        out.append(struct.pack("<Q", rid))
    return b"".join(out)


def decode_write_batch(payload: bytes
                       ) -> Tuple[List[Tuple], bool,
                                  Optional[Tuple[bytes, int]]]:
    """Inverse of encode_write_batch; items come back as (key, value) or
    (key, value, ht_override), plus the retryable-request tag if present."""
    flag = payload[0]
    target_intents = bool(flag & 1)
    has_ht = bool(flag & 2)
    (n,) = struct.unpack_from("<I", payload, 1)
    off = 5
    pairs = []
    for _ in range(n):
        (kl,) = struct.unpack_from("<I", payload, off)
        off += 4
        k = payload[off:off + kl]
        off += kl
        (vl,) = struct.unpack_from("<I", payload, off)
        off += 4
        v = payload[off:off + vl]
        off += vl
        if has_ht:
            (ht,) = struct.unpack_from("<Q", payload, off)
            off += 8
            pairs.append((k, v, ht) if ht else (k, v))
        else:
            pairs.append((k, v))
    request = None
    if flag & 4:
        cid = payload[off: off + 16]
        (rid,) = struct.unpack_from("<Q", payload, off + 16)
        request = (cid, rid)
    return pairs, target_intents, request


class RaftWriteContext:
    """The consensus seam Tablet.write submits through (replaces
    LocalConsensusContext once a TabletPeer owns the tablet)."""

    def __init__(self, peer: "TabletPeer"):
        self._peer = peer

    def submit(self, kv_pairs, ht: HybridTime, timeout_s: float = 30.0,
               target_intents: bool = False, request=None) -> Tuple[int, int]:
        payload = encode_write_batch(kv_pairs, target_intents,
                                     request=request)
        try:
            return self._peer.raft.replicate(OP_WRITE, ht.value, payload,
                                             timeout_s=timeout_s)
        except ReplicationTimedOut as e:
            # The entry may still commit: MVCC must keep holding safe time
            # at ht until the fate settles, then resolve the registration.
            # The retryable-request stays in-flight until the fate settles
            # too — a concurrent retry must not slip past the dedup check.
            mvcc = self._peer.tablet.mvcc
            retry_reg = self._peer.tablet.retryable

            def on_aborted():
                mvcc.aborted(ht)
                if request is not None:
                    retry_reg.failed(*request)

            self._peer.raft.watch_fate(
                e.op_id,
                on_committed=lambda: mvcc.replicated(ht),
                on_aborted=on_aborted)
            raise OperationOutcomeUnknown(str(e)) from e


def peer_address(server_id: str, tablet_id: str) -> str:
    return f"{server_id}/{tablet_id}"


class TabletPeer:
    def __init__(self, tablet_id: str, data_dir: str, schema: Schema,
                 server_id: str, server_ids: Sequence[str], transport,
                 clock: Optional[HybridClock] = None,
                 options: Optional[TabletOptions] = None,
                 metrics=None):
        self.tablet_id = tablet_id
        self.server_id = server_id
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self.clock = clock or HybridClock()
        self.tablet = Tablet(tablet_id, data_dir, schema, clock=self.clock,
                             options=options, metrics=metrics)
        self.log = Log(os.path.join(data_dir, "wal"))
        # WAL-backlog arm of the write-pressure state machine: appends
        # queued faster than fsync drains them delay, then shed, writes
        self.tablet.admission.bind_wal(self.log.backlog)
        config = RaftConfig(
            peer_id=peer_address(server_id, tablet_id),
            peer_ids=tuple(peer_address(s, tablet_id) for s in server_ids))
        self.raft = RaftConsensus(
            config, self.log, transport,
            apply_cb=self._apply_replicated,
            meta_path=os.path.join(data_dir, "cmeta.json"),
            safe_time_provider=lambda: self.tablet.mvcc.peek_safe_time().value,
            on_propagated_safe_time=self._on_propagated_safe_time,
            on_role_change=self._on_role_change,
            clock=self.clock,
            on_append_cb=self._on_entry_appended)
        # Registration is DEFERRED to start(), after bootstrap: serving
        # AppendEntries while bootstrap replays lets the leader's catch-up
        # race the replay — set_bootstrap_state then jumps last_applied
        # past entries the racing apply loop never applied, permanently
        # losing a window of rows on this replica (found by the
        # linked-list churn harness; ref: the reference only serves
        # consensus once the tablet reaches RUNNING state,
        # tablet_peer.cc state gating).
        self._transport = transport
        self.tablet.consensus = RaftWriteContext(self)
        self.tablet.mvcc.set_leader_mode(False)
        # Failure containment: a background error in either DB or a sealed
        # WAL parks this peer in FAILED (ref tablet FAILED state,
        # tablet.cc MarkTabletFailed).
        self.state = STATE_RUNNING
        self.failed_status: Optional[Status] = None
        # data-corruption failure (scrub / read-path CRC mismatch /
        # digest divergence): in-place recovery is impossible — the
        # heartbeat reports it and the master rebuilds this replica from
        # a healthy peer (remote bootstrap in place)
        self.failed_corrupt = False
        # last at-rest scrub of this replica (wall ts + totals), set by
        # the ScrubTabletsOp; {} until the first scrub
        self.scrub_state: dict = {}
        # Follower-read gate (ROADMAP item 1 safety rail): a follower may
        # serve bounded-staleness reads ONLY while it holds a live vouch
        # from the leader's cross-replica digest exchange (PR 8) — the
        # exchange proved this replica's resolved rows match the
        # leader's. 0.0 = never vouched. monotonic deadline.
        self._vouched_until = 0.0
        self._vouch_read_ht = 0  # read_ht the vouching digest was taken at
        for db in (self.tablet.regular_db, self.tablet.intents_db):
            db.on_background_error = self._on_storage_error
        self.log.on_io_error = self._on_log_error
        # Split hook: the tablet manager creates the child tablets when the
        # SPLIT op applies (deterministically on every replica, including
        # WAL replay after restart — child creation is idempotent).
        self.on_split = lambda info: None

    # ------------------------------------------------------------ bootstrap
    def bootstrap(self) -> int:
        """Replay WAL into the tablet (ref tablet_bootstrap.cc). Returns the
        number of entries replayed."""
        frontiers = [db.versions.flushed_frontier.op_id_max[1]
                     for db in (self.tablet.regular_db, self.tablet.intents_db)
                     if db.versions.flushed_frontier is not None]
        flushed_min = min(frontiers) if frontiers else 0
        replay_from = flushed_min + 1
        replayed = 0
        max_ht = 0
        applied_up_to = flushed_min
        # Flushed storage implies those entries were committed; the floor
        # may exceed the (non-fsynced) one recovered from metadata.
        committed_floor = max(self.raft.commit_index, flushed_min)
        for entry in LogReader(self.log.wal_dir).read_all():
            msg = ReplicateMsg.from_log_entry(entry)
            if msg.index < replay_from:
                # already flushed into storage — not replayed, but its
                # retryable-request tag must still resolve to 'replicated'
                # or a post-restart retry would double-apply after the
                # in-flight expiry (dedup must survive restart-after-flush)
                if msg.op_type == OP_WRITE and msg.payload \
                        and msg.payload[0] & 4:
                    cid = msg.payload[-24:-8]
                    (rid,) = struct.unpack("<Q", msg.payload[-8:])
                    self.tablet.retryable.replicated(cid, rid, msg.ht_value)
                continue
            if msg.index > committed_floor:
                break  # pending tail: Raft decides its fate later
            self._apply_replicated(msg)
            applied_up_to = msg.index
            replayed += 1
            max_ht = max(max_ht, msg.ht_value)
        # report what was ACTUALLY applied (flushed state + replay), never
        # the aspirational floor: claiming more would mark unapplied
        # entries applied and lose their rows on this replica forever
        self.raft.set_bootstrap_state(applied_up_to)
        if max_ht:
            ht = HybridTime(max_ht)
            self.clock.update(ht)
            self.tablet.mvcc.set_last_replicated(ht)
        TRACE("bootstrap %s: replayed %d ops from index %d",
              self.tablet_id, replayed, replay_from)
        return replayed

    def start(self, election_timer: bool = True) -> "TabletPeer":
        self.bootstrap()
        # only NOW serve consensus traffic (see __init__: registering
        # before bootstrap races leader catch-up against WAL replay)
        self._transport.register(self.raft.config.peer_id, self.raft)
        self.raft.start(election_timer=election_timer)
        return self

    # ------------------------------------------------------ failure state
    def _on_storage_error(self, status: Status) -> None:
        self.mark_failed(status)

    def _on_log_error(self, exc: Exception) -> None:
        self.mark_failed(Status.IoError(
            f"WAL append failed on {self.tablet_id}: {exc}"))

    def mark_failed(self, status: Status) -> None:
        """Transition to FAILED: writes reject retryably, reads drain, the
        next heartbeat reports the state so the master can re-replicate.
        In-flight background compactions (including the device-offload
        pipeline) are cancelled at their next stage boundary. A
        CORRUPTION status additionally marks the replica
        ``failed_corrupt``: its data is bad, so recovery is a rebuild
        from a healthy peer, never an in-place retry."""
        from yugabyte_tpu_torch.utils.status import Code
        if status.code == Code.CORRUPTION:
            # set even when already FAILED: corruption discovered under
            # an I/O park upgrades the required recovery to a rebuild
            self.failed_corrupt = True
        if self.state == STATE_FAILED:
            return
        self.state = STATE_FAILED
        self.failed_status = status
        # a parked replica's data is suspect by definition: drop any
        # follower-read license it still holds
        self._vouched_until = 0.0
        self.tablet.cancel_background_work(
            f"tablet {self.tablet_id} FAILED: {status}")
        TRACE("tablet %s FAILED: %s", self.tablet_id, status)

    def _check_not_failed(self) -> None:
        if self.state == STATE_FAILED:
            err = StatusError(Status.ServiceUnavailable(
                f"tablet {self.tablet_id} is in FAILED state "
                f"({self.failed_status}); retry another replica"))
            err.extra = {"tablet_failed": True}
            raise err

    def try_recover(self) -> bool:
        """In-place recovery from DB background errors (driven by the
        maintenance manager's capped-backoff retry). A sealed WAL cannot
        recover in place — its torn tail needs the bootstrap replay rule —
        so those peers wait for TSTabletManager.recover_failed_tablet.
        Returns True when the peer is RUNNING again."""
        if self.state != STATE_FAILED:
            return True
        if self.failed_corrupt:
            # lost/diverged bytes cannot be retried back into existence:
            # stay parked until the master rebuilds this replica from a
            # healthy peer (load_balancer in-place remote bootstrap)
            return False
        if self.log.io_error is not None:
            return False
        for db in (self.tablet.regular_db, self.tablet.intents_db):
            if not db.retry_background_work():
                return False
        self.state = STATE_RUNNING
        self.failed_status = None
        TRACE("tablet %s recovered from background error", self.tablet_id)
        return True

    def _on_entry_appended(self, msg: ReplicateMsg) -> None:
        """Log-append hook (every replica, incl. recovery): pre-register the
        write's retryable-request tag as in-flight, so a retry hitting a
        new leader in the committed-but-unapplied window is pushed back
        instead of double-applied (ref retryable_requests.cc registering
        at replication time)."""
        if msg.op_type != OP_WRITE or not msg.payload:
            return
        if msg.payload[0] & 4:
            cid = msg.payload[-24:-8]
            (rid,) = struct.unpack("<Q", msg.payload[-8:])
            self.tablet.retryable.track_appended(cid, rid)

    # ---------------------------------------------------------------- apply
    def _apply_replicated(self, msg: ReplicateMsg) -> None:
        if msg.op_type == OP_WRITE:
            kv_pairs, target_intents, request = decode_write_batch(
                msg.payload)
            ht = HybridTime(msg.ht_value)
            if target_intents:
                self.tablet.apply_intent_batch(kv_pairs, ht, msg.op_id)
            else:
                self.tablet.apply_write_batch(kv_pairs, ht, msg.op_id)
            if request is not None:
                # every replica (and WAL replay) rebuilds the dedup
                # registry from the replicated payload
                self.tablet.retryable.replicated(request[0], request[1],
                                                 msg.ht_value)
            if not self.raft.is_leader():
                # Followers advance replication watermark directly; the
                # leader's MvccManager drains via replicated() in write().
                self.clock.update(ht)
                self.tablet.mvcc.set_last_replicated(ht)
        elif msg.op_type == OP_UPDATE_TXN:
            import json as _json
            info = _json.loads(msg.payload)
            self.tablet.apply_txn_update(
                info["action"], bytes.fromhex(info["txn_id"]),
                info.get("commit_ht") or 0, msg.ht_value, msg.op_id)
        elif msg.op_type == OP_SNAPSHOT:
            # Deterministic: every replica checkpoints the same applied
            # prefix (ref snapshot_coordinator raft-driven snapshots).
            import json as _json
            self.tablet.create_snapshot(
                _json.loads(msg.payload)["snapshot_id"])
        elif msg.op_type == OP_SPLIT:
            # Applied at the same log position on every replica, after all
            # preceding writes and before nothing (the parent rejects writes
            # once the split is appended) — so the parent state each replica
            # snapshots into the children is identical (ref
            # tablet/operations/split_operation.cc).
            import json as _json
            info = _json.loads(msg.payload)
            self.tablet.split_children = tuple(info["children"])
            self.on_split(info)

    def submit_snapshot(self, snapshot_id: str,
                        snapshot_ht_value: int = 0,
                        timeout_s: float = 60.0):
        """Leader: replicate a snapshot barrier. When the master supplies a
        cluster-wide snapshot hybrid time, the leader first waits for
        SafeTime >= snapshot_ht so every write visible at that time is in
        the log BEFORE the barrier — all tablets then restore consistently
        at the same point in time (ref snapshot_coordinator anchoring
        snapshots to one hybrid time)."""
        import json as _json
        if not self.raft.is_leader():
            raise NotLeader(self.raft.leader_hint())
        if snapshot_ht_value:
            self.clock.update(HybridTime(snapshot_ht_value))
            self.tablet.mvcc.safe_time(
                min_allowed=HybridTime(snapshot_ht_value),
                timeout_s=timeout_s)
        payload = _json.dumps({"snapshot_id": snapshot_id,
                               "snapshot_ht": snapshot_ht_value}).encode()
        return self.raft.replicate(OP_SNAPSHOT, self.clock.now().value,
                                   payload, timeout_s=timeout_s)

    def submit_split(self, child_ids, split_partition_key: bytes,
                     timeout_s: float = 30.0):
        """Leader: replicate the split point + child ids through Raft
        (ref tablet/operations/split_operation.h:38). Writes are gated and
        drained FIRST so the SPLIT entry is the last write-affecting entry
        in the parent's log."""
        import json as _json
        payload = _json.dumps({
            "children": list(child_ids),
            "split_partition_key": split_partition_key.hex(),
        }).encode()
        self.tablet.block_writes()
        try:
            return self.raft.replicate(OP_SPLIT, self.clock.now().value,
                                       payload, timeout_s=timeout_s)
        except ReplicationTimedOut as e:
            # Fate unknown: the SPLIT may still commit, so writes MUST stay
            # blocked (an acked write appended after a committing SPLIT
            # would exist only in the soon-retired parent). Unblock only if
            # the entry is eventually overwritten.
            self.raft.watch_fate(
                e.op_id,
                on_committed=lambda: None,  # apply sets split_children
                on_aborted=self.tablet.unblock_writes)
            raise
        except BaseException:
            # Entry definitively not in the log (NotLeader before append)
            # or overwritten (ReplicationAborted): safe to resume writes.
            self.tablet.unblock_writes()
            raise

    def _on_propagated_safe_time(self, ht_value: int) -> None:
        ht = HybridTime(ht_value)
        self.clock.update(ht)
        self.tablet.mvcc.set_propagated_safe_time(ht)

    def _on_role_change(self, role: Role) -> None:
        self.tablet.mvcc.set_leader_mode(role == Role.LEADER)

    # ---------------------------------------------------------------- reads
    def check_leader_lease(self, timeout_s: float = 5.0) -> None:
        """Wait for a majority-acked lease before serving a consistent read
        (the reference blocks on the ht lease the same way, ref
        raft_consensus WaitForLeaderLeaseImprecise)."""
        deadline = time.monotonic() + timeout_s
        while True:
            if not self.raft.is_leader():
                raise NotLeader(self.raft.leader_hint())
            if self.raft.has_leader_lease() and self.raft.leader_ready():
                return
            if time.monotonic() >= deadline:
                raise NotLeader(self.raft.leader_hint())
            time.sleep(0.002)

    # ----------------------------------------------- follower-read vouching
    def grant_vouch(self, read_ht_value: int = 0) -> None:
        """The leader's digest exchange verified this replica's resolved
        rows match its own: license follower reads for the vouch TTL
        (re-granted every clean exchange round, so a replica that starts
        diverging ages out even before the strike path FAILs it)."""
        from yugabyte_tpu_torch.utils.metrics import serve_path_metrics
        self._vouched_until = time.monotonic() + flags.get_flag(
            "follower_read_vouch_ttl_s")
        self._vouch_read_ht = max(self._vouch_read_ht, read_ht_value)
        serve_path_metrics().counter(
            "follower_read_vouches_total",
            "digest-exchange vouches granted to this server's "
            "replicas").increment()

    def revoke_vouch(self) -> None:
        self._vouched_until = 0.0

    def is_vouched(self) -> bool:
        return time.monotonic() < self._vouched_until

    def _check_follower_read_allowed(self) -> None:
        """A follower without a live digest vouch must NOT serve reads —
        push the client to another replica (retryably) instead of
        answering from state nobody has cross-checked. A FAILED replica
        never serves regardless of any vouch it still holds."""
        from yugabyte_tpu_torch.utils.metrics import serve_path_metrics
        self._check_not_failed()
        m = serve_path_metrics()
        if not self.is_vouched():
            m.counter(
                "follower_read_unvouched_rejects_total",
                "follower reads refused because the replica holds no "
                "live digest vouch").increment()
            err = StatusError(Status.ServiceUnavailable(
                f"replica {self.server_id}/{self.tablet_id} holds no "
                f"live digest vouch; read from another replica"))
            err.extra = {"follower_unvouched": True}
            raise err
        m.counter("follower_reads_total",
                  "reads served by a vouched follower replica").increment()

    def _follower_wait_safe_time(self, read_ht: HybridTime,
                                 timeout_s: float = 1.0) -> None:
        """Same repeatable-read guarantee as the leader path — but bounded
        SHORT: a follower whose propagated safe time lags the (already
        stale) read point answers retryably so the client's replica walk
        moves on, instead of pinning the RPC on a 10s MVCC wait."""
        try:
            self.tablet.mvcc.safe_time(min_allowed=read_ht,
                                       timeout_s=timeout_s)
        except TimeoutError as e:
            err = StatusError(Status.ServiceUnavailable(
                f"replica {self.server_id}/{self.tablet_id} safe time "
                f"behind read point; read from another replica"))
            err.extra = {"follower_lagging": True}
            raise err from e

    def read_row(self, doc_key, read_ht: Optional[HybridTime] = None,
                 projection=None, allow_follower: bool = False,
                 txn_id: Optional[bytes] = None):
        if self.raft.is_leader():
            self.check_leader_lease()
            return self.tablet.read_row(doc_key, read_ht, projection,
                                        txn_id=txn_id)
        if not allow_follower:
            raise NotLeader(self.raft.leader_hint())
        self._check_follower_read_allowed()
        if read_ht is not None:
            # Wait (briefly) until the propagated safe time covers the
            # requested read point — same repeatable-read guarantee as
            # the leader path, minus the long stall.
            self._follower_wait_safe_time(read_ht)
            ht = read_ht
        else:
            ht = self.tablet.mvcc.safe_time_for_follower()
        from yugabyte_tpu_torch.docdb.doc_rowwise_iterator import read_row
        return read_row(self.tablet.regular_db, self.tablet.schema, doc_key,
                        ht, projection=projection)

    def multi_read(self, doc_keys, read_ht: Optional[HybridTime] = None,
                   projection=None, allow_follower: bool = False,
                   txn_id: Optional[bytes] = None):
        """Batched point-row reads: read_row's lease/follower rules paid
        ONCE for the whole batch, rows resolved through the tablet's
        batched path (Tablet.multi_read -> DB.multi_get)."""
        if self.raft.is_leader():
            self.check_leader_lease()
            return self.tablet.multi_read(doc_keys, read_ht, projection,
                                          txn_id=txn_id)
        if not allow_follower:
            raise NotLeader(self.raft.leader_hint())
        self._check_follower_read_allowed()
        if read_ht is not None:
            # same repeatable-read guarantee as the follower read_row:
            # bounded wait for propagated safe time to cover the point
            self._follower_wait_safe_time(read_ht)
            ht = read_ht
        else:
            ht = self.tablet.mvcc.safe_time_for_follower()
        return self.tablet.multi_read(doc_keys, ht, projection)

    def write(self, ops, timeout_s: float = 30.0,
              request=None) -> HybridTime:
        self._check_not_failed()
        if not self.raft.is_leader():
            raise NotLeader(self.raft.leader_hint())
        return self.tablet.write(ops, timeout_s=timeout_s, request=request)

    def apply_external_batch(self, kvs, default_ht_value: int) -> HybridTime:
        self._check_not_failed()
        if not self.raft.is_leader():
            raise NotLeader(self.raft.leader_hint())
        return self.tablet.apply_external_batch(kvs, default_ht_value)

    def write_transactional(self, ops, txn_meta,
                            timeout_s: float = 30.0,
                            write_id_base: int = 0) -> HybridTime:
        self._check_not_failed()
        if not self.raft.is_leader():
            raise NotLeader(self.raft.leader_hint())
        return self.tablet.write_transactional(ops, txn_meta,
                                               timeout_s=timeout_s,
                                               write_id_base=write_id_base)

    def submit_txn_update(self, action: str, txn_id: bytes,
                          commit_ht_value: int = 0,
                          timeout_s: float = 30.0):
        """Replicate a transaction resolution through this tablet's Raft
        group (ref transaction_participant.cc apply/cleanup tasks riding
        UpdateTransaction operations)."""
        import json as _json
        if not self.raft.is_leader():
            raise NotLeader(self.raft.leader_hint())
        payload = _json.dumps({"action": action, "txn_id": txn_id.hex(),
                               "commit_ht": commit_ht_value}).encode()
        return self.raft.replicate(OP_UPDATE_TXN, self.clock.now().value,
                                   payload, timeout_s=timeout_s)

    # ----------------------------------------------------------- background
    def wal_anchor(self, assume_flushed: bool = False) -> int:
        """Index below which WAL entries are no longer needed: min of the
        flushed frontiers, lagging-peer watermarks, and CDC retention
        (ref log_anchor_registry).

        assume_flushed: score 'what could a flush release' — skip the
        flushed-frontier component (a flush advances it) but KEEP the
        raft/CDC pins, which a flush cannot move."""
        if assume_flushed:
            anchor = self.raft.observed_state()[1] + 1
        else:
            frontiers = [db.versions.flushed_frontier.op_id_max[1]
                         for db in (self.tablet.regular_db,
                                    self.tablet.intents_db)
                         if db.versions.flushed_frontier is not None]
            anchor = (min(frontiers) + 1) if frontiers else 0
        # Never GC entries a lagging peer still needs (there is no remote
        # bootstrap yet to rebuild it from a snapshot).
        anchor = min(anchor, self.raft.wal_gc_anchor())
        # CDC retention: a consumer's checkpoint pins the WAL — GC'ing
        # unstreamed changes would silently tear the replication stream
        # (ref cdc_min_replicated_index-driven retention)
        cdc_idx = getattr(self, "cdc_retention_index", None)
        if cdc_idx is not None:
            anchor = min(anchor, cdc_idx + 1)
        return anchor

    def gc_wal(self) -> int:
        """Drop WAL segments fully below the current anchor (no flush)."""
        return self.log.gc_up_to(self.wal_anchor())

    def flush_and_gc_wal(self) -> int:
        """Flush both DBs, then drop WAL segments fully below the persisted
        frontier (ref log GC driven by flushed OpId anchors)."""
        self.tablet.flush()
        return self.gc_wal()

    def shutdown(self) -> None:
        self.raft.shutdown()
        self.log.close()
        self.tablet.close()
