"""Raft consensus with leader leases.

Counterpart of yugabyte_tpu/consensus/raft.py, with the imports renamed;
device-free (the replicas' tablets reach the card).

Capability parity with the reference (ref: src/yb/consensus/raft_consensus.cc
— elections :546 `DoStartElection`, :1038 `BecomeLeaderUnlocked`, replication
:1140 `ReplicateBatch`, follower path :1473 `Update`; per-peer watermark
tracking ref consensus_queue.h:110 `PeerMessageQueue`; vote withholding for
leader leases ref leader_lease.h). Differences from the C++ design are
deliberate simplifications, not omissions:

- The WAL (consensus/log.py) is the only persistent log, exactly like the
  reference. Entry (term, index) pairs live in an in-memory cache (the
  reference's LogCache) that is reloaded from the WAL at startup.
- Votes/terms persist in a small fsynced metadata file (the reference's
  ConsensusMetadata, consensus_meta.cc). The committed index is persisted
  as a non-fsynced floor so bootstrap knows how far it may safely apply.
- Replication fan-out: one worker thread per peer doubling as the
  heartbeat timer (the reference's Peer + PeerMessageQueue).
- Leader leases: each AppendEntries carries a lease duration; followers
  withhold votes until it expires, and the leader serves reads only while
  a majority acked a request sent within the lease window.
- Propagated safe time for follower reads piggybacks on AppendEntries
  (ref mvcc.h:93), capped at the hybrid time of the first entry NOT yet
  sent to that peer so a follower never advances past data it lacks.
"""

from __future__ import annotations

import enum
import json
import os
import random
import struct
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from yugabyte_tpu_torch.consensus.log import Log, LogEntry
from yugabyte_tpu_torch.consensus.transport import PeerUnreachable
from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils import latency as _latency
from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
from yugabyte_tpu_torch.utils.trace import (TRACE, LongOperationTracker, Trace,
                                      current_trace_context)

flags.define_flag("raft_heartbeat_interval_ms", 50,
                  "leader heartbeat period (ref raft_heartbeat_interval_ms)")
flags.define_flag("leader_failure_max_missed_heartbeat_periods", 6,
                  "election timeout = this many heartbeat periods "
                  "(randomized up to 2x, ref same-named flag)")
flags.define_flag("ht_lease_duration_ms", 2000,
                  "leader lease length (ref ht_lease_duration_ms)")
flags.define_flag("consensus_max_batch_size_entries", 256,
                  "max entries per AppendEntries request "
                  "(ref consensus_max_batch_size_bytes)")
flags.define_flag("raft_slow_replicate_threshold_ms", 1000.0,
                  "a leader replicate (append -> commit+apply) slower "
                  "than this dumps its stitched trace to /tracez")


def _consensus_metrics():
    e = ROOT_REGISTRY.entity("server", "consensus")
    return (e.histogram("raft_replicate_duration_ms",
                        "leader replicate round-trip: local append to "
                        "commit + local apply"),
            e.histogram("raft_append_entries_rpc_duration_ms",
                        "one AppendEntries exchange with a peer"))

OpId = Tuple[int, int]

OP_NOOP = 0
OP_WRITE = 1
OP_CHANGE_METADATA = 2
OP_SPLIT = 3
OP_UPDATE_TXN = 4
OP_SNAPSHOT = 5
OP_TRUNCATE = 6
OP_CHANGE_CONFIG = 7

_MSG_HEADER = struct.Struct("<BQ")  # op_type, ht_value


class NotLeader(Exception):
    def __init__(self, leader_hint: Optional[str]):
        super().__init__(f"not the leader (leader hint: {leader_hint})")
        self.leader_hint = leader_hint


class ReplicationAborted(Exception):
    """Entry was overwritten by a new leader before committing."""


class ReplicationTimedOut(Exception):
    """The entry's fate (commit vs overwrite) is still unknown — it remains
    in the log and MAY commit later. Callers must NOT treat this as an
    abort; use watch_fate() to resolve bookkeeping when the fate settles."""

    def __init__(self, op_id: "OpId"):
        super().__init__(f"op {op_id} outcome unknown (timeout)")
        self.op_id = op_id


class OperationOutcomeUnknown(Exception):
    """Surfaced to clients when a write timed out without a known fate
    (the reference returns a timeout status for the same situation)."""


class ConfigChangeInProgress(Exception):
    """A previous membership change has not committed yet."""


class ConfigAlreadyApplied(Exception):
    """The requested add/remove is already reflected in the active config
    (idempotent retries hit this; callers treat it as success)."""


class Role(enum.Enum):
    FOLLOWER = "follower"
    CANDIDATE = "candidate"
    LEADER = "leader"


@dataclass(frozen=True)
class ReplicateMsg:
    term: int
    index: int
    op_type: int
    ht_value: int
    payload: bytes

    @property
    def op_id(self) -> OpId:
        return (self.term, self.index)

    def to_log_entry(self) -> LogEntry:
        return LogEntry(self.term, self.index,
                        _MSG_HEADER.pack(self.op_type, self.ht_value)
                        + self.payload)

    @staticmethod
    def from_log_entry(e: LogEntry) -> "ReplicateMsg":
        op_type, ht = _MSG_HEADER.unpack_from(e.payload)
        return ReplicateMsg(e.term, e.index, op_type, ht,
                            e.payload[_MSG_HEADER.size:])


@dataclass(frozen=True)
class AppendEntriesReq:
    term: int
    leader_id: str
    preceding_term: int
    preceding_index: int
    entries: Tuple[ReplicateMsg, ...]
    committed_index: int
    propagated_safe_time: int
    lease_duration_s: float
    # span context of the write that produced the first traced entry in
    # this batch, carried so the peer's handler span stitches under the
    # originating request's trace_id (None: heartbeat / untraced write)
    trace_ctx: Optional[dict] = None


@dataclass(frozen=True)
class AppendEntriesResp:
    responder_id: str
    term: int
    success: bool
    last_received_index: int


@dataclass(frozen=True)
class VoteReq:
    term: int
    candidate_id: str
    last_log_term: int
    last_log_index: int
    ignore_lease: bool = False


@dataclass(frozen=True)
class VoteResp:
    responder_id: str
    term: int
    granted: bool


@dataclass
class RaftConfig:
    """ACTIVE config: `peer_ids` is mutated (under the consensus lock) by
    membership changes (ref consensus/raft_consensus.cc ChangeConfig;
    single-server-at-a-time rule avoids joint consensus)."""

    peer_id: str
    peer_ids: Tuple[str, ...]  # full voter set, including self

    @property
    def majority(self) -> int:
        return len(self.peer_ids) // 2 + 1

    @property
    def remote_peers(self) -> List[str]:
        return [p for p in self.peer_ids if p != self.peer_id]


class _ConsensusMetadata:
    """Durable (term, voted_for) + advisory committed floor
    (ref consensus/consensus_meta.cc).

    The floor lives in its OWN file, written without fsync: it is a pure
    bootstrap optimization, and letting its frequent non-fsynced rewrites
    touch the file holding the Raft-critical (term, voted_for) record could
    corrupt the vote on power loss. A torn floor file degrades to floor 0."""

    def __init__(self, path: str):
        self.path = path
        self.floor_path = path + ".floor"
        self.term = 0
        self.voted_for: Optional[str] = None
        self.committed_floor = 0
        # Durable active config (ref ConsensusMetadata::active_config):
        # None until the first membership change.
        self.peer_ids: Optional[List[str]] = None
        self.config_index = 0
        if os.path.exists(path):
            with open(path) as f:
                d = json.load(f)
            self.term = d["term"]
            self.voted_for = d.get("voted_for")
            self.peer_ids = d.get("peer_ids")
            self.config_index = d.get("config_index", 0)
            # Legacy layout kept the floor inline; prefer the newer file.
            self.committed_floor = d.get("committed_floor", 0)
        if os.path.exists(self.floor_path):
            try:
                with open(self.floor_path) as f:
                    self.committed_floor = max(self.committed_floor,
                                               int(f.read().strip() or 0))
            except (ValueError, OSError):
                pass  # advisory only

    def save(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"term": self.term, "voted_for": self.voted_for,
                       "peer_ids": self.peer_ids,
                       "config_index": self.config_index}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def save_floor(self) -> None:
        tmp = self.floor_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(self.committed_floor))
        os.replace(tmp, self.floor_path)


class RaftConsensus:
    """One Raft participant. apply_cb(msg) is invoked exactly once per
    committed entry, in index order, possibly from internal threads."""

    def __init__(self, config: RaftConfig, log: Log, transport,
                 apply_cb: Callable[[ReplicateMsg], None],
                 meta_path: str,
                 safe_time_provider: Optional[Callable[[], int]] = None,
                 on_propagated_safe_time: Optional[Callable[[int], None]] = None,
                 on_role_change: Optional[Callable[[Role], None]] = None,
                 clock=None,
                 seed: Optional[int] = None,
                 on_append_cb: Optional[Callable[["ReplicateMsg"], None]]
                 = None):
        self.config = config
        self._initial_peer_ids = tuple(config.peer_ids)
        # index -> peer_ids active FROM that log index (config history for
        # truncation revert; index 0 = the bootstrap config)
        self._config_history: Dict[int, Tuple[str, ...]] = {
            0: tuple(config.peer_ids)}
        self.on_config_change: Callable[[Tuple[str, ...]], None] = \
            lambda ids: None
        self.log = log
        self.transport = transport
        self.apply_cb = apply_cb
        # invoked for every entry as it is STORED in the local log (leader
        # append, follower append, startup recovery) — before commit/apply.
        # Used by the tablet layer to pre-register retryable requests so a
        # new leader's dedup covers committed-but-unapplied entries (ref
        # consensus/retryable_requests.cc registering at replication time).
        self.on_append_cb = on_append_cb
        self.safe_time_provider = safe_time_provider or (lambda: 0)
        self.on_propagated_safe_time = on_propagated_safe_time or (lambda ht: None)
        self.on_role_change = on_role_change or (lambda r: None)
        # role-change deferred under thread exhaustion; fired by the
        # election timer loop (upper layers MUST learn about leadership)
        self._pending_role_change: Optional[Role] = None
        self.clock = clock
        self._meta = _ConsensusMetadata(meta_path)
        self._rng = random.Random(seed if seed is not None
                                  else hash(config.peer_id) & 0xFFFF)

        from yugabyte_tpu_torch.utils import lock_rank
        self._lock = lock_rank.tracked(threading.Lock(), "raft._lock")
        self._commit_cv = threading.Condition(self._lock)
        self._apply_lock = lock_rank.tracked(threading.Lock(),
                                             "raft._apply_lock")

        self.role = Role.FOLLOWER               # guarded-by: _lock
        self.leader_id: Optional[str] = None    # guarded-by: _lock
        self._entries: Dict[int, ReplicateMsg] = {}  # guarded-by: _lock
        # index -> ht_value, surviving CACHE eviction (trimmed separately):
        # the propagated-safe-time clamp must see the HT of EVERY entry a
        # lagging peer has not received — reading a cache-evicted tail as
        # "no constraint" let a restarted follower's safe time run ahead
        # of its data (caught by the linked-list churn harness)
        self._ht_by_index: Dict[int, int] = {}  # guarded-by: _lock
        # index -> originating span context for traced writes, so the
        # AppendEntries carrying that entry propagates the trace to peers;
        # trimmed aggressively (entries replicate within one heartbeat in
        # the common case) — a missing ctx only drops propagation, never
        # correctness
        self._trace_ctx_by_index: Dict[int, dict] = {}  # guarded-by: _lock
        # index -> the originating write's LatencyBudget, so the commit
        # worker can attribute the apply slice to the op that asked for
        # it (the replicate caller blocks on _commit_cv, so the budget
        # contextvar is unreachable from the applying thread). Same
        # lifecycle as _trace_ctx_by_index: trimmed with it, dropped on
        # truncation, advisory-only.
        self._budget_by_index: Dict[int, object] = {}  # guarded-by: _lock
        self._last_index = 0           # guarded-by: _lock
        self._last_term = 0            # guarded-by: _lock
        self._local_durable_index = 0  # guarded-by: _lock
        self.commit_index = 0          # guarded-by: _lock
        self.last_applied = 0          # guarded-by: _lock
        # Durability watermark handshake: WAL-appender callbacks touch ONLY
        # this small lock + event (never self._lock), so a thread holding
        # self._lock may safely block on WAL durability (e.g. handle_update's
        # append_sync) without deadlocking against pending async callbacks.
        self._durable_lock = lock_rank.tracked(threading.Lock(),
                                               "raft._durable_lock")
        self._durable_watermark = 0    # guarded-by: _durable_lock
        self._durable_event = threading.Event()
        # Latched on the first WAL append failure (Log seals itself): new
        # replicates fail fast with fate-unknown instead of waiting out
        # their timeout on a durability ack that can never come.
        self._log_error: Optional[Exception] = None  # guarded-by: _durable_lock
        self._withhold_votes_until = 0.0        # guarded-by: _lock
        self._last_leader_contact = time.monotonic()  # guarded-by: _lock

        # leader state
        self._next_index: Dict[str, int] = {}         # guarded-by: _lock
        self._match_index: Dict[str, int] = {}        # guarded-by: _lock
        self._last_ack_send_time: Dict[str, float] = {}  # guarded-by: _lock
        self._peer_events: Dict[str, threading.Event] = {}  # guarded-by: _lock
        self._peer_threads: List[threading.Thread] = []     # guarded-by: _lock
        self._leader_epoch = 0                        # guarded-by: _lock

        # deliberately unannotated latch bool: set-once under _lock in
        # shutdown(); loop threads read it bare (torn reads impossible,
        # one extra iteration is harmless)
        self._stopped = False
        self._load_log()
        self._election_thread: Optional[threading.Thread] = None
        self._commit_worker = threading.Thread(
            target=self._commit_worker_loop,
            name=f"raft-commit-{config.peer_id}", daemon=True)
        self._commit_worker.start()

    # -------------------------------------------------------------- startup
    def _load_log(self) -> None:  # guarded-by: _lock (pre-publication ctor)
        from yugabyte_tpu_torch.consensus.log import LogReader
        # Durable config from metadata first (a committed config entry may
        # have been GC'd from the WAL).
        if self._meta.peer_ids is not None:
            self._config_history[self._meta.config_index] = tuple(
                self._meta.peer_ids)
        reader = LogReader(self.log.wal_dir)
        for e in reader.read_all():
            msg = ReplicateMsg.from_log_entry(e)
            self._entries[msg.index] = msg
            self._ht_by_index[msg.index] = msg.ht_value
            self._last_index = msg.index
            self._last_term = msg.term
            if self.on_append_cb is not None:
                self.on_append_cb(msg)
            if msg.op_type == OP_CHANGE_CONFIG:
                self._config_history[msg.index] = tuple(
                    json.loads(msg.payload)["peer_ids"])
        self.config.peer_ids = self._config_history[
            max(self._config_history)]
        self._local_durable_index = self._last_index
        # Committed floor: entries at/below it are safe to apply at
        # bootstrap; entries above it stay pending until a leader commits
        # or overwrites them.
        self.commit_index = min(self._meta.committed_floor, self._last_index)

    def start(self, election_timer: bool = True) -> None:
        if election_timer:
            self._election_thread = threading.Thread(
                target=self._election_timer_loop,
                name=f"raft-timer-{self.config.peer_id}", daemon=True)
            self._election_thread.start()

    def set_bootstrap_state(self, committed_index: int) -> None:
        """Bootstrap: the tablet replayed/persisted through
        `committed_index`; treat it as committed+applied so apply_cb is not
        re-invoked (ref TabletBootstrap skipping flushed entries). Flushed
        storage implies the entries were committed, so this may raise the
        non-fsynced committed floor recovered from metadata."""
        with self._lock:
            self.commit_index = max(self.commit_index,
                                    min(committed_index, self._last_index))
            self.last_applied = max(self.last_applied, self.commit_index)

    # ----------------------------------------------------------- properties
    @property
    def current_term(self) -> int:
        return self._meta.term

    @property
    def last_op_id(self) -> OpId:
        with self._lock:
            return (self._last_term, self._last_index)

    def is_leader(self) -> bool:
        with self._lock:
            return self.role == Role.LEADER

    def leader_hint(self) -> Optional[str]:
        with self._lock:
            return self.leader_id

    # ------------------------------------------------------------ elections
    def _election_timeout_s(self) -> float:
        hb = flags.get_flag("raft_heartbeat_interval_ms") / 1000.0
        periods = flags.get_flag("leader_failure_max_missed_heartbeat_periods")
        base = hb * periods
        return base * (1.0 + self._rng.random())

    def _election_timer_loop(self) -> None:
        timeout = self._election_timeout_s()
        while not self._stopped:
            time.sleep(flags.get_flag("raft_heartbeat_interval_ms") / 1000.0)
            try:
                self._drain_role_change()
            except Exception as e:  # noqa: BLE001 — keep the timer alive
                TRACE("raft %s: deferred role-change failed: %s",
                      self.config.peer_id, e)
            with self._lock:
                if self._stopped or self.role == Role.LEADER:
                    self._last_leader_contact = time.monotonic()
                    continue
                expired = (time.monotonic() - self._last_leader_contact
                           > timeout)
            if expired:
                try:
                    self.start_election()
                except RuntimeError as e:
                    # transient thread exhaustion (big test runs): a dead
                    # timer would freeze this peer as a non-leader forever
                    # — back off and retry instead
                    TRACE("raft %s: election deferred: %s",
                          self.config.peer_id, e)
                    time.sleep(0.2)
                timeout = self._election_timeout_s()

    def observed_state(self) -> Tuple["Role", int]:
        """Locked (role, commit_index) snapshot for off-raft observers —
        tablet reports, WAL anchoring — which must not read the guarded
        fields bare."""
        with self._lock:
            return self.role, self.commit_index

    def commit_progress(self) -> Tuple[int, int]:
        """Locked (commit_index, last_applied) snapshot — catch-up
        polling must not read the guarded fields bare."""
        with self._lock:
            return self.commit_index, self.last_applied

    def start_election(self, ignore_lease: bool = False) -> None:
        """Become candidate, solicit votes (ref raft_consensus.cc:546)."""
        with self._lock:
            if self._stopped or self.role == Role.LEADER:
                return
            self._meta.term += 1
            self._meta.voted_for = self.config.peer_id
            self._meta.save()
            term = self._meta.term
            self.role = Role.CANDIDATE
            self.leader_id = None
            self._last_leader_contact = time.monotonic()
            req = VoteReq(term, self.config.peer_id,
                          self._last_term, self._last_index, ignore_lease)
            votes = {self.config.peer_id}
        TRACE("raft %s: starting election for term %d", self.config.peer_id, term)
        if len(self.config.peer_ids) == 1:
            self._maybe_win(term, votes)
            return
        for peer in self.config.remote_peers:
            try:
                threading.Thread(target=self._solicit_vote,
                                 args=(peer, req, votes),
                                 daemon=True).start()
            except RuntimeError:
                # out of threads: solicit this peer synchronously — a
                # slow election beats a stuck one. Shield the caller
                # (possibly the election timer) from the peer handler's
                # faults like the worker-thread path naturally did.
                try:
                    self._solicit_vote(peer, req, votes)
                except Exception as e:  # noqa: BLE001
                    TRACE("raft %s: sync vote solicit of %s failed: %s",
                          self.config.peer_id, peer, e)

    def _solicit_vote(self, peer: str, req: VoteReq, votes: set) -> None:
        try:
            resp = self.transport.request_vote(self.config.peer_id, peer, req)
        except PeerUnreachable:
            return
        with self._lock:
            if resp.term > self._meta.term:
                self._step_down_unlocked(resp.term)
                return
        if resp.granted:
            votes.add(peer)
            self._maybe_win(req.term, votes)

    def _maybe_win(self, term: int, votes: set) -> None:
        with self._lock:
            if (self.role != Role.CANDIDATE or self._meta.term != term
                    or len(votes) < self.config.majority):
                return
            self._become_leader_unlocked()

    def _spawn_role_change(self, role: "Role") -> None:  # guarded-by: _lock
        """Notify upper layers of a role change without blocking the
        consensus lock. Latest-wins slot + drainer: the slot (written
        under the consensus lock, which every caller holds) always
        carries the NEWEST role, so rapid leader->follower flaps deliver
        the terminal state and never out-of-order or dropped
        notifications; under thread exhaustion the election timer loop
        drains the slot instead (a leader whose bootstrap callback never
        fires wedges the tablet)."""
        self._pending_role_change = role
        try:
            threading.Thread(target=self._drain_role_change,
                             daemon=True).start()
        except RuntimeError:
            pass  # the election timer loop drains the slot

    def _drain_role_change(self) -> None:
        with self._lock:
            role = self._pending_role_change
            self._pending_role_change = None
        if role is not None:
            self.on_role_change(role)

    def _become_leader_unlocked(self) -> None:
        """ref raft_consensus.cc:1038 BecomeLeaderUnlocked."""
        self.role = Role.LEADER
        self.leader_id = self.config.peer_id
        self._leader_epoch += 1
        epoch = self._leader_epoch
        now = time.monotonic()
        for p in self.config.remote_peers:
            self._next_index[p] = self._last_index + 1
            self._match_index[p] = 0
            self._last_ack_send_time[p] = 0.0
            self._peer_events[p] = threading.Event()
        # NO_OP at the new term: commits everything from prior terms
        # (Raft can only count replicas for current-term entries).
        ht = self.clock.now().value if self.clock else 0
        noop = self._append_unlocked(OP_NOOP, ht, b"")
        self._leader_noop_index = noop.index
        try:
            for p in self.config.remote_peers:
                t = threading.Thread(
                    target=self._peer_loop, args=(p, epoch),
                    name=f"raft-peer-{self.config.peer_id}-{p}",
                    daemon=True)
                self._peer_threads.append(t)
                t.start()
        except RuntimeError as e:
            # thread exhaustion mid-bring-up: a leader missing peer
            # replication loops could never commit — step back to
            # follower (same term) so a later election retries cleanly
            TRACE("raft %s: leader bring-up aborted (%s); stepping down",
                  self.config.peer_id, e)
            self.role = Role.FOLLOWER
            self.leader_id = None
            self._leader_epoch += 1  # orphan any loops that DID start
            return
        TRACE("raft %s: leader for term %d", self.config.peer_id, self._meta.term)
        self._spawn_role_change(Role.LEADER)

    def _step_down_unlocked(self, new_term: int) -> None:
        if new_term > self._meta.term:
            self._meta.term = new_term
            self._meta.voted_for = None
            self._meta.save()
        was_leader = self.role == Role.LEADER
        self.role = Role.FOLLOWER
        self._leader_epoch += 1  # stops peer loops
        self._last_leader_contact = time.monotonic()
        for ev in self._peer_events.values():
            ev.set()
        self._commit_cv.notify_all()
        if was_leader:
            self._spawn_role_change(Role.FOLLOWER)

    # ---------------------------------------------------------- vote handler
    def handle_vote_request(self, req: VoteReq) -> VoteResp:
        with self._lock:
            # Leader-lease vote withholding (ref leader_lease.h): a follower
            # that recently heard from a live leader refuses to elect a new
            # one until the lease expires.
            if (not req.ignore_lease
                    and time.monotonic() < self._withhold_votes_until
                    and req.candidate_id != self.leader_id):
                return VoteResp(self.config.peer_id, self._meta.term, False)
            if req.term > self._meta.term:
                self._step_down_unlocked(req.term)
            if req.term < self._meta.term:
                return VoteResp(self.config.peer_id, self._meta.term, False)
            log_ok = (req.last_log_term, req.last_log_index) >= \
                (self._last_term, self._last_index)
            if log_ok and self._meta.voted_for in (None, req.candidate_id):
                self._meta.voted_for = req.candidate_id
                self._meta.save()
                self._last_leader_contact = time.monotonic()
                return VoteResp(self.config.peer_id, self._meta.term, True)
            return VoteResp(self.config.peer_id, self._meta.term, False)

    # -------------------------------------------------------- config change
    def change_config(self, add: Sequence[str] = (),
                      remove: Sequence[str] = (),
                      timeout_s: float = 30.0) -> OpId:
        """Single-server membership change (ref raft_consensus.cc
        ChangeConfig; one-at-a-time keeps old/new majorities overlapping so
        joint consensus is unnecessary). The new config takes effect ON
        APPEND at every replica; commit makes it durable in cmeta. Removing
        the leader itself is allowed — it steps down after commit."""
        if len(add) + len(remove) != 1:
            raise ValueError("exactly one server may be added or removed")
        with self._lock:
            if self.role != Role.LEADER:
                raise NotLeader(self.leader_id)
            # Only one pending (uncommitted) change at a time.
            for i in range(self.commit_index + 1, self._last_index + 1):
                e = self._entries.get(i)
                if e is not None and e.op_type == OP_CHANGE_CONFIG:
                    raise ConfigChangeInProgress(
                        f"config change at index {i} still pending")
            cur = set(self.config.peer_ids)
            for p in add:
                if p in cur:
                    raise ConfigAlreadyApplied(f"{p} already a voter")
            for p in remove:
                if p not in cur:
                    raise ConfigAlreadyApplied(f"{p} not a voter")
            new_ids = tuple(sorted((cur | set(add)) - set(remove)))
            payload = json.dumps({"peer_ids": list(new_ids)}).encode()
            ht = self.clock.now().value if self.clock else 0
            msg = self._append_unlocked(OP_CHANGE_CONFIG, ht, payload)
            self._activate_config_unlocked(msg.index, new_ids)
            events = list(self._peer_events.values())
        for ev in events:
            ev.set()
        deadline = time.monotonic() + timeout_s
        with self._commit_cv:
            while True:
                if self.commit_index >= msg.index:
                    return msg.op_id
                cur_e = self._entries.get(msg.index)
                if cur_e is None or cur_e.term != msg.term:
                    raise ReplicationAborted(
                        f"config change {msg.op_id} overwritten")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise ReplicationTimedOut(msg.op_id)
                self._commit_cv.wait(timeout=remaining)

    def _activate_config_unlocked(self, index: int,
                                  peer_ids: Tuple[str, ...]) -> None:
        """Adopt a config the moment its entry exists in our log (standard
        effect-on-append semantics)."""
        self._config_history[index] = peer_ids
        self.config.peer_ids = peer_ids
        self._meta.peer_ids = list(peer_ids)
        self._meta.config_index = index
        self._meta.save()  # config is Raft-critical: fsynced
        if self.role == Role.LEADER:
            self._ensure_peer_state_unlocked()
        # Synchronous delivery: back-to-back changes must reach the
        # listener in order, or a stale peer set could overwrite a newer
        # one in the tablet superblock.
        self.on_config_change(peer_ids)
        TRACE("raft %s: config @%d -> %s", self.config.peer_id, index,
              peer_ids)

    def _revert_config_unlocked(self, new_tail: int) -> None:
        """After truncation, reactivate the latest config at/below the new
        log tail."""
        for i in list(self._config_history):
            if i > new_tail:
                del self._config_history[i]
        best = max(self._config_history)
        peer_ids = self._config_history[best]
        if peer_ids != self.config.peer_ids:
            self.config.peer_ids = peer_ids
            self._meta.peer_ids = list(peer_ids)
            self._meta.config_index = best
            self._meta.save()
            self.on_config_change(peer_ids)

    def _ensure_peer_state_unlocked(self) -> None:
        """Start replication workers for newly added peers; workers for
        removed peers exit on their next wakeup."""
        epoch = self._leader_epoch
        for p in self.config.remote_peers:
            if p not in self._peer_events:
                self._next_index[p] = self._last_index + 1
                self._match_index[p] = 0
                self._last_ack_send_time[p] = 0.0
                self._peer_events[p] = threading.Event()
                t = threading.Thread(
                    target=self._peer_loop, args=(p, epoch),
                    name=f"raft-peer-{self.config.peer_id}-{p}",
                    daemon=True)
                self._peer_threads.append(t)
                t.start()

    # ---------------------------------------------------------- replication
    def replicate(self, op_type: int, ht_value: int, payload: bytes,
                  timeout_s: float = 30.0) -> OpId:
        """Leader: append + replicate + wait for commit AND local apply
        (ref raft_consensus.cc:1140 ReplicateBatch)."""
        t0 = time.monotonic()
        budget = _latency.current_budget()
        fs0 = ap0 = 0.0
        if budget is not None:
            fs0 = budget.stages.get(_latency.STAGE_WAL_FSYNC, 0.0)
            ap0 = budget.stages.get(_latency.STAGE_APPLY, 0.0)
        try:
            with LongOperationTracker(
                    "raft.replicate",
                    flags.get_flag("raft_slow_replicate_threshold_ms")):
                return self._replicate_inner(op_type, ht_value, payload,
                                             timeout_s)
        finally:
            wall_ms = (time.monotonic() - t0) * 1e3
            _consensus_metrics()[0].increment(wall_ms)
            if budget is not None:
                # attribution: the replicate wall MINUS the fsync/apply
                # slices other threads recorded into this budget during
                # the call — the three stages stay disjoint, so the
                # decomposition telescopes instead of double-counting
                inner = ((budget.stages.get(_latency.STAGE_WAL_FSYNC, 0.0)
                          - fs0)
                         + (budget.stages.get(_latency.STAGE_APPLY, 0.0)
                            - ap0))
                budget.record(_latency.STAGE_RAFT_REPLICATE,
                              wall_ms - inner)

    def _replicate_inner(self, op_type: int, ht_value: int, payload: bytes,
                         timeout_s: float) -> OpId:
        ctx = current_trace_context()
        budget = _latency.current_budget()
        with self._lock:
            if self.role != Role.LEADER:
                raise NotLeader(self.leader_id)
            msg = self._append_unlocked(op_type, ht_value, payload)
            if ctx is not None:
                self._trace_ctx_by_index[msg.index] = ctx
            if budget is not None:
                self._budget_by_index[msg.index] = budget
        TRACE("raft %s: replicating op %s (%d bytes)",
              self.config.peer_id, msg.op_id, len(payload))
        from yugabyte_tpu_torch.utils import sync_point
        sync_point.hit("raft.replicate:after_local_append")
        # snapshot under the lock: iterating the live dict would race
        # _ensure_peer_state_unlocked adding a peer (RuntimeError: dict
        # changed size during iteration) — found by the lock pass
        with self._lock:
            events = list(self._peer_events.values())
        for ev in events:
            ev.set()
        deadline = time.monotonic() + timeout_s
        with self._commit_cv:
            while True:
                # Applied first: a committed+applied entry may already be
                # evicted from the cache — reporting it aborted would double-
                # apply on client retry.
                if self.last_applied >= msg.index:
                    try:
                        applied_term = self._term_at_unlocked(msg.index)
                    except KeyError:
                        # Evicted from cache AND WAL-GC'd: only applied
                        # entries are evicted, and an overwrite would still
                        # be cached — the survivor is ours.
                        applied_term = msg.term
                    if applied_term != msg.term:
                        raise ReplicationAborted(f"op {msg.op_id} overwritten")
                    return msg.op_id
                cur = self._entries.get(msg.index)
                if cur is None or cur.term != msg.term:
                    raise ReplicationAborted(f"op {msg.op_id} overwritten")
                with self._durable_lock:
                    log_error = self._log_error
                if log_error is not None:
                    # Local WAL is dead. The entry may still commit through
                    # the followers, so this is fate-unknown, not an abort:
                    # the timeout path keeps the watch_fate/dedup story.
                    raise ReplicationTimedOut(msg.op_id)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    # NOT an abort: the entry stays in the log and may yet
                    # commit. Callers resolve bookkeeping via watch_fate().
                    raise ReplicationTimedOut(msg.op_id)
                self._commit_cv.wait(timeout=remaining)

    def _append_unlocked(self, op_type: int, ht_value: int,
                         payload: bytes) -> ReplicateMsg:
        index = self._last_index + 1
        msg = ReplicateMsg(self._meta.term, index, op_type, ht_value, payload)
        self._entries[index] = msg
        self._ht_by_index[index] = ht_value
        self._last_index = index
        self._last_term = msg.term
        if self.on_append_cb is not None:
            self.on_append_cb(msg)
        self.log.append_async(
            [msg.to_log_entry()],
            callback=lambda err=None: self._on_local_durable(index, err),
            budget=_latency.current_budget())
        return msg

    def _on_local_durable(self, index: int, err=None) -> None:
        """WAL appender callback. MUST NOT touch self._lock (see the
        durability-watermark comment in __init__). A non-None err means
        the append failed: the watermark stays put (this replica must not
        count toward the majority for the entry) and waiting replicates
        are woken to fail fast."""
        if err is not None:
            with self._durable_lock:
                if self._log_error is None:
                    self._log_error = err
            self._durable_event.set()
            with self._commit_cv:
                self._commit_cv.notify_all()
            return
        with self._durable_lock:
            if index > self._durable_watermark:
                self._durable_watermark = index
        self._durable_event.set()

    def _commit_worker_loop(self) -> None:
        """Folds the durability watermark into consensus state and advances
        commit, off the WAL appender thread."""
        while True:
            self._durable_event.wait(timeout=0.05)
            self._durable_event.clear()
            if self._stopped:
                return
            should_apply = False
            with self._lock:
                with self._durable_lock:
                    w = self._durable_watermark
                # Cap at the current log tail: after a follower truncation
                # the stale pre-truncation watermark must not resurrect
                # durability for rewritten indexes (handle_update re-marks
                # them after its own synchronous append).
                w = min(w, self._last_index)
                if w > self._local_durable_index:
                    self._local_durable_index = w
                if self.role == Role.LEADER:
                    self._advance_commit_unlocked()
                    should_apply = self.last_applied < self.commit_index
                self._maybe_evict_cache_unlocked()
            if should_apply:
                self._apply_committed()

    # Keep a tail of recent entries in memory for term lookups and lagging
    # peers; everything older falls back to (segment-skipping) WAL reads.
    _CACHE_HIGH_WATER = 4096
    _CACHE_TAIL = 1024
    # beyond this lag, safe-time propagation to a peer freezes rather than
    # scanning an unbounded tail per request
    _SAFE_TIME_SCAN_CAP = 65536

    def _maybe_evict_cache_unlocked(self) -> None:
        """Bound the in-memory entry cache (ref consensus/log_cache.cc):
        applied entries below every peer's match index are reloadable from
        the WAL on demand. Only a LEADER gates eviction on peer match
        indexes — a follower has no peers to serve, and its empty
        _match_index map must not pin the floor at 0 forever."""
        if len(self._ht_by_index) > 2 * self._CACHE_HIGH_WATER:
            # the HT sidecar trims at an ABSOLUTE floor: safe-time
            # propagation already freezes (safe=0) for peers lagging past
            # the scan cap, so holding entries for them buys nothing — and
            # a permanently dead peer pinned at match_index 0 would
            # otherwise keep this map (and the entry cache below) growing
            # for as long as writes continue
            floor = self.last_applied - self._SAFE_TIME_SCAN_CAP
            if floor > 0:
                for i in list(self._ht_by_index):
                    if i < floor:
                        del self._ht_by_index[i]
        if len(self._trace_ctx_by_index) > 512:
            # span contexts matter only while the entry is still being
            # replicated; anything at/below last_applied has finished its
            # fan-out (or will re-send untraced — propagation is advisory)
            for i in list(self._trace_ctx_by_index):
                if i <= self.last_applied:
                    del self._trace_ctx_by_index[i]
        if len(self._budget_by_index) > 512:
            # same lifecycle: an applied entry's budget has already had
            # its apply slice recorded (attribution is advisory)
            for i in list(self._budget_by_index):
                if i <= self.last_applied:
                    del self._budget_by_index[i]
        if len(self._entries) <= self._CACHE_HIGH_WATER:
            return
        floor = self.last_applied - self._CACHE_TAIL
        if self.role == Role.LEADER:
            # serve lagging peers from memory — but never below the
            # absolute cap: beyond it they re-read from the WAL anyway
            floor = min([floor] + [self._match_index.get(p, 0)
                                   for p in self.config.remote_peers])
            floor = max(floor, self.last_applied - self._SAFE_TIME_SCAN_CAP)
        for i in list(self._entries):
            if i < floor:
                del self._entries[i]

    # ------------------------------------------------------ fate resolution
    def op_fate(self, op_id: OpId) -> str:
        """'committed' | 'aborted' | 'pending' for a previously appended
        entry. 'aborted' means it was overwritten/truncated away."""
        term, index = op_id
        with self._lock:
            if index > self._last_index:
                return "aborted"  # truncated off the log tail
            try:
                local_term = self._term_at_unlocked(index)
            except KeyError:
                # GC'd from WAL+cache: only applied entries get evicted, and
                # an overwrite would still be in the cache — treat as the
                # surviving (committed) record.
                return "committed" if index <= self.last_applied else "aborted"
            if local_term != term:
                return "aborted"
            return "committed" if index <= self.last_applied else "pending"

    def watch_fate(self, op_id: OpId, on_committed: Callable[[], None],
                   on_aborted: Callable[[], None]) -> None:
        """Resolve a timed-out op's bookkeeping once its fate settles
        (commit vs overwrite). Runs on a daemon thread."""
        def loop():
            while not self._stopped:
                f = self.op_fate(op_id)
                if f == "committed":
                    on_committed()
                    return
                if f == "aborted":
                    on_aborted()
                    return
                time.sleep(0.05)
        threading.Thread(target=loop, daemon=True,
                         name=f"raft-fate-{op_id}").start()

    # ------------------------------------------------------ peer replication
    def _peer_loop(self, peer: str, epoch: int) -> None:
        """Per-peer replication worker, doubles as heartbeat timer
        (ref consensus_peers.h:183 SendNextRequest)."""
        with self._lock:
            ev = self._peer_events[peer]
        while True:
            hb = flags.get_flag("raft_heartbeat_interval_ms") / 1000.0
            ev.wait(timeout=hb)
            ev.clear()
            try:
                with self._lock:
                    if (self._stopped or self.role != Role.LEADER
                            or self._leader_epoch != epoch
                            or peer not in self.config.peer_ids):
                        return
                    req, sent_up_to = self._build_request_unlocked(peer)
                    send_time = time.monotonic()
                try:
                    if req.trace_ctx is not None:
                        # per-hop span on the LEADER for the replication
                        # RPC: adopts the originating write's context, so
                        # the messenger stamps the same trace_id on the
                        # wire and /tracez here shows the raft hop
                        with Trace.from_wire_context(
                                req.trace_ctx,
                                f"raft.append_entries:{peer}"):
                            TRACE("AppendEntries -> %s: %d entries, "
                                  "commit %d", peer, len(req.entries),
                                  req.committed_index)
                            resp = self.transport.update_consensus(
                                self.config.peer_id, peer, req)
                            TRACE("AppendEntries <- %s: success=%s "
                                  "last_received=%d", peer, resp.success,
                                  resp.last_received_index)
                    else:
                        resp = self.transport.update_consensus(
                            self.config.peer_id, peer, req)
                except PeerUnreachable:
                    continue
                finally:
                    if req.entries:
                        _consensus_metrics()[1].increment(
                            (time.monotonic() - send_time) * 1e3)
                self._process_peer_response(peer, epoch, resp, send_time,
                                            sent_up_to)
            except Exception as e:  # noqa: BLE001 — a single bad exchange
                # (KeyError from a GC'd log, follower-side assertion, ...)
                # must not silently kill replication to this peer forever.
                TRACE("raft %s: peer %s exchange failed: %r",
                      self.config.peer_id, peer, e)
                time.sleep(hb)
                continue
            with self._lock:
                more = (self.role == Role.LEADER
                        and self._leader_epoch == epoch
                        and self._next_index.get(peer, 1) <= self._last_index)
            if more:
                ev.set()

    def _build_request_unlocked(self, peer: str):
        next_idx = self._next_index[peer]
        max_batch = flags.get_flag("consensus_max_batch_size_entries")
        entries = []
        idx = next_idx
        reloaded: Dict[int, ReplicateMsg] = {}
        while idx <= self._last_index and len(entries) < max_batch:
            e = self._entries.get(idx) or reloaded.get(idx)
            if e is None:
                # Trimmed from cache: reload the whole remaining batch range
                # in ONE WAL pass (per-index scans would make catch-up of a
                # lagging peer O(batch * WAL-size)).
                hi = min(self._last_index, next_idx + max_batch - 1)
                reloaded = self._reload_range_from_wal_unlocked(idx, hi)
                e = reloaded.get(idx)
                if e is None:
                    raise KeyError(f"log index {idx} not found in WAL")
            entries.append(e)
            idx += 1
        preceding = next_idx - 1
        preceding_term = self._term_at_unlocked(preceding)
        sent_up_to = next_idx + len(entries) - 1
        # Propagated safe time: never past any entry this peer is still
        # missing (it would expose follower reads to missing data). Raft
        # index order need not match hybrid-time order across concurrent
        # writers, so take the min HT over the whole unsent tail — from
        # _ht_by_index, which is trimmed only below the absolute
        # last_applied - _SAFE_TIME_SCAN_CAP floor, provably under any
        # index this scan can touch. An unknown tail HT (or a peer more
        # than _SAFE_TIME_SCAN_CAP behind) freezes propagation instead of
        # guessing: a follower that far back must not serve reads anyway,
        # and 0 leaves its safe time unchanged.
        safe = self.safe_time_provider()
        tail = self._last_index - sent_up_to
        if tail > self._SAFE_TIME_SCAN_CAP:
            safe = 0
        else:
            unsent_min = 0
            for i in range(sent_up_to + 1, self._last_index + 1):
                ht = self._ht_by_index.get(i)
                if ht is None:
                    e = self._entries.get(i)
                    ht = e.ht_value if e is not None else None
                if ht is None:
                    safe = 0
                    break
                if ht > 0 and (unsent_min == 0 or ht < unsent_min):
                    unsent_min = ht
            else:
                if unsent_min:
                    safe = min(safe, unsent_min - 1)
        lease_s = flags.get_flag("ht_lease_duration_ms") / 1000.0
        # propagate the originating write's span to the peer: first traced
        # entry in the batch wins (one ctx per RPC keeps the header small)
        trace_ctx = None
        for e in entries:
            trace_ctx = self._trace_ctx_by_index.get(e.index)
            if trace_ctx is not None:
                break
        return AppendEntriesReq(
            term=self._meta.term, leader_id=self.config.peer_id,
            preceding_term=preceding_term, preceding_index=preceding,
            entries=tuple(entries),
            committed_index=min(self.commit_index, sent_up_to),
            propagated_safe_time=safe,
            lease_duration_s=lease_s,
            trace_ctx=trace_ctx), sent_up_to

    def _reload_from_wal_unlocked(self, idx: int) -> ReplicateMsg:
        from yugabyte_tpu_torch.consensus.log import LogReader
        for e in LogReader(self.log.wal_dir).read_all(min_index=idx):
            msg = ReplicateMsg.from_log_entry(e)
            if msg.index == idx:
                return msg
        raise KeyError(f"log index {idx} not found in WAL")

    def _reload_range_from_wal_unlocked(
            self, lo: int, hi: int) -> Dict[int, ReplicateMsg]:
        """One contiguous WAL pass covering [lo, hi]."""
        from yugabyte_tpu_torch.consensus.log import LogReader
        out: Dict[int, ReplicateMsg] = {}
        for e in LogReader(self.log.wal_dir).read_all(min_index=lo):
            if e.index > hi:
                break
            out[e.index] = ReplicateMsg.from_log_entry(e)
        return out

    def _term_at_unlocked(self, index: int) -> int:
        if index == 0:
            return 0
        e = self._entries.get(index)
        if e is not None:
            return e.term
        return self._reload_from_wal_unlocked(index).term

    def _process_peer_response(self, peer: str, epoch: int,
                               resp: AppendEntriesResp, send_time: float,
                               sent_up_to: int) -> None:
        should_apply = False
        with self._lock:
            if self.role != Role.LEADER or self._leader_epoch != epoch:
                return
            if resp.term > self._meta.term:
                self._step_down_unlocked(resp.term)
                return
            if resp.success:
                self._match_index[peer] = max(self._match_index[peer],
                                              min(sent_up_to,
                                                  resp.last_received_index))
                self._next_index[peer] = self._match_index[peer] + 1
                self._last_ack_send_time[peer] = max(
                    self._last_ack_send_time[peer], send_time)
                self._advance_commit_unlocked()
                should_apply = self.last_applied < self.commit_index
            else:
                # Log mismatch: back off to the follower's tail
                # (ref consensus_queue.cc response handling).
                self._next_index[peer] = min(self._next_index[peer] - 1,
                                             resp.last_received_index + 1)
                self._next_index[peer] = max(1, self._next_index[peer])
        if should_apply:
            self._apply_committed()

    def _advance_commit_unlocked(self) -> None:
        """Majority-match rule; only current-term entries count directly
        (Raft §5.4.2; ref UpdateMajorityReplicated raft_consensus.cc:1319).
        Self counts only while still a voter (a leader that appended its own
        removal keeps committing with the remaining majority)."""
        vals = [self._match_index.get(p, 0)
                for p in self.config.remote_peers]
        if self.config.peer_id in self.config.peer_ids:
            vals.append(self._local_durable_index)
        matches = sorted(vals, reverse=True)
        if len(matches) < self.config.majority:
            return
        candidate = matches[self.config.majority - 1]
        while candidate > self.commit_index:
            if self._term_at_unlocked(candidate) == self._meta.term:
                self._set_commit_index_unlocked(candidate)
                break
            candidate -= 1

    # Persist the advisory committed floor only every N entries: it is a
    # bootstrap optimization (flushed frontiers + leader re-commit cover the
    # gap), so putting a file rename on every commit would be pure overhead.
    _FLOOR_PERSIST_STRIDE = 64

    def _set_commit_index_unlocked(self, index: int) -> None:
        self.commit_index = index
        if index - self._meta.committed_floor >= self._FLOOR_PERSIST_STRIDE:
            self._meta.committed_floor = index
            self._meta.save_floor()
        self._commit_cv.notify_all()

    # ----------------------------------------------------------------- apply
    def _apply_committed(self) -> None:
        """Apply entries (last_applied, commit_index] in order. Serialized
        by _apply_lock; callable from any thread."""
        with self._apply_lock:
            while True:
                with self._lock:
                    if self.last_applied >= self.commit_index:
                        return
                    idx = self.last_applied + 1
                    msg = self._entries.get(idx)
                    budget = self._budget_by_index.pop(idx, None)
                if msg is None:
                    with self._lock:
                        msg = self._reload_from_wal_unlocked(idx)
                if msg.op_type == OP_CHANGE_CONFIG:
                    # Consensus-internal; committed config may remove us.
                    self._on_config_committed(msg)
                elif msg.op_type != OP_NOOP:
                    apply_t0 = time.monotonic()
                    try:
                        self.apply_cb(msg)
                    except Exception as e:  # noqa: BLE001 — contained
                        # A parked storage engine (background error) rejects
                        # the apply. last_applied MUST NOT advance past an
                        # unapplied entry; stop here and let the commit
                        # worker's next round retry — applies resume once
                        # the DB recovers (ref: tablet FAILED containment).
                        # (The popped budget is dropped: a deferred apply
                        # loses its attribution slice — advisory only.)
                        TRACE("raft %s: apply of op %s deferred: %s",
                              self.config.peer_id, msg.op_id, e)
                        return
                    if budget is not None:
                        budget.record(
                            _latency.STAGE_APPLY,
                            (time.monotonic() - apply_t0) * 1e3)
                with self._lock:
                    self.last_applied = idx
                    self._commit_cv.notify_all()

    def _on_config_committed(self, msg: ReplicateMsg) -> None:
        peer_ids = tuple(json.loads(msg.payload)["peer_ids"])
        with self._lock:
            if (self.config.peer_id not in peer_ids
                    and self.role == Role.LEADER):
                # We were removed: step down once the removal is committed
                # (ref raft_consensus.cc leader removal step-down).
                self._step_down_unlocked(self._meta.term)

    # -------------------------------------------------------- follower path
    def handle_update(self, req: AppendEntriesReq) -> AppendEntriesResp:
        """AppendEntries handler (ref raft_consensus.cc:1473 Update)."""
        me = self.config.peer_id
        with self._lock:
            if req.term < self._meta.term:
                return AppendEntriesResp(me, self._meta.term, False,
                                         self._last_index)
            if req.term > self._meta.term or self.role != Role.FOLLOWER:
                self._step_down_unlocked(req.term)
            self.leader_id = req.leader_id
            self._last_leader_contact = time.monotonic()
            self._withhold_votes_until = (time.monotonic()
                                          + req.lease_duration_s)
            # Log-matching check
            if req.preceding_index > 0:
                if req.preceding_index > self._last_index:
                    return AppendEntriesResp(me, self._meta.term, False,
                                             self._last_index)
                try:
                    local_term = self._term_at_unlocked(req.preceding_index)
                except KeyError:
                    local_term = -1
                if local_term != req.preceding_term:
                    # Conflict at/before preceding: force full backoff by
                    # hinting one below the conflict point.
                    return AppendEntriesResp(me, self._meta.term, False,
                                             req.preceding_index - 1)
            to_append: List[ReplicateMsg] = []
            for msg in req.entries:
                if msg.index <= self._last_index:
                    if self._term_at_unlocked(msg.index) == msg.term:
                        continue  # already have it
                    # Conflict: truncate our log from msg.index on.
                    if msg.index <= self.commit_index:
                        raise AssertionError(
                            "attempt to truncate committed entries")
                    for i in range(msg.index, self._last_index + 1):
                        self._entries.pop(i, None)
                        self._ht_by_index.pop(i, None)
                        self._trace_ctx_by_index.pop(i, None)
                        self._budget_by_index.pop(i, None)
                    self.log.truncate_after(msg.index - 1)
                    self._last_index = msg.index - 1
                    self._last_term = self._term_at_unlocked(self._last_index)
                    self._local_durable_index = min(
                        self._local_durable_index, self._last_index)
                    # Also roll back the async-appender watermark: indexes at
                    # or below the old watermark are being REWRITTEN, and the
                    # stale value must not resurrect durability for them if
                    # this node later becomes leader (the min(w, _last_index)
                    # cap in the commit worker only guards indexes above the
                    # new tail).
                    with self._durable_lock:
                        self._durable_watermark = min(
                            self._durable_watermark, self._last_index)
                    self._revert_config_unlocked(self._last_index)
                to_append.append(msg)
                self._entries[msg.index] = msg
                self._ht_by_index[msg.index] = msg.ht_value
                self._last_index = msg.index
                self._last_term = msg.term
                if self.on_append_cb is not None:
                    self.on_append_cb(msg)
                if msg.op_type == OP_CHANGE_CONFIG:
                    self._activate_config_unlocked(
                        msg.index,
                        tuple(json.loads(msg.payload)["peer_ids"]))
            if to_append:
                # Durable before ack: the leader counts this follower
                # toward majority once we respond.
                self.log.append_sync([m.to_log_entry() for m in to_append])
                self._local_durable_index = self._last_index
                TRACE("raft %s: appended %d entries from %s through %s",
                      me, len(to_append), req.leader_id,
                      to_append[-1].op_id)
            new_commit = min(req.committed_index, self._last_index)
            if new_commit > self.commit_index:
                self._set_commit_index_unlocked(new_commit)
            should_apply = self.last_applied < self.commit_index
            last = self._last_index
        if should_apply:
            self._apply_committed()
        if req.propagated_safe_time > 0:
            self.on_propagated_safe_time(req.propagated_safe_time)
        return AppendEntriesResp(me, self._meta.term, True, last)

    # -------------------------------------------------------- leader leases
    def leader_ready(self) -> bool:
        """The current term's NO_OP has been applied — every entry from
        prior terms is committed and applied locally, so reads see all
        previously acknowledged writes (ref: YB requires the leader-side
        noop commit before serving consistent reads)."""
        with self._lock:
            return (self.role == Role.LEADER
                    and self.last_applied >= getattr(
                        self, "_leader_noop_index", 0))

    def has_leader_lease(self) -> bool:
        """A majority acked a request sent within the lease window
        (ref leader_lease.h majority-replicated lease)."""
        with self._lock:
            if self.role != Role.LEADER:
                return False
            if len(self.config.peer_ids) == 1:
                return True
            times = sorted(
                [time.monotonic()]
                + [self._last_ack_send_time.get(p, 0.0)
                   for p in self.config.remote_peers],
                reverse=True)
            majority_time = times[self.config.majority - 1]
            lease_s = flags.get_flag("ht_lease_duration_ms") / 1000.0
            return time.monotonic() < majority_time + lease_s


    def committed_config_index(self) -> int:
        """Index of the newest COMMITTED config entry. Stale-replica
        eviction must key off committed configs only — an active-but-
        uncommitted removal can still be overwritten."""
        with self._lock:
            eligible = [i for i in self._config_history
                        if i <= self.commit_index]
            return max(eligible) if eligible else 0

    def wal_gc_anchor(self) -> int:
        """Lowest index the WAL must retain for replication purposes. A
        leader keeps everything a lagging peer still needs; elsewhere the
        committed prefix is safe. (Until remote bootstrap lands — SURVEY §7
        stage 7 — a peer lagging behind a GC'd log cannot catch up, so the
        leader-side cap is load-bearing.)"""
        with self._lock:
            if self.role == Role.LEADER and self.config.remote_peers:
                return min(self._match_index.get(p, 0)
                           for p in self.config.remote_peers) + 1
            return self.commit_index + 1

    def shutdown(self) -> None:
        with self._lock:
            self._stopped = True
            self._leader_epoch += 1
            if self.commit_index > self._meta.committed_floor:
                self._meta.committed_floor = self.commit_index
                self._meta.save_floor()
            for ev in self._peer_events.values():
                ev.set()
            self._commit_cv.notify_all()
        self._durable_event.set()
