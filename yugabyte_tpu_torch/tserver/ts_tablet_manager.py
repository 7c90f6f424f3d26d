"""TSTabletManager: tablet lifecycle on one tablet server.

Counterpart of yugabyte_tpu/tserver/ts_tablet_manager.py, with the
imports renamed. Its default tablet-options factory is `TabletOptions`,
whose device=None is the card in the port (the JAX package's is
device-free; ROADMAP C.1): a port twin of a JAX case with no factory
passes `lambda: TabletOptions(device="native")`.

Capability parity with the reference (ref: src/yb/tserver/ts_tablet_manager.h
:126 — creates/opens/deletes TabletPeers, persists per-tablet metadata so a
restart reopens every hosted tablet and replays its WAL; the reference keeps
RaftGroupMetadata in a superblock protobuf, here a JSON sidecar per tablet
dir). Thread-safe: RPC handlers and the heartbeater hit it concurrently.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Dict, List, Optional, Sequence

from yugabyte_tpu_torch.utils import jsonutil

from yugabyte_tpu_torch.common.hybrid_time import HybridClock
from yugabyte_tpu_torch.common.wire import schema_from_wire, schema_to_wire
from yugabyte_tpu_torch.tablet.tablet import TabletOptions
from yugabyte_tpu_torch.tablet.tablet_peer import TabletPeer
from yugabyte_tpu_torch.utils.status import Status, StatusError
from yugabyte_tpu_torch.utils.trace import TRACE


class TSTabletManager:
    def __init__(self, server_id: str, fs_root: str, transport,
                 clock: Optional[HybridClock] = None,
                 tablet_options_factory=None, metrics=None,
                 messenger=None):
        self.server_id = server_id
        self.fs_root = fs_root
        self.transport = transport
        self.clock = clock or HybridClock()
        self.metrics = metrics
        self.messenger = messenger
        from yugabyte_tpu_torch.tserver.remote_bootstrap import (
            RemoteBootstrapSessions)
        self.rb_sessions = RemoteBootstrapSessions(fs_root)
        self._tablet_options_factory = tablet_options_factory or TabletOptions
        self._tablets: Dict[str, TabletPeer] = {}
        self._meta: Dict[str, dict] = {}  # tablet_id -> superblock dict
        self._rb_in_progress: set = set()
        # Wired by the TabletServer after construction; tablets call it to
        # resolve foreign transaction statuses at read time.
        self.status_resolver = None
        self._lock = threading.Lock()
        # Serializes whole tablet creations: two concurrent (retried /
        # reconciler-raced) create_tablet RPCs must never both open a
        # TabletPeer over the same WAL directory. Reentrant: opening a
        # tablet can replay a SPLIT op, which creates children while the
        # lock is already held.
        self._create_lock = threading.RLock()
        os.makedirs(self._tablets_root, exist_ok=True)

    @property
    def _tablets_root(self) -> str:
        return os.path.join(self.fs_root, "tablets")

    def _tablet_dir(self, tablet_id: str) -> str:
        return os.path.join(self._tablets_root, tablet_id)

    # ------------------------------------------------------------- lifecycle
    def open_existing(self) -> int:
        """Reopen every tablet found on disk (restart path; ref
        TSTabletManager::Init replaying each superblock). A parent's SPLIT
        replay may open its children before the loop reaches their dirs, so
        re-check under the create lock; dot-dirs are crash leftovers of
        interrupted bootstraps/splits and are swept."""
        opened = 0
        for tablet_id in sorted(os.listdir(self._tablets_root)):
            if tablet_id.startswith("."):
                shutil.rmtree(os.path.join(self._tablets_root, tablet_id),
                              ignore_errors=True)
                continue
            with self._create_lock:
                with self._lock:
                    if tablet_id in self._tablets:
                        continue
                meta_path = os.path.join(self._tablet_dir(tablet_id),
                                         "meta.json")
                if not os.path.exists(meta_path):
                    continue
                self._open_tablet(tablet_id, jsonutil.read_file(meta_path))
            opened += 1
        return opened

    def create_tablet(self, tablet_id: str, table_id: str, schema_wire: dict,
                      peer_server_ids: Sequence[str],
                      partition_wire: Optional[dict] = None,
                      hash_partitioning: bool = True) -> None:
        """Create a brand-new tablet replica on this server (ref
        TSTabletManager::CreateNewTablet). Idempotent for retried RPCs."""
        with self._create_lock:
            with self._lock:
                if tablet_id in self._tablets:
                    return
            tdir = self._tablet_dir(tablet_id)
            meta_path = os.path.join(tdir, "meta.json")
            if os.path.exists(meta_path):
                self._open_tablet(tablet_id, jsonutil.read_file(meta_path))
                return
            meta = {"tablet_id": tablet_id, "table_id": table_id,
                    "schema": schema_wire,
                    "peer_server_ids": list(peer_server_ids),
                    "partition": partition_wire,
                    "hash_partitioning": hash_partitioning}
            os.makedirs(tdir, exist_ok=True)
            jsonutil.write_atomic(meta_path, meta)
            self._open_tablet(tablet_id, meta)
        TRACE("ts %s: created tablet %s (table %s)",
              self.server_id, tablet_id, table_id)

    def _open_tablet(self, tablet_id: str, meta: dict) -> None:
        import dataclasses

        from yugabyte_tpu_torch.common.partition import (
            Partition, doc_key_bounds)
        schema = schema_from_wire(meta["schema"])
        options = self._tablet_options_factory()
        part_wire = meta.get("partition")
        if part_wire is not None:
            lower, upper = doc_key_bounds(
                Partition(part_wire["start"], part_wire["end"]),
                meta.get("hash_partitioning", True))
            options = dataclasses.replace(
                options, lower_bound_key=lower, upper_bound_key=upper)
        peer = TabletPeer(
            tablet_id, self._tablet_dir(tablet_id), schema,
            server_id=self.server_id,
            server_ids=meta["peer_server_ids"],
            transport=self.transport, clock=self.clock,
            options=options,
            metrics=self.metrics)
        # Late-bound status resolver (assigned on the manager after
        # construction): conservative pending when unset.
        peer.tablet.status_resolver = (
            lambda st, txn, read_ht=None:
            self.status_resolver(st, txn, read_ht)
            if self.status_resolver is not None
            else {"status": "pending", "commit_ht": None})
        # Closure over peer+meta: during bootstrap replay the parent is not
        # yet in self._tablets, so the hook must not look it up.
        peer.on_split = (
            lambda info, p=peer, m=meta: self._create_split_children(
                p, m, info))
        # Membership changes must survive restarts: mirror the active Raft
        # config into the superblock (ref RaftGroupMetadata config update).
        peer.raft.on_config_change = (
            lambda ids, tid=tablet_id: self._update_peers_in_meta(tid, ids))
        peer.start(election_timer=True)
        with self._lock:
            self._tablets[tablet_id] = peer
            self._meta[tablet_id] = meta
        active = sorted(p.split("/", 1)[0]
                        for p in peer.raft.config.peer_ids)
        if active != sorted(meta["peer_server_ids"]):
            self._update_peers_in_meta(
                tablet_id, tuple(peer.raft.config.peer_ids))

    def _update_peers_in_meta(self, tablet_id: str,
                              peer_ids: tuple) -> None:
        server_ids = [p.split("/", 1)[0] for p in peer_ids]
        with self._lock:
            meta = self._meta.get(tablet_id)
            if meta is None:
                return
            meta["peer_server_ids"] = server_ids
            snapshot = dict(meta)
        jsonutil.write_atomic(
            os.path.join(self._tablet_dir(tablet_id), "meta.json"), snapshot)

    # ----------------------------------------------------------- splitting
    def _create_split_children(self, parent, parent_meta: dict,
                               info: dict) -> None:
        """SPLIT-op apply hook: snapshot the parent into two child tablets
        (hard links) with halved partitions. Idempotent — re-invoked on WAL
        replay after restart (ref tablet.cc:3338 CreateSubtablet)."""
        from yugabyte_tpu_torch.tserver.remote_bootstrap import _snapshot_tree
        parent_id = parent.tablet_id
        split_pk = bytes.fromhex(info["split_partition_key"])
        part = parent_meta.get("partition") or {"start": b"", "end": b""}
        child_parts = [{"start": part["start"], "end": split_pk},
                       {"start": split_pk, "end": part["end"]}]
        parent.tablet.flush()
        for child_id, child_part in zip(info["children"], child_parts):
            with self._create_lock:
                with self._lock:
                    already = child_id in self._tablets
                if already:
                    self._inherit_retryable(parent, child_id)
                    continue
                cdir = self._tablet_dir(child_id)
                if os.path.exists(os.path.join(cdir, "meta.json")):
                    self._open_tablet(child_id, jsonutil.read_file(
                        os.path.join(cdir, "meta.json")))
                    self._inherit_retryable(parent, child_id)
                    continue
                tmp_dir = os.path.join(self._tablets_root,
                                       f".split-{child_id}")
                shutil.rmtree(tmp_dir, ignore_errors=True)
                _snapshot_tree(os.path.join(parent.data_dir, "regular"),
                               os.path.join(tmp_dir, "regular"))
                _snapshot_tree(os.path.join(parent.data_dir, "intents"),
                               os.path.join(tmp_dir, "intents"))
                meta = {"tablet_id": child_id,
                        "table_id": parent_meta["table_id"],
                        "schema": parent_meta["schema"],
                        "peer_server_ids": [
                            p.split("/", 1)[0]
                            for p in parent.raft.config.peer_ids],
                        "partition": child_part,
                        "hash_partitioning": parent_meta.get(
                            "hash_partitioning", True),
                        "split_parent": parent_id}
                jsonutil.write_atomic(os.path.join(tmp_dir, "meta.json"),
                                      meta)
                shutil.rmtree(cdir, ignore_errors=True)
                os.rename(tmp_dir, cdir)
                self._open_tablet(child_id, meta)
            # exactly-once dedup survives the split on EVERY path (fresh
            # create, replay re-open, already-open): children adopt the
            # parent's retryable-request records — the data they inherited
            # includes those writes
            self._inherit_retryable(parent, child_id)
        TRACE("ts %s: split %s -> %s", self.server_id, parent_id,
              info["children"])

    def _inherit_retryable(self, parent, child_id: str) -> None:
        with self._lock:
            child = self._tablets.get(child_id)
        if child is not None:
            child.tablet.retryable.inherit_from(parent.tablet.retryable)

    def split_tablet(self, tablet_id: str) -> List[str]:
        """Leader-side split entry: compute the split point and replicate
        the SPLIT op (ref master's TabletSplitManager driving
        tserver SplitTablet RPCs)."""
        peer = self.get_tablet(tablet_id)
        meta = self.tablet_meta(tablet_id)
        if peer.tablet.split_children is not None:
            return list(peer.tablet.split_children)
        split_pk = peer.tablet.split_partition_key(
            meta.get("hash_partitioning", True))
        if split_pk is None:
            raise StatusError(Status.IllegalState(
                f"tablet {tablet_id} has too little data to split"))
        part = meta.get("partition") or {"start": b"", "end": b""}
        if not (part["start"] < split_pk
                and (not part["end"] or split_pk < part["end"])):
            raise StatusError(Status.IllegalState(
                f"median key outside partition; cannot split {tablet_id}"))
        children = [f"{tablet_id}.s0", f"{tablet_id}.s1"]
        peer.submit_split(children, split_pk)
        return children

    # ------------------------------------------------------ remote bootstrap
    def start_remote_bootstrap(self, tablet_id: str,
                               source_addr: str) -> None:
        """Destination path: download a snapshot from source_addr and open
        the replica (ref remote_bootstrap_client.cc). Idempotent: a replica
        that already exists locally is left alone."""
        from yugabyte_tpu_torch.tablet.tablet_peer import STATE_FAILED
        from yugabyte_tpu_torch.tserver.remote_bootstrap import download_tablet
        with self._create_lock:
            with self._lock:
                cur = self._tablets.get(tablet_id)
            if cur is not None:
                if not (cur.state == STATE_FAILED
                        and getattr(cur, "failed_corrupt", False)):
                    return
                # Corruption-failed replica: its on-disk data is bad and
                # sticky (retry refuses to clear it) — tear it down and
                # rebuild in place from the healthy source the master
                # pointed us at. Never done to a healthy replica: the
                # idempotent-skip above protects those.
                TRACE("ts %s: rebuilding corrupt replica %s from %s",
                      self.server_id, tablet_id, source_addr)
                self.delete_tablet(tablet_id)
            tdir = self._tablet_dir(tablet_id)
            if os.path.exists(os.path.join(tdir, "meta.json")):
                self._open_tablet(
                    tablet_id,
                    jsonutil.read_file(os.path.join(tdir, "meta.json")))
                return
            with self._lock:
                if tablet_id in self._rb_in_progress:
                    return  # another thread is already downloading it
                self._rb_in_progress.add(tablet_id)
        # Download OUTSIDE the create lock: a multi-GB transfer must not
        # head-of-line-block every other tablet creation on this server.
        tmp_dir = os.path.join(self._tablets_root, f".rb-{tablet_id}")
        try:
            shutil.rmtree(tmp_dir, ignore_errors=True)
            os.makedirs(tmp_dir, exist_ok=True)
            resp = download_tablet(self.messenger, source_addr, tablet_id,
                                   tmp_dir)
        except BaseException:
            shutil.rmtree(tmp_dir, ignore_errors=True)
            with self._lock:
                self._rb_in_progress.discard(tablet_id)
            raise
        with self._create_lock:
            with self._lock:
                self._rb_in_progress.discard(tablet_id)
                if tablet_id in self._tablets:
                    shutil.rmtree(tmp_dir, ignore_errors=True)
                    return
            src_meta = resp["tablet_meta"]
            meta = {"tablet_id": tablet_id,
                    "table_id": src_meta["table_id"],
                    "schema": src_meta["schema"],
                    "peer_server_ids": [p.split("/", 1)[0]
                                        for p in resp["peer_ids"]],
                    "partition": src_meta.get("partition"),
                    "hash_partitioning": src_meta.get("hash_partitioning",
                                                      True),
                    "split_parent": src_meta.get("split_parent")}
            # Fresh vote record at the source's term; adopting the source's
            # votes could double-vote in an in-flight election.
            jsonutil.write_atomic(
                os.path.join(tmp_dir, "cmeta.json"),
                {"term": resp["term"], "voted_for": None,
                 "peer_ids": resp["peer_ids"],
                 "config_index": resp["config_index"]})
            jsonutil.write_atomic(os.path.join(tmp_dir, "meta.json"), meta)
            shutil.rmtree(tdir, ignore_errors=True)
            os.rename(tmp_dir, tdir)
            self._open_tablet(tablet_id, meta)
        TRACE("ts %s: remote-bootstrapped tablet %s from %s",
              self.server_id, tablet_id, source_addr)

    def recover_failed_tablet(self, tablet_id: str) -> bool:
        """Bring a FAILED replica back: in-place first (clears DB
        background errors and retries the parked flush), then — for
        failures a live process cannot undo, like a sealed WAL with a torn
        tail — a full re-bootstrap: shut the peer down and reopen it from
        its on-disk state so the normal torn-tail replay + leader catch-up
        rules apply (ref: the reference tombstones and re-bootstraps
        failed replicas). Returns True when the replica is RUNNING."""
        from yugabyte_tpu_torch.tablet.tablet_peer import STATE_FAILED
        peer = self.get_tablet(tablet_id)
        if peer.state != STATE_FAILED:
            return True
        if peer.try_recover():
            return True
        if peer.log.io_error is None:
            # a DB background error that STILL fails to clear means the
            # disk is still bad — re-bootstrapping onto the same disk
            # cannot help; stay parked and let the backoff retry again
            return False
        with self._create_lock:
            with self._lock:
                cur = self._tablets.get(tablet_id)
                if cur is not peer:
                    # replaced concurrently (another recovery / delete)
                    return cur is not None and cur.state != STATE_FAILED
                self._tablets.pop(tablet_id)
                meta = self._meta.pop(tablet_id)
            self.transport.unregister(peer.raft.config.peer_id)
            try:
                peer.shutdown()
            except OSError as e:
                TRACE("ts %s: shutdown of failed tablet %s raised: %s",
                      self.server_id, tablet_id, e)
            self._open_tablet(tablet_id, meta)
        TRACE("ts %s: re-bootstrapped failed tablet %s", self.server_id,
              tablet_id)
        return True

    def delete_tablet(self, tablet_id: str) -> None:
        """ref TSTabletManager::DeleteTablet — shut down + remove data."""
        with self._lock:
            peer = self._tablets.pop(tablet_id, None)
            self._meta.pop(tablet_id, None)
        if peer is not None:
            self.transport.unregister(peer.raft.config.peer_id)
            peer.shutdown()
        shutil.rmtree(self._tablet_dir(tablet_id), ignore_errors=True)
        TRACE("ts %s: deleted tablet %s", self.server_id, tablet_id)

    # --------------------------------------------------------------- lookup
    def get_tablet(self, tablet_id: str) -> TabletPeer:
        with self._lock:
            peer = self._tablets.get(tablet_id)
        if peer is None:
            raise StatusError(Status.NotFound(
                f"tablet {tablet_id} not hosted on {self.server_id}"))
        return peer

    def peers(self) -> List[TabletPeer]:
        """Atomic snapshot of all hosted peers (memory arbiter, reports)."""
        with self._lock:
            return list(self._tablets.values())

    def alter_tablet_schema(self, tablet_id: str, schema_wire: dict,
                            version: int) -> bool:
        """Apply an online schema change to a hosted tablet (ref
        TSTabletManager + tablet AlterSchema; versions are monotonic and
        retries idempotent).  Returns True when applied or already at
        `version`."""
        with self._lock:
            peer = self._tablets.get(tablet_id)
        if peer is None:
            raise StatusError(Status.NotFound(
                f"tablet {tablet_id} not hosted on {self.server_id}"))
        with self._create_lock:
            # re-read under the serializing lock: a concurrent NEWER alter
            # (direct push racing a heartbeat piggyback) must not be
            # overwritten by this older one
            with self._lock:
                meta = self._meta.get(tablet_id)
            if meta is None:
                raise StatusError(Status.NotFound(
                    f"tablet {tablet_id} not hosted on {self.server_id}"))
            if meta.get("schema_version", 0) >= version:
                return True
            meta = dict(meta, schema=schema_wire, schema_version=version)
            jsonutil.write_atomic(
                os.path.join(self._tablet_dir(tablet_id), "meta.json"),
                meta)
            with self._lock:
                self._meta[tablet_id] = meta
            if peer.tablet is not None:
                peer.tablet.schema = schema_from_wire(schema_wire)
        TRACE("ts %s: tablet %s schema -> v%d", self.server_id, tablet_id,
              version)
        return True

    def apply_history_retention(self, overrides) -> None:
        """Heartbeat piggyback: per-tablet minimum MVCC history retention
        required by the master's active snapshot schedules (PITR).

        None (older master / probe path) is a no-op; a dict is the complete
        view — hosted tablets absent from it reset to zero so a deleted
        schedule releases its deep retention."""
        if overrides is None:
            return
        for peer in self.peers():
            if peer.tablet is not None:
                peer.tablet.retention_policy.set_override(
                    overrides.get(peer.tablet_id, 0.0))

    def tablet_ids(self) -> List[str]:
        with self._lock:
            return list(self._tablets)

    def tablet_meta(self, tablet_id: str) -> dict:
        with self._lock:
            return dict(self._meta.get(tablet_id) or {})

    def generate_report(self) -> List[dict]:  # yblint: wire-pair(tablet_report, writes)
        """Per-tablet state for the heartbeat (ref master_heartbeat.proto
        tablet reports)."""
        with self._lock:
            peers = list(self._tablets.items())
        report = []
        for tablet_id, peer in peers:
            role, _commit = peer.raft.observed_state()
            entry = {
                "tablet_id": tablet_id,
                "role": role.value,
                # FAILED replicas are reported so the master's load
                # balancer can re-replicate without waiting for the whole
                # server to go silent (ref tablet reports carrying
                # RaftGroupStatePB / tablet data state).
                "state": peer.state,
                # corruption-failed replicas (scrub / read-path CRC /
                # digest divergence) are rebuilt IN PLACE from a healthy
                # peer — the disk is fine, the data is not, so no spare
                # server is needed
                "failed_corrupt": bool(getattr(peer, "failed_corrupt",
                                               False)),
                "term": peer.raft.current_term,
                "leader_ready": peer.raft.is_leader() and
                peer.raft.leader_ready(),
                "replica_servers": [p.split("/", 1)[0]
                                    for p in peer.raft.config.peer_ids],
                # For stale-replica detection: a replica whose config is
                # older than the authoritative one AND that is no longer a
                # voter gets torn down by the master. COMMITTED configs
                # only — an uncommitted removal may yet be overwritten.
                "config_index": peer.raft.committed_config_index(),
            }
            meta = self.tablet_meta(tablet_id)
            entry["schema_version"] = meta.get("schema_version", 0)
            if meta.get("split_parent"):
                # Enough context for the master to ADOPT a split child it
                # has never heard of (ref tablet reports carrying
                # split_parent_tablet_id in master_heartbeat.proto).
                entry["split_parent"] = meta["split_parent"]
                entry["table_id"] = meta["table_id"]
                entry["partition"] = meta.get("partition")
            # (split children are NOT piggybacked on the parent's entry:
            # the master adopts each child from the child's own report —
            # see `split_parent` above — and derives parent completeness
            # from its catalog, so a parent-side list was dead wire
            # weight the wire-drift lint now rejects.)
            report.append(entry)
        return report

    def shutdown(self) -> None:
        with self._lock:
            peers = list(self._tablets.values())
            self._tablets.clear()
        for peer in peers:
            peer.shutdown()
