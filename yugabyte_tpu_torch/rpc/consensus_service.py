"""Consensus traffic over the host RPC layer.

Counterpart of yugabyte_tpu/rpc/consensus_service.py, with the imports
renamed.

The reference sends AppendEntries/RequestVote through generated proxies to a
`ConsensusService` that routes by tablet id (ref: src/yb/consensus/
consensus_peers.cc `Peer::SendNextRequest`; tserver registers the service in
tserver/tablet_server.cc). Here:

- `ConsensusService` is the server half: one instance per Messenger, holding
  the local RaftConsensus instances keyed by peer address
  "<server_id>/<tablet_id>" (the same keying LocalTransport uses, so
  TabletPeer code is transport-agnostic).
- `RpcTransport` is the client half implementing the consensus transport
  seam (register/update_consensus/request_vote). It resolves the *server*
  half of a peer address to host:port via a resolver callable — the cluster
  config (master heartbeats) keeps that mapping fresh.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from yugabyte_tpu_torch.consensus.raft import (
    AppendEntriesReq, AppendEntriesResp, ReplicateMsg, VoteReq, VoteResp)
from yugabyte_tpu_torch.consensus.transport import PeerUnreachable
from yugabyte_tpu_torch.rpc.messenger import (
    Messenger, RemoteError, RpcTimeout, ServiceUnavailable)

SERVICE_NAME = "consensus"


def _msg_to_wire(m: ReplicateMsg) -> list:
    return [m.term, m.index, m.op_type, m.ht_value, m.payload]


def _msg_from_wire(w: list) -> ReplicateMsg:
    return ReplicateMsg(w[0], w[1], w[2], w[3], w[4])


def append_req_to_wire(req: AppendEntriesReq) -> dict:
    w = {
        "term": req.term, "leader_id": req.leader_id,
        "preceding_term": req.preceding_term,
        "preceding_index": req.preceding_index,
        "entries": [_msg_to_wire(m) for m in req.entries],
        "committed_index": req.committed_index,
        "propagated_safe_time": req.propagated_safe_time,
        "lease_duration_s": req.lease_duration_s,
    }
    if req.trace_ctx is not None:
        w["trace_ctx"] = req.trace_ctx
    return w


def append_req_from_wire(w: dict) -> AppendEntriesReq:
    return AppendEntriesReq(
        term=w["term"], leader_id=w["leader_id"],
        preceding_term=w["preceding_term"],
        preceding_index=w["preceding_index"],
        entries=tuple(_msg_from_wire(m) for m in w["entries"]),
        committed_index=w["committed_index"],
        propagated_safe_time=w["propagated_safe_time"],
        lease_duration_s=w["lease_duration_s"],
        trace_ctx=w.get("trace_ctx"))  # absent from old peers: untraced


class ConsensusService:
    """Server-side dispatch to local RaftConsensus instances."""

    def __init__(self):
        self._peers: Dict[str, object] = {}

    def register(self, peer_id: str, consensus: object) -> None:
        self._peers[peer_id] = consensus

    def unregister(self, peer_id: str) -> None:
        self._peers.pop(peer_id, None)

    def _peer(self, peer_id: str):
        peer = self._peers.get(peer_id)
        if peer is None:
            from yugabyte_tpu_torch.utils.status import Status, StatusError
            raise StatusError(Status.NotFound(
                f"no consensus instance for {peer_id!r} here"))
        return peer

    # -------------------------------------------------------- wire handlers
    def update_consensus(self, dst: str, req: dict) -> dict:
        resp = self._peer(dst).handle_update(append_req_from_wire(req))
        return {"responder_id": resp.responder_id, "term": resp.term,
                "success": resp.success,
                "last_received_index": resp.last_received_index}

    def request_vote(self, dst: str, req: dict) -> dict:
        resp = self._peer(dst).handle_vote_request(VoteReq(
            term=req["term"], candidate_id=req["candidate_id"],
            last_log_term=req["last_log_term"],
            last_log_index=req["last_log_index"],
            ignore_lease=req["ignore_lease"]))
        return {"responder_id": resp.responder_id, "term": resp.term,
                "granted": resp.granted}

    def multi_update_consensus(self, items: list) -> dict:
        """Batched cross-tablet heartbeats (ref multi_raft_batcher.cc):
        [(dst_peer, wire_req), ...] -> positional responses; per-item
        failures come back as {'err': ...} so one dead tablet cannot fail
        its whole batch."""
        out = []
        for dst, req in items:
            try:
                out.append(self.update_consensus(dst, req))
            except Exception as e:  # noqa: BLE001 — isolate per item
                out.append({"err": repr(e)})
        return {"resps": out}


class RpcTransport:  # yblint: disable=ybsan-coverage (stateless dispatch seam: every attr is set once in __init__ and read-only after; the .submit goes to MultiRaftBatcher, whose shared state carries its own guarded-by annotations)
    """Client-side consensus transport seam over the Messenger.

    resolver(peer_address) -> 'host:port' of the server hosting that peer,
    or None if unknown (treated as unreachable, like a failed DNS lookup in
    the reference's periodic proxy refresh)."""

    def __init__(self, messenger: Messenger,
                 resolver: Callable[[str], Optional[str]]):
        from yugabyte_tpu_torch.consensus.multi_raft_batcher import (
            MultiRaftBatcher)
        self._messenger = messenger
        self._resolver = resolver
        self._service = ConsensusService()
        messenger.register_service(SERVICE_NAME, self._service)
        # cross-tablet heartbeat coalescing (one per server process)
        self.batcher = MultiRaftBatcher(self._send_batch)

    def _send_batch(self, addr: str, items):
        try:
            w = self._messenger.call(addr, SERVICE_NAME,
                                     "multi_update_consensus",
                                     items=[[d, r] for d, r in items])
        except (RpcTimeout, ServiceUnavailable, RemoteError) as e:
            raise PeerUnreachable(f"batch@{addr}: {e}") from e
        return w["resps"]

    def register(self, peer_id: str, consensus: object) -> None:
        self._service.register(peer_id, consensus)

    def unregister(self, peer_id: str) -> None:
        self._service.unregister(peer_id)

    def _call(self, dst: str, mth: str, req: dict) -> dict:
        addr = self._resolver(dst)
        if addr is None:
            raise PeerUnreachable(f"{dst}: no address known")
        try:
            return self._messenger.call(addr, SERVICE_NAME, mth,
                                        dst=dst, req=req)
        except (RpcTimeout, ServiceUnavailable, RemoteError) as e:
            raise PeerUnreachable(f"{dst}@{addr}: {e}") from e

    # ------------------------------------------------------------- dispatch
    def update_consensus(self, src: str, dst: str,
                         request: AppendEntriesReq) -> AppendEntriesResp:
        from yugabyte_tpu_torch.utils import flags as _flags
        if (not request.entries
                and _flags.get_flag("multi_raft_batch_window_ms") > 0):
            # empty AppendEntries = heartbeat: coalesce across tablets
            # sharing this destination server (multi_raft_batcher.py);
            # data-bearing requests never wait in the batch window
            addr = self._resolver(dst)
            if addr is None:
                raise PeerUnreachable(f"{dst}: no address known")
            w = self.batcher.submit(addr, dst,
                                    append_req_to_wire(request))
        else:
            w = self._call(dst, "update_consensus",
                           append_req_to_wire(request))
        return AppendEntriesResp(
            responder_id=w["responder_id"], term=w["term"],
            success=w["success"],
            last_received_index=w["last_received_index"])

    def request_vote(self, src: str, dst: str, request: VoteReq) -> VoteResp:
        w = self._call(dst, "request_vote", {
            "term": request.term, "candidate_id": request.candidate_id,
            "last_log_term": request.last_log_term,
            "last_log_index": request.last_log_index,
            "ignore_lease": request.ignore_lease})
        return VoteResp(responder_id=w["responder_id"], term=w["term"],
                        granted=w["granted"])
