"""Consensus transport seam.

Counterpart of yugabyte_tpu/consensus/transport.py, with the imports
renamed.

The reference sends consensus traffic through its custom RPC framework
(ref: src/yb/consensus/consensus_peers.h:131 `Peer::SendNextRequest` over a
`PeerProxy`). Here the seam is `PeerProxyIf` with two calls — UpdateConsensus
(AppendEntries) and RequestVote — so the same RaftConsensus runs over:

- `LocalTransport`: in-process dispatch between peers in one interpreter
  (the MiniCluster path, ref rpc/local_call.h bypass), with fault injection
  for failure tests, and
- the host RPC layer (rpc/consensus_service.py RpcTransport) for real
  multi-process clusters.

Fault semantics are shared with the RPC layer: LocalTransport delegates
to the same `NemesisRules` engine (rpc/nemesis.py) the messenger
consults, so chaos tests express symmetric/one-way partitions, drops,
latency and duplicate delivery identically over both fabrics.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

from yugabyte_tpu_torch.rpc.nemesis import (LinkBlocked, LinkDropped, LinkRule,
                                      NemesisRules)


class PeerUnreachable(Exception):
    pass


class LocalTransport:
    """In-process message fabric between named consensus instances."""

    def __init__(self, seed: int = 0):
        from yugabyte_tpu_torch.utils import lock_rank
        self._peers: Dict[str, object] = {}        # guarded-by: _lock
        self._lock = lock_rank.tracked(threading.Lock(),
                                       "local_transport._lock")
        # the shared fault-rule engine (same semantics as the messenger's
        # nemesis hook); the drop-probability convenience keeps a handle
        # to its rule so re-setting replaces instead of stacking
        self.rules = NemesisRules(seed=seed)
        self._drop_rule: Optional[LinkRule] = None  # guarded-by: _lock

    def register(self, peer_id: str, consensus: object) -> None:
        with self._lock:
            self._peers[peer_id] = consensus

    def unregister(self, peer_id: str) -> None:
        with self._lock:
            self._peers.pop(peer_id, None)

    # ------------------------------------------------------ fault injection
    def _known(self, name: str) -> bool:  # guarded-by: _lock
        return name in self._peers or \
            any(p.startswith(name + "/") for p in self._peers)

    def _require_known(self, what: str, *names: str) -> None:
        with self._lock:
            # a silent no-op fault (name not matching any registered peer
            # id) makes fault tests pass vacuously — fail loudly
            for name in names:
                if self._peers and not self._known(name):
                    raise ValueError(
                        f"{what}({name!r}): no such peer; registered: "
                        f"{sorted(self._peers)}")

    def partition(self, a: str, b: str, one_way: bool = False) -> None:
        """Cut the a<->b link (or only a->b when one_way): faults match
        the full consensus id ("ts0/t1") OR the server part ("ts0") — a
        network partition cuts SERVERS, so tests express it per-server
        and it applies to every tablet channel between them."""
        self._require_known("partition", a, b)
        self.rules.partition(a, b, one_way=one_way)

    def isolate(self, peer_id: str) -> None:
        """Cut peer_id off from everyone (crash-failure emulation)."""
        self._require_known("isolate", peer_id)
        self.rules.isolate(peer_id)

    def heal(self) -> None:
        with self._lock:
            self._drop_rule = None
        self.rules.heal()

    def set_drop_probability(self, p: float) -> None:
        """Drop every link's requests with probability p (0 clears)."""
        with self._lock:
            old = self._drop_rule
            self._drop_rule = None
        if old is not None:
            self.rules.remove_rule(old)
        if p > 0:
            rule = self.rules.add_rule(LinkRule("*", "*", drop_prob=p))
            with self._lock:
                self._drop_rule = rule

    def set_latency(self, src: str, dst: str, delay_s: float,
                    jitter_s: float = 0.0) -> None:
        self._require_known("set_latency", src, dst)
        self.rules.latency(src, dst, delay_s, jitter_s=jitter_s)

    def set_duplicate_probability(self, src: str, dst: str,
                                  p: float) -> None:
        self._require_known("set_duplicate", src, dst)
        self.rules.duplicate(src, dst, p)

    def _check_link(self, src: str, dst: str) -> Tuple[object, object]:
        try:
            verdict = self.rules.check_link(src, dst)
        except (LinkBlocked, LinkDropped) as e:
            raise PeerUnreachable(f"{src}->{dst}: {e}") from e
        with self._lock:
            peer = self._peers.get(dst)
        if peer is None:
            raise PeerUnreachable(f"{src}->{dst}: unknown peer")
        return peer, verdict

    # ------------------------------------------------------------ dispatch
    def update_consensus(self, src: str, dst: str, request):
        peer, verdict = self._check_link(src, dst)
        ctx = getattr(request, "trace_ctx", None)
        if ctx is not None:
            # mirror the RPC path's inbound adoption: the in-process hop
            # still produces a per-peer handler span under the same
            # trace_id, so LocalTransport clusters trace like real ones
            from yugabyte_tpu_torch.utils.trace import Trace
            with Trace.from_wire_context(ctx, f"consensus.update:{dst}"):
                resp = peer.handle_update(request)
        else:
            resp = peer.handle_update(request)
        if verdict.duplicate:
            peer.handle_update(request)  # second delivery; resp discarded
        if verdict.drop_response:
            raise PeerUnreachable(f"{src}->{dst}: response dropped "
                                  "(nemesis)")
        return resp

    def request_vote(self, src: str, dst: str, request):
        peer, verdict = self._check_link(src, dst)
        resp = peer.handle_vote_request(request)
        if verdict.duplicate:
            peer.handle_vote_request(request)
        if verdict.drop_response:
            raise PeerUnreachable(f"{src}->{dst}: response dropped "
                                  "(nemesis)")
        return resp
