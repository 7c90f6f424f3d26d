"""MultiRaftBatcher: cross-tablet consensus heartbeat batching.

Counterpart of yugabyte_tpu/consensus/multi_raft_batcher.py, with the
imports renamed.

A tserver hosting T tablets whose leaders share a follower server sends
T independent AppendEntries heartbeats per interval to that server —
O(tablets x peers) messages of ~nothing (ref:
src/yb/consensus/multi_raft_batcher.cc, motivated by exactly this fan-out).

This batcher collapses them: per DESTINATION SERVER, heartbeat-shaped
requests (no entries) arriving within a short window ride ONE
`multi_update_consensus` RPC carrying [(dst_peer, req), ...]; the remote
ConsensusService dispatches each to its tablet's RaftConsensus and returns
the responses positionally.  Data-bearing AppendEntries never wait here —
batching them would tax write latency for no message-count win (each
already carries a meaningful payload).

The caller's thread blocks on its slot future, so per-tablet raft code is
unchanged: the batcher is purely a transport-level coalescer.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Tuple

from yugabyte_tpu_torch.consensus.transport import PeerUnreachable
from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY

flags.define_flag("multi_raft_batch_window_ms", 3,
                  "consensus heartbeats to one destination server within "
                  "this window share one multi_update_consensus RPC "
                  "(ref multi_raft_heartbeat_interval_ms); 0 disables "
                  "batching")
flags.define_flag("multi_raft_batch_max", 256,
                  "max heartbeats per batched RPC")


class _Slot:
    __slots__ = ("event", "resp", "err")

    def __init__(self):
        self.event = threading.Event()
        self.resp = None
        self.err: Optional[Exception] = None


class MultiRaftBatcher:
    """One per server process; groups heartbeats by destination address."""

    def __init__(self, send_batch: Callable[[str, List[Tuple[str, dict]]],
                                            List[dict]]):
        """send_batch(addr, [(dst_peer, wire_req), ...]) -> [wire_resp,...]
        (positional; an item-level failure is a dict with key 'err')."""
        from yugabyte_tpu_torch.utils import lock_rank
        self._send_batch = send_batch
        self._lock = lock_rank.tracked(threading.Lock(),
                                       "multi_raft._lock")
        self._queues: Dict[str, List[Tuple[str, dict,
                                           _Slot]]] = {}  # guarded-by: _lock
        self._timers: Dict[str, threading.Timer] = {}     # guarded-by: _lock
        self._stopped = False                             # guarded-by: _lock
        # observability: how many heartbeats rode how many RPCs. The ints
        # are per-batcher (tests diff them per server); the registry
        # counters aggregate process-wide for scraping.
        self.heartbeats_in = 0                            # guarded-by: _lock
        self.batches_out = 0                              # guarded-by: _lock
        e = ROOT_REGISTRY.entity("server", "multi_raft")
        self._c_heartbeats = e.counter(
            "multi_raft_heartbeats_total",
            "consensus heartbeats submitted to the batcher")
        self._c_batches = e.counter(
            "multi_raft_batches_total",
            "batched multi_update_consensus RPCs sent")

    def counters(self) -> Tuple[int, int]:
        """Locked (heartbeats_in, batches_out) snapshot for observers;
        the fields themselves must only be touched under `_lock`."""
        with self._lock:
            return self.heartbeats_in, self.batches_out

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            timers = list(self._timers.values())
            self._timers.clear()
            # fail queued slots NOW — leaving them to ride out the full
            # slot timeout stalls server shutdown by seconds per peer
            pending = [s for q in self._queues.values() for _d, _r, s in q]
            self._queues.clear()
        for t in timers:
            t.cancel()
        for slot in pending:
            slot.err = PeerUnreachable("batcher stopped")
            slot.event.set()

    def submit(self, addr: str, dst_peer: str, wire_req: dict,
               timeout_s: Optional[float] = None) -> dict:
        """Enqueue one heartbeat for addr; blocks until its response."""
        window = flags.get_flag("multi_raft_batch_window_ms") / 1000.0
        if timeout_s is None:
            # must exceed the underlying RPC timeout plus the batch window,
            # else a slow-but-successful batch RPC fails every coalesced
            # heartbeat spuriously
            timeout_s = flags.get_flag("rpc_default_timeout_s") + window + 1.0
        slot = _Slot()
        flush_now = False
        with self._lock:
            if self._stopped:
                raise PeerUnreachable(f"{dst_peer}: batcher stopped")
            q = self._queues.setdefault(addr, [])
            q.append((dst_peer, wire_req, slot))
            self.heartbeats_in += 1
            self._c_heartbeats.increment()
            if len(q) >= flags.get_flag("multi_raft_batch_max"):
                flush_now = True
            elif addr not in self._timers:
                t = threading.Timer(window, self._flush, args=(addr,))
                t.daemon = True
                self._timers[addr] = t
                t.start()
        if flush_now:
            self._flush(addr)
        if not slot.event.wait(timeout_s):
            raise PeerUnreachable(f"{dst_peer}@{addr}: batched heartbeat "
                                  f"timed out")
        if slot.err is not None:
            raise slot.err
        return slot.resp

    def _flush(self, addr: str) -> None:
        with self._lock:
            timer = self._timers.pop(addr, None)
            batch = self._queues.pop(addr, [])
        if timer is not None:
            timer.cancel()
        if not batch:
            return
        with self._lock:
            self.batches_out += 1
        self._c_batches.increment()
        try:
            resps = self._send_batch(addr, [(d, r) for d, r, _s in batch])
            if len(resps) != len(batch):
                raise PeerUnreachable(
                    f"{addr}: batched response arity mismatch "
                    f"({len(resps)} != {len(batch)})")
        except Exception as e:  # noqa: BLE001  # yblint: contained(failure fanned out to every waiter slot below)
            for _d, _r, slot in batch:
                slot.err = e if isinstance(e, PeerUnreachable) \
                    else PeerUnreachable(f"{addr}: {e}")
                slot.event.set()
            return
        for (dst, _r, slot), resp in zip(batch, resps):
            if isinstance(resp, dict) and "err" in resp:
                slot.err = PeerUnreachable(f"{dst}@{addr}: {resp['err']}")
            else:
                slot.resp = resp
            slot.event.set()
