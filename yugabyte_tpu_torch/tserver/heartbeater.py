"""Heartbeater: periodic TSHeartbeat from tserver to the master leader.

Counterpart of yugabyte_tpu/tserver/heartbeater.py, with the imports
renamed.

Capability parity with the reference (ref: src/yb/tserver/heartbeater.cc:382
`TryHeartbeat` — registration on first beat, tablet reports, master-leader
failover by re-resolving; ref master_heartbeat.proto:136,236-240). The
response piggybacks the cluster address map (server_id -> host:port) which
feeds the consensus transport resolver, plus the tserver universe view used
by clients.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

from yugabyte_tpu_torch.rpc.messenger import (
    Messenger, RemoteError, RpcTimeout, ServiceUnavailable)
from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils import ybsan
from yugabyte_tpu_torch.utils.backoff import RetrySchedule
from yugabyte_tpu_torch.utils.trace import TRACE

flags.define_flag("heartbeat_interval_ms", 200,
                  "tserver -> master heartbeat period "
                  "(ref heartbeat_interval_ms, 1000 in the reference; lower "
                  "here because MiniCluster tests drive failover timing)")

MASTER_SERVICE = "master"


@ybsan.shadow(_leader_addr=ybsan.SINGLE_WRITER)
class Heartbeater:
    def __init__(self, messenger: Messenger, master_addrs: List[str],
                 server_id: str, server_addr: str,
                 report_provider: Callable[[], List[dict]],
                 on_response: Callable[[dict], None]):
        self._messenger = messenger
        self._master_addrs = list(master_addrs)
        self._leader_addr: Optional[str] = None
        self.server_id = server_id
        self.server_addr = server_addr
        self._report_provider = report_provider
        self._on_response = on_response
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"heartbeater-{self.server_id}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def heartbeat_now(self) -> bool:
        """One synchronous heartbeat attempt across known masters; returns
        True when a master leader accepted it."""
        addrs = ([self._leader_addr] if self._leader_addr else []) + [
            a for a in self._master_addrs if a != self._leader_addr]
        for addr in addrs:
            try:
                resp = self._messenger.call(
                    addr, MASTER_SERVICE, "heartbeat",
                    timeout_s=flags.get_flag("heartbeat_interval_ms") / 250.0,
                    server_id=self.server_id, server_addr=self.server_addr,
                    tablet_report=self._report_provider())
            except (RpcTimeout, ServiceUnavailable):
                continue
            except RemoteError as e:
                if e.extra.get("not_leader"):
                    # Follower master: try its hint next (ref heartbeater
                    # master-leader re-resolution).
                    hint = e.extra.get("leader_hint")
                    if hint and hint not in addrs:
                        addrs.append(hint)
                    continue
                raise
            self._leader_addr = addr
            self._on_response(resp)
            return True
        self._leader_addr = None
        return False

    def _loop(self) -> None:
        # While no master leader answers, the retry spacing grows with
        # capped exponential backoff + jitter instead of every tserver
        # hammering the dead master in lockstep at the heartbeat interval
        # (ref heartbeater.cc consecutive_failed_heartbeats_ backoff).
        interval_s = lambda: flags.get_flag("heartbeat_interval_ms") / 1000.0
        retry = RetrySchedule(initial_s=interval_s(), max_s=2.0)
        wait_s = interval_s()
        while not self._stop.wait(wait_s):
            try:
                ok = self.heartbeat_now()
            except Exception as e:  # noqa: BLE001 — keep beating
                TRACE("heartbeater %s: %r", self.server_id, e)
                ok = False
            if ok:
                retry = RetrySchedule(initial_s=interval_s(), max_s=2.0)
                wait_s = interval_s()
            else:
                wait_s = retry.record_failure()
