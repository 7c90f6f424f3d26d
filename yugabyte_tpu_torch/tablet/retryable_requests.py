"""Exactly-once writes: the per-tablet retryable-request registry.

Counterpart of yugabyte_tpu/tablet/retryable_requests.py, with the imports renamed.

Capability parity with the reference (ref: src/yb/consensus/
retryable_requests.cc): every client write carries (client_id,
request_id); the pair rides the REPLICATED write-batch payload, so every
replica rebuilds the registry as entries apply — dedup state survives
leader changes and restarts (WAL replay repopulates it). A retry of a
write whose first attempt already replicated returns the original result
instead of applying twice; a retry racing its own in-flight first attempt
is pushed back to the client's retry loop until the fate settles.

Entries expire after retryable_request_timeout_s (ref
retryable_request_timeout_secs): a client that retries longer than that
has long since exhausted its RPC budget.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from yugabyte_tpu_torch.utils import flags

flags.define_flag("retryable_request_timeout_s", 660,
                  "replicated write dedup records are kept this long "
                  "(ref retryable_request_timeout_secs)")
flags.define_flag("retryable_request_inflight_timeout_s", 120,
                  "an appended-but-never-applied request tag (its log entry "
                  "was overwritten without the abort watcher firing) stops "
                  "blocking retries after this long")

RequestId = Tuple[bytes, int]  # (client uuid bytes, per-client counter)


class RetryableRequests:
    def __init__(self):
        self._lock = threading.Lock()
        # replicated: request -> (result ht value, wall time recorded)
        self._replicated: Dict[RequestId, Tuple[int, float]] = {}
        self._in_flight: Dict[RequestId, float] = {}   # -> tracked-at time
        self._last_gc = 0.0

    def check_or_track(self, client_id: bytes, request_id: int
                       ) -> Tuple[str, Optional[int]]:
        """-> ("duplicate", ht) | ("in_flight", None) | ("new", None).
        "new" registers the request as in-flight."""
        req = (client_id, request_id)
        now = time.monotonic()
        with self._lock:
            self._maybe_gc(now)
            hit = self._replicated.get(req)
            if hit is not None:
                return "duplicate", hit[0]
            t = self._in_flight.get(req)
            if t is not None:
                if (now - t < flags.get_flag(
                        "retryable_request_inflight_timeout_s")):
                    return "in_flight", None
                # expired in-flight (orphaned tag): treat as new
            self._in_flight[req] = now
            return "new", None

    def track_appended(self, client_id: bytes, request_id: int) -> None:
        """Log-append hook on EVERY replica: a stored-but-unapplied entry's
        request is in-flight, so a retry arriving at a freshly elected
        leader before applies catch up is pushed back, not re-executed."""
        req = (client_id, request_id)
        with self._lock:
            if req not in self._replicated:
                self._in_flight.setdefault(req, time.monotonic())

    def replicated(self, client_id: bytes, request_id: int,
                   ht_value: int) -> None:
        """Called on EVERY replica as the write batch applies (and during
        WAL replay) — this is what makes dedup survive failover."""
        req = (client_id, request_id)
        with self._lock:
            self._replicated[req] = (ht_value, time.monotonic())
            self._in_flight.pop(req, None)

    def failed(self, client_id: bytes, request_id: int) -> None:
        """The attempt definitively did NOT replicate (rejected before
        append, or the fate watcher saw the entry overwritten)."""
        with self._lock:
            self._in_flight.pop((client_id, request_id), None)

    def inherit_from(self, parent: "RetryableRequests") -> None:
        """Tablet split: both children adopt the parent's records so dedup
        survives the split (the reference copies the retryable-requests
        structure into the children the same way)."""
        with parent._lock:
            replicated = dict(parent._replicated)
            in_flight = dict(parent._in_flight)
        with self._lock:
            self._replicated.update(replicated)
            for req, t in in_flight.items():
                self._in_flight.setdefault(req, t)

    def _maybe_gc(self, now: float) -> None:
        if now - self._last_gc < 10.0:
            return
        self._last_gc = now
        ttl = flags.get_flag("retryable_request_timeout_s")
        dead = [r for r, (_ht, t) in self._replicated.items()
                if now - t > ttl]
        for r in dead:
            del self._replicated[r]
        # orphaned in-flight tags (overwritten follower entries, clients
        # that never retried) must not accumulate forever
        in_ttl = flags.get_flag("retryable_request_inflight_timeout_s")
        stale = [r for r, t in self._in_flight.items() if now - t > in_ttl]
        for r in stale:
            del self._in_flight[r]

    def __len__(self) -> int:
        with self._lock:
            return len(self._replicated)
