"""Bucket health board: one live health record per (kernel family,
shape bucket), replacing the frozen calibration file.

Counterpart of yugabyte_tpu/storage/bucket_health.py, whole: the same
states, flags (names and defaults), gates, probe rationing, counters and
save/load JSON, so a board saved by either package loads in the other.
The families the port records: run_merge_fused (the single-device
compaction job, bucket (k_pad, m)), block_decode / block_encode (the
codec, (1, n_pad)), point_read_locate ((1, n_pad)), scan_filtered /
scan_agg (the pushdown, (1, n_pad)) and dist_compact ((n_shards,
capacity)).

Five mechanisms used to each hold a fragment of device-vs-native truth:
the static calibration-file loader, `BucketQuarantine` (fault
containment's memory), the compaction pool's per-bucket EWMA demotion,
the codec/pushdown/point-read fallback counters, and the drift-gated
kernel manifest. RESYSTANCE's lesson is that compaction wins come from
measuring where time actually goes and steering on it, and LUDA's is
that offload only pays when the policy knows per-shape amortization —
both argue for ONE live record per (kernel, bucket), not a calibration
snapshot that goes stale the moment the fleet changes.

The board keys records by the kernel manifest's declared
(kernel_family, bucket) vocabulary and runs a per-key state machine:

    COLD -> WARMING -> HEALTHY <-> DEGRADED -> QUARANTINED
                          ^                        |
                          +------ PROBATION <------+  (timed decay)

  COLD        never dispatched; routes native at policy sites until
              prewarmed or first observed (compile cost not yet
              amortized), and feeds AOT prewarm priority.
  WARMING     device observations accumulating; after `warmup_obs`
              results the rates decide HEALTHY vs DEGRADED.
  HEALTHY     device wins on measured rows/s EWMA; route device.
  DEGRADED    device measured slower than native; route native except
              for sampled re-promotion probes (bounded: one in flight,
              exponential backoff while probes keep losing, never two
              consecutive probes without a native gap).
  QUARANTINED a device fault parked the bucket (timed decay window in
              the embedded BucketQuarantine registry) or a shadow/
              digest mismatch marked it sticky (operator clear only).
  PROBATION   the quarantine window decayed; the next jobs re-prove
              the bucket on device, `probation_obs` clean results
              re-promote to HEALTHY, any fault re-quarantines.

Two gates, matching how dispatch sites differ:

  use_device()   policy sites (inline/pool/dist compaction) — COLD
                 routes native; forced `device_offload_mode` honored.
  allow_device() containment sites (point read, pushdown, codec, and
                 the device-native entry inside a job) — COLD/WARMING
                 pass (those kernels are the job), only QUARANTINED /
                 sticky-mismatch / DEGRADED-without-a-probe-slot block.

Byte identity is the existing fallback machinery's job — the board only
STEERS; every native completion it forces goes through the same
verified host paths the fault containment already uses.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from yugabyte_tpu_torch.storage import offload_policy as _policy
from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils import ybsan
from yugabyte_tpu_torch.utils.trace import TRACE

flags.define_flag("bucket_health_ewma_alpha", 0.3,
                  "EWMA smoothing for per-bucket device/native rows-per-"
                  "second rates (higher = faster reaction, noisier)")
flags.define_flag("bucket_health_warmup_obs", 3,
                  "device observations before a WARMING bucket is judged "
                  "HEALTHY/DEGRADED and before a rate crossover may "
                  "demote (one cold-compile sample must not demote)")
flags.define_flag("bucket_health_probe_interval_s", 30.0,
                  "base spacing between sampled device probes on a "
                  "DEGRADED bucket (doubles per losing probe up to "
                  "bucket_health_probe_backoff_max)")
flags.define_flag("bucket_health_probe_backoff_max", 8,
                  "cap on the probe-interval backoff multiplier for a "
                  "bucket whose probes keep losing")
flags.define_flag("bucket_health_probation_obs", 2,
                  "clean device results a PROBATION bucket needs before "
                  "re-promotion to HEALTHY")
flags.define_flag("bucket_health_path", "",
                  "where the board persists its compact JSON across "
                  "restarts; empty = <fs_root>/bucket_health.json when "
                  "running under a tablet server, no persistence "
                  "otherwise")

COLD = "cold"
WARMING = "warming"
HEALTHY = "healthy"
DEGRADED = "degraded"
QUARANTINED = "quarantined"
PROBATION = "probation"

STATES = (COLD, WARMING, HEALTHY, DEGRADED, QUARANTINED, PROBATION)

# a probe whose job died without ever reporting a device result or a
# fault must not wedge the bucket native forever
_PROBE_TIMEOUT_S = 600.0
_PROBE_HISTORY = 16
_TRANSITION_LOG = 64


def _health_counter(what: str):
    from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
    helps = {
        "promotions": "buckets re-promoted to HEALTHY (probe won or "
                      "probation passed)",
        "demotions": "buckets demoted to DEGRADED on a measured rate "
                     "crossover",
        "quarantines": "buckets parked QUARANTINED after a device fault "
                       "or shadow mismatch",
        "probes": "sampled device probes launched on DEGRADED buckets",
        "probe_failures": "probes that lost to the native rate or "
                          "faulted",
        "mismatch": "sticky shadow/digest-mismatch marks (operator "
                    "clear only)",
    }
    return ROOT_REGISTRY.entity("server", "bucket_health").counter(
        f"bucket_health_{what}_total", helps[what])


def board_native_counter():
    """Work the board's gate sent native: allow_device() refused it (a
    QUARANTINED or sticky-mismatch bucket, or a DEGRADED one with no
    probe slot). The port's own counter (the JAX board counts these
    nowhere), in an entity of its own so the counters both packages
    share keep equal names."""
    from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
    return ROOT_REGISTRY.entity("server", "board_routing").counter(
        "board_routed_native_total",
        "device work the health board's gate routed native (parked "
        "bucket, or degraded with no probe slot)")


@ybsan.shadow(probe_pending=ybsan.PUBLISHER_CONSUMER,
              probe_started=ybsan.PUBLISHER_CONSUMER,
              probe_tid=ybsan.PUBLISHER_CONSUMER)
class _Rec:
    """One (family, bucket) health record. guarded-by: board._lock

    The probe-claim triple (shadowed above) carries an extra protocol
    on top of the lock: the board publishes a claim in `_probe_gate`
    and the claiming thread is the only one allowed to pass the gate
    until the claim clears — every consumer of the triple must be
    HB-after the publishing write (they are — all sites hold the
    board's tracked lock, which is exactly what the shadow verifies)."""

    __slots__ = ("state", "device_rate", "native_rate", "device_obs",
                 "native_obs", "faults", "traffic", "prewarmed",
                 "mismatch", "mismatch_reason", "quar_mark",
                 "probe_pending", "probe_started", "probe_tid",
                 "last_probe_t", "probe_backoff", "needs_native_gap",
                 "probation_ok", "probes", "since", "last_change_wall")

    def __init__(self, now: float):
        self.state = COLD
        self.device_rate = 0.0
        self.native_rate = 0.0
        self.device_obs = 0
        self.native_obs = 0
        self.faults = 0
        self.traffic = 0
        self.prewarmed = False
        self.mismatch = False
        self.mismatch_reason = ""
        # the quarantine registry said "open window" the last time we
        # looked; when the window decays the bucket goes PROBATION
        self.quar_mark = False
        self.probe_pending = False
        self.probe_started = 0.0
        self.probe_tid = 0
        self.last_probe_t = 0.0
        self.probe_backoff = 1
        self.needs_native_gap = False
        self.probation_ok = 0
        self.probes: collections.deque = collections.deque(
            maxlen=_PROBE_HISTORY)
        # `since` runs on the board clock (monotonic; durations);
        # `last_change_wall` is the wall-clock transition timestamp the
        # /healthz page shows (comparable across processes)
        self.since = now
        self.last_change_wall = time.time()


class _BoardQuarantine(_policy.BucketQuarantine):
    """The board's embedded fault registry. `clear()` resets the WHOLE
    board: every legacy test/fixture that calls
    `bucket_quarantine().clear()` to isolate itself now gets a clean
    health slate too, not a board still demoted from the last test."""

    def __init__(self, board: "BucketHealthBoard"):
        super().__init__()
        self._board = board

    def clear(self) -> None:
        self._board.reset()


class BucketHealthBoard:
    """Process-wide per-(kernel family, bucket) health state machine."""

    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._recs: Dict[Tuple[str, Tuple[int, ...]], _Rec] = {}
        self._transitions: collections.deque = collections.deque(
            maxlen=_TRANSITION_LOG)
        self._tally = {k: 0 for k in ("promotions", "demotions",
                                      "quarantines", "probes",
                                      "probe_failures", "mismatch")}
        # lock order: board._lock and the registry's quarantine lock are
        # NEVER nested — every registry call happens outside board._lock
        self._registry = _BoardQuarantine(self)

    # -- plumbing ----------------------------------------------------

    def quarantine_registry(self) -> _policy.BucketQuarantine:
        return self._registry

    def _rec(self, key) -> _Rec:
        r = self._recs.get(key)
        if r is None:
            r = _Rec(self._clock())
            self._recs[key] = r
        return r

    @staticmethod
    def _key(family: str, bucket) -> Tuple[str, Tuple[int, ...]]:
        return (str(family), tuple(int(b) for b in bucket))

    def _transition(self, key, r: _Rec, to: str, why: str,
                    events: List[str]) -> None:
        """guarded-by: _lock. Collects counter events for post-lock
        firing (metric increments take the registry lock)."""
        frm = r.state
        if frm == to:
            return
        r.state = to
        r.since = self._clock()
        r.last_change_wall = time.time()
        self._transitions.append({
            "t": time.time(), "family": key[0], "bucket": list(key[1]),
            "from": frm, "to": to, "why": why})
        if to == DEGRADED:
            # first probe waits a full interval — demotion itself is
            # the signal, not an instant re-probe
            r.last_probe_t = self._clock()
            r.probation_ok = 0
            if frm in (HEALTHY, WARMING):
                events.append("demotions")
        elif to == QUARANTINED:
            events.append("quarantines")
        elif to == HEALTHY and frm in (DEGRADED, PROBATION):
            events.append("promotions")
        elif to == PROBATION:
            r.probation_ok = 0

    def _fire(self, events: List[str]) -> None:
        for ev in events:
            _health_counter(ev).increment()
            with self._lock:
                self._tally[ev] += 1

    # -- gates -------------------------------------------------------

    def use_device(self, family: str, bucket, est_rows: int = 0,
                   cached: bool = False, probe: bool = True) -> bool:
        """Policy-site gate (inline/pool/dist compaction): COLD routes
        native until prewarmed/observed; forced modes honored; otherwise
        defers to allow_device().

        probe=False is for DECISION-ONLY sites that hand the job to a
        different thread (the mesh pool submitter): a DEGRADED bucket
        answers True without claiming the probe slot — the slot is
        claimed by the thread that actually dispatches, at its own
        allow_device() call, so a probe never wedges on a thread that
        will never record the result."""
        c = _policy._offload_counters()
        mode = flags.get_flag("device_offload_mode")
        if mode == "device":
            c["forced"].increment()
            c["device"].increment()
            return True
        if mode == "native":
            c["forced"].increment()
            c["native"].increment()
            return False
        key = self._key(family, bucket)
        with self._lock:
            r = self._rec(key)
            r.traffic += 1
            cold = r.state == COLD
        if cold:
            # compile cost not amortized yet: stay native, let the
            # prewarm op (fed by prewarm_priorities) pay the compile
            c["cold"].increment()
            c["native"].increment()
            return False
        ok = self.allow_device(family, bucket, _claim_probe=probe)
        c["measured"].increment()
        c["device" if ok else "native"].increment()
        return ok

    def allow_device(self, family: str, bucket,
                     _claim_probe: bool = True) -> bool:
        """Containment-site gate: blocks QUARANTINED / sticky-mismatch
        buckets and rations DEGRADED buckets to sampled probes; COLD and
        WARMING pass (the dispatch IS the measurement). Every refusal
        sends its work native and is counted (board_native_counter)."""
        ok = self._allow_device(family, bucket, _claim_probe)
        if not ok:
            board_native_counter().increment()
        return ok

    def _allow_device(self, family: str, bucket,
                      _claim_probe: bool) -> bool:
        key = self._key(family, bucket)
        # registry check OUTSIDE the board lock (lock-order discipline)
        qopen = self._registry.open_window(key[1])
        now = self._clock()
        events: List[str] = []
        try:
            with self._lock:
                r = self._rec(key)
                if r.mismatch:
                    return False
                if qopen:
                    if r.state != QUARANTINED:
                        self._transition(key, r, QUARANTINED,
                                         "quarantine window open", events)
                    r.quar_mark = True
                    return False
                if r.quar_mark:
                    # the timed window decayed since we last looked:
                    # this job re-proves the bucket (legacy decay
                    # semantics, now with a counted probation)
                    r.quar_mark = False
                    self._transition(key, r, PROBATION,
                                     "quarantine decayed", events)
                    return True
                if r.state == DEGRADED:
                    if not _claim_probe:
                        # decision-only caller: pass the job through to
                        # the executing thread, whose allow_device()
                        # rations the probe slot itself
                        return True
                    return self._probe_gate(key, r, now, events)
                return True
        finally:
            self._fire(events)

    def _probe_gate(self, key, r: _Rec, now: float,
                    events: List[str]) -> bool:
        """guarded-by: _lock. One probe in flight; the claiming thread
        (the probing job re-checks at its containment site) passes."""
        if r.probe_pending:
            if now - r.probe_started <= _PROBE_TIMEOUT_S:
                return threading.get_ident() == r.probe_tid
            r.probe_pending = False  # probe job died silently
        if r.needs_native_gap:
            # never two consecutive device probes on a failing bucket
            r.needs_native_gap = False
            return False
        interval = float(flags.get_flag("bucket_health_probe_interval_s"))
        if now - r.last_probe_t < interval * r.probe_backoff:
            return False
        r.probe_pending = True
        r.probe_started = now
        r.probe_tid = threading.get_ident()
        r.last_probe_t = now
        r.probes.append({"t": time.time(), "outcome": "launched"})
        events.append("probes")
        return True

    # -- observations ------------------------------------------------

    def record_device(self, family: str, bucket, rows: int,
                      seconds: float) -> None:
        """A device dispatch completed: fold the measured rate in and
        run the promotion/demotion edges."""
        key = self._key(family, bucket)
        alpha = float(flags.get_flag("bucket_health_ewma_alpha"))
        warmup = int(flags.get_flag("bucket_health_warmup_obs"))
        rate = (rows / seconds) if seconds > 0 and rows > 0 else 0.0
        events: List[str] = []
        with self._lock:
            r = self._rec(key)
            if rate > 0:
                r.device_rate = rate if r.device_obs == 0 else \
                    (1 - alpha) * r.device_rate + alpha * rate
                r.device_obs += 1
            was_probe = r.probe_pending \
                and threading.get_ident() == r.probe_tid
            if was_probe:
                r.probe_pending = False
            if r.state == COLD:
                self._transition(key, r, WARMING, "first device result",
                                 events)
            slower = (r.native_rate > 0 and r.device_rate > 0
                      and r.device_rate < r.native_rate)
            if r.state == DEGRADED:
                if slower:
                    if was_probe and r.probes:
                        r.probes[-1]["outcome"] = "slow"
                        r.probe_backoff = min(
                            r.probe_backoff * 2,
                            int(flags.get_flag(
                                "bucket_health_probe_backoff_max")))
                        r.needs_native_gap = True
                        events.append("probe_failures")
                else:
                    if was_probe and r.probes:
                        r.probes[-1]["outcome"] = "won"
                    r.probe_backoff = 1
                    r.needs_native_gap = False
                    self._transition(key, r, HEALTHY,
                                     "probe won the rate race", events)
            elif r.state == WARMING:
                if r.device_obs >= warmup:
                    if slower:
                        self._transition(key, r, DEGRADED,
                                         "device EWMA below native "
                                         "after warmup", events)
                    else:
                        self._transition(key, r, HEALTHY,
                                         "warmup complete", events)
            elif r.state == HEALTHY:
                if slower and r.device_obs >= warmup:
                    self._transition(key, r, DEGRADED,
                                     "device EWMA fell below native",
                                     events)
            elif r.state == PROBATION:
                r.probation_ok += 1
                if r.probation_ok >= int(flags.get_flag(
                        "bucket_health_probation_obs")):
                    self._transition(key, r, HEALTHY,
                                     "probation passed", events)
        self._fire(events)

    def record_native(self, family: str, bucket, rows: int,
                      seconds: float) -> None:
        key = self._key(family, bucket)
        alpha = float(flags.get_flag("bucket_health_ewma_alpha"))
        warmup = int(flags.get_flag("bucket_health_warmup_obs"))
        rate = (rows / seconds) if seconds > 0 and rows > 0 else 0.0
        if rate <= 0:
            return
        events: List[str] = []
        with self._lock:
            r = self._rec(key)
            r.native_rate = rate if r.native_obs == 0 else \
                (1 - alpha) * r.native_rate + alpha * rate
            r.native_obs += 1
            if r.state == HEALTHY and r.device_obs >= warmup \
                    and r.device_rate > 0 \
                    and r.device_rate < r.native_rate:
                self._transition(key, r, DEGRADED,
                                 "native EWMA overtook device", events)
        self._fire(events)

    def record_fault(self, family: str, bucket, reason: str,
                     ttl_s: Optional[float] = None) -> None:
        """A device fault in this bucket's kernel path: park it in the
        timed registry (legacy counters preserved) and QUARANTINE."""
        key = self._key(family, bucket)
        # registry call outside the board lock (lock-order discipline)
        self._registry.quarantine(key[1], reason, ttl_s=ttl_s)
        events: List[str] = []
        with self._lock:
            r = self._rec(key)
            r.faults += 1
            r.quar_mark = True
            if r.probe_pending:
                r.probe_pending = False
                if r.probes:
                    r.probes[-1]["outcome"] = "fault"
                r.probe_backoff = min(
                    r.probe_backoff * 2,
                    int(flags.get_flag("bucket_health_probe_backoff_max")))
                r.needs_native_gap = True
                events.append("probe_failures")
            self._transition(key, r, QUARANTINED, reason, events)
        self._fire(events)

    def record_mismatch(self, family: str, bucket, reason: str) -> None:
        """Shadow/digest mismatch: STICKY — wrong bytes are worse than
        any slowness, so only an operator clear re-opens the bucket."""
        key = self._key(family, bucket)
        self._registry.quarantine(key[1], reason)
        events: List[str] = ["mismatch"]
        with self._lock:
            r = self._rec(key)
            r.mismatch = True
            r.mismatch_reason = reason
            r.faults += 1
            self._transition(key, r, QUARANTINED, reason, events)
        self._fire(events)

    def clear_mismatch(self, family: Optional[str] = None,
                       bucket=None) -> int:
        """Operator clear of sticky mismatch marks (all, or one key);
        cleared buckets go PROBATION and must re-prove on device."""
        events: List[str] = []
        n = 0
        want = None if family is None else self._key(family, bucket)
        with self._lock:
            for key, r in self._recs.items():
                if not r.mismatch or (want is not None and key != want):
                    continue
                r.mismatch = False
                r.mismatch_reason = ""
                r.quar_mark = False
                self._transition(key, r, PROBATION, "operator mismatch "
                                 "clear", events)
                n += 1
        self._fire(events)
        return n

    def record_prewarmed(self, family: str, bucket) -> None:
        """A prewarm ran this bucket's kernels: the compile cost is
        paid, COLD no longer needs to route native."""
        events: List[str] = []
        with self._lock:
            r = self._rec(self._key(family, bucket))
            r.prewarmed = True
            if r.state == COLD:
                self._transition(self._key(family, bucket), r, WARMING,
                                 "prewarmed", events)
        self._fire(events)

    def prewarm_priorities(self) -> List[Tuple[str, Tuple[int, ...]]]:
        """COLD keys by observed traffic, highest first — the AOT
        prewarm order (warm what the workload actually asks for)."""
        with self._lock:
            cold = [(key, r.traffic) for key, r in self._recs.items()
                    if r.state == COLD]
        cold.sort(key=lambda kt: (-kt[1], kt[0]))
        return [k for k, _ in cold]

    def state(self, family: str, bucket) -> str:
        """Current state, quarantine decay folded in (read-only probe
        for tests/bench — does not claim a probe slot)."""
        key = self._key(family, bucket)
        qopen = self._registry.open_window(key[1])
        events: List[str] = []
        with self._lock:
            r = self._recs.get(key)
            if r is None:
                return COLD
            if r.mismatch:
                return QUARANTINED
            if qopen:
                if r.state != QUARANTINED:
                    self._transition(key, r, QUARANTINED,
                                     "quarantine window open", events)
                r.quar_mark = True
            elif r.quar_mark:
                r.quar_mark = False
                self._transition(key, r, PROBATION, "quarantine decayed",
                                 events)
            out = r.state
        self._fire(events)
        return out

    # -- observability / persistence ---------------------------------

    def snapshot(self) -> dict:
        """The /healthz block: per-key state+rates+probe history, a
        state histogram, the open quarantine windows, the transition
        log, and the lifetime transition tally."""
        quar = self._registry.snapshot()  # outside the board lock
        now = self._clock()
        with self._lock:
            keys = []
            hist = {s: 0 for s in STATES}
            for key, r in sorted(self._recs.items()):
                hist[r.state] += 1
                rec = {"family": key[0], "bucket": list(key[1]),
                       "state": r.state,
                       "time_in_state_s": round(max(0.0, now - r.since),
                                                3),
                       "last_transition_at": r.last_change_wall,
                       "device_rows_per_sec": round(r.device_rate, 1),
                       "native_rows_per_sec": round(r.native_rate, 1),
                       "device_obs": r.device_obs,
                       "native_obs": r.native_obs,
                       "faults": r.faults, "traffic": r.traffic,
                       "prewarmed": r.prewarmed}
                if r.mismatch:
                    rec["mismatch"] = r.mismatch_reason
                if r.probes:
                    rec["probes"] = list(r.probes)
                    rec["probe_backoff"] = r.probe_backoff
                keys.append(rec)
            return {"keys": keys, "states": hist, "quarantine": quar,
                    "transitions": list(self._transitions),
                    "counters": dict(self._tally)}

    def save(self, path: Optional[str] = None) -> None:
        """Persist the DURABLE facts: quarantine windows (remaining
        TTL), sticky mismatches, fault/traffic tallies. Rates are NOT
        saved — a restarted process must re-measure, not route on the
        previous run's numbers."""
        path = path or flags.get_flag("bucket_health_path")
        if not path:
            return
        quar = {tuple(e["bucket"]): e for e in self._registry.snapshot()}
        with self._lock:
            recs = [(key, r.state, r.faults, r.traffic, r.mismatch,
                     r.mismatch_reason)
                    for key, r in sorted(self._recs.items())]
        out = {"version": 1, "saved_at": time.time(), "keys": []}
        for key, state, faults, traffic, mismatch, mreason in recs:
            e = quar.get(key[1])
            out["keys"].append({
                "family": key[0], "bucket": list(key[1]),
                "state": state, "faults": faults, "traffic": traffic,
                "mismatch": mismatch, "mismatch_reason": mreason,
                "quarantine_remaining_s":
                    e["remaining_s"] if e else None,
                "quarantine_reason": e["reason"] if e else ""})
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(out, f, indent=1, sort_keys=True)
            os.replace(tmp, path)
        except OSError as e:
            TRACE("bucket_health: save to %s failed: %s", path, e)

    def load(self, path: Optional[str] = None) -> int:
        """Rehydrate durable facts from save(): QUARANTINED windows
        resume their remaining decay, sticky mismatches stay sticky,
        every other observed key restarts WARMING with rates cleared
        (stale rates must not pin routing). Returns keys loaded."""
        path = path or flags.get_flag("bucket_health_path")
        if not path:
            return 0
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, ValueError) as e:  # yblint: contained(no/corrupt board file means a fresh board — the cold-start default, not a durability loss)
            TRACE("bucket_health: no board state at %s (%s)", path, e)
            return 0
        n = 0
        for entry in data.get("keys", ()):
            try:
                key = self._key(entry["family"], entry["bucket"])
                faults = int(entry.get("faults", 0))
                traffic = int(entry.get("traffic", 0))
                mismatch = bool(entry.get("mismatch"))
                mreason = str(entry.get("mismatch_reason", ""))
                rem = entry.get("quarantine_remaining_s")
                qreason = str(entry.get("quarantine_reason", ""))
                state = str(entry.get("state", COLD))
            except (KeyError, TypeError, ValueError):  # yblint: contained(one malformed record is skipped; the rest of the board still loads)
                continue
            if rem is not None and float(rem) > 0 and not mismatch:
                # restore() re-opens the window WITHOUT bumping the
                # legacy added-counter — a restart is not a new fault
                self._registry.restore(key[1], qreason or "restored",
                                       faults, float(rem))
            with self._lock:
                r = self._rec(key)
                r.faults = faults
                r.traffic = traffic
                if mismatch:
                    r.mismatch = True
                    r.mismatch_reason = mreason
                    r.state = QUARANTINED
                elif rem is not None and float(rem) > 0:
                    r.quar_mark = True
                    r.state = QUARANTINED
                elif state != COLD:
                    r.state = WARMING  # observed before; re-measure
            n += 1
        return n

    def reset(self) -> None:
        """Full wipe (test isolation / operator reset): records,
        transition log, tally AND the embedded quarantine registry."""
        with self._lock:
            self._recs.clear()
            self._transitions.clear()
            for k in self._tally:
                self._tally[k] = 0
        # bypass _BoardQuarantine.clear (it calls back into reset)
        _policy.BucketQuarantine.clear(self._registry)


_board: Optional[BucketHealthBoard] = None  # guarded-by: _board_lock
_board_lock = threading.Lock()


def health_board() -> BucketHealthBoard:
    """Process-wide board (one per process, like the slab cache — a
    bucket demoted under one tablet is demoted for all)."""
    global _board
    with _board_lock:
        if _board is None:
            _board = BucketHealthBoard()
        return _board
