"""Offload vocabulary + fault quarantine for device-vs-native routing.

Counterpart of yugabyte_tpu/storage/offload_policy.py, whole: routing
decisions come from the live per-(kernel family, bucket) health state
machine in storage/bucket_health.py (`BucketHealthBoard.use_device()` /
`allow_device()`), fed by measured rates, fault events and shadow
mismatches on the running process. What stays here is the shared
vocabulary and the fault registry:

  - the (k_pad, m) bucket-key helpers every dispatch site and the
    kernel manifest agree on (the port's run-major layout is the JAX
    package's, so the keys are equal);
  - the declared compile surface, read from the committed manifest
    (tools/analysis/kernel_manifest.json) as data — nothing of tools/
    is imported;
  - `BucketQuarantine`, the timed native-only fault registry embedded in
    the board as its QUARANTINED state's memory, with its
    `offload_quarantine_*` counters;
  - the routing-decision counters.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional, Tuple

from yugabyte_tpu_torch.utils import flags

flags.define_flag("device_offload_mode", "auto",
                  "auto = measured bucket-health routing; device/native "
                  "= force")
flags.define_flag("device_fault_quarantine_s", 300.0,
                  "how long a shape bucket stays native-only after a "
                  "device fault in its kernel path (timed decay; the "
                  "next job after expiry re-proves the bucket)")


def _offload_counters():
    """Decision counters: WHICH way each compaction routed, and WHY —
    the visibility LUDA-style offload systems attribute their wins with
    (offloaded vs CPU-fallback, forced/cold/measured)."""
    from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
    e = ROOT_REGISTRY.entity("server", "offload_policy")
    return {
        "device": e.counter("offload_decisions_device_total",
                            "compactions routed to the device kernel"),
        "native": e.counter("offload_decisions_native_total",
                            "compactions routed to the native CPU path"),
        "forced": e.counter("offload_decisions_forced_total",
                            "decisions forced by device_offload_mode"),
        "cold": e.counter(
            "offload_decisions_cold_total",
            "native routings taken because the bucket is COLD (compile "
            "cost not yet amortized; prewarm pays it)"),
        "measured": e.counter(
            "offload_decisions_measured_total",
            "decisions made from live bucket-health measurements"),
    }


# ---------------------------------------------------------------------------
# Shape-bucket quarantine: device-fault containment's memory. When the
# kernel path of a compaction fails (kernel load error, HBM OOM, runtime
# launch fault) the job completes via the native fallback — and the
# failing SHAPE BUCKET is parked native-only for a decay window, so every
# subsequent job that would compile/launch the same poisoned executable
# routes straight to native instead of re-failing (the RESYSTANCE lesson
# applied to faults: observe where the device path breaks and steer work
# around it). The bucket key is the padded run layout (k_pad, m) — the
# dominant part of the fused program's compile key.

class BucketQuarantine:
    """Timed native-only quarantine of kernel shape buckets."""

    def __init__(self):
        self._lock = threading.Lock()
        # bucket -> {"until": monotonic, "reason": str, "faults": int,
        #            "since": wall}  # guarded-by: _lock
        self._entries: dict = {}

    def quarantine(self, bucket: Tuple[int, ...], reason: str,
                   ttl_s: Optional[float] = None) -> None:
        surface = declared_surface_keys()
        if surface and tuple(bucket) not in surface:
            # a fault on a shape the manifest never declared: the
            # compile-surface lattice leaked before the device did
            from yugabyte_tpu_torch.utils.trace import TRACE
            TRACE("offload_policy: quarantining bucket k_pad=%s m=%s "
                  "OUTSIDE the declared compile surface (%d keys) — "
                  "regenerate/review tools/analysis/kernel_manifest.json",
                  bucket[0], bucket[1], len(surface))
        ttl = ttl_s if ttl_s is not None else \
            flags.get_flag("device_fault_quarantine_s")
        with self._lock:
            e = self._entries.get(bucket)
            self._entries[bucket] = {
                "until": time.monotonic() + ttl,
                "reason": reason,
                "faults": (e["faults"] + 1) if e else 1,
                "since": time.time(),
            }
        _quarantine_counter("added").increment()

    def is_quarantined(self, bucket: Tuple[int, ...]) -> bool:
        """True while the bucket's window is open; expired entries decay
        (are dropped) on the first check past their deadline."""
        decayed, hit = self._check_window(bucket)
        if decayed:
            _quarantine_counter("decayed").increment()
        elif hit:
            _quarantine_counter("hits").increment()
        return hit

    def open_window(self, bucket: Tuple[int, ...]) -> bool:
        """is_quarantined WITHOUT the legacy hits counter — the health
        board attributes routing decisions itself (the decayed counter
        still fires; a decay is a registry event either way)."""
        decayed, hit = self._check_window(bucket)
        if decayed:
            _quarantine_counter("decayed").increment()
        return hit

    def _check_window(self, bucket) -> Tuple[bool, bool]:
        """(decayed, open). The clock is read INSIDE the lock: reading
        it outside let a concurrent quarantine() land between the stale
        `now` and the decay compare, deleting a window that had just
        been re-armed (the PR 16 timed-decay race)."""
        with self._lock:
            now = time.monotonic()
            e = self._entries.get(bucket)
            if e is None:
                return False, False
            if now >= e["until"]:
                del self._entries[bucket]   # timed decay: re-prove it
                return True, False
            return False, True

    def restore(self, bucket: Tuple[int, ...], reason: str, faults: int,
                remaining_s: float) -> None:
        """Re-open a window from persisted board state WITHOUT bumping
        the added-counter — a process restart is not a new fault."""
        with self._lock:
            self._entries[tuple(bucket)] = {
                "until": time.monotonic() + max(0.0, remaining_s),
                "reason": reason,
                "faults": max(1, int(faults)),
                "since": time.time(),
            }

    def snapshot(self) -> List[dict]:
        """Open quarantine windows for /compactionz (expired entries are
        pruned here too, so the page never shows a decayed bucket)."""
        now = time.monotonic()
        with self._lock:
            for b in [b for b, e in self._entries.items()
                      if now >= e["until"]]:
                del self._entries[b]
            return [{"bucket": list(b), "reason": e["reason"],
                     "faults": e["faults"],
                     "remaining_s": round(e["until"] - now, 1),
                     "since": e["since"]}
                    for b, e in sorted(self._entries.items())]

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()


def _quarantine_counter(what: str):
    from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
    helps = {"added": "shape buckets parked native-only after a device "
                      "fault",
             "hits": "compactions routed native because their shape "
                     "bucket is quarantined",
             "decayed": "quarantine windows that expired (bucket "
                        "eligible for the device path again)"}
    return ROOT_REGISTRY.entity("server", "offload_policy").counter(
        f"offload_quarantine_{what}_total", helps[what])


# ---------------------------------------------------------------------------
# Declared compile surface: the committed kernel manifest
# (tools/analysis/kernel_manifest.json, regenerated by
# `python -m tools.analysis.kernel_manifest --write` and drift-gated in
# tier-1) enumerates every (k_pad, m) shape bucket the kernel families
# are declared reachable with. The policy layer uses it as the shape
# vocabulary: a quarantine (or a device-native launch) on a key OUTSIDE
# the surface is the earliest signal that the bucket lattice has sprung
# a leak — some code path is minting executables the prewarm/budget
# discipline never reviewed.

_surface_keys: Optional[frozenset] = None  # guarded-by: _surface_lock
_surface_counts: Optional[dict] = None     # guarded-by: _surface_lock
_surface_lock = threading.Lock()


def _manifest_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "tools", "analysis", "kernel_manifest.json")


def _load_surface_unlocked() -> None:
    global _surface_keys, _surface_counts
    keys = set()
    counts: dict = {}
    try:
        with open(_manifest_path()) as f:
            manifest = json.load(f)
        for name, rec in manifest.get("families", {}).items():
            counts[name] = int(rec.get("distinct_executables") or 0)
            for e in rec.get("entries", ()):
                qk = e.get("quarantine_key")
                if qk:
                    keys.add((int(qk[0]), int(qk[1])))
    except (OSError, ValueError):  # yblint: contained(absent/corrupt manifest means no declared surface — the off-surface telemetry simply stays quiet)
        pass
    _surface_keys = frozenset(keys)
    _surface_counts = counts


def declared_surface_keys() -> frozenset:
    """(k_pad, m) quarantine keys of every declared manifest bucket;
    empty when no manifest is committed (telemetry-only consumer)."""
    with _surface_lock:
        if _surface_keys is None:
            _load_surface_unlocked()
        return _surface_keys


def declared_surface_counts() -> dict:
    """family -> declared distinct-executable count from the manifest
    (feeds the kernel_compile_surface gauges)."""
    with _surface_lock:
        if _surface_counts is None:
            _load_surface_unlocked()
        return dict(_surface_counts)


def bucket_key(run_ns) -> Tuple[int, int]:
    """The quarantine key for a job with (packed) run lengths run_ns:
    (k_pad, m) of the run-major layout — computed the same way
    ops/run_merge.stage_runs_from_slabs lays the matrix out, WITHOUT
    staging anything, so the pre-dispatch check and the fault-time
    quarantine agree on the key."""
    from yugabyte_tpu_torch.ops.run_merge import run_bucket
    live = [n for n in run_ns if n]
    if not live:
        return (0, 0)
    k = len(live)
    k_pad = 1 << max(0, (k - 1).bit_length()) if k > 1 else 1
    m = max(run_bucket(n) for n in live)
    return (k_pad, m)


def point_read_bucket_key(n_pad: int) -> Tuple[int, int]:
    """Quarantine key for the batched point-read kernels over a staged
    matrix padded to n_pad: the single-run layout (k_pad=1, m=n_pad) —
    the same vocabulary scan_fused declares, so a locate-kernel fault
    parks exactly the declared bucket (ops/point_read.py)."""
    return (1, n_pad)


def bucket_quarantine() -> BucketQuarantine:
    """Process-wide quarantine registry — the health board's embedded
    fault registry (storage/bucket_health.py), so legacy callers and
    the board share ONE memory of poisoned buckets. Its `clear()`
    resets the whole board (test/operator isolation)."""
    from yugabyte_tpu_torch.storage.bucket_health import health_board
    return health_board().quarantine_registry()
