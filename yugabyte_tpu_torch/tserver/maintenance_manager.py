"""MaintenanceManager: scored background-op scheduling.

Counterpart of yugabyte_tpu/tserver/maintenance_manager.py, with the
imports renamed; PrewarmKernelsOp warms the port's CUDA kernels on the
server's device instead of compiling XLA programs.

Capability parity with the reference (ref:
src/yb/tablet/maintenance_manager.h:154 MaintenanceOp with UpdateStats/
Prepare/Perform; maintenance_manager.cc FindBestOp): every candidate op
reports (ram_anchored, logs_retained_bytes, perf_improvement) and the
scheduler picks, in priority order,
  1. under memory pressure - the op anchoring the most RAM,
  2. with WAL replay debt above log_target_replay_size - the op
     releasing the most log bytes,
  3. otherwise - the op with the highest perf_improvement.

Built-in per-tablet ops (generated dynamically from the live peer list,
like the memory arbiter, rather than registered/unregistered on tablet
open/close): FlushOp (memstore -> SST, releases RAM and WAL),
LogGCOp (drops fully-flushed WAL segments; the only automatic WAL GC
trigger in the server), CompactOp (kicks the compaction picker for
tablets that went idle mid-backlog), and RecoverOp — the capped-
exponential-backoff retry that un-parks tablets in FAILED state after a
background storage error (ref DBImpl::Resume driven by
ErrorHandler::RecoverFromBGError). External subsystems can register
custom MaintenanceOps through register_op() — the TabletServer registers
PrewarmKernelsOp (startup kernel build and launch) and ScrubTabletsOp (at-rest
integrity scrub + cross-replica digest exchange) this way.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils.backoff import RetrySchedule
from yugabyte_tpu_torch.utils.mem_tracker import root_tracker
from yugabyte_tpu_torch.utils.trace import TRACE

flags.define_flag("maintenance_manager_polling_interval_s", 0.25,
                  "how often the maintenance scheduler scores ops "
                  "(ref maintenance_manager_polling_interval_ms)")
flags.define_flag("log_target_replay_size_mb", 64,
                  "closed-WAL bytes per tablet above which log-releasing "
                  "ops take priority (ref log_target_replay_size_mb)")
flags.define_flag("background_error_retry_initial_s", 0.5,
                  "first-retry delay for a tablet parked by a background "
                  "storage error; doubles per failure")
flags.define_flag("background_error_retry_max_s", 30.0,
                  "cap on the background-error retry delay")
flags.define_flag("compaction_prewarm_kernels", 0,
                  "build and launch the common kernel shape buckets at "
                  "tserver startup (one-shot maintenance op) so first "
                  "compactions, point reads and scans do not pay the "
                  "kernel build; enable on the card")


class MaintenanceOpStats:
    """One op's current utility (ref maintenance_manager.h:62)."""

    __slots__ = ("runnable", "ram_anchored", "logs_retained_bytes",
                 "perf_improvement")

    def __init__(self):
        self.runnable = False
        self.ram_anchored = 0
        self.logs_retained_bytes = 0
        self.perf_improvement = 0.0


class MaintenanceOp:
    """Base class for registered ops (ref maintenance_manager.h:154)."""

    def __init__(self, name: str):
        self.name = name

    def update_stats(self, stats: MaintenanceOpStats) -> None:
        raise NotImplementedError

    def perform(self) -> None:
        raise NotImplementedError


class _FlushOp(MaintenanceOp):
    def __init__(self, peer, flush_releasable: int):
        super().__init__(f"flush:{peer.tablet_id}")
        self._peer = peer
        self._flush_releasable = flush_releasable

    def update_stats(self, stats: MaintenanceOpStats) -> None:
        ram = self._peer.tablet.memstore_bytes()
        stats.runnable = ram > 0
        stats.ram_anchored = ram
        # only the bytes a flush can ACTUALLY release: the raft lagging-
        # peer watermark and CDC retention still pin the WAL after a
        # flush, so scoring all closed segments would flush near-empty
        # memstores forever while freeing nothing (snapshotted once per
        # poll round by _candidate_ops — one WAL scan serves both ops)
        stats.logs_retained_bytes = self._flush_releasable

    def perform(self) -> None:
        self._peer.flush_and_gc_wal()


class _LogGCOp(MaintenanceOp):
    def __init__(self, peer, freeable: int):
        super().__init__(f"log_gc:{peer.tablet_id}")
        self._peer = peer
        self._freeable = freeable

    def update_stats(self, stats: MaintenanceOpStats) -> None:
        stats.runnable = self._freeable > 0
        stats.logs_retained_bytes = self._freeable

    def perform(self) -> None:
        self._peer.gc_wal()


class _CompactOp(MaintenanceOp):
    def __init__(self, peer):
        super().__init__(f"compact:{peer.tablet_id}")
        self._peer = peer

    def update_stats(self, stats: MaintenanceOpStats) -> None:
        # L0 backlog beyond the picker's merge width = perf debt: reads
        # touch every overlapping run (ref: read amplification scoring)
        t = self._peer.tablet
        trigger = flags.get_flag("universal_compaction_min_merge_width")
        backlog = 0
        for db in (t.regular_db, t.intents_db):
            backlog = max(backlog, db.n_live_files - trigger)
        stats.runnable = backlog > 0
        stats.perf_improvement = float(backlog)

    def perform(self) -> None:
        t = self._peer.tablet
        for db in (t.regular_db, t.intents_db):
            db.maybe_schedule_compaction()


class PrewarmKernelsOp(MaintenanceOp):
    """One-shot startup warm of the common kernel shape buckets: builds
    the CUDA kernel libraries (nvcc, once per checkout) and launches each
    kernel family once at its declared buckets, before traffic, so the
    first real compaction, point read or pushdown of each shape does not
    pay the build, and the health board stops routing those buckets
    native (COLD -> WARMING). Each bucket's warm covers both is_major
    merge variants (kernels A, B; ops/run_merge.prewarm_buckets, which
    marks each bucket that warmed on the board), the point-read family
    (P1-P4, ops/point_read.prewarm_point_read) and, in the full mode
    (shapes=None), the pushdown (G, H, I.1, B, J, K;
    ops/scan.prewarm_scan_pushdown), the block codec (C, F;
    ops/block_codec.prewarm_block_codec) and, on a mesh of more than one
    device, the mesh families (parallel/dist_compact.prewarm_dist_compact).
    No XLA program is compiled: the JAX package's op compiles its
    executables here.

    Scored just below recovery (warm kernels beat compaction debt: every
    queued compaction stalls on a cold bucket) and unrunnable after the
    first successful run. Gated by the compaction_prewarm_kernels flag
    (default off — the plain versions on the CPU build nothing)."""

    PREWARM_SCORE = 1e8

    def __init__(self, shapes=None, enabled_fn=None, mesh=None,
                 device=None):
        super().__init__("prewarm_kernels")
        self._shapes = shapes
        self._mesh = mesh
        # the server's device (None = the card, as every entry point)
        self._device = device
        self._enabled_fn = enabled_fn or (
            lambda: bool(flags.get_flag("compaction_prewarm_kernels")))
        self.done = False

    def update_stats(self, stats: MaintenanceOpStats) -> None:
        stats.runnable = not self.done and self._enabled_fn()
        stats.perf_improvement = self.PREWARM_SCORE

    def perform(self) -> None:
        from yugabyte_tpu_torch.ops import block_codec, point_read, run_merge, scan
        from yugabyte_tpu_torch.storage import offload_policy
        from yugabyte_tpu_torch.storage.bucket_health import health_board
        from yugabyte_tpu_torch.utils.metrics import publish_compile_surface
        board = health_board()
        shapes = list(self._shapes if self._shapes is not None
                      else run_merge._PREWARM_SHAPES)
        # priority from the health board: the highest-traffic COLD
        # buckets (jobs the policy routed native while unamortized)
        # warm first, so the order traffic arrives in is the order the
        # warm budget is spent in
        prio = {key[1]: i for i, key in enumerate(
            k for k in board.prewarm_priorities()
            if k[0] == "run_merge_fused")}
        shapes.sort(key=lambda s: prio.get((s[0], s[1]), len(prio)))
        # prewarm_buckets marks each bucket that warmed prewarmed on the
        # board (COLD -> WARMING), so the policy gate stops routing it
        # native
        n = run_merge.prewarm_buckets(shapes, device=self._device)
        # the batched point-read families (serve-path kernels) warm in
        # the same pass — their first real multi_get batch must not
        # stall a read on a kernel build
        n += point_read.prewarm_point_read(device=self._device)
        # query-pushdown families (fused filtered/aggregating scans):
        # only in FULL prewarm mode (shapes=None); a bounded-shapes op —
        # the unit-test lifecycle mode — warms the merge and point-read
        # buckets only
        if self._shapes is None:
            n += scan.prewarm_scan_pushdown(device=self._device)
            # device block codec (kernel C decode / kernel F encode)
            n += block_codec.prewarm_block_codec(device=self._device)
            if self._mesh is not None \
                    and getattr(self._mesh, "devices", None) is not None \
                    and self._mesh.devices.size > 1:
                # mesh families: the key-range-sharded dist step and the
                # multi-tablet pool wave
                from yugabyte_tpu_torch.parallel.dist_compact import (
                    prewarm_dist_compact)
                n += prewarm_dist_compact(self._mesh)
        # expose the declared surface (committed kernel manifest) next
        # to the bucket hit/miss counters
        publish_compile_surface(offload_policy.declared_surface_counts())
        self.done = True
        TRACE("maintenance: prewarmed %d kernel launches", n)


class ScrubTabletsOp(MaintenanceOp):
    """Background at-rest integrity scrubber: deep-verifies each RUNNING
    tablet's SSTs (block CRCs + footer + index/bloom consistency) on a
    ``--scrub_interval_s`` cadence, reads throttled through the
    process-wide ``--scrub_bytes_per_sec`` token bucket, one tablet per
    perform() so the scheduler stays responsive. When the scrubbed
    tablet is a Raft leader, a cross-replica digest exchange (the
    ``checksum_tablet`` RPC, via the server-provided ``digest_check``
    hook) follows the local scrub — the detector for divergence that
    byte-level CRCs cannot see.

    Scored just above zero: scrubbing is strictly idle-time work — any
    flush/compaction/recovery debt outranks it (the reference's
    VerifyChecksum sweeps are likewise background-priority)."""

    SCRUB_SCORE = 0.05

    def __init__(self, peers_fn: Callable[[], List],
                 digest_check: Optional[Callable[[object], int]] = None):
        super().__init__("scrub_tablets")
        self._peers_fn = peers_fn
        self._digest_check = digest_check
        # tablet_id -> monotonic ts of its last scrub; tablets never
        # scrubbed age from op construction (a fresh server's files were
        # just written/bootstrapped — scrubbing them immediately would
        # burn startup I/O for nothing)
        self._last: Dict[str, float] = {}
        self._t0 = time.monotonic()

    def _due_peer(self):
        """Most-overdue RUNNING tablet at or past the interval, else
        None."""
        from yugabyte_tpu_torch.tablet.tablet_peer import STATE_RUNNING
        from yugabyte_tpu_torch.storage import integrity  # noqa: F401 (flags)
        interval = float(flags.get_flag("scrub_interval_s"))
        if interval <= 0:
            return None
        now = time.monotonic()
        best, best_age = None, interval
        live = set()
        for peer in self._peers_fn():
            live.add(peer.tablet_id)
            if peer.state != STATE_RUNNING:
                continue
            age = now - self._last.get(peer.tablet_id, self._t0)
            if age >= best_age:
                best, best_age = peer, age
        for tid in [t for t in self._last if t not in live]:
            del self._last[tid]  # deleted/moved tablets drop tracking
        return best

    def update_stats(self, stats: MaintenanceOpStats) -> None:
        stats.runnable = self._due_peer() is not None
        stats.perf_improvement = self.SCRUB_SCORE

    def perform(self) -> None:
        from yugabyte_tpu_torch.storage import integrity
        peer = self._due_peer()
        if peer is None:
            return
        self._last[peer.tablet_id] = time.monotonic()
        report = peer.tablet.scrub(limiter=integrity.scrub_rate_limiter())
        mismatches = 0
        if self._digest_check is not None and not report["corrupt"] \
                and peer.raft.is_leader():
            mismatches = self._digest_check(peer)
        prev = peer.scrub_state or {}
        peer.scrub_state = {
            "last_scrub_ts": time.time(),
            "files": report["files"], "bytes": report["bytes"],
            "corrupt": prev.get("corrupt", 0) + len(report["corrupt"]),
            "replica_mismatches": prev.get("replica_mismatches", 0)
            + mismatches,
        }
        if report["corrupt"]:
            TRACE("scrub: tablet %s has %d corrupt SST(s) — quarantined "
                  "and parked for rebuild: %s", peer.tablet_id,
                  len(report["corrupt"]), report["corrupt"])
        else:
            TRACE("scrub: tablet %s clean (%d files, %d bytes, %d "
                  "replica digest mismatches)", peer.tablet_id,
                  report["files"], report["bytes"], mismatches)


class _RecoverOp(MaintenanceOp):
    """Un-park a FAILED tablet (ref ErrorHandler::RecoverFromBGError):
    in-place retry of the parked flush/compaction via the tablet
    manager's recover hook, paced by a per-tablet capped exponential
    backoff so a persistently broken disk is not hammered every poll."""

    # outranks every compaction-debt score: a FAILED tablet rejects writes
    RECOVERY_SCORE = 1e9

    def __init__(self, peer, schedule: RetrySchedule, recover_fn):
        super().__init__(f"recover:{peer.tablet_id}")
        self._peer = peer
        self._schedule = schedule
        self._recover_fn = recover_fn

    def update_stats(self, stats: MaintenanceOpStats) -> None:
        stats.runnable = self._schedule.ready()
        stats.perf_improvement = self.RECOVERY_SCORE

    def perform(self) -> None:
        if self._recover_fn(self._peer):
            self._schedule.reset()
        else:
            delay = self._schedule.record_failure()
            TRACE("maintenance: recovery of %s failed; next attempt in "
                  "%.2fs", self._peer.tablet_id, delay)


class MaintenanceManager:
    """One per TabletServer (ref maintenance_manager.cc)."""

    def __init__(self, peers_fn: Callable[[], List], metric_entity=None,
                 memory_pressure_fn: Optional[Callable[[], bool]] = None,
                 recover_fn: Optional[Callable[[object], bool]] = None):
        self._peers_fn = peers_fn
        # recover_fn(peer) -> bool; default = the peer's in-place recovery
        # (clears DB background errors). The tablet server passes the
        # manager's recover_failed_tablet for full re-bootstrap coverage.
        self._recover_fn = recover_fn or (lambda peer: peer.try_recover())
        # _recover_backoff is scheduler-thread-only state (the loop and
        # test-driven run_once are never concurrent by contract)
        self._recover_backoff: Dict[str, RetrySchedule] = {}
        from yugabyte_tpu_torch.utils import lock_rank
        self._registered: List[MaintenanceOp] = []  # guarded-by: _reg_lock
        self._reg_lock = lock_rank.tracked(threading.Lock(),
                                           "maintenance._reg_lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._memory_pressure = (memory_pressure_fn or
                                 (lambda: root_tracker()
                                  .soft_limit_exceeded().exceeded))
        self._c_ops = self._h_dur = None
        if metric_entity is not None:
            self._c_ops = metric_entity.counter(
                "maintenance_ops_performed_total",
                "background maintenance ops run")
            self._h_dur = metric_entity.histogram(
                "maintenance_op_duration_ms", "maintenance op wall time")
        self.last_op_name: Optional[str] = None   # observability/tests

    # ------------------------------------------------------------ lifecycle
    def init(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="maintenance-mgr")
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def register_op(self, op: MaintenanceOp) -> None:
        with self._reg_lock:
            self._registered.append(op)

    def unregister_op(self, op: MaintenanceOp) -> None:
        with self._reg_lock:
            if op in self._registered:
                self._registered.remove(op)

    # ------------------------------------------------------------ scheduling
    def _retry_schedule(self, tablet_id: str) -> RetrySchedule:
        sched = self._recover_backoff.get(tablet_id)
        if sched is None:
            sched = self._recover_backoff[tablet_id] = RetrySchedule(
                initial_s=flags.get_flag("background_error_retry_initial_s"),
                max_s=flags.get_flag("background_error_retry_max_s"))
        return sched

    def _candidate_ops(self) -> List[MaintenanceOp]:
        from yugabyte_tpu_torch.tablet.tablet_peer import STATE_FAILED
        ops: List[MaintenanceOp] = []
        live_ids = set()
        for peer in self._peers_fn():
            live_ids.add(peer.tablet_id)
            if peer.state == STATE_FAILED:
                # a parked tablet has nothing to flush/GC/compact — its
                # only maintenance is the backoff-paced recovery retry
                ops.append(_RecoverOp(peer,
                                      self._retry_schedule(peer.tablet_id),
                                      self._recover_fn))
                continue
            # one WAL-directory scan per peer per round, shared by both
            # log-scoring ops (listdir+stat per op per poll would hammer
            # the Log lock on servers with many idle tablets)
            try:
                freeable = peer.log.gc_candidate_bytes(peer.wal_anchor())
                flush_releasable = peer.log.gc_candidate_bytes(
                    peer.wal_anchor(assume_flushed=True))
            except Exception as e:
                TRACE("maintenance: WAL scoring for %s failed: %s",
                      getattr(peer, "tablet_id", "?"), e)
                freeable = flush_releasable = 0
            ops.append(_FlushOp(peer, flush_releasable))
            ops.append(_LogGCOp(peer, freeable))
            ops.append(_CompactOp(peer))
        # drop backoff state for tablets that went away (deleted / moved)
        for tid in list(self._recover_backoff):
            if tid not in live_ids:
                del self._recover_backoff[tid]
        with self._reg_lock:
            ops.extend(self._registered)
        return ops

    def find_best_op(self) -> Optional[MaintenanceOp]:
        """The reference's FindBestOp policy (maintenance_manager.cc):
        memory pressure -> max ram_anchored; log debt above target ->
        max logs_retained; else max perf_improvement."""
        scored = []
        for op in self._candidate_ops():
            stats = MaintenanceOpStats()
            try:
                op.update_stats(stats)
            except Exception as e:
                # never silently disable a broken op: a tablet whose flush
                # scoring always throws would pile up debt with no signal
                TRACE("maintenance op %s update_stats failed: %s",
                      op.name, e)
                continue
            if stats.runnable:
                scored.append((op, stats))
        if not scored:
            return None
        if self._memory_pressure():
            best = max(scored, key=lambda s: s[1].ram_anchored)
            if best[1].ram_anchored > 0:
                return best[0]
        log_target = flags.get_flag("log_target_replay_size_mb") << 20
        loggy = max(scored, key=lambda s: s[1].logs_retained_bytes)
        if loggy[1].logs_retained_bytes > log_target:
            return loggy[0]
        perf = max(scored, key=lambda s: s[1].perf_improvement)
        if perf[1].perf_improvement > 0:
            return perf[0]
        # fall back to any freeable log bytes (cheap housekeeping)
        if loggy[1].logs_retained_bytes > 0:
            return loggy[0]
        return None

    def run_once(self) -> Optional[str]:
        """Score + perform at most one op; returns its name (tests drive
        this synchronously; the background loop calls it repeatedly)."""
        op = self.find_best_op()
        if op is None:
            return None
        t0 = time.monotonic()
        try:
            op.perform()
        except Exception as e:
            TRACE("maintenance op %s failed: %s", op.name, e)
            return None
        self.last_op_name = op.name
        if self._c_ops is not None:
            self._c_ops.increment()
            self._h_dur.increment((time.monotonic() - t0) * 1e3)
        return op.name

    def _loop(self) -> None:
        # interval re-read each round: the flag is runtime-tunable
        while not self._stop.wait(
                flags.get_flag("maintenance_manager_polling_interval_s")):
            try:
                self.run_once()
            except Exception as e:
                TRACE("maintenance loop error: %s", e)
