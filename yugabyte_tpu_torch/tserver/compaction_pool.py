"""Mesh-sharded compaction pool: many tablets share one device mesh.

Counterpart of yugabyte_tpu/tserver/compaction_pool.py. The headline is
AGGREGATE multi-job rows/s across concurrent tablets, not single-job
latency. Queued jobs from concurrent tablets are packed into
shape-bucketed batch slots — one tablet job per mesh slot, one wave of
launches (parallel/dist_compact.pooled_merge_gc: kernels A + B on each
slot's device) — while a job at or above
`distributed_compaction_min_rows` takes the whole mesh exclusively
through the key-range-sharded dist-native job (kernels M1-M3, G, I.1, B).

Scheduling is measured, fair and contained:

  - measured per-bucket rates: every wave records its device rows/s on
    the health board (storage/bucket_health.py), every native completion
    the native twin; a bucket the board parks (degraded, quarantined, a
    sticky mismatch) runs natively until the board re-opens it;
  - fairness: tablets are served in deficit order (least rows served
    first), and wave slots fill round-robin across tablet queue heads —
    a tablet saturating the queue cannot starve the others;
  - cancellation: every job carries a CancellationToken checked at each
    stage boundary; a cancelled job's partial outputs are swept and its
    input pins released, co-scheduled jobs unaffected;
  - fault containment: a device fault in a wave quarantines that shape
    bucket and completes every affected job NATIVELY, byte-identically;
    a host-side failure in one job's write stage fails only that job's
    handle.

Per-slot merge products stay on the device: each job's output spans
gather on its slot's device (kernels D once a slot, E a span), move to
the tablet's cache partition's device (storage/device_cache.
ShardPartition) and install there, so the resident L0->L1->L2 chain
survives sharding. The wave, and with it every launch of a pooled job,
runs on the pool's own thread.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils.cancellation import (CancellationToken,
                                             OperationCancelled)
from yugabyte_tpu_torch.utils.trace import TRACE

@dataclass
class PoolRequest:
    """One tablet compaction job as the pool schedules it."""
    inputs: List                      # SSTReaders, newest-first pick order
    out_dir: str
    new_file_id: object               # callable -> next file id
    history_cutoff_ht: int
    is_major: bool
    retain_deletes: bool = False
    block_entries: Optional[int] = None
    input_ids: Optional[List[int]] = None
    device_cache: object = None       # NamespacedSlabCache / ShardPartition
    est_rows: int = 0
    # merge-only jobs (decisions service, no SST I/O): the tests use
    # this form
    slabs: Optional[List] = None


class PoolJobHandle:
    """Caller's side of a submitted job: wait for the result, or cancel."""

    def __init__(self, tablet_id: str, cancel: CancellationToken):
        self.tablet_id = tablet_id
        self.cancel_token = cancel
        self._done = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self.submitted_at = time.monotonic()
        self.finished_at: Optional[float] = None

    def cancel(self, reason: str = "cancelled") -> None:
        self.cancel_token.cancel(reason)

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise TimeoutError("pool job still running")
        if self._exc is not None:
            raise self._exc
        return self._result

    def _resolve(self, result=None, exc: Optional[BaseException] = None
                 ) -> None:
        self._result = result
        self._exc = exc
        self.finished_at = time.monotonic()
        self._done.set()


@dataclass
class _Job:
    tablet_id: str
    request: PoolRequest
    handle: PoolJobHandle
    # set during wave staging
    filtered_inputs: List = field(default_factory=list)
    slabs: List = field(default_factory=list)
    staged: object = None
    dropped_rows: int = 0
    pins: List[int] = field(default_factory=list)


def _bucket_name(bucket: Tuple[int, int]) -> str:
    return f"k{bucket[0]}_m{bucket[1]}"


class CompactionPool:
    """One per tablet server (next to the thread pool it rides behind):
    the scheduler that turns a device mesh into a multi-tablet compaction
    throughput service."""

    def __init__(self, mesh, device=None, name: str = "compaction-pool"):
        from yugabyte_tpu_torch.utils import lock_rank
        from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
        self.mesh = mesh
        self.n_slots = int(mesh.devices.size)
        self.device = (device if device is not None
                       else list(mesh.devices.flat)[0])
        self._lock = lock_rank.tracked(threading.Lock(),
                                       "compaction_pool.lock")
        self._cond = threading.Condition(self._lock)
        self._queues: Dict[str, deque] = {}       # guarded-by: _lock
        self._credits: Dict[str, float] = {}      # rows served; _lock
        self._running: Dict[str, int] = {}        # guarded-by: _lock
        self._shutdown = False                    # guarded-by: _lock
        self._last_fill = 0.0                     # guarded-by: _lock
        e = ROOT_REGISTRY.entity("server", "compaction_pool")
        self._c_jobs = e.counter(
            "compaction_pool_jobs_total", "jobs submitted to the pool")
        self._c_waves = e.counter(
            "compaction_pool_waves_total",
            "pooled wave dispatches (one launch per slot each)")
        self._c_wave_jobs = e.counter(
            "compaction_pool_wave_jobs_total",
            "jobs whose device stage rode a pooled wave slot")
        self._c_native = e.counter(
            "compaction_pool_native_completions_total",
            "pool jobs completed on the native path (bucket demoted, "
            "quarantined, or wave fault containment)")
        self._c_faults = e.counter(
            "compaction_pool_wave_faults_total",
            "wave dispatches that hit a device fault (bucket "
            "quarantined; jobs completed natively)")
        self._c_cancelled = e.counter(
            "compaction_pool_cancelled_total",
            "pool jobs cancelled before or during execution")
        self._g_queue = e.gauge(
            "compaction_pool_queue_depth", "jobs queued across tablets")
        self._g_running = e.gauge(
            "compaction_pool_running_count", "jobs currently executing")
        self._g_fill = e.gauge(
            "compaction_pool_slot_occupancy_ratio",
            "filled slots / mesh slots of the most recent wave")
        self._h_wall = e.histogram(
            "compaction_pool_job_wall_ms",
            "submit-to-done wall time per pool job")
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=name)
        self._thread.start()

    # ------------------------------------------------------------- client API
    def partition_for(self, shared_cache, namespace: str, tablet_id: str):
        """The tablet's sticky cache partition: home shard =
        hash(tablet_id) mod mesh size, staged onto that shard's device."""
        from yugabyte_tpu_torch.storage.device_cache import ShardPartition
        shard = hash(tablet_id) % self.n_slots
        return ShardPartition(shared_cache, namespace, shard,
                              list(self.mesh.devices.flat)[shard])

    def submit(self, tablet_id: str, request: PoolRequest,
               cancel: Optional[CancellationToken] = None) -> PoolJobHandle:
        token = cancel or CancellationToken(f"pool job {tablet_id}")
        handle = PoolJobHandle(tablet_id, token)
        job = _Job(tablet_id, request, handle)
        with self._cond:
            if self._shutdown:
                handle._resolve(exc=OperationCancelled(
                    "compaction pool shut down"))
                return handle
            q = self._queues.setdefault(tablet_id, deque())
            if tablet_id not in self._credits:
                # newcomers start at the current minimum so they are
                # served promptly without eternal priority
                self._credits[tablet_id] = min(self._credits.values(),
                                               default=0.0)
            q.append(job)
            self._c_jobs.increment()
            self._g_queue.set(self._queue_depth_unlocked())
            self._cond.notify_all()
        return handle

    def submit_compaction(self, tablet_id: str, *, inputs, out_dir,
                          new_file_id, history_cutoff_ht, is_major,
                          retain_deletes: bool = False,
                          block_entries: Optional[int] = None,
                          input_ids: Optional[List[int]] = None,
                          device_cache=None, est_rows: int = 0,
                          cancel: Optional[CancellationToken] = None
                          ) -> PoolJobHandle:
        """Keyword-argument front for storage/db.py (which does not import
        this module: the pool object is injected through DBOptions.
        mesh_pool)."""
        return self.submit(tablet_id, PoolRequest(
            inputs=list(inputs), out_dir=out_dir, new_file_id=new_file_id,
            history_cutoff_ht=history_cutoff_ht, is_major=is_major,
            retain_deletes=retain_deletes, block_entries=block_entries,
            input_ids=list(input_ids) if input_ids is not None else None,
            device_cache=device_cache, est_rows=est_rows), cancel=cancel)

    def cancel_tablet(self, tablet_id: str,
                      reason: str = "tablet cancelled") -> int:
        """Cancel every queued and running job of one tablet. Queued jobs
        resolve immediately; running ones abort at their next stage
        boundary. Returns how many jobs were signalled."""
        n = 0
        with self._cond:
            for job in list(self._queues.get(tablet_id, ())):
                job.handle.cancel(reason)
                n += 1
        # running jobs: their token is shared with the handle
        return n

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            queued = [j for q in self._queues.values() for j in q]
            for q in self._queues.values():
                q.clear()
            self._g_queue.set(0)
            self._cond.notify_all()
        for job in queued:
            job.handle._resolve(exc=OperationCancelled(
                "compaction pool shut down"))
        self._thread.join(timeout=10)

    def snapshot(self) -> dict:
        """The /compactionz "pool" block: queue depth, per-tablet
        queued/running, packed-slot occupancy and the health board's
        measured per-bucket rates the scheduler routes by."""
        from yugabyte_tpu_torch.storage.bucket_health import health_board
        rates = {}
        for rec in health_board().snapshot()["keys"]:
            if rec["family"] != "run_merge_fused":
                continue
            rates[_bucket_name(tuple(rec["bucket"]))] = {
                "device_rows_per_sec": rec["device_rows_per_sec"],
                "native_rows_per_sec": rec["native_rows_per_sec"],
                "state": rec["state"],
                "demoted": rec["state"] in ("degraded", "quarantined"),
            }
        with self._lock:
            tablets = {}
            for tid, q in self._queues.items():
                r = self._running.get(tid, 0)
                if q or r:
                    tablets[tid] = {"queued": len(q), "running": r}
            for tid, r in self._running.items():
                if r and tid not in tablets:
                    tablets[tid] = {"queued": 0, "running": r}
            return {
                "mesh_slots": self.n_slots,
                "queue_depth": self._queue_depth_unlocked(),
                "tablets": tablets,
                "slot_occupancy_ratio": round(self._last_fill, 3),
                "bucket_rates": rates,
                "waves": self._c_waves.value(),
                "wave_jobs": self._c_wave_jobs.value(),
                "native_completions": self._c_native.value(),
                "wave_faults": self._c_faults.value(),
                "cancelled": self._c_cancelled.value(),
            }

    # ------------------------------------------------------------- scheduling
    def _queue_depth_unlocked(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _take_round(self) -> List[_Job]:
        """Pop up to n_slots queue heads in deficit-fair order: tablets
        sorted by rows served ascending, then round-robin across their
        queues until the slots fill or the queues drain."""
        with self._cond:
            while not self._shutdown \
                    and self._queue_depth_unlocked() == 0:
                self._cond.wait(timeout=0.5)
            if self._shutdown:
                return []
            order = sorted(
                (tid for tid, q in self._queues.items() if q),
                key=lambda tid: self._credits.get(tid, 0.0))
            picked: List[_Job] = []
            while len(picked) < self.n_slots:
                progressed = False
                for tid in order:
                    q = self._queues.get(tid)
                    if q and len(picked) < self.n_slots:
                        picked.append(q.popleft())
                        progressed = True
                if not progressed:
                    break
            for job in picked:
                self._running[job.tablet_id] = \
                    self._running.get(job.tablet_id, 0) + 1
            self._g_queue.set(self._queue_depth_unlocked())
            self._g_running.set(sum(self._running.values()))
            return picked

    def _loop(self) -> None:
        from yugabyte_tpu_torch.utils import sync_point
        while True:
            # a test arms this point to hold the loop until the jobs it
            # wants in one round are queued
            sync_point.hit("compaction_pool:take_round")
            jobs = self._take_round()
            if not jobs:
                with self._lock:
                    if self._shutdown:
                        return
                continue
            try:
                self._run_round(jobs)
            except Exception as e:  # noqa: BLE001 — scheduler must survive
                TRACE("compaction pool: round failed: %s", e)
                for job in jobs:
                    if not job.handle.done:
                        job.handle._resolve(exc=e)
            finally:
                with self._lock:
                    for job in jobs:
                        self._running[job.tablet_id] = max(
                            0, self._running.get(job.tablet_id, 0) - 1)
                    self._g_running.set(sum(self._running.values()))

    # -------------------------------------------------------------- execution
    def _finish(self, job: _Job, result=None,
                exc: Optional[BaseException] = None) -> None:
        if job.handle.done:
            return
        if isinstance(exc, OperationCancelled):
            self._c_cancelled.increment()
        rows = 0
        if result is not None:
            rows = getattr(result, "rows_in", 0) or \
                (sum(s.n for s in job.slabs) if job.slabs else 0)
        with self._lock:
            self._credits[job.tablet_id] = \
                self._credits.get(job.tablet_id, 0.0) + float(rows or 1)
        self._h_wall.increment(
            (time.monotonic() - job.handle.submitted_at) * 1e3)
        job.handle._resolve(result=result, exc=exc)

    def _run_round(self, jobs: List[_Job]) -> None:
        from yugabyte_tpu_torch.ops.merge_gc import GCParams
        from yugabyte_tpu_torch.storage import compaction as compaction_mod

        # stage every job (filter, read, pack / cache restage, pin);
        # failures and cancellations here affect only their own job
        staged_jobs: List[_Job] = []
        big_jobs: List[_Job] = []
        dist_min = flags.get_flag("distributed_compaction_min_rows")
        for job in jobs:
            try:
                job.handle.cancel_token.check()
                if self.n_slots > 1 and job.request.slabs is None \
                        and job.request.est_rows >= dist_min:
                    big_jobs.append(job)
                    continue
                self._stage_job(job)
                if job.staged is None:      # nothing to merge
                    continue
                staged_jobs.append(job)
            except BaseException as e:  # noqa: BLE001 — per-job containment
                self._unpin(job)
                self._finish(job, exc=e)

        # shape-bucketed wave groups: (k_pad, m, w, is_major,
        # retain_deletes) — each group is one wave of launches
        groups: Dict[tuple, List[_Job]] = {}
        for job in staged_jobs:
            st = job.staged
            key = (st.k_pad, st.m, st.w, job.request.is_major,
                   job.request.retain_deletes)
            groups.setdefault(key, []).append(job)
        from yugabyte_tpu_torch.storage.bucket_health import health_board
        board = health_board()
        for key, group in groups.items():
            bucket = key[:3]
            if not board.allow_device("run_merge_fused",
                                      (bucket[0], bucket[1])):
                # the health board parked the bucket (measured demotion,
                # open fault-quarantine window, or sticky mismatch): run
                # these natively until a probe / the decay re-opens it
                for job in group:
                    self._complete_natively(job, record_rate=True)
                continue
            self._run_wave(bucket, key[3], key[4], group)

        # whole-mesh jobs run after the waves (exclusive use of the mesh)
        for job in big_jobs:
            self._run_exclusive(job)

    def _stage_job(self, job: _Job) -> None:
        """Filter + read + pack one job's device-stage input. Resident
        hit: every input present in the job's cache partition restages
        on the device (ops/run_merge.stage_runs_from_staged — no upload);
        miss: host pack (parallel/dist_compact.stage_pool_slot)."""
        from yugabyte_tpu_torch.parallel.dist_compact import (pool_slot_bucket,
                                                        stage_pool_slot)
        from yugabyte_tpu_torch.storage.compaction import filter_expired_inputs
        req = job.request
        if req.slabs is not None:
            # merge-only job (decisions service): slabs arrive pre-read
            job.filtered_inputs = []
            job.slabs = [s for s in req.slabs if s.n]
            if not job.slabs:
                job.staged = None
                self._finish(job, result=None)
                return
            b = pool_slot_bucket(job.slabs)
            job.staged = stage_pool_slot(job.slabs, *b)
            return
        inputs, dropped = filter_expired_inputs(
            req.inputs, req.history_cutoff_ht, req.is_major,
            req.retain_deletes)
        job.dropped_rows = sum(r.props.n_entries for r in dropped)
        inputs = [r for r in inputs if r.props.n_entries]
        job.filtered_inputs = inputs
        if not inputs:
            from yugabyte_tpu_torch.storage.compaction import CompactionResult
            job.staged = None
            self._finish(job, result=CompactionResult(
                [], job.dropped_rows, 0))
            return
        cache = req.device_cache
        ids = req.input_ids
        if cache is not None and ids is not None:
            # keep the id pairing aligned with the FILTERED list
            id_of = {id(r): fid for r, fid in zip(req.inputs, ids)}
            ids = [id_of[id(r)] for r in inputs]
            for fid in ids:
                if cache.pin(fid):
                    job.pins.append(fid)
        job.slabs = [r.read_all() for r in inputs]
        job.slabs = [s for s in job.slabs if s.n]
        resident = (cache is not None and ids is not None
                    and all(cache.contains(fid) for fid in ids))
        if resident:
            from yugabyte_tpu_torch.ops.run_merge import stage_runs_from_staged
            staged_list = [cache.get(fid) for fid in ids]
            if all(st is not None for st in staged_list):
                job.staged = stage_runs_from_staged(staged_list)
                return
        b = pool_slot_bucket(job.slabs)
        job.staged = stage_pool_slot(job.slabs, *b)

    def _unpin(self, job: _Job) -> None:
        cache = job.request.device_cache
        if cache is not None:
            for fid in job.pins:
                cache.unpin(fid)
        job.pins = []

    def _run_wave(self, bucket: Tuple[int, int, int], is_major: bool,
                  retain_deletes: bool, group: List[_Job]) -> None:
        from yugabyte_tpu_torch.ops import device_faults
        from yugabyte_tpu_torch.ops.merge_gc import GCParams
        from yugabyte_tpu_torch.parallel.dist_compact import pooled_merge_gc
        from yugabyte_tpu_torch.storage.bucket_health import health_board
        board = health_board()

        # waves are mesh-slot sized; a larger group runs in several
        waves = [group[i:i + self.n_slots]
                 for i in range(0, len(group), self.n_slots)]
        for wave in waves:
            with self._lock:
                self._last_fill = len(wave) / self.n_slots
            self._g_fill.set(len(wave) / self.n_slots)
            t0 = time.monotonic()
            try:
                handle = pooled_merge_gc(
                    self.mesh,
                    [(job.staged,
                      GCParams(job.request.history_cutoff_ht, is_major,
                               retain_deletes))
                     for job in wave])
            except Exception as e:  # noqa: BLE001 — wave fault containment
                if not device_faults.is_device_fault(e):
                    for job in wave:
                        self._unpin(job)
                        self._finish(job, exc=e)
                    continue
                # one shard's fault quarantines the BUCKET and completes
                # every wave job natively — co-scheduled tablets' jobs
                # finish byte-identically instead of aborting
                self._c_faults.increment()
                board.record_fault(
                    "run_merge_fused", (bucket[0], bucket[1]),
                    reason=f"pool wave fault: {type(e).__name__}: {e}")
                TRACE("compaction pool: wave device fault (%r) — bucket "
                      "k_pad=%d m=%d quarantined; completing %d job(s) "
                      "natively", e, bucket[0], bucket[1], len(wave))
                for job in wave:
                    self._complete_natively(job, record_rate=False)
                continue
            self._c_waves.increment()
            wall = max(time.monotonic() - t0, 1e-9)
            rows = sum(job.staged.n for job in wave)
            board.record_device("run_merge_fused",
                                (bucket[0], bucket[1]), rows, wall)
            for slot, job in enumerate(wave):
                self._c_wave_jobs.increment()
                try:
                    self._finish_wave_job(job, handle, slot)
                except BaseException as e:  # noqa: BLE001 — per-job
                    self._finish(job, exc=e)
                finally:
                    self._unpin(job)

    def _finish_wave_job(self, job: _Job, handle, slot: int) -> None:
        """Stage C of one wave job: write outputs from the slot's
        decisions through the sequential writer rules (byte-identical),
        installing survivor spans from the slot's device into the
        tablet's cache partition as each SST hits disk."""
        from yugabyte_tpu_torch.storage.compaction import (
            CompactionResult, run_compaction_job_with_decisions)
        job.handle.cancel_token.check()
        perm, keep, mk = handle.decisions[slot]
        surv = perm[keep]
        mk_surv = mk[keep]
        req = job.request
        if req.slabs is not None:
            # merge-only job: the decisions ARE the result
            self._finish(job, result=(surv, mk_surv))
            return
        rows_in = sum(s.n for s in job.slabs) + job.dropped_rows
        on_span = None
        cache = req.device_cache
        installed: List[int] = []
        if cache is not None:
            in_levels = [cache.level_of(fid)
                         for fid in (req.input_ids or [])
                         if fid is not None]
            out_level = 1 + max([lv for lv in in_levels
                                 if lv is not None], default=0)

            def on_span(fid, base_path, start, end,
                        _lvl=out_level, _installed=installed):
                from yugabyte_tpu_torch.storage import integrity
                st = handle.gather_span(slot, start, end)
                target = getattr(cache, "device", None)
                if target is not None and st.cols_dev.device != target:
                    # move the span onto the partition's device so later
                    # merges never mix devices
                    st.cols_dev = st.cols_dev.to(target)
                if integrity.maybe_verify_resident_entry(st, base_path):
                    cache.put(fid, st, level=_lvl)
                    _installed.append(fid)
        try:
            result = run_compaction_job_with_decisions(
                job.filtered_inputs, job.slabs, req.out_dir,
                req.new_file_id, req.history_cutoff_ht, req.is_major,
                req.retain_deletes, req.block_entries, surv, mk_surv,
                rows_in, frontier_inputs=req.inputs,
                cancel=job.handle.cancel_token, on_span=on_span)
        except BaseException:
            # the writer deleted its files: their entries must not outlive
            # them (a cancelled or failed job installs nothing)
            for fid in installed:
                cache.drop(fid)
            raise
        self._finish(job, result=result)

    def _complete_natively(self, job: _Job, record_rate: bool) -> None:
        """Byte-identical native completion of one pool job (demoted
        bucket or wave-fault containment)."""
        from yugabyte_tpu_torch.storage import compaction as compaction_mod
        try:
            job.handle.cancel_token.check()
            req = job.request
            t0 = time.monotonic()
            if req.slabs is not None:
                # merge-only job: the CPU baseline computes the identical
                # decisions (differential-tested against the kernel)
                from yugabyte_tpu_torch.ops.slabs import concat_slabs
                from yugabyte_tpu_torch.storage.cpu_baseline import (
                    compact_cpu_baseline)
                live = [s for s in job.slabs if s.n]
                merged = concat_slabs(live)
                offsets = np.concatenate(
                    ([0], np.cumsum([s.n for s in live]))).tolist()
                perm, keep, mk = compact_cpu_baseline(
                    merged, offsets, req.history_cutoff_ht, req.is_major,
                    req.retain_deletes)
                result = (perm[keep], mk[keep])
                rows = merged.n
            else:
                result = compaction_mod.run_compaction_job(
                    req.inputs, req.out_dir, req.new_file_id,
                    req.history_cutoff_ht, req.is_major,
                    req.retain_deletes, device="native",
                    block_entries=req.block_entries,
                    cancel=job.handle.cancel_token, _no_combined=True)
                rows = result.rows_in
            self._c_native.increment()
            if record_rate and job.staged is not None:
                from yugabyte_tpu_torch.storage.bucket_health import (
                    health_board)
                health_board().record_native(
                    "run_merge_fused", (job.staged.k_pad, job.staged.m),
                    rows, max(time.monotonic() - t0, 1e-9))
            self._finish(job, result=result)
        except BaseException as e:  # noqa: BLE001 — per-job containment
            self._finish(job, exc=e)
        finally:
            self._unpin(job)

    def _run_exclusive(self, job: _Job) -> None:
        """A mesh-sized job: the whole mesh, key-range-sharded
        (storage/compaction.run_compaction_job routes it through the
        dist-native path)."""
        from yugabyte_tpu_torch.storage import compaction as compaction_mod
        req = job.request
        try:
            job.handle.cancel_token.check()
            result = compaction_mod.run_compaction_job(
                req.inputs, req.out_dir, req.new_file_id,
                req.history_cutoff_ht, req.is_major, req.retain_deletes,
                device=self.device, block_entries=req.block_entries,
                device_cache=req.device_cache, input_ids=req.input_ids,
                mesh=self.mesh, cancel=job.handle.cancel_token)
            self._finish(job, result=result)
        except BaseException as e:  # noqa: BLE001 — per-job containment
            self._finish(job, exc=e)
