"""ServerExecutionContext: the server-wide device dispatch seam.

Counterpart of yugabyte_tpu/tserver/server_context.py, with the imports
renamed. Capability parity with the reference's shared background-work
machinery: every tablet's compactions run as tasks on ONE server-wide
priority pool (ref: rocksdb/db/db_impl.cc:201-440 CompactionTask/FlushTask
on yb::PriorityThreadPool; util/priority_thread_pool.h:61; pool sizing
flag `priority_thread_pool_size`, docdb/docdb_rocksdb_util.cc:137), and
all tablets share one block cache (ref: db/table_cache.cc).

The context also owns the shared device, the device-resident
DeviceSlabCache and the health board, so every tablet's compaction rides
one device queue and one staged-slab working set.

The device, and the one divergence from the JAX package: the JAX
`resolve_device` probes its backend on a watchdog thread and falls back
to the native C++ path on a failure or a timeout. The port keeps no such
fallback: `tserver_device="auto"` (the default) takes the first CUDA
card through `utils/torch_setup` and raises its error when the server
is built without CUDA; with more than one visible card it also builds a
`parallel.mesh.make_mesh()` mesh over a power of two of them. `"none"`
is the native path. An explicit `device=` ("cpu" for the kernels' plain
versions, as the tests run it; "cuda"; "native") is used as given.
"""

from __future__ import annotations

from typing import Optional

from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
from yugabyte_tpu_torch.storage.sst import BlockCache
from yugabyte_tpu_torch.tablet.tablet import TabletOptions
from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils import torch_setup
from yugabyte_tpu_torch.utils.metrics import MetricRegistry
from yugabyte_tpu_torch.utils.threadpool import PriorityThreadPool
from yugabyte_tpu_torch.utils.trace import TRACE

flags.define_flag("tserver_compaction_pool_size", 2,
                  "worker threads in the shared server-wide compaction pool "
                  "(ref priority_thread_pool_size, "
                  "docdb_rocksdb_util.cc:137)")
flags.define_flag("tserver_device", "auto",
                  "device for the compaction/scan/point-read kernels: "
                  "'auto' (the first CUDA card; raises without CUDA), "
                  "'none' (native C++ merge+GC only)")
flags.define_flag("block_cache_bytes", 256 << 20,
                  "host RAM budget for the shared decoded-block cache "
                  "(ref block cache sizing, docdb_rocksdb_util.cc)")
flags.define_flag("tserver_mesh_compaction_pool", 1,
                  "schedule device-routed compactions through the "
                  "mesh-sharded multi-tablet pool "
                  "(tserver/compaction_pool.py) when a >1-device mesh "
                  "is visible; 0 = inline per-tablet device dispatch")


def resolve_device(mode: str):
    """Resolve (shared device, mesh-or-None), or ('native', None).

    'auto' takes the first CUDA card and raises torch_setup's error
    without CUDA (no native fallback). With more than one visible card a
    mesh over a power of two of them is returned too: large compactions
    fan subcompactions across it (parallel/dist_compact.py)."""
    if mode == "none":
        return "native", None
    if mode != "auto":
        raise ValueError(f"tserver_device: unknown mode {mode!r}")
    import torch
    device = torch_setup.resolve_device(None)
    mesh = None
    mesh_n = 1
    n = torch.cuda.device_count()
    if n > 1:
        from yugabyte_tpu_torch.parallel.mesh import make_mesh
        # power-of-two shard count: run-padding and the exchange's
        # capacity math assume it
        mesh_n = 1 << (n.bit_length() - 1)
        mesh = make_mesh(mesh_n)
    TRACE("server device: %s (mesh devices: %d)", device, mesh_n)
    return device, mesh


class ServerExecutionContext:  # yblint: disable=ybsan-coverage (set-once-in-__init__ config holder, read-only after construction; the pools/caches it owns carry their own guarded-by annotations)
    """One per TabletServer process; every hosted tablet's TabletOptions
    come from here so compaction pool, device, slab cache and block
    cache are shared server-wide."""

    def __init__(self, metrics: Optional[MetricRegistry] = None,
                 device=None):
        if device is not None:
            self.device, self.mesh = device, None
        else:
            self.device, self.mesh = resolve_device(
                flags.get_flag("tserver_device"))
        self.device_cache = None
        if self.device != "native":
            # capacity rides --device_cache_capacity_bytes (defined by
            # storage/device_cache.py, the flag's single owner)
            self.device_cache = DeviceSlabCache(self.device)
        self.pool = PriorityThreadPool(
            max_threads=flags.get_flag("tserver_compaction_pool_size"),
            name="compact")
        # mesh-sharded multi-tablet compaction pool: device-routed
        # compactions from every hosted tablet share the mesh through
        # batch-slot waves / whole-mesh dist jobs
        self.compaction_pool = None
        if self.mesh is not None \
                and flags.get_flag("tserver_mesh_compaction_pool"):
            from yugabyte_tpu_torch.tserver.compaction_pool import (
                CompactionPool)
            self.compaction_pool = CompactionPool(self.mesh,
                                                  device=self.device)
        self.block_cache = BlockCache(flags.get_flag("block_cache_bytes"))
        # the live device-vs-native routing authority: one process-wide
        # health record per (kernel family, shape bucket)
        from yugabyte_tpu_torch.storage.bucket_health import health_board
        self.health_board = health_board()
        self.offload_policy = self.health_board
        self._entity = None
        if metrics is not None:
            e = metrics.entity("server", "execution")
            self._g_queue = e.gauge("compaction_pool_queue_depth",
                                    "queued background compactions")
            self._g_active = e.gauge("compaction_pool_active_count",
                                     "running background compactions")
            self._entity = e

    def prewarm_op(self):
        """The one-shot maintenance op that builds and launches the
        common kernel shape buckets at startup (flag-gated; see
        tserver/maintenance_manager.PrewarmKernelsOp) on this server's
        device. None when this server is native — that path launches
        nothing."""
        if self.device == "native":
            return None
        from yugabyte_tpu_torch.tserver.maintenance_manager import (
            PrewarmKernelsOp)
        return PrewarmKernelsOp(mesh=self.mesh, device=self.device)

    def tablet_options(self) -> TabletOptions:
        return TabletOptions(device=self.device,
                             mesh=self.mesh,
                             offload_policy=self.offload_policy,
                             device_cache=self.device_cache,
                             compaction_pool=self.pool,
                             mesh_pool=self.compaction_pool,
                             block_cache=self.block_cache)

    def refresh_metrics(self) -> None:
        if self._entity is None:
            return
        self._g_queue.set(self.pool.queue_depth())
        self._g_active.set(self.pool.active_count())

    def shutdown(self) -> None:
        if self.compaction_pool is not None:
            self.compaction_pool.shutdown()
        self.pool.shutdown(wait=False)
