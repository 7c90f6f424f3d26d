"""Tablet server: hosts many replicated tablets, heartbeats to the master.

Counterpart of yugabyte_tpu/tserver/__init__.py, with the JAX package's
exports (ref: tablet_server.h:71, ts_tablet_manager.h:126,
tablet_service.cc, heartbeater.cc). `TabletServer(TabletServerOptions(
server_id, fs_root))` with no tablet-options factory builds its
`server_context.ServerExecutionContext` on the card (`tserver_device`
'auto'; raises without CUDA, no native fallback); `tserver_device="none"`,
a `device="native"` option or a native tablet factory serves device-free,
and `device="cpu"` runs the kernels' plain versions. Beside it:
`compaction_pool.CompactionPool`, the mesh pool the DB's
`DBOptions.mesh_pool` dispatches to.
"""

from yugabyte_tpu_torch.tserver.tablet_server import TabletServer, TabletServerOptions

__all__ = ["TabletServer", "TabletServerOptions"]
