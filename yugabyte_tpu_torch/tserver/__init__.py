"""The tablet server's device services. `compaction_pool.CompactionPool`
(counterpart of yugabyte_tpu/tserver/compaction_pool.py) is the mesh
pool the DB's `DBOptions.mesh_pool` dispatches to; the tablet server
itself comes with the device-free rest (ROADMAP queue A)."""
