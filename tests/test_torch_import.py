"""The port imports neither JAX nor the JAX package, and never quietly
runs on the CPU: without CUDA its entry points raise unless the caller
passes device='cpu'."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "yugabyte_tpu_torch",
    "yugabyte_tpu_torch.utils.flags",
    "yugabyte_tpu_torch.utils.status",
    "yugabyte_tpu_torch.utils.env",
    "yugabyte_tpu_torch.utils.native_build",
    "yugabyte_tpu_torch.utils.torch_setup",
    "yugabyte_tpu_torch.common.hybrid_time",
    "yugabyte_tpu_torch.common.partition",
    "yugabyte_tpu_torch.common.schema",
    "yugabyte_tpu_torch.docdb.value_type",
    "yugabyte_tpu_torch.docdb.doc_key",
    "yugabyte_tpu_torch.docdb.value",
    "yugabyte_tpu_torch.docdb.doc_operations",
    "yugabyte_tpu_torch.docdb.scan_spec",
    "yugabyte_tpu_torch.ops.slabs",
    "yugabyte_tpu_torch.ops.merge_gc",
    "yugabyte_tpu_torch.ops.merge_path",
    "yugabyte_tpu_torch.ops.run_merge",
    "yugabyte_tpu_torch.ops.point_read",
    "yugabyte_tpu_torch.ops.block_codec",
    "yugabyte_tpu_torch.ops.radix",
    "yugabyte_tpu_torch.ops.scan",
    "yugabyte_tpu_torch.ops.pushdown",
    "yugabyte_tpu_torch.storage.bloom",
    "yugabyte_tpu_torch.storage.block_format",
    "yugabyte_tpu_torch.storage.sst",
    "yugabyte_tpu_torch.storage.cpu_baseline",
    "yugabyte_tpu_torch.storage.native_engine",
    "yugabyte_tpu_torch.storage.compaction",
    "yugabyte_tpu_torch.storage.device_cache",
    "yugabyte_tpu_torch.storage.learned_index",
    "yugabyte_tpu_torch.storage.memtable",
    "yugabyte_tpu_torch.storage.version_set",
    "yugabyte_tpu_torch.storage.native_read",
    "yugabyte_tpu_torch.storage.db",
    "yugabyte_tpu_torch.parallel",
    "yugabyte_tpu_torch.parallel.mesh",
    "yugabyte_tpu_torch.parallel.dist_compact",
    "chip_smoke",
    "kernel_ab",
]

_CHECK = """
import sys
mods = {mods!r}
import importlib
for m in mods:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "yugabyte_tpu" or m.startswith("yugabyte_tpu."))
print("BAD", bad)
"""


def _run(code):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax_and_no_reference():
    r = _run(_CHECK.format(mods=MODULES))
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


_NO_CUDA = """
import torch
torch.cuda.is_available = lambda: False
{body}
"""

# one row (liveness + v = 5) of a table (h INT64 hash key, v INT64)
_PUSHDOWN = """
from yugabyte_tpu_torch.common.schema import ColumnSchema, DataType, Schema
from yugabyte_tpu_torch.docdb import scan_spec
from yugabyte_tpu_torch.docdb.doc_key import DocKey
from yugabyte_tpu_torch.docdb.doc_operations import QLWriteOp, WriteOpKind
from yugabyte_tpu_torch.ops import scan
from yugabyte_tpu_torch.ops.slabs import pack_kvs
SCHEMA = Schema([ColumnSchema("h", DataType.INT64),
                 ColumnSchema("v", DataType.INT64)], num_hash_key_columns=1)
KVS = QLWriteOp(WriteOpKind.INSERT, DocKey((7,)), {"v": 5}).to_kv_pairs(SCHEMA)
SRC = [scan.SlabSource(pack_kvs([(k, ((5 << 12) << 32) | i, v)
                                 for i, (k, v) in enumerate(KVS)]), True)]
SPEC = scan_spec.ScanSpec(
    (scan_spec.compile_predicate(SCHEMA, "v", ">", 1),),
    (scan_spec.compile_aggregate(SCHEMA, "count", None),
     scan_spec.compile_aggregate(SCHEMA, "sum", "v")))
"""

# a mesh of two CUDA shards, built without make_mesh's own check
_CUDA_MESH = """
import torch
from yugabyte_tpu_torch.ops.merge_gc import GCParams
from yugabyte_tpu_torch.ops.slabs import pack_kvs
from yugabyte_tpu_torch.parallel.mesh import Mesh
MESH = Mesh([torch.device("cuda", 0)] * 2)
SLAB = pack_kvs([(b"k", 1 << 32, b"\\x01")])
"""

ENTRY_POINTS = {
    "make_mesh": """
from yugabyte_tpu_torch.parallel.mesh import make_mesh
make_mesh()
""",
    "make_mesh_cuda_devices": """
from yugabyte_tpu_torch.parallel.mesh import make_mesh
make_mesh(8, devices=["cuda"] * 8)
""",
    "distributed_compact": _CUDA_MESH + """
from yugabyte_tpu_torch.parallel.dist_compact import distributed_compact
distributed_compact(SLAB, GCParams(1, True), MESH)
""",
    "pooled_merge_gc": _CUDA_MESH + """
from yugabyte_tpu_torch.parallel.dist_compact import (
    pool_slot_bucket, pooled_merge_gc, stage_pool_slot)
st = stage_pool_slot([SLAB], *pool_slot_bucket([SLAB]))
pooled_merge_gc(MESH, [(st, GCParams(1, True))])
""",
    "resolve_device": """
from yugabyte_tpu_torch.utils.torch_setup import resolve_device
resolve_device()
""",
    "stage_slab": """
from yugabyte_tpu_torch.ops.merge_gc import stage_slab
from yugabyte_tpu_torch.ops.slabs import pack_kvs
stage_slab(pack_kvs([(b"k", 1 << 32, b"\\x01")]))
""",
    "stage_runs_from_slabs": """
from yugabyte_tpu_torch.ops.run_merge import stage_runs_from_slabs
from yugabyte_tpu_torch.ops.slabs import pack_kvs
stage_runs_from_slabs([pack_kvs([(b"k", 1 << 32, b"\\x01")])])
""",
    "decode_file_to_staged": """
from yugabyte_tpu_torch.ops.block_codec import (RawFileBlocks,
                                                 decode_file_to_staged)
decode_file_to_staged(RawFileBlocks(1, 1, None, None, [], []))
""",
    "run_compaction_job_device_native": """
from yugabyte_tpu_torch.storage.compaction import (
    run_compaction_job_device_native)
run_compaction_job_device_native([], ".", lambda: 1, 0, True)
""",
    "run_compaction_job": """
from yugabyte_tpu_torch.storage.compaction import run_compaction_job
from yugabyte_tpu_torch.storage.sst import Frontier, SSTReader, SSTWriter
from yugabyte_tpu_torch.ops.slabs import pack_kvs
import os, tempfile
d = tempfile.mkdtemp()
p = os.path.join(d, "000001.sst")
SSTWriter(p).write(pack_kvs([(b"k", 1 << 32, b"\\x01")]), Frontier())
run_compaction_job([SSTReader(p)], d, lambda: 2, 1 << 40, True)
""",
    "merge_and_gc_device": """
from yugabyte_tpu_torch.ops.merge_gc import GCParams, merge_and_gc_device
from yugabyte_tpu_torch.ops.slabs import pack_kvs
merge_and_gc_device(pack_kvs([(b"k", 1 << 32, b"\\x01")]), GCParams(1, True))
""",
    "visible_entries": """
from yugabyte_tpu_torch.ops.scan import visible_entries
from yugabyte_tpu_torch.ops.slabs import pack_kvs
list(visible_entries([pack_kvs([(b"k", 1 << 32, b"\\x01")])], 1 << 40))
""",
    "filtered_entries_sources": _PUSHDOWN + """
scan.filtered_entries_sources(SRC, 1 << 40, SPEC)
""",
    "aggregate_sources": _PUSHDOWN + """
scan.aggregate_sources(SRC, 1 << 40, SPEC)
""",
    "DeviceSlabCache": """
from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
DeviceSlabCache()
""",
    "DB_multi_get": """
import tempfile
from yugabyte_tpu_torch.storage.db import DB, DBOptions
DB(tempfile.mkdtemp(), DBOptions(auto_compact=False))
""",
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_cuda_raises(name):
    r = _run(_NO_CUDA.format(body=ENTRY_POINTS[name]))
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr, r.stderr


CPU_CALLS = {
    "mesh_jobs": """
import sys
from yugabyte_tpu_torch.ops.merge_gc import GCParams
from yugabyte_tpu_torch.ops.slabs import pack_kvs
from yugabyte_tpu_torch.parallel import dist_compact
from yugabyte_tpu_torch.parallel.mesh import make_mesh
mesh = make_mesh(2, devices=["cpu"] * 2)
slab = pack_kvs([(b"k%d" % i, (5 + i) << 32, b"\\x01") for i in range(9)])
_cols, keep, _mk, src = dist_compact.distributed_compact(
    slab, GCParams(1 << 40, True), mesh)
assert sorted(src[keep]) == list(range(9)), src[keep]
st = dist_compact.stage_pool_slot([slab], *dist_compact.pool_slot_bucket([slab]))
h = dist_compact.pooled_merge_gc(mesh, [(st, GCParams(1 << 40, True))])
assert int(h.decisions[0][1].sum()) == 9
assert not any(m in ("jax", "yugabyte_tpu")
               or m.startswith(("jax.", "yugabyte_tpu."))
               for m in sys.modules), "the mesh path imported jax"
""",
    "stage_slab": """
from yugabyte_tpu_torch.ops.merge_gc import stage_slab
from yugabyte_tpu_torch.ops.slabs import pack_kvs
st = stage_slab(pack_kvs([(b"k", 1 << 32, b"\\x01")]), device="cpu")
assert st.cols_dev.device.type == "cpu"
""",
    "stage_runs_from_slabs": """
from yugabyte_tpu_torch.ops.run_merge import stage_runs_from_slabs
from yugabyte_tpu_torch.ops.slabs import pack_kvs
st = stage_runs_from_slabs([pack_kvs([(b"k", 1 << 32, b"\\x01")])],
                           device="cpu")
assert st.cols_dev.device.type == "cpu"
""",
    "visible_entries": """
from yugabyte_tpu_torch.ops.scan import visible_entries
from yugabyte_tpu_torch.ops.slabs import pack_kvs
got = list(visible_entries([pack_kvs([(b"k", 5 << 32, b"\\x01")])], 1 << 40,
                           device="cpu"))
assert got == [(b"k", b"\\x01", 5)], got
""",
    "filtered_entries_sources": _PUSHDOWN + """
got = list(scan.filtered_entries_sources(SRC, 1 << 40, SPEC, device="cpu"))
assert [(k, v) for k, v, _ht in got] == KVS, got
""",
    "aggregate_sources": _PUSHDOWN + """
got = scan.aggregate_sources(SRC, 1 << 40, SPEC, device="cpu")
assert got == {"rows": 1, "cols": {0: {"nonnull": 1, "sum": 5, "min": 5,
                                       "max": 5}}}, got
""",
    "run_compaction_job": """
import os, sys, tempfile
from yugabyte_tpu_torch.ops.slabs import pack_kvs
from yugabyte_tpu_torch.storage.compaction import run_compaction_job
from yugabyte_tpu_torch.storage.sst import Frontier, SSTReader, SSTWriter
d = tempfile.mkdtemp()
paths = [os.path.join(d, f"00000{i}.sst") for i in (1, 2)]
for i, p in enumerate(paths):
    SSTWriter(p).write(pack_kvs([(b"k", (5 + i) << 32, b"\\x01")]),
                       Frontier())
ids = iter(range(3, 99))
for dev in ("cpu", "native"):
    out = os.path.join(d, dev)
    os.mkdir(out)
    res = run_compaction_job([SSTReader(p) for p in paths], out,
                             lambda: next(ids), 1 << 40, True, device=dev)
    assert (res.rows_in, res.rows_out) == (2, 1), res
assert not any(m in ("jax", "yugabyte_tpu")
               or m.startswith(("jax.", "yugabyte_tpu."))
               for m in sys.modules), "the router imported jax"
""",
    "DB_multi_get": """
import shutil, tempfile
from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime, HybridTime
from yugabyte_tpu_torch.ops import point_read
from yugabyte_tpu_torch.storage.db import DB, DBOptions
from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
d = tempfile.mkdtemp()
db = DB(d, DBOptions(device="cpu", device_cache=DeviceSlabCache("cpu"),
                     auto_compact=False))
db.write_batch([(b"k", DocHybridTime(HybridTime(5 << 12), 0), b"\x01")])
db.flush()
got = db.multi_get([b"k", b"j"])
assert [g and (g[0].ht.value, g[1]) for g in got] == [(5 << 12, b"\x01"),
                                                        None], got
assert point_read.point_read_metrics()["batches"] == 1
db.close()
shutil.rmtree(d)
""",
}


@pytest.mark.parametrize("name", sorted(CPU_CALLS))
def test_entry_point_with_explicit_cpu_runs(name):
    r = _run(_NO_CUDA.format(body=CPU_CALLS[name]))
    assert r.returncode == 0, r.stderr
