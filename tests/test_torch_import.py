"""The port imports neither JAX nor the JAX package, and never quietly
runs on the CPU: without CUDA its entry points raise unless the caller
passes device='cpu'.

Every case runs in one fresh interpreter (`_RUNNER`): the import check
first, then each entry point's snippet in its own namespace with
`torch.cuda.is_available` patched to False, its outcome recorded. The
run is made once per test run, shared by pytest-xdist's workers through
a file under the run's common temporary directory, and pinned to one
thread: the tier-1 run shares the host's cores among its workers. Each
parametrised case asserts its own outcome."""

import fcntl
import json
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
    "yugabyte_tpu_torch.utils.metrics",
    "yugabyte_tpu_torch.utils.trace",
    "yugabyte_tpu_torch.utils.ybsan",
    "yugabyte_tpu_torch.utils.cancellation",
    "yugabyte_tpu_torch.utils.rate_limiter",
    "yugabyte_tpu_torch.utils.lock_rank",
    "yugabyte_tpu_torch.utils.sync_point",
    "yugabyte_tpu_torch.utils.threadpool",
    "yugabyte_tpu_torch.ops.device_faults",
    "yugabyte_tpu_torch.storage.offload_policy",
    "yugabyte_tpu_torch.storage.bucket_health",
    "yugabyte_tpu_torch.storage.integrity",
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
    "yugabyte_tpu_torch.tserver",
    "yugabyte_tpu_torch.tserver.compaction_pool",
    "yugabyte_tpu_torch.utils.latency",
    "yugabyte_tpu_torch.rpc",
    "yugabyte_tpu_torch.rpc.nemesis",
    "yugabyte_tpu_torch.rpc.codec",
    "yugabyte_tpu_torch.rpc.messenger",
    "yugabyte_tpu_torch.rpc.consensus_service",
    "yugabyte_tpu_torch.consensus",
    "yugabyte_tpu_torch.consensus.transport",
    "yugabyte_tpu_torch.consensus.raft",
    "yugabyte_tpu_torch.consensus.multi_raft_batcher",
    "yugabyte_tpu_torch.consensus.log",
    "yugabyte_tpu_torch.docdb.lock_manager",
    "yugabyte_tpu_torch.docdb.intents",
    "yugabyte_tpu_torch.docdb.conflict_resolution",
    "yugabyte_tpu_torch.docdb.intent_aware_iterator",
    "yugabyte_tpu_torch.docdb.doc_rowwise_iterator",
    "yugabyte_tpu_torch.docdb.subdocument",
    "yugabyte_tpu_torch.docdb.compaction_model",
    "yugabyte_tpu_torch.tablet",
    "yugabyte_tpu_torch.tablet.mvcc",
    "yugabyte_tpu_torch.tablet.retryable_requests",
    "yugabyte_tpu_torch.tablet.admission",
    "yugabyte_tpu_torch.tablet.tablet",
    "yugabyte_tpu_torch.tablet.tablet_peer",
    "yugabyte_tpu_torch.common.jsonb",
    "yugabyte_tpu_torch.common.wire",
    "yugabyte_tpu_torch.utils.jsonutil",
    "yugabyte_tpu_torch.utils.backoff",
    "yugabyte_tpu_torch.utils.mem_tracker",
    "yugabyte_tpu_torch.utils.timeseries",
    "yugabyte_tpu_torch.server",
    "yugabyte_tpu_torch.server.webserver",
    "yugabyte_tpu_torch.tserver.remote_bootstrap",
    "yugabyte_tpu_torch.tserver.heartbeater",
    "yugabyte_tpu_torch.tserver.tablet_memory_manager",
    "yugabyte_tpu_torch.tserver.maintenance_manager",
    "yugabyte_tpu_torch.tserver.server_context",
    "yugabyte_tpu_torch.tserver.transaction_coordinator",
    "yugabyte_tpu_torch.tserver.ts_tablet_manager",
    "yugabyte_tpu_torch.tserver.tablet_service",
    "yugabyte_tpu_torch.tserver.tablet_server",
    "chip_smoke",
    "kernel_ab",
]

# The replicated tablet's and the tablet server's modules, each imported
# first of all, under a finder that refuses jax and the JAX package
# (`_BLOCKER`): one case each.
BLOCKED_IMPORTS = [
    "yugabyte_tpu_torch.rpc.nemesis",
    "yugabyte_tpu_torch.consensus.transport",
    "yugabyte_tpu_torch.consensus.raft",
    "yugabyte_tpu_torch.consensus.multi_raft_batcher",
    "yugabyte_tpu_torch.tablet.tablet_peer",
    "yugabyte_tpu_torch.rpc.codec",
    "yugabyte_tpu_torch.rpc.messenger",
    "yugabyte_tpu_torch.rpc.consensus_service",
    "yugabyte_tpu_torch.common.jsonb",
    "yugabyte_tpu_torch.common.wire",
    "yugabyte_tpu_torch.utils.jsonutil",
    "yugabyte_tpu_torch.utils.backoff",
    "yugabyte_tpu_torch.utils.mem_tracker",
    "yugabyte_tpu_torch.utils.timeseries",
    "yugabyte_tpu_torch.server",
    "yugabyte_tpu_torch.server.webserver",
    "yugabyte_tpu_torch.tserver.remote_bootstrap",
    "yugabyte_tpu_torch.tserver.heartbeater",
    "yugabyte_tpu_torch.tserver.tablet_memory_manager",
    "yugabyte_tpu_torch.tserver.maintenance_manager",
    "yugabyte_tpu_torch.tserver.server_context",
    "yugabyte_tpu_torch.tserver.transaction_coordinator",
    "yugabyte_tpu_torch.tserver.ts_tablet_manager",
    "yugabyte_tpu_torch.tserver.tablet_service",
    "yugabyte_tpu_torch.tserver.tablet_server",
    "yugabyte_tpu_torch.tserver",
]

_BLOCKER = """
import importlib, importlib.abc, sys, traceback


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "yugabyte_tpu"):
            raise ImportError("blocked import of " + name)
        return None


sys.meta_path.insert(0, _Refuse())
blocked = {{}}
for m in {mods!r}:
    try:
        importlib.import_module(m)
        blocked[m] = [True, ""]
    except BaseException:
        blocked[m] = [False, traceback.format_exc()]
"""

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
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


# One interpreter for every case: the import check (_CHECK) before
# anything else is imported, then each case's body in a namespace of its
# own, CUDA hidden; prints {case: [ran to its end, traceback]} as JSON.
_RUNNER = """
import json, traceback
import torch
torch.set_num_threads(1)
{blocker}
{check}
torch.cuda.is_available = lambda: False
out = {{"imports": [True, repr(bad)]}}
out.update({{"blocked:" + m: v for m, v in blocked.items()}})
for case, body in {cases!r}:
    try:
        exec(compile(body, "<" + case + ">", "exec"), {{"__name__": case}})
        out[case] = [True, ""]
    except BaseException:
        out[case] = [False, traceback.format_exc()]
print("RESULTS " + json.dumps(out))
"""


def _run_all() -> dict:
    cases = ([("raises:" + k, ENTRY_POINTS[k]) for k in sorted(ENTRY_POINTS)]
             + [("cpu:" + k, CPU_CALLS[k]) for k in sorted(CPU_CALLS)])
    r = _run(_RUNNER.format(blocker=_BLOCKER.format(mods=BLOCKED_IMPORTS),
                            check=_CHECK.format(mods=MODULES), cases=cases))
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULTS ")]
    assert r.returncode == 0 and line, r.stderr
    return json.loads(line[-1][len("RESULTS "):])


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    """Every case's outcome, from one run of _RUNNER a test run: the
    first xdist worker to need it runs it under a file lock, the others
    read its result (keyed by the run's id)."""
    run_id = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if run_id is None:
        return _run_all()
    path = tmp_path_factory.getbasetemp().parent / f"port_import_{run_id}"
    with open(f"{path}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(f"{path}.json"):
            with open(f"{path}.tmp", "w") as f:
                json.dump(_run_all(), f)
            os.replace(f"{path}.tmp", f"{path}.json")
        with open(f"{path}.json") as f:
            return json.load(f)


def test_port_imports_no_jax_and_no_reference(outcomes):
    ok, bad = outcomes["imports"]
    assert ok and bad == "[]", bad


@pytest.mark.parametrize("module", BLOCKED_IMPORTS)
def test_module_imports_with_jax_blocked(module, outcomes):
    ok, err = outcomes["blocked:" + module]
    assert ok, err

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

# a tablet (k INT64 hash key, v INT64) driven through write, flush,
# compact, multi_read and scan
_TABLET = """
import sys, tempfile
from yugabyte_tpu_torch.common.schema import ColumnSchema, DataType, Schema
from yugabyte_tpu_torch.docdb.doc_key import DocKey
from yugabyte_tpu_torch.docdb.doc_operations import QLWriteOp, WriteOpKind
from yugabyte_tpu_torch.tablet.tablet import Tablet, TabletOptions
SCHEMA = Schema([ColumnSchema("k", DataType.INT64),
                 ColumnSchema("v", DataType.INT64)], num_hash_key_columns=1)

def drive(t):
    for i in range(40):
        t.write([QLWriteOp(WriteOpKind.INSERT, DocKey((i,)), {"v": i})])
        if i % 10 == 9:
            t.flush()
    t.compact()
    got = [r.to_dict(SCHEMA)["v"] for r in t.multi_read(
        [DocKey((i,)) for i in range(40)])]
    assert sorted(got) == sorted(r.to_dict(SCHEMA)["v"]
                                 for r in t.scan()), got
    t.close()
    return got
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
    "DB_default_options": """
import tempfile
from yugabyte_tpu_torch.storage.db import DB
DB(tempfile.mkdtemp())
""",
    "Tablet_on_the_card": """
import tempfile
from yugabyte_tpu_torch.common.schema import ColumnSchema, DataType, Schema
from yugabyte_tpu_torch.tablet.tablet import Tablet, TabletOptions
Tablet("t", tempfile.mkdtemp(), Schema([ColumnSchema("k", DataType.INT64)],
                                      num_hash_key_columns=1),
       options=TabletOptions(device="cuda"))
""",
    "Tablet_default_options": _TABLET + """
Tablet("t", tempfile.mkdtemp(), SCHEMA)
""",
    "TabletPeer_default_options": _TABLET + """
from yugabyte_tpu_torch.consensus.transport import LocalTransport
from yugabyte_tpu_torch.tablet.tablet_peer import TabletPeer
TabletPeer("t", tempfile.mkdtemp(), SCHEMA, "ts0", ("ts0",),
           LocalTransport())
""",
    "CompactionPool": """
from yugabyte_tpu_torch.parallel.mesh import make_mesh
from yugabyte_tpu_torch.tserver.compaction_pool import CompactionPool
CompactionPool(make_mesh())
""",
    "TabletServer_default_options": """
import tempfile
from yugabyte_tpu_torch.tserver import TabletServer, TabletServerOptions
TabletServer(TabletServerOptions("ts0", tempfile.mkdtemp()))
""",
    "ServerExecutionContext_default": """
from yugabyte_tpu_torch.tserver.server_context import ServerExecutionContext
ServerExecutionContext()
""",
    "TSTabletManager_default_factory": _TABLET + """
from yugabyte_tpu_torch.common.wire import schema_to_wire
from yugabyte_tpu_torch.consensus.transport import LocalTransport
from yugabyte_tpu_torch.tserver.ts_tablet_manager import TSTabletManager
m = TSTabletManager("ts0", tempfile.mkdtemp(), LocalTransport())
try:
    m.create_tablet("t", "tbl", schema_to_wire(SCHEMA), ["ts0"])
finally:
    m.shutdown()
""",
}

# a TabletServer's tablet (k INT64 hash key, v INT64) written, flushed,
# compacted and read through the `tserver` service, the server shut down
_TSERVER = _TABLET + """
import time
from yugabyte_tpu_torch.common.wire import (doc_key_to_wire, schema_to_wire,
                                            write_op_to_wire)
from yugabyte_tpu_torch.tserver import TabletServer, TabletServerOptions

def serve(ts):
    try:
        ts.tablet_manager.create_tablet("t", "tbl", schema_to_wire(SCHEMA),
                                        ["ts0"])
        p = ts.tablet_manager.get_tablet("t")
        p.raft.start_election(ignore_lease=True)
        deadline = time.monotonic() + 30
        while not (p.raft.is_leader() and p.raft.leader_ready()):
            assert time.monotonic() < deadline, "no leader"
            time.sleep(0.01)
        svc = ts.service
        for f in range(3):
            svc.write("t", [write_op_to_wire(QLWriteOp(
                WriteOpKind.INSERT, DocKey((i,)), {"v": i + f}))
                for i in range(20)])
            svc.flush_tablet("t")
        svc.compact_tablet("t")
        rows = svc.multi_read("t", [doc_key_to_wire(DocKey((i,)))
                                    for i in range(20)])["rows"]
        assert [r["columns"][0] for r in rows] == [i + 2 for i in range(20)]
        return p.tablet.regular_db
    finally:
        ts.shutdown()
"""


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_cuda_raises(name, outcomes):
    ran, err = outcomes["raises:" + name]
    assert not ran
    assert "no CUDA device is available" in err, err


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
assert point_read.point_read_metrics()["batches"].value() == 1
db.close()
shutil.rmtree(d)
""",
    "DB_compaction_and_scans": """
import shutil, sys, tempfile
from yugabyte_tpu_torch.common.hybrid_time import DocHybridTime, HybridTime
from yugabyte_tpu_torch.parallel.mesh import make_mesh
from yugabyte_tpu_torch.storage.db import DB, DBOptions
from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
from yugabyte_tpu_torch.tserver.compaction_pool import CompactionPool
d = tempfile.mkdtemp()
pool = CompactionPool(make_mesh(2, devices=["cpu"] * 2))
db = DB(d, DBOptions(device="cpu", mesh_pool=pool,
                     device_cache=DeviceSlabCache("cpu"),
                     retention_policy=lambda: HybridTime.kMax.value))
for f in range(4):
    db.write_batch([(b"k%d" % i, DocHybridTime(HybridTime((9 + f) << 12), 0),
                     b"v%d" % f) for i in range(3)])
    db.flush()
assert db.n_live_files == 1, db.n_live_files
assert pool.snapshot()["wave_jobs"] == 1
got = list(db.scan_visible(HybridTime.kMax.value - 1))
assert [(k, v) for k, v, _h in got] == [(b"k%d" % i, b"v3") for i in range(3)]
db.close()
pool.shutdown()
shutil.rmtree(d)
assert not any(m in ("jax", "yugabyte_tpu")
               or m.startswith(("jax.", "yugabyte_tpu."))
               for m in sys.modules), "the DB imported jax"
""",
    "Tablet_native_is_device_free": _TABLET + """
t = Tablet("t", tempfile.mkdtemp(), SCHEMA,
           options=TabletOptions(device="native"))
rows = drive(t)
assert t.regular_db.opts.device == "native" and rows == list(range(40))
assert not any(m in ("jax", "yugabyte_tpu")
               or m.startswith(("jax.", "yugabyte_tpu."))
               for m in sys.modules), "the tablet imported jax"
""",
    "TabletPeer_native_replicates": _TABLET + """
import time
from yugabyte_tpu_torch.consensus.transport import LocalTransport
from yugabyte_tpu_torch.tablet.tablet_peer import TabletPeer
p = TabletPeer("t", tempfile.mkdtemp(), SCHEMA, "ts0", ("ts0",),
               LocalTransport(), options=TabletOptions(device="native"))
p.start(election_timer=False)
p.raft.start_election(ignore_lease=True)
deadline = time.monotonic() + 30
while not (p.raft.is_leader() and p.raft.leader_ready()):
    assert time.monotonic() < deadline, "no leader"
    time.sleep(0.01)
p.write([QLWriteOp(WriteOpKind.INSERT, DocKey((i,)), {"v": i})
         for i in range(10)])
assert [r.to_dict(SCHEMA)["v"] for r in p.multi_read(
    [DocKey((i,)) for i in range(10)])] == list(range(10))
p.shutdown()
""",
    "TabletServer_cpu": _TSERVER + """
db = serve(TabletServer(TabletServerOptions("ts0", tempfile.mkdtemp(),
                                            device="cpu")).start())
assert db._device_cache is not None and db.n_live_files == 1
assert not any(m in ("jax", "yugabyte_tpu")
               or m.startswith(("jax.", "yugabyte_tpu."))
               for m in sys.modules), "the tablet server imported jax"
""",
    "TabletServer_tserver_device_none": _TSERVER + """
from yugabyte_tpu_torch.utils import flags
flags.set_flag("tserver_device", "none")
try:
    ts = TabletServer(TabletServerOptions("ts0", tempfile.mkdtemp(),
                                          webserver_port=None))
finally:
    flags.reset_flag("tserver_device")
assert ts.exec_context.device == "native"
assert serve(ts.start()).opts.device == "native"
""",
    "Tablet_cpu": _TABLET + """
from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
t = Tablet("t", tempfile.mkdtemp(), SCHEMA, options=TabletOptions(
    device="cpu", device_cache=DeviceSlabCache("cpu")))
assert drive(t) == list(range(40))
""",
}


@pytest.mark.parametrize("name", sorted(CPU_CALLS))
def test_entry_point_with_explicit_cpu_runs(name, outcomes):
    ran, err = outcomes["cpu:" + name]
    assert ran, err
