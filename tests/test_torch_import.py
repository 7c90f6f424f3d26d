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
    "yugabyte_tpu_torch.docdb.value_type",
    "yugabyte_tpu_torch.docdb.doc_key",
    "yugabyte_tpu_torch.docdb.value",
    "yugabyte_tpu_torch.ops.slabs",
    "yugabyte_tpu_torch.ops.merge_gc",
    "yugabyte_tpu_torch.ops.merge_path",
    "yugabyte_tpu_torch.ops.run_merge",
    "yugabyte_tpu_torch.storage.bloom",
    "yugabyte_tpu_torch.storage.block_format",
    "yugabyte_tpu_torch.storage.sst",
    "yugabyte_tpu_torch.storage.cpu_baseline",
    "yugabyte_tpu_torch.storage.native_engine",
    "yugabyte_tpu_torch.storage.compaction",
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

ENTRY_POINTS = {
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
    "run_compaction_job_device_native": """
from yugabyte_tpu_torch.storage.compaction import (
    run_compaction_job_device_native)
run_compaction_job_device_native([], ".", lambda: 1, 0, True)
""",
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_cuda_raises(name):
    r = _run(_NO_CUDA.format(body=ENTRY_POINTS[name]))
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr, r.stderr


CPU_CALLS = {
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
}


@pytest.mark.parametrize("name", sorted(CPU_CALLS))
def test_entry_point_with_explicit_cpu_runs(name):
    r = _run(_NO_CUDA.format(body=CPU_CALLS[name]))
    assert r.returncode == 0, r.stderr
