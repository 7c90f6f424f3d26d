"""Disk-to-disk compaction of the PyTorch port against the JAX package.

The port's `run_compaction_job_device_native` runs on the CPU here (the
plain PyTorch versions of its kernels). Its output SST files, base and
data, must be byte-identical to the JAX package's
`run_compaction_job_device_native` with the device codec off
(YBTPU_DEVICE_CODEC=0) and to the stock native CompactionJob
(`_run_native_job`) over the same input files. Inputs are made from a seed
with numpy and written once; both packages read the same files.
"""

import os

import numpy as np
import pytest
import torch

from tests.test_run_merge import _make_run
from yugabyte_tpu.ops.slabs import ValueArray
from yugabyte_tpu.storage import compaction as ref_compaction
from yugabyte_tpu.storage.sst import Frontier, SSTReader, SSTWriter
from yugabyte_tpu.utils import flags as ref_flags
from yugabyte_tpu_torch.storage import compaction as port_compaction
from yugabyte_tpu_torch.storage.sst import SSTReader as PortSSTReader
from yugabyte_tpu_torch.utils import flags as port_flags
from yugabyte_tpu_torch.utils import env as port_env

# The tier-1 run shares the host's cores among its workers: one intra-op
# thread keeps these small tensors from starving the cluster tests
# running beside them.
torch.set_num_threads(1)

CUTOFF = (1 << 21) << 12


@pytest.fixture(autouse=True)
def _codec_off(monkeypatch):
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "0")


def _mk_run(rng, n, key_space, ttl_frac=0.0, tomb_frac=0.1):
    slab = _make_run(rng, n, key_space, ttl_frac=ttl_frac,
                     tomb_frac=tomb_frac)
    vb = 12
    slab.values = ValueArray(
        rng.integers(0, 256, size=n * vb, dtype=np.uint8),
        np.arange(n + 1, dtype=np.int64) * vb)
    return slab


def _write_inputs(workdir, runs):
    paths = []
    for i, slab in enumerate(runs):
        p = os.path.join(workdir, f"in{i:03d}.sst")
        SSTWriter(p).write(slab, Frontier(op_id_min=(1, i), op_id_max=(1, i + 5),
                                          ht_min=1, ht_max=100 + i))
        paths.append(p)
    return paths


def _files(outputs):
    out = []
    for _fid, base, _props in outputs:
        for p in (base, base + ".sblock.0"):
            with open(p, "rb") as f:
                out.append((os.path.basename(p), f.read()))
    return out


def _run_three(tmp_path, runs, cutoff, is_major, retain_deletes=False):
    paths = _write_inputs(str(tmp_path), runs)
    results = {}
    for name in ("ref", "port", "native"):
        out_dir = tmp_path / name
        out_dir.mkdir()
        ids = iter(range(100, 1000))
        if name == "ref":
            readers = [SSTReader(p) for p in paths]
            import jax
            res = ref_compaction.run_compaction_job_device_native(
                readers, str(out_dir), lambda: next(ids), cutoff, is_major,
                retain_deletes, device=jax.devices("cpu")[0])
        elif name == "port":
            readers = [PortSSTReader(p) for p in paths]
            res = port_compaction.run_compaction_job_device_native(
                readers, str(out_dir), lambda: next(ids), cutoff, is_major,
                retain_deletes, device="cpu")
        else:
            readers = [PortSSTReader(p) for p in paths]
            res = port_compaction._run_native_job(
                readers, str(out_dir), lambda: next(ids), cutoff, is_major,
                retain_deletes, None)
        results[name] = (res, _files(res.outputs))
    ref, port, native = results["ref"], results["port"], results["native"]
    assert port[0].rows_in == ref[0].rows_in == native[0].rows_in
    assert port[0].rows_out == ref[0].rows_out == native[0].rows_out
    assert port[0].tombstones_written == ref[0].tombstones_written
    assert [n for n, _ in port[1]] == [n for n, _ in ref[1]]
    for (name, a), (_, b), (_, c) in zip(port[1], ref[1], native[1]):
        assert a == b, f"{name}: port differs from the JAX package"
        assert a == c, f"{name}: port differs from the native job"
    assert port[1], "the job wrote no output"
    return port[0]


@pytest.mark.parametrize("k,seed", [(1, 0), (2, 1), (3, 2), (4, 3), (8, 4)])
@pytest.mark.parametrize("is_major", [True, False])
def test_byte_identical_runs(tmp_path, k, seed, is_major):
    rng = np.random.default_rng(seed)
    runs = [_mk_run(rng, 600, key_space=900) for _ in range(k)]
    cutoff = CUTOFF if is_major else (1 << 19) << 12
    res = _run_three(tmp_path, runs, cutoff, is_major)
    assert res.rows_out > 0


@pytest.mark.parametrize("is_major", [True, False])
def test_byte_identical_ttl(tmp_path, is_major):
    rng = np.random.default_rng(13)
    runs = [_mk_run(rng, 800, key_space=700, ttl_frac=0.4, tomb_frac=0.2)
            for _ in range(3)]
    res = _run_three(tmp_path, runs, (1 << 22) << 12, is_major)
    if not is_major:
        assert res.tombstones_written > 0


def test_byte_identical_retain_deletes(tmp_path):
    rng = np.random.default_rng(17)
    runs = [_mk_run(rng, 700, key_space=500, tomb_frac=0.3)
            for _ in range(4)]
    _run_three(tmp_path, runs, CUTOFF, True, retain_deletes=True)


def test_byte_identical_unequal_runs(tmp_path):
    rng = np.random.default_rng(19)
    runs = [_mk_run(rng, n, key_space=1500) for n in (2000, 1100, 900, 1500)]
    _run_three(tmp_path, runs, CUTOFF, True)


def test_byte_identical_multi_file_split(tmp_path):
    rng = np.random.default_rng(23)
    runs = [_mk_run(rng, 1500, key_space=6000) for _ in range(4)]
    keys = "compaction_max_output_entries_per_sst"
    old_ref, old_port = ref_flags.get_flag(keys), port_flags.get_flag(keys)
    ref_flags.set_flag(keys, 1000)
    port_flags.set_flag(keys, 1000)
    try:
        _run_three(tmp_path, runs, CUTOFF, True)
    finally:
        ref_flags.set_flag(keys, old_ref)
        port_flags.set_flag(keys, old_port)


def test_outside_the_slice_raises(tmp_path):
    rng = np.random.default_rng(29)
    skewed = [_mk_run(rng, n, key_space=3000) for n in (3000, 40, 40, 40, 40)]
    paths = _write_inputs(str(tmp_path), skewed)
    readers = [PortSSTReader(p) for p in paths]
    ids = iter(range(100, 200))
    with pytest.raises(NotImplementedError, match="radix"):
        port_compaction.run_compaction_job_device_native(
            readers, str(tmp_path), lambda: next(ids), CUTOFF, True,
            device="cpu")
    with pytest.raises(NotImplementedError, match="cache"):
        port_compaction.run_compaction_job_device_native(
            readers[:1], str(tmp_path), lambda: next(ids), CUTOFF, True,
            device="cpu", device_cache=object())

    class _Encrypted(port_env.Env):
        encrypted = True

    old = port_env.get_env()
    port_env.set_env(_Encrypted())
    try:
        with pytest.raises(NotImplementedError, match="encrypted"):
            port_compaction.run_compaction_job_device_native(
                readers[:1], str(tmp_path), lambda: next(ids), CUTOFF, True,
                device="cpu")

    finally:
        port_env.set_env(old)
