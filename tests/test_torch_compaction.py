"""Disk-to-disk compaction of the PyTorch port against the JAX package.

The port's `run_compaction_job_device_native` runs on the CPU here (the
plain PyTorch versions of its kernels). Its output SST files, base and
data, must be byte-identical to the JAX package's
`run_compaction_job_device_native`, with the device codec off
(YBTPU_DEVICE_CODEC=0) and on, and to the stock native CompactionJob
(`_run_native_job`) over the same input files. The router
`run_compaction_job` is held against the JAX package's on each of its
routes (the Python path, an explicit device, "native", a skewed pick, the
radix override, deep documents, chunked subcompactions). Inputs are made
from a seed with numpy and written once; both packages read the same
files.
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
from yugabyte_tpu_torch.parallel.mesh import make_mesh
from yugabyte_tpu_torch.storage import compaction as port_compaction
from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
from yugabyte_tpu_torch.storage.run_cache import (NamespacedRunCache,
                                                  NativeRunCache)
from yugabyte_tpu_torch.storage.sst import SSTReader as PortSSTReader
from yugabyte_tpu_torch.utils import flags as port_flags
from yugabyte_tpu_torch.utils import env as port_env

# The tier-1 run shares the host's cores among its workers: one intra-op
# thread keeps these small tensors from starving the cluster tests
# running beside them.
torch.set_num_threads(1)

CUTOFF = (1 << 21) << 12


@pytest.fixture(autouse=True, params=["0", "1"], ids=["shell", "codec"])
def _codec_off(request, monkeypatch):
    """Every case runs twice: with the device codec off (the native byte
    shell, YBTPU_DEVICE_CODEC=0) and on (the default), in both packages."""
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", request.param)
    return request.param


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
    """A skewed pick, once refused, now re-enters the router's radix
    route; a device cache with input_ids, once refused, now stages the
    miss and writes the outputs through at level 1 with no pin left; an
    encrypted Env still raises, naming its ROADMAP queue A item."""
    rng = np.random.default_rng(29)
    skewed = [_mk_run(rng, n, key_space=3000) for n in (3000, 40, 40, 40, 40)]
    paths = _write_inputs(str(tmp_path), skewed)
    readers = [PortSSTReader(p) for p in paths]
    ids = iter(range(100, 200))
    (tmp_path / "skewed").mkdir()
    res = port_compaction.run_compaction_job_device_native(
        readers, str(tmp_path / "skewed"), lambda: next(ids), CUTOFF, True,
        device="cpu")
    assert res.rows_in == 3160 and res.outputs
    cache = DeviceSlabCache("cpu")
    (tmp_path / "cached").mkdir()
    res = port_compaction.run_compaction_job_device_native(
        readers[:1], str(tmp_path / "cached"), lambda: next(ids), CUTOFF,
        True, device="cpu", device_cache=cache, input_ids=[7])
    assert res.outputs and cache.contains(7) and cache.pinned_count() == 0
    assert [cache.level_of(fid) for fid, _p, _pr in res.outputs] == \
        [1] * len(res.outputs)

    class _Encrypted(port_env.Env):
        encrypted = True

    old = port_env.get_env()
    port_env.set_env(_Encrypted())
    try:
        with pytest.raises(NotImplementedError, match="encrypted Env: "
                           "ROADMAP queue A: the encrypted Env"):
            port_compaction.run_compaction_job_device_native(
                readers[:1], str(tmp_path), lambda: next(ids), CUTOFF, True,
                device="cpu")

    finally:
        port_env.set_env(old)


# ------------------------------------------------- the router, route by route


def _cpu_default(monkeypatch):
    """Let the port's device=None (the card) resolve to the CPU, so that
    the router's Python path with no device runs here."""
    from yugabyte_tpu_torch.utils import torch_setup
    real = torch_setup.resolve_device
    monkeypatch.setattr(torch_setup, "resolve_device",
                        lambda device=None: real("cpu" if device is None
                                                 else device))


def _route_three(tmp_path, paths, cutoff, is_major, port_device,
                 ref_device, retain_deletes=False):
    """run_compaction_job of both packages and the stock native job over
    the same files: byte-identical outputs, equal row counts."""
    results = {}
    for name in ("ref", "port", "native"):
        out_dir = tmp_path / f"out_{name}"
        out_dir.mkdir()
        ids = iter(range(100, 1000))
        if name == "ref":
            res = ref_compaction.run_compaction_job(
                [SSTReader(p) for p in paths], str(out_dir),
                lambda: next(ids), cutoff, is_major, retain_deletes,
                device=ref_device)
        elif name == "port":
            res = port_compaction.run_compaction_job(
                [PortSSTReader(p) for p in paths], str(out_dir),
                lambda: next(ids), cutoff, is_major, retain_deletes,
                device=port_device)
        else:
            res = port_compaction._run_native_job(
                [PortSSTReader(p) for p in paths], str(out_dir),
                lambda: next(ids), cutoff, is_major, retain_deletes, None)
        results[name] = (res, _files(res.outputs))
    ref, port, native = results["ref"], results["port"], results["native"]
    assert (port[0].rows_in, port[0].rows_out) == \
        (ref[0].rows_in, ref[0].rows_out) == \
        (native[0].rows_in, native[0].rows_out)
    assert port[0].tombstones_written == ref[0].tombstones_written
    assert port[1] == ref[1], "port differs from the JAX package"
    assert port[1] == native[1], "port differs from the native job"
    return port[0]


def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(name)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _jax_cpu():
    import jax
    return jax.devices("cpu")[0]


ROUTE_RUNS = {"equal": (900, 800, 700, 600),
              "skewed": (3000, 40, 40, 40, 40)}


@pytest.mark.parametrize("runs", sorted(ROUTE_RUNS))
@pytest.mark.parametrize("route", ["none", "explicit", "native",
                                   "force_radix"])
def test_router_matches_reference(tmp_path, monkeypatch, route, runs):
    from yugabyte_tpu_torch.ops import merge_gc as port_merge_gc
    rng = np.random.default_rng(31 + len(route) + len(runs))
    paths = _write_inputs(str(tmp_path), [
        _mk_run(rng, n, key_space=2500, ttl_frac=0.1)
        for n in ROUTE_RUNS[runs]])
    combined = _spy(monkeypatch, port_compaction,
                    "run_compaction_job_device_native")
    radix = _spy(monkeypatch, port_merge_gc, "merge_and_gc_device")
    native = _spy(monkeypatch, port_compaction, "_run_native_job")
    port_device, ref_device = {"none": (None, None),
                               "explicit": ("cpu", _jax_cpu()),
                               "native": ("native", "native"),
                               "force_radix": ("cpu", _jax_cpu())}[route]
    if route == "none":
        _cpu_default(monkeypatch)
    if route == "force_radix":
        monkeypatch.setenv("YBTPU_FORCE_RADIX", "1")
    res = _route_three(tmp_path, paths, (1 << 19) << 12, False,
                       port_device, ref_device)
    assert res.rows_out > 0
    assert bool(combined) == (route == "explicit")
    assert len(native) == (route == "native") + 1   # + the oracle job
    assert bool(radix) == (route != "native" and (
        runs == "skewed" or route == "force_radix"))


def _deep_inputs(tmp_path):
    """Two runs of random documents up to three subkeys deep (the
    generator of tests/test_deep_documents.py), written by the JAX
    package's writer."""
    import random
    from tests.test_deep_documents import (TestNativeBaselineDeep, _key,
                                           ModelEntry, ht)
    rng = random.Random(11)
    dk_len = len(_key("r0"))
    runs, seen = ([], []), set()
    for _ in range(600):
        depth = rng.randrange(4)
        subkeys = [("col", rng.randrange(3)), f"m{rng.randrange(3)}",
                   f"n{rng.randrange(2)}"][:depth]
        e = ModelEntry(_key(f"r{rng.randrange(4)}", *subkeys), dk_len,
                       ht(rng.randrange(1, 300), rng.randrange(3)),
                       is_tombstone=rng.random() < 0.2)
        if (e.key, e.dht) not in seen:
            seen.add((e.key, e.dht))
            runs[rng.randrange(2)].append(e)
    paths = []
    for i, entries in enumerate(runs):
        p = os.path.join(str(tmp_path), f"deep{i}.sst")
        SSTWriter(p).write(TestNativeBaselineDeep()._slab(entries),
                           Frontier(op_id_min=(1, i), op_id_max=(1, i + 1)))
        paths.append(p)
    return paths


@pytest.mark.parametrize("cutoff_us,is_major", [(150, False), (400, True)])
def test_router_deep_documents_match_reference(tmp_path, monkeypatch,
                                               cutoff_us, is_major):
    """Twin of tests/test_deep_documents.py:163: deep inputs with a device
    configured take the native merge's overwrite stack, in both
    packages."""
    from yugabyte_tpu.common.hybrid_time import HybridTime
    from yugabyte_tpu_torch.storage import cpu_baseline
    paths = _deep_inputs(tmp_path)
    combined = _spy(monkeypatch, port_compaction,
                    "run_compaction_job_device_native")
    baseline = _spy(monkeypatch, cpu_baseline, "compact_cpu_baseline")
    res = _route_three(tmp_path, paths, HybridTime.from_micros(
        cutoff_us).value, is_major, "cpu", _jax_cpu())
    assert res.rows_out > 0 and not combined and baseline


def test_router_deep_tombstone_does_not_resurrect(tmp_path):
    from tests.test_deep_documents import (TestNativeBaselineDeep,
                                           _entries_depth3)
    from yugabyte_tpu.common.hybrid_time import HybridTime
    entries, _ = _entries_depth3()
    path = str(tmp_path / "000001.sst")
    SSTWriter(path).write(TestNativeBaselineDeep()._slab(entries),
                          Frontier())
    res = port_compaction.run_compaction_job(
        [PortSSTReader(path)], str(tmp_path), iter(range(2, 100)).__next__,
        HybridTime.from_micros(100).value, True, device="cpu")
    assert res.rows_out == 0, "deleted map entries resurrected"


def test_chunked_jobs_match_reference(tmp_path, monkeypatch):
    """With YBTPU_MERGE_CHUNK_ROWS set, the device-native job (on the
    codec and the shell route) and the Python path run chunked
    subcompactions and stay byte-identical to the JAX package's job under
    the same setting and to the native job."""
    from yugabyte_tpu_torch.ops import run_merge as port_run_merge
    rng = np.random.default_rng(37)
    paths = _write_inputs(str(tmp_path), [
        _mk_run(rng, n, key_space=3000, ttl_frac=0.1)
        for n in (1500, 1400, 1300, 1200)])
    monkeypatch.setenv("YBTPU_MERGE_CHUNK_ROWS", "2048")
    chunked = []
    real = port_run_merge._launch_chunked

    def spy(*a, **k):
        h = real(*a, **k)
        chunked.append(h is not None and len(h._handles))
        return h

    monkeypatch.setattr(port_run_merge, "_launch_chunked", spy)
    for sub, port_dev, ref_dev in (("device", "cpu", _jax_cpu()),
                                   ("python", None, None)):
        if port_dev is None:
            _cpu_default(monkeypatch)
        d = tmp_path / sub
        d.mkdir()
        _route_three(d, paths, (1 << 19) << 12, False, port_dev, ref_dev)
        assert chunked and chunked[-1] >= 2, chunked


def test_router_unported_arguments_raise(tmp_path):
    rng = np.random.default_rng(41)
    paths = _write_inputs(str(tmp_path), [_mk_run(rng, 300, 400)])
    readers = [PortSSTReader(p) for p in paths]

    def job(**kw):
        return port_compaction.run_compaction_job(
            readers, str(tmp_path), iter(range(9, 99)).__next__, CUTOFF,
            True, device="cpu", **kw)

    health = "ROADMAP queue A: health-board routing"
    entry = "ROADMAP queue A: the DB's remaining entry points"
    # the caches, once refused, are taken: the input is staged into the
    # cache (input_ids alone has nothing to stage into), the outputs
    # written through at level 1 on a mesh too
    for kw in ({"device_cache": DeviceSlabCache("cpu"), "input_ids": [1]},
               {"input_ids": [1]},
               {"run_cache": NamespacedRunCache(NativeRunCache(1 << 26),
                                                "t"), "input_ids": [1]},
               {"mesh": make_mesh(2, devices=["cpu"] * 2),
                "device_cache": DeviceSlabCache("cpu"), "input_ids": [1]}):
        res = job(**kw)
        cache = kw.get("device_cache")
        assert res.outputs and res.rows_in == 300
        if cache is not None:
            assert cache.level_of(1) == 0 and cache.pinned_count() == 0
            assert all(cache.level_of(fid) == 1 for fid, _p, _pr in
                       res.outputs)
    for kw, title in (({"offload_policy": object()}, health),
                      ({"cancel": object()}, entry)):
        with pytest.raises(NotImplementedError, match=title):
            job(**kw)
    key = "compaction_rate_bytes_per_sec"
    port_flags.set_flag(key, 1 << 20)
    try:
        with pytest.raises(NotImplementedError, match=entry):
            job()
    finally:
        port_flags.set_flag(key, 0)

    class _Encrypted(port_env.Env):
        encrypted = True

    old = port_env.get_env()
    port_env.set_env(_Encrypted())
    try:
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue A: the encrypted Env"):
            job()
    finally:
        port_env.set_env(old)
