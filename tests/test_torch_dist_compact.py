"""The mesh path of the PyTorch port against the JAX package, on the CPU.

The port runs on `make_mesh(S, devices=["cpu"] * S)` (S virtual shards on
the CPU), the JAX package on conftest's forced host devices, over the same
numpy-seeded inputs:
  - twins of tests/test_dist_compact.py (dist == single device, routing
    spreads common-prefix keys and keeps short doc keys with their
    document, global order, the overflow retry, the router's mesh job);
  - `distributed_compact`'s outputs equal to the JAX package's in full,
    pad slots included, and the overflow retries and capacity equal;
  - the plain versions of kernels M1-M3 against the JAX `per_shard`
    program recomputed in numpy;
  - both `gather_span`s, `pooled_merge_gc`'s decisions and
    `run_compaction_job_with_decisions`' files against the JAX package's,
    the sequential launch and the native job.
Every value is an integer: equality is exact.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tests.test_merge_gc_kernel import CUTOFF, ht, mk_key, slab_from_model
from yugabyte_tpu.docdb.compaction_model import ModelEntry
from yugabyte_tpu.ops import merge_gc as ref_mg
from yugabyte_tpu.parallel import dist_compact as ref_dc
from yugabyte_tpu.parallel.mesh import make_mesh as ref_mesh
from yugabyte_tpu.storage import compaction as ref_compaction
from yugabyte_tpu.storage.sst import SSTReader as RefSSTReader
from yugabyte_tpu_torch.ops import merge_gc, run_merge
from yugabyte_tpu_torch.ops.merge_gc import GCParams
from yugabyte_tpu_torch.ops.slabs import slab_from_arrays
from yugabyte_tpu_torch.parallel import dist_compact
from yugabyte_tpu_torch.parallel.mesh import Mesh, make_mesh
from yugabyte_tpu_torch.storage import compaction
from yugabyte_tpu_torch.storage.sst import SSTReader
from yugabyte_tpu_torch.utils import flags



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tier-1 run shares the host's cores among its workers: one
    intra-op thread keeps these small tensors from starving the tests
    beside them. The worker's own count comes back after the module."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


_ROW_WORDS = merge_gc._ROW_WORDS


def _port_slab(slab):
    return slab_from_arrays(
        values=slab.values, key_words=slab.key_words, key_len=slab.key_len,
        doc_key_len=slab.doc_key_len, ht_hi=slab.ht_hi, ht_lo=slab.ht_lo,
        write_id=slab.write_id, flags=slab.flags, ttl_ms=slab.ttl_ms,
        value_idx=slab.value_idx)


def _mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def _params(is_major):
    return GCParams(CUTOFF, is_major), ref_mg.GCParams(CUTOFF, is_major)


def _random_entries(seed, n=400):
    rng = random.Random(seed)
    entries, seen = [], set()
    for _ in range(n):
        key, dkl = mk_key(rng.randint(0, 40), rng.choice([None, 0, 1]))
        e = ModelEntry(key, dkl, ht(rng.randint(1, 2000), rng.randint(0, 3)),
                       is_tombstone=rng.random() < 0.15,
                       ttl_ms=rng.choice([None, None, 0, 10**9]))
        if (e.key, e.dht) in seen:
            continue
        seen.add((e.key, e.dht))
        entries.append(e)
    return entries


def _kept(cols, keep, mk):
    out = set()
    for pos in np.nonzero(keep)[0]:
        klen = int(cols[0, pos])
        key = cols[_ROW_WORDS:, pos].astype(">u4").tobytes()[:klen]
        out.add((key, int(cols[2, pos]), int(cols[3, pos]),
                 int(cols[4, pos]), bool(mk[pos])))
    return out


def _kept_single(slab, is_major):
    perm, keep, mk = merge_gc.merge_and_gc_device(
        slab, _params(is_major)[0], device="cpu")
    out = set()
    for pos in np.nonzero(keep)[0]:
        i = int(perm[pos])
        out.add((slab.key_bytes(i), int(slab.ht_hi[i]), int(slab.ht_lo[i]),
                 int(slab.write_id[i]), bool(mk[pos])))
    return out


def _both(slab, is_major, n_shards, factor=2.0):
    """(port, JAX) distributed_compact over the same slab."""
    port = dist_compact.distributed_compact(
        _port_slab(slab), _params(is_major)[0], _mesh(n_shards),
        capacity_factor=factor)
    ref = ref_dc.distributed_compact(slab, _params(is_major)[1],
                                     ref_mesh(n_shards),
                                     capacity_factor=factor)
    return port, [np.asarray(x) for x in ref]


def _assert_same_outputs(port, ref):
    """cols_out, keep, make_tombstone and src_idx equal in full, pad
    slots included."""
    for what, a, b in zip(("cols_out", "keep", "make_tombstone", "src_idx"),
                          port, ref):
        assert a.shape == b.shape, what
        assert a.dtype == b.dtype, what
        assert np.array_equal(a, b), what


# ----------------------------------------------- twins of test_dist_compact


@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("is_major", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_dist_matches_single_and_reference(seed, is_major, n_shards):
    slab = slab_from_model(_random_entries(seed))
    port, ref = _both(slab, is_major, n_shards)
    _assert_same_outputs(port, ref)
    cols, keep, mk, src = port
    assert _kept(cols, keep, mk) == _kept_single(_port_slab(slab), is_major)
    # masked keeps: no pad slot survives, every survivor is a real row
    assert (src[keep] < slab.n).all()


def test_dist_actually_distributes_common_prefix_keys():
    n_shards = 8
    entries = []
    for r in range(256):
        for col in (0, 1):
            key, dkl = mk_key(r, col)
            entries.append(ModelEntry(key, dkl, ht(100 + r)))
    slab = slab_from_model(entries)
    port, ref = _both(slab, False, n_shards)
    _assert_same_outputs(port, ref)
    cols, keep, _mk, _idx = port
    per_shard = keep.reshape(n_shards, -1).sum(axis=1)
    assert per_shard.sum() == len(entries)
    assert (per_shard > 0).sum() >= 4, per_shard
    assert per_shard.max() <= len(entries) // 2, per_shard
    shard_width = cols.shape[1] // n_shards
    doc_to_shard = {}
    for pos in np.nonzero(keep)[0]:
        doc = cols[_ROW_WORDS:, pos].astype(">u4").tobytes()[:int(cols[1, pos])]
        assert doc_to_shard.setdefault(doc, int(pos) // shard_width) == \
            int(pos) // shard_width, doc
    assert len(doc_to_shard) == 256


def test_dist_short_doc_keys_stay_with_document():
    entries = []
    for r in range(64):
        doc = bytes([0x48, r])
        entries.append(ModelEntry(doc, 2, ht(500), is_tombstone=True))
        entries.append(ModelEntry(doc + bytes([0x4B, 0, 1]), 2, ht(400)))
    slab = slab_from_model(entries)
    port, ref = _both(slab, True, 8)
    _assert_same_outputs(port, ref)
    dist = _kept(port[0], port[1], port[2])
    assert dist == _kept_single(_port_slab(slab), True)
    assert len(dist) == 0


def test_dist_output_globally_ordered():
    entries = [ModelEntry(*mk_key(r), ht(100 + r)) for r in range(100)]
    slab = slab_from_model(entries)
    cols, keep, _mk, _idx = dist_compact.distributed_compact(
        _port_slab(slab), GCParams(CUTOFF, False), _mesh(8))
    kept_keys = [cols[_ROW_WORDS:, pos].astype(">u4").tobytes()
                 [:int(cols[0, pos])] for pos in np.nonzero(keep)[0]]
    assert kept_keys == sorted(kept_keys)
    assert len(kept_keys) == 100


def test_dist_overflow_retry_counts_and_matches_reference():
    """A too-small capacity factor overflows the buckets: the retry is
    counted, re-launches from the device-resident cols, converges to the
    decisions of a comfortable first try, and matches the JAX package's
    retries, capacity and outputs."""
    entries = [ModelEntry(*mk_key(r), ht(100 + (r % 500)))
               for r in range(2048)]
    slab = slab_from_model(entries)
    port_before = dist_compact.dist_compact_overflow_retry_total
    ref_before = ref_dc._overflow_retry_counter().value()
    port, ref = _both(slab, True, 8, factor=0.05)
    port_retries = dist_compact.dist_compact_overflow_retry_total \
        - port_before
    assert port_retries > 0, "overflow retries must be counted"
    assert port_retries == ref_dc._overflow_retry_counter().value() \
        - ref_before
    _assert_same_outputs(port, ref)       # the capacity too: equal shapes
    cols2, keep2, mk2, idx2 = dist_compact.distributed_compact(
        _port_slab(slab), GCParams(CUTOFF, True), _mesh(8))
    _cols, keep, mk, idx = port
    assert np.array_equal(idx[keep], idx2[keep2])
    assert np.array_equal(mk[keep], mk2[keep2])


# ------------------------------------------------------- the router's mesh


def _ycsb_tablet(workdir, n, seed, n_runs=4):
    """chip_smoke's YCSB-A runs (no repeated internal key) written as SST
    files; returns their paths and a cutoff above every write."""
    os.makedirs(workdir)
    runs = chip_smoke.synth_ycsb_runs(n, n_runs, max(1, n // 2), seed)
    readers = chip_smoke.write_inputs(runs, workdir)
    paths = [r.base_path for r in readers]
    for r in readers:
        r.close()
    return paths, chip_smoke.history_cutoff(n, n_runs)


def _files(outputs):
    out = []
    for _fid, base, _props in outputs:
        for p in (base, base + ".sblock.0"):
            with open(p, "rb") as f:
                out.append((os.path.basename(p), f.read()))
    return out


@pytest.fixture
def low_min_rows():
    old = (flags.get_flag("distributed_compaction_min_rows"),
           ref_compaction.flags.get_flag("distributed_compaction_min_rows"))
    flags.set_flag("distributed_compaction_min_rows", 1000)
    ref_compaction.flags.set_flag("distributed_compaction_min_rows", 1000)
    yield
    flags.set_flag("distributed_compaction_min_rows", old[0])
    ref_compaction.flags.set_flag("distributed_compaction_min_rows", old[1])


def test_run_compaction_job_mesh_byte_identical(tmp_path, low_min_rows,
                                                monkeypatch):
    """The router with a mesh, at 60,000 rows: the combined path reaches
    run_compaction_job_dist_native, the Python path distributed_compact;
    both write files byte-identical to the JAX package's mesh job and to
    the native job."""
    paths, cutoff = _ycsb_tablet(str(tmp_path / "in"), 60_000, 5)
    reached = []
    for name in ("run_compaction_job_dist_native",
                 "run_compaction_job_device_native"):
        real = getattr(compaction, name)

        def spy(*a, _real=real, _name=name, **k):
            reached.append(_name)
            return _real(*a, **k)
        monkeypatch.setattr(compaction, name, spy)
    real_dc = dist_compact.distributed_compact

    def spy_dc(*a, **k):
        reached.append("distributed_compact")
        return real_dc(*a, **k)
    monkeypatch.setattr(dist_compact, "distributed_compact", spy_dc)
    outs = {}
    for tag in ("ref", "port_combined", "port_python", "native"):
        out_dir = tmp_path / tag
        out_dir.mkdir()
        ids = iter(range(1, 1000))
        if tag == "ref":
            res = ref_compaction.run_compaction_job(
                [RefSSTReader(p) for p in paths], str(out_dir),
                lambda: next(ids), cutoff, True,
                device=jax.devices("cpu")[0], mesh=ref_mesh(8))
        elif tag == "native":
            res = compaction._run_native_job(
                [SSTReader(p) for p in paths], str(out_dir),
                lambda: next(ids), cutoff, True, False, None)
        else:
            res = compaction.run_compaction_job(
                [SSTReader(p) for p in paths], str(out_dir),
                lambda: next(ids), cutoff, True,
                device="cpu" if tag == "port_combined" else None,
                mesh=_mesh(8))
        outs[tag] = (res.rows_in, res.rows_out, _files(res.outputs))
    assert reached == ["run_compaction_job_dist_native",
                       "distributed_compact"], reached
    assert outs["ref"][2], "the job wrote no output"
    for tag in ("port_combined", "port_python", "native"):
        assert outs[tag] == outs["ref"], tag


def test_mesh_below_min_rows_stays_single_device(tmp_path, monkeypatch):
    """Below distributed_compaction_min_rows (and on a one-shard mesh) the
    router keeps the single-device job."""
    paths, cutoff = _ycsb_tablet(str(tmp_path / "in"), 4000, 6)
    monkeypatch.setattr(compaction, "run_compaction_job_dist_native",
                        None)
    for i, mesh in enumerate((_mesh(8), _mesh(1))):
        out_dir = tmp_path / f"out{i}"
        out_dir.mkdir()
        ids = iter(range(1, 1000))
        res = compaction.run_compaction_job(
            [SSTReader(p) for p in paths], str(out_dir), lambda: next(ids),
            cutoff, True, device="cpu", mesh=mesh)
        assert res.rows_out > 0


def test_dist_native_device_must_match_the_mesh(tmp_path):
    """The shards run on the mesh's devices: a device of another type
    than the mesh's raises before any work."""
    paths, cutoff = _ycsb_tablet(str(tmp_path / "in"), 2000, 7)
    card_mesh = Mesh([torch.device("cuda", 0)] * 2)
    with pytest.raises(ValueError, match="not the mesh's"):
        compaction.run_compaction_job_dist_native(
            [SSTReader(p) for p in paths], str(tmp_path), lambda: 1,
            cutoff, True, device="cpu", mesh=card_mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compaction.run_compaction_job_dist_native(
                [SSTReader(p) for p in paths], str(tmp_path), lambda: 1,
                cutoff, True, device="cuda", mesh=_mesh(2))


def test_dist_native_unported_arguments_raise(tmp_path):
    """A device cache and input_ids, once refused, are taken: each output
    file's span is gathered from the sharded outputs and installed under
    its id one level above the deepest input, equal to a host re-stage of
    the file, with the files still those of the native job; cancel still
    raises, naming its ROADMAP queue A item."""
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    paths, cutoff = _ycsb_tablet(str(tmp_path / "in"), 2000, 7)
    cache = DeviceSlabCache("cpu")
    for fid, p in enumerate(paths):
        cache.stage(fid, SSTReader(p).read_all(), level=fid % 2)
    outs = {}
    for tag in ("dist", "native"):
        (tmp_path / tag).mkdir()
        ids = iter(range(100, 1000))
        readers = [SSTReader(p) for p in paths]
        if tag == "dist":
            res = compaction.run_compaction_job_dist_native(
                readers, str(tmp_path / tag), lambda: next(ids), cutoff,
                True, mesh=_mesh(2), device_cache=cache,
                input_ids=list(range(len(paths))))
        else:
            res = compaction._run_native_job(
                readers, str(tmp_path / tag), lambda: next(ids), cutoff,
                True, False, None)
        outs[tag] = (res, _files(res.outputs))
    assert outs["dist"][1] == outs["native"][1] and outs["dist"][1]
    for fid, base, props in outs["dist"][0].outputs:
        assert cache.level_of(fid) == 2
        st = cache.get(fid)
        host = merge_gc.stage_slab(SSTReader(base).read_all(), "cpu")
        assert st.n == host.n == props.n_entries
        assert torch.equal(st.cols_dev[:, :st.n], host.cols_dev[:, :st.n])
    with pytest.raises(NotImplementedError,
                       match="ROADMAP queue A: the DB's remaining entry "
                       "points"):
        compaction.run_compaction_job_dist_native(
            [SSTReader(p) for p in paths], str(tmp_path), lambda: 1,
            cutoff, True, mesh=_mesh(2), cancel=object())


# ---------------------------------------- kernels M1-M3 against per_shard


def _splitters_numpy(g_samp, g_pad, n_shards):
    """The JAX `per_shard` splitter pick (parallel/dist_compact.py:125-140)
    in numpy: the gathered routes u32 [w_route, n] lexsorted with the pad
    flag as the final key, then read at (q * n_real) // S."""
    w_route = g_samp.shape[0]
    order = np.lexsort([g_pad.astype(np.uint32)]
                       + [g_samp[i] for i in range(w_route - 1, -1, -1)])
    n_real = max(len(g_pad) - int(g_pad.sum()), 1)
    qs = (np.arange(1, n_shards) * n_real) // n_shards
    return g_samp[:, order][:, qs]


def _per_shard_numpy(cols, n_shards, capacity):
    """The JAX `per_shard` program (parallel/dist_compact.py:112-178)
    recomputed in numpy over the global u32 matrix: the splitters, and per
    shard dest, the real and all counts, the send slots and the overflow
    flag."""
    r, n_total = cols.shape
    n_local = n_total // n_shards
    w_route = min(ref_dc._W_ROUTE, r - _ROW_WORDS)
    u32max = np.uint32(0xFFFFFFFF)
    shards = []
    for s in range(n_shards):
        c = cols[:, s * n_local:(s + 1) * n_local]
        is_pad = c[ref_mg._ROW_KEY_LEN] == np.uint32(ref_mg.PAD_SENTINEL)
        mask = np.asarray(ref_mg.route_word_mask(
            jnp.asarray(c[ref_mg._ROW_DKL].view(np.int32)), w_route))
        route = np.where(is_pad[None, :], u32max,
                         c[_ROW_WORDS:_ROW_WORDS + w_route] & mask)
        shards.append((c, is_pad, route))
    step = max(1, n_local // ref_dc._SAMPLES_PER_SHARD)
    g_samp = np.concatenate([rt[:, ::step][:, :ref_dc._SAMPLES_PER_SHARD]
                             for _c, _p, rt in shards], axis=1)
    g_pad = np.concatenate([p[::step][:ref_dc._SAMPLES_PER_SHARD]
                            for _c, p, _rt in shards])
    splitters = _splitters_numpy(g_samp, g_pad, n_shards)
    out = []
    for s, (c, is_pad, route) in enumerate(shards):
        lt = np.zeros((n_local, n_shards - 1), bool)
        eq = np.ones((n_local, n_shards - 1), bool)
        for i in range(w_route):
            rw, sw = route[i][:, None], splitters[i][None, :]
            lt |= eq & (rw < sw)
            eq &= rw == sw
        dest = (~lt).sum(axis=1)
        order = np.argsort(dest, kind="stable")
        counts = np.bincount(np.where(is_pad, n_shards, dest),
                             minlength=n_shards + 1)[:n_shards]
        all_counts = np.bincount(dest, minlength=n_shards)
        offsets = np.concatenate([[0], np.cumsum(all_counts)[:-1]])
        pos = np.arange(n_local) - offsets[dest[order]]
        valid = pos < capacity
        slot = np.where(valid, dest[order] * capacity + pos,
                        n_shards * capacity)
        idx = np.uint32(s * n_local) + np.arange(n_local, dtype=np.uint32)
        ship = np.concatenate([c, idx[None, :]], axis=0)
        pad_col = np.concatenate([ref_mg.pad_template(r), [u32max]])
        send = np.tile(pad_col[:, None], (1, n_shards * capacity + 1))
        send[:, slot] = ship[:, order]
        out.append((dest, counts, all_counts, send[:, :-1],
                    bool((counts > capacity).any())))
    return splitters, out


def _skewed_cols(n, n_shards, seed, dkl_max):
    rng = np.random.default_rng(seed)
    from tests.test_run_merge import _make_run
    slab = _make_run(rng, n, max(2, n // 3))
    slab.doc_key_len[:] = rng.integers(0, dkl_max, size=n)
    return merge_gc.pack_cols(_port_slab(slab))[0], slab


def _route_edges(cols, n_shards, splitters):
    """Which of M2's edges the global u32 matrix reaches: two equal
    splitters, a real row's route equal to a splitter."""
    w_route = splitters.shape[0]
    is_pad = cols[ref_mg._ROW_KEY_LEN] == np.uint32(ref_mg.PAD_SENTINEL)
    mask = np.asarray(ref_mg.route_word_mask(
        jnp.asarray(cols[ref_mg._ROW_DKL].view(np.int32)), w_route))
    route = (cols[_ROW_WORDS:_ROW_WORDS + w_route] & mask)[:, ~is_pad]
    as_void = np.dtype((np.void, 4 * w_route))
    r = np.ascontiguousarray(route.T).view(as_void).ravel()
    sp = np.ascontiguousarray(splitters.T).view(as_void).ravel()
    return {name for name, hit in (
        ("equal_splitters", len(np.unique(sp)) < len(sp)),
        ("route_eq_splitter", bool(np.isin(r, sp).any()))) if hit}


# M3's layouts that a case is there for (doc keys of no byte route every
# real row to the last shard): a destination with no row, one filled
# exactly to capacity, rows dropped past capacity while the overflow word
# stays 0 (only pads overflowed)
_M3_EDGES = {(1024, 2, 2.0, 1): {"empty", "full"},
             (700, 2, 1.0, 1): {"pads_dropped"}}
# M2's: splitters that repeat (doc keys under one word route alike) and
# routes equal to a splitter, at S = 2 and 8; narrow keys, w_route 1-3
# (the route words of a matrix of 8 + w_route rows: pack_cols pads a slab
# to 4 key words at least, so the mesh job routes on 4)
_M2_EDGES = {(3000, 8, 2.0, 3, 3): {"equal_splitters", "route_eq_splitter"},
             (6000, 2, 2.0, 12, 4): {"route_eq_splitter"},
             (4000, 8, 1.0, 12, 2): {"route_eq_splitter"},
             (2000, 8, 2.0, 12, 1): {"equal_splitters", "route_eq_splitter"}}


@pytest.mark.parametrize("n,n_shards,factor,dkl_max,w_route", [
    # (the first seven keep their ids from before w_route was a
    # parameter: the 4 of the mesh job)
    pytest.param(300, 8, 2.0, 12, 4, id="300-8-2.0-12"),   # shards 5-7 all pad
    pytest.param(5000, 2, 0.05, 12, 4, id="5000-2-0.05-12"),  # drops, overflow
    # 4 tiles a shard, doc keys under one word
    pytest.param(20000, 2, 2.0, 3, 4, id="20000-2-2.0-3"),
    # pad columns appended to a multiple of 3
    pytest.param(700, 3, 1.0, 12, 4, id="700-3-1.0-12"),
    pytest.param(3000, 8, 0.25, 12, 4, id="3000-8-0.25-12"),
    # an empty destination, one exactly full
    pytest.param(1024, 2, 2.0, 1, 4, id="1024-2-2.0-1"),
    # pads alone dropped past capacity
    pytest.param(700, 2, 1.0, 1, 4, id="700-2-1.0-1"),
    *_M2_EDGES])
def test_route_kernels_plain_match_per_shard(n, n_shards, factor, dkl_max,
                                             w_route):
    cols, slab = _skewed_cols(n, n_shards, n + n_shards, dkl_max)
    mesh = _mesh(n_shards)
    parts, n_local = dist_compact.stage_sharded_cols(_port_slab(slab), mesh)
    full = np.concatenate([p.numpy().view(np.uint32) for p in parts], 1)
    assert np.array_equal(full[:, :cols.shape[1]], cols)
    if w_route < 4:
        full = np.ascontiguousarray(full[:_ROW_WORDS + w_route])
        parts = [p[:_ROW_WORDS + w_route].contiguous() for p in parts]
    capacity = dist_compact._quantized_capacity(n_local, n_shards, factor)
    assert capacity == ref_dc._quantized_capacity(n_local, n_shards, factor)
    want_split, want = _per_shard_numpy(full, n_shards, capacity)
    assert w_route == min(dist_compact._W_ROUTE, full.shape[0] - _ROW_WORDS)
    samp = dist_compact._sample_matrix(parts, n_local, w_route,
                                       torch.device("cpu"))
    for fn in (dist_compact.splitter_pick_plain, dist_compact.splitter_pick):
        split = fn(samp, w_route, n_shards)
        assert np.array_equal(split.numpy().view(np.uint32), want_split)
    tiles = -(-n_local // dist_compact._TILE)
    seen = _route_edges(full, n_shards, want_split)
    for s, (dest_w, counts_w, all_w, send_w, ovf_w) in enumerate(want):
        seen |= {name for name, hit in (
            ("empty", (all_w == 0).any()), ("full", (all_w == capacity).any()),
            ("pads_dropped", (all_w > capacity).any() and not ovf_w)) if hit}
        dest, hist, real = dist_compact.route_dest(parts[s], split, w_route,
                                                   n_shards)
        assert np.array_equal(dest.numpy(), dest_w)
        assert np.array_equal(hist.numpy().sum(1), all_w)
        assert np.array_equal(real.numpy().sum(1), counts_w)
        tile = np.arange(n_local) // dist_compact._TILE
        assert np.array_equal(hist.numpy(), np.stack(
            [np.bincount(tile[dest_w == d], minlength=tiles)
             for d in range(n_shards)]))
        send, ovf = dist_compact.bucket_scatter(
            parts[s], dest, hist, real, capacity, n_shards, s * n_local)
        assert np.array_equal(send.numpy().view(np.uint32), send_w)
        assert bool(ovf.item()) == ovf_w
    assert _M3_EDGES.get((n, n_shards, factor, dkl_max), set()) <= seen
    assert _M2_EDGES.get((n, n_shards, factor, dkl_max, w_route),
                         set()) <= seen


def _edge_samples(kind, n, w_route, seed):
    """M1's gathered samples u32 [2 + w_route, n] (key_len, doc_key_len,
    key words): `all_pad` every sample a pad, `equal` every real tuple
    equal (doc keys of one word) beside pads, `ff_beside_pads` real
    routes of all 0xFFFFFFFF (full doc keys of 0xFF bytes) beside pads,
    which route to the same words."""
    rng = np.random.default_rng(seed)
    samp = np.zeros((2 + w_route, n), dtype=np.uint32)
    samp[0] = 4 * w_route + 2
    samp[1] = 4 * w_route
    samp[2:] = rng.integers(0, 1 << 32, size=(w_route, n), dtype=np.uint64)
    pad = rng.random(n) < 0.3
    if kind == "all_pad":
        pad[:] = True
    elif kind == "equal":
        samp[1] = 4
        samp[2] = 0x53000001
    else:  # ff_beside_pads
        samp[2:] = 0xFFFFFFFF
    samp[0, pad] = ref_mg.PAD_SENTINEL
    return samp


@pytest.mark.parametrize("kind,n,n_shards,w_route", [
    ("all_pad", 512, 8, 4), ("all_pad", 7, 256, 1),
    ("equal", 512, 8, 4), ("equal", 1, 2, 2),
    ("ff_beside_pads", 512, 8, 4), ("ff_beside_pads", 7, 256, 3)])
def test_splitter_pick_plain_edges_match_per_shard(kind, n, n_shards,
                                                    w_route):
    """M1's plain version and its CPU wrapper against the JAX `per_shard`
    pick recomputed in numpy (routes by the JAX `route_word_mask`) on
    gathered samples that are all pads (n_real 1: the first pad's route),
    whose real tuples are all equal, or whose real routes are all
    0xFFFFFFFF beside pads (the pad flag alone orders them)."""
    samp = _edge_samples(kind, n, w_route, n + n_shards + w_route)
    is_pad = samp[0] == np.uint32(ref_mg.PAD_SENTINEL)
    mask = np.asarray(ref_mg.route_word_mask(
        jnp.asarray(samp[1].view(np.int32)), w_route))
    route = np.where(is_pad[None, :], np.uint32(0xFFFFFFFF),
                     samp[2:] & mask)
    want = _splitters_numpy(route, is_pad, n_shards)
    t = torch.from_numpy(samp.view(np.int32))
    for fn in (dist_compact.splitter_pick_plain, dist_compact.splitter_pick):
        got = fn(t, w_route, n_shards)
        assert np.array_equal(got.numpy().view(np.uint32), want)
    if kind == "ff_beside_pads" and n > 7:
        assert (want == np.uint32(0xFFFFFFFF)).all() and not is_pad.all()


def test_exchange_copies_gather_column_blocks():
    """recv[d][:, s*capacity + j] == send[s][:, d*capacity + j] (the JAX
    all_to_all, as one permute of the stacked sends), each recv a tensor
    of its own so that it is freed once its shard is merged."""
    rng = np.random.default_rng(3)
    n_shards, r1, capacity = 4, 13, 64
    send_all = rng.integers(-2**31, 2**31,
                            size=(n_shards, r1, n_shards * capacity),
                            dtype=np.int64).astype(np.int32)
    want = send_all.reshape(n_shards, r1, n_shards, capacity).transpose(
        2, 1, 0, 3).reshape(n_shards, r1, n_shards * capacity)
    sends = [torch.from_numpy(x.copy()) for x in send_all]
    recvs = dist_compact._exchange_copies(sends, capacity,
                                          [torch.device("cpu")] * n_shards)
    for d in range(n_shards):
        assert np.array_equal(recvs[d].numpy(), want[d])
    ptrs = {t.untyped_storage().data_ptr() for t in recvs + sends}
    assert len(ptrs) == 2 * n_shards


def test_one_shard_mesh_picks_no_splitters(monkeypatch):
    """A one-shard mesh has no splitters: M1's wrapper returns an empty
    [w_route, 0] tensor without its plain sort, and the job equals the
    JAX package's one-device program and the single-device merge."""
    samp = torch.zeros((6, 64), dtype=torch.int32)
    split = dist_compact.splitter_pick(samp, 4, 1)
    assert split.shape == (4, 0) and split.dtype == torch.int32

    def no_plain(*_a):
        raise AssertionError("plain splitter pick on a one-shard mesh")
    monkeypatch.setattr(dist_compact, "splitter_pick_plain", no_plain)
    slab = slab_from_model(_random_entries(5))
    port, ref = _both(slab, True, 1)
    _assert_same_outputs(port, ref)
    cols, keep, mk, _src = port
    assert _kept(cols, keep, mk) == _kept_single(_port_slab(slab), True)


# -------------------------------------------------------------- gather_span


@pytest.mark.parametrize("n_shards", [2, 8])
def test_dist_outputs_gather_span_matches_reference(n_shards):
    slab = slab_from_model(_random_entries(5, 600))
    keep, mk, src, outputs = dist_compact.distributed_compact_with_outputs(
        _port_slab(slab), _params(False)[0], _mesh(n_shards))
    r_keep, r_mk, r_src, r_outputs = \
        ref_dc.distributed_compact_with_outputs(slab, _params(False)[1],
                                                ref_mesh(n_shards))
    assert np.array_equal(keep, r_keep) and np.array_equal(mk, r_mk)
    assert np.array_equal(src, r_src)
    assert outputs.bucket_key() == r_outputs.bucket_key()
    n_out = int(keep.sum())
    for start, end in ((0, n_out // 3), (n_out // 3, n_out), (0, n_out),
                       (n_out, n_out)):
        got = outputs.gather_span(start, end)
        want = r_outputs.gather_span(start, end)
        assert (got.n, got.n_pad, got.w) == (want.n, want.n_pad, want.w)
        assert np.array_equal(got.cols_dev.numpy().view(np.uint32),
                              np.asarray(want.cols_dev))


# ------------------------------------------------------------ the pool wave


def _tablets(tmp_path, seeds, rows=2000):
    """Per seed a YCSB-A tablet of 4 runs as SST files: (paths, cutoff)."""
    return [_ycsb_tablet(str(tmp_path / f"t{s}"), rows, s) for s in seeds]


def test_pooled_wave_matches_reference_and_sequential(tmp_path):
    """3 jobs in 8 slots (5 unfilled): per-job decisions equal the JAX
    wave's and a sequential launch_merge_gc's; a device-staged wave equals
    the host-staged one; gather_span equals the JAX handle's and the
    sequential job's span; the unfilled slots launch too."""
    tabs = _tablets(tmp_path, (0, 1, 2))
    params = [GCParams(c, True) for _p, c in tabs]
    port_slabs = [[SSTReader(p).read_all() for p in paths]
                  for paths, _c in tabs]
    bucket = dist_compact.pool_slot_bucket(port_slabs[0])
    assert all(dist_compact.pool_slot_bucket(s) == bucket
               for s in port_slabs)
    jobs = [(dist_compact.stage_pool_slot(s, *bucket), p)
            for s, p in zip(port_slabs, params)]
    handle = dist_compact.pooled_merge_gc(_mesh(8), jobs)
    assert len(handle._handles) == 8
    ref_slabs = [[RefSSTReader(p).read_all() for p in paths]
                 for paths, _c in tabs]
    ref_bucket = ref_dc.pool_slot_bucket(ref_slabs[0])
    assert ref_bucket == bucket
    ref_jobs = [(ref_dc.stage_pool_slot(s, *bucket),
                 ref_mg.GCParams(c, True))
                for s, (_p, c) in zip(ref_slabs, tabs)]
    ref_handle = ref_dc.pooled_merge_gc(ref_mesh(8), ref_jobs)
    staged = [run_merge.stage_runs_from_staged(
        [merge_gc.stage_slab(x, "cpu") for x in s]) for s in port_slabs]
    dev_handle = dist_compact.pooled_merge_gc(
        _mesh(8), [(st, p) for st, p in zip(staged, params)])
    for i, s in enumerate(port_slabs):
        seq = run_merge.launch_merge_gc(
            run_merge.stage_runs_from_slabs(s, device="cpu"),
            params[i]).result()
        for got in (handle.decisions[i], dev_handle.decisions[i],
                    ref_handle.decisions[i]):
            for a, b in zip(got, seq):
                assert np.array_equal(np.asarray(a), b), i
    slot = 1
    n_out = int(handle.decisions[slot][1].sum())
    seq_h = run_merge.launch_merge_gc(
        run_merge.stage_runs_from_slabs(port_slabs[slot], device="cpu"),
        params[slot])
    seq_pos = run_merge.survivor_positions(seq_h)
    for start, end in ((0, n_out // 2), (n_out // 2, n_out)):
        got = handle.gather_span(slot, start, end)
        want = ref_handle.gather_span(slot, start, end)
        seq = run_merge.gather_staged_output_span(seq_h, seq_pos, start, end)
        assert np.array_equal(got.cols_dev.numpy().view(np.uint32),
                              np.asarray(want.cols_dev))
        assert torch.equal(got.cols_dev, seq.cols_dev)
        assert (got.n, got.n_pad) == (want.n, want.n_pad) == (seq.n,
                                                              seq.n_pad)


def test_pooled_wave_rejects_mixed_jobs(tmp_path):
    tabs = _tablets(tmp_path, (3,))
    slabs = [SSTReader(p).read_all() for p in tabs[0][0]]
    bucket = dist_compact.pool_slot_bucket(slabs)
    st = dist_compact.stage_pool_slot(slabs, *bucket)
    small = dist_compact.stage_pool_slot(slabs[:2], *dist_compact
                                         .pool_slot_bucket(slabs[:2]))
    p = GCParams(tabs[0][1], True)
    with pytest.raises(ValueError, match="shape bucket"):
        dist_compact.pooled_merge_gc(_mesh(4), [(st, p), (small, p)])
    with pytest.raises(ValueError, match="GC statics"):
        dist_compact.pooled_merge_gc(
            _mesh(4), [(st, p), (st, GCParams(tabs[0][1], False))])
    with pytest.raises(ValueError, match="jobs for 2 slots"):
        dist_compact.pooled_merge_gc(_mesh(2), [(st, p)] * 3)


@pytest.mark.parametrize("native", [True, False])
def test_run_compaction_job_with_decisions_byte_identical(tmp_path, native,
                                                          monkeypatch):
    """Stage C of the pool wave: the port's files from its wave decisions
    equal the JAX package's from its wave decisions and the native job's,
    through the native shell and through the Python writer; on_span sees
    every file."""
    tabs = _tablets(tmp_path, (4, 5))
    mesh = _mesh(2)
    readers = [[SSTReader(p) for p in paths] for paths, _c in tabs]
    slabs = [[r.read_all() for r in rs] for rs in readers]
    bucket = dist_compact.pool_slot_bucket(slabs[0])
    handle = dist_compact.pooled_merge_gc(
        mesh, [(dist_compact.stage_pool_slot(s, *bucket), GCParams(c, True))
               for s, (_p, c) in zip(slabs, tabs)])
    ref_readers = [[RefSSTReader(p) for p in paths] for paths, _c in tabs]
    ref_slabs = [[r.read_all() for r in rs] for rs in ref_readers]
    ref_handle = ref_dc.pooled_merge_gc(
        ref_mesh(2), [(ref_dc.stage_pool_slot(s, *bucket),
                       ref_mg.GCParams(c, True))
                      for s, (_p, c) in zip(ref_slabs, tabs)])
    if not native:
        from yugabyte_tpu_torch.storage import native_engine
        monkeypatch.setattr(native_engine, "available", lambda: False)
    flags.set_flag("compaction_max_output_entries_per_sst", 400)
    ref_compaction.flags.set_flag("compaction_max_output_entries_per_sst",
                                  400)
    try:
        for i, (paths, cutoff) in enumerate(tabs):
            outs = {}
            spans = []
            for tag in ("port", "ref", "native"):
                out_dir = tmp_path / f"{tag}{i}"
                out_dir.mkdir()
                ids = iter(range(10, 1000))
                if tag == "native":
                    res = compaction._run_native_job(
                        readers[i], str(out_dir), lambda: next(ids), cutoff,
                        True, False, None)
                else:
                    h, mod, rs, ss = (
                        (handle, compaction, readers[i], slabs[i])
                        if tag == "port" else
                        (ref_handle, ref_compaction, ref_readers[i],
                         ref_slabs[i]))
                    perm, keep, mk = h.decisions[i]
                    res = mod.run_compaction_job_with_decisions(
                        rs, ss, str(out_dir), lambda: next(ids), cutoff,
                        True, False, None, perm[keep], mk[keep],
                        sum(s.n for s in ss),
                        on_span=(lambda *a: spans.append(a[2:]))
                        if tag == "port" else None)
                outs[tag] = (res.rows_in, res.rows_out, _files(res.outputs))
            assert len(outs["port"][2]) >= 4, "expected several files"
            assert outs["port"] == outs["ref"] == outs["native"], i
            assert spans == [(s, min(s + 400, outs["port"][1]))
                             for s in range(0, outs["port"][1], 400)]
    finally:
        flags.set_flag("compaction_max_output_entries_per_sst", 2_000_000)
        ref_compaction.flags.set_flag(
            "compaction_max_output_entries_per_sst", 2_000_000)


# ------------------------------------------------------------------ the mesh


def test_make_mesh_over_cpu_devices():
    mesh = make_mesh(4, devices=["cpu"] * 8)
    assert mesh.devices.size == mesh.size == 4
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert mesh.axis == "shard"
    with pytest.raises(ValueError):
        make_mesh(devices=["meta"])
