"""The port's snapshot scan path against the JAX package, on the CPU.

Held bit for bit (every value is an integer, so the tolerance is exact
equality) against the JAX package's functions on the same inputs, made
from a seed with numpy; the JAX side runs on the CPU as its own tests run
it, the port with device="cpu" (the kernels' plain versions):
  - `sort_and_gc` (kernel G's radix, the gather, the GC) in compaction and
    snapshot modes, and `merge_and_gc_device`;
  - kernel H's plain version through `_concat_staged_fused`,
    `_restage_concat` and `device_cache.concat_staged`;
  - `scan_visible` at several read times with lower, upper and truncated
    upper bounds;
  - `visible_entries` / `visible_entries_sources` over slabs and over SST
    files written by the port, entry for entry, and `_visible_entries_host`.

Pad rows: the JAX `sort_and_gc` / `_scan_fused` leave the first pad row of
the pad segment "visible" in their raw keep (a version of the all-0xFF pad
key); every JAX caller masks it with `perm < n` (merge_gc.py:399,
scan.py:119). The port's kernel B never keeps a pad row. So the raw keep of
`sort_and_gc` is held against the JAX keep masked by `perm < n`, and the
scan against `scan_visible`'s masked output, not the raw packed words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_run_merge import _make_run
from yugabyte_tpu.ops import merge_gc as ref_mg
from yugabyte_tpu.ops import run_merge as ref_rm
from yugabyte_tpu.ops import scan as ref_scan
from yugabyte_tpu.ops.slabs import FLAG_DEEP, ValueArray, concat_slabs
from yugabyte_tpu.storage import device_cache as ref_dc
from yugabyte_tpu.storage.sst import SSTReader
from yugabyte_tpu_torch.ops import merge_gc, radix, run_merge, scan
from yugabyte_tpu_torch.ops.slabs import slab_from_arrays
from yugabyte_tpu_torch.storage import device_cache
from yugabyte_tpu_torch.storage.sst import Frontier
from yugabyte_tpu_torch.storage.sst import SSTReader as PortSSTReader
from yugabyte_tpu_torch.storage.sst import SSTWriter as PortSSTWriter

# The tier-1 run shares the host's cores among its workers: one intra-op
# thread keeps these small tensors from starving the cluster tests
# running beside them.
torch.set_num_threads(1)

W = 4


def _port_slab(slab):
    return slab_from_arrays(
        values=slab.values, key_words=slab.key_words, key_len=slab.key_len,
        doc_key_len=slab.doc_key_len, ht_hi=slab.ht_hi, ht_lo=slab.ht_lo,
        write_id=slab.write_id, flags=slab.flags, ttl_ms=slab.ttl_ms,
        value_idx=slab.value_idx)


def _with_values(rng, slab):
    """Variable-length value payloads (0..11 bytes) for every row."""
    lens = rng.integers(0, 12, size=slab.n)
    off = np.concatenate(([0], np.cumsum(lens))).astype(np.int64)
    slab.values = ValueArray(
        rng.integers(0, 256, size=int(off[-1]), dtype=np.uint8), off)
    return slab


def _runs(name, seed):
    """Sorted runs of one case (JAX package slabs)."""
    rng = np.random.default_rng(seed)
    if name == "stacks":
        runs = [_make_run(rng, 300, key_space=40) for _ in range(3)]
    elif name == "ttl":
        runs = [_make_run(rng, 250, key_space=30, ttl_frac=0.5,
                          tomb_frac=0.2) for _ in range(3)]
    elif name == "tombstones":
        runs = [_make_run(rng, 200, key_space=25, tomb_frac=0.5)
                for _ in range(4)]
    elif name == "equal_ht":
        # one key written at one hybrid time by several write ids; the
        # write ids are unique, as a tablet's (hybrid time, write id) is:
        # two copies of one internal key would leave their order to each
        # merge's tie rule
        runs = []
        wids = rng.permutation(450).astype(np.uint32)
        for g in range(3):
            s = _make_run(rng, 150, key_space=12, tomb_frac=0.2)
            s.ht_hi[:] = 0
            s.ht_lo[:] = (rng.integers(1, 4, size=s.n) << 12).astype(np.uint32)
            s.write_id[:] = wids[150 * g:150 * (g + 1)]
            runs.append(_resort(s))
    elif name == "top_bit":
        # ht words >= 2^31: an int32 sort would order them first
        runs = []
        for _ in range(2):
            s = _make_run(rng, 300, key_space=50, ht_lo_bits=34)
            s.ht_hi[rng.random(s.n) < 0.3] |= np.uint32(0x80000000)
            runs.append(_resort(s))
    elif name == "constant":
        # constant ht_hi, write_id and key_len: pruned from the schedule
        s = _make_run(rng, 400, key_space=60, tomb_frac=0.2)
        s.key_len[:] = 10
        s.write_id[:] = 7
        runs = [_resort(s)]
    elif name == "one_row":
        runs = [_make_run(rng, 1, key_space=5)]
    else:
        raise AssertionError(name)
    return [_with_values(rng, s) for s in runs]


def _resort(s):
    inv = np.uint32(0xFFFFFFFF)
    order = np.lexsort((s.write_id ^ inv, s.ht_lo ^ inv, s.ht_hi ^ inv,
                        s.key_len.astype(np.uint32))
                       + tuple(s.key_words[:, j]
                               for j in range(s.width_words - 1, -1, -1)))
    for f in ("key_words", "key_len", "doc_key_len", "ht_hi", "ht_lo",
              "write_id", "flags", "ttl_ms", "value_idx"):
        setattr(s, f, getattr(s, f)[order])
    return s


CASES = ["stacks", "ttl", "tombstones", "equal_ht", "top_bit", "constant",
         "one_row"]
READ_HTS = [(1 << 18) << 12, (1 << 19) << 12, (1 << 21) << 12]


def _shuffled(runs, seed):
    """All runs as one slab in a random row order (the radix merge sorts
    any input order)."""
    slab = concat_slabs(runs)
    order = np.random.default_rng(seed).permutation(slab.n)
    for f in ("key_words", "key_len", "doc_key_len", "ht_hi", "ht_lo",
              "write_id", "flags", "ttl_ms", "value_idx"):
        setattr(slab, f, getattr(slab, f)[order])
    return slab


# The JAX package runs sort_and_gc inside its jitted programs; jitted here
# too, it compiles once per shape and mode instead of compiling each of
# its operations eagerly in every process that runs a case.
_sort_gc_jit = jax.jit(ref_mg.sort_and_gc, static_argnames=(
    "w", "is_major", "retain_deletes", "snapshot"))


def _cutoffs(name):
    if name == "top_bit":
        return [(1 << 63) + ((1 << 40) << 12), (1 << 64) - 1, (1 << 45) << 12]
    return [0] + READ_HTS + [1 << 62]


def _limbs(cutoff):
    phys = cutoff >> 12
    return cutoff >> 32, cutoff & 0xFFFFFFFF, phys >> 20, phys & 0xFFFFF


# ---------------------------------------------------------------- sort+GC


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("mode", ["major", "minor", "retain", "snapshot"])
def test_sort_and_gc_matches_reference(name, mode):
    slab = _shuffled(_runs(name, 3), 4)
    cols, n, n_pad, w = ref_mg.pack_cols(slab)
    is_const, _first = ref_mg.column_stats(cols, n)
    sort_rows, n_sort = ref_mg.build_sort_schedule(w, is_const)
    port_rows, port_n = merge_gc.build_sort_schedule(w, is_const)
    assert np.array_equal(port_rows, sort_rows) and port_n == n_sort
    is_major = mode in ("major", "retain")
    retain = mode == "retain"
    snapshot = mode == "snapshot"
    for cutoff in _cutoffs(name):
        hi, lo, phi, plo = _limbs(cutoff)
        perm, keep, mk = _sort_gc_jit(
            jnp.asarray(cols), jnp.uint32(hi), jnp.uint32(lo),
            jnp.uint32(phi), jnp.uint32(plo), w=w, is_major=is_major,
            retain_deletes=retain, sort_rows=jnp.asarray(sort_rows),
            n_sort=jnp.int32(n_sort), snapshot=snapshot)
        perm = np.asarray(perm)
        t_perm, t_keep, t_mk, _p_mat, _packed = merge_gc.sort_and_gc(
            torch.from_numpy(cols.view(np.int32)),
            merge_gc.GCParams(cutoff, is_major, retain), w, sort_rows,
            n_sort, snapshot)
        assert np.array_equal(t_perm.numpy(), perm), cutoff
        assert np.array_equal(t_keep.numpy(), np.asarray(keep) & (perm < n))
        assert np.array_equal(t_mk.numpy(), np.asarray(mk))


@pytest.mark.parametrize("name", ["stacks", "top_bit", "equal_ht"])
def test_radix_full_schedule_matches_reference(name):
    """The unpruned schedule (sort_rows=None) gives the JAX perm too."""
    slab = _shuffled(_runs(name, 5), 6)
    cols, n, n_pad, w = ref_mg.pack_cols(slab)
    perm, _k, _m = _sort_gc_jit(
        jnp.asarray(cols), jnp.uint32(0), jnp.uint32(0), jnp.uint32(0),
        jnp.uint32(0), w=w, is_major=True, retain_deletes=False)
    got = radix.radix_sort(torch.from_numpy(cols.view(np.int32)),
                           merge_gc.full_sort_sequence(w), 4 + w)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(perm))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("is_major", [True, False])
def test_merge_and_gc_device_matches_reference(name, is_major):
    slab = _shuffled(_runs(name, 8), 9)
    for cutoff in _cutoffs(name)[1:3]:
        want = ref_mg.merge_and_gc_device(slab,
                                          ref_mg.GCParams(cutoff, is_major))
        got = merge_gc.merge_and_gc_device(
            _port_slab(slab), merge_gc.GCParams(cutoff, is_major),
            device="cpu")
        for g, w_ in zip(got, want):
            assert g.dtype == w_.dtype
            assert np.array_equal(g, w_)


def test_merge_and_gc_device_empty_slab():
    slab = _runs("one_row", 1)[0]
    empty = _port_slab(slab)
    for f in ("key_words", "key_len", "doc_key_len", "ht_hi", "ht_lo",
              "write_id", "flags", "ttl_ms", "value_idx"):
        setattr(empty, f, getattr(empty, f)[:0])
    perm, keep, mk = merge_gc.merge_and_gc_device(
        empty, merge_gc.GCParams(1 << 40, True), device="cpu")
    assert perm.shape == keep.shape == mk.shape == (0,)


# ------------------------------------------------------------- kernel H


def _parts(seed, k, widths):
    rng = np.random.default_rng(seed)
    parts, ns = [], []
    for i in range(k):
        w_i = widths[i % len(widths)]
        n_pad = 256 << int(rng.integers(0, 2))
        n_i = int(rng.integers(1, n_pad + 1))
        p = rng.integers(0, 1 << 32, size=(8 + w_i, n_pad),
                         dtype=np.uint64).astype(np.uint32)
        parts.append(p)
        ns.append(n_i)
    return parts, ns


@pytest.mark.parametrize("k,widths", [(1, [4]), (3, [4, 8]), (5, [8, 4, 4]),
                                      (2, [8])])
def test_concat_staged_fused_matches_reference(k, widths):
    parts, ns = _parts(k, k, widths)
    w = max(p.shape[0] for p in parts) - 8
    n_pad = ref_mg.bucket_size(sum(ns))
    want = np.asarray(ref_rm._concat_staged_fused(
        tuple(jnp.asarray(p) for p in parts),
        jnp.asarray(ns, dtype=jnp.int32), w=w, n_pad=n_pad))
    got = run_merge._concat_staged_fused(
        [torch.from_numpy(p.view(np.int32)) for p in parts], ns, w, n_pad)
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("k,widths", [(1, [4]), (3, [4, 8]), (5, [8, 4, 4]),
                                      (4, [8])])
def test_restage_concat_matches_reference(k, widths):
    """Odd K leaves empty slots (k_pad > k) filled with the template."""
    parts, ns = _parts(10 + k, k, widths)
    w = max(p.shape[0] for p in parts) - 8
    m = max(ref_rm.run_bucket(n) for n in ns)
    k_pad = 1 << max(0, (k - 1).bit_length()) if k > 1 else 1
    want = np.asarray(ref_rm._restage_concat(
        tuple(jnp.asarray(p) for p in parts),
        jnp.asarray(ns, dtype=jnp.int32), w=w, m=m, k_pad=k_pad))
    got = run_merge._restage_concat(
        [torch.from_numpy(p.view(np.int32)) for p in parts], ns, w, m, k_pad)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_staged_concat_zero_template():
    """The value-concat form: a zero template, parts at explicit lanes."""
    parts, ns = _parts(3, 3, [4])
    offs = [0, ns[0] + 5, ns[0] + ns[1] + 40]
    n_out = offs[-1] + ns[2] + 7
    got = run_merge.staged_concat_plain(
        [torch.from_numpy(p.view(np.int32)) for p in parts], ns, offs, n_out,
        np.zeros(12, dtype=np.uint32)).numpy().view(np.uint32)
    want = np.zeros((12, n_out), dtype=np.uint32)
    for p, n_i, o in zip(parts, ns, offs):
        want[:, o:o + n_i] = p[:, :n_i]
    assert np.array_equal(got, want)


def _staged_pair(runs):
    """The same runs staged by both packages (stage_slab, then
    concat_staged when there are several)."""
    ref_st = [ref_mg.stage_slab(s) for s in runs]
    port_st = [merge_gc.stage_slab(_port_slab(s), "cpu") for s in runs]
    if len(runs) > 1:
        return (ref_dc.concat_staged(ref_st),
                device_cache.concat_staged(port_st))
    return ref_st[0], port_st[0]


@pytest.mark.parametrize("name", CASES)
def test_concat_staged_matches_reference(name):
    runs = _runs(name, 12)
    if name == "stacks":    # a narrow input beside wide ones
        rng = np.random.default_rng(1)
        runs.append(_with_values(rng, _make_run(rng, 100, 30, w=9)))
    ref_st, port_st = _staged_pair(runs)
    assert (port_st.n, port_st.n_pad, port_st.w, port_st.n_sort) == \
        (ref_st.n, ref_st.n_pad, ref_st.w, ref_st.n_sort)
    assert np.array_equal(port_st.sort_rows, ref_st.sort_rows)
    assert np.array_equal(port_st.cols_dev.numpy().view(np.uint32),
                          np.asarray(ref_st.cols_dev))


# -------------------------------------------------------------- the scan


def _bounds(runs):
    """(lower, upper, truncated) bound triples over keys of the runs: no
    bounds, each bound alone, both, an upper bound longer than the key
    stride (truncated on the device), and a long lower bound."""
    keys = sorted({k for s in runs for k in
                   (s.key_bytes(i) for i in range(s.n))})
    a, b = keys[len(keys) // 4], keys[(3 * len(keys)) // 4]
    stride = 4 * (1 << max(2, (max(s.width_words for s in runs) - 1)
                           .bit_length()))
    long_b = b + b"\x00" * (stride + 3 - len(b))
    long_a = a + b"\x01" * (stride + 2 - len(a))
    return [(None, None), (a, None), (None, b), (a, b), (None, long_b),
            (a, long_b), (long_a, None)]


@pytest.mark.parametrize("name", CASES)
def test_scan_visible_matches_reference(name):
    runs = _runs(name, 14)
    ref_st, port_st = _staged_pair(runs)
    stride = ref_st.w * 4
    for read_ht in READ_HTS:
        for lower, upper in _bounds(runs):
            trunc = upper is not None and len(upper) > stride
            lo = lower[:stride] if lower else lower
            hi = upper[:stride] if upper else upper
            want = ref_scan.scan_visible(ref_st, read_ht, lo, hi, trunc)
            got = scan.scan_visible(port_st, read_ht, lo, hi, trunc)
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1]), (read_ht, lower, upper)


def test_scan_keeps_no_pad_row_where_the_reference_does():
    """Without an upper bound the JAX packed keep marks the first pad row;
    the port's never does, and both agree once masked by perm < n."""
    runs = _runs("stacks", 2)
    ref_st, port_st = _staged_pair(runs)
    read_ht = READ_HTS[-1]
    args = (None, None)
    lo_w, lo_l = ref_scan._pack_bound(None, ref_st.w)
    perm, keep_p = ref_scan._scan_fused(
        ref_st.cols_dev, jnp.asarray(ref_st.sort_rows),
        jnp.int32(ref_st.n_sort), *[jnp.uint32(x) for x in _limbs(read_ht)],
        jnp.asarray(lo_w), jnp.int32(lo_l), jnp.asarray(lo_w),
        jnp.int32(lo_l), w=ref_st.w, has_lower=False, has_upper=False)
    raw = ref_mg._unpack_bits(np.asarray(keep_p), ref_st.n_pad)
    perm = np.asarray(perm)
    assert raw[perm >= ref_st.n].sum() == 1
    t_perm, t_keep_p = scan._scan_fused(
        port_st.cols_dev, port_st.sort_rows, port_st.n_sort, read_ht, lo_w,
        lo_l, lo_w, lo_l, port_st.w, False, False)
    t_raw = merge_gc._unpack_bits(t_keep_p.numpy(), port_st.n_pad)
    assert not t_raw[perm >= port_st.n].any()
    assert np.array_equal(t_raw, raw & (perm < ref_st.n))
    assert scan.scan_visible(port_st, read_ht, *args)[1].sum() == \
        t_raw.sum()


@pytest.mark.parametrize("name", CASES)
def test_unbounded_scan_takes_b_plane_zero(name):
    """An unbounded `_scan_fused` launches no I.2: its packed keep is plane
    0 of kernel B's packed buffer. That equals I.2's plain version without
    bounds over the same sort_and_gc outputs, and the JAX `_scan_fused`
    masked by perm < n, at every read time."""
    runs = _runs(name, 21)
    ref_st, port_st = _staged_pair(runs)
    w = port_st.w
    zero = np.zeros(w, dtype=np.uint32)
    for read_ht in READ_HTS:
        perm, keep_p = ref_scan._scan_fused(
            ref_st.cols_dev, jnp.asarray(ref_st.sort_rows),
            jnp.int32(ref_st.n_sort),
            *[jnp.uint32(x) for x in _limbs(read_ht)], jnp.asarray(zero),
            jnp.int32(0), jnp.asarray(zero), jnp.int32(0), w=w,
            has_lower=False, has_upper=False)
        perm = np.asarray(perm)
        want = ref_mg._unpack_bits(np.asarray(keep_p), ref_st.n_pad) \
            & (perm < ref_st.n)
        before = scan.bound_pack.launches
        t_perm, t_keep_p = scan._scan_fused(
            port_st.cols_dev, port_st.sort_rows, port_st.n_sort, read_ht,
            zero, 0, zero, 0, w, False, False)
        assert scan.bound_pack.launches == before
        assert t_keep_p.is_contiguous() and t_keep_p.dtype == torch.int32
        assert np.array_equal(t_perm.numpy(), perm)
        assert np.array_equal(
            merge_gc._unpack_bits(t_keep_p.numpy(), port_st.n_pad), want)
        _perm, keep, _mk, p_mat, _packed = merge_gc.sort_and_gc(
            port_st.cols_dev, merge_gc.GCParams(read_ht, True), w,
            port_st.sort_rows, port_st.n_sort, snapshot=True)
        assert torch.equal(t_keep_p, scan.bound_pack_plain(
            p_mat, keep, w, zero, 0, zero, 0, False, False))


def _host_entries(runs, read_ht, lower, upper):
    return list(scan._visible_entries_host([_port_slab(s) for s in runs],
                                           read_ht, lower, upper))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("read_ht", READ_HTS)
def test_visible_entries_matches_reference(name, read_ht):
    runs = _runs(name, 21)
    for lower, upper in _bounds(runs):
        want = list(ref_scan.visible_entries(runs, read_ht, lower, upper))
        got = list(scan.visible_entries([_port_slab(s) for s in runs],
                                        read_ht, lower, upper, device="cpu"))
        assert got == want, (lower, upper)
        assert got == _host_entries(runs, read_ht, lower, upper)
        src = list(scan.visible_entries_sources(
            [scan.SlabSource(_port_slab(s)) for s in runs], read_ht, lower,
            upper, device="cpu"))
        assert src == want


def test_deep_documents_route_to_the_host():
    runs = _runs("stacks", 25)
    runs[1].flags[::7] |= np.uint32(FLAG_DEEP)
    read_ht = READ_HTS[2]
    want = list(ref_scan.visible_entries(runs, read_ht))
    got = list(scan.visible_entries([_port_slab(s) for s in runs], read_ht,
                                    device="cpu"))
    assert got == want == _host_entries(runs, read_ht, None, None)


def test_scan_over_port_sst_files(tmp_path):
    """SSTs written by the port's SSTWriter, read back with read_all, scan
    to the JAX package's scan over the same files and to the host path."""
    runs = _runs("tombstones", 31) + _runs("ttl", 32)
    paths = []
    for i, s in enumerate(runs):
        p = str(tmp_path / f"{i:06d}.sst")
        PortSSTWriter(p, block_entries=64).write(_port_slab(s), Frontier())
        paths.append(p)
    for read_ht in READ_HTS:
        for lower, upper in _bounds(runs)[:5]:
            port_src = [scan.SlabSource(PortSSTReader(p).read_all())
                        for p in paths]
            got = list(scan.visible_entries_sources(
                port_src, read_ht, lower, upper, device="cpu"))
            ref_src = [ref_scan.SlabSource(SSTReader(p).read_all(),
                                           sorted_source=True)
                       for p in paths]
            want = list(ref_scan.visible_entries_sources(
                ref_src, read_ht, lower, upper))
            assert got == want
            host = list(scan._visible_entries_host(
                [s.slab for s in port_src], read_ht, lower, upper))
            assert got == host
    assert got


def test_calls_outside_the_slice_raise(tmp_path):
    """ResidentSource inputs (SSTs the device cache holds) scan to the
    SlabSource scan, the JAX package's scan of the same files and the
    host path, alone, mixed with slab sources and under bounds; a narrow
    range decodes only its survivors' blocks; empty source lists answer
    nothing."""
    from yugabyte_tpu_torch.docdb.scan_spec import ScanSpec
    runs = _runs("tombstones", 41) + _runs("ttl", 42)
    cache = device_cache.DeviceSlabCache("cpu")
    readers = []
    for i, s in enumerate(runs):
        p = str(tmp_path / f"{i:06d}.sst")
        PortSSTWriter(p, block_entries=64).write(_port_slab(s), Frontier())
        readers.append(PortSSTReader(p))
        cache.stage(i, readers[-1].read_all())
    for read_ht in READ_HTS:
        for lower, upper in _bounds(runs)[:5]:
            res = [scan.ResidentSource(r, cache.get(i))
                   for i, r in enumerate(readers)]
            mixed = res[:2] + [scan.SlabSource(r.read_all())
                               for r in readers[2:]]
            want = list(ref_scan.visible_entries_sources(
                [ref_scan.SlabSource(SSTReader(r.base_path).read_all(),
                                     sorted_source=True) for r in readers],
                read_ht, lower, upper))
            for srcs in (res, mixed):
                assert list(scan.visible_entries_sources(
                    srcs, read_ht, lower, upper, device="cpu")) == want
            assert want == list(scan._visible_entries_host(
                [r.read_all() for r in readers], read_ht, lower, upper))
    # a narrow range over one resident file decodes one or two blocks
    one = scan.ResidentSource(readers[0], cache.get(0))
    keys = sorted({k for k, _v, _h in scan.visible_entries_sources(
        [scan.SlabSource(readers[0].read_all())], READ_HTS[-1],
        device="cpu")})
    lo, hi = keys[len(keys) // 2], keys[len(keys) // 2 + 3]
    got = list(scan.visible_entries_sources([one], READ_HTS[-1], lo, hi,
                                            device="cpu"))
    assert [k for k, _v, _h in got] == [k for k in keys if lo <= k < hi]
    assert 1 <= one.decoded_blocks <= 2 < readers[0].n_blocks
    assert list(scan.filtered_entries_sources([], 1, ScanSpec())) == []
    assert scan.aggregate_sources([], 1, ScanSpec()) == {"rows": 0,
                                                         "cols": {}}
    for r in readers:
        r.close()