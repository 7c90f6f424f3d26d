"""Chunked subcompactions of the PyTorch port against the JAX package.

The port's route masking (`merge_gc.route_word_mask`), the plain versions
of kernel L (`run_merge.chunk_split_search_plain`) and of the carve
(`run_merge.carve_chunk_plain`) are held against the JAX package's
`route_word_mask`, `_chunk_split_search` and `_carve_chunk` on the same
inputs; the chunked launch (`launch_merge_gc` with YBTPU_MERGE_CHUNK_ROWS
set) against the unchunked one, the JAX package's chunked launch and the
native C++ merge; the chunked handle's survivor spans (kernels D and E)
against the unchunked handle's; `merge_and_gc_runs` against the JAX
package's. Inputs are made from a seed with numpy, the JAX side runs on
the CPU. Every value is an integer: equality is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_run_merge import _make_run
from yugabyte_tpu.ops import merge_gc as ref_mg
from yugabyte_tpu.ops import run_merge as ref_rm
from yugabyte_tpu.ops.slabs import concat_slabs
from yugabyte_tpu_torch.ops import merge_gc, run_merge
from yugabyte_tpu_torch.ops.slabs import slab_from_arrays
from yugabyte_tpu_torch.storage.cpu_baseline import compact_cpu_baseline

# The tier-1 run shares the host's cores among its workers: one intra-op
# thread keeps these small tensors from starving the cluster tests
# running beside them.
torch.set_num_threads(1)


def _port_slab(slab):
    return slab_from_arrays(
        values=slab.values, key_words=slab.key_words, key_len=slab.key_len,
        doc_key_len=slab.doc_key_len, ht_hi=slab.ht_hi, ht_lo=slab.ht_lo,
        write_id=slab.write_id, flags=slab.flags, ttl_ms=slab.ttl_ms,
        value_idx=slab.value_idx)


def _t(a: np.ndarray) -> torch.Tensor:
    """u32 host array -> the port's int32 tensor of the same bits."""
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


# ------------------------------------------------------- route masking


@pytest.mark.parametrize("w_route", [1, 2, 3, 4])
@pytest.mark.parametrize("leading", [True, False])
def test_route_word_mask_matches_reference(w_route, leading):
    rng = np.random.default_rng(w_route * 2 + leading)
    dkl = rng.integers(-3, 24, size=(6, 9)).astype(np.int32)
    want = np.asarray(ref_mg.route_word_mask(jnp.asarray(dkl), w_route,
                                             leading=leading))
    got = _u32(merge_gc.route_word_mask(torch.from_numpy(dkl), w_route,
                                        leading=leading))
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_mask_route_host_matches_reference():
    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 32, size=(4, 300), dtype=np.uint32)
    dkl = rng.integers(0, 20, size=300).astype(np.int32)
    assert np.array_equal(run_merge._mask_route_host(words, dkl),
                          ref_rm._mask_route_host(words, dkl))


# ------------------------------------------------- kernel L and the carve


def _staged_cols(k, n, key_space, seed, random_dkl=False):
    """A JAX-staged run-major matrix (u32 numpy) and its layout."""
    rng = np.random.default_rng(seed)
    runs = [_make_run(rng, int(rng.integers(n // 2, n + 1)), key_space)
            for _ in range(k)]
    if random_dkl:
        for r in runs:
            r.doc_key_len[:] = rng.integers(0, 12, size=r.n)
    st = ref_rm.stage_runs_from_slabs(runs, pack_runs=False)
    run_ns = np.zeros(st.k_pad, np.int32)
    run_ns[:len(st.run_ns)] = st.run_ns
    return np.asarray(st.cols_dev), st, run_ns, rng


@pytest.mark.parametrize("k,n,key_space,w_route,random_dkl", [
    (2, 600, 100, 4, False), (3, 1500, 40, 4, False), (4, 900, 5000, 2,
                                                       False),
    (8, 300, 60, 1, False), (4, 1000, 300, 3, True), (5, 2048, 20, 4,
                                                      False)])
def test_chunk_split_search_matches_reference(k, n, key_space, w_route,
                                              random_dkl):
    cols, st, run_ns, rng = _staged_cols(k, n, key_space, k * 31 + n,
                                         random_dkl)
    # splitters: sampled routes (with duplicates), extremes, random words
    idx = rng.integers(0, st.n_pad, size=12)
    words = cols[ref_mg._ROW_WORDS:ref_mg._ROW_WORDS + w_route][:, idx]
    dkl = cols[ref_mg._ROW_DKL][idx].astype(np.int32)
    sampled = ref_rm._mask_route_host(words, dkl).T
    splitters = np.concatenate([
        sampled, sampled[:3], np.zeros((1, w_route), np.uint32),
        np.full((1, w_route), 0xFFFFFFFF, np.uint32),
        rng.integers(0, 1 << 32, size=(3, w_route), dtype=np.uint32)])
    n_iters = int(st.m).bit_length() + 1
    want = np.asarray(ref_rm._chunk_split_search(
        jnp.asarray(cols), jnp.asarray(run_ns), jnp.asarray(splitters),
        st.k_pad, st.m, w_route, n_iters))
    args = (_t(cols), torch.from_numpy(run_ns), _t(splitters), st.k_pad,
            st.m, w_route, n_iters)
    plain = run_merge.chunk_split_search_plain(*args).numpy()
    assert plain.dtype == np.int32 and plain.shape == want.shape
    assert np.array_equal(plain, want)
    assert np.array_equal(run_merge.chunk_split_search(*args).numpy(), want)


def _windows(run_ns, m, m_c, rng):
    starts = np.zeros(len(run_ns), np.int32)
    lens = np.zeros(len(run_ns), np.int32)
    for i, rn in enumerate(run_ns):
        ln = int(rng.integers(0, min(m_c, rn) + 1))
        starts[i] = int(rng.integers(0, rn - ln + 1))
        lens[i] = ln
    return starts, lens


@pytest.mark.parametrize("k,n,m_c,seed", [
    (2, 700, 256, 0), (4, 1024, 256, 1), (3, 3000, 1024, 2),
    (8, 300, 256, 3)])
def test_carve_chunk_matches_reference(k, n, m_c, seed):
    rng = np.random.default_rng(seed)
    runs = [_make_run(rng, n, 500) for _ in range(k)]
    st = ref_rm.stage_runs_from_slabs(runs, pack_runs=False)
    cols = np.asarray(st.cols_dev)
    run_ns = np.zeros(st.k_pad, np.int32)
    run_ns[:k] = st.run_ns
    cases = [_windows(run_ns, st.m, m_c, rng) for _ in range(3)]
    # empty windows, and the last live slot's window ending at its run's
    # end, shorter than m_c: past n_pad - m_c when that run fills its slot
    # (the JAX tail extension's case)
    last = k - 1
    s_end, l_end = np.zeros_like(run_ns), np.zeros_like(run_ns)
    l_end[last] = min(m_c // 2, run_ns[last])
    s_end[last] = run_ns[last] - l_end[last]
    s_empty = run_ns.copy()
    cases += [(s_end, l_end), (s_empty, np.zeros_like(run_ns))]
    for starts, lens in cases:
        want = np.asarray(ref_rm._carve_chunk(
            jnp.asarray(cols), jnp.asarray(starts), jnp.asarray(lens), st.m,
            m_c, st.k_pad))
        args = (_t(cols), starts, lens, st.m, m_c, st.k_pad)
        assert np.array_equal(_u32(run_merge.carve_chunk_plain(*args)), want)
        assert np.array_equal(_u32(run_merge.carve_chunk(*args)), want)


@pytest.mark.parametrize("env,want", [
    (None, 0), ("0", 0), ("-7", 0), ("1023", 0), ("x", 0),
    ("1024", 1024), ("1048576", 1 << 20)])
def test_chunk_target_rows(monkeypatch, env, want):
    if env is None:
        monkeypatch.delenv("YBTPU_MERGE_CHUNK_ROWS", raising=False)
    else:
        monkeypatch.setenv("YBTPU_MERGE_CHUNK_ROWS", env)
    assert run_merge._chunk_target_rows() == want


# ------------------------------------------- the chunked launch, twins of
# tests/test_run_merge.py's chunking cases


def _chunk_equal(runs, cutoff, is_major, monkeypatch, target,
                 expect_chunked=None):
    """The chunked launch gives bit-identical (perm, keep, mk) to the
    unchunked launch and to the JAX package's chunked launch, and chunks
    where the JAX package does, on the same bounds."""
    params = merge_gc.GCParams(cutoff, is_major)
    staged = run_merge.stage_runs_from_slabs(
        [_port_slab(r) for r in runs], device="cpu")
    monkeypatch.setenv("YBTPU_MERGE_CHUNK_ROWS", "0")
    p0, k0, m0 = run_merge.launch_merge_gc(staged, params).result()
    monkeypatch.setenv("YBTPU_MERGE_CHUNK_ROWS", str(target))
    h = run_merge.launch_merge_gc(staged, params)
    chunked = isinstance(h, run_merge._ChunkedMergeGCHandle)
    if expect_chunked is not None:
        assert chunked == expect_chunked, type(h).__name__
    p1, k1, m1 = h.result()
    assert np.array_equal(p0, p1)
    assert np.array_equal(k0, k1)
    assert np.array_equal(m0, m1)
    hr = ref_rm.launch_merge_gc(ref_rm.stage_runs_from_slabs(runs),
                                ref_mg.GCParams(cutoff, is_major))
    assert isinstance(hr, ref_rm._ChunkedMergeGCHandle) == chunked
    for a, b in zip((p1, k1, m1), hr.result()):
        assert np.array_equal(a, b)
    if chunked:
        assert len(h._metas) == len(hr._metas)
        for (s_p, l_p), (s_r, l_r) in zip(h._metas, hr._metas):
            assert np.array_equal(s_p, s_r) and np.array_equal(l_p, l_r)
    return h


@pytest.mark.parametrize("k,seed", [(2, 10), (3, 11), (4, 12)])
def test_chunked_matches_unchunked(k, seed, monkeypatch):
    rng = np.random.default_rng(seed)
    runs = [_make_run(rng, int(rng.integers(1500, 2049)), key_space=500)
            for _ in range(k)]
    h = _chunk_equal(runs, (1 << 19) << 12, True, monkeypatch,
                     target=2048, expect_chunked=True)
    # subcompactions really happened, on bounded shapes
    assert len(h._handles) >= 2
    assert all(hh._staged.m < 2048 for hh in h._handles)


def test_chunked_doc_atomicity_under_hot_docs(monkeypatch):
    """A handful of doc keys with thousands of versions each: route
    boundaries keep every document whole. With this much skew the chunker
    may refuse (the bucket would not shrink); equality holds either
    way."""
    rng = np.random.default_rng(13)
    runs = [_make_run(rng, 2000, key_space=6) for _ in range(4)]
    _chunk_equal(runs, (1 << 19) << 12, True, monkeypatch, target=2048)
    _chunk_equal(runs, (1 << 18) << 12, False, monkeypatch, target=2048)


def test_chunked_against_native_baseline(monkeypatch):
    rng = np.random.default_rng(14)
    runs = [_make_run(rng, 1800, key_space=300, ttl_frac=0.1)
            for _ in range(4)]
    monkeypatch.setenv("YBTPU_MERGE_CHUNK_ROWS", "2048")
    port_runs = [_port_slab(r) for r in runs]
    staged = run_merge.stage_runs_from_slabs(port_runs, device="cpu")
    h = run_merge.launch_merge_gc(staged,
                                  merge_gc.GCParams((1 << 19) << 12, True))
    assert isinstance(h, run_merge._ChunkedMergeGCHandle)
    perm, keep, mk = h.result()
    merged = _port_slab(concat_slabs(runs))
    offsets = np.concatenate(([0], np.cumsum([r.n for r in runs]))).tolist()
    order_c, keep_c, mk_c = compact_cpu_baseline(
        merged, offsets, (1 << 19) << 12, True, False)
    assert np.array_equal(perm[keep], order_c[keep_c])
    assert np.array_equal(perm[mk], order_c[mk_c])


def test_chunked_disabled_below_threshold(monkeypatch):
    rng = np.random.default_rng(15)
    runs = [_make_run(rng, 300, key_space=60) for _ in range(4)]
    monkeypatch.setenv("YBTPU_MERGE_CHUNK_ROWS", "1048576")
    staged = run_merge.stage_runs_from_slabs([_port_slab(r) for r in runs],
                                             device="cpu")
    h = run_merge.launch_merge_gc(staged,
                                  merge_gc.GCParams((1 << 19) << 12, True))
    assert not isinstance(h, run_merge._ChunkedMergeGCHandle)


def test_chunked_result_iter_streams_chunks(monkeypatch):
    rng = np.random.default_rng(16)
    runs = [_port_slab(_make_run(rng, 1900, key_space=700))
            for _ in range(3)]
    staged = run_merge.stage_runs_from_slabs(runs, device="cpu")
    params = merge_gc.GCParams((1 << 19) << 12, True)
    monkeypatch.setenv("YBTPU_MERGE_CHUNK_ROWS", "2048")
    h = run_merge.launch_merge_gc(staged, params)
    parts = list(h.result_iter())
    assert len(parts) == len(h._handles) >= 2
    whole = run_merge.launch_merge_gc(staged, params).result()
    for i in range(3):
        assert np.array_equal(np.concatenate([p[i] for p in parts]),
                              whole[i])


# -------------------------- the chunked handle serves kernels D and E
# (the twin of tests/test_device_write_through.py:256 at the handle level)


@pytest.mark.parametrize("k,seed,pack", [(2, 20, True), (4, 21, True),
                                         (3, 22, False)])
def test_chunked_handle_spans_equal_unchunked(k, seed, pack, monkeypatch):
    rng = np.random.default_rng(seed)
    sizes = [int(rng.integers(1200, 2049)) for _ in range(k)]
    if pack:
        sizes.append(300)      # packed into a shared slot: run_maps
    runs = [_port_slab(_make_run(rng, n, key_space=800, ttl_frac=0.2))
            for n in sizes]
    staged = run_merge.stage_runs_from_slabs(runs, device="cpu",
                                             pack_runs=pack)
    params = merge_gc.GCParams((1 << 19) << 12, False)
    monkeypatch.setenv("YBTPU_MERGE_CHUNK_ROWS", "0")
    h0 = run_merge.launch_merge_gc(staged, params)
    monkeypatch.setenv("YBTPU_MERGE_CHUNK_ROWS", "2048")
    h1 = run_merge.launch_merge_gc(staged, params)
    assert isinstance(h1, run_merge._ChunkedMergeGCHandle)
    _p, keep, mk = h0.result()
    assert np.array_equal(h1.result()[1], keep)
    assert mk[keep].any(), "no TTL rewrite in the spans"
    n = len(keep)
    pos0 = run_merge.survivor_positions(h0)
    pos1 = run_merge.survivor_positions(h1)
    assert torch.equal(pos0, pos1)
    assert torch.equal(h0._perm_dev[:n], h1._perm_dev[:n])
    rows_out = int(keep.sum())
    for start in range(0, rows_out, 700):
        end = min(start + 700, rows_out)
        a = run_merge.gather_staged_output_span(h0, pos0, start, end)
        b = run_merge.gather_staged_output_span(h1, pos1, start, end)
        assert (a.n, a.n_pad, a.w) == (b.n, b.n_pad, b.w)
        assert torch.equal(a.cols_dev, b.cols_dev)


# ------------------------------------------------------- merge_and_gc_runs


@pytest.mark.parametrize("sizes,force", [
    ((3000, 40, 40, 40, 40), False), ((900, 800, 700), True),
    ((1000, 1000), False), ((), False)])
def test_merge_and_gc_runs_matches_reference(sizes, force, monkeypatch):
    monkeypatch.setenv("YBTPU_FORCE_RADIX", "1" if force else "0")
    rng = np.random.default_rng(sum(sizes) + force)
    runs = [_make_run(rng, n, key_space=2000, ttl_frac=0.1) for n in sizes]
    cutoff = (1 << 19) << 12
    want = ref_rm.merge_and_gc_runs(runs, ref_mg.GCParams(cutoff, False))
    got = run_merge.merge_and_gc_runs([_port_slab(r) for r in runs],
                                      merge_gc.GCParams(cutoff, False),
                                      device="cpu")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
