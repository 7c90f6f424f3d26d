"""The port's run staging + merge + GC against the JAX package's Pallas path.

`yugabyte_tpu_torch.ops.run_merge.stage_runs_from_slabs` + `launch_merge_gc`
run on the CPU (the plain versions of kernels A and B) and are held
against `yugabyte_tpu.ops.pallas_merge.launch_merge_gc_pallas` in Pallas
interpret mode (YBTPU_MERGE_IMPL=pallas, YBTPU_PALLAS_TILE=128, as
tests/test_pallas_merge.py runs it). The packed decision buffer must be
bit-identical, and so must the decoded perm, keep and make-tombstone.
Both packages get the same slabs: the port's through `slab_from_arrays`.
"""

import numpy as np
import pytest
import torch

from tests.test_run_merge import _make_run
from yugabyte_tpu.ops import pallas_merge
from yugabyte_tpu.ops import run_merge as ref_rm
from yugabyte_tpu.ops.merge_gc import GCParams as RefParams
from yugabyte_tpu.ops.slabs import concat_slabs
from yugabyte_tpu.storage.cpu_baseline import compact_cpu_baseline
from yugabyte_tpu_torch.ops import merge_gc as port_gc
from yugabyte_tpu_torch.ops import merge_path
from yugabyte_tpu_torch.ops import run_merge as port_rm
from yugabyte_tpu_torch.ops.slabs import slab_from_arrays

# The tier-1 run shares the host's cores among its workers: one intra-op
# thread keeps these small tensors from starving the cluster tests
# running beside them.
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _force_pallas(monkeypatch):
    monkeypatch.setenv("YBTPU_MERGE_IMPL", "pallas")
    monkeypatch.setenv("YBTPU_PALLAS_TILE", "128")


def _carry(slab):
    return slab_from_arrays(
        values=slab.values, key_words=slab.key_words, key_len=slab.key_len,
        doc_key_len=slab.doc_key_len, ht_hi=slab.ht_hi, ht_lo=slab.ht_lo,
        write_id=slab.write_id, flags=slab.flags, ttl_ms=slab.ttl_ms,
        value_idx=slab.value_idx)


def _both(runs, cutoff, is_major, retain_deletes=False, pack_runs=True):
    st = ref_rm.stage_runs_from_slabs(runs, pack_runs=pack_runs)
    assert pallas_merge.supported(st)
    h = pallas_merge.launch_merge_gc_pallas(
        st, RefParams(cutoff, is_major, retain_deletes))
    want_packed = np.asarray(h._packed_dev)
    want = h.result()

    ts = port_rm.stage_runs_from_slabs([_carry(s) for s in runs],
                                       device="cpu", pack_runs=pack_runs)
    assert (ts.k_pad, ts.m, ts.w, ts.n_cmp) == (st.k_pad, st.m, st.w,
                                                st.n_cmp)
    assert np.array_equal(ts.cmp_rows, st.cmp_rows)
    assert np.array_equal(ts.cols_dev.numpy().view(np.uint32),
                          np.asarray(st.cols_dev))
    th = port_rm.launch_merge_gc(
        ts, port_gc.GCParams(cutoff, is_major, retain_deletes))
    got_packed = th._packed_dev.numpy().view(np.uint32)
    got = th.result()
    assert np.array_equal(got_packed, want_packed)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    return got


@pytest.mark.parametrize("k,seed", [(2, 0), (3, 1), (4, 2), (8, 4)])
@pytest.mark.parametrize("is_major", [True, False])
def test_matches_pallas_interpret(k, seed, is_major):
    rng = np.random.default_rng(seed)
    runs = [_make_run(rng, int(rng.integers(50, 400)), key_space=60,
                      ttl_frac=0.2) for _ in range(k)]
    cutoff = (1 << 21) << 12 if is_major else (1 << 19) << 12
    perm, keep, mk = _both(runs, cutoff, is_major)
    # and the native heap-merge oracle agrees on the survivors
    merged = concat_slabs(runs)
    offsets = np.concatenate(([0], np.cumsum([r.n for r in runs]))).tolist()
    order_c, keep_c, mk_c = compact_cpu_baseline(merged, offsets, cutoff,
                                                 is_major)
    assert np.array_equal(perm[keep], order_c[keep_c])
    assert np.array_equal(perm[mk], order_c[mk_c])


def test_unequal_run_lengths():
    rng = np.random.default_rng(11)
    runs = [_make_run(rng, n, key_space=100) for n in (1000, 17, 3, 260)]
    _both(runs, (1 << 20) << 12, True, pack_runs=False)


def test_greedy_run_packing():
    rng = np.random.default_rng(12)
    runs = [_make_run(rng, n, key_space=100) for n in (900, 60, 50, 40, 30)]
    assert ref_rm.plan_run_packing([r.n for r in runs]) is not None
    ts = port_rm.stage_runs_from_slabs([_carry(s) for s in runs],
                                       device="cpu")
    assert ts.run_maps is not None and ts.k_pad == 2
    _both(runs, (1 << 20) << 12, True)


def test_retain_deletes_and_ttl():
    rng = np.random.default_rng(13)
    runs = [_make_run(rng, 200, key_space=30, ttl_frac=0.4, tomb_frac=0.3)
            for _ in range(3)]
    _both(runs, (1 << 22) << 12, True, retain_deletes=True)
    _both(runs, (1 << 22) << 12, False)


@pytest.mark.parametrize("k,L", [(2, 256), (4, 256), (4, 512), (8, 256)])
def test_merge_level_plain_is_a_stable_pair_merge(k, L):
    """Kernel A's plain version merges each pair of sorted runs into one
    run sorted by (compare tuple, global index) — checked against numpy's
    lexsort on the same tuples."""
    rng = np.random.default_rng(k * 1000 + L)
    runs = [_make_run(rng, L, key_space=40) for _ in range(k)]
    ts = port_rm.stage_runs_from_slabs([_carry(s) for s in runs],
                                       device="cpu", pack_runs=False)
    assert ts.m == L
    cols = ts.cols_dev.numpy().view(np.uint32)
    n = cols.shape[1]
    p_mat = np.concatenate([cols, np.arange(n, dtype=np.uint32)[None]])
    out = merge_path.merge_level(torch.from_numpy(p_mat.view(np.int32)), L,
                                 ts.cmp_rows).numpy().view(np.uint32)
    rows, inv = merge_path.cmp_desc(ts.cmp_rows)
    for p in range(n // (2 * L)):
        seg = p_mat[:, p * 2 * L:(p + 1) * 2 * L]
        keys = [seg[-1]] + [seg[r] ^ np.uint32(iv)
                            for r, iv in zip(rows, inv)][::-1]
        want = seg[:, np.lexsort(tuple(keys))]
        assert np.array_equal(out[:, p * 2 * L:(p + 1) * 2 * L], want)


@pytest.mark.parametrize("rp,c,L,tile", [(17, 7, 1 << 21, 1024),
                                         (13, 2, 1 << 21, 1024),
                                         (25, 17, 1 << 21, 512),
                                         (41, 33, 1 << 21, 256),
                                         (73, 68, 1 << 21, 128),
                                         (13, 7, 128, 256)])
def test_tile_fits_shared_memory(rp, c, L, tile):
    got = merge_path.tile_for(rp, c, L)
    assert got == tile
    assert merge_path.smem_bytes(rp, c, got) <= 233472 // 3 - 1024


# Every level shape kernel A runs at: (rp, c, L). The YCSB codec and shell
# jobs (k_pad 4, m 2^22), the chunked job (m_c 2^17), the pool wave (m
# 2^18), k_pad 8, and the small shapes of the tests (w 3 -> 4 key words,
# w 20 -> 32, w 40 -> 64; 2L below the tile; L not a multiple of 4).
_LEVEL_SHAPES = [(17, c, L) for c in (2, 7, 12) for L in
                 (1 << 22, 1 << 23, 1 << 17, 1 << 18, 1 << 19, 1 << 20)] + [
    (13, 6, L) for L in (128, 256, 512, 700, 1024, 2048, 3000, 4096)] + [
    (41, 24, 2048), (41, 24, 4096), (73, 68, 1024), (13, 3, 7),
    (13, 3, 1001), (6, 3, 999), (6, 3, 3075), (2, 1, 4)]


@pytest.mark.parametrize("rp,c,L", _LEVEL_SHAPES)
def test_tile_plan_fits_the_card(rp, c, L):
    """The wrapper's shared-memory plan fits one CTA's 232,448 bytes and
    covers the level: enough threads for the tile at 4 outputs each, the
    tile at most 2L, and tiles that cover each pair."""
    tile, threads, nbytes = merge_path.tile_plan(rp, c, L)
    assert nbytes == merge_path.smem_bytes(rp, c, tile) <= 232448
    assert 0 < tile <= 2 * L and threads % 32 == 0 and threads <= 512
    assert threads * 4 >= tile
    tpp = -(-2 * L // tile)
    assert (tpp - 1) * tile < 2 * L <= tpp * tile


def _sorted_payload(rng, rp, L, n_pairs, cmp_rows, key_space):
    """A [rp, 2L * n_pairs] u32 payload whose runs of L are sorted by the
    comparator, the last row the global index."""
    n = 2 * L * n_pairs
    p = rng.integers(0, key_space, size=(rp, n)).astype(np.uint32)
    rows, inv = merge_path.cmp_desc(cmp_rows)
    for q in range(n // L):
        seg = p[:rp - 1, q * L:(q + 1) * L]
        keys = [seg[r] ^ np.uint32(iv) for r, iv in zip(rows, inv)][::-1]
        p[:rp - 1, q * L:(q + 1) * L] = seg[:, np.lexsort(tuple(keys))]
    p[-1] = np.arange(n, dtype=np.uint32)
    return p


def _ref_splits(p, L, cmp_rows, tile):
    """The JAX package's _compute_splits on the same payload."""
    import jax.numpy as jnp
    rows = [int(r) for r in cmp_rows]
    inv = np.asarray([merge_path._inv_word(r) for r in rows], np.uint32)
    s_t = jnp.asarray((p[rows] ^ inv[:, None]).T)
    n = p.shape[1]
    return np.asarray(pallas_merge._compute_splits(
        s_t, L, tile, n // (2 * L), 2 * L // tile, len(rows)))


@pytest.mark.parametrize("k,L,tile", [(2, 256, 64), (4, 256, 128),
                                      (4, 512, 256), (8, 256, 32),
                                      (2, 256, 512), (4, 1024, 2048)])
def test_merge_splits_plain_matches_compute_splits(k, L, tile):
    """The split launch's plain version gives `_compute_splits`'s layout
    and values on staged runs (the n_cmp lattice's repeated rows
    included)."""
    rng = np.random.default_rng(k * 31 + L + tile)
    runs = [_make_run(rng, L, key_space=40) for _ in range(k)]
    ts = port_rm.stage_runs_from_slabs([_carry(s) for s in runs],
                                       device="cpu", pack_runs=False)
    cols = ts.cols_dev.numpy().view(np.uint32)
    n = cols.shape[1]
    p = np.concatenate([cols, np.arange(n, dtype=np.uint32)[None]])
    got = merge_path.merge_splits(torch.from_numpy(p.view(np.int32)), L,
                                  ts.cmp_rows, tile).numpy()
    assert np.array_equal(got, _ref_splits(p, L, ts.cmp_rows, tile))


@pytest.mark.parametrize("case", ["all_equal", "all_pad_run", "one_pair",
                                  "wide_keys"])
def test_merge_splits_plain_edge_cases(case):
    """All-equal compare rows (the index alone decides), a run of pad
    columns, one pair, many distinct keys: the plain splits equal
    `_compute_splits`, and the level equals a per-pair lexsort."""
    rng = np.random.default_rng(len(case))
    cmp_rows = [8, 9, 0, 2, 3, 4]
    L, n_pairs, tile = 256, 2, 64
    key_space = {"all_equal": 1, "wide_keys": 1 << 30}.get(case, 5)
    if case == "one_pair":
        n_pairs = 1
    p = _sorted_payload(rng, 13, L, n_pairs, cmp_rows, key_space)
    if case == "all_pad_run":
        p[:-1, 3 * L:] = 0xFFFFFFFF
    t = torch.from_numpy(p.view(np.int32))
    got = merge_path.merge_splits_plain(t, L, cmp_rows, tile).numpy()
    assert np.array_equal(got, _ref_splits(p, L, cmp_rows, tile))
    out = merge_path.merge_level(t, L, cmp_rows).numpy().view(np.uint32)
    rows, inv = merge_path.cmp_desc(cmp_rows)
    for q in range(n_pairs):
        seg = p[:, q * 2 * L:(q + 1) * 2 * L]
        keys = [seg[-1]] + [seg[r] ^ np.uint32(iv)
                            for r, iv in zip(rows, inv)][::-1]
        assert np.array_equal(out[:, q * 2 * L:(q + 1) * 2 * L],
                              seg[:, np.lexsort(tuple(keys))])
