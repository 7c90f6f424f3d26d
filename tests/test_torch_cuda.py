"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Needs a CUDA GPU (and nvcc to build csrc/*.cu at first use); skips
without one. The GPU machine has no JAX, so this file imports nothing of
it and runs without the repo's conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
Exact equality everywhere: every value is an integer.
"""

import numpy as np
import pytest
import torch

from yugabyte_tpu_torch.ops import merge_gc, merge_path, run_merge
from yugabyte_tpu_torch.ops.slabs import (FLAG_HAS_TTL, FLAG_TOMBSTONE,
                                          KVSlab, ValueArray)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _make_run(rng, n, key_space, w=3, tomb_frac=0.1, ttl_frac=0.0):
    """One sorted run of synthetic entries with duplicate keys across runs
    (the generator of tests/test_run_merge.py, on this package's slab)."""
    kid = rng.integers(0, key_space, size=n).astype(np.uint32)
    key_words = np.zeros((n, w), dtype=np.uint32)
    key_words[:, 0] = 0x53000000 | (kid >> 16)
    key_words[:, 1] = (kid << 16) | 0x2100
    key_len = np.full(n, 7, dtype=np.int32)
    dkl = np.full(n, 7, dtype=np.int32)
    is_col = rng.random(n) < 0.5
    key_words[is_col, 1] |= 0x4B
    key_len[is_col] = 10
    ht = rng.integers(1, 1 << 20, size=n).astype(np.uint64) << 12
    flags = np.where(rng.random(n) < tomb_frac, FLAG_TOMBSTONE,
                     0).astype(np.uint32)
    ttl_ms = np.zeros(n, dtype=np.int64)
    if ttl_frac:
        has = rng.random(n) < ttl_frac
        flags[has] |= FLAG_HAS_TTL
        ttl_ms[has] = rng.integers(1, 1000, size=int(has.sum()))
    wid = rng.integers(0, 4, size=n).astype(np.uint32)
    order = np.lexsort((~wid, ~ht, key_len) + tuple(
        key_words[:, j] for j in range(w - 1, -1, -1)))
    return KVSlab(
        key_words=key_words[order], key_len=key_len[order],
        doc_key_len=dkl[order], ht_hi=(ht[order] >> 32).astype(np.uint32),
        ht_lo=(ht[order] & 0xFFFFFFFF).astype(np.uint32),
        write_id=wid[order], flags=flags[order], ttl_ms=ttl_ms[order],
        value_idx=np.arange(n, dtype=np.int32),
        values=ValueArray.empty_rows(n))


def _staged(runs, device):
    return run_merge.stage_runs_from_slabs(runs, device=device,
                                           pack_runs=False)


@pytest.mark.parametrize("k,n,key_space,w", [
    (2, 256, 40, 3), (4, 3000, 200, 3), (8, 700, 30, 3), (4, 5000, 9, 3),
    (2, 4096, 100000, 3), (4, 2000, 500, 20)])
def test_merge_level_kernel_matches_plain(cuda, k, n, key_space, w):
    rng = np.random.default_rng(k * 7 + n)
    runs = [_make_run(rng, n, key_space, w=w) for _ in range(k)]
    st = _staged(runs, cuda)
    p = torch.cat([st.cols_dev, torch.arange(
        st.n_pad, dtype=torch.int32, device=cuda)[None]])
    length = st.m
    before = merge_path.merge_level.launches
    while length < st.n_pad:
        got = merge_path.merge_level(p, length, st.cmp_rows)
        want = merge_path.merge_level_plain(p, length, st.cmp_rows)
        assert torch.equal(got, want), f"level L={length}"
        p = got
        length *= 2
    assert merge_path.merge_level.launches > before


@pytest.mark.parametrize("ttl,tomb,cutoff,is_major,retain,snapshot", [
    (0.0, 0.1, (1 << 21) << 12, True, False, False),
    (0.4, 0.3, (1 << 22) << 12, False, False, False),
    (0.4, 0.3, (1 << 22) << 12, True, True, False),
    (0.2, 0.2, (1 << 19) << 12, False, False, True),
    (0.0, 0.1, 0, True, False, False)])
@pytest.mark.parametrize("k", [1, 4])
def test_gc_pack_kernel_matches_plain(cuda, ttl, tomb, cutoff, is_major,
                                      retain, snapshot, k):
    rng = np.random.default_rng(int(ttl * 10) + k)
    runs = [_make_run(rng, 2500, 300, ttl_frac=ttl, tomb_frac=tomb)
            for _ in range(k)]
    st = _staged(runs, cuda)
    p = run_merge.merge_payload(st)
    params = merge_gc.GCParams(cutoff, is_major, retain)
    r = merge_gc._ROW_WORDS + st.w
    got = merge_gc.gc_pack(p, r, st.w, params, st.k_pad, st.m, snapshot)
    want = merge_gc.gc_pack_plain(p, r, st.w, params, st.k_pad, st.m,
                                  snapshot)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)


def test_long_segments_cross_blocks(cuda):
    """One key with thousands of versions and one document spanning many
    1024-position blocks: the cross-block carries of both scans."""
    rng = np.random.default_rng(3)
    runs = [_make_run(rng, 6000, 2, tomb_frac=0.05) for _ in range(2)]
    st = _staged(runs, cuda)
    p = run_merge.merge_payload(st)
    r = merge_gc._ROW_WORDS + st.w
    for cutoff in ((1 << 19) << 12, (1 << 21) << 12):
        params = merge_gc.GCParams(cutoff, False)
        got = merge_gc.gc_pack(p, r, st.w, params, st.k_pad, st.m)
        want = merge_gc.gc_pack_plain(p, r, st.w, params, st.k_pad, st.m)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)


def test_launch_merge_gc_cuda_equals_cpu(cuda):
    rng = np.random.default_rng(9)
    runs = [_make_run(rng, int(rng.integers(500, 3000)), 400, ttl_frac=0.2)
            for _ in range(3)]
    params = merge_gc.GCParams((1 << 21) << 12, False)
    a = run_merge.launch_merge_gc(_staged(runs, cuda), params).result()
    b = run_merge.launch_merge_gc(_staged(runs, "cpu"), params).result()
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
