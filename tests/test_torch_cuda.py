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

from yugabyte_tpu_torch.ops import (block_codec, merge_gc, merge_path, pushdown,
                                   run_merge)
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


def _sorted_payload(rng, rp, L, n_pairs, cmp_rows, key_space):
    """A [rp, 2L * n_pairs] payload (u32 bits in int32) whose runs of L are
    sorted by the comparator, the last row the global index."""
    n = 2 * L * n_pairs
    p = rng.integers(0, key_space, size=(rp, n)).astype(np.uint32)
    rows, inv = merge_path.cmp_desc(cmp_rows)
    for q in range(n // L):
        seg = p[:rp - 1, q * L:(q + 1) * L]
        keys = [seg[r] ^ np.uint32(iv) for r, iv in zip(rows, inv)][::-1]
        p[:rp - 1, q * L:(q + 1) * L] = seg[:, np.lexsort(tuple(keys))]
    p[-1] = np.arange(n, dtype=np.uint32)
    return p.view(np.int32)


def _level_matches_plain(p, L, cmp_rows):
    """Kernel A's level and its split launch == their plain versions; the
    wrapper counts the level once."""
    rp, _n = p.shape
    tile, _t, _b = merge_path.tile_plan(
        rp, len(merge_path.cmp_desc(cmp_rows)[0]), L)
    got_s = merge_path.merge_splits(p, L, cmp_rows, tile)
    assert torch.equal(got_s.cpu(), merge_path.merge_splits_plain(
        p.cpu(), L, cmp_rows, tile)), f"splits at L={L}"
    before = merge_path.merge_level.launches
    got = merge_path.merge_level(p, L, cmp_rows)
    assert merge_path.merge_level.launches == before + 1
    assert torch.equal(got, merge_path.merge_level_plain(p, L, cmp_rows)), \
        f"level L={L}"
    return got


@pytest.mark.parametrize("case,rp,L,n_pairs,key_space", [
    ("2L below the tile", 13, 128, 4, 50),
    ("2L below the tile, odd", 13, 100, 3, 50),
    ("one pair", 13, 4096, 1, 300),
    ("all-equal compare rows", 13, 3000, 2, 1),
    ("L = 7, n % 4 == 2", 13, 7, 1, 4),
    ("L = 1001", 13, 1001, 2, 60),
    ("L = 999, n % 4 == 2", 6, 999, 3, 9),
    ("L = 3075", 6, 3075, 2, 1 << 30),
    ("L = 4098", 17, 4098, 2, 1000)])
def test_merge_level_kernel_edge_shapes(cuda, case, rp, L, n_pairs,
                                        key_space):
    """Tiles that straddle every window alignment (L not a multiple of 4,
    rows whose length is not one), 2L below the tile, one pair and
    all-equal compare rows where the index alone decides."""
    rng = np.random.default_rng(L * 7 + rp)
    cmp_rows = [1, 0, 2, 3] if rp < 8 else [8, 9, 0, 2, 3, 4]
    p = torch.from_numpy(_sorted_payload(rng, rp, L, n_pairs, cmp_rows,
                                         key_space)).to(cuda)
    _level_matches_plain(p, L, cmp_rows)


def test_merge_level_kernel_all_pad_run(cuda):
    """A run that is entirely pad columns (0xFFFFFFFF) beside real runs."""
    rng = np.random.default_rng(8)
    runs = [_make_run(rng, 3000, 200) for _ in range(3)]
    st = _staged(runs, cuda)
    assert st.k_pad == 4, "the fourth run slot is all pad"
    p = torch.cat([st.cols_dev, torch.arange(
        st.n_pad, dtype=torch.int32, device=cuda)[None]])
    assert bool((p[[0, 1, 8], 3 * st.m:] == -1).all())
    length = st.m
    while length < st.n_pad:
        p = _level_matches_plain(p, length, st.cmp_rows)
        length *= 2


def test_merge_level_kernel_k_pad_8(cuda):
    rng = np.random.default_rng(88)
    runs = [_make_run(rng, 1500, 400) for _ in range(8)]
    st = _staged(runs, cuda)
    assert st.k_pad == 8
    p = torch.cat([st.cols_dev, torch.arange(
        st.n_pad, dtype=torch.int32, device=cuda)[None]])
    length = st.m
    while length < st.n_pad:
        p = _level_matches_plain(p, length, st.cmp_rows)
        length *= 2


@pytest.mark.parametrize("rp,c,L", [(17, 7, 1 << 22), (13, 6, 128),
                                    (73, 68, 1024), (6, 3, 999)])
def test_merge_tiles_smem_plan_matches_the_kernel(cuda, rp, c, L):
    tile, _threads, nbytes = merge_path.tile_plan(rp, c, L)
    assert merge_path._lib().ybt_merge_tiles_smem_bytes(rp, c, tile) \
        == nbytes


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


# ------------------------------------------------- kernels C-F (the codec)


@pytest.mark.parametrize("rows,n_pad,n", [(12, 256, 1), (12, 4096, 3001),
                                          (16, 1 << 16, 1 << 16),
                                          (72, 2048, 2000)])
def test_block_decode_kernel_matches_plain(cuda, rows, n_pad, n):
    rng = np.random.default_rng(rows + n)
    raw = rng.integers(0, 1 << 32, size=(rows, n_pad), dtype=np.uint64
                       ).astype(np.uint32)
    raw[2, :] = raw[2, 0]                       # a constant row
    raw[4, n:] = 0xFFFFFFFF
    cols_in = torch.from_numpy(raw.view(np.int32)).to(cuda)
    before = block_codec.block_decode.launches
    got = block_codec.block_decode(cols_in, n)
    want = block_codec.block_decode_plain(cols_in, n)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    assert block_codec.block_decode.launches == before + 1


@pytest.mark.parametrize("n", [256, 1 << 16, 1 << 20])
@pytest.mark.parametrize("density", [0.0, 0.37, 1.0])
def test_survivor_scan_kernel_matches_plain(cuda, n, density):
    keep = torch.from_numpy(np.random.default_rng(n).random(n) < density
                            ).to(cuda)
    got = run_merge.survivor_scan(keep)
    want = run_merge.survivor_scan_plain(keep)
    assert torch.equal(got, want)


_SCAN_TILE = run_merge.SURVIVOR_SCAN_TILE


def _keep_case(case, n):
    if case == "alternating":
        return np.arange(n) % 2 == 1
    keep = np.zeros(n, dtype=bool)
    if case == "only the first tile":
        first = min(n, _SCAN_TILE)
        keep[:first] = np.random.default_rng(1).random(first) < 0.5
    elif case == "only the last tile":
        last = (n - 1) // _SCAN_TILE * _SCAN_TILE
        keep[last:] = np.random.default_rng(2).random(n - last) < 0.5
    elif case == "dense":
        keep[:] = True
    elif case == "random":
        keep = np.random.default_rng(n).random(n) < 0.37
    return keep


@pytest.mark.parametrize("n", [16, _SCAN_TILE - 16, _SCAN_TILE + 16,
                               3 * _SCAN_TILE + 48, 1 << 24])
@pytest.mark.parametrize("case", ["empty", "dense", "alternating",
                                  "only the first tile",
                                  "only the last tile", "random"])
def test_survivor_scan_kernel_tiles(cuda, n, case):
    """The single-pass scan at n = 16, one 16-byte step short of and past
    a CTA tile (n is a multiple of 16), several tiles, and 2^24; densities
    0 and 1, alternating bytes, keep only in the first or the last
    tile."""
    assert run_merge._wt().ybt_survivor_scan_scratch_words(_SCAN_TILE) == 2
    keep = torch.from_numpy(_keep_case(case, n)).to(cuda)
    before = run_merge.survivor_scan.launches
    got = run_merge.survivor_scan(keep)
    assert run_merge.survivor_scan.launches == before + 1
    assert torch.equal(got, run_merge.survivor_scan_plain(keep))


@pytest.mark.parametrize("k", [1, 4])
def test_span_gather_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(11 + k)
    runs = [_make_run(rng, 3000, 700, ttl_frac=0.4, tomb_frac=0.2)
            for _ in range(k)]
    st = _staged(runs, cuda)
    h = run_merge.launch_merge_gc(st, merge_gc.GCParams((1 << 22) << 12,
                                                        False))
    assert bool(h._mk_dev.any()), "no TTL rewrite to check"
    pos = run_merge.survivor_positions(h)
    n_surv = int((pos != st.n_pad - 1).sum())
    r = merge_gc._ROW_WORDS + st.w
    third = n_surv // 3
    for start, end in [(0, n_surv), (0, third), (third, n_surv),
                       (n_surv, n_surv + 3)]:
        n_out_pad = merge_gc.bucket_size(end - start)
        got = run_merge.span_gather(h._p_mat, r, pos, h._mk_dev, start, end,
                                    n_out_pad)
        want = run_merge.span_gather_plain(h._p_mat, r, pos, h._mk_dev,
                                           start, end, n_out_pad)
        assert torch.equal(got, want), (start, end)


@pytest.mark.parametrize("w", [3, 7, 40])
def test_block_encode_kernel_matches_plain(cuda, w):
    """w = 40 quantizes to 64 key words: the transpose's two 32-word
    chunks."""
    rng = np.random.default_rng(w)
    slab = _make_run(rng, 3000, 900, w=w, ttl_frac=0.3, tomb_frac=0.2)
    cols, n, _n_pad, _w = merge_gc.pack_cols(slab)
    cols[merge_gc._ROW_FLAGS, :n][rng.random(n) < 0.1] |= FLAG_TOMBSTONE
    x = torch.from_numpy(cols.view(np.int32)).to(cuda)
    got = block_codec.block_encode(x)
    want = block_codec.block_encode_plain(x)
    assert len(got) == len(want) == 10
    for i, (g, w_) in enumerate(zip(got, want)):
        assert torch.equal(g, w_), i


def test_codec_job_on_the_card_equals_native(cuda, tmp_path, monkeypatch):
    """The default (codec) job on the card launches kernels A-F and writes
    the native job's files."""
    import os
    from yugabyte_tpu_torch.storage import compaction
    from yugabyte_tpu_torch.storage.sst import (Frontier, SSTReader,
                                                SSTWriter)
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "1")
    rng = np.random.default_rng(5)
    readers = []
    for i in range(3):
        slab = _make_run(rng, 4000, 5000, ttl_frac=0.2)
        slab.values = ValueArray(
            rng.integers(0, 256, size=4000 * 8, dtype=np.uint8),
            np.arange(4001, dtype=np.int64) * 8)
        p = str(tmp_path / f"in{i}.sst")
        SSTWriter(p).write(slab, Frontier())
        readers.append(SSTReader(p))
    counters = [merge_path.merge_level, merge_gc.gc_pack,
                block_codec.block_decode, run_merge.survivor_scan,
                run_merge.span_gather, block_codec.block_encode]
    before = [c.launches for c in counters]
    out = {}
    for name in ("codec", "native"):
        os.makedirs(tmp_path / name)
        ids = iter(range(100, 200))
        if name == "codec":
            res = compaction.run_compaction_job_device_native(
                readers, str(tmp_path / name), lambda: next(ids),
                (1 << 22) << 12, False)
        else:
            res = compaction._run_native_job(
                readers, str(tmp_path / name), lambda: next(ids),
                (1 << 22) << 12, False, False, None)
        out[name] = res
    assert all(c.launches > b for c, b in zip(counters, before))
    for (_, pa, _), (_, pb, _) in zip(out["codec"].outputs,
                                      out["native"].outputs):
        for suffix in ("", ".sblock.0"):
            with open(pa + suffix, "rb") as fa, open(pb + suffix, "rb") as fb:
                assert fa.read() == fb.read()
    assert len(out["codec"].outputs) == len(out["native"].outputs) >= 1


# ---------------------------------------------- kernels G-I (the scan path)


def _unsorted_cols(rng, runs):
    """The runs' cols, concatenated and shuffled, with their pruned
    schedule: the radix input."""
    from yugabyte_tpu_torch.ops.slabs import concat_slabs
    cols, n, _n_pad, w = merge_gc.pack_cols(concat_slabs(runs))
    cols[:, :n] = cols[:, :n][:, rng.permutation(n)]
    is_const, _first = merge_gc.column_stats(cols, n)
    rows, n_sort = merge_gc.build_sort_schedule(w, is_const)
    return cols, n, w, rows, n_sort


@pytest.mark.parametrize("k,n,key_space,w,top_bit", [
    (1, 1, 5, 3, False), (3, 2500, 300, 3, False), (4, 5000, 9, 3, True),
    (2, 70000, 100000, 3, True), (4, 2000, 500, 20, False)])
def test_radix_sort_kernel_matches_plain(cuda, k, n, key_space, w, top_bit):
    from yugabyte_tpu_torch.ops import radix
    rng = np.random.default_rng(k + n)
    runs = [_make_run(rng, n, key_space, w=w) for _ in range(k)]
    for s in runs:
        s.write_id[:] = rng.integers(0, 3, size=s.n).astype(np.uint32)
        if top_bit:
            s.ht_hi[rng.random(s.n) < 0.4] |= np.uint32(0x80000000)
    cols, _n, w_pad, rows, n_sort = _unsorted_cols(rng, runs)
    x = torch.from_numpy(cols.view(np.int32)).to(cuda)
    for sched, cnt in ((rows, n_sort),
                       (merge_gc.full_sort_sequence(w_pad), 4 + w_pad)):
        before = radix.radix_sort.launches
        got = radix.radix_sort(x, sched, cnt)
        want = radix.radix_sort_plain(x, sched, cnt)
        assert torch.equal(got, want)
        assert radix.radix_sort.launches == before + 1


@pytest.mark.parametrize("k,widths", [(1, [4]), (3, [4, 8]), (5, [8, 4, 4])])
def test_staged_concat_kernel_matches_plain(cuda, k, widths):
    rng = np.random.default_rng(k)
    parts, ns = [], []
    for i in range(k):
        n_pad = 256 << int(rng.integers(0, 8))
        parts.append(torch.from_numpy(rng.integers(
            0, 1 << 32, size=(8 + widths[i % len(widths)], n_pad),
            dtype=np.uint64).astype(np.uint32).view(np.int32)).to(cuda))
        ns.append(int(rng.integers(0, n_pad + 1)))
    w = max(p.shape[0] for p in parts) - 8
    tmpl = merge_gc.pad_template(8 + w)
    m = max(run_merge.run_bucket(max(x, 1)) for x in ns)
    cum = np.concatenate(([0], np.cumsum(ns)[:-1])).tolist()
    for offs, n_out in ((cum, merge_gc.bucket_size(max(sum(ns), 1))),
                        ([i * m for i in range(k)], 8 * m)):
        for t in (tmpl, np.zeros_like(tmpl)):
            got = run_merge.staged_concat(parts, ns, offs, n_out, t)
            want = run_merge.staged_concat_plain(parts, ns, offs, n_out, t)
            assert torch.equal(got, want)


@pytest.mark.parametrize("snapshot", [True, False])
def test_scan_gather_and_bound_kernels_match_plain(cuda, snapshot):
    from yugabyte_tpu_torch.ops import radix, scan
    rng = np.random.default_rng(17)
    runs = [_make_run(rng, 3000, 700, ttl_frac=0.3, tomb_frac=0.2)
            for _ in range(3)]
    cols, n, w, rows, n_sort = _unsorted_cols(rng, runs)
    x = torch.from_numpy(cols.view(np.int32)).to(cuda)
    perm = radix.radix_sort(x, rows, n_sort)
    p_k = radix.sorted_payload(x, perm)
    assert torch.equal(p_k, radix.sorted_payload_plain(x, perm))
    params = merge_gc.GCParams((1 << 19) << 12, True)
    _packed, keep, _mk = merge_gc.gc_pack(p_k, 8 + w, w, params, 1,
                                          x.shape[1], snapshot)
    keys = sorted({s.key_bytes(i) for s in runs for i in range(0, s.n, 97)})
    lo, hi = keys[len(keys) // 5], keys[(4 * len(keys)) // 5]
    lo_w, lo_l = scan._pack_bound(lo, w)
    hi_w, hi_l = scan._pack_bound(hi, w)
    for has_lo, has_hi, trunc in ((False, False, False), (True, False, False),
                                  (False, True, False), (True, True, True)):
        args = (p_k, keep, w, lo_w, lo_l, hi_w, hi_l, has_lo, has_hi, trunc)
        assert torch.equal(scan.bound_pack(*args),
                           scan.bound_pack_plain(*args))


def test_scan_on_the_card_equals_cpu(cuda, tmp_path):
    """The seq-scan and a bounded scan over SST files on the card launch
    G, H, I.1 and B and yield the CPU scan's entries; I.2 launches exactly
    once on the bounded scan and never on the seq-scan (its keep is plane
    0 of B's packed buffer)."""
    from yugabyte_tpu_torch.ops import radix, scan
    from yugabyte_tpu_torch.storage.sst import (Frontier, SSTReader,
                                                SSTWriter)
    rng = np.random.default_rng(23)
    paths = []
    for i in range(4):
        slab = _make_run(rng, 3000 + 500 * i, 4000, ttl_frac=0.1)
        slab.values = ValueArray(
            rng.integers(0, 256, size=slab.n * 8, dtype=np.uint8),
            np.arange(slab.n + 1, dtype=np.int64) * 8)
        p = str(tmp_path / f"in{i}.sst")
        SSTWriter(p).write(slab, Frontier())
        paths.append(p)
    counters = [radix.radix_sort, run_merge.staged_concat,
                radix.sorted_payload, merge_gc.gc_pack]
    lower = b"S\x00\x00\x00\x03"
    upper = b"S\x00\x00\x00\x0c" + b"\x00" * 40  # truncated on the device
    for read_ht, lo, hi, i2 in (((1 << 21) << 12, None, None, 0),
                                ((1 << 19) << 12, lower, upper, 1)):
        before = [c.launches for c in counters]
        i2_before = scan.bound_pack.launches
        out = {}
        for dev in ("cuda", "cpu"):
            srcs = [scan.SlabSource(SSTReader(p).read_all()) for p in paths]
            out[dev] = list(scan.visible_entries_sources(srcs, read_ht, lo,
                                                         hi, device=dev))
        assert all(c.launches > b for c, b in zip(counters, before))
        assert scan.bound_pack.launches == i2_before + i2
        assert out["cuda"] == out["cpu"] and out["cpu"]


@pytest.mark.parametrize("is_major", [True, False])
def test_merge_and_gc_device_cuda_equals_cpu(cuda, is_major):
    """The radix merge + GC of one unsorted slab (kernels G, I.1, B in
    compaction mode) on the card equals the CPU run."""
    from yugabyte_tpu_torch.ops import radix
    from yugabyte_tpu_torch.ops.slabs import concat_slabs
    rng = np.random.default_rng(31)
    slab = concat_slabs([_make_run(rng, 4000, 900, ttl_frac=0.3,
                                   tomb_frac=0.2) for _ in range(3)])
    params = merge_gc.GCParams((1 << 19) << 12, is_major)
    before = [radix.radix_sort.launches, radix.sorted_payload.launches]
    got = merge_gc.merge_and_gc_device(slab, params)
    want = merge_gc.merge_and_gc_device(slab, params, device="cpu")
    for g, w_ in zip(got, want):
        assert np.array_equal(g, w_)
    assert radix.radix_sort.launches == before[0] + 1
    assert radix.sorted_payload.launches == before[1] + 1
    assert want[1].any() and (is_major or want[2].any())


# -------------------------------------------- kernels J and K (the pushdown)


def _table():
    from yugabyte_tpu_torch.common.schema import (ColumnSchema, DataType,
                                                  Schema)
    return Schema([ColumnSchema("h", DataType.INT64),
                   ColumnSchema("r", DataType.INT64),
                   ColumnSchema("v", DataType.INT64),
                   ColumnSchema("w", DataType.INT32),
                   ColumnSchema("b", DataType.BOOL)],
                  num_hash_key_columns=1, num_range_key_columns=1)


def _table_runs(seed, n_runs, n_ops, n_docs, long_doc=0):
    """Sorted runs of INSERT / UPDATE / DELETE_ROW entries of _table(),
    one hybrid time per op; long_doc extra versions of one column of one
    row make a document longer than many 1024-entry tiles."""
    from yugabyte_tpu_torch.docdb.doc_key import DocKey
    from yugabyte_tpu_torch.docdb.doc_operations import QLWriteOp, WriteOpKind
    from yugabyte_tpu_torch.ops.slabs import pack_kvs
    schema = _table()
    rng = np.random.default_rng(seed)
    runs, t = [], 0
    for g in range(n_runs):
        entries = []
        for j in range(n_ops):
            dk = DocKey((int(rng.integers(0, n_docs // 4)),),
                        (int(rng.integers(0, 4)),))
            roll = rng.random()
            if g == 0 and j < long_doc:
                op = QLWriteOp(WriteOpKind.UPDATE, DocKey((1,), (1,)),
                               {"v": int(rng.integers(-9, 9))})
            elif roll < 0.6:
                op = QLWriteOp(WriteOpKind.INSERT, dk, {
                    "v": None if rng.random() < 0.1 else
                    int(rng.integers(-2 ** 62, 2 ** 62)),
                    "w": int(rng.integers(-99, 99)),
                    "b": bool(rng.random() < 0.5)},
                    ttl_ms=None if rng.random() < 0.9 else 0)
            elif roll < 0.9:
                op = QLWriteOp(WriteOpKind.UPDATE, dk, {
                    "v": None if rng.random() < 0.3 else
                    int(rng.integers(-500, 500))})
            else:
                op = QLWriteOp(WriteOpKind.DELETE_ROW, dk)
            t += 1
            ht = (1000 + t) << 12
            for wid, (k, v) in enumerate(op.to_kv_pairs(schema)):
                entries.append((k, (ht << 32) | wid, v))
        entries.sort(key=lambda e: (e[0], -e[1]))
        runs.append(pack_kvs(entries))
    return runs, (1000 + t // 2) << 12


def _pushdown_specs():
    from yugabyte_tpu_torch.docdb import scan_spec as ss
    schema = _table()
    preds = [ss.compile_predicate(schema, c, op, v) for c, op, v in
             (("v", "!=", 0), ("w", ">", -50), ("b", "=", True),
              ("v", "<", 2 ** 61))]
    aggs = [ss.compile_aggregate(schema, f, c) for f, c in
            (("count", None), ("sum", "v"), ("max", "w"))]
    return [ss.ScanSpec(tuple(preds[:p]), tuple(aggs[:a]))
            for p, a in ((1, 2), (2, 3), (4, 3), (0, 1))]


@pytest.mark.parametrize("n_runs,n_ops,long_doc", [
    (1, 3000, 0), (3, 2000, 0), (2, 4000, 3000)])
def test_pushdown_kernels_match_plain(cuda, n_runs, n_ops, long_doc):
    """J.1, J.2, J.3 and K against their plain versions on the card, on
    the presorted route (one run) and the merge route, with a document
    of 3000 versions spanning several tiles."""
    from yugabyte_tpu_torch.ops import pushdown, scan
    runs, read_ht = _table_runs(n_runs + n_ops, n_runs, n_ops, 400,
                                long_doc)
    for spec in _pushdown_specs():
        srcs = [scan.SlabSource(s, sorted_source=True) for s in runs]
        staged, vals, _live, presorted = scan._stage_pushdown(srcs, spec,
                                                              cuda)
        perm, s, keep = scan._pushdown_base(
            staged.cols_dev, staged.sort_rows, staged.n_sort, read_ht,
            staged.w, presorted)
        sv = None if vals is None else scan._sorted_vals(vals, perm,
                                                         presorted)
        c_pad = scan.agg_slot_bucket(max(len(spec.agg_cids), 1))
        p_ops = scan._pack_predicate_operands(
            spec, scan.pred_slot_bucket(len(spec.predicates)), True)
        a_ops = scan._pack_agg_operands(spec, c_pad)
        bounds, _lo, _hi = scan._bound_operands(staged, None, None)
        flags = pushdown.row_flags(s, keep, sv, staged.w, bounds, p_ops,
                                   a_ops)
        assert torch.equal(flags, pushdown.row_flags_plain(
            s, keep, sv, staged.w, bounds, p_ops, a_ops))
        seg = pushdown.segment_or(flags)
        assert torch.equal(seg, pushdown.segment_or_plain(flags))
        assert torch.equal(
            pushdown.row_pass_pack(flags, seg, p_ops[1], p_ops[2]),
            pushdown.row_pass_pack_plain(flags, seg, p_ops[1], p_ops[2]))
        c = c_pad if sv is not None else 0
        got = pushdown.agg_reduce(flags, seg, sv, p_ops[1], p_ops[2], c,
                                  c_pad)
        want = pushdown.agg_reduce_plain(flags, seg, sv, p_ops[1], p_ops[2],
                                         c, c_pad)
        for g, w_ in zip(got, want):
            assert torch.equal(g, w_)


def test_segment_or_long_segments(cuda):
    """J.2 alone on random flag words: documents of one entry, of
    thousands of entries across tiles, and a first lane without a start
    flag."""
    from yugabyte_tpu_torch.ops import pushdown
    rng = np.random.default_rng(8)
    for n, p_start in ((1 << 20, 0.3), (1 << 20, 1e-4), (70000, 0.0)):
        flags = rng.integers(0, 1 << 8, size=n, dtype=np.int64)
        flags |= (rng.random(n) < p_start).astype(np.int64) << 8
        x = torch.from_numpy(flags.astype(np.int32)).to(cuda)
        assert torch.equal(pushdown.segment_or(x),
                           pushdown.segment_or_plain(x))


def test_pushdown_on_the_card_equals_cpu(cuda, tmp_path):
    """Filtered and aggregating scans over SST files on the card launch G,
    H, I.1, B, J and K and answer what the CPU run answers; one sorted SST
    takes the presorted route (no G)."""
    from yugabyte_tpu_torch.ops import pushdown, radix, scan
    from yugabyte_tpu_torch.storage.sst import (Frontier, SSTReader,
                                                SSTWriter)
    runs, read_ht = _table_runs(77, 4, 2500, 2000)
    paths = []
    for i, slab in enumerate(runs):
        p = str(tmp_path / f"in{i}.sst")
        SSTWriter(p).write(slab, Frontier())
        paths.append(p)
    kernels = [radix.radix_sort, run_merge.staged_concat,
               radix.sorted_payload, merge_gc.gc_pack, pushdown.row_flags,
               pushdown.segment_or]
    for spec in _pushdown_specs():
        for files in (paths, paths[:1]):
            before = [k.launches for k in kernels + [pushdown.row_pass_pack,
                                                     pushdown.agg_reduce]]
            out = {}
            for dev in ("cuda", "cpu"):
                srcs = [scan.SlabSource(SSTReader(p).read_all(), True)
                        for p in files]
                out[dev] = (scan.aggregate_sources(srcs, read_ht, spec,
                                                   device=dev),
                            list(scan.filtered_entries_sources(
                                srcs, read_ht, spec, device=dev)))
            assert out["cuda"] == out["cpu"]
            assert out["cpu"][0]["rows"] > 0
            after = [k.launches for k in kernels + [pushdown.row_pass_pack,
                                                    pushdown.agg_reduce]]
            ran = [a > b for a, b in zip(after, before)]
            if len(files) > 1:
                assert all(ran)
            else:   # presorted: no G, no H, no I.1
                assert not any(ran[:3]) and all(ran[3:])


# ------------------------------------------------------- point reads (P1-P4)
def _point_cols(seed, n_ids=3000):
    """A sorted slab of row and column keys with 1-3 versions each, its
    staged cols on the card, and its learned index."""
    from yugabyte_tpu_torch.ops.slabs import pack_kvs
    from yugabyte_tpu_torch.storage import learned_index
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(3 * n_ids, size=n_ids, replace=False))
    entries, wid = [], 0
    for i in ids:
        for col in (b"", b"K\x00\x01"):
            for v in range(int(rng.integers(1, 4))):
                wid += 1
                ht = (1000 + int(i) * 10 + v) << 12
                entries.append((b"Suser%08d\x00\x00!" % i + col,
                                (ht << 32) | (wid & 7), b"v"))
    slab = pack_kvs(entries)
    return ids, entries, slab, learned_index.fit_from_slab(slab)


def _point_queries(ids, entries, w, rng):
    from yugabyte_tpu_torch.ops.point_read import pack_query_batch
    present = [e[0] for e in entries]
    qs = [present[int(j)] for j in rng.integers(0, len(present), 500)]
    qs += [b"Suser%08d\x00\x00!" % int(i)
           for i in rng.integers(0, 3 * len(ids), 500)]
    qs += [b"S", b"Suser99999999\x00\x00!", present[0] + b"\0" * 40,
           b"Suser00000000\x00\x00!"]            # 20 pad lanes follow
    return pack_query_batch(qs, w)


def test_point_fnv64_and_bloom_kernels_match_plain(cuda):
    from yugabyte_tpu_torch.ops import point_read as pr
    rng = np.random.default_rng(31)
    for b, w in ((64, 4), (1024, 8), (1024, 16)):
        qw = rng.integers(0, 2 ** 32, size=(b, w), dtype=np.uint32)
        ql = rng.integers(-1, 4 * w + 3, size=b).astype(np.int32)
        ql[-5:] = 0                                  # pad lanes
        qw_d = merge_gc.u32_to_device(qw, cuda)
        ql_d = torch.from_numpy(ql).to(cuda)
        before = pr.fnv64.launches
        h1, h2 = pr.fnv64(qw_d, ql_d)
        assert pr.fnv64.launches == before + 1
        w1, w2 = pr.fnv64_plain(qw_d, ql_d)
        assert torch.equal(h1, w1) and torch.equal(h2, w2)
        for m_bits, k in ((1 << 16, 1), (64 * 311, 7), (32 * 57 + 5, 12),
                          ((1 << 20) + 3, 12)):
            n_words = merge_gc.bucket_size(-(-m_bits // 32))
            # bit density 0.5^(1/k): about half the lanes pass all k
            bits = rng.random((n_words, 32)) < 0.5 ** (1 / k)
            words = merge_gc.u32_to_device(
                (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64))
                .sum(axis=1).astype(np.uint32), cuda)
            got = pr.bloom_probe(h1, h2, words, m_bits, k)
            assert torch.equal(got, pr.bloom_probe_plain(h1, h2, words,
                                                         m_bits, k))
            assert 0 < int(got.sum()) < b


def test_point_locate_kernel_matches_plain(cuda):
    from yugabyte_tpu_torch.ops import point_read as pr
    from yugabyte_tpu_torch.storage import learned_index
    ids, entries, slab, fit = _point_cols(32)
    st = merge_gc.stage_slab(slab, cuda)
    n = st.n
    bad = dict(fit, a_hi=fit["a_hi"][::-1], a_lo=fit["a_lo"][::-1],
               max_err=0)
    wide = dict(fit, max_err=learned_index.LINDEX_MAX_ERR)
    models = {"exact": None,
              "fit": learned_index.model_operands(fit, n),
              "garbage": learned_index.model_operands(bad, n),
              "widest": learned_index.model_operands(wide, n)}
    qw, ql = _point_queries(ids, entries, st.w, np.random.default_rng(33))
    qw_d = merge_gc.u32_to_device(qw, cuda)
    ql_d = torch.from_numpy(ql).to(cuda)
    for name, model in models.items():
        for read_ht in ((1000 + 4500 * 10 + 1) << 12, (1 << 64) - 1,
                        (1000 << 12) - 1):
            args = (st.cols_dev, n, qw_d, ql_d, read_ht >> 32,
                    read_ht & 0xFFFFFFFF, model, st.w)
            got = pr.locate_gather(*args)
            want = pr.locate_gather_plain(*args)
            for g, x in zip(got, want):
                assert torch.equal(g, x), (name, read_ht)
            if name == "garbage":
                assert bool(got[5].any())
            if name in ("fit", "widest"):
                assert not bool(got[5].any())
    # the learned windows clip at both edges: the first and last keys
    edge = pr.pack_query_batch([entries[0][0], entries[-1][0]], st.w)
    got = pr.locate_gather(st.cols_dev, n,
                           merge_gc.u32_to_device(edge[0], cuda),
                           torch.from_numpy(edge[1]).to(cuda), 0xFFFFFFFF,
                           0xFFFFFFFF, models["widest"], st.w)
    assert got[1][:2].tolist() == [True, True]
    assert got[0][1].item() < n


def test_point_index_fit_kernel_matches_plain_and_host(cuda):
    from yugabyte_tpu_torch.ops import point_read as pr
    for seed in (34, 35):
        _ids, _entries, slab, fit = _point_cols(seed, n_ids=5000 + seed)
        st = merge_gc.stage_slab(slab, cuda)
        got = pr.index_fit(st.cols_dev, st.n, st.w)
        want = pr.index_fit_plain(st.cols_dev, st.n, st.w)
        for g, x in zip(got, want):
            assert torch.equal(g.reshape(-1), x.reshape(-1))
        assert pr.fit_learned_index_device(st) == fit


# Kernel P4's layouts (n, n_pad, w, p): n not a multiple of 4, n = n_pad,
# w = 2, p = 0, 1 and 2, runs of equal keys spanning several anchors (equal
# anchors, segments with da = 0), a row stride not a multiple of 4 (the
# kernel's scalar loads)
INDEX_FIT_CASES = {"n_mod4": (3001, 4096, 4, 0), "n_full": (4096, 4096, 3, 0),
                   "w2": (2000, 2048, 2, 0), "p1": (5000, 8192, 4, 1),
                   "p2": (5000, 8192, 5, 2), "runs": (4096, 4096, 4, 0),
                   "stride": (999, 1001, 4, 1)}


def _fit_cols(x, n_pad, w, p, rng):
    """A sorted staged matrix u32 [8 + w, n_pad] over the 64-bit
    coordinates x (sorted): key words 0..p-1 one shared prefix, words p and
    p + 1 the limbs of x, the rest random and sorted within equal limbs;
    pad columns 0xFFFFFFFF in the key words."""
    n = len(x)
    words = rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint64)
    words[:, :p] = rng.integers(0, 2 ** 32, size=p, dtype=np.uint64)
    words[:, p] = x >> np.uint64(32)
    words[:, p + 1] = x & np.uint64(0xFFFFFFFF)
    words = words[np.lexsort(words.T[::-1])].astype(np.uint32)
    cols = np.zeros((8 + w, n_pad), dtype=np.uint32)
    cols[0, :n] = 4 * w
    cols[8:, :n] = words.T
    cols[8:, n:] = 0xFFFFFFFF
    return cols


def index_fit_case(case):
    """(cols, n, w) of the named INDEX_FIT_CASES layout, from a seed."""
    n, n_pad, w, p = INDEX_FIT_CASES[case]
    rng = np.random.default_rng(sum(case.encode()))
    if case == "runs":
        vals = np.sort(rng.integers(0, 2 ** 62, size=5, dtype=np.uint64))
        x = np.repeat(vals, [700, 1500, 10, 1200, n - 3410])
    else:
        x = np.sort(rng.integers(0, 2 ** 62, size=n, dtype=np.uint64))
    return _fit_cols(x, n_pad, w, p, rng), n, w


def _fit_matches_plain(cuda, cols, n, w):
    from yugabyte_tpu_torch.ops import point_read as pr
    c = merge_gc.u32_to_device(cols, cuda)
    before = pr.index_fit.launches
    got = pr.index_fit(c, n, w)
    assert pr.index_fit.launches == before + 1
    want = pr.index_fit_plain(c, n, w)
    for g, x in zip(got, want):
        assert torch.equal(g.reshape(-1), x.reshape(-1))
    return c, got


@pytest.mark.parametrize("case", sorted(INDEX_FIT_CASES))
def test_point_index_fit_kernel_layouts(cuda, case):
    """P4 == its plain version on its layouts; on the strided one, a chain
    span cannot have it (every staged span is padded to a power of two),
    the kernel takes its scalar loads."""
    cols, n, w = index_fit_case(case)
    _c, got = _fit_matches_plain(cuda, cols, n, w)
    assert int(got[2]) == INDEX_FIT_CASES[case][3]


@pytest.mark.parametrize("where", [0, 100, 255])
def test_point_index_fit_largest_error_in_one_cta(cuda, where):
    """2^20 entries on a line but one run of 1000 equal coordinates, which
    holds the largest error: in the 4096 entries CTA `where` streams first
    (256 threads, 4 groups of 4 entries a thread; 256 CTAs), CTA 0, one in
    between and the last. The fold of the CTAs' partials finds it; ten
    calls on one stream give the same answer (the ticket resets)."""
    from yugabyte_tpu_torch.ops import point_read as pr
    n = 1 << 20
    x = np.uint64(1 << 40) + np.arange(n, dtype=np.uint64) * np.uint64(
        3_000_000_000)
    i0 = 4 * (where * 256) if where < 255 else 4 * (3 * 65536 + 255 * 256)
    x[i0:i0 + 1000] = x[i0]
    cols = _fit_cols(x, n, 4, 0, np.random.default_rng(where))
    c, got = _fit_matches_plain(cuda, cols, n, 4)
    assert 900 < int(got[3]) < 1100
    first = torch.cat([t.reshape(-1) for t in got]).clone()
    for _ in range(10):
        again = pr.index_fit(c, n, 4)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([t.reshape(-1) for t in again]), first)


def test_point_index_fit_one_launch_and_one_download(cuda):
    """index_fit is one kernel a call, with no memset or copy;
    fit_learned_index_device adds one device-to-host copy of its answer."""
    from yugabyte_tpu_torch.ops import point_read as pr
    _ids, _entries, slab, fit = _point_cols(36)
    st = merge_gc.stage_slab(slab, cuda)
    assert _device_activity(lambda: pr.index_fit(st.cols_dev, st.n,
                                                 st.w)) == (1, 0)
    assert pr.fit_learned_index_device(st) == fit
    # the trace behind the lost-first-events remedy: one call
    names = _device_names(lambda: pr.fit_learned_index_device(st), reps=1)
    copies = [x for x in names if x.startswith("Memcpy")
              or x.startswith("Memset")]
    assert len(names) - len(copies) == 1
    assert len(copies) == 1 and "DtoH" in copies[0], names


def _every_file_rows(n_files, seed, device):
    """n_files sorted SSTs staged on `device` (widths 4 and 8 by turns)
    as FileTable rows: a dense filter, none (every lane a maybe) or one
    that rejects every lane, by turns; a fitted model, a mispredicting
    one or none; files 0 and 1 share tie entries (the same key, ht and
    wid, newer than every other version). Returns (rows, tie keys)."""
    from yugabyte_tpu_torch.ops.slabs import pack_kvs
    from yugabyte_tpu_torch.storage import learned_index
    rng = np.random.default_rng(seed)
    tie = [(b"S%08d!" % int(i), (5_000_000 + int(i)) << 12, 3)
           for i in rng.choice(3000, size=60, replace=False)]
    m_bits, k = 64 * 37 + 13, 7
    n_words = merge_gc.bucket_size(-(-m_bits // 32))
    dense = merge_gc.u32_to_device(
        rng.integers(0, 2 ** 32, size=n_words, dtype=np.uint32)
        | rng.integers(0, 2 ** 32, size=n_words, dtype=np.uint32), device)
    zeros = torch.zeros(n_words, dtype=torch.int32, device=device)
    rows = []
    for f in range(n_files):
        ents = []
        for i in np.sort(rng.choice(3000, size=600, replace=False)):
            for col in (b"", b"K\x01"):
                for _v in range(int(rng.integers(1, 4))):
                    ents.append((b"S%08d!" % i + col,
                                 (1000 + int(i) * 10 + int(rng.integers(0, 8)))
                                 << 12, int(rng.integers(0, 4))))
        if f % 2:
            ents += [(b"Slong-key-%017d!" % i, (2000 + int(i)) << 12, f)
                     for i in rng.choice(3000, size=100, replace=False)]
        if f < 2:
            ents += tie
        ents = sorted({e: None for e in ents}, key=lambda e: (e[0], -e[1],
                                                               -e[2]))
        slab = pack_kvs([(kk, (ht << 32) | wid, b"v") for kk, ht, wid in ents])
        st = merge_gc.stage_slab(slab, device)
        fit = learned_index.fit_from_slab(slab)
        model = None
        if f % 4 == 0:
            model = learned_index.model_operands(fit, st.n)
        elif f % 4 == 3:
            model = learned_index.model_operands(
                dict(fit, a_hi=fit["a_hi"][::-1], a_lo=fit["a_lo"][::-1],
                     max_err=0), st.n)
        bloom = ((dense, m_bits, k), None, (zeros, m_bits, k))[f % 3]
        rows.append((bloom, st.cols_dev, st.n, st.w, model))
    return rows, [t[0] for t in tie]


@pytest.mark.parametrize("n_files,b", [(1, 1), (2, 64), (5, 65), (16, 1024)])
def test_point_every_file_kernels_match_plain(cuda, n_files, b):
    """P1 + P2 and P3 + the fold over every file, one launch each, bit for
    bit equal to their plain versions (the plain P1, the per-file plain P2
    / P3 looped in file order and the fold) at both read-time edges, the
    model on and off; the hashes at doc-key lengths 0, 1, 5 and 4 * w_hash
    and with a first file that has no filter; ties go to file 0."""
    from yugabyte_tpu_torch.ops import point_read as pr
    from yugabyte_tpu_torch.ops.slabs import _doc_key_len
    rows, tie_keys = _every_file_rows(n_files, 60 + n_files, cuda)
    table = pr.FileTable(rows, cuda)
    rng = np.random.default_rng(61 + b)
    qs = (tie_keys[:max(1, b // 8)]
          + [b"Slong-key-%017d!" % i for i in range(b // 8)]
          + [b"S%08d!" % int(i) + (b"K\x01" if i % 3 == 0 else b"")
             for i in rng.integers(0, 3300, 2 * b)])[:b]
    qbuf, ql = table.queries(qs)
    b_pad = len(ql)
    qbuf_d = merge_gc.u32_to_device(qbuf, cuda)
    ql_d = torch.from_numpy(ql).to(cuda)
    hw = merge_gc.u32_to_device(pr.pack_query_batch(qs, 8)[0], cuda)
    dk = np.zeros(b_pad, np.int32)
    dk[:b] = [_doc_key_len(q) for q in qs]
    dk[:4] = (0, 1, 5, 32)          # none, a byte, mid-word, 4 * w_hash
    dk = torch.from_numpy(dk).to(cuda)
    tables = [table] + ([pr.FileTable(rows[1:] + rows[:1], cuda)]
                        if n_files > 1 else [])   # file 0 with no filter
    for tb in tables:
        before = pr.hash_probe_files.launches
        got = pr.hash_probe_files(hw, dk, tb, b)
        assert pr.hash_probe_files.launches == before + 1
        for g, x in zip(got, pr.hash_probe_files_plain(hw, dk, tb, b)):
            assert torch.equal(g, x)
        assert torch.equal(torch.stack(got[2:]),
                           torch.stack(pr.fnv64_plain(hw, dk)))
    for read_ht, model_on in (((1 << 64) - 1, True), ((1 << 64) - 1, False),
                              ((1000 + 15000) << 12, True),
                              ((1000 << 12) - 1, True)):
        before = (pr.hash_probe_files.launches, pr.locate_fold.launches)
        maybe, flag, _h1, _h2 = pr.hash_probe_files(hw, dk, table, b)
        w_maybe, w_flag, _w1, _w2 = pr.hash_probe_files_plain(hw, dk, table,
                                                              b)
        assert torch.equal(maybe, w_maybe) and torch.equal(flag, w_flag)
        args = (table, qbuf_d, ql_d, b, read_ht >> 32, read_ht & 0xFFFFFFFF,
                model_on, flag)
        out = pr.locate_fold(*args)
        assert torch.equal(out, pr.locate_fold_plain(*args)), (read_ht,
                                                               model_on)
        assert (pr.hash_probe_files.launches,
                pr.locate_fold.launches) == (before[0] + 1, before[1] + 1)
        best, located, misses = pr.fold_arrays(out.cpu().numpy(), b_pad,
                                               n_files)
        if n_files >= 3:
            assert not located[2] and located[1]
        if n_files >= 4 and model_on and read_ht == (1 << 64) - 1:
            assert misses[3] > 0
        if n_files >= 2 and read_ht == (1 << 64) - 1:
            ties = [i for i, q in enumerate(qs) if q in set(tie_keys)]
            assert ties and all(best[4][i] and best[3][i] == 0
                                for i in ties)
    # the same launches again: deterministic, and the ticket was reset
    out2 = pr.locate_fold(*args)
    assert torch.equal(out, out2)


def test_point_multi_get_on_the_card_equals_native(cuda, tmp_path):
    """DB.multi_get over a DeviceSlabCache on the card launches P1 + P2
    over every file and P3 + the fold once per chunk (never P1 on its own,
    the per-file P2 or P3) and answers what the native per-key path and
    sequential gets answer."""
    from yugabyte_tpu_torch.common.hybrid_time import (DocHybridTime,
                                                       HybridTime)
    from yugabyte_tpu_torch.docdb.value import Value
    from yugabyte_tpu_torch.ops import point_read as pr
    from yugabyte_tpu_torch.storage.db import DB, DBOptions
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    db = DB(str(tmp_path / "db"), DBOptions(
        device="cuda", device_cache=DeviceSlabCache("cuda"),
        auto_compact=False))
    try:
        tomb = Value.tombstone().encode()
        for f in range(3):
            db.write_batch([
                (b"Suser%08d\x00\x00!" % i,
                 DocHybridTime(HybridTime.from_micros(1000 + i + 7 * f), f),
                 tomb if i % 17 == 0 and f == 1 else b"value%d" % f)
                for i in range(f, 3000, 3)], op_id=(1, f + 1))
            db.flush()
        db.write_batch([(b"Suser%08d\x00\x00!" % i,
                         DocHybridTime(HybridTime.from_micros(99_999), 1),
                         b"mem") for i in range(0, 300, 7)], op_id=(1, 9))
        rng = np.random.default_rng(36)
        keys = [b"Suser%08d\x00\x00!" % int(i)
                for i in rng.integers(0, 3300, size=2100)]
        kernels = [pr.fnv64, pr.hash_probe_files, pr.locate_fold,
                   pr.bloom_probe, pr.locate_gather]
        chunks = -(-len(keys) // 1024)
        for micros in (None, 1500, 50_000):
            read_ht = None if micros is None else HybridTime.from_micros(
                micros)
            before = [k.launches for k in kernels]
            got = db.multi_get(keys, read_ht)
            assert [k.launches - b for k, b in zip(kernels, before)] == [
                0, chunks, chunks, 0, 0]
            assert got == db._multi_get_native(keys,
                                               read_ht or HybridTime.kMax)
            assert got[:64] == [db.get(k, read_ht) for k in keys[:64]]
    finally:
        db.close()


# ------------------------------------- kernel L and the carve (chunking)


def _chunk_inputs(rng, k, n, key_space, w):
    runs = [_make_run(rng, int(rng.integers(max(1, n // 2), n + 1)),
                      key_space, w=w) for _ in range(k)]
    st = _staged(runs, "cpu")
    run_ns = np.zeros(st.k_pad, np.int32)
    run_ns[:k] = st.run_ns
    return st, run_ns


@pytest.mark.parametrize("k,n,key_space,w,w_route", [
    (2, 300, 50, 3, 4), (3, 5000, 40, 3, 4), (4, 9000, 100000, 3, 2),
    (8, 700, 9, 3, 1), (5, 3000, 500, 20, 3), (2, 70000, 30000, 3, 4)])
def test_chunk_split_search_kernel_matches_plain(cuda, k, n, key_space, w,
                                                 w_route):
    rng = np.random.default_rng(k * 13 + n)
    st, run_ns = _chunk_inputs(rng, k, n, key_space, w)
    cols = st.cols_dev
    idx = torch.from_numpy(rng.integers(0, st.n_pad, size=40))
    words = cols[8:8 + w_route][:, idx].numpy().view(np.uint32)
    routes = run_merge._mask_route_host(words, cols[1][idx].numpy()).T
    # sampled routes, duplicated splitters, both extremes, random words
    sp = np.concatenate([routes, routes[:5], np.zeros((1, w_route)),
                         np.full((1, w_route), 0xFFFFFFFF),
                         rng.integers(0, 1 << 32, size=(4, w_route))]
                        ).astype(np.uint32)
    sp = torch.from_numpy(sp.view(np.int32))
    n_iters = int(st.m).bit_length() + 1
    want = run_merge.chunk_split_search_plain(
        cols, torch.from_numpy(run_ns), sp, st.k_pad, st.m, w_route,
        n_iters)
    before = run_merge.chunk_split_search.launches
    got = run_merge.chunk_split_search(
        cols.to(cuda), torch.from_numpy(run_ns).to(cuda), sp.to(cuda),
        st.k_pad, st.m, w_route, n_iters)
    assert torch.equal(got.cpu(), want)
    assert run_merge.chunk_split_search.launches == before + 1


@pytest.mark.parametrize("k,n,m_c", [(2, 300, 256), (4, 4096, 1024),
                                     (3, 5000, 4096), (8, 2000, 512),
                                     (4, 70000, 1 << 15)])
def test_carve_chunk_kernel_matches_plain(cuda, k, n, m_c):
    rng = np.random.default_rng(k + n)
    st, run_ns = _chunk_inputs(rng, k, n, 500, 3)
    cols = st.cols_dev.to(cuda)
    cases = []
    for _ in range(3):
        lens = np.array([rng.integers(0, min(m_c, rn) + 1) for rn in run_ns])
        cases.append((np.array([rng.integers(0, rn - ln + 1)
                                for rn, ln in zip(run_ns, lens)]), lens))
    last = k - 1          # the last live run's tail window, and no window
    lens = np.zeros_like(run_ns)
    lens[last] = min(m_c // 2, run_ns[last])
    starts = np.zeros_like(run_ns)
    starts[last] = run_ns[last] - lens[last]
    cases += [(starts, lens), (run_ns.copy(), np.zeros_like(run_ns))]
    for starts, lens in cases:
        before = run_merge.carve_chunk.launches
        got = run_merge.carve_chunk(cols, starts, lens, st.m, m_c, st.k_pad)
        want = run_merge.carve_chunk_plain(cols, starts, lens, st.m, m_c,
                                           st.k_pad)
        assert torch.equal(got, want)
        assert run_merge.carve_chunk.launches == before + 1


def test_chunked_launch_on_the_card_equals_cpu(cuda, monkeypatch):
    """A chunked launch on the card (kernels L, H, A, B) gives the
    unchunked CPU decisions, and its parent-domain products serve kernels
    D and E."""
    rng = np.random.default_rng(23)
    runs = [_make_run(rng, int(rng.integers(3000, 4097)), 2000,
                      ttl_frac=0.2) for _ in range(4)]
    params = merge_gc.GCParams((1 << 19) << 12, False)
    monkeypatch.setenv("YBTPU_MERGE_CHUNK_ROWS", "0")
    h0 = run_merge.launch_merge_gc(_staged(runs, "cpu"), params)
    want = h0.result()
    monkeypatch.setenv("YBTPU_MERGE_CHUNK_ROWS", "4096")
    before = (run_merge.chunk_split_search.launches,
              run_merge.carve_chunk.launches)
    h = run_merge.launch_merge_gc(_staged(runs, cuda), params)
    assert isinstance(h, run_merge._ChunkedMergeGCHandle)
    nc = len(h._handles)
    assert nc >= 2
    assert (run_merge.chunk_split_search.launches,
            run_merge.carve_chunk.launches) == (before[0] + 1,
                                                before[1] + nc)
    for x, y in zip(h.result(), want):
        assert np.array_equal(x, y)
    pos0 = run_merge.survivor_positions(h0)
    pos1 = run_merge.survivor_positions(h)
    assert torch.equal(pos1.cpu(), pos0)
    rows_out = int(want[1].sum())
    for start in range(0, rows_out, 3000):
        end = min(start + 3000, rows_out)
        a = run_merge.gather_staged_output_span(h0, pos0, start, end)
        b = run_merge.gather_staged_output_span(h, pos1, start, end)
        assert torch.equal(b.cols_dev.cpu(), a.cols_dev)


def test_router_skewed_pick_on_the_card_equals_native(cuda, tmp_path):
    """A skewed pick through run_compaction_job on the card takes the
    radix route (kernels G, I.1, B over the host-concatenated slab, no
    kernel H) and writes the native job's files."""
    from yugabyte_tpu_torch.ops import radix
    from yugabyte_tpu_torch.storage import compaction
    from yugabyte_tpu_torch.storage.sst import (Frontier, SSTReader,
                                                SSTWriter)
    rng = np.random.default_rng(29)
    readers = []
    for i, n in enumerate((20000, 300, 300, 300, 300)):
        slab = _make_run(rng, n, 9000, ttl_frac=0.1)
        slab.values = ValueArray(
            rng.integers(0, 256, size=n * 8, dtype=np.uint8),
            np.arange(n + 1, dtype=np.int64) * 8)
        p = str(tmp_path / f"in{i}.sst")
        SSTWriter(p).write(slab, Frontier())
        readers.append(SSTReader(p))
    counters = [radix.radix_sort, radix.sorted_payload, merge_gc.gc_pack]
    before = [c.launches for c in counters]
    concat_before = run_merge.staged_concat.launches
    out = {}
    for name in ("router", "native"):
        (tmp_path / name).mkdir()
        ids = iter(range(100, 200))
        if name == "router":
            out[name] = compaction.run_compaction_job(
                readers, str(tmp_path / name), lambda: next(ids),
                (1 << 19) << 12, True, device="cuda")
        else:
            out[name] = compaction._run_native_job(
                readers, str(tmp_path / name), lambda: next(ids),
                (1 << 19) << 12, True, False, None)
    assert all(c.launches > b for c, b in zip(counters, before))
    assert run_merge.staged_concat.launches == concat_before
    assert len(out["router"].outputs) == len(out["native"].outputs) >= 1
    for (_, pa, _), (_, pb, _) in zip(out["router"].outputs,
                                      out["native"].outputs):
        for suffix in ("", ".sblock.0"):
            with open(pa + suffix, "rb") as fa, open(pb + suffix, "rb") as fb:
                assert fa.read() == fb.read()


# ------------------------------------------------- the mesh (kernels M1-M3)


def _mesh_slab(rng, n, dkl_max=12):
    slab = _make_run(rng, n, max(2, n // 3))
    slab.doc_key_len[:] = rng.integers(0, dkl_max, size=n)
    return slab


# M3's edge layouts: (doc-key bytes at most, capacity or None for the
# factor's); doc keys of no byte route every real row to the last shard
_M3_CARD_EDGES = {
    (8192, 256, 2.0): (12, None),     # kMaxShards, 32 lanes a shard
    (6000, 1, 2.0): (12, None),       # the one-shard mesh: no M1
    (9000, 2, 2.0): (12, 4),          # capacity 4: nearly every row dropped
    (16384, 2, 2.0): (1, None),       # destination 0 empty, 1 exactly full
    (12000, 2, 1.0): (1, None)}       # shard 1: pads alone past capacity


@pytest.mark.parametrize("n,n_shards,factor", [
    (300, 8, 2.0),            # shards 5-7 all pad
    (40000, 3, 0.5),          # 4 tiles a shard, pad columns appended
    (200000, 2, 0.05),        # drops past capacity and the overflow word
    *_M3_CARD_EDGES])
def test_dist_route_kernels_match_plain(cuda, n, n_shards, factor):
    """M1-M3 on the card == their plain versions, M3's send buffer and
    overflow word bit for bit, at its edge layouts too; M3 is one kernel
    a call, with no memset and no copy."""
    from yugabyte_tpu_torch.parallel import dist_compact
    from yugabyte_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(n + n_shards)
    dkl_max, cap = _M3_CARD_EDGES.get((n, n_shards, factor), (12, None))
    mesh = make_mesh(n_shards, devices=[cuda] * n_shards)
    parts, n_local = dist_compact.stage_sharded_cols(
        _mesh_slab(rng, n, dkl_max), mesh)
    w_route = 4
    cap = cap or dist_compact._quantized_capacity(n_local, n_shards, factor)
    samp = dist_compact._sample_matrix(parts, n_local, w_route, cuda)
    before = (dist_compact.splitter_pick.launches,
              dist_compact.route_dest.launches,
              dist_compact.bucket_scatter.launches)
    split = dist_compact.splitter_pick(samp, w_route, n_shards)
    assert torch.equal(split, dist_compact.splitter_pick_plain(
        samp, w_route, n_shards))
    overflow = False
    for s, c in enumerate(parts):
        got = dist_compact.route_dest(c, split, w_route, n_shards)
        want = dist_compact.route_dest_plain(c, split, w_route, n_shards)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        send, ovf = dist_compact.bucket_scatter(c, *got, cap, n_shards,
                                                s * n_local)
        send_p, ovf_p = dist_compact.bucket_scatter_plain(
            c, *got, cap, n_shards, s * n_local)
        assert torch.equal(send, send_p)
        assert int(ovf.item()) == int(ovf_p.item())
        overflow |= bool(ovf.item())
    assert overflow or factor >= 0.1
    assert (dist_compact.splitter_pick.launches,
            dist_compact.route_dest.launches,
            dist_compact.bucket_scatter.launches) == (
        before[0] + (n_shards > 1), before[1] + n_shards,
        before[2] + n_shards)
    m2 = dist_compact.route_dest(parts[0], split, w_route, n_shards)
    assert _device_activity(lambda: dist_compact.bucket_scatter(
        parts[0], *m2, cap, n_shards, 0)) == (1, 0)


def _route_cols(rng, n, w, sorted_keys, pads):
    """A shard's matrix u32 [8 + w, n] for kernel M2: key words from a
    small alphabet (routes collide, so splitters repeat and routes equal
    splitters), doc-key lengths 0..4w+1, sorted by key words or not, and
    `pads` pad columns at the tail."""
    words = rng.choice(np.array([0, 1, 0x53000000, 0x7FFFFFFF, 0xFFFFFFFF],
                                dtype=np.uint32), size=(n, w))
    if sorted_keys:
        words = words[np.lexsort(words.T[::-1])]
    cols = np.zeros((8 + w, n), dtype=np.uint32)
    cols[0] = 4 * w
    cols[1] = rng.integers(0, 4 * w + 2, size=n)
    cols[8:] = words.T
    cols[:, n - pads:] = merge_gc.pad_template(8 + w)[:, None]
    return cols


def _route_splitters(cols, w_route, n_shards, rng):
    """M1's plain splitters over 256 random columns of cols (sorted, so
    never decreasing; equal where routes collide), int32 [w_route, S-1]."""
    from yugabyte_tpu_torch.parallel import dist_compact
    if n_shards == 1:
        return torch.empty((w_route, 0), dtype=torch.int32)
    lanes = np.sort(rng.integers(0, cols.shape[1], size=256))
    rows = [0, 1] + list(range(8, 8 + w_route))
    samp = merge_gc.u32_to_device(
        np.ascontiguousarray(cols[rows][:, lanes]), "cpu")
    return dist_compact.splitter_pick_plain(samp, w_route, n_shards)


# M2's layouts (n, S, w_route, sorted keys, pad columns): S 1, 2, 8 and
# 256, w_route 1-4, n % 4 != 0 (the scalar loads), n below one tile, n not
# a multiple of the tile, pads at the tail
ROUTE_DEST_CASES = [(5000, 1, 4, True, 0), (4097, 2, 1, False, 3),
                    (1003, 8, 2, True, 100), (3 * 4096, 8, 3, False, 0),
                    (1 << 20, 8, 4, True, 1000), (50000, 256, 4, False, 7),
                    (50001, 256, 1, True, 0), (9000, 2, 4, True, 4096)]


@pytest.mark.parametrize("n,n_shards,w_route,sorted_keys,pads",
                         ROUTE_DEST_CASES)
def test_route_dest_kernel_layouts(cuda, n, n_shards, w_route, sorted_keys,
                                   pads):
    """M2 == its plain version (dest, hist, real_hist) on its layouts, one
    launch a call; M3 fed by it == M3's plain version fed the same."""
    from yugabyte_tpu_torch.parallel import dist_compact
    rng = np.random.default_rng(n + n_shards + w_route)
    cols = _route_cols(rng, n, w_route, sorted_keys, pads)
    split = _route_splitters(cols, w_route, n_shards, rng).to(cuda)
    c = merge_gc.u32_to_device(cols, cuda)
    before = dist_compact.route_dest.launches
    got = dist_compact.route_dest(c, split, w_route, n_shards)
    assert dist_compact.route_dest.launches == before + 1
    want = dist_compact.route_dest_plain(c, split, w_route, n_shards)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    cap = dist_compact._quantized_capacity(n, n_shards, 2.0)
    send, ovf = dist_compact.bucket_scatter(c, *got, cap, n_shards, 0)
    send_p, ovf_p = dist_compact.bucket_scatter_plain(c, *want, cap,
                                                      n_shards, 0)
    assert torch.equal(send, send_p) and torch.equal(ovf, ovf_p)
    assert _device_activity(lambda: dist_compact.route_dest(
        c, split, w_route, n_shards)) == (1, 0)


def test_one_shard_mesh_on_the_card(cuda, monkeypatch):
    """make_mesh's one-card mesh: M1 returns an empty splitter tensor on
    the card with no launch and no plain sort; M2 and M3 launch once; the
    job equals the CPU's."""
    from yugabyte_tpu_torch.ops.slabs import concat_slabs
    from yugabyte_tpu_torch.parallel import dist_compact
    from yugabyte_tpu_torch.parallel.mesh import make_mesh
    split = dist_compact.splitter_pick(
        torch.zeros((6, 64), dtype=torch.int32, device=cuda), 4, 1)
    assert split.shape == (4, 0) and split.device.type == cuda.type

    def no_plain(*_a):
        raise AssertionError("plain splitter pick on a CUDA tensor")
    rng = np.random.default_rng(41)
    slab = concat_slabs([_make_run(rng, 5000, 2500) for _ in range(2)])
    params = merge_gc.GCParams((1 << 19) << 12, True)
    want = dist_compact.distributed_compact(
        slab, params, make_mesh(1, devices=["cpu"]))
    monkeypatch.setattr(dist_compact, "splitter_pick_plain", no_plain)
    before = (dist_compact.splitter_pick.launches,
              dist_compact.route_dest.launches,
              dist_compact.bucket_scatter.launches)
    got = dist_compact.distributed_compact(
        slab, params, make_mesh(1, devices=[cuda]))
    assert (dist_compact.splitter_pick.launches,
            dist_compact.route_dest.launches,
            dist_compact.bucket_scatter.launches) == (
        before[0], before[1] + 1, before[2] + 1)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("n_shards", [2, 8])
def test_mesh_compact_on_the_card_equals_cpu(cuda, n_shards):
    """distributed_compact on a mesh of virtual shards on the card equals
    the CPU mesh's in full, pad slots included; so do the gather_spans."""
    from yugabyte_tpu_torch.parallel import dist_compact
    from yugabyte_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(31 + n_shards)
    runs = [_make_run(rng, 6000, 3000, ttl_frac=0.2) for _ in range(3)]
    from yugabyte_tpu_torch.ops.slabs import concat_slabs
    slab = concat_slabs(runs)
    params = merge_gc.GCParams((1 << 19) << 12, False)
    outs = {}
    for name, dev in (("cpu", "cpu"), ("cuda", cuda)):
        mesh = make_mesh(n_shards, devices=[dev] * n_shards)
        outs[name] = dist_compact.distributed_compact_with_outputs(
            slab, params, mesh, capacity_factor=0.5)
    for a, b in zip(outs["cuda"][:3], outs["cpu"][:3]):
        assert np.array_equal(a, b)
    n_out = int(outs["cpu"][0].sum())
    for start, end in ((0, n_out // 2), (n_out // 2, n_out)):
        a = outs["cuda"][3].gather_span(start, end)
        b = outs["cpu"][3].gather_span(start, end)
        assert torch.equal(a.cols_dev.cpu(), b.cols_dev)
    cols, _k, _m, _s = dist_compact.distributed_compact(
        slab, params, make_mesh(n_shards, devices=[cuda] * n_shards))
    cols_c, _k, _m, _s = dist_compact.distributed_compact(
        slab, params, make_mesh(n_shards, devices=["cpu"] * n_shards))
    assert np.array_equal(cols, cols_c)


def test_mesh_router_on_the_card_equals_native(cuda, tmp_path):
    """run_compaction_job with a mesh of 8 virtual shards on the card:
    the combined path (run_compaction_job_dist_native) and the Python path
    (device=None, distributed_compact) write the native job's files, each
    launching M1 once and M2, M3, G, I.1 and B once per shard."""
    import chip_smoke
    from yugabyte_tpu_torch.ops import radix
    from yugabyte_tpu_torch.parallel import dist_compact
    from yugabyte_tpu_torch.parallel.mesh import make_mesh
    from yugabyte_tpu_torch.storage import compaction
    from yugabyte_tpu_torch.utils import flags
    runs = chip_smoke.synth_ycsb_runs(80_000, 4, 40_000, 3)
    (tmp_path / "in").mkdir()
    readers = chip_smoke.write_inputs(runs, str(tmp_path / "in"))
    cutoff = chip_smoke.history_cutoff(80_000)
    mesh = make_mesh(8, devices=[cuda] * 8)
    counters = [dist_compact.splitter_pick, dist_compact.route_dest,
                dist_compact.bucket_scatter, radix.radix_sort,
                radix.sorted_payload, merge_gc.gc_pack,
                merge_path.merge_level]
    old = flags.get_flag("distributed_compaction_min_rows")
    flags.set_flag("distributed_compaction_min_rows", 1000)
    out = {}
    try:
        for name, dev in (("native", "native"), ("combined", "cuda"),
                          ("python", None)):
            (tmp_path / name).mkdir()
            ids = iter(range(100, 200))
            before = [c.launches for c in counters]
            out[name] = compaction.run_compaction_job(
                readers, str(tmp_path / name), lambda: next(ids), cutoff,
                True, device=dev, mesh=mesh if dev != "native" else None)
            if dev != "native":
                assert [c.launches - b for c, b in zip(counters, before)] \
                    == [1, 8, 8, 8, 8, 8, 0], name
    finally:
        flags.set_flag("distributed_compaction_min_rows", old)
    for name in ("combined", "python"):
        assert len(out[name].outputs) == len(out["native"].outputs) >= 1
        for (_, pa, _), (_, pb, _) in zip(out[name].outputs,
                                          out["native"].outputs):
            for suffix in ("", ".sblock.0"):
                with open(pa + suffix, "rb") as fa, \
                        open(pb + suffix, "rb") as fb:
                    assert fa.read() == fb.read(), name


def test_pooled_wave_on_the_card_equals_sequential(cuda):
    """3 jobs in 4 slots on the card: each job's decisions equal a
    sequential launch_merge_gc's; A launches log2(k_pad) times and B once
    per slot, unfilled slots included; gather_span equals the sequential
    span."""
    from yugabyte_tpu_torch.parallel import dist_compact
    from yugabyte_tpu_torch.parallel.mesh import make_mesh
    rng = np.random.default_rng(37)
    jobs, seq = [], []
    for j in range(3):
        runs = [_make_run(rng, 3000, 2500, ttl_frac=0.1) for _ in range(4)]
        params = merge_gc.GCParams(((1 << 18) + j) << 12, True)
        st = dist_compact.stage_pool_slot(
            runs, *dist_compact.pool_slot_bucket(runs))
        jobs.append((st, params))
        seq.append(run_merge.launch_merge_gc(
            run_merge.stage_runs_from_slabs(runs, device=cuda), params))
    before = (merge_path.merge_level.launches, merge_gc.gc_pack.launches)
    handle = dist_compact.pooled_merge_gc(make_mesh(4, devices=[cuda] * 4),
                                          jobs)
    assert (merge_path.merge_level.launches - before[0],
            merge_gc.gc_pack.launches - before[1]) == (4 * 2, 4)
    for got, h in zip(handle.decisions, seq):
        for a, b in zip(got, h.result()):
            assert np.array_equal(a, b)
    n_out = int(handle.decisions[2][1].sum())
    pos = run_merge.survivor_positions(seq[2])
    a = handle.gather_span(2, 0, n_out)
    b = run_merge.gather_staged_output_span(seq[2], pos, 0, n_out)
    assert torch.equal(a.cols_dev, b.cols_dev)


# ------------------ kernel G's onesweep passes and kernel B's tiles at edges


def _u32_rows(rng, rows, n, high):
    """u32 [rows, n]: row r uniform below high[r] (0: constant 0x9E3779B9,
    None: any u32)."""
    out = np.empty((rows, n), dtype=np.uint32)
    for r in range(rows):
        h = high.get(r)
        out[r] = (np.uint32(0x9E3779B9) if h == 0 else rng.integers(
            0, h or (1 << 32), size=n, dtype=np.uint64).astype(np.uint32))
    return out


def _radix_on_card(cuda, cols, rows):
    """Kernel G over cols u32 [R, n] == radix_sort_plain, its statistics
    launches == their plain versions, one counted call; returns (perm,
    the plan, the sorted prefix's length, where the tail block lands)."""
    from yugabyte_tpu_torch.ops import radix
    x = torch.from_numpy(cols.view(np.int32)).to(cuda)
    counts, tail = radix.sort_stats(x, rows)
    want_c, want_t = radix.sort_stats_plain(x.cpu(), rows)
    assert torch.equal(counts.cpu(), want_c)
    assert torch.equal(tail.cpu(), want_t)
    before = radix.radix_sort.launches
    got = radix.radix_sort(x, rows, len(rows))
    assert radix.radix_sort.launches == before + 1
    assert torch.equal(got, radix.radix_sort_plain(x, rows, len(rows)))
    plan, n_prefix, at = radix.sort_plan(counts.cpu().numpy(),
                                         tail.cpu().numpy(), rows, x.shape[1])
    return got, plan, n_prefix, at


@pytest.mark.parametrize("case,n", [("below one tile", 1000),
                                    ("ragged last tile", 3 * 4096 + 77),
                                    ("2^22", 1 << 22)])
def test_radix_passes_at_tile_edges(cuda, case, n):
    rng = np.random.default_rng(n)
    cols = _u32_rows(rng, 13, n, {0: 64, 12: None, 11: 1 << 20, 3: None})
    _perm, plan, _np, _at = _radix_on_card(cuda, cols, [3, 0, 12, 11])
    assert len(plan) >= 6


def test_radix_all_keys_equal_is_the_iota(cuda):
    cols = _u32_rows(np.random.default_rng(5), 13, 9000,
                     {r: 0 for r in range(13)})
    perm, plan, n_prefix, _at = _radix_on_card(cuda, cols,
                                               [4, 3, 2, 0, 12, 11, 10, 9])
    assert len(plan) == 0 and n_prefix == 0
    assert torch.equal(perm.cpu(), torch.arange(9000, dtype=torch.int32))


@pytest.mark.parametrize("kept", [1, 2, 3, 4, 5])
def test_radix_odd_and_even_kept_passes(cuda, kept):
    """Rows below 2^8 keep one pass each, a full row four: 1-5 kept passes
    end in perm whichever buffer the parity starts in."""
    rng = np.random.default_rng(kept)
    high = {r: 0 for r in range(13)}
    sched = [0, 9, 10, 11, 12][:kept] if kept < 5 else [0, 12]
    for r in sched:
        high[r] = 1 << 8
    if kept == 5:
        high[12] = None
    cols = _u32_rows(rng, 13, 20000, high)
    _perm, plan, _np, _at = _radix_on_card(cuda, cols, sched)
    assert len(plan) == kept


@pytest.mark.parametrize("where", ["pads", "first", "middle", "last"])
def test_radix_tail_block(cuda, where):
    """The last 40% of the columns are one repeated column: pads (all-ones
    words and lengths, as pack_cols writes them), or a copy of the
    prefix's smallest, median or largest key. Only the prefix is sorted and
    the block lands after its ties, by the last pass."""
    rng = np.random.default_rng(77)
    n, rows = 1 << 20, [3, 2, 0, 12, 11, 10, 9]
    cols = _u32_rows(rng, 13, n, {0: 40, 2: 12, 3: None, 9: 1 << 16,
                                  10: None, 11: None, 12: None})
    t = 4 * n // 10
    if where == "pads":
        cols[:, n - t:] = merge_gc.pad_template(13)[:, None]
    else:
        keys = np.lexsort(tuple(
            cols[r] ^ np.uint32(0xFFFFFFFF if 2 <= r <= 4 else 0)
            for r in rows))
        src = {"first": keys[0], "middle": keys[n // 3],
               "last": keys[-1]}[where]
        cols[:, n - t:] = cols[:, src][:, None]
    perm, _plan, n_prefix, at = _radix_on_card(cuda, cols, rows)
    assert n_prefix == n - t
    assert torch.equal(perm[at:at + t].cpu(),
                       torch.arange(n - t, n, dtype=torch.int32))


def test_radix_many_duplicates_stay_stable(cuda):
    rng = np.random.default_rng(11)
    cols = _u32_rows(rng, 13, 50000, {r: 3 for r in range(13)})
    cols[9] |= rng.integers(0, 2, size=50000).astype(np.uint32) << 24
    _radix_on_card(cuda, cols, [4, 3, 2, 0, 12, 11, 10, 9])


def test_radix_inverted_ht_and_wid_rows(cuda):
    rng = np.random.default_rng(12)
    cols = _u32_rows(rng, 13, 30000, {2: None, 3: None, 4: 3, 0: 40})
    cols[2][rng.random(30000) < 0.4] |= np.uint32(0x80000000)
    cols[2][:500] = 0  # complemented to all-ones, as pad rows
    _radix_on_card(cuda, cols, [4, 3, 2, 0])


def test_radix_sixteen_row_schedule(cuda):
    rng = np.random.default_rng(16)
    w = 12
    cols = _u32_rows(rng, 8 + w, 40000, {r: 5 for r in range(8 + w)})
    cols[2] = rng.integers(0, 1 << 32, size=40000, dtype=np.uint64
                           ).astype(np.uint32)
    rows = merge_gc.full_sort_sequence(w)
    assert len(rows) == 16
    _radix_on_card(cuda, cols, rows)


def _gc_payload(rng, n, w=2, n_docs=50, n_cols=6, tomb=0.1, ttl=0.0,
                cutoff=1 << 40, k_pad=1, m=None):
    """A merged payload u32 [8 + w + 1, n] in internal-key order: doc
    (word 0, dkl 4), column (word 1; 0 is the root write, key_len 4),
    ht descending, write id descending; TTLs around the cutoff (expiry
    at, one below and one above cutoff's physical time); last row a perm
    below k_pad * m."""
    doc = rng.integers(0, n_docs, n)
    col = rng.integers(0, n_cols + 1, n)
    ht = rng.integers(1 << 30, 1 << 41, n).astype(np.uint64)
    wid = rng.integers(0, 4, n)
    order = np.lexsort((-wid, -ht.astype(np.int64), col, doc))
    doc, col, ht, wid = doc[order], col[order], ht[order], wid[order]
    p = np.zeros((8 + w + 1, n), dtype=np.uint32)
    p[0] = np.where(col == 0, 4, 8)
    p[1] = 4
    p[2] = ht >> np.uint64(32)
    p[3] = ht & np.uint64(0xFFFFFFFF)
    p[4] = wid
    flags = np.where(rng.random(n) < tomb, FLAG_TOMBSTONE, 0)
    has = rng.random(n) < ttl
    flags[has] |= FLAG_HAS_TTL
    p[5] = flags
    phys = (ht >> np.uint64(12)).astype(np.int64)
    ttl_us = (cutoff >> 12) - phys + rng.integers(-1, 2, n)
    ttl_us = np.where(has & (ttl_us > 0), ttl_us,
                      rng.integers(1, 1 << 30, n))
    p[6] = (ttl_us >> 20).astype(np.uint32)
    p[7] = (ttl_us & 0xFFFFF).astype(np.uint32)
    p[8] = doc
    p[9] = col
    p[8 + w] = rng.integers(0, k_pad * (m or n), n)
    return p


def _gc_on_card(cuda, p, w, params, k_pad=1, m=None, snapshot=False,
                perm=None):
    """Kernel B == gc_pack_plain on the same payload (packed, keep, mk),
    one counted call; returns the kernel's outputs."""
    n = p.shape[1]
    x = torch.from_numpy(p.view(np.int32)).to(cuda)
    r = 8 + w
    pt = None if perm is None else torch.from_numpy(
        perm.view(np.int32)).to(cuda)
    before = merge_gc.gc_pack.launches
    got = merge_gc.gc_pack(x[:r] if pt is not None else x, r, w, params,
                           k_pad, m or n, snapshot, pt)
    assert merge_gc.gc_pack.launches == before + 1
    want = merge_gc.gc_pack_plain(x, r, w, params, k_pad, m or n, snapshot,
                                  pt)
    for g, w_ in zip(got, want):
        assert g.shape == w_.shape and torch.equal(g, w_)
    return got


def test_gc_pack_segments_across_tiles(cuda):
    """One full key with 9000 versions (more than 4 tiles of 2048) and one
    document across every tile: both look-backs chain through tiles that
    publish only aggregates."""
    rng = np.random.default_rng(21)
    n, w = 1 << 15, 2
    p = _gc_payload(rng, n, w, n_docs=1, n_cols=40)
    p[9, 1000:10000] = 7        # one column key, 9000 versions
    p[0, 1000:10000] = 8
    ht = np.sort(rng.integers(1 << 30, 1 << 41, 9000))[::-1].astype(np.uint64)
    p[2, 1000:10000] = ht >> np.uint64(32)
    p[3, 1000:10000] = ht & np.uint64(0xFFFFFFFF)
    p[0, 500] = 4               # a root write early in the only document
    p[9, 500] = 0
    for cutoff in (int(ht[4500]), int(ht[100]), 1 << 42):
        for is_major in (True, False):
            _gc_on_card(cuda, p, w, merge_gc.GCParams(cutoff, is_major))


def test_gc_pack_thirty_two_positions(cuda):
    rng = np.random.default_rng(32)
    p = _gc_payload(rng, 32, n_docs=3)
    _gc_on_card(cuda, p, 2, merge_gc.GCParams(1 << 40, True))
    _gc_on_card(cuda, p, 2, merge_gc.GCParams(1 << 40, False), snapshot=True)


@pytest.mark.parametrize("is_major", [True, False])
def test_gc_pack_ttl_expiry_at_the_cutoff_limbs(cuda, is_major):
    rng = np.random.default_rng(41)
    cutoff = ((1 << 28) + 12345) << 12
    p = _gc_payload(rng, 40960, ttl=0.6, cutoff=cutoff)
    got = _gc_on_card(cuda, p, 2, merge_gc.GCParams(cutoff, is_major))
    assert 0 < int(got[2].sum()) or is_major


@pytest.mark.parametrize("snapshot,retain,perm_apart", [
    (True, False, False), (False, True, False), (False, False, True),
    (True, False, True)])
def test_gc_pack_modes(cuda, snapshot, retain, perm_apart):
    rng = np.random.default_rng(51)
    p = _gc_payload(rng, 20480, tomb=0.3, ttl=0.2, cutoff=1 << 40)
    params = merge_gc.GCParams(1 << 40, True, retain)
    perm = np.ascontiguousarray(p[-1]) if perm_apart else None
    _gc_on_card(cuda, p, 2, params, snapshot=snapshot, perm=perm)


@pytest.mark.parametrize("k_pad,b", [(8, 3), (64, 6), (1 << 10, 10)])
def test_gc_pack_source_planes(cuda, k_pad, b):
    rng = np.random.default_rng(k_pad)
    m = 4096
    p = _gc_payload(rng, 8192, k_pad=k_pad, m=m)
    assert merge_gc.n_src_planes(k_pad) == b
    packed, _k, _m = _gc_on_card(cuda, p, 2, merge_gc.GCParams(1 << 40, True),
                                 k_pad, m)
    assert packed.shape == (8192 // 32, 2 + b)


def test_gc_pack_repeated_calls_same_bytes(cuda):
    """50 calls give the same bytes: the tickets and status words are reset
    by each call's memset."""
    rng = np.random.default_rng(50)
    p = _gc_payload(rng, 1 << 16, tomb=0.2, ttl=0.1, cutoff=1 << 40)
    first = _gc_on_card(cuda, p, 2, merge_gc.GCParams(1 << 40, True))
    x = torch.from_numpy(p.view(np.int32)).to(cuda)
    for _ in range(50):
        again = merge_gc.gc_pack(x, 10, 2, merge_gc.GCParams(1 << 40, True),
                                 1, 1 << 16)
        for g, f in zip(again, first):
            assert torch.equal(g, f)


# ------------------------------ kernels I.2 and J.1 at the tiling's edges

_SUBKEYS = (0x4B0001, 0x4B0002, 0x4A0001, 0x4B0003)   # 'K' / 'J' + id
_TAGS = (0x48, 0x49, 0x4A, 0x05)


def _doc_matrix(rng, n, w, doc_lens, keep_mode="random", n_pads=0,
                n_neg=0):
    """A sorted-payload matrix s [8 + w, n] (u32 bits) of documents of the
    given lengths, then n_pads pad lanes: each document a doc key of dkl
    bytes from a 4-letter alphabet (neighbouring documents differ, bounds
    tie on leading words), each lane a bare doc key, a 3-byte column
    subkey or a 5-byte one; n_neg real lanes hold a negative int32
    key_len and zero words. Returns (s, keep, the key bytes of each lane)."""
    stride = 4 * w
    real = n - n_pads
    keys = np.zeros((n, stride), np.uint8)
    klen = np.zeros(n, np.int64)
    dkl = np.zeros(n, np.int64)
    choices = [d for d in (2, 5, 8, 13, 23) if d + 5 <= stride] \
        or [max(0, stride - 3)]
    i, prev = 0, None
    for length in doc_lens:
        if i >= real:
            break
        length = min(length, real - i)
        while True:
            d = int(rng.choice(choices))
            doc = rng.integers(0x40, 0x44, size=d).astype(np.uint8)
            if prev is None or prev != (d, doc.tobytes()):
                break
        prev = (d, doc.tobytes())
        keys[i:i + length, :d] = doc
        dkl[i:i + length] = d
        for t in range(i, i + length):
            kind = int(rng.integers(0, 4))
            if kind == 0 or d + 3 > stride:
                klen[t] = d
            else:
                sub = _SUBKEYS[int(rng.integers(0, len(_SUBKEYS)))]
                keys[t, d:d + 3] = [(sub >> 16) & 0xFF, (sub >> 8) & 0xFF,
                                    sub & 0xFF]
                klen[t] = d + 3
                if kind == 3 and d + 5 <= stride:
                    keys[t, d + 3:d + 5] = rng.integers(0, 4, size=2)
                    klen[t] = d + 5
        i += length
    neg = rng.choice(real, size=min(n_neg, real), replace=False)
    keys[neg] = 0
    klen[neg] = 0x80000005
    words = keys.reshape(n, w, 4).astype(np.uint32)
    words = (words[:, :, 0] << 24) | (words[:, :, 1] << 16) \
        | (words[:, :, 2] << 8) | words[:, :, 3]
    s = rng.integers(0, 1 << 32, size=(8 + w, n), dtype=np.uint64) \
        .astype(np.uint32)
    s[0], s[1], s[8:] = klen.astype(np.uint32), dkl.astype(np.uint32), \
        words.T
    s[0, real:] = s[1, real:] = merge_gc.PAD_SENTINEL
    s[8:, real:] = 0xFFFFFFFF
    keep = {"random": rng.random(n) < 0.7, "none": np.zeros(n, bool),
            "all": np.ones(n, bool)}[keep_mode]
    key_bytes = [keys[t, :int(klen[t]) if klen[t] <= stride else 0]
                 .tobytes() for t in range(n)]
    return s, keep, key_bytes


def _on_card(cuda, s, keep):
    return (torch.from_numpy(np.ascontiguousarray(s).view(np.int32)).to(cuda),
            torch.from_numpy(keep).to(cuda))


def _vals(rng, n):
    """Sorted value words [4, n]: payload lengths 0-12, words from a small
    set (compares tie), a payload tag in the first byte."""
    sv = rng.choice(np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF],
                             np.uint32), size=(4, n))
    sv[0] = rng.integers(0, 13, size=n)
    tags = np.array(_TAGS, np.uint32)[rng.integers(0, len(_TAGS), size=n)]
    sv[1] = (tags << 24) | (sv[1] & 0xFFFFFF)
    return sv


def _slot_ops(rng, p, c):
    """p predicate slots (every operator code, negated or not) and c
    aggregate slots on the matrix's subkeys and tags."""
    p_sub = np.array([_SUBKEYS[k % 4] for k in range(p)], np.uint32)
    p_op = np.array([1 + (k * 2 + int(rng.integers(0, 2))) % 6
                     for k in range(p)], np.int32)
    p_neg = np.array([k % 2 for k in range(p)], np.int32)
    p_ta = np.array([_TAGS[k % 2] for k in range(p)], np.uint32)
    p_tb = np.array([_TAGS[2] for _ in range(p)], np.uint32)
    p_words = rng.choice(np.array([0, 1, 0x80000000, 0xFFFFFFFF], np.uint32),
                         size=(p, 3))
    p_len = rng.integers(0, 13, size=p).astype(np.int32)
    a_ops = (np.array([_SUBKEYS[k] for k in range(c)], np.uint32),
             np.array([_TAGS[0]] * c, np.uint32),
             np.array([_TAGS[1]] * c, np.uint32))
    return (p_sub, p_op, p_neg, p_ta, p_tb, p_words, p_len), a_ops


def _flag_bounds(key_bytes, w, rng):
    """J.1's bound operands: empty / infinite, a lower bound equal to a
    lane's key, an upper bound equal to one, both, and a truncated upper
    bound (keys equal to it kept)."""
    from yugabyte_tpu_torch.ops import scan
    real = sorted({k for k in key_bytes if k and k[0] != 0xFF})
    lo_k = real[len(real) // 4]
    hi_k = real[(3 * len(real)) // 4]
    lo_w, lo_l = scan._pack_bound(lo_k, w)
    hi_w, hi_l = scan._pack_bound(hi_k, w)
    zero = np.zeros(w, np.uint32)
    return [(zero, 0, zero, 0, True, False),
            (lo_w, lo_l, zero, 0, True, False),
            (zero, 0, hi_w, hi_l, False, False),
            (lo_w, lo_l, hi_w, hi_l, False, False),
            (lo_w, lo_l, hi_w, hi_l, False, True)]


def _row_flags_match(cuda, s, keep, sv, w, bounds, p_ops, a_ops):
    from yugabyte_tpu_torch.ops import pushdown
    before = pushdown.row_flags.launches
    got = pushdown.row_flags(s, keep, sv, w, bounds, p_ops, a_ops)
    assert pushdown.row_flags.launches == before + 1
    want = pushdown.row_flags_plain(s, keep, sv, w, bounds, p_ops, a_ops)
    assert torch.equal(got, want)
    return got


def test_row_flags_documents_cross_thread_warp_and_cta(cuda):
    """J.1 against its plain version on documents that start inside a
    thread's 4 lanes and run across a thread, a warp (128 lanes) and a CTA
    (1024 lanes) boundary: lanes 126..1030 are one document; with every
    slot count, value words or none, and every bound kind."""
    from yugabyte_tpu_torch.ops import pushdown
    rng = np.random.default_rng(101)
    n, w = 4096 + 512, 8
    lens = [126, 905, 1, 3, 4, 5, 127, 129, 1023, 1025] + \
        list(rng.integers(1, 40, size=400))
    s_h, keep_h, key_bytes = _doc_matrix(rng, n, w, lens, n_pads=300)
    s, keep = _on_card(cuda, s_h, keep_h)
    sv = torch.from_numpy(_vals(rng, n).view(np.int32)).to(cuda)
    for bounds in _flag_bounds(key_bytes, w, rng):
        for p, c in ((0, 0), (1, 1), (4, 2), (2, 0)):
            p_ops, a_ops = _slot_ops(rng, p, c)
            flags = _row_flags_match(cuda, s, keep, sv, w, bounds, p_ops,
                                     a_ops if c else None)
            _row_flags_match(cuda, s, keep, None, w, bounds, p_ops, None)
    starts = ((flags.cpu().numpy() >> pushdown.NEW_DOC_BIT) & 1).astype(bool)
    assert starts[126] and not starts[127:1031].any() and starts[1031]


@pytest.mark.parametrize("n", [32, 96, 1024 + 32, 3 * 1024 + 96])
@pytest.mark.parametrize("keep_mode", ["none", "all", "random"])
def test_row_flags_at_tile_edges(cuda, n, keep_mode):
    """J.1 at n = 32 and n not a multiple of a CTA's 1024 lanes, with
    all-false, all-true and random keep, against its plain version."""
    rng = np.random.default_rng(n)
    w = 4
    s_h, keep_h, key_bytes = _doc_matrix(
        rng, n, w, list(rng.integers(1, 9, size=n)), keep_mode,
        n_pads=n // 8, n_neg=1)
    s, keep = _on_card(cuda, s_h, keep_h)
    sv = torch.from_numpy(_vals(rng, n).view(np.int32)).to(cuda)
    p_ops, a_ops = _slot_ops(rng, 4, 2)
    for bounds in _flag_bounds(key_bytes, w, rng):
        _row_flags_match(cuda, s, keep, sv, w, bounds, p_ops, a_ops)


@pytest.mark.parametrize("w", [1, 2, 128, 129])
def test_row_flags_key_stride_edges(cuda, w):
    """J.1 at w = 1 (subkey bytes past the stride read as 0), and at the
    by-value cap (128 words) and above it (the bounds on the card)."""
    from yugabyte_tpu_torch.ops import key_bounds
    assert key_bounds.BOUND_CAP == 128
    rng = np.random.default_rng(w)
    n = 2048
    s_h, keep_h, key_bytes = _doc_matrix(
        rng, n, w, list(rng.integers(1, 30, size=n)), n_pads=64)
    s, keep = _on_card(cuda, s_h, keep_h)
    sv = torch.from_numpy(_vals(rng, n).view(np.int32)).to(cuda)
    p_ops, a_ops = _slot_ops(rng, 3, 2)
    for bounds in _flag_bounds(key_bytes, w, rng):
        _row_flags_match(cuda, s, keep, sv, w, bounds, p_ops, a_ops)


def _pack_bounds_cases(key_bytes, w):
    """I.2's (lo_w, lo_l, hi_w, hi_l, has_lower, has_upper, trunc): bounds
    equal to lanes' keys, each alone and both, a truncated upper bound
    equal to a full-stride key, and an empty lower bound."""
    from yugabyte_tpu_torch.ops import scan
    real = sorted({k for k in key_bytes if k and k[0] != 0xFF})
    lo_k, hi_k = real[len(real) // 5], real[(4 * len(real)) // 5]
    full = max(real, key=len)
    lo = scan._pack_bound(lo_k, w)
    hi = scan._pack_bound(hi_k, w)
    fu = scan._pack_bound(full, w)
    zero = (np.zeros(w, np.uint32), 0)
    return [(*lo, *hi, True, True, False), (*lo, *hi, True, True, True),
            (*lo, *zero, True, False, False), (*zero, *hi, False, True, True),
            (*zero, *hi, False, True, False), (*fu, *fu, True, True, True),
            (*zero, *zero, True, False, False),
            (*zero, *zero, False, False, False)]


def _bound_pack_match(cuda, s, keep, w, case):
    from yugabyte_tpu_torch.ops import scan
    lo_w, lo_l, hi_w, hi_l, has_lo, has_hi, trunc = case
    args = (s, keep, w, lo_w, lo_l, hi_w, hi_l, has_lo, has_hi, trunc)
    before = scan.bound_pack.launches
    got = scan.bound_pack(*args)
    assert scan.bound_pack.launches == before + 1
    assert torch.equal(got, scan.bound_pack_plain(*args))


@pytest.mark.parametrize("n", [32, 512 + 32, 4096 + 32, 3 * 4096 + 480])
@pytest.mark.parametrize("keep_mode", ["none", "all", "random"])
def test_bound_pack_at_tile_edges(cuda, n, keep_mode):
    """I.2 at n = 32, n not a multiple of a warp's 512 lanes or a CTA's
    4096, all-false / all-true / random keep, bounds equal to keys and a
    truncated upper bound, against its plain version."""
    rng = np.random.default_rng(n + 7)
    w = 8
    s_h, keep_h, key_bytes = _doc_matrix(
        rng, n, w, list(rng.integers(1, 20, size=n)), keep_mode,
        n_pads=n // 4, n_neg=2)
    s, keep = _on_card(cuda, s_h, keep_h)
    for case in _pack_bounds_cases(key_bytes, w):
        _bound_pack_match(cuda, s, keep, w, case)


@pytest.mark.parametrize("w", [1, 128, 129])
def test_bound_pack_key_stride_edges(cuda, w):
    """I.2 at w = 1, at the by-value cap and above it."""
    rng = np.random.default_rng(w + 3)
    n = 8192
    s_h, keep_h, key_bytes = _doc_matrix(
        rng, n, w, list(rng.integers(1, 30, size=n)), n_pads=100, n_neg=3)
    s, keep = _on_card(cuda, s_h, keep_h)
    for case in _pack_bounds_cases(key_bytes, w):
        _bound_pack_match(cuda, s, keep, w, case)


def _device_activity(fn, reps=3, lead=512, tries=6):
    """(kernel launches, memcpys and memsets) per call of fn in the
    trace of `_device_names`."""
    names = _device_names(fn, reps, lead, tries)
    copies = [x for x in names if x.startswith("Memcpy")
              or x.startswith("Memset")]
    return (len(names) - len(copies)) / reps, len(copies) / reps


def _device_names(fn, reps=3, lead=512, tries=6):
    """The names of the device events of `reps` calls of fn in
    torch.profiler's trace: `lead` one-element adds and a sacrificial
    call first (in a long process a trace loses its first device events,
    as chip_smoke's `profiled` found: the adds are there to be lost), a
    marker kernel (`torch.cuda._sleep`), then `reps` calls, whose device
    events start after the marker. A trace that lost the marker is taken
    again, up to `tries` traces."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                pad.add_(1)
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        marks = [e.time_range.start for e in device
                 if "spin_kernel" in e.name]
        if marks:
            break
    assert marks, f"every one of {tries} traces lost the marker kernel"
    t0 = max(marks)
    return [e.name for e in device if e.time_range.start >= t0
            and "spin_kernel" not in e.name]


def test_bound_pack_and_row_flags_one_kernel_no_copy(cuda):
    """A call of each wrapper is one kernel on the card's timeline and no
    host-to-device copy: the bounds ride in the launch's parameters."""
    from yugabyte_tpu_torch.ops import pushdown, scan
    rng = np.random.default_rng(5)
    n, w = 1 << 16, 8
    s_h, keep_h, key_bytes = _doc_matrix(
        rng, n, w, list(rng.integers(1, 20, size=n)), n_pads=1000)
    s, keep = _on_card(cuda, s_h, keep_h)
    sv = torch.from_numpy(_vals(rng, n).view(np.int32)).to(cuda)
    lo_w, lo_l, hi_w, hi_l, *_ = _pack_bounds_cases(key_bytes, w)[1]
    p_ops, a_ops = _slot_ops(rng, 2, 1)
    bounds = _flag_bounds(key_bytes, w, rng)[4]
    for fn in (lambda: scan.bound_pack(s, keep, w, lo_w, lo_l, hi_w, hi_l,
                                       True, True, True),
               lambda: pushdown.row_flags(s, keep, sv, w, bounds, p_ops,
                                          a_ops)):
        assert _device_activity(fn) == (1, 0)



# ------------------------------------------- J.2 and K at their edges


_J2_LAYOUTS = ["dense", "sparse", "every_lane", "tile_edges", "tile_plus_one",
               "one_segment", "no_first_start", "ends_at_last"]


def _j2_flags(layout, n, seed=0):
    """Flag words of J.2's adversarial layouts (int32): random bits 0-7 and
    the start bit 8 where the layout puts it: segments ending exactly at
    tile edges (`tile_edges`), a tile's first entry ending a segment begun
    in an earlier tile (`tile_plus_one`), one segment over every tile, a
    first lane with no start, a last segment crossing a tile edge to lane
    n - 1 (tests/test_torch_pushdown.py holds the same layouts on the CPU
    against the JAX package)."""
    tile = pushdown.SEGMENT_OR_TILE
    rng = np.random.default_rng(seed)
    flags = rng.integers(0, 1 << 8, size=n, dtype=np.int64)
    if layout == "dense":
        starts = rng.random(n) < 0.3
    elif layout == "sparse":
        starts = rng.random(n) < 2e-3
    elif layout == "every_lane":
        starts = np.ones(n, bool)
    elif layout in ("tile_edges", "tile_plus_one"):
        starts = rng.random(n) < 0.01
        starts[(1 if layout == "tile_plus_one" else 0)::tile] = True
    elif layout == "one_segment":
        starts = np.zeros(n, bool)
        starts[0] = True
    elif layout == "no_first_start":
        starts = rng.random(n) < 0.01
        starts[0] = False
    else:  # ends_at_last
        starts = rng.random(n) < 0.05
        last = max(0, n - tile - 7)
        starts[last:] = False
        starts[last] = True
    return (flags | (starts.astype(np.int64) << 8)).astype(np.int32)


_J2_N = 3 * pushdown.SEGMENT_OR_TILE + 5


@pytest.mark.parametrize("layout,n", [(name, _J2_N) for name in _J2_LAYOUTS]
                         + [("one_segment", 1 << 22), ("ends_at_last", 1 << 22),
                            ("dense", 32), ("sparse", 32), ("one_segment", 4),
                            ("tile_edges", 5 * pushdown.SEGMENT_OR_TILE),
                            ("tile_edges", 33 * pushdown.SEGMENT_OR_TILE + 1),
                            ("sparse", 70 * pushdown.SEGMENT_OR_TILE),
                            ("dense", 1 << 24), ("sparse", 70001)])
def test_segment_or_layouts(cuda, layout, n):
    """J.2 (one launch a call) == its plain version on each layout, at n =
    32, n not a multiple of the tile (nor of 4), one segment over 2^22
    lanes, tails over more than one group of 32 tiles and 2^24 lanes."""
    x = torch.from_numpy(_j2_flags(layout, n)).to(cuda)
    before = pushdown.segment_or.launches
    got = pushdown.segment_or(x)
    assert pushdown.segment_or.launches == before + 1
    assert torch.equal(got, pushdown.segment_or_plain(x))


def _k_inputs(rng, n, mode, cuda):
    """flags, seg and sv for kernel K: `random` bits; `none` no entry
    qualifies for a slot; `all` every row passes and every entry
    qualifies; `limbs` value words at 0 and 0xFFFFFFFF (the payload limbs
    at both ends); `wrap` every entry qualifying with payload bytes 0xFF
    (at 2^25 entries each byte sum wraps u32). Returns (flags, seg, sv,
    p_op, p_neg)."""
    flags = rng.integers(0, 1 << 9, size=n, dtype=np.int64)
    seg = rng.integers(0, 1 << 5, size=n, dtype=np.int64)
    sv = rng.integers(0, 1 << 32, size=(4, n), dtype=np.uint64)
    p_op, p_neg = np.array([1, 3, 0], np.int32), np.array([0, 1, 0], np.int32)
    if mode == "none":
        flags &= ~np.int64(0x60)
    elif mode in ("all", "wrap"):
        flags |= 0x160
        seg |= 1 << 4
        p_op = np.zeros(2, np.int32)
    if mode == "limbs":
        sv = np.where(rng.random((4, n)) < 0.5, 0, 0xFFFFFFFF).astype(np.uint64)
    elif mode == "wrap":
        sv[:] = 0xFFFFFFFF
    t = [torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(cuda)
         for a in (flags, seg, sv)]
    return (*t, p_op, p_neg)


@pytest.mark.parametrize("mode,n,c,c_pad", [
    ("random", 1 << 20, 0, 1), ("random", 1 << 20, 1, 1),
    ("random", 1 << 20, 1, 2), ("random", 1 << 20, 2, 2),
    ("random", 32, 2, 2), ("random", 4, 1, 2), ("random", (1 << 20) + 4, 2, 2),
    ("none", 1 << 20, 1, 1), ("none", 1 << 20, 2, 2), ("all", 1 << 20, 2, 2),
    ("all", 1 << 20, 0, 2), ("limbs", 1 << 20, 1, 1), ("limbs", 1 << 20, 2, 2),
    ("wrap", 1 << 25, 1, 1)])
def test_agg_reduce_edges(cuda, mode, n, c, c_pad):
    """K (one launch a call) == its plain version: 0, 1 and 2 slots (c_pad
    above c leaves zero slots), no qualifying entry (min and max keep
    their identities), every entry qualifying, limbs at 0 and 0xFFFFFFFF,
    byte sums wrapping u32, n = 4, 32 and not a multiple of a CTA's step."""
    rng = np.random.default_rng(n + 10 * c + c_pad)
    flags, seg, sv, p_op, p_neg = _k_inputs(rng, n, mode, cuda)
    before = pushdown.agg_reduce.launches
    got = pushdown.agg_reduce(flags, seg, sv, p_op, p_neg, c, c_pad)
    assert pushdown.agg_reduce.launches == before + 1
    want = pushdown.agg_reduce_plain(flags, seg, sv, p_op, p_neg, c, c_pad)
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    acc, ext = (x.cpu().numpy() for x in got)
    if mode == "none" and c:
        assert (ext[0:2 * c:2] == -1).all() and (ext[1:2 * c:2] == 0).all()
    if mode == "wrap":
        assert (acc[2:10].view(np.uint32).astype(np.int64)
                == (n * 255) & 0xFFFFFFFF).all()


def test_agg_reduce_deterministic(cuda):
    """20 launches of K on one input give one result, the plain one."""
    rng = np.random.default_rng(20)
    flags, seg, sv, p_op, p_neg = _k_inputs(rng, 1 << 22, "random", cuda)
    want = pushdown.agg_reduce_plain(flags, seg, sv, p_op, p_neg, 2, 2)
    for _ in range(20):
        got = pushdown.agg_reduce(flags, seg, sv, p_op, p_neg, 2, 2)
        assert all(torch.equal(g, w_) for g, w_ in zip(got, want))


def test_segment_or_and_agg_reduce_launches(cuda):
    """On the card's timeline a J.2 call is one kernel after one memset,
    a K call one kernel; unaligned inputs and a ragged n raise."""
    rng = np.random.default_rng(21)
    flags, seg, sv, p_op, p_neg = _k_inputs(rng, 1 << 20, "random", cuda)
    assert _device_activity(lambda: pushdown.segment_or(flags)) == (1, 1)
    assert _device_activity(lambda: pushdown.agg_reduce(
        flags, seg, sv, p_op, p_neg, 2, 2)) == (1, 0)
    with pytest.raises(ValueError):
        pushdown.segment_or(flags[1:33])
    with pytest.raises(ValueError):
        pushdown.agg_reduce(flags[1:33], seg[:32], sv[:, :32].contiguous(),
                            p_op, p_neg, 1, 1)
    with pytest.raises(ValueError):
        pushdown.agg_reduce(flags[:30], seg[:30], sv[:, :30].contiguous(),
                            p_op, p_neg, 1, 1)


# ------------------------------------------------- J.3 and M1 at their edges


# J.3's predicate slots (p_op, p_neg): none, one, every slot negated,
# inactive slots between active ones, MAX_PRED slots mixed
_J3_SLOTS = {"none": ([], []), "one": ([5], [0]),
             "all_negated": ([1, 3, 5, 2], [1, 1, 1, 1]),
             "gaps": ([1, 0, 0, 4], [0, 0, 0, 1]),
             "max_pred": ([1, 2, 3, 6], [0, 1, 0, 1])}


def _j3_inputs(rng, n, p_op, p_neg, cuda):
    """flags (random bits 0-8, so base is set on about half the lanes)
    and seg (random bits 0-4, on 70% of lanes forced to pass the verdict,
    so words come out dense and sparse) for kernel J.3, int32 on the
    card."""
    need, want = pushdown.verdict_masks(p_op, p_neg)
    flags = rng.integers(0, 1 << 9, size=n, dtype=np.int64)
    seg = rng.integers(0, 1 << 5, size=n, dtype=np.int64)
    seg = np.where(rng.random(n) < 0.7, (seg & ~need) | want, seg)
    return [torch.from_numpy(a.astype(np.int32)).to(cuda)
            for a in (flags, seg)]


@pytest.mark.parametrize("slots", sorted(_J3_SLOTS))
@pytest.mark.parametrize("n", [32, 96, 4096 + 32, 1 << 20])
def test_row_pass_pack_layouts(cuda, n, slots):
    """J.3 (one launch a call) == its plain version bit for bit at n = 32
    (one word, below a 16-byte store), 96, 4096 + 32 (a word past a CTA's
    step: the word-by-word tail) and 2^20, with no slot, every slot
    negated, inactive slots between active ones and MAX_PRED slots."""
    p_op, p_neg = _J3_SLOTS[slots]
    rng = np.random.default_rng(n + 7 * len(p_op))
    flags, seg = _j3_inputs(rng, n, p_op, p_neg, cuda)
    before = pushdown.row_pass_pack.launches
    got = pushdown.row_pass_pack(flags, seg, p_op, p_neg)
    assert pushdown.row_pass_pack.launches == before + 1
    assert got.shape == (n // 32,)
    assert torch.equal(got, pushdown.row_pass_pack_plain(flags, seg, p_op,
                                                         p_neg))


def test_row_pass_pack_one_kernel_no_memset(cuda):
    """On the card's timeline a J.3 call is one kernel, with no memset and
    no copy; unaligned inputs and a ragged n raise."""
    p_op, p_neg = _J3_SLOTS["max_pred"]
    flags, seg = _j3_inputs(np.random.default_rng(22), 1 << 20, p_op, p_neg,
                            cuda)
    assert _device_activity(lambda: pushdown.row_pass_pack(
        flags, seg, p_op, p_neg)) == (1, 0)
    with pytest.raises(ValueError):
        pushdown.row_pass_pack(flags[1:33], seg[:32], p_op, p_neg)
    with pytest.raises(ValueError):
        pushdown.row_pass_pack(flags[:48], seg[:48], p_op, p_neg)


def _m1_samples(rng, n, w, kind):
    """Kernel M1's samples int32 [2 + w, n] (key_len, doc_key_len, key
    words): words from a small alphabet (tuples repeat), doc-key lengths
    0..4w+1, a quarter pads (key_len PAD_SENTINEL, their other rows
    random); `all_pad` every sample a pad, `no_pad` none, `all_equal`
    every tuple equal, `ff_beside_pads` real routes all 0xFFFFFFFF (every
    doc-key byte set) beside pads, whose route is the same words."""
    samp = np.zeros((2 + w, n), dtype=np.uint32)
    samp[0] = 4 * w
    samp[1] = rng.integers(0, 4 * w + 2, size=n)
    samp[2:] = rng.choice(np.array([0, 1, 0x53000000, 0x7FFFFFFF, 0xFFFFFFFF],
                                   dtype=np.uint32), size=(w, n))
    pad = rng.random(n) < 0.25
    if kind == "all_pad":
        pad[:] = True
    elif kind in ("no_pad", "all_equal"):
        pad[:] = False
    if kind == "all_equal":
        samp[1], samp[2:] = 4 * w, 0x53000000
    elif kind == "ff_beside_pads":
        samp[1], samp[2:] = 4 * w, 0xFFFFFFFF
        pad = rng.random(n) < 0.4
    samp[0, pad] = merge_gc.PAD_SENTINEL
    return samp.view(np.int32)


def _m1_matches_plain(cuda, samp, w, n_shards):
    from yugabyte_tpu_torch.parallel import dist_compact
    t = torch.from_numpy(np.ascontiguousarray(samp)).to(cuda)
    before = dist_compact.splitter_pick.launches
    got = dist_compact.splitter_pick(t, w, n_shards)
    assert dist_compact.splitter_pick.launches == before + 1
    assert got.shape == (w, n_shards - 1)
    assert torch.equal(got, dist_compact.splitter_pick_plain(t, w, n_shards))


@pytest.mark.parametrize("w_route", [1, 2, 3, 4])
@pytest.mark.parametrize("n_shards", [2, 8, 256])
@pytest.mark.parametrize("n_samp", [1, 7, 512, 8192])
def test_splitter_pick_layouts(cuda, n_samp, n_shards, w_route):
    """M1 (one launch a call) == its plain version bit for bit at n_samp
    1, 7, 512 (the mesh job's) and 8192 (the most the wrapper takes: 160
    KB of shared memory at w_route 4), S = 2, 8 and 256, w_route 1-4."""
    rng = np.random.default_rng(n_samp + 3 * n_shards + w_route)
    _m1_matches_plain(cuda, _m1_samples(rng, n_samp, w_route, "random"),
                      w_route, n_shards)


@pytest.mark.parametrize("kind", ["all_pad", "no_pad", "all_equal",
                                  "ff_beside_pads"])
@pytest.mark.parametrize("n_samp,n_shards,w_route", [
    (512, 8, 4), (512, 8, 1), (7, 256, 4), (8192, 256, 2)])
def test_splitter_pick_edges(cuda, kind, n_samp, n_shards, w_route):
    """M1 == its plain version with every sample a pad (n_real 1: the
    first pad's route at every pick), no pad, every tuple equal, and real
    routes of all 0xFFFFFFFF beside pads (the pad flag alone orders
    them)."""
    rng = np.random.default_rng(n_samp + n_shards + w_route + len(kind))
    _m1_matches_plain(cuda, _m1_samples(rng, n_samp, w_route, kind),
                      w_route, n_shards)


def test_splitter_pick_one_kernel_no_copy(cuda):
    """On the card's timeline an M1 call is one kernel, with no memset and
    no copy."""
    from yugabyte_tpu_torch.parallel import dist_compact
    samp = torch.from_numpy(_m1_samples(np.random.default_rng(23), 512, 4,
                                        "random")).to(cuda)
    assert _device_activity(lambda: dist_compact.splitter_pick(
        samp, 4, 8)) == (1, 0)


# ------------------------------------------------ the resident chain (D, E)


def _chain_runs(seed, k, n, key_space):
    """k sorted runs whose hybrid times are one permutation over all rows
    (no internal key repeats across runs), with 16-byte values."""
    rng = np.random.default_rng(seed)
    runs = [_make_run(rng, n, key_space) for _ in range(k)]
    hts = (rng.permutation(k * n).astype(np.uint64) + 1) << 12
    out = []
    for g, s in enumerate(runs):
        ht = hts[g * n:(g + 1) * n]
        order = np.lexsort((~s.write_id, ~ht, s.key_len) + tuple(
            s.key_words[:, j] for j in range(2, -1, -1)))
        out.append(KVSlab(
            key_words=s.key_words[order], key_len=s.key_len[order],
            doc_key_len=s.doc_key_len[order],
            ht_hi=(ht[order] >> 32).astype(np.uint32),
            ht_lo=(ht[order] & 0xFFFFFFFF).astype(np.uint32),
            write_id=s.write_id[order], flags=s.flags[order],
            ttl_ms=s.ttl_ms[order], value_idx=np.arange(n, dtype=np.int32),
            values=ValueArray(
                rng.integers(0, 256, size=16 * n, dtype=np.uint8),
                np.arange(n + 1, dtype=np.int64) * 16)))
    return out


def _chain_files(tmp_path, runs):
    from yugabyte_tpu_torch.storage.sst import SSTWriter
    paths = []
    for i, s in enumerate(runs):
        paths.append(str(tmp_path / f"in{i:03d}.sst"))
        SSTWriter(paths[-1]).write(s)
    return paths


def _chain_job(paths, out_dir, ids, first, device, cache, run_cache=None):
    from yugabyte_tpu_torch.storage import compaction
    from yugabyte_tpu_torch.storage.sst import SSTReader
    out_dir.mkdir()
    it = iter(range(first, first + 500))
    return compaction.run_compaction_job_device_native(
        [SSTReader(p) for p in paths], str(out_dir), lambda: next(it),
        10_000_000 << 12, True, device=device, device_cache=cache,
        input_ids=ids, run_cache=run_cache)


def _bytes(outputs):
    out = []
    for _f, base, _p in outputs:
        for p in (base, base + ".sblock.0"):
            with open(p, "rb") as f:
                out.append(f.read())
    return out


@pytest.mark.parametrize("codec", ["1", "0"])
def test_resident_installer_spans_match_plain(cuda, tmp_path, monkeypatch,
                                              codec):
    """The installer's spans on the card (kernel D once, kernel E per
    output file) equal the plain versions' spans of the same job on the
    CPU, entry for entry, and the files are the same; each span is
    installed at level 1 and no pin is left."""
    from yugabyte_tpu_torch.storage import compaction  # noqa: F401 (flags)
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    from yugabyte_tpu_torch.storage.sst import SSTReader
    from yugabyte_tpu_torch.utils import flags
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", codec)
    paths = _chain_files(tmp_path, _chain_runs(61, 3, 5000, 9000))
    old = flags.get_flag("compaction_max_output_entries_per_sst")
    flags.set_flag("compaction_max_output_entries_per_sst", 3000)
    res = {}
    try:
        for i, dev in enumerate(("cuda", "cpu")):
            cache = DeviceSlabCache(dev)
            for fid, p in enumerate(paths):
                cache.stage(fid, SSTReader(p).read_all())
            d0 = run_merge.survivor_scan.launches
            e0 = run_merge.span_gather.launches
            r = _chain_job(paths, tmp_path / f"job{i}", [0, 1, 2], 100, dev,
                           cache)
            res[dev] = (r, cache, run_merge.survivor_scan.launches - d0,
                        run_merge.span_gather.launches - e0)
    finally:
        flags.set_flag("compaction_max_output_entries_per_sst", old)
    (card, c_cache, d, e), (cpu, p_cache, _d, _e) = res["cuda"], res["cpu"]
    assert len(card.outputs) >= 2 and _bytes(card.outputs) == \
        _bytes(cpu.outputs)
    assert d == 1 and e == len(card.outputs)
    for fid, _b, _p in card.outputs:
        got, want = c_cache.get(fid), p_cache.get(fid)
        assert (got.n, got.n_pad, got.w) == (want.n, want.n_pad, want.w)
        assert torch.equal(got.cols_dev.cpu(), want.cols_dev)
        assert c_cache.level_of(fid) == 1
    assert c_cache.pinned_count() == 0


def test_stage_from_raw_on_card_matches_stage(cuda, tmp_path):
    """stage_from_raw (kernel C on the card) == stage of read_all, bit
    for bit, with the same column stats."""
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    from yugabyte_tpu_torch.storage.sst import SSTReader, SSTWriter
    runs = _chain_runs(62, 2, 20000, 30000)
    cache = DeviceSlabCache("cuda")
    for i, s in enumerate(runs):
        p = str(tmp_path / f"{i}.sst")
        SSTWriter(p, block_entries=1000).write(s)
        r = SSTReader(p)
        raw = cache.stage_from_raw(("raw", i), block_codec.parse_raw_file(
            r.read_raw(), r.block_handles))
        host = cache.stage(("host", i), r.read_all())
        assert torch.equal(raw.cols_dev, host.cols_dev)
        assert (raw.n, raw.n_pad, raw.w) == (host.n, host.n_pad, host.w)
        assert np.array_equal(raw.col_const, host.col_const)


@pytest.mark.parametrize("route", ["codec", "run_cached"])
def test_warm_chain_equals_cold_on_card(cuda, tmp_path, monkeypatch, route):
    """A warm chained L1 -> L2 job on the card (inputs resident, and on
    the run-cached route in the run cache) writes the cold job's files,
    file for file, with no key-column upload, no host block decode (and
    on the run-cached route no shell ingest)."""
    from yugabyte_tpu_torch.storage import compaction, sst
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    from yugabyte_tpu_torch.storage.run_cache import (NamespacedRunCache,
                                                      NativeRunCache,
                                                      export_reader)
    from yugabyte_tpu_torch.storage.sst import SSTReader
    paths = _chain_files(tmp_path, _chain_runs(63, 4, 6000, 8000))
    cache = DeviceSlabCache("cuda")
    rc = (NamespacedRunCache(NativeRunCache(1 << 30), "t")
          if route == "run_cached" else None)
    for fid, p in enumerate(paths):
        cache.stage(fid, SSTReader(p).read_all())
        if rc is not None:
            export_reader(rc, fid, SSTReader(p))
    a = _chain_job(paths[:2], tmp_path / "a", [0, 1], 100, "cuda", cache, rc)
    b = _chain_job(paths[2:], tmp_path / "b", [2, 3], 200, "cuda", cache, rc)
    l1 = a.outputs + b.outputs
    l1_paths = [p for _f, p, _pr in l1]
    # the sampled checks decode host blocks when they fire: off for the
    # counted job, as in the JAX package's chain tests
    from yugabyte_tpu_torch.utils import flags
    samples = {k: flags.get_flag(k) for k in ("shadow_verify_sample",
                                              "resident_digest_sample")}
    for k in samples:
        flags.set_flag(k, 0.0)
    try:
        before = (sst.blocks_decoded(), merge_gc.key_col_uploads(),
                  compaction.ingest_decodes())
        warm = _chain_job(l1_paths, tmp_path / "warm",
                          [f for f, _p, _pr in l1], 300, "cuda", cache, rc)
        after = (sst.blocks_decoded(), merge_gc.key_col_uploads(),
                 compaction.ingest_decodes())
    finally:
        for k, v in samples.items():
            flags.set_flag(k, v)
    cold_cache = DeviceSlabCache("cuda")
    cold = _chain_job(l1_paths, tmp_path / "cold", [f for f, _p, _pr in l1],
                      300, "cuda", cold_cache)
    assert warm.rows_out == cold.rows_out
    assert _bytes(warm.outputs) == _bytes(cold.outputs)
    assert after[:2] == before[:2]
    if route == "run_cached":
        assert after[2] == before[2]
    assert all(cache.level_of(f) == 2 for f, _p, _pr in warm.outputs)
    assert cache.pinned_count() == 0


# ----------------------------------------------- device-fault containment
@pytest.fixture
def fault_state():
    """Disarmed, a fresh board, the sampled checks off; restored after."""
    from yugabyte_tpu_torch.ops import device_faults
    from yugabyte_tpu_torch.storage import integrity  # noqa: F401 (flags)
    from yugabyte_tpu_torch.storage.bucket_health import health_board
    from yugabyte_tpu_torch.utils import flags
    keys = ("shadow_verify_sample", "resident_digest_sample",
            "device_fault_quarantine_s")
    old = {k: flags.get_flag(k) for k in keys}
    flags.set_flag("shadow_verify_sample", 0.0)
    flags.set_flag("resident_digest_sample", 0.0)
    device_faults.disarm_all()
    health_board().reset()
    yield health_board()
    device_faults.disarm_all()
    health_board().reset()
    for k, v in old.items():
        flags.set_flag(k, v)
    torch.cuda.set_per_process_memory_fraction(1.0)


def _native_files(paths, out_dir):
    from yugabyte_tpu_torch.storage import compaction
    from yugabyte_tpu_torch.storage.sst import SSTReader
    out_dir.mkdir()
    it = iter(range(100, 600))
    return _bytes(compaction._run_native_job(
        [SSTReader(p) for p in paths], str(out_dir), lambda: next(it),
        10_000_000 << 12, True, False, None).outputs)


def _quarantined(board):
    return sorted((k["family"], tuple(k["bucket"]))
                  for k in board.snapshot()["keys"]
                  if k["state"] == "quarantined")


@pytest.mark.parametrize("route", ["codec", "shell"])
def test_real_oom_is_contained_on_card(cuda, tmp_path, monkeypatch,
                                       fault_state, route):
    """The caching allocator capped below the job's staging: the job's
    first allocation raises a real torch.cuda.OutOfMemoryError, which
    is_device_fault classifies; the job completes natively (files equal
    to native), the cache holds no pin, and once the cap is lifted and
    the window decayed a device job over the same cache writes the files
    a cached device job wrote before the cap (a job with a cache fits
    learned indexes into its base files, which the native job's lack),
    and a device job without a cache writes the native files."""
    import time as _time
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    from yugabyte_tpu_torch.utils import flags
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "1" if route == "codec"
                       else "0")
    paths = _chain_files(tmp_path, _chain_runs(71, 4, 300_000, 500_000))
    native = _native_files(paths, tmp_path / "native")
    flags.set_flag("device_fault_quarantine_s", 0.5)
    cached = _bytes(_chain_job(paths, tmp_path / "cached", [0, 1, 2, 3],
                               100, "cuda", DeviceSlabCache("cuda")).outputs)
    cache = DeviceSlabCache("cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    cap = torch.cuda.memory_reserved() + (4 << 20)
    torch.cuda.set_per_process_memory_fraction(cap / total)
    from yugabyte_tpu_torch.storage import compaction
    fb = compaction._storage_fallback_counter()
    f0 = fb.value()
    try:
        res = _chain_job(paths, tmp_path / "capped", [0, 1, 2, 3], 100,
                         "cuda", cache)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
        torch.cuda.empty_cache()
    assert _bytes(res.outputs) == native
    assert fb.value() == f0 + 1
    assert cache.pinned_count() == 0
    assert _quarantined(fault_state) and all(
        f in ("run_merge_fused", "block_decode")
        for f, _b in _quarantined(fault_state))
    _time.sleep(0.6)
    after = _chain_job(paths, tmp_path / "after", [0, 1, 2, 3], 100,
                       "cuda", cache)
    assert _bytes(after.outputs) == cached
    assert cache.pinned_count() == 0
    again = _chain_job(paths, tmp_path / "again", None, 100, "cuda", None)
    assert _bytes(again.outputs) == native
    assert fb.value() == f0 + 1


def test_build_and_contract_errors_are_not_contained(cuda, tmp_path,
                                                     monkeypatch,
                                                     fault_state):
    """A kernel library that fails to build and a wrapper's contract
    error are bugs: is_device_fault refuses them and the job raises
    instead of completing natively."""
    from yugabyte_tpu_torch.ops import device_faults
    from yugabyte_tpu_torch.storage import compaction
    from yugabyte_tpu_torch.utils import torch_setup
    with pytest.raises(Exception) as build:
        torch_setup.load_cuda_lib("no_such_kernel.cu")
    assert not device_faults.is_device_fault(build.value)
    p = torch.zeros((9, 64), dtype=torch.int32, device=cuda)[:, 1:]
    with pytest.raises(ValueError) as contract:
        merge_gc.gc_pack(p, 8, 1, merge_gc.GCParams(0, True), 1, 63)
    assert not device_faults.is_device_fault(contract.value)
    paths = _chain_files(tmp_path, _chain_runs(72, 3, 2000, 3000))

    def broken(*a, **k):
        raise ValueError("gc_pack: p_mat must start 16-byte aligned")
    monkeypatch.setattr(run_merge, "gc_pack", broken)
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "0")
    fb = compaction._storage_fallback_counter().value()
    with pytest.raises(ValueError, match="aligned"):
        _chain_job(paths, tmp_path / "job", None, 100, "cuda", None)
    assert compaction._storage_fallback_counter().value() == fb
    assert not _quarantined(fault_state)
    assert not list((tmp_path / "job").iterdir())


@pytest.mark.parametrize("case", ["merge_dispatch", "codec_decode",
                                  "point_read", "pushdown", "mesh"])
def test_armed_fault_parks_exactly_its_bucket(cuda, tmp_path, monkeypatch,
                                              fault_state, case):
    """An armed fault at each family's site on the card parks exactly the
    (family, bucket) keys of the launches it hit, and the answer is the
    native one."""
    from yugabyte_tpu_torch.ops import device_faults, scan
    from yugabyte_tpu_torch.storage import compaction
    from yugabyte_tpu_torch.storage.sst import SSTReader
    if case in ("merge_dispatch", "codec_decode", "mesh"):
        monkeypatch.setenv("YBTPU_DEVICE_CODEC",
                           "1" if case == "codec_decode" else "0")
        paths = _chain_files(tmp_path, _chain_runs(73, 3, 3000, 4000))
        native = _native_files(paths, tmp_path / "native")
        if case == "mesh":
            from yugabyte_tpu_torch.parallel.mesh import make_mesh
            from yugabyte_tpu_torch.utils import flags
            old = flags.get_flag("distributed_compaction_min_rows")
            flags.set_flag("distributed_compaction_min_rows", 1000)
            device_faults.arm("oom", "dispatch", 1)
            try:
                (tmp_path / "mesh").mkdir()
                it = iter(range(100, 600))
                res = compaction.run_compaction_job(
                    [SSTReader(p) for p in paths], str(tmp_path / "mesh"),
                    lambda: next(it), 10_000_000 << 12, True,
                    device="cuda", mesh=make_mesh(2, devices=[cuda] * 2))
            finally:
                flags.set_flag("distributed_compaction_min_rows", old)
            want = [("dist_compact", (2, 8192))]
        else:
            spec = (("runtime", "dispatch", 1) if case == "merge_dispatch"
                    else ("oom", "result", 2))
            device_faults.arm(*spec)
            res = _chain_job(paths, tmp_path / "job", None, 100, "cuda",
                             None)
            want = [("run_merge_fused", (4, 4096))]
            if case == "codec_decode":
                want = [("block_decode", (1, 4096))] + want
        assert _bytes(res.outputs) == native
        assert _quarantined(fault_state) == want
        return
    if case == "point_read":
        from yugabyte_tpu_torch.common.hybrid_time import (DocHybridTime,
                                                           HybridTime)
        from yugabyte_tpu_torch.storage.db import DB, DBOptions
        from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
        db = DB(str(tmp_path / "db"), DBOptions(
            device="cuda", device_cache=DeviceSlabCache("cuda"),
            auto_compact=False))
        try:
            for f in range(2):
                db.write_batch([(b"Suser%08d\x00\x00!" % i, DocHybridTime(
                    HybridTime.from_micros(1000 + i + 7 * f), f), b"v")
                    for i in range(f, 3000, 2)])
                db.flush()
            keys = [b"Suser%08d\x00\x00!" % i for i in range(0, 3100, 3)]
            device_faults.arm("oom", "result", 1)
            got = db.multi_get(keys)
            assert got == db._multi_get_native(keys, HybridTime.kMax)
            assert _quarantined(fault_state) == [("point_read_locate",
                                                  (1, 2048))]
        finally:
            db.close()
        return
    from yugabyte_tpu_torch.docdb.scan_spec import PushdownUnsupported
    runs, read_ht = _table_runs(78, 3, 2500, 2000)
    spec = _pushdown_specs()[0]
    srcs = [scan.SlabSource(s, False) for s in runs]
    device_faults.arm("runtime", "result", 1)
    with pytest.raises(PushdownUnsupported, match="fault"):
        scan.aggregate_sources(srcs, read_ht, spec, device="cuda")
    n_pad = merge_gc.bucket_size(sum(s.n for s in runs))
    assert _quarantined(fault_state) == [("scan_agg", (1, n_pad))]
    with pytest.raises(PushdownUnsupported, match="quarantined"):
        scan.aggregate_sources(srcs, read_ht, spec, device="cuda")


# ------------------------------------------------- the DB's entry points


def _db_pair(tmp_path, tag, **kw):
    """A DB on the card (its cache there) and its "native" twin, with
    the same options."""
    from yugabyte_tpu_torch.common.hybrid_time import HybridTime
    from yugabyte_tpu_torch.storage.db import DB, DBOptions
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    kw.setdefault("retention_policy", lambda: HybridTime.kMax.value)
    card = DB(str(tmp_path / f"{tag}_card"), DBOptions(
        device="cuda", device_cache=kw.pop("device_cache", None)
        or DeviceSlabCache("cuda"), **kw))
    kw.pop("mesh_pool", None)
    kw.pop("compaction_pool", None)
    native = DB(str(tmp_path / f"{tag}_native"),
                DBOptions(device="native", **kw))
    return card, native


def _db_writes(dbs, gen, n=6000, seed=0):
    from yugabyte_tpu_torch.common.hybrid_time import (DocHybridTime,
                                                       HybridTime)
    from yugabyte_tpu_torch.docdb.value import Value
    rng = np.random.default_rng(seed + gen)
    ids = rng.integers(0, 4000, size=n)
    tomb = rng.random(n) < 0.05
    items = [(b"Suser%08d\x00\x00!" % k,
              DocHybridTime(HybridTime.from_micros(100_000 * (gen + 1) + i),
                            0),
              Value.tombstone().encode() if t else b"v%d-%d" % (gen, i))
             for i, (k, t) in enumerate(zip(ids.tolist(), tomb.tolist()))]
    for db in dbs:
        db.write_batch(items, op_id=(1, gen + 1))
        db.flush()


def _db_data(db):
    from yugabyte_tpu_torch.storage.sst import data_file_name
    return [open(data_file_name(fm.path), "rb").read()
            for fm in sorted(db.versions.live_files(),
                             key=lambda f: f.file_id)]


def test_db_scheduled_compaction_and_scans_on_the_card(cuda, tmp_path):
    """DBOptions(device="cuda", device_cache on the card, auto_compact):
    the 4th flush schedules the universal pick, which runs the codec
    route on the card over the flushes' resident entries (kernels A, B,
    D-F, H; the outputs resident at L1) and
    writes the native DB's data files; compact_all then takes the
    resident chain; scan_visible, unbounded and over a range, launches
    G, H, I.1, B (and one I.2 for the range) and answers what the native
    DB's scan_native(visible=True) answers."""
    from yugabyte_tpu_torch.common.hybrid_time import HybridTime
    from yugabyte_tpu_torch.ops import radix, scan
    from yugabyte_tpu_torch.utils import flags
    flags.set_flag("compaction_run_cache_mb", 0)      # the codec route
    card, native = _db_pair(tmp_path, "sched")
    # the flushes wrote through to the cache: no decode on the card
    kernels = [merge_path.merge_level, merge_gc.gc_pack,
               block_codec.block_encode]
    try:
        before = [k.launches for k in kernels]
        for gen in range(4):
            _db_writes((card, native), gen)
        assert card.compaction_stats.to_dict()["compactions"] == 1
        assert all(k.launches > b for k, b in zip(kernels, before))
        assert _db_data(card) == _db_data(native) and _db_data(card)
        assert all(card._device_cache.level_of(fm.file_id) == 1
                   for fm in card.versions.live_files())
        for gen in range(4, 6):
            _db_writes((card, native), gen, n=1500)
        card.compact_all()
        native.compact_all()
        assert _db_data(card) == _db_data(native)
        assert card._device_cache.pinned_count() == 0
        read_ht = HybridTime.kMax.value - 1
        for lo, hi, bounds in ((None, None, 0), (500, 2500, 1)):
            lower = None if lo is None else b"Suser%08d\x00\x00!" % lo
            upper = None if hi is None else b"Suser%08d\x00\x00!" % hi
            counted = [radix.radix_sort, radix.sorted_payload,
                       merge_gc.gc_pack, scan.bound_pack]
            before = [k.launches for k in counted]
            got = list(card.scan_visible(read_ht, lower, upper))
            moved = [k.launches - b for k, b in zip(counted, before)]
            assert moved == [1, 1, 1, bounds]
            want = []
            for b in native.scan_native(lower or b"", upper, read_ht,
                                        visible=True).batches():
                for i in range(b.n):
                    want.append(
                        (b.keys[b.key_offs[i]:b.key_offs[i + 1]].tobytes(),
                         b.vals[b.val_offs[i]:b.val_offs[i + 1]].tobytes()))
            assert [(k, v) for k, v, _h in got] == want and want
    finally:
        card.close()
        native.close()
        flags.reset_flag("compaction_run_cache_mb")


def test_db_mesh_pool_wave_on_the_card(cuda, tmp_path):
    """8 DBs sharing CompactionPool(8 virtual shards of the card) as
    DBOptions.mesh_pool: their scheduled compactions ride one wave (A + B
    on every slot), their files equal their native twins', no pin left."""
    import threading
    from yugabyte_tpu_torch.parallel.mesh import make_mesh
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    from yugabyte_tpu_torch.tserver.compaction_pool import CompactionPool
    from yugabyte_tpu_torch.utils import sync_point
    from yugabyte_tpu_torch.utils.threadpool import PriorityThreadPool
    release = threading.Event()
    sync_point.arm("compaction_pool:take_round", lambda: release.wait(120))
    pool = CompactionPool(make_mesh(8, devices=[cuda] * 8))
    threads = PriorityThreadPool(8, name="card-tablets")
    shared = DeviceSlabCache(cuda)
    pairs = []
    try:
        w0 = (pool.snapshot()["waves"], pool.snapshot()["wave_jobs"])
        a0 = merge_gc.gc_pack.launches
        for t in range(8):
            pairs.append(_db_pair(
                tmp_path, f"t{t}", mesh_pool=pool, compaction_pool=threads,
                device_cache=pool.partition_for(shared, f"t{t}", f"t{t}")))
        for gen in range(4):
            for t, pair in enumerate(pairs):
                _db_writes(pair, gen, n=3000, seed=100 * t)
        for _ in range(1200):
            if pool.snapshot()["queue_depth"] == 8:
                break
            threading.Event().wait(0.05)
        release.set()
        threads.wait_idle()
        snap = pool.snapshot()
        assert (snap["waves"] - w0[0], snap["wave_jobs"] - w0[1]) == (1, 8)
        assert merge_gc.gc_pack.launches - a0 == 8
        for card, native in pairs:
            assert card.compaction_stats.to_dict()["compactions"] == 1
            assert _db_data(card) == _db_data(native) and _db_data(card)
        assert shared.pinned_count() == 0
    finally:
        release.set()
        sync_point.disarm("compaction_pool:take_round")
        for pair in pairs:
            for db in pair:
                db.close()
        threads.shutdown()
        pool.shutdown()


# -------------------------------------------------------------- the tablet


def _tablet_pair(tmp_path, n=6000, seed=20):
    """A Tablet on the card (its regular DB with a DeviceSlabCache) and a
    device-free (device="native") Tablet on one deterministic clock, each
    written the same rows of (k STRING range key, v STRING) in 3 flushes."""
    from yugabyte_tpu_torch.common.hybrid_time import HybridClock
    from yugabyte_tpu_torch.common.schema import (ColumnSchema, DataType,
                                                  Schema)
    from yugabyte_tpu_torch.docdb.doc_key import DocKey
    from yugabyte_tpu_torch.docdb.doc_operations import (QLWriteOp,
                                                         WriteOpKind)
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    from yugabyte_tpu_torch.tablet.tablet import Tablet, TabletOptions
    schema = Schema([ColumnSchema("k", DataType.STRING),
                     ColumnSchema("v", DataType.STRING)],
                    num_range_key_columns=1)
    tablets = []
    for kw in (dict(device="cuda", device_cache=DeviceSlabCache("cuda")),
               dict(device="native")):
        t = Tablet("t", str(tmp_path / str(len(tablets))), schema,
                   clock=HybridClock(lambda: 10**12),
                   options=TabletOptions(auto_compact=False, **kw))
        rng = np.random.default_rng(seed)
        for f in range(3):
            ids = rng.integers(0, n, size=n // 2)
            t.write([QLWriteOp(
                WriteOpKind.DELETE_ROW if i % 13 == 0 and f else
                WriteOpKind.INSERT, DocKey(range_components=("k%06d" % i,)),
                {} if i % 13 == 0 and f else {"v": "v%d-%d" % (f, i)})
                for i in ids])
            t.flush()
        tablets.append(t)
    return tablets, [DocKey(range_components=("k%06d" % i,))
                     for i in range(0, n + 50, 3)]


def _rows(rows):
    return [None if r is None else (r.doc_key.encode(),
                                    sorted(r.columns.items()),
                                    r.write_ht.value) for r in rows]


def test_tablet_on_the_card_equals_device_free(cuda, tmp_path):
    """A small Tablet on the card: multi_read (P1 + P2 and P3 + the fold
    once per 1024-key chunk: liveness, v and the bare key a row), a full
    scan (G, H, I.1, B), a range scan forced onto the card (+ I.2) and
    compact (its inputs run-cached by their flushes: the shell route, A,
    B, D, E, H, P4) equal the device-free Tablet's answers and data
    files."""
    from yugabyte_tpu_torch.ops import point_read, radix, scan
    from yugabyte_tpu_torch.storage.sst import data_file_name
    (dev, free), keys = _tablet_pair(tmp_path)
    kernels = {"p12": point_read.hash_probe_files,
               "p3": point_read.locate_fold, "p1": point_read.fnv64,
               "G": radix.radix_sort, "I1": radix.sorted_payload,
               "B": merge_gc.gc_pack, "H": run_merge.staged_concat,
               "I2": scan.bound_pack, "A": merge_path.merge_level,
               "D": run_merge.survivor_scan, "E": run_merge.span_gather,
               "F": block_codec.block_encode,
               "P4": point_read.index_fit}

    def counted(fn):
        before = {k: w.launches for k, w in kernels.items()}
        res = fn()
        torch.cuda.synchronize()
        return res, {k: w.launches - before[k] for k, w in kernels.items()
                     if w.launches - before[k]}

    try:
        for step in ("before", "after"):
            got, n = counted(lambda: _rows(dev.multi_read(keys)))
            chunks = -(-3 * len(keys) // 1024)
            assert n == {"p12": chunks, "p3": chunks}, n
            assert got == _rows(free.multi_read(keys))
            it = dev.scan()
            got, n = counted(lambda: _rows(it))
            # H concatenates the sources: none when one file is live
            h = {"H": 1} if dev.regular_db.n_live_files > 1 else {}
            assert n == {"G": 1, "I1": 1, "B": 1, **h}, n
            assert got == _rows(free.scan()) and got
            lo, hi = keys[100].encode(), keys[400].encode()
            got, n = counted(lambda: _rows(dev.scan(
                lower_doc_key=lo, upper_doc_key=hi, use_device=True)))
            assert n == {"G": 1, "I1": 1, "B": 1, "I2": 1, **h}, n
            assert got == _rows(free.scan(lower_doc_key=lo,
                                          upper_doc_key=hi))
            if step == "before":
                _, n = counted(dev.compact)
                outs = dev.regular_db.n_live_files
                # every input was exported to the run cache by its
                # flush: the shell route (no F), its outputs written
                # through (D, E) with a learned index (P4)
                assert n == {"A": 2, "B": 1, "D": 1, "H": 1, "E": outs,
                             "P4": outs}, n
                free.compact()
                for a, b in zip(dev.regular_db.versions.live_files(),
                                free.regular_db.versions.live_files()):
                    with open(data_file_name(a.path), "rb") as fa, \
                            open(data_file_name(b.path), "rb") as fb:
                        assert fa.read() == fb.read()
        assert dev.regular_db._device_cache.pinned_count() == 0
    finally:
        dev.close()
        free.close()


# ---------------------------------------------------- the replicated tablet


def test_replicated_tablet_on_the_card_equals_device_free(cuda, tmp_path):
    """Two Raft groups of three TabletPeers over a LocalTransport, one on
    the card (a DeviceSlabCache a replica), one device-free
    (device="native"), taking the same writes through a forced leader:
    the leader's multi_read (P1 + P2 and P3 + the fold a chunk) and every
    replica's flushed files equal the device-free group's, each card
    replica's compaction (A-F, H, P4) writes the native one's data files,
    and after ts0 fails over to ts1 and restarts (its bootstrap replays
    its WAL into a card tablet) every replica reads alike."""
    import time
    from chip_smoke import StepTime
    from yugabyte_tpu_torch.common.hybrid_time import HybridClock, HybridTime
    from yugabyte_tpu_torch.common.schema import (ColumnSchema, DataType,
                                                  Schema)
    from yugabyte_tpu_torch.consensus.transport import LocalTransport
    from yugabyte_tpu_torch.docdb.doc_key import DocKey
    from yugabyte_tpu_torch.docdb.doc_operations import (QLWriteOp,
                                                         WriteOpKind)
    from yugabyte_tpu_torch.ops import point_read
    from yugabyte_tpu_torch.storage.device_cache import DeviceSlabCache
    from yugabyte_tpu_torch.storage.sst import data_file_name
    from yugabyte_tpu_torch.tablet.tablet import TabletOptions
    from yugabyte_tpu_torch.tablet.tablet_peer import TabletPeer

    schema = Schema([ColumnSchema("k", DataType.STRING),
                     ColumnSchema("v", DataType.STRING)],
                    num_range_key_columns=1)
    servers = ("ts0", "ts1", "ts2")

    def wait(pred, what, timeout=60.0):
        deadline = time.monotonic() + timeout
        while not pred():
            assert time.monotonic() < deadline, f"timed out: {what}"
            time.sleep(0.005)

    groups = {}
    for tag in ("card", "free"):
        groups[tag] = {"time": StepTime(10**15, 1000), "net": LocalTransport(),
                       "peers": {}}

    def open_peer(tag, s):
        g = groups[tag]
        opts = (TabletOptions(device="cuda", auto_compact=False,
                              device_cache=DeviceSlabCache("cuda"))
                if tag == "card" else
                TabletOptions(device="native", auto_compact=False))
        g["peers"][s] = TabletPeer(
            "t", str(tmp_path / tag / s), schema, s, servers, g["net"],
            clock=HybridClock(g["time"]), options=opts).start(
                election_timer=False)

    def elect(tag, s):
        p = groups[tag]["peers"][s]
        p.raft.start_election(ignore_lease=True)
        wait(lambda: p.raft.is_leader() and p.raft.leader_ready(),
             f"{tag} {s} to lead")

    def quiesce(tag, leader):
        ps = groups[tag]["peers"]
        target = ps[leader].raft.commit_index
        wait(lambda: all(p.raft.last_applied >= target for p in ps.values()),
             f"{tag} to apply {target}")

    def write(tag, leader, ops):
        groups[tag]["time"].arm()
        return groups[tag]["peers"][leader].write(ops).value

    def ops_of(rng, n=600, key_space=2000):
        return [QLWriteOp(WriteOpKind.INSERT,
                          DocKey(range_components=("k%05d" % i,)),
                          {"v": "v%d" % rng.integers(1 << 30)})
                for i in rng.choice(key_space, size=n, replace=False)]

    keys = [DocKey(range_components=("k%05d" % i,))
            for i in range(0, 2050, 2)]
    try:
        for tag in groups:
            for s in servers:
                open_peer(tag, s)
            elect(tag, "ts0")
        rng = np.random.default_rng(21)
        for f in range(2):
            for _c in range(3):
                ops = ops_of(rng)
                hts = {tag: write(tag, "ts0", ops) for tag in groups}
                assert hts["card"] == hts["free"]
            for tag in groups:
                quiesce(tag, "ts0")
                for p in groups[tag]["peers"].values():
                    p.tablet.flush()
        ref = tmp_path / "free" / "ts0" / "regular"
        names = sorted(x.name for x in ref.iterdir()
                       if ".sst" in x.name or x.name == "MANIFEST")
        for tag in groups:
            for s in servers:
                d = tmp_path / tag / s / "regular"
                for name in names:
                    assert (d / name).read_bytes() == (ref / name).read_bytes()
        before = (point_read.hash_probe_files.launches,
                  point_read.locate_fold.launches)
        got = _rows(groups["card"]["peers"]["ts0"].multi_read(keys))
        torch.cuda.synchronize()
        chunks = -(-3 * len(keys) // 1024)
        assert (point_read.hash_probe_files.launches - before[0],
                point_read.locate_fold.launches - before[1]) == \
            (chunks, chunks)
        assert got == _rows(groups["free"]["peers"]["ts0"].multi_read(keys))
        for s in servers:
            dev = groups["card"]["peers"][s].tablet
            nat = groups["free"]["peers"][s].tablet
            dev.compact()
            nat.compact()
            for a, b in zip(dev.regular_db.versions.live_files(),
                            nat.regular_db.versions.live_files()):
                assert open(data_file_name(a.path), "rb").read() == \
                    open(data_file_name(b.path), "rb").read()
        last = {}
        for tag, g in groups.items():
            g["peers"].pop("ts0").shutdown()
            g["net"].unregister("ts0/t")
            elect(tag, "ts1")
        ops = ops_of(rng)
        for tag in groups:
            last[tag] = write(tag, "ts1", ops)
            open_peer(tag, "ts0")
            quiesce(tag, "ts1")
        answers = {}
        for tag, g in groups.items():
            for s, p in sorted(g["peers"].items()):
                if not p.raft.is_leader():
                    p.grant_vouch(0)
                answers[(tag, s)] = _rows(p.multi_read(
                    keys, read_ht=HybridTime(last[tag]),
                    allow_follower=True))
        assert len(set(map(str, answers.values()))) == 1
        for p in groups["card"]["peers"].values():
            assert p.tablet.regular_db._device_cache.pinned_count() == 0
    finally:
        for g in groups.values():
            for p in g["peers"].values():
                p.shutdown()


# ------------------------------------------------------- the tablet server


def test_tablet_server_on_the_card_equals_device_free(cuda, tmp_path):
    """A default TabletServer (its execution context on the card: one
    DeviceSlabCache, block cache, compaction pool and health board for
    its tablets) beside a device-free one (device="native"), each
    hosting one tablet and taking the same writes through its `tserver`
    service on the test thread (StepTime clocks: equal hybrid times):
    four flushes schedule a compaction on each server's pool (A-F, H,
    P4 on the card) that writes the native job's data files (MANIFEST
    edit for edit); multi_read (P1 + P2 and P3 + the fold a chunk), the
    pushdown scan and a filtered scan answer alike; the maintenance
    manager's pick is the same; a flush and compact_tablet again."""
    import time
    from chip_smoke import StepTime, same_db_files, same_manifest
    from yugabyte_tpu_torch.common.hybrid_time import HybridClock
    from yugabyte_tpu_torch.common.schema import (ColumnSchema, DataType,
                                                  Schema)
    from yugabyte_tpu_torch.common.wire import (doc_key_to_wire,
                                                schema_to_wire,
                                                write_op_to_wire)
    from yugabyte_tpu_torch.docdb.doc_key import DocKey
    from yugabyte_tpu_torch.docdb.doc_operations import (QLWriteOp,
                                                         WriteOpKind)
    from yugabyte_tpu_torch.ops import point_read
    from yugabyte_tpu_torch.tserver import TabletServer, TabletServerOptions
    from yugabyte_tpu_torch.tserver import maintenance_manager  # noqa: F401
    from yugabyte_tpu_torch.utils import flags

    schema = Schema([ColumnSchema("k", DataType.STRING),
                     ColumnSchema("v", DataType.INT64)],
                    num_range_key_columns=1)
    flags.set_flag("scan_pushdown_min_rows", 1)
    flags.set_flag("maintenance_manager_polling_interval_s", 3600)
    servers, clocks = {}, {}
    try:
        for tag, dev in (("card", None), ("free", "native")):
            ts = TabletServer(TabletServerOptions(
                f"{tag}0", str(tmp_path / tag), device=dev,
                webserver_port=None))
            clocks[tag] = StepTime(10**15, 1000)
            ts.clock = ts.tablet_manager.clock = HybridClock(clocks[tag])
            servers[tag] = ts.start()
            ts.tablet_manager.create_tablet(
                "t", "tbl", schema_to_wire(schema), [f"{tag}0"])
            p = ts.tablet_manager.get_tablet("t")
            p.raft.start_election(ignore_lease=True)
            deadline = time.monotonic() + 60
            while not (p.raft.is_leader() and p.raft.leader_ready()):
                assert time.monotonic() < deadline, f"{tag}: no leader"
                time.sleep(0.005)
        card = servers["card"].exec_context
        assert card.device.type == "cuda" and card.device_cache is not None
        rng = np.random.default_rng(23)
        for _f in range(4):
            ids = rng.choice(4000, size=900, replace=False)
            vals = rng.integers(-1000, 1000, size=900)
            ops = [write_op_to_wire(QLWriteOp(
                WriteOpKind.INSERT, DocKey(range_components=("k%05d" % i,)),
                {"v": int(v)})) for i, v in zip(ids, vals)]
            hts = {}
            for tag, ts in servers.items():
                clocks[tag].arm()
                hts[tag] = ts.service.write("t", ops)["propagated_ht"]
                ts.service.flush_tablet("t")
            assert hts["card"] == hts["free"]
        peers = {tag: ts.tablet_manager.get_tablet("t")
                 for tag, ts in servers.items()}
        dbs = {tag: p.tablet.regular_db for tag, p in peers.items()}
        # the fourth flush scheduled a universal compaction on each
        # server's pool (auto_compact, the default)
        for ts in servers.values():
            ts.exec_context.pool.wait_idle()
        assert dbs["card"].n_live_files == dbs["free"].n_live_files == 1
        same_db_files(dbs["card"], dbs["free"], "tserver auto compaction")
        same_manifest(dbs["card"], dbs["free"], "tserver auto compaction")
        keys = [doc_key_to_wire(DocKey(range_components=("k%05d" % i,)))
                for i in range(0, 4100, 3)]
        before = (point_read.hash_probe_files.launches,
                  point_read.locate_fold.launches)
        got = {tag: ts.service.multi_read("t", keys)
               for tag, ts in servers.items()}
        torch.cuda.synchronize()
        chunks = -(-3 * len(keys) // 1024)
        assert (point_read.hash_probe_files.launches - before[0],
                point_read.locate_fold.launches - before[1]) == \
            (chunks, chunks)
        assert got["card"] == got["free"]
        # the pushdown on the card (J, K); the device-free tablet answers
        # in rows and the caller aggregates, as the client does
        agg = servers["card"].service.scan(
            "t", filters=[["v", ">", 0]],
            aggregates=[["count", None], ["sum", "v"]])["agg"]
        rows = servers["free"].service.scan("t", filters=[["v", ">", 0]])
        vals = [r["columns"][0] for r in rows["rows"]]
        assert (agg["rows"], agg["cols"][0]["sum"]) == (len(vals), sum(vals))
        filtered = {tag: ts.service.scan("t", filters=[["v", "<", -900]])
                    for tag, ts in servers.items()}
        assert filtered["card"]["pushdown"]
        assert filtered["card"]["rows"] == filtered["free"]["rows"]
        picks = {tag: ts.maintenance_manager.run_once()
                 for tag, ts in servers.items()}
        assert picks["card"] == picks["free"]
        for ts in servers.values():
            ts.service.flush_tablet("t")
            ts.service.compact_tablet("t")
            ts.exec_context.pool.wait_idle()
        same_db_files(dbs["card"], dbs["free"], "tserver compact")
        same_manifest(dbs["card"], dbs["free"], "tserver compact")
        assert card.device_cache.pinned_count() == 0
        got = {tag: ts.service.multi_read("t", keys)
               for tag, ts in servers.items()}
        assert got["card"] == got["free"]
    finally:
        for ts in servers.values():
            ts.shutdown()
        flags.reset_flag("scan_pushdown_min_rows")
        flags.reset_flag("maintenance_manager_polling_interval_s")
