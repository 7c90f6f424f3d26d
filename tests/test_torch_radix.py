"""Kernel G's host plan on the CPU: the statistics, the passes kept, the
buffers each pass reads and writes and the tail block (ops/radix.py
`sort_stats_plain`, `sort_plan`, `pass_plan`).

The card runs the plan in csrc/radix.cu; here a numpy model of it (each
onesweep pass a stable counting sort of the prefix by one 8-bit digit,
keys gathered through the previous perm on a row's first pass, the tail
block placed at `at` by the last pass) runs the same plan over the same
buffers, and its perm must equal `radix_sort_plain`'s, which the scan
tests hold against the JAX package's `sort_and_gc`; one case here is held
against the JAX loop directly. Inputs come from numpy with a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yugabyte_tpu.ops import merge_gc as ref_mg
from yugabyte_tpu_torch.ops import merge_gc, radix


def _run_plan(cols: np.ndarray, plan: np.ndarray, n_prefix: int,
              at: int) -> np.ndarray:
    """The plan executed as the kernel does, pass by pass, over named
    buffers (an unwritten buffer is None, so a pass that reads one fails),
    over the first n_prefix columns; the tail block lands at `at`."""
    n = cols.shape[1]
    keys = {radix.KEYS_A: None, radix.KEYS_B: None}
    perms = {radix.PERM: None, radix.TMP: None}
    prefix = np.arange(n_prefix, dtype=np.int32)
    for row, digit, _slot, ksrc, kdst, psrc, pdst in plan:
        perm_in = (np.arange(n_prefix, dtype=np.int64) if psrc == radix.IOTA
                   else perms[psrc].astype(np.int64))
        if ksrc == radix.GATHER:
            inv = np.uint32(0xFFFFFFFF if 2 <= row <= 4 else 0)
            key = cols[row][perm_in] ^ inv
        else:
            key = keys[ksrc]
        assert key is not None and len(key) == n_prefix
        order = np.argsort((key >> np.uint32(8 * digit)) & np.uint32(0xFF),
                           kind="stable")
        if kdst != radix.NO_KEYS:
            assert kdst != ksrc
            keys[kdst] = key[order]
        assert pdst != psrc
        perms[pdst] = perm_in[order].astype(np.int32)
    if len(plan):
        assert plan[-1][6] == radix.PERM
        prefix = perms[radix.PERM]
    block = np.arange(n_prefix, n, dtype=np.int32)
    return np.concatenate([prefix[:at], block, prefix[at:]])


def _plan(cols: np.ndarray, rows):
    x = torch.from_numpy(cols.view(np.int32))
    counts, tail = radix.sort_stats_plain(x, rows)
    plan, n_prefix, at = radix.sort_plan(counts.numpy(), tail.numpy(), rows,
                                         cols.shape[1])
    return counts.numpy(), tail.numpy(), plan, n_prefix, at


def _want(cols: np.ndarray, rows) -> np.ndarray:
    return radix.radix_sort_plain(torch.from_numpy(cols.view(np.int32)),
                                  rows, len(rows)).numpy()


def _cols(rng, n, rows=13, const_rows=(), low_rows=(), pad=0):
    """A random u32 [rows, n] matrix: `const_rows` constant, `low_rows`
    below 2^8 (digits 1-3 constant), the last `pad` columns all-0xFF."""
    cols = rng.integers(0, 1 << 32, size=(rows, n), dtype=np.uint64
                        ).astype(np.uint32)
    for r in const_rows:
        cols[r] = np.uint32(rng.integers(0, 1 << 32))
    for r in low_rows:
        cols[r] = rng.integers(0, 256, size=n).astype(np.uint32)
    if pad:
        cols[:, n - pad:] = 0xFFFFFFFF
    return cols


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 100), (2, 4097), (3, 20000)])
def test_digit_counts_plain_matches_numpy(seed, n):
    rng = np.random.default_rng(seed)
    cols = _cols(rng, n, low_rows=(0, 9))
    rows = [4, 3, 2, 0, 12, 11, 10, 9]
    got = radix.digit_counts_plain(torch.from_numpy(cols.view(np.int32)),
                                   rows).numpy()
    assert got.shape == (len(rows), 4, 256) and got.dtype == np.int32
    for k, row in enumerate(rows):
        key = cols[row] ^ np.uint32(0xFFFFFFFF if 2 <= row <= 4 else 0)
        for p in range(4):
            want = np.bincount((key >> np.uint32(8 * p)) & np.uint32(0xFF),
                               minlength=256)
            assert np.array_equal(got[k, p], want), (row, p)


_CASES = ["random", "constant rows", "low rows", "pad tail", "odd kept",
          "even kept", "all equal", "one key"]


@pytest.mark.parametrize("case", _CASES)
def test_pass_plan_keeps_the_non_constant_digits(case):
    rng = np.random.default_rng(_CASES.index(case))
    n = 1 if case == "one key" else 5000
    rows = [4, 3, 2, 0, 12, 11, 10, 9]
    kw = {"random": {}, "constant rows": {"const_rows": (3, 11)},
          "low rows": {"low_rows": (4, 0, 9)},
          "pad tail": {"low_rows": (0,), "pad": 700},
          "odd kept": {"const_rows": (4, 3, 2, 12, 11, 10, 9),
                       "low_rows": (0,)},
          "even kept": {"const_rows": (4, 3, 2, 12, 11, 10),
                        "low_rows": (0, 9)},
          "all equal": {"const_rows": tuple(range(13))},
          "one key": {}}[case]
    cols = _cols(rng, n, **kw)
    counts, tail, plan, n_prefix, at = _plan(cols, rows)
    assert n_prefix == {"pad tail": n - 700, "all equal": 0,
                        "one key": 0}.get(case, n - 1)
    # the counts cover the prefix before the tail block
    assert np.array_equal(counts, radix.digit_counts_plain(
        torch.from_numpy(cols[:, :n_prefix].view(np.int32)), rows).numpy())
    kept = {(int(r), int(d)) for r, d in plan[:, :2]}
    for k, row in enumerate(rows):
        for p in range(4):
            assert ((row, p) in kept) == (counts[k, p].max() < n_prefix)
    assert [tuple(x) for x in plan[:, :2]] == sorted(
        kept, key=lambda rd: (rows.index(rd[0]), rd[1]))
    assert all(plan[:, 2] == [4 * rows.index(r) + d for r, d in plan[:, :2]])
    if case == "odd kept":
        assert len(plan) == 1
    if case == "even kept":
        assert len(plan) == 2 and plan[0, 6] == radix.TMP
    if case in ("all equal", "one key"):
        assert len(plan) == 0
    assert np.array_equal(_run_plan(cols, plan, n_prefix, at),
                          _want(cols, rows))


@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_tail_block_lands_among_its_ties(where):
    """The last 300 columns copy one column of the prefix: the block sorts
    after that column's ties in the prefix, wherever its key falls."""
    rng = np.random.default_rng(7)
    n, rows = 3000, [4, 3, 0, 10, 9]
    cols = _cols(rng, n, low_rows=(4, 0, 10, 9))
    keys = np.lexsort(tuple(cols[r] ^ np.uint32(0xFFFFFFFF if 2 <= r <= 4
                                                else 0) for r in rows))
    src = {"first": keys[0], "middle": keys[n // 2], "last": keys[-1]}[where]
    cols[:, n - 300:] = cols[:, src][:, None]
    _c, tail, plan, n_prefix, at = _plan(cols, rows)
    assert n_prefix == n - 300
    assert tail[1] - 300 == at
    got = _run_plan(cols, plan, n_prefix, at)
    assert np.array_equal(got, _want(cols, rows))
    assert np.array_equal(got[at:at + 300], np.arange(n - 300, n))


def test_pass_plan_sixteen_rows_matches_jax():
    """A 16-row schedule (w = 12) with many duplicate keys, the plan run
    by the numpy model == the JAX package's radix loop."""
    rng = np.random.default_rng(16)
    n, w = 3000, 12
    cols = rng.integers(0, 3, size=(8 + w, n)).astype(np.uint32)
    cols[2] = rng.integers(0, 1 << 32, size=n, dtype=np.uint64
                           ).astype(np.uint32) & np.uint32(0x80000003)
    rows = merge_gc.full_sort_sequence(w)
    assert len(rows) == 16
    _c, _t, plan, n_prefix, at = _plan(cols, rows)
    got = _run_plan(cols, plan, n_prefix, at)
    # jitted as the JAX package runs it (one compile, cached on disk by
    # the package, instead of compiling each eager operation)
    perm, _keep, _mk = jax.jit(ref_mg.sort_and_gc, static_argnums=(5, 6, 7))(
        jnp.asarray(cols), jnp.uint32(0), jnp.uint32(0), jnp.uint32(0),
        jnp.uint32(0), w, True, False)
    assert np.array_equal(got, np.asarray(perm))
