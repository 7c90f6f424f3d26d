"""Concatenation of staged inputs on the device.

Counterpart of two functions of yugabyte_tpu/storage/device_cache.py:
`merged_column_stats` (:488) and `concat_staged` (:510). The device slab
cache itself (the module's classes) is not ported yet: the scan stages
every input from its decoded slab.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from yugabyte_tpu_torch.ops.merge_gc import (_ROW_WORDS, StagedCols,
                                             bucket_size, build_sort_schedule)


def merged_column_stats(staged_list: Sequence[StagedCols], w: int
                        ) -> np.ndarray:
    """Cross-input is_const vector over staged inputs: a row prunes from
    the sort schedule only when it is constant WITH THE SAME VALUE across
    every input (constant-per-input with differing values still orders the
    merge). Inputs narrower than w expose their extra word rows as
    constant zero; inputs without column stats poison every row they
    cover as non-constant."""
    r_total = _ROW_WORDS + w
    k = len(staged_list)
    consts = np.zeros((k, r_total), dtype=bool)
    firsts = np.zeros((k, r_total), dtype=np.uint32)
    for i, s in enumerate(staged_list):
        rs = min(_ROW_WORDS + s.w, r_total)
        consts[i, rs:] = True              # implicit zero-pad word rows
        if s.col_const is not None:
            consts[i, :rs] = s.col_const[:rs]
            firsts[i, :rs] = s.col_first[:rs]
    return consts.all(axis=0) & (firsts == firsts[0:1]).all(axis=0)


def concat_staged(staged_list: Sequence[StagedCols]) -> StagedCols:
    """Concatenate staged inputs ON THE DEVICE into one padded cols matrix
    (kernel H through run_merge._concat_staged_fused): each input's width
    padded to the max, the real rows laid out back to back, the tail
    padded to the bucket size. The merged sort schedule prunes rows by the
    cross-input column stats."""
    from yugabyte_tpu_torch.ops.run_merge import _concat_staged_fused

    w = max(s.w for s in staged_list)
    n = sum(s.n for s in staged_list)
    n_pad = bucket_size(n)
    cat = _concat_staged_fused([s.cols_dev for s in staged_list],
                               [s.n for s in staged_list], w=w, n_pad=n_pad)
    sort_rows, n_sort = build_sort_schedule(
        w, merged_column_stats(staged_list, w))
    return StagedCols(cat, n, n_pad, w, sort_rows=sort_rows, n_sort=n_sort)
