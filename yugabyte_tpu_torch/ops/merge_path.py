"""Merge-path tournament level: the wrapper of kernel A and its plain twin.

Counterpart of yugabyte_tpu/ops/pallas_merge.py (`_merge_level`, the JAX
package's only Pallas kernel). The kernel is csrc/merge_path.cu; see its
header for the design and its bound on an H100.

A payload matrix p_mat is int32 [rp, n] (u32 bits): rows 0..rp-2 are the
cols layout of ops/merge_gc.py, the LAST row is the global run-major index
of each column. Runs of length L are sorted under the comparator: the
pruned compare rows (most significant first; ht_hi/ht_lo/write_id
descending, i.e. complemented) then the global index. One level merges
each pair of adjacent runs into one sorted run of length 2L.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from yugabyte_tpu_torch.ops.merge_gc import (_ROW_HT_HI, _ROW_WID, _U32, _u,
                                             to_u32_bits)
from yugabyte_tpu_torch.utils import torch_setup

_SMEM_BUDGET = 48 * 1024   # default per-CTA shared memory, no opt-in
_THREADS = 256


def _inv_word(row: int) -> int:
    """Complement mask for descending comparator rows (ht_hi/ht_lo/wid)."""
    return _U32 if _ROW_HT_HI <= row <= _ROW_WID else 0


def cmp_desc(cmp_rows: Sequence[int]) -> Tuple[List[int], List[int]]:
    """(rows, complement masks) of the comparator, duplicates dropped: the
    n_cmp lattice repeats the last row, which never changes a
    lexicographic compare."""
    rows: List[int] = []
    for r in cmp_rows:
        if int(r) not in rows:
            rows.append(int(r))
    return rows, [_inv_word(r) for r in rows]


def tile_for(c: int, L: int) -> int:
    """Output positions per CTA: the largest power of two <= 2048 whose
    shared windows (c compare words + one source index per position) fit
    the default 48 KB, at least one position per thread, at most 2L."""
    tile = 2048
    while tile > _THREADS and (c + 1) * tile * 4 + 8 * c > _SMEM_BUDGET:
        tile //= 2
    return min(tile, 2 * L)


def merge_level_plain(p_mat: torch.Tensor, L: int,
                      cmp_rows: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version: per pair, a chained stable sort of its 2L
    columns by (comparator tuple, global index), least significant key
    first, with the pair id as the most significant part of every key."""
    rp, n = p_mat.shape
    rows, inv = cmp_desc(cmp_rows)
    dev = p_mat.device
    pair = torch.arange(n, device=dev) // (2 * L)
    order = torch.arange(n, device=dev)
    for row, iv in [(rp - 1, 0)] + list(zip(rows, inv))[::-1]:
        key = (pair << 32) | (_u(p_mat[row, order]) ^ iv)
        order = order[torch.sort(key, stable=True).indices]
    return p_mat[:, order]


_mp_lib = None


def _lib():
    global _mp_lib
    if _mp_lib is None:
        lib = torch_setup.load_cuda_lib("merge_path.cu")
        lib.ybt_merge_level.restype = ctypes.c_int
        lib.ybt_merge_level.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        _mp_lib = lib
    return _mp_lib


def merge_level(p_mat: torch.Tensor, L: int,
                cmp_rows: Sequence[int]) -> torch.Tensor:
    """Kernel A wrapper: one tournament level, returns a new [rp, n]
    payload. CPU tensor: merge_level_plain. CUDA tensor: csrc/merge_path.cu,
    counted in `merge_level.launches` (one per level)."""
    rp, n = p_mat.shape
    if L <= 0 or n % (2 * L):
        raise ValueError(f"merge_level: n={n} is not a multiple of 2L={2 * L}")
    if not p_mat.is_cuda:
        return merge_level_plain(p_mat, L, cmp_rows)
    torch_setup.check_u32_matrix(p_mat, "merge_level")
    rows, inv = cmp_desc(cmp_rows)
    if max(rows) >= rp - 1:
        raise ValueError(f"merge_level: compare row {max(rows)} is not a "
                         f"cols row of a [{rp}, n] payload")
    dev = p_mat.device
    desc = to_u32_bits(torch.tensor(rows + inv, dtype=torch.int64)).to(dev)
    out = torch.empty_like(p_mat)
    rc = _lib().ybt_merge_level(
        p_mat.data_ptr(), out.data_ptr(), rp, n, L, desc.data_ptr(),
        len(rows), tile_for(len(rows), L), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "merge_level")
    merge_level.launches += 1
    return out


merge_level.launches = 0
