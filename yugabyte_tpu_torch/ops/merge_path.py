"""Merge-path tournament level: the wrapper of kernel A and its plain twin.

Counterpart of yugabyte_tpu/ops/pallas_merge.py (`_merge_level`, the JAX
package's only Pallas kernel). The kernel is csrc/merge_path.cu, two
launches a level (every tile boundary, then the tiles); see its header for
the design and its bound on an H100.

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

from yugabyte_tpu_torch.ops.merge_gc import _ROW_HT_HI, _ROW_WID, _U32, _u
from yugabyte_tpu_torch.utils import torch_setup

# Shared memory a tile CTA may plan for: a third of an H100 SM's 233,472
# bytes less the 1 KB the hardware keeps per CTA, so that three CTAs fit.
_SMEM_BUDGET = 233472 // 3 - 1024
_SMEM_MAX = 232448         # the most one CTA can opt in to
_PAD = 12                  # words a shared row holds beyond the tile (kPad)
_PER = 4                   # merged outputs per tile thread (kPer)
_MAX_CMP = 128             # compare rows the kernel's descriptor holds


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


def smem_bytes(rp: int, c: int, tile: int) -> int:
    """Dynamic shared memory of one tile CTA (ybt_merge_tiles_smem_bytes):
    rp rows of the tile rounded up to 4 words plus _PAD, then three words
    per compare row."""
    return (rp * (-(-tile // 4) * 4 + _PAD) + 3 * c) * 4


def tile_for(rp: int, c: int, L: int) -> int:
    """Output positions per tile CTA: the largest power of two <= 2048
    whose rp shared rows fit _SMEM_BUDGET (down to 32), at most 2L."""
    tile = 2048
    while tile > 32 and smem_bytes(rp, c, tile) > _SMEM_BUDGET:
        tile //= 2
    return min(tile, 2 * L)


def tile_plan(rp: int, c: int, L: int) -> Tuple[int, int, int]:
    """(tile, threads, shared bytes) of a level's tile launch; raises
    when the CTA cannot hold its windows."""
    tile = tile_for(rp, c, L)
    nbytes = smem_bytes(rp, c, tile)
    if nbytes > _SMEM_MAX or c > _MAX_CMP:
        raise ValueError(f"merge_level: {rp} rows and {c} compare rows do "
                         f"not fit a tile CTA ({nbytes} bytes)")
    threads = -(-tile // _PER)
    return tile, -(-threads // 32) * 32, nbytes


def _lex_gt(keys: List[torch.Tensor], ia: torch.Tensor,
            ib: torch.Tensor) -> torch.Tensor:
    """keys[ia] > keys[ib], lexicographic over the compare rows."""
    gt = torch.zeros(ia.shape, dtype=torch.bool, device=ia.device)
    eq = torch.ones(ia.shape, dtype=torch.bool, device=ia.device)
    for k in keys:
        a, b = k[ia], k[ib]
        gt |= eq & (a > b)
        eq &= a == b
    return gt


def merge_splits_plain(p_mat: torch.Tensor, L: int, cmp_rows: Sequence[int],
                       tile: int) -> torch.Tensor:
    """Plain PyTorch version of the split launch (`_compute_splits`):
    int32 [n_pairs * (tpp + 1)], tpp = ceil(2L / tile); entry (p, t) is
    the number of A elements among the first min(t * tile, 2L) merged
    elements of pair p, by a binary search on each diagonal with the
    strict predicate keyA[mid] > keyB[d - mid - 1]."""
    n = p_mat.shape[1]
    rows, inv = cmp_desc(cmp_rows)
    dev = p_mat.device
    keys = [_u(p_mat[r]) ^ iv for r, iv in zip(rows, inv)]
    n_pairs = n // (2 * L)
    tpp = -(-2 * L // tile)
    d = torch.clamp(torch.arange(tpp + 1, device=dev) * tile, max=2 * L)
    base_a = (torch.arange(n_pairs, device=dev) * 2 * L)[:, None]
    d = d[None, :].expand(n_pairs, tpp + 1)
    lo = torch.clamp(d - L, min=0)
    hi = torch.clamp(d, max=L)
    while bool((lo < hi).any()):
        live = lo < hi
        mid = (lo + hi) >> 1
        ia = torch.clamp(base_a + mid, max=n - 1)
        ib = torch.clamp(base_a + L + (d - mid - 1), min=0, max=n - 1)
        gt = _lex_gt(keys, ia, ib)
        lo = torch.where(live & ~gt, mid + 1, lo)
        hi = torch.where(live & gt, mid, hi)
    return lo.to(torch.int32).reshape(-1)


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
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.ybt_merge_tiles_smem_bytes.restype = ctypes.c_int64
        lib.ybt_merge_tiles_smem_bytes.argtypes = [ctypes.c_int] * 3
        lib.ybt_merge_splits.restype = ctypes.c_int
        lib.ybt_merge_splits.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
            i32p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.ybt_merge_tiles.restype = ctypes.c_int
        lib.ybt_merge_tiles.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
            ctypes.c_int64, i32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        _mp_lib = lib
    return _mp_lib


def _check_level(p_mat: torch.Tensor, L: int, cmp_rows: Sequence[int],
                 what: str):
    """Kernel-input checks; returns (rp, n, c, host descriptor)."""
    rp, n = p_mat.shape
    torch_setup.check_u32_matrix(p_mat, what)
    rows, inv = cmp_desc(cmp_rows)
    if max(rows) >= rp - 1:
        raise ValueError(f"{what}: compare row {max(rows)} is not a "
                         f"cols row of a [{rp}, n] payload")
    desc = (ctypes.c_int32 * (2 * len(rows)))(
        *rows, *[v - (1 << 32) if v >= 1 << 31 else v for v in inv])
    return rp, n, len(rows), desc


def merge_splits(p_mat: torch.Tensor, L: int, cmp_rows: Sequence[int],
                 tile: int) -> torch.Tensor:
    """Kernel A's split launch: every tile boundary of the level (see
    merge_splits_plain). CPU tensor: the plain version. CUDA tensor: one
    launch of csrc/merge_path.cu's merge_splits_kernel."""
    if not p_mat.is_cuda:
        return merge_splits_plain(p_mat, L, cmp_rows, tile)
    rp, n, c, desc = _check_level(p_mat, L, cmp_rows, "merge_splits")
    dev = p_mat.device
    tpp = -(-2 * L // tile)
    splits = torch.empty(n // (2 * L) * (tpp + 1), dtype=torch.int32,
                         device=dev)
    rc = _lib().ybt_merge_splits(p_mat.data_ptr(), rp, n, L, desc, c, tile,
                                 splits.data_ptr(),
                                 torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "merge_splits")
    return splits


def merge_tiles(p_mat: torch.Tensor, splits: torch.Tensor, L: int,
                cmp_rows: Sequence[int], tile: int) -> torch.Tensor:
    """Kernel A's tile launch: the level's merged payload from the splits
    of merge_splits at the same tile. CPU tensor: merge_level_plain (which
    needs no splits). CUDA tensor: one launch of merge_tile_kernel."""
    if not p_mat.is_cuda:
        return merge_level_plain(p_mat, L, cmp_rows)
    rp, n, c, desc = _check_level(p_mat, L, cmp_rows, "merge_tiles")
    tile_plan(rp, c, L)
    dev = p_mat.device
    if (splits.device != dev or splits.dtype != torch.int32
            or splits.numel() != n // (2 * L) * (-(-2 * L // tile) + 1)):
        raise ValueError("merge_tiles: splits do not match the level")
    out = torch.empty_like(p_mat)
    rc = _lib().ybt_merge_tiles(p_mat.data_ptr(), out.data_ptr(), rp, n, L,
                                desc, c, tile, splits.data_ptr(),
                                torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "merge_tiles")
    return out


def merge_level(p_mat: torch.Tensor, L: int,
                cmp_rows: Sequence[int]) -> torch.Tensor:
    """Kernel A wrapper: one tournament level, returns a new [rp, n]
    payload. CPU tensor: merge_level_plain. CUDA tensor: the split launch
    and the tile launch of csrc/merge_path.cu, counted as one call in
    `merge_level.launches` (one per level)."""
    rp, n = p_mat.shape
    if L <= 0 or n % (2 * L):
        raise ValueError(f"merge_level: n={n} is not a multiple of 2L={2 * L}")
    if not p_mat.is_cuda:
        return merge_level_plain(p_mat, L, cmp_rows)
    tile, _threads, _nbytes = tile_plan(rp, len(cmp_desc(cmp_rows)[0]), L)
    splits = merge_splits(p_mat, L, cmp_rows, tile)
    out = merge_tiles(p_mat, splits, L, cmp_rows, tile)
    merge_level.launches += 1
    return out


merge_level.launches = 0
