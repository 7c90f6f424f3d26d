"""The radix merge of sort_and_gc and its sorted payload: the wrappers of
kernel G and kernel I.1, each with its plain twin.

Counterpart of yugabyte_tpu/ops/merge_gc.py `sort_and_gc` (:216-230):
  - kernel G (csrc/radix.cu), the `lax.fori_loop`: one stable sort per
    scheduled row of `cols[row][perm] ^ invert`, least significant row
    first, with the ht_hi, ht_lo and write_id rows (2-4) complemented so
    that they sort descending. A stable sort's result is unique, so perm
    equals the JAX package's bit for bit (ties fall to the input index).
    On the card the statistics come first (`sort_stats`: the tail block
    of columns equal to the last, the rows' 8-bit digit counts over the
    prefix before it), `sort_plan` keeps the passes whose digit is not
    constant, and each kept pass is one onesweep launch;
  - kernel I.1 (csrc/scan.cu), the gather `cols[:, perm]` that follows,
    written in kernel B's input layout.

This module sits below ops/merge_gc.py and imports none of the ops: the
row layout it needs is fixed by the kernels (see merge_gc's docstring).
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np
import torch

from yugabyte_tpu_torch.utils import torch_setup

# merge_gc's row layout: rows ht_hi..write_id sort descending
_ROW_HT_HI, _ROW_WID = 2, 4
_U32 = 0xFFFFFFFF


def _schedule(sort_rows: Sequence[int], n_sort: int) -> list:
    return [int(r) for r in np.asarray(sort_rows)[:n_sort]]


def radix_sort_plain(cols: torch.Tensor, sort_rows: Sequence[int],
                     n_sort: int) -> torch.Tensor:
    """Plain PyTorch version: the JAX loop, one `torch.sort(stable=True)`
    per scheduled row. The keys are widened to int64 first: a signed int32
    sort would put u32 values >= 2^31 first. Returns int32 [n]."""
    n = cols.shape[1]
    perm = torch.arange(n, device=cols.device)
    for row in _schedule(sort_rows, n_sort):
        invert = _U32 if _ROW_HT_HI <= row <= _ROW_WID else 0
        key = (cols[row][perm].long() & _U32) ^ invert
        perm = perm[torch.sort(key, stable=True).indices]
    return perm.to(torch.int32)


# pass_plan's buffer codes (csrc/radix.cu reads the same numbers): a key
# source is the gather from cols or a key buffer, a perm source the iota
# or a perm buffer; PERM is the output.
GATHER, KEYS_A, KEYS_B = 0, 1, 2
NO_KEYS = 0
IOTA, PERM, TMP = 0, 1, 2
PLAN_COLS = ("row", "digit", "slot", "key_src", "key_dst", "perm_src",
             "perm_dst")
_MAX_ROWS = 128   # csrc/radix.cu kMaxRows


def _keys(cols: torch.Tensor, row: int) -> torch.Tensor:
    """Row `row` of cols as its radix keys (int64 in [0, 2^32))."""
    invert = _U32 if _ROW_HT_HI <= row <= _ROW_WID else 0
    return (cols[row].long() & _U32) ^ invert


def digit_counts_plain(cols: torch.Tensor, sort_rows: Sequence[int]
                       ) -> torch.Tensor:
    """Kernel G's digit counts: int32 [k, 4, 256], the number of keys
    cols[row_k] ^ invert whose digit p (bits 8p..8p+7) is d. A digit's
    count does not depend on the order of the keys."""
    out = [torch.stack([torch.bincount((_keys(cols, int(row)) >> (8 * p))
                                       & 0xFF, minlength=256)
                        for p in range(4)]) for row in sort_rows]
    return torch.stack(out).to(torch.int32).reshape(len(out), 4, 256)


def tail_plain(cols: torch.Tensor, sort_rows: Sequence[int]) -> torch.Tensor:
    """Kernel G's tail words, int32 [2 + k]: 1 + the last column that
    differs from column n-1 in a scheduled row (0: none), the number of
    columns whose key is <= column n-1's under the schedule (most
    significant row last), then column n-1's key in each row."""
    n = cols.shape[1]
    keys = [_keys(cols, int(row)) for row in sort_rows]
    cmp = torch.zeros(n, dtype=torch.int64, device=cols.device)
    for key in keys:  # least significant first: the last difference wins
        cmp = torch.where(key != key[-1], torch.sign(key - key[-1]), cmp)
    differs = torch.nonzero(cmp).reshape(-1)
    last = int(differs[-1]) + 1 if differs.numel() else 0
    head = torch.tensor([last, int((cmp <= 0).sum())], device=cols.device)
    words = torch.cat([head, torch.stack([key[-1] for key in keys])])
    return torch.where(words >= (1 << 31), words - (1 << 32),
                       words).to(torch.int32)


def sort_stats_plain(cols: torch.Tensor, sort_rows: Sequence[int]
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel G's statistics launches: (the digit
    counts [k, 4, 256] over the prefix before the tail block, the tail
    words [2 + k])."""
    tail = tail_plain(cols, sort_rows)
    return digit_counts_plain(cols[:, :int(tail[0])], sort_rows), tail


def pass_plan(counts: np.ndarray, sort_rows: Sequence[int], n: int
              ) -> np.ndarray:
    """Kernel G's passes from the digit counts [k, 4, 256] of the schedule's
    rows over the n keys to sort: int32 [P, 7], one line per kept pass in
    sort order (PLAN_COLS). A pass whose one bucket holds all n keys is
    dropped (a stable sort by a constant key is the identity). Buffers: a
    row's first kept pass gathers its keys through the previous pass's
    perm (the iota before the first pass), later passes of the row read the
    keys the previous one wrote, a row's last pass writes none; the perm
    buffers alternate so that the last pass writes PERM. No pass: the
    iota."""
    counts = np.asarray(counts).reshape(len(sort_rows), 4, 256)
    kept = [(k, p) for k in range(len(sort_rows)) for p in range(4)
            if counts[k, p].max() < n]
    n_pass = len(kept)
    plan = np.zeros((n_pass, len(PLAN_COLS)), dtype=np.int32)
    for j, (k, p) in enumerate(kept):
        first = j == 0 or kept[j - 1][0] != k
        last = j == n_pass - 1 or kept[j + 1][0] != k
        plan[j] = (int(sort_rows[k]), p, 4 * k + p,
                   GATHER if first else plan[j - 1, 4],
                   NO_KEYS if last else (KEYS_A if j % 2 == 0 else KEYS_B),
                   IOTA if j == 0 else plan[j - 1, 6],
                   PERM if (n_pass - 1 - j) % 2 == 0 else TMP)
    return plan


def sort_plan(counts: np.ndarray, tail: np.ndarray, sort_rows: Sequence[int],
              n: int) -> Tuple[np.ndarray, int, int]:
    """(plan, n_prefix, at) from kernel G's statistics over n columns. The
    columns n_prefix..n-1 all equal column n-1 in every scheduled row: a
    block of ties that keeps its index order, so only the prefix is sorted
    (the counts cover the prefix) and the block lands at `at`, the number
    of prefix keys <= its key. On the card the last pass moves the keys
    from `at` on up by the block's length."""
    n_prefix, n_le = int(tail[0]), int(tail[1])
    return (pass_plan(counts, sort_rows, n_prefix), n_prefix,
            n_le - (n - n_prefix))


_radix_lib = None
_gather_lib = None


def _lib():
    global _radix_lib
    if _radix_lib is None:
        lib = torch_setup.load_cuda_lib("radix.cu")
        lib.ybt_radix_scratch_bytes.restype = ctypes.c_int64
        lib.ybt_radix_scratch_bytes.argtypes = [ctypes.c_int64, ctypes.c_int]
        lib.ybt_radix_stats.restype = ctypes.c_int
        lib.ybt_radix_stats.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.ybt_radix_passes.restype = ctypes.c_int
        lib.ybt_radix_passes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _radix_lib = lib
    return _radix_lib


def _glib():
    global _gather_lib
    if _gather_lib is None:
        lib = torch_setup.load_cuda_lib("scan.cu")
        lib.ybt_sorted_gather.restype = ctypes.c_int
        lib.ybt_sorted_gather.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        _gather_lib = lib
    return _gather_lib


def _check_schedule(cols: torch.Tensor, rows: list, what: str) -> None:
    torch_setup.check_u32_matrix(cols, what)
    r, n = cols.shape
    if any(not 0 <= row < r for row in rows) or not 0 < n < (1 << 30) \
            or len(rows) > _MAX_ROWS:
        raise ValueError(f"{what}: schedule {rows} or width {n} does not "
                         f"fit a [{r}, n] matrix (n < 2^30, at most "
                         f"{_MAX_ROWS} rows)")


def _stats_flat(cols: torch.Tensor, rows: list) -> torch.Tensor:
    """The device buffer of ybt_radix_stats: counts, then the tail words."""
    dev = cols.device
    flat = torch.empty(len(rows) * (4 * 256 + 1) + 2, dtype=torch.int32,
                       device=dev)
    host_rows = (ctypes.c_int32 * len(rows))(*rows)
    rc = _lib().ybt_radix_stats(cols.data_ptr(), cols.shape[1], host_rows,
                                len(rows), flat.data_ptr(),
                                torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "sort_stats")
    return flat


def sort_stats(cols: torch.Tensor, sort_rows: Sequence[int]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel G's statistics launches (see sort_stats_plain) on the device
    of cols. CPU tensor: the plain version. CUDA tensor: csrc/radix.cu
    `digit_counts` and `tail_compare` after one memset; part of
    radix_sort, so not counted apart."""
    rows = [int(x) for x in sort_rows]
    if not cols.is_cuda:
        return sort_stats_plain(cols, rows)
    _check_schedule(cols, rows, "sort_stats")
    if not rows:
        raise ValueError("sort_stats: an empty schedule")
    flat = _stats_flat(cols, rows)
    k = len(rows)
    return flat[:k * 1024].reshape(k, 4, 256), flat[k * 1024:]


def radix_sort(cols: torch.Tensor, sort_rows: Sequence[int],
               n_sort: int) -> torch.Tensor:
    """Kernel G wrapper: the merged order of cols int32 [R, n] under the
    schedule's first n_sort rows, int32 [n]. CPU tensor: radix_sort_plain.
    CUDA tensor: csrc/radix.cu: the statistics launches, one download of
    them, `sort_plan`, then one memset and one onesweep launch per kept
    pass and one launch placing the tail block (or the whole order where
    no pass is kept), counted as one call in `radix_sort.launches`."""
    if not cols.is_cuda:
        return radix_sort_plain(cols, sort_rows, n_sort)
    rows = _schedule(sort_rows, n_sort)
    _check_schedule(cols, rows, "radix_sort")
    n = cols.shape[1]
    lib = _lib()
    dev = cols.device
    if rows:
        flat = _stats_flat(cols, rows)
        host = flat.cpu().numpy()
        k = len(rows)
        plan, n_prefix, at = sort_plan(host[:k * 1024], host[k * 1024:],
                                       rows, n)
    else:
        flat = torch.empty(0, dtype=torch.int32, device=dev)
        plan, n_prefix, at = np.zeros((0, len(PLAN_COLS)), np.int32), n, n
    scratch = torch.empty(int(lib.ybt_radix_scratch_bytes(n_prefix,
                                                          len(plan))),
                          dtype=torch.uint8, device=dev)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    flat_plan = np.ascontiguousarray(plan, dtype=np.int32).reshape(-1)
    host_plan = (ctypes.c_int32 * max(1, flat_plan.size))(*flat_plan.tolist())
    rc = lib.ybt_radix_passes(cols.data_ptr(), n, n_prefix, at, host_plan,
                              len(plan), flat.data_ptr(), scratch.data_ptr(),
                              perm.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "radix_sort")
    radix_sort.launches += 1
    return perm


radix_sort.launches = 0


def sorted_payload_plain(cols: torch.Tensor, perm: torch.Tensor
                         ) -> torch.Tensor:
    """Plain PyTorch version of kernel I.1: int32 [R+1, n], rows 0..R-1
    cols[:, perm], row R perm (kernel B's input layout)."""
    p = perm.long()
    return torch.cat([cols[:, p], perm.to(torch.int32)[None]], dim=0)


def sorted_payload(cols: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Kernel I.1 wrapper (see sorted_payload_plain). CPU tensor: the plain
    version. CUDA tensor: csrc/scan.cu, counted in
    `sorted_payload.launches`."""
    if not cols.is_cuda:
        return sorted_payload_plain(cols, perm)
    torch_setup.check_u32_matrix(cols, "sorted_payload")
    r, n = cols.shape
    if perm.dtype != torch.int32 or perm.shape != (n,) \
            or not perm.is_contiguous() or perm.device != cols.device:
        raise ValueError(f"sorted_payload: perm must be a contiguous int32 "
                         f"[{n}] tensor beside cols")
    dev = cols.device
    out = torch.empty((r + 1, n), dtype=torch.int32, device=dev)
    rc = _glib().ybt_sorted_gather(cols.data_ptr(), r, n, perm.data_ptr(),
                                   out.data_ptr(), torch_setup.stream_ptr(dev))
    torch_setup.raise_on_cuda_error(rc, "sorted_payload")
    sorted_payload.launches += 1
    return out


sorted_payload.launches = 0
