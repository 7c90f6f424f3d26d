"""The radix merge of sort_and_gc and its sorted payload: the wrappers of
kernel G and kernel I.1, each with its plain twin.

Counterpart of yugabyte_tpu/ops/merge_gc.py `sort_and_gc` (:216-230):
  - kernel G (csrc/radix.cu), the `lax.fori_loop`: one stable sort per
    scheduled row of `cols[row][perm] ^ invert`, least significant row
    first, with the ht_hi, ht_lo and write_id rows (2-4) complemented so
    that they sort descending. A stable sort's result is unique, so perm
    equals the JAX package's bit for bit (ties fall to the input index);
  - kernel I.1 (csrc/scan.cu), the gather `cols[:, perm]` that follows,
    written in kernel B's input layout.

This module sits below ops/merge_gc.py and imports none of the ops: the
row layout it needs is fixed by the kernels (see merge_gc's docstring).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

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


_radix_lib = None
_gather_lib = None


def _lib():
    global _radix_lib
    if _radix_lib is None:
        lib = torch_setup.load_cuda_lib("radix.cu")
        lib.ybt_radix_scratch_bytes.restype = ctypes.c_int64
        lib.ybt_radix_scratch_bytes.argtypes = [ctypes.c_int64]
        lib.ybt_radix_sort.restype = ctypes.c_int
        lib.ybt_radix_sort.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
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


def radix_sort(cols: torch.Tensor, sort_rows: Sequence[int],
               n_sort: int) -> torch.Tensor:
    """Kernel G wrapper: the merged order of cols int32 [R, n] under the
    schedule's first n_sort rows, int32 [n]. CPU tensor: radix_sort_plain.
    CUDA tensor: csrc/radix.cu (per row one gather and four digit passes
    of three launches each, counted as one call in `radix_sort.launches`)."""
    if not cols.is_cuda:
        return radix_sort_plain(cols, sort_rows, n_sort)
    torch_setup.check_u32_matrix(cols, "radix_sort")
    rows = _schedule(sort_rows, n_sort)
    r, n = cols.shape
    if any(not 0 <= row < r for row in rows) or not 0 < n < (1 << 31):
        raise ValueError(f"radix_sort: schedule {rows} or width {n} does not "
                         f"fit a [{r}, n] matrix")
    lib = _lib()
    dev = cols.device
    scratch = torch.empty(int(lib.ybt_radix_scratch_bytes(n)),
                          dtype=torch.uint8, device=dev)
    perm = torch.empty(n, dtype=torch.int32, device=dev)
    host_rows = (ctypes.c_int32 * max(1, len(rows)))(*rows)
    rc = lib.ybt_radix_sort(cols.data_ptr(), n, host_rows, len(rows),
                            scratch.data_ptr(), perm.data_ptr(),
                            torch_setup.stream_ptr(dev))
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
