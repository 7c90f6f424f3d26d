"""Device selection and CUDA kernel loading for the port.

Entry points run on `cuda` unless the caller asks for the CPU
(`device="cpu"`, as the tests do). Without a GPU and without that explicit
request they raise: the port never quietly runs on the CPU.

Kernel libraries are built from `csrc/*.cu` with nvcc at first use
(utils/native_build.py) and loaded with ctypes; this module imports
neither nvcc's output nor CUDA at import time.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

_libs: Dict[str, ctypes.CDLL] = {}
_libs_lock = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` by default, the CPU only
    when asked for explicitly. Raises when CUDA is wanted but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "yugabyte_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def load_cuda_lib(src_name: str) -> ctypes.CDLL:
    """Build (if stale) and load the shared library of csrc/<src_name>."""
    with _libs_lock:
        lib = _libs.get(src_name)
        if lib is None:
            from yugabyte_tpu_torch.utils.native_build import build_cuda_lib
            lib = ctypes.CDLL(build_cuda_lib(src_name))
            _libs[src_name] = lib
        return lib


def check_u32_matrix(t: torch.Tensor, what: str, rows: int = -1) -> None:
    """Kernel-input check: a contiguous int32 tensor (u32 bits) on CUDA."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 (u32 bits), got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if rows >= 0 and (t.dim() != 2 or t.shape[0] != rows):
        raise ValueError(f"{what}: expected shape [{rows}, n], "
                         f"got {tuple(t.shape)}")


# cudaErrorMemoryAllocation: the one launch error a process survives
# (ops/device_faults.is_device_fault). The others mean the kernel was
# built or called wrongly (invalid value 1, invalid configuration 9, no
# kernel image 209, out of resources 701) or left the context unusable
# (illegal address 700, launch failure 719, ECC 214: sticky errors)
CUDA_ALLOC_ERROR = 2


class CudaLaunchError(RuntimeError):
    """A wrapper's launch returned a CUDA error; `code` is its
    cudaError_t."""

    def __init__(self, what: str, code: int):
        super().__init__(f"{what}: CUDA launch failed with error {code}")
        self.code = code


def raise_on_cuda_error(rc: int, what: str) -> None:
    """The C interface returns cudaGetLastError() after each launch."""
    if rc != 0:
        raise CudaLaunchError(what, rc)


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
