"""The scan's key bounds as kernels I.2 and J.1 take them: by value.

`KeyBounds` mirrors csrc/key_bounds.cuh's struct of the same name. The
wrapper fills one on the host and hands its address to the C function,
which copies it into the launch's parameters, so a call makes no
host-to-device copy. The struct holds both bounds' words up to
BOUND_CAP words each; a wider key stride goes to the card as one pinned,
non-blocking copy of the [2, w] words, whose pointer the struct carries.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

BOUND_CAP = 128     # words of each bound held by value (kBoundCap)


class KeyBounds(ctypes.Structure):
    _fields_ = [("words", ctypes.c_uint32 * (2 * BOUND_CAP)),
                ("dev", ctypes.c_void_p),
                ("w", ctypes.c_int32),
                ("lo_len", ctypes.c_int32),
                ("hi_len", ctypes.c_int32)]


def key_bounds(lo_words, lo_len: int, hi_words, hi_len: int, w: int,
               device: Optional[torch.device] = None
               ) -> Tuple[KeyBounds, Optional[torch.Tensor]]:
    """(the struct, the device words or None). Lower words at [0, w),
    upper at [w, 2w). Up to BOUND_CAP words they ride in the struct; above
    it they are copied to `device` (pinned, non-blocking: the caller keeps
    the returned tensor until its launch is enqueued)."""
    words = np.concatenate([np.asarray(lo_words, np.uint32).reshape(-1),
                            np.asarray(hi_words, np.uint32).reshape(-1)])
    if w <= 0 or words.size != 2 * w:
        raise ValueError(f"key bounds: {words.size} words for w={w}")
    kb = KeyBounds(w=w, lo_len=int(lo_len), hi_len=int(hi_len))
    if w <= BOUND_CAP:
        ctypes.memmove(kb.words, words.ctypes.data, words.nbytes)
        return kb, None
    host = torch.from_numpy(words.view(np.int32)).pin_memory()
    dev_words = host.to(device, non_blocking=True)
    kb.dev = dev_words.data_ptr()
    return kb, dev_words


def check_layout(lib) -> None:
    """Raise unless the C struct has this module's size."""
    if lib.ybt_key_bounds_size() != ctypes.sizeof(KeyBounds):
        raise RuntimeError("key_bounds.cuh: KeyBounds layout differs")
