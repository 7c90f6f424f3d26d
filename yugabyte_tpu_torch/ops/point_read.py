"""FNV-1a-64 in two u32 limbs: the part of point reads the block encode needs.

Counterpart of yugabyte_tpu/ops/point_read.py:122-147 (the limb constants
and `_mul64_by_prime`). The hash is storage/bloom.fnv64_masked's, so the
doc-key bloom bits of a file written by the device codec are the ones the
host writer would set. The rest of the JAX module (the batched probe,
locate and index-fit programs) is a later slice of the port.
"""

from __future__ import annotations

from typing import Tuple

import torch

from yugabyte_tpu_torch.ops.merge_gc import _U32, _u, to_u32_bits

_FNV_OFFSET_HI = 0xCBF29CE4
_FNV_OFFSET_LO = 0x84222325
# FNV prime 0x100000001B3 = 2^40 + 0x1B3; the multiply below decomposes
# h*P mod 2^64 into shift/add limbs so no intermediate needs 64 bits
_FNV_PRIME_LOW = 0x1B3


def _mul64_by_prime(hi: torch.Tensor, lo: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) * 0x100000001B3 mod 2^64 on int32 tensors holding u32 bits.

    h*P = h*2^40 + h*0x1B3 (mod 2^64): h*2^40 contributes (lo << 8) to the
    high limb; h*0x1B3 goes through a 16-bit split of `lo` so no partial
    product exceeds 2^25. The limbs are widened to int64 and every sum is
    wrapped to 32 bits, as u32 arithmetic wraps."""
    hi, lo = _u(hi), _u(lo)
    p = _FNV_PRIME_LOW
    t = (lo >> 16) * p                      # < 2^25
    u = (lo & 0xFFFF) * p                   # < 2^25
    s1 = (t << 16) & _U32
    new_lo = (s1 + u) & _U32
    carry = (new_lo < s1).long()
    new_hi = (((lo << 8) & _U32) + hi * p + (t >> 16) + carry) & _U32
    return to_u32_bits(new_hi), to_u32_bits(new_lo)
