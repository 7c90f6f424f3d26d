"""The sampled digest check of device write-through cache entries.

Counterpart of the resident-entry part of yugabyte_tpu/storage/
integrity.py (:239-316 there). A write-through entry (compaction's
survivor span gathered on the device and installed into the slab cache
under the output file id) must equal a host re-stage of the SST bytes the
job actually wrote: the chained L0->L1->L2 path feeds the next compaction
from these entries without re-decoding the file, so a wrong entry would
poison every later merge. A sampled fraction of installs is re-derived
from the installed file and compared; a divergent entry is dropped, never
installed, and counted.

The counters are plain module ints (the JAX package's registry counters
come with the metrics registry). The shadow verifier and the at-rest
scrub are ROADMAP queue A: the sampled shadow verifier.
"""

from __future__ import annotations

import random
import threading
from typing import List

import numpy as np

from yugabyte_tpu_torch.utils import flags

flags.define_flag("resident_digest_sample", 0.02,
                  "fraction of device write-through cache installs whose "
                  "staged columns are re-derived from the written SST "
                  "bytes and compared (0 disables; a mismatched entry is "
                  "dropped, never installed)")

_lock = threading.Lock()
_checked = 0      # guarded-by: _lock
_mismatches = 0   # guarded-by: _lock


def verify_resident_entry(staged, base_path: str) -> List[str]:
    """Full check of one write-through cache entry against the decoded
    bytes of its installed SST: a download of the staged columns plus a
    host decode and pack, hence the sampling gate around it. Returns the
    (possibly empty) list of divergences."""
    from yugabyte_tpu_torch.ops.merge_gc import pack_cols
    from yugabyte_tpu_torch.storage.sst import SSTReader
    errors: List[str] = []
    reader = SSTReader(base_path)
    try:
        slab = reader.read_all()
    finally:
        reader.close()
    host_cols, n, _n_pad, _w = pack_cols(slab)
    if staged.n != n:
        return [f"row count: staged {staged.n} != decoded {n}"]
    dev_cols = staged.cols_dev.cpu().numpy().view(np.uint32)
    r_common = min(dev_cols.shape[0], host_cols.shape[0])
    if not np.array_equal(dev_cols[:r_common, :n], host_cols[:r_common, :n]):
        bad = np.nonzero(dev_cols[:r_common, :n]
                         != host_cols[:r_common, :n])
        errors.append(f"column words diverge at (row {int(bad[0][0])}, "
                      f"entry {int(bad[1][0])})")
    if dev_cols.shape[0] > r_common \
            and not (dev_cols[r_common:, :n] == 0).all():
        errors.append("staged width padding rows are not zero")
    return errors


def maybe_verify_resident_entry(staged, base_path: str) -> bool:
    """Sampling gate of the write-through install: True when the entry may
    install (clean, or not sampled), False when the digest check found a
    divergence (counted; the caller drops the entry and the next reader
    re-stages from the file bytes)."""
    global _checked, _mismatches
    sample = float(flags.get_flag("resident_digest_sample"))
    if sample <= 0:
        return True
    if sample < 1.0 and random.random() >= sample:
        return True
    errors = verify_resident_entry(staged, base_path)
    with _lock:
        _checked += 1
        if errors:
            _mismatches += 1
    return not errors


def resident_digest_snapshot() -> dict:
    """The digest check's state: the sample rate, the installs checked and
    the mismatches found (each one an entry dropped before install)."""
    with _lock:
        return {"sample": float(flags.get_flag("resident_digest_sample")),
                "checked": _checked, "mismatches": _mismatches}
