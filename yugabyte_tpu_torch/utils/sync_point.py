"""Sync points: named hooks that tests arm with callbacks.

Capability parity with the reference's test hooks (ref:
src/yb/rocksdb/util/sync_point.h). A test registers a callback per point
(`arm("db.flush:before_manifest", cb)`); `hit` runs it when the code
reaches the point. Points are free in production: one dict lookup on an
(almost always) empty dict.

The port's copy of yugabyte_tpu/utils/sync_point.py, in-process arming
only: the DB hits `db.flush:before_manifest` and
`db.compaction:before_install`, every compaction writer
`compaction:output_written`, and the compaction pool's loop
`compaction_pool:take_round`.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict

_arms: Dict[str, Callable[[], None]] = {}
_lock = threading.Lock()


def hit(name: str) -> None:
    """Mark reaching a named point; fires any armed action."""
    cb = _arms.get(name)
    if cb is not None:
        cb()


def arm(name: str, cb: Callable[[], None]) -> None:
    with _lock:
        _arms[name] = cb


def disarm(name: str) -> None:
    with _lock:
        _arms.pop(name, None)


def clear() -> None:
    with _lock:
        _arms.clear()
