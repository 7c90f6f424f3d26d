"""Cancellation tokens for long-running background work.

The compaction offload pipeline (storage/compaction.py) spans three
overlapped stages across threads and a device queue; DB shutdown and a
tablet-FAILED transition must be able to abort the in-flight job at the
next stage boundary — without corrupting the writer and while releasing
every HostStagingPool lease — instead of racing it to the filesystem.

`CancellationToken.check()` raises `OperationCancelled`, a StatusError
with Code.ABORTED, which callers treat as a CLEAN abort: no background
error is recorded, partial outputs are swept, and the job simply ends
(ref: rocksdb's ShutdownInProgress status threading through
CompactionJob).
"""

from __future__ import annotations

import threading
from typing import Optional

from yugabyte_tpu_torch.utils.status import Code, Status, StatusError

__all__ = ["CancellationToken", "OperationCancelled"]


class OperationCancelled(StatusError):
    """The operation was aborted by shutdown / tablet failure — a clean
    abort, not an error to contain or report."""

    def __init__(self, msg: str):
        super().__init__(Status(Code.ABORTED, msg))


class CancellationToken:
    """One-way latch shared by a job's stages; thread-safe.

    cancel() is idempotent and carries a reason for the abort message.
    """

    def __init__(self, what: str = "operation"):
        self._what = what
        self._event = threading.Event()
        self._reason: Optional[str] = None  # written once before set()

    def cancel(self, reason: str = "shutdown") -> None:
        # reason is published BEFORE the event: a checker that observes
        # the set event always reads a complete reason
        if not self._event.is_set():
            self._reason = reason
            self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def check(self) -> None:
        """Raise OperationCancelled if cancel() was called."""
        if self._event.is_set():
            raise OperationCancelled(
                f"{self._what} cancelled: {self._reason}")
