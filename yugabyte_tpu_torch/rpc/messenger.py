"""The typed retryable rejection of the write-admission state machine.

Counterpart of yugabyte_tpu/rpc/messenger.py (:96-113), holding only what
tablet/admission.py raises. The Messenger, its service pools, proxies and
TLS come with the rpc part of ROADMAP queue A item 7.
"""

from __future__ import annotations

from typing import Optional

from yugabyte_tpu_torch.utils.status import Code, Status, StatusError


class Overloaded(StatusError):
    """Typed retryable shedding rejection (ref: the reference's
    ServiceUnavailable queue-overflow + memory-pressure rejections,
    rpc/service_pool.cc Overflow / tablet_service.cc write throttling).

    Raised by the write-admission state machine as Code.BUSY with
    extra={"overloaded": True, "retry_after_ms": <measured hint>} so
    client retry loops classify it retryable and floor their backoff at
    the server's own drain estimate."""

    def __init__(self, msg: str, retry_after_ms: Optional[float] = None,
                 **extra_kv):
        super().__init__(Status(Code.BUSY, msg))
        self.extra = {"overloaded": True}
        if retry_after_ms is not None:
            self.extra["retry_after_ms"] = int(retry_after_ms)
        self.extra.update(extra_kv)

