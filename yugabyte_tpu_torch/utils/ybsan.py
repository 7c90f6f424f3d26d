"""ybsan shim: the package-side face of the happens-before sanitizer.

The port's copy of yugabyte_tpu/utils/ybsan.py, so the classes that carry
its declarations (storage/integrity.ShadowVerifier, storage/bucket_health,
utils/latency.LatencyBudget, server/webserver.Webserver,
tserver/heartbeater.Heartbeater) keep them. No detector arms this copy, so `shadow(...)` returns the class
untouched. The JAX shim's arming, its declaration registry and its lock
and thread-pool forwarders have no caller in the port and are not copied.
"""

from __future__ import annotations

# The declared shadow disciplines the port's classes use (see README
# "Concurrency sanitizer"): the detector checks the STATED protocol of a
# deliberately lock-free structure instead of lock possession.
SINGLE_WRITER = "single-writer"            # un-HB'd 2nd writer = race
SINGLE_WRITER_PER_KEY = "single-writer-per-key"  # per dict key
PUBLISHER_CONSUMER = "publisher-consumer"  # reads must be HB-after writes


def shadow(**attrs: str):
    """Class decorator declaring per-attribute lock-free disciplines:

        @ybsan.shadow(probe_pending=ybsan.PUBLISHER_CONSUMER)
        class BucketHealthBoard: ...

    Here a declaration only: the class is returned unchanged."""

    def deco(cls: type) -> type:
        return cls

    return deco
