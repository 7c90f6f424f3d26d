"""Device-fault injection + classification for the kernel offload path.

Counterpart of yugabyte_tpu/ops/device_faults.py: the same kinds, sites,
counters and YBTPU_INJECT_DEVICE_FAULT spec, so a nemesis script arms
either package alike. Where that injects accelerator faults under the
XLA programs, this one injects them under the CUDA kernels' wrappers, so
tests can prove a mid-job device failure is contained (retry once, then a
byte-identical native completion + shape-bucket quarantine) instead of
corrupting the writer.

Sites:
  - "dispatch": fired before a kernel family's launch (ops/run_merge.
    launch_merge_gc per leaf launch, the codec, the point-read locate,
    the pushdown, the mesh) — where a real launch failure or an
    allocation of the launch's buffers surfaces;
  - "result":   fired where the family's answer is downloaded
    (MergeGCHandle.result, the codec's downloads, the point read's one
    download a chunk) — where an asynchronous device fault materializes,
    since a CUDA launch returns before the kernel runs.
  - "survivor": the SILENT kind — `maybe_flip_survivors` corrupts one
    downloaded survivor decision in place (kind "bitflip", no
    exception), modeling an HBM bit flip or a miscompile that loud-fault
    containment cannot see. Shadow verification (storage/integrity.py)
    is the defense it tests.

A fourth kind, "slow", raises nothing at all: it sleeps `delay_s` at
the injection site, modeling a degraded-but-alive accelerator (thermal
or power throttle, a contended PCIe link, a straggling mesh shard). The
bucket-health board's rate race (storage/bucket_health.py) is the
defense it tests, and it can be pinned to one shape bucket via
arm(..., bucket=...).

Arming is programmatic (`arm()`) or via the environment for child
processes: YBTPU_INJECT_DEVICE_FAULT="<kind>:<site>:<count>[:delay_s]",
e.g. "oom:result:1" or "slow:dispatch:4:0.05". Counts decrement per
fire; count <= 0 disarms.

`is_device_fault()` classifies both injected and real device failures
(see its docstring: the card running out of memory, the one real fault
the process survives) so the containment code treats them uniformly,
and refuses everything else — a kernel that fails to build, is called
wrongly or faults on the card (an illegal address leaves the CUDA
context unusable) is a bug to surface, never a fault to contain.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List

__all__ = ["InjectedDeviceFault", "InjectedCompileError",
           "InjectedResourceExhausted", "InjectedDispatchFault",
           "arm", "disarm_all", "maybe_fault", "maybe_flip_survivors",
           "is_device_fault", "armed_count"]


class InjectedDeviceFault(Exception):
    """Base for injected accelerator faults."""


class InjectedCompileError(InjectedDeviceFault):
    """Mimics a failed kernel load of the launched family (the XLA
    compile failure of the JAX package)."""


class InjectedResourceExhausted(InjectedDeviceFault):
    """Mimics an HBM allocation failure (torch.cuda.OutOfMemoryError)."""


class InjectedDispatchFault(InjectedDeviceFault):
    """Mimics an asynchronous runtime fault surfacing on the value."""


_KINDS = {
    "compile": (InjectedCompileError,
                "injected XLA compile failure (nemesis)"),
    "oom": (InjectedResourceExhausted,
            "RESOURCE_EXHAUSTED: injected HBM OOM (nemesis)"),
    "runtime": (InjectedDispatchFault,
                "injected device dispatch fault (nemesis)"),
}

# Silent-corruption model (no exception — the HBM-bit-flip class that
# shadow verification exists to catch): armed like the loud kinds but
# consumed by maybe_flip_survivors, which MUTATES a downloaded survivor
# decision instead of raising.
_BITFLIP = "bitflip"
# Silent-slowness model (no exception — the degraded-accelerator class
# the bucket-health rate race exists to catch): maybe_fault sleeps
# delay_s instead of raising, optionally only for one shape bucket.
_SLOW = "slow"
_SITES = ("dispatch", "result", "survivor")

_lock = threading.Lock()
_armed: List[dict] = []   # guarded-by: _lock
_env_loaded = False       # guarded-by: _lock


def arm(kind: str, site: str = "dispatch", count: int = 1,
        delay_s: float = 0.05, bucket=None) -> None:
    """Arm `count` faults of `kind`
    ('compile'|'oom'|'runtime'|'bitflip'|'slow') at `site`
    ('dispatch'|'result'|'survivor'). Several armings stack; 'bitflip'
    only fires at the 'survivor' site (silent corruption of a downloaded
    decision buffer, no exception); 'slow' sleeps `delay_s` at the site
    without raising, and when `bucket` is given it fires only at
    bucket-aware sites dispatching that exact shape bucket."""
    assert kind in _KINDS or kind in (_BITFLIP, _SLOW), kind
    assert site in _SITES, site
    with _lock:
        _armed.append({"kind": kind, "site": site, "count": count,
                       "delay_s": float(delay_s),
                       "bucket": tuple(bucket) if bucket is not None
                       else None})


def disarm_all() -> None:
    with _lock:
        _armed.clear()


def armed_count() -> int:
    with _lock:
        return sum(max(0, a["count"]) for a in _armed)


def _load_env_locked() -> None:  # guarded-by: _lock
    global _env_loaded
    if _env_loaded:
        return
    _env_loaded = True
    spec = os.environ.get("YBTPU_INJECT_DEVICE_FAULT", "")
    if not spec:
        return
    for part in spec.split(","):
        bits = part.strip().split(":")
        if len(bits) >= 1 and (bits[0] in _KINDS or bits[0] == _BITFLIP):
            site = bits[1] if len(bits) > 1 else (
                "survivor" if bits[0] == _BITFLIP else "dispatch")
            try:
                count = int(bits[2]) if len(bits) > 2 else 1
            except ValueError:  # yblint: contained(malformed env count defaults to 1 — arming still happens)
                count = 1
            try:
                delay_s = float(bits[3]) if len(bits) > 3 else 0.05
            except ValueError:  # yblint: contained(malformed env delay defaults to 50ms — arming still happens)
                delay_s = 0.05
            if site in _SITES:
                _armed.append({"kind": bits[0], "site": site,
                               "count": count, "delay_s": delay_s,
                               "bucket": None})


def maybe_fault(site: str, bucket=None) -> None:
    """Fire the next armed fault for `site`, if any (decrements its
    count). 'slow' entries SLEEP (outside the lock) instead of raising
    and consume independently of the loud kinds; a loud entry still
    raises on the same call after the sleep, so a slow-AND-faulty
    device is expressible. `bucket` is the dispatching shape bucket at
    bucket-aware sites; bucket-pinned slow entries fire only when it
    matches. A single locked list check when nothing is armed."""
    delay = 0.0
    hit = None
    with _lock:
        _load_env_locked()
        if not _armed:
            return
        for a in list(_armed):
            if a["site"] != site or a["count"] <= 0:
                continue
            if a["kind"] == _SLOW:
                want = a.get("bucket")
                if want is not None and (bucket is None
                                         or tuple(bucket) != want):
                    continue
                a["count"] -= 1
                if a["count"] <= 0:
                    _armed.remove(a)
                delay = max(delay, float(a.get("delay_s", 0.05)))
            elif hit is None and a["kind"] != _BITFLIP:
                a["count"] -= 1
                if a["count"] <= 0:
                    _armed.remove(a)
                hit = a
    if delay > 0.0:
        _fault_counter(_SLOW).increment()
        time.sleep(delay)
    if hit is not None:
        exc_type, msg = _KINDS[hit["kind"]]
        _fault_counter(hit["kind"]).increment()
        raise exc_type(msg)


def maybe_flip_survivors(surv, make_tomb) -> bool:
    """Consume one armed 'bitflip' fault by SILENTLY corrupting a
    downloaded survivor decision in place — the HBM-bit-flip /
    miscompile model the shadow verifier exists to catch. Flips the low
    bit of an odd survivor index (stays in range: the write path would
    gather a duplicate row, not crash), falling back to a tombstone-flag
    flip when every index is even. Returns True when a flip fired."""
    with _lock:
        _load_env_locked()
        hit = None
        for a in _armed:
            if a["kind"] == _BITFLIP and a["count"] > 0:
                a["count"] -= 1
                if a["count"] <= 0:
                    _armed.remove(a)
                hit = a
                break
        if hit is None:
            return False
    flipped = False
    if len(surv):
        odd = [i for i in range(len(surv)) if int(surv[i]) & 1]
        if odd:
            i = odd[len(odd) // 2]
            surv[i] = int(surv[i]) ^ 1
            flipped = True
    if not flipped and len(make_tomb):
        i = len(make_tomb) // 2
        make_tomb[i] = not bool(make_tomb[i])
        flipped = True
    if flipped:
        _fault_counter(_BITFLIP).increment()
    return flipped


def _fault_counter(kind: str):
    from yugabyte_tpu_torch.utils.metrics import kernel_metrics
    return kernel_metrics().counter(
        f"kernel_injected_fault_{kind}_total",
        f"injected device faults of kind {kind}")


def is_device_fault(exc: BaseException) -> bool:
    """True for failures of the DEVICE path — injected or real — that the
    containment may survive via the native completion:

      - an injected fault (InjectedDeviceFault);
      - the card out of memory: torch.cuda.OutOfMemoryError (the caching
        allocator could not serve a tensor: the CUDA twin of
        RESOURCE_EXHAUSTED), a CUDA error "out of memory" from any other
        runtime call (torch.AcceleratorError where the installed torch
        has it, else a RuntimeError), and a wrapper's launch error
        (utils/torch_setup.CudaLaunchError) with the allocation code.

    False for everything else: a CUDA error of any other kind (an
    illegal address, a launch failure, a timeout, ECC: the error is
    sticky, the context unusable, so no device job can follow in this
    process, and a kernel writing out of bounds must surface), a kernel
    library that fails to build or load (native_build's
    CalledProcessError / RuntimeError("build failed"), ImportError,
    OSError), a launch refused for its configuration, a wrapper's own
    contract check (ValueError / TypeError on a bad shape, dtype or
    alignment), cancellation (OperationCancelled), and any host error.
    Those are bugs, lost devices or clean aborts and must surface."""
    if isinstance(exc, InjectedDeviceFault):
        return True
    from yugabyte_tpu_torch.utils.cancellation import OperationCancelled
    if isinstance(exc, OperationCancelled):
        return False
    import torch
    from yugabyte_tpu_torch.utils.torch_setup import (CUDA_ALLOC_ERROR,
                                                      CudaLaunchError)
    if isinstance(exc, CudaLaunchError):
        return exc.code == CUDA_ALLOC_ERROR
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if type(exc) is RuntimeError or (accel is not None
                                     and isinstance(exc, accel)):
        return str(exc).startswith("CUDA error: out of memory")
    return False
