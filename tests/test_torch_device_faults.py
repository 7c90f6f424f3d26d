"""The port's device-fault injection and classification.

Injection (arm, disarm_all, armed_count, maybe_fault with the "slow"
kind and bucket pinning, maybe_flip_survivors and the
YBTPU_INJECT_DEVICE_FAULT spec) is held against the JAX package's
ops/device_faults.py: the same armings fire the same exception types and
messages, consume the same counts, move the same registry counters and
flip the same decision. `is_device_fault` is the port's own design: it
classifies torch's CUDA failures and refuses every bug class (a failed
kernel build or load, a launch refused for its configuration, a
wrapper's contract check, cancellation, a host error)."""

import subprocess

import numpy as np
import pytest
import torch

from yugabyte_tpu.ops import device_faults as ref_df
from yugabyte_tpu.utils.metrics import kernel_metrics as ref_kernel_metrics
from yugabyte_tpu_torch.ops import device_faults as port_df
from yugabyte_tpu_torch.utils import torch_setup
from yugabyte_tpu_torch.utils.cancellation import OperationCancelled
from yugabyte_tpu_torch.utils.metrics import kernel_metrics as \
    port_kernel_metrics

BOTH = (ref_df, port_df)


@pytest.fixture(autouse=True)
def _disarmed():
    for m in BOTH:
        m.disarm_all()
    yield
    for m in BOTH:
        m.disarm_all()


def _fired(mod, site, bucket=None):
    """(exception type name, message) of one maybe_fault call, or None."""
    try:
        mod.maybe_fault(site, bucket=bucket)
    except Exception as e:  # noqa: BLE001 — the injected fault
        return type(e).__name__, str(e)
    return None


def _fault_counters(kernel_metrics):
    e = kernel_metrics()
    return {k: m.value() for k, m in e.metrics_snapshot().items()
            if k.startswith("kernel_injected_fault_")}


def _moved(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


@pytest.mark.parametrize("kind", ["compile", "oom", "runtime"])
@pytest.mark.parametrize("site", ["dispatch", "result"])
def test_loud_kinds_fire_alike(kind, site):
    before = [_fault_counters(ref_kernel_metrics),
              _fault_counters(port_kernel_metrics)]
    for m in BOTH:
        m.arm(kind, site=site, count=2)
    other = "result" if site == "dispatch" else "dispatch"
    seq = [[_fired(m, s) for s in (other, site, site, site)] for m in BOTH]
    assert seq[0] == seq[1]
    assert seq[1][0] is None and seq[1][3] is None
    assert seq[1][1] is not None and seq[1][1] == seq[1][2]
    assert [m.armed_count() for m in BOTH] == [0, 0]
    moved = [_moved(before[0], _fault_counters(ref_kernel_metrics)),
             _moved(before[1], _fault_counters(port_kernel_metrics))]
    assert moved[0] == moved[1] == {f"kernel_injected_fault_{kind}_total": 2}
    # every injected fault is a device fault in both packages
    for m in BOTH:
        m.arm(kind, site=site)
        with pytest.raises(m.InjectedDeviceFault) as exc:
            m.maybe_fault(site)
        assert m.is_device_fault(exc.value)


def test_slow_kind_bucket_pinning_and_stacking(monkeypatch):
    """'slow' sleeps without raising, only at its pinned bucket when
    given one, and stacks with a loud fault on the same call."""
    slept = {id(m): [] for m in BOTH}
    cur = []
    # both modules sleep through the one stdlib time module
    monkeypatch.setattr(port_df.time, "sleep", lambda s: cur[-1].append(s))
    outs = []
    for m in BOTH:
        cur.append(slept[id(m)])
        m.arm("slow", site="dispatch", count=2, delay_s=0.25,
              bucket=(4, 512))
        m.arm("oom", site="dispatch", count=1)
        outs.append([_fired(m, "dispatch", bucket=(2, 512)),
                     _fired(m, "dispatch", bucket=(4, 512)),
                     _fired(m, "dispatch"),
                     _fired(m, "dispatch", bucket=(4, 512)),
                     m.armed_count()])
    assert outs[0] == outs[1]
    assert outs[1][0] is not None and outs[1][1] is None   # oom first
    assert outs[1][4] == 0
    assert slept[id(ref_df)] == slept[id(port_df)] == [0.25, 0.25]


@pytest.mark.parametrize("surv,mk", [
    ([0, 3, 5, 8, 11], [False] * 5),      # an odd index flips its low bit
    ([0, 2, 4, 6], [False, True, False, False]),  # all even: a tomb flag
    ([], []),                             # nothing to flip
])
def test_bitflip_mutates_alike(surv, mk):
    got = []
    for m in BOTH:
        m.arm("bitflip", site="survivor", count=1)
        s = np.asarray(surv, dtype=np.int64)
        t = np.asarray(mk, dtype=bool)
        fired = m.maybe_flip_survivors(s, t)
        got.append((fired, s.tolist(), t.tolist(), m.armed_count()))
    assert got[0] == got[1]
    assert got[1][0] == bool(surv)
    if surv:
        assert (got[1][1], got[1][2]) != (surv, mk)


def test_env_spec_parses_alike(monkeypatch):
    spec = ("oom:result:2,bitflip,runtime:dispatch:x,compile:nowhere:1,"
            "bogus:result:1")
    monkeypatch.setenv("YBTPU_INJECT_DEVICE_FAULT", spec)
    out = []
    for m in BOTH:
        monkeypatch.setattr(m, "_env_loaded", False)
        seq = [_fired(m, "dispatch"), _fired(m, "result"),
               _fired(m, "result"), _fired(m, "result")]
        flips = m.maybe_flip_survivors(np.array([1, 3]), np.zeros(2, bool))
        out.append((seq, flips, m.armed_count()))
    assert out[0] == out[1]
    seq, flips, left = out[1]
    assert seq[0] is not None and seq[0][0] == "InjectedDispatchFault"
    assert seq[1] == seq[2] and seq[1][0] == "InjectedResourceExhausted"
    assert seq[3] is None and flips and left == 0


def _launch_error(code):
    try:
        torch_setup.raise_on_cuda_error(code, "merge_tiles")
    except torch_setup.CudaLaunchError as e:
        return e


def _contract_error():
    try:
        torch_setup.check_u32_matrix(torch.zeros(4, dtype=torch.int32),
                                     "gc_pack")
    except ValueError as e:
        return e


def _build_error():
    """The error a missing kernel source gives: nvcc's failure where
    nvcc exists, else the missing compiler (OSError)."""
    try:
        torch_setup.load_cuda_lib("no_such_kernel.cu")
    except Exception as e:  # noqa: BLE001 — whatever the build raised
        return e
    raise AssertionError("a missing source built")


CONTAINED = {
    "injected_compile": port_df.InjectedCompileError("x"),
    "injected_oom": port_df.InjectedResourceExhausted("x"),
    "injected_runtime": port_df.InjectedDispatchFault("x"),
    "cuda_oom": torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"),
    "accelerator_oom": torch.AcceleratorError(
        "CUDA error: out of memory"),
    "runtime_cuda_oom": RuntimeError("CUDA error: out of memory"),
    "launch_alloc": _launch_error(2),
}

NOT_CONTAINED = {
    # sticky CUDA errors: the context is unusable, the process restarts
    "accelerator_error": torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"),
    "runtime_cuda_error": RuntimeError(
        "CUDA error: unspecified launch failure"),
    "launch_illegal_address": _launch_error(700),
    "launch_failure": _launch_error(719),
    "launch_ecc": _launch_error(214),
    "launch_invalid_configuration": _launch_error(9),
    "launch_invalid_value": _launch_error(1),
    "launch_no_kernel_image": _launch_error(209),
    "launch_out_of_resources": _launch_error(701),
    "build_subprocess": subprocess.CalledProcessError(1, ["nvcc"]),
    "build_failed": RuntimeError("build failed: merge_path.cu (exit 1)"),
    "build_missing_source": _build_error(),
    "import_error": ImportError("no module named triton"),
    "os_error": OSError("cannot open shared object file"),
    "contract_shape": _contract_error(),
    "contract_dtype": TypeError("gc_pack: expected int32 (u32 bits), got "
                                "torch.int64"),
    "cancelled": OperationCancelled("compaction cancelled: shutdown"),
    "host_key_error": KeyError("fid"),
    "host_runtime_error": RuntimeError("distributed compaction bucket "
                                       "overflow at 64x"),
    "host_value_error": ValueError("bad shape"),
}


@pytest.mark.parametrize("name", sorted(CONTAINED))
def test_device_faults_are_contained(name):
    assert port_df.is_device_fault(CONTAINED[name])


@pytest.mark.parametrize("name", sorted(NOT_CONTAINED))
def test_bugs_and_host_errors_are_not_contained(name):
    exc = NOT_CONTAINED[name]
    assert exc is not None
    assert not port_df.is_device_fault(exc)
