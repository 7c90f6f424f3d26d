"""The port's offload vocabulary and policy routing against the JAX
package's.

`bucket_key` and `point_read_bucket_key` agree over a grid of run
lengths; the declared compile surface (read from the committed kernel
manifest as data) is the same set; and the router with
`offload_policy=health_board()` routes each mode — forced device, forced
native, COLD, measured (prewarmed), DEGRADED — the same way in both
packages: byte-identical files (== the native job), equal decision
counters and equal boards.
"""

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_compaction import _files, _mk_run, _write_inputs
from tests.test_torch_fault_containment import (Twin, assert_boards_equal,
                                                board_view)
from tests.test_torch_env import require_reference_native
from yugabyte_tpu.storage import bucket_health as ref_bh
from yugabyte_tpu.storage import compaction as ref_compaction
from yugabyte_tpu.storage import offload_policy as ref_pol
from yugabyte_tpu.storage.sst import SSTReader as RefSSTReader
from yugabyte_tpu.utils import flags as ref_flags
from yugabyte_tpu_torch.ops import run_merge
from yugabyte_tpu_torch.storage import bucket_health as port_bh
from yugabyte_tpu_torch.storage import compaction as port_compaction
from yugabyte_tpu_torch.storage import integrity  # noqa: F401 (its flags)
from yugabyte_tpu_torch.storage import offload_policy as port_pol
from yugabyte_tpu_torch.storage.sst import SSTReader
from yugabyte_tpu_torch.utils import flags as port_flags

torch.set_num_threads(1)

CUTOFF = (1 << 21) << 12


@pytest.fixture(autouse=True)
def _reference_native():
    """The reference's native engine loads and its process Env is
    plaintext (tests/test_torch_env.require_reference_native): the twins
    here drive its ingest_packed or native jobs."""
    require_reference_native()


@pytest.fixture(autouse=True)
def _fresh():
    """Fresh boards, and the sampled checks off in both packages: their
    coin flips would make the two packages' counters differ."""
    samples = {k: (port_flags.get_flag(k), ref_flags.get_flag(k))
               for k in ("shadow_verify_sample", "resident_digest_sample")}
    for k in samples:
        port_flags.set_flag(k, 0.0)
        ref_flags.set_flag(k, 0.0)
    port_bh.health_board().reset()
    ref_bh.health_board().reset()
    yield
    for fl in (port_flags, ref_flags):
        fl.reset_flag("device_offload_mode")
    for k, (p, r) in samples.items():
        port_flags.set_flag(k, p)
        ref_flags.set_flag(k, r)
    port_bh.health_board().reset()
    ref_bh.health_board().reset()


GRID = [(), (1,), (0, 7), (100,), (300, 300, 300), (1, 2, 3, 4, 5),
        (65536, 65536), (65537, 12), (1 << 18, 1 << 16, 1 << 16, 5),
        (3000, 40, 40, 40, 40), tuple(range(1, 18)), (0, 0, 9)]


@pytest.mark.parametrize("runs", GRID, ids=lambda r: repr(r)[:30])
def test_bucket_key_matches_reference(runs):
    from yugabyte_tpu.ops import run_merge as ref_run_merge
    port_ns = run_merge.packed_run_ns(list(runs)) if any(runs) else []
    ref_ns = ref_run_merge.packed_run_ns(list(runs)) if any(runs) else []
    assert port_ns == ref_ns
    assert port_pol.bucket_key(port_ns) == ref_pol.bucket_key(ref_ns)
    assert port_pol.bucket_key(list(runs)) == ref_pol.bucket_key(list(runs))


@pytest.mark.parametrize("n_pad", [1, 64, 1024, 1 << 16, 1 << 24])
def test_point_read_bucket_key_matches_reference(n_pad):
    assert port_pol.point_read_bucket_key(n_pad) == \
        ref_pol.point_read_bucket_key(n_pad) == (1, n_pad)


def test_declared_surface_matches_reference():
    assert port_pol.declared_surface_keys() == ref_pol.declared_surface_keys()
    assert port_pol.declared_surface_counts() == \
        ref_pol.declared_surface_counts()


def test_quarantine_registry_is_the_boards():
    """The legacy registry and the board share one memory; restore()
    re-opens a window without counting a new fault."""
    reg = port_pol.bucket_quarantine()
    assert reg is port_bh.health_board().quarantine_registry()
    added = port_pol._quarantine_counter("added")
    a0 = added.value()
    reg.restore((4, 512), "restored", 2, 30.0)
    assert added.value() == a0
    assert reg.is_quarantined((4, 512))
    board = port_bh.health_board()
    assert not board.allow_device("run_merge_fused", (4, 512))
    assert board.state("run_merge_fused", (4, 512)) == port_bh.QUARANTINED
    reg.clear()
    assert not reg.is_quarantined((4, 512))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("policy_inputs")
    rng = np.random.default_rng(31)
    return _write_inputs(str(d), [_mk_run(rng, 300, 400) for _ in range(3)])


def routed(pkg, paths, out_dir):
    out_dir.mkdir()
    ids = iter(range(100, 1000))
    if pkg == "ref":
        return ref_compaction.run_compaction_job(
            [RefSSTReader(p) for p in paths], str(out_dir),
            lambda: next(ids), CUTOFF, True, device=jax.devices("cpu")[0],
            offload_policy=ref_bh.health_board())
    if pkg == "port":
        return port_compaction.run_compaction_job(
            [SSTReader(p) for p in paths], str(out_dir), lambda: next(ids),
            CUTOFF, True, device="cpu",
            offload_policy=port_bh.health_board())
    return port_compaction._run_native_job(
        [SSTReader(p) for p in paths], str(out_dir), lambda: next(ids),
        CUTOFF, True, False, None)


def degrade(board, key):
    """Three slow device results, then a faster native rate."""
    for _ in range(3):
        board.record_device("run_merge_fused", key, 1000, 1.0)
    board.record_native("run_merge_fused", key, 1000, 0.001)


MODES = {
    "forced_device": ("device", None),
    "forced_native": ("native", None),
    "cold": ("auto", None),
    "measured": ("auto", "prewarm"),
    "degraded": ("auto", "degrade"),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_routing_matches_reference(tmp_path, inputs, monkeypatch, mode):
    monkeypatch.setenv("YBTPU_DEVICE_CODEC", "0")
    flag, prep = MODES[mode]
    for fl in (port_flags, ref_flags):
        fl.set_flag("device_offload_mode", flag)
    key = (4, 512)
    for board in (port_bh.health_board(), ref_bh.health_board()):
        if prep == "prewarm":
            board.record_prewarmed("run_merge_fused", key)
        elif prep == "degrade":
            degrade(board, key)
    native = _files(routed("native", inputs, tmp_path / "native").outputs)
    decisions = {}
    with Twin() as twin:
        got = {pkg: _files(routed(pkg, inputs, tmp_path / pkg).outputs)
               for pkg in ("ref", "port")}
    assert got["port"] == got["ref"] == native and native
    assert twin.port == twin.ref
    for k, v in twin.port.items():
        if k[1].startswith("offload_decisions_"):
            decisions[k[1][len("offload_decisions_"):-len("_total")]] = v
    want = {"forced_device": {"forced": 1, "device": 1},
            "forced_native": {"forced": 1, "native": 1},
            "cold": {"cold": 1, "native": 1},
            "measured": {"measured": 1, "device": 1},
            "degraded": {"measured": 1, "device": 1}}[mode]
    assert decisions == want
    assert_boards_equal()
    rec = {tuple(k["bucket"]): k for k in
           board_view(port_bh.health_board())["keys"]
           if k["family"] == "run_merge_fused"}[key]
    if mode == "cold":
        # the native routing was timed into the board
        assert rec["native_obs"] == 1 and rec["state"] == port_bh.COLD
    if mode == "degraded":
        # decided device, but the executing gate has no probe slot: the
        # job completed natively, timed
        assert rec["state"] == port_bh.DEGRADED and rec["native_obs"] == 2
