"""The port's bucket-health board against the JAX package's.

The same scripted sequence of record_device / record_native /
record_fault / record_mismatch / clear_mismatch / record_prewarmed calls
and gate queries runs on a board of each package under one injected
clock (the board clock, and the `time` of both packages' offload_policy
and bucket_health modules, so quarantine windows, wall stamps and probe
history are equal too; nothing sleeps). After every step the answers,
state() of every key and snapshot() must be equal, and so must the
bucket_health / offload_policy registry counters each package moved. A
board saved by one package loads in the other, and both write the same
JSON.
"""

import json
import types

import pytest

from yugabyte_tpu.storage import bucket_health as ref_bh
from yugabyte_tpu.storage import offload_policy as ref_pol
from yugabyte_tpu.utils import flags as ref_flags
from yugabyte_tpu.utils.metrics import ROOT_REGISTRY as REF_REGISTRY
from yugabyte_tpu_torch.storage import bucket_health as port_bh
from yugabyte_tpu_torch.storage import offload_policy as port_pol
from yugabyte_tpu_torch.utils import flags as port_flags
from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY as PORT_REGISTRY

F = "run_merge_fused"
B = (4, 512)
B2 = (2, 1 << 16)
P = "point_read_locate"
PB = (1, 1 << 20)


class FakeClock:
    """monotonic() and time() of both packages' policy modules."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self):
        return self.t

    def time(self):
        return 1.7e9 + self.t


@pytest.fixture
def clock(monkeypatch):
    clk = FakeClock()
    fake = types.SimpleNamespace(monotonic=clk.monotonic, time=clk.time)
    for mod in (ref_pol, port_pol, ref_bh, port_bh):
        monkeypatch.setattr(mod, "time", fake)
    yield clk


_SET = []


def set_both(name, value):
    """Set a flag in both packages' registries, reset after the test."""
    ref_flags.set_flag(name, value)
    port_flags.set_flag(name, value)
    _SET.append(name)


@pytest.fixture(autouse=True)
def _fresh():
    port_bh.health_board().reset()
    yield
    for name in _SET:
        ref_flags.reset_flag(name)
        port_flags.reset_flag(name)
    _SET.clear()
    port_bh.health_board().reset()


def entity_values(registry, ent):
    e = registry.entity("server", ent)
    return {k: m.value() for k, m in e.metrics_snapshot().items()
            if hasattr(m, "value")}


def counter_deltas(registry, before):
    out = {}
    for ent, vals in before.items():
        now = entity_values(registry, ent)
        for k, v in now.items():
            if v != vals.get(k, 0):
                out[(ent, k)] = v - vals.get(k, 0)
    return out


def apply(board, op):
    kind, args = op[0], op[1:]
    if kind == "dev":
        return board.record_device(*args)
    if kind == "nat":
        return board.record_native(*args)
    if kind == "fault":
        fam, bucket, reason, ttl = args
        return board.record_fault(fam, bucket, reason, ttl_s=ttl)
    if kind == "mm":
        return board.record_mismatch(*args)
    if kind == "clear":
        return board.clear_mismatch(*args)
    if kind == "prewarm":
        return board.record_prewarmed(*args)
    if kind == "use":
        return board.use_device(*args)
    if kind == "use_np":
        return board.use_device(*args, probe=False)
    if kind == "allow":
        return board.allow_device(*args)
    if kind == "state":
        return board.state(*args)
    if kind == "prio":
        return board.prewarm_priorities()
    raise AssertionError(kind)


FAST = 5000.0      # rows / s
SLOW = 1000.0


def dev(rate=FAST, fam=F, bucket=B, rows=1000):
    return ("dev", fam, bucket, rows, rows / rate)


def nat(rate=FAST, fam=F, bucket=B, rows=1000):
    return ("nat", fam, bucket, rows, rows / rate)


SCRIPTS = {
    # COLD routes native at policy sites, the first result warms it and
    # warmup_obs results make it HEALTHY
    "cold_warm_healthy": [
        ("use", F, B), ("allow", F, B), ("state", F, B), dev(),
        ("state", F, B), ("use", F, B), dev(), dev(), ("state", F, B),
        ("use", F, B)],
    # one cold-compile sample must not demote; a measured crossover does
    "warmup_then_demote": [
        nat(FAST), dev(SLOW), ("state", F, B), dev(SLOW), dev(SLOW),
        ("state", F, B), ("use", F, B), ("use_np", F, B)],
    # HEALTHY demotes when the native EWMA overtakes, then the probe
    # gate rations re-promotion: one probe in flight, backoff on a
    # losing probe, a native gap before the next, a winning probe
    # re-promotes
    "probe_gate": [
        dev(), dev(), dev(), ("state", F, B), nat(4 * FAST), nat(4 * FAST),
        ("state", F, B), ("allow", F, B), ("advance", 29.0),
        ("allow", F, B), ("advance", 2.0), ("allow", F, B),
        ("allow", F, B), dev(SLOW), ("state", F, B), ("allow", F, B),
        ("advance", 61.0), ("allow", F, B), ("advance", 61.0),
        ("allow", F, B), dev(100 * FAST), dev(100 * FAST),
        dev(100 * FAST), ("state", F, B)],
    # a probe whose job died silently must not wedge the bucket
    "probe_timeout": [
        dev(), dev(), dev(), nat(4 * FAST), ("advance", 31.0),
        ("allow", F, B), ("advance", 601.0), ("allow", F, B),
        ("state", F, B)],
    # a fault parks the bucket; the window decays to PROBATION and
    # probation_obs clean results make it HEALTHY
    "fault_decay_probation": [
        dev(), ("fault", F, B, "oom", 10.0), ("allow", F, B),
        ("use", F, B), ("state", F, B), ("advance", 9.0),
        ("state", F, B), ("advance", 2.0), ("state", F, B),
        ("allow", F, B), dev(), ("state", F, B), dev(), ("state", F, B)],
    # a fault during probation re-quarantines
    "fault_in_probation": [
        ("fault", F, B, "runtime", 5.0), ("advance", 6.0),
        ("allow", F, B), ("fault", F, B, "runtime again", 5.0),
        ("state", F, B), ("allow", F, B), ("advance", 6.0),
        ("allow", F, B), dev(), dev(), ("state", F, B)],
    # a fault during a DEGRADED bucket's probe fails the probe too
    "fault_during_probe": [
        dev(), dev(), dev(), nat(4 * FAST), ("advance", 31.0),
        ("allow", F, B), ("fault", F, B, "probe fault", 3.0),
        ("state", F, B), ("advance", 4.0), ("state", F, B)],
    # a shadow mismatch is sticky past any decay, until an operator
    # clear, which puts the bucket on probation
    "mismatch_sticky": [
        dev(), dev(), dev(), ("mm", F, B, "ShadowMismatch: x"),
        ("allow", F, B), ("advance", 10_000.0), ("allow", F, B),
        ("state", F, B), ("clear", F, B), ("state", F, B),
        ("allow", F, B), dev(), dev(), ("state", F, B),
        ("mm", P, PB, "digest"), ("clear",), ("state", P, PB)],
    # keys are isolated; COLD traffic orders the prewarm, and a prewarm
    # moves a COLD key to WARMING
    "isolation_and_prewarm": [
        ("use", F, B), ("use", F, B2), ("use", F, B2), ("use", P, PB),
        ("use", P, PB), ("use", P, PB), ("prio",),
        ("fault", F, B2, "oom", 100.0), ("state", F, B), ("state", P, PB),
        ("prewarm", F, B), ("prio",), ("use", F, B), ("state", F, B2),
        ("use", F, B2)],
}


def run_script(clock, script):
    """Run `script` on a fresh board of each package under `clock`;
    return the per-step transcript of each."""
    ref_board = ref_bh.BucketHealthBoard(clock=clock.monotonic)
    port_board = port_bh.BucketHealthBoard(clock=clock.monotonic)
    keys = {(F, B), (F, B2), (P, PB)}
    transcripts = []
    for i, op in enumerate(script):
        if op[0] == "advance":
            clock.t += op[1]
            continue
        got = [apply(b, op) for b in (ref_board, port_board)]
        states = [{k: b.state(*k) for k in sorted(keys)}
                  for b in (ref_board, port_board)]
        snaps = [b.snapshot() for b in (ref_board, port_board)]
        assert got[0] == got[1], (i, op, got)
        assert states[0] == states[1], (i, op, states)
        assert snaps[0] == snaps[1], (i, op)
        transcripts.append((op, got[1], states[1]))
    return ref_board, port_board, transcripts


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_scripted_boards_agree(clock, name):
    before = {e: entity_values(REF_REGISTRY, e)
              for e in ("bucket_health", "offload_policy")}
    pbefore = {e: entity_values(PORT_REGISTRY, e)
               for e in ("bucket_health", "offload_policy")}
    run_script(clock, SCRIPTS[name])
    ref_moved = counter_deltas(REF_REGISTRY, before)
    port_moved = counter_deltas(PORT_REGISTRY, pbefore)
    assert port_moved == ref_moved
    if name != "isolation_and_prewarm":
        assert port_moved, "the script moved no counter"


def test_script_reaches_every_state(clock):
    """The scripts together walk every state of the machine on the
    port's board."""
    seen = set()
    for script in SCRIPTS.values():
        _r, _p, tr = run_script(clock, script)
        for _op, _got, states in tr:
            seen.update(states.values())
    assert seen == set(port_bh.STATES)


def test_forced_modes_agree(clock):
    for mode, want in (("device", True), ("native", False)):
        set_both("device_offload_mode", mode)
        boards = [ref_bh.BucketHealthBoard(clock=clock.monotonic),
                  port_bh.BucketHealthBoard(clock=clock.monotonic)]
        for b in boards:
            b.record_fault(F, B, "oom", ttl_s=100.0)
        assert [b.use_device(F, B) for b in boards] == [want, want]
        assert boards[0].snapshot() == boards[1].snapshot()


@pytest.mark.parametrize("first", ["port", "ref"])
def test_saved_board_loads_in_the_other_package(clock, tmp_path, first):
    """Quarantine windows (remaining TTL), sticky mismatches and the
    fault / traffic tallies cross packages; both write the same JSON."""
    script = [dev(), ("use", F, B2), ("fault", F, B2, "oom", 50.0),
              ("mm", P, PB, "ShadowMismatch: y"), ("advance", 5.0)]
    ref_board, port_board, _ = run_script(clock, script)
    ref_path, port_path = tmp_path / "ref.json", tmp_path / "port.json"
    ref_board.save(str(ref_path))
    port_board.save(str(port_path))
    assert json.loads(ref_path.read_text()) == \
        json.loads(port_path.read_text())
    src = port_path if first == "port" else ref_path
    loaded = [ref_bh.BucketHealthBoard(clock=clock.monotonic),
              port_bh.BucketHealthBoard(clock=clock.monotonic)]
    assert [b.load(str(src)) for b in loaded] == [3, 3]
    for key in ((F, B), (F, B2), (P, PB)):
        assert loaded[0].state(*key) == loaded[1].state(*key), key
    assert loaded[1].state(F, B2) == port_bh.QUARANTINED
    assert loaded[1].state(P, PB) == port_bh.QUARANTINED
    assert loaded[1].state(F, B) == port_bh.WARMING
    assert loaded[0].snapshot() == loaded[1].snapshot()
    clock.t += 46.0   # the restored window decays on the same clock
    assert loaded[1].state(F, B2) == loaded[0].state(F, B2) \
        == port_bh.PROBATION


def test_load_missing_or_corrupt_is_cold_start(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for path in (tmp_path / "none.json", bad):
        assert port_bh.BucketHealthBoard().load(str(path)) == \
            ref_bh.BucketHealthBoard().load(str(path)) == 0


def test_legacy_quarantine_clear_resets_the_process_board():
    board = port_bh.health_board()
    board.record_fault(F, B, "oom")
    assert board.state(F, B) == port_bh.QUARANTINED
    port_pol.bucket_quarantine().clear()
    assert board.state(F, B) == port_bh.COLD
    assert board.snapshot()["quarantine"] == []


def test_prewarms_move_their_buckets_out_of_cold(monkeypatch):
    """Each family's prewarm builds its kernels' library, launches them
    once at the declared shapes (here cut small, on the CPU) and marks the
    bucket prewarmed: COLD -> WARMING, so the policy gate stops routing
    it native."""
    from yugabyte_tpu_torch.ops import block_codec, point_read, run_merge
    from yugabyte_tpu_torch.ops import scan
    from yugabyte_tpu_torch.parallel import dist_compact
    from yugabyte_tpu_torch.parallel.mesh import make_mesh
    monkeypatch.setattr(point_read, "_PREWARM_NPADS", (1 << 12,))
    monkeypatch.setattr(scan, "_PREWARM_NPADS", (1 << 12,))
    monkeypatch.setattr(block_codec, "_PREWARM_DECODE", ((1 << 12, 4),))
    board = port_bh.health_board()
    got = {
        "merge": run_merge.prewarm_buckets([(2, 1 << 10, 4, 8)],
                                           device="cpu"),
        "codec": block_codec.prewarm_block_codec("cpu"),
        "pushdown": scan.prewarm_scan_pushdown("cpu"),
        "point": point_read.prewarm_point_read("cpu"),
        "mesh": dist_compact.prewarm_dist_compact(
            make_mesh(2, devices=["cpu"] * 2), capacities=(256,),
            pool_shapes=((2, 1 << 10, 4, 8),)),
    }
    assert got == {"merge": 2, "codec": 2, "pushdown": 4, "point": 14,
                   "mesh": 2}
    states = {(k["family"], tuple(k["bucket"])): k["state"]
              for k in board.snapshot()["keys"]}
    assert states == {
        ("run_merge_fused", (2, 1 << 10)): port_bh.WARMING,
        ("block_decode", (1, 1 << 12)): port_bh.WARMING,
        ("block_encode", (1, 1 << 12)): port_bh.WARMING,
        ("scan_filtered", (1, 1 << 12)): port_bh.WARMING,
        ("scan_agg", (1, 1 << 12)): port_bh.WARMING,
        ("point_read_locate", (1, 1 << 12)): port_bh.WARMING,
        ("dist_compact", (2, 256)): port_bh.WARMING}
    assert board.use_device("run_merge_fused", (2, 1 << 10))
    assert board.prewarm_priorities() == []
