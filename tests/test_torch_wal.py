"""The port's WAL (consensus/log.py) against the JAX package's, on the CPU.

Twins of tests/test_consensus.py's TestLog (round trip and recovery,
segment rollover and GC, a torn tail, truncate_after) and of
tests/test_fault_injection.py's TestWalAppendFailure, plain and with
encrypted segments. Each case runs the same appends in each package's
Log: the segments must be byte-identical (plaintext) or equal in their
plaintext (encrypted), the replays equal, and each package must replay
and continue the other's log. Tolerance: exact.
"""

import os

import pytest

from tests.test_torch_env import (BOTH, PORT, REF, encrypted_both, envs,
                                  needs_crypto)


def _segments(wal, env=None):
    """{segment name: bytes} (the plaintext through `env` when given)."""
    out = {}
    for name in sorted(os.listdir(wal)):
        p = os.path.join(wal, name)
        out[name] = env.read_file(p) if env is not None else \
            open(p, "rb").read()
    return out


def _replay(P, wal):
    return [(e.term, e.index, e.payload)
            for e in P.log.LogReader(wal).read_all()]


def _check(tmp_path, env=None):
    """Segments equal between the packages; each replays the other's."""
    a = _segments(str(tmp_path / REF.name), env)
    b = _segments(str(tmp_path / PORT.name), env)
    assert a == b and a
    for P in BOTH:
        assert _replay(P, str(tmp_path / REF.name)) == \
            _replay(P, str(tmp_path / PORT.name))


@pytest.fixture(params=["plain", pytest.param("encrypted",
                                               marks=needs_crypto)])
def wal_env(request):
    if request.param == "plain":
        yield None
        return
    with encrypted_both() as e:
        yield e[PORT.name]


def test_roundtrip_and_recovery(tmp_path, wal_env):
    seen = {}
    for P in BOTH:
        wal = str(tmp_path / P.name)
        log = P.log.Log(wal)
        log.append_sync([P.log.LogEntry(1, i, f"payload-{i}".encode())
                         for i in range(1, 51)])
        last = log.last_op_id
        log.close()
        log2 = P.log.Log(wal)
        seen[P.name] = (last, log2.last_op_id, _replay(P, wal)[10])
        log2.close()
    assert seen[REF.name] == seen[PORT.name] == \
        ((1, 50), (1, 50), (1, 11, b"payload-11"))
    _check(tmp_path, wal_env)


def test_segment_rollover_and_gc(tmp_path, wal_env):
    seen = {}
    for P in BOTH:
        P.flags.set_flag("log_segment_size_bytes", 512)
        try:
            wal = str(tmp_path / P.name)
            log = P.log.Log(wal)
            for i in range(1, 101):
                log.append_sync([P.log.LogEntry(1, i, b"x" * 64)])
            n_segs = len(P.log.LogReader(wal).segments())
            cand = log.gc_candidate_bytes(60)
            removed = log.gc_up_to(60)
            seen[P.name] = (n_segs, cand, removed,
                            [e[1] for e in _replay(P, wal)])
            log.close()
        finally:
            P.flags.reset_flag("log_segment_size_bytes")
    assert seen[REF.name] == seen[PORT.name]
    n_segs, _cand, removed, remaining = seen[PORT.name]
    assert n_segs > 3 and removed > 0 and set(range(60, 101)) <= \
        set(remaining)
    _check(tmp_path, wal_env)


def test_torn_tail_dropped_and_each_continues_the_other(tmp_path, wal_env):
    for P, Q in ((REF, PORT), (PORT, REF)):
        wal = str(tmp_path / P.name)
        log = P.log.Log(wal)
        log.append_sync([P.log.LogEntry(1, i, b"data") for i in (1, 2, 3)])
        log.close()
        seg = P.log.LogReader(wal).segments()[0]
        with open(seg, "ab") as f:
            f.write(b"\x01\x02\x03garbage-partial-record")
        log2 = Q.log.Log(wal)      # the other package recovers it
        assert log2.last_op_id == (1, 3)
        log2.append_sync([Q.log.LogEntry(1, 4, b"after")])
        log2.close()
        assert [e[1] for e in _replay(P, wal)] == [1, 2, 3, 4]
    _check(tmp_path, wal_env)


def test_truncate_after(tmp_path, wal_env):
    for P in BOTH:
        wal = str(tmp_path / P.name)
        log = P.log.Log(wal)
        log.append_sync([P.log.LogEntry(1, i, b"d") for i in range(1, 11)])
        log.truncate_after(6)
        assert log.last_op_id == (1, 6)
        log.append_sync([P.log.LogEntry(2, 7, b"new7")])
        log.close()
        assert [(t, i) for t, i, _p in _replay(P, wal)] == \
            [(1, i) for i in range(1, 7)] + [(2, 7)]
    _check(tmp_path, wal_env)


@needs_crypto
def test_encrypted_segment_refuses_without_keys(tmp_path):
    """An encrypted WAL opened without universe keys fails closed in both
    packages (the torn-tail rewrite would destroy committed data)."""
    with encrypted_both():
        for P in BOTH:
            log = P.log.Log(str(tmp_path / P.name))
            log.append_sync([P.log.LogEntry(1, 1, b"secret")])
            log.close()
    for P in BOTH:
        for Q in BOTH:
            with pytest.raises(RuntimeError, match="no universe keys"):
                Q.log.Log(str(tmp_path / P.name))


# ------------------------------------------------ TestWalAppendFailure
@pytest.fixture()
def fenvs():
    with envs(lambda P: P.env.FaultInjectionEnv(P.env.Env())) as made:
        yield made


def test_append_sync_raises_and_log_seals(fenvs, tmp_path):
    seen = {}
    for P in BOTH:
        fe = fenvs[P.name]
        wal = str(tmp_path / P.name)
        log = P.log.Log(wal)
        log.append_sync([P.log.LogEntry(1, 1, b"ok")])
        fe.set_fault("append", path_filter="wal-")
        steps = []
        try:
            log.append_sync([P.log.LogEntry(1, 2, b"fails")])
            steps.append("appended")
        except OSError as e:
            steps.append(type(e).__name__)
        steps.append(log.io_error is not None)
        fe.clear_faults()
        try:
            log.append_sync([P.log.LogEntry(1, 3, b"still fails")])
            steps.append("appended")
        except OSError as e:
            steps.append(type(e).__name__)
        log.close()
        steps.append([e[1] for e in _replay(P, wal)])
        seen[P.name] = steps
    assert seen[REF.name] == seen[PORT.name]
    assert seen[PORT.name][1:] == [True, seen[PORT.name][2], [1]]
    assert "appended" not in seen[PORT.name]
    _check(tmp_path)


def test_torn_append_recovers_to_record_boundary(fenvs, tmp_path):
    seen = {}
    for P in BOTH:
        fe = fenvs[P.name]
        wal = str(tmp_path / P.name)
        log = P.log.Log(wal)
        log.append_sync([P.log.LogEntry(1, i, f"p{i}".encode() * 50)
                         for i in range(1, 6)])
        fe.set_fault("append_short", path_filter="wal-", count=1)
        with pytest.raises(OSError):
            log.append_sync([P.log.LogEntry(1, 6, b"torn" * 100)])
        log.close()
        fe.clear_faults()
        steps = [[e[1] for e in _replay(P, wal)]]
        log2 = P.log.Log(wal)
        log2.append_sync([P.log.LogEntry(1, 6, b"retried")])
        log2.close()
        steps.append([e[1] for e in _replay(P, wal)])
        seen[P.name] = steps
    assert seen[REF.name] == seen[PORT.name] == \
        [[1, 2, 3, 4, 5], [1, 2, 3, 4, 5, 6]]
    _check(tmp_path)
