"""The port's Envs against the JAX package's, on the CPU.

Twins of tests/test_encryption.py's Env and DB cases (the cluster case
waits for the cluster part of ROADMAP queue A item 7) and of
tests/test_fault_injection.py's TestFaultInjectionEnv and
TestDBBackgroundError, plus the encrypted compaction on every route of
the router. Each case runs the same steps against each package's own
process Env (utils/env.py of each) and must give the same answers; the
files each package writes are held byte for byte (plaintext ones) or by
their plaintext (encrypted ones, which carry a random nonce per file:
both packages decrypt with the same universe key), and each package must
read the files the other wrote. Tolerance: exact (decisions and bytes).

Also the helper every port test that drives the reference's
`ingest_packed` or native job calls first: `require_reference_native`.
"""

import contextlib
import fcntl
import importlib
import importlib.util
import os
import subprocess
from types import SimpleNamespace

import numpy as np
import pytest

import jax

from yugabyte_tpu.utils import env as ref_env
from yugabyte_tpu_torch.storage import native_engine

pytestmark = pytest.mark.skipif(not native_engine.available(),
                                reason="native engine unavailable")

# the AES-CTR cipher lives in the optional `cryptography` package, in
# both packages: the encrypted cases need it
needs_crypto = pytest.mark.skipif(
    importlib.util.find_spec("cryptography") is None,
    reason="the cryptography package is not installed")


# ------------------------------------------- the reference's preconditions
def require_reference_native() -> None:
    """The two preconditions of a twin that drives the reference's
    `ingest_packed` or its native job, each checked with a message that
    names it:

    - the reference's process Env is plaintext (an encrypted Env makes
      `ingest_packed` refuse and the jobs skip the native shell);
    - the reference's native engine loads. Its build-once probe caches a
      failure, and its build function writes the library in place under a
      thread lock only, so a test worker can load a library another
      worker is still writing. Under an `fcntl` lock shared by every
      worker, a cached failure is dropped, the library is rebuilt to a
      temporary name and moved into place, and the probe asked again."""
    from yugabyte_tpu.storage import native_engine as ref_ne
    from yugabyte_tpu.utils import native_build as ref_nb
    env = ref_env.get_env()
    assert not env.encrypted, (
        "precondition failed: the reference's process Env is encrypted "
        f"({type(env).__name__}); a test left encryption on")
    if ref_ne._available:
        return
    os.makedirs(ref_nb.BUILD_DIR, exist_ok=True)
    fd = os.open(os.path.join(ref_nb.BUILD_DIR, ".twin_probe.lock"),
                 os.O_CREAT | os.O_RDWR, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        with ref_ne._lib_lock:
            ref_ne._lib = None
        ref_ne._available = None
        if ref_ne.available():
            return
        lib = os.path.join(ref_nb.BUILD_DIR, "libcompaction_engine.so")
        tmp = f"{lib}.tmp{os.getpid()}"
        subprocess.run(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                        "-o", tmp,
                        os.path.join(ref_nb.NATIVE_DIR,
                                     "compaction_engine.cc"),
                        "-lz", "-lpthread"], check=True)
        os.replace(tmp, lib)
        ref_ne._available = None
        assert ref_ne.available(), (
            "precondition failed: the reference's native engine does not "
            f"load from {lib}")
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


# --------------------------------------------------------- both packages
def package(root: str) -> SimpleNamespace:
    """The modules a twin drives, of one package."""
    def m(name):
        return importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        name=root, env=m("utils.env"), db=m("storage.db"),
        ht=m("common.hybrid_time"), doc_key=m("docdb.doc_key"),
        value=m("docdb.value"), status=m("utils.status"),
        compaction=m("storage.compaction"), sst=m("storage.sst"),
        log=m("consensus.log"), dc=m("storage.device_cache"),
        flags=m("utils.flags"))


REF = package("yugabyte_tpu")
PORT = package("yugabyte_tpu_torch")
BOTH = (REF, PORT)


def db_options(P, variant: str, **kw):
    """The DB options of one twin variant: "free" (the JAX DB with no
    device, the port's "native" DB) or "cpu" (each package's CPU device
    and device cache)."""
    if variant == "free":
        dev = None if P is REF else "native"
        return P.db.DBOptions(device=dev, auto_compact=False, **kw)
    if P is REF:
        d = jax.devices("cpu")[0]
        return P.db.DBOptions(device=d, device_cache=P.dc.DeviceSlabCache(
            device=d), auto_compact=False, **kw)
    return P.db.DBOptions(device="cpu", device_cache=P.dc.DeviceSlabCache(
        "cpu"), auto_compact=False, **kw)


def dir_bytes(path, plain_env=None):
    """{file name: bytes} of every SST file and the MANIFEST under `path`
    (read through `plain_env` when given: the plaintext of encrypted
    files)."""
    out = {}
    for name in sorted(os.listdir(path)):
        if ".sst" not in name and name != "MANIFEST":
            continue
        p = os.path.join(path, name)
        out[name] = (plain_env.read_file(p) if plain_env is not None
                     else open(p, "rb").read())
    return out


@contextlib.contextmanager
def envs(make):
    """Install make(P) as the process Env of each package; restore."""
    old = {P.name: P.env.get_env() for P in BOTH}
    made = {}
    try:
        for P in BOTH:
            made[P.name] = make(P)
            P.env.set_env(made[P.name])
        yield made
    finally:
        for P in BOTH:
            P.env.set_env(old[P.name])


def universe_keys(P, key_id="uk-twin", key=b"\x5a" * 32):
    keys = P.env.UniverseKeys()
    keys.add(key_id, key)
    return keys


@contextlib.contextmanager
def encrypted_both(key=b"\x5a" * 32):
    """Both packages' process Envs encrypted with the same universe key."""
    with envs(lambda P: P.env.EncryptedEnv(universe_keys(P, key=key))) as e:
        yield e


def _key(P, i):
    return P.doc_key.SubDocKey(
        P.doc_key.DocKey(range_components=(f"r{i:04d}",)),
        (("col", 0),)).encode(include_ht=False)


def _items(P, lo, hi):
    return [(_key(P, i), P.ht.DocHybridTime(P.ht.HybridTime((i + 1) << 12), 0),
             P.value.Value(primitive=f"v{i}").encode())
            for i in range(lo, hi)]


def _got(r):
    return None if r is None else (r[0].ht.value, r[0].write_id, r[1])


# ------------------------------------------------ test_encryption.py twins
@needs_crypto
def test_env_roundtrip_and_random_access(tmp_path):
    data = bytes(range(256)) * 100
    with encrypted_both() as e:
        for P in BOTH:
            env = e[P.name]
            p = str(tmp_path / f"f_{P.name}")
            env.write_file(p, data)
            raw = open(p, "rb").read()
            assert raw[:8] == b"YBENCv1\x00" and data[:64] not in raw
            # each package reads its own file and the other's
            for Q in BOTH:
                assert e[Q.name].read_file(p) == data
                r = e[Q.name].open_random(p)
                for off, size in ((0, 10), (17, 33), (4000, 256),
                                  (25599, 1)):
                    assert r.pread(size, off) == data[off: off + size]
                assert r.size() == len(data)
                r.close()


@needs_crypto
def test_env_append_reopen_continues_stream(tmp_path):
    with encrypted_both() as e:
        for P, Q in ((REF, PORT), (PORT, REF)):
            p = str(tmp_path / f"wal_{P.name}")
            a = e[P.name].open_append(p)
            a.append(b"hello ")
            a.flush()
            a.close()
            a = e[Q.name].open_append(p)   # the other package continues
            assert a.offset == 6
            a.append(b"world")
            a.flush()
            a.close()
            assert e[P.name].read_file(p) == e[Q.name].read_file(p) \
                == b"hello world"


@needs_crypto
def test_env_legacy_plaintext_fallback(tmp_path):
    p = str(tmp_path / "legacy")
    with open(p, "wb") as f:
        f.write(b"plain old bytes")
    with encrypted_both() as e:
        for P in BOTH:
            assert e[P.name].read_file(p) == b"plain old bytes"
            r = e[P.name].open_random(p)
            assert r.pread(5, 6) == b"old b"
            r.close()


@needs_crypto
def test_env_torn_header_fails_closed(tmp_path):
    with encrypted_both() as e:
        for P in BOTH:
            env = e[P.name]
            p = str(tmp_path / f"full_{P.name}")
            env.write_file(p, b"x" * 500)
            raw = open(p, "rb").read()
            hlen = 8 + 2 + len("uk-twin") + 16 + 32
            for cut in (9, 10, 15, hlen - 1):
                torn = str(tmp_path / f"torn{cut}_{P.name}")
                with open(torn, "wb") as f:
                    f.write(raw[:cut])
                for Q in BOTH:
                    for op in (e[Q.name].read_file, e[Q.name].open_random,
                               e[Q.name].open_append):
                        with pytest.raises(ValueError):
                            op(torn)


@needs_crypto
def test_env_truncated_header_leaves_no_fd_leak(tmp_path):
    import resource
    soft, _hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    with encrypted_both() as e:
        for P in BOTH:
            p = str(tmp_path / f"f_{P.name}")
            e[P.name].write_file(p, b"data")
            torn = str(tmp_path / f"torn_{P.name}")
            with open(torn, "wb") as f:
                f.write(open(p, "rb").read()[:20])
            for _ in range(min(soft + 10, 2000)):
                with pytest.raises(ValueError):
                    e[PORT.name].open_random(torn)


@needs_crypto
def test_env_unknown_key_fails_closed(tmp_path):
    with encrypted_both():
        p = str(tmp_path / "f")
        PORT.env.get_env().write_file(p, b"secret")
        REF.env.get_env().write_file(p + "_ref", b"secret")
        for P in BOTH:
            other = P.env.EncryptedEnv(universe_keys(P, key_id="uk-b"))
            for path in (p, p + "_ref"):
                with pytest.raises(KeyError):
                    other.read_file(path)


@needs_crypto
@pytest.mark.parametrize("variant", ["free", "cpu"])
def test_encrypted_db_write_flush_compact_read(tmp_path, variant):
    marker = b"SUPERSECRETVALUE"
    answers = {}
    with encrypted_both() as e:
        for P in BOTH:
            d = str(tmp_path / P.name)
            db = P.db.DB(d, db_options(P, variant))
            for i in range(40):
                db.write_batch([(_key(P, i), P.ht.DocHybridTime(
                    P.ht.HybridTime((i + 1) << 12), 0),
                    P.value.Value(primitive=marker.decode()).encode())])
                if i % 13 == 12:
                    db.flush()
            db.flush()
            db.compact_all()
            for name in os.listdir(d):
                if ".sst" in name:
                    raw = open(os.path.join(d, name), "rb").read()
                    assert raw[:8] == b"YBENCv1\x00", name
                    assert marker not in raw, name
            answers[P.name] = [_got(db.get(_key(P, i))) for i in range(42)]
            db.close()
        assert answers[REF.name] == answers[PORT.name]
        assert answers[PORT.name][5] is not None
        ref_files = dir_bytes(str(tmp_path / REF.name), e[PORT.name])
        port_files = dir_bytes(str(tmp_path / PORT.name), e[PORT.name])
        assert ref_files == port_files and len(ref_files) >= 3
        # each package reopens the other's encrypted DB
        for P, Q in ((REF, PORT), (PORT, REF)):
            db = P.db.DB(str(tmp_path / Q.name), db_options(P, variant))
            assert [_got(db.get(_key(P, i))) for i in range(42)] \
                == answers[PORT.name]
            db.close()


# ------------------------------------------- test_fault_injection.py twins
@pytest.fixture()
def fenvs():
    """A FaultInjectionEnv over a plaintext Env in each package."""
    with envs(lambda P: P.env.FaultInjectionEnv(P.env.Env())) as made:
        yield made


def _outcome(fn):
    """What a step did: its value, or the exception's type name."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 - the twin compares outcomes
        return ("raised", type(e).__name__, getattr(e, "errno", None))


def test_fault_pread_and_read_file_faults(fenvs, tmp_path):
    seen = {}
    for P in BOTH:
        fe = fenvs[P.name]
        p = str(tmp_path / f"f_{P.name}")
        fe.write_file(p, b"payload-bytes")
        steps = []
        fe.set_fault("read", count=1)
        steps.append(_outcome(lambda: fe.read_file(p)))
        steps.append(_outcome(lambda: fe.read_file(p)))
        fe.set_fault("read", path_filter="other")
        r = fe.open_random(p)
        steps.append(_outcome(lambda: r.pread(7, 0)))
        fe.set_fault("read", path_filter="f")
        steps.append(_outcome(lambda: r.pread(7, 0)))
        r.close()
        seen[P.name] = (steps, fe.faults_injected)
    assert seen[REF.name] == seen[PORT.name]
    assert seen[PORT.name][0][0][1] == "FaultError"
    assert seen[PORT.name][0][1] == ("ok", b"payload-bytes")


def test_fault_enospc_and_short_append(fenvs, tmp_path):
    import errno
    seen = {}
    for P in BOTH:
        fe = fenvs[P.name]
        p = str(tmp_path / f"a_{P.name}")
        f = fe.open_append(p)
        f.append(b"good")
        fe.set_fault("enospc", count=1)
        steps = [_outcome(lambda: f.append(b"never"))]
        fe.set_fault("append_short", count=1)
        steps.append(_outcome(lambda: f.append(b"12345678")))
        f.flush()
        f.close()
        seen[P.name] = (steps, fe.read_file(p))
    assert seen[REF.name] == seen[PORT.name]
    assert seen[PORT.name] == ([("raised", "FaultError", errno.ENOSPC),
                                ("raised", "FaultError", None)],
                               b"good1234")


def test_fault_dropped_fsync_crash_loses_exactly_unsynced_tail(
        fenvs, tmp_path):
    seen = {}
    for P in BOTH:
        fe = fenvs[P.name]
        p = str(tmp_path / f"wal-000001_{P.name}")
        f = fe.open_append(p)
        f.append(b"SYNCED")
        f.flush(fsync=True)
        fe.set_drop_fsyncs(True)
        f.append(b"-UNSYNCED")
        f.flush(fsync=True)
        f.close()
        before = fe.read_file(p)
        affected = [os.path.basename(a) for a in fe.simulate_crash()]
        seen[P.name] = (before, open(p, "rb").read(),
                        [a.split("_")[0] for a in affected])
    assert seen[REF.name] == seen[PORT.name] == (
        b"SYNCED-UNSYNCED", b"SYNCED", ["wal-000001"])


def test_fault_crash_removes_never_synced_files(fenvs, tmp_path):
    seen = {}
    for P in BOTH:
        fe = fenvs[P.name]
        fe.set_drop_fsyncs(True)
        p1 = str(tmp_path / f"new-append_{P.name}")
        f = fe.open_append(p1)
        f.append(b"x" * 100)
        f.flush(fsync=True)
        f.close()
        p2 = str(tmp_path / f"whole_{P.name}")
        fe.write_file(p2, b"whole-file")
        fe.simulate_crash()
        seen[P.name] = (os.path.exists(p1), os.path.exists(p2))
    assert seen[REF.name] == seen[PORT.name] == (False, False)


def test_fault_whole_file_overwrite_reverts_to_synced_content(
        fenvs, tmp_path):
    seen = {}
    for P in BOTH:
        fe = fenvs[P.name]
        p = str(tmp_path / f"base_{P.name}.sst")
        fe.write_file(p, b"generation-1")
        fe.set_drop_fsyncs(True)
        fe.write_file(p, b"generation-2-unsynced")
        fe.simulate_crash()
        seen[P.name] = open(p, "rb").read()
    assert seen[REF.name] == seen[PORT.name] == b"generation-1"


@needs_crypto
def test_fault_stacks_over_encrypted_env(tmp_path):
    made = {P.name: P.env.FaultInjectionEnv(P.env.EncryptedEnv(
        universe_keys(P))) for P in BOTH}
    for P in BOTH:
        fi = made[P.name]
        assert fi.encrypted
        p = str(tmp_path / f"enc_{P.name}")
        fi.write_file(p, b"secret-data")
        assert open(p, "rb").read()[:8] == b"YBENCv1\x00"
    for P in BOTH:
        for Q in BOTH:
            assert made[Q.name].read_file(
                str(tmp_path / f"enc_{P.name}")) == b"secret-data"
    for P in BOTH:
        fi = made[P.name]
        fi.set_fault("read")
        assert _outcome(lambda: fi.read_file(
            str(tmp_path / f"enc_{P.name}")))[:2] == ("raised", "FaultError")
    assert made[REF.name].faults_injected == made[PORT.name].faults_injected


@pytest.mark.parametrize("variant", ["free", "cpu"])
def test_fault_no_faults_passthrough_sst_byte_identical(fenvs, tmp_path,
                                                        variant):
    """An un-armed FaultInjectionEnv adds no byte drift, in either
    package, and the two packages' flushes are byte-identical."""
    files = {}
    for via in ("fault", "plain"):
        for P in BOTH:
            if via == "plain":
                P.env.set_env(P.env.Env())
            d = str(tmp_path / f"{via}_{P.name}")
            db = P.db.DB(d, db_options(P, variant))
            db.write_batch(_items(P, 0, 50))
            db.flush()
            db.close()
            files[(via, P.name)] = dir_bytes(d)
    first = files[("fault", PORT.name)]
    assert first and all(f == first for f in files.values())


# --------------------------------------------------- DB background error
@pytest.mark.parametrize("variant", ["free", "cpu"])
def test_flush_error_parks_db_readonly_then_recovers(fenvs, tmp_path,
                                                     variant):
    seen = {}
    for P in BOTH:
        fe = fenvs[P.name]
        d = str(tmp_path / P.name)
        db = P.db.DB(d, db_options(P, variant))
        db.write_batch(_items(P, 0, 30))
        db.flush()
        steps = [db.n_live_files]
        db.write_batch(_items(P, 30, 60))
        fe.set_fault("enospc", path_filter=".sst")
        steps.append(db.flush())
        steps.append(db.background_error is not None)
        steps.append((db.n_live_files, len([n for n in os.listdir(d)
                                            if ".sst" in n])))
        steps.append([_got(db.get(_key(P, i))) for i in (45, 10)])
        try:
            db.write_batch(_items(P, 60, 61))
            steps.append("accepted")
        except P.status.StatusError as e:
            steps.append(e.status.code.name)
        steps.append(db.flush())
        steps.append(db.retry_background_work())
        steps.append(db.background_error is not None)
        fe.clear_faults()
        steps.append(db.retry_background_work())
        steps.append((db.background_error, db.n_live_files))
        db.write_batch(_items(P, 60, 70))
        steps.append(_got(db.get(_key(P, 65))))
        db.close()
        db2 = P.db.DB(d, db_options(P, variant))
        steps.append([_got(db2.get(_key(P, i))) for i in (0, 29, 30, 59)])
        db2.close()
        seen[P.name] = steps
    assert seen[REF.name] == seen[PORT.name]
    assert seen[PORT.name][3] == (1, 2)
    assert seen[PORT.name][5] == "SERVICE_UNAVAILABLE"
    assert seen[PORT.name][9:11] == [True, (None, 2)]
    assert dir_bytes(str(tmp_path / REF.name)) == \
        dir_bytes(str(tmp_path / PORT.name))


@pytest.mark.parametrize("variant", ["free", "cpu"])
def test_compaction_error_keeps_inputs_live_then_recovers(fenvs, tmp_path,
                                                          variant):
    seen = {}
    for P in BOTH:
        if P is REF:
            require_reference_native()
        fe = fenvs[P.name]
        d = str(tmp_path / P.name)
        db = P.db.DB(d, db_options(P, variant))
        for lo in range(0, 120, 30):
            db.write_batch(_items(P, lo, lo + 30))
            db.flush()
        steps = [db.n_live_files]
        fe.set_fault("enospc", path_filter=".sst")
        db.compact_all()
        steps.append((db.background_error is not None, db.n_live_files))
        steps.append([_got(db.get(_key(P, i))) for i in (0, 45, 119)])
        fe.clear_faults()
        steps.append(db.retry_background_work())
        db.compact_all()
        steps.append(db.n_live_files)
        steps.append([_got(db.get(_key(P, i))) for i in (0, 45, 119)])
        db.close()
        seen[P.name] = steps
    assert seen[REF.name] == seen[PORT.name]
    assert seen[PORT.name][1] == (True, 4) and seen[PORT.name][4] == 1
    assert dir_bytes(str(tmp_path / REF.name)) == \
        dir_bytes(str(tmp_path / PORT.name))


@pytest.mark.parametrize("variant", ["free", "cpu"])
def test_dropped_fsync_crash_rolls_manifest_back_with_sst(fenvs, tmp_path,
                                                          variant):
    seen = {}
    for P in BOTH:
        fe = fenvs[P.name]
        d = str(tmp_path / P.name)
        db = P.db.DB(d, db_options(P, variant))
        db.write_batch(_items(P, 0, 20))
        db.flush()
        fe.set_drop_fsyncs(True)
        db.write_batch(_items(P, 20, 40))
        db.flush()
        steps = [db.n_live_files]
        db.close()
        fe.simulate_crash()
        db2 = P.db.DB(d, db_options(P, variant))
        steps.append(db2.n_live_files)
        steps.append([_got(db2.get(_key(P, i))) for i in range(40)])
        db2.close()
        seen[P.name] = steps
    assert seen[REF.name] == seen[PORT.name]
    assert seen[PORT.name][:2] == [2, 1]
    assert all(g is None for g in seen[PORT.name][2][20:])
    assert dir_bytes(str(tmp_path / REF.name)) == \
        dir_bytes(str(tmp_path / PORT.name))


# ------------------------------------ encrypted compaction, route by route
CUTOFF = (1 << 21) << 12


def _encrypted_inputs(tmp_path, rng, sizes, deep=False):
    """Input SSTs written through the (encrypted) process Env: random
    runs by the port's writer, or the deep-document runs of
    test_torch_compaction by the JAX package's."""
    from tests.test_torch_compaction import (_deep_inputs, _mk_run,
                                             _write_inputs)
    d = tmp_path / "inputs"
    d.mkdir()
    if deep:
        return _deep_inputs(d)
    runs = [_mk_run(rng, n, key_space=4 * max(sizes)) for n in sizes]
    return _write_inputs(str(d), runs)


def encrypted_route_twin(tmp_path, paths, route, cache=False):
    """One compaction route of both packages under the same encrypted Env
    (the caller installs it): the plaintext of every output file equal
    between the packages and to the plaintext native job's, every output
    encrypted, and each package reading the other's outputs to the same
    entries. route: "native", "device" (an explicit device), "none" (the
    Python path on the default device), or "device_native"."""
    from unittest import mock
    ref_dev = jax.devices("cpu")[0]
    outs = {}
    shell = mock.patch.object(native_engine, "NativeCompactionJob",
                              side_effect=AssertionError(
                                  "the C++ shell ran under encryption"))
    for P in BOTH:
        if P is PORT:
            shell.start()
        out = tmp_path / f"out_{route}_{P.name}"
        out.mkdir()
        ids = iter(range(100, 1000))
        readers = [P.sst.SSTReader(p) for p in paths]
        dev = {"native": "native", "none": None,
               "device": ref_dev if P is REF else "cpu",
               "device_native": ref_dev if P is REF else "cpu"}[route]
        kw = {}
        if cache:
            kw = dict(device_cache=(P.dc.DeviceSlabCache(device=ref_dev)
                                    if P is REF
                                    else P.dc.DeviceSlabCache("cpu")),
                      input_ids=list(range(1, len(paths) + 1)))
        if route == "device_native":
            res = P.compaction.run_compaction_job_device_native(
                readers, str(out), lambda: next(ids), CUTOFF, True,
                device=dev, **kw)
        else:
            res = P.compaction.run_compaction_job(
                readers, str(out), lambda: next(ids), CUTOFF, True,
                device=dev, **kw)
        outs[P.name] = (res, str(out))
        for r in readers:
            r.close()
    shell.stop()
    env = PORT.env.get_env()
    plain = {n: dir_bytes(d, env) for n, (_r, d) in outs.items()}
    assert plain[REF.name] == plain[PORT.name] and plain[PORT.name]
    assert outs[REF.name][0].rows_out == outs[PORT.name][0].rows_out
    for _n, (_r, d) in outs.items():
        for name in os.listdir(d):
            if ".sst" in name:
                assert open(os.path.join(d, name), "rb").read(8) == \
                    b"YBENCv1\x00", name
    # the plaintext native job over the decrypted inputs
    clear = tmp_path / f"clear_{route}"
    clear.mkdir()
    for p in paths:
        for q in (p, p + ".sblock.0"):
            with open(clear / os.path.basename(q), "wb") as f:
                f.write(env.read_file(q))
    saved = {P.name: P.env.get_env() for P in BOTH}
    PORT.env.set_env(PORT.env.Env())
    try:
        ids = iter(range(100, 1000))
        (tmp_path / f"native_{route}").mkdir()
        nat = PORT.compaction._run_native_job(
            [PORT.sst.SSTReader(str(clear / os.path.basename(p)))
             for p in paths], str(tmp_path / f"native_{route}"),
            lambda: next(ids), CUTOFF, True, False, None)
        native_files = {os.path.basename(b): open(b, "rb").read()
                        for _f, b, _p in nat.outputs}
    finally:
        PORT.env.set_env(saved[PORT.name])
    assert plain[PORT.name] == dir_bytes(str(tmp_path / f"native_{route}"))
    # each package reads the other's encrypted outputs
    for P, Q in ((REF, PORT), (PORT, REF)):
        a = [P.sst.SSTReader(b).read_all() for _f, b, _p in
             outs[Q.name][0].outputs]
        b = [Q.sst.SSTReader(b).read_all() for _f, b, _p in
             outs[Q.name][0].outputs]
        for x, y in zip(a, b):
            assert x.n == y.n and np.array_equal(x.ht_lo, y.ht_lo)
            assert [x.key_bytes(i) for i in range(x.n)] == \
                [y.key_bytes(i) for i in range(y.n)]
    return outs[PORT.name][0]


@needs_crypto
@pytest.mark.parametrize("route", ["native", "device", "none",
                                   "device_native"])
@pytest.mark.parametrize("layout", ["even", "skewed", "deep"])
def test_encrypted_compaction_route(tmp_path, route, layout, monkeypatch):
    """Every route of the router under encryption at rest: the C++ shell
    is skipped, the Python path runs through the Env (A + B, G + I.1 + B
    for a skewed pick, the native merge for deep documents), and the
    plaintext equals the JAX package's and the native job's."""
    from yugabyte_tpu_torch.utils import torch_setup
    real = torch_setup.resolve_device
    monkeypatch.setattr(torch_setup, "resolve_device",
                        lambda device=None: real("cpu" if device is None
                                                 else device))
    rng = np.random.default_rng({"even": 1, "skewed": 2, "deep": 3}[layout])
    sizes = {"even": (700, 700, 700), "skewed": (2000, 40, 40, 40),
             "deep": ()}[layout]
    with encrypted_both():
        paths = _encrypted_inputs(tmp_path, rng, sizes,
                                  deep=layout == "deep")
        res = encrypted_route_twin(tmp_path, paths, route,
                                   cache=route == "device_native")
    assert res.rows_in == (sum(sizes) if sizes else res.rows_in) > 0


@needs_crypto
def test_encrypted_ingest_and_flush_refuse_native(tmp_path):
    """Under encryption ingest_packed refuses in both packages (the
    native encoder writes raw files), and flush takes SSTWriter through
    the Env: the two packages' flushes have the same plaintext."""
    with encrypted_both() as e:
        for P in BOTH:
            db = P.db.DB(str(tmp_path / P.name), db_options(P, "cpu"))
            db.write_batch(_items(P, 0, 80))
            db.flush()
            keys = b"".join(_key(P, i) for i in range(3))
            offs = np.arange(4, dtype=np.int64) * len(_key(P, 0))
            with pytest.raises(RuntimeError, match="native engine"):
                db.ingest_packed(keys, offs, np.ones(3, np.uint64),
                                 np.zeros(3, np.uint32), b"abc",
                                 np.arange(4, dtype=np.int64))
            db.close()
        assert dir_bytes(str(tmp_path / REF.name), e[PORT.name]) == \
            dir_bytes(str(tmp_path / PORT.name), e[PORT.name])


# ------------------------------------------------------ atomic port builds
def test_port_builds_are_atomic(tmp_path, monkeypatch):
    """A port build holds the build directory's fcntl lock, compiles to a
    temporary name and os.replaces it into place; a second build of a
    fresh library compiles nothing; a failed compile leaves no file."""
    import subprocess as sp
    from yugabyte_tpu_torch.utils import native_build as nb
    monkeypatch.setattr(nb, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(nb, "LOCK_PATH", str(tmp_path / ".build.lock"))
    seen = []
    real_run, real_replace = sp.run, os.replace

    def run(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        # the lock is held: another process cannot take it now
        probe = os.open(nb.LOCK_PATH, os.O_RDWR)
        try:
            with pytest.raises(BlockingIOError):
                fcntl.flock(probe, fcntl.LOCK_EX | fcntl.LOCK_NB)
        finally:
            os.close(probe)
        seen.append(("compile", os.path.basename(out)))
        return real_run(cmd, **kw)

    def replace(a, b):
        seen.append(("replace", os.path.basename(a), os.path.basename(b)))
        return real_replace(a, b)

    monkeypatch.setattr(nb.subprocess, "run", run)
    monkeypatch.setattr(nb.os, "replace", replace)
    lib = nb.build_native_lib("memtable_arena.cc", "libmemtable_arena.so")
    tmp = f"libmemtable_arena.so.tmp{os.getpid()}"
    assert seen == [("compile", tmp),
                    ("replace", tmp, "libmemtable_arena.so")]
    assert sorted(os.listdir(tmp_path)) == [".build.lock",
                                            "libmemtable_arena.so"]
    assert nb.build_native_lib("memtable_arena.cc",
                               "libmemtable_arena.so") == lib
    assert len(seen) == 2          # fresh: nothing compiled again
    with pytest.raises(sp.CalledProcessError):
        nb.build_native_lib("memtable_arena.cc", "libbroken.so",
                            extra_args=("-lno_such_library_here",))
    assert sorted(os.listdir(tmp_path)) == [".build.lock",
                                            "libmemtable_arena.so"]
