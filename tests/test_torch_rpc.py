"""The port's RPC layer against the JAX package's, on the CPU.

- The codec: `dumps` gives the same bytes in both packages for values of
  every type it carries (hypothesis over None, bools, arbitrary ints,
  floats, bytes, str, lists, dicts), each package `loads` the other's
  bytes, sidecars included (`dumps_with_sidecars` payloads and segments
  equal, `loads_with_sidecars` across); the frames `_send_message` writes
  (plain, zlib-compressed, with sidecar segments) are equal byte for
  byte and each package reads the other's.
- Twins of tests/test_rpc.py's messenger cases on the port's Messenger,
  the calls that cross the wire also between a port and a JAX messenger
  in both directions (a port Messenger serving a JAX Proxy and the other
  way round); TLS where `openssl` is present, as the reference's are.
- `test_raft_over_rpc` on the port, and one mixed group over the wire:
  two port RaftConsensus peers and one JAX peer, each over its own
  package's RpcTransport and Messenger, replicate 20 writes that all
  three apply in the same order.

What waits: tests/test_rpc.py::TestTLS::test_tls_cluster_end_to_end
needs the port's MiniCluster (ROADMAP queue A item 7g). The twin of
TestSidecars::test_remote_bootstrap_chunks_use_segment_path is in
tests/test_torch_tablet_server.py. Every wait has its own deadline.
Tolerance: exact.
"""

import importlib
import shutil
import subprocess
import threading
import time

import jax  # noqa: F401 (the conftest pins JAX to the CPU)
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from yugabyte_tpu import rpc as ref_rpc  # noqa: F401 (registers its flags)
from yugabyte_tpu.rpc import codec as ref_codec
from yugabyte_tpu.rpc import messenger as ref_m
from yugabyte_tpu.utils import flags as ref_flags
from yugabyte_tpu.utils import status as ref_status
from yugabyte_tpu_torch.rpc import codec
from yugabyte_tpu_torch.rpc import messenger as M
from yugabyte_tpu_torch.rpc.codec import dumps, loads
from yugabyte_tpu_torch.rpc.messenger import (
    Messenger, Proxy, RemoteError, RpcTimeout, ServiceUnavailable)
from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils.status import Code, Status, StatusError

MESSENGERS = {"port": M, "ref": ref_m}
FLAGS = (flags, ref_flags)

# ------------------------------------------------------------------- codec
scalars = (st.none() | st.booleans() | st.integers()
           | st.integers(min_value=-(2 ** 200), max_value=2 ** 200)
           | st.floats(allow_nan=False) | st.binary(max_size=64)
           | st.text(max_size=32))
keys = st.none() | st.booleans() | st.integers() | st.binary(max_size=16) \
    | st.text(max_size=16)
values = st.recursive(
    scalars, lambda children: st.lists(children, max_size=6)
    | st.dictionaries(keys, children, max_size=6), max_leaves=40)


@settings(max_examples=300, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(values)
def test_codec_dumps_bytes_equal_and_cross_loads(obj):
    """Twin of tests/test_rpc.py::test_codec_roundtrip over the codec's
    types: the same bytes, and each package loads the other's."""
    b = dumps(obj)
    assert b == ref_codec.dumps(obj)
    assert ref_codec.loads(b) == obj == loads(ref_codec.dumps(obj))


@pytest.mark.parametrize("obj", [
    None, True, False, 0, 1, -1, 2**64, -(2**70), 3.5, b"", b"\x00\xff" * 10,
    "", "héllo", [], [1, [2, [3]]], {}, {"a": 1, "b": [b"x", None]},
    {1: "int-key", b"b": "bytes-key"},
    {"nested": {"deep": {"deeper": [1.5, True, b"\x80"]}}},
])
def test_codec_roundtrip(obj):
    """Twin of tests/test_rpc.py::test_codec_roundtrip."""
    assert loads(dumps(obj)) == obj
    assert dumps(obj) == ref_codec.dumps(obj)


def test_codec_tuple_becomes_list():
    """Twin of tests/test_rpc.py::test_codec_tuple_becomes_list."""
    assert loads(dumps((1, 2))) == [1, 2]
    assert dumps((1, 2)) == ref_codec.dumps([1, 2])


def test_codec_rejects_unknown_type():
    """Twin of tests/test_rpc.py::test_codec_rejects_unknown_type."""
    with pytest.raises(TypeError):
        dumps(object())


@settings(max_examples=100, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.recursive(
    st.binary(max_size=300) | scalars,
    lambda c: st.lists(c, max_size=4) | st.dictionaries(keys, c, max_size=4),
    max_leaves=20), st.integers(min_value=1, max_value=256))
def test_codec_sidecars_equal_and_cross_loads(obj, min_bytes):
    """dumps_with_sidecars: the same payload and segments in both
    packages; each package's loads_with_sidecars reads the other's."""
    payload, scs = codec.dumps_with_sidecars(obj, min_bytes)
    rpayload, rscs = ref_codec.dumps_with_sidecars(obj, min_bytes)
    assert payload == rpayload
    assert [bytes(s) for s in scs] == [bytes(s) for s in rscs]
    assert ref_codec.loads_with_sidecars(
        payload, [bytes(s) for s in scs]) == obj
    assert codec.loads_with_sidecars(
        rpayload, [bytes(s) for s in rscs]) == obj


class _Wire:
    """A socket stand-in: records what is sent, replays it on recv."""

    def __init__(self, data=b""):
        self.sent = bytearray()
        self.data, self.off = bytes(data), 0

    def sendall(self, b):
        self.sent += bytes(b)

    def sendmsg(self, bufs):
        n = 0
        for b in bufs:
            self.sent += bytes(b)
            n += len(b)
        return n

    def recv(self, n):
        out = self.data[self.off:self.off + n]
        self.off += len(out)
        return out

    def recv_into(self, view, n):
        out = self.data[self.off:self.off + n]
        view[:len(out)] = out
        self.off += len(out)
        return len(out)


FRAMES = {
    "plain": {"id": 7, "svc": "echo", "mth": "add", "args": {"a": 1}},
    "compressed": {"id": 8, "args": {"x": "the quick brown fox " * 8192}},
    "sidecar": {"id": 9, "args": {"blob": bytes(range(256)) * 4096,
                                  "small": b"s", "more": [b"z" * 70000]}},
    "random": {"id": 10, "args": {"x": bytes(range(256)) * 300}},
}


@pytest.mark.parametrize("sidecars", [True, False])
@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_equal_and_cross_read(name, sidecars):
    """The bytes `_send_message` puts on the socket (the length word, the
    compression and sidecar bits, the segment table) are the JAX
    package's, and each package's `_recv_message` reads the other's."""
    obj = FRAMES[name]
    old = {f: f.get_flag("rpc_sidecar_min_bytes") for f in FLAGS}
    try:
        if not sidecars:
            for f in FLAGS:
                f.set_flag("rpc_sidecar_min_bytes", 0)
        lock = threading.Lock()
        wires = {}
        for tag, mod in MESSENGERS.items():
            wires[tag] = _Wire()
            mod._send_message(wires[tag], lock, obj)
        assert bytes(wires["port"].sent) == bytes(wires["ref"].sent)
        for reader, writer in (("port", "ref"), ("ref", "port")):
            got = MESSENGERS[reader]._recv_message(
                _Wire(wires[writer].sent))
            assert _plain(got) == obj
    finally:
        for f, v in old.items():
            f.set_flag("rpc_sidecar_min_bytes", v)


def _plain(obj):
    """Sidecar segments arrive as bytearrays: bytes again."""
    if isinstance(obj, (bytearray, memoryview)):
        return bytes(obj)
    if isinstance(obj, list):
        return [_plain(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


# --------------------------------------------------------------- messenger
class EchoService:
    def echo(self, x):
        return x

    def add(self, a, b):
        return a + b

    def fail_status(self):
        raise StatusError(Status.NotFound("no such thing"))

    def fail_raise(self):
        raise ValueError("boom")

    def slow(self, delay_s):
        time.sleep(delay_s)
        return "done"


class RefEchoService(EchoService):
    def fail_status(self):
        raise ref_status.StatusError(ref_status.Status.NotFound(
            "no such thing"))


# (server package, client package): the port alone, and across the wire
# both ways
COMBOS = [("port", "port"), ("port", "ref"), ("ref", "port")]


@pytest.fixture(params=COMBOS, ids=["-".join(c) for c in COMBOS])
def pair(request):
    srv, cli = request.param
    server = MESSENGERS[srv].Messenger("server")
    server.register_service("echo", EchoService() if srv == "port"
                            else RefEchoService())
    client = MESSENGERS[cli].Messenger("client")
    yield server, client, MESSENGERS[cli]
    client.shutdown()
    server.shutdown()


@pytest.fixture
def port_pair():
    server = Messenger("server")
    server.register_service("echo", EchoService())
    client = Messenger("client")
    yield server, client
    client.shutdown()
    server.shutdown()


def test_basic_call(pair):
    server, client, _mod = pair
    assert client.call(server.address, "echo", "add", a=2, b=3) == 5
    assert client.call(server.address, "echo", "echo",
                       x={"k": [b"v", 1]}) == {"k": [b"v", 1]}


def test_proxy(pair):
    """A port Messenger serving a JAX Proxy, and the other way round."""
    server, client, mod = pair
    proxy = mod.Proxy(client, server.address, "echo")
    assert proxy.add(a=10, b=20) == 30


def test_local_bypass(port_pair):
    server, _ = port_pair
    assert server.call(server.address, "echo", "add", a=1, b=1) == 2


def test_status_error_crosses_wire(pair):
    server, client, mod = pair
    with pytest.raises(mod.RemoteError) as ei:
        client.call(server.address, "echo", "fail_status")
    assert ei.value.status.code.name == Code.NOT_FOUND.name


def test_exception_maps_to_remote_error(pair):
    server, client, mod = pair
    with pytest.raises(mod.RemoteError) as ei:
        client.call(server.address, "echo", "fail_raise")
    assert ei.value.status.code.name == Code.REMOTE_ERROR.name
    assert "boom" in ei.value.status.message


def test_unknown_service_and_method(pair):
    server, client, mod = pair
    with pytest.raises(mod.RemoteError) as ei:
        client.call(server.address, "nope", "x")
    assert ei.value.status.code.name == Code.SERVICE_UNAVAILABLE.name
    with pytest.raises(mod.RemoteError) as ei:
        client.call(server.address, "echo", "nope")
    assert ei.value.status.code.name == Code.NOT_SUPPORTED.name


def test_timeout_and_connection_survives(port_pair):
    server, client = port_pair
    with pytest.raises(RpcTimeout):
        client.call(server.address, "echo", "slow", timeout_s=0.2, delay_s=5)
    assert client.call(server.address, "echo", "add", a=1, b=2) == 3


def test_unreachable_server():
    client = Messenger("client")
    try:
        with pytest.raises(ServiceUnavailable):
            client.call("127.0.0.1:1", "echo", "echo", x=1)
    finally:
        client.shutdown()


def test_concurrent_calls_multiplex(pair):
    server, client, _mod = pair
    results, errors = [], []

    def worker(i):
        try:
            results.append(client.call(server.address, "echo", "add",
                                       a=i, b=i))
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(32)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not errors
    assert sorted(results) == [2 * i for i in range(32)]


def test_server_shutdown_fails_pending(port_pair):
    server, client = port_pair
    done = threading.Event()
    caught = []

    def worker():
        try:
            client.call(server.address, "echo", "slow", timeout_s=10,
                        delay_s=30)
        except (ServiceUnavailable, RpcTimeout) as e:
            caught.append(e)
        done.set()

    threading.Thread(target=worker, daemon=True).start()
    time.sleep(0.2)
    server.shutdown()
    assert done.wait(timeout=5)
    assert caught


def test_midcall_connection_teardown_fails_calls_immediately(port_pair):
    server, client = port_pair
    results = {}
    started = threading.Event()

    def worker():
        t0 = time.monotonic()
        try:
            started.set()
            client.call(server.address, "echo", "slow", timeout_s=60,
                        delay_s=60)
            results["outcome"] = "returned"
        except ServiceUnavailable:
            results["outcome"] = "unavailable"
        except RpcTimeout:
            results["outcome"] = "timeout"
        results["elapsed"] = time.monotonic() - t0

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    started.wait(timeout=5)
    conn = None
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and conn is None:
        with client._conns_lock:
            for c in client._conns.values():
                with c.lock:
                    if c.pending:
                        conn = c
        time.sleep(0.01)
    assert conn is not None, "call never became in-flight"
    conn.close()
    t.join(timeout=10)
    assert not t.is_alive(), "caller still blocked after teardown"
    assert results["outcome"] == "unavailable"
    assert results["elapsed"] < 10


# ----------------------------------------------------------------- sidecars
class TestSidecars:
    def test_codec_sidecar_roundtrip(self):
        big = b"\x01\x02" * 40_000
        obj = {"small": b"tiny", "big": big,
               "nested": [b"x" * 100_000, {"k": big}], "n": 7}
        payload, scs = codec.dumps_with_sidecars(obj, 64 << 10)
        assert len(scs) == 3 and len(payload) < 200
        assert codec.loads_with_sidecars(payload,
                                         [bytes(s) for s in scs]) == obj

    def test_codec_below_threshold_inline(self):
        payload, scs = codec.dumps_with_sidecars({"v": b"x" * 100}, 64 << 10)
        assert scs == []
        assert loads(payload) == {"v": b"x" * 100}

    def test_big_payload_rides_segments(self, pair):
        server, client, mod = pair
        blob = bytes(range(256)) * 4096  # 1 MB
        before = mod.sidecar_frames_sent
        assert client.call(server.address, "echo", "echo", x=blob) == blob
        # the client's request rode a segment (the reply: the server's)
        assert mod.sidecar_frames_sent >= before + 1


# ---------------------------------------------------------------------- TLS
@pytest.mark.skipif(shutil.which("openssl") is None,
                    reason="openssl is not installed")
class TestTLS:
    @pytest.fixture()
    def tls_flags(self, tmp_path):
        """Self-signed cert acting as its own CA; mutual TLS both ways, in
        both packages' flags."""
        cert = str(tmp_path / "node.crt")
        key = str(tmp_path / "node.key")
        base = ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
                "-keyout", key, "-out", cert, "-days", "1",
                "-subj", "/CN=ybtpu-test"]
        subprocess.run(base, check=True, capture_output=True)
        ok = subprocess.run(["openssl", "verify", "-CAfile", cert, cert],
                            capture_output=True)
        if ok.returncode != 0:
            subprocess.run(
                base + ["-addext", "basicConstraints=critical,CA:TRUE"],
                check=True, capture_output=True)
        names = ("rpc_use_tls", "rpc_tls_cert_file", "rpc_tls_key_file",
                 "rpc_tls_ca_file")
        olds = {(f, n): f.get_flag(n) for f in FLAGS for n in names}
        for f in FLAGS:
            f.set_flag("rpc_use_tls", True)
            f.set_flag("rpc_tls_cert_file", cert)
            f.set_flag("rpc_tls_key_file", key)
            f.set_flag("rpc_tls_ca_file", cert)
        yield
        for (f, n), v in olds.items():
            f.set_flag(n, v)

    @pytest.mark.parametrize("combo", COMBOS, ids=["-".join(c)
                                                   for c in COMBOS])
    def test_mutual_tls_rpc(self, tls_flags, combo):
        a = MESSENGERS[combo[1]].Messenger("tls-a")
        b = MESSENGERS[combo[0]].Messenger("tls-b")
        try:
            class Svc:
                def echo(self, x):
                    return {"got": x}
            b.register_service("s", Svc())
            assert a.call(b.address, "s", "echo", x=41) == {"got": 41}
            for i in range(5):
                assert a.call(b.address, "s", "echo", x=i)["got"] == i
        finally:
            a.shutdown()
            b.shutdown()

    def test_plaintext_client_rejected(self, tls_flags):
        import socket as pysock
        import struct as pystruct
        b = Messenger("tls-only")
        try:
            class Svc:
                def echo(self, x):
                    return {"got": x}
            b.register_service("s", Svc())
            raw = pysock.create_connection((b.host, b.port), timeout=5)
            try:
                payload = b'{"id":1,"svc":"s","mth":"echo","args":{"x":1}}'
                raw.sendall(pystruct.pack("<I", len(payload)) + payload)
                raw.settimeout(2)
                with pytest.raises((ConnectionError, OSError)):
                    data = raw.recv(4)
                    if not data:
                        raise ConnectionError("closed")
            finally:
                raw.close()
        finally:
            b.shutdown()

    def test_tls_concurrent_calls_one_connection(self, tls_flags):
        a = Messenger("tls-cc-a")
        b = Messenger("tls-cc-b")
        try:
            class Svc:
                def echo(self, x):
                    time.sleep(0.002)
                    return {"got": x}
            b.register_service("s", Svc())
            errors = []

            def worker(base):
                try:
                    for i in range(25):
                        r = a.call(b.address, "s", "echo", x=base + i)
                        assert r["got"] == base + i
                except Exception as e:  # noqa: BLE001
                    errors.append(e)
            threads = [threading.Thread(target=worker, args=(k * 1000,))
                       for k in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not errors, errors
        finally:
            a.shutdown()
            b.shutdown()

    def test_tls_shutdown_closes_inbound(self, tls_flags):
        a = Messenger("tls-sd-a")
        b = Messenger("tls-sd-b")

        class Svc:
            def echo(self, x):
                return {"got": x}
        b.register_service("s", Svc())
        assert a.call(b.address, "s", "echo", x=1)["got"] == 1
        assert b._inbound
        b.shutdown()
        with pytest.raises(Exception):
            a.call(b.address, "s", "echo", x=2, timeout_s=3.0)
        a.shutdown()


# --------------------------------------------------------------- Raft on RPC
def _raft_group(tmp_path, packages):
    """One RaftConsensus per (peer, package), each over its own package's
    RpcTransport and Messenger."""
    peers = [p for p, _root in packages]
    messengers, nodes = {}, {}
    applied = {p: [] for p in peers}
    for p, root in packages:
        messengers[p] = importlib.import_module(
            f"{root}.rpc.messenger").Messenger(p)
    addr_map = {f"{p}/t1": messengers[p].address for p in peers}
    for p, root in packages:
        log = importlib.import_module(f"{root}.consensus.log")
        raft = importlib.import_module(f"{root}.consensus.raft")
        cs = importlib.import_module(f"{root}.rpc.consensus_service")
        transport = cs.RpcTransport(messengers[p], addr_map.get)
        d = tmp_path / p
        d.mkdir()
        cfg = raft.RaftConfig(peer_id=f"{p}/t1",
                              peer_ids=tuple(f"{q}/t1" for q in peers))
        node = raft.RaftConsensus(
            cfg, log.Log(str(d / "wal")), transport,
            apply_cb=lambda m, p=p: applied[p].append(m.payload),
            meta_path=str(d / "meta.json"))
        transport.register(cfg.peer_id, node)
        nodes[p] = (node, raft)
    return messengers, nodes, applied


def _replicate_20(messengers, nodes, applied, leader):
    peers = list(nodes)
    try:
        for node, _raft in nodes.values():
            node.start(election_timer=False)
        node, raft = nodes[leader]
        node.start_election(ignore_lease=True)
        deadline = time.monotonic() + 10
        while not node.is_leader():
            assert time.monotonic() < deadline, "leader election stalled"
            time.sleep(0.01)
        for i in range(20):
            node.replicate(raft.OP_WRITE, i + 1, b"payload-%d" % i,
                           timeout_s=10)
        deadline = time.monotonic() + 10
        while any(len(applied[p]) < 20 for p in peers):
            assert time.monotonic() < deadline, \
                f"replication stalled: { {p: len(applied[p]) for p in peers} }"
            time.sleep(0.01)
        for p in peers:
            assert applied[p] == [b"payload-%d" % i for i in range(20)]
    finally:
        for node, _raft in nodes.values():
            node.shutdown()
            node.log.close()
        for m in messengers.values():
            m.shutdown()


def test_raft_over_rpc(tmp_path):
    """Twin of tests/test_rpc.py::test_raft_over_rpc on the port."""
    _replicate_20(*_raft_group(tmp_path, [(p, "yugabyte_tpu_torch")
                                          for p in ("a", "b", "c")]),
                  leader="a")


@pytest.mark.parametrize("leader", ["a", "c"])
def test_mixed_group_over_the_wire(tmp_path, leader):
    """Two port peers (a, b) and one JAX peer (c) over RpcTransport: the
    group elects `leader` and replicates 20 writes that all three apply
    in the same order (the port's and the JAX package's consensus
    messages are one wire format)."""
    _replicate_20(*_raft_group(tmp_path, [("a", "yugabyte_tpu_torch"),
                                          ("b", "yugabyte_tpu_torch"),
                                          ("c", "yugabyte_tpu")]),
                  leader=leader)
