"""Messenger: socket server + multiplexed client connections + dispatch.

Counterpart of yugabyte_tpu/rpc/messenger.py, with the imports renamed;
its frames are the JAX package's byte for byte.

Capability parity with the reference RPC stack (ref: src/yb/rpc/messenger.h
`Messenger`, proxy.h `Proxy`, service_if.h `ServiceIf`/`ServicePool`,
binary_call_parser.cc framing, rpc/local_call.h local bypass, deadline
propagation on every call). Differences are deliberate design:

- Threaded accept/reader threads instead of libev reactors: this layer only
  carries control-plane traffic (consensus, heartbeats, DDL, cross-process
  reads/writes); bulk data between devices rides the device mesh.
- One TCP connection per (client, remote) pair with call-id multiplexing —
  many outstanding calls share the socket, responses demux by call id,
  exactly like the reference's OutboundCall tracking.
- Local bypass: calls addressed to a service registered on THIS messenger
  dispatch in-process without touching a socket or the codec
  (ref rpc/local_call.h).

Wire format per frame: [u32 LE length][codec payload]. Request payload:
{id, svc, mth, args, deadline_s}; response: {id, code, err, ret, extra}.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from yugabyte_tpu_torch.rpc.codec import (LAT_HEADER_KEY, TRACE_HEADER_KEY, dumps,
                                    lat_op_from_wire, lat_to_wire, loads,
                                    trace_from_wire, trace_to_wire)
from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils import latency as _latency
from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY, MetricRegistry
from yugabyte_tpu_torch.utils.status import Code, Status, StatusError
from yugabyte_tpu_torch.utils.trace import TRACE, Trace, current_trace_context

flags.define_flag("rpc_use_tls", False,
                  "mutual TLS on every RPC connection (ref "
                  "use_node_to_node_encryption; rpc/secure_stream.cc)")
flags.define_flag("rpc_tls_cert_file", "",
                  "PEM certificate presented by both sides")
flags.define_flag("rpc_tls_key_file", "",
                  "PEM private key for rpc_tls_cert_file")
flags.define_flag("rpc_tls_ca_file", "",
                  "PEM trust anchor peers are verified against")
flags.define_flag("rpc_service_pool_threads", 64,
                  "service-pool workers per messenger (ref "
                  "rpc/service_pool.cc); bounded to cap runaway "
                  "concurrency, large enough that blocking handlers "
                  "(consensus waits, scans) do not starve the pool")
flags.define_flag("rpc_service_queue_depth", 512,
                  "max inbound calls queued behind the service pool (ref "
                  "svc_queue_length / ServicePool::QueueInboundCall); "
                  "overflow is rejected with a retryable Overloaded error "
                  "carrying a measured retry_after_ms hint; 0 = unbounded")
flags.define_flag("rpc_default_timeout_s", 15.0,
                  "default outbound call deadline")
flags.define_flag("rpc_compression_min_bytes", 32 << 10,
                  "zlib-compress RPC frames at or above this size "
                  "(remote bootstrap, CDC, big scan pages; ref "
                  "rpc/compressed_stream.cc); 0 disables")
flags.define_flag("rpc_connect_timeout_s", 5.0,
                  "TCP connect timeout for outbound connections")
flags.define_flag("rpc_sidecar_min_bytes", 64 << 10,
                  "bytes values at or above this size travel as zero-copy "
                  "sidecar segments outside the tagged payload (remote "
                  "bootstrap chunks, CDC batches, big scan pages; ref "
                  "rpc/rpc_context.h sidecars); 0 disables")

_LEN = struct.Struct("<I")


class RpcTimeout(StatusError):
    def __init__(self, msg: str):
        super().__init__(Status(Code.TIMED_OUT, msg))


class ServiceUnavailable(StatusError):
    """Connection refused / reset / remote shut down."""

    def __init__(self, msg: str):
        super().__init__(Status(Code.SERVICE_UNAVAILABLE, msg))


class RemoteError(StatusError):
    """The remote handler raised; carries its status code and any extra
    context (e.g. a NotLeader leader hint)."""

    def __init__(self, status: Status, extra: Optional[dict] = None):
        super().__init__(status)
        self.extra = extra or {}


class Overloaded(StatusError):
    """Typed retryable shedding rejection (ref: the reference's
    ServiceUnavailable queue-overflow + memory-pressure rejections,
    rpc/service_pool.cc Overflow / tablet_service.cc write throttling).

    Raised server-side by the bounded RPC queue and the write-admission
    state machine; crosses the wire as Code.BUSY with
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


def is_overloaded_error(exc: Exception) -> bool:
    """True for any typed overload rejection — local Overloaded, a
    RemoteError carrying the overloaded extra, or a client retry-budget
    denial (which reuses the same extra shape)."""
    return bool(getattr(exc, "extra", None)
                and exc.extra.get("overloaded"))


def _tls_contexts():
    """(server_ctx, client_ctx) per the TLS flags, or (None, None).

    Mutual TLS: both sides present rpc_tls_cert_file and verify the peer
    against rpc_tls_ca_file (the reference's node-to-node encryption,
    secure_stream.cc). Hostname checks are off — cluster membership is
    carried by possession of a CA-signed cert, not by names (nodes move)."""
    if not flags.get_flag("rpc_use_tls"):
        return None, None
    import ssl
    cert = flags.get_flag("rpc_tls_cert_file")
    key = flags.get_flag("rpc_tls_key_file")
    ca = flags.get_flag("rpc_tls_ca_file")
    server = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    server.load_cert_chain(cert, key)
    server.load_verify_locations(ca)
    server.verify_mode = ssl.CERT_REQUIRED
    client = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    client.load_cert_chain(cert, key)
    client.load_verify_locations(ca)
    client.check_hostname = False
    client.verify_mode = ssl.CERT_REQUIRED
    return server, client


class _TlsSocket:
    """Full-duplex-safe wrapper around an SSLSocket.

    OpenSSL forbids concurrent SSL_read/SSL_write on one SSL* (the GIL is
    released around both), but the messenger's design is full-duplex: a
    reader thread blocks in recv while callers send. This adapter makes
    the socket non-blocking and serializes every SSL call under one lock
    WITHOUT ever holding it across a blocking wait — select() runs
    outside the lock — so reads and writes interleave with no deadlock
    and no added latency. Presents the socket surface _recv_exact /
    _send_frame / shutdown() use."""

    def __init__(self, ssl_sock):
        self._s = ssl_sock
        self._s.setblocking(False)
        self._lock = threading.Lock()

    def recv(self, n: int) -> bytes:
        import select
        import ssl as _ssl
        while True:
            with self._lock:
                try:
                    return self._s.recv(n)
                except (_ssl.SSLWantReadError, _ssl.SSLWantWriteError):
                    pass
                except BlockingIOError:
                    pass
            try:
                select.select([self._s], [], [], 0.5)
            except (ValueError, OSError):
                # closed concurrently by shutdown(): fd is gone
                raise ConnectionError("socket closed during recv")

    def sendall(self, data) -> None:
        import select
        import ssl as _ssl
        view = memoryview(data)
        while len(view):
            sent = 0
            want_read = False
            with self._lock:
                try:
                    sent = self._s.send(view)
                except _ssl.SSLWantReadError:
                    # renegotiation/KeyUpdate mid-write: progress needs
                    # INBOUND bytes — selecting for writability would
                    # return instantly and busy-spin a core
                    want_read = True
                except (_ssl.SSLWantWriteError, BlockingIOError):
                    pass
            if sent:
                view = view[sent:]
                continue
            try:
                if want_read:
                    select.select([self._s], [], [], 0.5)
                else:
                    select.select([], [self._s], [], 0.5)
            except (ValueError, OSError):
                raise ConnectionError("socket closed during send")

    def setsockopt(self, *a) -> None:
        self._s.setsockopt(*a)

    def settimeout(self, t) -> None:
        pass  # non-blocking + select manage timing

    def shutdown(self, how) -> None:
        self._s.shutdown(how)

    def close(self) -> None:
        self._s.close()


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(min(n, 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


_COMPRESS_BIT = 0x80000000
_SIDECAR_BIT = 0x40000000

# observability: sidecar frames sent / segment bytes moved (tests assert
# the zero-copy path actually carries the bulk traffic). Incremented from
# every sender thread — the bare `+= 1` here was a textbook lost-update
# race (found by the lock-discipline pass).
sidecar_frames_sent = 0  # guarded-by: _sidecar_stats_lock
sidecar_bytes_sent = 0   # guarded-by: _sidecar_stats_lock
_sidecar_stats_lock = threading.Lock()


def _send_message(sock: socket.socket, lock: threading.Lock, obj) -> None:
    """Encode + send one message, externalizing bulk bytes as sidecar
    segments (ref: rpc/rpc_context.h sidecars): the tagged payload carries
    only references; segment bytes go to the socket STRAIGHT from the
    caller's buffers via vectored send — no join, no re-encode, no
    compression attempt over already-opaque bulk data.

    Sidecar frame layout (length word has _SIDECAR_BIT set; the length
    word counts ONLY the small header + payload — segment sizes live in
    the u64 table, so sidecar bytes are unbounded by the u32 framing):
        [u32 (4+8n+payload_len)|SIDECAR][u32 n_sc][u64 sc_len]*n
        [payload][sc bytes]*n
    """
    from yugabyte_tpu_torch.rpc.codec import dumps_with_sidecars
    min_sc = flags.get_flag("rpc_sidecar_min_bytes")
    if not min_sc:
        _send_frame(sock, lock, dumps(obj))
        return
    payload, sidecars = dumps_with_sidecars(obj, min_sc)
    if not sidecars:
        _send_frame(sock, lock, payload)
        return
    global sidecar_frames_sent, sidecar_bytes_sent
    with _sidecar_stats_lock:
        sidecar_frames_sent += 1
        sidecar_bytes_sent += sum(len(s) for s in sidecars)
    n_sc = len(sidecars)
    header = bytearray()
    header += struct.pack("<I", n_sc)
    for sc in sidecars:
        header += struct.pack("<Q", len(sc))
    small = len(header) + len(payload)
    if small >= _SIDECAR_BIT:
        raise ValueError(f"RPC payload too large to frame: {small} bytes")
    bufs = [_LEN.pack(small | _SIDECAR_BIT), bytes(header), payload,
            *sidecars]
    with lock:
        if hasattr(sock, "sendmsg"):
            # vectored send; loop for short writes, and cap each call at
            # IOV_MAX-ish buffers (Linux 1024) — a scan/CDC response with
            # thousands of sidecar'd chunks would otherwise EMSGSIZE
            view_left = bufs
            while view_left:
                sent = sock.sendmsg(view_left[:1000])
                while view_left and sent >= len(view_left[0]):
                    sent -= len(view_left[0])
                    view_left = view_left[1:]
                if sent and view_left:
                    view_left = [memoryview(view_left[0])[sent:],
                                 *view_left[1:]]
        else:
            for b in bufs:  # TLS adapter: sequential sendall
                sock.sendall(b)


def _recv_message(sock: socket.socket):
    """Receive + decode one message (inverse of _send_message). Sidecar
    segments are read with recv_into straight into exact-sized buffers —
    one kernel->buffer copy, no reassembly join."""
    from yugabyte_tpu_torch.rpc.codec import loads_with_sidecars
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if not n & _SIDECAR_BIT:
        return loads(_recv_body(sock, n))
    small = n & ~_SIDECAR_BIT
    (n_sc,) = struct.unpack("<I", _recv_exact(sock, 4))
    lens = struct.unpack(f"<{n_sc}Q", _recv_exact(sock, 8 * n_sc))
    payload_len = small - 4 - 8 * n_sc
    payload = _recv_exact(sock, payload_len)
    sidecars = []
    for ln in lens:
        # exact-sized buffer filled straight from the socket; the
        # bytearray itself is spliced into the message (bytes-like,
        # equality-compatible) — no second copy
        buf = bytearray(ln)
        if hasattr(sock, "recv_into"):
            view = memoryview(buf)
            got = 0
            while got < ln:
                r = sock.recv_into(view[got:], ln - got)
                if not r:
                    raise ConnectionError("peer closed mid-sidecar")
                got += r
        else:
            buf[:] = _recv_exact(sock, ln)
        sidecars.append(buf)
    return loads_with_sidecars(payload, sidecars)


def _send_frame(sock: socket.socket, lock: threading.Lock,
                payload: bytes) -> None:
    """One frame: [u32 LE length][payload]; bit 31 of the length marks a
    zlib-compressed payload (ref rpc/compressed_stream.cc — bulk traffic
    like remote bootstrap chunks, CDC batches and big scan pages shrinks
    several-fold; small frames skip the codec cost)."""
    import zlib
    if len(payload) >= _SIDECAR_BIT:
        # bits 30/31 of the length word are flags; a >=1 GiB tagged
        # payload cannot be framed (bulk bytes ride sidecars, whose u64
        # length table has no such bound) — refuse loudly rather than
        # desync the stream
        raise ValueError(f"RPC payload too large to frame: {len(payload)}")
    min_bytes = flags.get_flag("rpc_compression_min_bytes")
    if min_bytes and len(payload) >= min_bytes:
        packed = zlib.compress(payload, 1)
        if len(packed) < len(payload):
            with lock:
                sock.sendall(_LEN.pack(len(packed) | _COMPRESS_BIT)
                             + packed)
            return
    with lock:
        sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_body(sock: socket.socket, len_word: int) -> bytes:
    """Read + (if flagged) decompress one plain frame body given its
    already-read length word — shared by the sidecar and plain paths."""
    import zlib
    body = _recv_exact(sock, len_word & ~_COMPRESS_BIT)
    if len_word & _COMPRESS_BIT:
        body = zlib.decompress(body)
    return body


def _recv_frame(sock: socket.socket) -> bytes:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    return _recv_body(sock, n)


class _ClientConnection:
    """One outbound TCP connection; demuxes responses by call id."""

    def __init__(self, addr: Tuple[str, int], ssl_ctx=None):
        self.addr = addr
        self.sock = socket.create_connection(
            addr, timeout=flags.get_flag("rpc_connect_timeout_s"))
        if ssl_ctx is not None:
            self.sock = _TlsSocket(ssl_ctx.wrap_socket(self.sock))
        self.sock.settimeout(None)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        from yugabyte_tpu_torch.utils import lock_rank
        self.write_lock = threading.Lock()
        self.lock = lock_rank.tracked(threading.Lock(),
                                      "messenger.client_conn.lock")
        self.next_id = 1                     # guarded-by: lock
        self.pending: Dict[int, dict] = {}   # guarded-by: lock
        self.dead: Optional[Exception] = None  # guarded-by: lock
        self.reader = threading.Thread(target=self._read_loop, daemon=True,
                                       name=f"rpc-client-read-{addr}")
        self.reader.start()

    def _read_loop(self) -> None:
        try:
            while True:
                resp = _recv_message(self.sock)
                with self.lock:
                    waiter = self.pending.pop(resp["id"], None)
                if waiter is not None:
                    waiter["resp"] = resp
                    waiter["event"].set()
        except Exception as e:  # noqa: BLE001 — fail all outstanding calls
            with self.lock:
                self.dead = e
                waiters = list(self.pending.values())
                self.pending.clear()
            for w in waiters:
                w["event"].set()

    def call(self, svc: str, mth: str, args: dict, timeout_s: float,
             trace_ctx: Optional[dict] = None) -> dict:
        with self.lock:
            if self.dead is not None:
                raise ServiceUnavailable(f"{self.addr}: {self.dead}")
            call_id = self.next_id
            self.next_id += 1
            waiter = {"event": threading.Event(), "resp": None}
            self.pending[call_id] = waiter
        req_msg = {"id": call_id, "svc": svc, "mth": mth,
                   "args": args, "deadline_s": timeout_s}
        if trace_ctx is not None:
            # cross-node trace propagation: the receiver adopts this span
            # context so multi-hop requests stitch under one trace_id
            req_msg[TRACE_HEADER_KEY] = trace_ctx
        budget = _latency.current_budget()
        if budget is not None:
            # latency attribution rides next to the trace header: mark
            # the op so the server opens a matching budget, and stamp
            # the budget's exemplar trace id while the context is live
            lat_hdr = lat_to_wire(budget)
            if lat_hdr is not None:
                req_msg[LAT_HEADER_KEY] = lat_hdr
            if budget.trace_id is None and trace_ctx is not None:
                budget.trace_id = trace_ctx.get("trace_id")
        t_enc = time.monotonic()
        try:
            _send_message(self.sock, self.write_lock, req_msg)
        except OSError as e:
            with self.lock:
                self.pending.pop(call_id, None)
            raise ServiceUnavailable(f"{self.addr}: {e}") from e
        if budget is not None:
            budget.record(_latency.STAGE_WIRE_ENCODE,
                          (time.monotonic() - t_enc) * 1e3)
        if not waiter["event"].wait(timeout=timeout_s):
            with self.lock:
                self.pending.pop(call_id, None)
            raise RpcTimeout(f"{svc}.{mth} to {self.addr} "
                             f"timed out after {timeout_s}s")
        if waiter["resp"] is None:
            with self.lock:
                dead = self.dead
            raise ServiceUnavailable(f"{self.addr}: connection failed "
                                     f"({dead})")
        return waiter["resp"]

    def alive(self) -> bool:
        """Locked liveness probe for the messenger's conn-cache paths.
        `dead` transitions once (None -> Exception) under `lock`; callers
        must not read it bare."""
        with self.lock:
            return self.dead is None

    def close(self) -> None:
        # Fail in-flight calls NOW rather than waiting for the reader
        # thread to observe the closed socket: a caller parked in
        # event.wait() must get ServiceUnavailable immediately, never sit
        # out its full timeout_s on a connection known to be gone.
        with self.lock:
            if self.dead is None:
                self.dead = ConnectionError("connection closed")
            waiters = list(self.pending.values())
            self.pending.clear()
        for w in waiters:
            w["event"].set()
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:  # yblint: contained(socket already dead — close() below still releases the fd)
            pass
        self.sock.close()


class _InboundCall:
    """One parsed inbound request parked in the service queue. Carries
    everything a worker needs to run it, plus the timing the shedding
    decisions key on: enqueue time (queue-wait histograms + drain-rate
    EWMA) and the absolute deadline propagated from the caller's
    timeout (expired calls are dropped before execution — the caller
    stopped waiting, so running the handler is pure wasted work)."""

    __slots__ = ("conn", "write_lock", "req", "peer", "enqueued",
                 "deadline")

    def __init__(self, conn, write_lock, req, peer):
        self.conn = conn
        self.write_lock = write_lock
        self.req = req
        self.peer = peer
        self.enqueued = time.monotonic()
        d = req.get("deadline_s")
        self.deadline = (self.enqueued + d) if d else None


class _ServicePool:
    """Bounded inbound-call queue + reused worker threads (ref
    rpc/service_pool.cc ServicePool). Replaces the unbounded
    ThreadPoolExecutor the messenger used to queue into: under overload
    an unbounded queue converts excess offered load into ever-growing
    latency and memory until every queued caller has timed out — this
    pool sheds instead (callers get a typed, retryable answer NOW).

    submit() returns False on overflow (the serving thread replies
    Overloaded); drain() hands back every still-queued call at shutdown
    so the messenger can fail them immediately rather than execute them
    against torn-down services (the inbound mirror of the PR-1
    in-flight-outbound close fix). Workers spawn lazily up to the
    configured thread cap and park on the condition when idle."""

    def __init__(self, messenger: "Messenger", max_threads: int,
                 name: str):
        from collections import deque
        from yugabyte_tpu_torch.utils import lock_rank
        self._messenger = messenger
        self._max_threads = max_threads
        self._name = name
        self._cv = threading.Condition(lock_rank.tracked(
            threading.Lock(), "messenger.service_pool.lock"))
        self._queue: "deque[_InboundCall]" = deque()  # guarded-by: _cv
        self._n_threads = 0   # guarded-by: _cv
        self._n_idle = 0      # guarded-by: _cv
        self._shutdown = False  # guarded-by: _cv

    def submit(self, call: _InboundCall) -> bool:
        """Queue one call; False = queue full (caller sheds)."""
        depth = flags.get_flag("rpc_service_queue_depth")
        with self._cv:
            if self._shutdown:
                raise RuntimeError("service pool is shut down")
            if depth and len(self._queue) >= depth:
                return False
            self._queue.append(call)
            if self._n_idle == 0 and self._n_threads < self._max_threads:
                self._n_threads += 1
                threading.Thread(
                    target=self._worker, daemon=True,
                    name=f"rpc-worker-{self._name}-{self._n_threads}"
                ).start()
            else:
                self._cv.notify()
        return True

    def queue_len(self) -> int:
        with self._cv:
            return len(self._queue)

    def _worker(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._shutdown:
                    self._n_idle += 1
                    self._cv.wait()
                    self._n_idle -= 1
                if self._shutdown and not self._queue:
                    self._n_threads -= 1
                    return
                call = self._queue.popleft()
            self._messenger._run_inbound(call)

    def drain(self) -> list:
        """Begin shutdown: returns every queued-but-not-started call for
        the messenger to fail; workers exit once idle (in-flight
        handlers run to completion, like the executor's
        cancel_futures=True shutdown did)."""
        with self._cv:
            self._shutdown = True
            queued = list(self._queue)
            self._queue.clear()
            self._cv.notify_all()
        return queued


class Messenger:
    """Owns the listening socket, inbound dispatch, and the outbound
    connection cache. One per server process (and one per pure client)."""

    def __init__(self, name: str = "messenger",
                 bind_host: str = "127.0.0.1", port: int = 0,
                 metrics: Optional[MetricRegistry] = None):
        self.name = name
        self._services: Dict[str, object] = {}
        # per-service.method inbound latency histograms (ref: the
        # reference's handler_latency_* metrics per RPC method); entity id
        # carries the method so the family name stays fixed and scrapeable
        from yugabyte_tpu_torch.utils import lock_rank
        self._metrics = metrics if metrics is not None else ROOT_REGISTRY
        self._method_hists: Dict[Tuple[str, str],
                                 object] = {}  # guarded-by: _method_hists_lock
        self._method_hists_lock = lock_rank.tracked(
            threading.Lock(), "messenger._method_hists_lock")
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((bind_host, port))
        self._listener.listen(128)
        self.host, self.port = self._listener.getsockname()
        self._conns: Dict[Tuple[str, int],
                          _ClientConnection] = {}  # guarded-by: _conns_lock
        self._conns_lock = lock_rank.tracked(threading.Lock(),
                                             "messenger._conns_lock")
        self._inbound: list = []  # guarded-by: _inbound_lock
        self._inbound_lock = lock_rank.tracked(threading.Lock(),
                                               "messenger._inbound_lock")
        # deliberately unannotated latch bool: one-way False->True at
        # shutdown; the accept loop's bare read only risks one extra
        # accept, which shutdown() handles by closing late arrivals
        self._shutdown = False
        # persistent BOUNDED service pool (ref rpc/service_pool.cc):
        # handlers run on reused workers — a fresh thread per request
        # cost ~0.4ms of the YCSB-C point-read path (profiled round 3);
        # the queue behind the workers is bounded (rpc_service_queue_depth)
        # and sheds with typed Overloaded + a measured retry_after hint
        self._service_pool = _ServicePool(
            self, flags.get_flag("rpc_service_pool_threads"), name)
        ent = self._metrics.entity("server", f"messenger.{name}")
        self._c_queue_overflow = ent.counter(
            "rpc_queue_overflow_total",
            "inbound calls rejected because the service queue was full")
        self._c_expired_in_queue = ent.counter(
            "rpc_calls_expired_in_queue_total",
            "queued inbound calls dropped unexecuted because their "
            "propagated deadline expired while waiting")
        self._c_shed_at_shutdown = ent.counter(
            "rpc_calls_failed_at_shutdown_total",
            "queued inbound calls failed immediately by messenger "
            "shutdown instead of executing against torn-down services")
        # drain-rate EWMAs feeding the retry_after_ms hint: observed
        # per-call handler time + queue wait (RESYSTANCE spirit — the
        # hint is measured from this messenger's own recent behavior,
        # not a static guess)
        self._ewma_lock = threading.Lock()
        self._svc_ms_ewma = 1.0    # guarded-by: _ewma_lock
        self._queue_ms_ewma = 0.0  # guarded-by: _ewma_lock
        # TLS contexts resolved once per messenger (flag + cert flags)
        self._tls_server_ctx, self._tls_client_ctx = _tls_contexts()
        # /rpcz bookkeeping (ref rpc/rpcz_store.cc): in-flight inbound
        # calls + a ring of recently completed ones
        self._rpcz_lock = lock_rank.tracked(threading.Lock(),
                                            "messenger._rpcz_lock")
        self._rpcz_seq = 0                       # guarded-by: _rpcz_lock
        self._rpcz_inflight: Dict[int, dict] = {}  # guarded-by: _rpcz_lock
        from collections import deque
        self._rpcz_recent: deque = deque(maxlen=100)  # guarded-by: _rpcz_lock
        # responses undeliverable because the caller disconnected first
        # (op fate unknown at the caller — the retryable-request dedup
        # window); counted so chaos soaks can assert the path is exercised
        self._responses_dropped = self._metrics.entity(
            "server", f"messenger.{name}").counter(
            "rpc_responses_dropped_total",
            "inbound-call responses dropped because the caller was gone")
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name=f"rpc-accept-{name}")
        self._accept_thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    # ---------------------------------------------------------------- server
    def register_service(self, name: str, handler: object) -> None:
        """Handler methods named `<method>` take keyword args from the wire
        and return a wire-encodable value (ref ServicePool dispatch)."""
        self._services[name] = handler

    def _accept_loop(self) -> None:
        while not self._shutdown:
            try:
                conn, peer = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._inbound_lock:
                if self._shutdown:
                    # accepted in the closing window: shutdown() already
                    # snapshotted _inbound and would never close this one
                    conn.close()
                    return
                self._inbound.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn, peer),
                             daemon=True,
                             name=f"rpc-serve-{self.name}-{peer}").start()

    def _serve_conn(self, conn: socket.socket, peer) -> None:
        write_lock = threading.Lock()
        if self._tls_server_ctx is not None:
            # handshake on the connection's own thread — a stalling or
            # certless client must not block the accept loop
            raw = conn
            try:
                conn = _TlsSocket(self._tls_server_ctx.wrap_socket(
                    raw, server_side=True))
            except Exception as e:  # noqa: BLE001 — reject bad handshakes
                TRACE("rpc %s: TLS handshake from %s failed: %s",
                      self.name, peer, e)
                raw.close()
                return
            # wrap_socket DETACHES the raw fd: shutdown() must operate on
            # the live wrapped socket, not the dead raw one. Swap under
            # the lock (shutdown iterates this list), and if shutdown
            # already ran, close the fresh wrapped socket ourselves.
            with self._inbound_lock:
                closing = self._shutdown
                try:
                    self._inbound.remove(raw)
                except ValueError:
                    pass
                if not closing:
                    self._inbound.append(conn)
            if closing:
                conn.close()
                return
        try:
            while True:
                req = _recv_message(conn)
                # Handlers run off-connection so one slow handler does not
                # head-of-line-block the connection; the pool reuses
                # workers (the reference's ServicePool). The queue behind
                # them is BOUNDED: overflow answers NOW with a typed
                # retryable Overloaded + a measured retry_after hint,
                # instead of parking the caller in an invisible line.
                call = _InboundCall(conn, write_lock, req, peer)
                try:
                    accepted = self._service_pool.submit(call)
                except RuntimeError:
                    return  # pool shut down: messenger is closing
                if not accepted:
                    self._c_queue_overflow.increment()
                    self._reply_overloaded(
                        call, f"rpc {self.name}: service queue full "
                        f"({flags.get_flag('rpc_service_queue_depth')} "
                        f"calls); retry later")
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def retry_after_hint_ms(self) -> int:
        """Measured drain estimate shipped with shedding rejections: the
        time the current queue takes to clear at the recently observed
        per-call service rate, floored by the recent queue wait. Clamped
        to [10ms, 2s] so a cold EWMA can neither spam retries nor park
        clients for minutes."""
        with self._ewma_lock:
            svc_ms, queue_ms = self._svc_ms_ewma, self._queue_ms_ewma
        n_workers = max(1, flags.get_flag("rpc_service_pool_threads"))
        drain_ms = self._service_pool.queue_len() * svc_ms / n_workers
        return int(min(2000.0, max(10.0, drain_ms, queue_ms)))

    def _note_timing(self, queue_ms: float,
                     svc_ms: Optional[float] = None) -> None:
        with self._ewma_lock:
            self._queue_ms_ewma = (0.8 * self._queue_ms_ewma
                                   + 0.2 * queue_ms)
            if svc_ms is not None:
                self._svc_ms_ewma = 0.8 * self._svc_ms_ewma + 0.2 * svc_ms

    def _reply_overloaded(self, call: _InboundCall, msg: str,
                          code: Code = Code.BUSY,
                          extra: Optional[dict] = None) -> None:
        """Synthesize a typed shedding response without running any
        handler (queue overflow / shutdown). Send failures mean the
        caller is already gone — counted like any dropped response."""
        resp = {"id": call.req.get("id"), "code": code.value, "err": msg,
                "ret": None,
                "extra": dict({"overloaded": True,
                               "retry_after_ms": self.retry_after_hint_ms()},
                              **(extra or {}))}
        try:
            _send_message(call.conn, call.write_lock, resp)
        except OSError as e:
            self._responses_dropped.increment()
            TRACE("rpc %s: overload reply to %s.%s call %s dropped: %s",
                  self.name, call.req.get("svc"), call.req.get("mth"),
                  call.req.get("id"), e)

    def _run_inbound(self, call: _InboundCall) -> None:
        """Worker-side entry: account queue time, shed expired calls
        (counted, provably never executed), then dispatch."""
        now = time.monotonic()
        queue_ms = (now - call.enqueued) * 1e3
        req = call.req
        self._method_histogram(req["svc"], req["mth"],
                               kind="queue").increment(queue_ms)
        if call.deadline is not None and now >= call.deadline:
            # Nobody is waiting for this answer anymore (the caller's
            # timeout elapsed while the call sat in the queue): running
            # the handler would spend pool time on dead work and delay
            # calls that CAN still be answered. Drop without executing
            # and without a response (the caller already moved on).
            self._c_expired_in_queue.increment()
            self._note_timing(queue_ms)
            TRACE("rpc %s: %s.%s call %s expired in queue "
                  "(waited %.1fms past a %.1fs deadline); dropped "
                  "unexecuted", self.name, req.get("svc"), req.get("mth"),
                  req.get("id"), queue_ms, req.get("deadline_s"))
            return
        t0 = time.monotonic()
        try:
            self._dispatch(call.conn, call.write_lock, req, call.peer,
                           queue_ms=queue_ms)
        finally:
            self._note_timing(queue_ms, (time.monotonic() - t0) * 1e3)

    def _dispatch(self, conn: socket.socket, write_lock: threading.Lock,
                  req: dict, peer=None, queue_ms: float = 0.0) -> None:
        resp = self._invoke(req["svc"], req["mth"], req["args"], peer=peer,
                            trace_ctx=trace_from_wire(
                                req.get(TRACE_HEADER_KEY)),
                            lat_op=lat_op_from_wire(
                                req.get(LAT_HEADER_KEY)),
                            queue_ms=queue_ms)
        resp["id"] = req["id"]
        try:
            _send_message(conn, write_lock, resp)
        except OSError as e:
            # Caller gone (closed its connection / died mid-call): the
            # response is dropped like an expired call. NOT silent — the
            # caller will retry as op-fate-unknown, so chaos runs need to
            # see how often this ambiguity window actually opens.
            self._responses_dropped.increment()
            TRACE("rpc %s: response to %s.%s call %s dropped, caller "
                  "gone: %s", self.name, req.get("svc"), req.get("mth"),
                  req.get("id"), e)

    _HIST_KINDS = {
        "duration": ("rpc_inbound_call_duration_ms",
                     "inbound RPC handler latency per service.method"),
        "queue": ("rpc_inbound_call_queue_time_ms",
                  "time inbound calls spent queued behind the service "
                  "pool per service.method"),
    }

    def _method_histogram(self, svc: str, mth: str,
                          kind: str = "duration"):
        key = (svc, mth, kind)
        # benign racy fast path on the per-RPC hot loop: dict reads are
        # atomic under the GIL and every WRITE happens under the lock
        # below, so the worst case is taking the slow path once
        h = self._method_hists.get(key)  # yblint: disable=lock-discipline
        if h is None:
            with self._method_hists_lock:
                h = self._method_hists.get(key)
                if h is None:
                    name, help_text = self._HIST_KINDS[kind]
                    h = self._metrics.entity(
                        "service", f"{svc}.{mth}",
                        {"service": svc, "method": mth}).histogram(
                        name, help_text)
                    self._method_hists[key] = h
        return h

    def _invoke(self, svc: str, mth: str, args: dict, peer=None,
                trace_ctx: Optional[dict] = None,
                lat_op: Optional[str] = None,
                queue_ms: float = 0.0) -> dict:
        entry = {"svc": svc, "mth": mth, "start": time.time(),
                 "peer": f"{peer[0]}:{peer[1]}" if peer else "local"}
        with self._rpcz_lock:
            self._rpcz_seq += 1
            rid = self._rpcz_seq
            self._rpcz_inflight[rid] = entry
        # Attribution-carrying request: open a server-side budget seeded
        # with the service-queue wait. Handler-path stage sites (raft,
        # WAL, storage) record into it via the contextvar, and the stage
        # map rides the response's `lat` key back to the owning client.
        budget = token = None
        if lat_op is not None:
            budget = _latency.LatencyBudget(lat_op)
            budget.record(_latency.STAGE_RPC_QUEUE, queue_ms)
            token = _latency.use_budget(budget)
        resp = None
        t0 = time.monotonic()
        try:
            # request-scoped trace: handler TRACE() calls land in /tracez.
            # An inbound trace header is ADOPTED, stitching this handler
            # span into the caller's distributed trace.
            with Trace.from_wire_context(trace_ctx,
                                         f"{svc}.{mth}") as span:
                entry["trace_id"] = span.trace_id
                resp = self._invoke_inner(svc, mth, args)
        finally:
            wall_ms = (time.monotonic() - t0) * 1e3
            if token is not None:
                _latency.clear_budget(token)
            if budget is not None and resp is not None:
                # telescope the handler wall closed: whatever the stage
                # sites did not claim is server_other, so the server map
                # always sums to queue wait + handler wall
                in_handler = budget.measured_ms() - budget.stages.get(
                    _latency.STAGE_RPC_QUEUE, 0.0)
                budget.record(_latency.STAGE_SERVER_OTHER,
                              wall_ms - in_handler)
                resp[LAT_HEADER_KEY] = budget.to_wire()
            self._method_histogram(svc, mth).increment(wall_ms)
            # entry is fully populated BEFORE it is published — rpcz()
            # hands out references, so late mutation would race the
            # webserver's serialization
            done = dict(entry)
            done["duration_ms"] = round(
                (time.time() - entry["start"]) * 1e3, 2)
            done["code"] = resp["code"] if resp is not None else None
            with self._rpcz_lock:
                self._rpcz_inflight.pop(rid, None)
                self._rpcz_recent.append(done)
        return resp

    def rpcz(self) -> dict:
        """In-flight + recently completed inbound RPCs (ref /rpcz,
        rpc/rpcz_store.cc)."""
        now = time.time()
        with self._rpcz_lock:
            inflight = [dict(e, elapsed_ms=round((now - e["start"]) * 1e3, 2))
                        for e in self._rpcz_inflight.values()]
            recent = list(self._rpcz_recent)
        return {"inbound_in_flight": inflight,
                "inbound_recent": recent}

    def _invoke_inner(self, svc: str, mth: str, args: dict) -> dict:
        handler = self._services.get(svc)
        if handler is None:
            return {"code": Code.SERVICE_UNAVAILABLE.value,
                    "err": f"unknown service {svc!r}", "ret": None,
                    "extra": {}}
        method = getattr(handler, mth, None)
        if method is None or mth.startswith("_"):
            return {"code": Code.NOT_SUPPORTED.value,
                    "err": f"{svc} has no method {mth!r}", "ret": None,
                    "extra": {}}
        try:
            ret = method(**args)
            return {"code": Code.OK.value, "err": "", "ret": ret, "extra": {}}
        except StatusError as e:  # yblint: contained(routed over the wire — the status code + message cross to the caller, which raises RemoteError)
            return {"code": e.status.code.value, "err": e.status.message,
                    "ret": None, "extra": getattr(e, "extra", {}) or {}}
        except Exception as e:  # noqa: BLE001 — remote errors cross the wire
            TRACE("rpc %s: %s.%s raised %r", self.name, svc, mth, e)
            return {"code": Code.REMOTE_ERROR.value,
                    "err": f"{type(e).__name__}: {e}", "ret": None,
                    "extra": {}}

    # ---------------------------------------------------------------- client
    def call(self, addr: str, svc: str, mth: str,
             timeout_s: Optional[float] = None, **args) -> Any:
        """Invoke svc.mth(**args) at addr ('host:port'). Local bypass when
        addr is this messenger (ref rpc/local_call.h)."""
        timeout_s = timeout_s if timeout_s is not None else \
            flags.get_flag("rpc_default_timeout_s")
        if addr == self.address:
            # local bypass is NOT an inbound RPC: skip /rpcz accounting,
            # and attach its trace as a CHILD of the caller's request
            # trace so slow-op dumps keep the nested-call section
            from yugabyte_tpu_torch.utils.trace import current_trace
            parent = current_trace()
            child = Trace(f"local:{svc}.{mth}", record=parent is None)
            if parent is not None:
                parent.children.append(child)
            with child:
                resp = self._invoke_inner(svc, mth, args)
        else:
            # Network nemesis (rpc/nemesis.py): an installed fault-rule
            # table may partition/drop/delay/duplicate this call. The
            # check is a single None test when no chaos run is active.
            from yugabyte_tpu_torch.rpc import nemesis as _nemesis
            nem = _nemesis.active()
            verdict = None
            if nem is not None:
                try:
                    verdict = nem.check_link(self.name, addr)
                except _nemesis.LinkBlocked as e:
                    raise ServiceUnavailable(str(e)) from e
                except _nemesis.LinkDropped as e:
                    # request lost in flight: the op's fate is unknown to
                    # the caller, exactly like a real timeout (fast-
                    # forwarded — see nemesis module docstring)
                    raise RpcTimeout(f"{svc}.{mth} to {addr}: {e}") from e
            host, port_s = addr.rsplit(":", 1)
            conn = self._get_conn((host, int(port_s)))
            try:
                resp = conn.call(svc, mth, args, timeout_s,
                                 trace_ctx=trace_to_wire(
                                     current_trace_context()))
                if verdict is not None and verdict.duplicate:
                    # duplicate delivery: the remote executes twice; the
                    # first response is the one the caller consumes (the
                    # retryable-request layer must dedup the second
                    # apply). A failure of the DUPLICATE must not fail
                    # the original call — real networks drop duplicates.
                    try:
                        conn.call(svc, mth, args, timeout_s,
                                  trace_ctx=trace_to_wire(
                                      current_trace_context()))
                    except (RpcTimeout, ServiceUnavailable,
                            RemoteError) as e:
                        TRACE("nemesis: duplicate delivery of %s.%s "
                              "failed (%s); original response stands",
                              svc, mth, e)
            except ServiceUnavailable:
                self._drop_conn(conn)
                raise
            if verdict is not None and verdict.drop_response:
                # delivered + executed, response lost: surface the same
                # ambiguity a real lost response produces
                raise RpcTimeout(f"{svc}.{mth} to {addr}: response "
                                 "dropped (nemesis)")
        lat = resp.get(LAT_HEADER_KEY)
        if lat:
            # fold the server's stage map into the caller's budget: the
            # client e2e histogram decomposes into server-side stages
            b = _latency.current_budget()
            if b is not None:
                b.merge(lat)
        code = Code(resp["code"])
        if code != Code.OK:
            raise RemoteError(Status(code, resp["err"]),
                              extra=resp.get("extra") or {})
        return resp["ret"]

    def _get_conn(self, addr: Tuple[str, int]) -> _ClientConnection:
        with self._conns_lock:
            conn = self._conns.get(addr)
            if conn is not None and conn.alive():
                return conn
        # Connect outside the lock; racing creators keep the one registered.
        try:
            fresh = _ClientConnection(addr, ssl_ctx=self._tls_client_ctx)
        except OSError as e:
            raise ServiceUnavailable(f"{addr}: {e}") from e
        with self._conns_lock:
            cur = self._conns.get(addr)
            if cur is not None and cur.alive():
                fresh.close()
                return cur
            self._conns[addr] = fresh
            return fresh

    def _drop_conn(self, conn: _ClientConnection) -> None:
        with self._conns_lock:
            if self._conns.get(conn.addr) is conn:
                del self._conns[conn.addr]
        conn.close()

    def overload_snapshot(self) -> dict:
        """The RPC arm of the /servez overload block: queue depth/bound,
        shed counters, and the measured hint state."""
        with self._ewma_lock:
            svc_ms, queue_ms = self._svc_ms_ewma, self._queue_ms_ewma
        return {
            "service_queue_len": self._service_pool.queue_len(),
            "service_queue_depth": flags.get_flag(
                "rpc_service_queue_depth"),
            "rpc_queue_overflow_total": self._c_queue_overflow.value(),
            "rpc_calls_expired_in_queue_total":
                self._c_expired_in_queue.value(),
            "rpc_calls_failed_at_shutdown_total":
                self._c_shed_at_shutdown.value(),
            "retry_after_hint_ms": self.retry_after_hint_ms(),
            "svc_ms_ewma": round(svc_ms, 2),
            "queue_ms_ewma": round(queue_ms, 2),
        }

    def shutdown(self) -> None:
        self._shutdown = True
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()
        # Fail QUEUED (not yet executing) inbound calls NOW, before the
        # services behind them are torn down — the inbound mirror of the
        # outbound close fix in _ClientConnection.close(): a queued
        # caller gets a typed retryable answer immediately instead of
        # its call executing against half-shut-down services (or being
        # silently cancelled into a full client-side timeout).
        for call in self._service_pool.drain():
            self._c_shed_at_shutdown.increment()
            self._reply_overloaded(
                call, f"rpc {self.name}: messenger shutting down; "
                f"retry another replica", code=Code.SERVICE_UNAVAILABLE,
                extra={"shutting_down": True})
        with self._conns_lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for c in conns:
            c.close()
        with self._inbound_lock:
            inbound = list(self._inbound)
        for c in inbound:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass


class Proxy:
    """Client stub bound to (messenger, remote addr, service) — the
    reference's generated proxies collapse to this one class
    (ref proxy.h + gen_yrpc)."""

    def __init__(self, messenger: Messenger, addr: str, svc: str):
        self._messenger = messenger
        self.addr = addr
        self.svc = svc

    def __getattr__(self, mth: str) -> Callable[..., Any]:
        def invoke(timeout_s: Optional[float] = None, **args):
            return self._messenger.call(self.addr, self.svc, mth,
                                        timeout_s=timeout_s, **args)
        return invoke
