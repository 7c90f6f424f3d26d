"""Self-describing binary wire codec for RPC payloads.

Counterpart of yugabyte_tpu/rpc/codec.py: the same bytes for the same
value, so each package loads what the other dumps.

The reference serializes RPC bodies as protobuf with a small binary header
(ref: src/yb/rpc/binary_call_parser.cc framing, gen_yrpc codegen for message
classes). Here the message set is small and Python-native, so instead of a
codegen step we use one compact tagged codec covering the closed type set
{None, bool, int, float, bytes, str, list, dict}; services exchange plain
dicts. Ints are arbitrary-precision (hybrid times are u64-sized), encoded
as length-prefixed big-endian two's complement.

Framing on the socket is [u32 little-endian length][payload] — the same
length-prefix scheme as the reference's binary call parser.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple

_F64 = struct.Struct("<d")


def _write_varint(out: List[bytes], n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(bytes((b | 0x80,)))
        else:
            out.append(bytes((b,)))
            return


def _read_varint(buf: bytes, off: int) -> Tuple[int, int]:
    shift = 0
    n = 0
    while True:
        b = buf[off]
        off += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, off
        shift += 7


def _dump(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"N")
    elif obj is True:
        out.append(b"T")
    elif obj is False:
        out.append(b"F")
    elif isinstance(obj, int):
        raw = obj.to_bytes((obj.bit_length() + 8) // 8 or 1, "big", signed=True)
        out.append(b"i")
        _write_varint(out, len(raw))
        out.append(raw)
    elif isinstance(obj, float):
        out.append(b"f")
        out.append(_F64.pack(obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        out.append(b"b")
        _write_varint(out, len(b))
        out.append(b)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        out.append(b"s")
        _write_varint(out, len(raw))
        out.append(raw)
    elif isinstance(obj, (list, tuple)):
        out.append(b"l")
        _write_varint(out, len(obj))
        for item in obj:
            _dump(item, out)
    elif isinstance(obj, dict):
        out.append(b"d")
        _write_varint(out, len(obj))
        for k, v in obj.items():
            _dump(k, out)
            _dump(v, out)
    else:
        raise TypeError(f"not wire-encodable: {type(obj)!r}")


def dumps(obj: Any) -> bytes:
    out: List[bytes] = []
    _dump(obj, out)
    return b"".join(out)


def _load(buf: bytes, off: int) -> Tuple[Any, int]:
    tag = buf[off:off + 1]
    off += 1
    if tag == b"N":
        return None, off
    if tag == b"T":
        return True, off
    if tag == b"F":
        return False, off
    if tag == b"i":
        n, off = _read_varint(buf, off)
        return int.from_bytes(buf[off:off + n], "big", signed=True), off + n
    if tag == b"f":
        return _F64.unpack_from(buf, off)[0], off + _F64.size
    if tag == b"b":
        n, off = _read_varint(buf, off)
        return buf[off:off + n], off + n
    if tag == b"s":
        n, off = _read_varint(buf, off)
        return buf[off:off + n].decode("utf-8"), off + n
    if tag == b"l":
        n, off = _read_varint(buf, off)
        items = []
        for _ in range(n):
            item, off = _load(buf, off)
            items.append(item)
        return items, off
    if tag == b"d":
        n, off = _read_varint(buf, off)
        d = {}
        for _ in range(n):
            k, off = _load(buf, off)
            v, off = _load(buf, off)
            d[k] = v
        return d, off
    raise ValueError(f"bad wire tag {tag!r} at offset {off - 1}")


def loads(buf: bytes) -> Any:
    obj, off = _load(buf, 0)
    if off != len(buf):
        raise ValueError(f"trailing garbage: {len(buf) - off} bytes")
    return obj


# ------------------------------------------------------------ trace header
# Distributed trace propagation (the reference's RPC header carries an
# optional trace id the same way, ref: rpc/rpc_header.proto trace fields):
# request messages carry an optional TRACE_HEADER_KEY entry holding the
# caller's span context. Absent header = untraced caller (old peer) — the
# decode side tolerates it, so the wire stays backward compatible.

TRACE_HEADER_KEY = "trace"


def trace_to_wire(ctx: Any) -> Any:
    """Normalize a span context dict for the wire; None when untraced."""
    if not isinstance(ctx, dict) or not ctx.get("trace_id"):
        return None
    return {"trace_id": str(ctx["trace_id"]),
            "span_id": str(ctx.get("span_id") or ""),
            "sampled": bool(ctx.get("sampled", True))}


def trace_from_wire(wire: Any) -> Any:
    """Inverse of trace_to_wire; tolerates absent/malformed headers."""
    if not isinstance(wire, dict) or not wire.get("trace_id"):
        return None
    return {"trace_id": str(wire["trace_id"]),
            "span_id": str(wire.get("span_id") or ""),
            "sampled": bool(wire.get("sampled", True))}


# ------------------------------------------------- latency-budget header
# Serve-path latency attribution (utils/latency.py) rides next to the
# trace header: a request whose caller carries a LatencyBudget marks the
# op with LAT_HEADER_KEY={"op": <op>}; the server opens a matching
# budget for the handler and returns its stage map under the same key in
# the response, which the caller merges into its own budget. Absent
# header = unattributed caller; both directions tolerate it, so the wire
# stays backward compatible exactly like the trace header.

LAT_HEADER_KEY = "lat"


def lat_to_wire(budget: Any) -> Any:
    """Request-side marker for an attribution-carrying op; None when the
    caller holds no budget."""
    if budget is None or not getattr(budget, "op", None):
        return None
    return {"op": str(budget.op)}


def lat_op_from_wire(wire: Any) -> Any:
    """The op name of a request's latency header; None when absent or
    malformed (old client)."""
    if not isinstance(wire, dict) or not wire.get("op"):
        return None
    return str(wire["op"])


# ---------------------------------------------------------------- sidecars
# Bulk bytes values ride OUTSIDE the tagged payload as separate segments —
# the reference's RPC sidecars (ref: src/yb/rpc/rpc_context.h AddRpcSidecar,
# used by read_query.cc:598 for big scan pages, remote bootstrap chunks and
# CDC batches). The payload holds a tag 'B' + sidecar index; the segment
# bytes are never re-encoded, never scanned, and sent straight from the
# caller's buffer (memoryview) by the messenger's vectored send.

def _dump_sc(obj: Any, out: List[bytes], sidecars: List[memoryview],
             min_bytes: int) -> None:
    if isinstance(obj, (bytes, bytearray, memoryview)) \
            and len(obj) >= min_bytes:
        out.append(b"B")
        _write_varint(out, len(sidecars))
        sidecars.append(memoryview(obj))
    elif isinstance(obj, (list, tuple)):
        out.append(b"l")
        _write_varint(out, len(obj))
        for item in obj:
            _dump_sc(item, out, sidecars, min_bytes)
    elif isinstance(obj, dict):
        out.append(b"d")
        _write_varint(out, len(obj))
        for k, v in obj.items():
            _dump(k, out)  # keys are small scalars: never sidecar'd
            _dump_sc(v, out, sidecars, min_bytes)
    else:
        _dump(obj, out)


def dumps_with_sidecars(obj: Any, min_bytes: int
                        ) -> Tuple[bytes, List[memoryview]]:
    """(payload, sidecars): bytes values >= min_bytes are externalized."""
    out: List[bytes] = []
    sidecars: List[memoryview] = []
    _dump_sc(obj, out, sidecars, min_bytes)
    return b"".join(out), sidecars


def _load_sc(buf: bytes, off: int, sidecars) -> Tuple[Any, int]:
    tag = buf[off:off + 1]
    if tag == b"B":
        idx, off = _read_varint(buf, off + 1)
        return sidecars[idx], off
    if tag == b"l":
        n, off = _read_varint(buf, off + 1)
        items = []
        for _ in range(n):
            item, off = _load_sc(buf, off, sidecars)
            items.append(item)
        return items, off
    if tag == b"d":
        n, off = _read_varint(buf, off + 1)
        d = {}
        for _ in range(n):
            k, off = _load(buf, off)
            v, off = _load_sc(buf, off, sidecars)
            d[k] = v
        return d, off
    return _load(buf, off)


def loads_with_sidecars(buf: bytes, sidecars) -> Any:
    """Inverse of dumps_with_sidecars; sidecar entries are spliced back in
    as the bytes-like objects given (receive path passes exact-sized
    buffers filled straight from the socket — no reassembly copy)."""
    obj, off = _load_sc(buf, 0, sidecars)
    if off != len(buf):
        raise ValueError(f"trailing garbage: {len(buf) - off} bytes")
    return obj
