"""Per-request tracing with cross-node propagation: TRACE and its spans.

The port's copy of the span half of yugabyte_tpu/utils/trace.py (ref:
src/yb/util/trace.h:62-137): a Trace collects timestamped messages for
one request or job, a contextvar carries the current one (so deep call
stacks need no plumbing), and `TRACE(msg, *args)` appends to it, a no-op
outside any trace. The containment paths (storage/compaction.py, the
codec, the pushdown, the point reads, the board) TRACE every fault they
contain. Every Trace is a span (trace_id, span_id, parent_span_id,
sampled); a Trace opened inside another parents itself under it; a
finished span with content lands in the /tracez ring (`tracez()`).
LongOperationTracker (the WAL's slow-fsync dump) TRACEs an overrun and
drops the trace so far into the ring as a `slow-op:<name>` span. The
tablet server's /tracez page (`tracez_page`: the ring and the spans
grouped by trace_id) and /threadz (`threadz`: every live thread's
stack) read it.
"""

from __future__ import annotations

import contextvars
import random
import threading
import time
from typing import Dict, List, Optional, Tuple

_current_trace: contextvars.ContextVar[Optional["Trace"]] = contextvars.ContextVar(
    "ybtpu_trace", default=None)

_id_rng = random.Random()


def _new_id(bits: int) -> str:
    return f"{_id_rng.getrandbits(bits):0{bits // 4}x}"


class Trace:
    __slots__ = ("entries", "start", "children", "name", "record",
                 "trace_id", "span_id", "parent_span_id", "sampled",
                 "_token")

    def __init__(self, name: str = "", record: bool = True,
                 trace_id: Optional[str] = None,
                 parent_span_id: Optional[str] = None,
                 sampled: bool = True):
        self.entries: List[Tuple[float, str]] = []
        self.start = time.monotonic()
        self.children: List["Trace"] = []
        self.name = name
        # record=False: a child attached to a parent trace — it renders
        # inside the parent's /tracez entry, not as its own
        self.record = record
        # Span identity: explicit ids come from an adopted wire context;
        # otherwise inherit the ambient trace (nested local span) or mint a
        # fresh root trace id.
        if trace_id is None:
            ambient = _current_trace.get()
            if ambient is not None:
                trace_id = ambient.trace_id
                parent_span_id = ambient.span_id
                sampled = ambient.sampled
            else:
                trace_id = _new_id(64)
        self.trace_id = trace_id
        self.span_id = _new_id(32)
        self.parent_span_id = parent_span_id
        self.sampled = sampled

    def message(self, msg: str) -> None:
        self.entries.append((time.monotonic() - self.start, msg))

    def dump(self) -> str:
        lines = [f"{dt * 1e3:10.3f}ms {msg}" for dt, msg in self.entries]
        for child in self.children:
            lines.append("  [child trace]")
            lines.extend("  " + l for l in child.dump().splitlines())
        return "\n".join(lines)

    def wire_context(self) -> Dict[str, object]:
        """The propagation header this span stamps on outbound RPCs
        (rpc/codec.trace_to_wire normalizes it for the wire)."""
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "sampled": self.sampled}

    @classmethod
    def from_wire_context(cls, ctx: Optional[dict], name: str = "",
                          record: bool = True) -> "Trace":
        """Adopt an inbound RPC's trace header: the new span continues the
        sender's trace_id and parents under the sender's span. A missing /
        malformed header (old peer) starts a fresh root trace."""
        if not isinstance(ctx, dict) or not ctx.get("trace_id"):
            return cls(name, record=record)
        return cls(name, record=record, trace_id=str(ctx["trace_id"]),
                   parent_span_id=(str(ctx["span_id"])
                                   if ctx.get("span_id") else None),
                   sampled=bool(ctx.get("sampled", True)))

    def __enter__(self) -> "Trace":
        self._token = _current_trace.set(self)
        return self

    def __exit__(self, *exc) -> None:
        _current_trace.reset(self._token)
        # children count as content: a request whose only activity is a
        # nested local-bypass call must still appear in /tracez
        if self.record and self.sampled and (self.entries or self.children):
            _record_tracez(self)


def TRACE(msg: str, *args) -> None:
    """Append to the current request trace, if any (ref: TRACE() macro, trace.h)."""
    t = _current_trace.get()
    if t is not None:
        t.message(msg % args if args else msg)


def current_trace() -> Optional[Trace]:
    return _current_trace.get()


def current_trace_context() -> Optional[Dict[str, object]]:
    """Wire context of the current span, or None outside any trace."""
    t = _current_trace.get()
    return t.wire_context() if t is not None else None


# ------------------------------------------------------------- /tracez
# Ring of recently completed traces (ref: the reference's /tracez page
# over yb::Trace sampling). Completed scoped Traces with any entries
# land here; the webserver serves them as JSON.
_tracez_lock = threading.Lock()
_TRACEZ: List[dict] = []
_TRACEZ_CAP = 256


def _span_entry(t: Trace, duration_ms: Optional[float] = None) -> dict:
    if duration_ms is None:
        duration_ms = round((time.monotonic() - t.start) * 1e3, 3)
    return {"name": t.name or "request",
            "wall_ts": time.time(),
            "duration_ms": duration_ms,
            "trace_id": t.trace_id,
            "span_id": t.span_id,
            "parent_span_id": t.parent_span_id,
            "dump": t.dump()}


def _record_tracez(t: Trace) -> None:
    entry = _span_entry(t)
    with _tracez_lock:
        _TRACEZ.append(entry)
        if len(_TRACEZ) > _TRACEZ_CAP:
            del _TRACEZ[: len(_TRACEZ) - _TRACEZ_CAP]


def tracez() -> List[dict]:
    with _tracez_lock:
        return list(reversed(_TRACEZ))


def tracez_grouped() -> List[dict]:
    """Spans grouped by trace_id with per-hop timings — the multi-hop view
    of /tracez: one entry per distributed trace, its spans (hops) oldest
    first, so a slow client -> tserver -> raft-peer write reads as one
    tree instead of fragments on every server."""
    groups: Dict[str, List[dict]] = {}
    order: List[str] = []
    for span in reversed(tracez()):        # oldest first within a trace
        tid = span.get("trace_id") or "untraced"
        if tid not in groups:
            groups[tid] = []
            order.append(tid)
        groups[tid].append(span)
    out = []
    for tid in order:
        spans = groups[tid]
        out.append({
            "trace_id": tid,
            "n_spans": len(spans),
            "wall_ts": spans[0]["wall_ts"],
            "total_duration_ms": round(
                sum(s["duration_ms"] for s in spans), 3),
            "spans": [{k: s[k] for k in
                       ("name", "wall_ts", "duration_ms", "span_id",
                        "parent_span_id", "dump")} for s in spans],
        })
    out.reverse()                          # newest trace first
    return out


def tracez_page() -> dict:
    """The /tracez payload: flat span ring + the grouped-by-trace view."""
    return {"spans": tracez(), "traces": tracez_grouped()}


def threadz() -> List[dict]:
    """Live thread stack dump (the reference exposes /pprof + /threadz
    from the stack-trace collector, util/debug-util.cc)."""
    import sys
    import threading as _t
    import traceback
    frames = sys._current_frames()
    out = []
    for th in _t.enumerate():
        fr = frames.get(th.ident)
        out.append({
            "name": th.name,
            "ident": th.ident,
            "daemon": th.daemon,
            "stack": traceback.format_stack(fr) if fr is not None else [],
        })
    return out


class LongOperationTracker:
    """Warns (collects) when an operation exceeds a threshold (ref:
    util/long_operation_tracker.h). On exceed it TRACEs into the current
    request trace AND dumps the stitched trace-so-far into the /tracez
    ring as a `slow-op:<name>` span, so a slow WAL fsync is explainable
    after the fact even if the enclosing request ultimately succeeds."""

    def __init__(self, name: str, threshold_ms: float = 1000.0):
        self.name = name
        self.threshold_ms = threshold_ms

    def __enter__(self):
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc):
        elapsed_ms = (time.monotonic() - self._start) * 1e3
        if elapsed_ms > self.threshold_ms:
            TRACE("LongOperation %s took %.1fms (threshold %.1fms)",
                  self.name, elapsed_ms, self.threshold_ms)
            self._dump_slow_op(elapsed_ms)

    def _dump_slow_op(self, elapsed_ms: float) -> None:
        from yugabyte_tpu_torch.utils.metrics import ROOT_REGISTRY
        ROOT_REGISTRY.entity("server", "slow_ops").counter(
            "long_operation_exceeded_total",
            "operations that overran their LongOperationTracker "
            "threshold").increment()
        t = _current_trace.get()
        entry = {"name": f"slow-op:{self.name}",
                 "wall_ts": time.time(),
                 "duration_ms": round(elapsed_ms, 3),
                 # a child span of the still-open enclosing request span
                 "trace_id": t.trace_id if t is not None else _new_id(64),
                 "span_id": _new_id(32),
                 "parent_span_id": t.span_id if t is not None else None,
                 "dump": t.dump() if t is not None else ""}
        with _tracez_lock:
            _TRACEZ.append(entry)
            if len(_TRACEZ) > _TRACEZ_CAP:
                del _TRACEZ[: len(_TRACEZ) - _TRACEZ_CAP]
