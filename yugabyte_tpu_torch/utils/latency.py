"""Per-op serve-path latency attribution: the LatencyBudget.

Counterpart of yugabyte_tpu/utils/latency.py, with the imports renamed.

A `LatencyBudget` rides one batched-write or multi_read op alongside the
existing trace context (utils/trace.py) and splits the op's measured
end-to-end wall time into named, disjoint stages:

  batched write : client_queue -> wire_encode -> [wire_transfer] ->
                  rpc_queue -> raft_replicate (-> wal_fsync -> apply)
                  -> server_other
  multi_read    : wire_encode -> [wire_transfer] -> rpc_queue ->
                  device_dispatch | host_fallback -> row_assembly ->
                  server_other

The carrier is a contextvar, exactly like the trace span stack, so the
client batcher, the RPC messenger, raft, the WAL appender and the
storage layer all record into the same object without any plumbing
through intermediate signatures. Two sites cross threads and carry the
budget explicitly instead: `Log.append_async` (the WAL appender thread
records the group-commit fsync slice) and raft's `_budget_by_index` map
(the commit worker records the apply slice), both mirroring how the
trace context already crosses the same boundaries.

Server-side stages cross the wire back to the client: the RPC response
carries a `lat` stage map (rpc/codec.py::LAT_HEADER_KEY) that
`Messenger.call` merges into the caller's budget, so the CLIENT-side
end-to-end histogram decomposes into SERVER-side stages. Two residual
stages telescope the decomposition closed: `server_other` (handler wall
minus the measured server stages) and `wire_transfer` (end-to-end minus
everything measured anywhere) — which is why the named stages sum to
the measured e2e by construction (>=90% asserted in
tests/test_telemetry.py; the clamp to >=0 under cross-thread clock
slack is the only way to lose mass).

Lock-free by design (acceptance: ZERO new locks on the hot path): every
mutation is a single dict-item write under the GIL, and each stage has
exactly one writer thread. Aggregation into the `serve_path` histograms
(which carry trace-id exemplars for /servez -> /tracez click-through)
happens once per op at finalize time, off the per-stage hot path.
"""

from __future__ import annotations

import contextvars
import time
from typing import Dict, Optional

from yugabyte_tpu_torch.utils import metrics as _metrics
from yugabyte_tpu_torch.utils import ybsan

OP_WRITE = "write"
OP_MULTI_READ = "multi_read"

# Stage names (the vocabulary /servez and the README document).
STAGE_CLIENT_QUEUE = "client_queue"      # op waited in the session batcher
STAGE_WIRE_ENCODE = "wire_encode"        # request frame encode + socket send
STAGE_WIRE_TRANSFER = "wire_transfer"    # residual: link + response decode
STAGE_RPC_QUEUE = "rpc_queue"            # inbound service-pool queue wait
STAGE_RAFT_REPLICATE = "raft_replicate"  # replicate wall minus fsync/apply
STAGE_WAL_FSYNC = "wal_fsync"            # group-commit fsync slice
STAGE_APPLY = "apply"                    # committed-entry apply (row encode)
STAGE_SERVER_OTHER = "server_other"      # residual: handler wall minus above
STAGE_DEVICE_DISPATCH = "device_dispatch"  # fused point-read kernel path
STAGE_HOST_FALLBACK = "host_fallback"    # native per-key read path
STAGE_ROW_ASSEMBLY = "row_assembly"      # winner-row flat-row assembly

# Literal per-(op, stage) histogram names: kept literal (not composed)
# so the metric-names lint pass covers every family of the attribution
# namespace at its construction site.
_WRITE_STAGE_HISTOGRAMS = {
    STAGE_CLIENT_QUEUE: "serve_path_write_client_queue_ms",
    STAGE_WIRE_ENCODE: "serve_path_write_wire_encode_ms",
    STAGE_WIRE_TRANSFER: "serve_path_write_wire_transfer_ms",
    STAGE_RPC_QUEUE: "serve_path_write_rpc_queue_ms",
    STAGE_RAFT_REPLICATE: "serve_path_write_raft_replicate_ms",
    STAGE_WAL_FSYNC: "serve_path_write_wal_fsync_ms",
    STAGE_APPLY: "serve_path_write_apply_ms",
    STAGE_SERVER_OTHER: "serve_path_write_server_other_ms",
}
_READ_STAGE_HISTOGRAMS = {
    STAGE_WIRE_ENCODE: "serve_path_multi_read_wire_encode_ms",
    STAGE_WIRE_TRANSFER: "serve_path_multi_read_wire_transfer_ms",
    STAGE_RPC_QUEUE: "serve_path_multi_read_rpc_queue_ms",
    STAGE_DEVICE_DISPATCH: "serve_path_multi_read_device_dispatch_ms",
    STAGE_HOST_FALLBACK: "serve_path_multi_read_host_fallback_ms",
    STAGE_ROW_ASSEMBLY: "serve_path_multi_read_row_assembly_ms",
    STAGE_SERVER_OTHER: "serve_path_multi_read_server_other_ms",
}
_E2E_HISTOGRAMS = {
    OP_WRITE: "serve_path_write_e2e_ms",
    OP_MULTI_READ: "serve_path_multi_read_e2e_ms",
}
_STAGE_TABLES = {
    OP_WRITE: _WRITE_STAGE_HISTOGRAMS,
    OP_MULTI_READ: _READ_STAGE_HISTOGRAMS,
}


@ybsan.shadow(stages=ybsan.SINGLE_WRITER_PER_KEY)
class LatencyBudget:
    """One op's wall clock, split into named disjoint stage slices.

    `stages` maps stage name -> accumulated milliseconds. Mutations are
    single dict-item writes (GIL-atomic) with one writer thread per
    stage — no lock, by acceptance-criteria design. `trace_id` is the
    op's root trace id, stamped where the wire encode happens (the
    trace context is live there) and attached as the e2e histogram
    exemplar at finalize.
    """

    __slots__ = ("op", "t0", "stages", "trace_id")

    def __init__(self, op: str, t0: Optional[float] = None):
        self.op = op
        self.t0 = time.monotonic() if t0 is None else t0
        self.stages: Dict[str, float] = {}
        self.trace_id: Optional[str] = None

    def record(self, stage: str, ms: float) -> None:
        if ms <= 0.0:
            return
        cur = self.stages.get(stage)
        self.stages[stage] = ms if cur is None else cur + ms

    def merge(self, stage_map) -> None:
        """Fold a wire-carried stage map (the response's `lat` value)
        into this budget. Wire data: tolerate any malformed entry."""
        if not isinstance(stage_map, dict):
            return
        for k, v in stage_map.items():
            if isinstance(k, str) and isinstance(v, (int, float)) \
                    and not isinstance(v, bool):
                self.record(k, float(v))

    def elapsed_ms(self) -> float:
        return (time.monotonic() - self.t0) * 1e3

    def measured_ms(self) -> float:
        return sum(self.stages.values())

    def to_wire(self) -> Dict[str, float]:
        return {k: round(v, 4) for k, v in self.stages.items()}


_BUDGET_VAR: "contextvars.ContextVar[Optional[LatencyBudget]]" = \
    contextvars.ContextVar("ybtpu_latency_budget", default=None)


def current_budget() -> Optional[LatencyBudget]:
    return _BUDGET_VAR.get()


def record_stage(stage: str, ms: float) -> None:
    """Record into the ambient budget, if any. The no-budget fast path
    is one contextvar read + an is-None check."""
    b = _BUDGET_VAR.get()
    if b is not None:
        b.record(stage, ms)


def use_budget(budget: Optional[LatencyBudget]):
    """Install `budget` as the ambient budget; returns the reset token.
    (The server handler path, which must NOT finalize — the budget's
    stage map rides the response back to the owning client.)"""
    return _BUDGET_VAR.set(budget)


def clear_budget(token) -> None:
    _BUDGET_VAR.reset(token)


class budget_scope:
    """Client-side scope: installs a fresh LatencyBudget for the with
    block and, on SUCCESSFUL exit, closes the decomposition and feeds
    the serve_path histograms. A failed op (exception propagating)
    records nothing — its wall time includes retry/timeout semantics
    the stage vocabulary does not describe."""

    __slots__ = ("budget", "_token")

    def __init__(self, op: str, t0: Optional[float] = None):
        self.budget = LatencyBudget(op, t0)

    def __enter__(self) -> LatencyBudget:
        self._token = _BUDGET_VAR.set(self.budget)
        return self.budget

    def __exit__(self, exc_type, exc, tb):
        _BUDGET_VAR.reset(self._token)
        if exc_type is None:
            finalize_budget(self.budget)
        return False


_STAGE_HELP = ("serve-path attribution: milliseconds this op spent in "
               "the stage (see README 'Telemetry timebase')")


def finalize_budget(budget: LatencyBudget) -> None:
    """Close the decomposition (wire_transfer residual) and aggregate
    the budget into the per-stage serve_path histograms; the e2e
    observation carries the op's trace id as exemplar."""
    table = _STAGE_TABLES.get(budget.op)
    if table is None:
        return
    e2e = budget.elapsed_ms()
    if e2e <= 0.0:
        return
    residual = e2e - budget.measured_ms()
    if residual > 0.0:
        budget.record(STAGE_WIRE_TRANSFER, residual)
    ent = _metrics.serve_path_metrics()
    for stage, ms in budget.stages.items():
        name = table.get(stage)
        if name is not None:
            ent.histogram(name, _STAGE_HELP).increment(ms)
    ent.histogram(_E2E_HISTOGRAMS[budget.op],
                  "serve-path attribution: measured end-to-end op wall "
                  "time; sums the per-stage histograms within clamp "
                  "slack").increment(e2e, exemplar=budget.trace_id)


def serve_path_attribution_page() -> Dict[str, object]:
    """The /servez attribution block: per op, the e2e summary plus each
    stage's share of total e2e time (percentages computed from the
    histogram sums, so they answer 'where did the path's time go' over
    the server's lifetime) with trace-id exemplars on e2e."""
    ent = _metrics.serve_path_metrics()
    out: Dict[str, object] = {}
    for op, table in _STAGE_TABLES.items():
        e2e_h = ent.histogram(_E2E_HISTOGRAMS[op])
        e2e = e2e_h.snapshot_dict()
        total = float(e2e.get("sum") or 0.0)
        stages = {}
        for stage, name in table.items():
            h = ent.histogram(name, _STAGE_HELP)
            snap = h.snapshot_dict()
            snap.pop("exemplars", None)
            snap["pct_of_e2e"] = (round(100.0 * float(snap["sum"]) / total, 2)
                                  if total > 0 else 0.0)
            stages[stage] = snap
        out[op] = {"e2e": e2e, "stages": stages}
    return out
