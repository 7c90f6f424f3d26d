"""Metrics: counters, gauges, histograms.

The port's copy of yugabyte_tpu/utils/metrics.py (device-free there too),
with the metric names unchanged, so a reader of either package's registry
finds the same series.

The reference metric system's counters, gauges and histograms (ref:
src/yb/util/metrics.h: Counter, AtomicGauge :713, Histogram). Entities
(server/table/tablet) each own their metrics in a MetricRegistry. The JSON
and Prometheus exposition (`registries_to_json_obj`,
`registries_to_prometheus`) serve the tablet server's webserver, which
merges its own registry with the process ROOT_REGISTRY.

Naming convention (enforced by tools/lint_metric_names.py in tier-1):
snake_case, with a unit suffix — counters end `_total`; histograms end
`_ms`/`_us`/`_bytes`/`_rows`; gauges end in a unit or count suffix. This
keeps the namespace scrapeable as the instrumented surface grows.
"""

from __future__ import annotations

import contextlib
import json
import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple


class Counter:
    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0
        self._lock = threading.Lock()

    def increment(self, by: int = 1) -> None:
        with self._lock:
            self._value += by

    def value(self) -> int:
        return self._value


class Gauge:
    __slots__ = ("name", "help", "_value", "_lock")

    def __init__(self, name: str, help: str = "", initial: float = 0.0):
        self.name = name
        self.help = help
        self._value = initial
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def increment(self, by: float = 1.0) -> None:
        with self._lock:
            self._value += by

    def decrement(self, by: float = 1.0) -> None:
        self.increment(-by)

    def value(self) -> float:
        return self._value


class Histogram:
    """Log-bucketed histogram (2% default precision), like the reference's HdrHistogram.

    Observations may carry an *exemplar* — an opaque reference (here: a
    trace id) tying a recorded value back to its origin. Exemplar storage
    is bounded: the `_EXEMPLAR_KEEP` most recent plus the one attached to
    the largest observation so far, so a p99 outlier on /servez stays
    click-through to /tracez no matter how much traffic followed it.
    Exemplars surface ONLY in the JSON exposition: the classic Prometheus
    text format 0.0.4 has no exemplar syntax, so keeping them out of
    `to_prometheus` is what keeps exemplar-bearing histograms
    grammar-valid there.
    """

    _EXEMPLAR_KEEP = 5

    __slots__ = ("name", "help", "_counts", "_lock", "_total_sum", "_total_count",
                 "_min", "_max", "_growth", "_exemplars", "_max_exemplar")

    def __init__(self, name: str, help: str = "", growth: float = 1.02):
        self.name = name
        self.help = help
        self._growth = math.log(growth)
        self._counts: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._total_sum = 0.0
        self._total_count = 0
        self._min = math.inf
        self._max = -math.inf
        self._exemplars: List[Dict[str, object]] = []
        self._max_exemplar: Optional[Dict[str, object]] = None

    def _bucket(self, v: float) -> int:
        if v <= 0:
            return -1
        return int(math.log(v) / self._growth)

    def increment(self, v: float, exemplar: Optional[str] = None) -> None:
        b = self._bucket(v)
        with self._lock:
            self._counts[b] = self._counts.get(b, 0) + 1
            self._total_sum += v
            self._total_count += 1
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if exemplar is not None:
                ex = {"value": v, "trace_id": exemplar}
                self._exemplars.append(ex)
                if len(self._exemplars) > self._EXEMPLAR_KEEP:
                    del self._exemplars[0]
                if self._max_exemplar is None or v >= self._max_exemplar["value"]:
                    self._max_exemplar = ex

    def exemplars(self) -> List[Dict[str, object]]:
        """Bounded exemplar snapshot: recent observations first, the
        max-valued one guaranteed present (it may also be recent)."""
        with self._lock:
            out = list(self._exemplars)
            if self._max_exemplar is not None and self._max_exemplar not in out:
                out.append(self._max_exemplar)
            return out

    def percentile(self, p: float) -> float:
        with self._lock:
            if self._total_count == 0:
                return 0.0
            target = p / 100.0 * self._total_count
            seen = 0
            for b in sorted(self._counts):
                seen += self._counts[b]
                if seen >= target:
                    return math.exp((b + 0.5) * self._growth) if b >= 0 else 0.0
            return self._max

    def mean(self) -> float:
        return self._total_sum / self._total_count if self._total_count else 0.0

    def snapshot_dict(self) -> Dict[str, object]:
        """JSON-ready point-in-time summary (observability pages that
        render one histogram inline rather than a whole registry)."""
        out = {
            "count": self.count(), "sum": round(self._total_sum, 3),
            "mean": round(self.mean(), 3), "min": self.min(),
            "max": self.max(),
            "p50": round(self.percentile(50), 3),
            "p95": round(self.percentile(95), 3),
            "p99": round(self.percentile(99), 3),
        }
        ex = self.exemplars()
        if ex:
            out["exemplars"] = ex
        return out

    def count(self) -> int:
        return self._total_count

    def min(self) -> float:
        return self._min if self._total_count else 0.0

    def max(self) -> float:
        return self._max if self._total_count else 0.0


@contextlib.contextmanager
def timed_ms(hist: Histogram):
    """Record the wall time of a with-block into `hist`, in milliseconds."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        hist.increment((time.monotonic() - t0) * 1e3)


class MetricEntity:
    """One metric-owning entity: a server, table, or tablet (ref: metrics.h entities)."""

    def __init__(self, entity_type: str, entity_id: str, attributes: Optional[Dict[str, str]] = None):
        self.entity_type = entity_type
        self.entity_id = entity_id
        self.attributes = attributes or {}
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, lambda: Counter(name, help))

    def gauge(self, name: str, help: str = "", initial: float = 0.0) -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name, help, initial))

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get_or_create(name, lambda: Histogram(name, help))

    def _get_or_create(self, name, factory):
        with self._lock:
            if name not in self._metrics:
                self._metrics[name] = factory()
            return self._metrics[name]

    def metrics_snapshot(self) -> Dict[str, object]:
        """Point-in-time copy of the entity's metric map (observability
        pages that enumerate dynamically-named counters)."""
        with self._lock:
            return dict(self._metrics)


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label-value escaping: backslash, double
    quote and newline (tablet attributes can contain any of them today)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(v: str) -> str:
    """HELP-line escaping: backslash and newline."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _label_str(labels: Dict[str, str]) -> str:
    return ",".join(f'{k}="{_escape_label_value(v)}"'
                    for k, v in labels.items())


class MetricRegistry:
    def __init__(self):
        self._entities: Dict[str, MetricEntity] = {}
        self._lock = threading.Lock()

    def entity(self, entity_type: str, entity_id: str,
               attributes: Optional[Dict[str, str]] = None) -> MetricEntity:
        key = f"{entity_type}:{entity_id}"
        with self._lock:
            if key not in self._entities:
                self._entities[key] = MetricEntity(entity_type, entity_id, attributes)
            return self._entities[key]

    def _snapshot(self):
        with self._lock:
            ents = list(self._entities.values())
        out = []
        for ent in ents:
            with ent._lock:
                out.append((ent, list(ent._metrics.values())))
        return out

    def to_json(self) -> str:
        return json.dumps(registries_to_json_obj([self]), indent=1)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (ref: metrics.h WriteForPrometheus :449-518)."""
        return registries_to_prometheus([self])


def registries_to_json_obj(registries: Iterable[MetricRegistry]) -> list:
    seen = set()
    out = []
    for reg in registries:
        if id(reg) in seen:
            continue
        seen.add(id(reg))
        for ent, ent_metrics in reg._snapshot():
            metrics = []
            for m in ent_metrics:
                if isinstance(m, Histogram):
                    entry = {
                        "name": m.name, "total_count": m.count(), "mean": m.mean(),
                        "min": m.min(), "max": m.max(),
                        "percentile_50": m.percentile(50),
                        "percentile_95": m.percentile(95), "percentile_99": m.percentile(99),
                    }
                    ex = m.exemplars()
                    if ex:
                        entry["exemplars"] = ex
                    metrics.append(entry)
                else:
                    metrics.append({"name": m.name, "value": m.value()})
            out.append({"type": ent.entity_type, "id": ent.entity_id,
                        "attributes": ent.attributes, "metrics": metrics})
    return out


def registries_to_prometheus(registries: Iterable[MetricRegistry]) -> str:
    """Valid Prometheus text-format exposition over one or more registries.

    Grammar obligations the naive per-entity dump violated (and the
    exposition test now enforces line-by-line):
      - every metric FAMILY gets exactly one `# TYPE` line, emitted before
        any of its samples, even when the same name appears under many
        entities (or several registries);
      - label values are escaped (quotes, backslashes, newlines);
      - histograms expose as summaries (quantile samples + _sum/_count)
        plus separate `<name>_min`/`<name>_max` gauge families (a summary
        family itself may only carry the quantile/_sum/_count samples);
      - histogram exemplars are NOT emitted here: text format 0.0.4 has
        no exemplar syntax (`# {...}` trailers are an OpenMetrics-only
        extension), so exemplar-bearing histograms expose exactly like
        plain ones and the output stays grammar-valid. Exemplars ride
        the JSON exposition (`registries_to_json_obj`) instead.
    """
    # family name -> (type, help, [sample lines])
    families: "Dict[str, Tuple[str, str, List[str]]]" = {}
    order: List[str] = []

    def fam(name: str, mtype: str, help: str) -> List[str]:
        if name not in families:
            families[name] = (mtype, help, [])
            order.append(name)
        return families[name][2]

    seen = set()
    for reg in registries:
        if id(reg) in seen:
            continue  # the webserver merges the per-server registry with
        seen.add(id(reg))  # the process ROOT_REGISTRY; never dump one twice
        for ent, ent_metrics in reg._snapshot():
            labels = {"metric_type": ent.entity_type,
                      "metric_id": ent.entity_id}
            labels.update(ent.attributes)
            ls = _label_str(labels)
            for m in ent_metrics:
                if isinstance(m, Histogram):
                    lines = fam(m.name, "summary", m.help)
                    for p in (50, 95, 99):
                        lines.append(f'{m.name}{{{ls},quantile="0.{p}"}} '
                                     f'{m.percentile(p)}')
                    lines.append(f"{m.name}_sum{{{ls}}} {m._total_sum}")
                    lines.append(f"{m.name}_count{{{ls}}} {m.count()}")
                    fam(f"{m.name}_min", "gauge",
                        f"minimum observed {m.name}").append(
                        f"{m.name}_min{{{ls}}} {m.min()}")
                    fam(f"{m.name}_max", "gauge",
                        f"maximum observed {m.name}").append(
                        f"{m.name}_max{{{ls}}} {m.max()}")
                else:
                    mtype = "counter" if isinstance(m, Counter) else "gauge"
                    prior = families.get(m.name)
                    if prior is not None and prior[0] != mtype:
                        mtype = "untyped"  # conflicting kinds across entities
                        families[m.name] = (mtype, prior[1], prior[2])
                    fam(m.name, mtype, m.help).append(
                        f"{m.name}{{{ls}}} {m.value()}")
    out: List[str] = []
    for name in order:
        mtype, help, lines = families[name]
        if help:
            out.append(f"# HELP {name} {_escape_help(help)}")
        out.append(f"# TYPE {name} {mtype}")
        out.extend(lines)
    return "\n".join(out) + "\n"


ROOT_REGISTRY = MetricRegistry()


def kernel_metrics() -> MetricEntity:
    """The process-wide entity every kernel dispatch site records into
    (ops/ code has no server registry in scope; the webserver merges
    ROOT_REGISTRY into each server's exposition)."""
    return ROOT_REGISTRY.entity("server", "kernels")


def serve_path_metrics() -> MetricEntity:
    """The process-wide entity of the batched serve path: group-commit
    writes (tablet/tablet.py), client-batcher coalescing, and
    follower-read gating (tablet/tablet_peer.py). Surfaced as the
    serve-path block on /servez."""
    return ROOT_REGISTRY.entity("server", "serve_path")


def serve_path_snapshot() -> Dict[str, object]:
    """JSON-ready snapshot of the serve-path counters/histograms for
    /servez: group-commit totals + batch-size distribution + follower-
    read accept/reject accounting."""
    e = serve_path_metrics()
    batch = e.histogram("write_batch_rows",
                        "rows per group-committed write batch")
    return {
        "write_group_commit_total": e.counter(
            "write_group_commit_total",
            "write batches replicated as ONE raft entry").value(),
        "write_batch_coalesced_ops_total": e.counter(
            "write_batch_coalesced_ops_total",
            "ops that rode a multi-op group commit").value(),
        "write_batch_rows": {
            "count": batch.count(), "mean": round(batch.mean(), 2),
            "max": batch.max(),
            "p50": round(batch.percentile(50), 1),
            "p99": round(batch.percentile(99), 1)},
        "follower_reads_total": e.counter(
            "follower_reads_total",
            "reads served by a vouched follower replica").value(),
        "follower_read_unvouched_rejects_total": e.counter(
            "follower_read_unvouched_rejects_total",
            "follower reads refused because the replica holds no live "
            "digest vouch").value(),
        "follower_read_vouches_total": e.counter(
            "follower_read_vouches_total",
            "digest-exchange vouches granted to this server's "
            "replicas").value(),
    }


def publish_compile_surface(counts: Dict[str, int]) -> None:
    """Per-kernel-family compile-surface gauges from the committed
    manifest (tools/analysis/kernel_manifest.json): how many distinct
    executables each family's declared bucket lattice mints. Reported
    next to the compile_bucket hit/miss counters so a bench run (or
    /metrics scrape) can prove the warm cache covers exactly the
    manifest surface — misses beyond the surface mean the lattice has
    sprung a leak."""
    e = kernel_metrics()
    total = 0
    for family, n in sorted(counts.items()):
        e.gauge(f"kernel_compile_surface_{family}_buckets_count",
                f"declared compile-surface executables of the {family} "
                "kernel family (committed manifest)").set(n)
        total += n
    e.gauge("kernel_compile_surface_buckets_count",
            "declared compile-surface executables across all kernel "
            "families (committed manifest)").set(total)


_PIPELINE_STAGES = ("host", "device", "write", "shadow", "decode",
                    "encode")


def record_pipeline_stage(stage: str, ms: float) -> None:
    """One slice of compaction-pipeline wall time: `stage` is where the
    time went — 'host' (raw-byte ingest + column packing + decision
    decode), 'device' (kernel compute + H2D/D2H transfer waits),
    'write' (SST output I/O), 'shadow' (sampled oracle verification),
    'decode' (device block-codec ingest: raw-word upload + decode
    dispatch) or 'encode' (device block-codec output: span encode
    dispatch + download + block assembly). Per-stage histograms plus
    a cumulative-ms gauge feed /compactionz and bench.py's stage report,
    so a stalled pipeline shows WHICH stage is the bottleneck."""
    e = kernel_metrics()
    e.histogram(f"compaction_pipeline_stage_{stage}_ms",
                f"compaction pipeline {stage}-stage wall time per "
                "slice").increment(max(ms, 0.0))
    e.gauge(f"compaction_pipeline_stage_{stage}_total_ms",
            f"cumulative compaction pipeline {stage}-stage wall "
            "time").increment(max(ms, 0.0))


def pipeline_stage_totals() -> Dict[str, float]:
    """Cumulative per-stage pipeline milliseconds (host/device/write) —
    the snapshot bench.py diffs around a run to report where the wall
    time of the offloaded compactions went."""
    e = kernel_metrics()
    return {s: float(e.gauge(
        f"compaction_pipeline_stage_{s}_total_ms").value())
        for s in _PIPELINE_STAGES}


def record_kernel_dispatch(kind: str, n_rows: int, n_pad: int,
                           duration_ms: Optional[float] = None) -> None:
    """One kernel dispatch: invocation counter, wall-time histogram,
    batch-size histogram, and the padding-waste gauges the shape-bucketing
    design makes interesting (padded slots are pure device work). `kind`
    is the kernel family, e.g. 'kernel_merge_gc' / 'kernel_scan'."""
    e = kernel_metrics()
    e.counter(kind + "_dispatch_total",
              f"{kind} device dispatches").increment()
    if duration_ms is not None:
        e.histogram(kind + "_duration_ms",
                    f"{kind} dispatch wall time").increment(duration_ms)
    e.histogram(kind + "_batch_rows",
                f"{kind} real rows per dispatch").increment(max(n_rows, 1))
    e.gauge("kernel_batch_rows",
            "real rows in the most recent kernel dispatch").set(n_rows)
    e.gauge("kernel_pad_waste_rows",
            "padded-but-dead rows in the most recent kernel dispatch "
            "(shape-bucket overhead)").set(max(0, n_pad - n_rows))
