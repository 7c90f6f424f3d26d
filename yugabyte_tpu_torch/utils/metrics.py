"""Metrics: counters, gauges, histograms.

The port's copy of yugabyte_tpu/utils/metrics.py (device-free there too),
with the metric names unchanged, so a reader of either package's registry
finds the same series.

The reference metric system's counters, gauges and histograms (ref:
src/yb/util/metrics.h: Counter, AtomicGauge :713, Histogram). Entities
(server/table/tablet) each own their metrics in a MetricRegistry. The JSON
and Prometheus exposition, and the histogram exemplars that ride it, have
no reader in the port (no server is ported) and are not copied.

Naming convention (enforced by tools/lint_metric_names.py in tier-1):
snake_case, with a unit suffix — counters end `_total`; histograms end
`_ms`/`_us`/`_bytes`/`_rows`; gauges end in a unit or count suffix. This
keeps the namespace scrapeable as the instrumented surface grows.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, Optional


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

    def value(self) -> float:
        return self._value


class Histogram:
    """Log-bucketed histogram (2% default precision), like the reference's HdrHistogram."""

    __slots__ = ("name", "help", "_counts", "_lock", "_total_count",
                 "_max", "_growth")

    def __init__(self, name: str, help: str = "", growth: float = 1.02):
        self.name = name
        self.help = help
        self._growth = math.log(growth)
        self._counts: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._total_count = 0
        self._max = -math.inf

    def _bucket(self, v: float) -> int:
        if v <= 0:
            return -1
        return int(math.log(v) / self._growth)

    def increment(self, v: float) -> None:
        b = self._bucket(v)
        with self._lock:
            self._counts[b] = self._counts.get(b, 0) + 1
            self._total_count += 1
            self._max = max(self._max, v)

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

    def count(self) -> int:
        return self._total_count

    def max(self) -> float:
        return self._max if self._total_count else 0.0


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


ROOT_REGISTRY = MetricRegistry()


def kernel_metrics() -> MetricEntity:
    """The process-wide entity every kernel dispatch site records into
    (ops/ code has no server registry in scope)."""
    return ROOT_REGISTRY.entity("server", "kernels")


def serve_path_metrics() -> MetricEntity:
    """The process-wide entity of the batched serve path: group-commit
    writes (tablet/tablet.py) and the per-stage latency budget
    (utils/latency.py)."""
    return ROOT_REGISTRY.entity("server", "serve_path")


def record_pipeline_stage(stage: str, ms: float) -> None:
    """One slice of compaction-pipeline wall time: `stage` is where the
    time went — 'host' (raw-byte ingest + column packing + decision
    decode), 'device' (kernel compute + H2D/D2H transfer waits),
    'write' (SST output I/O), 'shadow' (sampled oracle verification),
    'decode' (device block-codec ingest: raw-word upload + decode
    dispatch) or 'encode' (device block-codec output: span encode
    dispatch + download + block assembly). A per-stage histogram plus
    a cumulative-ms gauge, so a stalled pipeline shows WHICH stage is
    the bottleneck."""
    e = kernel_metrics()
    e.histogram(f"compaction_pipeline_stage_{stage}_ms",
                f"compaction pipeline {stage}-stage wall time per "
                "slice").increment(max(ms, 0.0))
    e.gauge(f"compaction_pipeline_stage_{stage}_total_ms",
            f"cumulative compaction pipeline {stage}-stage wall "
            "time").increment(max(ms, 0.0))


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
