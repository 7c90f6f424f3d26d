"""In-process time-series history: the telemetry timebase.

Counterpart of yugabyte_tpu/utils/timeseries.py, with the imports
renamed.

Every observability surface before this module (/servez, /healthz,
/compactionz, /rpcz) is a point-in-time snapshot — a counter tells you
the total, never the RATE, and a regression between two moments is
invisible unless someone happened to scrape both. `TimeSeriesStore`
closes that gap in-process: a sampler thread self-scrapes the process
metric registries plus a set of pluggable snapshot sources (bucket
health, overload, device cache, compaction pool) every
`--timeseries_interval_s` (default 5s) into per-metric ring buffers of
`(wall_ts, value)` points.

Memory is PROVABLY bounded (acceptance criterion, asserted in
tests/test_telemetry.py): each ring holds at most
`--timeseries_ring_capacity` points in two preallocated fixed-size
lists, and the number of rings is capped at `--timeseries_max_metrics`
(series beyond the cap are dropped and counted, never grown) — so the
whole store holds at most `ring_capacity x metric_count` points.

Reads are snapshot-based: scrape sources take their own snapshots
(registry JSON dumps, board snapshots) and the store's lock guards only
its private ring map — nothing on the serve hot path ever takes or
waits on it (acceptance: zero new locks on the hot path).

Queries: `window` (raw points), `delta`/`rate` (counter movement over a
trailing window), and `page()` — the `/timeseriesz` JSON: per metric
the raw window, the rate over the window, and a sparkline-ready
downsample. `bench_snapshot()` is the compact form every bench round
embeds.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from yugabyte_tpu_torch.utils import flags
from yugabyte_tpu_torch.utils import lock_rank
from yugabyte_tpu_torch.utils import ybsan
from yugabyte_tpu_torch.utils.metrics import (ROOT_REGISTRY, MetricRegistry,
                                        registries_to_json_obj)
from yugabyte_tpu_torch.utils.trace import TRACE

flags.define_flag("timeseries_interval_s", 5.0,
                  "sampler period of the in-process time-series store "
                  "(seconds between self-scrapes)")
flags.define_flag("timeseries_ring_capacity", 240,
                  "points retained per metric series (ring buffer; at "
                  "the default 5s interval, 240 points = 20 minutes)")
flags.define_flag("timeseries_max_metrics", 1024,
                  "hard cap on distinct series the store will track; "
                  "series beyond it are dropped and counted, so store "
                  "memory stays bounded at capacity x max_metrics")


@ybsan.shadow(_n=ybsan.PUBLISHER_CONSUMER, _i=ybsan.PUBLISHER_CONSUMER)
class _Ring:
    """Fixed-capacity (ts, value) ring. Preallocated lists, so a ring's
    memory is its capacity regardless of how long the sampler runs.
    Cursor discipline (shadowed above): the sampler thread publishes
    `_i`/`_n` under the store lock; every reader must be HB-after the
    publishing write (it is — readers take the same tracked lock)."""

    __slots__ = ("cap", "_ts", "_vals", "_n", "_i")

    def __init__(self, cap: int):
        self.cap = max(2, int(cap))
        self._ts = [0.0] * self.cap
        self._vals = [0.0] * self.cap
        self._n = 0
        self._i = 0

    def push(self, ts: float, v: float) -> None:
        self._ts[self._i] = ts
        self._vals[self._i] = v
        self._i = (self._i + 1) % self.cap
        if self._n < self.cap:
            self._n += 1

    def __len__(self) -> int:
        return self._n

    def points(self) -> List[Tuple[float, float]]:
        """Chronological [(ts, value)] copy."""
        if self._n < self.cap:
            idx = range(self._n)
        else:
            idx = [(self._i + k) % self.cap for k in range(self.cap)]
        return [(self._ts[j], self._vals[j]) for j in idx]


def _downsample(vals: List[float], n: int) -> List[float]:
    """Sparkline-ready downsample: bucket means, at most n points."""
    if len(vals) <= n:
        return list(vals)
    out = []
    step = len(vals) / n
    for k in range(n):
        lo, hi = int(k * step), max(int((k + 1) * step), int(k * step) + 1)
        chunk = vals[lo:hi]
        out.append(sum(chunk) / len(chunk))
    return out


class TimeSeriesStore:
    """Bounded ring-buffer sampler over pluggable snapshot sources."""

    def __init__(self, interval_s: Optional[float] = None,
                 capacity: Optional[int] = None,
                 max_metrics: Optional[int] = None):
        self.interval_s = float(interval_s if interval_s is not None
                                else flags.get_flag("timeseries_interval_s"))
        self.capacity = int(capacity if capacity is not None
                            else flags.get_flag("timeseries_ring_capacity"))
        self.max_metrics = int(
            max_metrics if max_metrics is not None
            else flags.get_flag("timeseries_max_metrics"))
        self._lock = lock_rank.tracked(threading.Lock(),
                                       "timeseries._lock")
        self._rings: Dict[str, _Ring] = {}      # guarded-by: _lock
        self._sources: List[Tuple[str, Callable[[], Dict[str, float]]]] = []  # guarded-by: _lock
        self._samples = 0                       # guarded-by: _lock
        self._sample_ms_total = 0.0             # guarded-by: _lock
        self._scrape_errors = 0                 # guarded-by: _lock
        self._dropped_series = 0                # guarded-by: _lock
        self._starts = 0                        # guarded-by: _lock
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock
        self._stop_evt = threading.Event()
        self._started_t: Optional[float] = None

    # ---- sources -----------------------------------------------------

    def register_source(self, label: str,
                        fn: Callable[[], Dict[str, float]]) -> None:
        """Register a snapshot source: a callable returning a flat
        {series_name: numeric} dict. Idempotent per label (a MiniCluster
        restarts servers; the new server's source replaces the old)."""
        with self._lock:
            self._sources = [(l, f) for (l, f) in self._sources
                             if l != label] + [(label, fn)]

    def register_registry(self, label: str, registry: MetricRegistry) -> None:
        """Scrape a metric registry as a source: counters/gauges become
        value series; histograms become `.count` and `.sum` series (the
        pair a rate query turns into observations/s and mean-ms-rate).
        Only server-scoped entities are sampled — per-tablet entities
        would multiply the series count per tablet."""

        def _scrape() -> Dict[str, float]:
            out: Dict[str, float] = {}
            for ent in registries_to_json_obj([registry]):
                if ent["type"] != "server":
                    continue
                eid = ent["id"]
                for m in ent["metrics"]:
                    name = f"{eid}.{m['name']}"
                    if "value" in m:
                        out[name] = m["value"]
                    else:
                        cnt = m.get("total_count", 0)
                        out[f"{name}.count"] = cnt
                        out[f"{name}.sum"] = m.get("mean", 0.0) * cnt
            return out

        self.register_source(label, _scrape)

    # ---- sampling ----------------------------------------------------

    def sample_once(self) -> int:
        """One self-scrape of every source into the rings. Returns the
        number of series sampled. Source snapshots run OUTSIDE the
        store lock; only the ring pushes hold it."""
        t0 = time.monotonic()
        wall = time.time()
        with self._lock:
            sources = list(self._sources)
        vals: Dict[str, float] = {}
        for label, fn in sources:
            try:
                d = fn()
            except Exception as e:  # yblint: contained(one broken scrape source must not kill the sampler; that source's series go stale, the failure is TRACEd and counted, every other source still samples)
                TRACE("timeseries: source %s scrape failed: %s", label, e)
                with self._lock:
                    self._scrape_errors += 1
                continue
            for k, v in (d or {}).items():
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    continue
                vals[f"{label}.{k}"] = float(v)
        with self._lock:
            for name, v in vals.items():
                r = self._rings.get(name)
                if r is None:
                    if len(self._rings) >= self.max_metrics:
                        self._dropped_series += 1
                        continue
                    r = _Ring(self.capacity)
                    self._rings[name] = r
                r.push(wall, v)
            self._samples += 1
            dur_ms = (time.monotonic() - t0) * 1e3
            self._sample_ms_total += dur_ms
        ent = ROOT_REGISTRY.entity("server", "timeseries")
        ent.counter("timeseries_samples_total",
                    "self-scrape ticks taken by the time-series "
                    "sampler").increment()
        ent.histogram("timeseries_sample_duration_ms",
                      "wall time of one time-series self-scrape tick "
                      "(the sampler-overhead budget: <1% of the "
                      "interval)").increment(dur_ms)
        return len(vals)

    # ---- sampler thread ----------------------------------------------

    def start(self, interval_s: Optional[float] = None) -> None:
        """Start (or ref-count a running) sampler thread. Multiple
        in-process servers share the store; the thread stops when every
        starter has called stop()."""
        with self._lock:
            self._starts += 1
            if self._thread is not None:
                return
            if interval_s is not None:
                self.interval_s = float(interval_s)
            self._stop_evt = threading.Event()
            if self._started_t is None:
                self._started_t = time.monotonic()
            t = threading.Thread(target=self._run, args=(self._stop_evt,),
                                 name="timeseries-sampler", daemon=True)
            self._thread = t
        t.start()

    def stop(self) -> None:
        with self._lock:
            if self._starts > 0:
                self._starts -= 1
            if self._starts > 0 or self._thread is None:
                return
            t, self._thread = self._thread, None
            evt = self._stop_evt
        evt.set()
        t.join(timeout=5.0)

    def stop_all(self) -> None:
        """Unconditional stop (test teardown / process shutdown)."""
        with self._lock:
            self._starts = 0
            t, self._thread = self._thread, None
            evt = self._stop_evt
        evt.set()
        if t is not None:
            t.join(timeout=5.0)

    def _run(self, stop_evt: threading.Event) -> None:
        while not stop_evt.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception as e:  # yblint: contained(the sampler is observability-only: a failed tick is TRACEd and the next tick proceeds; it must never terminate the thread or surface into a serving path)
                TRACE("timeseries: sample tick failed: %s", e)

    # ---- queries -----------------------------------------------------

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def window(self, name: str,
               window_s: Optional[float] = None) -> List[Tuple[float, float]]:
        """Chronological (ts, value) points of one series, optionally
        trimmed to the trailing `window_s` seconds."""
        with self._lock:
            r = self._rings.get(name)
            pts = r.points() if r is not None else []
        if window_s is not None and pts:
            cutoff = pts[-1][0] - window_s
            pts = [p for p in pts if p[0] >= cutoff]
        return pts

    def delta(self, name: str, window_s: Optional[float] = None) -> float:
        """Value movement over the trailing window (last - first)."""
        pts = self.window(name, window_s)
        if len(pts) < 2:
            return 0.0
        return pts[-1][1] - pts[0][1]

    def rate(self, name: str, window_s: Optional[float] = None) -> float:
        """Counter rate per second over the trailing window."""
        pts = self.window(name, window_s)
        if len(pts) < 2:
            return 0.0
        (t0, v0), (t1, v1) = pts[0], pts[-1]
        if t1 <= t0:
            return 0.0
        return (v1 - v0) / (t1 - t0)

    # ---- bounds & overhead -------------------------------------------

    def metric_count(self) -> int:
        with self._lock:
            return len(self._rings)

    def total_points(self) -> int:
        with self._lock:
            return sum(len(r) for r in self._rings.values())

    def memory_bound_points(self) -> int:
        """The store's provable point bound: ring capacity x metric
        count (and metric count itself is capped at max_metrics)."""
        return self.capacity * self.metric_count()

    def overhead_ratio(self) -> float:
        """Fraction of wall time spent sampling since start — the <1%
        acceptance number bench.py snapshots on the YCSB rung."""
        with self._lock:
            total_ms = self._sample_ms_total
            t0 = self._started_t
        if t0 is None:
            return 0.0
        elapsed = time.monotonic() - t0
        return (total_ms / 1e3) / elapsed if elapsed > 0 else 0.0

    # ---- exposition --------------------------------------------------

    def page(self, window_s: Optional[float] = None,
             spark_points: int = 40) -> Dict[str, object]:
        """The /timeseriesz JSON: store meta plus, per series, the raw
        window, the rate over it, and a sparkline downsample."""
        with self._lock:
            rings = {name: r.points() for name, r in self._rings.items()}
            meta = {
                "interval_s": self.interval_s,
                "ring_capacity": self.capacity,
                "max_metrics": self.max_metrics,
                "metric_count": len(rings),
                "samples_total": self._samples,
                "scrape_errors_total": self._scrape_errors,
                "dropped_series_total": self._dropped_series,
                "sample_ms_total": round(self._sample_ms_total, 3),
            }
        meta["memory_bound_points"] = meta["ring_capacity"] * meta["metric_count"]
        meta["sampler_overhead_ratio"] = round(self.overhead_ratio(), 6)
        metrics: Dict[str, object] = {}
        for name in sorted(rings):
            pts = rings[name]
            if window_s is not None and pts:
                cutoff = pts[-1][0] - window_s
                pts = [p for p in pts if p[0] >= cutoff]
            rate = 0.0
            if len(pts) >= 2 and pts[-1][0] > pts[0][0]:
                rate = (pts[-1][1] - pts[0][1]) / (pts[-1][0] - pts[0][0])
            metrics[name] = {
                "points": len(pts),
                "last": pts[-1][1] if pts else None,
                "window": [[round(t, 3), v] for t, v in pts],
                "rate_per_s": rate,
                "spark": _downsample([v for _, v in pts], spark_points),
            }
        meta["metrics"] = metrics
        return meta

    def bench_snapshot(self, spark_points: int = 16) -> Dict[str, object]:
        """Compact store snapshot every bench round embeds: the meta
        block plus per-series last value + rate (no raw windows)."""
        page = self.page(spark_points=spark_points)
        out = {k: v for k, v in page.items() if k != "metrics"}
        out["series"] = {
            name: {"last": m["last"], "rate_per_s": round(m["rate_per_s"], 4)}
            for name, m in page["metrics"].items()}
        return out


def _bucket_health_source() -> Dict[str, float]:
    """Per-state key counts of the process bucket-health board (the
    flap signal /healthz's point snapshot cannot show over time)."""
    from yugabyte_tpu_torch.storage.bucket_health import health_board
    snap = health_board().snapshot()
    out: Dict[str, float] = {}
    for state, n in (snap.get("states") or {}).items():
        out[f"state_{state}.count"] = float(n)
    out["keys.count"] = float(len(snap.get("keys") or ()))
    for name, n in (snap.get("counters") or {}).items():
        out[f"{name}.total"] = float(n)
    return out


_STORE: Optional[TimeSeriesStore] = None  # guarded-by: _STORE_LOCK
_STORE_LOCK = threading.Lock()


def timeseries_store() -> TimeSeriesStore:
    """Process-wide store (one sampler per process; every in-process
    server registers its registry/sources onto it). Pre-registered
    sources: ROOT_REGISTRY (kernel dispatch, serve-path attribution,
    bucket-health counters, device/run cache counters) and the
    bucket-health board state histogram."""
    global _STORE
    with _STORE_LOCK:
        if _STORE is None:
            s = TimeSeriesStore()
            s.register_registry("root", ROOT_REGISTRY)
            s.register_source("bucket_health", _bucket_health_source)
            _STORE = s
        return _STORE


def reset_timeseries_store() -> None:
    """Drop the process store (test isolation): stops any sampler
    thread and discards the rings."""
    global _STORE
    with _STORE_LOCK:
        s, _STORE = _STORE, None
    if s is not None:
        s.stop_all()
