"""Zero-dependency, thread-safe metrics registry: counters, gauges and
fixed-bucket histograms with percentile readout (port of
``sagecal_tpu/obs/metrics.py``).

- **No-op when disabled.** Until :func:`enable` installs the process
  registry, :func:`inc`, :func:`set_gauge` and :func:`observe` cost one
  attribute load and one ``is None`` test. Emit sites whose value
  conversion is itself costly (a device-to-host read) gate on
  :func:`active` first.
- **Thread-safe.** One registry lock keeps every update atomic. It is a
  plain ``threading.RLock``: the JAX package builds it through
  ``analysis.threadsan.make_rlock``, which returns that same stdlib lock
  unless the thread sanitizer is armed; the port has no sanitizer until
  ROADMAP queue A item 12 ports ``analysis/threadsan.py``.
- **Job attribution.** :func:`scope_labels` installs thread-local default
  labels (a stack). Past ``max_series`` distinct labelsets a metric folds
  new ones into ``{...: "_overflow"}``, so totals stay correct.

Histograms use fixed buckets (default: a latency ladder from 1 ms to 600
s); :meth:`Histogram.percentile` interpolates within a bucket as
``histogram_quantile`` does. :meth:`Registry.dump` gives the same JSON
snapshot as the JAX module for the same calls.
"""

from __future__ import annotations

import threading


#: default histogram ladder (seconds): latency-shaped, 1 ms .. 600 s.
#: Kept coarse on purpose — SLO readout needs p50/p90/p99 stability,
#: not microsecond resolution, and every bucket is one counter per
#: labelset forever.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                   120.0, 300.0, 600.0)

#: per-TILE latency ladder (seconds), 1 ms .. 60 s. The job-scale
#: ladder (serve.queue.JOB_SLO_BUCKETS) starts at 100 ms, which clamps
#: p50/p99 for tile-scale arrival-to-write latencies — a 5 ms tile and
#: a 95 ms tile land in the same bucket. Streaming SLO histograms
#: (stream_tile_latency_seconds) declare with THIS ladder: dense below
#: 100 ms where live-tile latency budgets actually live, capped at
#: 60 s because a tile a minute late is simply "late" (counted in
#: stream_tiles_late_total), not worth extra buckets.
TILE_LAT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.02, 0.035, 0.05,
                    0.075, 0.1, 0.15, 0.25, 0.4, 0.6, 1.0, 1.5, 2.5,
                    4.0, 6.0, 10.0, 20.0, 40.0, 60.0)

_REGISTRY = None            # module-level singleton; None = disabled

# thread-scoped default labels (serve: per-job attribution). A stack,
# so scopes nest; strictly thread-local, like diag.trace._SCOPED.
_SCOPED = threading.local()


def _scoped_labels() -> dict:
    st = getattr(_SCOPED, "stack", None)
    if not st:
        return {}
    out: dict = {}
    for d in st:
        out.update(d)
    return out


class _LabelScope:
    __slots__ = ("_labels",)

    def __init__(self, labels):
        self._labels = labels

    def __enter__(self):
        st = getattr(_SCOPED, "stack", None)
        if st is None:
            st = _SCOPED.stack = []
        st.append(self._labels)
        return self._labels

    def __exit__(self, *exc):
        _SCOPED.stack.pop()
        return False


def scope_labels(**labels):
    """Merge ``labels`` into every emission from THIS thread while the
    context is live (innermost scope wins per key). Per-job metric
    attribution for the serve scheduler; nests, never touches other
    threads, and is safe (a no-op at emit time) when disabled."""
    return _LabelScope(labels)


def _label_key(labels: dict):
    return tuple(sorted(labels.items()))


class _Metric:
    """Base: named metric holding per-labelset series.

    Cardinality bound: past ``max_series`` distinct labelsets, new
    labelsets fold into one ``_overflow`` series (every label value
    replaced) — counters keep counting, nothing is dropped."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", max_series: int = 256):
        self.name = name
        self.help = help
        self.max_series = int(max_series)
        self._series: dict = {}

    def _resolve(self, labels: dict):
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            if len(self._series) >= self.max_series:
                key = _label_key({k: "_overflow" for k in labels})
                s = self._series.get(key)
            if s is None:
                s = self._series[key] = self._new_series()
        return s

    def series(self) -> dict:
        return dict(self._series)


class Counter(_Metric):
    kind = "counter"

    def _new_series(self):
        return [0.0]

    def _inc(self, labels, value):
        if value < 0:
            raise ValueError(f"counter {self.name}: negative inc {value}")
        self._resolve(labels)[0] += value

    def value(self, **labels) -> float:
        s = self._series.get(_label_key(labels))
        return s[0] if s else 0.0

    def _dump_series(self, s):
        return s[0]


class Gauge(_Metric):
    kind = "gauge"

    def _new_series(self):
        return [0.0]

    def _set(self, labels, value):
        self._resolve(labels)[0] = value

    def value(self, **labels) -> float:
        s = self._series.get(_label_key(labels))
        return s[0] if s else 0.0

    def _dump_series(self, s):
        return s[0]


class _HistSeries:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets):
        self.counts = [0] * (n_buckets + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS,
                 max_series: int = 256):
        super().__init__(name, help, max_series)
        b = tuple(float(x) for x in buckets)
        if list(b) != sorted(b) or len(set(b)) != len(b):
            raise ValueError(f"histogram {name}: buckets must be "
                             f"strictly increasing, got {b}")
        self.buckets = b

    def _new_series(self):
        return _HistSeries(len(self.buckets))

    def _observe(self, labels, value):
        s = self._resolve(labels)
        i = 0
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                break
        else:
            i = len(self.buckets)
        s.counts[i] += 1
        s.sum += value
        s.count += 1

    def percentile(self, q: float, **labels):
        """Interpolated percentile (``q`` in [0, 1]) from the bucket
        counts, ``histogram_quantile`` style: linear within the bucket,
        the first bucket interpolates from 0, the +Inf bucket clamps to
        the last finite edge. None when the series is empty."""
        s = self._series.get(_label_key(labels))
        if s is None or s.count == 0:
            return None
        rank = q * s.count
        cum = 0
        for i, c in enumerate(s.counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i >= len(self.buckets):       # +Inf bucket
                    return self.buckets[-1]
                lo = self.buckets[i - 1] if i else 0.0
                hi = self.buckets[i]
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.buckets[-1]

    def stats(self, **labels) -> dict:
        """SLO readout for one series: count/sum/mean + p50/p90/p99."""
        s = self._series.get(_label_key(labels))
        if s is None or s.count == 0:
            return {"count": 0, "sum": 0.0, "mean": None,
                    "p50": None, "p90": None, "p99": None}
        return {"count": s.count, "sum": s.sum,
                "mean": s.sum / s.count,
                "p50": self.percentile(0.5, **labels),
                "p90": self.percentile(0.9, **labels),
                "p99": self.percentile(0.99, **labels)}

    def _dump_series(self, s):
        return {"count": s.count, "sum": s.sum,
                "buckets": dict(zip([str(b) for b in self.buckets]
                                    + ["+Inf"], s.counts))}


class Registry:
    """Thread-safe collection of named metrics.

    One lock covers declaration AND update: emissions are per-tile /
    per-sweep / per-job granularity (never per-baseline), so a plain
    lock costs nothing measurable while keeping every readout a
    consistent snapshot.
    """

    def __init__(self):
        self._metrics: dict = {}
        # reentrant: declaration helpers re-enter through the
        # declare-then-update convenience paths
        self._lock = threading.RLock()

    # -- declaration --------------------------------------------------------

    def _declare(self, cls, name, help="", **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already declared as {m.kind}")
            return m

    def counter(self, name, help="") -> Counter:
        return self._declare(Counter, name, help)

    def gauge(self, name, help="") -> Gauge:
        return self._declare(Gauge, name, help)

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS) \
            -> Histogram:
        return self._declare(Histogram, name, help, buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    # -- emission -----------------------------------------------------------

    def inc(self, name, value=1.0, **labels) -> None:
        with self._lock:
            self._declare(Counter, name)._inc(
                {**_scoped_labels(), **labels}, float(value))

    def set_gauge(self, name, value, **labels) -> None:
        with self._lock:
            self._declare(Gauge, name)._set(
                {**_scoped_labels(), **labels}, float(value))

    def observe(self, name, value, **labels) -> None:
        with self._lock:
            self._declare(Histogram, name)._observe(
                {**_scoped_labels(), **labels}, float(value))

    # -- readout ------------------------------------------------------------

    def dump(self) -> dict:
        """JSON-serializable snapshot of every metric: counters/gauges
        as values, histograms as bucket counts + count/sum + p50/p90/
        p99 per labelset (the serve ``metrics_full`` payload)."""
        with self._lock:
            out: dict = {}
            for name, m in sorted(self._metrics.items()):
                series = {}
                for key, s in m.series().items():
                    lk = ",".join(f"{k}={v}" for k, v in key) or ""
                    val = m._dump_series(s)
                    if isinstance(m, Histogram) and s.count:
                        val.update(
                            p50=m.percentile(0.5, **dict(key)),
                            p90=m.percentile(0.9, **dict(key)),
                            p99=m.percentile(0.99, **dict(key)))
                    series[lk] = val
                out[name] = {"type": m.kind, "help": m.help,
                             "series": series}
            return out

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()


# ---------------------------------------------------------------------------
# module-level no-op-when-disabled API (the diag.trace pattern)
# ---------------------------------------------------------------------------

def enable() -> Registry:
    """Install (or return) the process registry; emissions start
    counting. Idempotent: the serve daemon and an embedder can both
    call it."""
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = Registry()
    return _REGISTRY


def disable() -> None:
    """Uninstall the process registry (no-op when disabled); emissions
    return to costing one ``is None`` test."""
    global _REGISTRY
    _REGISTRY = None


def get() -> Registry | None:
    return _REGISTRY


def active() -> bool:
    """True when a registry is installed. Emit sites whose value
    conversion is itself costly (a device-to-host read) gate
    on this — the same blessed pattern as ``dtrace.active()``."""
    return _REGISTRY is not None


def inc(name, value=1.0, **labels) -> None:
    r = _REGISTRY
    if r is not None:
        r.inc(name, value, **labels)


def set_gauge(name, value, **labels) -> None:
    r = _REGISTRY
    if r is not None:
        r.set_gauge(name, value, **labels)


def observe(name, value, **labels) -> None:
    r = _REGISTRY
    if r is not None:
        r.observe(name, value, **labels)


def dump_to(path) -> None:
    """Write the live registry's dump as JSON to ``path`` and disable
    the registry — the shared ``--metrics PATH`` exit path of both
    CLIs (one definition, so the lifecycle cannot drift between
    them). No-op when disabled."""
    import json
    r = _REGISTRY
    if r is None:
        return
    try:
        with open(path, "w") as f:
            json.dump(r.dump(), f, indent=1)
    finally:
        disable()
