"""Prometheus exposition: a stdlib registry and text-format 0.0.4 writer.

The port's own copy of dynamo_tpu/runtime/prom.py (``CallbackCounter``)
together with the part of ``prometheus_client`` the reference's metric
modules use, which the card's machine does not have: ``CollectorRegistry``,
``Counter``, ``Gauge`` (with ``set_function``) and ``Histogram`` with label
children, the scrape-time ``CounterMetricFamily`` / ``GaugeMetricFamily`` /
``HistogramMetricFamily`` of custom collectors, and ``generate_latest``. The text is what
``prometheus_client`` writes for the same metrics (``# HELP`` / ``# TYPE``,
a counter's ``_total`` sample, cumulative ``_bucket{le=...}`` lines with
``_count`` and ``_sum``, label values and help escaped, numbers in Go's
float form), less the optional ``_created`` timestamps.

Why a callback counter: the fleet metrics planes export worker-lifetime
monotonic counters that this process only observes (scraped absolute
values, not events it can ``inc()``). ``CallbackCounter`` reads the
absolute value from a callback at scrape time and exposes it as a real
counter family (resets on worker restart are the counter-reset semantics
``rate()`` and ``increase()`` already handle).
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Iterable, Iterator, Optional, Sequence

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

INF = float("inf")
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0,
    7.5, 10.0, INF,
)


def float_to_go_string(d: float) -> str:
    """A sample value or bucket bound as Prometheus (and Go) print it."""
    d = float(d)
    if d == INF:
        return "+Inf"
    if d == -INF:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    # Go switches to exponents sooner than Python
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _escape_help(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n")


class Metric:
    """One family as a collector yields it: name, help, type, samples.
    A sample is ``(name, {label: value}, value)``."""

    def __init__(self, name: str, documentation: str, typ: str) -> None:
        self.name = name
        self.documentation = documentation
        self.type = typ
        self.samples: list[tuple[str, dict[str, str], float]] = []

    def add_sample(self, name: str, labels: dict[str, str], value: float) -> None:
        self.samples.append((name, labels, float(value)))


class CounterMetricFamily(Metric):
    """A counter family for custom collectors; ``name`` with or without
    ``_total`` (the sample always carries it)."""

    def __init__(self, name: str, documentation: str, value: Optional[float] = None,
                 labels: Optional[Sequence[str]] = None) -> None:
        if name.endswith("_total"):
            name = name[: -len("_total")]
        super().__init__(name, documentation, "counter")
        self._labelnames = tuple(labels or ())
        if value is not None:
            self.add_metric([], value)

    def add_metric(self, labels: Sequence[str], value: float) -> None:
        self.add_sample(self.name + "_total", dict(zip(self._labelnames, labels)), value)


class GaugeMetricFamily(Metric):
    def __init__(self, name: str, documentation: str, value: Optional[float] = None,
                 labels: Optional[Sequence[str]] = None) -> None:
        super().__init__(name, documentation, "gauge")
        self._labelnames = tuple(labels or ())
        if value is not None:
            self.add_metric([], value)

    def add_metric(self, labels: Sequence[str], value: float) -> None:
        self.add_sample(self.name, dict(zip(self._labelnames, labels)), value)


class HistogramMetricFamily(Metric):
    """A histogram family for custom collectors: ``buckets`` are
    ``(le, cumulative count)`` pairs ending at ``+Inf``."""

    def __init__(self, name: str, documentation: str,
                 labels: Optional[Sequence[str]] = None) -> None:
        super().__init__(name, documentation, "histogram")
        self._labelnames = tuple(labels or ())

    def add_metric(self, labels: Sequence[str], buckets: Sequence[tuple[str, float]],
                   sum_value: float) -> None:
        lab = dict(zip(self._labelnames, labels))
        for le, n in buckets:
            self.add_sample(self.name + "_bucket", {"le": le, **lab}, n)
        self.add_sample(self.name + "_count", lab, buckets[-1][1] if buckets else 0.0)
        self.add_sample(self.name + "_sum", lab, sum_value)


class CollectorRegistry:
    """Collectors (anything with ``collect()`` yielding families), in
    registration order; a family name may be registered once."""

    def __init__(self) -> None:
        self._collectors: list = []
        self._lock = threading.Lock()

    def register(self, collector) -> None:
        with self._lock:
            self._collectors.append(collector)

    def collect(self) -> Iterator[Metric]:
        with self._lock:
            collectors = list(self._collectors)
        for c in collectors:
            yield from c.collect()


def generate_latest(registry: CollectorRegistry) -> bytes:
    """The registry in the Prometheus text format 0.0.4."""
    out: list[str] = []
    for fam in registry.collect():
        name = fam.name + "_total" if fam.type == "counter" else fam.name
        out.append(f"# HELP {name} {_escape_help(fam.documentation)}\n")
        out.append(f"# TYPE {name} {fam.type}\n")
        for sname, labels, value in fam.samples:
            if labels:
                body = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in labels.items())
                out.append(f"{sname}{{{body}}} {float_to_go_string(value)}\n")
            else:
                out.append(f"{sname} {float_to_go_string(value)}\n")
    return "".join(out).encode("utf-8")


# ------------------------------------------------------- instrumented metrics


class _MetricBase:
    def __init__(self, name: str, documentation: str, labelnames: Iterable[str] = (),
                 registry: Optional[CollectorRegistry] = None) -> None:
        self._name = name
        self._doc = documentation
        self._labelnames = tuple(labelnames)
        self._children: dict[tuple[str, ...], "_MetricBase"] = {}
        self._lock = threading.Lock()
        if registry is not None:
            registry.register(self)

    def _child(self) -> "_MetricBase":
        raise NotImplementedError

    def labels(self, *values, **kw) -> "_MetricBase":
        if kw:
            values = tuple(kw[n] for n in self._labelnames)
        if len(values) != len(self._labelnames):
            raise ValueError(f"{self._name}: expected labels {self._labelnames}, got {values}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._child()
            return child

    def _series(self) -> list[tuple[dict[str, str], "_MetricBase"]]:
        if not self._labelnames:
            return [({}, self)]
        with self._lock:
            return [(dict(zip(self._labelnames, k)), c) for k, c in self._children.items()]


class Counter(_MetricBase):
    def __init__(self, name: str, documentation: str, labelnames: Iterable[str] = (),
                 registry: Optional[CollectorRegistry] = None) -> None:
        if name.endswith("_total"):
            name = name[: -len("_total")]
        super().__init__(name, documentation, labelnames, registry)
        self._value = 0.0

    def _child(self) -> "Counter":
        return Counter(self._name, self._doc)

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError("counters can only be incremented by non-negative amounts")
        with self._lock:
            self._value += amount

    def collect(self) -> Iterator[Metric]:
        fam = Metric(self._name, self._doc, "counter")
        for labels, c in self._series():
            fam.add_sample(self._name + "_total", labels, c._value)
        yield fam


class Gauge(_MetricBase):
    def __init__(self, name: str, documentation: str, labelnames: Iterable[str] = (),
                 registry: Optional[CollectorRegistry] = None) -> None:
        super().__init__(name, documentation, labelnames, registry)
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def _child(self) -> "Gauge":
        return Gauge(self._name, self._doc)

    def inc(self, amount: float = 1) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1) -> None:
        with self._lock:
            self._value -= amount

    def set(self, value: float) -> None:
        self._value = float(value)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Read the value from ``fn`` at every scrape."""
        self._fn = fn

    def get(self) -> float:
        return float(self._fn()) if self._fn is not None else self._value

    def collect(self) -> Iterator[Metric]:
        fam = Metric(self._name, self._doc, "gauge")
        for labels, g in self._series():
            fam.add_sample(self._name, labels, g.get())
        yield fam


class Histogram(_MetricBase):
    def __init__(self, name: str, documentation: str, labelnames: Iterable[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 registry: Optional[CollectorRegistry] = None) -> None:
        super().__init__(name, documentation, labelnames, registry)
        bounds = [float(b) for b in buckets]
        if bounds[-1] != INF:
            bounds.append(INF)
        self._bounds = tuple(bounds)
        self._counts = [0.0] * len(bounds)
        self._sum = 0.0

    def _child(self) -> "Histogram":
        return Histogram(self._name, self._doc, buckets=self._bounds)

    def observe(self, amount: float) -> None:
        with self._lock:
            self._sum += amount
            for i, b in enumerate(self._bounds):
                if amount <= b:
                    self._counts[i] += 1
                    break

    def collect(self) -> Iterator[Metric]:
        fam = Metric(self._name, self._doc, "histogram")
        for labels, h in self._series():
            acc = 0.0
            for b, n in zip(h._bounds, h._counts):
                acc += n
                fam.add_sample(self._name + "_bucket", {"le": float_to_go_string(b), **labels}, acc)
            fam.add_sample(self._name + "_count", labels, acc)
            fam.add_sample(self._name + "_sum", labels, h._sum)
        yield fam


class CallbackCounter:
    """A counter family whose value comes from a zero-arg callback at
    scrape time. ``name`` may be given with or without the ``_total``
    suffix (the exposition appends it either way)."""

    def __init__(self, registry: CollectorRegistry, name: str, documentation: str,
                 fn: Callable[[], float]) -> None:
        self._name = name[: -len("_total")] if name.endswith("_total") else name
        self._doc = documentation
        self._fn = fn
        registry.register(self)

    def collect(self) -> Iterator[Metric]:
        try:
            value = float(self._fn() or 0)
        except Exception:  # noqa: BLE001 — a failing read scrapes as 0
            value = 0.0
        yield CounterMetricFamily(self._name, self._doc, value=value)

