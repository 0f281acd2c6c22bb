"""Typed, labeled metrics registry for the serving stack.

Three metric kinds — monotonic counters, set-anywhere gauges, and
fixed-bucket histograms — each declared once in a `MetricsRegistry` with
an explicit label schema. Every observation names its labels by keyword
(``reg["executed"].inc(3, bucket="2")``), and an observation whose label
set does not exactly match the declaration raises `MetricError`: label
cardinality is a schema property, never an accident of call sites.

Snapshots are plain JSON-ready dicts (`MetricsRegistry.snapshot`), with
counter/histogram deltas between two snapshots via `snapshot_delta`.
`to_prometheus` renders the standard text exposition format (parseable
back with `parse_prometheus`, which the round-trip test uses).

This module is stdlib-only on purpose: `tools/check_docs.py` imports the
declared serving schema to gate the documentation without paying a torch
import.
"""
from __future__ import annotations

import json
import math
import re

_NAME_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")


class MetricError(ValueError):
    """Schema violation: bad metric/label name, label-set mismatch,
    conflicting re-declaration, or an invalid observation."""


def _check_name(name: str, what: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise MetricError(f"invalid {what} name {name!r}")
    return name


class Metric:
    """Base: one named series family with a fixed label schema."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: tuple[str, ...] = ()) -> None:
        """Declare the family; `labels` fixes the exact label-name set
        every observation must supply."""
        self.name = _check_name(name, "metric")
        self.help = help
        self.labels = tuple(_check_name(ln, "label") for ln in labels)
        self._series: dict[tuple[str, ...], object] = {}

    def _key(self, labels: dict[str, object]) -> tuple[str, ...]:
        """Validate an observation's labels against the declared schema."""
        if set(labels) != set(self.labels):
            raise MetricError(
                f"{self.name}: got labels {sorted(labels)}, declared "
                f"{sorted(self.labels)} — observations must supply exactly "
                "the declared label set")
        return tuple(str(labels[ln]) for ln in self.labels)

    def clear(self) -> None:
        """Drop every recorded label set (the family stays declared)."""
        self._series.clear()

    def _decl(self) -> dict:
        return {"kind": self.kind, "help": self.help,
                "labels": list(self.labels)}

    def snapshot(self) -> dict:
        """JSON-ready view: declaration plus one entry per label set."""
        out = self._decl()
        out["series"] = [
            {"labels": dict(zip(self.labels, key)), **self._value_view(v)}
            for key, v in sorted(self._series.items())]
        return out

    def _value_view(self, value) -> dict:
        return {"value": value}


class CounterMetric(Metric):
    """Monotonically increasing count per label set."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        """Add `amount` (>= 0) to the label set's count."""
        if amount < 0:
            raise MetricError(f"{self.name}: counters only go up "
                              f"(inc by {amount})")
        key = self._key(labels)
        self._series[key] = self._series.get(key, 0) + amount

    def total(self) -> float:
        """Sum over every label set (0 when nothing was recorded)."""
        return sum(self._series.values())


class GaugeMetric(Metric):
    """Last-written value per label set (queue depth, epoch, FLOPs...)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        """Overwrite the label set's value."""
        self._series[self._key(labels)] = float(value)

    def get(self, **labels) -> float | None:
        """Current value for one label set, None if never written."""
        return self._series.get(self._key(labels))


class HistogramMetric(Metric):
    """Fixed-bucket cumulative histogram per label set.

    `buckets` are the finite upper bounds (strictly increasing); an
    implicit +Inf bucket tops the list, Prometheus-style, so `observe`
    is O(#buckets) with no allocation.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: tuple[str, ...] = (),
                 buckets: tuple[float, ...] = (1.0, 10.0, 100.0)) -> None:
        """Declare the family with its fixed finite bucket bounds."""
        super().__init__(name, help, labels)
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])) \
                or not all(math.isfinite(b) for b in bounds):
            raise MetricError(f"{name}: buckets must be finite and strictly "
                              f"increasing, got {buckets}")
        self.buckets = bounds

    def observe(self, value: float, **labels) -> None:
        """Record one sample into its (cumulative) buckets."""
        key = self._key(labels)
        cell = self._series.get(key)
        if cell is None:
            cell = self._series[key] = {
                "counts": [0] * (len(self.buckets) + 1),
                "sum": 0.0, "count": 0}
        value = float(value)
        for i, bound in enumerate(self.buckets):
            if value <= bound:
                cell["counts"][i] += 1
                break
        else:
            cell["counts"][-1] += 1
        cell["sum"] += value
        cell["count"] += 1

    def _decl(self) -> dict:
        out = super()._decl()
        out["buckets"] = list(self.buckets)
        return out

    def _value_view(self, value) -> dict:
        cum, acc = [], 0
        for c in value["counts"]:
            acc += c
            cum.append(acc)
        return {"cumulative": cum, "sum": value["sum"],
                "count": value["count"]}


class MetricsRegistry:
    """A named collection of declared metric families.

    Families are declared once (`counter`/`gauge`/`histogram`); a
    re-declaration with an identical schema returns the existing family,
    a conflicting one raises `MetricError`. `snapshot()` always includes
    every declared family (empty series and all), so a zero is a real
    zero rather than a missing key.
    """

    def __init__(self) -> None:
        """Start empty; families are added by the declaration methods."""
        self._metrics: dict[str, Metric] = {}

    def _declare(self, cls, name: str, help: str, labels, **kw) -> Metric:
        labels = tuple(labels)
        existing = self._metrics.get(name)
        if existing is not None:
            same = (type(existing) is cls and existing.labels == labels
                    and kw.get("buckets",
                               getattr(existing, "buckets", None))
                    == getattr(existing, "buckets", None))
            if not same:
                raise MetricError(f"{name}: conflicting re-declaration")
            return existing
        metric = cls(name, help, labels, **kw)
        self._metrics[name] = metric
        return metric

    def counter(self, name: str, help: str = "",
                labels: tuple[str, ...] = ()) -> CounterMetric:
        """Declare (or fetch) a counter family."""
        return self._declare(CounterMetric, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: tuple[str, ...] = ()) -> GaugeMetric:
        """Declare (or fetch) a gauge family."""
        return self._declare(GaugeMetric, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: tuple[str, ...] = (),
                  buckets: tuple[float, ...] = (1.0, 10.0, 100.0),
                  ) -> HistogramMetric:
        """Declare (or fetch) a fixed-bucket histogram family."""
        return self._declare(HistogramMetric, name, help, labels,
                             buckets=buckets)

    def __getitem__(self, name: str) -> Metric:
        """The declared family for `name` (KeyError if undeclared)."""
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        """Whether `name` is a declared family."""
        return name in self._metrics

    def names(self) -> list[str]:
        """Declared family names, in declaration order."""
        return list(self._metrics)

    def total(self, name: str) -> float:
        """Sum of a counter family over all its label sets."""
        metric = self._metrics[name]
        if not isinstance(metric, CounterMetric):
            raise MetricError(f"{name} is a {metric.kind}, not a counter")
        return metric.total()

    def reset(self) -> None:
        """Zero every counter and histogram; gauges keep their values
        (a gauge reports current state, not accumulation)."""
        for metric in self._metrics.values():
            if metric.kind in ("counter", "histogram"):
                metric.clear()

    def snapshot(self) -> dict:
        """{name: family snapshot} over every declared family."""
        return {name: m.snapshot() for name, m in self._metrics.items()}

    def to_json(self, **dump_kw) -> str:
        """The snapshot as a JSON document."""
        dump_kw.setdefault("indent", 2)
        dump_kw.setdefault("sort_keys", True)
        return json.dumps(self.snapshot(), **dump_kw)

    def to_prometheus(self) -> str:
        """The snapshot in Prometheus text exposition format."""
        lines: list[str] = []
        for name, metric in self._metrics.items():
            if metric.help:
                lines.append(f"# HELP {name} {metric.help}")
            lines.append(f"# TYPE {name} {metric.kind}")
            for key in sorted(metric._series):
                value = metric._series[key]
                pairs = list(zip(metric.labels, key))
                if metric.kind == "histogram":
                    acc = 0
                    for bound, c in zip(
                            list(metric.buckets) + ["+Inf"],
                            value["counts"]):
                        acc += c
                        le = bound if bound == "+Inf" else _fmt(bound)
                        lines.append(_sample(f"{name}_bucket",
                                             pairs + [("le", le)], acc))
                    lines.append(_sample(f"{name}_sum", pairs, value["sum"]))
                    lines.append(_sample(f"{name}_count", pairs,
                                         value["count"]))
                else:
                    lines.append(_sample(name, pairs, value))
        return "\n".join(lines) + "\n"


def _fmt(value: float) -> str:
    """Prometheus value formatting: integral floats print as ints."""
    f = float(value)
    return str(int(f)) if f.is_integer() else repr(f)


def _sample(name: str, pairs: list[tuple[str, str]], value) -> str:
    """One exposition line: ``name{label="v",...} value``."""
    if pairs:
        inner = ",".join(
            '{}="{}"'.format(ln, str(lv).replace("\\", r"\\")
                             .replace('"', r"\"").replace("\n", r"\n"))
            for ln, lv in pairs)
        return f"{name}{{{inner}}} {_fmt(value)}"
    return f"{name} {_fmt(value)}"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_][a-zA-Z0-9_]*)(?:\{(.*)\})?\s+(\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_ESCAPES = {"\\": "\\", '"': '"', "n": "\n"}


def _unescape_label(value: str) -> str:
    """Invert exposition label escaping in one pass.

    Sequential ``str.replace`` chains corrupt values where an escaped
    backslash precedes an ``n`` (``\\\\n`` — a literal backslash then the
    letter n — would round-trip into a newline); a single left-to-right
    scan consumes each escape exactly once.
    """
    return re.sub(r"\\(.)",
                  lambda m: _ESCAPES.get(m.group(1), "\\" + m.group(1)),
                  value)


def parse_prometheus(text: str) -> dict[str, list[tuple[dict, float]]]:
    """Parse text exposition back into {name: [(labels, value), ...]}.

    Histogram families come back under their expanded sample names
    (``name_bucket`` / ``name_sum`` / ``name_count``) — exactly what the
    exposition publishes, which is what the round-trip test compares.
    """
    out: dict[str, list[tuple[dict, float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise MetricError(f"unparseable exposition line: {line!r}")
        name, labels_src, value = m.groups()
        labels = {ln: _unescape_label(lv)
                  for ln, lv in _LABEL_RE.findall(labels_src or "")}
        out.setdefault(name, []).append((labels, float(value)))
    return out


def snapshot_delta(new: dict, old: dict) -> dict:
    """Counter/histogram difference between two registry snapshots.

    Counters and histogram cumulative counts subtract (a label set absent
    from `old` counts from zero); gauges pass through `new` unchanged —
    a gauge is state, not accumulation. The result has the same shape as
    a snapshot, so it serializes and reads the same way.
    """
    out: dict = {}
    for name, fam in new.items():
        if fam["kind"] == "gauge":
            out[name] = fam
            continue
        old_series = {tuple(sorted(s["labels"].items())): s
                      for s in old.get(name, {}).get("series", [])}
        series = []
        for s in fam["series"]:
            prev = old_series.get(tuple(sorted(s["labels"].items())))
            if fam["kind"] == "counter":
                base = prev["value"] if prev else 0
                series.append({**s, "value": s["value"] - base})
            else:
                bc = prev["cumulative"] if prev else []
                if len(bc) != len(s["cumulative"]):
                    # bucket layout changed between snapshots (or the
                    # series is new) — a subtraction would misalign, so
                    # count from zero
                    bc = [0] * len(s["cumulative"])
                    prev = None
                series.append({
                    **s,
                    "cumulative": [a - b for a, b in
                                   zip(s["cumulative"], bc)],
                    "sum": s["sum"] - (prev["sum"] if prev else 0.0),
                    "count": s["count"] - (prev["count"] if prev else 0)})
        out[name] = {**fam, "series": series}
    return out
