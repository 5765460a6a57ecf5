"""Named counters / gauges / histograms with label sets.

The registry is the port's one metrics substrate: the dispatch telemetry
(``repro_torch.obs.dispatch``) counts kernel-path decisions and marginal
evaluations into it.  Two exports:

* :meth:`MetricsRegistry.snapshot` — a JSON-able dict (what
  ``serve_router --metrics-out`` and ``BENCH_<fig>.json`` write);
* :meth:`MetricsRegistry.expose` — Prometheus text exposition, one
  sample line per label set, so a scrape endpoint is a two-liner.

Metrics are plain dict arithmetic under the GIL — cheap enough to stay
always-on inside the router (its stats were always on), and zero-cost
for everything else when no registry is installed (see ``repro_torch.obs``).
Counters are monotonic; gauges hold the last set value; histograms keep
cumulative bucket counts plus sum/count (mean = sum/count).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

# Generic latency buckets (seconds), spanning ~100us host phases to
# multi-second drains; +Inf is implicit.
DEFAULT_BUCKETS = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5,
)

_LabelKey = Tuple[Tuple[str, str], ...]


def _key(labels: dict) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _key_str(key: _LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


def _prom_labels(key: _LabelKey, extra: Iterable[Tuple[str, str]] = ()) -> str:
    items = list(key) + list(extra)
    if not items:
        return ""
    body = ",".join(
        f'{k}="{v.replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
        for k, v in items
    )
    return "{" + body + "}"


class Counter:
    """Monotonic counter, one value per label set."""

    kind = "counter"
    __slots__ = ("name", "help", "_vals")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._vals: Dict[_LabelKey, float] = {}

    def inc(self, value: float = 1, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({value})")
        k = _key(labels)
        self._vals[k] = self._vals.get(k, 0) + value

    def value(self, **labels) -> float:
        return self._vals.get(_key(labels), 0)

    def total(self) -> float:
        """Sum over every label set."""
        return sum(self._vals.values())

    def _snapshot(self):
        return {_key_str(k): v for k, v in self._vals.items()}

    def _expose(self):
        for k, v in sorted(self._vals.items()):
            yield f"{self.name}{_prom_labels(k)} {v}"


class Gauge:
    """Last-set value, one per label set."""

    kind = "gauge"
    __slots__ = ("name", "help", "_vals")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._vals: Dict[_LabelKey, float] = {}

    def set(self, value: float, **labels) -> None:
        self._vals[_key(labels)] = value

    def inc(self, value: float = 1, **labels) -> None:
        k = _key(labels)
        self._vals[k] = self._vals.get(k, 0) + value

    def value(self, **labels) -> float:
        return self._vals.get(_key(labels), 0)

    def _snapshot(self):
        return {_key_str(k): v for k, v in self._vals.items()}

    def _expose(self):
        for k, v in sorted(self._vals.items()):
            yield f"{self.name}{_prom_labels(k)} {v}"


class Histogram:
    """Cumulative-bucket histogram (Prometheus semantics) per label set."""

    kind = "histogram"
    __slots__ = ("name", "help", "buckets", "_vals")

    def __init__(self, name: str, help: str = "",
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        # per label set: [per-bucket counts (+Inf last), sum, count]
        self._vals: Dict[_LabelKey, list] = {}

    def _cell(self, labels) -> list:
        k = _key(labels)
        cell = self._vals.get(k)
        if cell is None:
            cell = [[0] * (len(self.buckets) + 1), 0.0, 0]
            self._vals[k] = cell
        return cell

    def observe(self, value: float, **labels) -> None:
        cell = self._cell(labels)
        counts, _, _ = cell
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                counts[i] += 1
                break
        else:
            counts[-1] += 1
        cell[1] += value
        cell[2] += 1

    def sum(self, **labels) -> float:
        cell = self._vals.get(_key(labels))
        return cell[1] if cell else 0.0

    def count(self, **labels) -> int:
        cell = self._vals.get(_key(labels))
        return cell[2] if cell else 0

    def mean(self, **labels) -> float:
        cell = self._vals.get(_key(labels))
        return cell[1] / cell[2] if cell and cell[2] else 0.0

    def _snapshot(self):
        out = {}
        for k, (counts, s, n) in self._vals.items():
            cum, buckets = 0, {}
            for ub, c in zip(self.buckets, counts):
                cum += c
                buckets[repr(ub)] = cum
            buckets["+Inf"] = cum + counts[-1]
            out[_key_str(k)] = {"sum": s, "count": n, "buckets": buckets}
        return out

    def _expose(self):
        for k, (counts, s, n) in sorted(self._vals.items()):
            cum = 0
            for ub, c in zip(self.buckets, counts):
                cum += c
                yield (f"{self.name}_bucket"
                       f"{_prom_labels(k, [('le', repr(ub))])} {cum}")
            yield (f"{self.name}_bucket"
                   f"{_prom_labels(k, [('le', '+Inf')])} {cum + counts[-1]}")
            yield f"{self.name}_sum{_prom_labels(k)} {s}"
            yield f"{self.name}_count{_prom_labels(k)} {n}"


class MetricsRegistry:
    """Get-or-create home for named metrics.

    ``counter`` / ``gauge`` / ``histogram`` return the existing metric
    when the name is already registered (and raise if it is registered
    as a different kind), so call sites never coordinate registration.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as a {m.kind}, "
                f"requested as a {cls.kind}"
            )
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        if buckets is None:
            return self._get(Histogram, name, help)
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str):
        """The registered metric, or None."""
        return self._metrics.get(name)

    def names(self):
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """JSON-able snapshot: ``{kind: {name: {label_str: value}}}``
        (histogram values are ``{sum, count, buckets}`` dicts)."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name, m in sorted(self._metrics.items()):
            out[m.kind + "s"][name] = m._snapshot()
        return out

    def expose(self) -> str:
        """Prometheus text exposition (one HELP/TYPE header + one line
        per label set per metric)."""
        lines = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            lines.extend(m._expose())
        return "\n".join(lines) + "\n"
