"""Zero-dependency observability: span tracing, a metrics registry, and
dispatch telemetry (the torch port of ``repro.obs``).

Three pillars:

* ``repro_torch.obs.trace``    — nestable spans, ring-buffered, exported
  as Chrome ``trace_event`` JSON (Perfetto-loadable), optional
  ``torch.profiler.record_function`` bridge;
* ``repro_torch.obs.metrics``  — named counters/gauges/histograms with
  label sets, Prometheus text exposition + JSON snapshot;
* ``repro_torch.obs.dispatch`` — which kernel path actually ran and the
  launched steps / marginal-evaluation counts.

**Off by default, near-zero when off.**  The module holds one
process-global session (``_ACTIVE``); every hook in the hot paths is a
single global read when no session is installed — ``span()`` returns a
shared no-op singleton (no allocation), ``inc``/``gauge_set``/
``observe`` return immediately.  Enable it:

    from repro_torch import obs

    with obs.session(obs.ObsConfig(enabled=True)):
        ...                                  # scoped
    obs.enable(obs.ObsConfig(enabled=True))  # or process-wide

or thread an ``ObsConfig`` through ``DPPRerankConfig(obs=...)``, which
installs it when the ``Reranker`` is constructed.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
)
from repro_torch.obs.trace import SpanTracer, validate_chrome_trace  # noqa: F401


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """What to observe.  ``enabled=False`` (the default) is a hard off
    switch: nothing is installed and every hook is a cheap no-op."""

    enabled: bool = False
    trace: bool = True  # span tracer
    metrics: bool = True  # metrics registry
    ring_size: int = 65536  # span ring buffer capacity
    torch_annotations: bool = False  # bridge spans to torch.profiler

    def __post_init__(self):
        if self.ring_size < 1:
            raise ValueError(
                f"ring_size must be >= 1, got {self.ring_size}"
            )


class Obs:
    """One installed observability session (tracer + registry, each
    optional per :class:`ObsConfig`)."""

    def __init__(self, config: ObsConfig):
        self.config = config
        self.tracer = (
            SpanTracer(config.ring_size, config.torch_annotations)
            if config.trace else None
        )
        self.registry = MetricsRegistry() if config.metrics else None


_ACTIVE: Optional[Obs] = None


class _NullSpan:
    """The disabled-path span: one shared instance, no state."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs):
        return self


NULL_SPAN = _NullSpan()


def enable(config: Optional[ObsConfig] = None) -> Optional[Obs]:
    """Install a process-global observability session and return it.

    ``None`` defaults to everything on.  A config with
    ``enabled=False`` is a no-op returning None (so callers can thread
    user configs through unconditionally).  If a session is already
    installed it is kept and returned — ``disable()`` first to replace
    it.
    """
    global _ACTIVE
    if config is None:
        config = ObsConfig(enabled=True)
    if not config.enabled:
        return None
    if _ACTIVE is None:
        _ACTIVE = Obs(config)
    return _ACTIVE


def disable() -> None:
    """Tear down the global session (hooks go back to no-ops)."""
    global _ACTIVE
    _ACTIVE = None


def enabled() -> bool:
    return _ACTIVE is not None


def active() -> Optional[Obs]:
    return _ACTIVE


def tracer() -> Optional[SpanTracer]:
    a = _ACTIVE
    return a.tracer if a is not None else None


def registry() -> Optional[MetricsRegistry]:
    a = _ACTIVE
    return a.registry if a is not None else None


@contextlib.contextmanager
def session(config: Optional[ObsConfig] = None):
    """Scoped ``enable``/``disable`` (no-op if a session already runs,
    or if ``config.enabled`` is False)."""
    installed = _ACTIVE is None and enable(config) is not None
    try:
        yield _ACTIVE
    finally:
        if installed:
            disable()


# ---------------------------------------------------------------------------
# Hot-path hooks (all a single global read when disabled)
# ---------------------------------------------------------------------------


def span(name: str, **attrs):
    """A tracer span, or the shared no-op singleton when tracing is off
    — the hot path allocates nothing while disabled."""
    a = _ACTIVE
    if a is None or a.tracer is None:
        return NULL_SPAN
    return a.tracer.span(name, **attrs)


def inc(name: str, value: float = 1, **labels) -> None:
    a = _ACTIVE
    if a is None or a.registry is None:
        return
    a.registry.counter(name).inc(value, **labels)


def gauge_set(name: str, value: float, **labels) -> None:
    a = _ACTIVE
    if a is None or a.registry is None:
        return
    a.registry.gauge(name).set(value, **labels)


def observe(name: str, value: float, **labels) -> None:
    a = _ACTIVE
    if a is None or a.registry is None:
        return
    a.registry.histogram(name).observe(value, **labels)


__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_SPAN",
    "Obs",
    "ObsConfig",
    "SpanTracer",
    "active",
    "disable",
    "enable",
    "enabled",
    "gauge_set",
    "inc",
    "observe",
    "registry",
    "session",
    "span",
    "tracer",
    "validate_chrome_trace",
]
