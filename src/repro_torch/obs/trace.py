"""Nestable span tracing with Chrome ``trace_event`` export.

``SpanTracer.span("router.pump", **attrs)`` is a context manager that
records one complete span — monotonic start/end (``perf_counter_ns``)
plus a wall-clock anchor so absolute timestamps can be reconstructed —
into a bounded in-process ring buffer.  Export with
:meth:`SpanTracer.export_chrome` / :meth:`SpanTracer.write_chrome`:
the output is the Chrome ``trace_event`` JSON array format
(``{"traceEvents": [...]}`` with ``"ph": "X"`` complete events), which
Perfetto and ``chrome://tracing`` load directly; span nesting is
reconstructed by the viewer from ts/dur containment per thread.

With ``torch_annotations=True`` every span also enters a
``torch.profiler.record_function`` of the same name, so when a device
profile is being captured (``torch.profiler.profile``), the host spans
line up with the device timeline in the same viewer.

Recording is append-of-a-tuple cheap; the dict/JSON work happens at
export.  When tracing is disabled the tracer is never constructed at
all — ``repro_torch.obs.span`` returns a shared no-op (see
``repro_torch.obs``).
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional


class Span:
    """One in-flight span; records itself into the tracer on exit."""

    __slots__ = ("_tracer", "name", "attrs", "_start_ns", "_ann")

    def __init__(self, tracer: "SpanTracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self._start_ns = 0
        self._ann = None

    def set(self, **attrs) -> "Span":
        """Attach/overwrite key-value attributes (shown as Chrome
        ``args``)."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        if self._tracer._annotate is not None:
            self._ann = self._tracer._annotate(self.name)
            self._ann.__enter__()
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end_ns = time.perf_counter_ns()
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        self._tracer._record(self.name, self._start_ns, end_ns, self.attrs)
        return False


class SpanTracer:
    """Ring-buffered span recorder with Chrome trace_event export.

    ring_size bounds memory: the buffer keeps the newest ``ring_size``
    spans and counts what it dropped (``dropped``).
    """

    def __init__(self, ring_size: int = 65536,
                 torch_annotations: bool = False):
        if ring_size < 1:
            raise ValueError(f"ring_size must be >= 1, got {ring_size}")
        self.ring_size = ring_size
        self._events = deque(maxlen=ring_size)
        self._total = 0
        self._t0_ns = time.perf_counter_ns()
        self._wall0 = time.time()
        self._pid = os.getpid()
        self._tids: dict = {}
        self._annotate = None
        if torch_annotations:
            from torch.profiler import record_function

            self._annotate = record_function

    def span(self, name: str, **attrs) -> Span:
        return Span(self, name, attrs)

    # -- recording -----------------------------------------------------------

    def _record(self, name: str, start_ns: int, end_ns: int, attrs: dict):
        tid = threading.get_ident()
        small = self._tids.get(tid)
        if small is None:
            small = self._tids[tid] = len(self._tids)
        self._events.append((name, start_ns, end_ns, small, attrs))
        self._total += 1

    # -- introspection -------------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    @property
    def total(self) -> int:
        """Spans recorded over the tracer's lifetime (including dropped)."""
        return self._total

    @property
    def dropped(self) -> int:
        return self._total - len(self._events)

    def finished(self):
        """The buffered spans as dicts: ``name``, ``start_us`` / ``dur_us``
        (monotonic, relative to the tracer origin), ``wall_ts`` (epoch
        seconds), ``tid``, ``attrs`` — the in-process view of the trace."""
        out = []
        for name, s, e, tid, attrs in list(self._events):
            out.append({
                "name": name,
                "start_us": (s - self._t0_ns) / 1e3,
                "dur_us": (e - s) / 1e3,
                "wall_ts": self._wall0 + (s - self._t0_ns) / 1e9,
                "tid": tid,
                "attrs": attrs,
            })
        return out

    # -- Chrome trace_event export -------------------------------------------

    def export_chrome(self, process_name: str = "repro-torch-divdpp") -> dict:
        """The buffered spans as a Chrome ``trace_event`` JSON object
        (Perfetto-loadable): complete ``"ph": "X"`` events with ``ts`` /
        ``dur`` in microseconds, attributes under ``args``."""
        events = [{
            "name": "process_name", "ph": "M", "pid": self._pid, "tid": 0,
            "args": {"name": process_name},
        }]
        for name, s, e, tid, attrs in list(self._events):
            ev = {
                "name": name,
                "cat": "repro_torch",
                "ph": "X",
                "ts": (s - self._t0_ns) / 1e3,
                "dur": (e - s) / 1e3,
                "pid": self._pid,
                "tid": tid,
            }
            args = dict(attrs)
            args["wall_ts"] = self._wall0 + (s - self._t0_ns) / 1e9
            ev["args"] = args
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "wall_time_origin": self._wall0,
                "monotonic_origin_ns": self._t0_ns,
                "spans_total": self._total,
                "spans_dropped": self.dropped,
            },
        }

    def write_chrome(self, path: str, process_name: str = "repro-torch-divdpp"):
        """Write :meth:`export_chrome` JSON to ``path`` (load it in
        https://ui.perfetto.dev or ``chrome://tracing``)."""
        with open(path, "w") as f:
            # default=str: attrs are caller-supplied and may hold opaque
            # rids — stringify rather than crash the exporter
            json.dump(self.export_chrome(process_name), f, default=str)


def validate_chrome_trace(doc: dict) -> Optional[str]:
    """Schema check for an exported trace: returns None when valid, else
    a description of the first violation.  Used by the
    round-trip test."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return "missing traceEvents"
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return "traceEvents is not a list"
    for i, ev in enumerate(evs):
        for field in ("name", "ph", "pid", "tid"):
            if field not in ev:
                return f"event {i} missing {field!r}"
        if ev["ph"] == "X":
            if not isinstance(ev.get("ts"), (int, float)):
                return f"event {i} has non-numeric ts"
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                return f"event {i} has bad dur"
            if not isinstance(ev.get("args", {}), dict):
                return f"event {i} args is not a dict"
    return None
