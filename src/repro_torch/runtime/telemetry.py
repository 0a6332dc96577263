"""Telemetry primitives: a counter/gauge registry and a Chrome/Perfetto
``trace_event`` buffer (copy of ``repro/runtime/telemetry.py``, pure
Python: the same series names, label rendering and JSON shape, so one
dashboard or one Perfetto session reads both packages' output).

This module is the serving stack's measurement substrate, deliberately
generic — nothing in it knows about engines, requests, or KV pools.  The
serving-specific wiring (what spans mean, which counters exist, when they
are sampled) lives in ``serving/observe.py``.

``MetricsRegistry``
    Named counters (monotonic) and gauges (last-write) with optional
    labels, e.g. ``reg.counter("tokens_decoded_total").inc(5,
    family="dense")``.  ``prometheus_text()`` renders the whole registry
    in the Prometheus text exposition format; ``snapshot()`` returns the
    same data as plain nested dicts for JSON embedding.

``TraceBuffer``
    An append-only list of Chrome ``trace_event`` dicts — complete
    ("X") duration spans, instants ("i"), counter series ("C"), and
    process/thread metadata ("M") — exported as the JSON object format
    (``{"traceEvents": [...]}``) that ``ui.perfetto.dev`` and
    ``chrome://tracing`` load directly.  Timestamps are microseconds; the
    caller supplies them (the serving tracer uses the engine's injected
    clock so virtual-time tests produce exact traces).
"""
from __future__ import annotations

import json


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_text(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


class _Metric:
    """One named metric family: a value per distinct label set."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: dict[tuple, float] = {}

    def get(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def series(self) -> dict[tuple, float]:
        return dict(self._values)


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc by {amount})")
        key = _label_key(labels)
        self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._values[_label_key(labels)] = float(value)


class MetricsRegistry:
    """Process-local named metrics.  ``counter``/``gauge`` create on first
    use and return the existing instance afterwards (re-registering with a
    different kind is an error — one name, one meaning)."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help)
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def __iter__(self):
        return iter(self._metrics.values())

    def snapshot(self) -> dict:
        """{name: {label_text: value}} — JSON-embeddable."""
        return {m.name: {_label_text(k): v for k, v in m.series().items()}
                for m in self}

    def prometheus_text(self) -> str:
        """The Prometheus text exposition format (one HELP/TYPE header per
        metric family, one line per label set)."""
        lines = []
        for m in sorted(self, key=lambda m: m.name):
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key, value in sorted(m.series().items()):
                lines.append(f"{m.name}{_label_text(key)} {value:g}")
        return "\n".join(lines) + "\n"


class TraceBuffer:
    """Chrome ``trace_event`` accumulator (JSON object format).

    All timestamps (``ts``) and durations (``dur``) are in MICROSECONDS,
    per the trace_event spec.  Events carry a ``pid``/``tid`` pair that
    Perfetto renders as process/thread tracks; ``set_process_name`` /
    ``set_thread_name`` emit the metadata events that label them.
    """

    def __init__(self):
        self.events: list[dict] = []
        self._named_threads: set[tuple[int, int]] = set()
        self._named_processes: set[int] = set()

    def __len__(self) -> int:
        return len(self.events)

    # ------------------------------------------------------------ metadata
    def set_process_name(self, pid: int, name: str) -> None:
        if pid in self._named_processes:
            return
        self._named_processes.add(pid)
        self.events.append({"ph": "M", "name": "process_name", "pid": pid,
                            "tid": 0, "args": {"name": name}})

    def set_thread_name(self, pid: int, tid: int, name: str) -> None:
        if (pid, tid) in self._named_threads:
            return
        self._named_threads.add((pid, tid))
        self.events.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": tid, "args": {"name": name}})

    # -------------------------------------------------------------- events
    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 pid: int = 0, tid: int = 0, cat: str = "",
                 args: dict | None = None) -> None:
        """A complete duration span ("X"): one event carrying ts + dur."""
        ev = {"ph": "X", "name": name, "ts": ts_us, "dur": max(dur_us, 0.0),
              "pid": pid, "tid": tid}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, ts_us: float, *, pid: int = 0, tid: int = 0,
                cat: str = "", scope: str = "t",
                args: dict | None = None) -> None:
        ev = {"ph": "i", "name": name, "ts": ts_us, "pid": pid, "tid": tid,
              "s": scope}
        if cat:
            ev["cat"] = cat
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, ts_us: float, values: dict, *,
                pid: int = 0, tid: int = 0) -> None:
        """A counter sample ("C"): Perfetto plots each key as a series."""
        self.events.append({"ph": "C", "name": name, "ts": ts_us, "pid": pid,
                            "tid": tid, "args": values})

    # -------------------------------------------------------------- export
    def to_json(self) -> dict:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)


def validate_trace_events(obj) -> list[dict]:
    """Check ``obj`` is trace_event JSON (object format or bare array);
    returns the event list.  Raises ``ValueError`` on malformed input —
    used by CI to assert a written trace actually loads in Perfetto."""
    events = obj.get("traceEvents") if isinstance(obj, dict) else obj
    if not isinstance(events, list):
        raise ValueError("not trace_event JSON: no traceEvents array")
    for ev in events:
        if not isinstance(ev, dict) or "ph" not in ev:
            raise ValueError(f"malformed trace event: {ev!r}")
        if ev["ph"] in ("X", "i", "C", "b", "e") and "ts" not in ev:
            raise ValueError(f"event missing ts: {ev!r}")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"complete event missing dur: {ev!r}")
    return events
