"""Schema-level validators for the telemetry export surfaces.

The port's copy of ``repro.obs.validate``, which imports no JAX: the port
imports nothing of the reference, so it keeps its own.

Two checks, used by tests/test_serving.py and the CI observability lane
over the output of a short streaming replay (DESIGN.md §14):

- ``validate_chrome_trace`` — every Chrome trace event carries
  ``ph``/``pid``/``tid``/``name`` and (metadata events aside) a numeric
  ``ts``; span durations are non-negative; the payload is JSON-ready.
- ``validate_event_log`` — every JSON-lines record carries a numeric
  ``t`` timestamp and a ``kind``, and every record of a request-scoped
  kind (``REQUEST_SCOPED_KINDS``) carries ``request_id`` (plus
  ``trace_id``/``tenant``, the §14 request-propagation fields).

Both raise ``TraceValidationError`` naming the first offending record —
validators are for tests and CI, so a precise failure beats a boolean.
"""
from __future__ import annotations

import json
from numbers import Number
from typing import Iterable, Union

# Chrome trace-event phases the Tracer emits (trace.py): M metadata, X
# complete spans, i instants, C counter samples.
KNOWN_PHASES = {"M", "X", "i", "C"}

# Event-log kinds that are about one specific request and therefore must
# carry the request-scoped correlation fields.
REQUEST_SCOPED_KINDS = {"submit", "admit", "harvest", "evict",
                        "evict_waiting"}
REQUEST_FIELDS = ("request_id", "trace_id", "tenant")


class TraceValidationError(AssertionError):
    pass


def _fail(msg: str, rec) -> None:
    raise TraceValidationError(f"{msg}: {json.dumps(rec, default=str)[:300]}")


def validate_chrome_trace(trace: Union[dict, Iterable[dict]]) -> int:
    """Validate a Chrome trace dict (``{"traceEvents": [...]}``) or a raw
    event iterable; returns the number of events checked."""
    if isinstance(trace, dict):
        if "traceEvents" not in trace:
            _fail("chrome trace missing traceEvents", list(trace))
        events = trace["traceEvents"]
    else:
        events = list(trace)
    json.dumps(events)                          # JSON-ready end to end
    n = 0
    for ev in events:
        n += 1
        for field in ("ph", "pid", "tid", "name"):
            if field not in ev:
                _fail(f"trace event missing {field!r}", ev)
        if ev["ph"] not in KNOWN_PHASES:
            _fail(f"unknown phase {ev['ph']!r}", ev)
        if ev["ph"] != "M":                     # metadata has no timestamp
            if not isinstance(ev.get("ts"), Number):
                _fail("non-metadata event missing numeric ts", ev)
        if ev["ph"] == "X":
            if not isinstance(ev.get("dur"), Number) or ev["dur"] < 0:
                _fail("span missing non-negative dur", ev)
    return n


def validate_event_log(records: Iterable[Union[dict, str, bytes]]) -> int:
    """Validate event-log records (dicts, or JSON-lines strings straight
    from an ``--events-out`` file); returns the number checked."""
    n = 0
    for rec in records:
        if isinstance(rec, (str, bytes)):
            try:
                rec = json.loads(rec)
            except json.JSONDecodeError:
                _fail("event-log line is not JSON", str(rec)[:200])
        n += 1
        if not isinstance(rec.get("t"), Number):
            _fail("event missing numeric t", rec)
        if not isinstance(rec.get("kind"), str):
            _fail("event missing kind", rec)
        if rec["kind"] in REQUEST_SCOPED_KINDS:
            for field in REQUEST_FIELDS:
                if field not in rec:
                    _fail(f"request-scoped {rec['kind']!r} event missing "
                          f"{field!r}", rec)
    return n


def validate_event_log_file(path: str) -> int:
    with open(path) as f:
        return validate_event_log(f)
