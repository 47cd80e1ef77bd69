"""Span timer, structured event log, and Chrome-trace (Perfetto) export.

Two host-side recording surfaces (DESIGN.md §13):

- ``Tracer`` — wall-clock spans and instants on named (process, thread)
  tracks, exported as Chrome trace-event JSON (``{"traceEvents": [...]}``)
  that loads directly in Perfetto / ``chrome://tracing``.  The solver
  services map devices to processes and buckets / slots to threads, so a
  streaming run renders as per-device tracks of chunk dispatches with one
  span per resident request lifetime.
- ``EventLog`` — append-only JSON-lines records (``{"t": ..., "kind": ...,
  ...}``) for the slot lifecycle (submit → admit → chunk → harvest/evict)
  and periodic stats snapshots; greppable and cheap to tail.

Both are **bounded**: a fixed event capacity with an exact ``dropped``
count, so a long-lived service cannot leak memory through its own
observability (the same discipline registry.Histogram applies to
latency samples).

The port's copy of ``repro.obs.trace``: ``Tracer`` and ``EventLog`` as
they are there.  The profiler hooks are ``torch.profiler``'s:
``profile_start`` starts a capture of the host and the card and
``profile_stop`` writes it as a Chrome trace into the capture's
directory; ``step_annotation`` wraps ``torch.profiler.record_function``
so chunk steps show up as named ranges in that trace.  The torch imports
are lazy: building a Tracer never touches device state.
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager
from typing import Optional


class Tracer:
    """Record spans/instants/counters on (process, thread) tracks."""

    def __init__(self, max_events: int = 200_000,
                 clock=time.perf_counter) -> None:
        self._clock = clock
        self._t0 = clock()
        self._events: deque[dict] = deque(maxlen=max_events)
        self._meta: list[dict] = []          # track-name metadata events
        self._pids: dict[str, int] = {}
        self._tids: dict[tuple[str, str], int] = {}
        self.dropped = 0

    # ------------------------------------------------------------- tracks
    def track(self, process: str = "main", thread: str = "main"
              ) -> tuple[int, int]:
        """Intern a (process, thread) pair into Chrome (pid, tid) ids and
        emit the name metadata the first time each is seen."""
        pid = self._pids.get(process)
        if pid is None:
            pid = self._pids[process] = len(self._pids)
            self._meta.append({"ph": "M", "name": "process_name",
                               "pid": pid, "tid": 0,
                               "args": {"name": process}})
        key = (process, thread)
        tid = self._tids.get(key)
        if tid is None:
            tid = self._tids[key] = sum(
                1 for (p, _) in self._tids if p == process)
            self._meta.append({"ph": "M", "name": "thread_name",
                               "pid": pid, "tid": tid,
                               "args": {"name": thread}})
        return pid, tid

    # -------------------------------------------------------------- clock
    def now_us(self) -> float:
        return (self._clock() - self._t0) * 1e6

    def to_us(self, t: float) -> float:
        """Convert a raw clock reading (same clock as this tracer's —
        time.perf_counter by default) to trace microseconds."""
        return (t - self._t0) * 1e6

    def _push(self, ev: dict) -> None:
        if len(self._events) == self._events.maxlen:
            self.dropped += 1
        self._events.append(ev)

    # ------------------------------------------------------------- events
    @contextmanager
    def span(self, name: str, process: str = "main", thread: str = "main",
             **args):
        """Complete-event span ("X") covering the with-block wall time."""
        pid, tid = self.track(process, thread)
        ts = self.now_us()
        try:
            yield
        finally:
            self._push({"ph": "X", "name": name, "pid": pid, "tid": tid,
                        "ts": ts, "dur": self.now_us() - ts,
                        "args": args})

    def complete(self, name: str, ts_us: float, dur_us: float,
                 process: str = "main", thread: str = "main", **args) -> None:
        """Record an already-measured span (e.g. a slot's residency,
        stamped at harvest from its fill timestamp)."""
        pid, tid = self.track(process, thread)
        self._push({"ph": "X", "name": name, "pid": pid, "tid": tid,
                    "ts": ts_us, "dur": dur_us, "args": args})

    def instant(self, name: str, process: str = "main",
                thread: str = "main", **args) -> None:
        pid, tid = self.track(process, thread)
        self._push({"ph": "i", "s": "t", "name": name, "pid": pid,
                    "tid": tid, "ts": self.now_us(), "args": args})

    def counter(self, name: str, process: str = "main", **values) -> None:
        """Chrome counter track ("C"): Perfetto renders it as a stacked
        area chart (occupancy, queue depth)."""
        pid, _ = self.track(process, "main")
        self._push({"ph": "C", "name": name, "pid": pid, "tid": 0,
                    "ts": self.now_us(), "args": values})

    def request_chain(self, request_id) -> list[dict]:
        """Recover one request's span chain (DESIGN.md §14): every event
        whose args carry its ``request_id`` — the retroactive ``queued``
        span, the slot-residency span, each ``chunk_dispatch`` listing it
        resident — sorted by timestamp.  The same filter an operator runs
        in the Perfetto UI, as an API."""
        out = []
        for ev in self._events:
            args = ev.get("args") or {}
            if args.get("request_id") == request_id or \
                    request_id in (args.get("request_ids") or ()):
                out.append(ev)
        return sorted(out, key=lambda e: e.get("ts", 0.0))

    # ------------------------------------------------------------- export
    def to_chrome(self) -> dict:
        return {"traceEvents": self._meta + list(self._events),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)


class EventLog:
    """Bounded in-memory JSON-lines event record, optionally mirrored to a
    file as records arrive (line-buffered append)."""

    def __init__(self, path: Optional[str] = None,
                 max_records: int = 100_000) -> None:
        self._records: deque[dict] = deque(maxlen=max_records)
        self.dropped = 0
        self._fh = open(path, "a", buffering=1) if path else None

    def emit(self, kind: str, **fields) -> None:
        rec = {"t": time.time(), "kind": kind, **fields}
        if len(self._records) == self._records.maxlen:
            self.dropped += 1
        self._records.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")

    def records(self) -> list[dict]:
        return list(self._records)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# ------------------------------------------------------- torch.profiler
def profile_start():
    """Start a ``torch.profiler`` capture (host, and the card where there
    is one); returns the handle ``profile_stop`` takes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def profile_stop(prof, log_dir: str) -> str:
    """Stop a capture and write it as a Chrome trace (Perfetto-loadable)
    into ``log_dir``; returns the file's path."""
    import os
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"torch_trace_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


@contextmanager
def step_annotation(name: str, enabled: bool = True, **kw):
    """Name the enclosed dispatches as one profiler range (chunk steps in
    a service); a no-op passthrough when disabled so the hot path pays
    nothing without a capture running.  ``kw`` (the step number, ...)
    joins the range's name."""
    if not enabled:
        yield
        return
    import torch
    label = name + "".join(f" {k}={v}" for k, v in sorted(kw.items()))
    with torch.profiler.record_function(label):
        yield
