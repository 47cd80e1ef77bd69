"""Counter/gauge/histogram registry: the host-side metrics surface.

The port's copy of ``repro.obs.registry``, which imports no JAX: the port
imports nothing of the reference, so it keeps its own.

The solver services used to keep ad-hoc stats in plain Python lists and
ints (``StreamingSolverService._latencies`` grew one float per completed
request, forever, over a long-lived service).  This module replaces them
with a tiny named-instrument registry:

- ``Counter``  — monotone int (requests submitted, slots filled, ...).
- ``Gauge``    — last-written float (current occupancy, queue depth, ...).
- ``Histogram``— **bounded**: a fixed-capacity deque of recent samples for
  percentiles, plus *exact* running ``count``/``total``/``vmax`` fields so
  means, rates and maxima never drift no matter how many samples the
  window has dropped (DESIGN.md §13).

Instruments are created on first use (``registry.counter("fills")``), so
call sites never pre-declare schemas; ``snapshot()`` emits one nested
JSON-ready dict — the stable export schema the CLI's ``--metrics-out``
writes and CI validates.

Labeled families (DESIGN.md §14): every accessor takes optional keyword
labels — ``registry.counter("slo_completed", tenant="acme")`` — and each
distinct (name, label-set) pair is its own instrument.  ``snapshot()``
renders labeled instruments under Prometheus-style flat keys
(``slo_completed{tenant="acme"}``); unlabeled names stay plain strings,
so the pre-label schema is unchanged.  ``families()`` iterates the
structured (name, labels, kind, instrument) view the ``/metrics``
exposition endpoint renders from (obs/serving.py).
"""
from __future__ import annotations

import math
from collections import deque
from typing import Iterator, Optional


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded sample window + exact running aggregates.

    ``count``/``total``/``vmax`` are updated on every ``observe`` and are
    exact over the full stream; percentiles come from the most recent
    ``window`` samples only.  ``mean()`` is therefore exact while
    ``percentile(q)`` is a recent-window estimate — the trade the
    unbounded lists made implicitly in the other direction (exact
    percentiles, unbounded memory).

    Edge-case contract (tests/test_obs.py locks it):

    - empty window: ``mean``/``max``/``percentile`` all return 0.0;
    - single sample: every percentile is that sample;
    - window overflow (count > window): ``count``/``total``/``vmax``
      keep covering the *full* stream while percentiles cover only the
      surviving window — ``percentile(0)`` is the window minimum, not
      the stream minimum;
    - ``q`` outside [0, 100] clamps to the window extremes rather than
      indexing out of range.
    """
    __slots__ = ("samples", "count", "total", "vmax")

    def __init__(self, window: int = 4096) -> None:
        if window < 1:
            raise ValueError(f"window {window} < 1")
        self.samples: deque[float] = deque(maxlen=window)
        self.count = 0
        self.total = 0.0
        self.vmax = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.samples.append(v)
        self.count += 1
        self.total += v
        if v > self.vmax:
            self.vmax = v

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def max(self) -> float:
        return self.vmax if self.count else 0.0

    def percentile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        # The exposition endpoint (obs/serving.py) reads from its own
        # thread; copying a deque the service thread is appending to can
        # raise "deque mutated during iteration" — retry the copy.
        for _ in range(4):
            try:
                xs = sorted(self.samples)
                break
            except RuntimeError:
                continue
        else:
            xs = sorted(list(self.samples))
        if not xs:
            return 0.0
        q = min(max(q, 0.0), 100.0)
        # nearest-rank on the window, matching np.percentile's default
        # closely enough for latency reporting
        pos = (len(xs) - 1) * q / 100.0
        lo, hi = int(math.floor(pos)), int(math.ceil(pos))
        if lo == hi:
            return xs[lo]
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean": self.mean(),
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "max": self.max(),
            "window": self.samples.maxlen,
        }


# A family key is (name, sorted (label, value) tuple); the empty tuple is
# the unlabeled instrument, which snapshot() renders under the bare name.
_Key = tuple


def _key(name: str, labels: dict) -> _Key:
    return (name, tuple(sorted((str(k), str(v))
                               for k, v in labels.items())))


def _render_key(key: _Key) -> str:
    name, labels = key
    if not labels:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return f"{name}{{{inner}}}"


class Registry:
    """Create-on-first-use instrument registry with one snapshot schema."""

    def __init__(self) -> None:
        self._counters: dict[_Key, Counter] = {}
        self._gauges: dict[_Key, Gauge] = {}
        self._histograms: dict[_Key, Histogram] = {}

    def counter(self, name: str, **labels) -> Counter:
        k = _key(name, labels)
        c = self._counters.get(k)
        if c is None:
            c = self._counters[k] = Counter()
        return c

    def gauge(self, name: str, **labels) -> Gauge:
        k = _key(name, labels)
        g = self._gauges.get(k)
        if g is None:
            g = self._gauges[k] = Gauge()
        return g

    def histogram(self, name: str, window: Optional[int] = None,
                  **labels) -> Histogram:
        k = _key(name, labels)
        h = self._histograms.get(k)
        if h is None:
            h = self._histograms[k] = Histogram(window or 4096)
        return h

    def families(self) -> Iterator[tuple[str, dict, str, object]]:
        """Structured (name, labels, kind, instrument) iteration — the
        view obs/serving.py renders the Prometheus text format from.
        Sorted by (name, labels) so exposition output is stable."""
        for kind, store in (("counter", self._counters),
                            ("gauge", self._gauges),
                            ("histogram", self._histograms)):
            for (name, labels) in sorted(store):
                yield name, dict(labels), kind, store[(name, labels)]

    def snapshot(self) -> dict:
        """Nested JSON-ready view: the ``registry`` section of the
        ``repro.obs/v1`` metrics schema (DESIGN.md §13).  Labeled
        instruments appear under ``name{k="v",...}`` flat keys."""
        return {
            "counters": {_render_key(k): c.value
                         for k, c in sorted(self._counters.items())},
            "gauges": {_render_key(k): g.value
                       for k, g in sorted(self._gauges.items())},
            "histograms": {_render_key(k): h.summary()
                           for k, h in sorted(self._histograms.items())},
        }
