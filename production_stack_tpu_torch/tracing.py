"""In-process request tracing: spans, W3C traceparent, phase histograms
(``production_stack_tpu/tracing.py``), for the engine and the router.

- **Context.** ``parse_traceparent`` / ``format_traceparent`` read and
  write ``traceparent: 00-<32 hex trace-id>-<16 hex parent-id>-<2 hex
  flags>`` (https://www.w3.org/TR/trace-context/ level 1); a malformed
  header starts a fresh trace, never an error. The sampled flag
  (``-01``) propagates: an inbound flag wins over the local sample rate
  in both directions, so a chain across the router and the engines is
  recorded whole or not at all.
- **Spans.** A ``RequestTrace`` appends ``(name, kind, start, dur,
  status, attrs)`` tuples. ``"phase"`` spans are non-overlapping slices
  of the request's wall time; ``"event"`` spans (a tokenize, a KV-tier
  prefetch) show in the trace but never count as a phase, so the
  unattributed time (duration minus the phase sum) stays honest. A
  sealed trace drops late spans.
- **Bounded.** ``TraceRecorder`` keeps completed sampled traces in a
  ring of ``ring_entries``; ``GET /debug/traces``
  (``debug_traces_handler``) renders them when it is read, never on the
  request path.
- **Phase histograms.** Plain-int duration histograms rendered at
  scrape time: the engine loop does one bisect and two adds per
  observation under a lock held only for those adds; the Prometheus
  exposition reads the arrays when ``/metrics`` is scraped, through a
  custom collector, so no ``prometheus_client`` object is touched on
  the loop.
"""

import collections
import os
import random
import threading
import time
from bisect import bisect_right
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# phase-duration histogram bucket bounds (seconds), the JAX package's
PHASE_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0)

_FLAG_SAMPLED = 0x01


# ---------------------------------------------------------------- context

def new_trace_id() -> str:
    return os.urandom(16).hex()


def new_span_id() -> str:
    return os.urandom(8).hex()


def parse_traceparent(header: Optional[str]
                      ) -> Optional[Tuple[str, str, bool]]:
    """``(trace_id, parent_span_id, sampled)``, or None when the header
    is absent or malformed."""
    if not header:
        return None
    parts = header.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16 \
            or len(flags) != 2:
        return None
    try:
        int(version, 16)
        int(trace_id, 16)
        int(span_id, 16)
        flag_bits = int(flags, 16)
    except ValueError:
        return None
    if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
        return None                      # the spec's invalid sentinels
    return trace_id, span_id, bool(flag_bits & _FLAG_SAMPLED)


def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    return f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"


# ---------------------------------------------------------------- spans

class RequestTrace:
    """One request's spans inside one process. ``start`` may be None for
    a duration-only span (work measured elsewhere, e.g. the KV prefetch
    that ran on another thread)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "sampled", "name",
                 "started_at", "t0", "spans", "status", "attrs",
                 "_sealed", "duration_s", "seq")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], sampled: bool, name: str,
                 attrs: Optional[dict] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.sampled = sampled
        self.name = name
        self.started_at = time.time()
        self.t0 = time.monotonic()
        self.spans: List[tuple] = []
        self.status = "ok"
        self.attrs = attrs or {}
        self._sealed = False
        self.duration_s = 0.0
        # the ring's sequence number, given when the trace enters it (0 =
        # never ringed): the /debug/traces since_seq cursor
        self.seq = 0

    def add_span(self, name: str, start: Optional[float],
                 dur_s: float, kind: str = "phase", status: str = "ok",
                 attrs: Optional[dict] = None) -> None:
        if self._sealed:
            return
        self.spans.append((name, kind, start, dur_s, status, attrs))

    def add_phase(self, name: str, start: float, end: float,
                  status: str = "ok",
                  attrs: Optional[dict] = None) -> None:
        self.add_span(name, start, end - start, "phase", status, attrs)

    def add_event(self, name: str, start: Optional[float], dur_s: float,
                  status: str = "ok",
                  attrs: Optional[dict] = None) -> None:
        self.add_span(name, start, dur_s, "event", status, attrs)

    def child_traceparent(self) -> str:
        """The context the next hop parents onto (this process's span)."""
        return format_traceparent(self.trace_id, self.span_id,
                                  self.sampled)

    def seal(self, status: str = "ok",
             end: Optional[float] = None) -> None:
        if self._sealed:
            return
        self.status = status
        self.duration_s = (end if end is not None
                           else time.monotonic()) - self.t0
        self._sealed = True

    def phase_totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, kind, _start, dur, _status, _attrs in self.spans:
            if kind == "phase":
                out[name] = out.get(name, 0.0) + dur
        return out

    def unattributed_s(self) -> float:
        return max(0.0, self.duration_s
                   - sum(self.phase_totals().values()))

    def render(self) -> dict:
        """The /debug/traces row."""
        spans = []
        for name, kind, start, dur, status, attrs in self.spans:
            row = {
                "name": name,
                "kind": kind,
                "start_ms": (None if start is None
                             else round(1e3 * (start - self.t0), 3)),
                "duration_ms": round(1e3 * dur, 3),
                "status": status,
            }
            if attrs:
                row["attrs"] = attrs
            spans.append(row)
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "seq": self.seq,
            "name": self.name,
            "status": self.status,
            "started_at": round(self.started_at, 3),
            "duration_ms": round(1e3 * self.duration_s, 3),
            "unattributed_ms": round(1e3 * self.unattributed_s(), 3),
            "attrs": self.attrs,
            "spans": spans,
        }


# ---------------------------------------------------------------- histograms

class PhaseHistograms:
    """Plain-int duration histograms, one series per label tuple.
    ``labelnames`` is usually ``("phase",)`` (engine) or ``("phase",
    "server")`` (router: per-endpoint series, dropped by
    ``evict_except`` when the endpoint leaves the fleet)."""

    def __init__(self, labelnames: Sequence[str] = ("phase",),
                 buckets: Sequence[float] = PHASE_BUCKETS):
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets)
        # labels tuple -> [counts per bucket + overflow], sum, count
        self._series: Dict[tuple, list] = {}
        self._lock = threading.Lock()

    def observe(self, *args: object) -> None:
        """``observe(label1, ..., dur_s)``."""
        labels, dur = tuple(args[:-1]), float(args[-1])  # type: ignore
        idx = bisect_right(self.buckets, dur)
        with self._lock:
            series = self._series.get(labels)
            if series is None:
                series = self._series.setdefault(
                    labels, [[0] * (len(self.buckets) + 1), 0.0, 0])
            series[0][idx] += 1
            series[1] += dur
            series[2] += 1

    def snapshot(self) -> Dict[tuple, tuple]:
        """{labels: (cumulative bucket counts, sum, count)}."""
        out = {}
        with self._lock:
            items = list(self._series.items())
        for labels, (counts, total, n) in items:
            acc, cum = 0, []
            for c in counts:
                acc += c
                cum.append(acc)
            out[labels] = (tuple(cum), total, n)
        return out

    def evict_except(self, live: Iterable[str],
                     label_index: int = 1) -> int:
        """Drop series whose ``label_index`` label (the ``server``
        label) is not in ``live`` — per-endpoint phase series must not
        outlive the endpoint across dynamic-config swaps (the r8
        ``refresh_resilience`` precedent). Series with an empty label
        (router-local phases) are never evicted. Returns how many
        series were dropped."""
        live = set(live)
        with self._lock:
            dead = [labels for labels in self._series
                    if len(labels) > label_index
                    and labels[label_index]
                    and labels[label_index] not in live]
            for labels in dead:
                del self._series[labels]
        return len(dead)


class PhaseHistogramCollector:
    """prometheus_client custom collector over a ``PhaseHistograms``."""

    def __init__(self, name: str, documentation: str,
                 phases: PhaseHistograms):
        self.name = name
        self.documentation = documentation
        self.phases = phases

    def _family(self):
        from prometheus_client.core import HistogramMetricFamily
        return HistogramMetricFamily(self.name, self.documentation,
                                     labels=self.phases.labelnames)

    def describe(self):
        # registration must not trigger a collect
        return [self._family()]

    def collect(self):
        fam = self._family()
        for labels, (cum, total, _n) in self.phases.snapshot().items():
            buckets = [(str(b), c) for b, c in
                       zip(self.phases.buckets, cum)]
            buckets.append(("+Inf", cum[-1]))
            fam.add_metric(list(labels), buckets, sum_value=total)
        yield fam


# ---------------------------------------------------------------- recorder

class TraceRecorder:
    """Mints or continues trace contexts and keeps the bounded ring of
    completed traces. ``sample_rate`` gates which traces enter the ring
    (the phase histograms always record); an inbound sampled flag wins
    in both directions."""

    def __init__(self, service: str, ring_entries: int = 2048,
                 sample_rate: float = 1.0):
        self.service = service
        self.sample_rate = max(0.0, min(1.0, sample_rate))
        self.ring: "collections.deque[RequestTrace]" = \
            collections.deque(maxlen=max(1, ring_entries))
        self.traces_started = 0
        self.traces_recorded = 0
        # the last ring sequence number handed out: a scraper that read
        # up to N asks since_seq=N next and neither re-reads nor misses
        # a trace while the ring rotates
        self.last_seq = 0
        self._rng = random.Random(os.urandom(8))

    def begin(self, traceparent: Optional[str] = None,
              name: str = "request",
              attrs: Optional[dict] = None) -> RequestTrace:
        self.traces_started += 1
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            trace_id, parent_id, sampled = parsed
        else:
            trace_id, parent_id = new_trace_id(), None
            sampled = (self.sample_rate >= 1.0
                       or self._rng.random() < self.sample_rate)
        return RequestTrace(trace_id, new_span_id(), parent_id, sampled,
                            name, attrs)

    def finish(self, trace: RequestTrace, status: str = "ok") -> None:
        if trace._sealed:
            return                    # a second finish must not re-ring
        trace.seal(status)
        if trace.sampled:
            self.last_seq += 1
            trace.seq = self.last_seq
            self.ring.append(trace)
            self.traces_recorded += 1

    def snapshot(self, trace_id: Optional[str] = None,
                 slowest: Optional[int] = None,
                 limit: int = 100,
                 since_seq: Optional[int] = None) -> List[dict]:
        traces = list(self.ring)
        if since_seq is not None:
            # the ring is append-ordered: a suffix
            traces = [t for t in traces if t.seq > since_seq]
        if trace_id:
            traces = [t for t in traces if t.trace_id == trace_id]
        if slowest:
            traces = sorted(traces, key=lambda t: t.duration_s,
                            reverse=True)[:slowest]
        else:
            traces = traces[-limit:]
        return [t.render() for t in traces]


def debug_traces_handler(get_recorder):
    """aiohttp handler factory for ``GET /debug/traces``. Query
    parameters: ``trace_id`` (exact match), ``slowest=N``, ``limit=N``
    (the newest N, default 100) and ``since_seq=N`` (only traces ringed
    after N; the reply's ``last_seq`` is the next cursor).
    ``get_recorder`` is a zero-argument callable."""
    from aiohttp import web

    async def handler(request: web.Request) -> web.Response:
        rec: TraceRecorder = get_recorder()

        def intq(key, default=None, floor=1):
            raw = request.query.get(key)
            if raw is None:
                return default
            try:
                return max(floor, int(raw))
            except ValueError:
                return default

        traces = rec.snapshot(
            trace_id=request.query.get("trace_id"),
            slowest=intq("slowest"),
            limit=intq("limit", 100) or 100,
            since_seq=intq("since_seq", None, floor=0))
        return web.json_response({
            "service": rec.service,
            "ring_entries": rec.ring.maxlen,
            "traces_started": rec.traces_started,
            "traces_recorded": rec.traces_recorded,
            "last_seq": rec.last_seq,
            "sample_rate": rec.sample_rate,
            "returned": len(traces),
            "traces": traces,
        })

    return handler
