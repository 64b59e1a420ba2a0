"""Phase histograms: plain-int duration histograms rendered at scrape
time (the ``PhaseHistograms`` / ``PhaseHistogramCollector`` part of
``production_stack_tpu/tracing.py``; the span recorder and traceparent
propagation are not ported).

The engine loop does one bisect and two adds per observation, under a
lock held only for those adds; the Prometheus exposition reads the
arrays when ``/metrics`` is scraped, through a custom collector, so no
``prometheus_client`` object is touched on the loop.
"""

import threading
from bisect import bisect_right
from typing import Dict, Sequence, Tuple

# phase-duration histogram bucket bounds (seconds), the JAX package's
PHASE_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0)


class PhaseHistograms:
    """Plain-int duration histograms, one series per label tuple.
    ``labelnames`` is usually ``("phase",)``."""

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
