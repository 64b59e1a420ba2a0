"""In-process SLO engine: declarative objectives, multi-window burn
rates, and an alert state machine the serving loop itself evaluates.

Until now every invariant this stack enforces (r8 chaos, r9 overload,
r10 autoscale) lived in an *offline* loadgen exit code — the running
system never decided "this is unhealthy". This module closes that gap
with the Google SRE multi-window multi-burn-rate method:

- **SLO definitions** (``SLODef``) are declarative: per-class
  availability (non-5xx fraction), latency (TTFT / e2e under a
  threshold), shed-rate, and engine load-signal objectives. The
  default set (``default_config``) covers the classes the workload
  models drive (chat, rag) plus fleet-wide shed-rate and the r9 queue
  delay signal.
- **Good/bad accounting** is a bucketed sliding ring
  (``RollingCounts``): one append-or-increment per event on the hot
  path, window reads walk whole buckets (never individual events).
  Every read takes an injectable ``now`` — deterministic tests drive
  the clock explicitly, like the stats plane's ``_Window``.
- **Burn rate** = (bad fraction over a window) / (1 - objective):
  burn 1.0 spends the error budget exactly over the SLO period,
  burn 14.4 spends a 30-day budget in ~2 days. Each alert requires
  the burn to exceed its threshold over BOTH a short and a long
  window — the short window makes detection (and resolution) fast,
  the long window keeps one bad minute from paging.
- **Alert state machine**: inactive -> pending (condition holds) ->
  firing (held for ``for_s``) -> resolved (condition clear for
  ``resolve_s``) -> pending again on re-breach. Pending that clears
  before ``for_s`` flaps back to inactive without firing.
- **Window scale** (``window_scale``): one knob multiplies every
  window / hold duration so the fire-drill rig can run the REAL
  engine against seconds-long windows. Canonical labels ("5m", "1h")
  are kept so dashboards, the exposition, and the generated
  Prometheus rules agree on series names at any scale.

The same definitions compile (``compile_prometheus_rules``, via
``tools/gen_alert_rules.py``) to ``observability/alert-rules.yaml``
over the exported ``tpu:slo_burn_rate{slo,window}`` series — the
cluster alert and the in-process alert read the same accounting, so
they cannot drift (``tools/check_alert_rules.py`` enforces sync).

Closed loop: ``python -m production_stack_tpu_torch.loadgen firedrill``
(docs/observability.md "SLOs and alerting"; per-alert diagnosis steps
in docs/runbooks.md).
"""

import collections
import json
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

# canonical burn-rate windows (label -> seconds at window_scale 1.0).
# The fast pair (5m short / 1h long) backs page alerts, the slow pair
# (30m short / 6h long) backs tickets — the SRE-workbook shape.
WINDOWS: Dict[str, float] = {
    "5m": 300.0,
    "30m": 1800.0,
    "1h": 3600.0,
    "6h": 21600.0,
}

# (severity, short window, long window, burn threshold, for_s,
#  resolve_s) — for_s/resolve_s are canonical seconds, scaled with the
# windows. Thresholds follow the SRE workbook's 30-day-budget table:
# 14.4x burns a month's budget in 2 days (wake a human), 6x in 5 days
# (file a ticket).
ALERT_PAIRS: Tuple[Tuple[str, str, str, float, float, float], ...] = (
    ("page", "5m", "1h", 14.4, 120.0, 60.0),
    ("ticket", "30m", "6h", 6.0, 300.0, 120.0),
)

# request classes: the `x-slo-class` header wins (the loadgen rigs and
# tiered clients set it); otherwise the endpoint path names the class
_PATH_CLASS = {
    "/v1/chat/completions": "chat",
    "/v1/completions": "completions",
    "/v1/embeddings": "embeddings",
    "/v1/rerank": "rerank",
    "/v2/rerank": "rerank",
    "/v1/score": "score",
}

CLASS_HEADER = "x-slo-class"

INACTIVE, PENDING, FIRING, RESOLVED = ("inactive", "pending", "firing",
                                       "resolved")
# /metrics encoding of the state machine (tpu:alert_state)
STATE_CODE = {INACTIVE: 0, RESOLVED: 0, PENDING: 1, FIRING: 2}


def classify_request(path: str, headers) -> str:
    """SLO class of one request: explicit header, else path family."""
    cls = headers.get(CLASS_HEADER) if headers is not None else None
    if cls:
        return str(cls)[:32]
    return _PATH_CLASS.get(path, "other")


# ---------------------------------------------------------------- defs

@dataclass
class SLODef:
    """One declarative objective.

    kind:
      availability — good = response below 500 and not truncated;
                     sheds (429/503 + Retry-After, deadline 504) are
                     EXCLUDED (intentional backpressure is the
                     shed_rate SLO's business, not an outage)
      latency      — good = ``metric`` ("ttft" | "e2e") of an OK
                     response <= ``threshold_s``
      shed_rate    — good = request admitted (not shed)
      signal       — good = an engine /load sample's ``metric``
                     ("est_queue_delay_ms") <= ``bound``
    ``request_class`` filters request-fed kinds (None = every class).
    """

    name: str
    kind: str
    objective: float
    request_class: Optional[str] = None
    metric: Optional[str] = None
    threshold_s: Optional[float] = None
    bound: Optional[float] = None
    description: str = ""

    def validate(self) -> "SLODef":
        if self.kind not in ("availability", "latency", "shed_rate",
                             "signal"):
            raise ValueError(f"unknown SLO kind {self.kind!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"SLO {self.name}: objective must be in "
                             f"(0, 1), got {self.objective}")
        if self.kind == "latency":
            if self.metric not in ("ttft", "e2e"):
                raise ValueError(f"SLO {self.name}: latency metric must "
                                 f"be 'ttft' or 'e2e'")
            if not self.threshold_s or self.threshold_s <= 0:
                raise ValueError(f"SLO {self.name}: latency needs a "
                                 f"positive threshold_s")
        if self.kind == "signal" and (self.bound is None
                                      or self.bound <= 0):
            raise ValueError(f"SLO {self.name}: signal needs a positive "
                             f"bound")
        return self

    @property
    def error_budget(self) -> float:
        return 1.0 - self.objective

    def to_json(self) -> dict:
        out = {"name": self.name, "kind": self.kind,
               "objective": self.objective}
        for k in ("request_class", "metric", "threshold_s", "bound",
                  "description"):
            v = getattr(self, k)
            if v not in (None, ""):
                out[k] = v
        return out


@dataclass
class SLOConfig:
    """The SLO set plus the evaluation knobs one engine instance runs.

    ``window_scale`` multiplies every window and hold duration
    (labels stay canonical); ``min_events`` is the volume floor BOTH
    windows of an alert must hold before its condition can be true —
    one bad event against an empty window must never page.
    """

    slos: List[SLODef] = field(default_factory=list)
    window_scale: float = 1.0
    min_events: int = 12

    def validate(self) -> "SLOConfig":
        if self.window_scale <= 0:
            raise ValueError("window_scale must be positive")
        seen = set()
        for slo in self.slos:
            slo.validate()
            if slo.name in seen:
                raise ValueError(f"duplicate SLO name {slo.name!r}")
            seen.add(slo.name)
        return self

    def window_s(self, label: str) -> float:
        return WINDOWS[label] * self.window_scale

    @property
    def horizon_s(self) -> float:
        return max(WINDOWS.values()) * self.window_scale

    @classmethod
    def from_json(cls, data: dict) -> "SLOConfig":
        slos = [SLODef(**s) for s in data.get("slos", [])]
        return cls(slos=slos,
                   window_scale=float(data.get("window_scale", 1.0)),
                   min_events=int(data.get("min_events", 12))).validate()

    @classmethod
    def from_file(cls, path: str) -> "SLOConfig":
        with open(path) as f:
            return cls.from_json(json.load(f))


def default_slos() -> List[SLODef]:
    return [
        SLODef("chat_availability", "availability", 0.99,
               request_class="chat",
               description="chat requests answered without a 5xx or a "
                           "truncated stream"),
        SLODef("rag_availability", "availability", 0.99,
               request_class="rag",
               description="rag requests answered without a 5xx or a "
                           "truncated stream"),
        SLODef("chat_ttft", "latency", 0.99, request_class="chat",
               metric="ttft", threshold_s=2.0,
               description="chat time-to-first-token under 2 s "
                           "(router-observed backend TTFB)"),
        SLODef("rag_e2e", "latency", 0.99, request_class="rag",
               metric="e2e", threshold_s=30.0,
               description="rag end-to-end latency under 30 s"),
        SLODef("shed_rate", "shed_rate", 0.99,
               description="requests admitted rather than shed "
                           "(429/503 + Retry-After, expired "
                           "deadlines) across every class"),
        SLODef("tier0_shed_rate", "shed_rate", 0.99,
               request_class="tier0",
               description="top-priority (tier0) requests admitted "
                           "rather than shed — with QoS tiers on "
                           "(router/qos.py), the one tier the "
                           "low-tier-first contract says must hold "
                           "under saturation"),
        SLODef("engine_queue_delay", "signal", 0.99,
               metric="est_queue_delay_ms", bound=5000.0,
               description="scraped engine /load queue-delay estimate "
                           "under 5 s"),
        SLODef("router_peer_lost", "signal", 0.99,
               metric="peer_age_s", bound=10.0,
               description="peer router replicas answering gossip "
                           "within 10 s (router/shared_state.py; "
                           "fed only once a peer has been seen, so "
                           "single-router deployments stay silent)"),
    ]


def default_config(window_scale: float = 1.0,
                   min_events: int = 12) -> SLOConfig:
    return SLOConfig(slos=default_slos(), window_scale=window_scale,
                     min_events=min_events).validate()


# ---------------------------------------------------------------- windows

class RollingCounts:
    """Bucketed sliding good/bad counters over ``horizon_s``.

    The hot path increments the newest bucket (appending a fresh one
    when the clock crossed a bucket boundary); window reads walk at
    most ``horizon_s / bucket_s`` buckets newest-first and stop at the
    window edge. A sample at time ``t`` counts toward a window ``W``
    read at ``now`` iff its bucket overlaps ``(now - W, now]`` — edge
    resolution is one bucket, which ``bucket_s`` sizes well inside the
    shortest window. ``now`` is injectable everywhere (tests drive a
    synthetic clock; ``0.0`` is a timestamp, not "not provided").
    """

    def __init__(self, horizon_s: float, bucket_s: Optional[float] = None):
        if bucket_s is None:
            # fine enough for the shortest canonical window at this
            # horizon's scale: 6h horizon -> 1.08 s buckets vs the 5 m
            # short window; a 0.005-scaled drill gets 54 ms buckets
            bucket_s = max(0.05, horizon_s / 20000.0)
        self.horizon = horizon_s
        self.bucket_s = bucket_s
        # each bucket: [start_ts, good, bad]
        self._buckets: collections.deque = collections.deque()

    def _bucket_start(self, now: float) -> float:
        return now - (now % self.bucket_s)

    def add(self, good: int, bad: int,
            now: Optional[float] = None) -> None:
        if now is None:
            now = time.time()
        start = self._bucket_start(now)
        if self._buckets and self._buckets[-1][0] == start:
            b = self._buckets[-1]
            b[1] += good
            b[2] += bad
        else:
            self._buckets.append([start, good, bad])
            self._trim(now)

    def _trim(self, now: float) -> None:
        cutoff = now - self.horizon - self.bucket_s
        while self._buckets and self._buckets[0][0] < cutoff:
            self._buckets.popleft()

    def counts(self, window_s: float,
               now: Optional[float] = None) -> Tuple[int, int]:
        """(good, bad) over the trailing ``window_s``."""
        if now is None:
            now = time.time()
        edge = now - window_s
        good = bad = 0
        for start, g, b in reversed(self._buckets):
            if start + self.bucket_s <= edge:
                break
            if start > now:        # clock moved backwards in a test
                continue
            good += g
            bad += b
        return good, bad


def burn_rate(good: int, bad: int, error_budget: float) -> float:
    """Bad fraction over the window divided by the error budget.
    An empty window burns nothing (there is no traffic to be bad)."""
    total = good + bad
    if total <= 0 or bad <= 0:
        return 0.0
    return (bad / total) / error_budget


# ---------------------------------------------------------------- alerts

@dataclass
class AlertRule:
    """One multi-window burn-rate alert over one SLO (scaled seconds)."""

    name: str
    slo: str
    severity: str
    short_window: str
    long_window: str
    burn_threshold: float
    for_s: float
    resolve_s: float

    def runbook(self) -> str:
        return f"docs/runbooks.md#{self.name}"


class AlertState:
    """The pending -> firing -> resolved machine for one rule.

    ``evaluate(condition, now)`` is the only transition point; it is
    idempotent for a constant condition at a constant clock. A pending
    alert whose condition clears before ``for_s`` flaps back to
    inactive without firing; a firing alert resolves only after the
    condition has stayed clear for ``resolve_s`` (so a flapping burn
    cannot resolve-and-refire every tick); a resolved alert re-enters
    pending on the next breach.
    """

    def __init__(self, rule: AlertRule):
        self.rule = rule
        self.state = INACTIVE
        self.pending_since: Optional[float] = None
        self.firing_since: Optional[float] = None
        self.resolved_at: Optional[float] = None
        self.clear_since: Optional[float] = None
        self.fired_total = 0

    def evaluate(self, condition: bool, now: float) -> str:
        if condition:
            self.clear_since = None
            if self.state in (INACTIVE, RESOLVED):
                self.state = PENDING
                self.pending_since = now
            if self.state == PENDING and \
                    now - self.pending_since >= self.rule.for_s:
                self.state = FIRING
                self.firing_since = now
                self.fired_total += 1
                logger.warning("SLO alert FIRING: %s (burn > %.1fx over "
                               "%s and %s)", self.rule.name,
                               self.rule.burn_threshold,
                               self.rule.short_window,
                               self.rule.long_window)
        else:
            if self.state == PENDING:       # flap: never fired
                self.state = INACTIVE
                self.pending_since = None
            elif self.state == FIRING:
                if self.clear_since is None:
                    self.clear_since = now
                elif now - self.clear_since >= self.rule.resolve_s:
                    self.state = RESOLVED
                    self.resolved_at = now
                    self.firing_since = None
                    self.clear_since = None
                    logger.info("SLO alert resolved: %s", self.rule.name)
        return self.state

    def to_json(self) -> dict:
        r = self.rule
        return {
            "name": r.name, "slo": r.slo, "severity": r.severity,
            "state": self.state,
            "short_window": r.short_window, "long_window": r.long_window,
            "burn_threshold": r.burn_threshold,
            "for_s": r.for_s, "resolve_s": r.resolve_s,
            "pending_since": self.pending_since,
            "firing_since": self.firing_since,
            "resolved_at": self.resolved_at,
            "fired_total": self.fired_total,
            "runbook": r.runbook(),
        }


def build_alert_rules(config: SLOConfig) -> List[AlertRule]:
    """Two rules (page + ticket) per SLO, durations scaled."""
    s = config.window_scale
    rules = []
    for slo in config.slos:
        for severity, short, long_, thr, for_s, resolve_s in ALERT_PAIRS:
            rules.append(AlertRule(
                name=f"{slo.name}_{severity}", slo=slo.name,
                severity=severity, short_window=short, long_window=long_,
                burn_threshold=thr, for_s=for_s * s,
                resolve_s=resolve_s * s))
    return rules


# ---------------------------------------------------------------- engine

class SLOEngine:
    """Good/bad accounting + burn evaluation + alert states, one per
    router process.

    Request-path cost is a handful of bucket increments
    (``observe_response``); everything windowed happens in
    ``evaluate()``, which the router runs on a short interval task and
    every ``/alerts`` / ``/metrics`` read refreshes too.
    """

    def __init__(self, config: Optional[SLOConfig] = None):
        self.config = (config or default_config()).validate()
        self._counts: Dict[str, RollingCounts] = {
            slo.name: RollingCounts(self.config.horizon_s)
            for slo in self.config.slos}
        self.alerts: Dict[str, AlertState] = {
            r.name: AlertState(r) for r in build_alert_rules(self.config)}
        self._by_class: Dict[Tuple[str, str], List[SLODef]] = {}
        for slo in self.config.slos:
            if slo.kind == "signal":
                continue
            self._by_class.setdefault((slo.kind, slo.request_class or ""),
                                      []).append(slo)
        # (kind, cls) -> resolved SLO tuple, memoized per observed
        # class: the hot path must not rebuild lists per request
        self._resolved: Dict[Tuple[str, str], tuple] = {}
        self._signal_slos = [s for s in self.config.slos
                             if s.kind == "signal"]
        # last /load sample timestamp ingested per engine URL, so an
        # interval-old scrape read every eval tick counts once
        self._last_scrape: Dict[str, float] = {}
        # last evaluate() burn/volume maps: {slo: {window: value}}
        self.burns: Dict[str, Dict[str, float]] = {}
        self.volumes: Dict[str, Dict[str, int]] = {}
        self._last_eval = float("-inf")

    # -- feeding (hot path) ---------------------------------------------

    def _class_slos(self, kind: str, cls: str) -> tuple:
        key = (kind, cls)
        resolved = self._resolved.get(key)
        if resolved is None:
            out = list(self._by_class.get(key, ()))
            if cls:  # class-agnostic SLOs see every class exactly once
                out += self._by_class.get((kind, ""), ())
            resolved = tuple(out)
            # the class comes off a client header: bound the memo so
            # junk classes cannot grow it without limit
            if len(self._resolved) < 256:
                self._resolved[key] = resolved
        return resolved

    def observe_response(self, path: str, req_headers, status: int,
                         resp_headers, *,
                         ttft_s: Optional[float] = None,
                         e2e_s: Optional[float] = None,
                         truncated: bool = False,
                         now: Optional[float] = None,
                         cls: Optional[str] = None) -> None:
        """One finished (or shed) proxied request.

        Shed detection reads the response itself — 429/503 with
        ``Retry-After`` (the router's and the relayed engine's shed
        shape) or the 504 deadline marker — so the caller does not
        thread shed flags through every return path. ``cls`` overrides
        classification (the proxy passes the QoS tier name for tiered
        traffic so per-tier objectives like tier0_shed_rate see it).
        """
        if now is None:
            now = time.time()       # one clock read for every bucket add
        if cls is None:
            cls = classify_request(path, req_headers)
        shed = ((status in (429, 503)
                 and resp_headers is not None
                 and "Retry-After" in resp_headers)
                or (status == 504 and resp_headers is not None
                    and "x-deadline-expired" in resp_headers))
        for slo in self._class_slos("shed_rate", cls):
            self._counts[slo.name].add(0 if shed else 1,
                                       1 if shed else 0, now)
        if shed:
            return      # intentional backpressure: not an availability
        ok = status < 500 and not truncated
        for slo in self._class_slos("availability", cls):
            self._counts[slo.name].add(1 if ok else 0,
                                       0 if ok else 1, now)
        if not ok or status >= 400:
            return      # failed requests have no latency to judge
        for slo in self._class_slos("latency", cls):
            value = ttft_s if slo.metric == "ttft" else e2e_s
            if value is None:
                continue
            good = value <= slo.threshold_s
            self._counts[slo.name].add(1 if good else 0,
                                       0 if good else 1, now)

    def ingest_engine_loads(self, stats: Dict[str, object],
                            now: Optional[float] = None) -> int:
        """Feed signal SLOs from a scraper snapshot ({url: record with
        ``est_queue_delay_ms`` + ``scraped_at``}). Each (url, scrape)
        sample counts once no matter how often the snapshot is read.
        Returns how many fresh samples were ingested."""
        if not self._signal_slos:
            return 0
        if now is None:
            now = time.time()
        fresh = 0
        for url, rec in stats.items():
            at = getattr(rec, "scraped_at", 0.0)
            if self._last_scrape.get(url) == at:
                continue
            self._last_scrape[url] = at
            fresh += 1
            for slo in self._signal_slos:
                # a record only feeds the signal SLOs whose metric it
                # actually carries: engine /load records have
                # est_queue_delay_ms but no peer_age_s, peer gossip
                # records (shared_state.signal_records) the reverse —
                # defaulting the absent one to 0.0 would pad the other
                # family's volume with vacuous good samples
                raw = getattr(rec, slo.metric, None)
                if raw is None:
                    continue
                value = float(raw)
                good = value <= slo.bound
                self._counts[slo.name].add(1 if good else 0,
                                           0 if good else 1, now)
        for gone in set(self._last_scrape) - set(stats):
            del self._last_scrape[gone]
        return fresh

    # -- evaluation ------------------------------------------------------

    def window_counts(self, slo_name: str, label: str,
                      now: Optional[float] = None) -> Tuple[int, int]:
        if now is None:
            now = time.time()
        return self._counts[slo_name].counts(self.config.window_s(label),
                                             now)

    def burn(self, slo: SLODef, label: str, now: float) -> float:
        good, bad = self.window_counts(slo.name, label, now)
        return burn_rate(good, bad, slo.error_budget)

    def evaluate(self, now: Optional[float] = None,
                 max_age_s: float = 0.0) -> List[str]:
        """Recompute every burn, step every alert; returns the firing
        alert names. ``max_age_s`` serves the cached result when the
        last full evaluation is at least that fresh — the eval task
        already recomputes every interval, so probes/scrapes/pollers
        stacked on top need not each walk every window again."""
        if now is None:
            now = time.time()
        if max_age_s > 0 and now - self._last_eval < max_age_s:
            return self.firing()
        self._last_eval = now
        slos = {s.name: s for s in self.config.slos}
        burns: Dict[str, Dict[str, float]] = {}
        volumes: Dict[str, Dict[str, int]] = {}
        for slo in self.config.slos:
            burns[slo.name] = {}
            volumes[slo.name] = {}
            for label in WINDOWS:
                good, bad = self.window_counts(slo.name, label, now)
                burns[slo.name][label] = burn_rate(good, bad,
                                                   slo.error_budget)
                volumes[slo.name][label] = good + bad
        self.burns = burns
        self.volumes = volumes
        firing = []
        floor = self.config.min_events
        for alert in self.alerts.values():
            r = alert.rule
            slo = slos[r.slo]
            cond = (volumes[r.slo][r.short_window] >= floor
                    and volumes[r.slo][r.long_window] >= floor
                    and burns[r.slo][r.short_window] > r.burn_threshold
                    and burns[r.slo][r.long_window] > r.burn_threshold)
            if alert.evaluate(cond, now) == FIRING:
                firing.append(r.name)
        return firing

    def firing(self) -> List[str]:
        return sorted(name for name, a in self.alerts.items()
                      if a.state == FIRING)

    def fired_totals(self) -> Dict[str, int]:
        return {name: a.fired_total for name, a in self.alerts.items()}

    def snapshot(self, now: Optional[float] = None) -> dict:
        """The GET /alerts payload (evaluates first, so a poll always
        reads current states)."""
        if now is None:
            now = time.time()
        self.evaluate(now)
        slo_rows = []
        for slo in self.config.slos:
            windows = {}
            for label in WINDOWS:
                good, bad = self.window_counts(slo.name, label, now)
                windows[label] = {
                    "good": good, "bad": bad,
                    "burn_rate": round(
                        self.burns[slo.name][label], 4),
                }
            slo_rows.append({**slo.to_json(), "windows": windows})
        return {
            "window_scale": self.config.window_scale,
            "min_events": self.config.min_events,
            "windows_s": {lbl: self.config.window_s(lbl)
                          for lbl in WINDOWS},
            "slos": slo_rows,
            "alerts": [a.to_json() for a in self.alerts.values()],
            "firing": self.firing(),
        }


# ---------------------------------------------------------------- task

class SLOTask:
    """The router's evaluation loop: step alert states and pull fresh
    engine /load samples into the signal SLOs on a short interval
    (asyncio task, the StatLogger ownership idiom)."""

    def __init__(self, engine: SLOEngine,
                 scraper_get: Optional[Callable[[], Dict]] = None,
                 interval_s: float = 1.0,
                 peers_get: Optional[Callable[[], Dict]] = None):
        self.engine = engine
        self.scraper_get = scraper_get
        # peer-router gossip freshness (shared_state.signal_records)
        # rides the same signal path as engine /load samples
        self.peers_get = peers_get
        self.interval_s = interval_s
        self._task = None

    async def start(self) -> None:
        import asyncio
        self._task = asyncio.create_task(self._loop(), name="slo-eval")

    async def close(self) -> None:
        import asyncio
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def healthy(self) -> bool:
        return self._task is not None and not self._task.done()

    async def _loop(self) -> None:
        import asyncio
        while True:
            try:
                self.tick()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("SLO evaluation failed")
            await asyncio.sleep(self.interval_s)

    def tick(self) -> List[str]:
        stats: Dict = {}
        if self.scraper_get is not None:
            stats.update(self.scraper_get())
        if self.peers_get is not None:
            # one merged ingest: the per-(url, scrape) dedup evicts
            # urls absent from the snapshot, so feeding engine and
            # peer records in separate calls would evict each other's
            # dedup stamps every tick
            stats.update(self.peers_get())
        if stats or self.scraper_get is not None \
                or self.peers_get is not None:
            self.engine.ingest_engine_loads(stats)
        return self.engine.evaluate()


# ---------------------------------------------------------------- rules

def compile_prometheus_rules(config: Optional[SLOConfig] = None) -> dict:
    """The cluster-side mirror of the in-process alerts: Prometheus
    alerting rules over the exported ``tpu:slo_burn_rate{slo,window}``
    series. Always compiled at canonical (scale-1) durations — the
    window_scale knob exists for drills, not production rules.
    ``tools/gen_alert_rules.py`` writes this to
    ``observability/alert-rules.yaml``; ``tools/check_alert_rules.py``
    fails CI when the committed file drifts from this compilation."""
    config = config or default_config()
    slos = {s.name: s for s in config.slos}
    floor = config.min_events
    rules = []
    for r in build_alert_rules(SLOConfig(slos=config.slos)):
        slo = slos[r.slo]

        def series(window: str) -> str:
            return (f'max(tpu:slo_burn_rate{{slo="{r.slo}",'
                    f'window="{window}"}})')

        def volume(window: str) -> str:
            return (f'max(tpu:slo_window_events{{slo="{r.slo}",'
                    f'window="{window}"}})')

        # the volume floor mirrors the in-process min_events gate —
        # without it, one bad request against an empty window would
        # page the cluster while the in-process alert stays silent
        rules.append({
            "alert": r.name,
            "expr": (f"{series(r.short_window)} > {r.burn_threshold}\n"
                     f"and\n"
                     f"{series(r.long_window)} > {r.burn_threshold}\n"
                     f"and\n"
                     f"{volume(r.short_window)} >= {floor}\n"
                     f"and\n"
                     f"{volume(r.long_window)} >= {floor}"),
            "for": f"{int(r.for_s)}s",
            "labels": {"severity": r.severity, "slo": r.slo},
            "annotations": {
                "summary": (f"{r.slo} burning error budget at >"
                            f"{r.burn_threshold}x over {r.short_window} "
                            f"and {r.long_window}"),
                "description": slo.description or slo.name,
                "runbook": r.runbook(),
            },
        })
    # static (non-burn-rate) rules ride in their own group: symptoms
    # with a dedicated control loop rather than an error budget
    kvplane_rules = [{
        # fragmentation, not exhaustion: admissions failing while the
        # pool still holds free blocks. With the kvplane planner
        # deployed this should self-heal within a poll interval — a
        # firing alert means the planner is down, cooldown-pinned, or
        # the fleet has no destination with headroom.
        "alert": "KVPoolFragmented",
        "expr": ('sum by (model_name) (rate(\n'
                 '  tpu:kvpool_alloc_failures_total{reason="fragmented"}'
                 '[5m]\n)) > 0\n'
                 'and\n'
                 'sum by (model_name) '
                 '(tpu:kvpool_blocks{state="free"}) > 0'),
        "for": "120s",
        "labels": {"severity": "ticket", "component": "kvplane"},
        "annotations": {
            "summary": ("KV pool refusing admissions while free "
                        "blocks exist — fragmented, not exhausted"),
            "description": ("alloc failures with reason=fragmented "
                            "rising while the pool reports free "
                            "capacity; live migration / defrag is "
                            "not reclaiming it"),
            "runbook": "docs/runbooks.md#kv-fragmentation",
        },
    }]
    autoscaler_rules = [{
        # the remediation loop's own failure is an alert, not a log
        # line: an executed runbook that did not resolve its alert
        # (or failed mid-way) means the pilot is actuating on the
        # fleet without fixing it — a human must take the incident
        # over before the rate limit resets and it tries again
        "alert": "RemediationFailing",
        "expr": ('sum by (action) (increase(\n'
                 '  tpu:autoscaler_remediations_total'
                 '{outcome=~"failed|unresolved"}[30m]\n)) > 0'),
        "for": "60s",
        "labels": {"severity": "ticket", "component": "autoscaler"},
        "annotations": {
            "summary": ("auto-remediation executed but did not "
                        "resolve its alert (or failed mid-runbook)"),
            "description": ("remediations with outcome failed/"
                            "unresolved in the last 30m; the bounded "
                            "policy rate-limits retries, so the "
                            "incident is now a human's"),
            "runbook": "docs/runbooks.md#auto-remediation",
        },
    }]
    tenancy_rules = [{
        # tenant-bucket sheds are the containment WORKING, not failing
        # — the router refuses one tenant's overflow so its tier peers
        # keep their goodput (router/qos.py). The alert exists because
        # a tenant shedding for this long has outgrown its flat
        # --qos-tenant-rate (or is misbehaving), and either way the
        # conversation is with an account, not a pager storm: ticket.
        "alert": "NoisyTenantShedding",
        "expr": ('sum by (tenant, tier) (rate(\n'
                 '  tpu:router_tenant_sheds_total[10m]\n)) > 1'),
        "for": "600s",
        "labels": {"severity": "ticket", "component": "router"},
        "annotations": {
            "summary": ("tenant {{ $labels.tenant }} shedding on its "
                        "per-tenant budget in tier {{ $labels.tier }} "
                        "for 10m+"),
            "description": ("sustained tenant-bucket sheds: the noisy-"
                            "neighbor containment is holding (peers "
                            "are protected) but this tenant's traffic "
                            "has outgrown its rate"),
            "runbook": "docs/runbooks.md#noisy-neighbor",
        },
    }]
    return {"groups": [{"name": "tpu-stack-slo-burn", "rules": rules},
                       {"name": "tpu-stack-kvplane",
                        "rules": kvplane_rules},
                       {"name": "tpu-stack-autoscaler",
                        "rules": autoscaler_rules},
                       {"name": "tpu-stack-tenancy",
                        "rules": tenancy_rules}]}
