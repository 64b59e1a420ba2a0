"""Router resilience layer: per-endpoint health, failover policy, drain.

The router hides a fleet of mortal engine replicas behind one stable
endpoint; this module is where "mortal" is handled. Three pieces, all
consumed by proxy.py / routing-adjacent code through ``app['state']``:

- ``HealthTracker`` — per-endpoint circuit breaker fed by *passive*
  signals from the data plane (connect errors, timeouts, backend 5xx,
  mid-stream deaths, probe failures). closed → open on K consecutive
  failures or a windowed failure rate; open → half_open after a
  cooldown; half_open → closed only after an *active* ``/v1/models``
  re-probe succeeds (a dead pod must prove it is back before sessions
  return to it). Also owns graceful per-endpoint drain state: a
  draining endpoint takes no new admissions while its in-flight
  requests finish on the proxy's existing connections.
- ``RetryBudget`` — a global token bucket bounding failover retries to
  a fraction of live traffic, so a fleet-wide outage degrades to
  fast-failing requests instead of a router-amplified retry storm.
- ``backoff_s`` / ``wait_for_drain`` — jittered-backoff and
  listener-drain helpers for the proxy's failover loop and the app's
  SIGTERM path.

Everything here is event-loop-single-threaded (like the rest of the
router): no locks, mutations happen on the loop. The only network I/O
is the active re-probe task started by ``start()``.
"""

import asyncio
import collections
import random
import time
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from production_stack_tpu_torch.router.service_discovery import (EndpointInfo,
                                                           probe_model_name)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"

# passive failure kinds the data plane reports (metrics label values).
# The first five feed the breaker; the INFORMATIONAL kinds are counted
# in vllm:upstream_failures_total but NEVER enter breaker math —
# "shed" (429/503 + Retry-After: the engine is healthy but full; see
# record_shed) and "deadline" (engine 504 + x-deadline-expired: the
# CLIENT's budget elapsed, nothing is wrong with the engine).
FAILURE_KINDS = ("connect", "timeout", "http_5xx", "mid_stream", "probe")
INFORMATIONAL_KINDS = ("shed", "deadline")

# "no transition ever" sentinel age for the peer-gossip payloads
# (float('inf') is not valid JSON)
NEVER_AGE = 1e9


class _EndpointHealth:
    __slots__ = ("state", "consecutive", "outcomes", "open_until",
                 "opened_at", "probing", "opens", "transition_at")

    def __init__(self):
        self.state = CLOSED
        self.consecutive = 0
        # (timestamp, ok) ring for the windowed failure-rate trip
        self.outcomes: Deque[Tuple[float, bool]] = collections.deque()
        self.open_until = 0.0
        self.opened_at = 0.0
        self.probing = False
        self.opens = 0
        # when this endpoint last crossed open<->closed — the peer
        # gossip layer (shared_state.py) compares transition AGES so
        # two routers agree on which of them saw the newer event
        # without sharing a clock
        self.transition_at: Optional[float] = None


class HealthTracker:
    """Per-endpoint breaker + drain state + resilience counters.

    ``is_routable`` is the single question routing asks; ``record_*``
    are the passive signals the proxy feeds; ``start()`` owns the
    active half-open re-probe loop.
    """

    def __init__(self, failure_threshold: int = 3,
                 cooldown_s: float = 5.0,
                 window_s: float = 30.0,
                 failure_rate: float = 0.5,
                 min_samples: int = 20,
                 probe_interval_s: float = 1.0,
                 now_fn: Callable[[], float] = time.monotonic):
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.window_s = window_s
        self.failure_rate = failure_rate
        self.min_samples = min_samples
        self.probe_interval_s = probe_interval_s
        self._now = now_fn
        self._eps: Dict[str, _EndpointHealth] = {}
        self._draining: set = set()
        # url -> (draining bool, stamped at): drain TRANSITIONS carry
        # ages through peer gossip the same way breaker transitions do
        # (an /admin/drain lands on ONE router; its peers must learn)
        self._drain_events: Dict[str, Tuple[bool, float]] = {}
        # peer-adoption telemetry (shared_state.py feeds these)
        self.peer_adopted_opens = 0
        self.peer_adopted_closes = 0
        # counters exported by RouterMetrics.refresh_resilience
        self.failures: Dict[Tuple[str, str], int] = \
            collections.defaultdict(int)
        self.retries: Dict[str, int] = collections.defaultdict(int)
        self.relayed_5xx: Dict[str, int] = collections.defaultdict(int)
        self.breaker_opens = 0
        self.recoveries = 0
        self._probe_task: Optional[asyncio.Task] = None

    # -- breaker state machine ------------------------------------------

    def _h(self, url: str) -> _EndpointHealth:
        h = self._eps.get(url)
        if h is None:
            h = self._eps[url] = _EndpointHealth()
        return h

    def _note(self, h: _EndpointHealth, ok: bool, now: float) -> None:
        h.outcomes.append((now, ok))
        cutoff = now - self.window_s
        while h.outcomes and h.outcomes[0][0] < cutoff:
            h.outcomes.popleft()

    def _rate_tripped(self, h: _EndpointHealth) -> bool:
        n = len(h.outcomes)
        if n < self.min_samples:
            return False
        fails = sum(1 for _, ok in h.outcomes if not ok)
        return fails / n >= self.failure_rate

    def _open(self, url: str, h: _EndpointHealth, why: str) -> None:
        now = self._now()
        h.state = OPEN
        h.opened_at = now
        h.open_until = now + self.cooldown_s
        h.opens += 1
        h.probing = False
        h.transition_at = now
        self.breaker_opens += 1
        logger.warning("breaker OPEN for %s (%s; cooldown %.1fs)",
                       url, why, self.cooldown_s)

    def _close(self, url: str, h: _EndpointHealth, why: str) -> None:
        if h.state != CLOSED:
            self.recoveries += 1
            h.transition_at = self._now()
            logger.info("breaker CLOSED for %s (%s)", url, why)
        h.state = CLOSED
        h.consecutive = 0
        h.probing = False
        h.outcomes.clear()

    def record_success(self, url: str) -> None:
        h = self._eps.get(url)
        if h is None:
            return          # endpoints start healthy; nothing to track
        h.consecutive = 0
        self._note(h, True, self._now())
        if h.state != CLOSED:
            # a real request succeeded while the breaker was open (the
            # all-unroutable fallback sent it): as good as a probe
            self._close(url, h, "request succeeded")

    def record_failure(self, url: str, kind: str) -> None:
        self.failures[(url, kind)] += 1
        h = self._h(url)
        h.consecutive += 1
        now = self._now()
        self._note(h, False, now)
        if h.state == HALF_OPEN:
            self._open(url, h, f"{kind} while half-open")
        elif h.state == CLOSED:
            if h.consecutive >= self.failure_threshold:
                self._open(url, h,
                           f"{h.consecutive} consecutive failures, "
                           f"last: {kind}")
            elif self._rate_tripped(h):
                self._open(url, h,
                           f"failure rate >= {self.failure_rate:.0%} "
                           f"over {len(h.outcomes)} samples")

    def record_probe_result(self, url: str, ok: bool) -> None:
        """Outcome of an active /v1/models probe (the tracker's own
        half-open re-probe, or service discovery's liveness probe)."""
        if ok:
            h = self._eps.get(url)
            if h is not None and h.state != CLOSED:
                self._close(url, h, "probe succeeded")
            elif h is not None:
                h.consecutive = 0
                self._note(h, True, self._now())
        else:
            self.record_failure(url, "probe")

    def reset(self, url: str) -> None:
        """Administrative breaker reset (``POST /admin/breaker``): the
        remediation loop restarts a sick engine and must not wait out
        the open-state cooldown before routing resumes — the operator
        (human or remediator) is asserting the endpoint is healthy
        again, and the next real failure will re-open it normally."""
        h = self._eps.get(url)
        if h is None:
            return          # never tracked -> already CLOSED
        self._close(url, h, "admin reset")

    def record_shed(self, url: str) -> None:
        """An upstream 429/503-with-Retry-After: the engine shed the
        request under overload protection. Shed ≠ sick — counted (for
        vllm:upstream_failures_total{kind="shed"}) but deliberately
        excluded from consecutive-failure and windowed-rate breaker
        math: a full-but-healthy engine must never trip its breaker
        open (that would dogpile its load onto the remaining fleet and
        cascade the overload)."""
        self.failures[(url, "shed")] += 1

    def record_deadline_relay(self, url: str) -> None:
        """An upstream 504 marked x-deadline-expired: the client's own
        deadline elapsed while queued. Counter-only, same rationale."""
        self.failures[(url, "deadline")] += 1

    def note_retry(self, url: str) -> None:
        self.retries[url] += 1

    def note_relayed_5xx(self, url: str) -> None:
        self.relayed_5xx[url] += 1

    # -- routing reads --------------------------------------------------

    def state_of(self, url: str) -> str:
        h = self._eps.get(url)
        return h.state if h is not None else CLOSED

    def is_routable(self, url: str) -> bool:
        if url in self._draining:
            return False
        h = self._eps.get(url)
        if h is None or h.state == CLOSED:
            return True
        # OPEN and HALF_OPEN are both unroutable: closing requires the
        # active re-probe (or a stray success) first
        return False

    def healthy_endpoints(self, endpoints: Sequence[EndpointInfo]
                          ) -> List[EndpointInfo]:
        """Filter to breaker-closed, non-draining endpoints.

        Fail-open: if EVERY candidate is unroutable, return the
        non-draining ones (and, as the last resort, all of them) — a
        fleet-wide false-open must degrade to trying, not to a
        guaranteed 502 with zero attempts.
        """
        healthy = [ep for ep in endpoints if self.is_routable(ep.url)]
        if healthy:
            return healthy
        not_draining = [ep for ep in endpoints
                        if ep.url not in self._draining]
        return not_draining or list(endpoints)

    def evict_except(self, live_urls) -> None:
        """Forget endpoints that left the configured fleet, counters
        included (RouterMetrics.refresh_resilience drops their label
        series on the next scrape). Drain flags are deliberately NOT
        evicted: a drain is operator intent, and an endpoint bouncing
        out of discovery mid-drain must come back still draining —
        only end_drain clears it."""
        live = set(live_urls)
        for url in [u for u in self._eps if u not in live]:
            del self._eps[url]
        for store in (self.retries, self.relayed_5xx):
            for url in [u for u in store if u not in live]:
                del store[url]
        for key in [k for k in self.failures if k[0] not in live]:
            del self.failures[key]

    # -- peer gossip (shared_state.py) -----------------------------------

    def peer_view(self) -> Dict[str, Dict]:
        """This router's shareable health facts, ages instead of
        timestamps (two processes share no clock; an age survives the
        hop with only gossip-interval skew). Endpoints with no
        transition yet are omitted — there is nothing to converge on."""
        now = self._now()
        out: Dict[str, Dict] = {}
        for url, h in self._eps.items():
            if h.transition_at is None:
                continue
            entry = {"state": h.state,
                     "age_s": max(0.0, now - h.transition_at)}
            if h.state != CLOSED:
                entry["cooldown_remaining_s"] = max(
                    0.0, h.open_until - now)
            out[url] = entry
        for url, (draining, at) in self._drain_events.items():
            # NEVER_AGE keeps the payload JSON-clean (inf is not JSON)
            entry = out.setdefault(url, {"state": self.state_of(url),
                                         "age_s": NEVER_AGE})
            entry["draining"] = draining
            entry["drain_age_s"] = max(0.0, now - at)
        return out

    def _transition_age(self, h: Optional[_EndpointHealth]) -> float:
        if h is None or h.transition_at is None:
            return float("inf")
        return max(0.0, self._now() - h.transition_at)

    def adopt_peer_view(self, view: Dict[str, Dict],
                        known_urls=None) -> None:
        """Merge one peer's ``peer_view()``: last-writer-wins by
        transition age. A peer that observed a NEWER open/close than we
        did wins — its age is smaller than ours — so when an engine
        dies under traffic only one router carries, every replica
        converges on OPEN within a gossip interval instead of a full
        organic trip; when the probe closes it, the close propagates
        the same way. ``known_urls`` (the configured fleet) bounds what
        a peer can make us track — a peer with a stale config must not
        plant state for endpoints we no longer serve."""
        known = set(known_urls) if known_urls is not None else None
        for url, entry in view.items():
            if known is not None and url not in known:
                continue
            self._adopt_breaker(url, entry)
            self._adopt_drain(url, entry)

    def _adopt_breaker(self, url: str, entry: Dict) -> None:
        peer_state = entry.get("state")
        peer_age = float(entry.get("age_s", NEVER_AGE))
        if peer_state not in (OPEN, HALF_OPEN, CLOSED) or \
                peer_age >= NEVER_AGE:
            return
        h = self._eps.get(url)
        if self._transition_age(h) <= peer_age:
            return            # our own observation is at least as new
        now = self._now()
        if peer_state in (OPEN, HALF_OPEN):
            if self.state_of(url) == CLOSED:
                h = self._h(url)
                h.state = OPEN
                h.opened_at = now - peer_age
                # inherit the peer's remaining cooldown so our OWN
                # re-probe takes over roughly when theirs would —
                # adopted opens still close only through a probe
                h.open_until = now + max(
                    0.0, float(entry.get("cooldown_remaining_s",
                                         self.cooldown_s)))
                h.opens += 1
                h.probing = False
                h.transition_at = now - peer_age
                self.breaker_opens += 1
                self.peer_adopted_opens += 1
                logger.warning("breaker OPEN for %s (adopted from peer, "
                               "%.1fs old)", url, peer_age)
        else:
            if h is not None and h.state != CLOSED:
                self._close(url, h, "peer observed recovery")
                h.transition_at = now - peer_age
                self.peer_adopted_closes += 1

    def _adopt_drain(self, url: str, entry: Dict) -> None:
        if "draining" not in entry:
            return
        peer_draining = bool(entry["draining"])
        peer_age = float(entry.get("drain_age_s", float("inf")))
        ours = self._drain_events.get(url)
        our_age = float("inf") if ours is None \
            else max(0.0, self._now() - ours[1])
        if our_age <= peer_age:
            return
        if peer_draining == (url in self._draining):
            # already agree; just remember the (older) stamp so a
            # third router's even-staler contradiction cannot win later
            self._drain_events[url] = (peer_draining,
                                       self._now() - peer_age)
            return
        if peer_draining:
            self.start_drain(url)
        else:
            self.end_drain(url)
        self._drain_events[url] = (peer_draining, self._now() - peer_age)

    # -- drain ----------------------------------------------------------

    def start_drain(self, url: str) -> None:
        if url not in self._draining:
            logger.info("draining %s: no new admissions; in-flight "
                        "requests continue", url)
            self._drain_events[url] = (True, self._now())
        self._draining.add(url)

    def end_drain(self, url: str) -> None:
        if url in self._draining:
            logger.info("drain ended for %s: routable again", url)
            self._drain_events[url] = (False, self._now())
        self._draining.discard(url)

    def draining(self) -> List[str]:
        return sorted(self._draining)

    # -- introspection ---------------------------------------------------

    def snapshot(self) -> Dict[str, Dict]:
        out = {}
        for url, h in self._eps.items():
            out[url] = {"state": h.state,
                        "consecutive_failures": h.consecutive,
                        "opens": h.opens,
                        "draining": url in self._draining}
        for url in self._draining - set(self._eps):
            out[url] = {"state": CLOSED, "consecutive_failures": 0,
                        "opens": 0, "draining": True}
        return out

    # -- active re-probe -------------------------------------------------

    async def start(self, session) -> None:
        self._probe_task = asyncio.create_task(self._probe_loop(session),
                                               name="health-probe")

    async def close(self) -> None:
        if self._probe_task:
            self._probe_task.cancel()
            try:
                await self._probe_task
            except asyncio.CancelledError:
                pass
            self._probe_task = None

    def healthy(self) -> bool:
        return self._probe_task is None or not self._probe_task.done()

    async def _probe_loop(self, session) -> None:
        while True:
            await asyncio.sleep(self.probe_interval_s)
            try:
                await self.probe_open_endpoints(session)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("health re-probe pass failed")

    async def probe_open_endpoints(self, session) -> None:
        """One re-probe pass: every OPEN endpoint whose cooldown has
        elapsed moves to HALF_OPEN and gets an active /v1/models probe;
        success closes the breaker, failure re-opens it for another
        cooldown."""
        now = self._now()
        due = [url for url, h in self._eps.items()
               if h.state == OPEN and now >= h.open_until and not h.probing]
        for url in due:
            h = self._eps.get(url)
            if h is None:
                continue
            h.state = HALF_OPEN
            h.probing = True
            try:
                models = await probe_model_name(session, url)
            finally:
                if url in self._eps:
                    self._eps[url].probing = False
            self.record_probe_result(url, bool(models))


class RetryBudget:
    """Token bucket bounding failover retries to a fraction of traffic.

    Each incoming request deposits ``ratio`` tokens (capped); each
    retry withdraws one. Sustained retry volume is therefore at most
    ``ratio`` × request volume, while the ``cap``-sized burst allowance
    lets a quiet router still fail over its first few requests
    instantly after an engine dies.
    """

    def __init__(self, ratio: float = 0.2, cap: float = 50.0):
        self.ratio = ratio
        self.cap = cap
        self.tokens = cap
        self.spent = 0          # granted retries (telemetry)
        self.rejected = 0       # retries denied by an empty bucket

    def on_request(self) -> None:
        self.tokens = min(self.cap, self.tokens + self.ratio)

    def try_spend(self) -> bool:
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            self.spent += 1
            return True
        self.rejected += 1
        return False


def backoff_s(attempt: int, base_s: float = 0.05, cap_s: float = 1.0,
              rng: Optional[random.Random] = None) -> float:
    """Full-jitter exponential backoff for failover attempt N (1-based):
    uniform in [0, min(cap, base * 2^(N-1))] — retries from many
    concurrent requests against a dying endpoint de-synchronize instead
    of thundering onto the next candidate together."""
    ceiling = min(cap_s, base_s * (2 ** max(0, attempt - 1)))
    r = rng.random() if rng is not None else random.random()
    return r * ceiling


async def wait_for_drain(get_inflight: Callable[[], int],
                         timeout_s: float,
                         poll_s: float = 0.1) -> bool:
    """Wait until the router has zero in-flight requests (or the bound
    expires). Returns True when fully drained."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if get_inflight() <= 0:
            return True
        await asyncio.sleep(poll_s)
    return get_inflight() <= 0
