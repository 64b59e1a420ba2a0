"""Multi-router shared state: peer gossip, convergence, cap splitting.

One router process binds at ~1,650 req/s (BASELINE.md Round 7); a
fleet serving millions of users runs N of them behind a dumb L4
split. Everything the data plane learned used to be process-local —
session/prefix rings, breaker state, drain flags, in-flight caps — so
N routers would disagree about affinity and health. This module is
the control plane that makes N routers behave like one:

- **Deterministic affinity without synchronized rings.** The
  session/prefix policies already route by consistent hashing over
  the endpoint set (routing.HashRing): two routers with the SAME
  healthy-endpoint view map the same key to the same engine without
  exchanging a byte of ring state. What actually diverges is the
  *view* — a breaker tripped on one replica, a drain issued through
  one replica's /admin/drain. So the gossip exchanges exactly those
  facts and nothing else.
- **Breaker/drain convergence.** Each router serves its shareable
  health facts on ``GET /peers`` (``HealthTracker.peer_view()``:
  per-endpoint breaker state + drain flag, stamped with transition
  *ages* — no shared clock needed). ``RouterPeers`` polls every peer
  on a short interval and merges by last-writer-wins on age
  (``HealthTracker.adopt_peer_view``), so an engine death observed by
  one router opens everyone's breaker within a gossip interval, and
  the probe-driven close propagates the same way.
- **Apportioned in-flight caps.** The per-endpoint concurrency cap
  (engine-advertised capacity or ``--endpoint-inflight-cap``) is a
  FLEET-wide bound; each router enforces ``cap × cap_share()`` where
  the share is 1/(live routers), so N routers together still respect
  the engine's advertised capacity instead of N-times it.
- **Peer liveness.** Peers answer → ``live``; stop answering →
  ``stale`` after ``stale_after_s`` then counted dead. Surfaced on
  ``/health``, ``tpu:router_peers{state}``, and as a signal SLO
  (``router_peer_lost`` — docs/runbooks.md#router_peer_lost_page).

The closed loop is ``python -m production_stack_tpu_torch.loadgen
multirouter`` (docs/benchmarks.md "Multi-router"): ≥2 real router
processes behind an L4 splitter must match a single-router control's
affinity hit rate, converge breaker state across replicas, survive a
router SIGKILL with only the in-flight blip, and degrade by QoS tier
(router/qos.py) rather than uniformly — committed as
``MULTIROUTER_r16.json``.
"""

import asyncio
import time
from typing import Callable, Dict, List, Optional

import aiohttp

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

PEERS_PATH = "/peers"

LIVE, STALE, UNREACHABLE = "live", "stale", "unreachable"


class _Peer:
    __slots__ = ("url", "router_id", "last_seen", "last_attempt",
                 "failures", "ever_seen")

    def __init__(self, url: str):
        self.url = url
        self.router_id: Optional[str] = None
        self.last_seen: Optional[float] = None
        self.last_attempt: Optional[float] = None
        self.failures = 0
        self.ever_seen = False


class _PeerSignal:
    """One peer's freshness sample for the SLO engine's signal path
    (``SLOEngine.ingest_engine_loads`` reads ``peer_age_s`` by
    attribute name and dedups on ``scraped_at``)."""

    __slots__ = ("peer_age_s", "scraped_at")

    def __init__(self, peer_age_s: float, scraped_at: float):
        self.peer_age_s = peer_age_s
        self.scraped_at = scraped_at


def derive_router_id(host: str, port: int) -> str:
    """Default ``--router-id``: host:port the process listens on —
    stable across restarts of the same replica, unique across a
    fleet launched by the orchestrator (distinct ports/hosts)."""
    import socket
    h = host
    if h in ("0.0.0.0", "::", ""):
        h = socket.gethostname()
    return f"{h}:{port}"


class RouterPeers:
    """Gossip client + merge loop for one router process.

    ``health`` is the process's HealthTracker (merge target);
    ``known_urls`` returns the configured engine fleet so a peer with
    a stale config cannot plant state for endpoints we dropped.
    """

    def __init__(self, router_id: str,
                 peer_urls: List[str],
                 health,
                 known_urls: Callable[[], List[str]],
                 interval_s: float = 1.0,
                 stale_after_s: Optional[float] = None,
                 timeout_s: float = 2.0,
                 now_fn: Callable[[], float] = time.monotonic):
        self.router_id = router_id
        self.interval_s = interval_s
        # a peer is stale once it has missed ~3 gossip rounds
        self.stale_after_s = stale_after_s if stale_after_s is not None \
            else max(3.0 * interval_s, 2.0)
        self.health = health
        self.known_urls = known_urls
        self._now = now_fn
        self._timeout = aiohttp.ClientTimeout(total=timeout_s)
        self._peers: Dict[str, _Peer] = {
            u.rstrip("/"): _Peer(u.rstrip("/")) for u in peer_urls
            if u.strip()}
        self._task: Optional[asyncio.Task] = None
        self._session: Optional[aiohttp.ClientSession] = None
        # telemetry
        self.gossip_rounds = 0
        self.merge_errors = 0

    # -- lifecycle ------------------------------------------------------

    async def start(self, session: aiohttp.ClientSession) -> None:
        self._session = session
        self._task = asyncio.create_task(self._loop(), name="peer-gossip")

    async def close(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    def healthy(self) -> bool:
        return self._task is None or not self._task.done()

    async def _loop(self) -> None:
        while True:
            try:
                await self.gossip_now()
            except asyncio.CancelledError:
                raise
            except Exception:
                self.merge_errors += 1
                logger.exception("peer gossip round failed")
            await asyncio.sleep(self.interval_s)

    # -- gossip ---------------------------------------------------------

    async def gossip_now(self) -> None:
        """One concurrent poll-and-merge pass over every peer."""
        if not self._peers:
            return
        await asyncio.gather(*(self._poll_one(p)
                               for p in self._peers.values()))
        self.gossip_rounds += 1

    async def _poll_one(self, peer: _Peer) -> None:
        peer.last_attempt = self._now()
        try:
            async with self._session.get(f"{peer.url}{PEERS_PATH}",
                                         timeout=self._timeout) as r:
                if r.status != 200:
                    peer.failures += 1
                    return
                body = await r.json()
        except (aiohttp.ClientError, ConnectionError, OSError,
                asyncio.TimeoutError, ValueError):
            peer.failures += 1
            return
        rid = body.get("router_id")
        if rid == self.router_id:
            # an L4 splitter (or a copy-pasted config) pointed us at
            # ourselves; merging our own echo is harmless but the
            # liveness count would read one router as two
            logger.warning("peer %s answers with our own router_id %s; "
                           "ignoring it", peer.url, rid)
            peer.failures += 1
            return
        peer.router_id = rid
        peer.last_seen = self._now()
        peer.failures = 0
        peer.ever_seen = True
        view = body.get("breakers") or {}
        if isinstance(view, dict):
            self.health.adopt_peer_view(view, self.known_urls())

    # -- reads ----------------------------------------------------------

    def _state(self, peer: _Peer) -> str:
        if peer.last_seen is None:
            return UNREACHABLE
        if self._now() - peer.last_seen > self.stale_after_s:
            return STALE
        return LIVE

    def peers(self) -> Dict[str, Dict]:
        """Per-peer liveness for /health and the stat log."""
        out = {}
        for url, p in self._peers.items():
            age = None if p.last_seen is None \
                else round(self._now() - p.last_seen, 3)
            out[url] = {"router_id": p.router_id,
                        "state": self._state(p),
                        "last_seen_age_s": age,
                        "failures": p.failures}
        return out

    def state_counts(self) -> Dict[str, int]:
        counts = {LIVE: 0, STALE: 0, UNREACHABLE: 0}
        for p in self._peers.values():
            counts[self._state(p)] += 1
        return counts

    def live_router_count(self) -> int:
        """Routers currently sharing the fleet's caps: self + live
        peers. A peer that stopped answering stops counting — its
        share of every endpoint cap flows back to the survivors
        within ``stale_after_s`` (exactly what a router SIGKILL under
        load needs)."""
        return 1 + sum(1 for p in self._peers.values()
                       if self._state(p) == LIVE)

    def cap_share(self) -> float:
        """Fraction of each fleet-wide per-endpoint cap THIS router
        may use."""
        return 1.0 / max(1, self.live_router_count())

    def signal_records(self) -> Dict[str, _PeerSignal]:
        """Peer freshness as SLO signal samples (``router_peer_lost``).

        A peer we have EVER seen answers with its silence: its age
        grows past the SLO bound and burns. A peer we have never
        reached is indistinguishable from a replica that hasn't
        started yet — startup must not page — so it contributes no
        sample until first contact.
        """
        now = self._now()
        out = {}
        for url, p in self._peers.items():
            if not p.ever_seen:
                continue
            # `is None` checks throughout: 0.0 is a timestamp (the
            # stats-plane convention), not "never"
            age = max(0.0, now - p.last_seen) \
                if p.last_seen is not None else 0.0
            # scraped_at moves every attempt so the engine's per-
            # (url, scrape) dedup admits one sample per gossip round
            # even while the peer is dark
            out[url] = _PeerSignal(
                peer_age_s=age,
                scraped_at=p.last_attempt
                if p.last_attempt is not None else now)
        return out

    def snapshot(self) -> Dict:
        return {
            "router_id": self.router_id,
            "interval_s": self.interval_s,
            "gossip_rounds": self.gossip_rounds,
            "live_routers": self.live_router_count(),
            "cap_share": round(self.cap_share(), 4),
            "peers": self.peers(),
            "adopted_opens": self.health.peer_adopted_opens,
            "adopted_closes": self.health.peer_adopted_closes,
        }


def peers_payload(router_id: str, health) -> Dict:
    """The ``GET /peers`` body this router serves to its peers."""
    return {"router_id": router_id,
            "breakers": health.peer_view()}
