"""Routing policies: pick a backend for each request.

Capability parity with reference src/vllm_router/routers/routing_logic.py
(round-robin :45-76; session consistent-hash with lowest-QPS fallback
:79-172), re-designed:

- The consistent-hash ring is implemented here directly (md5 points,
  vnode replicas, bisect lookup) instead of depending on uhashring;
  same invariants: stable mapping, minimal remapping on join/leave.
- An extra ``prefix`` policy routes by a hash of the request's prompt
  prefix — KV-cache-affinity routing so multi-round conversations with
  shared history land where their KV blocks live (the TPU stack's
  answer to LMCache-aware routing).

Health awareness: the proxy filters the endpoint list through
``resilience.HealthTracker.healthy_endpoints`` before calling ANY
policy, so breaker-open / draining endpoints are invisible here. The
session/prefix rings rebuild from whatever list arrives — consistent
hashing means a health transition remaps only the failed endpoint's
keys (to deterministic successors) and returns them when it recovers;
everyone else's mapping is untouched (pinned by
tests/test_router_resilience.py).
"""

import bisect
import hashlib
import json
import time
from abc import ABC, abstractmethod
from typing import Dict, List, Optional, Sequence

from production_stack_tpu_torch.router.service_discovery import EndpointInfo
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


def prompt_text(body: dict) -> str:
    """Canonical prompt rendering for chunk hashing — shared by the
    prefix ring and the disagg DecodeSelector. Both rings must chunk
    the SAME text or affinity and transfer-cost scoring silently
    diverge on identical requests."""
    if "messages" in body:
        try:
            return json.dumps(body["messages"])
        except (TypeError, ValueError):
            return ""
    prompt = body.get("prompt", "")
    return prompt if isinstance(prompt, str) else json.dumps(prompt)


def prompt_chunk_digests(text: str, chunk_chars: int,
                         max_track_chars: int) -> List[bytes]:
    """Chained digests of the prompt's full chunk_chars chunks
    (bounded by max_track_chars; a partial tail chunk is skipped,
    mirroring chunk-granular tier storage)."""
    from production_stack_tpu_torch.kvcache.chunks import chain_digest_bytes
    data = text[:max_track_chars].encode("utf-8", "ignore")
    return chain_digest_bytes(data, chunk_chars)


def record_chunk_holders(ring, digests, url: str, *,
                         urls_per_chunk: int, max_entries: int) -> None:
    """Record ``url`` as a recent holder of each digest in an
    OrderedDict ring (most recent last, LRU over digests, at most
    ``urls_per_chunk`` holders per digest)."""
    for d in digests:
        urls = ring.get(d)
        if urls is None:
            ring[d] = [url]
        else:
            if url in urls:
                urls.remove(url)
            urls.append(url)
            del urls[:-urls_per_chunk]
            ring.move_to_end(d)
    while len(ring) > max_entries:
        ring.popitem(last=False)


class AffinityTracker:
    """Counts affinity *moves*: routing decisions where a key
    (session id / prompt prefix) lands on a different endpoint than
    its previous home. Reasons:

    - ``endpoint_lost`` — the previous home is absent from this
      decision's candidate set (breaker open, draining, removed):
      the expected, bounded churn consistent hashing promises.
    - ``endpoint_recovered`` — the key moved BACK to the home it held
      before its last ``endpoint_lost`` displacement: the second half
      of the same expected churn (breaker closed / drain ended), not
      drift — counting it as rebalance would spike the split-brain
      signal after every ordinary recovery.
    - ``rebalance`` — the previous home was still a candidate but
      the policy picked elsewhere: in a single router this is warm-
      scoring drift; across N routers it is the split-brain signal
      the multi-router control plane exists to keep near zero
      (``tpu:router_affinity_moves_total{reason}``).

    Bounded LRU over keys; one dict get + set per routing decision.
    """

    __slots__ = ("_homes", "max_entries", "moves")

    def __init__(self, max_entries: int = 4096):
        import collections
        # key -> [current_home, displaced_home-or-None]
        self._homes: "collections.OrderedDict[str, List[Optional[str]]]" \
            = collections.OrderedDict()
        self.max_entries = max_entries
        self.moves = {"endpoint_lost": 0, "endpoint_recovered": 0,
                      "rebalance": 0}

    def note(self, key: str, url: str, candidate_urls) -> None:
        entry = self._homes.get(key)
        if entry is None:
            entry = self._homes[key] = [url, None]
        else:
            prev, displaced = entry
            if prev != url:
                if prev not in candidate_urls:
                    self.moves["endpoint_lost"] += 1
                    entry[1] = prev       # remember the real home
                elif url == displaced:
                    self.moves["endpoint_recovered"] += 1
                    entry[1] = None
                else:
                    self.moves["rebalance"] += 1
                    entry[1] = None
                entry[0] = url
        self._homes.move_to_end(key)
        while len(self._homes) > self.max_entries:
            self._homes.popitem(last=False)


class Router(ABC):
    name = "abstract"

    @abstractmethod
    def route(self, endpoints: Sequence[EndpointInfo], request_stats: Dict,
              headers: Dict[str, str], body: dict) -> str:
        """Return the chosen backend URL. endpoints is non-empty."""


class RoundRobinRouter(Router):
    name = "roundrobin"

    def __init__(self):
        self._counter = 0

    def route(self, endpoints, request_stats, headers, body) -> str:
        ordered = sorted(endpoints, key=lambda e: e.url)
        choice = ordered[self._counter % len(ordered)]
        self._counter += 1
        return choice.url


class LeastLoadedRouter(Router):
    """Lowest observed in-flight requests (falls back to QPS, then RR).

    Slow start: an endpoint this router has never routed to (freshly
    added to the fleet) or one returning after an absence (filtered
    out while its breaker was open / probe-marked unroutable) used to
    score as idle and absorb the entire arrival burst at once. Such
    endpoints instead carry a virtual load — just above the busiest
    known endpoint's in-flight count, decaying linearly to zero over
    ``slow_start_s`` — so traffic ramps onto them. A cold start (the
    router's very first call, when everything is equally new) ramps
    nothing. Absence is detected against routing activity: an
    endpoint missing from ``absent_reset_s`` worth of *calls* restarts
    its ramp; an idle router restarts nobody's.
    """

    name = "least_loaded"

    def __init__(self, slow_start_s: float = 10.0,
                 absent_reset_s: float = 2.0,
                 now_fn=time.monotonic):
        self._rr = RoundRobinRouter()
        self.slow_start_s = slow_start_s
        self.absent_reset_s = absent_reset_s
        self._now = now_fn
        self._last_seen: Dict[str, float] = {}   # url -> last call with it
        self._ramp_from: Dict[str, float] = {}   # url -> ramp start
        self._last_call_at: Optional[float] = None

    def route(self, endpoints, request_stats, headers, body) -> str:
        now = self._now()
        cold = not self._last_seen
        for ep in endpoints:
            last = self._last_seen.get(ep.url)
            if last is None:
                if not cold:
                    self._ramp_from[ep.url] = now
            elif self._last_call_at is not None and \
                    self._last_call_at - last >= self.absent_reset_s:
                # the router kept routing without this endpoint (it was
                # health-filtered away): back from the dead, ramp it
                self._ramp_from[ep.url] = now
            self._last_seen[ep.url] = now
        self._last_call_at = now
        if len(self._last_seen) > 4 * len(endpoints) + 64:
            # bound growth across dynamic-config fleet swaps
            live = {ep.url for ep in endpoints}
            self._last_seen = {u: t for u, t in self._last_seen.items()
                               if u in live}
        peak = max((st.in_flight for st in request_stats.values()),
                   default=0)

        def load(ep: EndpointInfo):
            st = request_stats.get(ep.url)
            real = (float(st.in_flight), st.qps) if st is not None \
                else (0.0, 0.0)
            start = self._ramp_from.get(ep.url)
            if start is None or self.slow_start_s <= 0:
                return real
            ramp = min(1.0, (now - start) / self.slow_start_s)
            if ramp >= 1.0:
                del self._ramp_from[ep.url]
                return real
            # peak+1 (not peak): the ramping endpoint must start
            # strictly busier-looking than the busiest known one, or
            # the qps tiebreak still hands it the whole burst
            return (max(real[0], (1.0 - ramp) * (peak + 1.0)), real[1])
        if not request_stats:
            return self._rr.route(endpoints, request_stats, headers, body)
        return min(endpoints, key=load).url


class HashRing:
    """Consistent hashing: md5 ring with virtual nodes."""

    def __init__(self, vnodes: int = 128):
        self.vnodes = vnodes
        self._points: List[int] = []
        self._owners: Dict[int, str] = {}
        self._nodes: List[str] = []

    @staticmethod
    def _hash(key: str) -> int:
        return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")

    def rebuild(self, nodes: Sequence[str]) -> None:
        nodes = sorted(set(nodes))
        if nodes == self._nodes:
            return
        self._nodes = list(nodes)
        self._points = []
        self._owners = {}
        for node in nodes:
            for i in range(self.vnodes):
                p = self._hash(f"{node}#{i}")
                self._points.append(p)
                self._owners[p] = node
        self._points.sort()

    def lookup(self, key: str) -> Optional[str]:
        if not self._points:
            return None
        h = self._hash(key)
        idx = bisect.bisect(self._points, h) % len(self._points)
        return self._owners[self._points[idx]]


class SessionRouter(Router):
    """Sticky sessions via consistent hashing on a session header.

    Requests without the session header fall back to least-loaded
    (parity with reference routing_logic.py:94-115's QPS fallback).
    """

    name = "session"

    def __init__(self, session_key: str = "x-user-id", vnodes: int = 128):
        self.session_key = session_key
        self._ring = HashRing(vnodes)
        self._fallback = LeastLoadedRouter()
        self.affinity = AffinityTracker()

    @property
    def affinity_moves(self) -> Dict[str, int]:
        return self.affinity.moves

    def route(self, endpoints, request_stats, headers, body) -> str:
        self._ring.rebuild([e.url for e in endpoints])
        session_id = headers.get(self.session_key)
        if not session_id:
            return self._fallback.route(endpoints, request_stats, headers,
                                        body)
        url = self._ring.lookup(session_id)
        self.affinity.note(session_id, url, {e.url for e in endpoints})
        return url


class PrefixAwareRouter(Router):
    """Cache-aware KV-affinity routing.

    Scores candidate endpoints by *expected prefix-hit bytes*, not just
    a prefix hash. Two signals feed the score:

    - a **chunk-granularity prefix ring**: the prompt text is chained
      into fixed-size chunk digests (the router-side mirror of
      kvcache/chunks.ChunkHasher — chunk i's digest folds chunk i-1's,
      so a digest match implies the whole leading prefix matches), and
      every routing decision records the chosen endpoint against the
      prompt's digests. Because the chosen engine prefills and then
      *publishes* exactly those chunks through its tiers
      (connector.on_prefill_progress/on_finish), the ring is a
      router-side view of the producer-publish path. Expected hit bytes
      for an endpoint = longest leading digest run it has served ×
      chunk size.
    - **scraped per-endpoint hit stats**: ties between equally-warm
      endpoints break on the engine-reported tier hit rate
      (EngineStats.kv_hit_rate from /load), then on live in-flight.

    Cold prefixes (no endpoint has served any leading chunk) fall back
    to consistent-hash affinity over the full configured prefix — the
    pre-cache-aware behavior — so repeated cold prefixes still converge
    onto one replica, and a replica that never saw the session still
    hits through the shared remote tier (kvcache/server.py as the
    cross-replica rendezvous).

    The ring is bounded (``ring_entries`` digests, LRU) and each digest
    remembers at most ``_URLS_PER_CHUNK`` recent servers — with a shared
    remote tier EVERY replica can serve a published chunk, but host-RAM
    locality (and therefore TTFT) is best on the replicas that computed
    or recently fetched it.
    """

    name = "prefix"

    _URLS_PER_CHUNK = 4

    def __init__(self, prefix_chars: int = 1024, vnodes: int = 128,
                 chunk_chars: int = 256, ring_entries: int = 65536,
                 max_track_chars: int = 8192, cache_aware: bool = True):
        self.prefix_chars = prefix_chars
        self.chunk_chars = max(1, chunk_chars)
        self.ring_entries = ring_entries
        self.max_track_chars = max_track_chars
        self.cache_aware = cache_aware
        self._ring = HashRing(vnodes)
        self._fallback = LeastLoadedRouter()
        # digest -> list of recent server URLs (most recent last); LRU
        # over digests via OrderedDict move_to_end
        import collections
        self._chunks: "collections.OrderedDict[bytes, List[str]]" = \
            collections.OrderedDict()
        self._get_engine_stats = None    # attach_scraper
        self.warm_routes = 0
        self.cold_routes = 0
        self.affinity = AffinityTracker()

    @property
    def affinity_moves(self) -> Dict[str, int]:
        return self.affinity.moves

    def attach_scraper(self, get_stats) -> None:
        """``get_stats() -> {url: EngineStats}`` (the router app passes
        EngineStatsScraper.get) — enables the hit-rate tiebreak."""
        self._get_engine_stats = get_stats

    _prompt_text = staticmethod(prompt_text)

    def _chunk_digests(self, text: str) -> List[bytes]:
        return prompt_chunk_digests(text, self.chunk_chars,
                                    self.max_track_chars)

    def _record(self, digests: List[bytes], url: str) -> None:
        """Feed the ring: the chosen engine will prefill-and-publish
        these chunks (producer path), or already held them."""
        record_chunk_holders(self._chunks, digests, url,
                             urls_per_chunk=self._URLS_PER_CHUNK,
                             max_entries=self.ring_entries)

    def _expected_hit_chunks(self, digests: List[bytes],
                             urls) -> Dict[str, int]:
        """Deepest recorded digest membership per candidate. A chained
        digest at depth i matches only if the WHOLE prefix through i
        matches, and an endpoint was recorded for depth i only by
        serving a prompt covering depths 0..i — so one deep membership
        is complete evidence for the full leading run. Scoring by the
        deepest membership (not a leading-run intersection) keeps the
        per-chunk holder cap harmless: a popular fleet-wide system
        prompt may evict an endpoint from the crowded EARLY chunks'
        holder lists while its session-specific deep chunks still
        name it."""
        score = {u: 0 for u in urls}
        for i, d in enumerate(digests):
            holders = self._chunks.get(d)
            if not holders:
                continue   # LRU-evicted or never seen; deeper evidence
                           # (if any) still stands on its own
            for u in holders:
                if u in score:
                    score[u] = i + 1
        return score

    def route(self, endpoints, request_stats, headers, body) -> str:
        self._ring.rebuild([e.url for e in endpoints])
        text = self._prompt_text(body)
        if not text:
            return self._fallback.route(endpoints, request_stats, headers,
                                        body)
        if not self.cache_aware:
            return self._ring.lookup(text[:self.prefix_chars])
        digests = self._chunk_digests(text)
        score = self._expected_hit_chunks(
            digests, [e.url for e in endpoints]) if digests else {}
        best = max(score.values(), default=0)
        if best > 0:
            self.warm_routes += 1
            warm = [u for u, s in score.items() if s == best]
            url = warm[0] if len(warm) == 1 else self._tiebreak(
                warm, request_stats)
        else:
            # cold prefix: consistent-hash affinity so repeats converge
            self.cold_routes += 1
            url = self._ring.lookup(text[:self.prefix_chars])
        self._record(digests, url)
        self.affinity.note(text[:self.prefix_chars], url,
                           {e.url for e in endpoints})
        return url

    def _tiebreak(self, urls: List[str], request_stats) -> str:
        """Equally-warm endpoints: prefer the higher engine-reported
        tier hit rate, then the lower live in-flight, then URL order
        (deterministic)."""
        stats = {}
        if self._get_engine_stats is not None:
            try:
                stats = self._get_engine_stats() or {}
            except Exception:
                stats = {}

        def key(u: str):
            es = stats.get(u)
            rs = request_stats.get(u)
            return (-(es.kv_hit_rate if es is not None else 0.0),
                    rs.in_flight if rs is not None else 0,
                    u)
        return min(urls, key=key)

    def expected_hit_bytes(self, body: dict, url: str,
                           bytes_per_chunk: Optional[int] = None) -> int:
        """Introspection/debug: the score the router would assign
        ``url`` for this body, in (approximate) bytes."""
        digests = self._chunk_digests(self._prompt_text(body))
        score = self._expected_hit_chunks(digests, [url]).get(url, 0)
        return score * (bytes_per_chunk or self.chunk_chars)


_ROUTERS = {
    "roundrobin": RoundRobinRouter,
    "least_loaded": LeastLoadedRouter,
    "session": SessionRouter,
    "prefix": PrefixAwareRouter,
}


def make_router(name: str, session_key: str = "x-user-id",
                prefix_chunk_chars: int = 256,
                prefix_ring_entries: int = 65536,
                prefix_cache_aware: bool = True) -> Router:
    if name not in _ROUTERS:
        raise ValueError(f"unknown routing logic {name!r}; "
                         f"options: {sorted(_ROUTERS)}")
    if name == "session":
        return SessionRouter(session_key=session_key)
    if name == "prefix":
        return PrefixAwareRouter(chunk_chars=prefix_chunk_chars,
                                 ring_entries=prefix_ring_entries,
                                 cache_aware=prefix_cache_aware)
    return _ROUTERS[name]()
