"""Disaggregated prefill/decode orchestration (BASELINE config 5; the
reference only roadmaps it: README.md:56,
docs/source/tutorials/disagg.rst "Coming soon"; the --kv-transfer-config
kv_role producer/consumer knob, deployment-vllm-multi.yaml:96-97, is its
engine-side hook).

Architecture: a *prefill pool* of kv_producer engines (e.g. v5p slices —
prefill is compute-bound and loves MXU width) and a *decode pool* of
kv_consumer engines (e.g. v5e — decode is HBM-bandwidth-bound), joined
by the shared KV tier (host DRAM / disk / tpukv remote server over DCN).

Request flow: the router first sends the prompt to a prefill engine as a
1-token non-streaming completion. That engine computes the prompt KV and
its producer connector writes full chunks through the shared tier —
progressively, via ``connector.on_prefill_progress``, so chunks become
visible while later chunks still prefill. After a bounded head-start the
router routes decode; ``DecodeSelector`` picks the decode engine by
NetKV-style cost — *expected KV transfer bytes* (chunk locality in the
candidate's own tiers vs the remote server vs nowhere) weighed against
scraped decode load, not load alone. The consumer engine's connector
pulls the cached prefix, so decode-side prefill collapses to the chunk
remainder.

Failure semantics (the degradation contract, docs/disagg.md): every
prefill-stage failure — pool missing, breaker open, connect error,
timeout, backend 5xx, overload shed — degrades to aggregated serving
(the decode engine recomputes from scratch) and increments
``tpu:router_disagg_fallbacks_total{reason}``. Prefill-stage pressure
must never shed decode-bound traffic: a prefill 429/503 shed is a
fallback, not a breaker signal and not a client-visible error.
"""

import asyncio
import collections
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import aiohttp

from production_stack_tpu_torch.router.proxy import CACHE_CONTROL_FIELDS
from production_stack_tpu_torch.router.routing import (prompt_chunk_digests,
                                                 record_chunk_holders)
from production_stack_tpu_torch.router.routing import prompt_text as _prompt_text
from production_stack_tpu_torch.router.service_discovery import EndpointInfo
from production_stack_tpu_torch.utils import init_logger, parse_comma_separated

logger = init_logger(__name__)

PREFILL_PATHS = ("/v1/chat/completions", "/v1/completions")

# fallback reasons (the {reason} label set of
# tpu:router_disagg_fallbacks_total); every prefill-stage failure maps
# onto exactly one of these — a prefill failure must never vanish
FALLBACK_REASONS = ("no_pool", "breaker_open", "shed", "http_error",
                    "timeout", "connect")


class DecodeSelector:
    """NetKV-style decode-engine selection (PAPERS.md): score candidates
    by *expected KV transfer bytes*, weighed against scraped load.

    Generalizes the r11 PrefixAwareRouter expected-hit-bytes scoring
    from "deepest warm membership wins" to a per-chunk transfer-cost
    model. For each leading prompt chunk a candidate decode engine pays:

    - **0** when the chunk is warm in its own tiers (this selector
      routed the same leading prefix there before — host-RAM locality,
      no DCN transfer);
    - ``remote_fetch_cost`` × chunk bytes when the chunk was published
      to the shared remote tier (a prefill pass covered it) but is not
      local — the consumer will pull it over the network;
    - ``recompute_cost`` × chunk bytes when the chunk is known to
      neither — the consumer's tier walk stops at the first such chunk
      and everything after it is recomputed regardless of locality.

    The score blends normalized transfer cost with normalized scraped
    decode load (in-flight over advertised capacity when the engine
    advertises one, else over the busiest candidate):

        score = transfer_weight * cost_norm + load_weight * load_norm

    **Cold-prefix fallback:** when no candidate's transfer cost differs
    (nothing about the prompt is known, or everything is equally
    remote) the selector abstains (returns None) and the configured
    routing policy decides — balancing load without a network signal
    is the policy's job (least-loaded reads the same stats; session
    and hash policies keep their affinity, which converges repeated
    cold prefixes onto one replica).

    State is bounded: ``ring_entries`` chunk digests (LRU) for both the
    locality ring and the published-to-remote set.
    """

    _URLS_PER_CHUNK = 4

    def __init__(self, chunk_chars: int = 256,
                 ring_entries: int = 65536,
                 max_track_chars: int = 8192,
                 transfer_weight: float = 1.0,
                 load_weight: float = 1.0,
                 remote_fetch_cost: float = 1.0,
                 recompute_cost: float = 2.0):
        self.chunk_chars = max(1, chunk_chars)
        self.ring_entries = ring_entries
        self.max_track_chars = max_track_chars
        self.transfer_weight = transfer_weight
        self.load_weight = load_weight
        self.remote_fetch_cost = remote_fetch_cost
        self.recompute_cost = recompute_cost
        # digest -> recent decode URLs holding the chunk locally (most
        # recent last); LRU over digests
        self._chunks: "collections.OrderedDict[bytes, List[str]]" = \
            collections.OrderedDict()
        # digests a prefill pass covered -> published to the shared
        # remote tier (value unused; OrderedDict for LRU)
        self._published: "collections.OrderedDict[bytes, None]" = \
            collections.OrderedDict()
        # superset of URLs present in _chunks (an LRU'd-out URL may
        # linger until the next real eviction): lets evict_except
        # no-op without scanning the ring when nobody departed
        self._seen_urls: set = set()
        self.cost_routes = 0        # selections made by the cost model
        self.abstains = 0           # cold prefix: policy decided

    # shared with PrefixAwareRouter (routing.py): both rings must chunk
    # the SAME rendering or affinity and cost scoring diverge
    prompt_text = staticmethod(_prompt_text)

    @staticmethod
    def prompt_chars(body: dict) -> int:
        """CONTENT length only — the length gate's unit. prompt_text
        (the digest basis) serializes the whole messages array, whose
        ~40 chars/message of role/key scaffolding would let a 2-char
        chat sail past --disagg-min-prompt-chars."""
        msgs = body.get("messages")
        if isinstance(msgs, list):
            return sum(len(str(m.get("content") or ""))
                       for m in msgs if isinstance(m, dict))
        prompt = body.get("prompt", "")
        return len(prompt) if isinstance(prompt, str) else \
            len(json.dumps(prompt))

    def digests(self, body: dict) -> List[bytes]:
        return prompt_chunk_digests(self.prompt_text(body),
                                    self.chunk_chars,
                                    self.max_track_chars)

    # -- state feeds -----------------------------------------------------

    def on_prefill_dispatched(self, digests: Sequence[bytes]) -> None:
        """A prefill pass covers these chunks: the producer will publish
        them to the shared remote tier (progressively, so marking at
        dispatch time matches what a post-head-start consumer sees)."""
        for d in digests:
            self._published[d] = None
            self._published.move_to_end(d)
        while len(self._published) > self.ring_entries:
            self._published.popitem(last=False)

    def on_decode_routed(self, digests: Sequence[bytes],
                         url: str) -> None:
        """The chosen decode engine will fetch-or-compute these chunks
        and hold them in its local tiers afterwards."""
        record_chunk_holders(self._chunks, digests, url,
                             urls_per_chunk=self._URLS_PER_CHUNK,
                             max_entries=self.ring_entries)
        self._seen_urls.add(url)

    def on_decode_failed(self, digests: Sequence[bytes],
                         url: str) -> None:
        """A routed attempt failed before any byte reached the client:
        the engine never pulled the KV, so the route-time credit must
        come back out — a shedding engine's low in-flight would
        otherwise keep winning the load tiebreak at phantom-zero
        transfer cost for exactly the prefixes it keeps refusing.
        (_seen_urls deliberately keeps the URL: it is a superset.)"""
        for d in digests:
            urls = self._chunks.get(d)
            if urls and url in urls:
                urls.remove(url)
                if not urls:
                    del self._chunks[d]

    def rehome(self, from_url: str, to_url: str,
               digests: Optional[Sequence[bytes]] = None) -> int:
        """kvplane migration hand-off: chunks whose KV just moved
        replica-to-replica now live on ``to_url``, so the locality
        evidence must follow — otherwise transfer-cost scoring keeps
        steering the migrated prefixes at the replica that no longer
        holds them (recreating the very pressure the migration
        relieved). ``digests=None`` rehomes every entry naming
        ``from_url`` (whole-replica drain); a digest list restricts the
        rewrite to the migrated chunks. Returns entries rewritten."""
        if from_url == to_url:
            return 0
        keys = list(self._chunks) if digests is None else digests
        moved = 0
        for d in keys:
            urls = self._chunks.get(d)
            if not urls or from_url not in urls:
                continue
            urls.remove(from_url)
            if to_url not in urls:
                urls.append(to_url)
            moved += 1
        if moved:
            self._seen_urls.add(to_url)
        return moved

    def evict_except(self, live_urls) -> None:
        """Drop locality evidence for decode engines that left the
        fleet (dynamic-config swaps) — a departed URL must not keep
        winning cost scoring. Called on every /metrics scrape (and
        every dynamic-config apply), so the common nobody-departed
        case must not pay a full-ring scan."""
        live = set(live_urls)
        if self._seen_urls <= live:
            return
        for d in list(self._chunks):
            urls = [u for u in self._chunks[d] if u in live]
            if urls:
                self._chunks[d] = urls
            else:
                del self._chunks[d]
        self._seen_urls &= live

    # -- scoring ---------------------------------------------------------

    def transfer_cost(self, digests: Sequence[bytes], url: str) -> float:
        """Expected transfer cost for ``url``, in chunk-char units
        (absolute scale cancels in normalization)."""
        cost = 0.0
        walk_broken = False
        for d in digests:
            if walk_broken:
                cost += self.chunk_chars * self.recompute_cost
                continue
            if url in (self._chunks.get(d) or ()):
                continue                       # local: free
            if d in self._published:
                cost += self.chunk_chars * self.remote_fetch_cost
                continue
            # neither local nor remote: the consumer's tier walk stops
            # here; the rest of the prompt recomputes
            walk_broken = True
            cost += self.chunk_chars * self.recompute_cost
        return cost

    def select(self, body: dict, urls: Sequence[str],
               request_stats: Dict, engine_stats: Dict,
               digests: Optional[List[bytes]] = None,
               explain: Optional[dict] = None) -> Optional[str]:
        """Pick a decode URL, or None to abstain (cold prefix — let the
        routing policy decide). ``digests`` lets the caller hash the
        prompt once per request instead of once per hook. ``explain``
        (a caller-owned dict) is filled with the per-candidate
        transfer-cost inputs so the decision is reconstructable from a
        trace (tracing.py ``decode_select`` event span)."""
        if len(urls) <= 1:
            return None
        if digests is None:
            digests = self.digests(body)
        if not digests:
            return None
        costs = {u: self.transfer_cost(digests, u) for u in urls}
        if explain is not None:
            explain["transfer_cost"] = {u: round(c, 1)
                                        for u, c in costs.items()}
            explain["chunks"] = len(digests)
        if max(costs.values()) - min(costs.values()) < 1e-9:
            # no locality signal separates the candidates: abstain so
            # the policy's own affinity (hash ring) keeps repeated cold
            # prefixes converging
            self.abstains += 1
            return None
        # normalize by the worst possible cost; the max() guards a
        # zero cost knob (--disagg-recompute-cost 0 is expressible)
        max_cost = len(digests) * self.chunk_chars * max(
            self.recompute_cost, self.remote_fetch_cost, 1e-9)

        def in_flight(u: str) -> float:
            rs = request_stats.get(u)
            return float(rs.in_flight) if rs is not None else 0.0

        peak = max((in_flight(u) for u in urls), default=0.0)

        def capacity(u: str) -> float:
            es = engine_stats.get(u) if engine_stats else None
            cap = getattr(es, "capacity", 0.0) if es is not None else 0.0
            return float(cap) if cap and cap > 0 else 0.0

        # one normalization for the whole candidate set: utilization
        # (in-flight / advertised capacity) only when EVERY candidate
        # advertises one — mixing it with the peak-relative scale would
        # systematically favor exactly the engines whose stats are
        # missing or stale
        use_capacity = all(capacity(u) > 0 for u in urls)

        def load_norm(u: str) -> float:
            if use_capacity:
                return min(2.0, in_flight(u) / capacity(u))
            return in_flight(u) / (peak + 1.0)

        def score(u: str) -> Tuple[float, str]:
            return (self.transfer_weight * (costs[u] / max_cost)
                    + self.load_weight * load_norm(u), u)

        self.cost_routes += 1
        picked = min(urls, key=score)
        if explain is not None:
            explain["selected"] = picked
        return picked


class DisaggPrefillOrchestrator:
    """Owns the prefill pool and the decode selection for the two-stage
    request (see module docstring).

    Prefill dispatch round-robins per model over breaker-closed pool
    members. Failure handling: a per-backend circuit breaker opens after
    ``breaker_threshold`` consecutive failures and skips the backend for
    ``breaker_cooldown_s`` (decode engines can always recompute, so an
    open breaker degrades to non-disagg behavior, never to errors) —
    overload sheds (429/503 + Retry-After) are fallbacks but NEVER
    breaker signals, mirroring the r9 shed≠sick contract. Latency: the
    proxy gives prefill only a bounded ``headstart_s`` before routing
    decode (see run_with_headstart) — the producer keeps publishing KV
    chunks progressively in the background either way.

    ``set_pool`` swaps the prefill endpoint set at runtime (dynamic
    config): breaker and rotation state survive for members present on
    both sides of the swap — the same bug class r11 fixed for prefix
    rings (a fleet swap must not amnesty a sick backend or reset a
    rotation mid-cycle).
    """

    def __init__(self, backends: List[str], models: List[str],
                 timeout_s: float = 15.0, headstart_s: float = 2.0,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0,
                 min_prompt_chars: int = 0,
                 selector: Optional[DecodeSelector] = None):
        self.endpoints: List[EndpointInfo] = []
        self.timeout_s = timeout_s
        self.headstart_s = headstart_s
        self.breaker_threshold = breaker_threshold
        self.breaker_cooldown_s = breaker_cooldown_s
        self.min_prompt_chars = min_prompt_chars
        self.selector = selector
        # per-model counters: a shared counter advanced by other models'
        # traffic would skew (or fully starve) a pool's rotation
        self._rr: Dict[str, int] = {}
        self._consecutive_failures: Dict[str, int] = {}
        self._open_until: Dict[str, float] = {}
        self.prefills = 0
        self.prefill_errors = 0
        self.breaker_opens = 0
        self.headstart_elapsed = 0   # decode routed before prefill done
        self.fallbacks: Dict[str, int] = {r: 0 for r in FALLBACK_REASONS}
        self.set_pool(backends, models)

    # -- pool management -------------------------------------------------

    def set_pool(self, backends: List[str], models: List[str]) -> None:
        """Swap the prefill endpoint set; per-URL breaker state and
        per-model rotation counters survive for surviving members."""
        if len(backends) != len(models):
            raise ValueError(
                f"{len(backends)} prefill backends but {len(models)} "
                f"models")
        backends = [u.rstrip("/") for u in backends]
        self.endpoints = [EndpointInfo(url=u, model=m, pool="prefill")
                          for u, m in zip(backends, models)]
        live = set(backends)
        self._consecutive_failures = {
            u: n for u, n in self._consecutive_failures.items()
            if u in live}
        self._open_until = {u: t for u, t in self._open_until.items()
                            if u in live}
        live_models = {ep.model for ep in self.endpoints}
        self._rr = {m: i for m, i in self._rr.items() if m in live_models}

    def pool_snapshot(self) -> dict:
        """Operator view for /health."""
        now = self._now()
        return {
            "endpoints": [ep.url for ep in self.endpoints],
            "models": sorted({ep.model for ep in self.endpoints}),
            "open_breakers": sorted(
                u for u, t in self._open_until.items() if t > now),
            "prefills": self.prefills,
            "prefill_errors": self.prefill_errors,
            "fallbacks": dict(self.fallbacks),
        }

    def _now(self) -> float:
        return time.monotonic()

    def _fallback(self, reason: str) -> None:
        self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1

    def pick(self, model: str) -> Optional[str]:
        """Breaker-filtered per-model round-robin; None (with the
        fallback counted) when the pool can't take this prefill."""
        serving = [ep.url for ep in self.endpoints if ep.serves(model)]
        if not serving:
            self._fallback("no_pool")
            return None
        now = self._now()
        pool = [u for u in serving
                if self._open_until.get(u, 0.0) <= now]
        if not pool:
            self._fallback("breaker_open")
            return None
        idx = self._rr.get(model, 0)
        self._rr[model] = idx + 1
        return pool[idx % len(pool)]

    def _record(self, url: str, ok: bool) -> None:
        if ok:
            self._consecutive_failures[url] = 0
            return
        n = self._consecutive_failures.get(url, 0) + 1
        self._consecutive_failures[url] = n
        if n >= self.breaker_threshold:
            self._open_until[url] = self._now() + self.breaker_cooldown_s
            self._consecutive_failures[url] = 0
            self.breaker_opens += 1
            logger.warning(
                "disagg prefill breaker OPEN for %s (%d consecutive "
                "failures; cooldown %.0fs)", url, n,
                self.breaker_cooldown_s)

    # -- request gating --------------------------------------------------

    def should_run(self, endpoint_path: str, body: dict) -> bool:
        """Cheap pre-dispatch gate: right path, long-enough prompt.
        Short prompts skip the prefill stage entirely — a 1-token pass
        plus a tier walk costs more than just prefilling a few chars on
        the decode engine (``--disagg-min-prompt-chars``). Length is
        measured over message CONTENT, not JSON framing."""
        if endpoint_path not in PREFILL_PATHS:
            return False
        model = body.get("model")
        if not any(ep.serves(model) for ep in self.endpoints):
            # a model the pool was never configured for is not a
            # degradation — the disagg stage is simply inert for it;
            # counting it as a no_pool fallback would read a healthy
            # multi-model deployment as permanently degrading
            return False
        if self.min_prompt_chars <= 0:
            return True
        return DecodeSelector.prompt_chars(body) >= \
            self.min_prompt_chars

    # -- prefill stage ---------------------------------------------------

    @staticmethod
    def prefill_body(body: dict) -> dict:
        """The original request reduced to a 1-token non-streaming pass:
        enough for the producer engine to compute + publish the prompt
        KV, cheap enough to run serially before decode."""
        drop = ("stream", "stream_options") + CACHE_CONTROL_FIELDS
        out = {k: v for k, v in body.items() if k not in drop}
        out["max_tokens"] = 1
        out.pop("max_completion_tokens", None)
        return out

    def digests(self, body: dict) -> Optional[List[bytes]]:
        """Hash the prompt ONCE per request (the proxy threads the
        result through run_with_headstart / select_decode /
        on_decode_routed); None when no selector is configured."""
        if self.selector is None:
            return None
        return self.selector.digests(body)

    async def run_prefill(self, session: aiohttp.ClientSession,
                          endpoint_path: str, model: str, body: dict,
                          headers: Optional[Dict[str, str]] = None,
                          digests: Optional[List[bytes]] = None,
                          trace=None) -> bool:
        """Fire the prefill pass; True when the pool accepted it. Every
        failure path increments exactly one fallback reason. ``trace``
        (tracing.RequestTrace) gets a ``prefill`` EVENT span AT
        DISPATCH (so a pass that outlasts the sealed trace — long
        prompt, short decode — still leaves its evidence in the chain)
        and a ``prefill_result`` event when the pass settles, when the
        trace is still open. Events, not phases: the pass overlaps the
        decode-side phases past the head-start."""
        if endpoint_path not in PREFILL_PATHS:
            return False
        url = self.pick(model)
        if url is None:
            if trace is not None:
                trace.add_event("prefill", None, 0.0, status="fallback",
                                attrs={"reason": "no_pool_or_breaker"})
            return False            # pick counted no_pool/breaker_open
        self.prefills += 1
        t_pf = time.monotonic()
        if trace is not None:
            trace.add_event("prefill", t_pf, 0.0, status="dispatched",
                            attrs={"server": url})

        def _span(status: str) -> None:
            if trace is not None:
                trace.add_event("prefill_result", t_pf,
                                time.monotonic() - t_pf, status=status,
                                attrs={"server": url})
        if self.selector is not None:
            # mark at dispatch: the producer publishes progressively,
            # so by the time a post-head-start decode walks the tier
            # the leading chunks are (becoming) remote-visible
            self.selector.on_prefill_dispatched(
                digests if digests is not None
                else self.selector.digests(body))
        try:
            async with session.post(
                    f"{url}{endpoint_path}",
                    json=self.prefill_body(body),
                    headers=headers or {},
                    timeout=aiohttp.ClientTimeout(
                        total=self.timeout_s)) as resp:
                await resp.read()
                if resp.status == 200:
                    self._record(url, True)
                    _span("ok")
                    return True
                if resp.status in (429, 503) and \
                        "Retry-After" in resp.headers:
                    # prefill-queue pressure: the engine is healthy but
                    # full. Degrade to aggregated serving — decode-bound
                    # traffic is NOT shed and the breaker is NOT fed
                    # (shed ≠ sick, the r9 contract at this stage)
                    logger.debug("disagg prefill on %s shed (HTTP %d); "
                                 "decode recomputes", url, resp.status)
                    self.prefill_errors += 1
                    self._fallback("shed")
                    _span("shed")
                    return False
                logger.warning("disagg prefill on %s returned %d", url,
                               resp.status)
                self._fallback("http_error")
        except asyncio.TimeoutError:
            logger.warning("disagg prefill on %s timed out after %gs",
                           url, self.timeout_s)
            self._fallback("timeout")
        except (aiohttp.ClientError, ConnectionError, OSError) as e:
            logger.warning("disagg prefill on %s failed: %s", url, e)
            self._fallback("connect")
        except Exception as e:
            # the degradation contract admits no exception shape: a
            # prefill failure of ANY kind must degrade to aggregated
            # serving and be counted — never escape as an unretrieved
            # task exception (the head-start caller may not await us)
            logger.warning("disagg prefill on %s failed unexpectedly: "
                           "%s", url, e, exc_info=True)
            self._fallback("http_error")
        self.prefill_errors += 1
        self._record(url, False)
        _span("error")
        return False

    async def run_with_headstart(self, session: aiohttp.ClientSession,
                                 endpoint_path: str, model: str,
                                 body: dict,
                                 headers: Optional[Dict[str, str]] = None,
                                 digests: Optional[List[bytes]] = None,
                                 trace=None) -> None:
        """Overlap: give prefill at most ``headstart_s`` before decode
        routing proceeds. The prefill task keeps running (and its engine
        keeps publishing KV chunks progressively) in the background; a
        decode engine that starts early simply finds fewer cached chunks
        — never a wrong result."""
        task = asyncio.ensure_future(self.run_prefill(
            session, endpoint_path, model, body, headers,
            digests=digests, trace=trace))
        done, _ = await asyncio.wait({task}, timeout=self.headstart_s)
        if not done:
            self.headstart_elapsed += 1
            logger.debug("disagg prefill still running after %.1fs "
                         "head-start; routing decode now",
                         self.headstart_s)
            # surface late failures in logs/counters, never as exceptions
            task.add_done_callback(lambda t: t.exception())

    # -- decode stage ----------------------------------------------------

    def select_decode(self, body: dict, candidates, request_stats,
                      engine_stats,
                      digests: Optional[List[bytes]] = None,
                      explain: Optional[dict] = None
                      ) -> Optional[str]:
        """Transfer-cost-aware decode pick; None = let the routing
        policy decide (selector disabled or cold prefix)."""
        if self.selector is None:
            return None
        return self.selector.select(
            body, [ep.url for ep in candidates], request_stats,
            engine_stats or {}, digests=digests, explain=explain)

    def on_decode_routed(self, body: dict, url: str,
                         digests: Optional[List[bytes]] = None) -> None:
        if self.selector is not None:
            self.selector.on_decode_routed(
                digests if digests is not None
                else self.selector.digests(body), url)

    def on_decode_failed(self, body: dict, url: str,
                         digests: Optional[List[bytes]] = None) -> None:
        if self.selector is not None:
            self.selector.on_decode_failed(
                digests if digests is not None
                else self.selector.digests(body), url)


def make_orchestrator(args, kwargs: Optional[dict] = None
                      ) -> Optional[DisaggPrefillOrchestrator]:
    backends = parse_comma_separated(
        getattr(args, "prefill_backends", None))
    if not backends:
        return None
    models = parse_comma_separated(getattr(args, "prefill_models", None))
    return build_orchestrator(backends, models,
                              kwargs if kwargs is not None
                              else orchestrator_kwargs(args))


def build_orchestrator(backends: List[str], models: List[str],
                       kwargs: Optional[dict]
                       ) -> DisaggPrefillOrchestrator:
    """Construct an orchestrator from an ``orchestrator_kwargs`` dict.
    The selector factory (if any) is invoked HERE, so every
    orchestrator — startup or a dynamic-config enable — gets a FRESH
    DecodeSelector instead of inheriting a previous incarnation's
    locality state."""
    kw = dict(kwargs or {})
    factory = kw.pop("selector_factory", None)
    if factory is not None and kw.get("selector") is None:
        kw["selector"] = factory()
    return DisaggPrefillOrchestrator(backends, models, **kw)


def orchestrator_kwargs(args) -> dict:
    """The CLI-configured knobs, reusable by a dynamic-config swap that
    creates the orchestrator after startup (app state
    ``disagg_kwargs``). Carries a selector *factory*, not an instance —
    see build_orchestrator."""
    factory = None
    if not getattr(args, "no_disagg_decode_selection", False):
        knobs = dict(
            chunk_chars=getattr(args, "disagg_chunk_chars", 256),
            transfer_weight=getattr(args, "disagg_transfer_weight", 1.0),
            load_weight=getattr(args, "disagg_load_weight", 1.0),
            remote_fetch_cost=getattr(args, "disagg_remote_cost", 1.0),
            recompute_cost=getattr(args, "disagg_recompute_cost", 2.0))

        def factory(knobs=knobs):
            return DecodeSelector(**knobs)
    return dict(
        timeout_s=getattr(args, "prefill_timeout", 15.0),
        headstart_s=getattr(args, "prefill_headstart", 2.0),
        breaker_threshold=getattr(args, "prefill_breaker_threshold", 3),
        breaker_cooldown_s=getattr(args, "prefill_breaker_cooldown",
                                   30.0),
        min_prompt_chars=getattr(args, "disagg_min_prompt_chars", 0),
        selector_factory=factory)
