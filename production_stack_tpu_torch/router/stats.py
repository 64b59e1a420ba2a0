"""Router stats plane: per-engine request stats + scraped engine stats.

Capability parity with reference src/vllm_router/stats/ (request_stats.py
sliding-window QPS/TTFT/latency monitor :20-282; engine_stats.py
Prometheus scraper :27-186), re-designed: one dataclass per concern, the
scraper is an asyncio task (not a thread), and histograms are simple
ring-deques trimmed on read.
"""

import asyncio
import collections
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, Optional, Tuple

import aiohttp
from prometheus_client.parser import text_string_to_metric_families

from production_stack_tpu_torch.signals import LoadPoller, parse_load_report
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class _Window:
    """Sliding window of (timestamp, value) pairs.

    A running sum makes ``mean`` O(popped), not O(len): under load a
    30 s arrival window holds tens of thousands of entries, and the
    stats plane reads every window on each snapshot refresh.

    ``now`` is compared with ``is None`` throughout — an explicit 0.0
    (epoch zero, which deterministic tests use as a time origin) is a
    timestamp, not "not provided".
    """

    def __init__(self, horizon_s: float):
        self.horizon = horizon_s
        self._items: Deque[Tuple[float, float]] = collections.deque()
        self._sum = 0.0

    def add(self, value: float, now: Optional[float] = None) -> None:
        if now is None:
            now = time.time()
        self._items.append((now, value))
        self._sum += value

    def _trim(self, now: float) -> None:
        cutoff = now - self.horizon
        while self._items and self._items[0][0] < cutoff:
            _, value = self._items.popleft()
            self._sum -= value
        if not self._items:
            self._sum = 0.0        # shed accumulated float drift

    def count(self, now: Optional[float] = None) -> int:
        self._trim(time.time() if now is None else now)
        return len(self._items)

    def mean(self, now: Optional[float] = None) -> float:
        self._trim(time.time() if now is None else now)
        if not self._items:
            return 0.0
        return self._sum / len(self._items)

    def rate(self, now: Optional[float] = None) -> float:
        if now is None:
            now = time.time()
        self._trim(now)
        return len(self._items) / self.horizon


@dataclass
class RequestStats:
    """Router-observed stats for one engine URL."""

    qps: float = 0.0
    ttft: float = 0.0              # mean seconds in window
    latency: float = 0.0           # mean end-to-end seconds in window
    itl: float = 0.0               # mean inter-token latency proxy
    in_flight: int = 0             # currently proxied requests
    in_prefill: int = 0            # accepted, no first byte yet
    in_decoding: int = 0           # streaming
    finished: int = 0              # total completed


class ActiveRequest:
    """Mutable per-request record handed out by ``on_new_request``.

    The proxy's streaming hot loop does a bare ``rec.tokens += 1`` per
    chunk — no dict lookup by (url, request_id) tuple key — and every
    piece of window math is deferred to ``on_request_complete``.
    """

    __slots__ = ("url", "start", "first_byte", "tokens")

    def __init__(self, url: str, start: float):
        self.url = url
        self.start = start
        self.first_byte: Optional[float] = None
        self.tokens = 0


class RequestStatsMonitor:
    """Lifecycle hooks called by the proxy; windows per engine URL.

    ``snapshot()`` is the routing-decision read: the full sliding-window
    aggregate is recomputed at most every ``snapshot_ttl_s`` seconds
    (50 ms default — far inside any horizon's resolution) while the
    in-flight counters are always read live. ``get()`` always computes
    fresh (metrics scrapes, stat logging, tests).
    """

    def __init__(self, horizon_s: float = 30.0,
                 snapshot_ttl_s: float = 0.05):
        self.horizon = horizon_s
        self.snapshot_ttl_s = snapshot_ttl_s
        self._arrivals: Dict[str, _Window] = {}
        self._ttft: Dict[str, _Window] = {}
        self._latency: Dict[str, _Window] = {}
        self._itl: Dict[str, _Window] = {}
        self._in_prefill: Dict[str, int] = collections.defaultdict(int)
        self._in_decoding: Dict[str, int] = collections.defaultdict(int)
        self._finished: Dict[str, int] = collections.defaultdict(int)
        self._snapshot: Dict[str, RequestStats] = {}
        self._snapshot_at: float = float("-inf")

    def _window(self, store: Dict[str, _Window], url: str) -> _Window:
        if url not in store:
            store[url] = _Window(self.horizon)
        return store[url]

    # lifecycle ---------------------------------------------------------

    def on_new_request(self, url: str,
                       now: Optional[float] = None) -> ActiveRequest:
        if now is None:
            now = time.time()
        self._window(self._arrivals, url).add(1.0, now)
        self._in_prefill[url] += 1
        return ActiveRequest(url, now)

    def on_first_token(self, rec: ActiveRequest,
                       now: Optional[float] = None) -> None:
        if rec.first_byte is not None:
            return
        rec.first_byte = time.time() if now is None else now
        url = rec.url
        self._in_prefill[url] = max(0, self._in_prefill[url] - 1)
        self._in_decoding[url] += 1

    def on_request_complete(self, rec: ActiveRequest,
                            now: Optional[float] = None) -> None:
        if now is None:
            now = time.time()
        url = rec.url
        first = rec.first_byte
        if first is None:
            self._in_prefill[url] = max(0, self._in_prefill[url] - 1)
        else:
            self._in_decoding[url] = max(0, self._in_decoding[url] - 1)
            # window math deferred from the hot loop; stamped with the
            # completion time (like latency/ITL) — timestamps must stay
            # monotonic within the deque or the front-trim stops early
            # and expired samples linger in the mean
            self._window(self._ttft, url).add(first - rec.start, now)
            if rec.tokens > 1:
                self._window(self._itl, url).add(
                    (now - first) / (rec.tokens - 1), now)
        self._window(self._latency, url).add(now - rec.start, now)
        self._finished[url] += 1

    def evict_except(self, live_urls) -> None:
        """Drop windows/counters for engines no longer in discovery."""
        live = set(live_urls)
        for store in (self._arrivals, self._ttft, self._latency, self._itl,
                      self._in_prefill, self._in_decoding, self._finished):
            for url in [u for u in store if u not in live]:
                del store[url]
        self._snapshot_at = float("-inf")   # force a fresh snapshot

    # reads -------------------------------------------------------------

    def get(self, now: Optional[float] = None) -> Dict[str, RequestStats]:
        if now is None:
            now = time.time()
        urls = set(self._arrivals) | set(self._in_prefill) | set(
            self._in_decoding)
        out = {}
        for url in urls:
            out[url] = RequestStats(
                qps=self._window(self._arrivals, url).rate(now),
                ttft=self._window(self._ttft, url).mean(now),
                latency=self._window(self._latency, url).mean(now),
                itl=self._window(self._itl, url).mean(now),
                in_flight=self._in_prefill[url] + self._in_decoding[url],
                in_prefill=self._in_prefill[url],
                in_decoding=self._in_decoding[url],
                finished=self._finished[url],
            )
        return out

    def snapshot(self) -> Dict[str, RequestStats]:
        """Cached window aggregates + live in-flight counters: what a
        routing decision reads. With ``snapshot_ttl_s <= 0`` this is
        exactly ``get()``."""
        now = time.time()
        if self.snapshot_ttl_s <= 0 or \
                now - self._snapshot_at >= self.snapshot_ttl_s:
            self._snapshot = self.get(now)
            self._snapshot_at = now
            return self._snapshot
        for url, st in self._snapshot.items():
            st.in_prefill = self._in_prefill.get(url, 0)
            st.in_decoding = self._in_decoding.get(url, 0)
            st.in_flight = st.in_prefill + st.in_decoding
        # an engine whose FIRST request arrived inside the TTL is not in
        # the cached dict yet — surface it with live counters (and zero
        # window aggregates) or least-loaded routing would read it as
        # idle and dogpile it until the next refresh
        for url in [u for u in set(self._in_prefill)
                    | set(self._in_decoding) if u not in self._snapshot]:
            pre = self._in_prefill.get(url, 0)
            dec = self._in_decoding.get(url, 0)
            if pre or dec:
                self._snapshot[url] = RequestStats(
                    in_prefill=pre, in_decoding=dec, in_flight=pre + dec)
        return self._snapshot


@dataclass
class EngineStats:
    """Parsed from an engine's /metrics exposition."""

    num_running: float = 0.0
    num_waiting: float = 0.0
    kv_usage: float = 0.0          # vllm:gpu_cache_usage_perc | tpu:hbm_kv
    prefix_hit_rate: float = 0.0
    # overload-protection signals (engine/metrics.py): the total
    # in-flight the engine accepts before shedding (0 = unbounded
    # admission — no per-endpoint concurrency cap derivable) and its
    # own queue-delay estimate
    capacity: float = 0.0
    est_queue_delay_ms: float = 0.0
    # tier-share signals (/load "kv_cache" block; zero for engines
    # without KV tiering): the cache-aware prefix router breaks scoring
    # ties on kv_hit_rate (routing.PrefixAwareRouter)
    kv_hit_rate: float = 0.0
    kv_hit_tokens: float = 0.0
    kv_foreign_hit_tokens: float = 0.0
    # disagg role from /load ("kv_producer"/"kv_consumer"/"kv_both";
    # "" = no KV tiering): surfaced in the stat log so a mis-wired
    # pool (a producer in the decode set) is visible at a glance
    kv_role: str = ""
    # engine-efficiency signals (/load "perf" block; zeros for
    # foreign/legacy engines): the hardware-level view next to the
    # load view — a replica at high utilization but low MBU/live
    # fraction is busy doing dead work, and compile_in_flight > 0
    # explains a latency spike without a /debug round trip
    mbu_perc: float = 0.0
    live_fraction: float = 0.0
    decode_tokens_per_s: float = 0.0
    compiles_total: float = 0.0
    compile_in_flight: float = 0.0
    # the engine's live model catalog from /load ("models": base first,
    # then every currently-loaded LoRA adapter): feeds /v1/models
    # aggregation and the pool-resolution scrape fallback — a
    # just-loaded adapter becomes routable one scrape later with no
    # config push (router/pools.py)
    served_models: Tuple[str, ...] = ()
    scraped_at: float = field(default_factory=time.time)


_WANTED_GAUGES = ("vllm:num_requests_running", "vllm:num_requests_waiting",
                  "vllm:gpu_cache_usage_perc", "tpu:hbm_kv_usage_perc",
                  "vllm:gpu_prefix_cache_hit_rate",
                  "tpu:engine_capacity_seqs", "tpu:est_queue_delay_ms")


def parse_engine_metrics(text: str) -> EngineStats:
    values: Dict[str, float] = {}
    for family in text_string_to_metric_families(text):
        if family.name in _WANTED_GAUGES:
            for sample in family.samples:
                values[family.name] = float(sample.value)
    # vllm's gauge name wins when both KV-usage spellings are exposed
    kv = values.get("vllm:gpu_cache_usage_perc",
                    values.get("tpu:hbm_kv_usage_perc", 0.0))
    return EngineStats(
        num_running=values.get("vllm:num_requests_running", 0.0),
        num_waiting=values.get("vllm:num_requests_waiting", 0.0),
        kv_usage=kv,
        prefix_hit_rate=values.get("vllm:gpu_prefix_cache_hit_rate", 0.0),
        capacity=values.get("tpu:engine_capacity_seqs", 0.0),
        est_queue_delay_ms=values.get("tpu:est_queue_delay_ms", 0.0),
        # foreign backends (no /load): the exported prefix hit rate is
        # the closest available proxy for tier-hit likelihood
        kv_hit_rate=values.get("vllm:gpu_prefix_cache_hit_rate", 0.0),
    )


class EngineStatsScraper(LoadPoller):
    """Polls every engine's /load on an interval (asyncio task).

    Built on the shared ``signals.LoadPoller`` so the endpoint-cap
    derivation (proxy._endpoint_cap), the stat logger, and an embedded
    autoscaler all read ONE scrape per engine per interval. The /load
    report is a purpose-built JSON answer — far cheaper on both sides
    than parsing a full Prometheus exposition — and carries everything
    EngineStats needs; engines that do not serve /load (a foreign
    vLLM pod behind the same router) fall back to the /metrics parse.
    """

    def __init__(self, get_endpoints, interval_s: float = 10.0):
        super().__init__(
            lambda: [ep.url for ep in get_endpoints()],
            interval_s=interval_s)
        self._stats: Dict[str, EngineStats] = {}

    def _build(self, data: dict) -> EngineStats:
        load = parse_load_report(data)
        return EngineStats(
            num_running=load.running,
            num_waiting=load.queue_depth,
            kv_usage=load.kv_usage,
            # EngineStats keeps 0.0 as its unbounded-admission sentinel
            # (pre-/load consumers pin it: see proxy._endpoint_cap)
            capacity=load.capacity if load.capacity is not None else 0.0,
            est_queue_delay_ms=load.est_queue_delay_ms,
            kv_hit_rate=load.kv_hit_rate,
            kv_hit_tokens=load.kv_hit_tokens,
            kv_foreign_hit_tokens=load.kv_foreign_hit_tokens,
            kv_role=load.kv_role,
            mbu_perc=load.mbu_perc,
            live_fraction=load.live_fraction,
            decode_tokens_per_s=load.decode_tokens_per_s,
            compiles_total=load.compiles_total,
            compile_in_flight=load.compile_in_flight,
            served_models=load.models,
        )

    async def _fetch_fallback(self, url: str) -> Optional[EngineStats]:
        try:
            async with self._session.get(f"{url}/metrics",
                                         timeout=self._timeout) as r:
                if r.status == 200:
                    return parse_engine_metrics(await r.text())
        except (aiohttp.ClientError, asyncio.TimeoutError):
            pass
        return None

    def get(self) -> Dict[str, EngineStats]:
        return dict(self._stats)


class StatLogger:
    """Periodic stat dump: one log line per engine every `interval_s`
    with request-window and scraped-engine numbers, plus a gauge refresh.

    The reference ships the same capability as a thread
    (src/vllm_router/stats/log_stats.py — whose spawn-site bug meant it
    died on first use, SURVEY.md §2.1); here it is an asyncio task owned
    by the app lifecycle.
    """

    def __init__(self, get_endpoints, monitor: "RequestStatsMonitor",
                 scraper: "EngineStatsScraper", metrics=None,
                 interval_s: float = 30.0, health_tracker=None):
        self.get_endpoints = get_endpoints
        self.monitor = monitor
        self.scraper = scraper
        self.metrics = metrics
        self.interval_s = interval_s
        self.health_tracker = health_tracker
        self._task = None

    async def start(self) -> None:
        import asyncio
        self._task = asyncio.create_task(self._loop(), name="stat-logger")

    async def close(self) -> None:
        import asyncio
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        import asyncio
        while True:
            await asyncio.sleep(self.interval_s)
            try:
                self.log_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("stat logging failed")

    def log_once(self) -> None:
        request_stats = self.monitor.get()
        engine_stats = self.scraper.get()
        urls = sorted({ep.url for ep in self.get_endpoints()}
                      | set(request_stats) | set(engine_stats))
        if not urls:
            logger.info("stats: no engines")
        for url in urls:
            rs = request_stats.get(url)
            es = engine_stats.get(url)
            parts = [f"engine {url}"]
            if rs is not None:
                parts.append(
                    f"qps={rs.qps:.2f} ttft={rs.ttft:.3f}s "
                    f"itl={rs.itl:.4f}s latency={rs.latency:.3f}s "
                    f"in_prefill={rs.in_prefill} "
                    f"in_decoding={rs.in_decoding} "
                    f"finished={rs.finished}")
            if es is not None:
                parts.append(
                    f"running={es.num_running:.0f} "
                    f"waiting={es.num_waiting:.0f} "
                    f"kv_usage={es.kv_usage:.1%}")
                # compile_in_flight gates too: a cold engine stalled
                # on its FIRST build has zero mbu/live fraction — the
                # one moment this line exists to explain
                if es.mbu_perc or es.live_fraction \
                        or es.compile_in_flight or es.compiles_total:
                    parts.append(
                        f"mbu={es.mbu_perc:.2f}% "
                        f"live={es.live_fraction:.2f} "
                        f"compiling={es.compile_in_flight:.0f}")
            logger.info("stats: %s", " | ".join(parts))
        if self.metrics is not None:
            eps = list(self.get_endpoints())
            tracker = self.health_tracker
            healthy = len([ep for ep in eps if tracker is None
                           or tracker.is_routable(ep.url)])
            self.metrics.refresh(request_stats, healthy)
            if tracker is not None:
                self.metrics.refresh_resilience(tracker)
