"""Shared engine load-signal poller: one scrape per engine, any consumer.

Every engine replica answers ``GET /load`` with a cheap lock-free JSON
report (engine/engine.py ``load_report``): queue depth, running
sequences, advertised admission capacity, KV pressure, and the
service-EWMA queue-delay estimate. Two subsystems consume those
numbers:

- the **router**, which derives its per-endpoint concurrency cap from
  advertised capacity and feeds the stats log (router/stats.py
  ``EngineStatsScraper``), and
- the **autoscaler**, whose scaling policy reads queue delay and
  utilization (autoscaler/collector.py).

This module is the one poller both are built on, so a process hosting
several consumers still issues exactly one ``/load`` request per engine
per interval instead of one per consumer. ``LoadPoller`` subclasses
override ``_build`` to store their own per-engine record type without
re-implementing the polling loop, the concurrency fan-out, or the
stale-engine eviction.

Engines that do not serve ``/load`` (a stock vLLM pod behind the same
router) are handled by the subclass fallback hook ``_fetch_fallback``
— the router's scraper uses it to fall back to parsing ``/metrics``.
"""

import asyncio
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Optional, Tuple

import aiohttp

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


@dataclass
class EngineLoad:
    """Parsed ``/load`` report for one engine replica."""

    queue_depth: float = 0.0       # WAITING sequences
    running: float = 0.0           # RUNNING + prefilling sequences
    # total in-flight the engine accepts before shedding; None =
    # unbounded admission (no --max-waiting-seqs) — consumers must not
    # coerce this to 0, which /metrics uses as its own sentinel
    capacity: Optional[float] = None
    max_num_seqs: float = 0.0
    est_queue_delay_ms: float = 0.0
    kv_usage: float = 0.0
    free_kv_blocks: float = 0.0
    # KV-tier sharing signals (engines running --kv-transfer-config
    # publish a "kv_cache" block in /load; zeros otherwise): the
    # cache-aware router reads the hit rate, the kvshare rig reads the
    # token counters
    kv_hit_rate: float = 0.0
    kv_query_tokens: float = 0.0
    kv_hit_tokens: float = 0.0
    kv_foreign_hit_tokens: float = 0.0
    # disagg role advertised in the kv_cache block ("kv_producer",
    # "kv_consumer", "kv_both"; "" = no KV tiering / unknown)
    kv_role: str = ""
    # engine-efficiency signals (/load "perf" block, engine/
    # efficiency.py; zeros for engines without the accounting layer):
    # recent effective-bandwidth/MBU rates, the decode live fraction,
    # cumulative real/pad/dead token-step totals, and compile
    # counters — compile_in_flight > 0 means the engine loop is
    # blocked on an XLA build RIGHT NOW (the /load path answers
    # through it)
    mbu_perc: float = 0.0
    effective_bytes_per_s: float = 0.0
    live_fraction: float = 0.0
    decode_tokens_per_s: float = 0.0
    token_steps_real: float = 0.0
    token_steps_pad: float = 0.0
    token_steps_dead: float = 0.0
    compiles_total: float = 0.0
    compile_in_flight: float = 0.0
    # the engine's live model catalog (/load "models": base model
    # first, then every currently-loaded LoRA adapter; () for engines
    # predating the field): the router's /v1/models aggregation and
    # pool resolution read it, so a runtime adapter load propagates
    # fleet-wide one scrape later without a config push
    models: Tuple[str, ...] = ()
    scraped_at: float = field(default_factory=time.time)

    @property
    def in_flight(self) -> float:
        """Everything admitted and not yet finished: what counts
        against advertised capacity."""
        return self.queue_depth + self.running

    @property
    def utilization(self) -> Optional[float]:
        """in_flight / capacity, or None when admission is unbounded
        (nothing to normalise against)."""
        if self.capacity is None or self.capacity <= 0:
            return None
        return self.in_flight / self.capacity


def parse_load_report(data: dict) -> EngineLoad:
    def pnum(src: dict, key: str) -> float:
        v = src.get(key)
        return 0.0 if v is None else float(v)

    cap = data.get("capacity")
    kv = data.get("kv_cache") or {}
    perf = data.get("perf") or {}
    steps = perf.get("token_steps") or {}

    return EngineLoad(
        queue_depth=pnum(data, "queue_depth"),
        running=pnum(data, "running"),
        capacity=None if cap is None else float(cap),
        max_num_seqs=pnum(data, "max_num_seqs"),
        est_queue_delay_ms=pnum(data, "est_queue_delay_ms"),
        kv_usage=pnum(data, "kv_usage"),
        free_kv_blocks=pnum(data, "free_kv_blocks"),
        kv_hit_rate=pnum(kv, "hit_rate"),
        kv_query_tokens=pnum(kv, "query_tokens"),
        kv_hit_tokens=pnum(kv, "hit_tokens"),
        kv_foreign_hit_tokens=pnum(kv, "foreign_hit_tokens"),
        kv_role=str(kv.get("role") or ""),
        mbu_perc=pnum(perf, "mbu_perc"),
        effective_bytes_per_s=pnum(perf, "effective_bytes_per_s"),
        live_fraction=pnum(perf, "live_fraction"),
        decode_tokens_per_s=pnum(perf, "decode_tokens_per_s"),
        token_steps_real=pnum(steps, "real"),
        token_steps_pad=pnum(steps, "pad"),
        token_steps_dead=pnum(steps, "dead"),
        compiles_total=pnum(perf, "compiles_total"),
        compile_in_flight=pnum(perf, "compile_in_flight"),
        models=tuple(str(m) for m in data.get("models") or ()),
    )


def coerce_load(rec) -> EngineLoad:
    """Adapt any per-engine record to an ``EngineLoad``.

    Lets the autoscaler's collector read a poller that stores a
    different record type — specifically the router's
    ``EngineStatsScraper`` (``EngineStats``: num_running/num_waiting,
    capacity 0.0 as the unbounded sentinel) — so an autoscaler embedded
    next to a router reuses the router's scrape verbatim.
    """
    if isinstance(rec, EngineLoad):
        return rec
    cap = getattr(rec, "capacity", 0.0) or 0.0
    return EngineLoad(
        queue_depth=getattr(rec, "num_waiting", 0.0),
        running=getattr(rec, "num_running", 0.0),
        capacity=None if cap <= 0 else cap,
        est_queue_delay_ms=getattr(rec, "est_queue_delay_ms", 0.0),
        kv_usage=getattr(rec, "kv_usage", 0.0),
        scraped_at=getattr(rec, "scraped_at", time.time()),
    )


class LoadPoller:
    """Polls each engine's ``/load`` on an interval (asyncio task).

    ``get_urls`` is called per pass so discovery swaps are followed;
    engines that stop answering drop out of ``get()`` (consumers treat
    absence as "no fresh signal"). ``poll_now()`` runs one immediate
    concurrent pass — the autoscaler calls it at each control tick so
    decisions act on current load, not an interval-old snapshot.
    """

    def __init__(self, get_urls: Callable[[], Iterable[str]],
                 interval_s: float = 10.0,
                 timeout_s: float = 5.0):
        self._get_urls = get_urls
        self.interval = interval_s
        self._timeout = aiohttp.ClientTimeout(total=timeout_s)
        self._stats: Dict[str, object] = {}
        self._task: Optional[asyncio.Task] = None
        self._session: Optional[aiohttp.ClientSession] = None
        self._owns_session = False

    # -- record-building hooks (subclass surface) -----------------------

    def _build(self, data: dict) -> object:
        return parse_load_report(data)

    async def _fetch_fallback(self, url: str) -> Optional[object]:
        """Called when ``GET {url}/load`` answers 404 (an engine that
        predates /load or a foreign backend). Default: no signal."""
        return None

    # -- lifecycle ------------------------------------------------------

    async def start(self,
                    session: Optional[aiohttp.ClientSession] = None
                    ) -> None:
        if session is None:
            session = aiohttp.ClientSession()
            self._owns_session = True
        self._session = session
        self._task = asyncio.create_task(self._loop(), name="load-poller")

    def attach(self, session: aiohttp.ClientSession) -> None:
        """On-demand mode: no background interval loop — the consumer
        drives every scrape through ``poll_now()`` (the autoscaler's
        collector does this so each engine is scraped exactly once per
        control tick, never once per tick PLUS once per interval)."""
        self._session = session

    async def close(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._session and self._owns_session:
            await self._session.close()
        self._session = None

    def healthy(self) -> bool:
        return self._task is not None and not self._task.done()

    # -- reads ----------------------------------------------------------

    def get(self) -> Dict[str, object]:
        return dict(self._stats)

    # -- polling --------------------------------------------------------

    async def _loop(self) -> None:
        while True:
            await self.poll_now()
            await asyncio.sleep(self.interval)

    async def _scrape_one(self, url: str) -> None:
        try:
            async with self._session.get(f"{url}/load",
                                         timeout=self._timeout) as r:
                if r.status == 200:
                    self._stats[url] = self._build(await r.json())
                    return
                if r.status == 404:
                    rec = await self._fetch_fallback(url)
                    if rec is not None:
                        self._stats[url] = rec
                        return
            self._stats.pop(url, None)
        except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
            self._stats.pop(url, None)   # stale engine drops out

    async def poll_now(self) -> Dict[str, object]:
        """One concurrent scrape pass over the current URL set."""
        urls = {u.rstrip("/") for u in self._get_urls()}
        # concurrent: one slow/unreachable engine must not stall the rest
        await asyncio.gather(*(self._scrape_one(u) for u in urls))
        for gone in set(self._stats) - urls:
            del self._stats[gone]
        return self.get()
