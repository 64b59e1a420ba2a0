"""Named pools: model -> endpoints -> routing policy (heterogeneous fleet).

One router fronting a heterogeneous fleet — different base models,
different LoRA adapter sets, prefill vs decode roles — needs a layer
between "the request named model X" and "run routing policy P over
endpoint set E". That layer is the pool:

- A **pool spec** maps a pool name to its backends, the models every
  backend in the pool serves (first = base, rest = adapters/aliases),
  and its routing policy::

      {"pool-a": {"backends": ["http://10.0.0.3:8100"],
                  "models": ["llama-3-8b", "sql-adapter"],
                  "routing_logic": "prefix",
                  "session_key": "x-user-id"},
       "pool-b": {"backends": [...], "models": ["qwen-7b"]}}

  Delivered at startup (``--pools``, inline JSON or @file) or hot via
  the dynamic-config ``pools`` key (tri-state like ``prefill_backends``:
  absent = leave the running pools alone, ``{}`` = disable pooling,
  non-empty = swap in place).

- **Model resolution** happens once per request in the proxy: the
  body's ``model`` picks the pool; its endpoints and ITS router
  instance serve the request. A model no pool serves is a structured
  404 (``model_not_found``) — distinct from 400 (malformed) and from
  the legacy single-pool "no backend serves model" 400, because with
  pools active the router authoritatively knows the fleet's model
  catalog. Adapters loaded at runtime (``/admin/lora/load``) become
  resolvable through the scraped ``/load`` ``models`` list without a
  config push — resolution falls back to the scrape on an index miss.

- **Per-pool policy state survives swaps of other pools** (the r11/r12
  state-survival contract at the pool layer): ``apply()`` diffs specs
  pool-by-pool and keeps the existing ``Pool`` object — its router
  instance, with the prefix ring / session ring / slow-start state
  inside — whenever the pool's routing fields are unchanged. Breaker
  and drain state live in the ONE HealthTracker keyed by URL, so they
  were never per-pool objects to lose; request-stats windows key by
  URL likewise. Only the pool you actually reconfigure pays.

PoolManager IS a ServiceDiscovery (duck-typed): when pools are active
it replaces ``state["discovery"]``, so every fleet-wide consumer —
the stats scraper, /health endpoint counts, /metrics eviction sweeps,
the proxy's live-set re-read — sees the union of all pools without
learning a second membership API.

Closed loop: ``python -m production_stack_tpu_torch.loadgen multitenant``
(TENANT_r21.json; docs/multitenancy.md).
"""

import collections
import json
from typing import Dict, List, Optional

from production_stack_tpu_torch.router.routing import make_router
from production_stack_tpu_torch.router.service_discovery import (EndpointInfo,
                                                           ServiceDiscovery)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


def parse_pool_spec(raw) -> Dict[str, dict]:
    """Normalize a pools document: ``{name: {backends, models,
    routing_logic?, session_key?}}``. Accepts the JSON text form (CLI)
    or an already-parsed dict (dynamic config). Raises ValueError on a
    malformed spec — callers at startup fail fast, the config watcher
    logs and keeps the running pools."""
    if isinstance(raw, str):
        raw = json.loads(raw)
    if not isinstance(raw, dict):
        raise ValueError(f"pools spec must be an object, got "
                         f"{type(raw).__name__}")
    out: Dict[str, dict] = {}
    for name, spec in raw.items():
        if not isinstance(spec, dict):
            raise ValueError(f"pool {name!r}: spec must be an object")
        backends = [u.rstrip("/") for u in spec.get("backends") or []]
        models = list(spec.get("models") or [])
        if not backends:
            raise ValueError(f"pool {name!r}: no backends")
        if not models:
            raise ValueError(f"pool {name!r}: no models")
        out[name] = {
            "backends": backends,
            "models": models,
            "routing_logic": spec.get("routing_logic", "roundrobin"),
            "session_key": spec.get("session_key", "x-user-id"),
        }
    return out


class Pool:
    """One named pool: endpoints + its own routing-policy instance."""

    __slots__ = ("name", "backends", "models", "routing_logic",
                 "session_key", "router", "endpoints")

    def __init__(self, name: str, spec: dict, router):
        self.name = name
        self.router = router
        self.rebuild(spec)

    def rebuild(self, spec: dict) -> None:
        self.backends = list(spec["backends"])
        self.models = list(spec["models"])
        self.routing_logic = spec["routing_logic"]
        self.session_key = spec["session_key"]
        base = self.models[0]
        aliases = self.models[1:]
        self.endpoints = [
            EndpointInfo(url=u, model=base, model_aliases=list(aliases),
                         pool=self.name)
            for u in self.backends]

    def routing_unchanged(self, spec: dict) -> bool:
        """True when the new spec keeps this pool's policy fields —
        the condition under which the router INSTANCE (and its learned
        ring/ramp state) must survive the swap."""
        return (self.routing_logic == spec["routing_logic"]
                and self.session_key == spec["session_key"])


class PoolManager(ServiceDiscovery):
    """The pools table + model->pool resolution + fleet-union discovery.

    Counters (``routed``/``unknown_models``) are plain ints keyed by
    pool NAME in the manager — not on Pool objects — so a pool swap
    never resets them (they delta-sync into ``tpu:router_pool_*`` at
    scrape, the r12 convention)."""

    def __init__(self, router_kwargs: Optional[dict] = None):
        self._pools: Dict[str, Pool] = {}
        self._index: Dict[str, Pool] = {}
        self._router_kwargs = dict(router_kwargs or {})
        self._scraper_get = None
        # telemetry: requests routed per pool, unknown-model 404s,
        # pool swap generations (survive Pool object replacement)
        self.routed: Dict[str, int] = collections.defaultdict(int)
        self.unknown_models = 0
        self.swaps: Dict[str, int] = collections.defaultdict(int)

    # -- discovery interface (the fleet union) --------------------------

    def get_endpoints(self) -> List[EndpointInfo]:
        return [ep for p in self._pools.values() for ep in p.endpoints]

    def all_endpoints(self) -> List[EndpointInfo]:
        return self.get_endpoints()

    async def start(self) -> None:
        pass

    async def close(self) -> None:
        pass

    # -- lifecycle -------------------------------------------------------

    def attach_scraper(self, get_stats) -> None:
        """Scrape fallback for resolve(): adapters loaded at runtime
        surface in each engine's /load ``models`` list one scrape
        interval later, with no config push."""
        self._scraper_get = get_stats

    def apply(self, spec: Dict[str, dict]) -> List[str]:
        """Diff-and-swap the pools table in place; returns the names of
        pools that were dropped (callers fold their metrics first if
        they need to — the manager's own counters persist regardless).

        Per pool: unchanged routing fields keep the existing Pool and
        router instance (state survival); changed routing fields build
        a fresh router; new pools are created; absent pools dropped."""
        dropped = [n for n in self._pools if n not in spec]
        for name in dropped:
            logger.info("pool %s dropped", name)
            del self._pools[name]
        for name, pspec in spec.items():
            pool = self._pools.get(name)
            if pool is None:
                router = self._make_router(pspec)
                self._pools[name] = Pool(name, pspec, router)
                self.swaps[name] += 1
                logger.info("pool %s created: %d backends, models %s, "
                            "routing %s", name, len(pspec["backends"]),
                            pspec["models"], pspec["routing_logic"])
            elif pool.routing_unchanged(pspec):
                # membership/model change only: the router instance —
                # and its prefix/session ring, slow-start ramps — is
                # kept; consistent hashing absorbs the member diff
                if (pool.backends != pspec["backends"]
                        or pool.models != pspec["models"]):
                    pool.rebuild(pspec)
                    self.swaps[name] += 1
                    logger.info("pool %s membership swapped in place "
                                "(%d backends)", name,
                                len(pspec["backends"]))
            else:
                pool.router = self._make_router(pspec)
                pool.rebuild(pspec)
                self.swaps[name] += 1
                logger.info("pool %s routing changed -> %s (fresh "
                            "policy state)", name, pspec["routing_logic"])
        self._index = {m: p for p in self._pools.values()
                       for m in p.models}
        return dropped

    def _make_router(self, pspec: dict):
        router = make_router(pspec["routing_logic"], pspec["session_key"],
                             **self._router_kwargs)
        if self._scraper_get is not None and \
                hasattr(router, "attach_scraper"):
            router.attach_scraper(self._scraper_get)
        return router

    # -- request path ----------------------------------------------------

    @property
    def active(self) -> bool:
        return bool(self._pools)

    def resolve(self, model: str) -> Optional[Pool]:
        """Model name -> pool, or None (the proxy answers 404).
        Static index first (the hot path: one dict get), then endpoint
        aliases (probe-promoted), then the scraped /load ``models``
        lists — the path a just-loaded adapter takes until the next
        config push."""
        pool = self._index.get(model)
        if pool is not None:
            return pool
        for p in self._pools.values():
            for ep in p.endpoints:
                if ep.serves(model):
                    return p
        if self._scraper_get is not None:
            by_url = {ep.url: p for p in self._pools.values()
                      for ep in p.endpoints}
            for url, es in self._scraper_get().items():
                p = by_url.get(url)
                if p is not None and \
                        model in getattr(es, "served_models", ()):
                    return p
        return None

    def note_routed(self, pool_name: str) -> None:
        self.routed[pool_name] += 1

    def note_unknown_model(self) -> None:
        self.unknown_models += 1

    # -- introspection ---------------------------------------------------

    def served_models(self) -> List[str]:
        """Every model the pools table names, pool order preserved."""
        seen = []
        for p in self._pools.values():
            for m in p.models:
                if m not in seen:
                    seen.append(m)
        return seen

    def snapshot(self) -> dict:
        return {name: {
            "backends": list(p.backends),
            "models": list(p.models),
            "routing_logic": p.routing_logic,
            "routed": self.routed.get(name, 0),
            "swaps": self.swaps.get(name, 0),
        } for name, p in self._pools.items()}
