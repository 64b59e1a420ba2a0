"""Hot-reload router configuration from a JSON file (operator contract).

Capability parity with reference src/vllm_router/dynamic_config.py
(DynamicRouterConfig :20-76 + 10s file-poll watcher :95-209): the C++
operator reconciles a StaticRoute CR into a ConfigMap mounted at
--dynamic-config-json; this watcher (an asyncio task) detects content
changes and swaps service discovery / routing policy in place. The
current config is surfaced in /health (parity with main_router.py:150-158).
"""

import asyncio
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

from production_stack_tpu_torch.router.routing import make_router
from production_stack_tpu_torch.router.service_discovery import (
    StaticServiceDiscovery)
from production_stack_tpu_torch.utils import init_logger, parse_comma_separated

logger = init_logger(__name__)


@dataclass
class DynamicRouterConfig:
    service_discovery: str = "static"
    routing_logic: str = "roundrobin"
    static_backends: List[str] = field(default_factory=list)
    static_models: List[str] = field(default_factory=list)
    session_key: str = "x-user-id"
    # disaggregated-prefill pool (router/disagg.py). Tri-state: None =
    # key absent from the config file, leave the running pool alone
    # (an autoscaler managing only the decode pool must not wipe the
    # prefill pool on every scale event); [] = explicitly disable
    # disaggregation; non-empty = swap the pool in place.
    prefill_backends: Optional[List[str]] = None
    prefill_models: Optional[List[str]] = None
    # named pools (router/pools.py). Same tri-state: None = key absent,
    # leave the running pools table alone (an autoscaler actuating one
    # pool writes only that pool's entry merged by its shared config
    # writer — but an operator pushing an unrelated key must not wipe
    # the table); {} = disable pooling (single-pool routing resumes
    # from static_backends); non-empty = diff-and-swap pool by pool,
    # preserving untouched pools' policy state.
    pools: Optional[dict] = None

    @staticmethod
    def from_json(data: dict) -> "DynamicRouterConfig":
        def listify(v):
            return parse_comma_separated(v) if isinstance(v, str) else (
                v or [])
        return DynamicRouterConfig(
            service_discovery=data.get("service_discovery", "static"),
            routing_logic=data.get("routing_logic", "roundrobin"),
            static_backends=listify(data.get("static_backends")),
            static_models=listify(data.get("static_models")),
            session_key=data.get("session_key", "x-user-id"),
            prefill_backends=(listify(data["prefill_backends"])
                              if "prefill_backends" in data else None),
            prefill_models=(listify(data["prefill_models"])
                            if "prefill_models" in data else None),
            pools=(dict(data["pools"] or {}) if "pools" in data
                   else None),
        )

    def to_json(self) -> dict:
        out = {
            "service_discovery": self.service_discovery,
            "routing_logic": self.routing_logic,
            "static_backends": self.static_backends,
            "static_models": self.static_models,
            "session_key": self.session_key,
        }
        # each key echoed only as provided: synthesizing prefill_models
        # [] next to non-empty backends would render a length-mismatched
        # document (which _apply_prefill_pool rejects) as if it were
        # the live config on /health
        if self.prefill_backends is not None:
            out["prefill_backends"] = self.prefill_backends
        if self.prefill_models is not None:
            out["prefill_models"] = self.prefill_models
        if self.pools is not None:
            out["pools"] = self.pools
        return out


class DynamicConfigWatcher:
    def __init__(self, app_state: dict, path: str, interval_s: float = 10.0):
        self.state = app_state
        self.path = path
        self.interval = interval_s
        self._last_content: Optional[str] = None
        self._task: Optional[asyncio.Task] = None
        self.current: Optional[DynamicRouterConfig] = None

    async def start(self) -> None:
        await self._check_once()   # apply initial config before serving
        self._task = asyncio.create_task(self._loop(), name="config-watch")

    async def close(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    def healthy(self) -> bool:
        return self._task is None or not self._task.done()

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval)
            try:
                await self._check_once()
            except Exception:
                logger.exception("dynamic config reload failed")

    async def _check_once(self) -> None:
        if not os.path.exists(self.path):
            return
        with open(self.path) as f:
            content = f.read()
        if content == self._last_content:
            return
        self._last_content = content
        cfg = DynamicRouterConfig.from_json(json.loads(content))
        await self._apply(cfg)

    async def _apply(self, cfg: DynamicRouterConfig) -> None:
        logger.info("applying dynamic config: %s", cfg.to_json())
        if cfg.service_discovery == "static" and cfg.static_backends:
            old = self.state.get("discovery")
            new = StaticServiceDiscovery(
                cfg.static_backends, cfg.static_models,
                health_tracker=self.state.get("health"))
            await new.start()
            self.state["discovery"] = new
            if old is not None:
                await old.close()
        # rebuild the router ONLY when its own fields changed: the
        # autoscaler rewrites this file on every scale event, and a
        # gratuitous rebuild would wipe the policy's learned state —
        # the prefix router's warm-endpoint ring, least-loaded's
        # slow-start ramps — exactly when the fleet is in motion
        old_router = self.state.get("router")
        unchanged = (
            old_router is not None
            and old_router.name == cfg.routing_logic
            and getattr(old_router, "session_key",
                        cfg.session_key) == cfg.session_key)
        if not unchanged:
            metrics = self.state.get("metrics")
            if metrics is not None and old_router is not None:
                # fold the outgoing router's routing counters into the
                # exposition before its totals vanish with it
                metrics.refresh_routing(old_router)
            self.state["router"] = make_router(
                cfg.routing_logic, cfg.session_key,
                **self.state.get("router_kwargs", {}))
            scraper = self.state.get("scraper")
            if scraper is not None and \
                    hasattr(self.state["router"], "attach_scraper"):
                self.state["router"].attach_scraper(scraper.get)
        await self._apply_pools(cfg)
        self._apply_prefill_pool(cfg)
        # decode-fleet membership may have changed above (static swap)
        # even when the prefill key was absent — the decode-only-
        # autoscaler case. Locality evidence for departed decode
        # engines must go either way: a later scale-up reusing the URL
        # starts a COLD process the ring would otherwise score warm.
        disagg = self.state.get("disagg")
        if disagg is not None and disagg.selector is not None:
            discovery = self.state.get("discovery")
            if discovery is not None:
                disagg.selector.evict_except(
                    ep.url for ep in discovery.all_endpoints())
        self.current = cfg

    async def _apply_pools(self, cfg: DynamicRouterConfig) -> None:
        """Create/swap/disable the named-pools table (router/pools.py).
        The running PoolManager is mutated IN PLACE pool by pool, so a
        swap that touches pool A never resets pool B's router-policy
        state, and the manager's routed/unknown counters survive every
        swap (the r11/r12 state-survival contract at the pool layer).
        When pools are active the manager IS the service discovery —
        every fleet-wide consumer reads the union of pools."""
        if cfg.pools is None:
            return                     # key absent: leave pools alone
        manager = self.state.get("pools")
        metrics = self.state.get("metrics")
        if not cfg.pools:
            # {} -> disable pooling. Discovery falls back to whatever
            # the static swap above installed (an operator disabling
            # pools ships static_backends in the same document); with
            # no static list the fleet is legitimately empty.
            if manager is not None and manager.active:
                if metrics is not None:
                    metrics.refresh_pools(manager)
                manager.apply({})
                logger.info("dynamic config: pools disabled")
                if self.state.get("discovery") is manager and \
                        not cfg.static_backends:
                    logger.warning(
                        "dynamic config: pools disabled with no "
                        "static_backends — zero routable endpoints")
            return
        from production_stack_tpu_torch.router.pools import (PoolManager,
                                                       parse_pool_spec)
        try:
            spec = parse_pool_spec(cfg.pools)
        except (ValueError, TypeError) as e:
            # a malformed pools document must not kill the watcher or
            # leave the apply half-done: keep the running table
            logger.error("dynamic config: bad pools spec (%s) — pools "
                         "left unchanged", e)
            return
        if manager is None:
            manager = PoolManager(self.state.get("router_kwargs"))
            scraper = self.state.get("scraper")
            if scraper is not None:
                manager.attach_scraper(scraper.get)
            self.state["pools"] = manager
        elif metrics is not None:
            # fold counters before any pool drops out of the table
            metrics.refresh_pools(manager)
        manager.apply(spec)
        old = self.state.get("discovery")
        if old is not manager:
            self.state["discovery"] = manager
            if old is not None:
                await old.close()

    def _apply_prefill_pool(self, cfg: DynamicRouterConfig) -> None:
        """Swap/create/disable the disagg prefill pool. The running
        orchestrator is mutated IN PLACE (set_pool) so breaker and
        rotation state survive for pool members present on both sides
        of the swap — replacing the object would amnesty a sick prefill
        backend exactly when the fleet is in motion (the bug class r11
        fixed for prefix rings)."""
        if cfg.prefill_backends is None:
            return                    # key absent: leave the pool alone
        disagg = self.state.get("disagg")
        if not cfg.prefill_backends:
            if disagg is not None:
                # fold the outgoing orchestrator's counters into the
                # exposition before its totals vanish with it, then
                # reset the delta baseline: a later enable starts a
                # fresh orchestrator from zero
                metrics = self.state.get("metrics")
                if metrics is not None:
                    metrics.refresh_disagg(disagg)
                    metrics.reset_disagg_baseline()
                del self.state["disagg"]
                logger.info("dynamic config: disaggregated prefill "
                            "disabled")
            return
        models = cfg.prefill_models or []
        if len(models) != len(cfg.prefill_backends):
            # an operator (or an actuator extra_config) shipping a
            # mismatched pool must not kill the watcher — or router
            # startup, where _check_once runs unwrapped — nor leave
            # the apply half-done: log loudly, keep the running pool
            logger.error(
                "dynamic config: %d prefill_backends but %d "
                "prefill_models — prefill pool left unchanged",
                len(cfg.prefill_backends), len(models))
            return
        if disagg is None:
            from production_stack_tpu_torch.router.disagg import (
                build_orchestrator)
            self.state["disagg"] = build_orchestrator(
                cfg.prefill_backends, models,
                self.state.get("disagg_kwargs"))
            logger.info("dynamic config: disaggregated prefill enabled "
                        "(%d backends)", len(cfg.prefill_backends))
        else:
            # (_apply evicts departed decode engines from the selector
            # locality ring after this, for every config shape)
            disagg.set_pool(cfg.prefill_backends, models)
