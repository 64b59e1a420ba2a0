"""Router application: endpoint surface + wiring + CLI.

Endpoint parity with reference src/vllm_router/routers/main_router.py:
42-160 — /v1/chat/completions, /v1/completions, /v1/embeddings,
/v1/rerank, /v1/score (proxied); /v1/models (aggregated, deduped);
/health (discovery + scraper + config watcher liveness + current dynamic
config); /metrics; /version. Files and batches endpoints live in
files_api.py / batches_api.py and are mounted here.

Everything is one aiohttp Application; background activities (K8s watch,
stats scraper, config watcher) are asyncio tasks started on app startup
and cancelled on cleanup.
"""

import argparse
import asyncio
import signal
from typing import Optional

import aiohttp
from aiohttp import web

from production_stack_tpu_torch import protocol as proto
from production_stack_tpu_torch.router.dynamic_config import DynamicConfigWatcher
from production_stack_tpu_torch.router.feature_gates import FeatureGates
from production_stack_tpu_torch.router.metrics import RouterMetrics
from production_stack_tpu_torch.router.pools import PoolManager, parse_pool_spec
from production_stack_tpu_torch.router.proxy import route_general_request
from production_stack_tpu_torch.router.resilience import (CLOSED,
                                                    HealthTracker,
                                                    RetryBudget,
                                                    wait_for_drain)
from production_stack_tpu_torch.router.qos import QosPolicy
from production_stack_tpu_torch.router.rewriter import make_rewriter
from production_stack_tpu_torch.router.routing import make_router
from production_stack_tpu_torch.router.shared_state import (RouterPeers,
                                                      derive_router_id,
                                                      peers_payload)
from production_stack_tpu_torch.router.service_discovery import (
    K8sServiceDiscovery, StaticServiceDiscovery, engine_auth_headers)
from production_stack_tpu_torch.router.stats import (EngineStatsScraper,
                                               RequestStatsMonitor)
from production_stack_tpu_torch.slo import (SLOConfig, SLOEngine, SLOTask,
                                      default_config)
from production_stack_tpu_torch.tracing import TraceRecorder, debug_traces_handler
from production_stack_tpu_torch.utils import (init_logger, parse_comma_separated,
                                        parse_static_aliases,
                                        parse_static_urls, set_ulimit)
from production_stack_tpu_torch.version import __version__

logger = init_logger(__name__)

PROXIED_PATHS = ["/v1/chat/completions", "/v1/completions", "/v1/embeddings",
                 "/v1/rerank", "/v2/rerank", "/v1/score"]


# ---------------------------------------------------------------- handlers

def _make_proxy_handler(path: str):
    async def handler(request: web.Request) -> web.StreamResponse:
        return await route_general_request(request, path)
    return handler


async def list_models(request: web.Request) -> web.Response:
    state = request.app["state"]
    cards = {}
    for ep in state["discovery"].get_endpoints():
        for name in [ep.model] + ep.model_aliases:
            if name not in cards:
                cards[name] = proto.ModelCard(id=name)
    # the configured fleet is the floor, not the catalog: adapters
    # loaded at runtime (/admin/lora/load) surface in each engine's
    # scraped /load ``models`` list one scrape interval later — merge
    # them so /v1/models reports what the fleet ACTUALLY serves
    scraper = state.get("scraper")
    if scraper is not None:
        for es in scraper.get().values():
            for name in getattr(es, "served_models", ()):
                if name not in cards:
                    cards[name] = proto.ModelCard(id=name)
    return web.json_response(
        proto.ModelList(data=list(cards.values())).model_dump())


async def health(request: web.Request) -> web.Response:
    state = request.app["state"]
    problems = []
    if not state["discovery"].get_endpoints():
        problems.append("no routable engine endpoints")
    if not state["discovery"].healthy():
        problems.append("service discovery task dead")
    if state.get("scraper") and not state["scraper"].healthy():
        problems.append("engine stats scraper dead")
    watcher = state.get("config_watcher")
    if watcher and not watcher.healthy():
        problems.append("dynamic config watcher dead")
    tracker = state.get("health")
    if tracker and not tracker.healthy():
        problems.append("health re-probe task dead")
    slo_task = state.get("slo_task")
    if slo_task and not slo_task.healthy():
        problems.append("SLO evaluation task dead")
    peers = state.get("peers")
    if peers is not None and not peers.healthy():
        problems.append("peer gossip task dead")
    endpoints = state["discovery"].get_endpoints()
    body = {
        "status": "ok" if not problems else "unhealthy",
        "problems": problems,
        "router_id": state["router_id"],
        "endpoints": len(endpoints),
        "healthy_endpoints": len([ep for ep in endpoints
                                  if tracker is None
                                  or tracker.is_routable(ep.url)]),
        "breakers": tracker.snapshot() if tracker else {},
        "sheds": dict(state.get("shed_counts") or {}),
        "draining": state.get("draining_listener", False),
        "dynamic_config": watcher.current.to_json()
        if watcher and watcher.current else None,
    }
    disagg = state.get("disagg")
    if disagg is not None:
        body["prefill_pool"] = disagg.pool_snapshot()
    pools = state.get("pools")
    if pools is not None and pools.active:
        body["pools"] = pools.snapshot()
    if peers is not None:
        body["peers"] = peers.snapshot()
    if state.get("qos") is not None:
        body["qos"] = state["qos"].snapshot()
    # firing burn-rate alerts ride on /health so a probe (or a human
    # with curl) sees SLO burn without knowing about /alerts — but
    # they do NOT flip status: a burning SLO is the fleet's problem
    # to diagnose (docs/runbooks.md), not this process being sick
    slo = state.get("slo")
    if slo is not None:
        # probes arrive faster than alert states can change; serve the
        # eval task's result when it is under half an interval old
        slo.evaluate(max_age_s=0.5)
        body["firing_alerts"] = slo.firing()
    return web.json_response(body, status=200 if not problems else 503)


async def alerts(request: web.Request) -> web.Response:
    """GET /alerts: the SLO engine's full state — per-SLO good/bad
    counts and burn rates for every window, plus the alert state
    machine (pending/firing/resolved, fire counts, runbook anchors).
    The read evaluates first, so a poll always sees current states."""
    slo = request.app["state"].get("slo")
    if slo is None:
        return web.json_response(
            {"enabled": False, "slos": [], "alerts": [], "firing": []})
    return web.json_response({"enabled": True, **slo.snapshot()})


async def admin_drain(request: web.Request) -> web.Response:
    """Start/stop draining one engine endpoint: no new admissions while
    in-flight requests finish on their existing proxied connections.
    Body: {"url": "http://engine:8100", "drain": true|false}."""
    state = request.app["state"]
    tracker = state["health"]
    try:
        body = await request.json()
        url = body["url"].rstrip("/")
        drain = bool(body.get("drain", True))
    except (ValueError, KeyError, AttributeError, TypeError):
        return web.json_response(
            {"error": {"message": "body must be JSON with a 'url' "
                                  "field (and optional bool 'drain')",
                       "type": "invalid_request_error"}}, status=400)
    if drain:
        # a typo'd URL would be accepted, matched against nothing, and
        # silently drain nobody — reject unknown endpoints instead
        # (end_drain stays permissive so stale flags can be cleared)
        known = {ep.url for ep in state["discovery"].all_endpoints()}
        if url not in known:
            return web.json_response(
                {"error": {"message": f"unknown endpoint {url!r}; "
                                      f"known: {sorted(known)}",
                           "type": "invalid_request_error"}},
                status=404)
        tracker.start_drain(url)
    else:
        tracker.end_drain(url)
    return web.json_response({"draining": tracker.draining()})


async def admin_breaker(request: web.Request) -> web.Response:
    """Administratively reset one endpoint's breaker to CLOSED (clears
    consecutive-failure and windowed-rate state). The remediator calls
    this after restarting a drained engine so routing resumes without
    waiting out the open-state cooldown.
    Body: {"url": "http://engine:8100"} (optional "action": "reset")."""
    state = request.app["state"]
    tracker = state["health"]
    try:
        body = await request.json()
        url = body["url"].rstrip("/")
        action = body.get("action", "reset")
    except (ValueError, KeyError, AttributeError, TypeError):
        return web.json_response(
            {"error": {"message": "body must be JSON with a 'url' "
                                  "field",
                       "type": "invalid_request_error"}}, status=400)
    if action != "reset":
        return web.json_response(
            {"error": {"message": f"unknown action {action!r}; only "
                                  f"'reset' is supported",
                       "type": "invalid_request_error"}}, status=400)
    tracker.reset(url)
    return web.json_response({"url": url,
                              "state": tracker.state_of(url)})


async def admin_kvplane_rehome(request: web.Request) -> web.Response:
    """kvplane migration hand-off: rewrite decode-locality evidence
    after KV chunks moved replica-to-replica, so transfer-cost scoring
    follows the bytes instead of steering migrated prefixes back at
    the replica that shed them. Body: {"from": url, "to": url,
    "digests": ["<hex>", ...]} — digests optional (omit to rehome every
    entry naming "from")."""
    state = request.app["state"]
    try:
        body = await request.json()
        from_url = body["from"].rstrip("/")
        to_url = body["to"].rstrip("/")
    except (ValueError, KeyError, AttributeError, TypeError):
        return web.json_response(
            {"error": {"message": "body must be JSON with 'from' and "
                                  "'to' URL fields (and optional "
                                  "'digests' hex list)",
                       "type": "invalid_request_error"}}, status=400)
    digests = None
    if body.get("digests") is not None:
        try:
            digests = [bytes.fromhex(d) for d in body["digests"]]
        except (ValueError, TypeError):
            return web.json_response(
                {"error": {"message": "digests must be hex strings",
                           "type": "invalid_request_error"}},
                status=400)
    disagg = state.get("disagg")
    selector = disagg.selector if disagg is not None else None
    if selector is None:
        # nothing to rewrite — not an error: the planner runs the same
        # hand-off against routers with and without disagg scoring
        return web.json_response({"enabled": False, "rehomed": 0})
    # a typo'd destination would silently collect locality credit for
    # a replica that does not exist (admin_drain precedent)
    known = {ep.url for ep in state["discovery"].all_endpoints()}
    if to_url not in known:
        return web.json_response(
            {"error": {"message": f"unknown endpoint {to_url!r}; "
                                  f"known: {sorted(known)}",
                       "type": "invalid_request_error"}}, status=404)
    moved = selector.rehome(from_url, to_url, digests)
    return web.json_response({"enabled": True, "rehomed": moved})


async def version(request: web.Request) -> web.Response:
    return web.json_response({"version": __version__})


async def metrics(request: web.Request) -> web.Response:
    state = request.app["state"]
    endpoints = state["discovery"].get_endpoints()
    # evictions key off the CONFIGURED fleet: an endpoint temporarily
    # withheld from routing (probe-marked unroutable) must not lose its
    # windows/breaker state over a scrape
    configured = state["discovery"].all_endpoints()
    state["request_stats"].evict_except(ep.url for ep in configured)
    # per-endpoint phase-histogram series leave with the endpoint, like
    # every other per-endpoint family (r8 refresh_resilience precedent)
    state["metrics"].evict_phase_servers(ep.url for ep in configured)
    tracker = state.get("health")
    if tracker is not None:
        tracker.evict_except(ep.url for ep in configured)
        healthy = len([ep for ep in endpoints
                       if tracker.is_routable(ep.url)])
    else:
        healthy = len(endpoints)
    disagg = state.get("disagg")
    if disagg is not None and disagg.selector is not None:
        # discovery-driven decode churn (k8s) never passes through a
        # dynamic-config apply, so the scrape is the only hook where a
        # departed decode URL can lose its warm locality evidence — a
        # scale-up reusing the URL starts a COLD process the ring
        # would otherwise score at zero transfer cost. Breaker-open
        # counts as departed for the same reason: an in-place restart
        # on the same URL comes back with empty tiers (pessimistic
        # costs pay a refetch; optimistic phantom-zero costs misroute).
        # Draining keeps its evidence — the process, and its KV, lives.
        live = [ep.url for ep in configured]
        if tracker is not None:
            live = [u for u in live if tracker.state_of(u) == CLOSED]
        disagg.selector.evict_except(live)
    state["metrics"].refresh(state["request_stats"].get(), healthy)
    state["metrics"].refresh_overload(state["shed_counts"])
    if tracker is not None:
        state["metrics"].refresh_resilience(tracker)
    if state.get("semantic_cache") is not None:
        state["metrics"].refresh_semantic_cache(state["semantic_cache"])
    if state.get("pii_middleware") is not None:
        state["metrics"].refresh_pii(state["pii_middleware"])
    state["metrics"].refresh_routing(state["router"])
    if disagg is not None:
        state["metrics"].refresh_disagg(disagg)
    if state.get("slo") is not None:
        state["metrics"].refresh_slo(state["slo"])
    if state.get("peers") is not None:
        state["metrics"].refresh_peers(state["peers"])
    if state.get("qos") is not None:
        state["metrics"].refresh_qos(state["qos"])
    if state.get("pools") is not None:
        state["metrics"].refresh_pools(state["pools"])
    return web.Response(body=state["metrics"].render(),
                        content_type="text/plain")


async def peers_endpoint(request: web.Request) -> web.Response:
    """GET /peers: this router's shareable control-plane facts — the
    gossip wire format peer replicas poll (shared_state.RouterPeers).
    Cheap by construction: a dict walk over breaker/drain state, no
    window math."""
    state = request.app["state"]
    return web.json_response(
        peers_payload(state["router_id"], state["health"]))


# ---------------------------------------------------------------- wiring

def build_app(args: argparse.Namespace) -> web.Application:
    app = web.Application(client_max_size=64 * 1024 * 1024)
    state: dict = {
        # replica identity: reported on /health, stamped as
        # x-router-id on EVERY response (loadgen trace three-way joins
        # attribute chains per replica), and exchanged in peer gossip
        "router_id": args.router_id or derive_router_id(args.host,
                                                        args.port),
        "request_timeout": args.request_timeout,
        # hot-path statics, built once: the client timeout object and
        # the engine-auth header overlay (proxy._forward_headers) are
        # per-request allocations otherwise
        "client_timeout": aiohttp.ClientTimeout(
            total=args.request_timeout),
        "auth_overlay": engine_auth_headers(),
        # downstream deadline injected when the client sent none: the
        # engine may drop the request from its queue the moment the
        # router's own --request-timeout would have fired anyway
        # (proxy._forward_headers; engine/server.py DEADLINE_HEADER)
        "deadline_overlay": {
            "x-request-deadline-ms":
                str(int(args.request_timeout * 1000))},
        "metrics": RouterMetrics(),
        "request_stats": RequestStatsMonitor(
            horizon_s=args.request_stats_window,
            snapshot_ttl_s=args.request_stats_snapshot_ttl),
        "feature_gates": FeatureGates(args.feature_gates),
        "rewriter": make_rewriter("noop"),
        # resilience plane: per-endpoint breaker + global retry budget
        # + failover bound, consumed by proxy.route_general_request
        "health": HealthTracker(
            failure_threshold=args.breaker_threshold,
            cooldown_s=args.breaker_cooldown,
            failure_rate=args.breaker_failure_rate,
            probe_interval_s=args.breaker_probe_interval),
        "retry_budget": RetryBudget(ratio=args.retry_budget),
        "failover_attempts": max(1, args.failover_attempts),
        "inflight": 0,
        "draining_listener": False,
        # overload protection (proxy.route_general_request): the
        # router-wide admission gate, the per-endpoint concurrency cap
        # override, and the shed accounting /metrics exports
        "max_inflight": max(0, args.max_inflight),
        "endpoint_cap": args.endpoint_inflight_cap,
        "proxied_inflight": 0,
        "shed_counts": {"admission": 0, "endpoint_cap": 0},
        # request tracing (tracing.py): span ring + traceparent
        # propagation + x-trace-id stamping, consumed by
        # proxy.route_general_request; completed traces on
        # GET /debug/traces, phase histograms on /metrics
        "tracer": TraceRecorder("router",
                                ring_entries=args.trace_ring_entries,
                                sample_rate=args.trace_sample_rate),
    }
    app["state"] = state

    # QoS priority tiers (router/qos.py): graduated low-tier-first
    # admission on the r9 gates + per-tier deadline budgets + optional
    # background preemption; off unless --qos-tiers names a tier set
    if args.qos_tiers:
        state["qos"] = QosPolicy(
            args.qos_tiers, tier_rates=args.qos_tier_rates,
            preempt_from=args.qos_preempt_from,
            tenant_rate=args.qos_tenant_rate)
        state["qos_deadline_overlays"] = [
            {"x-request-deadline-ms":
             str(max(1000, int(args.request_timeout * 1000
                               * state["qos"].deadline_factor(t))))}
            for t in state["qos"].tiers]

    async def stamp_router_id(request, response):
        response.headers["x-router-id"] = state["router_id"]
    app.on_response_prepare.append(stamp_router_id)

    @web.middleware
    async def track_inflight(request, handler):
        # graceful listener drain counts every live handler, not just
        # proxied inference requests
        state["inflight"] += 1
        try:
            return await handler(request)
        finally:
            state["inflight"] -= 1
    app.middlewares.append(track_inflight)

    if args.service_discovery == "static":
        state["discovery"] = StaticServiceDiscovery(
            parse_static_urls(args.static_backends),
            parse_comma_separated(args.static_models),
            aliases=parse_static_aliases(args.static_model_aliases),
            probe=args.probe_backends,
            probe_failure_threshold=args.probe_failure_threshold,
            health_tracker=state["health"],
        )
    elif args.service_discovery == "k8s":
        state["discovery"] = K8sServiceDiscovery(
            namespace=args.k8s_namespace,
            label_selector=args.k8s_label_selector,
            engine_port=args.k8s_engine_port)
    else:
        raise ValueError(
            f"unknown service discovery {args.service_discovery!r}")

    if args.routing_logic == "prefix" and not state["feature_gates"].enabled(
            "KVAwareRouting"):
        raise ValueError("--routing-logic prefix requires the "
                         "KVAwareRouting feature gate (BETA, on by "
                         "default; it was explicitly disabled)")
    # kept in state so a dynamic-config router swap preserves the
    # CLI-configured prefix knobs (dynamic_config._apply)
    state["router_kwargs"] = {
        "prefix_chunk_chars": args.prefix_chunk_chars,
        "prefix_ring_entries": args.prefix_ring_entries,
        "prefix_cache_aware": not args.no_prefix_cache_aware,
    }
    state["router"] = make_router(args.routing_logic, args.session_key,
                                  **state["router_kwargs"])

    if state["feature_gates"].enabled("PIIDetection"):
        from production_stack_tpu_torch.router.pii import PIIConfig, PIIMiddleware
        state["pii_middleware"] = PIIMiddleware(PIIConfig.from_args(
            args.pii_analyzer, args.pii_action, args.pii_types,
            device=args.pii_device))
        app.middlewares.append(state["pii_middleware"].middleware)

    if state["feature_gates"].enabled("SemanticCache"):
        from production_stack_tpu_torch.router.semantic_cache import (
            SemanticCache, make_embedder)
        state["semantic_cache"] = SemanticCache(
            embedder=make_embedder(args.semantic_cache_embedder),
            threshold=args.semantic_cache_threshold,
            max_entries=args.semantic_cache_max_entries,
            persist_dir=args.semantic_cache_dir)
    from production_stack_tpu_torch.router.disagg import (make_orchestrator,
                                                    orchestrator_kwargs)
    # kept in state so a dynamic-config pool swap (or late creation)
    # preserves the CLI-configured disagg knobs (dynamic_config._apply);
    # built once and shared with the startup orchestrator
    state["disagg_kwargs"] = orchestrator_kwargs(args)
    disagg = make_orchestrator(args, kwargs=state["disagg_kwargs"])
    if disagg is not None:
        state["disagg"] = disagg
        logger.info("disaggregated prefill: %d prefill backends, "
                    "decode selection %s", len(disagg.endpoints),
                    "on" if disagg.selector is not None else "off")

    # SLO engine (slo.py): good/bad accounting fed by the proxy's
    # completion path + the /load scraper, burn-rate alert evaluation
    # on a short interval task, surfaced on GET /alerts, /health, and
    # /metrics. On by default — the firedrill overhead guard holds the
    # r7 band with accounting enabled — and declarative: --slo-config
    # swaps the objective set, --slo-window-scale shrinks every window
    # for drills
    if not args.no_slo:
        if args.slo_config:
            slo_cfg = SLOConfig.from_file(args.slo_config)
        else:
            slo_cfg = default_config(
                window_scale=args.slo_window_scale,
                min_events=args.slo_min_events)
        state["slo"] = SLOEngine(slo_cfg)

    # indirect through state so dynamic-config discovery swaps are followed
    state["scraper"] = EngineStatsScraper(
        lambda: state["discovery"].get_endpoints(),
        interval_s=args.engine_stats_interval)
    # cache-aware prefix routing breaks warm-endpoint ties on the
    # scraped per-engine tier hit rate (routing.PrefixAwareRouter)
    if hasattr(state["router"], "attach_scraper"):
        state["router"].attach_scraper(state["scraper"].get)

    # named pools (router/pools.py): model -> endpoints -> per-pool
    # routing policy. The manager replaces service discovery — every
    # fleet-wide consumer sees the union of pools. The startup static
    # discovery (never started) is simply discarded; dynamic config
    # can still swap/disable the table via its ``pools`` key.
    if args.pools:
        raw = args.pools
        if raw.startswith("@"):
            with open(raw[1:]) as f:
                raw = f.read()
        manager = PoolManager(state["router_kwargs"])
        manager.attach_scraper(state["scraper"].get)
        manager.apply(parse_pool_spec(raw))
        state["pools"] = manager
        state["discovery"] = manager

    if args.dynamic_config_json:
        state["config_watcher"] = DynamicConfigWatcher(
            state, args.dynamic_config_json,
            interval_s=args.dynamic_config_interval)

    # multi-router shared state (router/shared_state.py): gossip
    # breaker/drain transitions with the named peer replicas and split
    # the fleet-wide per-endpoint caps across live routers.
    # --no-shared-state keeps the flags parsed but the plane dark —
    # the multirouter rig's anti-vacuity lever.
    if args.peer_routers and not args.no_shared_state:
        state["peers"] = RouterPeers(
            state["router_id"],
            parse_comma_separated(args.peer_routers),
            state["health"],
            known_urls=lambda: [ep.url for ep in
                                state["discovery"].all_endpoints()],
            interval_s=args.peer_gossip_interval,
            stale_after_s=args.peer_stale_after)

    for path in PROXIED_PATHS:
        app.router.add_post(path, _make_proxy_handler(path))
    app.router.add_get("/v1/models", list_models)
    app.router.add_get("/health", health)
    app.router.add_get("/version", version)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/debug/traces",
                       debug_traces_handler(lambda: state["tracer"]))
    app.router.add_get("/alerts", alerts)
    # always served (even with zero peers configured): a replica
    # joining later can start polling before this one learns about it
    app.router.add_get("/peers", peers_endpoint)
    app.router.add_post("/admin/drain", admin_drain)
    app.router.add_post("/admin/breaker", admin_breaker)
    app.router.add_post("/admin/kvplane/rehome", admin_kvplane_rehome)

    if args.enable_files_api or args.enable_batch_api:
        from production_stack_tpu_torch.router.files_api import mount_files_api
        mount_files_api(app, args.file_storage_path)
    if args.enable_batch_api:
        from production_stack_tpu_torch.router.batches_api import mount_batches_api
        mount_batches_api(app, args.batch_db_path)

    if args.log_stats_interval > 0:
        from production_stack_tpu_torch.router.stats import StatLogger
        state["stat_logger"] = StatLogger(
            lambda: state["discovery"].get_endpoints(),
            state["request_stats"], state["scraper"],
            metrics=state["metrics"],
            interval_s=args.log_stats_interval,
            health_tracker=state["health"])

    if "slo" in state:
        peers_get = None
        if "peers" in state:
            # peer gossip freshness feeds the router_peer_lost signal
            # SLO through the same ingest path as engine /load samples
            peers_get = lambda: state["peers"].signal_records()  # noqa: E731
        state["slo_task"] = SLOTask(
            state["slo"], scraper_get=lambda: state["scraper"].get(),
            interval_s=args.slo_eval_interval,
            peers_get=peers_get)

    async def on_startup(app):
        state["client"] = aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0))
        await state["discovery"].start()
        await state["scraper"].start()
        await state["health"].start(state["client"])
        if "peers" in state:
            await state["peers"].start(state["client"])
        if "stat_logger" in state:
            await state["stat_logger"].start()
        if "config_watcher" in state:
            await state["config_watcher"].start()
        if "slo_task" in state:
            await state["slo_task"].start()

    async def on_cleanup(app):
        if "slo_task" in state:
            await state["slo_task"].close()
        if "stat_logger" in state:
            await state["stat_logger"].close()
        if "config_watcher" in state:
            await state["config_watcher"].close()
        if "peers" in state:
            await state["peers"].close()
        await state["health"].close()
        await state["scraper"].close()
        await state["discovery"].close()
        await state["client"].close()
        if state.get("semantic_cache") is not None:
            state["semantic_cache"].persist()

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)
    return app


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        "pstpu-router",
        description="OpenAI-compatible router over TPU engine replicas")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--service-discovery", choices=["static", "k8s"],
                   default="static")
    p.add_argument("--static-backends", default="",
                   help="comma-separated engine URLs")
    p.add_argument("--static-models", default="",
                   help="comma-separated model names (same order)")
    p.add_argument("--probe-backends", action="store_true",
                   help="query each static backend's /v1/models at "
                        "startup; extra served models (e.g. LoRA "
                        "adapters) become routable aliases")
    p.add_argument("--static-model-aliases", default="",
                   help="alias:model,... pairs")
    p.add_argument("--pools", default="",
                   help="named-pool fleet spec: JSON object (inline, "
                        "or @/path/to/file) mapping pool name to "
                        "{backends, models, routing_logic?, "
                        "session_key?}. Requests route on their body's "
                        "``model`` to the owning pool and ITS routing-"
                        "policy instance; a model no pool serves is a "
                        "structured 404. Replaces service discovery "
                        "with the union of pools; hot-swappable via "
                        "the dynamic-config ``pools`` key")
    p.add_argument("--k8s-namespace", default="default")
    p.add_argument("--k8s-label-selector", default="")
    p.add_argument("--k8s-engine-port", type=int, default=8100)
    p.add_argument("--routing-logic",
                   choices=["roundrobin", "session", "least_loaded",
                            "prefix"],
                   default="roundrobin")
    p.add_argument("--session-key", default="x-user-id")
    p.add_argument("--prefix-chunk-chars", type=int, default=256,
                   help="prefix-router ring granularity: prompt text is "
                        "chain-hashed in chunks of this many chars; one "
                        "ring entry per chunk (should roughly track the "
                        "engine-side kv chunk_size in text terms)")
    p.add_argument("--prefix-ring-entries", type=int, default=65536,
                   help="max chunk digests the prefix router tracks "
                        "(LRU)")
    p.add_argument("--no-prefix-cache-aware", action="store_true",
                   help="disable expected-hit-bytes scoring: the prefix "
                        "policy falls back to pure hash affinity "
                        "(pre-r11 behavior)")
    p.add_argument("--engine-stats-interval", type=float, default=10.0)
    p.add_argument("--log-stats-interval", type=float, default=0.0,
                   help="seconds between periodic per-engine stat log "
                        "lines (0 disables; the reference's "
                        "--log-stats equivalent)")
    p.add_argument("--request-stats-window", type=float, default=30.0)
    p.add_argument("--request-stats-snapshot-ttl", type=float,
                   default=0.05,
                   help="seconds a routing-decision stats snapshot may "
                        "be reused before the sliding-window aggregates "
                        "are recomputed (in-flight counters are always "
                        "live; 0 recomputes every request)")
    p.add_argument("--request-timeout", type=float, default=600.0)
    p.add_argument("--probe-failure-threshold", type=int, default=3,
                   help="consecutive /v1/models probe failures before "
                        "static discovery marks an endpoint unroutable "
                        "(with --probe-backends)")
    p.add_argument("--breaker-threshold", type=int, default=3,
                   help="consecutive upstream failures before an "
                        "endpoint's circuit opens")
    p.add_argument("--breaker-cooldown", type=float, default=5.0,
                   help="seconds an open circuit waits before the "
                        "half-open /v1/models re-probe")
    p.add_argument("--breaker-failure-rate", type=float, default=0.5,
                   help="windowed failure-rate trip (fraction, over "
                        ">=20 samples in the last 30s)")
    p.add_argument("--breaker-probe-interval", type=float, default=1.0,
                   help="seconds between half-open re-probe passes")
    p.add_argument("--failover-attempts", type=int, default=3,
                   help="max backend attempts per request for failures "
                        "occurring before any byte reaches the client "
                        "(1 disables failover)")
    p.add_argument("--max-inflight", type=int, default=0,
                   help="router-wide admission gate: shed with 429 + "
                        "Retry-After once this many proxied requests "
                        "are in flight (0 = unlimited)")
    p.add_argument("--endpoint-inflight-cap", type=int, default=0,
                   help="static per-endpoint concurrency cap; 0 derives "
                        "the cap from each engine's advertised capacity "
                        "(tpu:engine_capacity_seqs on /metrics; engines "
                        "with unbounded admission stay uncapped)")
    p.add_argument("--retry-budget", type=float, default=0.2,
                   help="failover retries allowed as a fraction of "
                        "request volume (token bucket; bounds retry "
                        "storms)")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="seconds SIGTERM waits for in-flight requests "
                        "after the listener stops accepting")
    p.add_argument("--dynamic-config-json", default=None)
    p.add_argument("--dynamic-config-interval", type=float, default=10.0)
    p.add_argument("--feature-gates", default=None,
                   help="Name=true,Name2=false")
    p.add_argument("--semantic-cache-dir", default=None,
                   help="persist the semantic cache index/metadata here")
    p.add_argument("--semantic-cache-threshold", type=float, default=0.95)
    p.add_argument("--semantic-cache-max-entries", type=int, default=4096)
    p.add_argument("--semantic-cache-embedder", default="hashing",
                   help="'hashing' (dependency-free), "
                        "'engine:http://host:port[#model]' (REAL "
                        "embeddings via an engine's /v1/embeddings — "
                        "models/encoder.py), or "
                        "'sentence-transformers/<model>'")
    p.add_argument("--pii-analyzer", default="regex",
                   help="'regex' (dependency-free patterns) or "
                        "'ner:<checkpoint-dir>' (BERT token-"
                        "classification model via the port's encoder — "
                        "finds names/places/orgs regex cannot)")
    p.add_argument("--pii-device", default="cuda",
                   help="device the ner: analyzer runs on: 'cuda' (the "
                        "card; raises without CUDA) or 'cpu'")
    p.add_argument("--pii-action", choices=["block", "redact"],
                   default="block")
    p.add_argument("--pii-types", default=None,
                   help="comma-separated PIIType values (default: all)")
    p.add_argument("--prefill-backends", default="",
                   help="comma-separated kv_producer engine URLs enabling "
                        "disaggregated prefill")
    p.add_argument("--prefill-models", default="",
                   help="comma-separated model names for the prefill pool "
                        "(same order)")
    p.add_argument("--prefill-timeout", type=float, default=15.0,
                   help="hard cap on one disagg prefill pass")
    p.add_argument("--prefill-headstart", type=float, default=2.0,
                   help="max seconds decode routing waits on the prefill "
                        "pool; past it, decode proceeds while prefill "
                        "keeps publishing KV in the background")
    p.add_argument("--prefill-breaker-threshold", type=int, default=3,
                   help="consecutive failures before a prefill backend's "
                        "circuit opens")
    p.add_argument("--prefill-breaker-cooldown", type=float, default=30.0,
                   help="seconds an open prefill circuit stays open")
    p.add_argument("--disagg-min-prompt-chars", type=int, default=0,
                   help="prompts shorter than this skip the prefill "
                        "stage entirely (a 1-token pass costs more "
                        "than prefilling a short prompt on the decode "
                        "engine; 0 = disaggregate everything)")
    p.add_argument("--disagg-chunk-chars", type=int, default=256,
                   help="decode-selection chunk granularity: prompt "
                        "text is chain-hashed in chunks of this many "
                        "chars for the transfer-cost model (should "
                        "roughly track the engine-side kv chunk_size "
                        "in text terms)")
    p.add_argument("--disagg-transfer-weight", type=float, default=1.0,
                   help="decode-selection weight on expected KV "
                        "transfer bytes")
    p.add_argument("--disagg-load-weight", type=float, default=1.0,
                   help="decode-selection weight on scraped decode "
                        "load (in-flight / advertised capacity)")
    p.add_argument("--disagg-remote-cost", type=float, default=1.0,
                   help="per-byte cost of pulling a chunk from the "
                        "shared remote tier (relative units)")
    p.add_argument("--disagg-recompute-cost", type=float, default=2.0,
                   help="per-byte cost of recomputing a chunk the "
                        "tiers don't hold (relative units; > remote "
                        "cost when the DCN link beats prefill compute)")
    p.add_argument("--no-disagg-decode-selection", action="store_true",
                   help="disable transfer-cost decode selection: the "
                        "configured routing policy picks the decode "
                        "engine unassisted")
    p.add_argument("--trace-ring-entries", type=int, default=2048,
                   help="completed request traces kept per process "
                        "(bounded ring served on GET /debug/traces)")
    p.add_argument("--trace-sample-rate", type=float, default=1.0,
                   help="fraction of requests whose span timeline "
                        "enters the trace ring (phase histograms always "
                        "record; an inbound sampled traceparent flag "
                        "wins either way)")
    p.add_argument("--no-slo", action="store_true",
                   help="disable the in-process SLO engine (burn-rate "
                        "accounting, /alerts, tpu:slo_* families)")
    p.add_argument("--slo-config", default=None,
                   help="SLO definition JSON file (slo.SLOConfig "
                        "shape: objectives, window_scale, min_events); "
                        "default: the built-in objective set")
    p.add_argument("--slo-window-scale", type=float, default=1.0,
                   help="multiply every burn-rate window and alert "
                        "hold duration (labels stay canonical; the "
                        "firedrill rig's lever — ignored when "
                        "--slo-config provides its own scale)")
    p.add_argument("--slo-min-events", type=int, default=12,
                   help="volume floor both windows of an alert must "
                        "hold before its condition can be true (one "
                        "bad request against an empty window must "
                        "never page)")
    p.add_argument("--slo-eval-interval", type=float, default=1.0,
                   help="seconds between alert-state evaluation ticks "
                        "(also pulls fresh /load samples into the "
                        "signal SLOs)")
    p.add_argument("--router-id", default=None,
                   help="replica identity reported on /health, "
                        "stamped as x-router-id on every response, "
                        "and exchanged in peer gossip (default: "
                        "derived from host:port)")
    p.add_argument("--peer-routers", default="",
                   help="comma-separated peer router base URLs: "
                        "enables the multi-router shared-state plane "
                        "(breaker/drain gossip via GET /peers, "
                        "apportioned per-endpoint caps)")
    p.add_argument("--peer-gossip-interval", type=float, default=1.0,
                   help="seconds between peer gossip rounds")
    p.add_argument("--peer-stale-after", type=float, default=None,
                   help="seconds of gossip silence before a peer "
                        "stops counting toward the live-router cap "
                        "split (default: 3x the gossip interval)")
    p.add_argument("--no-shared-state", action="store_true",
                   help="parse --peer-routers but keep the gossip "
                        "plane dark (no breaker/drain exchange, no "
                        "cap splitting) — the multirouter rig's "
                        "anti-vacuity lever")
    p.add_argument("--qos-tiers", default="",
                   help="enable QoS priority tiers: ordered "
                        "name=admit_fraction pairs, highest priority "
                        "first (canonical: "
                        "'tier0=1.0,tier1=0.85,tier2=0.7'). Requests "
                        "pick a tier via the x-priority-class header "
                        "(name or index; untagged traffic = tier 0); "
                        "tier k admits only while proxied in-flight "
                        "is under fraction*--max-inflight, so "
                        "saturation sheds low tiers first")
    p.add_argument("--qos-tier-rates", default="",
                   help="optional per-tier token buckets: "
                        "name=requests_per_second pairs (absent = "
                        "uncapped rate)")
    p.add_argument("--qos-tenant-rate", type=float, default=0.0,
                   help="per-tenant token bucket nested inside every "
                        "QoS tier (requests/second per distinct "
                        "x-tenant-id value; 0 disables). A tenant over "
                        "its bucket sheds 429 + Retry-After WITHOUT "
                        "drawing from its tier's shared budget, so a "
                        "noisy tenant cannot starve its tier peers")
    p.add_argument("--qos-preempt-from", type=int, default=None,
                   help="tiers at or past this index register as "
                        "preemptable while their backend dispatch is "
                        "pre-first-byte; a higher-priority arrival at "
                        "the full gate takes the newest such slot "
                        "(victim gets a structured 503 + Retry-After). "
                        "Default: only the lowest tier; pass the tier "
                        "count to disable preemption")
    p.add_argument("--enable-files-api", action="store_true")
    p.add_argument("--enable-batch-api", action="store_true")
    p.add_argument("--file-storage-path", default="/tmp/pstpu_files")
    p.add_argument("--batch-db-path", default="/tmp/pstpu_batches.db")
    args = p.parse_args(argv)
    if args.service_discovery == "static" and not args.static_backends \
            and not args.pools:
        p.error("--static-backends is required with static discovery "
                "(or name the fleet via --pools)")
    if args.service_discovery == "k8s" and not args.k8s_label_selector:
        p.error("--k8s-label-selector is required with k8s discovery")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    set_ulimit()
    app = build_app(args)

    async def _serve():
        # handler_cancellation: a client disconnect cancels the relay
        # task, which closes the backend connection — propagating the
        # disconnect to the engine so IT can abort the generation
        # (aiohttp >= 3.9 defaults this off; without it an abandoned
        # request is only noticed when the next token write fails).
        # access_log=None: the default access logger formats a line per
        # request even when no handler consumes it — per-request stats
        # live in the stats plane, not in access logs
        runner = web.AppRunner(app, handler_cancellation=True,
                               access_log=None)
        await runner.setup()
        site = web.TCPSite(runner, args.host, args.port)
        await site.start()
        logger.info("router listening on %s:%d (%s discovery, %s routing)",
                    args.host, args.port, args.service_discovery,
                    args.routing_logic)
        # graceful drain: SIGTERM/SIGINT stops the listener (no new
        # connections) and waits for in-flight requests to finish
        # within --drain-timeout before tearing the app down
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, stop.set)
            except NotImplementedError:
                pass
        await stop.wait()
        state = app["state"]
        state["draining_listener"] = True
        logger.info("shutdown: draining listener (%d in-flight, "
                    "bound %.0fs)", state["inflight"], args.drain_timeout)
        await site.stop()
        drained = await wait_for_drain(lambda: state["inflight"],
                                       args.drain_timeout)
        logger.info("shutdown: %s", "drained clean" if drained else
                    f"{state['inflight']} requests still in flight at "
                    f"the drain bound; closing anyway")
        await runner.cleanup()

    asyncio.run(_serve())


if __name__ == "__main__":
    main()
