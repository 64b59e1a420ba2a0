"""Router-side Prometheus gauges, refreshed from the stats plane on scrape.

Gauge names match the reference's router metrics surface (reference:
src/vllm_router/services/metrics_service/prometheus_gauge.py —
vllm:current_qps, vllm:avg_latency, vllm:avg_itl, vllm:num_prefill_requests,
vllm:num_decoding_requests, vllm:num_requests_running,
vllm:healthy_pods_total) so existing Grafana dashboards keep working.
"""

from prometheus_client import CollectorRegistry, Gauge, generate_latest

from production_stack_tpu_torch.tracing import (PhaseHistogramCollector,
                                          PhaseHistograms)


class RouterMetrics:
    def __init__(self):
        self.registry = CollectorRegistry()
        # phase-latency attribution (tracing.py): one histogram series
        # per (phase, server). Router-local phases (admission, routing,
        # backoff, prefill_dispatch) carry server=""; backend-attributed
        # phases (backend_ttfb, relay) carry the endpoint URL — and are
        # EVICTED with the endpoint (evict_phase_servers) so a dynamic-
        # config swap never leaves frozen per-endpoint series behind
        # (the r8 refresh_resilience precedent). Fed at trace seal time
        # (proxy.py), rendered at scrape by the custom collector —
        # never a prometheus object on the relay hot loop.
        self.request_phases = PhaseHistograms(("phase", "server"))
        self.registry.register(PhaseHistogramCollector(
            "tpu:request_phase_seconds",
            "Router-side request phase durations (docs/observability.md "
            "'Tracing' phase glossary)", self.request_phases))

        def gauge(name, doc):
            return Gauge(name, doc, ["server"], registry=self.registry)

        self.current_qps = gauge("vllm:current_qps",
                                 "Router-observed QPS per engine")
        self.avg_latency = gauge("vllm:avg_latency",
                                 "Mean e2e latency (window)")
        self.avg_ttft = gauge("vllm:avg_ttft", "Mean TTFT (window)")
        self.avg_itl = gauge("vllm:avg_itl", "Mean inter-token latency")
        self.num_prefill = gauge("vllm:num_prefill_requests",
                                 "Requests awaiting first byte")
        self.num_decoding = gauge("vllm:num_decoding_requests",
                                  "Requests streaming")
        self.num_running = gauge("vllm:num_requests_running",
                                 "In-flight requests via router")
        self.healthy_pods = Gauge("vllm:healthy_pods_total",
                                  "Healthy (breaker-closed, non-"
                                  "draining) engine endpoints",
                                  registry=self.registry)
        # resilience surface: per-endpoint upstream failure/retry
        # outcomes (previously invisible — a relayed backend 5xx looked
        # identical to a healthy response in every exported series) and
        # breaker state
        self.upstream_failures = Gauge(
            "vllm:upstream_failures_total",
            "Upstream failures observed per endpoint by kind "
            "(connect, timeout, http_5xx, mid_stream, probe)",
            ["server", "kind"], registry=self.registry)
        self.upstream_retries = Gauge(
            "vllm:upstream_retries_total",
            "Pre-stream failovers routed away from this endpoint",
            ["server"], registry=self.registry)
        self.relayed_5xx = Gauge(
            "vllm:relayed_5xx_total",
            "Backend 5xx responses relayed to clients (retries "
            "exhausted)", ["server"], registry=self.registry)
        self.breaker_state = Gauge(
            "vllm:breaker_state",
            "Circuit state per endpoint (0 closed, 1 half-open, 2 open)",
            ["server"], registry=self.registry)
        self.breaker_opens = Gauge(
            "vllm:breaker_opens_total",
            "Circuit-breaker open transitions", registry=self.registry)
        # overload-protection surface: requests the ROUTER itself shed
        # ("admission" = --max-inflight gate -> 429; "endpoint_cap" =
        # every candidate at its concurrency cap -> 503). Upstream
        # sheds the router observed live in
        # vllm:upstream_failures_total{kind="shed"|"deadline"}.
        self.router_sheds = Gauge(
            "vllm:router_sheds_total",
            "Requests shed by the router by scope",
            ["scope"], registry=self.registry)
        # semantic-cache surface (reference:
        # semantic_cache_integration.py:25-44 gauge names)
        def plain(name, doc):
            return Gauge(name, doc, registry=self.registry)
        self.semantic_hits = plain("vllm:semantic_cache_hits",
                                   "Semantic cache hits")
        self.semantic_misses = plain("vllm:semantic_cache_misses",
                                     "Semantic cache misses")
        self.semantic_hit_ratio = plain("vllm:semantic_cache_hit_ratio",
                                        "Semantic cache hit ratio")
        self.semantic_size = plain("vllm:semantic_cache_size",
                                   "Semantic cache entries")
        self.semantic_latency = plain("vllm:semantic_cache_latency",
                                      "Last semantic cache lookup seconds")
        # cache-aware prefix routing surface (routing.PrefixAwareRouter):
        # how often scoring found a warm endpoint vs fell back to hash
        # affinity on a cold prefix. Real counters (exposition name
        # gains the _total suffix) fed by delta-sync in refresh_routing
        # so a dynamic-config router swap never reads as an unflagged
        # gauge reset.
        from prometheus_client import Counter
        self.prefix_warm_routes = Counter(
            "tpu:router_prefix_warm_routes",
            "Routing decisions scored onto a warm endpoint "
            "(expected prefix-hit bytes > 0)", registry=self.registry)
        self.prefix_cold_routes = Counter(
            "tpu:router_prefix_cold_routes",
            "Routing decisions that fell back to hash affinity "
            "(cold prefix)", registry=self.registry)
        self._prefix_last = {"warm": 0, "cold": 0}
        # multi-router control plane (router/shared_state.py + qos.py):
        # peer liveness, per-tier QoS sheds/preemptions, and affinity
        # moves. Counters are delta-synced (the r12 disagg convention)
        # so a dynamic-config router swap — which resets the policy
        # object's affinity totals — never reads as a counter reset.
        self.router_peers = Gauge(
            "tpu:router_peers",
            "Peer router replicas by gossip liveness state "
            "(live, stale, unreachable)",
            ["state"], registry=self.registry)
        self.qos_sheds = Counter(
            "tpu:router_qos_sheds",
            "Requests shed by the QoS admission layer per priority "
            "tier (graduated pressure gate, token bucket, preemption)",
            ["tier"], registry=self.registry)
        self.qos_preemptions = Counter(
            "tpu:router_qos_preemptions",
            "In-flight background dispatches preempted by higher-"
            "priority arrivals, per victim tier",
            ["tier"], registry=self.registry)
        self.qos_inflight = Gauge(
            "tpu:router_qos_inflight",
            "Currently proxied requests per priority tier",
            ["tier"], registry=self.registry)
        # named-pools surface (router/pools.py): per-pool routed
        # requests / endpoint counts / in-place swaps, unknown-model
        # 404s, and per-(tenant, tier) sheds from the nested tenant
        # buckets (qos.py). Counters delta-sync off the PoolManager's /
        # QosPolicy's plain-int totals, which survive pool swaps by
        # construction; the tenant label set is bounded by the policy's
        # LRU (max_tenants).
        self.pool_requests = Counter(
            "tpu:router_pool_requests",
            "Requests routed per named pool (model -> pool resolution)",
            ["pool"], registry=self.registry)
        self.pool_endpoints = Gauge(
            "tpu:router_pool_endpoints",
            "Configured endpoints per named pool",
            ["pool"], registry=self.registry)
        self.pool_swaps = Counter(
            "tpu:router_pool_swaps",
            "In-place pool spec swaps applied (membership or policy)",
            ["pool"], registry=self.registry)
        self.pool_unknown_models = Counter(
            "tpu:router_pool_unknown_models",
            "Requests 404ed because no pool serves the named model",
            registry=self.registry)
        self.tenant_sheds = Counter(
            "tpu:router_tenant_sheds",
            "Requests shed by a per-tenant token bucket nested in a "
            "QoS tier (noisy-neighbor containment, "
            "docs/multitenancy.md)",
            ["tenant", "tier"], registry=self.registry)
        self._pool_req_last: dict = {}
        self._pool_swap_last: dict = {}
        self._pool_unknown_last = 0
        self._tenant_shed_last: dict = {}
        self._seen_pools = set()
        self.affinity_moves = Counter(
            "tpu:router_affinity_moves",
            "Session/prefix keys routed away from their previous home "
            "endpoint, by reason (endpoint_lost = home unroutable/"
            "removed; rebalance = policy drift — across N routers, "
            "the split-brain signal)",
            ["reason"], registry=self.registry)
        self._qos_shed_last: dict = {}
        self._qos_preempt_last: dict = {}
        self._affinity_last: dict = {}
        # disaggregated prefill surface (router/disagg.py): prefill
        # dispatches/failures, per-reason fallbacks to aggregated
        # serving, breaker opens, and decode-selection outcomes. Real
        # counters, delta-synced in refresh_disagg so a dynamic-config
        # pool swap (which may replace the orchestrator) never reads as
        # an unflagged counter reset.
        self.disagg_prefills = Counter(
            "tpu:router_disagg_prefills",
            "Prefill passes dispatched to the prefill pool",
            registry=self.registry)
        self.disagg_prefill_errors = Counter(
            "tpu:router_disagg_prefill_errors",
            "Prefill passes that failed (decode recomputed)",
            registry=self.registry)
        self.disagg_fallbacks = Counter(
            "tpu:router_disagg_fallbacks",
            "Requests degraded to aggregated serving by reason "
            "(no_pool, breaker_open, shed, http_error, timeout, "
            "connect)", ["reason"], registry=self.registry)
        self.disagg_breaker_opens = Counter(
            "tpu:router_disagg_breaker_opens",
            "Prefill-backend circuit-breaker open transitions",
            registry=self.registry)
        self.disagg_headstart_elapsed = Counter(
            "tpu:router_disagg_headstart_elapsed",
            "Decode routed while the prefill pass was still running",
            registry=self.registry)
        self.disagg_decode_cost_routes = Counter(
            "tpu:router_disagg_decode_cost_routes",
            "Decode selections made by the transfer-cost model",
            registry=self.registry)
        self.disagg_decode_abstains = Counter(
            "tpu:router_disagg_decode_abstains",
            "Decode selections deferred to the routing policy "
            "(cold prefix)", registry=self.registry)
        self._disagg_last: dict = {}
        # SLO surface (production_stack_tpu/slo.py): burn rates per
        # (slo, window) — the series the generated Prometheus rules in
        # observability/alert-rules.yaml alert over, so in-process and
        # cluster alerting read the same accounting — plus the alert
        # state machine and firing transitions (delta-synced real
        # counter). Refreshed at scrape (refresh_slo), like every
        # other family.
        self.slo_burn = Gauge(
            "tpu:slo_burn_rate",
            "Error-budget burn rate per SLO and window (bad fraction "
            "over the window / error budget; docs/observability.md "
            "'SLOs and alerting')",
            ["slo", "window"], registry=self.registry)
        self.slo_events = Gauge(
            "tpu:slo_window_events",
            "Good+bad events per SLO window — the volume floor the "
            "generated alert rules gate on, mirroring the in-process "
            "min_events gate",
            ["slo", "window"], registry=self.registry)
        self.alert_state = Gauge(
            "tpu:alert_state",
            "Burn-rate alert state (0 inactive/resolved, 1 pending, "
            "2 firing; diagnosis steps in docs/runbooks.md)",
            ["alert"], registry=self.registry)
        self.alerts_fired = Counter(
            "tpu:alerts_fired",
            "Alert firing transitions (pending -> firing)",
            ["alert"], registry=self.registry)
        self._alerts_fired_last: dict = {}
        # PII surface (reference: pii/middleware.py:20-39 counters)
        self.pii_scanned = plain("vllm:pii_requests_scanned",
                                 "Requests scanned for PII")
        self.pii_blocked = plain("vllm:pii_requests_blocked",
                                 "Requests blocked for PII")
        self.pii_redacted = plain("vllm:pii_requests_redacted",
                                  "Requests redacted for PII")
        self._seen_servers = set()
        self._seen_failures = set()       # (url, kind) label pairs
        self._seen_retry_servers = set()
        self._seen_relayed_servers = set()
        self._seen_breaker_servers = set()

    def refresh(self, request_stats: dict, num_healthy: int) -> None:
        # drop label series for engines that left the fleet so /metrics
        # never exports frozen stats for dead pods
        for url in self._seen_servers - set(request_stats):
            for g in (self.current_qps, self.avg_latency, self.avg_ttft,
                      self.avg_itl, self.num_prefill, self.num_decoding,
                      self.num_running):
                try:
                    g.remove(url)
                except KeyError:
                    pass
        self._seen_servers = set(request_stats)
        for url, st in request_stats.items():
            self.current_qps.labels(server=url).set(st.qps)
            self.avg_latency.labels(server=url).set(st.latency)
            self.avg_ttft.labels(server=url).set(st.ttft)
            self.avg_itl.labels(server=url).set(st.itl)
            self.num_prefill.labels(server=url).set(st.in_prefill)
            self.num_decoding.labels(server=url).set(st.in_decoding)
            self.num_running.labels(server=url).set(st.in_flight)
        # healthy = breaker-closed and not draining (callers compute it
        # from the HealthTracker), NOT raw discovery membership
        self.healthy_pods.set(num_healthy)

    def refresh_resilience(self, tracker) -> None:
        """Export the HealthTracker's counters + breaker states,
        dropping label series for endpoints the tracker evicted so
        departed pods never export frozen resilience series."""
        def sync(gauge, seen, current, setter):
            for labels in seen - set(current):
                try:
                    gauge.remove(*labels)
                except KeyError:
                    pass
            for labels in current:
                setter(labels)
            return set(current)

        state_code = {"closed": 0, "half_open": 1, "open": 2}
        self._seen_failures = sync(
            self.upstream_failures, self._seen_failures,
            tracker.failures,
            lambda k: self.upstream_failures.labels(
                server=k[0], kind=k[1]).set(tracker.failures[k]))
        self._seen_retry_servers = sync(
            self.upstream_retries, self._seen_retry_servers,
            {(u,) for u in tracker.retries},
            lambda k: self.upstream_retries.labels(server=k[0]).set(
                tracker.retries[k[0]]))
        self._seen_relayed_servers = sync(
            self.relayed_5xx, self._seen_relayed_servers,
            {(u,) for u in tracker.relayed_5xx},
            lambda k: self.relayed_5xx.labels(server=k[0]).set(
                tracker.relayed_5xx[k[0]]))
        snap = tracker.snapshot()
        self._seen_breaker_servers = sync(
            self.breaker_state, self._seen_breaker_servers,
            {(u,) for u in snap},
            lambda k: self.breaker_state.labels(server=k[0]).set(
                state_code.get(snap[k[0]]["state"], 0)))
        self.breaker_opens.set(tracker.breaker_opens)

    def refresh_overload(self, shed_counts: dict) -> None:
        for scope, count in shed_counts.items():
            self.router_sheds.labels(scope=scope).set(count)

    def refresh_routing(self, router) -> None:
        """Export cache-aware routing + affinity-move counters when
        the active policy carries them. Delta-synced: a dynamic-config
        swap resets the router object's totals, so fresh totals below
        the last sync are treated as new increments."""
        moves = getattr(router, "affinity_moves", None)
        if moves is not None:
            for reason, total in moves.items():
                delta = total - self._affinity_last.get(reason, 0)
                if delta < 0:     # router swapped: totals restarted
                    delta = total
                if delta > 0:
                    self.affinity_moves.labels(reason=reason).inc(delta)
                self._affinity_last[reason] = total
        warm = getattr(router, "warm_routes", None)
        if warm is None:
            return
        cold = router.cold_routes
        for key, total, counter in (
                ("warm", warm, self.prefix_warm_routes),
                ("cold", cold, self.prefix_cold_routes)):
            delta = total - self._prefix_last[key]
            if delta < 0:         # router swapped: totals restarted
                delta = total
            if delta > 0:
                counter.inc(delta)
            self._prefix_last[key] = total

    def refresh_peers(self, peers) -> None:
        """Export peer-router liveness (shared_state.RouterPeers).
        The state label set is fixed, so nothing to evict."""
        for state, count in peers.state_counts().items():
            self.router_peers.labels(state=state).set(count)

    def refresh_qos(self, qos) -> None:
        """Export per-tier QoS accounting (qos.QosPolicy). The tier
        label set is fixed by the CLI spec for the process lifetime;
        sheds/preemptions are delta-synced real counters."""
        for tier, total in qos.shed_totals().items():
            delta = total - self._qos_shed_last.get(tier, 0)
            if delta > 0:
                self.qos_sheds.labels(tier=tier).inc(delta)
            self._qos_shed_last[tier] = total
        for t in qos.tiers:
            total = qos.preemptions[t.index]
            delta = total - self._qos_preempt_last.get(t.name, 0)
            if delta > 0:
                self.qos_preemptions.labels(tier=t.name).inc(delta)
            self._qos_preempt_last[t.name] = total
            self.qos_inflight.labels(tier=t.name).set(
                qos.inflight[t.index])
        # per-(tenant, tier) sheds from the nested tenant buckets; the
        # policy's LRU evicts (tenant, tier) keys with their buckets,
        # so the baseline dict is pruned with it — an evicted tenant
        # that returns restarts its totals, which delta-sync treats as
        # fresh increments (never negative)
        tenant_sheds = getattr(qos, "tenant_sheds", None)
        if tenant_sheds is not None:
            for key in [k for k in self._tenant_shed_last
                        if k not in tenant_sheds]:
                del self._tenant_shed_last[key]
            for (tenant, tier), total in tenant_sheds.items():
                delta = total - self._tenant_shed_last.get(
                    (tenant, tier), 0)
                if delta > 0:
                    self.tenant_sheds.labels(
                        tenant=tenant, tier=tier).inc(delta)
                self._tenant_shed_last[(tenant, tier)] = total

    def refresh_pools(self, pools) -> None:
        """Export the PoolManager's accounting. Requests/swaps are
        delta-synced real counters off manager totals that survive
        pool-object swaps; the endpoint gauge drops label series for
        pools no longer in the table (dropped pools keep their counter
        totals — counters are monotonic — but must not export a frozen
        endpoint count)."""
        snap = pools.snapshot()
        for name in self._seen_pools - set(snap):
            try:
                self.pool_endpoints.remove(name)
            except KeyError:
                pass
        self._seen_pools = set(snap)
        for name, info in snap.items():
            self.pool_endpoints.labels(pool=name).set(
                len(info["backends"]))
        for name, total in pools.routed.items():
            delta = total - self._pool_req_last.get(name, 0)
            if delta > 0:
                self.pool_requests.labels(pool=name).inc(delta)
            self._pool_req_last[name] = total
        for name, total in pools.swaps.items():
            delta = total - self._pool_swap_last.get(name, 0)
            if delta > 0:
                self.pool_swaps.labels(pool=name).inc(delta)
            self._pool_swap_last[name] = total
        delta = pools.unknown_models - self._pool_unknown_last
        if delta > 0:
            self.pool_unknown_models.inc(delta)
        self._pool_unknown_last = pools.unknown_models

    def refresh_disagg(self, orch) -> None:
        """Export the disagg orchestrator's counters. Delta-synced like
        refresh_routing: a dynamic-config swap may replace the
        orchestrator (totals restart), so fresh totals below the last
        sync are treated as new increments."""
        def bump(key, total, counter):
            delta = total - self._disagg_last.get(key, 0)
            if delta < 0:             # orchestrator swapped: restarted
                delta = total
            if delta > 0:
                counter.inc(delta)
            self._disagg_last[key] = total

        bump("prefills", orch.prefills, self.disagg_prefills)
        bump("errors", orch.prefill_errors, self.disagg_prefill_errors)
        bump("breaker_opens", orch.breaker_opens,
             self.disagg_breaker_opens)
        bump("headstart", orch.headstart_elapsed,
             self.disagg_headstart_elapsed)
        for reason, total in orch.fallbacks.items():
            bump(f"fb:{reason}", total,
                 self.disagg_fallbacks.labels(reason=reason))
        sel = orch.selector
        if sel is not None:
            bump("cost_routes", sel.cost_routes,
                 self.disagg_decode_cost_routes)
            bump("abstains", sel.abstains, self.disagg_decode_abstains)

    def evict_phase_servers(self, live_urls) -> int:
        """Drop per-endpoint phase-histogram series for endpoints no
        longer configured (called from the /metrics handler next to the
        stats/breaker evictions). Router-local series (server="") are
        untouched."""
        return self.request_phases.evict_except(live_urls,
                                                label_index=1)

    def reset_disagg_baseline(self) -> None:
        """Called after a final refresh_disagg fold when the
        orchestrator is removed (dynamic-config disable): the next
        orchestrator starts its totals from zero, and a stale baseline
        would swallow its first increments whenever they happen to
        pass the old totals between scrapes."""
        self._disagg_last = {}

    def refresh_slo(self, slo_engine) -> None:
        """Export the SLO engine's burn rates and alert states (a
        scrape re-evaluates unless the eval task's last pass is under
        half a second old — states cannot move faster). Fired counts are
        delta-synced real counters; the (slo, window) and (alert)
        label sets are fixed by the SLO config, so there is nothing to
        evict."""
        from production_stack_tpu_torch.slo import STATE_CODE
        slo_engine.evaluate(max_age_s=0.5)
        for slo_name, windows in slo_engine.burns.items():
            for window, value in windows.items():
                self.slo_burn.labels(slo=slo_name, window=window).set(
                    value)
        for slo_name, windows in slo_engine.volumes.items():
            for window, value in windows.items():
                self.slo_events.labels(slo=slo_name, window=window).set(
                    value)
        for name, alert in slo_engine.alerts.items():
            self.alert_state.labels(alert=name).set(
                STATE_CODE[alert.state])
            delta = alert.fired_total - \
                self._alerts_fired_last.get(name, 0)
            if delta > 0:
                self.alerts_fired.labels(alert=name).inc(delta)
            self._alerts_fired_last[name] = alert.fired_total

    def refresh_semantic_cache(self, cache) -> None:
        self.semantic_hits.set(cache.hits)
        self.semantic_misses.set(cache.misses)
        self.semantic_hit_ratio.set(cache.hit_ratio)
        self.semantic_size.set(len(cache))
        self.semantic_latency.set(cache.last_lookup_s)

    def refresh_pii(self, middleware) -> None:
        self.pii_scanned.set(middleware.scanned)
        self.pii_blocked.set(middleware.blocked)
        self.pii_redacted.set(middleware.redacted)

    def render(self) -> bytes:
        return generate_latest(self.registry)
