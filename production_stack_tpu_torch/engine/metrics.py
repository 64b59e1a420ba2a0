"""Engine Prometheus metrics (``production_stack_tpu/engine/metrics.py``).

The gauge names are the ones the router parses
(``router/stats.py parse_engine_metrics``): ``vllm:num_requests_running``,
``vllm:num_requests_waiting``, ``vllm:gpu_cache_usage_perc``,
``tpu:hbm_kv_usage_perc``, ``vllm:gpu_prefix_cache_hit_rate``,
``tpu:engine_capacity_seqs`` and ``tpu:est_queue_delay_ms``; every other
family keeps its JAX name and labels too, so one dashboard reads
either engine: the LoRA adapter pool's ``tpu:engine_adapter_*``, the KV
tiers' ``tpu:kvcache_*`` (hits, bytes, publishes, tier occupancy, the
remote breaker), ``tpu:engine_kv_role`` and the kvplane's
``tpu:kvplane_*`` (migration, warm, defrag, codecs, pipelined
prefetch) included. Left out: XLA's compile families
(``tpu:engine_compiles``, ``tpu:engine_compile_seconds``), which have
no counterpart in an eager engine.

Totals the engine loop and the KV connector keep as plain ints
(token-steps, the pool census, the tiers' counters) are folded in at
scrape time as counter deltas (``sync_eff``, ``sync_kvpool``,
``sync_kv``); phase durations (``queue_wait``, ``prefill``,
``decode``, ``decode_window``, ``kv_prefetch``, ``kv_publish``) are
``PhaseHistograms`` rendered by a custom collector.
"""

from prometheus_client import (CollectorRegistry, Counter, Gauge, Histogram,
                               generate_latest)

from production_stack_tpu_torch.engine.efficiency import OCCUPANCY_BUCKETS
from production_stack_tpu_torch.tracing import (PhaseHistogramCollector,
                                                PhaseHistograms)


class EngineMetrics:
    """One engine's families, in a registry of its own (several engines
    in one process do not collide)."""

    def __init__(self, model: str):
        self.registry = CollectorRegistry()
        labels = {"model_name": model}

        def gauge(name, doc):
            g = Gauge(name, doc, list(labels), registry=self.registry)
            return g.labels(**labels)

        def counter(name, doc):
            c = Counter(name, doc, list(labels), registry=self.registry)
            return c.labels(**labels)

        def histo(name, doc, buckets):
            h = Histogram(name, doc, list(labels), buckets=buckets,
                          registry=self.registry)
            return h.labels(**labels)

        # the router's gauges
        self.num_running = gauge("vllm:num_requests_running",
                                 "Sequences in the decode batch")
        self.num_waiting = gauge("vllm:num_requests_waiting",
                                 "Sequences queued or prefilling")
        self.kv_usage = gauge("vllm:gpu_cache_usage_perc",
                              "KV cache slot-token utilization (0-1)")
        self.hbm_kv_usage = gauge("tpu:hbm_kv_usage_perc",
                                  "KV cache device-memory utilization (0-1)")
        self.prefix_hit_rate = gauge("vllm:gpu_prefix_cache_hit_rate",
                                     "Prefix cache hit rate (0-1)")
        self.capacity = gauge(
            "tpu:engine_capacity_seqs",
            "Total sequences accepted before shedding (max_num_seqs + "
            "max_waiting_seqs; 0 = unbounded admission)")
        self.est_queue_delay = gauge(
            "tpu:est_queue_delay_ms",
            "Estimated wait for a newly queued request (ms)")
        # requests, tokens and latencies
        self.hbm_prefix_hit_rate = gauge(
            "tpu:hbm_prefix_cache_hit_rate",
            "In-pool prefix cache hit rate (0-1, per request)")
        self.preemptions = counter(
            "vllm:num_preemptions_total",
            "Sequences preempted (KV pool pressure) for recompute")
        self.prompt_tokens = counter("vllm:prompt_tokens_total",
                                     "Prefilled prompt tokens")
        self.generation_tokens = counter("vllm:generation_tokens_total",
                                         "Generated tokens")
        self.ttft = histo(
            "vllm:time_to_first_token_seconds", "Time to first token",
            (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0))
        self.e2e_latency = histo(
            "vllm:e2e_request_latency_seconds", "End-to-end request latency",
            (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0))
        self.per_token = histo(
            "vllm:time_per_output_token_seconds", "Inter-token latency",
            (0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5))
        # n-gram speculation: accepted draft tokens are those emitted
        # beyond one per macro-step; both count speculating rows only
        # (per-row spec_ok), so accepted / steps is the rows' acceptance
        self.spec_accepted_tokens = counter(
            "tpu:spec_accepted_draft_tokens_total",
            "Draft tokens accepted by speculative verification")
        self.spec_macro_steps = counter(
            "tpu:spec_macro_steps_total",
            "Speculative macro-steps executed by eligible rows")
        # runtime LoRA adapter pool (engine.load_adapter/evict_adapter;
        # /admin/lora/load|evict): lifecycle counters + live catalog
        self.adapter_loads = counter(
            "tpu:engine_adapter_loads_total",
            "LoRA adapters loaded at runtime (/admin/lora/load)")
        self.adapter_evictions = counter(
            "tpu:engine_adapter_evictions_total",
            "LoRA adapters evicted at runtime (/admin/lora/evict)")
        self.adapters_loaded = gauge(
            "tpu:engine_adapters_loaded",
            "LoRA adapters currently serving (served model catalog "
            "minus the base model)")
        # KV tiering (kvcache/connector.py): the connector keeps running
        # totals; sync_kv() turns them into counter increments at scrape
        # time, so the engine loop never touches prometheus objects
        self.kv_query_tokens = counter(
            "tpu:kvcache_query_tokens_total",
            "Prompt tokens looked up against the KV tiers")
        self.kv_hit_tokens = counter(
            "tpu:kvcache_hit_tokens_total",
            "Prompt tokens served from the KV tiers (prefill skipped)")
        self.kv_foreign_hit_tokens = counter(
            "tpu:kvcache_foreign_hit_tokens_total",
            "Tier-hit tokens from chunks this process never published "
            "(produced by another replica — cross-replica sharing)")
        self.kv_chunk_hits = counter(
            "tpu:kvcache_chunk_hits_total", "Tier chunk lookups that hit")
        self.kv_chunk_misses = counter(
            "tpu:kvcache_chunk_misses_total",
            "Tier chunk lookups that ended the prefix walk")
        self.kv_bytes_loaded = counter(
            "tpu:kvcache_bytes_loaded_total",
            "Bytes materialized from the tiers by prefetch")
        self.kv_bytes_saved = counter(
            "tpu:kvcache_bytes_saved_total",
            "Bytes written through the tiers by the publish path")
        self.kv_rejected_chunks = counter(
            "tpu:kvcache_rejected_chunks_total",
            "Tier values rejected (size/checksum validation) and evicted")
        self.kv_dropped_saves = counter(
            "tpu:kvcache_dropped_saves_total",
            "Publish batches dropped by writer-queue backpressure")
        # the disaggregated-prefill role and the producer's publishes
        self.kv_published_chunks = counter(
            "tpu:kvcache_published_chunks_total",
            "Chunks written through the tiers by the producer path")
        self.kv_progress_published_chunks = counter(
            "tpu:kvcache_progress_published_chunks_total",
            "Published chunks that became tier-visible mid-prefill "
            "(the eager-publish path disaggregated decode overlaps "
            "with)")
        self._kv_role = Gauge(
            "tpu:engine_kv_role",
            "KV transfer role (1 on the engine's role label: "
            "kv_producer, kv_consumer, or kv_both)",
            list(labels) + ["role"], registry=self.registry)
        self.kv_remote_breaker_open = gauge(
            "tpu:kvcache_remote_breaker_open",
            "1 while the remote cache-server tier is breaker-skipped")
        self._kv_tier_bytes = Gauge(
            "tpu:kvcache_tier_bytes", "KV tier occupancy in bytes",
            list(labels) + ["tier"], registry=self.registry)
        self._kv_tier_items = Gauge(
            "tpu:kvcache_tier_items", "KV tier chunk count",
            list(labels) + ["tier"], registry=self.registry)
        self._kv_tier_hits = Counter(
            "tpu:kvcache_tier_chunk_hits",
            "Prefetch chunk hits by the tier that served them",
            list(labels) + ["tier"], registry=self.registry)
        # overload protection
        self.admission_rejected = counter(
            "tpu:admission_rejected_total",
            "Requests shed at submit (max_waiting_seqs reached, 503)")
        self.deadline_expired = counter(
            "tpu:deadline_expired_total",
            "Requests dropped while WAITING (x-request-deadline-ms "
            "elapsed before admission, 504)")
        self.queue_delay_shed = counter(
            "tpu:queue_delay_shed_total",
            "Requests shed while WAITING (max_queue_delay_ms exceeded, "
            "503)")
        # engine-side phases: queue_wait / prefill / decode per request,
        # decode_window per window
        self.engine_phases = PhaseHistograms(("phase",))
        self.registry.register(PhaseHistogramCollector(
            "tpu:engine_phase_seconds",
            "Engine-side request phase durations", self.engine_phases))
        # efficiency accounting (engine/efficiency.py)
        self._token_steps = Counter(
            "tpu:engine_token_steps",
            "Device token-step computations by usefulness: real "
            "(emitted tokens), pad (parked rows), dead (finished-row "
            "tails, discarded rows, prefill bucket padding)",
            list(labels) + ["kind", "phase"], registry=self.registry)
        self.effective_bytes_per_s = gauge(
            "tpu:engine_effective_bytes_per_s",
            "Modelled useful device-memory traffic per wall-clock second "
            "over the recent window")
        self.mbu_perc = gauge(
            "tpu:engine_mbu_perc",
            "Model-bandwidth utilization: effective bytes/s over the "
            "configured --hbm-peak-gbps (0-100)")
        self.decode_live_fraction = gauge(
            "tpu:decode_window_live_fraction",
            "Recent fraction of decode token-steps that emitted a kept "
            "token (real / (real+pad+dead))")
        # the KV block pool (engine/block_manager.py frag_report)
        self._kvpool_blocks = Gauge(
            "tpu:kvpool_blocks",
            "Paged-KV pool blocks by state (free list / held by live "
            "sequences / refcount-0 prefix-cached)",
            list(labels) + ["state"], registry=self.registry)
        self._kvpool_alloc_failures = Counter(
            "tpu:kvpool_alloc_failures",
            "Block allocations refused, by reason: exhausted (zero "
            "allocatable blocks) vs fragmented (free blocks remain but "
            "fewer than the request needs)",
            list(labels) + ["reason"], registry=self.registry)
        self.kvpool_cache_evictions = counter(
            "tpu:kvpool_cache_evictions_total",
            "Prefix-cached blocks reclaimed (LRU) to satisfy allocations")
        self.kvpool_occ_hist = PhaseHistograms((),
                                               buckets=OCCUPANCY_BUCKETS)
        self.registry.register(PhaseHistogramCollector(
            "tpu:kvpool_alloc_occupancy",
            "Pool occupancy fraction observed at each allocation attempt",
            self.kvpool_occ_hist))
        # kvplane: migration and warm (counted on the admin paths),
        # defrag and the pipelined prefetch (delta-synced), the tier
        # codecs' accounting
        self.kvplane_migrations = counter(
            "tpu:kvplane_migrations_total",
            "Sequences migrated out (published to the tiers and "
            "preempted) by /admin/kvplane/migrate_out")
        self.kvplane_migrated_blocks = counter(
            "tpu:kvplane_migrated_blocks_total",
            "KV pool blocks freed by migrate_out victims")
        self.kvplane_warmed_chunks = counter(
            "tpu:kvplane_warmed_chunks_total",
            "Chunks pulled warm by /admin/kvplane/warm (destination "
            "side of a migration: tier hits promoted into the fastest "
            "local tier)")
        self.kvplane_migrated_chunks = counter(
            "tpu:kvplane_migrated_chunks_total",
            "Chunks published by the migration source path "
            "(connector.on_migrate)")
        self.kvplane_defrag_runs = counter(
            "tpu:kvplane_defrag_runs_total",
            "Free-list compactions run between fused windows")
        self.kvplane_defrag_block_moves = counter(
            "tpu:kvplane_defrag_block_moves_total",
            "Free-list positions reordered by defrag")
        self.kvplane_free_contiguity = gauge(
            "tpu:kvplane_free_contiguity",
            "Fraction of adjacent free-block-id pairs (1.0 = one dense "
            "run; the quantity defrag restores)")
        self.kvplane_chunk_deadline_hits = counter(
            "tpu:kvplane_prefetch_chunk_deadline_hits_total",
            "Prefetch walks cut because one chunk blew its fair-share "
            "slice of the budget (per-remaining-chunk accounting)")
        self.kvplane_pipelined_fetches = counter(
            "tpu:kvplane_pipelined_fetches_total",
            "Chunk reads issued while an earlier chunk was still "
            "being consumed (pipelined prefetch overlap)")
        self._kvplane_codec_bytes_in = Counter(
            "tpu:kvplane_codec_bytes_in",
            "Logical chunk-body bytes entering a tier codec's encoder",
            list(labels) + ["tier", "codec"], registry=self.registry)
        self._kvplane_codec_bytes_out = Counter(
            "tpu:kvplane_codec_bytes_out",
            "Encoded bytes written to the tier (bytes_in/bytes_out = "
            "the tier's capacity multiplier)",
            list(labels) + ["tier", "codec"], registry=self.registry)
        self._kvplane_codec_rejects = Counter(
            "tpu:kvplane_codec_rejects",
            "Encoded payloads rejected by the post-encode checksum "
            "(torn/corrupt values read as misses and evicted)",
            list(labels) + ["tier", "codec"], registry=self.registry)
        self._labels = labels
        self._kv_last: dict = {}
        self._eff_last: dict = {}
        self._kvpool_last: dict = {}

    # connector stats_report() totals -> counters
    _KV_COUNTER_KEYS = (
        ("query_tokens", "kv_query_tokens"),
        ("hit_tokens", "kv_hit_tokens"),
        ("foreign_hit_tokens", "kv_foreign_hit_tokens"),
        ("chunk_hits", "kv_chunk_hits"),
        ("chunk_misses", "kv_chunk_misses"),
        ("bytes_loaded", "kv_bytes_loaded"),
        ("bytes_saved", "kv_bytes_saved"),
        ("rejected_chunks", "kv_rejected_chunks"),
        ("dropped_saves", "kv_dropped_saves"),
        ("published_chunks", "kv_published_chunks"),
        ("progress_published_chunks", "kv_progress_published_chunks"),
        ("prefetch_chunk_deadline_hits", "kvplane_chunk_deadline_hits"),
        ("pipelined_fetches", "kvplane_pipelined_fetches"),
        ("migrated_chunks", "kvplane_migrated_chunks"),
        ("warmed_chunks", "kvplane_warmed_chunks"),
    )

    def _delta_inc(self, metric, last: dict, key: str, total) -> None:
        delta = total - last.get(key, 0)
        if delta > 0:
            metric.inc(delta)
        last[key] = total

    def sync_kv(self, report: dict) -> None:
        """Fold a connector ``stats_report()`` in: counters advance by
        their deltas, the role, breaker and tier gauges are set."""
        for src, attr in self._KV_COUNTER_KEYS:
            self._delta_inc(getattr(self, attr), self._kv_last, src,
                            report.get(src, 0))
        for tier, total in (report.get("tier_hits") or {}).items():
            self._delta_inc(
                self._kv_tier_hits.labels(tier=tier, **self._labels),
                self._kv_last, f"tier_hits:{tier}", total)
        self.kv_remote_breaker_open.set(
            1.0 if report.get("remote_breaker_open") else 0.0)
        role = report.get("role")
        if role:
            self._kv_role.labels(role=role, **self._labels).set(1.0)
        for tier, st in (report.get("tiers") or {}).items():
            self._kv_tier_bytes.labels(tier=tier, **self._labels).set(
                st.get("bytes", 0))
            self._kv_tier_items.labels(tier=tier, **self._labels).set(
                st.get("count", 0))
        for row in report.get("codecs") or []:
            tier, codec = row.get("tier", "?"), row.get("codec", "?")
            for src, metric in (
                    ("bytes_in", self._kvplane_codec_bytes_in),
                    ("bytes_out", self._kvplane_codec_bytes_out),
                    ("rejects", self._kvplane_codec_rejects)):
                self._delta_inc(
                    metric.labels(tier=tier, codec=codec, **self._labels),
                    self._kv_last, f"codec:{tier}:{codec}:{src}",
                    row.get(src, 0))

    def sync_eff(self, report: dict, rates: dict) -> None:
        """Fold ``EngineEffAccounting.report()/rates()`` in: token-step
        counters advance by their deltas, rate gauges are set."""
        dec = report.get("decode") or {}
        for kind in ("real", "pad", "dead"):
            self._delta_inc(
                self._token_steps.labels(kind=kind, phase="decode",
                                         **self._labels),
                self._eff_last, f"decode:{kind}", dec.get(kind, 0))
        pre = report.get("prefill") or {}
        for kind in ("real", "pad"):
            self._delta_inc(
                self._token_steps.labels(kind=kind, phase="prefill",
                                         **self._labels),
                self._eff_last, f"prefill:{kind}", pre.get(kind, 0))
        self.effective_bytes_per_s.set(
            rates.get("effective_bytes_per_s", 0.0))
        self.mbu_perc.set(rates.get("mbu_perc", 0.0))
        self.decode_live_fraction.set(rates.get("live_fraction", 0.0))

    def sync_kvpool(self, report: dict) -> None:
        """Fold a ``BlockManager.frag_report()`` in."""
        for state in ("free", "active", "cached"):
            self._kvpool_blocks.labels(state=state, **self._labels).set(
                report.get(state, 0))
        for reason in ("exhausted", "fragmented"):
            self._delta_inc(
                self._kvpool_alloc_failures.labels(reason=reason,
                                                   **self._labels),
                self._kvpool_last, reason,
                report.get(f"alloc_failures_{reason}", 0))
        self._delta_inc(self.kvpool_cache_evictions, self._kvpool_last,
                        "cache_evictions", report.get("cache_evictions", 0))
        self._delta_inc(self.kvplane_defrag_runs, self._kvpool_last,
                        "defrag_runs", report.get("defrag_runs", 0))
        self._delta_inc(self.kvplane_defrag_block_moves,
                        self._kvpool_last, "defrag_block_moves",
                        report.get("defrag_block_moves", 0))
        self.kvplane_free_contiguity.set(
            report.get("free_contiguity", 1.0))

    def render(self) -> bytes:
        return generate_latest(self.registry)
