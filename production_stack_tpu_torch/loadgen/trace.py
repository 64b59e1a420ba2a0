"""trace mode: end-to-end span-chain validation + phase attribution.

The closed loop for the tracing substrate. The rig launches a
real router in front of N engines (fake by default; optionally the full
disaggregated split — cache server + producer pool + consumer pool +
``--prefill-backends``), drives a mixed chat/rag storm, captures each
request's ``x-trace-id`` and client-observed latency, then fetches
``/debug/traces`` from the router and every engine and JOINS the three
views per trace id. It exits 1 unless the traces it claims to provide
actually exist and actually account for the time:

- **chain completeness**: >= ``min_chain_fraction`` (default 95%) of
  the requests found in the router's ring must have a complete span
  chain — a router trace whose winning ``relay`` span names an engine,
  AND that engine's ring holding the same trace id; with the split
  topology on, rag-class requests (past ``--min-prompt-chars``) must
  additionally show the ``prefill`` event span and the producer pool's
  rings must hold router-issued trace ids;
- **attribution honesty**: the router-side unattributed time (trace
  duration minus the phase-span sum) must be < ``max_unattributed``
  (default 10%) of the trace duration at the p50 — if the phases don't
  cover the request, the breakdown is decoration, not attribution;
- **zero errors**: a storm that 5xx'd or dropped transport is not a
  measurement.

The committed record (TRACE_r13.json) carries the first honest
phase-level decomposition of where a request's time goes through the
split topology — the attribution the r12 chat-ITL claim previously
could not provide — plus (``--overhead-guard``) a tracing-on re-run of
the r7 router-overhead A/B pinned inside its band.

Reproduction one-liners: docs/benchmarks.md "Request tracing";
benchmarks/run_trace.sh.
"""

import asyncio
import dataclasses
import json
import random
import time
from typing import Dict, List, Optional

import aiohttp

from production_stack_tpu_torch.loadgen.orchestrator import (Proc, _stop,
                                                       free_port,
                                                       launch_cache_server,
                                                       launch_engine,
                                                       launch_router,
                                                       wait_cache_ready,
                                                       wait_healthy)
from production_stack_tpu_torch.loadgen.report import percentile
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

CHAT_PATH = "/v1/chat/completions"


@dataclasses.dataclass
class _ClientRecord:
    trace_id: Optional[str]
    cls: str                       # chat | rag
    status: int
    e2e_s: float
    ttft_s: Optional[float]


def _words(rng: random.Random, n_chars: int) -> str:
    out, size = [], 0
    while size < n_chars:
        w = "w%04x" % rng.randrange(1 << 16)
        out.append(w)
        size += len(w) + 1
    return " ".join(out)[:n_chars]


async def _storm(router_url: str, model: str, *, duration_s: float,
                 chat_users: int, rag_users: int,
                 chat_prompt_chars: int, chat_tokens: int,
                 rag_prompt_chars: int, rag_tokens: int, seed: int,
                 request_timeout_s: float = 120.0
                 ) -> List[_ClientRecord]:
    """Closed-loop mixed storm; every request's x-trace-id + client
    latency is recorded — the client-side half of the join."""
    records: List[_ClientRecord] = []
    timeout = aiohttp.ClientTimeout(total=request_timeout_s)
    end_at = time.monotonic() + duration_s

    async def one_request(http, cls: str, rng: random.Random,
                          uid: str) -> None:
        if cls == "chat":
            prompt = f"chat {uid} " + _words(rng, chat_prompt_chars)
            max_tokens = chat_tokens
        else:
            prompt = f"rag {uid} " + _words(rng, rag_prompt_chars)
            max_tokens = rag_tokens
        body = json.dumps({
            "model": model, "stream": True, "max_tokens": max_tokens,
            "messages": [{"role": "user", "content": prompt}]}).encode()
        t0 = time.monotonic()
        first_at = None
        try:
            async with http.post(
                    f"{router_url}{CHAT_PATH}", data=body,
                    headers={"Content-Type": "application/json"},
                    timeout=timeout) as resp:
                trace_id = resp.headers.get("x-trace-id")
                async for raw_line in resp.content:
                    if first_at is None and raw_line.strip():
                        first_at = time.monotonic()
                records.append(_ClientRecord(
                    trace_id=trace_id, cls=cls, status=resp.status,
                    e2e_s=time.monotonic() - t0,
                    ttft_s=None if first_at is None else first_at - t0))
        except (aiohttp.ClientError, ConnectionError, OSError,
                asyncio.TimeoutError) as e:
            records.append(_ClientRecord(
                trace_id=None, cls=cls, status=-1,
                e2e_s=time.monotonic() - t0, ttft_s=None))
            logger.warning("storm request failed: %s: %s",
                           type(e).__name__, e)

    async def user(cls: str, i: int) -> None:
        rng = random.Random(seed * 104729 + (0 if cls == "chat"
                                             else 1 << 20) + i)
        k = 0
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0)) as http:
            while time.monotonic() < end_at:
                await one_request(http, cls, rng, f"{i}-{k}")
                k += 1

    await asyncio.gather(
        *[user("chat", i) for i in range(chat_users)],
        *[user("rag", i) for i in range(rag_users)])
    return records


async def _fetch_traces(url: str, limit: int = 100000) -> Dict[str, dict]:
    """{trace_id: trace} from one process's /debug/traces ring.
    Carries the engine Bearer when ENGINE_API_KEY is exported —
    /debug/traces is auth-enforced on secured engines (per-request
    data, unlike the probe endpoints)."""
    from production_stack_tpu_torch.router.service_discovery import (
        engine_auth_headers)
    try:
        async with aiohttp.ClientSession() as http:
            async with http.get(
                    f"{url}/debug/traces", params={"limit": str(limit)},
                    headers=engine_auth_headers(),
                    timeout=aiohttp.ClientTimeout(total=10)) as r:
                data = await r.json()
    except (aiohttp.ClientError, ConnectionError, OSError,
            asyncio.TimeoutError, ValueError):
        return {}
    return {t["trace_id"]: t for t in data.get("traces", [])}


def _span_names(trace: dict) -> set:
    return {s["name"] for s in trace.get("spans", [])}


def _relay_server(trace: dict) -> Optional[str]:
    """The engine the winning attempt relayed from (the last relay /
    backend_ttfb span's server attr)."""
    for span in reversed(trace.get("spans", [])):
        if span["name"] in ("relay", "backend_ttfb"):
            return (span.get("attrs") or {}).get("server")
    return None


def _phase_breakdown(traces: List[dict]) -> Dict[str, dict]:
    """Per-phase p50/p99 ms + share of total attributed time."""
    per_phase: Dict[str, List[float]] = {}
    for t in traces:
        sums: Dict[str, float] = {}
        for s in t.get("spans", []):
            if s["kind"] == "phase":
                sums[s["name"]] = sums.get(s["name"], 0.0) \
                    + s["duration_ms"]
        for name, ms in sums.items():
            per_phase.setdefault(name, []).append(ms)
        per_phase.setdefault("unattributed", []).append(
            t.get("unattributed_ms", 0.0))
    total = sum(sum(v) for v in per_phase.values()) or 1.0
    return {
        name: {
            "p50_ms": round(percentile(vals, 50), 2),
            "p99_ms": round(percentile(vals, 99), 2),
            "share_pct": round(100.0 * sum(vals) / total, 1),
            "requests": len(vals),
        }
        for name, vals in sorted(per_phase.items())
    }


def _join(client_records: List[_ClientRecord], router_traces: Dict,
          engine_traces: Dict[str, Dict], prefill_urls: List[str],
          min_prompt_chars_hit_cls: Optional[str]) -> Dict:
    """The three-way join: client records x router ring x engine rings.
    ``sampled`` = client requests whose trace id the router ring still
    holds (ring churn drops the oldest; the gate applies to what IS
    held — a held trace must be complete)."""
    sampled = complete = with_engine_side = 0
    unattributed_pct: List[float] = []
    joined_cls: Dict[str, List[dict]] = {}
    for rec in client_records:
        if rec.trace_id is None or rec.trace_id not in router_traces:
            continue
        rt = router_traces[rec.trace_id]
        sampled += 1
        dur = rt.get("duration_ms") or 0.0
        if dur > 0:
            unattributed_pct.append(
                100.0 * rt.get("unattributed_ms", 0.0) / dur)
        server = _relay_server(rt)
        engine_side = server is not None and \
            rec.trace_id in engine_traces.get(server, {})
        chain_ok = engine_side
        if chain_ok and min_prompt_chars_hit_cls is not None \
                and rec.cls == min_prompt_chars_hit_cls:
            # split topology: the long-prompt class must ALSO show the
            # prefill stage in its router trace (router->prefill->decode)
            chain_ok = "prefill" in _span_names(rt)
        if engine_side:
            with_engine_side += 1
        if chain_ok:
            complete += 1
        joined_cls.setdefault(rec.cls, []).append(rt)
    # only ROUTER-ISSUED ids count as prefill-stage evidence: a
    # producer minting fresh contexts (a broken traceparent forward)
    # must read as zero, not as a full ring
    prefill_trace_ids = set()
    for url in prefill_urls:
        prefill_trace_ids |= (set(engine_traces.get(url, {}))
                              & set(router_traces))
    return {
        "client_requests": len(client_records),
        "sampled": sampled,
        "with_engine_side": with_engine_side,
        "complete_chains": complete,
        "chain_fraction": round(complete / sampled, 4) if sampled else 0.0,
        "unattributed_p50_pct": round(
            percentile(unattributed_pct, 50), 2) if unattributed_pct
        else None,
        "unattributed_p99_pct": round(
            percentile(unattributed_pct, 99), 2) if unattributed_pct
        else None,
        "prefill_ring_traces": len(prefill_trace_ids),
        "phase_breakdown": {cls: _phase_breakdown(ts)
                            for cls, ts in sorted(joined_cls.items())},
    }


async def run_trace(*, engines: int = 2, engine: str = "fake",
                    disagg: bool = False,
                    prefill_engines: int = 2, decode_engines: int = 2,
                    chat_users: int = 6, rag_users: int = 3,
                    duration_s: float = 20.0,
                    chat_prompt_chars: int = 96, chat_tokens: int = 24,
                    rag_prompt_chars: int = 2400, rag_tokens: int = 4,
                    tokens_per_s: float = 40.0,
                    prefill_ms_per_char: float = 0.4,
                    interference: float = 1.5,
                    kv_chunk_chars: int = 64,
                    headstart_s: float = 3.0,
                    min_prompt_chars: int = 512,
                    routing: str = "least_loaded", seed: int = 0,
                    ring_entries: int = 16384,
                    platform: str = "cuda",
                    log_dir: str = "loadgen-logs",
                    startup_timeout_s: float = 420.0,
                    overhead_guard: bool = False,
                    overhead_users: int = 48,
                    overhead_duration_s: float = 10.0) -> Dict:
    """Launch the topology, storm it, join the spans, return the
    BENCH-schema record (headline value = complete-chain %)."""
    procs: List[Proc] = []
    prefill_procs: List[Proc] = []
    model = "fake-model" if engine == "fake" else engine
    try:
        cache_url = None
        if disagg:
            cache = launch_cache_server(free_port(), log_dir=log_dir)
            procs.append(cache)
            await wait_cache_ready(cache.url)
            cache_url = cache.url

        def fake_args(role: Optional[str]) -> List[str]:
            args = ["--num-tokens", str(max(chat_tokens, rag_tokens)),
                    "--tokens-per-s", str(tokens_per_s),
                    "--prefill-ms-per-char", str(prefill_ms_per_char),
                    "--prefill-decode-interference", str(interference),
                    "--trace-ring-entries", str(ring_entries)]
            if role is not None:
                args += ["--kv-role", role,
                         "--kv-remote-url", cache_url,
                         "--kv-chunk-chars", str(kv_chunk_chars)]
            return args

        def real_args(role: Optional[str]) -> List[str]:
            args = ["--trace-ring-entries", str(ring_entries)]
            if role is not None:
                args += ["--kv-transfer-config",
                         json.dumps({"kv_role": role, "chunk_size": 16,
                                     "remote_url": cache_url})]
            return args

        mk = fake_args if engine == "fake" else real_args
        if disagg:
            prefill_procs = [launch_engine(engine, free_port(),
                                           log_dir=log_dir,
                                           platform=platform,
                                           extra_args=mk("kv_producer"))
                             for _ in range(prefill_engines)]
            decode_procs = [launch_engine(engine, free_port(),
                                          log_dir=log_dir,
                                          platform=platform,
                                          extra_args=mk("kv_consumer"))
                            for _ in range(decode_engines)]
        else:
            prefill_procs = []
            decode_procs = [launch_engine(engine, free_port(),
                                          log_dir=log_dir,
                                          platform=platform,
                                          extra_args=mk(None))
                            for _ in range(engines)]
        procs.extend(prefill_procs)
        procs.extend(decode_procs)
        await asyncio.gather(*[wait_healthy(e.url, startup_timeout_s)
                               for e in prefill_procs + decode_procs])

        router_extra = ["--engine-stats-interval", "2",
                        "--trace-ring-entries", str(ring_entries)]
        if disagg:
            router_extra += [
                "--prefill-backends",
                ",".join(e.url for e in prefill_procs),
                "--prefill-models",
                ",".join([model] * len(prefill_procs)),
                "--prefill-headstart", str(headstart_s),
                "--disagg-min-prompt-chars", str(min_prompt_chars),
            ]
        router = launch_router([e.url for e in decode_procs], model,
                               free_port(), routing=routing,
                               log_dir=log_dir, extra_args=router_extra)
        procs.append(router)
        await wait_healthy(router.url, 60.0,
                           require_endpoints=len(decode_procs))

        t0 = time.monotonic()
        client_records = await _storm(
            router.url, model, duration_s=duration_s,
            chat_users=chat_users, rag_users=rag_users,
            chat_prompt_chars=chat_prompt_chars,
            chat_tokens=chat_tokens,
            rag_prompt_chars=rag_prompt_chars, rag_tokens=rag_tokens,
            seed=seed)
        elapsed = time.monotonic() - t0

        router_traces = await _fetch_traces(router.url)
        engine_traces = {}
        for p in prefill_procs + decode_procs:
            engine_traces[p.url] = await _fetch_traces(p.url)
    finally:
        _stop(procs)

    rag_gated = disagg and rag_prompt_chars >= min_prompt_chars > \
        chat_prompt_chars
    join = _join(client_records, router_traces, engine_traces,
                 [p.url for p in prefill_procs],
                 "rag" if rag_gated else None)
    errors = sum(1 for r in client_records if r.status != 200)

    def side_pct(vals, p):
        return round(percentile(vals, p) * 1e3, 2) if vals else None

    client_lat = {
        cls: {
            "e2e_ms": {"p50": side_pct(
                [r.e2e_s for r in client_records
                 if r.cls == cls and r.status == 200], 50),
                "p99": side_pct(
                [r.e2e_s for r in client_records
                 if r.cls == cls and r.status == 200], 99)},
            "ttft_ms": {"p50": side_pct(
                [r.ttft_s for r in client_records
                 if r.cls == cls and r.ttft_s is not None], 50)},
        }
        for cls in ("chat", "rag") if rag_users or cls == "chat"
    }

    detail = {
        "engine": engine,
        "disagg": disagg,
        "topology": (f"{len(prefill_procs)}P+{len(decode_procs)}D"
                     if disagg else f"{len(decode_procs)} aggregated"),
        "duration_s": round(elapsed, 1),
        "chat_users": chat_users, "rag_users": rag_users,
        "min_prompt_chars": min_prompt_chars if disagg else None,
        "errors": errors,
        "client_latency": client_lat,
        "join": join,
    }

    if overhead_guard:
        # the r7 guard, tracing on: same A/B, same band — tracing must
        # be free enough to leave on in production
        from production_stack_tpu_torch.loadgen.overhead import run_overhead
        logger.info("trace: running the tracing-on overhead guard "
                    "(%d users, %.0fs per side)...", overhead_users,
                    overhead_duration_s)
        guard = await run_overhead(
            engine="fake", users=overhead_users,
            duration_s=overhead_duration_s, platform=platform,
            log_dir=log_dir, startup_timeout_s=startup_timeout_s)
        detail["overhead_guard"] = {
            "direct_req_per_s": guard["detail"]["direct"]["req_per_s"],
            "router_req_per_s": guard["detail"]["router"]["req_per_s"],
            "overhead_ratio": guard["detail"]["overhead_ratio"],
            "errors": (guard["detail"]["direct"]["errors"]
                       + guard["detail"]["router"]["errors"]),
        }

    return {
        "metric": "end-to-end trace completeness + phase attribution "
                  "(router/engine span chains joined by trace id)",
        "value": round(100.0 * join["chain_fraction"], 2),
        "unit": "% complete span chains",
        "platform": platform,
        "detail": detail,
    }


def trace_violations(record: Dict, min_chain_fraction: float = 0.95,
                     max_unattributed_pct: float = 10.0,
                     max_overhead_ratio: Optional[float] = None
                     ) -> List[str]:
    """The pass/fail contract ``loadgen trace`` enforces (exit 1)."""
    out: List[str] = []
    d = record["detail"]
    join = d["join"]
    if d["errors"]:
        out.append(f"{d['errors']} client-visible errors — the storm "
                   f"is not a measurement")
    if join["sampled"] == 0:
        out.append("router trace ring held none of the storm's trace "
                   "ids (ring too small, or x-trace-id missing)")
    elif join["chain_fraction"] < min_chain_fraction:
        out.append(
            f"only {100 * join['chain_fraction']:.1f}% of sampled "
            f"requests have a complete span chain "
            f"(need >= {100 * min_chain_fraction:.0f}%): "
            f"{join['complete_chains']}/{join['sampled']} "
            f"({join['with_engine_side']} had the engine side)")
    una = join.get("unattributed_p50_pct")
    if una is None:
        out.append("no unattributed-time samples (no joined traces)")
    elif una >= max_unattributed_pct:
        out.append(f"unattributed time p50 {una:.1f}% >= "
                   f"{max_unattributed_pct:.0f}% — the phases do not "
                   f"cover the request")
    if d["disagg"] and join["prefill_ring_traces"] == 0:
        out.append("split topology but the prefill pool's trace rings "
                   "hold no router-issued trace ids (prefill stage "
                   "invisible)")
    guard = d.get("overhead_guard")
    if max_overhead_ratio is not None:
        if guard is None:
            out.append("--max-overhead-ratio set but the guard did "
                       "not run")
        elif guard["errors"]:
            out.append(f"overhead guard saw {guard['errors']} errors")
        elif guard["overhead_ratio"] and \
                guard["overhead_ratio"] > max_overhead_ratio:
            out.append(f"tracing-on overhead ratio "
                       f"{guard['overhead_ratio']:.2f}x exceeds the "
                       f"{max_overhead_ratio:g}x band")
    return out
