"""The hot path: proxy an OpenAI request to a chosen engine, streaming.

Capability parity with reference src/vllm_router/services/request_service/
request.py:44-196 (body parse -> model filter -> route -> stream relay ->
stats hooks -> response), re-designed on one shared aiohttp
ClientSession around a zero-rework fast path:

- the body is parsed ONCE and the client's raw bytes are forwarded
  untouched unless a rewriter / cache knob / disagg hook actually
  mutated them (byte-identical passthrough is pinned by
  tests/test_router_fastpath.py);
- the static forward-header overlay (the router's engine Bearer) and
  the client timeout object are built at app startup, not per request;
- the streaming loop does one bare attribute increment per chunk on an
  ActiveRequest record (stats.py) — all window math runs at
  on_request_complete;
- routing reads RequestStatsMonitor.snapshot() (window aggregates
  cached ~50 ms, in-flight counters live) instead of recomputing every
  engine's sliding windows per request;
- small non-streaming backend responses (Content-Length present, no
  event-stream) are relayed as ONE buffered write instead of a
  prepare/chunk/eof sequence.

The committed A/B for all of this is
``python -m production_stack_tpu_torch.loadgen overhead``
(BASELINE.md Round 7; docs/benchmarks.md "Router performance").

Resilience (resilience.py, BASELINE.md Round 8): candidates are
filtered to breaker-closed/non-draining endpoints before routing, and
failures occurring *before any byte reaches the client* (connect
error, refusal, timeout, backend 5xx) mark the endpoint in the health
tracker and fail over to the remaining candidates — bounded by
``--failover-attempts``, a global retry budget, and jittered backoff.
Mid-stream failures still truncate: relayed bytes cannot be replayed.
The closed loop is ``python -m production_stack_tpu_torch.loadgen chaos``.
"""

import asyncio
import json
import time
import uuid
from typing import Optional

import aiohttp
from aiohttp import web

from production_stack_tpu_torch.router.resilience import backoff_s
from production_stack_tpu_torch.router.rewriter import NoopRequestRewriter
from production_stack_tpu_torch.slo import CLASS_HEADER, classify_request
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

HOP_HEADERS = {"host", "content-length", "transfer-encoding", "connection",
               "keep-alive", "te", "upgrade",
               # aiohttp's client auto-decompresses, so encoding headers
               # must not leak through in either direction
               "accept-encoding", "content-encoding"}

# Router-level cache knobs (consumed by semantic_cache.SemanticCache,
# which imports this tuple): stripped from forwarded bodies because they
# are not OpenAI fields and strict backends reject unknown params.
# Defined here, not in semantic_cache, so the hot proxy path never pulls
# in numpy/kvcache when the cache gate is off.
CACHE_CONTROL_FIELDS = ("skip_cache", "cache_similarity_threshold")

# buffered-relay cap: a non-streaming backend response up to this size
# is read whole and written in one shot; anything bigger (or chunked,
# or an event stream) goes through the chunk relay loop
BUFFERED_RESPONSE_MAX = 4 * 1024 * 1024

# overload-protection wire signals (mirrored in engine/server.py; the
# router must not import the engine package)
DEADLINE_HEADER = "x-request-deadline-ms"
DEADLINE_MARKER = "x-deadline-expired"


def _copy_backend_headers(resp: web.StreamResponse,
                          backend: aiohttp.ClientResponse) -> None:
    for k, v in backend.headers.items():
        if k.lower() not in HOP_HEADERS:
            resp.headers[k] = v


def _log_store_failure(fut) -> None:
    e = fut.exception()
    if e is not None:
        logger.warning("semantic cache store failed: %s", e)


def _store_cached_response(semantic_cache, body: dict,
                           payload: bytes) -> None:
    """Fire-and-forget semantic-cache store: the sync CPU embed +
    index insert must never sit between the handler and the client."""
    try:
        response_body = json.loads(payload)
    except Exception as e:
        logger.warning("semantic cache store failed: %s", e)
        return
    fut = asyncio.get_running_loop().run_in_executor(
        None, semantic_cache.store, body, response_body)
    fut.add_done_callback(_log_store_failure)


class _ClientDisconnect(Exception):
    """The CLIENT side of the relay died (reset/broken pipe writing to
    it). Distinct from backend failures: it must produce no health
    signal against the engine and no retry — nobody is listening."""


class _Preempted(Exception):
    """A higher-priority request took this one's admission slot
    (router/qos.py). Raised only while the backend dispatch is in
    flight and no byte has reached the client; the handler answers a
    structured 503 + Retry-After."""


class _PreemptableRequest:
    """Races a backend dispatch against a preemption event. Wraps the
    aiohttp request context manager ONLY for preemptable-tier requests
    — the untiered/tier-0 hot path never allocates any of this."""

    __slots__ = ("_ctx", "_event")

    def __init__(self, ctx, event: asyncio.Event):
        self._ctx = ctx
        self._event = event

    async def __aenter__(self):
        req_task = asyncio.ensure_future(self._ctx.__aenter__())
        waiter = asyncio.ensure_future(self._event.wait())
        try:
            await asyncio.wait({req_task, waiter},
                               return_when=asyncio.FIRST_COMPLETED)
        except asyncio.CancelledError:
            # the HANDLER was cancelled (client disconnect): reap the
            # in-flight dispatch too — asyncio.wait never cancels its
            # pending futures, and a detached request task would pin
            # its pooled connection until GC
            req_task.cancel()
            try:
                await req_task
            except (asyncio.CancelledError, Exception):
                pass
            raise
        finally:
            waiter.cancel()
        if req_task.done():
            return req_task.result()
        # preempted mid-dispatch: cancelling the request coroutine
        # closes the backend connection, so the engine sees the abort
        req_task.cancel()
        try:
            await req_task
        except (asyncio.CancelledError, Exception):
            pass
        raise _Preempted()

    async def __aexit__(self, *exc):
        return await self._ctx.__aexit__(*exc)


# client-leg transport failures (raised by resp.prepare/write/write_eof)
_CLIENT_LEG_ERRORS = (OSError, RuntimeError, aiohttp.ClientError)


def _can_retry(attempt: int, max_attempts: int, tried: set,
               candidates, budget) -> bool:
    """Pre-stream failover gate: attempts left, an untried candidate
    left, and a retry-budget token available."""
    return (attempt < max_attempts
            and len(tried) + 1 < len(candidates)
            and (budget is None or budget.try_spend()))


def _forward_headers(request: web.Request, auth_overlay: dict,
                     deadline_overlay: Optional[dict] = None) -> dict:
    headers = {k: v for k, v in request.headers.items()
               if k.lower() not in HOP_HEADERS}
    # membership test on the CIMultiDict (case-insensitive): a lowercase
    # 'authorization' must suppress injection too, or the upstream
    # request would carry both the client's and the router's Bearer.
    # engines enforcing ENGINE_API_KEY (engine/server.py) accept the
    # router's own key for clients trusted at the router boundary; a
    # client-provided Bearer always passes through untouched
    if auth_overlay and "Authorization" not in request.headers:
        headers.update(auth_overlay)
    # deadline propagation: the client's x-request-deadline-ms passes
    # through untouched (it is not hop-by-hop); when the client sent
    # none, the router's own --request-timeout becomes the downstream
    # deadline so the engine can drop the request from its queue the
    # moment the router would have given up on it anyway
    if deadline_overlay and DEADLINE_HEADER not in request.headers:
        headers.update(deadline_overlay)
    return headers


def _endpoint_cap(state, url: str, scraper_stats=None) -> float:
    """Concurrency cap for one endpoint: the static override
    (--endpoint-inflight-cap) when set, else the capacity the engine
    advertises on /metrics (tpu:engine_capacity_seqs, scraped by
    EngineStatsScraper; 0 = unbounded admission -> no cap).
    ``scraper_stats`` lets the failover loop snapshot the scraper once
    per routing pass instead of once per candidate.

    Both caps are FLEET-wide bounds: with peer routers configured
    (shared_state.RouterPeers) each router enforces only its share —
    cap / live-router-count, floored at 1 — so N routers together
    still respect the engine's advertised capacity instead of
    N-times it, and a dead peer's share flows back to the survivors
    once gossip marks it stale."""
    peers = state.get("peers")
    share = peers.cap_share() if peers is not None else 1.0
    static = state.get("endpoint_cap") or 0
    if static > 0:
        return max(1.0, float(static) * share)
    if scraper_stats is None:
        scraper = state.get("scraper")
        if scraper is None:
            return float("inf")
        scraper_stats = scraper.get()
    es = scraper_stats.get(url)
    if es is None or es.capacity <= 0:
        return float("inf")
    return max(1.0, es.capacity * share)


def _under_cap(state, ep, request_stats, scraper_stats) -> bool:
    """Endpoint below its concurrency cap (or uncapped / never seen).
    Shared by the routing loop's under-cap filter and the disagg
    saturation pre-check — the pre-check exists to predict the loop's
    shed decision, so the two must never diverge."""
    rs = request_stats.get(ep.url)
    return rs is None or \
        rs.in_flight < _endpoint_cap(state, ep.url, scraper_stats)


def _shed_response(status: int, message: str,
                   retry_after_s: float = 1.0) -> web.Response:
    resp = web.json_response(
        {"error": {"message": message, "type": "overloaded_error"}},
        status=status)
    resp.headers["Retry-After"] = str(max(1, int(retry_after_s)))
    return resp


def _preempted_response(tier) -> web.Response:
    """Structured answer for a preempted background request: the same
    shed wire shape (503 + Retry-After), so clients back off and the
    SLO engine classifies it as intentional backpressure, never an
    availability burn."""
    return _shed_response(
        503, f"preempted: tier {tier.name} admission slot taken by "
             f"higher-priority traffic; retry later")


# response header carrying the request's trace id (stamped on EVERY
# response, sheds and errors included) so a client-side harness can
# join client-observed latency to the server-side span chain
# (docs/observability.md "Tracing"; the closed loop is
# ``python -m production_stack_tpu_torch.loadgen trace``)
TRACE_ID_HEADER = "x-trace-id"


def _slo_observe(state, endpoint_path: str, request: web.Request,
                 resp: Optional[web.StreamResponse], trace,
                 final_status: str = "ok", tier=None) -> None:
    """Feed the SLO engine one finished request — a handful of bucket
    increments, taken from state already at hand (the response and the
    trace's phase spans). Client disconnects are skipped entirely: the
    caller vanished, so neither availability nor latency was observed
    by anyone. A QoS tier becomes the request's SLO class (unless the
    client named one explicitly) so per-tier objectives — e.g. the
    default tier0_shed_rate — see per-tier traffic."""
    slo = state.get("slo")
    if slo is None or resp is None or final_status == "client_disconnect":
        return
    cls = None
    if tier is not None:
        from production_stack_tpu_torch.slo import CLASS_HEADER
        if CLASS_HEADER not in request.headers:
            cls = tier.name
    t0 = trace.t0
    ttft = None
    for name, kind, start, dur, _status, _attrs in trace.spans:
        if kind == "phase" and name == "backend_ttfb" \
                and start is not None:
            ttft = start + dur - t0
            break
    slo.observe_response(endpoint_path, request.headers, resp.status,
                         resp.headers, ttft_s=ttft,
                         e2e_s=time.monotonic() - t0,
                         truncated=(final_status == "truncated"),
                         cls=cls)


def _finish_trace(state, trace, status: str) -> None:
    """Seal the request trace into the ring and fold its phase spans
    into the tpu:request_phase_seconds histograms — ONE pass at request
    end, so the relay hot loop never touches histogram state. Event
    spans (abandoned failover attempts, decode-selection detail) ride
    in the trace only: phases must sum to at most the request's wall
    time or unattributed-time accounting goes negative."""
    state["tracer"].finish(trace, status)
    phases = state["metrics"].request_phases
    for name, kind, _start, dur, _status, attrs in trace.spans:
        if kind == "phase":
            phases.observe(name, (attrs or {}).get("server", ""), dur)


async def route_general_request(request: web.Request,
                                endpoint_path: str) -> web.StreamResponse:
    """Proxy `request` to an engine chosen by the app's routing policy.

    Router-wide admission gate first (--max-inflight): past the bound,
    shed with 429 + Retry-After BEFORE parsing the body — protecting
    the router's own event loop is the last line of defense when every
    engine-side bound has already been blown through."""
    state = request.app["state"]
    trace = state["tracer"].begin(request.headers.get("traceparent"),
                                  name=endpoint_path)
    # the request's SLO class rides on the trace so a cross-process
    # reader (the obsplane stitcher) can bucket fleet percentiles per
    # class without re-deriving header semantics; a QoS tier overrides
    # it below exactly the way _slo_observe's classification does
    trace.attrs["class"] = classify_request(endpoint_path,
                                            request.headers)
    max_inflight = state.get("max_inflight") or 0
    qos = state.get("qos")
    tier = None
    if qos is not None:
        # graduated, low-tier-first admission (router/qos.py): each
        # tier hits its own fraction of the --max-inflight gate, its
        # optional token bucket applies pressure or not, and a top-tier
        # arrival at the full gate may preempt a background dispatch
        # instead of shedding
        tier = qos.resolve(request.headers)
        if CLASS_HEADER not in request.headers:
            trace.attrs["class"] = tier.name
        tenant = qos.resolve_tenant(request.headers)
        verdict, _victim = qos.admit(tier, state["proxied_inflight"],
                                     max_inflight, tenant=tenant)
        if verdict == "shed":
            state["shed_counts"]["admission"] += 1
            resp = _shed_response(
                429, f"router overloaded: priority tier {tier.name} "
                     f"is past its admission bound "
                     f"({state['proxied_inflight']} in flight, "
                     f"--max-inflight {max_inflight}); retry later"
                if tenant is None else
                f"tenant {tenant} is over its per-tenant rate in "
                f"tier {tier.name}, or the tier is past its admission "
                f"bound; retry later")
            resp.headers[TRACE_ID_HEADER] = trace.trace_id
            _slo_observe(state, endpoint_path, request, resp, trace,
                         tier=tier)
            _finish_trace(state, trace, "shed")
            return resp
    elif max_inflight and state["proxied_inflight"] >= max_inflight:
        state["shed_counts"]["admission"] += 1
        resp = _shed_response(
            429, f"router overloaded: {state['proxied_inflight']} "
                 f"requests already in flight (--max-inflight "
                 f"{max_inflight}); retry later")
        resp.headers[TRACE_ID_HEADER] = trace.trace_id
        _slo_observe(state, endpoint_path, request, resp, trace)
        _finish_trace(state, trace, "shed")
        return resp
    state["proxied_inflight"] += 1
    if qos is not None:
        qos.on_start(tier)
    try:
        resp = await _proxy_request(request, endpoint_path, trace, tier)
    except BaseException as e:
        if not isinstance(e, asyncio.CancelledError):
            # an escaped handler exception becomes aiohttp's own 500 —
            # client-visible, so it must burn availability like any
            # other 5xx (a router-side bug 500ing every request is
            # exactly the outage class the SLO engine exists to catch);
            # cancellation is the client disconnecting, observed by
            # nobody
            slo = state.get("slo")
            if slo is not None:
                slo.observe_response(endpoint_path, request.headers,
                                     500, None)
        _finish_trace(state, trace, "exception")
        raise
    finally:
        state["proxied_inflight"] -= 1
        if qos is not None:
            qos.on_complete(tier)
    if resp is not None and not resp.prepared:
        # prepared (streaming / relayed) responses were stamped before
        # resp.prepare inside the relay; everything else — error JSON,
        # sheds, cache hits — is stamped here
        resp.headers[TRACE_ID_HEADER] = trace.trace_id
    status = trace.attrs.get("final_status", "ok")
    if status == "ok" and resp is not None and resp.status >= 400:
        status = f"http_{resp.status}"
    _slo_observe(state, endpoint_path, request, resp, trace, status,
                 tier=tier)
    _finish_trace(state, trace, status)
    return resp


async def _proxy_request(request: web.Request,
                         endpoint_path: str,
                         trace, tier=None) -> web.StreamResponse:
    app = request.app
    state = app["state"]
    t_route0 = time.monotonic()

    # the PII middleware may have redacted the body (read-once request;
    # the sanitized copy is stashed on the request object)
    raw = request.get("pii_sanitized_raw") or await request.read()
    try:
        body = json.loads(raw) if raw else {}
    except (json.JSONDecodeError, UnicodeDecodeError):
        return web.json_response(
            {"error": {"message": "request body is not valid JSON",
                       "type": "invalid_request_error"}}, status=400)
    model = body.get("model")
    if not model:
        return web.json_response(
            {"error": {"message": "missing 'model' field",
                       "type": "invalid_request_error"}}, status=400)

    # optional pluggable rewrite hook (the exact noop default is
    # skipped so the fast path stays allocation-free; a SUBCLASS of the
    # noop must still be invoked)
    rewriter = state.get("rewriter")
    if rewriter is not None and \
            type(rewriter) is not NoopRequestRewriter:
        body, raw = rewriter.rewrite(endpoint_path, body, raw)

    # semantic cache short-circuit (gated; chat completions only) —
    # reference hooks the same spot (main_router.py:44-51 checks before
    # routing, request.py:113-117 stores after completion)
    semantic_cache = state.get("semantic_cache")
    check_cache = (semantic_cache is not None
                   and endpoint_path == "/v1/chat/completions")
    if check_cache:
        try:
            # embed + index search are sync CPU work — keep them off the
            # event loop so concurrent streams never stall behind them
            cached = await asyncio.get_running_loop().run_in_executor(
                None, semantic_cache.check, body)
        except Exception as e:
            logger.warning("semantic cache check failed: %s", e)
            cached = None
        if cached is not None:
            trace.add_phase("admission", t_route0, time.monotonic(),
                            attrs={"semantic_cache": "hit"})
            return web.json_response(cached)

    # router-level cache knobs are not OpenAI fields: strip them from the
    # forwarded bytes (strict backends reject unknown params) while the
    # local `body` keeps them for the store/capture decision below
    if any(k in body for k in CACHE_CONTROL_FIELDS):
        raw = json.dumps({k: v for k, v in body.items()
                          if k not in CACHE_CONTROL_FIELDS}).encode()

    # named pools (router/pools.py): the model picks its pool — the
    # pool's endpoints AND its own routing-policy instance. A model no
    # pool serves is an authoritative 404 (the pools table is the
    # fleet's model catalog), not the legacy 400. Without pools the
    # single-pool path below is byte-identical to before (r7 band).
    pools = state.get("pools")
    pool_router = None
    if pools is not None and pools.active:
        model_pool = pools.resolve(model)
        if model_pool is None:
            pools.note_unknown_model()
            return web.json_response(
                {"error": {"message": f"model {model!r} is not served "
                                      f"by any pool",
                           "type": "not_found_error",
                           "code": "model_not_found"}}, status=404)
        pools.note_routed(model_pool.name)
        pool_router = model_pool.router
        candidates = list(model_pool.endpoints)
    else:
        candidates = [ep for ep in state["discovery"].get_endpoints()
                      if ep.serves(model)]
    if not candidates:
        return web.json_response(
            {"error": {"message": f"no backend serves model {model!r}",
                       "type": "invalid_request_error"}}, status=400)

    # health-aware admission: every policy sees only breaker-closed,
    # non-draining endpoints (fail-open to the full set when nothing is
    # routable — see HealthTracker.healthy_endpoints)
    health = state.get("health")
    if health is not None:
        candidates = health.healthy_endpoints(candidates)

    # admission phase: body parse, rewrite, cache check, candidate
    # discovery + health filtering — everything before the disagg
    # overlap / routing decision starts
    trace.add_phase("admission", t_route0, time.monotonic())

    # disaggregated prefill: the prefill pool computes the prompt KV into
    # the shared tier (publishing chunk-by-chunk as it goes) while decode
    # routing proceeds after a bounded head-start; failures (or an open
    # breaker) degrade to a normal full prefill on the decode engine.
    # Decode selection then goes through the orchestrator's NetKV-style
    # transfer-cost scoring (disagg.DecodeSelector) for the FIRST
    # attempt; failover re-routing stays with the normal policy.
    disagg = state.get("disagg")
    disagg_active = disagg is not None and \
        disagg.should_run(endpoint_path, body)
    disagg_digests = None
    if disagg_active:
        # decode-side saturation pre-check: with EVERY candidate at its
        # concurrency cap the routing loop below sheds 503 — dispatching
        # the prefill first would burn a producer pass on a request
        # that is never served AND delay that shed by the head-start
        # (defeating Retry-After's fast-backoff intent)
        _stats0 = state["request_stats"].snapshot()
        _scraper0 = state.get("scraper")
        _sstats0 = _scraper0.get() if _scraper0 is not None else {}
        if not any(_under_cap(state, ep, _stats0, _sstats0)
                   for ep in candidates):
            disagg_active = False
    if disagg_active:
        request_id = request.headers.get("x-request-id") or \
            uuid.uuid4().hex
        # the producer's engine-side spans must join the same trace as
        # the decode engine's (router->prefill->decode chain)
        prefill_headers = {"x-request-id": request_id,
                           "traceparent": trace.child_traceparent()}
        if "Authorization" in request.headers:
            prefill_headers["Authorization"] = \
                request.headers["Authorization"]
        else:
            prefill_headers.update(state["auth_overlay"])
        # hash the prompt once; the same digest list feeds the prefill
        # dispatch, decode selection, and the locality-ring record
        disagg_digests = disagg.digests(body)
        t_pf0 = time.monotonic()
        await disagg.run_with_headstart(state["client"], endpoint_path,
                                        model, body,
                                        headers=prefill_headers,
                                        digests=disagg_digests,
                                        trace=trace)
        # the serialization the CLIENT pays before decode routing: the
        # bounded head-start wait (the prefill pass itself, which may
        # keep running in the background, is the "prefill" event span
        # the orchestrator records)
        trace.add_phase("prefill_dispatch", t_pf0, time.monotonic())

    monitor = state["request_stats"]
    session: aiohttp.ClientSession = state["client"]
    # tiered deadline budgets: the overlay injected when the client
    # sent no deadline shrinks with the tier's admit fraction, so under
    # queue buildup the engine's expiry sweep drops background work
    # first (router/qos.py "deadline budgets, low-tier-first")
    deadline_overlay = state.get("deadline_overlay")
    if tier is not None:
        overlays = state.get("qos_deadline_overlays")
        if overlays is not None:
            deadline_overlay = overlays[tier.index]
    fwd_headers = _forward_headers(request, state["auth_overlay"],
                                   deadline_overlay)
    # the engine parents its spans onto the ROUTER's span (a client-
    # supplied traceparent became this trace's parent in begin(), so
    # the client's own context is replaced, not forwarded verbatim)
    fwd_headers["traceparent"] = trace.child_traceparent()
    budget = state.get("retry_budget")
    if budget is not None:
        budget.on_request()
    max_attempts = state.get("failover_attempts", 1)
    tried: set = set()
    attempt = 0
    last_failure = ""      # human-readable cause of the final attempt
    timed_out = False      # 504 vs 502 on exhaustion
    shed_rerouted = False  # one re-route per request on upstream shed
    prefer_least_loaded = False
    last_was_shed = False  # exhaustion after a shed relays 503, not 502

    # preemption surface (router/qos.py): background-tier requests
    # register while their backend dispatch is in flight; a top-tier
    # arrival at the full admission gate may take the slot
    qos = state.get("qos")
    preempt_event: Optional[asyncio.Event] = None
    preempt_slot = None
    if qos is not None and tier is not None \
            and tier.index >= qos.preempt_from:
        preempt_event = asyncio.Event()
        preempt_slot = qos.register_preemptable(tier, preempt_event)

    # bounded pre-stream failover loop: a connect error, refusal,
    # timeout, or backend 5xx *before any byte reached the client* marks
    # the endpoint in the health tracker and re-routes among the
    # remaining candidates (jittered backoff, global retry budget).
    # Once bytes have been relayed the stream can only truncate — bytes
    # cannot be replayed.
    try:
      while True:
        if preempt_event is not None and preempt_event.is_set():
            # preempted between attempts: the slot is already gone
            trace.attrs["final_status"] = "preempted"
            return _preempted_response(tier)
        # re-read the CONFIGURED fleet each attempt: a dynamic-config
        # apply that removed an endpoint mid-failover must not see it
        # resurrected from this loop's captured candidate list
        # (pinned by tests/test_router_resilience.py)
        live = {ep.url
                for ep in state["discovery"].all_endpoints()}
        pool = [ep for ep in candidates
                if ep.url not in tried and ep.url in live]
        if not pool:
            break
        if attempt > 0:
            # de-synchronize concurrent failovers off a dying endpoint
            t_bo = time.monotonic()
            await asyncio.sleep(backoff_s(attempt))
            trace.add_phase("backoff", t_bo, time.monotonic())
        t_route = time.monotonic()
        # routing reads the TTL-cached snapshot: window aggregates at
        # most snapshot_ttl_s stale, in-flight counters live
        request_stats = state["request_stats"].snapshot()
        # per-endpoint concurrency cap (advertised engine capacity or
        # --endpoint-inflight-cap): endpoints already at their cap are
        # invisible to routing; with EVERY candidate at its cap the
        # router sheds here instead of piling more onto engines that
        # would only shed it themselves one hop later
        scraper = state.get("scraper")
        scraper_stats = scraper.get() if scraper is not None else {}
        under_cap = [ep for ep in pool
                     if _under_cap(state, ep, request_stats,
                                   scraper_stats)]
        if under_cap:
            pool = under_cap
        elif attempt == 0:
            state["shed_counts"]["endpoint_cap"] += 1
            return _shed_response(
                503, "all backends at their concurrency cap; retry "
                     "after the indicated delay")
        else:
            break      # mid-failover: relay the recorded failure
        if prefer_least_loaded:
            # post-shed re-route: go straight to the least-loaded
            # healthy endpoint (the policy's pick — e.g. a sticky
            # session's home — is the one that just shed); the ring
            # itself is untouched, so the session is NOT rehomed
            prefer_least_loaded = False
            url = min(pool, key=lambda ep:
                      request_stats[ep.url].in_flight
                      if ep.url in request_stats else 0).url
        else:
            url = None
            if disagg_active and attempt == 0:
                # two-stage decode selection: expected KV transfer
                # bytes vs scraped load; None (cold prefix / selection
                # disabled) falls through to the routing policy
                explain: dict = {}
                url = disagg.select_decode(body, pool, request_stats,
                                           scraper_stats,
                                           digests=disagg_digests,
                                           explain=explain)
                if explain:
                    # per-candidate transfer-cost inputs, in the trace
                    # only (event): the "why this decode engine" record
                    trace.add_event("decode_select", t_route,
                                    time.monotonic() - t_route,
                                    status=("cost" if url is not None
                                            else "abstain"),
                                    attrs=explain)
            if url is None:
                # the pool's own policy instance when pools are active
                # (its ring/ramp state is pool-scoped); the app-wide
                # router otherwise
                router = pool_router if pool_router is not None \
                    else state["router"]
                url = router.route(pool, request_stats,
                                   request.headers, body)
        if disagg_active:
            # the chosen decode engine will fetch-or-compute the
            # prompt chunks and hold them locally afterwards. Recorded
            # on EVERY attempt — failover re-routes and post-shed
            # least-loaded picks included (like the prefix ring, which
            # records inside route()) — and taken back out by
            # on_decode_failed when the attempt dies before a byte
            # reaches the client: only the engine that actually pulled
            # the KV stays credited
            disagg.on_decode_routed(body, url, digests=disagg_digests)
        attempt += 1
        t_attempt = time.monotonic()
        # routing phase: snapshot read + cap filter + policy/cost pick
        # (one span per attempt; histogram counts therefore tally
        # routing PASSES, not requests, under failover)
        trace.add_phase("routing", t_route, t_attempt,
                        attrs={"server": ""})
        if attempt == 1:
            logger.debug("routed %s %s -> %s (%.2fms)", endpoint_path,
                         model, url,
                         1e3 * (time.monotonic() - t_route0))
        rec = monitor.on_new_request(url)
        resp: Optional[web.StreamResponse] = None
        retry_cause: Optional[str] = None
        t_hdrs: Optional[float] = None   # backend headers received at
        decode_failed = False   # pre-stream failure: un-credit locality
        try:
            post_cm = session.post(
                f"{url}{endpoint_path}", data=raw,
                headers=fwd_headers,
                timeout=state["client_timeout"])
            if preempt_event is not None:
                # background tier: the dispatch races the preemption
                # event (the hot path takes the bare context manager)
                post_cm = _PreemptableRequest(post_cm, preempt_event)
            async with post_cm as backend:
                t_hdrs = time.monotonic()
                if preempt_slot is not None:
                    # the engine answered: preempting past this point
                    # saves almost nothing, so leave the registry now
                    # and close the picked-but-already-streaming race
                    qos.unregister_preemptable(preempt_slot)
                    preempt_slot = None
                    preempt_event = None
                shed = (backend.status in (429, 503)
                        and "Retry-After" in backend.headers)
                if shed:
                    # overload shed: the engine is healthy but full.
                    # NEVER a breaker signal (resilience.record_shed);
                    # re-route ONCE to the least-loaded healthy
                    # endpoint, then relay the 503/Retry-After so the
                    # client backs off instead of the router amplifying
                    # the overload with retries
                    if health is not None:
                        health.record_shed(url)
                    last_failure = f"backend shed (HTTP {backend.status})"
                    last_was_shed = True
                    decode_failed = True
                    if not shed_rerouted and _can_retry(
                            attempt, max_attempts, tried, candidates,
                            budget):
                        shed_rerouted = True
                        prefer_least_loaded = True
                        retry_cause = "shed"
                        continue
                elif (backend.status == 504
                        and DEADLINE_MARKER in backend.headers):
                    # the CLIENT's deadline expired in the engine's
                    # queue: relay verbatim — re-trying a request whose
                    # budget is spent helps nobody, and the engine did
                    # nothing wrong (no breaker signal)
                    if health is not None:
                        health.record_deadline_relay(url)
                elif backend.status >= 500:
                    # upstream failure that never reached the client:
                    # breaker signal, then either fail over or (when
                    # retries are exhausted) relay the backend's answer
                    if health is not None:
                        health.record_failure(url, "http_5xx")
                    last_failure = f"backend HTTP {backend.status}"
                    last_was_shed = False
                    decode_failed = True
                    if _can_retry(attempt, max_attempts, tried,
                                  candidates, budget):
                        retry_cause = last_failure
                        continue
                    if health is not None:
                        health.note_relayed_5xx(url)
                elif health is not None:
                    health.record_success(url)

                # capture the body for the semantic cache only when this
                # response is storable (non-streaming 200 on the chat
                # path)
                capture = (check_cache and backend.status == 200
                           and semantic_cache.cacheable(body))

                length = backend.headers.get("Content-Length", "")
                if length.isdigit() and \
                        int(length) <= BUFFERED_RESPONSE_MAX \
                        and "text/event-stream" not in \
                        backend.headers.get("Content-Type", ""):
                    # buffered fast path: whole body in one write (no
                    # chunked framing on the client leg); first byte and
                    # completion coincide
                    payload = await backend.read()
                    monitor.on_first_token(rec)
                    rec.tokens += 1
                    resp = web.Response(status=backend.status,
                                        body=payload)
                    _copy_backend_headers(resp, backend)
                    resp.headers[TRACE_ID_HEADER] = trace.trace_id
                    trace.add_phase("backend_ttfb", t_attempt, t_hdrs,
                                    attrs={"server": url})
                    trace.add_phase("relay", t_hdrs, time.monotonic(),
                                    attrs={"server": url})
                    if capture:
                        _store_cached_response(semantic_cache, body,
                                               payload)
                    return resp

                resp = web.StreamResponse(status=backend.status)
                _copy_backend_headers(resp, backend)
                resp.headers[TRACE_ID_HEADER] = trace.trace_id
                trace.add_phase("backend_ttfb", t_attempt, t_hdrs,
                                attrs={"server": url})
                try:
                    await resp.prepare(request)
                except _CLIENT_LEG_ERRORS as e:
                    raise _ClientDisconnect() from e
                captured = bytearray() if capture else None
                async for chunk in backend.content.iter_any():
                    if rec.first_byte is None:
                        monitor.on_first_token(rec)
                    rec.tokens += 1
                    if captured is not None:
                        captured.extend(chunk)
                    # inline (not a helper coroutine): this is the
                    # per-chunk hot loop
                    try:
                        await resp.write(chunk)
                    except _CLIENT_LEG_ERRORS as e:
                        raise _ClientDisconnect() from e
                try:
                    await resp.write_eof()
                except _CLIENT_LEG_ERRORS as e:
                    raise _ClientDisconnect() from e
                trace.add_phase("relay", t_hdrs, time.monotonic(),
                                attrs={"server": url})
                if captured is not None:
                    _store_cached_response(semantic_cache, body,
                                           bytes(captured))
                return resp
        except _Preempted:
            # a higher-priority request took this slot mid-dispatch:
            # structured 503 + Retry-After (the engine saw the abort;
            # no health signal — nothing is wrong with it)
            decode_failed = True
            trace.attrs["final_status"] = "preempted"
            return _preempted_response(tier)
        except _ClientDisconnect:
            # the client vanished mid-relay; the backend did nothing
            # wrong (a few users hitting stop must not trip a healthy
            # engine's breaker)
            logger.debug("client disconnected during relay from %s",
                         url)
            if t_hdrs is not None:
                trace.add_phase("relay", t_hdrs, time.monotonic(),
                                status="client_disconnect",
                                attrs={"server": url})
            trace.attrs["final_status"] = "client_disconnect"
            if resp is not None and resp.prepared:
                resp.force_close()
            return resp
        except asyncio.TimeoutError:
            # the configured --request-timeout fired: a structured 504,
            # not an escaped-exception 500 (aiohttp's total timeout
            # raises bare asyncio.TimeoutError, not a ClientError)
            logger.warning("backend %s timed out after %gs", url,
                           state["request_timeout"])
            if resp is not None and resp.prepared:
                if health is not None:
                    health.record_failure(url, "mid_stream")
                if t_hdrs is not None:
                    trace.add_phase("relay", t_hdrs, time.monotonic(),
                                    status="truncated",
                                    attrs={"server": url})
                trace.attrs["final_status"] = "truncated"
                resp.force_close()
                return resp
            if health is not None:
                health.record_failure(url, "timeout")
            last_failure = (f"backend timed out after "
                            f"{state['request_timeout']:g}s")
            timed_out = True
            decode_failed = True
            last_was_shed = False
            if _can_retry(attempt, max_attempts, tried, candidates,
                          budget):
                retry_cause = "timeout"
                continue
        except (aiohttp.ClientError, ConnectionError) as e:
            logger.warning("backend %s failed: %s", url, e)
            if resp is not None and resp.prepared:
                # headers already sent — a 502 body can't be delivered;
                # drop the connection so the client sees a truncated
                # stream, not a corrupted second response on the same
                # exchange
                if health is not None:
                    health.record_failure(url, "mid_stream")
                if t_hdrs is not None:
                    trace.add_phase("relay", t_hdrs, time.monotonic(),
                                    status="truncated",
                                    attrs={"server": url})
                trace.attrs["final_status"] = "truncated"
                resp.force_close()
                return resp
            if health is not None:
                health.record_failure(url, "connect")
            last_failure = f"backend error: {e}"
            timed_out = False
            decode_failed = True
            last_was_shed = False
            if _can_retry(attempt, max_attempts, tried, candidates,
                          budget):
                retry_cause = str(e)
                continue
        finally:
            monitor.on_request_complete(rec)
            if decode_failed and disagg_active:
                # a shed/failed pick never pulled the KV: take the
                # route-time credit back out, or its low in-flight
                # keeps winning the load tiebreak at phantom-zero
                # transfer cost for the prefixes it keeps refusing
                disagg.on_decode_failed(body, url,
                                        digests=disagg_digests)
            if retry_cause is not None:
                # abandoned attempt: an EVENT span, never a phase — its
                # wall time must not double-count against the winning
                # attempt's backend_ttfb in the histograms (the trace
                # still shows exactly where the failover time went)
                trace.add_event("backend_attempt", t_attempt,
                                time.monotonic() - t_attempt,
                                status="abandoned",
                                attrs={"server": url,
                                       "cause": retry_cause})
                tried.add(url)
                if health is not None:
                    health.note_retry(url)
                logger.info("failing over from %s after %s "
                            "(attempt %d/%d)", url, retry_cause,
                            attempt, max_attempts)
        break
    finally:
        if qos is not None:
            qos.unregister_preemptable(preempt_slot)

    # all attempts exhausted before a byte reached the client
    if timed_out:
        return web.json_response(
            {"error": {"message": last_failure or "backend timed out",
                       "type": "timeout_error"}}, status=504)
    if last_was_shed:
        # the final word was an overload shed (e.g. shed -> re-route ->
        # every remaining candidate at its cap): the client must see
        # the back-off signal, not a sick-fleet 502
        return _shed_response(503, last_failure or "backend shed")
    return web.json_response(
        {"error": {"message": last_failure or "no routable backend",
                   "type": "server_error"}}, status=502)
