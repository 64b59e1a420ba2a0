"""Router-overhead A/B: the same request storm, direct vs via router.

The round-5 prose number (~770 req/s through one router process vs
~3,900 req/s hitting the same fake engine directly — BASELINE.md
"Router data-plane measurement") was produced by an ad-hoc `/tmp`
script that never landed in the repo. This module is the committed,
reproducible form: it launches ONE engine (the zero-think fake by
default, or a real one) plus the real router in front of it, then
drives the identical closed-loop storm at both URLs and reports both
sides plus the overhead ratio in one BENCH-schema record.

Deliberately minimal client: a fixed pre-encoded body, N workers, one
shared session — per-request Python work on the *measuring* side is a
few dict writes, so the number characterizes the router, not the
harness. (The full loadgen workload machinery would tax both sides
equally but caps the ceiling well below the fake engine's.)
"""

import asyncio
import itertools
import json
import time
from typing import Dict, List, Optional

import aiohttp

from production_stack_tpu_torch.loadgen.orchestrator import (_stop, free_port,
                                                       launch_engine,
                                                       launch_router,
                                                       wait_healthy)
from production_stack_tpu_torch.loadgen.report import percentile
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

CHAT_PATH = "/v1/chat/completions"


def overhead_payload(model: str, num_tokens: int = 8,
                     stream: bool = False) -> bytes:
    """The fixed request body both sides receive, encoded once."""
    return json.dumps({
        "model": model,
        "messages": [{"role": "user", "content": "ping"}],
        "max_tokens": num_tokens,
        "stream": stream,
    }).encode()


def unique_payload_factory(model: str, num_tokens: int = 8,
                           stream: bool = False,
                           prompt_chars: int = 768):
    """Per-request UNIQUE long prompts — the cold-prefix worst case for
    cache-aware routing (every request hashes `prompt_chars` of text,
    walks the prefix ring, misses, and falls back to hash affinity).
    The r11 no-regression guard drives this against --routing prefix
    and asserts the r7 overhead band still holds."""
    counter = itertools.count()
    filler = "pad " * (prompt_chars // 4 + 1)

    def make() -> bytes:
        i = next(counter)
        return json.dumps({
            "model": model,
            "messages": [{"role": "user",
                          "content": f"cold-{i:08d} {filler}"
                                     [:prompt_chars]}],
            "max_tokens": num_tokens,
            "stream": stream,
        }).encode()
    return make


async def measure_side(url: str, payload: bytes, *,
                       users: int = 64,
                       duration_s: float = 15.0,
                       stream: bool = False,
                       warmup_requests: int = 32,
                       api_key: Optional[str] = None,
                       extra_headers: Optional[Dict] = None) -> Dict:
    """Closed-loop storm at one URL: ``users`` workers re-posting
    ``payload`` back to back for ``duration_s``. ``payload`` may be a
    zero-arg callable producing per-request bodies (cold-prefix mode).
    Returns the side's summary (req/s + latency/TTFT percentiles)."""
    headers = {"Content-Type": "application/json", **(extra_headers or {})}
    if api_key:
        headers["Authorization"] = f"Bearer {api_key}"
    target = f"{url}{CHAT_PATH}"
    make_payload = payload if callable(payload) else (lambda: payload)
    latencies: List[float] = []
    ttfts: List[float] = []
    errors: List[str] = []
    timeout = aiohttp.ClientTimeout(total=30)

    async with aiohttp.ClientSession(
            connector=aiohttp.TCPConnector(limit=0)) as session:

        async def one_request(record: bool) -> None:
            t0 = time.monotonic()
            try:
                async with session.post(target, data=make_payload(),
                                        headers=headers,
                                        timeout=timeout) as resp:
                    if resp.status != 200:
                        if record and len(errors) < 5:
                            errors.append(f"HTTP {resp.status}")
                        raise _RequestFailed()
                    if stream:
                        first_at = None
                        async for _chunk in resp.content.iter_any():
                            if first_at is None:
                                first_at = time.monotonic()
                        if record and first_at is not None:
                            ttfts.append(first_at - t0)
                    else:
                        await resp.read()
            except _RequestFailed:
                raise
            except (aiohttp.ClientError, ConnectionError, OSError,
                    asyncio.TimeoutError) as e:
                if record and len(errors) < 5:
                    errors.append(f"{type(e).__name__}: {e}")
                raise _RequestFailed()
            if record:
                latencies.append(time.monotonic() - t0)

        # warmup: absorb connection setup / first-request compiles
        warm_failures = 0
        for i in range(warmup_requests):
            try:
                await one_request(record=False)
            except _RequestFailed:
                warm_failures += 1
        if warm_failures:
            logger.warning("%d/%d warmup requests to %s failed",
                           warm_failures, warmup_requests, url)

        error_count = 0
        deadline = time.monotonic() + duration_s

        async def worker() -> None:
            nonlocal error_count
            while time.monotonic() < deadline:
                try:
                    await one_request(record=True)
                except _RequestFailed:
                    error_count += 1
                    await asyncio.sleep(0.05)   # don't spin an error storm

        started = time.monotonic()
        await asyncio.gather(*[worker() for _ in range(users)])
        elapsed = time.monotonic() - started

    def pcts(values: List[float]) -> Dict:
        return {"p50": round(percentile(values, 50) * 1e3, 3),
                "p90": round(percentile(values, 90) * 1e3, 3),
                "p99": round(percentile(values, 99) * 1e3, 3)}

    return {
        "url": url,
        "finished": len(latencies),
        "errors": error_count,
        "error_samples": errors,
        "duration_s": round(elapsed, 3),
        "req_per_s": round(len(latencies) / max(elapsed, 1e-9), 1),
        "latency_ms": pcts(latencies),
        "ttft_ms": pcts(ttfts) if stream else None,
    }


class _RequestFailed(Exception):
    """Internal: one request failed (already sampled)."""


async def run_overhead(*, engine: str = "fake",
                       users: int = 64,
                       duration_s: float = 15.0,
                       num_tokens: int = 8,
                       stream: bool = False,
                       routing: str = "roundrobin",
                       platform: str = "cuda",
                       log_dir: str = "loadgen-logs",
                       startup_timeout_s: float = 420.0,
                       snapshot_ttl: Optional[float] = None,
                       warmup_requests: int = 32,
                       unique_prompts: bool = False,
                       prompt_chars: int = 768,
                       router_extra_args: Optional[List[str]] = None,
                       companion=None) -> Dict:
    """Launch engine + router, measure both sides, return the A/B
    record (BENCH schema; headline value = router-side req/s).

    ``companion`` (optional) is a callable ``(engine_url, router_url)
    -> async context manager`` entered after the stack is healthy and
    exited after both sides are measured — the hook the obsplane
    overhead guard uses to keep a fleet scraper attached to the
    serving path for the WHOLE measured window."""
    procs = []
    companion_cm = None
    try:
        # zero-think fake: argparse takes the LAST occurrence, so these
        # override launch_engine's paced defaults
        fake_args = ["--tokens-per-s", "0",
                     "--num-tokens", str(num_tokens)] \
            if engine == "fake" else None
        eng = launch_engine(engine, free_port(), log_dir=log_dir,
                            platform=platform, extra_args=fake_args)
        procs.append(eng)
        await wait_healthy(eng.url, startup_timeout_s)
        model = "fake-model" if engine == "fake" else engine
        router = launch_router([eng.url], model, free_port(),
                               routing=routing, log_dir=log_dir,
                               snapshot_ttl=snapshot_ttl,
                               extra_args=router_extra_args)
        procs.append(router)
        await wait_healthy(router.url, 60.0, require_endpoints=1)
        if companion is not None:
            companion_cm = companion(eng.url, router.url)
            await companion_cm.__aenter__()

        if unique_prompts:
            payload = unique_payload_factory(model, num_tokens=num_tokens,
                                             stream=stream,
                                             prompt_chars=prompt_chars)
        else:
            payload = overhead_payload(model, num_tokens=num_tokens,
                                       stream=stream)
        # secured deployments (ENGINE_API_KEY exported): the direct
        # side hits the engine without the router's Bearer injection,
        # so carry the engine key on both sides (the router passes a
        # client Authorization through untouched)
        from production_stack_tpu_torch.router.service_discovery import (
            engine_auth_headers)
        auth = engine_auth_headers()
        logger.info("overhead A/B: %d users, %.0fs per side, "
                    "%d-token %s responses, engine=%s",
                    users, duration_s, num_tokens,
                    "streaming" if stream else "non-streaming", engine)
        direct = await measure_side(eng.url, payload, users=users,
                                    duration_s=duration_s, stream=stream,
                                    warmup_requests=warmup_requests,
                                    extra_headers=auth)
        logger.info("direct:  %.1f req/s (%d finished, %d errors)",
                    direct["req_per_s"], direct["finished"],
                    direct["errors"])
        via = await measure_side(router.url, payload, users=users,
                                 duration_s=duration_s, stream=stream,
                                 warmup_requests=warmup_requests,
                                 extra_headers=auth)
        logger.info("router:  %.1f req/s (%d finished, %d errors)",
                    via["req_per_s"], via["finished"], via["errors"])
    finally:
        if companion_cm is not None:
            await companion_cm.__aexit__(None, None, None)
        _stop(procs)

    ratio = (direct["req_per_s"] / via["req_per_s"]
             if via["req_per_s"] > 0 else None)
    added_p50 = round(via["latency_ms"]["p50"] -
                      direct["latency_ms"]["p50"], 3)
    return {
        "metric": "router data-plane overhead A/B "
                  "(req/s via router vs direct to the same engine)",
        "value": via["req_per_s"],
        "unit": "req/s",
        "platform": platform,
        "detail": {
            "engine": engine,
            "users": users,
            "duration_s": duration_s,
            "num_tokens": num_tokens,
            "stream": stream,
            "routing": routing,
            "unique_prompts": unique_prompts,
            "direct": direct,
            "router": via,
            "overhead_ratio": round(ratio, 3) if ratio else None,
            "added_latency_p50_ms": added_p50,
        },
    }
