"""Chaos mode: real router + N engines under scheduled engine churn.

The resilience layer's closed loop. The orchestrator launches the real
router in front of N engine processes (the zero-dependency fake by
default — chaos measures the *router's* failure handling, not model
compute), then drives a closed-loop chat storm while a churn task
kills engine processes with SIGKILL and restarts them on a schedule
(optionally also injecting backend-500 bursts through the fake
engine's ``/fault`` control endpoint).

Every client request is classified:

- ``ok``                    — HTTP 200, body/stream complete
- ``http_5xx``              — a 5xx reached the client. The router's
  pre-stream failover contract says this must be ZERO while at least
  one replica is healthy; the CLI exits 1 otherwise.
- ``truncated_streams``     — status 200 but the stream died before
  ``[DONE]``: the engine died mid-stream. Allowed (bytes cannot be
  replayed), counted, and reported.
- ``transport_errors``      — connect/read failure talking to the
  *router* itself; must also be zero (the router never restarts).
  One caveat: truncating a stream force-closes that client connection,
  so a pooled keep-alive connection can die under a later request's
  pen before any response byte exists. That is an HTTP/1.1 reuse
  race, retry-safe by construction — like every production OpenAI
  client, the storm retries such pre-response connection errors once
  on a fresh connection (counted as ``stale_conn_retries``).

The committed record (``CHAOS_*.json``, BENCH schema) carries
availability as the headline, latency percentiles under churn, the
kill/restart event log, and the router's own resilience counters
scraped from ``/metrics`` at the end.
"""

import asyncio
import json
import random
import re
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

# router knobs for a chaos run: fail fast, fail over, re-probe quickly
ROUTER_CHAOS_ARGS = ["--request-timeout", "30",
                     "--breaker-threshold", "2",
                     "--breaker-cooldown", "2",
                     "--breaker-probe-interval", "0.5",
                     "--failover-attempts", "3"]


class _Counters:
    def __init__(self):
        self.launched = 0
        self.ok = 0
        self.http_5xx = 0
        self.http_4xx = 0
        self.truncated_streams = 0
        self.transport_errors = 0
        self.stale_conn_retries = 0
        self.latencies: List[float] = []
        self.ttfts: List[float] = []
        self.samples: List[str] = []
        # absolute monotonic stamps of every transport error: with
        # --router-kill the contract becomes "errors only inside the
        # kill blip windows", which needs to know WHEN each happened
        self.transport_error_times: List[float] = []

    def sample(self, text: str) -> None:
        if len(self.samples) < 8:
            self.samples.append(text[:160])


async def chaos_storm(url: str, model: str, *, users: int,
                      deadline: float, stream_fraction: float,
                      num_tokens: int, seed: int,
                      request_timeout_s: float = 30.0) -> _Counters:
    """Closed-loop storm with per-request outcome classification.
    Workers carry stable ``x-user-id`` headers so session routing has
    real sessions to keep sticky across the churn."""
    c = _Counters()
    timeout = aiohttp.ClientTimeout(total=request_timeout_s)

    async def one(session: aiohttp.ClientSession, user: str,
                  stream: bool) -> None:
        body = json.dumps({
            "model": model,
            "messages": [{"role": "user", "content": f"chaos {user}"}],
            "max_tokens": num_tokens, "stream": stream}).encode()
        c.launched += 1
        t0 = time.monotonic()
        response_started = False
        for attempt_no in (0, 1):
            try:
                async with session.post(
                        f"{url}{CHAT_PATH}", data=body,
                        headers={"Content-Type": "application/json",
                                 "x-user-id": user},
                        timeout=timeout) as resp:
                    response_started = True
                    if resp.status >= 500:
                        c.http_5xx += 1
                        c.sample(f"HTTP {resp.status}: "
                                 f"{(await resp.text())}")
                        return
                    if resp.status >= 400:
                        c.http_4xx += 1
                        c.sample(f"HTTP {resp.status}")
                        return
                    if stream:
                        first_at = None
                        done = False
                        try:
                            async for chunk in resp.content.iter_any():
                                if first_at is None:
                                    first_at = time.monotonic()
                                if b"[DONE]" in chunk:
                                    done = True
                        except (aiohttp.ClientError, ConnectionError,
                                asyncio.TimeoutError):
                            done = False
                        if not done:
                            # 200 + dead stream: engine died mid-relay
                            c.truncated_streams += 1
                            return
                        if first_at is not None:
                            c.ttfts.append(first_at - t0)
                    else:
                        await resp.read()
                    c.ok += 1
                    c.latencies.append(time.monotonic() - t0)
                    return
            except (aiohttp.ClientOSError,
                    aiohttp.ServerDisconnectedError) as e:
                if not response_started and attempt_no == 0:
                    # stale pooled keep-alive connection (the router
                    # force-closed it truncating an earlier stream):
                    # pre-response, so retry once on a fresh socket
                    c.stale_conn_retries += 1
                    continue
                c.transport_errors += 1
                c.transport_error_times.append(time.monotonic())
                c.sample(f"{type(e).__name__}: {e}")
                return
            except (aiohttp.ClientError, ConnectionError, OSError,
                    asyncio.TimeoutError) as e:
                c.transport_errors += 1
                c.transport_error_times.append(time.monotonic())
                c.sample(f"{type(e).__name__}: {e}")
                return

    async def worker(i: int) -> None:
        rng = random.Random(seed * 997 + i)
        user = f"chaos-user-{i}"
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0)) as session:
            while time.monotonic() < deadline:
                stream = rng.random() < stream_fraction
                await one(session, user, stream)
                await asyncio.sleep(0.01)

    await asyncio.gather(*[worker(i) for i in range(users)])
    return c


async def _churn_loop(engines: List[Proc], *, engine_kind: str,
                      kill_interval_s: float, downtime_s: float,
                      deadline: float, log_dir: str, t0: float,
                      events: List[Dict],
                      platform: str = "cuda",
                      engine_extra_args: Optional[List[str]] = None
                      ) -> None:
    """Kill one engine (SIGKILL — no goodbye), wait ``downtime_s``,
    restart it on the same port, round-robin over the fleet."""
    i = 0
    while True:
        await asyncio.sleep(kill_interval_s)
        # leave room for the restart inside the measured window
        if time.monotonic() + downtime_s + 2.0 >= deadline:
            return
        victim_idx = i % len(engines)
        i += 1
        victim = engines[victim_idx]
        port = int(victim.url.rsplit(":", 1)[1])
        victim.popen.kill()
        victim.popen.wait()
        events.append({"t_s": round(time.monotonic() - t0, 2),
                       "event": "kill", "url": victim.url})
        logger.info("chaos: killed %s", victim.url)
        await asyncio.sleep(downtime_s)
        engines[victim_idx] = launch_engine(
            engine_kind, port, log_dir=log_dir, platform=platform,
            extra_args=engine_extra_args)
        events.append({"t_s": round(time.monotonic() - t0, 2),
                       "event": "restart", "url": victim.url})
        logger.info("chaos: restarted %s", victim.url)
        try:
            await wait_healthy(engines[victim_idx].url, 60.0)
        except TimeoutError:
            logger.warning("chaos: %s not healthy after restart",
                           engines[victim_idx].url)


async def _cache_churn_loop(holder: Dict[str, Proc], *,
                            kill_interval_s: float, downtime_s: float,
                            deadline: float, log_dir: str, t0: float,
                            events: List[Dict]) -> None:
    """SIGKILL/restart the shared TPKV cache server on a schedule — a
    replica mid-transfer must degrade to recompute (bounded remote
    timeouts + breaker in kvcache/store.RemoteStore), never surface a
    client-visible error."""
    while True:
        await asyncio.sleep(kill_interval_s)
        if time.monotonic() + downtime_s + 2.0 >= deadline:
            return
        victim = holder["proc"]
        port = int(victim.url.rsplit(":", 1)[1])
        victim.popen.kill()
        victim.popen.wait()
        events.append({"t_s": round(time.monotonic() - t0, 2),
                       "event": "cache_kill", "url": victim.url})
        logger.info("chaos: killed cache server %s", victim.url)
        await asyncio.sleep(downtime_s)
        holder["proc"] = launch_cache_server(port, log_dir=log_dir)
        events.append({"t_s": round(time.monotonic() - t0, 2),
                       "event": "cache_restart", "url": victim.url})
        logger.info("chaos: restarted cache server %s", victim.url)
        try:
            await wait_cache_ready(holder["proc"].url, 30.0)
        except TimeoutError:
            logger.warning("chaos: cache server %s not answering after "
                           "restart", holder["proc"].url)


async def _router_churn_loop(router_procs: List[Proc],
                             router_ports: List[int],
                             engine_urls: List[str], model: str, *,
                             routing: str, kill_interval_s: float,
                             downtime_s: float, deadline: float,
                             log_dir: str, t0: float,
                             events: List[Dict],
                             router_extra_args: Optional[List[str]],
                             engines: int) -> None:
    """SIGKILL/restart ROUTER replicas round-robin (mirroring the
    engine churn scheduler): sequential kill -> downtime -> restart ->
    wait-healthy, so at least one replica is always up and the L4
    splitter's connect-failover carries the traffic."""
    i = 0
    while True:
        await asyncio.sleep(kill_interval_s)
        if time.monotonic() + downtime_s + 5.0 >= deadline:
            return
        victim_idx = i % len(router_procs)
        i += 1
        victim = router_procs[victim_idx]
        victim.popen.kill()
        victim.popen.wait()
        events.append({"t_s": round(time.monotonic() - t0, 2),
                       "event": "router_kill", "url": victim.url})
        logger.info("chaos: killed router %s", victim.url)
        await asyncio.sleep(downtime_s)
        router_procs[victim_idx] = _launch_chaos_router(
            victim_idx, router_ports, engine_urls, model,
            routing=routing, log_dir=log_dir,
            router_extra_args=router_extra_args)
        try:
            await wait_healthy(router_procs[victim_idx].url, 30.0,
                               require_endpoints=engines)
            events.append({"t_s": round(time.monotonic() - t0, 2),
                           "event": "router_restart",
                           "url": router_procs[victim_idx].url})
        except TimeoutError:
            logger.warning("chaos: router %s not healthy after restart",
                           router_procs[victim_idx].url)


def _launch_chaos_router(idx: int, router_ports: List[int],
                         engine_urls: List[str], model: str, *,
                         routing: str, log_dir: str,
                         router_extra_args: Optional[List[str]]) -> Proc:
    port = router_ports[idx]
    peers = ",".join(f"http://127.0.0.1:{p}" for p in router_ports
                     if p != port)
    extra = ROUTER_CHAOS_ARGS + [
        "--router-id", f"chaos-router-{idx}",
        "--peer-routers", peers,
        "--peer-gossip-interval", "0.25",
    ] + (router_extra_args or [])
    return launch_router(engine_urls, model, port, routing=routing,
                         log_dir=log_dir, extra_args=extra)


async def _error_burst_loop(engine_urls: List[str], *,
                            interval_s: float, burst: int,
                            deadline: float, seed: int, t0: float,
                            events: List[Dict]) -> None:
    """Every ``interval_s``, tell one (fake) engine to 500 the next
    ``burst`` inference requests — exercises the backend-5xx failover
    path, not just dead sockets."""
    rng = random.Random(seed ^ 0xc4a05)
    async with aiohttp.ClientSession() as session:
        while time.monotonic() + 1.0 < deadline:
            await asyncio.sleep(interval_s)
            url = rng.choice(engine_urls)
            try:
                async with session.post(
                        f"{url}/fault",
                        json={"mode": "error", "count": burst},
                        timeout=aiohttp.ClientTimeout(total=2)) as r:
                    if r.status == 200:
                        events.append(
                            {"t_s": round(time.monotonic() - t0, 2),
                             "event": f"error_burst x{burst}",
                             "url": url})
            except (aiohttp.ClientError, ConnectionError, OSError,
                    asyncio.TimeoutError):
                pass    # victim currently dead; fine


async def _scrape_router_resilience(router_url: str) -> Dict[str, float]:
    """Pull the router's resilience counters off /metrics (totals only
    — per-endpoint label detail stays in the exposition)."""
    wanted = ("vllm:upstream_failures_total",
              "vllm:upstream_retries_total",
              "vllm:relayed_5xx_total",
              "vllm:breaker_opens_total",
              "vllm:healthy_pods_total")
    out: Dict[str, float] = {}
    try:
        async with aiohttp.ClientSession() as session:
            async with session.get(
                    f"{router_url}/metrics",
                    timeout=aiohttp.ClientTimeout(total=5)) as r:
                text = await r.text()
    except (aiohttp.ClientError, ConnectionError, OSError,
            asyncio.TimeoutError):
        return out
    for name in wanted:
        total = 0.0
        for m in re.finditer(
                rf"^{re.escape(name)}(?:{{[^}}]*}})?\s+([0-9.eE+-]+)",
                text, re.M):
            total += float(m.group(1))
        out[name] = total
    return out


async def run_chaos(*, engines: int = 3,
                    engine: str = "fake",
                    users: int = 16,
                    duration_s: float = 60.0,
                    kill_interval_s: float = 10.0,
                    downtime_s: float = 3.0,
                    error_burst_interval_s: Optional[float] = 7.0,
                    error_burst: int = 5,
                    stream_fraction: float = 0.3,
                    num_tokens: int = 16,
                    routing: str = "session",
                    seed: int = 0,
                    p99_bound_s: Optional[float] = None,
                    platform: str = "cuda",
                    log_dir: str = "loadgen-logs",
                    startup_timeout_s: float = 420.0,
                    router_extra_args: Optional[List[str]] = None,
                    cache_server_kill: bool = False,
                    cache_kill_interval_s: float = 7.0,
                    cache_downtime_s: float = 2.0,
                    prefill_ms_per_char: float = 0.2,
                    router_kill: bool = False,
                    router_replicas: int = 2,
                    router_kill_interval_s: float = 15.0,
                    router_downtime_s: float = 2.0,
                    router_blip_window_s: float = 4.0
                    ) -> Dict:
    """Launch router + N engines, storm the router while killing and
    restarting engines on a schedule; return the CHAOS record.

    ``cache_server_kill`` additionally launches a shared TPKV cache
    server wired into (fake) engines as their remote KV tier and
    SIGKILLs/restarts IT on its own schedule — the r11 extension: a
    dying cache server mid-transfer must cost TTFT (recompute), never a
    client-visible error.

    ``router_kill`` (the r16 extension) launches ``router_replicas``
    peered routers behind an in-process L4 splitter instead of one
    router, and SIGKILLs/restarts router replicas round-robin on their
    own schedule: client errors are then allowed ONLY inside each
    kill's ``router_blip_window_s`` (the dead replica's in-flight
    requests), never in steady state."""
    procs: List[Proc] = []
    engine_procs: List[Proc] = []
    router_procs: List[Proc] = []
    events: List[Dict] = []
    engine_extra_args: Optional[List[str]] = None
    cache_holder: Dict[str, Proc] = {}
    splitter = None
    try:
        if cache_server_kill:
            if engine != "fake":
                raise ValueError("cache_server_kill currently drives "
                                 "the fake-engine KV simulation")
            cache = launch_cache_server(free_port(), log_dir=log_dir)
            procs.append(cache)
            cache_holder["proc"] = cache
            await wait_cache_ready(cache.url)
            engine_extra_args = [
                "--kv-remote-url", cache.url,
                "--prefill-ms-per-char", str(prefill_ms_per_char)]
        for _ in range(engines):
            engine_procs.append(launch_engine(
                engine, free_port(), log_dir=log_dir, platform=platform,
                extra_args=engine_extra_args))
        procs.extend(engine_procs)
        await asyncio.gather(*[wait_healthy(e.url, startup_timeout_s)
                               for e in engine_procs])
        model = "fake-model" if engine == "fake" else engine
        if router_kill:
            from production_stack_tpu_torch.loadgen.multirouter import (
                L4Splitter)
            router_ports = [free_port() for _ in range(router_replicas)]
            for idx in range(router_replicas):
                router_procs.append(_launch_chaos_router(
                    idx, router_ports, [e.url for e in engine_procs],
                    model, routing=routing, log_dir=log_dir,
                    router_extra_args=router_extra_args))
            procs.extend(router_procs)
            await asyncio.gather(*[
                wait_healthy(r.url, 60.0, require_endpoints=engines)
                for r in router_procs])
            splitter = L4Splitter([("127.0.0.1", p)
                                   for p in router_ports])
            await splitter.start()
            storm_url = splitter.url
            scrape_url = router_procs[0].url
        else:
            router = launch_router(
                [e.url for e in engine_procs], model, free_port(),
                routing=routing, log_dir=log_dir,
                extra_args=ROUTER_CHAOS_ARGS + (router_extra_args or []))
            procs.append(router)
            await wait_healthy(router.url, 60.0,
                               require_endpoints=engines)
            storm_url = router.url
            scrape_url = router.url

        logger.info("chaos: %d users vs router + %d %s engines for "
                    "%.0fs (kill every %.0fs, %.0fs downtime)",
                    users, engines, engine, duration_s,
                    kill_interval_s, downtime_s)
        t0 = time.monotonic()
        deadline = t0 + duration_s
        tasks = [asyncio.create_task(_churn_loop(
            engine_procs, engine_kind=engine,
            kill_interval_s=kill_interval_s, downtime_s=downtime_s,
            deadline=deadline, log_dir=log_dir, t0=t0, events=events,
            platform=platform, engine_extra_args=engine_extra_args))]
        if cache_server_kill:
            tasks.append(asyncio.create_task(_cache_churn_loop(
                cache_holder, kill_interval_s=cache_kill_interval_s,
                downtime_s=cache_downtime_s, deadline=deadline,
                log_dir=log_dir, t0=t0, events=events)))
        if engine == "fake" and error_burst_interval_s:
            tasks.append(asyncio.create_task(_error_burst_loop(
                [e.url for e in engine_procs],
                interval_s=error_burst_interval_s, burst=error_burst,
                deadline=deadline, seed=seed, t0=t0, events=events)))
        if router_kill:
            tasks.append(asyncio.create_task(_router_churn_loop(
                router_procs, router_ports,
                [e.url for e in engine_procs], model, routing=routing,
                kill_interval_s=router_kill_interval_s,
                downtime_s=router_downtime_s, deadline=deadline,
                log_dir=log_dir, t0=t0, events=events,
                router_extra_args=router_extra_args, engines=engines)))
        try:
            c = await chaos_storm(storm_url, model, users=users,
                                  deadline=deadline,
                                  stream_fraction=stream_fraction,
                                  num_tokens=num_tokens, seed=seed)
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
        elapsed = time.monotonic() - t0
        router_counters = await _scrape_router_resilience(scrape_url)
        engine_kv = None
        if cache_server_kill:
            from production_stack_tpu_torch.loadgen.kvshare import _scrape_kv
            engine_kv = await _scrape_kv([e.url for e in engine_procs])
    finally:
        # the churn loops swap engine/cache/router Procs in place; stop
        # the CURRENT processes plus anything from the launch-time
        # snapshot (already-dead originals — _stop skips exited pids)
        if splitter is not None:
            await splitter.close()
        current = list(engine_procs) + list(router_procs)
        if cache_holder.get("proc") is not None:
            current.append(cache_holder["proc"])
        current.extend(p for p in procs if p not in current)
        _stop(current)

    kills = len([e for e in events if e["event"] == "kill"])
    restarts = len([e for e in events if e["event"] == "restart"])
    cache_kills = len([e for e in events if e["event"] == "cache_kill"])
    router_kills = len([e for e in events
                        if e["event"] == "router_kill"])
    # classify each transport error against the router-kill blip
    # windows (kill .. restart-healthy + blip slack)
    transport_rel = sorted(round(ts - t0, 2)
                           for ts in c.transport_error_times)
    errors_outside_blip = []
    if router_kill:
        windows = []
        for e in events:
            if e["event"] == "router_kill":
                # the kill stamp lands after popen.wait(); connections
                # reset the instant the signal delivers, so each
                # window opens 0.5s early
                windows.append([e["t_s"] - 0.5,
                                e["t_s"] + router_downtime_s
                                + router_blip_window_s])
        for rel in transport_rel:
            if not any(lo <= rel <= hi for lo, hi in windows):
                errors_outside_blip.append(rel)
    done = c.ok + c.http_5xx + c.http_4xx + c.truncated_streams + \
        c.transport_errors
    availability = 100.0 * c.ok / done if done else 0.0

    def pcts(vals: List[float]) -> Dict:
        return {"p50": round(percentile(vals, 50) * 1e3, 1),
                "p90": round(percentile(vals, 90) * 1e3, 1),
                "p99": round(percentile(vals, 99) * 1e3, 1)}

    return {
        "metric": "client-visible availability under engine churn "
                  "(router pre-stream failover; fake engines killed/"
                  "restarted on schedule)",
        "value": round(availability, 3),
        "unit": "%",
        "platform": platform,
        "detail": {
            "engine": engine, "engines": engines, "users": users,
            "routing": routing,
            "duration_s": round(elapsed, 1),
            "kill_interval_s": kill_interval_s,
            "downtime_s": downtime_s,
            "error_burst_interval_s": error_burst_interval_s
            if engine == "fake" else None,
            "kills": kills, "restarts": restarts,
            "cache_server_kill": cache_server_kill,
            "cache_kills": cache_kills,
            "router_kill": router_kill,
            "router_replicas": router_replicas if router_kill else 1,
            "router_kills": router_kills,
            "router_blip_window_s": router_blip_window_s
            if router_kill else None,
            "transport_error_times_s": transport_rel,
            "errors_outside_blip": errors_outside_blip
            if router_kill else None,
            "splitter_connect_failovers": splitter.connect_failovers
            if splitter is not None else None,
            "engine_kv": engine_kv,
            "requests": {
                "launched": c.launched, "ok": c.ok,
                "http_5xx": c.http_5xx, "http_4xx": c.http_4xx,
                "truncated_streams": c.truncated_streams,
                "transport_errors": c.transport_errors,
                "stale_conn_retries": c.stale_conn_retries,
            },
            "availability_pct": round(availability, 3),
            "req_per_s": round(c.ok / max(elapsed, 1e-9), 1),
            "latency_ms": pcts(c.latencies),
            "ttft_ms": pcts(c.ttfts) if c.ttfts else None,
            "p99_bound_s": p99_bound_s,
            "router_resilience_counters": router_counters,
            "error_samples": c.samples,
            "events": events,
        },
    }


def chaos_violations(record: Dict) -> List[str]:
    """The chaos run's pass/fail contract (CLI exits 1 on any)."""
    d = record["detail"]
    r = d["requests"]
    out = []
    if r["http_5xx"]:
        out.append(f"{r['http_5xx']} client-visible 5xx (pre-stream "
                   f"failures must fail over, not surface)")
    if d.get("router_kill"):
        # router replicas DO die on schedule here: each kill may cost
        # its in-flight blip (counted), but nothing outside a window
        outside = d.get("errors_outside_blip") or []
        if outside:
            out.append(f"{len(outside)} transport errors OUTSIDE the "
                       f"router-kill blip windows (at {outside[:5]}s) "
                       f"— only the dead replica's in-flight requests "
                       f"may surface")
        if not d.get("router_kills"):
            out.append("router churn never killed a router (window "
                       "too short for router_kill_interval?)")
    elif r["transport_errors"]:
        out.append(f"{r['transport_errors']} transport errors talking "
                   f"to the router (the router must not die)")
    if r["ok"] == 0:
        out.append("zero successful requests")
    if not d["kills"]:
        out.append("churn never killed an engine (window too short "
                   "for kill_interval?)")
    if d.get("cache_server_kill") and not d.get("cache_kills"):
        out.append("cache churn never killed the cache server (window "
                   "too short for cache_kill_interval?)")
    bound = d.get("p99_bound_s")
    if bound and d["latency_ms"]["p99"] > bound * 1e3:
        out.append(f"p99 {d['latency_ms']['p99']:.0f}ms exceeds the "
                   f"{bound:g}s bound under churn")
    return out
