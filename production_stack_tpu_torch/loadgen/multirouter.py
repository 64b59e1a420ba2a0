"""Multi-router closed loop: N real routers behind an L4 split.

The multi-router acceptance rig (``MULTIROUTER_r16.json``).
Launches N fake engines + R≥2 REAL router processes wired together as
a shared-state control plane (``--peer-routers`` gossip,
``--qos-tiers``, apportioned caps — router/shared_state.py + qos.py),
fronts them with a dumb in-process L4 TCP splitter (round-robin per
connection, connect-failure failover — the loadgen stand-in for a
cloud NLB), and drives four phases:

1. **control** — the affinity storm through ONE router directly: the
   single-router baseline the pair must match.
2. **pair** — the identical storm through the splitter, with the
   asymmetric control-plane event that splits un-gossiped routers:
   an ``/admin/drain`` issued through ONE router only (exactly how an
   operator drains), plus a breaker-convergence probe (a scheduled
   error burst against one engine; both routers must report it open
   within one probe interval of each other). Affinity hit rate =
   mean per-session fraction of steady-window requests on the
   session's modal engine (measured from the ``x-engine-id`` each
   fake stamps). With shared state both routers move the drained
   engine's sessions to the SAME consistent-hash successor; with
   ``--no-shared-state`` the un-drained router keeps routing into
   the drain — the affinity gate MUST fail (anti-vacuity).
3. **router_kill** — SIGKILL one router mid-storm. The splitter
   reroutes new connections on connect failure, so the kill may cost
   only the requests in flight on the dead replica: every client
   error must land inside the kill→recover blip window (counted and
   reported), zero client 5xx outside it, zero steady-state errors
   after the replica returns.
4. **saturation** — a tiered storm (``x-priority-class``) past the
   routers' ``--max-inflight``: tier-0 goodput must hold ≥95% of its
   pre-saturation rate while tier-2 sheds ≥50% — the low-tier-first
   contract, fleet-wide.

``multirouter_violations`` is the pass/fail contract (CLI exits 1 on
any); ``--overhead-guard`` re-runs the r7 A/B through a shared-state
router against a same-host plain baseline (r14 convention: within the
band, or within 10% of the baseline).
"""

import asyncio
import json
import random
import time
from typing import Dict, List, Optional, Tuple

import aiohttp

from production_stack_tpu_torch.loadgen.orchestrator import (Proc, _stop,
                                                       free_port,
                                                       launch_engine,
                                                       launch_router,
                                                       wait_healthy)
from production_stack_tpu_torch.loadgen.report import percentile
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

CHAT_PATH = "/v1/chat/completions"

# fail fast, fail over, probe quickly — plus the shared-state plane
ROUTER_BASE_ARGS = ["--request-timeout", "20",
                    "--breaker-threshold", "2",
                    "--breaker-cooldown", "1.5",
                    "--breaker-probe-interval", "0.5",
                    "--failover-attempts", "3"]

QOS_TIERS = "tier0=1.0,tier1=0.85,tier2=0.7"


# ---------------------------------------------------------------- splitter

class L4Splitter:
    """Dumb TCP splitter: new connections round-robin over the router
    replicas; a connect failure tries the next replica (that is ALL a
    cloud L4 does — no health checks, no request awareness). Serves
    one listening port; counts per-backend connections and connect
    failovers so the record shows the kill actually moved traffic."""

    def __init__(self, backends: List[Tuple[str, int]],
                 host: str = "127.0.0.1", port: Optional[int] = None):
        self.backends = list(backends)
        self.host = host
        self.port = port or free_port()
        self._rr = 0
        self._server: Optional[asyncio.AbstractServer] = None
        self.connections: Dict[str, int] = {
            f"{h}:{p}": 0 for h, p in self.backends}
        self.connect_failovers = 0
        self.refused = 0

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, client_reader: asyncio.StreamReader,
                      client_writer: asyncio.StreamWriter) -> None:
        upstream = None
        first = self._rr
        self._rr += 1
        for i in range(len(self.backends)):
            h, p = self.backends[(first + i) % len(self.backends)]
            try:
                upstream = await asyncio.open_connection(h, p)
                self.connections[f"{h}:{p}"] += 1
                break
            except OSError:
                self.connect_failovers += 1
                upstream = None
        if upstream is None:
            self.refused += 1
            client_writer.close()
            return
        up_reader, up_writer = upstream

        async def pipe(reader: asyncio.StreamReader,
                       writer: asyncio.StreamWriter) -> None:
            try:
                while True:
                    data = await reader.read(65536)
                    if not data:
                        break
                    writer.write(data)
                    await writer.drain()
            except (OSError, asyncio.IncompleteReadError,
                    ConnectionError):
                pass
            finally:
                try:
                    writer.close()
                except OSError:
                    pass

        await asyncio.gather(pipe(client_reader, up_writer),
                             pipe(up_reader, client_writer))


# ---------------------------------------------------------------- storm

class _Rec:
    __slots__ = ("t", "session", "tier", "kind", "engine", "router",
                 "latency_s")

    def __init__(self, t, session, tier, kind, engine, router,
                 latency_s):
        self.t = t                      # completion, monotonic
        self.session = session
        self.tier = tier
        self.kind = kind                # ok | shed | http_5xx |
                                        # http_4xx | transport
        self.engine = engine            # x-engine-id (ok only)
        self.router = router            # x-router-id
        self.latency_s = latency_s


async def _storm(url: str, model: str, *, deadline: float,
                 sessions: List[Tuple[str, str]],
                 num_tokens: int = 8,
                 think_s: float = 0.01,
                 request_timeout_s: float = 20.0,
                 sink: Optional[List[_Rec]] = None) -> List[_Rec]:
    """Closed-loop storm: one worker per (session_id, tier). Fresh
    connection per request (``force_close``) so the splitter's
    per-connection round-robin becomes per-request — both routers see
    every session, which is the whole point. ``sink`` lets a
    concurrent task (the drain scheduler) read records live."""
    recs: List[_Rec] = sink if sink is not None else []
    timeout = aiohttp.ClientTimeout(total=request_timeout_s)

    async def worker(session_id: str, tier: str) -> None:
        # jittered think time: synchronized closed-loop workers phase-
        # lock with the splitter's global connection round-robin, and a
        # phase-locked session sees only ONE router — hiding exactly
        # the cross-router divergence the affinity metric measures
        jitter = random.Random(session_id)
        headers = {"Content-Type": "application/json",
                   "x-user-id": session_id}
        if tier:
            headers["x-priority-class"] = tier
        body = json.dumps({
            "model": model,
            "messages": [{"role": "user",
                          "content": f"multirouter {session_id}"}],
            "max_tokens": num_tokens, "stream": False}).encode()
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0,
                                               force_close=True)) as s:
            while time.monotonic() < deadline:
                t0 = time.monotonic()
                kind, engine, router = "transport", "", ""
                try:
                    async with s.post(f"{url}{CHAT_PATH}", data=body,
                                      headers=headers,
                                      timeout=timeout) as resp:
                        router = resp.headers.get("x-router-id", "")
                        if resp.status == 200:
                            await resp.read()
                            kind = "ok"
                            engine = resp.headers.get("x-engine-id", "")
                        elif resp.status in (429, 503) and \
                                "Retry-After" in resp.headers:
                            await resp.read()
                            kind = "shed"
                        elif resp.status >= 500:
                            await resp.read()
                            kind = "http_5xx"
                        else:
                            await resp.read()
                            kind = "http_4xx"
                except (aiohttp.ClientError, ConnectionError, OSError,
                        asyncio.TimeoutError):
                    kind = "transport"
                now = time.monotonic()
                recs.append(_Rec(now, session_id, tier, kind, engine,
                                 router, now - t0))
                if kind == "shed":
                    await asyncio.sleep(0.1)   # honor the backoff
                else:
                    await asyncio.sleep(think_s *
                                        (0.5 + jitter.random()))

    await asyncio.gather(*(worker(sid, tier) for sid, tier in sessions))
    return recs


def _affinity_hit_rate(recs: List[_Rec], *, after: float,
                       min_requests: int = 3) -> Optional[float]:
    """Mean per-session modal-engine fraction over ok-requests
    completing after ``after`` — 1.0 means every session stuck to one
    engine for the whole steady window, split-brain drags it down."""
    per: Dict[str, Dict[str, int]] = {}
    for r in recs:
        if r.kind == "ok" and r.t >= after and r.engine:
            per.setdefault(r.session, {}) \
               .setdefault(r.engine, 0)
            per[r.session][r.engine] += 1
    rates = []
    for session, engines in per.items():
        total = sum(engines.values())
        if total >= min_requests:
            rates.append(max(engines.values()) / total)
    if not rates:
        return None
    return sum(rates) / len(rates)


def _kinds(recs: List[_Rec]) -> Dict[str, int]:
    out = {"ok": 0, "shed": 0, "http_5xx": 0, "http_4xx": 0,
           "transport": 0}
    for r in recs:
        out[r.kind] += 1
    return out


# ---------------------------------------------------------------- helpers

async def _routers_report_state(router_urls: List[str], engine_url: str,
                                want_open: bool, timeout_s: float,
                                poll_s: float = 0.05) -> Dict[str, float]:
    """Poll every router's /health until each reports ``engine_url``'s
    breaker open (or closed again); returns per-router seconds-to-
    report (inf for routers that never did)."""
    t0 = time.monotonic()
    seen: Dict[str, float] = {}
    async with aiohttp.ClientSession() as s:
        while time.monotonic() - t0 < timeout_s \
                and len(seen) < len(router_urls):
            for url in router_urls:
                if url in seen:
                    continue
                try:
                    async with s.get(f"{url}/health",
                                     timeout=aiohttp.ClientTimeout(
                                         total=2)) as r:
                        body = await r.json()
                except (aiohttp.ClientError, ConnectionError, OSError,
                        asyncio.TimeoutError, ValueError):
                    continue
                st = (body.get("breakers") or {}).get(engine_url, {})
                is_open = st.get("state") in ("open", "half_open")
                if is_open == want_open:
                    seen[url] = time.monotonic() - t0
            await asyncio.sleep(poll_s)
    return {u: seen.get(u, float("inf")) for u in router_urls}


async def _drain(router_url: str, engine_url: str, drain: bool) -> None:
    async with aiohttp.ClientSession() as s:
        async with s.post(f"{router_url}/admin/drain",
                          json={"url": engine_url, "drain": drain},
                          timeout=aiohttp.ClientTimeout(total=5)) as r:
            if r.status != 200:
                raise RuntimeError(
                    f"drain({drain}) via {router_url} -> HTTP {r.status}")


async def _inject_error_burst(engine_url: str, count: int) -> None:
    async with aiohttp.ClientSession() as s:
        async with s.post(f"{engine_url}/fault",
                          json={"mode": "error", "count": count},
                          timeout=aiohttp.ClientTimeout(total=5)) as r:
            if r.status != 200:
                raise RuntimeError(f"fault injection -> HTTP {r.status}")


def _launch_router_replica(idx: int, port: int, engine_urls: List[str],
                           model: str, peer_ports: List[int], *,
                           routing: str, shared_state: bool,
                           max_inflight: int, gossip_interval_s: float,
                           log_dir: str) -> Proc:
    peers = ",".join(f"http://127.0.0.1:{p}" for p in peer_ports)
    extra = list(ROUTER_BASE_ARGS)
    extra += ["--router-id", f"router-{idx}",
              "--qos-tiers", QOS_TIERS,
              "--max-inflight", str(max_inflight),
              "--engine-stats-interval", "1"]
    if peers:
        extra += ["--peer-routers", peers,
                  "--peer-gossip-interval", str(gossip_interval_s)]
    if not shared_state:
        extra += ["--no-shared-state"]
    return launch_router(engine_urls, model, port, routing=routing,
                         log_dir=log_dir, extra_args=extra)


# ---------------------------------------------------------------- run

async def run_multirouter(*, engines: int = 3,
                          routers: int = 2,
                          engine: str = "fake",
                          sessions: int = 12,
                          phase_duration_s: float = 20.0,
                          num_tokens: int = 8,
                          tokens_per_s: float = 60.0,
                          gossip_interval_s: float = 0.25,
                          settle_s: float = 3.0,
                          blip_window_s: float = 3.0,
                          max_inflight: int = 8,
                          tier0_users: int = 4,
                          tier1_users: int = 8,
                          tier2_users: int = 16,
                          saturation_presat_s: float = 8.0,
                          routing: str = "session",
                          shared_state: bool = True,
                          seed: int = 0,
                          platform: str = "cuda",
                          log_dir: str = "loadgen-logs",
                          startup_timeout_s: float = 420.0,
                          skip_saturation: bool = False,
                          skip_kill: bool = False,
                          skip_convergence: bool = False,
                          convergence_storm_s: float = 8.0,
                          overhead_guard: bool = False,
                          overhead_users: int = 48,
                          overhead_duration_s: float = 10.0) -> Dict:
    """Launch the stack, run the four phases, return the MULTIROUTER
    record (BENCH schema; headline value = pair affinity hit rate %)."""
    if routers < 2:
        raise ValueError("the multirouter rig needs >= 2 routers")
    rng = random.Random(seed)
    procs: List[Proc] = []
    router_procs: List[Proc] = []
    detail: Dict = {}
    splitter: Optional[L4Splitter] = None
    try:
        # --- engines ---------------------------------------------------
        engine_extra = None
        if engine == "fake":
            # pace via --ttft: a deterministic per-request service time
            # (num_tokens / tokens_per_s) that applies to the
            # NON-streaming path the storms use — tokens_per_s pacing
            # alone only stretches streamed chunk gaps. The saturation
            # sweep needs real service time, or router admission never
            # becomes the scarce resource
            engine_extra = ["--ttft", str(num_tokens / tokens_per_s),
                            "--tokens-per-s", "0",
                            "--num-tokens", str(num_tokens)]
        engine_procs = [launch_engine(engine, free_port(),
                                      log_dir=log_dir, platform=platform,
                                      extra_args=engine_extra)
                        for _ in range(engines)]
        procs.extend(engine_procs)
        await asyncio.gather(*[wait_healthy(e.url, startup_timeout_s)
                               for e in engine_procs])
        model = "fake-model" if engine == "fake" else engine
        engine_urls = [e.url for e in engine_procs]

        # --- routers ---------------------------------------------------
        ports = [free_port() for _ in range(routers)]
        for i, port in enumerate(ports):
            router_procs.append(_launch_router_replica(
                i, port, engine_urls, model,
                [p for p in ports if p != port],
                routing=routing, shared_state=shared_state,
                max_inflight=max_inflight,
                gossip_interval_s=gossip_interval_s, log_dir=log_dir))
        procs.extend(router_procs)
        await asyncio.gather(*[
            wait_healthy(r.url, 60.0, require_endpoints=engines)
            for r in router_procs])
        router_urls = [r.url for r in router_procs]

        splitter = L4Splitter([("127.0.0.1", p) for p in ports])
        await splitter.start()
        logger.info("multirouter: %d engines, %d routers (%s), "
                    "splitter %s, shared_state=%s", engines, routers,
                    ",".join(router_urls), splitter.url, shared_state)

        plain_sessions = [(f"mr-s{i:02d}", "") for i in range(sessions)]

        async def affinity_phase(target_url: str,
                                 drain_via: str) -> Dict:
            """The affinity storm: drain one engine through ONE router
            a third of the way in, never undrain; measure the steady
            window after the drain settles."""
            t0 = time.monotonic()
            deadline = t0 + phase_duration_s
            drain_at = t0 + phase_duration_s / 3.0
            live_recs: List[_Rec] = []
            chosen: Dict[str, str] = {}

            async def drainer():
                await asyncio.sleep(max(0.0, drain_at - time.monotonic()))
                # drain the engine serving the MOST sessions so far:
                # the probe must actually displace traffic, or session
                # hashing can hand it an idle engine and the
                # anti-vacuity split never materializes (flaky)
                counts: Dict[str, int] = {}
                for r in list(live_recs):
                    if r.kind == "ok" and r.engine:
                        counts[r.engine] = counts.get(r.engine, 0) + 1
                victim = engine_urls[rng.randrange(len(engine_urls))]
                if counts:
                    candidate = f"http://{max(counts, key=counts.get)}"
                    if candidate in engine_urls:
                        victim = candidate
                chosen["victim"] = victim
                await _drain(drain_via, victim, True)

            task = asyncio.create_task(drainer())
            try:
                recs = await _storm(target_url, model, deadline=deadline,
                                    sessions=plain_sessions,
                                    num_tokens=num_tokens,
                                    sink=live_recs)
            finally:
                task.cancel()
                await asyncio.gather(task, return_exceptions=True)
            victim = chosen.get("victim")
            # leave the fleet clean for the next phase: undrain via
            # every router (idempotent; end_drain is permissive)
            if victim is not None:
                for url in router_urls:
                    try:
                        await _drain(url, victim, False)
                    except RuntimeError:
                        pass
            await asyncio.sleep(2.5 * gossip_interval_s)
            hit = _affinity_hit_rate(recs, after=drain_at + settle_s)
            by_engine: Dict[str, int] = {}
            for r in recs:
                if r.kind == "ok" and r.engine:
                    by_engine[r.engine] = by_engine.get(r.engine, 0) + 1
            return {"kinds": _kinds(recs),
                    "drained_engine": victim,
                    "drain_at_s": round(drain_at - t0, 2),
                    "steady_after_s": round(drain_at + settle_s - t0, 2),
                    "affinity_hit_rate": round(hit, 4)
                    if hit is not None else None,
                    "requests": len(recs),
                    "requests_by_engine": by_engine}

        # --- phase 1: single-router control ----------------------------
        logger.info("multirouter phase 1/4: single-router control "
                    "(%.0fs)", phase_duration_s)
        control = await affinity_phase(router_urls[0], router_urls[0])
        detail["control"] = control

        # --- phase 2: the pair, drain issued via one router ------------
        logger.info("multirouter phase 2/4: pair behind the splitter "
                    "(%.0fs)", phase_duration_s)
        pair = await affinity_phase(splitter.url, router_urls[0])
        detail["pair"] = pair

        # breaker convergence: burst one engine into 500s while a
        # short storm runs; both routers must report it open within
        # one probe interval of each other. The victim is the engine
        # the pair phase routed MOST traffic to (x-engine-id is
        # host:port — the URL minus scheme), so session hashing can
        # never pick a burst target the storm's sessions skip.
        if not skip_convergence:
            by_engine = pair.get("requests_by_engine") or {}
            burst_victim = engine_urls[0]
            if by_engine:
                busiest = max(by_engine, key=by_engine.get)
                candidate = f"http://{busiest}"
                if candidate in engine_urls:
                    burst_victim = candidate
            t_conv = time.monotonic()
            storm_task = asyncio.create_task(_storm(
                splitter.url, model,
                deadline=t_conv + convergence_storm_s,
                sessions=plain_sessions, num_tokens=num_tokens))
            await asyncio.sleep(0.5)
            await _inject_error_burst(burst_victim, count=12)
            opened = await _routers_report_state(
                router_urls, burst_victim, want_open=True,
                timeout_s=6.0)
            closed = await _routers_report_state(
                router_urls, burst_victim, want_open=False,
                timeout_s=8.0)
            await storm_task
            times = [t for t in opened.values() if t != float("inf")]
            convergence_s = (max(times) - min(times)) if len(times) == \
                len(router_urls) else float("inf")
            detail["breaker_convergence"] = {
                "victim": burst_victim,
                "open_report_s": {u: (round(t, 3) if t != float("inf")
                                      else None)
                                  for u, t in opened.items()},
                "close_report_s": {u: (round(t, 3) if t != float("inf")
                                       else None)
                                   for u, t in closed.items()},
                "open_spread_s": round(convergence_s, 3)
                if convergence_s != float("inf") else None,
                "probe_interval_s": 0.5,
            }

        # --- phase 3: router SIGKILL mid-storm -------------------------
        if not skip_kill:
            logger.info("multirouter phase 3/4: router SIGKILL "
                        "(%.0fs)", phase_duration_s)
            t0 = time.monotonic()
            deadline = t0 + phase_duration_s
            kill_at = t0 + phase_duration_s / 3.0
            victim_idx = len(router_procs) - 1
            events: List[Dict] = []

            async def killer():
                await asyncio.sleep(max(0.0, kill_at - time.monotonic()))
                victim = router_procs[victim_idx]
                victim.popen.kill()
                victim.popen.wait()
                events.append({"t_s": round(time.monotonic() - t0, 2),
                               "event": "router_kill",
                               "url": victim.url})
                logger.info("multirouter: killed %s", victim.url)
                await asyncio.sleep(2.0)
                router_procs[victim_idx] = _launch_router_replica(
                    victim_idx, ports[victim_idx], engine_urls, model,
                    [p for p in ports if p != ports[victim_idx]],
                    routing=routing, shared_state=shared_state,
                    max_inflight=max_inflight,
                    gossip_interval_s=gossip_interval_s,
                    log_dir=log_dir)
                events.append({"t_s": round(time.monotonic() - t0, 2),
                               "event": "router_restart",
                               "url": router_procs[victim_idx].url})
                try:
                    await wait_healthy(router_procs[victim_idx].url,
                                       30.0, require_endpoints=engines)
                    events.append(
                        {"t_s": round(time.monotonic() - t0, 2),
                         "event": "router_healthy",
                         "url": router_procs[victim_idx].url})
                except TimeoutError:
                    logger.warning("multirouter: %s not healthy after "
                                   "restart", router_procs[victim_idx].url)

            ktask = asyncio.create_task(killer())
            try:
                recs = await _storm(splitter.url, model,
                                    deadline=deadline,
                                    sessions=plain_sessions,
                                    num_tokens=num_tokens)
            finally:
                await asyncio.gather(ktask, return_exceptions=True)
            kill_rel = next((e["t_s"] for e in events
                             if e["event"] == "router_kill"), None)
            blip = []
            outside = []
            for r in recs:
                if r.kind in ("transport", "http_5xx"):
                    rel = r.t - t0
                    # the kill stamp lands AFTER popen.wait(); the
                    # dead replica's connections reset the instant the
                    # signal delivers, so the window opens 0.5s early
                    if kill_rel is not None and \
                            kill_rel - 0.5 <= rel <= \
                            kill_rel + blip_window_s:
                        blip.append(r.kind)
                    else:
                        outside.append((round(rel, 2), r.kind))
            detail["router_kill"] = {
                "kinds": _kinds(recs),
                "events": events,
                "kill_fired": kill_rel is not None,
                "blip_window_s": blip_window_s,
                "blip_errors": len(blip),
                "errors_outside_blip": outside[:20],
                "errors_outside_blip_count": len(outside),
                "splitter_connect_failovers": splitter.connect_failovers,
                "splitter_connections": dict(splitter.connections),
                "post_restart_ok": sum(
                    1 for r in recs
                    if r.kind == "ok" and kill_rel is not None
                    and r.t - t0 > kill_rel + blip_window_s),
            }

        # --- phase 4: tiered saturation sweep --------------------------
        if not skip_saturation:
            logger.info("multirouter phase 4/4: QoS saturation sweep "
                        "(%.0fs + %.0fs)", saturation_presat_s,
                        phase_duration_s)
            presat_sessions = \
                [(f"t0-{i}", "tier0") for i in range(tier0_users)] + \
                [(f"t1-{i}", "tier1") for i in range(tier1_users)]
            t0 = time.monotonic()
            pre = await _storm(splitter.url, model,
                               deadline=t0 + saturation_presat_s,
                               sessions=presat_sessions,
                               num_tokens=num_tokens)
            pre_window = saturation_presat_s
            sat_sessions = presat_sessions + \
                [(f"t2-{i}", "tier2") for i in range(tier2_users)]
            t1 = time.monotonic()
            sat = await _storm(splitter.url, model,
                               deadline=t1 + phase_duration_s,
                               sessions=sat_sessions,
                               num_tokens=num_tokens)

            def tier_stats(recs, window_s):
                out = {}
                for tier in ("tier0", "tier1", "tier2"):
                    rows = [r for r in recs if r.tier == tier]
                    kinds = _kinds(rows)
                    total = len(rows)
                    lat = [r.latency_s for r in rows if r.kind == "ok"]
                    out[tier] = {
                        **kinds,
                        "goodput_qps": round(kinds["ok"] / window_s, 2),
                        "shed_fraction": round(kinds["shed"] / total, 4)
                        if total else None,
                        "latency_p50_ms": round(
                            percentile(lat, 50) * 1e3, 1) if lat else None,
                        "latency_p99_ms": round(
                            percentile(lat, 99) * 1e3, 1) if lat else None,
                    }
                return out

            detail["saturation"] = {
                "presat_s": pre_window,
                "saturated_s": phase_duration_s,
                "max_inflight_per_router": max_inflight,
                "qos_tiers": QOS_TIERS,
                "presat": tier_stats(pre, pre_window),
                "saturated": tier_stats(sat, phase_duration_s),
            }
            # per-tier QoS counters off one router's /metrics
            detail["saturation"]["router_qos_metrics"] = \
                await _scrape_qos(router_urls[0])
    finally:
        if splitter is not None:
            await splitter.close()
        current = list(router_procs)
        current.extend(p for p in procs if p not in current)
        _stop(current)

    if overhead_guard:
        detail["overhead_guard"] = await _overhead_guard(
            users=overhead_users, duration_s=overhead_duration_s,
            gossip_interval_s=gossip_interval_s, platform=platform,
            log_dir=log_dir, startup_timeout_s=startup_timeout_s)

    pair_hit = (detail.get("pair") or {}).get("affinity_hit_rate")
    return {
        "metric": "multi-router control plane: pair affinity hit rate "
                  "behind an L4 split vs the single-router control "
                  "(+ router-kill blip containment, breaker "
                  "convergence, QoS tier degradation)",
        "value": round(100.0 * pair_hit, 2) if pair_hit is not None
        else None,
        "unit": "%",
        "platform": platform,
        "detail": {
            "engine": engine, "engines": engines, "routers": routers,
            "routing": routing, "sessions": sessions,
            "shared_state": shared_state,
            "gossip_interval_s": gossip_interval_s,
            "phase_duration_s": phase_duration_s,
            **detail,
        },
    }


async def _scrape_qos(router_url: str) -> Dict[str, float]:
    import re
    wanted = ("tpu:router_qos_sheds_total",
              "tpu:router_qos_preemptions_total",
              "tpu:router_affinity_moves_total",
              "tpu:router_peers")
    out: Dict[str, float] = {}
    try:
        async with aiohttp.ClientSession() as s:
            async with s.get(f"{router_url}/metrics",
                             timeout=aiohttp.ClientTimeout(total=5)) as r:
                text = await r.text()
    except (aiohttp.ClientError, ConnectionError, OSError,
            asyncio.TimeoutError):
        return out
    for name in wanted:
        for m in re.finditer(
                rf"^{re.escape(name)}({{[^}}]*}})?\s+([0-9.eE+-]+)",
                text, re.M):
            out[f"{name}{m.group(1) or ''}"] = float(m.group(2))
    return out


async def _overhead_guard(*, users: int, duration_s: float,
                          gossip_interval_s: float, platform: str,
                          log_dir: str,
                          startup_timeout_s: float,
                          rounds: int = 2) -> Dict:
    """r7 band no-regression through one router of a shared-state
    pair: the A/B with gossip + QoS enabled vs the same-host plain
    baseline (the r14 guard convention — band OR baseline+10%).

    Both sides run ``rounds`` times ALTERNATING and each side keeps
    its best round (highest router-side req/s): the router-side
    number swings ±10% run-to-run on a busy host, and a guard that
    fails on a one-sided fluke teaches people to ignore it. Every
    round's numbers are reported."""
    from production_stack_tpu_torch.loadgen.overhead import run_overhead
    # an idle peer replica so the gossip loop has a real conversation
    # (its backend list is a dead port: it serves /peers, routes nothing)
    peer = launch_router(["http://127.0.0.1:9"], "fake-model",
                         free_port(), routing="roundrobin",
                         log_dir=log_dir,
                         extra_args=["--router-id", "guard-peer"])
    shared_runs: List[Dict] = []
    baseline_runs: List[Dict] = []
    try:
        await wait_healthy(peer.url, 30.0)
        for _ in range(max(1, rounds)):
            shared_runs.append(await run_overhead(
                engine="fake", users=users, duration_s=duration_s,
                platform=platform, log_dir=log_dir,
                startup_timeout_s=startup_timeout_s,
                router_extra_args=["--router-id", "guard-shared",
                                   "--peer-routers", peer.url,
                                   "--peer-gossip-interval",
                                   str(gossip_interval_s),
                                   "--qos-tiers", QOS_TIERS]))
            baseline_runs.append(await run_overhead(
                engine="fake", users=users, duration_s=duration_s,
                platform=platform, log_dir=log_dir,
                startup_timeout_s=startup_timeout_s))
    finally:
        _stop([peer])

    def best(runs: List[Dict]) -> Dict:
        return max(runs,
                   key=lambda r: r["detail"]["router"]["req_per_s"])

    def side(run: Dict) -> Dict:
        return {"router_req_per_s": run["detail"]["router"]["req_per_s"],
                "errors": run["detail"]["router"]["errors"]
                + run["detail"]["direct"]["errors"]}

    shared, baseline = best(shared_runs), best(baseline_runs)
    return {
        "users": users, "duration_s": duration_s, "rounds": rounds,
        "overhead_ratio": shared["detail"]["overhead_ratio"],
        "baseline_ratio": baseline["detail"]["overhead_ratio"],
        "shared": side(shared),
        "baseline": side(baseline),
        "all_rounds": {
            "shared": [{"ratio": r["detail"]["overhead_ratio"],
                        **side(r)} for r in shared_runs],
            "baseline": [{"ratio": r["detail"]["overhead_ratio"],
                          **side(r)} for r in baseline_runs]},
    }


# ---------------------------------------------------------------- gates

def multirouter_violations(record: Dict, *,
                           affinity_tolerance: float = 0.05,
                           convergence_bound_s: Optional[float] = None,
                           min_tier0_hold: float = 0.95,
                           min_tier2_shed: float = 0.5,
                           max_overhead_ratio: Optional[float] = None
                           ) -> List[str]:
    """The multirouter contract (CLI exits 1 on any violation)."""
    d = record["detail"]
    out: List[str] = []

    control = d.get("control") or {}
    pair = d.get("pair") or {}
    c_hit, p_hit = control.get("affinity_hit_rate"), \
        pair.get("affinity_hit_rate")
    if c_hit is None or p_hit is None:
        out.append("affinity hit rate unmeasured (too few steady-"
                   "window samples)")
    elif p_hit < c_hit - affinity_tolerance:
        out.append(f"pair affinity hit rate {p_hit:.1%} is more than "
                   f"{affinity_tolerance:.0%} below the single-router "
                   f"control's {c_hit:.1%} — the routers disagree "
                   f"about the endpoint view (split-brain)")
    for phase_name, phase in (("control", control), ("pair", pair)):
        kinds = phase.get("kinds") or {}
        if kinds.get("http_5xx") or kinds.get("transport"):
            out.append(f"{phase_name} phase saw "
                       f"{kinds.get('http_5xx', 0)} client 5xx / "
                       f"{kinds.get('transport', 0)} transport errors "
                       f"(steady state must be clean)")

    conv = d.get("breaker_convergence")
    if conv is not None:
        spread = conv.get("open_spread_s")
        bound = convergence_bound_s if convergence_bound_s is not None \
            else conv.get("probe_interval_s", 1.0)
        if spread is None:
            out.append("breaker never reported open on every router "
                       "(convergence unmeasured)")
        elif spread > bound:
            out.append(f"breaker open-state spread {spread:.2f}s "
                       f"across routers exceeds the {bound:g}s "
                       f"probe-interval bound")

    kill = d.get("router_kill")
    if kill is not None:
        if not kill.get("kill_fired"):
            out.append("the router kill never fired")
        if kill.get("errors_outside_blip_count"):
            out.append(f"{kill['errors_outside_blip_count']} client "
                       f"errors OUTSIDE the kill blip window (first: "
                       f"{kill['errors_outside_blip'][:3]}) — only the "
                       f"bounded in-flight blip may surface")
        if not kill.get("post_restart_ok"):
            out.append("zero successful requests after the killed "
                       "router returned")

    sat = d.get("saturation")
    if sat is not None:
        pre0 = (sat.get("presat") or {}).get("tier0") or {}
        sat0 = (sat.get("saturated") or {}).get("tier0") or {}
        sat2 = (sat.get("saturated") or {}).get("tier2") or {}
        if not pre0.get("goodput_qps"):
            out.append("tier0 pre-saturation goodput unmeasured")
        elif (sat0.get("goodput_qps") or 0.0) < \
                min_tier0_hold * pre0["goodput_qps"]:
            out.append(
                f"tier0 goodput fell to {sat0.get('goodput_qps')} qps "
                f"under saturation ({pre0['goodput_qps']} qps "
                f"pre-saturation; must hold >= {min_tier0_hold:.0%})")
        if (sat2.get("shed_fraction") or 0.0) < min_tier2_shed:
            out.append(
                f"tier2 shed only {sat2.get('shed_fraction'):.0%} "
                f"under saturation (< {min_tier2_shed:.0%}: the sweep "
                f"never actually saturated, or low-tier-first "
                f"shedding is not engaging)")
        for tier in ("tier0", "tier1", "tier2"):
            kinds = (sat.get("saturated") or {}).get(tier) or {}
            if kinds.get("http_5xx") or kinds.get("transport"):
                out.append(f"saturation phase {tier}: "
                           f"{kinds.get('http_5xx', 0)} 5xx / "
                           f"{kinds.get('transport', 0)} transport "
                           f"errors (saturation must shed, not error)")

    guard = d.get("overhead_guard")
    if guard is not None and max_overhead_ratio is not None:
        ratio, base = guard.get("overhead_ratio"), \
            guard.get("baseline_ratio")
        if guard["shared"]["errors"] or guard["baseline"]["errors"]:
            out.append("overhead guard A/B saw errors — the ratio is "
                       "suspect")
        elif ratio is None:
            out.append("overhead guard ratio unmeasured")
        elif ratio > max_overhead_ratio and \
                (base is None or ratio > base * 1.10) and \
                guard["shared"]["router_req_per_s"] < \
                0.9 * guard["baseline"]["router_req_per_s"]:
            # three escapes, any one passes: inside the band, within
            # 10% of the same-host baseline RATIO, or within 10% of
            # the baseline's router-side THROUGHPUT (the ratio's
            # denominator — the direct side — swings with host noise
            # the router never sees)
            out.append(
                f"shared-state overhead ratio {ratio:.2f}x exceeds "
                f"the {max_overhead_ratio:g}x band, the same-host "
                f"baseline {base:.2f}x + 10%, and router-side "
                f"throughput {guard['shared']['router_req_per_s']} "
                f"req/s is more than 10% under the baseline's "
                f"{guard['baseline']['router_req_per_s']}")
    return out
