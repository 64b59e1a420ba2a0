"""incident mode: prove the fleet flight recorder closes the loop.

The obsplane (production_stack_tpu_torch/obsplane) is only worth shipping if
(a) a clean fleet yields ZERO spurious incident bundles while its
online stitcher is demonstrably joining chains, and (b) when a real
fault burns a real SLO, the alert arrives WITH the fleet-wide evidence
attached: exactly one self-contained bundle in which every fleet
process is represented and the machine-written attribution names the
injected culprit process and the correct phase. This rig closes that
loop with the r14 firedrill machinery scaled to a fleet:

1. **Fleet**: N peered routers (r16 gossip) + M engines + the
   obsplane, all real subprocesses; SLO windows scaled to seconds
   (firedrill's ``drill_slo_config``), resilience masking disabled
   (the drill measures detection + attribution, not hiding).
2. **Baseline** (false-positive gate): a mixed chat/rag storm across
   every router; zero bundles may be captured, zero alerts fire, the
   storm sees zero 5xx — and the stitcher must show complete chains
   (an obsplane that stitches nothing would pass every other gate
   vacuously).
3. **Scenarios**, each: inject -> the expected alert fires (observed
   through the obsplane's OWN ``/fleet`` view) -> exactly one bundle
   appears -> the bundle holds every fleet process AND its attribution
   names the injected process and phase -> clear -> resolve -> settle:

   - ``slow_ttft``    — TTFT inflation on ONE engine ->
     ``chat_ttft_page``; attribution must name that engine, phase
     ``prefill`` (the per-process phase scoreboard)
   - ``engine_down``  — SIGKILL one engine, no goodbye ->
     ``chat_availability_page``; attribution must name the corpse,
     phase ``down`` (the unreachable-process rule)
   - ``shed_storm``   — a concurrency burst aimed at ONE router past
     its ``--max-inflight`` -> ``shed_rate_page``; attribution must
     name that router, phase ``admission`` (the shed-delta rule)

``--overhead-guard`` runs the r7 A/B twice — once with an obsplane
scraping the serving pair at the drill's poll interval, once without —
and fails only when the scraped side breaks the band AND exceeds the
same-host unscraped baseline by >10% (the multirouter guard shape).

Committed record: ``INCIDENT_r18.json`` via
``benchmarks/run_incident.sh``; exit 1 on any spurious capture, missed
alert, missing/extra bundle, incomplete bundle, or wrong attribution.
"""

import asyncio
import json
import os
import time
from typing import Dict, List, Optional

import aiohttp

from production_stack_tpu_torch.loadgen.firedrill import (
    ROUTER_FIREDRILL_ARGS, _Control, drill_slo_config)
from production_stack_tpu_torch.loadgen.orchestrator import (Proc, _stop,
                                                       free_port,
                                                       launch_engine,
                                                       launch_obsplane,
                                                       launch_router,
                                                       wait_healthy)
from production_stack_tpu_torch.slo import WINDOWS
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

CHAT_PATH = "/v1/chat/completions"

SCENARIO_NAMES = ("slow_ttft", "engine_down", "shed_storm")
# scenarios driving the fake's /fault endpoint; a real-engine drill
# keeps the process-level kill and the router-side shed storm
_FAKE_ONLY = ("slow_ttft",)

EXPECTED = {
    # scenario -> (alert, culprit role, phase)
    "slow_ttft": ("chat_ttft_page", "engine", "prefill"),
    "engine_down": ("chat_availability_page", "engine", "down"),
    "shed_storm": ("shed_rate_page", "router", "admission"),
}


class _FleetStorm:
    """Closed-loop mixed chat/rag storm spread across N router URLs
    (worker i pins to router i mod N), phase-tagged outcome counters —
    the firedrill storm shape, fleet-wide."""

    def __init__(self, router_urls: List[str], model: str, *,
                 users: int, num_tokens: int,
                 request_timeout_s: float = 20.0):
        self.urls = list(router_urls)
        self.model = model
        self.users = users
        self.num_tokens = num_tokens
        self.timeout = aiohttp.ClientTimeout(total=request_timeout_s)
        self.phase = "baseline"
        self.counters: Dict[str, dict] = {}
        self._tasks: List[asyncio.Task] = []
        self._stopping = False

    def _c(self) -> dict:
        c = self.counters.get(self.phase)
        if c is None:
            c = self.counters[self.phase] = {
                "launched": 0, "ok": 0, "http_5xx": 0, "http_4xx": 0,
                "shed": 0, "transport_errors": 0, "samples": []}
        return c

    async def _one(self, session: aiohttp.ClientSession, url: str,
                   i: int, n: int) -> None:
        rag = (n % 5) == 0
        headers = {"Content-Type": "application/json"}
        if rag:
            headers["x-slo-class"] = "rag"
        body = json.dumps({
            "model": self.model,
            "messages": [{"role": "user",
                          "content": f"incident u{i} r{n}"
                                     + (" ctx " * 40 if rag else "")}],
            "max_tokens": self.num_tokens, "stream": False}).encode()
        c = self._c()
        c["launched"] += 1
        try:
            async with session.post(f"{url}{CHAT_PATH}", data=body,
                                    headers=headers,
                                    timeout=self.timeout) as resp:
                await resp.read()
                if resp.status < 400:
                    c["ok"] += 1
                elif resp.status in (429, 503) and \
                        "Retry-After" in resp.headers:
                    c["shed"] += 1
                elif resp.status >= 500:
                    c["http_5xx"] += 1
                    if len(c["samples"]) < 5:
                        c["samples"].append(f"HTTP {resp.status}")
                else:
                    c["http_4xx"] += 1
        except (aiohttp.ClientError, ConnectionError, OSError,
                asyncio.TimeoutError) as e:
            c["transport_errors"] += 1
            if len(c["samples"]) < 5:
                c["samples"].append(f"{type(e).__name__}: {e}")

    async def _worker(self, i: int) -> None:
        url = self.urls[i % len(self.urls)]
        n = i
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0)) as session:
            while not self._stopping:
                await self._one(session, url, i, n)
                n += self.users
                await asyncio.sleep(0.02)

    def start(self) -> None:
        self._tasks = [asyncio.create_task(self._worker(i))
                       for i in range(self.users)]

    async def stop(self) -> None:
        self._stopping = True
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)

    def totals(self) -> dict:
        return dict(self.counters)


class _Burst:
    """The shed-storm lever: ``users`` concurrent workers hammering
    ONE router back to back (no think time) until stopped — admission
    pressure, aimed, so the shed delta lands on a known process."""

    def __init__(self, url: str, model: str, users: int,
                 num_tokens: int):
        self.url = url
        self.model = model
        self.users = users
        self.num_tokens = num_tokens
        self._tasks: List[asyncio.Task] = []
        self._stopping = False
        self.launched = 0
        self.shed = 0

    async def _worker(self, i: int) -> None:
        body = json.dumps({
            "model": self.model,
            "messages": [{"role": "user", "content": f"burst {i}"}],
            "max_tokens": self.num_tokens, "stream": False}).encode()
        timeout = aiohttp.ClientTimeout(total=20)
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0)) as session:
            while not self._stopping:
                self.launched += 1
                try:
                    async with session.post(
                            f"{self.url}{CHAT_PATH}", data=body,
                            headers={"Content-Type":
                                     "application/json"},
                            timeout=timeout) as resp:
                        await resp.read()
                        if resp.status in (429, 503):
                            self.shed += 1
                            await asyncio.sleep(0.01)
                except (aiohttp.ClientError, ConnectionError, OSError,
                        asyncio.TimeoutError):
                    await asyncio.sleep(0.05)

    def start(self) -> None:
        self._tasks = [asyncio.create_task(self._worker(i))
                       for i in range(self.users)]

    async def stop(self) -> None:
        self._stopping = True
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)


async def _obsplane_get(control: _Control, url: str,
                        path: str) -> Optional[dict]:
    try:
        async with control.session.get(
                f"{url}{path}",
                timeout=aiohttp.ClientTimeout(total=5)) as r:
            if r.status == 200:
                return await r.json()
            control.errors.append(f"GET {path} -> HTTP {r.status}")
    except (aiohttp.ClientError, ConnectionError, OSError,
            asyncio.TimeoutError) as e:
        control.errors.append(f"GET {path} -> {type(e).__name__}: {e}")
    return None


async def _wait_fleet(control: _Control, obs_url: str, predicate,
                      timeout_s: float,
                      poll_s: float = 0.3) -> Optional[float]:
    """Poll the obsplane's /fleet until ``predicate(payload)``;
    seconds it took, or None on timeout."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        payload = await _obsplane_get(control, obs_url, "/fleet")
        if payload is not None and predicate(payload):
            return round(time.monotonic() - t0, 2)
        await asyncio.sleep(poll_s)
    return None


def bundle_completeness(bundle: dict,
                        expected: Dict[str, str]) -> List[str]:
    """Every fleet process must be represented in the bundle with the
    payloads its role owes (last-known state for a dead process) —
    returns what is missing. ``expected`` is {url: role}."""
    missing = []
    processes = (bundle.get("fleet") or {}).get("processes") or {}
    for url, role in expected.items():
        p = processes.get(url.rstrip("/"))
        if p is None:
            missing.append(f"{url}: absent from bundle")
            continue
        if role == "router":
            if p.get("health") is None:
                missing.append(f"{url}: no /health snapshot")
            if p.get("alerts") is None:
                missing.append(f"{url}: no /alerts snapshot")
        else:
            if p.get("load") is None:
                missing.append(f"{url}: no /load snapshot")
            if p.get("perf") is None:
                missing.append(f"{url}: no /debug/perf snapshot")
    return missing


async def run_incident(*, engines: int = 3,
                       routers: int = 2,
                       engine: str = "fake",
                       users: int = 8,
                       baseline_s: float = 10.0,
                       window_scale: float = 0.01,
                       scenarios: Optional[List[str]] = None,
                       detect_timeout_s: Optional[float] = None,
                       resolve_timeout_s: Optional[float] = None,
                       num_tokens: int = 4,
                       fake_tokens_per_s: float = 400.0,
                       slow_ttft_arg_s: float = 0.4,
                       ttft_threshold_s: Optional[float] = None,
                       max_inflight: int = 24,
                       burst_users: int = 64,
                       min_events: int = 4,
                       routing: str = "roundrobin",
                       platform: str = "cuda",
                       log_dir: str = "loadgen-logs",
                       incident_dir: Optional[str] = None,
                       poll_interval_s: float = 0.3,
                       capture_cooldown_s: float = 5.0,
                       startup_timeout_s: float = 420.0,
                       overhead_guard: bool = False,
                       overhead_users: int = 48,
                       overhead_duration_s: float = 10.0) -> Dict:
    """Launch the fleet + obsplane, storm, run the fault scenarios;
    return the INCIDENT record."""
    if scenarios is None:
        scenarios = list(SCENARIO_NAMES)
    if engine != "fake":
        dropped = [s for s in scenarios if s in _FAKE_ONLY]
        if dropped:
            logger.warning("real-engine incident drill: dropping "
                           "fake-only scenarios %s", dropped)
        scenarios = [s for s in scenarios if s not in _FAKE_ONLY]
    unknown = [s for s in scenarios if s not in SCENARIO_NAMES]
    if unknown:
        raise ValueError(f"unknown scenarios {unknown}; "
                         f"options: {list(SCENARIO_NAMES)}")
    if not scenarios:
        # a drill with zero scenarios would pass every gate vacuously
        raise ValueError("no scenarios left to run (real-engine mode "
                         "drops the fake-only ones — pick from "
                         f"{[s for s in SCENARIO_NAMES if s not in _FAKE_ONLY]})")
    if ttft_threshold_s is None:
        # the 0.25s bar is calibrated for the zero-think fake; a real
        # debug-tiny on a CPU host prefills in hundreds of ms, so the
        # same bar fires chat_ttft_page on a CLEAN baseline and the
        # spurious-capture gate (correctly) fails the drill
        ttft_threshold_s = 0.25 if engine == "fake" else 2.0

    long_w = WINDOWS["1h"] * window_scale
    ticket_short_w = WINDOWS["30m"] * window_scale
    if detect_timeout_s is None:
        detect_timeout_s = max(15.0, 0.85 * long_w + 10.0)
    if resolve_timeout_s is None:
        # floor: the ticket pair's short window must flush its bad
        # events (36s at scale 0.02) plus the scaled resolve hold —
        # and a real engine's post-restart tail (requests launched
        # against the warming replica) eats several more seconds, so
        # the slack is sized past the firedrill default
        resolve_timeout_s = max(15.0, ticket_short_w + 25.0)
    settle_s = ticket_short_w + 1.0

    os.makedirs(log_dir, exist_ok=True)
    if incident_dir is None:
        incident_dir = os.path.join(log_dir, "incidents")
    slo_cfg = drill_slo_config(window_scale, min_events=min_events,
                               ttft_threshold_s=ttft_threshold_s)
    slo_cfg_path = os.path.join(log_dir, "incident_slo_config.json")
    with open(slo_cfg_path, "w") as f:
        json.dump(slo_cfg, f, indent=2)

    procs: List[Proc] = []
    engine_procs: List[Proc] = []
    router_procs: List[Proc] = []
    fake_args = ["--tokens-per-s", str(fake_tokens_per_s),
                 "--num-tokens", str(num_tokens)] \
        if engine == "fake" else None
    record_scenarios: List[dict] = []
    storm = None
    try:
        for _ in range(engines):
            engine_procs.append(launch_engine(
                engine, free_port(), log_dir=log_dir, platform=platform,
                extra_args=fake_args))
        procs.extend(engine_procs)
        await asyncio.gather(*[wait_healthy(e.url, startup_timeout_s)
                               for e in engine_procs])
        model = "fake-model" if engine == "fake" else engine

        router_ports = [free_port() for _ in range(routers)]
        router_urls = [f"http://127.0.0.1:{p}" for p in router_ports]
        for i, port in enumerate(router_ports):
            peers = [u for j, u in enumerate(router_urls) if j != i]
            extra = (ROUTER_FIREDRILL_ARGS
                     + ["--slo-config", slo_cfg_path,
                        "--max-inflight", str(max_inflight),
                        "--router-id", f"router-{i}"])
            if peers:
                extra += ["--peer-routers", ",".join(peers),
                          "--peer-gossip-interval", "0.5"]
            router_procs.append(launch_router(
                [e.url for e in engine_procs], model, port,
                routing=routing, log_dir=log_dir, extra_args=extra))
        procs.extend(router_procs)
        await asyncio.gather(*[
            wait_healthy(r.url, 60.0, require_endpoints=engines)
            for r in router_procs])

        obsplane = launch_obsplane(
            router_urls, [e.url for e in engine_procs], free_port(),
            log_dir=log_dir, incident_dir=incident_dir,
            extra_args=["--poll-interval", str(poll_interval_s),
                        "--scrape-timeout", "2",
                        "--capture-cooldown", str(capture_cooldown_s),
                        "--attribution-lookback",
                        str(detect_timeout_s + 15.0)])
        procs.append(obsplane)
        await wait_healthy(obsplane.url, 60.0)

        logger.info("incident drill: %d users vs %d routers + %d %s "
                    "engines + obsplane, window_scale %g, scenarios %s",
                    users, routers, engines, engine, window_scale,
                    scenarios)
        async with aiohttp.ClientSession() as control_session:
            control = _Control(control_session)
            storm = _FleetStorm(router_urls, model, users=users,
                                num_tokens=num_tokens)
            storm.start()
            t0 = time.monotonic()

            # ---------------------------------------------- baseline
            await asyncio.sleep(baseline_s)
            baseline_fleet = await _obsplane_get(control, obsplane.url,
                                                 "/fleet") or {}
            baseline_traces = await _obsplane_get(
                control, obsplane.url, "/fleet/traces") or {}
            baseline_incidents = len(baseline_fleet.get("incidents",
                                                        []))
            baseline_firing = list(baseline_fleet.get("firing_alerts",
                                                      []))
            baseline_states = {
                url: p.get("state")
                for url, p in (baseline_fleet.get("processes")
                               or {}).items()}

            expected_procs = {r.url: "router" for r in router_procs}
            expected_procs.update(
                {e.url: "engine" for e in engine_procs})

            # ---------------------------------------------- scenarios
            seen_incidents = baseline_incidents
            burst: Optional[_Burst] = None
            killed: Dict[str, int] = {}

            async def inject(name: str) -> (bool, str):
                nonlocal burst
                if name == "slow_ttft":
                    victim = engine_procs[-1]
                    ok = await control.post_fault(
                        victim.url, {"mode": "slow_ttft",
                                     "arg": slow_ttft_arg_s,
                                     "count": -1})
                    return ok, victim.url
                if name == "engine_down":
                    victim = engine_procs[0]
                    victim.popen.kill()
                    victim.popen.wait()
                    killed[name] = 0
                    logger.info("incident: killed %s", victim.url)
                    return True, victim.url
                if name == "shed_storm":
                    target = router_procs[0]
                    burst = _Burst(target.url, model, burst_users,
                                   num_tokens)
                    burst.start()
                    return True, target.url
                raise AssertionError(name)

            async def clear(name: str) -> bool:
                nonlocal burst
                if name == "slow_ttft":
                    return await control.post_fault(
                        engine_procs[-1].url, {"mode": None})
                if name == "engine_down":
                    idx = killed.pop(name)
                    port = int(engine_procs[idx].url.rsplit(":", 1)[1])
                    engine_procs[idx] = launch_engine(
                        engine, port, log_dir=log_dir,
                        platform=platform, extra_args=fake_args)
                    # the finally-block _stop() walks `procs`, which
                    # holds the ORIGINAL (now dead) Proc — the
                    # replacement must join it or it leaks past the
                    # drill
                    procs.append(engine_procs[idx])
                    try:
                        # a REAL engine re-pays its XLA warmup here:
                        # the restart gets the same budget as launch
                        await wait_healthy(engine_procs[idx].url,
                                           startup_timeout_s)
                    except TimeoutError:
                        control.errors.append(
                            f"{engine_procs[idx].url} not healthy "
                            f"after restart")
                        return False
                    return True
                if name == "shed_storm":
                    if burst is not None:
                        await burst.stop()
                        burst = None
                    return True
                raise AssertionError(name)

            for name in scenarios:
                expected_alert, _role, expected_phase = EXPECTED[name]
                storm.phase = name
                await asyncio.sleep(0.5)
                injected_ok, culprit_url = await inject(name)
                injected_at = time.monotonic()

                detected_in = await _wait_fleet(
                    control, obsplane.url,
                    lambda p: any(a.get("name") == expected_alert
                                  for a in p.get("firing_alerts", [])),
                    detect_timeout_s)

                # the capture rides the SAME firing transition the
                # detection saw; give the poll loop a couple of beats
                captured_in = await _wait_fleet(
                    control, obsplane.url,
                    lambda p: len(p.get("incidents", []))
                    > seen_incidents,
                    max(10.0, 5 * poll_interval_s + 5.0)) \
                    if detected_in is not None else None

                fleet_now = await _obsplane_get(control, obsplane.url,
                                                "/fleet") or {}
                incidents_now = fleet_now.get("incidents", [])
                new_bundles = incidents_now[seen_incidents:]
                seen_incidents = len(incidents_now)

                bundle = None
                completeness: List[str] = []
                attribution = {}
                if len(new_bundles) >= 1:
                    bundle = await _obsplane_get(
                        control, obsplane.url,
                        f"/fleet/incidents/"
                        f"{new_bundles[0]['incident_id']}")
                if bundle is not None:
                    completeness = bundle_completeness(bundle,
                                                       expected_procs)
                    attribution = bundle.get("attribution") or {}

                cleared_ok = await clear(name)
                resolved_in = await _wait_fleet(
                    control, obsplane.url,
                    lambda p: not p.get("firing_alerts"),
                    resolve_timeout_s) if detected_in is not None \
                    else None

                storm.phase = "settle"
                await asyncio.sleep(settle_s)
                post_settle_quiet = await _wait_fleet(
                    control, obsplane.url,
                    lambda p: not p.get("firing_alerts"),
                    resolve_timeout_s)
                # fold captures that arrived during settle into THIS
                # scenario's count (a late ticket-pair capture would
                # otherwise blame the next scenario)
                fleet_settled = await _obsplane_get(
                    control, obsplane.url, "/fleet") or fleet_now
                late = len(fleet_settled.get("incidents", [])) \
                    - seen_incidents
                seen_incidents += max(0, late)

                record_scenarios.append({
                    "name": name,
                    "expected_alert": expected_alert,
                    "expected_process": culprit_url,
                    "expected_phase": expected_phase,
                    "injected_ok": injected_ok,
                    "cleared_ok": cleared_ok,
                    "t_inject_s": round(injected_at - t0, 2),
                    "detected_in_s": detected_in,
                    "captured_in_s": captured_in,
                    "bundles_captured": len(new_bundles) + max(0, late),
                    "bundle_id": (new_bundles[0]["incident_id"]
                                  if new_bundles else None),
                    "bundle_missing": completeness,
                    "attribution": {
                        k: attribution.get(k)
                        for k in ("process", "role", "phase",
                                  "confidence", "reason")},
                    "attribution_process_ok":
                        (attribution.get("process") or "").rstrip("/")
                        == culprit_url.rstrip("/"),
                    "attribution_phase_ok":
                        attribution.get("phase") == expected_phase,
                    "resolved_in_s": resolved_in,
                    "post_settle_quiet": post_settle_quiet is not None,
                })
                logger.info(
                    "incident %s: detected=%s captured=%s bundle=%s "
                    "attribution=%s/%s ok=%s/%s resolved=%s",
                    name, detected_in, captured_in,
                    record_scenarios[-1]["bundle_id"],
                    attribution.get("process"), attribution.get("phase"),
                    record_scenarios[-1]["attribution_process_ok"],
                    record_scenarios[-1]["attribution_phase_ok"],
                    resolved_in)

            storm.phase = "final"
            await asyncio.sleep(1.0)
            final_fleet = await _obsplane_get(control, obsplane.url,
                                              "/fleet") or {}
            await storm.stop()
            if burst is not None:
                await burst.stop()
            storm_totals = storm.totals()
            control_errors = list(control.errors)
            elapsed = time.monotonic() - t0
    finally:
        if storm is not None and not storm._stopping:
            await storm.stop()
        _stop(procs)

    overhead = None
    if overhead_guard:
        overhead = await _run_overhead_guard(
            users=overhead_users, duration_s=overhead_duration_s,
            num_tokens=num_tokens, platform=platform, log_dir=log_dir,
            startup_timeout_s=startup_timeout_s,
            poll_interval_s=poll_interval_s)

    closed = [s for s in record_scenarios
              if s["detected_in_s"] is not None
              and s["bundles_captured"] == 1
              and not s["bundle_missing"]
              and s["attribution_process_ok"]
              and s["attribution_phase_ok"]
              and s["resolved_in_s"] is not None]
    baseline_storm = storm_totals.get(
        "baseline", {"launched": 0, "ok": 0, "http_5xx": 0,
                     "http_4xx": 0, "shed": 0, "transport_errors": 0,
                     "samples": []})
    return {
        "metric": "fleet flight recorder: injected faults fire their "
                  "alert and yield one complete incident bundle whose "
                  "attribution names the culprit process and phase "
                  "(zero spurious captures on a clean fleet)",
        "value": round(100.0 * len(closed)
                       / max(1, len(record_scenarios)), 1),
        "unit": "% scenarios detected+captured+attributed+resolved",
        "platform": platform,
        "detail": {
            "engine": engine, "engines": engines, "routers": routers,
            "users": users, "routing": routing,
            "duration_s": round(elapsed, 1),
            "window_scale": window_scale,
            "windows_s": {lbl: round(w * window_scale, 2)
                          for lbl, w in WINDOWS.items()},
            "min_events": min_events,
            "baseline_s": baseline_s,
            "detect_timeout_s": round(detect_timeout_s, 1),
            "resolve_timeout_s": round(resolve_timeout_s, 1),
            "settle_s": round(settle_s, 1),
            "poll_interval_s": poll_interval_s,
            "capture_cooldown_s": capture_cooldown_s,
            "max_inflight": max_inflight,
            "burst_users": burst_users,
            "incident_dir": incident_dir,
            "baseline": {
                "storm": baseline_storm,
                "bundles_captured": baseline_incidents,
                "firing_alerts": baseline_firing,
                "process_states": baseline_states,
                "stitch": (baseline_traces.get("stats") or {}),
                "fleet_percentile_classes": sorted(
                    (baseline_traces.get("fleet_percentiles")
                     or {}).keys()),
            },
            "scenarios": record_scenarios,
            "final": {
                "firing_alerts": list(final_fleet.get("firing_alerts",
                                                      [])),
                "bundles_total": len(final_fleet.get("incidents", [])),
                "captures_suppressed": final_fleet.get(
                    "captures_suppressed", 0),
                "stitch": final_fleet.get("chains", {}),
                "scrape_errors_total": final_fleet.get(
                    "scrape_errors_total", {}),
            },
            "storm": storm_totals,
            "control_errors": control_errors,
            "overhead_guard": overhead,
        },
    }


async def _run_overhead_guard(*, users: int, duration_s: float,
                              num_tokens: int, platform: str,
                              log_dir: str, startup_timeout_s: float,
                              poll_interval_s: float,
                              rounds: int = 2) -> dict:
    """The r7 A/B with the obsplane scraping the serving pair vs the
    same host without it. Both sides run ``rounds`` times ALTERNATING
    and each keeps its best round (highest router-side req/s) — the
    multirouter guard convention: single-host ratios swing ±10%
    run-to-run, and a guard that fails on a one-sided fluke teaches
    people to ignore it. Every round's numbers are reported."""
    from production_stack_tpu_torch.loadgen.overhead import run_overhead

    class _Companion:
        def __init__(self, engine_url: str, router_url: str):
            self.engine_url = engine_url
            self.router_url = router_url
            self.proc: Optional[Proc] = None

        async def __aenter__(self):
            self.proc = launch_obsplane(
                [self.router_url], [self.engine_url], free_port(),
                log_dir=log_dir,
                incident_dir=os.path.join(log_dir, "guard-incidents"),
                extra_args=["--poll-interval", str(poll_interval_s),
                            "--scrape-timeout", "2",
                            "--no-capture-on-alert"])
            await wait_healthy(self.proc.url, 30.0)
            return self

        async def __aexit__(self, *exc):
            _stop([self.proc])

    logger.info("incident: overhead guard — %d alternating r7 A/B "
                "rounds with the obsplane scraping the serving pair "
                "at %.1fs vs without...", max(1, rounds),
                poll_interval_s)
    scraped_runs: List[Dict] = []
    plain_runs: List[Dict] = []
    for _ in range(max(1, rounds)):
        scraped_runs.append(await run_overhead(
            engine="fake", users=users, duration_s=duration_s,
            num_tokens=num_tokens, platform=platform, log_dir=log_dir,
            startup_timeout_s=startup_timeout_s,
            companion=_Companion))
        plain_runs.append(await run_overhead(
            engine="fake", users=users, duration_s=duration_s,
            num_tokens=num_tokens, platform=platform, log_dir=log_dir,
            startup_timeout_s=startup_timeout_s))

    def best(runs: List[Dict]) -> Dict:
        return max(runs,
                   key=lambda r: r["detail"]["router"]["req_per_s"])

    def side(run: Dict) -> Dict:
        return {"router_req_per_s":
                run["detail"]["router"]["req_per_s"],
                "errors": run["detail"]["router"]["errors"]
                + run["detail"]["direct"]["errors"]}

    scraped, plain = best(scraped_runs), best(plain_runs)
    return {
        "users": users, "duration_s": duration_s,
        "rounds": max(1, rounds),
        "overhead_ratio": scraped["detail"]["overhead_ratio"],
        "baseline_ratio": plain["detail"]["overhead_ratio"],
        "scraped": side(scraped),
        "baseline": side(plain),
        "all_rounds": {
            "scraped": [{"ratio": r["detail"]["overhead_ratio"],
                         **side(r)} for r in scraped_runs],
            "baseline": [{"ratio": r["detail"]["overhead_ratio"],
                          **side(r)} for r in plain_runs]},
    }


def incident_violations(record: Dict,
                        max_overhead_ratio: Optional[float] = None,
                        min_chain_fraction: float = 0.5) -> List[str]:
    """The drill's pass/fail contract (CLI exits 1 on any)."""
    d = record["detail"]
    out: List[str] = []
    if d["control_errors"]:
        out.append(f"{len(d['control_errors'])} control-plane errors "
                   f"from the rig itself (first: "
                   f"{d['control_errors'][0]})")
    b = d["baseline"]
    if b["storm"]["http_5xx"] or b["storm"]["transport_errors"]:
        out.append(f"baseline storm saw {b['storm']['http_5xx']} 5xx / "
                   f"{b['storm']['transport_errors']} transport errors "
                   f"on a healthy fleet")
    if b["storm"]["ok"] == 0:
        out.append("baseline storm finished zero requests — the drill "
                   "measured nothing")
    if b["bundles_captured"]:
        out.append(f"{b['bundles_captured']} incident bundles captured "
                   f"during the clean baseline (spurious captures)")
    if b["firing_alerts"]:
        out.append(f"alerts firing during the clean baseline: "
                   f"{b['firing_alerts']}")
    stitch = b.get("stitch") or {}
    if not stitch.get("chains_complete"):
        out.append("the online stitcher completed zero chains during "
                   "the baseline — every later gate would pass "
                   "vacuously")
    elif stitch.get("complete_fraction", 0.0) < min_chain_fraction:
        out.append(f"baseline stitched-chain completeness "
                   f"{stitch.get('complete_fraction')} < "
                   f"{min_chain_fraction} — the join is leaking")
    for s in d["scenarios"]:
        if not s["injected_ok"]:
            out.append(f"{s['name']}: fault injection failed")
        if s["detected_in_s"] is None:
            out.append(f"{s['name']}: {s['expected_alert']} never "
                       f"showed on the obsplane's /fleet view within "
                       f"{d['detect_timeout_s']}s (missed detection)")
            continue
        if s["bundles_captured"] == 0:
            out.append(f"{s['name']}: alert fired but no incident "
                       f"bundle was captured")
        elif s["bundles_captured"] > 1:
            out.append(f"{s['name']}: {s['bundles_captured']} bundles "
                       f"captured for one fault (dedup failed)")
        if s["bundle_missing"]:
            out.append(f"{s['name']}: bundle incomplete — "
                       f"{s['bundle_missing']}")
        if not s["attribution_process_ok"]:
            out.append(f"{s['name']}: attribution named "
                       f"{s['attribution'].get('process')!r}, expected "
                       f"{s['expected_process']!r}")
        if not s["attribution_phase_ok"]:
            out.append(f"{s['name']}: attribution named phase "
                       f"{s['attribution'].get('phase')!r}, expected "
                       f"{s['expected_phase']!r}")
        if s["resolved_in_s"] is None:
            out.append(f"{s['name']}: alerts did not resolve within "
                       f"{d['resolve_timeout_s']}s of clearing the "
                       f"fault")
        elif not s.get("post_settle_quiet", True):
            out.append(f"{s['name']}: alerts re-fired and stayed "
                       f"firing through the settle window")
        if not s["cleared_ok"]:
            out.append(f"{s['name']}: fault clear failed")
    f = d["final"]
    if f["firing_alerts"]:
        out.append(f"alerts still firing at drill end: "
                   f"{f['firing_alerts']}")
    expected_bundles = len(d["scenarios"]) \
        + d["baseline"]["bundles_captured"]
    if f["bundles_total"] > expected_bundles:
        out.append(f"{f['bundles_total']} bundles on the obsplane at "
                   f"drill end, expected {expected_bundles} (one per "
                   f"scenario)")
    guard = d.get("overhead_guard")
    if guard is not None and max_overhead_ratio is not None:
        ratio = guard.get("overhead_ratio")
        base = guard.get("baseline_ratio")
        if guard["scraped"]["errors"] or guard["baseline"]["errors"]:
            out.append("overhead guard A/B saw errors — the ratio is "
                       "suspect")
        elif ratio is None:
            out.append("overhead guard ratio unmeasured")
        elif ratio > max_overhead_ratio and \
                (base is None or ratio > base * 1.10) and \
                guard["scraped"]["router_req_per_s"] < \
                0.9 * guard["baseline"]["router_req_per_s"]:
            # three escapes, any one passes (the multirouter guard
            # convention): inside the band, within 10% of the
            # same-host unscraped RATIO, or within 10% of its
            # router-side THROUGHPUT (the ratio's denominator — the
            # direct side — swings with host noise the router and the
            # scraper never see)
            out.append(
                f"overhead ratio {ratio:.2f}x with the obsplane "
                f"scraping exceeds the {max_overhead_ratio:g}x band, "
                f"the same-host unscraped baseline {base:.2f}x + "
                f"10%, and router-side throughput "
                f"{guard['scraped']['router_req_per_s']} req/s is "
                f"more than 10% under the baseline's "
                f"{guard['baseline']['router_req_per_s']}")
    return out
