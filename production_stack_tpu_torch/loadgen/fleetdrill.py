"""fleetdrill: prove the fleet pilot closes BOTH loops off ``/fleet``.

The r20 fleet pilot makes two promises, and each is easy to fake:

- **burn-rate-driven scale-up** is only worth having if it beats the
  queue-delay loop it augments — so the drill runs the SAME latency
  burn twice, once with the pilot (``FleetSignalCollector`` +
  ``burn_rate_input``) and once with an embedded queue-delay-only
  control, and the pilot must resolve the alert with zero shed at
  LOWER replica-seconds (the fleet spends less total capacity-time
  burning because the page alert fires seconds before the queue-delay
  threshold crossing).
- **bounded auto-remediation** is only safe if the kill-switch is
  real — so alongside the hands-off drain->restart->verify scenario,
  an anti-vacuity run repeats the SAME injection with the kill-switch
  down and must show the remediation suppressed (logged
  ``suppressed_killswitch``) and the alert still burning.

Scenarios (all three run by default; ``exit 1`` on any violation):

1. ``burn`` — a latency burn whose severity is inversely proportional
   to fleet size (the drill's load model: per-engine ``slow_ttft`` =
   burn / replicas and a queue-delay ramp split across replicas,
   pushed via ``POST /fault`` — fake engines have no load-dependent
   latency of their own). The pilot's page alert (reason
   ``burn_rate``, ``signal_source: fleet``) scales up before the
   control's queue-delay threshold trips; both runs must resolve, the
   pilot with zero shed and strictly fewer replica-seconds from
   injection to resolution.
2. ``remediate`` — ``slow_ttft`` on ONE engine of a fixed fleet; the
   obsplane captures the incident, its attribution names the culprit,
   and the armed remediator drains it, restarts it, resets its
   breaker and verifies the alert resolves — hands-off, zero
   client-visible errors, EXACTLY ONE executed remediation in the
   decision log.
3. ``killswitch`` — the same injection with ``enabled=False``: the
   attempt must be logged ``suppressed_killswitch``, nothing may
   actuate, and the alert must still be firing when the drill checks
   — then the drill clears the fault itself and the alert must
   resolve (proving the suppressed run left a resolvable fleet, not a
   wedged one).

Committed record: ``FLEETDRILL_r20.json`` via
``benchmarks/run_fleetdrill.sh``.
"""

import asyncio
import json
import os
import time
from typing import Dict, List, Optional

import aiohttp

from production_stack_tpu_torch.autoscaler.collector import (
    FleetSignalCollector, SignalCollector)
from production_stack_tpu_torch.autoscaler.actuator import (Actuator,
                                                      LocalProcessActuator)
from production_stack_tpu_torch.autoscaler.controller import Autoscaler
from production_stack_tpu_torch.autoscaler.policy import (AutoscalerPolicy,
                                                    PolicyConfig)
from production_stack_tpu_torch.autoscaler.remediator import (RemediationPolicy,
                                                        Remediator)
from production_stack_tpu_torch.loadgen.firedrill import (_Control,
                                                    drill_slo_config)
from production_stack_tpu_torch.loadgen.incident import (_FleetStorm,
                                                   _obsplane_get,
                                                   _wait_fleet)
from production_stack_tpu_torch.loadgen.orchestrator import (Proc, _stop,
                                                       free_port,
                                                       launch_engine,
                                                       launch_obsplane,
                                                       launch_router,
                                                       wait_healthy)
from production_stack_tpu_torch.slo import WINDOWS
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

SCENARIO_NAMES = ("burn", "remediate", "killswitch")

ALERT = "chat_ttft_page"

# breaker effectively off (the drill's faults must reach the SLO
# engine, not be masked by r8 resilience), fast stats + SLO eval +
# dynamic-config reload — the firedrill shape plus the autoscaler's
# hot-reload knob
ROUTER_FLEETDRILL_ARGS = ["--failover-attempts", "1",
                          "--breaker-threshold", "1000000",
                          "--breaker-failure-rate", "1.01",
                          "--engine-stats-interval", "0.5",
                          "--request-timeout", "20",
                          "--slo-eval-interval", "0.25",
                          "--dynamic-config-interval", "0.3"]

FAKE_ARGS = ["--tokens-per-s", "400", "--num-tokens", "4"]


class _FixedActuator(Actuator):
    """A pinned fleet for the remediation scenarios: the remediator
    rides the autoscaler loop, but nothing may scale."""

    def __init__(self, count: int):
        self._replicas = count

    @property
    def replicas(self) -> int:
        return self._replicas

    async def apply(self, target: int, victims=None) -> None:
        raise RuntimeError("fixed fleet must not scale")


async def _firing(control: _Control, router_url: str) -> List[str]:
    body = await control.alerts(router_url)
    return list((body or {}).get("firing") or [])


def _storm_phase(storm: _FleetStorm, phase: str) -> dict:
    return storm.totals().get(phase) or {
        "launched": 0, "ok": 0, "http_5xx": 0, "http_4xx": 0,
        "shed": 0, "transport_errors": 0, "samples": []}


# ---------------------------------------------------------------- burn

async def _burn_run(*, pilot: bool,
                    window_scale: float,
                    users: int,
                    baseline_s: float,
                    detect_timeout_s: float,
                    resolve_timeout_s: float,
                    burn_ttft_s: float,
                    queue_ramp_ms_per_s: float,
                    queue_plateau_ms: float,
                    max_replicas: int,
                    tick_interval_s: float,
                    min_events: int,
                    log_dir: str,
                    startup_timeout_s: float) -> Dict:
    """One latency-burn pass: pilot (burn-rate input off /fleet) or the
    embedded queue-delay-only control. Same stack, same load model,
    same gates — only the signal path differs."""
    tag = "pilot" if pilot else "control"
    slo_cfg_path = os.path.join(log_dir, f"fleetdrill_slo_{tag}.json")
    with open(slo_cfg_path, "w") as f:
        json.dump(drill_slo_config(window_scale,
                                   min_events=min_events), f, indent=2)
    config_path = os.path.join(log_dir, f"fleetdrill-config-{tag}.json")
    decision_log = os.path.join(log_dir,
                                f"fleetdrill-decisions-{tag}.jsonl")

    actuator = LocalProcessActuator(
        engine="fake", dynamic_config_path=config_path,
        routing_logic="least_loaded", log_dir=log_dir,
        engine_extra_args=list(FAKE_ARGS),
        startup_timeout_s=startup_timeout_s, drain_timeout_s=20.0)
    procs: List[Proc] = []
    storm = None
    scaler = None
    obs_url = None
    try:
        urls = await actuator.start(1)
        router = launch_router(
            urls, actuator.model, free_port(), routing="least_loaded",
            log_dir=log_dir,
            extra_args=ROUTER_FLEETDRILL_ARGS
            + ["--slo-config", slo_cfg_path,
               "--dynamic-config-json", config_path])
        procs.append(router)
        actuator.router_url = router.url
        await wait_healthy(router.url, 60.0, require_endpoints=1)

        if pilot:
            # --engines-config makes the obsplane's scraped engine set
            # follow the elastic fleet (a scaled-up replica the
            # aggregator cannot see would hold the settling gate
            # forever); captures are off — this scenario measures the
            # scale input, the remediation scenarios own the bundles
            obsplane = launch_obsplane(
                [router.url], urls, free_port(), log_dir=log_dir,
                incident_dir=os.path.join(log_dir,
                                          "fleetdrill-burn-incidents"),
                extra_args=["--poll-interval", "0.3",
                            "--scrape-timeout", "2",
                            "--engines-config", config_path,
                            "--no-capture-on-alert"])
            procs.append(obsplane)
            await wait_healthy(obsplane.url, 60.0)
            obs_url = obsplane.url

        policy_cfg = PolicyConfig(
            min_replicas=1, max_replicas=max_replicas,
            target_queue_delay_ms=800.0, down_queue_delay_ms=100.0,
            target_utilization=0.95, down_utilization=0.10,
            up_cooldown_s=3.0, down_cooldown_s=120.0,
            up_breach_ticks=2, down_breach_ticks=20,
            burn_rate_input=pilot,
            # an un-breached phase bound: exercises the pilot's phase-
            # percentile input path without adding a second trigger
            phase_p95_targets=({"engine.prefill": 30000.0}
                               if pilot else None)).validate()
        if pilot:
            collector = FleetSignalCollector(
                actuator.endpoint_urls, obsplane_url=obs_url,
                router_url=router.url,
                poll_interval_s=tick_interval_s, freshness_s=5.0)
        else:
            collector = SignalCollector(
                actuator.endpoint_urls, router_url=router.url,
                poll_interval_s=tick_interval_s)
        scaler = Autoscaler(AutoscalerPolicy(policy_cfg), actuator,
                            collector, interval_s=tick_interval_s,
                            decision_log_path=decision_log)
        await scaler.start()

        async with aiohttp.ClientSession() as control_session:
            control = _Control(control_session)
            # idle-fleet pacing: baseline requests carry the RELIEVED
            # TTFT (burn / max_replicas, under the threshold) so the
            # baseline request rate matches the scaled-up fleet's.
            # Without it the fast baseline floods the page alert's
            # long window with good events and the burn cannot cross
            # 14.4% before the queue-delay threshold trips — the race
            # this scenario exists to measure would be unwinnable.
            pace_s = round(burn_ttft_s / max_replicas, 4)
            for u in actuator.endpoint_urls():
                await control.post_fault(u, {"mode": "slow_ttft",
                                             "arg": pace_s,
                                             "count": -1})
            storm = _FleetStorm([router.url], actuator.model,
                                users=users, num_tokens=4)
            storm.start()
            await asyncio.sleep(baseline_s)
            baseline_firing = await _firing(control, router.url)

            # ------------------------------------------ the load model
            # fake engines have no load-dependent latency, so the drill
            # IS the queueing model: per-engine TTFT = burn / replicas
            # (floored at the idle pacing set above)
            # (adding a replica halves every engine's latency, exactly
            # the relief a real scale-up buys) and a slow queue-delay
            # ramp split the same way — slow enough that the burn-rate
            # page alert beats the 800 ms threshold crossing by seconds
            storm.phase = "burn"
            t_inject = time.monotonic()
            stop_model = asyncio.Event()

            async def load_model():
                while not stop_model.is_set():
                    reps = max(1, actuator.replicas)
                    elapsed = time.monotonic() - t_inject
                    qd = min(queue_ramp_ms_per_s * elapsed,
                             queue_plateau_ms) / reps
                    body = {"mode": "slow_ttft",
                            "arg": round(max(pace_s,
                                             burn_ttft_s / reps), 4),
                            "count": -1,
                            "queue_delay_ms": round(qd, 1)}
                    for u in actuator.endpoint_urls():
                        await control.post_fault(u, body)
                    try:
                        await asyncio.wait_for(stop_model.wait(), 0.4)
                    except asyncio.TimeoutError:
                        pass

            model_task = asyncio.create_task(load_model())

            # ------------------- fire -> resolve, integrating replicas
            fired_in = resolved_in = None
            replica_seconds = 0.0
            last = time.monotonic()
            deadline = t_inject + detect_timeout_s + resolve_timeout_s
            while time.monotonic() < deadline:
                now = time.monotonic()
                replica_seconds += actuator.replicas * (now - last)
                last = now
                firing = await _firing(control, router.url)
                if ALERT in firing and fired_in is None:
                    fired_in = round(now - t_inject, 2)
                if fired_in is not None and ALERT not in firing:
                    resolved_in = round(now - t_inject, 2)
                    break
                if fired_in is None and \
                        now - t_inject > detect_timeout_s:
                    break
                await asyncio.sleep(0.3)

            stop_model.set()
            await model_task
            for u in actuator.endpoint_urls():
                await control.post_fault(u, {"mode": None,
                                             "queue_delay_ms": None})
            storm.phase = "settle"
            await asyncio.sleep(1.0)
            await storm.stop()
            control_errors = list(control.errors)

        await scaler.close()
        first_up = next((d for d in scaler.timeline()
                         if d.get("direction") == "up"), None)
        summary = scaler.summary()
        fleet_stats = None
        if pilot:
            fleet_stats = {"fleet_polls": collector.fleet_polls,
                           "fleet_failures": collector.fleet_failures,
                           "last_source": collector.last_source}
        return {
            "pilot": pilot,
            "baseline_firing": baseline_firing,
            "fired_in_s": fired_in,
            "resolved_in_s": resolved_in,
            "replica_seconds": round(replica_seconds, 1),
            "max_replicas_observed": summary["max_replicas_observed"],
            "scale_ups": summary["scale_ups"],
            "first_up_reason": (first_up or {}).get("reason"),
            "first_up_source": (first_up or {}).get("signal_source"),
            "fleet_collector": fleet_stats,
            "storm": _storm_phase(storm, "burn"),
            "control_errors": control_errors,
        }
    finally:
        if storm is not None and not storm._stopping:
            await storm.stop()
        if scaler is not None and scaler.healthy():
            await scaler.close()
        _stop(procs)
        await actuator.close()


# ---------------------------------------------- remediate / killswitch

async def _remediation_run(*, armed: bool,
                           window_scale: float,
                           engines: int,
                           users: int,
                           baseline_s: float,
                           detect_timeout_s: float,
                           resolve_timeout_s: float,
                           slow_ttft_arg_s: float,
                           tick_interval_s: float,
                           min_events: int,
                           log_dir: str,
                           startup_timeout_s: float) -> Dict:
    """One incident-loop pass: ``slow_ttft`` on engine 0 of a fixed
    fleet. ``armed=True`` is the hands-off drain->restart->verify run;
    ``armed=False`` is the kill-switch anti-vacuity run (suppression
    logged, alert must persist, drill cleans up)."""
    tag = "remediate" if armed else "killswitch"
    slo_cfg_path = os.path.join(log_dir, f"fleetdrill_slo_{tag}.json")
    with open(slo_cfg_path, "w") as f:
        json.dump(drill_slo_config(window_scale,
                                   min_events=min_events), f, indent=2)
    incident_dir = os.path.join(log_dir, f"fleetdrill-{tag}-incidents")

    procs: List[Proc] = []
    engine_procs: List[Proc] = []
    storm = None
    scaler = None
    remediator = None
    try:
        for _ in range(engines):
            engine_procs.append(launch_engine(
                "fake", free_port(), log_dir=log_dir,
                extra_args=list(FAKE_ARGS)))
        procs.extend(engine_procs)
        await asyncio.gather(*[wait_healthy(e.url, startup_timeout_s)
                               for e in engine_procs])
        urls = [e.url for e in engine_procs]

        # roundrobin, deliberately: it keeps routing a full 1/Nth of
        # traffic at the slow engine, so the bad fraction (1/N) burns
        # the 1% budget at page rate — least_loaded would starve the
        # victim of requests and mask the very incident being injected
        router = launch_router(
            urls, "fake-model", free_port(), routing="roundrobin",
            log_dir=log_dir,
            extra_args=ROUTER_FLEETDRILL_ARGS
            + ["--slo-config", slo_cfg_path])
        procs.append(router)
        await wait_healthy(router.url, 60.0, require_endpoints=engines)

        obsplane = launch_obsplane(
            [router.url], urls, free_port(), log_dir=log_dir,
            incident_dir=incident_dir,
            extra_args=["--poll-interval", "0.3",
                        "--scrape-timeout", "2",
                        "--capture-cooldown", "5",
                        "--attribution-lookback",
                        str(detect_timeout_s + 15.0)])
        procs.append(obsplane)
        await wait_healthy(obsplane.url, 60.0)

        async def restart_fn(url: str) -> bool:
            """The drill's process owner: kill the sick engine, relaunch
            on the SAME port (clean — faults live in process memory, so
            a restart IS the fix, like a real wedged runtime)."""
            url = url.rstrip("/")
            idx = urls.index(url)
            await asyncio.to_thread(_stop, [engine_procs[idx]])
            port = int(url.rsplit(":", 1)[1])
            newp = launch_engine("fake", port, log_dir=log_dir,
                                 extra_args=list(FAKE_ARGS))
            procs.append(newp)
            engine_procs[idx] = newp
            try:
                await wait_healthy(newp.url, 60.0)
            except TimeoutError:
                return False
            return True

        remediator = Remediator(
            obsplane_url=obsplane.url, router_urls=[router.url],
            policy=RemediationPolicy(
                enabled=armed,
                # the phase-excess attribution rule convicts with
                # MEDIUM confidence (only process death and shed deltas
                # earn "high") — the floor is an explicit drill knob,
                # not a default
                confidence_floor="medium",
                max_per_window=1, window_s=600.0, cooldown_s=60.0,
                drain_timeout_s=15.0, drain_poll_s=0.25,
                verify_timeout_s=resolve_timeout_s,
                verify_poll_s=0.5),
            restart_fn=restart_fn,
            engine_urls_fn=lambda: urls)
        policy_cfg = PolicyConfig(
            min_replicas=engines, max_replicas=engines,
            target_queue_delay_ms=1e9,
            down_queue_delay_ms=0.0).validate()
        collector = FleetSignalCollector(
            lambda: urls, obsplane_url=obsplane.url,
            router_url=router.url, poll_interval_s=tick_interval_s,
            freshness_s=5.0)
        scaler = Autoscaler(
            AutoscalerPolicy(policy_cfg), _FixedActuator(engines),
            collector, interval_s=tick_interval_s,
            decision_log_path=os.path.join(
                log_dir, f"fleetdrill-decisions-{tag}.jsonl"),
            remediator=remediator)
        await scaler.start()

        async with aiohttp.ClientSession() as control_session:
            control = _Control(control_session)
            storm = _FleetStorm([router.url], "fake-model",
                                users=users, num_tokens=4)
            storm.start()
            await asyncio.sleep(baseline_s)
            baseline_fleet = await _obsplane_get(control, obsplane.url,
                                                 "/fleet") or {}
            baseline_firing = [a.get("name") for a in
                               baseline_fleet.get("firing_alerts", [])]
            baseline_incidents = len(baseline_fleet.get("incidents",
                                                        []))

            victim = engine_procs[0].url
            storm.phase = tag
            t0 = time.monotonic()
            injected_ok = await control.post_fault(
                victim, {"mode": "slow_ttft", "arg": slow_ttft_arg_s,
                         "count": -1})

            detected_in = await _wait_fleet(
                control, obsplane.url,
                lambda p: any(a.get("name") == ALERT
                              for a in p.get("firing_alerts", [])),
                detect_timeout_s)

            # wait for the remediator's verdict (the executed path
            # blocks its autoscaler tick through drain + restart +
            # verify, so the budget covers the whole runbook)
            rem_deadline = time.monotonic() + detect_timeout_s \
                + resolve_timeout_s + 30.0
            while time.monotonic() < rem_deadline:
                if scaler.remediation_events:
                    break
                await asyncio.sleep(0.3)
            remediations = [dict(r) for r in scaler.remediation_events]
            executed = [r for r in remediations if "executed_at" in r]

            if armed:
                # hands-off: the restart itself cleared the fault; the
                # alert must resolve with NO drill-side intervention
                resolved_in = await _wait_fleet(
                    control, obsplane.url,
                    lambda p: not p.get("firing_alerts"),
                    resolve_timeout_s)
                still_firing = None
                cleanup_resolved = None
            else:
                # anti-vacuity: nothing may have actuated, and the
                # alert must STILL be burning when the drill looks
                fleet_now = await _obsplane_get(control, obsplane.url,
                                                "/fleet") or {}
                still_firing = any(
                    a.get("name") == ALERT
                    for a in fleet_now.get("firing_alerts", []))
                resolved_in = None
                # then prove the fleet was resolvable, not wedged:
                # clear the fault by hand and watch the alert leave
                await control.post_fault(victim, {"mode": None})
                cleanup_resolved = await _wait_fleet(
                    control, obsplane.url,
                    lambda p: not p.get("firing_alerts"),
                    resolve_timeout_s) is not None

            storm.phase = "settle"
            await asyncio.sleep(1.0)
            fleet_end = await _obsplane_get(control, obsplane.url,
                                            "/fleet") or {}
            await storm.stop()
            control_errors = list(control.errors)
            elapsed = round(time.monotonic() - t0, 1)

        await scaler.close()
        # late records (a verify that finished after the poll loop)
        remediations = [dict(r) for r in scaler.remediation_events]
        executed = [r for r in remediations if "executed_at" in r]
        return {
            "armed": armed,
            "victim": victim,
            "injected_ok": injected_ok,
            "baseline_firing": baseline_firing,
            "baseline_incidents": baseline_incidents,
            "detected_in_s": detected_in,
            "resolved_in_s": resolved_in,
            "still_firing_after_suppression": still_firing,
            "cleanup_resolved": cleanup_resolved,
            "remediations": remediations,
            "executed_count": len(executed),
            "incidents_total": len(fleet_end.get("incidents", [])),
            "firing_at_end": [a.get("name") for a in
                              fleet_end.get("firing_alerts", [])],
            "storm": _storm_phase(storm, tag),
            "duration_s": elapsed,
            "control_errors": control_errors,
        }
    finally:
        if storm is not None and not storm._stopping:
            await storm.stop()
        if scaler is not None and scaler.healthy():
            await scaler.close()
        if remediator is not None:
            await remediator.close()
        _stop(procs)


# ------------------------------------------------------------- the rig

async def run_fleetdrill(*, scenarios: Optional[List[str]] = None,
                         window_scale: float = 0.01,
                         users: int = 6,
                         engines: int = 3,
                         baseline_s: float = 6.0,
                         detect_timeout_s: Optional[float] = None,
                         resolve_timeout_s: Optional[float] = None,
                         burn_ttft_s: float = 0.4,
                         queue_ramp_ms_per_s: float = 60.0,
                         queue_plateau_ms: float = 1200.0,
                         max_replicas: int = 2,
                         slow_ttft_arg_s: float = 0.6,
                         tick_interval_s: float = 0.5,
                         min_events: int = 4,
                         platform: str = "cuda",
                         log_dir: str = "loadgen-logs",
                         startup_timeout_s: float = 420.0) -> Dict:
    """Run the fleet-pilot drill scenarios; return the FLEETDRILL
    record."""
    if scenarios is None:
        scenarios = list(SCENARIO_NAMES)
    unknown = [s for s in scenarios if s not in SCENARIO_NAMES]
    if unknown:
        raise ValueError(f"unknown scenarios {unknown}; "
                         f"options: {list(SCENARIO_NAMES)}")
    long_w = WINDOWS["1h"] * window_scale
    ticket_short_w = WINDOWS["30m"] * window_scale
    if detect_timeout_s is None:
        detect_timeout_s = max(15.0, 0.85 * long_w + 10.0)
    if resolve_timeout_s is None:
        resolve_timeout_s = max(15.0, ticket_short_w + 25.0)
    os.makedirs(log_dir, exist_ok=True)

    t0 = time.monotonic()
    detail: Dict[str, object] = {
        "window_scale": window_scale,
        "windows_s": {lbl: round(w * window_scale, 2)
                      for lbl, w in WINDOWS.items()},
        "min_events": min_events,
        "users": users,
        "baseline_s": baseline_s,
        "detect_timeout_s": round(detect_timeout_s, 1),
        "resolve_timeout_s": round(resolve_timeout_s, 1),
        "tick_interval_s": tick_interval_s,
        "scenarios_run": list(scenarios),
    }
    if "burn" in scenarios:
        burn_kw = dict(window_scale=window_scale, users=users,
                       baseline_s=baseline_s,
                       detect_timeout_s=detect_timeout_s,
                       resolve_timeout_s=resolve_timeout_s,
                       burn_ttft_s=burn_ttft_s,
                       queue_ramp_ms_per_s=queue_ramp_ms_per_s,
                       queue_plateau_ms=queue_plateau_ms,
                       max_replicas=max_replicas,
                       tick_interval_s=tick_interval_s,
                       min_events=min_events, log_dir=log_dir,
                       startup_timeout_s=startup_timeout_s)
        logger.info("fleetdrill burn: pilot run (burn-rate input off "
                    "/fleet)...")
        pilot = await _burn_run(pilot=True, **burn_kw)
        logger.info("fleetdrill burn: control run (queue-delay "
                    "only)...")
        ctl = await _burn_run(pilot=False, **burn_kw)
        detail["burn"] = {
            "burn_ttft_s": burn_ttft_s,
            "queue_ramp_ms_per_s": queue_ramp_ms_per_s,
            "queue_plateau_ms": queue_plateau_ms,
            "max_replicas": max_replicas,
            "pilot": pilot, "control": ctl,
            "replica_seconds_saved": (
                None if pilot["resolved_in_s"] is None
                or ctl["resolved_in_s"] is None
                else round(ctl["replica_seconds"]
                           - pilot["replica_seconds"], 1)),
        }
        logger.info(
            "fleetdrill burn: pilot fired=%s resolved=%s rs=%.1f "
            "(reason=%s source=%s) | control fired=%s resolved=%s "
            "rs=%.1f (reason=%s)",
            pilot["fired_in_s"], pilot["resolved_in_s"],
            pilot["replica_seconds"], pilot["first_up_reason"],
            pilot["first_up_source"], ctl["fired_in_s"],
            ctl["resolved_in_s"], ctl["replica_seconds"],
            ctl["first_up_reason"])
    rem_kw = dict(window_scale=window_scale, engines=engines,
                  users=users, baseline_s=baseline_s,
                  detect_timeout_s=detect_timeout_s,
                  resolve_timeout_s=resolve_timeout_s,
                  slow_ttft_arg_s=slow_ttft_arg_s,
                  tick_interval_s=tick_interval_s,
                  min_events=min_events, log_dir=log_dir,
                  startup_timeout_s=startup_timeout_s)
    if "remediate" in scenarios:
        logger.info("fleetdrill remediate: armed hands-off run...")
        detail["remediate"] = await _remediation_run(armed=True,
                                                     **rem_kw)
        r = detail["remediate"]
        logger.info("fleetdrill remediate: detected=%s executed=%d "
                    "resolved=%s outcomes=%s", r["detected_in_s"],
                    r["executed_count"], r["resolved_in_s"],
                    [x.get("outcome") for x in r["remediations"]])
    if "killswitch" in scenarios:
        logger.info("fleetdrill killswitch: suppressed anti-vacuity "
                    "run...")
        detail["killswitch"] = await _remediation_run(armed=False,
                                                      **rem_kw)
        k = detail["killswitch"]
        logger.info("fleetdrill killswitch: detected=%s outcomes=%s "
                    "still_firing=%s cleanup_resolved=%s",
                    k["detected_in_s"],
                    [x.get("outcome") for x in k["remediations"]],
                    k["still_firing_after_suppression"],
                    k["cleanup_resolved"])

    detail["duration_s"] = round(time.monotonic() - t0, 1)
    saved = (detail.get("burn") or {}).get("replica_seconds_saved")
    return {
        "metric": "fleet pilot: burn-rate scale-up beats the "
                  "queue-delay control on replica-seconds to "
                  "resolution; bounded remediation drains and restarts "
                  "the attributed culprit hands-off; the kill-switch "
                  "verifiably suppresses",
        "value": saved if saved is not None else 0.0,
        "unit": "replica_seconds_saved",
        "platform": platform,
        "detail": detail,
    }


def fleetdrill_violations(record: Dict) -> List[str]:
    """The drill's pass/fail contract (CLI exits 1 on any)."""
    d = record["detail"]
    out: List[str] = []

    def storm_errors(run: dict, who: str, gate_shed: bool) -> None:
        s = run["storm"]
        if s["http_5xx"] or s["transport_errors"]:
            out.append(f"{who}: {s['http_5xx']} 5xx / "
                       f"{s['transport_errors']} transport errors "
                       f"reached clients")
        if gate_shed and s["shed"]:
            out.append(f"{who}: {s['shed']} requests shed — the gate "
                       f"is zero shed")
        if s["ok"] == 0:
            out.append(f"{who}: storm finished zero requests — the "
                       f"scenario measured nothing")
        if run["control_errors"]:
            out.append(f"{who}: {len(run['control_errors'])} control-"
                       f"plane errors (first: "
                       f"{run['control_errors'][0]})")
        if run["baseline_firing"]:
            out.append(f"{who}: alerts firing during the clean "
                       f"baseline: {run['baseline_firing']}")

    burn = d.get("burn")
    if burn is not None:
        for who in ("pilot", "control"):
            run = burn[who]
            storm_errors(run, f"burn/{who}", gate_shed=(who == "pilot"))
            if run["fired_in_s"] is None:
                out.append(f"burn/{who}: {ALERT} never fired within "
                           f"{d['detect_timeout_s']}s")
            elif run["resolved_in_s"] is None:
                out.append(f"burn/{who}: {ALERT} fired but never "
                           f"resolved — the scale-up did not relieve "
                           f"the burn")
            if run["scale_ups"] == 0:
                out.append(f"burn/{who}: never scaled up")
        pilot, ctl = burn["pilot"], burn["control"]
        if pilot["first_up_reason"] != "burn_rate":
            out.append(f"burn/pilot: first scale-up reason was "
                       f"{pilot['first_up_reason']!r}, not "
                       f"'burn_rate' — the alert was not the trigger")
        if pilot["first_up_source"] != "fleet":
            out.append(f"burn/pilot: scale-up decision consumed signal "
                       f"source {pilot['first_up_source']!r}, not "
                       f"'fleet'")
        if ctl["first_up_reason"] == "burn_rate":
            out.append("burn/control: the queue-delay-only control "
                       "scaled on 'burn_rate' — the comparison is "
                       "vacuous")
        if pilot["resolved_in_s"] is not None \
                and ctl["resolved_in_s"] is not None \
                and pilot["replica_seconds"] >= ctl["replica_seconds"]:
            out.append(
                f"burn: pilot consumed {pilot['replica_seconds']} "
                f"replica-seconds to resolution vs the control's "
                f"{ctl['replica_seconds']} — the burn-rate input "
                f"bought nothing")
    rem = d.get("remediate")
    if rem is not None:
        storm_errors(rem, "remediate", gate_shed=True)
        if not rem["injected_ok"]:
            out.append("remediate: fault injection failed")
        if rem["detected_in_s"] is None:
            out.append(f"remediate: {ALERT} never fired within "
                       f"{d['detect_timeout_s']}s")
        if rem["baseline_incidents"]:
            out.append(f"remediate: {rem['baseline_incidents']} "
                       f"incident bundles captured during the clean "
                       f"baseline")
        if rem["executed_count"] != 1:
            out.append(f"remediate: {rem['executed_count']} executed "
                       f"remediations in the decision log, expected "
                       f"exactly 1")
        resolved = [r for r in rem["remediations"]
                    if r.get("outcome") == "resolved"]
        if len(resolved) != 1:
            out.append(f"remediate: outcomes "
                       f"{[r.get('outcome') for r in rem['remediations']]}"
                       f" — expected exactly one 'resolved'")
        else:
            r = resolved[0]
            if (r.get("target") or "").rstrip("/") != \
                    rem["victim"].rstrip("/"):
                out.append(f"remediate: remediation targeted "
                           f"{r.get('target')!r}, the injection hit "
                           f"{rem['victim']!r}")
            if r.get("action") != "drain_restart":
                out.append(f"remediate: action {r.get('action')!r}, "
                           f"expected 'drain_restart'")
        if rem["resolved_in_s"] is None:
            out.append(f"remediate: alert did not resolve hands-off "
                       f"within {d['resolve_timeout_s']}s of the "
                       f"remediation")
        if rem["firing_at_end"]:
            out.append(f"remediate: alerts still firing at scenario "
                       f"end: {rem['firing_at_end']}")
    ks = d.get("killswitch")
    if ks is not None:
        storm_errors(ks, "killswitch", gate_shed=True)
        if not ks["injected_ok"]:
            out.append("killswitch: fault injection failed")
        if ks["detected_in_s"] is None:
            out.append(f"killswitch: {ALERT} never fired within "
                       f"{d['detect_timeout_s']}s")
        suppressed = [r for r in ks["remediations"]
                      if r.get("outcome") == "suppressed_killswitch"]
        if not suppressed:
            out.append(f"killswitch: no 'suppressed_killswitch' record "
                       f"in the decision log (outcomes: "
                       f"{[r.get('outcome') for r in ks['remediations']]})"
                       f" — the suppression is unproven")
        if ks["executed_count"] != 0:
            out.append(f"killswitch: {ks['executed_count']} "
                       f"remediations EXECUTED with the kill-switch "
                       f"down")
        if ks["still_firing_after_suppression"] is not True:
            out.append("killswitch: the alert was not still firing "
                       "after the suppressed attempt — the "
                       "anti-vacuity gate is vacuous itself")
        if ks["cleanup_resolved"] is not True:
            out.append("killswitch: the alert did not resolve after "
                       "the drill cleared the fault by hand — the "
                       "suppressed run left a wedged fleet")
    return out
