"""Multitenant storm: named pools, LoRA churn, noisy-neighbor containment.

The heterogeneous-fleet closed loop. One router fronts TWO
named pools (``--pools``): pool-a serves ``model-a`` (plus dynamically
loaded LoRA adapters), pool-b serves ``model-b``. Each pool is owned by
its own ``LocalProcessActuator`` publishing membership through a shared
``PoolConfigWriter`` (one dynamic-config document, N writers), and its
own ``Autoscaler`` policy loop — both loops share ONE
``ActuationBudget`` so simultaneous decisions serialize instead of
double-spending the host.

Phases:

1. **baseline** — mixed model-a/model-b traffic; per-model goodput is
   the reference for the interference gate.
2. **churn** — same mix while pool-a goes through the wringer: LoRA
   adapters are loaded on every pool-a engine, traffic moves onto the
   adapter id once the router's ``/v1/models`` aggregates it
   fleet-wide, then the adapter is evicted; one engine gets an
   ``adapter_load_error`` fault injected and the rig asserts the load
   answers a structured 503 + ``Retry-After`` while the router's
   healthy-endpoint count is untouched (shed ≠ sick at the adapter
   stage — the r9 contract); finally one pool-a engine is SIGKILLed
   mid-storm. Pool-b must not notice any of it.
3. **noisy** — tenants ``acme``/``beta``/``gamma`` share one QoS tier
   on model-b; acme bursts far past the per-tenant bucket
   (``--qos-tenant-rate``) while its peers stay under it.
4. **surge** — heavy legitimate load on BOTH models forces each pool's
   policy loop to scale up through the shared budget.

The acceptance contract (``multitenant_violations``; CLI exits 1 on
any):

- **routing is 100% model-correct** — every ok response's
  ``x-engine-id`` belongs to the pool that serves the requested model
  (joined against the config writer's cumulative membership history),
  and zero 404s: the fake engines run ``--strict-models``, so a
  misrouted request is observable, not silently absorbed;
- **zero cross-pool interference** — pool-b goodput during pool-a's
  churn+kill phase holds >= ``interference_floor`` of baseline with
  zero 5xx/transport errors;
- **noisy-neighbor containment** — the bursting tenant is shed >=
  ``min_noisy_shed`` of its attempts while each same-tier peer keeps
  ok-fraction >= ``peer_floor``;
- **per-pool scale events** — the shared decision log contains applied
  scale-ups for BOTH pool labels.

``--no-tenant-buckets`` is the anti-vacuity lever: the router runs
without per-tenant buckets, acme's burst saturates pool-b's bounded
engines, and the peer-goodput gate MUST fail (exit 1) — proving the
gate measures the isolation mechanism, not ambient capacity.

The committed record is ``TENANT_*.json`` (BENCH schema; headline =
pool-b churn-phase goodput as % of baseline). Reproduction:
``benchmarks/run_multitenant.sh``.
"""

import asyncio
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import aiohttp

from production_stack_tpu_torch.autoscaler.actuator import (LocalProcessActuator,
                                                      PoolConfigWriter)
from production_stack_tpu_torch.autoscaler.collector import SignalCollector
from production_stack_tpu_torch.autoscaler.controller import (ActuationBudget,
                                                        Autoscaler)
from production_stack_tpu_torch.autoscaler.policy import (AutoscalerPolicy,
                                                    PolicyConfig)
from production_stack_tpu_torch.loadgen.orchestrator import (_spawn, _stop,
                                                       free_port,
                                                       wait_healthy)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

CHAT_PATH = "/v1/chat/completions"

POOL_A = "pool-a"
POOL_B = "pool-b"
MODEL_A = "model-a"
MODEL_B = "model-b"


class _Rec:
    __slots__ = ("t", "phase", "model", "tenant", "tier", "kind",
                 "engine", "latency_s")

    def __init__(self, t, phase, model, tenant, tier, kind, engine,
                 latency_s):
        self.t = t                      # completion, monotonic
        self.phase = phase
        self.model = model              # model requested AT SEND TIME
        self.tenant = tenant
        self.tier = tier
        self.kind = kind                # ok | shed | http_5xx |
                                        # http_4xx | transport
        self.engine = engine            # x-engine-id (ok only)
        self.latency_s = latency_s


class _Worker:
    """One closed-loop client. ``model`` is a zero-arg callable so the
    churn script can retarget live workers onto a freshly loaded
    adapter id (and back) without restarting the storm."""

    __slots__ = ("session", "model", "tenant", "tier", "think_s")

    def __init__(self, session: str, model: Callable[[], str],
                 tenant: Optional[str] = None, tier: str = "",
                 think_s: float = 0.05):
        self.session = session
        self.model = model
        self.tenant = tenant
        self.tier = tier
        self.think_s = think_s


def _fixed(model: str) -> Callable[[], str]:
    return lambda: model


async def _storm(url: str, phase: str, *, deadline: float,
                 workers: List[_Worker],
                 num_tokens: int = 4,
                 request_timeout_s: float = 20.0,
                 sink: Optional[List[_Rec]] = None) -> List[_Rec]:
    """Closed-loop storm, one task per worker. Fresh connection per
    request (``force_close``) so per-request routing is exercised;
    sheds honor the Retry-After backoff like a well-behaved client."""
    recs: List[_Rec] = sink if sink is not None else []
    timeout = aiohttp.ClientTimeout(total=request_timeout_s)

    async def run(w: _Worker) -> None:
        headers = {"Content-Type": "application/json",
                   "x-user-id": w.session}
        if w.tier:
            headers["x-priority-class"] = w.tier
        if w.tenant:
            headers["x-tenant-id"] = w.tenant
        async with aiohttp.ClientSession(
                connector=aiohttp.TCPConnector(limit=0,
                                               force_close=True)) as s:
            while time.monotonic() < deadline:
                model = w.model()
                body = json.dumps({
                    "model": model,
                    "messages": [{"role": "user",
                                  "content": f"multitenant {w.session}"}],
                    "max_tokens": num_tokens, "stream": False}).encode()
                t0 = time.monotonic()
                kind, engine = "transport", ""
                try:
                    async with s.post(f"{url}{CHAT_PATH}", data=body,
                                      headers=headers,
                                      timeout=timeout) as resp:
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
                recs.append(_Rec(now, phase, model, w.tenant, w.tier,
                                 kind, engine, now - t0))
                if kind == "shed":
                    await asyncio.sleep(0.1)   # honor the backoff
                else:
                    await asyncio.sleep(w.think_s)

    await asyncio.gather(*(run(w) for w in workers))
    return recs


def _kinds(recs: List[_Rec]) -> Dict[str, int]:
    out = {"ok": 0, "shed": 0, "http_5xx": 0, "http_4xx": 0,
           "transport": 0}
    for r in recs:
        out[r.kind] += 1
    return out


def _model_kinds(recs: List[_Rec], model: str) -> Dict[str, int]:
    return _kinds([r for r in recs if r.model == model])


def _tenant_kinds(recs: List[_Rec], tenant: str) -> Dict[str, int]:
    return _kinds([r for r in recs if r.tenant == tenant])


# ---------------------------------------------------------------- helpers

async def _admin_lora(session: aiohttp.ClientSession, engine_url: str,
                      verb: str, name: str) -> Tuple[int, Optional[str]]:
    """POST /admin/lora/{load|evict}; returns (status, Retry-After)."""
    async with session.post(
            f"{engine_url}/admin/lora/{verb}", json={"name": name},
            timeout=aiohttp.ClientTimeout(total=10)) as r:
        await r.read()
        return r.status, r.headers.get("Retry-After")


async def _set_fault(session: aiohttp.ClientSession, engine_url: str,
                     body: dict) -> None:
    async with session.post(
            f"{engine_url}/fault", json=body,
            timeout=aiohttp.ClientTimeout(total=10)) as r:
        await r.read()


async def _router_health(session: aiohttp.ClientSession,
                         router_url: str) -> dict:
    async with session.get(
            f"{router_url}/health",
            timeout=aiohttp.ClientTimeout(total=5)) as r:
        return await r.json()


async def _wait_model_listed(session: aiohttp.ClientSession,
                             router_url: str, model: str, *,
                             present: bool = True,
                             timeout_s: float = 15.0) -> float:
    """Poll the router's aggregated ``/v1/models`` until ``model``
    appears (or disappears); returns the wait in seconds. This is the
    fleet-wide adapter catalog the rig's adapter traffic keys on — a
    request sent before the catalog lists the adapter would 404."""
    t0 = time.monotonic()
    deadline = t0 + timeout_s
    while time.monotonic() < deadline:
        try:
            async with session.get(
                    f"{router_url}/v1/models",
                    timeout=aiohttp.ClientTimeout(total=5)) as r:
                body = await r.json()
                ids = {row.get("id") for row in body.get("data", [])}
                if (model in ids) == present:
                    return time.monotonic() - t0
        except (aiohttp.ClientError, asyncio.TimeoutError, ValueError):
            pass
        await asyncio.sleep(0.3)
    raise TimeoutError(
        f"router /v1/models did not {'list' if present else 'drop'} "
        f"{model!r} within {timeout_s:.0f}s")


def _audit_routing(recs: List[_Rec], writer: PoolConfigWriter,
                   model_to_pool: Dict[str, str],
                   adapter_models: List[str]) -> Dict:
    """The model-correctness audit: join every ok response's
    x-engine-id (the Host the router dialed) against the cumulative
    membership history of the pool that serves the requested model.
    Adapters belong to pool-a (they were only ever loaded there)."""
    hosts: Dict[str, set] = {}
    for pool, urls in writer.history.items():
        hosts[pool] = {u.split("://", 1)[-1].rstrip("/") for u in urls}
    lookup = dict(model_to_pool)
    for m in adapter_models:
        lookup[m] = POOL_A
    wrong: List[dict] = []
    checked = 0
    for r in recs:
        if r.kind != "ok" or not r.engine:
            continue
        pool = lookup.get(r.model)
        checked += 1
        if pool is None or r.engine not in hosts.get(pool, set()):
            wrong.append({"model": r.model, "engine": r.engine,
                          "pool": pool, "phase": r.phase})
    return {"ok_checked": checked,
            "misroutes": len(wrong),
            "misroute_samples": wrong[:10],
            "http_404s": sum(1 for r in recs if r.kind == "http_4xx"),
            "pool_hosts": {p: sorted(h) for p, h in hosts.items()}}


# ---------------------------------------------------------------- the rig

def _launch_pool_router(port: int, *, pools_json: str, config_path: str,
                        log_dir: str, max_inflight: int,
                        tenant_rate: float, extra_args: List[str]):
    cmd = [sys.executable, "-m", "production_stack_tpu_torch.router.app",
           "--host", "127.0.0.1", "--port", str(port),
           "--service-discovery", "static",
           "--pools", pools_json,
           "--routing-logic", "roundrobin",
           "--engine-stats-interval", "1",
           "--dynamic-config-json", config_path,
           "--dynamic-config-interval", "0.3",
           "--failover-attempts", "3",
           "--max-inflight", str(max_inflight),
           "--qos-tiers", "tier0=1.0,tier1=0.9"]
    if tenant_rate > 0:
        cmd += ["--qos-tenant-rate", str(tenant_rate)]
    cmd += extra_args
    return _spawn(f"router-{port}", cmd, f"http://127.0.0.1:{port}",
                  log_dir)


async def run_multitenant(*, baseline_s: float = 6.0,
                          churn_s: float = 14.0,
                          noisy_s: float = 8.0,
                          surge_s: float = 8.0,
                          adapter_cycles: int = 2,
                          initial_a: int = 2, initial_b: int = 1,
                          max_a: int = 3, max_b: int = 2,
                          fake_capacity: int = 4,
                          num_tokens: int = 4,
                          tenant_rate: float = 5.0,
                          tenant_buckets: bool = True,
                          max_inflight: int = 40,
                          noisy_workers: int = 8,
                          tick_interval_s: float = 0.5,
                          surge_rounds: int = 3,
                          platform: str = "cuda",
                          log_dir: str = "loadgen-logs",
                          startup_timeout_s: float = 120.0) -> Dict:
    """Launch two actuator-owned pools behind one pooled router, run
    the four phases, return the TENANT record."""
    os.makedirs(log_dir, exist_ok=True)
    config_path = os.path.join(log_dir, "multitenant-config.json")
    decision_log = os.path.join(log_dir, "multitenant-decisions.jsonl")
    for stale in (config_path, decision_log):
        if os.path.exists(stale):
            os.unlink(stale)

    writer = PoolConfigWriter(config_path)
    service_s = 0.02

    def engine_args(model: str) -> List[str]:
        # strict models make misroutes OBSERVABLE (404), the overload
        # fault bounds admission + advertises capacity for the
        # utilization signal, exactly like the autoscale rig's fakes
        return ["--model", model, "--strict-models",
                "--ttft", f"{service_s:.3f}",
                "--num-tokens", str(num_tokens),
                "--tokens-per-s", "400",
                "--fault", "overload", "--fault-arg", str(fake_capacity)]

    actuator_a = LocalProcessActuator(
        engine="fake", dynamic_config_path=config_path,
        routing_logic="roundrobin", log_dir=log_dir, platform=platform,
        engine_extra_args=engine_args(MODEL_A),
        startup_timeout_s=startup_timeout_s,
        pool=POOL_A, pool_models=[MODEL_A], config_writer=writer)
    actuator_b = LocalProcessActuator(
        engine="fake", dynamic_config_path=config_path,
        routing_logic="roundrobin", log_dir=log_dir, platform=platform,
        engine_extra_args=engine_args(MODEL_B),
        startup_timeout_s=startup_timeout_s,
        pool=POOL_B, pool_models=[MODEL_B], config_writer=writer)

    router = None
    scalers: List[Autoscaler] = []
    budget = ActuationBudget(max_concurrent=1)
    recs: List[_Rec] = []
    adapter_models: List[str] = []
    adapter_ops: List[dict] = []
    fault_probe: Dict = {}
    kill_info: Dict = {}
    http = aiohttp.ClientSession()
    try:
        urls_a = await actuator_a.start(initial_a)
        urls_b = await actuator_b.start(initial_b)
        pools_json = json.dumps(
            {n: dict(p) for n, p in writer.pools.items()})
        router = _launch_pool_router(
            free_port(), pools_json=pools_json, config_path=config_path,
            log_dir=log_dir, max_inflight=max_inflight,
            tenant_rate=tenant_rate if tenant_buckets else 0.0,
            extra_args=[])
        actuator_a.router_url = router.url
        actuator_b.router_url = router.url
        await wait_healthy(router.url, 60.0,
                           require_endpoints=initial_a + initial_b)

        def make_scaler(actuator, pool, initial, maximum) -> Autoscaler:
            policy = AutoscalerPolicy(PolicyConfig(
                min_replicas=initial, max_replicas=maximum,
                target_queue_delay_ms=800.0, down_queue_delay_ms=1.0,
                target_utilization=0.85, down_utilization=0.01,
                up_cooldown_s=2.0, down_cooldown_s=600.0,
                up_breach_ticks=2,
                # the rig never wants a scale-down mid-storm
                down_breach_ticks=10_000,
                # a SIGKILLed replica must not wedge the pool's loop:
                # resume on live signals after ~2s of staleness
                settling_grace_ticks=4))
            collector = SignalCollector(actuator.endpoint_urls,
                                        router_url=router.url,
                                        poll_interval_s=tick_interval_s)
            return Autoscaler(policy, actuator, collector,
                              interval_s=tick_interval_s,
                              decision_log_path=decision_log,
                              pool=pool, budget=budget)

        scalers = [make_scaler(actuator_a, POOL_A, initial_a, max_a),
                   make_scaler(actuator_b, POOL_B, initial_b, max_b)]
        for s in scalers:
            await s.start()
        await asyncio.sleep(tick_interval_s)

        # ---- phase 1: baseline ---------------------------------------
        base_workers = (
            [_Worker(f"a{i}", _fixed(MODEL_A), think_s=0.08)
             for i in range(3)] +
            [_Worker(f"b{i}", _fixed(MODEL_B), think_s=0.08)
             for i in range(3)])
        logger.info("multitenant phase: baseline (%.0fs)", baseline_s)
        baseline = await _storm(router.url, "baseline",
                                deadline=time.monotonic() + baseline_s,
                                workers=base_workers,
                                num_tokens=num_tokens)
        recs.extend(baseline)

        # ---- phase 2: churn (adapters + fault + kill on pool-a) ------
        logger.info("multitenant phase: churn (%.0fs, %d adapter "
                    "cycles, fault + SIGKILL on %s)", churn_s,
                    adapter_cycles, POOL_A)
        current = {"model": MODEL_A}
        churn_recs: List[_Rec] = []
        churn_workers = (
            [_Worker(f"ca{i}", _fixed(MODEL_A), think_s=0.08)
             for i in range(3)] +
            [_Worker(f"cb{i}", _fixed(MODEL_B), think_s=0.08)
             for i in range(3)] +
            [_Worker(f"ad{i}", lambda: current["model"], think_s=0.08)
             for i in range(2)])
        t_churn = time.monotonic()
        storm_task = asyncio.create_task(_storm(
            router.url, "churn", deadline=t_churn + churn_s,
            workers=churn_workers, num_tokens=num_tokens,
            sink=churn_recs))

        live_a = list(urls_a)
        for cycle in range(adapter_cycles):
            name = f"lora-r21-{cycle}"
            statuses = await asyncio.gather(
                *(_admin_lora(http, u, "load", name) for u in live_a))
            listed_in = await _wait_model_listed(http, router.url, name)
            adapter_models.append(name)
            current["model"] = name          # retarget live workers
            await asyncio.sleep(1.2)         # adapter traffic window
            current["model"] = MODEL_A
            await asyncio.sleep(0.6)         # drain in-flight adapter reqs
            evicts = await asyncio.gather(
                *(_admin_lora(http, u, "evict", name) for u in live_a))
            adapter_ops.append({
                "adapter": name,
                "load_statuses": [s for s, _ in statuses],
                "evict_statuses": [s for s, _ in evicts],
                "listed_fleetwide_after_s": round(listed_in, 2)})

        # adapter-load failure is a SHED, never sickness: inject the
        # fault, assert the structured refusal, assert the router's
        # healthy count never moves
        before = await _router_health(http, router.url)
        await _set_fault(http, live_a[0],
                         {"mode": "adapter_load_error", "count": 1})
        status, retry_after = await _admin_lora(http, live_a[0], "load",
                                                "lora-r21-doomed")
        await _set_fault(http, live_a[0],        # restore capacity ad
                         {"mode": "overload", "arg": fake_capacity})
        await asyncio.sleep(1.0)
        after = await _router_health(http, router.url)
        fault_probe = {
            "status": status, "retry_after": retry_after,
            "healthy_endpoints_before": before.get("healthy_endpoints"),
            "healthy_endpoints_after": after.get("healthy_endpoints")}

        # SIGKILL one pool-a engine mid-storm: pool-b must not notice
        victim = live_a[-1]
        handle = actuator_a._handles.get(victim)
        t_kill = time.monotonic() - t_churn
        if handle is not None:
            handle.popen.kill()
        kill_info = {"victim": victim, "at_s": round(t_kill, 1)}
        logger.info("  SIGKILLed %s at t+%.1fs", victim, t_kill)

        churn = await storm_task
        # ---- phase 3: noisy tenant -----------------------------------
        logger.info("multitenant phase: noisy tenant (%.0fs, acme x%d "
                    "vs beta/gamma, buckets %s)", noisy_s,
                    noisy_workers, "on" if tenant_buckets else "OFF")
        noisy_spec = (
            [_Worker(f"acme{i}", _fixed(MODEL_B), tenant="acme",
                     tier="tier1", think_s=0.005)
             for i in range(noisy_workers)] +
            [_Worker("beta0", _fixed(MODEL_B), tenant="beta",
                     tier="tier1", think_s=0.3),
             _Worker("gamma0", _fixed(MODEL_B), tenant="gamma",
                     tier="tier1", think_s=0.3)] +
            [_Worker(f"na{i}", _fixed(MODEL_A), think_s=0.1)
             for i in range(2)])
        noisy = await _storm(router.url, "noisy",
                             deadline=time.monotonic() + noisy_s,
                             workers=noisy_spec,
                             num_tokens=num_tokens)
        recs.extend(churn_recs)
        recs.extend(noisy)

        # ---- phase 4: surge (both pools must scale) ------------------
        surge_spec = (
            [_Worker(f"sa{i}", _fixed(MODEL_A), think_s=0.005)
             for i in range(10)] +
            [_Worker(f"sb{i}", _fixed(MODEL_B), think_s=0.005)
             for i in range(10)])
        surge: List[_Rec] = []
        for rnd in range(surge_rounds):
            logger.info("multitenant phase: surge round %d (%.0fs)",
                        rnd + 1, surge_s)
            await _storm(router.url, "surge",
                         deadline=time.monotonic() + surge_s,
                         workers=surge_spec, num_tokens=num_tokens,
                         sink=surge)
            ups = {s.pool for s in scalers
                   if s.summary()["scale_ups"] > 0}
            if ups >= {POOL_A, POOL_B}:
                break
        recs.extend(surge)

        health = await _router_health(http, router.url)
    finally:
        for s in scalers:
            if s.healthy():
                await s.close()
        if router is not None:
            _stop([router])
        await actuator_a.close()
        await actuator_b.close()
        await http.close()

    # ---- reduce ------------------------------------------------------
    base_b = _model_kinds(baseline, MODEL_B)
    churn_b = _model_kinds(churn, MODEL_B)
    base_b_qps = base_b["ok"] / baseline_s
    churn_b_qps = churn_b["ok"] / churn_s
    held = (100.0 * churn_b_qps / base_b_qps) if base_b_qps else 0.0

    acme = _tenant_kinds(noisy, "acme")
    acme_total = sum(acme.values())
    peers = {t: _tenant_kinds(noisy, t) for t in ("beta", "gamma")}

    decisions: List[dict] = []
    if os.path.exists(decision_log):
        with open(decision_log) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        decisions.append(json.loads(line))
                    except ValueError:
                        pass
    applied_ups = [d for d in decisions
                   if d.get("direction") == "up" and d.get("applied")]
    deferred = [d for d in decisions
                if d.get("deferred") == "actuation_budget"]

    routing = _audit_routing(recs, writer,
                             {MODEL_A: POOL_A, MODEL_B: POOL_B},
                             adapter_models)

    return {
        "metric": "pool-b goodput held during pool-a adapter churn + "
                  "engine kill (multi-pool isolation)",
        "value": round(held, 1),
        "unit": "percent_of_baseline",
        "platform": platform,
        "detail": {
            "tenant_buckets": tenant_buckets,
            "tenant_rate": tenant_rate if tenant_buckets else 0.0,
            "pools": {POOL_A: {"model": MODEL_A, "initial": initial_a,
                               "max": max_a},
                      POOL_B: {"model": MODEL_B, "initial": initial_b,
                               "max": max_b}},
            "phase_durations_s": {"baseline": baseline_s,
                                  "churn": churn_s, "noisy": noisy_s,
                                  "surge": surge_s},
            "baseline": {"model_a": _model_kinds(baseline, MODEL_A),
                         "model_b": base_b,
                         "model_b_goodput_qps": round(base_b_qps, 2)},
            "churn": {
                "model_a": _model_kinds(churn, MODEL_A),
                "model_b": churn_b,
                "model_b_goodput_qps": round(churn_b_qps, 2),
                "adapter": {m: _model_kinds(churn, m)
                            for m in adapter_models},
                "adapter_ops": adapter_ops,
                "adapter_load_fault": fault_probe,
                "engine_kill": kill_info},
            "noisy": {
                "acme": acme,
                "acme_attempts": acme_total,
                "acme_shed_fraction": round(
                    acme["shed"] / acme_total, 3) if acme_total else 0.0,
                "peers": peers,
                "router_tenant_sheds": (health.get("qos") or {}).get(
                    "tenant_sheds"),
            },
            "surge": _kinds(surge),
            "routing": routing,
            "autoscaling": {
                "pools_scaled_up": sorted(
                    {d.get("pool") for d in applied_ups
                     if d.get("pool")}),
                "applied_scale_ups": len(applied_ups),
                "budget_deferrals": len(deferred),
                "budget": budget.snapshot(),
                "per_pool": {s.pool: s.summary() for s in scalers},
            },
            "router_pools_snapshot": health.get("pools"),
            "pool_membership_history": {
                p: sorted(urls) for p, urls in writer.history.items()},
        },
    }


def multitenant_violations(record: Dict, *,
                           interference_floor: float = 0.95,
                           min_noisy_shed: float = 0.5,
                           peer_floor: float = 0.95) -> List[str]:
    """The rig's pass/fail contract (CLI exits 1 on any)."""
    d = record["detail"]
    out: List[str] = []

    # gate 1: routing is 100% model-correct
    routing = d["routing"]
    if routing["ok_checked"] == 0:
        out.append("no ok responses to audit — the storm never ran")
    if routing["misroutes"]:
        out.append(f"{routing['misroutes']} responses served by an "
                   f"engine OUTSIDE the pool that owns the requested "
                   f"model (of {routing['ok_checked']} audited): "
                   f"{routing['misroute_samples'][:3]}")
    if routing["http_404s"]:
        out.append(f"{routing['http_404s']} requests answered 404 "
                   f"(strict engines make misroutes observable; a "
                   f"correctly pooled router never produces one)")

    # gate 2: zero cross-pool interference during pool-a's churn+kill
    if record["value"] < 100.0 * interference_floor:
        out.append(
            f"pool-b goodput fell to {record['value']}% of baseline "
            f"during pool-a churn+kill (need >= "
            f"{100 * interference_floor:.0f}%): cross-pool "
            f"interference")
    churn_b = d["churn"]["model_b"]
    bad_b = churn_b["http_5xx"] + churn_b["transport"]
    if bad_b:
        out.append(f"{bad_b} pool-b client-visible errors during "
                   f"pool-a's churn phase — the blast radius leaked "
                   f"across pools")

    # the adapter-failure semantics ride gate 2's phase: shed, not sick
    fault = d["churn"]["adapter_load_fault"]
    if fault.get("status") != 503 or not fault.get("retry_after"):
        out.append(f"injected adapter-load failure answered "
                   f"{fault.get('status')} (Retry-After: "
                   f"{fault.get('retry_after')!r}) — must be a "
                   f"structured 503 + Retry-After shed")
    if fault.get("healthy_endpoints_after") is not None and \
            fault.get("healthy_endpoints_after") != \
            fault.get("healthy_endpoints_before"):
        out.append(
            f"router healthy-endpoint count moved "
            f"{fault.get('healthy_endpoints_before')} -> "
            f"{fault.get('healthy_endpoints_after')} across the "
            f"adapter-load failure: a failed weight fetch must NEVER "
            f"be a breaker signal (shed != sick)")

    # gate 3: noisy-neighbor containment
    noisy = d["noisy"]
    if noisy["acme_attempts"] == 0:
        out.append("the noisy tenant never sent traffic")
    elif noisy["acme_shed_fraction"] < min_noisy_shed:
        out.append(
            f"noisy tenant acme was shed only "
            f"{noisy['acme_shed_fraction']:.0%} of attempts (need >= "
            f"{min_noisy_shed:.0%}): the per-tenant bucket is not "
            f"binding")
    for tenant, kinds in noisy["peers"].items():
        total = sum(kinds.values())
        ok_frac = kinds["ok"] / total if total else 0.0
        if ok_frac < peer_floor:
            out.append(
                f"tier peer {tenant} kept only {ok_frac:.0%} goodput "
                f"during acme's burst (need >= {peer_floor:.0%}): the "
                f"noisy neighbor was not contained")

    # gate 4: per-pool scale events in the shared decision log
    scaled = set(d["autoscaling"]["pools_scaled_up"])
    for pool in d["pools"]:
        if pool not in scaled:
            out.append(f"no applied scale-up with pool label "
                       f"{pool!r} in the decision log: the per-pool "
                       f"policy loop never actuated")
    return out
