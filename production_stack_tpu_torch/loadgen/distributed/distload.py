"""distload mode: prove sharded loadgen measures the same thing.

A distributed load generator is only worth trusting if sharding the
generation changes NOTHING about what is measured. This rig closes
that loop, then composes the capstone demonstration:

1. **Scaling gate** — one router + M fake engines (with per-request
   ``--service-jitter`` so latency has real spread to get wrong).
   A single-worker control drives the open-loop workload at global
   rate Q; then N >= 3 workers drive the SAME schedule at Q/N each.
   Merged offered load must land on Q, and the merged TTFT/e2e
   percentiles (merge-then-quantile across workers) must match the
   control within tolerance. Zero errors on both sides.
2. **Replay determinism gate** — the committed production-shaped
   trace is replayed twice across N workers; both replays must issue
   the SAME request multiset (digest over every (session, turn, kind,
   model, shape, tenant)), with zero errors.
3. **Capstone** (``--capstone``) — 2 peered routers fronting the r21
   two-pool heterogeneous fleet (pool-a: model-a + runtime LoRA,
   pool-b: model-b) + the r18 obsplane scraping all of it, under
   multi-worker replay of the mixed chat/rag/LoRA trace, workers
   pinned round-robin across routers. Gates: zero raw 5xx anywhere,
   and the obsplane's online stitcher shows >= ``min_chain_fraction``
   (0.95) complete router->engine chains — the fleet-wide measurement
   story holds under distributed production-shaped load.

Anti-vacuity: ``--anti-vacuity mismatched-rate`` skips the per-worker
rate division (every worker fires at the FULL global rate) and
``--anti-vacuity single-worker`` runs the "distributed" side with one
worker; either way the scaling gate must verifiably fail. The full
rig also embeds a short mismatched-rate run and requires its failure
in the committed record — a tolerance loose enough to pass a 3x
offered-load error would be certified useless by its own record.

Committed record: ``DISTLOAD_r22.json`` via
``benchmarks/run_distload.sh``; exit 1 on any gate violation.
"""

import asyncio
import json
import os
import sys
import time
from typing import Dict, List, Optional

import aiohttp

from production_stack_tpu_torch.loadgen.distributed.coordinator import (
    DistResult, replay_assignments, run_coordinated,
    synthetic_assignments)
from production_stack_tpu_torch.loadgen.distributed.shard import WorkerAssignment
from production_stack_tpu_torch.loadgen.distributed.tracefile import read_trace
from production_stack_tpu_torch.loadgen.orchestrator import (Proc, _spawn, _stop,
                                                       free_port,
                                                       launch_engine,
                                                       launch_obsplane,
                                                       launch_router,
                                                       wait_healthy)
from production_stack_tpu_torch.loadgen.spec import (ArrivalSpec, SessionSpec,
                                               TrafficMix, WorkloadSpec)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

TRACES_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "..",
                 "benchmarks", "traces"))
# replay-determinism gate default: single-model trace the basic stack
# (one router, model-a engines) can serve end to end
BURSTY_TRACE = os.path.join(TRACES_DIR, "bursty_tenant.trace.jsonl")
# capstone default: mixed chat/rag/LoRA/secondary-model trace — needs
# the two-pool fleet (model-a + lora-a in pool-a, model-b in pool-b)
MIXED_TRACE = os.path.join(TRACES_DIR, "mixed_classes.trace.jsonl")

BASE_MODEL = "model-a"
LORA_MODEL = "lora-a"
POOL_B_MODEL = "model-b"


def distload_spec(qps: float, phase_s: float) -> WorkloadSpec:
    """The scaling-gate workload: open-loop constant rate, small
    multi-round chat sessions (fake engines serve chat only)."""
    return WorkloadSpec(
        name="distload", model=BASE_MODEL, seed=22,
        mix=TrafficMix(chat=1.0),
        session=SessionSpec(rounds_min=1, rounds_max=3,
                            system_prompt_tokens=16,
                            question_tokens_mean=12.0,
                            question_tokens_sigma=0.4,
                            question_tokens_max=24,
                            answer_tokens_mean=16.0,
                            answer_tokens_sigma=0.3,
                            answer_tokens_max=16),
        arrival=ArrivalSpec(mode="open", qps_start=qps, qps_end=qps,
                            qps_step=0.0, stage_duration_s=phase_s),
        request_timeout_s=30.0,
    ).validate()


def _dist_block(res: DistResult) -> Dict:
    return {"summary": res.merged_summary,
            "per_worker": res.per_worker,
            "skew": res.skew,
            "violations": res.violations,
            "issued_digest": res.issued_digest}


def scaling_violations(control: Dict, dist: Dict, *, target_qps: float,
                       workers: int, min_workers: int = 3,
                       qps_rel_tol: float = 0.25,
                       pct_rel_tol: float = 0.35,
                       pct_abs_tol_s: float = 0.05) -> List[str]:
    """The scaling gate as a pure function of the two summary blocks —
    the embedded anti-vacuity run reuses it verbatim, so whatever
    tolerance the real gate applies is the tolerance the mismatched
    run must fail."""
    out: List[str] = []
    if workers < min_workers:
        out.append(f"SCALE distributed side ran {workers} workers, "
                   f"gate requires >= {min_workers}")
    csum, dsum = control.get("summary") or {}, dist.get("summary") or {}
    for name, block in (("control", control), ("dist", dist)):
        for v in block.get("violations") or []:
            out.append(f"SCALE {name}: {v}")
        s = block.get("summary") or {}
        if s.get("errors"):
            out.append(f"SCALE {name} saw {s['errors']} request errors")
    for name, s in (("control", csum), ("dist", dsum)):
        offered = s.get("offered_qps", 0.0)
        if abs(offered - target_qps) > qps_rel_tol * target_qps:
            out.append(
                f"SCALE {name} offered {offered:.3f} qps, target "
                f"{target_qps:.3f} (±{qps_rel_tol:.0%}) — "
                + ("rate sharding is broken (workers are not "
                   "superposing to the target)" if name == "dist"
                   else "the control measured the wrong rate"))
    for metric, pcts in (("ttft_s", ("p50", "p90")),
                         ("e2e_s", ("p50",))):
        for p in pcts:
            c = (csum.get(metric) or {}).get(p)
            d = (dsum.get(metric) or {}).get(p)
            if c is None or d is None:
                out.append(f"SCALE {metric}.{p} missing from a summary")
                continue
            tol = max(pct_abs_tol_s, pct_rel_tol * c)
            if abs(d - c) > tol:
                out.append(
                    f"SCALE merged {metric}.{p} {d:.4f}s vs control "
                    f"{c:.4f}s — |delta| {abs(d - c):.4f}s exceeds "
                    f"tol {tol:.4f}s (sharding changed the "
                    f"measurement)")
    return out


def replay_gate_violations(replay: Dict) -> List[str]:
    out: List[str] = []
    runs = replay.get("runs") or []
    if len(runs) < 2:
        out.append("REPLAY fewer than 2 replay runs recorded")
        return out
    digests = [r.get("issued_digest") for r in runs]
    if None in digests:
        out.append("REPLAY a run produced no issued digest")
    elif len(set(digests)) != 1:
        out.append(f"REPLAY digests differ across runs: {digests} — "
                   f"replay is not deterministic")
    expect = replay.get("trace_requests")
    for i, r in enumerate(runs):
        if r.get("summary", {}).get("errors"):
            out.append(f"REPLAY run {i} saw "
                       f"{r['summary']['errors']} errors")
        for v in r.get("violations") or []:
            out.append(f"REPLAY run {i}: {v}")
        launched = r.get("summary", {}).get("launched", 0)
        if expect is not None and launched != expect:
            out.append(f"REPLAY run {i} launched {launched} of the "
                       f"trace's {expect} requests")
    return out


def capstone_violations(cap: Dict,
                        min_chain_fraction: float = 0.95) -> List[str]:
    out: List[str] = []
    if cap.get("summary", {}).get("http_5xx"):
        out.append(f"CAPSTONE {cap['summary']['http_5xx']} raw 5xx "
                   f"under replayed distributed traffic")
    if cap.get("summary", {}).get("errors"):
        out.append(f"CAPSTONE {cap['summary']['errors']} request "
                   f"errors")
    for v in cap.get("violations") or []:
        out.append(f"CAPSTONE {v}")
    stitch = cap.get("stitch") or {}
    if not stitch.get("chains_complete"):
        out.append("CAPSTONE the obsplane stitched zero complete "
                   "chains — the composed demonstration is vacuous")
    elif stitch.get("complete_fraction", 0.0) < min_chain_fraction:
        out.append(f"CAPSTONE stitched-chain completeness "
                   f"{stitch.get('complete_fraction')} < "
                   f"{min_chain_fraction}")
    if not cap.get("pools_served", {}).get(POOL_B_MODEL):
        out.append("CAPSTONE pool-b saw no traffic — the "
                   "heterogeneous-fleet leg of the demonstration "
                   "did not run")
    return out


def distload_violations(record: Dict, *,
                        min_chain_fraction: float = 0.95) -> List[str]:
    """Everything that must hold for DISTLOAD_*.json to mean what it
    claims. Exit-1 surface of ``loadgen distload``."""
    d = record["detail"]
    out: List[str] = list(d.get("control_errors") or [])
    out += scaling_violations(
        d["control"], d["dist"], target_qps=d["target_qps"],
        workers=d["workers"], min_workers=d.get("min_workers", 3),
        qps_rel_tol=d["tolerances"]["qps_rel_tol"],
        pct_rel_tol=d["tolerances"]["pct_rel_tol"],
        pct_abs_tol_s=d["tolerances"]["pct_abs_tol_s"])
    out += replay_gate_violations(d["replay"])
    if d.get("capstone"):
        out += capstone_violations(d["capstone"],
                                   min_chain_fraction=min_chain_fraction)
    av = d.get("anti_vacuity")
    if av is not None and not av.get("violations"):
        out.append("ANTI-VACUITY the mismatched-rate run PASSED the "
                   "scaling gate — the tolerance is too loose to "
                   "certify anything")
    return out


async def _settle(procs: List[Proc], names: List[str],
                  errors: List[str]) -> None:
    for p, name in zip(procs, names):
        if p.popen.poll() is not None:
            errors.append(f"{name} died (exit {p.popen.returncode}, "
                          f"see {p.log_path})")


def _run_dist(assignments: List[WorkerAssignment], work_dir: str,
              timeout_s: float, tag: str) -> DistResult:
    return run_coordinated(assignments, work_dir=work_dir,
                           timeout_s=timeout_s, log_prefix=tag)


async def run_distload(*, engines: int = 2, workers: int = 3,
                       qps: float = 6.0, phase_s: float = 10.0,
                       trace_path: Optional[str] = None,
                       capstone_trace: Optional[str] = None,
                       speedup: float = 4.0,
                       capstone: bool = True,
                       capstone_routers: int = 2,
                       capstone_engines_per_pool: int = 2,
                       anti_vacuity: Optional[str] = None,
                       skip_embedded_anti_vacuity: bool = False,
                       service_jitter: float = 0.25,
                       qps_rel_tol: float = 0.25,
                       pct_rel_tol: float = 0.35,
                       pct_abs_tol_s: float = 0.05,
                       min_chain_fraction: float = 0.95,
                       worker_timeout_s: float = 300.0,
                       startup_timeout_s: float = 60.0,
                       log_dir: str = "loadgen-logs",
                       work_dir: str = "loadgen-logs/distload",
                       platform: str = "cuda") -> Dict:
    """The full rig; returns the BENCH-schema record."""
    trace_path = os.path.abspath(trace_path or BURSTY_TRACE)
    capstone_trace = os.path.abspath(capstone_trace or MIXED_TRACE)
    control_errors: List[str] = []
    os.makedirs(work_dir, exist_ok=True)
    spec = distload_spec(qps, phase_s)
    record_workers = 1 if anti_vacuity == "single-worker" else workers

    engine_args = ["--model", BASE_MODEL, "--adapters", LORA_MODEL,
                   "--ttft", "0.04", "--tokens-per-s", "300",
                   "--num-tokens", "16",
                   "--service-jitter", str(service_jitter)]
    procs: List[Proc] = []
    try:
        engine_procs = [launch_engine("fake", free_port(),
                                      log_dir=log_dir,
                                      extra_args=engine_args)
                        for _ in range(engines)]
        procs.extend(engine_procs)
        await asyncio.gather(*[wait_healthy(e.url, startup_timeout_s)
                               for e in engine_procs])
        router = launch_router([e.url for e in engine_procs],
                               BASE_MODEL, free_port(),
                               routing="session", log_dir=log_dir)
        procs.append(router)
        await wait_healthy(router.url, startup_timeout_s,
                           require_endpoints=engines)

        # ------------------------------------------ scaling gate
        logger.info("distload: control (1 worker @ %.1f qps, %gs)",
                    qps, phase_s)
        control_res = await asyncio.to_thread(
            _run_dist,
            synthetic_assignments(spec, router.url, workers=1,
                                  duration_s=phase_s,
                                  warmup_requests=4),
            work_dir, worker_timeout_s, "control")

        logger.info("distload: distributed (%d workers @ %.1f qps "
                    "global%s)", record_workers, qps,
                    ", MISMATCHED per-worker rate" if
                    anti_vacuity == "mismatched-rate" else "")
        dist_assignments = synthetic_assignments(
            spec, router.url, workers=record_workers,
            duration_s=phase_s, warmup_requests=2)
        if anti_vacuity == "mismatched-rate":
            # the vacuity probe: skip the 1/N division — every worker
            # fires at the FULL global rate, so offered load lands at
            # workers * qps and the gate must catch it
            for asn in dist_assignments:
                asn.spec["arrival"]["qps_scale"] = \
                    spec.arrival.qps_scale
        dist_res = await asyncio.to_thread(
            _run_dist, dist_assignments, work_dir, worker_timeout_s,
            "dist")
        await _settle(procs, [p.name for p in procs], control_errors)

        # --------------------------- embedded anti-vacuity (short)
        anti_block: Optional[Dict] = None
        if anti_vacuity is None and not skip_embedded_anti_vacuity:
            short = distload_spec(qps, max(3.0, phase_s / 2))
            av_assignments = synthetic_assignments(
                short, router.url, workers=workers,
                duration_s=max(3.0, phase_s / 2))
            for asn in av_assignments:
                asn.spec["arrival"]["qps_scale"] = \
                    short.arrival.qps_scale
            av_res = await asyncio.to_thread(
                _run_dist, av_assignments, work_dir, worker_timeout_s,
                "anti-vacuity")
            av_violations = scaling_violations(
                _dist_block(control_res), _dist_block(av_res),
                target_qps=qps, workers=workers,
                qps_rel_tol=qps_rel_tol, pct_rel_tol=pct_rel_tol,
                pct_abs_tol_s=pct_abs_tol_s)
            anti_block = {
                "mode": "mismatched-rate",
                "offered_qps": av_res.merged_summary.get("offered_qps"),
                "violations": av_violations,
            }

        # ------------------------------- replay determinism gate
        _, trace_reqs = read_trace(trace_path)
        replay_runs: List[Dict] = []
        for i in range(2):
            logger.info("distload: replay run %d (%d workers, "
                        "speedup %g)", i, workers, speedup)
            rres = await asyncio.to_thread(
                _run_dist,
                replay_assignments(trace_path, router.url,
                                   workers=workers, speedup=speedup),
                work_dir, worker_timeout_s, f"replay{i}")
            replay_runs.append({
                "summary": rres.merged_summary,
                "violations": rres.violations,
                "issued_digest": rres.issued_digest,
                "skew": rres.skew,
            })
        replay_block = {"trace": os.path.basename(trace_path),
                        "trace_requests": len(trace_reqs),
                        "speedup": speedup,
                        "runs": replay_runs}
        await _settle(procs, [p.name for p in procs], control_errors)
    finally:
        _stop(procs)

    # ---------------------------------------------------- capstone
    capstone_block: Optional[Dict] = None
    if capstone:
        capstone_block = await _run_capstone(
            trace_path=capstone_trace, workers=workers, speedup=speedup,
            routers=capstone_routers,
            engines_per_pool=capstone_engines_per_pool,
            service_jitter=service_jitter,
            worker_timeout_s=worker_timeout_s,
            startup_timeout_s=startup_timeout_s, log_dir=log_dir,
            work_dir=work_dir, control_errors=control_errors)

    detail = {
        "workers": record_workers,
        "declared_workers": workers,
        "engines": engines,
        "target_qps": qps,
        "phase_s": phase_s,
        "service_jitter": service_jitter,
        "min_workers": 3,
        "tolerances": {"qps_rel_tol": qps_rel_tol,
                       "pct_rel_tol": pct_rel_tol,
                       "pct_abs_tol_s": pct_abs_tol_s,
                       "min_chain_fraction": min_chain_fraction},
        "anti_vacuity_mode": anti_vacuity,
        "control": _dist_block(control_res),
        "dist": _dist_block(dist_res),
        "anti_vacuity": anti_block,
        "replay": replay_block,
        "capstone": capstone_block,
        "control_errors": control_errors,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    return {
        "metric": "distributed loadgen: merged-percentile parity vs "
                  "single-worker control + deterministic trace replay "
                  "+ composed routers/pools/obsplane capstone",
        "value": (dist_res.merged_summary or {})
        .get("output_tokens_per_s", 0.0),
        "unit": "out_tok/s",
        "platform": platform,
        "detail": detail,
    }


def add_cli_args(sp) -> None:
    """The ``loadgen distload`` flag surface (registered here, not in
    ``__main__.py``, so ``tools/check_flags_documented.py`` can scan
    this file as its own surface)."""
    sp.add_argument("--workers", type=int, default=3,
                    help="loadgen worker processes the coordinator "
                         "shards the schedule across (scaling gate "
                         "requires >= 3)")
    sp.add_argument("--engines", type=int, default=2,
                    help="fake engines behind the basic stack's router")
    sp.add_argument("--qps", type=float, default=6.0,
                    help="global open-loop target rate; each worker "
                         "runs at qps/workers")
    sp.add_argument("--phase", type=float, default=10.0,
                    help="seconds per scaling-gate phase (control and "
                         "distributed)")
    sp.add_argument("--trace", default=None,
                    help="trace replayed for the determinism gate "
                         "(default: the committed bursty_tenant trace)")
    sp.add_argument("--capstone-trace", default=None,
                    help="trace replayed through the capstone fleet "
                         "(default: the committed mixed_classes trace "
                         "— it carries the model-b stream pool-b "
                         "serves)")
    sp.add_argument("--speedup", type=float, default=4.0,
                    help="replay timeline compression (4 = replay a "
                         "40s trace in 10s)")
    sp.add_argument("--no-capstone", action="store_true",
                    help="skip the composed 2-router/2-pool/obsplane "
                         "capstone (tier-1 smoke runs this way)")
    sp.add_argument("--capstone-routers", type=int, default=2)
    sp.add_argument("--capstone-engines-per-pool", type=int, default=2)
    sp.add_argument("--anti-vacuity", default=None,
                    choices=["mismatched-rate", "single-worker"],
                    help="sabotage the run (workers at full global "
                         "rate each, or a 1-worker 'distributed' "
                         "side); the scaling gate must fail and the "
                         "command must exit 1")
    sp.add_argument("--skip-embedded-anti-vacuity", action="store_true",
                    help="skip the short mismatched-rate sub-run the "
                         "record embeds as self-test evidence")
    sp.add_argument("--service-jitter", type=float, default=0.25,
                    help="fake engines' deterministic per-request "
                         "service spread — real latency variance for "
                         "the percentile-parity gate to get wrong")
    sp.add_argument("--qps-rel-tol", type=float, default=0.25,
                    help="offered-load tolerance vs the target rate")
    sp.add_argument("--pct-rel-tol", type=float, default=0.35,
                    help="merged-vs-control percentile tolerance, "
                         "relative part")
    sp.add_argument("--pct-abs-tol", type=float, default=0.05,
                    help="merged-vs-control percentile tolerance, "
                         "absolute floor (seconds)")
    sp.add_argument("--min-chain-fraction", type=float, default=0.95,
                    help="capstone: fraction of obsplane-stitched "
                         "chains that must be complete")
    sp.add_argument("--worker-timeout", type=float, default=300.0,
                    help="coordinator kills a worker past this")
    sp.add_argument("--startup-timeout", type=float, default=60.0)
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--work-dir", default="loadgen-logs/distload",
                    help="assignment/records/summary files per worker")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--output", default=None,
                    help="write DISTLOAD_*.json here (default: "
                         "timestamped)")


async def _run_capstone(*, trace_path: str, workers: int,
                        speedup: float, routers: int,
                        engines_per_pool: int, service_jitter: float,
                        worker_timeout_s: float,
                        startup_timeout_s: float, log_dir: str,
                        work_dir: str,
                        control_errors: List[str]) -> Dict:
    """2 peered pool-routers + two-pool fleet + obsplane under
    multi-worker replayed traffic."""
    procs: List[Proc] = []
    try:
        pool_a = [launch_engine(
            "fake", free_port(), log_dir=log_dir,
            extra_args=["--model", BASE_MODEL, "--adapters", LORA_MODEL,
                        "--strict-models", "--ttft", "0.04",
                        "--tokens-per-s", "300", "--num-tokens", "16",
                        "--service-jitter", str(service_jitter)])
            for _ in range(engines_per_pool)]
        pool_b = [launch_engine(
            "fake", free_port(), log_dir=log_dir,
            extra_args=["--model", POOL_B_MODEL, "--strict-models",
                        "--ttft", "0.04", "--tokens-per-s", "300",
                        "--num-tokens", "16",
                        "--service-jitter", str(service_jitter)])
            for _ in range(engines_per_pool)]
        procs.extend(pool_a + pool_b)
        await asyncio.gather(*[wait_healthy(e.url, startup_timeout_s)
                               for e in pool_a + pool_b])
        pools_json = json.dumps({
            "pool-a": {"backends": [e.url for e in pool_a],
                       "models": [BASE_MODEL, LORA_MODEL],
                       "routing_logic": "session"},
            "pool-b": {"backends": [e.url for e in pool_b],
                       "models": [POOL_B_MODEL],
                       "routing_logic": "roundrobin"},
        })
        router_ports = [free_port() for _ in range(routers)]
        router_urls = [f"http://127.0.0.1:{p}" for p in router_ports]
        router_procs: List[Proc] = []
        for i, port in enumerate(router_ports):
            peers = [u for j, u in enumerate(router_urls) if j != i]
            cmd = [sys.executable, "-m",
                   "production_stack_tpu_torch.router.app",
                   "--host", "127.0.0.1", "--port", str(port),
                   "--service-discovery", "static",
                   "--pools", pools_json,
                   "--engine-stats-interval", "1",
                   "--router-id", f"router-{i}"]
            if peers:
                cmd += ["--peer-routers", ",".join(peers),
                        "--peer-gossip-interval", "0.5"]
            router_procs.append(_spawn(f"capstone-router-{port}", cmd,
                                       f"http://127.0.0.1:{port}",
                                       log_dir))
        procs.extend(router_procs)
        await asyncio.gather(*[
            wait_healthy(r.url, startup_timeout_s,
                         require_endpoints=2 * engines_per_pool)
            for r in router_procs])
        obsplane = launch_obsplane(
            router_urls, [e.url for e in pool_a + pool_b], free_port(),
            log_dir=log_dir,
            incident_dir=os.path.join(work_dir, "incidents"),
            extra_args=["--poll-interval", "0.5",
                        "--scrape-timeout", "2"])
        procs.append(obsplane)
        await wait_healthy(obsplane.url, startup_timeout_s)

        # workers pinned round-robin across routers — one coordinated
        # run whose shards enter the fleet through different frontends
        assignments = []
        for i in range(workers):
            assignments.extend(replay_assignments(
                trace_path, router_urls[i % len(router_urls)],
                workers=workers, speedup=speedup)[i:i + 1])
        res = await asyncio.to_thread(
            _run_dist, assignments, work_dir, worker_timeout_s,
            "capstone")
        # let the obsplane's poll loop drain the engines' trace rings
        await asyncio.sleep(2.5)

        stitch: Dict = {}
        pools_served: Dict[str, int] = {}
        async with aiohttp.ClientSession() as s:
            try:
                async with s.get(f"{obsplane.url}/fleet/traces",
                                 timeout=aiohttp.ClientTimeout(
                                     total=5)) as r:
                    if r.status == 200:
                        stitch = (await r.json()).get("stats") or {}
                    else:
                        control_errors.append(
                            f"CAPSTONE GET /fleet/traces -> {r.status}")
            except (aiohttp.ClientError, asyncio.TimeoutError,
                    OSError) as e:
                control_errors.append(
                    f"CAPSTONE /fleet/traces: {type(e).__name__}: {e}")
            # per-pool traffic census from the engines' own counters
            for eng, pool in ([(e, "pool-a") for e in pool_a]
                              + [(e, "pool-b") for e in pool_b]):
                try:
                    async with s.get(f"{eng.url}/load",
                                     timeout=aiohttp.ClientTimeout(
                                         total=5)) as r:
                        mr = (await r.json()).get("model_requests") or {}
                        for m, n in mr.items():
                            pools_served[m] = pools_served.get(m, 0) + n
                except (aiohttp.ClientError, asyncio.TimeoutError,
                        OSError) as e:
                    control_errors.append(
                        f"CAPSTONE {eng.name}/load: "
                        f"{type(e).__name__}: {e}")
        await _settle(procs, [p.name for p in procs], control_errors)
        return {
            "trace": os.path.basename(trace_path),
            "routers": routers,
            "engines_per_pool": engines_per_pool,
            "summary": res.merged_summary,
            "per_worker": res.per_worker,
            "skew": res.skew,
            "violations": res.violations,
            "issued_digest": res.issued_digest,
            "stitch": stitch,
            "pools_served": pools_served,
        }
    finally:
        _stop(procs)
