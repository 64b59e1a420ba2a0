"""CLI: python -m production_stack_tpu_torch.loadgen
{run,soak,scaleout,overhead,chaos,overload}

run      — drive a workload (preset or --spec JSON file) against a
           running stack; print + write a BENCH-schema JSON report
soak     — duration-bounded mixed-traffic run with invariant checks,
           abort injection, and periodic checkpoint lines; exit 1 on
           any invariant violation
scaleout — launch real router+engine processes at N=1,2,4,... and
           write the aggregate-tokens/s-vs-replicas SCALEOUT_*.json
overhead — launch one engine + the router, drive the identical
           closed-loop storm at both URLs, report router-vs-direct
           req/s and the overhead ratio (ROUTER_OVERHEAD_*.json)
chaos    — launch the router + N engines and kill/restart engines on
           a schedule while storming the router; exit 1 on any
           client-visible 5xx / router transport error
           (CHAOS_*.json)
overload — launch router + N engines (with overload protection) and
           sweep open-loop offered QPS past saturation; exit 1 unless
           goodput plateaus, zero accepted requests violate their
           deadline, and nothing 5xxes (OVERLOAD_*.json)
autoscale — launch router + autoscaler-owned engines and drive an
           open-loop QPS ramp up then down; replicas must track the
           ramp (1 -> N -> 1) with zero client-visible 5xx across
           every scale-up and drain-based scale-down, goodput at the
           peak must track offered load and beat the fixed-N
           comparison baseline (AUTOSCALE_*.json)
kvshare  — launch a shared TPKV cache server + N engines wired to it
           + the router with session affinity deliberately broken;
           drive multi-round QA and exit 1 unless the cross-replica
           tier hit rate clears 60% AND follow-up-round TTFT beats
           the recompute baseline (KVSHARE_*.json)
disagg   — launch the P/D split (cache server + prefill pool + decode
           pool + router with --prefill-backends) AND the aggregated
           baseline at equal engine count; drive a mixed long-prefill/
           short-decode storm at both (SIGKILLing a prefill pod
           mid-run) and exit 1 unless chat ITL p99 improves with zero
           client-visible errors (DISAGG_*.json)
firedrill — launch router + N engines with SLO windows scaled to
           seconds, storm a clean baseline (zero alerts may fire),
           then inject fault scenarios (partial 500s, engine SIGKILL,
           TTFT inflation, overload storm, queue-delay override); each
           must fire its expected burn-rate alert within the detection
           bound and resolve after the fault clears; exit 1 on any
           miss, false fire, or non-resolution (FIREDRILL_*.json;
           --overhead-guard re-runs the r7 A/B with SLO accounting on)
effwatch — launch ONE engine and audit its efficiency accounting
           around a steady storm: real+pad+dead token-step deltas must
           sum to the independent total within tolerance, accounted
           decode tokens/s must reconcile with client-measured
           throughput within 10%, and zero XLA compile events may land
           in the post-warmup steady window; --anti-vacuity mis-sizes
           the accounting window and must fail (EFF_*.json)
multirouter — launch N peered router replicas (breaker/drain gossip,
           QoS tiers, apportioned caps) behind an in-process L4
           splitter; exit 1 unless pair affinity matches the
           single-router control within tolerance, breaker state
           converges across replicas within one probe interval, a
           router SIGKILL costs only the counted in-flight blip, and
           a saturation sweep holds tier-0 goodput while tier-2
           sheds (MULTIROUTER_*.json; --no-shared-state must fail
           the affinity gate)
multitenant — launch TWO named pools (model-a + runtime LoRA
           adapters, model-b) behind one pooled router, each with its
           own per-pool autoscaler sharing one actuation budget; exit
           1 unless routing is 100%% model-correct against strict
           engines, pool-b goodput holds through pool-a's adapter
           churn + engine SIGKILL with zero errors, a bursting tenant
           is shed >=50%% while same-tier peers hold >=95%% goodput,
           and BOTH pool labels appear as applied scale-ups in the
           decision log (TENANT_*.json; --no-tenant-buckets must fail
           the peer-goodput gate)
trace    — launch router + engines (optionally the disagg split),
           storm them, and join client x-trace-ids against the
           router's and engines' /debug/traces rings; exit 1 unless
           >=95%% of sampled requests have a complete span chain,
           unattributed time is <10%% at p50, and nothing errored
           (TRACE_*.json; --overhead-guard re-runs the r7 A/B with
           tracing on)
incident — launch N peered routers + M engines + the obsplane fleet
           flight recorder; a clean baseline must capture zero
           incident bundles while the online stitcher joins chains,
           then each injected fault (one-engine TTFT inflation,
           engine SIGKILL, an aimed shed storm) must fire its alert,
           yield exactly one complete bundle (every fleet process
           represented), and the bundle's attribution must name the
           injected culprit process and the correct phase; exit 1 on
           any spurious capture, miss, or wrong attribution
           (INCIDENT_*.json; --overhead-guard runs the r7 A/B with
           and without the obsplane scraping the serving pair)
fleetdrill — the r20 fleet-pilot closed loop: (1) the same latency
           burn run twice — burn-rate-driven pilot vs queue-delay-only
           control — the pilot must scale on the page alert (reason
           burn_rate, signal source fleet) and resolve with zero shed
           at LOWER replica-seconds; (2) a slow engine must be
           detected, drained, restarted and verified hands-off with
           EXACTLY ONE remediation in the decision log; (3) the same
           injection with the kill-switch down must log
           suppressed_killswitch while the alert keeps burning
           (FLEETDRILL_*.json)
distload — distributed load generation closed loop: launch router +
           fake engines, drive the same open-loop workload as ONE
           worker (control) and as N coordinator-sharded worker
           processes at qps/N each; exit 1 unless the merged offered
           load and merge-then-quantile percentiles match the control
           within tolerance with zero errors, two sharded replays of
           the committed trace issue identical request multisets, and
           (unless --no-capstone) 2 peered pool-routers + the two-pool
           fleet + obsplane under replayed mixed traffic stitch >=95%
           complete chains with zero raw 5xx; the record embeds a
           mismatched-rate sub-run that must FAIL the scaling gate
           (DISTLOAD_*.json; --anti-vacuity must exit 1)
kvmigrate — the kvplane closed loop: a fragmentation storm (one
           replica's pool injected into the fragmented-admission
           regime behind the router) run with and without the kvplane
           planner — migration ON must collapse the engine-census
           fragmented-failure rate to ~0 in the second half at
           constant aggregate blocks, migration OFF must keep failing
           (anti-vacuity) — plus the kvshare storm re-run through the
           raw vs int4 tier codecs: >=2x logical/physical capacity at
           equal bytes with hit TTFT within tolerance
           (KVMIGRATE_*.json)

Reproduction one-liners live in docs/benchmarks.md and BASELINE.md.
"""

import argparse
import asyncio
import json
import re
import sys
import time

from production_stack_tpu_torch.loadgen import report as report_mod
from production_stack_tpu_torch.loadgen.autoscale import (autoscale_violations,
                                                    run_autoscale)
from production_stack_tpu_torch.loadgen.chaos import chaos_violations, run_chaos
from production_stack_tpu_torch.loadgen.disagg import (disagg_violations,
                                                 run_disagg)
from production_stack_tpu_torch.loadgen.distributed.distload import (
    add_cli_args as distload_cli_args, distload_violations, run_distload)
from production_stack_tpu_torch.loadgen.distributed.tracefile import (
    trace_from_records, write_trace)
from production_stack_tpu_torch.loadgen.effwatch import (effwatch_ab_violations,
                                                   effwatch_violations,
                                                   run_effwatch,
                                                   run_effwatch_ab)
from production_stack_tpu_torch.loadgen.firedrill import (SCENARIO_NAMES,
                                                    firedrill_violations,
                                                    run_firedrill)
from production_stack_tpu_torch.loadgen.fleetdrill import (
    SCENARIO_NAMES as FLEETDRILL_SCENARIOS, fleetdrill_violations,
    run_fleetdrill)
from production_stack_tpu_torch.loadgen.incident import (
    SCENARIO_NAMES as INCIDENT_SCENARIOS, incident_violations,
    run_incident)
from production_stack_tpu_torch.loadgen.kvmigrate import (kvmigrate_violations,
                                                    run_kvmigrate)
from production_stack_tpu_torch.loadgen.kvshare import (kvshare_violations,
                                                  run_kvshare)
from production_stack_tpu_torch.loadgen.multirouter import (
    multirouter_violations, run_multirouter)
from production_stack_tpu_torch.loadgen.multitenant import (
    multitenant_violations, run_multitenant)
from production_stack_tpu_torch.loadgen.orchestrator import run_scaleout
from production_stack_tpu_torch.loadgen.overhead import run_overhead
from production_stack_tpu_torch.loadgen.overload import (overload_violations,
                                                   run_overload)
from production_stack_tpu_torch.loadgen.runner import run_workload
from production_stack_tpu_torch.loadgen.spec import WorkloadSpec, preset
from production_stack_tpu_torch.loadgen.trace import run_trace, trace_violations


def parse_duration(text: str) -> float:
    """'120', '120s', '5m', '4.4h' -> seconds."""
    m = re.fullmatch(r"\s*([0-9.]+)\s*([smh]?)\s*", text)
    if not m:
        raise argparse.ArgumentTypeError(f"bad duration {text!r}")
    mult = {"": 1.0, "s": 1.0, "m": 60.0, "h": 3600.0}[m.group(2)]
    return float(m.group(1)) * mult


def _load_spec(args) -> WorkloadSpec:
    if getattr(args, "spec", None):
        spec = WorkloadSpec.from_file(args.spec)
    else:
        spec = preset(args.workload)
    if getattr(args, "model", None):
        spec.model = args.model
    if getattr(args, "seed", None) is not None:
        spec.seed = args.seed
    if getattr(args, "users", None) is not None:
        spec.arrival.users = args.users
    return spec.validate()


def _print_report(result, out: dict) -> None:
    print(json.dumps(out, indent=2))
    if result.violations:
        print(f"INVARIANT VIOLATIONS ({len(result.violations)}):",
              file=sys.stderr)
        for v in result.violations[:20]:
            print(f"  - {v}", file=sys.stderr)


def _record_trace(result, spec, path: str) -> None:
    """The recorder leg of the distributed-loadgen loop: dump the run's
    per-request schedule (measured arrival offsets + planned shapes) as
    a replayable ``*.trace.jsonl``."""
    reqs = trace_from_records(result.records, spec)
    write_trace(path, {"name": spec.name, "seed": spec.seed,
                       "notes": f"recorded from a live {spec.name} run "
                                f"({spec.arrival.mode}-loop)"}, reqs)
    print(f"recorded {len(reqs)} requests to {path} (replay: loadgen "
          f"distload --trace {path}, or distributed.worker in replay "
          f"mode)", file=sys.stderr)


def cmd_run(args) -> int:
    spec = _load_spec(args)
    result = asyncio.run(run_workload(
        spec, args.base_url, api_key=args.api_key,
        duration_s=args.duration, max_sessions=args.max_sessions,
        checkpoint_interval_s=args.checkpoint_interval))
    out = report_mod.bench_schema(
        f"loadgen {spec.name} ({spec.arrival.mode}-loop) via "
        f"{args.base_url}", result.summary,
        detail={"workload": spec.name, "seed": spec.seed,
                "model": spec.model, "arrival_mode": spec.arrival.mode})
    if args.output:
        report_mod.write_json(args.output, out)
    if args.record_trace:
        _record_trace(result, spec, args.record_trace)
    _print_report(result, out)
    return 0 if result.ok else 1


def cmd_soak(args) -> int:
    spec = _load_spec(args)
    # precedence: explicit --duration, else the spec file's own
    # duration_s, else 120 s — a spec configured for a 4.4 h soak must
    # not be silently truncated by the CLI default
    duration = args.duration if args.duration is not None else \
        (spec.duration_s if spec.duration_s is not None else 120.0)
    result = asyncio.run(run_workload(
        spec, args.base_url, api_key=args.api_key,
        duration_s=duration,
        abort_fraction=args.abort_fraction,
        p99_ttft_bound_s=args.p99_ttft_bound,
        checkpoint_interval_s=args.checkpoint_interval,
        checkpoint_path=args.checkpoint_file))
    if args.record_trace:
        _record_trace(result, spec, args.record_trace)
    out = report_mod.bench_schema(
        f"loadgen soak {spec.name} ({duration:.0f}s)",
        result.summary,
        detail={"workload": spec.name, "seed": spec.seed,
                "model": spec.model,
                "abort_fraction": args.abort_fraction,
                "invariant_violations": result.violations,
                "checkpoints": len(result.checkpoints)})
    if args.output:
        report_mod.write_json(args.output, out)
    _print_report(result, out)
    if result.ok:
        print(f"soak PASSED: {result.summary['finished']} requests, "
              f"zero invariant violations")
    return 0 if result.ok else 1


def cmd_distload(args) -> int:
    record = asyncio.run(run_distload(
        engines=args.engines, workers=args.workers, qps=args.qps,
        phase_s=args.phase, trace_path=args.trace,
        capstone_trace=args.capstone_trace, speedup=args.speedup,
        capstone=not args.no_capstone,
        capstone_routers=args.capstone_routers,
        capstone_engines_per_pool=args.capstone_engines_per_pool,
        anti_vacuity=args.anti_vacuity,
        skip_embedded_anti_vacuity=args.skip_embedded_anti_vacuity,
        service_jitter=args.service_jitter,
        qps_rel_tol=args.qps_rel_tol, pct_rel_tol=args.pct_rel_tol,
        pct_abs_tol_s=args.pct_abs_tol,
        min_chain_fraction=args.min_chain_fraction,
        worker_timeout_s=args.worker_timeout,
        startup_timeout_s=args.startup_timeout,
        log_dir=args.log_dir, work_dir=args.work_dir,
        platform=args.platform))
    print(json.dumps(record, indent=2))
    output = args.output or \
        f"DISTLOAD_{time.strftime('%Y%m%d_%H%M%S')}.json"
    report_mod.write_json(output, record)
    violations = distload_violations(
        record, min_chain_fraction=args.min_chain_fraction)
    for v in violations:
        print(f"DISTLOAD VIOLATION: {v}", file=sys.stderr)
    if not violations:
        d = record["detail"]
        dist, ctrl = d["dist"]["summary"], d["control"]["summary"]
        av = d.get("anti_vacuity") or {}
        msg = (f"distload PASSED: {d['workers']} workers offered "
               f"{dist['offered_qps']:.2f} qps (control "
               f"{ctrl['offered_qps']:.2f}, target {d['target_qps']}), "
               f"merged ttft p50 {dist['ttft_s']['p50']*1000:.1f}ms vs "
               f"control {ctrl['ttft_s']['p50']*1000:.1f}ms, replay "
               f"digest stable over "
               f"{len(d['replay']['runs'])} runs")
        if av:
            msg += (f"; embedded mismatched-rate run failed the gate "
                    f"as required ({len(av['violations'])} violations "
                    f"at {av.get('offered_qps', 0):.2f} qps offered)")
        cap = d.get("capstone")
        if cap:
            msg += (f"; capstone stitched "
                    f"{cap['stitch'].get('chains_complete', 0)} chains "
                    f"({cap['stitch'].get('complete_fraction', 0):.0%} "
                    f"complete) across {cap['routers']} routers / 2 "
                    f"pools with 0 raw 5xx")
        print(msg)
    return 1 if violations else 0


def cmd_scaleout(args) -> int:
    spec = _load_spec(args)
    replicas = [int(x) for x in args.replicas.split(",") if x.strip()]
    output = args.output or \
        f"SCALEOUT_{time.strftime('%Y%m%d_%H%M%S')}.json"
    record = asyncio.run(run_scaleout(
        spec, replicas=replicas, engine=args.engine,
        routing=args.routing, duration_s=args.duration,
        users_per_replica=args.users_per_replica,
        platform=args.platform, log_dir=args.log_dir,
        startup_timeout_s=args.startup_timeout,
        checkpoint_interval_s=args.checkpoint_interval, output=output))
    print(json.dumps(record, indent=2))
    # a curve measured through an error storm is not a curve: fail the
    # run (same contract as run/soak, whose exit status BASELINE.md
    # advertises as enforcing the invariants)
    bad = [p for p in record["points"]
           if p["errors"] or p.get("invariant_violations")]
    for p in bad:
        print(f"N={p['replicas']}: {p['errors']} errors, "
              f"{len(p.get('invariant_violations') or [])} invariant "
              f"violations — curve is suspect", file=sys.stderr)
    return 1 if bad else 0


def cmd_overhead(args) -> int:
    record = asyncio.run(run_overhead(
        engine=args.engine, users=args.users, duration_s=args.duration,
        num_tokens=args.num_tokens, stream=args.stream,
        routing=args.routing, platform=args.platform,
        log_dir=args.log_dir, startup_timeout_s=args.startup_timeout,
        snapshot_ttl=args.snapshot_ttl,
        unique_prompts=args.unique_prompts,
        prompt_chars=args.prompt_chars))
    print(json.dumps(record, indent=2))
    if args.output:
        report_mod.write_json(args.output, record)
    d = record["detail"]
    bad = d["direct"]["errors"] + d["router"]["errors"]
    if bad:
        print(f"{bad} requests errored — the A/B is suspect",
              file=sys.stderr)
        return 1
    ratio = d["overhead_ratio"]
    if args.max_ratio and ratio and ratio > args.max_ratio:
        print(f"OVERHEAD VIOLATION: ratio {ratio:.2f}x exceeds the "
              f"--max-ratio {args.max_ratio:g}x band", file=sys.stderr)
        return 1
    return 0


def cmd_chaos(args) -> int:
    record = asyncio.run(run_chaos(
        engines=args.engines, engine=args.engine, users=args.users,
        duration_s=args.duration, kill_interval_s=args.kill_interval,
        downtime_s=args.downtime,
        error_burst_interval_s=args.error_burst_interval or None,
        error_burst=args.error_burst,
        stream_fraction=args.stream_fraction,
        num_tokens=args.num_tokens, routing=args.routing,
        seed=args.seed, p99_bound_s=args.p99_bound,
        platform=args.platform, log_dir=args.log_dir,
        startup_timeout_s=args.startup_timeout,
        cache_server_kill=args.cache_server_kill,
        cache_kill_interval_s=args.cache_kill_interval,
        cache_downtime_s=args.cache_downtime,
        router_kill=args.router_kill,
        router_replicas=args.router_replicas,
        router_kill_interval_s=args.router_kill_interval,
        router_downtime_s=args.router_downtime,
        router_blip_window_s=args.router_blip_window))
    print(json.dumps(record, indent=2))
    output = args.output or f"CHAOS_{time.strftime('%Y%m%d_%H%M%S')}.json"
    report_mod.write_json(output, record)
    violations = chaos_violations(record)
    for v in violations:
        print(f"CHAOS VIOLATION: {v}", file=sys.stderr)
    if not violations:
        d = record["detail"]
        print(f"chaos PASSED: {d['requests']['ok']} ok, "
              f"{d['kills']} kills/{d['restarts']} restarts, "
              f"zero client-visible 5xx "
              f"(availability {d['availability_pct']:.2f}%, "
              f"{d['requests']['truncated_streams']} mid-stream "
              f"truncations)")
    return 1 if violations else 0


def cmd_overload(args) -> int:
    qps = [float(x) for x in args.qps.split(",") if x.strip()]
    record = asyncio.run(run_overload(
        engines=args.engines, engine=args.engine, qps_points=qps,
        duration_s=args.duration, deadline_ms=args.deadline_ms,
        num_tokens=args.num_tokens, fake_capacity=args.fake_capacity,
        fake_tokens_per_s=args.fake_tokens_per_s,
        unprotected=args.unprotected,
        plateau_tolerance=args.plateau_tolerance,
        platform=args.platform, log_dir=args.log_dir,
        startup_timeout_s=args.startup_timeout))
    print(json.dumps(record, indent=2))
    output = args.output or \
        f"OVERLOAD_{time.strftime('%Y%m%d_%H%M%S')}.json"
    report_mod.write_json(output, record)
    if args.unprotected:
        # the "before" curve EXISTS to show the collapse; don't fail it
        print("unprotected baseline sweep recorded (no contract "
              "enforced)", file=sys.stderr)
        return 0
    violations = overload_violations(
        record, plateau_tolerance=args.plateau_tolerance)
    for v in violations:
        print(f"OVERLOAD VIOLATION: {v}", file=sys.stderr)
    if not violations:
        d = record["detail"]
        top = d["points"][-1]
        print(f"overload PASSED: goodput peak {record['value']} qps, "
              f"plateau held at {top['offered_qps']} qps offered "
              f"({top['goodput_qps']} qps goodput, "
              f"{top['shed']} shed, 0 late, 0 errors)")
    return 1 if violations else 0


def cmd_effwatch(args) -> int:
    mixed = ([int(x) for x in args.mixed_tokens.split(",")]
             if args.mixed_tokens else None)
    common = dict(
        engine=args.engine, users=args.users, duration_s=args.duration,
        warmup_s=args.warmup, num_tokens=args.num_tokens,
        sum_tolerance=args.sum_tolerance,
        rate_tolerance=args.rate_tolerance,
        stagger_s=args.stagger, mixed_tokens=mixed,
        prompt_chars=args.prompt_chars,
        engine_args=args.engine_args.split() if args.engine_args
        else None,
        fake_pad_fraction=args.fake_pad_fraction,
        fake_dead_fraction=args.fake_dead_fraction,
        fake_skew=args.fake_skew,
        platform=args.platform, log_dir=args.log_dir,
        startup_timeout_s=args.startup_timeout)
    output = args.output or \
        f"EFF_{time.strftime('%Y%m%d_%H%M%S')}.json"
    if args.ab:
        if args.anti_vacuity:
            print("--anti-vacuity is a single-run falsifiability "
                  "probe (mis-sized accounting window, gates must "
                  "fail); it has no A/B semantics — run it without "
                  "--ab", file=sys.stderr)
            return 2
        if args.no_window_adapt:
            print("--no-window-adapt is the single-run control side "
                  "by itself; --ab already runs both sides — pick "
                  "one", file=sys.stderr)
            return 2
        record = asyncio.run(run_effwatch_ab(
            live_floor=args.live_floor,
            improve_floor=args.improve_floor,
            rounds=args.rounds, **common))
        print(json.dumps(record, indent=2))
        report_mod.write_json(output, record)
        violations = effwatch_ab_violations(
            record, live_floor=args.live_floor,
            improve_floor=args.improve_floor,
            sum_tolerance=args.sum_tolerance,
            rate_tolerance=args.rate_tolerance)
        for v in violations:
            print(f"EFFWATCH A/B VIOLATION: {v}", file=sys.stderr)
        if not violations:
            d = record["detail"]
            print(f"effwatch A/B PASSED: accounted decode tok/s "
                  f"{d['accounted_decode_tokens_per_s_adapt']} adapt "
                  f"vs {d['accounted_decode_tokens_per_s_control']} "
                  f"control (+{d['improvement_perc']}%), live "
                  f"fraction {d['live_fraction_adapt']} vs "
                  f"{d['live_fraction_control']}, all per-side gates "
                  f"green")
        return 1 if violations else 0
    record = asyncio.run(run_effwatch(
        anti_vacuity=args.anti_vacuity,
        window_adapt=not args.no_window_adapt, **common))
    print(json.dumps(record, indent=2))
    report_mod.write_json(output, record)
    violations = effwatch_violations(
        record, sum_tolerance=args.sum_tolerance,
        rate_tolerance=args.rate_tolerance)
    if args.anti_vacuity:
        # the mis-sized window EXISTS to prove the gates can fail
        if any("diverge" in v for v in violations):
            print("effwatch anti-vacuity PASSED: the mis-sized window "
                  "failed the reconciliation gate as it must",
                  file=sys.stderr)
            return 0
        print("effwatch anti-vacuity FAILED: the reconciliation gate "
              "did not trip on a deliberately mis-sized window",
              file=sys.stderr)
        return 1
    for v in violations:
        print(f"EFFWATCH VIOLATION: {v}", file=sys.stderr)
    if not violations:
        d = record["detail"]
        print(f"effwatch PASSED: accounted {record['value']} decode "
              f"tok/s vs client {d['client_decode_tokens_per_s']} "
              f"(fraction sum {d['fraction_sum']}, live fraction "
              f"{d['live_fraction_steady']}, mbu "
              f"{d['mbu_perc_steady']}%, 0 steady compiles, 0 errors)")
    return 1 if violations else 0


def cmd_autoscale(args) -> int:
    qps = [float(x) for x in args.qps.split(",") if x.strip()]

    def ramp(fixed_replicas=None):
        return run_autoscale(
            engine=args.engine, qps_profile=qps,
            phase_duration_s=args.phase_duration,
            min_replicas=args.min_replicas,
            max_replicas=args.max_replicas,
            initial_replicas=args.min_replicas,
            deadline_ms=args.deadline_ms, num_tokens=args.num_tokens,
            fake_capacity=args.fake_capacity,
            fake_tokens_per_s=args.fake_tokens_per_s,
            tick_interval_s=args.tick_interval,
            target_utilization=args.target_utilization,
            down_utilization=args.down_utilization,
            target_queue_delay_ms=args.target_queue_delay_ms,
            down_queue_delay_ms=args.down_queue_delay_ms,
            up_cooldown_s=args.up_cooldown,
            down_cooldown_s=args.down_cooldown,
            fixed_replicas=fixed_replicas,
            drain_timeout_s=args.drain_timeout,
            platform=args.platform, log_dir=args.log_dir,
            startup_timeout_s=args.startup_timeout)

    record = asyncio.run(ramp())
    if args.compare_fixed > 0:
        print(f"autoscale ramp done; measuring the fixed-N="
              f"{args.compare_fixed} comparison baseline...",
              file=sys.stderr)
        record["detail"]["comparison"] = asyncio.run(
            ramp(fixed_replicas=args.compare_fixed))
    print(json.dumps(record, indent=2))
    output = args.output or \
        f"AUTOSCALE_{time.strftime('%Y%m%d_%H%M%S')}.json"
    report_mod.write_json(output, record)
    violations = autoscale_violations(
        record, track_fraction=args.track_fraction,
        compare_margin=args.compare_margin)
    for v in violations:
        print(f"AUTOSCALE VIOLATION: {v}", file=sys.stderr)
    if not violations:
        d = record["detail"]
        print(f"autoscale PASSED: replicas "
              f"{d['replicas_initial']} -> "
              f"{d['max_replicas_observed']} -> "
              f"{d['final_replicas']} tracking the ramp, "
              f"{d['scale_ups']} scale-up(s) / {d['scale_downs']} "
              f"drain-safe scale-down(s), peak goodput "
              f"{record['value']} qps, zero client-visible errors")
    return 1 if violations else 0


def cmd_kvshare(args) -> int:
    record = asyncio.run(run_kvshare(
        engines=args.engines, engine=args.engine,
        sessions=args.sessions, rounds=args.rounds,
        system_chars=args.system_chars, round_chars=args.round_chars,
        num_tokens=args.num_tokens,
        prefill_ms_per_char=args.prefill_ms_per_char,
        kv_chunk_chars=args.kv_chunk_chars, routing=args.routing,
        seed=args.seed, no_cache=args.no_cache,
        platform=args.platform, log_dir=args.log_dir,
        startup_timeout_s=args.startup_timeout))
    print(json.dumps(record, indent=2))
    output = args.output or \
        f"KVSHARE_{time.strftime('%Y%m%d_%H%M%S')}.json"
    report_mod.write_json(output, record)
    violations = kvshare_violations(record,
                                    min_hit_rate=args.min_hit_rate)
    for v in violations:
        print(f"KVSHARE VIOLATION: {v}", file=sys.stderr)
    if not violations:
        d = record["detail"]
        ttft = d["ttft_followup_mean_ms"]
        print(f"kvshare PASSED: {record['value']}% tier hit rate with "
              f"affinity broken across {d['engines']} replicas "
              f"(foreign share "
              f"{d['cached']['foreign_share']:.0%}), follow-up TTFT "
              f"{ttft['cached']:.0f}ms vs {ttft['recompute']:.0f}ms "
              f"recompute ({ttft['improvement_pct']:.0f}% faster)")
    return 1 if violations else 0


def cmd_kvmigrate(args) -> int:
    record = asyncio.run(run_kvmigrate(
        storm_duration_s=args.storm_duration,
        storm_workers=args.storm_workers,
        poll_interval_s=args.poll_interval,
        codec=args.codec, sessions=args.sessions, rounds=args.rounds,
        seed=args.seed, platform=args.platform, log_dir=args.log_dir,
        startup_timeout_s=args.startup_timeout))
    print(json.dumps(record, indent=2))
    output = args.output or \
        f"KVMIGRATE_{time.strftime('%Y%m%d_%H%M%S')}.json"
    report_mod.write_json(output, record)
    violations = kvmigrate_violations(
        record, max_on_failure_rate=args.max_on_failure_rate,
        min_off_failure_rate=args.min_off_failure_rate,
        min_capacity_ratio=args.min_capacity_ratio,
        ttft_tolerance=args.ttft_tolerance)
    for v in violations:
        print(f"KVMIGRATE VIOLATION: {v}", file=sys.stderr)
    if not violations:
        d = record["detail"]
        on2 = d["storm"]["on"]["halves"][1]
        off2 = d["storm"]["off"]["halves"][1]
        ratios = d["codec"]["capacity_ratio"]
        print(f"kvmigrate PASSED: migration erased the fragmented "
              f"regime ({on2['failure_rate']:.1%} second-half failure "
              f"rate vs {off2['failure_rate']:.1%} with migration "
              f"OFF, {d['storm']['on']['planner']['moves']} moves, "
              f"aggregate blocks constant); codec "
              f"{d['codec']['name']} capacity "
              f"{ratios[d['codec']['name']]:.2f}x vs raw "
              f"{ratios['raw']:.2f}x at equal logical bytes")
    return 1 if violations else 0


def cmd_disagg(args) -> int:
    record = asyncio.run(run_disagg(
        prefill_engines=args.prefill_engines,
        decode_engines=args.decode_engines, engine=args.engine,
        chat_users=args.chat_users, rag_users=args.rag_users,
        duration_s=args.duration,
        chat_prompt_chars=args.chat_prompt_chars,
        chat_tokens=args.chat_tokens,
        rag_prompt_chars=args.rag_prompt_chars,
        rag_tokens=args.rag_tokens,
        tokens_per_s=args.fake_tokens_per_s,
        prefill_ms_per_char=args.prefill_ms_per_char,
        interference=args.interference,
        kv_chunk_chars=args.kv_chunk_chars,
        headstart_s=args.headstart,
        min_prompt_chars=args.min_prompt_chars,
        routing=args.routing, seed=args.seed, no_split=args.no_split,
        prefill_kill=not args.no_prefill_kill,
        kill_downtime_s=args.kill_downtime,
        platform=args.platform, log_dir=args.log_dir,
        startup_timeout_s=args.startup_timeout))
    print(json.dumps(record, indent=2))
    output = args.output or \
        f"DISAGG_{time.strftime('%Y%m%d_%H%M%S')}.json"
    report_mod.write_json(output, record)
    violations = disagg_violations(
        record,
        min_itl_improvement=(args.min_itl_improvement
                             if args.min_itl_improvement >= 0 else None))
    for v in violations:
        print(f"DISAGG VIOLATION: {v}", file=sys.stderr)
    if not violations:
        d = record["detail"]
        itl = d["chat_itl_p99_ms"]
        chaos = d["split_phase"].get("chaos") or {}
        if itl.get("improvement_pct") is not None:
            itl_msg = (f"chat ITL p99 {itl['split']:.1f}ms split vs "
                       f"{itl['aggregated']:.1f}ms aggregated "
                       f"({itl['improvement_pct']:.0f}% better)")
        else:
            # single-chunk chat streams yield no ITL samples; only
            # reachable with the gate disabled (negative
            # --min-itl-improvement), where the data-path gates carry
            # the contract
            itl_msg = "chat ITL not sampled (single-chunk streams)"
        print(f"disagg PASSED: {itl_msg} at equal engine "
              f"count ({d['prefill_engines']}P+{d['decode_engines']}D), "
              f"{chaos.get('kills', 0)} prefill-pod kill(s) with zero "
              f"client-visible errors")
    return 1 if violations else 0


def cmd_firedrill(args) -> int:
    scenarios = None
    if args.scenarios:
        scenarios = [s.strip() for s in args.scenarios.split(",")
                     if s.strip()]
    record = asyncio.run(run_firedrill(
        engines=args.engines, engine=args.engine, users=args.users,
        baseline_s=args.baseline, window_scale=args.window_scale,
        scenarios=scenarios,
        detect_timeout_s=args.detect_timeout,
        resolve_timeout_s=args.resolve_timeout,
        num_tokens=args.num_tokens,
        fake_tokens_per_s=args.fake_tokens_per_s,
        error_rate=args.error_rate,
        slow_ttft_arg_s=args.slow_ttft_arg,
        ttft_threshold_s=args.ttft_threshold,
        overload_capacity=args.overload_capacity,
        queue_delay_ms=args.queue_delay_ms,
        min_events=args.min_events, routing=args.routing,
        platform=args.platform, log_dir=args.log_dir,
        startup_timeout_s=args.startup_timeout,
        overhead_guard=args.overhead_guard,
        overhead_users=args.overhead_users,
        overhead_duration_s=args.overhead_duration))
    print(json.dumps(record, indent=2))
    output = args.output or \
        f"FIREDRILL_{time.strftime('%Y%m%d_%H%M%S')}.json"
    report_mod.write_json(output, record)
    violations = firedrill_violations(
        record, max_overhead_ratio=(args.max_overhead_ratio
                                    if args.overhead_guard else None))
    for v in violations:
        print(f"FIREDRILL VIOLATION: {v}", file=sys.stderr)
    if not violations:
        d = record["detail"]
        # a real-engine drill may have dropped every /fault-driven
        # scenario: the baseline false-positive gate alone still passes
        detect = [s["detected_in_s"] for s in d["scenarios"]
                  if s["detected_in_s"] is not None]
        scen_msg = (f"{d['detected']}/{len(d['scenarios'])} scenarios "
                    f"detected (worst {max(detect):.1f}s vs "
                    f"{d['detect_timeout_s']:.0f}s bound) and "
                    f"resolved, zero false fires"
                    if detect else "no scenarios run (baseline "
                                   "false-positive gate only)")
        msg = (f"firedrill PASSED: baseline clean "
               f"({d['baseline']['storm']['ok']} ok, 0 alerts), "
               + scen_msg)
        guard = d.get("overhead_guard")
        if guard:
            msg += (f"; SLO-on overhead {guard['overhead_ratio']:.2f}x "
                    f"vs direct")
        print(msg)
    return 1 if violations else 0


def cmd_incident(args) -> int:
    scenarios = None
    if args.scenarios:
        scenarios = [s.strip() for s in args.scenarios.split(",")
                     if s.strip()]
    record = asyncio.run(run_incident(
        engines=args.engines, routers=args.routers, engine=args.engine,
        users=args.users, baseline_s=args.baseline,
        window_scale=args.window_scale, scenarios=scenarios,
        detect_timeout_s=args.detect_timeout,
        resolve_timeout_s=args.resolve_timeout,
        num_tokens=args.num_tokens,
        fake_tokens_per_s=args.fake_tokens_per_s,
        slow_ttft_arg_s=args.slow_ttft_arg,
        ttft_threshold_s=args.ttft_threshold,
        max_inflight=args.max_inflight,
        burst_users=args.burst_users,
        min_events=args.min_events, routing=args.routing,
        platform=args.platform, log_dir=args.log_dir,
        incident_dir=args.incident_dir,
        poll_interval_s=args.poll_interval,
        capture_cooldown_s=args.capture_cooldown,
        startup_timeout_s=args.startup_timeout,
        overhead_guard=args.overhead_guard,
        overhead_users=args.overhead_users,
        overhead_duration_s=args.overhead_duration))
    print(json.dumps(record, indent=2))
    output = args.output or \
        f"INCIDENT_{time.strftime('%Y%m%d_%H%M%S')}.json"
    report_mod.write_json(output, record)
    violations = incident_violations(
        record, max_overhead_ratio=(args.max_overhead_ratio
                                    if args.overhead_guard else None),
        min_chain_fraction=args.min_chain_fraction)
    for v in violations:
        print(f"INCIDENT VIOLATION: {v}", file=sys.stderr)
    if not violations:
        d = record["detail"]
        stitch = d["baseline"]["stitch"]
        msg = (f"incident drill PASSED: baseline clean "
               f"({d['baseline']['storm']['ok']} ok, 0 bundles, "
               f"{stitch.get('chains_complete', 0)} chains stitched "
               f"at {stitch.get('complete_fraction', 0):.0%}), "
               f"{len(d['scenarios'])}/{len(d['scenarios'])} faults "
               f"detected+captured+attributed")
        guard = d.get("overhead_guard")
        if guard:
            msg += (f"; scraped overhead {guard['overhead_ratio']:.2f}x"
                    f" vs unscraped {guard['baseline_ratio']:.2f}x "
                    f"(best of {guard['rounds']} alternating rounds)")
        print(msg)
    return 1 if violations else 0


def cmd_fleetdrill(args) -> int:
    scenarios = None
    if args.scenarios:
        scenarios = [s.strip() for s in args.scenarios.split(",")
                     if s.strip()]
    record = asyncio.run(run_fleetdrill(
        scenarios=scenarios, window_scale=args.window_scale,
        users=args.users, engines=args.engines,
        baseline_s=args.baseline,
        detect_timeout_s=args.detect_timeout,
        resolve_timeout_s=args.resolve_timeout,
        burn_ttft_s=args.burn_ttft,
        queue_ramp_ms_per_s=args.queue_ramp,
        queue_plateau_ms=args.queue_plateau,
        max_replicas=args.max_replicas,
        slow_ttft_arg_s=args.slow_ttft_arg,
        tick_interval_s=args.tick_interval,
        min_events=args.min_events, platform=args.platform,
        log_dir=args.log_dir,
        startup_timeout_s=args.startup_timeout))
    print(json.dumps(record, indent=2))
    output = args.output or \
        f"FLEETDRILL_{time.strftime('%Y%m%d_%H%M%S')}.json"
    report_mod.write_json(output, record)
    violations = fleetdrill_violations(record)
    for v in violations:
        print(f"FLEETDRILL VIOLATION: {v}", file=sys.stderr)
    if not violations:
        d = record["detail"]
        parts = []
        burn = d.get("burn")
        if burn:
            parts.append(
                f"burn-rate scale-up saved "
                f"{burn['replica_seconds_saved']} replica-seconds vs "
                f"the queue-delay control (pilot fired "
                f"{burn['pilot']['fired_in_s']}s vs control "
                f"{burn['control']['fired_in_s']}s)")
        rem = d.get("remediate")
        if rem:
            parts.append(
                f"slow engine drained+restarted hands-off in "
                f"{rem['duration_s']}s (1 remediation, outcome "
                f"resolved)")
        if d.get("killswitch"):
            parts.append("kill-switch verifiably suppressed the "
                         "remediation while the alert kept burning")
        print("fleetdrill PASSED: " + "; ".join(parts))
    return 1 if violations else 0


def cmd_trace(args) -> int:
    record = asyncio.run(run_trace(
        engines=args.engines, engine=args.engine, disagg=args.disagg,
        prefill_engines=args.prefill_engines,
        decode_engines=args.decode_engines,
        chat_users=args.chat_users, rag_users=args.rag_users,
        duration_s=args.duration,
        chat_prompt_chars=args.chat_prompt_chars,
        chat_tokens=args.chat_tokens,
        rag_prompt_chars=args.rag_prompt_chars,
        rag_tokens=args.rag_tokens,
        tokens_per_s=args.fake_tokens_per_s,
        prefill_ms_per_char=args.prefill_ms_per_char,
        interference=args.interference,
        kv_chunk_chars=args.kv_chunk_chars,
        headstart_s=args.headstart,
        min_prompt_chars=args.min_prompt_chars,
        routing=args.routing, seed=args.seed,
        ring_entries=args.ring_entries,
        platform=args.platform, log_dir=args.log_dir,
        startup_timeout_s=args.startup_timeout,
        overhead_guard=args.overhead_guard,
        overhead_users=args.overhead_users,
        overhead_duration_s=args.overhead_duration))
    print(json.dumps(record, indent=2))
    output = args.output or f"TRACE_{time.strftime('%Y%m%d_%H%M%S')}.json"
    report_mod.write_json(output, record)
    violations = trace_violations(
        record, min_chain_fraction=args.min_chain_fraction,
        max_unattributed_pct=args.max_unattributed,
        max_overhead_ratio=(args.max_overhead_ratio
                            if args.overhead_guard else None))
    for v in violations:
        print(f"TRACE VIOLATION: {v}", file=sys.stderr)
    if not violations:
        d = record["detail"]
        j = d["join"]
        msg = (f"trace PASSED: {record['value']}% complete span chains "
               f"({j['complete_chains']}/{j['sampled']} sampled, "
               f"{d['topology']}), unattributed time p50 "
               f"{j['unattributed_p50_pct']}%")
        guard = d.get("overhead_guard")
        if guard:
            msg += (f"; tracing-on overhead "
                    f"{guard['overhead_ratio']:.2f}x vs direct")
        print(msg)
    return 1 if violations else 0


def cmd_multirouter(args) -> int:
    record = asyncio.run(run_multirouter(
        engines=args.engines, routers=args.routers, engine=args.engine,
        sessions=args.sessions, phase_duration_s=args.phase_duration,
        num_tokens=args.num_tokens,
        tokens_per_s=args.fake_tokens_per_s,
        gossip_interval_s=args.gossip_interval,
        settle_s=args.settle, blip_window_s=args.blip_window,
        max_inflight=args.max_inflight,
        tier0_users=args.tier0_users, tier1_users=args.tier1_users,
        tier2_users=args.tier2_users,
        saturation_presat_s=args.presat_duration,
        routing=args.routing,
        shared_state=not args.no_shared_state, seed=args.seed,
        platform=args.platform, log_dir=args.log_dir,
        startup_timeout_s=args.startup_timeout,
        skip_saturation=args.skip_saturation,
        skip_kill=args.skip_kill,
        overhead_guard=args.overhead_guard,
        overhead_users=args.overhead_users,
        overhead_duration_s=args.overhead_duration))
    print(json.dumps(record, indent=2))
    output = args.output or \
        f"MULTIROUTER_{time.strftime('%Y%m%d_%H%M%S')}.json"
    report_mod.write_json(output, record)
    violations = multirouter_violations(
        record, affinity_tolerance=args.affinity_tolerance,
        convergence_bound_s=args.convergence_bound or None,
        min_tier0_hold=args.min_tier0_hold,
        min_tier2_shed=args.min_tier2_shed,
        max_overhead_ratio=(args.max_overhead_ratio
                            if args.overhead_guard else None))
    for v in violations:
        print(f"MULTIROUTER VIOLATION: {v}", file=sys.stderr)
    if not violations:
        d = record["detail"]
        conv = d.get("breaker_convergence") or {}
        kill = d.get("router_kill") or {}
        sat = d.get("saturation") or {}
        sat0 = (sat.get("saturated") or {}).get("tier0") or {}
        sat2 = (sat.get("saturated") or {}).get("tier2") or {}
        msg = (f"multirouter PASSED: pair affinity {record['value']}% "
               f"vs control "
               f"{100 * d['control']['affinity_hit_rate']:.1f}%, "
               f"breaker open spread {conv.get('open_spread_s')}s")
        if kill:
            msg += (f", router kill blip {kill.get('blip_errors')} "
                    f"errors / 0 outside, "
                    f"{kill.get('post_restart_ok')} ok post-restart")
        if sat:
            msg += (f", tier0 {sat0.get('goodput_qps')} qps held while "
                    f"tier2 shed {sat2.get('shed_fraction', 0):.0%}")
        guard = d.get("overhead_guard")
        if guard:
            msg += (f"; shared-state overhead "
                    f"{guard['overhead_ratio']:.2f}x vs baseline "
                    f"{guard['baseline_ratio']:.2f}x")
        print(msg)
    return 1 if violations else 0


def cmd_multitenant(args) -> int:
    record = asyncio.run(run_multitenant(
        baseline_s=args.baseline_duration,
        churn_s=args.churn_duration,
        noisy_s=args.noisy_duration,
        surge_s=args.surge_duration,
        adapter_cycles=args.adapter_cycles,
        initial_a=args.pool_a_replicas, initial_b=args.pool_b_replicas,
        max_a=args.pool_a_max, max_b=args.pool_b_max,
        fake_capacity=args.fake_capacity,
        num_tokens=args.num_tokens,
        tenant_rate=args.tenant_rate,
        tenant_buckets=not args.no_tenant_buckets,
        max_inflight=args.max_inflight,
        noisy_workers=args.noisy_workers,
        tick_interval_s=args.tick_interval,
        platform=args.platform, log_dir=args.log_dir,
        startup_timeout_s=args.startup_timeout))
    print(json.dumps(record, indent=2))
    output = args.output or \
        f"TENANT_{time.strftime('%Y%m%d_%H%M%S')}.json"
    report_mod.write_json(output, record)
    violations = multitenant_violations(
        record, interference_floor=args.interference_floor,
        min_noisy_shed=args.min_noisy_shed,
        peer_floor=args.peer_floor)
    for v in violations:
        print(f"MULTITENANT VIOLATION: {v}", file=sys.stderr)
    if not violations:
        d = record["detail"]
        noisy = d["noisy"]
        routing = d["routing"]
        print(f"multitenant PASSED: {routing['ok_checked']} responses "
              f"100% model-correct across "
              f"{len(d['pools'])} pools, pool-b held "
              f"{record['value']}% of baseline through pool-a "
              f"churn+kill, acme shed "
              f"{noisy['acme_shed_fraction']:.0%} while peers held, "
              f"pools scaled: "
              f"{', '.join(d['autoscaling']['pools_scaled_up'])} "
              f"({d['autoscaling']['budget_deferrals']} budget "
              f"deferrals)")
    return 1 if violations else 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "python -m production_stack_tpu_torch.loadgen",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, base_url=True):
        if base_url:
            sp.add_argument("--base-url", required=True,
                            help="router (or engine) URL")
            sp.add_argument("--api-key", default=None)
        sp.add_argument("--workload", default="chat",
                        help="preset: chat | mixed | scaleout | ref-ramp")
        sp.add_argument("--spec", default=None,
                        help="WorkloadSpec JSON file (overrides "
                             "--workload)")
        sp.add_argument("--model", default=None,
                        help="override the spec's model id")
        sp.add_argument("--seed", type=int, default=None)
        sp.add_argument("--users", type=int, default=None,
                        help="override closed-loop user count")
        sp.add_argument("--output", default=None,
                        help="write the JSON report here")
        sp.add_argument("--checkpoint-interval", type=float, default=30.0)

    sp = sub.add_parser("run", help="one workload against a running stack")
    common(sp)
    sp.add_argument("--duration", type=parse_duration, default=None)
    sp.add_argument("--max-sessions", type=int, default=None)
    sp.add_argument("--record-trace", default=None,
                    help="dump this run's per-request schedule as a "
                         "replayable *.trace.jsonl (measured arrival "
                         "offsets + planned shapes)")
    sp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("soak", help="duration-bounded invariant-checked "
                                     "mixed-traffic run")
    common(sp)
    sp.add_argument("--duration", type=parse_duration, default=None,
                    help="e.g. 120s, 30m, 4.4h (default: the spec's "
                         "duration_s, else 120s)")
    sp.add_argument("--abort-fraction", type=float, default=0.02,
                    help="fraction of streams disconnected mid-flight "
                         "(invariant I5)")
    sp.add_argument("--p99-ttft-bound", type=float, default=None,
                    help="seconds; invariant I4 when set")
    sp.add_argument("--checkpoint-file", default=None,
                    help="append checkpoint JSON lines here")
    sp.add_argument("--record-trace", default=None,
                    help="dump this run's per-request schedule as a "
                         "replayable *.trace.jsonl")
    # the soak's whole point is mixed traffic
    sp.set_defaults(fn=cmd_soak, workload="mixed")

    sp = sub.add_parser(
        "distload",
        help="coordinator/worker sharded loadgen closed loop: "
             "N-worker merged percentiles must match the 1-worker "
             "control, trace replay must be deterministic, and the "
             "composed routers/pools/obsplane capstone must stitch "
             "complete chains with zero 5xx")
    distload_cli_args(sp)
    sp.set_defaults(fn=cmd_distload)

    sp = sub.add_parser("scaleout",
                        help="launch router+N engines, measure the "
                             "tokens/s-vs-replicas curve")
    common(sp, base_url=False)
    sp.add_argument("--replicas", default="1,2,4",
                    help="comma-separated replica counts")
    sp.add_argument("--engine", default="debug-tiny",
                    help="engine model name, or 'fake' for the mock")
    sp.add_argument("--routing", default="session",
                    choices=["roundrobin", "session", "least_loaded",
                             "prefix"])
    sp.add_argument("--duration", type=parse_duration, default=60.0,
                    help="measured window per replica point")
    sp.add_argument("--users-per-replica", type=int, default=None)
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                    help="--device of the engine processes")
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--startup-timeout", type=float, default=420.0)
    # the scaleout preset is sized to the engine geometry the
    # orchestrator launches (max-model-len 1024)
    sp.set_defaults(fn=cmd_scaleout, workload="scaleout")

    sp = sub.add_parser("overhead",
                        help="router-vs-direct A/B: launch one engine "
                             "+ the router, storm both URLs, report "
                             "the overhead ratio")
    sp.add_argument("--engine", default="fake",
                    help="'fake' (zero-think mock — measures the "
                         "router, not the model) or a real engine "
                         "model name")
    sp.add_argument("--users", type=int, default=64,
                    help="closed-loop concurrency per side")
    sp.add_argument("--duration", type=parse_duration, default=15.0,
                    help="measured window per side (e.g. 15s)")
    sp.add_argument("--num-tokens", type=int, default=8,
                    help="response length the engine generates")
    sp.add_argument("--stream", action="store_true",
                    help="streaming responses (exercises the chunk "
                         "relay loop; TTFT percentiles reported)")
    sp.add_argument("--routing", default="roundrobin",
                    choices=["roundrobin", "session", "least_loaded",
                             "prefix"])
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--startup-timeout", type=float, default=420.0)
    sp.add_argument("--snapshot-ttl", type=float, default=None,
                    help="router --request-stats-snapshot-ttl override "
                         "(seconds; 0 disables snapshot caching)")
    sp.add_argument("--unique-prompts", action="store_true",
                    help="per-request unique long prompts — the "
                         "cold-prefix worst case for cache-aware "
                         "routing (the r11 no-regression guard pairs "
                         "this with --routing prefix)")
    sp.add_argument("--prompt-chars", type=int, default=768,
                    help="unique-prompt length in chars")
    sp.add_argument("--max-ratio", type=float, default=None,
                    help="exit 1 if the overhead ratio exceeds this "
                         "band (e.g. 2.5 = the r7 band)")
    sp.add_argument("--output", default=None,
                    help="write the JSON report here "
                         "(e.g. ROUTER_OVERHEAD_r07.json)")
    sp.set_defaults(fn=cmd_overhead)

    sp = sub.add_parser("chaos",
                        help="router + N engines with scheduled engine "
                             "kills/restarts; assert zero client-"
                             "visible 5xx for pre-stream failures")
    sp.add_argument("--engines", type=int, default=3,
                    help="engine replica count behind the router")
    sp.add_argument("--engine", default="fake",
                    help="'fake' (chaos measures the router, not the "
                         "model) or a real engine model name")
    sp.add_argument("--users", type=int, default=16,
                    help="closed-loop storm concurrency")
    sp.add_argument("--duration", type=parse_duration, default=60.0)
    sp.add_argument("--kill-interval", type=parse_duration, default=10.0,
                    help="seconds between engine SIGKILLs")
    sp.add_argument("--downtime", type=parse_duration, default=3.0,
                    help="seconds a killed engine stays down")
    sp.add_argument("--error-burst-interval", type=parse_duration,
                    default=7.0,
                    help="seconds between injected backend-500 bursts "
                         "(fake engines only; 0 disables)")
    sp.add_argument("--error-burst", type=int, default=5,
                    help="500s per injected burst")
    sp.add_argument("--stream-fraction", type=float, default=0.3,
                    help="fraction of requests using SSE streaming")
    sp.add_argument("--num-tokens", type=int, default=16)
    sp.add_argument("--routing", default="session",
                    choices=["roundrobin", "session", "least_loaded",
                             "prefix"])
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--p99-bound", type=parse_duration, default=None,
                    help="seconds; fail the run if p99 latency under "
                         "churn exceeds this")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--startup-timeout", type=float, default=420.0)
    sp.add_argument("--cache-server-kill", action="store_true",
                    help="also launch a shared TPKV cache server wired "
                         "into the (fake) engines as their remote KV "
                         "tier and SIGKILL/restart it on its own "
                         "schedule — a dead cache server must cost "
                         "recompute, never a client-visible error")
    sp.add_argument("--cache-kill-interval", type=parse_duration,
                    default=7.0,
                    help="seconds between cache-server SIGKILLs")
    sp.add_argument("--cache-downtime", type=parse_duration, default=2.0,
                    help="seconds the cache server stays down")
    sp.add_argument("--router-kill", action="store_true",
                    help="launch --router-replicas peered routers "
                         "behind an in-process L4 splitter and "
                         "SIGKILL/restart router replicas on their "
                         "own schedule — client errors are then "
                         "allowed only inside each kill's blip window")
    sp.add_argument("--router-replicas", type=int, default=2,
                    help="router replica count with --router-kill")
    sp.add_argument("--router-kill-interval", type=parse_duration,
                    default=15.0,
                    help="seconds between router SIGKILLs")
    sp.add_argument("--router-downtime", type=parse_duration,
                    default=2.0,
                    help="seconds a killed router stays down")
    sp.add_argument("--router-blip-window", type=parse_duration,
                    default=4.0,
                    help="seconds after each router kill during which "
                         "in-flight client errors are tolerated "
                         "(counted, reported)")
    sp.add_argument("--output", default=None,
                    help="write CHAOS_*.json here (default: "
                         "timestamped)")
    sp.set_defaults(fn=cmd_chaos)

    sp = sub.add_parser("overload",
                        help="router + N protected engines; sweep "
                             "open-loop offered QPS past saturation "
                             "and assert goodput plateaus")
    sp.add_argument("--engines", type=int, default=2,
                    help="engine replica count behind the router")
    sp.add_argument("--engine", default="fake",
                    help="'fake' (overload fault mode = bounded queue) "
                         "or a real engine model name (launched with "
                         "--max-waiting-seqs/--max-queue-delay-ms)")
    sp.add_argument("--qps", default="2,4,8,16",
                    help="comma-separated offered-QPS sweep (open "
                         "loop; the top rates should be well past "
                         "saturation)")
    sp.add_argument("--duration", type=parse_duration, default=15.0,
                    help="measured window per point")
    sp.add_argument("--deadline-ms", type=float, default=8000.0,
                    help="x-request-deadline-ms each request carries")
    sp.add_argument("--num-tokens", type=int, default=8)
    sp.add_argument("--fake-capacity", type=int, default=4,
                    help="fake engines: bounded-queue capacity")
    sp.add_argument("--fake-tokens-per-s", type=float, default=50.0,
                    help="fake engines: service pacing")
    sp.add_argument("--unprotected", action="store_true",
                    help="launch engines WITHOUT protection flags — "
                         "the collapse baseline (no contract "
                         "enforced, exit 0)")
    sp.add_argument("--plateau-tolerance", type=float, default=0.10,
                    help="goodput past the knee may dip this fraction "
                         "under the peak")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--startup-timeout", type=float, default=420.0)
    sp.add_argument("--output", default=None,
                    help="write OVERLOAD_*.json here (default: "
                         "timestamped)")
    sp.set_defaults(fn=cmd_overload)

    sp = sub.add_parser("effwatch",
                        help="one engine; audit the efficiency "
                             "accounting (token-step fractions, "
                             "accounted-vs-client decode tokens/s, "
                             "steady-window compile silence) around "
                             "a real storm")
    sp.add_argument("--engine", default="debug-tiny",
                    help="engine model name (real process) or 'fake' "
                         "(synthetic perf block — the engine-free "
                         "smoke)")
    sp.add_argument("--users", type=int, default=6,
                    help="closed-loop concurrent streaming clients")
    sp.add_argument("--duration", type=parse_duration, default=20.0,
                    help="steady measured window")
    sp.add_argument("--warmup", type=parse_duration, default=8.0,
                    help="warmup storm ahead of the measured window "
                         "(same shape, so every executable is "
                         "compiled before the steady scrape)")
    sp.add_argument("--num-tokens", type=int, default=32)
    sp.add_argument("--sum-tolerance", type=float, default=0.02,
                    help="allowed |1 - (real+pad+dead)/total|")
    sp.add_argument("--rate-tolerance", type=float, default=0.10,
                    help="allowed relative gap between accounted and "
                         "client-measured decode tokens")
    sp.add_argument("--anti-vacuity", action="store_true",
                    help="mis-size the accounting window (scrape "
                         "before the warmup storm): the "
                         "reconciliation gate MUST fail; exit 0 iff "
                         "it does")
    sp.add_argument("--ab", action="store_true",
                    help="same-storm A/B: window adaptation on vs "
                         "--no-window-adapt control (fresh engine per "
                         "side); gates on per-side accounting PLUS "
                         "adapt live fraction >= --live-floor and "
                         "accounted tokens/s >= (1 + --improve-floor) "
                         "x control")
    sp.add_argument("--no-window-adapt", action="store_true",
                    help="single run with adaptation disabled (the "
                         "control side by itself)")
    sp.add_argument("--live-floor", type=float, default=0.80,
                    help="A/B: minimum adapt-side whole-window live "
                         "fraction")
    sp.add_argument("--improve-floor", type=float, default=0.20,
                    help="A/B: minimum relative accounted-tokens/s "
                         "improvement over the control")
    sp.add_argument("--stagger", type=float, default=0.0,
                    help="seconds between successive workers' first "
                         "requests (staggered arrivals — the churny "
                         "storm shape)")
    sp.add_argument("--mixed-tokens", default=None,
                    help="comma-separated max_tokens cycled per "
                         "request, offset by worker (mixed short/long "
                         "outputs), e.g. 8,48; overrides --num-tokens "
                         "for the storm bodies")
    sp.add_argument("--engine-args", default=None,
                    help="extra engine CLI flags appended to the "
                         "launch (space-separated; real engines only) "
                         "— geometry overrides for the A/B, e.g. "
                         "'--max-num-seqs 16'")
    sp.add_argument("--prompt-chars", type=int, default=0,
                    help="pad storm prompts to this many characters "
                         "(longer live context — the per-row KV read "
                         "dominates fixed dispatch overhead)")
    sp.add_argument("--rounds", type=int, default=1,
                    help="A/B rounds in alternating ABBA order; gates "
                         "read per-side aggregates across rounds "
                         "(single-host noise control)")
    sp.add_argument("--fake-pad-fraction", type=float, default=0.3,
                    help="fake engine: synthetic padding fraction")
    sp.add_argument("--fake-dead-fraction", type=float, default=0.1,
                    help="fake engine: synthetic dead fraction")
    sp.add_argument("--fake-skew", type=float, default=0.0,
                    help="fake engine: inflate the independent "
                         "token_steps_total by this fraction (breaks "
                         "the sum-to-1 gate on purpose)")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--startup-timeout", type=float, default=420.0)
    sp.add_argument("--output", default=None,
                    help="write EFF_*.json here (default: "
                         "timestamped)")
    sp.set_defaults(fn=cmd_effwatch)

    sp = sub.add_parser("autoscale",
                        help="router + autoscaler-owned engines; drive "
                             "a QPS ramp up then down and assert "
                             "replicas track it with zero "
                             "client-visible 5xx")
    sp.add_argument("--engine", default="fake",
                    help="'fake' (bounded mock — measures the control "
                         "loop, not the model) or a real engine model "
                         "name (launched with protection flags)")
    sp.add_argument("--qps", default="4,12,24,12,4",
                    help="comma-separated offered-QPS phases, shaped "
                         "up then down")
    sp.add_argument("--phase-duration", type=parse_duration,
                    default=15.0, help="seconds per ramp phase")
    sp.add_argument("--min-replicas", type=int, default=1)
    sp.add_argument("--max-replicas", type=int, default=3)
    sp.add_argument("--deadline-ms", type=float, default=8000.0)
    sp.add_argument("--num-tokens", type=int, default=4)
    sp.add_argument("--fake-capacity", type=int, default=4,
                    help="fake engines: bounded-queue capacity "
                         "(advertised; drives utilization)")
    sp.add_argument("--fake-tokens-per-s", type=float, default=10.0,
                    help="fake engines: service pacing")
    sp.add_argument("--tick-interval", type=float, default=1.0,
                    help="autoscaler control-tick seconds")
    sp.add_argument("--target-utilization", type=float, default=0.85)
    sp.add_argument("--down-utilization", type=float, default=0.45)
    sp.add_argument("--target-queue-delay-ms", type=float,
                    default=500.0)
    sp.add_argument("--down-queue-delay-ms", type=float, default=100.0)
    sp.add_argument("--up-cooldown", type=float, default=4.0)
    sp.add_argument("--down-cooldown", type=float, default=8.0)
    sp.add_argument("--drain-timeout", type=float, default=30.0,
                    help="seconds a scale-down waits for the victim's "
                         "in-flight work before proceeding")
    sp.add_argument("--compare-fixed", type=int, default=1,
                    help="also measure the same ramp with this many "
                         "FIXED replicas as the baseline (0 skips)")
    sp.add_argument("--track-fraction", type=float, default=0.7,
                    help="peak-phase goodput must reach this fraction "
                         "of offered QPS")
    sp.add_argument("--compare-margin", type=float, default=1.3,
                    help="autoscale peak goodput must beat the fixed "
                         "baseline by this factor")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--startup-timeout", type=float, default=420.0)
    sp.add_argument("--output", default=None,
                    help="write AUTOSCALE_*.json here (default: "
                         "timestamped)")
    sp.set_defaults(fn=cmd_autoscale)

    sp = sub.add_parser("kvshare",
                        help="shared cache server + N engines + router "
                             "with affinity broken; multi-round QA "
                             "must show >60%% cross-replica hit rate "
                             "and TTFT beating recompute")
    sp.add_argument("--engines", type=int, default=2,
                    help="engine replica count behind the router")
    sp.add_argument("--engine", default="fake",
                    help="'fake' (KV simulation against a real cache "
                         "server — measures the sharing data path) or "
                         "a real engine model name (launched with "
                         "--kv-transfer-config; TTFT then includes "
                         "real prefill compute)")
    sp.add_argument("--sessions", type=int, default=4,
                    help="concurrent multi-round QA sessions")
    sp.add_argument("--rounds", type=int, default=6,
                    help="rounds per session (round 1 is cold)")
    sp.add_argument("--system-chars", type=int, default=384,
                    help="per-session system prompt length")
    sp.add_argument("--round-chars", type=int, default=160,
                    help="new user content per round")
    sp.add_argument("--num-tokens", type=int, default=8)
    sp.add_argument("--prefill-ms-per-char", type=float, default=0.5,
                    help="fake engines: TTFT pacing per uncached char")
    sp.add_argument("--kv-chunk-chars", type=int, default=64,
                    help="fake engines: chunk granularity (chars)")
    sp.add_argument("--routing", default="session",
                    choices=["roundrobin", "session", "least_loaded",
                             "prefix"],
                    help="affinity is broken by ROTATING the session "
                         "key every round; 'session' (default) then "
                         "scatters rounds deterministically across "
                         "replicas")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--no-cache", action="store_true",
                    help="launch the fleet WITHOUT the cache tier: the "
                         "contract must then fail (exit 1) — the "
                         "anti-vacuity check")
    sp.add_argument("--min-hit-rate", type=float, default=0.6,
                    help="cross-replica hit-rate bar")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--startup-timeout", type=float, default=420.0)
    sp.add_argument("--output", default=None,
                    help="write KVSHARE_*.json here (default: "
                         "timestamped)")
    sp.set_defaults(fn=cmd_kvshare)

    sp = sub.add_parser(
        "kvmigrate",
        help="kvplane closed loop: fragmentation storm with/without "
             "the migration planner (engine-census failure rate must "
             "collapse only when migration is ON, at constant "
             "aggregate blocks) + raw-vs-int4 codec capacity re-run "
             "of the kvshare storm")
    sp.add_argument("--storm-duration", type=parse_duration,
                    default=8.0,
                    help="per-phase storm length; gates read the "
                         "second half, so the planner gets the first "
                         "half to react")
    sp.add_argument("--storm-workers", type=int, default=4,
                    help="closed-loop chat workers through the router")
    sp.add_argument("--poll-interval", type=float, default=0.3,
                    help="planner census poll interval (s)")
    sp.add_argument("--codec", default="int4",
                    choices=["int8", "int4", "fp8"],
                    help="compressed tier codec for the capacity "
                         "phase (the >=2x gate wants int4)")
    sp.add_argument("--sessions", type=int, default=4,
                    help="codec phase: concurrent QA sessions")
    sp.add_argument("--rounds", type=int, default=6,
                    help="codec phase: rounds per session (round 1 "
                         "is cold)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--max-on-failure-rate", type=float, default=0.02,
                    help="migration ON second-half fragmented-failure "
                         "rate ceiling")
    sp.add_argument("--min-off-failure-rate", type=float, default=0.2,
                    help="anti-vacuity: migration OFF second-half "
                         "failure rate floor")
    sp.add_argument("--min-capacity-ratio", type=float, default=2.0,
                    help="compressed tier logical/physical bytes "
                         "floor")
    sp.add_argument("--ttft-tolerance", type=float, default=0.25,
                    help="compressed hit TTFT may exceed raw by at "
                         "most this fraction")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--startup-timeout", type=float, default=420.0)
    sp.add_argument("--output", default=None,
                    help="write KVMIGRATE_*.json here (default: "
                         "timestamped)")
    sp.set_defaults(fn=cmd_kvmigrate)

    sp = sub.add_parser("disagg",
                        help="P/D split (prefill pool + decode pool + "
                             "shared cache) vs aggregated serving at "
                             "equal engine count; mixed storm with a "
                             "prefill-pod SIGKILL must show chat ITL "
                             "p99 improving with zero errors")
    sp.add_argument("--prefill-engines", type=int, default=2,
                    help="kv_producer pool size")
    sp.add_argument("--decode-engines", type=int, default=2,
                    help="kv_consumer pool size (the aggregated "
                         "baseline runs prefill+decode engines total)")
    sp.add_argument("--engine", default="fake",
                    help="'fake' (role simulation over the real TPKV "
                         "tier protocol — measures router "
                         "orchestration + transfer path) or a real "
                         "engine model name (--kv-transfer-config "
                         "roles)")
    sp.add_argument("--chat-users", type=int, default=8,
                    help="closed-loop short-prompt/long-decode users "
                         "(the ITL-gated class)")
    sp.add_argument("--rag-users", type=int, default=4,
                    help="closed-loop long-prefill/short-decode users "
                         "(the head-of-line blockers)")
    sp.add_argument("--duration", type=parse_duration, default=30.0,
                    help="measured window per phase (p99 gates want "
                         ">=30s of samples)")
    sp.add_argument("--chat-prompt-chars", type=int, default=96)
    sp.add_argument("--chat-tokens", type=int, default=24)
    sp.add_argument("--rag-prompt-chars", type=int, default=2400)
    sp.add_argument("--rag-tokens", type=int, default=4)
    sp.add_argument("--fake-tokens-per-s", type=float, default=40.0,
                    help="fake engines: decode pacing")
    sp.add_argument("--prefill-ms-per-char", type=float, default=0.4,
                    help="fake engines: prefill pacing per uncached "
                         "char")
    sp.add_argument("--interference", type=float, default=1.5,
                    help="fake engines: decode ticks stretch by "
                         "(1 + this * concurrently-prefilling "
                         "requests) — the contention the split "
                         "removes")
    sp.add_argument("--kv-chunk-chars", type=int, default=64,
                    help="fake engines: chunk granularity (chars)")
    sp.add_argument("--headstart", type=float, default=3.0,
                    help="router --prefill-headstart (should cover one "
                         "long prefill so decode finds the prefix "
                         "published)")
    sp.add_argument("--min-prompt-chars", type=int, default=512,
                    help="router --disagg-min-prompt-chars: chat "
                         "prompts below this skip the prefill stage")
    sp.add_argument("--routing", default="least_loaded",
                    choices=["roundrobin", "session", "least_loaded",
                             "prefix"])
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--no-split", action="store_true",
                    help="run BOTH phases aggregated: the ITL gate "
                         "must then fail (exit 1) — the anti-vacuity "
                         "check")
    sp.add_argument("--no-prefill-kill", action="store_true",
                    help="skip the mid-run prefill-pod SIGKILL")
    sp.add_argument("--kill-downtime", type=parse_duration, default=3.0,
                    help="seconds the killed prefill pod stays down")
    sp.add_argument("--min-itl-improvement", type=float, default=0.1,
                    help="chat ITL p99 must improve split-vs-"
                         "aggregated by this fraction; negative "
                         "disables the ITL gate (real debug-tiny CPU "
                         "engines are ITL-noise-dominated — the data-"
                         "path gates still apply)")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--startup-timeout", type=float, default=420.0)
    sp.add_argument("--output", default=None,
                    help="write DISAGG_*.json here (default: "
                         "timestamped)")
    sp.set_defaults(fn=cmd_disagg)

    sp = sub.add_parser("firedrill",
                        help="router + N engines with seconds-scale "
                             "SLO windows; clean baseline must fire "
                             "zero alerts, injected faults must each "
                             "fire their expected burn-rate alert and "
                             "resolve after clearing")
    sp.add_argument("--engines", type=int, default=2,
                    help="engine replica count behind the router")
    sp.add_argument("--engine", default="fake",
                    help="'fake' (the /fault control endpoint drives "
                         "most scenarios) or a real engine model name "
                         "(engine_down only)")
    sp.add_argument("--users", type=int, default=8,
                    help="closed-loop storm concurrency (80%% chat, "
                         "20%% x-slo-class: rag)")
    sp.add_argument("--baseline", type=parse_duration, default=10.0,
                    help="clean-phase duration (the false-positive "
                         "gate)")
    sp.add_argument("--window-scale", type=float, default=0.01,
                    help="router --slo-window-scale: multiplies the "
                         "canonical 5m/30m/1h/6h windows (0.01 -> "
                         "3s/18s/36s/216s)")
    sp.add_argument("--scenarios", default=None,
                    help=f"comma-separated subset of "
                         f"{','.join(SCENARIO_NAMES)} "
                         f"(default: all)")
    sp.add_argument("--detect-timeout", type=parse_duration,
                    default=None,
                    help="seconds an expected alert has to reach "
                         "firing (default: sized to the scaled 1h "
                         "window)")
    sp.add_argument("--resolve-timeout", type=parse_duration,
                    default=None,
                    help="seconds alerts have to resolve after the "
                         "fault clears (default: sized to the scaled "
                         "30m window)")
    sp.add_argument("--num-tokens", type=int, default=4)
    sp.add_argument("--fake-tokens-per-s", type=float, default=400.0)
    sp.add_argument("--error-rate", type=float, default=0.5,
                    help="partial 500 fraction for the error_rate "
                         "scenario")
    sp.add_argument("--slow-ttft-arg", type=float, default=0.4,
                    help="seconds of TTFT inflation for slow_ttft")
    sp.add_argument("--ttft-threshold", type=float, default=0.25,
                    help="drill chat_ttft SLO threshold (seconds; "
                         "clean TTFT must sit well under, slow_ttft "
                         "well over)")
    sp.add_argument("--overload-capacity", type=int, default=1,
                    help="per-engine bounded-queue capacity for the "
                         "overload scenario")
    sp.add_argument("--queue-delay-ms", type=float, default=60000.0,
                    help="injected /load queue-delay override for "
                         "queue_delay")
    sp.add_argument("--min-events", type=int, default=4,
                    help="drill SLO volume floor (router "
                         "--slo-min-events equivalent, inside the "
                         "drill config)")
    sp.add_argument("--routing", default="roundrobin",
                    choices=["roundrobin", "session", "least_loaded",
                             "prefix"])
    sp.add_argument("--overhead-guard", action="store_true",
                    help="also re-run the r7 router-overhead A/B "
                         "(SLO accounting is on by default) and embed "
                         "it")
    sp.add_argument("--overhead-users", type=int, default=48)
    sp.add_argument("--overhead-duration", type=parse_duration,
                    default=10.0)
    sp.add_argument("--max-overhead-ratio", type=float, default=2.5,
                    help="exit 1 if the SLO-on overhead ratio exceeds "
                         "this band AND the same-host --no-slo "
                         "baseline by >10%% (the r7 contract, "
                         "host-normalized)")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--startup-timeout", type=float, default=420.0)
    sp.add_argument("--output", default=None,
                    help="write FIREDRILL_*.json here (default: "
                         "timestamped)")
    sp.set_defaults(fn=cmd_firedrill)

    sp = sub.add_parser("incident",
                        help="N peered routers + M engines + the "
                             "obsplane flight recorder: a clean "
                             "baseline captures zero bundles, each "
                             "injected fault fires its alert and "
                             "yields ONE complete bundle whose "
                             "attribution names the culprit process "
                             "and phase")
    sp.add_argument("--engines", type=int, default=3,
                    help="engine replica count behind the routers")
    sp.add_argument("--routers", type=int, default=2,
                    help="peered router replica count (r16 gossip)")
    sp.add_argument("--engine", default="fake",
                    help="'fake' (the /fault endpoint drives "
                         "slow_ttft) or a real engine model name "
                         "(engine_down + shed_storm only)")
    sp.add_argument("--users", type=int, default=8,
                    help="closed-loop storm concurrency, spread "
                         "across the routers (80%% chat, 20%% "
                         "x-slo-class: rag)")
    sp.add_argument("--baseline", type=parse_duration, default=10.0,
                    help="clean-phase duration (the zero-spurious-"
                         "capture gate)")
    sp.add_argument("--window-scale", type=float, default=0.01,
                    help="drill SLO window scale (0.01 -> "
                         "3s/18s/36s/216s)")
    sp.add_argument("--scenarios", default=None,
                    help=f"comma-separated subset of "
                         f"{','.join(INCIDENT_SCENARIOS)} "
                         f"(default: all)")
    sp.add_argument("--detect-timeout", type=parse_duration,
                    default=None,
                    help="seconds the expected alert has to show on "
                         "the obsplane's /fleet view (default: sized "
                         "to the scaled 1h window)")
    sp.add_argument("--resolve-timeout", type=parse_duration,
                    default=None,
                    help="seconds alerts have to resolve after the "
                         "fault clears (default: sized to the scaled "
                         "30m window)")
    sp.add_argument("--num-tokens", type=int, default=4)
    sp.add_argument("--fake-tokens-per-s", type=float, default=400.0)
    sp.add_argument("--slow-ttft-arg", type=float, default=0.4,
                    help="seconds of TTFT inflation injected on ONE "
                         "engine for slow_ttft")
    sp.add_argument("--ttft-threshold", type=float, default=None,
                    help="drill chat_ttft SLO threshold (seconds; "
                         "default 0.25 for the fake fleet, 2.0 for "
                         "real engines — a real prefill would trip "
                         "the fake-calibrated bar on a clean "
                         "baseline)")
    sp.add_argument("--max-inflight", type=int, default=24,
                    help="per-router admission gate: the shed storm "
                         "must blow through it, the baseline storm "
                         "must sit well under it")
    sp.add_argument("--burst-users", type=int, default=64,
                    help="concurrency of the shed-storm burst aimed "
                         "at router 0")
    sp.add_argument("--min-events", type=int, default=4,
                    help="drill SLO volume floor")
    sp.add_argument("--routing", default="roundrobin",
                    choices=["roundrobin", "session", "least_loaded",
                             "prefix"])
    sp.add_argument("--poll-interval", type=float, default=0.3,
                    help="obsplane fleet scrape interval (seconds)")
    sp.add_argument("--capture-cooldown", type=float, default=5.0,
                    help="obsplane capture cooldown (seconds; the "
                         "fleet quiet->burning edge is the primary "
                         "dedup, this is the flap backstop)")
    sp.add_argument("--incident-dir", default=None,
                    help="bundle directory (default: "
                         "<log-dir>/incidents)")
    sp.add_argument("--min-chain-fraction", type=float, default=0.5,
                    help="baseline stitched-chain completeness floor "
                         "(the anti-vacuity gate on the online join)")
    sp.add_argument("--overhead-guard", action="store_true",
                    help="run the r7 A/B with and without the "
                         "obsplane scraping the serving pair, embed "
                         "both")
    sp.add_argument("--overhead-users", type=int, default=48)
    sp.add_argument("--overhead-duration", type=parse_duration,
                    default=10.0)
    sp.add_argument("--max-overhead-ratio", type=float, default=2.5,
                    help="exit 1 if the scraped-side ratio exceeds "
                         "this band AND the same-host unscraped "
                         "baseline by >10%%")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--startup-timeout", type=float, default=420.0)
    sp.add_argument("--output", default=None,
                    help="write INCIDENT_*.json here (default: "
                         "timestamped)")
    sp.set_defaults(fn=cmd_incident)

    sp = sub.add_parser("fleetdrill",
                        help="the r20 fleet pilot closed loop: "
                             "burn-rate scale-up must beat the "
                             "queue-delay-only control on "
                             "replica-seconds to resolution; a slow "
                             "engine must be drained+restarted "
                             "hands-off with exactly one remediation "
                             "logged; the kill-switch run must show "
                             "the suppression AND the alert still "
                             "burning")
    sp.add_argument("--scenarios", default=None,
                    help=f"comma-separated subset of "
                         f"{','.join(FLEETDRILL_SCENARIOS)} "
                         f"(default: all)")
    sp.add_argument("--window-scale", type=float, default=0.01,
                    help="drill SLO window scale (0.01 -> "
                         "3s/18s/36s/216s)")
    sp.add_argument("--users", type=int, default=6,
                    help="closed-loop storm concurrency")
    sp.add_argument("--engines", type=int, default=3,
                    help="fixed fleet size for the remediation "
                         "scenarios (the burn scenario scales 1 -> "
                         "--max-replicas)")
    sp.add_argument("--baseline", type=parse_duration, default=6.0,
                    help="clean-phase duration before each injection")
    sp.add_argument("--detect-timeout", type=parse_duration,
                    default=None,
                    help="seconds the page alert has to fire "
                         "(default: sized to the scaled 1h window)")
    sp.add_argument("--resolve-timeout", type=parse_duration,
                    default=None,
                    help="seconds the alert has to resolve after "
                         "relief (default: sized to the scaled 30m "
                         "window)")
    sp.add_argument("--burn-ttft", type=float, default=0.4,
                    help="burn scenario: injected per-request TTFT at "
                         "1 replica (seconds; divided by the live "
                         "replica count — scale-up IS the relief)")
    sp.add_argument("--queue-ramp", type=float, default=60.0,
                    help="burn scenario: queue-delay ramp (ms per "
                         "second of incident, split across replicas) "
                         "— slow enough that the burn-rate alert "
                         "beats the queue-delay threshold")
    sp.add_argument("--queue-plateau", type=float, default=1200.0,
                    help="burn scenario: queue-delay ramp ceiling "
                         "(ms) so the control's trigger stays "
                         "bounded")
    sp.add_argument("--max-replicas", type=int, default=2,
                    help="burn scenario scale-up ceiling")
    sp.add_argument("--slow-ttft-arg", type=float, default=0.6,
                    help="remediation scenarios: TTFT inflation "
                         "injected on ONE engine (seconds)")
    sp.add_argument("--tick-interval", type=float, default=0.5,
                    help="autoscaler control-loop interval (seconds)")
    sp.add_argument("--min-events", type=int, default=4,
                    help="drill SLO volume floor")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--startup-timeout", type=float, default=420.0)
    sp.add_argument("--output", default=None,
                    help="write FLEETDRILL_*.json here (default: "
                         "timestamped)")
    sp.set_defaults(fn=cmd_fleetdrill)

    sp = sub.add_parser("multirouter",
                        help="N real routers (peer gossip + QoS "
                             "tiers) behind an in-process L4 "
                             "splitter: pair affinity must match the "
                             "single-router control, a router "
                             "SIGKILL must cost only the in-flight "
                             "blip, breakers must converge across "
                             "replicas, and saturation must shed "
                             "low-tier-first")
    sp.add_argument("--engines", type=int, default=3,
                    help="engine replica count behind the routers")
    sp.add_argument("--routers", type=int, default=2,
                    help="router replica count (>= 2)")
    sp.add_argument("--engine", default="fake",
                    help="'fake' (the rig measures the control "
                         "plane, not the model) or a real engine "
                         "model name")
    sp.add_argument("--sessions", type=int, default=12,
                    help="sticky sessions in the affinity storms")
    sp.add_argument("--phase-duration", type=parse_duration,
                    default=20.0, help="seconds per phase")
    sp.add_argument("--num-tokens", type=int, default=8)
    sp.add_argument("--fake-tokens-per-s", type=float, default=60.0,
                    help="fake engines: decode pacing (slow enough "
                         "that router admission is the scarce "
                         "resource in the saturation sweep)")
    sp.add_argument("--gossip-interval", type=float, default=0.25,
                    help="router --peer-gossip-interval")
    sp.add_argument("--settle", type=parse_duration, default=3.0,
                    help="seconds after the one-sided drain before "
                         "the steady affinity window starts")
    sp.add_argument("--blip-window", type=parse_duration, default=3.0,
                    help="seconds after the router kill during which "
                         "in-flight client errors are tolerated")
    sp.add_argument("--max-inflight", type=int, default=8,
                    help="per-router --max-inflight (the saturation "
                         "sweep's scarce resource)")
    sp.add_argument("--tier0-users", type=int, default=4)
    sp.add_argument("--tier1-users", type=int, default=8)
    sp.add_argument("--tier2-users", type=int, default=16,
                    help="background users added for the saturation "
                         "phase")
    sp.add_argument("--presat-duration", type=parse_duration,
                    default=8.0,
                    help="pre-saturation tier0 goodput baseline "
                         "window")
    sp.add_argument("--routing", default="session",
                    choices=["roundrobin", "session", "least_loaded",
                             "prefix"])
    sp.add_argument("--no-shared-state", action="store_true",
                    help="launch the routers WITHOUT the gossip "
                         "plane: the affinity gate must then fail "
                         "(exit 1) — the anti-vacuity check")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--skip-saturation", action="store_true",
                    help="skip the QoS saturation phase")
    sp.add_argument("--skip-kill", action="store_true",
                    help="skip the router-SIGKILL phase")
    sp.add_argument("--affinity-tolerance", type=float, default=0.05,
                    help="pair affinity may trail the control by "
                         "this much")
    sp.add_argument("--convergence-bound", type=float, default=0.0,
                    help="seconds the per-router breaker open reports "
                         "may spread (0 = one probe interval)")
    sp.add_argument("--min-tier0-hold", type=float, default=0.95,
                    help="tier0 saturated goodput as a fraction of "
                         "pre-saturation")
    sp.add_argument("--min-tier2-shed", type=float, default=0.5,
                    help="tier2 shed fraction the sweep must reach")
    sp.add_argument("--overhead-guard", action="store_true",
                    help="also re-run the r7 A/B through a shared-"
                         "state router vs a same-host plain baseline")
    sp.add_argument("--overhead-users", type=int, default=48)
    sp.add_argument("--overhead-duration", type=parse_duration,
                    default=10.0)
    sp.add_argument("--max-overhead-ratio", type=float, default=2.5,
                    help="exit 1 if the shared-state ratio exceeds "
                         "this band AND the same-host baseline by "
                         ">10%% (the r14 convention)")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--startup-timeout", type=float, default=420.0)
    sp.add_argument("--output", default=None,
                    help="write MULTIROUTER_*.json here (default: "
                         "timestamped)")
    sp.set_defaults(fn=cmd_multirouter)

    sp = sub.add_parser("multitenant",
                        help="two named pools (multi-model + runtime "
                             "LoRA adapters) behind one router with "
                             "per-tenant buckets and per-pool "
                             "autoscalers on a shared actuation "
                             "budget: routing must be 100%% model-"
                             "correct, pool-a churn+kill must not "
                             "touch pool-b, the noisy tenant must "
                             "shed while tier peers hold, and both "
                             "pools must log applied scale-ups")
    sp.add_argument("--baseline-duration", type=parse_duration,
                    default=6.0, help="reference-goodput window")
    sp.add_argument("--churn-duration", type=parse_duration,
                    default=14.0,
                    help="pool-a adapter churn + fault + SIGKILL "
                         "window")
    sp.add_argument("--noisy-duration", type=parse_duration,
                    default=8.0, help="noisy-tenant burst window")
    sp.add_argument("--surge-duration", type=parse_duration,
                    default=8.0, help="seconds per surge round (up "
                                      "to 3 rounds until both pools "
                                      "scale)")
    sp.add_argument("--adapter-cycles", type=int, default=2,
                    help="load->route->evict adapter cycles during "
                         "churn")
    sp.add_argument("--pool-a-replicas", type=int, default=2)
    sp.add_argument("--pool-b-replicas", type=int, default=1)
    sp.add_argument("--pool-a-max", type=int, default=3)
    sp.add_argument("--pool-b-max", type=int, default=2)
    sp.add_argument("--fake-capacity", type=int, default=4,
                    help="per-engine bounded admission (the overload "
                         "fault's capacity advertisement)")
    sp.add_argument("--num-tokens", type=int, default=4)
    sp.add_argument("--tenant-rate", type=float, default=5.0,
                    help="router --qos-tenant-rate (req/s per "
                         "x-tenant-id inside each tier)")
    sp.add_argument("--no-tenant-buckets", action="store_true",
                    help="launch the router WITHOUT per-tenant "
                         "buckets: acme's burst then saturates "
                         "pool-b and the peer-goodput gate must "
                         "fail (exit 1) — the anti-vacuity check")
    sp.add_argument("--max-inflight", type=int, default=40,
                    help="router-wide admission gate (QoS tiers "
                         "fraction it)")
    sp.add_argument("--noisy-workers", type=int, default=8,
                    help="closed-loop workers the bursting tenant "
                         "runs")
    sp.add_argument("--tick-interval", type=float, default=0.5,
                    help="autoscaler decision tick (s)")
    sp.add_argument("--interference-floor", type=float, default=0.95,
                    help="pool-b churn-phase goodput as a fraction "
                         "of baseline")
    sp.add_argument("--min-noisy-shed", type=float, default=0.5,
                    help="shed fraction the bursting tenant must "
                         "reach")
    sp.add_argument("--peer-floor", type=float, default=0.95,
                    help="ok-fraction each tier peer must keep "
                         "during the burst")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--startup-timeout", type=float, default=120.0)
    sp.add_argument("--output", default=None,
                    help="write TENANT_*.json here (default: "
                         "timestamped)")
    sp.set_defaults(fn=cmd_multitenant)

    sp = sub.add_parser("trace",
                        help="router + engines (optionally the disagg "
                             "split); storm, then join client "
                             "x-trace-ids against the /debug/traces "
                             "rings — span chains must be complete "
                             "and phases must cover the time")
    sp.add_argument("--engines", type=int, default=2,
                    help="engine count (aggregated topology)")
    sp.add_argument("--engine", default="fake",
                    help="'fake' (deterministic pacing — measures the "
                         "tracing substrate) or a real engine model "
                         "name")
    sp.add_argument("--disagg", action="store_true",
                    help="launch the P/D split (cache server + "
                         "producer pool + consumer pool + "
                         "--prefill-backends) so the chain gate "
                         "covers router->prefill->decode")
    sp.add_argument("--prefill-engines", type=int, default=2)
    sp.add_argument("--decode-engines", type=int, default=2)
    sp.add_argument("--chat-users", type=int, default=6)
    sp.add_argument("--rag-users", type=int, default=3)
    sp.add_argument("--duration", type=parse_duration, default=20.0)
    sp.add_argument("--chat-prompt-chars", type=int, default=96)
    sp.add_argument("--chat-tokens", type=int, default=24)
    sp.add_argument("--rag-prompt-chars", type=int, default=2400)
    sp.add_argument("--rag-tokens", type=int, default=4)
    sp.add_argument("--fake-tokens-per-s", type=float, default=40.0)
    sp.add_argument("--prefill-ms-per-char", type=float, default=0.4)
    sp.add_argument("--interference", type=float, default=1.5)
    sp.add_argument("--kv-chunk-chars", type=int, default=64)
    sp.add_argument("--headstart", type=float, default=3.0)
    sp.add_argument("--min-prompt-chars", type=int, default=512)
    sp.add_argument("--routing", default="least_loaded",
                    choices=["roundrobin", "session", "least_loaded",
                             "prefix"])
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--ring-entries", type=int, default=16384,
                    help="router/engine --trace-ring-entries (must "
                         "hold the storm, or old traces churn out "
                         "before the join reads them)")
    sp.add_argument("--min-chain-fraction", type=float, default=0.95,
                    help="sampled requests that must show a complete "
                         "router->engine span chain")
    sp.add_argument("--max-unattributed", type=float, default=10.0,
                    help="percent of a trace's duration the phase "
                         "spans may leave uncovered at the p50")
    sp.add_argument("--overhead-guard", action="store_true",
                    help="also re-run the r7 router-overhead A/B "
                         "(tracing on, zero-think fake) and embed it")
    sp.add_argument("--overhead-users", type=int, default=48)
    sp.add_argument("--overhead-duration", type=parse_duration,
                    default=10.0)
    sp.add_argument("--max-overhead-ratio", type=float, default=2.5,
                    help="exit 1 if the tracing-on overhead ratio "
                         "exceeds this band (the r7 contract)")
    sp.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--log-dir", default="loadgen-logs")
    sp.add_argument("--startup-timeout", type=float, default=420.0)
    sp.add_argument("--output", default=None,
                    help="write TRACE_*.json here (default: "
                         "timestamped)")
    sp.set_defaults(fn=cmd_trace)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
