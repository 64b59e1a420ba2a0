"""loadgen: committed load-generation, soak, and DP scale-out measurement.

The measurement layer the serving stack's perf claims rest on — in-repo
so every BASELINE number is a one-command reproduction from a fresh
clone (the reference commits its request generator and multi-server
sweep the same way: src/tests/perftest/request_generator.py,
run-multi-server.sh).

Pieces (each importable on its own):

- ``spec``     — dataclass workload specs (traffic mix, session shape,
                 arrival process) + JSON round-trip and named presets
- ``workload`` — deterministic, seeded session/turn planning and
                 OpenAI-protocol payload construction
- ``arrival``  — closed-loop and open-loop (Poisson, QPS ramp) arrival
                 processes
- ``client``   — asyncio streaming client with per-request TTFT / ITL /
                 e2e capture and abort injection
- ``runner``   — drives a workload against a base URL; soak invariants
                 and periodic checkpoint lines
- ``report``   — aggregation into BENCH-schema JSON and SCALEOUT_*.json
- ``orchestrator`` — launches N engine processes + the router and
                 measures the aggregate-tokens/s-vs-replicas curve
- ``overhead`` — router-vs-direct A/B storm (data-plane overhead ratio)
- ``chaos``    — engine kill/restart churn under storm (availability)
- ``overload`` — open-loop offered-QPS sweep past saturation (goodput
                 plateau, deadline compliance, structured sheds)
- ``autoscale`` — offered-QPS ramp against the closed-loop autoscaler
                 (replicas track the ramp, drain-safe scale-down,
                 fixed-N comparison)
- ``kvshare`` / ``kvmigrate`` / ``disagg`` / ``trace`` / ``firedrill``
  / ``incident`` / ``fleetdrill`` / ``effwatch`` — the closed loops
                 (cross-replica KV sharing, KV migration, P/D split
                 A/B, span-chain joins, SLO fire drill, incident
                 bundles, fleet remediation drill, efficiency-accounting
                 audit)
- ``multirouter`` — N peered router replicas behind an in-process L4
                 splitter (affinity vs single-router control, breaker
                 convergence, router-SIGKILL blip containment, QoS
                 tier degradation)
- ``multitenant`` — pooled multi-tenant fleet behind routers
- ``distributed`` — sharded load from several worker processes,
                 trace files, replay and the distload capstone

CLI: ``python -m production_stack_tpu_torch.loadgen
{run,soak,distload,scaleout,overhead,chaos,overload,effwatch,autoscale,
kvshare,kvmigrate,disagg,firedrill,incident,fleetdrill,multirouter,
multitenant,trace} ...``. Engine processes are the port's
``engine.server`` on the GPU (``--platform cuda``, the default) or on
the CPU (``--platform cpu``), or the test fake engine
(``--engine fake``).

Talks to the stack only through its public HTTP surfaces; no imports
from engine/ or router/ internals.
"""

from production_stack_tpu_torch.loadgen.spec import (ArrivalSpec, SessionSpec,
                                               TrafficMix, WorkloadSpec)

__all__ = ["ArrivalSpec", "SessionSpec", "TrafficMix", "WorkloadSpec"]
