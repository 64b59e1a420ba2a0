"""Distributed loadgen coordinator: partition, spawn, merge.

The coordinator owns the three laws the workers must not be trusted
with individually:

1. **Schedule partition** — contiguous session-id shards of the one
   deterministic schedule (synthetic) or ``session_id % N`` shards of
   a trace (replay). Shards are disjoint and covering by construction.
2. **Rate partition** — worker i runs the shared open-loop ramp at
   ``qps_scale = 1/N`` with an independent arrival seed; the merged
   superposition is one Poisson process at the target rate.
3. **Merge-then-quantile** — workers ship RAW records; the coordinator
   folds every sample into one ``LatencyRecordSet`` and only then
   reads percentiles. Per-worker percentiles appear ONLY in the skew
   diagnostics block, labelled as such.

Workers are subprocesses (``python -m ...distributed.worker``) talking
to the stack's public HTTP surface — the same process isolation every
rig in this repo uses, and the same files a multi-host run would ship
over ssh.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

REPO_ROOT = str(Path(__file__).resolve().parents[3])

from production_stack_tpu_torch.loadgen.distributed.shard import (
    WorkerAssignment, shard_sessions, worker_arrival_seed)
from production_stack_tpu_torch.loadgen.distributed.worker import read_records
from production_stack_tpu_torch.loadgen.client import RequestRecord
from production_stack_tpu_torch.loadgen.report import (LatencyRecordSet,
                                                 aggregate)
from production_stack_tpu_torch.loadgen.spec import WorkloadSpec
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


@dataclass
class DistResult:
    """One coordinated run: the merged truth + per-worker evidence."""
    records: List[RequestRecord]
    merged_summary: Dict
    per_worker: List[Dict]
    violations: List[str]
    skew: Dict = field(default_factory=dict)
    issued_digest: Optional[str] = None   # replay runs only

    @property
    def ok(self) -> bool:
        return not self.violations


def synthetic_assignments(spec: WorkloadSpec, base_url: str, *,
                          workers: int,
                          total_sessions: Optional[int] = None,
                          duration_s: Optional[float] = None,
                          api_key: Optional[str] = None,
                          warmup_requests: int = 0
                          ) -> List[WorkerAssignment]:
    """Partition a synthetic workload: session shards + rate shards."""
    spec.validate()
    spec_dict = dataclasses.asdict(spec)
    if total_sessions is None:
        total_sessions = spec.max_sessions
    ranges: List[Tuple[int, Optional[int]]]
    if total_sessions is not None:
        ranges = [(start, end - start)
                  for start, end in shard_sessions(total_sessions,
                                                   workers)]
    else:
        # unbounded (duration-capped) run: give workers disjoint id
        # lanes far apart so shards never collide however many
        # sessions each starts
        ranges = [(i * 10_000_000, None) for i in range(workers)]
    out: List[WorkerAssignment] = []
    for i, (first, count) in enumerate(ranges):
        wspec = json.loads(json.dumps(spec_dict))   # deep copy
        if spec.arrival.mode == "open":
            wspec["arrival"]["qps_scale"] = \
                spec.arrival.qps_scale / workers
        else:
            share = spec.arrival.users // workers + \
                (1 if i < spec.arrival.users % workers else 0)
            wspec["arrival"]["users"] = max(1, share)
        out.append(WorkerAssignment(
            worker_index=i, num_workers=workers, base_url=base_url,
            mode="synthetic", spec=wspec, first_session_id=first,
            session_count=count, duration_s=duration_s,
            arrival_seed=worker_arrival_seed(spec.seed, i),
            api_key=api_key, warmup_requests=warmup_requests))
    return out


def replay_assignments(trace_path: str, base_url: str, *,
                       workers: int, speedup: float = 1.0,
                       api_key: Optional[str] = None
                       ) -> List[WorkerAssignment]:
    return [WorkerAssignment(
        worker_index=i, num_workers=workers, base_url=base_url,
        mode="replay", trace_path=trace_path, speedup=speedup,
        api_key=api_key) for i in range(workers)]


def run_coordinated(assignments: List[WorkerAssignment], *,
                    work_dir: str, timeout_s: float = 900.0,
                    log_prefix: str = "worker") -> DistResult:
    """Spawn one subprocess per assignment, wait, merge raw records.

    A worker that exits nonzero, times out, or leaves no records file
    is a coordinator-level violation (the run measured less than it
    claims) — never silently dropped from the merge.
    """
    os.makedirs(work_dir, exist_ok=True)
    procs: List[Tuple[int, subprocess.Popen, str, str, "object"]] = []
    for asn in assignments:
        asn.validate()
        tag = f"{log_prefix}-{asn.worker_index}"
        asn_path = os.path.join(work_dir, f"{tag}.assignment.json")
        rec_path = os.path.join(work_dir, f"{tag}.records.jsonl")
        sum_path = os.path.join(work_dir, f"{tag}.summary.json")
        with open(asn_path, "w") as f:
            f.write(asn.to_json())
        log = open(os.path.join(work_dir, f"{tag}.log"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "production_stack_tpu_torch.loadgen.distributed.worker",
             "--assignment", asn_path, "--records", rec_path,
             "--summary", sum_path],
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO_ROOT)
        procs.append((asn.worker_index, proc, rec_path, sum_path, log))
    violations: List[str] = []
    deadline = time.monotonic() + timeout_s
    merged: List[RequestRecord] = []
    latencies = LatencyRecordSet()
    per_worker: List[Dict] = []
    digests: List[str] = []
    for idx, proc, rec_path, sum_path, log in procs:
        budget = max(1.0, deadline - time.monotonic())
        try:
            rc = proc.wait(timeout=budget)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            violations.append(f"DIST worker {idx} timed out after "
                              f"{timeout_s:.0f}s and was killed")
            log.close()
            continue
        log.close()
        if rc != 0:
            violations.append(f"DIST worker {idx} exited {rc} "
                              f"(see {log.name})")
            continue
        if not os.path.exists(rec_path) or not os.path.exists(sum_path):
            violations.append(f"DIST worker {idx} exited 0 but left "
                              f"no records/summary files")
            continue
        records = read_records(rec_path)
        with open(sum_path) as f:
            summary = json.load(f)
        merged.extend(records)
        for r in records:
            latencies.add(r)
        for v in summary.get("violations", []):
            violations.append(f"[worker {idx}] {v}")
        if summary.get("issued_digest"):
            digests.append(summary["issued_digest"])
        ok = [r for r in records if r.ok]
        span = (max((r.finish_time for r in records), default=0.0)
                - min((r.launch_time for r in records), default=0.0))
        per_worker.append({
            "worker_index": idx,
            "launched": summary.get("launched", len(records)),
            "finished": summary.get("finished", len(ok)),
            "errors": summary.get("errors", 0),
            "http_5xx": summary.get("http_5xx", 0),
            "offered_qps": round(len(records) / span, 4)
            if span > 0 else 0.0,
            # per-worker quantiles: skew DIAGNOSTICS only — the
            # merged truth comes from the coordinator's LatencyRecordSet
            "diag_quantiles": LatencyRecordSet.from_records(ok)
            .quantiles(),
        })
    merged_summary = aggregate(merged) if merged else {}
    if merged:
        # the authoritative percentiles: merged raw samples
        merged_summary.update(latencies.quantiles())
    skew: Dict = {}
    rates = [w["offered_qps"] for w in per_worker if w["offered_qps"]]
    if len(rates) > 1:
        skew = {
            "workers": len(per_worker),
            "offered_qps_min": min(rates),
            "offered_qps_max": max(rates),
            "offered_qps_imbalance": round(max(rates) / min(rates), 4)
            if min(rates) > 0 else None,
            "ttft_p50_spread_s": round(
                max(w["diag_quantiles"]["ttft_s"]["p50"]
                    for w in per_worker)
                - min(w["diag_quantiles"]["ttft_s"]["p50"]
                      for w in per_worker), 4),
        }
    issued_digest = None
    if digests:
        # the run's issued multiset = union of worker shards; digests
        # are per-shard, so combine order-independently
        import hashlib
        issued_digest = hashlib.sha256(
            "".join(sorted(digests)).encode()).hexdigest()
    return DistResult(records=merged, merged_summary=merged_summary,
                      per_worker=per_worker, violations=violations,
                      skew=skew, issued_digest=issued_digest)
