"""Distributed loadgen worker: one shard, raw records out.

Subprocess entry point (the coordinator spawns N of these; a
multi-host run spawns them by hand or via ssh with the same files)::

    python -m production_stack_tpu_torch.loadgen.distributed.worker \\
        --assignment /tmp/dist/worker-0.json \\
        --records /tmp/dist/worker-0.records.jsonl \\
        --summary /tmp/dist/worker-0.summary.json

The assignment file (``shard.WorkerAssignment``) says what to run;
this process stays dumb on purpose. Output discipline is the whole
contract: the records file carries one RAW ``RequestRecord`` per line
— individual samples, never pre-aggregated percentiles — so the
coordinator can merge-then-quantile. The summary carries worker-local
bookkeeping (counts, violations, the issued-request digest replay
determinism is gated on) and a convenience aggregate that is NEVER
merged with other workers' (skew diagnostics only).

Exit 0 iff the shard ran and both files were written; invariant
violations are reported in the summary, not the exit code — the
coordinator owns the verdict.
"""

import argparse
import asyncio
import dataclasses
import json
import sys
from typing import Dict, List

from production_stack_tpu_torch.loadgen.client import RequestRecord
from production_stack_tpu_torch.loadgen.distributed.shard import WorkerAssignment
from production_stack_tpu_torch.loadgen.distributed.tracefile import (
    read_trace, replay_workload)
from production_stack_tpu_torch.loadgen.runner import run_workload
from production_stack_tpu_torch.loadgen.spec import WorkloadSpec


def write_records(path: str, records: List[RequestRecord]) -> None:
    with open(path, "w") as f:
        for r in records:
            d = dataclasses.asdict(r)
            d.pop("body", None)          # measurement, not payload
            f.write(json.dumps(d) + "\n")


def read_records(path: str) -> List[RequestRecord]:
    out: List[RequestRecord] = []
    with open(path) as f:
        for ln in f:
            if ln.strip():
                out.append(RequestRecord(**json.loads(ln)))
    return out


async def run_assignment(asn: WorkerAssignment) -> Dict:
    """Run the shard; returns {"records", "summary_extra"}."""
    if asn.mode == "replay":
        _, requests = read_trace(asn.trace_path)
        res = await replay_workload(
            requests, asn.base_url, worker_index=asn.worker_index,
            num_workers=asn.num_workers, speedup=asn.speedup,
            api_key=asn.api_key,
            extra_headers=asn.extra_headers or None)
        return {"records": res["records"],
                "summary_extra": {"violations": res["violations"],
                                  "issued": res["issued"],
                                  "issued_digest": res["issued_digest"]}}
    spec = WorkloadSpec.from_dict(asn.spec)
    result = await run_workload(
        spec, asn.base_url, api_key=asn.api_key,
        duration_s=asn.duration_s, max_sessions=asn.session_count,
        first_session_id=asn.first_session_id,
        arrival_seed=asn.arrival_seed,
        warmup_requests=asn.warmup_requests,
        checkpoint_interval_s=3600.0)    # coordinator owns progress
    return {"records": result.records,
            "summary_extra": {"violations": result.violations}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser("loadgen-dist-worker")
    p.add_argument("--assignment", required=True,
                   help="WorkerAssignment JSON file the coordinator "
                        "wrote (shard bounds, arrival seed, mode)")
    p.add_argument("--records", required=True,
                   help="output: one raw RequestRecord JSON per line "
                        "(samples, never percentiles)")
    p.add_argument("--summary", required=True,
                   help="output: worker-local counts/violations JSON")
    args = p.parse_args(argv)
    asn = WorkerAssignment.from_file(args.assignment)
    res = asyncio.run(run_assignment(asn))
    records = res["records"]
    write_records(args.records, records)
    ok = [r for r in records if r.ok]
    summary = {
        "worker_index": asn.worker_index,
        "mode": asn.mode,
        "launched": len(records),
        "finished": len(ok),
        "errors": len([r for r in records if r.error is not None]),
        "http_5xx": len([r for r in records if r.status >= 500]),
        **res["summary_extra"],
    }
    with open(args.summary, "w") as f:
        json.dump(summary, f, indent=2)
        f.write("\n")
    print(f"worker {asn.worker_index}: {summary['launched']} launched, "
          f"{summary['errors']} errors, "
          f"{len(summary.get('violations', []))} violations",
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
