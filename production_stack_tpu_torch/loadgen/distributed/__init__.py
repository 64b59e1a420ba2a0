"""Distributed load generation: coordinator/worker sharded loadgen.

One loadgen process caps out well below the saturation point of an
N-router fleet — this package shards generation across worker
processes (one coordinator, N workers, optionally on N hosts via
``--base-url`` per worker) without changing what is measured:

- the deterministic session schedule is partitioned by contiguous
  ``first_id`` ranges (``workload.plan_sessions`` is resumable, so the
  shards concatenate to exactly the single-process schedule);
- each worker runs an independent open-loop Poisson stream at
  rate/N — the superposition of N independent Poisson processes at
  qps/N is one Poisson process at qps, so the fleet sees the same
  arrival statistics one big worker would produce;
- workers ship RAW per-request records (JSONL), and the coordinator
  merges samples before taking quantiles (``report.LatencyRecordSet``
  — merge-then-quantile, never quantile-then-merge).

Trace replay rides the same sharding: ``tracefile`` records any run's
per-request schedule to a ``.trace.jsonl`` and replays it with original
timing, sessions sharded across workers by id.
"""

from production_stack_tpu_torch.loadgen.distributed.shard import (  # noqa: F401
    WorkerAssignment, shard_sessions, worker_arrival_seed)
from production_stack_tpu_torch.loadgen.distributed.tracefile import (  # noqa: F401
    TRACE_SCHEMA, TraceRequest, read_trace, synthesize_trace,
    trace_from_records, write_trace)
