"""Schedule and rate sharding: how N workers split one workload.

Pure functions (no IO) so the partition laws are unit-testable:

- ``shard_sessions(total, workers)`` — contiguous [start, end) ranges
  covering [0, total) exactly once. Contiguity matters: a session's
  turns must all be fired by ONE worker (multi-turn history and
  session-affinity routing both key off the session), and contiguous
  ``first_id`` ranges are what ``plan_sessions`` resumes from.
- ``worker_arrival_seed(seed, i)`` — per-worker arrival RNG seeds,
  distinct by construction, decoupled from the (shared) planning seed.

The rate law needs no function: worker i runs the spec's open-loop
stages with every qps divided by N. Superposing N independent Poisson
processes at qps/N yields one Poisson process at qps — the merged
arrival statistics are the single-worker statistics.
"""

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


def shard_sessions(total: int, workers: int) -> List[Tuple[int, int]]:
    """Contiguous [start, end) session-id ranges, one per worker,
    covering [0, total) with sizes differing by at most 1. Empty ranges
    (more workers than sessions) are legal and returned as (k, k)."""
    if workers < 1:
        raise ValueError(f"workers must be >= 1, got {workers}")
    if total < 0:
        raise ValueError(f"total must be >= 0, got {total}")
    base, extra = divmod(total, workers)
    out: List[Tuple[int, int]] = []
    start = 0
    for i in range(workers):
        size = base + (1 if i < extra else 0)
        out.append((start, start + size))
        start += size
    return out


def worker_arrival_seed(seed: int, worker_index: int) -> int:
    """Worker i's open-loop arrival seed: derived from the workload
    seed but distinct per worker (identical streams would synchronize
    into N-request bursts) and distinct from the single-process
    arrival seed (``(seed << 8) ^ 0xa441``) so a 1-worker distributed
    run is still an independent draw, not a bit-identical rerun."""
    return ((seed << 16) ^ 0xD157_0000) + worker_index * 0x9E37


@dataclass
class WorkerAssignment:
    """Everything one worker process needs, JSON round-tripped through
    the assignment file the coordinator writes and the worker loads.

    mode "synthetic": run ``spec`` (arrival qps already divided by
    ``num_workers`` by the coordinator) over sessions
    [first_session_id, first_session_id + session_count).

    mode "replay": re-issue ``trace_path``'s recorded requests whose
    session_id % num_workers == worker_index, at recorded offsets.
    """
    worker_index: int
    num_workers: int
    base_url: str
    mode: str = "synthetic"              # "synthetic" | "replay"
    spec: Optional[Dict] = None          # WorkloadSpec asdict (synthetic)
    first_session_id: int = 0
    session_count: Optional[int] = None
    duration_s: Optional[float] = None
    arrival_seed: Optional[int] = None
    trace_path: Optional[str] = None     # replay
    speedup: float = 1.0
    api_key: Optional[str] = None
    warmup_requests: int = 0
    extra_headers: Dict[str, str] = field(default_factory=dict)

    def validate(self) -> "WorkerAssignment":
        if self.mode not in ("synthetic", "replay"):
            raise ValueError(f"mode {self.mode!r} must be 'synthetic' "
                             f"or 'replay'")
        if self.mode == "synthetic" and self.spec is None:
            raise ValueError("synthetic assignment needs a spec")
        if self.mode == "replay" and not self.trace_path:
            raise ValueError("replay assignment needs a trace_path")
        if not (0 <= self.worker_index < self.num_workers):
            raise ValueError(
                f"worker_index {self.worker_index} outside "
                f"[0, {self.num_workers})")
        return self

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "WorkerAssignment":
        return cls(**json.loads(text)).validate()

    @classmethod
    def from_file(cls, path: str) -> "WorkerAssignment":
        with open(path) as f:
            return cls.from_json(f.read())
