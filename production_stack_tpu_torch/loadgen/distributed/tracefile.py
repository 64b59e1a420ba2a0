"""Replayable traffic traces: record, validate, synthesize, replay.

Format — ``*.trace.jsonl``, one JSON object per line:

- line 1, the header::

    {"schema": "tpu-loadgen-trace/v1", "name": ..., "seed": ...,
     "requests": N, "sessions": M, "duration_s": ..., "notes": ...}

- every further line, one request of the schedule (offset order)::

    {"offset_s": 1.234, "session_id": 7, "turn_index": 0,
     "kind": "chat", "model": "debug-tiny", "tenant": "acme",
     "question_tokens": 48, "answer_tokens": 96,
     "system_prompt_tokens": 200, "stream": true}

``offset_s`` is seconds since trace start (non-decreasing across the
file); ``turn_index`` is contiguous from 0 within each session;
``tenant`` is optional (absent = untagged traffic). Everything needed
to re-issue the request is ON the line — replay never consults the
spec that produced the trace, so a trace recorded from one stack
replays against any other.

Replay shards sessions across workers by ``session_id % num_workers``
(a session's turns all fire from one worker: multi-turn history and
session-affinity routing key off it) and preserves recorded timing
(``speedup`` compresses it). Two replays of one trace issue the same
request multiset — the determinism gate ``loadgen distload`` enforces.
"""

import asyncio
import hashlib
import heapq
import itertools
import json
import time
from dataclasses import asdict, dataclass
from typing import Dict, Iterable, List, Optional, Tuple

from production_stack_tpu_torch.loadgen.arrival import (arrival_stream,
                                                  replay_stream)
from production_stack_tpu_torch.loadgen.client import LoadClient, RequestRecord
from production_stack_tpu_torch.loadgen.report import aggregate
from production_stack_tpu_torch.loadgen.runner import InvariantTracker
from production_stack_tpu_torch.loadgen.spec import WorkloadSpec
from production_stack_tpu_torch.loadgen.workload import (plan_sessions,
                                                   replay_request_plan)

TRACE_SCHEMA = "tpu-loadgen-trace/v1"

_REQUIRED_FIELDS = ("offset_s", "session_id", "turn_index", "kind",
                    "model", "question_tokens", "answer_tokens")


@dataclass
class TraceRequest:
    """One recorded request: the schedule entry, not the outcome."""
    offset_s: float
    session_id: int
    turn_index: int
    kind: str
    model: str
    question_tokens: int
    answer_tokens: int
    system_prompt_tokens: int = 0
    tenant: Optional[str] = None
    stream: bool = True

    def to_line(self) -> Dict:
        d = asdict(self)
        if d["tenant"] is None:
            del d["tenant"]              # absent, not null: smaller files
        return d


def write_trace(path: str, header: Dict,
                requests: List[TraceRequest]) -> str:
    """Write header + requests (sorted by offset, ties by session/turn
    so the file is byte-deterministic). Fills the header's counts."""
    reqs = sorted(requests, key=lambda r: (r.offset_s, r.session_id,
                                           r.turn_index))
    hdr = {"schema": TRACE_SCHEMA, **header}
    hdr["requests"] = len(reqs)
    hdr["sessions"] = len({r.session_id for r in reqs})
    hdr["duration_s"] = round(reqs[-1].offset_s, 3) if reqs else 0.0
    with open(path, "w") as f:
        f.write(json.dumps(hdr, sort_keys=True) + "\n")
        for r in reqs:
            f.write(json.dumps(r.to_line(), sort_keys=True) + "\n")
    return path


def read_trace(path: str) -> Tuple[Dict, List[TraceRequest]]:
    """Parse + validate: schema version, required fields, offsets
    non-decreasing, per-session turn indexes contiguous from 0. A trace
    that fails any of these would replay as a DIFFERENT workload than
    it claims — refuse it loudly."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty trace")
    header = json.loads(lines[0])
    if header.get("schema") != TRACE_SCHEMA:
        raise ValueError(f"{path}: schema {header.get('schema')!r} != "
                         f"{TRACE_SCHEMA!r}")
    out: List[TraceRequest] = []
    prev_off = 0.0
    turn_seen: Dict[int, int] = {}
    for i, ln in enumerate(lines[1:], start=2):
        d = json.loads(ln)
        missing = [k for k in _REQUIRED_FIELDS if k not in d]
        if missing:
            raise ValueError(f"{path}:{i}: missing fields {missing}")
        r = TraceRequest(**d)
        if r.offset_s < prev_off - 1e-9:
            raise ValueError(f"{path}:{i}: offset {r.offset_s} before "
                             f"previous {prev_off}")
        prev_off = max(prev_off, r.offset_s)
        expect = turn_seen.get(r.session_id, 0)
        if r.turn_index != expect:
            raise ValueError(
                f"{path}:{i}: session {r.session_id} turn "
                f"{r.turn_index}, expected {expect} (turns must be "
                f"contiguous from 0)")
        turn_seen[r.session_id] = expect + 1
        out.append(r)
    declared = header.get("requests")
    if declared is not None and declared != len(out):
        raise ValueError(f"{path}: header claims {declared} requests, "
                         f"file has {len(out)}")
    return header, out


def trace_from_records(records: Iterable[RequestRecord],
                       spec: WorkloadSpec) -> List[TraceRequest]:
    """The recorder: any run's records -> its replayable schedule.

    Arrival offsets come from the measured launch times (so a replay
    reproduces the run's REAL arrival process — queueing delays the
    open loop imposed and all); per-turn shapes are re-derived from the
    spec's deterministic plan (records only carry the total prompt
    size, not the turn split)."""
    recs = [r for r in records if not r.cancelled]
    if not recs:
        return []
    t0 = min(r.launch_time for r in recs)
    plans = {}
    out: List[TraceRequest] = []
    for r in recs:
        if r.session_id not in plans:
            plans[r.session_id] = plan_sessions(spec, 1,
                                                first_id=r.session_id)[0]
        plan = plans[r.session_id]
        if r.turn_index >= len(plan.turns):
            raise ValueError(f"record turn {r.turn_index} beyond "
                             f"session {r.session_id}'s plan")
        turn = plan.turns[r.turn_index]
        out.append(TraceRequest(
            offset_s=round(r.launch_time - t0, 4),
            session_id=r.session_id, turn_index=r.turn_index,
            kind=r.kind,
            model=spec.lora_model if r.kind == "lora" else spec.model,
            question_tokens=turn.question_tokens,
            answer_tokens=turn.answer_tokens,
            system_prompt_tokens=0 if r.kind == "embeddings"
            else spec.session.system_prompt_tokens,
            stream=r.kind != "embeddings"))
    return out


def synthesize_trace(spec: WorkloadSpec, *,
                     duration_s: float,
                     tenants: Optional[List[Tuple[str, float]]] = None,
                     stages: Optional[List[Tuple[float, float]]] = None,
                     service_s_per_token: float = 0.02,
                     service_floor_s: float = 0.2
                     ) -> List[TraceRequest]:
    """A production-shaped schedule synthesized WITHOUT running load:
    arrival offsets from the spec's open-loop stages (the diurnal ramp
    lives in the stages), sessions admitted/resumed by a deterministic
    service model (a session's next turn becomes eligible
    ``service_floor_s + answer_tokens * service_s_per_token`` after the
    previous one fired — the service/think gap a real closed session
    shows). ``tenants`` (name, weight) tags each session by a
    deterministic per-session draw — skewed weights make one tenant
    bursty. ``stages`` overrides the spec's ramp with explicit
    (qps, duration_s) segments — ``ArrivalSpec`` only ramps upward,
    but a diurnal curve goes up AND back down."""
    spec.validate()
    if stages is None:
        stages = spec.arrival.stages()
    import random
    rng = random.Random((spec.seed << 8) ^ 0xa441)
    # (eligible_at, seq, session_state) — seq breaks ties determinist.
    ready: List[Tuple[float, int, Dict]] = []
    seq = itertools.count()
    next_sid = 0
    out: List[TraceRequest] = []

    def tenant_for(sid: int) -> Optional[str]:
        if not tenants:
            return None
        trng = random.Random((spec.seed << 24) ^ sid ^ 0x7E4A)
        names = [n for n, _ in tenants]
        weights = [w for _, w in tenants]
        return trng.choices(names, weights)[0]

    for offset, _qps in arrival_stream(rng, stages):
        if offset >= duration_s:
            break
        state = None
        if ready and ready[0][0] <= offset:
            _, _, state = heapq.heappop(ready)
        if state is None:
            plan = plan_sessions(spec, 1, first_id=next_sid)[0]
            next_sid += 1
            state = {"plan": plan, "turn": 0,
                     "tenant": tenant_for(plan.session_id)}
        plan, turn_i = state["plan"], state["turn"]
        turn = plan.turns[turn_i]
        out.append(TraceRequest(
            offset_s=round(offset, 4),
            session_id=plan.session_id, turn_index=turn_i,
            kind=turn.kind,
            model=spec.lora_model if turn.kind == "lora" else spec.model,
            question_tokens=turn.question_tokens,
            answer_tokens=turn.answer_tokens,
            system_prompt_tokens=0 if turn.kind == "embeddings"
            else spec.session.system_prompt_tokens,
            tenant=state["tenant"],
            stream=turn.kind != "embeddings"))
        state["turn"] += 1
        if state["turn"] < len(plan.turns):
            eligible = offset + service_floor_s + \
                turn.answer_tokens * service_s_per_token
            heapq.heappush(ready, (eligible, next(seq), state))
    return out


def merge_traces(parts: List[List[TraceRequest]], *,
                 session_stride: int = 1_000_000) -> List[TraceRequest]:
    """Superpose independently-synthesized schedules into one trace
    (e.g. chat on model-a + batch on model-b as one fleet workload).
    Part i's session ids are re-based to ``i * session_stride`` so
    sessions never collide; offsets are kept as-is — the parts
    interleave in time exactly as they would as concurrent tenants."""
    out: List[TraceRequest] = []
    for i, part in enumerate(parts):
        for r in part:
            d = asdict(r)
            d["session_id"] = i * session_stride + r.session_id
            out.append(TraceRequest(**d))
    out.sort(key=lambda r: (r.offset_s, r.session_id, r.turn_index))
    return out


def issued_key(r: TraceRequest) -> Tuple:
    """The identity of a request for the determinism gate: everything
    that reaches the wire except timing."""
    return (r.session_id, r.turn_index, r.kind, r.model,
            r.question_tokens, r.answer_tokens, r.tenant or "")


def multiset_digest(keys: Iterable[Tuple]) -> str:
    """Order-independent digest of an issued-request multiset: two
    replays match iff their digests match."""
    blob = json.dumps(sorted(list(k) for k in keys)).encode()
    return hashlib.sha256(blob).hexdigest()


async def replay_workload(requests: List[TraceRequest], base_url: str, *,
                          worker_index: int = 0, num_workers: int = 1,
                          speedup: float = 1.0,
                          api_key: Optional[str] = None,
                          request_timeout_s: float = 600.0,
                          extra_headers: Optional[Dict[str, str]] = None
                          ) -> Dict:
    """Re-issue this worker's shard of a trace with recorded timing.

    Shard = lines whose ``session_id % num_workers == worker_index``.
    Turns within a session fire in order (a turn whose offset arrives
    while the previous turn is still in flight waits for it — exactly
    what the original closed session did). Returns ``{"records",
    "summary", "violations", "issued_digest", "issued": n}``.
    """
    if speedup <= 0:
        raise ValueError(f"speedup must be positive, got {speedup}")
    mine = [r for r in requests
            if r.session_id % num_workers == worker_index]
    by_session: Dict[int, List[TraceRequest]] = {}
    for r in mine:
        by_session.setdefault(r.session_id, []).append(r)
    client = LoadClient(base_url, api_key=api_key,
                        request_timeout_s=request_timeout_s)
    tracker = InvariantTracker()
    records: List[RequestRecord] = []
    ids = itertools.count()
    prev_task: Dict[int, asyncio.Task] = {}
    in_flight: List[asyncio.Task] = []
    issued: List[Tuple] = []
    await client.start()
    try:
        t0 = time.monotonic()
        ordered = sorted(mine, key=lambda x: (x.offset_s, x.session_id,
                                              x.turn_index))
        arrivals = replay_stream((x.offset_s for x in ordered), speedup)
        for (target, _qps), r in zip(arrivals, ordered):
            delay = t0 + target - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            sess = by_session[r.session_id]
            prior = [{"question_tokens": t.question_tokens,
                      "answer_tokens": t.answer_tokens}
                     for t in sess if t.turn_index < r.turn_index]
            plan = replay_request_plan(
                session_id=r.session_id, turn_index=r.turn_index,
                kind=r.kind, model=r.model,
                question_tokens=r.question_tokens,
                answer_tokens=r.answer_tokens,
                system_prompt_tokens=r.system_prompt_tokens,
                prior_turns=prior, tenant=r.tenant, stream=r.stream)
            if extra_headers:
                plan.headers.update(extra_headers)
            issued.append(issued_key(r))
            wait_for = prev_task.get(r.session_id)

            async def fire(plan=plan, wait_for=wait_for) -> None:
                if wait_for is not None:
                    # in-order within the session: the recorded offset
                    # is the earliest fire time, not a license to
                    # overtake the previous turn
                    await asyncio.wait({wait_for})
                rid = next(ids)
                tracker.on_launch(rid)
                rec = await client.execute(plan, rid)
                rec.body = ""
                records.append(rec)
                tracker.on_complete(rec)

            task = asyncio.create_task(fire())
            prev_task[r.session_id] = task
            in_flight.append(task)
        if in_flight:
            await asyncio.gather(*in_flight)
    finally:
        await client.close()
    violations = tracker.finalize(records)
    return {"records": records,
            "summary": aggregate(records),
            "violations": violations,
            "issued": len(issued),
            "issued_digest": multiset_digest(issued)}
