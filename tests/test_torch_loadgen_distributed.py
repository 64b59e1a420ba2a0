"""The port's distributed loadgen (production_stack_tpu_torch/loadgen/
distributed/) against the JAX package's: the same shard plans and
worker seeds, assignments that round-trip through either side's files,
merged quantiles, synthesized traces byte-equal on disk with equal
digests, the recorder, trace merges and replay plans, and the same
refusals of malformed traces.
"""

import dataclasses
import json
import random

import pytest

from production_stack_tpu.loadgen import report as jreport
from production_stack_tpu.loadgen import spec as jspec
from production_stack_tpu.loadgen import workload as jworkload
from production_stack_tpu.loadgen.client import RequestRecord as JRecord
from production_stack_tpu.loadgen.distributed import shard as jshard
from production_stack_tpu.loadgen.distributed import tracefile as jtrace
from production_stack_tpu.loadgen.distributed import worker as jworker
from production_stack_tpu_torch.loadgen import report as treport
from production_stack_tpu_torch.loadgen import spec as tspec
from production_stack_tpu_torch.loadgen import workload as tworkload
from production_stack_tpu_torch.loadgen.client import RequestRecord as TRecord
from production_stack_tpu_torch.loadgen.distributed import shard as tshard
from production_stack_tpu_torch.loadgen.distributed import \
    tracefile as ttrace
from production_stack_tpu_torch.loadgen.distributed import \
    worker as tworker


def _spec(mod, seed=5, **arrival):
    return mod.WorkloadSpec(
        name="t", model="m", seed=seed,
        session=mod.SessionSpec(rounds_min=1, rounds_max=3,
                                system_prompt_tokens=8,
                                question_tokens_mean=10.0,
                                question_tokens_max=16,
                                answer_tokens_mean=12.0,
                                answer_tokens_max=16),
        arrival=mod.ArrivalSpec(**arrival) if arrival else
        mod.ArrivalSpec(),
    ).validate()


OPEN = dict(mode="open", qps_start=2.0, qps_end=2.0, qps_step=0.0,
            stage_duration_s=20.0)


def _asdicts(items):
    return [dataclasses.asdict(x) for x in items]


# ------------------------------------------------------------- shards

@pytest.mark.parametrize("total,workers", [(10, 3), (7, 7), (2, 5),
                                           (100, 4), (0, 3), (1, 1),
                                           (1000, 16)])
def test_shard_plans_equal_jax(total, workers):
    assert tshard.shard_sessions(total, workers) == \
        jshard.shard_sessions(total, workers)
    assert [tshard.worker_arrival_seed(total, i) for i in range(workers)] \
        == [jshard.worker_arrival_seed(total, i) for i in range(workers)]


def test_sharded_plans_equal_jax():
    ts, js = _spec(tspec), _spec(jspec)
    for first, count in tshard.shard_sessions(9, 4):
        assert _asdicts(tworkload.plan_sessions(ts, count,
                                                first_id=first)) == \
            _asdicts(jworkload.plan_sessions(js, count, first_id=first))


@pytest.mark.parametrize("kw", [
    dict(worker_index=1, num_workers=3, base_url="http://x",
         mode="replay", trace_path="/t.jsonl", speedup=2.0),
    dict(worker_index=0, num_workers=2, base_url="http://y",
         mode="synthetic", first_session_id=10, session_count=5,
         duration_s=3.0, arrival_seed=77, api_key="k",
         warmup_requests=2, extra_headers={"x-tenant-id": "acme"}),
])
def test_worker_assignment_round_trip(kw, tmp_path):
    # the spec as the coordinator writes it: a JSON copy of asdict
    def spec(mod):
        if kw["mode"] != "synthetic":
            return {}
        return {"spec": json.loads(json.dumps(
            dataclasses.asdict(_spec(mod))))}
    tasn = tshard.WorkerAssignment(**kw, **spec(tspec))
    jasn = jshard.WorkerAssignment(**kw, **spec(jspec))
    assert tasn.to_json() == jasn.to_json()
    path = tmp_path / "a.json"
    path.write_text(tasn.to_json())
    assert tshard.WorkerAssignment.from_file(str(path)) == tasn
    assert dataclasses.asdict(jshard.WorkerAssignment.from_file(
        str(path))) == dataclasses.asdict(tasn)
    path.write_text(jasn.to_json())
    assert tshard.WorkerAssignment.from_file(str(path)) == tasn


def _records(cls, n, seed, offset=0.0):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        e2e = rng.uniform(0.05, 3.0)
        err = rng.random() < 0.1
        out.append(cls(
            request_id=i, session_id=i // 2, turn_index=i % 2,
            kind="chat", launch_time=offset + i * 0.3,
            finish_time=offset + i * 0.3 + e2e,
            ttft_s=None if err else rng.uniform(0.01, e2e),
            e2e_s=None if err else e2e,
            itl_s=[] if err else [rng.uniform(0.001, 0.05)
                                  for _ in range(rng.randint(0, 9))],
            status=500 if err else 200, error="boom" if err else None))
    return out


def test_worker_records_files_and_merged_quantiles_equal_jax(tmp_path):
    """Each worker's records file, read back by either side, folds into
    the same merged quantiles as one pass over the union."""
    shards = [(40, 1, 0.0), (25, 2, 100.0), (3, 3, 200.0)]
    tsets, jsets = [], []
    for k, (n, seed, offset) in enumerate(shards):
        path = str(tmp_path / f"w{k}.records.jsonl")
        tworker.write_records(path, _records(TRecord, n, seed, offset))
        jpath = str(tmp_path / f"w{k}.jax.records.jsonl")
        jworker.write_records(jpath, _records(JRecord, n, seed, offset))
        assert open(path).read() == open(jpath).read()
        trecs, jrecs = tworker.read_records(path), jworker.read_records(path)
        assert _asdicts(trecs) == _asdicts(jrecs)
        tsets.append(treport.LatencyRecordSet.from_records(trecs))
        jsets.append(jreport.LatencyRecordSet.from_records(jrecs))
    tmerged, jmerged = tsets[0], jsets[0]
    for t, j in zip(tsets[1:], jsets[1:]):
        tmerged.merge(treport.LatencyRecordSet.from_dict(t.to_dict()))
        jmerged.merge(jreport.LatencyRecordSet.from_dict(j.to_dict()))
    assert tmerged.quantiles() == jmerged.quantiles()
    assert tmerged.count == jmerged.count
    union = [r for n, seed, off in shards
             for r in _records(TRecord, n, seed, off)]
    assert tmerged.quantiles() == \
        treport.LatencyRecordSet.from_records(union).quantiles()


# ------------------------------------------------------------- traces

@pytest.mark.parametrize("seed,tenants", [(9, [("a", 3.0), ("b", 1.0)]),
                                          (2, None)])
def test_synthesized_trace_written_and_read_equal_jax(seed, tenants,
                                                      tmp_path):
    kw = dict(duration_s=20.0, **({"tenants": tenants} if tenants else {}))
    treqs = ttrace.synthesize_trace(_spec(tspec, seed, **OPEN), **kw)
    jreqs = jtrace.synthesize_trace(_spec(jspec, seed, **OPEN), **kw)
    assert treqs and _asdicts(treqs) == _asdicts(jreqs)
    tpath, jpath = str(tmp_path / "t.trace.jsonl"), \
        str(tmp_path / "j.trace.jsonl")
    ttrace.write_trace(tpath, {"name": "t", "seed": seed}, treqs)
    jtrace.write_trace(jpath, {"name": "t", "seed": seed}, jreqs)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    theader, tback = ttrace.read_trace(tpath)
    jheader, jback = jtrace.read_trace(tpath)
    assert theader == jheader
    assert _asdicts(tback) == _asdicts(jback)
    tdigest = ttrace.multiset_digest([ttrace.issued_key(r) for r in tback])
    assert tdigest == jtrace.multiset_digest(
        [jtrace.issued_key(r) for r in jback])
    assert tdigest == ttrace.multiset_digest(
        [ttrace.issued_key(r) for r in reversed(tback)])


def test_trace_from_records_equal_jax():
    ts, js = _spec(tspec, 3), _spec(jspec, 3)
    plans = tworkload.plan_sessions(ts, 4)
    rows = []
    for i, plan in enumerate(plans):
        for j, turn in enumerate(plan.turns):
            rows.append(dict(request_id=len(rows),
                             session_id=plan.session_id, turn_index=j,
                             kind=turn.kind, launch_time=50.0 + i + 0.1 * j,
                             status=200))
    random.Random(1).shuffle(rows)
    got = ttrace.trace_from_records([TRecord(**r) for r in rows], ts)
    want = jtrace.trace_from_records([JRecord(**r) for r in rows], js)
    assert len(got) == len(rows)
    assert _asdicts(got) == _asdicts(want)


def test_merge_traces_equal_jax():
    parts = [[(0.0, 0, 0, "chat", "m1", 4, 4), (0.2, 0, 1, "chat", "m1",
                                                 5, 6)],
             [(0.1, 0, 0, "chat", "m2", 4, 4)],
             [(0.05, 3, 0, "rag", "m3", 9, 2)]]
    for stride in (1000, 7):
        got = ttrace.merge_traces(
            [[ttrace.TraceRequest(*r) for r in p] for p in parts],
            session_stride=stride)
        want = jtrace.merge_traces(
            [[jtrace.TraceRequest(*r) for r in p] for p in parts],
            session_stride=stride)
        assert _asdicts(got) == _asdicts(want)


@pytest.mark.parametrize("turn,tenant", [(0, None), (2, "acme"),
                                         (1, None)])
def test_replay_plans_equal_jax(turn, tenant):
    kw = dict(session_id=7, turn_index=turn, kind="chat", model="m",
              question_tokens=8, answer_tokens=8, system_prompt_tokens=8,
              prior_turns=[{"question_tokens": 6,
                            "answer_tokens": 6}] * turn, tenant=tenant)
    got = tworkload.replay_request_plan(**kw)
    want = jworkload.replay_request_plan(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


GOOD = ('{"schema": "tpu-loadgen-trace/v1", "requests": 1}\n'
        '{"offset_s": 0.5, "session_id": 0, "turn_index": 0, '
        '"kind": "chat", "model": "m", "question_tokens": 4, '
        '"answer_tokens": 4}\n')


@pytest.mark.parametrize("text", [
    GOOD,
    GOOD.replace("/v1", "/v9"),
    GOOD.replace('"turn_index": 0', '"turn_index": 1'),
    GOOD.replace('"requests": 1', '"requests": 3'),
    GOOD.replace('"question_tokens": 4, ', ""),
    GOOD.replace('"offset_s": 0.5', '"offset_s": -1.0'),
    GOOD.split("\n")[0] + "\n",
    "",
    "not json\n",
], ids=["good", "schema", "contiguous", "claims", "missing", "negative",
        "empty-body", "empty", "garbage"])
def test_malformed_traces_rejected_by_both(text, tmp_path):
    path = tmp_path / "x.trace.jsonl"
    path.write_text(text)

    def outcome(mod):
        try:
            header, reqs = mod.read_trace(str(path))
            return ("read", header, _asdicts(reqs))
        except Exception as e:
            return ("refused", type(e).__name__, str(e))
    got, want = outcome(ttrace), outcome(jtrace)
    assert got == want
    if text != GOOD:
        assert got[0] == "refused" or got[2] == []
