"""The harness's parts on their own: arguments, finding files by name,
the traffic, the window's arithmetic, the operation and byte counts and
the import check."""

import json
import random

import pytest

from h100_bench import measures, run, traffic, work
from h100_bench.imports import forbidden_loaded
from h100_bench.spec import Bench
from conftest import REPO


def test_parse_args_takes_the_run_arguments():
    a = run.parse_args(["--workload", "mistral-7b.rag", "--seed",
                        str(2 ** 31 + 12345), "--seconds", "50",
                        "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == (
        "mistral-7b.rag", 2 ** 31 + 12345, 50.0, 1)
    assert run.parse_args(["--workload", "x", "--seed", "1",
                           "--seconds", "1"]).trace == 0


@pytest.mark.parametrize("argv", [
    ["--seed", "1", "--seconds", "1"],
    ["--workload", "x", "--seed", "1", "--seconds", "0"],
    ["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"],
])
def test_parse_args_refuses(argv):
    with pytest.raises(SystemExit):
        run.parse_args(argv)


def test_main_refuses_an_unknown_cell_and_a_missing_card():
    assert run.main(["--workload", "no.such", "--seed", "1",
                     "--seconds", "1"]) == 2
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "mistral-7b.rag", "--seed", "1",
                     "--seconds", "1"]) == 3


def test_every_cell_finds_its_files_by_name():
    bench = Bench(REPO)
    for w in bench.spec["workloads"]:
        cfg = bench.config(w["config"])
        assert cfg["source"] == bench.config_entry(w["config"])["source"]
        cell, mix = bench.cell(w["name"]), bench.traffic(w["traffic"])
        assert cell["engine"]["max_num_seqs"] > 0 and cell["rate"] > 0
        assert mix["prompt"]["min"] <= mix["prompt"]["max"]
        for trace in (False, True):
            for m in bench.metrics(w["name"], trace):
                assert callable(bench.reader(m["name"]).read)
    names = {w["name"] for w in bench.spec["workloads"]}
    for m in bench.spec["per_layer"]:
        assert set(m["workloads"]) <= names


def test_a_cell_and_a_metric_come_from_new_files_alone(tiny):
    (tiny / "h100_bench" / "metrics" / "requests_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.run['records']))\n")
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["per_layer"].append({
        "name": "requests_seen", "unit": "requests", "better": "higher",
        "source": "host_clock", "layer": "a test's", "moves": "ttft_p95_ms",
        "workloads": ["tiny.t"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(tiny)
    assert bench.cell("tiny.t")["rate"] == 4.0
    assert bench.traffic("t")["warm_s"] == 1.0
    assert bench.config("tiny")["hidden_size"] == 64
    metric = [m for m in bench.metrics("tiny.t", True)
              if m["name"] == "requests_seen"][0]

    class Ctx:
        run = {"records": [{}, {}, {}]}
    assert bench.read(metric, Ctx) == 3.0


def _plan(seed):
    mix = {"warm_s": 5,
           "prompt": {"median": 2000, "sigma": 0.35, "min": 1000,
                      "max": 3800},
           "output": {"median": 128, "sigma": 0.45, "min": 32, "max": 256}}
    return traffic.plan(mix, {"rate": 2.0}, seed, 32000, 30.0, 5.0)


def test_traffic_is_the_seeds_and_every_seed_gets_the_same_sizes():
    a, b, c = _plan(2 ** 31 + 7), _plan(2 ** 31 + 7), _plan(11)
    assert a == b
    assert a["requests"] != c["requests"]
    for key in ("max_tokens",):
        assert sorted(r[key] for r in a["requests"]) == sorted(
            r[key] for r in c["requests"])
    assert sorted(len(r["prompt"]) for r in a["requests"]) == sorted(
        len(r["prompt"]) for r in c["requests"])
    for r in a["requests"]:
        assert 1000 <= len(r["prompt"]) <= 3800
        assert 32 <= r["max_tokens"] <= 256
        assert all(0 <= t < 32000 for t in r["prompt"])


def test_arrivals_fill_their_segment_at_their_rate():
    offs = traffic.arrival_offsets(2.0, 50.0, random.Random(1))
    assert len(offs) == 100
    assert offs == sorted(offs) and 0.0 < offs[0] and offs[-1] < 50.0


def test_every_seed_puts_the_same_work_in_the_window():
    def window(plan, key):
        return sorted(key(r) for r in plan["requests"]
                      if 5.0 <= r["due"] < 35.0)
    a, c = _plan(2 ** 31 + 7), _plan(11)
    for key in (lambda r: len(r["prompt"]), lambda r: r["max_tokens"]):
        assert len(window(a, key)) == 60
        assert window(a, key) == window(c, key)


def _run(stall: bool):
    """Requests due every 0.5 s, first token 0.1 s after, then a token
    every 0.05 s for 20 tokens; a stall of 3 s at 4 s delays every
    delivery after it by 3 s."""
    def deliver(t):
        return t + 3.0 if stall and t >= 4.0 else t
    records = []
    for i in range(24):
        due = 0.5 * i
        times = [deliver(due + 0.1 + 0.05 * k) for k in range(20)]
        times = sorted(times)
        records.append({"due": due, "sent": due, "times": times,
                        "in_window": 0.0 <= due < 10.0, "error": None,
                        "finished": True})
    return {"open": 0.0, "close": 10.0, "end": 13.0, "records": records}


def test_a_stall_in_the_window_lowers_output_and_raises_ttft():
    calm, stalled = _run(False), _run(True)
    tok = measures.output_tokens_in_window
    assert tok(stalled) < tok(calm)
    p95 = lambda r: measures.percentile(measures.ttfts_s(r), 95)  # noqa
    assert p95(calm) == pytest.approx(0.1)
    assert p95(stalled) >= 2.5
    assert max(measures.tpots_s(stalled)) > max(measures.tpots_s(calm))


def test_an_unanswered_request_counts_its_wait():
    r = _run(False)
    late = r["records"][19]            # due at 9.5 s, inside the window
    late["times"], late["finished"] = [], False
    assert max(measures.ttfts_s(r)) == pytest.approx(13.0 - 9.5)
    assert measures.failed(r) == 0
    r["records"][0]["error"] = "http 500"
    assert measures.failed(r) == 1


def test_percentile_is_nearest_rank():
    assert measures.percentile([], 95) == 0.0
    assert measures.percentile(list(range(1, 101)), 95) == 95
    assert measures.percentile([3, 1, 2], 50) == 2


@pytest.mark.parametrize("starts,window,kv_itemsize,bytes_,flops", [
    # one query at position 10 over 16-key blocks: 11 keys attended
    ([10], 0, 2, 68 + 64 + 2 * 11 * 2 * 16 + 4, 4 * 8 * 4 * 11),
    # a window of 8 at position 40: keys 33..40, one block
    ([40], 8, 2, 68 + 64 + 2 * 8 * 2 * 16 + 4, 4 * 8 * 4 * 8),
    # an int8 pool: 1-byte values and a 4-byte scale per (key, head)
    ([10], 0, 1, 68 + 64 + 2 * 11 * 2 * (8 + 4) + 4, 4 * 8 * 4 * 11),
    # a parked row (start = MB * Bs) reads nothing but its start
    ([64], 0, 2, 68, 0),
])
def test_paged_work_counts_by_hand(starts, window, kv_itemsize, bytes_,
                                   flops):
    assert work.paged_work(1, 1, 4, 8, starts, 3, 4, 16, 2, 2, window,
                           kv_itemsize) == (bytes_, flops)


def test_model_flops_count_weights_and_windowed_keys():
    cfg = {"hidden_size": 8, "intermediate_size": 16, "vocab_size": 10,
           "num_hidden_layers": 2, "num_attention_heads": 2,
           "num_key_value_heads": 1, "sliding_window": 3}
    per_layer = 8 * 8 * 2 + 8 * 4 * 2 + 3 * 8 * 16
    assert work.layer_params(cfg) == per_layer
    assert work.token_flops(cfg, 9, True) == (
        2 * (2 * per_layer + 4 * 4 * 2 * 3) + 2 * 8 * 10)
    assert work.span_flops(cfg, 0, 4, False) == 2 * (
        2 * per_layer * 4 + 4 * 4 * 2 * (1 + 2 + 3 + 3))


@pytest.mark.parametrize("names,found", [
    (["production_stack_tpu_torch", "production_stack_tpu_torch.ops",
      "numpy", "jax_like", "flaxen"], []),
    (["production_stack_tpu.engine"], ["production_stack_tpu"]),
    (["jaxlib.xla_client", "jax", "flax.linen"], ["flax", "jax", "jaxlib"]),
])
def test_the_import_check_compares_whole_top_level_names(names, found):
    assert forbidden_loaded(names) == found
