"""The whole harness on a tiny cell on the CPU: the engine and server in
this process, the load generator in its own, the reference and the
check of what was served. With the timed path broken underneath, the
check must come out false; so must the control, the reference computed
one precision below the configuration's, put through the same check."""

import pytest
import torch

from h100_bench import run
from h100_bench.spec import Bench
from conftest import tiny_root

SEED = 2 ** 31 + 4321


def _run(root, trace=False, control=None, seconds=2.0):
    return run.run_cell(Bench(root), "tiny.t", SEED, seconds, trace,
                        device="cpu", control=control)


def test_a_tiny_cell_runs_and_is_correct(tiny):
    res = _run(tiny)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) >= {"ttft_p95_ms", "tpot_p95_ms", "setup_s"}
    assert res["checks"]["requests_checked"]["value"] >= 1
    assert list(res)[-1] == "checks"


def test_a_traced_run_reads_the_programs_spans_and_counters(tiny):
    res = _run(tiny, trace=True)
    assert res["correct"], res["checks"]
    assert "pad_dead_share" in res["metrics"]
    assert 0.0 <= res["metrics"]["pad_dead_share"]["value"] <= 100.0


def _state_unchanged(monkeypatch):
    from production_stack_tpu_torch.models import llama
    monkeypatch.setattr(llama, "write_at", lambda pool, x, blk, off: pool)


def _half_batch(monkeypatch):
    from production_stack_tpu_torch.ops import paged_attention as pa
    for name in ("paged_attention", "paged_decode_attention"):
        orig = getattr(pa, name)

        def half(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            if out.shape[0] > 1:
                out = out.clone()
                out[out.shape[0] // 2:] = 0
            return out
        monkeypatch.setattr(pa, name, half)


def _token_altered(monkeypatch):
    from production_stack_tpu_torch.engine import runner
    orig = runner._pick

    def pick(logits, sampling, generator, positions, **k):
        ids, lp, tops, state = orig(logits, sampling, generator, positions,
                                    **k)
        ids = torch.where(positions % 5 == 0,
                          (ids + 1) % logits.shape[-1], ids)
        return ids.to(torch.int32), lp, tops, state
    monkeypatch.setattr(runner, "_pick", pick)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    # a high rate keeps every slot busy, so every row of a batch serves
    root = tiny_root(tmp_path, rate=16.0)
    fault(monkeypatch)
    res = _run(root)
    assert not res["correct"], res["checks"]


def test_the_control_is_not_correct(tmp_path):
    """The control's tokens go through the check that judges the
    program's, on the same run's sample. At this size the program's
    float32 CPU path reads a mean gap of 0 and int8 weights 2.6e-5, so
    the tiny cell's limit sits between them."""
    res = _run(tiny_root(tmp_path, limit=5e-6), control="w8a16")
    assert res["correct"], res["checks"]
    ctl = res["control"]
    assert ctl["precision"] == "w8a16" and not ctl["correct"], ctl
    assert ctl["checks"]["mean_gap"]["value"] > ctl["checks"]["mean_gap"][
        "limit"]
    assert list(res)[-2:] == ["control", "checks"]
