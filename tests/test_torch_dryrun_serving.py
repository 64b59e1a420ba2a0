"""The serving half of the JAX package's multichip dry run
(__graft_entry__.py:114-281) through the port's engines on the CPU, at
n = 4 ranks (gloo, spawned): dp = 2 x tp = 2 over f32, int8 and bf16
pools, debug-moe at ep = 2 x tp = 2, the feature pass and the
disaggregated handoff over tp = 2 (parallel/dryrun.dryrun_serving; any
miss raises inside it)."""

import dataclasses

import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import LLMEngine
from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer
from production_stack_tpu_torch.models.config import ModelConfig, get_config
from production_stack_tpu_torch.parallel import dryrun


def test_dryrun_serving_passes_at_four_ranks():
    """Every part passes, and the report shows the dp engine's pool split
    as JAX splits it: the 9 blocks of 4 slots x 2 blocks + trash padded
    to 10, 5 a rank (and the scratch block), the block manager over 10;
    each layer's blocks assembled over dp; prefix hits on both feature
    engines; the consumer's hit."""
    r = dryrun.dryrun_serving(4, "cpu")
    assert r["mesh"] == {"dp": 2, "tp": 2}
    eng = r["dp_engine"]
    assert [p["dp_rank"] for p in eng["pool"]] == [0, 0, 1, 1]
    assert {(p["owned_blocks"], p["held_blocks"], p["pool_blocks"])
            for p in eng["pool"]} == {(5, 6, 10)}
    assert eng["block_manager_blocks"] == 10
    assert eng["collectives"]["dp.assemble"] > 0
    assert r["float32"]["tokens"] == r["int8"]["tokens"] \
        == r["bfloat16"]["tokens"]
    assert r["moe"]["mesh"] == {"ep": 2, "tp": 2}
    assert r["features"]["hit_rate"] > 0
    assert r["handoff"]["kv_consumer_hit_tokens"] > 0
    assert set(r["seconds"]) == {"float32", "int8", "bfloat16", "moe",
                                 "features", "handoff"}


def test_card_models_are_the_presets_at_head_dim_64(tmp_path):
    """On the card the dry run serves the tiny presets at head dim 64
    (the paged kernels take 64, 128 and 256) from a config.json it
    writes, with the preset's byte tokenizer; everything else is the
    preset's. On the CPU: the preset."""
    assert dryrun.tiny_model("debug-tiny", torch.device("cpu"),
                             str(tmp_path)) == {"model": "debug-tiny",
                                                "tokenizer": "debug-tiny"}
    for name in ("debug-tiny", "debug-moe"):
        got = dryrun.tiny_model(name, torch.device("cuda"), str(tmp_path))
        assert got["tokenizer"] == name
        assert ModelConfig.from_json(got["model"]) == dataclasses.replace(
            get_config(name), name=got["model"],
            head_dim=dryrun.CARD_HEAD_DIM)
        engine = LLMEngine(EngineConfig(**got, device="cpu",
                                        max_model_len=64, max_num_seqs=1))
        assert isinstance(engine.tokenizer, ByteTokenizer)
