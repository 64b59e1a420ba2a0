"""A throwaway benchmark in a temporary folder: a tiny Mistral
configuration (a window on every layer), a traffic mix and a cell,
beside a copy of the harness's metric readers, so a run of the whole
harness fits on a CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

HARNESS = Path(__file__).resolve().parent.parent
REPO = HARNESS.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def tiny_root(tmp: Path, rate: float = 4.0, limit: float = 0.0005) -> Path:
    hb = tmp / "h100_bench"
    for d in ("configs", "cells", "traffic", "metrics"):
        (hb / d).mkdir(parents=True, exist_ok=True)
    for f in (HARNESS / "metrics").glob("*.py"):
        shutil.copy(f, hb / "metrics" / f.name)
    cfg = {"architectures": ["MistralForCausalLM"],
           "model_type": "mistral",
           "hidden_act": "silu", "hidden_size": 64,
           "intermediate_size": 128, "max_position_embeddings": 512,
           "num_attention_heads": 4, "num_hidden_layers": 2,
           "num_key_value_heads": 2, "rms_norm_eps": 1e-5,
           "rope_theta": 10000.0, "sliding_window": 48,
           "tie_word_embeddings": False, "vocab_size": 300,
           "deployment": {"quantization": None}}
    (hb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (hb / "traffic" / "t.json").write_text(json.dumps({
        "warm_s": 1.0,
        "prompt": {"median": 60, "sigma": 0.3, "min": 40, "max": 100},
        "output": {"median": 8, "sigma": 0.4, "min": 4, "max": 16}}))
    (hb / "cells" / "tiny.t.json").write_text(json.dumps({
        "engine": {"max_num_seqs": 4, "max_model_len": 256,
                   "prefill_chunk": 32, "decode_window": 4,
                   "kv_block_size": 16},
        "rate": rate, "drain_s": 20,
        "correct": {"mean_gap": limit, "tokens": 40, "requests": 4}}))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny", "source": "a test's own",
                        "file": "h100_bench/configs/tiny.json",
                        "reduced": [], "why": "a CPU test"}]
    spec["workloads"] = [{"name": "tiny.t", "config": "tiny",
                          "traffic": "t", "chips": 1, "why": "a CPU test"}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        m.pop("workloads", None)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def tiny(tmp_path):
    return tiny_root(tmp_path)
