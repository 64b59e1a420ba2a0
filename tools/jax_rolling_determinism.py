#!/usr/bin/env python3
"""Run the JAX engine's rolling-KV setup of tests/test_sliding_window.py
several times and print a hash of each run's greedy tokens.

    JAX_PLATFORMS=cpu python tools/jax_rolling_determinism.py --runs 20 \
        --pipeline-depth 2

debug-sliding (a 64-token window on every layer) in float32, two
concurrent 300-token generations on a 512-token pool (blocks of 16), so
blocks roll behind the window while the pool is tight. Every run should
print the same hash; the count of each hash is printed last. The CPU
backend is forced to 8 virtual devices, as tests/conftest.py does.
"""

import argparse
import collections
import dataclasses
import hashlib
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from production_stack_tpu.engine.config import EngineConfig  # noqa: E402
from production_stack_tpu.engine.engine import LLMEngine  # noqa: E402
from production_stack_tpu.engine.scheduler import SamplingOptions  # noqa: E402
from production_stack_tpu.models import config, llama  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--pipeline-depth", type=int, default=2)
    args = ap.parse_args()
    cfg = dataclasses.replace(config.get_config("debug-sliding"),
                              dtype=jnp.float32)
    params = llama.init_params(cfg, jax.random.PRNGKey(0))
    prompts = [list(range(3 + j, 35 + j)) for j in range(2)]
    seen = collections.Counter()
    for i in range(args.runs):
        eng = LLMEngine(EngineConfig(
            model="debug-sliding", dtype="float32", kv_dtype="float32",
            max_model_len=512, max_num_seqs=2, prefill_chunk=32,
            prefill_buckets=(32,), decode_window=4, kv_block_size=16,
            kv_pool_tokens=512, window_adapt=False,
            pipeline_depth=args.pipeline_depth), params=params)
        ids = [eng.add_request(p, SamplingOptions(
            temperature=0.0, max_tokens=300, ignore_eos=True))
            for p in prompts]
        while eng.has_work:
            eng.step()
        digest = hashlib.md5(str([eng.seqs[s].output_tokens
                                  for s in ids]).encode()).hexdigest()[:8]
        seen[digest] += 1
        print(f"run {i}: {digest}", flush=True)
    print(dict(seen))


if __name__ == "__main__":
    main()
