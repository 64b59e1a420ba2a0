#!/usr/bin/env python3
"""Drive the PyTorch port (production_stack_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. build: compiles the CUDA kernels from csrc/ with nvcc (sm_90a), one
   nvcc per source, all started together, and reports each kernel's
   registers, shared memory and spills (ptxas -v), the HGMMA (wgmma)
   instructions of the bf16 prefill kernel and the HMMA (mma.sync)
   instructions of the bf16-q decode kernel, none of which may be 0;
2. kernels: holds each kernel against its plain PyTorch version on the
   card — for the paged kernels shuffled block tables, ragged rows, a
   row parked past the pool's virtual capacity, the chunk's own K/V
   written first, D in {64, 128, 256}, a sliding window that is not a
   multiple of the block size and a softcap on scores that reach it;
   the split decode over a 72-block row beside a 1-block row, the wgmma
   prefill at G = 2, 4, 8 with T off its 64-row tile, G = 1 (MHA, D 128
   and 256) and G = 7 (63 live rows of the tile), Mistral's window of
   4096; the decode kernel at batch 1 and 2 over the first rows of a
   4-row table (the batch buckets of the engine's adaptive windows);
   every paged case once more over an int8 pool with its scales;
   rolled tables (the entries behind each row's window at trash block 0,
   filled with 1e4) against the intact ones; for the flash kernel T
   and S that are not multiples of its tiles; under torch.profiler, a
   bf16-q decode call at Llama-3-8B's and Gemma-2-9B's shapes (T = 1
   and 4; bf16 and int8 pools) launches exactly one device kernel, the
   tensor-core decode kernel, which merges its own splits — and times
   kernel (a whole wrapper call), plain version
   and one PyTorch library call at the shapes the serving phases give
   them (Gemma-2's at both layer kinds, sliding and global; the paged
   kernels over a bf16 and over an int8 pool; the speculative verify
   windows, the decode kernel at T = 4 and the prefill kernel at
   T = 9; the decode kernel at batch 1 and 2, the buckets of the
   adaptive windows; the decode kernel at Llama-3-8B's shape at T = 2
   and 8, which no path serves; Qwen1.5-MoE's G = 1, Mistral's window on
   every layer, and Qwen2-7B's G = 7 at T = 1 and 4, which no path
   serves; one tensor-parallel rank's
   heads: Llama-3-8B at tp 2 over bf16 and int8 pools (at T = 1 and at
   the verify window T = 4 its engine launches), at tp 4 and 8,
   Gemma-2-9B at tp 2 and Qwen1.5-MoE at ep 2 and ep 2 x tp 2, checked
   among the cases above too; the dp = 2 x tp = 2 engine's launches,
   both kernels reading the copy of every row's first nb blocks that
   its ranks assemble, held against the plain version over the pool),
   holding
   each kernel against
   its plain version on the timed inputs too; Gemma-2's bf16 rows, which
   SDPA cannot compute (no softcap), take flex_attention with a tanh
   softcap and a window mask as their library call;
3. checkpoint: an HF checkpoint directory of Llama-3-8B's widths at 2
   layers (config.json, two .safetensors shards of the seed-0 draw)
   loads through the port's reader (bytes, seconds, GB/s), and an
   engine started on it serves and matches, bit for bit, an engine
   given the same weights in memory; loaded with int8 weights (each
   tensor read from its byte range, each layer quantized as it lands)
   it equals quantize_params of the bf16 load bit for bit; a second
   directory of Mixtral-8x7B's widths at 1 layer (3.4 GB of bf16
   experts, attention, embedding and head) loads int8 likewise (bytes,
   seconds, peak device memory, bit-equal to the quantized draw); both
   directories are deleted;
4. encoder: the BERT encoder of --embedding-model at full width,
   bert-base and minilm-l6 (random f32 weights from the engine's seed):
   pooled vectors on the card against the same weights on the CPU (rows
   of 512, 100 and 7 tokens), a row alone against itself batched beside
   the 512-token row, the time of one batch of max_num_seqs x 512 tokens
   beside its bound, and /v1/embeddings from an HF-named directory of
   the same weights (--embedding-model <dir>) bit for bit equal to the
   in-memory preset's on the same token ids, with no paged or flash
   kernel launched;
5. then for each served path — llama-3-8b, gemma-2-9b, llama-3-8b
   with int8 weights and an int8 KV pool (llama-3-8b-int8),
   qwen1.5-moe-a2.7b (60 experts, top-4, a shared expert, q/k/v biases),
   mistral-7b-v0.1 (a 4096 window on every layer, rolling KV) and
   Mixtral-8x7B with int8 weights over a bf16 pool (mixtral-8x7b-int8:
   8 experts of 14336, top-2; 93.4 GB in bf16, 46.7 GB int8, drawn,
   rounded and quantized one layer at a time on the card) — at full
   width and depth with random weights from a seed, one after the
   other (each engine is freed before the next is built; the engine's
   build time, its peak device memory beside the weights' and the
   pool's bytes, the peak past what stays held to three f32 copies of
   the largest layer on the int8 paths):
   - serve: starts the port's OpenAI server in-process, sends completion
     and chat requests (some concurrent, one streamed, one prompt long
     enough for several prefill chunks — past Gemma-2's 4096-token
     window), checks status, token counts and greedy repeatability, and
     that both paged kernels were launched (on Gemma-2 with the window
     and the softcap on, on the int8 path with the int8 pool) and the
     flash kernel, which serves no path as in the JAX package, was not;
     on Mistral every launch carries the window, on Qwen1.5-MoE and
     Mixtral the prefill chunks took the MoE's capacity dispatch and
     decode its exact path;
   - roll (mistral-7b-v0.1): a 4,600-token prompt through the engine;
     at the first decode window 7 blocks behind the window are freed
     and the pool's free blocks rise by 7; served at pipeline_depth 2
     with windows dispatched ahead, its tokens equal depth 1's;
   - trace and auth (llama-3-8b; the trace with its own kernel counts):
     a streamed and a non-streamed completion with an inbound sampled
     traceparent keep its trace id (x-trace-id), /debug/traces returns
     the engine's trace parented on the inbound span with the phases
     preprocess, queue_wait, prefill, decode and postprocess (printed
     beside the client's TTFT and wall, with the unattributed time),
     /debug/perf read under the engine lock holds the efficiency ring's
     newest windows and the pool's census; then an application with an
     API key answers 401 without it on /v1/completions and /debug/traces
     and 200 on the probe routes, and 200 with it;
   - surface (its own kernel counts): on llama-3-8b, /load against the
     engine while a request is in flight, /metrics with the router's
     gauges, the x-engine-* headers on every reply, a 504 for an elapsed
     deadline, /tokenize and /detokenize, logit_bias, min_tokens, a
     penalized greedy request (held in the reference phase against the
     plain adjust_logits over f32 logits), n = 3 and two prompts; on
     llama-3-8b and gemma-2-9b, top_logprobs and echo with prompt
     logprobs; on every path last, prompt ids outside the vocabulary
     answer 200 and so does the next request;
   - breakdown: device time of a decode step and of a prefill chunk of
     the served model, and from a torch.profiler trace of each the
     device's idle share and each kernel class's share; on llama-3-8b
     the decode step with one shaped row and top-5 beside it, and with
     one guided row, and the plain step's launches held to their count
     before shaping existed; on Qwen1.5-MoE and Mixtral the MoE block's
     share of the step and of the chunk (its device time per layer,
     times the layers); with int8 weights the converts' share (every
     layer's int8 weights and the head converted to bf16, as each
     forward converts them, the expert stacks apart);
   - then through the server again (after the breakdown, whose plain
     step's count of device events large uploads disturb):
   - guided (llama-3-8b, its own kernel counts): guided_regex,
     guided_choice, guided_json and response_format json_schema, each
     greedy and sampled, beside a plain and a shaped row; every output
     fully matches its pattern or parses as schema-valid JSON;
     json_object answers 400; the stacked table's shape and build time;
   - spec (llama-3-8b at spec 3 and 8, gemma-2-9b at spec 3 over its
     4,600-token prompt): a second engine over the same weights with
     speculative_ngram_tokens serves a repetitive prompt, a
     non-repetitive one and a mixed batch (plain, shaped, guided and
     top_logprobs rows) that the spec-free engine served first; the
     verify window must launch the decode kernel at T = 4 and the
     prefill kernel at T = 9; the speculation counters, and at spec 3
     a macro-step's wall and device time, launches and tokens per
     macro-step;
   - embed (llama-3-8b, its own kernel counts, which stay 0: the
     pooling forward is the plain causal attention, as in the JAX
     package): /v1/embeddings over three inputs of different lengths
     gives finite vectors of the model's width; /v1/rerank, /v2/rerank
     and /v1/score answer 200 with finite scores;
   - lora (llama-3-8b, and on llama-3-8b-int8 the .npz adapter alone;
     its own kernel counts): adapters loaded over /admin/lora/load
     (random:11 and a full-width .npz written from a seeded numpy
     draw, rank 16 on all seven projections) are listed by /v1/models,
     /load and the tpu:engine_adapter_* series; a batch of the base
     model and both adapters gives distinct streams through both paged
     kernels; an evicted adapter answers 404 and a new load takes the
     next id; then lora_breakdown times a decode step of two adapter
     rows and two base rows beside the plain step;
   - windows (llama-3-8b, after lora_breakdown): continuous batching
     across decode windows at JAX's defaults — WINDOWS' mix of 8 greedy
     requests in two waves through engines on the served weights, with
     the fixed geometry at depth 1, then adaptive windows at depth 2
     and at depth 1 (twice each): the windows reach batch buckets 4, 2
     and 1 and the decode kernel launches at each, some windows are
     dispatched ahead, and every request's tokens equal the fixed
     geometry's or part at a near-tie; printed: the window geometries,
     the windows ahead and their discarded rows, the decode kernel's
     launches by batch, the mix's wall, each request's TTFT, the
     delivery lag (a window's end on the card to step() handing its
     tokens out) and a decode step at B = 1, 2 and 4;
   - reference: the served model's logits through the kernels agree
     with a float32 forward through the plain attention (on the int8
     path over the same int8 weights and an int8 pool; the f32 weights
     upcast a layer at a time, so Qwen1.5-MoE's fit beside its bf16
     ones; Mixtral's int8 weights dequantized in f32 by the forward);
     on the MoE paths the first layer's expert ids of the bf16
     path against the f32 ones (a difference only within the bf16
     router error); on Mistral the greedy tokens past the roll against
     the f32 teacher-forced argmax (near_tie_check); on the
     speculating paths the teacher-forced verify window (one forward of
     spec + 1 tokens, and spec + 1 single-token forwards) against it
     too, the speculating engine's greedy tokens against the spec-free
     ones (a first difference only at a near-tie) and its shaped row
     against the f32 shaped argmax; the pooled vector against the f32
     encode and padding-independent; with adapters, the .npz adapter's
     bf16 logits through the kernels against an f32 forward with the
     same adapter, and each adapter row of the mixed batch against the
     same request served alone (equal, or parting at a near-tie);
6. kvtier: KV tiering and disaggregated prefill at Llama-3-8B's full
   width and depth (KVTIER; one weight set shared by five engines):
   the port's cache server as a subprocess; a producer with a host and
   the remote tier serves a 3,000-token and a 2,048-token prompt through
   its HTTP server with max_tokens = 1 (the router's prefill stage);
   a consumer on the remote tier serves each with 24 greedy tokens
   from hits of 2,816 and 2,047 tokens (its injected blocks, re-extracted,
   equal the producer's chunk bytes bit for bit; the suffix through the
   prefill kernel, the 1-token suffix at its 16-token bucket, decode
   over the injected blocks; the terminal output's timing carries the
   prefetch wait and the hit as the trace's kv_prefetch event reads
   them), its tokens against a recompute engine's (equal, or parting at
   a near-tie); an int8-pool consumer takes the
   same bf16 chunks; migrate_out of a decoding sequence on the producer
   and warm of its keys on the consumer, the victim re-admitted by
   injection; then extract_chunk / inject_chunk per chunk (bf16 and
   int8 pools), pinned D2H / H2D, each tier's put and get rates and
   each codec's times and ratio on one chunk, and TTFT with the hit
   and without it;
7. parallel: tensor- and expert-parallel serving at full width
   (PARALLEL), every rank on the one card, where gloo stages each
   collective through the host (its step times measure that rig, not a
   multi-GPU speed). Llama-3-8B at 16 of its 32 layers (its worlds cut
   in depth to make room for Mixtral; MoE models at full depth): a
   one-rank engine serves greedy
   prompts of 300 and 1,000 tokens, a shaped, a guided and a
   repetitive (n-gram speculating) request through its server, then an
   engine at tensor_parallel_size = 2 on the same weights (random, from
   the seed; each rank draws every layer whole and keeps its slice)
   serves them, and its tokens equal the one-rank engine's or part at a
   near-tie against the f32 teacher-forced logits (the shaped row:
   shaped_check); a greedy request over the int8 pool likewise.
   Qwen1.5-MoE-A2.7B at expert_parallel_size = 2 and at ep = 2 x tp = 2:
   a 1,100-token prompt whose prefill takes the capacity dispatch and
   decode the exact path, its tokens against the one-rank engine's
   (near_tie_check), layer 0's routing against f32 (routing_check).
   Mixtral-8x7B with int8 weights at expert_parallel_size = 2, both
   ranks on the card (each builds its slice a layer at a time: all the
   attention, the embedding and the head, and 4 of each layer's 8
   experts, ~24 GB a rank): a 600-token prompt against the one-rank
   int8 engine's tokens likewise.
   Each world prints its backend and rank->device map, every rank's
   memory, the first step's log-softmax and the prompt's
   log-probabilities against the one-rank engine (max |diff|), a decode
   step's wall and its collectives beside the
   one-rank step, /load, the paged kernels' launches of every rank, and
   that the workers sampled rank 0's tokens. Then Llama-3-8B at
   dp = 2 x tp = 2 (the `dp` line, dp_run; four ranks, each with a
   tp = 2 slice of the weights and half the pool's blocks): the mesh
   refused without dp_gather_attention_ok; with it, a request served
   through its server, the same batch as the tp = 2 engine (added at
   once under the engine lock) and the int8 pool's request, each bit
   for bit equal to the tp = 2 engine's; rank 0's kernel launches by T
   (both kernels, over the copy each layer assembles over dp) and no
   call of the plain version; the pool per rank beside a tp = 2 rank's;
   the assembly's ms per layer beside its bytes; a decode step's wall
   and collectives by axis and kind beside the tp = 2 step. Then the
   dry run's serving half at 4 ranks (`dryrun_serving`,
   parallel/dryrun.py: debug-tiny and debug-moe at head dim 64, f32,
   int8 and bf16 pools, each part against one rank).
8. train (after parallel, before kvtier; every engine freed first): the
   training path (TRAIN). Llama-3-8B at full width and depth, bf16,
   random weights from seed 0, one batch of 1 x 512 tokens from a
   numpy seed: before any optimizer state, forward_train's f32 logits
   against llama.forward through the paged prefill kernel (a 512-token
   pool; max |diff|, and the argmax of each against an f32 forward of
   the same weights, parting only at near-ties), then a forward and a
   backward with every stacked leaf split once (layer_params) and read
   per layer by select (select_layers), each timed with its peak memory;
   then 3 train_steps, whose losses are finite and fall and which launch
   no serving kernel, with the step's wall, one step timed part by part
   (forward, backward, the clip's norm, AdamW), its FLOPs over the bf16
   peak and AdamW's and the norm's bytes over HBM's, tokens/s, launches
   and the idle share from a profiled step, and the peak memory beside
   the state's bytes. At 2 layers of full width every leaf's bf16
   gradient against f32's of the same weights (relative Frobenius
   error, TRAIN_GRAD_TOL) and one bf16 AdamW step against the same
   step in f32. Then parallel/dryrun.py's worlds, every rank a process
   on the one card over gloo: dp 2 x sp 2 x tp 2 for 3 steps (losses
   equal one rank's within 1e-4 and falling) and GPipe at pp = 2 over
   4 microbatches (loss within 1e-4 of plain, gradients within atol
   2e-4 / rtol 2e-3), with the backend, the rank -> device map and the
   collectives a step.

Progress goes to stdout; the line before the last two is the kernels'
JSON record, then the card's name and power limit, then the result.
Any failed phase raises: the exit code is not 0 and no result line is
printed. Needs CUDA and this repository's sources beside the script.
"""

import asyncio
import gc
from contextlib import asynccontextmanager, contextmanager, nullcontext
import json
import math
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# LoRA on the llama paths (lora_phase): rank 16 on all seven projections,
# scaling alpha / rank = 1; nothing is stacked until an adapter loads
LORA_TARGETS = ("q", "k", "v", "o", "gate", "up", "down")
LORA = dict(lora_rank=16, lora_alpha=16.0, lora_targets=LORA_TARGETS)

# the served paths, in the order they are served. model: the preset (the
# path's name where not given); serve: the engine's
# geometry; decode_starts: the rows of the timed decode step; chunk_start:
# the start of the one live row of the timed prefill chunk; kv_len: the
# kv bucket both run at; long_tokens: the length of the long prompt;
# timing_layers: layers' pools the kernel timings rotate over, so the L2
# holds no layer from the previous launch; ref_prompt: the reference
# input's length (prefilled in prefill_chunk chunks, then 3 decode
# steps)
PATHS = {
    "llama-3-8b": dict(
        serve=dict(max_num_seqs=4, max_model_len=1024, prefill_chunk=512,
                   decode_window=8, kv_block_size=64, seed=0, **LORA),
        decode_starts=[200, 431, 57, 400], chunk_start=0, kv_len=512,
        long_tokens=697, timing_layers=32, ref_prompt=40),
    # Gemma-2-9B: KV 344 KB per token, 11.3 GB for the pool; the long
    # prompt runs past the 4096-token window of the even layers, so
    # they skip blocks in its last prefill chunks and its decode
    "gemma-2-9b": dict(
        serve=dict(max_num_seqs=4, max_model_len=8192, prefill_chunk=512,
                   decode_window=8, kv_block_size=64, seed=0),
        decode_starts=[4600, 1000, 57, 400], chunk_start=4096,
        kv_len=8192, long_tokens=4600, timing_layers=4, ref_prompt=4600),
    # Llama-3-8B with weight-only int8 (quantized on the card) and the
    # int8 KV pool, at the llama path's geometry
    "llama-3-8b-int8": dict(
        model="llama-3-8b",
        serve=dict(max_num_seqs=4, max_model_len=1024, prefill_chunk=512,
                   decode_window=8, kv_block_size=64, seed=0,
                   quantization="int8", kv_dtype="int8", **LORA),
        decode_starts=[200, 431, 57, 400], chunk_start=0, kv_len=512,
        long_tokens=697, timing_layers=32, ref_prompt=40),
    # Qwen1.5-MoE-A2.7B: 60 experts, top-4 raw softmax weights, a shared
    # expert, q/k/v biases, 16 q heads over 16 kv heads (G = 1); 28.6 GB
    # of bf16 weights, KV 196 KB per token (3.2 GB for the pool). Its
    # prefill chunks (4 x 512 tokens) take the capacity dispatch, its
    # decode the exact all-expert path; the reference prompt of 600
    # tokens runs both (chunks of 512 and 88 tokens, N > 64)
    "qwen1.5-moe-a2.7b": dict(
        serve=dict(max_num_seqs=4, max_model_len=4096, prefill_chunk=512,
                   decode_window=8, kv_block_size=64, seed=0),
        decode_starts=[200, 431, 57, 400], chunk_start=0, kv_len=512,
        long_tokens=1100, timing_layers=24, ref_prompt=600),
    # Mistral-7B-v0.1: the 4096-token window on every layer, so the
    # engine rolls the blocks behind it (roll_phase)
    "mistral-7b-v0.1": dict(
        serve=dict(max_num_seqs=4, max_model_len=8192, prefill_chunk=512,
                   decode_window=8, kv_block_size=64, seed=0),
        decode_starts=[4600, 1000, 57, 400], chunk_start=4096,
        kv_len=8192, long_tokens=4600, timing_layers=4, ref_prompt=4600),
    # Mixtral-8x7B: 8 experts of 14336, top-2, 32 q heads over 8 kv
    # heads (G = 4, Llama-3-8B's attention shape); 93.4 GB in bf16, so
    # weight-only int8 (46.7 GB, built a layer at a time on the card)
    # over a bf16 pool. Its prefill chunks take the capacity dispatch
    # (capacity N/2 at 8 experts, top-2), its decode the exact
    # all-expert path; the 600-token reference prompt runs both
    # (chunks of 512 and 88 tokens). Served last, when every earlier
    # path's engine is freed
    "mixtral-8x7b-int8": dict(
        model="mixtral-8x7b",
        serve=dict(max_num_seqs=4, max_model_len=4096, prefill_chunk=512,
                   decode_window=8, kv_block_size=64, seed=0,
                   quantization="int8"),
        decode_starts=[200, 431, 57, 400], chunk_start=0, kv_len=512,
        long_tokens=1100, timing_layers=32, ref_prompt=600),
}
# models timed in the kernel phase at their shapes without a serving
# path (no launches): Qwen2-7B's 28 q heads over 4 kv heads (G = 7)
KERNEL_ONLY = {
    "qwen2-7b": dict(
        serve=dict(max_num_seqs=4, kv_block_size=64),
        decode_starts=[200, 431, 57, 400], chunk_start=0, kv_len=512,
        timing_layers=28),
}
# tokens the roll phase generates past the long prompt
ROLL_TOKENS = 24


def path_model(path: str) -> str:
    """A path's preset (a name outside PATHS is its own)."""
    return PATHS.get(path, {}).get("model", path)


def path_kv(path: str) -> str:
    return PATHS[path]["serve"].get("kv_dtype", "bfloat16")
# kernel-phase tolerances, max |kernel - plain|:
# - float32: 2e-5, the bound the Pallas kernels are held to against the
#   plain path (tests/test_pallas_paged.py): the online softmax sums in
#   another order;
# - bfloat16: 3e-2 — outputs are bf16 (a rounding is 2^-8 relative on
#   values up to ~4) and the plain version, like the JAX one, rounds the
#   probabilities to bf16 before the value product where the kernel
#   keeps them f32.
# Over an int8 pool each kernel is held, at the same tolerances, against
# the plain version in float32 on the same q (upcast exactly): the
# kernels dequantize in f32 as the Pallas int8 branch does, where the
# plain version at bf16 q rounds the dequantized K/V to bf16.
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# the served model against its float32 plain-attention forward:
# - float32 through the kernels: 1e-3 of the largest logit (the 2e-5
#   per-attention difference of the summation order, through every
#   layer);
# - bf16 through the kernels: at most 2x the distance of the bf16 plain
#   path from the same reference
F32_LOGIT_TOL = 1e-3
BF16_FLOOR_FACTOR = 2.0
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
# device launches of one plain decode step of the breakdown (a window of
# decode_window steps, divided), as this script counted them on an H100
# before logit shaping existed: a batch with no shaped row and no top-K
# must launch exactly these. 1,836.5 until the decode kernel merged its
# splits in its one launch: 32 launches fewer a step
PLAIN_DECODE_LAUNCHES = {"llama-3-8b": 1804.5}
# n-gram speculation each path serves beside its spec-free engine
# (spec_phase): the draft lengths; the verify window spec + 1 takes the
# paged decode kernel at 4 and the prefill kernel at 9
SPEC = {"llama-3-8b": (3, 8), "gemma-2-9b": (3,)}
# the two-key object of the guided phase: every path through it ends
GUIDED_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "colour": {"enum": ["red", "green",
                                                   "blue"]}}}


def log(*args):
    print(*args, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean time of fn() over iters calls back to back (CUDA events),
    the host's dispatch included where it outlasts the device work."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, repeats: int = 3) -> float:
    """Device time of one fn() call: iters calls captured in one CUDA
    graph, replayed between CUDA events, the least of `repeats` replays.
    A kernel row's time is the card's work, not the host's dispatch: a
    decode-sized call takes ~0.01-0.05 ms on the card and ~0.05-0.1 ms to
    dispatch from Python, and timed eagerly it measured the host (which
    other processes share)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    del graph
    free_memory()
    return best


def free_memory():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def release(engine) -> None:
    """Drop a served engine's device tensors (weights, pool, carries,
    the guided table). aiohttp caches each application's middleware
    chain for the life of the process, and with the application the
    engine object, so deleting the last name of an engine frees
    nothing after its server has run."""
    eng = engine.engine
    eng.runner = eng._guided_table = eng._dev_sampling = None
    eng._inflight = []
    eng._lora_rows = []
    eng._enc_params = None
    free_memory()


# ------------------------------------------------------------ kernels

def paged_case(B, T, Hkv, G, D, Bs, lens, dtype, layers=1, parked=0,
               seed=0):
    """Pools [layers, N, Hkv, Bs, D] with shuffled tables, the chunk's
    own K/V written first, the last `parked` rows parked at
    start = MB*Bs + 3 (past the virtual capacity)."""
    import torch
    from production_stack_tpu_torch.models.kv import write_chunk
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    H = Hkv * G
    MB = -(-(max(lens) + T + 1) // Bs) + 1
    N = B * MB + 4

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    k, v = rnd(layers, N, Hkv, Bs, D), rnd(layers, N, Hkv, Bs, D)
    tables = (torch.randperm(N - 1, generator=g, device=dev)[:B * MB]
              + 1).reshape(B, MB).to(torch.int32)
    starts = torch.tensor(lens, dtype=torch.int32, device=dev)
    if parked:
        starts[B - parked:] = MB * Bs + 3
    q = rnd(B, T, H, D)
    pos = starts[:, None].long() + torch.arange(T, device=dev)
    for layer in range(layers):
        write_chunk(k[layer], rnd(B, T, Hkv, D), tables, pos)
        write_chunk(v[layer], rnd(B, T, Hkv, D), tables, pos)
    nb = min(-(-(max(lens) + T) // Bs), MB)
    return q, k, v, tables, starts, nb


def int8_pools(k, v, tables, starts, T, seed):
    """paged_case's pools as an int8 pool: quantized per (token, head),
    then the chunk's own K/V (fresh values) written by write_chunk_q.
    Returns (k8, v8, ks, vs), [layers, N, Hkv, Bs(, D)]."""
    import torch
    from production_stack_tpu_torch.models.kv import (quantize_chunk,
                                                      write_chunk_q)
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    (k8, ks), (v8, vs) = quantize_chunk(k), quantize_chunk(v)
    pos = starts[:, None].long() + torch.arange(T, device="cuda")
    B, Hkv, D = tables.shape[0], k.shape[2], k.shape[-1]
    for layer in range(k.shape[0]):
        for pool, scales in ((k8, ks), (v8, vs)):
            write_chunk_q(pool[layer], scales[layer],
                          torch.randn((B, T, Hkv, D), generator=g,
                                      device="cuda"), tables, pos)
    return k8, v8, ks, vs


def work(q, starts, nb, MB, Bs, Hkv, D, itemsize, window=0,
         kv_itemsize=None):
    """(bytes, flops) the paged call needs on this data. Every row:
    starts once and its output written once. A live row (start < MB*Bs)
    also reads its q, the table entries of the blocks it attends (from
    its first query's window start to its last query's block, within nb)
    and the K/V of the keys it attends (from its first query's window
    start to its last query's position, within those blocks), not the
    rest of their blocks — an int8 pool (kv_itemsize 1) also a 4-byte K
    and V scale per attended (key, head) — and does 4*D flops per (query
    head, attended key) for QK and PV, counting only the keys inside each
    query's window. A parked row needs nothing more: its output is zeros
    the engine discards. The softcap's tanh (one per score) is not
    counted: the tensor-core rate does not apply to it and it is 1/(4D)
    of the dot-product operations; nor is the int8 dequantization, one
    multiply per K/V value."""
    B, T, H, _ = q.shape
    kv_itemsize = kv_itemsize or itemsize
    kv_row = D * kv_itemsize + (4 if kv_itemsize == 1 else 0)
    row_q = T * H * D * itemsize
    byts = B * (row_q + 4)
    flops = 0
    for s in starts.tolist():
        if s >= MB * Bs:
            continue
        jend = min((s + T - 1) // Bs, nb - 1)
        first = max(s - (window - 1), 0) if window else 0
        blocks = max(jend - first // Bs + 1, 0)
        attended = max(min(s + T, (jend + 1) * Bs) - first, 0)
        byts += row_q + 2 * attended * Hkv * kv_row + 4 * blocks
        for t in range(T):
            lo = max(s + t - window + 1, 0) if window else 0
            keys = max(min(s + t + 1, (jend + 1) * Bs) - lo, 0)
            flops += 4 * D * H * keys
    return byts, flops


def flash_work(q, starts, S, Hkv, D, itemsize):
    """(bytes, flops) of the flash call on this data: q read and output
    written once, starts once, and per row the K/V slots up to its last
    query's position (within S); 4*D flops per (query head, attended
    slot)."""
    B, T, H, _ = q.shape
    byts = B * (2 * T * H * D * itemsize + 4)
    flops = 0
    for s in starts.tolist():
        byts += 2 * min(s + T, S) * Hkv * D * itemsize
        for t in range(T):
            flops += 4 * D * H * min(s + t + 1, S)
    return byts, flops


def sdpa_call(q, k, v, qpos, window=0, scale=None):
    """The library yardstick: SDPA (GQA, boolean causal mask, sliding
    window where given) over k/v [B, S, Hkv, D] — no softcap, which no
    single PyTorch call applies."""
    import torch
    import torch.nn.functional as F
    S = k.shape[1]
    kv_k, kv_v = k.transpose(1, 2), v.transpose(1, 2)   # [B, Hkv, S, D]
    s_idx = torch.arange(S, device=q.device)[None, None, :]
    mask = s_idx <= qpos[:, :, None]
    if window:
        mask = mask & (s_idx > qpos[:, :, None] - window)
    mask = mask[:, None]                                 # [B, 1, T, S]
    qt = q.transpose(1, 2)

    def call(i=0):
        return F.scaled_dot_product_attention(qt, kv_k, kv_v,
                                              attn_mask=mask, scale=scale,
                                              enable_gqa=True)
    return call


def sdpa_over_view(q, k, v, tables, starts, nb, window=0, scale=None,
                   k_scales=None, v_scales=None):
    """SDPA over the gathered view of the paged pool (an int8 pool
    dequantized to q's dtype) — the paged gather itself is not timed."""
    import torch
    from production_stack_tpu_torch.models.kv import gather_view, \
        gather_view_q
    T = q.shape[1]
    qpos = starts.long()[:, None] + torch.arange(T, device=q.device)
    if k_scales is not None:
        kv = (gather_view_q(k, k_scales, tables, nb, q.dtype),
              gather_view_q(v, v_scales, tables, nb, q.dtype))
    else:
        kv = gather_view(k, tables, nb), gather_view(v, tables, nb)
    return sdpa_call(q, *kv, qpos, window, scale)


def flex_over_view(q, k, v, tables, starts, nb, window, scale, softcap):
    """The library yardstick for Gemma-2's rows, which SDPA cannot
    compute (it applies no softcap): torch.nn.attention.flex_attention,
    compiled (once per shape), over the same gathered view of the paged
    pool as sdpa_over_view, with a tanh softcap score_mod and a causal
    mask_mod that also drops keys at or past `window` behind the query
    (window 0: none). The mods are module functions reading the call's
    positions, window and cap from module globals, so every call of one
    shape (both layer kinds) shares one compiled kernel. Returns (call,
    output of one call)."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)
    from production_stack_tpu_torch.models.kv import gather_view
    global _FLEX, _FLEX_QPOS, _FLEX_WIN, _FLEX_CAP
    if _FLEX is None:
        _FLEX = torch.compile(flex_attention, dynamic=False)
    B, T, H, D = q.shape
    kt = gather_view(k, tables, nb).transpose(1, 2).contiguous()
    vt = gather_view(v, tables, nb).transpose(1, 2).contiguous()
    S = kt.shape[2]
    _FLEX_QPOS = starts.long()[:, None] + torch.arange(T, device=q.device)
    _FLEX_WIN = torch.tensor(window or (1 << 30), device=q.device)
    _FLEX_CAP = float(softcap)
    block_mask = create_block_mask(_flex_mask, B, None, T, S,
                                   device=q.device)
    qt = q.transpose(1, 2).contiguous()

    def call(i=0):
        return _FLEX(qt, kt, vt, score_mod=_flex_softcap,
                     block_mask=block_mask, scale=scale, enable_gqa=True)
    return call, call().transpose(1, 2)


def _flex_mask(b, h, q_idx, kv_idx):
    p = _FLEX_QPOS[b, q_idx]
    return (kv_idx <= p) & (kv_idx > p - _FLEX_WIN)


def _flex_softcap(score, b, h, q_idx, kv_idx):
    return _FLEX_CAP * (score / _FLEX_CAP).tanh()


_FLEX = _FLEX_QPOS = _FLEX_WIN = None
_FLEX_CAP = 0.0


def paged_checks(pa):
    """Each paged case against the plain version, at TOL."""
    import torch
    fns = {"decode": pa.paged_decode_attention,
           "prefill": pa.paged_attention}
    # (kernel, T, Hkv, G, D, Bs, lens, window, softcap, q scale, v scale)
    llama_rows, long_rows = [70, 5, 300, 0], [300, 170, 517, 45]
    gemma_rows = [4600, 10, 2000, 0]
    cases = []
    for T in (1, 5, 8):
        cases.append(("decode", T, 8, 4, 128, 64, llama_rows, 0, 0.0, 1.0,
                      1.0))
    cases += [
        ("decode", 8, 2, 8, 64, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("prefill", 9, 8, 4, 128, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("prefill", 512, 8, 4, 128, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("prefill", 40, 2, 8, 64, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        # D = 256 with G = 2 (Gemma-2-9B); T = 100 leaves a ragged tile
        ("decode", 1, 8, 2, 256, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("decode", 8, 8, 2, 256, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("prefill", 100, 8, 2, 256, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        # a window of 40 over blocks of 16, rows well past it
        ("decode", 5, 2, 4, 128, 16, long_rows, 40, 0.0, 1.0, 1.0),
        ("prefill", 70, 2, 4, 128, 16, long_rows, 40, 0.0, 1.0, 1.0),
        # q x 30: raw scores reach about +-100, the cap of 50 bites. The
        # softmax then sits on a few keys and the output is close to one
        # V row; V at half scale keeps it within the +-4 that the bf16
        # tolerance assumes (a bf16 ulp is 2^-5 from 4 up)
        ("decode", 1, 4, 2, 256, 64, llama_rows, 0, 50.0, 30.0, 0.5),
        ("prefill", 64, 4, 2, 256, 64, llama_rows, 0, 50.0, 30.0, 0.5),
        # all three together at Gemma's block size, window 100
        ("decode", 8, 8, 2, 256, 64, long_rows, 100, 50.0, 30.0, 0.5),
        ("prefill", 96, 8, 2, 256, 64, long_rows, 100, 50.0, 30.0, 0.5),
        # the split decode: rows of 72 blocks and of 1 block in one batch
        # (24 splits of 3 blocks); T = 8 with split boundaries (every 2
        # blocks of 16) inside a window of 100; Gemma-2's window of 4096
        ("decode", 1, 8, 2, 256, 64, gemma_rows, 0, 0.0, 1.0, 1.0),
        ("decode", 8, 2, 4, 128, 16, long_rows, 100, 0.0, 1.0, 1.0),
        ("decode", 1, 8, 2, 256, 64, gemma_rows, 4096, 50.0, 30.0, 0.5),
        # the wgmma prefill at G = 2, 4, 8 with T not a multiple of its
        # 64-row tile, and past a window of 4096
        ("prefill", 100, 2, 4, 128, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("prefill", 37, 2, 8, 64, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("prefill", 96, 8, 2, 256, 64, [4550, 4100, 300, 0], 4096, 50.0,
         30.0, 0.5),
        # G = 1 (MHA): Qwen1.5-MoE (16 kv heads, D = 128) and Gemma-7B
        # (D = 256); the bf16 prefill tile holds 64 positions of one head
        ("decode", 1, 16, 1, 128, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("decode", 8, 16, 1, 128, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("prefill", 130, 16, 1, 128, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("decode", 1, 4, 1, 256, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("prefill", 100, 4, 1, 256, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        # G = 7: Qwen2-7B, 28 q heads over 4 kv heads; the prefill tile
        # has 63 live rows (block_q 9), decode R = 7 rows per kv head
        ("decode", 1, 4, 7, 128, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("decode", 8, 4, 7, 128, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("prefill", 100, 4, 7, 128, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        # Mistral-7B-v0.1: the 4096 window at G = 4, D = 128
        ("decode", 1, 8, 4, 128, 64, gemma_rows, 4096, 0.0, 1.0, 1.0),
        ("prefill", 96, 8, 4, 128, 64, [4550, 4100, 300, 0], 4096, 0.0,
         1.0, 1.0),
        # one tensor-parallel rank's heads: Llama-3-8B at tp 2, 4 and 8
        # (Hkv 4, 2, 1 at G = 4, D = 128: a decode grid of (B, 1,
        # splits) at tp 8), Gemma-2-9B at tp 2 (Hkv 4, G = 2, D = 256,
        # window and softcap)
        ("decode", 1, 4, 4, 128, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("prefill", 512, 4, 4, 128, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("decode", 1, 2, 4, 128, 64, gemma_rows, 0, 0.0, 1.0, 1.0),
        ("decode", 1, 1, 4, 128, 64, gemma_rows, 0, 0.0, 1.0, 1.0),
        ("decode", 8, 1, 4, 128, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("prefill", 512, 1, 4, 128, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("decode", 1, 4, 2, 256, 64, gemma_rows, 4096, 50.0, 30.0, 0.5),
        ("prefill", 100, 4, 2, 256, 64, [4550, 4100, 300, 0], 4096, 50.0,
         30.0, 0.5),
        # Qwen1.5-MoE at ep 2 x tp 2: 8 heads a rank, G = 1
        ("decode", 1, 8, 1, 128, 64, llama_rows, 0, 0.0, 1.0, 1.0),
        ("prefill", 130, 8, 1, 128, 64, llama_rows, 0, 0.0, 1.0, 1.0),
    ]
    # every case over a pool of q's dtype, then over an int8 pool with its
    # scales (V's scales times the case's V scale)
    i = 0
    for kv in ("native", "int8"):
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            for kind, T, Hkv, G, D, Bs, lens, w, cap, qx, vx in cases:
                i += 1
                q, k, v, tables, starts, nb = paged_case(
                    4, T, Hkv, G, D, Bs, lens, dtype, parked=1, seed=i)
                q = (q.float() * qx).to(dtype)
                sc = {}
                if kv == "int8":
                    k, v, ks, vs = int8_pools(k, v, tables, starts, T, i)
                    sc = dict(k_scales=ks[0], v_scales=vs[0] * vx)
                else:
                    v = (v.float() * vx).to(dtype)
                fn = fns[kind]
                got = fn(q, k[0], v[0], tables, starts, nb=nb, window=w,
                         softcap=cap, **sc)
                torch.cuda.synchronize()
                want = pa.paged_attention_plain(
                    q.float() if sc else q, k[0], v[0], tables, starts, nb,
                    D ** -0.5, w, cap, **sc)
                err = (got.float() - want.float()).abs().max().item()
                ok = bool(torch.isfinite(got).all()) and err <= TOL[dt]
                rec = {"check": fn.__name__, "kv": kv, "T": T, "Hkv": Hkv,
                       "G": G, "D": D, "Bs": Bs, "starts": starts.tolist(),
                       "window": w, "softcap": cap, "q_scale": qx,
                       "v_scale": vx, "dtype": dt,
                       "parked_rows": 1, "max_abs_err": err, "tol": TOL[dt],
                       "ok": ok}
                if cap:
                    kb = k[0][tables[0, 0].long(), 0].float()
                    if sc:
                        kb = kb * sc["k_scales"][tables[0, 0].long(), 0,
                                                 :, None]
                    qf = q[0, :, :G].float() * D ** -0.5
                    rec["max_raw_score"] = (qf @ kb.T).abs().max().item()
                log(json.dumps(rec))
                if not ok:
                    raise AssertionError(f"{fn.__name__} disagrees with its "
                                         f"plain version: {rec}")
                del q, k, v, sc
    bucket_checks(pa)


# the decode kernel at the batch buckets below max_num_seqs that the
# engine's adaptive windows launch it at (B, T): Llama-3-8B's heads
BUCKET_CASES = ((1, 1), (1, 8), (2, 1), (2, 8))


def bucket_checks(pa) -> list:
    """The decode kernel over the first B rows of a 4-row table (the
    runner cuts the tables, q and the starts to the window's batch
    bucket) against the plain version on the same rows, at TOL, over a
    bf16, an f32 and an int8 pool; one row of the 2-row cases is
    parked."""
    import torch
    out = []
    i = 500
    for kv in ("native", "int8"):
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            for B, T in BUCKET_CASES:
                i += 1
                q, k, v, tables, starts, nb = paged_case(
                    4, T, 8, 4, 128, 64, [431, 57, 200, 400], dtype,
                    parked=3 if B == 2 else 0, seed=i)
                q, tables, starts = q[:B], tables[:B], starts[:B]
                sc = {}
                if kv == "int8":
                    k, v, ks, vs = int8_pools(k, v, tables, starts, T, i)
                    sc = dict(k_scales=ks[0], v_scales=vs[0])
                got = pa.paged_decode_attention(q, k[0], v[0], tables,
                                                starts, nb=nb, **sc)
                torch.cuda.synchronize()
                want = pa.paged_attention_plain(
                    q.float() if sc else q, k[0], v[0], tables, starts, nb,
                    128 ** -0.5, 0, 0.0, **sc)
                err = (got.float() - want.float()).abs().max().item()
                ok = bool(torch.isfinite(got).all()) and err <= TOL[dt]
                rec = {"check": "paged_decode_attention", "batch": B,
                       "table_rows": 4, "kv": kv, "T": T, "dtype": dt,
                       "starts": starts.tolist(), "max_abs_err": err,
                       "tol": TOL[dt], "ok": ok}
                log(json.dumps(rec))
                out.append(rec)
                if not ok:
                    raise AssertionError(f"the decode kernel at batch {B} "
                                         f"disagrees with its plain "
                                         f"version: {rec}")
                del q, k, v, sc
    return out


# (T, Hkv, G, D, lens, window, softcap) of the one-launch check, at nb =
# the longest row's blocks: Llama-3-8B's decode step and verify window
# (B = 4, 7 splits) and Gemma-2-9B's verify window (32 splits at nb 126),
# each over a bf16 and an int8 pool
LAUNCH_CASES = (
    (1, 8, 4, 128, [200, 431, 57, 400], 0, 0.0),
    (4, 8, 4, 128, [200, 431, 57, 400], 0, 0.0),
    (4, 8, 2, 256, [4600, 1000, 57, 8000], 4096, 50.0),
)


def decode_launch_checks(pa) -> list:
    """Each of LAUNCH_CASES once under torch.profiler (device_profile):
    a bf16-q decode call must be exactly one device kernel, the
    tensor-core decode kernel (its splits merged by their last block), and
    agree with the plain version at TOL."""
    import torch
    out = []
    i = 700
    for kv in ("native", "int8"):
        for T, Hkv, G, D, lens, w, cap in LAUNCH_CASES:
            i += 1
            q, k, v, tables, starts, nb = paged_case(
                4, T, Hkv, G, D, 64, lens, torch.bfloat16, seed=i)
            sc = {}
            if kv == "int8":
                k, v, ks, vs = int8_pools(k, v, tables, starts, T, i)
                sc = dict(k_scales=ks[0], v_scales=vs[0])

            def call():
                return pa.paged_decode_attention(
                    q, k[0], v[0], tables, starts, nb=nb, window=w,
                    softcap=cap, **sc)
            prof = device_profile(call)
            got = call()
            torch.cuda.synchronize()
            want = pa.paged_attention_plain(
                q.float() if sc else q, k[0], v[0], tables, starts, nb,
                D ** -0.5, w, cap, **sc)
            err = (got.float() - want.float()).abs().max().item()
            names = ({n: c for n, (_, c) in prof["by_name"].items()}
                     if prof else None)
            ok = (names is not None and sum(names.values()) == 1
                  and "paged_decode_mma_kernel" in next(iter(names))
                  and bool(torch.isfinite(got).all())
                  and err <= TOL["bfloat16"])
            rec = {"check": "decode_one_launch", "kv": kv, "T": T, "G": G,
                   "D": D, "nb": nb, "splits": pa.decode_split_plan(nb)[1],
                   "device_kernels": names, "max_abs_err": err,
                   "tol": TOL["bfloat16"], "ok": ok}
            log(json.dumps(rec))
            out.append(rec)
            if not ok:
                raise AssertionError(f"a bf16 decode call is not one launch "
                                     f"of the decode kernel, or disagrees "
                                     f"with its plain version: {rec}")
            del q, k, v, sc
    return out


# rolled-table cases (kernel, T, Hkv, G, D, Bs, rows, window): the
# decode windows and verify chunks of a model with a window on every
# layer, after the engine freed the blocks behind each row's window
ROLLED_CASES = (
    ("decode", 1, 2, 4, 128, 16, [300, 170, 517, 45], 40),
    ("decode", 8, 2, 4, 128, 16, [300, 170, 517, 45], 40),
    ("prefill", 9, 2, 4, 128, 16, [300, 170, 517, 45], 40),
    ("prefill", 70, 2, 4, 128, 16, [300, 170, 517, 45], 40),
    # Mistral's geometry: a 4,600-token row has rolled 7 blocks of 64
    ("decode", 1, 8, 4, 128, 64, [4600, 10, 2000, 0], 4096),
    ("decode", 8, 8, 4, 128, 64, [4600, 10, 2000, 0], 4096),
)
# what the rolled cases write into trash block 0, finite and far from
# any real value: read without its mask, it would dominate the output
TRASH_VALUE = 1.0e4


def rolled_checks(pa):
    """Each of ROLLED_CASES over a rolled table — every block wholly
    behind its row's first query's window (keep_from = (start - W + 1) //
    Bs, the engine's _roll_windows) and the parked row's whole row point
    at trash block 0, filled with TRASH_VALUE (int8: 127 with scales of
    TRASH_VALUE / 127) — against the plain version of the same rows over
    the intact table, at TOL; both dtypes, over a pool of q's dtype and
    over an int8 pool."""
    import torch
    fns = {"decode": pa.paged_decode_attention,
           "prefill": pa.paged_attention}
    i = 500
    for kv in ("native", "int8"):
        for dt in ("float32", "bfloat16"):
            dtype = getattr(torch, dt)
            for kind, T, Hkv, G, D, Bs, lens, w in ROLLED_CASES:
                i += 1
                q, k, v, tables, starts, nb = paged_case(
                    4, T, Hkv, G, D, Bs, lens, dtype, parked=1, seed=i)
                sc = {}
                if kv == "int8":
                    k, v, ks, vs = int8_pools(k, v, tables, starts, T, i)
                    sc = dict(k_scales=ks[0], v_scales=vs[0])
                    for pool, scales in ((k, ks), (v, vs)):
                        pool[:, 0] = 127
                        scales[:, 0] = TRASH_VALUE / 127
                else:
                    k[:, 0] = TRASH_VALUE
                    v[:, 0] = TRASH_VALUE
                rolled = tables.clone()
                MB = tables.shape[1]
                for b, s_ in enumerate(starts.tolist()):
                    keep = (MB if s_ >= MB * Bs
                            else max(s_ - w + 1, 0) // Bs)
                    rolled[b, :keep] = 0
                got = fns[kind](q, k[0], v[0], rolled, starts, nb=nb,
                                window=w, **sc)
                torch.cuda.synchronize()
                want = pa.paged_attention_plain(
                    q.float() if sc else q, k[0], v[0], tables, starts, nb,
                    D ** -0.5, w, 0.0, **sc)
                err = (got.float() - want.float()).abs().max().item()
                ok = bool(torch.isfinite(got).all()) and err <= TOL[dt]
                rec = {"check": fns[kind].__name__ + "_rolled", "kv": kv,
                       "T": T, "Hkv": Hkv, "G": G, "D": D, "Bs": Bs,
                       "starts": starts.tolist(), "window": w, "dtype": dt,
                       "rolled_blocks": (rolled == 0).sum(dim=1).tolist(),
                       "max_abs_err": err, "tol": TOL[dt], "ok": ok}
                log(json.dumps(rec))
                if not ok:
                    raise AssertionError(f"{fns[kind].__name__} over a "
                                         f"rolled table disagrees with "
                                         f"the intact one: {rec}")
                del q, k, v, sc


# flash cases (D, G, T, S, starts) over B = 3 rows and 2 kv heads: G in
# {1, 2, 3, 4, 8} (3 does not divide the 128-row tile), T*G off that
# tile, S off the K/V panel (64 or 128 keys), rows whose positions pass
# S - 1, S < 64 (a single ragged panel), and 192 tiles, more than an H100
# has SMs
FLASH_CASES = (
    (64, 2, 37, 200, [0, 100, 180]),
    (128, 1, 300, 700, [0, 250, 400]),
    (128, 4, 1000, 1100, [0, 50, 100]),
    (128, 3, 50, 200, [0, 100, 163]),
    (128, 4, 37, 200, [0, 100, 180]),
    (128, 8, 37, 200, [0, 100, 163]),
    (128, 4, 1, 130, [129, 64, 0]),
    (128, 4, 20, 40, [0, 10, 30]),
    (256, 2, 37, 200, [0, 100, 180]),
    (256, 2, 300, 700, [0, 250, 400]),
)


def flash_checks(fa):
    """Each of FLASH_CASES against the plain version, float32 and
    bfloat16, at TOL; raises after logging every case if any
    disagrees."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(7)
    bad = []
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        for D, G, T, S, starts in FLASH_CASES:
            B, Hkv = len(starts), 2

            def rnd(*shape):
                return torch.randn(shape, generator=g,
                                   device="cuda").to(dtype)
            q = rnd(B, T, Hkv * G, D)
            k, v = rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
            st = torch.tensor(starts, dtype=torch.int32, device="cuda")
            got = fa.flash_attention_with_cache(q, k, v, st)
            torch.cuda.synchronize()
            want = fa.flash_attention_plain(q, k, v, st)
            err = (got.float() - want.float()).abs().max().item()
            ok = bool(torch.isfinite(got).all()) and err <= TOL[dt]
            rec = {"check": "flash_attention_with_cache", "T": T, "S": S,
                   "Hkv": Hkv, "G": G, "D": D, "starts": starts,
                   "dtype": dt, "max_abs_err": err, "tol": TOL[dt],
                   "ok": ok}
            log(json.dumps(rec))
            if not ok:
                bad.append(rec)
    if bad:
        raise AssertionError(f"flash kernel disagrees with its plain "
                             f"version: {bad}")


def _record(name, source, replaces, path, err, ms, plain_ms, library_ms,
            byts, flops, shape):
    t_bytes, t_ops = byts / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
    bound = max(t_bytes, t_ops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path, "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_share": bound / ms, "library_ms": library_ms,
            "shape": shape}


PAGED_SOURCE = "production_stack_tpu_torch/csrc/paged_attention.cu"
REPLACES = {
    "paged_decode_attention": "production_stack_tpu/ops/pallas_paged.py:325",
    "paged_attention": "production_stack_tpu/ops/pallas_paged.py:75",
    "flash_attention_with_cache":
        "production_stack_tpu/ops/pallas_attention.py:120",
}


def paged_timings(pa, model, kv, path, verify=False, tp=1, batch=None,
                  assembled=False, kernels=None, decode_T=None):
    """Both paged kernels at one served model's shapes: a decode step of
    the whole batch (T=1) and a 512-token prefill chunk of one row with
    the others parked, at the model's softcap and scale, bf16 q over a
    bf16 pool or (kv "int8") an int8 pool with its scales; for a model
    with sliding layers once at each layer kind (its window, then none),
    else once. Each row holds the kernel against its plain version on the
    timed inputs (TOL; over an int8 pool the plain version in f32), and
    names in `path` the serving path whose launches main() reports (None:
    no path serves these shapes with this pool) and in `layers` the layer
    kind. Over an int8 pool no PyTorch call attends, so library_ms is
    null and SDPA over the dequantized bf16 view is logged beside it;
    with a softcap over a bf16 pool, flex_attention is the library call
    (flex_over_view; null with flex_error where it fails).
    verify: the speculative verify windows instead — the decode kernel
    at T = 4 (spec 3) over the whole batch and, for Llama-3-8B, the
    prefill kernel at T = 9 (spec 8), rows at decode_starts; their
    launches come from the speculative serving run (spec_phase).
    tp: one tensor-parallel rank's shapes, H / tp q heads over Hkv / tp
    kv heads (the parallel phase's; G unchanged).
    batch: the decode kernel alone at a batch bucket of the engine's
    adaptive windows (the first `batch` rows at decode_starts); its
    launches are the windows phase's decode steps at that batch. Another
    decode row's launches are its serving run's decode steps (T = 1) at
    the row's batch (the wrapper's step_launches); a parallel serving
    run's rows are at its engine's max_num_seqs; a parallel engine's
    verify windows are its own speculation's (PARALLEL's serve).
    assembled: the kernel reads, as a dp > 1 engine's ranks do, the copy
    of every row's first nb blocks assembled from the pool (B * nb
    blocks, pa.assembled_tables), and is held against the plain version
    over the pool itself. kernels: the wrappers to time (default both).
    decode_T: the decode kernel alone at that query-window length over
    the whole batch (rows at decode_starts), a shape no path serves."""
    import torch
    from production_stack_tpu_torch.models.config import get_config
    from production_stack_tpu_torch.models.llama import attn_scale
    cfg, p = (get_config(path_model(model)),
              PATHS.get(model) or KERNEL_ONLY[model])
    # a parallel serving run's rows at its engine's batch
    serve = (PARALLEL[path_model(model)]["serve"]
             if str(path).startswith("parallel:") else p["serve"])
    B, Bs = batch or serve["max_num_seqs"], serve["kv_block_size"]
    rows = p["decode_starts"][:B]
    Hkv, G, D = cfg.num_kv_heads // tp, cfg.num_heads // cfg.num_kv_heads, \
        cfg.head_dim_
    L = p["timing_layers"]
    # Gemma-2's two layer kinds; a window on every layer (Mistral) is
    # one kind, windowed
    kinds = ([("sliding", cfg.sliding_window), ("global", 0)]
             if cfg.alternating_sliding
             else [("all", cfg.sliding_window or 0)])
    shapes = {
        "paged_decode_attention": (1, rows, 0, 64, 101),
        "paged_attention": (512, [p["chunk_start"]] * B, B - 1, 8, 102),
    }
    if batch:
        shapes = {"paged_decode_attention": (1, rows, 0, 64, 106 + batch)}
    if verify:
        specs = ((serve["speculative_ngram_tokens"],)
                 if str(path).startswith("parallel:")
                 else SPEC.get(model, ()))
        shapes = {"paged_decode_attention": (4, rows, 0, 64, 104)}
        if 8 in specs:
            shapes["paged_attention"] = (9, rows, 0, 64, 105)
    if decode_T:
        shapes = {"paged_decode_attention": (decode_T, rows, 0, 64,
                                             110 + decode_T)}
    if kernels:
        shapes = {name: shapes[name] for name in kernels}
    records = []
    for name, (T, lens, parked, it, seed) in shapes.items():
        q, k, v, tables, starts, nb = paged_case(
            B, T, Hkv, G, D, Bs, lens, torch.bfloat16, layers=L,
            parked=parked, seed=seed)
        sc = [{}] * L
        if kv == "int8":
            k, v, ks, vs = int8_pools(k, v, tables, starts, T, seed)
            sc = [dict(k_scales=ks[i], v_scales=vs[i]) for i in range(L)]
        MB = tables.shape[1]
        nb = min(p["kv_len"] // Bs, MB)
        fn = getattr(pa, name)
        # what the kernel reads: the pool, or the copy a dp engine's
        # ranks assemble of every row's first nb blocks
        run_k, run_v, run_sc, run_tables = k, v, sc, tables
        if assembled:
            idx = tables[:, :nb].long()

            def copy(t):
                return t[:, idx].flatten(1, 2).contiguous()
            run_k, run_v = copy(k), copy(v)
            if kv == "int8":
                cks, cvs = copy(ks), copy(vs)
                run_sc = [dict(k_scales=cks[i], v_scales=cvs[i])
                          for i in range(L)]
            run_tables = pa.assembled_tables(B, nb, MB, "cuda")
        for layers, window in kinds:
            kw = dict(scale=attn_scale(cfg), window=window,
                      softcap=cfg.attn_logit_softcap or 0.0)
            got = fn(q, run_k[0], run_v[0], run_tables, starts, nb=nb, **kw,
                     **run_sc[0])
            want = pa.paged_attention_plain(
                q.float() if sc[0] else q, k[0], v[0], tables, starts, nb,
                kw["scale"], kw["window"], kw["softcap"], **sc[0])
            err = (got.float() - want.float()).abs().max().item()
            shape = {"B": B, "T": T, "H": Hkv * G, "Hkv": Hkv, "D": D,
                     "Bs": Bs, "nb": nb, "starts": starts.tolist(),
                     "dtype": "bfloat16", "kv_dtype": kv, **kw}
            if not (bool(torch.isfinite(got).all())
                    and err <= TOL["bfloat16"]):
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version at {model}'s timed shape: "
                                     f"err {err}, {shape}")
            del got, want
            ms = device_ms(lambda i=0: fn(q, run_k[i % L], run_v[i % L],
                                          run_tables, starts, nb=nb, **kw,
                                          **run_sc[i % L]), it)
            plain_ms = device_ms(lambda i=0: pa.paged_attention_plain(
                q, k[i % L], v[i % L], tables, starts, nb, kw["scale"],
                kw["window"], kw["softcap"], **sc[i % L]), it)
            sdpa = sdpa_over_view(q, k[0], v[0], tables, starts, nb,
                                  kw["window"], kw["scale"], **sc[0])
            sdpa_ms = device_ms(sdpa, it)
            del sdpa
            byts, flops = work(q, starts, nb, MB, Bs, Hkv, D, 2,
                               kw["window"], kv_itemsize=k.element_size())
            # SDPA computes the same function only without a softcap and
            # over a bf16 pool; with the softcap over a bf16 pool,
            # flex_attention does (null, with the error, where it fails)
            library_ms, flex = (None if kw["softcap"] or sc[0]
                                else sdpa_ms), {}
            if kw["softcap"] and not sc[0]:
                t_flex = time.monotonic()
                try:
                    call, got = flex_over_view(
                        q, k[0], v[0], tables, starts, nb, kw["window"],
                        kw["scale"], kw["softcap"])
                    live = starts < MB * Bs
                    want = fn(q, k[0], v[0], tables, starts, nb=nb, **kw)
                    flex["flex_err_vs_kernel"] = (
                        got[live].float() - want[live].float()).abs().max(
                    ).item()
                    del got, want
                    library_ms = device_ms(call, it)
                    del call
                except Exception as e:   # the row keeps null, with why
                    flex["flex_error"] = f"{type(e).__name__}: {e}"[:600]
                free_memory()
                flex["flex_s"] = time.monotonic() - t_flex
            rec = _record(name, PAGED_SOURCE, REPLACES[name], path, err,
                          ms, plain_ms, library_ms, byts, flops, shape)
            rec.update(flex)
            rec["layers"] = layers
            rec["kv_dtype"] = kv
            rec["shapes_of"] = model
            rec["tp"] = tp
            if verify:
                rec["verify_T"] = T
            if batch:
                rec["batch"] = batch
            if decode_T:
                rec["decode_T"] = decode_T
            if assembled:
                rec["layout"] = "assembled"
            # the yardstick where library_ms is null: SDPA without the
            # softcap, over the bf16 pool or the dequantized bf16 view
            rec["sdpa_ms"] = sdpa_ms
            log(json.dumps({"timing": rec}))
            records.append(rec)
        del q, k, v, sc, run_k, run_v, run_sc
        free_memory()
    return records


def flash_timing(fa):
    """The flash kernel, its plain version and SDPA with a boolean mask
    over the same cache, bf16, starts [0, 128, 256, 512], S = 1024, at
    q [4, 512, 32, 128] (cache [4, 1024, 8, 128]) and q [4, 512, 16, 256]
    (cache [4, 1024, 8, 256]); the kernel held against its plain version
    on these inputs (TOL)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(103)
    B, T, Hkv, S = 4, 512, 8, 1024
    records = []
    for H, D in ((32, 128), (16, 256)):
        def rnd(*shape):
            return torch.randn(shape, generator=g,
                               device="cuda").to(torch.bfloat16)
        q, k, v = rnd(B, T, H, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
        starts = torch.tensor([0, 128, 256, 512], dtype=torch.int32,
                              device="cuda")
        got = fa.flash_attention_with_cache(q, k, v, starts)
        err = (got.float() - fa.flash_attention_plain(q, k, v, starts)
               .float()).abs().max().item()
        if not (bool(torch.isfinite(got).all())
                and err <= TOL["bfloat16"]):
            raise AssertionError(f"flash kernel disagrees with its plain "
                                 f"version at the timed shape D = {D}: "
                                 f"err {err}")
        del got
        it = 8
        ms = device_ms(lambda i=0: fa.flash_attention_with_cache(
            q, k, v, starts), it)
        plain_ms = device_ms(lambda i=0: fa.flash_attention_plain(
            q, k, v, starts), it)
        qpos = starts.long()[:, None] + torch.arange(T, device="cuda")
        library_ms = device_ms(sdpa_call(q, k, v, qpos), it)
        byts, flops = flash_work(q, starts, S, Hkv, D, 2)
        rec = _record("flash_attention_with_cache",
                      "production_stack_tpu_torch/csrc/flash_attention.cu",
                      REPLACES["flash_attention_with_cache"], None, err, ms,
                      plain_ms, library_ms, byts, flops,
                      {"B": B, "T": T, "H": H, "Hkv": Hkv, "D": D, "S": S,
                       "starts": starts.tolist(), "dtype": "bfloat16"})
        log(json.dumps({"timing": rec}))
        records.append(rec)
        del q, k, v
        free_memory()
    return records


def kernel_phase():
    from production_stack_tpu_torch.ops import flash_attention as fa
    from production_stack_tpu_torch.ops import paged_attention as pa
    paged_checks(pa)
    rolled_checks(pa)
    flash_checks(fa)
    decode_launch_checks(pa)
    free_memory()
    records = []
    for model in ("llama-3-8b", "gemma-2-9b", "qwen1.5-moe-a2.7b",
                  "mistral-7b-v0.1", "mixtral-8x7b-int8"):
        records += paged_timings(pa, model, "bfloat16", model)
    # Qwen2-7B's G = 7, which no path serves (no launches), at T = 1 and
    # at a verify window of 4 (28 query rows per kv head); Llama-3-8B's
    # decode at T = 2 and 8 (8 and 32 rows), which no path serves either
    records += paged_timings(pa, "qwen2-7b", "bfloat16", None)
    records += paged_timings(pa, "qwen2-7b", "bfloat16", None, decode_T=4)
    for T in (2, 8):
        records += paged_timings(pa, "llama-3-8b", "bfloat16", None,
                                 decode_T=T)
    # the int8 branches at both models' shapes; only Llama-3-8B is served
    # with an int8 pool, so the Gemma-2 rows name no path (no launches)
    records += paged_timings(pa, "llama-3-8b", "int8", "llama-3-8b-int8")
    records += paged_timings(pa, "gemma-2-9b", "int8", None)
    # the decode kernel at the batch buckets below max_num_seqs that the
    # windows phase's adaptive windows launch it at
    for batch in (1, 2):
        records += paged_timings(pa, WINDOWS["path"], "bfloat16",
                                 WINDOWS["path"], batch=batch)
    # the speculative verify windows the spec phase serves
    for model in SPEC:
        records += paged_timings(pa, model, "bfloat16", model, verify=True)
    # one rank's shapes in the parallel phase: Llama-3-8B at tp 2 (served
    # over a bf16 and an int8 pool), 4 and 8 (no path); Gemma-2-9B at
    # tp 2 (no path); Qwen1.5-MoE at ep 2, whose ranks keep every head,
    # and at ep 2 x tp 2 (8 heads a rank, G = 1)
    llama2 = dict(tensor_parallel_size=2)
    records += paged_timings(pa, "llama-3-8b", "bfloat16",
                             parallel_label("llama-3-8b", llama2), tp=2)
    records += paged_timings(pa, "llama-3-8b", "int8",
                             parallel_label("llama-3-8b", llama2, "int8"),
                             tp=2)
    for tp in (4, 8):
        records += paged_timings(pa, "llama-3-8b", "bfloat16", None, tp=tp)
    records += paged_timings(pa, "gemma-2-9b", "bfloat16", None, tp=2)
    for tp in (1, 2):
        records += paged_timings(
            pa, "qwen1.5-moe-a2.7b", "bfloat16",
            parallel_label("qwen1.5-moe-a2.7b", dict(
                expert_parallel_size=2, tensor_parallel_size=tp)), tp=tp)
    # Mixtral at ep 2: each rank keeps every head, at its engine's batch
    records += paged_timings(
        pa, "mixtral-8x7b-int8", "bfloat16",
        parallel_label("mixtral-8x7b", dict(expert_parallel_size=2)))
    # the tp = 2 Llama engine speculates (spec 3): its decode launches are
    # T = 4 verify windows; and the dp = 2 x tp = 2 engine, whose ranks
    # read the copy assembled over dp (its decode launches T = 4 too)
    dp_mesh = PARALLEL["llama-3-8b"]["dp_mesh"]
    for kv in ("bfloat16", "int8"):
        records += paged_timings(pa, "llama-3-8b", kv,
                                 parallel_label("llama-3-8b", llama2, kv),
                                 tp=2, verify=True)
        label = parallel_label("llama-3-8b", dp_mesh, kv)
        records += paged_timings(pa, "llama-3-8b", kv, label, tp=2,
                                 verify=True, assembled=True)
        records += paged_timings(pa, "llama-3-8b", kv, label, tp=2,
                                 assembled=True,
                                 kernels=("paged_attention",))
    records += flash_timing(fa)
    free_memory()
    return records


# ------------------------------------------------------------ serving

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def long_prompt_text(tokens: int) -> str:
    """A prompt of `tokens` tokens for the byte tokenizer (one per
    UTF-8 byte, after the BOS token)."""
    text = ("In the beginning the engine read every block of the pool "
            "once, and the pool was paged. ") * (tokens // 80 + 1)
    return text[:tokens - 1]


async def serve_phase(engine, path: str):
    """The OpenAI server in-process on `engine`, serving PATHS[path];
    every kernel launch count is zeroed just before the requests and read
    just after. Both paged kernels must have launched (with the window,
    the softcap and the int8 pool where the path has them), the flash
    kernel never (it serves no path, as in the JAX package)."""
    import aiohttp
    from aiohttp import web
    from production_stack_tpu_torch.engine.server import build_app
    from production_stack_tpu_torch.ops import flash_attention as fa
    from production_stack_tpu_torch.ops import moe
    from production_stack_tpu_torch.ops import paged_attention as pa

    # which MoE path each MLP call took while serving
    moe_paths = {"exact": 0, "dispatch": 0}
    originals = {"exact": moe._moe_exact, "dispatch": moe._moe_dispatch}

    def counted(kind):
        def call(*a, **kw):
            moe_paths[kind] += 1
            return originals[kind](*a, **kw)
        return call
    moe._moe_exact, moe._moe_dispatch = counted("exact"), counted("dispatch")
    port = free_port()
    runner = web.AppRunner(build_app(engine, api_key=""))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", port)
    await site.start()
    base = f"http://127.0.0.1:{port}"
    model = path_model(path)
    long_tokens = PATHS[path]["long_tokens"]
    try:
        async with aiohttp.ClientSession() as http:
            async def post(url, body):
                async with http.post(base + url, json=body) as r:
                    if r.status != 200:
                        raise AssertionError(
                            f"{url} -> {r.status}: {await r.text()}")
                    if body.get("stream"):
                        return [ln[6:] for ln in
                                (await r.text()).splitlines()
                                if ln.startswith("data: ")]
                    return await r.json()

            async with http.get(base + "/health") as r:
                assert r.status == 200, r.status
            greedy = {"model": model, "prompt": long_prompt_text(long_tokens),
                      "max_tokens": 24, "temperature": 0.0,
                      "ignore_eos": True, "logprobs": 0}
            reqs = [
                ("/v1/completions", greedy),
                ("/v1/chat/completions", {
                    "model": model, "max_tokens": 16, "temperature": 0.8,
                    "seed": 7, "ignore_eos": True, "logprobs": True,
                    "messages": [{"role": "user",
                                  "content": "Name three rivers."}]}),
                ("/v1/chat/completions", {
                    "model": model, "max_tokens": 16, "stream": True,
                    "ignore_eos": True,
                    "stream_options": {"include_usage": True},
                    "messages": [{"role": "user", "content": "Hello!"}]}),
                ("/v1/completions", {
                    "model": model, "prompt": "The capital of France is",
                    "max_tokens": 20, "top_p": 0.9, "top_k": 50,
                    "ignore_eos": True}),
            ]
            pa.reset_launch_counts()
            fa.reset_launch_counts()
            t0 = time.monotonic()
            results = await asyncio.gather(*(post(u, b) for u, b in reqs))
            again = await post("/v1/completions", greedy)
            wall = time.monotonic() - t0
            counts = {"launches": {**pa.launch_counts,
                                   **fa.launch_counts},
                      "window_launches": dict(pa.window_launches),
                      "softcap_launches": dict(pa.softcap_launches),
                      "int8_launches": dict(pa.int8_launches),
                      "step_launches": pa.launch_report()["step_launches"]}
            surface = await surface_phase(http, base, engine, path)
            if path == "llama-3-8b":
                surface["trace"] = await trace_phase(http, base, engine,
                                                     path)
            # last: a wrong index rule is a device-side assert that ends
            # the process
            await fault_probe(http, base, engine, path)
    finally:
        await runner.cleanup()
        moe._moe_exact, moe._moe_dispatch = (originals["exact"],
                                             originals["dispatch"])
    if path == "llama-3-8b":
        # its own application over the engine, once the first is gone
        # (an application starts and stops the engine loop)
        await auth_phase(engine, path)

    want = [24, 16, 16, 20]
    for (url, body), res, n in zip(reqs, results, want):
        if body.get("stream"):
            assert res[-1] == "[DONE]", res[-3:]
            chunks = [json.loads(x) for x in res[:-1]]
            got = chunks[-1]["usage"]["completion_tokens"]
            assert chunks[-2]["choices"][0]["finish_reason"] == "length"
        else:
            got = res["usage"]["completion_tokens"]
            assert res["choices"][0]["finish_reason"] == "length"
        assert got == n, (url, got, n)
    lps = results[0]["choices"][0]["logprobs"]["token_logprobs"]
    assert len(lps) == 24 and all(math.isfinite(x) and x <= 0 for x in lps)
    chat_lps = [e["logprob"] for e in
                results[1]["choices"][0]["logprobs"]["content"]]
    assert len(chat_lps) == 16 and all(math.isfinite(x) for x in chat_lps)
    # greedy twice: the same tokens (the logprobs block names each id)
    first_lp = results[0]["choices"][0]["logprobs"]
    again_lp = again["choices"][0]["logprobs"]
    assert again_lp["tokens"] == first_lp["tokens"], "greedy repeat differs"
    assert again["choices"][0]["text"] == results[0]["choices"][0]["text"]
    assert max(abs(a - b) for a, b in zip(again_lp["token_logprobs"],
                                          first_lp["token_logprobs"])) < 1e-3
    prompt_tokens = results[0]["usage"]["prompt_tokens"]
    assert prompt_tokens == long_tokens, (prompt_tokens, long_tokens)
    assert prompt_tokens > PATHS[path]["serve"]["prefill_chunk"]
    cfg = engine.engine.model_cfg
    need = ["launches"]
    if cfg.sliding_window:
        need.append("window_launches")
        # the long prompt's last prefill chunks and its decode skip blocks
        assert prompt_tokens > cfg.sliding_window + \
            PATHS[path]["serve"]["kv_block_size"], prompt_tokens
    if cfg.sliding_window and not cfg.alternating_sliding:
        # a window on every layer: every launch carries it
        if any(counts["window_launches"][name] != counts["launches"][name]
               for name in pa.launch_counts):
            raise AssertionError(f"a launch without the window on a model "
                                 f"windowed on every layer: {counts}")
    if cfg.num_experts:
        # prefill chunks (4 x 512 tokens) dispatch, decode is exact
        counts["moe_paths"] = moe_paths
        if not (moe_paths["exact"] and moe_paths["dispatch"]):
            raise AssertionError(f"the MoE did not take both paths while "
                                 f"serving: {moe_paths}")
    if cfg.attn_logit_softcap:
        need.append("softcap_launches")
    if engine.engine.cfg.kv_dtype == "int8":
        need.append("int8_launches")
    elif any(counts["int8_launches"].values()):
        raise AssertionError(f"int8 launches on a path without an int8 "
                             f"pool: {counts}")
    for kind in need:
        for name in pa.launch_counts:
            if counts[kind][name] <= 0:
                raise AssertionError(f"kernel {name} was not launched "
                                     f"({kind}) while serving: {counts}")
    for name in fa.launch_counts:
        if counts["launches"][name] != 0:
            raise AssertionError(f"kernel {name} serves no path but was "
                                 f"launched while serving: {counts}")
    log(json.dumps({"serve": {"path": path, "model": model,
                              "requests": len(reqs) + 1,
                              "wall_s": wall,
                              "long_prompt_tokens": prompt_tokens,
                              **counts}}))
    return counts, surface


# the /load fields signals.parse_load_report reads (the router, the
# autoscaler and the kvplane), and the gauges router/stats.py
# parse_engine_metrics reads
LOAD_FIELDS = ("queue_depth", "running", "capacity", "max_num_seqs",
               "est_queue_delay_ms", "kv_usage", "free_kv_blocks", "models",
               "perf", "kv_pool")
PERF_FIELDS = ("mbu_perc", "effective_bytes_per_s", "live_fraction",
               "decode_tokens_per_s", "token_steps", "compiles_total",
               "compile_in_flight")
ROUTER_GAUGES = ("vllm:num_requests_running", "vllm:num_requests_waiting",
                 "vllm:gpu_cache_usage_perc", "tpu:hbm_kv_usage_perc",
                 "vllm:gpu_prefix_cache_hit_rate",
                 "tpu:engine_capacity_seqs", "tpu:est_queue_delay_ms")
LOAD_HEADERS = ("x-engine-queue-depth", "x-engine-running",
                "x-engine-free-kv-blocks", "x-engine-est-queue-delay-ms")
# the shaped request: OpenAI penalties at the top of their ranges
SHAPED = {"presence_penalty": 1.5, "frequency_penalty": 1.0,
          "repetition_penalty": 1.3}
# prompts of the shaping and echo checks: token ids below 256 from a seed
SURFACE_PROMPT = 40


def surface_prompt(seed: int):
    import random
    rnd = random.Random(seed)
    return [256] + [rnd.randrange(32, 256) for _ in range(SURFACE_PROMPT - 1)]


@asynccontextmanager
async def engine_parked(eng, when):
    """Inside: the engine loop thread parks before the first step at which
    when() holds (read under the engine lock), until the block ends. The
    block starts its requests, then awaits park_wait on what it yields, so
    it reads the engine at a chosen moment of a request that is still
    running; a read that waits for the engine lock alone races the loop
    thread, which takes the lock again at once after each step and can
    keep it until the request has finished."""
    import threading
    step = eng.step
    parked, resume = threading.Event(), threading.Event()

    def parked_step():
        if not resume.is_set() and not parked.is_set():
            with eng._lock:
                now = when()
            if now:
                parked.set()
                resume.wait()
        return step()
    eng.step = parked_step
    try:
        yield parked
    finally:
        del eng.step
        resume.set()


async def park_wait(parked, timeout: float = 60.0) -> None:
    """Until the loop thread has parked (engine_parked), the event loop
    serving meanwhile."""
    if not await asyncio.get_running_loop().run_in_executor(
            None, parked.wait, timeout):
        raise AssertionError("the engine loop did not park")


async def surface_phase(http, base, engine, path: str) -> dict:
    """The engine surface the stack reads, on the served model, with the
    kernel counts zeroed before and read after (both paged kernels must
    launch, the flash kernel not):

    - llama-3-8b: /load while a request is in flight, its fields against
      the engine's own state (the engine lock held so both read one
      moment); /metrics parsed by prometheus_client's parser, with the
      router's seven gauges; an
      elapsed x-request-deadline-ms answers 504; /tokenize and
      /detokenize round-trip; logit_bias {65: 100} emits only 65;
      min_tokens 16 with EOS biased +100 emits 16 tokens, then EOS; the
      penalized greedy request (SHAPED) is kept for reference_phase;
      n = 3 with a seed (streamed and not) and two prompts give their
      choice indices;
    - llama-3-8b and gemma-2-9b: top_logprobs 5 in descending order
      with the greedy choice first, and echo with logprobs (one value
      per prompt token after the first), kept for reference_phase.

    Every reply must carry the four x-engine-* headers."""
    from prometheus_client.parser import text_string_to_metric_families
    from production_stack_tpu_torch.ops import flash_attention as fa
    from production_stack_tpu_torch.ops import paged_attention as pa
    model = path_model(path)
    eng = engine.engine
    out = {}
    if path not in ("llama-3-8b", "gemma-2-9b"):
        return out

    async def call(method, url, body=None, status=200, headers=None):
        async with http.request(method, base + url, json=body,
                                headers=headers) as r:
            text = await r.text()
            if r.status != status:
                raise AssertionError(f"{url} -> {r.status} (want "
                                     f"{status}): {text[:500]}")
            missing = [h for h in LOAD_HEADERS if h not in r.headers]
            if missing:
                raise AssertionError(f"{url}: no {missing} header")
            return r, text

    async def completion(body):
        _, text = await call("POST", "/v1/completions",
                             {"model": model, "temperature": 0.0, **body})
        return json.loads(text)

    pa.reset_launch_counts()
    fa.reset_launch_counts()
    t0 = time.monotonic()
    if path == "llama-3-8b":
        # /load and /metrics with a request in flight: the engine parked
        # once it has given the request a token (the stream's first bytes
        # may wait for more tokens: a token can end inside a character)
        def decoding():
            return any(s.output_tokens
                       for s in eng.scheduler.running.values())

        async def hold_request():
            async with http.post(base + "/v1/completions", json={
                    "model": model, "prompt": "hold", "max_tokens": 400,
                    "ignore_eos": True, "stream": True}) as r:
                await r.read()
                return r.status
        async with engine_parked(eng, decoding) as parked:
            hold = asyncio.ensure_future(hold_request())
            await park_wait(parked)
            with eng._lock:
                _, text = await call("GET", "/load")
                load = json.loads(text)
                want = {"running": len(eng.scheduler.running)
                        + len(eng.scheduler._prefilling),
                        "queue_depth": len(eng.scheduler.waiting),
                        "kv_usage": round(eng.block_mgr.usage, 4),
                        "free_kv_blocks": eng.block_mgr.available}
                _, metrics = await call("GET", "/metrics")
            missing = [k for k in LOAD_FIELDS if k not in load] + [
                k for k in PERF_FIELDS if k not in load["perf"]]
            got = {k: load[k] for k in want}
            if missing or got != want or want["running"] < 1 \
                    or want["kv_usage"] <= 0:
                raise AssertionError(f"/load {got} against the engine "
                                     f"{want}; missing {missing}")
            samples = {s.name: s.value for f in
                       text_string_to_metric_families(metrics)
                       for s in f.samples}
            absent = [g for g in ROUTER_GAUGES if g not in samples]
            if absent:
                raise AssertionError(f"/metrics lacks {absent}")
            if samples["vllm:num_requests_running"] < 1:
                raise AssertionError("/metrics shows no running request")
        status = await hold   # the engine runs on and finishes it
        if status != 200:
            raise AssertionError(f"the held request -> {status}")
        out["load"] = {**got, "perf_mbu_perc": load["perf"]["mbu_perc"],
                       "metric_names": len(samples)}
        r, _ = await call("POST", "/v1/completions",
                          {"model": model, "prompt": "late",
                           "max_tokens": 4}, status=504,
                          headers={"x-request-deadline-ms": "0"})
        assert r.headers.get("x-deadline-expired") == "1"
        _, text = await call("POST", "/tokenize",
                             {"prompt": "Hello, paged world"})
        ids = json.loads(text)["tokens"]
        _, text = await call("POST", "/detokenize", {"tokens": ids})
        assert json.loads(text)["prompt"] == "Hello, paged world", text
        # shaping
        prompt = surface_prompt(1)
        res = await completion({"prompt": prompt, "max_tokens": 12,
                                "logit_bias": {"65": 100}, "logprobs": 0})
        toks = res["choices"][0]["logprobs"]["tokens"]
        assert toks == ["A"] * 12, toks
        eos = eng.tokenizer.eos_token_id
        res = await completion({"prompt": prompt, "max_tokens": 40,
                                "min_tokens": 16, "logprobs": 0,
                                "logit_bias": {str(eos): 100}})
        ch = res["choices"][0]
        assert ch["finish_reason"] == "stop", ch
        assert len(ch["logprobs"]["tokens"]) == 16, ch
        assert res["usage"]["completion_tokens"] == 17, res["usage"]
        res = await completion({"prompt": prompt, "max_tokens": 24,
                                "ignore_eos": True, **SHAPED})
        assert res["usage"]["completion_tokens"] == 24
        seq = next(s for s in eng.seqs.values()
                   if s.prompt_tokens == prompt
                   and s.options.presence_penalty == SHAPED[
                       "presence_penalty"])
        out["shaped"] = {"prompt": prompt,
                         "tokens": list(seq.output_tokens)}
        # n and several prompts
        res = await completion({"prompt": "The river", "n": 3, "seed": 9,
                                "temperature": 0.8, "max_tokens": 8})
        assert [c["index"] for c in res["choices"]] == [0, 1, 2], res
        _, text = await call("POST", "/v1/completions", {
            "model": model, "prompt": "The river", "n": 3, "seed": 9,
            "temperature": 0.8, "max_tokens": 8, "stream": True})
        chunks = [json.loads(ln[6:]) for ln in text.splitlines()
                  if ln.startswith("data: ") and ln != "data: [DONE]"]
        finished = sorted(c["choices"][0]["index"] for c in chunks
                          if c["choices"][0]["finish_reason"])
        assert finished == [0, 1, 2], finished
        res = await completion({"prompt": ["One river", "Two rivers"],
                                "max_tokens": 6})
        assert [c["index"] for c in res["choices"]] == [0, 1], res
    # logprobs
    _, text = await call("POST", "/v1/chat/completions", {
        "model": model, "temperature": 0.0, "max_tokens": 8,
        "ignore_eos": True, "logprobs": True, "top_logprobs": 5,
        "messages": [{"role": "user", "content": "Name three rivers."}]})
    for e in json.loads(text)["choices"][0]["logprobs"]["content"]:
        tops = [t["logprob"] for t in e["top_logprobs"]]
        if len(tops) != 5 or tops != sorted(tops, reverse=True) \
                or abs(e["logprob"] - tops[0]) > 1e-6:
            raise AssertionError(f"top_logprobs entry {e}")
    prompt = surface_prompt(2)
    res = await completion({"prompt": prompt, "max_tokens": 1,
                            "echo": True, "logprobs": 1})
    lps = res["choices"][0]["logprobs"]["token_logprobs"]
    assert lps[0] is None and len(lps) == len(prompt) + 1, lps[:3]
    out["echo"] = {"prompt": prompt, "logprobs": lps[1:len(prompt)]}
    launches = {**pa.launch_counts, **fa.launch_counts}
    for name in pa.launch_counts:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"surface checks: {launches}")
    for name in fa.launch_counts:
        if launches[name]:
            raise AssertionError(f"kernel {name} serves no path but was "
                                 f"launched: {launches}")
    log(json.dumps({"surface": {
        "path": path, "seconds": time.monotonic() - t0,
        "launches": launches,
        **{k: v for k, v in out.items() if k == "load"}}}))
    return out


# the engine-side phases of a traced request, in order
TRACE_PHASES = ["preprocess", "queue_wait", "prefill", "decode",
                "postprocess"]


async def trace_phase(http, base, engine, path: str) -> dict:
    """Request tracing on the served model, the kernel counts zeroed
    before and read after (both paged kernels must launch): one
    non-streamed and one streamed completion, each with an inbound
    sampled traceparent. The non-streamed reply's x-trace-id (the
    stream's SSE headers) is the inbound trace id; /debug/traces?trace_id
    returns the engine's trace, parented on the inbound span, with the
    five phases in order and the tokenize event; the phase durations are
    printed beside the client's own TTFT (the stream's first token) and
    wall, with the unattributed time. /debug/perf?limit=5, read under the
    engine lock, holds the newest windows of the efficiency ring, which
    include these requests' windows, and a kv_pool equal to the block
    manager's frag_report() at that moment."""
    from production_stack_tpu_torch import tracing
    from production_stack_tpu_torch.ops import flash_attention as fa
    from production_stack_tpu_torch.ops import paged_attention as pa
    eng = engine.engine
    model = path_model(path)
    windows0 = eng.eff.report()["decode"]["windows"]
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    t_phase = time.monotonic()
    rows = []
    for stream in (False, True):
        tid, sid = tracing.new_trace_id(), tracing.new_span_id()
        # logprobs: every token is a chunk of the stream, text or not
        # (random weights pick ids the byte tokenizer gives no text)
        body = {"model": model, "prompt": long_prompt_text(300),
                "max_tokens": 24, "temperature": 0.0, "ignore_eos": True,
                "logprobs": 0, "stream": stream}
        t0 = time.monotonic()
        ttft = None
        async with http.post(base + "/v1/completions", json=body, headers={
                "traceparent": tracing.format_traceparent(tid, sid)}) as r:
            if r.status != 200:
                raise AssertionError(f"traced completion -> {r.status}: "
                                     f"{await r.text()}")
            got_tid = r.headers.get("x-trace-id")
            async for line in r.content:
                if ttft is None and line.startswith(b"data: "):
                    ttft = time.monotonic() - t0
        wall = time.monotonic() - t0
        async with http.get(base + "/debug/traces",
                            params={"trace_id": tid}) as r:
            traces = (await r.json())["traces"]
        if got_tid != tid or len(traces) != 1:
            raise AssertionError(f"trace {tid}: x-trace-id {got_tid}, "
                                 f"{len(traces)} traces in the ring")
        t = traces[0]
        phases = [x for x in t["spans"] if x["kind"] == "phase"]
        events = sorted(x["name"] for x in t["spans"]
                        if x["kind"] == "event")
        row = {"stream": stream, "trace_id": tid,
               "parent_ok": t["parent_id"] == sid, "status": t["status"],
               "phases_ms": {x["name"]: x["duration_ms"] for x in phases},
               "events": events, "duration_ms": t["duration_ms"],
               "unattributed_s": t["unattributed_ms"] / 1e3,
               "client_ttft_s": ttft if stream else None,
               "client_wall_s": wall,
               "output_tokens": t["attrs"].get("output_tokens")}
        rows.append(row)
        if (not row["parent_ok"] or row["status"] != "ok"
                or [x["name"] for x in phases] != TRACE_PHASES
                or events != ["tokenize"] or row["output_tokens"] != 24
                or row["duration_ms"] > 1e3 * wall):
            raise AssertionError(f"engine trace: {row}")
    launches = {**pa.launch_counts, **fa.launch_counts}
    with eng._lock:
        async with http.get(base + "/debug/perf?limit=5") as r:
            perf = await r.json()
        pool = eng.block_mgr.frag_report()
        ring = eng.eff.recent_windows(5)
    new_windows = perf["totals"]["decode"]["windows"] - windows0
    ring = [{k: round(v, 4) if isinstance(v, float) else v
             for k, v in w.items()} for w in ring]
    got = [{k: round(v, 4) if isinstance(v, float) else v
            for k, v in w.items()} for w in perf["windows"]]
    perf_ok = (perf["kv_pool"] == pool and got == ring and new_windows >= 1
               and len(got) == min(5, perf["totals"]["decode"]["windows"])
               and sum(w["real"] for w in got[-min(5, new_windows):]) > 0
               and perf["compiles"] == [])
    rec = {"path": path, "requests": rows, "launches": launches,
           "perf": {"windows_during": new_windows,
                    "returned": len(got), "kv_pool_equal":
                        perf["kv_pool"] == pool, "ring_equal": got == ring},
           "seconds": time.monotonic() - t_phase}
    log(json.dumps({"trace": rec}))
    if not perf_ok:
        raise AssertionError(f"/debug/perf {perf} against the engine's "
                             f"ring {ring} and pool {pool}")
    for name in pa.launch_counts:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"traced requests: {launches}")
    return rec


async def auth_phase(engine, path: str) -> dict:
    """API-key enforcement on the served engine: an application built
    with api_key="k" answers 401 on /v1/completions and /debug/traces
    without the key (no x-engine-* header, no trace id), 200 on /health,
    /metrics, /version and /load, and 200 with Authorization: Bearer k
    (a completion included)."""
    import aiohttp
    from aiohttp import web
    from production_stack_tpu_torch.engine.server import build_app
    port = free_port()
    runner = web.AppRunner(build_app(engine, api_key="k"))
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    base = f"http://127.0.0.1:{port}"
    body = {"model": path_model(path), "prompt": "Hello", "max_tokens": 4,
            "temperature": 0.0}
    got = {}
    try:
        async with aiohttp.ClientSession() as http:
            for key, headers in (("none", {}), ("right", {
                    "Authorization": "Bearer k"})):
                for method, url in (("POST", "/v1/completions"),
                                    ("GET", "/debug/traces"),
                                    ("GET", "/health"), ("GET", "/metrics"),
                                    ("GET", "/version"), ("GET", "/load")):
                    async with http.request(
                            method, base + url, headers=headers,
                            json=body if method == "POST" else None) as r:
                        await r.read()
                        got[f"{key} {url}"] = (
                            r.status, "x-engine-running" in r.headers,
                            "x-trace-id" in r.headers)
    finally:
        await runner.cleanup()
    want = {f"{key} {url}": ((401, False, False) if key == "none"
                             and url in ("/v1/completions", "/debug/traces")
                             else (200, True, url == "/v1/completions"))
            for key in ("none", "right")
            for url in ("/v1/completions", "/debug/traces", "/health",
                        "/metrics", "/version", "/load")}
    log(json.dumps({"auth": {"path": path, "statuses": {
        k: v[0] for k, v in got.items()}, "ok": got == want}}))
    if got != want:
        raise AssertionError(f"auth: {got} against {want}")
    return got


async def feature_phase(engine, path: str) -> dict:
    """The OpenAI server in-process on `engine` again, after the
    breakdown: guided_phase, spec_phase, embed_phase and lora_phase,
    each with its own kernel counts. They run after the breakdown
    because its plain step's count of device events is held to
    PLAIN_DECODE_LAUNCHES, and after large uploads (the guided table)
    the profiler records fewer of the step's small pageable
    host-to-device copies (the kernels it launches are the same)."""
    import aiohttp
    from aiohttp import web
    from production_stack_tpu_torch.engine.server import build_app
    port = free_port()
    runner = web.AppRunner(build_app(engine, api_key=""))
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    base = f"http://127.0.0.1:{port}"
    try:
        async with aiohttp.ClientSession() as http:
            return {"guided": await guided_phase(http, base, engine, path),
                    "spec": await spec_phase(http, base, engine, path),
                    "embed": await embed_phase(http, base, engine, path),
                    "lora": await lora_phase(http, base, engine, path)}
    finally:
        await runner.cleanup()


async def _post_json(http, url, body, status=200):
    async with http.post(url, json=body) as r:
        text = await r.text()
        if r.status != status:
            raise AssertionError(f"{url} -> {r.status} (want {status}): "
                                 f"{text[:500]}")
        return json.loads(text)


async def guided_phase(http, base, engine, path) -> dict:
    """Guided decoding on llama-3-8b through the server, the kernel
    counts zeroed before and read after: guided_regex (red|green|blue)
    and \\d{3}, guided_choice, guided_json and response_format
    json_schema with a two-key object (GUIDED_SCHEMA), each as a greedy
    row and as a row sampled at temperature 1.0, sent together with a
    plain and a shaped row so they share windows (a window with the
    guided table and the shaping carry must run). Every guided output
    must fully match its pattern or parse as schema-valid JSON, ending
    on EOS; response_format json_object answers 400. Logs the stacked
    table's shape and build time (host lift, stack and upload)."""
    import re

    import torch
    from production_stack_tpu_torch.ops import flash_attention as fa
    from production_stack_tpu_torch.ops import paged_attention as pa
    if path != "llama-3-8b":
        return {}
    model = path_model(path)
    eng = engine.engine
    builds, windows = [], []
    orig_table, orig_decode = eng._ensure_guided_table, eng.runner.decode

    def timed_table():
        t0, before = time.monotonic(), eng._guided_table
        out = orig_table()
        if out[0] is not before:
            torch.cuda.synchronize()
            builds.append({"shape": list(out[0].shape),
                           "seconds": time.monotonic() - t0})
        return out

    def noted_decode(*a, **k):
        windows.append((k.get("guide_table") is not None,
                        bool(k.get("penalized"))))
        return orig_decode(*a, **k)

    def check_json(text):
        doc = json.loads(text)
        return (set(doc) == {"ok", "colour"} and isinstance(doc["ok"], bool)
                and doc["colour"] in ("red", "green", "blue"))

    cases = [
        ("regex", {"guided_regex": "(red|green|blue)"},
         lambda t: re.fullmatch("(red|green|blue)", t)),
        ("digits", {"guided_regex": r"\d{3}"},
         lambda t: re.fullmatch(r"\d{3}", t)),
        ("choice", {"guided_choice": ["north", "south", "east", "west"]},
         lambda t: t in ("north", "south", "east", "west")),
        ("json", {"guided_json": GUIDED_SCHEMA}, check_json),
        ("response_format", {"response_format": {
            "type": "json_schema",
            "json_schema": {"name": "pick", "schema": GUIDED_SCHEMA}}},
         check_json),
    ]
    prompt = surface_prompt(3)
    reqs = [("plain", None, {"prompt": surface_prompt(4), "max_tokens": 32,
                             "temperature": 0.0, "ignore_eos": True}),
            ("shaped", None, {"prompt": surface_prompt(5), "max_tokens": 32,
                              "temperature": 0.0, "ignore_eos": True,
                              **SHAPED})]
    for name, extra, check in cases:
        for temp in (0.0, 1.0):
            reqs.append((f"{name}@{temp}", check, {
                "prompt": prompt, "max_tokens": 64, "temperature": temp,
                "seed": 11, **extra}))
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    eng._ensure_guided_table, eng.runner.decode = timed_table, noted_decode
    t0 = time.monotonic()

    def post(body):
        return asyncio.ensure_future(_post_json(
            http, base + "/v1/completions", {"model": model, **body}))
    try:
        # the plain and the shaped row first, so that the guided rows
        # join their windows (the server admits requests from a thread
        # pool, in no fixed order)
        first = [post(body) for _, _, body in reqs[:2]]
        while sum(s.prompt_tokens in (reqs[0][2]["prompt"],
                                      reqs[1][2]["prompt"])
                  for s in list(eng.seqs.values())) < 2:
            await asyncio.sleep(0.005)
        results = await asyncio.gather(*first, *(
            post(body) for _, _, body in reqs[2:]))
        wall = time.monotonic() - t0
        launches = {**pa.launch_counts, **fa.launch_counts}
        await _post_json(http, base + "/v1/completions", {
            "model": model, "prompt": prompt, "max_tokens": 8,
            "response_format": {"type": "json_object"}}, status=400)
    finally:
        eng._ensure_guided_table, eng.runner.decode = orig_table, \
            orig_decode
    outputs, bad = {}, []
    for (name, check, _), res in zip(reqs, results):
        ch = res["choices"][0]
        outputs[name] = ch["text"]
        if check is not None and (ch["finish_reason"] != "stop"
                                  or not check(ch["text"])):
            bad.append((name, ch["finish_reason"], ch["text"]))
    shared = any(g and p for g, p in windows)
    rec = {"path": path, "requests": len(reqs) + 1, "wall_s": wall,
           "tables": builds, "outputs": outputs,
           "guided_and_shaped_window": shared, "launches": launches}
    log(json.dumps({"guided": rec}))
    if bad or not builds or not shared:
        raise AssertionError(f"guided phase: outputs off their pattern "
                             f"{bad}, tables {builds}, shared {shared}")
    for name in pa.launch_counts:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"guided phase: {launches}")
    return {"table_shape": builds[-1]["shape"]}


def spec_prompts(engine, path):
    """The spec phase's prompts as token ids: a repetitive one (a
    12-token base x 6, as tests/test_engine.py; Gemma-2 its long prompt
    past the 4096 window, itself a repeated sentence), a non-repetitive
    one, and the mixed batch's four."""
    import random
    tok = engine.engine.tokenizer
    rnd = random.Random(17)
    base = [rnd.randrange(32, 127) for _ in range(12)]
    if path == "gemma-2-9b":
        rep = tok.encode(long_prompt_text(PATHS[path]["long_tokens"]))
    else:
        rep = [256] + base * 6
    other = [256] + [rnd.randrange(32, 256) for _ in range(80)]
    mixed = [[256] + base[3:] * 5] + [surface_prompt(20 + i)
                                      for i in range(3)]
    return rep, other, mixed


SPEC_GUIDED = r"(red|green|blue)!"


def spec_requests(rep, other, mixed):
    """[[(name, body)], [(name, body)]] of the spec phase, each list
    sent at once: the repetitive and the non-repetitive prompt, then the
    mixed batch (a plain greedy, a shaped, a guided and a top_logprobs
    row)."""
    greedy = {"temperature": 0.0, "ignore_eos": True}
    return [[("repetitive", {"prompt": rep, "max_tokens": 32, **greedy}),
             ("other", {"prompt": other, "max_tokens": 24, **greedy})],
            [("plain", {"prompt": mixed[0], "max_tokens": 16, **greedy}),
             # 24 steps, as the surface phase's shaped request: the
             # bf16 noise shaped_check bounds by is a maximum over them
             ("shaped", {"prompt": mixed[1], "max_tokens": 24, **greedy,
                         **SHAPED}),
             ("guided", {"prompt": mixed[2], "max_tokens": 16,
                         "temperature": 0.0, "guided_regex": SPEC_GUIDED}),
             ("top", {"prompt": mixed[3], "max_tokens": 16, **greedy,
                      "logprobs": 5})]]


async def serve_spec_requests(http, base, engine, model, groups):
    """{name: (prompt ids, served ids)}: each group of spec_requests at
    once, one group after the other; the ids read from the engine's
    sequences."""
    for group in groups:
        await asyncio.gather(*(_post_json(http, base + "/v1/completions",
                                          {"model": model, **body})
                               for _, body in group))
    seqs = list(engine.engine.seqs.values())
    out = {}
    for name, body in groups[0] + groups[1]:
        seq = next(s for s in reversed(seqs)
                   if s.prompt_tokens == body["prompt"]
                   and s.options.max_tokens == body["max_tokens"])
        out[name] = (list(body["prompt"]), list(seq.output_tokens))
    return out


async def spec_phase(http, base, engine, path) -> dict:
    """n-gram speculation beside the spec-free engine: for each draft
    length of SPEC[path] a second engine over the same weights with
    speculative_ngram_tokens set serves, through its own server, the
    requests spec_requests names — which the served spec-free engine
    has answered first. The kernel counts are zeroed before each
    speculating engine serves and read after: the verify window
    spec + 1 must have launched the paged decode kernel at T = 4
    (spec 3) and the prefill kernel at T = 9 (spec 8). The guided row
    must match its pattern; the greedy rows' tokens against the
    spec-free ones, the shaped row's against the f32 shaped argmax and
    the teacher-forced verify logits are held in reference_phase (the
    f32 weights live there). Logs the speculation counters and, at
    spec 3, the macro-step breakdown (macro_step_breakdown). Each speculating engine is freed before
    the next."""
    import re

    from aiohttp import web
    from prometheus_client.parser import text_string_to_metric_families
    from production_stack_tpu_torch.engine.async_engine import \
        AsyncLLMEngine
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.server import build_app
    from production_stack_tpu_torch.ops import flash_attention as fa
    from production_stack_tpu_torch.ops import paged_attention as pa
    if path not in SPEC:
        return {}
    model = path_model(path)
    rep, other, mixed = spec_prompts(engine, path)
    groups = spec_requests(rep, other, mixed)
    ref = await serve_spec_requests(http, base, engine, model, groups)
    out = {"ref": ref, "runs": {}, "verify": {}, "verify_window": {}}
    for K in SPEC[path]:
        spec_engine = AsyncLLMEngine(
            EngineConfig(model=model, device=engine.engine.cfg.device,
                         speculative_ngram_tokens=K,
                         **PATHS[path]["serve"]),
            params=engine.engine.runner.params)
        port = free_port()
        runner = web.AppRunner(build_app(spec_engine, api_key=""))
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        base2 = f"http://127.0.0.1:{port}"
        try:
            pa.reset_launch_counts()
            fa.reset_launch_counts()
            t0 = time.monotonic()
            got = await serve_spec_requests(http, base2, spec_engine, model,
                                            groups)
            wall = time.monotonic() - t0
            launches = {**pa.launch_counts, **fa.launch_counts}
            verify = {n: dict(v) for n, v in pa.verify_launches.items()}
            vwin = {n: dict(v) for n, v in
                    pa.verify_window_launches.items()}
            async with http.get(base2 + "/metrics") as r:
                samples = {x.name: x.value for f in
                           text_string_to_metric_families(await r.text())
                           for x in f.samples}
        finally:
            await runner.cleanup()
        kernel = ("paged_decode_attention" if K + 1 <= pa.DECODE_T_MAX
                  else "paged_attention")
        guided_text = spec_engine.engine.tokenizer.decode(
            got["guided"][1])
        rec = {"path": path, "spec": K, "wall_s": wall,
               "accepted_draft_tokens":
                   samples["tpu:spec_accepted_draft_tokens_total"],
               "macro_steps": samples["tpu:spec_macro_steps_total"],
               "generated": sum(len(t) for _, t in got.values()),
               "equal_to_spec_free": {n: got[n][1] == ref[n][1]
                                      for n in got},
               "guided_text": guided_text, "launches": launches,
               "verify_launches": verify,
               "verify_window_launches": vwin}
        if K == 3:
            rec["macro_step"] = macro_step_breakdown(
                spec_engine.engine.runner, rep, K)
        log(json.dumps({"spec": rec}))
        if verify[kernel].get(K + 1, 0) <= 0 or launches[
                "flash_attention_with_cache"]:
            raise AssertionError(f"the verify window T = {K + 1} did not "
                                 f"launch {kernel}: {rec}")
        if not re.fullmatch(SPEC_GUIDED, guided_text):
            raise AssertionError(f"guided row under speculation: "
                                 f"{guided_text!r}")
        out["runs"][K] = got
        for counts, key in ((verify, "verify"), (vwin, "verify_window")):
            for name, by_t in counts.items():
                for T, n in by_t.items():
                    agg = out[key].setdefault(name, {})
                    agg[T] = agg.get(T, 0) + n
        release(spec_engine)
    return out


def macro_step_breakdown(runner, prompt, K, steps=2):
    """One speculative window of `steps` macro-steps of K drafts over
    the whole batch, every row the repetitive prompt prefilled and its
    history uploaded at each call (the history and decode state
    re-upload is part of the profiled span): per macro-step the wall
    time (CUDA events), the device's busy time and launches (profiler)
    and the tokens each row emits. Two macro-steps keep the trace
    short; the upload's share of a macro-step is then 1/2 where a
    decode_window of 8 would make it 1/8."""
    import numpy as np
    from production_stack_tpu_torch.engine.sampler import SamplingParams
    cfg = runner.engine_cfg
    B, S, W = cfg.max_num_seqs, cfg.max_model_len, steps
    MB = cfg.max_blocks_per_seq
    runner.set_block_tables(
        (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB))
    sp = SamplingParams.filled(B, temperature=0.0, device=runner.device)
    P = len(prompt)
    toks = np.tile(np.array(prompt, np.int32), (B, 1))
    first = runner.prefill(toks, np.zeros(B, np.int32),
                           np.full(B, P, np.int32), sp,
                           cfg.kv_bucket_for(P), greedy=True)[0]
    first = first.cpu().numpy()
    hist = np.zeros((B, S), np.int32)
    hist[:, :P] = prompt
    hist[:, P] = first
    kv_len = cfg.kv_bucket_for(min(P + W * (K + 1) + 1, S))
    ok = np.ones(B, bool)

    def window(i=0):
        runner.set_decode_state(first, np.full(B, P, np.int32),
                                history=hist)
        return runner.decode_spec(sp, steps=W, kv_len=kv_len, spec=K,
                                  spec_ok=ok, greedy=True)

    counts = window()[2].cpu().numpy()
    step_ms = time_ms(window, 3) / W
    return {"spec": K, "batch": B, "kv_len": kv_len, "prompt_tokens": P,
            "macro_step_ms": step_ms,
            "tokens_per_macro_step": float(counts.mean()),
            "tokens_per_row": counts.sum(axis=1).tolist(),
            "profile_per_macro_step": profile_summary(
                device_profile(window), W, step_ms)}


async def embed_phase(http, base, engine, path) -> dict:
    """The pooling routes on llama-3-8b, the kernel counts zeroed before
    and read after (the pooling forward is the plain causal attention,
    as in the JAX package: no paged or flash kernel may launch):
    /v1/embeddings with three inputs of different lengths gives three
    finite vectors of the model's width, labelled causal-mean-pool; the
    shortest input alone gives its vector again (padding-independence,
    held in reference_phase with the f32 bound); /v1/rerank, /v2/rerank
    and /v1/score answer 200 with finite scores."""
    from production_stack_tpu_torch.ops import flash_attention as fa
    from production_stack_tpu_torch.ops import paged_attention as pa
    if path != "llama-3-8b":
        return {}
    model = path_model(path)
    eng = engine.engine
    H = eng.model_cfg.hidden_size
    inputs = [long_prompt_text(300), "Rivers run to the sea, and the sea "
              "is never full.", "Tea."]
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    t0 = time.monotonic()
    res = await _post_json(http, base + "/v1/embeddings",
                           {"model": model, "input": inputs})
    alone = await _post_json(http, base + "/v1/embeddings",
                             {"model": model, "input": [inputs[2]]})
    docs = inputs[1:] + ["Keys and values, paged."]
    scores = [
        await _post_json(http, base + path_, {"model": model, **body})
        for path_, body in (
            ("/v1/rerank", {"query": "where do rivers go?",
                            "documents": docs}),
            ("/v2/rerank", {"query": "pools", "documents": docs,
                            "top_n": 2}),
            ("/v1/score", {"text_1": "rivers", "text_2": docs}))]
    wall = time.monotonic() - t0
    launches = {**pa.launch_counts, **fa.launch_counts}
    vecs = [d["embedding"] for d in res["data"]]
    finite = [math.isfinite(x) for v in vecs + [alone["data"][0][
        "embedding"]] for x in v]
    vals = [r["relevance_score"] for r in scores[0]["results"]
            + scores[1]["results"]] + [d["score"] for d in scores[2]["data"]]
    rec = {"path": path, "wall_s": wall, "vectors": len(vecs),
           "width": [len(v) for v in vecs],
           "embedding_source": res["embedding_source"],
           "input_tokens": [len(eng.tokenizer.encode(t)) for t in inputs],
           "scores": vals, "launches": launches}
    log(json.dumps({"embed": rec}))
    if (len(vecs) != 3 or any(len(v) != H for v in vecs) or not all(finite)
            or not all(math.isfinite(v) for v in vals) or len(vals) != 8
            or res["embedding_source"] != "causal-mean-pool"
            or any(launches.values())):
        raise AssertionError(f"embed phase: {rec}")
    return {"tokens": eng.tokenizer.encode(inputs[2]),
            "batched": vecs[2], "alone": alone["data"][0]["embedding"]}


# the full-width .npz adapter of lora_phase, written from a seeded numpy
# draw (both factors N(0, 0.05), the scale of the JAX package's
# random_adapter) into build/ at the first use
LORA_NPZ = os.path.join(REPO, "build", "lora", "ad-npz.npz")
LORA_NPZ_SEED = 5
LORA_TOKENS = 16


def npz_adapter(cfg) -> str:
    """LORA_NPZ for `cfg`'s widths at rank LORA["lora_rank"] on every
    target of LORA_TARGETS ({proj}.a [L, in, r], {proj}.b [L, r, out],
    float32, the models/lora.py format)."""
    import numpy as np
    from production_stack_tpu_torch.models.lora import _proj_dims
    if not os.path.exists(LORA_NPZ):
        os.makedirs(os.path.dirname(LORA_NPZ), exist_ok=True)
        rng = np.random.default_rng(LORA_NPZ_SEED)
        L, r = cfg.num_layers, LORA["lora_rank"]
        arrays = {}
        for name in LORA_TARGETS:
            d_in, d_out = _proj_dims(cfg)[name]
            for key, shape in (("a", (L, d_in, r)), ("b", (L, r, d_out))):
                arrays[f"{name}.{key}"] = rng.standard_normal(
                    shape, dtype=np.float32) * np.float32(0.05)
        np.savez(LORA_NPZ + ".tmp.npz", **arrays)
        os.replace(LORA_NPZ + ".tmp.npz", LORA_NPZ)
    return LORA_NPZ


def served_ids(engine, prompt, adapter_id) -> list:
    """The output ids of the latest sequence of `prompt` on adapter
    `adapter_id`."""
    seq = next(s for s in reversed(list(engine.engine.seqs.values()))
               if s.prompt_tokens == prompt and s.adapter_id == adapter_id)
    return list(seq.output_tokens)


async def _adapter_series(http, base) -> dict:
    from prometheus_client.parser import text_string_to_metric_families
    async with http.get(base + "/metrics") as r:
        text = await r.text()
    names = ("tpu:engine_adapter_loads_total",
             "tpu:engine_adapter_evictions_total",
             "tpu:engine_adapters_loaded")
    return {x.name: x.value for f in text_string_to_metric_families(text)
            for x in f.samples if x.name in names}


async def lora_phase(http, base, engine, path) -> dict:
    """Multi-LoRA through the server (llama-3-8b; on llama-3-8b-int8 the
    .npz adapter beside a base row), the kernel counts zeroed before the
    mixed batch and read after. /admin/lora/load loads ad-rand
    (random:11) and ad-npz (npz_adapter); /v1/models (root and parent),
    /load's models and the tpu:engine_adapter_* series (2 / 0 / 2) list
    them. Each adapter's request is served alone, then one batch of the
    base model, ad-rand and ad-npz on one prompt and the base model on
    another, greedy: three distinct streams; both paged kernels launch,
    the flash kernel not. The mixed rows against the solo ones are held
    in reference_phase (equal, or parting at a near-tie). Then ad-rand
    is evicted: it answers 404 as a model and on a second evict, ad-npz
    still serves, and a new load takes id 3."""
    from production_stack_tpu_torch.ops import flash_attention as fa
    from production_stack_tpu_torch.ops import paged_attention as pa
    if path not in ("llama-3-8b", "llama-3-8b-int8"):
        return {}
    full = path == "llama-3-8b"
    model = path_model(path)
    eng = engine.engine
    t_phase = t0 = time.monotonic()
    npz = npz_adapter(eng.model_cfg)
    out = {"npz_write_s": time.monotonic() - t0,
           "npz_bytes": os.path.getsize(npz), "load_s": {}}
    sources = ({"ad-rand": "random:11", "ad-npz": npz} if full
               else {"ad-npz": npz})
    for name, src in sources.items():
        t0 = time.monotonic()
        res = await _post_json(http, base + "/admin/lora/load",
                               {"name": name, "src": src})
        out["load_s"][name] = time.monotonic() - t0
        if res["loaded"] is not True:
            raise AssertionError(f"adapter {name} did not load: {res}")
    names = list(sources)
    ids = {n: eng.lora_ids[n] for n in names}
    async with http.get(base + "/v1/models") as r:
        cards = (await r.json())["data"]
    async with http.get(base + "/load") as r:
        models = (await r.json())["models"]
    series = await _adapter_series(http, base)
    want = {"tpu:engine_adapter_loads_total": len(names),
            "tpu:engine_adapter_evictions_total": 0,
            "tpu:engine_adapters_loaded": len(names)}
    if ([c["id"] for c in cards] != [model] + names or models
            != [model] + names or series != want
            or any(c["root"] != model or c["parent"] != model
                   for c in cards[1:])):
        raise AssertionError(f"adapter catalog: cards {cards}, /load "
                             f"{models}, series {series}")
    prompt, other = surface_prompt(30), surface_prompt(31)
    rows = ([(model, prompt)] + [(n, prompt) for n in names]
            + [(model, other)])

    def body(m, p):
        return {"model": m, "prompt": p, "max_tokens": LORA_TOKENS,
                "temperature": 0.0, "ignore_eos": True}

    solo = {}
    for name in names:
        await _post_json(http, base + "/v1/completions", body(name, prompt))
        solo[name] = served_ids(engine, prompt, ids[name])
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    t0 = time.monotonic()
    await asyncio.gather(*(_post_json(http, base + "/v1/completions",
                                      body(m, p)) for m, p in rows))
    out["mixed_wall_s"] = time.monotonic() - t0
    launches = {**pa.launch_counts, **fa.launch_counts}
    streams = {m if p is prompt else "base2":
               served_ids(engine, p, ids.get(m, 0)) for m, p in rows}
    out.update(path=path, adapters=ids, launches=launches,
               int8_launches=dict(pa.int8_launches), streams=streams,
               solo=solo, equal_to_solo={n: streams[n] == solo[n]
                                         for n in names})
    first = [tuple(streams[n]) for n in [model] + names]
    if (len(set(first)) != len(first)
            or any(len(t) != LORA_TOKENS for t in streams.values())):
        log(json.dumps({"lora": out}))
        raise AssertionError("the adapters' streams are not distinct from "
                             "the base model's and each other's")
    for name in pa.launch_counts:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"adapter requests: {launches}")
    if any(launches[n] for n in fa.launch_counts):
        raise AssertionError(f"the flash kernel launched: {launches}")
    if full:
        await _post_json(http, base + "/admin/lora/evict",
                         {"name": "ad-rand"})
        await _post_json(http, base + "/v1/completions",
                         body("ad-rand", prompt), status=404)
        await _post_json(http, base + "/admin/lora/evict",
                         {"name": "ad-rand"}, status=404)
        res = await _post_json(http, base + "/v1/completions",
                               body("ad-npz", other))
        if res["usage"]["completion_tokens"] != LORA_TOKENS:
            raise AssertionError(f"ad-npz after the evict: {res}")
        await _post_json(http, base + "/admin/lora/load",
                         {"name": "ad-three", "src": "random:13"})
        out["new_load_id"] = eng.lora_ids["ad-three"]
        out["series_after"] = await _adapter_series(http, base)
        if out["new_load_id"] != 3 or out["series_after"] != {
                "tpu:engine_adapter_loads_total": 3,
                "tpu:engine_adapter_evictions_total": 1,
                "tpu:engine_adapters_loaded": 2}:
            raise AssertionError(f"after the evict: {out}")
    out["seconds"] = time.monotonic() - t_phase
    log(json.dumps({"lora": out}))
    return {"ids": ids, "prompt": prompt,
            "rows": {n: {"mixed": streams[n], "solo": solo[n]}
                     for n in names}}


async def fault_probe(http, base, engine, path: str):
    """Prompt ids outside the vocabulary ([1, V+100, -(V+100), 3]) answer
    200 (the embedding's index rule), plain and with echo and logprobs
    (the prompt logprobs' target rule: NaN at the two ids outside
    [-V, V), finite elsewhere); min_tokens with stop ids outside the
    vocabulary (V+5, 2**40) answers 200; and so does the next request."""
    V = engine.engine.model_cfg.vocab_size
    model = path_model(path)
    bad = [1, V + 100, -(V + 100), 3]
    probes = [{"prompt": bad},
              {"prompt": bad, "echo": True, "logprobs": 1},
              {"prompt": [1, 5, 6], "min_tokens": 2,
               "stop_token_ids": [V + 5, 2 ** 40]},
              {"prompt": "After the probe"}]
    status = []
    for extra in probes:
        async with http.post(base + "/v1/completions", json={
                "model": model, "max_tokens": 4, "temperature": 0.0,
                **extra}) as r:
            status.append(r.status)
            if r.status != 200:
                raise AssertionError(f"fault probe {extra!r} -> "
                                     f"{r.status}: {await r.text()}")
            body = await r.json()
        if extra.get("echo"):
            lps = body["choices"][0]["logprobs"]["token_logprobs"]
            nan = [v is not None and math.isnan(v) for v in lps[:len(bad)]]
            if nan != [False, True, True, False]:
                raise AssertionError(f"fault probe echo logprobs "
                                     f"{lps[:len(bad)]}")
    log(json.dumps({"fault_probe": {"path": path, "vocab": V,
                                    "status": status}}))


def reference_phase(engine, path: str, surface: dict):
    """The served model's logits against a float32 reference on the card:
    the same weights upcast (exact; int8 weights shared as they are, and
    dequantized in f32 by the f32 forward), the plain attention, a pool of
    the served path's KV dtype (an int8 pool read through its scales), a
    prompt of ref_prompt tokens prefilled in prefill_chunk chunks, then 3
    decode steps; logits compared at each chunk's last position and at
    each step.

    - float32 through the kernels must match the reference to
      F32_LOGIT_TOL of its largest logit. Over an int8 pool that is not
      a bound: rounding to int8 is discontinuous, so K/V values that lie
      at a rounding tie quantize differently once the layers below
      differ by the kernels' f32 summation order (~1e-7), and each such
      value moves by one int8 step (llama-3-8b-int8 on an H100 80GB
      HBM3: 0.023 of a largest logit of 5.9). There each kernel call of the f32 run
      is held instead against the plain attention on the same inputs
      (the model's own activations and pool), at TOL of the larger of 1
      and its largest output; the logits' distance and the count of
      int8 values that differ from the reference's pool are logged. On
      a MoE model every f32 kernel call is held so too, and where the
      two f32 runs route a token to other experts (top-k routing is
      discontinuous as int8 rounding is), the first such MoE call must
      be a near-tie of the router logits (first_routing_flip) and the
      calls' bound replaces the logits' (Mixtral-8x7B on an H100 80GB
      HBM3: 0.0118 of a largest logit of 5.88 after such a flip);
    - the served bf16 path through the kernels may be at most
      BF16_FLOOR_FACTOR times further from it than the bf16 path through
      the plain attention is (bf16 rounding through every layer is the
      floor both share). On a MoE model that floor is weak once bf16
      routing parts from f32 (Mixtral-8x7B on an H100 80GB HBM3: 5.4 of
      a largest logit of 5.88), so each MoE call of the served bf16 run
      is also held against the same call in f32 on its own inputs
      (moe_call_f32): both route alike, so they differ by the bf16
      products' rounding alone, at most TOL["bfloat16"] of the f32
      call's largest output.

    Then the surface phase's outputs (surface_phase) against float32
    forwards of the same weights through the plain attention:
    - the penalized greedy request: each served token is the argmax of
      the port's plain adjust_logits (sampler.py) over the f32 logits of
      the served sequence so far (teacher-forced), or, where it is not,
      the f32 gap between the best token and the served one is at most
      BF16_FLOOR_FACTOR x the bf16 plain path's largest error on such a
      gap over the same steps, a bound that must stay below the
      smallest penalty term (shaped_check);
    - the echoed prompt logprobs may be at most BF16_FLOOR_FACTOR times
      further from the f32 prompt logprobs than the bf16 plain path's
      are, as the logits are.

    On the paths that speculate (SPEC), the teacher-forced verify: after
    the 3 decode steps, spec + 1 further tokens go through one forward
    (the verify window's shape), and through the kernels also as
    spec + 1 single-token forwards over the same positions. The bf16
    verify and single-token logits may each be at most
    BF16_FLOOR_FACTOR times further from the f32 forward than the bf16
    plain path's verify forward is, so at most 2 x BF16_FLOOR_FACTOR
    times that from each other; the f32 verify through the kernels is
    held at F32_LOGIT_TOL. The spec phase's greedy rows against the
    spec-free ones (near_tie_check) and its shaped row
    (shaped_check). The embed phase's vector (embed_check).

    After the lora phase: the .npz adapter's logits (the same prompt and
    steps, its factors in every forward) through the kernels in bf16
    may be at most BF16_FLOOR_FACTOR times further from the f32 plain
    forward with the adapter (its factors upcast, exact) than the bf16
    plain path with it is; each adapter row of the mixed batch against
    the same request served alone (near_tie_check, over the solo
    sequence's logits with the adapter)."""
    from contextlib import contextmanager
    import dataclasses

    import torch
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models import lora as lora_mod
    from production_stack_tpu_torch.models.kv import make_slot_cache
    from production_stack_tpu_torch.models.quant import is_quantized
    from production_stack_tpu_torch.ops import moe
    from production_stack_tpu_torch.ops import paged_attention as pa
    from production_stack_tpu_torch.ops.norms import rms_norm

    runner = engine.engine.runner
    cfg = runner.model_cfg
    dev = next(runner.params.parameters()).device
    P, chunk = PATHS[path]["ref_prompt"], PATHS[path]["serve"][
        "prefill_chunk"]
    kv_dtype = getattr(torch, path_kv(path))
    steps = 3
    Bs = 64
    verify_T = [K + 1 for K in SPEC.get(path, ())]
    max_len = -(-(P + steps + sum(verify_T)) // Bs) * Bs
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = Upcast(runner.params)
    g = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (1, P), generator=g,
                           device=dev)
    step_toks = torch.randint(0, cfg.vocab_size, (steps,), generator=g,
                              device=dev)
    ver_toks = torch.randint(0, cfg.vocab_size, (sum(verify_T),),
                             generator=g, device=dev)

    def plain(q, k, v, tables, starts, *, nb, scale=None, window=0,
              softcap=0.0, k_scales=None, v_scales=None):
        return pa.paged_attention_plain(q, k, v, tables, starts, nb, scale,
                                        window, softcap, k_scales, v_scales)

    # per kernel call of a "checked" run: (max |kernel - plain|, its bound)
    call_errs = []

    def checked(kernel):
        def call(q, k, v, tables, starts, *, nb, scale=None, window=0,
                 softcap=0.0, k_scales=None, v_scales=None):
            out = kernel(q, k, v, tables, starts, nb=nb, scale=scale,
                         window=window, softcap=softcap, k_scales=k_scales,
                         v_scales=v_scales)
            want = plain(q, k, v, tables, starts, nb=nb, scale=scale,
                         window=window, softcap=softcap, k_scales=k_scales,
                         v_scales=v_scales)
            call_errs.append(((out - want).abs().max().item(),
                              TOL["float32"] * max(
                                  1.0, want.abs().max().item())))
            return out
        return call

    @contextmanager
    def attention(mode):
        """The attention the forward takes: "plain", "kernels" or
        "checked"."""
        saved = (pa.paged_attention, pa.paged_decode_attention)
        if mode == "plain":
            pa.paged_attention = pa.paged_decode_attention = plain
        elif mode == "checked":
            pa.paged_attention = checked(saved[0])
            pa.paged_decode_attention = checked(saved[1])
        try:
            yield
        finally:
            pa.paged_attention, pa.paged_decode_attention = saved

    def pool(mcfg, length):
        return make_slot_cache(
            mcfg.num_layers, 1, length, mcfg.num_kv_heads, mcfg.head_dim_,
            dtype=kv_dtype if kv_dtype == torch.int8 else mcfg.dtype,
            block_size=Bs, device=dev)

    def adapter(aid, dtype):
        """(factors of adapter `aid` for one row, in `dtype`, scaling)
        from the served engine's stack, as llama.forward's lora_rows,
        lora_scaling; None for aid None."""
        if aid is None:
            return {}
        rows = lora_mod.gather_rows(runner._lora,
                                    torch.tensor([aid], device=dev))
        return dict(lora_rows={n: (a.to(dtype), b.to(dtype))
                               for n, (a, b) in rows.items()},
                    lora_scaling=runner._lora_scaling)

    # per MoE call of the served bf16 run: (max |bf16 - f32|, its bound)
    moe_errs = []

    @contextmanager
    def moe_held():
        """Each MoE call inside held against moe_call_f32."""
        call = moe.moe_mlp

        def held(x, router_w, *ws, **kw):
            out = call(x, router_w, *ws, **kw)
            want = moe_call_f32(call, x, router_w, ws, kw)
            moe_errs.append(((out.float() - want).abs().max().item(),
                             TOL["bfloat16"] * want.abs().max().item()))
            return out
        moe.moe_mlp = held
        try:
            yield
        finally:
            moe.moe_mlp = call

    routed = {}

    @contextmanager
    def routing_log(key):
        """routed[key]: (hidden, router) in f32 of the MoE calls inside,
        in order: every call in an f32 run, the first (layer 0 of the
        first prefill chunk) in another."""
        call = moe.moe_mlp
        every = key[0] == str(torch.float32)
        calls = routed.setdefault(key, [])

        def capture(x, router_w, *a, **kw):
            if every or not calls:
                calls.append((x.float().clone(), router_w.float()))
            return call(x, router_w, *a, **kw)
        moe.moe_mlp = capture
        try:
            yield
        finally:
            moe.moe_mlp = call

    def run(params, mcfg, mode, lora=None, hold_moe=False):
        """Logits at the compared positions, the verify segments' logits
        {T: [T, V]} as one forward and (not in "plain") as T
        single-token forwards over the same positions, and the pool's
        int8 K/V (None over a float pool); mode "plain", "kernels" or
        "checked"; lora: an adapter id whose factors join every
        forward; hold_moe: each MoE call held (moe_held). On a MoE
        model the run's routing inputs are kept in routed[(dtype,
        mode)] (routing_log)."""
        cache, tables = pool(mcfg, max_len)
        out, ver, single = [], {}, {}
        ad = adapter(lora, mcfg.dtype)
        with (moe_held() if hold_moe else nullcontext()), attention(mode), \
                routing_log((str(mcfg.dtype), mode)):
            for lo in range(0, P, chunk):
                hi = min(lo + chunk, P)
                logits, _ = llama.forward(
                    params, mcfg, prompt[:, lo:hi],
                    torch.arange(lo, hi, device=dev)[None], cache,
                    block_tables=tables, rope=runner.rope, kv_len=max_len,
                    last_index=torch.tensor([hi - lo - 1], device=dev),
                    **ad)
                out.append(logits[0, 0])
            for i, tok in enumerate(step_toks):
                logits, _ = llama.forward(
                    params, mcfg, tok.view(1, 1),
                    torch.tensor([[P + i]], device=dev), cache,
                    block_tables=tables, rope=runner.rope, kv_len=max_len,
                    **ad)
                out.append(logits[0, 0])
            at = P + steps
            for T in (verify_T if lora is None else ()):
                toks = ver_toks[at - P - steps:at - P - steps + T]
                pos = torch.arange(at, at + T, device=dev)
                logits, _ = llama.forward(
                    params, mcfg, toks[None], pos[None], cache,
                    block_tables=tables, rope=runner.rope, kv_len=max_len)
                ver[T] = logits[0]
                if mode != "plain":
                    single[T] = torch.cat([llama.forward(
                        params, mcfg, toks[i].view(1, 1), pos[i].view(1, 1),
                        cache, block_tables=tables, rope=runner.rope,
                        kv_len=max_len)[0][0] for i in range(T)])
                at += T
        k8 = (torch.stack([cache.k, cache.v])
              if kv_dtype == torch.int8 else None)
        del cache
        return torch.stack(out), ver, single, k8

    def all_logits(params, mcfg, ids):
        """f32 logits [T, V] at every position of `ids`, one chunk
        through a pool of its own and the plain attention."""
        T = len(ids)
        cache, tables = pool(mcfg, -(-T // Bs) * Bs)
        with attention("plain"):
            logits, _ = llama.forward(
                params, mcfg, torch.tensor([ids], device=dev),
                torch.arange(T, device=dev)[None], cache,
                block_tables=tables, rope=runner.rope,
                kv_len=-(-T // Bs) * Bs)
        del cache
        return logits[0]

    def tail_logits(params, mcfg, ids, n, lora=None):
        """plain_tail_logits over a pool of the path's KV dtype; lora: an
        adapter id whose factors join the forward."""
        return plain_tail_logits(
            runner, params, mcfg, ids, n,
            kv_dtype if kv_dtype == torch.int8 else mcfg.dtype,
            **adapter(lora, mcfg.dtype))

    def pooled_plain(params, mcfg, ids):
        """The mean over `ids` of the final-normed hidden states of one
        incremental forward through the plain attention: the bf16 plain
        path of embed_check."""
        T = len(ids)
        cache, tables = pool(mcfg, -(-T // Bs) * Bs)
        with attention("plain"):
            x = llama.hidden(params, mcfg, torch.tensor([ids], device=dev),
                             torch.arange(T, device=dev)[None], cache,
                             block_tables=tables, rope=runner.rope,
                             kv_len=-(-T // Bs) * Bs)
        del cache
        x = rms_norm(x, params.final_norm, mcfg.rms_norm_eps,
                     1.0 if mcfg.rms_norm_offset else 0.0)
        return x[0].float().mean(dim=0)

    def prompt_lps(params, mcfg, ids):
        lsm = torch.log_softmax(all_logits(params, mcfg, ids)[:-1], -1)
        return lsm.gather(1, torch.tensor(ids[1:], device=dev)[:, None])[
            :, 0]

    t0 = time.monotonic()
    ref, ref_ver, _, ref_pool = run(p32, cfg32, "plain")
    int8 = ref_pool is not None
    # each f32 kernel call is held against the plain attention on its
    # own inputs where the logits' distance may be no bound: over an
    # int8 pool, and on a MoE model (its routing may flip at a tie)
    f32_mode = "checked" if int8 or cfg.num_experts else "kernels"
    got32, ver32, _, pool32 = run(p32, cfg32, f32_mode)
    err32 = (got32 - ref).abs().max().item()
    shaped32 = echo32 = None
    # the spec phase's rows that left the spec-free tokens, and its
    # shaped rows: f32 logits of their distributions
    spec = surface.get("spec") or {}
    spec_rows = []
    for K, got in spec.get("runs", {}).items():
        for name, (prompt_ids, toks) in got.items():
            want = spec["ref"][name][1]
            if name == "shaped" or (name != "guided" and toks != want):
                seq = toks if name == "shaped" else want
                spec_rows.append({"spec": K, "name": name,
                                  "prompt": prompt_ids, "tokens": seq,
                                  "got": toks,
                                  "f32": tail_logits(p32, cfg32,
                                                     prompt_ids + seq,
                                                     len(seq))})
    embed = surface.get("embed")
    if embed:
        ids = torch.tensor([embed["tokens"]], device=dev)
        embed32 = llama.encode(p32, cfg32, ids, rope=runner.rope)[0].mean(
            dim=0)
    if "shaped" in surface:
        sh = surface["shaped"]
        shaped32 = all_logits(p32, cfg32, sh["prompt"] + sh["tokens"])[
            len(sh["prompt"]) - 1:-1]
    if "echo" in surface:
        echo32 = prompt_lps(p32, cfg32, surface["echo"]["prompt"])
    # the lora phase: ad-npz's f32 forward, and the f32 logits of each
    # adapter row whose mixed tokens left its solo ones
    lora = surface.get("lora") or {}
    lora_rows = []
    if lora:
        npz_id = lora["ids"]["ad-npz"]
        ref_lora = run(p32, cfg32, "plain", lora=npz_id)[0]
        for name, row in lora["rows"].items():
            if row["mixed"] != row["solo"]:
                lora_rows.append((name, tail_logits(
                    p32, cfg32, lora["prompt"] + row["solo"],
                    len(row["solo"]), lora=lora["ids"][name])))
    roll = surface.get("roll")
    if roll:
        roll["f32"] = tail_logits(p32, cfg32, roll["prompt"] + roll["tokens"],
                                  len(roll["tokens"]))
    del p32
    free_memory()
    got16, ver16, single16, _ = run(runner.params, cfg, "kernels",
                                    hold_moe=bool(cfg.num_experts))
    plain16, pver16, _, _ = run(runner.params, cfg, "plain")
    err16 = (got16 - ref).abs().max().item()
    floor16 = (plain16 - ref).abs().max().item()
    scale = ref.abs().max().item()
    extra = {}
    calls_ok = bool(call_errs) and all(e <= t for e, t in call_errs)
    if call_errs:
        extra = {"f32_kernel_calls": len(call_errs),
                 "f32_call_err_max": max(e for e, _ in call_errs),
                 "f32_call_tol_min": min(t for _, t in call_errs)}
    if int8:
        # the pools [2, L, N, Hkv, Bs, D] outside trash block 0
        step = (pool32[:, :, 1:].int() - ref_pool[:, :, 1:].int()).abs()
        extra.update({"int8_values_differing": int((step != 0).sum().item()),
                      "int8_values_in_pool": step.numel(),
                      "int8_max_step": int(step.max().item())})
        f32_ok = calls_ok
    else:
        f32_ok = err32 <= F32_LOGIT_TOL * scale
    if cfg.num_experts:
        # top-k routing is discontinuous: where the two f32 runs route a
        # token to other experts (first_routing_flip: a tie of the router
        # logits broken the other way by the kernels' summation order)
        # the logits' distance is no bound, and the kernel calls are
        # held to the plain attention instead, as over an int8 pool
        flip = first_routing_flip(routed[(str(torch.float32), "plain")],
                                  routed[(str(torch.float32), f32_mode)],
                                  cfg.num_experts_per_tok)
        extra["f32_routing_flip"] = flip
        if flip is not None:
            f32_ok = flip["ok"] and calls_ok
    ok = (bool(torch.isfinite(ref).all()) and f32_ok
          and err16 <= BF16_FLOOR_FACTOR * floor16)
    if moe_errs:
        extra.update({"bf16_moe_calls": len(moe_errs),
                      "bf16_moe_call_err_max": max(e for e, _ in moe_errs),
                      "bf16_moe_call_share_of_tol_max": max(
                          e / t for e, t in moe_errs),
                      "bf16_moe_call_tol_min": min(t for _, t in moe_errs)})
        ok = ok and all(e <= t for e, t in moe_errs)
    if shaped32 is not None:
        sh = surface["shaped"]
        shaped16 = all_logits(runner.params, cfg,
                              sh["prompt"] + sh["tokens"])[
            len(sh["prompt"]) - 1:-1].float()
        extra["shaped"] = shaped_check(engine, sh, shaped32, shaped16)
        ok = ok and extra["shaped"]["ok"]
    if verify_T:
        extra["verify"] = []
        for T in verify_T:
            r32 = ref_ver[T]

            def dist(a):
                return (a.float() - r32).abs().max().item()
            floor = dist(pver16[T])
            v = {"T": T, "bf16_verify_err": dist(ver16[T]),
                 "bf16_single_err": dist(single16[T]),
                 "verify_vs_single": (ver16[T].float()
                                      - single16[T].float()).abs().max()
                 .item(),
                 "bf16_plain_err": floor,
                 "tol": BF16_FLOOR_FACTOR * floor,
                 "f32_verify_err": dist(ver32[T]),
                 "f32_tol": F32_LOGIT_TOL * scale}
            v["ok"] = (v["bf16_verify_err"] <= v["tol"]
                       and v["bf16_single_err"] <= v["tol"]
                       and v["verify_vs_single"] <= 2 * v["tol"]
                       and v["f32_verify_err"] <= v["f32_tol"])
            extra["verify"].append(v)
            ok = ok and v["ok"]
    if spec:
        extra["spec"] = []
        for row in spec_rows:
            l16 = tail_logits(runner.params, cfg,
                              row["prompt"] + row["tokens"],
                              len(row["tokens"]))
            if row["name"] == "shaped":
                chk = shaped_check(engine, {"prompt": row["prompt"],
                                            "tokens": row["tokens"]},
                                   row["f32"], l16)
            else:
                chk = near_tie_check(row["tokens"], row["got"], row["f32"],
                                     l16)
            extra["spec"].append({"spec": row["spec"], "row": row["name"],
                                  **chk})
            ok = ok and chk["ok"]
    if embed:
        extra["embed"] = embed_check(embed, embed32, pooled_plain(
            runner.params, cfg, embed["tokens"]))
        ok = ok and extra["embed"]["ok"]
    if lora:
        got_l = run(runner.params, cfg, "kernels", lora=npz_id)[0]
        plain_l = run(runner.params, cfg, "plain", lora=npz_id)[0]
        l_err = (got_l - ref_lora).abs().max().item()
        l_floor = (plain_l - ref_lora).abs().max().item()
        extra["lora"] = {"adapter": "ad-npz", "bf16_kernels_err": l_err,
                         "bf16_plain_err": l_floor,
                         "tol": BF16_FLOOR_FACTOR * l_floor,
                         "moved_by_adapter": (ref_lora - ref).abs().max()
                         .item(),
                         "ok": l_err <= BF16_FLOOR_FACTOR * l_floor}
        ok = ok and extra["lora"]["ok"]
        extra["lora"]["rows"] = {n: {"tokens": len(r["solo"]),
                                     "differ_at": None, "ok": True}
                                 for n, r in lora["rows"].items()}
        for name, l32 in lora_rows:
            row = lora["rows"][name]
            l16 = tail_logits(runner.params, cfg,
                              lora["prompt"] + row["solo"],
                              len(row["solo"]), lora=lora["ids"][name])
            chk = near_tie_check(row["solo"], row["mixed"], l32, l16)
            extra["lora"]["rows"][name] = chk
            ok = ok and chk["ok"]
    if cfg.num_experts:
        extra["routing"] = routing_check(
            routed[(str(torch.float32), "plain")][0],
            routed[(str(cfg.dtype), "kernels")][0], cfg.num_experts_per_tok)
        ok = ok and extra["routing"]["ok"]
    if roll:
        l16 = tail_logits(runner.params, cfg, roll["prompt"] + roll["tokens"],
                          len(roll["tokens"]))
        extra["roll"] = near_tie_check(
            roll["tokens"], roll["f32"].argmax(dim=-1).tolist(),
            roll["f32"], l16)
        ok = ok and extra["roll"]["ok"]
    if echo32 is not None:
        served = torch.tensor(surface["echo"]["logprobs"], device=dev)
        plain16 = prompt_lps(runner.params, cfg, surface["echo"]["prompt"])
        e_err = (served - echo32).abs().max().item()
        e_floor = (plain16 - echo32).abs().max().item()
        extra["echo"] = {"tokens": len(surface["echo"]["prompt"]),
                         "served_err": e_err, "bf16_plain_err": e_floor,
                         "tol": BF16_FLOOR_FACTOR * e_floor,
                         "ok": e_err <= BF16_FLOOR_FACTOR * e_floor}
        ok = ok and extra["echo"]["ok"]
    log(json.dumps({"reference": {
        "path": path, "layers": cfg.num_layers, "kv_dtype": str(kv_dtype),
        "int8_weights": is_quantized(runner.params.q), "prompt_tokens": P,
        "decode_steps": steps, "positions": ref.shape[0],
        "max_abs_logit": scale,
        "f32_kernels_err": err32,
        "f32_tol": None if int8 else F32_LOGIT_TOL * scale, **extra,
        "bf16_kernels_err": err16, "bf16_plain_err": floor16,
        "bf16_tol": BF16_FLOOR_FACTOR * floor16,
        "seconds": time.monotonic() - t0, "ok": ok}}))
    if not ok:
        raise AssertionError("served logits disagree with the float32 "
                             "reference beyond the stated bounds")


class Upcast:
    """A Llama module's weights read as float32 a leaf at a time: a
    layer-stacked weight upcasts one layer when the forward indexes it,
    the others (embedding, final norm, head) whole at each read; int8
    leaves come as they are (the f32 forward dequantizes them in f32).
    The upcast is exact, and the f32 reference never holds more than a
    layer's f32 copy beside the served weights: a whole f32 copy of
    Qwen1.5-MoE-A2.7B (57.2 GB) beside its 28.6 GB of bf16 weights would
    not fit the card."""

    def __init__(self, model):
        self._model = model

    def __getattr__(self, name):
        from production_stack_tpu_torch.models.llama import LAYER_KEYS
        from production_stack_tpu_torch.models.quant import is_quantized
        import torch
        w = getattr(self._model, name)
        if is_quantized(w) or not isinstance(w, torch.Tensor):
            return w
        return _UpcastLayers(w) if name in LAYER_KEYS else w.float()


class _UpcastLayers:
    def __init__(self, stacked):
        self._stacked = stacked

    def __getitem__(self, layer):
        return self._stacked[layer].float()


def moe_call_f32(call, x, router_w, ws, kw):
    """The MoE call call(x, router_w, *ws, **kw) in float32: the
    activations and a float router and expert stacks upcast (exact),
    int8 stacks as they are (dequantized in f32 by the product). The
    router logits come out the same bytes (route() takes them in f32
    from the same values), so the two calls route alike."""
    from production_stack_tpu_torch.models.quant import is_quantized
    return call(x.float(), router_w.float(),
                *(w if is_quantized(w) else w.float() for w in ws), **kw)


def routing_check(ref, got, k: int) -> dict:
    """The experts the served bf16 path routes each token of the first
    prefill chunk to at the first layer, against the f32 reference's:
    ref and got are (routing input [N, H], router [H, E]) in f32. A
    token whose set of k experts differs is allowed only where the f32
    gap between its k-th and (k+1)-th router logits is within twice the
    bf16 router logits' largest error on that token (two logits, each
    off by at most that, can swap there)."""
    import torch
    l32 = ref[0] @ ref[1]
    l16 = got[0] @ got[1]
    top32 = l32.topk(k + 1, dim=-1)
    ids32 = top32.indices[:, :k].sort(dim=-1).values
    ids16 = l16.topk(k, dim=-1).indices.sort(dim=-1).values
    differ = (ids32 != ids16).any(dim=-1)
    gap = top32.values[:, k - 1] - top32.values[:, k]
    err = (l16 - l32).abs().amax(dim=-1)
    allowed = gap <= 2 * err
    n = int(differ.sum().item())
    return {"tokens": l32.shape[0], "experts": l32.shape[1], "top_k": k,
            "tokens_routed_differently": n,
            "router_logit_err_max": err.max().item(),
            "differing_gap_max": (gap[differ].max().item() if n else None),
            "ok": bool((allowed | ~differ).all().item())}


def first_routing_flip(ref_calls, got_calls, k: int):
    """The first MoE call, in forward order, at which two f32 runs of the
    same forward (the plain attention and the kernels) route some token
    to another set of k experts, with routing_check's verdict on that
    call (ref_calls, got_calls: each call's (routing input, router) in
    f32): a flip is allowed only at a near-tie of the router logits.
    None when every call routes alike. Past the first flip the runs'
    activations differ by the flipped token's expert outputs, so later
    calls are not compared."""
    import torch
    if len(ref_calls) != len(got_calls):
        raise AssertionError(f"the f32 runs made {len(ref_calls)} and "
                             f"{len(got_calls)} MoE calls")
    for i, (ref, got) in enumerate(zip(ref_calls, got_calls)):
        a = (ref[0] @ ref[1]).topk(k, dim=-1).indices.sort(dim=-1).values
        b = (got[0] @ got[1]).topk(k, dim=-1).indices.sort(dim=-1).values
        if not torch.equal(a, b):
            return {"call": i, "calls": len(ref_calls),
                    **routing_check(ref, got, k)}
    return None


def near_tie_check(want, got, logits32, logits16) -> dict:
    """Greedy tokens of the speculating engine (`got`) against the
    spec-free engine's (`want`), logits [n, V] of want's n
    distributions teacher-forced (f32 weights, and the served bf16
    weights), both through the plain attention. Equal, or the first
    token where they part is a near-tie: the f32 gap between the two
    tokens there is at most BF16_FLOOR_FACTOR times the bf16 plain
    path's own largest error on such a gap over the steps (between
    the f32 best token and the spec-free one, or the runner-up where
    those agree). After the first difference the sequences condition
    on different tokens and are not compared."""
    import torch
    n = len(want)
    differ = [i for i in range(min(n, len(got))) if want[i] != got[i]]
    if not differ and len(got) == n:
        return {"tokens": n, "differ_at": None, "ok": True}
    i = differ[0] if differ else min(n, len(got))
    dev = logits32.device
    w = torch.tensor(want, device=dev)
    top2 = logits32.topk(2, dim=-1).indices
    best = top2[:, 0]
    other = torch.where(w != best, w, top2[:, 1])

    def gap(a):
        return (a.gather(1, best[:, None])[:, 0]
                - a.gather(1, other[:, None])[:, 0])
    noise = (gap(logits16.float()) - gap(logits32)).abs().max().item()
    tol = BF16_FLOOR_FACTOR * noise
    gap_i = (logits32[i, want[i]] - logits32[i, got[i]]).abs().item() \
        if i < min(n, len(got)) else math.inf
    return {"tokens": n, "differ_at": i, "f32_gap": gap_i,
            "bf16_plain_gap_err": noise, "tol": tol, "ok": gap_i <= tol}


def embed_check(embed: dict, pooled32, pooled16_plain) -> dict:
    """The served pooled vector (an input batched with longer ones)
    against the f32 encode of its tokens: at most BF16_FLOOR_FACTOR
    times as far as the bf16 plain path's vector (one incremental
    forward through the plain attention) is; and the vector of the
    input served alone at most as far from the batched one."""
    import torch
    dev = pooled32.device
    batched = torch.tensor(embed["batched"], device=dev)
    alone = torch.tensor(embed["alone"], device=dev)
    floor = (pooled16_plain - pooled32).abs().max().item()
    err = (batched - pooled32).abs().max().item()
    pad = (alone - batched).abs().max().item()
    tol = BF16_FLOOR_FACTOR * floor
    return {"tokens": len(embed["tokens"]), "served_err": err,
            "alone_vs_batched": pad, "bf16_plain_err": floor, "tol": tol,
            "max_abs": pooled32.abs().max().item(),
            "ok": err <= tol and pad <= tol}


def shaped_check(engine, shaped: dict, logits32, logits16) -> dict:
    """The served penalized greedy tokens against the argmax of the
    port's plain adjust_logits over f32 logits [n, V] (row i: the
    distribution of served token i), both teacher-forced on the served
    sequence: logits32 from the f32 weights, logits16 from the served
    bf16 weights, both through the plain attention. Where a served token
    is not the f32 best, the f32 gap between the two must be at most
    BF16_FLOOR_FACTOR times the bf16 plain path's own error on such a
    gap: its largest error, over the steps, on the shaped gap between
    the f32 best token and the runner-up, or the served token where that
    differs. That bound must stay below the smallest penalty term
    (the frequency penalty, 1.0 a repeat), so a path that dropped a
    term fails."""
    import torch
    from production_stack_tpu_torch.engine.sampler import (SamplingParams,
                                                           adjust_logits)
    dev = logits32.device
    n, V = logits32.shape
    served = torch.tensor(shaped["tokens"], device=dev)
    counts = torch.zeros((n, V), dtype=torch.int32, device=dev)
    for i in range(1, n):
        counts[i] = counts[i - 1]
        counts[i, served[i - 1]] += 1
    seen = torch.zeros((n, V), dtype=torch.bool, device=dev)
    seen[:, torch.tensor(shaped["prompt"], device=dev)] = True
    sp = SamplingParams.filled(
        n, temperature=0.0, presence=SHAPED["presence_penalty"],
        frequency=SHAPED["frequency_penalty"],
        repetition=SHAPED["repetition_penalty"], device=dev)
    out_len = torch.arange(n, dtype=torch.int32, device=dev)
    eos = int(engine.engine.tokenizer.eos_token_id)
    adj = adjust_logits(logits32, sp, counts, seen, out_len, eos)
    adj16 = adjust_logits(logits16, sp, counts, seen, out_len, eos)
    top2 = adj.topk(2, dim=-1).indices
    best = top2[:, 0]
    other = torch.where(served != best, served, top2[:, 1])

    def gap(a, t):
        return (a.gather(1, best[:, None])[:, 0]
                - a.gather(1, t[:, None])[:, 0])
    noise = (gap(adj16, other) - gap(adj, other)).abs().max().item()
    gaps = gap(adj, served)
    differ = (best != served).nonzero()[:, 0].tolist()
    worst = max((gaps[i].item() for i in differ), default=0.0)
    tol = BF16_FLOOR_FACTOR * noise
    least_term = min(SHAPED["presence_penalty"], SHAPED["frequency_penalty"])
    return {"tokens": n, "differ_at": differ, "worst_gap": worst,
            "bf16_plain_gap_err": noise, "tol": tol,
            "least_penalty_term": least_term,
            "ok": worst <= tol < least_term}


def device_profile(fn, margin_s: float = 0.1):
    """One call of fn (ending in a host sync) under torch.profiler: its
    host span, the device's busy time within it (the union of kernel,
    copy and set intervals), and the device time and count of each
    kernel name. None where the profiler recorded no device event.
    The traced call follows a warm-up cycle of the profiler (a call
    traced and discarded) and starts and ends `margin_s` inside its
    trace: a trace whose device work begins as it starts loses, in some
    runs, its first device events (on an H100 a decode window's two
    uploads and first few kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    label = "chip_smoke.span"
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            time.sleep(margin_s)
            with record_function(label):
                fn()
                torch.cuda.synchronize()
            time.sleep(margin_s)
            prof.step()
    events = prof.events()
    span = next(e.time_range for e in events
                if e.name == label and e.device_type == DeviceType.CPU)
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                  and e.name != label),
                 key=lambda e: e.time_range.start)
    if not dev:
        return None
    busy, cur_s, cur_e, by_name = 0.0, None, None, {}
    for e in dev:
        s_, e_ = max(e.time_range.start, span.start), \
            min(e.time_range.end, span.end)
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, n + 1)
        if e_ <= s_:
            continue
        if cur_e is None or s_ > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    if cur_e is not None:
        busy += cur_e - cur_s
    return {"span_us": span.end - span.start, "busy_us": busy,
            "by_name": by_name}


def kernel_class(name: str) -> str:
    if "paged_decode" in name or "paged_prefill" in name:
        return "paged_attention"
    low = name.lower()
    if any(k in low for k in ("gemm", "cutlass", "xmma", "sm90_", "gemv",
                              "nvjet")):
        return "matmul"
    if low.startswith("memcpy") or low.startswith("memset"):
        return "copy"
    return "other"


def profile_summary(prof, divide: int, event_ms: float):
    """Idle share of the host span, each kernel class's share of it,
    and device launches, per `divide` steps of the profiled call. The
    profiler slows the host, so the span is longer than the same work
    timed with CUDA events (`event_ms` per step): the device's busy
    time over event_ms is its share of the unprofiled step."""
    if prof is None:
        return {"profiler": "no device events recorded: not measured"}
    span = prof["span_us"]
    classes = {}
    launches = 0
    for name, (t, n) in prof["by_name"].items():
        c = kernel_class(name)
        classes[c] = classes.get(c, 0.0) + t
        launches += n
    top = sorted(prof["by_name"].items(), key=lambda kv: -kv[1][0])[:6]
    return {"span_ms": span / 1e3 / divide,
            "device_busy_ms": prof["busy_us"] / 1e3 / divide,
            "idle_share": 1.0 - prof["busy_us"] / span,
            "busy_share_of_event_time":
                prof["busy_us"] / 1e3 / divide / event_ms,
            "share_of_span": {c: t / span for c, t in classes.items()},
            "device_launches": launches / divide,
            "top_kernels": [{"name": n[:80], "ms": t / 1e3 / divide,
                             "count": c / divide} for n, (t, c) in top]}


def decode_step_timing(runner, path: str, B: int, sp):
    """One decode step at batch B: a greedy window of decode_window
    steps through the runner at the first B rows of the path's
    decode_starts and its kv_len, over linear block tables of
    max_num_seqs rows, with sampling rows `sp` (max_num_seqs of them:
    the runner cuts them to B). Returns its wall per step (CUDA events),
    the profiler's summary per step (profile_summary) and the window."""
    import numpy as np
    p = PATHS[path]
    serve = p["serve"]
    n, W = serve["max_num_seqs"], serve["decode_window"]
    MB = serve["max_model_len"] // serve["kv_block_size"]
    runner.set_block_tables(
        (1 + np.arange(n * MB, dtype=np.int32)).reshape(n, MB))
    starts = np.array(p["decode_starts"][:B], np.int32)

    def window(i=0):
        runner.set_decode_state(np.zeros((B,), np.int32), starts)
        return runner.decode(sp, steps=W, kv_len=p["kv_len"], greedy=True)

    step_ms = time_ms(window, 3) / W
    return (step_ms, profile_summary(device_profile(window), W, step_ms),
            window)


def breakdown_phase(engine, path: str):
    """Device time of one decode step of the whole batch (a window of
    decode_window steps, divided) at the rows decode_starts, and of one
    512-token prefill chunk of one row at chunk_start with the other
    rows parked, through the served model at the shapes the kernel
    timings used (CUDA events); then one window and one chunk under
    torch.profiler: the device's idle share and each kernel class's
    share of the span, read from the trace."""
    import numpy as np
    import torch
    from production_stack_tpu_torch.engine.sampler import SamplingParams
    from production_stack_tpu_torch.models.quant import is_quantized

    runner = engine.engine.runner
    dev = next(runner.params.parameters()).device
    p = PATHS[path]
    serve, kv_len = p["serve"], p["kv_len"]
    B, W, S = serve["max_num_seqs"], serve["decode_window"], \
        serve["max_model_len"]
    sp = SamplingParams.filled(B, temperature=0.0, device=dev)
    starts = np.array(p["decode_starts"], np.int32)
    # also sets the tables the chunk reads
    step_ms, step_prof, window = decode_step_timing(runner, path, B, sp)

    def chunk(i=0):
        return runner.prefill(
            np.zeros((B, 512), np.int32),
            np.array([p["chunk_start"]] + [S] * (B - 1), np.int32),
            np.array([512] + [1] * (B - 1), np.int32), sp, kv_len,
            greedy=True)

    chunk_ms = time_ms(chunk, 3)
    out = {"path": path, "decode_step_ms": step_ms,
           "prefill_chunk_ms": chunk_ms, "batch": B, "kv_len": kv_len,
           "decode_starts": p["decode_starts"],
           "chunk_start": p["chunk_start"],
           "decode_profile_per_step": step_prof,
           "prefill_profile_per_chunk": profile_summary(
               device_profile(chunk), 1, chunk_ms)}
    if runner.model_cfg.num_experts:
        out.update(moe_breakdown(runner, p, out))
    if is_quantized(runner.params.q):
        out.update(int8_convert_breakdown(runner, out))
    if path in PLAIN_DECODE_LAUNCHES:
        out.update(shaped_breakdown(runner, sp, window, W, kv_len, starts))
        out.update(guided_breakdown(engine, sp, W, kv_len, starts))
        got = out["decode_profile_per_step"].get("device_launches")
        out["guided_added_launches_per_step"] = (
            out["guided_decode_profile_per_step"].get("device_launches", 0)
            - (got or 0))
        if got != PLAIN_DECODE_LAUNCHES[path]:
            log(json.dumps({"breakdown": out}))
            raise AssertionError(
                f"the plain decode step launched {got} times per step, "
                f"not the {PLAIN_DECODE_LAUNCHES[path]} it launched "
                f"before logit shaping existed")
    log(json.dumps({"breakdown": out}))
    return out


def moe_breakdown(runner, p: dict, plain: dict) -> dict:
    """The MoE MLP's share of the decode step and of the prefill chunk
    that breakdown_phase measured: the device time (CUDA graph replay,
    device_ms) of one layer's MoE block (the routed experts and the
    shared expert, llama._moe_block) at the step's shape (B tokens: the
    exact path) and at the chunk's (B x 512 tokens, one row live: the
    dispatch), on normal(0, 1) activations, the layers taken in turn;
    times the layer count, over the step's and the chunk's device busy
    time and their CUDA-event time."""
    import torch
    from production_stack_tpu_torch.models import llama
    cfg = runner.model_cfg
    B, H, L = p["serve"]["max_num_seqs"], cfg.hidden_size, cfg.num_layers
    dev = runner.device
    g = torch.Generator(device=dev).manual_seed(17)
    layers = llama.layer_params(runner.params)
    out = {}
    for name, T, live, key, ms_key in (
            ("decode", 1, B, "decode_profile_per_step", "decode_step_ms"),
            ("prefill", 512, 1, "prefill_profile_per_chunk",
             "prefill_chunk_ms")):
        hidden = torch.randn((B, T, H), generator=g, device=dev).to(
            cfg.dtype)
        valid = torch.zeros((B, T), dtype=torch.bool, device=dev)
        valid[:live] = True

        def block(i=0):
            return llama._moe_block(cfg, runner.params, layers[i % L],
                                    hidden, valid)
        ms = device_ms(block, 2 * L)
        busy = plain[key].get("device_busy_ms")
        out[f"moe_{name}_layer_ms"] = ms
        out[f"moe_{name}_ms"] = ms * L
        out[f"moe_share_of_{name}_busy"] = ms * L / busy if busy else None
        out[f"moe_share_of_{name}_event_ms"] = ms * L / plain[ms_key]
    return out


def int8_convert_breakdown(runner, plain: dict) -> dict:
    """The int8 weights' converts that one decode step and one prefill
    chunk make: each product converts its whole int8 weight to the model
    dtype before the matmul (quant.dequant_matmul; the head in _lm_head),
    once per forward, at any batch. Device time (CUDA graph replay,
    device_ms) of every layer's int8 leaves converted, the layers taken
    in turn, times the layers, plus the head's; over the step's and the
    chunk's device busy time; the expert stacks' converts apart (a MoE
    decode step's exact path and a chunk's dispatch convert every
    expert)."""
    from production_stack_tpu_torch.models.llama import LAYER_KEYS
    from production_stack_tpu_torch.models.quant import is_quantized
    cfg, params = runner.model_cfg, runner.params
    L = cfg.num_layers
    names = [n for n in LAYER_KEYS if is_quantized(getattr(params, n, None))]
    experts = [n for n in ("gate", "up", "down") if cfg.num_experts]
    head = params.embed if cfg.tie_word_embeddings else params.lm_head

    def converts(leaves):
        def fn(i=0):
            for n in leaves:
                getattr(params, n).w8[i % L].to(cfg.dtype)
        return fn
    layers_ms = device_ms(converts(names), L) * L
    experts_ms = device_ms(converts(experts), L) * L if experts else 0.0
    head_ms = device_ms(lambda i=0: head.w8.to(cfg.dtype), 2)
    total = layers_ms + head_ms
    out = {"int8_convert_ms": total, "int8_convert_layers_ms": layers_ms,
           "int8_convert_head_ms": head_ms,
           "int8_convert_experts_ms": experts_ms,
           "int8_weight_bytes": sum(t.nbytes for t in params.buffers())}
    # a step's floor: every int8 weight (and its scales) read once
    out["int8_weights_read_bound_ms"] = (out["int8_weight_bytes"] / HBM_BPS
                                         * 1e3)
    for name, key in (("decode", "decode_profile_per_step"),
                      ("prefill", "prefill_profile_per_chunk")):
        busy = plain[key].get("device_busy_ms")
        out[f"int8_convert_share_of_{name}_busy"] = (total / busy if busy
                                                     else None)
        if experts:
            moe_ms = plain.get(f"moe_{name}_ms")
            out[f"int8_convert_experts_share_of_moe_{name}"] = (
                experts_ms / moe_ms if moe_ms else None)
    return out


def lora_breakdown(engine, path: str, plain: dict):
    """The decode step of breakdown_phase with two adapter rows (ad-npz
    and ad-three, loaded by lora_phase, rank 16 on all seven targets)
    and two base rows: wall (CUDA events), device busy time, launches
    and idle share per step from a torch.profiler trace, beside the
    plain step `plain` that breakdown_phase measured before any adapter
    was loaded. The rows' factors are gathered at the first call (a new
    sampling upload), as at an engine's composition change."""
    import dataclasses

    import torch
    from production_stack_tpu_torch.engine.sampler import SamplingParams
    eng = engine.engine
    runner = eng.runner
    serve = PATHS[path]["serve"]
    B = serve["max_num_seqs"]
    dev = runner.device
    ids = [eng.lora_ids["ad-npz"], 0, eng.lora_ids["ad-three"], 0]
    sp = dataclasses.replace(
        SamplingParams.filled(B, temperature=0.0, device=dev),
        adapter=torch.tensor(ids, dtype=torch.int32, device=dev))
    t0 = time.monotonic()
    step_ms, prof, _ = decode_step_timing(runner, path, B, sp)
    base = plain["decode_profile_per_step"]
    out = {"path": path, "adapter_ids": ids,
           "lora_rank": serve["lora_rank"], "targets": list(LORA_TARGETS),
           "lora_decode_step_ms": step_ms,
           "lora_decode_profile_per_step": prof,
           "plain_decode_step_ms": plain["decode_step_ms"],
           "plain_device_busy_ms": base.get("device_busy_ms"),
           "plain_device_launches": base.get("device_launches"),
           "added_launches_per_step": (prof.get("device_launches", 0)
                                       - (base.get("device_launches")
                                          or 0)),
           "seconds": time.monotonic() - t0}
    log(json.dumps({"lora_breakdown": out}))
    if out["added_launches_per_step"] <= 0:
        raise AssertionError("the adapter rows' step launched no more "
                             "than the plain step: the LoRA products did "
                             "not run")
    return out


def shaped_breakdown(runner, sp, window, W, kv_len, starts) -> dict:
    """The decode step with one shaped row (SHAPED penalties, a prompt
    of SURFACE_PROMPT tokens) and top-5 alternatives among the batch,
    timed and profiled as the plain step is; the counts ride the device
    across calls as they do across an engine's windows."""
    import dataclasses

    import numpy as np
    import torch
    B = len(starts)
    V = runner.model_cfg.vocab_size
    dev = sp.temperature.device
    row = torch.arange(B, device=dev) == 0

    def one_row(value, inert, dtype=torch.float32):
        return torch.where(row, torch.tensor(value, dtype=dtype, device=dev),
                           torch.tensor(inert, dtype=dtype, device=dev))
    shaped = dataclasses.replace(
        sp, presence=one_row(SHAPED["presence_penalty"], 0.0),
        frequency=one_row(SHAPED["frequency_penalty"], 0.0),
        repetition=one_row(SHAPED["repetition_penalty"], 1.0),
        prompt_len=torch.tensor(starts, dtype=torch.int32, device=dev))
    seen = np.zeros((B, V), bool)
    seen[0, surface_prompt(1)] = True
    runner.set_penalty_state(np.zeros((B, V), np.int32), seen)

    def shaped_window(i=0):
        runner.set_decode_state(np.zeros((B,), np.int32), starts)
        return runner.decode(shaped, steps=W, kv_len=kv_len, greedy=True,
                             penalized=True, topk=5)

    step_ms = time_ms(shaped_window, 3) / W
    return {"shaped_decode_step_ms": step_ms,
            "shaped_decode_profile_per_step": profile_summary(
                device_profile(shaped_window), W, step_ms)}


def guided_breakdown(engine, sp, W, kv_len, starts) -> dict:
    """The decode step with one guided row ((red|green|blue), its table
    stacked as the engine stacks it) among the batch, timed and
    profiled as the plain step is; the DFA states are uploaded with the
    tokens at each call, as at an engine's composition change."""
    import numpy as np
    import torch
    from production_stack_tpu_torch.engine import guided
    from production_stack_tpu_torch.engine.engine import stack_guided_tables
    eng = engine.engine
    runner = eng.runner
    B = len(starts)
    table = torch.from_numpy(stack_guided_tables(
        [guided.compile_grammar("(red|green|blue)", eng.tokenizer)],
        eng.model_cfg.vocab_size)).to(runner.device)
    gids = np.zeros(B, np.int32)
    gids[0] = 1

    def guided_window(i=0):
        runner.set_decode_state(np.zeros((B,), np.int32), starts,
                                guide_states=np.zeros((B,), np.int32))
        return runner.decode(sp, steps=W, kv_len=kv_len, greedy=True,
                             guide_table=table, guide_ids=gids)

    step_ms = time_ms(guided_window, 3) / W
    return {"guided_table_shape": list(table.shape),
            "guided_decode_step_ms": step_ms,
            "guided_decode_profile_per_step": profile_summary(
                device_profile(guided_window), W, step_ms)}


def roll_phase(engine, path: str) -> dict:
    """Rolling KV on a model windowed on every layer, through the engine
    itself (its server has stopped): one greedy request of long_tokens
    random prompt ids (seed 13) and ROLL_TOKENS new tokens. At the first
    decode dispatch the engine frees the blocks wholly behind the
    window, (long_tokens - W + 1) // Bs of them, and the pool's free
    blocks rise by as many (read around _roll_windows, before the same
    dispatch grows the row); both paged kernels launched, every launch
    windowed. The engine serves at its default pipeline_depth of 2 (some
    window dispatched ahead while the blocks roll), and the same request
    at depth 1 gives the same tokens. Returns the prompt and the served
    tokens for reference_phase, which holds them against the f32
    teacher-forced argmax (near_tie_check)."""
    import random
    from production_stack_tpu_torch.engine.scheduler import SamplingOptions
    from production_stack_tpu_torch.ops import paged_attention as pa
    eng = engine.engine
    cfg = eng.model_cfg
    P, W = PATHS[path]["long_tokens"], cfg.sliding_window
    Bs = eng.cfg.kv_block_size
    rnd = random.Random(13)
    prompt = [rnd.randrange(cfg.vocab_size) for _ in range(P)]
    rolls, dispatches = [], []
    roll, dispatch = eng._roll_windows, eng._dispatch_decode

    def observed(decode_seqs):
        before = eng.block_mgr.available
        roll(decode_seqs)
        rolls.append({"free_before": before,
                      "free_after": eng.block_mgr.available,
                      "rolled": [s.rolled_blocks for s in decode_seqs]})

    def dispatched(decode_seqs, ahead=0):
        ok = dispatch(decode_seqs, ahead)
        dispatches.append(bool(ok and ahead))
        return ok

    def serve():
        sid = eng.add_request(prompt, SamplingOptions(
            temperature=0.0, max_tokens=ROLL_TOKENS, ignore_eos=True))
        while eng.has_work:
            eng.step()
        return eng.seqs[sid]
    eng._roll_windows = observed
    eng._dispatch_decode = dispatched
    pa.reset_launch_counts()
    t0 = time.monotonic()
    try:
        seq = serve()
    finally:
        del eng._roll_windows, eng._dispatch_decode
    depth = eng.cfg.pipeline_depth
    ahead_windows = sum(dispatches)
    # the same request with no window dispatched ahead: the engine reads
    # pipeline_depth at every step
    eng.cfg.pipeline_depth = 1
    try:
        depth1 = serve()
    finally:
        eng.cfg.pipeline_depth = depth
    want = (P - W + 1) // Bs
    first = rolls[0] if rolls else {}
    out = {"path": path, "prompt_tokens": P, "window": W,
           "block_size": Bs, "tokens": len(seq.output_tokens),
           "first_window": first, "rolls": len(rolls),
           "rolled_blocks_at_finish": seq.rolled_blocks,
           "want_first_rolled": want,
           "launches": dict(pa.launch_counts),
           "window_launches": dict(pa.window_launches),
           "pipeline_depth": depth, "ahead_windows": ahead_windows,
           "depth1_tokens_equal": depth1.output_tokens == seq.output_tokens,
           "seconds": time.monotonic() - t0}
    out["ok"] = (bool(first) and first["rolled"] == [want]
                 and depth == 2 and ahead_windows > 0
                 and out["depth1_tokens_equal"]
                 and first["free_after"] - first["free_before"] == want
                 and len(seq.output_tokens) == ROLL_TOKENS
                 and all(out["launches"][n] > 0
                         and out["window_launches"][n] == out["launches"][n]
                         for n in pa.launch_counts))
    log(json.dumps({"roll": out}))
    if not out["ok"]:
        raise AssertionError(f"rolling KV did not free the blocks behind "
                             f"the window as expected: {out}")
    return {"prompt": prompt, "tokens": list(seq.output_tokens)}


# the windows phase: continuous batching across decode windows at JAX's
# defaults on the llama-3-8b path's serve geometry. 8 greedy requests of
# random prompt ids (seed) in two waves of 4, the second added once the
# first wave's second window has been read
WINDOWS = dict(path="llama-3-8b",
               prompt_lens=(40, 300, 128, 75, 210, 60, 280, 150),
               max_tokens=(5, 9, 17, 33, 12, 24, 48, 64), seed=17,
               wave2_after_windows=2)
# the engines the phase compares, in the order they serve the mix: the
# fixed geometry (the tokens' reference), then JAX's defaults (adaptive
# windows, depth 2) and adaptive windows at depth 1, twice each (the
# first serve of a batch bucket initialises its GEMM plans)
WINDOW_MODES = (("fixed_depth1", False, 1), ("adapt_depth2", True, 2),
                ("adapt_depth1", True, 1), ("adapt_depth2", True, 2),
                ("adapt_depth1", True, 1))


def windows_serve(eng, prompts) -> dict:
    """Serve WINDOWS' mix through the engine loop, driven here, watching
    its windows: per dispatch whether it went ahead and its batch; the
    decode kernel's steps by batch (the wrapper's step_launches); a
    CUDA event after each window's last launch; the rows a read window discarded; and the host time at which
    step() handed each read window's tokens out. The delivery lag of a
    window is that time less its end on the card (the event, placed on
    the host clock by a reference event recorded on the idle card)."""
    import torch
    from production_stack_tpu_torch.engine.scheduler import (SamplingOptions,
                                                             SeqStatus)
    from production_stack_tpu_torch.ops import paged_attention as pa
    runner = eng.runner
    decode0, dispatch0 = runner.decode, eng._dispatch_decode
    process0 = eng._process_window
    wins, read = [], []

    def decode(*a, **kw):
        out = decode0(*a, **kw)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        wins.append({"batch": int(runner._dec_tokens.shape[0]), "end": end,
                     "ahead": False})
        return out

    def dispatch(decode_seqs, ahead=0):
        ok = dispatch0(decode_seqs, ahead)
        if ok and ahead:
            wins[-1]["ahead"] = True
        return ok

    def process(synced):
        if synced is not None:
            w = wins[len(read)]
            w["rows"] = len(synced[5])
            w["discarded"] = sum(s.status is not SeqStatus.RUNNING
                                 for s in synced[5])
            read.append(w)
        return process0(synced)

    runner.decode, eng._dispatch_decode = decode, dispatch
    eng._process_window = process
    ring0 = len(eng.eff._windows)
    n = len(prompts)
    half = n // 2
    ids, added, first = [None] * n, [0.0] * n, {}
    torch.cuda.synchronize()
    ref = torch.cuda.Event(enable_timing=True)
    ref.record()
    t_ref = time.perf_counter()
    pa.reset_launch_counts()

    def add(lo, hi):
        for i in range(lo, hi):
            added[i] = time.perf_counter()
            ids[i] = eng.add_request(prompts[i], SamplingOptions(
                temperature=0.0, max_tokens=WINDOWS["max_tokens"][i],
                ignore_eos=True))
    try:
        add(0, half)
        steps = 0
        while eng.has_work or ids[-1] is None:
            before = len(read)
            outs = eng.step()
            t = time.perf_counter()
            steps += 1
            for w in read[before:]:
                w["handed"] = t
            for o in outs:
                if o.new_token is not None and o.seq_id not in first:
                    first[o.seq_id] = t
            if ids[-1] is None and len(read) >= WINDOWS["wave2_after_windows"]:
                add(half, n)
            if steps > 5000:
                raise AssertionError("the windows mix did not finish")
        wall = time.perf_counter() - added[0]
        launches = dict(pa.launch_counts)
        by_batch = {B: c["launches"] for B, c in sorted(
            pa.launch_report()["step_launches"].items())}
        torch.cuda.synchronize()
        eng._drain_decode()
    finally:
        del runner.decode, eng._dispatch_decode, eng._process_window
    lags = [1e3 * (w["handed"] - t_ref - ref.elapsed_time(w["end"]) / 1e3)
            for w in read if "handed" in w]
    ring = list(eng.eff._windows)[ring0:]
    geometry = {}
    for w in ring:
        key = f"{w['batch']}x{w['steps']}x{w['kv_len']}"
        geometry[key] = geometry.get(key, 0) + 1
    ahead = [w for w in read if w["ahead"]]
    return {
        "tokens": [list(eng.seqs[i].output_tokens) for i in ids],
        "wall_s": wall,
        "ttft_s": [first[i] - a for i, a in zip(ids, added)],
        "windows": len(ring), "geometry": geometry,
        "batches": sorted({w["batch"] for w in ring}),
        "ahead": {"windows": len(ahead),
                  "rows": sum(w["rows"] for w in ahead),
                  "discarded_rows": sum(w["discarded"] for w in ahead)},
        "discarded_rows": sum(w["discarded"] for w in read),
        "decode_launches_by_batch": by_batch,
        "launches": launches,
        "delivery_lag_ms": {
            "windows": len(lags), "mean": sum(lags) / len(lags),
            "p50": sorted(lags)[len(lags) // 2], "max": max(lags),
            "min": min(lags)},
        "dead_token_steps": sum(w["dead"] for w in ring),
        "pad_token_steps": sum(w["pad"] for w in ring),
        "real_token_steps": sum(w["real"] for w in ring)}


def windows_phase(params, device="cuda") -> dict:
    """Continuous batching across decode windows on the card: WINDOWS'
    mix through engines on the served weights (`params`, shared, never
    copied) in each of WINDOW_MODES. At JAX's defaults the windows reach
    batch buckets 1, 2 and 4 (the decode kernel launched at each), some
    are dispatched ahead, and every request's tokens equal the fixed
    geometry's, or part at a near-tie (_tokens_check against the f32
    teacher-forced logits). Prints the window geometries, the windows
    dispatched ahead with their discarded rows, the decode kernel's
    launches by batch, the mix's wall, each request's TTFT and the
    delivery lag of each mode, and a decode step's wall, busy time and
    launches at B = 1, 2 and 4."""
    import random

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.sampler import SamplingParams
    t0 = time.monotonic()
    path = WINDOWS["path"]
    serve = dict(PATHS[path]["serve"])
    engines, runs = {}, {}
    rnd = random.Random(WINDOWS["seed"])
    V = params.cfg.vocab_size
    prompts = [[rnd.randrange(V) for _ in range(n)]
               for n in WINDOWS["prompt_lens"]]
    for name, adapt, depth in WINDOW_MODES:
        if name not in engines:
            engines[name] = LLMEngine(EngineConfig(
                model=path_model(path), device=device, **serve,
                window_adapt=adapt, pipeline_depth=depth), params=params)
        runs.setdefault(name, []).append(windows_serve(engines[name],
                                                       prompts))
    fixed = runs["fixed_depth1"][0]
    # every adaptive serve's tokens against the fixed geometry's
    checks = {name: [[_tokens_check(got, engines["fixed_depth1"], p, w)
                      for p, got, w in zip(prompts, r["tokens"],
                                           fixed["tokens"])]
                     for r in rs]
              for name, rs in runs.items() if name != "fixed_depth1"}
    first = runs["adapt_depth2"][0]
    runner = engines["adapt_depth2"].runner
    sp = SamplingParams.filled(serve["max_num_seqs"], temperature=0.0,
                               device=runner.device)
    steps = []
    for B in (1, 2, 4):
        step_ms, prof, _ = decode_step_timing(runner, path, B, sp)
        steps.append({"batch": B, "step_ms": step_ms,
                      **{k: prof.get(k) for k in (
                          "device_busy_ms", "idle_share",
                          "device_launches")}})
    out = {"path": path, "modes": {
        name: [{k: v for k, v in r.items() if k != "tokens"} for r in rs]
        for name, rs in runs.items()},
        "tokens_vs_fixed": checks, "step_by_batch": steps,
        "seconds": time.monotonic() - t0}
    log(json.dumps({"windows": out}))
    W = serve["decode_window"]
    ok = (first["batches"] == [1, 2, 4]
          and all(first["decode_launches_by_batch"].get(b, 0) > 0
                  for b in (1, 2, 4))
          and first["launches"]["paged_attention"] > 0
          and first["ahead"]["windows"] > 0
          and all(c["ok"] for cs in checks.values() for run in cs
                  for c in run)
          and set(fixed["geometry"]) <= {f"{serve['max_num_seqs']}x{W}x{kv}"
                                        for kv in (512, 1024)})
    if not ok:
        raise AssertionError(f"continuous batching across windows: {out}")
    for eng in engines.values():
        eng.runner = None
    del engines
    free_memory()
    return out


def model_phase(path: str):
    """Serve one path's model at full width and depth, then its breakdown
    and its reference; returns the kernels' launch counts of the serving
    run (serve_phase). The engine is freed before returning."""
    import torch
    from production_stack_tpu_torch.engine.async_engine import \
        AsyncLLMEngine
    from production_stack_tpu_torch.engine.config import EngineConfig
    free_memory()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    engine = AsyncLLMEngine(EngineConfig(model=path_model(path),
                                         device="cuda",
                                         **PATHS[path]["serve"]))
    torch.cuda.synchronize()
    build = build_check(engine.engine, mem0, time.monotonic() - t0)
    engine.engine.runner.warmup()
    runner = engine.engine.runner
    cfg = engine.engine.model_cfg
    log(json.dumps({"engine_ready_s": time.monotonic() - t0,
                    "path": path, "model": cfg.name,
                    "layers": cfg.num_layers, "hidden": cfg.hidden_size,
                    "params": cfg.num_params,
                    "quantization": engine.engine.cfg.quantization,
                    "kv_dtype": engine.engine.cfg.kv_dtype, **build,
                    "mem_gib": torch.cuda.memory_allocated() / 2**30}))
    if not build["ok"]:
        raise AssertionError(f"{path}: the build's peak memory passed "
                             f"what it keeps by more than its bound: "
                             f"{build}")
    t0 = time.monotonic()
    counts, surface = asyncio.run(serve_phase(engine, path))
    if cfg.sliding_window and not cfg.alternating_sliding:
        surface["roll"] = roll_phase(engine, path)
    plain = breakdown_phase(engine, path)
    surface.update(asyncio.run(feature_phase(engine, path)))
    if path in PLAIN_DECODE_LAUNCHES:
        lora_breakdown(engine, path, plain)
    if path == WINDOWS["path"]:
        # before the pool is dropped: its engines share these weights
        surface["windows"] = windows_phase(runner.params)
        # the decode steps by batch bucket at JAX's defaults
        counts["windows_by_batch"] = surface["windows"]["modes"][
            "adapt_depth2"][0]["decode_launches_by_batch"]
    # the speculative serving runs' launches by window length T
    counts["verify"] = surface["spec"].get("verify", {})
    counts["verify_window"] = surface["spec"].get("verify_window", {})
    # serving is over: the pool goes before the float32 copy arrives
    engine.engine.runner.cache = None
    del runner
    free_memory()
    reference_phase(engine, path, surface)
    release(engine)
    log(json.dumps({"model_phase_s": time.monotonic() - t0,
                    "path": path}))
    return counts


# an int8 build's device memory past what it keeps, in f32 copies of the
# largest layer (or the whole embedding or head): the layer's f32 draw,
# its rounding to the model dtype and one slice's quantize temporaries
INT8_BUILD_TRANSIENT = 3


def build_check(eng, mem0: int, build_s: float) -> dict:
    """An engine's build on the card (weights and pool), read right after
    its constructor: seconds, the weights' and the pool's bytes, the
    device's peak while it ran (max_memory_allocated after
    reset_peak_memory_stats) and the peak past what the build left
    allocated. With int8 weights, built a layer at a time, that excess
    must stay within INT8_BUILD_TRANSIENT f32 copies of the largest
    layer; a model drawn whole in the model dtype and then quantized
    would pass it by the model's size."""
    runner = eng.runner
    pool = runner.cache
    out = {"build_s": build_s,
           "weight_bytes": sum(t.nbytes for t in (
               *runner.params.parameters(), *runner.params.buffers())),
           "pool_bytes": sum(t.nbytes for t in (pool.k, pool.v, pool.ks,
                                                pool.vs) if t is not None),
           **build_memory(eng.model_cfg, mem0)}
    out["ok"] = (eng.cfg.quantization != "int8"
                 or out["transient_gb"] <= out["transient_bound_gb"])
    return out


def build_memory(cfg, mem0: int) -> dict:
    """The device's peak since reset_peak_memory_stats past mem0 (what
    was allocated before) and past what is allocated now, and the bound
    on the latter for an int8 build of cfg: INT8_BUILD_TRANSIENT f32
    copies of its largest layer."""
    import torch
    from production_stack_tpu_torch.models.llama import (LAYER_KEYS,
                                                         leaf_shapes)
    peak, held = torch.cuda.max_memory_allocated(), \
        torch.cuda.memory_allocated()
    largest = max(math.prod(shape[1:] if name in LAYER_KEYS else shape)
                  for name, shape in leaf_shapes(cfg).items())
    return {"peak_gb": (peak - mem0) / 1e9,
            "transient_gb": (peak - held) / 1e9,
            "mem_before_gb": mem0 / 1e9,
            "transient_bound_gb": INT8_BUILD_TRANSIENT * 4 * largest / 1e9}


# checkpoint_phase's directory: Llama-3-8B's widths at 2 layers, HF
# names, bf16, two safetensors shards, written from a seed-0 draw
CHECKPOINT_DIR = os.path.join(REPO, "build", "checkpoint")
CHECKPOINT_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "model_type": "llama",
    "vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 2, "num_attention_heads": 32,
    "num_key_value_heads": 8, "max_position_embeddings": 8192,
    "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
    "tie_word_embeddings": False, "attention_bias": False,
    "hidden_act": "silu", "torch_dtype": "bfloat16"}


def hf_shards(model, cfg) -> list:
    """The Llama module's weights under HF names and layouts ([out, in]
    projections, an expert stack's experts apart; the names
    hf_loader reads), on the CPU, as two shards: the embedding and
    layer 0, then the rest."""
    from production_stack_tpu_torch.models.hf_loader import _hf_names
    from production_stack_tpu_torch.models.llama import LAYER_KEYS
    first, second = {}, {}

    def put(shard, name, w, transpose):
        shard[name] = (w.t() if transpose else w).detach().contiguous().cpu()
    for ours, (hf, transpose) in _hf_names(cfg).items():
        leaf = getattr(model, ours, None)
        if leaf is None:
            continue
        if ours not in LAYER_KEYS:
            put(first if ours == "embed" else second,
                hf if ours == "lm_head" else f"model.{hf}", leaf, transpose)
            continue
        for i in range(cfg.num_layers):
            shard, name = first if i == 0 else second, f"model.layers.{i}.{hf}"
            if "{e}" in name:
                for e in range(cfg.num_experts):
                    put(shard, name.format(e=e), leaf[i, e], transpose)
            else:
                put(shard, name, leaf[i], transpose)
    return [first, second]


def write_checkpoint(where: str, hf_config: dict, device: str):
    """A fresh directory `where` holding hf_config as config.json and the
    seed-0 draw of its model (llama.init_params, bf16) as two
    .safetensors shards (hf_shards); (its config, the drawn module, the
    shards' bytes, seconds to write them)."""
    import shutil

    import torch
    from production_stack_tpu_torch.models import hf_loader, llama
    from production_stack_tpu_torch.models.config import get_config
    shutil.rmtree(where, ignore_errors=True)
    os.makedirs(where)
    with open(os.path.join(where, "config.json"), "w") as f:
        json.dump(hf_config, f)
    cfg = get_config(where)
    drawn = llama.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    t0 = time.monotonic()
    nbytes = 0
    for i, shard in enumerate(hf_shards(drawn, cfg)):
        path = os.path.join(where, f"model-{i + 1:05d}-of-00002.safetensors")
        hf_loader.save_safetensors(shard, path)
        nbytes += os.path.getsize(path)
        del shard
    return cfg, drawn, nbytes, time.monotonic() - t0


def same_weights(a, b) -> bool:
    """Two Llama modules hold the same leaves, bit for bit (an int8
    leaf's w8 and scale)."""
    import torch
    x, y = a.state_dict(), b.state_dict()
    return sorted(x) == sorted(y) and all(
        x[k].dtype == y[k].dtype and torch.equal(x[k], y[k]) for k in x)


def checkpoint_phase(device="cuda"):
    """HF checkpoint loading on the card: a directory with a config.json
    of Llama-3-8B's widths at 2 layers and the seed-0 draw's bf16
    weights in two .safetensors shards (the port's writer), loaded by
    the port's reader (hf_loader.load_checkpoint: bytes, seconds,
    GB/s); an engine started with model = checkpoint = the directory
    serves two greedy requests, and its weights and its logits on one
    prompt (through the kernels) are bit for bit those of an engine
    given the drawn weights in memory, as are both requests' tokens.
    Loaded with quantization="int8" (a tensor at a time, each layer
    quantized as it lands) it equals quant.quantize_params of the bf16
    load bit for bit. Both engines are freed and the directory deleted
    before returning; then int8_checkpoint_phase."""
    import shutil

    import torch
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.scheduler import SamplingOptions
    from production_stack_tpu_torch.models import hf_loader, llama
    from production_stack_tpu_torch.models.kv import make_slot_cache
    from production_stack_tpu_torch.models.quant import quantize_params
    t_phase = time.monotonic()
    cfg, drawn, nbytes, write_s = write_checkpoint(
        CHECKPOINT_DIR, CHECKPOINT_CONFIG, device)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    loaded = hf_loader.load_checkpoint(cfg, CHECKPOINT_DIR, device=device)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    same = all(torch.equal(p, getattr(drawn, n))
               for n, p in loaded.named_parameters())
    # int8: a tensor at a time, each layer quantized as it lands, against
    # the bf16 load quantized whole
    t0 = time.monotonic()
    loaded8 = hf_loader.load_checkpoint(cfg, CHECKPOINT_DIR, device=device,
                                        quantization="int8")
    torch.cuda.synchronize()
    load8_s = time.monotonic() - t0
    int8_equal = same_weights(loaded8, quantize_params(loaded))
    del loaded, loaded8
    free_memory()
    # the directory holds no tokenizer files: the byte tokenizer, named
    # outright so no tokenizer library is tried on the directory
    serve = dict(max_model_len=256, max_num_seqs=2, prefill_chunk=64,
                 kv_block_size=64, decode_window=8, tokenizer="byte")
    t0 = time.monotonic()
    from_dir = LLMEngine(EngineConfig(model=CHECKPOINT_DIR,
                                      checkpoint=CHECKPOINT_DIR,
                                      device=device, **serve))
    engine_s = time.monotonic() - t0
    in_memory = LLMEngine(EngineConfig(model=CHECKPOINT_DIR, device=device,
                                       **serve), params=drawn)
    same = same and all(
        torch.equal(p, getattr(in_memory.runner.params, n))
        for n, p in from_dir.runner.params.named_parameters())
    prompts = [surface_prompt(40), surface_prompt(41)[:25]]

    def served(engine):
        ids = [engine.add_request(p, SamplingOptions(
            temperature=0.0, max_tokens=8, ignore_eos=True))
            for p in prompts]
        while engine.has_work:
            engine.step()
        return [list(engine.seqs[i].output_tokens) for i in ids]

    def logits(engine):
        runner = engine.runner
        cache, tables = make_slot_cache(
            cfg.num_layers, 1, 64, cfg.num_kv_heads, cfg.head_dim_,
            dtype=torch.bfloat16, block_size=64, device=device)
        toks = torch.tensor([prompts[0]], device=device)
        out, _ = llama.forward(
            runner.params, runner.model_cfg, toks,
            torch.arange(len(prompts[0]), device=device)[None], cache,
            block_tables=tables, rope=runner.rope, kv_len=64)
        return out

    tokens = served(from_dir)
    tokens_mem = served(in_memory)
    bitwise = bool(torch.equal(logits(from_dir), logits(in_memory)))
    for engine in (from_dir, in_memory):
        engine.runner = None
    del from_dir, in_memory, drawn
    free_memory()
    shutil.rmtree(CHECKPOINT_DIR)
    out = {"layers": cfg.num_layers, "hidden": cfg.hidden_size,
           "vocab": cfg.vocab_size, "shards": 2, "bytes": nbytes,
           "write_s": write_s, "load_s": load_s,
           "load_gb_per_s": nbytes / load_s / 1e9,
           "engine_start_s": engine_s, "weights_equal": same,
           "int8_load_s": load8_s,
           "int8_equal_quantized_bf16_load": int8_equal,
           "tokens": tokens, "tokens_equal_in_memory": tokens == tokens_mem,
           "logits_bitwise_equal": bitwise,
           "seconds": time.monotonic() - t_phase}
    log(json.dumps({"checkpoint": out}))
    if not (same and bitwise and tokens == tokens_mem and int8_equal
            and all(len(t) == 8 for t in tokens)):
        raise AssertionError(f"the checkpoint engine differs from the "
                             f"in-memory one: {out}")
    int8_checkpoint_phase(device)


# int8_checkpoint_phase's directory: Mixtral-8x7B's widths at 1 layer, HF
# names, bf16, two safetensors shards (the embedding and the layer, then
# the final norm and the head), written from a seed-0 draw
MIXTRAL_CHECKPOINT_DIR = os.path.join(REPO, "build", "checkpoint_mixtral")
MIXTRAL_CHECKPOINT_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 1, "num_attention_heads": 32,
    "num_key_value_heads": 8, "max_position_embeddings": 32768,
    "rope_theta": 1000000.0, "rms_norm_eps": 1e-5, "num_local_experts": 8,
    "num_experts_per_tok": 2, "tie_word_embeddings": False,
    "hidden_act": "silu", "torch_dtype": "bfloat16"}


def int8_checkpoint_phase(device="cuda"):
    """A quantizing checkpoint load at Mixtral's widths: a directory of
    Mixtral-8x7B at 1 layer (3.4 GB bf16: a layer's 8 x 3 experts of
    14336, its attention, the embedding and the head), loaded with
    quantization="int8" (each tensor read from its byte range, each
    layer quantized as it lands): the shards' bytes, seconds, GB/s, the
    peak device memory over the load beside the int8 bytes it keeps
    (the transient held to build_check's bound), and the result bit for
    bit quant.quantize_params of the drawn weights. The directory is
    deleted before returning."""
    import shutil

    import torch
    from production_stack_tpu_torch.models import hf_loader
    from production_stack_tpu_torch.models.quant import quantize_params
    t_phase = time.monotonic()
    cfg, drawn, nbytes, write_s = write_checkpoint(
        MIXTRAL_CHECKPOINT_DIR, MIXTRAL_CHECKPOINT_CONFIG, device)
    want = quantize_params(drawn)
    free_memory()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    loaded = hf_loader.load_checkpoint(cfg, MIXTRAL_CHECKPOINT_DIR,
                                       device=device, quantization="int8")
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    out = {"layers": cfg.num_layers, "experts": cfg.num_experts,
           "bytes": nbytes, "write_s": write_s, "int8_load_s": load_s,
           "load_gb_per_s": nbytes / load_s / 1e9,
           "int8_weight_bytes": sum(t.nbytes for t in loaded.buffers()),
           **build_memory(cfg, mem0),
           "equal_quantized_draw": same_weights(loaded, want)}
    del drawn, want, loaded
    free_memory()
    shutil.rmtree(MIXTRAL_CHECKPOINT_DIR)
    out["seconds"] = time.monotonic() - t_phase
    log(json.dumps({"int8_checkpoint": out}))
    if not (out["equal_quantized_draw"]
            and out["transient_gb"] <= out["transient_bound_gb"]):
        raise AssertionError(f"the int8 checkpoint load: {out}")


# ------------------------------------------------------------ encoder

# the encoder phase: each preset served beside debug-tiny (the causal
# model the pooling routes do not use), random f32 weights from the
# engine's seed, batches of max_num_seqs rows up to the 512-position
# table; ENCODER_DIR holds each preset's HF-named directory while the
# phase runs
ENCODER_PRESETS = ("bert-base", "minilm-l6")
ENCODER_SERVE = dict(model="debug-tiny", max_model_len=512, max_num_seqs=4,
                     prefill_chunk=512, seed=0)
ENCODER_DIR = os.path.join(REPO, "build", "encoder")
# H100 SXM float32 peak outside the tensor cores (NVIDIA data sheet): the
# encoder's products are f32 with TF32 off, as PyTorch defaults
F32_FLOPS = 67e12
# card against CPU on the same weights: max |delta| over a pooled vector
# within this fraction of its norm (f32 products summed in another
# order, through 12 post-LN layers); a row alone against the same row
# batched beside a 512-token one
ENCODER_REL_TOL = 1e-4
ENCODER_PAD_TOL = 1e-5


def encoder_hf_tensors(params, cfg) -> dict:
    """The encoder's weights under HF BertModel names (``bert.``
    prefixed, Linear weights [out, in]) for save_safetensors."""
    e, out = "bert.embeddings.", {}
    for name, hf in (("word_emb", "word_embeddings.weight"),
                     ("pos_emb", "position_embeddings.weight"),
                     ("type_emb", "token_type_embeddings.weight"),
                     ("emb_ln_w", "LayerNorm.weight"),
                     ("emb_ln_b", "LayerNorm.bias")):
        out[e + hf] = getattr(params, name)
    per_layer = {"q": "attention.self.query", "k": "attention.self.key",
                 "v": "attention.self.value", "o": "attention.output.dense",
                 "up": "intermediate.dense", "down": "output.dense"}
    norms = {"attn_ln": "attention.output.LayerNorm",
             "out_ln": "output.LayerNorm"}
    for l in range(cfg.num_layers):
        pre = f"bert.encoder.layer.{l}."
        for name, hf in per_layer.items():
            out[pre + hf + ".weight"] = getattr(params, name)[l].T
            out[pre + hf + ".bias"] = getattr(params, name + "_b")[l]
        for name, hf in norms.items():
            out[pre + hf + ".weight"] = getattr(params, name + "_w")[l]
            out[pre + hf + ".bias"] = getattr(params, name + "_b")[l]
    return out


def write_encoder_tokenizer(path: str) -> int:
    """A BERT WordPiece tokenizer's files in `path` (vocab.txt, one
    token a line, and a tokenizer_config.json naming BertTokenizer): the
    special tokens, then letters, digits, punctuation and their ##
    continuations, then the words of the phase's texts. Returns its
    size. An engine given the directory refuses it without them
    (engine._build_encoder)."""
    chars = list("abcdefghijklmnopqrstuvwxyz0123456789.,!?")
    words = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + chars
             + ["##" + c for c in chars]
             + ["in", "the", "beginning", "engine", "read", "every",
                "block", "of", "pool", "once", "and", "was", "paged",
                "rivers", "run", "to", "sea", "is", "never", "full",
                "tea"])
    with open(os.path.join(path, "vocab.txt"), "w") as f:
        f.write("\n".join(words) + "\n")
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "BertTokenizer",
                   "do_lower_case": True, "model_max_length": 512}, f)
    return len(words)


def encoder_work(cfg, B: int, T: int, param_bytes: int):
    """(operations, bytes) of one encode of B rows of T tokens: the
    products (q, k, v, o, up, down) and the attention's two (scores and
    values over T keys), 2 operations a multiply-add; the weights read
    once, the tokens in and the pooled vectors out."""
    H, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    per_token = L * (2 * (4 * H * H + 2 * H * I) + 2 * 2 * T * H)
    return B * T * per_token, param_bytes + B * T * 8 + B * H * 4


async def _embeddings(engine, *inputs) -> list:
    """/v1/embeddings over each of `inputs` (texts or token-id lists)
    through the port's server in-process: the replies."""
    import aiohttp
    from aiohttp import web
    from production_stack_tpu_torch.engine.server import build_app
    port = free_port()
    runner = web.AppRunner(build_app(engine, api_key=""))
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    try:
        async with aiohttp.ClientSession() as http:
            return [await _post_json(
                http, f"http://127.0.0.1:{port}/v1/embeddings",
                {"model": ENCODER_SERVE["model"], "input": x})
                for x in inputs]
    finally:
        await runner.cleanup()


def encoder_phase(device="cuda"):
    """The BERT encoder of --embedding-model on the card, for bert-base
    and minilm-l6 at full width (random f32 weights drawn by the engine
    from its seed):
    - pooled vectors of rows of 512, 100 and 7 tokens in one batch on the
      card against the same weights on the CPU, within ENCODER_REL_TOL of
      each vector's norm; the 7-token row alone against itself batched
      beside the 512-token row, within ENCODER_PAD_TOL;
    - the device time of one batch of max_num_seqs x 512 tokens (CUDA
      graph replay; and eager calls back to back, the host's dispatch
      included where it outlasts the device) with its bound: the f32
      operations over F32_FLOPS, the bytes over HBM_BPS;
    - an HF-named directory written from those weights (the port's
      save_safetensors, a config.json and a small WordPiece tokenizer,
      write_encoder_tokenizer) and served by a second engine through
      --embedding-model <dir>: its weights equal the preset's, its
      tokenizer is the directory's (its ids of a text logged), and
      /v1/embeddings of the same token ids (the preset's tokenizer's
      ids of the texts) from both servers is bit for bit equal,
      embedding_source encoder:<preset> and encoder:<preset>-hf (the
      directory's name); the preset's server also takes the texts; no
      paged or flash kernel launched (the encoder attends with plain
      ops, as in the JAX package).
    The engines are freed and the directories deleted before returning."""
    import shutil

    import numpy as np
    import torch
    from production_stack_tpu_torch.engine.async_engine import \
        AsyncLLMEngine
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.models import encoder as enc
    from production_stack_tpu_torch.models.hf_loader import save_safetensors
    from production_stack_tpu_torch.ops import flash_attention as fa
    from production_stack_tpu_torch.ops import paged_attention as pa
    t_phase = time.monotonic()
    B = ENCODER_SERVE["max_num_seqs"]
    inputs = [long_prompt_text(512), "Rivers run to the sea, and the sea "
              "is never full.", "Tea."]
    out, ok = {}, True
    for preset in ENCODER_PRESETS:
        t0 = time.monotonic()
        engine = AsyncLLMEngine(EngineConfig(
            device=device, embedding_model=preset, **ENCODER_SERVE))
        eng = engine.engine
        params, cfg = eng._enc_params, eng._enc_cfg
        ready_s = time.monotonic() - t0
        cpu = enc.Encoder(cfg, device="cpu")
        cpu.load_state_dict(params.state_dict())
        g = torch.Generator().manual_seed(1)
        lens = torch.tensor([512, 100, 7])
        toks = torch.randint(0, cfg.vocab_size, (3, 512), generator=g)
        t0 = time.monotonic()
        want = enc.encode(cpu, cfg, toks, lens)
        cpu_s = time.monotonic() - t0
        del cpu
        got = enc.encode(params, cfg, toks.to(device), lens.to(device)).cpu()
        rel = float(((got - want).abs().amax(dim=1)
                     / want.norm(dim=1)).max())
        alone = enc.encode(params, cfg, toks[2:, :7].to(device),
                           lens[2:].to(device)).cpu()
        pad = float((alone[0] - got[2]).abs().max())
        tb = torch.randint(0, cfg.vocab_size, (B, 512), generator=g).to(
            device)
        lb = torch.full((B,), 512, device=device)
        ms = device_ms(lambda i=0: enc.encode(params, cfg, tb, lb), iters=5)
        eager_ms = time_ms(lambda i=0: enc.encode(params, cfg, tb, lb),
                           iters=10)
        param_bytes = sum(p.nbytes for p in params.parameters())
        flops, nbytes = encoder_work(cfg, B, 512, param_bytes)
        t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
        # the directory, served by a second engine
        path = os.path.join(ENCODER_DIR, f"{preset}-hf")
        shutil.rmtree(path, ignore_errors=True)
        os.makedirs(path)
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({"model_type": "bert", "vocab_size": cfg.vocab_size,
                       "hidden_size": cfg.hidden_size,
                       "intermediate_size": cfg.intermediate_size,
                       "num_hidden_layers": cfg.num_layers,
                       "num_attention_heads": cfg.num_heads,
                       "max_position_embeddings":
                           cfg.max_position_embeddings,
                       "type_vocab_size": cfg.type_vocab_size,
                       "layer_norm_eps": cfg.layer_norm_eps}, f)
        save_safetensors(encoder_hf_tensors(params, cfg),
                         os.path.join(path, "model.safetensors"))
        write_encoder_tokenizer(path)
        from_dir = AsyncLLMEngine(EngineConfig(
            device=device, embedding_model=path, **ENCODER_SERVE))
        weights_equal = all(
            torch.equal(t, getattr(from_dir.engine._enc_params, n))
            for n, t in params.named_parameters())
        dir_tok = from_dir.engine.embedding_tokenizer
        token_lists = [eng.embedding_tokenizer.encode(x) for x in inputs]
        pa.reset_launch_counts()
        fa.reset_launch_counts()
        t0 = time.monotonic()
        served, texts = asyncio.run(_embeddings(engine, token_lists,
                                                inputs))
        served_dir, = asyncio.run(_embeddings(from_dir, token_lists))
        serve_s = time.monotonic() - t0
        launches = {**pa.launch_counts, **fa.launch_counts}
        vecs = np.array([d["embedding"] for d in served["data"]])
        vecs_dir = np.array([d["embedding"] for d in served_dir["data"]])
        vecs_text = np.array([d["embedding"] for d in texts["data"]])
        rec = {"layers": cfg.num_layers, "hidden": cfg.hidden_size,
               "heads": cfg.num_heads, "engine_ready_s": ready_s,
               "card_vs_cpu_rel": rel, "cpu_encode_s": cpu_s,
               "padding_max_abs": pad,
               "batch": [B, 512], "ms": ms, "eager_ms": eager_ms,
               "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "flops": flops, "bytes": nbytes,
               "tflops_per_s": flops / ms / 1e9,
               "served": {"source": served["embedding_source"],
                          "dir_source": served_dir["embedding_source"],
                          "vectors": vecs.shape, "bit_equal":
                              bool(np.array_equal(vecs, vecs_dir)),
                          "weights_equal": weights_equal,
                          "texts_equal_ids": bool(np.array_equal(
                              vecs_text, vecs)),
                          "dir_tokenizer": [type(dir_tok).__name__,
                                            dir_tok.vocab_size,
                                            dir_tok.encode(inputs[2])],
                          "finite": bool(np.isfinite(vecs).all()),
                          "input_tokens": served["usage"]["prompt_tokens"],
                          "seconds": serve_s, "launches": launches}}
        out[preset] = rec
        ok = ok and (rel <= ENCODER_REL_TOL and pad <= ENCODER_PAD_TOL
                     and rec["served"]["bit_equal"] and weights_equal
                     and rec["served"]["texts_equal_ids"]
                     and rec["served"]["finite"]
                     and vecs.shape == (3, cfg.hidden_size)
                     and served["embedding_source"] == f"encoder:{preset}"
                     and served_dir["embedding_source"]
                     == f"encoder:{preset}-hf"
                     and not any(launches.values()))
        for e in (engine, from_dir):
            release(e)
        del params, tb, engine, from_dir, eng, dir_tok
        free_memory()
        shutil.rmtree(path)
    out["seconds"] = time.monotonic() - t_phase
    out["ok"] = ok
    log(json.dumps({"encoder": out}))
    if not ok:
        raise AssertionError(f"the encoder phase failed: {out}")
    return out


# ------------------------------------------------------------ main

# ------------------------------------------------------------ kvtier

# the KV-tier phase: Llama-3-8B at full width and depth, one weight set
# shared by every engine of the phase. The prompts: long_tokens = 3,000
# (11 chunks of 256: 2,816 cached tokens, 352 MiB of bf16 chunks on the
# wire, a 184-token suffix through the prefill kernel) and whole_tokens
# = 2,048 (8 whole chunks, hits capped at 2,047: a 1-token suffix,
# padded to the 16-token prefill bucket, then decode at T = 1 over the
# injected blocks); migrate_tokens = 1,100 for the kvplane migration
KVTIER = dict(
    model="llama-3-8b",
    serve=dict(max_num_seqs=4, max_model_len=4096, prefill_chunk=512,
               decode_window=8, kv_block_size=64, seed=0),
    chunk_size=256, long_tokens=3000, whole_tokens=2048,
    migrate_tokens=1100, gen_tokens=24, local_cpu_gb=2.0,
    server_capacity_gb=4.0, store_chunks=4)


def kvtier_prompt(n: int, seed: int, vocab: int) -> list:
    import random
    rnd = random.Random(seed)
    return [rnd.randrange(vocab) for _ in range(n)]


def _start_cache_server(capacity_gb: float):
    """The port's cache server as a subprocess (the native pskv-server
    where native/ builds, else the asyncio server); (process, url)."""
    from production_stack_tpu_torch.kvcache.store import RemoteStore
    port = free_port()
    # its log goes to a file: a pipe nobody drains could stall it
    log_path = os.path.join(REPO, "build", "kvtier_cache_server.log")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    with open(log_path, "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "production_stack_tpu_torch.kvcache.server", "--host",
             "127.0.0.1", "--port", str(port), "--capacity-gb",
             str(capacity_gb)], cwd=REPO, stdout=subprocess.DEVNULL,
            stderr=err)
    url = f"tpukv://127.0.0.1:{port}"
    t0 = time.monotonic()
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), 0.5).close()
            break
        except OSError:
            if proc.poll() is not None or time.monotonic() - t0 > 150:
                proc.kill()
                proc.wait(timeout=10)
                with open(log_path, "rb") as f:
                    tail = f.read()[-2000:].decode(errors="replace")
                raise AssertionError(f"the cache server did not start: "
                                     f"{tail}")
            time.sleep(0.1)
    probe = RemoteStore(url)
    if not probe.ping():
        proc.kill()
        proc.wait(timeout=10)
        raise AssertionError("the cache server does not answer a ping")
    probe.close()
    return proc, url


def plain_tail_logits(runner, params, mcfg, ids, n, pool_dtype, **lora):
    """f32 logits [n, V] of the distributions of the last n tokens of
    `ids` (positions len-1-n .. len-2), teacher-forced through the plain
    attention over a pool of its own (pool_dtype: the model's, or
    torch.int8), prefill_chunk at a time; lora: llama.hidden's
    lora_rows and lora_scaling. near_tie_check's inputs."""
    import torch
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.kv import make_slot_cache
    from production_stack_tpu_torch.ops import paged_attention as pa
    dev = runner.device
    chunk, Bs = runner.engine_cfg.prefill_chunk, 64
    T = len(ids)
    span = -(-T // Bs) * Bs
    cache, tables = make_slot_cache(
        mcfg.num_layers, 1, span, mcfg.num_kv_heads, mcfg.head_dim_,
        dtype=pool_dtype, block_size=Bs, device=dev)

    def plain(q, k, v, tables, starts, *, nb, scale=None, window=0,
              softcap=0.0, k_scales=None, v_scales=None):
        return pa.paged_attention_plain(q, k, v, tables, starts, nb, scale,
                                        window, softcap, k_scales, v_scales)
    saved = (pa.paged_attention, pa.paged_decode_attention)
    pa.paged_attention = pa.paged_decode_attention = plain
    rows = []
    try:
        t = torch.tensor([ids], device=dev)
        with torch.no_grad():
            for lo in range(0, T - 1, chunk):
                hi = min(lo + chunk, T - 1)
                x = llama.hidden(params, mcfg, t[:, lo:hi],
                                 torch.arange(lo, hi, device=dev)[None],
                                 cache, block_tables=tables,
                                 rope=runner.rope, kv_len=span, **lora)
                first = max(lo, T - 1 - n)
                if first < hi:
                    rows.append(llama.final_logits(
                        params, mcfg, x[:, first - lo:])[0])
    finally:
        pa.paged_attention, pa.paged_decode_attention = saved
    del cache
    return torch.cat(rows).float()


def _tokens_check(served, recompute_eng, prompt, want_tokens):
    """served tokens against the recompute engine's (the same weights and
    pool dtype, no tiers): equal, or parting at a near-tie within the
    bf16 bound (near_tie_check over f32 and served-dtype teacher-forced
    logits of the recompute sequence, computed only where they part)."""
    import dataclasses

    import torch
    if served == want_tokens:
        return {"tokens": len(served), "differ_at": None, "ok": True}
    eng = recompute_eng
    runner, mcfg = eng.runner, eng.model_cfg
    pool = torch.int8 if runner.cache.quantized else mcfg.dtype
    ids = prompt + want_tokens
    l32 = plain_tail_logits(
        runner, Upcast(runner.params),
        dataclasses.replace(mcfg, dtype=torch.float32), ids,
        len(want_tokens), torch.int8 if pool == torch.int8
        else torch.float32)
    l16 = plain_tail_logits(runner, runner.params, mcfg, ids,
                             len(want_tokens), pool)
    return near_tie_check(want_tokens, served, l32, l16)


def _serve_direct(eng, prompt, max_tokens):
    """One greedy request through the engine loop, driven here: (tokens,
    TTFT seconds from add_request, which pays the tier prefetch, to the
    first token; the sequence; its terminal output's timing)."""
    from production_stack_tpu_torch.engine.scheduler import SamplingOptions
    t0 = time.monotonic()
    sid = eng.add_request(list(prompt), SamplingOptions(
        temperature=0.0, max_tokens=max_tokens, ignore_eos=True))
    ttft = timing = None
    while eng.has_work:
        outs = eng.step()
        if ttft is None and any(o.seq_id == sid and o.new_token is not None
                                for o in outs):
            ttft = time.monotonic() - t0
        timing = next((o.timing for o in outs
                       if o.seq_id == sid and o.finished), timing)
    seq = eng.seqs[sid]
    return list(seq.output_tokens), ttft, seq, timing


def _counted(fn):
    """(fn's result, the paged kernels' launches and prefill launches at
    T = 16 while it ran): the counts are zeroed just before."""
    from production_stack_tpu_torch.ops import paged_attention as pa
    pa.reset_launch_counts()
    out = fn()
    return out, {"launches": dict(pa.launch_counts),
                 "int8_launches": dict(pa.int8_launches),
                 "prefill_T16": pa.verify_launches["paged_attention"].get(
                     16, 0)}


def kvtier_measure(device, consumer, consumer8, url) -> dict:
    """The tier path's pieces on one Llama chunk (256 tokens, 32 MiB of
    bf16 K and V): extract_chunk and inject_chunk over the bf16 and the
    int8 pool (four slots on distinct blocks in turn, 128 MiB, so the L2
    holds no chunk of the previous call), the pinned D2H and H2D copies,
    each tier's put and get rates (host, disk, remote; host clock), and
    each codec's encode and decode time and ratio; which backend the
    host tier runs on."""
    import hashlib
    import shutil

    import numpy as np
    import torch
    from production_stack_tpu_torch.kvcache import codec as kvcodec
    from production_stack_tpu_torch.kvcache.connector import tensor_bytes
    from production_stack_tpu_torch.kvcache.store import (DiskStore,
                                                          HostMemoryStore,
                                                          RemoteStore)
    C = KVTIER["chunk_size"]
    out = {}
    for name, eng in (("bf16", consumer), ("int8", consumer8)):
        runner = eng.runner
        B, MB = eng._tables.shape
        nblk = C // eng.cfg.kv_block_size
        tables = np.zeros((B, MB), np.int32)
        for s in range(B):
            tables[s, :nblk] = 1 + s * nblk + np.arange(nblk)
        runner.set_block_tables(tables)
        k, v = runner.extract_chunk(0, 0, C)
        out[f"extract_ms_{name}"] = time_ms(
            lambda i=0: runner.extract_chunk(i % B, 0, C), 16)
        out[f"inject_ms_{name}"] = time_ms(
            lambda i=0: runner.inject_chunk(i % B, 0, k, v), 16)
        runner.set_block_tables(eng._tables)
        wire = k.nbytes + v.nbytes
        # the pool side: bf16 K and V, or int8 K and V with an f32 scale
        # per (layer, token, head)
        pool = wire if name == "bf16" else wire // 2 + 2 * (
            k.numel() // k.shape[-1]) * 4
        # either way the chunk's pool bytes cross HBM one way and its
        # wire bytes the other: the least time at the card's HBM rate
        out[f"bound_ms_{name}"] = 1e3 * (wire + pool) / HBM_BPS
        if name == "bf16":
            chunk_k, chunk_v = k, v
    out["chunk_bytes"] = wire
    if chunk_k.is_cuda:
        host = torch.empty(chunk_k.shape, dtype=chunk_k.dtype,
                           pin_memory=True)
        dev = torch.empty_like(chunk_k)
        d2h = time_ms(lambda i=0: host.copy_(chunk_k, non_blocking=True),
                      16)
        h2d = time_ms(lambda i=0: dev.copy_(host, non_blocking=True), 16)
        out["d2h_gbps"] = chunk_k.nbytes / d2h / 1e6
        out["h2d_gbps"] = chunk_k.nbytes / h2d / 1e6
    body = tensor_bytes(chunk_k.cpu()) + tensor_bytes(chunk_v.cpu())
    value = body + hashlib.blake2b(body, digest_size=8).digest()
    disk_dir = os.path.join(REPO, "build", "kvtier_disk")
    shutil.rmtree(disk_dir, ignore_errors=True)
    tiers = {"cpu": HostMemoryStore(1 << 32),
             "disk": DiskStore(disk_dir, 1 << 34),
             "remote": RemoteStore(url, io_timeout=30.0)}
    out["host_store_backend"] = tiers["cpu"].backend
    m = KVTIER["store_chunks"]
    for name, st in tiers.items():
        keys = [b"kvtier-%s-%d" % (name.encode(), i) for i in range(m)]
        t0 = time.perf_counter()
        for key in keys:
            assert st.put(key, value), name
        put_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for key in keys:
            assert st.get(key) == value, name
        get_s = time.perf_counter() - t0
        out[f"{name}_put_gbps"] = m * len(value) / put_s / 1e9
        out[f"{name}_get_gbps"] = m * len(value) / get_s / 1e9
        for key in keys:
            st.delete(key)
        st.close()
    shutil.rmtree(disk_dir, ignore_errors=True)
    codecs = {}
    for name in kvcodec.codec_names():
        c = kvcodec.make_codec(name, dtype="bfloat16",
                               head_dim=chunk_k.shape[-1])
        t0 = time.perf_counter()
        payload = kvcodec.encode_payload(c, body)
        enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = kvcodec.decode_payload(c, payload, len(body))
        dec = time.perf_counter() - t0
        assert back is not None and len(back) == len(body), name
        codecs[name] = {"encode_ms": 1e3 * enc, "decode_ms": 1e3 * dec,
                        "ratio": len(body) / len(payload)}
    out["codecs"] = codecs
    return out


def kvtier_phase(device="cuda", cfg=None):
    """KV tiering and disaggregated prefill on the card (KVTIER): the
    port's cache server as a subprocess; a producer (kv_both: a host
    tier and the remote tier; a kv_producer's migrated victim could not
    re-admit from the tiers, since prefetch is a consumer's), a consumer
    (the remote tier), a second consumer over an int8 pool, and two
    recompute engines without tiers (bf16 and int8 pools), all on one
    Llama-3-8B weight set.

    - kvplane first, on the producer driven here: migrate_out of a
      decoding sequence publishes and preempts it; the consumer warms
      its keys; the victim re-admits by injection and finishes.
    - The producer serves the 3,000-token and the 2,048-token prompts
      through the port's HTTP server with max_tokens = 1, as the
      router's prefill stage sends them: chunks reach the tiers while
      later chunks still prefill (progress_published_chunks > 0).
    - The consumer serves each with 24 greedy tokens: hits of 2,816 and
      2,047 tokens; the injected blocks, re-extracted, equal the
      producer's chunk bytes (its host tier's copy) bit for bit; the
      suffix launches the prefill kernel (the 1-token suffix at T = 16,
      its bucket) and decode the decode kernel over the injected
      blocks; the tokens equal the recompute engine's or part at a
      near-tie (near_tie_check). TTFT with the hit and without it (the
      recompute engine), and the prefetch wait.
    - The int8 consumer takes the bf16 producer's chunks (the namespace
      is the wire dtype's) into its int8 pool: hit 2,816, tokens against
      the int8 recompute engine by the same rule.
    - kvtier_measure's rates.

    The engines and the server process are released before returning;
    any failed check raises."""
    import hashlib

    from aiohttp import web
    from production_stack_tpu_torch.engine.async_engine import \
        AsyncLLMEngine
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.scheduler import SamplingOptions
    from production_stack_tpu_torch.engine.server import build_app
    from production_stack_tpu_torch.kvcache._native import server_binary
    from production_stack_tpu_torch.kvcache.connector import tensor_bytes
    cfg = cfg or KVTIER
    t_phase = time.monotonic()
    C, G = cfg["chunk_size"], cfg["gen_tokens"]
    proc, url = _start_cache_server(cfg["server_capacity_gb"])
    engines = []
    try:
        def engine(kv=None, params=None, **kw):
            e = AsyncLLMEngine(EngineConfig(
                model=cfg["model"], device=device,
                **dict(cfg["serve"], **kw), kv_transfer_config=kv),
                params=params)
            e.engine.runner.warmup()
            engines.append(e)
            return e
        tier = {"chunk_size": C, "remote_url": url,
                "remote_io_timeout_s": 30.0, "prefetch_timeout_s": 30.0}
        t0 = time.monotonic()
        prod = engine(dict(tier, kv_role="kv_both",
                           local_cpu_gb=cfg["local_cpu_gb"]))
        params = prod.engine.runner.params
        cons = engine(dict(tier, kv_role="kv_consumer"), params)
        cons8 = engine(dict(tier, kv_role="kv_consumer"), params,
                       kv_dtype="int8")
        rec = engine(None, params)
        rec8 = engine(None, params, kv_dtype="int8")
        ready_s = time.monotonic() - t0
        V = prod.engine.model_cfg.vocab_size
        long_p = kvtier_prompt(cfg["long_tokens"], 31, V)
        whole_p = kvtier_prompt(cfg["whole_tokens"], 32, V)
        peng, pconn = prod.engine, prod.engine.connector
        cconn = cons.engine.connector

        # kvplane: migrate a decoding sequence off the producer, warm
        # its keys on the consumer; the victim re-admits by injection
        sid = peng.add_request(
            kvtier_prompt(cfg["migrate_tokens"], 33, V),
            SamplingOptions(temperature=0.0, max_tokens=G,
                            ignore_eos=True))
        while not peng.seqs[sid].output_tokens:
            peng.step()
        h0 = pconn.hit_tokens
        moved = peng.migrate_out(max_seqs=1)
        warm = cons.engine.warm_chunks(moved.get("keys", []))
        while peng.has_work:
            peng.step()
        victim = peng.seqs[sid]
        migrate = dict(migrated=moved.get("migrated") == [sid],
                       freed_blocks=moved.get("freed_blocks"),
                       keys=len(moved.get("keys", [])), warm=warm,
                       readmit_hit=pconn.hit_tokens - h0,
                       tokens=len(victim.output_tokens),
                       finish=victim.finish_reason)

        async def produce():
            import aiohttp
            runner = web.AppRunner(build_app(prod, api_key=""))
            await runner.setup()
            port = free_port()
            await web.TCPSite(runner, "127.0.0.1", port).start()
            walls = []
            try:
                async with aiohttp.ClientSession() as http:
                    for p in (long_p, whole_p):
                        t = time.monotonic()
                        async with http.post(
                                f"http://127.0.0.1:{port}/v1/completions",
                                json={"model": cfg["model"], "prompt": p,
                                      "max_tokens": 1,
                                      "temperature": 0.0}) as r:
                            body = await r.json()
                            assert r.status == 200, body
                            assert body["usage"]["completion_tokens"] == 1
                        walls.append(time.monotonic() - t)
            finally:
                # stops the engine loop and closes the connector, which
                # flushes the queued saves first
                await runner.cleanup()
            return walls
        p0 = pconn.stats_report()
        produce_walls = asyncio.run(produce())
        produced = {k: pconn.stats_report()[k] - p0[k] for k in (
            "published_chunks", "progress_published_chunks",
            "bytes_saved")}
        host_tier = pconn.store.tiers[0]

        # the consumer: its injected blocks, re-extracted right after
        # the injection, against the producer's host-tier copies
        checked = {}
        inject = cconn.inject

        def inject_and_check(pf, slot):
            inject(pf, slot)
            same = True
            for i, key in enumerate(pf.keys):
                k, v = cons.engine.runner.extract_chunk(slot, i * C, C)
                val = host_tier.get(key)
                same = same and val is not None and val[:-8] == (
                    tensor_bytes(k.cpu()) + tensor_bytes(v.cpu()))
            checked.update(chunks=len(pf.keys), bit_equal=same)
        cconn.inject = inject_and_check
        results = {}
        try:
            for name, p, hit in (("long", long_p, len(long_p) // C * C),
                                 ("whole", whole_p, len(whole_p) - 1)):
                h0 = cconn.hit_tokens
                (toks, ttft, seq, timing), counts = _counted(
                    lambda: _serve_direct(cons.engine, p, G))
                # this serve's TTFT holds the check's copies; the
                # terminal timing (the trace's kv_prefetch event) carries
                # the prefetch the sequence measured
                results[name] = dict(
                    hit=cconn.hit_tokens - h0, want_hit=hit,
                    want_chunks=len(p) // C, checked_ttft_s=ttft,
                    prefetch_wait_s=seq.kv_prefetch_wait_s,
                    cached_tokens=seq.kv_cached_tokens,
                    kv_prefetch_timing=dict(
                        wait_s=timing["kv_prefetch_wait_s"],
                        cached_tokens=timing["kv_cached_tokens"],
                        equal=(timing["kv_prefetch_wait_s"]
                               == seq.kv_prefetch_wait_s > 0)),
                    injected=dict(checked), tokens=toks, **counts)
                checked.clear()
        finally:
            cconn.inject = inject
        # the long prompt again, unchecked: the hit path's TTFT
        _, ttft_hit, seq, _ = _serve_direct(cons.engine, long_p, G)
        results["long"].update(ttft_s=ttft_hit,
                               prefetch_wait_s=seq.kv_prefetch_wait_s)
        # where the prefetch wait goes: the 11 chunks read one after
        # another from the remote tier, and one chunk's digest
        from production_stack_tpu_torch.kvcache.store import RemoteStore
        keys = cconn.hasher.chunk_keys(long_p)
        client = RemoteStore(url, io_timeout=30.0)
        t = time.perf_counter()
        vals = [client.get(k) for k in keys]
        results["long"]["serial_remote_read_s"] = time.perf_counter() - t
        client.close()
        t = time.perf_counter()
        hashlib.blake2b(vals[0][:-8], digest_size=8).digest()
        results["long"]["chunk_digest_s"] = time.perf_counter() - t
        del vals
        (want_long, ttft_rec, _, _), _ = _counted(
            lambda: _serve_direct(rec.engine, long_p, G))
        want_whole, _, _, _ = _serve_direct(rec.engine, whole_p, G)
        results["long"]["recompute_ttft_s"] = ttft_rec
        results["long"]["vs_recompute"] = _tokens_check(
            results["long"]["tokens"], rec.engine, long_p, want_long)
        results["whole"]["vs_recompute"] = _tokens_check(
            results["whole"]["tokens"], rec.engine, whole_p, want_whole)

        # the mixed-pool handoff: bf16 chunks into an int8 pool
        h0 = cons8.engine.connector.hit_tokens
        (toks8, ttft8, seq8, _), counts8 = _counted(
            lambda: _serve_direct(cons8.engine, long_p, G))
        want8, ttft8_rec, _, _ = _serve_direct(rec8.engine, long_p, G)
        int8 = dict(hit=cons8.engine.connector.hit_tokens - h0,
                    want_hit=len(long_p) // C * C, ttft_s=ttft8,
                    recompute_ttft_s=ttft8_rec,
                    prefetch_wait_s=seq8.kv_prefetch_wait_s,
                    vs_recompute=_tokens_check(toks8, rec8.engine, long_p,
                                               want8),
                    tokens=toks8, **counts8)
        measured = kvtier_measure(device, cons.engine, cons8.engine, url)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
        for e in engines:
            e.engine.close()
            release(e)
        engines.clear()
    ok = {}
    for name in ("long", "whole"):
        r = results[name]
        ok[name] = (r["hit"] == r["want_hit"] == r["cached_tokens"]
                    == r["kv_prefetch_timing"]["cached_tokens"]
                    and r["kv_prefetch_timing"]["equal"]
                    and r["injected"].get("bit_equal") is True
                    and r["injected"]["chunks"] == r["want_chunks"]
                    and r["vs_recompute"]["ok"]
                    and len(r["tokens"]) == G
                    and r["launches"]["paged_decode_attention"] > 0
                    and r["launches"]["paged_attention"] > 0)
    # the 1-token suffix: every prefill launch at its 16-token bucket
    ok["whole"] = ok["whole"] and (results["whole"]["prefill_T16"]
                                   == results["whole"]["launches"][
                                       "paged_attention"])
    ok["int8"] = (int8["hit"] == int8["want_hit"]
                  and int8["vs_recompute"]["ok"] and len(toks8) == G
                  and int8["int8_launches"]["paged_attention"] > 0
                  and int8["int8_launches"]["paged_decode_attention"] > 0)
    ok["publish"] = (produced["published_chunks"]
                     >= len(long_p) // C + len(whole_p) // C
                     and produced["progress_published_chunks"] > 0)
    ok["migrate"] = (migrate["migrated"] and migrate["keys"] > 0
                     and migrate["warm"] == {"warmed": migrate["keys"],
                                             "missed": 0}
                     and migrate["readmit_hit"] >= C
                     and migrate["tokens"] == G)
    for r in (results["long"], results["whole"], int8):
        r.pop("tokens")
    out = {"kvtier": {
        "model": cfg["model"], "device": str(device),
        "engines_ready_s": ready_s, "produce_wall_s": produce_walls,
        "published": produced, "long": results["long"],
        "whole": results["whole"], "int8_consumer": int8,
        "migrate": migrate,
        "server_backend": "native" if server_binary() else "python",
        **measured, "checks": ok, "ok": all(ok.values()),
        "seconds": time.monotonic() - t_phase}}
    log(json.dumps(out))
    if not out["kvtier"]["ok"]:
        raise AssertionError(f"the kvtier phase failed: {ok}")
    return out["kvtier"]


# ------------------------------------------------------------ parallel

# the parallel phase: Llama-3-8B at tp = 2 (16 layers), Qwen1.5-MoE-A2.7B
# at ep = 2 and ep = 2 x tp = 2 and Mixtral-8x7B int8 at ep = 2, at full
# width, every rank on the one card, so gloo stages each collective
# through the host. It holds the per-rank shapes, shards and kernels on the card against the
# single-rank engine on the same weights (random, from the seed); its
# step times measure this rig, not a multi-GPU speed. meshes: the
# worlds served after the single-rank engine; serve: both engines'
# geometry; greedy: the plain greedy prompts' lengths (token ids from a
# seed); int8: the length of the one greedy request over the int8 pool
# (None: no int8 run); features: a shaped, a guided and a repetitive
# (speculating) request besides; dp_mesh: a mesh with dp > 1 (its dp and
# tensor_parallel_size) whose engine (dp_run) is held bit for bit to the
# engine of its tp alone, the first of meshes (None: no dp run);
# layers: the depth every engine of the entry serves at (parallel_served;
# absent: the preset's)
PARALLEL = {
    "llama-3-8b": dict(
        meshes=(dict(tensor_parallel_size=2),),
        serve=dict(max_num_seqs=4, max_model_len=2048, prefill_chunk=512,
                   decode_window=8, kv_block_size=64, seed=0,
                   speculative_ngram_tokens=3),
        greedy=(300, 1000), tokens=24, int8=300, features=True,
        dp_mesh=dict(dp=2, tensor_parallel_size=2),
        # served at 16 layers: Llama-3-8B's widths in a config.json
        hf_config=dict(CHECKPOINT_CONFIG, num_hidden_layers=16)),
    "qwen1.5-moe-a2.7b": dict(
        meshes=(dict(expert_parallel_size=2),
                dict(expert_parallel_size=2, tensor_parallel_size=2)),
        serve=dict(max_num_seqs=2, max_model_len=2048, prefill_chunk=512,
                   decode_window=8, kv_block_size=64, seed=0),
        greedy=(1100,), tokens=24, int8=None, features=False,
        dp_mesh=None),
    # int8 weights: each rank builds its slice a layer at a time (the
    # attention, embedding and head whole, 4 of each layer's 8 experts)
    "mixtral-8x7b": dict(
        meshes=(dict(expert_parallel_size=2),),
        serve=dict(max_num_seqs=2, max_model_len=2048, prefill_chunk=512,
                   decode_window=8, kv_block_size=64, seed=0,
                   quantization="int8"),
        greedy=(600,), tokens=16, int8=None, features=False,
        dp_mesh=None),
}
# the decode window parallel_step_timing times: rows at these positions
PARALLEL_STARTS = [200, 431, 57, 400]


def parallel_label(model: str, mesh: dict, kv: str = "bfloat16") -> str:
    """The counts key of one parallel serving run (a kernel row's path)."""
    tp = mesh.get("tensor_parallel_size", 1)
    ep = mesh.get("expert_parallel_size", 1)
    dp = f"dp{mesh['dp']}" if mesh.get("dp", 1) > 1 else ""
    return f"parallel:{model}:{dp}tp{tp}ep{ep}" + (":int8kv" if kv == "int8"
                                                   else "")


def parallel_served(model: str, p: dict) -> dict:
    """EngineConfig's model for one PARALLEL entry: the preset, or where
    the entry gives an "hf_config" (the preset's widths at a cut depth)
    a directory under build/parallel holding it as config.json, served
    with the byte tokenizer the preset has (named outright, so no
    tokenizer library is tried on the directory)."""
    if "hf_config" not in p:
        return {"model": model}
    layers = p["hf_config"]["num_hidden_layers"]
    where = os.path.join(REPO, "build", "parallel", f"{model}-{layers}layers")
    os.makedirs(where, exist_ok=True)
    with open(os.path.join(where, "config.json"), "w") as f:
        json.dump(p["hf_config"], f)
    return {"model": where, "tokenizer": "byte"}


def parallel_requests(cfg, p: dict) -> list:
    """(name, body) of the phase's completions: greedy prompts of token
    ids from a seed, and with features a shaped, a guided and a
    repetitive (n-gram speculating) one."""
    import random
    rnd = random.Random(11)

    def ids(n):
        return [rnd.randrange(3, cfg.vocab_size) for _ in range(n)]
    base = {"model": cfg.name, "max_tokens": p["tokens"], "temperature": 0.0,
            "ignore_eos": True}
    reqs = [(f"greedy{n}", dict(base, prompt=ids(n))) for n in p["greedy"]]
    if p["features"]:
        reqs += [
            ("shaped", dict(base, prompt=ids(40), **SHAPED)),
            ("guided", dict(base, prompt=ids(40), max_tokens=12,
                            guided_regex=SPEC_GUIDED)),
            ("spec", dict(base, prompt=[9, 17, 33, 65] * 60)),
        ]
    return reqs


async def parallel_serve(engine, reqs, inside) -> dict:
    """The requests through the OpenAI server in-process on `engine`,
    concurrently: {name: (prompt, output ids)}, /load's body, the MoE
    calls of the serving (moe_capture) and what inside(engine) returns,
    called (off the event loop) once they are served and before the
    application's cleanup closes the engine (a closed parallel engine
    has stopped its workers)."""
    import aiohttp
    from aiohttp import web
    from production_stack_tpu_torch.engine.server import build_app
    port = free_port()
    app = web.AppRunner(build_app(engine, api_key=""))
    await app.setup()
    await web.TCPSite(app, "127.0.0.1", port).start()
    base = f"http://127.0.0.1:{port}"
    try:
        async with aiohttp.ClientSession() as http:
            async def post(body):
                async with http.post(base + "/v1/completions",
                                     json=body) as r:
                    if r.status != 200:
                        raise AssertionError(
                            f"/v1/completions -> {r.status}: "
                            f"{await r.text()}")
                    return await r.json()
            with moe_capture() as moe_seen:
                await asyncio.gather(*(post(b) for _, b in reqs))
            async with http.get(base + "/load") as r:
                load = await r.json()
            tokens = {name: (body["prompt"], served_ids(
                engine, body["prompt"], 0)) for name, body in reqs}
            after = await asyncio.get_running_loop().run_in_executor(
                None, inside, engine.engine)
    finally:
        await app.cleanup()
    return {"tokens": tokens, "load": load, "inside": after,
            "moe": moe_seen}


def parallel_step_timing(eng, steps: int = 8) -> dict:
    """One greedy decode window of `steps` steps over max_num_seqs rows
    at PARALLEL_STARTS through the runner (every rank): its wall time
    per step (a host sync at its end) and the collectives each step
    issued. Run on an idle engine: the window writes into the pool."""
    import numpy as np
    import torch
    from production_stack_tpu_torch.engine.sampler import SamplingParams
    runner, cfg = eng.runner, eng.cfg
    B, MB = cfg.max_num_seqs, cfg.max_blocks_per_seq
    runner.set_block_tables(
        (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB))
    starts = np.array(PARALLEL_STARTS[:B], np.int32)
    sampling = SamplingParams.filled(B, temperature=0.0,
                                     device=runner.device)
    kv_len = cfg.kv_bucket_for(int(starts.max()) + steps + 1)

    def window(n):
        runner.set_decode_state(np.zeros((B,), np.int32), starts)
        return runner.decode(sampling, steps=n, kv_len=kv_len,
                             greedy=True)[0].cpu()
    window(1)
    mesh = getattr(runner, "mesh", None)
    before = dict(mesh.calls) if mesh is not None else {}
    torch.cuda.synchronize(runner.device)
    t0 = time.monotonic()
    window(steps)
    wall = time.monotonic() - t0
    after = dict(mesh.calls) if mesh is not None else {}
    runner.set_block_tables(eng._tables)
    return {"step_wall_ms": wall / steps * 1e3, "kv_len": kv_len,
            "collectives_per_step": {k: (after[k] - before.get(k, 0))
                                     / steps for k in after}}


def batch_tokens(eng, reqs) -> dict:
    """{name: output ids} of the requests added to the engine at once,
    under its lock, so that its first step admits them together and the
    schedule depends on the engine's state alone: two parallel engines
    serve the same batches and are compared bit for bit. An
    AsyncLLMEngine's loop thread steps them."""
    from production_stack_tpu_torch.engine.scheduler import (SamplingOptions,
                                                             SeqStatus)
    with eng._lock:
        sids = {name: eng.add_request(list(body["prompt"]), SamplingOptions(
            **{k: v for k, v in body.items() if k not in ("model",
                                                          "prompt")}))
                for name, body in reqs}
    deadline = time.monotonic() + 600
    while any(eng.seqs[s].status != SeqStatus.FINISHED
              for s in sids.values()):
        if time.monotonic() > deadline:
            raise AssertionError("a batch of the dp comparison did not "
                                 "finish in 600 s")
        time.sleep(0.05)
    return {name: list(eng.seqs[s].output_tokens)
            for name, s in sids.items()}


def first_step_logprobs(eng, prompt) -> "torch.Tensor":
    """The log-softmax of the first step's logits (f32 [V], on the host)
    after the first prefill_chunk tokens of `prompt`, prefilled in one
    chunk through the runner (every rank) as the only live row, its top
    V alternatives put back in vocabulary order. Run on an idle engine:
    the chunk writes into the pool."""
    import numpy as np
    import torch
    from production_stack_tpu_torch.engine.sampler import SamplingParams
    runner, cfg = eng.runner, eng.cfg
    B, S, MB = cfg.max_num_seqs, cfg.max_model_len, cfg.max_blocks_per_seq
    V = eng.model_cfg.vocab_size
    ids = prompt[:cfg.prefill_chunk]
    Tb = cfg.bucket_for(len(ids))
    tokens = np.zeros((B, Tb), np.int32)
    tokens[0, :len(ids)] = ids
    starts = np.full((B,), S, np.int32)
    starts[0] = 0
    lengths = np.ones((B,), np.int32)
    lengths[0] = len(ids)
    runner.set_block_tables(
        (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB))
    _, _, (idx, vals) = runner.prefill(
        tokens, starts, lengths, SamplingParams.filled(
            B, temperature=0.0, device=runner.device),
        cfg.kv_bucket_for(Tb), greedy=True, topk=V)
    runner.set_block_tables(eng._tables)
    out = torch.empty(V)
    out[idx[0].long().cpu()] = vals[0].cpu()
    return out


def parallel_memory(eng) -> list:
    """Each rank's device bytes: its shard's weights and pool (rank 0,
    counted from its tensors: this process also holds the single-rank
    engine) and each worker's allocated and peak bytes."""
    runner = eng.runner
    pool = runner.cache
    own = {"weights": sum(t.nbytes for t in (*runner.params.parameters(),
                                             *runner.params.buffers())),
           "pool": sum(t.nbytes for t in (pool.k, pool.v, pool.ks, pool.vs)
                       if t is not None)}
    return [own] + runner.run_on_workers(
        "production_stack_tpu_torch.parallel.workers:memory")


def parallel_counts(eng) -> dict:
    """The kernels' launches of every rank since the last reset, summed,
    with the ranks' own (the flash kernel's among them: no path serves
    it)."""
    from production_stack_tpu_torch.ops import flash_attention as fa
    from production_stack_tpu_torch.ops import paged_attention as pa
    ops = "production_stack_tpu_torch.ops."
    ranks = [pa.launch_report()] + eng.runner.run_on_workers(
        ops + "paged_attention:launch_report")
    flash = [fa.launch_report()] + eng.runner.run_on_workers(
        ops + "flash_attention:launch_report")
    for r, f in zip(ranks, flash):
        r["launches"].update(f["launches"])
    total = {}
    for key in ("launches", "window_launches", "int8_launches"):
        total[key] = {name: sum(r[key][name] for r in ranks)
                      for name in ranks[0][key]}
    # the verify windows' launches by T (main() reads a verify row's)
    for key, name in (("verify_launches", "verify"),
                      ("verify_window_launches", "verify_window")):
        total[name] = {}
        for r in ranks:
            for kernel, by_t in r[key].items():
                mine = total[name].setdefault(kernel, {})
                for T, n in by_t.items():
                    mine[T] = mine.get(T, 0) + n
    total["step_launches"] = {}
    for r in ranks:
        for B, c in r["step_launches"].items():
            step = total["step_launches"].setdefault(B, dict.fromkeys(c, 0))
            for key, n in c.items():
                step[key] += n
    total["per_rank"] = [r["launches"] for r in ranks]
    return total


def parallel_reset(eng) -> None:
    from production_stack_tpu_torch.ops import flash_attention as fa
    from production_stack_tpu_torch.ops import paged_attention as pa
    for mod in (pa, fa):
        mod.reset_launch_counts()
        eng.runner.run_on_workers(f"{mod.__name__}:reset_launch_counts")


def parallel_check(ref_async, name, prompt, want, got) -> dict:
    """A parallel engine's tokens against the single-rank engine's on the
    same weights: equal, or parting at a near-tie (near_tie_check over
    the single-rank weights' f32 and bf16 teacher-forced logits; the
    shaped row: shaped_check on the served sequence)."""
    import dataclasses

    import torch
    if got == want:
        return {"tokens": len(got), "differ_at": None, "ok": True}
    eng = ref_async.engine
    if name != "shaped":
        return _tokens_check(got, eng, prompt, want)
    runner, mcfg = eng.runner, eng.model_cfg
    ids = prompt + got
    l32 = plain_tail_logits(runner, Upcast(runner.params),
                            dataclasses.replace(mcfg, dtype=torch.float32),
                            ids, len(got), torch.float32)
    l16 = plain_tail_logits(runner, runner.params, mcfg, ids, len(got),
                            mcfg.dtype)
    return shaped_check(ref_async, {"tokens": got, "prompt": prompt}, l32,
                        l16)


@contextmanager
def moe_capture():
    """{"exact", "dispatch"}: the MoE calls of this process by path;
    "routed": (routing input of the real tokens, router) in f32 of the
    first prefill call (N > 64) inside; "block": (input, token mask,
    output) of that call's MoE block (layer 0 of the first chunk; the
    output summed over the ranks), and "block_layer": (config, module,
    layer weights) it ran with, for moe_block_f32_check (drop it before
    the engine is released: it holds the weights)."""
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.ops import moe
    seen = {"exact": 0, "dispatch": 0}
    saved = (moe.moe_mlp, moe._moe_exact, moe._moe_dispatch,
             llama._moe_block)

    def mlp(x, router_w, *a, valid=None, **kw):
        if "routed" not in seen and valid is not None and x.shape[0] > 64:
            seen["routed"] = (x[valid].float(), router_w.float())
        return saved[0](x, router_w, *a, valid=valid, **kw)

    def block(cfg, model, lp, hidden, valid):
        y = saved[3](cfg, model, lp, hidden, valid)
        if "block" not in seen and valid is not None and valid.numel() > 64:
            seen["block"] = (hidden.clone(), valid.clone(), y.clone())
            seen["block_layer"] = (cfg, model, lp)
        return y

    def counted(kind, fn):
        def call(*a, **kw):
            seen[kind] += 1
            return fn(*a, **kw)
        return call
    moe.moe_mlp = mlp
    moe._moe_exact = counted("exact", saved[1])
    moe._moe_dispatch = counted("dispatch", saved[2])
    llama._moe_block = block
    try:
        yield seen
    finally:
        (moe.moe_mlp, moe._moe_exact, moe._moe_dispatch,
         llama._moe_block) = saved


def moe_block_f32_check(seen) -> dict:
    """The single-rank engine's first prefill MoE block (moe_capture's
    "block", which it pops "block_layer" of) against the same block in
    float32 on the same input (moe_call_f32's upcast, so the two route
    alike) over the real tokens: at most TOL["bfloat16"] of the f32
    block's largest output."""
    import torch
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.quant import is_quantized
    cfg, model, lp = seen.pop("block_layer")
    hidden, valid, y = seen["block"]
    lp32 = {name: (w if is_quantized(w) else w.float())
            for name, w in ((n, lp[n]) for n in lp._cols)}
    with torch.no_grad():
        want = llama._moe_block(cfg, model, lp32, hidden.float(), valid)
    err = (y.float() - want)[valid].abs().max().item()
    tol = TOL["bfloat16"] * want[valid].abs().max().item()
    return {"tokens": int(valid.sum().item()), "bf16_err": err,
            "tol": tol, "ok": err <= tol}


def moe_block_check(ref, got, ep: int) -> dict:
    """A world of `ep` expert ranks' first prefill MoE block
    (moe_capture's "block", summed over its ranks) against the
    single-rank engine's: the same input bit for bit (layer 0, before
    any exchange; so only where tp leaves the attention whole), and
    outputs over the real tokens at most ep bf16 spacings at the single
    rank's largest output apart (bf16 keeps 8 significant bits): the
    same products, each rank's partial rounded once more than the
    single rank's sum (at most half a spacing each), and the sum
    (half a spacing). A lost or wrong exchange moves a share of the
    output."""
    h1, v1, y1 = ref
    h2, v2, y2 = got
    same_input = (h1.shape == h2.shape and bool((h1 == h2).all())
                  and bool((v1 == v2).all()))
    top = y1.float()[v1].abs().max().item()
    tol = ep * 2.0 ** (math.floor(math.log2(top)) - 7)
    diff = ((y2.float() - y1.float())[v1].abs().max().item()
            if same_input else None)
    return {"same_input": same_input, "max_abs_diff": diff,
            "single_rank_max_abs": top, "tol": tol,
            "ok": same_input and diff <= tol}


def first_routing_f32(runner, ids) -> tuple:
    """Layer 0's MoE input (f32) and router of the first prefill chunk
    of `ids`, through the f32 weights (Upcast) and the plain attention:
    routing_check's reference."""
    import dataclasses

    import torch
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.kv import make_slot_cache
    from production_stack_tpu_torch.ops import moe
    from production_stack_tpu_torch.ops import paged_attention as pa
    mcfg = dataclasses.replace(runner.model_cfg, dtype=torch.float32,
                               num_layers=1)
    T = min(len(ids), runner.engine_cfg.prefill_chunk)
    dev = runner.device
    cache, tables = make_slot_cache(1, 1, -(-T // 64) * 64,
                                    mcfg.num_kv_heads, mcfg.head_dim_,
                                    dtype=torch.float32, block_size=64,
                                    device=dev)
    got = {}
    saved = (pa.paged_attention, pa.paged_decode_attention, moe.moe_mlp)

    def plain(q, k, v, tables, starts, *, nb, scale=None, window=0,
              softcap=0.0, k_scales=None, v_scales=None):
        return pa.paged_attention_plain(q, k, v, tables, starts, nb, scale,
                                        window, softcap)

    def capture(x, router_w, *a, **kw):
        got.setdefault("routed", (x.float(), router_w.float()))
        return saved[2](x, router_w, *a, **kw)
    pa.paged_attention = pa.paged_decode_attention = plain
    moe.moe_mlp = capture
    try:
        with torch.no_grad():
            llama.hidden(Upcast(runner.params), mcfg,
                         torch.tensor([ids[:T]], device=dev),
                         torch.arange(T, device=dev)[None], cache,
                         block_tables=tables, rope=runner.rope,
                         kv_len=-(-T // 64) * 64)
    finally:
        pa.paged_attention, pa.paged_decode_attention, moe.moe_mlp = saved
    return got["routed"]


def moe_reference(runner, prompt, want) -> dict:
    """The single-rank engine's reference data: f32 and bf16
    teacher-forced logits of its greedy sequence (near_tie_check's) and
    the f32 routing input of its first chunk (routing_check's)."""
    import dataclasses

    import torch
    cfg, ids = runner.model_cfg, prompt + want
    return {"l32": plain_tail_logits(
                runner, Upcast(runner.params),
                dataclasses.replace(cfg, dtype=torch.float32), ids,
                len(want), torch.float32),
            "l16": plain_tail_logits(runner, runner.params, cfg, ids,
                                     len(want), cfg.dtype),
            "routing": first_routing_f32(runner, prompt)}


def parallel_model(model: str, device: str, p: dict) -> dict:
    """One model of PARALLEL: the single-rank engine serves the requests
    (and its reference data is taken), then each mesh's engine serves
    them and is held to it; returns the kernels' launch counts of each
    parallel serving run by parallel_label."""
    import numpy as np
    import torch
    from production_stack_tpu_torch.engine.async_engine import \
        AsyncLLMEngine
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    counts = {}
    served_model = parallel_served(model, p)
    t0 = time.monotonic()
    mem0 = torch.cuda.memory_allocated() if device == "cuda" else 0
    ref = AsyncLLMEngine(EngineConfig(**served_model, device=device,
                                      **p["serve"]))
    ref.engine.runner.warmup()
    cfg = ref.engine.model_cfg
    reqs = parallel_requests(cfg, p)
    logp_prompt = np.array([reqs[0][1]["prompt"]], np.int32)

    def measure(eng):
        """The first greedy prompt's teacher-forced log-probabilities and
        its first step's log-softmax (first_step_logprobs), a timed
        decode window, and for a parallel engine every rank's last
        decode ids, memory and launches."""
        out = {}
        if eng.mesh is not None:
            # read before the comparisons below launch anything
            out["counts"] = parallel_counts(eng)
            if p["dp_mesh"]:
                # what dp_run serves on the dp engine, bit for bit
                out["batch"] = batch_tokens(eng, reqs)
            # each rank's last window of either kind (a mix whose every
            # window had a speculating row ran decode_spec alone)
            same = []
            for call in ("decode", "decode_spec"):
                ids = eng.runner.last_results(call)
                if ids[0] is not None:
                    same.append(all(r is not None
                                    and torch.equal(r[0], ids[0][0])
                                    for r in ids[1:]))
            out["same_ranks"] = bool(same) and all(same)
            out["memory"] = parallel_memory(eng)
        out["logp"] = eng.runner.prompt_logprobs(logp_prompt).cpu()
        out["first"] = first_step_logprobs(eng, reqs[0][1]["prompt"])
        out["step"] = parallel_step_timing(eng)
        return out
    ref_out = asyncio.run(parallel_serve(ref, reqs, measure))
    ref_moe = ref_out["moe"]
    ref_logp = ref_out["inside"]["logp"]
    ref_first = ref_out["inside"]["first"]
    ref_timing = ref_out["inside"]["step"]
    moe_ref = {}
    if cfg.num_experts:
        # taken before the single-rank engine goes (its weights do not
        # fit beside the parallel ranks')
        moe_ref = moe_reference(ref.engine.runner,
                                *ref_out["tokens"][reqs[0][0]])
        moe_ref["served_routing"] = ref_moe.get("routed")
        moe_ref["block_f32"] = moe_block_f32_check(ref_moe)
    int8_ref = None
    if p["int8"]:
        # the single-rank engine's weights over an int8 pool
        int8_ref = LLMEngine(EngineConfig(**served_model, device=device,
                                          **dict(p["serve"],
                                                 kv_dtype="int8")),
                             params=ref.engine.runner.params)
        int8_prompt = reqs[0][1]["prompt"][:p["int8"]]
        int8_want = _serve_direct(int8_ref, int8_prompt, p["tokens"])[0]
    log(json.dumps({"parallel_reference": {
        "model": model, "seconds": time.monotonic() - t0,
        "mem_gib_before": mem0 / 2**30,
        "step": ref_timing, "moe_paths": {k: ref_moe[k] for k in
                                          ("exact", "dispatch")},
        "moe_block_f32": moe_ref.get("block_f32")}}))
    if not moe_ref.get("block_f32", {"ok": True})["ok"]:
        raise AssertionError(f"parallel {model}: the single rank's MoE "
                             f"block against f32: {moe_ref['block_f32']}")
    if cfg.num_experts:
        release(ref)
        ref = None
    tp_run = None
    for mesh in p["meshes"]:
        t0 = time.monotonic()
        par = AsyncLLMEngine(EngineConfig(**served_model, device=device,
                                          **p["serve"], **mesh))
        ready_s = time.monotonic() - t0
        par.engine.runner.warmup()
        label = parallel_label(model, mesh)
        parallel_reset(par.engine)
        t1 = time.monotonic()
        out = asyncio.run(parallel_serve(par, reqs, measure))
        serve_s = time.monotonic() - t1
        inside, moe_seen = out["inside"], out["moe"]
        moe_seen.pop("block_layer", None)
        counts[label] = inside["counts"]
        checks = {}
        for name, body in reqs:
            prompt, want = ref_out["tokens"][name]
            got = out["tokens"][name][1]
            if cfg.num_experts:
                checks[name] = near_tie_check(want, got, moe_ref["l32"],
                                              moe_ref["l16"])
            else:
                checks[name] = parallel_check(ref, name, prompt, want, got)
        same_ranks = inside["same_ranks"]
        rec = {"model": model, "mesh": mesh, "label": label,
               "world": par.engine.runner.mesh.describe(),
               "engine_ready_s": ready_s, "serve_s": serve_s,
               "tokens": checks,
               "workers_sampled_rank0_tokens": same_ranks,
               "first_step_logprobs_max_abs_diff_vs_single": float(
                   (inside["first"] - ref_first).abs().max()),
               "first_step_argmax_equal": int(inside["first"].argmax())
               == int(ref_first.argmax()),
               "prompt_logprobs_max_abs_diff_vs_single": float(
                   (inside["logp"] - ref_logp).abs().max()),
               "memory_per_rank": inside["memory"],
               "step": inside["step"], "single_rank_step": ref_timing,
               "launches": counts[label], "load": out["load"]}
        ok = same_ranks and all(c["ok"] for c in checks.values()) \
            and counts[label]["launches"]["paged_attention"] > 0 \
            and counts[label]["launches"]["paged_decode_attention"] > 0
        if p["dp_mesh"] and mesh is p["meshes"][0]:
            # what the dp engine is held to (dp_run)
            tp_run = {"batch": inside["batch"], "step": inside["step"],
                      "memory": inside["memory"]}
        if cfg.num_experts:
            routing = routing_check(moe_ref["routing"], moe_seen["routed"],
                                    cfg.num_experts_per_tok)
            rec["routing"] = routing
            rec["moe_paths"] = {k: moe_seen[k] for k in ("exact",
                                                         "dispatch")}
            served = moe_ref["served_routing"]
            rec["routing_input_equal_single_rank"] = bool(
                served is not None and served[0].shape
                == moe_seen["routed"][0].shape
                and torch.equal(served[0], moe_seen["routed"][0]))
            ok = ok and routing["ok"] and moe_seen["dispatch"] > 0 \
                and moe_seen["exact"] > 0
            if mesh.get("tensor_parallel_size", 1) == 1:
                # the block's input is layer 0's attention, which tp cuts
                rec["moe_block"] = moe_block_check(
                    ref_moe["block"], moe_seen["block"],
                    mesh["expert_parallel_size"])
                ok = ok and rec["moe_block"]["ok"]
        if p["int8"]:
            release(par)
            free_memory()
            par = LLMEngine(EngineConfig(**served_model, device=device,
                                         **dict(p["serve"],
                                                kv_dtype="int8"), **mesh))
            label8 = parallel_label(model, mesh, "int8")
            parallel_reset(par)
            got8 = _serve_direct(par, int8_prompt, p["tokens"])[0]
            counts[label8] = parallel_counts(par)
            rec["int8_pool"] = {
                "tokens": _tokens_check(got8, int8_ref, int8_prompt,
                                        int8_want),
                "launches": counts[label8]}
            ok = ok and rec["int8_pool"]["tokens"]["ok"] \
                and counts[label8]["int8_launches"]["paged_attention"] > 0
            if p["dp_mesh"] and mesh is p["meshes"][0]:
                tp_run["int8"] = got8
            par.close()
            par = None
        else:
            release(par)
        free_memory()
        rec["seconds"] = time.monotonic() - t0
        rec["ok"] = bool(ok)
        log(json.dumps({"parallel": rec}))
        if not ok:
            raise AssertionError(f"parallel {label}: {rec}")
    if ref is not None:
        release(ref)
    int8_ref = None
    free_memory()
    if p["dp_mesh"]:
        counts.update(dp_run(model, device, p, reqs,
                             reqs[0][1]["prompt"][:p["int8"]], tp_run))
    return counts


def assembly_timing(runner, B: int, nbs, iters: int = 10) -> dict:
    """On one rank of a dp engine (ParallelRunner.map_ranks runs it on
    every rank at once): the host wall of layer 0's assembly of B rows'
    first nb blocks (tables over blocks 1.. of both dp ranks; the local
    gather and the dp sum, kv.assemble_blocks) and of the local gather
    alone, ms per layer, beside the assembled copy's bytes, for each nb
    of nbs. Counts the collectives it issues (mesh.calls)."""
    import torch
    from production_stack_tpu_torch.models import kv
    c, dev = runner.cache, runner.device

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    MB = runner.engine_cfg.max_blocks_per_seq
    tables = (1 + torch.arange(B * MB, dtype=torch.int32,
                               device=dev)).reshape(B, MB)
    out = {}
    for nb in sorted({min(nb, MB) for nb in nbs}):
        def assemble():
            return kv.assemble_blocks(c, 0, tables, nb, runner.mesh)

        def gather():
            return (kv.gather_owned(c.k[0], c, tables, nb),
                    kv.gather_owned(c.v[0], c, tables, nb))
        row = {"B": B, "nb": nb, "keys": nb * c.block_size,
               "bytes": sum(t.nbytes for t in assemble() if t is not None)}
        for name, fn in (("assemble", assemble), ("gather_owned", gather)):
            fn()
            sync()
            t0 = time.monotonic()
            for _ in range(iters):
                fn()
            sync()
            row[name + "_ms"] = (time.monotonic() - t0) / iters * 1e3
        out[f"nb{nb}"] = row
    return out


def launches_by_t(report: dict) -> dict:
    """One rank's paged kernel launches (pa.launch_report) by the query
    window's length T: decode at T = 1 (decode steps) and at the verify
    lengths, prefill at the verify lengths and above them (chunks)."""
    from production_stack_tpu_torch.ops import paged_attention as pa
    verify = report["verify_launches"]
    decode = {"1": sum(c["launches"] for c in
                       report["step_launches"].values())}
    decode.update({str(T): n for T, n in
                   sorted(verify["paged_decode_attention"].items())})
    prefill = {str(T): n for T, n in
               sorted(verify["paged_attention"].items())}
    prefill[f">{pa.VERIFY_T_MAX}"] = \
        report["launches"]["paged_attention"] - sum(prefill.values())
    return {"paged_decode_attention": decode, "paged_attention": prefill}


def dp_run(model: str, device: str, p: dict, reqs, int8_prompt,
           tp_run: dict) -> dict:
    """The dp line: p["dp_mesh"] (dp = 2 x tp = 2 for Llama-3-8B: four
    ranks sharing the card over gloo, each with a tp = 2 slice of the
    weights and half the pool's blocks) at PARALLEL's serve geometry.
    The mesh refused on the card without dp_gather_attention_ok; with
    it, the engine serves the first request through its server, then
    the same batch that the tp engine served (batch_tokens) and the int8
    pool's request, each bit for bit equal to the tp engine's; rank 0's
    kernel launches by T (> 0 for both kernels) with no call of the
    plain version, the pool per rank beside the tp engine's, the
    assembly's ms per layer beside its bytes, a decode step's wall and
    collectives beside the tp engine's. Returns the launch counts by
    label."""
    from production_stack_tpu_torch.engine.async_engine import \
        AsyncLLMEngine
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.ops import paged_attention as pa
    from production_stack_tpu_torch.parallel.mesh import MeshConfig
    t0 = time.monotonic()
    served_model = parallel_served(model, p)
    dm = p["dp_mesh"]
    mesh = MeshConfig(dp=dm["dp"], tp=dm["tensor_parallel_size"])
    serve = dict(p["serve"], tensor_parallel_size=mesh.tp)
    rec = {"model": model, "mesh": {"dp": mesh.dp, "tp": mesh.tp}}
    try:
        LLMEngine(EngineConfig(**served_model, device=device, **serve),
                  mesh=mesh)
        rec["refusal"] = {"raised": None}
    except ValueError as e:
        rec["refusal"] = {"raised": type(e).__name__,
                          "gathered_view": "gathered-view" in str(e),
                          "message": str(e)[:240]}
    label = parallel_label(model, dm)
    counts = {}
    t1 = time.monotonic()
    par = AsyncLLMEngine(EngineConfig(**served_model, device=device,
                                      dp_gather_attention_ok=True, **serve),
                         mesh=mesh)
    rec["engine_ready_s"] = time.monotonic() - t1
    par.engine.runner.warmup()
    parallel_reset(par.engine)
    plain = {"calls": 0}
    saved = pa.paged_attention_plain

    def counted_plain(*a, **kw):
        plain["calls"] += 1
        return saved(*a, **kw)

    def measure(eng):
        out = {"counts": parallel_counts(eng),
               "rank0": launches_by_t(pa.launch_report())}
        out["batch"] = batch_tokens(eng, reqs)
        out["pools"] = eng.runner.map_ranks(
            "production_stack_tpu_torch.parallel.workers:pool_report")
        out["memory"] = parallel_memory(eng)
        out["step"] = parallel_step_timing(eng)
        out["assembly"] = eng.runner.map_ranks(
            "chip_smoke:assembly_timing", eng.cfg.max_num_seqs,
            (out["step"]["kv_len"] // eng.cfg.kv_block_size,
             1024 // eng.cfg.kv_block_size))
        return out
    pa.paged_attention_plain = counted_plain
    t1 = time.monotonic()
    try:
        # one request through the server; the batch (measure) holds all
        served = asyncio.run(parallel_serve(par, reqs[:1], measure))
    finally:
        pa.paged_attention_plain = saved
    rec["serve_s"] = time.monotonic() - t1
    inside = served["inside"]
    counts[label] = inside["counts"]
    rec["world"] = par.engine.runner.mesh.describe()
    release(par)
    free_memory()
    batch = {name: {"tokens": len(got),
                    "equal_tp": got == tp_run["batch"][name]}
             for name, got in inside["batch"].items()}
    rec["batch_vs_tp"] = batch
    rec["served_tokens"] = {name: len(ids) for name, (_, ids) in
                            served["tokens"].items()}
    rec["launches_rank0_by_T"] = inside["rank0"]
    rec["plain_calls_rank0"] = plain["calls"]
    rec["launches"] = counts[label]
    tp_pool = tp_run["memory"][0]["pool"]
    rec["pool_per_rank"] = inside["pools"]
    rec["pool_bytes_share_of_tp_rank"] = \
        inside["pools"][0]["bytes"] / tp_pool
    rec["tp_rank_pool_bytes"] = tp_pool
    rec["memory_per_rank"] = inside["memory"]
    rec["assembly_per_layer"] = inside["assembly"][0]
    rec["assembly_ms_other_ranks"] = [
        {nb: r[nb]["assemble_ms"] for nb in r} for r in inside["assembly"][1:]]
    rec["step"], rec["tp_step"] = inside["step"], tp_run["step"]
    # the int8 pool: the tp engine's one direct request, bit for bit
    par = LLMEngine(EngineConfig(**served_model, device=device,
                                 dp_gather_attention_ok=True,
                                 **dict(serve, kv_dtype="int8")), mesh=mesh)
    label8 = parallel_label(model, dm, "int8")
    parallel_reset(par)
    got8 = _serve_direct(par, int8_prompt, p["tokens"])[0]
    counts[label8] = parallel_counts(par)
    rank0_8 = launches_by_t(pa.launch_report())
    par.close()
    par = None
    free_memory()
    rec["int8_pool"] = {"tokens": len(got8),
                        "equal_tp": got8 == tp_run["int8"],
                        "launches": counts[label8],
                        "launches_rank0_by_T": rank0_8}
    pools = inside["pools"]
    checks = {
        "refused_without_flag": rec["refusal"].get("raised") == "ValueError"
        and rec["refusal"]["gathered_view"],
        "batch_equal_tp": all(b["equal_tp"] for b in batch.values()),
        "int8_equal_tp": rec["int8_pool"]["equal_tp"],
        "decode_launches": counts[label]["launches"][
            "paged_decode_attention"] > 0
        and sum(inside["rank0"]["paged_decode_attention"].values()) > 0,
        "prefill_launches": counts[label]["launches"]["paged_attention"] > 0
        and sum(inside["rank0"]["paged_attention"].values()) > 0,
        "int8_launches": counts[label8]["int8_launches"][
            "paged_attention"] > 0
        and counts[label8]["int8_launches"]["paged_decode_attention"] > 0,
        "no_plain_call": plain["calls"] == 0,
        "blocks_split": all(r["owned_blocks"] * mesh.dp == r["pool_blocks"]
                            for r in pools)
        and [r["dp_rank"] for r in pools]
        == [rk // mesh.tp for rk in range(mesh.size)],
        "assembly_collectives": inside["step"]["collectives_per_step"].get(
            "dp.assemble", 0) > 0,
    }
    rec["checks"] = checks
    rec["ok"] = all(checks.values())
    rec["seconds"] = time.monotonic() - t0
    log(json.dumps({"dp": rec}))
    if not rec["ok"]:
        raise AssertionError(f"the dp run failed: {checks}")
    return counts


def dryrun_phase(device="cuda") -> dict:
    """parallel/dryrun.py's serving half at n = 4 (dp 2 x tp 2 over f32,
    int8 and bf16 pools; debug-moe at ep 2 x tp 2; the tp feature pass;
    the disk-tier handoff), every rank a process on the one card, the
    tiny models at head dim 64."""
    import shutil
    from production_stack_tpu_torch.parallel import dryrun
    t0 = time.monotonic()
    where = os.path.join(REPO, "build", "dryrun_serving")
    try:
        report = dryrun.dryrun_serving(4, device, workdir=where)
    finally:
        shutil.rmtree(where, ignore_errors=True)
    report["total_s"] = time.monotonic() - t0
    log(json.dumps({"dryrun_serving": report}))
    return report


def parallel_phase(device="cuda") -> dict:
    """Every model of PARALLEL (parallel_model, with its dp run), then
    the serving dry run (dryrun_phase); the launch counts of the
    parallel serving runs by label."""
    counts = {}
    t0 = time.monotonic()
    for model, p in PARALLEL.items():
        counts.update(parallel_model(model, device, p))
    dryrun_phase(device)
    free_memory()
    log(json.dumps({"parallel_phase_s": time.monotonic() - t0}))
    return counts


# ------------------------------------------------------------- training

# the train phase: Llama-3-8B at full width and depth, one batch of
# B x T tokens drawn from a seed, `steps` train_steps; the gradient check
# at full width and `grad_layers` layers; the training worlds at the JAX
# dry run's size over `dryrun_ranks` ranks on the one card
TRAIN = dict(model="llama-3-8b", batch=1, seq=512, steps=3, seed=0,
             token_seed=13, grad_layers=2, dryrun_ranks=8)
# bf16 gradients (and one bf16 AdamW step's moments) against float32's
# on the same weights: relative Frobenius error per leaf
TRAIN_GRAD_TOL = 3e-2


@contextmanager
def select_layers():
    """encode reads every layer by indexing each stacked leaf (select),
    as the forward did before layer_params split each leaf once: its
    backward adds a zero-filled gradient of the whole leaf per layer."""
    from production_stack_tpu_torch.models import llama

    class Layer:
        def __init__(self, model, l):
            self.model, self.l = model, l

        def __getitem__(self, name):
            return getattr(self.model, name)[self.l]
    split = llama.layer_params
    llama.layer_params = lambda model: [
        Layer(model, l) for l in range(model.cfg.num_layers)]
    try:
        yield
    finally:
        llama.layer_params = split


def train_flops(cfg, B: int, T: int) -> dict:
    """A train step's FLOPs: 6 per matmul parameter per token (forward
    2, backward 4; the embedding is a lookup) plus the plain attention's
    full T x T score and value products (4 B H T^2 D a layer forward,
    twice that backward)."""
    from production_stack_tpu_torch.models.llama import leaf_shapes
    matmul = sum(math.prod(s) for n, s in leaf_shapes(cfg).items()
                 if n in ("q", "k", "v", "o", "gate", "up", "down",
                          "lm_head"))
    attn = 3 * 4 * B * cfg.num_heads * T * T * cfg.head_dim_ \
        * cfg.num_layers
    return {"matmul_params": matmul, "flops": 6 * matmul * B * T + attn,
            "attention_flops": attn}


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def train_forward_check(model, cfg, tokens) -> dict:
    """forward_train's f32 logits against llama.forward through the paged
    prefill kernel (a 512-token pool) on the same tokens, and the
    argmax of each against an f32 forward of the same weights (upcast a
    layer at a time): equal, or parting at near-ties (near_tie_check's
    tolerance, from every position's gaps, held at every position where
    they part)."""
    import dataclasses
    import torch
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.kv import make_slot_cache
    from production_stack_tpu_torch.ops import paged_attention as pa
    B, T = tokens.shape
    dev = tokens.device
    with torch.no_grad():
        train_logits = llama.forward_train(model, cfg, tokens)[0]
        cache, tables = make_slot_cache(cfg.num_layers, B, T,
                                        cfg.num_kv_heads, cfg.head_dim_,
                                        cfg.dtype, 64, dev)
        pa.reset_launch_counts()
        positions = torch.arange(T, device=dev)[None].expand(B, T)
        kernel_logits = llama.forward(model, cfg, tokens, positions, cache,
                                      block_tables=tables)[0][0]
        torch.cuda.synchronize()
        launches = dict(pa.launch_counts)
        pool_bytes = cache.k.nbytes + cache.v.nbytes
        del cache
        ref = llama.forward_train(
            Upcast(model), dataclasses.replace(cfg, dtype=torch.float32),
            tokens)[0]
    if launches["paged_attention"] != cfg.num_layers:
        raise AssertionError(f"the kernel forward launched {launches}")
    want = kernel_logits.argmax(-1).tolist()
    got = train_logits.argmax(-1).tolist()
    tie = near_tie_check(want, got, ref, train_logits)
    parted = [i for i in range(T) if want[i] != got[i]]
    gaps = [(ref[i, want[i]] - ref[i, got[i]]).abs().item() for i in parted]
    out = {"max_abs_diff": (train_logits - kernel_logits).abs().max().item(),
           "max_abs_logit": kernel_logits.abs().max().item(),
           "kernel_launches": launches, "pool_bytes": pool_bytes,
           "positions": T, "argmax_parted": len(parted),
           "parted_max_f32_gap": max(gaps, default=0.0),
           "near_tie_tol": tie.get("tol"),
           "f32_max_abs_diff": (train_logits - ref).abs().max().item()}
    if parted and max(gaps) > tie["tol"]:
        raise AssertionError(f"forward_train's argmax parts from the "
                             f"kernel's beyond a near-tie: {out}")
    return out


def train_full(device="cuda") -> dict:
    """TRAIN's model at full width and depth: the forward check, the
    backward with each leaf split once (unbind) and read per layer
    (select), then `steps` train_steps (their losses finite and
    falling, their wall), one step timed part by part (forward,
    backward, the norm of the clip, AdamW), one profiled (launches,
    idle share), and the peak memory beside the state's bytes."""
    import numpy as np
    import torch
    from production_stack_tpu_torch.models import config as tconfig
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.ops import flash_attention as fa
    from production_stack_tpu_torch.ops import paged_attention as pa
    from production_stack_tpu_torch.parallel import train
    cfg = tconfig.get_config(TRAIN["model"])
    B, T = TRAIN["batch"], TRAIN["seq"]
    t0 = time.monotonic()
    model = llama.init_params(
        cfg, torch.Generator(device=device).manual_seed(TRAIN["seed"]),
        device=device)
    tokens = torch.from_numpy(np.random.default_rng(
        TRAIN["token_seed"]).integers(0, cfg.vocab_size, (B, T))).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    param_bytes = sum(p.nbytes for p in model.parameters())
    out = {"model": cfg.name, "layers": cfg.num_layers,
           "hidden": cfg.hidden_size, "params": n_params,
           "tokens": [B, T], "init_s": time.monotonic() - t0}
    out["forward_check"] = train_forward_check(model, cfg, tokens)
    log(json.dumps({"train_forward_check": out["forward_check"]}))

    train.trainable(model)
    params = list(model.parameters())
    # a first forward and backward, untimed: cuBLAS's workspaces and the
    # allocator's pool are made here, not in the first timed pass
    torch.autograd.grad(train.loss_fn(model, cfg, tokens), params)
    for how in ("select", "unbind"):
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        with (select_layers() if how == "select" else nullcontext()):
            ev[0].record()
            loss = train.loss_fn(model, cfg, tokens)
            ev[1].record()
            grads = torch.autograd.grad(loss, params)
            ev[2].record()
        torch.cuda.synchronize()
        out[f"backward_{how}"] = {
            "forward_ms": ev[0].elapsed_time(ev[1]),
            "backward_ms": ev[1].elapsed_time(ev[2]),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del loss, grads
    free_memory()

    optimizer = train.make_optimizer()
    state = train.init_train_state(model, optimizer)
    torch.cuda.reset_peak_memory_stats()
    pa.reset_launch_counts()
    fa.reset_launch_counts()
    losses, walls = [], []
    for _ in range(TRAIN["steps"]):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        state, loss = train.train_step(state, tokens, cfg, optimizer)
        e1.record()
        torch.cuda.synchronize()
        walls.append(e0.elapsed_time(e1))
        losses.append(loss.item())
    peak = torch.cuda.max_memory_allocated()
    launches = {**pa.launch_counts, **fa.launch_counts}
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train_step losses not finite and falling: "
                             f"{losses}")
    if any(launches.values()):
        raise AssertionError(f"training launched a serving kernel: "
                             f"{launches}")
    out.update({"losses": losses, "step_ms": walls,
                "kernel_launches": launches, "peak_gb": peak / 1e9,
                "state_gb": 4 * param_bytes / 1e9,
                "peak_over_state_gb": (peak - 4 * param_bytes) / 1e9})

    # one step part by part: the calls train_step makes, in its order
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    named = dict(model.named_parameters())
    ev[0].record()
    loss = train.loss_fn(model, cfg, tokens)
    ev[1].record()
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    ev[2].record()
    g_norm = train.global_norm(grads)
    ev[3].record()
    opt_state = optimizer.update_(named, grads, state.opt_state, g_norm)
    ev[4].record()
    torch.cuda.synchronize()
    del grads, loss
    state = train.TrainState(model, opt_state, state.step + 1)
    parts = dict(zip(("forward_ms", "backward_ms", "clip_norm_ms",
                      "adamw_ms"),
                     (ev[i].elapsed_time(ev[i + 1]) for i in range(4))))
    parts["g_norm"] = g_norm.item()

    def step():
        nonlocal state
        state, loss = train.train_step(state, tokens, cfg, optimizer)
        loss.item()
    prof = device_profile(step)
    flops = train_flops(cfg, B, T)
    step_ms = min(walls)
    bound = {"flops": flops["flops"], "matmul_params": flops["matmul_params"],
             "flop_bound_ms": flops["flops"] / BF16_FLOPS * 1e3,
             "adamw_bytes": 14 * n_params,
             "adamw_bound_ms": 14 * n_params / HBM_BPS * 1e3,
             "norm_bytes": 2 * n_params,
             "norm_bound_ms": 2 * n_params / HBM_BPS * 1e3}
    out.update({"parts": parts, "bounds": bound,
                "tokens_per_s": B * T / (step_ms / 1e3),
                "flop_share": bound["flop_bound_ms"] / step_ms,
                "profile": profile_summary(prof, 1, step_ms),
                "steps_taken": state.step})
    del state, model, named, opt_state, params
    free_memory()
    return out


def train_grad_check(device="cuda") -> dict:
    """TRAIN's model at full width and grad_layers layers: every leaf's
    bf16 gradient against the float32 gradient of the same weights
    upcast, and one bf16 AdamW step against the same step in float32 on
    the same (bf16) gradients: the moments within TRAIN_GRAD_TOL, the
    new weights within twice the error of rounding the f32 step's
    weights to bf16."""
    import dataclasses
    import numpy as np
    import torch
    from production_stack_tpu_torch.models import config as tconfig
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.parallel import train
    cfg = dataclasses.replace(tconfig.get_config(TRAIN["model"]),
                              num_layers=TRAIN["grad_layers"])
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    B, T = TRAIN["batch"], TRAIN["seq"]
    m16 = train.trainable(llama.init_params(
        cfg, torch.Generator(device=device).manual_seed(TRAIN["seed"]),
        device=device))
    m32 = llama.Llama(cfg32, device=device)
    with torch.no_grad():
        for (_, p32), p16 in zip(m32.named_parameters(), m16.parameters()):
            p32.copy_(p16.float())
    train.trainable(m32)
    tokens = torch.from_numpy(np.random.default_rng(
        TRAIN["token_seed"]).integers(0, cfg.vocab_size, (B, T))).to(device)
    names = [n for n, _ in m16.named_parameters()]
    g16 = dict(zip(names, torch.autograd.grad(
        train.loss_fn(m16, cfg, tokens), list(m16.parameters()))))
    g32 = dict(zip(names, torch.autograd.grad(
        train.loss_fn(m32, cfg32, tokens), list(m32.parameters()))))
    grad_err = {n: rel_err(g16[n], g32[n]) for n in names}
    del g32
    opt = train.make_optimizer()
    p16, p32 = dict(m16.named_parameters()), dict(m32.named_parameters())
    before = {n: p.detach().float().clone() for n, p in p16.items()}
    s16 = opt.update_(p16, g16, opt.init(p16), train.global_norm(g16))
    g16f = {n: g.float() for n, g in g16.items()}
    s32 = opt.update_(p32, g16f, opt.init(p32), train.global_norm(g16f))
    mu_err = {n: rel_err(s16.mu[n], s32.mu[n]) for n in names}
    nu_err = {n: rel_err(s16.nu[n], s32.nu[n]) for n in names}
    # the bf16 step's weights against the f32 step's, beside the error
    # of rounding the f32 step's weights to bf16 (the floor)
    w_err, floor, upd_err = {}, {}, {}
    for n in names:
        want = p32[n].detach()
        w_err[n] = float((p16[n].detach().float() - want).norm())
        floor[n] = float((want.to(torch.bfloat16).float() - want).norm())
        upd_err[n] = rel_err(p16[n].detach().float() - before[n],
                             want - before[n])
    out = {"layers": cfg.num_layers, "grad_rel_err": grad_err,
           "max_grad_rel_err": max(grad_err.values()),
           "adamw": {"mu_rel_err": max(mu_err.values()),
                     "nu_rel_err": max(nu_err.values()),
                     "weights_err_over_rounding": max(
                         w_err[n] / floor[n] for n in names if floor[n]),
                     "update_rel_err": upd_err}}
    bad = [n for n in names if grad_err[n] > TRAIN_GRAD_TOL
           or mu_err[n] > TRAIN_GRAD_TOL or nu_err[n] > TRAIN_GRAD_TOL
           or w_err[n] > 2 * floor[n] + 1e-12]
    if bad:
        raise AssertionError(f"bf16 training parts from f32 on {bad}: "
                             f"{out}")
    del m16, m32, g16, g16f, s16, s32, p16, p32, before
    free_memory()
    return out


def train_phase(device="cuda") -> dict:
    """The training path on the card (TRAIN): train_full, then
    train_grad_check, then the training worlds of parallel/dryrun.py
    (dp 2 x sp 2 x tp 2 and pp = 2, every rank a process on the one
    card). Every engine is freed before it starts."""
    import torch
    from production_stack_tpu_torch.parallel import dryrun
    free_memory()
    t0 = time.monotonic()
    start_gb = torch.cuda.memory_allocated() / 1e9
    full = train_full(device)
    log(json.dumps({"train": full}))
    grad = train_grad_check(device)
    log(json.dumps({"train_grad": grad}))
    t1 = time.monotonic()
    worlds = dryrun.dryrun_multichip(TRAIN["dryrun_ranks"], device)
    worlds["seconds"] = time.monotonic() - t1
    log(json.dumps({"train_worlds": worlds}))
    out = {"train_phase_s": time.monotonic() - t0,
           "memory_at_start_gb": start_gb}
    log(json.dumps(out))
    return out


def build_phase(kernels) -> dict:
    """Build every source (in parallel) and report, per kernel, what
    ptxas gave it: registers, static shared memory, spill bytes; the
    HGMMA (wgmma) instructions of the bfloat16 prefill kernel (over a
    bf16 and over an int8 pool), and the HGMMA and UTMALDG (TMA load)
    instructions of each bfloat16 flash kernel in the built library, none
    of which may be 0; `decode` the bf16-q decode kernel's six
    instantiations (bf16 and int8 pools, D 64/128/256) with their
    registers, spills and HMMA (mma.sync) count, which may not be 0;
    `int8` lists the instantiations over an int8 pool (paged decode and
    both prefill kernels, at D 64/128/256) with their registers, spills
    and the bf16 prefill's HGMMA count."""
    report = kernels.build()
    out = {"sources": sorted(report) or "cached", "kernels": {}}
    for name in kernels.SOURCES:
        if name in report:
            out["seconds_" + name] = report[name]["seconds"]
        out["kernels"].update(
            kernels.resource_report(kernels.build_log(name)))
    hgmma = {k: n for k, n in kernels.sass_count("paged_attention",
                                                 "HGMMA").items()
             if "paged_prefill_kernel" in k}
    out["hgmma"] = hgmma
    if not hgmma or min(hgmma.values()) == 0:
        raise AssertionError(f"the bf16 prefill kernel has no HGMMA "
                             f"instruction: {hgmma}")
    # the bf16-q decode kernel (mma.sync: HMMA), over a bf16 and an int8
    # pool at D 64 / 128 / 256: registers, spills and HMMA count
    decode = {k: dict(out["kernels"].get(k, {}), HMMA=n)
              for k, n in kernels.sass_count("paged_attention",
                                             "HMMA").items()
              if "paged_decode_mma_kernel" in k}
    out["decode"] = decode
    if len(decode) != 6 or min(r["HMMA"] for r in decode.values()) == 0:
        raise AssertionError(f"the tensor-core decode kernel is not built "
                             f"for both pools at every head dim, or has no "
                             f"HMMA instruction: {decode}")
    int8 = {k: dict(r, **({"HGMMA": hgmma[k]} if k in hgmma else {}))
            for k, r in out["kernels"].items() if "signed char" in k}
    out["int8"] = int8
    wgmma8 = [r["HGMMA"] for k, r in int8.items()
              if "paged_prefill_kernel<" in k]
    if len(int8) != 12 or len(wgmma8) != 3 or min(wgmma8) == 0:
        raise AssertionError(f"the int8 instantiations are not all built, "
                             f"or the bf16 prefill over an int8 pool has no "
                             f"HGMMA instruction: {int8}")
    flash = {}
    for op in ("HGMMA", "UTMALDG"):
        for k, n in kernels.sass_count("flash_attention", op).items():
            if "flash_kernel<" in k:
                flash.setdefault(k, dict(out["kernels"].get(k, {})))[op] = n
    out["flash"] = flash
    if not flash or min(min(f["HGMMA"], f["UTMALDG"])
                        for f in flash.values()) == 0:
        raise AssertionError(f"a bf16 flash kernel has no HGMMA or no "
                             f"UTMALDG instruction: {flash}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the "
              "port on an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import production_stack_tpu_torch as port
    if not os.path.dirname(os.path.abspath(port.__file__)).startswith(
            REPO):
        raise RuntimeError(f"production_stack_tpu_torch imported from "
                           f"{port.__file__}, not from {REPO}")
    from production_stack_tpu_torch import kernels
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    gpu = gpu_line()
    t_start = time.monotonic()
    # flex_attention's compiled kernels are cached inside the checkout
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(REPO, "build", sub))

    t0 = time.monotonic()
    log(json.dumps({"build": build_phase(kernels),
                    "seconds": time.monotonic() - t0}))

    t0 = time.monotonic()
    records = kernel_phase()
    log(json.dumps({"kernel_phase_s": time.monotonic() - t0}))

    checkpoint_phase()

    encoder_phase()

    counts = {path: model_phase(path) for path in PATHS}

    # before kvtier, which leaves device memory allocated behind it
    counts.update(parallel_phase())

    train_phase()

    kvtier_phase()

    for rec in records:
        name = rec["name"]
        if name == "flash_attention_with_cache":
            # the flash kernel serves no path, as in the JAX package: its
            # launches over every serving run (serve_phase holds it to 0)
            rec["launches"] = sum(c["launches"][name]
                                  for c in counts.values())
        elif rec["path"] is None:
            # an int8 row at the shapes of a model served with a bf16 pool
            rec["launches"] = 0
        elif "batch" in rec:
            # a batch bucket below max_num_seqs: the windows phase's
            # decode steps at it (the serving run's windows stay at
            # max_num_seqs: its long prompt's kv probe and its seeded
            # row pin the fixed geometry)
            rec["launches"] = counts[rec["path"]]["windows_by_batch"].get(
                rec["batch"], 0)
        elif "verify_T" in rec:
            # a verify window: launches at that T while speculating
            c, T = counts[rec["path"]], rec["verify_T"]
            total = c["verify"].get(name, {}).get(T, 0)
            windowed = c["verify_window"].get(name, {}).get(T, 0)
            rec["launches"] = {"all": total, "sliding": windowed,
                               "global": total - windowed}[rec["layers"]]
        else:
            c = counts[rec["path"]]
            key = ("int8_launches" if rec["kv_dtype"] == "int8"
                   else "launches")
            if name == "paged_decode_attention":
                # a decode step: the serving run's steps at this row's
                # batch (adaptive windows run at several batch buckets)
                step = c["step_launches"].get(rec["shape"]["B"], {})
                total, windowed = (step.get(key, 0),
                                   step.get("window_launches", 0))
            else:
                total, windowed = (c[key][name],
                                   c["window_launches"][name])
            rec["launches"] = {"all": total, "sliding": windowed,
                               "global": total - windowed}[rec["layers"]]
        del rec["shape"]
    log(json.dumps({"total_s": time.monotonic() - t_start}))
    log(json.dumps({"kernels": records}))
    log(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
