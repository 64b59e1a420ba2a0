#!/usr/bin/env python3
"""Drive the PyTorch port (production_stack_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. build: compiles the CUDA kernels from csrc/ with nvcc (sm_90a), one
   nvcc per source, all started together, and reports each kernel's
   registers, shared memory and spills (ptxas -v) and the HGMMA (wgmma)
   instructions of the bf16 prefill kernel, which must not be 0;
2. kernels: holds each kernel against its plain PyTorch version on the
   card — for the paged kernels shuffled block tables, ragged rows, a
   row parked past the pool's virtual capacity, the chunk's own K/V
   written first, D in {64, 128, 256}, a sliding window that is not a
   multiple of the block size and a softcap on scores that reach it;
   the split decode over a 72-block row beside a 1-block row, the wgmma
   prefill at G = 2, 4, 8 with T off its 64-row tile, G = 1 (MHA, D 128
   and 256) and G = 7 (63 live rows of the tile), Mistral's window of
   4096; every paged case once more over an int8 pool with its scales;
   rolled tables (the entries behind each row's window at trash block 0,
   filled with 1e4) against the intact ones; for the flash kernel T
   and S that are not multiples of its tiles — and times kernel (a whole
   wrapper call: the decode's split and merge launches), plain version
   and one PyTorch library call at the shapes the serving phases give
   them (Gemma-2's at both layer kinds, sliding and global; the paged
   kernels over a bf16 and over an int8 pool; the speculative verify
   windows, the decode kernel at T = 4 and the prefill kernel at
   T = 9; Qwen1.5-MoE's G = 1, Mistral's window on every layer, and
   Qwen2-7B's G = 7, which no path serves), holding each kernel against
   its plain version on the timed inputs too; Gemma-2's bf16 rows, which
   SDPA cannot compute (no softcap), take flex_attention with a tanh
   softcap and a window mask as their library call;
3. checkpoint: an HF checkpoint directory of Llama-3-8B's widths at 2
   layers (config.json, two .safetensors shards of the seed-0 draw)
   loads through the port's reader (bytes, seconds, GB/s), and an
   engine started on it serves and matches, bit for bit, an engine
   given the same weights in memory; the directory is deleted;
4. then for each served path — llama-3-8b, gemma-2-9b, llama-3-8b
   with int8 weights and an int8 KV pool (llama-3-8b-int8),
   qwen1.5-moe-a2.7b (60 experts, top-4, a shared expert, q/k/v biases)
   and mistral-7b-v0.1 (a 4096 window on every layer, rolling KV) — at
   full width and depth with random weights from a seed, one after the
   other (each engine is freed before the next is built):
   - serve: starts the port's OpenAI server in-process, sends completion
     and chat requests (some concurrent, one streamed, one prompt long
     enough for several prefill chunks — past Gemma-2's 4096-token
     window), checks status, token counts and greedy repeatability, and
     that both paged kernels were launched (on Gemma-2 with the window
     and the softcap on, on the int8 path with the int8 pool) and the
     flash kernel, which serves no path as in the JAX package, was not;
     on Mistral every launch carries the window, on Qwen1.5-MoE the
     prefill chunks took the MoE's capacity dispatch and decode its
     exact path;
   - roll (mistral-7b-v0.1): a 4,600-token prompt through the engine;
     at the first decode window 7 blocks behind the window are freed
     and the pool's free blocks rise by 7;
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
     before shaping existed; on Qwen1.5-MoE the MoE block's share of the
     step and of the chunk (its device time per layer, times the
     layers);
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
   - reference: the served model's logits through the kernels agree
     with a float32 forward through the plain attention (on the int8
     path over the same int8 weights and an int8 pool; the f32 weights
     upcast a layer at a time, so Qwen1.5-MoE's fit beside its bf16
     ones); on Qwen1.5-MoE the first layer's expert ids of the bf16
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
5. kvtier: KV tiering and disaggregated prefill at Llama-3-8B's full
   width and depth (KVTIER; one weight set shared by five engines):
   the port's cache server as a subprocess; a producer with a host and
   the remote tier serves a 3,000-token and a 2,048-token prompt through
   its HTTP server with max_tokens = 1 (the router's prefill stage);
   a consumer on the remote tier serves each with 24 greedy tokens
   from hits of 2,816 and 2,047 tokens (its injected blocks, re-extracted,
   equal the producer's chunk bytes bit for bit; the suffix through the
   prefill kernel, the 1-token suffix at its 16-token bucket, decode
   over the injected blocks), its tokens against a recompute engine's
   (equal, or parting at a near-tie); an int8-pool consumer takes the
   same bf16 chunks; migrate_out of a decoding sequence on the producer
   and warm of its keys on the consumer, the victim re-admitted by
   injection; then extract_chunk / inject_chunk per chunk (bf16 and
   int8 pools), pinned D2H / H2D, each tier's put and get rates and
   each codec's times and ratio on one chunk, and TTFT with the hit
   and without it.

Progress goes to stdout; the line before the last two is the kernels'
JSON record, then the card's name and power limit, then the result.
Any failed phase raises: the exit code is not 0 and no result line is
printed. Needs CUDA and this repository's sources beside the script.
"""

import asyncio
import gc
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
    return PATHS[path].get("model", path)


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
# must launch exactly these
PLAIN_DECODE_LAUNCHES = {"llama-3-8b": 1836.5}
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
    eng._inflight = None
    eng._lora_rows = []
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
    also reads its q and the K/V blocks and table entries it attends
    (blocks from its first query's window start to its last query's
    block, within nb) — an int8 pool (kv_itemsize 1) also a 4-byte K and
    V scale per attended (key, head) — and does 4*D flops per (query
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
        jmin = max(s - (window - 1), 0) // Bs if window else 0
        blocks = max(jend - jmin + 1, 0)
        byts += row_q + 2 * blocks * Hkv * Bs * kv_row + 4 * blocks
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


def paged_timings(pa, model, kv, path, verify=False):
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
    launches come from the speculative serving run (spec_phase)."""
    import torch
    from production_stack_tpu_torch.models.config import get_config
    from production_stack_tpu_torch.models.llama import attn_scale
    cfg, p = get_config(model), PATHS.get(model) or KERNEL_ONLY[model]
    B, Bs = p["serve"]["max_num_seqs"], p["serve"]["kv_block_size"]
    Hkv, G, D = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, \
        cfg.head_dim_
    L = p["timing_layers"]
    # Gemma-2's two layer kinds; a window on every layer (Mistral) is
    # one kind, windowed
    kinds = ([("sliding", cfg.sliding_window), ("global", 0)]
             if cfg.alternating_sliding
             else [("all", cfg.sliding_window or 0)])
    shapes = {
        "paged_decode_attention": (1, p["decode_starts"], 0, 64, 101),
        "paged_attention": (512, [p["chunk_start"]] * B, B - 1, 8, 102),
    }
    if verify:
        shapes = {"paged_decode_attention": (4, p["decode_starts"], 0, 64,
                                             104)}
        if 8 in SPEC.get(model, ()):
            shapes["paged_attention"] = (9, p["decode_starts"], 0, 64, 105)
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
        for layers, window in kinds:
            kw = dict(scale=attn_scale(cfg), window=window,
                      softcap=cfg.attn_logit_softcap or 0.0)
            got = fn(q, k[0], v[0], tables, starts, nb=nb, **kw, **sc[0])
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
            ms = device_ms(lambda i=0: fn(q, k[i % L], v[i % L], tables,
                                          starts, nb=nb, **kw, **sc[i % L]),
                           it)
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
            if verify:
                rec["verify_T"] = T
            # the yardstick where library_ms is null: SDPA without the
            # softcap, over the bf16 pool or the dequantized bf16 view
            rec["sdpa_ms"] = sdpa_ms
            log(json.dumps({"timing": rec}))
            records.append(rec)
        del q, k, v, sc
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
    free_memory()
    records = []
    for model in ("llama-3-8b", "gemma-2-9b", "qwen1.5-moe-a2.7b",
                  "mistral-7b-v0.1"):
        records += paged_timings(pa, model, "bfloat16", model)
    # Qwen2-7B's G = 7, which no path serves (no launches)
    records += paged_timings(pa, "qwen2-7b", "bfloat16", None)
    # the int8 branches at both models' shapes; only Llama-3-8B is served
    # with an int8 pool, so the Gemma-2 rows name no path (no launches)
    records += paged_timings(pa, "llama-3-8b", "int8", "llama-3-8b-int8")
    records += paged_timings(pa, "gemma-2-9b", "int8", None)
    # the speculative verify windows the spec phase serves
    for model in SPEC:
        records += paged_timings(pa, model, "bfloat16", model, verify=True)
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
    runner = web.AppRunner(build_app(engine))
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
                      "int8_launches": dict(pa.int8_launches)}
            surface = await surface_phase(http, base, engine, path)
            # last: a wrong index rule is a device-side assert that ends
            # the process
            await fault_probe(http, base, engine, path)
    finally:
        await runner.cleanup()
        moe._moe_exact, moe._moe_dispatch = (originals["exact"],
                                             originals["dispatch"])

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
        # /load and /metrics with a request in flight
        async with http.post(base + "/v1/completions", json={
                "model": model, "prompt": "hold", "max_tokens": 400,
                "ignore_eos": True, "stream": True}) as hold:
            assert hold.status == 200
            await hold.content.readany()
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
    runner = web.AppRunner(build_app(engine))
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
        runner = web.AppRunner(build_app(spec_engine))
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
      int8 values that differ from the reference's pool are logged;
    - the served bf16 path through the kernels may be at most
      BF16_FLOOR_FACTOR times further from it than the bf16 path through
      the plain attention is (bf16 rounding through every layer is the
      floor both share).

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

    routed = {}

    @contextmanager
    def first_routing(key):
        """routed[key] = (hidden, router) of the first MoE call inside:
        layer 0 of the first prefill chunk."""
        call = moe.moe_mlp

        def capture(x, router_w, *a, **kw):
            routed.setdefault(key, (x.float(), router_w.float()))
            return call(x, router_w, *a, **kw)
        moe.moe_mlp = capture
        try:
            yield
        finally:
            moe.moe_mlp = call

    def run(params, mcfg, mode, lora=None):
        """Logits at the compared positions, the verify segments' logits
        {T: [T, V]} as one forward and (not in "plain") as T
        single-token forwards over the same positions, and the pool's
        int8 K/V (None over a float pool); mode "plain", "kernels" or
        "checked"; lora: an adapter id whose factors join every
        forward. On a MoE model the first layer's routing input of the
        run is kept in routed[(dtype, mode)]."""
        cache, tables = pool(mcfg, max_len)
        out, ver, single = [], {}, {}
        ad = adapter(lora, mcfg.dtype)
        with attention(mode), first_routing((str(mcfg.dtype), mode)):
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
    got32, ver32, _, pool32 = run(p32, cfg32,
                                  "checked" if int8 else "kernels")
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
    got16, ver16, single16, _ = run(runner.params, cfg, "kernels")
    plain16, pver16, _, _ = run(runner.params, cfg, "plain")
    err16 = (got16 - ref).abs().max().item()
    floor16 = (plain16 - ref).abs().max().item()
    scale = ref.abs().max().item()
    extra = {}
    if int8:
        # the pools [2, L, N, Hkv, Bs, D] outside trash block 0
        step = (pool32[:, :, 1:].int() - ref_pool[:, :, 1:].int()).abs()
        extra = {"f32_kernel_calls": len(call_errs),
                 "f32_call_err_max": max(e for e, _ in call_errs),
                 "f32_call_tol_min": min(t for _, t in call_errs),
                 "int8_values_differing": int((step != 0).sum().item()),
                 "int8_values_in_pool": step.numel(),
                 "int8_max_step": int(step.max().item())}
        f32_ok = bool(call_errs) and all(e <= t for e, t in call_errs)
    else:
        f32_ok = err32 <= F32_LOGIT_TOL * scale
    ok = (bool(torch.isfinite(ref).all()) and f32_ok
          and err16 <= BF16_FLOOR_FACTOR * floor16)
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
            routed[(str(torch.float32), "plain")],
            routed[(str(cfg.dtype), "kernels")], cfg.num_experts_per_tok)
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
        w = getattr(self._model, name)
        if is_quantized(w):
            return w
        return _UpcastLayers(w) if name in LAYER_KEYS else w.float()


class _UpcastLayers:
    def __init__(self, stacked):
        self._stacked = stacked

    def __getitem__(self, layer):
        return self._stacked[layer].float()


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


def device_profile(fn):
    """One call of fn (ending in a host sync) under torch.profiler: its
    host span, the device's busy time within it (the union of kernel,
    copy and set intervals), and the device time and count of each
    kernel name. None where the profiler recorded no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    label = "chip_smoke.span"
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            fn()
            torch.cuda.synchronize()
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

    runner = engine.engine.runner
    dev = next(runner.params.parameters()).device
    p = PATHS[path]
    serve, kv_len = p["serve"], p["kv_len"]
    B, W, S = serve["max_num_seqs"], serve["decode_window"], \
        serve["max_model_len"]
    MB = S // serve["kv_block_size"]
    runner.set_block_tables(
        (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB))
    sp = SamplingParams.filled(B, temperature=0.0, device=dev)
    starts = np.array(p["decode_starts"], np.int32)

    def window(i=0):
        runner.set_decode_state(np.zeros((B,), np.int32), starts)
        return runner.decode(sp, steps=W, kv_len=kv_len, greedy=True)

    def chunk(i=0):
        return runner.prefill(
            np.zeros((B, 512), np.int32),
            np.array([p["chunk_start"]] + [S] * (B - 1), np.int32),
            np.array([512] + [1] * (B - 1), np.int32), sp, kv_len,
            greedy=True)

    step_ms = time_ms(window, 3) / W
    chunk_ms = time_ms(chunk, 3)
    out = {"path": path, "decode_step_ms": step_ms,
           "prefill_chunk_ms": chunk_ms, "batch": B, "kv_len": kv_len,
           "decode_starts": p["decode_starts"],
           "chunk_start": p["chunk_start"],
           "decode_profile_per_step": profile_summary(
               device_profile(window), W, step_ms),
           "prefill_profile_per_chunk": profile_summary(
               device_profile(chunk), 1, chunk_ms)}
    if runner.model_cfg.num_experts:
        out.update(moe_breakdown(runner, p, out))
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
            return llama._moe_block(cfg, runner.params, i % L, hidden,
                                    valid)
        ms = device_ms(block, 2 * L)
        busy = plain[key].get("device_busy_ms")
        out[f"moe_{name}_layer_ms"] = ms
        out[f"moe_{name}_ms"] = ms * L
        out[f"moe_share_of_{name}_busy"] = ms * L / busy if busy else None
        out[f"moe_share_of_{name}_event_ms"] = ms * L / plain[ms_key]
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

    import numpy as np
    import torch
    from production_stack_tpu_torch.engine.sampler import SamplingParams
    eng = engine.engine
    runner = eng.runner
    p = PATHS[path]
    serve, kv_len = p["serve"], p["kv_len"]
    B, W, S = serve["max_num_seqs"], serve["decode_window"], \
        serve["max_model_len"]
    MB = S // serve["kv_block_size"]
    runner.set_block_tables(
        (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB))
    dev = runner.device
    ids = [eng.lora_ids["ad-npz"], 0, eng.lora_ids["ad-three"], 0]
    sp = dataclasses.replace(
        SamplingParams.filled(B, temperature=0.0, device=dev),
        adapter=torch.tensor(ids, dtype=torch.int32, device=dev))
    starts = np.array(p["decode_starts"], np.int32)
    t0 = time.monotonic()

    def window(i=0):
        runner.set_decode_state(np.zeros((B,), np.int32), starts)
        return runner.decode(sp, steps=W, kv_len=kv_len, greedy=True)

    step_ms = time_ms(window, 3) / W
    prof = profile_summary(device_profile(window), W, step_ms)
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
    windowed. Returns the prompt and the served tokens for
    reference_phase, which holds them against the f32 teacher-forced
    argmax (near_tie_check)."""
    import random
    from production_stack_tpu_torch.engine.scheduler import SamplingOptions
    from production_stack_tpu_torch.ops import paged_attention as pa
    eng = engine.engine
    cfg = eng.model_cfg
    P, W = PATHS[path]["long_tokens"], cfg.sliding_window
    Bs = eng.cfg.kv_block_size
    rnd = random.Random(13)
    prompt = [rnd.randrange(cfg.vocab_size) for _ in range(P)]
    rolls = []
    roll = eng._roll_windows

    def observed(decode_seqs):
        before = eng.block_mgr.available
        roll(decode_seqs)
        rolls.append({"free_before": before,
                      "free_after": eng.block_mgr.available,
                      "rolled": [s.rolled_blocks for s in decode_seqs]})
    eng._roll_windows = observed
    pa.reset_launch_counts()
    t0 = time.monotonic()
    try:
        sid = eng.add_request(prompt, SamplingOptions(
            temperature=0.0, max_tokens=ROLL_TOKENS, ignore_eos=True))
        while eng.has_work:
            eng.step()
    finally:
        del eng._roll_windows
    seq = eng.seqs[sid]
    want = (P - W + 1) // Bs
    first = rolls[0] if rolls else {}
    out = {"path": path, "prompt_tokens": P, "window": W,
           "block_size": Bs, "tokens": len(seq.output_tokens),
           "first_window": first, "rolls": len(rolls),
           "rolled_blocks_at_finish": seq.rolled_blocks,
           "want_first_rolled": want,
           "launches": dict(pa.launch_counts),
           "window_launches": dict(pa.window_launches),
           "seconds": time.monotonic() - t0}
    out["ok"] = (bool(first) and first["rolled"] == [want]
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


def model_phase(path: str):
    """Serve one path's model at full width and depth, then its breakdown
    and its reference; returns the kernels' launch counts of the serving
    run (serve_phase). The engine is freed before returning."""
    import torch
    from production_stack_tpu_torch.engine.async_engine import \
        AsyncLLMEngine
    from production_stack_tpu_torch.engine.config import EngineConfig
    t0 = time.monotonic()
    engine = AsyncLLMEngine(EngineConfig(model=path_model(path),
                                         device="cuda",
                                         **PATHS[path]["serve"]))
    engine.engine.runner.warmup()
    runner = engine.engine.runner
    cfg = engine.engine.model_cfg
    pool = runner.cache
    log(json.dumps({"engine_ready_s": time.monotonic() - t0,
                    "path": path, "model": cfg.name,
                    "layers": cfg.num_layers, "hidden": cfg.hidden_size,
                    "params": cfg.num_params,
                    "quantization": engine.engine.cfg.quantization,
                    "kv_dtype": engine.engine.cfg.kv_dtype,
                    "weight_bytes": sum(
                        t.nbytes for t in (*runner.params.parameters(),
                                           *runner.params.buffers())),
                    "pool_bytes": sum(t.nbytes for t in (
                        pool.k, pool.v, pool.ks, pool.vs) if t is not None),
                    "mem_gib": torch.cuda.memory_allocated() / 2**30}))
    t0 = time.monotonic()
    counts, surface = asyncio.run(serve_phase(engine, path))
    if cfg.sliding_window and not cfg.alternating_sliding:
        surface["roll"] = roll_phase(engine, path)
    plain = breakdown_phase(engine, path)
    surface.update(asyncio.run(feature_phase(engine, path)))
    if path in PLAIN_DECODE_LAUNCHES:
        lora_breakdown(engine, path, plain)
    # the speculative serving runs' launches by window length T
    counts["verify"] = surface["spec"].get("verify", {})
    counts["verify_window"] = surface["spec"].get("verify_window", {})
    # serving is over: the pool goes before the float32 copy arrives
    engine.engine.runner.cache = None
    del runner, pool
    free_memory()
    reference_phase(engine, path, surface)
    release(engine)
    log(json.dumps({"model_phase_s": time.monotonic() - t0,
                    "path": path}))
    return counts


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
    projections), on the CPU, as two shards: the embedding and layer 0,
    then the rest."""
    from production_stack_tpu_torch.models.hf_loader import _LAYER_MAP
    first, second = {}, {}
    first["model.embed_tokens.weight"] = model.embed.detach().cpu()
    for ours, (suffix, transpose) in _LAYER_MAP.items():
        for i in range(cfg.num_layers):
            w = getattr(model, ours)[i].detach()
            (first if i == 0 else second)[f"model.layers.{i}.{suffix}"] = (
                w.t() if transpose else w).contiguous().cpu()
    second["model.norm.weight"] = model.final_norm.detach().cpu()
    second["lm_head.weight"] = model.lm_head.detach().t().contiguous().cpu()
    return [first, second]


def checkpoint_phase(device="cuda"):
    """HF checkpoint loading on the card: a directory with a config.json
    of Llama-3-8B's widths at 2 layers and the seed-0 draw's bf16
    weights in two .safetensors shards (the port's writer), loaded by
    the port's reader (hf_loader.load_checkpoint: bytes, seconds,
    GB/s); an engine started with model = checkpoint = the directory
    serves two greedy requests, and its weights and its logits on one
    prompt (through the kernels) are bit for bit those of an engine
    given the drawn weights in memory, as are both requests' tokens.
    Both engines are freed and the directory deleted before returning."""
    import shutil

    import torch
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import LLMEngine
    from production_stack_tpu_torch.engine.scheduler import SamplingOptions
    from production_stack_tpu_torch.models import hf_loader, llama
    from production_stack_tpu_torch.models.config import get_config
    from production_stack_tpu_torch.models.kv import make_slot_cache
    t_phase = time.monotonic()
    shutil.rmtree(CHECKPOINT_DIR, ignore_errors=True)
    os.makedirs(CHECKPOINT_DIR)
    with open(os.path.join(CHECKPOINT_DIR, "config.json"), "w") as f:
        json.dump(CHECKPOINT_CONFIG, f)
    cfg = get_config(CHECKPOINT_DIR)
    drawn = llama.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    t0 = time.monotonic()
    nbytes = 0
    for i, shard in enumerate(hf_shards(drawn, cfg)):
        path = os.path.join(CHECKPOINT_DIR,
                            f"model-{i + 1:05d}-of-00002.safetensors")
        hf_loader.save_safetensors(shard, path)
        nbytes += os.path.getsize(path)
        del shard
    write_s = time.monotonic() - t0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    loaded = hf_loader.load_checkpoint(cfg, CHECKPOINT_DIR, device=device)
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    same = all(torch.equal(p, getattr(drawn, n))
               for n, p in loaded.named_parameters())
    del loaded
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
           "tokens": tokens, "tokens_equal_in_memory": tokens == tokens_mem,
           "logits_bitwise_equal": bitwise,
           "seconds": time.monotonic() - t_phase}
    log(json.dumps({"checkpoint": out}))
    if not (same and bitwise and tokens == tokens_mem
            and all(len(t) == 8 for t in tokens)):
        raise AssertionError(f"the checkpoint engine differs from the "
                             f"in-memory one: {out}")


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
    first token; the sequence)."""
    from production_stack_tpu_torch.engine.scheduler import SamplingOptions
    t0 = time.monotonic()
    sid = eng.add_request(list(prompt), SamplingOptions(
        temperature=0.0, max_tokens=max_tokens, ignore_eos=True))
    ttft = None
    while eng.has_work:
        outs = eng.step()
        if ttft is None and any(o.seq_id == sid and o.new_token is not None
                                for o in outs):
            ttft = time.monotonic() - t0
    seq = eng.seqs[sid]
    return list(seq.output_tokens), ttft, seq


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
            runner = web.AppRunner(build_app(prod))
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
                (toks, ttft, seq), counts = _counted(
                    lambda: _serve_direct(cons.engine, p, G))
                # this serve's TTFT holds the check's copies
                results[name] = dict(
                    hit=cconn.hit_tokens - h0, want_hit=hit,
                    want_chunks=len(p) // C, checked_ttft_s=ttft,
                    prefetch_wait_s=seq.kv_prefetch_wait_s,
                    cached_tokens=seq.kv_cached_tokens,
                    injected=dict(checked), tokens=toks, **counts)
                checked.clear()
        finally:
            cconn.inject = inject
        # the long prompt again, unchecked: the hit path's TTFT
        _, ttft_hit, seq = _serve_direct(cons.engine, long_p, G)
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
        (want_long, ttft_rec, _), _ = _counted(
            lambda: _serve_direct(rec.engine, long_p, G))
        want_whole, _, _ = _serve_direct(rec.engine, whole_p, G)
        results["long"]["recompute_ttft_s"] = ttft_rec
        results["long"]["vs_recompute"] = _tokens_check(
            results["long"]["tokens"], rec.engine, long_p, want_long)
        results["whole"]["vs_recompute"] = _tokens_check(
            results["whole"]["tokens"], rec.engine, whole_p, want_whole)

        # the mixed-pool handoff: bf16 chunks into an int8 pool
        h0 = cons8.engine.connector.hit_tokens
        (toks8, ttft8, seq8), counts8 = _counted(
            lambda: _serve_direct(cons8.engine, long_p, G))
        want8, ttft8_rec, _ = _serve_direct(rec8.engine, long_p, G)
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


def build_phase(kernels) -> dict:
    """Build every source (in parallel) and report, per kernel, what
    ptxas gave it: registers, static shared memory, spill bytes; the
    HGMMA (wgmma) instructions of the bfloat16 prefill kernel (over a
    bf16 and over an int8 pool), and the HGMMA and UTMALDG (TMA load)
    instructions of each bfloat16 flash kernel in the built library, none
    of which may be 0; `int8` lists the instantiations over an int8 pool
    (paged decode and both prefill kernels, at D 64/128/256) with their
    registers, spills and the bf16 prefill's HGMMA count."""
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

    counts = {path: model_phase(path) for path in PATHS}

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
            windowed = c["window_launches"][name]
            rec["launches"] = {"all": c[key][name],
                               "sliding": windowed,
                               "global": c[key][name] - windowed,
                               }[rec["layers"]]
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
