#!/usr/bin/env python3
"""Drive the PyTorch port (production_stack_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. build: compiles the CUDA kernels from csrc/ with nvcc (sm_90a);
2. kernels: holds each kernel against its plain PyTorch version on the
   card — shuffled block tables, ragged rows, a row parked past the
   pool's virtual capacity, the chunk's own K/V written first — and
   times kernel, plain version and one PyTorch library call at the
   shapes the serving phase gives them;
3. serve: starts the port's OpenAI server in-process on llama-3-8b at
   full width and depth (random weights from a seed), sends completion
   and chat requests (some concurrent, one streamed, one prompt long
   enough for two prefill chunks), checks status, token counts and
   greedy repeatability, and that both kernels were launched;
4. breakdown: device time of a decode step and of a prefill chunk of
   the served model, and from a torch.profiler trace of each the
   device's idle share and each kernel class's share;
5. reference: the served model's logits through the kernels agree with
   a float32 forward through the plain attention on a small input.

Progress goes to stdout; the line before the last two is the kernels'
JSON record, then the card's name and power limit, then the result.
Any failed phase raises: the exit code is not 0 and no result line is
printed. Needs CUDA and this repository's sources beside the script.
"""

import asyncio
import json
import math
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# the serving phase's geometry; the kernel timings use the same shapes
MODEL = "llama-3-8b"
SERVE = dict(max_num_seqs=4, max_model_len=1024, prefill_chunk=512,
             decode_window=8, kv_block_size=64, seed=0)
# kernel-phase tolerances, max |kernel - plain|:
# - float32: 2e-5, the bound the Pallas kernels are held to against the
#   plain path (tests/test_pallas_paged.py): the online softmax sums in
#   another order;
# - bfloat16: 3e-2 — outputs are bf16 (a rounding is 2^-8 relative on
#   values up to ~4) and the plain version, like the JAX one, rounds the
#   probabilities to bf16 before the value product where the kernel
#   keeps them f32.
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# the served model against its float32 plain-attention forward:
# - float32 through the kernels: 1e-3 of the largest logit (the 2e-5
#   per-attention difference of the summation order, through 32 layers);
# - bf16 through the kernels: at most 2x the distance of the bf16 plain
#   path from the same reference
F32_LOGIT_TOL = 1e-3
BF16_FLOOR_FACTOR = 2.0
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense bf16 FLOP/s
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12


def log(*args):
    print(*args, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters calls (CUDA events)."""
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


def work(q, starts, nb, MB, Bs, Hkv, D, itemsize):
    """(bytes, flops) the call needs on this data. Every row: starts
    once and its output written once. A live row (start < MB*Bs) also
    reads its q and the K/V blocks and table entries it attends (blocks
    up to its last query's, within nb), and does 4*D flops per (query
    head, attended key) for QK and PV. A parked row needs nothing more:
    its output is zeros the engine discards."""
    B, T, H, _ = q.shape
    row_q = T * H * D * itemsize
    byts = B * (row_q + 4)
    flops = 0
    for s in starts.tolist():
        if s >= MB * Bs:
            continue
        blocks = min((s + T - 1) // Bs, nb - 1) + 1
        byts += row_q + 2 * blocks * Hkv * Bs * D * itemsize + 4 * blocks
        for t in range(T):
            keys = min(s + t + 1, blocks * Bs)
            flops += 4 * D * H * keys
    return byts, flops


def sdpa_over_view(q, k, v, tables, starts, nb):
    """The library yardstick: SDPA (GQA, boolean causal mask) over the
    gathered view — the paged gather itself is not timed."""
    import torch
    import torch.nn.functional as F
    from production_stack_tpu_torch.models.kv import gather_view
    B, T, H, D = q.shape
    kv_k = gather_view(k, tables, nb).transpose(1, 2)   # [B, Hkv, S, D]
    kv_v = gather_view(v, tables, nb).transpose(1, 2)
    S = kv_k.shape[2]
    qpos = starts.long()[:, None] + torch.arange(T, device=q.device)
    mask = (torch.arange(S, device=q.device)[None, None, :]
            <= qpos[:, :, None])[:, None]               # [B, 1, T, S]
    qt = q.transpose(1, 2)

    def call(i=0):
        return F.scaled_dot_product_attention(qt, kv_k, kv_v,
                                              attn_mask=mask,
                                              enable_gqa=True)
    return call


def kernel_phase(gpu: str):
    import torch
    from production_stack_tpu_torch.ops import paged_attention as pa
    checks = {"paged_decode_attention": [], "paged_attention": []}
    fns = {"paged_decode_attention": pa.paged_decode_attention,
           "paged_attention": pa.paged_attention}
    cases = []
    for dt in ("float32", "bfloat16"):
        for T in (1, 5, 8):
            cases.append(("paged_decode_attention", T, 8, 4, 128, dt))
        cases.append(("paged_decode_attention", 8, 2, 8, 64, dt))
        for T in (9, 512):
            cases.append(("paged_attention", T, 8, 4, 128, dt))
        cases.append(("paged_attention", 40, 2, 8, 64, dt))
    for i, (name, T, Hkv, G, D, dt) in enumerate(cases):
        dtype = getattr(torch, dt)
        q, k, v, tables, starts, nb = paged_case(
            4, T, Hkv, G, D, 64, [70, 5, 300, 0], dtype, parked=1, seed=i)
        got = fns[name](q, k[0], v[0], tables, starts, nb=nb)
        torch.cuda.synchronize()
        want = pa.paged_attention_plain(q, k[0], v[0], tables, starts, nb,
                                        D ** -0.5)
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= TOL[dt]
        log(json.dumps({"check": name, "T": T, "Hkv": Hkv, "G": G, "D": D,
                        "dtype": dt, "parked_rows": 1, "max_abs_err": err,
                        "tol": TOL[dt], "ok": ok}))
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"(T={T}, D={D}, {dt}): {err} > "
                                 f"{TOL[dt]}")
        checks[name].append(err)

    # timings at the serving phase's shapes: a decode step of the whole
    # batch (T=1) and a 512-token prefill chunk with the other rows
    # parked, kv bucket 512 (nb = 8), over 32 layers' pools so the L2
    # holds no layer from the previous launch
    B, L, Bs = SERVE["max_num_seqs"], 32, SERVE["kv_block_size"]
    timed = {
        "paged_decode_attention": paged_case(
            B, 1, 8, 4, 128, Bs, [200, 431, 57, 400], torch.bfloat16,
            layers=L, seed=101),
        "paged_attention": paged_case(
            B, 512, 8, 4, 128, Bs, [0, 0, 0, 0], torch.bfloat16,
            layers=L, parked=B - 1, seed=102),
    }
    records = []
    for name, (q, k, v, tables, starts, nb) in timed.items():
        nb = 8
        fn = fns[name]
        it = 64 if name == "paged_decode_attention" else 8
        ms = time_ms(lambda i=0: fn(q, k[i % L], v[i % L], tables, starts,
                                    nb=nb), it)
        plain_ms = time_ms(lambda i=0: pa.paged_attention_plain(
            q, k[i % L], v[i % L], tables, starts, nb, 128 ** -0.5), it)
        lib = sdpa_over_view(q, k[0], v[0], tables, starts, nb)
        library_ms = time_ms(lib, it)
        byts, flops = work(q, starts, nb, tables.shape[1], Bs, 8, 128, 2)
        t_bytes, t_ops = byts / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3
        rec = {
            "name": name, "route": "cuda",
            "source": "production_stack_tpu_torch/csrc/paged_attention.cu",
            "replaces": ("production_stack_tpu/ops/pallas_paged.py:325"
                         if name == "paged_decode_attention" else
                         "production_stack_tpu/ops/pallas_paged.py:75"),
            "launches": 0, "max_abs_err": max(checks[name]),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
            "shape": {"B": B, "T": int(q.shape[1]), "H": 32, "Hkv": 8,
                      "D": 128, "Bs": Bs, "nb": nb,
                      "starts": starts.tolist(), "dtype": "bfloat16"},
        }
        log(json.dumps({"timing": rec, "gpu": gpu}))
        records.append(rec)
    del timed
    torch.cuda.empty_cache()
    return records


# ------------------------------------------------------------ serving

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def serve_phase(engine):
    import aiohttp
    from aiohttp import web
    from production_stack_tpu_torch.engine.server import build_app
    from production_stack_tpu_torch.ops import paged_attention as pa

    port = free_port()
    runner = web.AppRunner(build_app(engine))
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", port)
    await site.start()
    base = f"http://127.0.0.1:{port}"
    long_prompt = ("In the beginning the engine read every block of the "
                   "pool once, and the pool was paged. ") * 8
    try:
        async with aiohttp.ClientSession() as http:
            async def post(path, body):
                async with http.post(base + path, json=body) as r:
                    if r.status != 200:
                        raise AssertionError(
                            f"{path} -> {r.status}: {await r.text()}")
                    if body.get("stream"):
                        return [ln[6:] for ln in
                                (await r.text()).splitlines()
                                if ln.startswith("data: ")]
                    return await r.json()

            async with http.get(base + "/health") as r:
                assert r.status == 200, r.status
            greedy = {"model": MODEL, "prompt": long_prompt,
                      "max_tokens": 24, "temperature": 0.0,
                      "ignore_eos": True, "logprobs": 0}
            reqs = [
                ("/v1/completions", greedy),
                ("/v1/chat/completions", {
                    "model": MODEL, "max_tokens": 16, "temperature": 0.8,
                    "seed": 7, "ignore_eos": True, "logprobs": True,
                    "messages": [{"role": "user",
                                  "content": "Name three rivers."}]}),
                ("/v1/chat/completions", {
                    "model": MODEL, "max_tokens": 16, "stream": True,
                    "ignore_eos": True,
                    "stream_options": {"include_usage": True},
                    "messages": [{"role": "user", "content": "Hello!"}]}),
                ("/v1/completions", {
                    "model": MODEL, "prompt": "The capital of France is",
                    "max_tokens": 20, "top_p": 0.9, "top_k": 50,
                    "ignore_eos": True}),
            ]
            pa.reset_launch_counts()
            t0 = time.monotonic()
            results = await asyncio.gather(*(post(p, b) for p, b in reqs))
            again = await post("/v1/completions", greedy)
            wall = time.monotonic() - t0
            counts = dict(pa.launch_counts)
    finally:
        await runner.cleanup()

    want = [24, 16, 16, 20]
    for (path, body), res, n in zip(reqs, results, want):
        if body.get("stream"):
            assert res[-1] == "[DONE]", res[-3:]
            chunks = [json.loads(x) for x in res[:-1]]
            got = chunks[-1]["usage"]["completion_tokens"]
            assert chunks[-2]["choices"][0]["finish_reason"] == "length"
        else:
            got = res["usage"]["completion_tokens"]
            assert res["choices"][0]["finish_reason"] == "length"
        assert got == n, (path, got, n)
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
    assert prompt_tokens > SERVE["prefill_chunk"], prompt_tokens
    for name, c in counts.items():
        if c <= 0:
            raise AssertionError(f"kernel {name} was not launched while "
                                 f"serving: {counts}")
    log(json.dumps({"serve": {"requests": len(reqs) + 1,
                              "wall_s": wall,
                              "long_prompt_tokens": prompt_tokens,
                              "launches": counts}}))
    return counts


def reference_phase(engine):
    """The served model's logits against a float32 reference on the card:
    the same weights upcast (exact), the plain attention, a 40-token
    prefill chunk and 3 decode steps.

    - float32 through the kernels must match the reference to
      F32_LOGIT_TOL of its largest logit;
    - the served bf16 path through the kernels may be at most
      BF16_FLOOR_FACTOR times further from it than the bf16 path through
      the plain attention is (bf16 rounding over 32 layers is the floor
      both share)."""
    import dataclasses

    import torch
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.kv import make_slot_cache
    from production_stack_tpu_torch.ops import paged_attention as pa

    runner = engine.engine.runner
    cfg = runner.model_cfg
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = llama.Llama(cfg32, device="cuda")
    with torch.no_grad():
        for (_, dst), (_, src) in zip(p32.named_parameters(),
                                      runner.params.named_parameters()):
            dst.copy_(src)
    g = torch.Generator(device="cuda").manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (1, 40), generator=g,
                           device="cuda")
    steps = torch.randint(0, cfg.vocab_size, (3,), generator=g,
                          device="cuda")

    def plain(q, k, v, tables, starts, *, nb, scale=None):
        return pa.paged_attention_plain(q, k, v, tables, starts, nb, scale)

    def run(params, mcfg, use_plain):
        cache, tables = make_slot_cache(
            mcfg.num_layers, 1, 128, mcfg.num_kv_heads, mcfg.head_dim_,
            dtype=mcfg.dtype, block_size=64, device="cuda")
        saved = (pa.paged_attention, pa.paged_decode_attention)
        if use_plain:
            pa.paged_attention = pa.paged_decode_attention = plain
        try:
            logits, _ = llama.forward(
                params, mcfg, prompt, torch.arange(40, device="cuda")[None],
                cache, block_tables=tables, rope=runner.rope, kv_len=64)
            out = [logits[0, -1]]
            for i, tok in enumerate(steps):
                logits, _ = llama.forward(
                    params, mcfg, tok.view(1, 1),
                    torch.tensor([[40 + i]], device="cuda"), cache,
                    block_tables=tables, rope=runner.rope, kv_len=64)
                out.append(logits[0, 0])
        finally:
            pa.paged_attention, pa.paged_decode_attention = saved
        return torch.stack(out)

    ref = run(p32, cfg32, True)
    err32 = (run(p32, cfg32, False) - ref).abs().max().item()
    del p32
    torch.cuda.empty_cache()
    err16 = (run(runner.params, cfg, False) - ref).abs().max().item()
    floor16 = (run(runner.params, cfg, True) - ref).abs().max().item()
    scale = ref.abs().max().item()
    ok = (bool(torch.isfinite(ref).all()) and err32 <= F32_LOGIT_TOL * scale
          and err16 <= BF16_FLOOR_FACTOR * floor16)
    log(json.dumps({"reference": {
        "positions": 4, "max_abs_logit": scale,
        "f32_kernels_err": err32, "f32_tol": F32_LOGIT_TOL * scale,
        "bf16_kernels_err": err16, "bf16_plain_err": floor16,
        "bf16_tol": BF16_FLOOR_FACTOR * floor16, "ok": ok}}))
    if not ok:
        raise AssertionError("served logits disagree with the float32 "
                             "reference beyond the stated bounds")


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
    if "paged_decode_kernel" in name or "paged_prefill_kernel" in name:
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


def breakdown_phase(engine):
    """Device time of one decode step of the whole batch (a window of
    decode_window steps, divided) and of one 512-token prefill chunk
    with the other rows parked, through the served model at the shapes
    the kernel timings used (CUDA events); then one window and one
    chunk under torch.profiler: the device's idle share and each kernel
    class's share of the span, read from the trace."""
    import numpy as np
    import torch
    from production_stack_tpu_torch.engine.sampler import SamplingParams

    runner = engine.engine.runner
    B, W, S = SERVE["max_num_seqs"], SERVE["decode_window"], \
        SERVE["max_model_len"]
    MB = S // SERVE["kv_block_size"]
    runner.set_block_tables(
        (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB))
    sp = SamplingParams.filled(B, temperature=0.0, device="cuda")
    starts = np.array([200, 431, 57, 400], np.int32)

    def window(i=0):
        runner.set_decode_state(np.zeros((B,), np.int32), starts)
        return runner.decode(sp, steps=W, kv_len=512, greedy=True)

    def chunk(i=0):
        return runner.prefill(
            np.zeros((B, 512), np.int32),
            np.array([0] + [S] * (B - 1), np.int32),
            np.array([512] + [1] * (B - 1), np.int32), sp, 512,
            greedy=True)

    step_ms = time_ms(window, 3) / W
    chunk_ms = time_ms(chunk, 3)
    out = {"decode_step_ms": step_ms, "prefill_chunk_ms": chunk_ms,
           "batch": B, "kv_len": 512,
           "decode_profile_per_step": profile_summary(
               device_profile(window), W, step_ms),
           "prefill_profile_per_chunk": profile_summary(
               device_profile(chunk), 1, chunk_ms)}
    log(json.dumps({"breakdown": out}))


# ------------------------------------------------------------ main

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

    t0 = time.monotonic()
    report = kernels.build()
    log(json.dumps({"build": {"seconds": time.monotonic() - t0,
                              "sources": sorted(report) or "cached"}}))

    t0 = time.monotonic()
    records = kernel_phase(gpu)
    log(json.dumps({"kernel_phase_s": time.monotonic() - t0}))

    from production_stack_tpu_torch.engine.async_engine import \
        AsyncLLMEngine
    from production_stack_tpu_torch.engine.config import EngineConfig
    t0 = time.monotonic()
    engine = AsyncLLMEngine(EngineConfig(model=MODEL, device="cuda",
                                         **SERVE))
    engine.engine.runner.warmup()
    log(json.dumps({"engine_ready_s": time.monotonic() - t0,
                    "model": MODEL,
                    "params": engine.engine.model_cfg.num_params,
                    "mem_gib": torch.cuda.memory_allocated() / 2**30}))
    counts = asyncio.run(serve_phase(engine))
    breakdown_phase(engine)
    reference_phase(engine)

    for rec in records:
        rec["launches"] = counts[rec["name"]]
        del rec["shape"]
    log(json.dumps({"kernels": records}))
    log(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
