"""The port's CUDA kernels against their plain PyTorch versions, on the
card. A CUDA kernel has no interpret mode, so these skip where there is
no NVIDIA GPU; on a machine with one:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Tolerances as in chip_smoke.py: float32 2e-5 (softmax summed in another
order); bfloat16 3e-2 (bf16 outputs up to ~4, and the plain version
rounds the probabilities to bf16 before the value product where the
kernel keeps them in float32). Over an int8 pool the kernels are held
against the plain version in float32 (q upcast exactly), whose f32
dequantization is the kernels' and the Pallas int8 branch's.
"""

import pytest
import torch

from production_stack_tpu_torch.models.kv import (quantize_chunk, write_chunk,
                                                  write_chunk_q)
from production_stack_tpu_torch.ops import flash_attention as fa
from production_stack_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(dev, T, G, D, dtype, lens=(70, 5, 300), seed=0, Bs=64):
    g = torch.Generator(device=dev).manual_seed(seed)
    Hkv, B = 2, len(lens) + 1
    MB = -(-(max(lens) + T + 1) // Bs) + 1
    N = B * MB + 2

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    k, v = rnd(N, Hkv, Bs, D), rnd(N, Hkv, Bs, D)
    tables = (torch.randperm(N - 1, generator=g, device=dev)[:B * MB]
              + 1).reshape(B, MB).to(torch.int32)
    # the last row is parked past the virtual capacity MB*Bs
    starts = torch.tensor(list(lens) + [MB * Bs + 1], dtype=torch.int32,
                          device=dev)
    pos = starts[:, None].long() + torch.arange(T, device=dev)
    write_chunk(k, rnd(B, T, Hkv, D), tables, pos)
    write_chunk(v, rnd(B, T, Hkv, D), tables, pos)
    nb = min(-(-(max(lens) + T) // Bs), MB)
    return rnd(B, T, Hkv * G, D), k, v, tables, starts, nb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,T,G,D,Bs,window,softcap", [
    (pa.paged_decode_attention, 1, 4, 128, 64, 0, 0.0),
    (pa.paged_decode_attention, 8, 8, 64, 64, 0, 0.0),
    (pa.paged_attention, 9, 4, 128, 64, 0, 0.0),
    (pa.paged_attention, 130, 8, 64, 64, 0, 0.0),
    # Gemma-2-9B: D = 256 with G = 2
    (pa.paged_decode_attention, 8, 2, 256, 64, 0, 0.0),
    (pa.paged_attention, 100, 2, 256, 64, 0, 0.0),
    # a window of 40 over blocks of 16, rows well past it
    (pa.paged_decode_attention, 5, 4, 128, 16, 40, 0.0),
    (pa.paged_attention, 70, 4, 128, 16, 40, 0.0),
    # a softcap of 50 on raw scores of about +-100 (q x 30)
    (pa.paged_decode_attention, 1, 2, 256, 64, 0, 50.0),
    (pa.paged_attention, 64, 2, 256, 64, 100, 50.0),
])
def test_kernel_matches_plain_version(cuda, fn, T, G, D, Bs, window,
                                      softcap, dtype):
    q, k, v, tables, starts, nb = _case(cuda, T, G, D, dtype, Bs=Bs)
    if softcap:
        # the softmax sits on a few keys: V at half scale keeps the
        # output within the +-4 the bf16 tolerance assumes
        q, v = (q.float() * 30).to(dtype), (v.float() * 0.5).to(dtype)
    name = fn.__name__
    before = pa.launch_counts[name]
    got = fn(q, k, v, tables, starts, nb=nb, window=window,
             softcap=softcap)
    torch.cuda.synchronize()
    assert pa.launch_counts[name] == before + 1
    want = pa.paged_attention_plain(q, k, v, tables, starts, nb, D ** -0.5,
                                    window, softcap)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


# The redesigned kernels' edges: decode splits the KV axis (many splits
# when a row of 72 blocks and one of 1 block share a batch; T = 8 with a
# split boundary inside the window; Gemma-2's window of 4096 at Bs = 64);
# bf16 prefill runs 64-row wgmma tiles (G in {2, 4, 8}, T not a multiple
# of the tile), f32 prefill the f32 tile.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,T,G,D,Bs,lens,window,softcap", [
    (pa.paged_decode_attention, 1, 2, 256, 64, (4600, 10, 2000), 0, 0.0),
    (pa.paged_decode_attention, 8, 4, 128, 16, (517, 300, 45), 100, 0.0),
    (pa.paged_decode_attention, 1, 2, 256, 64, (4600, 1000, 57), 4096,
     50.0),
    (pa.paged_attention, 96, 2, 256, 64, (4550, 4100, 300), 4096, 50.0),
    (pa.paged_attention, 100, 2, 256, 64, (70, 5, 300), 0, 0.0),
    (pa.paged_attention, 70, 4, 128, 64, (70, 5, 300), 0, 0.0),
    (pa.paged_attention, 37, 8, 64, 64, (70, 5, 300), 0, 0.0),
    (pa.paged_attention, 70, 4, 128, 16, (517, 300, 45), 40, 0.0),
])
def test_redesigned_kernels_match_plain_version(cuda, fn, T, G, D, Bs, lens,
                                                window, softcap, dtype):
    q, k, v, tables, starts, nb = _case(cuda, T, G, D, dtype, lens=lens,
                                        Bs=Bs)
    if softcap:
        q, v = (q.float() * 30).to(dtype), (v.float() * 0.5).to(dtype)
    name = fn.__name__
    before = pa.launch_counts[name]
    got = fn(q, k, v, tables, starts, nb=nb, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert pa.launch_counts[name] == before + 1
    want = pa.paged_attention_plain(q, k, v, tables, starts, nb, D ** -0.5,
                                    window, softcap)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (got[-1] == 0).all()   # the parked row


# bfloat16 runs the wgmma kernel on 128-row tiles, float32 the f32 tile
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,S,G,D,starts", [
    # G in {1, 3, 4, 8} at D = 128 and D in {64, 256} at G = 2, T * G off
    # the 128-row tile, S off the K/V panel; (0, 100, 180) has a row
    # whose positions pass S - 1; 1000 x 4 rows make 192 tiles, more than
    # an H100 has SMs
    (300, 700, 1, 128, (0, 250, 400)),
    (1000, 1100, 4, 128, (0, 50, 100)),
    (50, 200, 3, 128, (0, 100, 163)),
    (37, 200, 4, 128, (0, 100, 180)),
    (37, 200, 8, 128, (0, 100, 163)),
    (37, 200, 2, 64, (0, 100, 180)),
    (300, 700, 2, 256, (0, 250, 400)),
    (37, 200, 2, 256, (0, 100, 180)),
    (1, 130, 4, 128, (129, 64, 0)),
    # S < 64: a single ragged panel
    (20, 40, 4, 128, (0, 10, 30)),
])
def test_flash_kernel_matches_plain_version(cuda, T, S, G, D, starts,
                                            dtype):
    """T and S not multiples of the query tile and the K/V panel."""
    g = torch.Generator(device=cuda).manual_seed(T + S + D)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)
    B, Hkv = len(starts), 2
    q, k, v = rnd(B, T, Hkv * G, D), rnd(B, S, Hkv, D), rnd(B, S, Hkv, D)
    starts = torch.tensor(starts, dtype=torch.int32, device=cuda)
    before = fa.launch_counts["flash_attention_with_cache"]
    got = fa.flash_attention_with_cache(q, k, v, starts)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_attention_with_cache"] == before + 1
    want = fa.flash_attention_plain(q, k, v, starts)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


def _case8(dev, T, G, D, lens, seed, Bs, dtype):
    """_case over an int8 pool: random f32 K/V quantized per (token,
    head) and the chunk's own K/V written by write_chunk_q; q in
    `dtype`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, tables, starts, nb = _case(dev, T, G, D, torch.float32,
                                        lens=lens, seed=seed, Bs=Bs)
    (k8, ks), (v8, vs) = quantize_chunk(k), quantize_chunk(v)
    pos = starts[:, None].long() + torch.arange(T, device=dev)
    for pool, scales in ((k8, ks), (v8, vs)):
        new = torch.randn((len(lens) + 1, T, k.shape[1], D), generator=g,
                          device=dev)
        write_chunk_q(pool, scales, new, tables, pos)
    return q.to(dtype), k8, v8, ks, vs, tables, starts, nb


# the int8 pool's branches of both kernels, q in bf16 and f32: the split
# decode, the wgmma prefill (bf16 q: panels cast to bf16 as they land,
# scales on the accumulators) and the f32 tile (f32 q), with a window,
# a softcap and D = 256 (Bs = 16: panels cross blocks)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,T,G,D,Bs,lens,window,softcap", [
    (pa.paged_decode_attention, 1, 4, 128, 64, (70, 5, 300), 0, 0.0),
    (pa.paged_decode_attention, 8, 8, 64, 16, (517, 300, 45), 0, 0.0),
    (pa.paged_decode_attention, 5, 4, 128, 16, (517, 300, 45), 40, 0.0),
    (pa.paged_decode_attention, 1, 2, 256, 64, (4600, 10, 2000), 0, 0.0),
    (pa.paged_decode_attention, 8, 2, 256, 64, (70, 5, 300), 0, 50.0),
    (pa.paged_attention, 9, 4, 128, 64, (70, 5, 300), 0, 0.0),
    (pa.paged_attention, 100, 2, 256, 64, (70, 5, 300), 0, 0.0),
    (pa.paged_attention, 70, 4, 128, 16, (517, 300, 45), 40, 0.0),
    (pa.paged_attention, 37, 8, 64, 64, (70, 5, 300), 0, 0.0),
    (pa.paged_attention, 64, 2, 256, 64, (70, 5, 300), 100, 50.0),
])
def test_int8_kernel_matches_plain_version(cuda, fn, T, G, D, Bs, lens,
                                           window, softcap, dtype):
    q, k8, v8, ks, vs, tables, starts, nb = _case8(
        cuda, T, G, D, lens, T + D + Bs, Bs, dtype)
    if softcap:
        q, vs = (q.float() * 30).to(dtype), vs * 0.5
    name = fn.__name__
    before = (pa.launch_counts[name], pa.int8_launches[name])
    got = fn(q, k8, v8, tables, starts, nb=nb, window=window,
             softcap=softcap, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert (pa.launch_counts[name], pa.int8_launches[name]) == (
        before[0] + 1, before[1] + 1)
    # the plain version in f32 on the same (exactly upcast) q: the kernels
    # dequantize in f32 as the Pallas int8 branch does, where the plain
    # version at bf16 q rounds the dequantized K/V to bf16 (which at the
    # softcap case's scores of ~+-100 alone moves outputs by ~3e-2)
    want = pa.paged_attention_plain(q.float(), k8, v8, tables, starts, nb,
                                    D ** -0.5, window, softcap, ks, vs)
    assert got.dtype == dtype and torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (got[-1] == 0).all()   # the parked row


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v, tables, starts, nb = _case(cuda, 1, 4, 128, torch.float32)
    scales = torch.ones(k.shape[:3], device=cuda)
    with pytest.raises(ValueError, match="int8"):
        pa.paged_attention(q, k, v, tables, starts, nb=nb,
                           k_scales=scales, v_scales=scales)
    with pytest.raises(ValueError, match="int8"):
        pa.paged_decode_attention(q, k.to(torch.int8), v.to(torch.int8),
                                  tables, starts, nb=nb)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_decode_attention(q[..., :96].contiguous(),
                                  k[..., :96].contiguous(),
                                  v[..., :96].contiguous(), tables, starts,
                                  nb=nb)
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention(q, k, v, tables.long(), starts, nb=nb)
    with pytest.raises(ValueError, match="T <= 8"):
        pa.paged_decode_attention(q.repeat(1, 9, 1, 1), k, v, tables,
                                  starts, nb=nb)


# ------------------------------------------------------------ logit shaping

def _shaping_inputs(dev, B=4, V=512, seed=0):
    """Random logits, counts, prompt membership and shaping params."""
    import dataclasses
    from production_stack_tpu_torch.engine import sampler
    g = torch.Generator().manual_seed(seed)
    sp = sampler.SamplingParams.filled(B, device="cpu")
    bias_ids = torch.full_like(sp.bias_ids, -1)
    bias_ids[:, :6] = torch.randint(0, V, (B, 6), generator=g,
                                    dtype=torch.int32)
    stop_ids = torch.full_like(sp.stop_ids, -1)
    stop_ids[:, :2] = torch.randint(0, V, (B, 2), generator=g,
                                    dtype=torch.int32)
    sp = dataclasses.replace(
        sp, presence=torch.rand(B, generator=g) * 2,
        frequency=torch.rand(B, generator=g) - 0.5,
        repetition=torch.rand(B, generator=g) + 0.5,
        min_tokens=torch.tensor([0, 3, 9, 1], dtype=torch.int32)[:B],
        bias_ids=bias_ids, bias_vals=torch.randn(sp.bias_vals.shape,
                                                 generator=g) * 5,
        stop_ids=stop_ids)
    logits = torch.randn(B, V, generator=g) * 4
    counts = torch.randint(0, 3, (B, V), generator=g, dtype=torch.int32) \
        * (torch.rand(B, V, generator=g) < 0.1)
    seen = torch.rand(B, V, generator=g) < 0.1
    out_len = torch.tensor([0, 2, 5, 1], dtype=torch.int32)[:B]
    move = lambda x: x.to(dev)
    return (move(logits), sampler.SamplingParams(
        **{f.name: move(getattr(sp, f.name))
           for f in dataclasses.fields(sp)}),
        move(counts.to(torch.int32)), move(seen), move(out_len))


def test_adjust_logits_on_the_card_equals_the_cpu(cuda):
    from production_stack_tpu_torch.engine.sampler import adjust_logits
    got = adjust_logits(*_shaping_inputs(cuda), eos_id=257)
    want = adjust_logits(*_shaping_inputs("cpu"), eos_id=257)
    assert (got.cpu() - want).abs().max().item() <= 1e-6


def _tiny_runner(dev, B=4):
    """debug-tiny at head dim 64 (the kernels take 64, 128 and 256) in
    float32, weights from seed 0 made on the CPU, in a runner on
    `dev`."""
    import dataclasses

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.runner import ModelRunner
    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import get_config
    mcfg = dataclasses.replace(get_config("debug-tiny"), head_dim=64,
                               dtype=torch.float32)
    params = llama.init_params(mcfg, torch.Generator().manual_seed(0),
                               device="cpu")
    moved = llama.Llama(mcfg, device=dev)
    moved.load_state_dict(params.state_dict())
    cfg = EngineConfig(model="debug-tiny", dtype="float32",
                       kv_dtype="float32", max_model_len=256,
                       max_num_seqs=B, kv_block_size=16, device=dev)
    return ModelRunner(mcfg, cfg, params=moved)


def _shaped_window(dev, B=4, W=8):
    """The runner of _tiny_runner on `dev`: one 8-token prefill per row,
    then a decode window of W greedy steps with shaping and top-5 on
    every row. Returns (ids, logprobs, top ids, top logprobs, counts) on
    the CPU."""
    import dataclasses

    import numpy as np
    runner = _tiny_runner(dev, B)
    cfg = runner.engine_cfg
    runner.eos_id = 257
    MB = cfg.max_blocks_per_seq
    runner.set_block_tables(
        (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB))
    _, sp, counts, seen, _ = _shaping_inputs(dev, B=B)
    sp = dataclasses.replace(sp, prompt_len=torch.full(
        (B,), 8, dtype=torch.int32, device=dev))
    toks = np.array([[256, 5, 6, 7, 8, 9, 10, 11]] * B, np.int32)
    runner.prefill(toks, np.zeros(B, np.int32), np.full(B, 8, np.int32),
                   sp, 256, greedy=True)
    runner.set_decode_state(np.full(B, 12, np.int32),
                            np.full(B, 8, np.int32))
    runner.set_penalty_state(counts.cpu().numpy(), seen.cpu().numpy())
    ids, lps, tops = runner.decode(sp, steps=W, kv_len=256, greedy=True,
                                   penalized=True, topk=5)
    return [t.cpu() for t in (ids, lps, tops[0], tops[1],
                              runner._dec_counts)]


def test_shaped_decode_window_on_the_card_equals_the_cpu(cuda):
    """The shaped window on the card (the paged kernels) and on the CPU
    (their plain versions): the same ids, top-5 ids and counts, the
    logprobs and alternatives to 1e-4 (float32 attention summed in
    another order, 2e-5 per call)."""
    c, g = _shaped_window("cpu"), _shaped_window(cuda)
    assert torch.equal(c[0], g[0]) and torch.equal(c[2], g[2])
    assert torch.equal(c[4], g[4])
    assert (c[1] - g[1]).abs().max().item() <= 1e-4
    assert (c[3] - g[3]).abs().max().item() <= 1e-4


def test_out_of_vocab_prompt_logprobs_on_the_card_equal_the_cpu(cuda):
    """Prompt logprobs with ids outside the vocabulary (V = 512) on the
    card, through the paged kernels: no device assert, NaN where a
    target lies outside [-V, V) as on the CPU, the rest to 1e-4."""
    import numpy as np
    row = [1, 612, -5, -612, 511, -512, 2 ** 30, 3]
    toks = np.array([row, [256, 7, 8, 9, 10, 11, 12, 13]], np.int32)
    c = _tiny_runner("cpu", 2).prompt_logprobs(toks)
    g = _tiny_runner(cuda, 2).prompt_logprobs(toks).cpu()
    assert torch.equal(c.isnan(), g.isnan())
    assert c.isnan().sum().item() == 3
    assert torch.allclose(c, g, rtol=0, atol=1e-4, equal_nan=True)


def _verify_window(dev, spec, B=4, steps=4):
    """The runner of _tiny_runner on `dev`: one prefill of four prompts
    (two repetitive, one short, one of 250 tokens whose macro-steps run
    into max_model_len 256), then a speculative window of `steps`
    macro-steps of `spec` drafts with the third row declining to
    speculate. Returns (ids, logprobs, counts, history) on the CPU."""
    import numpy as np

    from production_stack_tpu_torch.engine import sampler
    runner = _tiny_runner(dev, B)
    cfg = runner.engine_cfg
    S, MB = cfg.max_model_len, cfg.max_blocks_per_seq
    runner.set_block_tables(
        (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB))
    rng = np.random.default_rng(1)
    base = rng.integers(1, 40, 10).tolist()
    prompts = [base * 4, (base[3:] + base[:3]) * 4,
               rng.integers(0, 512, 24).tolist(), (base * 25)[:250]]
    toks = np.zeros((B, 250), np.int32)
    lens = np.array([len(p) for p in prompts], np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    sp = sampler.SamplingParams.filled(B, temperature=0.0, device=dev)
    first, _, _ = runner.prefill(toks, np.zeros(B, np.int32), lens, sp, S,
                                 greedy=True)
    first = first.cpu().numpy()
    hist = np.zeros((B, S), np.int32)
    for b, p in enumerate(prompts):
        hist[b, :len(p)] = p
        hist[b, len(p)] = first[b]
    runner.set_decode_state(first, lens, history=hist)
    ids, lps, counts, _ = runner.decode_spec(
        sp, steps=steps, kv_len=S, spec=spec,
        spec_ok=np.array([True, True, False, True]), greedy=True)
    return [t.cpu() for t in (ids, lps, counts, runner._dec_hist)]


@pytest.mark.parametrize("spec", [3, 8])
def test_verify_window_on_the_card_equals_the_cpu(cuda, spec):
    """Speculative verify windows through the paged kernels at
    T = spec + 1 (the decode kernel at 4, the prefill kernel at 9),
    a row running past max_model_len among them: the same tokens,
    accepted counts and history as the plain versions on the CPU, the
    logprobs to 1e-4, and the kernel launched at that T."""
    pa.reset_launch_counts()
    g = _verify_window(cuda, spec)
    name = ("paged_decode_attention" if spec + 1 <= pa.DECODE_T_MAX
            else "paged_attention")
    assert pa.verify_launches[name].get(spec + 1, 0) > 0
    c = _verify_window("cpu", spec)
    assert torch.equal(c[0], g[0]) and torch.equal(c[2], g[2])
    assert torch.equal(c[3], g[3])
    assert (c[1] - g[1]).abs().max().item() <= 1e-4
    assert c[2][:2].sum().item() > 2 * c[2].shape[1]   # drafts accepted
    assert (c[2][2] == 1).all()


def _adapter_window(dev, B=4, W=6):
    """The runner of _tiny_runner on `dev` with two adapters on all seven
    targets (drawn on the CPU, rank 4) and rows on adapters [0, 1, 2, 1]:
    one prefill of four prompts, then a greedy decode window of W steps.
    Returns (first ids, window ids, logprobs) on the CPU."""
    import dataclasses

    import numpy as np

    from production_stack_tpu_torch.engine import sampler
    from production_stack_tpu_torch.models import lora
    runner = _tiny_runner(dev, B)
    mcfg, cfg = runner.model_cfg, runner.engine_cfg
    lcfg = lora.LoRAConfig(rank=4, alpha=8.0, targets=(
        "q", "k", "v", "o", "gate", "up", "down"))
    gen = torch.Generator().manual_seed(11)
    ads = [lora.random_adapter(mcfg, lcfg, gen, device="cpu")
           for _ in range(2)]
    stack = lora.stack_adapters(mcfg, lcfg, ads, device="cpu")
    runner.set_lora({n: {k: t.to(dev) for k, t in ab.items()}
                     for n, ab in stack.items()}, lcfg.scaling)
    MB = cfg.max_blocks_per_seq
    runner.set_block_tables(
        (1 + np.arange(B * MB, dtype=np.int32)).reshape(B, MB))
    sp = sampler.SamplingParams.filled(B, temperature=0.0, device=dev)
    sp = dataclasses.replace(sp, adapter=torch.tensor(
        [0, 1, 2, 1], dtype=torch.int32, device=dev))
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (B, 20)).astype(np.int32)
    toks[3] = toks[1]
    first, _, _ = runner.prefill(toks, np.zeros(B, np.int32),
                                 np.full(B, 20, np.int32), sp, 256,
                                 greedy=True)
    runner.set_decode_state(first.cpu().numpy(), np.full(B, 20, np.int32))
    ids, lps, _ = runner.decode(sp, steps=W, kv_len=256, greedy=True)
    return first.cpu(), ids.cpu(), lps.cpu()


def test_mixed_adapter_batch_on_the_card_equals_the_cpu(cuda):
    """A batch mixing the base model and two adapters through the paged
    kernels on the card: the same greedy ids as the plain versions on
    the CPU, logprobs to 1e-4 (float32), both kernels launched; rows 1
    and 3 share prompt and adapter, so their streams are equal, and the
    adapters give streams of their own."""
    pa.reset_launch_counts()
    g = _adapter_window(cuda)
    assert pa.launch_counts["paged_attention"] > 0
    assert pa.launch_counts["paged_decode_attention"] > 0
    c = _adapter_window("cpu")
    assert torch.equal(c[0], g[0]) and torch.equal(c[1], g[1])
    assert (c[2] - g[2]).abs().max().item() <= 1e-4
    assert torch.equal(g[1][1], g[1][3])
    assert not torch.equal(g[1][1], g[1][2])


# ------------------------- MHA, seven groups, rolled tables and the MoE

def _geometry_case(dev, T, Hkv, G, D, dtype, lens, Bs=64, seed=0):
    """_case with Hkv kv heads: B = len(lens) + 1 rows, the last parked."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lens) + 1
    MB = -(-(max(lens) + T + 1) // Bs) + 1
    N = B * MB + 2

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)
    k, v = rnd(N, Hkv, Bs, D), rnd(N, Hkv, Bs, D)
    tables = (torch.randperm(N - 1, generator=g, device=dev)[:B * MB]
              + 1).reshape(B, MB).to(torch.int32)
    starts = torch.tensor(list(lens) + [MB * Bs + 1], dtype=torch.int32,
                          device=dev)
    pos = starts[:, None].long() + torch.arange(T, device=dev)
    write_chunk(k, rnd(B, T, Hkv, D), tables, pos)
    write_chunk(v, rnd(B, T, Hkv, D), tables, pos)
    nb = min(-(-(max(lens) + T) // Bs), MB)
    return rnd(B, T, Hkv * G, D), k, v, tables, starts, nb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,T,Hkv,G,D", [
    # G = 1: Qwen1.5-MoE (16 kv heads, D = 128), Gemma-7B (D = 256); the
    # bf16 prefill tile holds 64 positions of one head
    (pa.paged_decode_attention, 1, 16, 1, 128),
    (pa.paged_decode_attention, 8, 16, 1, 128),
    (pa.paged_attention, 130, 16, 1, 128),
    (pa.paged_decode_attention, 1, 4, 1, 256),
    (pa.paged_attention, 100, 4, 1, 256),
    # G = 7: Qwen2-7B; 63 live rows of the prefill tile (block_q 9)
    (pa.paged_decode_attention, 1, 4, 7, 128),
    (pa.paged_decode_attention, 8, 4, 7, 128),
    (pa.paged_attention, 9, 4, 7, 128),
    (pa.paged_attention, 100, 4, 7, 128),
])
def test_kernels_at_mha_and_seven_groups_match_plain_version(cuda, fn, T,
                                                             Hkv, G, D,
                                                             dtype):
    q, k, v, tables, starts, nb = _geometry_case(cuda, T, Hkv, G, D, dtype,
                                                 (70, 5, 300))
    got = fn(q, k, v, tables, starts, nb=nb)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(q, k, v, tables, starts, nb)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]
    assert (got[-1] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fn,T,G,Bs,lens,window", [
    (pa.paged_decode_attention, 1, 4, 16, (300, 170, 517), 40),
    (pa.paged_decode_attention, 8, 4, 16, (300, 170, 517), 40),
    (pa.paged_attention, 9, 4, 16, (300, 170, 517), 40),
    (pa.paged_attention, 70, 4, 16, (300, 170, 517), 40),
    (pa.paged_decode_attention, 1, 4, 64, (4600, 10, 2000), 4096),
])
def test_kernels_over_rolled_tables_match_the_intact_ones(cuda, fn, T, G,
                                                          Bs, lens, window,
                                                          dtype):
    """The engine's rolling points the table entries of blocks wholly
    behind a row's window at trash block 0 (engine._roll_windows): over
    such a table, with the trash block full of 1e4, the kernels give the
    plain version's output over the intact table."""
    q, k, v, tables, starts, nb = _geometry_case(cuda, T, 2, G, 128, dtype,
                                                 lens, Bs=Bs)
    k[0] = 1.0e4
    v[0] = 1.0e4
    rolled = tables.clone()
    MB = tables.shape[1]
    for b, s in enumerate(starts.tolist()):
        rolled[b, :MB if s >= MB * Bs else max(s - window + 1, 0) // Bs] = 0
    assert (rolled[0] == 0).any()
    got = fn(q, k, v, rolled, starts, nb=nb, window=window)
    torch.cuda.synchronize()
    want = pa.paged_attention_plain(q, k, v, tables, starts, nb,
                                    window=window)
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("exact", [True, False])
def test_moe_on_the_card_equals_the_cpu(cuda, exact):
    """ops/moe.moe_mlp in float32 on the card against the same call on
    the CPU (1e-5): the same expert ids, and in the dispatch (factor 0.5,
    padding masked) the same drop set."""
    from production_stack_tpu_torch.ops import moe
    g = torch.Generator().manual_seed(3)
    N, h, E, i = 96, 32, 4, 64
    x = torch.randn((N, h), generator=g)
    rw = torch.randn((h, E), generator=g) * 0.2
    gate, up = (torch.randn((E, h, i), generator=g) * 0.1 for _ in range(2))
    down = torch.randn((E, i, h), generator=g) * 0.1
    valid = torch.arange(N) < 80
    kw = dict(top_k=2, capacity_factor=0.5,
              dense_threshold=1000 if exact else 1)
    args = (x, rw, gate, up, down)
    want = moe.moe_mlp(*args, valid=valid, **kw)
    got = moe.moe_mlp(*(t.to(cuda) for t in args), valid=valid.to(cuda),
                      **kw)
    assert (got.cpu() - want).abs().max().item() <= 1e-5
    ids_c = moe.route(x, rw, 2)[1]
    ids_g = moe.route(x.to(cuda), rw.to(cuda), 2)[1]
    assert torch.equal(ids_g.cpu(), ids_c)
    cap = moe.capacity_for(N, E, 2, 0.5)
    assert torch.equal(moe.dispatch_plan(ids_g, E, cap, valid.to(cuda)).cpu(),
                       moe.dispatch_plan(ids_c, E, cap, valid))


def _tier_runner(dev, kv_dtype):
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.runner import ModelRunner
    from production_stack_tpu_torch.models import config as tconfig
    from production_stack_tpu_torch.models.kv import KVCache
    cfg = EngineConfig(model="debug-tiny", device=str(dev),
                       kv_dtype=kv_dtype, max_model_len=256,
                       max_num_seqs=3, kv_block_size=16)
    runner = ModelRunner(tconfig.get_config("debug-tiny"), cfg)
    g = torch.Generator().manual_seed(4)
    shape = runner.cache.k.shape
    if kv_dtype == "int8":
        k, v = (torch.randint(-127, 128, shape, generator=g,
                              dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], generator=g) * 0.05 + 1e-3
                  for _ in range(2))
        runner.cache = KVCache(k.to(dev), v.to(dev), ks.to(dev), vs.to(dev))
    else:
        runner.cache = KVCache(*(torch.randn(shape, generator=g).to(
            torch.bfloat16).to(dev) for _ in range(2)))
    MB = cfg.max_blocks_per_seq
    runner.set_block_tables(
        (torch.randperm(3 * MB, generator=g) + 1).reshape(3, MB).to(
            torch.int32).numpy())
    return runner


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_tier_chunks_on_the_card_equal_the_cpu(cuda, kv_dtype):
    """runner.extract_chunk / inject_chunk on the card against the CPU on
    the same pool and tables: equal bf16 chunks out (an int8 pool
    dequantized in f32, then rounded), and after injecting a chunk equal
    pools (an int8 pool re-quantized: equal int8 payload and scales)."""
    c, d = _tier_runner("cpu", kv_dtype), _tier_runner(cuda, kv_dtype)
    for slot, start in ((1, 32), (2, 40), (0, 240)):
        kc, vc = c.extract_chunk(slot, start, 32)
        kd, vd = d.extract_chunk(slot, start, 32)
        assert kd.is_cuda and kd.is_contiguous()
        assert torch.equal(kd.cpu().view(torch.int16),
                           kc.view(torch.int16))
        assert torch.equal(vd.cpu().view(torch.int16),
                           vc.view(torch.int16))
    g = torch.Generator().manual_seed(5)
    chunk = [torch.randn(kc.shape, generator=g).to(torch.bfloat16)
             for _ in range(2)]
    c.inject_chunk(1, 64, *chunk)
    d.inject_chunk(1, 64, *(t.pin_memory() for t in chunk))
    for name in ("k", "v", "ks", "vs"):
        want, got = getattr(c.cache, name), getattr(d.cache, name)
        if want is not None:
            assert torch.equal(got.cpu(), want), name


def test_tier_round_trip_on_the_card_equals_the_cpu(cuda):
    """The connector on the card: a slot's prompt chunks published
    (gathered, copied into pinned memory behind an event, serialized by
    the writer thread) and fetched back (into pinned memory, copied to
    the card asynchronously) into another slot, whose blocks then hold
    the same chunks; the tier values equal the CPU run's byte for
    byte."""
    from types import SimpleNamespace

    from production_stack_tpu_torch.kvcache.connector import (
        KVConnector, KVTransferConfig)

    def run(dev):
        r = _tier_runner(dev, "bfloat16")
        conn = KVConnector(r, r.model_cfg, r.engine_cfg, KVTransferConfig(
            local_cpu_gb=0.01, chunk_size=32))
        prompt = list(range(100))
        seq = SimpleNamespace(prompt_tokens=prompt, output_tokens=[],
                              num_prefilled=100, slot=1,
                              kv_publish_state=None)
        conn.on_prefill_progress(seq)
        conn.flush()
        pf = conn.prefetch(prompt)
        assert pf is not None and pf.cached_tokens == 96
        assert all(k.is_pinned() == (r.device.type == "cuda")
                   for k, _ in pf.chunks)
        conn.inject(pf, 2)
        for i in range(3):
            for a, b in zip(r.extract_chunk(1, 32 * i, 32),
                            r.extract_chunk(2, 32 * i, 32)):
                assert torch.equal(a, b)
        values = [conn.store.get(k) for k in pf.keys]
        conn.close()
        return values
    assert run(cuda) == run("cpu")
