"""Batched on-device sampling: greedy, temperature, top-k, top-p, min_p
(``production_stack_tpu/engine/sampler.py``).

Only sampled ids (and their logprobs) cross to the host; the [B, V]
logits stay on the device. Rows differ only by data, so one call serves
any mix of per-request parameters, and one descending sort feeds both
top-k and top-p.

Noise differs from the JAX package by design: ``jax.random`` threefry
cannot be reproduced by a torch generator. What is kept is the contract
seeded rows rely on: a row with ``seed > 0`` draws its Gumbel noise
from a counter hash of (seed, position, vocab index) only, so the same
seeded request gives the same tokens whatever else shares the batch —
and the same on the CPU and on the card. Unseeded rows draw from the
engine's ``torch.Generator``.

``adjust_logits`` is the OpenAI/vLLM logit shaping (penalties, logit
bias, min_tokens) ahead of sampling: plain tensor ops over [B, V], run
only for windows with a shaped row (engine.py).
"""

from dataclasses import dataclass, fields
from typing import Optional

import torch

from production_stack_tpu_torch.utils import resolve_device

_EPS = 1e-6
_NEG_INF = -1e30

# logit_bias slots per row: covers OpenAI's documented 300-entry cap
LOGIT_BIAS_K = 320

# stop_token_ids masked while the output is below min_tokens (vLLM:
# min_tokens bans EOS and every stop token)
MIN_TOKENS_STOP_K = 16


@dataclass
class SamplingParams:
    """Per-row request state on the engine device: [B] tensors, and
    [B, K] for the logit-bias and stop-id slots.

    ``adapter`` selects each row's LoRA adapter (0 = base model,
    models/lora.py); it rides with the sampling params because both
    change only when a slot's sequence does, so one upload covers them.
    sample() ignores it; the runner gathers the rows' factors from it."""

    temperature: torch.Tensor   # f32; <= 0 => greedy
    top_p: torch.Tensor         # f32 in (0, 1]
    top_k: torch.Tensor         # int32; 0 => disabled
    adapter: torch.Tensor       # int32 adapter id; 0 => base model
    seed: torch.Tensor          # int64; 0 => unseeded (engine generator)
    min_p: torch.Tensor         # f32; 0 => off
    # logit shaping (adjust_logits), inert at these defaults
    presence: torch.Tensor      # f32; 0 => off (OpenAI presence_penalty)
    frequency: torch.Tensor     # f32; 0 => off (OpenAI frequency_penalty)
    repetition: torch.Tensor    # f32; 1 => off (HF/vLLM repetition_penalty)
    min_tokens: torch.Tensor    # int32; EOS + stop ids banned below it
    prompt_len: torch.Tensor    # int32; output index = position - this
    bias_ids: torch.Tensor      # int32 [B, LOGIT_BIAS_K]; -1 => unused
    bias_vals: torch.Tensor     # f32 [B, LOGIT_BIAS_K]
    stop_ids: torch.Tensor      # int32 [B, MIN_TOKENS_STOP_K]; -1 => unused

    @staticmethod
    def filled(batch: int, temperature=1.0, top_p=1.0, top_k=0, adapter=0,
               seed=0, min_p=0.0, presence=0.0, frequency=0.0,
               repetition=1.0, min_tokens=0, prompt_len=0, device="cuda"
               ) -> "SamplingParams":
        device = resolve_device(device)

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=device)

        f32, i32 = torch.float32, torch.int32
        return SamplingParams(
            temperature=full((batch,), temperature, f32),
            top_p=full((batch,), top_p, f32),
            top_k=full((batch,), top_k, i32),
            adapter=full((batch,), adapter, i32),
            seed=full((batch,), seed, torch.int64),
            min_p=full((batch,), min_p, f32),
            presence=full((batch,), presence, f32),
            frequency=full((batch,), frequency, f32),
            repetition=full((batch,), repetition, f32),
            min_tokens=full((batch,), min_tokens, i32),
            prompt_len=full((batch,), prompt_len, i32),
            bias_ids=full((batch, LOGIT_BIAS_K), -1, i32),
            bias_vals=full((batch, LOGIT_BIAS_K), 0.0, f32),
            stop_ids=full((batch, MIN_TOKENS_STOP_K), -1, i32))

    def rows(self, n: int) -> "SamplingParams":
        """The first n rows."""
        return SamplingParams(**{f.name: getattr(self, f.name)[:n]
                                 for f in fields(self)})


def adjust_logits(logits: torch.Tensor, params: SamplingParams,
                  out_counts: torch.Tensor, prompt_seen: torch.Tensor,
                  out_len: torch.Tensor, eos_id: int) -> torch.Tensor:
    """OpenAI/vLLM logit shaping ahead of sampling
    (``production_stack_tpu/engine/sampler.py adjust_logits``).

    logits f32 [B, V]; out_counts int32 [B, V]: each row's counts of
    generated tokens; prompt_seen bool [B, V]: tokens of the prompt;
    out_len [B]: tokens generated so far (the one being sampled is
    output index out_len). As in vLLM:

    - logit_bias: added from the request's (id, value) pairs;
    - repetition_penalty: divides positive and multiplies negative
      logits of every token seen in the prompt or the output;
    - presence_penalty: subtracted once for any generated token;
    - frequency_penalty: subtracted per generated occurrence;
    - min_tokens: EOS and the request's stop ids are banned while
      out_len < min_tokens."""
    B, V = logits.shape
    valid = params.bias_ids >= 0
    logits = logits.scatter_add(
        1, params.bias_ids.clamp(min=0).long(),
        torch.where(valid, params.bias_vals,
                    torch.zeros_like(params.bias_vals)))
    seen_out = out_counts > 0
    rep = params.repetition[:, None]
    penal = torch.where(logits > 0, logits / rep, logits * rep)
    logits = torch.where(seen_out | prompt_seen, penal, logits)
    logits = logits - params.presence[:, None] * seen_out
    logits = logits - params.frequency[:, None] * out_counts
    below_floor = (out_len < params.min_tokens)[:, None]
    banned = torch.zeros((B, V), dtype=torch.int32,
                         device=logits.device).scatter_add_(
        1, params.stop_ids.clamp(min=0).long(),
        (params.stop_ids >= 0).to(torch.int32)) > 0
    banned[:, eos_id] = True
    return torch.where(below_floor & banned,
                       torch.full_like(logits, _NEG_INF), logits)


def _i64(c: int) -> int:
    """A 64-bit constant as the int64 torch arithmetic wraps it."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 (torch's >> is arithmetic)."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _mix(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finaliser in wrapping int64 arithmetic."""
    x = (x ^ _shr(x, 30)) * _i64(0xBF58476D1CE4E5B9)
    x = (x ^ _shr(x, 27)) * _i64(0x94D049BB133111EB)
    return x ^ _shr(x, 31)


def seeded_gumbel(seed: torch.Tensor, positions: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Gumbel noise [B, V] that depends only on each row's (seed,
    position) and the vocabulary index: a counter hash, the same on
    every device and for any batch."""
    base = _mix(seed.long() * _i64(0x9E3779B97F4A7C15)
                + positions.long())                            # [B]
    idx = torch.arange(vocab, device=seed.device, dtype=torch.int64)
    bits = _shr(_mix(base[:, None] + idx[None, :]
                     * _i64(0xD1B54A32D192ED03)), 40)          # 24 bits
    u = (bits.float() + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample(logits: torch.Tensor, params: SamplingParams,
           generator: Optional[torch.Generator],
           positions: Optional[torch.Tensor] = None,
           plain: bool = False) -> torch.Tensor:
    """logits f32 [B, V] -> token ids int32 [B].

    positions [B]: absolute position of the token being sampled; rows
    with seed > 0 take their noise from seeded_gumbel(seed, position).
    None skips the seeded branch (no seeded row in the batch).

    plain=True skips the [B, V] sort: pure temperature sampling, for
    batches where every row has top_p >= 1, top_k == 0 and min_p == 0 —
    the same distribution the full path gives such rows."""
    B, V = logits.shape
    greedy = torch.argmax(logits, dim=-1)
    temp = torch.clamp(params.temperature, min=_EPS)[:, None]
    scaled = logits / temp
    if plain:
        masked = scaled
    else:
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        k = torch.where(params.top_k > 0, params.top_k,
                        torch.full_like(params.top_k, V)).long()
        kth = torch.gather(sorted_logits, 1,
                           torch.clamp(k[:, None] - 1, 0, V - 1))
        probs_sorted = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs_sorted, dim=-1)
        keep_sorted = (cum - probs_sorted) < params.top_p[:, None]
        p_thresh = torch.where(
            keep_sorted, sorted_logits,
            torch.full_like(sorted_logits, float("inf"))).amin(
                dim=-1, keepdim=True)
        threshold = torch.maximum(kth, p_thresh)
        masked = torch.where(scaled >= threshold, scaled,
                             torch.full_like(scaled, _NEG_INF))
        minp_thresh = sorted_logits[:, :1] + torch.log(
            torch.clamp(params.min_p[:, None], 0.0, 1.0))
        masked = torch.where(scaled >= minp_thresh, masked,
                             torch.full_like(masked, _NEG_INF))
    u = torch.rand((B, V), generator=generator, device=logits.device,
                   dtype=torch.float32).clamp_(1e-20, 1.0 - 1e-7)
    gumbel = -torch.log(-torch.log(u))
    if positions is not None:
        gumbel = torch.where((params.seed > 0)[:, None],
                             seeded_gumbel(params.seed, positions, V),
                             gumbel)
    sampled = torch.argmax(masked + gumbel, dim=-1)
    return torch.where(params.temperature <= _EPS, greedy,
                       sampled).to(torch.int32)
