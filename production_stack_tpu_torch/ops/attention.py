"""Grouped-query attention over a contiguous cache view or a whole
sequence (``production_stack_tpu/ops/attention.py:38-127``).

``attention_with_cache`` is the body of the kernels' plain versions
(ops/paged_attention.py, ops/flash_attention.py); ``causal_attention``
is the full-sequence attention of ``llama.encode`` (the pooling routes),
which the JAX package also computes outside any Pallas kernel. Both view
q as [B, T, Hkv, G, D] so K/V are never repeated to H query heads;
scores and softmax are f32 and masked with -1e30, and the probabilities
are cast to V's dtype before the value product, as the JAX functions
do."""

from typing import Optional

import torch

_NEG_INF = -1e30


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    """Gemma-2 logit softcap, s -> cap * tanh(s / cap), on RAW scores:
    applied before the -1e30 mask, since capping a masked score would
    bring it back at -cap."""
    if not cap:
        return scores
    return cap * torch.tanh(scores / cap)


def attention_with_cache(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, q_positions: torch.Tensor,
                         scale: Optional[float] = None,
                         sliding_window: Optional[int] = None,
                         logit_softcap: Optional[float] = None
                         ) -> torch.Tensor:
    """q [B,T,H,D]; k/v [B,S,Hkv,D] already holding the chunk's own K/V;
    q_positions [B,T]. A query at position p attends cache slots s <= p,
    and s > p - sliding_window when windowed. Returns [B,T,H,D] in v's
    dtype."""
    B, T, H, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    if scale is None:
        scale = D ** -0.5
    q5 = q.reshape(B, T, Hkv, G, D)
    # products of bf16 values are exact in f32: upcasting first matches
    # the JAX einsum's preferred_element_type=f32
    scores = _softcap(torch.einsum("btkgd,bskd->bkgts", q5.float(),
                                   k_cache.float()) * scale, logit_softcap)
    s_idx = torch.arange(S, device=q.device)[None, None, :]
    qp = q_positions[:, :, None]
    mask = s_idx <= qp                                          # [B,T,S]
    if sliding_window:
        mask = mask & (s_idx > qp - sliding_window)
    scores = torch.where(mask[:, None, None], scores,
                         torch.full((), _NEG_INF, device=q.device))
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v_cache.dtype),
                       v_cache)
    return out.reshape(B, T, H, D)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     scale: Optional[float] = None,
                     sliding_window: Optional[int] = None,
                     logit_softcap: Optional[float] = None
                     ) -> torch.Tensor:
    """Full-sequence causal GQA: q [B,T,H,D], k/v [B,T,Hkv,D] ->
    [B,T,H,D] in v's dtype. The query at t attends keys s <= t, and
    s > t - sliding_window when windowed (0 or None = off); the softcap
    applies to the raw scores (0 or None = off)."""
    T = q.shape[1]
    t = torch.arange(T, device=q.device)
    return attention_with_cache(q, k, v, t[None].expand(q.shape[0], T),
                                scale=scale, sliding_window=sliding_window,
                                logit_softcap=logit_softcap)
