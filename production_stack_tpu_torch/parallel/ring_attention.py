"""Ring attention: causal attention with the sequence split over ``sp``
(``production_stack_tpu/parallel/ring_attention.py:32-113``).

Each of the n ranks along sp holds one contiguous block of the sequence
(its queries and its K/V). The rank attends its own block first, then
n - 1 times receives the K/V block of the rank before it on the ring
(mesh.TrainWorld.ppermute: one hop, K and V stacked into one tensor)
and merges that block's partial attention into its running float32
online softmax. Causality is per element on global positions (block
index times block length plus the offset): a block wholly in a query's
future is masked, not skipped, so every rank runs the same ops and
issues the same hops, in the forward and in the backward, where
autograd differentiates the ops and each hop's backward is the reverse
hop. Rows with no visible key in a block (its running max still at the
mask value) are zeroed, as JAX's ``_block_attend`` does. Plain PyTorch:
JAX's ring attention is plain jnp too, so no kernel is ported here.
"""

from typing import Optional

import torch

from production_stack_tpu_torch.parallel.mesh import TrainWorld

_NEG_INF = -1e30


def _block_attend(q5, k, v, q_pos, k_pos, scale):
    """Partial attention of the local queries q5 [B,Tq,Hkv,G,D] against
    one K/V block [B,Tk,Hkv,D] at global positions q_pos [Tq], k_pos
    [Tk]: (unnormalized f32 out [B,Tq,Hkv,G,D], row max m [B,Hkv,G,Tq],
    row sum l [B,Hkv,G,Tq])."""
    scores = torch.einsum("btkgd,bskd->bkgts", q5.float(), k.float()) * scale
    mask = k_pos[None, :] <= q_pos[:, None]                    # [Tq,Tk]
    scores = torch.where(mask, scores,
                         torch.full((), _NEG_INF, device=scores.device))
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m[..., None])
    # rows with no visible key: m at the mask value would give exp(0) = 1
    valid = m > _NEG_INF / 2
    p = torch.where(valid[..., None], p, torch.zeros((), device=p.device))
    m = torch.where(valid, m, torch.full((), _NEG_INF, device=m.device))
    out = torch.einsum("bkgts,bskd->btkgd", p.to(v.dtype), v)
    return out.float(), m, p.sum(dim=-1)


def _to_btkgd(x: torch.Tensor) -> torch.Tensor:
    """[B,Hkv,G,Tq] -> [B,Tq,Hkv,G,1]."""
    return x.movedim(-1, 1)[..., None]


def _merge(out, m, l, blk_out, blk_m, blk_l):
    """Online-softmax merge of one block's partial attention."""
    new_m = torch.maximum(m, blk_m)
    alpha = torch.exp(m - new_m)
    beta = torch.exp(blk_m - new_m)
    return (out * _to_btkgd(alpha) + blk_out * _to_btkgd(beta), new_m,
            l * alpha + blk_l * beta)


def ring_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          world: TrainWorld, axis: str = "sp",
                          scale: Optional[float] = None) -> torch.Tensor:
    """Causal GQA of this rank's block of a sequence split over `axis`:
    q [B,Tl,H,D], k/v [B,Tl,Hkv,D] at global positions
    index * Tl .. + Tl - 1 -> [B,Tl,H,D] in q's dtype, equal to
    ops/attention.causal_attention of the whole sequence at the rank's
    rows. scale defaults to D ** -0.5 (JAX's jit_train_step passes no
    window and no softcap)."""
    B, Tl, H, D = q.shape
    Hkv = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    idx, n = world.index(axis), world.size(axis)
    pos = torch.arange(Tl, device=q.device)
    q_pos = idx * Tl + pos
    q5 = q.reshape(B, Tl, Hkv, H // Hkv, D)
    # the local (diagonal) block first: no hop needed for it
    out, m, l = _block_attend(q5, k, v, q_pos, q_pos, scale)
    kv = torch.stack([k, v])
    for hop in range(1, n):
        kv = world.ppermute(kv, axis)
        k_pos = (idx - hop) % n * Tl + pos
        out, m, l = _merge(out, m, l,
                           *_block_attend(q5, kv[0], kv[1], q_pos, k_pos,
                                          scale))
    norm = torch.where(l > 0, l, torch.ones((), device=l.device))
    return (out / _to_btkgd(norm)).reshape(B, Tl, H, D).to(q.dtype)
