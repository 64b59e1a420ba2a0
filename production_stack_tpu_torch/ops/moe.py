"""Mixture-of-experts MLP: top-k routing with static-shape dispatch
(``production_stack_tpu/ops/moe.py``).

The JAX module is plain ``jnp`` (no Pallas kernel): routing, dispatch
and combine are PyTorch ops here, on tensors of an explicit device, with
the same two strategies, chosen by token count N:

- **Exact (small N, the decode path).** Every expert runs over all N
  tokens (``torch.matmul`` of the tokens against the stacked ``[E, h, i]``
  weights, one batched product per projection) and the results combine
  by an ``[N, E]`` matrix holding each token's routing weights (zero for
  the experts it did not choose). No token is ever dropped.
- **Capacity dispatch (large N, the prefill path).** Each (token,
  choice) assignment gets a rank within its expert from a token-major
  ``cumsum`` of the one-hot choices; assignments ranked below
  ``capacity`` are scattered into a per-expert ``[capacity, h]`` buffer,
  the experts run as one batched product, and the results gather back
  and combine. Assignments ranked past capacity go to a trash row
  ``E * capacity`` and contribute nothing (the token rides the residual
  stream). Padding tokens (``valid`` False) are left out of the ranking,
  so they never take a real token's place in an expert.

The drop set is the JAX one: N is the whole padded batch the caller
gives (the runner's full-batch prefill), capacity comes from that N, and
ranks follow the token-major order of the k choices. Only the trash row
receives duplicate scatter indices, so the scatter is deterministic
where it matters.

Under expert parallelism (parallel/sharding.py) a rank holds E / ep
consecutive experts from ``first_expert`` on: every rank routes every
token with the replicated router and plans the capacity dispatch over
all E experts, identically, then applies only its own experts. The
exact path keeps its experts' columns of the routing matrix; the
dispatch maps the plan's rows of its experts into a local buffer and
every other assignment (other ranks' experts, drops, padding) onto the
local trash row, so the drop set is the single-device one. The rank's
output is a partial sum that the caller sums over the ranks.

Routing is Mixtral's: a float32 softmax over all experts, ``torch.topk``,
then the selected probabilities renormalized to sum to 1, or kept raw
(Qwen2-MoE's ``norm_topk_prob=False``). Weight-only int8 expert stacks
(models/quant.py ``Int8Weight``: int8 ``[E, in, out]``, f32 scale
``[E, out]``) apply their per-expert, per-output-channel scale after the
product, as the JAX ``_edot`` does.
"""

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F


def capacity_for(n_tokens: int, num_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    """Per-expert token capacity: factor x the perfectly balanced load,
    a multiple of 8, clamped to [8, n_tokens] (the JAX rule)."""
    balanced = n_tokens * top_k / num_experts
    cap = int(-(-capacity_factor * balanced // 8) * 8)
    return max(8, min(cap, n_tokens))


def route(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
          renormalize: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing. x [N, h], router_w [h, E] -> (weights [N, k] f32,
    expert ids [N, k] int32). The router logits are computed and
    softmaxed in float32; renormalize=False keeps the raw probabilities."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, top_k, dim=-1)
    if renormalize:
        top_p = top_p / top_p.sum(dim=-1, keepdim=True)
    return top_p, top_i.to(torch.int32)


def _quant():
    """models/quant.py, imported at call time: models/ imports ops/."""
    from production_stack_tpu_torch.models import quant
    return quant


def _num_experts(w) -> int:
    return (w.w8 if _quant().is_quantized(w) else w).shape[0]


def _expert_ffn(xb: torch.Tensor, gate, up, down,
                act: Callable) -> torch.Tensor:
    """The batched per-expert gated FFN: xb [E or 1, C, h] -> [E, C, h]
    (JAX ``_expert_ffn``; an int8 stack takes its [E, out] scale after
    each product, as ``_edot`` does)."""
    edot = _quant().dequant_matmul
    return edot(act(edot(xb, gate)) * edot(xb, up), down)


def _moe_exact(x, top_p, top_i, gate, up, down, act, num_experts: int,
               first_expert: int = 0) -> torch.Tensor:
    """All (local) experts over all tokens, combined by routing weight."""
    N = x.shape[0]
    E = _num_experts(gate)
    combine = torch.zeros((N, num_experts), dtype=torch.float32,
                          device=x.device)
    combine.scatter_(1, top_i.long(), top_p)
    combine = combine[:, first_expert:first_expert + E]
    y_e = _expert_ffn(x[None], gate, up, down, act)          # [E, N, h]
    return torch.einsum("enh,ne->nh", y_e, combine.to(x.dtype))


def dispatch_plan(top_i: torch.Tensor, num_experts: int, capacity: int,
                  valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The buffer row of every assignment, token-major [N*k] int64:
    expert * capacity + its rank within the expert, or the trash row
    num_experts * capacity where it is dropped (ranked past capacity) or
    padding (valid False, left out of the ranking)."""
    k = top_i.shape[1]
    flat_e = top_i.reshape(-1).long()
    # the one-hot choices expert-major, [E, N*k]: the running count
    # scans the contiguous axis (a scan along the outer axis of a
    # [N*k, E] one-hot runs one thread per expert on the card)
    onehot = (flat_e[None, :] == torch.arange(
        num_experts, device=flat_e.device)[:, None]).to(torch.int32)
    if valid is not None:
        valid_rep = valid.to(torch.int32).repeat_interleave(k)
        onehot = onehot * valid_rep[None, :]
    # rank of each assignment within its expert: how many earlier
    # assignments chose the same expert
    prior = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    rank = prior.gather(0, flat_e[None, :])[0].long()
    keep = rank < capacity
    if valid is not None:
        keep = keep & (valid_rep > 0)
    trash = num_experts * capacity
    return torch.where(keep, flat_e * capacity + rank,
                       torch.full_like(rank, trash))


def _moe_dispatch(x, top_p, top_i, gate, up, down, act, capacity,
                  num_experts: int, valid=None,
                  first_expert: int = 0) -> torch.Tensor:
    """Scatter-based capacity dispatch (see the module doc)."""
    N, h = x.shape
    E = _num_experts(gate)
    k = top_i.shape[1]
    dest = dispatch_plan(top_i, num_experts, capacity, valid)
    if E != num_experts:
        # this rank's experts' rows, the rest onto the local trash row
        dest = dest - first_expert * capacity
        dest = torch.where((dest >= 0) & (dest < E * capacity), dest,
                           torch.full_like(dest, E * capacity))
    buf = torch.zeros((E * capacity + 1, h), dtype=x.dtype, device=x.device)
    buf[dest] = x.repeat_interleave(k, dim=0)
    y_e = _expert_ffn(buf[:-1].reshape(E, capacity, h), gate, up, down, act)
    y_flat = torch.cat([y_e.reshape(E * capacity, h),
                        torch.zeros((1, h), dtype=y_e.dtype,
                                    device=x.device)])
    w = top_p.reshape(-1)[:, None].to(x.dtype)
    return (y_flat[dest] * w).reshape(N, k, h).sum(dim=1)


def moe_mlp(x: torch.Tensor, router_w: torch.Tensor, gate, up, down, *,
            top_k: int, capacity_factor: float = 2.0,
            dense_threshold: int = 64, act: Callable = F.silu,
            valid: Optional[torch.Tensor] = None,
            exact: Optional[bool] = None,
            renormalize: bool = True,
            first_expert: int = 0) -> torch.Tensor:
    """MoE feed-forward. x [N, h]; router_w [h, E]; gate/up [E', h, i];
    down [E', i, h] (each a tensor or an Int8Weight): all E experts, or
    under expert parallelism the E' experts from first_expert on, whose
    partial output this is. Returns [N, h] in x's dtype.

    valid [N] bool marks real tokens: padding rows contribute nothing and
    never take expert capacity. exact=True forces the all-expert path
    whatever N (decode passes it: a live sequence must never lose a
    token's MLP); exact=None takes it for N <= dense_threshold or when
    capacity covers every assignment."""
    N = x.shape[0]
    E = router_w.shape[-1]
    top_p, top_i = route(x, router_w, top_k, renormalize=renormalize)
    if valid is not None:
        top_p = top_p * valid.to(top_p.dtype)[:, None]
    capacity = capacity_for(N, E, top_k, capacity_factor)
    if exact is None:
        exact = N <= dense_threshold or capacity >= N
    if exact:
        return _moe_exact(x, top_p, top_i, gate, up, down, act, E,
                          first_expert)
    return _moe_dispatch(x, top_p, top_i, gate, up, down, act, capacity,
                         E, valid=valid, first_expert=first_expert)
