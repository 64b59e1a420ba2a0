"""The training step: causal-LM loss, optax's AdamW with global-norm
clipping, and the step sharded over a (dp, sp, tp) world
(``production_stack_tpu/parallel/train.py``).

JAX differentiates ``loss_fn`` with ``jax.value_and_grad``; here autograd
differentiates the same plain ops (models/llama.forward_train), whose
collectives in a sharded world are autograd Functions
(parallel/mesh.TrainWorld). No step reaches a hand-written kernel: JAX's
training reaches no Pallas kernel either.

``make_optimizer`` has the semantics of optax 0.2.6's
``chain(clip_by_global_norm(1.0), adamw(lr))`` (b1 0.9, b2 0.999, eps
1e-8, eps_root 0, weight decay 1e-4 on every leaf, added to the Adam
direction before the learning rate, bias correction with count + 1,
``mu`` and ``nu`` in the parameters' dtype), written as in-place passes
over the leaves: the clip factor (1 below the norm, else max_norm /
norm) scales the gradient as it enters the moments, and each leaf is
updated a slice at a time, so the step's transient memory is one
slice's float32 copies, not a leaf's (Llama-3-8B's gate is 3.76 GB).
The norm and each slice's arithmetic are float32 whatever the leaves'
dtype; optax computes in the leaves' dtype, so on float32 leaves the
two agree to rounding and on bf16 leaves the port rounds once per
stored value.

A step updates the state's tensors in place and returns a new
``TrainState`` over them: the state it was given is consumed (JAX
donates it to the jitted step), and a second step on it raises.
"""

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.quant import is_quantized
from production_stack_tpu_torch.parallel import sharding
from production_stack_tpu_torch.parallel.mesh import TrainWorld
from production_stack_tpu_torch.parallel.ring_attention import \
    ring_causal_attention

# elements of a leaf updated at a time: the slice's float32 copies are
# 256 MB each (a leaf's first axis is cut, a stacked leaf's layers)
SLICE_ELEMENTS = 1 << 26

# replicated leaves whose gradient is a tp rank's partial sum: their
# output scales a partial (the experts' combine, the shared expert)
_PARTIAL_UNDER_TP = ("router", "s_gate_w")


class NotTrainable(ValueError, TypeError):
    """A model that cannot be trained: int8 leaves. A ValueError, and a
    TypeError as JAX's grad of an int8 leaf raises."""


@dataclasses.dataclass
class AdamState:
    """optax's ScaleByAdamState: the step count and the moments, one
    tensor per leaf name in the parameters' dtype."""
    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The trainable model (its leaves require gradients), the
    optimizer's state and the step; consumed by the step it is given to
    (the module doc)."""
    params: llama.Llama
    opt_state: AdamState
    step: int = 0
    consumed: bool = False


def _consume(state: TrainState) -> None:
    if state.consumed:
        raise RuntimeError("this TrainState was consumed by an earlier "
                           "step, which updated its tensors in place: "
                           "step the state that step returned")
    state.consumed = True


def _slices(t: torch.Tensor):
    """t cut on its first axis into pieces of at most SLICE_ELEMENTS
    (whole rows; a 0-d or small tensor is one piece)."""
    if t.dim() == 0 or t.numel() <= SLICE_ELEMENTS:
        return (t,)
    rows = max(1, SLICE_ELEMENTS // (t.numel() // t.shape[0]))
    return t.split(rows, 0)


def _sumsq(t: torch.Tensor) -> torch.Tensor:
    return sum(s.float().square().sum() for s in _slices(t))


def global_norm(grads: Dict[str, torch.Tensor], sharded=(),
                reduce=None) -> torch.Tensor:
    """optax's global_norm in float32: the square root of every leaf's
    sum of squares. The leaves named in `sharded` are a rank's slices:
    their sum goes through reduce (the sum over the ranks holding the
    other slices); every other leaf is whole on the rank and counts
    once."""
    parts = {True: [], False: []}
    for name, g in grads.items():
        parts[name in sharded].append(_sumsq(g))
    zero = torch.zeros((), dtype=torch.float32,
                       device=next(iter(grads.values())).device)
    split = sum(parts[True], zero)
    if reduce is not None and parts[True]:
        split = reduce(split)
    return torch.sqrt(split + sum(parts[False], zero))


@dataclasses.dataclass(frozen=True)
class AdamW:
    """optax's chain(clip_by_global_norm(max_norm), adamw(lr, b1, b2,
    eps, eps_root, weight_decay)) on tensors, in place (the module
    doc)."""
    lr: float = 3e-4
    max_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0
    weight_decay: float = 1e-4

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        return AdamState(
            0, {n: torch.zeros_like(p, requires_grad=False)
                for n, p in params.items()},
            {n: torch.zeros_like(p, requires_grad=False)
             for n, p in params.items()})

    def clip_factor(self, g_norm: torch.Tensor) -> torch.Tensor:
        """1 where the norm is below max_norm, else max_norm / norm (a
        device scalar: no host sync)."""
        return torch.where(g_norm < self.max_norm, torch.ones_like(g_norm),
                           self.max_norm / g_norm)

    @torch.no_grad()
    def update_(self, params: Dict[str, torch.Tensor],
                grads: Dict[str, torch.Tensor], state: AdamState,
                g_norm: torch.Tensor) -> AdamState:
        """One step on every leaf in place: the clipped gradient into
        mu = b1 mu + (1 - b1) g and nu = b2 nu + (1 - b2) g^2, then
        p += -lr (mu_hat / (sqrt(nu_hat + eps_root) + eps) + wd p) with
        the moments bias-corrected by count + 1. Returns the state with
        the new count."""
        count = state.count + 1
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        factor = self.clip_factor(g_norm)
        for name, p in params.items():
            for ps, gs, ms, vs in zip(*(_slices(t) for t in (
                    p, grads[name], state.mu[name], state.nu[name]))):
                # optax's order: (1 - b) * g^k + b * moment, each in f32
                g = gs.float() * factor
                m = g.mul(1 - self.b1).add_(ms, alpha=self.b1)
                v = g.square_().mul_(1 - self.b2).add_(vs, alpha=self.b2)
                ms.copy_(m)
                vs.copy_(v)
                u = m.div_(bc1).div_(v.div_(bc2).add_(self.eps_root)
                                     .sqrt_().add_(self.eps))
                u.add_(ps, alpha=self.weight_decay)
                ps.add_(u, alpha=-self.lr)
        return AdamState(count, state.mu, state.nu)


def make_optimizer(lr: float = 3e-4) -> AdamW:
    """JAX's make_optimizer: clip at global norm 1.0, then AdamW(lr)."""
    return AdamW(lr=lr)


def trainable(model: llama.Llama) -> llama.Llama:
    """model with gradients on for every leaf (training's own module:
    serving's stay frozen). int8 leaves refuse (NotTrainable)."""
    quant = [n for n, c in model.named_children() if is_quantized(c)]
    if quant:
        raise NotTrainable(f"int8 leaves {quant} cannot be trained: "
                           f"train the bf16 or f32 weights")
    for p in model.parameters():
        p.requires_grad_(True)
    return model


def init_train_state(model: llama.Llama,
                     optimizer: Optional[AdamW] = None) -> TrainState:
    """A TrainState over `model` (made trainable) with the optimizer's
    zero moments (JAX: optimizer.init(params))."""
    optimizer = optimizer or make_optimizer()
    trainable(model)
    return TrainState(model, optimizer.init(dict(model.named_parameters())))


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-position cross entropy [B, n] of f32 logits [B, n, V] against
    targets [B, n]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0]


def nll_from_logits(logits: torch.Tensor, tokens: torch.Tensor
                    ) -> torch.Tensor:
    """Mean next-token cross entropy: the f32 log-softmax of
    logits[:, :-1] read at tokens[:, 1:]. The one definition the plain
    and the pipelined losses share (JAX's)."""
    return _nll(logits[:, :-1], tokens[:, 1:]).mean()


def loss_fn(model: llama.Llama, cfg: ModelConfig, tokens: torch.Tensor,
            attention_fn=None) -> torch.Tensor:
    """Next-token cross entropy of tokens [B, T] (f32 logits)."""
    return nll_from_logits(
        llama.forward_train(model, cfg, tokens, attention_fn=attention_fn),
        tokens)


def _grads(loss: torch.Tensor, model: llama.Llama
           ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return params, dict(zip(params, grads))


def train_step(state: TrainState, tokens: torch.Tensor, cfg: ModelConfig,
               optimizer: AdamW, attention_fn=None
               ) -> Tuple[TrainState, torch.Tensor]:
    """(new state, loss): the loss and its gradients, the clipped AdamW
    update in place (JAX's train_step)."""
    _consume(state)
    loss = loss_fn(state.params, cfg, tokens, attention_fn)
    params, grads = _grads(loss, state.params)
    opt_state = optimizer.update_(params, grads, state.opt_state,
                                  global_norm(grads))
    return TrainState(state.params, opt_state, state.step + 1), loss.detach()


def _split(n: int, index: int, size: int, what: str) -> slice:
    if n % size:
        raise ValueError(f"{what} of {n} does not split over {size} ranks")
    step = n // size
    return slice(index * step, (index + 1) * step)


def jit_train_step(world: TrainWorld, cfg: ModelConfig, model: llama.Llama,
                   optimizer: Optional[AdamW] = None,
                   sequence_parallel: bool = True):
    """(state, step_fn) of this rank of a (dp, sp, tp) world, JAX's
    jit_train_step: step_fn(state, tokens) -> (state, loss).

    The rank holds the tp slices of the model's leaves
    (sharding.shard_params; `model`, the whole one, is left as it is) and
    their AdamW moments. step_fn takes the whole [B, T] batch and keeps
    its rows of the dp split and, when sequence-parallel, its block of
    the sp split of the sequence (JAX's data_sharding), whose
    attention is then ring attention over sp and whose RoPE positions
    are global. A position's target is the next token of the whole
    sequence (a block's last position reads the next block's first),
    the loss divides by B * (T - 1) over the whole batch, and the
    gradients are summed over dp (and sp). Refuses as JAX does: sp > 1
    with a sliding window."""
    optimizer = optimizer or make_optimizer()
    if world.size("pp") > 1:
        raise ValueError("jit_train_step runs pp = 1: a pipeline trains "
                         "through parallel/pipeline.pipeline_loss_fn")
    use_sp = sequence_parallel and world.size("sp") > 1
    attention_fn = None
    if use_sp:
        if cfg.sliding_window:
            # the ring-attention override bypasses the windowed
            # causal_attention path (JAX's refusal)
            raise NotImplementedError(
                "sequence-parallel training does not implement "
                "sliding-window attention yet; train this config "
                "with sp=1")
        attention_fn = lambda q, k, v: ring_causal_attention(  # noqa: E731
            q, k, v, world, axis="sp")
    data = "data" if use_sp else "dp"
    local = sharding.shard_params(model, world.shard)
    local.mesh = world
    state = init_train_state(local, optimizer)
    tp = world.size("tp")
    sharded = {name for name, _ in local.named_parameters()
               if tp > 1 and "tp" in sharding.leaf_spec(cfg, name)}
    partial = [n for n in _PARTIAL_UNDER_TP if tp > 1 and hasattr(local, n)]
    rope = llama.rope_tensors(cfg, cfg.max_position_embeddings,
                              world.device)

    def step_fn(state: TrainState, tokens: torch.Tensor
                ) -> Tuple[TrainState, torch.Tensor]:
        _consume(state)
        B, T = tokens.shape
        tokens = tokens.to(world.device)
        rows = tokens[_split(B, world.index("dp"), world.size("dp"),
                             "batch")]
        sp_i, sp_n = ((world.index("sp"), world.size("sp")) if use_sp
                      else (0, 1))
        block = _split(T, sp_i, sp_n, "sequence")
        targets = rows[:, block.start + 1:block.stop + 1]
        logits = llama.forward_train(state.params, cfg, rows[:, block],
                                     rope=rope, attention_fn=attention_fn,
                                     offset=block.start)
        nll = _nll(logits[:, :targets.shape[1]], targets).sum() \
            / (B * (T - 1))
        params, grads = _grads(nll, state.params)
        for g in grads.values():
            world.reduce_(g, data)
        for name in partial:
            world.reduce_(grads[name], "tp")
        g_norm = global_norm(grads, sharded,
                             lambda t: world.reduce_(t, "tp"))
        opt_state = optimizer.update_(params, grads, state.opt_state,
                                      g_norm)
        loss = world.reduce_(nll.detach().clone(), data)
        return TrainState(state.params, opt_state, state.step + 1), loss

    return state, step_fn
