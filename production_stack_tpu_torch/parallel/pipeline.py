"""GPipe pipeline-parallel training over the world's ``pp`` axis
(``production_stack_tpu/parallel/pipeline.py:49-172``).

Each pp rank holds one stage: L / P consecutive layers of every stacked
leaf (``stage_params``) beside the replicated embedding, final norm and
head. The schedule is JAX's: for step t in [0, n_micro + P - 1) every
stage shifts its previous output one stage forward (TrainWorld.shift,
not cyclic: stage 0 receives zeros), stage 0 takes microbatch t's
embedding, and stage s runs its layers on microbatch t - s when it is in
range (JAX runs them on the bubble's zeros too and drops the result;
here a stage in the bubble runs nothing but still takes part in every
shift). The last stage banks each microbatch's hidden states, then runs
the final norm, the head and ``nll_from_logits`` over the whole batch;
the loss is summed over pp from the last stage alone, so every rank
holds it.

The backward is the reverse pipeline, written out, not left to
autograd: ``pipeline_loss_fn``'s loss is an autograd Function whose
forward keeps each microbatch's graph of each stage (built on detached
copies of the stage's leaves) and whose backward walks the steps in
reverse, shifting each stage's input gradient one stage back before the
stage backpropagates the step's microbatch, so every rank issues the
same shifts in the same order whatever autograd would have chosen. The
replicated leaves' gradients (embedding on stage 0, final norm and head
on the last stage) are then summed over pp, as JAX's psum does, so
every stage holds them whole.

Composes with nothing else: the world is pp ranks alone, as JAX's
pipeline runs with dp = sp = tp = 1 inside it. Gemma-2's alternating
windows refuse, as in JAX.
"""

import dataclasses
import types
from typing import Dict, List

import torch

from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.ops.attention import causal_attention
from production_stack_tpu_torch.parallel.mesh import TrainWorld
from production_stack_tpu_torch.parallel.train import nll_from_logits

# leaves every stage holds whole; their gradients are summed over pp
REPLICATED = ("embed", "final_norm", "lm_head")


def stage_params(model: llama.Llama, n_stages: int,
                 stage: int) -> llama.Llama:
    """Stage `stage` of n_stages: a Llama module over layers
    [stage * L / P, (stage + 1) * L / P) of every stacked leaf (its cfg's
    num_layers L / P) and copies of the replicated leaves."""
    cfg = model.cfg
    L = cfg.num_layers
    if L % n_stages:
        raise ValueError(f"pp={n_stages} does not divide num_layers={L}")
    per = L // n_stages
    device = next(model.parameters()).device
    out = llama.Llama(dataclasses.replace(cfg, num_layers=per),
                      device=device)
    with torch.no_grad():
        for name, p in out.named_parameters():
            src = getattr(model, name)
            p.copy_(src[stage * per:(stage + 1) * per]
                    if name in llama.LAYER_KEYS else src)
    return out


class _Schedule:
    """One rank's GPipe forward and backward over its stage (the module
    doc)."""

    def __init__(self, cfg: ModelConfig, world: TrainWorld, n_micro: int,
                 stage_model: llama.Llama, tokens: torch.Tensor):
        self.cfg, self.world, self.n_micro = cfg, world, n_micro
        self.P, self.s = world.size("pp"), world.index("pp")
        B = tokens.shape[0]
        if B % n_micro:
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             f"microbatches")
        self.tokens = tokens
        self.micro = tokens.split(B // n_micro)
        # the stage's leaves, detached: each step's graph ends at them
        self.leaves = {n: p.detach().requires_grad_()
                       for n, p in stage_model.named_parameters()}
        self.view = types.SimpleNamespace(cfg=stage_model.cfg, shard=None,
                                          mesh=None, **self.leaves)
        self.steps = n_micro + self.P - 1
        T = tokens.shape[1]
        positions = torch.arange(T, device=tokens.device)[None].expand(
            B // n_micro, T)
        self.rows = llama.rope_rows(positions, *llama.rope_tensors(
            cfg, cfg.max_position_embeddings, tokens.device))
        self.saved: Dict[int, tuple] = {}

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        cfg, scale = self.cfg, llama.attn_scale(self.cfg)

        def attend(q, k, v):
            return causal_attention(q, k, v, scale=scale,
                                    sliding_window=cfg.sliding_window,
                                    logit_softcap=cfg.attn_logit_softcap)
        for l, lp in enumerate(llama.layer_params(self.view)):
            x = llama._block(cfg, self.view, l, lp, x, self.rows, attend)
        return x

    def forward(self) -> torch.Tensor:
        world, s, P = self.world, self.s, self.P
        prev = None
        for t in range(self.steps):
            if t > 0:
                prev = world.shift(prev, "pp", 1, cyclic=False)
            m = t - s
            if not 0 <= m < self.n_micro:
                # the bubble: this stage's output at t is zeros
                prev = torch.zeros_like(prev) if prev is not None else \
                    self._zeros()
                continue
            with torch.enable_grad():
                if s == 0:
                    x_in = None
                    x = llama._embed(self.view, self.cfg, self.micro[m])
                else:
                    x_in = x = prev.detach().requires_grad_()
                y = self._run(x)
            self.saved[m] = (x_in, y)
            prev = y.detach()
        loss = torch.zeros((), dtype=torch.float32,
                           device=self.tokens.device)
        if s == P - 1:
            with torch.enable_grad():
                self.banked = [self.saved[m][1].detach().requires_grad_()
                               for m in range(self.n_micro)]
                self.loss = nll_from_logits(
                    llama.final_logits(self.view, self.cfg,
                                       torch.cat(self.banked)),
                    self.tokens)
            loss = self.loss.detach().clone()
        return world.reduce_(loss, "pp")

    def _zeros(self) -> torch.Tensor:
        mb, T = self.micro[0].shape
        return torch.zeros((mb, T, self.cfg.hidden_size),
                           dtype=self.cfg.dtype, device=self.tokens.device)

    def backward(self, g: torch.Tensor) -> List[torch.Tensor]:
        world, s, P = self.world, self.s, self.P
        if s == P - 1:
            torch.autograd.backward(self.loss, g)
        d_in = None
        for t in reversed(range(self.steps)):
            if t + 1 < self.steps:
                # the adjoint of step t + 1's shift: the next stage's
                # input gradient comes back to this stage's output
                d_out = world.shift(d_in if d_in is not None
                                    else self._zeros(), "pp", -1,
                                    cyclic=False)
            m = t - s
            if not 0 <= m < self.n_micro:
                d_in = None
                continue
            x_in, y = self.saved.pop(m)
            torch.autograd.backward(
                y, self.banked[m].grad if s == P - 1 else d_out)
            d_in = None if x_in is None else x_in.grad
        grads = []
        for name, leaf in self.leaves.items():
            grad = (leaf.grad if leaf.grad is not None
                    else torch.zeros_like(leaf))
            if name in REPLICATED:
                world.reduce_(grad, "pp")
            grads.append(grad)
        return grads


class _GPipe(torch.autograd.Function):
    """The pipelined loss as one autograd node over the stage's leaves:
    the forward runs the schedule, the backward its reverse."""

    @staticmethod
    def forward(ctx, schedule, *leaves):
        ctx.schedule = schedule
        return schedule.forward()

    @staticmethod
    def backward(ctx, g):
        grads = ctx.schedule.backward(g)
        ctx.schedule = None
        return (None, *grads)


def pipeline_loss_fn(cfg: ModelConfig, world: TrainWorld, n_micro: int):
    """loss(stage_model, tokens) -> the scalar loss on every rank, the
    GPipe schedule over the world's pp ranks (stage_model: this rank's
    stage_params; tokens [B, T], the whole batch on every rank, B a
    multiple of n_micro). Differentiable: autograd.grad of the loss
    w.r.t. the stage's leaves runs the reverse pipeline."""
    if cfg.alternating_sliding:
        # per-layer window alternation needs layer identity, which the
        # stage-local layers do not carry (JAX's refusal)
        raise NotImplementedError(
            "pipeline-parallel training does not support alternating "
            "sliding-window models (Gemma-2) yet; train with pp=1")
    if world.cfg.size != world.size("pp"):
        raise ValueError(f"a pipeline world has the pp axis alone (got "
                         f"{world.cfg})")

    def loss(stage_model: llama.Llama, tokens: torch.Tensor
             ) -> torch.Tensor:
        tokens = tokens.to(world.device)
        return _GPipe.apply(_Schedule(cfg, world, n_micro, stage_model,
                                      tokens),
                            *stage_model.parameters())

    return loss
