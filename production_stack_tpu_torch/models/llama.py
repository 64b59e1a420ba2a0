"""Dense Llama-family decoder over stacked per-layer weights
(``production_stack_tpu/models/llama.py:38-370,419-450``).

The weights keep the JAX layout: every layer's matrices are stacked on a
leading layer axis and stored ``[L, in, out]`` (``x @ w[l]``), so
carrying weights across from the JAX package is a copy, never a
transpose (weights.py). They live in an ``nn.Module``; ``forward`` loops
over the layers in Python where JAX scans.

Per layer: RMSNorm -> QKV -> RoPE -> write the chunk's K/V into the
paged pool (models/kv.write_chunk, in place) -> paged attention ->
O-proj -> gated MLP. Attention dispatches exactly as the JAX forward
does (llama.py:188-223): ``nb = min(ceil(kv_len/Bs), MB)`` blocks, and
windows of T <= DECODE_T_MAX tokens take the decode kernel, longer
chunks the prefill kernel. On CUDA tensors both are the hand-written
kernels; on the CPU their plain versions. ``encode`` (the pooling
routes) runs the same blocks over a whole sequence with the plain causal
attention of ops/attention.py, as the JAX encode does.

Weight-only int8 (models/quant.py, JAX ``llama.py:130-140,419-450``):
a model built int8 (``init_params(int8=True)``, a layer at a time) or
quantized in place (``quant.quantize_params``) runs its projections through
``dequant_matmul``, the embedding through ``dequant_rows`` and the LM
head applies the per-vocab scale to its f32 product. On an int8 pool
(``KVCache.quantized``) K/V are quantized as they are written
(``write_at_q``) and both kernels read the pool with its scales.

Under a dp > 1 serving mesh (``cache.dp``, models/kv.py) a token's K/V
are written by the dp rank that owns its block only (``kv.owned``),
and each layer attends over its blocks
assembled from every dp rank (``kv.assemble_blocks``: one sum over dp)
through the same kernels (``pa.assembled_tables``), where JAX reads its
jnp gathered view (``llama.py:193-226``).

Gemma-2's deviations are those of the JAX forward: norm gains stored
around an implicit 1 (``rms_norm_offset``, initialised to zeros),
embeddings scaled by sqrt(hidden) in f32, the attention scale from
``query_pre_attn_scalar``, a tanh softcap on the attention scores and
on the f32 logits, sandwich norms after attention and MLP, gelu_tanh,
and a sliding window on the even layers (``alternating_sliding``).

The other family variations are the JAX forward's too
(``llama.py:45-97,131-135,247-270``):
- Qwen2's q/k/v biases (``attention_bias``), added to the projection
  before any LoRA delta;
- a sliding window on every layer (Mistral v0.1: ``sliding_window``
  without ``alternating_sliding``; the engine frees the blocks behind
  the window, engine.py ``_roll_windows``);
- mixture-of-experts MLPs (ops/moe.py): stacked experts ``gate``/``up``
  ``[L, E, h, mi]`` and ``down`` ``[L, E, mi, h]`` behind a ``router``
  ``[L, h, E]``; the tokens' valid mask keeps padding out of routing and
  capacity; decode (T = 1) takes the exact all-expert path. Qwen2-MoE
  adds an always-on shared expert (``s_gate``/``s_up`` ``[L, h, si]``,
  ``s_down`` ``[L, si, h]``) scaled by ``sigmoid(hidden @ s_gate_w)``.

Multi-LoRA (models/lora.py, JAX ``proj`` at ``llama.py:130-138``):
``forward`` and ``hidden`` take a batch's gathered adapter factors
(``lora.gather_rows`` of the rows' adapter ids) and the scaling; after
every product of a targeted projection (q, k, v, o, gate, up, down, on
the bf16 and the int8 weight path alike) ``lora.apply`` adds the rows'
deltas. Without factors nothing more is launched. ``encode`` takes no
adapter, as in JAX.

Training (JAX ``forward_train``, ``llama.py:406-416``): ``forward_train``
is the LM head on ``encode``, whose ``attention_fn`` replaces the causal
attention (ring attention, parallel/ring_attention.py) and whose
``offset`` starts the RoPE positions of a sequence block. Autograd
differentiates the same ops once parallel/train.py has turned the
leaves' gradients on. Every layer reads its weights through
``layer_params``, which splits each stacked leaf once. In a training
world (``model.mesh`` a parallel/mesh.TrainWorld) ``_reduce`` and the
logits gather are autograd Functions, and ``_enter`` marks each
replicated activation ahead of a column-parallel product (q/k/v,
gate/up, the vocab-parallel head), whose gradient the backward sums
over tp. The bf16 head's f32 product is ``_HeadF32``: torch.mm's
``out_dtype`` has no derivative.
"""

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from production_stack_tpu_torch.models import lora as lora_mod
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.kv import (KVCache, assemble_blocks,
                                                  chunk_addresses,
                                                  linear_tables, owned,
                                                  write_at, write_at_q)
from production_stack_tpu_torch.models.quant import (Int8Weight,
                                                     QuantizedWeight,
                                                     dequant_matmul,
                                                     dequant_rows,
                                                     is_quantized,
                                                     is_quantized_name,
                                                     quantize_into,
                                                     scale_shape)
from production_stack_tpu_torch.ops import moe
from production_stack_tpu_torch.ops import paged_attention as pa
from production_stack_tpu_torch.ops.attention import causal_attention
from production_stack_tpu_torch.ops.norms import rms_norm
from production_stack_tpu_torch.ops.rope import rope_rows, rope_table, rotate
from production_stack_tpu_torch.parallel import sharding
from production_stack_tpu_torch.utils import resolve_device

# per-layer weights, stacked on axis 0; the post norms exist only with
# sandwich norms (Gemma-2), the biases with attention_bias (Qwen2), the
# router and the stacked experts with num_experts, the shared expert with
# shared_expert_size (Qwen2-MoE)
LAYER_KEYS = ("attn_norm", "q", "k", "v", "o", "mlp_norm", "gate", "up",
              "down", "post_attn_norm", "post_mlp_norm", "q_bias",
              "k_bias", "v_bias", "router", "s_gate", "s_up", "s_down",
              "s_gate_w")
NORM_KEYS = ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm",
             "final_norm")


def layer_window(cfg: ModelConfig, layer: int) -> int:
    """Sliding window of one layer, 0 = full causal: every layer of a
    model with a window (Mistral v0.1), or Gemma-2's even layers while
    its odd layers are global (JAX llama.py:157-165,361-363)."""
    if cfg.sliding_window and (not cfg.alternating_sliding
                               or layer % 2 == 0):
        return cfg.sliding_window
    return 0


def activation(cfg: ModelConfig):
    """The MLP's gate activation: silu, or Gemma's gelu_tanh."""
    if cfg.activation == "silu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")


def attn_scale(cfg: ModelConfig) -> float:
    """query_pre_attn_scalar**-0.5 where set (Gemma-2), else D**-0.5."""
    if cfg.query_pre_attn_scalar:
        return float(cfg.query_pre_attn_scalar) ** -0.5
    return cfg.head_dim_ ** -0.5


class Llama(nn.Module):
    """Parameters of one Llama-family model, JAX layout, no gradients
    (parallel/train.trainable turns them on for training); the
    module-level ``forward`` runs them.

    embed [V, H]; per layer (stacked on axis 0): attn_norm/mlp_norm
    [L, H], q [L, H, NH*D], k/v [L, H, NKV*D], o [L, NH*D, H]; a dense
    MLP gate/up [L, H, I], down [L, I, H], or with experts gate/up
    [L, E, H, MI], down [L, E, MI, H], router [L, H, E] and with a shared
    expert s_gate/s_up [L, H, SI], s_down [L, SI, H], s_gate_w [L, H, 1];
    with sandwich norms post_attn_norm/post_mlp_norm [L, H]; with
    attention biases q_bias [L, NH*D], k_bias/v_bias [L, NKV*D];
    final_norm [H]; lm_head [H, V] unless the embeddings are tied."""

    def __init__(self, cfg: ModelConfig, device="cuda", shard=None,
                 int8: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        # a rank of a serving mesh (parallel/mesh.Shard) holds its slice
        # of every leaf (parallel/sharding.py) and calls its collectives
        # through `mesh` (the runner sets it); None: the whole model
        self.shard = shard
        self.mesh = None
        for name, shape in leaf_shapes(cfg).items():
            spec = sharding.leaf_spec(cfg, name)
            if int8 and is_quantized_name(name):
                # int8 from the start: the rank's w8 and scale buffers
                # only, never the leaf in cfg.dtype
                sshape = scale_shape(name, shape)
                if shard is not None:
                    sshape = sharding.local_shape(
                        sshape, sharding.scale_spec(spec, name == "embed"),
                        shard)
                    shape = sharding.local_shape(shape, spec, shard)
                setattr(self, name, QuantizedWeight(
                    torch.empty(shape, dtype=torch.int8, device=device),
                    torch.empty(sshape, dtype=torch.float32,
                                device=device)))
                continue
            if shard is not None:
                shape = sharding.local_shape(shape, spec, shard)
            self.register_parameter(name, nn.Parameter(
                torch.empty(shape, dtype=cfg.dtype, device=device),
                requires_grad=False))


def leaf_shapes(cfg: ModelConfig) -> dict:
    """name -> full shape of every leaf, in init_params' draw order."""
    h, i, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    nh, nkv, hd, L = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_,
                      cfg.num_layers)
    shapes = {
        "embed": (v, h), "attn_norm": (L, h), "q": (L, h, nh * hd),
        "k": (L, h, nkv * hd), "v": (L, h, nkv * hd),
        "o": (L, nh * hd, h), "mlp_norm": (L, h),
    }
    # insertion order is init_params' draw order: a dense model's
    # leaves keep the order they had before the other families
    E = cfg.num_experts
    if E:
        mi = cfg.moe_intermediate_size or i
        shapes.update({"gate": (L, E, h, mi), "up": (L, E, h, mi),
                       "down": (L, E, mi, h), "router": (L, h, E)})
        if cfg.shared_expert_size:
            si = cfg.shared_expert_size
            shapes.update({"s_gate": (L, h, si), "s_up": (L, h, si),
                           "s_down": (L, si, h), "s_gate_w": (L, h, 1)})
    else:
        shapes.update({"gate": (L, h, i), "up": (L, h, i),
                       "down": (L, i, h)})
    shapes["final_norm"] = (h,)
    if cfg.sandwich_norms:
        shapes["post_attn_norm"] = shapes["post_mlp_norm"] = (L, h)
    if cfg.attention_bias:
        shapes.update({"q_bias": (L, nh * hd), "k_bias": (L, nkv * hd),
                       "v_bias": (L, nkv * hd)})
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (h, v)
    return shapes


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", shard=None, int8: bool = False) -> Llama:
    """Random init (normal 0.02) in cfg.dtype, drawn from `generator`
    (which must live on `device`) one layer at a time so the f32 draw
    never holds more than one layer's matrix. Norm gains are ones, or
    zeros where they are stored around an implicit 1 (rms_norm_offset),
    as in the JAX init. Attention biases are drawn like the matrices
    (the JAX init zeroes them), so a random model exercises them.
    shard: a rank's coordinates; every layer is drawn whole, as the
    unsharded init draws it, and only the rank's slice is kept, so each
    rank holds its block of the very weights a single device would.
    int8: the weight-only int8 model (models/quant.py), built a layer at
    a time: each layer (the embedding and the head whole) is drawn and
    rounded to cfg.dtype as above, then quantized whole (put_leaf)
    before the next is drawn, and a rank keeps its slice of w8 and
    scale; no leaf exists whole in cfg.dtype. The
    generator is consumed in the same order, so the weights are bit for
    bit quantize_params(init_params(...)) and, under a shard,
    sharding.shard_params of that (a row-parallel scale reduces over
    the axis tp cuts, hence the whole-layer quantization)."""
    model = Llama(cfg, device=device, shard=shard, int8=int8)
    for name, shape in leaf_shapes(cfg).items():
        if name in NORM_KEYS:
            getattr(model, name).fill_(0.0 if cfg.rms_norm_offset else 1.0)
            continue
        layered = name in LAYER_KEYS
        for l in (range(shape[0]) if layered else (None,)):
            # the f32 draw is freed once rounded
            w = torch.randn(shape[1:] if layered else shape,
                            generator=generator, device=device,
                            dtype=torch.float32).mul_(0.02).to(cfg.dtype)
            put_leaf(model, name, l, w)
    return model


@torch.no_grad()
def put_leaf(model: Llama, name: str, l: Optional[int],
             w: torch.Tensor) -> None:
    """Store `w`, the whole value in cfg.dtype of layer l of leaf `name`
    (l None: the whole leaf, as the embedding or the head), into
    `model`: quantized where the leaf is int8 (quant.quantize_into) and
    cut to the rank's slice under a shard — an int8 leaf quantized
    whole first, so a row-parallel scale reduces over the axis tp cuts
    and the rank keeps its slice of w8 and scale."""
    leaf, shard = getattr(model, name), model.shard
    spec = sharding.leaf_spec(model.cfg, name)[0 if l is None else 1:]
    if not isinstance(leaf, QuantizedWeight):
        if shard is not None:
            w = sharding.slice_spec(w, spec, shard, name)
        (leaf if l is None else leaf[l]).copy_(w)
        return
    dst = Int8Weight(leaf.w8, leaf.scale) if l is None else leaf[l]
    if shard is None:
        quantize_into(name, w, dst.w8, dst.scale)
        return
    whole = Int8Weight(
        torch.empty(w.shape, dtype=torch.int8, device=w.device),
        torch.empty(scale_shape(name, w.shape), dtype=torch.float32,
                    device=w.device))
    quantize_into(name, w, whole.w8, whole.scale)
    part = sharding.shard_leaf(whole, spec, shard, per_row=name == "embed",
                               what=name)
    dst.w8.copy_(part.w8)
    dst.scale.copy_(part.scale)


def _tp(model: Llama) -> int:
    return model.shard.tp if model.shard is not None else 1


def _reduce(model: Llama, t: torch.Tensor, axis: str = "tp") -> torch.Tensor:
    """A rank's partial sum summed over `axis` (a whole model: t)."""
    return t if model.mesh is None else model.mesh.all_reduce(t, axis)


def _enter(model: Llama, t: torch.Tensor) -> torch.Tensor:
    """The replicated activation ahead of the column-parallel products:
    itself in the forward; a training world sums its gradient, each
    rank's partial from its own heads or features, over tp."""
    return t if model.mesh is None else model.mesh.copy_to_tp(t)


def layer_params(model: Llama) -> List["_Layer"]:
    """Every layer's weights, read as lp[name] (an int8 leaf's layer an
    Int8Weight): each stacked tensor is split once (unbind), so the
    backward stacks a leaf's layer gradients once, where indexing each
    layer (select) would add a zero-filled gradient of the whole [L, ...]
    leaf per layer. A leaf that is neither a tensor nor an int8 leaf
    (anything indexable by layer) is indexed when the layer reads it."""
    cols = {}
    for name in LAYER_KEYS:
        leaf = getattr(model, name, None)
        if isinstance(leaf, torch.Tensor):
            cols[name] = leaf.unbind(0)
        elif isinstance(leaf, QuantizedWeight):
            cols[name] = [Int8Weight(w8, s) for w8, s in
                          zip(leaf.w8.unbind(0), leaf.scale.unbind(0))]
        elif leaf is not None:
            cols[name] = leaf
    return [_Layer(cols, l) for l in range(model.cfg.num_layers)]


class _Layer:
    """Layer l of every stacked leaf (layer_params)."""

    def __init__(self, cols: Dict[str, object], l: int):
        self._cols, self._l = cols, l

    def __getitem__(self, name: str):
        return self._cols[name][self._l]


def _layer(cfg: ModelConfig, model: Llama, l: int, lp: "_Layer",
           x: torch.Tensor, rows: Tuple[torch.Tensor, torch.Tensor], starts,
           cache: KVCache, block_tables, nb: int,
           addresses: Tuple[torch.Tensor, torch.Tensor], lora=None,
           valid: Optional[torch.Tensor] = None, view_tables=None):
    """One transformer block (lp: layer l's weights, layer_params) over
    the paged pool; rows = this chunk's rope rows and addresses = its KV
    write addresses (on this rank's part of the pool), both shared by
    every layer. The chunk's K/V are written first, then the paged
    kernels attend: over the pool through block_tables, or, on a pool
    whose blocks dp splits, over the layer's blocks assembled from every
    dp rank through view_tables (pa.assembled_tables). lora: (gathered
    factors, scaling) or None; valid: the chunk's token mask [B,T] (MoE
    routing), or None."""
    def paged(q, k, v):
        if cache.quantized:
            k_pool, k_scales = write_at_q(cache.k[l], cache.ks[l], k,
                                          *addresses)
            v_pool, v_scales = write_at_q(cache.v[l], cache.vs[l], v,
                                          *addresses)
        else:
            k_pool = write_at(cache.k[l], k, *addresses)
            v_pool = write_at(cache.v[l], v, *addresses)
            k_scales = v_scales = None
        tables = block_tables
        if cache.dp > 1:
            k_pool, v_pool, k_scales, v_scales = assemble_blocks(
                cache, l, block_tables, nb, model.mesh)
            tables = view_tables
        scales = ({} if k_scales is None
                  else dict(k_scales=k_scales, v_scales=v_scales))
        kw = dict(nb=nb, scale=attn_scale(cfg), window=layer_window(cfg, l),
                  softcap=cfg.attn_logit_softcap or 0.0, **scales)
        if model.shard is not None:
            return pa.paged_attention_sharded(
                q, k_pool, v_pool, tables, starts, model.shard,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, **kw)
        attn_fn = (pa.paged_decode_attention if q.shape[1] <= pa.DECODE_T_MAX
                   else pa.paged_attention)
        return attn_fn(q, k_pool, v_pool, tables, starts, **kw)
    return _block(cfg, model, l, lp, x, rows, paged, lora, valid)


def _block(cfg: ModelConfig, model: Llama, l: int, lp: "_Layer",
           x: torch.Tensor, rows: Tuple[torch.Tensor, torch.Tensor], attend,
           lora=None, valid: Optional[torch.Tensor] = None):
    """Layer l (its weights lp, layer_params) on the residual stream x
    [B,T,H]: attend(q, k, v) -> [B,T,nh,hd] is the attention (the paged kernels in serving, the
    plain causal attention in encode). lora: (factors gathered for the
    batch's rows, scaling), whose deltas join each targeted product;
    valid [B,T] bool marks real tokens, which alone route to experts and
    take their capacity (None: every token)."""
    B, T, _ = x.shape
    # a tp rank's heads: H / tp q heads over Hkv / tp kv heads
    tp = _tp(model)
    nh, nkv, hd = cfg.num_heads // tp, cfg.num_kv_heads // tp, cfg.head_dim_
    eps = cfg.rms_norm_eps
    off = 1.0 if cfg.rms_norm_offset else 0.0

    def proj(h, name):
        out = dequant_matmul(h, lp[name])
        if cfg.attention_bias and name in ("q", "k", "v"):
            # Qwen2: the bias comes before the adapter's delta
            out = out + lp[name + "_bias"]
        if lora is not None and name in lora[0]:
            a, b = lora[0][name]
            out = lora_mod.apply(h, out, a[l], b[l], lora[1])
        return out

    hidden = _enter(model, rms_norm(x, lp["attn_norm"], eps, off))
    q = rotate(proj(hidden, "q").reshape(B, T, nh, hd), *rows)
    k = rotate(proj(hidden, "k").reshape(B, T, nkv, hd), *rows)
    v = proj(hidden, "v").reshape(B, T, nkv, hd)
    attn = attend(q, k, v)
    # row-parallel: the rank's partial sum (its adapter delta included)
    # is summed over tp before the norm and the residual
    o_out = _reduce(model, proj(attn.reshape(B, T, nh * hd), "o"))
    if cfg.sandwich_norms:
        o_out = rms_norm(o_out, lp["post_attn_norm"], eps, off)
    x = x + o_out
    hidden = _enter(model, rms_norm(x, lp["mlp_norm"], eps, off))
    if cfg.num_experts:
        return x + _moe_block(cfg, model, lp, hidden, valid)
    act = activation(cfg)
    mlp_out = _reduce(model, proj(act(proj(hidden, "gate"))
                                  * proj(hidden, "up"), "down"))
    if cfg.sandwich_norms:
        mlp_out = rms_norm(mlp_out, lp["post_mlp_norm"], eps, off)
    return x + mlp_out


def _moe_block(cfg: ModelConfig, model: Llama, lp: "_Layer",
               hidden: torch.Tensor,
               valid: Optional[torch.Tensor]) -> torch.Tensor:
    """The MoE MLP of a layer (its weights lp) on the normed stream
    hidden [B,T,H] (JAX llama.py:247-270): the routed experts over all B*T tokens at once,
    exact at T == 1 (a decode step must never drop a live token), plus
    Qwen2-MoE's shared expert scaled by sigmoid(hidden @ s_gate_w)."""
    B, T, H = hidden.shape
    act = activation(cfg)
    # a rank applies its E / ep experts (their inner dimension over tp)
    # and the shared expert's tp slice; the partials are summed over the
    # world once, the shared expert's by the first ep slice only, so it
    # is counted once, not ep times
    ep_rank, _ = (model.shard.axis("ep") if model.shard is not None
                  else (0, 1))
    gate = lp["gate"]
    n_local = (gate.w8 if is_quantized(gate) else gate).shape[0]
    y = moe.moe_mlp(
        hidden.reshape(B * T, H), lp["router"], gate,
        lp["up"], lp["down"], top_k=cfg.num_experts_per_tok,
        capacity_factor=cfg.moe_capacity_factor, act=act,
        valid=None if valid is None else valid.reshape(B * T),
        renormalize=cfg.norm_topk_prob,
        exact=True if T == 1 else None,
        first_expert=ep_rank * n_local).reshape(B, T, H)
    if cfg.shared_expert_size and ep_rank == 0:
        shared = dequant_matmul(
            act(dequant_matmul(hidden, lp["s_gate"]))
            * dequant_matmul(hidden, lp["s_up"]), lp["s_down"])
        y = y + torch.sigmoid(hidden @ lp["s_gate_w"]) * shared
    return _reduce(model, y, "world")


def forward(model: Llama, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: KVCache,
            block_tables: Optional[torch.Tensor] = None,
            rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            kv_len: Optional[int] = None,
            token_valid: Optional[torch.Tensor] = None,
            last_index: Optional[torch.Tensor] = None,
            sampled_ids: bool = False,
            lora_rows: Optional[lora_mod.Rows] = None,
            lora_scaling: float = 1.0
            ) -> Tuple[torch.Tensor, KVCache]:
    """Incremental forward. tokens/positions [B,T] -> (logits f32
    [B,T,V], cache), the cache updated in place.

    block_tables [B, MB] int32 map each row's virtual positions to pool
    blocks (None = identity tables over a make_slot_cache pool).
    positions[b] are contiguous from the row's current length. kv_len
    bounds attention to the first ceil(kv_len/Bs) blocks; every real
    query position must be < kv_len. token_valid [B,T] marks real
    tokens: the others write to the trash block. last_index [B] (torch
    addition) computes logits only at one position per row, giving
    [B,1,V] — the serving runner needs no more than that.
    rope: (cos, sin) device tensors; None builds them from the config.
    sampled_ids: the tokens are the sampler's own output, so in
    [0, V) already and the embedding skips the index rule (_embed).
    lora_rows: the adapter factors gathered for the B rows' adapter ids
    (lora.gather_rows; JAX passes the stack and the ids) and
    lora_scaling = alpha / rank; None runs the base model.
    """
    x = hidden(model, cfg, tokens, positions, cache, block_tables, rope,
               kv_len, token_valid, sampled_ids, lora_rows, lora_scaling)
    if last_index is not None:
        x = torch.gather(x, 1, last_index.long()[:, None, None].expand(
            -1, 1, x.shape[-1]))
    return final_logits(model, cfg, x), cache


def hidden(model: Llama, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor, cache: KVCache,
           block_tables: Optional[torch.Tensor] = None,
           rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           kv_len: Optional[int] = None,
           token_valid: Optional[torch.Tensor] = None,
           sampled_ids: bool = False,
           lora_rows: Optional[lora_mod.Rows] = None,
           lora_scaling: float = 1.0) -> torch.Tensor:
    """forward() up to the last layer: the residual stream [B,T,H]
    before the final norm, the cache updated in place."""
    device = tokens.device
    if rope is None:
        rope = rope_tensors(cfg, cfg.max_position_embeddings, device)
    B = tokens.shape[0]
    Bs = cache.block_size
    if block_tables is None:
        n_per = (cache.num_blocks - 1) // B
        block_tables = linear_tables(B, n_per * Bs, Bs, device=device)
    MB = block_tables.shape[1]
    nb = MB if kv_len is None else min(-(-kv_len // Bs), MB)
    starts = positions[:, 0].to(torch.int32).contiguous()
    rows = rope_rows(positions, *rope)
    blk, off = chunk_addresses(block_tables, positions, Bs, token_valid)
    # on a pool that dp splits: this rank's local blocks, the scratch
    # block for the blocks other dp ranks own (a whole pool: blk itself)
    addresses = (owned(cache, blk)[0], off)
    view_tables = (pa.assembled_tables(B, nb, MB, device) if cache.dp > 1
                   else None)
    x = _embed(model, cfg, tokens, sampled_ids)
    lora = None if lora_rows is None else (lora_rows, lora_scaling)
    # cfg's layers: a reference may run the first layers of a model
    for l, lp in enumerate(layer_params(model)[:cfg.num_layers]):
        x = _layer(cfg, model, l, lp, x, rows, starts, cache, block_tables,
                   nb, addresses, lora, token_valid, view_tables)
    return x


def final_logits(model: Llama, cfg: ModelConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """f32 logits [B,T,V] of the residual stream [B,T,H]: the final
    norm, then the LM head."""
    x = rms_norm(x, model.final_norm, cfg.rms_norm_eps,
                 1.0 if cfg.rms_norm_offset else 0.0)
    return _lm_head(model, cfg, x)


def encode(model: Llama, cfg: ModelConfig, tokens: torch.Tensor,
           rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
           token_valid: Optional[torch.Tensor] = None,
           attention_fn=None, offset: int = 0) -> torch.Tensor:
    """Full-sequence causal forward without the LM head (JAX
    ``llama.encode``): the final-normed hidden states [B,T,H] of tokens
    [B,T] at positions offset..offset+T-1, no cache. The pooling routes
    mean-pool them (runner.embed); forward_train puts the head on top.
    Attention is ops/attention.causal_attention, plain PyTorch with the
    window and Gemma-2's softcap, as the JAX encode never reaches a
    Pallas kernel; attention_fn(q, k, v) replaces
    it when given (JAX's override: ring attention over a sequence split
    over sp, whose block starts at offset). token_valid [B,T] marks the
    real tokens of right-padded rows: a pad after the real tokens cannot
    reach them through causal attention, but on a MoE model it would
    route and take expert capacity, so the mask keeps it out of both."""
    device = tokens.device
    if rope is None:
        rope = rope_tensors(cfg, cfg.max_position_embeddings, device)
    B, T = tokens.shape
    positions = (offset + torch.arange(T, device=device))[None].expand(B, T)
    rows = rope_rows(positions, *rope)
    scale = attn_scale(cfg)
    x = _embed(model, cfg, tokens)
    for l, lp in enumerate(layer_params(model)[:cfg.num_layers]):
        def attend(q, k, v, w=layer_window(cfg, l)):
            if attention_fn is not None:
                return attention_fn(q, k, v)
            return causal_attention(q, k, v, scale=scale, sliding_window=w,
                                    logit_softcap=cfg.attn_logit_softcap)
        x = _block(cfg, model, l, lp, x, rows, attend, valid=token_valid)
    return rms_norm(x, model.final_norm, cfg.rms_norm_eps,
                    1.0 if cfg.rms_norm_offset else 0.0)


def forward_train(model: Llama, cfg: ModelConfig, tokens: torch.Tensor,
                  rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  attention_fn=None, offset: int = 0) -> torch.Tensor:
    """Full-sequence causal forward without a cache (JAX
    ``llama.forward_train``): tokens [B,T] -> f32 logits [B,T,V], the LM
    head on encode. Differentiable where the model's leaves require
    gradients (parallel/train.py); int8 leaves take none."""
    return _lm_head(model, cfg, encode(model, cfg, tokens, rope=rope,
                                       attention_fn=attention_fn,
                                       offset=offset))


def _embed(model: Llama, cfg: ModelConfig, tokens: torch.Tensor,
           sampled_ids: bool = False) -> torch.Tensor:
    """Embedding rows of `tokens`, bf16 and int8 tables alike. Ids from
    outside (a prompt) take the JAX gather's index rule on the device:
    ids >= V read row V-1, ids in [-V, 0) wrap, ids below -V read row 0
    (clamped to [-V, V-1], the wrap is a remainder by V). Sampled ids
    are in range and skip the two launches."""
    ids = tokens.long()
    if not sampled_ids:
        V = cfg.vocab_size
        ids = torch.remainder(torch.clamp(ids, -V, V - 1), V)
    tp = _tp(model)
    if tp > 1:
        # vocab-parallel: the rank looks up the ids of its vocabulary
        # block, zeros elsewhere, and the sum over tp is exact (one
        # rank's row plus zeros)
        Vl = cfg.vocab_size // tp
        local = ids - model.shard.tp_rank * Vl
        inside = (local >= 0) & (local < Vl)
        x = dequant_rows(model.embed, local.clamp(0, Vl - 1), cfg.dtype)
        x = _reduce(model, torch.where(inside[..., None], x,
                                       torch.zeros((), dtype=x.dtype,
                                                   device=x.device)))
    else:
        x = dequant_rows(model.embed, ids, cfg.dtype)
    if cfg.embed_scale:
        # Gemma: sqrt(hidden) in f32, then cast, as the JAX forward does
        # (HF multiplies in bf16)
        x = x.float() * math.sqrt(cfg.hidden_size)
    return x.to(cfg.dtype)


def _lm_head(model: Llama, cfg: ModelConfig,
             x: torch.Tensor) -> torch.Tensor:
    """f32 logits [B,T,V] from bf16 or f32 activations: the product
    accumulates in f32 and is not rounded to bf16 (the JAX einsum's
    preferred_element_type=f32); an int8 head is converted to x's dtype
    for the product and its per-vocab scale multiplies the f32 logits
    (tied or untied, JAX llama.py:427-450); Gemma-2's final softcap
    applies to the f32 logits last."""
    w = model.embed if cfg.tie_word_embeddings else model.lm_head
    vocab_scale = None
    if is_quantized(w):
        w, vocab_scale = w.w8.to(x.dtype), w.scale
    head = w.t() if cfg.tie_word_embeddings else w
    B, T, H = x.shape
    # the vocab-parallel head is a column-parallel product
    x2 = _enter(model, x).reshape(B * T, H)
    if x.dtype == torch.float32:
        logits = x2 @ head.float()
    elif x.is_cuda:
        logits = _HeadF32.apply(x2, head)
    else:
        # CPU has no mixed-precision mm: bf16 products are exact in f32
        logits = x2.float() @ head.float()
    if vocab_scale is not None:
        logits = logits * vocab_scale
    if _tp(model) > 1:
        # vocab-parallel head: every rank gathers the [B*T, V] f32
        # logits of all vocabulary blocks, so all hold the same bytes
        logits = model.mesh.all_gather(logits, dim=-1)
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = cap * torch.tanh(logits / cap)
    return logits.reshape(B, T, -1)


class _HeadF32(torch.autograd.Function):
    """x2 [N, H] @ head [H, V] of bf16 inputs into f32 logits: torch.mm's
    out_dtype, which has no derivative. The backward's two products take
    the f32 gradient rounded to the inputs' dtype and accumulate in
    f32, as the forward does."""

    @staticmethod
    def forward(ctx, x2, head):
        ctx.save_for_backward(x2, head)
        return torch.mm(x2, head, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x2, head = ctx.saved_tensors
        g = g.to(x2.dtype)
        return (torch.mm(g, head.t()) if ctx.needs_input_grad[0] else None,
                torch.mm(x2.t(), g) if ctx.needs_input_grad[1] else None)


def rope_tensors(cfg: ModelConfig, max_positions: int,
                 device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) as device tensors for a cache of max_positions."""
    cos, sin = rope_table(max_positions, cfg.head_dim_, cfg.rope_theta,
                          scaling=cfg.rope_scaling)
    return (torch.from_numpy(np.ascontiguousarray(cos)).to(device),
            torch.from_numpy(np.ascontiguousarray(sin)).to(device))
