"""PartitionSpecs of the stacked-params Llama module and the slices they
give each rank (``production_stack_tpu/parallel/sharding.py``).

The rules are the JAX package's, kept as data under the same names so
the two files read side by side: a spec names, per array axis, the mesh
axis it is split over (None: whole on every rank).

- Column-parallel projections (q/k/v/gate/up, and the q/k/v biases)
  split their output features over ``tp``; row-parallel ones (o/down)
  their input features, so each layer's attention and MLP end in one
  all-reduce over tp (models/llama.py).
- ``embed`` is split on vocabulary rows and ``lm_head`` on vocabulary
  columns; norms are replicated.
- MoE: the router is replicated (every rank routes every token), the
  expert stacks split E over ``ep`` and their inner dimension over
  ``tp``, the shared expert is an ordinary tp-sharded MLP with a
  replicated scalar gate.
- The KV pool ``[L, N, Hkv, Bs, D]`` splits its blocks over dp and its
  kv heads over tp (``cache_pspec``); the int8 pool's scales ``[L, N,
  Hkv, Bs]`` follow (``cache_scale_pspec``). N is padded up to a
  multiple of dp (``padded_blocks``, JAX ``runner.py:89-91``). Weights
  and adapters name no dp axis: every dp replica holds them whole (cut
  over tp and ep only), and the tables are replicated.

Where JAX places a full array with ``jax.device_put`` and a
NamedSharding, ``slice_spec`` cuts the rank's block of each split axis:
the same contiguous block a device holds in JAX (axis size / axis
length, in mesh order), so a rank's slice equals the JAX per-device
shard of the same array bit for bit. An int8 leaf ({w8, scale},
models/quant.py) keeps the weight's spec on w8 and drops the reduced
axis from its scale (``_qspec``): quantization happens on the full
weight, before the cut, so a row-parallel weight's scale stays whole.

LoRA (JAX replicates the adapters): a column-parallel target's B factor
is cut on its output features and a row-parallel target's A factor on
its input features (``_LORA_SPECS``), so each rank's delta joins its own
output slice or its own partial sum.
"""

from typing import Any, Dict, Optional, Tuple

import torch

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.kv import KVCache
from production_stack_tpu_torch.models.quant import (Int8Weight,
                                                     QuantizedWeight,
                                                     is_quantized)
from production_stack_tpu_torch.parallel.mesh import AXES, Shard
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


def P(*axes: Optional[str]) -> Tuple[Optional[str], ...]:
    """A PartitionSpec: one mesh axis name (or None) per array axis."""
    return tuple(axes)


_LAYER_SPECS: Dict[str, tuple] = {
    # [L, in, out] column-parallel: shard out over tp
    "q": P(None, None, "tp"),
    "k": P(None, None, "tp"),
    "v": P(None, None, "tp"),
    "gate": P(None, None, "tp"),
    "up": P(None, None, "tp"),
    # [L, in, out] row-parallel: shard in over tp
    "o": P(None, "tp", None),
    "down": P(None, "tp", None),
    # column-parallel biases [L, out] follow their projection's out shard
    "q_bias": P(None, "tp"),
    "k_bias": P(None, "tp"),
    "v_bias": P(None, "tp"),
    # norms replicated (incl. Gemma-2's sandwich norms)
    "attn_norm": P(None, None),
    "mlp_norm": P(None, None),
    "post_attn_norm": P(None, None),
    "post_mlp_norm": P(None, None),
}


_MOE_SPECS: Dict[str, tuple] = {
    # router [L, h, E] replicated: every rank routes every token
    "router": P(None, None, None),
    # expert-stacked FFN: experts over ep, hidden features over tp —
    # column-parallel gate/up ([L, E, h, i] shard i), row-parallel down
    # ([L, E, i, h] shard i)
    "gate": P(None, "ep", None, "tp"),
    "up": P(None, "ep", None, "tp"),
    "down": P(None, "ep", "tp", None),
    # Qwen2-MoE shared expert: an ordinary dense MLP, megatron-sharded
    # over tp; its scalar sigmoid gate is replicated
    "s_gate": P(None, None, "tp"),
    "s_up": P(None, None, "tp"),
    "s_down": P(None, "tp", None),
    "s_gate_w": P(None, None, None),
}

# LoRA factors of one stack {proj: {a: [N+1, L, in, r], b: [N+1, L, r,
# out]}}: B cut on out for column-parallel targets, A on in for
# row-parallel ones
_LORA_SPECS: Dict[str, Dict[str, tuple]] = {
    **{name: {"a": P(None, None, None, None), "b": P(None, None, None, "tp")}
       for name in ("q", "k", "v", "gate", "up")},
    **{name: {"a": P(None, None, "tp", None), "b": P(None, None, None, None)}
       for name in ("o", "down")},
}


def scale_spec(spec: tuple, per_row: bool = False) -> tuple:
    """The spec of an int8 leaf's scale, given its weight's: the reduced
    axis dropped — the in axis (-2) for per-output-channel weights, the
    last axis for the per-row embed table."""
    return P(*spec[:-1]) if per_row else P(*spec[:-2], spec[-1])


def _qspec(leaf: Any, spec: tuple, per_row: bool = False) -> Any:
    """Expand a weight's spec for int8-quantized leaves (models/quant.py
    {w8, scale}): w8 keeps the weight's spec, scale takes scale_spec."""
    if not is_quantized(leaf):
        return spec
    return {"w8": spec, "scale": scale_spec(spec, per_row)}


def layer_specs(cfg: ModelConfig) -> Dict[str, tuple]:
    """The per-layer leaves' specs of a model: the MoE rules override
    the dense ones on a model with experts."""
    return dict(_LAYER_SPECS, **_MOE_SPECS) if cfg.num_experts \
        else _LAYER_SPECS


def param_pspecs(model) -> Dict[str, Any]:
    """PartitionSpec tree of a ``Llama`` module, in the JAX params
    layout: {"embed", "layers": {name: spec}, "final_norm",
    ["lm_head"]}, an int8 leaf's spec a {w8, scale} dict."""
    specs_l = layer_specs(model.cfg)
    leaves = dict(model.named_children(), **dict(model.named_parameters()))
    specs: Dict[str, Any] = {
        "embed": _qspec(leaves["embed"], P("tp", None), per_row=True),
        "layers": {name: _qspec(leaf, specs_l[name])
                   for name, leaf in leaves.items()
                   if name in specs_l},
        "final_norm": P(None),
    }
    if "lm_head" in leaves:
        specs["lm_head"] = _qspec(leaves["lm_head"], P(None, "tp"))
    return specs


def leaf_spec(cfg: ModelConfig, name: str) -> tuple:
    """The spec of one leaf of the flat module by its name (a weight's
    own spec; an int8 leaf's w8 takes it unchanged)."""
    if name == "embed":
        return P("tp", None)
    if name == "lm_head":
        return P(None, "tp")
    if name == "final_norm":
        return P(None)
    return layer_specs(cfg)[name]


def _block(n: int, index: int, size: int, what: str) -> slice:
    if n % size:
        raise ValueError(f"{what}: axis of {n} does not split over "
                         f"{size} ranks")
    step = n // size
    return slice(index * step, (index + 1) * step)


def slice_spec(t: torch.Tensor, spec: tuple, shard: Shard,
               what: str = "tensor") -> torch.Tensor:
    """This rank's block of a full array under `spec` (a view)."""
    if len(spec) != t.dim():
        raise ValueError(f"{what}: spec {spec} for a {t.dim()}-d array")
    index = []
    for n, axis in zip(t.shape, spec):
        i, size = shard.axis(axis)
        index.append(_block(n, i, size, what) if size > 1 else slice(None))
    return t[tuple(index)]


def local_shape(shape: Tuple[int, ...], spec: tuple,
                shard: Shard) -> Tuple[int, ...]:
    """The shape of this rank's block of an array of `shape`."""
    return tuple(n // shard.axis(axis)[1] for n, axis in zip(shape, spec))


def shard_leaf(leaf, spec: tuple, shard: Shard, per_row: bool = False,
               what: str = "leaf"):
    """This rank's copy of one leaf: a tensor, or an int8 leaf whose
    w8 takes `spec` and whose scale takes _qspec's (contiguous copies, so
    the full leaf can be freed)."""
    if is_quantized(leaf):
        q = _qspec(leaf, spec, per_row)
        return Int8Weight(
            slice_spec(leaf.w8, q["w8"], shard, what).contiguous(),
            slice_spec(leaf.scale, q["scale"], shard, what).contiguous())
    return slice_spec(leaf, spec, shard, what).contiguous()


def shard_params(model, shard: Shard):
    """A new ``Llama`` module holding this rank's slice of every leaf of
    `model` (quantized leaves sliced as _qspec says), with ``shard`` set.
    `model` is left as it is."""
    from production_stack_tpu_torch.models.llama import Llama
    cfg = model.cfg
    out = Llama(cfg, device=_device_of(model), shard=shard)
    with torch.no_grad():
        for name, leaf in _leaves(model):
            part = shard_leaf(leaf, leaf_spec(cfg, name), shard,
                              per_row=name == "embed", what=name)
            if isinstance(part, Int8Weight):
                delattr(out, name)
                setattr(out, name, QuantizedWeight(part.w8, part.scale))
            else:
                getattr(out, name).copy_(part)
    return out


def _leaves(model):
    """(name, leaf) of every weight of a Llama module, a quantized leaf
    as its whole Int8Weight."""
    for name, child in model.named_children():
        if isinstance(child, QuantizedWeight):
            yield name, Int8Weight(child.w8, child.scale)
    for name, p in model.named_parameters():
        yield name, p


def _device_of(model) -> torch.device:
    for t in (*model.parameters(), *model.buffers()):
        return t.device
    return torch.device("cpu")


def check_mesh(cfg: ModelConfig, tp: int, ep: int, dp: int = 1,
               device: Optional[torch.device] = None,
               dp_gather_attention_ok: bool = False) -> None:
    """The JAX engine's refusals of a serving mesh (runner.py:113-147,
    engine.py:133-145), with its messages. A mesh whose dp > 1 splits
    the pool's blocks serves on the gathered view (each layer's blocks
    assembled over dp before the kernels read them, models/kv.py): on
    the card, where the kernels would otherwise read the pool in place,
    it is refused unless dp_gather_attention_ok acknowledges it (then
    one warning); on the CPU, where the plain versions run, it is a
    warning only, as JAX warns where its kernel is off. An ep slice is
    a full replica of the attention, so ep alone keeps the kernels."""
    if dp > 1:
        shape = dict(zip(AXES, (1, dp, 1, ep, tp)))
        cliff = (
            f"serving mesh {shape} shards the KV pool's block axis: the "
            f"paged-attention kernels read a rank's own blocks only, so "
            f"this config serves on the gathered-view path (each layer's "
            f"blocks assembled over dp, ~3x decode KV traffic). Prefer "
            f"tp-only serving meshes with replicaCount for data "
            f"parallelism.")
        if device is None or device.type != "cuda":
            logger.warning("paged-attention kernels do not run on the "
                           "CPU: " + cliff)
        elif dp_gather_attention_ok:
            logger.warning("dp_gather_attention_ok=True: " + cliff)
        else:
            raise ValueError(cliff + " Set dp_gather_attention_ok=True to "
                             "serve on the gather path anyway.")
    if cfg.num_kv_heads % tp:
        raise ValueError(
            f"tensor_parallel_size {tp} must divide num_kv_heads "
            f"{cfg.num_kv_heads} (KV-head replication is not "
            f"implemented yet)")
    if ep > 1:
        if not cfg.num_experts:
            raise ValueError(
                f"expert_parallel_size={ep} but model {cfg.name!r} is "
                f"dense (no experts)")
        if cfg.num_experts % ep:
            raise ValueError(
                f"expert_parallel_size={ep} does not divide "
                f"num_experts={cfg.num_experts}")


def padded_blocks(num_blocks: int, dp: int) -> int:
    """The pool's block count padded up to a multiple of dp, as the JAX
    runner pads it; the extra blocks are allocatable (the engine sizes
    its block manager from the pool)."""
    return -(-num_blocks // dp) * dp


def cache_pspec() -> tuple:
    """KV pool [L, N, Hkv, Bs, D]: blocks over dp, kv heads over tp."""
    return P(None, "dp", "tp", None, None)


def cache_scale_pspec() -> tuple:
    """int8-KV dequant scales [L, N, Hkv, Bs]: same placement as the
    pool minus the head-dim axis (models/kv.py)."""
    return P(None, "dp", "tp", None)


def shard_cache(cache: KVCache, shard: Shard) -> KVCache:
    """This rank's part of a full pool (and of its scales): its Hkv / tp
    heads and, with dp > 1, its N / dp blocks (N a multiple of dp) and
    a zeroed scratch block after them (models/kv.py)."""
    def cut(t, spec):
        t = slice_spec(t, spec, shard, "kv pool")
        if shard.dp > 1:
            t = torch.cat([t, torch.zeros_like(t[:, :1])], dim=1)
        return t.contiguous()
    return KVCache(
        k=cut(cache.k, cache_pspec()), v=cut(cache.v, cache_pspec()),
        ks=None if cache.ks is None else cut(cache.ks, cache_scale_pspec()),
        vs=None if cache.vs is None else cut(cache.vs, cache_scale_pspec()),
        dp=shard.dp, dp_rank=shard.dp_rank)


def kv_heads(cfg: ModelConfig, shard: Optional[Shard]) -> int:
    """Kv heads a rank's pool holds: Hkv / tp."""
    return cfg.num_kv_heads // (shard.tp if shard is not None else 1)


def head_slice(shard: Shard, num_kv_heads: int) -> slice:
    """This rank's kv heads of a full [.., Hkv, D] chunk."""
    return _block(num_kv_heads, shard.tp_rank, shard.tp, "kv heads")


def shard_lora(stacked: Optional[Dict[str, Dict[str, torch.Tensor]]],
               shard: Shard):
    """This rank's factors of an adapter stack (_LORA_SPECS)."""
    if stacked is None:
        return None
    return {name: {k: slice_spec(ab[k], _LORA_SPECS[name][k], shard,
                                 f"lora {name}.{k}").contiguous()
                   for k in ("a", "b")}
            for name, ab in stacked.items()}
