"""Carry weights and KV state across from the JAX package.

Both take numpy arrays (the JAX params pytree after ``np.asarray`` on
every leaf), so this module imports neither JAX nor the JAX package.
bfloat16 leaves (``ml_dtypes.bfloat16`` in numpy) go through float32,
which is lossless both ways. The layouts are the same on both sides
(``[L, in, out]`` stacked weights, ``[L, N, Hkv, Bs, D]`` pools), so
carrying them is a copy, never a transpose. Leaves the JAX package
quantized (``{"w8": int8, "scale": f32}``, models/quant.py) and an int8
pool with its ``ks``/``vs`` scales come across bit for bit. A LoRA
adapter (``{proj: {"a": [L, in, r], "b": [L, r, out]}}``, models/lora.py)
keeps the JAX layout too, and so does the BERT encoder of the pooling
routes (models/encoder.py: the embeddings and ``{"layers": {...}}``
stacked on a leading layer axis).

``params_from_jax(..., shard=...)`` gives one rank of a ``tp x ep``
serving mesh its slice of every leaf (parallel/sharding.py), so one JAX
weight set feeds JAX's mesh engine and the port's ranks alike.

Training state goes both ways: ``opt_state_from_jax`` carries optax's
``ScaleByAdamState(count, mu, nu)`` into the port's AdamState
(parallel/train.py), and ``to_jax`` lays any {leaf name: tensor} of the
port (parameters, gradients, moments) out as JAX's pytree of numpy
float32 arrays, so the two can be compared leaf by leaf.
"""

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models import lora as lora_mod
from production_stack_tpu_torch.models.encoder import (EMBED_KEYS, Encoder,
                                                       EncoderConfig)
from production_stack_tpu_torch.models.kv import KVCache
from production_stack_tpu_torch.models.llama import LAYER_KEYS, Llama
from production_stack_tpu_torch.models.quant import QuantizedWeight
from production_stack_tpu_torch.parallel import sharding
from production_stack_tpu_torch.parallel.train import AdamState
from production_stack_tpu_torch.utils import resolve_device


def _tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(x)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return torch.from_numpy(
        np.ascontiguousarray(arr.astype(np.float32))).to(
            device=device, dtype=dtype)


def params_from_jax(np_params: Mapping, cfg: ModelConfig,
                    device="cuda", shard=None) -> Llama:
    """The JAX params pytree ({"embed", "layers": {...}, "final_norm",
    ["lm_head"]}, numpy leaves; the layers carry post_attn_norm and
    post_mlp_norm with sandwich norms, q_bias/k_bias/v_bias with
    attention biases, router and the [L, E, ...] expert stacks with
    experts, s_gate/s_up/s_down/s_gate_w with a shared expert) as the
    port's Llama module in cfg.dtype on `device`. A quantized leaf
    ({"w8", "scale"}, an expert stack's scale [L, E, out]) replaces its
    parameter with a QuantizedWeight of the same int8 and f32 values.
    shard (parallel/mesh.Shard): the rank's slice of every leaf
    instead."""
    model = Llama(cfg, device=device)
    with torch.no_grad():
        for name, p in list(model.named_parameters()):
            src = (np_params["layers"][name] if name in LAYER_KEYS
                   else np_params[name])
            quant = isinstance(src, Mapping) and "w8" in src
            shape = np.shape(src["w8"] if quant else src)
            if tuple(shape) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {shape} != "
                                 f"port shape {tuple(p.shape)}")
            if quant:
                delattr(model, name)
                setattr(model, name, QuantizedWeight(
                    _tensor(src["w8"], torch.int8, device),
                    _tensor(src["scale"], torch.float32, device)))
            else:
                p.copy_(_tensor(src, cfg.dtype, device))
    return model if shard is None else sharding.shard_params(model, shard)


def encoder_params_from_jax(np_params: Mapping, cfg: EncoderConfig,
                            device="cuda") -> Encoder:
    """The JAX encoder's params ({"word_emb", "pos_emb", "type_emb",
    "emb_ln_w", "emb_ln_b", "layers": {...}}, numpy leaves) as the
    port's Encoder in cfg.dtype on `device`, every shape checked."""
    model = Encoder(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            src = np_params[name] if name in EMBED_KEYS \
                else np_params["layers"][name]
            if tuple(np.shape(src)) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {np.shape(src)} != "
                                 f"port shape {tuple(p.shape)}")
            p.copy_(_tensor(src, cfg.dtype, device))
    return model


def adapter_from_jax(np_adapter: Mapping, cfg: ModelConfig,
                     device="cuda") -> lora_mod.Adapter:
    """One JAX adapter ({proj: {"a", "b"}}, numpy leaves) as the port's
    in cfg.dtype on `device`, each projection's shapes checked against
    the model's ([L, in, r] and [L, r, out], one rank)."""
    device = resolve_device(device)
    dims = lora_mod._proj_dims(cfg)
    lora_mod._check_targets(cfg, tuple(np_adapter), dims)
    out: lora_mod.Adapter = {}
    for name, ab in np_adapter.items():
        a, b = np.asarray(ab["a"]), np.asarray(ab["b"])
        d_in, d_out = dims[name]
        L, r = cfg.num_layers, a.shape[-1]
        if a.shape != (L, d_in, r) or b.shape != (L, r, d_out):
            raise ValueError(
                f"adapter {name}: got a{a.shape} b{b.shape}, want "
                f"a{(L, d_in, r)} b{(L, r, d_out)}")
        out[name] = {"a": _tensor(a, cfg.dtype, device),
                     "b": _tensor(b, cfg.dtype, device)}
    return out


def cache_from_jax(k, v, tables=None, dtype: Optional[torch.dtype] = None,
                   device="cuda", ks=None, vs=None
                   ) -> Tuple[KVCache, Optional[torch.Tensor]]:
    """A JAX KVCache's k/v pools ([L, N, Hkv, Bs, D], numpy) and,
    optionally, its block tables ([B, MB]) as (KVCache, int32 tables)
    on `device`. dtype defaults to the pool's own (bf16 or f32); an int8
    pool comes with its scales ks/vs ([L, N, Hkv, Bs] f32)."""
    device = resolve_device(device)
    if np.asarray(k).dtype == np.int8:
        if ks is None or vs is None:
            raise ValueError("an int8 pool comes with its ks/vs scales")
        cache = KVCache(k=_tensor(k, torch.int8, device),
                        v=_tensor(v, torch.int8, device),
                        ks=_tensor(ks, torch.float32, device),
                        vs=_tensor(vs, torch.float32, device))
    else:
        if dtype is None:
            dtype = (torch.float32 if np.asarray(k).dtype == np.float32
                     else torch.bfloat16)
        cache = KVCache(k=_tensor(k, dtype, device),
                        v=_tensor(v, dtype, device))
    t = None
    if tables is not None:
        t = torch.from_numpy(np.asarray(tables, np.int32).copy()).to(device)
    return cache, t


def _flat(tree: Mapping, names, dtype: torch.dtype,
          device) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a JAX params-layout pytree's leaves `names`."""
    return {n: _tensor(tree["layers"][n] if n in LAYER_KEYS else tree[n],
                       dtype, device) for n in names}


def opt_state_from_jax(np_opt_state, model: Llama) -> AdamState:
    """optax's state of the JAX make_optimizer (a tuple holding
    ``ScaleByAdamState(count, mu, nu)``, numpy leaves; the Adam state
    itself is taken too) as the port's AdamState for `model`: the count
    and the moments in the model's dtype on its device, by leaf name."""
    adam = _find_adam(np_opt_state)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the "
                         "optimizer state")
    names = [n for n, _ in model.named_parameters()]
    p = next(model.parameters())
    return AdamState(int(np.asarray(adam.count)),
                     _flat(adam.mu, names, p.dtype, p.device),
                     _flat(adam.nu, names, p.dtype, p.device))


def _find_adam(state):
    if all(hasattr(state, a) for a in ("count", "mu", "nu")):
        return state
    if isinstance(state, (tuple, list)):
        for item in state:
            found = _find_adam(item)
            if found is not None:
                return found
    return None


def to_jax(leaves: Mapping[str, torch.Tensor]) -> dict:
    """{leaf name: tensor} (a model's named_parameters, gradients, AdamW
    moments) as JAX's params layout ({"embed", "layers": {...},
    "final_norm", ["lm_head"]}) of numpy float32 arrays."""
    out: dict = {"layers": {}}
    for name, t in leaves.items():
        arr = t.detach().float().cpu().numpy()
        if name in LAYER_KEYS:
            out["layers"][name] = arr
        else:
            out[name] = arr
    return out
