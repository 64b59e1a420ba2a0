"""Carry weights and KV state across from the JAX package.

Both take numpy arrays (the JAX params pytree after ``np.asarray`` on
every leaf), so this module imports neither JAX nor the JAX package.
bfloat16 leaves (``ml_dtypes.bfloat16`` in numpy) go through float32,
which is lossless both ways. The layouts are the same on both sides
(``[L, in, out]`` stacked weights, ``[L, N, Hkv, Bs, D]`` pools), so
carrying them is a copy, never a transpose.
"""

from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.kv import KVCache
from production_stack_tpu_torch.models.llama import LAYER_KEYS, Llama
from production_stack_tpu_torch.utils import resolve_device


def _tensor(x, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(x)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(device)
    return torch.from_numpy(
        np.ascontiguousarray(arr.astype(np.float32))).to(
            device=device, dtype=dtype)


def params_from_jax(np_params: Mapping, cfg: ModelConfig,
                    device="cuda") -> Llama:
    """The JAX params pytree ({"embed", "layers": {...}, "final_norm",
    ["lm_head"]}, numpy leaves; the layers carry post_attn_norm and
    post_mlp_norm with sandwich norms) as the port's Llama module in
    cfg.dtype on `device`."""
    model = Llama(cfg, device=device)
    with torch.no_grad():
        for name, p in model.named_parameters():
            src = (np_params["layers"][name] if name in LAYER_KEYS
                   else np_params[name])
            if tuple(np.shape(src)) != tuple(p.shape):
                raise ValueError(f"{name}: JAX shape {np.shape(src)} != "
                                 f"port shape {tuple(p.shape)}")
            p.copy_(_tensor(src, cfg.dtype, device))
    return model


def cache_from_jax(k, v, tables=None, dtype: Optional[torch.dtype] = None,
                   device="cuda") -> Tuple[KVCache, Optional[torch.Tensor]]:
    """A JAX KVCache's k/v pools ([L, N, Hkv, Bs, D], numpy) and,
    optionally, its block tables ([B, MB]) as (KVCache, int32 tables)
    on `device`. dtype defaults to the pool's own (bf16 or f32)."""
    device = resolve_device(device)
    if dtype is None:
        dtype = (torch.float32 if np.asarray(k).dtype == np.float32
                 else torch.bfloat16)
    cache = KVCache(k=_tensor(k, dtype, device), v=_tensor(v, dtype, device))
    t = None
    if tables is not None:
        t = torch.from_numpy(np.asarray(tables, np.int32).copy()).to(device)
    return cache, t
