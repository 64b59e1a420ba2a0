"""Batched multi-LoRA for the Llama decoder: stacked adapters, the
adapter chosen per row inside one batch
(``production_stack_tpu/models/lora.py``).

All adapters live as one stack ``{proj: {"a": [N+1, L, in, r], "b":
[N+1, L, r, out]}}`` with row 0 zero (the base model). A batch carries
per-row adapter ids [B]; every targeted projection adds
``(x @ A_i) @ B_i * (alpha / r)`` to its base product. The ids of a
batch change only when a slot's sequence does, so the runner gathers
the rows' factors once per composition change (``layer_slice`` then
``gather_rows``: ``[L, B, in, r]`` / ``[L, B, r, out]``), not per layer
and per step; ``apply`` is then two launches per targeted projection,
``torch.bmm`` and ``baddbmm_`` — the two einsums JAX leaves to XLA
(a plain matrix product, not a Pallas kernel).

Checkpoint format, the JAX package's: an .npz per adapter with keys
``{proj}.a`` [L, in, r] and ``{proj}.b`` [L, r, out], stored as
float32 (npz has no bfloat16; float32 holds bf16 values exactly) and
read back in the model dtype.

``random_adapter`` draws from a seeded ``torch.Generator``, which cannot
reproduce ``jax.random``'s threefry: a ``random:SEED`` adapter differs
between the two packages (ROADMAP Queue C). Adapters written to .npz
by either package load bit for bit in the other.
"""

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.utils import resolve_device

# one adapter: {proj: {"a": [L, in, r], "b": [L, r, out]}}
Adapter = Dict[str, Dict[str, torch.Tensor]]
# a batch's gathered factors: {proj: (a [L, B, in, r], b [L, B, r, out])}
Rows = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _proj_dims(cfg: ModelConfig) -> Dict[str, Tuple[int, int]]:
    """projection name -> (in_dim, out_dim)."""
    h, i = cfg.hidden_size, cfg.intermediate_size
    hd = cfg.head_dim_
    dims = {
        "q": (h, cfg.num_heads * hd),
        "k": (h, cfg.num_kv_heads * hd),
        "v": (h, cfg.num_kv_heads * hd),
        "o": (cfg.num_heads * hd, h),
    }
    if not cfg.num_experts:
        # MoE models have no dense MLP projections for the hook to adapt
        dims.update({"gate": (h, i), "up": (h, i), "down": (i, h)})
    return dims


DEFAULT_TARGETS = ("q", "v")


def _check_targets(cfg: ModelConfig, targets: Tuple[str, ...],
                   dims: Dict[str, Tuple[int, int]]) -> None:
    unknown = [t for t in targets if t not in dims]
    if unknown:
        hint = (" (MoE expert FFNs cannot take LoRA — adapt the "
                "attention projections instead)" if cfg.num_experts
                else "")
        raise ValueError(
            f"LoRA target(s) {unknown} not available for model "
            f"{cfg.name!r}; valid: {sorted(dims)}{hint}")


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0
    targets: Tuple[str, ...] = DEFAULT_TARGETS

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def init_adapter(cfg: ModelConfig, lcfg: LoRAConfig,
                 generator: Optional[torch.Generator] = None,
                 zero: bool = False, device="cuda") -> Adapter:
    """One adapter's factors in cfg.dtype on `device`. Standard LoRA
    init: A ~ N(0, 0.02), B = 0 (a fresh adapter is a no-op until
    trained); ``zero`` also zeroes A (the base-model row)."""
    device = resolve_device(device)
    dims = _proj_dims(cfg)
    _check_targets(cfg, lcfg.targets, dims)
    L, r = cfg.num_layers, lcfg.rank
    out: Adapter = {}
    for name in lcfg.targets:
        d_in, d_out = dims[name]
        if zero:
            a = torch.zeros((L, d_in, r), dtype=cfg.dtype, device=device)
        else:
            a = (torch.randn((L, d_in, r), generator=generator,
                             device=device) * 0.02).to(cfg.dtype)
        out[name] = {"a": a, "b": torch.zeros((L, r, d_out),
                                              dtype=cfg.dtype,
                                              device=device)}
    return out


def random_adapter(cfg: ModelConfig, lcfg: LoRAConfig,
                   generator: torch.Generator, device="cuda") -> Adapter:
    """A synthetic adapter with both factors N(0, 0.05), drawn in
    float32 from `generator` (which lives on `device`): it visibly
    changes the model's output ("random:SEED" in EngineConfig)."""
    device = resolve_device(device)
    dims = _proj_dims(cfg)
    _check_targets(cfg, lcfg.targets, dims)
    L, r = cfg.num_layers, lcfg.rank
    out: Adapter = {}
    for name in lcfg.targets:
        d_in, d_out = dims[name]
        out[name] = {
            "a": (torch.randn((L, d_in, r), generator=generator,
                              device=device) * 0.05).to(cfg.dtype),
            "b": (torch.randn((L, r, d_out), generator=generator,
                              device=device) * 0.05).to(cfg.dtype),
        }
    return out


def stack_adapters(cfg: ModelConfig, lcfg: LoRAConfig,
                   adapters: Sequence[Adapter], device="cuda"
                   ) -> Dict[str, Dict[str, torch.Tensor]]:
    """[base-zero] + adapters as {proj: {a: [N+1, L, in, r], b: ...}}."""
    base = init_adapter(cfg, lcfg, zero=True, device=device)
    return {name: {k: torch.stack([base[name][k]]
                                  + [ad[name][k] for ad in adapters])
                   for k in ("a", "b")}
            for name in lcfg.targets}


def load_adapter_npz(cfg: ModelConfig, lcfg: LoRAConfig, path: str,
                     device="cuda") -> Adapter:
    """One adapter from an .npz checkpoint (format in the module doc),
    in cfg.dtype on `device`; shapes are checked as the JAX loader
    checks them."""
    device = resolve_device(device)
    data = np.load(path)
    dims = _proj_dims(cfg)
    _check_targets(cfg, lcfg.targets, dims)
    L, r = cfg.num_layers, lcfg.rank
    out: Adapter = {}
    for name in lcfg.targets:
        a_key, b_key = f"{name}.a", f"{name}.b"
        if a_key not in data or b_key not in data:
            raise ValueError(f"adapter {path} missing {a_key}/{b_key}")
        a, b = np.asarray(data[a_key]), np.asarray(data[b_key])
        d_in, d_out = dims[name]
        if a.shape != (L, d_in, r) or b.shape != (L, r, d_out):
            raise ValueError(
                f"adapter {path} {name}: got a{a.shape} b{b.shape}, want "
                f"a{(L, d_in, r)} b{(L, r, d_out)}")
        out[name] = {k: torch.from_numpy(
            np.ascontiguousarray(x, np.float32)).to(device=device,
                                                    dtype=cfg.dtype)
            for k, x in (("a", a), ("b", b))}
    return out


def save_adapter_npz(adapter: Adapter, path: str) -> None:
    """Write one adapter as float32 .npz (the loader casts back to the
    model dtype; float32 holds bf16 values exactly)."""
    arrays = {}
    for name, ab in adapter.items():
        for k in ("a", "b"):
            arrays[f"{name}.{k}"] = ab[k].detach().float().cpu().numpy()
    np.savez(path, **arrays)


def layer_slice(stacked: Optional[Dict[str, Dict[str, torch.Tensor]]]
                ) -> Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]]:
    """The stack with the layer axis first, contiguous:
    {proj: (a [L, N+1, in, r], b [L, N+1, r, out])}."""
    if stacked is None:
        return None
    return {name: tuple(ab[k].transpose(0, 1).contiguous()
                        for k in ("a", "b"))
            for name, ab in stacked.items()}


def gather_rows(sliced: Dict[str, Tuple[torch.Tensor, torch.Tensor]],
                adapter_ids: torch.Tensor) -> Rows:
    """A batch's factors from a layer-first stack: adapter_ids [B]
    (0 = base, zero factors) -> {proj: (a [L, B, in, r], b [L, B, r,
    out])}, contiguous, so layer l's rows are one [B, ...] slice."""
    ids = adapter_ids.long()
    return {name: (a.index_select(1, ids), b.index_select(1, ids))
            for name, (a, b) in sliced.items()}


def apply(x: torch.Tensor, out: torch.Tensor, a: torch.Tensor,
          b: torch.Tensor, scaling: float) -> torch.Tensor:
    """out [B,T,out] += scaling * (x [B,T,in] @ a [B,in,r]) @ b [B,r,out]
    per batch row, in place (returned). Row i's factors are its
    adapter's (zeros for the base model, which leave out unchanged)."""
    return out.baddbmm_(torch.bmm(x, a), b, alpha=scaling)
