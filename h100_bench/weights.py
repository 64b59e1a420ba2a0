"""The benchmark's weights, drawn on the device from the run's seed.

Both sides read the same draws: the program gets them as its ``Llama``
module (serve.py), and the reference (reference.py) draws them again a
layer at a time once the program's state is freed. Each (leaf, layer)
has a generator of its own, seeded from (seed, leaf, layer), so one
layer can be drawn again without the others. Nothing here imports the
program.

Leaves keep the serving layout ``[in, out]`` (``x @ w``); the
embedding is ``[V, H]`` and the head ``[H, V]``. Every leaf is
normal(0, 0.02) rounded to bfloat16, as a bfloat16 deployment serves
it; norm gains are 1 + normal(0, 0.1).
"""

import hashlib
from typing import Dict, Iterator, Optional, Tuple

import torch

# the leaves the port's weight-only int8 recipe quantizes: every
# projection, the embedding and the head (the control's, reference.py)
INT8_LEAVES = ("embed", "lm_head", "q", "k", "v", "o", "gate", "up", "down")
NORMS = ("attn_norm", "mlp_norm", "final_norm")
STD = 0.02


def dims(cfg: dict) -> dict:
    """The sizes the draws and the reference need, from the published
    config.json keys."""
    nh = cfg["num_attention_heads"]
    d = cfg.get("head_dim") or cfg["hidden_size"] // nh
    return {"H": cfg["hidden_size"], "I": cfg["intermediate_size"],
            "V": cfg["vocab_size"], "L": cfg["num_hidden_layers"],
            "NH": nh, "NKV": cfg.get("num_key_value_heads", nh), "D": d,
            "window": cfg.get("sliding_window") or 0,
            "theta": float(cfg.get("rope_theta", 10000.0)),
            "eps": float(cfg.get("rms_norm_eps", 1e-5))}


def layer_shapes(cfg: dict) -> Dict[str, tuple]:
    """name -> shape of one layer of each per-layer leaf."""
    m = dims(cfg)
    H, I, NH, NKV, D = m["H"], m["I"], m["NH"], m["NKV"], m["D"]
    return {"attn_norm": (H,), "q": (H, NH * D), "k": (H, NKV * D),
            "v": (H, NKV * D), "o": (NH * D, H), "mlp_norm": (H,),
            "gate": (H, I), "up": (H, I), "down": (I, H)}


def whole_shapes(cfg: dict) -> Dict[str, tuple]:
    m = dims(cfg)
    return {"embed": (m["V"], m["H"]), "final_norm": (m["H"],),
            "lm_head": (m["H"], m["V"])}


def _generator(seed: int, name: str, layer: Optional[int],
               device) -> torch.Generator:
    digest = hashlib.sha256(f"{seed}:{name}:{layer}".encode()).digest()
    g = torch.Generator(device=device)
    g.manual_seed(int.from_bytes(digest[:8], "little") & (2 ** 63 - 1))
    return g


def draw(cfg: dict, seed: int, name: str, layer: Optional[int],
         device) -> torch.Tensor:
    """One leaf (layer None: a whole leaf) as served, in bfloat16."""
    shape = (whole_shapes(cfg) if layer is None else layer_shapes(cfg))[name]
    g = _generator(seed, name, layer, device)
    if name in NORMS:
        w = torch.randn(shape, generator=g, device=device,
                        dtype=torch.float32).mul_(0.1).add_(1.0)
        return w.to(torch.bfloat16)
    w = torch.randn(shape, generator=g, device=device, dtype=torch.float32)
    return w.mul_(STD).to(torch.bfloat16)


def iter_draws(cfg: dict, seed: int, device
               ) -> Iterator[Tuple[str, Optional[int], torch.Tensor]]:
    """Every leaf of the model, a layer at a time: (name, layer or None,
    value as ``draw`` gives it)."""
    for name in whole_shapes(cfg):
        yield name, None, draw(cfg, seed, name, None, device)
    for layer in range(dims(cfg)["L"]):
        for name in layer_shapes(cfg):
            yield name, layer, draw(cfg, seed, name, layer, device)
