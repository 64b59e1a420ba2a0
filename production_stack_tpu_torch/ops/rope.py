"""Rotary position embeddings, non-interleaved ("rotate half") layout
(``production_stack_tpu/ops/rope.py``).

The table is computed once in numpy float32, exactly as the JAX module
does, so both packages rotate by the same angles."""

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch


@lru_cache(maxsize=32)
def rope_table(max_positions: int, head_dim: int, theta: float = 10000.0,
               scaling: tuple = None) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin), each [max_positions, head_dim // 2] float32 numpy.

    scaling: ("linear", factor) divides every frequency by factor;
    ("llama3", factor, low_freq_factor, high_freq_factor,
    original_max_position_embeddings) applies Llama-3.1's
    wavelength-dependent warp."""
    inv_freq = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))
    if scaling is not None:
        kind = scaling[0]
        if kind == "linear":
            inv_freq = inv_freq / float(scaling[1])
        elif kind == "llama3":
            factor, low_f, high_f, orig = (float(scaling[1]),
                                           float(scaling[2]),
                                           float(scaling[3]),
                                           float(scaling[4]))
            low_wavelen = orig / low_f
            high_wavelen = orig / high_f
            wavelen = 2.0 * np.pi / inv_freq
            smooth = (orig / wavelen - low_f) / (high_f - low_f)
            warped = ((1.0 - smooth) * inv_freq / factor
                      + smooth * inv_freq)
            inv_freq = np.where(
                wavelen > low_wavelen, inv_freq / factor,
                np.where(wavelen < high_wavelen, inv_freq, warped))
        else:
            raise ValueError(
                f"unsupported rope scaling {kind!r} (supported: "
                f"linear, llama3)")
    pos = np.arange(max_positions, dtype=np.float32)
    angles = np.outer(pos, inv_freq)
    return np.cos(angles), np.sin(angles)


def rope_rows(positions: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 (cos, sin) rows [..., T, 1, D/2] of per-token positions
    [..., T]: the same for every layer, so the forward gathers them once.

    Positions are clamped into the table, as JAX's gather clamps: parked
    rows sit at position max_model_len and advance past it inside a
    decode window, and an index out of range on CUDA is a device-side
    assert. Negative positions wrap once, as jnp indexing does."""
    P = cos.shape[0]
    idx = torch.where(positions < 0, positions + P, positions).clamp(0, P - 1)
    return cos[idx].float().unsqueeze(-2), sin[idx].float().unsqueeze(-2)


def rotate(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Rotate x [..., T, H, D] by rope_rows' (c, s), in f32."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate x [..., T, H, D] by per-token positions [..., T]
    (rope_rows, then rotate)."""
    return rotate(x, *rope_rows(positions, cos, sin))
