"""RMSNorm, reduced in float32 whatever the activation dtype
(``production_stack_tpu/ops/norms.py``)."""

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             offset: float = 0.0) -> torch.Tensor:
    """y = x / rms(x) * (weight + offset), f32 compute, x.dtype out.

    offset=1.0 is Gemma's unit-gain convention; 0.0 the Llama baseline."""
    xf = x.float()
    var = xf.pow(2).mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (weight.float() + offset)).to(x.dtype)
