"""Weight-only int8 quantization of the decoder's projection matmuls
(``production_stack_tpu/models/quant.py:36-97``).

- Symmetric per-output-channel int8 on every large matrix: q/k/v/o,
  gate/up/down (a MoE model's expert stacks per expert, scale
  ``[L, E, out]``), the shared expert, lm_head, and the embedding per
  row (``quantize_embed``:
  one scale per vocab entry serves both the token gather and the tied
  lm_head, where it lands on the logit axis). Norm gains, the q/k/v
  biases, the MoE router and the shared expert's gate vector stay in
  the model dtype (``_SKIP_LAYER``, the JAX set).
- Weight-only: activations stay in the model dtype. A projection
  computes ``(x @ w8.to(dtype)) * scale.to(dtype)``, which equals
  ``x @ (w8 * scale)``. XLA fuses the convert into the dot; here the
  convert is an eager pass over the layer's int8 weight before
  ``torch.matmul`` (a fused int8-weight product is later work).
- A quantized leaf keeps its name: the ``Llama`` module's parameter is
  replaced by a ``QuantizedWeight`` holding the buffers ``w8`` int8
  ``[..., in, out]`` and ``scale`` f32 ``[..., out]``, so ``model.q[l]``
  still indexes a layer (giving an ``Int8Weight``).

``torch.round`` rounds half to even as ``jnp.round`` does, so on the
same float32 inputs ``w8`` and ``scale`` are bit-identical to the JAX
package's.
"""

from typing import NamedTuple, Union

import torch
from torch import nn

# layer weights that stay in the model dtype (small or accuracy-critical)
_SKIP_LAYER = ("attn_norm", "mlp_norm", "post_attn_norm", "post_mlp_norm",
               "q_bias", "k_bias", "v_bias", "router", "s_gate_w")


class Int8Weight(NamedTuple):
    """One quantized matrix (or a layer of a stack): value = w8 * scale,
    the scale broadcast over the `in` axis."""
    w8: torch.Tensor      # int8 [..., in, out]
    scale: torch.Tensor   # f32 [..., out]


class QuantizedWeight(nn.Module):
    """A quantized leaf of the ``Llama`` module under the weight's own
    name: buffers ``w8`` and ``scale``; indexing gives a layer's
    ``Int8Weight``."""

    def __init__(self, w8: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("w8", w8)
        self.register_buffer("scale", scale)

    def __getitem__(self, i) -> Int8Weight:
        return Int8Weight(self.w8[i], self.scale[i])


Weight = Union[torch.Tensor, Int8Weight, QuantizedWeight]


def quantize_tensor(w: torch.Tensor) -> Int8Weight:
    """Symmetric per-output-channel int8 over the last axis: w [..., in,
    out] -> (int8 same shape, f32 scale [..., out]), scale = max|w| / 127
    reduced over the `in` axis (leading axes keep their own channels)."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=-2), min=1e-8) / 127.0
    w8 = torch.clamp(torch.round(wf / scale[..., None, :]), -127, 127)
    return Int8Weight(w8.to(torch.int8), scale)


def quantize_embed(w: torch.Tensor) -> Int8Weight:
    """Per-ROW int8 for the [V, H] embedding table: scale [V]."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=-1), min=1e-8) / 127.0
    w8 = torch.clamp(torch.round(wf / scale[:, None]), -127, 127)
    return Int8Weight(w8.to(torch.int8), scale)


def is_quantized(w) -> bool:
    return isinstance(w, (Int8Weight, QuantizedWeight))


def dequant_matmul(x: torch.Tensor, w: Weight) -> torch.Tensor:
    """x @ w for a raw or quantized w, in x.dtype. A stack of matrices
    (w8 [E, in, out] with scale [E, out], the MoE experts) takes x
    [E or 1, C, in] to [E, C, out], each matrix's scale on its own
    product (JAX ops/moe.py ``_edot``)."""
    if not is_quantized(w):
        return torch.matmul(x, w)
    return (torch.matmul(x, w.w8.to(x.dtype))
            * w.scale.to(x.dtype).unsqueeze(-2))


def dequant_rows(w: Weight, rows: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of a raw or quantized [V, H] table in `dtype`: the embedding
    lookup (per-row scale from quantize_embed)."""
    if not is_quantized(w):
        return w[rows].to(dtype)
    return w.w8[rows].to(dtype) * w.scale[rows].to(dtype)[..., None]


# vocabulary entries quantized at a time: the embedding and lm_head are
# the largest matrices, and their f32 copy is made a slice at a time
_VOCAB_SLICE = 16384


def is_quantized_name(name: str) -> bool:
    """Whether the ``Llama`` leaf `name` is stored int8 under
    quantization="int8": every weight outside _SKIP_LAYER and the final
    norm."""
    return name not in _SKIP_LAYER and name != "final_norm"


def scale_shape(name: str, shape) -> tuple:
    """The f32 scale's shape of an int8 leaf (or of one layer of it) of
    `shape`: [V] per row for the embedding, else the shape without the
    reduced `in` axis."""
    shape = tuple(shape)
    return shape[:1] if name == "embed" else shape[:-2] + shape[-1:]


@torch.no_grad()
def quantize_into(name: str, w: torch.Tensor, w8: torch.Tensor,
                  scale: torch.Tensor) -> None:
    """Quantize the full-precision weight `w` of leaf `name` — the whole
    embedding or lm_head, or one layer of another leaf — into the
    buffers w8 and scale (quantize_params' recipe), a slice at a time:
    _VOCAB_SLICE vocabulary entries of the embedding (per row) or the
    head, one matrix of a stack (a MoE layer's experts). Every reduction
    runs within a slice, so the result is that of the whole weight at
    once, and the f32 temporaries are one slice's."""
    if name == "embed":
        for lo in range(0, w.shape[0], _VOCAB_SLICE):
            sl = slice(lo, lo + _VOCAB_SLICE)
            w8[sl], scale[sl] = quantize_embed(w[sl])
    elif name == "lm_head":
        for lo in range(0, w.shape[1], _VOCAB_SLICE):
            sl = slice(lo, lo + _VOCAB_SLICE)
            w8[:, sl], scale[sl] = quantize_tensor(w[:, sl])
    elif w.dim() > 2:
        for e in range(w.shape[0]):
            quantize_into(name, w[e], w8[e], scale[e])
    else:
        w8[...], scale[...] = quantize_tensor(w)


@torch.no_grad()
def quantize_params(model: nn.Module) -> nn.Module:
    """Quantize a ``Llama`` module in place with the JAX package's recipe
    and return it: the embedding per row, lm_head and every layer weight
    outside _SKIP_LAYER per output channel; norms unchanged. Each weight
    is quantized a slice at a time (quantize_into, each layer of a
    stack) on its own device, and its full-precision parameter is
    dropped as soon as its int8 copy is done, so the transient memory is
    one slice's f32 copy (JAX donates the buffers to the same end). A
    module built int8 (llama.init_params(int8=True), a quantizing
    checkpoint load) has no such parameter left and is returned as it
    is."""
    names = [n for n, _ in model.named_parameters() if is_quantized_name(n)]
    for name in names:
        p = getattr(model, name)
        w8 = torch.empty(p.shape, dtype=torch.int8, device=p.device)
        scale = torch.empty(scale_shape(name, p.shape), dtype=torch.float32,
                            device=p.device)
        if name in ("embed", "lm_head"):
            quantize_into(name, p, w8, scale)
        else:
            for l in range(p.shape[0]):
                quantize_into(name, p[l], w8[l], scale[l])
        delattr(model, name)
        del p
        setattr(model, name, QuantizedWeight(w8, scale))
    return model
