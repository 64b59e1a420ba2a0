"""Load HuggingFace Llama-family checkpoints into the port's ``Llama``
module (``production_stack_tpu/models/hf_loader.py``).

Takes a state-dict-like mapping (name -> torch tensor or numpy array)
or a checkpoint directory: ``*.safetensors`` shards, read a tensor at a
time by this module's own reader (the header length, the JSON header,
then each tensor from its byte range with ``torch.frombuffer``; no
``safetensors`` package), else ``*.bin`` through ``torch.load(...,
weights_only=True)``.

HF stores projections ``[out, in]``; the port, like the JAX package,
``[in, out]`` (``x @ W``), so every projection is transposed on load,
and per-layer tensors fill the leading layer axis of the stacked
parameters one layer at a time. With ``quantization="int8"``
(``load_checkpoint``) each layer is quantized as it lands, so neither
the host nor the device holds the checkpoint whole in its own dtype
(Mixtral-8x7B: 93.4 GB in bf16, 46.7 GB int8); under a shard a rank
keeps its slice.
Values are cast straight to the model dtype, which rounds as the JAX
loader's cast through float32 does (bf16 -> bf16 is exact). The families are the JAX loader's
(``hf_loader.py:69-118``): dense Llama, Mistral (its ``sliding_window``
comes with the config), Gemma-1, Gemma-2 (sandwich-norm names), Qwen2's
q/k/v biases, Mixtral's ``block_sparse_moe.{gate, experts.N.w1/w3/w2}``
and Qwen2-MoE's ``mlp.{gate, experts.N.gate_proj/up_proj/down_proj,
shared_expert.*, shared_expert_gate}`` (``moe_naming``), each expert
filling its row of the stacked ``[L, E, in, out]`` parameters.
"""

import glob
import json
import os
import struct
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.llama import (LAYER_KEYS, Llama,
                                                     leaf_shapes, put_leaf)
from production_stack_tpu_torch.utils import init_logger, resolve_device

logger = init_logger(__name__)

_LAYER_MAP = {
    # our-name: (hf-suffix, transpose)
    "attn_norm": ("input_layernorm.weight", False),
    "q": ("self_attn.q_proj.weight", True),
    "k": ("self_attn.k_proj.weight", True),
    "v": ("self_attn.v_proj.weight", True),
    "o": ("self_attn.o_proj.weight", True),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "gate": ("mlp.gate_proj.weight", True),
    "up": ("mlp.up_proj.weight", True),
    "down": ("mlp.down_proj.weight", True),
}

# safetensors dtype names -> torch dtypes
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def _to_tensor(t: Any) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach()
    arr = np.asarray(t)
    if arr.dtype.kind not in "biuf":
        # ml_dtypes.bfloat16 and the like: numpy holds them, torch does
        # not take them from numpy; float32 keeps their values
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _hf_names(cfg: ModelConfig) -> Dict[str, Tuple[str, bool]]:
    """Each leaf's HF name and whether it is transposed on load: a
    per-layer leaf's suffix after ``layers.{i}.`` (an expert stack's
    with ``{e}`` for the expert), the others' whole names (lm_head's
    looked up bare first)."""
    layer_map = dict(_LAYER_MAP)
    if cfg.sandwich_norms:
        # Gemma-2: post_attention_layernorm is the sandwich post-attn
        # norm (Llama's MLP pre-norm), the MLP pre-norm is
        # pre_feedforward_layernorm, plus post_feedforward_layernorm
        layer_map["mlp_norm"] = ("pre_feedforward_layernorm.weight", False)
        layer_map["post_attn_norm"] = ("post_attention_layernorm.weight",
                                       False)
        layer_map["post_mlp_norm"] = ("post_feedforward_layernorm.weight",
                                      False)
    if cfg.attention_bias:
        # Qwen2: q/k/v projection biases ([out] vectors)
        layer_map.update({
            "q_bias": ("self_attn.q_proj.bias", False),
            "k_bias": ("self_attn.k_proj.bias", False),
            "v_bias": ("self_attn.v_proj.bias", False),
        })
    if cfg.num_experts:
        # the routed experts replace the dense MLP: expert e fills row e
        # of the stacked [L, E, in, out] leaf
        qwen_moe = cfg.moe_naming == "qwen2"
        prefix = "mlp" if qwen_moe else "block_sparse_moe"
        moe_map = ({"gate": "gate_proj", "up": "up_proj",
                    "down": "down_proj"} if qwen_moe
                   else {"gate": "w1", "up": "w3", "down": "w2"})
        for ours, hf in moe_map.items():
            layer_map[ours] = (f"{prefix}.experts.{{e}}.{hf}.weight", True)
        layer_map["router"] = (f"{prefix}.gate.weight", True)
        if qwen_moe and cfg.shared_expert_size:
            layer_map.update({
                "s_gate": ("mlp.shared_expert.gate_proj.weight", True),
                "s_up": ("mlp.shared_expert.up_proj.weight", True),
                "s_down": ("mlp.shared_expert.down_proj.weight", True),
                "s_gate_w": ("mlp.shared_expert_gate.weight", True),
            })
    layer_map.update({"embed": ("embed_tokens.weight", False),
                      "final_norm": ("norm.weight", False),
                      "lm_head": ("lm_head.weight", True)})
    return layer_map


@torch.no_grad()
def _build(cfg: ModelConfig, read: Callable[..., Any], device="cuda",
           shard=None, int8: bool = False) -> Llama:
    """The Llama module of the tensors `read(name, bare=False)` gives by
    HF name, built a layer at a time: each layer of each leaf (the
    embedding, the final norm and the head whole) is assembled in
    cfg.dtype from its tensors (transposed where HF stores [out, in];
    an expert stack expert by expert), then stored by llama.put_leaf —
    quantized where int8, cut to the rank's slice under `shard` — and
    dropped before the next is read."""
    model = Llama(cfg, device=device, shard=shard, int8=int8)
    dev = resolve_device(device)
    names = _hf_names(cfg)

    def put(dst: torch.Tensor, name: str, transpose: bool,
            bare: bool = False) -> None:
        src = _to_tensor(read(name, bare=bare)).to(dst.device)
        if transpose:
            src = src.t()
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"weight {name!r}: shape {tuple(src.shape)} "
                             f"!= {tuple(dst.shape)} of the config")
        dst.copy_(src)

    for ours, shape in leaf_shapes(cfg).items():
        hf, transpose = names[ours]
        layered = ours in LAYER_KEYS
        for i in (range(cfg.num_layers) if layered else (None,)):
            w = torch.empty(shape[1:] if layered else shape,
                            dtype=cfg.dtype, device=dev)
            name = f"layers.{i}.{hf}" if layered else hf
            if "{e}" in name:
                for e in range(cfg.num_experts):
                    put(w[e], name.format(e=e), transpose)
            else:
                put(w, name, transpose, bare=ours == "lm_head")
            put_leaf(model, ours, i, w)
            del w
    return model


def params_from_state_dict(cfg: ModelConfig, sd: Mapping[str, Any],
                           device="cuda") -> Llama:
    """The Llama module of an HF LlamaForCausalLM / MistralForCausalLM /
    Qwen2ForCausalLM / GemmaForCausalLM / Gemma2ForCausalLM /
    MixtralForCausalLM / Qwen2MoeForCausalLM state dict, in cfg.dtype on
    `device`."""
    return _build(cfg, lambda name, bare=False: _lookup(sd, name, bare),
                  device=device)


def _lookup(sd: Mapping[str, Any], name: str, bare: bool = False) -> Any:
    candidates = [name] if bare else []
    candidates += [f"model.{name}", name]
    for c in candidates:
        if c in sd:
            return sd[c]
    raise KeyError(f"missing weight {name!r}")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one .safetensors file, on the CPU
    (_SafetensorsIndex's reader)."""
    index = _SafetensorsIndex([path])
    return {name: index[name] for name in index}


def save_safetensors(tensors: Mapping[str, torch.Tensor], path: str
                     ) -> None:
    """Write tensors as one .safetensors file (the format read_safetensors
    reads; the header padded to 8 bytes with spaces, as the reference
    writer pads it)."""
    header, chunks, at = {}, [], 0
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [at, at + len(raw)]}
        chunks.append(raw)
        at += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in chunks:
            f.write(raw)


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Raw tensors of an HF checkpoint dir, whole on the host: every
    *.safetensors shard, else every *.bin (torch.load, weights only)."""
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    sd: Dict[str, torch.Tensor] = {}
    if st_files:
        for f in st_files:
            sd.update(read_safetensors(f))
    else:
        for f in sorted(glob.glob(os.path.join(path, "*.bin"))):
            sd.update(torch.load(f, map_location="cpu", weights_only=True))
    if not sd:
        raise FileNotFoundError(f"no weights (*.safetensors|*.bin) in {path}")
    logger.info("read %d tensors from %s", len(sd), path)
    return sd


class _SafetensorsIndex:
    """The tensors of .safetensors files, read one at a time. A file is
    an 8-byte little-endian header length, the JSON header ({name:
    {dtype, shape, data_offsets}}, plus an optional __metadata__), then
    the data; each file's header is read once, and a tensor's bytes are
    read from its byte range when it is asked for, so the host holds one
    tensor at a time, never a file or the checkpoint."""

    def __init__(self, files):
        self._where: Dict[str, tuple] = {}
        for path in files:
            with open(path, "rb") as f:
                (n,) = struct.unpack("<Q", f.read(8))
                header = json.loads(f.read(n))
            size = os.path.getsize(path) - 8 - n
            for name, info in header.items():
                if name == "__metadata__":
                    continue
                self._where[name] = (path, 8 + n, size, info)

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def __iter__(self):
        return iter(self._where)

    def __getitem__(self, name: str) -> torch.Tensor:
        path, base, size, info = self._where[name]
        if info["dtype"] not in _ST_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']}, which the reader does not "
                             f"take ({sorted(_ST_DTYPES)})")
        dtype = _ST_DTYPES[info["dtype"]]
        shape = list(info["shape"])
        lo, hi = info["data_offsets"]
        count = int(np.prod(shape, dtype=np.int64))
        if hi - lo != count * dtype.itemsize or hi > size:
            raise ValueError(f"{path}: tensor {name!r} spans bytes "
                             f"[{lo}, {hi}), not {count} x "
                             f"{info['dtype']}")
        if not count:
            return torch.empty(shape, dtype=dtype)
        data = bytearray(hi - lo)
        with open(path, "rb") as f:
            f.seek(base + lo)
            got = f.readinto(data)
        if got != len(data):
            raise ValueError(f"{path}: read {got} of {len(data)} bytes of "
                             f"tensor {name!r}")
        return torch.frombuffer(data, dtype=dtype).reshape(shape)


def load_checkpoint(cfg: ModelConfig, path: str, device="cuda",
                    quantization: Optional[str] = None,
                    shard=None) -> Llama:
    """The Llama module of an HF checkpoint directory on disk, built a
    layer at a time (_build): from *.safetensors shards each tensor is
    read on its own (_SafetensorsIndex), so the host holds one tensor;
    a directory of *.bin files is read whole first. quantization
    "int8": the weight-only int8 model (models/quant.py), each layer
    quantized as it lands, so the device holds the int8 model plus one
    layer in cfg.dtype; bit for bit quant.quantize_params of the load
    in cfg.dtype. shard: a rank's coordinates; its slice of every leaf
    (an int8 layer quantized whole, then cut), bit for bit
    sharding.shard_params of the whole."""
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    tensors = (_SafetensorsIndex(st_files) if st_files
               else read_state_dict(path))
    return _build(cfg, lambda name, bare=False: _lookup(tensors, name, bare),
                  device=device, shard=shard, int8=quantization == "int8")
