"""Model configuration for the Llama decoder family (torch dtypes).

A copy of ``production_stack_tpu/models/config.py``: same fields, same
presets, same HF aliases, with ``dtype`` a ``torch.dtype``. The JAX
module imports ``jax.numpy`` for its dtype, so the port keeps its own.
``tests/test_torch_model.py`` checks every preset field by field
against the JAX table.
"""

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import torch


def _rope_scaling_spec(rs: Optional[dict]) -> Optional[tuple]:
    """HF config.json rope_scaling dict -> the hashable spec
    ops/rope.rope_table takes. Unsupported kinds raise."""
    if not rs:
        return None
    kind = rs.get("rope_type") or rs.get("type")
    if kind in ("default", None):
        return None
    if kind == "linear":
        return ("linear", float(rs["factor"]))
    if kind == "llama3":
        return ("llama3", float(rs["factor"]),
                float(rs.get("low_freq_factor", 1.0)),
                float(rs.get("high_freq_factor", 4.0)),
                float(rs.get("original_max_position_embeddings", 8192)))
    raise ValueError(
        f"unsupported rope_scaling type {kind!r} (supported: linear, "
        f"llama3)")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "debug-llama"
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632
    num_layers: int = 22
    num_heads: int = 32
    num_kv_heads: int = 4
    head_dim: Optional[int] = None  # defaults to hidden_size // num_heads
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    # family variations beyond the Llama baseline (see the JAX module),
    # all served by the port's forward (models/llama.py)
    sliding_window: Optional[int] = None
    alternating_sliding: bool = False
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    query_pre_attn_scalar: Optional[float] = None
    sandwich_norms: bool = False
    rope_scaling: Optional[tuple] = None
    attention_bias: bool = False
    activation: str = "silu"
    rms_norm_offset: bool = False
    embed_scale: bool = False
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_capacity_factor: float = 2.0
    norm_topk_prob: bool = True
    moe_intermediate_size: Optional[int] = None
    shared_expert_size: int = 0
    moe_naming: str = "mixtral"
    dtype: Any = torch.bfloat16

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def num_params(self) -> int:
        h, i, v = self.hidden_size, self.intermediate_size, self.vocab_size
        hd = self.head_dim_
        E = self.num_experts
        if E:
            mi = self.moe_intermediate_size or i
            mlp = 3 * h * mi * E + h * E
            if self.shared_expert_size:
                mlp += 3 * h * self.shared_expert_size + h
        else:
            mlp = 3 * h * i
        per_layer = (h * (self.num_heads * hd)
                     + 2 * h * (self.num_kv_heads * hd)
                     + (self.num_heads * hd) * h
                     + mlp + 2 * h)
        emb = v * h * (1 if self.tie_word_embeddings else 2)
        return self.num_layers * per_layer + emb + h

    @staticmethod
    def from_hf_config(cfg: Dict[str, Any], name: str = "",
                       dtype: Any = torch.bfloat16) -> "ModelConfig":
        """Map a HuggingFace config dict onto ModelConfig (same family
        rules as the JAX module)."""
        archs = cfg.get("architectures") or []
        arch = archs[0] if archs else ""
        model_type = cfg.get("model_type", "")
        is_qwen2 = model_type == "qwen2" or arch == "Qwen2ForCausalLM"
        is_gemma = model_type == "gemma" or arch == "GemmaForCausalLM"
        is_gemma2 = (model_type == "gemma2"
                     or arch == "Gemma2ForCausalLM")
        is_mixtral = (model_type == "mixtral"
                      or arch == "MixtralForCausalLM")
        is_qwen2_moe = (model_type == "qwen2_moe"
                        or arch == "Qwen2MoeForCausalLM")
        is_llama_like = (model_type in ("llama", "mistral") or arch in
                         ("LlamaForCausalLM", "MistralForCausalLM"))
        if not (is_qwen2 or is_gemma or is_gemma2 or is_mixtral
                or is_qwen2_moe or is_llama_like) and (model_type or arch):
            raise ValueError(
                f"unsupported model family (model_type={model_type!r}, "
                f"architecture={arch!r}); supported: llama, mistral, "
                f"qwen2, gemma, gemma2, mixtral, qwen2_moe")
        if is_qwen2_moe:
            if (cfg.get("decoder_sparse_step", 1) != 1
                    or cfg.get("mlp_only_layers")):
                raise ValueError(
                    "qwen2_moe with dense interleaving "
                    "(decoder_sparse_step != 1 or mlp_only_layers) is "
                    "not supported: every layer must be sparse")
        gemmaish = is_gemma or is_gemma2
        hidden_act = cfg.get("hidden_act") or cfg.get(
            "hidden_activation") or ("gelu_tanh" if gemmaish else "silu")
        return ModelConfig(
            name=name or cfg.get("_name_or_path", "hf-model"),
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"],
            num_kv_heads=cfg.get("num_key_value_heads",
                                 cfg["num_attention_heads"]),
            head_dim=cfg.get("head_dim"),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            max_position_embeddings=cfg.get("max_position_embeddings", 4096),
            sliding_window=(cfg.get("sliding_window")
                            if (is_llama_like or is_gemma2) else None),
            alternating_sliding=is_gemma2,
            attn_logit_softcap=(cfg.get("attn_logit_softcapping")
                                if is_gemma2 else None),
            final_logit_softcap=(cfg.get("final_logit_softcapping")
                                 if is_gemma2 else None),
            query_pre_attn_scalar=(cfg.get("query_pre_attn_scalar")
                                   if is_gemma2 else None),
            sandwich_norms=is_gemma2,
            rope_scaling=_rope_scaling_spec(cfg.get("rope_scaling")),
            tie_word_embeddings=cfg.get("tie_word_embeddings", gemmaish),
            attention_bias=cfg.get("attention_bias",
                                   is_qwen2 or is_qwen2_moe),
            activation="gelu_tanh" if "gelu" in hidden_act else "silu",
            rms_norm_offset=gemmaish,
            embed_scale=gemmaish,
            num_experts=(cfg.get("num_local_experts", 0) if is_mixtral
                         else cfg.get("num_experts", 0) if is_qwen2_moe
                         else 0),
            num_experts_per_tok=cfg.get("num_experts_per_tok", 2),
            norm_topk_prob=cfg.get("norm_topk_prob", False)
            if is_qwen2_moe else True,
            moe_intermediate_size=cfg.get("moe_intermediate_size")
            if is_qwen2_moe else None,
            shared_expert_size=cfg.get("shared_expert_intermediate_size",
                                       0) if is_qwen2_moe else 0,
            moe_naming="qwen2" if is_qwen2_moe else "mixtral",
            dtype=dtype,
        )

    @staticmethod
    def from_json(path: str, dtype: Any = torch.bfloat16) -> "ModelConfig":
        with open(os.path.join(path, "config.json")
                  if os.path.isdir(path) else path) as f:
            return ModelConfig.from_hf_config(json.load(f), name=path,
                                              dtype=dtype)


# ---------------------------------------------------------------------------
# Presets. Dimensions are the publicly documented architecture shapes.
# ---------------------------------------------------------------------------

PRESETS: Dict[str, ModelConfig] = {
    "debug-tiny": ModelConfig(
        name="debug-tiny", vocab_size=512, hidden_size=128,
        intermediate_size=384, num_layers=2, num_heads=4, num_kv_heads=2,
        max_position_embeddings=512,
    ),
    "tinyllama-1.1b": ModelConfig(
        name="tinyllama-1.1b", vocab_size=32000, hidden_size=2048,
        intermediate_size=5632, num_layers=22, num_heads=32, num_kv_heads=4,
        max_position_embeddings=2048,
    ),
    "llama-3-8b": ModelConfig(
        name="llama-3-8b", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        rope_theta=500000.0, max_position_embeddings=8192,
    ),
    "llama-3.1-8b": ModelConfig(
        name="llama-3.1-8b", vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32,
        num_kv_heads=8, rope_theta=500000.0,
        max_position_embeddings=131072,
        rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192),
    ),
    "llama-3-70b": ModelConfig(
        name="llama-3-70b", vocab_size=128256, hidden_size=8192,
        intermediate_size=28672, num_layers=80, num_heads=64, num_kv_heads=8,
        rope_theta=500000.0, max_position_embeddings=8192,
    ),
    "llama-3.2-1b": ModelConfig(
        name="llama-3.2-1b", vocab_size=128256, hidden_size=2048,
        intermediate_size=8192, num_layers=16, num_heads=32,
        num_kv_heads=8, head_dim=64, rope_theta=500000.0,
        max_position_embeddings=131072, tie_word_embeddings=True,
        rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192),
    ),
    "llama-3.2-3b": ModelConfig(
        name="llama-3.2-3b", vocab_size=128256, hidden_size=3072,
        intermediate_size=8192, num_layers=28, num_heads=24,
        num_kv_heads=8, head_dim=128, rope_theta=500000.0,
        max_position_embeddings=131072, tie_word_embeddings=True,
        rope_scaling=("llama3", 32.0, 1.0, 4.0, 8192),
    ),
    "llama-3.1-70b": ModelConfig(
        name="llama-3.1-70b", vocab_size=128256, hidden_size=8192,
        intermediate_size=28672, num_layers=80, num_heads=64,
        num_kv_heads=8, rope_theta=500000.0,
        max_position_embeddings=131072,
        rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192),
    ),
    "mistral-7b": ModelConfig(
        name="mistral-7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        max_position_embeddings=32768,
    ),
    "mistral-7b-v0.1": ModelConfig(
        name="mistral-7b-v0.1", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32,
        num_kv_heads=8, max_position_embeddings=32768,
        sliding_window=4096,
    ),
    "debug-sliding": ModelConfig(
        name="debug-sliding", vocab_size=512, hidden_size=128,
        intermediate_size=384, num_layers=2, num_heads=4, num_kv_heads=2,
        max_position_embeddings=512, sliding_window=64,
    ),
    "qwen2-7b": ModelConfig(
        name="qwen2-7b", vocab_size=152064, hidden_size=3584,
        intermediate_size=18944, num_layers=28, num_heads=28,
        num_kv_heads=4, rope_theta=1000000.0,
        max_position_embeddings=32768, attention_bias=True,
    ),
    "gemma-2b": ModelConfig(
        name="gemma-2b", vocab_size=256000, hidden_size=2048,
        intermediate_size=16384, num_layers=18, num_heads=8,
        num_kv_heads=1, head_dim=256, max_position_embeddings=8192,
        rms_norm_eps=1e-6,
        tie_word_embeddings=True, activation="gelu_tanh",
        rms_norm_offset=True, embed_scale=True,
    ),
    "debug-moe": ModelConfig(
        name="debug-moe", vocab_size=512, hidden_size=128,
        intermediate_size=256, num_layers=2, num_heads=4, num_kv_heads=2,
        max_position_embeddings=512, num_experts=4, num_experts_per_tok=2,
    ),
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32,
        num_kv_heads=8, rope_theta=1000000.0,
        max_position_embeddings=32768, num_experts=8,
        num_experts_per_tok=2,
    ),
    "qwen1.5-moe-a2.7b": ModelConfig(
        name="qwen1.5-moe-a2.7b", vocab_size=151936, hidden_size=2048,
        intermediate_size=5632, num_layers=24, num_heads=16,
        num_kv_heads=16, rope_theta=1000000.0,
        max_position_embeddings=8192, attention_bias=True,
        num_experts=60, num_experts_per_tok=4, norm_topk_prob=False,
        moe_intermediate_size=1408, shared_expert_size=5632,
        moe_naming="qwen2",
    ),
    "gemma-2-2b": ModelConfig(
        name="gemma-2-2b", vocab_size=256000, hidden_size=2304,
        intermediate_size=9216, num_layers=26, num_heads=8,
        num_kv_heads=4, head_dim=256, max_position_embeddings=8192,
        rms_norm_eps=1e-6,
        tie_word_embeddings=True, activation="gelu_tanh",
        rms_norm_offset=True, embed_scale=True,
        sliding_window=4096, alternating_sliding=True,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        query_pre_attn_scalar=256.0, sandwich_norms=True,
    ),
    "gemma-2-9b": ModelConfig(
        name="gemma-2-9b", vocab_size=256000, hidden_size=3584,
        intermediate_size=14336, num_layers=42, num_heads=16,
        num_kv_heads=8, head_dim=256, max_position_embeddings=8192,
        rms_norm_eps=1e-6,
        tie_word_embeddings=True, activation="gelu_tanh",
        rms_norm_offset=True, embed_scale=True,
        sliding_window=4096, alternating_sliding=True,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        query_pre_attn_scalar=256.0, sandwich_norms=True,
    ),
    "debug-gemma2": ModelConfig(
        name="debug-gemma2", vocab_size=512, hidden_size=128,
        intermediate_size=384, num_layers=2, num_heads=4,
        num_kv_heads=2, max_position_embeddings=512,
        rms_norm_eps=1e-6,
        tie_word_embeddings=True, activation="gelu_tanh",
        rms_norm_offset=True, embed_scale=True,
        sliding_window=64, alternating_sliding=True,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        query_pre_attn_scalar=32.0, sandwich_norms=True,
    ),
    "gemma-7b": ModelConfig(
        name="gemma-7b", vocab_size=256000, hidden_size=3072,
        intermediate_size=24576, num_layers=28, num_heads=16,
        num_kv_heads=16, head_dim=256, max_position_embeddings=8192,
        rms_norm_eps=1e-6,
        tie_word_embeddings=True, activation="gelu_tanh",
        rms_norm_offset=True, embed_scale=True,
    ),
}

PRESETS["qwen2.5-7b"] = dataclasses.replace(PRESETS["qwen2-7b"],
                                            name="qwen2.5-7b")


HF_ALIASES: Dict[str, str] = {
    "meta-llama/Meta-Llama-3-8B": "llama-3-8b",
    "meta-llama/Meta-Llama-3-8B-Instruct": "llama-3-8b",
    "meta-llama/Llama-3.1-8B": "llama-3.1-8b",
    "meta-llama/Llama-3.1-8B-Instruct": "llama-3.1-8b",
    "meta-llama/Meta-Llama-3-70B": "llama-3-70b",
    "meta-llama/Meta-Llama-3-70B-Instruct": "llama-3-70b",
    "meta-llama/Llama-3.1-70B-Instruct": "llama-3.1-70b",
    "mistralai/Mistral-7B-v0.1": "mistral-7b-v0.1",
    "mistralai/Mistral-7B-Instruct-v0.2": "mistral-7b",
    "mistralai/Mistral-7B-Instruct-v0.3": "mistral-7b",
    "TinyLlama/TinyLlama-1.1B-Chat-v1.0": "tinyllama-1.1b",
    "Qwen/Qwen2-7B": "qwen2-7b",
    "Qwen/Qwen2-7B-Instruct": "qwen2-7b",
    "Qwen/Qwen2.5-7B": "qwen2.5-7b",
    "Qwen/Qwen2.5-7B-Instruct": "qwen2.5-7b",
    "mistralai/Mixtral-8x7B-v0.1": "mixtral-8x7b",
    "mistralai/Mixtral-8x7B-Instruct-v0.1": "mixtral-8x7b",
    "Qwen/Qwen1.5-MoE-A2.7B": "qwen1.5-moe-a2.7b",
    "Qwen/Qwen1.5-MoE-A2.7B-Chat": "qwen1.5-moe-a2.7b",
    "google/gemma-2b": "gemma-2b",
    "google/gemma-2b-it": "gemma-2b",
    "google/gemma-7b": "gemma-7b",
    "google/gemma-7b-it": "gemma-7b",
    "meta-llama/Llama-3.2-1B": "llama-3.2-1b",
    "meta-llama/Llama-3.2-1B-Instruct": "llama-3.2-1b",
    "meta-llama/Llama-3.2-3B": "llama-3.2-3b",
    "meta-llama/Llama-3.2-3B-Instruct": "llama-3.2-3b",
    "google/gemma-2-2b": "gemma-2-2b",
    "google/gemma-2-2b-it": "gemma-2-2b",
    "google/gemma-2-9b": "gemma-2-9b",
    "google/gemma-2-9b-it": "gemma-2-9b",
}


def get_config(name: str) -> ModelConfig:
    if name in PRESETS:
        return PRESETS[name]
    if name in HF_ALIASES:
        return dataclasses.replace(PRESETS[HF_ALIASES[name]], name=name)
    if os.path.exists(name):
        return ModelConfig.from_json(name)
    raise KeyError(
        f"unknown model {name!r}; presets: {sorted(PRESETS)}, known HF ids: "
        f"{sorted(HF_ALIASES)}, or a path to an HF checkpoint directory")
