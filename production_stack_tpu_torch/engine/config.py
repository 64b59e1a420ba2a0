"""Engine configuration: a copy of ``production_stack_tpu/engine/config.py``
plus ``device``.

The fields keep their names and meaning, so a JAX-package config maps
onto this one field by field. The MoE capacity factor
(``moe_capacity_factor``), weight-only int8 (``quantization="int8"``),
the int8 KV pool (``kv_dtype="int8"``), n-gram speculation
(``speculative_ngram_tokens`` in 0..16), multi-LoRA (``lora_adapters``
with ``lora_rank``, ``lora_alpha`` and ``lora_targets``), an HF
checkpoint directory (``checkpoint``), KV tiering and disaggregated
prefill (``kv_transfer_config``, kvcache/connector.py) and the kvplane's
free-list defrag (``kvplane_defrag``) are taken as the JAX config takes
them. Options the port does not implement yet raise here instead of
being ignored: an embedding encoder (``embedding_model``; the pooling
routes serve the causal model's mean-pooled hidden states), multi-device
parallelism, adaptive decode windows and pipelined windows (the last two
default to off here, where the JAX engine turns them on; speculation
pins the adaptive windows off in the JAX engine too). They arrive with
the slices that need them (ROADMAP.md, Queue A).
"""

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from production_stack_tpu_torch.utils import resolve_device


@dataclasses.dataclass
class EngineConfig:
    model: str = "debug-tiny"
    tokenizer: Optional[str] = None          # defaults to model path
    chat_template: Optional[str] = None      # Jinja file overriding the
                                             # tokenizer's chat template
    max_model_len: int = 2048                # max prompt+generation length
    max_num_seqs: int = 8                    # concurrent batch slots
    prefill_chunk: int = 512                 # chunked-prefill chunk size
    # prefill chunks are padded up to these lengths
    prefill_buckets: Tuple[int, ...] = (16, 32, 64, 128, 256, 512)
    # decode tokens generated per window: one host sync per window
    decode_window: int = 8
    # adaptive window sizing and compaction (JAX engine, docs/engine.md
    # "Continuous batching across windows"): not ported, must stay off
    window_adapt: bool = False
    # windows queued ahead of the host: not ported, must stay 1
    pipeline_depth: int = 1
    # attention reads the first ceil(kv_len / Bs) blocks, kv_len the
    # smallest bucket covering every live position
    kv_len_buckets: Tuple[int, ...] = ()
    kv_block_size: int = 64
    kv_pool_tokens: Optional[int] = None
    dtype: str = "bfloat16"
    kv_dtype: str = "bfloat16"
    tensor_parallel_size: int = 1
    pipeline_parallel_size: int = 1
    expert_parallel_size: int = 1
    # MoE prefill capacity factor override (ops/moe.py): None keeps the
    # model family default (ModelConfig.moe_capacity_factor)
    moe_capacity_factor: Optional[float] = None
    quantization: Optional[str] = None
    # n-gram (prompt-lookup) speculative decoding: draft length per
    # macro-step (0 = off). Only greedy, unguided, unshaped,
    # no-alternatives rows speculate; other rows single-step inside the
    # same window (engine/runner.decode_spec)
    speculative_ngram_tokens: int = 0
    seed: int = 0
    # HF checkpoint directory (*.safetensors, else *.bin) loaded in
    # place of random weights (models/hf_loader.py)
    checkpoint: Optional[str] = None
    embedding_model: Optional[str] = None
    enable_prefix_caching: bool = False
    # KV tiering (kvcache/connector.KVTransferConfig's fields): the
    # engine publishes and consumes KV chunks through host, disk and
    # remote tiers as its kv_role says
    kv_transfer_config: Optional[Dict[str, Any]] = None
    # kvplane intra-replica defrag: compact the free block list between
    # steps after fragmented allocation failures
    kvplane_defrag: bool = True
    # multi-LoRA: name -> .npz path (models/lora.py format) or
    # "random:SEED"; each adapter is served as its own model id. Rank,
    # alpha and targets are shared by every adapter of an engine,
    # runtime loads (/admin/lora/load) included
    lora_adapters: Optional[Dict[str, str]] = None
    lora_rank: int = 8
    lora_alpha: float = 16.0
    lora_targets: Tuple[str, ...] = ("q", "v")
    # overload protection: add_request raises AdmissionRejected (the
    # server answers 503 + Retry-After) once this many sequences wait
    # un-admitted beyond what the free slots absorb. None = unbounded
    max_waiting_seqs: Optional[int] = None
    # a sequence still waiting (never admitted) after this many
    # milliseconds is shed (finish_reason "queue_delay" -> 503). None =
    # never
    max_queue_delay_ms: Optional[float] = None
    # the device-memory peak the MBU gauge normalizes against (GB/s):
    # an NVIDIA H100 SXM's 3,350 GB/s of HBM3 (NVIDIA's data sheet)
    hbm_peak_gbps: float = 3350.0
    # the device every tensor of the engine lives on. "cuda" runs the
    # hand-written kernels; "cpu" runs their plain versions and must be
    # asked for. CUDA requested where there is none raises.
    device: str = "cuda"

    def __post_init__(self):
        resolve_device(self.device)
        if self.dtype not in ("bfloat16", "float32"):
            raise ValueError(f"dtype={self.dtype!r} unsupported: bfloat16 "
                             f"or float32")
        if self.kv_dtype not in ("bfloat16", "float32", "int8"):
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r} unsupported: bfloat16, "
                f"float32, or int8 (quantized cache — halves "
                f"long-context decode KV traffic, models/kv.py)")
        if self.quantization not in (None, "int8"):
            raise ValueError(
                f"quantization={self.quantization!r} unsupported: only "
                f"weight-only 'int8' (models/quant.py) is implemented")
        if not 0 <= self.speculative_ngram_tokens <= 16:
            raise ValueError("speculative_ngram_tokens must be in 0..16")
        not_ported = {
            "tensor_parallel_size": self.tensor_parallel_size != 1,
            "pipeline_parallel_size": self.pipeline_parallel_size != 1,
            "expert_parallel_size": self.expert_parallel_size != 1,
            "embedding_model": self.embedding_model is not None,
            "window_adapt": self.window_adapt,
            "pipeline_depth": self.pipeline_depth != 1,
        }
        bad = [k for k, v in not_ported.items() if v]
        if bad:
            raise NotImplementedError(
                f"{', '.join(bad)}: not implemented in the PyTorch port yet")
        if self.kv_block_size < 8 or self.kv_block_size % 8:
            raise ValueError(f"kv_block_size={self.kv_block_size} must be "
                             f"a multiple of 8")
        self.kv_block_size = min(
            self.kv_block_size, max(8, (self.max_model_len + 7) // 8 * 8))
        if self.kv_pool_tokens is not None and self.kv_pool_tokens <= 0:
            raise ValueError("kv_pool_tokens must be positive")
        if self.max_waiting_seqs is not None and self.max_waiting_seqs < 0:
            raise ValueError("max_waiting_seqs must be >= 0 "
                             "(0 sheds anything that cannot be admitted "
                             "immediately; None = unbounded)")
        if self.max_queue_delay_ms is not None \
                and self.max_queue_delay_ms <= 0:
            raise ValueError("max_queue_delay_ms must be positive")
        if self.hbm_peak_gbps <= 0:
            raise ValueError("hbm_peak_gbps must be positive")
        self.prefill_chunk = min(self.prefill_chunk, self.max_model_len)
        buckets = sorted(b for b in self.prefill_buckets
                         if b <= self.prefill_chunk)
        if not buckets or buckets[-1] < self.prefill_chunk:
            buckets.append(self.prefill_chunk)
        self.prefill_buckets = tuple(buckets)
        self.decode_window = max(1, min(self.decode_window,
                                        self.max_model_len))
        if not self.kv_len_buckets:
            b, buckets = 512, []
            while b < self.max_model_len:
                buckets.append(b)
                b *= 2
            buckets.append(self.max_model_len)
            self.kv_len_buckets = tuple(buckets)
        else:
            buckets = sorted(b for b in self.kv_len_buckets
                             if 0 < b <= self.max_model_len)
            if not buckets or buckets[-1] < self.max_model_len:
                buckets.append(self.max_model_len)
            self.kv_len_buckets = tuple(buckets)

    @property
    def torch_device(self) -> torch.device:
        return resolve_device(self.device)

    @property
    def max_blocks_per_seq(self) -> int:
        """Block-table width MB: blocks covering max_model_len."""
        return -(-self.max_model_len // self.kv_block_size)

    @property
    def num_kv_blocks(self) -> int:
        """Pool size in blocks, INCLUDING trash block 0, clamped to
        [one full-length sequence, worst case for the whole batch]."""
        worst = self.max_num_seqs * self.max_blocks_per_seq
        if self.kv_pool_tokens is None:
            n = worst
        else:
            n = -(-self.kv_pool_tokens // self.kv_block_size)
        return min(max(n, self.max_blocks_per_seq), worst) + 1

    def bucket_for(self, length: int) -> int:
        for b in self.prefill_buckets:
            if length <= b:
                return b
        return self.prefill_buckets[-1]

    def kv_bucket_for(self, length: int) -> int:
        """Smallest kv-length bucket covering `length` cache positions."""
        for b in self.kv_len_buckets:
            if length <= b:
                return b
        return self.kv_len_buckets[-1]
