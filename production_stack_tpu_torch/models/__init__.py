"""The dense Llama decoder, its configurations and the paged KV pool."""

from production_stack_tpu_torch.models.config import (HF_ALIASES, PRESETS,
                                                      ModelConfig,
                                                      get_config)
from production_stack_tpu_torch.models.kv import (KVCache, make_cache,
                                                  make_slot_cache)

__all__ = ["HF_ALIASES", "PRESETS", "ModelConfig", "get_config", "KVCache",
           "make_cache", "make_slot_cache"]
