"""ModelRunner: owns the weights, the paged KV pool and the device-side
decode state (``production_stack_tpu/engine/runner.py``).

- ``decode``: a window of W forward+sample steps in a Python loop. The
  sampled ids and advanced positions stay on the device and feed the
  next step and the next window directly; the host syncs once per
  window, when the engine reads the window's ids. The batch is the
  carried one (``set_decode_state``): free slots run as parked rows at
  position ``max_model_len``, whose writes go to the trash block.
- ``prefill``: full batch — every admissible sequence's next chunk in
  one forward, idle rows parked at ``max_model_len`` and right padding
  masked by ``token_valid``. Logits are computed at each row's last
  real token only.

PyTorch runs eagerly, so there is no executable cache and nothing to
fall back from: on CUDA tensors attention runs the hand-written kernels
(ops/paged_attention.py) or raises. CUDA graphs of the decode step are
later work. The pool is updated in place (models/kv.write_chunk).

``quantization="int8"`` quantizes the weights on their device right
after they are made or handed in (the given module is quantized in
place, as JAX consumes its donated params); ``kv_dtype="int8"``
allocates the int8 pool with its scales.
"""

import time
from typing import Optional, Tuple

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.sampler import SamplingParams, sample
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.kv import KVCache, make_cache
from production_stack_tpu_torch.models.quant import quantize_params
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

_KV_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
              "int8": torch.int8}


def _pick(logits: torch.Tensor, sampling: SamplingParams,
          generator: torch.Generator, positions: torch.Tensor, *,
          greedy: bool, seeded: bool,
          plain: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids int32 [B], their logprobs f32 [B]) from f32 logits [B, V]:
    argmax for all-greedy batches, else sample(); the logprob is the
    chosen token's under the raw model distribution."""
    if greedy:
        ids = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        ids = sample(logits, sampling, generator,
                     positions=positions if seeded else None, plain=plain)
    lp = torch.log_softmax(logits, dim=-1).gather(
        1, ids.long()[:, None])[:, 0]
    return ids, lp


class ModelRunner:
    def __init__(self, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 params: Optional[llama.Llama] = None):
        self.model_cfg = model_cfg
        self.engine_cfg = engine_cfg
        self.device = engine_cfg.torch_device
        # the rope table covers the cache length, not just the model's
        # native maximum
        self.rope = llama.rope_tensors(model_cfg, engine_cfg.max_model_len,
                                       self.device)
        if params is None:
            t0 = time.time()
            gen = torch.Generator(device=self.device).manual_seed(
                engine_cfg.seed)
            params = llama.init_params(model_cfg, gen, device=self.device)
            logger.info("random-initialized %s on %s (%.2fs)",
                        model_cfg.name, self.device, time.time() - t0)
        if engine_cfg.quantization == "int8":
            t0 = time.time()
            params = quantize_params(params)
            logger.info("quantized %s to int8 weights (%.2fs)",
                        model_cfg.name, time.time() - t0)
        self.params = params
        self.cache: KVCache = make_cache(
            model_cfg.num_layers, engine_cfg.num_kv_blocks,
            engine_cfg.kv_block_size, model_cfg.num_kv_heads,
            model_cfg.head_dim_, dtype=_KV_DTYPES[engine_cfg.kv_dtype],
            device=self.device)
        shape = (engine_cfg.max_num_seqs, engine_cfg.max_blocks_per_seq)
        self._tables_host = np.zeros(shape, np.int32)
        self._tables = torch.zeros(shape, dtype=torch.int32,
                                   device=self.device)
        self._tables_dirty = False
        self._generator = torch.Generator(device=self.device).manual_seed(
            engine_cfg.seed ^ 0x5EED)
        # device-carried decode inputs [B]: refreshed from host mirrors
        # only when the engine marks them stale
        self._dec_tokens: Optional[torch.Tensor] = None
        self._dec_pos: Optional[torch.Tensor] = None

    # ------------------------------------------------------------------

    def set_block_tables(self, tables: np.ndarray) -> None:
        """Note a change to the host block-table mirror [B, MB] int32;
        the upload waits for the next dispatch that reads the tables,
        so several row changes cost one copy."""
        self._tables_host = tables
        self._tables_dirty = True

    def _dev_tables(self) -> torch.Tensor:
        if self._tables_dirty:
            self._tables = self._upload(self._tables_host)
            self._tables_dirty = False
        return self._tables

    def set_decode_state(self, tokens: np.ndarray,
                         positions: np.ndarray) -> None:
        """Upload fresh decode inputs (host mirrors -> device carry)."""
        self._dec_tokens = self._upload(tokens)
        self._dec_pos = self._upload(positions)

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """A host int32 array as a device tensor (copied: the host
        mirror may change while the device still reads it)."""
        return torch.from_numpy(np.array(x, np.int32)).to(self.device)

    # ------------------------------------------------------------------

    @torch.no_grad()
    def decode(self, sampling: SamplingParams, steps: int = 1,
               kv_len: Optional[int] = None, greedy: bool = False,
               seeded: bool = False, plain: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """A window of `steps` decode steps over the carried batch.
        Returns device (ids int32 [B, steps], logprobs f32 [B, steps]);
        reading them is the window's one host sync. Attention reads the
        first ceil(kv_len/Bs) blocks; the engine guarantees every live
        position stays < kv_len and its table row covers the window."""
        S = self.engine_cfg.max_model_len
        kv_len = kv_len or S
        toks, pos = self._dec_tokens, self._dec_pos
        B = toks.shape[0]
        sampling = sampling.rows(B)
        tables = self._dev_tables()[:B]
        ids, lps = [], []
        for _ in range(steps):
            logits, _ = llama.forward(
                self.params, self.model_cfg, toks[:, None], pos[:, None],
                self.cache, block_tables=tables, rope=self.rope,
                kv_len=kv_len, token_valid=(pos < S)[:, None])
            tok, lp = _pick(logits[:, 0], sampling, self._generator,
                            pos + 1, greedy=greedy, seeded=seeded,
                            plain=plain)
            ids.append(tok)
            lps.append(lp)
            toks, pos = tok, pos + 1
        self._dec_tokens, self._dec_pos = toks, pos
        return torch.stack(ids, dim=1), torch.stack(lps, dim=1)

    @torch.no_grad()
    def prefill(self, tokens: np.ndarray, starts: np.ndarray,
                lengths: np.ndarray, sampling: SamplingParams,
                kv_len: int, greedy: bool = False, seeded: bool = False,
                plain: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-batch chunk prefill. tokens [B, Tb], starts/lengths [B]
        (host int32). Every row writes its chunk at its own offset
        through its table; idle rows (parked at start = max_model_len)
        and right padding write to the trash block. Returns device
        (id sampled after each row's last real token [B], its logprob
        [B])."""
        S = self.engine_cfg.max_model_len
        toks = self._upload(tokens)
        st = self._upload(starts)
        ln = self._upload(lengths)
        Tb = toks.shape[1]
        ar = torch.arange(Tb, device=self.device, dtype=torch.int32)
        positions = st[:, None] + ar[None, :]
        token_valid = (ar[None, :] < ln[:, None]) & (st < S)[:, None]
        logits, _ = llama.forward(
            self.params, self.model_cfg, toks, positions, self.cache,
            block_tables=self._dev_tables(), rope=self.rope, kv_len=kv_len,
            token_valid=token_valid,
            last_index=torch.clamp(ln - 1, min=0))
        return _pick(logits[:, 0], sampling.rows(toks.shape[0]),
                     self._generator, st + torch.clamp(ln, min=1),
                     greedy=greedy, seeded=seeded, plain=plain)

    def warmup(self) -> float:
        """One parked decode step and one parked prefill chunk: loads
        the kernels (building them if needed) and initialises the
        libraries the forward uses, so the first request pays none of
        it. Returns seconds spent."""
        t0 = time.time()
        cfg = self.engine_cfg
        B, S = cfg.max_num_seqs, cfg.max_model_len
        sampling = SamplingParams.filled(B, device=self.device)
        self.set_decode_state(np.zeros((B,), np.int32),
                              np.full((B,), S, np.int32))
        self.decode(sampling, steps=1, kv_len=cfg.kv_len_buckets[0],
                    greedy=True)
        Tb = cfg.prefill_buckets[-1]
        self.prefill(np.zeros((B, Tb), np.int32), np.full((B,), S, np.int32),
                     np.ones((B,), np.int32), sampling,
                     cfg.kv_bucket_for(Tb), greedy=True)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.time() - t0
        logger.info("warmup: one decode step + one %d-token prefill in "
                    "%.2fs", Tb, dt)
        return dt
