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

Where JAX forks its executables on ``penalized`` and ``topk``, these
are arguments here: a batch with a shaped row runs
``sampler.adjust_logits`` before the pick (decode windows carry the
[B, V] counts of generated tokens on the device and add each step's ids
to them), and a batch that asks for alternatives takes the top K of the
same log-softmax the chosen logprob comes from. A batch with neither
runs exactly the launches it ran before either existed.

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
from production_stack_tpu_torch.engine.sampler import (SamplingParams,
                                                      adjust_logits, sample)
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.kv import (KVCache, make_cache,
                                                  make_slot_cache)
from production_stack_tpu_torch.models.quant import quantize_params
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

_KV_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
              "int8": torch.int8}


# top-K alternatives: (token ids int32, logprobs f32), [B, K] from a
# pick and [B, steps, K] from a decode window
Tops = Optional[Tuple[torch.Tensor, torch.Tensor]]

# prompt logprobs: vocabulary rows of the LM head materialized at once
_PROMPT_LP_CHUNK = 256


def _pick(logits: torch.Tensor, sampling: SamplingParams,
          generator: torch.Generator, positions: torch.Tensor, *,
          greedy: bool, seeded: bool, plain: bool, shaping=None,
          topk: int = 0) -> Tuple[torch.Tensor, torch.Tensor, Tops]:
    """(ids int32 [B], their logprobs f32 [B], top-K or None) from f32
    logits [B, V]; positions [B]: where the sampled token lands.
    shaping (out_counts, prompt_seen, eos_id) shapes the logits first
    (the token being sampled is output index positions - prompt_len).
    Argmax for all-greedy batches, else sample(). The chosen logprob
    and the alternatives are taken under the same distribution: the
    shaped one where shaping is on, the raw model's otherwise."""
    if shaping is not None:
        counts, seen, eos_id = shaping
        logits = adjust_logits(logits, sampling, counts, seen,
                               positions - sampling.prompt_len, eos_id)
    if greedy:
        ids = torch.argmax(logits, dim=-1).to(torch.int32)
    else:
        ids = sample(logits, sampling, generator,
                     positions=positions if seeded else None, plain=plain)
    lsm = torch.log_softmax(logits, dim=-1)
    lp = lsm.gather(1, ids.long()[:, None])[:, 0]
    tops = None
    if topk:
        vals, idx = torch.topk(lsm, topk, dim=-1)
        tops = (idx.to(torch.int32), vals)
    return ids, lp, tops


def _target_logprobs(logits: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    """log p(target) of f32 logits [N, C, V] at int64 targets [N, C] by
    the JAX runner's rule (jnp.take_along_axis, mode "fill"): ids in
    [-V, 0) wrap, ids outside [-V, V) read NaN. On the device, so a
    prompt id outside the vocabulary never indexes out of bounds."""
    V = logits.shape[-1]
    idx = torch.remainder(torch.clamp(targets, -V, V - 1), V)
    lp = (logits.gather(2, idx[..., None])[..., 0]
          - torch.logsumexp(logits, dim=-1))
    inside = (targets >= -V) & (targets < V)
    return torch.where(inside, lp, torch.full_like(lp, float("nan")))


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
        # logit-shaping carry [B, V]: generated-token counts (int32) and
        # prompt membership (bool), uploaded by set_penalty_state
        self._dec_counts: Optional[torch.Tensor] = None
        self._dec_seen: Optional[torch.Tensor] = None
        # the EOS id min_tokens bans (the engine sets its tokenizer's)
        self.eos_id = 0

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

    def set_penalty_state(self, out_counts: np.ndarray,
                          prompt_seen: np.ndarray) -> None:
        """Upload the logit-shaping state: generated-token counts
        [B, V] int32 (carried by the decode windows like tokens and
        positions) and prompt membership [B, V] bool."""
        self._dec_counts = torch.from_numpy(
            np.array(out_counts, np.int32)).to(self.device)
        self._dec_seen = torch.from_numpy(
            np.array(prompt_seen, bool)).to(self.device)

    def _shaping(self, B: int):
        return self._dec_counts[:B], self._dec_seen[:B], self.eos_id

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        """A host int32 array as a device tensor (copied: the host
        mirror may change while the device still reads it)."""
        return torch.from_numpy(np.array(x, np.int32)).to(self.device)

    # ------------------------------------------------------------------

    @torch.no_grad()
    def decode(self, sampling: SamplingParams, steps: int = 1,
               kv_len: Optional[int] = None, greedy: bool = False,
               seeded: bool = False, plain: bool = False,
               penalized: bool = False, topk: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor, Tops]:
        """A window of `steps` decode steps over the carried batch.
        Returns device (ids int32 [B, steps], logprobs f32 [B, steps],
        top-K [B, steps, K] or None); reading them is the window's one
        host sync. Attention reads the first ceil(kv_len/Bs) blocks; the
        engine guarantees every live position stays < kv_len and its
        table row covers the window. penalized: shape every step's
        logits with the carried counts (set_penalty_state), which each
        step's ids then join."""
        S = self.engine_cfg.max_model_len
        kv_len = kv_len or S
        toks, pos = self._dec_tokens, self._dec_pos
        B = toks.shape[0]
        sampling = sampling.rows(B)
        tables = self._dev_tables()[:B]
        shaping = self._shaping(B) if penalized else None
        ids, lps, tops = [], [], []
        for _ in range(steps):
            logits, _ = llama.forward(
                self.params, self.model_cfg, toks[:, None], pos[:, None],
                self.cache, block_tables=tables, rope=self.rope,
                kv_len=kv_len, token_valid=(pos < S)[:, None],
                sampled_ids=True)
            tok, lp, top = _pick(logits[:, 0], sampling, self._generator,
                                 pos + 1, greedy=greedy, seeded=seeded,
                                 plain=plain, shaping=shaping, topk=topk)
            if shaping is not None:
                counts, seen, eos_id = shaping
                counts = counts.scatter_add(
                    1, tok.long()[:, None],
                    torch.ones_like(tok, dtype=torch.int32)[:, None])
                shaping = (counts, seen, eos_id)
            ids.append(tok)
            lps.append(lp)
            tops.append(top)
            toks, pos = tok, pos + 1
        self._dec_tokens, self._dec_pos = toks, pos
        if shaping is not None:
            self._dec_counts = shaping[0]
        out_tops = None
        if topk:
            out_tops = (torch.stack([t[0] for t in tops], dim=1),
                        torch.stack([t[1] for t in tops], dim=1))
        return torch.stack(ids, dim=1), torch.stack(lps, dim=1), out_tops

    @torch.no_grad()
    def prefill(self, tokens: np.ndarray, starts: np.ndarray,
                lengths: np.ndarray, sampling: SamplingParams,
                kv_len: int, greedy: bool = False, seeded: bool = False,
                plain: bool = False, penalized: bool = False,
                topk: int = 0) -> Tuple[torch.Tensor, torch.Tensor, Tops]:
        """Full-batch chunk prefill. tokens [B, Tb], starts/lengths [B]
        (host int32). Every row writes its chunk at its own offset
        through its table; idle rows (parked at start = max_model_len)
        and right padding write to the trash block. Returns device
        (id sampled after each row's last real token [B], its logprob
        [B], top-K [B, K] or None). penalized: the first sampled token
        takes the shaping, with the uploaded counts (the emitted output
        of a row resumed after preemption) and prompt membership."""
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
        B = toks.shape[0]
        return _pick(logits[:, 0], sampling.rows(B), self._generator,
                     st + torch.clamp(ln, min=1), greedy=greedy,
                     seeded=seeded, plain=plain,
                     shaping=self._shaping(B) if penalized else None,
                     topk=topk)

    @torch.no_grad()
    def prompt_logprobs(self, tokens: np.ndarray) -> torch.Tensor:
        """Teacher-forced logprobs of a prompt batch: tokens [N, T] host
        int32 -> f32 [N, T-1] on the device, entry t = log p(tokens[t+1]
        | tokens[:t+1]) under the raw model distribution (rows shorter
        than T are right-padded; their entries past len-1 are padding).
        The prompt runs through the paged kernels over a pool of its own
        (the serving pool is not touched, so this may run beside the
        engine loop) in prefill_chunk chunks, and the LM head in chunks
        of 256 positions, so one [N, 256, V] f32 slab exists at a time;
        Gemma-2's final softcap and an int8 head's per-vocab scale apply
        as in serving (llama.final_logits). A target id outside the
        vocabulary reads as jnp.take_along_axis reads it in the JAX
        runner (_target_logprobs)."""
        cfg, ecfg = self.model_cfg, self.engine_cfg
        N, T = tokens.shape
        if T > ecfg.max_model_len:
            raise ValueError(f"prompt length {T} exceeds max_model_len "
                             f"{ecfg.max_model_len}")
        Bs = ecfg.kv_block_size
        cache, tables = make_slot_cache(
            cfg.num_layers, N, -(-T // Bs) * Bs, cfg.num_kv_heads,
            cfg.head_dim_, dtype=self.cache.k.dtype, block_size=Bs,
            device=self.device)
        toks = self._upload(tokens)
        out = []
        for lo in range(0, T - 1, ecfg.prefill_chunk):
            hi = min(lo + ecfg.prefill_chunk, T)
            pos = torch.arange(lo, hi, device=self.device,
                               dtype=torch.int32)[None].expand(N, -1)
            x = llama.hidden(self.params, cfg, toks[:, lo:hi], pos, cache,
                             block_tables=tables, rope=self.rope,
                             kv_len=hi)
            for c0 in range(lo, min(hi, T - 1), _PROMPT_LP_CHUNK):
                c1 = min(c0 + _PROMPT_LP_CHUNK, hi, T - 1)
                logits = llama.final_logits(self.params, cfg,
                                            x[:, c0 - lo:c1 - lo])
                out.append(_target_logprobs(
                    logits, toks[:, c0 + 1:c1 + 1].long()))
        del cache
        if not out:
            return torch.zeros((N, 0), dtype=torch.float32,
                               device=self.device)
        return torch.cat(out, dim=1)

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
