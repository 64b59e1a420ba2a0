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
runs exactly the launches it ran before either existed. Guided decoding
is a third such argument: a window with a guided row takes the engine's
[G, S, V] DFA table, masks each step's logits with one [B, V] gather and
carries each row's DFA state on the device (``_pick``).

- ``decode_spec``: the decode window with per-row n-gram (prompt-lookup)
  speculation (JAX ``_decode_spec_impl``). Each macro-step drafts K
  tokens per row from the device history [B, max_model_len], verifies
  K + 1 positions in one forward (the paged decode kernel at
  K + 1 <= 8, the prefill kernel above) and emits the agreeing prefix
  plus one token; rows that do not speculate emit one token with the
  full ``_pick`` treatment.
- ``embed``: mean-pooled final hidden states of padded prompts
  (``llama.encode``, no cache) for the pooling routes.
- ``extract_chunk`` / ``inject_chunk``: a slot's KV positions as a
  [L, size, Hkv, D] chunk out of the pool and back (JAX
  ``runner.py:937-1018``), the KV tiers' device side
  (kvcache/connector.py). Plain PyTorch indexing, as the JAX runner's
  are plain gathers and scatters.

Multi-LoRA (models/lora.py): the runner holds the engine's adapter
stack layer-first (``set_lora``, swapped whole at a runtime load) and
the factors gathered for the batch's adapter ids (``sampling.adapter``),
regathered only when a new sampling upload or a new stack arrives — at
composition changes, never per window. ``decode``, ``decode_spec`` and
``prefill`` add the rows' deltas (JAX ``runner.py:356,445,527``); a
batch of base rows only, or an engine without adapters, launches
nothing more. ``embed`` and ``prompt_logprobs`` are the base model's, as
in JAX, so an adapter request's echoed prompt logprobs are the base
model's in both packages.

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
from production_stack_tpu_torch.models import lora as lora_mod
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.kv import (KVCache, make_cache,
                                                  make_slot_cache,
                                                  quantize_chunk)
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


# guided decoding: (table [G, S, V] int32, gids [B] int32, states [B]
# int32); row 0 of the table is the unguided placeholder (gid 0)
Guide = Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _pick(logits: torch.Tensor, sampling: SamplingParams,
          generator: torch.Generator, positions: torch.Tensor, *,
          greedy: bool, seeded: bool, plain: bool, shaping=None,
          topk: int = 0, guide: Guide = None
          ) -> Tuple[torch.Tensor, torch.Tensor, Tops,
                     Optional[torch.Tensor]]:
    """(ids int32 [B], their logprobs f32 [B], top-K or None, the guided
    rows' next DFA states [B] or None) from f32 logits [B, V];
    positions [B]: where the sampled token lands. shaping (out_counts,
    prompt_seen, eos_id) shapes the logits first (the token being
    sampled is output index positions - prompt_len); guide (table,
    gids, states) then sets every token the DFA forbids from a guided
    row's state to -inf (JAX ``_sample_position``). Argmax for
    all-greedy batches, else sample(). The chosen logprob and the
    alternatives are taken under the same distribution: the shaped and
    masked one where those are on, the raw model's otherwise. A guided
    row's state advances to the table entry of its pick (max 0: the
    dead state is never picked)."""
    if shaping is not None:
        counts, seen, eos_id = shaping
        logits = adjust_logits(logits, sampling, counts, seen,
                               positions - sampling.prompt_len, eos_id)
    if guide is not None:
        table, gids, gstate = guide
        nxt_row = table[gids.long(), gstate.long()]            # [B, V]
        is_g = (gids > 0)[:, None]
        logits = logits.masked_fill(is_g & (nxt_row < 0), float("-inf"))
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
    new_state = None
    if guide is not None:
        adv = nxt_row.gather(1, ids.long()[:, None])[:, 0]
        new_state = torch.where(gids > 0, adv.clamp(min=0), gstate)
    return ids, lp, tops, new_state


def _add_counts(shaping, tok: torch.Tensor):
    """The shaping carry with this step's ids added to the counts."""
    if shaping is None:
        return None
    counts, seen, eos_id = shaping
    counts = counts.scatter_add(
        1, tok.long()[:, None],
        torch.ones_like(tok, dtype=torch.int32)[:, None])
    return counts, seen, eos_id


def _stack_tops(tops: list) -> Tops:
    """Per-step top-K pairs -> ([B, steps, K] ids, [B, steps, K] lps)."""
    return (torch.stack([t[0] for t in tops], dim=1),
            torch.stack([t[1] for t in tops], dim=1))


def _draft(hist: torch.Tensor, pos: torch.Tensor, K: int) -> torch.Tensor:
    """The K-token drafts [B, K] (JAX ``draft_row``): for each row,
    the tokens after the latest prior occurrence i < pos of the
    bigram (hist[pos-1], hist[pos]), or after position 0 when there
    is none. Indices clamp as JAX's gathers and dynamic_slice do:
    positions into [0, S-1], the slice's start into [0, S-K]."""
    S = hist.shape[1]
    p = pos.long()[:, None]
    a = hist.gather(1, (p - 1).clamp(0, S - 1))
    c = hist.gather(1, p.clamp(0, S - 1))
    idx = torch.arange(S, device=hist.device)[None]
    m = ((idx >= 1) & (idx < p) & (torch.roll(hist, 1, dims=1) == a)
         & (hist == c))
    j = torch.where(m, idx, torch.zeros_like(idx)).amax(dim=1)
    start = (j + 1).clamp(max=S - K)
    return hist.gather(1, start[:, None] + torch.arange(
        K, device=hist.device)[None])


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
                 params: Optional[llama.Llama] = None, lora_stacked=None,
                 lora_scaling: float = 1.0):
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
        # guided DFA states [B] and the speculation history [B, S],
        # uploaded only by windows that read them (None otherwise)
        self._dec_gstate: Optional[torch.Tensor] = None
        self._dec_hist: Optional[torch.Tensor] = None
        # logit-shaping carry [B, V]: generated-token counts (int32) and
        # prompt membership (bool), uploaded by set_penalty_state
        self._dec_counts: Optional[torch.Tensor] = None
        self._dec_seen: Optional[torch.Tensor] = None
        # the EOS id min_tokens bans (the engine sets its tokenizer's)
        self.eos_id = 0
        # multi-LoRA: the layer-first stack (_lora), and the factors
        # gathered for the last batch's adapter ids (_lora_batch) under
        # the key (ids tensor, B) (_lora_key); all set by set_lora
        self._lora_scaling = lora_scaling
        self.set_lora(lora_stacked)

    # ------------------------------------------------------------------

    def set_lora(self, lora_stacked, lora_scaling: Optional[float] = None
                 ) -> None:
        """Swap the adapter stack ({proj: {a: [N+1, L, in, r], b: ...}},
        row 0 zero; None = no adapter) whole (JAX ``set_lora``: a runtime
        load restacks). Adapter ids are append-only, so a row keeps its
        index; the next dispatch regathers the batch's factors."""
        self._lora = lora_mod.layer_slice(lora_stacked)
        if lora_scaling is not None:
            self._lora_scaling = lora_scaling
        self._lora_key = self._lora_batch = None

    def _lora_rows(self, sampling: SamplingParams, B: int
                   ) -> Optional[lora_mod.Rows]:
        """The factors of the first B rows' adapters, or None when no
        adapter is loaded or every row is the base model. Gathered when
        `sampling.adapter` is a new tensor (the engine uploads one at
        each composition change) or the stack changed; the all-base test
        reads the ids back once then."""
        if self._lora is None:
            return None
        ids = sampling.adapter
        if (self._lora_key is None or self._lora_key[0] is not ids
                or self._lora_key[1] != B):
            sel = ids[:B]
            self._lora_batch = (lora_mod.gather_rows(self._lora, sel)
                                if bool((sel > 0).any()) else None)
            self._lora_key = (ids, B)
        return self._lora_batch

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

    def set_decode_state(self, tokens: np.ndarray, positions: np.ndarray,
                         guide_states: Optional[np.ndarray] = None,
                         history: Optional[np.ndarray] = None) -> None:
        """Upload fresh decode inputs (host mirrors -> device carry):
        tokens and positions [B]; the guided rows' DFA states [B] when
        a window with a guided row follows, and the token history
        [B, max_model_len] (history[b, t] = row b's token at position
        t, live through positions[b]) when a speculative one does.
        Either left None costs no upload; a guided window then starts
        every row from state 0."""
        self._dec_tokens = self._upload(tokens)
        self._dec_pos = self._upload(positions)
        self._dec_gstate = (None if guide_states is None
                            else self._upload(guide_states))
        self._dec_hist = None if history is None else self._upload(history)

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

    def _guide(self, table: Optional[torch.Tensor],
               gids: Optional[np.ndarray], states) -> Guide:
        """The guide of a window or chunk: None without a table, else
        (table, gids on the device, the DFA states; the carried ones
        where `states` is None, zeros where none are carried)."""
        if table is None:
            return None
        g = self._upload(gids)
        if states is None:
            states = (self._dec_gstate if self._dec_gstate is not None
                      else torch.zeros_like(g))
        else:
            states = self._upload(states)
        return table, g, states

    # ------------------------------------------------------------------

    @torch.no_grad()
    def decode(self, sampling: SamplingParams, steps: int = 1,
               kv_len: Optional[int] = None, greedy: bool = False,
               seeded: bool = False, plain: bool = False,
               penalized: bool = False, topk: int = 0,
               guide_table: Optional[torch.Tensor] = None,
               guide_ids: Optional[np.ndarray] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, Tops]:
        """A window of `steps` decode steps over the carried batch.
        Returns device (ids int32 [B, steps], logprobs f32 [B, steps],
        top-K [B, steps, K] or None); reading them is the window's one
        host sync. Attention reads the first ceil(kv_len/Bs) blocks; the
        engine guarantees every live position stays < kv_len and its
        table row covers the window. penalized: shape every step's
        logits with the carried counts (set_penalty_state), which each
        step's ids then join. guide_table [G, S, V] int32 with guide_ids
        [B] (0 = unguided): mask every step from the carried DFA
        states, which each step's ids advance."""
        S = self.engine_cfg.max_model_len
        kv_len = kv_len or S
        toks, pos = self._dec_tokens, self._dec_pos
        B = toks.shape[0]
        # keyed on the uploaded tensor, so before rows() slices it
        lora = self._lora_rows(sampling, B)
        sampling = sampling.rows(B)
        tables = self._dev_tables()[:B]
        shaping = self._shaping(B) if penalized else None
        guide = self._guide(guide_table, guide_ids, None)
        ids, lps, tops = [], [], []
        for _ in range(steps):
            logits, _ = llama.forward(
                self.params, self.model_cfg, toks[:, None], pos[:, None],
                self.cache, block_tables=tables, rope=self.rope,
                kv_len=kv_len, token_valid=(pos < S)[:, None],
                sampled_ids=True, lora_rows=lora,
                lora_scaling=self._lora_scaling)
            tok, lp, top, gstate = _pick(
                logits[:, 0], sampling, self._generator, pos + 1,
                greedy=greedy, seeded=seeded, plain=plain, shaping=shaping,
                topk=topk, guide=guide)
            shaping = _add_counts(shaping, tok)
            if guide is not None:
                guide = (guide[0], guide[1], gstate)
            ids.append(tok)
            lps.append(lp)
            tops.append(top)
            toks, pos = tok, pos + 1
        self._dec_tokens, self._dec_pos = toks, pos
        if shaping is not None:
            self._dec_counts = shaping[0]
        if guide is not None:
            self._dec_gstate = guide[2]
        return (torch.stack(ids, dim=1), torch.stack(lps, dim=1),
                _stack_tops(tops) if topk else None)

    @torch.no_grad()
    def decode_spec(self, sampling: SamplingParams, steps: int,
                    kv_len: int, spec: int, spec_ok: np.ndarray,
                    greedy: bool = False, seeded: bool = False,
                    plain: bool = False, penalized: bool = False,
                    topk: int = 0,
                    guide_table: Optional[torch.Tensor] = None,
                    guide_ids: Optional[np.ndarray] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               Tops]:
        """A decode window of `steps` macro-steps with per-row n-gram
        speculation over the carried batch and history (JAX
        ``_decode_spec_impl``). spec_ok [B] bool marks the rows that
        speculate (greedy, unshaped, unguided, no alternatives: the
        engine decides per row).

        Each macro-step drafts `spec` = K tokens per row (_draft) and
        verifies the K + 1 positions in one forward (token_valid:
        position < max_model_len). Position 0 takes the whole _pick
        treatment — shaping, the guided mask, sampling when the batch
        is not all greedy, top-K — so every row emits what decode()
        would have; positions 1..K take their logprobs from the raw f32
        log-softmax and their tokens from the argmax. A speculating row
        accepts the drafts that agree with the argmax up to the first
        that does not, and emits accepted + 1 tokens (every one an
        argmax given the true prefix: exact greedy); any other row
        emits one. The K + 1 tokens are written into the history at
        pos + 1 (the start clamped into [0, S - K - 1], as JAX's
        dynamic_update_slice clamps it); rejected positions' K/V past
        the live length are rewritten before anything reads them.

        Returns device (ids int32 [B, steps, K+1], logprobs f32
        [B, steps, K+1], counts int32 [B, steps] of emitted tokens,
        top-K [B, steps, K] or None)."""
        S = self.engine_cfg.max_model_len
        K = spec
        toks, pos, hist = self._dec_tokens, self._dec_pos, self._dec_hist
        B = toks.shape[0]
        # keyed on the uploaded tensor, so before rows() slices it
        lora = self._lora_rows(sampling, B)
        sampling = sampling.rows(B)
        tables = self._dev_tables()[:B]
        shaping = self._shaping(B) if penalized else None
        guide = self._guide(guide_table, guide_ids, None)
        ok = torch.from_numpy(np.array(spec_ok[:B], bool)).to(self.device)
        ar = torch.arange(K + 1, device=self.device, dtype=torch.int32)
        ids, lps, tops, cnts = [], [], [], []
        for _ in range(steps):
            draft = _draft(hist, pos, K)
            step_toks = torch.cat([toks[:, None], draft], dim=1)
            step_pos = pos[:, None] + ar[None]
            logits, _ = llama.forward(
                self.params, self.model_cfg, step_toks, step_pos,
                self.cache, block_tables=tables, rope=self.rope,
                kv_len=kv_len, token_valid=step_pos < S, lora_rows=lora,
                lora_scaling=self._lora_scaling)
            expected = torch.argmax(logits, dim=-1).to(torch.int32)
            tok0, lp0, top, gstate = _pick(
                logits[:, 0], sampling, self._generator, pos + 1,
                greedy=greedy, seeded=seeded, plain=plain, shaping=shaping,
                topk=topk, guide=guide)
            shaping = _add_counts(shaping, tok0)
            if guide is not None:
                guide = (guide[0], guide[1], gstate)
            expected[:, 0] = tok0
            lp = torch.log_softmax(logits, dim=-1).gather(
                2, expected.long()[..., None])[..., 0]
            lp[:, 0] = lp0
            agree = (draft == expected[:, :K]).to(torch.int32)
            accepted = torch.cumprod(agree, dim=1).sum(dim=1)
            count = torch.where(ok, accepted, torch.zeros_like(accepted)) + 1
            start = (pos.long() + 1).clamp(max=S - K - 1)
            hist = hist.scatter(1, start[:, None] + ar.long()[None],
                                expected)
            toks = expected.gather(1, (count - 1).long()[:, None])[:, 0]
            pos = pos + count.to(torch.int32)
            ids.append(expected)
            lps.append(lp)
            cnts.append(count.to(torch.int32))
            tops.append(top)
        self._dec_tokens, self._dec_pos, self._dec_hist = toks, pos, hist
        if shaping is not None:
            self._dec_counts = shaping[0]
        if guide is not None:
            self._dec_gstate = guide[2]
        return (torch.stack(ids, dim=1), torch.stack(lps, dim=1),
                torch.stack(cnts, dim=1),
                _stack_tops(tops) if topk else None)

    @torch.no_grad()
    def prefill(self, tokens: np.ndarray, starts: np.ndarray,
                lengths: np.ndarray, sampling: SamplingParams,
                kv_len: int, greedy: bool = False, seeded: bool = False,
                plain: bool = False, penalized: bool = False,
                topk: int = 0, guide_table: Optional[torch.Tensor] = None,
                guide_ids: Optional[np.ndarray] = None,
                guide_states: Optional[np.ndarray] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, Tops]:
        """Full-batch chunk prefill. tokens [B, Tb], starts/lengths [B]
        (host int32). Every row writes its chunk at its own offset
        through its table; idle rows (parked at start = max_model_len)
        and right padding write to the trash block. Returns device
        (id sampled after each row's last real token [B], its logprob
        [B], top-K [B, K] or None). penalized: the first sampled token
        takes the shaping, with the uploaded counts (the emitted output
        of a row resumed after preemption) and prompt membership.
        guide_table with guide_ids and guide_states [B]: a guided row's
        first token is masked from its DFA state (the state it reaches
        comes back with the tokens through the engine's host walk)."""
        S = self.engine_cfg.max_model_len
        toks = self._upload(tokens)
        st = self._upload(starts)
        ln = self._upload(lengths)
        Tb = toks.shape[1]
        ar = torch.arange(Tb, device=self.device, dtype=torch.int32)
        positions = st[:, None] + ar[None, :]
        token_valid = (ar[None, :] < ln[:, None]) & (st < S)[:, None]
        B = toks.shape[0]
        # keyed on the uploaded tensor, so before rows() slices it
        lora = self._lora_rows(sampling, B)
        sampling = sampling.rows(B)
        logits, _ = llama.forward(
            self.params, self.model_cfg, toks, positions, self.cache,
            block_tables=self._dev_tables(), rope=self.rope, kv_len=kv_len,
            token_valid=token_valid,
            last_index=torch.clamp(ln - 1, min=0),
            lora_rows=lora, lora_scaling=self._lora_scaling)
        ids, lp, tops, _ = _pick(
            logits[:, 0], sampling, self._generator,
            st + torch.clamp(ln, min=1), greedy=greedy, seeded=seeded,
            plain=plain, shaping=self._shaping(B) if penalized else None,
            topk=topk, guide=self._guide(guide_table, guide_ids,
                                         guide_states))
        return ids, lp, tops

    @torch.no_grad()
    def embed(self, tokens: np.ndarray, lengths: np.ndarray) -> torch.Tensor:
        """Mean-pooled final hidden states of right-padded prompts
        (JAX ``runner.embed``): tokens [N, Tb] host int32, lengths [N] ->
        f32 [N, H] on the device, the mean over each row's first
        lengths[b] positions of llama.encode's output. No cache is read
        or written, so this may run beside the engine loop."""
        toks = self._upload(tokens)
        lens = self._upload(lengths)
        mask = (torch.arange(toks.shape[1], device=self.device)[None]
                < lens[:, None])
        # the mask also keeps a MoE model's padding out of routing
        h = llama.encode(self.params, self.model_cfg, toks, rope=self.rope,
                         token_valid=mask)
        pooled = (h.float() * mask[..., None]).sum(dim=1)
        return pooled / lens.clamp(min=1)[:, None]

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

    # ----------------------------------------------------- KV tier chunks

    def _slot_block_offsets(self, slot: int, start: int, size: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(block ids [size], intra-block offsets [size]) of a slot's
        virtual positions start..start+size-1, through its table row,
        the block index clamped to MB - 1 (JAX
        ``_slot_block_offsets``)."""
        Bs = self.engine_cfg.kv_block_size
        MB = self.engine_cfg.max_blocks_per_seq
        pos = start + torch.arange(size, device=self.device)
        row = self._dev_tables()[slot]
        blk = row[torch.clamp(torch.div(pos, Bs, rounding_mode="floor"),
                              0, MB - 1)].long()
        return blk, torch.remainder(pos, Bs)

    @torch.no_grad()
    def extract_chunk(self, slot: int, start: int, size: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Gather k, v [L, size, Hkv, D] (C-contiguous) out of a slot's
        blocks into fresh device tensors, enqueued on the current
        stream: ordered after the forwards that wrote them and before
        any later step reuses the blocks. An int8 pool is dequantized
        in f32 (int8 x scale), THEN rounded to bf16, the wire dtype
        (JAX ``extract_chunk``)."""
        blk, off = self._slot_block_offsets(slot, start, size)
        c = self.cache
        # advanced indices on the block and offset axes come first:
        # [size, L, Hkv, D] -> the chunk layout [L, size, Hkv, D]
        k = c.k[:, blk, :, off, :].permute(1, 0, 2, 3)
        v = c.v[:, blk, :, off, :].permute(1, 0, 2, 3)
        if c.quantized:
            ks = c.ks[:, blk, :, off].permute(1, 0, 2)
            vs = c.vs[:, blk, :, off].permute(1, 0, 2)
            k = (k.float() * ks[..., None]).to(torch.bfloat16)
            v = (v.float() * vs[..., None]).to(torch.bfloat16)
        return k.contiguous(), v.contiguous()

    @torch.no_grad()
    def inject_chunk(self, slot: int, start: int, k_chunk: torch.Tensor,
                     v_chunk: torch.Tensor) -> None:
        """Scatter k, v [L, size, Hkv, D] (host or device tensors in the
        wire dtype) into a slot's blocks, in place. Host tensors are
        copied to the engine's device first (asynchronously from pinned
        memory). The slot's table must already cover start + size
        positions (admission allocates the whole prompt's blocks before
        injection). An int8 pool re-quantizes the chunk with
        models/kv.quantize_chunk, the recipe of serving writes (JAX
        ``inject_chunk``)."""
        size = k_chunk.shape[1]
        blk, off = self._slot_block_offsets(slot, start, size)
        c = self.cache
        k = k_chunk.to(self.device, non_blocking=True)
        v = v_chunk.to(self.device, non_blocking=True)
        if c.quantized:
            kq, ksc = quantize_chunk(k)
            vq, vsc = quantize_chunk(v)
            c.k[:, blk, :, off, :] = kq.permute(1, 0, 2, 3)
            c.v[:, blk, :, off, :] = vq.permute(1, 0, 2, 3)
            c.ks[:, blk, :, off] = ksc.permute(1, 0, 2)
            c.vs[:, blk, :, off] = vsc.permute(1, 0, 2)
            return
        c.k[:, blk, :, off, :] = k.permute(1, 0, 2, 3).to(c.k.dtype)
        c.v[:, blk, :, off, :] = v.permute(1, 0, 2, 3).to(c.v.dtype)

    def warmup(self) -> float:
        """One parked decode step and one parked prefill chunk: loads
        the kernels (building them if needed) and initialises the
        libraries the forward uses, so the first request pays none of
        it. On a MoE model the step takes the exact all-expert path and
        the chunk (B x the largest bucket tokens) the capacity dispatch,
        the two shapes serving runs. Returns seconds spent."""
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
