"""LLMEngine: the synchronous continuous-batching core
(``production_stack_tpu/engine/engine.py``, the main path only).

One ``step()`` = at most one prefill chunk per admissible sequence (one
full-batch forward per chunk bucket) and one decode window over all
running slots, interleaved 1:1 so running sequences keep their token
cadence while a long prompt prefills chunk by chunk. Host bookkeeping —
admission, KV block accounting, stop detection, detokenization — is the
JAX engine's, unchanged.

One decode window is kept in flight between steps: it is dispatched at
the end of a step and read at the next, so the card computes while the
host hands tokens to the server. Rows whose sequence finished or was
aborted in between are discarded when the window is read. The JAX
engine's adaptive window sizing and deeper pipelining are not ported:
EngineConfig pins ``window_adapt`` off and ``pipeline_depth`` at 1.
Sampling options the port does not implement (guided decoding,
penalties, logit bias, min_tokens, top logprobs) and LoRA model ids are
refused at ``add_request``.
"""

import dataclasses
import itertools
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine.block_manager import (
    BlockManager, model_fingerprint)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.runner import ModelRunner
from production_stack_tpu_torch.engine.sampler import SamplingParams
from production_stack_tpu_torch.engine.scheduler import (SamplingOptions,
                                                         Scheduler,
                                                         SeqStatus,
                                                         Sequence)
from production_stack_tpu_torch.engine.tokenizer import (DetokenizeStream,
                                                         load_tokenizer)
from production_stack_tpu_torch.models.config import get_config
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

# finished sequences kept for post-hoc inspection (bounded; see _remember)
_FINISHED_RETENTION = 1024

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass
class StepOutput:
    seq_id: str
    new_token: Optional[int]
    text_delta: str
    finished: bool
    finish_reason: Optional[str]
    # chosen token's log p under the raw model distribution
    logprob: Optional[float] = None


def unsupported_options(options: SamplingOptions) -> List[str]:
    """Names of the request options set away from their inert defaults
    that the port does not implement yet."""
    bad = []
    if options.guided_regex:
        bad.append("guided decoding")
    for name, inert in (("presence_penalty", 0.0),
                        ("frequency_penalty", 0.0),
                        ("repetition_penalty", 1.0), ("min_tokens", 0)):
        if getattr(options, name) != inert:
            bad.append(name)
    if options.logit_bias:
        bad.append("logit_bias")
    if options.top_logprobs:
        bad.append("top_logprobs")
    return bad


class LLMEngine:
    def __init__(self, engine_cfg: EngineConfig, params=None):
        self.cfg = engine_cfg
        self.model_cfg = dataclasses.replace(
            get_config(engine_cfg.model), dtype=_DTYPES[engine_cfg.dtype])
        self.tokenizer = load_tokenizer(engine_cfg.model,
                                        engine_cfg.tokenizer,
                                        engine_cfg.chat_template)
        self.served_models = [engine_cfg.model]
        self.runner = ModelRunner(self.model_cfg, engine_cfg, params=params)
        self.scheduler = Scheduler(engine_cfg.max_num_seqs,
                                   engine_cfg.max_model_len,
                                   engine_cfg.prefill_chunk)
        self.block_mgr = BlockManager(
            self.runner.cache.num_blocks, engine_cfg.kv_block_size,
            enable_prefix_caching=engine_cfg.enable_prefix_caching,
            namespace=model_fingerprint(self.model_cfg,
                                        engine_cfg.kv_dtype))
        self._tables = np.zeros((engine_cfg.max_num_seqs,
                                 engine_cfg.max_blocks_per_seq), np.int32)
        self.scheduler.can_admit = self._try_admit
        self.scheduler.on_admit = self._set_slot_table
        self.seqs: Dict[str, Sequence] = {}
        self._finished_order: List[str] = []
        self._id_counter = itertools.count()
        # guards scheduler state across the engine-loop and server threads
        self._lock = threading.RLock()
        # per-slot host mirrors feeding the decode batch; free and
        # prefilling slots sit parked at position max_model_len
        B = engine_cfg.max_num_seqs
        self._slot_token = np.zeros((B,), np.int32)
        self._slot_pos = np.full((B,), engine_cfg.max_model_len, np.int32)
        self._slot_temp = np.full((B,), 1.0, np.float32)
        self._slot_top_p = np.ones((B,), np.float32)
        self._slot_top_k = np.zeros((B,), np.int32)
        self._slot_seed = np.zeros((B,), np.int64)
        self._slot_min_p = np.zeros((B,), np.float32)
        # device sampling params, re-uploaded only when a slot's options
        # change (admission/finish), never per window
        self._dev_sampling: Optional[SamplingParams] = None
        self._sampling_dirty = True
        # the decode carry is re-uploaded from the host mirrors only
        # after a slot-composition change (admission, finish, abort)
        self._decode_dirty = True
        # the decode window in flight between steps:
        # (ids_dev, lps_dev, W, [seqs at dispatch]) or None
        self._inflight: Optional[tuple] = None

    # ------------------------------------------------------------------

    def resolve_model(self, model: Optional[str]) -> None:
        """Check a served model name: the port serves the base model
        only (LoRA adapters come later)."""
        if model is None or model == self.cfg.model:
            return
        raise ValueError(f"model {model!r} is not served: the PyTorch port "
                         f"serves {self.cfg.model!r} only (LoRA adapter "
                         f"ids are not implemented yet)")

    def add_request(self, prompt_tokens: List[int],
                    options: Optional[SamplingOptions] = None,
                    seq_id: Optional[str] = None,
                    model: Optional[str] = None) -> str:
        seq_id = seq_id or f"seq-{next(self._id_counter)}"
        options = options or SamplingOptions()
        bad = unsupported_options(options)
        if bad:
            raise ValueError(f"not implemented in the PyTorch port yet: "
                             f"{', '.join(bad)}")
        if not 0.0 <= options.min_p <= 1.0:
            raise ValueError(f"min_p must be in [0, 1] "
                             f"(got {options.min_p})")
        self.resolve_model(model)
        seq = Sequence(seq_id=seq_id, prompt_tokens=list(prompt_tokens),
                       options=options,
                       detok=DetokenizeStream(self.tokenizer))
        with self._lock:
            self.scheduler.add(seq)
            self.seqs[seq_id] = seq
        return seq_id

    def abort(self, seq_id: str) -> bool:
        with self._lock:
            seq = self.seqs.get(seq_id)
            slot = seq.slot if seq is not None else -1
            ok = self.scheduler.abort(seq_id)
            if ok:
                self._park_slot(slot)
                if seq is not None:
                    self._free_seq_blocks(seq)
                    self._remember(seq)
            return ok

    # ------------------------------------------------------------------

    def step(self) -> List[StepOutput]:
        """One engine iteration: this step's prefill chunks, then the
        decode window in flight is read and the next one dispatched."""
        with self._lock:
            outputs: List[StepOutput] = []
            works, decode_seqs = self.scheduler.schedule()
            if works:
                # the window in flight was dispatched before this
                # prefill: read it first, its tokens come first
                outputs.extend(self._process_window())
                outputs.extend(self._do_prefill(works))
                # sequences whose prefill just completed are RUNNING
                # now and join this step's decode window
                decode_seqs = list(self.scheduler.running.values())
            if decode_seqs or self._inflight is not None:
                if self._inflight is None:
                    self._dispatch_decode(decode_seqs)
                outputs.extend(self._process_window())
                decode_seqs = list(self.scheduler.running.values())
                if decode_seqs:
                    self._dispatch_decode(decode_seqs)
            return outputs

    def _do_prefill(self, works) -> List[StepOutput]:
        """Batch-prefill every scheduled chunk: one forward per
        chunk-length bucket (usually one), all slots at once."""
        outputs: List[StepOutput] = []
        for w in works:
            self._sync_sampling(w.seq)
        self._ensure_dev_sampling()
        by_bucket: Dict[int, list] = {}
        for w in works:
            by_bucket.setdefault(self.cfg.bucket_for(len(w.chunk)),
                                 []).append(w)
        B, S = self.cfg.max_num_seqs, self.cfg.max_model_len
        for bucket, group in sorted(by_bucket.items()):
            tokens = np.zeros((B, bucket), np.int32)
            starts = np.full((B,), S, np.int32)   # parked rows
            lengths = np.ones((B,), np.int32)
            kv_need = bucket
            for w in group:
                slot = w.seq.slot
                tokens[slot, :len(w.chunk)] = w.chunk
                starts[slot] = w.start
                lengths[slot] = len(w.chunk)
                kv_need = max(kv_need, w.start + bucket)
            opts = [w.seq.options for w in group]
            ids_dev, lps_dev = self.runner.prefill(
                tokens, starts, lengths, self._dev_sampling,
                self.cfg.kv_bucket_for(min(kv_need, S)),
                **self._sampling_mode(opts))
            ids = lps = None
            for w in group:
                self.scheduler.on_prefill_done(w)
                seq = w.seq
                if self.cfg.enable_prefix_caching:
                    # a full block is final once its last position is
                    # written: register it for concurrent sharers now
                    seq.reg_state = self.block_mgr.register_incremental(
                        seq.prefill_tokens[:seq.num_prefilled],
                        seq.block_ids, seq.reg_state)
                if not w.is_last:
                    continue
                if seq.output_tokens:
                    # preemption-recompute resume: the emitted output
                    # was teacher-forced back in; the last emitted token
                    # is the next decode input again
                    self._sync_slot(seq)
                    continue
                if ids is None:
                    ids = ids_dev.cpu().numpy()   # one sync per bucket
                    lps = lps_dev.cpu().numpy()
                outputs.extend(self._accept_token(
                    seq, int(ids[seq.slot]), float(lps[seq.slot])))
        self._decode_dirty = True
        return outputs

    @staticmethod
    def _sampling_mode(options) -> dict:
        """Which sampling variant a batch needs: argmax only when every
        row is greedy, the seeded noise only when some row is seeded,
        the sort only when some row truncates (top_p/top_k/min_p)."""
        return dict(
            greedy=all(o.temperature <= 0.0 for o in options),
            seeded=any(o.seed is not None for o in options),
            plain=all(o.top_p >= 1.0 and not o.top_k and not o.min_p
                      for o in options))

    def _ensure_dev_sampling(self) -> None:
        if self._sampling_dirty:
            dev = self.runner.device
            self._dev_sampling = SamplingParams(
                temperature=torch.from_numpy(self._slot_temp.copy()).to(dev),
                top_p=torch.from_numpy(self._slot_top_p.copy()).to(dev),
                top_k=torch.from_numpy(self._slot_top_k.copy()).to(dev),
                seed=torch.from_numpy(self._slot_seed.copy()).to(dev),
                min_p=torch.from_numpy(self._slot_min_p.copy()).to(dev))
            self._sampling_dirty = False

    def _dispatch_decode(self, decode_seqs) -> bool:
        """Launch one decode window (no host sync). Every live slot's
        block table must span the whole window first: under pool
        pressure the youngest sequences are preempted (recomputed
        later)."""
        W = self.cfg.decode_window
        for s in list(decode_seqs):
            if s.status is not SeqStatus.RUNNING:
                continue   # already preempted as a victim this pass
            if not self._ensure_blocks(s, s.next_position + W + 1):
                self._preempt(s)
        decode_seqs = list(self.scheduler.running.values())
        if not decode_seqs:
            return False
        max_pos = max(s.next_position for s in decode_seqs)
        kv_len = self.cfg.kv_bucket_for(
            min(max_pos + W + 1, self.cfg.max_model_len))
        self._ensure_dev_sampling()
        if self._decode_dirty:
            self.runner.set_decode_state(self._slot_token, self._slot_pos)
            self._decode_dirty = False
        ids_dev, lps_dev = self.runner.decode(
            self._dev_sampling, steps=W, kv_len=kv_len,
            **self._sampling_mode([s.options for s in decode_seqs]))
        self._inflight = (ids_dev, lps_dev, W, list(decode_seqs))
        return True

    def _process_window(self) -> List[StepOutput]:
        """Read the window in flight (its one host sync) and walk its
        steps: each live row takes its tokens until it stops."""
        if self._inflight is None:
            return []
        ids_dev, lps_dev, W, seqs = self._inflight
        self._inflight = None
        ids = ids_dev.cpu().numpy()
        lps = lps_dev.cpu().numpy()
        outputs: List[StepOutput] = []
        alive = [s for s in seqs if s.status is not SeqStatus.FINISHED]
        for j in range(W):
            still = []
            for seq in alive:
                outs = self._accept_token(seq, int(ids[seq.slot, j]),
                                          float(lps[seq.slot, j]))
                outputs.extend(outs)
                if not outs[-1].finished:
                    still.append(seq)
            alive = still
            if not alive:
                break
        return outputs

    def _accept_token(self, seq: Sequence, token: int,
                      logprob: Optional[float] = None) -> List[StepOutput]:
        seq.output_tokens.append(token)
        seq.output_logprobs.append(logprob)
        delta = seq.detok.push(token)
        opt = seq.options
        if (token in opt.stop_token_ids
                or (not opt.ignore_eos
                    and token == self.tokenizer.eos_token_id)):
            # a token that stops the sequence is excluded from the text
            delta = ""
        seq.output_text += delta
        reason = self._stop_reason(seq, token, delta)
        if reason is not None and reason != "stop":
            seq.output_text += seq.detok.flush()
        text_delta = seq.output_text[seq.chars_emitted:]
        seq.chars_emitted = len(seq.output_text)
        if reason is None:
            self._sync_slot(seq)
            return [StepOutput(seq.seq_id, token, text_delta, False, None,
                               logprob)]
        # prefix caching: full blocks stay in the pool under their chain
        # keys; register BEFORE free so they land in the evictable LRU
        self.block_mgr.register(
            (seq.prompt_tokens + seq.output_tokens)[:-1], seq.block_ids)
        self._free_seq_blocks(seq)
        slot = seq.slot
        self.scheduler.finish(seq, reason)
        self._park_slot(slot)
        self._remember(seq)
        return [StepOutput(seq.seq_id, token, text_delta, True, reason,
                           logprob)]

    def _stop_reason(self, seq: Sequence, token: int,
                     delta: str) -> Optional[str]:
        """Stop decision; on a stop-string match, truncates
        seq.output_text so the stop string itself is never delivered."""
        opt = seq.options
        if token in opt.stop_token_ids:
            return "stop"
        if not opt.ignore_eos and token == self.tokenizer.eos_token_id:
            return "stop"
        if opt.stop and delta:
            # a match can straddle the delta boundary
            for s in opt.stop:
                from_idx = max(0, len(seq.output_text) - len(delta)
                               - len(s))
                idx = seq.output_text.find(s, from_idx)
                if idx != -1:
                    seq.output_text = seq.output_text[:idx]
                    return "stop"
        if len(seq.output_tokens) >= opt.max_tokens:
            return "length"
        if seq.num_tokens >= self.cfg.max_model_len:
            return "length"
        return None

    def _remember(self, seq: Sequence) -> None:
        """Retain finished sequences for inspection, bounded in count."""
        self._finished_order.append(seq.seq_id)
        while len(self._finished_order) > _FINISHED_RETENTION:
            self.seqs.pop(self._finished_order.pop(0), None)

    def _sync_slot(self, seq: Sequence) -> None:
        """Mirror the sequence's next decode input into the slot arrays."""
        self._slot_token[seq.slot] = seq.output_tokens[-1]
        self._slot_pos[seq.slot] = seq.next_position
        self._sync_sampling(seq)

    def _sync_sampling(self, seq: Sequence) -> None:
        slot, opt = seq.slot, seq.options
        # user seeds (0 and negatives included) map to a positive id;
        # 0 marks an unseeded row
        seed = 0 if opt.seed is None else (opt.seed % 0x7FFFFFFE) + 1
        row = (opt.temperature, opt.top_p, opt.top_k, seed, opt.min_p)
        mirrors = (self._slot_temp, self._slot_top_p, self._slot_top_k,
                   self._slot_seed, self._slot_min_p)
        if any(m[slot] != v for m, v in zip(mirrors, row)):
            for m, v in zip(mirrors, row):
                m[slot] = v
            self._sampling_dirty = True

    def _park_slot(self, slot: int) -> None:
        """Return a freed slot's mirrors to the idle state (position
        max_model_len: its writes go to the trash block)."""
        if slot >= 0:
            self._slot_token[slot] = 0
            self._slot_pos[slot] = self.cfg.max_model_len
            self._decode_dirty = True

    # ---------------------------------------------------- paged-KV host

    def _try_admit(self, seq: Sequence) -> bool:
        """Scheduler admission gate: claim KV blocks for the whole
        prompt (+1 position for the first sampled token); registered
        prefix blocks are attached by reference. False defers
        admission when the pool cannot cover the rest."""
        toks = seq.prefill_tokens
        # hash the prompt once per length: a deferred admission retries
        # every scheduler pass
        if seq.prefix_state is None or seq.prefix_state[0] != len(toks):
            seq.prefix_state = (len(toks), self.block_mgr.prefix_keys(toks))
        shared, covered = self.block_mgr.match_keys(seq.prefix_state[1])
        need = self.block_mgr.blocks_for(len(toks) + 1) - len(shared)
        fresh = self.block_mgr.alloc(max(need, 0))
        if fresh is None:
            self.block_mgr.free(shared)   # unpin; retry next pass
            return False
        seq.block_ids = shared + fresh
        seq.num_prefilled = covered
        return True

    def _set_slot_table(self, seq: Sequence) -> None:
        """Scheduler hook (slot assigned): point the slot's table row at
        the sequence's blocks."""
        self._set_table_row(seq.slot, seq.block_ids)

    def _set_table_row(self, slot: int, block_ids) -> None:
        self._tables[slot, :] = 0
        if block_ids:
            self._tables[slot, :len(block_ids)] = block_ids
        self.runner.set_block_tables(self._tables)

    def _free_seq_blocks(self, seq: Sequence) -> None:
        self.block_mgr.free(seq.block_ids)
        seq.block_ids = []

    def _ensure_blocks(self, seq: Sequence, upto_tokens: int) -> bool:
        """Grow a live sequence's blocks to cover positions
        < min(upto_tokens, max_model_len), preempting younger sequences
        under pool pressure. False = could not cover even then (the
        caller preempts `seq` itself)."""
        need = self.block_mgr.blocks_for(
            min(upto_tokens, self.cfg.max_model_len))
        while len(seq.block_ids) < need:
            fresh = self.block_mgr.alloc(need - len(seq.block_ids))
            if fresh is not None:
                seq.block_ids.extend(fresh)
                self._set_table_row(seq.slot, seq.block_ids)
                return True
            if not self._preempt_youngest(requester=seq):
                return False
        return True

    def _preempt_youngest(self, requester: Sequence) -> bool:
        """Preempt the most recently arrived live sequence; False when
        the requester itself is the youngest (the caller preempts it)."""
        candidates = list(self.scheduler.running.values()) \
            + list(self.scheduler._prefilling.values())
        if requester not in candidates:
            candidates.append(requester)
        victim = max(candidates, key=lambda s: s.arrival_time)
        if victim is requester or len(candidates) == 1:
            return False
        self._preempt(victim)
        return True

    def _preempt(self, seq: Sequence) -> None:
        logger.warning("preempting %s (KV pool pressure): %d blocks "
                       "freed, %d tokens will recompute", seq.seq_id,
                       len(seq.block_ids), seq.num_tokens)
        slot = seq.slot
        self._free_seq_blocks(seq)
        seq.reg_state = None    # re-register the recomputed blocks
        self.scheduler.preempt(seq)
        self._park_slot(slot)
        self._set_table_row(slot, [])

    # ------------------------------------------------------------------

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work
