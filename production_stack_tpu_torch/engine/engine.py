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

The load surface is the JAX engine's: bounded admission
(``max_waiting_seqs`` -> ``AdmissionRejected``), deadlines and the
queue-delay shed of waiting sequences (``scheduler.expire_waiting``), a
lock-free ``load_report`` (``/load`` and the ``x-engine-*`` headers)
and the metrics of engine/metrics.py, fed by plain-int accounting
(engine/efficiency.py). Logit shaping (penalties, logit bias,
min_tokens), top-K logprobs and guided decoding run on the device
(runner.py).

Multi-LoRA (JAX ``engine.py:102-127,329-415``): every adapter is served
as its own model id (``served_models``: the base first, then the
adapters). Adapter ids are append-only — id = stack row — so an evicted
adapter's row is tombstoned, not freed: in-flight sequences finish on
it while its name answers ``unknown model``. A runtime load restacks
and swaps the runner's stack before the id is published. Each slot's
adapter id rides the sampling upload (``_slot_adapter``), and prefix
keys are salted with the adapter's name (``_adapter_salt``), so an
adapter request never attaches a base block. ``checkpoint`` loads an
HF checkpoint directory (models/hf_loader.py) in place of random
weights; int8 quantization then applies to the loaded weights.

Guided decoding (engine/guided.py): a guided request's pattern is
compiled at ``add_request`` (LRU-cached; the server compiles it first
in an executor), the engine stacks the active patterns' tables into one
[G, S, V] device table rebuilt only when that set changes, and each
slot's DFA state rides the device carry with a host mirror
(``_slot_gstate``) advanced in ``_accept_token``.

n-gram speculation (``speculative_ngram_tokens`` K > 0): a window with a
row that may speculate (greedy, unguided, unshaped, no alternatives)
runs ``runner.decode_spec``, whose macro-steps emit 1..K+1 tokens per
such row and one per other row. Block coverage and the kv bucket take
the worst case, W * (K + 1) + 1 positions past each row; the token
history [B, max_model_len] is uploaded with the decode carry, at
composition changes only; ``_process_window`` walks the macro-steps, dropping the rest
of one where its row stops, and counts rejected draft positions as dead
token-steps.

Rolling KV (JAX ``engine.py:228-239,1905-1927``): on a model whose
every layer is windowed (Mistral v0.1), no query attends a position
behind the window again, so before each decode dispatch
``_roll_windows`` frees the blocks wholly behind every running
sequence's window (their table entries point at trash block 0, which
the kernels never read there), and the freed blocks feed the same
window's growth: live KV is bounded by the window, not by the length. A
rolled sequence registers no prefix chain (its early blocks are gone);
preemption recomputes it from position 0.

``embed_tokens`` serves the pooling routes (/v1/embeddings, rerank,
score) with the serving model's mean-pooled final hidden states
(``runner.embed``, no cache), beside the engine loop.

KV tiering and disaggregated prefill (JAX ``engine.py:213-239,477-484,
980-984,1455-1458,1867-1887``): with ``kv_transfer_config`` the engine
owns a ``kvcache.connector.KVConnector``. ``add_request`` prefetches the
prompt's cached chunk-prefix from the tiers on the caller's thread; at
slot assignment (``_on_admit``) the chunks are injected into the slot's
blocks when the tiers cover more than the HBM prefix cache does, and
prefill starts at the cached length. A producer publishes each full
prompt chunk as soon as it is prefilled and a finished sequence's
chunks before its slot is released. Rolling KV is off under a connector
(publishing reads from position 0). The kvplane's calls:
``migrate_out`` publishes and preempts the least recently active
sequences, ``warm_chunks`` pulls keys into this replica's fastest tier,
and ``_maybe_defrag`` compacts the free block list after fragmented
allocation failures. Chunk keys carry the adapter salt.
"""

import dataclasses
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine import guided
from production_stack_tpu_torch.engine.block_manager import BlockManager
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.efficiency import EngineEffAccounting
from production_stack_tpu_torch.engine.metrics import EngineMetrics
from production_stack_tpu_torch.engine.runner import ModelRunner
from production_stack_tpu_torch.engine.sampler import (LOGIT_BIAS_K,
                                                       MIN_TOKENS_STOP_K,
                                                       SamplingParams)
from production_stack_tpu_torch.engine.scheduler import (SamplingOptions,
                                                         Scheduler,
                                                         SeqStatus,
                                                         Sequence)
from production_stack_tpu_torch.engine.tokenizer import (DetokenizeStream,
                                                         load_tokenizer)
from production_stack_tpu_torch.kvcache.chunks import model_fingerprint
from production_stack_tpu_torch.kvcache.connector import (KVConnector,
                                                          KVTransferConfig)
from production_stack_tpu_torch.models import lora as lora_mod
from production_stack_tpu_torch.models.config import get_config
from production_stack_tpu_torch.models.hf_loader import load_checkpoint
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
    # chosen token's log p (shaped distribution for shaped rows, the raw
    # model's otherwise)
    logprob: Optional[float] = None
    # top_logprobs alternatives [(token_id, logprob)] when requested
    top_alts: Optional[list] = None


class AdmissionRejected(Exception):
    """Bounded admission (cfg.max_waiting_seqs): the waiting queue is
    full, so the request is shed at submit time. The server answers 503
    + Retry-After."""

    def __init__(self, queue_depth: int, retry_after_s: float):
        self.queue_depth = queue_depth
        self.retry_after_s = retry_after_s
        super().__init__(
            f"engine overloaded: {queue_depth} sequences already "
            f"waiting (max_waiting_seqs reached); retry in "
            f"~{retry_after_s:.1f}s")


class DeadlineExceeded(Exception):
    """The request's deadline (x-request-deadline-ms) expired while it
    still waited; the server answers 504 with x-deadline-expired."""


class LLMEngine:
    def __init__(self, engine_cfg: EngineConfig, params=None):
        self.cfg = engine_cfg
        self.model_cfg = dataclasses.replace(
            get_config(engine_cfg.model), dtype=_DTYPES[engine_cfg.dtype])
        if engine_cfg.moe_capacity_factor is not None:
            # the engine's override of the family's MoE capacity factor
            self.model_cfg = dataclasses.replace(
                self.model_cfg,
                moe_capacity_factor=engine_cfg.moe_capacity_factor)
        self.tokenizer = load_tokenizer(engine_cfg.model,
                                        engine_cfg.tokenizer,
                                        engine_cfg.chat_template)
        if params is None and engine_cfg.checkpoint:
            t0 = time.time()
            params = load_checkpoint(self.model_cfg, engine_cfg.checkpoint,
                                     device=engine_cfg.torch_device)
            logger.info("loaded %s from %s (%.2fs)", self.model_cfg.name,
                        engine_cfg.checkpoint, time.time() - t0)
        # multi-LoRA: adapter name -> id (= its row in the stack; 0 is
        # the base model). Rows are append-only and share the rank,
        # alpha and targets pinned at the first use
        self.lora_ids: Dict[str, int] = {}
        self._lora_cfg: Optional[lora_mod.LoRAConfig] = None
        self._lora_rows: List[lora_mod.Adapter] = []
        self.adapter_loads = 0
        self.adapter_evictions = 0
        lora_stacked, lora_scaling = None, 1.0
        if engine_cfg.lora_adapters:
            lcfg = self._ensure_lora_cfg()
            for name, src in sorted(engine_cfg.lora_adapters.items()):
                self._lora_rows.append(self._build_adapter(name, src))
                self.lora_ids[name] = len(self._lora_rows)
            lora_stacked = lora_mod.stack_adapters(
                self.model_cfg, lcfg, self._lora_rows,
                device=engine_cfg.torch_device)
            lora_scaling = lcfg.scaling
        self.served_models = [engine_cfg.model] + list(self.lora_ids)
        self.runner = ModelRunner(self.model_cfg, engine_cfg, params=params,
                                  lora_stacked=lora_stacked,
                                  lora_scaling=lora_scaling)
        self.runner.eos_id = int(self.tokenizer.eos_token_id or 0)
        self.metrics = EngineMetrics(engine_cfg.model)
        self.metrics.adapters_loaded.set(len(self.lora_ids))
        # KV tiering (kvcache/connector.py). A config without a tier
        # raises the connector's ValueError rather than serving without
        # the tiers it asked for
        self.connector: Optional[KVConnector] = None
        if engine_cfg.kv_transfer_config:
            self.connector = KVConnector(
                self.runner, self.model_cfg, engine_cfg,
                KVTransferConfig.from_dict(engine_cfg.kv_transfer_config))
            # kv_prefetch / kv_publish land beside the request phases
            self.connector.phase_recorder = self.metrics.engine_phases
        # the byte model of the efficiency gauges: the whole parameter
        # set, and what one cache position costs one attention read
        # (K and V over layers and kv-heads, plus the int8 pool's f32
        # scales)
        mc = self.model_cfg
        kv_itemsize = {"bfloat16": 2, "float32": 4,
                       "int8": 1}[engine_cfg.kv_dtype]
        kv_pos_bytes = (2 * mc.num_layers * mc.num_kv_heads
                        * mc.head_dim_ * kv_itemsize)
        if engine_cfg.kv_dtype == "int8":
            kv_pos_bytes += 2 * mc.num_layers * mc.num_kv_heads * 4
        params_ = self.runner.params
        self.eff = EngineEffAccounting(
            weight_bytes=sum(t.nbytes for t in (*params_.parameters(),
                                                *params_.buffers())),
            kv_position_bytes=kv_pos_bytes,
            hbm_peak_bytes_per_s=engine_cfg.hbm_peak_gbps * 1e9)
        # advertised once: the router's per-endpoint concurrency cap
        # reads it (0 = unbounded admission)
        self.metrics.capacity.set(
            engine_cfg.max_num_seqs + engine_cfg.max_waiting_seqs
            if engine_cfg.max_waiting_seqs is not None else 0)
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
        self.block_mgr.on_alloc_occupancy = \
            self.metrics.kvpool_occ_hist.observe
        self.scheduler.can_admit = self._try_admit
        self.scheduler.on_admit = self._on_admit
        # rolling KV: a window on every layer (not Gemma-2's alternating
        # one, whose global layers read the whole prefix), and no KV
        # tiers (publishing reads a sequence's blocks from position 0)
        self._roll_window = (mc.sliding_window if mc.sliding_window
                             and not mc.alternating_sliding
                             and self.connector is None else None)
        # fragmented allocation failures already answered by a defrag
        self._defrag_seen_failures = 0
        self.seqs: Dict[str, Sequence] = {}
        self._finished_order: List[str] = []
        self._id_counter = itertools.count()
        # EWMA of finished-request wall time (arrival -> finish), the
        # pace of the queue-delay estimate; seeded before any request
        # has finished
        self._service_ewma = 0.5
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
        self._slot_adapter = np.zeros((B,), np.int32)
        self._slot_seed = np.zeros((B,), np.int64)
        self._slot_min_p = np.zeros((B,), np.float32)
        # logit-shaping mirrors (sampler.adjust_logits), inert by default
        self._slot_presence = np.zeros((B,), np.float32)
        self._slot_frequency = np.zeros((B,), np.float32)
        self._slot_repetition = np.ones((B,), np.float32)
        self._slot_min_tokens = np.zeros((B,), np.int32)
        self._slot_prompt_len = np.zeros((B,), np.int32)
        self._slot_bias_ids = np.full((B, LOGIT_BIAS_K), -1, np.int32)
        self._slot_bias_vals = np.zeros((B, LOGIT_BIAS_K), np.float32)
        self._slot_stop_ids = np.full((B, MIN_TOKENS_STOP_K), -1, np.int32)
        # guided decoding: each slot's DFA state (the device carries it
        # within windows), and the stacked table of the active patterns
        self._slot_gstate = np.zeros((B,), np.int32)
        self._guided_key: Optional[tuple] = None   # the active patterns
        self._guided_table: Optional[torch.Tensor] = None  # [G, S, V]
        self._guided_gids: Dict[str, int] = {}    # pattern -> table row
        # device sampling params, re-uploaded only when a slot's options
        # change (admission/finish), never per window
        self._dev_sampling: Optional[SamplingParams] = None
        self._sampling_dirty = True
        # the decode carry is re-uploaded from the host mirrors only
        # after a slot-composition change (admission, finish, abort)
        self._decode_dirty = True
        # the decode window in flight between steps: (ids_dev, lps_dev,
        # counts_dev or None, tops_dev, W, [seqs at dispatch], dispatch
        # time, spec_ok or None, kv_len) or None
        self._inflight: Optional[tuple] = None
        self._last_sync_t = 0.0

    # ------------------------------------------------------------------

    def _adapter_salt(self, adapter_id: int) -> str:
        """Prefix-key salt: the adapter's NAME (stable across processes
        and config orderings, unlike the id), so adapter-colored KV
        blocks never collide with the base model's or each other's."""
        if adapter_id == 0:
            return ""
        for name, aid in self.lora_ids.items():
            if aid == adapter_id:
                return f"lora:{name}"
        return f"lora-id:{adapter_id}"

    def resolve_model(self, model: Optional[str]) -> int:
        """Served model name -> adapter id (0 = base). Raises on unknown."""
        if model is None or model == self.cfg.model:
            return 0
        if model in self.lora_ids:
            return self.lora_ids[model]
        raise ValueError(f"unknown model {model!r}; serving "
                         f"{self.served_models}")

    # ------------------------------------------------- runtime adapters

    def _ensure_lora_cfg(self) -> lora_mod.LoRAConfig:
        if self._lora_cfg is None:
            self._lora_cfg = lora_mod.LoRAConfig(
                rank=self.cfg.lora_rank, alpha=self.cfg.lora_alpha,
                targets=tuple(self.cfg.lora_targets))
        return self._lora_cfg

    def _build_adapter(self, name: str, src: str) -> lora_mod.Adapter:
        """One adapter's factors on the engine's device: "random:SEED"
        draws from a torch.Generator seeded SEED (other values than the
        JAX package's threefry draws), anything else is an .npz path."""
        lcfg = self._ensure_lora_cfg()
        dev = self.cfg.torch_device
        if src.startswith("random:"):
            gen = torch.Generator(device=dev).manual_seed(
                int(src.split(":", 1)[1]))
            return lora_mod.random_adapter(self.model_cfg, lcfg, gen,
                                           device=dev)
        return lora_mod.load_adapter_npz(self.model_cfg, lcfg, src,
                                         device=dev)

    def load_adapter(self, name: str, src: str) -> bool:
        """Load a LoRA adapter at runtime and serve it as model ``name``.
        False when the name is already served (idempotent); any failure
        raises (the server answers 503 + Retry-After: a shed, the engine
        serves on)."""
        with self._lock:
            if name == self.cfg.model or name in self.lora_ids:
                return False
            new_row = self._build_adapter(name, src)
            lcfg = self._ensure_lora_cfg()
            rows = self._lora_rows + [new_row]
            # restack and swap before the id is published: a request on
            # the new name never selects a row the runner lacks
            self.runner.set_lora(
                lora_mod.stack_adapters(self.model_cfg, lcfg, rows,
                                        device=self.cfg.torch_device),
                lcfg.scaling)
            self._lora_rows = rows
            self.lora_ids[name] = len(rows)
            self.served_models.append(name)
            self.adapter_loads += 1
            self.metrics.adapter_loads.inc()
            self.metrics.adapters_loaded.set(len(self.lora_ids))
            logger.info("adapter %s loaded from %s (id=%d, %d rows "
                        "stacked)", name, src, len(rows), len(rows))
            return True

    def evict_adapter(self, name: str) -> None:
        """Stop serving adapter ``name``; KeyError when it is not served
        (the server answers 404). Its row is tombstoned: in-flight
        sequences keep their id and finish, new requests for the name
        answer unknown model."""
        with self._lock:
            if name not in self.lora_ids:
                raise KeyError(f"adapter {name!r} is not loaded; "
                               f"serving {self.served_models}")
            del self.lora_ids[name]
            self.served_models.remove(name)
            self.adapter_evictions += 1
            self.metrics.adapter_evictions.inc()
            self.metrics.adapters_loaded.set(len(self.lora_ids))
            logger.info("adapter %s evicted (row tombstoned)", name)

    def add_request(self, prompt_tokens: List[int],
                    options: Optional[SamplingOptions] = None,
                    seq_id: Optional[str] = None,
                    model: Optional[str] = None,
                    deadline: Optional[float] = None) -> str:
        """Queue a request. deadline: absolute time.monotonic() after
        which a still-waiting sequence is dropped (finish_reason
        "deadline"). Raises ValueError for an option out of range and
        AdmissionRejected when the waiting queue is full."""
        seq_id = seq_id or f"seq-{next(self._id_counter)}"
        options = options or SamplingOptions()
        self.check_options(options)
        seq = Sequence(seq_id=seq_id, prompt_tokens=list(prompt_tokens),
                       options=options,
                       adapter_id=self.resolve_model(model),
                       deadline=deadline,
                       detok=DetokenizeStream(self.tokenizer))
        if options.guided_regex:
            # compiled per (pattern, tokenizer) with an LRU cache; a bad
            # pattern raises here, on the caller's thread, as ValueError
            seq.grammar = guided.compile_grammar(options.guided_regex,
                                                 self.tokenizer)
        if self.connector is not None:
            # the tier walk and the host copies run here, on the
            # caller's thread, never on the engine loop
            seq.kv_prefetch = self.connector.prefetch(
                seq.prompt_tokens, salt=self._adapter_salt(seq.adapter_id))
            if seq.kv_prefetch is not None:
                seq.kv_prefetch_wait_s = seq.kv_prefetch.wait_s
                seq.kv_cached_tokens = seq.kv_prefetch.cached_tokens
        with self._lock:
            # bounded admission: a fresh submit always lands in waiting
            # first, so the bound is on waiting beyond what the free
            # slots absorb on the next pass; preempted sequences (which
            # hold a client stream already) reclaim slots first and do
            # not count against new arrivals
            if self.cfg.max_waiting_seqs is not None:
                depth = sum(1 for s in self.scheduler.waiting
                            if not s.output_tokens)
                preempted = len(self.scheduler.waiting) - depth
                allowance = self.cfg.max_waiting_seqs + max(
                    0, len(self.scheduler.free_slots) - preempted)
                if depth >= allowance:
                    self.metrics.admission_rejected.inc()
                    raise AdmissionRejected(
                        depth, self.estimated_queue_delay_s())
            self.scheduler.add(seq)
            self.seqs[seq_id] = seq
        return seq_id

    def check_options(self, options: SamplingOptions) -> None:
        """The JAX engine's range checks: a bad value is a ValueError
        here, on the caller's thread, never a failed step."""
        if options.logit_bias:
            if len(options.logit_bias) > LOGIT_BIAS_K:
                raise ValueError(
                    f"logit_bias supports at most {LOGIT_BIAS_K} "
                    f"entries (got {len(options.logit_bias)})")
            V = self.model_cfg.vocab_size
            bad = [t for t in options.logit_bias if not 0 <= int(t) < V]
            if bad:
                raise ValueError(
                    f"logit_bias token id {bad[0]} out of range for "
                    f"vocab size {V}")
        if not options.repetition_penalty > 0:
            raise ValueError(
                f"repetition_penalty must be > 0 "
                f"(got {options.repetition_penalty})")
        for fname in ("presence_penalty", "frequency_penalty"):
            val = getattr(options, fname)
            if not -2.0 <= val <= 2.0:
                raise ValueError(f"{fname} must be in [-2, 2] (got {val})")
        if not 0.0 <= options.min_p <= 1.0:
            raise ValueError(f"min_p must be in [0, 1] "
                             f"(got {options.min_p})")
        if options.min_tokens < 0:
            raise ValueError(f"min_tokens must be >= 0 "
                             f"(got {options.min_tokens})")
        if (options.min_tokens and options.stop_token_ids
                and len(options.stop_token_ids) > MIN_TOKENS_STOP_K):
            raise ValueError(
                f"min_tokens supports at most {MIN_TOKENS_STOP_K} "
                f"stop_token_ids (got {len(options.stop_token_ids)})")

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
            self._refresh_gauges()
            return ok

    # ------------------------------------------------------------------

    def step(self) -> List[StepOutput]:
        """One engine iteration: this step's prefill chunks, then the
        decode window in flight is read and the next one dispatched."""
        with self._lock:
            outputs = self._expire_waiting()
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
            self._maybe_defrag()
            self._refresh_gauges()
            return outputs

    def _maybe_defrag(self) -> None:
        """kvplane intra-replica defrag, at the end of a step (no
        allocation is mid-flight): when this step's admissions met
        fragmented failures, compact the free list so the next
        allocations take dense block-id runs."""
        if not self.cfg.kvplane_defrag:
            return
        frag = self.block_mgr.alloc_failures_fragmented
        if frag > self._defrag_seen_failures:
            self._defrag_seen_failures = frag
            self.block_mgr.defrag()

    def migrate_out(self, max_seqs: int = 2,
                    target_blocks: int = 0) -> Dict[str, object]:
        """kvplane live migration, source side: publish the victims'
        computed chunks to the shared tiers, preempt them (freeing their
        blocks), flush the write-through, and return the chunk keys so
        the planner can warm the destination and re-home routing.
        Victims are the least recently active sequences first (arrival
        time breaks ties). Each victim is prefetched again from the
        tiers, so its re-admission injects instead of recomputing."""
        if self.connector is None or not self.connector.cfg.is_producer:
            return {"migrated": [], "freed_blocks": 0, "keys": [],
                    "error": "kv tiering with a producer role is "
                             "required for migration"}
        keys: List[bytes] = []
        victims = []
        freed = 0
        with self._lock:
            candidates = list(self.scheduler.running.values()) \
                + list(self.scheduler._prefilling.values())
            candidates.sort(key=lambda s: (s.last_active, s.arrival_time))
            for seq in candidates:
                if len(victims) >= max(1, max_seqs):
                    break
                if target_blocks and freed >= target_blocks:
                    break
                held = len([b for b in seq.block_ids if b])
                if held == 0:
                    continue
                keys.extend(self.connector.on_migrate(
                    seq, salt=self._adapter_salt(seq.adapter_id)))
                self._preempt(seq)
                freed += held
                victims.append(seq)
            self.metrics.kvplane_migrations.inc(len(victims))
            self.metrics.kvplane_migrated_blocks.inc(freed)
        # outside the lock: the published chunks become tier-visible
        # before the planner acts on the keys; a victim admitted before
        # its prefetch lands recomputes, as before migration
        self.connector.flush(timeout=10.0)
        for seq in victims:
            pf = self.connector.prefetch(
                seq.prompt_tokens, salt=self._adapter_salt(seq.adapter_id))
            if pf is not None and seq.kv_prefetch is None:
                seq.kv_prefetch = pf
        return {"migrated": [s.seq_id for s in victims],
                "freed_blocks": freed,
                "keys": [k.hex() for k in keys]}

    def warm_chunks(self, hex_keys: List[str]) -> Dict[str, int]:
        """kvplane migration, destination side: pull the chunk keys
        through the tier walk so hits promote into this replica's
        fastest tier. Runs on the caller's thread."""
        if self.connector is None:
            return {"warmed": 0, "missed": 0}
        try:
            keys = [bytes.fromhex(k) for k in hex_keys]
        except ValueError:
            return {"warmed": 0, "missed": len(hex_keys)}
        warmed, missed = self.connector.warm_keys(keys)
        return {"warmed": warmed, "missed": missed}

    def _expire_waiting(self) -> List[StepOutput]:
        """Drop expired-deadline and over-delayed sequences from the
        waiting queue before admission, so no prefill is spent on a
        request its client has given up on. Each gets a terminal
        output with no token."""
        cap = self.cfg.max_queue_delay_ms
        outputs = []
        for seq in self.scheduler.expire_waiting(
                max_queue_delay_s=cap / 1e3 if cap is not None else None):
            self._free_seq_blocks(seq)
            self._remember(seq)
            if seq.finish_reason == "deadline":
                self.metrics.deadline_expired.inc()
            else:
                self.metrics.queue_delay_shed.inc()
            now = time.monotonic()
            logger.info("dropped %s while waiting (%s): queued %.0fms",
                        seq.seq_id, seq.finish_reason,
                        1e3 * (now - seq.arrival_time))
            # its whole remaining life was queue wait
            seq.queue_wait_s += now - seq.enqueued_time
            self.metrics.engine_phases.observe("queue_wait",
                                               seq.queue_wait_s)
            outputs.append(StepOutput(seq.seq_id, None, "", True,
                                      seq.finish_reason))
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
            last = [w.seq.options for w in group if w.is_last]
            # the first output token is masked from each guided row's
            # DFA state
            guide = self._guide_args([w.seq for w in group], states=True)
            penalized = any(o.shaped for o in last)
            topk = max((o.top_logprobs for o in last), default=0)
            if penalized:
                # the last chunks' rows sample their first token shaped;
                # the window in flight was read first, so the mirrors
                # are current. The next decode dispatch rebuilds again,
                # with the tokens this prefill samples
                self.runner.set_penalty_state(*self._penalty_arrays())
            ids_dev, lps_dev, tops_dev = self.runner.prefill(
                tokens, starts, lengths, self._dev_sampling,
                self.cfg.kv_bucket_for(min(kv_need, S)),
                penalized=penalized, topk=topk, **guide,
                **self._sampling_mode(opts))
            self.eff.note_prefill(
                bucket=bucket, batch=B,
                real_tokens=sum(len(w.chunk) for w in group))
            ids = lps = tops = None
            for w in group:
                self.scheduler.on_prefill_done(w)
                self.metrics.prompt_tokens.inc(len(w.chunk))
                seq = w.seq
                if (self.cfg.enable_prefix_caching
                        and not seq.rolled_blocks):
                    # a full block is final once its last position is
                    # written: register it for concurrent sharers now
                    seq.reg_state = self.block_mgr.register_incremental(
                        seq.prefill_tokens[:seq.num_prefilled],
                        seq.block_ids, seq.reg_state,
                        salt=self._adapter_salt(seq.adapter_id))
                if self.connector is not None:
                    # progressive publish: a decode engine can pull the
                    # prefix while later chunks still prefill
                    self.connector.on_prefill_progress(
                        seq, salt=self._adapter_salt(seq.adapter_id))
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
                    if tops_dev is not None:
                        tops = (tops_dev[0].cpu().numpy(),
                                tops_dev[1].cpu().numpy())
                alts = None
                k = seq.options.top_logprobs
                if tops is not None and k:
                    alts = _alts(tops[0][seq.slot], tops[1][seq.slot], k)
                seq.first_token_time = time.monotonic()
                self.metrics.ttft.observe(seq.first_token_time
                                          - seq.arrival_time)
                outputs.extend(self._accept_token(
                    seq, int(ids[seq.slot]), float(lps[seq.slot]), alts))
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
        """Upload the slots' sampling mirrors when a slot's options
        changed (admission, finish), never per window."""
        if self._sampling_dirty:
            dev = self.runner.device

            def up(a):
                return torch.from_numpy(a.copy()).to(dev)

            self._dev_sampling = SamplingParams(
                temperature=up(self._slot_temp), top_p=up(self._slot_top_p),
                top_k=up(self._slot_top_k), adapter=up(self._slot_adapter),
                seed=up(self._slot_seed),
                min_p=up(self._slot_min_p),
                presence=up(self._slot_presence),
                frequency=up(self._slot_frequency),
                repetition=up(self._slot_repetition),
                min_tokens=up(self._slot_min_tokens),
                prompt_len=up(self._slot_prompt_len),
                bias_ids=up(self._slot_bias_ids),
                bias_vals=up(self._slot_bias_vals),
                stop_ids=up(self._slot_stop_ids))
            self._sampling_dirty = False

    def _penalty_arrays(self):
        """[B, V] generated-token counts and prompt membership of every
        live slot, rebuilt from the sequences (at composition changes
        only; within windows the device carries the counts), so a
        sequence resumed after preemption has its own."""
        B, V = self.cfg.max_num_seqs, self.model_cfg.vocab_size
        counts = np.zeros((B, V), np.int32)
        seen = np.zeros((B, V), bool)
        live = list(self.scheduler.running.values()) + list(
            self.scheduler._prefilling.values())
        for s in live:
            if s.slot < 0:
                continue
            if s.output_tokens:
                out = np.asarray(s.output_tokens, np.int64)
                np.add.at(counts[s.slot], np.clip(out, 0, V - 1), 1)
            if s.prompt_tokens:
                pt = np.clip(np.asarray(s.prompt_tokens, np.int64), 0, V - 1)
                seen[s.slot][pt] = True
        return counts, seen

    def _ensure_guided_table(self):
        """(Re)build the stacked table of the distinct patterns among
        admitted sequences (JAX ``_ensure_guided_table``) on the device
        (stack_guided_tables). Returns (table, {pattern: row}).
        Rebuilt only when the set of active patterns changes, which
        marks the decode carry stale (the ids and states re-upload)."""
        active = list(self.scheduler.running.values()) + list(
            self.scheduler._prefilling.values())
        pats = sorted({s.options.guided_regex for s in active
                       if s.grammar is not None})
        key = tuple(pats)
        if pats and key != self._guided_key:
            table = stack_guided_tables(
                [guided.compile_grammar(p, self.tokenizer) for p in pats],
                self.model_cfg.vocab_size)
            self._guided_table = torch.from_numpy(table).to(
                self.runner.device)
            self._guided_gids = {p: i + 1 for i, p in enumerate(pats)}
            self._guided_key = key
            self._decode_dirty = True
        return self._guided_table, self._guided_gids

    def _guide_args(self, seqs, states: bool = False) -> dict:
        """The runner's guide arguments for a batch holding `seqs`: none
        without a guided row, else the table and each row's table index
        (0 = unguided), with `states` also each row's DFA state."""
        if all(s.grammar is None for s in seqs):
            return {}
        table, gid_map = self._ensure_guided_table()
        B = self.cfg.max_num_seqs
        gids = np.zeros((B,), np.int32)
        gstates = np.zeros((B,), np.int32)
        for s in seqs:
            if s.grammar is not None:
                gids[s.slot] = gid_map[s.options.guided_regex]
                gstates[s.slot] = s.fsm_state
        out = dict(guide_table=table, guide_ids=gids)
        if states:
            out["guide_states"] = gstates
        return out

    def _dispatch_decode(self, decode_seqs) -> bool:
        """Launch one decode window (no host sync). Every live slot's
        block table must span the whole window first — W * (K + 1) + 1
        positions under speculation of K tokens, the most a window can
        emit: under pool pressure the youngest sequences are preempted
        (recomputed later)."""
        W = self.cfg.decode_window
        horizon = W * (self.cfg.speculative_ngram_tokens + 1) + 1
        if self._roll_window:
            # free behind-window blocks before growing coverage: the
            # reclaimed blocks feed this very window's growth
            self._roll_windows(decode_seqs)
        for s in list(decode_seqs):
            if s.status is not SeqStatus.RUNNING:
                continue   # already preempted as a victim this pass
            if not self._ensure_blocks(s, s.next_position + horizon):
                self._preempt(s)
        decode_seqs = list(self.scheduler.running.values())
        if not decode_seqs:
            return False
        B, S = self.cfg.max_num_seqs, self.cfg.max_model_len
        self._ensure_dev_sampling()
        guide = self._guide_args(decode_seqs)
        # windows with a shaped row carry [B, V] counts and shape the
        # logits; a row asking for alternatives gets the top K
        penalized = any(s.options.shaped for s in decode_seqs)
        topk = max((s.options.top_logprobs for s in decode_seqs),
                   default=0)
        # speculation is per row: greedy (the argmax verify is exact),
        # unguided (drafts would pass the DFA mask by), unshaped (the
        # verify ignores the shaped logits) and without alternatives (a
        # macro-step emits several tokens)
        spec_rows = [s for s in decode_seqs
                     if s.options.temperature <= 0.0 and s.grammar is None
                     and not s.options.shaped
                     and not s.options.top_logprobs]
        spec = self.cfg.speculative_ngram_tokens if spec_rows else 0
        spec_ok = None
        if spec:
            spec_ok = np.zeros((B,), bool)
            spec_ok[[s.slot for s in spec_rows]] = True
        max_pos = max(s.next_position for s in decode_seqs)
        kv_len = self.cfg.kv_bucket_for(
            min(max_pos + W * (spec + 1) + 1, S))
        hist = None
        if spec and self._decode_dirty:
            # the set of rows, and so whether any speculates, changes
            # only with the composition, which marks the carry stale:
            # the device history is current whenever the carry is
            hist = np.zeros((B, S), np.int32)
            for s in decode_seqs:
                row = s.prompt_tokens + s.output_tokens
                hist[s.slot, :len(row)] = row
        if penalized and self._decode_dirty:
            # uploaded on the decode carry's trigger: any composition
            # change; within windows the device adds each step's ids
            self.runner.set_penalty_state(*self._penalty_arrays())
        if self._decode_dirty:
            self.runner.set_decode_state(
                self._slot_token, self._slot_pos,
                self._slot_gstate if guide else None, hist)
            self._decode_dirty = False
        kw = dict(steps=W, kv_len=kv_len, penalized=penalized, topk=topk,
                  **guide, **self._sampling_mode(
                      [s.options for s in decode_seqs]))
        if spec:
            ids_dev, lps_dev, counts_dev, tops_dev = self.runner.decode_spec(
                self._dev_sampling, spec=spec, spec_ok=spec_ok, **kw)
        else:
            ids_dev, lps_dev, tops_dev = self.runner.decode(
                self._dev_sampling, **kw)
            counts_dev = None
        self._inflight = (ids_dev, lps_dev, counts_dev, tops_dev, W,
                          list(decode_seqs), time.monotonic(), spec_ok,
                          kv_len)
        return True

    def _process_window(self) -> List[StepOutput]:
        """Read the window in flight (its one host sync) and walk its
        steps: each live row takes its tokens until it stops — under
        speculation 1..K+1 per macro-step, the rest of a macro-step
        dropped where the row stops."""
        if self._inflight is None:
            return []
        (ids_dev, lps_dev, counts_dev, tops_dev, W, seqs, t0, spec_ok,
         kv_len) = self._inflight
        self._inflight = None
        # the window's wall time: from its dispatch, or from the last
        # read if the host was still reading the previous one
        t0 = max(t0, self._last_sync_t)
        ids = ids_dev.cpu().numpy()
        lps = lps_dev.cpu().numpy()
        counts = None if counts_dev is None else counts_dev.cpu().numpy()
        tops = None
        if tops_dev is not None:
            tops = (tops_dev[0].cpu().numpy(), tops_dev[1].cpu().numpy())
        self._last_sync_t = time.monotonic()
        self.metrics.engine_phases.observe("decode_window",
                                           self._last_sync_t - t0)
        outputs: List[StepOutput] = []
        # a row whose sequence finished, was aborted or was preempted
        # (migrate_out preempts between steps, with this window in
        # flight) is discarded: only a sequence still RUNNING holds the
        # slot it was dispatched from
        alive = [s for s in seqs if s.status is SeqStatus.RUNNING]
        accepted = steps_walked = 0
        for j in range(W):
            steps_walked = j + 1
            still = []
            for seq in alive:
                slot = seq.slot
                if counts is None:
                    row = [(ids[slot, j], lps[slot, j])]
                else:
                    c = int(counts[slot, j])
                    row = list(zip(ids[slot, j, :c], lps[slot, j, :c]))
                    if spec_ok[slot]:
                        self.metrics.spec_macro_steps.inc()
                        self.metrics.spec_accepted_tokens.inc(c - 1)
                # a row with alternatives never speculates: one token
                # per step, and the step's alternatives are its own
                k = seq.options.top_logprobs
                alts = (_alts(tops[0][slot, j], tops[1][slot, j], k)
                        if tops is not None and k else None)
                finished = False
                for token, lp in row:
                    accepted += 1
                    outs = self._accept_token(seq, int(token), float(lp),
                                              alts)
                    outputs.extend(outs)
                    if outs[-1].finished:
                        finished = True
                        break
                if not finished:
                    still.append(seq)
            alive = still
            if not alive:
                break
        dt = time.monotonic() - t0
        # inter-token latency: the window's wall over the steps walked,
        # or over the tokens emitted where a macro-step emits several
        per_tok = dt / (steps_walked if counts is None else max(accepted, 1))
        for _ in range(accepted):
            self.metrics.per_token.observe(per_tok)
        B = self.cfg.max_num_seqs
        P = ids.shape[2] if counts is not None else 1
        pad = (B - len(seqs)) * W * P
        self.eff.note_window(steps=W, batch=B, kv_len=kv_len, real=accepted,
                             pad=pad, dead=B * W * P - pad - accepted,
                             window_s=dt, positions=P)
        return outputs

    def _accept_token(self, seq: Sequence, token: int,
                      logprob: Optional[float] = None,
                      top_alts=None) -> List[StepOutput]:
        seq.output_tokens.append(token)
        seq.last_active = time.monotonic()
        seq.output_logprobs.append(logprob)
        if seq.options.top_logprobs:
            seq.output_top.append(top_alts)
        if seq.grammar is not None:
            # host mirror of the device-carried DFA state (re-uploaded
            # on composition changes); the dead state is never picked
            seq.fsm_state = max(
                seq.grammar.next_state(seq.fsm_state, token), 0)
        self.metrics.generation_tokens.inc()
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
                               logprob, top_alts)]
        if self.connector is not None:
            # extract while the slot still holds this sequence's KV:
            # enqueued before scheduler.finish can recycle the slot
            self.connector.on_finish(
                seq, salt=self._adapter_salt(seq.adapter_id))
        # prefix caching: full blocks stay in the pool under their chain
        # keys; register BEFORE free so they land in the evictable LRU. A
        # rolled sequence's chain lost its early blocks: none registers
        if not seq.rolled_blocks:
            self.block_mgr.register(
                (seq.prompt_tokens + seq.output_tokens)[:-1],
                seq.block_ids, salt=self._adapter_salt(seq.adapter_id))
        self._free_seq_blocks(seq)
        slot = seq.slot
        self.scheduler.finish(seq, reason)
        self._park_slot(slot)
        self._remember(seq)
        now = time.monotonic()
        dur = now - seq.arrival_time
        self.metrics.e2e_latency.observe(dur)
        # the pace of the queue-delay estimate: the wall time, queueing
        # included, that the next queued client will wait through
        self._service_ewma = 0.8 * self._service_ewma + 0.2 * dur
        # where the request's engine time went: cumulative queue wait,
        # admission to first token, first token to finish
        admit = seq.admit_time if seq.admit_time is not None \
            else seq.arrival_time
        first = seq.first_token_time if seq.first_token_time is not None \
            else now
        phases = self.metrics.engine_phases
        phases.observe("queue_wait", seq.queue_wait_s)
        phases.observe("prefill", max(0.0, first - admit))
        phases.observe("decode", max(0.0, now - max(first, admit)))
        return [StepOutput(seq.seq_id, token, text_delta, True, reason,
                           logprob, top_alts)]

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
        """Mirror the sequence's next decode input into the slot arrays
        (its sampling row was mirrored when its prefill was scheduled,
        _do_prefill: a slot's options change only at admission)."""
        self._slot_token[seq.slot] = seq.output_tokens[-1]
        self._slot_pos[seq.slot] = seq.next_position
        self._slot_gstate[seq.slot] = seq.fsm_state

    def _sync_sampling(self, seq: Sequence) -> None:
        slot, opt = seq.slot, seq.options
        # user seeds (0 and negatives included) map to a positive id;
        # 0 marks an unseeded row
        seed = 0 if opt.seed is None else (opt.seed % 0x7FFFFFFE) + 1
        bias_ids = np.full((LOGIT_BIAS_K,), -1, np.int32)
        bias_vals = np.zeros((LOGIT_BIAS_K,), np.float32)
        for i, (tid, val) in enumerate(sorted((opt.logit_bias
                                               or {}).items())):
            bias_ids[i] = tid
            bias_vals[i] = val
        stop_ids = np.full((MIN_TOKENS_STOP_K,), -1, np.int32)
        if opt.min_tokens and opt.stop_token_ids:
            # only read below the min_tokens floor; width checked at
            # add_request. An id outside the vocabulary bans nothing,
            # as the JAX sampler's scatter drops it
            V = self.model_cfg.vocab_size
            ids = [t for t in opt.stop_token_ids if 0 <= t < V]
            stop_ids[:len(ids)] = ids
        row = (opt.temperature, opt.top_p, opt.top_k, seq.adapter_id, seed,
               opt.min_p, opt.presence_penalty, opt.frequency_penalty,
               opt.repetition_penalty, opt.min_tokens,
               len(seq.prompt_tokens), bias_ids, bias_vals, stop_ids)
        mirrors = (self._slot_temp, self._slot_top_p, self._slot_top_k,
                   self._slot_adapter, self._slot_seed, self._slot_min_p,
                   self._slot_presence, self._slot_frequency,
                   self._slot_repetition,
                   self._slot_min_tokens, self._slot_prompt_len,
                   self._slot_bias_ids, self._slot_bias_vals,
                   self._slot_stop_ids)
        # compared in the mirrors' dtypes: a float32 mirror never
        # equals a float64 0.8
        if any(not np.array_equal(m[slot], np.asarray(v, m.dtype))
               for m, v in zip(mirrors, row)):
            for m, v in zip(mirrors, row):
                m[slot] = v
            self._sampling_dirty = True

    def _park_slot(self, slot: int) -> None:
        """Return a freed slot's mirrors to the idle state (position
        max_model_len: its writes go to the trash block; shaping
        inert)."""
        if slot >= 0:
            self._slot_token[slot] = 0
            self._slot_pos[slot] = self.cfg.max_model_len
            self._slot_gstate[slot] = 0
            if self._slot_adapter[slot]:
                # a parked row on an adapter would keep the batch's
                # factors gathered for nothing
                self._slot_adapter[slot] = 0
                self._sampling_dirty = True
            if (self._slot_presence[slot] or self._slot_frequency[slot]
                    or self._slot_repetition[slot] != 1.0
                    or self._slot_min_tokens[slot]
                    or self._slot_bias_ids[slot, 0] >= 0
                    or self._slot_stop_ids[slot, 0] >= 0):
                self._slot_presence[slot] = 0.0
                self._slot_frequency[slot] = 0.0
                self._slot_repetition[slot] = 1.0
                self._slot_min_tokens[slot] = 0
                self._slot_bias_ids[slot, :] = -1
                self._slot_bias_vals[slot, :] = 0.0
                self._slot_stop_ids[slot, :] = -1
                self._sampling_dirty = True
            self._decode_dirty = True

    # ---------------------------------------------------- paged-KV host

    def _try_admit(self, seq: Sequence) -> bool:
        """Scheduler admission gate: claim KV blocks for the whole
        prompt (+1 position for the first sampled token); registered
        prefix blocks are attached by reference. False defers
        admission when the pool cannot cover the rest."""
        toks = seq.prefill_tokens
        salt = self._adapter_salt(seq.adapter_id)
        # hash the prompt once per (salt, length): a deferred admission
        # retries every scheduler pass, and counts one hit or miss
        first_try = (seq.prefix_state is None
                     or seq.prefix_state[0] != (salt, len(toks)))
        if first_try:
            seq.prefix_state = ((salt, len(toks)),
                                self.block_mgr.prefix_keys(toks, salt=salt))
        shared, covered = self.block_mgr.match_keys(
            seq.prefix_state[1], record_stats=first_try)
        need = self.block_mgr.blocks_for(len(toks) + 1) - len(shared)
        fresh = self.block_mgr.alloc(max(need, 0))
        if fresh is None:
            self.block_mgr.free(shared)   # unpin; retry next pass
            return False
        seq.block_ids = shared + fresh
        seq.num_prefilled = covered
        return True

    def _on_admit(self, seq: Sequence) -> None:
        """Scheduler hook (slot assigned): point the slot's table row at
        the sequence's blocks, then inject the tiers' cached prefix where
        it covers more than the HBM prefix cache does; prefill then
        starts at the cached length."""
        self._set_table_row(seq.slot, seq.block_ids)
        pf = seq.kv_prefetch
        seq.kv_prefetch = None   # release the host buffers either way
        if pf is None:
            return
        if pf.cached_tokens > seq.num_prefilled:
            # the injected range may overlap prefix-shared blocks: the
            # bytes are identical by key construction, so sharers read
            # the same values
            self.connector.inject(pf, seq.slot)
            seq.num_prefilled = pf.cached_tokens
        else:
            # block sharing covers as much already; the tier holds these
            # chunks, so they are not extracted again at finish
            self.connector.mark_seen(pf.keys)

    def _set_table_row(self, slot: int, block_ids) -> None:
        """A slot's table row: its blocks, rolled (None) entries and the
        rest at trash block 0."""
        self._tables[slot, :] = 0
        if block_ids:
            self._tables[slot, :len(block_ids)] = [b or 0 for b in block_ids]
        self.runner.set_block_tables(self._tables)

    def _free_seq_blocks(self, seq: Sequence) -> None:
        """Release a sequence's live blocks (rolled entries are None,
        freed already)."""
        self.block_mgr.free([b for b in seq.block_ids if b])
        seq.block_ids = []

    def _roll_windows(self, decode_seqs) -> None:
        """Free the blocks no future query of a running sequence can
        attend: those wholly before its window, positions <=
        next_position - W. Safe against the window being dispatched:
        its queries start at next_position or later, so their windows
        begin no earlier."""
        W = self._roll_window
        Bs = self.cfg.kv_block_size
        for s in decode_seqs:
            if s.status is not SeqStatus.RUNNING:
                continue
            keep_from = min(max(s.next_position - W + 1, 0) // Bs,
                            len(s.block_ids))
            if keep_from <= s.rolled_blocks:
                continue
            dead = [b for b in s.block_ids[s.rolled_blocks:keep_from] if b]
            if dead:
                self.block_mgr.free(dead)
            for i in range(s.rolled_blocks, keep_from):
                s.block_ids[i] = None
            s.rolled_blocks = keep_from
            self._set_table_row(s.slot, s.block_ids)

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
        seq.rolled_blocks = 0   # recompute re-prefills from position 0
        seq.reg_state = None    # re-register the recomputed blocks
        self.scheduler.preempt(seq)
        self._park_slot(slot)
        self._set_table_row(slot, [])
        self.metrics.preemptions.inc()

    # ------------------------------------------------- pooling routes

    @property
    def embedding_source(self) -> str:
        """What the pooling routes serve: the serving model's mean-pooled
        final hidden states (an encoder, ``embedding_model``, is not
        ported)."""
        return "causal-mean-pool"

    @property
    def embedding_tokenizer(self):
        """The tokenizer of the pooling routes: the serving one."""
        return self.tokenizer

    @property
    def max_embed_len(self) -> int:
        """Length cap of a pooling input: the serving cache length."""
        return self.cfg.max_model_len

    def embed_tokens(self, token_lists: List[List[int]]) -> np.ndarray:
        """Pooled embeddings [n, H] f32 of token lists (JAX
        ``embed_tokens``): batches of max_num_seqs rows, each padded to
        the smallest prefill or kv-length bucket that holds its longest
        input. Reads the weights only, so the server runs it beside the
        engine loop."""
        B = self.cfg.max_num_seqs
        buckets = sorted(set(self.cfg.prefill_buckets)
                         | set(self.cfg.kv_len_buckets))
        out: List[np.ndarray] = []
        for i in range(0, len(token_lists), B):
            group = token_lists[i:i + B]
            need = max(len(t) for t in group)
            tb = next((b for b in buckets if b >= need), need)
            tokens = np.zeros((B, tb), np.int32)
            lengths = np.ones((B,), np.int32)
            for j, toks in enumerate(group):
                tokens[j, :len(toks)] = toks
                lengths[j] = len(toks)
            pooled = self.runner.embed(tokens, lengths).cpu().numpy()
            out.append(pooled[:len(group)])
        return np.concatenate(out, axis=0)

    # ------------------------------------------------- overload surface

    def render_metrics(self) -> bytes:
        """The /metrics exposition: gauges refreshed, the efficiency and
        pool totals folded in as counter deltas."""
        with self._lock:
            self._refresh_gauges()
            if self.connector is not None:
                self.metrics.sync_kv(self.connector.stats_report())
            self.metrics.sync_eff(self.eff.report(), self.eff.rates())
            self.metrics.sync_kvpool(self.block_mgr.frag_report())
        return self.metrics.render()

    def admission_full(self) -> bool:
        """Lock-free hint: True when a new submit would very likely be
        rejected by bounded admission now, so a shed storm is refused
        before tokenization. The exact count stays in add_request."""
        cap = self.cfg.max_waiting_seqs
        if cap is None:
            return False
        return len(self.scheduler.waiting) >= \
            cap + len(self.scheduler.free_slots)

    def estimated_queue_delay_s(self) -> float:
        """The wait a newly queued request faces: the queue ahead of it
        over the batch width, paced by the recent per-request wall
        time. Lock-free (len() and attribute reads), so /load and
        Retry-After answer while a step holds the engine lock."""
        waiting = len(self.scheduler.waiting)
        return (waiting / max(1, self.cfg.max_num_seqs)) \
            * self._service_ewma

    def load_report(self) -> Dict[str, object]:
        """Point-in-time load signal, served on /load and as the
        x-engine-* response headers (signals.parse_load_report reads
        it). Lock-free, as estimated_queue_delay_s."""
        sched = self.scheduler
        cap = None
        if self.cfg.max_waiting_seqs is not None:
            cap = self.cfg.max_num_seqs + self.cfg.max_waiting_seqs
        report = {
            "queue_depth": len(sched.waiting),
            "running": len(sched.running) + len(sched._prefilling),
            "max_num_seqs": self.cfg.max_num_seqs,
            "max_waiting_seqs": self.cfg.max_waiting_seqs,
            # in-flight sequences accepted before shedding (None =
            # unbounded); the router derives its concurrency cap from it
            "capacity": cap,
            "free_kv_blocks": self.block_mgr.available,
            "kv_usage": round(self.block_mgr.usage, 4),
            "est_queue_delay_ms": round(
                1e3 * self.estimated_queue_delay_s(), 1),
            "models": list(self.served_models),
            "perf": self.eff.perf_block(),
            "kv_pool": self.block_mgr.frag_report(),
        }
        if self.connector is not None:
            # in-memory totals, no I/O: the cache-aware router scores
            # endpoints on them, the disagg and kvshare rigs read them
            report["kv_cache"] = self.connector.stats_report()
        return report

    def _refresh_gauges(self) -> None:
        m = self.metrics
        m.num_running.set(self.scheduler.num_running)
        m.num_waiting.set(self.scheduler.num_waiting)
        m.est_queue_delay.set(1e3 * self.estimated_queue_delay_s())
        usage = self.block_mgr.usage
        m.kv_usage.set(usage)
        m.hbm_kv_usage.set(usage)
        if self.cfg.enable_prefix_caching:
            m.hbm_prefix_hit_rate.set(self.block_mgr.hit_rate)
        # the tiers' token-weighted hit rate where there are tiers, else
        # the block pool's per-request one
        if self.connector is not None:
            m.prefix_hit_rate.set(self.connector.hit_rate)
        elif self.cfg.enable_prefix_caching:
            m.prefix_hit_rate.set(self.block_mgr.hit_rate)

    def close(self) -> None:
        """Flush the KV writer and release the tiers' connections."""
        if self.connector is not None:
            self.connector.close()

    # ------------------------------------------------------------------

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work


def stack_guided_tables(grammars, vocab: int) -> np.ndarray:
    """The compiled grammars' token tables stacked into one int32
    [G, S, vocab] table: row 0 the unguided placeholder, grammar i at
    row i + 1, G and S padded to powers of two (as the JAX engine pads
    them to bound its executables' shapes), -1 = forbidden, the
    vocabulary columns beyond a grammar's tokenizer too."""
    S = max(g.n_states for g in grammars)
    S = 1 << (S - 1).bit_length() if S > 1 else 1
    G = 1 << len(grammars).bit_length()
    table = np.full((G, S, vocab), -1, np.int32)
    for gi, g in enumerate(grammars, start=1):
        s, v = g.token_next.shape
        table[gi, :s, :min(v, vocab)] = g.token_next[:, :vocab]
    return table


def _alts(ids: np.ndarray, lps: np.ndarray, k: int) -> list:
    """A row's top-k alternatives [(id, logprob)], dropping banned
    entries (-1e30 logits would serialize as -Infinity)."""
    return [(int(t), float(l)) for t, l in zip(ids[:k], lps[:k])
            if l > -1e29]
