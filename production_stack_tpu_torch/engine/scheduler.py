"""Continuous-batching scheduler: waiting queue -> slots -> decode batch
(``production_stack_tpu/engine/scheduler.py``).

Policy (round-robin between admission and decode):
- A waiting sequence is admitted when a slot is free; its prompt is
  prefilled in chunks of ``prefill_chunk`` tokens (chunked prefill).
- The engine batch-prefills every admissible sequence's next chunk and
  runs a decode window over all running slots in the same step.
- Finished sequences free their slot immediately; the next waiting
  sequence takes it on the following iteration.

The scheduler is pure host-side bookkeeping — device work happens in
ModelRunner.
"""

import collections
import enum
import time
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple


class SeqStatus(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    RUNNING = "running"
    FINISHED = "finished"


@dataclass
class SamplingOptions:
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    max_tokens: int = 128
    stop: List[str] = field(default_factory=list)
    stop_token_ids: List[int] = field(default_factory=list)
    ignore_eos: bool = False
    logprobs: bool = False
    # OpenAI top_logprobs: return the K highest-probability
    # alternatives per generated token (0 = chosen-token only)
    top_logprobs: int = 0
    # > 0: reproducible sampling — gumbel noise derived from
    # (seed, token position) only (engine/sampler.py)
    seed: Optional[int] = None
    # constrain generation to this regex (engine/guided.py); the server
    # maps guided_choice onto it
    guided_regex: Optional[str] = None
    # OpenAI/vLLM logit shaping (engine/sampler.adjust_logits); all
    # inert at their defaults — the penalized executable only compiles
    # when a live row departs from them
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    min_p: float = 0.0
    min_tokens: int = 0
    logit_bias: Optional[Dict[int, float]] = None
    # vLLM scheduling priority: LOWER values admit earlier; equal
    # priorities keep FIFO arrival order (scheduler.add)
    priority: int = 0

    @property
    def shaped(self) -> bool:
        """True when this request needs the penalized executable."""
        return bool(self.presence_penalty or self.frequency_penalty
                    or self.repetition_penalty != 1.0 or self.min_tokens
                    or self.logit_bias)


@dataclass
class Sequence:
    seq_id: str
    prompt_tokens: List[int]
    options: SamplingOptions
    status: SeqStatus = SeqStatus.WAITING
    slot: int = -1
    adapter_id: int = 0      # LoRA adapter (0 = base model, models/lora.py)
    # paged-KV blocks this sequence owns, table order (engine/
    # block_manager.py); prefix-shared blocks lead, exclusive ones
    # follow. Rolled (freed behind the sliding window) entries are None
    # placeholders, so a block's index stays its virtual position
    block_ids: List[Optional[int]] = field(default_factory=list)
    # blocks freed behind the sliding window (engine._roll_windows);
    # prefix registration is skipped once any block rolled
    rolled_blocks: int = 0
    # live progressive-registration hasher chain state
    # (block_manager.register_incremental); reset on preemption
    reg_state: object = None
    output_tokens: List[int] = field(default_factory=list)
    # per output token: chosen-token logprob (pre-temperature, post-
    # shaping distribution — raw model distribution for unshaped rows)
    output_logprobs: List[Optional[float]] = field(default_factory=list)
    # per output token, when options.top_logprobs: [(id, logprob)] top
    # alternatives under the same distribution
    output_top: List[Optional[list]] = field(default_factory=list)
    num_prefilled: int = 0
    arrival_time: float = field(default_factory=time.monotonic)
    # last forward progress (a prefill chunk landed, a token emitted):
    # kvplane migration retires the least recently active sequence
    # first. Set from arrival in __post_init__
    last_active: float = 0.0
    # phase attribution: queue time accumulates across admissions, so a
    # preempted-and-requeued sequence never counts an interval twice —
    # enqueued_time stamps each entry into the waiting queue, schedule()
    # folds the closed interval into queue_wait_s at slot assignment,
    # and admit_time keeps the last admission
    enqueued_time: float = 0.0          # set from arrival in __post_init__
    queue_wait_s: float = 0.0
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    # absolute monotonic deadline (the client's x-request-deadline-ms):
    # a sequence whose deadline passes while it still waits is dropped
    # by expire_waiting() before any prefill. None = no deadline
    deadline: Optional[float] = None
    finish_reason: Optional[str] = None
    # KV-tier prefetch of this request at add time
    # (kvcache/connector.py): wall seconds of the tier walk and the
    # prompt tokens it served
    kv_prefetch_wait_s: float = 0.0
    kv_cached_tokens: int = 0
    # host-side KV of a cached prompt prefix, fetched off the engine
    # loop at add time (connector.Prefetch); injected at admission
    kv_prefetch: object = None
    # incremental chunk-key chain state of the progressive KV publish
    # (connector._publish)
    kv_publish_state: object = None
    # cached prefix-cache chain keys: (salt, prefill_len, keys) — an
    # admission deferred by pool pressure retries every scheduler pass
    # and must not re-hash the prompt (or re-count hit/miss) each time
    prefix_state: object = None
    # guided decoding (engine/guided.py): compiled grammar + current
    # DFA state (host mirror of the device-carried state)
    grammar: object = None
    fsm_state: int = 0
    # incremental detokenization state (owned by LLMEngine)
    output_text: str = ""       # stable decoded text, stop-truncated
    chars_emitted: int = 0      # prefix of output_text already delivered
    detok: object = None

    def __post_init__(self):
        self.enqueued_time = self.arrival_time
        self.last_active = self.arrival_time

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_tokens) + len(self.output_tokens)

    @property
    def next_position(self) -> int:
        return self.num_tokens - 1

    @property
    def prefill_tokens(self) -> List[int]:
        """Tokens to prefill when (re)building this sequence's KV: the
        prompt, plus — after a preemption-recompute — the already-
        emitted output teacher-forced back in (all but the last emitted
        token, which becomes the decode input again)."""
        if self.output_tokens:
            return self.prompt_tokens + self.output_tokens[:-1]
        return self.prompt_tokens


@dataclass
class PrefillWork:
    seq: Sequence
    chunk: List[int]
    start: int
    is_last: bool


class Scheduler:
    def __init__(self, max_num_seqs: int, max_model_len: int,
                 prefill_chunk: int):
        self.max_num_seqs = max_num_seqs
        self.max_model_len = max_model_len
        self.prefill_chunk = prefill_chunk
        self.waiting: Deque[Sequence] = collections.deque()
        self.running: Dict[int, Sequence] = {}        # slot -> seq
        # kept sorted DESCENDING so pop() hands out the LOWEST free
        # slot: admissions fill the low slots first
        self.free_slots: List[int] = list(range(max_num_seqs - 1, -1, -1))
        self._prefilling: Dict[int, Sequence] = {}    # slot -> seq
        # invoked right after a slot is assigned, before the first prefill
        # chunk is cut: may advance seq.num_prefilled past a cached prefix
        self.on_admit: Optional[object] = None
        # admission gate: called with the head-of-queue sequence BEFORE a
        # slot is taken; returning False defers admission (the engine's
        # KV block allocator uses this — engine.py _try_admit)
        self.can_admit: Optional[object] = None

    # ------------------------------------------------------------------

    def add(self, seq: Sequence) -> None:
        if len(seq.prompt_tokens) >= self.max_model_len:
            raise ValueError(
                f"prompt length {len(seq.prompt_tokens)} exceeds "
                f"max_model_len {self.max_model_len}")
        # priority insertion (vLLM semantics: lower value admits
        # earlier; FIFO within a priority level). The common all-
        # default case is a pure O(1) append. The scan iterates (no
        # mid-deque indexing — deque[i] is O(n)) and never crosses a
        # PREEMPTED sequence (one with emitted output): recompute-first
        # holds even against higher-priority arrivals, or a steady
        # stream of them would starve a partially-streamed request
        # while its recompute debt grows.
        pr = seq.options.priority
        i = len(self.waiting)
        for other in reversed(self.waiting):
            if other.options.priority > pr and not other.output_tokens:
                i -= 1
            else:
                break
        if i == len(self.waiting):
            self.waiting.append(seq)
        else:
            self.waiting.insert(i, seq)

    def abort(self, seq_id: str) -> bool:
        for seq in list(self.waiting):
            if seq.seq_id == seq_id:
                self.waiting.remove(seq)
                seq.status = SeqStatus.FINISHED
                seq.finish_reason = "abort"
                seq.kv_prefetch = None   # release host KV buffers
                return True
        for slot, seq in list(self.running.items()):
            if seq.seq_id == seq_id:
                self._release(slot, seq, "abort")
                return True
        for slot, seq in list(self._prefilling.items()):
            if seq.seq_id == seq_id:
                del self._prefilling[slot]
                self._release(slot, seq, "abort")
                return True
        return False

    def expire_waiting(self, now: Optional[float] = None,
                       max_queue_delay_s: Optional[float] = None
                       ) -> List[Sequence]:
        """Overload sweep over the waiting queue, run by the engine at
        the top of every step: a sequence past its ``deadline`` is
        dropped with finish_reason ``"deadline"``; with
        ``max_queue_delay_s`` set, one queued longer than that is shed
        with ``"queue_delay"``. Preempted sequences (with emitted
        output) are exempt from the queue-delay shed, not from their
        deadline. Returns the dropped sequences."""
        if not self.waiting:
            return []
        if now is None:
            now = time.monotonic()
        dropped: List[Sequence] = []
        kept: List[Sequence] = []
        for seq in self.waiting:
            if seq.deadline is not None and now >= seq.deadline:
                reason = "deadline"
            elif (max_queue_delay_s is not None
                  and not seq.output_tokens
                  and now - seq.arrival_time >= max_queue_delay_s):
                reason = "queue_delay"
            else:
                kept.append(seq)
                continue
            seq.status = SeqStatus.FINISHED
            seq.finish_reason = reason
            seq.kv_prefetch = None   # release host KV buffers
            dropped.append(seq)
        if dropped:
            self.waiting.clear()
            self.waiting.extend(kept)
        return dropped

    # ------------------------------------------------------------------

    def schedule(self) -> Tuple[List[PrefillWork], List[Sequence]]:
        """Pick this iteration's device work.

        Returns (prefill_works, decode_seqs) — BOTH may be non-empty: the
        engine batch-prefills every admissible sequence's next chunk in
        one dispatch and then runs a decode window in the same step, so a
        newcomer's (chunked) prefill never stalls running sequences'
        token cadence.
        """
        works = [self._chunk_of(seq) for seq in self._prefilling.values()]
        while self.waiting and self.free_slots:
            seq = self.waiting[0]
            if self.can_admit is not None and not self.can_admit(seq):
                break   # KV pool pressure: keep FIFO order, retry later
            self.waiting.popleft()
            seq.admit_time = time.monotonic()
            seq.queue_wait_s += seq.admit_time - seq.enqueued_time
            seq.slot = self.free_slots.pop()
            seq.status = SeqStatus.PREFILLING
            self._prefilling[seq.slot] = seq
            if self.on_admit is not None:
                self.on_admit(seq)
            works.append(self._chunk_of(seq))
        return works, list(self.running.values())

    def _chunk_of(self, seq: Sequence) -> PrefillWork:
        toks = seq.prefill_tokens
        start = seq.num_prefilled
        end = min(start + self.prefill_chunk, len(toks))
        return PrefillWork(seq=seq, chunk=toks[start:end],
                           start=start, is_last=end == len(toks))

    def on_prefill_done(self, work: PrefillWork) -> None:
        seq = work.seq
        seq.num_prefilled += len(work.chunk)
        seq.last_active = time.monotonic()
        if work.is_last:
            seq.status = SeqStatus.RUNNING
            self._prefilling.pop(seq.slot, None)
            self.running[seq.slot] = seq

    def preempt(self, seq: Sequence) -> None:
        """KV-pressure preemption (recompute flavor): drop the sequence
        back to the FRONT of the waiting queue; its next admission
        re-prefills prefill_tokens (prompt + emitted output, teacher-
        forced) into freshly allocated blocks. The engine frees the
        blocks and parks the slot (engine.py _preempt)."""
        slot = seq.slot
        self.running.pop(slot, None)
        self._prefilling.pop(slot, None)
        if slot >= 0:
            self._free_slot(slot)
        seq.slot = -1
        seq.status = SeqStatus.WAITING
        seq.num_prefilled = 0
        seq.enqueued_time = time.monotonic()   # a new queue-wait interval
        self.waiting.appendleft(seq)

    def finish(self, seq: Sequence, reason: str) -> None:
        self._release(seq.slot, seq, reason)

    def _free_slot(self, slot: int) -> None:
        """Return a slot to the free list, keeping it sorted descending
        (pop() hands out the lowest index)."""
        self.free_slots.append(slot)
        self.free_slots.sort(reverse=True)

    def _release(self, slot: int, seq: Sequence, reason: str) -> None:
        seq.status = SeqStatus.FINISHED
        seq.finish_reason = reason
        seq.kv_prefetch = None   # finished seqs are retained; drop host KV
        if slot >= 0:
            self.running.pop(slot, None)
            self._free_slot(slot)
            seq.slot = -1

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self._prefilling)

    @property
    def num_waiting(self) -> int:
        return len(self.waiting) + len(self._prefilling)

    @property
    def num_running(self) -> int:
        return len(self.running)

