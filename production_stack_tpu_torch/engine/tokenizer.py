"""Tokenizers: HF-backed for real checkpoints, byte-level for debug models.

A copy of ``production_stack_tpu/engine/tokenizer.py`` (the port imports
nothing of the JAX package), except that the byte tokenizer reads a
negative id as an unknown one where the JAX copy raises.

The byte tokenizer keeps every CI/e2e path hardware- and download-free
(the reference achieves the same with facebook/opt-125m on CPU runners,
reference: .github/workflows/functionality-helm-chart.yml; we go further
and need no network at all).
"""

from typing import List, Optional, Sequence

BOS_ID = 256
EOS_ID = 257
PAD_ID = 258


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0-255 are bytes, then BOS/EOS/PAD."""

    vocab_size = 512
    bos_token_id = BOS_ID
    eos_token_id = EOS_ID
    pad_token_id = PAD_ID

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return [BOS_ID] + ids if add_bos else ids

    def decode(self, ids: Sequence[int]) -> str:
        # ids outside the byte range (a prompt's negative ids too)
        # decode to nothing
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace")

    def id_to_token(self, token_id: int):
        """(token string, raw bytes) for logprobs reporting — byte ids
        keep their exact byte so clients can reassemble split UTF-8."""
        if 0 <= token_id < 256:
            raw = bytes([token_id])
            return raw.decode("utf-8", errors="replace"), list(raw)
        name = {BOS_ID: "<bos>", EOS_ID: "<eos>", PAD_ID: "<pad>"}.get(
            token_id, f"<unk:{token_id}>")
        return name, list(name.encode("utf-8"))

    @property
    def special_token_ids(self):
        # everything past the byte range: specials + unmapped ids
        return list(range(256, self.vocab_size))

    def apply_chat_template(self, messages: List[dict]) -> str:
        parts = [f"<|{m.get('role', 'user')}|>\n{_content_text(m)}\n"
                 for m in messages]
        return "".join(parts) + "<|assistant|>\n"


_BYTE_DECODER = None


def _byte_decoder():
    """The standard byte-level-BPE bytes↔unicode table (GPT-2's
    bytes_to_unicode), inverted: printable char -> original byte.
    Covers ALL 256 bytes, so a piece made entirely of these chars is a
    byte-level piece and inverts exactly."""
    global _BYTE_DECODER
    if _BYTE_DECODER is None:
        bs = (list(range(ord("!"), ord("~") + 1))
              + list(range(ord("¡"), ord("¬") + 1))
              + list(range(ord("®"), ord("ÿ") + 1)))
        cs = bs[:]
        n = 0
        for b in range(256):
            if b not in bs:
                bs.append(b)
                cs.append(256 + n)
                n += 1
        _BYTE_DECODER = {chr(c): b for b, c in zip(bs, cs)}
    return _BYTE_DECODER


class HFTokenizer:
    """Wraps a transformers tokenizer loaded from a checkpoint path."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer
        self._tok = AutoTokenizer.from_pretrained(path)
        self.vocab_size = len(self._tok)
        self.bos_token_id = self._tok.bos_token_id
        self.eos_token_id = self._tok.eos_token_id
        self.pad_token_id = self._tok.pad_token_id or self._tok.eos_token_id
        self.bos_token = self._tok.bos_token or ""
        self.eos_token = self._tok.eos_token or ""
        self._byte_level = None   # lazily detected (see _is_byte_level)

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        return self._tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(ids, skip_special_tokens=True)

    def id_to_token(self, token_id: int):
        """(token string, raw bytes) for logprobs reporting and the
        guided-decoding token lift. Uses the tokenizer's own token
        representation (convert_ids_to_tokens), NOT decode([id]) —
        decoding a multi-byte-split piece in isolation collapses
        distinct tokens to the replacement char and loses the bytes
        clients need to reassemble UTF-8.

        Raw bytes come from the piece's own encoding scheme: byte-level
        BPE pieces (GPT-2/Llama-3/Qwen style — every char is in the
        256-entry bytes↔unicode table) invert that table exactly, so a
        token for "é" lifts as [0xC3, 0xA9], not the mojibake piece's
        UTF-8; SentencePiece pieces map ▁ to a real space (a lone
        piece's leading space is load-bearing for guided matching —
        convert_tokens_to_string would strip it) and <0xHH>
        byte-fallbacks to their exact byte."""
        piece = self._tok.convert_ids_to_tokens(token_id)
        if piece is None:
            piece = f"<unk:{token_id}>"
        if (len(piece) == 6 and piece.startswith("<0x")
                and piece.endswith(">")):
            try:
                return piece, [int(piece[3:5], 16)]
            except ValueError:
                pass
        if self._is_byte_level():
            bd = _byte_decoder()
            if piece and all(c in bd for c in piece):
                return piece, [bd[c] for c in piece]
        text = piece.replace("▁", " ")      # SPM word boundary
        return piece, list(text.encode("utf-8"))

    def _is_byte_level(self) -> bool:
        """Byte-level BPE (GPT-2/Llama-3/Qwen) vs SentencePiece: decided
        per TOKENIZER, not per piece — SPM vocabularies also contain
        chars that happen to be in the byte table (é), which must lift
        as UTF-8, while in a byte-level vocab the same char IS a byte.
        The Ġ space marker only exists in byte-level vocabs."""
        if self._byte_level is None:
            try:
                vocab = self._tok.get_vocab()
                self._byte_level = any("Ġ" in k for k in vocab)
            except Exception:
                self._byte_level = False
        return self._byte_level

    @property
    def special_token_ids(self):
        return list(getattr(self._tok, "all_special_ids", []) or [])

    def apply_chat_template(self, messages: List[dict]) -> str:
        if getattr(self._tok, "chat_template", None):
            return self._tok.apply_chat_template(
                messages, tokenize=False, add_generation_prompt=True)
        return ByteTokenizer.apply_chat_template(self, messages)  # type: ignore


def _content_text(message: dict) -> str:
    content = message.get("content", "")
    if isinstance(content, list):  # OpenAI content-part arrays
        return "".join(p.get("text", "") for p in content
                       if isinstance(p, dict))
    return str(content)


def render_chat_template(template_text: str, messages: List[dict],
                         **extra_vars) -> str:
    """Render a user-supplied Jinja chat template (HF conventions:
    `messages` in scope, `add_generation_prompt` true). StrictUndefined:
    a template referencing a variable we don't provide errors loudly
    instead of silently rendering empty strings."""
    import datetime

    import jinja2
    env = jinja2.Environment(autoescape=False,
                             undefined=jinja2.StrictUndefined)

    # helpers stock HF chat templates expect (many Llama/Mistral templates
    # call raise_exception on bad role sequences; some stamp dates)
    def raise_exception(message):
        raise jinja2.exceptions.TemplateError(message)

    env.globals["raise_exception"] = raise_exception
    env.globals["strftime_now"] = \
        lambda fmt: datetime.datetime.now().strftime(fmt)
    return env.from_string(template_text).render(
        messages=messages, add_generation_prompt=True, **extra_vars)


def load_tokenizer(model_or_path: str, tokenizer_path: Optional[str] = None,
                   chat_template_path: Optional[str] = None):
    """HF tokenizer when a checkpoint dir exists; byte tokenizer otherwise.
    `chat_template_path` (a Jinja file) overrides the built-in template —
    the reference surfaces the same knob as the engine's chat-template
    mount (deployment-vllm-multi.yaml:100-103)."""
    import os
    path = tokenizer_path or model_or_path
    tok = None
    if os.path.isdir(path):
        try:
            tok = HFTokenizer(path)
        except Exception:
            pass
    if tok is None:
        tok = ByteTokenizer()
    if chat_template_path:
        with open(chat_template_path) as f:
            template_text = f.read()
        extra = {
            # common HF template variables
            "bos_token": getattr(tok, "bos_token", "") or "",
            "eos_token": getattr(tok, "eos_token", "") or "",
        }

        def apply_with_override(messages: List[dict]) -> str:
            return render_chat_template(template_text, messages, **extra)

        # fail at startup, not per-request: a broken template (Jinja
        # typo, missing jinja2, undefined variable) must never silently
        # fall back to the default and serve wrong prompts
        probe = [{"role": "system", "content": "probe"},
                 {"role": "user", "content": "probe"}]
        try:
            apply_with_override(probe)
        except Exception as e:
            raise ValueError(
                f"chat template {chat_template_path!r} failed to render: "
                f"{e}") from e
        tok.apply_chat_template = apply_with_override  # type: ignore
    return tok


class DetokenizeStream:
    """Incremental detokenizer producing printable deltas per new token.

    Buffers until the decoded string grows cleanly (handles multi-byte
    UTF-8 and SentencePiece prefix-space merges) — the SSE stream sends
    only stable text.
    """

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._ids: List[int] = []
        # incremental window (the vLLM detokenizer scheme): decode only
        # ids[prefix:] each push — prefix trails read by a few tokens of
        # context so SentencePiece prefix-space merges and multi-byte
        # codepoints resolve identically to a full decode, while per-
        # token cost stays O(window), not O(sequence) (a full re-decode
        # per token is quadratic and dominates host time at long
        # generations).
        self._prefix = 0     # window start
        self._stable = ""    # emitted portion of decode(ids[prefix:])
        self._hold = 0       # consecutive mid-codepoint holds
        self._empty = {}     # id -> renders-nothing-alone (cached)

    # context window (tokens): window start, keep_head offset, buffer
    # tail, and the hold bound all derive from this ONE constant — the
    # slide/compaction invariants require them mutually consistent
    _WINDOW = 8

    def _invisible(self, token_id: int) -> bool:
        v = self._empty.get(token_id)
        if v is None:
            v = self._empty[token_id] = \
                self._tok.decode([token_id]) == ""
        return v

    def push(self, token_id: int) -> str:
        W = self._WINDOW
        self._ids.append(token_id)
        text = self._tok.decode(self._ids[self._prefix:])
        pending = text.endswith("�")
        if pending:
            # trailing codepoint may still be in flight: hold — but
            # BOUNDED. A UTF-8 sequence resolves within 4 bytes, so W
            # consecutive pending decodes mean the tail is invalid
            # bytes, not an in-flight codepoint: emit everything EXCEPT
            # the final (only still-completable) char instead of
            # freezing the window and re-paying an ever-growing decode
            # per push on degenerate byte storms. Because the pending
            # char is never counted emitted (_stable excludes it, and
            # slid windows exclude it below), a later completion emits
            # the resolved char through the ordinary delta — no
            # retroactive divergence, no lost codepoint.
            self._hold += 1
            if self._hold <= W:
                return ""
            emit_to = len(text) - 1
        else:
            emit_to = len(text)
        self._hold = 0
        delta = text[len(self._stable):emit_to] \
            if emit_to > len(self._stable) else ""
        # slide the window: keep the trailing tokens as context so the
        # next decode resolves prefix-space merges exactly like a full
        # decode would. _stable is re-decoded FROM THE NEW START so the
        # next delta is measured against the same origin (a suffix
        # decode can render its first chars differently than the full
        # string; consistency of origin is what matters). String-
        # position-dependent rendering (SentencePiece strips a leading
        # space at position 0) can only leak into a delta when _stable
        # is EMPTY — the next token would sit at the window's string
        # start and lose its boundary space — so when the trailing
        # window renders nothing, KEEP the current origin and instead
        # bound the buffer by dropping middle ids that render nothing
        # on their own (skipped specials: decode output is unchanged
        # without them, and the kept window stays O(2W) through
        # arbitrarily long invisible runs, e.g. an eos loop under
        # ignore_eos).
        start = max(0, len(self._ids) - W)
        stable = self._tok.decode(self._ids[start:])
        if pending and stable.endswith("�"):
            stable = stable[:-1]     # pending char stays un-emitted
        if stable == "" and start > self._prefix:
            self._stable = text[:emit_to]
            keep_head = self._prefix + W
            tail_start = len(self._ids) - W
            if tail_start > keep_head:
                mid = [i for i in self._ids[keep_head:tail_start]
                       if not self._invisible(i)]
                self._ids[keep_head:tail_start] = mid
        else:
            self._prefix = start
            self._stable = stable
        return delta

    def flush(self) -> str:
        """Emit whatever is still buffered (e.g. a trailing partial
        codepoint rendered as the replacement char) at end of stream."""
        text = self._tok.decode(self._ids[self._prefix:])
        delta = text[len(self._stable):]
        self._stable = text
        return delta
