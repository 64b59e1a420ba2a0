"""PII detection for incoming requests (feature gate ``PIIDetection``).

Capability parity with reference src/vllm_router/experimental/pii/
(types.py:1-53 PIIType enum; analyzers/base.py + analyzers/regex.py
dependency-free analyzer; middleware.py:60-154 request-blocking with
conservative block-on-error). Differences by design:

  * aiohttp middleware (this stack's server) instead of FastAPI;
  * REDACT is implemented, not just declared: matched spans are replaced
    with ``[REDACTED:<type>]`` and the sanitized body is handed to the
    proxy, so requests can proceed PII-free — the reference lists redaction
    as future work (types.py:10);
  * credit-card candidates are Luhn-validated to cut false positives.

The analyzer abstraction lets a model-based backend (the reference wraps
Microsoft Presidio) slot in: ``ner:<dir>`` runs a BERT token-classification
checkpoint through the port's encoder on ``--pii-device`` (the card by
default); the regex analyzer is the dependency-free default, as in the
reference. The port's copy of ``production_stack_tpu/router/pii.py``:
everything but ``NERPIIAnalyzer`` and the device it runs on is the JAX
module's.
"""

import asyncio
import enum
import json
import os
import re
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from aiohttp import web

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class PIIAction(enum.Enum):
    BLOCK = "block"
    REDACT = "redact"


class PIIType(enum.Enum):
    EMAIL = "email"
    PHONE = "phone"
    SSN = "ssn"
    CREDIT_CARD = "credit_card"
    IP_ADDRESS = "ip_address"
    API_KEY = "api_key"
    BANK_ACCOUNT = "bank_account"
    IBAN = "iban"
    PASSPORT = "passport"
    DRIVERS_LICENSE = "drivers_license"
    TAX_ID = "tax_id"
    MEDICAL_RECORD = "medical_record"
    MAC_ADDRESS = "mac_address"
    DOB = "date_of_birth"
    PASSWORD = "password"
    SECRET_URL_CRED = "url_credential"
    # entity types only a model can find (NERPIIAnalyzer; the regex
    # analyzer never produces them — names/places have no pattern)
    PERSON = "person"
    LOCATION = "location"
    ORGANIZATION = "organization"


@dataclass
class PIIMatch:
    pii_type: PIIType
    start: int
    end: int
    text: str


@dataclass
class PIIAnalysisResult:
    detected: bool = False
    types: Set[PIIType] = field(default_factory=set)
    matches: List[PIIMatch] = field(default_factory=list)


class PIIAnalyzer(ABC):
    """Analyzer abstraction (reference analyzers/base.py:1-65)."""

    @abstractmethod
    def analyze(self, text: str,
                types: Optional[Set[PIIType]] = None) -> PIIAnalysisResult:
        ...


def _iban_ok(candidate: str) -> bool:
    """ISO 7064 mod-97 check (same false-positive cut as Luhn for cards)."""
    s = candidate[4:] + candidate[:4]
    num = "".join(str(int(c, 36)) for c in s)
    return int(num) % 97 == 1


def _luhn_ok(digits: str) -> bool:
    total, alt = 0, False
    for ch in reversed(digits):
        d = ord(ch) - 48
        if alt:
            d *= 2
            if d > 9:
                d -= 9
        total += d
        alt = not alt
    return total % 10 == 0


def _keyword_id_pattern(keyword: str, lo: int, hi: int) -> str:
    """Keyword-prefixed identifier pattern with two alternatives:
    (a) an explicit separator (:, =, #, or the words number/no) admits an
        any-case token, so "passport no: ab1234567" is caught;
    (b) bare whitespace admits only an UPPERCASE token, so prose like
        "my passport b4monday trip" or "dl 100mbps" never matches.
    Both require at least one digit in the token."""
    return (
        rf"\b(?i:{keyword})\s*(?:(?i:number|no)|#|:|=)+\s*[:=]?\s*"
        rf"(?=[A-Za-z0-9]*\d)[A-Za-z0-9]{{{lo},{hi}}}\b"
        rf"|\b(?i:{keyword})\s+(?=[A-Z0-9]*\d)[A-Z0-9]{{{lo},{hi}}}\b"
    )


class RegexPIIAnalyzer(PIIAnalyzer):
    """Dependency-free pattern analyzer (reference analyzers/regex.py)."""

    PATTERNS: Dict[PIIType, str] = {
        PIIType.EMAIL:
            r"\b[A-Za-z0-9._%+-]+@[A-Za-z0-9.-]+\.[A-Za-z]{2,}\b",
        # classic NANP-style shapes only; the trailing lookahead rejects a
        # fourth digit group so card-number-like runs never match
        PIIType.PHONE:
            r"(?<![\w.)-])(?:\+\d{1,2}[ .-]?)?(?:\(\d{3}\)[ .-]?"
            r"|\d{3}[ .-])\d{3}[ .-]\d{4}(?![ .-]?\d)",
        PIIType.SSN:
            r"\b\d{3}-\d{2}-\d{4}\b",
        PIIType.CREDIT_CARD:
            r"\b\d(?:[ -]?\d){12,18}\b",   # 13-19 digits, ends on a digit
        PIIType.IP_ADDRESS:
            r"\b(?:(?:25[0-5]|2[0-4]\d|1?\d?\d)\.){3}"
            r"(?:25[0-5]|2[0-4]\d|1?\d?\d)\b"
            r"|\b(?:[A-Fa-f0-9]{1,4}:){7}[A-Fa-f0-9]{1,4}\b",
        PIIType.API_KEY:
            r"\b(?:sk|pk|rk)-[A-Za-z0-9_-]{16,}\b"
            r"|\bAKIA[0-9A-Z]{16}\b"
            r"|\bgh[pousr]_[A-Za-z0-9]{20,}\b"
            r"|\bxox[baprs]-[A-Za-z0-9-]{10,}\b",
        PIIType.IBAN:
            r"\b[A-Z]{2}\d{2}[A-Z0-9]{11,30}\b",
        PIIType.BANK_ACCOUNT:
            r"(?i)\b(?:account|acct)\.?\s*(?:number|no|#)?\s*[:=]?\s*"
            r"\d{8,17}\b",
        PIIType.PASSPORT: _keyword_id_pattern("passport", 6, 9),
        PIIType.DRIVERS_LICENSE:
            _keyword_id_pattern(r"driver'?s?\s+licen[cs]e|dl", 5, 13),
        PIIType.TAX_ID:
            r"\b\d{2}-\d{7}\b",
        PIIType.MEDICAL_RECORD:
            _keyword_id_pattern(r"mrn|medical\s+record", 6, 12),
        PIIType.MAC_ADDRESS:
            r"\b(?:[0-9A-Fa-f]{2}[:-]){5}[0-9A-Fa-f]{2}\b",
        PIIType.DOB:
            r"(?i)\b(?:dob|date\s+of\s+birth|born(?:\s+on)?)\s*[:=]?\s*"
            r"\d{1,4}[/-]\d{1,2}[/-]\d{1,4}\b",
        PIIType.PASSWORD:
            r"(?i)\b(?:password|passwd|pwd)\s*[:=]\s*\S{4,}",
        PIIType.SECRET_URL_CRED:
            r"\b[a-z][a-z0-9+.-]*://[^/\s:@]+:[^/\s:@]+@",
    }

    def __init__(self):
        self._compiled = {t: re.compile(p) for t, p in self.PATTERNS.items()}

    def analyze(self, text: str,
                types: Optional[Set[PIIType]] = None) -> PIIAnalysisResult:
        result = PIIAnalysisResult()
        for pii_type, pattern in self._compiled.items():
            if types is not None and pii_type not in types:
                continue
            for m in pattern.finditer(text):
                if pii_type == PIIType.CREDIT_CARD:
                    digits = re.sub(r"\D", "", m.group())
                    if not (13 <= len(digits) <= 19 and _luhn_ok(digits)):
                        continue
                if pii_type == PIIType.IBAN and not _iban_ok(m.group()):
                    continue
                result.detected = True
                result.types.add(pii_type)
                result.matches.append(PIIMatch(pii_type, m.start(), m.end(),
                                               m.group()))
        return result


class NERPIIAnalyzer(PIIAnalyzer):
    """Model-based analyzer: a BERT token-classification checkpoint
    (HF ``BertForTokenClassification`` layout) run through the port's
    encoder (models/encoder.py encode_hidden) with the classifier head
    applied on top, on ``device`` (the card unless the caller asks for
    the CPU): the port of the JAX package's analyzer, the counterpart of
    the reference's Presidio/spaCy analyzer
    (reference src/vllm_router/experimental/pii/analyzers/presidio.py:1-172),
    finding entities regex cannot (names, places, organizations).

    Spec form: ``ner:<checkpoint-dir>``. The dir must hold config.json
    with ``id2label`` (BIO or bare labels: PER/PERSON -> PERSON,
    LOC/GPE -> LOCATION, ORG -> ORGANIZATION; O and unmapped labels are
    ignored), weights (safetensors or .bin, ``bert.*`` + ``classifier.*``),
    and a fast tokenizer (char offsets come from its offset mapping).
    Construction failures RAISE — the operator explicitly configured a
    model; silently scanning with regex instead would be a silent
    security downgrade — and so does ``device="cuda"`` on a machine
    without CUDA: the analyzer never moves to the CPU or to regex on its
    own. The encoder runs in f32 with plain torch ops (the JAX encoder
    reaches no Pallas kernel); the logits are ``hidden.float() @ W.T +
    b`` with the head's W and b kept f32 on the device, as JAX computes
    them. analyze() runs on middleware threads."""

    _LABEL_MAP = {
        "PER": PIIType.PERSON, "PERSON": PIIType.PERSON,
        "LOC": PIIType.LOCATION, "LOCATION": PIIType.LOCATION,
        "GPE": PIIType.LOCATION,
        "ORG": PIIType.ORGANIZATION,
        "ORGANIZATION": PIIType.ORGANIZATION,
    }

    def __init__(self, path: str, device="cuda"):
        import torch

        from production_stack_tpu_torch.models import encoder as enc
        from production_stack_tpu_torch.models import hf_loader
        from production_stack_tpu_torch.utils import resolve_device

        self.device = resolve_device(device)
        with open(os.path.join(path, "config.json")) as f:
            hf_cfg = json.load(f)
        if "id2label" not in hf_cfg:
            raise ValueError(
                f"{path}/config.json has no id2label — not a token-"
                f"classification checkpoint")
        self._id2label = {int(k): v for k, v in hf_cfg["id2label"].items()}
        self._cfg = enc.config_from_hf_json(hf_cfg, name=f"ner:{path}")
        sd = hf_loader.read_state_dict(path)
        self._params = enc.params_from_state_dict(self._cfg, sd,
                                                  device=self.device)
        self._head_w = torch.as_tensor(sd["classifier.weight"]).to(
            self.device, torch.float32)                 # [num_labels, H]
        self._head_b = torch.as_tensor(sd["classifier.bias"]).to(
            self.device, torch.float32)
        from transformers import AutoTokenizer
        self._tok = AutoTokenizer.from_pretrained(path)
        if not getattr(self._tok, "is_fast", False):
            raise ValueError(
                f"tokenizer at {path} is not a fast tokenizer; the NER "
                f"analyzer needs offset mappings for span extraction")
        self._fn = self._logits

    def _logits(self, tokens, lengths):
        """tokens [N, T] int32 and lengths [N] (host arrays) -> f32
        logits [N, T, num_labels] on the device."""
        import torch

        from production_stack_tpu_torch.models import encoder as enc
        with torch.no_grad():
            t = torch.as_tensor(tokens, dtype=torch.long).to(self.device)
            n = torch.as_tensor(lengths, dtype=torch.long).to(self.device)
            h = enc.encode_hidden(self._params, self._cfg, t, n)
            return h.float() @ self._head_w.T + self._head_b

    def logits(self, text: str):
        """(f32 logits [n, num_labels] of ``text``'s n tokens as a host
        array, their char offsets)."""
        import numpy as _np
        enc_out = self._tok(
            text, return_offsets_mapping=True, truncation=True,
            max_length=self._cfg.max_position_embeddings,
            return_attention_mask=False)
        ids = enc_out["input_ids"]
        offsets = enc_out["offset_mapping"]
        if not ids:
            return _np.zeros((0, len(self._id2label)), _np.float32), []
        # pad to the JAX analyzer's power-of-two length buckets: its jit
        # compiles one executable a bucket, and the same padded shapes
        # here give the reference's logits and bound the shapes the
        # device sees. Padding is masked out of attention by `lengths`
        # (encode_hidden) and never enters the offsets loop.
        n = len(ids)
        bucket = min(max(16, 1 << (n - 1).bit_length()),
                     self._cfg.max_position_embeddings)
        toks = _np.zeros((1, bucket), _np.int32)
        toks[0, :n] = ids
        out = self._fn(toks, _np.asarray([n], _np.int32))
        return _np.asarray(out.cpu())[0, :n], offsets

    def analyze(self, text: str,
                types: Optional[Set[PIIType]] = None) -> PIIAnalysisResult:
        return self.decode(text, *self.logits(text), types)

    def decode(self, text: str, logits, offsets,
               types: Optional[Set[PIIType]] = None) -> PIIAnalysisResult:
        """The matches of ``text`` from its token logits and offsets
        (``logits``)."""
        result = PIIAnalysisResult()
        if not offsets:
            return result
        labels = logits.argmax(-1)
        # BIO decode into char spans: I- (or bare-label) tokens extend
        # the running entity; a B- token always STARTS a new one, so
        # adjacent same-type entities ("alice smith bob jones" as
        # B-PER I-PER B-PER I-PER) stay two matches. Special tokens
        # ([CLS]/[SEP]) carry (0, 0) offsets and break merges.
        cur_type, cur_start, cur_end = None, 0, 0

        def flush():
            if cur_type is not None and cur_end > cur_start:
                if types is None or cur_type in types:
                    result.detected = True
                    result.types.add(cur_type)
                    result.matches.append(PIIMatch(
                        cur_type, cur_start, cur_end,
                        text[cur_start:cur_end]))

        for i, (a, b) in enumerate(offsets):
            label = self._id2label.get(int(labels[i]), "O")
            kind = self._LABEL_MAP.get(label.split("-", 1)[-1])
            if a == b or kind is None:      # special/pad token or O
                flush()
                cur_type = None
                continue
            begins = label.startswith("B-")
            if not begins and kind is cur_type and a <= cur_end + 1:
                cur_end = b                  # extend (wordpiece / space)
            else:
                flush()
                cur_type, cur_start, cur_end = kind, a, b
        flush()
        return result


def make_analyzer(spec: str = "regex", device="cuda") -> PIIAnalyzer:
    if spec == "regex":
        return RegexPIIAnalyzer()
    if spec.startswith("ner:"):
        return NERPIIAnalyzer(spec[len("ner:"):], device=device)
    raise ValueError(f"unknown PII analyzer {spec!r} (available: regex, "
                     f"ner:<token-classification checkpoint dir>)")


# ---------------------------------------------------------------- config


@dataclass
class PIIConfig:
    """Reference config surface (pii/config.py): analyzer, action, types;
    and the device a model analyzer runs on."""
    analyzer: str = "regex"
    action: PIIAction = PIIAction.BLOCK
    types: Optional[Set[PIIType]] = None     # None = all
    device: str = "cuda"

    @classmethod
    def from_args(cls, analyzer: str, action: str,
                  types_csv: Optional[str],
                  device: str = "cuda") -> "PIIConfig":
        types = None
        if types_csv:
            types = {PIIType(t.strip()) for t in types_csv.split(",")
                     if t.strip()}
        return cls(analyzer=analyzer, action=PIIAction(action), types=types,
                   device=device)


# ---------------------------------------------------------------- middleware


def _extract_texts(body: dict) -> List[Tuple[str, object]]:
    """(text, setter-path) pairs from the OpenAI body fields that carry
    user text: chat message content (string or multimodal content-part
    list), `prompt`, `input`."""
    out = []
    messages = body.get("messages")
    if isinstance(messages, list):
        for i, m in enumerate(messages):
            if not isinstance(m, dict):
                continue
            content = m.get("content")
            if isinstance(content, str):
                out.append((content, ("messages", i)))
            elif isinstance(content, list):   # multimodal content parts
                for j, part in enumerate(content):
                    if isinstance(part, dict) and \
                            isinstance(part.get("text"), str):
                        out.append((part["text"], ("messages", i, j)))
    for key in ("prompt", "input"):
        val = body.get(key)
        if isinstance(val, str):
            out.append((val, (key,)))
        elif isinstance(val, list):
            for i, item in enumerate(val):
                if isinstance(item, str):
                    out.append((item, (key, i)))
    return out


def _apply_redaction(body: dict, path, redacted_text: str) -> None:
    if path[0] == "messages":
        if len(path) == 3:   # multimodal content part
            body["messages"][path[1]]["content"][path[2]]["text"] = \
                redacted_text
        else:
            body["messages"][path[1]]["content"] = redacted_text
    elif len(path) == 1:
        body[path[0]] = redacted_text
    else:
        body[path[0]][path[1]] = redacted_text


def redact(text: str, matches: List[PIIMatch]) -> str:
    """Replace matched spans with [REDACTED:<type>] tags.

    Overlapping matches from different patterns (e.g. a card number inside
    an 'account number: …' span) are merged first — offsets were computed
    on the original string, so replacements must never nest."""
    merged: List[PIIMatch] = []
    for m in sorted(matches, key=lambda m: (m.start, -m.end)):
        if merged and m.start < merged[-1].end:
            if m.end > merged[-1].end:   # extend the covering span
                prev = merged[-1]
                merged[-1] = PIIMatch(prev.pii_type, prev.start, m.end,
                                      text[prev.start:m.end])
            continue
        merged.append(m)
    for m in reversed(merged):
        text = (text[:m.start] + f"[REDACTED:{m.pii_type.value}]"
                + text[m.end:])
    return text


PII_SCAN_PATHS = ("/v1/chat/completions", "/v1/completions",
                  "/v1/embeddings")


class PIIMiddleware:
    """Scans request bodies; blocks (400) or redacts before proxying.

    Conservative on errors: an analyzer failure blocks the request rather
    than letting unscanned text through (reference middleware.py:99-103).
    The redacted body is stashed on the request for the proxy to forward
    (aiohttp requests are read-once, so the original body stays intact
    for non-scanned paths).
    """

    def __init__(self, config: PIIConfig):
        self.config = config
        self.analyzer = make_analyzer(config.analyzer, device=config.device)
        self.scanned = 0
        self.blocked = 0
        self.redacted = 0

    def _scan(self, body: dict):
        """Analyze (and under REDACT, mutate) the body. Pure CPU work —
        called via run_in_executor so multi-MB prompts never stall the
        event loop (same treatment as the semantic cache's embed)."""
        detected_types: Set[PIIType] = set()
        mutated = False
        for text, path in _extract_texts(body):
            result = self.analyzer.analyze(text, self.config.types)
            if not result.detected:
                continue
            detected_types |= result.types
            if self.config.action == PIIAction.REDACT:
                _apply_redaction(body, path, redact(text, result.matches))
                mutated = True
        return detected_types, mutated

    @web.middleware
    async def middleware(self, request: web.Request, handler):
        if request.method != "POST" or \
                request.path not in PII_SCAN_PATHS:
            return await handler(request)
        try:
            raw = await request.read()
            try:
                body = json.loads(raw) if raw else {}
            except (json.JSONDecodeError, UnicodeDecodeError):
                # malformed client JSON is not an analyzer failure: let
                # the proxy produce its invalid_request_error
                return await handler(request)
            if not isinstance(body, dict):
                return await handler(request)
            self.scanned += 1
            detected_types, mutated = \
                await asyncio.get_running_loop().run_in_executor(
                    None, self._scan, body)
            if detected_types and self.config.action == PIIAction.BLOCK:
                self.blocked += 1
                logger.warning("blocked request with PII: %s",
                               sorted(t.value for t in detected_types))
                return web.json_response(
                    {"error": {
                        "message": "request blocked: detected PII of "
                                   "types "
                                   f"{sorted(t.value for t in detected_types)}",
                        "type": "invalid_request_error",
                        "code": "pii_detected"}}, status=400)
            if mutated:
                self.redacted += 1
                request["pii_sanitized_raw"] = json.dumps(body).encode()
        except web.HTTPException:
            raise
        except Exception as e:
            # conservative: failure to scan blocks the request
            logger.error("PII analysis failed; blocking request: %s", e)
            self.blocked += 1
            return web.json_response(
                {"error": {"message": "PII analysis failed",
                           "type": "server_error",
                           "code": "pii_analysis_error"}}, status=400)
        return await handler(request)
