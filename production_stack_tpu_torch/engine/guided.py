"""Guided decoding: regex/choice/JSON-schema constrained generation
through token DFAs — a copy of ``production_stack_tpu/engine/guided.py``
(numpy only; the port imports nothing of the JAX package).

- A small BYTE-level regex engine compiles the pattern to a DFA
  (Thompson NFA → subset construction → dead-state pruning). Supported
  syntax: literals, ``.``, ``[...]`` classes with ranges/negation,
  ``|``, ``(...)``, ``*`` ``+`` ``?`` ``{m}`` ``{m,n}``, and the
  escapes ``\\d \\w \\s \\D \\W \\S`` plus escaped metacharacters.
  Non-ASCII literals constrain their exact UTF-8 byte sequence.
- The DFA is then lifted from bytes to TOKENS: for every vocab id the
  token's bytes (tokenizer.id_to_token) are walked from every DFA
  state, producing ``token_next [n_states, vocab]`` (−1 = forbidden).
  EOS is allowed exactly in accepting states (self-loop), so a guided
  sequence can only terminate on a complete match.
- The engine stacks the tables of its active patterns into one
  [G, S, V] int32 device tensor (engine.py ``_ensure_guided_table``);
  the decode window (engine/runner.py ``_pick``) carries each row's DFA
  state on the device, masks the logits with one [B, V] gather per
  step and advances the state from the picked id. The engine mirrors
  the states on the host (``CompiledGrammar.next_state``) so a slot
  composition change can re-upload them, like the token and position
  carries.

The lift loops over the vocabulary once per pattern (seconds at 128K
tokens): the server runs it in an executor, off the engine loop, and
compiled grammars are LRU-cached per (pattern, tokenizer).
"""

import functools
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

import numpy as np

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

MAX_DFA_STATES = 512
DEAD = -1

_DIGIT = frozenset(range(ord("0"), ord("9") + 1))
_WORD = frozenset(
    set(range(ord("a"), ord("z") + 1)) | set(range(ord("A"), ord("Z") + 1))
    | _DIGIT | {ord("_")})
_SPACE = frozenset({9, 10, 11, 12, 13, 32})
_ANY = frozenset(range(256))   # '.' matches any byte (incl. newline)


class RegexError(ValueError):
    pass


# --------------------------------------------------------------- parsing
# Grammar: alt := concat ('|' concat)* ; concat := repeat* ;
# repeat := atom ('*'|'+'|'?'|'{m[,n]}')* ; atom := literal | class |
# '(' alt ')' | '.'


class _Parser:
    def __init__(self, pattern: str):
        self.bytes_ = pattern.encode("utf-8")
        self.i = 0

    def peek(self) -> Optional[int]:
        return self.bytes_[self.i] if self.i < len(self.bytes_) else None

    def next(self) -> int:
        b = self.bytes_[self.i]
        self.i += 1
        return b

    def parse(self):
        node = self._alt()
        if self.i != len(self.bytes_):
            raise RegexError(f"unexpected {chr(self.bytes_[self.i])!r} "
                             f"at byte {self.i}")
        return node

    def _alt(self):
        branches = [self._concat()]
        while self.peek() == ord("|"):
            self.next()
            branches.append(self._concat())
        return ("alt", branches) if len(branches) > 1 else branches[0]

    def _concat(self):
        parts = []
        while True:
            c = self.peek()
            if c is None or c in (ord("|"), ord(")")):
                break
            parts.append(self._repeat())
        if not parts:
            return ("eps",)
        return ("cat", parts) if len(parts) > 1 else parts[0]

    def _repeat(self):
        node = self._atom()
        while True:
            c = self.peek()
            if c == ord("*"):
                self.next()
                node = ("star", node)
            elif c == ord("+"):
                self.next()
                node = ("cat", [node, ("star", node)])
            elif c == ord("?"):
                self.next()
                node = ("alt", [node, ("eps",)])
            elif c == ord("{"):
                node = self._bounded(node)
            else:
                return node

    def _bounded(self, node):
        self.next()   # '{'
        lo = self._int()
        hi = lo
        if self.peek() == ord(","):
            self.next()
            hi = self._int() if self.peek() != ord("}") else None
        if self.peek() != ord("}"):
            raise RegexError("unterminated {m,n}")
        self.next()
        if lo > 256 or (hi is not None and (hi < lo or hi > 256)):
            raise RegexError(f"bad repetition bounds {{{lo},{hi}}}: "
                             f"counts are capped at 256")
        parts = [node] * lo
        if hi is None:
            parts.append(("star", node))
        else:
            parts.extend(("alt", [node, ("eps",)]) for _ in range(hi - lo))
        return ("cat", parts) if parts else ("eps",)

    def _int(self) -> int:
        digits = b""
        while self.peek() is not None and self.peek() in _DIGIT:
            digits += bytes([self.next()])
        if not digits:
            raise RegexError("expected integer in {m,n}")
        return int(digits)

    def _atom(self):
        c = self.next() if self.peek() is not None else None
        if c is None:
            raise RegexError("unexpected end of pattern")
        if c == ord("("):
            if self.bytes_[self.i:self.i + 2] == b"?:":
                self.i += 2   # non-capturing group marker: same thing here
            node = self._alt()
            if self.peek() != ord(")"):
                raise RegexError("unbalanced parenthesis")
            self.next()
            return node
        if c == ord("["):
            return ("set", self._class())
        if c == ord("."):
            return ("set", _ANY)
        if c == ord("\\"):
            return ("set", self._escape())
        if c in b"*+?{":
            raise RegexError(f"dangling quantifier {chr(c)!r}")
        if c in b"^$":
            raise RegexError(
                "anchors are implicit: matching is whole-string (a "
                "leading ^ / trailing $ is stripped; mid-pattern "
                "anchors are unsupported)")
        return ("set", frozenset({c}))

    def _escape(self) -> FrozenSet[int]:
        if self.peek() is None:
            raise RegexError("trailing backslash")
        c = self.next()
        table = {ord("d"): _DIGIT, ord("D"): _ANY - _DIGIT,
                 ord("w"): _WORD, ord("W"): _ANY - _WORD,
                 ord("s"): _SPACE, ord("S"): _ANY - _SPACE,
                 ord("n"): frozenset({10}), ord("t"): frozenset({9}),
                 ord("r"): frozenset({13})}
        if c in table:
            return table[c]
        if c in b"bBAZz":
            raise RegexError(
                f"unsupported zero-width escape \\{chr(c)}")
        return frozenset({c})   # escaped literal / metacharacter

    def _class(self) -> FrozenSet[int]:
        negate = False
        if self.peek() == ord("^"):
            self.next()
            negate = True
        members: Set[int] = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                raise RegexError("unterminated character class")
            if c == ord("]") and not first:
                self.next()
                break
            first = False
            c = self.next()
            if c == ord("\\"):
                members |= self._escape()
                continue
            if (self.peek() == ord("-")
                    and self.i + 1 < len(self.bytes_)
                    and self.bytes_[self.i + 1] != ord("]")):
                self.next()   # '-'
                hi = self.next()
                if hi == ord("\\"):
                    raise RegexError("range endpoint cannot be an escape")
                if hi < c:
                    raise RegexError("reversed character range")
                members |= set(range(c, hi + 1))
            else:
                members.add(c)
        return frozenset(_ANY - members if negate else members)


# ------------------------------------------------- NFA -> DFA compilation

def _build_nfa(node, nfa, start: int) -> int:
    """Thompson construction. nfa: {"eps": [set], "edges": [list of
    (byteset, dst)]}; returns the accepting position for `node` hung
    off `start`."""
    kind = node[0]
    if kind == "eps":
        return start
    if kind == "set":
        dst = _new_state(nfa)
        nfa["edges"][start].append((node[1], dst))
        return dst
    if kind == "cat":
        cur = start
        for part in node[1]:
            cur = _build_nfa(part, nfa, cur)
        return cur
    if kind == "alt":
        out = _new_state(nfa)
        for branch in node[1]:
            b_start = _new_state(nfa)
            nfa["eps"][start].add(b_start)
            b_end = _build_nfa(branch, nfa, b_start)
            nfa["eps"][b_end].add(out)
        return out
    if kind == "star":
        hub = _new_state(nfa)
        nfa["eps"][start].add(hub)
        body_start = _new_state(nfa)
        nfa["eps"][hub].add(body_start)
        body_end = _build_nfa(node[1], nfa, body_start)
        nfa["eps"][body_end].add(hub)
        return hub
    raise AssertionError(kind)


def _new_state(nfa) -> int:
    nfa["eps"].append(set())
    nfa["edges"].append([])
    return len(nfa["eps"]) - 1


def _eps_closure(nfa, states: FrozenSet[int]) -> FrozenSet[int]:
    stack, seen = list(states), set(states)
    while stack:
        s = stack.pop()
        for t in nfa["eps"][s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


class ByteDFA:
    """trans [n_states, 256] int32 (DEAD = -1), accept [n_states] bool,
    state 0 = start."""

    def __init__(self, trans: np.ndarray, accept: np.ndarray):
        self.trans = trans
        self.accept = accept

    @property
    def n_states(self) -> int:
        return self.trans.shape[0]

    def matches(self, data: bytes) -> bool:
        s = 0
        for b in data:
            s = int(self.trans[s, b])
            if s == DEAD:
                return False
        return bool(self.accept[s])


def compile_regex(pattern: str) -> ByteDFA:
    """Byte-level regex -> DFA (full-string match semantics). Leading
    ^ / trailing $ are stripped (they are implicit here); anchors
    anywhere else are rejected rather than silently matched as
    literals."""
    if pattern.startswith("^"):
        pattern = pattern[1:]
    if pattern.endswith("$"):
        # the $ is an anchor only if preceded by an EVEN number of
        # backslashes (an odd count escapes it into a literal)
        slashes = len(pattern) - 1 - len(pattern[:-1].rstrip("\\"))
        if slashes % 2 == 0:
            pattern = pattern[:-1]
    nfa = {"eps": [], "edges": []}
    start = _new_state(nfa)
    accept_pos = _build_nfa(_Parser(pattern).parse(), nfa, start)

    d0 = _eps_closure(nfa, frozenset({start}))
    index: Dict[FrozenSet[int], int] = {d0: 0}
    order: List[FrozenSet[int]] = [d0]
    rows: List[np.ndarray] = []
    i = 0
    while i < len(order):
        cur = order[i]
        i += 1
        row = np.full((256,), DEAD, np.int32)
        # group outgoing byte edges
        move: Dict[int, Set[int]] = {}
        for s in cur:
            for byteset, dst in nfa["edges"][s]:
                for b in byteset:
                    move.setdefault(b, set()).add(dst)
        for b, dsts in move.items():
            nxt = _eps_closure(nfa, frozenset(dsts))
            if nxt not in index:
                if len(order) >= MAX_DFA_STATES:
                    raise RegexError(
                        f"pattern needs > {MAX_DFA_STATES} DFA states")
                index[nxt] = len(order)
                order.append(nxt)
            row[b] = index[nxt]
        rows.append(row)
    trans = np.stack(rows)
    accept = np.array([accept_pos in st for st in order], bool)
    if not accept.any():
        raise RegexError("pattern accepts nothing")
    return ByteDFA(trans, accept)


def choice_regex(choices: List[str]) -> str:
    """guided_choice sugar: alternation of escaped literals."""
    if not choices:
        raise RegexError("guided_choice requires at least one choice")
    return "(" + "|".join(_regex_literal(c) for c in choices) + ")"


# ------------------------------------------------ JSON-schema -> regex

# JSON primitive regexes (exact canonical formatting: no insignificant
# whitespace inside values). String content follows RFC 8259: raw
# control bytes (0x00-0x1F) are excluded — the class lists them as
# literal members — and backslash escapes are restricted to the legal
# set, so every accepted string is json.loads-parseable.
_JSON_STRING = ('"([^"\\\\' + "".join(chr(c) for c in range(0x20))
                + ']|\\\\(["\\\\/bfnrt]|u[0-9a-fA-F]{4}))*"')
_JSON_INT = r"-?(0|[1-9]\d*)"
_JSON_NUMBER = _JSON_INT + r"(\.\d+)?([eE][+-]?\d+)?"
_JSON_BOOL = r"(true|false)"
_JSON_NULL = r"null"


def _regex_literal(s: str) -> str:
    out = []
    for ch in s:
        if ch in "\\.[](){}|*+?^$-":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def _json_value_regex(schema, depth: int) -> str:
    if depth > 8:
        raise RegexError("guided_json: schema nesting too deep (>8)")
    if not isinstance(schema, dict):
        raise RegexError("guided_json: each schema node must be an object")
    if "enum" in schema:
        import json as _json
        # enum values render as their canonical JSON literal
        return ("(" + "|".join(
            _regex_literal(_json.dumps(v)) for v in schema["enum"]) + ")")
    t = schema.get("type")
    if t == "string":
        pat = schema.get("pattern")
        if pat is not None:
            # user pattern constrains the string CONTENT (full-match
            # semantics), grouped so alternations cannot escape the
            # quotes. JSON validity of the content (no raw controls /
            # stray backslashes) is the pattern author's contract.
            return '"(' + pat + ')"'
        return _JSON_STRING
    if t == "integer":
        return _JSON_INT
    if t == "number":
        return _JSON_NUMBER
    if t == "boolean":
        return _JSON_BOOL
    if t == "null":
        return _JSON_NULL
    if t == "array":
        item = _json_value_regex(schema.get("items", {"type": "string"}),
                                 depth + 1)
        lo = schema.get("minItems")
        hi = schema.get("maxItems")
        if lo is None and hi is None:
            body = f"({item}(, {item})*)?"
        else:
            lo = int(lo or 0)
            if hi is None:
                # unbounded {m,} is not in the regex subset: emulate
                # with m-1 required copies then *
                tail = (f"(, {item})" * max(lo - 1, 0)
                        + f"(, {item})*")
            else:
                hi = int(hi)
                if hi < lo or hi < 0:
                    raise RegexError("guided_json: bad min/maxItems")
                if hi == 0:
                    return r"\[\]"
                tail = (f"(, {item})" * max(lo - 1, 0)
                        + f"(, {item})?" * (hi - max(lo, 1)))
            body = f"{item}{tail}"
            if lo == 0:
                body = f"({body})?"
        return r"\[" + body + r"\]"
    if t == "object" or "properties" in schema:
        props = schema.get("properties", {})
        if not props:
            raise RegexError(
                "guided_json: object schemas need non-empty 'properties' "
                "(a regex DFA cannot express arbitrary-depth free-form "
                "JSON)")
        import json as _json
        parts = []
        for name, sub in props.items():   # declaration order
            # json.dumps both quotes AND escapes the name (controls,
            # quotes, backslashes), then the result is regex-escaped —
            # same recipe as enum values
            parts.append(_regex_literal(_json.dumps(name)) + ": "
                         + _json_value_regex(sub, depth + 1))
        return r"\{" + ", ".join(parts) + r"\}"
    raise RegexError(f"guided_json: unsupported schema node {schema!r}")


def json_schema_regex(schema) -> str:
    """vLLM's ``guided_json``: compile a JSON-schema subset to a regex
    for the byte-DFA engine. Output is CANONICAL JSON — every declared
    property, in declaration order, separated by ", " with ": " after
    keys and no other insignificant whitespace (DFA-friendly and
    deterministic; the 'required' list is ignored because every
    property is always emitted). Supported nodes: object/properties,
    array (items, minItems/maxItems), string (optional content
    'pattern'), integer, number, boolean, null, enum. Free-form
    objects (no 'properties') are rejected — a finite automaton cannot
    express unbounded-depth JSON."""
    import json as _json
    if isinstance(schema, str):
        schema = _json.loads(schema)
    return _json_value_regex(schema, 0)


# --------------------------------------------------- token-level lifting

class CompiledGrammar:
    """token_next [n_states, vocab] int32: next DFA state after emitting
    a vocab id (DEAD = forbidden). EOS self-loops in accepting states
    and is forbidden elsewhere, so generation can only stop on a
    complete match."""

    def __init__(self, pattern: str, token_next: np.ndarray):
        self.pattern = pattern
        self.token_next = token_next
        self.n_states = token_next.shape[0]

    def next_state(self, state: int, token: int) -> int:
        return int(self.token_next[state, token])


def _token_bytes(tokenizer, vocab: int) -> List[Optional[bytes]]:
    out: List[Optional[bytes]] = []
    for tid in range(vocab):
        try:
            _, raw = tokenizer.id_to_token(tid)
            out.append(bytes(raw))
        except Exception:
            out.append(None)
    return out


@functools.lru_cache(maxsize=64)
def _compile_cached(pattern: str, tok_key: int):
    tokenizer = _TOKENIZERS[tok_key]
    dfa = compile_regex(pattern)
    vocab = tokenizer.vocab_size
    token_next = np.full((dfa.n_states, vocab), DEAD, np.int32)
    # walk every token's bytes from every state, fully vectorized over
    # states: cur [n_states] advances one byte at a time (dead rows
    # stay dead via a guarded gather)
    specials = (set(getattr(tokenizer, "special_token_ids", None) or ())
                | {tokenizer.bos_token_id, tokenizer.pad_token_id})
    eos = tokenizer.eos_token_id
    tok_bytes = _token_bytes(tokenizer, vocab)
    base = np.arange(dfa.n_states, dtype=np.int32)
    for tid in range(vocab):
        if tid == eos:
            token_next[dfa.accept, tid] = base[dfa.accept]
            continue
        raw = tok_bytes[tid]
        if raw is None or len(raw) == 0 or tid in specials:
            continue   # forbidden under guidance
        cur = base.copy()
        for b in raw:
            alive = cur != DEAD
            cur[alive] = dfa.trans[cur[alive], b]
        token_next[:, tid] = cur
    # sanity: every live non-accepting state must have a way forward
    # (otherwise sampling would mask everything); dead-ends become
    # unreachable by forbidding the tokens that lead to them, iterated
    # until no NEW dead-end appears (dead states never come back, so
    # the loop runs at most #dead+1 passes, each one vectorized)
    known_dead: set = set()
    while True:
        has_out = (token_next != DEAD).any(axis=1)
        new_dead = [int(s) for s in np.nonzero(~has_out)[0]
                    if int(s) not in known_dead]
        if not new_dead:
            break
        known_dead.update(new_dead)
        token_next[np.isin(token_next, new_dead)] = DEAD
    if not (token_next[0] != DEAD).any():
        raise RegexError(
            f"pattern {pattern!r} is unsatisfiable with this tokenizer's "
            f"vocabulary")
    return CompiledGrammar(pattern, token_next)


# tokenizer registry keyed by id() so the lru_cache key stays hashable
_TOKENIZERS: Dict[int, object] = {}


def compile_grammar(pattern: str, tokenizer) -> CompiledGrammar:
    key = id(tokenizer)
    _TOKENIZERS[key] = tokenizer
    return _compile_cached(pattern, key)
