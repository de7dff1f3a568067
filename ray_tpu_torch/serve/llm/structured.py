"""Grammar-constrained decoding: spec -> token-level DFA -> allow-masks
(the port's copy of ``ray_tpu/serve/llm/structured.py``).

The host-side half of structured output. It compiles a grammar spec —
JSON mode, a JSON-Schema subset, or a regex subset — into a byte-level
DFA whose per-state token allow-sets are precomputed as a packed
``[S, ceil(V/32)]`` uint32 bitmask table, built once per
``(grammar, vocab, eos)`` and LRU-cached process-wide. Per-request
:class:`FSMCursor` objects then advance on the engine's already-synced
host token ids: the cursors never touch a device tensor, so
constrained decoding adds no device-to-host sync to the engine.

Design constraints:

- **Bytes are tokens.** The serving tokenizer is byte-level (token id
  t < 256 <-> UTF-8 byte t), so the DFA alphabet is
  ``min(256, vocab_size)`` and token ids outside it are never allowed
  by a constrained row.
- **Unconstrained rows are untouched.** The engine stages one packed
  row per batch slot (all-ones for unconstrained rows) into the step's
  ``sample`` inputs when a batch holds a constrained row
  (``ops/sampling.apply_allow_mask`` is the identity on all-ones rows).
- **Unsatisfiable is a client error.** A grammar with no accepting
  path within the vocabulary raises :class:`GrammarError`, a
  ``ValueError`` subclass.
- **EOS is the DFA's terminal.** Accepting states allow ``eos_id``;
  accepting states with no outgoing byte edge are ``must_stop`` and
  the engine completes the stream there exactly like EOS.

Metrics, by the reference's names: ``llm_grammar_compile_seconds`` (the
compile time of a cache miss, on ``obs.clock``) and
``llm_grammar_cache_hit_rate`` (the LRU's lifetime hit rate), in the
port's registry (``util/metrics.py``); ``cache_stats()`` gives the counts.
"""
from __future__ import annotations

import json
import logging
import threading
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from ray_tpu_torch.serve.llm import obs
from ray_tpu_torch.util import metrics

logger = logging.getLogger("ray_tpu_torch.serve.llm")

# Compile-time caps: DFA state blowup and {m,n} repetition expansion
# both raise GrammarError rather than wedging the submit path.
_DFA_STATE_CAP = 4096
_NFA_STATE_CAP = 200_000
_REP_CAP = 512
_JSON_DEPTH = 3

GRAMMAR_COMPILE_BUCKETS = (
    0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0,
)


def compile_seconds_histogram() -> metrics.Histogram:
    return metrics.histogram(
        "llm_grammar_compile_seconds",
        "Wall time to compile one grammar spec into a token DFA "
        "(cache misses only; hits are O(1))",
        boundaries=GRAMMAR_COMPILE_BUCKETS,
    )


def cache_hit_gauge() -> metrics.Gauge:
    return metrics.gauge(
        "llm_grammar_cache_hit_rate",
        "Lifetime hit rate of the process-wide (grammar, vocab, eos) "
        "-> token-DFA LRU cache",
    )


class GrammarError(ValueError):
    """Invalid, unsupported, or unsatisfiable grammar spec.

    Subclasses ``ValueError`` so the serving proxies map it to a
    client error (HTTP 400 / gRPC INVALID_ARGUMENT), not a 500: a bad
    grammar is the request's fault, and must not trigger failover.
    """


@dataclass(frozen=True)
class GrammarSpec:
    """Canonical grammar spec: ``kind`` in {json, json_schema, regex},
    ``text`` the canonical payload (empty for JSON mode, the
    declaration-order ``json.dumps`` of the schema, or the regex
    pattern). Hashable and picklable — it rides inside
    ``SamplingParams`` across the handle/replica boundary, and is the
    grammar half of the DFA cache key."""

    kind: str
    text: str = ""


def parse_response_format(value) -> GrammarSpec | None:
    """Normalize a ``response_format=`` payload into a GrammarSpec.

    Accepts ``None`` (unconstrained), the strings ``"json"`` /
    ``"json_object"``, a ``GrammarSpec``, or a dict in the OpenAI
    shapes::

        {"type": "json_object"}
        {"type": "json_schema", "json_schema": {"schema": {...}}}
        {"type": "json_schema", "schema": {...}}
        {"type": "regex", "pattern": "..."}

    Anything else raises :class:`GrammarError`.
    """
    if value is None:
        return None
    if isinstance(value, GrammarSpec):
        if value.kind not in ("json", "json_schema", "regex"):
            raise GrammarError(
                f"unknown grammar kind {value.kind!r}; expected "
                "json, json_schema or regex"
            )
        return value
    if isinstance(value, str):
        if value in ("json", "json_object"):
            return GrammarSpec(kind="json")
        raise GrammarError(
            f"unknown response_format {value!r}; expected 'json' or "
            "'json_object'"
        )
    if isinstance(value, dict):
        kind = value.get("type")
        if kind in ("json", "json_object"):
            return GrammarSpec(kind="json")
        if kind == "json_schema":
            schema = value.get("schema")
            if schema is None:
                wrapper = value.get("json_schema")
                if isinstance(wrapper, dict):
                    schema = wrapper.get("schema")
            if not isinstance(schema, dict):
                raise GrammarError(
                    "response_format type 'json_schema' needs a dict "
                    "schema under 'schema' or 'json_schema.schema'"
                )
            # NOT sort_keys: property order is the emission order, so
            # it is semantically part of the grammar (and the cache key)
            return GrammarSpec(
                kind="json_schema",
                text=json.dumps(schema, separators=(",", ":")),
            )
        if kind == "regex":
            pattern = value.get("pattern", value.get("regex"))
            if not isinstance(pattern, str) or not pattern:
                raise GrammarError(
                    "response_format type 'regex' needs a non-empty "
                    "string 'pattern'"
                )
            return GrammarSpec(kind="regex", text=pattern)
        raise GrammarError(
            f"unknown response_format type {kind!r}; expected "
            "json, json_object, json_schema or regex"
        )
    raise GrammarError(
        f"response_format must be None, str, dict or GrammarSpec, "
        f"got {type(value).__name__}"
    )


# ---------------------------------------------------------------------------
# Regex subset -> AST
#
# Supported: literals (UTF-8, multi-byte chars become byte sequences),
# escapes (\d \D \w \W \s \S \n \r \t \f \v \0 \xHH and escaped
# punctuation), char classes [...] with ranges and ^-negation, ``.``
# (any byte but \n), (?:...) / (...) grouping, ``|`` alternation, and
# the quantifiers * + ? {m} {m,} {m,n}. Anchors, backrefs, lookaround
# and lazy quantifiers are rejected — the output must be a DFA.
# ---------------------------------------------------------------------------

def _byteset() -> np.ndarray:
    return np.zeros(256, dtype=bool)


def _class_escape(c: str) -> np.ndarray:
    """Byteset for a class-style escape letter, or raise."""
    bs = _byteset()
    if c == "d":
        bs[0x30:0x3A] = True
    elif c == "D":
        bs[:] = True
        bs[0x30:0x3A] = False
    elif c == "w":
        bs[0x30:0x3A] = True
        bs[0x41:0x5B] = True
        bs[0x5F] = True
        bs[0x61:0x7B] = True
    elif c == "W":
        bs[:] = True
        bs[0x30:0x3A] = False
        bs[0x41:0x5B] = False
        bs[0x5F] = False
        bs[0x61:0x7B] = False
    elif c == "s":
        for b in (0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x0B):
            bs[b] = True
    elif c == "S":
        bs[:] = True
        for b in (0x20, 0x09, 0x0A, 0x0D, 0x0C, 0x0B):
            bs[b] = False
    else:
        raise GrammarError(f"unsupported escape \\{c}")
    return bs


_CTRL_ESCAPES = {
    "n": 0x0A, "r": 0x0D, "t": 0x09, "f": 0x0C, "v": 0x0B, "0": 0x00,
}


class _Parser:
    """Recursive-descent parser for the regex subset. Produces an AST
    of tuples: ``("lit", byteset)``, ``("cat", [..])``,
    ``("alt", [..])``, ``("rep", node, m, n_or_None)``."""

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise GrammarError(
                f"unexpected {self.p[self.i]!r} at index {self.i}"
            )
        return node

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def _alt(self):
        parts = [self._cat()]
        while self._peek() == "|":
            self.i += 1
            parts.append(self._cat())
        return parts[0] if len(parts) == 1 else ("alt", parts)

    def _cat(self):
        parts = []
        while True:
            c = self._peek()
            if c is None or c in "|)":
                break
            parts.append(self._repeat())
        if len(parts) == 1:
            return parts[0]
        return ("cat", parts)

    def _repeat(self):
        node = self._atom()
        while True:
            c = self._peek()
            if c == "*":
                self.i += 1
                node = ("rep", node, 0, None)
            elif c == "+":
                self.i += 1
                node = ("rep", node, 1, None)
            elif c == "?":
                self.i += 1
                node = ("rep", node, 0, 1)
            elif c == "{":
                node = self._braced(node)
            else:
                return node

    def _braced(self, node):
        j = self.p.find("}", self.i)
        if j < 0:
            raise GrammarError("unterminated {m,n} quantifier")
        body = self.p[self.i + 1 : j]
        self.i = j + 1
        try:
            if "," in body:
                lo, hi = body.split(",", 1)
                m = int(lo) if lo.strip() else 0
                n = int(hi) if hi.strip() else None
            else:
                m = n = int(body)
        except ValueError as e:
            raise GrammarError(f"bad quantifier {{{body}}}") from e
        if m < 0 or (n is not None and n < m):
            raise GrammarError(f"bad quantifier {{{body}}}")
        if m > _REP_CAP or (n is not None and n > _REP_CAP):
            raise GrammarError(
                f"quantifier {{{body}}} exceeds repetition cap {_REP_CAP}"
            )
        return ("rep", node, m, n)

    def _atom(self):
        c = self.p[self.i]
        if c == "(":
            self.i += 1
            if self.p.startswith("?:", self.i):
                self.i += 2
            elif self._peek() == "?":
                raise GrammarError(
                    "only (?:...) groups are supported (no lookaround "
                    "or flags)"
                )
            node = self._alt()
            if self._peek() != ")":
                raise GrammarError("unbalanced '('")
            self.i += 1
            return node
        if c == "[":
            return ("lit", self._class())
        if c == ".":
            self.i += 1
            bs = _byteset()
            bs[:] = True
            bs[0x0A] = False
            return ("lit", bs)
        if c == "\\":
            return self._escape_atom()
        if c in "*+?{":
            raise GrammarError(f"dangling quantifier {c!r}")
        if c in "^$":
            raise GrammarError(f"anchors ({c!r}) are not supported")
        self.i += 1
        return self._char_node(c)

    def _char_node(self, c: str):
        enc = c.encode("utf-8")
        if len(enc) == 1:
            bs = _byteset()
            bs[enc[0]] = True
            return ("lit", bs)
        parts = []
        for b in enc:
            bs = _byteset()
            bs[b] = True
            parts.append(("lit", bs))
        return ("cat", parts)

    def _escape_atom(self):
        self.i += 1  # consume backslash
        if self.i >= len(self.p):
            raise GrammarError("dangling backslash")
        c = self.p[self.i]
        self.i += 1
        if c in "dDwWsS":
            return ("lit", _class_escape(c))
        if c in _CTRL_ESCAPES:
            bs = _byteset()
            bs[_CTRL_ESCAPES[c]] = True
            return ("lit", bs)
        if c == "x":
            hx = self.p[self.i : self.i + 2]
            if len(hx) != 2:
                raise GrammarError("truncated \\xHH escape")
            try:
                b = int(hx, 16)
            except ValueError as e:
                raise GrammarError(f"bad \\x{hx} escape") from e
            self.i += 2
            bs = _byteset()
            bs[b] = True
            return ("lit", bs)
        if c.isalnum():
            raise GrammarError(f"unsupported escape \\{c}")
        return self._char_node(c)

    def _class_member(self) -> tuple[np.ndarray, int | None]:
        """One class member: (byteset, single_byte_or_None). Ranges
        need the single-byte form on both ends."""
        c = self.p[self.i]
        if c == "\\":
            self.i += 1
            if self.i >= len(self.p):
                raise GrammarError("dangling backslash in class")
            e = self.p[self.i]
            self.i += 1
            if e in "dDwWsS":
                return _class_escape(e), None
            if e in _CTRL_ESCAPES:
                b = _CTRL_ESCAPES[e]
                bs = _byteset()
                bs[b] = True
                return bs, b
            if e == "x":
                hx = self.p[self.i : self.i + 2]
                if len(hx) != 2:
                    raise GrammarError("truncated \\xHH escape in class")
                try:
                    b = int(hx, 16)
                except ValueError as ex:
                    raise GrammarError(f"bad \\x{hx} escape") from ex
                self.i += 2
                bs = _byteset()
                bs[b] = True
                return bs, b
            if e.isalnum():
                raise GrammarError(f"unsupported escape \\{e} in class")
            c = e
        else:
            self.i += 1
        enc = c.encode("utf-8")
        if len(enc) != 1:
            raise GrammarError(
                f"non-ASCII char {c!r} in class (byte-level alphabet)"
            )
        bs = _byteset()
        bs[enc[0]] = True
        return bs, enc[0]

    def _class(self) -> np.ndarray:
        self.i += 1  # consume '['
        negate = False
        if self._peek() == "^":
            negate = True
            self.i += 1
        acc = _byteset()
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise GrammarError("unterminated character class")
            if c == "]" and not first:
                self.i += 1
                break
            first = False
            bs, lo = self._class_member()
            if (
                lo is not None
                and self._peek() == "-"
                and self.i + 1 < len(self.p)
                and self.p[self.i + 1] != "]"
            ):
                self.i += 1  # consume '-'
                _, hi = self._class_member()
                if hi is None or hi < lo:
                    raise GrammarError("bad range in character class")
                acc[lo : hi + 1] = True
            else:
                acc |= bs
        if negate:
            acc = ~acc
        if not acc.any():
            raise GrammarError("empty character class")
        return acc


# ---------------------------------------------------------------------------
# AST -> Thompson NFA -> subset-construction DFA
# ---------------------------------------------------------------------------

class _NFA:
    def __init__(self):
        self.eps: list[list[int]] = []
        self.edges: list[list[tuple[np.ndarray, int]]] = []

    def new(self) -> int:
        if len(self.eps) >= _NFA_STATE_CAP:
            raise GrammarError(
                f"grammar too large: NFA exceeds {_NFA_STATE_CAP} states"
            )
        self.eps.append([])
        self.edges.append([])
        return len(self.eps) - 1


def _build_nfa(node, nfa: _NFA) -> tuple[int, int]:
    tag = node[0]
    if tag == "lit":
        s = nfa.new()
        e = nfa.new()
        nfa.edges[s].append((node[1], e))
        return s, e
    if tag == "cat":
        if not node[1]:
            s = nfa.new()
            return s, s
        s, e = _build_nfa(node[1][0], nfa)
        for sub in node[1][1:]:
            s2, e2 = _build_nfa(sub, nfa)
            nfa.eps[e].append(s2)
            e = e2
        return s, e
    if tag == "alt":
        s = nfa.new()
        e = nfa.new()
        for sub in node[1]:
            s2, e2 = _build_nfa(sub, nfa)
            nfa.eps[s].append(s2)
            nfa.eps[e2].append(e)
        return s, e
    if tag == "rep":
        _, sub, m, n = node
        s = nfa.new()
        cur = s
        for _ in range(m):
            s2, e2 = _build_nfa(sub, nfa)
            nfa.eps[cur].append(s2)
            cur = e2
        end = nfa.new()
        if n is None:
            s2, e2 = _build_nfa(sub, nfa)
            nfa.eps[cur].append(s2)
            nfa.eps[cur].append(end)
            nfa.eps[e2].append(s2)
            nfa.eps[e2].append(end)
        else:
            nfa.eps[cur].append(end)
            for _ in range(n - m):
                s2, e2 = _build_nfa(sub, nfa)
                nfa.eps[cur].append(s2)
                cur = e2
                nfa.eps[cur].append(end)
        return s, end
    raise GrammarError(f"internal: unknown AST node {tag!r}")


def _closure(nfa: _NFA, states) -> frozenset:
    seen = set(states)
    stack = list(states)
    while stack:
        s = stack.pop()
        for t in nfa.eps[s]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def _subset_construct(
    nfa: _NFA, start: int, accept_nfa: int, alphabet: int
) -> tuple[np.ndarray, np.ndarray]:
    """NFA -> DFA over bytes ``[0, alphabet)``. Returns
    ``(trans [S,256] int32 with -1 = reject, accept [S] bool)``."""
    start_set = _closure(nfa, [start])
    index: dict[frozenset, int] = {start_set: 0}
    order = [start_set]
    rows: list[np.ndarray] = []
    i = 0
    while i < len(order):
        dstate = order[i]
        i += 1
        row = np.full(256, -1, dtype=np.int32)
        edge_sets: list[np.ndarray] = []
        edge_targets: list[int] = []
        for s in dstate:
            for bs, t in nfa.edges[s]:
                edge_sets.append(bs)
                edge_targets.append(t)
        if edge_sets:
            m = np.zeros((len(edge_sets), 256), dtype=bool)
            for j, bs in enumerate(edge_sets):
                m[j] = bs
            m[:, alphabet:] = False
            # group the 256 byte columns into equivalence classes so
            # the closure work is O(#classes), not O(256)
            cols = np.packbits(m, axis=0)
            _, inv = np.unique(cols, axis=1, return_inverse=True)
            inv = inv.reshape(-1)
            for u in range(int(inv.max()) + 1):
                class_bytes = np.nonzero(inv == u)[0]
                b0 = int(class_bytes[0])
                active = [
                    edge_targets[j]
                    for j in range(len(edge_sets))
                    if m[j, b0]
                ]
                if not active:
                    continue
                tset = _closure(nfa, active)
                nxt = index.get(tset)
                if nxt is None:
                    if len(order) >= _DFA_STATE_CAP:
                        raise GrammarError(
                            "grammar too large: DFA exceeds "
                            f"{_DFA_STATE_CAP} states"
                        )
                    nxt = len(order)
                    index[tset] = nxt
                    order.append(tset)
                row[class_bytes] = nxt
        rows.append(row)
    S = len(order)
    trans = np.zeros((S, 256), dtype=np.int32)
    for k, row in enumerate(rows):
        trans[k] = row
    accept = np.zeros(S, dtype=bool)
    for k, dstate in enumerate(order):
        accept[k] = accept_nfa in dstate
    return trans, accept


def _trim(trans: np.ndarray, accept: np.ndarray):
    """Drop states that cannot reach an accepting state (their rows
    would stage all-banned masks); raise if the start state is one —
    that grammar is unsatisfiable within the vocabulary."""
    S = trans.shape[0]
    radj: list[list[int]] = [[] for _ in range(S)]
    for s in range(S):
        for t in set(int(x) for x in trans[s] if x >= 0):
            radj[t].append(s)
    co = set(int(x) for x in np.nonzero(accept)[0])
    stack = list(co)
    while stack:
        t = stack.pop()
        for s in radj[t]:
            if s not in co:
                co.add(s)
                stack.append(s)
    if 0 not in co:
        raise GrammarError(
            "unsatisfiable grammar: no accepting path exists within "
            "the model's vocabulary"
        )
    keep = sorted(co)
    remap = np.full(S + 1, -1, dtype=np.int32)
    for new, old in enumerate(keep):
        remap[old] = new
    new_trans = remap[trans[keep]]  # trans == -1 hits remap[-1] == -1
    new_accept = accept[keep]
    return new_trans, new_accept


# ---------------------------------------------------------------------------
# JSON mode / JSON-Schema subset -> regex pattern
# ---------------------------------------------------------------------------

# Compact JSON, no inter-token whitespace. Strings are printable ASCII
# minus '"' and '\', plus the single-char escapes (no \uXXXX).
_STR_RE = r'"(?:[\x20-\x21\x23-\x5b\x5d-\x7e]|\\["\\/bfnrt])*"'
_INT_RE = r"-?(?:0|[1-9][0-9]*)"
_NUM_RE = _INT_RE + r"(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?"
_SCHEMA_DEPTH_CAP = 12


def _json_value_regex(depth: int) -> str:
    atoms = ["null", "true", "false", _NUM_RE, _STR_RE]
    if depth > 0:
        inner = _json_value_regex(depth - 1)
        atoms.append(r"\[(?:%s(?:,%s)*)?\]" % (inner, inner))
        atoms.append(
            r"\{(?:%s:%s(?:,%s:%s)*)?\}" % (_STR_RE, inner, _STR_RE, inner)
        )
    return "(?:" + "|".join(atoms) + ")"


def _json_mode_regex() -> str:
    """JSON mode: one object whose values nest up to _JSON_DEPTH deep
    (matching ``{"type": "json_object"}`` semantics)."""
    inner = _json_value_regex(_JSON_DEPTH - 1)
    return r"\{(?:%s:%s(?:,%s:%s)*)?\}" % (_STR_RE, inner, _STR_RE, inner)


def _lit_regex(text: str) -> str:
    out = []
    for c in text:
        if c.isalnum():
            out.append(c)
        else:
            out.append("\\" + c)
    return "".join(out)


def _schema_regex(schema, depth: int = 0) -> str:
    """JSON-Schema subset -> regex. Objects emit their declared
    properties in order, all required; supported keywords: type
    (object/array/string/integer/number/boolean/null), properties,
    items, minItems/maxItems, enum, const, anyOf/oneOf."""
    if depth > _SCHEMA_DEPTH_CAP:
        raise GrammarError(
            f"schema nesting exceeds depth cap {_SCHEMA_DEPTH_CAP}"
        )
    if not isinstance(schema, dict):
        raise GrammarError(
            f"schema must be a dict, got {type(schema).__name__}"
        )
    if "const" in schema:
        return _lit_regex(json.dumps(schema["const"], separators=(",", ":")))
    if "enum" in schema:
        vals = schema["enum"]
        if not isinstance(vals, list) or not vals:
            raise GrammarError("'enum' must be a non-empty list")
        return "(?:" + "|".join(
            _lit_regex(json.dumps(v, separators=(",", ":"))) for v in vals
        ) + ")"
    for combo in ("anyOf", "oneOf"):
        if combo in schema:
            subs = schema[combo]
            if not isinstance(subs, list) or not subs:
                raise GrammarError(f"{combo!r} must be a non-empty list")
            return "(?:" + "|".join(
                _schema_regex(s, depth + 1) for s in subs
            ) + ")"
    t = schema.get("type")
    if t == "object":
        props = schema.get("properties", {})
        if not isinstance(props, dict):
            raise GrammarError("'properties' must be a dict")
        if not props:
            return r"\{\}"
        fields = [
            '\\"%s\\":%s'
            % (_escape_json_string(k), _schema_regex(v, depth + 1))
            for k, v in props.items()
        ]
        return r"\{" + ",".join(fields) + r"\}"
    if t == "array":
        items = schema.get("items")
        if items is None:
            raise GrammarError("array schema needs 'items'")
        item = _schema_regex(items, depth + 1)
        lo = schema.get("minItems", 0)
        hi = schema.get("maxItems", max(int(lo), 1) + 2)
        if not (isinstance(lo, int) and isinstance(hi, int)) or lo < 0:
            raise GrammarError("minItems/maxItems must be ints >= 0")
        if hi < lo:
            raise GrammarError("maxItems < minItems")
        if hi == 0:
            return r"\[\]"
        if lo == 0:
            return r"\[(?:%s(?:,%s){0,%d})?\]" % (item, item, hi - 1)
        return r"\[%s(?:,%s){%d,%d}\]" % (item, item, lo - 1, hi - 1)
    if t == "string":
        return _STR_RE
    if t == "integer":
        return _INT_RE
    if t == "number":
        return _NUM_RE
    if t == "boolean":
        return "(?:true|false)"
    if t == "null":
        return "null"
    raise GrammarError(f"unsupported schema: {schema!r}")


def _escape_json_string(key: str) -> str:
    """Regex for the *contents* of a JSON object key (between the
    quotes): the key chars, regex-escaped, with JSON-special chars
    rejected (they would need escape-sequence emission)."""
    for c in key:
        if ord(c) < 0x20 or c in ('"', "\\") or ord(c) > 0x7E:
            raise GrammarError(
                f"unsupported character {c!r} in property name {key!r}"
            )
    return _lit_regex(key)


# ---------------------------------------------------------------------------
# Token DFA + per-request cursor
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TokenDFA:
    """A compiled grammar over token ids.

    - ``trans``: ``[S, 256]`` int32; ``trans[s, t]`` is the next state
      on token t, or -1 (reject). Token ids >= 256 always reject.
    - ``accept``: ``[S]`` bool — the byte prefix so far is a complete
      sentence of the grammar.
    - ``mask``: ``[S, ceil(V/32)]`` uint32, little-endian packed (bit
      j of word w = token ``w*32+j``); the per-state allow-set with
      the EOS bit set at accepting states. Rows are staged directly
      into the engine's ``sample=`` scratch.
    - ``allowed_counts``: ``[S]`` int32 popcounts of ``mask`` (for the
      masked-fraction metric, O(1) per step).
    - ``must_stop``: ``[S]`` bool — accepting with no outgoing edge;
      the engine completes the stream there like EOS.
    """

    trans: np.ndarray
    accept: np.ndarray
    mask: np.ndarray
    allowed_counts: np.ndarray
    must_stop: np.ndarray
    vocab_size: int
    eos_id: int | None
    words: int

    @property
    def n_states(self) -> int:
        return int(self.trans.shape[0])


def _token_table(
    trans: np.ndarray,
    accept: np.ndarray,
    vocab_size: int,
    eos_id: int | None,
) -> TokenDFA:
    S = trans.shape[0]
    V = int(vocab_size)
    words = (V + 31) // 32
    limit = min(256, V)
    allow = np.zeros((S, words * 32), dtype=np.uint32)
    allow[:, :limit] = trans[:, :limit] >= 0
    if eos_id is not None and 0 <= eos_id < V:
        allow[accept, eos_id] = 1
    counts = allow.sum(axis=1).astype(np.int32)
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    packed = (
        (allow.reshape(S, words, 32).astype(np.uint64) * weights)
        .sum(axis=2)
        .astype(np.uint32)
    )
    out_any = (trans[:, :limit] >= 0).any(axis=1)
    must_stop = accept & ~out_any
    return TokenDFA(
        trans=trans,
        accept=accept,
        mask=packed,
        allowed_counts=counts,
        must_stop=must_stop,
        vocab_size=V,
        eos_id=eos_id,
        words=words,
    )


class FSMCursor:
    """Per-request position in a TokenDFA. Host-only: advances on the
    already-synced int token ids the engine hands it — never on a
    device tensor — so constrained decoding adds no device->host sync."""

    __slots__ = ("dfa", "state", "dead")

    def __init__(self, dfa: TokenDFA):
        self.dfa = dfa
        self.state = 0
        self.dead = False

    def advance(self, tok: int) -> bool:
        """Consume one emitted token; False = the grammar rejects it
        (the cursor goes dead and the stream must terminate)."""
        if self.dead:
            return False
        if tok < 0 or tok >= self.dfa.trans.shape[1]:
            self.dead = True
            return False
        nxt = int(self.dfa.trans[self.state, tok])
        if nxt < 0:
            self.dead = True
            return False
        self.state = nxt
        return True

    @property
    def must_stop(self) -> bool:
        return bool(self.dfa.must_stop[self.state])

    @property
    def accepting(self) -> bool:
        return bool(self.dfa.accept[self.state])

    def allow_row(self) -> np.ndarray:
        """Packed uint32 ``[words]`` allow-mask for the current state
        (a view into the shared table — copy-on-stage by the engine's
        scratch assignment)."""
        return self.dfa.mask[self.state]

    def masked_fraction(self) -> float:
        """Fraction of the vocab banned at the current state."""
        allowed = float(self.dfa.allowed_counts[self.state])
        return 1.0 - allowed / float(self.dfa.vocab_size)

    def filter_draft(self, tokens) -> list[int]:
        """Longest grammar-valid prefix of a speculative draft from
        the current state (truncating before any EOS — EOS ends the
        stream at emit time, not inside a verify window). The cursor
        itself does not move; committed tokens advance it via
        ``advance`` at the emit path like every other token."""
        dfa = self.dfa
        st = self.state
        out: list[int] = []
        for t in tokens:
            t = int(t)
            if dfa.eos_id is not None and t == dfa.eos_id:
                break
            if t < 0 or t >= dfa.trans.shape[1]:
                break
            nxt = int(dfa.trans[st, t])
            if nxt < 0:
                break
            out.append(t)
            st = nxt
        return out

    def stage_verify_masks(self, out: np.ndarray, draft) -> None:
        """Fill ``out[W, words]`` with per-column allow-masks for a
        verify window: column 0 is the current state's mask, column s
        the mask after consuming ``draft[:s]``. Columns past the draft
        length hold the last simulated state (those positions never
        commit — acceptance stops at the first mismatch)."""
        dfa = self.dfa
        st = self.state
        out[0] = dfa.mask[st]
        for s in range(1, out.shape[0]):
            if s - 1 < len(draft):
                t = int(draft[s - 1])
                if 0 <= t < dfa.trans.shape[1]:
                    nxt = int(dfa.trans[st, t])
                    if nxt >= 0:
                        st = nxt
            out[s] = dfa.mask[st]


# ---------------------------------------------------------------------------
# Compile + process-wide LRU cache
# ---------------------------------------------------------------------------

_CACHE_CAP = 64
_cache: OrderedDict[tuple, TokenDFA] = OrderedDict()
_cache_lock = threading.Lock()
_cache_stats = {"lookups": 0, "hits": 0}


def _compile(spec: GrammarSpec, vocab_size: int, eos_id) -> TokenDFA:
    if spec.kind == "json":
        pattern = _json_mode_regex()
    elif spec.kind == "json_schema":
        pattern = _schema_regex(json.loads(spec.text))
    elif spec.kind == "regex":
        pattern = spec.text
    else:
        raise GrammarError(f"unknown grammar kind {spec.kind!r}")
    ast = _Parser(pattern).parse()
    nfa = _NFA()
    start, end = _build_nfa(ast, nfa)
    alphabet = min(256, int(vocab_size))
    trans, accept = _subset_construct(nfa, start, end, alphabet)
    trans, accept = _trim(trans, accept)
    return _token_table(trans, accept, vocab_size, eos_id)


def cache_stats() -> dict:
    with _cache_lock:
        return {
            "size": len(_cache),
            "lookups": _cache_stats["lookups"],
            "hits": _cache_stats["hits"],
        }


def clear_cache() -> None:
    """Test hook: drop all compiled DFAs (and the hit-rate history)."""
    with _cache_lock:
        _cache.clear()
        _cache_stats["lookups"] = 0
        _cache_stats["hits"] = 0


def compile_grammar(
    spec: GrammarSpec, vocab_size: int, eos_id: int | None = None
) -> TokenDFA:
    """Grammar spec -> TokenDFA, LRU-cached on
    ``(kind, text, vocab_size, eos_id)``.

    Raises :class:`GrammarError` (a ``ValueError``) for invalid,
    unsupported, oversized, or unsatisfiable grammars — the proxies
    map it to a client error; it must never crash the engine or look
    retryable to the handle.
    """
    key = (spec.kind, spec.text, int(vocab_size), eos_id)
    with _cache_lock:
        _cache_stats["lookups"] += 1
        dfa = _cache.get(key)
        if dfa is not None:
            _cache.move_to_end(key)
            _cache_stats["hits"] += 1
            cache_hit_gauge().set(
                _cache_stats["hits"] / _cache_stats["lookups"]
            )
            return dfa
    t0 = obs.clock()
    try:
        dfa = _compile(spec, vocab_size, eos_id)
    except GrammarError:
        raise
    except (ValueError, KeyError, TypeError, RecursionError) as e:
        # degradation path is loud by contract: a compile failure is
        # re-raised as the client-visible GrammarError, never swallowed
        raise GrammarError(f"grammar compile failed: {e!r}") from e
    compile_seconds_histogram().observe(obs.clock() - t0)
    with _cache_lock:
        _cache[key] = dfa
        while len(_cache) > _CACHE_CAP:
            _cache.popitem(last=False)
        cache_hit_gauge().set(
            _cache_stats["hits"] / max(1, _cache_stats["lookups"])
        )
    logger.info(
        "compiled grammar kind=%s states=%d vocab=%d",
        spec.kind, dfa.n_states, int(vocab_size),
    )
    return dfa
