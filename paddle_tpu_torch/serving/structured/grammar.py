"""Grammar-constrained decoding, layer 1: the grammar compiler (the
port's copy of ``paddle_tpu/serving/structured/grammar.py``, kept term
for term so both packages build identical tables; host numpy only).

Compiles a regex (or a practical JSON-schema subset lowered to regex)
into a token-level DFA over the model vocabulary:

    regex --> Thompson NFA (interval-labeled transitions)
          --> subset construction (alphabet-partitioned char DFA)
          --> Moore minimization + co-accessibility pruning
          --> vocab crossproduct: walk every vocab token string through
              the char DFA from every state

The crossproduct emits two device-ready arrays per grammar:

  * a dense ``[num_states, vocab]`` int32 transition table mapping
    (state, token) -> next state, ``REJECT`` (-1) where the token is
    illegal — the *advance* structure;
  * a packed ``[num_states, ceil(vocab/32)]`` uint32 allowed-token
    bitmask — the *mask* structure consumed by ``sample_window``.

The two are views of one relation (``table[s, t] >= 0`` iff mask bit
``t`` of row ``s`` is set); the engine advances states with the dense
table and masks logits with the bitmask, and a unit test pins the
equivalence.

EOS is the grammar's stop contract: the EOS column is legal exactly in
accepting states (where it self-loops — the lane retires on EOS before
the state matters again), so a constrained lane can stop if and only if
its emitted text is a complete sentence of the grammar.  Together with
co-accessibility pruning (every surviving state reaches an accepting
state) and a vocab-reachability check (every token-reachable state
keeps at least one legal token), a constrained lane can never strand:
there is always a legal token, and following legal tokens never reaches
``REJECT``.

``GrammarSlab`` is the host master for the fixed-capacity device slab
the engine uploads: row 0 is the reserved accept-all sentinel that
unconstrained lanes ride (all tokens legal, self-loop), and compiled
grammars install at refcounted offsets >= 1 so grammars of any size
share one device allocation and one decode path.  The slab is
single-owner: only the engine thread that owns the Engine mutates it.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

__all__ = [
    "GrammarError",
    "GrammarSpec",
    "as_grammar_spec",
    "CharDFA",
    "TokenDFA",
    "REJECT",
    "compile_regex",
    "compile_grammar",
    "schema_to_regex",
    "GrammarSlab",
]

#: next-state value for an illegal (state, token) pair in TokenDFA.
REJECT = -1

_MAXCP = 0x10FFFF
#: repetition bounds above this expand the NFA quadratically; refuse.
_MAX_REPEAT = 256
#: JSON-schema lowering recursion cap (bounded nesting by contract).
_MAX_SCHEMA_DEPTH = 16


class GrammarError(ValueError):
    """A grammar the compiler does not accept.

    Raised eagerly at validation/compile time with the unsupported
    construct named in the message — the gateway maps it to a 400
    ``invalid_grammar`` typed error, mirroring ``SamplingParams``
    validation style.
    """


# ---------------------------------------------------------------------------
# character sets: sorted disjoint inclusive codepoint intervals
# ---------------------------------------------------------------------------


def _normalize(ranges):
    rs = sorted((lo, hi) for lo, hi in ranges if lo <= hi)
    out = []
    for lo, hi in rs:
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


def _negate(ranges):
    out, cur = [], 0
    for lo, hi in _normalize(ranges):
        if lo > cur:
            out.append((cur, lo - 1))
        cur = hi + 1
    if cur <= _MAXCP:
        out.append((cur, _MAXCP))
    return tuple(out)


_DIGIT = ((48, 57),)
_WORD = _normalize([(48, 57), (65, 90), (95, 95), (97, 122)])
_SPACE = _normalize([(9, 13), (32, 32)])
_DOT = _negate([(10, 10)])  # any char but newline

_ESCAPE_SETS = {
    "d": _DIGIT, "D": _negate(_DIGIT),
    "w": _WORD, "W": _negate(_WORD),
    "s": _SPACE, "S": _negate(_SPACE),
}
_ESCAPE_CHARS = {"n": "\n", "t": "\t", "r": "\r", "f": "\f", "v": "\v",
                 "0": "\0"}
_HEXDIGITS = frozenset("0123456789abcdefABCDEF")


# ---------------------------------------------------------------------------
# regex parser -> AST
#   ("set", ranges) | ("cat", parts) | ("alt", branches)
#   ("rep", node, min, max_or_None) | ("eps",)
# ---------------------------------------------------------------------------


class _RegexParser:
    def __init__(self, pattern):
        self.p = pattern
        self.i = 0

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else ""

    def _take(self):
        c = self._peek()
        if not c:
            raise GrammarError("regex: unexpected end of pattern")
        self.i += 1
        return c

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise GrammarError(
                f"regex: unexpected {self.p[self.i]!r} at index {self.i}"
                " (unbalanced ')'?)")
        return node

    def _alt(self):
        branches = [self._cat()]
        while self._peek() == "|":
            self.i += 1
            branches.append(self._cat())
        return branches[0] if len(branches) == 1 else \
            ("alt", tuple(branches))

    def _cat(self):
        parts = []
        while self._peek() not in ("", "|", ")"):
            parts.append(self._repeat())
        if not parts:
            return ("eps",)
        return parts[0] if len(parts) == 1 else ("cat", tuple(parts))

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
                node = ("rep", node, *self._bounds())
            else:
                return node

    def _bounds(self):
        j = self.p.find("}", self.i)
        if j < 0:
            raise GrammarError("regex: unescaped '{' (use \\{ for a "
                               "literal brace)")
        body = self.p[self.i + 1:j]
        self.i = j + 1
        lo, _, hi = body.partition(",")
        try:
            m = int(lo)
            mx = m if "," not in body else (int(hi) if hi else None)
        except ValueError:
            raise GrammarError(
                f"regex: malformed repetition bound {{{body}}}") from None
        if m < 0 or (mx is not None and mx < m):
            raise GrammarError(
                f"regex: invalid repetition bound {{{body}}}")
        if m > _MAX_REPEAT or (mx or 0) > _MAX_REPEAT:
            raise GrammarError(
                f"regex: repetition bound {{{body}}} exceeds the "
                f"{_MAX_REPEAT} expansion cap")
        return m, mx

    def _atom(self):
        c = self._take()
        if c == "(":
            if self.p[self.i:self.i + 2] == "?:":
                self.i += 2
            elif self._peek() == "?":
                raise GrammarError(
                    "regex: (?...) groups (lookaround, flags, named "
                    "groups) are not supported; only (?:...) and (...)")
            node = self._alt()
            if self._peek() != ")":
                raise GrammarError("regex: unbalanced '('")
            self.i += 1
            return node
        if c == "[":
            return ("set", self._cls())
        if c == ".":
            return ("set", _DOT)
        if c == "\\":
            return self._escape()
        if c in "*+?{":
            raise GrammarError(f"regex: nothing to repeat before {c!r}")
        if c in "^$":
            raise GrammarError(
                f"regex: anchors ({c!r}) are not supported — the "
                "compiled DFA is full-match by construction")
        return ("set", ((ord(c), ord(c)),))

    def _escape(self):
        c = self._take()
        if c in _ESCAPE_SETS:
            return ("set", _ESCAPE_SETS[c])
        if c in _ESCAPE_CHARS:
            o = ord(_ESCAPE_CHARS[c])
            return ("set", ((o, o),))
        if c in ("x", "u"):
            o = self._hex_escape(c)
            return ("set", ((o, o),))
        if not c.isalnum():
            return ("set", ((ord(c), ord(c)),))
        raise GrammarError(f"regex: unsupported escape \\{c}"
                           " (\\b word boundaries and backreferences "
                           "are not supported)")

    def _hex_escape(self, kind):
        """``\\xHH`` / ``\\uHHHH``: exactly 2/4 hex digits.  ``int(_,
        16)`` alone would accept a truncated escape ('a\\x4', '\\u12')
        — or '+'/'_'-decorated strings — as a shorter codepoint instead
        of raising."""
        n = 2 if kind == "x" else 4
        hexs = self.p[self.i:self.i + n]
        if len(hexs) != n or any(h not in _HEXDIGITS for h in hexs):
            raise GrammarError(
                f"regex: malformed \\{kind} escape (expected exactly "
                f"{n} hex digits, got {hexs!r})")
        self.i += n
        return int(hexs, 16)

    def _cls(self):
        negate = False
        if self._peek() == "^":
            negate = True
            self.i += 1
        ranges = []
        while True:
            c = self._take()
            if c == "]":
                break
            lo = self._cls_cp(c)
            if isinstance(lo, tuple):   # a \d/\w/\s-style set
                ranges.extend(lo)
                continue
            if self._peek() == "-" and self.p[self.i + 1:self.i + 2] \
                    not in ("]", ""):
                self.i += 1
                hi = self._cls_cp(self._take())
                if isinstance(hi, tuple):
                    raise GrammarError(
                        "regex: a character-set escape cannot end a "
                        "range")
                if hi < lo:
                    raise GrammarError(
                        f"regex: bad range {chr(lo)}-{chr(hi)}")
                ranges.append((lo, hi))
            else:
                ranges.append((lo, lo))
        if not ranges:
            raise GrammarError("regex: empty character class []")
        rs = _normalize(ranges)
        return _negate(rs) if negate else rs

    def _cls_cp(self, c):
        """One class item: a codepoint, or a ranges tuple for set
        escapes like ``\\d`` (which cannot bound a range)."""
        if c != "\\":
            return ord(c)
        e = self._take()
        if e in _ESCAPE_SETS:
            return _ESCAPE_SETS[e]
        if e in _ESCAPE_CHARS:
            return ord(_ESCAPE_CHARS[e])
        if e in ("x", "u"):
            return self._hex_escape(e)
        if e == "b":               # backspace inside a class
            return 8
        if not e.isalnum():
            return ord(e)
        raise GrammarError(f"regex: unsupported class escape \\{e}")


# ---------------------------------------------------------------------------
# Thompson NFA
# ---------------------------------------------------------------------------


class _NFA:
    def __init__(self):
        self.n = 0
        self.by_src = {}   # state -> list of (ranges, dst)
        self.eps = {}      # state -> list of dst

    def state(self):
        s = self.n
        self.n += 1
        self.by_src[s] = []
        self.eps[s] = []
        return s

    def edge(self, src, ranges, dst):
        self.by_src[src].append((ranges, dst))

    def epsilon(self, src, dst):
        self.eps[src].append(dst)


def _frag(nfa, node):
    """Thompson-construct ``node``; returns (start, end) states."""
    kind = node[0]
    if kind == "eps":
        s = nfa.state()
        return s, s
    if kind == "set":
        s, e = nfa.state(), nfa.state()
        nfa.edge(s, node[1], e)
        return s, e
    if kind == "cat":
        s, e = _frag(nfa, node[1][0])
        for part in node[1][1:]:
            ps, pe = _frag(nfa, part)
            nfa.epsilon(e, ps)
            e = pe
        return s, e
    if kind == "alt":
        s, e = nfa.state(), nfa.state()
        for br in node[1]:
            bs, be = _frag(nfa, br)
            nfa.epsilon(s, bs)
            nfa.epsilon(be, e)
        return s, e
    if kind == "rep":
        _, sub, m, mx = node
        s = e = nfa.state()
        for _i in range(m):            # mandatory copies, chained
            cs, ce = _frag(nfa, sub)
            nfa.epsilon(e, cs)
            e = ce
        if mx is None:                 # Kleene tail
            cs, ce = _frag(nfa, sub)
            tail = nfa.state()
            nfa.epsilon(e, cs)
            nfa.epsilon(e, tail)
            nfa.epsilon(ce, cs)
            nfa.epsilon(ce, tail)
            return s, tail
        end = nfa.state()
        nfa.epsilon(e, end)            # may stop after the m copies
        for _i in range(mx - m):       # optional copies, each may bail
            cs, ce = _frag(nfa, sub)
            nfa.epsilon(e, cs)
            e = ce
            nfa.epsilon(e, end)
        return s, end
    raise AssertionError(f"unknown AST node {kind}")


# ---------------------------------------------------------------------------
# char-level DFA: subset construction, minimization, pruning
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CharDFA:
    """Minimized, co-accessible character DFA.  State 0 is the start;
    missing transitions are implicit rejection."""

    accepting: frozenset
    trans: tuple    # trans[state] = tuple of (lo, hi, dst), sorted

    @property
    def n_states(self):
        return len(self.trans)

    def step(self, state, cp):
        """Next state for codepoint ``cp``, or ``REJECT``."""
        if state < 0:
            return REJECT
        for lo, hi, dst in self.trans[state]:
            if lo <= cp <= hi:
                return dst
        return REJECT

    def walk(self, state, text):
        for ch in text:
            state = self.step(state, ord(ch))
            if state < 0:
                return REJECT
        return state

    def matches(self, text):
        return self.walk(0, text) in self.accepting


def _closure(nfa, states):
    seen = set(states)
    stack = list(states)
    while stack:
        for t in nfa.eps[stack.pop()]:
            if t not in seen:
                seen.add(t)
                stack.append(t)
    return frozenset(seen)


def _subset(nfa, start, accept):
    start_c = _closure(nfa, {start})
    ids = {start_c: 0}
    order = [start_c]
    trans = {}
    queue = [start_c]
    while queue:
        cur = queue.pop()
        sid = ids[cur]
        edges = [(lo, hi, dst) for src in cur
                 for ranges, dst in nfa.by_src[src]
                 for lo, hi in ranges]
        bounds = sorted({lo for lo, _, _ in edges}
                        | {hi + 1 for _, hi, _ in edges})
        out = []
        for a, b1 in zip(bounds, bounds[1:]):
            tgt = frozenset(d for lo, hi, d in edges if lo <= a <= hi)
            if not tgt:
                continue
            clo = _closure(nfa, tgt)
            if clo not in ids:
                ids[clo] = len(order)
                order.append(clo)
                queue.append(clo)
            out.append((a, b1 - 1, ids[clo]))
        trans[sid] = _merge_runs(sorted(out))
    accepting = {ids[s] for s in order if accept in s}
    return len(order), trans, accepting


def _merge_runs(runs):
    out = []
    for lo, hi, dst in runs:
        if out and out[-1][2] == dst and out[-1][1] + 1 == lo:
            out[-1] = (out[-1][0], hi, dst)
        else:
            out.append((lo, hi, dst))
    return tuple(tuple(r) for r in out)


def _step_runs(runs, cp):
    for lo, hi, dst in runs:
        if lo <= cp <= hi:
            return dst
    return REJECT


def _minimize(n, trans, accepting):
    # global alphabet partition: every state's intervals are unions of
    # these atomic pieces, so one representative codepoint per piece
    # decides equivalence exactly
    bounds = sorted({lo for st in range(n) for lo, _, _ in trans[st]}
                    | {hi + 1 for st in range(n)
                       for _, hi, _ in trans[st]})
    reps = bounds[:-1] if len(bounds) > 1 else []
    part = [1 if s in accepting else 0 for s in range(n)]
    while True:
        sigs = {}
        new = [0] * n
        for s in range(n):
            sig = (part[s], tuple(
                part[d] if (d := _step_runs(trans[s], r)) >= 0 else -1
                for r in reps))
            new[s] = sigs.setdefault(sig, len(sigs))
        if len(sigs) == len(set(part)):
            break
        part = new
    # relabel blocks to contiguous 0..blocks-1: if the loop broke on
    # the first pass (e.g. every state accepting: "(a*)*", "()"), part
    # still holds its seed labels {1}, which are not 0-based
    remap = {}
    part = [remap.setdefault(b, len(remap)) for b in part]
    blocks = len(set(part))
    btrans = {}
    for s in range(n):
        b = part[s]
        if b not in btrans:
            btrans[b] = _merge_runs(
                [(lo, hi, part[d]) for lo, hi, d in trans[s]])
    baccept = {part[s] for s in accepting}
    return blocks, btrans, baccept, part[0]


def _prune_and_renumber(n, trans, accepting, start):
    fwd = {s: {d for _, _, d in trans[s]} for s in range(n)}
    reach = {start}
    stack = [start]
    while stack:
        for d in fwd[stack.pop()]:
            if d not in reach:
                reach.add(d)
                stack.append(d)
    rev = {s: set() for s in range(n)}
    for s in range(n):
        for d in fwd[s]:
            rev[d].add(s)
    coacc = set(a for a in accepting)
    stack = list(coacc)
    while stack:
        for p in rev[stack.pop()]:
            if p not in coacc:
                coacc.add(p)
                stack.append(p)
    keep = reach & coacc
    if start not in keep:
        raise GrammarError("grammar matches no string (empty language)")
    order = [start]  # BFS renumber, start first -> state 0
    ids = {start: 0}
    qi = 0
    while qi < len(order):
        s = order[qi]
        qi += 1
        for _, _, d in trans[s]:
            if d in keep and d not in ids:
                ids[d] = len(order)
                order.append(d)
    new_trans = tuple(
        _merge_runs([(lo, hi, ids[d]) for lo, hi, d in trans[s]
                     if d in keep])
        for s in order)
    new_accept = frozenset(ids[s] for s in accepting if s in keep)
    return CharDFA(accepting=new_accept, trans=new_trans)


def compile_regex(pattern):
    """Compile a regex to a minimized co-accessible :class:`CharDFA`.

    Full-match semantics (no anchors).  Raises :class:`GrammarError`
    naming the unsupported construct for anything outside the dialect:
    literals, escapes (``\\d \\w \\s`` + negations, ``\\n`` etc.,
    ``\\x``/``\\u``), classes with ranges and negation, ``|``, groups,
    ``* + ?`` and bounded ``{m}``/``{m,}``/``{m,n}``, and ``.``.
    """
    ast = _RegexParser(str(pattern)).parse()
    nfa = _NFA()
    s, e = _frag(nfa, ast)
    n, trans, accepting = _subset(nfa, s, e)
    bn, btrans, baccept, bstart = _minimize(n, trans, accepting)
    return _prune_and_renumber(bn, btrans, baccept, bstart)


# ---------------------------------------------------------------------------
# vocab crossproduct: char DFA -> token DFA
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TokenDFA:
    """Token-level DFA over the model vocabulary.  State 0 is the
    start.  ``next_state[s, t] == REJECT`` iff mask bit ``t`` of row
    ``s`` is clear — the dense table advances, the bitmask masks."""

    next_state: np.ndarray   # [S, V] int32, REJECT where illegal
    mask: np.ndarray         # [S, ceil(V/32)] uint32, bit t of word t//32
    accepting: np.ndarray    # [S] bool
    forced: np.ndarray       # [S] int32: the sole legal token, or -1
    popcount: np.ndarray     # [S] int32: number of legal tokens

    @property
    def n_states(self):
        return self.next_state.shape[0]

    @property
    def vocab_size(self):
        return self.next_state.shape[1]

    @property
    def table_bytes(self):
        return (self.next_state.nbytes + self.mask.nbytes
                + self.forced.nbytes)

    def allows(self, state, token):
        return bool((self.mask[state, token // 32]
                     >> np.uint32(token % 32)) & np.uint32(1))

    def step(self, state, token):
        return int(self.next_state[state, token])


def _pack_mask(allowed):
    """[S, V] bool -> [S, ceil(V/32)] uint32, token t = bit t%32 of
    word t//32."""
    s, v = allowed.shape
    words = (v + 31) // 32
    padded = np.zeros((s, words * 32), np.uint32)
    padded[:, :v] = allowed
    return (padded.reshape(s, words, 32)
            << np.arange(32, dtype=np.uint32)).sum(
                axis=2, dtype=np.uint32)


def compile_grammar(grammar, vocab, eos_id, vocab_size=None):
    """Compile ``grammar`` (regex string / schema dict /
    :class:`GrammarSpec`) against ``vocab`` (sequence of token strings,
    index = token id) into a :class:`TokenDFA`.

    ``eos_id`` is mandatory: EOS is legal exactly in accepting states
    (self-loop), which is how a constrained lane stops.  Tokens with
    ids >= ``len(vocab)``, empty token strings, and tokens whose walk
    rejects are illegal.  Raises :class:`GrammarError` if some
    token-reachable state would have no legal token — the vocabulary
    cannot express the grammar and a lane would strand there.
    """
    spec = as_grammar_spec(grammar)
    cdfa = compile_regex(spec.pattern)
    v = int(vocab_size if vocab_size is not None else len(vocab))
    if not 0 <= int(eos_id) < v:
        raise GrammarError(
            f"eos_id {eos_id} outside vocab of size {v}")
    s_n = cdfa.n_states
    nxt = np.full((s_n, v), REJECT, np.int32)
    for t, text in enumerate(vocab[:v]):
        if t == eos_id or not text:
            continue
        for s in range(s_n):
            d = cdfa.walk(s, text)
            if d >= 0:
                nxt[s, t] = d
    accepting = np.zeros(s_n, bool)
    accepting[list(cdfa.accepting)] = True
    nxt[accepting, int(eos_id)] = np.nonzero(accepting)[0]
    allowed = nxt >= 0
    pop = allowed.sum(axis=1).astype(np.int32)
    forced = np.where(pop == 1, allowed.argmax(axis=1), -1)
    forced = forced.astype(np.int32)
    # a lane must never strand: every state reachable by legal tokens
    # must keep at least one legal token
    seen = {0}
    stack = [0]
    while stack:
        s = stack.pop()
        if pop[s] == 0:
            raise GrammarError(
                "vocabulary cannot express this grammar: a reachable "
                "constraint state has no legal token (grammar needs a "
                "character no vocab token can begin)")
        for d in set(int(x) for x in nxt[s][allowed[s]]):
            if d not in seen:
                seen.add(d)
                stack.append(d)
    return TokenDFA(next_state=nxt, mask=_pack_mask(allowed),
                    accepting=accepting, forced=forced, popcount=pop)


# ---------------------------------------------------------------------------
# JSON-schema subset -> regex lowering
# ---------------------------------------------------------------------------

_RE_META = set(".^$*+?()[]{}|\\")

_STRING_RE = (r'"([^"\\\x00-\x1f]|\\["\\/bfnrt]'
              r'|\\u[0-9a-fA-F]{4})*"')
_INTEGER_RE = r"-?(0|[1-9][0-9]*)"
_NUMBER_RE = _INTEGER_RE + r"(\.[0-9]+)?([eE][+-]?[0-9]+)?"

_UNSUPPORTED = (
    "$ref", "$dynamicRef", "anyOf", "oneOf", "allOf", "not",
    "patternProperties", "propertyNames", "if", "then", "else",
    "dependentSchemas", "dependentRequired", "pattern", "format",
    "minLength", "maxLength", "minimum", "maximum",
    "exclusiveMinimum", "exclusiveMaximum", "multipleOf",
    "uniqueItems", "contains", "prefixItems", "additionalItems",
    "unevaluatedProperties", "minProperties", "maxProperties",
)


def _lit(text):
    """Regex-escape a literal string (e.g. a JSON-dumped enum value)."""
    return "".join("\\" + c if c in _RE_META else c for c in text)


def _json_dump(value):
    return json.dumps(value, separators=(",", ":"), sort_keys=True)


def _schema_regex(schema, depth):
    if depth > _MAX_SCHEMA_DEPTH:
        raise GrammarError(
            f"JSON schema nests deeper than the supported bound "
            f"({_MAX_SCHEMA_DEPTH})")
    if not isinstance(schema, dict):
        raise GrammarError(
            f"schema nodes must be objects, got {type(schema).__name__}")
    bad = [k for k in _UNSUPPORTED if k in schema]
    if bad:
        raise GrammarError(
            "unsupported JSON-schema feature(s): " + ", ".join(bad)
            + " (supported: type object/array/string/integer/number/"
            "boolean/null, enum, const, properties + required, items "
            "+ minItems/maxItems, additionalProperties: false)")
    if "const" in schema:
        return _lit(_json_dump(schema["const"]))
    if "enum" in schema:
        vals = schema["enum"]
        if not isinstance(vals, list) or not vals:
            raise GrammarError("'enum' must be a non-empty list")
        return "(" + "|".join(_lit(_json_dump(v)) for v in vals) + ")"
    ty = schema.get("type")
    if isinstance(ty, list):
        return ("(" + "|".join(
            _schema_regex({**schema, "type": t}, depth + 1)
            for t in ty) + ")")
    if ty == "string":
        return _STRING_RE
    if ty == "integer":
        return _INTEGER_RE
    if ty == "number":
        return _NUMBER_RE
    if ty == "boolean":
        return "(true|false)"
    if ty == "null":
        return "null"
    if ty == "array":
        return _array_regex(schema, depth)
    if ty == "object":
        return _object_regex(schema, depth)
    raise GrammarError(
        f"unsupported or missing schema 'type': {ty!r} (supported: "
        "object, array, string, integer, number, boolean, null, or "
        "enum/const)")


def _array_regex(schema, depth):
    if "items" not in schema:
        raise GrammarError(
            "'array' schemas need 'items' (unbounded heterogeneous "
            "arrays are not supported)")
    item = _schema_regex(schema["items"], depth + 1)
    lo = int(schema.get("minItems", 0))
    hi = schema.get("maxItems")
    hi = None if hi is None else int(hi)
    if lo < 0 or (hi is not None and hi < lo):
        raise GrammarError("invalid minItems/maxItems bounds")
    if hi == 0:
        return r"\[\]"
    x = "(" + item + ")"
    if lo == 0:
        tail = "*" if hi is None else ("{0,%d}" % (hi - 1))
        body = "(" + x + "(," + x + ")" + tail + ")?"
    else:
        tail = ("{%d,}" % (lo - 1)) if hi is None else \
            ("{%d,%d}" % (lo - 1, hi - 1))
        body = x + "(," + x + ")" + tail
    return r"\[" + body + r"\]"


def _object_regex(schema, depth):
    extra = schema.get("additionalProperties", False)
    if extra is not False:
        raise GrammarError(
            "additionalProperties must be false (or omitted): "
            "free-form keys are not supported")
    props = schema.get("properties", {})
    if not isinstance(props, dict):
        raise GrammarError("'properties' must be an object")
    required = schema.get("required", [])
    unknown = [k for k in required if k not in props]
    if unknown:
        raise GrammarError(
            "required key(s) missing from 'properties': "
            + ", ".join(repr(k) for k in unknown))
    pairs = {k: _lit(json.dumps(k)) + ":"
             + _schema_regex(v, depth + 1)
             for k, v in props.items()}
    req = [k for k in props if k in set(required)]
    opt = [k for k in props if k not in set(required)]
    if req:
        # required keys in declaration order; each optional key may
        # ride behind them as an independent (,"k":V)? suffix
        body = ",".join(pairs[k] for k in req)
        body += "".join("(," + pairs[k] + ")?" for k in opt)
    elif opt:
        # all-optional: alternate on the first key present, each chain
        # keeping declaration order for what follows
        chains = []
        for i, k in enumerate(opt):
            chain = pairs[k] + "".join(
                "(," + pairs[j] + ")?" for j in opt[i + 1:])
            chains.append(chain)
        body = "(" + "|".join(chains) + ")?"
    else:
        body = ""
    return r"\{" + body + r"\}"


def schema_to_regex(schema):
    """Lower a JSON-schema subset to a regex over *compact* JSON (no
    insignificant whitespace, ``json.dumps(separators=(',', ':'))``
    form).  Raises :class:`GrammarError` naming unsupported features.
    """
    return _schema_regex(schema, 0)


# ---------------------------------------------------------------------------
# GrammarSpec: the validated request-level grammar object
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GrammarSpec:
    """A validated grammar riding a request (alongside SamplingParams).

    ``kind`` is ``"regex"`` or ``"json_schema"``; ``source`` is the
    canonical text (the pattern, or the sorted-key JSON dump of the
    schema) and keys the engine's compile cache; ``pattern`` is the
    effective regex the compiler consumes.  Construction validates
    eagerly (parse / lowering), so a bad grammar raises
    :class:`GrammarError` at the gateway, before anything queues.
    """

    kind: str
    source: str
    pattern: str

    @classmethod
    def regex(cls, pattern):
        pattern = str(pattern)
        compile_regex(pattern)     # validate eagerly
        return cls(kind="regex", source=pattern, pattern=pattern)

    @classmethod
    def json_schema(cls, schema):
        pattern = schema_to_regex(schema)
        compile_regex(pattern)
        return cls(kind="json_schema", source=_json_dump(schema),
                   pattern=pattern)

    @property
    def key(self):
        return (self.kind, self.source)


def as_grammar_spec(obj):
    """Coerce a request-level grammar value to a :class:`GrammarSpec`:
    a string is a regex, a dict is a JSON schema, a spec passes
    through."""
    if isinstance(obj, GrammarSpec):
        return obj
    if isinstance(obj, str):
        return GrammarSpec.regex(obj)
    if isinstance(obj, dict):
        return GrammarSpec.json_schema(obj)
    raise GrammarError(
        f"grammar must be a regex string, a JSON-schema object, or a "
        f"GrammarSpec, got {type(obj).__name__}")


# ---------------------------------------------------------------------------
# GrammarSlab: host master for the fixed-capacity device DFA slab
# ---------------------------------------------------------------------------


class GrammarSlab:
    """Fixed-capacity host master for the device-resident token-DFA
    tables.

    Row 0 is the reserved accept-all sentinel unconstrained lanes ride:
    every token legal, every transition a self-loop — masking with it
    is the identity (``where(True, x, floor)`` is bitwise ``x``), so a
    mixed constrained/free batch is one compiled program with zero cost
    to free lanes.  Compiled grammars install at refcounted offsets
    >= 1; installed rows store *global* next-state ids (grammar-local
    state + offset) so the engine advances lanes with one gather, and
    REJECT entries store 0 (the sentinel row) because legality is
    decided by the bitmask alone — a rejected gather must stay a valid
    row index for the lanes whose position is never emitted.

    Single-owner by contract: only the engine thread mutates the slab;
    the engine re-uploads when ``dirty``.
    """

    def __init__(self, capacity, vocab_size):
        capacity = int(capacity)
        if capacity < 2:
            raise ValueError(
                "grammar_max_states must be >= 2: row 0 is the "
                "reserved accept-all sentinel, grammars need rows >= 1")
        self.capacity = capacity
        self.vocab_size = int(vocab_size)
        words = (self.vocab_size + 31) // 32
        self.next = np.zeros((capacity, self.vocab_size), np.int32)
        self.mask = np.zeros((capacity, words), np.uint32)
        self.forced = np.full(capacity, -1, np.int32)
        self.popcount = np.zeros(capacity, np.int32)
        self.accepting = np.zeros(capacity, bool)
        self.mask[0] = _pack_mask(
            np.ones((1, self.vocab_size), bool))[0]
        self.popcount[0] = self.vocab_size
        self.dirty = True
        self._segments = {}    # key -> [offset, size, refs]

    @property
    def states_used(self):
        return 1 + sum(sz for _, sz, _ in self._segments.values())

    @property
    def grammars_installed(self):
        return len(self._segments)

    @property
    def device_bytes(self):
        return (self.next.nbytes + self.mask.nbytes
                + self.forced.nbytes)

    def offset(self, key):
        return self._segments[key][0]

    def installed(self, key):
        """True while ``key`` holds a live (refcount > 0) segment."""
        return key in self._segments

    def _alloc(self, size):
        taken = sorted((off, sz) for off, sz, _ in
                       self._segments.values())
        cur = 1
        for off, sz in taken:
            if off - cur >= size:
                break
            cur = off + sz
        if cur + size > self.capacity:
            raise RuntimeError(
                f"grammar slab exhausted: need {size} states, "
                f"{self.capacity - self.states_used} free of "
                f"{self.capacity} (raise grammar_max_states or retire "
                "constrained requests)")
        return cur

    def install(self, key, dfa):
        """Install (or re-reference) a compiled TokenDFA; returns the
        row offset of its start state."""
        seg = self._segments.get(key)
        if seg is not None:
            seg[2] += 1
            return seg[0]
        if dfa.vocab_size != self.vocab_size:
            raise ValueError(
                f"grammar compiled for vocab {dfa.vocab_size}, slab "
                f"holds vocab {self.vocab_size}")
        size = dfa.n_states
        off = self._alloc(size)
        self.next[off:off + size] = np.where(
            dfa.next_state >= 0, dfa.next_state + off, 0)
        self.mask[off:off + size] = dfa.mask
        self.forced[off:off + size] = dfa.forced
        self.popcount[off:off + size] = dfa.popcount
        self.accepting[off:off + size] = dfa.accepting
        self._segments[key] = [off, size, 1]
        self.dirty = True
        return off

    def release(self, key):
        """Drop one reference; frees the rows at refcount zero (the
        device arrays are refreshed lazily at the next install)."""
        seg = self._segments.get(key)
        if seg is None:
            return
        seg[2] -= 1
        if seg[2] <= 0:
            off, size, _ = self._segments.pop(key)
            self.next[off:off + size] = 0
            self.mask[off:off + size] = 0
            self.forced[off:off + size] = -1
            self.popcount[off:off + size] = 0
            self.accepting[off:off + size] = False
