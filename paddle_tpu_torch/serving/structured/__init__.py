"""Grammar-constrained decoding (structured generation).

Three layers: the grammar compiler (:mod:`.grammar` — regex / JSON
schema -> token-level DFA over the vocab), the engine integration
(per-lane DFA states in the engine's device state, the logit mask
applied before sampling), and the constraint-aware drafter
(forced-token chains proposed ahead of n-gram drafts, see
``serving.drafter.forced_chain``).
"""

from .grammar import (          # noqa: F401
    REJECT,
    CharDFA,
    GrammarError,
    GrammarSlab,
    GrammarSpec,
    TokenDFA,
    as_grammar_spec,
    compile_grammar,
    compile_regex,
    schema_to_regex,
)

__all__ = [
    "REJECT",
    "CharDFA",
    "GrammarError",
    "GrammarSlab",
    "GrammarSpec",
    "TokenDFA",
    "as_grammar_spec",
    "compile_grammar",
    "compile_regex",
    "schema_to_regex",
]
