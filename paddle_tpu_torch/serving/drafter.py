"""Self-drafting token proposal for speculative decoding (counterpart of
``paddle_tpu/serving/drafter.py``: ``draft_tokens`` and the grammar's
``forced_chain``).

Prompt-lookup / n-gram drafting: a lane's guess for its next K tokens is
what followed the best earlier occurrence of its current
``ngram``-token suffix in its own prompt+output history.  No second
model and no host round-trip: the history lives on the device (the
engine's ``[num_slots, max_seq_len + 1]`` token buffer) and the matcher
is a fixed-shape gather/compare, run once per decode step.

The drafter may be wrong: a rejected draft costs one wasted position of
the verify forward and nothing else.  Its one contract is the
**sentinel**: a position with no valid proposal is ``-1``, which no
sampled token equals, so it is never accepted.
"""

from __future__ import annotations

import torch


def draft_tokens(hist, lengths, k, ngram=2):
    """Propose up to ``k`` draft tokens per lane by suffix matching.

    hist [N, S] int      per-lane token history; positions ``< lengths``
                         are valid (prompt followed by emitted tokens)
    lengths [N] int      valid history length per lane
    k                    draft width (>= 1)
    ngram                suffix length to match (>= 1)

    Returns [N, k] int64 draft ids on ``hist``'s device, ``-1`` where no
    proposal exists (history shorter than ``ngram + 1``, no earlier
    occurrence of the suffix, or the continuation would run past the
    valid history).  The match with the most runway (known history after
    it, capped at ``k``) wins, ties to the most recent: both ranked by
    one integer ``runway * (S + 1) + start`` and one max.  A usable match
    ends strictly before the last valid token, so the trailing window
    never matches itself."""
    if k < 1:
        raise ValueError(f"draft width k must be >= 1, got {k}")
    if ngram < 1:
        raise ValueError(f"ngram must be >= 1, got {ngram}")
    n, s = hist.shape
    dev = hist.device
    if s < ngram + 1:
        return torch.full((n, k), -1, dtype=torch.int64, device=dev)
    hist = hist.long()
    lengths = lengths.long()
    starts = torch.arange(s - ngram + 1, device=dev)
    offs = torch.arange(ngram, device=dev)
    ks = torch.arange(k, device=dev)
    # the lane's trailing ngram (its start clamped into the row, as
    # dynamic_slice; short histories are rejected by `enough`)
    g0 = (lengths - ngram).clamp(0, s - ngram)
    g = torch.gather(hist, 1, g0[:, None] + offs)                 # [N, ngram]
    win = hist[:, starts[:, None] + offs[None, :]]                # [N, W, ngram]
    hit = (win == g[:, None, :]).all(dim=2)
    hit &= (starts + ngram)[None, :] <= (lengths - 1)[:, None]
    enough = lengths >= ngram + 1
    runway = (lengths[:, None] - (starts + ngram)[None, :]).clamp(0, k)
    score = torch.where(hit & enough[:, None], runway * (s + 1) + starts,
                        torch.full_like(runway, -1))
    top = score.amax(dim=1)
    best = torch.where(top >= 0, top % (s + 1), torch.full_like(top, -1))
    cont = best[:, None] + ngram + ks                              # [N, k]
    cand = torch.gather(hist, 1, cont.clamp(0, s - 1))
    valid = (best >= 0)[:, None] & (cont < lengths[:, None])
    return torch.where(valid, cand, torch.full_like(cand, -1))


def forced_chain(states, next_table, forced, k):
    """Constraint-aware draft proposals: chain the grammar's FORCED
    tokens from each lane's DFA state.

    When a lane's DFA state admits exactly one legal token (closing
    braces, quoted keys, commas: the skeleton of a JSON output)
    ``forced[state]`` names it and the verify forward must agree, since
    every other logit sits at the mask floor, so proposing it is a
    draft that lands.  Chains extend while each successor state stays
    forced, up to ``k``; the first non-forced state ends the chain with
    ``-1`` from there on, and the engine overlays these proposals on
    the n-gram drafter's (forced wins where present).  Unconstrained
    lanes sit in the accept-all sentinel state, whose ``forced`` entry
    is ``-1``, so they never chain.

    states [N] int         per-lane DFA state ids (slab-global rows)
    next_table [S, V] int  dense transition table (slab rows)
    forced [S] int         the state's sole legal token, or -1
    k                      chain length (the draft width)

    Returns [N, k] int64 proposals, ``-1`` where not forced: ``k``
    gathers into ``forced`` and ``next_table`` on the tables' device."""
    cols = []
    st = states.long()
    ok = None
    for _ in range(k):
        f = forced[st].long()
        ok = (f >= 0) if ok is None else (ok & (f >= 0))
        cols.append(torch.where(ok, f, torch.full_like(f, -1)))
        st = torch.where(ok, next_table[st, f.clamp_min(0)].long(), st)
    return torch.stack(cols, dim=1)
