"""The port's n-gram drafter (``paddle_tpu_torch.serving.drafter``)
against JAX's ``paddle_tpu.serving.draft_tokens``, element by element,
on ``tests/test_serving.py::TestDrafter``'s cases and on seeded random
histories.  Exact equality: both are integer gathers and compares."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.serving import draft_tokens as jax_draft_tokens
from paddle_tpu_torch.serving.drafter import draft_tokens

from _torch_port_util import one_thread  # noqa: F401


def _both(hist, lengths, k, ngram=2):
    hist = np.asarray(hist, np.int32)
    lengths = np.asarray(lengths, np.int32)
    want = np.asarray(jax_draft_tokens(jnp.asarray(hist),
                                       jnp.asarray(lengths), k, ngram))
    got = draft_tokens(torch.from_numpy(hist), torch.from_numpy(lengths), k,
                       ngram)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy().tolist()


def _draft(row, length, k=3, ngram=2, width=16):
    hist = np.zeros((1, width), np.int32)
    hist[0, :len(row)] = row
    return _both(hist, [length], k, ngram)[0]


# TestDrafter's cases: (row, length, k, expected drafts)
CASES = {
    "short_history_is_sentinel": ([7, 7], 2, 3, [-1, -1, -1]),
    "no_earlier_match_is_sentinel": ([1, 2, 3, 4, 5, 6], 6, 3, [-1] * 3),
    "full_runway": ([1, 2, 3, 9, 1, 2], 6, 3, [3, 9, 1]),
    "runway_beats_recency": ([1, 2, 3, 1, 2, 1, 2], 7, 3, [3, 1, 2]),
    "recency_breaks_runway_ties": ([1, 2, 5, 5, 5, 1, 2, 8, 8, 8, 1, 2], 12,
                                   3, [8, 8, 8]),
    "clamped_to_known_history": ([7, 1, 2, 1, 2], 5, 3, [1, 2, -1]),
    "tail_never_matches_itself": ([5, 1, 2], 3, 3, [-1, -1, -1]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_cases(case):
    row, length, k, want = CASES[case]
    assert _draft(row, length, k) == want


def test_history_narrower_than_ngram_plus_one():
    assert _both(np.zeros((2, 2)), [2, 2], 4) == [[-1] * 4] * 2


def test_lanes_are_independent():
    hist = np.zeros((2, 16), np.int32)
    hist[0, :6] = [1, 2, 3, 9, 1, 2]
    hist[1, :6] = [4, 5, 6, 7, 8, 9]
    assert _both(hist, [6, 6], 3) == [[3, 9, 1], [-1, -1, -1]]


def test_validates_static_args():
    h = torch.zeros((1, 8), dtype=torch.int64)
    lengths = torch.tensor([4])
    with pytest.raises(ValueError):
        draft_tokens(h, lengths, 0)
    with pytest.raises(ValueError):
        draft_tokens(h, lengths, 2, ngram=0)


@pytest.mark.parametrize("seed", range(6))
def test_random_histories_match_jax(seed):
    """Histories over a small alphabet (so suffixes recur) of width
    2-40, k 1-8, ngram 1-3; 16 lanes a call with lengths 0 .. width
    (some lanes empty, some full)."""
    r = np.random.default_rng(seed)
    width, k, ngram = int(r.integers(2, 41)), int(r.integers(1, 9)), \
        int(r.integers(1, 4))
    hist = r.integers(0, 2 + seed % 4, (16, width))
    lengths = r.integers(0, width + 1, 16)
    lengths[:2] = (0, width)
    _both(hist, lengths, k, ngram)
