"""Token sampling for the serving engine.

Greedy / temperature / top-k / top-p with the JAX package's tie and
threshold rules (``paddle_tpu/serving/sampling.py``): top-k keeps every
logit ``>=`` the k-th largest (ties widen the pool), top-p keeps every
token whose probability reaches the probability at the first sorted
index where the cumulative mass reaches ``top_p``.

A request's k-th sampled token depends only on (its seed, k, its
logits row): the random draw for that token comes from a
``torch.Generator`` seeded by :func:`request_seed`, a pure function of
``(seed, k)``, never from a generator shared across the batch.  That
is what makes continuous batching reproduce sequential generation
token for token, whatever slot the request occupies and whatever else
runs beside it.

JAX derives the same key as ``fold_in(PRNGKey(seed), k)`` and draws
with threefry bits; those bits are not reproduced here, so a sampled
(temperature > 0) stream differs from the JAX engine's by design.
Greedy streams depend on the logits alone and match.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_MASK64 = (1 << 64) - 1


@dataclass
class SamplingParams:
    """Per-request decoding controls.

    temperature <= 0 selects greedy argmax decoding; top_k <= 0 and
    top_p >= 1.0 disable their respective filters.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    max_new_tokens: int = 16
    eos_token_id: int | None = None
    seed: int = 0

    def validate(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        return self


def request_seed(seed, n_sampled):
    """The generator seed of a request's ``n_sampled``-th token: the
    splitmix64 finalizer over ``(seed, n_sampled)`` packed into 64 bits,
    so neighbouring (seed, k) pairs give unrelated streams."""
    z = (((int(seed) & 0xFFFFFFFF) << 32) | (int(n_sampled) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def filter_logits(logits, temperatures, top_ks, top_ps):
    """Temperature-scale and top-k / top-p filter each row of ``logits``
    [N, vocab] under its own row parameters ([N] tensors on the logits'
    device).  Returns f32 [N, vocab] with filtered entries at -inf.
    Row-wise throughout, so a row's result never depends on the other
    rows."""
    vocab = logits.shape[-1]
    t = torch.where(temperatures > 0, temperatures,
                    torch.ones_like(temperatures))
    scaled = logits.float() / t[:, None]

    # top-k: keep logits >= the k-th largest (ties widen the pool)
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_idx = (top_ks.clamp(1, vocab) - 1).long()[:, None]
    kth = torch.gather(sorted_desc, 1, k_idx)
    drop = (top_ks > 0)[:, None] & (scaled < kth)
    scaled = scaled.masked_fill(drop, float("-inf"))

    # top-p (nucleus): keep the smallest prefix of the sorted
    # distribution whose mass reaches top_p; argmax over the bool picks
    # the FIRST index reaching p (index 0 when none does, as jnp.argmax)
    probs = torch.softmax(scaled, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    cum = torch.cumsum(sp, dim=-1)
    cutoff = torch.argmax((cum >= top_ps[:, None]).to(torch.int32), dim=-1)
    threshold = torch.gather(sp, 1, cutoff[:, None])
    drop = (top_ps < 1.0)[:, None] & (probs < threshold)
    return scaled.masked_fill(drop, float("-inf"))


def sample_batch(logits, seeds, counts, temperatures, top_ks, top_ps):
    """Token ids [N] (int64, on the logits' device) for ``logits``
    [N, vocab].  The per-row parameters are host sequences of length N:
    ``seeds`` and ``counts`` seed each sampled row's generator through
    :func:`request_seed`; ``temperatures``, ``top_ks`` and ``top_ps``
    are its controls.  Greedy rows (temperature <= 0) take the argmax;
    when every row is greedy nothing else runs.  A sampled row draws by
    Gumbel-max over its filtered logits, with the uniforms from its own
    generator."""
    greedy = torch.argmax(logits, dim=-1)
    temps = [float(t) for t in temperatures]
    rows = [i for i, t in enumerate(temps) if t > 0]
    if not rows:
        return greedy
    dev = logits.device
    idx = torch.tensor(rows, device=dev)
    filtered = filter_logits(
        logits[idx],
        torch.tensor([temps[i] for i in rows], dtype=torch.float32,
                     device=dev),
        torch.tensor([int(top_ks[i]) for i in rows], device=dev),
        torch.tensor([float(top_ps[i]) for i in rows], dtype=torch.float32,
                     device=dev))
    vocab = logits.shape[-1]
    u = torch.empty((len(rows), vocab), dtype=torch.float32, device=dev)
    for j, i in enumerate(rows):
        g = torch.Generator(device=dev)
        g.manual_seed(request_seed(seeds[i], counts[i]))
        u[j].uniform_(generator=g)
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(filtered + gumbel, dim=-1)
    return greedy.index_copy(0, idx, sampled)
