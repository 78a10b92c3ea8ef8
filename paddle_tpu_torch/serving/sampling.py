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

#: logit floor for grammar-masked (disallowed) tokens: finite, so the
#: temperature divide and softmax stay NaN-free at any temperature, but
#: far below every real logit, so neither argmax nor a draw can pick a
#: masked token.  Exact in bf16 and f32 (in f16 it would be -inf, and an
#: all--inf row turns softmax into NaN), so the mask is applied to f32
#: logits.
MASK_FLOOR = -1.0e30


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


def sampled_rows(temperatures):
    """Indices of the rows that sample (temperature > 0); the others
    are greedy."""
    return [i for i, t in enumerate(temperatures) if float(t) > 0]


def draw_uniforms(seeds, counts, rows, n, vocab, device):
    """The uniform draws [len(rows), n, vocab] f32 of ``n`` consecutive
    tokens of each sampled row: entry ``[a, j]`` is the draw of row
    ``rows[a]``'s token ``counts[rows[a]] + j``, from a generator seeded
    by :func:`request_seed` (host ``seeds``/``counts``)."""
    u = torch.empty((len(rows), n, vocab), dtype=torch.float32,
                    device=device)
    for a, i in enumerate(rows):
        for j in range(n):
            g = torch.Generator(device=device)
            g.manual_seed(request_seed(seeds[i], int(counts[i]) + j))
            u[a, j].uniform_(generator=g)
    return u


def row_params(rows, temperatures, top_ks, top_ps, device):
    """The filter controls of the sampled ``rows`` as device tensors
    (``filter_logits``'s arguments)."""
    return (torch.tensor([float(temperatures[i]) for i in rows],
                         dtype=torch.float32, device=device),
            torch.tensor([int(top_ks[i]) for i in rows], device=device),
            torch.tensor([float(top_ps[i]) for i in rows],
                         dtype=torch.float32, device=device))


def sample_rows(logits, idx, params, u):
    """Token ids [N] for ``logits`` [N, vocab]: the argmax, except at the
    sampled rows ``idx`` (a device index tensor), which draw by
    Gumbel-max over their filtered logits (``params`` from
    :func:`row_params`) with the uniforms ``u`` [len(idx), vocab]."""
    greedy = torch.argmax(logits, dim=-1)
    if not len(idx):
        return greedy
    filtered = filter_logits(logits[idx], *params)
    gumbel = -torch.log(-torch.log(u))
    return greedy.index_copy(0, idx, torch.argmax(filtered + gumbel, dim=-1))


def sample_batch(logits, seeds, counts, temperatures, top_ks, top_ps):
    """Token ids [N] (int64, on the logits' device) for ``logits``
    [N, vocab].  The per-row parameters are host sequences of length N:
    ``seeds`` and ``counts`` seed each sampled row's generator through
    :func:`request_seed`; ``temperatures``, ``top_ks`` and ``top_ps``
    are its controls.  Greedy rows (temperature <= 0) take the argmax;
    when every row is greedy nothing else runs.  A sampled row draws by
    Gumbel-max over its filtered logits, with the uniforms from its own
    generator."""
    rows = sampled_rows(temperatures)
    if not rows:
        return torch.argmax(logits, dim=-1)
    dev = logits.device
    u = draw_uniforms(seeds, counts, rows, 1, logits.shape[-1], dev)[:, 0]
    return sample_rows(logits, torch.tensor(rows, device=dev),
                       row_params(rows, temperatures, top_ks, top_ps, dev),
                       u)


def _unpack_mask(rows, vocab):
    """Unpack packed legality-bitmask rows to a boolean mask.

    rows [..., W32] int32   bit ``t % 32`` of word ``t // 32`` set means
                            token ``t`` is legal (the grammar slab's
                            uint32 words viewed as int32: CUDA has few
                            uint32 ops, and an arithmetic shift's sign
                            fill is cut off by the ``& 1``)
    Returns [..., vocab] bool."""
    bits = torch.arange(32, dtype=rows.dtype, device=rows.device)
    b = (rows[..., :, None] >> bits) & 1
    return b.reshape(rows.shape[:-1] + (rows.shape[-1] * 32,))[
        ..., :vocab].bool()


def apply_mask(logits, allowed):
    """``logits`` as f32 with the disallowed entries at
    :data:`MASK_FLOOR`.  An all-True row is the identity on its values
    (the upcast is exact), so an unconstrained lane samples as it would
    unmasked."""
    return torch.where(allowed, logits.float(),
                       torch.full((), MASK_FLOOR, device=logits.device))


def sample_window(logits, seeds, counts, temperatures, top_ks, top_ps,
                  allowed=None):
    """Sampling across a speculative verify window: logits [N, W, vocab]
    -> token ids [N, W], where window position j of lane i draws as
    token ``counts[i] + j`` of its request: the uniforms of
    ``request_seed(seeds[i], counts[i] + j)``, the draw
    :func:`sample_batch` makes for that token at K = 0.  So the token a
    request emits at index k is the same whatever window verified it.
    (The engine's horizon draws its uniforms once, at its start, with
    :func:`draw_uniforms`, and indexes them by the lanes' device
    counts.)

    ``allowed`` (optional, [N, W, vocab] bool) is the grammar mask:
    disallowed logits drop to :data:`MASK_FLOOR` before the all-greedy
    fast path and before the draw, so constrained sampling keeps the
    same key discipline."""
    n, w, vocab = logits.shape
    if allowed is not None:
        logits = apply_mask(logits, allowed)
    rows = sampled_rows(temperatures)
    flat = logits.reshape(n * w, vocab)
    if not rows:
        return torch.argmax(flat, dim=-1).view(n, w)
    dev = logits.device
    u = draw_uniforms(seeds, counts, rows, w, vocab, dev)
    win = [i * w + j for i in rows for j in range(w)]
    rep = lambda a: [a[i] for i in range(n) for _ in range(w)]
    params = row_params(win, rep(list(temperatures)), rep(list(top_ks)),
                        rep(list(top_ps)), dev)
    return sample_rows(flat, torch.tensor(win, device=dev), params,
                       u.reshape(-1, vocab)).view(n, w)
