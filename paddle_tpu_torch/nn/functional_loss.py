"""Loss functionals, the counterparts of
``paddle_tpu/nn/functional/loss.py`` (re-exported by ``nn.functional``).

Each is JAX's function term for term, in its inputs' dtype, with JAX's
constants (the 1e-12 and 1e-30 floors, the -1e30 of CTC's log space) and
reductions (``"mean"``, ``"sum"``, ``"none"``).  Labels that JAX detaches
are detached here.  Each calls :func:`~paddle_tpu_torch.amp.auto_cast.
cast_inputs` with JAX's op name (``square_error_cost`` names none).

``ctc_loss`` runs JAX's forward algorithm (``lax.scan`` over time) as a
loop over time steps; ``hsigmoid_loss`` builds the default
complete-binary-tree coding on the host, as JAX's, and like it refuses a
custom path table.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as TF

from ..amp.auto_cast import cast_inputs


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def _detach(t):
    return None if t is None else t.detach()


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """``loss.py:26-63`` in the logits' dtype (as JAX's
    ``log_softmax``): integer labels (``axis`` is the class dim;
    ``ignore_index`` rows count for nothing), per-class ``weight``,
    ``label_smoothing``, or soft labels of the logits' shape.  ``"mean"``
    over integer labels divides by ``max(valid rows, 1)``, or with
    ``weight`` by ``max(sum of the valid rows' weights, 1e-12)``; soft
    labels take the plain mean."""
    soft = soft_label or (label.dim() == input.dim()
                          and label.shape == input.shape)
    input, label, weight = cast_inputs(
        "cross_entropy", input, label if soft else label.detach(),
        _detach(weight))
    logits = input
    if use_softmax:
        logp = torch.log_softmax(logits, dim=axis)
    else:
        logp = torch.log(torch.clamp(logits, min=1e-30))
    n_class = logits.shape[axis]
    if soft:
        sl = label
        if label_smoothing > 0:
            sl = sl * (1 - label_smoothing) + label_smoothing / n_class
        return _reduce(-(sl * logp).sum(dim=axis), reduction)
    lbl = label.long()
    if lbl.dim() == logits.dim():
        lbl = lbl.squeeze(axis)
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    if label_smoothing > 0:
        oh = TF.one_hot(safe, n_class).to(logp.dtype).movedim(-1, axis)
        oh = oh * (1 - label_smoothing) + label_smoothing / n_class
        nll = -(oh * logp).sum(dim=axis)
    else:
        nll = -torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    if weight is not None:
        cw = weight[safe]
        nll = nll * cw
        if reduction == "mean":
            denom = torch.where(valid, cw, 0.0).sum()
            return torch.where(valid, nll, 0.0).sum() / torch.clamp(
                denom, min=1e-12)
    loss = torch.where(valid, nll, 0.0)
    if reduction == "mean":
        return loss.sum() / torch.clamp(valid.to(logp.dtype).sum(), min=1.0)
    return _reduce(loss, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis).unsqueeze(axis)
    if return_softmax:
        (x,) = cast_inputs("softmax", logits)
        return loss, torch.softmax(x, dim=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    logp, lbl, w = cast_inputs("nll_loss", input, label.detach(),
                               _detach(weight))
    lbl = lbl.long()
    valid = lbl != ignore_index
    safe = torch.where(valid, lbl, 0)
    nll = -torch.gather(logp, 1, safe.unsqueeze(1)).squeeze(1)
    if w is not None:
        cw = w[safe]
        nll = nll * cw
        if reduction == "mean":
            denom = torch.where(valid, cw, 0.0).sum()
            return torch.where(valid, nll, 0.0).sum() / torch.clamp(
                denom, min=1e-12)
    nll = torch.where(valid, nll, 0.0)
    if reduction == "mean":
        return nll.sum() / torch.clamp(valid.to(logp.dtype).sum(), min=1.0)
    return _reduce(nll, reduction)


def mse_loss(input, label, reduction="mean"):
    a, b = cast_inputs("mse_loss", input, label)
    return _reduce((a - b).square(), reduction)


def l1_loss(input, label, reduction="mean"):
    a, b = cast_inputs("l1_loss", input, label)
    return _reduce((a - b).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    a, b = cast_inputs("smooth_l1_loss", input, label)
    d = (a - b).abs()
    return _reduce(torch.where(d < delta, 0.5 * d * d,
                               delta * (d - 0.5 * delta)), reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean"):
    p, y, w = cast_inputs("bce", input, label, weight)
    p = torch.clamp(p, 1e-12, 1 - 1e-12)
    loss = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None):
    z, y, w = cast_inputs("bce_with_logits", logit, label, weight)
    neg_abs = -z.abs()
    if pos_weight is not None:
        pw = torch.as_tensor(pos_weight, device=z.device).detach()
        log_w = (pw - 1) * y + 1
        loss = (1 - y) * z + log_w * (torch.log1p(torch.exp(neg_abs))
                                      + torch.clamp(-z, min=0))
    else:
        loss = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(neg_abs))
    if w is not None:
        loss = loss * w
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", log_target=False):
    lp, t = cast_inputs("kl_div", input, label)
    if log_target:
        loss = torch.exp(t) * (t - lp)
    else:
        loss = torch.where(t > 0, t * (torch.log(torch.clamp(t, min=1e-30))
                                       - lp), 0.0)
    if reduction == "batchmean":
        return loss.sum() / lp.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    a, b, y = cast_inputs("margin_ranking_loss", input, other, label)
    return _reduce(torch.clamp(-y * (a - b) + margin, min=0.0), reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean"):
    a, b, y = cast_inputs("cosine_embedding_loss", input1, input2, label)
    cos = (a * b).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(a, dim=-1)
        * torch.linalg.vector_norm(b, dim=-1), min=1e-12)
    loss = torch.where(y == 1, 1 - cos, torch.clamp(cos - margin, min=0.0))
    return _reduce(loss, reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    a, y = cast_inputs("hinge_embedding_loss", input, label)
    return _reduce(torch.where(y == 1, a, torch.clamp(margin - a, min=0.0)),
                   reduction)


def _pdist(a, b, p, epsilon):
    return torch.pow(torch.pow((a - b).abs() + epsilon, p).sum(-1), 1 / p)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean"):
    a, pos, neg = cast_inputs("triplet_margin_loss", input, positive,
                              negative)
    dp = _pdist(a, pos, p, epsilon)
    dn = _pdist(a, neg, p, epsilon)
    if swap:
        dn = torch.minimum(dn, _pdist(pos, neg, p, epsilon))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def square_error_cost(input, label):
    return (input - label).square()


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum"):
    z, y, n = cast_inputs("sigmoid_focal_loss", logit, label, normalizer)
    p = torch.sigmoid(z)
    ce = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
    p_t = p * y + (1 - p) * (1 - y)
    a_t = alpha * y + (1 - alpha) * (1 - y)
    loss = a_t * torch.pow(1 - p_t, gamma) * ce
    if n is not None:
        loss = loss / n
    return _reduce(loss, reduction)


def log_loss(input, label, epsilon=1e-4):
    p, y = cast_inputs("log_loss", input, label)
    return -y * torch.log(p + epsilon) - (1 - y) * torch.log(1 - p + epsilon)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC by the forward algorithm in log space; ``log_probs`` is
    ``[T, B, C]`` (normalised again by ``log_softmax``, as JAX's)."""
    lp, lbl, in_len, lbl_len = cast_inputs(
        "ctc_loss", log_probs, labels.detach(), input_lengths.detach(),
        label_lengths.detach())
    lp = torch.log_softmax(lp, dim=-1)
    t_len, b, _ = lp.shape
    s = lbl.shape[1]
    dev = lp.device
    ext = torch.full((b, 2 * s + 1), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = lbl.long()
    last = 2 * lbl_len.long() + 1
    neg_inf = -1e30
    alpha = torch.full((b, 2 * s + 1), neg_inf, dtype=torch.float32,
                       device=dev)
    alpha = torch.cat([lp[0, :, blank][:, None].to(alpha.dtype),
                       torch.gather(lp[0], 1, ext[:, 1:2]).to(alpha.dtype),
                       alpha[:, 2:]], dim=1)
    same_as_prev2 = torch.cat([torch.ones(b, 2, dtype=torch.bool,
                                          device=dev),
                               ext[:, 2:] == ext[:, :-2]], dim=1)
    pad1 = torch.full((b, 1), neg_inf, dtype=alpha.dtype, device=dev)
    pad2 = torch.full((b, 2), neg_inf, dtype=alpha.dtype, device=dev)
    for t in range(1, t_len):
        shift1 = torch.cat([pad1, alpha[:, :-1]], dim=1)
        shift2 = torch.where(same_as_prev2, neg_inf,
                             torch.cat([pad2, alpha[:, :-2]], dim=1))
        merged = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2)
        new_alpha = merged + torch.gather(lp[t], 1, ext)
        alpha = torch.where((t < in_len)[:, None], new_alpha, alpha)
    a_last = torch.gather(alpha, 1, (last - 1)[:, None])[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp(last - 2, min=0)[:, None])[
        :, 0]
    loss = -torch.logaddexp(a_last, a_prev)
    if reduction == "mean":
        return (loss / torch.clamp(lbl_len.to(loss.dtype), min=1.0)).mean()
    return _reduce(loss, reduction)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """The combined ArcFace/CosFace margin ``cos(m1 theta + m2) - m3`` on
    the target logit, then scaled softmax cross-entropy."""
    lg, y = cast_inputs("margin_cross_entropy", logits, label)
    # strictly inside (-1, 1): arccos' derivative is infinite at +-1
    eps = 1e-6
    cos = torch.clamp(lg, -1.0 + eps, 1.0 - eps)
    onehot = TF.one_hot(y.long(), cos.shape[1]).to(cos.dtype)
    target_cos = torch.cos(margin1 * torch.arccos(cos) + margin2) - margin3
    adj = torch.where(onehot > 0, target_cos, cos) * scale
    loss = -(onehot * torch.log_softmax(adj, dim=-1)).sum(-1)
    if reduction == "mean":
        loss = loss.mean()
    elif reduction == "sum":
        loss = loss.sum()
    if return_softmax:
        return loss, torch.softmax(adj, dim=-1)
    return loss


def gaussian_nll_loss(input, label, variance, full=False, epsilon=1e-6,
                      reduction="mean"):
    mu, y, var = cast_inputs("gaussian_nll_loss", input, label, variance)
    v = torch.clamp(var, min=epsilon)
    loss = 0.5 * (torch.log(v) + (y - mu).square() / v)
    if full:
        loss = loss + 0.5 * torch.log(torch.tensor(2 * math.pi,
                                                   dtype=loss.dtype))
    return _reduce(loss, reduction)


def poisson_nll_loss(input, label, log_input=True, full=False, epsilon=1e-8,
                     reduction="mean"):
    x, y = cast_inputs("poisson_nll_loss", input, label)
    if log_input:
        loss = torch.exp(x) - y * x
    else:
        loss = x - y * torch.log(x + epsilon)
    if full:
        # Stirling's approximation where y > 1
        stir = y * torch.log(y) - y + 0.5 * torch.log(2 * math.pi * y)
        loss = loss + torch.where(y > 1, stir, 0.0)
    return _reduce(loss, reduction)


def _softplus(v):
    return torch.logaddexp(v, torch.zeros_like(v))


def soft_margin_loss(input, label, reduction="mean"):
    x, y = cast_inputs("soft_margin_loss", input, label)
    return _reduce(_softplus(-y * x), reduction)


def multi_label_soft_margin_loss(input, label, weight=None,
                                 reduction="mean"):
    x, y, w = cast_inputs("multi_label_soft_margin_loss", input, label,
                          _detach(weight))
    term = y * -_softplus(-x) + (1 - y) * -_softplus(x)
    if w is not None:
        term = term * w
    return _reduce(-term.mean(-1), reduction)


def multi_margin_loss(input, label, p=1, margin=1.0, weight=None,
                      reduction="mean"):
    x, y, w = cast_inputs("multi_margin_loss", input, label.detach(),
                          _detach(weight))
    c = x.shape[1]
    y = y.long().reshape(-1)
    true_score = torch.gather(x, 1, y[:, None])
    m = torch.clamp(margin - true_score + x, min=0.0) ** p
    if w is not None:
        m = m * w[y][:, None]
    m = torch.where(TF.one_hot(y, c).bool(), 0.0, m)
    return _reduce(m.sum(1) / c, reduction)


def triplet_margin_with_distance_loss(input, positive, negative,
                                      distance_function=None, margin=1.0,
                                      swap=False, reduction="mean"):
    if distance_function is None:
        return triplet_margin_loss(input, positive, negative, margin=margin,
                                   swap=swap, reduction=reduction)
    dp = distance_function(input, positive)
    dn = distance_function(input, negative)
    if swap:
        dn = torch.minimum(dn, distance_function(positive, negative))
    a, b = cast_inputs("triplet_margin_with_distance_loss", dp, dn)
    return _reduce(torch.clamp(a - b + margin, min=0.0), reduction)


def dice_loss(input, label, epsilon=1e-5):
    """``input`` ``[N, ..., C]`` probabilities, ``label`` ``[N, ..., 1]``."""
    x, y = cast_inputs("dice_loss", input, label.detach())
    y1 = TF.one_hot(y.long().squeeze(-1), x.shape[-1]).to(x.dtype)
    xf = x.reshape(x.shape[0], -1)
    yf = y1.reshape(y1.shape[0], -1)
    inter = (xf * yf).sum(1)
    union = xf.sum(1) + yf.sum(1)
    return (1.0 - (2 * inter + epsilon) / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    a, p, y = cast_inputs("npair_loss", anchor, positive, labels.detach())
    y = y.reshape(-1)
    sim = a @ p.T
    same = (y[:, None] == y[None, :]).to(a.dtype)
    same = same / torch.clamp(same.sum(1, keepdim=True), min=1.0)
    ce = (torch.logsumexp(sim, dim=1) - (sim * same).sum(1)).mean()
    reg = l2_reg * (a.square().sum(1).mean()
                    + p.square().sum(1).mean()) * 0.25
    return ce + reg


def _hsigmoid_codes(num_classes):
    """Per-class inner-node indices, signs (+1 left, -1 right) and mask
    along the path through the complete binary tree (heap order)."""
    n_inner = int(num_classes) - 1
    depth = max(int(np.ceil(np.log2(max(num_classes, 2)))), 1)
    codes = np.zeros((num_classes, depth), np.int64)
    signs = np.zeros((num_classes, depth), np.float32)
    mask = np.zeros((num_classes, depth), np.float32)
    for cls in range(num_classes):
        node = cls + n_inner
        path = []
        while node > 0 and len(path) < depth:
            parent = (node - 1) // 2
            path.append((parent, 1.0 if node == 2 * parent + 1 else -1.0))
            node = parent
        for i, (pn, sgn) in enumerate(reversed(path)):
            codes[cls, i] = pn
            signs[cls, i] = sgn
            mask[cls, i] = 1.0
    return codes, signs, mask


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False):
    """Hierarchical sigmoid over the default complete-binary-tree
    coding."""
    if path_table is not None or path_code is not None:
        raise NotImplementedError(
            "custom path_table/path_code hsigmoid is not supported; use the "
            "default complete-binary-tree coding")
    x, y, w, b = cast_inputs("hsigmoid_loss", input, label.detach(), weight,
                             bias)
    codes, signs, mask = (torch.from_numpy(a).to(x.device)
                          for a in _hsigmoid_codes(num_classes))
    y = y.long().reshape(-1)
    pc, sg, mk = codes[y], signs[y].to(x.dtype), mask[y].to(x.dtype)
    logits = torch.einsum("nd,nkd->nk", x, w[pc])
    if b is not None:
        logits = logits + b[pc]
    return (-TF.logsigmoid(sg * logits) * mk).sum(1).mean()


__all__ = [
    "binary_cross_entropy", "binary_cross_entropy_with_logits",
    "cosine_embedding_loss", "cross_entropy", "ctc_loss", "dice_loss",
    "gaussian_nll_loss", "hinge_embedding_loss", "hsigmoid_loss", "kl_div",
    "l1_loss", "log_loss", "margin_cross_entropy", "margin_ranking_loss",
    "mse_loss", "multi_label_soft_margin_loss", "multi_margin_loss",
    "nll_loss", "npair_loss", "poisson_nll_loss", "sigmoid_focal_loss",
    "smooth_l1_loss", "soft_margin_loss", "softmax_with_cross_entropy",
    "square_error_cost", "triplet_margin_loss",
    "triplet_margin_with_distance_loss",
]
