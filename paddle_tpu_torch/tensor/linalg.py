"""Linear algebra, the counterparts of ``paddle_tpu/tensor/linalg.py`` (all
of it; ``paddle_tpu_torch.linalg`` is the ``paddle.linalg`` namespace).

Each runs where its tensors lie, through ``torch.linalg`` (cuSOLVER and
cuBLAS on the card), computing ``jnp.linalg``'s function:

* ``lstsq`` is ``jnp.linalg.lstsq``: the minimum-norm solution through
  the SVD (singular values below ``rcond * s[0]`` dropped, rank-deficient
  inputs included; ``rcond`` None is ``eps * max(m, n)``), returning
  ``(solution, residuals, rank, singular_values)`` with the residuals
  ``|b - a x|^2`` of every column always (JAX's default, not NumPy's
  empty array), the rank int32.  On the card ``torch.linalg.lstsq`` has
  only the full-rank ``gels`` driver, so it is not used.
* ``lu`` is ``jax.scipy.linalg.lu_factor``: pivots 0-based (torch's and
  Paddle's are 1-based, LAPACK's); ``lu_unpack`` takes them so and
  returns ``P, L, U`` with ``x = P @ L @ U``.
* ``eig`` and ``eigvals`` return real tensors when every eigenvalue is
  real, as NumPy's (JAX runs ``numpy.linalg.eig``); the check is a host
  read.
* ``slogdet`` stacks ``[sign, logdet]``; ``matrix_norm`` ignores
  ``axis``; ``matrix_rank`` takes ``tol`` as an absolute threshold,
  ignores ``hermitian`` and returns int32;
  ``cov`` ignores the weights; ``pca_lowrank`` is the truncated full
  SVD; ``svd_lowrank`` multiplies by a Gaussian test matrix from a
  fixed key ``(0, 0)`` of the counter stream's generator, as JAX's
  draws from ``key(0)``, and leaves the stream alone.
* ``cdist``/``pdist`` take differences (JAX's accurate form; p = 2 is
  ``sqrt(max(sum d^2, 1e-30))``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import random as _random
from ..amp.auto_cast import cast_inputs
from .math import cross, dot, matmul  # noqa: F401  (paddle.linalg's)

__all__ = [
    "cdist", "cholesky", "cholesky_solve", "cond", "corrcoef", "cov",
    "cross", "det", "dot", "eig", "eigh", "eigvals", "eigvalsh",
    "householder_product", "inv", "lstsq", "lu", "lu_unpack", "matmul",
    "matrix_exp", "matrix_norm", "matrix_power", "matrix_rank",
    "multi_dot", "norm", "ormqr", "pca_lowrank", "pdist", "pinv", "qr",
    "slogdet", "solve", "svd", "svd_lowrank", "svdvals",
    "triangular_solve", "vector_norm",
]


def norm(x, p=None, axis=None, keepdim=False):
    """``jnp.linalg.norm``: the 2-norm (or ``p``-norm) of the flattened
    tensor for a None axis (``keepdim`` ignored there, as JAX's), a
    vector norm over an int axis, a matrix norm (``"fro"`` by default)
    over two."""
    (x,) = cast_inputs("norm", x)
    if axis is None:
        return torch.linalg.vector_norm(x.reshape(-1), 2 if p is None else p)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if isinstance(ax, tuple) and len(ax) == 1:
        ax = ax[0]
    o = p if p is not None else (2 if isinstance(ax, int) else "fro")
    if isinstance(ax, int):
        return torch.linalg.vector_norm(x, 2 if o == "fro" else o, ax,
                                        keepdim=keepdim)
    return torch.linalg.matrix_norm(x, o, ax, keepdim=keepdim)


def vector_norm(x, p=2.0, axis=None, keepdim=False):
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    return torch.linalg.vector_norm(x, p, ax, keepdim=keepdim)


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False):
    """Over the last two dims (``axis`` ignored, as JAX's)."""
    return torch.linalg.matrix_norm(x, p, (-2, -1), keepdim=keepdim)


def cond(x, p=None):
    return torch.linalg.cond(x, p)


def det(x):
    return torch.linalg.det(x)


def slogdet(x):
    sign, logdet = torch.linalg.slogdet(x)
    return torch.stack([sign, logdet])


def inv(x):
    return torch.linalg.inv(x)


def pinv(x, rcond=1e-15, hermitian=False):
    return torch.linalg.pinv(x, rtol=rcond, hermitian=hermitian)


def svd(x, full_matrices=False):
    """``(u, s, vh)``."""
    u, s, vh = torch.linalg.svd(x, full_matrices=full_matrices)
    return u, s, vh


def svdvals(x):
    return torch.linalg.svdvals(x)


def qr(x, mode="reduced"):
    """``(q, r)``, or ``r`` alone for ``mode="r"``."""
    q, r = torch.linalg.qr(x, mode=mode)
    return r if mode == "r" else (q, r)


def _all_real(w):
    """NumPy's eig rule (a host read): real results when every
    eigenvalue's imaginary part is 0."""
    return not bool((w.imag != 0).any())


def eig(x):
    """``(values, vectors)``; both real when every eigenvalue is."""
    w, v = torch.linalg.eig(x)
    return (w.real, v.real) if _all_real(w) else (w, v)


def eigh(x, UPLO="L"):
    w, v = torch.linalg.eigh(x, UPLO)
    return w, v


def eigvals(x):
    w = torch.linalg.eigvals(x)
    return w.real if _all_real(w) else w


def eigvalsh(x, UPLO="L"):
    return torch.linalg.eigvalsh(x, UPLO)


def cholesky(x, upper=False):
    return torch.linalg.cholesky(x, upper=upper)


def cholesky_solve(x, y, upper=False):
    """Solve ``a z = x`` from ``a``'s Cholesky factor ``y``."""
    return torch.cholesky_solve(x, y, upper=upper)


def solve(x, y):
    return torch.linalg.solve(x, y)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False):
    """Solve ``x z = y`` (``x^T z = y`` with ``transpose``) for
    triangular ``x``."""
    if transpose:
        x, upper = x.mT, not upper
    return torch.linalg.solve_triangular(x, y, upper=upper,
                                         unitriangular=unitriangular)


def lstsq(x, y, rcond=None, driver=None):
    """``jnp.linalg.lstsq`` (see the module docstring); ``driver`` is
    ignored.  Leading batch dims are taken too (JAX's is 2-D only)."""
    dt = torch.promote_types(x.dtype, y.dtype)
    if not dt.is_floating_point and not dt.is_complex:
        dt = torch.get_default_dtype()
    a, b = x.to(dt), y.to(dt)
    vec = b.dim() == a.dim() - 1
    if vec:
        b = b[..., None]
    m, n = a.shape[-2:]
    eps = torch.finfo(a.dtype).eps
    rc = eps * max(m, n) if rcond is None else (eps if rcond < 0 else rcond)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= torch.tensor(rc, dtype=s.dtype,
                                        device=s.device) * s[..., :1])
    rank = mask.sum(-1).to(torch.int32)
    safe_s = torch.where(mask, s, torch.ones_like(s)).to(a.dtype)
    s_inv = torch.where(mask, 1 / safe_s, torch.zeros_like(safe_s))[..., None]
    sol = vt.mH @ (s_inv * (u.mH @ b))
    resid = torch.linalg.vector_norm(b - a @ sol, dim=-2) ** 2
    if vec:
        sol = sol[..., 0]
    return sol, resid, rank, s


def lu(x, pivot=True, get_infos=False):
    """``(lu, pivots)`` with 0-based int32 pivots (``lu_factor``'s);
    with ``get_infos`` also a ``[1]`` int32 zero."""
    lu_mat, piv = torch.linalg.lu_factor(x)
    piv = (piv - 1).to(torch.int32)
    if get_infos:
        return lu_mat, piv, torch.zeros(1, dtype=torch.int32,
                                        device=x.device)
    return lu_mat, piv


def lu_unpack(lu_data, lu_pivots, unpack_ludata=True, unpack_pivots=True):
    """``(P, L, U)`` from :func:`lu`'s factors (0-based pivots)."""
    P, L, U = torch.lu_unpack(lu_data, (lu_pivots + 1).to(torch.int32))
    return (P if unpack_pivots else None,
            L if unpack_ludata else None,
            U if unpack_ludata else None)


def matrix_power(x, n):
    return torch.linalg.matrix_power(x, n)


def matrix_rank(x, tol=None, hermitian=False):
    """``jnp.linalg.matrix_rank(x, rtol=tol)``: the singular values
    above ``tol`` as an absolute threshold (JAX's; Paddle's ``tol`` is
    absolute too), or above ``s_max * max(m, n) * eps`` without one;
    int32.  ``hermitian`` is ignored, as JAX's."""
    a = x if x.is_floating_point() or x.is_complex() else x.to(
        torch.get_default_dtype())
    if a.dim() < 2:
        return (a != 0).any().to(torch.int32)
    s = torch.linalg.svdvals(a)
    if tol is None:
        thr = (s.amax(-1) * max(a.shape[-2:])
               * torch.finfo(s.dtype).eps)[..., None]
    else:
        thr = tol
    return torch.sum(s > thr, -1).to(torch.int32)


def multi_dot(x):
    return torch.linalg.multi_dot(list(x))


def pca_lowrank(x, q=None, center=True, niter=2):
    """The first ``q`` (default ``min(6, m, n)``) singular triplets of
    the column-centred ``x``, from its full SVD: ``(u, s, v)``."""
    qv = q if q is not None else min(6, x.shape[-2], x.shape[-1])
    m = x - x.mean(-2, keepdim=True) if center else x
    u, s, vt = torch.linalg.svd(m, full_matrices=False)
    return u[..., :qv], s[..., :qv], vt.mT[..., :qv]


def corrcoef(x, rowvar=True):
    return torch.corrcoef(x if rowvar else x.mT)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None):
    """The weights are ignored, as JAX's."""
    return torch.cov(x if rowvar else x.mT, correction=1 if ddof else 0)


def householder_product(x, tau):
    return torch.linalg.householder_product(x, tau)


def _p_reduce(d, p):
    """``d`` reduced over its last dim to the p-distance."""
    if p == 0:
        return torch.sum((d != 0).to(d.dtype), -1)
    if math.isinf(p):
        return torch.amax(torch.abs(d), -1)
    if p == 1:
        return torch.sum(torch.abs(d), -1)
    if p == 2:
        return torch.sqrt(torch.clamp(torch.sum(d * d, -1), min=1e-30))
    return torch.sum(torch.abs(d) ** p, -1) ** (1.0 / p)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary"):
    """``[..., P, M] x [..., R, M] -> [..., P, R]`` p-distances of the
    differences (``compute_mode`` ignored, as JAX's)."""
    return _p_reduce(x[..., :, None, :] - y[..., None, :, :], p)


def pdist(x, p=2.0):
    """The strict upper triangle of ``cdist(x, x)``, row by row."""
    iu, ju = np.triu_indices(x.shape[0], k=1)
    iu = torch.from_numpy(iu).to(x.device)
    ju = torch.from_numpy(ju).to(x.device)
    return _p_reduce(x[iu] - x[ju], p)


def matrix_exp(x):
    return torch.linalg.matrix_exp(x)


def ormqr(x, tau, y, left=True, transpose=False):
    """``Q @ y``, ``Q^T @ y``, ``y @ Q`` or ``y @ Q^T``, ``Q`` from the
    Householder factors ``(x, tau)``."""
    return torch.ormqr(x, tau, y, left=left, transpose=transpose)


def svd_lowrank(x, q=6, niter=2, M=None):
    """Randomized truncated SVD by subspace iteration (QR after every
    product) from a Gaussian ``[n, k]`` test matrix of the fixed key
    ``(0, 0)``; ``M`` is subtracted first.  ``(u, s, v)``."""
    a = x - M if M is not None else x
    n = a.shape[-1]
    k = min(q, a.shape[-2], n)
    omega = torch.randn(n, k, dtype=a.dtype, device=a.device,
                        generator=_random.generator((0, 0), a.device))
    qmat = torch.linalg.qr(a @ omega).Q
    for _ in range(niter):
        z = torch.linalg.qr(a.mT @ qmat).Q
        qmat = torch.linalg.qr(a @ z).Q
    u_b, s, vh = torch.linalg.svd(qmat.mT @ a, full_matrices=False)
    return qmat @ u_b, s, vh.mT
