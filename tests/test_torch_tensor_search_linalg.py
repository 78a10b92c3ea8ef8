"""The port's search, linalg, fft, signal and random functions against the
JAX package's on numpy-seeded inputs on the CPU.

Search holds JAX's tie rules exactly on planted ties (``topk`` takes the
lower index first, ``argsort(descending=True)`` flips a stable ascending
sort, ``kthvalue`` indexes the stable sort, ``mode`` returns counts,
``median`` averages the two middle values at even lengths).  Linear
algebra holds every function; where the factors are unique only up to
signs or phases (``svd``, ``qr``, ``eigh``, ``pca_lowrank``) the cases
compare what is unique (values, reconstructions, ``Q^T Q``, ``|R|``),
``lstsq`` runs rank-deficient inputs (its minimum-norm solution is
unique) and ``lu`` is held factor for factor, pivots exactly, with
``lu_unpack`` round trips.  ``fft`` runs every name under every
``norm``; ``stft``/``istft`` cover ``center``, ``pad_mode``, short
windows, ``normalized`` and ``onesided``.  Tolerance 1e-5 of the
reference's largest magnitude (1e-4 for the decompositions, whose
LAPACK and XLA orders differ).  The random functions draw from the
port's counter stream (bits differ from JAX's by design): they are held
to JAX's shapes and dtypes, to their ranges and moments over a few
thousand draws, and to seeded reproducibility.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.fft as JFFT
import paddle_tpu.linalg as JLA
import paddle_tpu.signal as JSIG
import paddle_tpu.tensor as J
import paddle_tpu_torch as pt
import paddle_tpu_torch.fft as TFFT
import paddle_tpu_torch.linalg as TLA
import paddle_tpu_torch.signal as TSIG
import paddle_tpu_torch.tensor as T

from _torch_jax_table import check_case, close, compare, jax_table
from _torch_port_util import one_thread  # noqa: F401

DECOMP_REL = 1e-4
MODULES = {"J": (J, JLA, JFFT, JSIG), "T": (T, TLA, TFFT, TSIG)}


def _f(*shapes, seed=0, lo=-2.0, hi=2.0):
    r = np.random.RandomState(seed)
    return [r.uniform(lo, hi, s).astype(np.float32) for s in shapes]


def _spd(n, seed=0, batch=()):
    a = np.random.RandomState(seed).randn(*batch, n, n).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n, dtype=np.float32))


CASES = {}


def _reg(family, name, call, arrays, grad=False):
    """``call(tensor_module, linalg, fft, signal, *args)`` of each
    package."""
    CASES[f"{family}|{name}"] = (lambda *a: call(*MODULES["J"], *a),
                                 lambda *a: call(*MODULES["T"], *a),
                                 list(arrays), grad)


# ----- search, with planted ties -----
TIES = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0],
                 [2.0, 2.0, 2.0, 2.0, 1.0, 1.0],
                 [5.0, -1.0, 5.0, -1.0, 0.0, 5.0]], np.float32)
for _ax in (None, 0, 1):
    for _kd in (False, True):
        _reg("search", f"argmax_argmin_{_ax}_{int(_kd)}",
             lambda m, la, f, s, a, ax=_ax, kd=_kd: (
                 m.argmax(a, ax, kd), m.argmin(a, ax, kd)), [TIES])
for _ax in (0, 1, -1):
    for _desc in (False, True):
        _reg("search", f"argsort_sort_{_ax}_{int(_desc)}",
             lambda m, la, f, s, a, ax=_ax, d=_desc: (
                 m.sort(a, ax, d), m.argsort(a, ax, d)), [TIES], True)
for _k, _ax, _lg in ((2, -1, True), (3, -1, False), (2, 0, True),
                     (1, 0, False), (6, 1, True)):
    _reg("search", f"topk_{_k}_{_ax}_{int(_lg)}",
         lambda m, la, f, s, a, k=_k, ax=_ax, lg=_lg: m.topk(
             a, k, ax, lg), [TIES], True)
_reg("search", "topk_1d", lambda m, la, f, s, a: m.topk(a, 2),
     [np.array([1.0, 3.0, 3.0, 2.0], np.float32)], True)
_reg("search", "topk_random", lambda m, la, f, s, a: m.topk(a, 5, 0),
     _f((9, 4)), True)
for _k, _ax in ((1, -1), (3, -1), (2, 0), (4, 1)):
    for _kd in (False, True):
        _reg("search", f"kthvalue_{_k}_{_ax}_{int(_kd)}",
             lambda m, la, f, s, a, k=_k, ax=_ax, kd=_kd: m.kthvalue(
                 a, k, ax, kd), [TIES], True)
_SORTED = np.sort(_f((12,), seed=3)[0])
_reg("search", "searchsorted",
     lambda m, la, f, s, q, v: (m.searchsorted(q, v),
                                m.searchsorted(q, v, right=True),
                                m.bucketize(v, q)),
     [_SORTED, np.concatenate([_f((5,), seed=4)[0], _SORTED[[2, 7]]])])
_reg("search", "searchsorted_batched",
     lambda m, la, f, s, q, v: m.searchsorted(q, v, right=True),
     [np.sort(_f((3, 6), seed=5)[0], -1), _f((3, 4), seed=6)[0]])
for _shape in ((3, 6), (3, 7)):
    for _ax in (None, 0, 1):
        for _kd in (False, True):
            _reg("search", f"median_{_shape[1]}_{_ax}_{int(_kd)}",
                 lambda m, la, f, s, a, ax=_ax, kd=_kd: (
                     m.median(a, ax, kd), m.median(a, ax, kd, mode="min")),
                 _f(_shape, seed=_shape[1]), True)
_NAN = np.array([[1.0, np.nan, 3.0, 2.0], [np.nan, np.nan, 1.0, 5.0],
                 [4.0, 0.5, 2.5, 1.0]], np.float32)
_reg("search", "nanmedian", lambda m, la, f, s, a: (
    m.nanmedian(a, 1), m.nanmedian(a), m.median(a, 1)), [_NAN])
for _meth in ("linear", "lower", "higher", "midpoint", "nearest"):
    for _q, _ax, _kd in ((0.3, None, False), ([0.1, 0.5, 0.9], 1, True),
                         (0.75, (0, 2), False), ([0.25, 0.5], (0, 2), True),
                         (0.5, 2, False)):
        _reg("search", f"quantile_{_meth}_{_q}_{_ax}_{int(_kd)}",
             lambda m, la, f, s, a, q=_q, ax=_ax, kd=_kd, me=_meth: (
                 m.quantile(a, q, ax, kd, me)), _f((2, 3, 4), seed=7), True)
    _reg("search", f"nanquantile_{_meth}",
         lambda m, la, f, s, a, me=_meth: (
             m.nanquantile(a, [0.2, 0.7], 1, False, me),
             m.nanquantile(a, 0.4, None, True, me)), [_NAN])
_reg("search", "histogram", lambda m, la, f, s, a: (
    m.histogram(a, 7), m.histogram(a, 5, -1.0, 1.0), m.histogram(a * 0, 3)),
     _f((40,), seed=8))

# ----- linear algebra -----
LINALG = {
    "norm_default": (lambda m, la, a: la.norm(a), [(3, 4)], True),
    "norm_p1": (lambda m, la, a: la.norm(a, 1), [(3, 4)], True),
    "norm_axis": (lambda m, la, a: (la.norm(a, axis=1), la.norm(
        a, 1, 0, True), la.norm(a, float("inf"), 1),
        la.norm(a, 0, -1)), [(3, 4)], True),
    "norm_matrix": (lambda m, la, a: (la.norm(a, axis=[0, 1]), la.norm(
        a, "nuc", (0, 1)), la.norm(a, 1, [0, 1], True), la.norm(
        a, float("inf"), (0, 1)), la.norm(a, 2, (0, 1))), [(3, 4)], True),
    "vector_matrix_norm": (lambda m, la, a: (
        la.vector_norm(a), la.vector_norm(a, 3.0, [0, 2], True),
        la.matrix_norm(a), la.matrix_norm(a, "nuc"), la.matrix_norm(
            a, 1, keepdim=True)), [(2, 3, 4)], True),
    "cond": (lambda m, la, a: (la.cond(a), la.cond(a, "fro"), la.cond(a, 1)),
             [(4, 4)], False),
    "det_slogdet_inv": (lambda m, la, a: (la.det(a), la.slogdet(a),
                                          la.inv(a)), [(2, 4, 4)], True),
    "pinv": (lambda m, la, a: la.pinv(a), [(5, 3)], True),
    "matrix_power": (lambda m, la, a: (la.matrix_power(a, 3),
                                       la.matrix_power(a, 0),
                                       la.matrix_power(a, -2)),
                     [(3, 3)], True),
    "multi_dot": (lambda m, la, a, b, c: la.multi_dot([a, b, c]),
                  [(3, 4), (4, 5), (5, 2)], True),
    "corrcoef_cov": (lambda m, la, a: (la.corrcoef(a), la.corrcoef(
        a, False), la.cov(a), la.cov(a, False, False)), [(3, 6)], True),
    "cdist": (lambda m, la, a, b: (la.cdist(a, b), la.cdist(a, b, 1.0),
                                   la.cdist(a, b, float("inf")),
                                   la.cdist(a, b, 0.0), la.cdist(a, b, 3.0)),
              [(2, 4, 3), (2, 5, 3)], True),
    "pdist": (lambda m, la, a: (la.pdist(a), la.pdist(a, 1.0),
                                la.pdist(a, 2.5)), [(5, 3)], True),
    "solve": (lambda m, la, a, b, c: (la.solve(a, b), la.solve(a, c)),
              [(4, 4), (4, 2), (4,)], True),
    "solve_batched": (lambda m, la, a, b: la.solve(a, b),
                      [(2, 3, 3), (2, 3, 2)], True),
    "triangular_solve": (lambda m, la, a, b: (
        la.triangular_solve(m.triu(a), b),
        la.triangular_solve(m.tril(a), b, upper=False),
        la.triangular_solve(m.triu(a), b, transpose=True),
        la.triangular_solve(m.tril(a), b, False, False, True)),
        [(4, 4), (4, 3)], True),
    "matrix_exp": (lambda m, la, a: la.matrix_exp(a * 0.3), [(2, 3, 3)],
                   True),
    "householder_ormqr": (lambda m, la, a, t, c, d: (
        la.householder_product(a, t), la.ormqr(a, t, c),
        la.ormqr(a, t, c, transpose=True), la.ormqr(a, t, d, left=False),
        la.ormqr(a, t, d, False, True)),
        [(5, 3), (3,), (5, 2), (2, 5)], True),
}
for _c, (_fn, _shapes, _g) in LINALG.items():
    _reg("linalg", _c, lambda m, la, f, s, *a, fn=_fn: fn(m, la, *a),
         _f(*_shapes, seed=len(_c)) if _c != "triangular_solve" else
         [_f((4, 4), seed=1)[0] + 4 * np.eye(4, dtype=np.float32),
          _f((4, 3), seed=2)[0]], _g)
_reg("linalg", "cholesky", lambda m, la, f, s, a, b: (
    la.cholesky(a), la.cholesky(a, upper=True),
    la.cholesky_solve(b, la.cholesky(a)),
    la.cholesky_solve(b, la.cholesky(a, upper=True), upper=True)),
     [_spd(4), _f((4, 2))[0]], True)
_reg("linalg", "eigvalsh_grad", lambda m, la, f, s, a: (
    la.eigvalsh(a), la.eigvalsh(a, "U"), la.svdvals(a)), [_spd(4, 1)], True)
_RANK2 = (_f((6, 2), seed=9)[0] @ _f((2, 4), seed=10)[0]).astype(np.float32)
_reg("linalg", "matrix_rank", lambda m, la, f, s, a, b: (
    la.matrix_rank(a), la.matrix_rank(b), la.matrix_rank(b, 0.5)),
     [_RANK2, _f((4, 4))[0]])


def _tr(m, a):
    return m.swapaxes(a, -1, -2)


def _svd_inv(m, la, f, s, a):
    u, sv, vh = la.svd(a)
    uf, sf, vhf = la.svd(a, full_matrices=True)
    return (sv, m.matmul(u * m.unsqueeze(sv, -2), vh),
            m.matmul(_tr(m, u), u), m.matmul(vh, _tr(m, vh)), sf,
            m.matmul(_tr(m, uf), uf))


def _qr_inv(m, la, f, s, a):
    q, r = la.qr(a)
    qc, rc = la.qr(a, "complete")
    return (m.matmul(q, r), m.matmul(_tr(m, q), q), m.abs(r),
            m.matmul(qc, rc), m.abs(la.qr(a, "r")))


def _eigh_inv(m, la, f, s, a):
    w, v = la.eigh(a)
    return (w, m.matmul(v * m.unsqueeze(w, -2), _tr(m, v)),
            m.matmul(_tr(m, v), v), la.eigh(a, "U")[0])


def _lu_all(m, la, f, s, a):
    lu, piv = la.lu(a)
    p, l_, u = la.lu_unpack(lu, piv)
    _, _, info = la.lu(a, get_infos=True)
    return (lu, piv, p, l_, u, m.matmul(p, m.matmul(l_, u)), info,
            la.lu_unpack(lu, piv, False, True)[0])


def _lstsq(m, la, f, s, a, b):
    return la.lstsq(a, b)


def _lowrank(m, la, f, s, a):
    u, sv, v = la.pca_lowrank(a, 3, center=False)
    uc, sc, vc = la.pca_lowrank(a)
    lu, ls, lv = la.svd_lowrank(a, 3)
    return (sv, m.matmul(u * m.unsqueeze(sv, -2), _tr(m, v)), sc,
            m.matmul(uc * m.unsqueeze(sc, -2), _tr(m, vc)), ls,
            m.matmul(lu * m.unsqueeze(ls, -2), _tr(m, lv)))


_RANK3 = (_f((8, 3), seed=11)[0] @ _f((3, 6), seed=12)[0]).astype(
    np.float32)
_reg("decomp", "svd", _svd_inv, _f((2, 5, 3), seed=13))
_reg("decomp", "svd_wide", _svd_inv, _f((3, 5), seed=14))
_reg("decomp", "qr", _qr_inv, _f((5, 3), seed=15))
_reg("decomp", "qr_batched", _qr_inv, _f((2, 4, 4), seed=16))
_reg("decomp", "eigh", _eigh_inv, [_spd(5, 2, (2,))])
_reg("decomp", "lu", _lu_all, _f((5, 5), seed=17))
_reg("decomp", "lu_batched", _lu_all, _f((3, 4, 4), seed=18))
_reg("decomp", "lu_wide", _lu_all, _f((3, 5), seed=19))
_reg("decomp", "lu_tall", _lu_all, _f((5, 3), seed=20))
_reg("decomp", "lstsq_full", _lstsq, _f((6, 3), (6, 2), seed=21))
_reg("decomp", "lstsq_vector", _lstsq, _f((6, 3), (6,), seed=22))
_reg("decomp", "lstsq_deficient", _lstsq, [_RANK2, _f((6, 2), seed=23)[0]])
# underdetermined: the residuals are rounding noise about 0 in both
_reg("decomp", "lstsq_under", lambda m, la, f, s, a, b: [
    la.lstsq(a, b)[i] for i in (0, 2, 3)], _f((3, 5), (3, 2), seed=24))
_reg("decomp", "lowrank", _lowrank, [_RANK3])

# ----- fft: every name under every norm -----
_CPLX = (np.random.RandomState(30).randn(3, 8)
         + 1j * np.random.RandomState(31).randn(3, 8)).astype(np.complex64)
_CPLX3 = (np.random.RandomState(32).randn(2, 4, 6)
          + 1j * np.random.RandomState(33).randn(2, 4, 6)).astype(
    np.complex64)
for _norm in ("backward", "ortho", "forward"):
    _reg("fft", f"1d_{_norm}", lambda m, la, f, s, x, c, nm=_norm: (
        f.fft(x, norm=nm), f.fft(c, 5, 0, nm), f.ifft(c, norm=nm),
        f.ifft(x, 10, -1, nm), f.rfft(x, norm=nm), f.rfft(x, 6, 0, nm),
        f.irfft(c, norm=nm), f.irfft(c, 9, -1, nm), f.hfft(c, norm=nm),
        f.hfft(c, 6, 0, nm), f.ihfft(x, norm=nm), f.ihfft(x, 5, 1, nm)),
         [_f((3, 8), seed=34)[0], _CPLX])
    _reg("fft", f"nd_{_norm}", lambda m, la, f, s, x, c, nm=_norm: (
        f.fft2(x, axes=(-2, -1), norm=nm),
        f.fft2(c, (3, 4), (1, 2), norm=nm),
        f.ifft2(c, axes=(0, 2), norm=nm),
        f.rfft2(x, axes=(-2, -1), norm=nm),
        f.rfft2(x, (4, 4), (0, 1), nm), f.irfft2(c, axes=(1, 2), norm=nm),
        f.irfft2(c, (2, 6), (-2, -1), norm=nm), f.fftn(x, norm=nm),
        f.fftn(c, (3, 5), norm=nm), f.ifftn(c, axes=[1, 2], norm=nm),
        f.rfftn(x, norm=nm), f.rfftn(x, (2, 4, 6), norm=nm),
        f.irfftn(c, norm=nm), f.irfftn(c, (4, 8), (1, 2), nm)),
         [_f((2, 4, 6), seed=35)[0], _CPLX3])
_reg("fft", "real_out_grad", lambda m, la, f, s, x: (
    f.irfft(f.rfft(x)), f.fftshift(x), f.ifftshift(x, axes=[0]),
    f.fftshift(x, 1)), _f((4, 6), seed=36), True)
_reg("fft", "freq", lambda m, la, f, s: (
    f.fftfreq(8), f.fftfreq(7, 0.5), f.rfftfreq(8), f.rfftfreq(9, 2.0))
    if m is J else (f.fftfreq(8, device="cpu"),
                    f.fftfreq(7, 0.5, device="cpu"),
                    f.rfftfreq(8, device="cpu"),
                    f.rfftfreq(9, 2.0, device="cpu")), [])
_reg("fft", "float_int_input", lambda m, la, f, s, x: (
    f.fft(m.cast(x, "int32")), f.fft(m.cast(x, "bfloat16"))),
     _f((2, 8), seed=37, lo=-9, hi=9))

# ----- signal -----
_SIG = _f((2, 400), seed=40)[0]
_HANN = np.hanning(64).astype(np.float32)
_SHORT = np.hanning(40).astype(np.float32)
STFT = {
    "default": dict(n_fft=64),
    "hann_hop": dict(n_fft=64, hop_length=16, window="hann"),
    "short_window": dict(n_fft=64, hop_length=20, win_length=40,
                         window="short"),
    "no_center": dict(n_fft=64, hop_length=32, center=False,
                      window="hann"),
    "constant_pad": dict(n_fft=64, pad_mode="constant", window="hann"),
    "normalized": dict(n_fft=64, normalized=True, window="hann"),
    "two_sided": dict(n_fft=64, onesided=False, window="hann"),
    "two_sided_norm": dict(n_fft=32, hop_length=8, onesided=False,
                           normalized=True),
}


def _stft_case(kw):
    kw = dict(kw)
    win = kw.pop("window", None)
    win_arr = {"hann": _HANN, "short": _SHORT}.get(win)

    def call(m, la, f, s, x, *w):
        spec = s.stft(x, window=w[0] if w else None, **kw)
        ikw = {k: v for k, v in kw.items() if k != "pad_mode"}
        back = s.istft(spec, window=w[0] if w else None, length=400, **ikw)
        short = s.istft(spec, window=w[0] if w else None, **ikw)
        return spec, back, short
    return call, [_SIG] + ([win_arr] if win_arr is not None else [])


for _c, _kw in STFT.items():
    _call, _arrs = _stft_case(_kw)
    _reg("signal", _c, _call, _arrs)
_reg("signal", "istft_complex", lambda m, la, f, s, x: s.istft(
    s.stft(x, 32, onesided=False), 32, onesided=False, return_complex=True),
     [_SIG])

# ----- random: JAX's shapes and dtypes (the bits differ by design) -----


def _rand_calls(m, la, f, s, x, xi, p):
    dev = {} if m is J else {"device": "cpu"}
    return (m.rand([2, 3], **dev), m.randn([4], **dev),
            m.standard_normal([2, 2], "float32", **dev),
            m.normal(0.5, 2.0, [3], **dev), m.normal(x, 2.0),
            m.uniform([3, 2], min=-2.0, max=3.0, **dev),
            m.uniform([5], seed=7, **dev), m.randint(0, 5, [4], **dev),
            m.randint(7, shape=[2, 2], **dev), m.randint_like(xi, 0, 4),
            m.randperm(6, **dev), m.multinomial(p, 3),
            m.multinomial(p, 4, True), m.bernoulli(x * 0.5),
            m.poisson(x * 3.0), m.rand_like(x), m.randn_like(x, "float32"),
            m.gumbel_softmax(x, hard=True))


_reg("random", "draws", _rand_calls,
     [np.ones((3, 4), np.float32), np.ones((3, 4), np.int32),
      np.full((2, 5), 0.2, np.float32)])


@pytest.fixture(scope="module")
def jax_refs():
    return jax_table(CASES)


def _keys(family):
    return sorted(k for k in CASES if k.startswith(family + "|"))


@pytest.mark.parametrize("key", _keys("search"))
def test_search_matches_jax_ties_included(jax_refs, key):
    check_case(jax_refs, key)


@pytest.mark.parametrize("key", _keys("linalg"))
def test_linalg_matches_jax(jax_refs, key):
    check_case(jax_refs, key, DECOMP_REL)


@pytest.mark.parametrize("key", _keys("decomp"))
def test_decomposition_invariants_match_jax(jax_refs, key):
    check_case(jax_refs, key, DECOMP_REL)


@pytest.mark.parametrize("key", _keys("fft"))
def test_fft_matches_jax(jax_refs, key):
    check_case(jax_refs, key, 1e-5 if "int" not in key else 1e-2)


@pytest.mark.parametrize("key", _keys("signal"))
def test_stft_istft_match_jax(jax_refs, key):
    """1e-4: ``istft`` divides by the window envelope, which is near 0
    at the ends of an uncentred signal and magnifies the summation
    order's rounding there."""
    check_case(jax_refs, key, 1e-4)


def test_fft2_family_without_axes():
    """JAX's ``fft2``/``ifft2``/``rfft2``/``irfft2`` pass ``axes=None`` on
    to ``jnp.fft``, which raises (a reference fault, ``ROADMAP.md`` Queue
    3); the port takes Paddle's default, the last two axes, which is
    JAX's function with ``axes=(-2, -1)``."""
    x = _f((2, 4, 6), seed=38)[0]
    for name in ("fft2", "ifft2", "rfft2", "irfft2"):
        with pytest.raises(TypeError):
            getattr(JFFT, name)(paddle.to_tensor(x))
        close(getattr(TFFT, name)(torch.from_numpy(x)),
              getattr(JFFT, name)(paddle.to_tensor(x), axes=(-2, -1)),
              name)


def test_tie_rules_by_hand():
    """The rules the module docstrings state, on ``[1, 3, 3, 2]``."""
    x = torch.tensor([1.0, 3.0, 3.0, 2.0])
    assert T.topk(x, 2)[1].tolist() == [1, 2]
    assert T.topk(x, 2, largest=False)[1].tolist() == [0, 3]
    assert T.argsort(x, descending=True).tolist() == [2, 1, 3, 0]
    assert T.argsort(x).tolist() == [0, 3, 1, 2]
    assert T.kthvalue(x, 3)[1].tolist() == 1
    v, c = T.mode(torch.tensor([[1.0, 2.0, 2.0, 3.0, 3.0]]))
    assert v.tolist() == [2.0] and c.tolist() == [2] and c.dtype == \
        torch.int32
    assert T.median(x).item() == 2.5


def test_accuracy_ranks_equal_scores_lower_index_first():
    """Repaired: ``metric.Accuracy`` ranked with ``torch.topk``, whose
    order among equal scores is unspecified on the card (and on the CPU
    is neither JAX's numpy order nor a stable one), so equal scores
    could count as a hit on one device and a miss on another.  It ranks
    with ``tensor.topk`` now: the lower index first, on every device.
    JAX's ranks by NumPy's default (unstable) argsort, whose tie order
    is machine-dependent (``ROADMAP.md`` Queue 3)."""
    from paddle_tpu_torch.metric import Accuracy

    pred = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.0, 3.0],
                     [2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    label = np.array([[4], [3]], np.int64)
    stable = np.argsort(-pred, axis=-1, kind="stable")[..., :3]
    want = (stable == label).astype(np.float32)
    got = Accuracy(topk=(1, 3)).compute(torch.from_numpy(pred),
                                        torch.from_numpy(label))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0].tolist() == [0.0, 0.0, 1.0] and want[1].sum() == 0


def test_mode_and_histogramdd_match_jax():
    """``mode`` (counts, not indices) and ``histogramdd`` run on the host
    in both packages."""
    r = np.random.RandomState(50)
    a = r.randint(0, 4, (3, 5, 6)).astype(np.float32)
    for ax in (-1, 0, 1):
        for kd in (False, True):
            compare(T.mode(torch.from_numpy(a), ax, kd),
                    J.mode(paddle.to_tensor(a), ax, kd), f"mode {ax} {kd}")
    pts = r.randn(50, 2).astype(np.float32)
    w = r.rand(50).astype(np.float32)
    for kw in (dict(bins=4), dict(bins=[3, 5], ranges=[(-2, 2), (-1, 3)]),
               dict(bins=3, density=True)):
        compare(T.histogramdd(torch.from_numpy(pts), **kw),
                J.histogramdd(paddle.to_tensor(pts), **kw), f"hdd {kw}")
    compare(T.histogramdd(torch.from_numpy(pts), 3,
                          weights=torch.from_numpy(w)),
            J.histogramdd(paddle.to_tensor(pts), 3,
                          weights=paddle.to_tensor(w)), "hdd weights")


@pytest.mark.parametrize("case", ["general", "symmetric"])
def test_eig_matches_jax(case):
    """``eig``/``eigvals``: JAX runs NumPy (real results when every
    eigenvalue is real); the port ``torch.linalg.eig`` where the tensor
    lies, with NumPy's rule."""
    a = _f((4, 4), seed=60)[0] if case == "general" else _spd(4, 61)
    jw, jv = JLA.eig(paddle.to_tensor(a))
    tw, tv = TLA.eig(torch.from_numpy(a))
    order = lambda w: np.lexsort((np.imag(w), np.real(w)))  # noqa: E731
    jw_, tw_ = np.asarray(jw.numpy()), tw.numpy()
    assert tw_.dtype == jw_.dtype, (tw_.dtype, jw_.dtype)
    close(tw_[order(tw_)], jw_[order(jw_)], f"eig {case}", DECOMP_REL)
    close(TLA.eigvals(torch.from_numpy(a)).numpy()[order(tw_)],
          np.asarray(JLA.eigvals(paddle.to_tensor(a)).numpy())[order(jw_)],
          "eigvals", DECOMP_REL)
    at = torch.from_numpy(a).to(tv.dtype)
    np.testing.assert_allclose((at @ tv).numpy(), (tv * tw).numpy(),
                               atol=1e-4)


def test_lu_pivots_are_zero_based_as_jax():
    """JAX's ``lu`` is ``lu_factor`` (0-based pivots, where torch's and
    Paddle's are 1-based); ``lu_unpack`` reverses exactly what ``lu``
    gives."""
    a = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
    lu, piv = TLA.lu(a)
    assert piv.tolist() == [1, 1] and piv.dtype == torch.int32
    p, l_, u = TLA.lu_unpack(lu, piv)
    assert torch.equal(p @ l_ @ u, a)


def test_random_shapes_and_dtypes_match_jax(jax_refs):
    """Every draw's shape and dtype equal JAX's (its values are the
    counter stream's)."""
    tfn, arrays, _, _, jout, _ = jax_refs["random|draws"]
    got = tfn(*[torch.from_numpy(a) for a in arrays])
    assert [(tuple(g.shape), str(g.dtype).split(".")[1]) for g in got] == [
        (tuple(np.shape(w)), str(np.asarray(w).dtype)) for w in jout]


def test_random_ranges_moments_and_reproducibility():
    dev = {"device": "cpu"}
    pt.seed(11)
    state = pt.get_rng_state()
    a = T.rand([4000], **dev)
    pt.set_rng_state(state)
    assert torch.equal(T.rand([4000], **dev), a)
    assert 0.0 <= a.min() and a.max() < 1.0 and abs(a.mean() - 0.5) < 0.02
    z = T.randn([4000], **dev)
    assert abs(z.mean()) < 0.06 and abs(z.std() - 1) < 0.05
    nrm = T.normal(1.5, 0.5, [4000], **dev)
    assert abs(nrm.mean() - 1.5) < 0.03 and abs(nrm.std() - 0.5) < 0.03
    u = T.uniform([4000], min=-2.0, max=3.0, **dev)
    assert -2.0 <= u.min() and u.max() < 3.0 and abs(u.mean() - 0.5) < 0.1
    before = pt.get_rng_state()
    s1 = T.uniform([50], seed=9, **dev)
    assert pt.get_rng_state() == before          # the stream left alone
    assert torch.equal(T.uniform([50], seed=9, **dev), s1)
    assert not torch.equal(T.uniform([50], seed=10, **dev), s1)
    i = T.randint(-3, 4, [4000], **dev)
    assert i.dtype == torch.int32 and i.min() == -3 and i.max() == 3
    assert sorted(T.randperm(50, **dev).tolist()) == list(range(50))
    probs = torch.tensor([[0.1, 0.0, 0.6, 0.3]])
    draws = T.multinomial(probs.expand(4000, 4), 1, True)
    freq = torch.bincount(draws.reshape(-1).long(), minlength=4) / 4000.0
    assert (freq - probs[0]).abs().max() < 0.03 and freq[1] == 0
    no_rep = T.multinomial(torch.ones(3, 6), 6)
    assert all(sorted(r) == list(range(6)) for r in no_rep.tolist())
    b = T.bernoulli(torch.full((4000,), 0.3))
    assert set(b.unique().tolist()) <= {0.0, 1.0} and abs(b.mean() - 0.3) \
        < 0.03
    po = T.poisson(torch.full((4000,), 3.0))
    assert abs(po.mean() - 3.0) < 0.1 and abs(po.var() - 3.0) < 0.3
    x = torch.empty(4000)
    assert T.exponential_(x, 2.0) is x and abs(x.mean() - 0.5) < 0.03
    T.normal_(x, -1.0, 2.0)
    assert abs(x.mean() + 1.0) < 0.1 and abs(x.std() - 2.0) < 0.1
    T.uniform_(x, 0.0, 4.0)
    assert 0.0 <= x.min() and x.max() < 4.0
    T.bernoulli_(x, 0.8)
    assert abs(x.mean() - 0.8) < 0.03
    g = T.gumbel_softmax(torch.randn(5, 7), hard=True)
    assert torch.equal(g.detach().argmax(-1), g.detach().round().argmax(-1))
    np.testing.assert_allclose(g.detach().sum(-1).numpy(), 1.0, atol=1e-6)
    # JAX's randint_like raises on a float tensor (randint takes no float
    # dtype); the port gives integer values in x's dtype, as Paddle's
    f = T.randint_like(torch.zeros(500), -2, 3)
    assert f.dtype == torch.float32 and set(f.unique().tolist()) <= {
        -2.0, -1.0, 0.0, 1.0, 2.0}
    if not torch.cuda.is_available():
        for fn in (lambda: T.rand([2]), lambda: T.randint(3),
                   lambda: T.randperm(3), lambda: TFFT.fftfreq(4)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn()


def test_stft_round_trip():
    x = torch.from_numpy(_SIG[1])
    w = torch.from_numpy(_HANN)
    for center in (True, False):
        spec = TSIG.stft(x, 64, 16, window=w, center=center)
        back = TSIG.istft(spec, 64, 16, window=w, center=center)
        n = back.shape[-1]
        lo, hi = (0, n) if center else (64, n - 64)
        np.testing.assert_allclose(back[lo:hi].numpy(), _SIG[1][lo:hi],
                                   atol=1e-5)


def test_namespaces_match_jax():
    """``paddle.linalg``, ``paddle.fft`` and ``paddle.signal``: every name
    JAX's modules export, and no other."""
    def public(mod, *homes):
        return {n for n, v in vars(mod).items() if not n.startswith("_")
                and callable(v) and getattr(v, "__module__", "") in homes}

    assert set(TLA.__all__) == public(
        JLA, "paddle_tpu.tensor.linalg", "paddle_tpu.tensor.math")
    assert len(TLA.__all__) == 37
    assert set(TFFT.__all__) == public(JFFT, JFFT.__name__)
    assert len(TFFT.__all__) == 18
    assert set(TSIG.__all__) == public(JSIG, JSIG.__name__) == {"stft",
                                                                "istft"}
    for mod in (TLA, TFFT, TSIG):
        assert all(callable(getattr(mod, n)) for n in mod.__all__)
    assert pt.linalg is TLA and pt.fft is TFFT and pt.signal is TSIG
