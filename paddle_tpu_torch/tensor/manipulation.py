"""Shape, layout and indexing functions, the counterparts of
``paddle_tpu/tensor/manipulation.py``, all 72 of them and its three
aliases (``cat``, ``take_along_dim``, ``unstack``).

Paddle's argument names and conventions, as JAX's: ``axis``,
``num_or_sections`` (an int, or sizes of which one may be -1), ``expand``'s
-1 for "keep this dim", ``shard_index``'s floor rule.  Every function
runs where its tensors lie.  The index tensors JAX returns are int32 (its
int64 is 32-bit with x64 off): ``nonzero``, ``where`` with one argument,
``unique``'s index, inverse and counts, ``unique_consecutive``'s and
``shape``; index arguments of any integer dtype are taken.  The
data-dependent functions (``masked_select``, ``nonzero``, ``unique``,
``unique_consecutive``) size their outputs on the host, as JAX's eager
ones do.  A function the JAX package names as an op asks
:func:`paddle_tpu_torch.amp.auto_cast.cast_inputs` for its floating
inputs' dtype under JAX's op name (an O2 scope casts them); the unnamed
ones (``moveaxis``, ``take``, ``tensordot``, ...) are never cast, as in
JAX.  ``reshape_`` and ``scatter_`` replace the tensor's data, as JAX
replaces the buffer.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..amp.auto_cast import cast_inputs

__all__ = [
    "as_complex", "as_real", "as_strided", "atleast_1d", "atleast_2d",
    "atleast_3d", "broadcast_shape", "broadcast_tensors", "broadcast_to",
    "cast", "cat", "chunk", "column_stack", "concat", "diagonal", "dsplit",
    "expand", "expand_as", "flatten", "flip", "fliplr", "flipud", "gather",
    "gather_nd", "hsplit", "hstack", "index_add", "index_fill", "index_put",
    "index_sample", "index_select", "masked_fill", "masked_select",
    "moveaxis", "nonzero", "put_along_axis", "repeat_interleave", "reshape",
    "reshape_", "roll", "rot90", "row_stack", "scatter", "scatter_",
    "scatter_nd", "scatter_nd_add", "shape", "shard_index", "slice", "split",
    "squeeze", "stack", "strided_slice", "swapaxes", "t", "take",
    "take_along_axis", "take_along_dim", "tensor_split", "tensordot", "tile",
    "tolist", "transpose", "unbind", "unflatten", "unfold", "unique",
    "unique_consecutive", "unsqueeze", "unstack", "view", "view_as",
    "vsplit", "vstack", "where",
]

_DTYPE_NAMES = {"bool": torch.bool, "float16": torch.float16,
                "bfloat16": torch.bfloat16, "float32": torch.float32,
                "float64": torch.float64, "int8": torch.int8,
                "uint8": torch.uint8, "int16": torch.int16,
                "int32": torch.int32, "int64": torch.int64,
                "complex64": torch.complex64, "complex128": torch.complex128}


def to_dtype(dtype):
    """A torch dtype from a torch dtype, a name (``"float32"``) or a
    NumPy dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return _DTYPE_NAMES[name]


def _ints(v):
    """An int, or a tuple of ints from a list, a tuple or a tensor."""
    if isinstance(v, torch.Tensor):
        return tuple(int(s) for s in v.reshape(-1).tolist())
    if isinstance(v, (int, np.integer)):
        return int(v)
    return tuple(int(s) for s in v)


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _long(i):
    return i.long() if isinstance(i, torch.Tensor) else torch.as_tensor(i)


def _assign(x, out):
    """Replace ``x``'s data with ``out``'s (JAX's ``x._data = ...``)."""
    x.data = out.detach()
    return x


def reshape(x, shape):
    (x,) = cast_inputs("reshape", x)
    return torch.reshape(x, _ints(shape))


def reshape_(x, shape):
    return _assign(x, torch.reshape(x, _ints(shape)))


def transpose(x, perm):
    (x,) = cast_inputs("transpose", x)
    return x.permute(_ints(perm))


def t(x):
    """A tensor of under 2 dims cloned, else its dims reversed."""
    if x.dim() < 2:
        return x.clone()
    (x,) = cast_inputs("t", x)
    return x.permute(tuple(range(x.dim() - 1, -1, -1)))


def moveaxis(x, source, destination):
    return torch.movedim(x, source, destination)


def swapaxes(x, axis0, axis1):
    return torch.swapaxes(x, axis0, axis1)


def flatten(x, start_axis=0, stop_axis=-1):
    """Dims ``start_axis`` through ``stop_axis`` merged into one (a 0-d
    tensor becomes ``[1]``)."""
    (x,) = cast_inputs("flatten", x)
    if x.dim() == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def squeeze(x, axis=None):
    """Every size-1 dim, or those of ``axis`` that have size 1."""
    (x,) = cast_inputs("squeeze", x)
    if axis is None:
        return torch.squeeze(x)
    axes = _ints(axis)
    axes = (axes,) if isinstance(axes, int) else axes
    keep = tuple(a % x.dim() for a in axes if x.shape[a % x.dim()] == 1)
    return torch.squeeze(x, keep) if keep else x


def unsqueeze(x, axis):
    """``jnp.expand_dims``: each axis names a dim of the output."""
    (x,) = cast_inputs("unsqueeze", x)
    axes = _ints(axis)
    axes = (axes,) if isinstance(axes, int) else axes
    nd = x.dim() + len(axes)
    for a in sorted(a % nd for a in axes):
        x = x.unsqueeze(a)
    return x


def concat(x, axis=0):
    xs = cast_inputs("concat", *x)
    return torch.cat(xs, dim=_int(axis))


def stack(x, axis=0):
    xs = cast_inputs("stack", *x)
    return torch.stack(xs, dim=axis)


def split(x, num_or_sections, axis=0):
    """A list of pieces along ``axis``: ``num_or_sections`` equal ones
    (the length must divide), or pieces of the given sizes, one of which
    may be -1 for the rest."""
    (x,) = cast_inputs("split", x)
    ax = _int(axis)
    n = x.shape[ax]
    if isinstance(num_or_sections, int):
        if n % num_or_sections:
            raise ValueError(f"split: axis {ax} length {n} is not divisible "
                             f"by num_or_sections={num_or_sections}")
        sizes = [n // num_or_sections] * num_or_sections
    else:
        sizes = [_int(s) for s in num_or_sections]
        neg = [i for i, s in enumerate(sizes) if s < 0]
        if neg:
            sizes[neg[0]] = n - sum(s for s in sizes if s >= 0)
    return list(torch.split(x, sizes, dim=ax))


def chunk(x, chunks, axis=0):
    return split(x, chunks, axis)


def unbind(x, axis=0):
    return [squeeze(o, axis) for o in split(x, x.shape[axis], axis)]


unstack = unbind


def tile(x, repeat_times):
    (x,) = cast_inputs("tile", x)
    rt = _ints(repeat_times)
    return torch.tile(x, (rt,) if isinstance(rt, int) else rt)


def expand(x, shape):
    """``x`` broadcast to ``shape``; -1 keeps the matching dim (1 for a
    new leading one)."""
    (x,) = cast_inputs("expand", x)
    tgt = list(_ints(shape))
    off = len(tgt) - x.dim()
    for i, s in enumerate(tgt):
        if s == -1:
            tgt[i] = x.shape[i - off] if i >= off else 1
    return torch.broadcast_to(x, tgt)


def expand_as(x, y):
    (x,) = cast_inputs("expand_as", x)
    return torch.broadcast_to(x, y.shape)


def broadcast_to(x, shape):
    return expand(x, shape)


def broadcast_tensors(inputs):
    return list(torch.broadcast_tensors(*inputs))


def flip(x, axis):
    (x,) = cast_inputs("flip", x)
    ax = _ints(axis)
    return torch.flip(x, (ax,) if isinstance(ax, int) else ax)


def rot90(x, k=1, axes=(0, 1)):
    return torch.rot90(x, k, tuple(axes))


def roll(x, shifts, axis=None):
    (x,) = cast_inputs("roll", x)
    ax = _ints(axis) if axis is not None else None
    return torch.roll(x, _ints(shifts), ax)


def _wrap_negative(i, n):
    i = _long(i)
    return torch.where(i < 0, i + n, i)


def gather(x, index, axis=0):
    """``jnp.take(x, index, axis)``: rows of ``x`` along ``axis`` at an
    index of any shape (negative indices count from the end)."""
    (x,) = cast_inputs("gather", x)
    ax = _int(axis) % x.dim()
    i = _wrap_negative(index, x.shape[ax]).to(x.device)
    out = x.index_select(ax, i.reshape(-1))
    return out.reshape(x.shape[:ax] + i.shape + x.shape[ax + 1:])


def gather_nd(x, index):
    (x,) = cast_inputs("gather_nd", x)
    return x[tuple(_long(index).unbind(-1))]


def scatter(x, index, updates, overwrite=True):
    """Rows of ``x`` at the flattened ``index`` set to ``updates``; with
    ``overwrite=False`` those rows are zeroed and the updates summed into
    them."""
    x, updates = cast_inputs("scatter", x, updates)
    i = (_long(index).reshape(-1),)
    if overwrite:
        return x.index_put(i, updates)
    return x.index_put(i, torch.zeros_like(updates)).index_put(
        i, updates, accumulate=True)


def scatter_(x, index, updates, overwrite=True):
    return _assign(x, scatter(x, index, updates, overwrite))


def scatter_nd_add(x, index, updates):
    x, updates = cast_inputs("scatter_nd_add", x, updates)
    return x.index_put(tuple(_long(index).unbind(-1)), updates,
                       accumulate=True)


def scatter_nd(index, updates, shape):
    base = torch.zeros(_ints(shape), dtype=updates.dtype,
                       device=updates.device)
    return scatter_nd_add(base, index, updates)


def index_select(x, index, axis=0):
    return gather(x, index, axis)


def index_sample(x, index):
    """``x[r, index[r, j]]`` for each row ``r`` of a 2-D ``x``."""
    (x,) = cast_inputs("index_sample", x)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, _long(index)]


def index_add(x, index, axis, value):
    x, value = cast_inputs("index_add", x, value)
    return x.index_add(axis, _long(index), value)


def index_put(x, indices, value, accumulate=False):
    """``x`` with the positions of ``indices`` (integer or bool tensors)
    set to ``value``, or ``value`` added with ``accumulate``."""
    x, value = cast_inputs("index_put", x, value)
    idx = tuple(i if i.dtype == torch.bool else i.long() for i in indices)
    value = torch.as_tensor(value, dtype=x.dtype, device=x.device)
    return x.index_put(idx, value, accumulate=accumulate)


def masked_select(x, mask):
    """The elements of ``x`` where ``mask`` holds, 1-D (sized on the
    host, as JAX's eager function)."""
    return torch.masked_select(x, mask)


def masked_fill(x, mask, value):
    (x,) = cast_inputs("masked_fill", x)
    return torch.where(mask, value, x)


def take_along_axis(arr, indices, axis, broadcast=True):
    (arr,) = cast_inputs("take_along_axis", arr)
    return torch.take_along_dim(arr, _long(indices), dim=axis)


def put_along_axis(arr, indices, values, axis, reduce="assign"):
    """``arr`` with ``values`` (broadcast to ``indices``' shape) written
    along ``axis`` at ``indices``: set (``"assign"``), summed (``"add"``)
    or multiplied (``"mul"``, ``"multiply"``) in."""
    arr, values = cast_inputs("put_along_axis", arr, values)
    i = _long(indices)
    v = torch.as_tensor(values, dtype=arr.dtype, device=arr.device)
    v = torch.broadcast_to(v, i.shape)
    if reduce == "add":
        return arr.scatter_add(axis, i, v)
    if reduce in ("mul", "multiply"):
        return arr.scatter_reduce(axis, i, v, "prod")
    return arr.scatter(axis, i, v)


def take(x, index, mode="raise"):
    """Elements of the flattened ``x``: ``"raise"`` and ``"clip"`` clamp
    the index to ``[0, n - 1]``, ``"wrap"`` takes it modulo ``n`` (JAX's
    ``jnp.take`` modes)."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    i = _long(index).to(x.device)
    if mode == "wrap":
        i = torch.remainder(i, n)
    elif mode in ("raise", "clip"):
        i = i.clamp(0, n - 1)
    else:
        raise KeyError(mode)
    return flat[i]


def _bound(v, n):
    return max(v + n, 0) if v < 0 else min(v, n)


def slice(input, axes, starts, ends):  # noqa: A001  (paddle's name)
    """``input[starts:ends]`` along each of ``axes``, negative bounds
    counted from the end and both clamped to the dim."""
    (input,) = cast_inputs("slice", input)
    out = input
    for ax, st, en in zip(_ints(axes), _ints(starts), _ints(ends)):
        n = input.shape[ax]
        lo, hi = _bound(st, n), _bound(en, n)
        out = out.narrow(ax, lo, max(hi - lo, 0))
    return out


def strided_slice(x, axes, starts, ends, strides):
    """Python's ``x[start:end:stride]`` along each of ``axes`` (a
    negative stride too)."""
    (x,) = cast_inputs("strided_slice", x)
    out = x
    for ax, st, en, sd in zip(_ints(axes), _ints(starts), _ints(ends),
                              _ints(strides)):
        if sd > 0:
            idx = [builtins.slice(None)] * out.dim()
            idx[ax] = builtins.slice(st, en, sd)
            out = out[tuple(idx)]
        else:
            keep = list(range(out.shape[ax]))[builtins.slice(st, en, sd)]
            out = out.index_select(ax, torch.tensor(keep, dtype=torch.long,
                                                    device=out.device))
    return out


def repeat_interleave(x, repeats, axis=None):
    (x,) = cast_inputs("repeat_interleave", x)
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(x.device)
    return torch.repeat_interleave(x, repeats, dim=axis)


def _first_index(inverse, n):
    """The first position of each unique value: the least position
    whose inverse names it."""
    pos = torch.arange(n, device=inverse.device)
    k = int(inverse.max().item()) + 1 if n else 0
    return torch.full((k,), n, dtype=torch.long,
                      device=inverse.device).scatter_reduce(
        0, inverse, pos, "amin")


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64"):
    """``np.unique``'s results, as JAX's (sorted values; the first index,
    the inverse and the counts as int32; ``axis=None`` flattens, and
    then the inverse has ``x``'s shape)."""
    flat = x.reshape(-1) if axis is None else x
    dim = None if axis is None else axis % x.dim()
    vals, inv, counts = torch.unique(flat, sorted=True, return_inverse=True,
                                     return_counts=True, dim=dim)
    outs = [vals]
    if return_index:
        n = flat.shape[0] if dim is None else x.shape[dim]
        outs.append(_first_index(inv.reshape(-1), n).int())
    if return_inverse:
        outs.append((inv.reshape(x.shape) if axis is None else inv).int())
    if return_counts:
        outs.append(counts.int())
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64"):
    """Runs of equal values collapsed to one, of the flattened ``x``
    (``axis=None``, JAX's case), else of slices along ``axis``; the
    inverse and the counts as int32."""
    if axis is None:
        x = x.reshape(-1)
    out, inv, counts = torch.unique_consecutive(
        x, return_inverse=True, return_counts=True,
        dim=None if axis is None else axis)
    rets = [out]
    if return_inverse:
        rets.append(inv.int())
    if return_counts:
        rets.append(counts.int())
    return rets[0] if len(rets) == 1 else tuple(rets)


def nonzero(x, as_tuple=False):
    """``[nnz, x.dim()]`` int32 coordinates of the nonzero elements, or
    with ``as_tuple`` one int32 vector a dim."""
    nz = torch.nonzero(x).int()
    if as_tuple:
        return tuple(nz.unbind(1))
    return nz


def where(condition, x=None, y=None):
    """``x`` where ``condition`` holds, else ``y``; with neither given,
    :func:`nonzero` ``(condition, as_tuple=True)``."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    x, y = cast_inputs("where", x, y)
    return torch.where(condition, x, y)


def as_complex(x):
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x):
    return torch.stack([x.real, x.imag], dim=-1)


def view(x, shape_or_dtype):
    """A reshape for a list or tuple, else a cast to that dtype (JAX has
    no views; neither does this)."""
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return x.to(to_dtype(shape_or_dtype))


def view_as(x, other):
    return reshape(x, other.shape)


def _each(fn, inputs):
    outs = [fn(t) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_1d(*inputs):
    return _each(torch.atleast_1d, inputs)


def atleast_2d(*inputs):
    return _each(torch.atleast_2d, inputs)


def atleast_3d(*inputs):
    return _each(torch.atleast_3d, inputs)


def tensordot(x, y, axes=2):
    """``jnp.tensordot``: ``axes`` an int, a pair of ints or a pair of
    sequences."""
    ax = _ints(axes) if isinstance(axes, torch.Tensor) else axes
    if isinstance(ax, (list, tuple)) and len(ax) == 2 and all(
            isinstance(a, (int, np.integer)) for a in ax):
        ax = ([int(ax[0])], [int(ax[1])])
    elif isinstance(ax, (list, tuple)):
        ax = [[int(a) for a in (s if isinstance(s, (list, tuple)) else [s])]
              for s in ax]
    return torch.tensordot(x, y, dims=ax)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Each index ``i`` of shard ``i // (index_num // nshards)``:
    ``i % size`` in shard ``shard_id``, else ``ignore_value``."""
    size = index_num // nshards
    return torch.where(torch.div(input, size, rounding_mode="floor")
                       == shard_id, torch.remainder(input, size),
                       torch.as_tensor(ignore_value, dtype=input.dtype,
                                       device=input.device))


def cast(x, dtype):
    return x.to(to_dtype(dtype))


def diagonal(x, offset=0, axis1=0, axis2=1):
    """The diagonal of the (axis1, axis2) planes as the last dim."""
    return torch.diagonal(x, offset, axis1, axis2)


def unfold(x, axis, size, step):
    """Windows of ``size`` every ``step`` along ``axis``: that dim
    becomes the window count and a last dim of ``size`` is appended."""
    ax = axis % x.dim()
    if size > x.shape[ax]:
        raise ValueError(f"unfold size {size} exceeds dim {x.shape[ax]} at "
                         f"axis {axis}")
    return x.unfold(ax, size, step)


def as_strided(x, shape, stride, offset=0):
    """The elements a row-major view of ``x``'s data with ``shape``,
    ``stride`` and ``offset`` would show, gathered (a gradient sums into
    overlapping positions)."""
    nd = len(shape)
    idx = torch.full((), offset, dtype=torch.long, device=x.device)
    for i, (sh, st) in enumerate(zip(shape, stride)):
        ar = torch.arange(sh, device=x.device) * st
        idx = idx + ar.reshape((sh,) + (1,) * (nd - 1 - i))
    return x.reshape(-1)[idx]


def fliplr(x):
    (x,) = cast_inputs("fliplr", x)
    return torch.flip(x, (1,))


def flipud(x):
    (x,) = cast_inputs("flipud", x)
    return torch.flip(x, (0,))


def tensor_split(x, num_or_indices, axis=0):
    """``np.array_split``'s pieces for an int (empty trailing pieces
    kept), else the pieces between the given indices."""
    (x,) = cast_inputs("tensor_split", x)
    n = int(x.shape[axis])
    if isinstance(num_or_indices, int):
        bounds = [0]
        for s in np.array_split(np.arange(n), num_or_indices):
            bounds.append(bounds[-1] + len(s))
    else:
        bounds = [0] + [int(i) for i in num_or_indices] + [n]
    return [x.narrow(axis, lo, hi - lo)
            for lo, hi in zip(bounds[:-1], bounds[1:])]


def hsplit(x, num_or_indices):
    return tensor_split(x, num_or_indices, axis=0 if x.dim() == 1 else 1)


def vsplit(x, num_or_indices):
    return tensor_split(x, num_or_indices, axis=0)


def dsplit(x, num_or_indices):
    return tensor_split(x, num_or_indices, axis=2)


def hstack(x):
    return concat(list(x), axis=0 if x[0].dim() <= 1 else 1)


def vstack(x):
    ts = list(x)
    if ts[0].dim() <= 1:
        ts = [reshape(t_, [1, -1]) for t_ in ts]
    return concat(ts, axis=0)


def column_stack(x):
    return concat([reshape(t_, [-1, 1]) if t_.dim() == 1 else t_
                   for t_ in x], axis=1)


def row_stack(x):
    return vstack(x)


def unflatten(x, axis, shape):
    axis = axis % x.dim()
    return reshape(x, list(x.shape[:axis]) + [int(s) for s in shape]
                   + list(x.shape[axis + 1:]))


def index_fill(x, index, axis, value):
    (x,) = cast_inputs("index_fill", x)
    return x.index_fill(axis, _long(index).to(x.device), value)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def tolist(x):
    return x.tolist()


def shape(x):
    """The shape as a 1-D int32 tensor on ``x``'s device."""
    return torch.tensor(list(x.shape), dtype=torch.int32, device=x.device)


cat = concat
take_along_dim = take_along_axis
