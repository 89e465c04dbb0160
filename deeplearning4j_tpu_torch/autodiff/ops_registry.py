"""The SameDiff op registry — the port's counterpart of
`deeplearning4j_tpu/autodiff/ops_registry.py`: each op name maps to a
function of torch tensors (positional) and static attributes (keyword),
so a recorded graph stores op names and attributes and serializes
without code.

Semantics are the JAX package's with ``jax_enable_x64`` off: an op
returns no 64-bit value (int64 results narrow to int32, float64 to
float32, complex128 to complex64; `get_op` hands out the narrowing
wrapper), comparisons and masks come back as f32 0 / 1 where the JAX op
casts them, reductions take ``axis`` as None, an int or a tuple, and
variance is the population variance.  An op with no tensor input makes
its result on the device of the running graph (`device_scope`).

Nothing here launches a hand-written kernel except
``multi_head_dot_product_attention``, which calls `ops/attention.py`
``mha``: kernels B1 (forward) and B2 / B3 (backward) on the card.

Ops that wait (`WAITING`) raise `NotImplementedError` naming ROADMAP
A13: the image ops whose sampling grids or colour maths the port has not
reproduced yet, the signal / FFT namespace, the random ops whose bits
`runtime/rng.py` does not reproduce, and special functions with no
torch counterpart.  `PORTED` plus `WAITING` is the JAX package's op set.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.runtime import rng as rng_mod

_DEVICE = contextvars.ContextVar("samediff_device", default=None)


@contextlib.contextmanager
def device_scope(device):
    """Ops with no tensor input make their result on ``device`` inside."""
    tok = _DEVICE.set(torch.device(device))
    try:
        yield
    finally:
        _DEVICE.reset(tok)


def _dev():
    d = _DEVICE.get()
    return d if d is not None else torch.device("cpu")


_F32 = torch.float32
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
           torch.complex128: torch.complex64}
_NP_DTYPES = {"float32": _F32, "float64": _F32, "float16": torch.float16,
              "bfloat16": torch.bfloat16, "int32": torch.int32, "int64": torch.int32,
              "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8,
              "bool": torch.bool, "uint32": torch.int32, "complex64": torch.complex64}


def torch_dtype(dtype) -> torch.dtype:
    """A numpy / string / torch dtype as the torch dtype the JAX package
    (x64 off) would hold it in."""
    if isinstance(dtype, torch.dtype):
        return _NARROW.get(dtype, dtype)
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    if name not in _NP_DTYPES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _NP_DTYPES[name]


def _narrow(out):
    if isinstance(out, torch.Tensor):
        to = _NARROW.get(out.dtype)
        return out if to is None else out.to(to)
    if isinstance(out, (tuple, list)):
        return type(out)(_narrow(o) for o in out)
    return out


def _ax(axis):
    if axis is None:
        return None
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def _dims(x, axis) -> tuple:
    axis = _ax(axis)
    if axis is None:
        return tuple(range(x.dim()))
    return axis if isinstance(axis, tuple) else (axis,)


def _fl(x):
    """A floating copy of ``x`` (jnp promotes ints to f32 for mean / var)."""
    return x if x.is_floating_point() or x.is_complex() else x.to(_F32)


def _reduce(fn, x, axis=None, keepdims=False):
    """``fn(x, dim, keepdim)`` over ``axis`` (None: every axis)."""
    dims = _dims(x, axis)
    if x.dim() == 0:
        return fn(x.reshape(1), (0,), False).reshape(()) if not keepdims else x
    return fn(x, dims, keepdims)


def _sum(x, axis=None, keepdims=False):
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    return _reduce(lambda t, d, k: torch.sum(t, dim=d, keepdim=k), x, axis, keepdims)


def _mean(x, axis=None, keepdims=False):
    return _reduce(lambda t, d, k: torch.mean(_fl(t), dim=d, keepdim=k), x, axis, keepdims)


def _amax(x, axis=None, keepdims=False):
    return _reduce(lambda t, d, k: torch.amax(t, dim=d, keepdim=k), x, axis, keepdims)


def _amin(x, axis=None, keepdims=False):
    return _reduce(lambda t, d, k: torch.amin(t, dim=d, keepdim=k), x, axis, keepdims)


def _prod(x, axis=None, keepdims=False):
    def fn(t, dims, k):
        for d in sorted((d % t.dim() for d in dims), reverse=True):
            t = torch.prod(t, dim=d, keepdim=k)
        return t
    return _reduce(fn, x, axis, keepdims)


def _var(x, axis=None, keepdims=False):
    return _reduce(lambda t, d, k: torch.var(_fl(t), dim=d, keepdim=k, correction=0),
                   x, axis, keepdims)


def _std(x, axis=None, keepdims=False):
    return _reduce(lambda t, d, k: torch.std(_fl(t), dim=d, keepdim=k, correction=0),
                   x, axis, keepdims)


def _all(x, axis=None, keepdims=False):
    return _reduce(lambda t, d, k: torch.amin((t != 0).to(torch.uint8), dim=d, keepdim=k),
                   x, axis, keepdims).to(_F32)


def _any(x, axis=None, keepdims=False):
    return _reduce(lambda t, d, k: torch.amax((t != 0).to(torch.uint8), dim=d, keepdim=k),
                   x, axis, keepdims).to(_F32)


def _nanreduce(fn, fill):
    def op(x, *, axis=None, keepdims=False):
        return fn(torch.where(torch.isnan(x), fill(x), x), axis, keepdims)
    return op


def _nanmean(x, *, axis=None, keepdims=False):
    ok = ~torch.isnan(x)
    s = _sum(torch.where(ok, x, 0.0), axis, keepdims)
    return s / _sum(ok.to(x.dtype), axis, keepdims)


def _nanstd(x, *, axis=None, keepdims=False):
    ok = ~torch.isnan(x)
    n = _sum(ok.to(x.dtype), axis, True)
    mu = _sum(torch.where(ok, x, 0.0), axis, True) / n
    d = torch.where(ok, x - mu, 0.0)
    out = torch.sqrt(_sum(d * d, axis, True) / n)
    return out if keepdims else out.squeeze(_dims(x, axis)) if axis is not None \
        else out.reshape(())


def _argmax(x, axis=-1):
    if axis is None:
        return torch.argmax(x.reshape(-1))
    return torch.argmax(x, dim=int(axis))


def _argmin(x, axis=-1):
    if axis is None:
        return torch.argmin(x.reshape(-1))
    return torch.argmin(x, dim=int(axis))


def _f(x, like):
    """A Python scalar as a 0-dim tensor of ``like``'s dtype and device."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _index(x, idx: tuple):
    """``x[idx]`` with numpy semantics for ints, None, slices and one
    Ellipsis, negative slice steps included (torch slicing takes none)."""
    if Ellipsis in idx:
        at = idx.index(Ellipsis)
        used = sum(1 for i in idx if i is not None and i is not Ellipsis)
        idx = idx[:at] + (slice(None),) * (x.dim() - used) + idx[at + 1:]
    d = 0
    for i in idx:
        if i is None:
            x = x.unsqueeze(d)
            d += 1
        elif isinstance(i, slice):
            start, stop, step = i.indices(x.shape[d])
            if step > 0:
                x = x[(slice(None),) * d + (slice(start, stop, step),)]
            else:
                ids = torch.arange(start, stop, step, device=x.device)
                x = x.index_select(d, ids)
            d += 1
        else:
            n = x.shape[d]
            i = int(i)
            x = x.select(d, i + n if i < 0 else i)
    return x


# -- nn composites ------------------------------------------------------------

def _same_or_valid(padding):
    return padding.lower() if isinstance(padding, str) else padding


def _conv2d(x, w, *, stride=(1, 1), padding="SAME", dilation=(1, 1)):
    from deeplearning4j_tpu_torch.ops.conv import conv2d_nhwc

    return conv2d_nhwc(x, w, stride=tuple(stride), padding=_same_or_valid(padding),
                       dilation=tuple(dilation))


def _conv1d(x, w, *, stride=1, padding="SAME"):
    from deeplearning4j_tpu_torch.ops.conv import conv_channels_last

    return conv_channels_last(x, w, stride=stride, padding=_same_or_valid(padding))


def _conv3d(x, w, *, stride=(1, 1, 1), padding="SAME"):
    from deeplearning4j_tpu_torch.ops.conv import conv_channels_last

    return conv_channels_last(x, w, stride=tuple(stride), padding=_same_or_valid(padding))


def _depthwise_conv2d(x, w, *, stride=(1, 1), padding="SAME", dilation=(1, 1)):
    from deeplearning4j_tpu_torch.ops.conv import conv2d_nhwc

    c = x.shape[-1]
    return conv2d_nhwc(x, w.reshape(w.shape[0], w.shape[1], 1, -1), stride=tuple(stride),
                       padding=_same_or_valid(padding), dilation=tuple(dilation), groups=c)


def _conv_transpose_pads(k: int, s: int, padding: str):
    """``lax.conv_transpose``'s padding of the stride-dilated input."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(math.ceil(pad_len / 2))
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    return pad_a, pad_len - pad_a


def _deconv2d(x, w, *, stride=(2, 2), padding="SAME"):
    """``lax.conv_transpose`` (no kernel flip): the input dilated by the
    stride, padded, then correlated with the HWIO kernel."""
    b, h, wd, c = x.shape
    sh, sw = stride
    kh, kw = w.shape[0], w.shape[1]
    xd = x.new_zeros((b, (h - 1) * sh + 1, (wd - 1) * sw + 1, c))
    xd[:, ::sh, ::sw, :] = x
    (pt, pb), (pl, pr) = (_conv_transpose_pads(kh, sh, padding),
                          _conv_transpose_pads(kw, sw, padding))
    xc = F.pad(xd.movedim(-1, 1), (pl, pr, pt, pb))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1))
    return y.movedim(1, -1)


def _pool(kind):
    def fn(x, *, kernel=(2, 2), stride=(2, 2), padding="VALID"):
        from deeplearning4j_tpu_torch.ops.conv import pool2d_nhwc

        return pool2d_nhwc(x, kind, kernel=tuple(kernel), stride=tuple(stride),
                           padding=_same_or_valid(padding))
    return fn


def _layer_norm(x, gamma, beta, *, epsilon=1e-5):
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    return (x - mean) * torch.rsqrt(var + epsilon) * gamma + beta


def _log_softmax(x, axis=-1):
    return torch.log_softmax(x, dim=int(axis))


def _softmax_cross_entropy(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(labels * logp, dim=-1))


def _sparse_softmax_cross_entropy(logits, labels):
    logp = torch.log_softmax(logits, dim=-1)
    picked = torch.take_along_dim(logp, labels[..., None].long(), dim=-1)
    return -torch.mean(picked)


def _sigmoid_cross_entropy(logits, labels):
    per = torch.clamp_min(logits, 0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return torch.mean(per)


def _rationaltanh(x):
    from deeplearning4j_tpu_torch.nn.activations import _rational_tanh

    return _rational_tanh(x)


def _mhdpa(q, k, v, *, causal=False):
    from deeplearning4j_tpu_torch.ops.attention import mha

    return mha(q, k, v, causal=causal)


def _batch_norm(x, mean, var, gamma, beta, *, epsilon=1e-5):
    return (x - mean) * torch.rsqrt(var + epsilon) * gamma + beta


def _lstm_cell(x, h, c, w, r, b):
    z = x @ w + h @ r + b
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return torch.stack([h_new, c_new])


def _gru_cell(x, h, w, r, b):
    zx = x @ w + b
    zr = h @ r
    rx, ux, nx = torch.chunk(zx, 3, dim=-1)
    rr, ur, nr = torch.chunk(zr, 3, dim=-1)
    reset = torch.sigmoid(rx + rr)
    update = torch.sigmoid(ux + ur)
    cand = torch.tanh(nx + reset * nr)
    return (1.0 - update) * cand + update * h


def _gelu(x):
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def _selu(x):
    alpha, scale = 1.6732632423543772848170429916717, 1.0507009873554804934193349852946
    return scale * torch.where(x > 0, x, alpha * torch.expm1(torch.where(x > 0, 0.0, x)))


def _elu(x, alpha=1.0):
    return torch.where(x > 0, x, alpha * torch.expm1(torch.where(x > 0, 0.0, x)))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _relu6(x):
    return torch.clamp(x, 0.0, 6.0)


def _one_hot(x, *, depth, on_value=1.0, off_value=0.0, axis=-1):
    hot = (x.long()[..., None] == torch.arange(depth, device=x.device)).to(_F32)
    if axis != -1 and axis != x.dim():
        hot = hot.movedim(-1, axis)
    return hot * (on_value - off_value) + off_value


def _gather(x, idx, *, axis=0):
    """``jnp.take(x, idx, axis)``: negative indices count from the end.
    Advanced indexing, whose backward (``index_put_`` accumulating) is
    sort-based on the card and so deterministic; ``index_select``'s
    backward adds with atomics, and a captured step would not give the
    eager step's bits.  Nothing is read on the host, so a captured step
    may gather."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis = int(axis) % x.dim()
    n = x.shape[axis]
    ids = idx.long()
    ids = torch.where(ids < 0, ids + n, ids)
    # a 0-dim index tensor would be read on the host (an int index):
    # index with its 1-element view, then drop the axis
    out = x[(slice(None),) * axis + (ids.reshape(-1) if ids.dim() == 0 else ids,)]
    return out.squeeze(axis) if ids.dim() == 0 else out


def _pad(x, *, paddings, constant_values=0.0):
    flat = []
    for lo, hi in reversed([tuple(p) for p in paddings]):
        flat += [int(lo), int(hi)]
    return F.pad(x, flat, value=float(constant_values))


def _squeeze(x, *, axis=None):
    if axis is None:
        return x.squeeze()
    return x.squeeze(_ax(axis))


def _expand_dims(x, *, axis):
    axes = _ax(axis)
    if isinstance(axes, int):
        return x.unsqueeze(axes)
    out_nd = x.dim() + len(axes)
    for a in sorted(a % out_nd for a in axes):
        x = x.unsqueeze(a)
    return x


def _slice(x, *, begin, size):
    return x[tuple(slice(b, None if s == -1 else b + s) for b, s in zip(begin, size))]


def _onnx_slice(x, *, starts, ends, axes):
    big = 2**31 - 1
    sl = [slice(None)] * x.dim()
    for s, e, a in zip(starts, ends, axes):
        sl[a % x.dim()] = slice(s, None if e >= big else e)
    return x[tuple(sl)]


def _strided_slice(x, *, begin, end, strides, begin_mask=0, end_mask=0,
                   ellipsis_mask=0, new_axis_mask=0, shrink_axis_mask=0):
    idx = []
    for i in range(len(begin)):
        if ellipsis_mask & (1 << i):
            idx.append(Ellipsis)
        elif new_axis_mask & (1 << i):
            idx.append(None)
        elif shrink_axis_mask & (1 << i):
            idx.append(int(begin[i]))
        else:
            b = None if begin_mask & (1 << i) else int(begin[i])
            e = None if end_mask & (1 << i) else int(end[i])
            idx.append(slice(b, e, int(strides[i])))
    return _index(x, tuple(idx))


def _where(c, x=None, y=None):
    c = c if c.dtype == torch.bool else c != 0
    if x is None:
        raise ValueError("where takes a condition and two branches")
    return torch.where(c, x, y)


def _cast(x, *, dtype):
    return x.to(torch_dtype(dtype))


def _cmp(fn):
    return lambda a, b: fn(a, b).to(_F32)


def _transpose(x, *, axes=None):
    if axes is None:
        return x.permute(*reversed(range(x.dim())))
    return x.permute(*[int(a) for a in axes])


def _tensordot(a, b, *, axes=2):
    if isinstance(axes, (list, tuple)):
        axes = [list(np.atleast_1d(axes[0]).tolist()), list(np.atleast_1d(axes[1]).tolist())]
    return torch.tensordot(a, b, dims=axes)


def _sort(x, *, axis=-1, descending=False):
    if descending:
        return -torch.sort(-x, dim=axis).values
    return torch.sort(x, dim=axis).values


def _argsort(x, *, axis=-1):
    return torch.argsort(x, dim=axis, stable=True)


def _top_k(x, k):
    """``lax.top_k``: largest first, ties to the lower index."""
    order = torch.argsort(-x if x.is_floating_point() else -x.long(), dim=-1, stable=True)
    idx = order[..., :k]
    return torch.take_along_dim(x, idx, dim=-1), idx


def _segment(x, ids, num_segments, how):
    ids = ids.long()
    shape = (num_segments,) + tuple(x.shape[1:])
    if how == "sum":
        return x.new_zeros(shape).index_add_(0, ids, x)
    if how == "prod":
        return _scatter_rows(x.new_ones(shape), ids, x, "prod", True)
    if x.is_floating_point():
        init = float("-inf") if how == "amax" else float("inf")
    else:
        info = torch.iinfo(x.dtype)
        init = info.min if how == "amax" else info.max
    return _scatter_rows(torch.full(shape, init, dtype=x.dtype, device=x.device), ids, x,
                         how, False)


def _scatter_rows(out, ids, rows, how, include_self):
    """``out`` with ``rows[i]`` reduced into row ``ids[i]`` (in place)."""
    index = ids.reshape((-1,) + (1,) * (rows.dim() - 1)).expand(rows.shape)
    return out.scatter_reduce_(0, index, rows, how, include_self=include_self)


def _segment_mean(x, ids, *, num_segments):
    s = _segment(x, ids, num_segments, "sum")
    n = _segment(torch.ones_like(x), ids, num_segments, "sum")
    return s / torch.clamp_min(n, 1.0)


def _unsorted_segment_minmax(kind):
    def fn(x, ids, *, num_segments):
        out = _segment(x, ids, num_segments, "amax" if kind == "max" else "amin")
        cnt = _segment(torch.ones((x.shape[0],), dtype=_F32, device=x.device), ids,
                       num_segments, "sum")
        info = torch.finfo(x.dtype) if x.is_floating_point() else torch.iinfo(x.dtype)
        fill = info.min if kind == "max" else info.max
        shape = (num_segments,) + (1,) * (x.dim() - 1)
        return torch.where(cnt.reshape(shape) > 0, out, _f(fill, out))
    return fn


def _moments(x, *, axis=None, keepdims=False):
    return torch.stack([_mean(x, axis, keepdims), _var(x, axis, keepdims)])


def _entropy(x, *, axis=None):
    p = torch.clamp(x, 1e-12, 1.0)
    return -_sum(p * torch.log(p), axis)


def _reverse_sequence(x, lengths, *, seq_axis=1, batch_axis=0):
    t = x.shape[seq_axis]
    idx = torch.arange(t, device=x.device)
    lengths = lengths.long()
    rows = []
    for b in range(x.shape[batch_axis]):
        row = x.select(batch_axis, b)
        n = lengths[b]
        rev = torch.where(idx < n, n - 1 - idx, idx)
        ax = seq_axis - 1 if seq_axis > batch_axis else seq_axis
        rows.append(row.index_select(ax, rev))
    return torch.stack(rows, dim=batch_axis)


def _sequence_mask(lengths, *, maxlen):
    return (torch.arange(maxlen, device=lengths.device)[None, :]
            < lengths.long()[..., None]).to(_F32)


def _scatter(how):
    def fn(ref, indices, updates):
        idx = indices.long().reshape(-1)
        upd = updates.reshape((idx.shape[0],) + tuple(ref.shape[1:]))
        out = ref.clone()
        if how == "add":
            return out.index_add_(0, idx, upd.to(ref.dtype))
        if how == "set":
            return out.index_copy_(0, idx, upd.to(ref.dtype))
        return _scatter_rows(out, idx, upd.to(ref.dtype), how, True)
    return fn


def _nd_index(indices):
    return tuple(indices.long().unbind(-1))


def _gather_nd(x, indices):
    return x[_nd_index(indices)]


def _scatter_nd(indices, updates, *, shape):
    out = torch.zeros(tuple(shape), dtype=updates.dtype, device=updates.device)
    return out.index_put_(_nd_index(indices), updates, accumulate=True)


def _matrix_band_part(x, *, lower, upper):
    m, n = x.shape[-2], x.shape[-1]
    i = torch.arange(m, device=x.device)[:, None]
    j = torch.arange(n, device=x.device)[None, :]
    keep = torch.ones((m, n), dtype=torch.bool, device=x.device)
    if lower >= 0:
        keep &= (i - j) <= lower
    if upper >= 0:
        keep &= (j - i) <= upper
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


def _matrix_set_diag(x, diag):
    m, n = x.shape[-2], x.shape[-1]
    k = min(m, n)
    out = x.clone()
    idx = torch.arange(k, device=x.device)
    out[..., idx, idx] = diag[..., :k].to(x.dtype)
    return out


def _matrix_diag(diag):
    return torch.diag_embed(diag)


def _space_to_depth(x, *, block):
    b, h, w, c = x.shape
    return x.reshape(b, h // block, block, w // block, block, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block, block * block * c)


def _depth_to_space(x, *, block):
    b, h, w, c = x.shape
    return x.reshape(b, h, w, block, block, c // (block * block)).permute(
        0, 1, 3, 2, 4, 5).reshape(b, h * block, w * block, c // (block * block))


def _space_to_batch(x, *, block, paddings=((0, 0), (0, 0))):
    x = _pad(x, paddings=((0, 0), tuple(paddings[0]), tuple(paddings[1]), (0, 0)))
    n, h, w, c = x.shape
    x = x.reshape(n, h // block, block, w // block, block, c)
    return x.permute(2, 4, 0, 1, 3, 5).reshape(n * block * block, h // block, w // block, c)


def _batch_to_space(x, *, block, crops=((0, 0), (0, 0))):
    nb, h, w, c = x.shape
    n = nb // (block * block)
    x = x.reshape(block, block, n, h, w, c).permute(2, 3, 0, 4, 1, 5)
    x = x.reshape(n, h * block, w * block, c)
    (ct, cb), (cl, cr) = crops
    return x[:, ct:x.shape[1] - cb or None, cl:x.shape[2] - cr or None, :]


def _im2col(x, *, kernel, stride=(1, 1)):
    """``lax.conv_general_dilated_patches`` (VALID, NHWC): features
    ordered channel-major, then kernel row, then kernel column."""
    b, h, w, c = x.shape
    kh, kw = kernel
    cols = F.unfold(x.movedim(-1, 1), tuple(kernel), stride=tuple(stride))
    oh = (h - kh) // stride[0] + 1
    ow = (w - kw) // stride[1] + 1
    return cols.reshape(b, c * kh * kw, oh, ow).permute(0, 2, 3, 1)


def _col2im(cols, *, input_shape, kernel, stride=(1, 1)):
    """The adjoint of `_im2col`: patches overlap-added back."""
    b, h, w, c = input_shape
    flat = cols.permute(0, 3, 1, 2).reshape(b, cols.shape[-1], -1)
    img = F.fold(flat, (h, w), tuple(kernel), stride=tuple(stride))
    return img.movedim(1, -1)


def _confusion_matrix(labels, preds, *, num_classes):
    idx = labels.long() * num_classes + preds.long()
    return torch.bincount(idx.reshape(-1), minlength=num_classes * num_classes)[
        :num_classes * num_classes].reshape(num_classes, num_classes).to(_F32)


def _standardize(x, *, axis=-1, epsilon=1e-5):
    mean = _mean(x, axis, True)
    var = _var(x, axis, True)
    return (x - mean) * torch.rsqrt(var + epsilon)


def _lrn_onnx(x, *, size=5, alpha=1e-4, beta=0.75, bias=2.0):
    sq = torch.square(x)
    half = (size - 1) // 2
    cs = torch.cumsum(F.pad(sq, (half, size - 1 - half)), dim=-1)
    cs = F.pad(cs, (1, 0))
    win = cs[..., size:] - cs[..., :-size]
    return x / (bias + (alpha / size) * win) ** beta


def _lrn_tf(x, *, depth_radius=5, bias=1.0, alpha=1.0, beta=0.5):
    sq = torch.square(x)
    pad = F.pad(sq, (depth_radius, depth_radius))
    window = sum(pad[..., i:i + x.shape[-1]] for i in range(2 * depth_radius + 1))
    return x / torch.pow(bias + alpha * window, beta)


def _clip_by_norm(x, *, clip_norm, axis=None):
    n = torch.sqrt(_sum(torch.square(x), axis, True))
    return torch.where(n > clip_norm, x * clip_norm / torch.clamp_min(n, 1e-12), x)


def _histogram_fixed_width(x, *, lo, hi, nbins):
    edges = torch.linspace(lo, hi, nbins + 1, device=x.device)
    b = torch.clamp(torch.searchsorted(edges, x.reshape(-1).contiguous(), right=True) - 1,
                    0, nbins - 1)
    return torch.bincount(b, minlength=nbins)[:nbins].to(torch.int32)


def _rand_key(seed):
    return rng_mod.key(seed)


def _rand(kind):
    def fn(*, shape, seed=0, **kw):
        key, shape, dev = _rand_key(seed), tuple(shape), _dev()
        if kind == "normal":
            return kw.get("mean", 0.0) + kw.get("std", 1.0) * rng_mod.normal(key, shape, dev)
        if kind == "uniform":
            return rng_mod.uniform(key, shape, kw.get("minval", 0.0), kw.get("maxval", 1.0),
                                   device=dev)
        if kind == "bernoulli":
            return rng_mod.bernoulli(key, kw.get("p", 0.5), shape, device=dev).to(_F32)
        if kind == "truncated_normal":
            return kw.get("mean", 0.0) + kw.get("std", 1.0) * _truncated_normal(
                key, -2.0, 2.0, shape, dev)
        raise ValueError(kind)
    return fn


def _truncated_normal(key, lower, upper, shape, device):
    """``jax.random.truncated_normal``: sqrt(2) erfinv of a uniform on
    (erf(lower / sqrt 2), erf(upper / sqrt 2)), clipped inside the
    open interval."""
    sqrt2 = torch.tensor(np.float32(np.sqrt(2)))
    lo, hi = torch.tensor(np.float32(lower)), torch.tensor(np.float32(upper))
    a = torch.erf(lo / sqrt2).item()
    b = torch.erf(hi / sqrt2).item()
    u = rng_mod._uniform(rng_mod.random_bits(key, shape, device), a, b)
    out = sqrt2.item() * rng_mod._erfinv(u)
    lo_n = float(np.nextafter(np.float32(lower), np.float32(np.inf)))
    hi_n = float(np.nextafter(np.float32(upper), np.float32(-np.inf)))
    return torch.clamp(out, lo_n, hi_n)


def _random_categorical(logits, *, num_samples, seed=0):
    """``jax.random.categorical`` with ``shape=(num_samples,) + batch``:
    argmax of Gumbel noise plus the logits, samples moved last."""
    batch = tuple(logits.shape[:-1])
    g = rng_mod.gumbel(_rand_key(seed), (num_samples,) + batch + (logits.shape[-1],),
                       device=logits.device)
    out = torch.argmax(g + logits[None], dim=-1)
    return out.movedim(0, -1)


def _alpha_dropout(x, *, rate=0.5, seed=0):
    a_ = -1.7580993408473766
    keep = rng_mod.bernoulli(_rand_key(seed), 1.0 - rate, tuple(x.shape), device=x.device)
    # f32 at each step, as jnp takes the Python scalars
    s = np.float32(1.0) / np.sqrt(np.float32((1 - rate) * (1 + rate * a_ ** 2)))
    shift = np.float32(np.float32(-s) * np.float32(rate)) * np.float32(a_)
    return torch.where(keep, x, _f(a_, x)) * float(s) + float(shift)


def _huber_loss(pred, target, *, delta=1.0):
    d = (pred - target).abs()
    return torch.mean(torch.where(d <= delta, 0.5 * d * d, delta * (d - 0.5 * delta)))


def _kl_divergence(p, q):
    p = torch.clamp(p, 1e-12, 1.0)
    q = torch.clamp(q, 1e-12, 1.0)
    return torch.mean(torch.sum(p * (torch.log(p) - torch.log(q)), dim=-1))


def _norm(x, axis):
    return torch.sqrt(_sum(torch.square(x), axis))


def _cosine_similarity(a, b, *, axis=-1):
    return _sum(a * b, axis) / torch.clamp_min(_norm(a, axis) * _norm(b, axis), 1e-12)


def _percentile(x, *, q, axis=None):
    return _quantile(x, q=q / 100.0, axis=axis)


def _quantile(x, *, q, axis=None):
    """``jnp.quantile`` (linear): the sorted values at floor and ceil of
    q (n - 1), each index held inside [0, n - 1]."""
    x = _fl(x)
    if axis is None:
        x, axis = x.reshape(-1), 0
    s = torch.sort(x, dim=axis).values
    n = s.shape[axis]
    pos = np.float32(q) * np.float32(n - 1)
    low, high = math.floor(pos), math.ceil(pos)
    w_high = float(np.float32(pos - low))
    w_low = float(np.float32(1.0) - np.float32(w_high))
    low, high = min(max(low, 0), n - 1), min(max(high, 0), n - 1)
    return s.select(axis, low) * w_low + s.select(axis, high) * w_high


def _median(x, *, axis=None):
    return _quantile(x, q=0.5, axis=axis)


def _first_index_nonzero(x, *, axis=-1):
    nz = (x != 0)
    return torch.where(nz.any(dim=axis), torch.argmax(nz.to(torch.int32), dim=axis), -1)


def _last_index_nonzero(x, *, axis=-1):
    nz = (x != 0)
    flipped = torch.argmax(torch.flip(nz.to(torch.int32), dims=(axis,)), dim=axis)
    return torch.where(nz.any(dim=axis), x.shape[axis] - 1 - flipped, -1)


# -- image ops the port carries -------------------------------------------------

def _adjust_contrast(x, *, factor):
    mean = torch.mean(x, dim=(-3, -2), keepdim=True)
    return (x - mean) * factor + mean


def _rgb_to_grayscale(x):
    w = torch.tensor([0.2989, 0.5870, 0.1140], dtype=x.dtype, device=x.device)
    return torch.sum(x * w, dim=-1, keepdim=True)


def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn
    safe = torch.where(diff == 0, 1.0, diff)
    h = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0)) / 6.0
    h = torch.where(diff == 0, 0.0, h)
    s = torch.where(mx == 0, 0.0, diff / torch.where(mx == 0, 1.0, mx))
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(x):
    h, s, v = x[..., 0] * 6.0, x[..., 1], x[..., 2]
    i = torch.floor(h)
    f = h - i
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(vals):
        out = vals[-1]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    r = select([v, q, p, p, t, v])
    g = select([t, v, v, q, p, p])
    b = select([p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


def _adjust_hue(x, *, delta):
    hsv = _rgb_to_hsv(x)
    hsv = torch.cat([torch.remainder(hsv[..., :1] + delta, 1.0), hsv[..., 1:]], dim=-1)
    return _hsv_to_rgb(hsv)


def _adjust_saturation(x, *, factor):
    hsv = _rgb_to_hsv(x)
    hsv = torch.cat([hsv[..., :1], torch.clamp(hsv[..., 1:2] * factor, 0.0, 1.0),
                     hsv[..., 2:]], dim=-1)
    return _hsv_to_rgb(hsv)


def _image_gradients(img):
    dy = torch.cat([img[:, 1:] - img[:, :-1], torch.zeros_like(img[:, :1])], dim=1)
    dx = torch.cat([img[:, :, 1:] - img[:, :, :-1], torch.zeros_like(img[:, :, :1])], dim=2)
    return torch.stack([dy, dx])


def _sobel_edges(img):
    ky = torch.tensor([[-1, -2, -1], [0, 0, 0], [1, 2, 1]], dtype=img.dtype, device=img.device)
    kx = ky.T
    b, h, w, c = img.shape
    x = img.movedim(-1, 1).reshape(b * c, 1, h, w)
    pad = F.pad(x, (1, 1, 1, 1), mode="reflect")

    def conv(k):
        out = F.conv2d(pad, k[None, None])
        return out.reshape(b, c, h, w).movedim(1, -1)

    return torch.stack([conv(ky), conv(kx)])


def _total_variation(img):
    dv = (img[:, 1:] - img[:, :-1]).abs().sum(dim=(1, 2, 3))
    dh = (img[:, :, 1:] - img[:, :, :-1]).abs().sum(dim=(1, 2, 3))
    return dv + dh


def _psnr(a, b, *, max_val=1.0):
    mse = torch.mean(torch.square(a - b), dim=(-3, -2, -1))
    return 10.0 * torch.log10(max_val * max_val / torch.clamp_min(mse, 1e-12))


def _ssim(a, b, *, max_val=1.0):
    axes = (-3, -2, -1)
    mu_a, mu_b = torch.mean(a, dim=axes), torch.mean(b, dim=axes)
    va = torch.var(a, dim=axes, correction=0)
    vb = torch.var(b, dim=axes, correction=0)
    cov = torch.mean(a * b, dim=axes) - mu_a * mu_b
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    return ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2))


def _grayscale_to_rgb(x):
    if x.shape[-1] != 1:
        raise ValueError(
            f"grayscale_to_rgb expects a single channel, got {x.shape[-1]} "
            "(TF semantics: non-1-channel input is an error, not a repeat)")
    return x.repeat_interleave(3, dim=-1)


def _central_crop(x, *, fraction):
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"central_crop fraction must be in (0, 1], got {fraction}")
    h, w = x.shape[-3], x.shape[-2]
    ch = max(int(round(h * fraction)), 1)
    cw = max(int(round(w * fraction)), 1)
    top, left = (h - ch) // 2, (w - cw) // 2
    return x[..., top:top + ch, left:left + cw, :]


def _crop(x, *, offset, size):
    oh, ow = offset
    h, w = size
    return x[:, oh:oh + h, ow:ow + w, :]


def _crop_and_resize(img, boxes, box_ind, *, crop_size):
    big_h, big_w = img.shape[1], img.shape[2]
    ch, cw = crop_size
    lin_h = torch.linspace(0.0, 1.0, ch, device=img.device)
    lin_w = torch.linspace(0.0, 1.0, cw, device=img.device)
    out = []
    for box, bi in zip(boxes, box_ind.long()):
        y1, x1, y2, x2 = box[0], box[1], box[2], box[3]
        ys = y1 * (big_h - 1) + (y2 - y1) * (big_h - 1) * lin_h
        xs = x1 * (big_w - 1) + (x2 - x1) * (big_w - 1) * lin_w
        image = img[bi]
        y0 = torch.clamp(torch.floor(ys).long(), 0, big_h - 1)
        x0 = torch.clamp(torch.floor(xs).long(), 0, big_w - 1)
        y1i = torch.clamp(y0 + 1, 0, big_h - 1)
        x1i = torch.clamp(x0 + 1, 0, big_w - 1)
        wy = (ys - y0)[:, None, None]
        wx = (xs - x0)[None, :, None]

        def g(yy, xx):
            return image[yy][:, xx]

        out.append(g(y0, x0) * (1 - wy) * (1 - wx) + g(y0, x1i) * (1 - wy) * wx
                   + g(y1i, x0) * wy * (1 - wx) + g(y1i, x1i) * wy * wx)
    return torch.stack(out)


def _iou_pair(a, b):
    yy1, xx1 = torch.maximum(a[0], b[..., 0]), torch.maximum(a[1], b[..., 1])
    yy2, xx2 = torch.minimum(a[2], b[..., 2]), torch.minimum(a[3], b[..., 3])
    inter = torch.clamp_min(yy2 - yy1, 0) * torch.clamp_min(xx2 - xx1, 0)

    def area(z):
        return torch.clamp_min(z[..., 2] - z[..., 0], 0) * torch.clamp_min(z[..., 3] - z[..., 1], 0)

    union = area(a) + area(b) - inter
    return torch.where(union > 0, inter / union, 0.0)


def _non_max_suppression(boxes, scores, *, max_output_size, iou_threshold=0.5,
                         score_threshold=-math.inf):
    """Greedy NMS with a static output size padded with -1 (the JAX
    package's ``fori_loop``, as a host loop)."""
    n = boxes.shape[0]
    alive = scores > score_threshold
    sel = torch.full((max_output_size,), -1, dtype=torch.int32, device=boxes.device)
    ar = torch.arange(n, device=boxes.device)
    for i in range(max_output_size):
        masked = torch.where(alive, scores, float("-inf"))
        best = torch.argmax(masked)
        ok = masked[best] > float("-inf")
        sel[i] = torch.where(ok, best, -1).to(torch.int32)
        ious = _iou_pair(boxes[best], boxes)
        alive = alive & (ious <= iou_threshold) & (ar != best)
        alive = torch.where(ok, alive, torch.zeros_like(alive))
    return sel


def _iou_matrix(a, b):
    def area(z):
        return torch.clamp_min(z[:, 2] - z[:, 0], 0) * torch.clamp_min(z[:, 3] - z[:, 1], 0)
    tl = torch.maximum(a[:, None, :2], b[None, :, :2])
    br = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = torch.clamp_min(br - tl, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[:, None] + area(b)[None, :] - inter
    return inter / torch.clamp_min(union, 1e-9)


def _resize_linear(x, *, size):
    """``jax.image.resize(..., "bilinear")`` of (N, H, W, C): half-pixel
    centres; a downscale widens the triangle kernel (antialias)."""
    n, h, w, c = x.shape
    out_h, out_w = int(size[0]), int(size[1])
    down = out_h < h or out_w < w
    y = F.interpolate(x.movedim(-1, 1), size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=down)
    return y.movedim(1, -1)


def _resize_nearest(x, *, size):
    y = F.interpolate(x.movedim(-1, 1), size=(int(size[0]), int(size[1])),
                      mode="nearest-exact")
    return y.movedim(1, -1)


def _colorspace(mat):
    def fwd(x):
        return x @ torch.as_tensor(mat.T, dtype=x.dtype, device=x.device)
    return fwd


_RGB_YIQ = np.array([[0.299, 0.587, 0.114],
                     [0.59590059, -0.27455667, -0.32134392],
                     [0.21153661, -0.52273617, 0.31119955]], np.float32)
_RGB_YUV = np.array([[0.299, 0.587, 0.114],
                     [-0.14714119, -0.28886916, 0.43601035],
                     [0.61497538, -0.51496512, -0.10001026]], np.float32)


def _reflect_index(n: int, lo: int, hi: int, symmetric: bool) -> np.ndarray:
    """numpy's ``reflect`` / ``symmetric`` pad as an index array."""
    idx = np.arange(-lo, n + hi)
    if symmetric:
        period = 2 * n
        m = np.mod(idx, period)
        return np.where(m < n, m, period - 1 - m)
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    m = np.mod(idx, period)
    return np.where(m < n, m, period - m)


def _mirror_pad(x, *, paddings, mode="REFLECT"):
    sym = str(mode).upper() != "REFLECT"
    for d, (lo, hi) in enumerate(paddings):
        if lo == 0 and hi == 0:
            continue
        idx = torch.as_tensor(_reflect_index(x.shape[d], int(lo), int(hi), sym),
                              device=x.device)
        x = x.index_select(d, idx)
    return x


def _max_pool_patches(x, kernel, stride, padding):
    b, h, w, c = x.shape
    kh, kw = kernel
    sh, sw = stride
    if padding == "SAME":
        oh, ow = -(-h // sh), -(-w // sw)
        ph = max((oh - 1) * sh + kh - h, 0)
        pw = max((ow - 1) * sw + kw - w, 0)
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
                  value=float("-inf"))
        off_h, off_w = -(ph // 2), -(pw // 2)
    else:
        oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
        off_h = off_w = 0
    vals, idxs = [], []
    for i in range(kh):
        for j in range(kw):
            sub = x[:, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw, :]
            vals.append(sub)
            yy = torch.arange(oh, device=x.device) * sh + i + off_h
            zz = torch.arange(ow, device=x.device) * sw + j + off_w
            flat = yy[:, None] * w + zz[None, :]
            idxs.append(flat[None, :, :, None].expand(sub.shape))
    return torch.stack(vals), torch.stack(idxs)


def _max_pool_with_argmax(x, *, kernel=(2, 2), stride=(2, 2), padding="VALID"):
    return torch.amax(_max_pool_patches(x, tuple(kernel), tuple(stride), padding)[0], dim=0)


def _max_pool_with_argmax_indices(x, *, kernel=(2, 2), stride=(2, 2), padding="VALID",
                                  include_batch_in_index=False):
    b, h, w, c = x.shape
    vals, idxs = _max_pool_patches(x, tuple(kernel), tuple(stride), padding)
    best = torch.argmax(vals, dim=0)
    spatial = torch.take_along_dim(idxs, best[None], dim=0)[0]
    flat = spatial * c + torch.arange(c, device=x.device)[None, None, None, :]
    if include_batch_in_index:
        flat = flat + (torch.arange(b, device=x.device) * h * w * c)[:, None, None, None]
    return flat.to(torch.int32)


def _dilation2d(x, filt, *, stride=(1, 1), padding="SAME"):
    b, h, w, c = x.shape
    kh, kw, _ = filt.shape
    sh, sw = stride
    if padding == "SAME":
        oh, ow = -(-h // sh), -(-w // sw)
        ph = max((oh - 1) * sh + kh - h, 0)
        pw = max((ow - 1) * sw + kw - w, 0)
        x = F.pad(x, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2),
                  value=float("-inf"))
    else:
        oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    acc = None
    for i in range(kh):
        for j in range(kw):
            sub = x[:, i:i + (oh - 1) * sh + 1:sh, j:j + (ow - 1) * sw + 1:sw, :] + filt[i, j]
            acc = sub if acc is None else torch.maximum(acc, sub)
    return acc


def _erosion2d(x, filt, *, stride=(1, 1), padding="SAME"):
    return -_dilation2d(-x, torch.flip(filt, dims=(0, 1)), stride=stride, padding=padding)


# -- CTC ------------------------------------------------------------------------

def _ctc_loss(logits, labels, *, logit_lengths=None, label_lengths=None, blank=0):
    """The log-alpha forward recursion over the blank-interleaved label
    string, one time step at a time (the JAX package's ``lax.scan``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    b, t, _ = logits.shape
    s = labels.shape[1]
    dev = logits.device
    labels = labels.long()
    if logit_lengths is None:
        logit_lengths = torch.full((b,), t, dtype=torch.long, device=dev)
    if label_lengths is None:
        label_lengths = torch.full((b,), s, dtype=torch.long, device=dev)
    logit_lengths, label_lengths = logit_lengths.long(), label_lengths.long()
    length = 2 * s + 1
    ext = torch.full((b, length), blank, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels
    neg = torch.tensor(-1e30, dtype=torch.float32, device=dev)
    if length >= 3:
        prev2 = F.pad(ext[:, :-2], (2, 0), value=-1)
    else:
        prev2 = torch.full_like(ext, -1)
    can_skip = (ext != blank) & (ext != prev2)
    emit0 = torch.take_along_dim(logp[:, 0], ext, dim=-1)
    pos = torch.arange(length, device=dev)[None, :]
    alpha = torch.where(pos <= 1, emit0, neg)
    if s == 0:
        alpha = torch.where(pos == 0, emit0, neg)

    def lse(a, c):
        m = torch.maximum(a, c)
        return m + torch.log1p(torch.exp(torch.minimum(a, c) - m))

    for step in range(1, t):
        shift1 = F.pad(alpha[:, :-1], (1, 0), value=-1e30)
        shift2 = (F.pad(alpha[:, :-2], (2, 0), value=-1e30) if length >= 3
                  else torch.full_like(alpha, -1e30))
        acc = lse(alpha, shift1)
        acc = torch.where(can_skip, lse(acc, shift2), acc)
        new = acc + torch.take_along_dim(logp[:, step], ext, dim=-1)
        alpha = torch.where((step < logit_lengths)[:, None], new, alpha)
    last = 2 * label_lengths - 1
    final = lse(torch.take_along_dim(alpha, torch.clamp_min(last, 0)[:, None], dim=1)[:, 0],
                torch.take_along_dim(alpha, (last + 1)[:, None], dim=1)[:, 0])
    final = torch.where(label_lengths == 0, alpha[:, 0], final)
    return torch.mean(-final)


def _ctc_greedy_decode(logits, *, blank=0, pad=-1):
    ids = torch.argmax(logits, dim=-1)
    prev = F.pad(ids[:, :-1], (1, 0), value=-1)
    keep = (ids != blank) & (ids != prev)
    pos = torch.cumsum(keep.long(), dim=1) - 1
    b, t = ids.shape
    out = torch.full((b, t + 1), pad, dtype=torch.long, device=ids.device)
    rows = torch.arange(b, device=ids.device)[:, None].expand(b, t)
    safe = torch.where(keep, pos, t)
    out[rows, safe] = torch.where(keep, ids, pad)
    return out[:, :t].to(torch.int32)


def _ctc_greedy_decode_lengths(logits, *, blank=0):
    ids = torch.argmax(logits, dim=-1)
    prev = F.pad(ids[:, :-1], (1, 0), value=-1)
    return torch.sum((ids != blank) & (ids != prev), dim=1).to(torch.int32)


def _ctc_beam_search(logits, *, beam_width=8, blank=0, symbol_topk=8, pad=-1):
    """CTC prefix beam search with fixed shapes (the JAX package's
    ``_ctc_beam_search``, batch rows in a loop): returns (prefixes (B, W,
    T), lengths (B, W), log_probs (B, W)), best first."""
    neg = -1e30
    b, t, c = logits.shape
    w = int(beam_width)
    k = min(int(symbol_topk), c)
    logp = torch.log_softmax(logits.float(), dim=-1)
    dev = logits.device
    outs = []
    for row in range(b):
        prefixes = torch.full((w, t), pad, dtype=torch.long, device=dev)
        lengths = torch.zeros((w,), dtype=torch.long, device=dev)
        pb = torch.full((w,), neg, device=dev)
        pb[0] = 0.0
        pnb = torch.full((w,), neg, device=dev)
        for step in range(t):
            lp = logp[row, step]
            top_v, top_i = _top_k(lp, k)
            last = torch.take_along_dim(prefixes, torch.clamp_min(lengths - 1, 0)[:, None],
                                        dim=1)[:, 0]
            lp_last = torch.where(lengths > 0, lp[torch.clamp_min(last, 0)],
                                  torch.tensor(neg, device=dev))
            stay_pb = torch.logaddexp(pb, pnb) + lp[blank]
            stay_pnb = pnb + lp_last
            is_rep = top_i[None, :] == last[:, None]
            base = torch.where(is_rep & (lengths > 0)[:, None], pb[:, None],
                               torch.logaddexp(pb, pnb)[:, None])
            ext_pnb = base + top_v[None, :]
            ext_pnb = torch.where((top_i[None, :] == blank) | (lengths >= t)[:, None],
                                  torch.tensor(neg, device=dev), ext_pnb)
            ext_prefix = prefixes.repeat_interleave(k, dim=0)
            pos = lengths.repeat_interleave(k)
            ext_prefix[torch.arange(w * k, device=dev), torch.clamp_max(pos, t - 1)] = \
                top_i.repeat(w)
            cand_prefix = torch.cat([prefixes, ext_prefix], dim=0)
            cand_len = torch.cat([lengths, torch.clamp_max(pos + 1, t)], dim=0)
            cand_pb = torch.cat([stay_pb, torch.full((w * k,), neg, device=dev)], dim=0)
            cand_pnb = torch.cat([stay_pnb, ext_pnb.reshape(-1)], dim=0)
            eq = ((cand_prefix[:, None, :] == cand_prefix[None, :, :]).all(dim=-1)
                  & (cand_len[:, None] == cand_len[None, :]))
            canon = torch.argmax(eq.to(torch.int32), dim=1)
            m = cand_pb.shape[0]
            owns = canon[None, :] == torch.arange(m, device=dev)[:, None]
            merged_pb = torch.logsumexp(torch.where(owns, cand_pb[None, :], neg), dim=1)
            merged_pnb = torch.logsumexp(torch.where(owns, cand_pnb[None, :], neg), dim=1)
            is_canon = canon == torch.arange(m, device=dev)
            score = torch.where(is_canon, torch.logaddexp(merged_pb, merged_pnb),
                                torch.tensor(neg, device=dev))
            _, keep = _top_k(score, w)
            prefixes, lengths = cand_prefix[keep], cand_len[keep]
            pb, pnb = merged_pb[keep], merged_pnb[keep]
        score = torch.logaddexp(pb, pnb)
        order = torch.argsort(-score, stable=True)
        outs.append((prefixes[order], lengths[order], score[order]))
    return (torch.stack([o[0] for o in outs]).to(torch.int32),
            torch.stack([o[1] for o in outs]).to(torch.int32),
            torch.stack([o[2] for o in outs]))


ctc_beam_search = _ctc_beam_search


# -- norms, attention, losses ---------------------------------------------------

def _instance_norm(x, gamma, beta, *, epsilon=1e-5):
    axes = tuple(range(1, x.dim() - 1))
    if not axes:        # no spatial axes: jnp reduces over none
        return (x - x) * torch.rsqrt(torch.zeros_like(x) + epsilon) * gamma + beta
    mu = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + epsilon) * gamma + beta


def _group_norm(x, gamma, beta, *, groups, epsilon=1e-5):
    shp = tuple(x.shape)
    c = shp[-1]
    g = x.reshape(shp[:-1] + (groups, c // groups))
    axes = tuple(range(1, x.dim() - 1)) + (x.dim(),)
    mu = torch.mean(g, dim=axes, keepdim=True)
    var = torch.var(g, dim=axes, keepdim=True, correction=0)
    g = (g - mu) * torch.rsqrt(var + epsilon)
    return g.reshape(shp) * gamma + beta


def _dot_product_attention(q, k, v, *, mask=None, causal=False):
    d = q.shape[-1]
    s = torch.einsum("...qd,...kd->...qk", q, k) / torch.sqrt(_f(d, q))
    if causal:
        t, n = s.shape[-2], s.shape[-1]
        cm = torch.ones((t, n), dtype=torch.bool, device=q.device).tril()
        s = torch.where(cm, s, _f(-1e30, s))
    if mask is not None:
        s = torch.where(mask.bool(), s, _f(-1e30, s))
    return torch.einsum("...qk,...kd->...qd", torch.softmax(s, dim=-1), v)


def _multi_head_attention(x, wq, wk, wv, wo, *, heads, causal=False):
    b, t, d = x.shape
    dh = d // heads

    def split(z):
        return z.reshape(b, t, heads, dh).permute(0, 2, 1, 3)

    o = _dot_product_attention(split(x @ wq), split(x @ wk), split(x @ wv), causal=causal)
    return o.permute(0, 2, 1, 3).reshape(b, t, d) @ wo


def _mixture_density_loss(params, target, *, components):
    b, d = target.shape
    k = components
    logit_pi = params[:, :k]
    mu = params[:, k:k + k * d].reshape(b, k, d)
    log_sig = params[:, k + k * d:].reshape(b, k, d)
    log_pi = torch.log_softmax(logit_pi, dim=-1)
    z = (target[:, None, :] - mu) * torch.exp(-log_sig)
    comp = (-0.5 * torch.sum(torch.square(z), dim=-1) - torch.sum(log_sig, dim=-1)
            - 0.5 * d * math.log(2 * math.pi))
    return torch.mean(-torch.logsumexp(log_pi + comp, dim=-1))


def _log_poisson_loss(logits, targets, *, compute_full_loss=False):
    out = torch.exp(logits) - targets * logits
    if compute_full_loss:
        safe = torch.clamp_min(targets, 1e-12)
        out = out + torch.where(targets > 1.0, targets * torch.log(safe) - targets
                                + 0.5 * torch.log(2 * math.pi * safe), 0.0)
    return torch.mean(out)


def _mean_pairwise_squared_error(pred, lab):
    d = (pred - lab).reshape(pred.shape[0], -1)
    n = float(d.shape[1])
    return torch.mean(2.0 * (n * torch.sum(torch.square(d), dim=-1)
                             - torch.square(torch.sum(d, dim=-1))) / max(n * (n - 1), 1.0))


def _focal_loss(logits, labels, *, gamma=2.0, alpha=0.25):
    sig = torch.sigmoid(logits)
    return torch.mean(-labels * alpha * torch.pow(1 - sig, gamma) * F.logsigmoid(logits)
                      - (1 - labels) * (1 - alpha) * torch.pow(sig, gamma)
                      * F.logsigmoid(-logits))


def _in_top_k(predictions, targets, *, k):
    tgt = torch.take_along_dim(predictions, targets[:, None].long(), dim=-1)
    return torch.sum((predictions > tgt).to(torch.int32), dim=-1) < k


def _choose(idx, x):
    """``jnp.choose(idx, x, mode="clip")``: x's rows are the choices."""
    n = x.shape[0]
    i = torch.clamp(idx.long(), 0, n - 1)
    shape = torch.broadcast_shapes(tuple(i.shape), tuple(x.shape[1:]))
    lead = len(shape) - (x.dim() - 1)
    xs = x.reshape((n,) + (1,) * lead + tuple(x.shape[1:])).expand((n,) + tuple(shape))
    return torch.gather(xs, 0, i.expand(shape)[None])[0]


def _bit_count(x, bits: int):
    """Set bits of each value's low ``bits`` bits (two's complement)."""
    v = x.to(torch.int64) & ((1 << bits) - 1)
    count = torch.zeros_like(v)
    for _ in range(bits):
        count += v & 1
        v = v >> 1
    return count.to(torch.int32)


_WIDTH = {torch.int8: 8, torch.uint8: 8, torch.int16: 16, torch.bool: 1}


def _bitcast(x, *, dtype):
    return x.view(torch_dtype(dtype))


def _put_along_axis(x, idx, vals, *, axis=-1):
    return torch.scatter(x, axis, idx.long(), vals.to(x.dtype).expand(idx.shape)
                         if vals.dim() else vals.to(x.dtype).expand(idx.shape))


# -- numpy-parity tail ------------------------------------------------------------

def _interp(x, xp, fp):
    idx = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(), right=True),
                      1, xp.shape[0] - 1)
    x0, x1 = xp[idx - 1], xp[idx]
    f0, f1 = fp[idx - 1], fp[idx]
    df = f1 - f0
    dx = x1 - x0
    delta = x - x0
    eps = torch.finfo(dx.dtype).eps
    out = torch.where(dx <= eps, f0, f0 + (delta / torch.where(dx <= eps, 1.0, dx)) * df)
    out = torch.where(x < xp[0], fp[0], out)
    return torch.where(x > xp[-1], fp[-1], out)


def _unwrap(p, *, axis=-1):
    dd = torch.diff(p, dim=axis)
    ddmod = torch.remainder(dd + math.pi, 2 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0), _f(math.pi, ddmod), ddmod)
    corr = torch.where(dd.abs() < math.pi, 0.0, ddmod - dd)
    first = p.narrow(axis, 0, 1)
    return torch.cat([first, p.narrow(axis, 1, p.shape[axis] - 1)
                      + torch.cumsum(corr, dim=axis)], dim=axis)


def _polyval(coeffs, x):
    out = torch.zeros_like(x) if x.is_floating_point() else torch.zeros_like(x, dtype=_F32)
    for c in coeffs:
        out = out * x + c
    return out


def _polyder(coeffs, *, m=1):
    for _ in range(m):
        n = coeffs.shape[0] - 1
        coeffs = coeffs[:-1] * torch.arange(n, 0, -1, device=coeffs.device, dtype=coeffs.dtype)
    return coeffs


def _polyint(coeffs, *, m=1):
    for _ in range(m):
        n = coeffs.shape[0]
        coeffs = torch.cat([coeffs / torch.arange(n, 0, -1, device=coeffs.device,
                                                  dtype=coeffs.dtype),
                            coeffs.new_zeros((1,))])
    return coeffs


def _convolve(a, v, *, mode="full"):
    n, m = a.shape[0], v.shape[0]
    if m > n:
        a, v, n, m = v, a, m, n
    full = F.conv1d(a[None, None], torch.flip(v, dims=(0,))[None, None],
                    padding=m - 1)[0, 0]
    if mode == "full":
        return full
    if mode == "same":
        start = (m - 1) // 2
        return full[start:start + n]
    return full[m - 1:n]


def _correlate(a, v, *, mode="full"):
    return _convolve(a, torch.flip(v, dims=(0,)).conj(), mode=mode)


def _partition(x, *, kth, axis=-1):
    arr = x.movedim(axis, -1)
    bottom = -_top_k(-arr, kth + 1)[0]
    top = _top_k(arr, arr.shape[-1] - kth - 1)[0]
    return torch.cat([bottom, top], dim=-1).movedim(-1, axis)


def _argpartition(x, *, kth, axis=-1):
    arr = x.movedim(axis, -1)
    bottom = _top_k(-arr, kth + 1)[1]
    proxy = torch.ones(arr.shape, device=x.device).scatter(-1, bottom, 0.0)
    top = _top_k(proxy, arr.shape[-1] - kth - 1)[1]
    return torch.cat([bottom, top], dim=-1).movedim(-1, axis)


def _lexsort(*keys):
    """``jnp.lexsort``: along the last axis, the last key primary."""
    idx = torch.arange(keys[0].shape[-1], device=keys[0].device).expand(keys[0].shape)
    for k in keys:
        order = torch.argsort(torch.take_along_dim(k, idx, dim=-1), dim=-1, stable=True)
        idx = torch.take_along_dim(idx, order, dim=-1)
    return idx


def _repeat(x, *, repeats, axis=None):
    if axis is None:
        x, axis = x.reshape(-1), 0
    return x.repeat_interleave(repeats, dim=axis)


def _compress(cond, x, *, axis=None, size, fill=0):
    if axis is None:
        x, axis = x.reshape(-1), 0
    keep = torch.nonzero(cond.bool().reshape(-1)).reshape(-1)
    picked = x.index_select(axis, keep[:size])
    short = size - picked.shape[axis]
    if short > 0:
        pad_shape = list(picked.shape)
        pad_shape[axis] = short
        picked = torch.cat([picked, torch.full(pad_shape, fill, dtype=x.dtype,
                                               device=x.device)], dim=axis)
    return picked


def _fill_diagonal(x, *, value):
    k = min(x.shape[-2], x.shape[-1])
    out = x.clone()
    idx = torch.arange(k, device=x.device)
    out[..., idx, idx] = value
    return out


def _toeplitz(c, r=None):
    """``jax.scipy.linalg.toeplitz``, batched over leading axes."""
    r = c if r is None else r
    vals = torch.cat([torch.flip(r[..., 1:], dims=(-1,)), c], dim=-1)
    n, m = c.shape[-1], r.shape[-1]
    i = torch.arange(n, device=c.device)[:, None]
    j = torch.arange(m, device=c.device)[None, :]
    return vals[..., (m - 1) + i - j]


def _detrend(x):
    n = x.shape[-1]
    t = torch.arange(n, dtype=_F32, device=x.device)
    tc = t - t.mean()
    xm = torch.mean(x, dim=-1, keepdim=True)
    slope = torch.sum((x - xm) * tc, dim=-1, keepdim=True) / torch.sum(tc * tc)
    return x - xm - slope * tc


def _medfilt(x, *, kernel=3):
    k = int(kernel)
    if k % 2 != 1:
        raise ValueError("medfilt kernel must be odd")
    pad = k // 2
    xp = torch.cat([x[..., :1].expand(x.shape[:-1] + (pad,)), x,
                    x[..., -1:].expand(x.shape[:-1] + (pad,))], dim=-1)
    stacked = torch.stack([xp[..., i:i + x.shape[-1]] for i in range(k)], dim=0)
    return torch.quantile(stacked, 0.5, dim=0)


def _pearson(a, b):
    a = a.to(_F32).reshape(-1)
    b = b.to(_F32).reshape(-1)
    ac, bc = a - torch.mean(a), b - torch.mean(b)
    return torch.sum(ac * bc) / torch.clamp_min(
        torch.sqrt(torch.sum(ac * ac) * torch.sum(bc * bc)), 1e-12)


def _spearman(a, b):
    def ranks(x):
        s = torch.sort(x).values
        lo = torch.searchsorted(s, x, right=False)
        hi = torch.searchsorted(s, x, right=True)
        return (lo + hi - 1).to(_F32) / 2.0
    return _pearson(ranks(a.reshape(-1).contiguous()), ranks(b.reshape(-1).contiguous()))


def _confusion_counts(pred, lab):
    pred = pred.bool().reshape(-1)
    lab = lab.bool().reshape(-1)
    return tuple(torch.sum(m).to(_F32) for m in
                 (pred & lab, pred & ~lab, ~pred & lab, ~pred & ~lab))


def _f1(pred, lab):
    tp, fp, fn, _ = _confusion_counts(pred, lab)
    return 2 * tp / torch.clamp_min(2 * tp + fp + fn, 1e-12)


def _mcc(pred, lab):
    tp, fp, fn, tn = _confusion_counts(pred, lab)
    denom = torch.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    return (tp * tn - fp * fn) / torch.clamp_min(denom, 1e-12)


def _cohen_kappa(pred, lab):
    tp, fp, fn, tn = _confusion_counts(pred, lab)
    n = tp + fp + fn + tn
    po = (tp + tn) / n
    pe = ((tp + fp) * (tp + fn) + (fn + tn) * (fp + tn)) / (n * n)
    return (po - pe) / torch.clamp_min(1.0 - pe, 1e-12)


def _ema(x, *, alpha):
    c = x[..., 0]
    outs = []
    for i in range(x.shape[-1]):
        c = (1 - alpha) * c + alpha * x[..., i]
        outs.append(c)
    return torch.stack(outs, dim=-1)


def _ensure_shape(x, *, shape):
    shape = tuple(shape)
    if len(shape) != x.dim() or any(
            s not in (None, -1) and int(s) != d for s, d in zip(shape, x.shape)):
        raise ValueError(f"ensure_shape: got {tuple(x.shape)}, expected {shape}")
    return x


def _unique_with_pad(x, *, size, fill=0):
    u = torch.unique(x.reshape(-1), sorted=True)[:size]
    if u.shape[0] < size:
        u = torch.cat([u, torch.full((size - u.shape[0],), fill, dtype=x.dtype,
                                     device=x.device)])
    return u


def _fake_quant(x, *, min_val=-6.0, max_val=6.0, num_bits=8):
    n = 2 ** num_bits - 1
    scale = (max_val - min_val) / n
    clipped = torch.clamp(x, min_val, max_val)
    q = torch.round((clipped - min_val) / scale) * scale + min_val
    return clipped + (q - clipped).detach()


def _cbrt(x):
    return torch.sign(x) * torch.pow(x.abs(), 1.0 / 3.0)


def _heaviside(x, *, value=0.5):
    return torch.heaviside(x, _f(value, x))


def _cross(a, b, *, axis=-1):
    return torch.linalg.cross(a, b, dim=axis)


def _matrix_norm(x, *, ord="fro"):
    return torch.linalg.matrix_norm(x, ord=ord)


def _lstsq(a, b):
    return torch.linalg.lstsq(a, b, driver="gelsd").solution


def _floor_div(a, b):
    if a.is_floating_point() or b.is_floating_point():
        return torch.floor(a / b)
    return torch.floor_divide(a, b)


def _softmin(x, *, axis=-1):
    return torch.softmax(-x, dim=axis)


def _l2_normalize(x, *, axis=-1, epsilon=1e-12):
    return x * torch.rsqrt(torch.clamp_min(_sum(torch.square(x), axis, True), epsilon))


def _clip_by_avg_norm(x, *, clip_norm):
    return x * torch.clamp_max(clip_norm / torch.clamp_min(
        torch.sqrt(torch.sum(torch.square(x))) / x.numel(), 1e-12), 1.0)


def _nth_element(x, *, n, reverse=False):
    s = torch.sort(x, dim=-1).values
    return s[..., x.shape[-1] - 1 - n] if reverse else s[..., n]


def _vander(x, *, n):
    return torch.vander(x, N=n)


def _matrix_rank(x):
    return torch.linalg.matrix_rank(x).to(_F32)


def _slogdet_sign(x):
    return torch.linalg.slogdet(x)[0]


def _logdet(x):
    return torch.linalg.slogdet(x)[1]


def _triangular_solve(a, b, *, lower=True):
    return torch.linalg.solve_triangular(a, b, upper=not lower)


def _cholesky_inverse(low):
    return torch.cholesky_inverse(low, upper=False)


def _multi_dot(*ms):
    return torch.linalg.multi_dot(list(ms))


def _vdot(a, b):
    return torch.vdot(a.reshape(-1), b.reshape(-1))


OPS: dict = {
    # elementwise arithmetic
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.true_divide,
    "pow": torch.pow,
    "neg": torch.neg,
    "abs": torch.abs,
    "exp": torch.exp,
    "log": torch.log,
    "sqrt": torch.sqrt,
    "square": torch.square,
    "rsqrt": torch.rsqrt,
    "sign": torch.sign,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "clip": lambda x, *, lo, hi: torch.clamp(x, lo, hi),
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    # comparisons / selection
    "greater": _cmp(torch.gt),
    "less": _cmp(torch.lt),
    "equal": _cmp(torch.eq),
    "where": _where,
    # linalg
    "matmul": torch.matmul,
    "transpose": _transpose,
    "einsum": lambda *xs, equation: torch.einsum(equation, *xs),
    "tensordot": _tensordot,
    # shape
    "reshape": lambda x, *, shape: x.reshape(tuple(int(s) for s in shape)),
    "onnx_reshape": lambda x, *, shape: x.reshape(
        tuple(x.shape[i] if s == 0 else int(s) for i, s in enumerate(shape))),
    "onnx_slice": _onnx_slice,
    "concat": lambda *xs, axis=-1: torch.cat(xs, dim=axis),
    "stack": lambda *xs, axis=0: torch.stack(xs, dim=axis),
    "squeeze": _squeeze,
    "expand_dims": _expand_dims,
    "slice": _slice,
    "gather": _gather,
    "one_hot": _one_hot,
    "tile": lambda x, *, reps: torch.tile(x, tuple(reps)),
    "pad": _pad,
    # reductions
    "sum": lambda x, *, axis=None, keepdims=False: _sum(x, axis, keepdims),
    "mean": lambda x, *, axis=None, keepdims=False: _mean(x, axis, keepdims),
    "max": lambda x, *, axis=None, keepdims=False: _amax(x, axis, keepdims),
    "min": lambda x, *, axis=None, keepdims=False: _amin(x, axis, keepdims),
    "prod": lambda x, *, axis=None, keepdims=False: _prod(x, axis, keepdims),
    "var": lambda x, *, axis=None, keepdims=False: _var(x, axis, keepdims),
    "std": lambda x, *, axis=None, keepdims=False: _std(x, axis, keepdims),
    "argmax": lambda x, *, axis=-1: _argmax(x, axis),
    "argmin": lambda x, *, axis=-1: _argmin(x, axis),
    "norm2": lambda x, *, axis=None: _norm(x, axis),
    "cumsum": lambda x, *, axis=0: torch.cumsum(x, dim=axis),
    # activations
    "relu": torch.relu,
    "relu6": _relu6,
    "leaky_relu": lambda x, *, alpha=0.01: torch.where(x >= 0, x, alpha * x),
    "elu": _elu,
    "selu": _selu,
    "gelu": _gelu,
    "silu": lambda x: x * torch.sigmoid(x),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": lambda x, *, axis=-1: torch.softmax(x, dim=axis),
    "log_softmax": lambda x, *, axis=-1: _log_softmax(x, axis),
    "softplus": _softplus,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "asin": torch.asin,
    "acos": torch.acos,
    "atan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "asinh": torch.asinh,
    "acosh": torch.acosh,
    "atanh": torch.atanh,
    "round": torch.round,
    "trunc": torch.trunc,
    "is_nan": lambda x: torch.isnan(x).to(_F32),
    "is_inf": lambda x: torch.isinf(x).to(_F32),
    "is_finite": lambda x: torch.isfinite(x).to(_F32),
    "log1p": torch.log1p,
    "expm1": torch.expm1,
    "erfc": torch.special.erfc,
    "cube": lambda x: x * x * x,
    "softsign": lambda x: x / (x.abs() + 1),
    "hard_sigmoid": lambda x: _relu6(x + 3.0) / 6.0,
    "hard_tanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "rationaltanh": _rationaltanh,
    "logsumexp": lambda x, *, axis=None, keepdims=False: _reduce(
        lambda t, d, k: torch.logsumexp(t, dim=d, keepdim=k), x, axis, keepdims),
    "cumprod": lambda x, *, axis=0: torch.cumprod(x, dim=axis),
    "sort": _sort,
    "argsort": _argsort,
    "top_k_values": lambda x, *, k: _top_k(x, k)[0],
    "top_k_indices": lambda x, *, k: _top_k(x, k)[1],
    "segment_sum": lambda x, ids, *, num_segments: _segment(x, ids, num_segments, "sum"),
    "segment_max": lambda x, ids, *, num_segments: _segment(x, ids, num_segments, "amax"),
    "segment_min": lambda x, ids, *, num_segments: _segment(x, ids, num_segments, "amin"),
    "segment_mean": _segment_mean,
    "reverse": lambda x, *, axis: torch.flip(x, dims=_dims(x, axis)),
    "roll": lambda x, *, shift, axis: torch.roll(x, shift, dims=axis),
    # TF-import primitives
    "identity": lambda x: x,
    "stop_gradient": lambda x: x.detach(),
    "erf": torch.erf,
    "cast": _cast,
    "squared_difference": lambda a, b: torch.square(a - b),
    "greater_equal": _cmp(torch.ge),
    "less_equal": _cmp(torch.le),
    "not_equal": _cmp(torch.ne),
    "logical_and": lambda a, b: ((a > 0) & (b > 0)).to(_F32),
    "logical_or": lambda a, b: ((a > 0) | (b > 0)).to(_F32),
    "logical_not": lambda a: (~(a > 0)).to(_F32),
    "reciprocal": lambda x: 1.0 / x,
    "floor_div": _floor_div,
    "mod": torch.remainder,
    "atan2": torch.atan2,
    "multi_head_dot_product_attention": _mhdpa,
    # nn composites
    "conv2d": _conv2d,
    "max_pool2d": _pool("max"),
    "avg_pool2d": _pool("avg"),
    "layer_norm": _layer_norm,
    "bias_add": lambda x, b: x + b,
    "dropout": lambda x, *, rate=0.5, seed=0: x,   # inference identity; fit draws masks
    # losses
    "softmax_cross_entropy": _softmax_cross_entropy,
    "sparse_softmax_cross_entropy": _sparse_softmax_cross_entropy,
    "sigmoid_cross_entropy": _sigmoid_cross_entropy,
    "mse_loss": lambda pred, lab: torch.mean(torch.square(pred - lab)),
    "l1_loss": lambda pred, lab: torch.mean((pred - lab).abs()),
    # cnn extras
    "conv1d": _conv1d,
    "conv3d": _conv3d,
    "depthwise_conv2d": _depthwise_conv2d,
    "deconv2d": _deconv2d,
    "batch_norm": _batch_norm,
    "im2col": _im2col,
    "space_to_depth": _space_to_depth,
    "depth_to_space": _depth_to_space,
    # rnn cells
    "lstm_cell": _lstm_cell,
    "gru_cell": _gru_cell,
    # image ops
    "crop": _crop,
    "flip_lr": lambda x: torch.flip(x, dims=(2,)),
    "flip_ud": lambda x: torch.flip(x, dims=(1,)),
    "adjust_brightness": lambda x, *, delta: x + delta,
    "adjust_contrast": _adjust_contrast,
    "rgb_to_grayscale": _rgb_to_grayscale,
    "normalize_image": lambda x, mean, std: (x - mean) / std,
    # linalg
    "inv": torch.linalg.inv,
    "det": torch.linalg.det,
    "cholesky": torch.linalg.cholesky,
    "solve": torch.linalg.solve,
    "svd": lambda x: torch.linalg.svdvals(x),
    "qr": lambda x: torch.linalg.qr(x)[0],
    "matrix_trace": lambda x: torch.diagonal(x, dim1=-2, dim2=-1).sum(-1),
    "diag": lambda x: torch.diag(x),
    "diag_part": lambda x: torch.diagonal(x, dim1=-2, dim2=-1),
    "matrix_transpose": lambda x: x.transpose(-1, -2),
    "lstsq": _lstsq,
    "triu": lambda x, *, k=0: torch.triu(x, k),
    "tril": lambda x, *, k=0: torch.tril(x, k),
    # bitwise
    "bitwise_and": lambda a, b: torch.bitwise_and(a.to(torch.int32), b.to(torch.int32)),
    "bitwise_or": lambda a, b: torch.bitwise_or(a.to(torch.int32), b.to(torch.int32)),
    "bitwise_xor": lambda a, b: torch.bitwise_xor(a.to(torch.int32), b.to(torch.int32)),
    "bitwise_not": lambda a: torch.bitwise_not(a.to(torch.int32)),
    "left_shift": lambda a, *, bits: torch.bitwise_left_shift(a.to(torch.int32), bits),
    "right_shift": lambda a, *, bits: torch.bitwise_right_shift(a.to(torch.int32), bits),
    # reduce3 family
    "dot": lambda a, b, *, axis=None: _sum(a * b, axis),
    "cosine_similarity": _cosine_similarity,
    "cosine_distance": lambda a, b, *, axis=-1: 1.0 - _cosine_similarity(a, b, axis=axis),
    "euclidean_distance": lambda a, b, *, axis=None: torch.sqrt(_sum(torch.square(a - b), axis)),
    "manhattan_distance": lambda a, b, *, axis=None: _sum((a - b).abs(), axis),
    "hamming_distance": lambda a, b, *, axis=None: _sum((a != b).to(_F32), axis),
    "jaccard_distance": lambda a, b, *, axis=None: 1.0 - _sum(torch.minimum(a, b), axis)
    / torch.clamp_min(_sum(torch.maximum(a, b), axis), 1e-12),
    # reduction breadth
    "norm1": lambda x, *, axis=None, keepdims=False: _sum(x.abs(), axis, keepdims),
    "norm_max": lambda x, *, axis=None, keepdims=False: _amax(x.abs(), axis, keepdims),
    "squared_norm": lambda x, *, axis=None, keepdims=False: _sum(torch.square(x), axis,
                                                                 keepdims),
    "count_nonzero": lambda x, *, axis=None: _sum((x != 0).to(_F32), axis),
    "count_zero": lambda x, *, axis=None: _sum((x == 0).to(_F32), axis),
    "amean": lambda x, *, axis=None: _mean(x.abs(), axis),
    "amax": lambda x, *, axis=None: _amax(x.abs(), axis),
    "amin": lambda x, *, axis=None: _amin(x.abs(), axis),
    "entropy": _entropy,
    "shannon_entropy": lambda x, *, axis=None: _entropy(x, axis=axis) / math.log(2.0),
    "log_entropy": lambda x, *, axis=None: torch.log(torch.clamp_min(
        _entropy(x, axis=axis), 1e-12)),
    "moments": _moments,
    "percentile": _percentile,
    "median": _median,
    "iamax": lambda x, *, axis=-1: _argmax(x.abs(), axis),
    "iamin": lambda x, *, axis=-1: _argmin(x.abs(), axis),
    "first_index_nonzero": _first_index_nonzero,
    "last_index_nonzero": _last_index_nonzero,
    # scatter family
    "scatter_add": _scatter("add"),
    "scatter_sub": lambda ref, idx, upd: _scatter("add")(ref, idx, -upd),
    "scatter_mul": _scatter("prod"),
    "scatter_update": _scatter("set"),
    "scatter_max": _scatter("amax"),
    "scatter_min": _scatter("amin"),
    "gather_nd": _gather_nd,
    "scatter_nd": _scatter_nd,
    # random family (seed is a static attr)
    "random_normal": _rand("normal"),
    "random_uniform": _rand("uniform"),
    "random_bernoulli": _rand("bernoulli"),
    # creation
    "zeros_like": torch.zeros_like,
    "ones_like": torch.ones_like,
    "full_like": lambda x, *, value: torch.full_like(x, value),
    "eye": lambda *, n, m=None: torch.eye(n, n if m is None else m, device=_dev()),
    "linspace": lambda *, start, stop, num: torch.linspace(start, stop, num, device=_dev()),
    "range": lambda *, start, limit, delta=1: torch.arange(start, limit, delta,
                                                           dtype=_F32, device=_dev()),
    "fill": lambda *, shape, value: torch.full(tuple(shape), value, dtype=_F32,
                                               device=_dev()),
    # sequence ops
    "reverse_sequence": _reverse_sequence,
    "sequence_mask": _sequence_mask,
    # matrix structure
    "matrix_band_part": _matrix_band_part,
    "matrix_diag": _matrix_diag,
    "matrix_set_diag": _matrix_set_diag,
    # image breadth
    "rgb_to_hsv": _rgb_to_hsv,
    "hsv_to_rgb": _hsv_to_rgb,
    "adjust_hue": _adjust_hue,
    "adjust_saturation": _adjust_saturation,
    "crop_and_resize": _crop_and_resize,
    "non_max_suppression": _non_max_suppression,
    "space_to_batch": _space_to_batch,
    "batch_to_space": _batch_to_space,
    "broadcast_to": lambda x, *, shape: x.expand(tuple(shape)),
    "lrn": _lrn_onnx,
    # nn / misc breadth
    "prelu": lambda x, alpha: torch.where(x >= 0, x, alpha * x),
    "thresholded_relu": lambda x, *, theta=1.0: torch.where(x > theta, x, 0.0),
    "log_sigmoid": lambda x: -_softplus(-x),
    "mish": lambda x: x * torch.tanh(_softplus(x)),
    "swish": lambda x: x * torch.sigmoid(x),
    "standardize": _standardize,
    "clip_by_norm": _clip_by_norm,
    "xw_plus_b": lambda x, w, b: x @ w + b,
    "confusion_matrix": _confusion_matrix,
    # special math
    "lgamma": torch.lgamma,
    "digamma": torch.digamma,
    "igamma": torch.special.gammainc,
    "igammac": torch.special.gammaincc,
    "zeta": torch.special.zeta,
    "polygamma": lambda x, *, n: torch.polygamma(n, x),
    "truncate_div": lambda a, b: torch.trunc(a / b),
    "floor_mod": torch.remainder,
    # exotic reductions tail
    "all": lambda x, *, axis=None, keepdims=False: _all(x, axis, keepdims),
    "any": lambda x, *, axis=None, keepdims=False: _any(x, axis, keepdims),
    "cumulative_logsumexp": lambda x, *, axis=-1: torch.logcumsumexp(x, dim=axis),
    "segment_prod": lambda x, ids, *, num_segments: _segment(x, ids, num_segments, "prod"),
    "unique_with_pad": _unique_with_pad,
    "bincount": lambda x, *, length: torch.bincount(
        x.long().reshape(-1), minlength=length)[:length],
    "searchsorted": lambda sorted_seq, values, *, side="left": torch.searchsorted(
        sorted_seq.contiguous(), values.contiguous(), right=(side == "right")),
    "invert_permutation": lambda x: torch.argsort(x.to(torch.int32), stable=True),
    "histogram_fixed_width": _histogram_fixed_width,
    "nan_to_num": lambda x, *, nan=0.0, posinf=None, neginf=None: torch.nan_to_num(
        x, nan=nan, posinf=posinf, neginf=neginf),
    # linalg tail
    "eigh_values": lambda x: torch.linalg.eigvalsh(x),
    "eigh_vectors": lambda x: torch.linalg.eigh(x)[1],
    "logdet": _logdet,
    "slogdet_sign": _slogdet_sign,
    "pinv": torch.linalg.pinv,
    "triangular_solve": _triangular_solve,
    "matrix_power": lambda x, *, n: torch.linalg.matrix_power(x, n),
    "kron": torch.kron,
    "matrix_rank": _matrix_rank,
    "expm": torch.linalg.matrix_exp,
    # loss-function tail
    "huber_loss": _huber_loss,
    "hinge_loss": lambda pred, target: torch.mean(torch.clamp_min(1.0 - target * pred, 0.0)),
    "log_loss": lambda pred, target: -torch.mean(
        target * torch.log(torch.clamp(pred, 1e-7, 1.0))
        + (1.0 - target) * torch.log(torch.clamp(1.0 - pred, 1e-7, 1.0))),
    "absolute_difference": lambda pred, target: torch.mean((pred - target).abs()),
    "poisson_loss": lambda pred, target: torch.mean(
        pred - target * torch.log(torch.clamp_min(pred, 1e-7))),
    "kl_divergence": _kl_divergence,
    "cosine_proximity_loss": lambda pred, target: -torch.mean(
        torch.sum(pred * target, -1) / torch.clamp_min(
            _norm(pred, -1) * _norm(target, -1), 1e-12)),
    # random tail
    "random_truncated_normal": _rand("truncated_normal"),
    "random_categorical": _random_categorical,
    # activation tail
    "hard_swish": lambda x: x * _relu6(x + 3.0) / 6.0,
    "celu": lambda x, *, alpha=1.0: torch.where(
        x > 0, x, alpha * torch.expm1(torch.where(x > 0, 0.0, x) / alpha)),
    "glu": lambda x, *, axis=-1: (lambda a, b: a * torch.sigmoid(b))(
        *torch.chunk(x, 2, dim=axis)),
    "softshrink": lambda x, *, lambd=0.5: torch.sign(x) * torch.clamp_min(x.abs() - lambd,
                                                                            0.0),
    "hardshrink": lambda x, *, lambd=0.5: torch.where(x.abs() > lambd, x, 0.0),
    "tanhshrink": lambda x: x - torch.tanh(x),
    # elementwise tail
    "rint": torch.round,
    "heaviside": _heaviside,
    "copysign": torch.copysign,
    "nextafter": torch.nextafter,
    "deg2rad": torch.deg2rad,
    "rad2deg": torch.rad2deg,
    "sinc": torch.sinc,
    "logaddexp": torch.logaddexp,
    "logaddexp2": torch.logaddexp2,
    "hypot": torch.hypot,
    "signbit": lambda x: torch.signbit(x).to(_F32),
    "ldexp": lambda x, *, exp: x * (2.0 ** exp),
    "logit": torch.logit,
    "erfinv": torch.erfinv,
    "ndtr": torch.special.ndtr,
    "ndtri": torch.special.ndtri,
    "lerp": lambda a, b, *, weight: a + weight * (b - a),
    # ``jnp.bitwise_count`` in the value's own width
    "popcount": lambda x: _bit_count(x, _WIDTH.get(x.dtype, 32)),
    "isclose": lambda a, b, *, rtol=1e-5, atol=1e-8: torch.isclose(
        a, b, rtol=rtol, atol=atol).to(_F32),
    # NaN-aware / range reductions
    "nansum": _nanreduce(_sum, lambda x: 0.0),
    "nanmean": _nanmean,
    "nanmax": _nanreduce(_amax, lambda x: float("-inf")),
    "nanmin": _nanreduce(_amin, lambda x: float("inf")),
    "nanstd": _nanstd,
    "ptp": lambda x, *, axis=None: _amax(x, axis) - _amin(x, axis),
    "cummax": lambda x, *, axis=-1: torch.cummax(x, dim=axis).values,
    "cummin": lambda x, *, axis=-1: torch.cummin(x, dim=axis).values,
    # linalg tail 2
    "lu_factor": lambda x: torch.linalg.lu_factor(x)[0],
    "outer": torch.outer,
    "cross": _cross,
    "vander": _vander,
    "diagflat": torch.diagflat,
    "matrix_norm": _matrix_norm,
    "cond_number": torch.linalg.cond,
    # image tail
    "image_gradients": _image_gradients,
    "sobel_edges": _sobel_edges,
    "total_variation": _total_variation,
    "psnr": _psnr,
    "ssim": _ssim,
    "rot90": lambda x, *, k=1: torch.rot90(x, k, dims=(-3, -2)),
    "grayscale_to_rgb": _grayscale_to_rgb,
    "central_crop": _central_crop,
    # quantization
    "fake_quant": _fake_quant,
    # loss tail 2
    "weighted_cross_entropy_with_logits": lambda logits, labels, *, pos_weight: torch.mean(
        (1 - labels) * logits
        + (1 + (pos_weight - 1) * labels) * torch.log1p(torch.exp(-logits.abs()))
        + torch.clamp_min(-logits, 0.0) * (1 + (pos_weight - 1) * labels)),
    "log_cosh_loss": lambda pred, target: torch.mean(
        (pred - target).abs() + _softplus(-2.0 * (pred - target).abs()) - math.log(2.0)),
}

OPS["extract_image_patches"] = OPS["im2col"]
for _k in ("sum", "mean", "prod"):
    OPS[f"unsorted_segment_{_k}"] = OPS[f"segment_{_k}"]
OPS["unsorted_segment_max"] = _unsorted_segment_minmax("max")
OPS["unsorted_segment_min"] = _unsorted_segment_minmax("min")

OPS.update({
    # CTC family
    "ctc_loss": _ctc_loss,
    "ctc_greedy_decode": _ctc_greedy_decode,
    "ctc_greedy_decode_lengths": _ctc_greedy_decode_lengths,
    # morphology / argmax pooling
    "dilation2d": _dilation2d,
    "erosion2d": _erosion2d,
    "max_pool_with_argmax": _max_pool_with_argmax,
    "max_pool_with_argmax_indices": _max_pool_with_argmax_indices,
    # image tail 2
    "rgb_to_yiq": _colorspace(_RGB_YIQ),
    "yiq_to_rgb": _colorspace(np.linalg.inv(_RGB_YIQ)),
    "rgb_to_yuv": _colorspace(_RGB_YUV),
    "yuv_to_rgb": _colorspace(np.linalg.inv(_RGB_YUV)),
    "resize_bilinear": _resize_linear,
    "resize_nearest": _resize_nearest,
    "mirror_pad": _mirror_pad,
    "upsampling2d": lambda x, *, factor=(2, 2): x.repeat_interleave(
        factor[0], dim=1).repeat_interleave(factor[1], dim=2),
    "iou": _iou_matrix,
    "col2im": _col2im,
    # activations / nn tail
    "hardswish": lambda x: x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0,
    "softmin": _softmin,
    "rectifiedtanh": lambda x: torch.clamp_min(torch.tanh(x), 0.0),
    "relu_layer": lambda x, w, b: torch.relu(x @ w + b),
    "alpha_dropout": _alpha_dropout,
    # norms
    "instance_norm": _instance_norm,
    "group_norm": _group_norm,
    "local_response_normalization": _lrn_tf,
    "l2_normalize": _l2_normalize,
    "normalize_moments": lambda count, mean_ss, var_ss, *, shift=0.0: torch.stack([
        mean_ss / count + shift, var_ss / count - torch.square(mean_ss / count)]),
    "clip_by_avg_norm": _clip_by_avg_norm,
    # attention
    "dot_product_attention": _dot_product_attention,
    "multi_head_attention": _multi_head_attention,
    # loss-function parity
    "mae_loss": lambda pred, lab: torch.mean((pred - lab).abs()),
    "mape_loss": lambda pred, lab: torch.mean(
        ((lab - pred) / torch.clamp_min(lab.abs(), 1e-8)).abs()) * 100.0,
    "msle_loss": lambda pred, lab: torch.mean(torch.square(
        torch.log1p(torch.clamp_min(pred, -1 + 1e-7))
        - torch.log1p(torch.clamp_min(lab, -1 + 1e-7)))),
    "squared_hinge_loss": lambda pred, lab: torch.mean(torch.square(
        torch.clamp_min(1.0 - lab * pred, 0.0))),
    "kld_loss": lambda pred, lab: torch.mean(torch.sum(
        lab * (torch.log(torch.clamp_min(lab, 1e-12))
               - torch.log(torch.clamp_min(pred, 1e-12))), dim=-1)),
    "wasserstein_loss": lambda pred, lab: torch.mean(pred * lab),
    "multi_label_loss": lambda logits, labels: torch.mean(
        torch.clamp_min(logits, 0) - logits * labels
        + torch.log1p(torch.exp(-logits.abs()))),
    "fmeasure_loss": lambda pred, lab, *, beta=1.0: 1.0 - (
        (1 + beta ** 2) * torch.sum(pred * lab)
        / torch.clamp_min(beta ** 2 * torch.sum(lab) + torch.sum(pred), 1e-8)),
    "focal_loss": _focal_loss,
    "dice_loss": lambda pred, lab, *, smooth=1.0: 1.0 - (
        (2.0 * torch.sum(pred * lab) + smooth)
        / (torch.sum(torch.square(pred)) + torch.sum(torch.square(lab)) + smooth)),
    "log_poisson_loss": _log_poisson_loss,
    "mean_pairwise_squared_error": _mean_pairwise_squared_error,
    "cosine_embedding_loss": lambda a, b, y, *, margin=0.0: torch.mean(torch.where(
        y > 0, 1.0 - _cosine_similarity(a, b, axis=-1),
        torch.clamp_min(_cosine_similarity(a, b, axis=-1) - margin, 0.0))),
    "margin_ranking_loss": lambda x1, x2, y, *, margin=0.0: torch.mean(
        torch.clamp_min(-y * (x1 - x2) + margin, 0.0)),
    "triplet_margin_loss": lambda anchor, pos, neg, *, margin=1.0: torch.mean(
        torch.clamp_min(torch.sqrt(torch.sum(torch.square(anchor - pos), -1) + 1e-12)
                        - torch.sqrt(torch.sum(torch.square(anchor - neg), -1) + 1e-12)
                        + margin, 0.0)),
    "nll_loss": lambda logp, labels: -torch.mean(
        torch.take_along_dim(logp, labels[..., None].long(), dim=-1)),
    "mixture_density_loss": _mixture_density_loss,
    # math / array tail
    "erfcinv": lambda x: torch.erfinv(1.0 - x),
    "fmod": torch.fmod,
    "trace": lambda x: torch.diagonal(x, dim1=-2, dim2=-1).sum(-1),
    "matrix_diag_part": lambda x: torch.diagonal(x, dim1=-2, dim2=-1),
    "choose": _choose,
    "nth_element": _nth_element,
    "kth_value": lambda x, *, k: torch.sort(x, dim=-1).values[..., k - 1],
    "in_top_k": _in_top_k,
    "embedding_lookup": lambda table, ids: _gather(table, ids, axis=0),
    "tensor_scatter_update": lambda x, indices, updates: x.clone().index_put_(
        _nd_index(indices), updates.to(x.dtype)),
    "tensor_scatter_add": lambda x, indices, updates: x.clone().index_put_(
        _nd_index(indices), updates.to(x.dtype), accumulate=True),
    "matmul_transpose": lambda a, b, *, transpose_a=False, transpose_b=False: torch.matmul(
        a.transpose(-1, -2) if transpose_a else a, b.transpose(-1, -2) if transpose_b else b),
    "flatten_2d": lambda x: x.reshape(x.shape[0], -1),
    "reshape_as": lambda x, ref: x.reshape(ref.shape),
    "meshgrid_x": lambda x, y: torch.meshgrid(x, y, indexing="xy")[0],
    "meshgrid_y": lambda x, y: torch.meshgrid(x, y, indexing="xy")[1],
    "population_count": lambda x: _bit_count(x, 32),   # as uint32
    "bitcast": _bitcast,
    "complex": torch.complex,
    "conj": lambda x: torch.conj(x).resolve_conj() if x.is_complex() else x,
})

OPS["softmax_cross_entropy_with_logits"] = OPS["softmax_cross_entropy"]
OPS["mean_squared_error"] = OPS["mse_loss"]
OPS["batch_matmul"] = OPS["matmul"]
OPS["truncated_normal"] = OPS["random_truncated_normal"]
OPS["cross_entropy_loss"] = OPS["sparse_softmax_cross_entropy"]
OPS["histogram"] = OPS["histogram_fixed_width"]
OPS["top_k"] = OPS["top_k_values"]
OPS["cyclic_shift"] = OPS["roll"]
OPS["squared_hinge"] = OPS["squared_hinge_loss"]

OPS.update({
    "matrix_inverse": torch.linalg.inv,
    "log2": torch.log2,
    "log10": torch.log10,
    "exp2": torch.exp2,
    "frac": lambda x: x - torch.trunc(x),
    "remainder": torch.remainder,
    "gcd": torch.gcd,
    "lcm": torch.lcm,
    "swapaxes": lambda x, *, axis1, axis2: x.transpose(axis1, axis2),
    "moveaxis": lambda x, *, source, destination: x.movedim(source, destination),
    "flip_left_right": lambda x: torch.flip(x, dims=(-2,)),
    "flip_up_down": lambda x: torch.flip(x, dims=(-3,)),
    "adjust_gamma": lambda x, *, gamma=1.0, gain=1.0: gain * torch.pow(
        torch.clamp_min(x, 0.0), gamma),
    "take_along_axis": lambda x, idx, *, axis=-1: torch.take_along_dim(x, idx.long(),
                                                                         dim=axis),
    "put_along_axis": _put_along_axis,
    "array_equal": lambda a, b: torch.all(a == b),
    "strided_slice": _strided_slice,
    "l2_loss": lambda x: 0.5 * torch.sum(torch.square(x)),
})

OPS.update({
    # numpy-parity math / array tail
    "diff": lambda x, *, n=1, axis=-1: torch.diff(x, n=n, dim=axis),
    "ediff1d": lambda x: torch.diff(x.reshape(-1)),
    "trapz": lambda y, *, dx=1.0, axis=-1: torch.trapezoid(y, dx=dx, dim=axis),
    "gradient_1d": lambda x: torch.gradient(x)[0],
    "interp": _interp,
    "unwrap": _unwrap,
    "polyval": _polyval,
    "polyder": _polyder,
    "polyint": _polyint,
    "convolve_1d": _convolve,
    "correlate_1d": _correlate,
    "partition": _partition,
    "argpartition": _argpartition,
    "lexsort": _lexsort,
    "repeat": _repeat,
    "take": lambda x, idx, *, axis=None: _gather(x, idx, axis=axis),
    "compress": _compress,
    "fill_diagonal": _fill_diagonal,
    "digitize": lambda x, bins: torch.searchsorted(bins.contiguous(), x.contiguous(),
                                                   right=True),
    "float_power": lambda a, b: torch.pow(_fl(a), _fl(b)),
    "fix": torch.trunc,
    "positive": lambda x: x,
    "cbrt": _cbrt,
    "fabs": torch.abs,
    # linalg tail 2
    "norm_fro": lambda x: torch.linalg.matrix_norm(x, ord="fro"),
    "inner": torch.inner,
    "vdot": _vdot,
    "multi_dot": _multi_dot,
    "cholesky_inverse": _cholesky_inverse,
    "diag_embed": lambda x: x[..., None] * torch.eye(x.shape[-1], dtype=x.dtype,
                                                     device=x.device),
    "block_diag": lambda *ms: torch.block_diag(*ms),
    "toeplitz": _toeplitz,
    "adjoint": lambda x: torch.conj(x.transpose(-1, -2)).resolve_conj()
    if x.is_complex() else x.transpose(-1, -2),
    # signal tail 2 (the simple ones)
    "power_to_db": lambda s, *, ref=1.0, amin=1e-10: 10.0 * (
        torch.log10(torch.clamp_min(s, amin)) - math.log10(max(ref, amin))),
    "db_to_power": lambda db, *, ref=1.0: ref * torch.pow(10.0, db / 10.0),
    "rms": lambda x, *, axis=None: torch.sqrt(_mean(torch.square(x.to(_F32)), axis)),
    "zero_crossings": lambda x: torch.sum(torch.diff((x >= 0).to(torch.int32), dim=-1).abs(),
                                          dim=-1),
    "autocorr": lambda x, *, lag=1: _pearson(x[..., :-lag].reshape(-1),
                                             x[..., lag:].reshape(-1)),
    "detrend": _detrend,
    "medfilt": _medfilt,
    # statistics / metrics tail
    "covariance": lambda a, b: torch.mean((a.to(_F32) - torch.mean(_fl(a)))
                                          * (b.to(_F32) - torch.mean(_fl(b)))),
    "pearson_corr": _pearson,
    "spearman_corr": _spearman,
    "skewness": lambda x: (lambda c, s: torch.mean(c ** 3) / torch.clamp_min(s ** 3, 1e-12))(
        x.to(_F32) - torch.mean(_fl(x)), _std(x)),
    "kurtosis": lambda x: (lambda c, s: torch.mean(c ** 4) / torch.clamp_min(s ** 4, 1e-12)
                           - 3.0)(x.to(_F32) - torch.mean(_fl(x)), _std(x)),
    "quantile": _quantile,
    "iqr": lambda x: _quantile(x, q=0.75) - _quantile(x, q=0.25),
    "mad": lambda x: _median((x - _median(x)).abs()),
    "zscore": lambda x, *, axis=None, epsilon=1e-12: (
        (x - _mean(x, axis, True)) / (_std(x, axis, True) + epsilon)),
    "weighted_mean": lambda x, w: torch.sum(x * w) / torch.clamp_min(torch.sum(w), 1e-12),
    "ema": _ema,
    "sma": lambda x, *, window: _convolve(x, torch.ones(window, device=x.device) / window,
                                          mode="valid"),
    "f1_score": _f1,
    "matthews_corrcoef": _mcc,
    "cohen_kappa": _cohen_kappa,
    "r2_score": lambda pred, lab: 1.0 - torch.sum(torch.square(lab - pred))
    / torch.clamp_min(torch.sum(torch.square(lab - torch.mean(lab))), 1e-12),
    "explained_variance": lambda pred, lab: 1.0 - _var(lab - pred)
    / torch.clamp_min(_var(lab), 1e-12),
    "rmse": lambda pred, lab: torch.sqrt(torch.mean(torch.square(pred - lab))),
    # legacy *_bp grad ops
    "sigmoid_bp": lambda x, g: g * torch.sigmoid(x) * (1.0 - torch.sigmoid(x)),
    "tanh_bp": lambda x, g: g * (1.0 - torch.square(torch.tanh(x))),
    "relu_bp": lambda x, g: g * (x > 0).to(g.dtype),
    "softmax_bp": lambda x, g, *, axis=-1: (lambda s: s * (
        g - torch.sum(g * s, dim=axis, keepdim=True)))(torch.softmax(x, dim=axis)),
    "ensure_shape": _ensure_shape,
    "split_part": lambda x, *, index, num, axis=0: torch.chunk(x, num, dim=axis)[index],
    "slice_axis": lambda x, *, begin, size, axis=0: x.narrow(axis, begin, size),
})
OPS["matrix_exp"] = OPS["expm"]
OPS["log_matrix_determinant"] = OPS["logdet"]
OPS.update({
    "ctc_beam_decode": lambda logits, **kw: _ctc_beam_search(logits, **kw)[0],
    "ctc_beam_decode_lengths": lambda logits, **kw: _ctc_beam_search(logits, **kw)[1],
    "ctc_beam_decode_log_probs": lambda logits, **kw: _ctc_beam_search(logits, **kw)[2],
})

_WAIT_REASONS = {
    "image": "an image op whose sampling grid the port has not reproduced",
    "signal": "the signal / FFT namespace",
    "random": "a random op whose bits runtime/rng.py does not reproduce",
    "special": "a special function with no torch counterpart",
}
#: op name -> why it waits (each raises NotImplementedError naming A13)
WAITING = {
    **dict.fromkeys(("resize", "resize_bicubic"), "image"),
    **dict.fromkeys((
        "hann_window", "hamming_window", "blackman_window", "frame", "stft", "istft",
        "fft", "ifft", "rfft", "irfft", "fft2", "ifft2", "real", "imag", "complex_abs",
        "angle", "bartlett_window", "kaiser_window", "fft2d", "ifft2d",
        "mel_filterbank"), "signal"),
    **dict.fromkeys((
        "random_exponential", "random_gamma", "random_poisson", "random_shuffle",
        "random_laplace", "random_cauchy", "random_rademacher", "random_beta",
        "random_crop"), "random"),
    "betainc": "special",
}


def _waiting(name: str):
    def fn(*_a, **_k):
        raise NotImplementedError(
            f"SameDiff op {name!r} is not ported yet ({_WAIT_REASONS[WAITING[name]]}); "
            "it waits in ROADMAP A13")
    return fn


def _narrowing(fn):
    def op(*args, **attrs):
        return _narrow(fn(*args, **attrs))
    op.__wrapped__ = fn
    return op


#: the ported op names
PORTED = frozenset(OPS)
OPS = {name: _narrowing(fn) for name, fn in OPS.items()}
OPS.update({name: _waiting(name) for name in WAITING})


def get_op(name: str):
    if name not in OPS:
        raise KeyError(f"unknown autodiff op {name!r}; known: {sorted(OPS)}")
    return OPS[name]
