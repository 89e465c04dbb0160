"""Convolution and pooling on channels-last maps — what the JAX
package's `Conv2D` and `Subsampling` (and the 1-D and 3-D layers of
`layers_nd.py`) lower to (``lax.conv_general_dilated`` and
``lax.reduce_window``, `deeplearning4j_tpu/nn/conf/layers.py`).  XLA
emits their code there: no Pallas kernel, so none here either.  The
card runs cuDNN's convolutions and PyTorch's pooling kernels.

Layout.  Maps stay channels-last (NWC, NHWC, NDHWC) and kernels WIO,
HWIO, DHWIO, the JAX tree's layouts, so a checkpoint's weights and a
flatten's order carry across unchanged.  A (B, H, W, C) tensor is handed
to PyTorch as its (B, C, H, W) view: the strides of channels-last
memory, which cuDNN reads as NHWC without a copy (3-D maps likewise as
``channels_last_3d``; a 1-D map is made contiguous); the result's view
back is channels-last again.

Padding.  ``"same"`` is XLA's: ``out = ceil(in / stride)``, the total
padding ``max((out - 1) * stride + dilated kernel - in, 0)``, ``total //
2`` before and the rest after.  That is asymmetric for an even kernel or
a stride above 1, which PyTorch's own padding argument cannot say, so
such maps are padded explicitly first: with -inf for max pooling (as
``reduce_window`` pads with its init value), with zeros otherwise.  SAME
average pooling divides each window by its count of real elements.

Exact f32 and fixed bits on the card.  PyTorch lets cuDNN run f32
convolutions in TF32 and pick nondeterministic backward algorithms by
default.  `ConvChannelsLast` runs its forward and its backward each under a
local ``torch.backends.cudnn.flags`` (TF32 off, deterministic
algorithms, no benchmarking), so the f32 model stays the JAX package's
f32 arithmetic and a captured training step gives the eager step's
bits, whatever the caller's global settings.  Those flags are the
process's, not a thread's, and the backward runs on autograd's thread
while a server may run forwards on others: each window holds a module
lock, so two of this module's windows never interleave their saves and
restores, and each restores the flags it found.  A thread that sets
the flags itself, or runs a convolution of its own, while a window is
open is not covered: it sees the window's flags meanwhile.

Transposed convolution.  ``lax.conv_transpose`` (``transpose_kernel``
False, the JAX package's `Deconv2D`) correlates the stride-dilated map,
padded by its own (before, after) pads, with the HWIO kernel as it is.
That is PyTorch's transposed convolution with the kernel flipped in both
spatial axes, laid out (I, O, kh, kw), and then a window of the full
``(h - 1) s + k`` result: it starts ``k - 1 - before`` in, and where the
JAX output runs past the full result's end (a kernel smaller than its
stride) the rows past it carry nothing but the bias, which
``output_padding`` adds.

Ties.  The gradient of a max window goes to its first largest element
in row-major window order: XLA's ``select_and_scatter`` with ``ge``
keeps the earlier element on a tie, and PyTorch's max pooling keeps the
first index whose value is strictly larger, so both send it to the same
place.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F


def pair(v) -> tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def same_pads(size: int, k: int, s: int, d: int = 1) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (before, after)."""
    ek = (k - 1) * d + 1
    out = -(-size // s)
    total = max((out - 1) * s + ek - size, 0)
    return total // 2, total - total // 2


def _pads(x, kernel, stride, dilation, padding: str):
    """(before, after) of each spatial dim of a channels-last map ``x``
    (B, *spatial, C) for ``padding``."""
    nd = x.dim() - 2
    if padding == "same":
        return [same_pads(x.shape[1 + i], kernel[i], stride[i], dilation[i])
                for i in range(nd)]
    if padding != "valid":
        raise ValueError(f"padding must be 'same' or 'valid', got {padding!r}")
    return [(0, 0)] * nd


def _flat_pads(pads) -> tuple:
    """`F.pad`'s argument for per-dim (before, after) pads: the last
    spatial dim first."""
    return tuple(v for before, after in reversed(pads) for v in (before, after))


_FLAGS_LOCK = threading.Lock()


@contextlib.contextmanager
def _exact(device):
    """f32 convolutions in f32 and deterministic algorithms on the card,
    one window at a time across threads (module docstring)."""
    if device.type != "cuda":
        yield
        return
    with _FLAGS_LOCK, torch.backends.cudnn.flags(
            enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        yield


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_LAST = {2: torch.channels_last, 3: torch.channels_last_3d}


class ConvChannelsLast(torch.autograd.Function):
    """``F.conv{1,2,3}d`` (or, with ``output_padding``, the transposed
    convolution) on channels-first views of channels-last memory, with
    its forward and backward each under `_exact`."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups, output_padding=None):
        with _exact(x.device):
            if output_padding is None:
                y = _CONV[x.dim() - 2](x, w, None, stride, padding, dilation, groups)
            else:
                y = torch.ops.aten.convolution(x, w, None, list(stride), list(padding),
                                               list(dilation), True,
                                               list(output_padding), groups)
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups, output_padding)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups, output_padding = ctx.conf
        transposed = output_padding is not None
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _exact(x.device):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, list(stride), list(padding), list(dilation),
                transposed, list(output_padding) if transposed else [0] * len(stride),
                groups, mask)
        return gx, gw, None, None, None, None, None


def _tuple(v, n: int) -> tuple:
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def conv_channels_last(x: torch.Tensor, w: torch.Tensor, *, stride=1,
                       padding: str = "valid", dilation=1,
                       groups: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated`` of channels-last maps: x (B, *spatial,
    C), w (*kernel, C / groups, n_out) (WIO, HWIO or DHWIO) -> (B,
    *spatial', n_out) in x's dtype, for 1, 2 or 3 spatial dims."""
    nd = x.dim() - 2
    kernel = tuple(w.shape[:nd])
    stride, dilation = _tuple(stride, nd), _tuple(dilation, nd)
    pads = _pads(x, kernel, stride, dilation, padding)
    xc = x.movedim(-1, 1)                         # channels-first view
    if any(before != after for before, after in pads):
        xc = F.pad(xc, _flat_pads(pads))
        sym = (0,) * nd
    else:
        sym = tuple(before for before, _ in pads)
    fmt = _LAST.get(nd)
    wc = w.permute(nd + 1, nd, *range(nd))
    if fmt is None:                               # 1-D: plain contiguous
        xc, wc = xc.contiguous(), wc.contiguous()
    else:
        xc, wc = xc.contiguous(memory_format=fmt), wc.contiguous(memory_format=fmt)
    y = ConvChannelsLast.apply(xc, wc, stride, sym, dilation, groups)
    return y.movedim(1, -1)


def conv2d_nhwc(x: torch.Tensor, w_hwio: torch.Tensor, *, stride=(1, 1),
                padding: str = "valid", dilation=(1, 1),
                groups: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated(x, w, stride, padding, rhs_dilation,
    ("NHWC", "HWIO", "NHWC"), feature_group_count=groups)``: (B, H, W,
    C) maps and an (kh, kw, C / groups, n_out) kernel -> (B, H', W',
    n_out) maps in x's dtype."""
    return conv_channels_last(x, w_hwio, stride=pair(stride), padding=padding,
                              dilation=pair(dilation), groups=groups)


def transpose_pads(k: int, s: int, padding: str) -> tuple[int, int]:
    """``lax.conv_transpose``'s (before, after) padding of the dilated
    input in one spatial dim (``_conv_transpose_padding``)."""
    if padding == "same":
        total = k + s - 2
        before = k - 1 if s > k - 1 else -(-total // 2)
    elif padding == "valid":
        total = k + s - 2 + max(k - s, 0)
        before = k - 1
    else:
        raise ValueError(f"padding must be 'same' or 'valid', got {padding!r}")
    return before, total - before


def conv_transpose2d_nhwc(x: torch.Tensor, w_hwio: torch.Tensor, *, stride=(2, 2),
                          padding: str = "valid") -> torch.Tensor:
    """``lax.conv_transpose(x, w, stride, padding, ("NHWC", "HWIO",
    "NHWC"))``: (B, H, W, C) maps and a (kh, kw, C, n_out) kernel ->
    (B, H', W', n_out) in x's dtype (the module docstring's mapping)."""
    kernel, stride = tuple(w_hwio.shape[:2]), pair(stride)
    crops, extra = [], []
    for i, (k, s) in enumerate(zip(kernel, stride)):
        before, after = transpose_pads(k, s, padding)
        n = x.shape[1 + i]
        out = (n - 1) * s + 1 + before + after - k + 1     # JAX's length
        start = k - 1 - before
        extra.append(max(start + out - ((n - 1) * s + k), 0))
        crops.append((start, out))
    if any(e >= s for e, s in zip(extra, stride)):
        raise ValueError(f"transposed convolution at kernel {kernel}, stride {stride}: "
                         "no output padding reaches JAX's output")
    xc = x.movedim(-1, 1).contiguous(memory_format=torch.channels_last)
    wc = w_hwio.flip(0, 1).permute(2, 3, 0, 1).contiguous(
        memory_format=torch.channels_last)
    y = ConvChannelsLast.apply(xc, wc, stride, (0, 0), (1, 1), 1, tuple(extra))
    (sh, lh), (sw, lw) = crops
    return y[:, :, sh:sh + lh, sw:sw + lw].movedim(1, -1)


_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def pool_channels_last(x: torch.Tensor, pooling: str, *, kernel, stride,
                       padding: str = "valid", pnorm: float = 2) -> torch.Tensor:
    """``lax.reduce_window`` pooling of channels-last maps (B, *spatial,
    C), 1, 2 or 3 spatial dims: ``"max"``, ``"sum"``, ``"avg"`` (SAME
    windows divided by their real elements) or ``"pnorm"`` ((sum
    |x|^p)^(1/p)).  A 1-D map pools as a 2-D map of height 1."""
    nd = x.dim() - 2
    if nd == 1:
        y = pool_channels_last(x[:, None], pooling, kernel=(1,) + _tuple(kernel, 1),
                               stride=(1,) + _tuple(stride, 1), padding=padding,
                               pnorm=pnorm)
        return y[:, 0]
    kernel, stride = _tuple(kernel, nd), _tuple(stride, nd)
    pads = _pads(x, kernel, stride, (1,) * nd, padding)
    padded = any(p != (0, 0) for p in pads)
    xc = x.movedim(-1, 1)

    def pad(t, value=0.0):
        return F.pad(t, _flat_pads(pads), value=value) if padded else t

    def sum_pool(t):
        return _AVG_POOL[nd](t, kernel, stride, divisor_override=1)

    if pooling == "max":
        y = _MAX_POOL[nd](pad(xc, float("-inf")), kernel, stride)
    elif pooling == "sum":
        y = sum_pool(pad(xc))
    elif pooling == "avg":
        s = sum_pool(pad(xc))
        if padding == "same":
            ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=x.dtype,
                              device=x.device)
            y = s / sum_pool(pad(ones))
        else:
            n = 1
            for k in kernel:
                n *= k
            y = s / n
    elif pooling == "pnorm":
        p = float(pnorm)
        y = sum_pool(pad(xc.abs() ** p)) ** (1.0 / p)
    else:
        raise ValueError(f"unhandled pooling {pooling!r}")
    return y.movedim(1, -1)


def pool2d_nhwc(x: torch.Tensor, pooling: str, *, kernel=(2, 2),
                stride=(2, 2), padding: str = "valid",
                pnorm: int = 2) -> torch.Tensor:
    """`pool_channels_last` of (B, H, W, C) maps (the `Subsampling`
    layer)."""
    return pool_channels_last(x, pooling, kernel=pair(kernel), stride=pair(stride),
                              padding=padding, pnorm=pnorm)
