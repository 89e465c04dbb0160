"""Convolution and pooling on NHWC maps — what the JAX package's
`Conv2D` and `Subsampling` lower to (``lax.conv_general_dilated`` and
``lax.reduce_window``, `deeplearning4j_tpu/nn/conf/layers.py`).  XLA
emits their code there: no Pallas kernel, so none here either.  The
card runs cuDNN's convolutions and PyTorch's pooling kernels.

Layout.  Maps stay NHWC and kernels HWIO, the JAX tree's layouts, so a
checkpoint's weights and a flatten's order carry across unchanged.  A
(B, H, W, C) tensor is handed to PyTorch as its (B, C, H, W) view: the
strides of channels-last memory, which cuDNN reads as NHWC without a
copy; the result's view back is NHWC again.

Padding.  ``"same"`` is XLA's: ``out = ceil(in / stride)``, the total
padding ``max((out - 1) * stride + dilated kernel - in, 0)``, ``total //
2`` before and the rest after.  That is asymmetric for an even kernel or
a stride above 1, which PyTorch's own padding argument cannot say, so
such maps are padded explicitly first: with -inf for max pooling (as
``reduce_window`` pads with its init value), with zeros otherwise.  SAME
average pooling divides each window by its count of real elements.

Exact f32 and fixed bits on the card.  PyTorch lets cuDNN run f32
convolutions in TF32 and pick nondeterministic backward algorithms by
default.  `Conv2dNHWC` runs its forward and its backward each under a
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


def _pads(x_nhwc, kernel, stride, dilation, padding: str):
    """((top, bottom), (left, right)) of an NHWC map for ``padding``."""
    if padding == "same":
        (kh, kw), (sh, sw), (dh, dw) = kernel, stride, dilation
        return (same_pads(x_nhwc.shape[1], kh, sh, dh),
                same_pads(x_nhwc.shape[2], kw, sw, dw))
    if padding != "valid":
        raise ValueError(f"padding must be 'same' or 'valid', got {padding!r}")
    return (0, 0), (0, 0)


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


class Conv2dNHWC(torch.autograd.Function):
    """``F.conv2d`` on NCHW views (channels-last memory) with its forward
    and backward each under `_exact`."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, groups):
        with _exact(x.device):
            y = F.conv2d(x, w, None, stride, padding, dilation, groups)
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding, dilation, groups)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, groups = ctx.conf
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False]
        with _exact(x.device):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, list(stride), list(padding), list(dilation),
                False, [0, 0], groups, mask)
        return gx, gw, None, None, None, None


def conv2d_nhwc(x: torch.Tensor, w_hwio: torch.Tensor, *, stride=(1, 1),
                padding: str = "valid", dilation=(1, 1),
                groups: int = 1) -> torch.Tensor:
    """``lax.conv_general_dilated(x, w, stride, padding, rhs_dilation,
    ("NHWC", "HWIO", "NHWC"), feature_group_count=groups)``: (B, H, W,
    C) maps and an (kh, kw, C / groups, n_out) kernel -> (B, H', W',
    n_out) maps in x's dtype."""
    kernel, stride, dilation = pair(w_hwio.shape[:2]), pair(stride), pair(dilation)
    (pt, pb), (pl, pr) = _pads(x, kernel, stride, dilation, padding)
    xc = x.permute(0, 3, 1, 2)                    # NCHW view, NHWC memory
    if (pt, pl) != (pb, pr):
        xc = F.pad(xc, (pl, pr, pt, pb))
        sym = (0, 0)
    else:
        sym = (pt, pl)
    xc = xc.contiguous(memory_format=torch.channels_last)
    w = w_hwio.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    y = Conv2dNHWC.apply(xc, w, stride, sym, dilation, groups)
    return y.permute(0, 2, 3, 1)


def _sum_pool(xc, kernel, stride):
    return F.avg_pool2d(xc, kernel, stride, divisor_override=1)


def pool2d_nhwc(x: torch.Tensor, pooling: str, *, kernel=(2, 2),
                stride=(2, 2), padding: str = "valid",
                pnorm: int = 2) -> torch.Tensor:
    """``lax.reduce_window`` pooling of (B, H, W, C) maps: ``"max"``,
    ``"sum"``, ``"avg"`` (SAME windows divided by their real elements)
    or ``"pnorm"`` ((sum |x|^p)^(1/p))."""
    kernel, stride = pair(kernel), pair(stride)
    (pt, pb), (pl, pr) = _pads(x, kernel, stride, (1, 1), padding)
    padded = (pt, pb, pl, pr) != (0, 0, 0, 0)
    xc = x.permute(0, 3, 1, 2)

    def pad(t, value=0.0):
        return F.pad(t, (pl, pr, pt, pb), value=value) if padded else t

    if pooling == "max":
        y = F.max_pool2d(pad(xc, float("-inf")), kernel, stride)
    elif pooling == "sum":
        y = _sum_pool(pad(xc), kernel, stride)
    elif pooling == "avg":
        s = _sum_pool(pad(xc), kernel, stride)
        if padding == "same":
            ones = torch.ones((1, 1) + tuple(xc.shape[2:]), dtype=x.dtype,
                              device=x.device)
            y = s / _sum_pool(pad(ones), kernel, stride)
        else:
            y = s / (kernel[0] * kernel[1])
    elif pooling == "pnorm":
        p = float(pnorm)
        y = _sum_pool(pad(xc.abs() ** p), kernel, stride) ** (1.0 / p)
    else:
        raise ValueError(f"unhandled pooling {pooling!r}")
    return y.permute(0, 2, 3, 1)
