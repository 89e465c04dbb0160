"""1-D and 3-D convolution-family layers, croppings, PReLU, upsampling
and the zero mask — `deeplearning4j_tpu/nn/conf/layers_nd.py`.

The same config contract as `layers.py` (serde tags, fields and
defaults of the JAX package; ``output_type``, ``init``, ``apply``).
Sequence (1-D) layers take the recurrent input kind, (B, T, C); volumes
are (B, D, H, W, C): channels stay last at every rank, as in the JAX
package, and kernels are WIO and DHWIO.  Convolutions and pooling go
through `ops/conv.py` (cuDNN inside its exact-flags window on the card,
XLA's SAME padding), and a convolution's kernel through
`quantf.conv_weight`, so an int8 kernel is dequantized first.
"""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LayerConfig,
    PoolingType,
    split_region,
)
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.ops import conv as conv_ops
from deeplearning4j_tpu_torch.quant import functional as quantf
from deeplearning4j_tpu_torch.utils import serde


def _triple(v) -> tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    t = tuple(int(x) for x in v)
    if len(t) != 3:
        raise ValueError(f"need an int or 3-tuple, got {v}")
    return t


def _out_len(size: int, k: int, s: int, padding: str, d: int = 1) -> int:
    eff = (k - 1) * d + 1
    if padding == "same":
        return -(-size // s)
    return -(-(size - eff + 1) // s)


def _conv_params(layer, key, kernel: tuple, c_in: int, device) -> dict:
    vol = 1
    for k in kernel:
        vol *= k
    w = layer._winit(WeightInit.RELU).init(
        key, kernel + (c_in, layer.n_out), fan_in=vol * c_in,
        fan_out=vol * layer.n_out, device=device)
    params = {"W": w}
    if layer.has_bias:
        params["b"] = torch.zeros(layer.n_out, device=device)
    return params


def _conv_apply(layer, params, x, **kw):
    def fn(x):
        y = conv_ops.conv_channels_last(x, quantf.conv_weight(params["W"], x.dtype),
                                        padding=layer.padding, **kw)
        if layer.has_bias:
            y = y + params["b"].to(x.dtype)
        return y

    # under the model axis: the rank's output channels, gathered
    return layer._act()(split_region(layer, params, x, fn))


@serde.register
@dataclasses.dataclass(frozen=True)
class Conv1D(LayerConfig):
    """Temporal convolution over (B, T, C) — `Convolution1DLayer`."""

    n_out: int = 0
    kernel: int = 3
    stride: int = 1
    padding: str = "same"
    dilation: int = 1
    has_bias: bool = True

    EXPECTS = "rnn"

    def output_type(self, itype):
        t = itype.shape[0]
        t_out = (-1 if t < 0
                 else _out_len(t, self.kernel, self.stride, self.padding, self.dilation))
        return InputType.recurrent(self.n_out, t_out)

    def init(self, key, itype, device):
        return _conv_params(self, key, (self.kernel,), itype.size, device), {}

    def apply(self, params, state, x, *, training=False, rng=None):
        return _conv_apply(self, params, x, stride=self.stride,
                           dilation=self.dilation), state


@serde.register
@dataclasses.dataclass(frozen=True)
class Conv3D(LayerConfig):
    """Volumetric convolution over (B, D, H, W, C) — `Convolution3D`."""

    n_out: int = 0
    kernel: tuple[int, int, int] = (3, 3, 3)
    stride: tuple[int, int, int] = (1, 1, 1)
    padding: str = "same"
    has_bias: bool = True

    EXPECTS = "cnn3d"

    def output_type(self, itype):
        d, h, w, _ = itype.shape
        kd, kh, kw = _triple(self.kernel)
        sd, sh, sw = _triple(self.stride)
        return InputType.convolutional3d(
            _out_len(d, kd, sd, self.padding), _out_len(h, kh, sh, self.padding),
            _out_len(w, kw, sw, self.padding), self.n_out)

    def init(self, key, itype, device):
        return _conv_params(self, key, _triple(self.kernel), itype.channels,
                            device), {}

    def apply(self, params, state, x, *, training=False, rng=None):
        return _conv_apply(self, params, x, stride=_triple(self.stride)), state


@serde.register
@dataclasses.dataclass(frozen=True)
class Subsampling1D(LayerConfig):
    """Temporal pooling over (B, T, C) — `Subsampling1DLayer`."""

    kernel: int = 2
    stride: int = 2
    padding: str = "valid"
    pooling: PoolingType = PoolingType.MAX
    pnorm: float = 2.0

    EXPECTS = "rnn"
    HAS_PARAMS = False

    def output_type(self, itype):
        t = itype.shape[0]
        t_out = -1 if t < 0 else _out_len(t, self.kernel, self.stride, self.padding)
        return InputType.recurrent(itype.size, t_out)

    def apply(self, params, state, x, *, training=False, rng=None):
        return conv_ops.pool_channels_last(
            x, self.pooling.value, kernel=self.kernel, stride=self.stride,
            padding=self.padding, pnorm=self.pnorm), state


@serde.register
@dataclasses.dataclass(frozen=True)
class Subsampling3D(LayerConfig):
    """Volumetric pooling over (B, D, H, W, C) — `Subsampling3DLayer`."""

    kernel: tuple[int, int, int] = (2, 2, 2)
    stride: tuple[int, int, int] = (2, 2, 2)
    padding: str = "valid"
    pooling: PoolingType = PoolingType.MAX
    pnorm: float = 2.0

    EXPECTS = "cnn3d"
    HAS_PARAMS = False

    def output_type(self, itype):
        d, h, w, c = itype.shape
        kd, kh, kw = _triple(self.kernel)
        sd, sh, sw = _triple(self.stride)
        return InputType.convolutional3d(
            _out_len(d, kd, sd, self.padding), _out_len(h, kh, sh, self.padding),
            _out_len(w, kw, sw, self.padding), c)

    def apply(self, params, state, x, *, training=False, rng=None):
        return conv_ops.pool_channels_last(
            x, self.pooling.value, kernel=_triple(self.kernel),
            stride=_triple(self.stride), padding=self.padding,
            pnorm=self.pnorm), state


def _crop2(v) -> tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    t = tuple(int(x) for x in v)
    return (t[0], t[1]) if len(t) == 2 else (t[0], t[0])


@serde.register
@dataclasses.dataclass(frozen=True)
class Cropping1D(LayerConfig):
    """Trim (begin, end) timesteps — `Cropping1D`."""

    cropping: tuple[int, int] = (0, 0)

    EXPECTS = "rnn"
    HAS_PARAMS = False

    def output_type(self, itype):
        t = itype.shape[0]
        a, b = _crop2(self.cropping)
        return InputType.recurrent(itype.size, t if t < 0 else t - a - b)

    def apply(self, params, state, x, *, training=False, rng=None):
        a, b = _crop2(self.cropping)
        return x[:, a: x.shape[1] - b, :], state


@serde.register
@dataclasses.dataclass(frozen=True)
class Cropping2D(LayerConfig):
    """Trim ((top, bottom), (left, right)) pixels — `Cropping2D`."""

    cropping: tuple = ((0, 0), (0, 0))

    EXPECTS = "cnn"
    HAS_PARAMS = False

    def _hw(self):
        c = self.cropping
        if isinstance(c, int):
            return (c, c), (c, c)
        c = tuple(c)
        if isinstance(c[0], int):
            return (c[0], c[0]), (c[1], c[1])
        return _crop2(c[0]), _crop2(c[1])

    def output_type(self, itype):
        h, w, ch = itype.shape
        (t, b), (l, r) = self._hw()
        return InputType.convolutional(h - t - b, w - l - r, ch)

    def apply(self, params, state, x, *, training=False, rng=None):
        (t, b), (l, r) = self._hw()
        return x[:, t: x.shape[1] - b, l: x.shape[2] - r, :], state


@serde.register
@dataclasses.dataclass(frozen=True)
class Cropping3D(LayerConfig):
    """Trim ((d0, d1), (h0, h1), (w0, w1)) voxels — `Cropping3D`."""

    cropping: tuple = ((0, 0), (0, 0), (0, 0))

    EXPECTS = "cnn3d"
    HAS_PARAMS = False

    def _dhw(self):
        c = self.cropping
        if isinstance(c, int):
            return ((c, c),) * 3
        c = tuple(c)
        if isinstance(c[0], int):
            return tuple((v, v) for v in _triple(c))
        return tuple(_crop2(v) for v in c)

    def output_type(self, itype):
        d, h, w, ch = itype.shape
        (d0, d1), (h0, h1), (w0, w1) = self._dhw()
        return InputType.convolutional3d(d - d0 - d1, h - h0 - h1, w - w0 - w1, ch)

    def apply(self, params, state, x, *, training=False, rng=None):
        (d0, d1), (h0, h1), (w0, w1) = self._dhw()
        return x[:, d0: x.shape[1] - d1, h0: x.shape[2] - h1,
                 w0: x.shape[3] - w1, :], state


@serde.register
@dataclasses.dataclass(frozen=True)
class PReLU(LayerConfig):
    """Parametric ReLU with a learned slope a channel — `PReLULayer`.  The
    slopes take no weight decay (it would pull them to a dead ReLU)."""

    alpha_init: float = 0.25

    REGULARIZED = ()

    def _n_channels(self, itype) -> int:
        if itype.kind in (InputType.KIND_CNN, InputType.KIND_CNN3D):
            return itype.channels
        return itype.size

    def init(self, key, itype, device):
        return {"alpha": torch.full((self._n_channels(itype),), self.alpha_init,
                                    dtype=torch.float32, device=device)}, {}

    def apply(self, params, state, x, *, training=False, rng=None):
        a = params["alpha"].to(x.dtype)
        return torch.where(x >= 0, x, a * x), state


@serde.register
@dataclasses.dataclass(frozen=True)
class Upsampling1D(LayerConfig):
    """Nearest-neighbour upsampling of the time axis: (B, T, C) -> (B,
    T * size, C)."""

    size: int = 2
    EXPECTS = "rnn"
    HAS_PARAMS = False
    REGULARIZED = ()

    def output_type(self, itype):
        t = itype.shape[0]
        return InputType.recurrent(itype.size, t if t < 0 else t * self.size)

    def apply(self, params, state, x, *, training=False, rng=None):
        return torch.repeat_interleave(x, self.size, dim=1), state


@serde.register
@dataclasses.dataclass(frozen=True)
class Upsampling3D(LayerConfig):
    """Nearest-neighbour volumetric upsampling: each spatial dim of (B, D,
    H, W, C) repeated by its factor."""

    size: tuple = (2, 2, 2)
    EXPECTS = "cnn3d"
    HAS_PARAMS = False
    REGULARIZED = ()

    def __post_init__(self):
        super().__post_init__()
        s = self.size
        if isinstance(s, int):
            s = (s, s, s)
        object.__setattr__(self, "size", tuple(int(v) for v in s))

    def output_type(self, itype):
        d, h, w, c = itype.shape
        sd, sh, sw = self.size
        return InputType.convolutional3d(d * sd, h * sh, w * sw, c)

    def apply(self, params, state, x, *, training=False, rng=None):
        for axis, s in zip((1, 2, 3), self.size):
            x = torch.repeat_interleave(x, s, dim=axis)
        return x, state


@serde.register
@dataclasses.dataclass(frozen=True)
class MaskZeroLayer(LayerConfig):
    """Padded timesteps (mask 0) set to ``mask_value`` — `MaskZeroLayer`,
    its own stack element after the layer it would wrap."""

    mask_value: float = 0.0
    EXPECTS = "rnn"
    HAS_PARAMS = False
    ACCEPTS_MASK = True
    REGULARIZED = ()

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        if mask is None:
            return x, state
        keep = mask.to(x.dtype)[:, :, None]
        return x * keep + (1.0 - keep) * self.mask_value, state
