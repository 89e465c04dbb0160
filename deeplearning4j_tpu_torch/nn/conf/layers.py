"""Layer configs — `deeplearning4j_tpu/nn/conf/layers.py`: the
`LayerConfig` base and the layers the ported stacks use.

A config is a frozen dataclass registered for serde under the JAX
package's tag, with its fields, defaults and enum values.  Each owns the
JAX package's three functions:

- ``output_type(itype)``: shape inference down the stack;
- ``init(key, itype, device) -> (params, state)``: draws from a threefry
  key (`nn/weights.py`) as the JAX layer does, so a seed gives the JAX
  package's weights; ``state`` holds what is not trained (BatchNorm's
  running mean and variance);
- ``apply(params, state, x, *, training, rng) -> (y, new_state)``: a
  plain function of the parameter and state dicts and a tensor; in
  training it takes the layer's step key for dropout.  A layer with
  ``ACCEPTS_MASK`` also takes ``mask=``, the model's (B, T) features
  mask, until the time axis collapses.

``EXPECTS`` says which input kind a layer takes ("ff" layers after a
convolutional one get the implicit flatten), ``HAS_PARAMS`` whether it
has parameters.  Layouts are the JAX tree's: dense weights (n_in, n_out)
applied as ``x @ W``, conv kernels HWIO over NHWC maps (`ops/conv.py`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.ops import conv as conv_ops
from deeplearning4j_tpu_torch.parallel import context as dp_context
from deeplearning4j_tpu_torch.quant import functional as quantf
from deeplearning4j_tpu_torch.runtime import rng as rng_mod
from deeplearning4j_tpu_torch.runtime.mesh import leaf_axis
from deeplearning4j_tpu_torch.utils import serde


class PoolingType(str, enum.Enum):
    MAX = "max"
    AVG = "avg"
    SUM = "sum"
    PNORM = "pnorm"


def _coerce_enum(v, enum_cls):
    """An enum member from a member, its value ("relu"), its NAME
    ("RELU") or an alias of the enum's ``_ALIASES_`` table."""
    if isinstance(v, enum_cls):
        return v
    s = str(v).lower()
    s = getattr(enum_cls, "_ALIASES_", {}).get(s, s)
    try:
        return enum_cls(s)
    except ValueError:
        pass
    try:
        return enum_cls[str(v).upper()]
    except KeyError:
        raise ValueError(f"{v!r} is not a valid {enum_cls.__name__}; "
                         f"options: {[e.value for e in enum_cls]}") from None


def _dropout(x: torch.Tensor, rate: float, training: bool, key) -> torch.Tensor:
    """Inverted dropout on a layer's input, the JAX package's mask: kept
    where ``bernoulli(key, 1 - rate)``, scaled by a division by the keep
    probability (taken in x's dtype, as jax takes a Python scalar).  The
    key is two 32-bit words, Python ints or device tensors (a captured
    training step's key is a device input).  Under data parallelism a
    rank draws its rows of the global mask (`parallel/context.py`)."""
    if not training or rate <= 0.0 or key is None:
        return x
    keep = 1.0 - rate
    mask = rng_mod.bernoulli(key, keep, tuple(x.shape), device=x.device,
                             offset=dp_context.dropout_offset(x))
    # torch.full, not torch.tensor: no host-to-device copy inside a step
    return torch.where(mask, x / torch.full((), keep, dtype=x.dtype, device=x.device),
                       0.0).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class LayerConfig:
    """Base layer config.  ``name`` is filled as ``layer{i}`` by the
    builder; parameter trees key on it."""

    name: Optional[str] = None
    activation: Optional[Activation] = None
    weight_init: Optional[WeightInit] = None
    l1: Optional[float] = None
    l2: Optional[float] = None
    dropout_rate: Optional[float] = None   # probability of dropping
    # excluded from updates (no gradient, no optimizer state); the
    # forward still runs in training mode
    frozen: bool = False

    # the input kind apply() takes; an "ff" layer after a convolutional
    # one gets the implicit flatten
    EXPECTS = "any"
    HAS_PARAMS = True
    # which parameters the l1 / l2 penalty applies to
    REGULARIZED = ("W",)
    # apply() takes the (B, T) features mask as ``mask=``
    ACCEPTS_MASK = False
    # the layer computes in f32 from f32 weights whatever the compute
    # dtype (the model leaves its tree out of the bf16 cast)
    F32_PARAMS = False
    # each time step's output depends on that step alone (or the layer
    # runs sequence-parallel itself): under a seq axis it runs on the
    # rank's time block, every other layer on the gathered sequence
    SEQ_LOCAL = False

    def __post_init__(self):
        # strings are accepted wherever the enum is, and padding is
        # case-insensitive ("SAME" must not diverge from "same")
        if self.activation is not None:
            object.__setattr__(self, "activation",
                               _coerce_enum(self.activation, Activation))
        if self.weight_init is not None:
            object.__setattr__(self, "weight_init",
                               _coerce_enum(self.weight_init, WeightInit))
        pad = getattr(self, "padding", None)
        if isinstance(pad, str):
            object.__setattr__(self, "padding", pad.lower())
        loss = getattr(self, "loss", None)
        if loss is not None:
            object.__setattr__(self, "loss", _coerce_enum(loss, Loss))
        pooling = getattr(self, "pooling", None)
        if pooling is not None:
            object.__setattr__(self, "pooling", _coerce_enum(pooling, PoolingType))

    def check_supported(self) -> None:
        """Raise `NotImplementedError`, naming the ROADMAP item, for a
        field value this port cannot honour yet (called when a model is
        built, never when a configuration loads)."""

    def output_type(self, itype: InputType) -> InputType:
        return itype

    def init(self, key, itype: InputType, device) -> tuple[dict, dict]:
        return {}, {}

    def apply(self, params: dict, state: dict, x: torch.Tensor, *,
              training: bool = False, rng=None) -> tuple[torch.Tensor, dict]:
        raise NotImplementedError

    def regularizable_params(self, lp: dict) -> list:
        """Arrays the l1 / l2 penalty applies to."""
        return [lp[p] for p in self.REGULARIZED if p in lp]

    def regularization_terms(self, lp: dict) -> list:
        """(l1, l2, array) triples."""
        l1, l2 = self.l1 or 0.0, self.l2 or 0.0
        if not l1 and not l2:
            return []
        return [(l1, l2, w) for w in self.regularizable_params(lp)]

    def _act(self, default=Activation.IDENTITY) -> Activation:
        return self.activation if self.activation is not None else default

    def _winit(self, default=WeightInit.XAVIER) -> WeightInit:
        return self.weight_init if self.weight_init is not None else default


# ---------------------------------------------------------------------------
# Feed-forward layers
# ---------------------------------------------------------------------------

def split_region(layer, params, x, fn, leaf: str = "W"):
    """``fn(x)`` on this rank's output-feature slice of the layer's
    weights (``params[leaf]``), made the whole function under the model
    axis: the input enters by `collectives.copy_to` (its gradient summed
    over the axis) and the output slices are gathered on the last dim
    (NHWC's channels, a dense layer's features)."""
    from deeplearning4j_tpu_torch.parallel import collectives

    if leaf_axis(params[leaf]) != "model":
        return fn(x)
    y = fn(collectives.copy_to(x, "model"))
    return collectives.gather(y, -1, "model")


def _dense(layer, params, x):
    def fn(x):
        # quantf.matmul: ``x @ W`` for f32 weights, B5 (int8 weights,
        # f32 accumulation) after quantize()
        y = quantf.matmul(x, params["W"])
        if layer.has_bias:
            y = y + params["b"].to(x.dtype)
        return y

    return split_region(layer, params, x, fn)


def _dense_init(layer, key, n_in, device):
    p = {"W": layer._winit().init(key, (n_in, layer.n_out), fan_in=n_in,
                                  fan_out=layer.n_out, device=device)}
    if layer.has_bias:
        p["b"] = torch.zeros(layer.n_out, device=device)
    return p


@serde.register
@dataclasses.dataclass(frozen=True)
class Dense(LayerConfig):
    """Fully connected layer (DenseLayer role); n_in is inferred."""

    SEQ_LOCAL = True

    n_out: int = 0
    has_bias: bool = True

    EXPECTS = "ff"

    def output_type(self, itype):
        return InputType.feed_forward(self.n_out)

    def init(self, key, itype, device):
        return _dense_init(self, key, itype.size, device), {}

    def apply(self, params, state, x, *, training=False, rng=None):
        x = _dropout(x, self.dropout_rate or 0.0, training, rng)
        return self._act()(_dense(self, params, x)), state


@serde.register
@dataclasses.dataclass(frozen=True)
class OutputLayer(Dense):
    """Dense + declared loss.  ``apply`` returns PRE-activation logits;
    the model fuses the activation into the loss for training and
    applies it for ``output()``."""

    loss: Loss = Loss.MCXENT

    def apply(self, params, state, x, *, training=False, rng=None):
        x = _dropout(x, self.dropout_rate or 0.0, training, rng)
        return _dense(self, params, x), state


@serde.register
@dataclasses.dataclass(frozen=True)
class LossLayer(LayerConfig):
    """Parameterless output: a loss attached to whatever precedes it."""

    loss: Loss = Loss.MCXENT
    HAS_PARAMS = False
    REGULARIZED = ()

    def apply(self, params, state, x, *, training=False, rng=None):
        return x, state


@serde.register
@dataclasses.dataclass(frozen=True)
class ActivationLayer(LayerConfig):
    HAS_PARAMS = False
    SEQ_LOCAL = True
    REGULARIZED = ()
    # slope / scale of the parameterised activations (Keras' LeakyReLU
    # alpha 0.3 against the enum's 0.01; ELU's scale); None keeps the
    # enum's constant
    alpha: Optional[float] = None

    def apply(self, params, state, x, *, training=False, rng=None):
        if self.alpha is not None:
            a = self.alpha
            if self.activation == Activation.LEAKYRELU:
                return torch.where(x >= 0, x, a * x), state
            if self.activation == Activation.ELU:
                return torch.where(x > 0, x, a * torch.expm1(
                    torch.where(x > 0, 0.0, x))), state
        return self._act()(x), state


def _scalar(v: float, x: torch.Tensor) -> torch.Tensor:
    """``jnp.asarray(v, x.dtype)`` on x's device, made there (no
    host-to-device copy inside a captured step)."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


@serde.register
@dataclasses.dataclass(frozen=True)
class ScaleShift(LayerConfig):
    """Fixed elementwise ``x * scale + shift`` (the ScaleVertex role as a
    sequential layer), the constants taken in x's dtype as the JAX
    package takes them."""

    SEQ_LOCAL = True

    scale: float = 1.0
    shift: float = 0.0
    HAS_PARAMS = False
    REGULARIZED = ()

    def apply(self, params, state, x, *, training=False, rng=None):
        y = x * _scalar(self.scale, x) + _scalar(self.shift, x)
        return self._act()(y), state


@serde.register
@dataclasses.dataclass(frozen=True)
class Dropout(LayerConfig):
    """Standalone dropout layer (DropoutLayer role)."""

    SEQ_LOCAL = True

    rate: float = 0.5
    HAS_PARAMS = False
    REGULARIZED = ()

    def apply(self, params, state, x, *, training=False, rng=None):
        return _dropout(x, self.rate, training, rng), state


@serde.register
@dataclasses.dataclass(frozen=True)
class Embedding(LayerConfig):
    """Token ids (B,) -> (B, n_out) or (B, T) -> (B, T, n_out)."""

    SEQ_LOCAL = True

    n_in: int = 0
    n_out: int = 0

    def output_type(self, itype):
        if itype.kind == InputType.KIND_RNN:
            return InputType.recurrent(self.n_out, itype.shape[0])
        return InputType.feed_forward(self.n_out)

    def init(self, key, itype, device):
        if self.n_in <= 0:
            raise ValueError("Embedding.n_in (vocab size) must be set explicitly")
        return {"W": self._winit().init(key, (self.n_in, self.n_out),
                                        fan_in=self.n_in, fan_out=self.n_out,
                                        device=device)}, {}

    def apply(self, params, state, x, *, training=False, rng=None):
        from deeplearning4j_tpu_torch.parallel import collectives

        # a quantized table gathers int8 rows and returns them in f32
        y = quantf.embedding_lookup(params["W"], x.long())
        if leaf_axis(params["W"]) == "model":
            y = collectives.gather(y, -1, "model")      # columns of each row
        return self._act()(y), state


# ---------------------------------------------------------------------------
# Convolutional layers (NHWC maps, HWIO kernels; ops/conv.py)
# ---------------------------------------------------------------------------

@serde.register
@dataclasses.dataclass(frozen=True)
class Conv2D(LayerConfig):
    """2D convolution (ConvolutionLayer role): ``lax.conv_general_dilated``
    in the JAX package, cuDNN on the card (`ops/conv.py`)."""

    n_out: int = 0
    kernel: tuple[int, int] = (3, 3)
    stride: tuple[int, int] = (1, 1)
    padding: str = "valid"             # "same" | "valid"
    dilation: tuple[int, int] = (1, 1)
    groups: int = 1                    # n_in groups => depthwise
    has_bias: bool = True

    EXPECTS = "cnn"

    def _out_hw(self, h: int, w: int) -> tuple[int, int]:
        kh, kw = conv_ops.pair(self.kernel)
        sh, sw = conv_ops.pair(self.stride)
        dh, dw = conv_ops.pair(self.dilation)
        ekh, ekw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
        if self.padding == "same":
            return -(-h // sh), -(-w // sw)
        return (h - ekh) // sh + 1, (w - ekw) // sw + 1

    def output_type(self, itype):
        h, w, _ = itype.shape
        oh, ow = self._out_hw(h, w)
        return InputType.convolutional(oh, ow, self.n_out)

    def init(self, key, itype, device):
        c_in = itype.channels
        kh, kw = conv_ops.pair(self.kernel)
        if c_in % self.groups:
            raise ValueError(f"channels {c_in} not divisible by groups {self.groups}")
        shape = (kh, kw, c_in // self.groups, self.n_out)
        fan_in = kh * kw * (c_in // self.groups)
        fan_out = kh * kw * self.n_out // self.groups
        p = {"W": self._winit(WeightInit.RELU).init(key, shape, fan_in=fan_in,
                                                      fan_out=fan_out, device=device)}
        if self.has_bias:
            p["b"] = torch.zeros(self.n_out, device=device)
        return p, {}

    def apply(self, params, state, x, *, training=False, rng=None):
        x = _dropout(x, self.dropout_rate or 0.0, training, rng)

        def fn(x):
            groups = self.groups
            if groups > 1 and leaf_axis(params["W"]) == "model":
                # a grouped kernel's output slice reads its groups' inputs
                from deeplearning4j_tpu_torch.parallel import collectives

                x = collectives.block(x, -1, "model")
                groups //= collectives.axis_size("model")
            # conv_weight: a dtype cast, or the int8 kernel dequantized
            w = quantf.conv_weight(params["W"], x.dtype)
            y = conv_ops.conv2d_nhwc(x, w, stride=self.stride, padding=self.padding,
                                     dilation=self.dilation, groups=groups)
            if self.has_bias:
                y = y + params["b"].to(x.dtype)
            return y

        return self._act()(split_region(self, params, x, fn)), state


@serde.register
@dataclasses.dataclass(frozen=True)
class SeparableConv2D(LayerConfig):
    """Depthwise then pointwise convolution (SeparableConvolution2D
    role): a convolution of ``C_in`` groups over ``depthW`` (kh, kw, 1,
    C_in m), whose output channel o belongs to input channel o // m,
    then a 1 x 1 convolution over ``pointW`` (1, 1, C_in m, n_out)."""

    n_out: int = 0
    kernel: tuple[int, int] = (3, 3)
    stride: tuple[int, int] = (1, 1)
    padding: str = "valid"
    depth_multiplier: int = 1
    has_bias: bool = True

    EXPECTS = "cnn"
    REGULARIZED = ("depthW", "pointW")

    def output_type(self, itype):
        h, w, _ = itype.shape
        oh, ow = Conv2D(n_out=self.n_out, kernel=self.kernel, stride=self.stride,
                        padding=self.padding)._out_hw(h, w)
        return InputType.convolutional(oh, ow, self.n_out)

    def init(self, key, itype, device):
        c_in, m = itype.channels, self.depth_multiplier
        kh, kw = conv_ops.pair(self.kernel)
        k1, k2 = rng_mod.split(key)
        wi = self._winit(WeightInit.RELU)
        p = {"depthW": wi.init(k1, (kh, kw, 1, c_in * m), fan_in=kh * kw, fan_out=m,
                               device=device),
             "pointW": wi.init(k2, (1, 1, c_in * m, self.n_out), fan_in=c_in * m,
                               fan_out=self.n_out, device=device)}
        if self.has_bias:
            p["b"] = torch.zeros(self.n_out, device=device)
        return p, {}

    def apply(self, params, state, x, *, training=False, rng=None):
        x = _dropout(x, self.dropout_rate or 0.0, training, rng)
        y = conv_ops.conv2d_nhwc(x, quantf.conv_weight(params["depthW"], x.dtype),
                                 stride=self.stride, padding=self.padding,
                                 groups=x.shape[-1])

        def fn(y):
            y = conv_ops.conv2d_nhwc(y, quantf.conv_weight(params["pointW"], x.dtype))
            if self.has_bias:
                y = y + params["b"].to(x.dtype)
            return y

        return self._act()(split_region(self, params, y, fn, "pointW")), state


@serde.register
@dataclasses.dataclass(frozen=True)
class Deconv2D(LayerConfig):
    """Transposed convolution (Deconvolution2D role): JAX's
    ``lax.conv_transpose`` (`ops/conv.py` `conv_transpose2d_nhwc`)."""

    n_out: int = 0
    kernel: tuple[int, int] = (2, 2)
    stride: tuple[int, int] = (2, 2)
    padding: str = "valid"
    has_bias: bool = True

    EXPECTS = "cnn"

    def output_type(self, itype):
        h, w, _ = itype.shape
        kh, kw = conv_ops.pair(self.kernel)
        sh, sw = conv_ops.pair(self.stride)
        if self.padding == "same":
            oh, ow = h * sh, w * sw
        else:
            oh, ow = h * sh + max(kh - sh, 0), w * sw + max(kw - sw, 0)
        return InputType.convolutional(oh, ow, self.n_out)

    def init(self, key, itype, device):
        c_in = itype.channels
        kh, kw = conv_ops.pair(self.kernel)
        p = {"W": self._winit(WeightInit.RELU).init(
            key, (kh, kw, c_in, self.n_out), fan_in=kh * kw * c_in,
            fan_out=kh * kw * self.n_out, device=device)}
        if self.has_bias:
            p["b"] = torch.zeros(self.n_out, device=device)
        return p, {}

    def apply(self, params, state, x, *, training=False, rng=None):
        x = _dropout(x, self.dropout_rate or 0.0, training, rng)

        def fn(x):
            y = conv_ops.conv_transpose2d_nhwc(
                x, quantf.conv_weight(params["W"], x.dtype), stride=self.stride,
                padding=self.padding)
            if self.has_bias:
                y = y + params["b"].to(x.dtype)
            return y

        return self._act()(split_region(self, params, x, fn)), state


@serde.register
@dataclasses.dataclass(frozen=True)
class Subsampling(LayerConfig):
    """Pooling layer (SubsamplingLayer role)."""

    pooling: PoolingType = PoolingType.MAX
    kernel: tuple[int, int] = (2, 2)
    stride: tuple[int, int] = (2, 2)
    padding: str = "valid"
    pnorm: int = 2

    EXPECTS = "cnn"
    HAS_PARAMS = False
    REGULARIZED = ()

    def output_type(self, itype):
        h, w, c = itype.shape
        kh, kw = conv_ops.pair(self.kernel)
        sh, sw = conv_ops.pair(self.stride)
        if self.padding == "same":
            oh, ow = -(-h // sh), -(-w // sw)
        else:
            oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
        return InputType.convolutional(oh, ow, c)

    def apply(self, params, state, x, *, training=False, rng=None):
        return conv_ops.pool2d_nhwc(x, self.pooling.value, kernel=self.kernel,
                                    stride=self.stride, padding=self.padding,
                                    pnorm=self.pnorm), state


@serde.register
@dataclasses.dataclass(frozen=True)
class SpaceToDepth(LayerConfig):
    """Space to depth (SpaceToDepthLayer role; YOLO2's passthrough): (B,
    H, W, C) -> (B, H / b, W / b, C b^2), channels in the JAX package's
    (bi, bj, c) order (not `F.pixel_unshuffle`'s (c, bi, bj))."""

    block: int = 2
    EXPECTS = "cnn"
    HAS_PARAMS = False
    REGULARIZED = ()

    def output_type(self, itype):
        h, w, c = itype.shape
        b = self.block
        if h % b or w % b:
            raise ValueError(f"spatial dims ({h},{w}) not divisible by block {b}")
        return InputType.convolutional(h // b, w // b, c * b * b)

    def apply(self, params, state, x, *, training=False, rng=None):
        n, h, w, c = x.shape
        b = self.block
        y = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(n, h // b, w // b, c * b * b), state


@serde.register
@dataclasses.dataclass(frozen=True)
class ZeroPadding2D(LayerConfig):
    """Zeros around (B, H, W, C) maps: (top, bottom, left, right)."""

    padding: tuple[int, int, int, int] = (1, 1, 1, 1)
    EXPECTS = "cnn"
    HAS_PARAMS = False
    REGULARIZED = ()

    def output_type(self, itype):
        h, w, c = itype.shape
        t, b, l, r = self.padding
        return InputType.convolutional(h + t + b, w + l + r, c)

    def apply(self, params, state, x, *, training=False, rng=None):
        t, b, l, r = self.padding
        return torch.nn.functional.pad(x, (0, 0, l, r, t, b)), state


@serde.register
@dataclasses.dataclass(frozen=True)
class Upsampling2D(LayerConfig):
    """Nearest-neighbour upsampling: each row repeated ``size[0]`` times,
    then each column ``size[1]`` times."""

    size: tuple[int, int] = (2, 2)
    EXPECTS = "cnn"
    HAS_PARAMS = False
    REGULARIZED = ()

    def output_type(self, itype):
        h, w, c = itype.shape
        return InputType.convolutional(h * self.size[0], w * self.size[1], c)

    def apply(self, params, state, x, *, training=False, rng=None):
        y = x.repeat_interleave(self.size[0], dim=1)
        return y.repeat_interleave(self.size[1], dim=2), state


@serde.register
@dataclasses.dataclass(frozen=True)
class GlobalPooling(LayerConfig):
    """GlobalPoolingLayer role: collapse the time axis of (B, T, F) or the
    spatial axes of (B, H, W, C).  A (B, T) features mask excludes padded
    steps from every pooling type: MAX sees them as -inf, SUM and PNORM
    (p = 2) as zeros, AVG divides the masked sum by ``max(sum m, 1)``."""

    pooling: PoolingType = PoolingType.AVG
    HAS_PARAMS = False
    REGULARIZED = ()
    ACCEPTS_MASK = True

    def output_type(self, itype):
        if itype.kind == InputType.KIND_CNN:
            return InputType.feed_forward(itype.channels)
        if itype.kind == InputType.KIND_RNN:
            return InputType.feed_forward(itype.size)
        return itype

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        axes = tuple(range(1, x.dim() - 1))
        m = None
        if mask is not None:
            m = mask.to(x.dtype)
            while m.dim() < x.dim():
                m = m[..., None]
        if self.pooling is PoolingType.MAX:
            if m is not None:
                x = torch.where(m > 0, x, torch.full((), float("-inf"),
                                                     dtype=x.dtype, device=x.device))
            return torch.amax(x, dim=axes), state
        if self.pooling is PoolingType.SUM:
            if m is not None:
                x = x * m
            return x.sum(dim=axes), state
        if self.pooling is PoolingType.PNORM:
            if m is not None:
                x = x * m
            return (x.abs() ** 2.0).sum(dim=axes) ** 0.5, state
        if m is not None:
            denom = torch.clamp(m.sum(dim=axes), min=1.0)
            return (x * m).sum(dim=axes) / denom, state
        return x.mean(dim=axes), state


# ---------------------------------------------------------------------------
# Normalization layers
# ---------------------------------------------------------------------------

@serde.register
@dataclasses.dataclass(frozen=True)
class BatchNorm(LayerConfig):
    """BatchNormalization role.  The running mean and variance live in
    the layer's STATE: training normalises with the batch's mean and
    population variance (``jnp.var``) in f32 and returns the running
    stats as ``decay * old + (1 - decay) * batch``; inference normalises
    with them.  (``F.batch_norm``'s own update uses the unbiased
    variance and the opposite momentum, so it is not used.)  Under data
    parallelism the batch mean and variance are global means over every
    rank's rows (`parallel/context.py` `global_mean`, the JAX package's
    cross-replica reduction), so the running stats agree on every rank."""

    SEQ_LOCAL = True

    epsilon: float = 1e-5
    decay: float = 0.9        # running-stat momentum (reference default 0.9)
    lock_gamma_beta: bool = False

    REGULARIZED = ()

    def init(self, key, itype, device):
        c = itype.shape[-1]
        params = {}
        if not self.lock_gamma_beta:
            params = {"gamma": torch.ones(c, device=device),
                      "beta": torch.zeros(c, device=device)}
        state = {"mean": torch.zeros(c, device=device),
                 "var": torch.ones(c, device=device)}
        return params, state

    def apply(self, params, state, x, *, training=False, rng=None):
        dims = tuple(range(x.dim() - 1))
        xf = x.float()
        if training:
            mean = dp_context.global_mean(xf, dims)
            var = dp_context.global_mean((xf - mean) ** 2, dims)
            new_state = {
                "mean": self.decay * state["mean"] + (1 - self.decay) * mean,
                "var": self.decay * state["var"] + (1 - self.decay) * var,
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        scale = torch.rsqrt(var + self.epsilon)
        if "gamma" in params:
            scale = params["gamma"].float() * scale
        shift = (params["beta"].float() - mean * scale if "beta" in params
                 else -(mean * scale))
        y = (xf * scale + shift).to(x.dtype)
        return self._act()(y), new_state


def layer_norm(params: dict, x: torch.Tensor, epsilon: float = 1e-5) -> torch.Tensor:
    """Layer normalization over the last dim, in f32, back in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + epsilon)
    y = y * params["gamma"].float() + params["beta"].float()
    return y.to(x.dtype)


@serde.register
@dataclasses.dataclass(frozen=True)
class LayerNorm(LayerConfig):
    """Layer normalization over the last dim, computed in f32."""

    SEQ_LOCAL = True

    epsilon: float = 1e-5
    REGULARIZED = ()

    def init(self, key, itype, device):
        c = itype.shape[-1]
        return {"gamma": torch.ones(c, device=device),
                "beta": torch.zeros(c, device=device)}, {}

    def apply(self, params, state, x, *, training=False, rng=None):
        return self._act()(layer_norm(params, x, self.epsilon)), state


@serde.register
@dataclasses.dataclass(frozen=True)
class LocalResponseNormalization(LayerConfig):
    """LRN role (AlexNet's): ``x / (k + alpha sum x^2)^beta``, the sum over
    a window of ``n`` channels zero-padded by ``n // 2`` each side, in
    f32.  (`F.local_response_norm` divides alpha by n: another
    function.)"""

    SEQ_LOCAL = True

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75
    EXPECTS = "cnn"
    HAS_PARAMS = False
    REGULARIZED = ()

    def apply(self, params, state, x, *, training=False, rng=None):
        xf = x.float()
        c, half = x.shape[-1], self.n // 2
        padded = torch.nn.functional.pad(xf * xf, (half, half))
        s = 0
        for i in range(self.n):
            s = s + padded[..., i:i + c]
        y = xf / (self.k + self.alpha * s) ** self.beta
        return y.to(x.dtype), state


@serde.register
@dataclasses.dataclass(frozen=True)
class CenterLossOutputLayer(LayerConfig):
    """Softmax and center loss output (CenterLossOutputLayer role, the
    FaceNetNN4Small2 head): the cross-entropy separates the classes while
    a center term pulls each embedding toward its class center.  The
    centers are trained parameters; ``alpha`` scales only the gradient
    that reaches them.  ``apply`` returns ``concat([logits, x])``
    (`split_output` separates the halves)."""

    n_out: int = 0            # number of classes
    alpha: float = 0.1        # the centers' learning-rate multiplier
    lambda_coeff: float = 2e-4  # weight of the center term
    has_bias: bool = True

    EXPECTS = "ff"

    def output_type(self, itype):
        return InputType.feed_forward(self.n_out + itype.size)

    def init(self, key, itype, device):
        n_in = itype.size
        p = _dense_init(self, key, n_in, device)
        p["centers"] = torch.zeros((self.n_out, n_in), device=device)
        return p, {}

    def apply(self, params, state, x, *, training=False, rng=None):
        x = _dropout(x, self.dropout_rate or 0.0, training, rng)
        return torch.cat([_dense(self, params, x), x], dim=-1), state

    def split_output(self, out):
        """(logits, embedding) halves of ``apply``'s output."""
        return out[..., :self.n_out], out[..., self.n_out:]

    def evaluation_output(self, lp, out):
        """Class probabilities for `Evaluation` (an argmax over the whole
        output would land in the embedding half)."""
        return torch.softmax(self.split_output(out)[0].float(), dim=-1)

    def compute_loss_with_params(self, lp, preds, labels, mask=None):
        logits, emb = self.split_output(preds.float())
        labels = labels.float()
        per = -(labels * torch.log_softmax(logits, dim=-1)).sum(dim=-1)
        centers = lp["centers"]
        centers = centers * self.alpha + centers.detach() * (1 - self.alpha)
        c = labels @ centers.float()
        per = per + self.lambda_coeff * (0.5 * ((emb - c) ** 2).sum(dim=-1))
        if mask is not None:
            m = mask.float()
            return (per * m).sum() / torch.clamp(m.sum(), min=1.0)
        return per.mean()


@serde.register
@dataclasses.dataclass(frozen=True)
class ChunkedSoftmaxOutputLayer(LayerConfig):
    """LM head whose training loss streams the vocab in chunks
    (`ops/chunked_xent.py`), so the (N, vocab) logits never exist.
    ``apply`` passes hidden states through (dropped out in training) and
    the loss owns the projection; for inference ``logits`` projects them
    densely."""

    SEQ_LOCAL = True

    n_out: int = 0
    chunk: int = 8192
    has_bias: bool = True

    def init(self, key, itype, device):
        return _dense_init(self, key, itype.size, device), {}

    def apply(self, params, state, x, *, training=False, rng=None):
        return _dropout(x, self.dropout_rate or 0.0, training, rng), state

    def evaluation_output(self, lp, out):
        """Class probabilities for `Evaluation`: the hidden states
        projected densely (evaluation batches are inference-sized)."""
        return torch.softmax(self.logits(lp, out).float(), dim=-1)

    def logits(self, params, h):
        return _dense(self, params, h)

    def compute_loss_with_params(self, lp, preds, labels, mask=None):
        """Chunked cross-entropy of (..., D) hidden states ``preds`` against
        int ids (...,) or one-hot labels (..., n_out), told apart by
        element count as in the JAX package (a sequence as long as the
        vocab would otherwise read (B, T) ids as (B, V) one-hot)."""
        from deeplearning4j_tpu_torch.ops.chunked_xent import chunked_softmax_xent

        d = preds.shape[-1]
        h = preds.reshape(-1, d)
        n = h.shape[0]
        if labels.numel() == n * self.n_out:
            labels = labels.reshape(n, self.n_out).argmax(dim=-1)   # one-hot
        elif labels.numel() != n:
            raise ValueError(
                f"labels with {labels.numel()} elements fit neither int ids "
                f"({n}) nor one-hot ({n}x{self.n_out})")
        ids = labels.reshape(-1).long()
        w = (mask.reshape(-1).float() if mask is not None
             else torch.ones((n,), dtype=torch.float32, device=h.device))
        W = lp["W"]
        b = lp.get("b")
        if b is None:
            b = torch.zeros((W.shape[1],), dtype=torch.float32, device=h.device)
        # under the model axis: W / b hold this rank's vocabulary shard
        axis = leaf_axis(W)
        return chunked_softmax_xent(h, W, b, ids, w, self.chunk, vocab_axis=axis)
