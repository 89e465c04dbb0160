"""Weight initialization schemes — `deeplearning4j_tpu/nn/weights.py`.

Every scheme is a function of a threefry key (`runtime/rng.py`) and
draws the JAX package's bits: the same key gives the same f32 weights,
bit for bit, on the CPU and on the card.  The one exception is
ORTHOGONAL, whose QR factorisation (LAPACK on one side, PyTorch's on
the other) is not reproducible across libraries; it agrees to rounding.
Fan-in and fan-out come from the shape as `_fans` derives them.

Inside `skip_draws` (a thread's own setting) every scheme returns an
uninitialised tensor of its shape: a model that is about to be loaded
whole (`Model.load_params`) needs its tree's names and shapes, not its
random weights.
"""

from __future__ import annotations

import contextlib
import enum
import math
import threading

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime import rng


_LOCAL = threading.local()


@contextlib.contextmanager
def skip_draws():
    """`WeightInit.init` draws nothing in this thread while open."""
    before = getattr(_LOCAL, "skip", False)
    _LOCAL.skip = True
    try:
        yield
    finally:
        _LOCAL.skip = before


class WeightInit(str, enum.Enum):
    XAVIER = "xavier"              # glorot normal
    XAVIER_UNIFORM = "xavier_uniform"
    RELU = "relu"                  # he normal
    RELU_UNIFORM = "relu_uniform"
    LECUN_NORMAL = "lecun_normal"
    LECUN_UNIFORM = "lecun_uniform"
    NORMAL = "normal"              # N(0, 1/sqrt(fan_in))
    UNIFORM = "uniform"            # U(-a, a), a = 1/sqrt(fan_in)
    ZERO = "zero"
    ONES = "ones"
    CONSTANT = "constant"
    IDENTITY = "identity"
    ORTHOGONAL = "orthogonal"
    VAR_SCALING_NORMAL_FAN_AVG = "var_scaling_normal_fan_avg"

    def init(self, key, shape, fan_in=None, fan_out=None,
             constant: float = 0.0, device=None) -> torch.Tensor:
        """f32 weights of ``shape`` drawn with ``key`` (a 2-word threefry
        key) on ``device``."""
        shape = tuple(int(s) for s in shape)
        if getattr(_LOCAL, "skip", False):
            return torch.empty(shape, dtype=torch.float32, device=device)
        if fan_in is None or fan_out is None:
            fi, fo = _fans(shape)
            fan_in = fan_in if fan_in is not None else fi
            fan_out = fan_out if fan_out is not None else fo
        f32 = dict(dtype=torch.float32, device=device)
        w = self
        if w is WeightInit.ZERO:
            return torch.zeros(shape, **f32)
        if w is WeightInit.ONES:
            return torch.ones(shape, **f32)
        if w is WeightInit.CONSTANT:
            return torch.full(shape, constant, **f32)
        if w is WeightInit.IDENTITY:
            if len(shape) != 2 or shape[0] != shape[1]:
                raise ValueError(f"IDENTITY init needs a square 2D shape, got {shape}")
            return torch.eye(shape[0], **f32)
        if w is WeightInit.ORTHOGONAL:
            return _orthogonal(key, shape, device)
        if w in (WeightInit.XAVIER, WeightInit.VAR_SCALING_NORMAL_FAN_AVG):
            return _scaled(math.sqrt(2.0 / (fan_in + fan_out)), key, shape, device)
        if w is WeightInit.RELU:
            return _scaled(math.sqrt(2.0 / fan_in), key, shape, device)
        if w is WeightInit.LECUN_NORMAL:
            return _scaled(math.sqrt(1.0 / fan_in), key, shape, device)
        if w is WeightInit.NORMAL:
            # a division, as the JAX package writes it: x / s and
            # x * (1 / s) round differently
            z = rng.normal(key, shape, device)
            return z / torch.tensor(math.sqrt(fan_in), **f32)
        a = {WeightInit.XAVIER_UNIFORM: math.sqrt(6.0 / (fan_in + fan_out)),
             WeightInit.RELU_UNIFORM: math.sqrt(6.0 / fan_in),
             WeightInit.LECUN_UNIFORM: math.sqrt(3.0 / fan_in),
             WeightInit.UNIFORM: 1.0 / math.sqrt(fan_in)}.get(w)
        if a is None:
            raise ValueError(f"unhandled WeightInit {w}")
        return rng.uniform(key, shape, -a, a, device=device)


def _scaled(std: float, key, shape, device) -> torch.Tensor:
    # std is taken as f32, as jax takes a Python scale of an f32 array
    return rng.normal(key, shape, device) * float(np.float32(std))


def _orthogonal(key, shape, device) -> torch.Tensor:
    """``jax.nn.initializers.orthogonal()``: Q of the QR of a normal
    matrix, its columns' signs fixed by R's diagonal, transposed when
    wide, the last axis the column axis."""
    if len(shape) < 2:
        raise ValueError(f"ORTHOGONAL init needs at least 2 dims, got {shape}")
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    mshape = (n_cols, n_rows) if n_rows < n_cols else (n_rows, n_cols)
    a = rng.normal(key, mshape, device)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return q.reshape(shape).contiguous()


def _fans(shape: tuple[int, ...]) -> tuple[int, int]:
    """(fan_in, fan_out) for dense [in, out] and conv [kh, kw, in, out]
    shapes."""
    if len(shape) < 1:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[:-2]))
    return shape[-2] * receptive, shape[-1] * receptive
