"""`InputType` — `deeplearning4j_tpu/nn/conf/input_type.py`, as data.

Layers declare ``output_type(input_type)``; the configuration walks the
chain once (`SequentialConfiguration.layer_input_types`), so no layer
is given its input width by hand.  Convolutional types are NHWC, the
JAX package's layout: a (height, width, channels) type is a batch of
(B, H, W, C) maps, flattened in that order where a feed-forward layer
follows.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.utils import serde


@dataclasses.dataclass(frozen=True)
class InputType:
    KIND_FF = "ff"
    KIND_CNN = "cnn"
    KIND_RNN = "rnn"
    KIND_CNN3D = "cnn3d"

    kind: str = KIND_FF
    # FF: (size,); RNN: (timesteps, size), timesteps -1 = variable;
    # CNN: (height, width, channels); CNN3D: (d, h, w, channels)
    shape: tuple[int, ...] = (0,)

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(InputType.KIND_FF, (int(size),))

    @staticmethod
    def recurrent(size: int, timesteps: int = -1) -> "InputType":
        return InputType(InputType.KIND_RNN, (int(timesteps), int(size)))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(InputType.KIND_CNN, (int(height), int(width), int(channels)))

    @staticmethod
    def convolutional3d(depth: int, height: int, width: int,
                        channels: int) -> "InputType":
        return InputType(InputType.KIND_CNN3D,
                         (int(depth), int(height), int(width), int(channels)))

    @property
    def size(self) -> int:
        """Feature size of FF / RNN types."""
        if self.kind == self.KIND_FF:
            return self.shape[0]
        if self.kind == self.KIND_RNN:
            return self.shape[1]
        raise ValueError(f"size undefined for {self}")

    @property
    def channels(self) -> int:
        if self.kind in (self.KIND_CNN, self.KIND_CNN3D):
            return self.shape[-1]
        raise ValueError(f"channels undefined for {self}")

    @property
    def flat_size(self) -> int:
        n = 1
        for s in self.shape:
            if s < 0:
                raise ValueError(f"cannot flatten variable dimension in {self}")
            n *= s
        return n

    def batch_shape(self, batch: int) -> tuple[int, ...]:
        return (batch, *self.shape)

    def __repr__(self) -> str:
        return f"InputType({self.kind}, {self.shape})"


serde.register(InputType)
