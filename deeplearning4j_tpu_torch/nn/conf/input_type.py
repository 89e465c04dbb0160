"""`InputType` — `deeplearning4j_tpu/nn/conf/input_type.py`, as data.

A configuration carries its input type so that ``configuration.json``
matches the JAX package's.  The port's stacks size themselves from the
feature size of a feed-forward or recurrent type; convolutional types
wait for the LeNet slice (ROADMAP A3), and a model built from one
raises.
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

    def __repr__(self) -> str:
        return f"InputType({self.kind}, {self.shape})"


serde.register(InputType)
