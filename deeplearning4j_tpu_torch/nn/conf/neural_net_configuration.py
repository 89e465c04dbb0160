"""The ``builder().list().layer(...)`` subset of
`deeplearning4j_tpu/nn/conf/neural_net_configuration.py`, with the
training settings: updater (`Sgd` by default, as there), gradient
clipping and steps per epoch.

Layers left unnamed get ``layer{i}`` — parameter trees (and so
`convert.params_from_jax`) key on those names, exactly as in the JAX
package.  The input type is implied: the stack starts with an
`Embedding`, whose ``n_out`` sets every later layer's input size.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from deeplearning4j_tpu_torch.nn.conf.layers import LayerConfig
from deeplearning4j_tpu_torch.nn.updaters import Sgd, Updater


@dataclasses.dataclass(frozen=True)
class SequentialConfiguration:
    layers: tuple = ()
    updater: Updater = dataclasses.field(default_factory=Sgd)
    seed: int = 0
    gradient_clip_value: Optional[float] = None
    gradient_clip_norm: Optional[float] = None
    # None = auto: bf16 compute on CUDA, f32 on the CPU
    bf16_compute: Optional[bool] = None
    # iterations per epoch, for epoch-based LR schedules (not ported yet)
    steps_per_epoch: int = 1

    def layer_input_sizes(self) -> list[int]:
        """Feature size each layer sees (0 for the id-consuming first)."""
        sizes, cur = [], 0
        for layer in self.layers:
            sizes.append(cur)
            cur = layer.output_size(cur)
        return sizes


class NeuralNetConfiguration:
    """Fluent builder::

        conf = (NeuralNetConfiguration.builder().seed(123)
                .updater(Adam(3e-4))
                .list()
                .layer(Embedding(n_in=vocab, n_out=d))
                .layer(PositionalEncoding())
                .layer(TransformerEncoderBlock(d_model=d, n_heads=h))
                .layer(ChunkedSoftmaxOutputLayer(n_out=vocab))
                .build())
    """

    def __init__(self):
        self._seed = 0
        self._updater: Updater = Sgd()
        self._weight_init: Optional[str] = None
        self._clip_value: Optional[float] = None
        self._clip_norm: Optional[float] = None
        self._bf16: Optional[bool] = None
        self._steps_per_epoch = 1
        self._layers: list[LayerConfig] = []

    @staticmethod
    def builder() -> "NeuralNetConfiguration":
        return NeuralNetConfiguration()

    def seed(self, s: int):
        self._seed = int(s)
        return self

    def updater(self, u: Updater):
        self._updater = u
        return self

    def weight_init(self, w: str):
        self._weight_init = w
        return self

    def gradient_clip(self, value: float | None = None,
                      norm: float | None = None):
        self._clip_value, self._clip_norm = value, norm
        return self

    def bf16_compute(self, on: Optional[bool]):
        self._bf16 = on
        return self

    def steps_per_epoch(self, n: int):
        """Iterations per epoch — read by per-epoch LR schedules."""
        self._steps_per_epoch = max(1, int(n))
        return self

    def tbptt(self, length: int):
        raise NotImplementedError(
            "truncated BPTT is not ported yet (ROADMAP A8: recurrent layers "
            "and TBPTT)")

    def list(self):
        return self

    def layer(self, layer: LayerConfig):
        updates = {}
        if layer.weight_init is None and self._weight_init is not None:
            updates["weight_init"] = self._weight_init
        if layer.name is None:
            updates["name"] = f"layer{len(self._layers)}"
        self._layers.append(
            dataclasses.replace(layer, **updates) if updates else layer)
        return self

    def build(self) -> SequentialConfiguration:
        if not self._layers:
            raise ValueError("no layers configured")
        names = [l.name for l in self._layers]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate layer names {sorted(dupes)}")
        return SequentialConfiguration(
            layers=tuple(self._layers), updater=self._updater,
            seed=self._seed, gradient_clip_value=self._clip_value,
            gradient_clip_norm=self._clip_norm, bf16_compute=self._bf16,
            steps_per_epoch=self._steps_per_epoch)
