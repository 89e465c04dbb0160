"""`SequentialConfiguration` and its ``builder().list().layer(...)`` DSL —
`deeplearning4j_tpu/nn/conf/neural_net_configuration.py`.

The configuration has the JAX class's fields and round-trips through
the same JSON (`to_json` / `from_json`, `utils/serde.py`).  Model-level
defaults (activation, weight init, l1, l2, dropout) flow into layers
that did not set their own; layers left unnamed get ``layer{i}``, the
names parameter trees key on.  The configuration walks the input type
down the stack (`layer_input_types`), with the implicit CNN -> FF
flatten where a feed-forward layer follows a convolutional one (the
InputPreProcessor role, `flatten_flags`).  Fields the port cannot
honour yet load all the same and raise when a model is built
(`SequentialModel`, `LayerConfig.check_supported`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import LayerConfig
from deeplearning4j_tpu_torch.nn.updaters import Sgd, Updater
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.utils import serde


@serde.register
@dataclasses.dataclass(frozen=True)
class SequentialConfiguration:
    layers: tuple[LayerConfig, ...] = ()
    input_type: Optional[InputType] = None
    updater: Updater = dataclasses.field(default_factory=Sgd)
    seed: int = 0
    gradient_clip_value: Optional[float] = None
    gradient_clip_norm: Optional[float] = None
    # None = auto: bf16 compute on CUDA, f32 on the CPU
    bf16_compute: Optional[bool] = None
    # iterations per epoch, for epoch-based learning-rate schedules
    steps_per_epoch: int = 1
    # "standard" or "tbptt": truncated BPTT in windows of tbptt_length
    # steps (`SequentialModel._run_tbptt`)
    backprop_type: str = "standard"
    tbptt_length: int = 0

    def to_json(self) -> str:
        return serde.dumps(self)

    @staticmethod
    def from_json(s: str) -> "SequentialConfiguration":
        cfg = serde.loads(s)
        if not isinstance(cfg, SequentialConfiguration):
            raise TypeError(
                f"JSON did not decode to SequentialConfiguration: {type(cfg)}")
        return cfg

    def check_supported(self) -> None:
        """Raise `NotImplementedError`, naming the ROADMAP item, for a
        setting this port cannot honour yet."""
        for layer in self.layers:
            layer.check_supported()

    def _walk_types(self) -> tuple[list[InputType], list[bool]]:
        """The type walk down the stack, with the implicit CNN -> FF
        flatten: where a layer EXPECTS "ff" and the incoming type is
        convolutional, the maps flatten (NHWC order) first; ``flags[i]``
        records it so the model applies the same rule."""
        if self.input_type is None:
            raise ValueError("configuration has no input_type; call set_input_type")
        itypes, flags = [], []
        cur = self.input_type
        for layer in self.layers:
            flat = layer.EXPECTS == "ff" and cur.kind in (
                InputType.KIND_CNN, InputType.KIND_CNN3D)
            if flat:
                cur = InputType.feed_forward(cur.flat_size)
            flags.append(flat)
            itypes.append(cur)
            cur = layer.output_type(cur)
        return itypes, flags

    def layer_input_types(self) -> list[InputType]:
        """Input type each layer sees (after a flatten where one applies)."""
        return self._walk_types()[0]

    def flatten_flags(self) -> list[bool]:
        """Whether an implicit flatten precedes each layer."""
        return self._walk_types()[1]

    def output_type(self) -> InputType:
        itypes = self.layer_input_types()
        return self.layers[-1].output_type(itypes[-1])


class NeuralNetConfiguration:
    """Fluent builder::

        conf = (NeuralNetConfiguration.builder().seed(123)
                .updater(Adam(3e-4))
                .list()
                .layer(Embedding(n_in=vocab, n_out=d))
                .layer(PositionalEncoding())
                .layer(TransformerEncoderBlock(d_model=d, n_heads=h))
                .layer(ChunkedSoftmaxOutputLayer(n_out=vocab))
                .set_input_type(InputType.recurrent(1))
                .build())

    or LeNet's ``Conv2D`` / ``Subsampling`` / ``Dense`` / ``OutputLayer``
    stack over ``InputType.convolutional(28, 28, 1)`` (`zoo/lenet.py`).
    """

    def __init__(self):
        self._seed = 0
        self._updater: Updater = Sgd()
        self._activation: Optional[Activation] = None
        self._weight_init: Optional[WeightInit] = None
        self._l1: Optional[float] = None
        self._l2: Optional[float] = None
        self._dropout: Optional[float] = None
        self._clip_value: Optional[float] = None
        self._clip_norm: Optional[float] = None
        self._bf16: Optional[bool] = None
        self._steps_per_epoch = 1
        self._backprop_type = "standard"
        self._tbptt_length = 0
        self._layers: list[LayerConfig] = []
        self._input_type: Optional[InputType] = None

    @staticmethod
    def builder() -> "NeuralNetConfiguration":
        return NeuralNetConfiguration()

    def seed(self, s: int):
        self._seed = int(s)
        return self

    def updater(self, u: Updater):
        self._updater = u
        return self

    def activation(self, a: Activation):
        self._activation = a
        return self

    def weight_init(self, w: WeightInit):
        self._weight_init = w
        return self

    def l1(self, v: float):
        self._l1 = v
        return self

    def l2(self, v: float):
        self._l2 = v
        return self

    def dropout(self, rate: float):
        self._dropout = rate
        return self

    def gradient_clip(self, value: float | None = None,
                      norm: float | None = None):
        self._clip_value, self._clip_norm = value, norm
        return self

    def bf16_compute(self, on: Optional[bool]):
        self._bf16 = on
        return self

    def steps_per_epoch(self, n: int):
        """Iterations per epoch, read by per-epoch learning-rate schedules."""
        self._steps_per_epoch = max(1, int(n))
        return self

    def tbptt(self, length: int):
        """Truncated BPTT in windows of ``length`` steps (the
        BackpropType.TruncatedBPTT role)."""
        self._backprop_type = "tbptt"
        self._tbptt_length = int(length)
        return self

    def list(self):
        return self

    def set_input_type(self, itype: InputType):
        self._input_type = itype
        return self

    def layer(self, layer: LayerConfig):
        self._layers.append(self._fill_defaults(layer))
        return self

    def _fill_defaults(self, layer: LayerConfig) -> LayerConfig:
        updates = {}
        # the global activation never reaches an output layer: its
        # activation follows from its loss
        if (layer.activation is None and self._activation is not None
                and not hasattr(layer, "loss")):
            updates["activation"] = self._activation
        if layer.weight_init is None and self._weight_init is not None:
            updates["weight_init"] = self._weight_init
        if layer.l1 is None and self._l1 is not None:
            updates["l1"] = self._l1
        if layer.l2 is None and self._l2 is not None:
            updates["l2"] = self._l2
        if layer.dropout_rate is None and self._dropout is not None:
            updates["dropout_rate"] = self._dropout
        if layer.name is None:
            updates["name"] = f"layer{len(self._layers)}"
        return dataclasses.replace(layer, **updates) if updates else layer

    def build(self) -> SequentialConfiguration:
        if not self._layers:
            raise ValueError("no layers configured")
        names = [l.name for l in self._layers]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate layer names {sorted(dupes)}")
        return SequentialConfiguration(
            layers=tuple(self._layers), input_type=self._input_type,
            updater=self._updater, seed=self._seed,
            gradient_clip_value=self._clip_value,
            gradient_clip_norm=self._clip_norm, bf16_compute=self._bf16,
            steps_per_epoch=self._steps_per_epoch,
            backprop_type=self._backprop_type,
            tbptt_length=self._tbptt_length)
