"""SqueezeNet v1.1 — `deeplearning4j_tpu/zoo/squeezenet.py`, the reference
zoo's `org.deeplearning4j.zoo.model.SqueezeNet`.

Fire modules: 1x1 "squeeze" conv feeding parallel 1x1 + 3x3 "expand" convs
whose outputs concatenate on channels (MergeVertex).  Ends with a 1x1
class conv + global average pool — no big FC layers.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer,
    Conv2D,
    Dropout,
    GlobalPooling,
    LossLayer,
    PoolingType,
    Subsampling,
)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder, MergeVertex
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel


class SqueezeNet(ZooModel):
    NAME = "squeezenet"

    # (squeeze, expand) filters per fire module, v1.1 schedule
    FIRES = [(16, 64), (16, 64), (32, 128), (32, 128),
             (48, 192), (48, 192), (64, 256), (64, 256)]

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3,
                 learning_rate: float = 1e-3):
        super().__init__(num_classes, seed)
        self.height, self.width, self.channels = height, width, channels
        self.learning_rate = learning_rate

    def _fire(self, g: GraphBuilder, name: str, inp: str, squeeze: int, expand: int) -> str:
        g.add_layer(f"{name}_sq", Conv2D(n_out=squeeze, kernel=(1, 1),
                                         activation=Activation.RELU), inp)
        g.add_layer(f"{name}_e1", Conv2D(n_out=expand, kernel=(1, 1),
                                         activation=Activation.RELU), f"{name}_sq")
        g.add_layer(f"{name}_e3", Conv2D(n_out=expand, kernel=(3, 3), padding="same",
                                         activation=Activation.RELU), f"{name}_sq")
        g.add_vertex(f"{name}_cat", MergeVertex(), f"{name}_e1", f"{name}_e3")
        return f"{name}_cat"

    def conf(self):
        g = (
            GraphBuilder()
            .seed(self.seed)
            .updater(Adam(self.learning_rate))
            .weight_init(WeightInit.RELU)
            .add_inputs("input")
            .set_input_types(InputType.convolutional(self.height, self.width, self.channels))
        )
        g.add_layer("stem", Conv2D(n_out=64, kernel=(3, 3), stride=(2, 2),
                                   activation=Activation.RELU, padding="same"), "input")
        g.add_layer("pool1", Subsampling(pooling=PoolingType.MAX, kernel=(3, 3),
                                         stride=(2, 2)), "stem")
        cur = "pool1"
        for i, (s, e) in enumerate(self.FIRES, start=2):
            cur = self._fire(g, f"fire{i}", cur, s, e)
            if i in (3, 5):  # v1.1 pools after fire3 and fire5
                g.add_layer(f"pool{i}", Subsampling(pooling=PoolingType.MAX,
                                                    kernel=(3, 3), stride=(2, 2)), cur)
                cur = f"pool{i}"
        g.add_layer("drop", Dropout(rate=0.5), cur)
        g.add_layer("head", Conv2D(n_out=self.num_classes, kernel=(1, 1),
                                   activation=Activation.RELU), "drop")
        g.add_layer("gap", GlobalPooling(pooling=PoolingType.AVG), "head")
        g.add_layer("output", LossLayer(loss=Loss.MCXENT, activation=Activation.SOFTMAX), "gap")
        g.set_outputs("output")
        return g.build()
