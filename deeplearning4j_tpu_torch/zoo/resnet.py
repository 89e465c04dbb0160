"""ResNet-50 — `deeplearning4j_tpu/zoo/resnet.py`, the reference zoo's
`org.deeplearning4j.zoo.model.ResNet50` (BASELINE configs 2 and 5).

A bottleneck-v1 graph: a 7 x 7 / 2 convolution and a 3 x 3 / 2 max pool,
then stages of (3, 4, 6, 3) 1x1-3x3-1x1 bottlenecks (the stride in the
first 1 x 1) with identity or projection shortcuts added by an
`ElementWiseVertex` ADD, global average pooling and a softmax head;
BatchNorm after every convolution.  NHWC throughout.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ElementWiseOp,
    ElementWiseVertex,
    GraphBuilder,
)
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer,
    BatchNorm,
    Conv2D,
    GlobalPooling,
    OutputLayer,
    PoolingType,
    Subsampling,
)
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel


class ResNet50(ZooModel):
    NAME = "resnet50"

    STAGES = (3, 4, 6, 3)
    FILTERS = (64, 128, 256, 512)

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3,
                 learning_rate: float = 1e-3):
        super().__init__(num_classes, seed)
        self.height, self.width, self.channels = height, width, channels
        self.learning_rate = learning_rate

    def _bottleneck(self, g: GraphBuilder, name: str, inp: str, filters: int,
                    stride: int, project: bool) -> str:
        """1x1 (reduce) -> 3x3 -> 1x1 (expand x4) + shortcut."""
        expanded = filters * 4
        g.add_layer(f"{name}_c1", Conv2D(n_out=filters, kernel=(1, 1),
                                         stride=(stride, stride)), inp)
        g.add_layer(f"{name}_b1", BatchNorm(activation=Activation.RELU), f"{name}_c1")
        g.add_layer(f"{name}_c2", Conv2D(n_out=filters, kernel=(3, 3), padding="same"),
                    f"{name}_b1")
        g.add_layer(f"{name}_b2", BatchNorm(activation=Activation.RELU), f"{name}_c2")
        g.add_layer(f"{name}_c3", Conv2D(n_out=expanded, kernel=(1, 1)), f"{name}_b2")
        g.add_layer(f"{name}_b3", BatchNorm(), f"{name}_c3")
        shortcut = inp
        if project:
            g.add_layer(f"{name}_sc", Conv2D(n_out=expanded, kernel=(1, 1),
                                             stride=(stride, stride)), inp)
            g.add_layer(f"{name}_sb", BatchNorm(), f"{name}_sc")
            shortcut = f"{name}_sb"
        g.add_vertex(f"{name}_add", ElementWiseVertex(ElementWiseOp.ADD),
                     f"{name}_b3", shortcut)
        g.add_layer(f"{name}_out", ActivationLayer(activation=Activation.RELU),
                    f"{name}_add")
        return f"{name}_out"

    def conf(self):
        g = (GraphBuilder()
             .seed(self.seed)
             .updater(Adam(self.learning_rate))
             .weight_init(WeightInit.RELU)
             .add_inputs("input")
             .set_input_types(InputType.convolutional(self.height, self.width,
                                                      self.channels)))
        g.add_layer("stem_conv", Conv2D(n_out=64, kernel=(7, 7), stride=(2, 2),
                                        padding="same"), "input")
        g.add_layer("stem_bn", BatchNorm(activation=Activation.RELU), "stem_conv")
        g.add_layer("stem_pool", Subsampling(pooling=PoolingType.MAX, kernel=(3, 3),
                                             stride=(2, 2), padding="same"), "stem_bn")
        cur = "stem_pool"
        for stage, (blocks, filters) in enumerate(zip(self.STAGES, self.FILTERS)):
            for block in range(blocks):
                stride = 2 if (block == 0 and stage > 0) else 1
                cur = self._bottleneck(g, f"s{stage}b{block}", cur, filters, stride,
                                       project=block == 0)
        g.add_layer("avgpool", GlobalPooling(pooling=PoolingType.AVG), cur)
        g.add_layer("output", OutputLayer(n_out=self.num_classes, loss=Loss.MCXENT,
                                          activation=Activation.SOFTMAX), "avgpool")
        g.set_outputs("output")
        return g.build()
