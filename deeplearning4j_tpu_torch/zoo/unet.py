"""UNet — `deeplearning4j_tpu/zoo/unet.py`, the reference zoo's UNet
(encoder-decoder with skip merges).

Exercises the graph machinery the other way from ResNet: MergeVertex
(channel concat) skip connections + Deconv2D upsampling, per-pixel
sigmoid output (segmentation).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    Conv2D,
    PoolingType,
    Subsampling,
)
from deeplearning4j_tpu_torch.nn.conf.layers import Deconv2D, LossLayer
from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder, MergeVertex
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel


class UNet(ZooModel):
    NAME = "unet"

    def __init__(self, num_classes: int = 1, seed: int = 123,
                 height: int = 128, width: int = 128, channels: int = 3,
                 base_filters: int = 32, depth: int = 3,
                 learning_rate: float = 1e-3):
        super().__init__(num_classes, seed)
        self.height, self.width, self.channels = height, width, channels
        self.base_filters = base_filters
        self.depth = depth
        self.learning_rate = learning_rate

    def _double_conv(self, g, name, inp, filters):
        g.add_layer(f"{name}_c1", Conv2D(n_out=filters, kernel=(3, 3), padding="same",
                                         activation=Activation.RELU), inp)
        g.add_layer(f"{name}_c2", Conv2D(n_out=filters, kernel=(3, 3), padding="same",
                                         activation=Activation.RELU), f"{name}_c1")
        return f"{name}_c2"

    def conf(self):
        g = (
            GraphBuilder()
            .seed(self.seed)
            .updater(Adam(self.learning_rate))
            .weight_init(WeightInit.RELU)
            .add_inputs("input")
            .set_input_types(
                InputType.convolutional(self.height, self.width, self.channels)
            )
        )
        # encoder
        skips = []
        cur = "input"
        for d in range(self.depth):
            filters = self.base_filters * (2**d)
            cur = self._double_conv(g, f"enc{d}", cur, filters)
            skips.append(cur)
            g.add_layer(f"down{d}", Subsampling(pooling=PoolingType.MAX,
                                                kernel=(2, 2), stride=(2, 2)), cur)
            cur = f"down{d}"
        # bottleneck
        cur = self._double_conv(g, "mid", cur, self.base_filters * (2**self.depth))
        # decoder
        for d in reversed(range(self.depth)):
            filters = self.base_filters * (2**d)
            g.add_layer(f"up{d}", Deconv2D(n_out=filters, kernel=(2, 2),
                                           stride=(2, 2)), cur)
            g.add_vertex(f"cat{d}", MergeVertex(), f"up{d}", skips[d])
            cur = self._double_conv(g, f"dec{d}", f"cat{d}", filters)
        g.add_layer("logits", Conv2D(n_out=self.num_classes, kernel=(1, 1)), cur)
        g.add_layer("output", LossLayer(loss=Loss.XENT), "logits")
        g.set_outputs("output")
        return g.build()
