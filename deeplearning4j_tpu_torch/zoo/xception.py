"""Xception — `deeplearning4j_tpu/zoo/xception.py`, the reference zoo's
`org.deeplearning4j.zoo.model.Xception`.

Depthwise-separable convs throughout (SeparableConv2D), with residual
1x1-conv shortcuts around each block (entry flow 3 blocks, middle flow 8
identity blocks, exit flow).  Channels-last.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer,
    BatchNorm,
    Conv2D,
    GlobalPooling,
    OutputLayer,
    PoolingType,
    SeparableConv2D,
    Subsampling,
)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ElementWiseOp,
    ElementWiseVertex,
    GraphBuilder,
)
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel


def _relu():
    return ActivationLayer(activation=Activation.RELU)


class Xception(ZooModel):
    NAME = "xception"

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 299, width: int = 299, channels: int = 3,
                 learning_rate: float = 1e-3, middle_blocks: int = 8):
        super().__init__(num_classes, seed)
        self.height, self.width, self.channels = height, width, channels
        self.learning_rate = learning_rate
        self.middle_blocks = middle_blocks

    def _sep_bn(self, g, name, inp, filters, relu_first: bool) -> str:
        cur = inp
        if relu_first:
            g.add_layer(f"{name}_r", _relu(), cur)
            cur = f"{name}_r"
        g.add_layer(f"{name}_sc", SeparableConv2D(n_out=filters, kernel=(3, 3),
                                                  padding="same", has_bias=False), cur)
        g.add_layer(f"{name}_bn", BatchNorm(), f"{name}_sc")
        return f"{name}_bn"

    def _entry_block(self, g, name, inp, filters, first_relu: bool) -> str:
        a = self._sep_bn(g, f"{name}_a", inp, filters, relu_first=first_relu)
        b = self._sep_bn(g, f"{name}_b", a, filters, relu_first=True)
        g.add_layer(f"{name}_pool", Subsampling(pooling=PoolingType.MAX, kernel=(3, 3),
                                                stride=(2, 2), padding="same"), b)
        g.add_layer(f"{name}_proj", Conv2D(n_out=filters, kernel=(1, 1), stride=(2, 2),
                                           has_bias=False), inp)
        g.add_layer(f"{name}_projbn", BatchNorm(), f"{name}_proj")
        g.add_vertex(f"{name}_add", ElementWiseVertex(ElementWiseOp.ADD),
                     f"{name}_pool", f"{name}_projbn")
        return f"{name}_add"

    def _middle_block(self, g, name, inp) -> str:
        cur = inp
        for i in range(3):
            cur = self._sep_bn(g, f"{name}_{i}", cur, 728, relu_first=True)
        g.add_vertex(f"{name}_add", ElementWiseVertex(ElementWiseOp.ADD), cur, inp)
        return f"{name}_add"

    def conf(self):
        g = (
            GraphBuilder()
            .seed(self.seed)
            .updater(Adam(self.learning_rate))
            .weight_init(WeightInit.RELU)
            .add_inputs("input")
            .set_input_types(InputType.convolutional(self.height, self.width, self.channels))
        )
        g.add_layer("stem1", Conv2D(n_out=32, kernel=(3, 3), stride=(2, 2), has_bias=False), "input")
        g.add_layer("stem1_bn", BatchNorm(activation=Activation.RELU), "stem1")
        g.add_layer("stem2", Conv2D(n_out=64, kernel=(3, 3), has_bias=False), "stem1_bn")
        g.add_layer("stem2_bn", BatchNorm(activation=Activation.RELU), "stem2")

        cur = self._entry_block(g, "entry1", "stem2_bn", 128, first_relu=False)
        cur = self._entry_block(g, "entry2", cur, 256, first_relu=True)
        cur = self._entry_block(g, "entry3", cur, 728, first_relu=True)
        for m in range(self.middle_blocks):
            cur = self._middle_block(g, f"mid{m}", cur)

        # exit flow
        a = self._sep_bn(g, "exit_a", cur, 728, relu_first=True)
        b = self._sep_bn(g, "exit_b", a, 1024, relu_first=True)
        g.add_layer("exit_pool", Subsampling(pooling=PoolingType.MAX, kernel=(3, 3),
                                             stride=(2, 2), padding="same"), b)
        g.add_layer("exit_proj", Conv2D(n_out=1024, kernel=(1, 1), stride=(2, 2),
                                        has_bias=False), cur)
        g.add_layer("exit_projbn", BatchNorm(), "exit_proj")
        g.add_vertex("exit_add", ElementWiseVertex(ElementWiseOp.ADD),
                     "exit_pool", "exit_projbn")
        c = self._sep_bn(g, "exit_c", "exit_add", 1536, relu_first=False)
        g.add_layer("exit_c_r", _relu(), c)
        d = self._sep_bn(g, "exit_d", "exit_c_r", 2048, relu_first=False)
        g.add_layer("exit_d_r", _relu(), d)
        g.add_layer("gap", GlobalPooling(pooling=PoolingType.AVG), "exit_d_r")
        g.add_layer("output", OutputLayer(n_out=self.num_classes, loss=Loss.MCXENT,
                                          activation=Activation.SOFTMAX), "gap")
        g.set_outputs("output")
        return g.build()
