"""InceptionResNetV1 — `deeplearning4j_tpu/zoo/inception_resnet.py`, the
reference zoo's `org.deeplearning4j.zoo.model.InceptionResNetV1` (the
FaceNet backbone; the reference's FaceNetNN1Small2 variant builds on the
same blocks).

Stem, then scaled-residual inception blocks: A (35x35) / B (17x17) /
C (8x8) with Reduction-A/B in between.  Each block is a multi-branch
MergeVertex concat, 1x1-projected and added to its input through a
ScaleVertex (the 0.17/0.10/0.20 residual scales from the paper).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BatchNorm,
    Conv2D,
    Dense,
    Dropout,
    GlobalPooling,
    OutputLayer,
    PoolingType,
    Subsampling,
)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ElementWiseOp,
    ElementWiseVertex,
    GraphBuilder,
    MergeVertex,
    ScaleVertex,
)
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel


class InceptionResNetV1(ZooModel):
    NAME = "inception_resnet_v1"

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 160, width: int = 160, channels: int = 3,
                 learning_rate: float = 1e-3,
                 blocks_a: int = 5, blocks_b: int = 10, blocks_c: int = 5,
                 embedding_size: int = 128):
        super().__init__(num_classes, seed)
        self.height, self.width, self.channels = height, width, channels
        self.learning_rate = learning_rate
        self.blocks_a, self.blocks_b, self.blocks_c = blocks_a, blocks_b, blocks_c
        self.embedding_size = embedding_size

    def _conv(self, g, name, inp, filters, kernel, stride=1, padding="same") -> str:
        g.add_layer(name, Conv2D(n_out=filters, kernel=(kernel, kernel),
                                 stride=(stride, stride), padding=padding,
                                 has_bias=False), inp)
        g.add_layer(f"{name}_bn", BatchNorm(activation=Activation.RELU), name)
        return f"{name}_bn"

    def _residual(self, g, name, inp, concat, out_channels, scale) -> str:
        g.add_layer(f"{name}_proj", Conv2D(n_out=out_channels, kernel=(1, 1)), concat)
        g.add_vertex(f"{name}_scale", ScaleVertex(scale=scale), f"{name}_proj")
        g.add_vertex(f"{name}_add", ElementWiseVertex(ElementWiseOp.ADD), inp, f"{name}_scale")
        g.add_layer(f"{name}_out", BatchNorm(activation=Activation.RELU), f"{name}_add")
        return f"{name}_out"

    def _block_a(self, g, name, inp) -> str:  # 35x35, 256ch in our stem
        b1 = self._conv(g, f"{name}_b1", inp, 32, 1)
        b2 = self._conv(g, f"{name}_b2b", self._conv(g, f"{name}_b2a", inp, 32, 1), 32, 3)
        b3a = self._conv(g, f"{name}_b3a", inp, 32, 1)
        b3 = self._conv(g, f"{name}_b3c", self._conv(g, f"{name}_b3b", b3a, 32, 3), 32, 3)
        g.add_vertex(f"{name}_cat", MergeVertex(), b1, b2, b3)
        return self._residual(g, name, inp, f"{name}_cat", 256, 0.17)

    def _block_b(self, g, name, inp) -> str:  # 17x17, 896ch
        b1 = self._conv(g, f"{name}_b1", inp, 128, 1)
        b2a = self._conv(g, f"{name}_b2a", inp, 128, 1)
        b2b = self._conv(g, f"{name}_b2b", b2a, 128, 1)   # (1x7)(7x1) folded to 1x1+3x3 pair
        b2 = self._conv(g, f"{name}_b2c", b2b, 128, 3)
        g.add_vertex(f"{name}_cat", MergeVertex(), b1, b2)
        return self._residual(g, name, inp, f"{name}_cat", 896, 0.10)

    def _block_c(self, g, name, inp) -> str:  # 8x8, 1792ch
        b1 = self._conv(g, f"{name}_b1", inp, 192, 1)
        b2a = self._conv(g, f"{name}_b2a", inp, 192, 1)
        b2 = self._conv(g, f"{name}_b2b", b2a, 192, 3)
        g.add_vertex(f"{name}_cat", MergeVertex(), b1, b2)
        return self._residual(g, name, inp, f"{name}_cat", 1792, 0.20)

    def _reduction_a(self, g, inp) -> str:  # 35 -> 17
        b1 = self._conv(g, "redA_b1", inp, 384, 3, stride=2, padding="valid")
        b2 = self._conv(g, "redA_b2c",
                        self._conv(g, "redA_b2b",
                                   self._conv(g, "redA_b2a", inp, 192, 1), 192, 3),
                        256, 3, stride=2, padding="valid")
        g.add_layer("redA_pool", Subsampling(pooling=PoolingType.MAX, kernel=(3, 3),
                                             stride=(2, 2)), inp)
        g.add_vertex("redA_cat", MergeVertex(), b1, b2, "redA_pool")
        return "redA_cat"

    def _reduction_b(self, g, inp) -> str:  # 17 -> 8
        b1 = self._conv(g, "redB_b1b", self._conv(g, "redB_b1a", inp, 256, 1),
                        384, 3, stride=2, padding="valid")
        b2 = self._conv(g, "redB_b2b", self._conv(g, "redB_b2a", inp, 256, 1),
                        256, 3, stride=2, padding="valid")
        b3 = self._conv(g, "redB_b3c",
                        self._conv(g, "redB_b3b",
                                   self._conv(g, "redB_b3a", inp, 256, 1), 256, 3),
                        256, 3, stride=2, padding="valid")
        g.add_layer("redB_pool", Subsampling(pooling=PoolingType.MAX, kernel=(3, 3),
                                             stride=(2, 2)), inp)
        g.add_vertex("redB_cat", MergeVertex(), b1, b2, b3, "redB_pool")
        return "redB_cat"

    def conf(self):
        g = (
            GraphBuilder()
            .seed(self.seed)
            .updater(Adam(self.learning_rate))
            .weight_init(WeightInit.RELU)
            .add_inputs("input")
            .set_input_types(InputType.convolutional(self.height, self.width, self.channels))
        )
        # stem: 160 -> 35-ish spatial, 256 channels
        cur = self._conv(g, "stem1", "input", 32, 3, stride=2, padding="valid")
        cur = self._conv(g, "stem2", cur, 32, 3, padding="valid")
        cur = self._conv(g, "stem3", cur, 64, 3)
        g.add_layer("stem_pool", Subsampling(pooling=PoolingType.MAX, kernel=(3, 3),
                                             stride=(2, 2)), cur)
        cur = self._conv(g, "stem4", "stem_pool", 80, 1)
        cur = self._conv(g, "stem5", cur, 192, 3, padding="valid")
        cur = self._conv(g, "stem6", cur, 256, 3, stride=2, padding="valid")

        for i in range(self.blocks_a):
            cur = self._block_a(g, f"A{i}", cur)
        # Reduction-A concat: 384 + 256 + 256(pool) = 896 — the B-block width
        cur = self._reduction_a(g, cur)
        for i in range(self.blocks_b):
            cur = self._block_b(g, f"B{i}", cur)
        # Reduction-B concat: 384 + 256 + 256 + 896(pool) = 1792 — the C width
        cur = self._reduction_b(g, cur)
        for i in range(self.blocks_c):
            cur = self._block_c(g, f"C{i}", cur)

        g.add_layer("gap", GlobalPooling(pooling=PoolingType.AVG), cur)
        g.add_layer("drop", Dropout(rate=0.2), "gap")
        # bottleneck embedding (FaceNet's 128-d face embedding layer)
        g.add_layer("embedding", Dense(n_out=self.embedding_size,
                                       activation=Activation.IDENTITY), "drop")
        g.add_layer("output", OutputLayer(n_out=self.num_classes, loss=Loss.MCXENT,
                                          activation=Activation.SOFTMAX), "embedding")
        g.set_outputs("output")
        return g.build()
