"""FaceNetNN4Small2 — `deeplearning4j_tpu/zoo/facenet.py`, the reference
zoo's `org.deeplearning4j.zoo.model.FaceNetNN4Small2` [U]: the OpenFace
nn4.small2 inception variant producing L2-normalized 128-d face
embeddings, trained with the center-loss head (`CenterLossOutputLayer`).

GoogLeNet-style inception modules (1x1 / 3x3-reduce / 5x5-reduce / pool
branches merged on the channel axis); channels-last throughout.  Embedding path: global avg pool → dense
128 → L2NormalizeVertex → center-loss softmax head.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BatchNorm,
    CenterLossOutputLayer,
    Conv2D,
    Dense,
    GlobalPooling,
    LocalResponseNormalization,
    PoolingType,
    Subsampling,
)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    GraphBuilder,
    L2NormalizeVertex,
    MergeVertex,
)
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel


def _conv_bn(g, name, inp, n_out, kernel, stride=(1, 1)) -> str:
    g.add_layer(
        name,
        Conv2D(n_out=n_out, kernel=kernel, stride=stride, padding="same",
               has_bias=False),
        inp,
    )
    g.add_layer(f"{name}_bn", BatchNorm(activation=Activation.RELU), name)
    return f"{name}_bn"


class FaceNetNN4Small2(ZooModel):
    NAME = "facenet_nn4_small2"

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 96, width: int = 96, channels: int = 3,
                 embedding_size: int = 128, learning_rate: float = 1e-3,
                 center_alpha: float = 0.1, center_lambda: float = 2e-4):
        super().__init__(num_classes, seed)
        self.height, self.width, self.channels = height, width, channels
        self.embedding_size = embedding_size
        self.learning_rate = learning_rate
        self.center_alpha = center_alpha
        self.center_lambda = center_lambda

    def _inception(self, g, name, inp, *, b1, r3, b3, r5, b5, pool,
                   stride=(1, 1)) -> str:
        """Four-branch inception module; b1/b5/pool may be 0 to drop the
        branch (the nn4 reduction modules do)."""
        branches = []
        if b1:
            branches.append(_conv_bn(g, f"{name}_1x1", inp, b1, (1, 1), stride))
        red3 = _conv_bn(g, f"{name}_3r", inp, r3, (1, 1))
        branches.append(_conv_bn(g, f"{name}_3x3", red3, b3, (3, 3), stride))
        if b5:
            red5 = _conv_bn(g, f"{name}_5r", inp, r5, (1, 1))
            branches.append(_conv_bn(g, f"{name}_5x5", red5, b5, (5, 5), stride))
        g.add_layer(
            f"{name}_pool",
            Subsampling(pooling=PoolingType.MAX, kernel=(3, 3), stride=stride,
                        padding="same"),
            inp,
        )
        if pool:
            branches.append(
                _conv_bn(g, f"{name}_poolproj", f"{name}_pool", pool, (1, 1))
            )
        else:
            branches.append(f"{name}_pool")
        g.add_vertex(f"{name}_merge", MergeVertex(), *branches)
        return f"{name}_merge"

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
        cur = _conv_bn(g, "conv1", "input", 64, (7, 7), (2, 2))
        g.add_layer("pool1", Subsampling(pooling=PoolingType.MAX, kernel=(3, 3),
                                         stride=(2, 2), padding="same"), cur)
        g.add_layer("lrn1", LocalResponseNormalization(), "pool1")
        cur = _conv_bn(g, "conv2", "lrn1", 64, (1, 1))
        cur = _conv_bn(g, "conv3", cur, 192, (3, 3))
        g.add_layer("lrn2", LocalResponseNormalization(), cur)
        g.add_layer("pool2", Subsampling(pooling=PoolingType.MAX, kernel=(3, 3),
                                         stride=(2, 2), padding="same"), "lrn2")

        cur = self._inception(g, "i3a", "pool2", b1=64, r3=96, b3=128,
                              r5=16, b5=32, pool=32)
        cur = self._inception(g, "i3b", cur, b1=64, r3=96, b3=128,
                              r5=32, b5=64, pool=64)
        cur = self._inception(g, "i3c", cur, b1=0, r3=128, b3=256,
                              r5=32, b5=64, pool=0, stride=(2, 2))
        cur = self._inception(g, "i4a", cur, b1=256, r3=96, b3=192,
                              r5=32, b5=64, pool=128)
        cur = self._inception(g, "i4e", cur, b1=0, r3=160, b3=256,
                              r5=64, b5=128, pool=0, stride=(2, 2))
        cur = self._inception(g, "i5a", cur, b1=256, r3=96, b3=384,
                              r5=0, b5=0, pool=96)
        cur = self._inception(g, "i5b", cur, b1=256, r3=96, b3=384,
                              r5=0, b5=0, pool=96)

        g.add_layer("gap", GlobalPooling(pooling=PoolingType.AVG), cur)
        g.add_layer("bottleneck", Dense(n_out=self.embedding_size,
                                        activation=Activation.IDENTITY), "gap")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer(
            "output",
            CenterLossOutputLayer(
                n_out=self.num_classes,
                alpha=self.center_alpha,
                lambda_coeff=self.center_lambda,
            ),
            "embeddings",
        )
        g.set_outputs("output")
        return g.build()
