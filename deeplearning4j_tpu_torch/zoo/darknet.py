"""Darknet19 — `deeplearning4j_tpu/zoo/darknet.py`, the reference zoo's
`org.deeplearning4j.zoo.model.Darknet19` (the YOLO2 backbone).

19 conv layers in the classic 3x3/1x1 alternating pattern, BatchNorm +
leaky-ReLU after every conv, five maxpool halvings, 1x1 class head +
global average pool.  All convs NHWC.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BatchNorm,
    Conv2D,
    GlobalPooling,
    LossLayer,
    PoolingType,
    Subsampling,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel

# (filters, kernel) per conv; "M" = maxpool.  Mirrors the darknet19 cfg.
DARKNET19_PLAN = [
    (32, 3), "M",
    (64, 3), "M",
    (128, 3), (64, 1), (128, 3), "M",
    (256, 3), (128, 1), (256, 3), "M",
    (512, 3), (256, 1), (512, 3), (256, 1), (512, 3), "M",
    (1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3),
]


def darknet_conv_block(b, idx: int, filters: int, kernel: int):
    """conv -> BN(leaky relu), the universal darknet block."""
    b.layer(Conv2D(name=f"conv{idx}", n_out=filters, kernel=(kernel, kernel),
                   padding="same", has_bias=False))
    b.layer(BatchNorm(name=f"bn{idx}", activation=Activation.LEAKYRELU))


class Darknet19(ZooModel):
    NAME = "darknet19"

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3,
                 learning_rate: float = 1e-3):
        super().__init__(num_classes, seed)
        self.height, self.width, self.channels = height, width, channels
        self.learning_rate = learning_rate

    def conf(self):
        b = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(Adam(self.learning_rate))
            .weight_init(WeightInit.RELU)
            .list()
        )
        idx, pools = 0, 0
        for item in DARKNET19_PLAN:
            if item == "M":
                pools += 1
                b.layer(Subsampling(name=f"pool{pools}", pooling=PoolingType.MAX,
                                    kernel=(2, 2), stride=(2, 2)))
            else:
                idx += 1
                darknet_conv_block(b, idx, item[0], item[1])
        # 1x1 class head then global average pool (darknet19 ordering)
        b.layer(Conv2D(name="head", n_out=self.num_classes, kernel=(1, 1), padding="same"))
        b.layer(GlobalPooling(name="gap", pooling=PoolingType.AVG))
        b.layer(LossLayer(name="output", loss=Loss.MCXENT, activation=Activation.SOFTMAX))
        return (
            b.set_input_type(InputType.convolutional(self.height, self.width, self.channels))
            .build()
        )
