"""SimpleCNN — `deeplearning4j_tpu/zoo/simplecnn.py`, the reference zoo's
small net: four conv-BatchNorm-pool blocks (16, 32, 64, 128 filters),
Dense 256, Dropout 0.5, softmax."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BatchNorm,
    Conv2D,
    Dense,
    Dropout,
    OutputLayer,
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


class SimpleCNN(ZooModel):
    NAME = "simplecnn"

    def __init__(self, num_classes: int = 10, seed: int = 123,
                 height: int = 48, width: int = 48, channels: int = 3,
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
            .activation(Activation.RELU)
            .list()
        )
        for filters in (16, 32, 64, 128):
            b.layer(Conv2D(n_out=filters, kernel=(3, 3), padding="same"))
            b.layer(BatchNorm(activation=Activation.RELU))
            b.layer(Subsampling(pooling=PoolingType.MAX, kernel=(2, 2), stride=(2, 2)))
        b.layer(Dense(n_out=256))
        b.layer(Dropout(rate=0.5))
        b.layer(OutputLayer(n_out=self.num_classes, loss=Loss.MCXENT,
                            activation=Activation.SOFTMAX))
        b.set_input_type(InputType.convolutional(self.height, self.width,
                                                 self.channels))
        return b.build()
