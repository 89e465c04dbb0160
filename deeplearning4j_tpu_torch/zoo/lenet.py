"""LeNet — `deeplearning4j_tpu/zoo/lenet.py`, the reference zoo's
`org.deeplearning4j.zoo.model.LeNet` (BASELINE config 1):
conv20-pool-conv50-pool-dense500-softmax10 over 28 x 28 x 1 maps."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    Conv2D,
    Dense,
    OutputLayer,
    Subsampling,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel


class LeNet(ZooModel):
    NAME = "lenet"

    def __init__(self, num_classes: int = 10, seed: int = 123,
                 height: int = 28, width: int = 28, channels: int = 1,
                 learning_rate: float = 1e-3):
        super().__init__(num_classes, seed)
        self.height, self.width, self.channels = height, width, channels
        self.learning_rate = learning_rate

    def conf(self):
        return (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(Adam(self.learning_rate))
            .weight_init(WeightInit.XAVIER)
            .activation(Activation.RELU)
            .list()
            .layer(Conv2D(n_out=20, kernel=(5, 5), stride=(1, 1), padding="same"))
            .layer(Subsampling(kernel=(2, 2), stride=(2, 2)))
            .layer(Conv2D(n_out=50, kernel=(5, 5), stride=(1, 1), padding="same"))
            .layer(Subsampling(kernel=(2, 2), stride=(2, 2)))
            .layer(Dense(n_out=500))
            .layer(OutputLayer(n_out=self.num_classes, loss=Loss.MCXENT,
                               activation=Activation.SOFTMAX))
            .set_input_type(InputType.convolutional(self.height, self.width,
                                                    self.channels))
            .build()
        )
