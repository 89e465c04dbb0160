"""AlexNet — `deeplearning4j_tpu/zoo/alexnet.py`, the reference zoo's
`org.deeplearning4j.zoo.model.AlexNet`.

Classic 5-conv/3-fc stack with LRN after the first two conv blocks
(Krizhevsky 2012, single-tower).  NHWC; one tower, no grouped two-GPU split (that was a 2012 memory
workaround, not an architecture feature).
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    Conv2D,
    Dense,
    Dropout,
    LocalResponseNormalization,
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


class AlexNet(ZooModel):
    NAME = "alexnet"

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3,
                 learning_rate: float = 1e-3):
        super().__init__(num_classes, seed)
        self.height, self.width, self.channels = height, width, channels
        self.learning_rate = learning_rate

    def conf(self):
        pool = lambda: Subsampling(pooling=PoolingType.MAX, kernel=(3, 3), stride=(2, 2))
        return (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(Adam(self.learning_rate))
            .weight_init(WeightInit.RELU)
            .activation(Activation.RELU)
            .list()
            .layer(Conv2D(name="c1", n_out=96, kernel=(11, 11), stride=(4, 4), padding="same"))
            .layer(LocalResponseNormalization(name="lrn1"))
            .layer(pool())
            .layer(Conv2D(name="c2", n_out=256, kernel=(5, 5), padding="same"))
            .layer(LocalResponseNormalization(name="lrn2"))
            .layer(pool())
            .layer(Conv2D(name="c3", n_out=384, kernel=(3, 3), padding="same"))
            .layer(Conv2D(name="c4", n_out=384, kernel=(3, 3), padding="same"))
            .layer(Conv2D(name="c5", n_out=256, kernel=(3, 3), padding="same"))
            .layer(pool())
            .layer(Dense(name="fc1", n_out=4096))
            .layer(Dropout(name="do1", rate=0.5))
            .layer(Dense(name="fc2", n_out=4096))
            .layer(Dropout(name="do2", rate=0.5))
            .layer(OutputLayer(name="output", n_out=self.num_classes,
                               loss=Loss.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.convolutional(self.height, self.width, self.channels))
            .build()
        )
