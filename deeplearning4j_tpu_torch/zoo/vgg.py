"""VGG16 / VGG19 — `deeplearning4j_tpu/zoo/vgg.py`, the reference zoo's
VGG16/VGG19 (sequential stacks)."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
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
from deeplearning4j_tpu_torch.nn.updaters import Nesterovs
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel

_VGG16_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_VGG19_BLOCKS = ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4))


class VGG16(ZooModel):
    NAME = "vgg16"
    BLOCKS = _VGG16_BLOCKS

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3,
                 learning_rate: float = 1e-2, fc_width: int = 4096):
        super().__init__(num_classes, seed)
        self.height, self.width, self.channels = height, width, channels
        self.learning_rate = learning_rate
        self.fc_width = fc_width

    def conf(self):
        b = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(Nesterovs(learning_rate=self.learning_rate, momentum=0.9))
            .weight_init(WeightInit.RELU)
            .activation(Activation.RELU)
            .list()
        )
        for filters, reps in self.BLOCKS:
            for _ in range(reps):
                b.layer(Conv2D(n_out=filters, kernel=(3, 3), padding="same"))
            b.layer(Subsampling(pooling=PoolingType.MAX, kernel=(2, 2), stride=(2, 2)))
        b.layer(Dense(n_out=self.fc_width))
        b.layer(Dropout(rate=0.5))
        b.layer(Dense(n_out=self.fc_width))
        b.layer(Dropout(rate=0.5))
        b.layer(
            OutputLayer(n_out=self.num_classes, loss=Loss.MCXENT, activation=Activation.SOFTMAX)
        )
        b.set_input_type(InputType.convolutional(self.height, self.width, self.channels))
        return b.build()


class VGG19(VGG16):
    NAME = "vgg19"
    BLOCKS = _VGG19_BLOCKS
