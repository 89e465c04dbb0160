"""TextGenerationLSTM — `deeplearning4j_tpu/zoo/textgen.py`, the
reference zoo's char-RNN (BASELINE config 3): one-hot characters, two
`GravesLSTM` layers and a per-timestep softmax, trained by truncated
BPTT in windows of ``tbptt_length`` steps (0: whole sequences)."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.recurrent import GravesLSTM, RnnOutputLayer
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel


class TextGenerationLSTM(ZooModel):
    NAME = "textgenlstm"

    def __init__(self, vocab_size: int = 77, hidden: int = 200, seed: int = 123,
                 learning_rate: float = 1e-2, tbptt_length: int = 50):
        super().__init__(vocab_size, seed)
        self.vocab_size = vocab_size
        self.hidden = hidden
        self.learning_rate = learning_rate
        self.tbptt_length = tbptt_length

    def conf(self):
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(Adam(self.learning_rate))
             .weight_init(WeightInit.XAVIER)
             .list()
             .layer(GravesLSTM(n_out=self.hidden, activation=Activation.TANH))
             .layer(GravesLSTM(n_out=self.hidden, activation=Activation.TANH))
             .layer(RnnOutputLayer(n_out=self.vocab_size, loss=Loss.MCXENT,
                                   activation=Activation.SOFTMAX))
             .set_input_type(InputType.recurrent(self.vocab_size)))
        if self.tbptt_length:
            b.tbptt(self.tbptt_length)
        return b.build()
