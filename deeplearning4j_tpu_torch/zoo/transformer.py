"""TransformerEncoder — the zoo's causal LM, as in
`deeplearning4j_tpu/zoo/transformer.py`: token embedding + sinusoidal
positions + N pre-LN encoder blocks (each followed by a `MoELayer` when
``moe_experts`` > 0) + a per-token vocab head."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.attention import (
    PositionalEncoding,
    TransformerEncoderBlock,
)
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.moe import MoELayer
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ChunkedSoftmaxOutputLayer,
    Embedding,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.recurrent import RnnOutputLayer
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel


class TransformerEncoder(ZooModel):
    NAME = "transformer_encoder"

    def __init__(
        self,
        vocab_size: int = 1000,
        d_model: int = 128,
        n_heads: int = 4,
        n_layers: int = 2,
        d_ff: int = 0,
        causal: bool = True,
        seq_parallel: str = "none",
        seed: int = 123,
        learning_rate: float = 3e-4,
        moe_experts: int = 0,
        moe_top_k: int = 2,
        chunked_vocab_loss: bool = False,
        vocab_chunk: int = 8192,
        bf16_compute=None,
    ):
        super().__init__(vocab_size, seed)
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.d_ff = d_ff
        self.causal = causal
        self.seq_parallel = seq_parallel
        self.seed = seed
        self.learning_rate = learning_rate
        self.moe_experts = moe_experts
        self.moe_top_k = moe_top_k
        self.chunked_vocab_loss = chunked_vocab_loss
        self.vocab_chunk = vocab_chunk
        self.bf16_compute = bf16_compute

    def conf(self):
        b = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(Adam(self.learning_rate))
            .weight_init(WeightInit.XAVIER)
            .bf16_compute(self.bf16_compute)
            .list()
            .layer(Embedding(n_in=self.vocab_size, n_out=self.d_model))
            .layer(PositionalEncoding())
        )
        for _ in range(self.n_layers):
            b.layer(TransformerEncoderBlock(
                d_model=self.d_model, n_heads=self.n_heads, d_ff=self.d_ff,
                causal=self.causal, seq_parallel=self.seq_parallel))
            if self.moe_experts > 0:
                b.layer(MoELayer(n_out=self.d_model, n_experts=self.moe_experts,
                                 top_k=self.moe_top_k))
        if self.chunked_vocab_loss:
            head = ChunkedSoftmaxOutputLayer(n_out=self.vocab_size,
                                             chunk=self.vocab_chunk)
        else:
            head = RnnOutputLayer(n_out=self.vocab_size, loss=Loss.MCXENT,
                                  activation=Activation.SOFTMAX)
        return b.layer(head).set_input_type(InputType.recurrent(1)).build()
