"""`RnnOutputLayer` — the per-timestep dense head of
`deeplearning4j_tpu/nn/conf/recurrent.py`.  The recurrent layers
themselves are a later slice (ROADMAP A8)."""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import LayerConfig, _dense, _dense_init, _dropout
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.utils import serde

#: output activation a loss implies when the layer declares none
CANONICAL_ACTIVATION = {
    Loss.MCXENT: Activation.SOFTMAX,
    Loss.NEGATIVELOGLIKELIHOOD: Activation.SOFTMAX,
    Loss.SPARSE_MCXENT: Activation.SOFTMAX,
    Loss.XENT: Activation.SIGMOID,
}


@serde.register
@dataclasses.dataclass(frozen=True)
class RnnOutputLayer(LayerConfig):
    """(B, T, H) -> (B, T, n_out) logits; ``output()`` applies the
    activation the loss implies (softmax for ``mcxent``)."""

    n_out: int = 0
    loss: Loss = Loss.MCXENT
    has_bias: bool = True

    EXPECTS = "rnn"

    def output_type(self, itype):
        return InputType.recurrent(self.n_out, itype.shape[0])

    def init(self, key, itype, device):
        return _dense_init(self, key, itype.size, device), {}

    def apply(self, params, state, x, *, training=False, rng=None):
        x = _dropout(x, self.dropout_rate or 0.0, training, rng)
        return self.logits(params, x), state

    def logits(self, params, x):
        return _dense(self, params, x)
