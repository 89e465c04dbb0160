"""`RnnOutputLayer` — the per-timestep dense head of
`deeplearning4j_tpu/nn/conf/recurrent.py`.  The recurrent layers
themselves are a later slice (ROADMAP A8)."""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.layers import LayerConfig, _dropout
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.quant import functional as quantf
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

    def output_size(self, n_in: int) -> int:
        return self.n_out

    def init(self, key, n_in, device):
        p = {"W": self._winit().init(key, (n_in, self.n_out), fan_in=n_in,
                                     fan_out=self.n_out, device=device)}
        if self.has_bias:
            p["b"] = torch.zeros(self.n_out, device=device)
        return p

    def apply(self, params, x, *, training=False, rng=None):
        x = _dropout(x, self.dropout_rate or 0.0, training, rng)
        return self.logits(params, x)

    def logits(self, params, x):
        y = quantf.matmul(x, params["W"])
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return y

    def output_activation(self) -> Activation:
        if self.activation is not None:
            return self.activation
        return CANONICAL_ACTIVATION.get(self.loss, Activation.IDENTITY)
