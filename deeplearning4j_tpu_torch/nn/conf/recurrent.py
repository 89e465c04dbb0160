"""`RnnOutputLayer` — the per-timestep dense head of
`deeplearning4j_tpu/nn/conf/recurrent.py`.  The recurrent layers
themselves are a later slice."""

from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.layers import LayerConfig, init_weight
from deeplearning4j_tpu_torch.quant import functional as quantf

#: output activation a loss implies when the layer declares none
CANONICAL_ACTIVATION = {
    "mcxent": Activation.SOFTMAX,
    "negativeloglikelihood": Activation.SOFTMAX,
    "sparse_mcxent": Activation.SOFTMAX,
}


@dataclasses.dataclass(frozen=True)
class RnnOutputLayer(LayerConfig):
    """(B, T, H) -> (B, T, n_out) logits; ``output()`` applies the
    activation the loss implies (softmax for ``mcxent``)."""

    n_out: int = 0
    loss: str = "mcxent"
    has_bias: bool = True

    def output_size(self, n_in: int) -> int:
        return self.n_out

    def init(self, gen, n_in, device):
        p = {"W": init_weight(gen, (n_in, self.n_out), n_in, self.n_out,
                              self._winit(), device)}
        if self.has_bias:
            p["b"] = torch.zeros(self.n_out, device=device)
        return p

    def apply(self, params, x):
        y = quantf.matmul(x, params["W"])
        if self.has_bias:
            y = y + params["b"].to(x.dtype)
        return y

    logits = apply

    def output_activation(self) -> Activation:
        if self.activation is not None:
            return self.activation
        return CANONICAL_ACTIVATION.get(self.loss, Activation.IDENTITY)
