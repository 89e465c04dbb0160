"""`MoELayer` — the Mixture-of-Experts FFN of `deeplearning4j_tpu/nn/conf/moe.py`
over `parallel/expert.py`.

The layer is FFN-shaped, (B, T, D) -> (B, T, D), with the residual
``x + MoE(x)`` by default.  In training its state carries the weighted
load-balancing loss under `models._common.AUX_LOSS_KEY`; the training
step adds it to the objective and never keeps it in ``net_state``.  Its
weights stay f32 in a bf16 model (``F32_PARAMS``): the JAX layer runs the
router and the experts in f32.
"""

from __future__ import annotations

import dataclasses

from deeplearning4j_tpu_torch.models._common import AUX_LOSS_KEY
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import LayerConfig
from deeplearning4j_tpu_torch.parallel.expert import MoEConfig, init_moe, moe_apply
from deeplearning4j_tpu_torch.utils import serde


@serde.register
@dataclasses.dataclass(frozen=True)
class MoELayer(LayerConfig):
    """Capacity-bounded top-k MoE FFN over a sequence.  ``n_out`` is
    d_model and must equal the input's feature size."""

    n_out: int = 0
    n_experts: int = 8
    d_hidden: int = 0                    # default 4 * n_out
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    residual: bool = True                # x + MoE(x)

    EXPECTS = "rnn"
    REGULARIZED = ()
    F32_PARAMS = True

    def _cfg(self) -> MoEConfig:
        return MoEConfig(
            n_experts=self.n_experts, d_model=self.n_out,
            d_hidden=self.d_hidden if self.d_hidden > 0 else 4 * self.n_out,
            top_k=self.top_k, capacity_factor=self.capacity_factor)

    def output_type(self, itype):
        if itype.kind != InputType.KIND_RNN:
            raise ValueError(f"MoELayer expects sequence input, got {itype}")
        if itype.size != self.n_out:
            raise ValueError(
                f"MoELayer n_out={self.n_out} must equal the input feature "
                f"size {itype.size} (FFN-shaped layer)")
        return InputType.recurrent(self.n_out, itype.shape[0])

    def init(self, key, itype, device):
        return init_moe(key, self._cfg(), device), {}

    def apply(self, params, state, x, *, training=False, rng=None):
        y, aux = moe_apply(params, x, self._cfg())
        if self.residual:
            y = x + y
        ns = {}
        if training and self.aux_loss_weight:
            ns[AUX_LOSS_KEY] = (self.aux_loss_weight * aux).float()
        return y, ns
