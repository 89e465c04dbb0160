"""Training-step pieces of `deeplearning4j_tpu/models/_common.py`: the
output-layer loss resolution, auxiliary-loss extraction and the l1 / l2
penalty."""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.conf.recurrent import CANONICAL_ACTIVATION
from deeplearning4j_tpu_torch.nn.losses import FUSED_ACTIVATION_LOSSES

#: the key under which a layer's state carries an auxiliary loss
AUX_LOSS_KEY = "__aux_loss__"


def resolve_output_spec(layer) -> str:
    """The loss an output layer trains with.  Only the fused path is
    ported: the loss runs on logits through a numerically stable
    log-softmax because the declared activation IS the loss's canonical
    one (softmax for mcxent)."""
    loss = getattr(layer, "loss", None)
    if (loss not in FUSED_ACTIVATION_LOSSES
            or layer.output_activation() != CANONICAL_ACTIVATION[loss]):
        raise NotImplementedError(
            f"output layer {layer.name!r}: only a {FUSED_ACTIVATION_LOSSES} "
            "loss with its canonical activation is ported (ROADMAP A2: "
            "nn/losses.py)")
    return loss


def pop_aux_losses(new_state: dict):
    """Split layer-emitted auxiliary losses out of a state tree: returns
    (aux_total, cleaned_state).  Aux entries feed the objective, never the
    carried state.  No ported layer emits one yet (the MoE layer, which
    does, is not ported), so the training step does not call this."""
    total = 0.0
    cleaned = {}
    for lname, ls in new_state.items():
        if AUX_LOSS_KEY in ls:
            total = total + ls[AUX_LOSS_KEY]
            ls = {k: v for k, v in ls.items() if k != AUX_LOSS_KEY}
        if ls:
            cleaned[lname] = ls
    return total, cleaned


def regularization_loss(params: dict, named_layers):
    """Sum of per-layer l1 * |W| + 0.5 * l2 * W^2 penalties over the
    regularized parameters, in f32: a 0-dim tensor, or 0.0 when no layer
    has a penalty.  named_layers: iterable of (name, LayerConfig)."""
    reg = 0.0
    for name, layer in named_layers:
        lp = params.get(name)
        if not lp:
            continue
        for l1, l2, w in layer.regularization_terms(lp):
            w = w.float()
            if l1:
                reg = reg + l1 * w.abs().sum()
            if l2:
                reg = reg + 0.5 * l2 * (w * w).sum()
    return reg
