"""Training-step pieces of `deeplearning4j_tpu/models/_common.py`: the
output-layer loss resolution, auxiliary-loss extraction and the l1 / l2
penalty."""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.recurrent import CANONICAL_ACTIVATION
from deeplearning4j_tpu_torch.nn.losses import FUSED_ACTIVATION_LOSSES

#: the key under which a layer's state carries an auxiliary loss
AUX_LOSS_KEY = "__aux_loss__"


def resolve_output_spec(layer):
    """(loss, output activation, fused) of an output layer.  Fused: the
    declared activation is the loss's canonical one, so the loss runs on
    logits through a stable log-softmax / log-sigmoid; otherwise the
    activation is applied first and the loss sees what ``output()``
    serves."""
    loss = getattr(layer, "loss", None)
    if loss is None:
        raise ValueError("the last layer must declare a loss (an output layer)")
    canonical = CANONICAL_ACTIVATION.get(loss, Activation.IDENTITY)
    act = layer.activation if layer.activation is not None else canonical
    return loss, act, loss in FUSED_ACTIVATION_LOSSES and act == canonical


def pop_aux_losses(new_state: dict):
    """Split layer-emitted auxiliary losses out of a state tree: returns
    (aux_total, cleaned_state).  Aux entries (the MoE layer's
    load-balancing loss) feed the objective, never the carried state:
    `SequentialModel._step_loss` adds the total to the data loss and the
    penalty, as the JAX package's ``_step_loss`` does."""
    total = 0.0
    cleaned = {}
    for lname, ls in new_state.items():
        if AUX_LOSS_KEY in ls:
            total = total + ls[AUX_LOSS_KEY]
            ls = {k: v for k, v in ls.items() if k != AUX_LOSS_KEY}
        if ls:
            cleaned[lname] = ls
    return total, cleaned


def regularization_loss(params: dict, named_layers, split_axes=None):
    """Sum of per-layer l1 * |W| + 0.5 * l2 * W^2 penalties over the
    regularized parameters, in f32: a 0-dim tensor, or 0.0 when no layer
    has a penalty.  named_layers: iterable of (name, LayerConfig).
    ``split_axes``: {id of a leaf: the mesh axis that splits it}; such a
    leaf's terms are summed over that axis (its gradient stays the
    rank's slice's)."""
    from deeplearning4j_tpu_torch.parallel import collectives

    reg = 0.0
    for name, layer in named_layers:
        lp = params.get(name)
        if not lp:
            continue
        for l1, l2, w in layer.regularization_terms(lp):
            axis = (split_axes or {}).get(id(w))
            w = w.float()
            term = 0.0
            if l1:
                term = term + l1 * w.abs().sum()
            if l2:
                term = term + 0.5 * l2 * (w * w).sum()
            if axis is not None and isinstance(term, torch.Tensor):
                term = collectives.reduce_from(term, axis)
            reg = reg + term
    return reg
