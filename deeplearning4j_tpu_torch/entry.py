"""The port's entry point — the counterpart of the repo's
``__graft_entry__.entry()``: the forward step of the flagship model
(LeNet) and example arguments for it.

    forward, (params, net_state, x) = entry()          # on the card
    logits = forward(params, net_state, x)             # (8, 10)

``forward`` returns what the JAX forward returns: the OutputLayer's
pre-activation logits of the (8, 28, 28, 1) input, f32 on the CPU and
the compute dtype (bf16) on the card.  ``device="cpu"`` builds on the
CPU; the default is CUDA.
"""

from __future__ import annotations

import torch


def entry(device=None):
    """Returns (forward, (params, net_state, x)): LeNet (seed 123) on
    ``device``, its compute-dtype parameters, its layer state and an
    (8, 28, 28, 1) f32 batch of zeros."""
    from deeplearning4j_tpu_torch.zoo.lenet import LeNet

    model = LeNet().init_model(device=device)
    x = torch.zeros((8, 28, 28, 1), dtype=torch.float32, device=model.device)

    @torch.no_grad()
    def forward(params, net_state, features):
        out, _ = model._forward(params, net_state, features, training=False)
        return out

    return forward, (model.compute_params(), model.net_state, x)
