"""Loss functions — the part of `deeplearning4j_tpu/nn/losses.py` an
`RnnOutputLayer` head with ``loss="mcxent"`` trains with: softmax
cross-entropy fused with its log-softmax on pre-activation logits, int or
one-hot labels, and the masked mean.  The other losses arrive with the
slices whose heads use them.
"""

from __future__ import annotations

import torch

MCXENT = "mcxent"
#: losses whose canonical activation the loss fuses (`FUSED_ACTIVATION_LOSSES`)
FUSED_ACTIVATION_LOSSES = ("mcxent", "negativeloglikelihood", "sparse_mcxent")


def _masked_mean(per_elem: torch.Tensor, mask) -> torch.Tensor:
    if mask is None:
        return per_elem.mean()
    mask = torch.broadcast_to(mask, per_elem.shape).to(per_elem.dtype)
    return (per_elem * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def compute(loss: str, preds: torch.Tensor, labels: torch.Tensor,
            mask=None) -> torch.Tensor:
    """Scalar loss of pre-activation logits ``preds`` (..., C).  Labels
    are int class ids (...,) or one-hot / soft (..., C); ``mask``
    broadcasts against the per-example loss (``preds.shape[:-1]``)."""
    if loss not in FUSED_ACTIVATION_LOSSES:
        raise NotImplementedError(
            f"loss {loss!r} is not ported yet (ROADMAP A2: nn/losses.py)")
    preds = preds.float()
    logp = torch.log_softmax(preds, dim=-1)
    if labels.dim() == preds.dim() - 1 or loss == "sparse_mcxent":
        ids = labels.long()
        if ids.dim() == preds.dim():                 # one-hot passed to sparse
            ids = ids.argmax(dim=-1)
        nll = -logp.gather(-1, ids[..., None])[..., 0]
    else:
        nll = -(labels.float() * logp).sum(dim=-1)
    return _masked_mean(nll, mask)
