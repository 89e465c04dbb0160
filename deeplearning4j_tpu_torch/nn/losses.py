"""Loss functions — `deeplearning4j_tpu/nn/losses.py`: every member of
`Loss`, with its aliases, in PyTorch.

Predictions enter pre-activation for the fused softmax / sigmoid losses
(MCXENT, NLL, SPARSE_MCXENT, XENT) when ``from_logits`` is set: the
output layer declares its activation and the loss fuses it.  Every other
loss receives activated predictions.  A mask multiplies the per-example
losses (``preds.shape[:-1]``) before the mean over unmasked elements.
"""

from __future__ import annotations

import enum

import torch

from deeplearning4j_tpu_torch.parallel import context as dp_context


class Loss(str, enum.Enum):
    MCXENT = "mcxent"                    # softmax cross-entropy, int or one-hot labels
    NEGATIVELOGLIKELIHOOD = "nll"        # alias of MCXENT in the reference
    XENT = "xent"                        # sigmoid binary cross-entropy
    MSE = "mse"
    MAE = "l1"
    L2 = "l2"                            # sum of squares (no 1/n)
    SPARSE_MCXENT = "sparse_mcxent"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    HUBER = "huber"
    POISSON = "poisson"
    COSINE_PROXIMITY = "cosine_proximity"
    KL_DIVERGENCE = "kld"
    MAPE = "mape"                        # mean absolute percentage error
    MSLE = "msle"                        # mean squared logarithmic error
    WASSERSTEIN = "wasserstein"          # critic loss (labels +-1)
    RECONSTRUCTION_CROSSENTROPY = "reconstruction_xent"

    def __call__(self, preds, labels, mask=None):
        return compute(self, preds, labels, mask)


# spellings accepted beyond value / NAME, as in the JAX package
Loss._ALIASES_ = {
    "categorical_crossentropy": "mcxent",
    "softmax_cross_entropy": "mcxent",
    "sparse_categorical_crossentropy": "sparse_mcxent",
    "binary_crossentropy": "xent",
    "negativeloglikelihood": "nll",
    "mean_squared_error": "mse",
    "mean_absolute_error": "l1",
    "mae": "l1",
    "kl_divergence": "kld",
    "kullback_leibler_divergence": "kld",
    "mean_absolute_percentage_error": "mape",
    "mean_squared_logarithmic_error": "msle",
}

#: losses whose canonical activation the loss fuses
FUSED_ACTIVATION_LOSSES = (Loss.MCXENT, Loss.NEGATIVELOGLIKELIHOOD,
                           Loss.SPARSE_MCXENT, Loss.XENT)


def _masked_mean(per_elem: torch.Tensor, mask) -> torch.Tensor:
    """The mean of the kept entries.  Under data parallelism
    (`parallel/context.py`) a rank's share of the global mean: its mean
    over 1 / n, or its masked sum over the global count of kept
    entries, so the ranks' shares sum to the JAX package's global mean."""
    if mask is None:
        mean = per_elem.mean()
        scale = dp_context.loss_scale()
        return mean if scale is None else mean * scale
    mask = torch.broadcast_to(torch.as_tensor(mask, device=per_elem.device),
                              per_elem.shape).to(per_elem.dtype)
    return (per_elem * mask).sum() / torch.clamp(
        dp_context.global_count(mask.sum()), min=1.0)


def _bce(p, labels):
    p = torch.clamp(p, 1e-7, 1 - 1e-7)
    return -(labels * torch.log(p) + (1 - labels) * torch.log1p(-p))


def compute(loss: Loss, preds: torch.Tensor, labels: torch.Tensor, mask=None,
            from_logits: bool = True) -> torch.Tensor:
    """Scalar loss.  For the softmax / sigmoid family ``preds`` are
    logits when ``from_logits`` (the fused path), else probabilities;
    labels are int class ids (...,) or one-hot / soft (..., C)."""
    loss = Loss(loss)
    preds = preds.float()
    if loss in (Loss.MCXENT, Loss.NEGATIVELOGLIKELIHOOD, Loss.SPARSE_MCXENT):
        if from_logits:
            logp = torch.log_softmax(preds, dim=-1)
        else:
            logp = torch.log(torch.clamp_min(preds, 1e-12))
        if labels.dim() == preds.dim() - 1 or loss is Loss.SPARSE_MCXENT:
            ids = labels.long()
            if ids.dim() == preds.dim():                 # one-hot passed to sparse
                ids = ids.argmax(dim=-1)
            nll = -logp.gather(-1, ids[..., None])[..., 0]
        else:
            nll = -(labels.float() * logp).sum(dim=-1)
        return _masked_mean(nll, mask)
    labels = labels.float()
    if loss is Loss.XENT:
        if from_logits:
            per = (torch.clamp_min(preds, 0) - preds * labels
                   + torch.log1p(torch.exp(-preds.abs())))
        else:
            per = _bce(preds, labels)
        return _masked_mean(per.sum(dim=-1), mask)
    if loss is Loss.MSE:
        per = ((preds - labels) ** 2).mean(dim=-1)
    elif loss is Loss.MAE:
        per = (preds - labels).abs().mean(dim=-1)
    elif loss is Loss.L2:
        per = ((preds - labels) ** 2).sum(dim=-1)
    elif loss in (Loss.HINGE, Loss.SQUARED_HINGE):
        y = torch.where(labels > 0, 1.0, -1.0)
        margin = torch.clamp_min(1.0 - y * preds, 0.0)
        per = (margin if loss is Loss.HINGE else margin ** 2).mean(dim=-1)
    elif loss is Loss.HUBER:
        d = preds - labels
        a = d.abs()
        per = torch.where(a <= 1.0, 0.5 * d * d, a - 0.5).mean(dim=-1)
    elif loss is Loss.POISSON:
        per = (preds - labels * torch.log(torch.clamp_min(preds, 1e-12))).mean(dim=-1)
    elif loss is Loss.COSINE_PROXIMITY:
        pn = preds / torch.clamp_min(torch.linalg.vector_norm(
            preds, dim=-1, keepdim=True), 1e-12)
        ln = labels / torch.clamp_min(torch.linalg.vector_norm(
            labels, dim=-1, keepdim=True), 1e-12)
        per = -(pn * ln).sum(dim=-1)
    elif loss is Loss.KL_DIVERGENCE:
        p = torch.clamp_min(labels, 1e-12)
        q = torch.clamp_min(preds, 1e-12)
        per = (p * (torch.log(p) - torch.log(q))).sum(dim=-1)
    elif loss is Loss.MAPE:
        per = (100.0 * ((labels - preds)
                        / torch.clamp_min(labels.abs(), 1e-7)).abs()).mean(dim=-1)
    elif loss is Loss.MSLE:
        per = ((torch.log1p(torch.clamp_min(labels, 0.0))
                - torch.log1p(torch.clamp_min(preds, 0.0))) ** 2).mean(dim=-1)
    elif loss is Loss.WASSERSTEIN:
        per = (-labels * preds).mean(dim=-1)
    elif loss is Loss.RECONSTRUCTION_CROSSENTROPY:
        per = _bce(preds, labels).sum(dim=-1)
    else:
        raise ValueError(f"unhandled loss {loss}")
    return _masked_mean(per, mask)
