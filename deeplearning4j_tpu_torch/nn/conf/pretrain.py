"""Unsupervised-pretraining layers — `deeplearning4j_tpu/nn/conf/pretrain.py`:
`AutoEncoder` and `VariationalAutoencoder`.

A pretrainable layer (``PRETRAINABLE``) adds one function to the layer
triple, ``pretrain_loss(params, x, key) -> scalar``; the models'
``pretrain_layer`` runs the prefix in inference mode, differentiates this
loss for the layer's own parameters and steps the updater on them
(`models/sequential.py`, `models/computation_graph.py`).  The supervised
``apply`` is the encoder alone, so a pretrained stack goes straight on
to fine-tuning.  The random bits are the JAX package's: the corruption
mask is ``bernoulli(key, 1 - corruption_level)`` and sample s of the
reparameterisation noise ``normal(fold_in(key, s))`` (`runtime/rng.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    LayerConfig,
    _coerce_enum,
    _dropout,
    split_region,
)
from deeplearning4j_tpu_torch.nn.losses import Loss, compute as compute_loss
from deeplearning4j_tpu_torch.runtime import rng as rng_mod
from deeplearning4j_tpu_torch.utils import serde

# log(2 pi) in f32, as jnp.log takes it
_LOG_2PI = float(np.log(np.float32(2 * np.pi)))


@serde.register
@dataclasses.dataclass(frozen=True)
class AutoEncoder(LayerConfig):
    """Denoising autoencoder with tied decoder weights.

    The supervised forward is the encoder, ``act(x W + b)`` (sigmoid by
    default).  `pretrain_loss` zeroes each input with probability
    ``corruption_level``, encodes, decodes through ``W``'s transpose
    plus the visible bias ``vb`` and scores the reconstruction with
    ``loss`` (cross-entropy on logits for XENT and
    RECONSTRUCTION_CROSSENTROPY); a KL penalty pulls the mean hidden
    activation toward ``sparsity`` when ``sparsity_beta`` is set.
    """

    n_out: int = 0
    corruption_level: float = 0.3
    sparsity: float = 0.0
    sparsity_beta: float = 0.0
    loss: Loss = Loss.MSE

    EXPECTS = "ff"
    PRETRAINABLE = True

    def output_type(self, itype):
        return InputType.feed_forward(self.n_out)

    def init(self, key, itype, device):
        n_in = itype.size
        (kw,) = rng_mod.split(key, 1)
        return {"W": self._winit().init(kw, (n_in, self.n_out), fan_in=n_in,
                                        fan_out=self.n_out, device=device),
                "b": torch.zeros(self.n_out, device=device),
                "vb": torch.zeros(n_in, device=device)}, {}

    def apply(self, params, state, x, *, training=False, rng=None):
        x = _dropout(x, self.dropout_rate or 0.0, training, rng)
        y = split_region(self, params, x, lambda x: x @ params["W"].to(x.dtype)
                         + params["b"].to(x.dtype))
        return self._act(Activation.SIGMOID)(y), state

    def _decode(self, params, h):
        """The tied decoder: ``h W^T + vb``."""
        return h @ params["W"].to(h.dtype).T + params["vb"].to(h.dtype)

    def _encode_f32(self, params, x):
        return self._act(Activation.SIGMOID)(x @ params["W"] + params["b"])

    def pretrain_loss(self, params, x, key) -> torch.Tensor:
        x = x.float()
        if self.corruption_level > 0.0 and key is not None:
            keep = rng_mod.bernoulli(key, 1.0 - self.corruption_level, tuple(x.shape),
                                     device=x.device)
            x_in = torch.where(keep, x, 0.0)
        else:
            x_in = x
        h = self._encode_f32(params, x_in)
        recon = self._decode(params, h)
        if self.loss in (Loss.XENT, Loss.RECONSTRUCTION_CROSSENTROPY):
            loss = compute_loss(Loss.XENT, recon, x, None, from_logits=True)
        else:
            loss = compute_loss(self.loss, recon, x, None, from_logits=False)
        if self.sparsity_beta > 0.0:
            rho = self.sparsity
            rho_hat = torch.clamp(h.mean(dim=0), 1e-6, 1 - 1e-6)
            kl = (rho * torch.log(rho / rho_hat)
                  + (1 - rho) * torch.log((1 - rho) / (1 - rho_hat)))
            loss = loss + self.sparsity_beta * kl.sum()
        return loss

    def reconstruction_error(self, params, x) -> torch.Tensor:
        """Each example's reconstruction error (the reference's
        AutoEncoder score, anomaly detection)."""
        x = x.float()
        recon = self._decode(params, self._encode_f32(params, x))
        if self.loss in (Loss.XENT, Loss.RECONSTRUCTION_CROSSENTROPY):
            p = torch.sigmoid(recon)
            return -(x * torch.log(torch.clamp(p, 1e-7, 1.0))
                     + (1 - x) * torch.log(torch.clamp(1 - p, 1e-7, 1.0))).sum(dim=-1)
        return ((recon - x) ** 2).sum(dim=-1)


def _mlp_init(key, sizes, winit, device):
    params = {}
    keys = rng_mod.split(key, max(len(sizes) - 1, 1))
    for i in range(len(sizes) - 1):
        n_in, n_out = sizes[i], sizes[i + 1]
        params[f"W{i}"] = winit.init(keys[i], (n_in, n_out), fan_in=n_in, fan_out=n_out,
                                     device=device)
        params[f"b{i}"] = torch.zeros(n_out, device=device)
    return params


def _mlp_apply(params, x, act, n_layers):
    for i in range(n_layers):
        x = act(x @ params[f"W{i}"].to(x.dtype) + params[f"b{i}"].to(x.dtype))
    return x


def _affine(h, params, w, b):
    return h @ params[w].to(h.dtype) + params[b].to(h.dtype)


@serde.register
@dataclasses.dataclass(frozen=True)
class VariationalAutoencoder(LayerConfig):
    """Variational autoencoder pretrained on the ELBO.

    ``n_out`` is the latent size, ``encoder_layer_sizes`` and
    ``decoder_layer_sizes`` the hidden MLPs (their parameters nested
    under ``enc`` and ``dec``).  ``reconstruction_distribution`` is
    "gaussian" (a learned diagonal variance) or "bernoulli" (sigmoid
    logits); ``num_samples`` Monte-Carlo samples estimate the
    reconstruction term.  The supervised forward is the posterior mean
    through ``pzx_activation``.
    """

    n_out: int = 0
    encoder_layer_sizes: tuple = (100,)
    decoder_layer_sizes: tuple = (100,)
    reconstruction_distribution: str = "gaussian"
    num_samples: int = 1
    pzx_activation: Optional[Activation] = None

    EXPECTS = "ff"
    PRETRAINABLE = True
    REGULARIZED = ()

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "encoder_layer_sizes",
                           tuple(int(s) for s in self.encoder_layer_sizes))
        object.__setattr__(self, "decoder_layer_sizes",
                           tuple(int(s) for s in self.decoder_layer_sizes))
        if self.pzx_activation is not None:
            object.__setattr__(self, "pzx_activation",
                               _coerce_enum(self.pzx_activation, Activation))
        if self.reconstruction_distribution not in ("gaussian", "bernoulli"):
            raise ValueError(
                "reconstruction_distribution must be 'gaussian' or 'bernoulli', "
                f"got {self.reconstruction_distribution!r}")

    def output_type(self, itype):
        return InputType.feed_forward(self.n_out)

    def init(self, key, itype, device):
        n_in = itype.size
        winit = self._winit()
        k_enc, k_mu, k_lv, k_dec, k_out, k_out_lv = rng_mod.split(key, 6)
        enc_sizes = (n_in,) + self.encoder_layer_sizes
        dec_sizes = (self.n_out,) + self.decoder_layer_sizes
        e_last, d_last = enc_sizes[-1], dec_sizes[-1]
        params = {
            "enc": _mlp_init(k_enc, enc_sizes, winit, device),
            "W_mu": winit.init(k_mu, (e_last, self.n_out), device=device),
            "b_mu": torch.zeros(self.n_out, device=device),
            "W_lv": winit.init(k_lv, (e_last, self.n_out), device=device),
            "b_lv": torch.zeros(self.n_out, device=device),
            "dec": _mlp_init(k_dec, dec_sizes, winit, device),
            "W_out": winit.init(k_out, (d_last, n_in), device=device),
            "b_out": torch.zeros(n_in, device=device),
        }
        if self.reconstruction_distribution == "gaussian":
            params["W_out_lv"] = winit.init(k_out_lv, (d_last, n_in), device=device)
            params["b_out_lv"] = torch.zeros(n_in, device=device)
        return params, {}

    def _posterior(self, params, x):
        h = _mlp_apply(params["enc"], x, self._act(Activation.RELU),
                       len(self.encoder_layer_sizes))
        return _affine(h, params, "W_mu", "b_mu"), _affine(h, params, "W_lv", "b_lv")

    def _decode(self, params, z):
        h = _mlp_apply(params["dec"], z, self._act(Activation.RELU),
                       len(self.decoder_layer_sizes))
        out = _affine(h, params, "W_out", "b_out")
        if self.reconstruction_distribution == "gaussian":
            return out, _affine(h, params, "W_out_lv", "b_out_lv")
        return out, None

    def apply(self, params, state, x, *, training=False, rng=None):
        x = _dropout(x, self.dropout_rate or 0.0, training, rng)
        mu, _ = self._posterior(params, x)
        act = self.pzx_activation if self.pzx_activation is not None else Activation.IDENTITY
        return act(mu), state

    def _recon_log_prob(self, params, z, x):
        """log p(x | z) summed over the features, each example's."""
        mean, logvar = self._decode(params, z)
        if self.reconstruction_distribution == "bernoulli":
            return (x * F.logsigmoid(mean) + (1 - x) * F.logsigmoid(-mean)).sum(dim=-1)
        logvar = torch.clamp(logvar, -10.0, 10.0)
        return -0.5 * (logvar + _LOG_2PI + (x - mean) ** 2 / torch.exp(logvar)).sum(dim=-1)

    def _sample(self, mu, logvar, key, s):
        eps = rng_mod.normal(rng_mod.fold_in(key, s), tuple(mu.shape), device=mu.device)
        return mu + torch.exp(0.5 * logvar) * eps, eps

    def pretrain_loss(self, params, x, key) -> torch.Tensor:
        """The negative ELBO, averaged over the batch."""
        x = x.float()
        mu, logvar = self._posterior(params, x)
        logvar = torch.clamp(logvar, -10.0, 10.0)
        kl = -0.5 * (1 + logvar - mu ** 2 - torch.exp(logvar)).sum(dim=-1)
        n = max(self.num_samples, 1)
        recon = 0.0
        for s in range(n):
            z, _ = self._sample(mu, logvar, key, s)
            recon = recon + self._recon_log_prob(params, z, x)
        return (kl - recon / n).mean()

    def reconstruction_log_probability(self, params, x, key, num_samples=None):
        """An importance-sampled estimate of each example's log p(x)
        (VariationalAutoencoder.reconstructionLogProbability)."""
        x = torch.as_tensor(x, dtype=torch.float32)
        n = int(num_samples or self.num_samples or 1)
        mu, logvar = self._posterior(params, x)
        logvar = torch.clamp(logvar, -10.0, 10.0)
        ws = []
        for s in range(n):
            z, eps = self._sample(mu, logvar, key, s)
            log_pz = -0.5 * (z ** 2 + _LOG_2PI).sum(dim=-1)
            log_qzx = -0.5 * (logvar + _LOG_2PI + eps ** 2).sum(dim=-1)
            ws.append(self._recon_log_prob(params, z, x) + log_pz - log_qzx)
        return torch.logsumexp(torch.stack(ws), dim=0) - math.log(float(n))

    def generate(self, params, z):
        """Latents decoded to the data space (generateAtMeanGivenZ)."""
        mean, _ = self._decode(params, torch.as_tensor(z, dtype=torch.float32))
        if self.reconstruction_distribution == "bernoulli":
            return torch.sigmoid(mean)
        return mean
