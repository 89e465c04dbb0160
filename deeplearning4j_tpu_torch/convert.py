"""Carry weights from the JAX package into the port, in memory.

Files go through the JAX package's checkpoint zip instead:
`train/checkpoint.py` `ModelSerializer` reads and writes it (the
configuration, the parameters, the optimizer state and the counters).

The JAX model's parameters are a nested dict keyed by layer name::

    {"layer0": {"W"},
     "layer2": {"attn": {"Wq", "Wk", "Wv", "Wo"}, "ln1": {"gamma", "beta"},
                "ln2": {...}, "W1", "b1", "W2", "b2"},
     "layer3": {"router", "Wi", "Wo"},              # MoELayer
     "layer10": {"W", "b"}}

(a `SelfAttentionLayer` holds ``Wq``, ``Wk``, ``Wv``, ``Wo`` at its top
level, none without ``project_input``; a `LearnedSelfAttentionLayer`
``Q``, ``Wk``, ``Wv``, ``Wo``; `GlobalPooling` nothing).  The long
tail's layers keep the JAX trees too: `SeparableConv2D` ``{"depthW"
(kh, kw, 1, C m), "pointW" (1, 1, C m, n_out), "b"}``, `Deconv2D` ``{"W"
(kh, kw, C, n_out), "b"}`` (HWIO, unflipped), `CenterLossOutputLayer`
``{"W", "b", "centers" (classes, n_in)}``, `AutoEncoder` ``{"W", "b",
"vb"}`` and `VariationalAutoencoder` ``{"enc": {"W0", "b0", ...},
"W_mu", "b_mu", "W_lv", "b_lv", "dec": {...}, "W_out", "b_out"}`` (with
``W_out_lv``, ``b_out_lv`` for a Gaussian reconstruction); the
parameterless ones (`LossLayer`, `ScaleShift`, `SpaceToDepth`,
`Upsampling2D`, `LocalResponseNormalization`, `Yolo2OutputLayer`) hold
nothing.  A `GraphModel`'s
tree is keyed by each node's ``param_key`` (its name unless shared), an
`AttentionVertex` holding ``Wq``, ``Wk``, ``Wv``, ``Wo``; its BatchNorm
state under the same keys.

`params_from_jax` loads such a tree (leaves as numpy arrays, e.g.
``jax.tree.map(np.asarray, model.params)`` on the JAX side) into a port
model (sequential or graph) built from the same configuration, and with ``net_state=`` the
JAX model's layer state too (BatchNorm's ``{"mean", "var"}`` under the
layer's name).  Layouts are kept as they are:
dense weights stay (n_in, n_out) and are applied as ``x @ W``.  The
model itself is needed because the tree does not say everything the
stack is (head count, causality, head type).  `params_to_numpy` is the
inverse: the port model's tree as numpy arrays, for comparing trees
after training on both sides.

Quantized trees carry across too.  On the JAX side a `QuantizedTensor`
is a pytree node, so ``jax.tree.map(np.asarray, qmodel.params)`` leaves
an object with numpy ``.q`` (int8) and ``.scale`` (f32) arrays;
`params_from_jax` installs those bit for bit, and `params_to_numpy`
hands a quantized leaf back as a `QuantizedTensor` of numpy arrays.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.model import Model, _tree_map
from deeplearning4j_tpu_torch.quant.qtensor import QuantizedTensor


def params_from_jax(tree: dict, model: Model,
                    net_state: dict | None = None) -> Model:
    """Install ``tree`` (and ``net_state``, when given) into ``model``,
    names and shapes checked, and return the model."""
    model.load_params(tree)
    if net_state is not None:
        model.load_net_state(net_state)
    return model


def net_state_to_numpy(model: Model) -> dict:
    """The model's layer state as numpy arrays (copies, on the host)."""
    return _tree_map(lambda t: t.detach().cpu().numpy().copy(), model.net_state)


def params_to_numpy(model: Model) -> dict:
    """The model's parameter tree as numpy arrays (copies, on the host),
    keyed as the JAX package keys it; a quantized leaf becomes a
    `QuantizedTensor` of its numpy ``q`` and ``scale``."""
    def host(t):
        return t.detach().cpu().numpy().copy()

    return _tree_map(
        lambda t: QuantizedTensor(host(t.q), host(t.scale))
        if isinstance(t, QuantizedTensor) else host(t), model.params)
