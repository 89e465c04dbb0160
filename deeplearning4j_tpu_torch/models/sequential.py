"""`SequentialModel` — `deeplearning4j_tpu/models/sequential.py`: the
layer stack, its inference (``output``, ``predict``, ``evaluate``) and
training (``fit``, ``fit_batch``).

The model is an `nn.Module` on one explicit device.  Its parameters keep
the JAX package's tree: ``model.params["layer2"]["attn"]["Wq"]`` is the
same (n_in, n_out) array there and here, so weights carry across by
layer name (`convert.params_from_jax`).  They are f32 master weights.
``net_state`` is the JAX package's tree of what is not trained
(BatchNorm's running mean and variance), f32.  The compute dtype (bf16
on CUDA, f32 on the CPU, or ``conf.bf16_compute``) applies to a cast of
the tree: for inference a detached copy made once and cached
(`compute_params`); for training a cast inside the autograd graph at
every step, so the gradients land on the f32 masters.  Network inputs
take the compute dtype on the device (`_cast.entry_cast`: float and
uint8 image bytes; integer ids pass through), and a feed-forward layer
after convolutional maps sees them flattened in NHWC order
(``conf.flatten_flags()``), the JAX package's row order of Dense ``W``.

A quantized model (`quant.quantize`, or `load_params` of a tree with
`QuantizedTensor` leaves) holds each int8 weight and its f32 scales as
buffers and computes in f32, whatever the bf16 setting says: that is
what the JAX package computes, since its quantized layers return f32
and every later layer follows ``x.dtype``.  It takes no training step.
``output()`` runs as a program registered with the cost registry under
the JAX package's key (``("infer", masked)``, plus ``"int8"`` for a
quantized model), and a quantized site counts its implementation once a
program signature (`program_run`, `ops/dequant_matmul.py`).

Masks.  A (B, T) features mask (1 on real steps) reaches every layer
with ``ACCEPTS_MASK`` (attention keys, `GlobalPooling`) until the time
axis collapses, in ``output``, ``score``, ``evaluate``, ``predict``,
``feed_forward`` and training, as in the JAX package.

A training step is the JAX step written out: forward, data loss (the
output layer's own loss, or a loss of `nn/losses.py`), plus the l1 / l2
penalty, backward, clipping and the updater (`nn/updaters.py`, optax's
arithmetic), applied in place, and the layers' new state written over
the old.  The model base (`models/model.py`) runs it: eagerly on the
CPU, and on CUDA as one CUDA graph for each batch signature, grouped
K steps at a time by ``fit(..., steps_per_execution=K)``.  Whatever
changes between steps is a device input the host refills before each
replay, never a value baked in at capture: the batch, the layers'
dropout keys (drawn on the host from the step counter), and the
updater's step values (the learning rate and Adam's bias corrections,
`nn/updaters.py` ``values``), whose counts advance on the host.

Random bits follow the JAX package's `SeedStream` (`runtime/rng.py`):
layer ``name`` initialises from ``stream.key("init/<name>")``, and step
``i`` drops out with ``fold_in(fold(root, i), layer index)``, so a seed
gives the JAX package's weights and masks.  The parameter list the
updater sees is in ``jax.tree.leaves`` order (dict keys sorted at every
level), the order of the optax state's leaves in a checkpoint.
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import (
    DataSetIterator,
    ExistingDataSetIterator,
    NumpyDataSetIterator,
)
from deeplearning4j_tpu_torch.models._cast import entry_cast
from deeplearning4j_tpu_torch.models._common import (
    pop_aux_losses,
    regularization_loss,
    resolve_output_spec,
)
# tree_leaves lives in the model base; importers of this module find it
# here too
from deeplearning4j_tpu_torch.models.model import (  # noqa: F401
    Model,
    as_tensor,
    tree_leaves,
)
from deeplearning4j_tpu_torch.nn import losses
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.updaters import with_gradient_clipping
from deeplearning4j_tpu_torch.runtime import rng
from deeplearning4j_tpu_torch.runtime.backend import backend, resolve_device


def _as_iterator(data, batch_size: int | None) -> DataSetIterator:
    if isinstance(data, DataSetIterator):
        return data
    if isinstance(data, DataSet):
        if batch_size:
            return ExistingDataSetIterator(data.split_batches(batch_size))
        return ExistingDataSetIterator([data])
    if isinstance(data, tuple) and len(data) == 2:
        return NumpyDataSetIterator(data[0], data[1], batch_size or 32)
    if isinstance(data, list) and data and all(
            isinstance(b, DataSet) for b in data):
        # non-empty only: fit([]) stays a loud error, not zero-batch training
        return ExistingDataSetIterator(data)
    raise TypeError(f"cannot interpret {type(data)} as training data")


class SequentialModel(Model):
    """Sequential layer stack on one device (``"cuda"`` by default)."""

    def __init__(self, conf, device=None):
        super().__init__()
        conf.check_supported()
        self.conf = conf
        self.device = resolve_device(device)
        self._bf16 = (conf.bf16_compute if conf.bf16_compute is not None
                      else backend(self.device).is_cuda)
        self._tx = with_gradient_clipping(
            conf.updater.to_tx(conf.steps_per_epoch), conf.gradient_clip_value,
            conf.gradient_clip_norm)
        self._stream = rng.SeedStream(conf.seed)
        self._itypes = self._flatten_before = None
        if conf.input_type is not None:
            self._itypes, self._flatten_before = conf._walk_types()
        # layers whose weights stay f32 in the compute tree (the MoE layer)
        self.f32_layers = frozenset(l.name for l in conf.layers if l.F32_PARAMS)
        # frozen layers take no update (JAX mask_frozen_tx)
        self._frozen = frozenset(l.name for l in conf.layers if l.frozen)

    def _types(self):
        if self._itypes is None:
            raise ValueError("configuration has no input_type; call set_input_type")
        return self._itypes

    @torch.no_grad()
    def init(self) -> "SequentialModel":
        """Random weights from ``conf.seed``, drawn on the model's device
        (the JAX package's, bit for bit), and the layers' initial state."""
        tree, state = {}, {}
        for layer, itype in zip(self.conf.layers, self._types()):
            p, s = layer.init(self._stream.key(f"init/{layer.name}"), itype,
                              self.device)
            if p:
                tree[layer.name] = p
            if s:
                state[layer.name] = s
        self._install(tree)
        self.net_state = state
        return self

    def _layer_keys(self, step: int) -> list:
        """The dropout keys of step ``step``: layer i's is
        ``fold_in(fold(root, step), i)``, as the JAX package folds them."""
        key = rng.SeedStream.fold(self._stream.root, step)
        return [rng.fold_in(key, i) for i in range(len(self.conf.layers))]

    def _layer_outputs(self, params: dict, net_state: dict, features, *,
                       training: bool = False, keys=None, fmask=None):
        """Run the stack, yielding (layer, output, new state) layer by
        layer.  Inputs take the compute dtype (`entry_cast`); a
        feed-forward layer after convolutional maps sees them flattened.
        The (B, T) features mask ``fmask`` reaches every layer with
        ``ACCEPTS_MASK`` until the time axis collapses (JAX
        ``_forward``).  In training, layer i draws its dropout from
        ``keys[i]`` (`_layer_keys`: two Python ints, or two device
        scalars)."""
        x = entry_cast(as_tensor(features, self.device), self.compute_dtype)
        mask = None if fmask is None else as_tensor(fmask, self.device)
        n = len(self.conf.layers)
        flatten = self._flatten_before or [False] * n
        itypes = self._itypes or [None] * n
        for i, layer in enumerate(self.conf.layers):
            if flatten[i]:
                x = x.reshape(x.shape[0], -1)
            kw = {"mask": mask} if layer.ACCEPTS_MASK else {}
            x, ns = layer.apply(params.get(layer.name, {}),
                                net_state.get(layer.name, {}), x,
                                training=training,
                                rng=keys[i] if keys is not None else None, **kw)
            yield layer, x, ns
            # once the time axis collapses (RNN -> FF), the mask is spent
            it = itypes[i]
            if (mask is not None and it is not None and it.kind == "rnn"
                    and layer.output_type(it).kind != "rnn"):
                mask = None

    def _forward(self, params: dict, net_state: dict, features, *,
                 training: bool = False, keys=None, fmask=None):
        """The layer stack on ``params`` (already in the compute dtype)
        and ``net_state``; returns (output, new state of the layers that
        have one).  See `_layer_outputs`."""
        x, new_state = None, {}
        for layer, x, ns in self._layer_outputs(params, net_state, features,
                                                training=training, keys=keys,
                                                fmask=fmask):
            if ns:
                new_state[layer.name] = ns
        return x, new_state

    def _out_activation(self) -> Activation:
        """What ``output()`` applies to the last layer's output: the
        output layer's activation (its loss's canonical one by default);
        nothing for a head that owns its loss."""
        last = self.conf.layers[-1]
        if hasattr(last, "compute_loss_with_params") or not hasattr(last, "loss"):
            return Activation.IDENTITY
        return resolve_output_spec(last)[1]

    @torch.no_grad()
    def output(self, features, features_mask=None, params: dict | None = None,
               net_state: dict | None = None) -> torch.Tensor:
        """Forward pass with the output activation applied, in f32
        (reference `MultiLayerNetwork.output()`): class probabilities for
        an output layer with a softmax, hidden states for a
        `ChunkedSoftmaxOutputLayer` head (its projection lives in the
        loss).  ``features_mask``: the (B, T) keep-mask of a padded
        batch (1 on real steps), seen by every mask-aware layer.
        ``params``: a `compute_params()` tree to run on instead of the
        current one (a server's snapshot, taken under its weights lock);
        ``net_state`` likewise (the model's by default)."""
        if self.params is None:
            self.init()
        masked = features_mask is not None
        args = (params if params is not None else self.compute_params(),
                net_state if net_state is not None else self.net_state, features)
        return self._infer_program(masked)(*args, *((features_mask,) if masked else ()))

    def _infer_program(self, masked: bool = False):
        """`_infer`, registered with the cost registry on first use under
        the JAX package's key (``_get_infer_fn``: ``("infer", masked)``,
        plus ``"int8"`` for a quantized tree)."""
        key = ("infer", masked) + (("int8",) if self._quantized is not None else ())
        fn = self._step_fns.get(key)
        if fn is None:
            from deeplearning4j_tpu_torch.observe import cost

            fn = self._step_fns[key] = cost.register_step_program(
                self, key, self._infer)
        return fn

    def _infer(self, params: dict, net_state: dict, features,
               fmask=None) -> torch.Tensor:
        """The ``output()`` program: the stack on ``params`` (compute
        dtype) and the output activation, in f32.  Pure."""
        x = as_tensor(features, self.device)
        sig = (tuple(x.shape), x.dtype) + (
            () if fmask is None else (tuple(np.shape(fmask)),))
        with self.program_run("infer", *sig):
            x, _ = self._forward(params, net_state, x, fmask=fmask)
        return self._out_activation()(x.float())

    def predict(self, features, features_mask=None) -> np.ndarray:
        """Argmax class predictions (reference `predict()`)."""
        return self.output(features, features_mask).argmax(dim=-1).cpu().numpy()

    @torch.no_grad()
    def feed_forward(self, features, features_mask=None) -> list:
        """Every layer's activations (reference `feedForward()`), in the
        compute dtype; an inspection path."""
        return [x for _, x, _ in self._layer_outputs(
            self.compute_params(), self.net_state, features, fmask=features_mask)]

    def _data_loss(self, params: dict, out, labels, lmask):
        last = self.conf.layers[-1]
        labels = as_tensor(labels, self.device)
        if lmask is not None:
            lmask = as_tensor(lmask, self.device)
        if hasattr(last, "compute_loss_with_params"):
            return last.compute_loss_with_params(params.get(last.name, {}), out,
                                                 labels, lmask)
        loss, act, fused = resolve_output_spec(last)
        if not fused:
            out = act(out.float())
        return losses.compute(loss, out, labels, lmask, from_logits=fused)

    @torch.no_grad()
    def score(self, ds: DataSet) -> float:
        """Loss, penalty included, on a dataset, inference mode, nothing
        updated."""
        if self.params is None:
            self.init()
        out, _ = self._forward(self.compute_params(), self.net_state, ds.features,
                               fmask=ds.features_mask)
        loss = self._data_loss(self.params, out, ds.labels, ds.labels_mask)
        return float(loss + self._reg_loss(self.params))

    def evaluate(self, data, batch_size: int | None = None):
        """`Evaluation` of ``output()`` over ``data`` (reference
        `evaluate()`).  Integer class ids are told from one-hot labels by
        element count, one label per prediction position, as the chunked
        head's loss tells them apart."""
        from deeplearning4j_tpu_torch.evaluation.evaluation import Evaluation

        ev = Evaluation()
        last = self.conf.layers[-1]
        for batch in _as_iterator(data, batch_size):
            probs = self.output(batch.features, batch.features_mask)
            if hasattr(last, "evaluation_output"):
                # a head that owns its projection: its logits, not apply()'s
                probs = last.evaluation_output(
                    self.compute_params().get(last.name, {}), probs)
            parr = probs.float().cpu().numpy()
            labels = np.asarray(batch.labels)
            n_out = parr.shape[-1]
            if labels.ndim >= 1 and n_out > 1 and labels.size * n_out == parr.size:
                ids = labels.astype(np.int64)
                if ids.ndim == parr.ndim and ids.shape[-1] == 1:
                    ids = ids[..., 0]
                onehot = np.zeros(ids.shape + (n_out,), np.float32)
                np.put_along_axis(onehot, ids[..., None], 1.0, axis=-1)
                labels = onehot
            ev.eval(labels, parr, mask=batch.labels_mask)
        return ev

    def _check_trainable(self) -> None:
        last = self.conf.layers[-1]
        if not hasattr(last, "compute_loss_with_params"):
            resolve_output_spec(last)

    @staticmethod
    def _as_iterator(data, batch_size: int | None) -> DataSetIterator:
        return _as_iterator(data, batch_size)

    @staticmethod
    def _as_batch(batch: DataSet) -> DataSet:
        return batch

    @staticmethod
    def _batch_arrays(batch: DataSet) -> tuple:
        """The step's device inputs of ``batch``: features, labels and
        the labels and features masks (None where absent)."""
        return (batch.features, batch.labels, batch.labels_mask,
                batch.features_mask)

    def _reg_loss(self, params: dict):
        return regularization_loss(params,
                                   [(l.name, l) for l in self.conf.layers])

    def _step_loss(self, params: dict, net_state: dict, features, labels,
                   lmask=None, fmask=None, keys=None):
        """The step's objective (JAX ``_step_loss``): data loss + l1 / l2
        penalty + the layers' auxiliary losses, summed in that order
        (`_step_loss_parts`).  Returns (loss, the layers' new state)."""
        data, reg, aux, new_state = self._step_loss_parts(
            params, net_state, features, labels, lmask, fmask, keys)
        return data + reg + aux, new_state

    def _step_loss_parts(self, params: dict, net_state: dict, features, labels,
                         lmask=None, fmask=None, keys=None):
        """Forward, then the data loss, the l1 / l2 penalty and the layers'
        auxiliary losses apart, on the f32 master tree ``params``: the
        layers see it cast to the compute dtype inside the graph (but
        ``F32_PARAMS`` layers the masters); the output layer's own loss
        (the chunked head) and the penalty see the masters, as the JAX
        package's do.  Returns (data, penalty, aux, the layers' new state
        with the aux entries popped)."""
        out, new_state = self._forward(self.cast_tree(params, detach=False),
                                       net_state, features, training=True,
                                       keys=keys, fmask=fmask)
        data_loss = self._data_loss(params, out, labels, lmask)
        aux, new_state = pop_aux_losses(new_state)
        return data_loss, self._reg_loss(params), aux, new_state


