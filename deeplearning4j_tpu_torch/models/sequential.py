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
with ``ACCEPTS_MASK`` (attention keys, `GlobalPooling`, the recurrent
layers) until the time axis collapses, in ``output``, ``score``,
``evaluate``, ``predict``, ``feed_forward`` and training, as in the JAX
package.

Recurrent layers (`nn/conf/recurrent.py`).  A run of two or more
consecutive recurrent layers steps in one time loop (`_find_rnn_runs`,
`fused_rnn_scan`), exactly where the JAX package fuses: the fused and
layer-by-layer forms sum in different orders.  The forward takes
optional initial carries and returns the final ones, named by layer
(`_forward`).  Truncated BPTT (``conf.tbptt_length``, `_run_tbptt`)
splits a batch's time axis into windows, one optimizer step a window,
the carries flowing from window to window as values; on the card a
window is one replay of a captured step whose carries are static
inputs and outputs.  ``fit(..., steps_per_execution=K)`` runs K batches
as K x W window steps.  `rnn_time_step` streams inference, its carries
kept across calls; on the card each chunk signature is one graph.

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

import functools

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
    _Staged,
    as_tensor,
    tree_leaves,
)
from deeplearning4j_tpu_torch.nn import losses
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.recurrent import (
    Bidirectional,
    RecurrentLayerConfig,
    fused_rnn_scan,
)
from deeplearning4j_tpu_torch.nn.updaters import advance_counts, with_gradient_clipping
from deeplearning4j_tpu_torch.observe.trace import step_scope
from deeplearning4j_tpu_torch.parallel import context as dp_context
from deeplearning4j_tpu_torch.runtime import rng
from deeplearning4j_tpu_torch.runtime.backend import backend, resolve_device


def _time_block(t):
    """The rank's time block (dim 1) of ``t`` (None stays None)."""
    from deeplearning4j_tpu_torch.parallel import collectives

    return None if t is None else collectives.block(t, 1, "seq")


def _gather_time(t):
    """Every seq rank's time block of ``t`` concatenated (dim 1)."""
    from deeplearning4j_tpu_torch.parallel import collectives

    return collectives.gather(t, 1, "seq", grad="sum")


class _SeqBlocks:
    """The time axis of a forward under a seq axis larger than 1
    (`parallel/context.py`): the stack runs on the rank's time block of a
    sequence input, a layer that needs the whole sequence
    (``SEQ_LOCAL`` False: recurrent layers, pooling over time, Conv1D, a
    MoE layer's capacity count) on the sequence gathered (its backward
    sums the seq ranks' gradients), and a time-distributed layer after
    it on the block again.  Outside a seq mesh nothing changes."""

    def __init__(self, model, x, mask):
        from deeplearning4j_tpu_torch.parallel import collectives

        self.s = collectives.axis_size("seq")
        self.rank = collectives.axis_rank("seq")
        it = (model._itypes or [None])[0]
        seqin = it.kind == "rnn" if it is not None else x.dim() >= 3
        self.active = self.s > 1 and seqin and x.dim() >= 2
        self.t = x.shape[1] if self.active else 0
        if self.active and self.t % self.s:
            raise ValueError(f"sequence length {self.t} not divisible by seq "
                             f"axis size {self.s}")
        self.mask = mask                  # the whole features mask
        self.blocked = False

    def _is_seq(self, x, itype) -> bool:
        if not self.active or x.dim() < 2 or x.shape[1] != self.t:
            return False
        return itype.kind == "rnn" if itype is not None else x.dim() >= 3

    def enter(self, layer, x, mask, itype):
        """``x`` and the mask as ``layer`` takes them (``itype``: its
        input type, or None)."""
        if self.blocked and not layer.SEQ_LOCAL:
            self.blocked = False
            return _gather_time(x), self.mask
        if not self.blocked and layer.SEQ_LOCAL and self._is_seq(x, itype):
            self.blocked = True
            return _time_block(x), _time_block(self.mask)
        return x, mask

    def scope(self):
        from deeplearning4j_tpu_torch.parallel import context

        return context.time_sharded(self.rank, self.s if self.blocked else 1)

    def collapse(self) -> None:
        """The time axis is gone: nothing is a sequence from here on."""
        self.mask = None
        self.active = False


def check_schedule(schedule: str) -> None:
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}; options: "
                         "'gpipe', '1f1b'")


def _owns_loss(layer) -> bool:
    """A head that computes its own loss (`CenterLossOutputLayer`'s
    ``compute_loss_with_params``, `Yolo2OutputLayer`'s ``compute_loss``):
    it has no ``loss`` enum, and ``output()`` applies no activation."""
    return hasattr(layer, "compute_loss_with_params") or hasattr(layer, "compute_loss")


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
        self._rnn_runs = self._find_rnn_runs()
        # rnn_time_step: the carries between calls, and on the card one
        # graph a chunk signature over the compute tree they were
        # captured on
        self._rnn_stream_state: dict = {}
        self._rnn_graphs: dict = {}
        self._rnn_params = None

    def _find_rnn_runs(self) -> dict[int, int]:
        """Maximal runs (start index -> length) of two or more consecutive
        recurrent layers that step in one time loop: no dropout on a
        member after the first (a fused run applies only the first
        layer's) and no flatten inside (JAX ``_find_rnn_runs``)."""
        layers = self.conf.layers
        flat = self._flatten_before or [False] * len(layers)
        runs, i = {}, 0
        while i < len(layers):
            if not isinstance(layers[i], RecurrentLayerConfig):
                i += 1
                continue
            j = i + 1
            while (j < len(layers) and isinstance(layers[j], RecurrentLayerConfig)
                   and not layers[j].dropout_rate and not flat[j]):
                j += 1
            if j - i >= 2:
                runs[i] = j - i
            i = j
        return runs

    @property
    def _recurrent(self) -> list:
        """The recurrent layers, in stack order: whose carries a window
        or a stream holds."""
        return [l for l in self.conf.layers if isinstance(l, RecurrentLayerConfig)]

    def _init_carries(self, batch: int) -> dict:
        """Zero carries of every recurrent layer, in the compute dtype
        (JAX ``_init_carries``; the TBPTT program's ``cdtype``)."""
        return {l.name: l.init_carry(batch, self.compute_dtype, self.device)
                for l in self._recurrent}

    def _flatten_carries(self, carries: dict) -> list:
        return [t for l in self._recurrent for t in carries[l.name]]

    def _unflatten_carries(self, flat) -> dict:
        out, i = {}, 0
        for l in self._recurrent:
            out[l.name] = tuple(flat[i:i + l.CARRY])
            i += l.CARRY
        return out

    def _types(self):
        if self._itypes is None:
            raise ValueError("configuration has no input_type; call set_input_type")
        return self._itypes

    @torch.no_grad()
    def _initial_trees(self) -> tuple[dict, dict]:
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
        return tree, state

    def _layer_keys(self, step: int) -> list:
        """The dropout keys of step ``step``: layer i's is
        ``fold_in(fold(root, step), i)``, as the JAX package folds them."""
        key = rng.SeedStream.fold(self._stream.root, step)
        return [rng.fold_in(key, i) for i in range(len(self.conf.layers))]

    def _layer_outputs(self, params: dict, net_state: dict, features, *,
                       training: bool = False, keys=None, fmask=None,
                       carries=None, new_carries=None, fuse: bool = True,
                       lo: int = 0, hi: int | None = None):
        """Run the stack, yielding (layer, output, new state, whether the
        output is the rank's time block (`_SeqBlocks`)) layer by layer;
        layers [lo, hi) only when given.
        Inputs take the compute dtype (`entry_cast`); a
        feed-forward layer after convolutional maps sees them flattened.
        The (B, T) features mask ``fmask`` reaches every layer with
        ``ACCEPTS_MASK`` until the time axis collapses (JAX
        ``_forward``).  In training, layer i draws its dropout from
        ``keys[i]`` (`_layer_keys`: two Python ints, or two device
        scalars).  ``carries``: {layer name: carry}, where recurrent
        layers start (zeros for a name it lacks); their final carries
        land in the dict ``new_carries``.  A run of recurrent layers
        (`_find_rnn_runs`) steps in one time loop, drawing dropout from
        its first layer's key, and yields once, as its last layer,
        unless ``fuse`` is False."""
        x = entry_cast(as_tensor(features, self.device), self.compute_dtype)
        mask = None if fmask is None else as_tensor(fmask, self.device)
        layers = self.conf.layers
        n = len(layers) if hi is None else hi
        flatten = self._flatten_before or [False] * len(layers)
        itypes = self._itypes or [None] * len(layers)
        runs = self._rnn_runs if fuse else {}
        seq = _SeqBlocks(self, x, mask)
        plan = self._active_pipeline_plan()
        if plan is not None and carries is not None:
            raise ValueError(
                "recurrent carries (truncated BPTT, rnn_time_step) are not "
                "supported through a pipelined segment; drop the pipe axis")

        def carry_of(layer, x):
            c = None if carries is None else carries.get(layer.name)
            return c if c is not None else layer.init_carry(
                x.shape[0], x.dtype, x.device)

        i = lo
        while i < n:
            layer = layers[i]
            if flatten[i]:
                x = x.reshape(x.shape[0], -1)
            if plan is not None and i == plan.start:
                # the pipelined segment: this rank's stage of its blocks,
                # GPipe over the pipe axis (JAX `_forward`)
                from deeplearning4j_tpu_torch.parallel.pipeline import (
                    run_pipelined_segment,
                )

                if mask is not None:
                    raise ValueError(
                        "sequence masks are not supported through a pipelined "
                        "segment yet; drop the pipe axis or the mask")
                x = run_pipelined_segment(plan, params, x, training=training)
                yield layers[plan.end - 1], x, {}, False
                i = plan.end
                continue
            key = keys[i] if keys is not None else None
            run = runs.get(i, 0)
            # under a seq axis: the rank's time block into a per-step
            # layer, the whole sequence into any other
            x, mask = seq.enter(layer, x, mask, itypes[i])
            with seq.scope():
                if run >= 2:
                    lys = layers[i:i + run]
                    x, fins = fused_rnn_scan(
                        lys, [params.get(l.name, {}) for l in lys], x,
                        [carry_of(l, x) for l in lys], mask, training=training,
                        rng=key)
                    if carries is not None:
                        new_carries.update((l.name, f) for l, f in zip(lys, fins))
                    yield lys[-1], x, {}, seq.blocked
                    i += run
                    continue
                lp = params.get(layer.name, {})
                if carries is not None and isinstance(layer, RecurrentLayerConfig):
                    x, new_carries[layer.name] = layer.apply_with_carry(
                        lp, x, carry_of(layer, x), mask=mask, training=training,
                        rng=key)
                    ns = {}
                else:
                    kw = {"mask": mask} if layer.ACCEPTS_MASK else {}
                    x, ns = layer.apply(lp, net_state.get(layer.name, {}), x,
                                        training=training, rng=key, **kw)
            yield layer, x, ns, seq.blocked
            # once the time axis collapses (RNN -> FF), the mask is spent
            it = itypes[i]
            if (it is not None and it.kind == "rnn"
                    and layer.output_type(it).kind != "rnn"):
                mask = None
                seq.collapse()
            i += 1

    def _stack(self, params: dict, net_state: dict, features, *,
               training: bool = False, keys=None, fmask=None, carries=None):
        """The layer stack on ``params`` (already in the compute dtype)
        and ``net_state``, inside the mesh scope: (output, new state of the
        layers that have one, final carries or None when ``carries``
        (initial ones, {layer name: carry}) is None, whether the output is
        the rank's time block).  See `_layer_outputs`."""
        x, new_state, blocked = None, {}, False
        new_carries = None if carries is None else {}
        with self.mesh_scope(params):
            for layer, x, ns, blocked in self._layer_outputs(
                    params, net_state, features, training=training, keys=keys,
                    fmask=fmask, carries=carries, new_carries=new_carries):
                if ns:
                    new_state[layer.name] = ns
        return x, new_state, new_carries, blocked

    def _forward(self, params: dict, net_state: dict, features, *,
                 training: bool = False, keys=None, fmask=None, carries=None):
        """`_stack`'s output for the whole sequence (a time block
        gathered) and new state, and the final carries third when
        ``carries`` is given."""
        x, new_state, new_carries, blocked = self._stack(
            params, net_state, features, training=training, keys=keys,
            fmask=fmask, carries=carries)
        if blocked:
            with self.mesh_scope():
                x = _gather_time(x)
        if carries is not None:
            return x, new_state, new_carries
        return x, new_state

    def _out_activation(self) -> Activation:
        """What ``output()`` applies to the last layer's output: the
        output layer's activation (its loss's canonical one by default);
        nothing for a head that owns its loss."""
        last = self.conf.layers[-1]
        if _owns_loss(last) or not hasattr(last, "loss"):
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
        compute dtype, each recurrent layer's on its own; an inspection
        path; each for the whole sequence (a time block gathered)."""
        params = self.compute_params()
        with self.mesh_scope(params):
            return [_gather_time(x) if blocked else x
                    for _, x, _, blocked in self._layer_outputs(
                        params, self.net_state, features, fmask=features_mask,
                        fuse=False)]

    def _data_loss(self, params: dict, out, labels, lmask, blocked: bool = False):
        """The output layer's loss of ``out``; ``blocked``: ``out`` is the
        rank's time block (`_stack`), and so are the per-step labels and
        mask it is held against."""
        last = self.conf.layers[-1]
        labels = as_tensor(labels, self.device)
        if lmask is not None:
            lmask = as_tensor(lmask, self.device)
        if blocked:
            labels, lmask = (_time_block(t) for t in (labels, lmask))
        if hasattr(last, "compute_loss_with_params"):
            return last.compute_loss_with_params(params.get(last.name, {}), out,
                                                 labels, lmask)
        if hasattr(last, "compute_loss"):
            return last.compute_loss(out, labels, lmask)
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
        with self.mesh_scope(self.params):
            out, _ = self._forward(self.compute_params(), self.net_state,
                                   ds.features, fmask=ds.features_mask)
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
                params = self.compute_params()
                with self.mesh_scope(params):
                    probs = last.evaluation_output(params.get(last.name, {}), probs)
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
        if not _owns_loss(last):
            resolve_output_spec(last)

    # -- layerwise unsupervised pretraining --------------------------------
    def pretrain(self, data, epochs: int = 1, batch_size: int | None = None) -> None:
        """Greedy layerwise pretraining (MultiLayerNetwork.pretrain): each
        ``PRETRAINABLE`` layer (`nn/conf/pretrain.py`) in stack order, on
        the features alone."""
        for i, layer in enumerate(self.conf.layers):
            if getattr(layer, "PRETRAINABLE", False):
                self.pretrain_layer(i, data, epochs=epochs, batch_size=batch_size)

    def pretrain_layer(self, index: int, data, epochs: int = 1,
                       batch_size: int | None = None) -> float:
        """Pretrain layer ``index`` (MultiLayerNetwork.pretrainLayer): the
        layers before it in inference mode, then its ``pretrain_loss`` on
        its own parameters (`Model._pretrain_steps`).  Returns the last
        loss."""
        if self.params is None:
            self.init()
        layer = self.conf.layers[index]
        if not getattr(layer, "PRETRAINABLE", False):
            raise ValueError(
                f"layer {index} ({type(layer).__name__}) is not pretrainable; "
                "only AutoEncoder/VariationalAutoencoder layers support "
                "unsupervised pretraining")
        flatten = self._flatten_before or [False] * (index + 1)

        def prefix(batch):
            x = entry_cast(as_tensor(batch.features, self.device), self.compute_dtype)
            params = self.compute_params()
            with self.mesh_scope(params):
                for _, x, _, _ in self._layer_outputs(params, self.net_state, x,
                                                      fuse=False, hi=index):
                    pass
            return x.reshape(x.shape[0], -1) if flatten[index] else x

        return self._pretrain_steps(layer.name, layer, prefix,
                                    _as_iterator(data, batch_size), epochs)

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

    @staticmethod
    def _decoded_arrays(feats, labs, fmask, lmask) -> tuple:
        return (feats, labs, lmask, fmask)

    def _fused_decode_reason(self, steps_per_execution: int = 1) -> str | None:
        """JAX ``_fused_decode_reason``: the fit variants whose steps
        were not built to take a decode stage keep host transforms."""
        if self._grad_compression:
            return "grad-compression fit path"
        if self._pipeline_schedule == "1f1b" and self._pipeline_plan is not None:
            return "1F1B pipeline fit path"
        if self._tbptt:
            return "TBPTT fit path"
        return None

    def _reg_loss(self, params: dict):
        return regularization_loss(params,
                                   [(l.name, l) for l in self.conf.layers],
                                   self._split_axes(params))

    def _step_loss(self, params: dict, net_state: dict, features, labels,
                   lmask=None, fmask=None, keys=None, carries=None):
        """The step's objective (JAX ``_step_loss``): data loss + l1 / l2
        penalty + the layers' auxiliary losses, summed in that order
        (`_step_loss_parts`); under data parallelism the rank's share of
        the penalty and the auxiliary losses (`parallel/context.py`).
        Returns (loss, the layers' new state), and the final carries
        third when ``carries`` is given."""
        data, reg, aux, new_state, *rest = self._step_loss_parts(
            params, net_state, features, labels, lmask, fmask, keys, carries)
        reg, aux = dp_context.replica_share(reg, aux)
        return (data + reg + aux, new_state, *rest)

    def _step_loss_parts(self, params: dict, net_state: dict, features, labels,
                         lmask=None, fmask=None, keys=None, carries=None):
        """Forward, then the data loss, the l1 / l2 penalty and the layers'
        auxiliary losses apart, on the f32 master tree ``params``: the
        layers see it cast to the compute dtype inside the graph (but
        ``F32_PARAMS`` layers the masters); the output layer's own loss
        (the chunked head) and the penalty see the masters, as the JAX
        package's do.  Returns (data, penalty, aux, the layers' new state
        with the aux entries popped), and the final carries fifth when
        ``carries`` is given."""
        out, new_state, new_carries, blocked = self._stack(
            self.cast_tree(params, detach=False), net_state, features,
            training=True, keys=keys, fmask=fmask, carries=carries)
        with self.mesh_scope(params):
            data_loss = self._data_loss(params, out, labels, lmask, blocked)
        aux, new_state = pop_aux_losses(new_state)
        rest = () if carries is None else (new_carries,)
        return (data_loss, self._reg_loss(params), aux, new_state, *rest)


    def _forward_range(self, params: dict, net_state: dict, x, lo: int, hi: int, *,
                       training: bool, keys=None):
        """Layers [lo, hi) alone on ``params`` (compute dtype), one by
        one: the pieces before and after the pipelined segment of the
        1F1B step (JAX ``_forward_range``; no masks or carries, which the
        pipelined path refuses).  Returns (output, the layers' new
        state)."""
        new_state = {}
        for layer, x, ns, _ in self._layer_outputs(
                params, net_state, x, training=training, keys=keys, fuse=False,
                lo=lo, hi=hi):
            if ns:
                new_state[layer.name] = ns
        return x, new_state

    # -- pipeline parallelism ----------------------------------------------
    def _setup_pipeline(self, mesh, n_micro: int = 0, schedule: str = "gpipe") -> None:
        """`distribute` with a pipe axis: plan which run of blocks
        pipelines over it (raises with the reason when the stack has no
        such run).  ``schedule`` "gpipe" runs the segment inside the
        ordinary step's forward (`_layer_outputs`); "1f1b" trains through
        its own step (`_grad_step_1f1b`), its backward interleaved into
        the pipeline."""
        from deeplearning4j_tpu_torch.parallel.pipeline import plan_sequential_pipeline
        from deeplearning4j_tpu_torch.runtime.mesh import PIPE_AXIS

        check_schedule(schedule)
        self._pipeline_plan = plan_sequential_pipeline(
            self.conf.layers, self.params, self._types(), mesh.shape[PIPE_AXIS],
            n_micro, net_state=self.net_state)
        self._pipeline_schedule = schedule
        self._step_fns.clear()

    def _active_pipeline_plan(self):
        """The plan, while the active mesh's pipe axis is wider than 1."""
        from deeplearning4j_tpu_torch.runtime.mesh import PIPE_AXIS, active_mesh

        plan = self._pipeline_plan
        mesh = active_mesh()
        if plan is None or mesh is None or mesh.shape.get(PIPE_AXIS, 1) < 2:
            return None
        return plan

    @property
    def _1f1b(self) -> bool:
        return (self._pipeline_plan is not None and self._mesh is not None
                and self._pipeline_schedule == "1f1b")

    def _step_program(self, decode=None):
        """Under the 1F1B schedule the step is its own program, under
        the JAX package's key ``("train_1f1b",)`` (a 1F1B fit never
        fuses a decode: `_fused_decode_reason`)."""
        if not self._1f1b:
            return super()._step_program(decode)
        fn = self._step_fns.get(("train_1f1b",))
        if fn is None:
            from deeplearning4j_tpu_torch.observe import cost

            fn = self._step_fns[("train_1f1b",)] = cost.register_step_program(
                self, ("train_1f1b",), self._grad_step)
        return fn

    def _grad_step(self, params: dict, net_state: dict, *inputs, loss=None):
        if loss is None and self._1f1b:
            return self._grad_step_1f1b(params, net_state, *inputs)
        return super()._grad_step(params, net_state, *inputs, loss=loss)

    def _grad_step_1f1b(self, params: dict, net_state: dict, features, labels,
                        lmask=None, fmask=None, keys=None):
        """The 1F1B training step (JAX ``_get_step_fn_1f1b``): the layers
        before the segment forward with their graph kept, the segment
        through `pipeline_train_1f1b` with the head's loss and gradients
        on the last stage a microbatch at a time, the layers before the
        segment pulled back from the microbatches' dx, and the l1 / l2
        penalty's gradient added.  Same returns as `_grad_step`: the
        loss, the trainable leaves' gradients (this rank's stage's for
        the blocks, zeros for the other stages'), the new state of the
        layers before the segment.  The state and auxiliary losses the
        layers after the segment emit are dropped, as in the JAX step."""
        from deeplearning4j_tpu_torch.models.model import _tree_map, tree_unflatten
        from deeplearning4j_tpu_torch.parallel import collectives
        from deeplearning4j_tpu_torch.parallel import pipeline as pp

        if lmask is not None or fmask is not None:
            raise ValueError(
                "masks are not supported through the 1f1b pipeline schedule; drop "
                "the masks or use schedule='gpipe' without masks")
        plan = self._pipeline_plan
        layers = self.conf.layers
        n_layers = len(layers)
        pre = [l.name for l in layers[:plan.start] if l.name in params]
        post = [l.name for l in layers[plan.end:] if l.name in params]
        # a frozen layer's leaves enter detached (`_grad_step`)
        src = {k: _tree_map(torch.Tensor.detach, v) if k in self._frozen else v
               for k, v in params.items()}
        with torch.enable_grad():
            # the whole compute tree, so the mesh scope knows every split leaf
            cp = self.cast_tree(src, detach=False)
            scope = self.mesh_scope(cp, params)
            scope.__enter__()
            try:
                stage = collectives.axis_rank("pipe")
                x1, st_pre = self._forward_range(cp, net_state, features, 0, plan.start,
                                                 training=True, keys=keys)
                x_micro = pp.split_microbatches(x1.detach(), plan.n_micro)
                labels_micro = pp.split_microbatches(as_tensor(labels, self.device),
                                                     plan.n_micro)

                def loss_grad(y, m):
                    yy = y.detach().requires_grad_()
                    pt = {n: _tree_map(lambda t: t.detach().requires_grad_(), src[n])
                          for n in post}
                    full = {**src, **pt}
                    cfull = {**cp, **self.cast_tree(pt, detach=False)}
                    with self.mesh_scope(cfull, full):
                        out, _ = self._forward_range(cfull, net_state, yy, plan.end,
                                                     n_layers, training=True, keys=keys)
                        loss_m = self._data_loss(full, out, labels_micro[m], None)
                    pl = tree_leaves(pt)
                    g = torch.autograd.grad(loss_m, pl + [yy], allow_unused=True)
                    return loss_m.detach(), g[-1], tree_unflatten(pt, [
                        torch.zeros_like(t) if d is None else d for t, d in zip(pl, g[:-1])])

                loss, seg, dx_micro, dpost = pp.pipeline_train_1f1b(
                    pp._stage_fn(plan.block_config, True, self.compute_dtype),
                    pp.stage_blocks(plan, src, stage), x_micro, loss_grad, axis="pipe",
                    extra={n: _tree_map(torch.zeros_like, params[n]) for n in post})
                grads = {name: _tree_map(torch.zeros_like, params[name])
                         for name in params}
                grads.update(dpost)
                m = len(plan.block_names) // plan.k
                for name, g in zip(plan.block_names[stage * m:(stage + 1) * m], seg):
                    grads[name] = g
                pre_leaves = [t for n in pre for t in tree_leaves(src[n]) if t.requires_grad]
                if pre_leaves and x1.requires_grad:
                    back = torch.autograd.grad(x1, pre_leaves, pp.merge_microbatches(
                        dx_micro).to(x1.dtype), allow_unused=True)
                    got = {id(t): g for t, g in zip(pre_leaves, back) if g is not None}
                    for n in pre:
                        grads[n] = tree_unflatten(src[n], [
                            got.get(id(t), torch.zeros_like(t)) for t in tree_leaves(src[n])])
                # the penalty is local to each leaf: its gradient adds directly
                (reg,) = dp_context.replica_share(self._reg_loss(params))
                if isinstance(reg, torch.Tensor) and reg.requires_grad:
                    rg = torch.autograd.grad(reg, tree_leaves(params), allow_unused=True)
                    grads = tree_unflatten(grads, [
                        g if r is None else g + r.to(g.dtype)
                        for g, r in zip(tree_leaves(grads), rg)])
                    loss = loss + reg.detach()
            finally:
                scope.__exit__(None, None, None)
        _, st_pre = pop_aux_losses(st_pre)
        return (loss, self._trainable_leaves(grads),
                _tree_map(lambda t: t.detach(), st_pre))

    # -- truncated BPTT ----------------------------------------------------
    @property
    def _tbptt(self) -> bool:
        return self.conf.backprop_type == "tbptt" and self.conf.tbptt_length > 0

    def fit_batch(self, batch) -> None:
        """One optimizer step on ``batch``; under truncated BPTT one a
        window of ``conf.tbptt_length`` steps (`_run_tbptt`)."""
        if self._tbptt:
            self._run_tbptt([self._as_batch(batch)])
        else:
            super().fit_batch(batch)

    def _group_runner(self, batches, decode=None):
        """Under truncated BPTT a group runs as K x W window steps
        (`_run_tbptt`) when its batches share features and labels shapes,
        carry no mask and split into whole windows; else batch by batch,
        where the JAX package's ``_fit_epoch_multi`` flushes them too.
        (The JAX package also keeps a switch, ``_tbptt_scan``, that forces
        per-window programs around an XLA miscompile of its window scan;
        the port runs no scan and needs none.)"""
        if not self._tbptt:
            return super()._group_runner(batches, decode)
        f0, l0 = np.shape(batches[0].features), np.shape(batches[0].labels)
        if any(tuple(np.shape(b.features)) != tuple(f0)
               or tuple(np.shape(b.labels)) != tuple(l0)
               or b.features_mask is not None or b.labels_mask is not None
               for b in batches):
            return None
        if f0[1] % self.conf.tbptt_length:
            return None
        return self._run_tbptt

    def _check_tbptt(self, batch) -> None:
        """The JAX package's refusals, with its messages."""
        t = np.shape(batch.features)[1]
        if self.conf.output_type().kind != "rnn":
            raise ValueError(
                "TBPTT requires a per-timestep output (RnnOutputLayer); this "
                "network collapses the time axis — use standard backprop")
        if any(isinstance(l, Bidirectional) for l in self.conf.layers):
            raise ValueError(
                "TBPTT is undefined for bidirectional networks (the backward "
                "direction crosses window boundaries) — use standard backprop")
        lshape = np.shape(batch.labels)
        if len(lshape) < 2 or lshape[1] != t:
            raise ValueError(
                "TBPTT needs per-timestep labels with a (B, T, ...) time "
                f"axis matching features; got {tuple(lshape)} for T={t}")

    def _window_loss(self, params: dict, net_state: dict, features, labels,
                     lmask, fmask, *rest):
        """The objective of one truncated-BPTT window; ``rest`` is the
        window's carries, flat in `_flatten_carries` order, then the
        keys.  Returns (loss, the layers' new state, the new carries flat
        and detached: the window boundary stops the gradient)."""
        *flat, keys = rest
        loss, new_state, new_carries = self._step_loss(
            params, net_state, features, labels, lmask, fmask, keys,
            carries=self._unflatten_carries(flat))
        return loss, new_state, tuple(t.detach() for t in
                                      self._flatten_carries(new_carries))

    def _window_program(self, key: tuple):
        """The window step (`_grad_step` over `_window_loss`), registered
        with the cost registry under the JAX package's key on first use:
        ``("train_tbptt", has_lmask, has_fmask)`` for a batch,
        ``("train_tbptt_grouped",)`` for a group, and
        `_step_key_suffix`."""
        key = key + self._step_key_suffix()
        fn = self._step_fns.get(key)
        if fn is None:
            from deeplearning4j_tpu_torch.observe import cost

            fn = self._step_fns[key] = cost.register_step_program(
                self, key, functools.partial(self._grad_step, loss=self._window_loss))
        return fn

    def _run_tbptt(self, batches: list) -> None:
        """Truncated BPTT on ``batches`` (one, or a group of one shape):
        each batch's time axis in windows of ``tbptt_length`` steps, and
        a remainder window after them when the length does not divide T.
        Each window is one optimizer step with its own loss and dropout
        keys (step ``iteration + i``), its carries the previous window's
        final ones as values; every batch starts from zero carries.  One
        program of all the windows (JAX ``_get_step_fn_tbptt`` and its
        grouped form): the listeners see each window as an iteration,
        and the step scope counts each window's work."""
        if self._grad_compression:
            raise ValueError(
                "grad_compression does not compose with TBPTT (per-window "
                "carries cross the compressed-sync boundary); use standard "
                "backprop or drop compression")
        self._prepare(batches)
        for b in batches:
            self._check_tbptt(b)
        size = self.conf.tbptt_length
        t = int(np.shape(batches[0].features)[1])
        w, rem = divmod(t, size)
        bounds = [(i * size, (i + 1) * size) for i in range(w)] + (
            [(w * size, t)] if rem else [])
        n = len(batches) * len(bounds)
        first = batches[0]
        key = (("train_tbptt_grouped",) if len(batches) > 1 else
               ("train_tbptt", first.labels_mask is not None,
                first.features_mask is not None))
        program = self._window_program(key)
        with step_scope(self, n) as scope:
            if self.device.type == "cuda":
                losses = self._tbptt_cuda(batches, bounds, program)
            else:
                losses = self._tbptt_eager(batches, bounds, program)
            scope.sync(losses)
            self._compute = None
            self.last_batch_size = batches[-1].num_examples
            self._finish_steps(losses, n)

    def _tbptt_eager(self, batches, bounds, program) -> torch.Tensor:
        out, s = [], 0
        for b in batches:
            flat = self._flatten_carries(self._init_carries(np.shape(b.features)[0]))
            arrays = self._batch_arrays(b)
            for t0, t1 in bounds:
                window = [None if a is None else a[:, t0:t1] for a in arrays]
                loss, self.opt_state, flat = self._train_step(
                    *window, *flat, self._step_keys(self.iteration + s), None,
                    grad_step=program)
                out.append(loss)
                s += 1
        return torch.stack(out)

    def _tbptt_cuda(self, batches, bounds, program) -> torch.Tensor:
        """The windows on the card from inputs staged once (the batches,
        every window's keys and step values).  Each window is a replay of
        the captured window step of its signature (the remainder window
        has its own), or with ``capture_steps = False`` the same program
        eagerly.  A graph's carries are static inputs and its new carries
        static outputs: between replays the next window's carries are a
        device-to-device copy of them, and a batch's first window zeros
        its carry inputs.  Nothing here waits on the card."""
        staged = _Staged(self, batches, n_steps=len(batches) * len(bounds))
        out = torch.empty(len(batches) * len(bounds), dtype=torch.float32,
                          device=self.device)
        zeros = tuple(self._flatten_carries(
            self._init_carries(staged.arrays[0].shape[1])))
        n_arrays, n_carries = len(staged.arrays), len(zeros)
        bare = functools.partial(self._grad_step, loss=self._window_loss)
        rec = program._cost_record
        s = 0
        for k in range(len(batches)):
            flat = zeros
            for w, (t0, t1) in enumerate(bounds):
                window = tuple(None if a is None else a[k][:, t0:t1]
                               for a in staged.arrays)
                inputs = window + tuple(flat) + (staged.keys[s], staged.vals[s])
                if not self.capture_steps:
                    # the counts advance below, as after a replay
                    loss, _, flat = self._train_step(*inputs, grad_step=program)
                    out[s].copy_(loss)
                else:
                    prog = self._captured.get(self._signature(inputs))
                    if prog is None:
                        prog = self._new_graph(inputs, program, bare)
                        (flat,) = prog.warmup_outputs
                    else:
                        for i, (dst, src) in enumerate(zip(prog.inputs, inputs)):
                            if dst is None:
                                continue
                            if w == 0 and n_arrays <= i < n_arrays + n_carries:
                                dst.zero_()
                            else:
                                dst.copy_(src)
                        (flat,) = prog.replay()
                        self._cost_program = rec
                        rec.dispatches += 1
                    out[s].copy_(prog.inputs[-1])
                self.opt_state = advance_counts(self.opt_state)
                s += 1
        return out

    def _reset_carries(self) -> None:
        """Zero the carry inputs of the captured window steps: a batch
        that failed between windows (a rollback, an OOM split) leaves no
        carries a later replay could read.  Every batch zeros them at its
        first window anyway (JAX recovery resets its TBPTT state there)."""
        for prog in self._captured.values():
            if prog.outputs:             # a window step: (its new carries,)
                n = len(prog.outputs[0])
                # the inputs: features, labels, two masks, the carries, ...
                for dst in prog.inputs[4:4 + n]:
                    dst.zero_()

    # -- streaming inference (rnnTimeStep) ---------------------------------
    def _rnn_program(self):
        """`_rnn_step`, registered under the JAX package's key."""
        fn = self._step_fns.get(("rnn_step",))
        if fn is None:
            from deeplearning4j_tpu_torch.observe import cost

            fn = self._step_fns[("rnn_step",)] = cost.register_step_program(
                self, ("rnn_step",), self._rnn_step)
        return fn

    def _rnn_step(self, params: dict, net_state: dict, features, *flat):
        """One streamed chunk: the stack from the carries ``flat``
        (`_flatten_carries` order) on the compute tree ``params``.
        Returns (the output activation of the last layer, in f32; the new
        carries flat).  Pure."""
        x = as_tensor(features, self.device)
        with self.program_run("rnn_step", tuple(x.shape), x.dtype):
            out, _, new = self._forward(params, net_state, x,
                                        carries=self._unflatten_carries(flat))
        return self._out_activation()(out.float()), tuple(self._flatten_carries(new))

    @torch.no_grad()
    def rnn_time_step(self, features) -> torch.Tensor:
        """Streaming inference (the reference's ``rnnTimeStep``): a chunk
        (B, T, F) from the carries the previous call left, which it
        replaces; the output activation applied, in f32.  On the card
        each chunk signature is one CUDA graph whose carry inputs are the
        stream's state itself (the graph writes the new carries over
        them), so char-by-char generation is a replay a character."""
        if self.params is None:
            self.init()
        if any(isinstance(l, Bidirectional) for l in self.conf.layers):
            raise ValueError(
                "rnn_time_step is undefined for bidirectional networks (the "
                "backward pass needs the full future sequence) — use output()")
        x = as_tensor(features, self.device)
        if not self._rnn_stream_state:
            self._rnn_stream_state = self._init_carries(x.shape[0])
            self._rnn_graphs = {}
        flat = self._flatten_carries(self._rnn_stream_state)
        if flat and flat[0].shape[0] != x.shape[0]:
            raise ValueError(
                f"rnn_time_step: a chunk of batch {x.shape[0]} against a stream "
                f"state of batch {flat[0].shape[0]}; call "
                "rnn_clear_previous_state() first")
        params, program = self.compute_params(), self._rnn_program()
        if self.device.type != "cuda" or not self.capture_steps:
            out, new = program(params, self.net_state, x, *flat)
            for dst, src in zip(flat, new):
                dst.copy_(src)
            return out
        if params is not self._rnn_params:        # new weights: new graphs
            self._rnn_graphs, self._rnn_params = {}, params
        sig = (tuple(x.shape), x.dtype)
        prog = self._rnn_graphs.get(sig)
        if prog is None:
            from deeplearning4j_tpu_torch.runtime.graphs import CapturedProgram

            def step(xin, *state):
                capturing = torch.cuda.is_current_stream_capturing()
                out, new = (self._rnn_step if capturing else program)(
                    params, self.net_state, xin, *state)
                for dst, src in zip(state, new):
                    dst.copy_(src)
                return out

            other = next(iter(self._rnn_graphs.values()), None)
            prog = self._rnn_graphs[sig] = CapturedProgram(
                step, (x.clone(), *flat), keep=(params, self.net_state),
                pool=other and other.graph.pool(), stream=other and other.stream)
            return prog.warmup_outputs
        prog.inputs[0].copy_(x)
        out = prog.replay()
        rec = program._cost_record
        self._cost_program = rec
        rec.dispatches += 1
        return out.clone()

    def rnn_clear_previous_state(self) -> None:
        """Forget the stream's carries: the next `rnn_time_step` starts
        from zeros (and captures its graphs again)."""
        self._rnn_stream_state = {}
        self._rnn_graphs = {}

    def _drop_graphs(self) -> None:
        super()._drop_graphs()
        self._rnn_graphs = {}
