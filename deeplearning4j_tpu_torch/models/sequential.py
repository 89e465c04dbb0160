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
the old.  ``fit(..., steps_per_execution=K)`` groups K batches of one
shape (JAX ``_fit_epoch_multi``): each step keeps its own loss; a group
whose shapes differ, and a short tail, step batch by batch.

The captured step.  The JAX package runs a whole step as one compiled
program.  On CUDA the port runs it as one CUDA graph for each batch
signature (`runtime/graphs.py`): forward, backward, updater and state
write.  The first step of a signature runs eagerly (the graph's
warm-up, on the capture stream) and is captured after; every later step
is a replay.  Whatever changes between steps is a device input the host
refills before each replay, never a value baked in at capture: the
batch, the layers' dropout keys (drawn on the host from the step
counter), and the updater's step values (the learning rate and Adam's
bias corrections, `nn/updaters.py` ``values``), whose counts advance on
the host.  A K-step group stages its K batches, keys and values on the
card in one copy each and replays
the graph K times, each step's inputs copied card to card into the
graph's.  ``capture_steps = False`` runs the same step program eagerly
on the same device inputs: the same kernels, so the same bits.  A
capture that fails raises; nothing reruns the step eagerly instead.
A model's step graphs share one memory pool and one capture stream:
the pool holds what a step needs besides the live trees (activations,
gradients, scratch), and a later signature's graph reuses the earlier
ones' memory, since no two steps run at once.  The graphs read the
live parameter, optimizer and state tensors, so whatever installs new
ones (`init`, `load_params`, `load_net_state`, a fresh optimizer
state) drops them (`_drop_graphs`); copying values into the live
tensors in place, as `load_state_leaves` does, keeps them.  On the CPU
the step runs eagerly, its step values as Python floats: optax's
arithmetic.

Random bits follow the JAX package's `SeedStream` (`runtime/rng.py`):
layer ``name`` initialises from ``stream.key("init/<name>")``, and step
``i`` drops out with ``fold_in(fold(root, i), layer index)``, so a seed
gives the JAX package's weights and masks.  The parameter list the
updater sees is in ``jax.tree.leaves`` order (dict keys sorted at every
level), the order of the optax state's leaves in a checkpoint.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
from torch import nn

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
from deeplearning4j_tpu_torch.models.model import Model
from deeplearning4j_tpu_torch.nn import losses
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.updaters import advance_counts, with_gradient_clipping
from deeplearning4j_tpu_torch.observe.trace import step_scope
from deeplearning4j_tpu_torch.ops.dequant_matmul import counting_selections
from deeplearning4j_tpu_torch.quant.ptq import SCHEME
from deeplearning4j_tpu_torch.quant.qtensor import QuantizedTensor
from deeplearning4j_tpu_torch.runtime import rng
from deeplearning4j_tpu_torch.runtime.backend import backend, resolve_device


class QuantizedLeaf(nn.Module):
    """One `QuantizedTensor` of the tree: int8 ``q`` and f32 ``scale`` as
    buffers (an int8 tensor cannot be a parameter that requires grad)."""

    def __init__(self, qt: QuantizedTensor):
        super().__init__()
        self.register_buffer("q", qt.q)
        self.register_buffer("scale", qt.scale)

    def tree(self) -> QuantizedTensor:
        return QuantizedTensor(self.q, self.scale)


class ParamTree(nn.Module):
    """A nested parameter dict as a module: tensors become parameters,
    `QuantizedTensor` leaves `QuantizedLeaf` buffers, dicts child
    modules."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, QuantizedTensor):
                self.add_module(key, QuantizedLeaf(val))
            else:
                self.register_parameter(key, nn.Parameter(val))

    def tree(self) -> dict:
        out = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


def as_tensor(x, device) -> torch.Tensor:
    """A tensor on ``device``; array-likes are copied first, so read-only
    numpy arrays (a JAX array's ``np.asarray`` view) are fine."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in ``jax.tree.leaves`` order: keys
    sorted at every level, a `QuantizedTensor` as its ``q`` then its
    ``scale``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, QuantizedTensor):
        return [tree.q, tree.scale]
    return [tree]


def _has_quantized(tree: dict) -> bool:
    return any(_has_quantized(v) if isinstance(v, dict)
               else isinstance(v, QuantizedTensor) for v in tree.values())


def _as_quantized(leaf, path: str) -> QuantizedTensor:
    """A `QuantizedTensor` from any leaf with ``.q`` and ``.scale``
    arrays, its bits unchanged: ``q`` must be int8 and ``scale`` f32 of
    shape ``(q.shape[-1],)``.  Tensors stay on their device (a staged
    push on the card is not copied through the host)."""
    q, scale = (x.detach() if isinstance(x, torch.Tensor)
                else torch.from_numpy(np.array(x)) for x in (leaf.q, leaf.scale))
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{path}: a quantized leaf needs int8 q and f32 scale, "
                        f"got {q.dtype} and {scale.dtype}")
    if q.dim() < 1 or tuple(scale.shape) != (q.shape[-1],):
        raise ValueError(f"{path}: scale shape {tuple(scale.shape)} does not "
                         f"match q {tuple(q.shape)}")
    return QuantizedTensor(q.contiguous(), scale.contiguous())


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


def _copy_state(dst: dict, src: dict) -> None:
    """Write the layers' new state ``src`` over ``dst`` in place (the
    tensors a captured step reads stay the same objects)."""
    for name, leaves in src.items():
        for k, v in leaves.items():
            dst[name][k].copy_(v)


class _Staged:
    """A step group's inputs on the card: the batches and their masks
    stacked, the layers' keys (K, layers, 2) and the updater's step
    values (K, n), one host-to-device copy each."""

    def __init__(self, model, batches):
        dev = model.device

        def stack(arrays):
            if isinstance(arrays[0], torch.Tensor):
                return torch.stack([a.to(dev) for a in arrays])
            return torch.from_numpy(np.stack([np.asarray(a) for a in arrays])).to(dev)

        self.features = stack([b.features for b in batches])
        self.labels = stack([b.labels for b in batches])
        self.lmask = (None if batches[0].labels_mask is None
                      else stack([b.labels_mask for b in batches]))
        self.fmask = (None if batches[0].features_mask is None
                      else stack([b.features_mask for b in batches]))
        keys, vals, state = [], [], model.opt_state
        for i in range(len(batches)):
            keys.append(model._layer_keys(model.iteration + i))
            vals.append(model._tx.values(state))
            state = advance_counts(state)
        self.keys = torch.tensor(keys, dtype=torch.int64).to(dev)
        self.vals = torch.from_numpy(np.asarray(vals, np.float32).reshape(
            len(batches), len(vals[0]))).to(dev)

    def step(self, i: int) -> tuple:
        """Step i's (features, labels, labels mask, features mask, keys,
        values)."""
        return (self.features[i], self.labels[i],
                None if self.lmask is None else self.lmask[i],
                None if self.fmask is None else self.fmask[i],
                self.keys[i], self.vals[i])


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
        self.layers = nn.ModuleDict()
        self._compute = None
        self._quantized = None         # the scheme marker of a quantized tree
        # the training step's CUDA graphs, one a batch signature; on the
        # card a step replays one unless `capture_steps` is False
        self._captured: dict = {}
        self.capture_steps = True
        # the step program, registered with the cost registry
        # (observe/cost.py) on first use; the record lives while it is
        # cached here.  `_cost_program`: the record of the last program
        # dispatched (set by the registration wrapper during the call;
        # StepScope.sync() snapshots it)
        self._step_fns: dict = {}
        self._cost_program = None
        # (program kind, int8?, input signature) of every program run so
        # far: where the JAX package would trace (`program_run`)
        self._program_signatures: set = set()
        self._signatures_lock = threading.Lock()

    @property
    def compute_dtype(self) -> torch.dtype:
        if self._bf16 and self._quantized is None:
            return torch.bfloat16
        return torch.float32

    @property
    def params(self):
        """The parameter tree: f32 tensors, and `QuantizedTensor` leaves
        in a quantized model (None before `init`)."""
        if not self.layers:
            return None
        return {name: m.tree() for name, m in self.layers.items()}

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

    @torch.no_grad()
    def load_params(self, tree: dict) -> "SequentialModel":
        """Install a parameter tree of array-likes, checked name for name
        and shape for shape against what `init` would create.  A leaf
        with ``.q`` and ``.scale`` arrays (a `QuantizedTensor`, or the
        JAX package's after ``jax.tree.map(np.asarray, ...)``) is
        installed bit for bit as an int8 weight and its f32 scales."""
        if self.params is None:
            self.init()
        self._install(self._checked(self.params, tree, quantized_ok=True))
        return self

    @torch.no_grad()
    def load_net_state(self, tree: dict) -> "SequentialModel":
        """Install a layer-state tree (BatchNorm's running stats) of
        array-likes, checked against what `init` creates."""
        if self.params is None:
            self.init()
        self.net_state = _tree_map(lambda t: t.to(self.device),
                                   self._checked(self.net_state, tree))
        self._drop_graphs()
        return self

    def _checked(self, want: dict, got: dict, quantized_ok=False) -> dict:
        def walk(w, g, path):
            if set(w) != set(g):
                raise ValueError(
                    f"names differ at {path or '<root>'}: "
                    f"want {sorted(w)}, got {sorted(g)}")
            out = {}
            for k, v in w.items():
                p = f"{path}/{k}" if path else k
                if isinstance(v, dict):
                    out[k] = walk(v, g[k], p)
                    continue
                t = g[k]
                if quantized_ok and hasattr(t, "q") and hasattr(t, "scale"):
                    t = _as_quantized(t, p)
                else:
                    t = (t.detach().float() if isinstance(t, torch.Tensor)
                         else torch.from_numpy(np.array(t, dtype=np.float32))
                         ).contiguous()
                if tuple(t.shape) != tuple(v.shape):
                    raise ValueError(f"{p}: shape {tuple(t.shape)} != "
                                     f"{tuple(v.shape)}")
                out[k] = t
            return out

        return walk(want, got, "")

    def _install(self, tree: dict) -> None:
        """Make ``tree`` the model's parameters (`init`, `load_params`,
        a restore): the compute copy, the optimizer state and the step
        graphs belonged to the old tensors and go."""
        tree = _tree_map(lambda t: t.to(self.device), tree)
        self.layers = nn.ModuleDict(
            {name: ParamTree(p) for name, p in tree.items()})
        self._compute = None
        self.opt_state = None
        self._drop_graphs()
        self._quantized = ({"scheme": SCHEME} if _has_quantized(tree)
                           else None)

    def _drop_graphs(self) -> None:
        """Forget the step graphs: they read tensors that are no longer
        the model's.  The next step of each signature captures anew."""
        self._captured = {}

    def compute_params(self) -> dict:
        """The parameter tree in the compute dtype, detached (cached;
        rebuilt after `init`, `load_params` and every training step).
        `QuantizedTensor` leaves stay as they are."""
        if self._compute is None:
            self._compute = self.cast_tree(self.params)
        return self._compute

    def cast_tree(self, tree: dict, detach: bool = True) -> dict:
        """``tree`` cast to the compute dtype, as the layers see it: the
        ``F32_PARAMS`` layers (the MoE layer) keep f32 and `QuantizedTensor`
        leaves stay as they are (a quantized model computes in f32).
        Detached unless ``detach`` is False (the training step
        differentiates through the cast)."""
        def cast(dt):
            def leaf(t):
                if isinstance(t, QuantizedTensor):
                    return t
                return (t.detach() if detach else t).to(dt)
            return leaf

        return {k: _tree_map(cast(torch.float32 if k in self.f32_layers
                                  else self.compute_dtype), v)
                for k, v in tree.items()}

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

    def program_run(self, kind: str, *signature):
        """The scope of one run of program ``kind`` at input ``signature``
        (shapes only) over this model's kind of tree (int8 or float).
        Its quantized sites count their implementation on the first run
        only: where the JAX package traces the program."""
        key = (kind, self._quantized is not None) + signature
        with self._signatures_lock:
            first = key not in self._program_signatures
            self._program_signatures.add(key)
        return counting_selections(first)

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

    def clone(self) -> "SequentialModel":
        """A model of the same configuration and device with copies of
        the parameters, layer state, optimizer state and counters."""
        m = SequentialModel(self.conf, device=self.device)
        if self.params is not None:
            m._install(_tree_map(lambda t: t if isinstance(t, QuantizedTensor)
                                 else t.detach().clone(), self.params))
            m._quantized = self._quantized
            m.net_state = _tree_map(lambda t: t.clone(), self.net_state)
            if self.opt_state is not None:
                m.opt_state = _clone_state(self.opt_state)
        m.iteration, m.epoch = self.iteration, self.epoch
        return m

    # -- training -------------------------------------------------------------

    def _check_trainable(self) -> None:
        for layer in self.conf.layers:
            if layer.frozen:
                raise NotImplementedError(
                    f"layer {layer.name!r}: frozen layers are not ported yet "
                    "(ROADMAP A9: masked updates, train/transfer.py)")
        last = self.conf.layers[-1]
        if not hasattr(last, "compute_loss_with_params"):
            resolve_output_spec(last)

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

    def _step_program(self):
        """The training step's pure device program, `_grad_step`,
        registered with the cost registry on first use (as the JAX
        package's ``_get_step_fn`` registers its jitted step)."""
        fn = self._step_fns.get(("train",))
        if fn is None:
            from deeplearning4j_tpu_torch.observe import cost

            fn = self._step_fns[("train",)] = cost.register_step_program(
                self, ("train",), self._grad_step)
        return fn

    def _grad_step(self, params: dict, net_state: dict, features, labels,
                   lmask, fmask, keys):
        """Loss, gradients of ``params`` (``jax.tree.leaves`` order, zeros
        for an unused leaf) and the layers' new state on one batch: the
        step's forward and backward, and no state changed — the update
        applies them.  Pure, so the cost analysis can run it again."""
        plist = tree_leaves(params)
        with torch.enable_grad():
            loss, new_state = self._step_loss(params, net_state, features,
                                              labels, lmask, fmask, keys=keys)
            grads = torch.autograd.grad(loss, plist, allow_unused=True)
        return (loss, [torch.zeros_like(p) if g is None else g
                       for p, g in zip(plist, grads)],
                _tree_map(lambda t: t.detach(), new_state))

    def _train_step(self, features, labels, lmask, fmask, keys, vals,
                    grad_step=None):
        """One whole step on the live trees: `_grad_step`, the updater,
        the parameters and the layer state updated in place.  ``lmask``,
        ``fmask``: the labels and features masks, or None.  ``keys``:
        the layers' dropout keys (`_layer_keys`, or their (layers, 2)
        int64 device tensor); ``vals``: the updater's step values (None:
        the updater computes them as Python floats; else a device
        tensor).  ``grad_step``: the forward and backward to run (the
        registered `_step_program`, which counts a dispatch, by
        default).  Returns the loss and the updater's new state (its
        counts advanced)."""
        if isinstance(keys, torch.Tensor):
            keys = [(k[0], k[1]) for k in keys]
        if vals is not None:
            vals = [vals[i] for i in range(vals.shape[0])]
        params = self.params
        plist = tree_leaves(params)
        loss, grads, new_state = (grad_step or self._step_program())(
            params, self.net_state, features, labels, lmask, fmask, keys)
        updates, opt_state = self._tx.update(grads, self.opt_state, plist, vals)
        with torch.no_grad():
            for p, u in zip(plist, updates):
                p.add_(u.to(p.dtype))
            _copy_state(self.net_state, new_state)
        return loss.detach(), opt_state

    def fit_batch(self, batch: DataSet) -> None:
        """One optimizer step on ``batch``."""
        self._run_steps([batch])

    def _prepare(self, batches) -> None:
        if self.params is None:
            self.init()
        if self._quantized is not None:
            raise RuntimeError(
                "this model is int8-quantized for inference and takes no "
                "training step; train the f32 model, then quantize it again")
        self._check_trainable()
        if self.opt_state is None:
            self.opt_state = self._tx.init(tree_leaves(self.params))
            self._drop_graphs()

    def _run_steps(self, batches: list) -> None:
        """len(batches) optimizer steps in order, one loss each: on the
        card from staged inputs (graph replays, or the same program
        eagerly), on the CPU eagerly."""
        self._prepare(batches)
        k = len(batches)
        with step_scope(self, k) as scope:
            if self.device.type == "cuda":
                losses_k = self._run_steps_cuda(batches)
            else:
                out = []
                for i, b in enumerate(batches):
                    loss, self.opt_state = self._train_step(
                        b.features, b.labels, b.labels_mask, b.features_mask,
                        self._layer_keys(self.iteration + i), None)
                    out.append(loss)
                losses_k = torch.stack(out)
            scope.sync(losses_k)
        self._compute = None           # output() and the engine read new weights
        self._last_score = losses_k if k > 1 else losses_k[0]
        self.last_batch_size = batches[-1].num_examples
        self.iteration += k

    def _run_steps_cuda(self, batches: list) -> torch.Tensor:
        staged = _Staged(self, batches)
        out = torch.empty(len(batches), dtype=torch.float32, device=self.device)
        first = 0
        if self.capture_steps:
            sig = tuple(None if t is None else (tuple(t.shape), t.dtype)
                        for t in staged.step(0))
            prog = self._captured.get(sig)
            if prog is None:
                prog = self._captured[sig] = self._capture(staged.step(0))
                first = 1
                out[0].copy_(prog.inputs[-1])
                self.opt_state = advance_counts(self.opt_state)
            rec = self._step_program()._cost_record
        for i in range(first, len(batches)):
            if not self.capture_steps:
                out[i].copy_(self._train_step(*staged.step(i))[0])
            else:
                for dst, src in zip(prog.inputs, staged.step(i)):
                    if dst is not None:
                        dst.copy_(src)
                prog.replay()
                out[i].copy_(prog.inputs[-1])
                self._cost_program = rec
                rec.dispatches += 1
            self.opt_state = advance_counts(self.opt_state)
        return out

    def _capture(self, inputs: tuple):
        """The step program as a CUDA graph over static copies of
        ``inputs`` (a staged step's), in the pool and on the stream of
        the model's other step graphs.  Its warm-up (`CapturedProgram`)
        is that step itself, run eagerly on the capture stream, and
        counts as the step's dispatch; the capture records the step
        without running it, so it calls the bare `_grad_step`.  Every
        run's loss lands in the last input, a static slot."""
        from deeplearning4j_tpu_torch.runtime.graphs import CapturedProgram

        def step(features, labels, lmask, fmask, keys, vals, slot):
            bare = torch.cuda.is_current_stream_capturing()
            slot.copy_(self._train_step(
                features, labels, lmask, fmask, keys, vals,
                grad_step=self._grad_step if bare else None)[0])

        inputs = tuple(None if t is None else t.clone() for t in inputs)
        slot = torch.empty((), dtype=torch.float32, device=self.device)
        other = next(iter(self._captured.values()), None)
        return CapturedProgram(
            step, inputs + (slot,), keep=(tree_leaves(self.params), self.opt_state,
                                          self.net_state),
            pool=other and other.graph.pool(), stream=other and other.stream)

    def fit(self, data, epochs: int = 1, batch_size: int | None = None,
            steps_per_execution: int = 1) -> None:
        """``epochs`` passes over ``data``: a DataSetIterator, a DataSet
        (split by ``batch_size`` when given), a list of DataSets or a
        (features, labels) tuple of arrays.  ``steps_per_execution`` K
        groups K batches of one shape into one staged run of K steps
        (graph replays on the card), each step with its own loss; a
        group of mixed shapes, and a short tail, step batch by batch."""
        if steps_per_execution < 1:
            raise ValueError(f"steps_per_execution must be >= 1, got "
                             f"{steps_per_execution}")
        if self.params is None:
            self.init()
        iterator = _as_iterator(data, batch_size)
        for _ in range(epochs):
            if steps_per_execution > 1:
                self._fit_epoch_multi(iterator, steps_per_execution)
            else:
                for batch in self._timed_batches(iterator):
                    self.fit_batch(batch)
            self.epoch += 1
            iterator.reset()

    def _fit_epoch_multi(self, iterator, spe: int) -> None:
        """JAX ``_fit_epoch_multi``: groups of ``spe`` batches.  A group
        stages its masks beside its batches; one whose shapes differ, or
        whose batches differ in having a mask, steps batch by batch (the
        JAX package steps every masked batch alone: the same steps)."""
        def sig(b):
            return tuple(None if a is None else np.shape(a) for a in (
                b.features, b.labels, b.features_mask, b.labels_mask))

        def group_ok(buf):
            return all(sig(b) == sig(buf[0]) for b in buf)

        buf: list[DataSet] = []
        for batch in self._timed_batches(iterator):
            buf.append(batch)
            if len(buf) == spe:
                if group_ok(buf):
                    self._run_steps(buf)
                else:
                    for b in buf:
                        self.fit_batch(b)
                buf = []
        for b in buf:                       # ragged tail group
            self.fit_batch(b)


def _clone_state(state):
    if isinstance(state, tuple):
        return tuple(_clone_state(s) for s in state)
    if isinstance(state, list):
        return [_clone_state(s) for s in state]
    if isinstance(state, torch.Tensor):
        return state.clone()
    return state
