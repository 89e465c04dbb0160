"""`SequentialModel` — `deeplearning4j_tpu/models/sequential.py` for the
transformer stack: inference (``output``) and training (``fit``,
``fit_batch``).

The model is an `nn.Module` on one explicit device.  Its parameters keep
the JAX package's tree: ``model.params["layer2"]["attn"]["Wq"]`` is the
same (n_in, n_out) array there and here, so weights carry across by
layer name (`convert.params_from_jax`).  They are f32 master weights.
The compute dtype (bf16 on CUDA, f32 on the CPU, or
``conf.bf16_compute``) applies to a cast of the tree: for inference a
detached copy made once and cached (`compute_params`); for training a
cast inside the autograd graph at every step, so the gradients land on
the f32 masters.

A quantized model (`quant.quantize`, or `load_params` of a tree with
`QuantizedTensor` leaves) holds each int8 weight and its f32 scales as
buffers and computes in f32, whatever the bf16 setting says: that is
what the JAX package computes, since its quantized embedding returns f32
rows and every later layer follows ``x.dtype``.  It takes no training
step.  ``output()`` runs as a program registered with the cost registry
under the JAX package's key (``("infer", False)``, plus ``"int8"`` for a
quantized model), and a quantized site counts its implementation once a
program signature (`program_run`, `ops/dequant_matmul.py`).

A training step is the JAX step written out eagerly: forward, data loss
(the output layer's own loss, or a loss of `nn/losses.py`), plus the
l1 / l2 penalty, backward, clipping and the updater (`nn/updaters.py`,
optax's arithmetic), applied in place.

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
from deeplearning4j_tpu_torch.models._common import (
    regularization_loss,
    resolve_output_spec,
)
from deeplearning4j_tpu_torch.nn import losses
from deeplearning4j_tpu_torch.nn.updaters import with_gradient_clipping
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


def compute_tree(tree: dict, dtype: torch.dtype) -> dict:
    """``tree`` detached and cast to the compute ``dtype``; `QuantizedTensor`
    leaves stay as they are (a quantized model computes in f32)."""
    return _tree_map(lambda t: t if isinstance(t, QuantizedTensor)
                     else t.detach().to(dtype), tree)


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


class SequentialModel(nn.Module):
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
        self.layers = nn.ModuleDict()
        self._compute = None
        self._quantized = None         # the scheme marker of a quantized tree
        self.opt_state = None
        self.iteration = 0
        self.epoch = 0
        self._last_score = None
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

    @torch.no_grad()
    def init(self) -> "SequentialModel":
        """Random weights from ``conf.seed``, drawn on the model's device:
        the JAX package's, bit for bit."""
        tree = {}
        sizes = self.conf.layer_input_sizes()
        for layer, n_in in zip(self.conf.layers, sizes):
            p = layer.init(self._stream.key(f"init/{layer.name}"), n_in,
                           self.device)
            if p:
                tree[layer.name] = p
        self._install(tree)
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
        want = self.params

        def walk(w, got, path):
            if set(w) != set(got):
                raise ValueError(
                    f"parameter names differ at {path or '<root>'}: "
                    f"want {sorted(w)}, got {sorted(got)}")
            out = {}
            for k, v in w.items():
                p = f"{path}/{k}" if path else k
                if isinstance(v, dict):
                    out[k] = walk(v, got[k], p)
                    continue
                t = got[k]
                if hasattr(t, "q") and hasattr(t, "scale"):
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

        self._install(walk(want, tree, ""))
        return self

    def _install(self, tree: dict) -> None:
        tree = _tree_map(lambda t: t.to(self.device), tree)
        self.layers = nn.ModuleDict(
            {name: ParamTree(p) for name, p in tree.items()})
        self._compute = None
        self.opt_state = None          # moments belong to the old tensors
        self._quantized = ({"scheme": SCHEME} if _has_quantized(tree)
                           else None)

    def compute_params(self) -> dict:
        """The parameter tree in the compute dtype, detached (cached;
        rebuilt after `init`, `load_params` and every training step).
        `QuantizedTensor` leaves stay as they are."""
        if self._compute is None:
            self._compute = compute_tree(self.params, self.compute_dtype)
        return self._compute

    def _forward(self, params: dict, features, *, training: bool = False,
                 key=None) -> torch.Tensor:
        """The layer stack on ``params`` (already in the compute dtype).
        Float features take the compute dtype, as the JAX package's
        ``entry_cast`` does; integer ids pass through.  In training,
        layer i draws its dropout from ``fold_in(key, i)``."""
        x = as_tensor(features, self.device)
        if x.is_floating_point():
            x = x.to(self.compute_dtype)
        for i, layer in enumerate(self.conf.layers):
            lkey = rng.fold_in(key, i) if key is not None else None
            x = layer.apply(params.get(layer.name, {}), x, training=training,
                            rng=lkey)
        return x

    @torch.no_grad()
    def output(self, features, params: dict | None = None) -> torch.Tensor:
        """Forward pass with the output activation applied, in f32
        (reference `MultiLayerNetwork.output()`): class probabilities for
        an `RnnOutputLayer` head, hidden states for a
        `ChunkedSoftmaxOutputLayer` head (its projection lives in the
        loss).  ``params``: a `compute_params()` tree to run on instead
        of the current one (a server's snapshot, taken under its weights
        lock)."""
        if self.params is None:
            self.init()
        return self._infer_program()(
            params if params is not None else self.compute_params(), features)

    def _infer_program(self):
        """`_infer`, registered with the cost registry on first use under
        the JAX package's key (``_get_infer_fn``: ``("infer", False)``,
        plus ``"int8"`` for a quantized tree)."""
        key = ("infer", False) + (("int8",) if self._quantized is not None else ())
        fn = self._step_fns.get(key)
        if fn is None:
            from deeplearning4j_tpu_torch.observe import cost

            fn = self._step_fns[key] = cost.register_step_program(
                self, key, self._infer)
        return fn

    def _infer(self, params: dict, features) -> torch.Tensor:
        """The ``output()`` program: the stack on ``params`` (compute
        dtype) and the output activation, in f32.  Pure."""
        x = as_tensor(features, self.device)
        with self.program_run("infer", tuple(x.shape), x.dtype):
            x = self._forward(params, x)
        return self.conf.layers[-1].output_activation()(x.float())

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

    def _step_loss(self, params: dict, features, labels, lmask=None, key=None):
        """Forward + data loss + l1 / l2 penalty on the f32 master tree
        ``params``: the layers see it cast to the compute dtype inside
        the graph; the output layer's own loss (the chunked head) and the
        penalty see the masters, as the JAX package's do."""
        dt = self.compute_dtype
        out = self._forward(_tree_map(lambda t: t.to(dt), params), features,
                            training=True, key=key)
        last = self.conf.layers[-1]
        labels = as_tensor(labels, self.device)
        if lmask is not None:
            lmask = as_tensor(lmask, self.device)
        if hasattr(last, "compute_loss_with_params"):
            data_loss = last.compute_loss_with_params(
                params.get(last.name, {}), out, labels, lmask)
        else:
            loss, act, fused = resolve_output_spec(last)
            if not fused:
                out = act(out.float())
            data_loss = losses.compute(loss, out, labels, lmask,
                                       from_logits=fused)
        return data_loss + self._reg_loss(params)

    def fit_batch(self, batch: DataSet) -> None:
        """One optimizer step on ``batch``."""
        if self.params is None:
            self.init()
        if self._quantized is not None:
            raise RuntimeError(
                "this model is int8-quantized for inference and takes no "
                "training step; train the f32 model, then quantize it again")
        self._check_trainable()
        if batch.features_mask is not None:
            raise NotImplementedError(
                "features masks (key masks in attention) are not ported to "
                "training yet (ROADMAP A5: SelfAttentionLayer)")
        params = self.params
        plist = tree_leaves(params)
        if self.opt_state is None:
            self.opt_state = self._tx.init(plist)
        key = rng.SeedStream.fold(self._stream.root, self.iteration)
        with step_scope(self) as scope:
            loss, grads = self._step_program()(
                params, batch.features, batch.labels, batch.labels_mask, key)
            scope.sync(loss)
            updates, self.opt_state = self._tx.update(grads, self.opt_state,
                                                      plist)
            with torch.no_grad():
                for p, u in zip(plist, updates):
                    p.add_(u.to(p.dtype))
        self._compute = None           # output() and the engine read new weights
        self._last_score = loss.detach()
        self.iteration += 1

    def _step_program(self):
        """The training step's device program, `_grad_step`, registered
        with the cost registry on first use (as the JAX package's
        ``_get_step_fn`` registers its jitted step)."""
        fn = self._step_fns.get(("train",))
        if fn is None:
            from deeplearning4j_tpu_torch.observe import cost

            fn = self._step_fns[("train",)] = cost.register_step_program(
                self, ("train",), self._grad_step)
        return fn

    def _grad_step(self, params: dict, features, labels, lmask, key):
        """Loss and gradients of ``params`` (``jax.tree.leaves`` order,
        zeros for an unused leaf) on one batch: the step's forward and
        backward, and no state changed — the optimizer update applies
        them.  Pure, so the cost analysis can run it again."""
        plist = tree_leaves(params)
        with torch.enable_grad():
            loss = self._step_loss(params, features, labels, lmask, key=key)
            grads = torch.autograd.grad(loss, plist, allow_unused=True)
        return loss, [torch.zeros_like(p) if g is None else g
                      for p, g in zip(plist, grads)]

    def fit(self, data, epochs: int = 1, batch_size: int | None = None,
            steps_per_execution: int = 1) -> None:
        """``epochs`` passes over ``data``: a DataSetIterator, a DataSet
        (split by ``batch_size`` when given), a list of DataSets or a
        (features, labels) tuple of arrays."""
        if steps_per_execution != 1:
            raise NotImplementedError(
                "steps_per_execution > 1 is not ported yet (ROADMAP A3: "
                "models/sequential.py grouped steps)")
        if self.params is None:
            self.init()
        iterator = _as_iterator(data, batch_size)
        for _ in range(epochs):
            for batch in iterator:
                self.fit_batch(batch)
            self.epoch += 1
            iterator.reset()

    @property
    def score_value(self) -> float:
        """Last training loss, penalty included (reference
        `Model.score()`); synchronises with the device."""
        if self._last_score is None:
            return float("nan")
        return float(self._last_score)
