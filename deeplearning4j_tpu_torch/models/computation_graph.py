"""`GraphModel` — `deeplearning4j_tpu/models/computation_graph.py`, the
ComputationGraph role: a DAG of layers and vertices
(`nn/conf/graph_conf.py`) with several inputs and outputs, trained as
one step.

The walk is the JAX package's: nodes in topological order, each layer
node on its first input (flattened where a feed-forward layer follows
convolutional maps), each vertex on all of its inputs.  An activation is
freed once the last node that reads it has run, so the forward holds no
more than autograd keeps for the backward.  Parameters and layer state
are keyed by the node's ``param_key`` (its name unless shared): nodes
of one key read, and train, one set, initialised once from
``stream.key("init/<key>")`` and penalised once.  In training, node i
of the order draws its dropout from ``fold_in(fold(root, step), i)``,
as the JAX package folds it, so a seed gives its weights and masks.

Training is the model base's (`models/model.py`): the step's device
inputs are the batch's features, then its labels, then its labels'
masks (None where a batch has none); the objective is the sum over the
network outputs of each output layer's loss (on logits through the
fused softmax where the activation is the loss's own; a head with
``compute_loss_with_params`` computes its own), plus the l1 / l2
penalty and the layers' auxiliary losses.  On the card the step is one
CUDA graph for each batch signature; ``capture_steps = False`` runs the
same program eagerly.  A graph step takes no features masks (the JAX
package's graph step has none).

``output(*features)`` runs as the cost registry's ``("infer",)``
program (``"int8"`` appended for a quantized tree): the activated
outputs in f32, one tensor a network output (a tuple when there are
several).  A quantized graph's Dense and output heads run B5
(`quant/functional.py`); its convolutions dequantize their kernels.

Frozen layer nodes (`train/transfer.py` ``GraphBuilder``) train as in
the model base: only the trainable leaves are differentiated and
updated.

The device data pipeline (`datavec/device.py`) fuses into the
single-input, single-output graph's per-batch step, as in the JAX
package: a raw `DataSet` runs the chain as the step's first stage
(`_fit_batch_fused`; the decode's labels mask feeds the output's loss,
its features mask is dropped: a graph step takes none).  A grouped fit
(``steps_per_execution`` > 1) and a graph of several inputs or outputs
keep host transforms, the reason logged and counted.

Not ported yet, raising where it is asked for: layerwise pretraining
(A13).
"""

from __future__ import annotations

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models._cast import entry_cast
from deeplearning4j_tpu_torch.models._common import (
    pop_aux_losses,
    regularization_loss,
    resolve_output_spec,
)
from deeplearning4j_tpu_torch.models.model import Model, as_tensor
from deeplearning4j_tpu_torch.nn import losses
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.updaters import with_gradient_clipping
from deeplearning4j_tpu_torch.parallel import context as dp_context
from deeplearning4j_tpu_torch.runtime import rng
from deeplearning4j_tpu_torch.runtime.backend import backend, resolve_device


class GraphModel(Model):
    """A computation graph on one device (``"cuda"`` by default)."""

    def __init__(self, conf: GraphConfiguration, device=None):
        super().__init__()
        if not isinstance(conf, GraphConfiguration):
            raise TypeError(f"GraphModel needs a GraphConfiguration, got "
                            f"{type(conf).__name__}")
        conf.check_supported()
        self.conf = conf
        self.device = resolve_device(device)
        self._topo = conf.topological_order()
        self._types, self._flatten = conf.infer_types()
        self._by_name = {n.name: n for n in conf.nodes}
        self._out_specs = self._resolve_outputs()
        self._bf16 = (conf.bf16_compute if conf.bf16_compute is not None
                      else backend(self.device).is_cuda)
        self._tx = with_gradient_clipping(
            conf.updater.to_tx(conf.steps_per_epoch), conf.gradient_clip_value,
            conf.gradient_clip_norm)
        self._stream = rng.SeedStream(conf.seed)
        self.f32_layers = frozenset(n.pkey for n in conf.nodes
                                    if n.layer is not None and n.layer.F32_PARAMS)
        # frozen layer nodes take no update; the mask is by node name over
        # the tree's keys, as JAX mask_frozen_tx masks it
        self._frozen = frozenset(n.name for n in conf.nodes
                                 if n.layer is not None and n.layer.frozen)
        # the position in the order after which each activation is dead
        outputs = set(conf.network_outputs)
        last = {}
        for i, node in enumerate(self._topo):
            for name in node.inputs:
                last[name] = i
        self._free_after = [[n for n in dict.fromkeys(node.inputs)
                             if last[n] == i and n not in outputs]
                            for i, node in enumerate(self._topo)]

    # -- construction ------------------------------------------------------
    def _resolve_outputs(self) -> list:
        """(loss, activation, fused, custom) for each network output, in
        declared order; ``custom`` is a head's own loss
        (``compute_loss_with_params``), which takes its node's
        parameters."""
        specs = []
        for out in self.conf.network_outputs:
            layer = self._by_name[out].layer
            if layer is not None and hasattr(layer, "compute_loss_with_params"):
                specs.append((None, Activation.IDENTITY, False,
                              layer.compute_loss_with_params))
                continue
            if layer is None or not hasattr(layer, "loss"):
                raise ValueError(f"network output {out!r} must be an OutputLayer/"
                                 "RnnOutputLayer/LossLayer")
            specs.append(resolve_output_spec(layer) + (None,))
        return specs

    def _layer_itype(self, node) -> InputType:
        """A layer node's input type, after the implicit flatten."""
        t = self._types[node.inputs[0]]
        if self._flatten[node.name]:
            t = InputType.feed_forward(t.flat_size)
        return t

    @torch.no_grad()
    def init(self) -> "GraphModel":
        """Random weights from ``conf.seed`` on the model's device (the
        JAX package's, bit for bit), and the layers' initial state; a
        shared ``param_key`` initialises once."""
        params, state = {}, {}
        for node in self._topo:
            if node.pkey in params or node.pkey in state:
                continue
            key = self._stream.key(f"init/{node.pkey}")
            if node.layer is None:
                if node.vertex.HAS_PARAMS:
                    p = node.vertex.init(key, [self._types[i] for i in node.inputs],
                                         self.device)
                    if p:
                        params[node.pkey] = p
                continue
            p, s = node.layer.init(key, self._layer_itype(node), self.device)
            if p:
                params[node.pkey] = p
            if s:
                state[node.pkey] = s
        self._install(params)
        self.net_state = state
        return self

    # -- the forward -------------------------------------------------------
    def _layer_keys(self, step: int) -> list:
        """The dropout keys of step ``step``: node i's (topological order)
        is ``fold_in(fold(root, step), i)``."""
        key = rng.SeedStream.fold(self._stream.root, step)
        return [rng.fold_in(key, i) for i in range(len(self._topo))]

    def _forward(self, params: dict, net_state: dict, features, *,
                 training: bool = False, keys=None):
        """The graph on ``params`` (in the compute dtype) and
        ``net_state``; ``features`` one array a network input.  Returns
        (the outputs in declared order, the new state of the layers that
        have one: a shared layer's last call wins)."""
        with self.mesh_scope(params):
            return self._run_nodes(params, net_state, features, training, keys)

    def _run_nodes(self, params, net_state, features, training, keys):
        acts = {name: entry_cast(as_tensor(x, self.device), self.compute_dtype)
                for name, x in zip(self.conf.network_inputs, features)}
        new_state = {}
        for i, node in enumerate(self._topo):
            xs = [acts[n] for n in node.inputs]
            key = keys[i] if keys is not None else None
            if node.layer is not None:
                x = xs[0]
                if self._flatten[node.name]:
                    x = x.reshape(x.shape[0], -1)
                y, ns = node.layer.apply(params.get(node.pkey, {}),
                                         net_state.get(node.pkey, {}), x,
                                         training=training, rng=key)
                if ns:
                    new_state[node.pkey] = ns
            elif node.vertex.HAS_PARAMS:
                y = node.vertex.apply(xs, params=params.get(node.pkey, {}),
                                      training=training, rng=key)
            else:
                y = node.vertex.apply(xs)
            acts[node.name] = y
            for name in self._free_after[i]:
                del acts[name]
        return [acts[o] for o in self.conf.network_outputs], new_state

    def _outputs_loss(self, params: dict, outs, labels, lmasks):
        """The data loss summed over the network outputs, f32."""
        total = 0.0
        for (loss, act, fused, custom), oname, out, lab, m in zip(
                self._out_specs, self.conf.network_outputs, outs, labels, lmasks):
            lab = as_tensor(lab, self.device)
            if m is not None:
                m = as_tensor(m, self.device)
            if custom is not None:
                total = total + custom(params.get(oname, {}), out, lab, m)
                continue
            if not fused:
                out = act(out.float())
            total = total + losses.compute(loss, out, lab, m, from_logits=fused)
        return total

    def _reg_loss(self, params: dict):
        seen, named = set(), []
        for n in self.conf.nodes:
            if n.pkey in seen:
                continue
            seen.add(n.pkey)
            if n.layer is not None:
                named.append((n.pkey, n.layer))
            elif n.vertex.HAS_PARAMS:
                named.append((n.pkey, n.vertex))
        return regularization_loss(params, named, self._split_axes(params))

    # -- the batch ---------------------------------------------------------
    def _as_mds(self, batch) -> MultiDataSet:
        if isinstance(batch, MultiDataSet):
            return batch
        if isinstance(batch, DataSet):
            return MultiDataSet.from_dataset(batch)
        raise TypeError(f"cannot interpret {type(batch)} as a graph batch")

    def _check_mds(self, mds: MultiDataSet) -> None:
        if len(mds.features) != len(self.conf.network_inputs):
            raise ValueError(
                f"graph has {len(self.conf.network_inputs)} inputs, batch has "
                f"{len(mds.features)} feature arrays")
        if len(mds.labels) != len(self.conf.network_outputs):
            raise ValueError(
                f"graph has {len(self.conf.network_outputs)} outputs, batch has "
                f"{len(mds.labels)} label arrays")
        masks = mds.labels_masks
        if masks is not None and len(masks) != len(mds.labels):
            raise ValueError(
                f"labels_masks has {len(masks)} entries for {len(mds.labels)} "
                "outputs (one mask per output, use None entries for unmasked)")

    def _as_batch(self, batch) -> MultiDataSet:
        mds = self._as_mds(batch)
        self._check_mds(mds)
        return mds

    def _batch_arrays(self, mds: MultiDataSet) -> tuple:
        masks = mds.labels_masks or (None,) * len(mds.labels)
        return tuple(mds.features) + tuple(mds.labels) + tuple(masks)

    @staticmethod
    def _decoded_arrays(feats, labs, fmask, lmask) -> tuple:
        return (feats, labs, lmask)

    def _fused_decode_reason(self, steps_per_execution: int = 1) -> str | None:
        """JAX ``GraphModel.fit``'s refusals: the grouped fit and a graph
        of several inputs or outputs keep host transforms."""
        if steps_per_execution > 1 and self._batch_sharding is None:
            return "graph grouped (steps_per_execution) fit path"
        if len(self.conf.network_inputs) != 1 or len(self.conf.network_outputs) != 1:
            return "multi-input/output graph"
        return None

    def _split(self, arrays) -> tuple:
        n_in, n_out = len(self.conf.network_inputs), len(self.conf.network_outputs)
        return (arrays[:n_in], arrays[n_in:n_in + n_out],
                arrays[n_in + n_out:n_in + 2 * n_out])

    @staticmethod
    def _as_iterator(data, batch_size: int | None = None):
        """``fit`` / ``evaluate`` input as an iterable of batches: a
        `DataSet`, a `MultiDataSet`, a (features, labels) tuple of arrays
        or any iterable of batches."""
        if isinstance(data, (DataSet, MultiDataSet)):
            return [data]
        if (isinstance(data, tuple) and len(data) == 2
                and all(isinstance(a, np.ndarray) for a in data)):
            from deeplearning4j_tpu_torch.data.iterator import NumpyDataSetIterator

            return NumpyDataSetIterator(data[0], data[1], batch_size or 32)
        if hasattr(data, "__iter__"):
            return data
        raise TypeError(f"cannot interpret {type(data)} as graph training data")

    # -- training ----------------------------------------------------------
    def _step_loss(self, params: dict, net_state: dict, *inputs):
        """The step's objective on the f32 masters ``params`` (the layers
        see them cast to the compute dtype inside the graph): the
        outputs' losses + l1 / l2 penalty + the layers' auxiliary losses
        (under data parallelism the rank's share of the last two).
        ``inputs``: `_batch_arrays`, then the keys.  Returns (loss, the
        layers' new state)."""
        *arrays, keys = inputs
        feats, labels, lmasks = self._split(arrays)
        outs, new_state = self._forward(self.cast_tree(params, detach=False),
                                        net_state, feats, training=True, keys=keys)
        with self.mesh_scope(params):
            data = self._outputs_loss(params, outs, labels, lmasks)
        aux, new_state = pop_aux_losses(new_state)
        reg, aux = dp_context.replica_share(self._reg_loss(params), aux)
        return data + reg + aux, new_state

    def pretrain(self, data, epochs: int = 1) -> None:
        raise NotImplementedError(
            "layerwise pretraining is not ported yet (ROADMAP A13: "
            "AutoEncoder / VariationalAutoencoder)")

    def pretrain_layer(self, name: str, data, epochs: int = 1) -> float:
        raise NotImplementedError(
            "layerwise pretraining is not ported yet (ROADMAP A13: "
            "AutoEncoder / VariationalAutoencoder)")

    # -- inference ---------------------------------------------------------
    @torch.no_grad()
    def output(self, *features):
        """Activated outputs in f32 for one array a network input: a
        tensor, or a tuple of them for several network outputs."""
        if self.params is None:
            self.init()
        if len(features) != len(self.conf.network_inputs):
            raise ValueError(
                f"graph has {len(self.conf.network_inputs)} inputs "
                f"{self.conf.network_inputs}, got {len(features)} arrays")
        outs = self._infer_program()(self.compute_params(), self.net_state,
                                     *features)
        return outs if len(outs) > 1 else outs[0]

    def _infer_program(self):
        """`_infer`, registered with the cost registry on first use
        (``("infer",)``, plus ``"int8"`` for a quantized tree)."""
        key = ("infer",) + (("int8",) if self._quantized is not None else ())
        fn = self._step_fns.get(key)
        if fn is None:
            from deeplearning4j_tpu_torch.observe import cost

            fn = self._step_fns[key] = cost.register_step_program(
                self, key, self._infer)
        return fn

    def _infer(self, params: dict, net_state: dict, *features) -> tuple:
        """The ``output()`` program: the graph on ``params`` and each
        output's activation, in f32.  Pure."""
        xs = [as_tensor(x, self.device) for x in features]
        with self.program_run("infer", *((tuple(x.shape), x.dtype) for x in xs)):
            outs, _ = self._forward(params, net_state, xs)
        return tuple(act(o.float()) for (_, act, _, _), o in zip(self._out_specs, outs))

    def predict(self, *features) -> np.ndarray:
        """Argmax class predictions of the first output."""
        out = self.output(*features)
        first = out[0] if isinstance(out, tuple) else out
        return first.argmax(dim=-1).cpu().numpy()

    def evaluate(self, data, output_index: int = 0):
        """`Evaluation` of output ``output_index`` over ``data``."""
        from deeplearning4j_tpu_torch.evaluation.evaluation import Evaluation

        ev = Evaluation()
        out_layer = self._by_name[self.conf.network_outputs[output_index]].layer
        for batch in self._as_iterator(data):
            mds = self._as_mds(batch)
            out = self.output(*mds.features)
            arr = out[output_index] if isinstance(out, tuple) else out
            if out_layer is not None and hasattr(out_layer, "evaluation_output"):
                params = self.compute_params()
                with self.mesh_scope(params):
                    arr = out_layer.evaluation_output(
                        params.get(out_layer.name, {}), arr)
            mask = None if mds.labels_masks is None else mds.labels_masks[output_index]
            ev.eval(np.asarray(mds.labels[output_index]), arr.float().cpu().numpy(),
                    mask=mask)
        return ev

    @torch.no_grad()
    def score(self, batch) -> float:
        """Loss, penalty included, on a batch, inference mode, nothing
        updated."""
        if self.params is None:
            self.init()
        mds = self._as_mds(batch)
        with self.mesh_scope(self.params):
            outs, _ = self._forward(self.compute_params(), self.net_state,
                                    mds.features)
            masks = mds.labels_masks or (None,) * len(mds.labels)
            loss = self._outputs_loss(self.params, outs, mds.labels, masks)
            return float(loss + self._reg_loss(self.params))
