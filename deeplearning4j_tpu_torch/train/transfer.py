"""Transfer learning — `deeplearning4j_tpu/train/transfer.py`, the
`org.deeplearning4j.nn.transferlearning` role.

Reference parity (eclipse/deeplearning4j, `deeplearning4j-nn`, classes
`TransferLearning.Builder` / `TransferLearning.GraphBuilder`,
`TransferLearningHelper`, `FrozenLayer`): rebuild a trained model with
layers frozen up to a boundary (`setFeatureExtractor`), output heads
replaced (`nOutReplace`, `removeOutputLayer`/`addLayer`), and fine-tune
overrides (updater/seed), copying pretrained params for every retained
layer.  A frozen layer is ``frozen=True`` on its config: the training
step differentiates only the trainable leaves, so the frozen layers get
no gradient, no update and no optimizer state, and a frozen prefix runs
forward only (`models/model.py`).  As in the JAX package the forward is
unchanged: a frozen BatchNorm still updates its running statistics in
training mode and a frozen layer's dropout still applies (the
reference's `FrozenLayer` runs them in inference mode).  The new model
is built on the old one's device, its retained tensors copies of the
old ones.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphNode
from deeplearning4j_tpu_torch.nn.conf.layers import LayerConfig
from deeplearning4j_tpu_torch.nn.updaters import Updater


def _copies(table: dict) -> dict:
    return {k: _copies(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in table.items()}


def _shapes_match(old: dict, new: dict) -> bool:
    return set(old) == set(new) and all(
        _shapes_match(old[k], new[k]) if isinstance(new[k], dict)
        else tuple(old[k].shape) == tuple(new[k].shape) for k in new)


def _copy_retained_params(new_model, old_params: dict, old_state: dict | None,
                          reinit: set[str]) -> None:
    """Copy the old model's parameter tensors (and its layer state, such
    as BatchNorm's running statistics) into the new model wherever the
    layer name is retained, not marked for re-init, and every shape
    matches.  The tensors are copies: the two models must not share
    storage, or one model's in-place step would train the other's."""
    tree = new_model.params
    tree = {name: (_copies(old_params[name]) if name not in reinit
                   and name in old_params and _shapes_match(old_params[name], table)
                   else table)
            for name, table in tree.items()}
    new_model._install(tree)
    if new_model.net_state and old_state:
        new_model.net_state = {
            name: (_copies(old_state[name]) if name not in reinit
                   and name in old_state and _shapes_match(old_state[name], table)
                   else table)
            for name, table in new_model.net_state.items()}


@dataclasses.dataclass
class FineTuneConfiguration:
    """Overrides applied to the rebuilt config (FineTuneConfiguration role)."""

    updater: Optional[Updater] = None
    seed: Optional[int] = None

    def apply(self, conf):
        updates = {}
        if self.updater is not None:
            updates["updater"] = self.updater
        if self.seed is not None:
            updates["seed"] = self.seed
        return dataclasses.replace(conf, **updates) if updates else conf


class TransferLearning:
    """Namespace matching the reference: `TransferLearning.Builder(model)`
    for SequentialModel, `TransferLearning.GraphBuilder(model)` for
    GraphModel."""

    class Builder:
        def __init__(self, model):
            if model.params is None:
                raise ValueError("transfer learning requires an initialized model")
            self._model = model
            self._layers: list[LayerConfig] = list(model.conf.layers)
            self._fine_tune = FineTuneConfiguration()
            self._freeze_until: Optional[int] = None
            self._reinit: set[str] = set()

        # -- configuration -------------------------------------------------
        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def _index_of(self, layer) -> int:
            if isinstance(layer, int):
                return layer if layer >= 0 else len(self._layers) + layer
            for i, l in enumerate(self._layers):
                if l.name == layer:
                    return i
            raise ValueError(f"no layer named {layer!r}")

        def set_feature_extractor(self, layer) -> "TransferLearning.Builder":
            """Freeze all layers up to and including `layer` (index or name)."""
            self._freeze_until = self._index_of(layer)
            return self

        def n_out_replace(
            self, layer, n_out: int, weight_init=None
        ) -> "TransferLearning.Builder":
            """Change a layer's n_out; that layer and the next parameterized
            layer are re-initialized (their shapes change)."""
            i = self._index_of(layer)
            updates = {"n_out": n_out}
            if weight_init is not None:
                updates["weight_init"] = weight_init
            self._layers[i] = dataclasses.replace(self._layers[i], **updates)
            self._reinit.add(self._layers[i].name)
            for j in range(i + 1, len(self._layers)):
                if hasattr(self._layers[j], "n_out") or self._layers[j].HAS_PARAMS:
                    self._reinit.add(self._layers[j].name)
                    break
            return self

        def remove_output_layer(self) -> "TransferLearning.Builder":
            self._layers.pop()
            return self

        def remove_layers_from_output(self, n: int) -> "TransferLearning.Builder":
            del self._layers[len(self._layers) - n :]
            return self

        def add_layer(self, layer: LayerConfig) -> "TransferLearning.Builder":
            if layer.name is None:
                layer = dataclasses.replace(layer, name=f"layer{len(self._layers)}")
            self._layers.append(layer)
            self._reinit.add(layer.name)
            return self

        # -- build ---------------------------------------------------------
        def build(self):
            from deeplearning4j_tpu_torch.models.sequential import SequentialModel

            layers = list(self._layers)
            if self._freeze_until is not None:
                for i in range(self._freeze_until + 1):
                    layers[i] = dataclasses.replace(layers[i], frozen=True)
            conf = dataclasses.replace(self._model.conf, layers=tuple(layers))
            conf = self._fine_tune.apply(conf)
            new_model = SequentialModel(conf, device=self._model.device).init()
            _copy_retained_params(
                new_model, self._model.params, self._model.net_state, self._reinit
            )
            return new_model

    class GraphBuilder:
        def __init__(self, model):
            if model.params is None:
                raise ValueError("transfer learning requires an initialized model")
            self._model = model
            self._nodes: dict[str, GraphNode] = {n.name: n for n in model.conf.nodes}
            self._order: list[str] = [n.name for n in model.conf.nodes]
            self._outputs: list[str] = list(model.conf.network_outputs)
            self._fine_tune = FineTuneConfiguration()
            self._frozen: set[str] = set()
            self._reinit: set[str] = set()

        def fine_tune_configuration(self, ftc: FineTuneConfiguration):
            self._fine_tune = ftc
            return self

        def set_feature_extractor(self, *vertex_names: str):
            """Freeze the named vertices and all their ancestors."""
            pending = list(vertex_names)
            while pending:
                name = pending.pop()
                if name in self._frozen or name not in self._nodes:
                    continue
                self._frozen.add(name)
                pending.extend(self._nodes[name].inputs)
            return self

        def n_out_replace(self, layer_name: str, n_out: int, weight_init=None):
            node = self._nodes[layer_name]
            if node.layer is None:
                raise ValueError(f"{layer_name!r} is not a layer vertex")
            updates = {"n_out": n_out}
            if weight_init is not None:
                updates["weight_init"] = weight_init
            self._nodes[layer_name] = dataclasses.replace(
                node, layer=dataclasses.replace(node.layer, **updates)
            )
            self._reinit.add(layer_name)
            # consumers' input width changes -> they need re-init too
            for other in self._nodes.values():
                if layer_name in other.inputs and other.layer is not None:
                    self._reinit.add(other.name)
            return self

        def remove_vertex_and_connections(self, name: str):
            """Drop a vertex and every vertex downstream of it."""
            doomed = {name}
            changed = True
            while changed:
                changed = False
                for n in self._nodes.values():
                    if n.name not in doomed and any(i in doomed for i in n.inputs):
                        doomed.add(n.name)
                        changed = True
            for d in doomed:
                self._nodes.pop(d, None)
                if d in self._order:
                    self._order.remove(d)
            self._outputs = [o for o in self._outputs if o not in doomed]
            return self

        def add_layer(self, name: str, layer: LayerConfig, *inputs: str):
            if layer.name is None:
                layer = dataclasses.replace(layer, name=name)
            self._nodes[name] = GraphNode(name=name, inputs=tuple(inputs), layer=layer)
            self._order.append(name)
            self._reinit.add(name)
            return self

        def add_vertex(self, name: str, vertex, *inputs: str):
            self._nodes[name] = GraphNode(name=name, inputs=tuple(inputs), vertex=vertex)
            self._order.append(name)
            return self

        def set_outputs(self, *names: str):
            self._outputs = list(names)
            return self

        def build(self):
            from deeplearning4j_tpu_torch.models.computation_graph import GraphModel

            nodes = []
            for name in self._order:
                node = self._nodes[name]
                if node.layer is not None and name in self._frozen:
                    node = dataclasses.replace(
                        node, layer=dataclasses.replace(node.layer, frozen=True)
                    )
                nodes.append(node)
            conf = dataclasses.replace(
                self._model.conf,
                nodes=tuple(nodes),
                network_outputs=tuple(self._outputs),
            )
            conf = self._fine_tune.apply(conf)
            new_model = GraphModel(conf, device=self._model.device).init()
            _copy_retained_params(
                new_model, self._model.params, self._model.net_state, self._reinit
            )
            return new_model


class TransferLearningHelper:
    """`TransferLearningHelper` role: split a model at the frozen boundary,
    featurize datasets through the frozen bottom once, and train only the
    unfrozen top — saving recompute when the frozen part dominates."""

    def __init__(self, model, frozen_until=None):
        from deeplearning4j_tpu_torch.models.sequential import SequentialModel

        if not isinstance(model, SequentialModel):
            raise TypeError("TransferLearningHelper supports SequentialModel")
        self._orig = model
        if frozen_until is None:
            frozen_flags = [l.frozen for l in model.conf.layers]
            if not any(frozen_flags):
                raise ValueError("model has no frozen layers and no frozen_until given")
            frozen_until = max(i for i, f in enumerate(frozen_flags) if f)
        elif not isinstance(frozen_until, int):
            frozen_until = [l.name for l in model.conf.layers].index(frozen_until)
        self._split = frozen_until
        self._build_tail()

    def _build_tail(self):
        from deeplearning4j_tpu_torch.models.sequential import SequentialModel

        conf = self._orig.conf
        tail_layers = tuple(
            dataclasses.replace(l, frozen=False) for l in conf.layers[self._split + 1:]
        )
        boundary_type = conf.layer_input_types()[self._split + 1]
        tail_conf = dataclasses.replace(conf, layers=tail_layers,
                                        input_type=boundary_type)
        self.unfrozen_model = SequentialModel(tail_conf,
                                              device=self._orig.device).init()
        tree = self.unfrozen_model.params
        orig = self._orig.params
        self.unfrozen_model._install({
            name: _copies(orig[name]) if name in orig else table
            for name, table in tree.items()})
        orig_state = self._orig.net_state
        self.unfrozen_model.net_state = {
            name: _copies(orig_state[name]) if name in orig_state else table
            for name, table in self.unfrozen_model.net_state.items()}

    def featurize(self, ds):
        """Run a DataSet through the frozen bottom; returns a DataSet whose
        features are the boundary activations (f32 on the host).  If an
        implicit CNN->FF flatten sits at the boundary (the tail's
        input_type is the post-flatten feed-forward type), the
        activations are flattened here so they match what the tail model
        expects."""
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        acts = self._orig.feed_forward(ds.features)[self._split]
        acts = acts.float().cpu().numpy()
        if self._orig.conf.flatten_flags()[self._split + 1]:
            acts = acts.reshape(acts.shape[0], -1)
        return DataSet(acts, ds.labels, labels_mask=ds.labels_mask)

    def fit_featurized(self, ds_or_iter, epochs: int = 1) -> None:
        self.unfrozen_model.fit(ds_or_iter, epochs=epochs)

    def output_from_featurized(self, features):
        return self.unfrozen_model.output(features)

    def unfrozen_graph(self):
        return self.unfrozen_model

    @torch.no_grad()
    def to_full_model(self):
        """Merge the trained top back into a copy of the full model."""
        full = self._orig.clone()
        tree, opt_state = full.params, full.opt_state
        top = self.unfrozen_model.params
        full._install({name: _copies(top[name]) if name in top else table
                       for name, table in tree.items()})
        full.opt_state = opt_state
        state = dict(full.net_state)
        state.update({name: _copies(t)
                      for name, t in self.unfrozen_model.net_state.items()})
        full.net_state = state
        return full
