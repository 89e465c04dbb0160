"""Graph (DAG) configuration — `deeplearning4j_tpu/nn/conf/graph_conf.py`,
the `ComputationGraphConfiguration` role.

Named nodes, each a layer or a structural vertex, with their inputs;
several network inputs and outputs; a topological order computed once;
type inference with the implicit CNN -> FF flatten; JSON both ways with
the JAX package's tags and fields.  The vertices are plain functions of
their input tensors (`MergeVertex` concatenates on the last axis,
`ElementWiseVertex` adds, subtracts, multiplies, averages or takes the
maximum — ResNet's skip connections are its ADD — and so on);
`AttentionVertex` has parameters and runs `apply_qkv_attention`, so an
unmasked self-attention vertex reaches the flash-forward kernel (B1) on
the card.  Its ``seq_parallel`` knob builds; a graph runs it densely
(distributing a graph over a seq axis raises, ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import LayerConfig
from deeplearning4j_tpu_torch.nn.updaters import Sgd, Updater
from deeplearning4j_tpu_torch.utils import serde


class ElementWiseOp(str, enum.Enum):
    ADD = "add"
    SUBTRACT = "subtract"
    PRODUCT = "product"
    AVERAGE = "average"
    MAX = "max"


@dataclasses.dataclass(frozen=True)
class VertexConfig:
    """Base graph vertex: a function of its input tensors.  A vertex with
    ``HAS_PARAMS`` also has ``init(key, itypes, device) -> params`` and
    takes ``params=`` in ``apply``."""

    HAS_PARAMS = False
    REGULARIZED = ()      # a class attribute, not a field (stays out of serde)

    def check_supported(self) -> None:
        """Raise `NotImplementedError`, naming the ROADMAP item, for a
        setting the port cannot honour yet (when a model is built)."""

    def output_type(self, itypes: list) -> InputType:
        raise NotImplementedError

    def init(self, key, itypes: list, device) -> dict:
        return {}

    def apply(self, xs: list, **kwargs):
        raise NotImplementedError

    def regularization_terms(self, lp: dict) -> list:
        """(l1, l2, array) triples: a vertex with parameters takes part in
        the l1 / l2 penalty as a layer does."""
        l1 = getattr(self, "l1", None) or 0.0
        l2 = getattr(self, "l2", None) or 0.0
        if not l1 and not l2:
            return []
        return [(l1, l2, lp[p]) for p in self.REGULARIZED if p in lp]


@serde.register
@dataclasses.dataclass(frozen=True)
class MergeVertex(VertexConfig):
    """Concatenate along the feature (last) axis.  A ``declared_axis``
    other than -1 (an imported configuration's positional trailing axis)
    is checked against the input rank and refused unless it is the
    trailing axis."""

    declared_axis: int = -1

    _RANK = {InputType.KIND_FF: 2, InputType.KIND_RNN: 3,
             InputType.KIND_CNN: 4, InputType.KIND_CNN3D: 5}

    def output_type(self, itypes):
        first = itypes[0]
        if self.declared_axis != -1:
            rank = self._RANK.get(first.kind, 2)
            norm = (self.declared_axis if self.declared_axis >= 0
                    else rank + self.declared_axis)
            if norm != rank - 1:
                raise ValueError(
                    f"MergeVertex concatenates the trailing axis only; "
                    f"declared axis {self.declared_axis} on rank-{rank} "
                    "input is not the trailing axis")
        if first.kind == InputType.KIND_FF:
            return InputType.feed_forward(sum(t.size for t in itypes))
        if first.kind == InputType.KIND_CNN:
            h, w, _ = first.shape
            for t in itypes[1:]:
                if t.shape[:2] != (h, w):
                    raise ValueError(f"MergeVertex spatial mismatch: {itypes}")
            return InputType.convolutional(h, w, sum(t.channels for t in itypes))
        if first.kind == InputType.KIND_RNN:
            return InputType.recurrent(sum(t.size for t in itypes), first.shape[0])
        raise ValueError(f"MergeVertex: unsupported {first}")

    def apply(self, xs, **kwargs):
        return torch.cat(xs, dim=-1)


@serde.register
@dataclasses.dataclass(frozen=True)
class ElementWiseVertex(VertexConfig):
    op: ElementWiseOp = ElementWiseOp.ADD

    def output_type(self, itypes):
        first = itypes[0]
        for t in itypes[1:]:
            if t.shape != first.shape:
                raise ValueError(f"ElementWiseVertex shape mismatch: {itypes}")
        return first

    def apply(self, xs, **kwargs):
        out = xs[0]
        for x in xs[1:]:
            if self.op in (ElementWiseOp.ADD, ElementWiseOp.AVERAGE):
                out = out + x
            elif self.op is ElementWiseOp.SUBTRACT:
                out = out - x
            elif self.op is ElementWiseOp.PRODUCT:
                out = out * x
            elif self.op is ElementWiseOp.MAX:
                out = torch.maximum(out, x)
            else:
                raise ValueError(f"unhandled {self.op}")
        if self.op is ElementWiseOp.AVERAGE:
            out = out / len(xs)
        return out


@serde.register
@dataclasses.dataclass(frozen=True)
class SubsetVertex(VertexConfig):
    """Feature range [frm, to], both ends included (reference SubsetVertex)."""

    frm: int = 0
    to: int = 0

    def output_type(self, itypes):
        t = itypes[0]
        n = self.to - self.frm + 1
        if t.kind == InputType.KIND_FF:
            return InputType.feed_forward(n)
        if t.kind == InputType.KIND_RNN:
            return InputType.recurrent(n, t.shape[0])
        if t.kind == InputType.KIND_CNN:
            return InputType.convolutional(t.shape[0], t.shape[1], n)
        raise ValueError(f"SubsetVertex: unsupported {t}")

    def apply(self, xs, **kwargs):
        return xs[0][..., self.frm: self.to + 1]


@serde.register
@dataclasses.dataclass(frozen=True)
class ScaleVertex(VertexConfig):
    scale: float = 1.0

    def output_type(self, itypes):
        return itypes[0]

    def apply(self, xs, **kwargs):
        x = xs[0]
        return x * torch.full((), self.scale, dtype=x.dtype, device=x.device)


@serde.register
@dataclasses.dataclass(frozen=True)
class L2NormalizeVertex(VertexConfig):
    epsilon: float = 1e-8

    def output_type(self, itypes):
        return itypes[0]

    def apply(self, xs, **kwargs):
        x = xs[0]
        n = torch.sqrt((x.float() ** 2).sum(dim=-1, keepdim=True))
        return x / torch.clamp(n, min=self.epsilon).to(x.dtype)


@serde.register
@dataclasses.dataclass(frozen=True)
class StackVertex(VertexConfig):
    """Stack inputs along the batch axis (reference StackVertex), the
    inverse of `UnstackVertex`."""

    def output_type(self, itypes):
        first = itypes[0]
        for t in itypes[1:]:
            if t.shape != first.shape:
                raise ValueError(f"StackVertex shape mismatch: {itypes}")
        return first

    def apply(self, xs, **kwargs):
        return torch.cat(xs, dim=0)


@serde.register
@dataclasses.dataclass(frozen=True)
class UnstackVertex(VertexConfig):
    """Chunk ``index`` of ``stack_size`` equal batch chunks (reference
    UnstackVertex)."""

    index: int = 0
    stack_size: int = 1

    def output_type(self, itypes):
        if not (0 <= self.index < self.stack_size):
            raise ValueError(f"UnstackVertex index {self.index} out of range "
                             f"for stack_size {self.stack_size}")
        return itypes[0]

    def apply(self, xs, **kwargs):
        x = xs[0]
        if x.shape[0] % self.stack_size:
            raise ValueError(f"UnstackVertex: batch {x.shape[0]} not divisible "
                             f"by stack_size {self.stack_size}")
        n = x.shape[0] // self.stack_size
        return x[self.index * n: (self.index + 1) * n]


@serde.register
@dataclasses.dataclass(frozen=True)
class ReshapeVertex(VertexConfig):
    """Reshape to a fixed per-example shape (reference ReshapeVertex); one
    -1 wildcard allowed."""

    shape: tuple[int, ...] = ()

    def output_type(self, itypes):
        t = itypes[0]
        s = list(self.shape)
        if sum(1 for d in s if d == -1) > 1:
            raise ValueError(f"ReshapeVertex: at most one -1 in {self.shape}")
        if -1 in s:
            fixed = 1
            for d in s:
                if d != -1:
                    fixed *= d
            if t.flat_size % fixed:
                raise ValueError(f"ReshapeVertex: cannot reshape {t.flat_size} "
                                 f"elements into {self.shape}")
            s[s.index(-1)] = t.flat_size // fixed
        if len(s) == 1:
            return InputType.feed_forward(s[0])
        if len(s) == 2:
            return InputType.recurrent(s[1], s[0])
        if len(s) == 3:
            return InputType.convolutional(s[0], s[1], s[2])
        raise ValueError(f"ReshapeVertex: unsupported target shape {s}")

    def apply(self, xs, **kwargs):
        x = xs[0]
        return x.reshape((x.shape[0],) + tuple(self.shape))


@serde.register
@dataclasses.dataclass(frozen=True)
class AttentionVertex(VertexConfig):
    """Multi-head dot-product attention over (queries, keys, values)
    inputs (the reference's AttentionVertex): 1 input is self-attention,
    2 are (q, kv), 3 are (q, k, v).  Projections Wq / Wk / Wv / Wo when
    ``project_input``.  No key mask reaches it, so self-attention at
    equal lengths goes to the flash kernel on the card."""

    n_out: int = 0
    n_heads: int = 1
    head_size: Optional[int] = None
    project_input: bool = True
    causal: bool = False
    seq_parallel: str = "none"
    weight_init: Optional[object] = None
    l1: Optional[float] = None
    l2: Optional[float] = None

    HAS_PARAMS = True
    REGULARIZED = ("Wq", "Wk", "Wv", "Wo")

    def check_supported(self) -> None:
        from deeplearning4j_tpu_torch.nn.conf.attention import _check_seq_parallel

        _check_seq_parallel(self.seq_parallel)

    def _head_size(self) -> int:
        from deeplearning4j_tpu_torch.nn.conf.attention import resolve_head_size

        return resolve_head_size(self.n_out, self.n_heads, self.head_size)

    def output_type(self, itypes):
        tq = itypes[0]
        if tq.kind != InputType.KIND_RNN:
            raise ValueError(f"AttentionVertex expects RNN inputs, got {tq}")
        if not self.project_input and self.n_out != self.n_heads * self._head_size():
            raise ValueError(
                "project_input=False requires n_out == n_heads*head_size "
                f"({self.n_heads}*{self._head_size()}), got {self.n_out}")
        return InputType.recurrent(self.n_out, tq.shape[0])

    def init(self, key, itypes, device):
        from deeplearning4j_tpu_torch.nn.conf.attention import init_qkv_params
        from deeplearning4j_tpu_torch.nn.weights import WeightInit

        tq = itypes[0]
        tk = itypes[1] if len(itypes) > 1 else tq
        tv = itypes[2] if len(itypes) > 2 else tk
        hd = self.n_heads * self._head_size()
        if not self.project_input:
            for t in (tq, tk, tv):
                if t.size != hd:
                    raise ValueError(
                        "project_input=False requires every input size == "
                        f"n_heads*head_size ({hd}), got {t.size}")
            return {}
        wi = self.weight_init if self.weight_init is not None else WeightInit.XAVIER
        if not isinstance(wi, WeightInit):
            wi = WeightInit(wi)
        return init_qkv_params(key, wi, tq.size, tk.size, tv.size, hd, self.n_out,
                               device)

    def apply(self, xs, params=None, **kwargs):
        from deeplearning4j_tpu_torch.nn.conf.attention import apply_qkv_attention

        xq = xs[0]
        xk = xs[1] if len(xs) > 1 else xq
        xv = xs[2] if len(xs) > 2 else xk
        return apply_qkv_attention(
            params or {}, xq, xk, xv, n_heads=self.n_heads,
            head_size=self._head_size(), project_input=self.project_input,
            causal=self.causal, mask=None)


@serde.register
@dataclasses.dataclass(frozen=True)
class GraphNode:
    """A named node: a layer or a structural vertex, and its inputs.

    ``param_key``: nodes with the same key read (and train) one
    parameter and state set (a layer called on several inputs).  None is
    the node's own name."""

    name: str = ""
    inputs: tuple[str, ...] = ()
    layer: Optional[LayerConfig] = None
    vertex: Optional[VertexConfig] = None
    param_key: Optional[str] = None

    @property
    def pkey(self) -> str:
        return self.param_key or self.name

    def __post_init__(self):
        if (self.layer is None) == (self.vertex is None):
            raise ValueError(f"node {self.name}: exactly one of layer/vertex required")


@serde.register
@dataclasses.dataclass(frozen=True)
class GraphConfiguration:
    """A resolved DAG (ComputationGraphConfiguration role)."""

    nodes: tuple[GraphNode, ...] = ()
    network_inputs: tuple[str, ...] = ()
    network_outputs: tuple[str, ...] = ()
    input_types: tuple[InputType, ...] = ()
    updater: Updater = dataclasses.field(default_factory=Sgd)
    seed: int = 0
    gradient_clip_value: Optional[float] = None
    gradient_clip_norm: Optional[float] = None
    bf16_compute: Optional[bool] = None
    steps_per_epoch: int = 1

    def to_json(self) -> str:
        return serde.dumps(self)

    @staticmethod
    def from_json(s: str) -> "GraphConfiguration":
        cfg = serde.loads(s)
        if not isinstance(cfg, GraphConfiguration):
            raise TypeError(f"JSON did not decode to GraphConfiguration: {type(cfg)}")
        return cfg

    def check_supported(self) -> None:
        """Raise `NotImplementedError`, naming the ROADMAP item, for a
        node the port cannot honour yet."""
        for n in self.nodes:
            (n.layer if n.layer is not None else n.vertex).check_supported()

    def topological_order(self) -> list[GraphNode]:
        by_name = {n.name: n for n in self.nodes}
        for n in self.nodes:
            for i in n.inputs:
                if i not in by_name and i not in self.network_inputs:
                    raise ValueError(f"node {n.name}: unknown input {i!r}")
        order: list[GraphNode] = []
        state: dict[str, int] = {}  # 0 unvisited, 1 visiting, 2 done
        net_inputs = set(self.network_inputs)

        def visit(root: str):
            # iterative DFS: a deep linear chain must not reach Python's
            # recursion limit
            stack: list[tuple[str, bool]] = [(root, False)]
            while stack:
                name, expanded = stack.pop()
                if name in net_inputs or state.get(name) == 2:
                    continue
                if expanded:
                    state[name] = 2
                    order.append(by_name[name])
                    continue
                if state.get(name) == 1:
                    raise ValueError(f"cycle involving {name!r}")
                state[name] = 1
                stack.append((name, True))
                for i in by_name[name].inputs:
                    if state.get(i) == 1 and i not in net_inputs:
                        raise ValueError(f"cycle involving {i!r}")
                    stack.append((i, False))

        for out in self.network_outputs:
            if out not in by_name:
                raise ValueError(f"network output {out!r} is not a node")
            visit(out)
        # nodes no output reaches are kept, so their parameters exist
        for n in self.nodes:
            visit(n.name)
        return order

    def infer_types(self) -> tuple[dict, dict]:
        """The type of every node's output, and whether an implicit CNN ->
        FF flatten precedes each layer node."""
        types: dict = dict(zip(self.network_inputs, self.input_types))
        flatten: dict = {}
        for node in self.topological_order():
            in_types = [types[i] for i in node.inputs]
            if node.layer is not None:
                t = in_types[0]
                flat = node.layer.EXPECTS == "ff" and t.kind in (
                    InputType.KIND_CNN, InputType.KIND_CNN3D)
                flatten[node.name] = flat
                if flat:
                    t = InputType.feed_forward(t.flat_size)
                types[node.name] = node.layer.output_type(t)
            else:
                flatten[node.name] = False
                types[node.name] = node.vertex.output_type(in_types)
        return types, flatten


class GraphBuilder:
    """Fluent DAG builder (ComputationGraphConfiguration.GraphBuilder
    role)::

        conf = (GraphBuilder()
                .add_inputs("in")
                .set_input_types(InputType.convolutional(32, 32, 3))
                .add_layer("c1", Conv2D(n_out=16, kernel=(3, 3)), "in")
                .add_layer("c2", Conv2D(n_out=16, kernel=(3, 3), padding="same"), "c1")
                .add_vertex("skip", ElementWiseVertex(ElementWiseOp.ADD), "c1", "c2")
                .add_layer("out", OutputLayer(n_out=10), "skip")
                .set_outputs("out")
                .updater(Adam(1e-3))
                .build())
    """

    def __init__(self):
        self._nodes: list[GraphNode] = []
        self._inputs: tuple[str, ...] = ()
        self._outputs: tuple[str, ...] = ()
        self._input_types: tuple[InputType, ...] = ()
        self._updater: Updater = Sgd()
        self._seed = 0
        self._clip_value: Optional[float] = None
        self._clip_norm: Optional[float] = None
        self._bf16: Optional[bool] = None
        self._steps_per_epoch = 1
        # layer-level defaults (as in NeuralNetConfiguration)
        self._activation = None
        self._weight_init = None
        self._l1 = None
        self._l2 = None
        self._dropout = None

    def add_inputs(self, *names: str):
        self._inputs = tuple(names)
        return self

    def set_input_types(self, *types: InputType):
        self._input_types = tuple(types)
        return self

    def add_layer(self, name: str, layer: LayerConfig, *inputs: str,
                  param_key: str | None = None):
        """``param_key``: share parameters with every other node of the
        same key; their layer configurations must agree."""
        layer = self._fill_defaults(name, layer)
        self._nodes.append(GraphNode(name=name, inputs=tuple(inputs),
                                     layer=layer, param_key=param_key))
        return self

    def add_vertex(self, name: str, vertex: VertexConfig, *inputs: str):
        # the net-wide l1 / l2 reach a vertex with parameters as a layer
        if vertex.HAS_PARAMS:
            updates = {}
            fields = {f.name for f in dataclasses.fields(vertex)}
            if "l1" in fields and vertex.l1 is None and self._l1 is not None:
                updates["l1"] = self._l1
            if "l2" in fields and vertex.l2 is None and self._l2 is not None:
                updates["l2"] = self._l2
            if updates:
                vertex = dataclasses.replace(vertex, **updates)
        self._nodes.append(GraphNode(name=name, inputs=tuple(inputs), vertex=vertex))
        return self

    def set_outputs(self, *names: str):
        self._outputs = tuple(names)
        return self

    def replace_layer(self, name: str, layer: LayerConfig):
        """Swap the layer configuration of an existing node."""
        if not any(n.name == name for n in self._nodes):
            raise ValueError(f"no node named {name!r}")
        self._nodes = [dataclasses.replace(n, layer=layer) if n.name == name else n
                       for n in self._nodes]
        return self

    def updater(self, u: Updater):
        self._updater = u
        return self

    def seed(self, s: int):
        self._seed = int(s)
        return self

    def activation(self, a):
        self._activation = a
        return self

    def weight_init(self, w):
        self._weight_init = w
        return self

    def l1(self, v: float):
        self._l1 = v
        return self

    def l2(self, v: float):
        self._l2 = v
        return self

    def dropout(self, rate: float):
        self._dropout = rate
        return self

    def gradient_clip(self, value: float | None = None, norm: float | None = None):
        self._clip_value, self._clip_norm = value, norm
        return self

    def bf16_compute(self, on: bool):
        self._bf16 = on
        return self

    def steps_per_epoch(self, n: int):
        self._steps_per_epoch = max(1, int(n))
        return self

    def _fill_defaults(self, name: str, layer: LayerConfig) -> LayerConfig:
        updates = {}
        is_output = hasattr(layer, "loss")
        if layer.activation is None and self._activation is not None and not is_output:
            updates["activation"] = self._activation
        if layer.weight_init is None and self._weight_init is not None:
            updates["weight_init"] = self._weight_init
        if layer.l1 is None and self._l1 is not None:
            updates["l1"] = self._l1
        if layer.l2 is None and self._l2 is not None:
            updates["l2"] = self._l2
        if layer.dropout_rate is None and self._dropout is not None:
            updates["dropout_rate"] = self._dropout
        updates["name"] = name
        return dataclasses.replace(layer, **updates)

    def build(self) -> GraphConfiguration:
        if not self._nodes:
            raise ValueError("no nodes configured")
        if not self._inputs:
            raise ValueError("no network inputs declared (add_inputs)")
        if not self._outputs:
            raise ValueError("no network outputs declared (set_outputs)")
        if len(self._input_types) != len(self._inputs):
            raise ValueError(f"{len(self._inputs)} inputs but "
                             f"{len(self._input_types)} input types")
        names = [n.name for n in self._nodes] + list(self._inputs)
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(f"duplicate node names: {sorted(dupes)}")
        conf = GraphConfiguration(
            nodes=tuple(self._nodes), network_inputs=self._inputs,
            network_outputs=self._outputs, input_types=self._input_types,
            updater=self._updater, seed=self._seed,
            gradient_clip_value=self._clip_value,
            gradient_clip_norm=self._clip_norm, bf16_compute=self._bf16,
            steps_per_epoch=self._steps_per_epoch)
        conf.topological_order()  # acyclic, every input known
        conf.infer_types()        # the shapes compose
        return conf
