"""NASNet-A — `deeplearning4j_tpu/zoo/nasnet.py`, the reference zoo's
`org.deeplearning4j.zoo.model.NASNet` [U].

NASNet-A (Mobile-shaped by default: 4 cells per stack, 44 cell filters →
1056 penultimate filters) built from the two learned cells:

  normal cell   — five add-pairs of {separable 3x3/5x5, avg pool, identity}
                  over (current h, previous p), concatenated with p
  reduction cell — stride-2 pairs of {separable 5x5/7x7, max/avg pool}
                  with two derived pairs, concatenated

Each separable branch is the doubled stage (relu → sepconv → bn, twice) of
the original; every cell starts by squeezing both inputs to the cell
filter count with 1x1 conv + BN.  One simplification, stated: when the
previous-cell activation has a larger spatial extent than the current one
(right after a reduction), it is adjusted with a strided 1x1 conv + BN
rather than the original's factorized space-shifted reduction — same
shapes, marginally less capacity.  Channels-last.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer,
    BatchNorm,
    Conv2D,
    Dropout,
    GlobalPooling,
    OutputLayer,
    PoolingType,
    SeparableConv2D,
    Subsampling,
)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    ElementWiseOp,
    ElementWiseVertex,
    GraphBuilder,
    MergeVertex,
)
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel


def _relu():
    return ActivationLayer(activation=Activation.RELU)


class NASNet(ZooModel):
    NAME = "nasnet"

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 height: int = 224, width: int = 224, channels: int = 3,
                 cells_per_stack: int = 4, cell_filters: int = 44,
                 stem_filters: int = 32, learning_rate: float = 1e-3,
                 dropout: float = 0.0):
        super().__init__(num_classes, seed)
        self.height, self.width, self.channels = height, width, channels
        self.cells_per_stack = cells_per_stack
        self.cell_filters = cell_filters
        self.stem_filters = stem_filters
        self.learning_rate = learning_rate
        self.dropout = dropout

    # -- cell building blocks ---------------------------------------------
    def _sep(self, g, name, inp, filters, kernel, stride=(1, 1)) -> str:
        """Doubled separable stage: (relu → sep k×k → bn) × 2, second
        stage always stride 1."""
        g.add_layer(f"{name}_r1", _relu(), inp)
        g.add_layer(f"{name}_s1", SeparableConv2D(
            n_out=filters, kernel=kernel, stride=stride, padding="same",
            has_bias=False), f"{name}_r1")
        g.add_layer(f"{name}_b1", BatchNorm(), f"{name}_s1")
        g.add_layer(f"{name}_r2", _relu(), f"{name}_b1")
        g.add_layer(f"{name}_s2", SeparableConv2D(
            n_out=filters, kernel=kernel, padding="same", has_bias=False),
            f"{name}_r2")
        g.add_layer(f"{name}_b2", BatchNorm(), f"{name}_s2")
        return f"{name}_b2"

    def _squeeze(self, g, name, inp, filters, stride=(1, 1)) -> str:
        g.add_layer(f"{name}_r", _relu(), inp)
        g.add_layer(f"{name}_c", Conv2D(n_out=filters, kernel=(1, 1),
                                        stride=stride, has_bias=False),
                    f"{name}_r")
        g.add_layer(f"{name}_b", BatchNorm(), f"{name}_c")
        return f"{name}_b"

    def _pool(self, g, name, inp, kind: PoolingType, stride) -> str:
        g.add_layer(name, Subsampling(pooling=kind, kernel=(3, 3),
                                      stride=stride, padding="same"), inp)
        return name

    def _add(self, g, name, a, b) -> str:
        g.add_vertex(name, ElementWiseVertex(ElementWiseOp.ADD), a, b)
        return name

    def _normal_cell(self, g, name, p, h, filters, adjust_prev: bool) -> str:
        h1 = self._squeeze(g, f"{name}_h", h, filters)
        p1 = self._squeeze(g, f"{name}_p", p, filters,
                           stride=(2, 2) if adjust_prev else (1, 1))
        x1 = self._add(g, f"{name}_x1",
                       self._sep(g, f"{name}_x1a", h1, filters, (5, 5)),
                       self._sep(g, f"{name}_x1b", p1, filters, (3, 3)))
        x2 = self._add(g, f"{name}_x2",
                       self._sep(g, f"{name}_x2a", p1, filters, (5, 5)),
                       self._sep(g, f"{name}_x2b", p1, filters, (3, 3)))
        x3 = self._add(g, f"{name}_x3",
                       self._pool(g, f"{name}_x3a", h1, PoolingType.AVG, (1, 1)),
                       p1)
        a4 = self._pool(g, f"{name}_x4a", p1, PoolingType.AVG, (1, 1))
        x4 = self._add(g, f"{name}_x4", a4, a4)
        x5 = self._add(g, f"{name}_x5",
                       self._sep(g, f"{name}_x5a", h1, filters, (3, 3)),
                       h1)
        g.add_vertex(f"{name}_out", MergeVertex(), p1, x1, x2, x3, x4, x5)
        return f"{name}_out"

    def _reduction_cell(self, g, name, p, h, filters, adjust_prev: bool) -> str:
        h1 = self._squeeze(g, f"{name}_h", h, filters)
        p1 = self._squeeze(g, f"{name}_p", p, filters,
                           stride=(2, 2) if adjust_prev else (1, 1))
        s2 = (2, 2)
        x1 = self._add(g, f"{name}_x1",
                       self._sep(g, f"{name}_x1a", h1, filters, (5, 5), s2),
                       self._sep(g, f"{name}_x1b", p1, filters, (7, 7), s2))
        x2 = self._add(g, f"{name}_x2",
                       self._pool(g, f"{name}_x2a", h1, PoolingType.MAX, s2),
                       self._sep(g, f"{name}_x2b", p1, filters, (7, 7), s2))
        x3 = self._add(g, f"{name}_x3",
                       self._pool(g, f"{name}_x3a", h1, PoolingType.AVG, s2),
                       self._sep(g, f"{name}_x3b", p1, filters, (5, 5), s2))
        x4 = self._add(g, f"{name}_x4",
                       self._pool(g, f"{name}_x4a", x1, PoolingType.AVG, (1, 1)),
                       x2)
        x5 = self._add(g, f"{name}_x5",
                       self._sep(g, f"{name}_x5a", x1, filters, (3, 3)),
                       self._pool(g, f"{name}_x5b", h1, PoolingType.MAX, s2))
        g.add_vertex(f"{name}_out", MergeVertex(), x2, x3, x4, x5)
        return f"{name}_out"

    # -- whole network -----------------------------------------------------
    def conf(self):
        g = (
            GraphBuilder()
            .seed(self.seed)
            .updater(Adam(self.learning_rate))
            .weight_init(WeightInit.RELU)
            .add_inputs("input")
            .set_input_types(
                InputType.convolutional(self.height, self.width, self.channels)
            )
        )
        g.add_layer("stem", Conv2D(n_out=self.stem_filters, kernel=(3, 3),
                                   stride=(2, 2), padding="same",
                                   has_bias=False), "input")
        g.add_layer("stem_bn", BatchNorm(), "stem")

        filters = self.cell_filters
        p, h = "stem_bn", "stem_bn"
        adjust = False                # p and h spatial extents differ?
        for stack in range(3):
            for i in range(self.cells_per_stack):
                cur = self._normal_cell(
                    g, f"s{stack}_n{i}", p, h, filters, adjust_prev=adjust
                )
                # after the cell, p and h are both post-reduction size
                p, h, adjust = h, cur, False
            if stack < 2:
                cur = self._reduction_cell(
                    g, f"s{stack}_red", p, h, filters * 2, adjust_prev=False
                )
                p, h = h, cur
                adjust = True          # next cell's p is pre-reduction size
                filters *= 2

        g.add_layer("head_relu", _relu(), h)
        g.add_layer("gap", GlobalPooling(pooling=PoolingType.AVG), "head_relu")
        if self.dropout:
            g.add_layer("head_drop", Dropout(rate=self.dropout), "gap")
            gap = "head_drop"
        else:
            gap = "gap"
        g.add_layer("output", OutputLayer(n_out=self.num_classes,
                                          loss=Loss.MCXENT,
                                          activation=Activation.SOFTMAX), gap)
        g.set_outputs("output")
        return g.build()
