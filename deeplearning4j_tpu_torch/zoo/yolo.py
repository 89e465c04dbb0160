"""TinyYOLO and YOLO2 — `deeplearning4j_tpu/zoo/yolo.py`, the reference
zoo's `TinyYOLO` / `YOLO2` models.

TinyYOLO: the 9-conv tiny-darknet backbone + Yolo2OutputLayer, sequential.
YOLO2: the Darknet19 backbone with the 'passthrough' reorg — conv13's
26x26 features space-to-depth'd and concatenated with the 13x13 trunk
(SpaceToDepth + MergeVertex in the graph) — then the detection head.

Detection labels come from `nn.conf.objdetect.build_targets` (dense grid,
host-built); the loss is the dense YOLOv2 loss inside the training step
(captured with it on the card).  Default anchors are the VOC anchors both reference
models ship with.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (
    BatchNorm,
    Conv2D,
    PoolingType,
    SpaceToDepth,
    Subsampling,
)
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphBuilder, MergeVertex
from deeplearning4j_tpu_torch.nn.conf.objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.nn.updaters import Adam
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.zoo.darknet import DARKNET19_PLAN, darknet_conv_block
from deeplearning4j_tpu_torch.zoo.zoo_model import ZooModel

# VOC anchor priors (grid units), as shipped with the reference models
TINY_YOLO_ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                     (9.42, 5.11), (16.62, 10.52))
YOLO2_ANCHORS = ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434),
                 (7.88282, 3.52778), (9.77052, 9.16828))


class TinyYOLO(ZooModel):
    NAME = "tiny_yolo"

    FILTERS = (16, 32, 64, 128, 256, 512)

    def __init__(self, num_classes: int = 20, seed: int = 123,
                 height: int = 416, width: int = 416, channels: int = 3,
                 learning_rate: float = 1e-3, anchors=TINY_YOLO_ANCHORS):
        super().__init__(num_classes, seed)
        self.height, self.width, self.channels = height, width, channels
        self.learning_rate = learning_rate
        self.anchors = tuple(tuple(a) for a in anchors)

    def conf(self):
        b = (
            NeuralNetConfiguration.builder()
            .seed(self.seed)
            .updater(Adam(self.learning_rate))
            .weight_init(WeightInit.RELU)
            .list()
        )
        for i, f in enumerate(self.FILTERS, start=1):
            darknet_conv_block(b, i, f, 3)
            # last pool is stride-1 'same' (keeps 13x13), darknet tiny quirk
            stride = (2, 2) if i < len(self.FILTERS) else (1, 1)
            b.layer(Subsampling(name=f"pool{i}", pooling=PoolingType.MAX,
                                kernel=(2, 2), stride=stride, padding="same"))
        darknet_conv_block(b, 7, 1024, 3)
        darknet_conv_block(b, 8, 1024, 3)
        head = len(self.anchors) * (5 + self.num_classes)
        b.layer(Conv2D(name="det_head", n_out=head, kernel=(1, 1), padding="same"))
        b.layer(Yolo2OutputLayer(name="yolo", anchors=self.anchors,
                                 num_classes=self.num_classes))
        return (
            b.set_input_type(InputType.convolutional(self.height, self.width, self.channels))
            .build()
        )


class YOLO2(ZooModel):
    NAME = "yolo2"

    def __init__(self, num_classes: int = 20, seed: int = 123,
                 height: int = 416, width: int = 416, channels: int = 3,
                 learning_rate: float = 1e-3, anchors=YOLO2_ANCHORS):
        super().__init__(num_classes, seed)
        self.height, self.width, self.channels = height, width, channels
        self.learning_rate = learning_rate
        self.anchors = tuple(tuple(a) for a in anchors)

    def conf(self):
        g = (
            GraphBuilder()
            .seed(self.seed)
            .updater(Adam(self.learning_rate))
            .weight_init(WeightInit.RELU)
            .add_inputs("input")
            .set_input_types(InputType.convolutional(self.height, self.width, self.channels))
        )
        # darknet19 backbone (without its class head), tracking the conv13
        # output (the 26x26 passthrough source)
        cur, idx, pools = "input", 0, 0
        passthrough = None
        for item in DARKNET19_PLAN:
            if item == "M":
                pools += 1
                name = f"pool{pools}"
                g.add_layer(name, Subsampling(pooling=PoolingType.MAX, kernel=(2, 2),
                                              stride=(2, 2)), cur)
                cur = name
            else:
                idx += 1
                g.add_layer(f"conv{idx}", Conv2D(n_out=item[0], kernel=(item[1], item[1]),
                                                 padding="same", has_bias=False), cur)
                g.add_layer(f"bn{idx}", BatchNorm(activation=Activation.LEAKYRELU), f"conv{idx}")
                cur = f"bn{idx}"
                if idx == 13:
                    passthrough = cur     # 26x26x512 before the last pool
        # detection trunk: two 3x3x1024 convs on the 13x13 map
        for j, name in ((19, "det1"), (20, "det2")):
            g.add_layer(name, Conv2D(n_out=1024, kernel=(3, 3), padding="same",
                                     has_bias=False), cur)
            g.add_layer(f"{name}_bn", BatchNorm(activation=Activation.LEAKYRELU), name)
            cur = f"{name}_bn"
        # passthrough: 1x1 squeeze then space-to-depth 26x26x64 -> 13x13x256
        g.add_layer("pt_conv", Conv2D(n_out=64, kernel=(1, 1), has_bias=False), passthrough)
        g.add_layer("pt_bn", BatchNorm(activation=Activation.LEAKYRELU), "pt_conv")
        g.add_layer("pt_s2d", SpaceToDepth(block=2), "pt_bn")
        g.add_vertex("concat", MergeVertex(), "pt_s2d", cur)
        g.add_layer("det3", Conv2D(n_out=1024, kernel=(3, 3), padding="same",
                                   has_bias=False), "concat")
        g.add_layer("det3_bn", BatchNorm(activation=Activation.LEAKYRELU), "det3")
        head = len(self.anchors) * (5 + self.num_classes)
        g.add_layer("det_head", Conv2D(n_out=head, kernel=(1, 1), padding="same"), "det3_bn")
        g.add_layer("yolo", Yolo2OutputLayer(anchors=self.anchors,
                                             num_classes=self.num_classes), "det_head")
        g.set_outputs("yolo")
        return g.build()
