"""The zoo's ten architectures (`zoo/alexnet.py` ... `zoo/yolo.py`)
against the JAX package's, on the CPU, at the reduced sizes the JAX
package's own zoo tests use.

For each: the configuration writes the JAX configuration's JSON.  Both
packages' models then hold the same seeded weights and BatchNorm
statistics (numpy, He-scaled kernels; the layers' own initialisers are
held to JAX's bit for bit in `tests/test_torch_layers_tail.py`), and:

- ``output()`` agrees within 1e-5 of the largest reference element (f32,
  another order of the sums);
- one training step under plain SGD (the zoo's configuration with its
  updater swapped, at a rate of 2^10, so that a weight's change is its
  gradient times the rate, far above the weight's rounding) gives the
  loss within 1e-4 relative, the BatchNorm statistics within 1e-5 of
  each leaf's largest, and each parameter leaf's change within 5e-2
  relative (L2) of JAX's, plus 1e-6 of the largest leaf's change (a
  bias that feeds a BatchNorm has a zero gradient in exact arithmetic:
  InceptionResNetV1's projection biases, 1e-8 of the largest).  Most
  leaves agree within 2e-5.  The bound is set by ReLU: a pre-activation
  within the two packages' rounding of zero passes in one and not in
  the other, and a BatchNorm shift's gradient, a sum of about a
  thousand terms of either sign, moves by one term, a few percent
  (Darknet19's first shift 2.9e-2, FaceNet's 2.4e-2; a 1e-7 change of
  the input moves the JAX package's own by 1.8e-2 and 3.8e-2).  A wrong
  gradient in any one leaf (a bias, a BatchNorm scale, a depthwise
  kernel, the centers) is off by order 1.  BatchNorm's batch statistics
  over small maps magnify f32 rounding in the loss: a 1e-7 relative
  change of the input moves the JAX package's own first loss by up to
  1.2e-5 (YOLO2, batch 8), and by 4e-4 for InceptionResNetV1 at batch 2
  (so it and Darknet19 step at batch 8).

Quantized models with `SeparableConv2D` (Xception) and `Deconv2D`
(UNet) hold JAX's int8 kernels bit for bit and give JAX's quantized
outputs within 1e-5.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.zoo as jax_zoo
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.computation_graph import GraphModel as JaxGraphModel
from deeplearning4j_tpu.models.sequential import SequentialModel as JaxSequentialModel
from deeplearning4j_tpu.nn.conf.graph_conf import GraphConfiguration as JaxGraphConfiguration
from deeplearning4j_tpu.nn.conf.neural_net_configuration import (
    SequentialConfiguration as JaxSequentialConfiguration)
from deeplearning4j_tpu.nn.conf.objdetect import build_targets
from deeplearning4j_tpu.quant.ptq import quantize as jax_quantize
from deeplearning4j_tpu_torch.convert import (net_state_to_numpy, params_from_jax,
                                              params_to_numpy)
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import SequentialConfiguration
from deeplearning4j_tpu_torch.quant.ptq import quantize

torch.set_num_threads(1)

TOL = 1e-5
LEAF_TOL, LEAF_FLOOR = 5e-2, 1e-6
LR = 2.0 ** 10        # a power of two: the rate times a gradient is exact

# (port module, class, constructor arguments, batch): the JAX zoo tests'
# reduced sizes (tests/test_zoo_extended.py, test_zoo_nasnet_facenet.py,
# test_zoo.py)
ZOO = {
    "alexnet": ("alexnet", "AlexNet", dict(num_classes=7, height=96, width=96), 2),
    "darknet19": ("darknet", "Darknet19", dict(num_classes=5, height=64, width=64), 8),
    "squeezenet": ("squeezenet", "SqueezeNet", dict(num_classes=6, height=96, width=96), 2),
    "vgg16": ("vgg", "VGG16", dict(num_classes=10, height=32, width=32, fc_width=64), 2),
    "xception": ("xception", "Xception", dict(num_classes=4, height=96, width=96,
                                              middle_blocks=2), 2),
    "inception_resnet_v1": ("inception_resnet", "InceptionResNetV1",
                            dict(num_classes=4, height=96, width=96, blocks_a=1,
                                 blocks_b=1, blocks_c=1), 8),
    "nasnet": ("nasnet", "NASNet", dict(num_classes=5, height=32, width=32,
                                        cells_per_stack=1, cell_filters=8,
                                        stem_filters=8), 4),
    "facenet_nn4_small2": ("facenet", "FaceNetNN4Small2",
                           dict(num_classes=4, height=64, width=64, embedding_size=16), 4),
    "unet": ("unet", "UNet", dict(num_classes=1, height=32, width=32, channels=3,
                                  base_filters=4, depth=2), 2),
    "tiny_yolo": ("yolo", "TinyYOLO", dict(num_classes=3, height=128, width=128), 2),
    "yolo2": ("yolo", "YOLO2", dict(num_classes=3, height=128, width=128), 2),
}


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} of max {scale:.3e}"


def _pair(case):
    mod, cls, kw, _ = ZOO[case]
    return (getattr(jax_zoo, cls)(**kw),
            getattr(importlib.import_module(f"deeplearning4j_tpu_torch.zoo.{mod}"), cls)(**kw))


def _seeded(shapes, r, name=""):
    """Numpy arrays of the tree ``shapes``: kernels He-normal over all but
    their last axis, BatchNorm's gamma 1 and its variance 1 give or take,
    biases, shifts and means near 0."""
    if isinstance(shapes, dict):
        return {k: _seeded(v, r, k) for k, v in shapes.items()}
    shape = tuple(shapes.shape)
    if len(shape) >= 2:
        a = r.normal(scale=np.sqrt(2.0 / np.prod(shape[:-1])), size=shape)
    elif name == "var":
        a = r.uniform(0.5, 1.5, size=shape)
    else:
        a = (name == "gamma") + r.normal(scale=0.1, size=shape)
    return a.astype(np.float32)


def _models(case, seed, updater=None):
    """The JAX and the port model of ``case`` with the same seeded
    weights and layer state; ``updater`` (JSON) replaces the zoo's."""
    jz, pz = _pair(case)
    d = json.loads(pz.conf().to_json())
    if updater is not None:
        d["updater"] = updater
    text = json.dumps(d)
    graph = d["@type"] == "GraphConfiguration"
    jconf = (JaxGraphConfiguration if graph else JaxSequentialConfiguration).from_json(text)
    pconf = (GraphConfiguration if graph else SequentialConfiguration).from_json(text)
    jm = (JaxGraphModel if graph else JaxSequentialModel)(jconf)
    shapes = jax.eval_shape(lambda: (lambda m: (m.params, m.net_state))(
        (JaxGraphModel if graph else JaxSequentialModel)(jconf).init()))
    params, state = _seeded(shapes[0], np.random.default_rng(seed)), _seeded(
        shapes[1], np.random.default_rng(seed + 1000))
    jm.params = jax.tree.map(jax.numpy.asarray, params)
    jm.net_state = jax.tree.map(jax.numpy.asarray, state)
    jm.opt_state = jm._tx.init(jm.params)
    pm = params_from_jax(params, (GraphModel if graph else SequentialModel)(
        pconf, device="cpu"), state)
    return jz, jm, pm


def _batch(case, jz, n, r):
    """Seeded images and labels of the architecture's kind: one-hot
    classes, a per-pixel mask (UNet) or `build_targets` grids over 1-4
    boxes an image (the YOLO heads)."""
    x = r.normal(size=(n, jz.height, jz.width, getattr(jz, "channels", 3))).astype(np.float32)
    if case == "unet":
        return x, (x[..., :1] > 0).astype(np.float32)
    if case in ("tiny_yolo", "yolo2"):
        g = jz.height // 32
        boxes = [[(int(r.integers(0, jz.num_classes)), float(r.uniform(0, g)),
                   float(r.uniform(0, g)), float(r.uniform(0.5, 3)), float(r.uniform(0.5, 3)))
                  for _ in range(int(r.integers(1, 5)))] for _ in range(n)]
        return x, build_targets(boxes, g, g, jz.anchors, jz.num_classes)
    return x, np.eye(jz.num_classes, dtype=np.float32)[r.integers(0, jz.num_classes, n)]


@pytest.mark.parametrize("case", list(ZOO))
def test_zoo_model_matches_jax(case):
    jz, pz = _pair(case)
    assert pz.conf().to_json() == jz.conf().to_json()
    seed = sorted(ZOO).index(case)
    jz, jm, pm = _models(case, seed, {"@type": "Sgd", "learning_rate": LR})
    x, y = _batch(case, jz, ZOO[case][3], np.random.default_rng(seed))
    _close(pm.output(x).numpy(), np.asarray(jm.output(x)), f"{case} output()")
    before = jax.tree.leaves(params_to_numpy(pm))
    jm.fit_batch(JaxDataSet(x, y))
    pm.fit_batch(DataSet(x, y))
    _close(pm.score_value, float(jm.score_value), f"{case} loss of the first step", tol=1e-4)
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jm.net_state))[0],
            jax.tree.leaves(net_state_to_numpy(pm))):
        _close(got, want, f"{case} {jax.tree_util.keystr(path)} after the step")
    got = jax.tree.leaves(params_to_numpy(pm))
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jm.params))[0]
    assert len(got) == len(want) == len(before)
    changes = [(jax.tree_util.keystr(path), w.astype(np.float64) - b, g.astype(np.float64) - b)
               for (path, w), g, b in zip(want, got, before)]
    floor = LEAF_FLOOR * max(np.linalg.norm(dw) for _, dw, _ in changes)
    for name, dw, dg in changes:
        err, norm = np.linalg.norm(dg - dw), np.linalg.norm(dw)
        assert err <= LEAF_TOL * norm + floor, (
            f"{case} {name}: the step's change off by {err:.3e} of {norm:.3e}")


def test_vgg19_configuration_is_the_jax_configuration():
    """VGG19 is VGG16's class with deeper blocks: the same JSON."""
    from deeplearning4j_tpu_torch.zoo.vgg import VGG19

    kw = dict(num_classes=10, height=32, width=32, fc_width=64)
    assert VGG19(**kw).conf().to_json() == jax_zoo.VGG19(**kw).conf().to_json()


@pytest.mark.parametrize("case", ["xception", "unet"])
def test_quantized_separable_and_transposed_convs_match_jax(case):
    """`quantize` int8-quantizes the SeparableConv2D kernels (Xception)
    and the Deconv2D kernels (UNet) bit for bit as the JAX package does,
    and the quantized model's output() is the JAX quantized model's."""
    jz, jm, pm = _models(case, 50)
    jq, pq = jax_quantize(jm), quantize(pm)
    kinds = {"xception": "SeparableConv2D", "unet": "Deconv2D"}
    nodes = [n for n in pq.conf.nodes if type(n.layer).__name__ == kinds[case]]
    assert nodes
    jp = jax.tree.map(np.asarray, jq.params)
    for node in nodes:
        for pname, leaf in pq.params[node.name].items():
            if pname == "b":
                continue
            np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(jp[node.name][pname].q))
            np.testing.assert_array_equal(leaf.scale.numpy(),
                                          np.asarray(jp[node.name][pname].scale))
    x, _ = _batch(case, jz, 2, np.random.default_rng(9))
    _close(pq.output(x).numpy(), np.asarray(jq.output(x)), f"{case} quantized output()")


def test_a_refused_tree_leaves_the_model_uninitialised():
    """`load_params` on a model not yet initialised checks the tree
    before it installs anything: a tree of a wrong shape raises and the
    model stays without parameters or layer state; the right tree then
    loads and gives JAX's output()."""
    jz, jm, _ = _models("unet", 7)
    pm = GraphModel(_pair("unet")[1].conf(), device="cpu")
    params = jax.tree.map(np.asarray, jm.params)
    bad = {**params, "logits": {**params["logits"], "W": params["logits"]["W"][..., :0]}}
    with pytest.raises(ValueError, match="logits/W: shape"):
        pm.load_params(bad)
    assert pm.params is None and pm.net_state is None
    pm.load_params(params).load_net_state(jax.tree.map(np.asarray, jm.net_state))
    x, _ = _batch("unet", jz, 2, np.random.default_rng(3))
    _close(pm.output(x).numpy(), np.asarray(jm.output(x)), "unet output() after the refusal")
