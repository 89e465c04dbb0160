"""The YOLOv2 head (`nn/conf/objdetect.py`) against the JAX package's, on
the CPU.

`build_targets` (numpy on the host in both packages) gives the same
grid bit for bit; the loss, its gradient with respect to the raw grid
and `decode` agree within 1e-5 of the largest reference element (f32,
another order of the sums); `non_max_suppression` keeps the same
indices and `get_predicted_objects` returns equal lists of detections
(confidences and boxes within 1e-5).  A small sequential detector and a
graph detector (a `SpaceToDepth` passthrough merged into the trunk)
take their first training steps from the JAX weights: the loss of each
step within 1e-5 relative, the parameters after them within 1e-5 of
the largest element; ``output()`` is the raw grid.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.computation_graph import GraphModel as JaxGraph
from deeplearning4j_tpu.models.sequential import SequentialModel as JaxSeq
from deeplearning4j_tpu.nn.conf import objdetect as jax_od
from deeplearning4j_tpu.nn.conf.graph_conf import GraphConfiguration as JaxGraphConf
from deeplearning4j_tpu.nn.conf.neural_net_configuration import (
    SequentialConfiguration as JaxSeqConf,
)
from deeplearning4j_tpu_torch.convert import params_from_jax, params_to_numpy
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf import objdetect
from deeplearning4j_tpu_torch.nn.conf.graph_conf import (
    GraphBuilder,
    GraphConfiguration,
    MergeVertex,
)
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
    SequentialConfiguration,
)
from deeplearning4j_tpu_torch.nn.updaters import Adam

torch.set_num_threads(1)

TOL = 1e-5
ANCHORS = ((1.0, 1.2), (2.5, 2.0), (0.6, 0.5))
C = 3


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} of max {scale:.3e}"


def _boxes(r, n, grid, classes=C, most=4):
    """1 to ``most`` boxes an image: (class, cx, cy, w, h) in grid units."""
    return [[(int(r.integers(0, classes)), float(r.uniform(0, grid)),
              float(r.uniform(0, grid)), float(r.uniform(0.3, 3.0)),
              float(r.uniform(0.3, 3.0))) for _ in range(int(r.integers(1, most + 1)))]
            for _ in range(n)]


def test_build_targets_is_the_jax_grid():
    r = np.random.default_rng(0)
    boxes = _boxes(r, 6, 5) + [[(1, 4.999, 0.0, 1e-9, 2.0)]]   # the clamps
    want = jax_od.build_targets(boxes, 5, 5, ANCHORS, C)
    got = objdetect.build_targets(boxes, 5, 5, ANCHORS, C)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_its_gradient_match_jax(masked):
    r = np.random.default_rng(1)
    b, g = 4, 5
    jl = jax_od.Yolo2OutputLayer(anchors=ANCHORS, num_classes=C, lambda_coord=4.0,
                                 lambda_noobj=0.3)
    pl = objdetect.Yolo2OutputLayer(anchors=ANCHORS, num_classes=C, lambda_coord=4.0,
                                    lambda_noobj=0.3)
    raw = r.normal(size=(b, g, g, len(ANCHORS) * (5 + C))).astype(np.float32)
    labels = jax_od.build_targets(_boxes(r, b, g), g, g, ANCHORS, C)
    mask = (np.arange(b) % 3 != 1).astype(np.float32) if masked else None
    jloss, jgrad = jax.jit(jax.value_and_grad(lambda p: jl.compute_loss(
        p, jnp.asarray(labels), None if mask is None else jnp.asarray(mask))))(
        jnp.asarray(raw))
    t = torch.tensor(raw, requires_grad=True)
    loss = pl.compute_loss(t, torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    loss.backward()
    _close(loss.item(), float(jloss), "loss")
    _close(t.grad.numpy(), jgrad, "d loss / d grid")


def test_decode_matches_jax():
    r = np.random.default_rng(2)
    raw = r.normal(size=(2, 4, 6, len(ANCHORS) * (5 + C))).astype(np.float32)
    want = jax_od.Yolo2OutputLayer(anchors=ANCHORS, num_classes=C).decode(raw)
    got = objdetect.Yolo2OutputLayer(anchors=ANCHORS, num_classes=C).decode(
        torch.from_numpy(raw))
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].numpy(), want[k], f"decode {k}")


def test_nms_keeps_the_jax_indices():
    r = np.random.default_rng(3)
    for _ in range(20):
        n = int(r.integers(1, 40))
        boxes = np.concatenate([r.uniform(0, 10, (n, 2)), r.uniform(0.5, 4, (n, 2))],
                               axis=1).astype(np.float32)
        scores = r.random(n).astype(np.float32)
        kw = dict(iou_threshold=float(r.uniform(0.2, 0.7)),
                  score_threshold=float(r.uniform(0.0, 0.5)), max_out=int(r.integers(1, 20)))
        assert (objdetect.non_max_suppression(boxes, scores, **kw)
                == jax_od.non_max_suppression(boxes, scores, **kw))


def test_get_predicted_objects_equal_lists():
    """Seeded grids with hot cells of several classes, overlapping
    anchors of one class (suppressed) and of two classes (both kept)."""
    r = np.random.default_rng(4)
    anchors = ((1.5, 1.5), (1.5, 1.5), (3.0, 2.0))
    raw = np.full((3, 6, 6, 3 * (5 + C)), -6.0, np.float32)
    raw += r.normal(scale=0.5, size=raw.shape).astype(np.float32)
    for b in range(3):
        for _ in range(6):
            i, j, a, c = (int(r.integers(0, 6)), int(r.integers(0, 6)),
                          int(r.integers(0, 3)), int(r.integers(0, C)))
            raw[b, i, j, a * (5 + C) + 4] = r.uniform(3, 8)
            raw[b, i, j, a * (5 + C) + 5 + c] = r.uniform(5, 9)
    jl = jax_od.Yolo2OutputLayer(anchors=anchors, num_classes=C)
    pl = objdetect.Yolo2OutputLayer(anchors=anchors, num_classes=C)
    for thr in (0.3, 0.6):
        want = jax_od.get_predicted_objects(jl, raw, score_threshold=thr)
        got = objdetect.get_predicted_objects(pl, torch.from_numpy(raw), score_threshold=thr)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert [d.class_index for d in g] == [d.class_index for d in w]
            assert len(g) > 0
            for dg, dw in zip(g, w):
                np.testing.assert_allclose(
                    [dg.confidence, dg.center_x, dg.center_y, dg.width, dg.height],
                    [dw.confidence, dw.center_x, dw.center_y, dw.width, dw.height],
                    rtol=TOL, atol=TOL)
                assert dg.top_left() < dg.bottom_right()


def _seq_conf():
    anchors = ((1.5, 1.5), (0.8, 1.1))
    return (NeuralNetConfiguration.builder().seed(3).updater(Adam(1e-2)).list()
            .layer(Conv2D(n_out=6, kernel=(3, 3), padding="same", activation=Activation.RELU))
            .layer(Subsampling(pooling=PoolingType.MAX, kernel=(2, 2), stride=(2, 2)))
            .layer(Conv2D(name="head", n_out=len(anchors) * (5 + C), kernel=(1, 1)))
            .layer(objdetect.Yolo2OutputLayer(name="yolo", anchors=anchors, num_classes=C))
            .set_input_type(InputType.convolutional(8, 8, 2)).build())


def _graph_conf():
    anchors = ((1.5, 1.5), (0.8, 1.1))
    g = (GraphBuilder().seed(5).updater(Adam(1e-2)).add_inputs("input")
         .set_input_types(InputType.convolutional(8, 8, 2)))
    g.add_layer("c1", Conv2D(n_out=4, kernel=(3, 3), padding="same", has_bias=False), "input")
    g.add_layer("b1", BatchNorm(activation=Activation.LEAKYRELU), "c1")
    g.add_layer("p1", Subsampling(pooling=PoolingType.MAX, kernel=(2, 2), stride=(2, 2)), "b1")
    g.add_layer("c2", Conv2D(n_out=6, kernel=(3, 3), padding="same"), "p1")
    g.add_layer("s2d", SpaceToDepth(block=2), "b1")
    g.add_vertex("concat", MergeVertex(), "s2d", "c2")
    g.add_layer("head", Conv2D(n_out=len(anchors) * (5 + C), kernel=(1, 1)), "concat")
    g.add_layer("yolo", objdetect.Yolo2OutputLayer(anchors=anchors, num_classes=C), "head")
    g.set_outputs("yolo")
    return g.build()


@pytest.mark.parametrize("kind", ["sequential", "graph"])
def test_detector_steps_match_jax(kind):
    conf = _seq_conf() if kind == "sequential" else _graph_conf()
    if kind == "sequential":
        jm = JaxSeq(JaxSeqConf.from_json(conf.to_json())).init()
        pm = SequentialModel(SequentialConfiguration.from_json(jm.conf.to_json()),
                             device="cpu")
    else:
        jm = JaxGraph(JaxGraphConf.from_json(conf.to_json())).init()
        pm = GraphModel(GraphConfiguration.from_json(jm.conf.to_json()), device="cpu")
    params_from_jax(jax.tree.map(np.asarray, jm.params), pm,
                    jax.tree.map(np.asarray, jm.net_state))
    r = np.random.default_rng(6)
    x = r.normal(size=(6, 8, 8, 2)).astype(np.float32)
    y = objdetect.build_targets(_boxes(r, 6, 4), 4, 4, ((1.5, 1.5), (0.8, 1.1)), C)
    out = pm.output(x)
    assert tuple(out.shape) == (6, 4, 4, 2 * (5 + C))      # the raw grid
    _close(out.numpy(), np.asarray(jm.output(x)), "output()")
    for step in range(3):
        jm.fit_batch(JaxDataSet(x, y))
        pm.fit_batch(DataSet(x, y))
        _close(pm.score_value, float(jm.score_value), f"loss of step {step}")
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jm.params)),
                    jax.tree.leaves(params_to_numpy(pm))):
        _close(b, a, "parameters after 3 steps")


def test_grouped_fit_takes_the_heads_own_loss():
    """``fit(..., steps_per_execution=2)`` runs the grouped step through
    the same loss site: the YOLO head's loss and the parameters after
    two batches are those of two ``fit_batch`` steps, bit for bit."""
    r = np.random.default_rng(8)
    batches = []
    for _ in range(2):
        x = r.normal(size=(4, 8, 8, 2)).astype(np.float32)
        y = objdetect.build_targets(_boxes(r, 4, 4), 4, 4, ((1.5, 1.5), (0.8, 1.1)), C)
        batches.append(DataSet(x, y))
    grouped = SequentialModel(_seq_conf(), device="cpu").init()
    single = SequentialModel(_seq_conf(), device="cpu").init()
    grouped.fit(batches, steps_per_execution=2)
    for b in batches:
        single.fit_batch(b)
    assert grouped.iteration == single.iteration == 2
    assert grouped.score_value == single.score_value
    for a, b in zip(jax.tree.leaves(params_to_numpy(grouped)),
                    jax.tree.leaves(params_to_numpy(single))):
        np.testing.assert_array_equal(a, b)
