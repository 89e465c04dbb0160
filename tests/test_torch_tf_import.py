"""The port's TF importer (`deeplearning4j_tpu_torch/modelimport/
tensorflow.py`) against the JAX package's, graph for graph: the same
GraphDef bytes (built by TensorFlow, or by either package's writer) are
imported by both, and outputs, gradients and fine-tune losses are held
to each other (f32: 1e-5) and to TensorFlow where it runs the graph.
The classes mirror `tests/test_tf_import.py`."""

import zipfile

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
tf1 = tf.compat.v1

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JaxSameDiff  # noqa: E402
from deeplearning4j_tpu.autodiff.samediff import TrainingConfig as JaxTC  # noqa: E402
from deeplearning4j_tpu.modelimport._tf.synthetic import (  # noqa: E402
    build_bert_classifier_graphdef as jax_bert,
)
from deeplearning4j_tpu.modelimport.tensorflow import import_graph as jax_import  # noqa: E402
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam  # noqa: E402
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig  # noqa: E402
from deeplearning4j_tpu_torch.modelimport._tf.synthetic import (  # noqa: E402
    build_bert_classifier_graphdef,
)
from deeplearning4j_tpu_torch.modelimport.tensorflow import (  # noqa: E402
    TFGraphMapper,
    TFImportError,
    import_graph,
    import_onnx,
)
from deeplearning4j_tpu_torch.nn.updaters import Adam  # noqa: E402

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.array(x)


def golden(graph, feeds, fetch):
    with tf1.Session(graph=graph) as sess:
        return sess.run(fetch, feeds)


def tf_graph(build, v1=False):
    if v1:
        tf1.disable_control_flow_v2()
    try:
        g = tf1.Graph()
        with g.as_default():
            build()
    finally:
        if v1:
            tf1.enable_control_flow_v2()
    return g


def both(raw, **kw):
    """The JAX package's import and the port's (on the CPU) of ``raw``."""
    return jax_import(raw, **kw), import_graph(raw, device="cpu", **kw)


def assert_pair(g, feeds, fetch, **kw):
    """TF, the JAX import and the port's import of ``g`` agree on ``fetch``."""
    raw = g.as_graph_def().SerializeToString()
    jsd, psd = both(raw, **kw)
    want = golden(g, {f"{k}:0": v for k, v in feeds.items()}, f"{fetch}:0")
    got = _np(psd.output(feeds, fetch))
    np.testing.assert_allclose(got, np.asarray(jsd.output(feeds, fetch)), **F32_TOL)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    return jsd, psd


def while_attrs(sd):
    return [{k: n.attrs[k] for k in ("max_trip", "exact_trip")}
            for n in sd._ops if n.op == "_while"]


class TestBasicGraphs:
    def test_mlp(self):
        rng = np.random.default_rng(0)
        w1 = rng.normal(size=(4, 8)).astype(np.float32)
        b1 = rng.normal(size=(8,)).astype(np.float32)
        w2 = rng.normal(size=(8, 3)).astype(np.float32)

        def build():
            x = tf1.placeholder(tf.float32, [None, 4], name="x")
            h = tf.nn.relu(tf.nn.bias_add(tf.matmul(x, tf.constant(w1)), tf.constant(b1)))
            tf.nn.softmax(tf.matmul(h, tf.constant(w2)), name="out")

        assert_pair(tf_graph(build), {"x": rng.normal(size=(5, 4)).astype(np.float32)}, "out")

    def test_conv_pool_batchnorm(self):
        rng = np.random.default_rng(1)
        k = rng.normal(0, 0.1, size=(3, 3, 2, 4)).astype(np.float32)

        def build():
            x = tf1.placeholder(tf.float32, [None, 8, 8, 2], name="x")
            c = tf.nn.conv2d(x, tf.constant(k), strides=[1, 1, 1, 1], padding="SAME")
            p = tf.nn.max_pool2d(tf.nn.relu(c), 2, 2, "VALID")
            y, _, _ = tf1.nn.fused_batch_norm(
                p, tf.constant(np.ones(4, np.float32)), tf.constant(np.zeros(4, np.float32)),
                mean=tf.constant(np.full(4, 0.1, np.float32)),
                variance=tf.constant(np.full(4, 2.0, np.float32)), is_training=False)
            tf.nn.avg_pool2d(y, 2, 2, "VALID", name="out")

        assert_pair(tf_graph(build), {"x": rng.normal(size=(2, 8, 8, 2)).astype(np.float32)},
                    "out")

    def test_reductions_shape_ops_and_selection(self):
        rng = np.random.default_rng(2)

        def build():
            x = tf1.placeholder(tf.float32, [3, 4], name="x")
            m = tf.reduce_mean(x, axis=1, keepdims=True)
            t = tf.transpose(tf.reshape(x - m, [4, 3]), [1, 0])
            s = tf.concat([t, tf.square(t)], axis=0)
            sel = tf.where(s > 0.0, s, -s * 0.5)
            tf.identity(tf.reduce_sum(tf.pad(sel, [[1, 0], [0, 2]]), axis=0), name="out")

        assert_pair(tf_graph(build), {"x": rng.normal(size=(3, 4)).astype(np.float32)}, "out")

    def test_gather_onehot_cast_argmax(self):
        table = np.random.default_rng(3).normal(size=(10, 4)).astype(np.float32)

        def build():
            ids = tf1.placeholder(tf.int32, [5], name="ids")
            e = tf.gather(tf.constant(table), ids)
            oh = tf.one_hot(ids, 10, on_value=2.0, off_value=-1.0)
            am = tf.cast(tf.argmax(oh, axis=1), tf.float32)
            tf.identity(tf.reduce_sum(e, axis=1) + am, name="out")

        assert_pair(tf_graph(build), {"ids": np.array([0, 3, 9, 3, 1], np.int32)}, "out")


class TestBertPath:
    """BASELINE config 4's path at vocab 128, d 32, 2 heads, 2 layers,
    T 16, B 4: bytes from the writer -> `import_graph(trainable=True)` ->
    `output()` and three `fit_batch` steps, against the JAX package."""

    KW = dict(vocab=128, d_model=32, n_layers=2, n_heads=2, seq_len=16, batch=4,
              n_classes=2, seed=4)

    def _pair(self):
        raw = build_bert_classifier_graphdef(**self.KW)
        return jax_import(jax_bert(**self.KW), trainable=True), import_graph(
            raw, trainable=True, device="cpu")

    def test_output_matches(self):
        jsd, psd = self._pair()
        ids = np.random.default_rng(0).integers(0, 128, (4, 16)).astype(np.int32)
        np.testing.assert_allclose(_np(psd.output({"ids": ids}, "logits")),
                                   np.asarray(jsd.output({"ids": ids}, "logits")), **F32_TOL)
        assert sorted(psd._trainable) == sorted(jsd._trainable)

    @staticmethod
    def _finetune(sd, tc, adam, feed, bf16):
        lab = sd.placeholder("labels")
        sd.set_loss(sd.loss.softmax_cross_entropy(sd["logits"], lab, name="loss"))
        sd.set_training_config(tc(updater=adam(1e-3), bf16_compute=bf16))
        return [sd.fit_batch(feed) for _ in range(3)]

    @pytest.mark.parametrize("bf16", [False, True])
    def test_three_finetune_steps(self, bf16):
        jsd, psd = self._pair()
        rng = np.random.default_rng(1)
        ids = rng.integers(0, 128, (4, 16)).astype(np.int32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
        feed = {"ids": ids, "labels": y}
        w0 = {n: np.array(jsd.get_value(n)) for n in jsd._trainable}
        jl = self._finetune(jsd, JaxTC, JaxAdam, feed, bf16)
        pl = self._finetune(psd, TrainingConfig, Adam, feed, bf16)
        # f32: 1e-5; bf16 compute: both round every operand to bf16, so
        # the losses agree to a few bf16 ulps of the loss (2^-8 relative)
        tol = dict(rtol=2**-8, atol=0) if bf16 else F32_TOL
        np.testing.assert_allclose(pl, jl, **tol)
        if bf16:
            # and they are bf16 losses: the port's f32 run of the same
            # steps lies farther from them than the JAX bf16 run does
            fl = self._finetune(self._pair()[1], TrainingConfig, Adam, feed, False)
            assert np.abs(np.subtract(pl, fl)).max() > np.abs(np.subtract(pl, jl)).max()
        # the three steps' change of the trainables against JAX's change,
        # relative L2 over all of them: a step that moved nothing gives 1;
        # Adam's rate-sized steps on near-zero gradient elements, whose
        # sign the summation order can flip, keep it near 0.06 in bf16
        num = den = 0.0
        for n, w in w0.items():
            dj = np.asarray(jsd.get_value(n)) - w
            num += float(((psd.get_value(n) - w - dj) ** 2).sum())
            den += float((dj ** 2).sum())
        assert den > 0 and (num / den) ** 0.5 < (0.2 if bf16 else 1e-2)
        # weights: f32 2e-5 (Adam turns summation-order noise of
        # near-zero gradient elements into rate-sized steps); bf16: an
        # Adam step moves a weight by about the rate, and a near-zero bf16
        # gradient can take the other sign in the other package's
        # summation order, so two runs can part by twice the rate a step
        for n in jsd.variables():
            np.testing.assert_allclose(psd.get_value(n), np.asarray(jsd.get_value(n)),
                                       atol=2 * 3 * 1e-3 if bf16 else 2e-5, rtol=0)


class TestControlFlow:
    def test_v1_while_with_capture(self):
        def build():
            x = tf1.placeholder(tf.float32, [4], name="x")
            scale = tf.constant(2.0, name="scale")
            tf1.while_loop(lambda i, a: i < 5, lambda i, a: (i + 1, a * scale + 1.0),
                           [tf.constant(0), x], name="loop")
            tf.identity(tf1.get_default_graph().get_tensor_by_name("loop/Exit_1:0"),
                        name="out")

        assert_pair(tf_graph(build, v1=True), {"x": np.array([1., -2., 3., .5], np.float32)},
                    "out")

    def test_v1_while_dynamic_capture_and_two_loops(self):
        def build():
            x = tf1.placeholder(tf.float32, [3], name="x")
            s = tf1.placeholder(tf.float32, [], name="s")
            _, a1 = tf1.while_loop(lambda i, a: i < 4, lambda i, a: (i + 1, a + s),
                                   [tf.constant(0), x], name="l1")
            _, a2 = tf1.while_loop(lambda i, a: i < 2, lambda i, a: (i + 1, a * 3.0),
                                   [tf.constant(0), a1], name="l2")
            tf.identity(a2, name="out")

        assert_pair(tf_graph(build, v1=True),
                    {"x": np.zeros(3, np.float32), "s": np.float32(2.5)}, "out")

    @pytest.mark.parametrize("const_branch", [False, True])
    def test_v1_cond_both_branches(self, const_branch):
        def build():
            x = tf1.placeholder(tf.float32, [4], name="x")
            if const_branch:
                y = tf1.cond(tf.reduce_sum(x) > 0.0,
                             lambda: tf.constant(np.full(4, 7.0, np.float32)),
                             lambda: x * 2.0, name="branch")
            else:
                y = tf1.cond(tf.reduce_sum(x) > 0.0, lambda: x * 2.0 + 1.0,
                             lambda: x - 3.0, name="branch")
            tf.identity(y, name="out")

        g = tf_graph(build, v1=True)
        jsd, psd = both(g.as_graph_def().SerializeToString())
        xv = np.array([1., -2., 3., .5], np.float32)
        for v in (xv, -xv):
            want = golden(g, {"x:0": v}, "out:0")
            got = _np(psd.output({"x": v}, "out"))
            np.testing.assert_allclose(got, np.asarray(jsd.output({"x": v}, "out")), **F32_TOL)
            np.testing.assert_allclose(got, want, atol=1e-5)
        assert psd.host_controlled()

    def test_v2_multi_output_if_and_functional_while(self):
        from tensorflow.python.framework.convert_to_constants import (
            convert_variables_to_constants_v2,
        )

        @tf.function
        def f(x):
            _, acc = tf.while_loop(lambda i, a: i < 5, lambda i, a: (i + 1, a * 2.0 + 1.0),
                                   [tf.constant(0), x])
            a, b = tf.cond(tf.reduce_sum(acc) > 0.0, lambda: (acc * 2.0, acc + 1.0),
                           lambda: (acc - 1.0, acc * 3.0))
            return a + b

        cfn = f.get_concrete_function(tf.TensorSpec([4], tf.float32))
        raw = convert_variables_to_constants_v2(
            cfn, lower_control_flow=False).graph.as_graph_def().SerializeToString()
        jsd, psd = both(raw)
        assert while_attrs(psd) == while_attrs(jsd) == [{"max_trip": 5, "exact_trip": True}]
        for v in (np.array([1., -2., 3., .5], np.float32),
                  np.array([-9., -2., -3., -.5], np.float32)):
            got = _np(psd.output({"x": v}, "Identity"))
            np.testing.assert_allclose(got, np.asarray(jsd.output({"x": v}, "Identity")),
                                       **F32_TOL)
            np.testing.assert_allclose(got, f(tf.constant(v)).numpy(), atol=1e-5)


class TestNestedFrames:
    def test_two_level_nested_while_with_outer_capture(self):
        def build():
            x = tf1.placeholder(tf.float32, [2], name="x")
            s = tf1.placeholder(tf.float32, [], name="s")

            def outer_body(i, a):
                _, a2 = tf1.while_loop(lambda j, b: j < 2, lambda j, b: (j + 1, b + s),
                                       [tf.constant(0), a], name="inner")
                return i + 1, a2 * 0.5

            _, acc = tf1.while_loop(lambda i, a: i < 2, outer_body,
                                    [tf.constant(0), x], name="outer")
            tf.identity(acc, name="out")

        assert_pair(tf_graph(build, v1=True),
                    {"x": np.array([4.0, -2.0], np.float32), "s": np.float32(3.0)}, "out")

    def test_three_level_nesting(self):
        def build():
            x = tf1.placeholder(tf.float32, [], name="x")

            def mid_body(j, b):
                _, b2 = tf1.while_loop(lambda k, c: k < 2, lambda k, c: (k + 1, c + 1.0),
                                       [tf.constant(0), b], name="l3")
                return j + 1, b2

            def outer_body(i, a):
                _, a2 = tf1.while_loop(lambda j, b: j < 2, mid_body,
                                       [tf.constant(0), a], name="l2")
                return i + 1, a2 * 1.5

            _, acc = tf1.while_loop(lambda i, a: i < 2, outer_body,
                                    [tf.constant(0), x], name="l1")
            tf.identity(acc, name="out")

        jsd, psd = assert_pair(tf_graph(build, v1=True), {"x": np.float32(1.0)}, "out")
        assert while_attrs(psd) == while_attrs(jsd)

    def test_cond_inside_while_body_runs_eagerly(self):
        def build():
            x = tf1.placeholder(tf.float32, [3], name="x")

            def body(i, a):
                a2 = tf1.cond(tf.reduce_sum(a) > 10.0, lambda: a * 0.5, lambda: a + 1.0)
                return i + 1, a2

            _, acc = tf1.while_loop(lambda i, a: i < 4, body, [tf.constant(0), x],
                                    name="loop")
            tf.identity(acc, name="out")

        g = tf_graph(build, v1=True)
        jsd, psd = both(g.as_graph_def().SerializeToString())
        # the cond sits in a loop body: the whole graph reads on the host
        assert psd.host_controlled() and not any(n.op == "_cond" for n in psd._ops)
        for xv in (np.array([1.0, 2.0, 3.0], np.float32), np.array([8.0, 9.0, 7.0], np.float32)):
            got = _np(psd.output({"x": xv}, "out"))
            np.testing.assert_allclose(got, np.asarray(jsd.output({"x": xv}, "out")), **F32_TOL)
            np.testing.assert_allclose(got, golden(g, {"x:0": xv}, "out:0"), atol=1e-5)


class TestDifferentiableImportedLoops:
    @pytest.mark.parametrize("start,pred,step,trips", [
        (0, "lt7", 1, 7), (9, "gt0", -2, 5)])
    def test_static_counters_run_exactly(self, start, pred, step, trips):
        def build():
            x = tf1.placeholder(tf.float32, [3], name="x")
            cond = (lambda i, a: i < 7) if pred == "lt7" else (lambda i, a: i > 0)
            tf1.while_loop(cond, lambda i, a: (i + step, a * 2.0 + 0.5),
                           [tf.constant(start), x], name="loop")
            tf.identity(tf1.get_default_graph().get_tensor_by_name("loop/Exit_1:0"),
                        name="out")

        jsd, psd = assert_pair(tf_graph(build, v1=True),
                               {"x": np.array([1.0, -1.0, 0.5], np.float32)}, "out")
        assert while_attrs(psd) == while_attrs(jsd) == [
            {"max_trip": trips, "exact_trip": True}]

    def _data_dependent(self):
        def build():
            x = tf1.placeholder(tf.float32, [], name="x")
            tf1.while_loop(lambda a: a < 100.0, lambda a: a * 2.0, [x], name="loop")
            tf.identity(tf1.get_default_graph().get_tensor_by_name("loop/Exit:0"),
                        name="out")

        return tf_graph(build, v1=True)

    def test_data_dependent_pred_is_a_host_loop(self):
        g = self._data_dependent()
        jsd, psd = both(g.as_graph_def().SerializeToString())
        assert while_attrs(psd) == while_attrs(jsd) == [{"max_trip": None, "exact_trip": False}]
        assert psd.host_controlled()
        for xv in (3.0, 150.0):
            got = _np(psd.output({"x": np.float32(xv)}, "out"))
            np.testing.assert_allclose(got, golden(g, {"x:0": np.float32(xv)}, "out:0"))

    def test_trip_bound_differentiates(self):
        import jax
        import jax.numpy as jnp

        g = self._data_dependent()
        jsd, psd = both(g.as_graph_def().SerializeToString(), loop_trip_bound=16)
        assert while_attrs(psd) == [{"max_trip": 16, "exact_trip": False}]
        assert not psd.host_controlled()
        for xv in (3.0, 0.5, 150.0):
            np.testing.assert_allclose(_np(psd.output({"x": np.float32(xv)}, "out")),
                                       golden(g, {"x:0": np.float32(xv)}, "out:0"))

        def jf(v):
            return jsd._execute({**jsd._values, "x": v}, ("out",))[0]

        x = torch.tensor(3.0, requires_grad=True)
        (out,) = psd._execute({**psd._values, "x": x}, ("out",))
        (gx,) = torch.autograd.grad(out, x)
        assert float(gx) == float(jax.grad(jf)(jnp.float32(3.0))) == 64.0

    def test_trainable_loop_capture_promotes_and_trains(self):
        rng = np.random.default_rng(3)
        wv = (rng.normal(size=(3, 3)) * 0.5).astype(np.float32)

        def build():
            x = tf1.placeholder(tf.float32, [2, 3], name="x")
            wl = tf.constant(wv, name="W")
            tf1.while_loop(lambda i, a: i < 4,
                           lambda i, a: (i + 1, tf.tanh(tf.matmul(a, wl))),
                           [tf.constant(0), x], name="loop")
            tf.identity(tf1.get_default_graph().get_tensor_by_name("loop/Exit_1:0"),
                        name="out")

        g = tf_graph(build, v1=True)
        jsd, psd = both(g.as_graph_def().SerializeToString(), trainable=True)
        assert "W" in psd._trainable and while_attrs(psd) == while_attrs(jsd)
        xv = rng.normal(size=(2, 3)).astype(np.float32)
        for sd in (jsd, psd):
            sd.set_loss(sd.apply("sum", sd.apply("square", sd["out"]), name="loss"))
        jg = jsd.grad({"x": xv})["W"]
        pg = psd.grad({"x": xv})["W"]
        np.testing.assert_allclose(_np(pg), np.asarray(jg), **F32_TOL)
        for sd, tc, adam in ((jsd, JaxTC, JaxAdam), (psd, TrainingConfig, Adam)):
            sd.set_training_config(tc(updater=adam(5e-2)))
        jl = [jsd.fit_batch({"x": xv}) for _ in range(3)]
        pl = [psd.fit_batch({"x": xv}) for _ in range(3)]
        np.testing.assert_allclose(pl, jl, **F32_TOL)

    def test_trip_bound_reaches_nested_function_loops(self):
        from tensorflow.python.framework.convert_to_constants import (
            convert_variables_to_constants_v2,
        )

        @tf.function
        def inner(x):
            return tf.while_loop(lambda a: tf.reduce_sum(a) < 10.0, lambda a: a * 2.0, [x])[0]

        @tf.function
        def fn(x):
            return inner(x) + 1.0

        cfn = fn.get_concrete_function(tf.TensorSpec([2], tf.float32))
        raw = convert_variables_to_constants_v2(
            cfn, lower_control_flow=False).graph.as_graph_def().SerializeToString()
        jsd, psd = both(raw, loop_trip_bound=12)
        ph = next(iter(psd._placeholders))
        xv = np.array([0.5, 0.7], np.float32)
        got = _np(psd.output({ph: xv}, "Identity"))
        np.testing.assert_allclose(got, np.asarray(jsd.output({ph: xv}, "Identity")), **F32_TOL)
        np.testing.assert_allclose(got, fn(tf.constant(xv)).numpy(), rtol=1e-6)
        x = torch.tensor(xv, requires_grad=True)
        (out,) = psd._execute({**psd._values, ph: x}, ("Identity",))
        (gx,) = torch.autograd.grad(out.sum(), x)
        assert torch.isfinite(gx).all() and gx.abs().max() > 0


class TestErrorPaths:
    def test_unsupported_op_inside_loop_names_body(self):
        def build():
            x = tf1.placeholder(tf.complex64, [4], name="x")
            tf1.while_loop(lambda i, a: i < 2, lambda i, a: (i + 1, tf1.fft(a)),
                           [tf.constant(0), x], name="loop")

        raw = tf_graph(build, v1=True).as_graph_def().SerializeToString()
        with pytest.raises(TFImportError, match="while frame"):
            import_graph(raw, device="cpu")

    def test_unsupported_op_named(self):
        def build():
            tf1.fft(tf1.placeholder(tf.complex64, [4], name="x"), name="out")

        with pytest.raises(TFImportError, match="FFT"):
            import_graph(tf_graph(build).as_graph_def().SerializeToString(), device="cpu")

    def test_dynamic_reshape_rejected(self):
        def build():
            x = tf1.placeholder(tf.float32, [None, 4], name="x")
            s = tf1.placeholder(tf.int32, [2], name="s")
            tf.reshape(x, s, name="out")

        with pytest.raises(TFImportError, match="constant"):
            import_graph(tf_graph(build).as_graph_def().SerializeToString(), device="cpu")

    def test_training_mode_batchnorm_rejected(self):
        def build():
            x = tf1.placeholder(tf.float32, [2, 4, 4, 3], name="x")
            tf1.nn.fused_batch_norm(x, tf.constant(np.ones(3, np.float32)),
                                    tf.constant(np.zeros(3, np.float32)), is_training=True,
                                    name="bn")

        with pytest.raises(TFImportError, match="is_training"):
            import_graph(tf_graph(build).as_graph_def().SerializeToString(), device="cpu")

    def test_onnx_waits_and_default_device_is_cuda(self, monkeypatch):
        with pytest.raises(NotImplementedError, match="A13"):
            import_onnx("model.onnx")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        raw = build_bert_classifier_graphdef(vocab=8, d_model=4, n_layers=1, n_heads=2,
                                             seq_len=2, batch=1)
        with pytest.raises(RuntimeError, match="CUDA"):
            import_graph(raw)

    def test_facade_from_file_and_graphdef(self, tmp_path):
        def build():
            x = tf1.placeholder(tf.float32, [None, 2], name="x")
            tf.identity(x * 2.0, name="out")

        p = tmp_path / "g.pb"
        p.write_bytes(tf_graph(build).as_graph_def().SerializeToString())
        sd = TFGraphMapper.import_graph(str(p), device="cpu")
        np.testing.assert_allclose(_np(sd.output({"x": np.ones((1, 2), np.float32)}, "out")),
                                   [[2.0, 2.0]])
        from deeplearning4j_tpu_torch.modelimport._tf import wire

        gd = wire.GraphDef()
        gd.ParseFromString(p.read_bytes())
        assert import_graph(gd, device="cpu").import_source["raw"] == p.read_bytes()


class TestSourceBackedSerde:
    def _loop_raw(self):
        def build():
            x = tf1.placeholder(tf.float32, [3], name="x")
            _, acc = tf1.while_loop(lambda i, a: i < 4, lambda i, a: (i + 1, a * 2.0 + 1.0),
                                    [tf.constant(0), x], name="loop")
            tf.identity(acc, name="out")

        return tf_graph(build, v1=True).as_graph_def().SerializeToString()

    def test_while_graph_roundtrips_both_ways(self, tmp_path):
        raw = self._loop_raw()
        jsd, psd = both(raw)
        xv = np.array([1.0, -2.0, 0.5], np.float32)
        want = np.asarray(jsd.output({"x": xv}, "out"))
        pp, jp = str(tmp_path / "port.zip"), str(tmp_path / "jax.zip")
        psd.save(pp)
        jsd.save(jp)
        for sd in (SameDiff.load(pp, device="cpu"), SameDiff.load(jp, device="cpu")):
            np.testing.assert_allclose(_np(sd.output({"x": xv}, "out")), want, **F32_TOL)
        np.testing.assert_allclose(np.asarray(JaxSameDiff.load(pp).output({"x": xv}, "out")),
                                   want, **F32_TOL)

    def test_finetuned_import_with_head_resumes_across_packages(self, tmp_path):
        """Config 4's shape: import trainable, attach a head, fine-tune,
        save (a graph with no control flow: the plain zip, as the JAX
        package writes it), load in the other package, resume: the next
        step agrees with the run that was never saved."""
        raw = build_bert_classifier_graphdef(vocab=32, d_model=8, n_layers=1, n_heads=2,
                                             seq_len=6, batch=4, n_classes=2, seed=1)
        rng = np.random.default_rng(0)
        head = rng.normal(0, 0.1, (2, 2)).astype(np.float32)
        ids = rng.integers(0, 32, (4, 6)).astype(np.int32)
        y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]
        feed = {"ids": ids, "labels": y}
        sds = both(raw, trainable=True)
        for sd, tc, adam in zip(sds, (JaxTC, TrainingConfig), (JaxAdam, Adam)):
            out = sd.apply("matmul", sd["logits"], sd.var("head_w", head))
            sd.set_loss(sd.apply("softmax_cross_entropy", out, sd.placeholder("labels"),
                                 name="fine_loss"))
            sd.set_training_config(tc(updater=adam(5e-3)))
            for _ in range(2):
                sd.fit_batch(feed)
        jsd, psd = sds
        pp, jp = str(tmp_path / "port.zip"), str(tmp_path / "jax.zip")
        psd.save(pp)
        jsd.save(jp)
        with zipfile.ZipFile(pp) as pz, zipfile.ZipFile(jp) as jz:
            assert sorted(pz.namelist()) == sorted(jz.namelist())
            assert "graph.json" in pz.namelist()
        want = psd.fit_batch(feed)
        jwant = jsd.fit_batch(feed)
        np.testing.assert_allclose(want, jwant, **F32_TOL)
        port_from_jax = SameDiff.load(jp, device="cpu")
        jax_from_port = JaxSameDiff.load(pp)
        assert "head_w" in port_from_jax.variables() and "head_w" in jax_from_port.variables()
        np.testing.assert_allclose(port_from_jax.fit_batch(feed), jwant, **F32_TOL)
        np.testing.assert_allclose(jax_from_port.fit_batch(feed), want, **F32_TOL)
        again = SameDiff.load(pp, device="cpu")
        assert again.fit_batch(feed) == want      # the port's own zip: same bits

    def test_hand_built_control_flow_still_rejects(self, tmp_path):
        sd = SameDiff(device="cpu")
        x = sd.placeholder("x")
        sd.while_loop(lambda v: (v < 5).all(), lambda v: (v + 1,), x)
        with pytest.raises(ValueError, match="rebuild the graph"):
            sd.save(str(tmp_path / "nope.zip"))

    def test_split_and_splitv(self):
        def build():
            x = tf1.placeholder(tf.float32, [2, 6], name="x")
            a, b2, c = tf.split(x, 3, axis=1)
            d, e = tf.split(x, [2, 4], axis=1)
            tf.identity(b2, name="mid")
            tf.identity(tf.concat([a, c], 1), name="outer")
            tf.identity(e - d[:, :1], name="v")

        g = tf_graph(build)
        xv = np.random.default_rng(8).normal(size=(2, 6)).astype(np.float32)
        for fetch in ("mid", "outer", "v"):
            assert_pair(g, {"x": xv}, fetch)


class TestResize:
    @pytest.mark.parametrize("size", [(16, 12), (3, 3), (5, 12)])
    def test_resize_bilinear_follows_jax_and_c30(self, size):
        """ResizeBilinear (half-pixel centres) imports as
        ``jax.image.resize``'s bilinear in both packages; the port equals
        the JAX import at every size.  C30: when a side shrinks,
        ``jax.image.resize`` widens its kernel (antialiasing) and TF does
        not, so the reference parts from TensorFlow there; upscaling
        equals TF."""
        rng = np.random.default_rng(6)

        def build():
            x = tf1.placeholder(tf.float32, [2, 8, 8, 3], name="x")
            tf1.image.resize_bilinear(x, list(size), half_pixel_centers=True, name="out")

        g = tf_graph(build)
        jsd, psd = both(g.as_graph_def().SerializeToString())
        xv = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
        got = _np(psd.output({"x": xv}, "out"))
        np.testing.assert_allclose(got, np.asarray(jsd.output({"x": xv}, "out")), **F32_TOL)
        tf_gap = np.abs(got - golden(g, {"x:0": xv}, "out:0")).max()
        if min(size) >= 8:
            assert tf_gap <= 1e-5
        else:
            assert tf_gap > 0.1

    def test_resize_modes_the_importer_rejects(self):
        def build():
            x = tf1.placeholder(tf.float32, [1, 4, 4, 1], name="x")
            tf1.image.resize_bilinear(x, [8, 8], align_corners=True, name="out")

        with pytest.raises(TFImportError, match="half_pixel_centers"):
            import_graph(tf_graph(build).as_graph_def().SerializeToString(), device="cpu")
