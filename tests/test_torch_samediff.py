"""The port's SameDiff (`deeplearning4j_tpu_torch/autodiff/`) against the
JAX package's, graph for graph: each graph is built the same way in both
packages (the same names, values and ops) and held to the JAX result —
forward, `grad`, namespaces, per-step `fit` losses with Sgd and Adam and
l2 (f32: 1e-5), bf16 compute (a stated bf16 bound), dropout masks bit
for bit, control flow, `multi_head_dot_product_attention` with its
gradients, `TrainingConfig` JSON, and zips loaded across the packages.
Mirrors `tests/test_samediff.py` and `tests/test_samediff_ext.py`."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu import autodiff as jad
from deeplearning4j_tpu.nn import updaters as jup
from deeplearning4j_tpu.utils import serde as jserde
from deeplearning4j_tpu_torch import autodiff as pad
from deeplearning4j_tpu_torch.nn import updaters as pup
from deeplearning4j_tpu_torch.utils import serde as pserde

F32_TOL = dict(rtol=1e-5, atol=1e-5)
PKG = {"jax": (jad, jup), "port": (pad, pup)}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def new_sd(pkg, seed=0):
    return pad.SameDiff(seed=seed, device="cpu") if pkg == "port" else jad.SameDiff(seed=seed)


def mlp(pkg, seed=0, dropout=None, bf16=False, updater="adam", l2=0.0):
    """A two-layer classifier graph, the same in both packages."""
    ad, up = PKG[pkg]
    rng = np.random.default_rng(seed)
    sd = new_sd(pkg, seed)
    x, y = sd.placeholder("x"), sd.placeholder("y")
    w1 = sd.var("w1", 0.5 * rng.normal(size=(6, 16)).astype(np.float32))
    b1 = sd.var("b1", np.zeros(16, np.float32))
    w2 = sd.var("w2", 0.5 * rng.normal(size=(16, 3)).astype(np.float32))
    h = sd.nn.tanh((x @ w1) + b1, name="h")
    if dropout:
        h = sd.nn.dropout(h, rate=dropout, name="drop")
    logits = sd.apply("matmul", h, w2, name="logits")
    sd.loss.softmax_cross_entropy(logits, y, name="loss")
    opt = {"adam": up.Adam(1e-2), "sgd": up.Sgd(0.1), "nesterovs": up.Nesterovs(0.05)}[updater]
    sd.set_training_config(ad.TrainingConfig(updater=opt, loss_variable="loss", l2=l2,
                                             bf16_compute=bf16))
    return sd


def data(seed=0, n=32):
    rng = np.random.default_rng(seed + 100)
    X = rng.normal(size=(n, 6)).astype(np.float32)
    Y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return {"x": X, "y": Y}


class TestForwardAndGrad:
    def _graph(self, pkg):
        rng = np.random.default_rng(3)
        sd = new_sd(pkg)
        x = sd.placeholder("x")
        k = sd.var("k", 0.2 * rng.normal(size=(3, 3, 2, 4)).astype(np.float32))
        g = sd.var("g", np.ones(4, np.float32))
        b = sd.var("b", np.zeros(4, np.float32))
        c = sd.nn.conv2d(x, k, stride=(1, 1), padding="SAME", name="c")
        p = sd.nn.max_pool2d(sd.nn.relu(c), kernel=(2, 2), stride=(2, 2), name="p")
        n = sd.nn.layer_norm(p, g, b, name="n")
        f = sd.nn.gelu(n).reshape((2, -1))
        w = sd.var("w", 0.1 * rng.normal(size=(64, 5)).astype(np.float32))
        logits = sd.math.matmul(f, w, name="logits")
        probs = sd.nn.softmax(logits, name="probs")
        sd.set_loss(sd.apply("sum", sd.math.square(probs - 0.2) * 3.0 + 1.0 / (logits ** 2.0 + 1.0),
                             name="loss"))
        return sd

    def test_forward_and_grad_match_jax(self):
        xv = np.random.default_rng(4).normal(size=(2, 8, 8, 2)).astype(np.float32)
        j, p = self._graph("jax"), self._graph("port")
        for name in ("c", "p", "n", "logits", "probs", "loss"):
            np.testing.assert_allclose(_np(p.output({"x": xv}, name)),
                                       np.asarray(j.output({"x": xv}, name)), **F32_TOL)
        jg, pg = j.grad({"x": xv}), p.grad({"x": xv})
        assert sorted(jg) == sorted(pg) == ["b", "g", "k", "w"]
        for n in jg:
            np.testing.assert_allclose(_np(pg[n]), np.asarray(jg[n]), **F32_TOL)
        np.testing.assert_allclose(_np(p.grad({"x": xv}, "k")["k"]), np.asarray(jg["k"]),
                                   **F32_TOL)

    def test_namespaces_match_jax(self):
        rng = np.random.default_rng(5)
        x4 = rng.normal(size=(4, 4)).astype(np.float32)
        ints = rng.integers(0, 16, (4, 4)).astype(np.int32)

        def build(pkg):
            sd = new_sd(pkg)
            a, i = sd.placeholder("a"), sd.placeholder("i")
            outs = [
                sd.math.cumsum(a, axis=1), sd.math.top_k_values(a, k=2), sd.linalg.inv(
                    a @ sd.math.transpose(a) + sd.math.eye(n=4) * 4.0),
                sd.linalg.triu(a, k=1), sd.bitwise.bitwise_xor(i, i * 3),
                sd.bitwise.left_shift(i, bits=2), sd.cnn.space_to_depth(
                    a.reshape((1, 4, 4, 1)), block=2),
                sd.rnn.gru_cell(a, a, sd.constant("w", np.eye(4, 12, dtype=np.float32)),
                                sd.constant("r", np.eye(4, 12, dtype=np.float32)),
                                sd.constant("b", np.zeros(12, np.float32))),
                sd.loss.huber_loss(a, a * 0.5, delta=0.7), sd.image.flip_lr(
                    a.reshape((1, 4, 4, 1))), sd.random.random_normal(shape=(3, 2), seed=5),
                sd.nn.one_hot(i, depth=16), sd.math.argmax(a, axis=0),
            ]
            return sd, [o.name for o in outs]

        (j, names), (p, pnames) = build("jax"), build("port")
        assert names == pnames
        feed = {"a": x4, "i": ints}
        for got, want in zip(p.output(feed, *names), j.output(feed, *names)):
            want = np.asarray(want)
            assert _np(got).dtype == want.dtype
            np.testing.assert_allclose(_np(got), want, **F32_TOL)
        with pytest.raises(NotImplementedError, match="A13"):
            sdw = new_sd("port")
            sdw.output({"a": x4}, sdw.signal.fft(sdw.placeholder("a")).name)
        with pytest.raises(AttributeError):
            new_sd("port").nn.not_an_op


class TestTraining:
    @pytest.mark.parametrize("updater,l2", [("sgd", 0.0), ("adam", 0.0), ("adam", 1e-2),
                                            ("nesterovs", 1e-3)])
    def test_per_step_losses_match_jax(self, updater, l2):
        j, p = mlp("jax", updater=updater, l2=l2), mlp("port", updater=updater, l2=l2)
        feeds = [data(s) for s in range(3)]
        jl = j.fit(feeds, epochs=2)
        pl = p.fit(feeds, epochs=2)
        np.testing.assert_allclose(pl, jl, **F32_TOL)
        for n in j.variables():
            np.testing.assert_allclose(p.get_value(n), np.asarray(j.get_value(n)),
                                       rtol=1e-5, atol=2e-5)

    def test_bf16_compute_within_bf16_bound(self):
        j, p = mlp("jax", bf16=True), mlp("port", bf16=True)
        feed = data(1)
        jl = [j.fit_batch(feed) for _ in range(3)]
        pl = [p.fit_batch(feed) for _ in range(3)]
        # both round every floating value to bf16 in the step: the losses
        # agree to a couple of bf16 ulps (2^-7 relative)
        np.testing.assert_allclose(pl, jl, rtol=2**-7, atol=0)
        # and they are bf16 losses: the port's f32 run of the same steps
        # lies farther from them than the JAX bf16 run does
        f = mlp("port")
        fl = [f.fit_batch(feed) for _ in range(3)]
        assert np.abs(np.subtract(pl, fl)).max() > np.abs(np.subtract(pl, jl)).max()
        assert p._values["w1"].dtype == torch.float32

    def test_dropout_masks_bit_for_bit(self):
        j, p = mlp("jax", dropout=0.4), mlp("port", dropout=0.4)
        feed = data(2)
        jk = jax.random.key(11)
        pk = tuple(int(v) for v in np.asarray(jax.random.key_data(jk)))
        jenv = {**j._values, "x": jnp.asarray(feed["x"])}
        penv = {**p._values, "x": torch.from_numpy(feed["x"])}
        (jd,) = j._execute(jenv, ("drop",), rng=jk)
        (pd,) = p._execute(penv, ("drop",), rng=pk)
        jd, pd = np.asarray(jd), _np(pd)
        np.testing.assert_array_equal(pd == 0, jd == 0)
        np.testing.assert_allclose(pd, jd, **F32_TOL)
        jl = [j.fit_batch(feed) for _ in range(3)]
        pl = [p.fit_batch(feed) for _ in range(3)]
        np.testing.assert_allclose(pl, jl, **F32_TOL)

    def test_fit_refusals_and_generators(self):
        sd = new_sd("port")
        x = sd.placeholder("x")
        sd.var("w", np.zeros((2, 1), np.float32))
        with pytest.raises(ValueError, match="set_training_config"):
            sd.fit_batch({"x": np.ones((1, 2), np.float32)})
        sd = mlp("port")
        losses = sd.fit((data(s) for s in range(3)), epochs=2)
        assert len(losses) == 6 and all(np.isfinite(losses))
        del x

    def test_failure_after_updating_is_not_retryable(self, monkeypatch):
        sd = mlp("port", updater="sgd")
        sd.fit_batch(data(0))
        with pytest.raises(RuntimeError):             # before any update: plain
            sd.fit_batch({"x": np.ones((4, 5), np.float32), "y": data(0)["y"][:4]})
        assert not sd._updating
        sd.fit_batch(data(0))                         # still usable

        def broken(*a, **k):
            raise MemoryError("device lost mid-update")

        tx = sd._training_config.updater.to_tx()
        monkeypatch.setattr(type(sd._training_config.updater), "to_tx",
                            lambda self, *a, **k: tx._replace(update=broken))
        with pytest.raises(RuntimeError, match="no longer retryable") as info:
            sd.fit_batch(data(0))
        assert isinstance(info.value.__cause__, MemoryError)

    def test_missing_and_duplicate_names(self):
        sd = new_sd("port")
        x, y = sd.placeholder("x"), sd.placeholder("y")
        z = x + y
        with pytest.raises(ValueError, match="missing placeholder"):
            sd.output({"x": np.ones(2, np.float32)}, z.name)
        with pytest.raises(ValueError, match="already exists"):
            sd.apply("relu", x, name="x")
        assert len(sd._ops) == 1

    def test_default_device_is_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            pad.SameDiff()


def _while_graph(pkg, **kw):
    sd = new_sd(pkg)
    x = sd.placeholder("x")
    i0 = sd.constant("i0", np.array(0, np.int32))
    _, acc = sd.while_loop(lambda i, a: i < 6, lambda i, a: (i + 1, a * 1.5), i0, x,
                           name="loop", **kw)
    return sd, acc.name


class TestControlFlow:
    def test_if_cond(self):
        for pkg in ("jax", "port"):
            sd = new_sd(pkg)
            x, pred = sd.placeholder("x"), sd.placeholder("p")
            sd.if_cond(pred, lambda v: v * 2.0, lambda v: v - 1.0, x, name="y")
            for pv, want in ((True, [6.0]), (False, [2.0])):
                out = sd.output({"x": np.array([3.0], np.float32), "p": np.array(pv)}, "y")
                np.testing.assert_allclose(_np(out), want)
            assert pkg == "jax" or sd.host_controlled()

    @pytest.mark.parametrize("kw", [{}, {"max_trip": 6, "exact_trip": True},
                                    {"max_trip": 10}], ids=["host", "exact", "masked"])
    def test_while_loop_forms_match_and_differentiate(self, kw):
        xv = np.array([2.0, -1.0], np.float32)
        (j, jn), (p, pn) = _while_graph("jax", **kw), _while_graph("port", **kw)
        np.testing.assert_allclose(_np(p.output({"x": xv}, pn)),
                                   np.asarray(j.output({"x": xv}, jn)), rtol=1e-6)
        assert p.host_controlled() == (not kw)
        if kw:
            xt = torch.tensor(xv, requires_grad=True)
            (o,) = p._execute({**p._values, "x": xt}, (pn,))
            (g,) = torch.autograd.grad(o.sum(), xt)
            jg = jax.grad(lambda v: jnp.sum(j._execute({**j._values, "x": v}, (jn,))[0]))(
                jnp.asarray(xv))
            np.testing.assert_allclose(_np(g), np.asarray(jg), rtol=1e-5)
            np.testing.assert_allclose(_np(g), [1.5 ** 6] * 2, rtol=1e-5)

    def test_masked_loop_gradient_survives_nan_body_past_termination(self):
        sd = new_sd("port")
        x0 = sd.placeholder("x0")
        (xf,) = sd.while_loop(lambda x: x > 0.6, lambda x: (torch.sqrt(x - 0.5),), x0,
                              name="loop", max_trip=8)
        v = torch.tensor(1.6, requires_grad=True)
        (o,) = sd._execute({**sd._values, "x0": v}, (xf.name,))
        assert 0.4 < float(o.detach()) < 0.6
        (g,) = torch.autograd.grad(o, v)
        assert torch.isfinite(g)

    def test_py_call(self):
        for pkg, lib in (("jax", jnp), ("port", torch)):
            sd = new_sd(pkg)
            x = sd.placeholder("x")
            a, b = sd.py_call(lambda v: (lib.exp(v), v * v), x, n_out=2, name="f")
            out = sd.output({"x": np.array([0.0, 1.0], np.float32)}, a.name, b.name)
            np.testing.assert_allclose(_np(out[0]), [1.0, np.e], rtol=1e-6)
            np.testing.assert_allclose(_np(out[1]), [0.0, 1.0])

    def test_control_flow_not_serializable(self, tmp_path):
        sd = new_sd("port")
        x = sd.placeholder("x")
        sd.if_cond(sd.constant("p", np.array(True)), lambda v: v, lambda v: -v, x, name="y")
        with pytest.raises(ValueError, match="control-flow"):
            sd.save(str(tmp_path / "g.zip"))


class TestAttention:
    def _graph(self, pkg, causal):
        rng = np.random.default_rng(9)
        sd = new_sd(pkg)
        q, k, v = (sd.var(n, 0.5 * rng.normal(size=(2, 16, 2, 8)).astype(np.float32))
                   for n in "qkv")
        o = sd.nn.multi_head_dot_product_attention(q, k, v, causal=causal, name="o")
        sd.set_loss(sd.apply("sum", o * sd.constant("w", rng.normal(
            size=(2, 16, 2, 8)).astype(np.float32)), name="loss"))
        return sd

    @pytest.mark.parametrize("causal", [False, True])
    def test_outputs_and_gradients_match_jax(self, causal):
        j, p = self._graph("jax", causal), self._graph("port", causal)
        np.testing.assert_allclose(_np(p.output({}, "o")), np.asarray(j.output({}, "o")),
                                   **F32_TOL)
        jg, pg = j.grad({}), p.grad({})
        for n in "qkv":
            np.testing.assert_allclose(_np(pg[n]), np.asarray(jg[n]), **F32_TOL)


class TestSerde:
    def test_training_config_json_both_ways(self):
        jc = jad.TrainingConfig(updater=jup.Adam(2e-5), l2=1e-4, loss_variable="loss",
                                bf16_compute=True)
        pc = pad.TrainingConfig(updater=pup.Adam(2e-5), l2=1e-4, loss_variable="loss",
                                bf16_compute=True)
        assert json.loads(pserde.dumps(pc)) == json.loads(jserde.dumps(jc))
        assert pserde.loads(jserde.dumps(jc)) == pc
        assert jserde.loads(pserde.dumps(pc)) == jc
        assert "TrainingConfig" not in pserde.UNPORTED

    @pytest.mark.parametrize("dropout", [None, 0.3])
    def test_zips_load_and_resume_across_packages(self, tmp_path, dropout):
        j, p = mlp("jax", dropout=dropout), mlp("port", dropout=dropout)
        feeds = [data(s) for s in range(2)]
        j.fit(feeds)
        p.fit(feeds)
        jp, pp = str(tmp_path / "jax.zip"), str(tmp_path / "port.zip")
        j.save(jp)
        p.save(pp)
        jwant = [j.fit_batch(feeds[i % 2]) for i in range(3)]
        pwant = [p.fit_batch(feeds[i % 2]) for i in range(3)]
        from_jax = pad.SameDiff.load(jp, device="cpu")
        from_port = jad.SameDiff.load(pp)
        np.testing.assert_allclose([from_jax.fit_batch(feeds[i % 2]) for i in range(3)],
                                   jwant, **F32_TOL)
        np.testing.assert_allclose([from_port.fit_batch(feeds[i % 2]) for i in range(3)],
                                   pwant, **F32_TOL)
        again = pad.SameDiff.load(pp, device="cpu")
        assert [again.fit_batch(feeds[i % 2]) for i in range(3)] == pwant
        for n in j.variables():
            np.testing.assert_allclose(from_jax.get_value(n), np.asarray(j.get_value(n)),
                                       rtol=1e-5, atol=2e-5)

    def test_a_changed_trainable_set_starts_a_fresh_adam_state(self, tmp_path):
        sd = mlp("port")
        sd.fit_batch(data(0))
        path = str(tmp_path / "g.zip")
        sd.save(path)
        back = pad.SameDiff.load(path, device="cpu")
        assert back._opt_state is not None
        back._trainable.discard("b1")
        import zipfile

        with zipfile.ZipFile(path) as zf:
            back._load_opt_state(zf)
        assert back._opt_state is None


class TestValidationHarness:
    def test_gradient_check_passes_and_catches(self):
        rng = np.random.default_rng(0)
        params = {"w": torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)),
                  "b": torch.zeros(3)}
        x = torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32))
        res = pad.gradient_check(lambda p: torch.mean(torch.square(x @ p["w"] + p["b"])), params)
        assert res.passed, res.failures

        class BadSquare(torch.autograd.Function):
            @staticmethod
            def forward(ctx, v):
                ctx.save_for_backward(v)
                return v * v

            @staticmethod
            def backward(ctx, g):
                (v,) = ctx.saved_tensors
                return g * 3.0 * v          # wrong: should be 2 v

        res = pad.gradient_check(lambda p: BadSquare.apply(p["w"]).sum(),
                                 {"w": torch.tensor([1.0, 2.0, -1.5])})
        assert not res.passed and res.max_rel_error > 0.2

    def test_opvalidation(self):
        rng = np.random.default_rng(1)
        sd = new_sd("port")
        x = sd.placeholder("x")
        w = sd.var("w", rng.normal(size=(4, 2)).astype(np.float32))
        y = sd.math.matmul(x, w, name="y")
        sd.set_loss(sd.loss.mse_loss(y, sd.placeholder("labels"), name="loss"))
        xv = rng.normal(size=(3, 4)).astype(np.float32)
        tc = pad.TestCase(sd, placeholders={"x": xv, "labels": rng.normal(
            size=(3, 2)).astype(np.float32)}, expected={"y": xv @ sd.get_value("w")})
        assert pad.OpValidation.validate(tc) == []
        assert "coverage" in pad.OpValidation.coverage_report()
        bad = pad.TestCase(sd, placeholders={"x": xv}, expected={"y": xv @ sd.get_value("w") + 1},
                           gradient_check=False)
        assert "mismatch" in pad.OpValidation.validate(bad)[0]
