"""The LeNet slice (ROADMAP A3) against the JAX package, on the CPU, in
f32: LeNet and SimpleCNN (at 16 x 16 x 3) built, trained, evaluated,
saved, restored and quantized in both packages from seed 123.

- Initial parameters are the JAX package's bit for bit; the forward
  within 1e-5 of max |JAX|; 5 ``fit_batch`` losses within 1e-5
  (LeNet: absolute, ROADMAP A3's bar; SimpleCNN: of the loss, a mean of
  cross entropies near 5 whose f32 sums in another order move it by a
  few 1e-6 of itself, up to 1.4e-5 absolute on these inputs).
- Layer state (BatchNorm's running mean and variance) within 1e-6 of
  each leaf's max |JAX|: after the first step, and after each of 5
  steps that start from the JAX model's parameters, optimizer state and
  layer state.  (Left to run freely the two drift apart by more: a conv
  bias before a BatchNorm has a zero gradient in exact arithmetic, and
  Adam turns each package's summation noise on it into a step of up to
  the learning rate, in its own direction.)
- ``fit(steps_per_execution=3)`` gives the losses of 3 single steps.
- ``evaluate`` gives the JAX package's accuracy and confusion matrix.
- The procedural MNIST and CIFAR data and the normalizers are the JAX
  package's, byte for byte; a normalizer file restores in either.
- A checkpoint zip (with its ``netstate.npz``) goes both ways.
- Quantized LeNet's ``output()`` within 1e-5 of max p of the JAX
  package's quantized model's.
- The port's `entry()` gives ``__graft_entry__.entry()``'s logits.
- Fault plans at ``data.next_batch`` and ``data.decode`` end a fit as
  the JAX package's fit ends.
"""

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.data import builtin as jax_builtin
from deeplearning4j_tpu.data import normalizers as jax_norm
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.quant import quantize as jax_quantize
from deeplearning4j_tpu.runtime import faults as jax_faults
from deeplearning4j_tpu.train.checkpoint import ModelSerializer as JaxMS
from deeplearning4j_tpu.zoo.lenet import LeNet as JaxLeNet
from deeplearning4j_tpu.zoo.simplecnn import SimpleCNN as JaxSimpleCNN
from deeplearning4j_tpu_torch.convert import net_state_to_numpy, params_to_numpy
from deeplearning4j_tpu_torch.data import builtin, normalizers
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.entry import entry
from deeplearning4j_tpu_torch.quant import quantize
from deeplearning4j_tpu_torch.runtime import faults
from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer
from deeplearning4j_tpu_torch.zoo.lenet import LeNet
from deeplearning4j_tpu_torch.zoo.simplecnn import SimpleCNN

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZOO = {"lenet": (JaxLeNet, LeNet, {}, (28, 28, 1)),
       "simplecnn": (JaxSimpleCNN, SimpleCNN, dict(height=16, width=16), (16, 16, 3))}
# a loss's tolerance: absolute for LeNet, relative for SimpleCNN (docstring)
LOSS_TOL = {"lenet": lambda ref: 1e-5, "simplecnn": lambda ref: 1e-5 * abs(ref)}


def _batches(name, n, batch=8, seed=0):
    r = np.random.default_rng(seed)
    shape = ZOO[name][3]
    return [(r.random((batch,) + shape).astype(np.float32),
             np.eye(10, dtype=np.float32)[r.integers(0, 10, batch)]) for _ in range(n)]


def _pair(name):
    jcls, pcls, kw, _ = ZOO[name]
    return jcls(**kw).init_model(), pcls(**kw).init_model(device="cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    jax_faults.disarm()


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_model_trains_as_the_jax_package(name):
    jm, pm = _pair(name)
    for lname, lp in jm.params.items():
        for k, v in lp.items():
            np.testing.assert_array_equal(np.asarray(v), params_to_numpy(pm)[lname][k])
    assert pm.num_params() == jm.num_params()
    assert list(pm.param_table()) == list(jm.param_table())
    x0 = _batches(name, 1, seed=9)[0][0]
    assert _rel(pm.output(x0).numpy(), jm.output(x0)) <= 1e-5
    assert _rel(pm.predict(x0), jm.predict(x0)) == 0
    for step, (x, y) in enumerate(_batches(name, 5)):
        jm.fit_batch(JaxDataSet(x, y))
        pm.fit_batch(DataSet(x, y))
        assert abs(pm.score_value - jm.score_value) <= LOSS_TOL[name](jm.score_value), step
        if step == 0:
            _same_state(pm, jm)
    assert pm.iteration == jm.iteration == 5
    ref = jm.score(JaxDataSet(x, y))
    assert abs(pm.score(DataSet(x, y)) - ref) <= LOSS_TOL[name](ref)


def _same_state(pm, jm, tol=1e-6):
    assert set(net_state_to_numpy(pm)) == set(jm.net_state)
    for lname, st in jm.net_state.items():
        for k, v in st.items():
            assert _rel(net_state_to_numpy(pm)[lname][k], v) <= tol, (lname, k)


def test_each_step_updates_the_layer_state_as_the_jax_step():
    """SimpleCNN: 5 steps, each from the JAX model's parameters, Adam
    state and BatchNorm state: the port's new state within 1e-6."""
    from deeplearning4j_tpu_torch.models.sequential import tree_leaves
    from deeplearning4j_tpu_torch.nn.updaters import load_state_leaves

    jm, pm = _pair("simplecnn")
    for x, y in _batches("simplecnn", 5, seed=2):
        pm.load_params(jax.tree.map(np.asarray, jm.params))
        pm.load_net_state(jax.tree.map(np.asarray, jm.net_state))
        pm.opt_state = load_state_leaves(
            pm._tx.init(tree_leaves(pm.params)),
            [np.array(v) for v in jax.tree.leaves(jm.opt_state)])
        pm.iteration = jm.iteration
        jm.fit_batch(JaxDataSet(x, y))
        pm.fit_batch(DataSet(x, y))
        _same_state(pm, jm)
        assert abs(pm.score_value - jm.score_value) <= 1e-5 * abs(jm.score_value)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_grouped_steps_give_the_single_steps_losses(name):
    batches = _batches(name, 7, seed=3)
    jm, single = _pair(name)
    grouped = ZOO[name][1](**ZOO[name][2]).init_model(device="cpu")
    want = []
    for x, y in batches:
        single.fit_batch(DataSet(x, y))
        jm.fit_batch(JaxDataSet(x, y))
        want.append((single.score_value, jm.score_value))
    got = []
    for g in range(0, 6, 3):
        grouped.fit([DataSet(x, y) for x, y in batches[g:g + 3]],
                    steps_per_execution=3)
        assert tuple(grouped._last_score.shape) == (3,)
        got.extend(float(v) for v in grouped._last_score)
    grouped.fit([DataSet(*batches[6])], steps_per_execution=3)    # a ragged tail
    got.append(grouped.score_value)
    for (ours, theirs), g in zip(want, got):
        assert g == ours and abs(g - theirs) <= LOSS_TOL[name](theirs)
    assert grouped.iteration == 7 and grouped.epoch == 3


def test_a_group_of_mixed_shapes_steps_batch_by_batch():
    m = LeNet().init_model(device="cpu")
    ref = LeNet().init_model(device="cpu")
    bs = [DataSet(*b) for b in _batches("lenet", 2, batch=8)]
    bs.insert(1, DataSet(*_batches("lenet", 1, batch=4, seed=5)[0]))
    m.fit(bs, steps_per_execution=3)
    for b in bs:
        ref.fit_batch(b)
    assert m.score_value == ref.score_value and m.iteration == 3


def test_evaluate_gives_the_jax_accuracy_and_confusion():
    jm, pm = _pair("lenet")
    for x, y in _batches("lenet", 3, batch=16):
        jm.fit_batch(JaxDataSet(x, y))
        pm.fit_batch(DataSet(x, y))
    x, y = builtin.synthetic_mnist(64, seed=4)
    onehot = np.eye(10, dtype=np.float32)[y]
    for labels in (onehot, y):            # int ids by element count
        je = jm.evaluate(JaxDataSet(x, labels), batch_size=32)
        pe = pm.evaluate(DataSet(x, labels), batch_size=32)
        np.testing.assert_array_equal(pe.confusion_matrix, je.confusion_matrix)
        assert pe.accuracy() == je.accuracy() and pe.f1() == je.f1()
        assert pe.stats() == je.stats()


def test_procedural_data_and_normalizers_are_the_jax_packages(tmp_path):
    for fn in ("synthetic_mnist", "synthetic_cifar"):
        for a, b in zip(getattr(builtin, fn)(24, seed=3), getattr(jax_builtin, fn)(24, seed=3)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    pit = builtin.MnistDataSetIterator(10, train=False, num_examples=25)
    jit_ = jax_builtin.MnistDataSetIterator(10, train=False, num_examples=25)
    assert pit.is_synthetic == jit_.is_synthetic
    for a, b in zip(pit, jit_):
        assert a.features.tobytes() == b.features.tobytes()
        assert a.labels.tobytes() == b.labels.tobytes()
    ptr = builtin.CifarDataSetIterator(8, num_examples=24)
    jtr = jax_builtin.CifarDataSetIterator(8, num_examples=24)
    for a, b in zip(ptr, jtr):
        assert a.features.tobytes() == b.features.tobytes()
    x = np.random.default_rng(0).integers(0, 256, (12, 4, 4, 3)).astype(np.uint8)
    for cls, kw in (("NormalizerStandardize", {}), ("NormalizerMinMaxScaler",
                                                     dict(lo=-1.0, hi=2.0)),
                    ("ImagePreProcessingScaler", dict(lo=0.0, hi=1.0))):
        data = [DataSet(x[i:i + 4].astype(np.float32) if cls != "ImagePreProcessingScaler"
                        else x[i:i + 4], np.zeros((4, 1))) for i in (0, 4, 8)]
        jdata = [JaxDataSet(d.features, d.labels) for d in data]
        pn = getattr(normalizers, cls)(**kw).fit(_List(data))
        jn = getattr(jax_norm, cls)(**kw).fit(_List(jdata))
        for d, jd in zip(data, jdata):
            assert pn.transform(d).features.tobytes() == jn.transform(jd).features.tobytes()
        pn.save(str(tmp_path / "p.json"))
        jn.save(str(tmp_path / "j.json"))
        assert json.loads((tmp_path / "p.json").read_text()) == \
            json.loads((tmp_path / "j.json").read_text())
        back = normalizers.Normalizer.restore(str(tmp_path / "j.json"))
        assert back.transform(data[0]).features.tobytes() == \
            pn.transform(data[0]).features.tobytes()
        out = list(normalizers.NormalizingIterator(_List(data), back))
        assert out[1].features.tobytes() == pn.transform(data[1]).features.tobytes()


class _List:
    """A resettable list of batches."""

    def __init__(self, items):
        self.items = items

    def __iter__(self):
        return iter(self.items)

    def reset(self):
        pass


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_checkpoint_zip_goes_both_ways_with_netstate(tmp_path, direction):
    jm, pm = _pair("simplecnn")
    for x, y in _batches("simplecnn", 2):
        jm.fit_batch(JaxDataSet(x, y))
        pm.fit_batch(DataSet(x, y))
    path = str(tmp_path / "m.zip")
    x0 = _batches("simplecnn", 1, seed=8)[0][0]
    if direction == "port_to_jax":
        ModelSerializer.write_model(pm, path)
        back = JaxMS.restore(path)
        for lname, st in net_state_to_numpy(pm).items():
            for k, v in st.items():
                np.testing.assert_array_equal(np.asarray(back.net_state[lname][k]), v)
        for a, b in zip(jax.tree.leaves(back.params),
                        jax.tree.leaves(params_to_numpy(pm))):
            np.testing.assert_array_equal(np.asarray(a), b)
        assert back.iteration == 2
        assert _rel(pm.output(x0).numpy(), back.output(x0)) <= 1e-5
    else:
        JaxMS.write_model(jm, path)
        back = ModelSerializer.restore(path, device="cpu")
        for lname, st in jm.net_state.items():
            for k, v in st.items():
                np.testing.assert_array_equal(net_state_to_numpy(back)[lname][k],
                                              np.asarray(v))
        assert back.iteration == 2
        assert _rel(back.output(x0).numpy(), jm.output(x0)) <= 1e-5
        x, y = _batches("simplecnn", 1, seed=11)[0]
        jm.fit_batch(JaxDataSet(x, y))
        back.fit_batch(DataSet(x, y))
        assert abs(back.score_value - jm.score_value) <= LOSS_TOL["simplecnn"](
            jm.score_value)


def test_quantized_lenet_matches_the_jax_quantized_model():
    jm, pm = _pair("lenet")
    for x, y in _batches("lenet", 2):
        jm.fit_batch(JaxDataSet(x, y))
        pm.fit_batch(DataSet(x, y))
    jq, pq = jax_quantize(jm), quantize(pm)
    assert pq.params["layer0"]["W"].shape == tuple(jq.params["layer0"]["W"].shape)
    for lname in ("layer0", "layer2", "layer4", "layer5"):
        a, b = jq.params[lname]["W"], pq.params[lname]["W"]
        assert _rel(b.q.numpy(), np.asarray(a.q)) <= 1.0 / 127 + 1e-6
    x = _batches("lenet", 1, batch=16, seed=6)[0][0]
    want = np.asarray(jq.output(x))
    assert _rel(pq.output(x).numpy(), want) <= 1e-5
    assert pq.compute_dtype == torch.float32


def test_entry_gives_the_graft_entry_logits():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", os.path.join(REPO, "__graft_entry__.py"))
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    jfwd, (jp, js, jx) = graft.entry()
    fwd, (p, s, x) = entry(device="cpu")
    assert tuple(x.shape) == tuple(jx.shape) == (8, 28, 28, 1)
    seeded = np.random.default_rng(12).random((8, 28, 28, 1)).astype(np.float32)
    want = np.asarray(jfwd(jp, js, seeded))
    got = fwd(p, s, torch.from_numpy(seeded))
    assert tuple(got.shape) == want.shape == (8, 10)
    assert _rel(got.numpy(), want) <= 1e-5
    assert _rel(fwd(p, s, x).numpy(), np.asarray(jfwd(jp, js, jx))) <= 1e-5


@pytest.mark.parametrize("plan", ["data.next_batch:raise:nth=3",
                                  "data.decode:raise:nth=2,exc=runtime",
                                  "data.decode:corrupt:nth=2"])
def test_a_fault_plan_ends_a_fit_as_the_jax_fit_ends(plan):
    jm, pm = _pair("lenet")
    data = _batches("lenet", 4)
    outcome = []
    for m, ds, mod in ((jm, JaxDataSet, jax_faults), (pm, DataSet, faults)):
        mod.arm(plan)
        try:
            m.fit([ds(x, y) for x, y in data])
            outcome.append(("done", m.iteration, bool(np.isfinite(m.score_value))))
        except Exception as e:
            outcome.append((type(e).__name__, m.iteration, None))
        finally:
            mod.disarm()
    assert outcome[0] == outcome[1]
    assert outcome[0][0] != "done" or not outcome[0][2]


def test_a_lenet_steps_flops_are_the_count_by_hand():
    """`observe.cost` counts a LeNet step (forward and backward; the
    convolutions by FlopCounterMode's formulas) as the shapes give it by
    hand: conv1 forward and weight gradient (the images take none),
    conv2 forward and both gradients, the two dense products 6 M N K."""
    from deeplearning4j_tpu_torch.observe import cost

    batch = 4
    m = LeNet().init_model(device="cpu")
    m.fit_batch(DataSet(*_batches("lenet", 1, batch=batch)[0]))
    rec, = [r for r in cost.analyze_model(m) if r.kind == "train"]
    conv1 = 2 * 28 * 28 * 20 * 25
    conv2 = 2 * 14 * 14 * 50 * 500
    dense = 2 * 2450 * 500 + 2 * 500 * 10
    assert rec.flops == batch * (2 * conv1 + 3 * conv2 + 3 * dense)


def test_a_failing_training_capture_raises_and_never_runs_eagerly(monkeypatch):
    """The card's step path (staged inputs, then the graph) with a capture
    that fails: the error reaches the caller, and the step program is not
    run eagerly in its place."""
    from deeplearning4j_tpu_torch.runtime import graphs

    class RefusedCapture:
        def __init__(self, *a, **k):
            raise RuntimeError("operation not permitted when stream is capturing")

    m = LeNet().init_model(device="cpu")
    batch = DataSet(*_batches("lenet", 1)[0])
    m._prepare([batch])
    eager = []
    monkeypatch.setattr(graphs, "CapturedProgram", RefusedCapture)
    monkeypatch.setattr(m, "_train_step", lambda *a: eager.append(a))
    with pytest.raises(RuntimeError, match="capturing"):
        m._run_steps_cuda([batch])
    assert eager == [] and m.iteration == 0 and not m._captured


class _Recorded:
    """A stand-in `CapturedProgram` for the card's step path on the CPU:
    its warm-up runs ``fn`` as the real one does; a replay runs it again
    as if capturing (a graph replays without calling into Python, so the
    registered step program counts nothing there)."""

    made: list = []
    capturing = False

    def __init__(self, fn, inputs, *, keep=(), pool=None, stream=None):
        self.fn, self.inputs, self.pool = fn, tuple(inputs), pool
        self.stream = stream if stream is not None else object()
        self.on = stream
        self.read = [id(t) for t in keep[0]]
        token = object()                     # this graph's own pool
        self.graph = types.SimpleNamespace(pool=lambda: token)
        fn(*self.inputs)
        _Recorded.made.append(self)

    def replay(self):
        _Recorded.capturing = True
        try:
            self.fn(*self.inputs)
        finally:
            _Recorded.capturing = False


def test_installing_new_trees_drops_the_step_graphs(monkeypatch):
    """The card's step path with stand-in graphs: a step graph is reused
    across steps and in-place state loads, a second batch signature
    captures into the first graph's pool on its stream, and whatever installs new
    tensors (`load_params`, `init`, `load_net_state`, a fresh optimizer
    state) drops the graphs, so the next step captures anew, in a new
    pool, over the new parameters.  Sgd keeps no optimizer tensors and
    LeNet no layer state: nothing but the install itself can tell the
    graphs are stale.  The step program counts one dispatch a step."""
    import dataclasses

    from deeplearning4j_tpu_torch.models.sequential import SequentialModel, tree_leaves
    from deeplearning4j_tpu_torch.nn.updaters import Sgd, load_state_leaves, state_leaves
    from deeplearning4j_tpu_torch.runtime import graphs

    monkeypatch.setattr(graphs, "CapturedProgram", _Recorded)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: _Recorded.capturing)
    _Recorded.made = []
    conf = dataclasses.replace(LeNet().conf(), updater=Sgd(0.1))
    m = SequentialModel(conf, device="cpu").init()
    b8, b4 = (DataSet(*_batches("lenet", 1, batch=n)[0]) for n in (8, 4))

    def step(batch):
        m._prepare([batch])
        m._run_steps_cuda([batch])

    def fresh(pool_of=None):
        prog = _Recorded.made[-1]
        assert prog.read == [id(p) for p in tree_leaves(m.params)]
        assert prog.pool == (None if pool_of is None else pool_of.graph.pool())
        assert prog.on is (None if pool_of is None else pool_of.stream)

    step(b8)
    step(b8)
    assert len(_Recorded.made) == 1
    fresh()
    step(b4)                                   # a second signature
    assert len(_Recorded.made) == 2 and m.compile_stats()["step_programs"] == 2
    fresh(pool_of=_Recorded.made[0])
    m.opt_state = load_state_leaves(m.opt_state, state_leaves(m.opt_state))
    step(b8)                                   # in place: the same graph
    assert len(_Recorded.made) == 2
    other = SequentialModel(dataclasses.replace(conf, seed=7), device="cpu").init().params
    for install in (lambda: m.load_params(other), m.init,
                    lambda: m.load_net_state({}),
                    lambda: setattr(m, "opt_state", None)):
        n = len(_Recorded.made)
        install()
        step(b8)
        assert len(_Recorded.made) == n + 1 and m.compile_stats()["step_programs"] == 1
        fresh()
    assert m._step_program()._cost_record.dispatches == 4 + 4
