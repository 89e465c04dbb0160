"""Listener dispatch in the model base (`models/model.py`),
`train/listeners.py` and `train/preemption.py` on the CPU, against the
JAX package where the two can be compared.

- Lazy scores: a fit whose listeners read no score fetches no loss to
  the host; with readers, one fetch a step program (a group of K steps
  fetches once).  The scores listeners see are the steps' own losses,
  the same as K single steps give.
- A listener that raises leaves ``iteration`` counting every step that
  ran.
- The alias check: a listener that keeps the live parameter or
  optimizer tensors raises after its first dispatch; one that copies
  does not.
- The JAX package's listener and preemption cases
  (`tests/test_training_tools.py` ``TestListeners`` and
  ``TestAsyncCheckpoint``, `tests/test_preemption.py`) on the port, the
  preemption checkpointer a `CheckpointStore` (the JAX cases' sharded
  checkpointer is ROADMAP A11's).
- An ``async_save`` `CheckpointListener` zip restores in the JAX package
  (parameters, optimizer state, output within 1e-6) and in the port bit
  for bit; the scores `CollectScoresListener` records equal the JAX
  model's from the same weights within 1e-6.
"""

import os
import signal

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.data.iterator import NumpyDataSetIterator as JaxIt
from deeplearning4j_tpu.models.sequential import SequentialModel as JaxSM
from deeplearning4j_tpu.nn.activations import Activation as JAct
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.layers import Dense as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOut
from deeplearning4j_tpu.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.losses import Loss as JLoss
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu.train import CollectScoresListener as JCollect
from deeplearning4j_tpu.train.checkpoint import ModelSerializer as JaxMS
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import NumpyDataSetIterator
from deeplearning4j_tpu_torch.models import model as model_base
from deeplearning4j_tpu_torch.models.model import tree_leaves
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
    SequentialConfiguration,
)
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.updaters import Adam, state_leaves
from deeplearning4j_tpu_torch.train import (
    CheckpointListener,
    CheckpointStore,
    CollectScoresListener,
    EvaluativeListener,
    PerformanceListener,
    ScoreIterationListener,
    TimeIterationListener,
    TrainingListener,
)
from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer
from deeplearning4j_tpu_torch.train.preemption import (
    PreemptionError,
    PreemptionHandler,
)

torch.set_num_threads(1)


def _toy_problem(n=256, n_in=8, k=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, n_in)).astype(np.float32)
    w = rng.normal(size=(n_in, k))
    y = np.argmax(x @ w, axis=1)
    return x, np.eye(k, dtype=np.float32)[y]


def _mlp(n_in=8, k=3, hidden=16, lr=0.05):
    return (NeuralNetConfiguration.builder().seed(42).updater(Adam(lr)).list()
            .layer(Dense(n_out=hidden, activation=Activation.RELU, name="d0"))
            .layer(Dense(n_out=hidden, activation=Activation.RELU, name="d1"))
            .layer(OutputLayer(n_out=k, loss=Loss.MCXENT,
                               activation=Activation.SOFTMAX, name="out"))
            .set_input_type(InputType.feed_forward(n_in)).build())


def _jax_mlp(lr=0.05):
    return (JNNC.builder().seed(42).updater(JAdam(lr)).list()
            .layer(JDense(n_out=16, activation=JAct.RELU, name="d0"))
            .layer(JDense(n_out=16, activation=JAct.RELU, name="d1"))
            .layer(JOut(n_out=3, loss=JLoss.MCXENT, activation=JAct.SOFTMAX,
                        name="out"))
            .set_input_type(JIT.feed_forward(8)).build())


def _model(conf=None):
    return SequentialModel(conf or _mlp(), device="cpu").init()


def _batches(n=8, batch=16, seed=0):
    x, y = _toy_problem(n=n * batch, seed=seed)
    return [DataSet(x[i:i + batch], y[i:i + batch]) for i in range(0, n * batch, batch)]


class _Fetches:
    """Counts host fetches of lazy scores."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = model_base._LazyScores.fetch

        def fetch(lazy):
            if lazy._host is None:
                self.n += 1
            return real(lazy)

        monkeypatch.setattr(model_base._LazyScores, "fetch", fetch)


# -- lazy scores ------------------------------------------------------------

def test_scores_are_fetched_only_when_read_and_once_a_program(monkeypatch):
    fetches = _Fetches(monkeypatch)
    m = _model()
    m.set_listeners(TimeIterationListener(100, frequency=1), PerformanceListener(2, 2))
    m.fit(_batches(8), steps_per_execution=4)
    assert m.iteration == 8 and fetches.n == 0     # nobody read a score
    collect = CollectScoresListener()
    m.set_listeners(collect, ScoreIterationListener(1))
    m.fit(_batches(8), steps_per_execution=4)
    assert fetches.n == 2                          # two groups, one fetch each
    assert [i for i, _ in collect.scores] == list(range(9, 17))
    m.fit(_batches(3))
    assert fetches.n == 5                          # single steps: one a step


def test_grouped_scores_are_each_steps_own_loss():
    a, b = _model(), _model()
    ca, cb = CollectScoresListener(), CollectScoresListener()
    a.set_listeners(ca)
    b.set_listeners(cb)
    a.fit(_batches(8), steps_per_execution=4)
    b.fit(_batches(8))
    assert ca.scores == cb.scores
    assert len({s for _, s in ca.scores}) == 8
    assert a.score_value == ca.scores[-1][1]


def test_scores_match_the_jax_models():
    x, y = _toy_problem(n=128)
    jm = JaxSM(_jax_mlp()).init()
    m = SequentialModel(SequentialConfiguration.from_json(jm.conf.to_json()),
                        device="cpu").init()
    jc, pc = JCollect(), CollectScoresListener()
    jm.set_listeners(jc)
    m.set_listeners(pc)
    jm.fit(JaxIt(x, y, batch_size=32), epochs=2)
    m.fit(NumpyDataSetIterator(x, y, batch_size=32), epochs=2)
    assert [i for i, _ in pc.scores] == [i for i, _ in jc.scores]
    np.testing.assert_allclose([s for _, s in pc.scores],
                               [s for _, s in jc.scores], rtol=1e-6, atol=1e-6)


# -- a listener that raises ------------------------------------------------

class _Boom(TrainingListener):
    def __init__(self, at):
        self.at = at

    def iteration_done(self, model, iteration, epoch, score):
        if iteration == self.at:
            raise RuntimeError("listener failed")


@pytest.mark.parametrize("spe,at,want", [(4, 2, 4), (4, 7, 8), (1, 3, 3)])
def test_a_raising_listener_leaves_iteration_counting_every_step(spe, at, want):
    m = _model()
    m.set_listeners(_Boom(at))
    with pytest.raises(RuntimeError, match="listener failed"):
        m.fit(_batches(8), steps_per_execution=spe)
    assert m.iteration == want
    assert np.isfinite(m.score_value)


# -- the alias check --------------------------------------------------------

class _Stash(TrainingListener):
    def __init__(self, what, copy=False):
        self.what, self.copy, self.kept = what, copy, None

    def iteration_done(self, model, iteration, epoch, score):
        if self.kept is None:
            tree = getattr(model, self.what)
            if self.copy:
                tree = [t.detach().clone() for t in tree_leaves(tree)]
            self.kept = tree


@pytest.mark.parametrize("what", ["params", "opt_state", "net_state"])
def test_a_listener_that_keeps_live_tensors_raises_and_a_copy_does_not(what):
    conf = _mlp()
    if what == "net_state":
        from deeplearning4j_tpu_torch.nn.conf.layers import BatchNorm

        conf = (NeuralNetConfiguration.builder().seed(1).list()
                .layer(Dense(n_out=8, name="d0"))
                .layer(BatchNorm(name="bn"))
                .layer(OutputLayer(n_out=3, name="out"))
                .set_input_type(InputType.feed_forward(8)).build())
    m = _model(conf)
    m.set_listeners(_Stash(what))
    with pytest.raises(RuntimeError, match="overwrites them in place"):
        m.fit(_batches(3))
    assert m.iteration == 1
    m2 = _model(conf)
    m2.set_listeners(_Stash("params", copy=True))
    m2.fit(_batches(3))
    assert m2.iteration == 3


# -- the JAX package's listener cases ------------------------------------------

def test_checkpoint_listener_rolling(tmp_path):
    x, y = _toy_problem(n=128)
    model = _model()
    lst = CheckpointListener(str(tmp_path), save_every_n_iterations=2, keep_last=2)
    model.set_listeners(lst)
    model.fit(NumpyDataSetIterator(x, y, batch_size=16), epochs=1)  # 8 iters
    avail = CheckpointListener.available_checkpoints(str(tmp_path))
    assert len(avail) == 2
    restored = CheckpointListener.last_checkpoint(str(tmp_path), device="cpu")
    assert restored.num_params() == model.num_params()
    assert os.path.exists(tmp_path / "checkpoint.txt")


def test_evaluative_listener_epoch_end():
    x, y = _toy_problem(n=128)
    val = NumpyDataSetIterator(x, y, batch_size=64, shuffle=False)
    model = _model()
    lst = EvaluativeListener(val, frequency=1, invocation=EvaluativeListener.EPOCH_END)
    model.set_listeners(lst)
    model.fit(NumpyDataSetIterator(x, y, batch_size=64), epochs=2)
    assert len(lst.evaluations) == 2
    assert 0.0 <= lst.evaluations[-1].accuracy() <= 1.0


def test_time_iteration_listener():
    x, y = _toy_problem(n=64)
    model = _model()
    lst = TimeIterationListener(total_iterations=100, frequency=1)
    model.set_listeners(lst)
    model.fit(NumpyDataSetIterator(x, y, batch_size=32), epochs=1)
    assert lst.remaining_seconds() >= 0


def _async_run(tmp_path):
    conf = (NeuralNetConfiguration.builder().seed(9).list()
            .layer(Dense(n_out=8, activation=Activation.TANH))
            .layer(OutputLayer(n_out=2, loss=Loss.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(4)).build())
    m = SequentialModel(conf, device="cpu").init()
    ck = CheckpointListener(str(tmp_path), save_every_n_iterations=2, async_save=True)
    m.set_listeners(ck)
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (16, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 16)]
    for _ in range(6):
        m.fit_batch(DataSet(x, y))
    ck.flush()
    return m, x, y


def test_async_save_restores_identically(tmp_path):
    m, x, _ = _async_run(tmp_path)
    restored = CheckpointListener.last_checkpoint(str(tmp_path), device="cpu")
    np.testing.assert_allclose(m.output(x).numpy(), restored.output(x).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert restored.iteration == 6


def test_an_async_zip_restores_in_jax_and_bit_for_bit_in_the_port(tmp_path):
    m, x, y = _async_run(tmp_path)
    path = CheckpointListener.available_checkpoints(str(tmp_path))[-1]
    back = ModelSerializer.restore(path, device="cpu")
    for a, b in zip(tree_leaves(m.params), tree_leaves(back.params)):
        assert torch.equal(a.detach(), b.detach())
    for a, b in zip(state_leaves(m.opt_state), state_leaves(back.opt_state)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    jm = JaxMS.restore(path)
    assert jm.iteration == 6
    jleaves = jax.tree.leaves(jm.params)
    for a, b in zip(tree_leaves(m.params), jleaves):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    for a, b in zip(state_leaves(m.opt_state), jax.tree.leaves(jm.opt_state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_allclose(np.asarray(jm.output(x)), m.output(x).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_a_snapshot_keeps_its_bytes_while_training_goes_on():
    from deeplearning4j_tpu_torch.train.listeners import _host_snapshot

    m = _model()
    m.fit(_batches(2))
    snap = _host_snapshot(m)
    kept = [t.clone() for t in tree_leaves(snap.params)]
    m.fit(_batches(2))
    for a, b, live in zip(kept, tree_leaves(snap.params), tree_leaves(m.params)):
        assert torch.equal(a, b) and not torch.equal(b, live.detach())


# -- preemption (the JAX package's cases) ------------------------------------

def _pmodel():
    conf = (NeuralNetConfiguration.builder().seed(1).updater(Adam(1e-2)).list()
            .layer(Dense(n_out=8)).layer(OutputLayer(n_out=2))
            .set_input_type(InputType.feed_forward(4)).build())
    return SequentialModel(conf, device="cpu").init()


def _pdata():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (64, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[rng.integers(0, 2, 64)]
    return DataSet(x, y)


def test_trigger_saves_and_raises(tmp_path):
    m = _pmodel()
    store = CheckpointStore(str(tmp_path / "p1"), device="cpu")
    handler = PreemptionHandler(store)
    m.set_listeners(handler.listener())
    handler.trigger()
    with pytest.raises(PreemptionError):
        m.fit(_pdata(), epochs=5, batch_size=32)
    assert m.iteration >= 1
    steps = store.all_steps()
    assert steps, "no preemption checkpoint written"
    m2 = store.restore_model(steps[-1])
    assert m2.iteration == steps[-1]
    handler.uninstall()


def test_real_signal_sets_flag_and_checkpoint_lands(tmp_path):
    m = _pmodel()
    store = CheckpointStore(str(tmp_path / "p2"), device="cpu")
    handler = PreemptionHandler(store, signals=(signal.SIGUSR1,))
    m.set_listeners(handler.listener())
    ds = _pdata()
    m.fit_batch(ds)
    os.kill(os.getpid(), signal.SIGUSR1)
    assert handler.preempted
    with pytest.raises(PreemptionError):
        m.fit_batch(ds)
    assert store.all_steps()
    # the checkpoint resumes: the restored model's next step is the
    # interrupted model's, bit for bit
    back = store.restore_latest()
    m.fit_batch(ds)
    back.fit_batch(ds)
    assert m.score_value == back.score_value
    handler.uninstall()


def test_no_raise_mode_continues():
    saves = []
    m = _pmodel()
    handler = PreemptionHandler(raise_after_save=False,
                                on_preempt=lambda model: saves.append(model.iteration))
    m.set_listeners(handler.listener())
    handler.trigger()
    m.fit(_pdata(), epochs=1, batch_size=32)
    assert saves and saves[0] >= 0
    handler.uninstall()


def test_uninstall_restores_previous_handler():
    prev = signal.getsignal(signal.SIGUSR2)
    h = PreemptionHandler(signals=(signal.SIGUSR2,)).install()
    assert signal.getsignal(signal.SIGUSR2) == h._on_signal
    h.uninstall()
    assert signal.getsignal(signal.SIGUSR2) == prev
