"""The port's device prefetch (`data/prefetch.py`, `AsyncDataSetIterator`,
`Model._prefetch_feed`) on the CPU: the contract cases of the JAX
package's `tests/test_prefetch.py`.

- Order and bytes: staged batches come out in the base iterator's order
  with identical values, as torch tensors on the staging device, each
  with its producer seconds; a `MultiDataSet` stages every array.
- Bounded depth: the producer never runs more than ``depth`` batches
  ahead of the consumer.
- A producer error reaches the consumer after every batch staged before
  it; abandoning or closing an iteration joins the producer thread.
- ``fit`` trains the same model, bit for bit, with and without the
  pipeline (``environment().prefetch_depth`` 2 and 0), for a sequential
  and a graph model; ``prefetch_depth`` 0 disables the wrap, and so does
  an in-memory feed.
- The ``data.prefetch`` fault site: a raise ends the fit after the
  batches before it trained, with no thread left; a delay changes
  nothing.  The overlap accounting: a slow feed's producer seconds show
  up as ``overlap_s`` and as ``overlap_seconds`` on ``train_step`` spans.
- Staging onto the card is asked for by default, and raises here.  The
  ``data.decode`` corrupt action poisons a staged batch's tensors where
  they lie.
"""

import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterator import (
    AsyncDataSetIterator,
    DataSetIterator,
    ExistingDataSetIterator,
)
from deeplearning4j_tpu_torch.data.prefetch import PrefetchIterator, stage_to_device
from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
from deeplearning4j_tpu_torch.models.model import tree_leaves
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf import graph_conf
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.nn.updaters import Sgd
from deeplearning4j_tpu_torch.runtime import faults
from deeplearning4j_tpu_torch.runtime.flags import Environment, environment


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()


@pytest.fixture
def depth():
    """Restores ``environment().prefetch_depth`` after a test sets it."""
    env = environment()
    saved = env.prefetch_depth
    yield env
    env.prefetch_depth = saved


def small_model():
    conf = (NeuralNetConfiguration.builder().seed(7).updater(Sgd(0.1)).list()
            .layer(Dense(n_out=8, activation=Activation.TANH))
            .layer(OutputLayer(n_out=3, activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(5)).build())
    return SequentialModel(conf, device="cpu").init()


def small_graph():
    conf = (graph_conf.GraphBuilder().seed(7).updater(Sgd(0.1))
            .add_inputs("in").set_input_types(InputType.feed_forward(5))
            .add_layer("h", Dense(n_out=8, activation=Activation.TANH), "in")
            .add_layer("out", OutputLayer(n_out=3, activation=Activation.SOFTMAX), "h")
            .set_outputs("out").build())
    return GraphModel(conf, device="cpu").init()


def batches(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [DataSet(rng.normal(0, 1, (8, 5)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.integers(0, 3, 8)])
            for _ in range(n)]


class _LazyFeed(DataSetIterator):
    """A feed that produces each batch on ``next()`` (the kind the fit
    loops wrap; in-memory lists are exempt)."""

    batch_size = 8

    def __init__(self, n, seed=0, sleep=0.0):
        self._n, self._seed, self._sleep = n, seed, sleep

    def reset(self):
        pass

    def __iter__(self):
        for b in batches(self._n, self._seed):
            time.sleep(self._sleep)
            yield b


class _Raising(DataSetIterator):
    def __init__(self, good, exc):
        self._good, self._exc = good, exc

    def reset(self):
        pass

    def __iter__(self):
        yield from self._good
        raise self._exc


def _no_producer_left(timeout=5.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not any(t.name == "dl4jtpu-prefetch" and t.is_alive()
                   for t in threading.enumerate()):
            return True
        time.sleep(0.01)
    return False


def test_order_and_bytes_survive_staging():
    src = batches(6)
    out = list(PrefetchIterator(ExistingDataSetIterator(src), depth=2, device="cpu"))
    assert len(out) == len(src)
    for staged, ref in zip(out, src):
        assert isinstance(staged.features, torch.Tensor)
        np.testing.assert_array_equal(staged.features.numpy(), ref.features)
        np.testing.assert_array_equal(staged.labels.numpy(), ref.labels)
        assert staged._prefetch_stage_s >= 0.0


def test_a_multidataset_and_uint8_stage_unchanged():
    r = np.random.default_rng(1)
    img = r.integers(0, 256, (4, 3, 3, 2)).astype(np.uint8)
    mds = MultiDataSet((img, r.normal(size=(4, 2)).astype(np.float32)),
                       (np.eye(2, dtype=np.float32)[[0, 1, 1, 0]],),
                       None, (np.ones((4,), np.float32),))
    staged = stage_to_device(mds, "cpu")
    assert staged.features[0].dtype == torch.uint8
    np.testing.assert_array_equal(staged.features[0].numpy(), img)
    np.testing.assert_array_equal(staged.labels_masks[0].numpy(), np.ones(4))
    assert staged.features_masks is None


def test_bounded_depth_backpressure():
    produced = []

    class Tracking(DataSetIterator):
        batch_size = 8

        def reset(self):
            pass

        def __iter__(self):
            for i, b in enumerate(batches(10)):
                produced.append(i)
                yield b

    depth = 2
    it = iter(PrefetchIterator(Tracking(), depth=depth, stage=None))
    assert next(it) is not None
    deadline = time.time() + 5.0
    while len(produced) < 1 + depth and time.time() < deadline:
        time.sleep(0.01)
    time.sleep(0.2)
    # 1 consumed + ``depth`` queued + 1 blocked in put() at most
    assert len(produced) <= 1 + depth + 1
    rest = list(it)
    assert len(rest) == 9 and len(produced) == 10


def test_producer_exception_surfaces_in_order():
    feed = PrefetchIterator(_Raising(batches(3), ValueError("decode exploded")),
                            depth=2, device="cpu")
    got = []
    with pytest.raises(ValueError, match="decode exploded"):
        for b in feed:
            got.append(b)
    assert len(got) == 3


def test_abandoned_and_closed_iterations_stop_the_producer():
    feed = PrefetchIterator(ExistingDataSetIterator(batches(50)), depth=2, stage=None)
    it = iter(feed)
    next(it)
    feed.close()
    assert _no_producer_left()
    it2 = iter(AsyncDataSetIterator(ExistingDataSetIterator(batches(50)),
                                    queue_size=2, device="cpu"))
    next(it2)
    it2.close()                      # the generator's finally joins the thread
    assert _no_producer_left()


@pytest.mark.parametrize("kind", ["sequential", "graph"])
def test_fit_is_the_same_with_and_without_prefetch(depth, kind):
    make = small_model if kind == "sequential" else small_graph
    depth.prefetch_depth = 0
    serial = make()
    serial.fit(_LazyFeed(5), epochs=2)
    depth.prefetch_depth = 2
    piped = make()
    piped.fit(_LazyFeed(5), epochs=2)
    assert serial.iteration == piped.iteration == 10
    for a, b in zip(tree_leaves(serial.params), tree_leaves(piped.params)):
        np.testing.assert_array_equal(a.detach().numpy(), b.detach().numpy())
    assert piped.overlap_s >= 0.0 and serial.overlap_s == 0.0


def test_prefetch_depth_zero_disables_the_wrap(depth):
    faults.arm("data.prefetch:raise:nth=1,exc=runtime")
    depth.prefetch_depth = 0
    m = small_model()
    feed = _LazyFeed(3)
    assert m._prefetch_feed(feed) is feed
    m.fit(feed, epochs=1)
    assert m.iteration == 3
    assert faults.active_plan().stats().get("data.prefetch", {}).get("consults", 0) == 0
    depth.prefetch_depth = 3
    wrapped = m._prefetch_feed(feed)
    assert isinstance(wrapped, PrefetchIterator) and wrapped.depth == 3


def test_prefetch_depth_reads_its_environment_variable(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PREFETCH_DEPTH", "0")
    assert Environment.from_env().prefetch_depth == 0
    monkeypatch.delenv("DL4J_TPU_PREFETCH_DEPTH")
    assert Environment.from_env().prefetch_depth == 2


@pytest.mark.parametrize("kind", ["sequential", "graph"])
def test_a_raise_at_data_prefetch_ends_the_fit_in_place(kind):
    faults.arm("data.prefetch:raise:nth=3,exc=runtime")
    m = small_model() if kind == "sequential" else small_graph()
    with pytest.raises(faults.InjectedError, match="data.prefetch"):
        m.fit(_LazyFeed(6), epochs=1)
    assert m.iteration == 2
    assert faults.active_plan().stats()["data.prefetch"]["fires"] == 1
    assert _no_producer_left()


def test_a_delay_at_data_prefetch_is_absorbed():
    faults.arm("data.prefetch:delay:every=2,secs=0.02")
    m = small_model()
    m.fit(_LazyFeed(4), epochs=1)
    assert m.iteration == 4


def test_in_memory_feeds_are_exempt():
    faults.arm("data.prefetch:raise:nth=1,exc=runtime")
    m = small_model()
    m.fit(batches(3), epochs=1)
    m.fit(ExistingDataSetIterator(batches(2)), epochs=1)
    assert m.iteration == 5
    assert faults.active_plan().stats().get("data.prefetch", {}).get("consults", 0) == 0


def test_overlap_lands_on_the_model_and_the_train_step_spans():
    from deeplearning4j_tpu_torch.observe.trace import tracer

    rec = tracer()
    rec.enable()
    rec.clear()
    try:
        m = small_model()
        m.fit(_LazyFeed(5, sleep=0.02), epochs=1)
    finally:
        rec.disable()
    steps = [e for e in rec.to_chrome_trace()["traceEvents"] if e["name"] == "train_step"]
    assert steps
    assert max(e["args"].get("overlap_seconds", 0.0) for e in steps) > 0.0
    assert m.overlap_s > 0.0


def test_staging_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default stages onto it")
    with pytest.raises(RuntimeError, match="CUDA"):
        PrefetchIterator(ExistingDataSetIterator(batches(1)))
    with pytest.raises(RuntimeError, match="CUDA"):
        stage_to_device(batches(1)[0])


def test_a_corrupt_decode_poisons_a_staged_batch_where_it_lies():
    """The ``data.decode`` corrupt action on a prefetched batch: its float
    tensors NaN-filled on their own device, integer labels kept, and the
    fit trains on through NaN losses (no recovery policy, ROADMAP A9)."""
    from deeplearning4j_tpu_torch.models.model import _poison_batch

    staged = stage_to_device(DataSet(np.ones((2, 5), np.float32),
                                     np.array([1, 2], np.int64)), "cpu")
    bad = _poison_batch(staged)
    assert isinstance(bad.features, torch.Tensor) and torch.isnan(bad.features).all()
    assert torch.equal(bad.labels, staged.labels)
    assert not torch.isnan(staged.features).any()
    faults.arm("data.decode:corrupt:nth=2")
    m = small_model()
    m.fit(_LazyFeed(3), epochs=1)
    assert m.iteration == 3 and np.isnan(m.score_value)
