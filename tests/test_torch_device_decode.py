"""The port's device data pipeline (`deeplearning4j_tpu_torch/datavec/device.py`
and the fused steps of `models/model.py`) against the JAX package's
(`deeplearning4j_tpu/datavec/device.py`), on the CPU.

- Every spec's torch ``device_apply`` and numpy ``host_apply`` against
  the JAX package's jitted ``device_apply`` on the same input and key,
  within 1e-6 (relative and absolute: the JAX package's own host /
  device bound; an f32 mean summed in another order lands an ulp away);
  ``host_apply`` against the JAX package's ``host_apply`` bit for bit.
- ``rng.randint``, the per-spec keys, `RandomCrop`'s offsets and
  `RandomFlip`'s coins against jax over many seeds and step indices, bit
  for bit; the keys staged as a device tensor draw what Python ints draw.
- A fused ``fit`` of a small `SequentialModel` (single steps and grouped)
  and of a single-input `GraphModel`, each from the JAX model's weights
  (one configuration's JSON), against the JAX package's fused fit: the
  losses of 3 steps within 1e-5 relative; the fused fit equals the same
  fit with the decode on the host (``device_decode`` off) bit for bit.
- Every fallback (a chain that does not lower, TBPTT, the compressed
  exchange, 1F1B, a graph of several inputs, a grouped graph fit) with
  the JAX package's reason, its log line and its
  ``dl4jtpu_device_decode_fallbacks_total`` count, and training on the
  host-decoded batches; the flag off is silent.
- The raw feed: uint8 step inputs, raw host-to-device bytes, the
  calibrated decode seconds and the registered ``"decode"`` program;
  masked and untaggable batches decoded on the host; augmentation keys
  that follow the feed's counter across ``evaluate``; a group mixing
  raw and decoded batches stepped batch by batch; the
  ``data.device_decode`` fault site.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.data.dataset import DataSet as JDS
from deeplearning4j_tpu.data.iterator import ExistingDataSetIterator as JEDI
from deeplearning4j_tpu.datavec import device as jdv
from deeplearning4j_tpu.models.computation_graph import GraphModel as JGM
from deeplearning4j_tpu.models.sequential import SequentialModel as JSM
from deeplearning4j_tpu.nn.conf import graph_conf as jg
from deeplearning4j_tpu.nn.conf import layers as jl
from deeplearning4j_tpu.nn.conf import recurrent as jrec
from deeplearning4j_tpu.nn.conf.input_type import InputType as JIT
from deeplearning4j_tpu.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration as JNNC,
)
from deeplearning4j_tpu.nn.updaters import Adam as JAdam
from deeplearning4j_tpu_torch.data import normalizers as pnorm
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import (
    DataSetIterator,
    ExistingDataSetIterator,
)
from deeplearning4j_tpu_torch.datavec import device as pdv
from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphConfiguration
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    SequentialConfiguration,
)
from deeplearning4j_tpu_torch.observe import cost
from deeplearning4j_tpu_torch.observe.metrics import registry
from deeplearning4j_tpu_torch.runtime import faults, rng
from deeplearning4j_tpu_torch.runtime.flags import environment

torch.set_num_threads(1)

TOL = 1e-6
LOSS_REL = 1e-5
R = np.random.default_rng(7)
IMG_U8 = R.integers(0, 256, (6, 12, 14, 3)).astype(np.uint8)
IMG_F32 = R.normal(0, 1, (6, 12, 14, 3)).astype(np.float32)
IDS = R.integers(0, 5, 6)
SEQ = R.normal(0, 1, (3, 21, 4)).astype(np.float32)
SEQ_MASK = (np.arange(21)[None, :] < np.array([[21], [15], [9]])).astype(np.float32)
KEY_SEED, KEY_STEP = 11, 5


def _counter(name, **labels):
    return registry().counter(name).value(**labels)


def _jkey(salt):
    return jax.random.fold_in(jax.random.fold_in(jax.random.key(KEY_SEED), KEY_STEP), salt)


def _pkey(salt):
    return rng.fold_in(rng.fold_in(rng.key(KEY_SEED), KEY_STEP), salt)


@jdv.device_transform
def _jax_custom(x, key):
    return x.astype(jnp.float32) * 2.0 - 1.0


@pdv.device_transform
def _port_custom(x, key):
    return x.to(torch.float32) * 2.0 - 1.0


def _specs(m):
    """(id, spec, features, mask) cases of one package's module."""
    mean, std = np.float32([100.0, 120.0, 90.0]), np.float32([40.0, 35.0, 50.0])
    mn, mx = np.float32([0.0, 10.0, 5.0]), np.float32([255.0, 200.0, 250.0])
    custom = _jax_custom if m is jdv else _port_custom
    return [
        ("scale_u8", m.Scale(1 / 127.5, -1.0), IMG_U8, None),
        ("scale_f32", m.Scale(0.37, 0.1), IMG_F32, None),
        ("standardize_u8", m.Standardize(mean, std), IMG_U8, None),
        ("standardize_f32", m.Standardize(mean, std), IMG_F32, None),
        ("minmax_u8", m.MinMaxScale(mn, mx, -1.0, 1.0), IMG_U8, None),
        ("minmax_f32", m.MinMaxScale(mn, mx), IMG_F32, None),
        ("center_crop", m.CenterCrop(7, 9), IMG_U8, None),
        ("random_crop_u8", m.RandomCrop(8, 9), IMG_U8, None),
        ("random_crop_f32", m.RandomCrop(12, 3), IMG_F32, None),
        ("random_flip", m.RandomFlip(0.5), IMG_U8, None),
        ("random_flip_rows", m.RandomFlip(0.3, axis=1), IMG_F32, None),
        ("mean_pool", m.MeanPool((2, 7)), IMG_U8, None),
        ("mean_pool_collapse", m.MeanPool((4, 2), collapse_channels=True), IMG_F32, None),
        ("one_hot", m.OneHot(5), IDS, None),
        ("pad_to_bucket", m.PadToBucket(8), SEQ, None),
        ("pad_to_bucket_masked", m.PadToBucket(16), SEQ, SEQ_MASK),
        ("pad_aligned", m.PadToBucket(7), SEQ, None),
        ("custom_marked", m.Custom(custom), IMG_U8, None),
    ]


CASES = [c[0] for c in _specs(pdv)]


@pytest.mark.parametrize("case", CASES)
def test_spec_matches_jax(case):
    (_, jspec, x, mask), = [c for c in _specs(jdv) if c[0] == case]
    (_, pspec, _, _), = [c for c in _specs(pdv) if c[0] == case]
    jk = _jkey(0) if jspec.needs_key else None
    pk = _pkey(0) if pspec.needs_key else None
    jx, jm = jax.jit(lambda a, m_, k: jspec.device_apply(a, m_, k))(x, mask, jk)
    jx, jm = np.asarray(jx), None if jm is None else np.asarray(jm)
    dx, dm = pspec.device_apply(torch.from_numpy(x.copy()),
                                None if mask is None else torch.from_numpy(mask), pk)
    hx, hm = pspec.host_apply(x, mask, pk)
    jhx, jhm = jspec.host_apply(x, mask, jk)
    for got in (dx.numpy(), np.asarray(hx)):
        assert got.shape == jx.shape and got.dtype == jx.dtype
        np.testing.assert_allclose(got, jx, rtol=TOL, atol=TOL)
    assert np.array_equal(np.asarray(hx), np.asarray(jhx))
    if jm is None:
        assert dm is None and hm is None
    else:
        assert np.array_equal(dm.numpy(), jm) and np.array_equal(hm, jm)
        assert np.array_equal(hm, np.asarray(jhm))


def _key_data(k):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(k)))


@pytest.mark.parametrize("span", [1, 2, 5, 33, 257, 65537, 2**31 - 1])
def test_randint_matches_jax_bit_for_bit(span):
    for seed in range(40):
        k = jax.random.fold_in(jax.random.key(seed), 3 * seed + span)
        lo = min(seed - 20, 2**31 - 1 - span)
        want = np.asarray(jax.random.randint(k, (9,), lo, lo + span))
        got = rng.randint(_key_data(k), (9,), lo, lo + span)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        words = torch.tensor(_key_data(k), dtype=torch.int64)
        staged = rng.randint((words[0], words[1]), (), lo, lo + span)
        assert int(staged) == int(jax.random.randint(k, (), lo, lo + span))


def test_randint_empty_span_returns_minval():
    k = jax.random.key(4)
    for lo, hi in ((3, 3), (5, 2)):
        assert int(rng.randint(_key_data(k), (), lo, hi)) == int(
            jax.random.randint(k, (), lo, hi)) == lo


def _aug_chain(m, seed):
    return m.TransformChain((m.RandomCrop(9, 10), m.Scale(1 / 255.0),
                             m.RandomFlip(0.5), m.RandomFlip(0.25, axis=1)),
                            (m.OneHot(5), m.Custom(_jax_custom if m is jdv else _port_custom)),
                            seed=seed)


def test_spec_keys_crop_offsets_and_flip_coins_match_jax():
    """Over many seeds and step indices: the per-spec keys are JAX's
    (fold_in of the step, then of salt + position), and so are the crop
    offsets and flip coins the host and the device draw from them."""
    for seed in (0, 1, 7, 123, 2**31 - 1):
        jchain, pchain = _aug_chain(jdv, seed), _aug_chain(pdv, seed)
        for step in (0, 1, 2, 17, 999, 2**32 - 1):
            keys = pdv.spec_keys(pchain, step)
            base = jax.random.fold_in(jax.random.key(seed), np.uint32(step))
            want = [_key_data(jax.random.fold_in(base, s)) for s in (0, 1, 2, 3, 1000, 1001)]
            needs = [True, False, True, True, False, True]
            for row, w, n in zip(keys, want, needs):
                assert tuple(row) == (w if n else (0, 0))
            crop = pchain.features[0]
            top, left = crop.offsets(IMG_U8.shape, tuple(keys[0]))
            kt, kl = jax.random.split(jax.random.fold_in(base, 0))
            assert int(top) == int(jax.random.randint(kt, (), 0, 12 - 9 + 1))
            assert int(left) == int(jax.random.randint(kl, (), 0, 14 - 10 + 1))
            coins = pchain.features[2].coins(6, tuple(keys[2])).numpy()
            assert np.array_equal(coins, np.asarray(jax.random.bernoulli(
                jax.random.fold_in(base, 2), 0.5, (6,))))
            staged = torch.from_numpy(keys)
            dev = pdv._apply_chain(pchain, staged, torch.from_numpy(IMG_U8),
                                   torch.from_numpy(IDS), device=True)
            host = pdv._apply_chain(pchain, keys, IMG_U8, IDS, device=False)
            jhost = jdv._apply_chain(jchain, np.uint32(step), IMG_U8, IDS, device=False)
            for d, h, j in zip(dev[:2], host[:2], jhost[:2]):
                assert np.array_equal(np.asarray(h), np.asarray(j))
                assert np.array_equal(d.numpy(), np.asarray(h))


def test_whole_chain_device_matches_jax_fused_decode():
    jchain, pchain = _aug_chain(jdv, 9), _aug_chain(pdv, 9)
    jdec, pdec = jdv.DeviceDecode(jchain), pdv.DeviceDecode(pchain)
    fn = jax.jit(jdec.fn)
    for step in range(6):
        jf, jy, _, _ = fn(jnp.uint32(step), IMG_U8, IDS)
        pf, py, pfm, plm = pdec.fn(step, torch.from_numpy(IMG_U8), torch.from_numpy(IDS))
        assert pfm is None and plm is None
        np.testing.assert_allclose(pf.numpy(), np.asarray(jf), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(py.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
        host = pdec.host(step, DataSet(IMG_U8, IDS))
        jhost = jdec.host(step, JDS(IMG_U8, IDS))
        assert np.array_equal(host.features, jhost.features)
        assert host._raw_for_device_decode is False


# -- lowering ------------------------------------------------------------------


def test_lowering_refusals_and_memo():
    def opaque(x, key):
        return x

    for m in (jdv, pdv):
        dec, reason = m.try_lower(m.TransformChain((m.Custom(opaque),), ()))
        assert dec is None and "not marked @device_transform" in reason
        dec, reason = m.try_lower(m.TransformChain(("not a transform",), ()))
        assert dec is None and "unknown transform" in reason
        assert m.try_lower("junk") == (None, "not a TransformChain: str")
    chain = pdv.TransformChain((pdv.Scale(2.0),), ())
    assert pdv.try_lower(chain)[0] is pdv.try_lower(chain)[0]


def test_fingerprints_match_jax_and_tell_closures_apart():
    def make(m, c):
        @m.device_transform
        def adjust(x, key):
            return x * c

        return adjust

    a = pdv.TransformChain((pdv.Custom(make(pdv, 0.5)),), ())
    b = pdv.TransformChain((pdv.Custom(make(pdv, 0.9)),), ())
    assert a.fingerprint() != b.fingerprint()
    for build in (lambda m: m.TransformChain((m.Scale(0.5, 1.0), m.RandomCrop(3, 4)),
                                             (m.OneHot(7),), seed=3),
                  lambda m: m.TransformChain((m.Standardize(np.float32([1.5]),
                                                            np.float32([2.0])),
                                              m.PadToBucket(16)), ())):
        assert build(pdv).fingerprint() == build(jdv).fingerprint()


def test_bucket_quantum_resolution_and_refusal(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_SEQUENCE_BUCKET", "5")
    spec = pdv.PadToBucket(None)
    assert spec.resolved_quantum() == 5
    x, m = spec.host_apply(SEQ, None, None)
    assert x.shape == (3, 25, 4) and m.shape == (3, 25)
    with pytest.raises(ValueError, match="bucket quantum must be positive"):
        pdv.PadToBucket(0).host_apply(SEQ, None, None)


def test_normalizers_advertise_their_lowering():
    std = pnorm.NormalizerStandardize()
    assert std.device_spec() is None
    std.mean, std.std = np.float32([1.0]), np.float32([2.0])
    assert isinstance(std.device_spec(), pdv.Standardize)
    mm = pnorm.NormalizerMinMaxScaler()
    mm.min, mm.max = np.float32([0.0]), np.float32([1.0])
    assert isinstance(mm.device_spec(), pdv.MinMaxScale)
    scaler = pnorm.ImagePreProcessingScaler()
    assert isinstance(scaler.device_spec(), pdv.Scale)
    it = pnorm.NormalizingIterator(ExistingDataSetIterator([]), scaler)
    c1 = it.device_chain
    assert it.device_chain is c1 and pdv.try_lower(c1)[0] is pdv.try_lower(it.device_chain)[0]
    scaler.lo = 0.5
    assert it.device_chain is not c1
    assert pdv.chain_of(it) is it.device_chain


# -- fused fits against the JAX package --------------------------------------------


def _cnn_conf(pkg_layers, it, nnc, upd):
    return (nnc.builder().seed(5).updater(upd(1e-2)).list()
            .layer(pkg_layers.Conv2D(n_out=4, kernel=(3, 3), activation="relu"))
            .layer(pkg_layers.Dense(n_out=8, activation="relu"))
            .layer(pkg_layers.OutputLayer(n_out=5, activation="softmax"))
            .set_input_type(it.convolutional(9, 10, 3)).build())


def _graph_conf():
    return (jg.GraphBuilder().seed(6).updater(JAdam(1e-2))
            .add_inputs("in").set_input_types(JIT.convolutional(9, 10, 3))
            .add_layer("c", jl.Conv2D(n_out=4, kernel=(3, 3), activation="relu"), "in")
            .add_layer("d", jl.Dense(n_out=8, activation="relu"), "c")
            .add_layer("out", jl.OutputLayer(n_out=5, activation="softmax"), "d")
            .set_outputs("out").build())


def _raw_batches(n=3, b=6, seed=0):
    r = np.random.default_rng(seed)
    return [(r.integers(0, 256, (b, 12, 14, 3)).astype(np.uint8),
             r.integers(0, 5, b)) for _ in range(n)]


class _Losses:
    def __init__(self):
        self.values = []

    def iteration_done(self, model, iteration, epoch, score):
        self.values.append(float(score))

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass


def _fit(model, chain_mod, raws, ds, edi, spe=1, epochs=1, chain=None):
    lst = _Losses()
    model.set_listeners(lst)
    it = chain_mod.DeviceTransformIterator(edi([ds(f, y) for f, y in raws]),
                                           chain or _aug_chain(chain_mod, 4))
    model.fit(it, epochs=epochs, steps_per_execution=spe)
    return np.asarray(lst.values)


def _models(kind):
    if kind == "graph":
        jconf = _graph_conf()
        return JGM(jconf).init(), GraphModel(GraphConfiguration.from_json(
            jconf.to_json()), device="cpu").init()
    jconf = _cnn_conf(jl, JIT, JNNC, JAdam)
    return JSM(jconf).init(), SequentialModel(SequentialConfiguration.from_json(
        jconf.to_json()), device="cpu").init()


@pytest.mark.parametrize("kind,spe", [("sequential", 1), ("sequential", 3), ("graph", 1)])
def test_fused_fit_matches_jax_fused_fit(kind, spe):
    jm, pm = _models(kind)
    raws = _raw_batches()
    b0 = _counter("dl4jtpu_device_decode_batches_total")
    want = _fit(jm, jdv, raws, JDS, JEDI, spe)
    got = _fit(pm, pdv, raws, DataSet, ExistingDataSetIterator, spe)
    assert _counter("dl4jtpu_device_decode_batches_total") - b0 == 3
    assert len(got) == len(want) == 3 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= LOSS_REL * np.abs(want).max()
    key = ("train_fused", pdv.try_lower(_aug_chain(pdv, 4))[0].fingerprint)
    assert any(k[:2] == key for k in pm._step_fns)


@pytest.mark.parametrize("kind,spe", [("sequential", 1), ("sequential", 3), ("graph", 1)])
def test_fused_fit_equals_the_host_decoded_fit(kind, spe):
    raws = _raw_batches(n=4, seed=2)
    runs = []
    env = environment()
    for on in (True, False):
        env.device_decode = on
        try:
            _, pm = _models(kind)
            b0 = _counter("dl4jtpu_device_decode_batches_total")
            runs.append(_fit(pm, pdv, raws, DataSet, ExistingDataSetIterator, spe,
                             epochs=2))
            fused = _counter("dl4jtpu_device_decode_batches_total") - b0
            assert fused == (8 if on else 0)
        finally:
            env.device_decode = True
    assert np.array_equal(runs[0], runs[1])


def test_fused_fit_stages_raw_uint8_and_counts():
    _, pm = _models("sequential")
    raws = _raw_batches()
    seen = []
    real = pm._train_step

    def spy(*inputs, **kw):
        if kw.get("decode") is not None:
            seen.append(inputs[0].dtype)
        return real(*inputs, **kw)

    pm._train_step = spy
    r0 = _counter("dl4jtpu_h2d_bytes_total", feed="raw")
    s0 = _counter("dl4jtpu_device_decode_seconds_total")
    chain = _aug_chain(pdv, 41)       # a seed no other test times: a fresh calibration
    _fit(pm, pdv, raws, DataSet, ExistingDataSetIterator, chain=chain)
    assert seen == [torch.uint8] * 3
    # features (uint8) and the int64 class ids cross raw
    assert _counter("dl4jtpu_h2d_bytes_total", feed="raw") - r0 == sum(
        f.nbytes + y.nbytes for f, y in raws)
    assert _counter("dl4jtpu_device_decode_seconds_total") > s0
    decodes = [r for r in cost.registry().programs() if r.kind == "decode"]
    assert any(r.key.startswith("('decode'") for r in decodes)
    rec = next(r for r in decodes if r.owner_ref() is pdv.try_lower(chain)[0])
    rec.ensure_analysis()
    assert rec.analysis in ("ok", "partial") and rec.bytes_accessed > 0


def test_normalizing_iterator_fuses_with_the_native_scaler():
    r = np.random.default_rng(1)
    x = r.integers(0, 256, (24, 9, 10, 3)).astype(np.uint8)
    y = np.eye(5, dtype=np.float32)[r.integers(0, 5, 24)]
    runs = []
    for on in (True, False):
        environment().device_decode = on
        try:
            _, pm = _models("sequential")
            b0 = _counter("dl4jtpu_device_decode_batches_total")
            it = pnorm.NormalizingIterator(ExistingDataSetIterator(
                DataSet(x, y).split_batches(8)), pnorm.ImagePreProcessingScaler(-1.0, 1.0))
            lst = _Losses()
            pm.set_listeners(lst)
            pm.fit(it, steps_per_execution=3)
            assert _counter("dl4jtpu_device_decode_batches_total") - b0 == (3 if on else 0)
            runs.append(lst.values)
        finally:
            environment().device_decode = True
    assert np.array_equal(runs[0], runs[1])


# -- fallbacks --------------------------------------------------------------------


def _tbptt_models():
    conf = (JNNC.builder().seed(2).updater(JAdam(1e-2)).tbptt(4).list()
            .layer(jrec.LSTM(n_out=5)).layer(jrec.RnnOutputLayer(n_out=3, activation="softmax"))
            .set_input_type(JIT.recurrent(4)).build())
    return JSM(conf).init(), SequentialModel(SequentialConfiguration.from_json(
        conf.to_json()), device="cpu").init()


def _seq_feed(m, n=2):
    r = np.random.default_rng(3)
    data = [(r.normal(0, 1, (4, 8, 4)).astype(np.float32),
             np.eye(3, dtype=np.float32)[r.integers(0, 3, (4, 8))]) for _ in range(n)]
    edi = JEDI if m is jdv else ExistingDataSetIterator
    ds = JDS if m is jdv else DataSet
    return m.DeviceTransformIterator(edi([ds(f, y) for f, y in data]),
                                     m.TransformChain((m.Scale(0.5, 0.1),), ()))


def _two_input_graph():
    return (jg.GraphBuilder().seed(5).updater(JAdam(1e-2))
            .add_inputs("a", "b").set_input_types(JIT.feed_forward(3), JIT.feed_forward(3))
            .add_vertex("m", jg.MergeVertex(), "a", "b")
            .add_layer("out", jl.OutputLayer(n_out=2, activation="softmax"), "m")
            .set_outputs("out").build())


def _fallback_case(case):
    """(port model, its feed, fit kwargs, the JAX package's reason for
    the same configuration).  The compressed exchange and 1F1B need a
    world: there the model carries the variant's marker undistributed,
    and the fit-entry decision alone is checked."""
    if case == "unlowerable":
        def opaque(x, key):
            return torch.as_tensor(x).to(torch.float32) / 255.0

        def jopaque(x, key):
            return np.asarray(x, np.float32) / 255.0

        _, pm = _models("sequential")
        chain = pdv.TransformChain((pdv.RandomCrop(9, 10), pdv.Custom(opaque)), (pdv.OneHot(5),))
        feed = pdv.DeviceTransformIterator(ExistingDataSetIterator(
            [DataSet(f, y) for f, y in _raw_batches(2)]), chain)
        reason = jdv.try_lower(jdv.TransformChain((jdv.Custom(jopaque),), ()))[1]
        return pm, feed, {}, reason.replace("jopaque", "opaque")
    if case == "tbptt":
        jm, pm = _tbptt_models()
        return pm, _seq_feed(pdv), {}, jm._fused_decode_reason()
    if case in ("compression", "1f1b"):
        jm, pm = _models("sequential")
        if case == "compression":
            jm._grad_compression = pm._grad_compression = "int8"
        else:
            jm._pipeline_schedule = pm._pipeline_schedule = "1f1b"
            jm._pipeline_plan = pm._pipeline_plan = object()
        feed = pdv.DeviceTransformIterator(ExistingDataSetIterator(
            [DataSet(f, y) for f, y in _raw_batches(2)]), _aug_chain(pdv, 1))
        return pm, feed, {}, jm._fused_decode_reason()
    if case == "multi_io_graph":
        pm = GraphModel(GraphConfiguration.from_json(_two_input_graph().to_json()),
                        device="cpu").init()
        feed = pdv.DeviceTransformIterator(ExistingDataSetIterator([]),
                                           pdv.TransformChain((pdv.Scale(2.0),), ()))
        return pm, feed, {}, "multi-input/output graph"
    # a grouped graph fit
    _, pm = _models("graph")
    feed = pdv.DeviceTransformIterator(ExistingDataSetIterator(
        [DataSet(f, y) for f, y in _raw_batches(2)]), _aug_chain(pdv, 1))
    return pm, feed, {"steps_per_execution": 2}, "graph grouped (steps_per_execution) fit path"


@pytest.mark.parametrize("case", ["unlowerable", "tbptt", "compression", "1f1b",
                                  "multi_io_graph", "grouped_graph"])
def test_fallback_reason_log_and_count(case, caplog):
    pm, feed, kw, reason = _fallback_case(case)
    assert isinstance(reason, str) and reason
    f0 = _counter("dl4jtpu_device_decode_fallbacks_total", reason=reason)
    b0 = _counter("dl4jtpu_device_decode_batches_total")
    r0 = _counter("dl4jtpu_h2d_bytes_total", feed="raw")
    with caplog.at_level(logging.INFO, logger="deeplearning4j_tpu_torch"):
        if case in ("compression", "1f1b"):
            assert pm._device_decode_feed(feed, pm._fused_decode_reason()) == (feed, None)
        else:
            pm.fit(feed, **kw)
    assert _counter("dl4jtpu_device_decode_fallbacks_total", reason=reason) - f0 == 1
    assert _counter("dl4jtpu_device_decode_batches_total") == b0
    assert _counter("dl4jtpu_h2d_bytes_total", feed="raw") == r0
    assert any("device decode fallback" in r.getMessage() and reason in r.getMessage()
               for r in caplog.records)
    if case not in ("multi_io_graph", "compression", "1f1b"):
        assert pm.iteration > 0 and np.isfinite(pm.score_value)


def test_flag_off_is_silent(caplog):
    _, pm = _models("sequential")
    b0 = _counter("dl4jtpu_device_decode_batches_total")
    env = environment()
    env.device_decode = False
    try:
        with caplog.at_level(logging.INFO, logger="deeplearning4j_tpu_torch"):
            _fit(pm, pdv, _raw_batches(), DataSet, ExistingDataSetIterator)
    finally:
        env.device_decode = True
    assert pm.iteration == 3 and _counter("dl4jtpu_device_decode_batches_total") == b0
    assert not any("fallback" in r.getMessage() for r in caplog.records)


# -- the raw feed's edges ------------------------------------------------------------


class _Slotted:
    __slots__ = ("features", "labels", "features_mask", "labels_mask")

    def __init__(self, f, y):
        self.features, self.labels = f, y
        self.features_mask = self.labels_mask = None

    @property
    def num_examples(self):
        return int(self.features.shape[0])


@pytest.mark.parametrize("kind", ["masked", "slotted"])
def test_batches_that_cannot_fuse_are_decoded_on_the_host(kind):
    raws = _raw_batches()
    if kind == "masked":
        batches = [DataSet(f, y, None, np.ones(len(y), np.float32)) for f, y in raws]
    else:
        batches = [_Slotted(f, y) for f, y in raws]
    _, pm = _models("sequential")
    b0 = _counter("dl4jtpu_device_decode_batches_total")
    r0 = _counter("dl4jtpu_h2d_bytes_total", feed="raw")
    feed = pdv.DeviceTransformIterator(ExistingDataSetIterator(batches), _aug_chain(pdv, 4))
    pm.fit(feed)
    assert pm.iteration == 3 and np.isfinite(pm.score_value)
    assert _counter("dl4jtpu_device_decode_batches_total") == b0
    assert _counter("dl4jtpu_h2d_bytes_total", feed="raw") == r0
    # the host decode keeps (and carries) the batch's own masks
    if kind == "masked":
        dec = pdv.DeviceDecode(pdv.TransformChain((pdv.Scale(2.0), pdv.PadToBucket(16)), ()))
        seq = dec.host(0, DataSet(SEQ, SEQ, SEQ_MASK, None))
        assert seq.features_mask.shape == (3, 32)
        assert np.array_equal(seq.features_mask[:, :21], SEQ_MASK)


def test_a_hand_tagged_masked_raw_batch_is_decoded_on_the_host():
    _, pm = _models("sequential")
    chain = _aug_chain(pdv, 4)
    decode = pdv.try_lower(chain)[0]
    f, y = _raw_batches(1)[0]
    batch = DataSet(f, y, None, np.ones(len(y), np.float32))
    batch._raw_for_device_decode, batch._decode_step = True, 0
    pm._device_decode = decode
    routed, dec = pm._route(batch)
    assert dec is None and routed.features.dtype == np.float32
    assert routed.labels_mask is batch.labels_mask or np.array_equal(
        routed.labels_mask, batch.labels_mask)
    with pytest.raises(TypeError, match="must be a DataSet"):
        slotted = _Slotted(f, y)
        pm._route(type("Tagged", (), {"_raw_for_device_decode": True,
                                       "features": slotted.features})())
    pm._device_decode = None


def test_augment_keys_follow_the_feed_counter_not_the_iteration():
    """An ``evaluate`` between fits advances only the feed's counter:
    the fused fit draws the same keys as the host-decoded one."""
    scores = []
    for on in (True, False):
        environment().device_decode = on
        try:
            _, pm = _models("sequential")
            it = pdv.DeviceTransformIterator(ExistingDataSetIterator(
                [DataSet(f, y) for f, y in _raw_batches(3, seed=5)]), _aug_chain(pdv, 8))
            pm.fit(it)
            pm.evaluate(it)
            pm.fit(it)
            scores.append(float(pm.score_value))
            assert it.next_decode_step() == 9
        finally:
            environment().device_decode = True
    assert scores[0] == scores[1]


def test_a_group_mixing_raw_and_decoded_batches_steps_batch_by_batch():
    raws = _raw_batches(4, seed=6)
    batches = [_Slotted(f, y) if i % 2 else DataSet(f, y) for i, (f, y) in enumerate(raws)]
    _, pm = _models("sequential")
    b0 = _counter("dl4jtpu_device_decode_batches_total")
    pm.fit(pdv.DeviceTransformIterator(ExistingDataSetIterator(batches),
                                       _aug_chain(pdv, 4)), steps_per_execution=4)
    assert pm.iteration == 4 and np.isfinite(pm.score_value)
    assert _counter("dl4jtpu_device_decode_batches_total") - b0 == 2


def test_split_and_prefetch_copies_keep_the_tags():
    from deeplearning4j_tpu_torch.data.prefetch import stage_to_device

    f, y = _raw_batches(1)[0]
    b = DataSet(f, y)
    b._raw_for_device_decode, b._decode_step, b._etl_source = True, 7, "cache"
    for piece in b.split_batches(4) + [stage_to_device(b, "cpu")]:
        assert (piece._raw_for_device_decode, piece._decode_step, piece._etl_source) == (
            True, 7, "cache")


def test_the_fault_site_fires_at_the_host_boundary():
    _, pm = _models("sequential")
    faults.arm("data.device_decode:raise:nth=2")
    try:
        with pytest.raises(faults.InjectedFault):
            _fit(pm, pdv, _raw_batches(), DataSet, ExistingDataSetIterator)
        assert pm.iteration == 1
    finally:
        faults.disarm()


def test_raw_feed_iterator_protocol():
    chain = pdv.TransformChain((pdv.Scale(1 / 127.5, -1.0),
                                pdv.MeanPool((4, 2), collapse_channels=True)),
                               (pdv.OneHot(5),))
    base = ExistingDataSetIterator([DataSet(f, y) for f, y in _raw_batches()])
    it = pdv.DeviceTransformIterator(base, chain)
    assert pdv.chain_of(it) is chain and pdv.chain_of(base) is None
    raw = list(pdv.raw_feed(it))
    assert [b._decode_step for b in raw] == [0, 1, 2]
    assert all(b._raw_for_device_decode and b.features.dtype == np.uint8 for b in raw)
    assert not hasattr(base._batches[0] if hasattr(base, "_batches") else object(),
                       "_raw_for_device_decode")
    host = next(iter(it))
    assert host.features.shape == (6, 3, 7, 1) and host.labels.shape == (6, 5)
    assert it.next_decode_step() == 4


class _Counting(DataSetIterator):
    def __init__(self, n):
        self.n, self.pulled = n, 0

    @property
    def batch_size(self):
        return 6

    def reset(self):
        pass

    def __iter__(self):
        for f, y in _raw_batches(self.n, seed=9):
            self.pulled += 1
            yield DataSet(f, y)


def test_a_lazy_raw_feed_is_prefetched_with_its_tags():
    """A lazily produced raw feed goes through the fit's prefetch wrap
    (staged copies keep the routing tags) and still fuses every batch."""
    _, pm = _models("sequential")
    base = _Counting(4)
    b0 = _counter("dl4jtpu_device_decode_batches_total")
    pm.fit(pdv.DeviceTransformIterator(base, _aug_chain(pdv, 4)))
    assert base.pulled == 4 and pm.iteration == 4
    assert _counter("dl4jtpu_device_decode_batches_total") - b0 == 4


def test_a_chain_lowered_again_reuses_its_calibration():
    """A fit over a fresh `NormalizingIterator` lowers an equal chain
    again: its calibration is the first one's (nothing is timed twice),
    and its decode program is registered all the same."""
    feats, labs = torch.from_numpy(IMG_U8), torch.from_numpy(IDS)
    first = pdv.DeviceDecode(_aug_chain(pdv, 77))
    again = pdv.DeviceDecode(_aug_chain(pdv, 77))
    t = first.calibrated_seconds(feats, labs)
    assert t > 0 and first.program()._cost_record.dispatches == 2
    assert again.calibrated_seconds(IMG_U8, IDS) == t
    assert again.program()._cost_record.dispatches == 0
    other = pdv.DeviceDecode(_aug_chain(pdv, 78))
    other.calibrated_seconds(feats, labs)
    assert other.program()._cost_record.dispatches == 2
