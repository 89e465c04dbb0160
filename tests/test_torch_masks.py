"""Features masks through the port's model, against the JAX package, on
the CPU.

A small non-causal classifier (Embedding, learned positions, two
encoder blocks, `GlobalPooling` AVG, a softmax `OutputLayer`) and the
zoo's causal LM are built from one configuration in both packages (the
port reads the JAX JSON, so the weights are the JAX model's bit for
bit) and fed the same padded batches: each row's length drawn from a
seed, trailing padding, the (B, T) mask 1 on real steps.  Tolerances:

- 5 masked `fit_batch` losses within 1e-5 of the JAX model's (f32 on
  both sides, another summation order);
- masked `output()` within 1e-5 of the largest JAX probability, `score`
  within 1e-5, and `evaluate` with the same predictions (accuracy and
  confusion equal);
- padding invariance: rewriting every padded id changes no bit of
  masked `output()`, `score` or a training step's loss (a masked key gets
  an exact-zero weight and pooling multiplies by the mask);
- `fit(steps_per_execution=K)` over masked batches: the same losses and
  weights as the same batches one `fit_batch` each.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.sequential import SequentialModel as JaxSM
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import attention as jax_attention
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.input_type import InputType as JaxInputType
from deeplearning4j_tpu.nn.updaters import Adam as JaxAdam
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.convert import params_to_numpy
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    SequentialConfiguration,
)

torch.set_num_threads(1)

TOL = 1e-5
VOCAB, D, HEADS, BATCH, SEQ, STEPS = 40, 16, 2, 4, 10, 5


def _classifier_conf():
    return (JaxNNC.builder().seed(11).updater(JaxAdam(5e-3)).list()
            .layer(jax_layers.Embedding(n_in=VOCAB, n_out=D))
            .layer(jax_attention.PositionalEncoding(learned=True, max_length=SEQ))
            .layer(jax_attention.TransformerEncoderBlock(d_model=D, n_heads=HEADS,
                                                         d_ff=32, causal=False))
            .layer(jax_attention.TransformerEncoderBlock(d_model=D, n_heads=HEADS,
                                                         d_ff=32, causal=False))
            .layer(jax_layers.GlobalPooling(pooling="avg"))
            .layer(jax_layers.OutputLayer(n_out=2))
            .set_input_type(JaxInputType.recurrent(1))
            .build())


def _pair(jconf):
    jm = JaxSM(jconf).init()
    pm = SequentialModel(SequentialConfiguration.from_json(jconf.to_json()),
                         device="cpu").init()
    return jm, pm


def _padded(seed, n=STEPS, lm=False):
    """n batches of trailing-padded ids (lengths 3 .. SEQ), their masks,
    and labels: a two-class label from the ids (classifier) or the next
    ids with the mask as labels mask (LM)."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lengths = r.integers(3, SEQ + 1, BATCH)
        lengths[0] = SEQ
        mask = (np.arange(SEQ)[None] < lengths[:, None]).astype(np.float32)
        ids = (r.integers(1, VOCAB, (BATCH, SEQ)) * mask).astype(np.int32)
        if lm:
            y = np.roll(ids, -1, axis=1)
            out.append((ids, y, mask, mask))
        else:
            cls = ((ids * mask).sum(1) / mask.sum(1) > VOCAB / 2).astype(np.int64)
            out.append((ids, np.eye(2, dtype=np.float32)[cls], mask, None))
    return out


def _rewrite_padding(ids, mask, seed):
    r = np.random.default_rng(seed)
    return np.where(mask > 0, ids, r.integers(0, VOCAB, ids.shape)).astype(ids.dtype)


def _assert_trees_close(pm, jm):
    for a, b in zip(jax.tree.leaves(jm.params), jax.tree.leaves(params_to_numpy(pm))):
        np.testing.assert_allclose(b, np.asarray(a), atol=5e-4)


def test_masked_fit_batch_matches_jax_step_for_step():
    jm, pm = _pair(_classifier_conf())
    for ids, y, m, _ in _padded(0):
        jm.fit_batch(JaxDataSet(ids, y, features_mask=m))
        pm.fit_batch(DataSet(ids, y, features_mask=m))
        assert abs(pm.score_value - float(jm.score_value)) <= TOL * max(
            1.0, abs(float(jm.score_value))), (pm.score_value, jm.score_value)
    _assert_trees_close(pm, jm)


def test_masked_output_score_and_evaluate_match_jax():
    jm, pm = _pair(_classifier_conf())
    ids, y, m, _ = _padded(1, n=1)[0]
    jp = np.asarray(jm.output(ids, m))
    pp = pm.output(ids, m).numpy()
    assert np.abs(pp - jp).max() <= TOL * np.abs(jp).max()
    # the mask changes the answer: padding is seen without it
    assert np.abs(pm.output(ids).numpy() - pp).max() > 1e-4
    js = jm.score(JaxDataSet(ids, y, features_mask=m))
    ps = pm.score(DataSet(ids, y, features_mask=m))
    assert abs(ps - js) <= TOL * max(1.0, abs(js))
    jev = jm.evaluate(JaxDataSet(ids, y, features_mask=m))
    pev = pm.evaluate(DataSet(ids, y, features_mask=m))
    assert pev.accuracy() == jev.accuracy()
    np.testing.assert_array_equal(pev.confusion_matrix, jev.confusion_matrix)
    np.testing.assert_array_equal(pm.predict(ids, m), jp.argmax(-1))
    acts = pm.feed_forward(ids, m)
    np.testing.assert_array_equal(acts[-1].numpy(), pm._forward(
        pm.compute_params(), pm.net_state, ids, fmask=m)[0].numpy())
    assert ("infer", True) in pm._step_fns and ("infer", False) in pm._step_fns


def test_causal_lm_with_trailing_padding_and_labels_mask_matches_jax():
    kw = dict(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=2, seed=7,
              chunked_vocab_loss=True, vocab_chunk=16, learning_rate=5e-3)
    jm, pm = _pair(JaxTE(**kw).conf())
    for ids, y, fm, lm in _padded(2, lm=True):
        jm.fit_batch(JaxDataSet(ids, y, features_mask=fm, labels_mask=lm))
        pm.fit_batch(DataSet(ids, y, features_mask=fm, labels_mask=lm))
        assert abs(pm.score_value - float(jm.score_value)) <= TOL * max(
            1.0, abs(float(jm.score_value)))
    _assert_trees_close(pm, jm)
    ids, _, fm, _ = _padded(3, n=1, lm=True)[0]
    jo, po = np.asarray(jm.output(ids, fm)), pm.output(ids, fm).numpy()
    assert np.abs(po - jo).max() <= TOL * np.abs(jo).max()


@pytest.mark.parametrize("pooling", ["avg", "max", "sum", "pnorm"])
def test_padding_is_invisible_bit_for_bit(pooling):
    jconf = _classifier_conf()
    conf = SequentialConfiguration.from_json(jconf.to_json())
    conf = dataclasses.replace(conf, layers=conf.layers[:4] + (
        dataclasses.replace(conf.layers[4], pooling=pooling),) + conf.layers[5:])
    pm = SequentialModel(conf, device="cpu").init()
    ids, y, m, _ = _padded(4, n=1)[0]
    ids2 = _rewrite_padding(ids, m, 5)
    assert not np.array_equal(ids, ids2)
    np.testing.assert_array_equal(pm.output(ids, m).numpy(), pm.output(ids2, m).numpy())
    assert pm.score(DataSet(ids, y, features_mask=m)) == pm.score(
        DataSet(ids2, y, features_mask=m))
    a, b = pm.clone(), pm.clone()
    a.fit_batch(DataSet(ids, y, features_mask=m))
    b.fit_batch(DataSet(ids2, y, features_mask=m))
    assert a.score_value == b.score_value
    for x, z in zip(jax.tree.leaves(params_to_numpy(a)), jax.tree.leaves(params_to_numpy(b))):
        np.testing.assert_array_equal(x, z)


def test_grouped_masked_steps_equal_single_steps():
    _, one = _pair(_classifier_conf())
    grouped = one.clone()
    batches = [DataSet(ids, y, features_mask=m) for ids, y, m, _ in _padded(6, n=4)]
    singles = []
    for b in batches:
        one.fit_batch(b)
        singles.append(one.score_value)
    grouped.fit(batches, steps_per_execution=4)
    np.testing.assert_array_equal(grouped._last_score.numpy(), np.float32(singles))
    for x, z in zip(jax.tree.leaves(params_to_numpy(one)),
                    jax.tree.leaves(params_to_numpy(grouped))):
        np.testing.assert_array_equal(x, z)


def test_server_serves_masked_rows_over_http_as_output_gives_them():
    """A padded request with its own features mask (a hole included) on a
    non-causal classifier: ``/v1/infer`` returns what ``output(x, mask)``
    gives for the same rows (the JAX server passes the mask too)."""
    import json
    import urllib.error
    import urllib.request

    from deeplearning4j_tpu_torch.serving.http import ServingHTTPServer
    from deeplearning4j_tpu_torch.serving.server import InferenceServer, ServingConfig

    _, pm = _pair(_classifier_conf())
    ids, _, m, _ = _padded(7, n=1)[0]
    m = m.copy()
    m[0, 3] = 0.0                                      # a hole, not padding
    srv = InferenceServer(pm, ServingConfig(max_batch=4, default_deadline_s=60.0)).start()
    http = ServingHTTPServer(srv, port=0, host="127.0.0.1").start()
    try:
        got = []
        for row, mrow in zip(ids, m):
            req = urllib.request.Request(
                http.url + "v1/infer", headers={"Content-Type": "application/json"},
                data=json.dumps({"features": row.tolist(),
                                 "features_mask": mrow.tolist()}).encode())
            with urllib.request.urlopen(req, timeout=60) as r:
                got.append(json.loads(r.read())["outputs"])
        bad = urllib.request.Request(
            http.url + "v1/infer", headers={"Content-Type": "application/json"},
            data=json.dumps({"features": ids[0].tolist(),
                             "features_mask": [[1.0]]}).encode())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=60)
        assert err.value.code == 400
        err.value.close()
    finally:
        http.stop()
        srv.stop()
    want = pm.output(ids, m).numpy()
    np.testing.assert_allclose(np.float32(got), want, rtol=0, atol=1e-6)
    assert np.abs(pm.output(ids).numpy()[0] - want[0]).max() > 1e-6
