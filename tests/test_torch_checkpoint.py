"""The port's checkpoint zip (`train/checkpoint.py`) against the JAX
package's `ModelSerializer`, both ways, on the CPU.

- The JAX package writes after 2 Adam steps; the port verifies and
  restores it: parameters, optimizer leaves and counters bit for bit,
  outputs within 1e-5; then 3 more `fit_batch` on each side: losses
  within 1e-5 at every step, parameters as the training tests hold them
  after Adam steps (99.9 % within 1e-5, all within a tenth of the
  learning rate).  The same with the port writing and the JAX package
  verifying and restoring.  Both heads; a 12-layer stack whose leaf
  order puts ``layer10`` before ``layer2``.
- Every updater, with a schedule and clipping: the port's state leaves
  load in the JAX package, and the JAX package's in the port, bit for
  bit.
- Quantized zips carry across bit for bit (int8 and scale leaves), and
  their outputs agree within 1e-5, both ways, at two ``min_elements``.
- A truncated zip, a corrupted entry (CRC) and a missing entry raise
  `CheckpointVerifyError` in both packages; a file without a manifest
  (format 1) verifies on the zip's own CRCs.  A zip whose model class
  does not take its configuration (``GraphModel`` over a sequential
  one) raises.
"""

import json
import os
import shutil
import zipfile

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.sequential import SequentialModel as JaxSM
from deeplearning4j_tpu.nn import schedules as jax_schedules
from deeplearning4j_tpu.nn import updaters as jax_updaters
from deeplearning4j_tpu.quant import quantize as jax_quantize
from deeplearning4j_tpu.train.checkpoint import (
    CheckpointVerifyError as JaxVerifyError,
    ModelSerializer as JaxMS,
)
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.convert import params_to_numpy
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models.sequential import SequentialModel, tree_leaves
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    SequentialConfiguration,
)
from deeplearning4j_tpu_torch.quant import quantize
from deeplearning4j_tpu_torch.train.checkpoint import (
    CheckpointVerifyError,
    ModelSerializer,
)

torch.set_num_threads(1)

VOCAB, LR = 64, 5e-3


def _zoo(chunked=True, n_layers=2, **kw):
    return JaxTE(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=n_layers,
                 seed=7, chunked_vocab_loss=chunked, vocab_chunk=16,
                 learning_rate=LR, **kw)


def _batches(n, seed, one_hot):
    rs = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = rs.integers(0, VOCAB, (2, 12)).astype(np.int32)
        y = np.roll(ids, -1, axis=1)
        out.append((ids, np.eye(VOCAB, dtype=np.float32)[y] if one_hot else y))
    return out


def _port_leaves(model):
    return [np.asarray(x) for x in tree_leaves(params_to_numpy(model))]


def _jax_leaves(jmodel):
    return [np.asarray(x) for x in jax.tree.leaves(jmodel.params)]


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _port_state(model):
    return [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)
            for x in updaters.state_leaves(model.opt_state)]


def _jax_state(jmodel):
    return [np.asarray(x) for x in jax.tree.leaves(jmodel.opt_state)]


def _close_after_adam(a, b):
    err = np.concatenate([np.abs(x - y).ravel() for x, y in zip(a, b)])
    assert err.max() <= LR / 10, err.max()
    assert np.mean(err <= 1e-5) >= 0.999, np.mean(err <= 1e-5)


def _resume_both(model, jmodel, one_hot):
    ids = _batches(1, 99, False)[0][0]
    np.testing.assert_allclose(model.output(ids).numpy(),
                               np.asarray(jmodel.output(ids)), rtol=0, atol=1e-5)
    for ids, y in _batches(3, 5, one_hot):
        jmodel.fit_batch(JaxDataSet(ids, y))
        model.fit_batch(DataSet(ids, y))
        assert abs(model.score_value - float(jmodel.score_value)) <= 1e-5
    _close_after_adam(_port_leaves(model), _jax_leaves(jmodel))
    assert model.iteration == jmodel.iteration == 5


@pytest.mark.parametrize("chunked,n_layers", [(True, 2), (False, 2), (True, 9)])
def test_jax_zip_restores_and_resumes_in_the_port(tmp_path, chunked, n_layers):
    jmodel = _zoo(chunked, n_layers).init_model()
    for ids, y in _batches(2, 1, not chunked):
        jmodel.fit_batch(JaxDataSet(ids, y))
    path = str(tmp_path / "jax.zip")
    JaxMS.write_model(jmodel, path)
    assert ModelSerializer.verify(path)["iteration"] == 2
    model = ModelSerializer.restore(path, device="cpu")
    assert model.device.type == "cpu" and model.conf == SequentialConfiguration.from_json(
        jmodel.conf.to_json())
    _same(_port_leaves(model), _jax_leaves(jmodel))
    _same(_port_state(model), _jax_state(jmodel))
    if n_layers > 8:
        assert "layer10" in model.params
    _resume_both(model, jmodel, not chunked)


@pytest.mark.parametrize("chunked,n_layers", [(True, 2), (False, 2), (True, 9)])
def test_port_zip_restores_and_resumes_in_jax(tmp_path, chunked, n_layers):
    conf = SequentialConfiguration.from_json(_zoo(chunked, n_layers).conf().to_json())
    model = SequentialModel(conf, device="cpu").init()
    for ids, y in _batches(2, 1, not chunked):
        model.fit_batch(DataSet(ids, y))
    path = str(tmp_path / "port.zip")
    ModelSerializer.write_model(model, path)
    assert not os.path.exists(path + ".tmp")
    assert JaxMS.verify(path)["iteration"] == 2
    jmodel = JaxMS.restore(path)
    assert jmodel.conf == _zoo(chunked, n_layers).conf()
    _same(_jax_leaves(jmodel), _port_leaves(model))
    _same(_jax_state(jmodel), _port_state(model))
    _resume_both(model, jmodel, not chunked)


UPDATERS = ["Sgd", "Nesterovs", "Momentum", "Adam", "AdamW", "AdaMax", "Nadam",
            "AmsGrad", "AdaGrad", "AdaDelta", "RmsProp", "NoOp"]


@pytest.mark.parametrize("name", UPDATERS)
def test_every_updater_state_crosses_both_ways(tmp_path, name):
    sched = jax_schedules.CosineSchedule(initial=0.05, decay_steps=6, warmup_steps=1)
    jconf = _zoo().conf()
    import dataclasses

    jconf = dataclasses.replace(jconf, updater=getattr(jax_updaters, name)(
        learning_rate=sched), gradient_clip_value=1.0, gradient_clip_norm=5.0)
    model = SequentialModel(SequentialConfiguration.from_json(jconf.to_json()),
                            device="cpu").init()
    for ids, y in _batches(2, 3, False):
        model.fit_batch(DataSet(ids, y))
    path = str(tmp_path / "port.zip")
    ModelSerializer.write_model(model, path)
    jmodel = JaxMS.restore(path)
    _same(_jax_state(jmodel), _port_state(model))
    back = str(tmp_path / "back.zip")
    JaxMS.write_model(jmodel, back)
    again = ModelSerializer.restore(back, device="cpu")
    _same(_port_state(again), _port_state(model))
    _same(_port_leaves(again), _port_leaves(model))


@pytest.mark.parametrize("min_elements", [0, 2000])
def test_quantized_zips_cross_both_ways_bit_for_bit(tmp_path, min_elements):
    jq = jax_quantize(_zoo(False).init_model(), min_elements=min_elements)
    path = str(tmp_path / "jq.zip")
    JaxMS.write_model(jq, path)
    q = ModelSerializer.restore(path, device="cpu")
    assert q._quantized == jq._quantized and q.opt_state is None
    _same(_port_leaves(q), _jax_leaves(jq))
    ids = _batches(1, 4, False)[0][0]
    np.testing.assert_allclose(q.output(ids).numpy(), np.asarray(jq.output(ids)),
                               rtol=0, atol=1e-5)

    conf = SequentialConfiguration.from_json(_zoo(False).conf().to_json())
    pq = quantize(SequentialModel(conf, device="cpu").init(),
                  min_elements=min_elements)
    ppath = str(tmp_path / "pq.zip")
    ModelSerializer.write_model(pq, ppath)
    with zipfile.ZipFile(ppath) as zf:
        assert "updater.npz" not in zf.namelist()
        assert json.loads(zf.read("meta.json"))["quantized"] == pq._quantized
    jback = JaxMS.restore(ppath)
    _same(_jax_leaves(jback), _port_leaves(pq))
    np.testing.assert_allclose(np.asarray(jback.output(ids)), pq.output(ids).numpy(),
                               rtol=0, atol=1e-5)
    again = ModelSerializer.restore(ppath, device="cpu")
    _same(_port_leaves(again), _port_leaves(pq))
    assert torch.equal(again.output(ids), pq.output(ids))


def _corrupt(path, how):
    if how == "truncated":
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        return
    with zipfile.ZipFile(path) as zf:
        entries = {n: zf.read(n) for n in zf.namelist()}
    if how == "crc":
        # a flipped byte inside params.npz, the manifest left as written
        data = bytearray(entries["params.npz"])
        data[len(data) // 2] ^= 0xFF
        entries["params.npz"] = bytes(data)
    elif how == "missing":
        del entries["meta.json"]
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        for n, d in entries.items():
            zf.writestr(n, d)


@pytest.mark.parametrize("how", ["truncated", "crc", "missing"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_damaged_zip_fails_verification_in_both_packages(tmp_path, writer, how):
    path = str(tmp_path / "m.zip")
    if writer == "jax":
        JaxMS.write_model(_zoo().init_model(), path)
    else:
        conf = SequentialConfiguration.from_json(_zoo().conf().to_json())
        ModelSerializer.write_model(SequentialModel(conf, device="cpu").init(), path)
    _corrupt(path, how)
    with pytest.raises(CheckpointVerifyError):
        ModelSerializer.verify(path)
    with pytest.raises(CheckpointVerifyError):
        ModelSerializer.restore(path, device="cpu")
    with pytest.raises(JaxVerifyError):
        JaxMS.verify(path)


def test_a_format_1_zip_verifies_on_the_zips_own_crcs(tmp_path):
    conf = SequentialConfiguration.from_json(_zoo().conf().to_json())
    model = SequentialModel(conf, device="cpu").init()
    path = str(tmp_path / "v2.zip")
    ModelSerializer.write_model(model, path)
    v1 = str(tmp_path / "v1.zip")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(v1, "w") as dst:
        for n in src.namelist():
            if n != "manifest.json":
                dst.writestr(n, src.read(n))
    assert ModelSerializer.verify(v1) == JaxMS.verify(v1)
    _same(_port_leaves(ModelSerializer.restore(v1, device="cpu")), _port_leaves(model))


def test_write_replaces_a_file_and_restore_refuses_other_models(tmp_path):
    conf = SequentialConfiguration.from_json(_zoo().conf().to_json())
    model = SequentialModel(conf, device="cpu").init()
    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(model, path)
    model.fit_batch(DataSet(*_batches(1, 2, False)[0]))
    ModelSerializer.write_model(model, path)              # over the old file
    assert ModelSerializer.verify(path)["iteration"] == 1
    assert sorted(os.listdir(tmp_path)) == ["m.zip"]
    with pytest.raises(RuntimeError, match="not initialized"):
        ModelSerializer.write_model(SequentialModel(conf, device="cpu"), path)
    graph = str(tmp_path / "graph.zip")
    shutil.copy(path, graph)
    with zipfile.ZipFile(path) as zf:
        entries = {n: zf.read(n) for n in zf.namelist()}
    cfg = json.loads(entries["configuration.json"])
    cfg["model_class"] = "GraphModel"
    entries["configuration.json"] = json.dumps(cfg).encode()
    with zipfile.ZipFile(graph, "w") as zf:
        for n, d in entries.items():
            zf.writestr(n, d)
    with pytest.raises(ValueError, match="GraphModel does not take its "
                                         "SequentialConfiguration"):
        ModelSerializer.restore(graph, verify=False, device="cpu")
