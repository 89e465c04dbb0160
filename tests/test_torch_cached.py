"""The port's batch cache (`deeplearning4j_tpu_torch/data/cached.py`
`CachedDataSetIterator`) against the JAX package's, on the CPU.

- The first pass writes each batch (uint8 stays uint8) and the manifest
  last; replays memory-map the same bytes and never touch the base.
- A cache written by either package replays byte for byte in the other:
  the same file names, the same ``.npy`` files, the same manifest.
- An incomplete cache (no manifest) populates again; a base that
  changes its mask layout mid-epoch, an empty base, and no cache with no
  base raise as the JAX package's do.
- A fit on a replay charges its pull time to
  ``dl4jtpu_etl_wait_seconds_total{source="cache"}``, not to the
  model's ETL wait, and counts hits and populations on
  ``dl4jtpu_data_cache_batches_total``.
"""

import json
import os

import numpy as np
import pytest

from deeplearning4j_tpu.data.cached import CachedDataSetIterator as JaxCached
from deeplearning4j_tpu.data.dataset import DataSet as JDS
from deeplearning4j_tpu.data.iterator import ExistingDataSetIterator as JEDI
from deeplearning4j_tpu_torch.data.cached import CachedDataSetIterator
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import ExistingDataSetIterator
from deeplearning4j_tpu_torch.observe.metrics import registry

PKG = {"jax": (JaxCached, JDS, JEDI), "port": (CachedDataSetIterator, DataSet,
                                                ExistingDataSetIterator)}


def _arrays(n=3, masked=False, seed=0):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        f = r.integers(0, 256, (4, 6, 6, 3)).astype(np.uint8)
        y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 4)]
        fm = r.integers(0, 2, (4, 6)).astype(np.float32) if masked else None
        out.append((f, y, fm, None))
    return out


def _base(pkg, arrays):
    _, ds, it = PKG[pkg]
    return it([ds(*a) for a in arrays])


def _batch_bytes(b):
    return [None if a is None else (str(np.asarray(a).dtype), np.asarray(a).shape,
                                    np.asarray(a).tobytes())
            for a in (b.features, b.labels, b.features_mask, b.labels_mask)]


def _files(d):
    return {name: (d / name).read_bytes() for name in sorted(os.listdir(d))}


@pytest.mark.parametrize("masked", [False, True])
def test_populate_then_replay_byte_for_byte(masked, tmp_path):
    arrays = _arrays(masked=masked)
    cache = CachedDataSetIterator(_base("port", arrays), str(tmp_path))
    assert not cache.is_cached
    first = [_batch_bytes(b) for b in cache]
    assert cache.is_cached and cache.decode_epochs == 1
    replay = [_batch_bytes(b) for b in cache]
    assert first == replay == [_batch_bytes(DataSet(*a)) for a in arrays]
    assert cache.cache_hits == 3 and cache.decode_epochs == 1
    cache.reset()
    assert [_batch_bytes(b) for b in cache] == first and cache.decode_epochs == 1
    # a fresh iterator over a complete cache needs no base
    again = CachedDataSetIterator(None, str(tmp_path))
    assert again.is_cached and again.batch_size == 4
    assert [_batch_bytes(b) for b in again] == first


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_cache_of_either_package_replays_in_the_other(writer, reader, tmp_path):
    arrays = _arrays(n=4, seed=1)
    w, r = tmp_path / "w", tmp_path / "r"
    written = [_batch_bytes(b) for b in PKG[writer][0](_base(writer, arrays), str(w))]
    # the other package writes the same files, byte for byte
    list(PKG[reader][0](_base(reader, arrays), str(r)))
    assert _files(w) == _files(r)
    replayed = PKG[reader][0](None, str(w))
    assert replayed.is_cached
    got = list(replayed)
    assert [_batch_bytes(b) for b in got] == written
    assert all(getattr(b, "_etl_source", None) == "cache" for b in got)
    assert replayed.cache_hits == 4 and replayed.decode_epochs == 0


def test_incomplete_cache_populates_again(tmp_path):
    arrays = _arrays()
    cache = CachedDataSetIterator(_base("port", arrays), str(tmp_path))
    it = iter(cache)
    next(it)                           # killed mid-population: no manifest
    assert not (tmp_path / "manifest.json").exists()
    fresh = CachedDataSetIterator(_base("port", arrays), str(tmp_path))
    assert not fresh.is_cached
    assert len(list(fresh)) == 3 and fresh.is_cached
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest == {"complete": True, "n_batches": 3,
                        "arrays": ["features", "labels"], "batch_size": 4}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_refusals(pkg, tmp_path):
    cls, ds, it = PKG[pkg]
    with pytest.raises(ValueError, match="no complete cache"):
        cls(None, str(tmp_path / "none"))
    with pytest.raises(ValueError, match="no batches"):
        list(cls(it([]), str(tmp_path / "empty")))
    a, b = _arrays(n=2, masked=True)
    mixed = it([ds(*a), ds(b[0], b[1])])
    with pytest.raises(ValueError, match="mask layout"):
        list(cls(mixed, str(tmp_path / "mixed")))


def test_fit_on_a_replay_charges_the_cache_series(tmp_path):
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel
    from deeplearning4j_tpu_torch.nn.updaters import Sgd

    conf = (NeuralNetConfiguration.builder().seed(1).updater(Sgd(1e-2)).list()
            .layer(Dense(n_out=5, activation="relu"))
            .layer(OutputLayer(n_out=3, activation="softmax"))
            .set_input_type(InputType.convolutional(6, 6, 3)).build())
    model = SequentialModel(conf, device="cpu").init()
    cache = CachedDataSetIterator(_base("port", _arrays()), str(tmp_path))
    reg = registry()
    wait = reg.counter("dl4jtpu_etl_wait_seconds_total")
    hits = reg.counter("dl4jtpu_data_cache_batches_total")
    h0, d0 = hits.value(source="cache"), hits.value(source="decode")
    model.fit(cache)                   # populates
    assert hits.value(source="decode") - d0 == 3
    etl0, cache0 = model.etl_wait_s, wait.value(source="cache")
    model.fit(cache)                   # replays
    assert hits.value(source="cache") - h0 == 3
    assert wait.value(source="cache") > cache0
    assert model.etl_wait_s == etl0 and model.last_etl_wait_s == 0.0
    assert model.iteration == 6 and np.isfinite(model.score_value)
