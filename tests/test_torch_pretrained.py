"""The pretrained registry (`zoo/pretrained.py`, `ZooModel.init_pretrained`)
on the CPU: the JAX package's five cases (`tests/test_pretrained.py`),
and a zip registered by either package loading in the other.

Outputs of a restored model equal the saved model's within rtol 1e-5 /
atol 1e-6 (one package) and within 1e-5 of the largest element across
the packages (f32 forwards in another order).
"""

import shutil

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.zoo.lenet import LeNet as JaxLeNet
from deeplearning4j_tpu.zoo.pretrained import PretrainedRegistry as JaxRegistry
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.zoo.lenet import LeNet
from deeplearning4j_tpu_torch.zoo.pretrained import (
    ENV_PRETRAINED_DIR,
    ChecksumMismatchError,
    PretrainedRegistry,
)

torch.set_num_threads(1)

SIZE = dict(num_classes=3, height=12, width=12)


@pytest.fixture
def registry(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV_PRETRAINED_DIR, str(tmp_path / "models"))
    return PretrainedRegistry()


def trained_lenet_zip(tmp_path):
    m = LeNet(**SIZE).init_model(device="cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (16, 12, 12, 1)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)]
    m.fit_batch(DataSet(x, y))
    p = str(tmp_path / "weights.zip")
    m.save(p)
    return m, p, x


def _same(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


class TestRegistry:
    def test_register_resolve_init_pretrained_roundtrip(self, registry, tmp_path):
        m, p, x = trained_lenet_zip(tmp_path)
        entry = registry.register("lenet", "mnist", p)
        assert len(entry["sha256"]) == 64
        loaded = LeNet(**SIZE).init_pretrained("mnist", device="cpu")
        _same(m.output(x), loaded.output(x))
        assert registry.available("lenet") == {"mnist": entry}

    def test_corruption_detected(self, registry, tmp_path):
        _, p, _ = trained_lenet_zip(tmp_path)
        registry.register("lenet", "mnist", p)
        target = registry.root / "lenet_mnist.zip"
        data = bytearray(target.read_bytes())
        data[100] ^= 0xFF
        target.write_bytes(bytes(data))
        with pytest.raises(ChecksumMismatchError, match="sha256"):
            registry.resolve("lenet", "mnist")
        with pytest.raises(ChecksumMismatchError):
            LeNet(**SIZE).init_pretrained("mnist", device="cpu")

    def test_missing_registration_names_alternatives(self, registry, tmp_path):
        _, p, _ = trained_lenet_zip(tmp_path)
        registry.register("lenet", "mnist", p)
        with pytest.raises(FileNotFoundError, match="mnist"):
            registry.resolve("lenet", "imagenet")

    def test_legacy_bare_zip_layout_still_loads(self, registry, tmp_path):
        m, p, x = trained_lenet_zip(tmp_path)
        registry.root.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(p, registry.root / "lenet.zip")
        loaded = LeNet(**SIZE).init_pretrained(device="cpu")
        _same(m.output(x), loaded.output(x))

    def test_explicit_path_bypasses_registry(self, registry, tmp_path):
        m, p, x = trained_lenet_zip(tmp_path)
        loaded = LeNet(**SIZE).init_pretrained(path=p, device="cpu")
        _same(m.output(x), loaded.output(x))


def test_a_zip_either_package_registered_loads_in_the_other(registry, tmp_path):
    """The registry directory, its index and its zips are one format: the
    port resolves and restores the JAX package's registration, and the
    JAX package the port's."""
    jm = JaxLeNet(**SIZE).init_model()
    x = np.random.default_rng(1).normal(size=(4, 12, 12, 1)).astype(np.float32)
    jzip = str(tmp_path / "jax.zip")
    jm.save(jzip)
    jreg = JaxRegistry()                  # the same directory, from the environment
    assert jreg.root == registry.root
    jentry = jreg.register("lenet", "jax_made", jzip)
    assert registry.available("lenet")["jax_made"] == jentry
    got = LeNet(**SIZE).init_pretrained("jax_made", device="cpu").output(x)
    want = np.asarray(jm.output(x))
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()

    pm, p, _ = trained_lenet_zip(tmp_path)
    registry.register("lenet", "port_made", p)
    theirs = JaxLeNet(**SIZE).init_pretrained("port_made")
    want = pm.output(x).numpy()
    assert np.abs(np.asarray(theirs.output(x)) - want).max() <= 1e-5 * np.abs(want).max()
