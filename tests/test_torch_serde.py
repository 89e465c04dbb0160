"""The port's configuration JSON (`utils/serde.py`) against the JAX
package's, on the CPU.

- A configuration the JAX package writes (`to_json`) loads in the port
  (`from_json`) and the port writes it back as the same JSON object; a
  configuration the port builds loads in the JAX package as a dataclass
  equal to the one the JAX package builds itself.  Held for the zoo
  transformer (both heads), every updater with a constant rate and with
  each schedule, gradient clipping, model-level defaults (activation,
  weight init, l1, l2, dropout), a learned positional encoding, and
  settings the port loads but cannot run yet (TBPTT, ring attention).
- The enums (activations, losses, weight schemes) have the JAX package's
  members and values; aliases coerce as there.
- A tag the port lacks raises `NotImplementedError` naming its ROADMAP
  item; every JAX tag is either registered in the port or listed.
"""

import json

import pytest
import torch

import jax  # noqa: F401  (conftest keeps it on the CPU)

from deeplearning4j_tpu.nn import activations as jax_activations
from deeplearning4j_tpu.nn import losses as jax_losses
from deeplearning4j_tpu.nn import schedules as jax_schedules
from deeplearning4j_tpu.nn import updaters as jax_updaters
from deeplearning4j_tpu.nn import weights as jax_weights
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import layers as jax_layers
from deeplearning4j_tpu.nn.conf.input_type import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf.neural_net_configuration import (
    SequentialConfiguration as JaxSC,
)
from deeplearning4j_tpu.utils import serde as jax_serde
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn import activations, losses, schedules, updaters, weights
from deeplearning4j_tpu_torch.nn.conf import attention, layers, recurrent
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
    SequentialConfiguration,
)
from deeplearning4j_tpu_torch.utils import serde
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

torch.set_num_threads(1)

SMALL = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, seed=7)
UPDATERS = ["Sgd", "Nesterovs", "Momentum", "Adam", "AdamW", "AdaMax", "Nadam",
            "AmsGrad", "AdaGrad", "AdaDelta", "RmsProp", "NoOp"]
SCHEDULES = {
    "FixedSchedule": dict(value=0.05),
    "StepSchedule": dict(initial=0.05, decay_rate=0.5, step=2.0, per_epoch=True),
    "ExponentialSchedule": dict(initial=0.05, gamma=0.9),
    "PolySchedule": dict(initial=0.05, power=2.0, max_iter=8),
    "SigmoidSchedule": dict(initial=0.05, gamma=0.5, step_size=3),
    "InverseSchedule": dict(initial=0.05, gamma=0.3, power=1.5),
    "CosineSchedule": dict(initial=0.05, decay_steps=6, warmup_steps=2,
                           final_fraction=0.1),
}


def _stack(pkg, updater, **builder):
    """The same small stack built through either package's DSL."""
    if pkg == "jax":
        b, lay, att, rec, it = (JaxNNC.builder(), jax_layers,
                                __import__("deeplearning4j_tpu.nn.conf.attention",
                                           fromlist=["x"]),
                                __import__("deeplearning4j_tpu.nn.conf.recurrent",
                                           fromlist=["x"]), JaxInputType)
    else:
        b, lay, att, rec, it = (NeuralNetConfiguration.builder(), layers,
                                attention, recurrent, InputType)
    b = b.seed(5).updater(updater)
    for name, value in builder.items():
        b = getattr(b, name)(*value) if isinstance(value, tuple) else getattr(b, name)(value)
    return (b.list()
            .layer(lay.Embedding(n_in=64, n_out=32))
            .layer(att.PositionalEncoding(learned=True, max_length=16))
            .layer(att.TransformerEncoderBlock(d_model=32, n_heads=2, causal=True,
                                               ffn_activation="relu"))
            .layer(lay.LayerNorm(epsilon=1e-6))
            .layer(rec.RnnOutputLayer(n_out=64, loss="negativeloglikelihood"))
            .set_input_type(it.recurrent(1))
            .build())


def _updater(module, name, sched):
    kw = {}
    if sched is not None:
        smod = jax_schedules if module is jax_updaters else schedules
        kw["learning_rate"] = getattr(smod, sched)(**SCHEDULES[sched])
    return getattr(module, name)(**kw)


def _both_ways(jconf, conf):
    """JAX JSON -> port -> JSON is the same object; port JSON -> JAX is
    the JAX configuration."""
    js = jconf.to_json()
    ported = SequentialConfiguration.from_json(js)
    assert json.loads(ported.to_json()) == json.loads(js)
    assert ported == conf
    assert JaxSC.from_json(conf.to_json()) == jconf
    return ported


@pytest.mark.parametrize("chunked", [True, False])
def test_zoo_transformer_json_round_trips_both_ways(chunked):
    kw = dict(SMALL, chunked_vocab_loss=chunked, vocab_chunk=16)
    ported = _both_ways(JaxTE(**kw).conf(), TransformerEncoder(**kw).conf())
    assert isinstance(ported.layers, tuple)
    assert isinstance(ported.updater, updaters.Adam)


@pytest.mark.parametrize("sched", [None] + list(SCHEDULES))
@pytest.mark.parametrize("name", UPDATERS)
def test_updater_and_schedule_json_round_trips_both_ways(name, sched):
    clip = dict(gradient_clip=(1.0, 5.0))
    jconf = _stack("jax", _updater(jax_updaters, name, sched), **clip)
    conf = _stack("port", _updater(updaters, name, sched), **clip)
    ported = _both_ways(jconf, conf)
    assert type(ported.updater).__name__ == name
    if sched is not None:
        assert type(ported.updater.learning_rate).__name__ == sched


@pytest.mark.parametrize("defaults", [
    dict(activation="tanh", weight_init="relu_uniform"),
    dict(l1=1e-4, l2=1e-3, dropout=0.1, weight_init="lecun_normal"),
    dict(bf16_compute=False, steps_per_epoch=7, tbptt=16),
])
def test_model_level_defaults_round_trip_both_ways(defaults):
    conf = _stack("port", updaters.Adam(1e-3), **defaults)
    jconf = _stack("jax", jax_updaters.Adam(1e-3), **defaults)
    _both_ways(jconf, conf)
    head = conf.layers[-1]
    assert head.loss is losses.Loss.NEGATIVELOGLIKELIHOOD
    if "activation" in defaults:          # never into the output layer
        assert head.activation is None
        assert conf.layers[2].activation is activations.Activation.TANH


def test_settings_the_port_cannot_run_load_and_raise_when_built():
    conf = TransformerEncoder(**SMALL, seq_parallel="ring").conf()
    jconf = JaxTE(**SMALL, seq_parallel="ring").conf()
    _both_ways(jconf, conf)
    # ring attention builds since the model-parallel slice (ROADMAP A11):
    # on one device its blocks attend densely, as the "none" model's do
    ring = SequentialModel(conf, device="cpu").init()
    plain = SequentialModel(TransformerEncoder(**SMALL).conf(), device="cpu").init()
    ids = torch.arange(8, dtype=torch.float32).reshape(1, 8)
    torch.testing.assert_close(ring.output(ids), plain.output(ids), rtol=0, atol=0)
    # truncated BPTT loads and builds since the recurrent slice (ROADMAP A8)
    tb = _stack("port", updaters.Sgd(), tbptt=8)
    assert SequentialModel(tb, device="cpu").conf.tbptt_length == 8
    # a convolutional input type builds since the LeNet slice (ROADMAP A3)
    cnn = (NeuralNetConfiguration.builder().list()
           .layer(layers.Conv2D(n_out=2, kernel=(3, 3)))
           .layer(layers.OutputLayer(n_out=3))
           .set_input_type(InputType.convolutional(8, 8, 1)).build())
    _both_ways(JaxSC.from_json(cnn.to_json()), cnn)
    model = SequentialModel(cnn, device="cpu").init()
    assert tuple(model.output(torch.zeros((2, 8, 8, 1))).shape) == (2, 3)


@pytest.mark.parametrize("pair", [
    (activations.Activation, jax_activations.Activation),
    (losses.Loss, jax_losses.Loss),
    (weights.WeightInit, jax_weights.WeightInit),
])
def test_enums_are_the_jax_packages(pair):
    ours, theirs = pair
    assert [(m.name, m.value) for m in ours] == [(m.name, m.value) for m in theirs]
    assert getattr(ours, "_ALIASES_", {}) == getattr(theirs, "_ALIASES_", {})


def test_enum_fields_coerce_values_names_and_aliases():
    assert recurrent.RnnOutputLayer(loss="NEGATIVELOGLIKELIHOOD").loss is \
        losses.Loss.NEGATIVELOGLIKELIHOOD
    assert recurrent.RnnOutputLayer(loss="mae").loss is losses.Loss.MAE
    assert layers.Embedding(activation="RELU").activation is activations.Activation.RELU
    assert layers.Embedding(weight_init="ORTHOGONAL").weight_init is \
        weights.WeightInit.ORTHOGONAL
    with pytest.raises(ValueError, match="options"):
        layers.Embedding(activation="nope")


@pytest.mark.parametrize("tag,item", [("SeparableConv2D", "A13"), ("LossLayer", "A13"),
                                      ("Deconv2D", "A13"),
                                      ("SpaceToDepth", "A13"),
                                      ("CenterLossOutputLayer", "A13"),
                                      ("Yolo2OutputLayer", "A13")])
def test_a_tag_the_port_lacks_names_its_roadmap_item(tag, item, monkeypatch):
    """Each of these tags waited in ROADMAP ``item`` and is ported now:
    it reads to the port's class of that name.  A tag still listed in
    `serde.UNPORTED` raises naming its item."""
    jconf = (JaxNNC.builder().list().layer(jax_layers.Dense(n_out=4))
             .layer(jax_layers.OutputLayer(n_out=2))
             .set_input_type(JaxInputType.feed_forward(3)).build())
    data = json.loads(jconf.to_json())
    data["layers"][0] = {"@type": tag, "name": "layer0"}
    assert type(serde.from_jsonable(data).layers[0]).__name__ == tag
    assert tag not in serde.UNPORTED
    monkeypatch.setitem(serde.UNPORTED, "FutureLayer", item)
    data["layers"][0]["@type"] = "FutureLayer"
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        serde.from_jsonable(data)
    data["layers"][0]["@type"] = "NoSuchLayer"
    with pytest.raises(KeyError, match="unknown config type"):
        serde.from_jsonable(data)


def test_every_jax_tag_is_registered_or_listed():
    import importlib
    import pkgutil

    import deeplearning4j_tpu

    for m in pkgutil.walk_packages(deeplearning4j_tpu.__path__,
                                   "deeplearning4j_tpu."):
        if m.name.split(".")[1] in ("nn", "utils", "autodiff"):
            try:
                importlib.import_module(m.name)
            except Exception:
                pass
    jax_tags = set(jax_serde._REGISTRY)
    ours = set(serde._REGISTRY)
    assert ours <= jax_tags, ours - jax_tags
    assert jax_tags - ours <= set(serde.UNPORTED), jax_tags - ours - set(serde.UNPORTED)
    assert not ours & set(serde.UNPORTED)


def test_field_names_and_defaults_are_the_jax_classes():
    import dataclasses

    for tag, cls in serde._REGISTRY.items():
        ref = jax_serde._REGISTRY[tag]
        got = [(f.name, f.default) for f in dataclasses.fields(cls)]
        want = [(f.name, f.default) for f in dataclasses.fields(ref)]
        assert got == want, tag
