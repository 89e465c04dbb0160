"""The port's serving slice against the JAX package, end to end.

One small causal transformer (vocab 61, d_model 32, 2 heads of 16, 2
layers, chunked head) is built by the JAX package; its weights go into
the port through `convert.params_from_jax`.  Then:

- `SequentialModel.output` agrees with JAX ``model.output`` (atol 1e-4:
  f32 both sides, 2 layers of different summation order);
- the port's dense `generate` and its `GenerationEngine` (greedy, 3
  concurrent streams of mixed lengths) are token-identical to JAX
  `ops.generation.generate`;
- int8 KV pages pass the JAX package's own int8 agreement gate (>= 0.9);
- a sampled stream gives identical tokens alone and beside others;
- every page comes back (``leak_check() is None``).
"""

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.ops.generation import generate as jax_generate
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.ops.generation import _sample, generate
from deeplearning4j_tpu_torch.serving.admission import ServingRejected
from deeplearning4j_tpu_torch.serving.generation import (
    GenerationConfig,
    GenerationEngine,
)
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

# small shapes: one intra-op thread keeps these files from competing with
# the multi-process tests that share the host under pytest-xdist
torch.set_num_threads(1)

VOCAB, D, HEADS, LAYERS = 61, 32, 2, 2
CFG = dict(slots=4, page_size=8, num_pages=64, max_pages_per_seq=4,
           max_queue=16)
PROMPT_LENS = (4, 9, 13)
MAX_NEW = 10


def _zoo(cls, chunked=True):
    return cls(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS,
               causal=True, seed=5, chunked_vocab_loss=chunked)


def _port(jmodel, chunked=True):
    model = SequentialModel(_zoo(TransformerEncoder, chunked).conf(),
                            device="cpu")
    return params_from_jax(jax.tree.map(np.asarray, jmodel.params), model)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


@pytest.fixture(scope="module")
def jmodel():
    return _zoo(JaxTE).init_model()


@pytest.fixture(scope="module")
def model(jmodel):
    return _port(jmodel)


@pytest.fixture(scope="module")
def refs(jmodel):
    """JAX greedy references, one per prompt length."""
    out = {}
    for n in PROMPT_LENS:
        p = _prompt(n, seed=n)
        out[n] = (p, np.asarray(jax_generate(jmodel, p[None], MAX_NEW))[0])
    return out


def _engine(model, **over):
    return GenerationEngine(model, GenerationConfig(**{**CFG, **over}))


@pytest.mark.parametrize("chunked", [True, False])
def test_output_matches_jax(chunked):
    jm = _zoo(JaxTE, chunked).init_model()
    ids = np.random.default_rng(0).integers(0, VOCAB, (2, 11))
    ref = np.asarray(jm.output(ids.astype(np.float32)))
    out = _port(jm, chunked).output(ids).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


def test_params_from_jax_checks_names_and_shapes(jmodel):
    tree = jax.tree.map(np.asarray, jmodel.params)
    model = SequentialModel(_zoo(TransformerEncoder).conf(), device="cpu")
    bad = dict(tree, layer2=dict(tree["layer2"], W1=tree["layer2"]["W1"][:, :3]))
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(bad, model)
    with pytest.raises(ValueError, match="names"):
        params_from_jax({k: v for k, v in tree.items() if k != "layer0"}, model)
    params_from_jax(tree, model)
    np.testing.assert_array_equal(
        model.params["layer2"]["attn"]["Wq"].detach().numpy(),
        tree["layer2"]["attn"]["Wq"])


def test_dense_generate_matches_jax(model, refs):
    for p, ref in refs.values():
        out = generate(model, p[None], MAX_NEW)[0].numpy()
        np.testing.assert_array_equal(out, ref)


def test_engine_greedy_concurrent_streams_match_jax(model, refs):
    eng = _engine(model).start()
    try:
        reqs = [eng.submit(p, MAX_NEW) for p, _ in refs.values()]
        outs = [r.result(timeout=120) for r in reqs]
        for out, (_, ref) in zip(outs, refs.values()):
            np.testing.assert_array_equal(out, ref)
        assert all(r.ttft_s is not None and r.ttft_s > 0 for r in reqs)
        assert eng.drain(10)
        assert eng.kv.leak_check() is None and eng.kv.used_pages == 0
    finally:
        eng.stop()


def test_int8_kv_agreement_gate(model, refs):
    """The JAX package's int8-page gate: greedy agreement >= 0.9."""
    eng = _engine(model, kv_dtype="int8").start()
    try:
        agree = total = 0
        for p, ref in refs.values():
            out = eng.generate(p, MAX_NEW, timeout=120)
            agree += int((out[len(p):] == ref[len(p):]).sum())
            total += MAX_NEW
        assert eng.kv.leak_check() is None
    finally:
        eng.stop()
    assert agree / total >= 0.9, f"int8 agreement {agree}/{total}"


def test_sampled_stream_is_independent_of_its_neighbours(model):
    p = _prompt(6, seed=1)
    kw = dict(temperature=0.8, top_k=8, seed=42)
    eng = _engine(model).start()
    try:
        alone = eng.generate(p, MAX_NEW, **kw)
        others = [eng.submit(_prompt(n, seed=n), MAX_NEW, temperature=1.0,
                             seed=n) for n in (3, 11)]
        beside = eng.submit(p, MAX_NEW, **kw)
        others.append(eng.submit(_prompt(5, seed=5), MAX_NEW))
        np.testing.assert_array_equal(beside.result(120), alone)
        for r in others:
            r.result(120)
        assert eng.kv.leak_check() is None
    finally:
        eng.stop()
    dense = generate(model, p[None], MAX_NEW, **kw)[0].numpy()
    np.testing.assert_array_equal(dense, alone)


def test_sampling_rule():
    logits = torch.tensor([[0.0, 3.0, 1.0, 2.9]])
    assert int(_sample(logits, temperature=0.0, top_k=0, seed=0, g=0)) == 1
    for g in range(20):      # top-2 never leaves {1, 3}
        tok = int(_sample(logits, temperature=5.0, top_k=2, seed=3, g=g))
        assert tok in (1, 3)
        assert tok == int(_sample(logits, temperature=5.0, top_k=2, seed=3, g=g))


def test_engine_admission_errors(model):
    eng = _engine(model, num_pages=3)
    with pytest.raises(ValueError, match="KV positions"):
        eng.submit(_prompt(8, 0), 40)          # 48 > 4 pages x 8 rows
    with pytest.raises(ValueError, match="empty"):
        eng.submit(np.zeros(0, np.int32), 4)
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(_prompt(4, 0), 0)
    eng.start()
    try:
        req = eng.submit(_prompt(17, 0), 4)     # needs 3 pages, 2 exist
        with pytest.raises(ServingRejected) as ei:
            req.result(60)
        assert ei.value.reason == "kv_exhausted" and ei.value.status == 429
        assert eng.kv.leak_check() is None
    finally:
        eng.stop()
