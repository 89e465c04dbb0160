"""The port's `GenerationEngine` against the JAX package's engine, on the
CPU, over the same converted weights.

- Head dims the paged-attention kernel did not take before (16, 48):
  greedy streams are token-identical to the JAX engine's.
- Seeds outside uint32: the JAX engine converts a stream's seed with
  ``np.uint32`` inside its prefill ``try``, so a seed below 0 or from
  2^32 up ends the stream with outcome ``"error"`` and a
  ``prefill failed`` `ServingError`; the port ends it the same way.  The
  largest uint32 seed serves the same sampled tokens on both engines.
"""

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.serving.admission import ServingError as JaxServingError
from deeplearning4j_tpu.serving.generation import (
    GenerationConfig as JaxGenerationConfig,
)
from deeplearning4j_tpu.serving.generation import (
    GenerationEngine as JaxGenerationEngine,
)
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.serving.admission import ServingError
from deeplearning4j_tpu_torch.serving.generation import (
    GenerationConfig,
    GenerationEngine,
)
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

# small shapes: one intra-op thread keeps these files from competing with
# the multi-process tests that share the host under pytest-xdist
torch.set_num_threads(1)

VOCAB, HEADS, LAYERS = 53, 2, 2
CFG = dict(slots=4, page_size=8, num_pages=48, max_pages_per_seq=4,
           max_queue=16)
MAX_NEW = 8


def _pair(head_dim):
    kw = dict(vocab_size=VOCAB, d_model=HEADS * head_dim, n_heads=HEADS,
              n_layers=LAYERS, causal=True, seed=9)
    jm = JaxTE(**kw).init_model()
    port = SequentialModel(TransformerEncoder(**kw).conf(), device="cpu")
    return jm, params_from_jax(jax.tree.map(np.asarray, jm.params), port)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _serve(eng, streams):
    """Submit every (prompt, kwargs) stream at once; returns each one's
    (outcome, tokens or the error) once all have ended."""
    eng.start()
    try:
        reqs = [eng.submit(p, MAX_NEW, **kw) for p, kw in streams]
        out = []
        for r in reqs:
            try:
                out.append((r.result(timeout=120), None))
            except Exception as exc:      # noqa: BLE001 - compared below
                out.append((None, exc))
        return [(r.outcome, *o) for r, o in zip(reqs, out)]
    finally:
        eng.stop()


def _engines(head_dim):
    jm, port = _pair(head_dim)
    return (JaxGenerationEngine(model=jm, config=JaxGenerationConfig(**CFG)),
            GenerationEngine(port, GenerationConfig(**CFG)))


@pytest.mark.parametrize("head_dim", [16, 48])
def test_engine_serves_head_dims_like_the_jax_engine(head_dim):
    jax_eng, port_eng = _engines(head_dim)
    streams = [(_prompt(n, seed=n), {}) for n in (3, 9, 14)]
    want = _serve(jax_eng, streams)
    got = _serve(port_eng, streams)
    for (j_out, j_tok, j_err), (p_out, p_tok, p_err) in zip(want, got):
        assert j_err is None and p_err is None, (j_err, p_err)
        assert j_out == p_out == "ok"
        np.testing.assert_array_equal(p_tok, j_tok)
    assert port_eng.kv.leak_check() is None


def test_seeds_outside_uint32_end_the_stream_as_the_jax_engine_does():
    jax_eng, port_eng = _engines(16)
    sampled = dict(temperature=0.8, top_k=8)
    streams = [(_prompt(6, seed=1), dict(sampled, seed=s))
               for s in (-1, 2**32, 2**32 - 1)]
    want = _serve(jax_eng, streams)
    got = _serve(port_eng, streams)
    for (j_out, _, j_err), (p_out, _, p_err) in zip(want[:2], got[:2]):
        assert j_out == p_out == "error"
        assert isinstance(j_err, JaxServingError)
        assert isinstance(p_err, ServingError)
        assert str(j_err).startswith("prefill failed")
        assert str(p_err).startswith("prefill failed")
    (j_out, j_tok, j_err), (p_out, p_tok, p_err) = want[2], got[2]
    assert j_err is None and p_err is None, (j_err, p_err)
    assert j_out == p_out == "ok"
    np.testing.assert_array_equal(p_tok, j_tok)
    assert port_eng.kv.leak_check() is None
