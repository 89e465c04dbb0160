"""The port's speculative decoding, prefill handoff and fault plans against
the JAX package, on the CPU, at `tests/test_speculative.py`'s sizes
(vocab 31, d_model 16, 2 heads, 2 layers; 4 slots of 8-row pages), the
weights carried by `convert.params_from_jax`.

- Drafters: `NGramDrafter` proposes the JAX drafter's tokens on seeded
  random and cyclic histories for k 1-6; `ModelDrafter` on the same
  draft model proposes the same tokens.
- `paged_attention_chunk` (its plain version here) against both JAX
  routes, f32 and int8 pages, within 1e-5.  Against the XLA chunk route
  on every row, idle rows included (both give zeros there); against the
  Pallas route in interpret mode on live rows only: that kernel masks
  every position of an ``attend_len`` 0 row to the same score and
  returns the mean of the row's V, which the engine never reads.
- `reserve_speculative` / `truncate_to` / `release` leave both caches
  with the same tables and free lists.
- Engines: the port's spec engine and the JAX spec engine serve the
  same streams with identical tokens and identical
  ``stats()["speculative"]`` counters (greedy across the 8/16 buckets,
  sampled at three seeds, the model drafter, int8 pages, a per-request
  ``spec_k=0``, a stop token inside a chunk, corrupt drafts, and a
  raising drafter that latches the plain fallback mid-stream), and
  every page comes back.  Streams are queued before the engines start,
  so both admit them together and dispatch the same batches.  Greedy
  f32 streams also equal the port's plain engine and dense `generate`.
- The handoff: an f32 engine's `prefill_detached` joined into an
  int8-page engine serves the JAX pair's tokens.
- `runtime.faults` parses plans as the JAX module does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.ops.paged_attention import (
    paged_attention_chunk as jax_chunk,
)
from deeplearning4j_tpu.runtime import faults as jax_faults
from deeplearning4j_tpu.serving import speculative as jax_spec
from deeplearning4j_tpu.serving.generation import (
    GenerationConfig as JaxGenerationConfig,
)
from deeplearning4j_tpu.serving.generation import (
    GenerationEngine as JaxGenerationEngine,
)
from deeplearning4j_tpu.serving.kv_cache import PagedKVCache as JaxKV
from deeplearning4j_tpu.serving.kv_cache import (
    quantize_page_rows as jax_quantize,
)
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.ops.generation import generate
from deeplearning4j_tpu_torch.ops.paged_attention import (
    paged_attention_chunk,
    paged_attention_chunk_plain,
)
from deeplearning4j_tpu_torch.runtime import faults
from deeplearning4j_tpu_torch.serving import speculative
from deeplearning4j_tpu_torch.serving.admission import ServingError
from deeplearning4j_tpu_torch.serving.generation import (
    GenerationConfig,
    GenerationEngine,
)
from deeplearning4j_tpu_torch.serving.kv_cache import (
    SCRATCH_PAGE,
    PagedKVCache,
    quantize_page_rows,
)
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

# small shapes: one intra-op thread keeps these files from competing with
# the multi-process tests that share the host under pytest-xdist
torch.set_num_threads(1)

VOCAB, D, HEADS, LAYERS = 31, 16, 2, 2
CFG = dict(slots=4, page_size=8, num_pages=64, max_pages_per_seq=4,
           max_queue=16, default_max_new=8)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    faults.disarm()
    jax_faults.disarm()


def _pair(seed=5, d=D, heads=HEADS, layers=LAYERS):
    kw = dict(vocab_size=VOCAB, d_model=d, n_heads=heads, n_layers=layers,
              causal=True, seed=seed)
    jm = JaxTE(**kw).init_model()
    port = SequentialModel(TransformerEncoder(**kw).conf(), device="cpu")
    return jm, params_from_jax(jax.tree.map(np.asarray, jm.params), port)


@pytest.fixture(scope="module")
def models():
    return _pair()


@pytest.fixture(scope="module")
def draft_models():
    """A smaller, different transformer: drafts sometimes right, sometimes
    wrong."""
    return _pair(seed=9, d=8, heads=1, layers=1)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _loopy_prompt(n, period=3, seed=0):
    base = np.random.default_rng(seed).integers(0, VOCAB, period).astype(np.int32)
    return np.tile(base, n // period + 1)[:n].copy()


# -- drafters -------------------------------------------------------------------

def _histories():
    rng = np.random.default_rng(3)
    out = [rng.integers(0, VOCAB, n).astype(np.int32) for n in (1, 2, 5, 17, 40)]
    out += [rng.integers(0, 4, n).astype(np.int32) for n in (6, 23)]   # repeats
    out += [_loopy_prompt(n, period=p, seed=n)
            for n, p in ((9, 3), (14, 4), (30, 5), (7, 7))]
    return out


@pytest.mark.parametrize("k", range(1, 7))
def test_ngram_drafts_equal_the_jax_drafter(k):
    mine, ref = speculative.NGramDrafter(), jax_spec.NGramDrafter()
    for h in _histories():
        got, want = mine.draft(h, k), ref.draft(h, k)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_model_drafter_drafts_equal_the_jax_drafter(draft_models):
    jd, pd = draft_models
    mine, ref = speculative.ModelDrafter(pd), jax_spec.ModelDrafter(jd)
    for h in _histories()[2:8]:
        for k in (1, 3, 5):
            np.testing.assert_array_equal(mine.draft(h, k), ref.draft(h, k))


def test_make_drafter_and_env_knobs(draft_models, monkeypatch):
    assert speculative.ENV_SPEC_K == jax_spec.ENV_SPEC_K
    assert speculative.ENV_SPEC_DRAFTER == jax_spec.ENV_SPEC_DRAFTER
    assert speculative.make_drafter("prompt_lookup").name == "ngram"
    assert speculative.make_drafter("model", draft_model=draft_models[1]).name == "model"
    for bad in ("model", "oracle"):         # a model drafter needs a model
        with pytest.raises(ValueError):
            speculative.make_drafter(bad)
    for raw in ("3", "-2", "four", ""):
        monkeypatch.setenv(speculative.ENV_SPEC_K, raw)
        assert speculative.spec_k_from_env(0) == jax_spec.spec_k_from_env(0)
    monkeypatch.setenv(speculative.ENV_SPEC_DRAFTER, " Model ")
    assert speculative.drafter_from_env() == jax_spec.drafter_from_env() == "model"


# -- the chunk attention ---------------------------------------------------------

S, C, P, PS, MAXP, DH = 4, 3, 14, 8, 3, 16
SEQ = np.array([5, 17, 0, 21], np.int32)     # slot 2 idle


def _chunk_inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, C, HEADS, DH)).astype(np.float32)
    kp = rng.standard_normal((P, PS, HEADS, DH)).astype(np.float32)
    vp = rng.standard_normal((P, PS, HEADS, DH)).astype(np.float32)
    pages = rng.permutation(np.arange(1, P)).astype(np.int32)
    tbl = np.full((S, MAXP), SCRATCH_PAGE, np.int32)
    used = 0
    for s, n in enumerate(SEQ):
        k = -(-(int(n) + C) // PS) if n else 0
        tbl[s, :k] = pages[used:used + k]
        used += k
    attend = np.where(SEQ[:, None] > 0,
                      np.minimum(SEQ[:, None] + np.arange(C) + 1, MAXP * PS), 0)
    return q, kp, vp, tbl, attend.astype(np.int32)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]   # writable copies


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("quant", [False, True])
def test_chunk_attention_matches_both_jax_routes(impl, quant):
    q, kp, vp, tbl, attend = _chunk_inputs(11 + quant)
    scales = {}
    if quant:
        kq, ks = jax_quantize(kp)
        vq, vs = jax_quantize(vp)
        kp, vp = np.asarray(kq), np.asarray(vq)
        scales = dict(k_scale=np.asarray(ks), v_scale=np.asarray(vs))
    ref = np.asarray(jax_chunk(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(attend), impl=impl, interpret=True,
        **{k: jnp.asarray(v) for k, v in scales.items()}))
    out = paged_attention_chunk(
        *_t(q, kp, vp, tbl, attend),
        **{k: t for k, t in zip(scales, _t(*scales.values()))}).numpy()
    assert out.shape == (S, C, HEADS, DH)
    # the Pallas route averages V over an idle row; the engine never reads it
    live = SEQ > 0 if impl == "pallas" else slice(None)
    np.testing.assert_allclose(out[live], ref[live], **TOL)
    assert np.all(out[2] == 0.0)
    plain = paged_attention_chunk_plain(
        *_t(q, kp, vp, tbl, attend),
        *(_t(*scales.values()) if quant else ())).numpy()
    np.testing.assert_array_equal(out, plain)


def test_int8_page_rows_quantize_as_the_jax_package():
    a = np.random.default_rng(2).standard_normal((6, HEADS, DH)).astype(np.float32)
    a[1] = 0.0
    q, s = quantize_page_rows(torch.from_numpy(a))
    jq, js = jax_quantize(a)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_chunk_attention_checks_its_arguments():
    q, kp, vp, tbl, attend = _t(*_chunk_inputs(1))
    with pytest.raises(ValueError, match="BOTH"):
        paged_attention_chunk(q, kp, vp, tbl, attend, k_scale=torch.ones(P, PS, HEADS))
    with pytest.raises(ValueError, match="attend_lens"):
        paged_attention_chunk(q, kp, vp, tbl, attend[:, :2])
    with pytest.raises(TypeError):
        paged_attention_chunk(q[:, 0], kp, vp, tbl, attend)


# -- speculative reservation -----------------------------------------------------

def test_reservation_and_truncation_match_the_jax_cache():
    kw = dict(n_layers=2, n_heads=2, head_dim=8, num_pages=12, page_size=8)
    mine, ref = PagedKVCache(**kw, device="cpu"), JaxKV(**kw)
    ops = [("alloc", "a", 2), ("reserve_speculative", "a", 16 + 8),
           ("alloc", "b", 3), ("reserve_speculative", "b", 3 * 8 + 20),
           ("truncate_to", "a", 16), ("reserve_speculative", "c", 8),
           ("alloc", "c", 1), ("reserve_speculative", "c", 8 * 11),
           ("truncate_to", "b", 9), ("release", "a"),
           ("reserve_speculative", "b", 40), ("release", "b"), ("release", "c")]
    for name, *args in ops:
        got, want = getattr(mine, name)(*args), getattr(ref, name)(*args)
        assert got == want, (name, args)
        for rid in "abc":
            assert mine.table(rid) == ref.table(rid)
        assert mine._free == ref._free
        assert mine.stats()["spec_reserved_pages"] == ref.stats()["spec_reserved_pages"]
        assert mine.leak_check() is None and ref.leak_check() is None
    assert mine.used_pages == ref.used_pages == 0


# -- engines ---------------------------------------------------------------------

SPEC_KEYS = ("enabled", "k", "drafter", "drafted", "accepted", "rejected", "bonus",
             "acceptance_ratio", "verify_dispatches", "plain_dispatches",
             "tokens_per_dispatch", "fallbacks")


def _run(eng, streams, plan=None, fault_mod=None):
    """Queue every (prompt, max_new, kwargs) stream, then start the
    engine: it admits them together.  Returns (outputs, requests, stats)."""
    reqs = [eng.submit(p, m, **kw) for p, m, kw in streams]
    if plan is not None:
        fault_mod.arm(plan)
    eng.start()
    try:
        outs = [np.asarray(r.result(timeout=120)) for r in reqs]
        st = eng.stats()
        assert eng.kv.leak_check() is None
        assert eng.kv.used_pages == 0
        assert eng.kv.stats()["spec_reserved_pages"] == 0
    finally:
        eng.stop()
        if fault_mod is not None:
            fault_mod.disarm()
    return outs, reqs, st


def _both(models, streams, plan=None, **cfg):
    jm, port = models
    jax_cfg = dict(cfg)
    if "spec_draft_model" in cfg:       # a (JAX model, port model) pair
        jax_cfg["spec_draft_model"] = cfg["spec_draft_model"][0]
        cfg["spec_draft_model"] = cfg["spec_draft_model"][1]
    want = _run(JaxGenerationEngine(model=jm, config=JaxGenerationConfig(**{**CFG, **jax_cfg})),
                streams, plan, jax_faults)
    got = _run(GenerationEngine(port, GenerationConfig(**{**CFG, **cfg})),
               streams, plan, faults)
    for o_got, o_want in zip(got[0], want[0]):
        np.testing.assert_array_equal(o_got, o_want)
    for r_got, r_want in zip(got[1], want[1]):
        assert (r_got.spec_drafted, r_got.spec_accepted, r_got.spec_disabled) == \
            (r_want.spec_drafted, r_want.spec_accepted, r_want.spec_disabled)
    assert {k: got[2]["speculative"][k] for k in SPEC_KEYS} == \
        {k: want[2]["speculative"][k] for k in SPEC_KEYS}
    assert got[2]["tokens_generated"] == want[2]["tokens_generated"]
    return got


def _dense(model, prompt, max_new, **kw):
    return generate(model, prompt[None], max_new, **kw)[0].numpy()


def _plain(model, streams):
    eng = GenerationEngine(model, GenerationConfig(**CFG, spec_k=0))
    return _run(eng, [(p, m, {k: v for k, v in kw.items() if k != "spec_k"})
                      for p, m, kw in streams])[0]


def test_greedy_across_buckets_matches_jax_plain_and_dense(models):
    streams = [(_loopy_prompt(4, seed=1), 16, {}), (_loopy_prompt(8, seed=2), 20, {}),
               (_loopy_prompt(12, seed=3), 16, {}), (_prompt(7, seed=4), 12, {})]
    outs, _, st = _both(models, streams, spec_k=4)
    spec = st["speculative"]
    assert spec["enabled"] and spec["k"] == 4 and spec["drafter"] == "ngram"
    assert spec["drafted"] > 0 and spec["accepted"] > 0 and spec["verify_dispatches"] > 0
    for (p, m, _), out, plain in zip(streams, outs, _plain(models[1], streams)):
        np.testing.assert_array_equal(out, plain)
        np.testing.assert_array_equal(out, _dense(models[1], p, m))


def test_sampled_streams_match_jax_and_dense(models):
    streams = [(_loopy_prompt(6, seed=s), 14, dict(temperature=0.9, top_k=5, seed=s))
               for s in (0, 7, 42)]
    outs, _, st = _both(models, streams, spec_k=3)
    assert st["speculative"]["drafted"] > 0
    for (p, m, kw), out in zip(streams, outs):
        np.testing.assert_array_equal(out, _dense(models[1], p, m, **kw))


def test_model_drafter_matches_jax(models, draft_models):
    streams = [(_prompt(5, seed=11), 12, {}), (_loopy_prompt(9, seed=12), 10, {})]
    outs, _, st = _both(models, streams, spec_k=2, spec_drafter="model",
                        spec_draft_model=draft_models)
    assert st["speculative"]["drafter"] == "model" and st["speculative"]["drafted"] > 0
    for (p, m, _), out in zip(streams, outs):
        np.testing.assert_array_equal(out, _dense(models[1], p, m))


def test_int8_pages_match_jax(models):
    streams = [(_loopy_prompt(5, seed=36), 12, {}), (_prompt(10, seed=37), 9, {})]
    _, _, st = _both(models, streams, spec_k=3, kv_dtype="int8")
    assert st["speculative"]["drafted"] > 0


def test_per_request_spec_k_zero_is_plain(models):
    streams = [(_loopy_prompt(6, seed=21), 10, dict(spec_k=0)),
               (_loopy_prompt(6, seed=22), 10, dict(spec_k=2))]
    outs, reqs, _ = _both(models, streams, spec_k=4)
    assert reqs[0].spec_drafted == 0 and reqs[1].spec_drafted > 0
    np.testing.assert_array_equal(outs[0], _dense(models[1], streams[0][0], 10))


def test_stop_token_inside_a_chunk(models):
    """The target model drafting for itself: every draft is accepted, so
    the first dispatch after the prefill emits positions 1 to 5, and a
    stop token first generated at position 2 or 3 cuts that chunk."""
    p = _prompt(7, seed=9)
    ref = _dense(models[1], p, 12)
    gen = ref[len(p):]
    f = next(i for i in (3, 2) if int(np.argmax(gen == gen[i])) == i)   # 2
    outs, _, st = _both(models, [(p, 12, dict(stop_tokens=(int(gen[f]),)))],
                        spec_k=4, spec_drafter="model", spec_draft_model=models)
    np.testing.assert_array_equal(outs[0], ref[: len(p) + f + 1])
    spec = st["speculative"]
    assert spec["verify_dispatches"] == 1 and spec["accepted"] == f


def test_corrupt_drafts_are_all_rejected(models):
    streams = [(_loopy_prompt(6, seed=41), 12, {}), (_loopy_prompt(9, seed=42), 11, {})]
    outs, _, st = _both(models, streams, plan="serving.draft:corrupt:every=1", spec_k=4)
    spec = st["speculative"]
    assert spec["drafted"] > 0 and spec["acceptance_ratio"] < 0.5
    for (p, m, _), out in zip(streams, outs):
        np.testing.assert_array_equal(out, _dense(models[1], p, m))


def test_raising_drafter_latches_the_plain_fallback(models):
    streams = [(_loopy_prompt(6, seed=51), 14, {}), (_loopy_prompt(7, seed=52), 12, {})]
    outs, reqs, st = _both(models, streams, plan="serving.draft:raise:nth=2", spec_k=4)
    assert st["speculative"]["fallbacks"] == 1
    assert sum(r.spec_disabled for r in reqs) == 1
    for (p, m, _), out in zip(streams, outs):
        np.testing.assert_array_equal(out, _dense(models[1], p, m))


# -- the prefill handoff ---------------------------------------------------------

def test_f32_prefill_feeds_an_int8_decode_engine_as_in_jax(models):
    jm, port = models
    prompts = [(_prompt(9, seed=61), {}),
               (_loopy_prompt(5, seed=62), dict(temperature=0.7, top_k=4, seed=3))]

    def pair(make, cfg_cls):
        pre = make(cfg_cls(**CFG))
        dec = make(cfg_cls(**CFG, kv_dtype="int8", spec_k=2))
        hands = [pre.prefill_detached(p, 10, **kw) for p, kw in prompts]
        reqs = [dec.join_prefilled(h) for h in hands]
        dec.start()
        try:
            outs = [np.asarray(r.result(timeout=120)) for r in reqs]
            assert dec.kv.leak_check() is None and dec.kv.used_pages == 0
        finally:
            dec.stop()
        return hands, outs, dec.stats()

    want = pair(lambda c: JaxGenerationEngine(model=jm, config=c), JaxGenerationConfig)
    got = pair(lambda c: GenerationEngine(port, c), GenerationConfig)
    for h_got, h_want in zip(got[0], want[0]):
        assert h_got["first_token"] == h_want["first_token"]
        assert h_got["k"].dtype == np.float32
        np.testing.assert_allclose(h_got["k"], np.asarray(h_want["k"]), **TOL)
        np.testing.assert_allclose(h_got["v"], np.asarray(h_want["v"]), **TOL)
    for o_got, o_want in zip(got[1], want[1]):
        np.testing.assert_array_equal(o_got, o_want)
    assert got[2]["prefills"] == 0          # the decode engine ran none


def test_injected_prefill_fault_fails_the_handoff_and_the_stream(models):
    eng = GenerationEngine(models[1], GenerationConfig(**CFG))
    faults.arm("serving.prefill:raise:nth=1")
    with pytest.raises(ServingError, match="injected prefill fault"):
        eng.prefill_detached(_prompt(5), 4)
    faults.arm("serving.prefill:raise:nth=1")
    req = eng.submit(_prompt(5), 4)
    eng.start()
    try:
        with pytest.raises(ServingError, match="prefill failed"):
            req.result(timeout=60)
        assert req.outcome == "error" and eng.kv.leak_check() is None
        assert eng.kv.used_pages == 0
    finally:
        eng.stop()


# -- fault plans -----------------------------------------------------------------

@pytest.mark.parametrize("plan", [
    "serving.draft:corrupt:every=1",
    "serving.draft:raise:nth=2",
    "serving.prefill:raise:once;serving.draft:corrupt:p=0.25,seed=3,max=4",
    "serving.draft:delay:every=3,secs=0.0",
    "serving.draft:raise:exc=runtime,every=2",
])
def test_fault_plans_parse_and_fire_as_in_jax(plan):
    mine, ref = faults.FaultPlan.parse(plan), jax_faults.FaultPlan.parse(plan)
    assert mine.spec() == ref.spec() and mine.sites() == ref.sites()
    faults.arm(mine)
    jax_faults.arm(ref)
    for _ in range(12):
        for site in ("serving.draft", "serving.prefill"):
            try:
                got = ("ok", faults.maybe_fail(site))
            except Exception as exc:          # noqa: BLE001 - compared below
                got = ("raise", type(exc).__name__)
            try:
                want = ("ok", jax_faults.maybe_fail(site))
            except Exception as exc:          # noqa: BLE001
                want = ("raise", type(exc).__name__)
            assert got == want
    assert mine.stats() == ref.stats()
    assert set(faults.SITES) == set(jax_faults.SITES)


@pytest.mark.parametrize("bad", ["", "serving.draft", "serving.draft:explode",
                                 "serving.draft:raise:nth=1,every=2",
                                 "serving.draft:raise:colour=red"])
def test_bad_fault_plans_raise_as_in_jax(bad):
    with pytest.raises(ValueError):
        jax_faults.FaultPlan.parse(bad)
    with pytest.raises(ValueError):
        faults.FaultPlan.parse(bad)
