"""Int8 serving on the port (ROADMAP A7) against the JAX package, on the
CPU: a causal transformer of vocab 256, d_model 64, 4 heads, 2 layers, f32
on both sides.  The JAX side quantizes with its own `quantize`, and the
tree is carried into the port by `params_from_jax`, bit for bit.

- Dense `generate` and the `GenerationEngine` (2-4 slots, f32 and int8
  pages, plain and speculative with the n-gram drafter and a quantized
  model drafter, and the prefill handoff from an f32-page engine into an
  int8-page one): greedy and seeded sampled tokens identical to the JAX
  package's, and the engines' counters equal; the handoff's K/V within
  1e-5 (f32 sums in another order).  The JAX engine dequantizes
  each weight and multiplies (``astype``); the port runs
  `dequant_matmul`'s plain version here.  Both are f32 sums of the same
  products, and the tokens agree exactly.
- The quantized embedding: the port gathers int8 rows and dequantizes
  them; the JAX engine dequantizes the table and gathers.  Bit for bit.
- `ops.dequant_matmul`: `select_impl` is the JAX rule on the CPU for
  every override; ``blocked`` is within 1e-5 of max |ref| of the JAX
  ``blocked`` (f32 sums over the same K blocks, another order inside a
  block) and falls back to ``xla`` where K does not tile; the
  ``dl4jtpu_quant_dequant_matmul_total`` deltas equal the JAX package's
  for direct calls and for ``output()`` calls at two input shapes
  (counted once a program signature); ``pallas`` (kernel B5) raises on
  a CPU tensor.
- `quant/ptq.py`: the ``dl4jtpu_quant_params_bytes`` gauge and the
  ``dl4jtpu_quant_parity_checks_total`` deltas equal the JAX package's.
- The cost registry: ``output()`` of a quantized model registers
  ``("infer", False, "int8")`` with int8 bytes, as the JAX package does.
- `InferenceServer` over a quantized model: ``output()``'s rows,
  ``quantized`` advertised; a JAX-written quantized zip installs through
  ``push_checkpoint`` and ``POST /v1/reload``; a NaN scale and an f32
  tree are rejected with the outputs unchanged; warm start then infer
  captures nothing.
- `ServingFleet` of quantized replicas: a rolling canary deploy of a
  quantized tree and a corrupted canary's rollback give the JAX
  deployer's results, on the routers' injected clock.
- ROADMAP C16: a quantized model built with ``bf16_compute=True``
  computes its engine step in f32 (the JAX engine would compute it in
  bf16).
"""

import http.client
import json

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.observe import metrics as jmetrics
from deeplearning4j_tpu.ops import dequant_matmul as jdm
from deeplearning4j_tpu.ops.generation import generate as jax_generate
from deeplearning4j_tpu.quant import parity_check as jax_parity_check
from deeplearning4j_tpu.quant import quantize as jax_quantize
from deeplearning4j_tpu.quant.qtensor import quantize_array as jax_quantize_array
from deeplearning4j_tpu.runtime import faults as jfaults
from deeplearning4j_tpu.serving import fleet as jfleet_mod
from deeplearning4j_tpu.serving import speculative as jax_spec
from deeplearning4j_tpu.serving.generation import (
    GenerationConfig as JaxGenerationConfig,
)
from deeplearning4j_tpu.serving.generation import (
    GenerationEngine as JaxGenerationEngine,
)
from deeplearning4j_tpu.serving.server import ServingConfig as JaxServingConfig
from deeplearning4j_tpu.train.checkpoint import ModelSerializer as JaxMS
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.observe import cost
from deeplearning4j_tpu_torch.observe import metrics as pmetrics
from deeplearning4j_tpu_torch.ops import dequant_matmul as pdm
from deeplearning4j_tpu_torch.ops.generation import generate
from deeplearning4j_tpu_torch.quant import (
    QuantizedTensor,
    functional as quantf,
    parity_check,
    quantize,
)
from deeplearning4j_tpu_torch.quant.qtensor import quantize_array
from deeplearning4j_tpu_torch.runtime import compile_stats
from deeplearning4j_tpu_torch.runtime import faults as pfaults
from deeplearning4j_tpu_torch.serving import fleet as pfleet_mod
from deeplearning4j_tpu_torch.serving import router as prouter
from deeplearning4j_tpu_torch.serving import speculative
from deeplearning4j_tpu_torch.serving.generation import (
    GenerationConfig,
    GenerationEngine,
)
from deeplearning4j_tpu_torch.serving.http import ServingHTTPServer
from deeplearning4j_tpu_torch.serving.server import (
    InferenceServer,
    ServingConfig,
)
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

torch.set_num_threads(1)

VOCAB, D, HEADS, LAYERS = 256, 64, 4, 2
CFG = dict(page_size=8, num_pages=64, max_pages_per_seq=4, max_queue=16)
SITES = 6 * LAYERS + 1          # six products a block and the head


def _kw(seed, **extra):
    return dict(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS,
                causal=True, seed=seed, **extra)


def _port(jax_model, **extra):
    conf = TransformerEncoder(**_kw(jax_model.conf.seed, **extra)).conf()
    return params_from_jax(jax.tree.map(np.asarray, jax_model.params),
                           SequentialModel(conf, device="cpu"))


def _quantized_pair(seed, **extra):
    jq = jax_quantize(JaxTE(**_kw(seed, **extra)).init_model())
    return jq, _port(jq, **extra)


@pytest.fixture(scope="module")
def models():
    return _quantized_pair(7)


@pytest.fixture(scope="module")
def draft_models():
    kw = dict(vocab_size=VOCAB, d_model=32, n_heads=2, n_layers=1, causal=True,
              seed=9)
    jq = jax_quantize(JaxTE(**kw).init_model())
    port = params_from_jax(jax.tree.map(np.asarray, jq.params),
                           SequentialModel(TransformerEncoder(**kw).conf(),
                                           device="cpu"))
    return jq, port


@pytest.fixture(autouse=True)
def _disarm(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path / "crash"))
    monkeypatch.delenv(pdm.ENV_KERNEL, raising=False)
    yield
    jfaults.disarm()
    pfaults.disarm()


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _loopy(n, seed, period=3):
    base = _prompt(period, seed)
    return np.tile(base, n // period + 1)[:n].copy()


# -- dense generate and the embedding ------------------------------------------


@pytest.mark.parametrize("sample", [None, dict(temperature=0.8, top_k=10, seed=3)],
                         ids=["greedy", "sampled"])
def test_dense_generate_gives_the_jax_packages_tokens(models, sample):
    jq, pq = models
    prompt = np.stack([_prompt(9, 1), _prompt(9, 2)])
    kw = sample or {}
    want = np.asarray(jax_generate(jq, prompt, 12, **kw))
    got = generate(pq, prompt, 12, **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_embedding_rows_are_the_jax_engines_dequantize_then_gather(models):
    jq, pq = models
    ids = _prompt(40, 5).astype(np.int64)
    want = np.asarray(jq.params["layer0"]["W"].astype(jax.numpy.float32)[ids])
    got = quantf.embedding_lookup(pq.compute_params()["layer0"]["W"],
                                  torch.from_numpy(ids))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


# -- the engine ----------------------------------------------------------------


def _run(eng, streams, max_new=10):
    """Queue every (prompt, kwargs) stream, then start: the engine admits
    them together.  Returns (tokens, stats)."""
    reqs = [eng.submit(p, max_new, **kw) for p, kw in streams]
    eng.start()
    try:
        outs = [np.asarray(r.result(timeout=120)) for r in reqs]
        st = eng.stats()
        assert eng.kv.leak_check() is None and eng.kv.used_pages == 0
    finally:
        eng.stop()
    return outs, st


def _engines(models, **cfg):
    jq, pq = models
    jax_cfg = dict(cfg)
    if "spec_draft_model" in cfg:       # a (JAX model, port model) pair
        jax_cfg["spec_draft_model"] = cfg["spec_draft_model"][0]
        cfg["spec_draft_model"] = cfg["spec_draft_model"][1]
    return (JaxGenerationEngine(model=jq, config=JaxGenerationConfig(**CFG, **jax_cfg)),
            GenerationEngine(pq, GenerationConfig(**CFG, **cfg)))


COUNTERS = ("decode_steps", "tokens_generated", "streams")


def _same(models, streams, **cfg):
    jax_eng, port_eng = _engines(models, **cfg)
    want, wst = _run(jax_eng, streams)
    got, gst = _run(port_eng, streams)
    for o_got, o_want in zip(got, want):
        np.testing.assert_array_equal(o_got, o_want)
    assert {k: gst[k] for k in COUNTERS} == {k: wst[k] for k in COUNTERS}
    return got, gst, wst


@pytest.mark.parametrize("slots,kv_dtype", [(2, "f32"), (3, "int8"), (4, "f32"),
                                            (4, "int8")])
def test_engine_gives_the_jax_engines_streams_and_counters(models, slots, kv_dtype):
    streams = [(_prompt(3, 11), {}),
               (_prompt(11, 12), dict(temperature=0.9, top_k=5, seed=4)),
               (_prompt(6, 13), {}),
               (_prompt(17, 14), dict(temperature=0.7, top_k=0, seed=8))]
    got, _, _ = _same(models, streams, slots=slots, kv_dtype=kv_dtype)
    if kv_dtype == "f32":         # greedy f32 streams are dense generate's
        for (p, kw), out in zip(streams, got):
            np.testing.assert_array_equal(
                out, generate(models[1], p[None], 10, **kw)[0].numpy())


SPEC_KEYS = ("drafted", "accepted", "rejected", "bonus", "verify_dispatches",
             "plain_dispatches", "fallbacks")


@pytest.mark.parametrize("drafter,kv_dtype", [("ngram", "f32"), ("ngram", "int8"),
                                              ("model", "f32")])
def test_spec_engine_gives_the_jax_spec_engines_streams(models, draft_models,
                                                        drafter, kv_dtype):
    streams = [(_loopy(6, 21), {}), (_loopy(9, 22, period=4), {}),
               (_prompt(7, 23), dict(temperature=0.9, top_k=5, seed=2))]
    cfg = dict(slots=3, kv_dtype=kv_dtype, spec_k=3, spec_drafter=drafter)
    if drafter == "model":
        cfg["spec_draft_model"] = draft_models
    _, gst, wst = _same(models, streams, **cfg)
    assert gst["speculative"]["drafted"] > 0
    assert {k: gst["speculative"][k] for k in SPEC_KEYS} == \
        {k: wst["speculative"][k] for k in SPEC_KEYS}


def test_a_quantized_model_drafter_drafts_the_jax_drafters_tokens(draft_models):
    jd, pd = draft_models
    mine, ref = speculative.ModelDrafter(pd), jax_spec.ModelDrafter(jd)
    for h in (_prompt(5, 31), _loopy(14, 32), _prompt(23, 33)):
        for k in (1, 3):
            np.testing.assert_array_equal(mine.draft(h, k), ref.draft(h, k))


def test_quantized_prefill_handoff_as_jax(models):
    """An f32-page engine's detached prefill joined into an int8-page
    engine, both over the quantized model: the handoff's K/V (host f32)
    and the streams are the JAX pair's."""
    jq, pq = models
    prompts = [(_prompt(9, 61), {}),
               (_loopy(5, 62), dict(temperature=0.7, top_k=4, seed=3))]

    def pair(make, cfg_cls):
        pre = make(cfg_cls(**CFG, slots=2))
        dec = make(cfg_cls(**CFG, slots=2, kv_dtype="int8"))
        hands = [pre.prefill_detached(p, 10, **kw) for p, kw in prompts]
        reqs = [dec.join_prefilled(h) for h in hands]
        dec.start()
        try:
            outs = [np.asarray(r.result(timeout=120)) for r in reqs]
            assert dec.kv.leak_check() is None and dec.kv.used_pages == 0
        finally:
            dec.stop()
        return hands, outs

    want = pair(lambda c: JaxGenerationEngine(model=jq, config=c), JaxGenerationConfig)
    got = pair(lambda c: GenerationEngine(pq, c), GenerationConfig)
    for h_got, h_want in zip(got[0], want[0]):
        assert h_got["first_token"] == h_want["first_token"]
        assert h_got["k"].dtype == np.float32
        np.testing.assert_allclose(h_got["k"], np.asarray(h_want["k"]),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(h_got["v"], np.asarray(h_want["v"]),
                                   atol=1e-5, rtol=1e-5)
    for o_got, o_want in zip(got[1], want[1]):
        np.testing.assert_array_equal(o_got, o_want)


def test_the_step_program_counts_its_sites_once(models):
    """Prefill at two buckets and many steps: each program counts its
    quantized sites on its first run only (the JAX package counts when
    it traces)."""
    _, pq = models
    c = pmetrics.registry().counter("dl4jtpu_quant_dequant_matmul_total")
    eng = GenerationEngine(pq, GenerationConfig(**CFG, slots=2))
    signatures = set(pq._program_signatures)
    before = c.value(impl="xla")
    _run(eng, [(_prompt(3, 41), {}), (_prompt(12, 42), {})])
    new = pq._program_signatures - signatures
    assert c.value(impl="xla") - before == SITES * len(new)
    assert {s[0] for s in new} <= {"prefill", "step"}


# -- dequant_matmul -----------------------------------------------------------


@pytest.mark.parametrize("env", ["", "auto", "pallas", "blocked", "xla", "bogus"])
def test_select_impl_is_the_jax_rule(monkeypatch, env):
    monkeypatch.setenv(pdm.ENV_KERNEL, env)
    for m in (1, 2, 8, 4096):
        for k in (64, 100, 1024, 2048, 4096):
            for n in (64, 1024, 2048, 32000):
                assert pdm.select_impl(m, k, n, "cpu") == jdm.select_impl(m, k, n)
                if env in ("blocked", "xla"):      # the card runs B5 or raises
                    with pytest.raises(RuntimeError, match="kernel B5"):
                        pdm.select_impl(m, k, n, "cuda")
                else:
                    assert pdm.select_impl(m, k, n, "cuda") == "pallas"
    assert pdm.IMPLS == jdm.IMPLS and pdm.ENV_KERNEL == jdm.ENV_KERNEL


def _dm_case(x_shape, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = rng.standard_normal((x_shape[-1], n)).astype(np.float32)
    return x, jax_quantize_array(w), quantize_array(w)


@pytest.mark.parametrize("x_shape,n", [((8, 256), 128), ((3, 512), 384),
                                       ((2, 7, 1024), 64), ((4, 100), 64)])
def test_blocked_matches_the_jax_blocked_and_counts_alike(monkeypatch, x_shape, n):
    x, jqt, pqt = _dm_case(x_shape, n, sum(x_shape) + n)
    jc = jmetrics.registry().counter("dl4jtpu_quant_dequant_matmul_total")
    pc = pmetrics.registry().counter("dl4jtpu_quant_dequant_matmul_total")
    j0 = {i: jc.value(impl=i) for i in pdm.IMPLS}
    p0 = {i: pc.value(impl=i) for i in pdm.IMPLS}
    monkeypatch.setenv(pdm.ENV_KERNEL, "blocked")
    ref = np.asarray(jdm.dequant_matmul(jax.numpy.asarray(x), jqt.q, jqt.scale))
    out = pdm.dequant_matmul(torch.from_numpy(x), pqt.q, pqt.scale)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    jd = {i: jc.value(impl=i) - j0[i] for i in pdm.IMPLS}
    pd = {i: pc.value(impl=i) - p0[i] for i in pdm.IMPLS}
    assert pd == jd
    # K 100 tiles by no block: the xla baseline runs, and is counted
    assert pd == ({"pallas": 0, "blocked": 0, "xla": 1} if x_shape[-1] == 100
                  else {"pallas": 0, "blocked": 1, "xla": 0})
    block = pdm._pick_block(x_shape[-1])
    if block:
        np.testing.assert_array_equal(out.numpy(), pdm._blocked_dequant_dot(
            torch.from_numpy(x), pqt.q, pqt.scale, block_k=block).numpy())
    monkeypatch.setenv(pdm.ENV_KERNEL, "xla")
    np.testing.assert_array_equal(
        pdm.dequant_matmul(torch.from_numpy(x), pqt.q, pqt.scale).numpy(),
        pdm.dequant_matmul_plain(torch.from_numpy(x), pqt.q, pqt.scale).numpy())


def test_pallas_names_the_kernel_and_needs_the_card(models, monkeypatch):
    x, _, pqt = _dm_case((4, 256), 64, 1)
    monkeypatch.setenv(pdm.ENV_KERNEL, "cublas")     # not a name: the rule runs
    np.testing.assert_array_equal(
        pdm.dequant_matmul(torch.from_numpy(x), pqt.q, pqt.scale).numpy(),
        pdm.dequant_matmul_plain(torch.from_numpy(x), pqt.q, pqt.scale).numpy())
    monkeypatch.setenv(pdm.ENV_KERNEL, "pallas")
    with pytest.raises(RuntimeError, match="CUDA"):
        pdm.dequant_matmul(torch.from_numpy(x), pqt.q, pqt.scale)
    with pytest.raises(RuntimeError, match="CUDA"):
        models[1].output(_prompt(5, 0)[None].astype(np.float32))


def _counter_deltas(metrics_mod, fn):
    c = metrics_mod.registry().counter("dl4jtpu_quant_dequant_matmul_total")
    before = {i: c.value(impl=i) for i in pdm.IMPLS}
    fn()
    return {i: c.value(impl=i) - before[i] for i in pdm.IMPLS}


@pytest.mark.parametrize("env", ["", "blocked", "xla"])
def test_output_counts_each_site_once_a_signature_as_jax(monkeypatch, env):
    monkeypatch.setenv(pdm.ENV_KERNEL, env)
    jq, pq = _quantized_pair(17)
    rng = np.random.default_rng(4)
    shapes = [(2, 12), (2, 12), (3, 20), (2, 12), (3, 20)]
    xs = [rng.integers(0, VOCAB, s).astype(np.float32) for s in shapes]

    def calls(model):
        def run():
            for x in xs:
                model.output(x)
        return run

    want = _counter_deltas(jmetrics, calls(jq))
    got = _counter_deltas(pmetrics, calls(pq))
    assert got == want
    assert sum(got.values()) == 2 * SITES          # two signatures


# -- quant/ptq.py metrics --------------------------------------------------------


def test_params_bytes_gauge_and_parity_counter_as_jax():
    jm = JaxTE(**_kw(23)).init_model()
    port = _port(jm)
    jg = jmetrics.registry().gauge("dl4jtpu_quant_params_bytes")
    pg = pmetrics.registry().gauge("dl4jtpu_quant_params_bytes")
    jq = jax_quantize(jm)
    want = {k: jg.value(kind=k) for k in ("quantized", "f32_equiv")}
    pq = quantize(port)
    got = {k: pg.value(kind=k) for k in ("quantized", "f32_equiv")}
    assert got == want and got["quantized"] < got["f32_equiv"]
    ids = np.random.default_rng(2).integers(0, VOCAB, (2, 16)).astype(np.float32)
    jc = jmetrics.registry().counter("dl4jtpu_quant_parity_checks_total")
    pc = pmetrics.registry().counter("dl4jtpu_quant_parity_checks_total")
    results = ("pass", "fail")
    j0 = {r: jc.value(result=r) for r in results}
    p0 = {r: pc.value(result=r) for r in results}
    verdicts = []
    for tol in (1.0, -1.0):               # a pass, then a forced fail
        verdicts.append((jax_parity_check(jm, jq, ids, top1_tol=tol)["pass"],
                         parity_check(port, pq, ids, top1_tol=tol)["pass"]))
    assert verdicts == [(True, True), (False, False)]
    assert {r: pc.value(result=r) - p0[r] for r in results} == \
        {r: jc.value(result=r) - j0[r] for r in results} == {"pass": 1, "fail": 1}


# -- the cost registry ----------------------------------------------------------


def test_quantized_output_registers_an_int8_program():
    jm = JaxTE(**_kw(31)).init_model()
    port = _port(jm)
    q = quantize(port)
    x = np.random.default_rng(0).integers(0, VOCAB, (2, 8))
    port.output(x)
    q.output(x)
    keys = {r.key: r for r in cost.registry().programs()
            if r.owner_ref() in (port, q)}
    assert {"('infer', False)", "('infer', False, 'int8')"} <= set(keys)
    rec, f32_rec = keys["('infer', False, 'int8')"], keys["('infer', False)"]
    assert rec.quantized and not f32_rec.quantized
    assert rec.params_bytes < rec.params_bytes_f32_equiv
    assert rec.params_bytes < f32_rec.params_bytes
    rec.ensure_analysis()
    assert rec.analysis == "ok" and rec.kernel_work["dequant_matmul"][0] == SITES
    # the record keeps the signature's specs, not the served weights
    assert "int8[256, 64]" in rec.signature
    specs = _qleaves(rec._sig)
    assert len(specs) == SITES + 1 and not any(
        isinstance(v.q, torch.Tensor) for v in specs)


def _qleaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _qleaves(v)]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _qleaves(v)]
    return [tree] if isinstance(tree, QuantizedTensor) else []


# -- the server -----------------------------------------------------------------


def _server(model, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("linger_s", 0.001)
    kw.setdefault("default_deadline_s", 60.0)
    return InferenceServer(model, ServingConfig(**kw))


def _nan_scale(tree):
    w = tree["layer0"]["W"]
    scale = w.scale.detach().clone()
    scale[0] = float("nan")
    return {**tree, "layer0": {**tree["layer0"], "W": QuantizedTensor(w.q, scale)}}


def test_quantized_server_serves_output_rows_and_rejects_bad_pushes(models):
    jq, _ = models
    pq = _port(jq)
    srv = _server(pq).start()
    try:
        x = _prompt(12, 51).astype(np.int64)
        out = np.asarray(srv.infer(x, deadline_s=60.0))
        np.testing.assert_allclose(out, pq.output(x[None]).numpy()[0],
                                   rtol=1e-5, atol=1e-6)
        ref = np.asarray(jq.output(x[None].astype(np.float32)))[0]
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
        assert srv.quantized and srv.health()["quantized"] is True
        assert srv.stats()["quantized"] is True
        f32 = SequentialModel(pq.conf, device="cpu").init().params
        assert not srv.push_weights(_nan_scale(pq.params))
        assert not srv.push_weights(f32)
        assert srv.generation == 0 and srv.stats()["swaps_rolled_back"] == 2
        np.testing.assert_array_equal(np.asarray(srv.infer(x, deadline_s=60.0)), out)
    finally:
        srv.stop()


def test_push_checkpoint_and_reload_of_a_jax_written_quantized_zip(models, tmp_path):
    jq, _ = models
    pq = _port(jq)
    trainer = jax_quantize(JaxTE(**_kw(45)).init_model())
    path = str(tmp_path / "q.zip")
    JaxMS.write_model(trainer, path)
    srv = _server(pq).start()
    fe = ServingHTTPServer(srv, port=0).start()
    try:
        assert srv.push_checkpoint(path) and srv.generation == 1
        x = _prompt(10, 52).astype(np.int64)
        ref = np.asarray(trainer.output(x[None].astype(np.float32)))[0]
        out = np.asarray(srv.infer(x, deadline_s=60.0))
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
        assert isinstance(pq.params["layer0"]["W"], QuantizedTensor)
        conn = http.client.HTTPConnection("127.0.0.1", fe.port, timeout=30)
        conn.request("POST", "/v1/reload", json.dumps({"path": path}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200, resp.read()
        assert srv.generation == 2
    finally:
        fe.stop()
        srv.stop()


def test_warm_start_then_infer_captures_nothing(models):
    pq = _port(models[0])
    srv = _server(pq, max_batch=4)
    assert len(srv.warm_start(_prompt(12, 0).astype(np.int64))) == 3   # 1, 2, 4
    srv.start()
    try:
        snap = compile_stats.snapshot()
        for i in range(4):
            srv.infer(_prompt(12, i).astype(np.int64), deadline_s=60.0)
        assert (compile_stats.snapshot() - snap).jit_cache_misses == 0
    finally:
        srv.stop()


# -- the fleet ------------------------------------------------------------------


class Clock:
    """The routers' monotonic clock, advanced by the test."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    @staticmethod
    def perf_counter():
        import time
        return time.perf_counter()


def _fleet_run(which, seeds):
    """A two-replica quantized fleet: a deploy of a quantized tree, then a
    deploy under ``serving.canary:corrupt:nth=1``.  Returns both results,
    the replicas' generations and the probe row before, between and
    after."""
    conf_kw = _kw(seeds[0])
    goldens = [np.zeros((12,), np.int64)]
    cfg = dict(max_batch=4, linger_s=0.001, default_deadline_s=60.0)
    if which == "jax":
        fleet = jfleet_mod.ServingFleet(
            lambda: jax_quantize(JaxTE(**conf_kw).init_model()), n_replicas=2,
            config=JaxServingConfig(**cfg), golden_inputs=goldens)
        new = [jax_quantize(JaxTE(**_kw(s)).init_model()).params for s in seeds[1:]]
        faults = jfaults
    else:
        def factory():
            return _port(jax_quantize(JaxTE(**conf_kw).init_model()))
        fleet = pfleet_mod.ServingFleet(factory, n_replicas=2,
                                        config=ServingConfig(**cfg),
                                        golden_inputs=goldens)
        new = [_port(jax_quantize(JaxTE(**_kw(s)).init_model())).params
               for s in seeds[1:]]
        faults = pfaults
    fleet.warm_start(goldens[0])
    fleet.start()
    try:
        assert all(srv.quantized for srv in fleet.replicas)
        x = _prompt(12, 61).astype(np.int64)
        rows = [np.asarray(fleet.infer(x, deadline_s=60.0))]
        res = [fleet.deployer.deploy(new[0], source="quant-test")]
        rows.append(np.asarray(fleet.infer(x, deadline_s=60.0)))
        faults.arm("serving.canary:corrupt:nth=1")
        res.append(fleet.deployer.deploy(new[1]))
        faults.disarm()
        rows.append(np.asarray(fleet.infer(x, deadline_s=60.0)))
        return res, [s.generation for s in fleet.replicas], rows
    finally:
        fleet.stop()


def test_quantized_fleet_canary_deploy_and_rollback_as_jax(monkeypatch):
    monkeypatch.setattr(prouter, "time", Clock())
    want = _fleet_run("jax", (47, 48, 49))
    got = _fleet_run("port", (47, 48, 49))
    assert got[0] == want[0] and got[1] == want[1]
    deployed, rolled = got[0]
    assert deployed["installed"] and deployed["replicas_updated"] == 2
    assert not rolled["installed"] and rolled["rolled_back"] >= 1
    before, between, after = got[2]
    assert not np.allclose(between, before)
    np.testing.assert_array_equal(after, between)        # back, bit for bit
    for g, w in zip(got[2], want[2]):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()


# -- ROADMAP C16 ----------------------------------------------------------------


def test_a_bf16_compute_quantized_model_steps_in_f32():
    """The JAX engine computes a quantized model's step in the model's
    compute dtype (bf16 when ``bf16_compute``); the port's quantized
    model computes in f32 whatever the flag says, as its B5 does."""
    jq = jax_quantize(JaxTE(**_kw(71)).init_model())
    flagged, plain = _port(jq, bf16_compute=True), _port(jq)
    assert flagged.conf.bf16_compute is True and flagged._bf16
    assert flagged.compute_dtype == torch.float32
    streams = [(_prompt(5, 72), {}), (_prompt(9, 73), {})]
    got, _ = _run(GenerationEngine(flagged, GenerationConfig(**CFG, slots=2)), streams)
    want, _ = _run(GenerationEngine(plain, GenerationConfig(**CFG, slots=2)), streams)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    cp = flagged.compute_params()
    assert cp["layer2"]["b1"].dtype == torch.float32
    logits = generate(flagged, streams[0][0][None], 2)
    np.testing.assert_array_equal(logits.numpy(),
                                  generate(plain, streams[0][0][None], 2).numpy())
