"""The port's `InferenceServer`, hot-swap and HTTP front against the JAX
package's, on the CPU: a causal transformer of 2 layers, d_model 64,
f32, the port's weights carried from the JAX model by
`convert.params_from_jax`.

- Both servers, fed the same requests (queued before the batcher starts,
  so both coalesce the same batches), give outputs within 1e-5 of each
  other and of ``output()``, and the same counters: requests, batches,
  padding rows, sheds (``queue_full``, ``admit_fault``,
  ``breaker_open``), dispatch errors (an injected raise, the NaN screen)
  and breaker transitions.
- Hot-swap: a perturbed tree installs in both and serves the same
  outputs after; a torn push (``serving.hotswap:truncate``), a poisoned
  one (``corrupt``), a wrong checksum and a shape drift roll back in both
  with the same counters.  A zip the JAX package wrote installs through
  the port's ``push_checkpoint``; a corrupted one rolls back.
- The HTTP status-code table, on an ephemeral port, is the JAX front's
  in every row (400, 404, 409, 429 ``queue_full`` and ``kv_exhausted``,
  503 ``breaker_open``, 200 with streamed NDJSON).
- A hot-swap lands between decode steps with no stream dropped; the
  server's padding rule (a trailing-padding mask on a causal stack is
  served, anything else raises).  A quantized model's server is held in
  `tests/test_torch_quant_serving.py`.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.observe import metrics as jmetrics
from deeplearning4j_tpu.runtime import faults as jfaults
from deeplearning4j_tpu.serving.generation import (
    GenerationConfig as JaxGenerationConfig,
)
from deeplearning4j_tpu.serving.generation import (
    GenerationEngine as JaxGenerationEngine,
)
from deeplearning4j_tpu.serving.http import ServingHTTPServer as JaxHTTP
from deeplearning4j_tpu.serving.server import InferenceServer as JaxServer
from deeplearning4j_tpu.serving.server import ServingConfig as JaxServingConfig
from deeplearning4j_tpu.train.checkpoint import ModelSerializer as JaxMS
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.observe import metrics as pmetrics
from deeplearning4j_tpu_torch.runtime import faults as pfaults
from deeplearning4j_tpu_torch.serving.admission import (
    ServingError,
    ServingRejected,
)
from deeplearning4j_tpu_torch.serving.generation import (
    GenerationConfig,
    GenerationEngine,
)
from deeplearning4j_tpu_torch.serving.hotswap import weights_checksum
from deeplearning4j_tpu_torch.serving.http import ServingHTTPServer
from deeplearning4j_tpu_torch.serving.server import (
    InferenceServer,
    ServingConfig,
)
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

# small shapes: one intra-op thread keeps these files from competing with
# the multi-process tests that share the host under pytest-xdist
torch.set_num_threads(1)

VOCAB, D, HEADS, LAYERS = 41, 64, 2, 2
KW = dict(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS,
          causal=True, seed=21)
GEN_CFG = dict(slots=4, page_size=8, num_pages=64, max_pages_per_seq=4)

PKG = {"jax": (JaxServer, JaxServingConfig, jfaults, jmetrics),
       "port": (InferenceServer, ServingConfig, pfaults, pmetrics)}


def _models():
    jm = JaxTE(**KW).init_model()
    port = SequentialModel(TransformerEncoder(**KW).conf(), device="cpu")
    return jm, params_from_jax(jax.tree.map(np.asarray, jm.params), port)


def _ids(n, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int64)


def _counts(metrics_mod, prefix="dl4jtpu_serving_") -> dict:
    reg = metrics_mod.registry()
    with reg._lock:
        fams = dict(reg._metrics)
    out = {}
    for name, fam in fams.items():
        if not name.startswith(prefix):
            continue
        if isinstance(fam, metrics_mod.Histogram):
            out[(name, ())] = fam.count
        elif isinstance(fam, metrics_mod.Counter):
            with fam._lock:
                out.update({(name, k): v for k, v in fam._series.items()})
    return out


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


STAT_KEYS = ("admitted", "completed", "errors", "timeouts", "shed", "batches",
             "wedged_batches", "swaps_installed", "swaps_rolled_back",
             "generation", "breaker_state")


def _outcome(call):
    try:
        return ("ok", np.asarray(call()))
    except Exception as exc:         # noqa: BLE001 - compared across packages
        return (type(exc).__name__, getattr(exc, "reason", None))


# -- requests ------------------------------------------------------------------


def _requests_run(which, model):
    Server, Config, faults, metrics = PKG[which]
    before = _counts(metrics)
    srv = Server(model, Config(max_batch=4, max_queue=8,
                               default_deadline_s=60.0,
                               breaker_threshold=2,
                               breaker_probe_after_s=600.0))
    feats = [_ids(12, s) for s in range(6)] + [_ids(7, s) for s in (8, 9)]
    pend = [srv.submit(f) for f in feats]
    rej = _outcome(lambda: srv.submit(_ids(12, 99)))     # queue_full
    srv.start()
    try:
        outs = [np.asarray(p.result(timeout=60)) for p in pend]
        faults.arm("serving.admit:raise:nth=1")
        adm = _outcome(lambda: srv.infer(_ids(12, 1)))
        faults.arm("serving.infer:corrupt:nth=1")
        nan = _outcome(lambda: srv.infer(_ids(12, 2)))   # the NaN screen
        faults.arm("serving.infer:raise:nth=1")
        err = _outcome(lambda: srv.infer(_ids(12, 3)))
        faults.disarm()
        shed = _outcome(lambda: srv.infer(_ids(12, 4)))  # breaker open
        health = srv.health()
        st = srv.stats()
    finally:
        faults.disarm()
        srv.stop()
    fates = [rej, adm, nan, err, shed]
    return (outs, [f[0] if f[0] != "ok" else "ok" for f in fates],
            [f[1] for f in fates if f[0] != "ok"],
            {k: st[k] for k in STAT_KEYS}, health["status"],
            _delta(before, _counts(metrics)))


def test_servers_give_the_same_outputs_sheds_and_counters():
    jm, port = _models()
    want = _requests_run("jax", jm)
    got = _requests_run("port", port)
    for o_got, o_want in zip(got[0], want[0]):
        np.testing.assert_allclose(o_got, o_want, rtol=0, atol=1e-5)
    assert got[1:] == want[1:]
    assert got[1] == ["ServingRejected", "ServingRejected", "ServingError",
                      "ServingError", "ServingRejected"]
    assert got[2] == ["queue_full", "admit_fault", None, None, "breaker_open"]
    assert got[4] == "breaker_open"
    ref = port.output(np.stack([_ids(12, s) for s in range(6)])).numpy()
    np.testing.assert_allclose(np.stack(got[0][:6]), ref, rtol=0, atol=1e-5)


def test_warm_start_runs_every_bucket_and_seeds_no_deadline():
    jm, port = _models()
    warmed = []
    for Server, Config, model in ((JaxServer, JaxServingConfig, jm),
                                  (InferenceServer, ServingConfig, port)):
        srv = Server(model, Config(max_batch=8))
        warmed.append(srv.warm_start(_ids(10, 0)))
        assert srv._watchdog.ewma is None
        assert srv.stats()["warmed_programs"] == 4
    assert warmed[1] == warmed[0]


# -- hot-swap ------------------------------------------------------------------


def _perturb_np(tree, f):
    return {k: _perturb_np(v, f) if isinstance(v, dict)
            else (np.asarray(v) * f).astype(np.float32) for k, v in tree.items()}


def _swap_run(which, model):
    Server, Config, faults, metrics = PKG[which]
    before = _counts(metrics)
    srv = Server(model, Config(max_batch=4, default_deadline_s=60.0)).start()
    x = _ids(10, 5)
    host = _perturb_np(jax.tree.map(np.asarray, model.params)
                       if which == "jax" else
                       {k: _np_tree(v) for k, v in model.params.items()}, 1.01)
    tree = host if which == "jax" else _torch_tree(host)
    res, outs = [], []
    try:
        outs.append(np.asarray(srv.infer(x)))
        res.append(srv.push_weights(tree, checksum=weights_checksum(tree)))
        outs.append(np.asarray(srv.infer(x)))
        for plan in ("serving.hotswap:truncate:nth=1",
                     "serving.hotswap:corrupt:nth=1",
                     "serving.hotswap:raise:nth=1"):
            faults.arm(plan)
            res.append(srv.push_weights(tree))
            faults.disarm()
        res.append(srv.push_weights(tree, checksum=123))
        bad = dict(tree)
        bad["layer0"] = dict(tree["layer0"])
        w = bad["layer0"]["W"]
        bad["layer0"]["W"] = w[:-1]
        res.append(srv.push_weights(bad))
        outs.append(np.asarray(srv.infer(x)))
        st = srv.stats()
    finally:
        faults.disarm()
        srv.stop()
    return outs, res, {k: st[k] for k in STAT_KEYS}, _delta(
        before, _counts(metrics))


def _np_tree(v):
    if isinstance(v, dict):
        return {k: _np_tree(x) for k, x in v.items()}
    return v.detach().numpy()


def _torch_tree(v):
    if isinstance(v, dict):
        return {k: _torch_tree(x) for k, x in v.items()}
    return torch.from_numpy(np.array(v))


def test_hot_swap_installs_and_rolls_back_as_the_jax_server_does():
    jm, port = _models()
    want = _swap_run("jax", jm)
    got = _swap_run("port", port)
    for o_got, o_want in zip(got[0], want[0]):
        np.testing.assert_allclose(o_got, o_want, rtol=0, atol=1e-5)
    assert not np.allclose(got[0][0], got[0][1])      # new weights serve
    np.testing.assert_array_equal(got[0][1], got[0][2])  # rollbacks keep them
    assert got[1] == want[1] == [True, False, False, False, False, False]
    assert got[2] == want[2]
    assert got[2]["generation"] == 1 and got[2]["swaps_rolled_back"] == 5
    assert got[3] == want[3]


def test_a_jax_written_zip_installs_through_push_checkpoint(tmp_path):
    jm, port = _models()
    jm2 = JaxTE(**{**KW, "seed": 22}).init_model()
    path = str(tmp_path / "jax.zip")
    JaxMS.write_model(jm2, path)
    srv = InferenceServer(port, ServingConfig(default_deadline_s=60.0)).start()
    fam = pmetrics.registry().counter("dl4jtpu_ckpt_verify_failures_total")
    try:
        x = _ids(9, 3)
        assert srv.push_checkpoint(path)
        ref = np.asarray(jm2.output(x[None]))[0]
        np.testing.assert_allclose(srv.infer(x), ref, rtol=0, atol=1e-5)
        with open(path, "rb") as f:
            raw = bytearray(f.read())
        raw[len(raw) // 2] ^= 0xFF
        bad = str(tmp_path / "bad.zip")
        with open(bad, "wb") as f:
            f.write(bytes(raw))
        n0 = fam.value(reason="corrupt")
        assert not srv.push_checkpoint(bad)
        assert fam.value(reason="corrupt") == n0 + 1
        assert not srv.push_checkpoint(str(tmp_path / "missing.zip"))
        np.testing.assert_allclose(srv.infer(x), ref, rtol=0, atol=1e-5)
        assert srv.generation == 1
    finally:
        srv.stop()


def test_a_hot_swap_between_decode_steps_drops_no_stream():
    _, port = _models()
    srv = InferenceServer(port, ServingConfig(default_deadline_s=60.0))
    eng = GenerationEngine(server=srv,
                           config=GenerationConfig(**GEN_CFG)).start()
    try:
        reqs = [eng.submit(_ids(5, 60 + i), 20) for i in range(3)]
        for r in reqs:                          # every stream is decoding
            while not r.tokens_so_far():
                threading.Event().wait(0.005)
        new = {k: _torch_tree(_perturb_np(_np_tree(v), 1.001))
               for k, v in port.params.items()}
        assert srv.push_weights(new, source="test")
        for r in reqs:
            assert np.asarray(r.result(timeout=120)).shape == (25,)
            assert r.error is None and r.outcome == "ok"
        assert srv.generation == 1
        assert eng.kv.leak_check() is None and eng.kv.used_pages == 0
    finally:
        eng.stop()
        srv.stop()


def test_the_engine_feeds_the_breaker_and_shed_pressure():
    _, port = _models()
    srv = InferenceServer(port, ServingConfig(breaker_threshold=1,
                                              breaker_probe_after_s=600.0))
    eng = GenerationEngine(server=srv, config=GenerationConfig(**GEN_CFG))
    assert srv.generation_engine is eng and eng.breaker is srv.breaker
    base = srv.shed_pressure()
    eng.kv.alloc("x", 60)
    assert srv.shed_pressure() >= eng.kv.occupancy() > base
    eng.kv.release("x")
    eng.start()
    try:
        pfaults.arm("serving.decode:raise:nth=1")
        with pytest.raises(ServingError, match="decode step failed"):
            eng.generate(_ids(5, 1), 6, timeout=60)
        pfaults.disarm()
        assert srv.breaker.state == "open"
        for _ in range(500):      # the breaker_open dump follows the failure
            if eng.flight.dumps_written:
                break
            threading.Event().wait(0.01)
        assert eng.flight.dumps_written == 1
        with pytest.raises(ServingRejected) as ei:
            eng.submit(_ids(5, 2), 4)
        assert ei.value.reason == "breaker_open"
        assert srv.health()["generation"]["stream_outcomes"] == {
            "error": 1, "breaker_open": 1}
    finally:
        pfaults.disarm()
        eng.stop()
        srv.stop()


# -- the server's limits ---------------------------------------------------------


def test_padding_masks_are_served_only_where_they_cannot_reach_a_real_row():
    """A batch's mask column reaches ``output(x, mask)``: trailing padding,
    a mask with a hole and a non-causal model are all served, each row
    what ``output()`` gives under the same mask (the JAX server's masked
    infer program).  A model with a mesh still raises (A11)."""
    _, port = _models()
    srv = InferenceServer(port)
    x = np.stack([_ids(8, 1), _ids(8, 2)])
    params = port.compute_params()
    suffix = np.array([[1] * 8, [1] * 5 + [0] * 3], np.float32)
    hole = np.array([[1] * 8, [1, 0] + [1] * 6], np.float32)
    nc = SequentialModel(TransformerEncoder(**{**KW, "causal": False}).conf(),
                         device="cpu").init()
    for model, mask in ((port, suffix), (port, hole), (nc, suffix), (nc, hole)):
        out = InferenceServer(model)._call_model([x], mask, model.compute_params(),
                                                 None)[0]
        np.testing.assert_array_equal(out.numpy(), model.output(x, mask).numpy())
    # a causal stack's rows before the padding do not see it (the masked
    # call attends densely, the unmasked one through flash: 1e-6)
    np.testing.assert_allclose(
        srv._call_model([x], suffix, params, None)[0].numpy()[1, :5],
        port.output(x).numpy()[1, :5], rtol=0, atol=1e-6)
    # the hole changes the rows after it, the non-causal mask every row
    assert not np.array_equal(srv._call_model([x], hole, params, None)[0].numpy()[1],
                              port.output(x).numpy()[1])
    port._mesh = object()
    try:
        with pytest.raises(NotImplementedError, match="A11"):
            srv._call_model([x], None, params, None)
    finally:
        del port._mesh


def test_a_bad_mask_is_refused_at_admit_and_fails_no_other_request():
    """A mask shorter or longer than its features, 2-D or holding a NaN is
    refused before it is queued (ValueError; 400 over HTTP), so it never
    reaches a batch: the requests queued beside it are served as
    ``output(x, mask)`` gives them, in one batch, and the breaker (one
    failure trips it here) records nothing."""
    _, port = _models()
    srv = InferenceServer(port, ServingConfig(max_batch=4, default_deadline_s=60.0,
                                              breaker_threshold=1))
    x = np.stack([_ids(8, 1), _ids(8, 2)])
    mask = np.array([[1] * 8, [1, 0] + [1] * 6], np.float32)
    good = [srv.submit(x[0], features_mask=mask[0])]
    for bad in ([1.0] * 7, [1.0] * 9, [[1.0] * 8], [1.0] * 7 + [float("nan")]):
        with pytest.raises(ValueError, match="features_mask"):
            srv.submit(x[1], features_mask=bad)
    good.append(srv.submit(x[1], features_mask=mask[1]))
    srv.start()
    http = ServingHTTPServer(srv, port=0, host="127.0.0.1").start()
    try:
        rows = np.stack([np.asarray(r.result(timeout=60)) for r in good])
        req = urllib.request.Request(
            http.url + "v1/infer", headers={"Content-Type": "application/json"},
            data=json.dumps({"features": x[0].tolist(),
                             "features_mask": [1.0] * 7}).encode())
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=60)
        assert err.value.code == 400
        err.value.close()
        stats = srv.stats()
    finally:
        http.stop()
        srv.stop()
    np.testing.assert_allclose(rows, port.output(x, mask).numpy(), rtol=0, atol=1e-6)
    assert (stats["admitted"], stats["batches"], stats["errors"]) == (2, 1, 0)
    assert srv.breaker.state == "closed"


# -- HTTP ------------------------------------------------------------------------


def _call(url, path, payload=None, raw=None):
    data = raw if raw is not None else (
        json.dumps(payload).encode() if payload is not None else None)
    req = urllib.request.Request(url + path.lstrip("/"), data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _reason(body):
    try:
        return json.loads(body).get("reason")
    except ValueError:
        return None


def _http_table(which, model, tmp_path):
    if which == "jax":
        Server, Config, Engine, GCfg, HTTP, faults = (
            JaxServer, JaxServingConfig, JaxGenerationEngine,
            JaxGenerationConfig, JaxHTTP, jfaults)
    else:
        Server, Config, Engine, GCfg, HTTP, faults = (
            InferenceServer, ServingConfig, GenerationEngine,
            GenerationConfig, ServingHTTPServer, pfaults)
    srv = Server(model, Config(max_queue=1, default_deadline_s=60.0,
                               breaker_threshold=1,
                               breaker_probe_after_s=600.0))
    eng = Engine(server=srv, config=GCfg(**GEN_CFG)).start()
    http = HTTP(srv).start()
    url = http.url
    rows = []

    def row(name, code, body):
        rows.append((name, code, _reason(body)))
        return body

    try:
        row("get_404", *_call(url, "/nope"))
        row("post_404", *_call(url, "/nope", {}))
        row("bad_json", *_call(url, "/v1/infer", raw=b"{nope"))
        row("bad_arity", *_call(url, "/v1/infer",
                                {"inputs": [[1, 2], [3, 4]]}))
        row("bad_prompt", *_call(url, "/v1/generate", {"prompt": [VOCAB + 5]}))
        row("reload_no_path", *_call(url, "/v1/reload", {}))
        row("reload_corrupt", *_call(url, "/v1/reload",
                                     {"path": str(tmp_path / "none.zip")}))
        held = srv.submit(_ids(6, 1))          # the batcher is not started
        row("queue_full", *_call(url, "/v1/infer",
                                 {"features": _ids(6, 2).tolist()}))
        srv.start()
        held.result(timeout=60)
        body = row("infer", *_call(url, "/v1/infer",
                                   {"features": _ids(6, 3).tolist()}))
        infer_out = np.asarray(json.loads(body)["outputs"])
        body = row("generate", *_call(url, "/v1/generate",
                                      {"prompt": [1, 2, 3],
                                       "max_new_tokens": 5}))
        toks = json.loads(body)["tokens"]
        body = row("stream", *_call(url, "/v1/generate",
                                    {"prompt": [1, 2, 3], "max_new_tokens": 5,
                                     "stream": True}))
        lines = [json.loads(l) for l in body.decode().splitlines()]
        streamed = [l["token"] for l in lines if "token" in l]
        done = lines[-1]
        faults.arm("kv.alloc:raise:every=1")
        row("kv_exhausted", *_call(url, "/v1/generate",
                                   {"prompt": [1, 2, 3], "max_new_tokens": 5}))
        faults.disarm()
        row("healthz", *_call(url, "/healthz"))
        code, body = _call(url, "/v1/status")
        row("status", code, body)
        status_keys = sorted(json.loads(body)["generation"])
        srv.breaker.record_failure()
        row("infer_breaker", *_call(url, "/v1/infer",
                                    {"features": _ids(6, 4).tolist()}))
        row("generate_breaker", *_call(url, "/v1/generate",
                                       {"prompt": [1, 2], "max_new_tokens": 3}))
        row("healthz_breaker", *_call(url, "/healthz"))
    finally:
        faults.disarm()
        http.stop()
        eng.stop()
        srv.stop()
    return rows, infer_out, toks, streamed, done, status_keys


def test_http_status_table_matches_the_jax_front(tmp_path):
    jm, port = _models()
    want = _http_table("jax", jm, tmp_path)
    got = _http_table("port", port, tmp_path)
    assert got[0] == want[0]
    codes = dict((n, c) for n, c, _ in got[0])
    assert codes == {
        "get_404": 404, "post_404": 404, "bad_json": 400, "bad_arity": 400,
        "bad_prompt": 400, "reload_no_path": 400, "reload_corrupt": 409,
        "queue_full": 429, "infer": 200, "generate": 200, "stream": 200,
        "kv_exhausted": 429, "healthz": 200, "status": 200,
        "infer_breaker": 503, "generate_breaker": 503, "healthz_breaker": 503}
    reasons = dict((n, r) for n, _, r in got[0])
    assert reasons["queue_full"] == "queue_full"
    assert reasons["kv_exhausted"] == "kv_exhausted"
    assert reasons["infer_breaker"] == reasons["generate_breaker"] == "breaker_open"
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    assert got[2] == want[2]
    assert [1, 2, 3] + got[3] == got[2]           # streamed = non-streamed
    assert got[4]["done"] and got[4]["n_tokens"] == 5 and got[4]["error"] is None
    assert set(want[5]) <= set(got[5])
