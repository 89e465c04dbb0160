"""The port's `ServingFleet` and `FleetDeployer` against the JAX
package's, on the CPU: causal transformers of 2 layers, d_model 32, f32,
every replica built by the port's own init from the JAX model's seed
(the JAX package's weights, bit for bit).

- Disaggregated generation (prefill on r0, decode on r1) gives the JAX
  package's `ops.generation.generate` greedy tokens; ``fleet.infer``
  gives the JAX model's ``output()`` within 1e-5, and the JAX fleet's
  rows within the same.  Roles are validated as the JAX fleet validates
  them.
- Routing, ejection, retries and the hedge, as
  `tests/test_fleet_serving.py` specifies them, on the port's fleet;
  probation runs on an injected clock and the hedge's slow replica
  blocks on an event, so nothing races the wall clock.
- Rolling deploys: the happy path, a canary mismatch, a torn push mid
  deploy and a torn checkpoint give the JAX deployer's results (installed,
  replicas updated, rolled back, reason) and counters, and every replica
  ends on the same weights as the JAX fleet's.  Kill, revive and sync:
  a revived replica serves the deployed weights, and (ROADMAP C14, where
  the port differs on purpose) a revived decode replica decodes again.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.observe import metrics as jmetrics
from deeplearning4j_tpu.ops.generation import generate as jax_generate
from deeplearning4j_tpu.runtime import faults as jfaults
from deeplearning4j_tpu.serving import fleet as jfleet_mod
from deeplearning4j_tpu.serving import router as jrouter
from deeplearning4j_tpu.serving.generation import (
    GenerationConfig as JaxGenerationConfig,
)
from deeplearning4j_tpu.serving.server import ServingConfig as JaxServingConfig
from deeplearning4j_tpu.train.checkpoint import ModelSerializer as JaxMS
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.observe import metrics as pmetrics
from deeplearning4j_tpu_torch.runtime import faults as pfaults
from deeplearning4j_tpu_torch.serving import fleet as pfleet_mod
from deeplearning4j_tpu_torch.serving import router as prouter
from deeplearning4j_tpu_torch.serving.admission import (
    ServingError,
    ServingRejected,
)
from deeplearning4j_tpu_torch.serving.generation import GenerationConfig
from deeplearning4j_tpu_torch.serving.server import ServingConfig
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

# small shapes: one intra-op thread keeps these files from competing with
# the multi-process tests that share the host under pytest-xdist
torch.set_num_threads(1)

VOCAB, D, HEADS, LAYERS, SEQ = 41, 32, 2, 2, 12
KW = dict(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS,
          causal=True, seed=5)
GEN = dict(slots=4, page_size=8, num_pages=64, max_pages_per_seq=4)


@pytest.fixture(autouse=True)
def _disarm(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path / "crash"))
    yield
    jfaults.disarm()
    pfaults.disarm()


def _port_model():
    return SequentialModel(TransformerEncoder(**KW).conf(), device="cpu").init()


def _fleet(which, n=2, router=None, goldens=None, roles=None, gen=False,
           **server_kw):
    server_kw.setdefault("max_batch", 4)
    server_kw.setdefault("linger_s", 0.001)
    server_kw.setdefault("default_deadline_s", 60.0)
    if which == "jax":
        return jfleet_mod.ServingFleet(
            lambda: JaxTE(**KW).init_model(), n_replicas=n,
            config=JaxServingConfig(**server_kw),
            router_config=jrouter.RouterConfig(**(router or {})),
            golden_inputs=goldens, roles=roles,
            generation_config=JaxGenerationConfig(**GEN) if gen else None)
    return pfleet_mod.ServingFleet(
        _port_model, n_replicas=n, config=ServingConfig(**server_kw),
        router_config=prouter.RouterConfig(**(router or {})),
        golden_inputs=goldens, roles=roles,
        generation_config=GenerationConfig(**GEN) if gen else None)


def _ids(seed, n=SEQ):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int64)


def _shift(which, params, d):
    """The tree with ``d`` added to every leaf, in the package's types."""
    if which == "jax":
        return jax.tree.map(lambda a: a + d, params)

    def walk(t):
        return ({k: walk(v) for k, v in t.items()} if isinstance(t, dict)
                else t.detach() + d)
    return walk(params)


def _fail_call_model(msg="injected replica failure"):
    def broken(cols, fmask_col, params, net_state):
        raise RuntimeError(msg)
    return broken


class Clock:
    """The routers' monotonic clock, advanced by the test."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    perf_counter = staticmethod(time.perf_counter)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(prouter, "time", c)
    return c


# -- generation and inference against the JAX package ------------------------


def test_disaggregated_generate_gives_jax_generate_tokens():
    jm = JaxTE(**KW).init_model()
    fleet = _fleet("port", roles=["prefill", "decode"], gen=True).start()
    try:
        assert [h.role for h in fleet.handles] == ["prefill", "decode"]
        assert fleet.engines["r0"]._thread is None      # no decode loop
        prompts = [_ids(s, n).astype(np.int32) for s, n in ((1, 5), (2, 11), (3, 17))]
        outs = [None] * len(prompts)

        def one(i):
            outs[i] = np.asarray(fleet.generate(prompts[i], 9, timeout=120))

        ts = [threading.Thread(target=one, args=(i,)) for i in range(len(prompts))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        assert not any(t.is_alive() for t in ts)
        for p, out in zip(prompts, outs):
            ref = np.asarray(jax_generate(jm, p[None], 9))[0]
            np.testing.assert_array_equal(out, ref)
        st = fleet.engines["r1"].stats()
        assert st["prefills"] == 0 and st["streams"]["settled"] == 3
        assert fleet.engines["r0"]._thread is None
        assert fleet.engines["r0"].kv.used_pages == 0
        assert fleet.engines["r1"].kv.leak_check() is None
    finally:
        fleet.stop()


def test_fleet_infer_matches_jax_output_and_the_jax_fleet():
    jm = JaxTE(**KW).init_model()
    fleets = {w: _fleet(w, n=3).start() for w in ("jax", "port")}
    try:
        for seed in range(4):
            x = _ids(seed)
            want = np.asarray(jm.output(x[None]))[0]
            got = {w: np.asarray(f.infer(x, deadline_s=60.0))
                   for w, f in fleets.items()}
            np.testing.assert_allclose(got["port"], want, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got["port"], got["jax"], rtol=1e-5, atol=1e-5)
        st = {w: f.router.stats() for w, f in fleets.items()}
        for w in fleets:
            assert st[w]["ok"] == 4 and st[w]["retries"] == 0
        served = [s.stats()["completed"] for s in fleets["port"].replicas]
        assert sum(served) == 4 and max(served) < 4
    finally:
        for f in fleets.values():
            f.stop()


@pytest.mark.parametrize("which", ["jax", "port"])
def test_roles_are_validated(which):
    mod = jfleet_mod if which == "jax" else pfleet_mod
    with pytest.raises(ValueError, match="roles"):
        mod.ServingFleet(lambda: None, n_replicas=2, roles=["both"])
    with pytest.raises(ValueError, match="at least one"):
        mod.ServingFleet(lambda: None, n_replicas=0)
    with pytest.raises(ValueError, match="role"):
        _fleet(which, roles=["prefill", "oracle"])


def test_generate_needs_generation_enabled():
    fleet = _fleet("port", n=1)
    with pytest.raises(RuntimeError, match="generation is not enabled"):
        fleet.generate(_ids(0, 4), 3)


# -- routing, ejection, retries, the hedge ------------------------------------


def test_loaded_replica_is_avoided_before_it_sheds():
    fleet = _fleet("port").start()
    try:
        loaded = fleet.replicas[0]
        with loaded._stats_lock:
            loaded._batch_ewma = 100.0          # "my batches take 100 s"
        assert loaded.shed_pressure() == 1.0
        for seed in range(5):
            fleet.infer(_ids(seed), deadline_s=60.0)
        assert loaded.stats()["completed"] == 0
        assert fleet.replicas[1].stats()["completed"] == 5
        st = fleet.router.stats()
        assert st["retries"] == 0 and st["failed"] == 0
    finally:
        fleet.stop()


def test_route_fault_site_rejects_explicitly():
    fleet = _fleet("port").start()
    try:
        pfaults.arm("serving.route:raise:nth=1")
        with pytest.raises(ServingRejected) as ei:
            fleet.infer(_ids(0), deadline_s=60.0)
        assert ei.value.reason == "route_fault"
        pfaults.disarm()
        assert np.isfinite(fleet.infer(_ids(1), deadline_s=60.0)).all()
    finally:
        fleet.stop()


def test_consecutive_failures_eject_then_one_probe_readmits(clock, monkeypatch):
    fleet = _fleet("port", router=dict(eject_threshold=2, probation_s=1.0,
                                       retry_budget=1)).start()
    try:
        bad = fleet.replicas[0]
        original = bad._call_model
        monkeypatch.setattr(bad, "_call_model", _fail_call_model())
        for seed in range(8):
            assert np.isfinite(fleet.infer(_ids(seed), deadline_s=60.0)).all()
        states = fleet.router.replica_states()
        assert states["r0"]["state"] == "probation"
        assert states["r0"]["ejections"] == 1
        assert fleet.router.stats()["retries"] >= 2
        errors = bad.stats()["errors"]
        for seed in range(3):
            fleet.infer(_ids(20 + seed), deadline_s=60.0)
        assert bad.stats()["errors"] == errors          # ejected: nothing routed
        monkeypatch.setattr(bad, "_call_model", original)
        clock.now += 1.5
        for seed in range(3):
            fleet.infer(_ids(40 + seed), deadline_s=60.0)
        assert fleet.router.replica_states()["r0"]["state"] == "active"
        assert fleet.router.stats()["readmissions"] == 1
    finally:
        fleet.stop()


def test_dead_replica_ejected_once_and_counted():
    reg = pmetrics.registry()
    dead0 = reg.counter("dl4jtpu_replica_ejections_total").value(reason="dead")
    fleet = _fleet("port", router=dict(probation_s=30.0, retry_budget=1)).start()
    try:
        fleet.kill_replica(0)
        for seed in range(4):
            assert np.isfinite(fleet.infer(_ids(seed), deadline_s=60.0)).all()
        assert fleet.router.replica_states()["r0"]["state"] == "probation"
        assert reg.counter("dl4jtpu_replica_ejections_total").value(
            reason="dead") == dead0 + 1
        assert fleet.health()["status"] == "serving"
        fleet.kill_replica(1)
        with pytest.raises(ServingRejected) as ei:
            fleet.infer(_ids(9), deadline_s=5.0)
        assert ei.value.reason in ("no_replicas", "replica_dead")
        assert fleet.health()["status"] == "unavailable"
    finally:
        fleet.stop()


def test_budget_exhaustion_surfaces_the_original_error(monkeypatch):
    fleet = _fleet("port", n=1, router=dict(eject_threshold=100,
                                            retry_budget=2)).start()
    try:
        calls = []

        def broken(cols, fmask_col, params, net_state):
            calls.append(1)
            raise RuntimeError(f"boom-{len(calls)}")

        monkeypatch.setattr(fleet.replicas[0], "_call_model", broken)
        with pytest.raises(ServingError) as ei:
            fleet.infer(_ids(0), deadline_s=60.0)
        assert len(calls) == 3 and "boom-1" in str(ei.value)
        st = fleet.router.stats()
        assert st["retries"] == 2 and st["failed"] == 1
    finally:
        fleet.stop()


def test_hedge_answers_from_the_fast_replica(monkeypatch):
    reg = pmetrics.registry()
    hedges0 = reg.counter("dl4jtpu_router_hedges_total").value()
    fleet = _fleet("port", router=dict(hedge_after_s=0.02, retry_budget=0,
                                       eject_threshold=100)).start()
    release = threading.Event()
    try:
        slow, fast = fleet.replicas
        slow_orig = slow._call_model

        def held(cols, fmask_col, params, net_state):
            release.wait(60)
            return slow_orig(cols, fmask_col, params, net_state)

        monkeypatch.setattr(slow, "_call_model", held)
        with fast._stats_lock:
            fast._batch_ewma = 0.01        # the pick goes to the held replica
        x = _ids(3)
        out = fleet.infer(x, deadline_s=30.0)
        want = np.asarray(JaxTE(**KW).init_model().output(x[None]))[0]
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
        st = fleet.router.stats()
        assert st["hedges"] == 1 and st["ok"] == 1
        assert reg.counter("dl4jtpu_router_hedges_total").value() == hedges0 + 1
        assert fleet.router.replica_states()["r0"]["fails"] == 0
    finally:
        release.set()
        fleet.stop()


# -- rolling deploys against the JAX deployer ----------------------------------


def _deploy_run(which, scenario):
    """One deploy scenario on a 3-replica fleet with one golden input:
    the deploy's result, the canary failure delta, the replicas'
    generations and their outputs on a probe row afterwards."""
    metrics, faults = ((jmetrics, jfaults) if which == "jax"
                       else (pmetrics, pfaults))
    canary = metrics.registry().counter("dl4jtpu_canary_failures_total")
    c0 = canary.value()
    fleet = _fleet(which, n=3, goldens=[_ids(100)]).start()
    try:
        params = fleet.replicas[0].model.params
        x = _ids(7)
        before = [np.asarray(s.infer(x, deadline_s=60.0)) for s in fleet.replicas]
        if scenario == "happy":
            res = fleet.deployer.deploy(_shift(which, params, 0.25), source="t")
        elif scenario == "canary":
            faults.arm("serving.canary:corrupt:nth=1")
            res = fleet.deployer.deploy(_shift(which, params, 0.25))
        else:                               # the second replica's push torn
            faults.arm("serving.hotswap:truncate:nth=2")
            res = fleet.deployer.deploy(_shift(which, params, 0.5))
        faults.disarm()
        after = [np.asarray(s.infer(x, deadline_s=60.0)) for s in fleet.replicas]
        return (res, canary.value() - c0, [s.generation for s in fleet.replicas],
                before, after, fleet.deployer.generation)
    finally:
        fleet.stop()


@pytest.mark.parametrize("scenario", ["happy", "canary", "torn"])
def test_rolling_deploy_gives_the_jax_deployers_result(scenario):
    got = {w: _deploy_run(w, scenario) for w in ("jax", "port")}
    (jres, jcan, jgens, jbefore, jafter, jgen) = got["jax"]
    (pres, pcan, pgens, pbefore, pafter, pgen) = got["port"]
    assert pres == jres and pcan == jcan and pgen == jgen
    np.testing.assert_allclose(np.stack(pafter), np.stack(jafter),
                               rtol=1e-5, atol=1e-5)
    if scenario == "happy":
        assert pres["installed"] and pres["replicas_updated"] == 3
        assert pgens == jgens == [1, 1, 1] and pgen == 1
        assert not np.allclose(pafter[0], pbefore[0])
        assert pmetrics.registry().gauge(
            "dl4jtpu_fleet_deploy_generation").value() == 1
    else:
        assert not pres["installed"] and pres["rolled_back"] == 1
        assert ("canary:r0" if scenario == "canary"
                else "hotswap_rejected:r1") in pres["reason"]
        assert pcan == (1 if scenario == "canary" else 0)
        for b, a in zip(pbefore, pafter):      # back on the old weights, bit for bit
            np.testing.assert_array_equal(a, b)
        if scenario == "canary":
            assert pgens == jgens == [2, 0, 0]    # swapped and rolled back; never touched


def test_deploy_checkpoint_verifies_before_touching_replicas(tmp_path):
    trainer = JaxTE(**{**KW, "seed": 99}).init_model()
    path = str(tmp_path / "new.zip")
    JaxMS.write_model(trainer, path)
    torn = str(tmp_path / "torn.zip")
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    raw[len(raw) // 2] ^= 0xFF
    with open(torn, "wb") as f:
        f.write(bytes(raw))
    fleet = _fleet("port", n=2, goldens=[_ids(100)]).start()
    try:
        res = fleet.deployer.deploy_checkpoint(torn)
        assert not res["installed"] and res["reason"].startswith("checkpoint")
        assert [s.generation for s in fleet.replicas] == [0, 0]
        assert fleet.push_checkpoint(path)
        x = _ids(5)
        want = np.asarray(trainer.output(x[None]))[0]
        for s in fleet.replicas:
            np.testing.assert_allclose(s.infer(x, deadline_s=60.0), want,
                                       rtol=1e-5, atol=1e-5)
    finally:
        fleet.stop()


def test_concurrent_deploys_are_serialized():
    fleet = _fleet("port", n=3, goldens=[_ids(100)]).start()
    try:
        params = fleet.replicas[0].model.params
        results = []
        ts = [threading.Thread(target=lambda d=d: results.append(
            fleet.deployer.deploy(_shift("port", params, d)))) for d in (0.1, 0.2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert len(results) == 2 and all(r["installed"] for r in results)
        assert fleet.deployer.generation == 2
        x = _ids(5)
        outs = [s.infer(x, deadline_s=60.0) for s in fleet.replicas]
        for o in outs[1:]:
            np.testing.assert_array_equal(o, outs[0])
    finally:
        fleet.stop()


# -- kill, revive, sync ---------------------------------------------------------


def test_revive_resyncs_onto_the_deployed_weights(clock):
    fleet = _fleet("port", goldens=[_ids(100)],
                   router=dict(probation_s=0.5, retry_budget=1)).start()
    try:
        params = fleet.replicas[0].model.params
        fleet.kill_replica(0)
        fleet.infer(_ids(1), deadline_s=60.0)          # the router ejects r0
        assert fleet.router.replica_states()["r0"]["state"] == "probation"
        new = _shift("port", params, 0.25)
        res = fleet.deployer.deploy(new)
        assert res["installed"] and res["replicas_updated"] == 1
        assert fleet.revive_replica(0)
        x = _ids(7)
        ref = _port_model().load_params(new)
        want = ref.output(x[None])[0].numpy()
        np.testing.assert_allclose(fleet.replicas[0].infer(x, deadline_s=60.0),
                                   want, rtol=1e-6, atol=1e-6)
        clock.now += 1.0
        for _ in range(4):
            np.testing.assert_allclose(fleet.infer(x, deadline_s=60.0), want,
                                       rtol=1e-6, atol=1e-6)
        assert fleet.router.replica_states()["r0"]["state"] == "active"
        assert fleet.router.stats()["readmissions"] == 1
    finally:
        fleet.stop()


def test_a_revived_decode_replica_decodes_again():
    """ROADMAP C14: `kill_replica` stops the engine's decode loop; the
    port's `revive_replica` starts it again (the JAX fleet restarts only
    the server, so its revived decode replica never decodes)."""
    jm = JaxTE(**KW).init_model()
    fleet = _fleet("port", roles=["prefill", "decode"], gen=True).start()
    try:
        p = _ids(4, 6).astype(np.int32)
        ref = np.asarray(jax_generate(jm, p[None], 5))[0]
        np.testing.assert_array_equal(fleet.generate(p, 5, timeout=60), ref)
        fleet.kill_replica(1)
        with pytest.raises(ServingRejected) as ei:
            fleet.generate(p, 5, timeout=60)
        assert ei.value.reason == "no_replicas"
        assert fleet.revive_replica(1)
        assert fleet.engines["r1"]._thread is not None
        assert fleet.engines["r0"]._thread is None
        np.testing.assert_array_equal(fleet.generate(p, 5, timeout=60), ref)
    finally:
        fleet.stop()
