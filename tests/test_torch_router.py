"""The port's `serving/router.py` against the JAX package's, on the CPU.

Both routers drive the same stub replicas: each stub answers health
with a pressure the test sets and ``submit`` with a request that is
already settled (served, or failed with its package's `ServingError`),
rejected, or left pending.  Probation runs on an injected clock (the
router modules' ``time.monotonic``), so nothing here races the wall
clock.  Both give the same pick sequence, the same ejection / probation
transitions and reasons, the same retry-budget outcome (the ORIGINAL
error surfaces), the same ``route_fault``, the same hedge, the same
role picks, and the same counter names and labels; the pressure
collector drops the series of a router nobody holds.
"""

import gc
import time

import numpy as np
import pytest

from deeplearning4j_tpu.observe import metrics as jmetrics
from deeplearning4j_tpu.observe import trace as jtrace
from deeplearning4j_tpu.runtime import faults as jfaults
from deeplearning4j_tpu.serving import admission as jadm
from deeplearning4j_tpu.serving import router as jrouter
from deeplearning4j_tpu_torch.observe import metrics as pmetrics
from deeplearning4j_tpu_torch.observe import trace as ptrace
from deeplearning4j_tpu_torch.runtime import faults as pfaults
from deeplearning4j_tpu_torch.serving import admission as padm
from deeplearning4j_tpu_torch.serving import router as prouter

PKG = {"jax": (jrouter, jadm, jfaults, jmetrics, jtrace),
       "port": (prouter, padm, pfaults, pmetrics, ptrace)}


@pytest.fixture(autouse=True)
def _disarm():
    yield
    jfaults.disarm()
    pfaults.disarm()


class Clock:
    """The routers' monotonic clock, advanced by the test."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    perf_counter = staticmethod(time.perf_counter)
    sleep = staticmethod(time.sleep)
    time = staticmethod(time.time)


@pytest.fixture
def clock(monkeypatch):
    c = Clock()
    monkeypatch.setattr(jrouter, "time", c)
    monkeypatch.setattr(prouter, "time", c)
    return c


class Stub:
    """A replica with the server's health/submit contract.  ``mode``:
    ``ok`` (served at once), ``error`` (fails with ServingError
    ``boom-<n>``), ``reject:<reason>`` (ServingRejected at submit),
    ``hang`` (never completes)."""

    def __init__(self, adm, name, pressure=0.0, mode="ok"):
        self.adm, self.name, self.pressure, self.mode = adm, name, pressure, mode
        self.calls = 0
        self.reqs = []

    def health(self):
        return {"status": "serving", "shed_pressure": self.pressure,
                "breaker_state": "closed"}

    def submit(self, features, deadline_s=None, trace_ctx=None):
        self.calls += 1
        if self.mode.startswith("reject:"):
            raise self.adm.ServingRejected(self.mode.split(":", 1)[1], "stub")
        req = self.adm.PendingRequest((np.asarray(features),), ("s",),
                                      time.monotonic() + deadline_s)
        self.reqs.append(req)
        if self.mode == "ok":
            req.complete((self.name, int(np.asarray(features).sum())))
        elif self.mode == "error":
            req.fail(self.adm.ServingError(f"boom-{self.calls}"))
        return req


def _router(which, specs, **cfg):
    """Router over ``specs`` [(name, pressure, mode, role)] stubs."""
    mod, adm = PKG[which][:2]
    stubs = [Stub(adm, n, p, m) for n, p, m, _ in specs]
    handles = [mod.ReplicaHandle(n, s, refresh_s=0.0, role=r)
               for s, (n, _, _, r) in zip(stubs, specs)]
    return mod.Router(handles, mod.RouterConfig(**cfg)), stubs


def _outcome(call):
    try:
        return ("ok", call())
    except Exception as exc:          # noqa: BLE001 - compared across packages
        return (type(exc).__name__, getattr(exc, "reason", None), str(exc))


def _stats(router):
    st = router.stats()
    st.pop("name")
    return st


def _both(scenario):
    out = {w: scenario(w) for w in PKG}
    assert out["jax"] == out["port"], out
    return out["port"]


def test_pick_sequence_follows_pressure_and_rotates_ties(clock):
    def run(which):
        router, stubs = _router(which, [("r0", 0.3, "ok", "both"),
                                        ("r1", 0.1, "ok", "both"),
                                        ("r2", 0.1, "ok", "both")])
        seq = [router.infer(np.array([i]))[0] for i in range(6)]
        stubs[1].pressure = stubs[2].pressure = 0.95     # above the ceiling
        seq += [router.infer(np.array([i]))[0] for i in range(3)]
        for s in stubs:
            s.pressure = 0.97                           # all above: least of all
        stubs[2].pressure = 0.96
        seq += [router.infer(np.array([i]))[0] for i in range(2)]
        return seq, _stats(router)

    seq, st = _both(run)
    assert seq[:6] == ["r2", "r1"] * 3 and seq[6:9] == ["r0"] * 3
    assert seq[9:] == ["r2", "r2"]
    assert st["ok"] == 11 and st["retries"] == 0


def test_ejection_probation_and_one_probe_readmission(clock):
    def run(which):
        metrics = PKG[which][3]
        ej = metrics.registry().counter("dl4jtpu_replica_ejections_total")
        before = ej.value(reason="consecutive_failures")
        router, stubs = _router(which, [("r0", 0.0, "error", "both"),
                                        ("r1", 0.1, "ok", "both")],
                                eject_threshold=2, probation_s=1.0,
                                retry_budget=1)
        log = []
        for i in range(4):
            out = router.infer(np.array([i]))
            log.append((out[0], router.replica_states()["r0"]["state"]))
        r0_calls = stubs[0].calls
        log.append(router.infer(np.array([9]))[0])          # r0 ejected: r1
        assert stubs[0].calls == r0_calls
        clock.now += 1.5                                    # probe window open
        log.append(router.infer(np.array([10]))[0])         # probe fails -> r1
        log.append(router.replica_states()["r0"])
        clock.now += 0.5                                    # timer restarted
        log.append(router.infer(np.array([11]))[0])
        stubs[0].mode = "ok"                                # healed
        clock.now += 1.0
        log.append(router.infer(np.array([12]))[0])         # the one probe
        log.append(router.replica_states()["r0"])
        return log, _stats(router), ej.value(reason="consecutive_failures") - before

    log, st, ejected = _both(run)
    assert log[-1] == {"state": "active", "fails": 0, "ejections": 1}
    assert log[-2] == "r0" and ejected == 1
    assert st["readmissions"] == 1 and st["ejections"] == 1


def test_retry_budget_surfaces_the_original_error(clock):
    def run(which):
        router, stubs = _router(which, [("r0", 0.0, "error", "both")],
                                eject_threshold=100, retry_budget=2)
        out = _outcome(lambda: router.infer(np.array([1])))
        return out[0], out[2], stubs[0].calls, _stats(router)

    name, msg, calls, st = _both(run)
    assert name == "ServingError" and "boom-1" in msg and calls == 3
    assert st["retries"] == 2 and st["failed"] == 1


def test_rejections_retry_elsewhere_and_no_replicas_is_explicit(clock):
    def run(which):
        router, stubs = _router(which, [("r0", 0.0, "reject:queue_full", "both"),
                                        ("r1", 0.1, "ok", "both")])
        first = router.infer(np.array([1]))[0]
        router.replicas[0].kill()
        router.replicas[1].kill()
        dead = _outcome(lambda: router.infer(np.array([2])))
        return first, dead[:2], _stats(router)

    first, dead, st = _both(run)
    assert first == "r1" and dead == ("ServingRejected", "no_replicas")
    assert st["retries"] == 1 and st["ejections"] == 2


def test_route_fault_rejects_explicitly(clock):
    def run(which):
        faults = PKG[which][2]
        router, _ = _router(which, [("r0", 0.0, "ok", "both")])
        faults.arm("serving.route:raise:nth=1")
        try:
            bad = _outcome(lambda: router.infer(np.array([1])))
        finally:
            faults.disarm()
        return bad[:2], router.infer(np.array([2]))[0], _stats(router)

    bad, ok, st = _both(run)
    assert bad == ("ServingRejected", "route_fault") and ok == "r0"
    assert st["requests"] == 1


def test_hedge_discards_the_slower_duplicate():
    def run(which):
        metrics = PKG[which][3]
        hedges = metrics.registry().counter("dl4jtpu_router_hedges_total")
        before = hedges.value()
        router, stubs = _router(which, [("r0", 0.0, "hang", "both"),
                                        ("r1", 0.1, "ok", "both")],
                                hedge_after_s=0.01, retry_budget=0,
                                eject_threshold=100)
        out = router.infer(np.array([3]), deadline_s=30.0)
        return (out, stubs[0].reqs[0].cancelled, _stats(router),
                router.replica_states(), hedges.value() - before)

    out, cancelled, st, states, hedged = _both(run)
    assert out == ("r1", 3) and cancelled and hedged == 1
    assert st["hedges"] == 1 and st["ok"] == 1
    assert states["r0"]["state"] == "active" and states["r0"]["fails"] == 0


def test_a_client_deadline_does_not_eject_the_replica():
    def run(which):
        router, _ = _router(which, [("r0", 0.0, "hang", "both")],
                            eject_threshold=1, retry_budget=1)
        out = _outcome(lambda: router.infer(np.array([1]), deadline_s=0.05))
        return out[0], router.replica_states()["r0"], _stats(router)

    name, state, st = _both(run)
    assert name == "ServingTimeout"
    assert state == {"state": "active", "fails": 0, "ejections": 0}
    assert st["failed"] == 1 and st["ejections"] == 0


def test_pick_for_role_steers_by_role_and_pressure(clock):
    def run(which):
        mod = PKG[which][0]
        router, stubs = _router(which, [("p0", 0.2, "ok", "prefill"),
                                        ("d0", 0.5, "ok", "decode"),
                                        ("b0", 0.3, "ok", "both")])
        picks = [router.pick_for_role(n).name for n in ("prefill", "decode")]
        stubs[2].pressure = 0.9
        picks += [router.pick_for_role(n).name for n in ("prefill", "decode")]
        router.replicas[1].kill()
        picks.append(router.pick_for_role("decode").name)
        router.replicas[2].kill()
        picks.append(_outcome(lambda: router.pick_for_role("decode"))[:2])
        picks.append(_outcome(lambda: router.pick_for_role("both"))[0])
        picks.append(_outcome(lambda: mod.ReplicaHandle("x", stubs[0],
                                                        role="draft"))[0])
        return picks

    picks = _both(run)
    assert picks[:5] == ["p0", "b0", "p0", "d0", "b0"]
    assert picks[5] == ("ServingRejected", "no_replicas")
    assert picks[6:] == ["ValueError", "ValueError"]


def _router_series(metrics, name):
    reg = metrics.registry()
    out = {}
    for fam in ("dl4jtpu_router_requests_total", "dl4jtpu_router_retries_total",
                "dl4jtpu_router_hedges_total", "dl4jtpu_replica_ejections_total"):
        f = reg.counter(fam)
        with f._lock:
            for key, v in f._series.items():
                labels = dict(key)
                if labels.get("router", name) == name:
                    labels.pop("router", None)
                    out[(fam, tuple(sorted(labels.items())))] = v
    out["overhead_count"] = reg.histogram("dl4jtpu_router_overhead_seconds").count
    return out


def test_counters_carry_the_same_names_and_labels(clock):
    def run(which):
        metrics = PKG[which][3]
        router, stubs = _router(which, [("r0", 0.0, "error", "both"),
                                        ("r1", 0.1, "ok", "both"),
                                        ("r2", 0.2, "reject:breaker_open", "both")],
                                eject_threshold=1, retry_budget=2)
        before = _router_series(metrics, router.name)
        for i in range(3):
            router.infer(np.array([i]))
        router.replicas[1].kill()
        _outcome(lambda: router.infer(np.array([5])))
        after = _router_series(metrics, router.name)
        delta = {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}
        return delta, _stats(router)

    delta, st = _both(run)
    assert delta[("dl4jtpu_router_requests_total",
                  (("outcome", "ok"), ("replica", "r1")))] == 3
    assert ("dl4jtpu_replica_ejections_total", (("reason", "dead"),)) in delta
    assert delta["overhead_count"] == 3


def test_router_spans_chain_the_tries_under_one_request(clock):
    def run(which):
        trace = PKG[which][4]
        rec = trace.tracer()
        rec.clear()
        rec.enable()
        try:
            router, _ = _router(which, [("r0", 0.0, "error", "both"),
                                        ("r1", 0.1, "ok", "both")],
                                eject_threshold=100, retry_budget=1)
            router.infer(np.array([1]))
            ids = rec.trace_ids()
            assert len(ids) == 1
            chain = rec.trace_chain(ids.pop())
        finally:
            rec.disable()
            rec.clear()
        return sorted((s["name"], s["args"].get("replica"), s["args"].get("outcome"))
                      for s in chain)

    spans = _both(run)
    assert spans == [("router.request", None, "ok"), ("router.try", "r0", "error"),
                     ("router.try", "r1", "ok")]


def test_pressure_collector_drops_the_series_of_a_dead_router(clock):
    def run(which):
        mod, _, _, metrics, _ = PKG[which]
        reg = metrics.registry()
        router, stubs = _router(which, [("r0", 0.25, "ok", "both"),
                                        ("r1", 0.5, "ok", "both")])
        name = router.name
        reg.collect()
        gauge = reg.gauge("dl4jtpu_router_replica_pressure")
        live = [gauge.value(router=name, replica=r) for r in ("r0", "r1")]
        listed = router in mod.active_routers()
        del router
        gc.collect()
        reg.collect()
        with gauge._lock:
            gone = not any(dict(k).get("router") == name for k in gauge._series)
        return live, listed, gone

    live, listed, gone = _both(run)
    assert live == [0.25, 0.5] and listed and gone
