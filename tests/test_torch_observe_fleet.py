"""The port's `observe/fleet.py` against the JAX package's, on the CPU:
the same worker payloads through both modules.

- `merge_prometheus_texts` gives byte-equal text (worker labels injected,
  histogram samples grouped under their family, a pushed worker label
  kept, blank and comment lines dropped).
- `FleetAggregator`: the latency view (skew, stragglers, the windowed
  recent mean), the serving, SLO and generation views, the merged
  exposition and the cluster trace are equal after the same ingests;
  expired workers drop out of both; the collector bridges the fleet
  gauges into the port's own registry.
- `FleetReporter` ships the port's registry text, its serving summary
  (the port's routers and servers) and only the spans it has not shipped.
"""

import copy

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.observe import fleet as jfleet
from deeplearning4j_tpu_torch.observe import fleet as pfleet
from deeplearning4j_tpu_torch.observe import metrics as pmetrics
from deeplearning4j_tpu_torch.observe import trace as ptrace

torch.set_num_threads(1)

WORKER_TEXT = """\
# HELP dl4jtpu_train_steps_total Optimizer steps run
# TYPE dl4jtpu_train_steps_total counter
dl4jtpu_train_steps_total {steps}
# HELP dl4jtpu_rpc_retries_total Retries
# TYPE dl4jtpu_rpc_retries_total counter
dl4jtpu_rpc_retries_total{{op="register"}} {retries}

# a stray comment
# HELP dl4jtpu_step_latency_seconds Step latency
# TYPE dl4jtpu_step_latency_seconds histogram
dl4jtpu_step_latency_seconds_bucket{{le="0.1"}} {steps}
dl4jtpu_step_latency_seconds_bucket{{le="+Inf"}} {steps}
dl4jtpu_step_latency_seconds_sum {lat_sum}
dl4jtpu_step_latency_seconds_count {steps}
# HELP dl4jtpu_fleet_workers Workers that pushed
# TYPE dl4jtpu_fleet_workers gauge
dl4jtpu_fleet_workers 7
dl4jtpu_coordinator_heartbeat_age_seconds{{worker="w9"}} 0.5
"""


def worker_payload(rank, steps=4, mean_lat=0.01, retries=1, trace=None,
                   serving=None, slo=None):
    return {
        "rank": rank,
        "prom": WORKER_TEXT.format(steps=steps, retries=retries,
                                   lat_sum=steps * mean_lat),
        "step_latency_sum": steps * mean_lat,
        "step_latency_count": steps,
        "trace": trace, "serving": serving, "slo": slo,
    }


def _trace(names, pid=999):
    return {"traceEvents": [{"name": n, "ph": "X", "ts": float(i), "dur": 1.0,
                             "pid": pid, "tid": 1} for i, n in enumerate(names)],
            "metadata": {"spans_dropped": 2}}


@pytest.mark.parametrize("texts", [
    {"w0": WORKER_TEXT.format(steps=3, retries=1, lat_sum=0.03),
     "w1": WORKER_TEXT.format(steps=5, retries=2, lat_sum=0.10)},
    {"b": 'x_total{a="1",b="q\\"uote"} 2\nx_total 3\n', "a": "",
     "c": "# TYPE y histogram\ny_bucket{le=\"1\"} 1\ny_sum 0.5\ny_count 1\n"},
    {"w\n0": "z 1\n", "3": "z{worker=\"x\"} 2\nbad line here\n{\n"},
    {},
])
def test_merge_prometheus_texts_is_byte_equal(texts):
    got = pfleet.merge_prometheus_texts(texts)
    assert got == jfleet.merge_prometheus_texts(texts)
    if texts and any(texts.values()):
        assert got.endswith("\n")


SCENARIOS = {
    "skew": [("w0", worker_payload(0, steps=10, mean_lat=0.01)),
             ("w1", worker_payload(1, steps=10, mean_lat=0.01)),
             ("w2", worker_payload(2, steps=10, mean_lat=0.05))],
    "two_workers": [("w0", worker_payload(0, steps=10, mean_lat=0.01)),
                    ("w1", worker_payload(1, steps=10, mean_lat=0.10))],
    "windowed": [("w0", worker_payload(0, steps=10, mean_lat=0.01)),
                 ("w0", {"rank": 0, "step_latency_sum": 10 * 0.01 + 10 * 0.03,
                         "step_latency_count": 20})],
    "traces": [("w0", worker_payload(0, trace=_trace(["a", "b"]))),
               ("w0", {"rank": 0, "trace": _trace(["c"])}),
               ("w1", worker_payload(1, trace=_trace(["d"], pid=5)))],
    "serving": [("w0", worker_payload(0, serving={
        "servers": [{"status": "serving", "generation": {"active_streams": 2}},
                    {"status": "serving"}],
        "routers": [{"name": "router1", "ok": 3}]},
        slo={"objectives": {"ttft": {"alert": "ok"}}})),
        ("w1", worker_payload(1, serving={"servers": [], "routers": []}))],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_aggregator_views_are_equal(name):
    aggs = {"jax": jfleet.FleetAggregator(), "port": pfleet.FleetAggregator()}
    for worker, payload in SCENARIOS[name]:
        for agg in aggs.values():
            agg.ingest(worker, copy.deepcopy(payload))
    views = {w: (a.workers(), a.latency_view(), a.serving_view(), a.slo_view(),
                 a.generation_view(), a.to_prometheus_text(), a.to_cluster_trace(),
                 a.snapshots)
             for w, a in aggs.items()}
    assert views["port"] == views["jax"]
    if name == "skew":
        view = views["port"][1]
        assert view["skew"] == pytest.approx(5.0) and view["stragglers"] == ["w2"]
        text = views["port"][5]
        assert "dl4jtpu_fleet_workers 3" in text
        assert "dl4jtpu_fleet_workers{" not in text      # pushed copies dropped
    if name == "windowed":
        assert views["port"][1]["workers"]["w0"] == pytest.approx(0.03)
    if name == "traces":
        xs = [e for e in views["port"][6]["traceEvents"] if e.get("ph") == "X"]
        assert sorted(e["name"] for e in xs) == ["a", "b", "c", "d"]
        assert {e["pid"] for e in xs} == {0, 1}
    if name == "serving":
        assert views["port"][4] == {"w0": [{"active_streams": 2}]}


def test_expired_workers_drop_out_of_both(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_FLEET_WORKER_TTL", "60")
    out = {}
    for which, mod in (("jax", jfleet), ("port", pfleet)):
        agg = mod.FleetAggregator()
        agg.ingest("dead", worker_payload(0, steps=10, mean_lat=0.09))
        agg.ingest("live", worker_payload(1, steps=10, mean_lat=0.01))
        with agg._lock:
            agg._workers["dead"]["last_push"] -= 120
        out[which] = (agg.workers(), agg.latency_view(),
                      'worker="dead"' in agg.to_prometheus_text())
    assert out["port"] == out["jax"] == (["live"], {
        "workers": {"live": pytest.approx(0.01)}, "skew": pytest.approx(1.0),
        "stragglers": []}, False)


def test_collector_bridges_fleet_gauges_into_the_port_registry():
    reg = pmetrics.registry()
    agg = pfleet.FleetAggregator()
    agg.ingest("wa", worker_payload(0, steps=4, mean_lat=0.02))
    agg.ingest("wb", worker_payload(1, steps=4, mean_lat=0.08))
    collect, cleanup = agg.make_collector()
    collect()
    assert reg.gauge("dl4jtpu_fleet_workers").value() == 2
    assert reg.gauge("dl4jtpu_fleet_step_latency_seconds").value(
        worker="wb") == pytest.approx(0.08)
    assert reg.gauge("dl4jtpu_fleet_step_latency_skew").value() == pytest.approx(4.0)
    assert reg.gauge("dl4jtpu_fleet_stragglers").value() == 1
    assert reg.counter("dl4jtpu_fleet_snapshots_total").value() >= 2
    cleanup()
    assert reg.gauge("dl4jtpu_fleet_workers").value() == 0
    with reg.gauge("dl4jtpu_fleet_step_latency_seconds")._lock:
        assert not any(dict(k).get("worker") == "wb" for k in
                       reg.gauge("dl4jtpu_fleet_step_latency_seconds")._series)


def test_reporter_ships_the_registry_the_serving_summary_and_new_spans():
    from deeplearning4j_tpu_torch.serving.router import ReplicaHandle, Router

    sent = []

    class FakeClient:
        def push_metrics(self, payload):
            sent.append(payload)

    class Stub:
        def health(self):
            return {"status": "serving", "shed_pressure": 0.0,
                    "breaker_state": "closed"}

    router = Router([ReplicaHandle("r0", Stub())])
    t = ptrace.tracer()
    was = t.enabled
    t.enable()
    t.clear()
    try:
        rep = pfleet.FleetReporter(FakeClient(), rank=3, every_s=3600.0)
        t.add_complete("first", 1.0, 0.001)
        assert rep.push()
        t.add_complete("second", 2.0, 0.001)
        assert rep.push()
        assert rep.push()                   # nothing new: no trace attached
        assert not rep.maybe_push()         # inside every_s
    finally:
        t.clear()
        if not was:
            t.disable()
    names = [[e["name"] for e in p["trace"]["traceEvents"]]
             for p in sent if "trace" in p]
    assert names == [["first"], ["second"]] and "trace" not in sent[2]
    p = sent[0]
    assert p["rank"] == 3 and "dl4jtpu_step_latency_seconds" in p["prom"]
    assert any(r["name"] == router.name for r in p["serving"]["routers"])
    agg = pfleet.FleetAggregator()
    agg.ingest("w3", p)
    assert agg.serving_view()["w3"]["routers"]
    assert np.isfinite(p["step_latency_sum"])


def test_a_failing_push_keeps_the_span_cursor():
    class Down:
        def push_metrics(self, payload):
            raise ConnectionError("coordinator away")

    t = ptrace.tracer()
    was = t.enabled
    t.enable()
    t.clear()
    try:
        rep = pfleet.FleetReporter(Down(), rank=0)
        t.add_complete("kept", 1.0, 0.001)
        assert not rep.push()
        assert rep._trace_cursor == 0
    finally:
        t.clear()
        if not was:
            t.disable()
