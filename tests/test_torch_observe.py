"""The port's observability plane against the JAX package's, on the CPU.

- The same counter, gauge and histogram operations give byte-identical
  Prometheus text in a registry of each package, and `_declare_core`
  declares the same families with the same types and buckets.
- SLO burn rates and alert edges agree on the same injected samples
  (injected clocks: hours of burn in microseconds).
- The watchdog ladder, driven by ``poll(now=...)`` on an injected clock:
  the same events in both packages, and the port's ``cold`` arm.
- The circuit breaker, the batching quantizers, the flight recorder's
  dump (the same record keys), the hot-swap checks (a checksum computed
  by one package verifies in the other), the crash reports, and the
  deferred counters (``dl4jtpu_faults_injected_total``,
  ``dl4jtpu_ckpt_verify_failures_total``).
"""

import json
import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.observe import metrics as jmetrics
from deeplearning4j_tpu.observe import slo as jslo
from deeplearning4j_tpu.observe import trace as jtrace
from deeplearning4j_tpu.runtime import watchdog as jwatchdog
from deeplearning4j_tpu.serving import batching as jbatching
from deeplearning4j_tpu.serving import breaker as jbreaker
from deeplearning4j_tpu.serving import flight as jflight
from deeplearning4j_tpu.serving import hotswap as jhotswap
from deeplearning4j_tpu_torch.observe import metrics as pmetrics
from deeplearning4j_tpu_torch.observe import slo as pslo
from deeplearning4j_tpu_torch.observe import trace as ptrace
from deeplearning4j_tpu_torch.runtime import crash as pcrash
from deeplearning4j_tpu_torch.runtime import faults as pfaults
from deeplearning4j_tpu_torch.runtime import watchdog as pwatchdog
from deeplearning4j_tpu_torch.serving import batching as pbatching
from deeplearning4j_tpu_torch.serving import breaker as pbreaker
from deeplearning4j_tpu_torch.serving import flight as pflight
from deeplearning4j_tpu_torch.serving import hotswap as photswap

torch.set_num_threads(1)

class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


# -- the registry ------------------------------------------------------------


def _ops_counters(reg):
    c = reg.counter("dl4jtpu_test_events_total", "events by kind")
    c.inc()
    c.inc(3, kind="a")
    c.inc(2.5, kind="b", zone="x\"y")
    c.set_total(11, kind="c")


def _ops_gauges(reg):
    g = reg.gauge("dl4jtpu_test_level", "a level")
    g.set(4)
    g.set(0.125, part="p")
    g.set(float("nan"), part="nan")
    g.set(float("inf"), part="inf")
    g.set(-7, part="neg")


def _ops_histograms(reg):
    h = reg.histogram("dl4jtpu_test_seconds", "latencies")
    for v in (0.0001, 0.003, 0.02, 0.02, 0.7, 3.0, 1e9):
        h.observe(v)
    h2 = reg.histogram("dl4jtpu_test_tokens", "token counts",
                       buckets=(1, 2, 4, 8))
    for v in (1, 1, 3, 8, 9):
        h2.observe(v)


def _ops_mixed(reg):
    _ops_counters(reg)
    _ops_gauges(reg)
    _ops_histograms(reg)
    reg.gauge("dl4jtpu_test_level").clear()
    reg.counter("dl4jtpu_test_events_total").inc(kind="a")


@pytest.mark.parametrize("ops", [_ops_counters, _ops_gauges, _ops_histograms,
                                 _ops_mixed])
def test_same_operations_give_byte_identical_prometheus_text(ops):
    texts = []
    for m in (jmetrics, pmetrics):
        reg = m.MetricsRegistry()
        ops(reg)
        texts.append(reg.to_prometheus_text())
    assert texts[0] == texts[1]
    assert "dl4jtpu_test" in texts[1]


def test_snapshots_agree():
    snaps = []
    for m in (jmetrics, pmetrics):
        reg = m.MetricsRegistry()
        _ops_mixed(reg)
        snaps.append(json.dumps(reg.snapshot(), sort_keys=True, default=str))
    assert snaps[0] == snaps[1]


def _declared(m):
    reg = m.MetricsRegistry()
    m._declare_core(reg)
    out = {}
    for name in sorted(reg._metrics):
        fam = reg.get(name)
        out[name] = (type(fam).__name__, getattr(fam, "buckets", None))
    return out, reg


def test_declare_core_declares_the_same_families_and_types():
    (want, jreg), (got, preg) = _declared(jmetrics), _declared(pmetrics)
    assert got == want
    # help strings too, but for the families whose source is the card
    own = {"dl4jtpu_build_info", "dl4jtpu_device_bytes_in_use",
           "dl4jtpu_device_peak_bytes_in_use"}
    for name in want:
        if name not in own:
            assert preg.get(name).help == jreg.get(name).help, name
    for name in ("dl4jtpu_generation_streams_total", "dl4jtpu_kv_pages_used",
                 "dl4jtpu_serving_shed_total", "dl4jtpu_watchdog_stalls_total",
                 "dl4jtpu_faults_injected_total", "dl4jtpu_spec_tokens_total",
                 "dl4jtpu_ckpt_verify_failures_total",
                 "dl4jtpu_serving_breaker_state"):
        assert name in got


def test_build_info_names_torch_and_the_device_count():
    reg = pmetrics.registry()
    text = reg.to_prometheus_text()
    line = [l for l in text.splitlines()
            if l.startswith("dl4jtpu_build_info{")]
    assert len(line) == 1
    assert f'torch="{torch.__version__}"' in line[0]
    want = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert f'device_count="{want}"' in line[0]


# -- SLOs --------------------------------------------------------------------


def _slo_run(m, slo_mod, kind):
    reg = m.MetricsRegistry()
    clk = _Clock(1000.0)
    windows = (slo_mod.BurnWindow(60.0, 14.4), slo_mod.BurnWindow(600.0, 6.0))
    if kind == "availability":
        obj = slo_mod.SLObjective.availability(
            "avail", 0.99, family="dl4jtpu_test_requests_total")
        fam = reg.counter("dl4jtpu_test_requests_total")
    elif kind == "latency":
        obj = slo_mod.SLObjective.latency(
            "lat", 0.99, 0.25, family="dl4jtpu_test_latency_seconds")
        fam = reg.histogram("dl4jtpu_test_latency_seconds")
    else:
        obj = slo_mod.SLObjective.throughput(
            "tput", 0.99, 100.0, family="dl4jtpu_test_tokens_total",
            demand_family="dl4jtpu_test_admitted_total")
        fam = reg.counter("dl4jtpu_test_tokens_total")
        dem = reg.counter("dl4jtpu_test_admitted_total")
    eng = slo_mod.SLOEngine([obj], windows=windows, clock=clk, registry=reg)
    edges = []
    listener = lambda name, state: edges.append((name, state["alert"]))
    slo_mod.add_alert_listener(listener)
    trace = []
    try:
        rng = np.random.default_rng(5)
        for step in range(120):
            clk.t += 15.0
            bad_phase = 30 <= step < 70
            for _ in range(20):
                if kind == "availability":
                    bad = bad_phase and rng.random() < 0.5
                    fam.inc(outcome="error" if bad else "ok")
                elif kind == "latency":
                    fam.observe(0.6 if bad_phase and rng.random() < 0.6
                                else 0.01)
            if kind == "throughput":
                dem.inc()
                fam.inc(200 if bad_phase else 2000)
            st = eng.sample()[obj.name]
            trace.append((st["alert"], st["burn"], st["alerts_total"],
                          st["budget_remaining"], st["good"], st["bad"]))
    finally:
        slo_mod.remove_alert_listener(listener)
    return trace, edges, eng.summary()


@pytest.mark.parametrize("kind", ["availability", "latency", "throughput"])
def test_slo_burn_rates_and_alert_edges_agree(kind):
    want = _slo_run(jmetrics, jslo, kind)
    got = _slo_run(pmetrics, pslo, kind)
    assert got == want
    trace, edges, _ = got
    assert [a for a, *_ in trace].count(True) > 0     # it fired
    assert trace[-1][0] is False                       # and cleared
    assert [e for _, e in edges] == [True]             # one rising edge


def test_generation_objectives_agree():
    a = jslo.generation_objectives()
    b = pslo.generation_objectives()
    assert [vars(o) for o in a] == [vars(o) for o in b]


# -- the watchdog ------------------------------------------------------------


def _ladder(wd_mod, tmp_path, monkeypatch):
    monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
    clk = _Clock(0.0)
    aborts = []
    wd = wd_mod.StepWatchdog(floor_s=0.5, cold_floor_s=5.0, k=4.0,
                             ewma_alpha=0.5, abort=aborts.append,
                             threaded=False, clock=clk, name="t")
    seen = []
    wd.arm(1)                             # cold: no EWMA yet
    clk.t += 4.9
    wd.poll(now=clk.t)
    seen.append(len(wd.events))
    clk.t += 0.2
    wd.poll(now=clk.t)                    # past 5.0: warn
    seen.append([e["stage"] for e in wd.events])
    wd.disarm(5.1)                        # escalated: no EWMA sample
    seen.append(wd.ewma)
    for i, dur in enumerate((0.2, 0.3, 0.1)):
        wd.arm(2 + i)
        clk.t += dur
        wd.disarm(dur)
    seen.append(round(wd.ewma, 9))
    seen.append(round(wd.deadline_s(), 9))
    wd.arm(9, n_steps=3)                  # a verify-width dispatch
    t0 = clk.t
    for dt in (1.0, 2.2, 3.4, 4.6, 9.0):
        wd.poll(now=t0 + dt)
    seen.append([(e["stage"], e["n_steps"], e["deadline_s"])
                 for e in wd.events])
    seen.append([(e["stage"], e["iteration"]) for e in aborts])
    wd.disarm(None)
    seen.append(len(wd.report_paths))
    return seen


def test_watchdog_ladder_agrees_on_an_injected_clock(tmp_path, monkeypatch):
    want = _ladder(jwatchdog, tmp_path / "jax", monkeypatch)
    got = _ladder(pwatchdog, tmp_path / "port", monkeypatch)
    assert got == want
    assert got[-2] == [("abort", 9)]
    # the stack dump is a thread report that names this test's frame
    rep = sorted(os.listdir(tmp_path / "port"))
    assert len(rep) == 1 and rep[0].startswith("dl4jtpu-hang-report-")
    text = (tmp_path / "port" / rep[0]).read_text()
    assert "step-watchdog hang report" in text and "_ladder" in text


def test_watchdog_stalls_counter_moves_by_stage(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
    fam = pmetrics.registry().counter("dl4jtpu_watchdog_stalls_total")
    before = {s: fam.value(stage=s) for s in pwatchdog.STAGES}
    wd = pwatchdog.StepWatchdog(floor_s=1.0, cold_floor_s=1.0, k=1.0,
                                abort=lambda e: None, threaded=False,
                                clock=_Clock(0.0))
    wd.arm(1)
    wd.poll(now=10.0)
    assert {s: fam.value(stage=s) - before[s] for s in pwatchdog.STAGES} == {
        "warn": 1, "stack_dump": 1, "abort": 1}


def test_a_cold_arm_takes_the_cold_floor_and_feeds_no_sample():
    clk = _Clock(0.0)
    wd = pwatchdog.StepWatchdog(floor_s=0.1, cold_floor_s=7.0, k=2.0,
                                ewma_alpha=1.0, threaded=False, clock=clk)
    wd.arm(1)
    wd.disarm(0.05)
    assert wd.ewma == pytest.approx(0.05)
    wd.arm(2, cold=True)                  # a dispatch that captures a graph
    wd.poll(now=6.9)
    assert wd.events == []
    wd.poll(now=7.05)
    assert [e["stage"] for e in wd.events] == ["warn"]
    assert wd.events[0]["deadline_s"] == 7.0
    wd.disarm(None)
    assert wd.ewma == pytest.approx(0.05)
    wd.arm(3)                              # warm again: max(0.1, 2 * 0.05)
    assert wd._base == pytest.approx(0.1)
    wd.disarm(None)


def test_the_monitor_thread_aborts_a_real_stall():
    import threading

    fired = threading.Event()
    wd = pwatchdog.StepWatchdog(floor_s=0.05, cold_floor_s=0.05, k=1.0,
                                dump_after=1.0, abort_after=1.0,
                                abort=lambda e: fired.set())
    wd.arm(1)
    try:
        assert fired.wait(10.0)
    finally:
        wd.disarm(None)


# -- the breaker, batching, tracing ------------------------------------------


def _breaker_run(b_mod, m_mod):
    clk = _Clock(0.0)
    br = b_mod.CircuitBreaker(threshold=2, probe_after_s=1.0, clock=clk)
    fam = m_mod.registry().counter("dl4jtpu_serving_breaker_transitions_total")
    before = {to: fam.value(to=to) for to in ("open", "half_open", "closed")}
    out = []
    for act in ("fail", "admit", "fail", "admit", "wait", "admit", "admit",
                "fail", "admit", "wait", "admit", "ok", "admit", "fail"):
        if act == "fail":
            br.record_failure()
        elif act == "ok":
            br.record_success()
        elif act == "wait":
            clk.t += 1.5
        else:
            out.append(br.admits())
        out.append(br.state)
    out.append(br.stats())
    out.append({to: fam.value(to=to) - before[to]
                for to in ("open", "half_open", "closed")})
    return out


def test_breaker_states_and_transition_counts_agree():
    want = _breaker_run(jbreaker, jmetrics)
    got = _breaker_run(pbreaker, pmetrics)
    assert got == want
    assert got[-1] == {"open": 2, "half_open": 2, "closed": 1}


def test_batching_quantizers_agree():
    for n in range(1, 17):
        assert (pbatching.batch_bucket(n, 16)
                == jbatching.batch_bucket(n, 16))
    with pytest.raises(ValueError):
        pbatching.batch_bucket(9, 8)
    a = np.arange(30, dtype=np.float32).reshape(10, 3)
    for q in (None, 4, 16):
        pj, mj = jbatching.pad_sequence(a, q)
        pp, mp = pbatching.pad_sequence(a, q)
        np.testing.assert_array_equal(pp, pj)
        np.testing.assert_array_equal(mp, mj)
        assert (pbatching.bucket_signature((a,), q, True)
                == jbatching.bucket_signature((a,), q, True))
    rows = [(np.full(5, i, np.int64),) for i in range(3)]
    for x, y in zip(pbatching.stack_batch(rows, 1, 4),
                    jbatching.stack_batch(rows, 1, 4)):
        np.testing.assert_array_equal(x, y)


def _chain(t_mod):
    rec = t_mod.TraceRecorder()
    rec.enable()
    tid, root = t_mod.next_id(), t_mod.next_id()
    for i, name in enumerate(("a.admit", "a.queue", "a.dispatch")):
        rec.add_complete(name, 1.0 + i, 0.5, cat="x",
                         **t_mod.trace_args(tid, t_mod.next_id(), root))
    rec.add_complete("a.root", 1.0, 3.0, cat="x",
                     **t_mod.trace_args(tid, root, None))
    chain = rec.trace_chain(tid)
    events = rec.to_chrome_trace()["traceEvents"]
    return ([s["name"] for s in chain], t_mod.chain_is_causal(chain),
            sorted({e["ph"] for e in events}), t_mod.chain_coverage(chain))


def test_trace_chains_agree():
    want, got = _chain(jtrace), _chain(ptrace)
    assert got == want
    assert got[1] is True


def test_step_scope_keeps_the_device_sync_site():
    plan = pfaults.arm("device.sync:raise:nth=1")
    try:
        scope = ptrace.StepScope(0)
        with pytest.raises(ConnectionError):
            scope.sync(torch.zeros(1))
        assert plan.stats()["device.sync"] == {"consults": 1, "fires": 1}
    finally:
        pfaults.disarm()


# -- the flight recorder -----------------------------------------------------


def _flight_dump(f_mod, path):
    fr = f_mod.FlightRecorder(spike_threshold=2, cooldown_s=1000.0)
    fr.context_fn = lambda: {"stats": {"slots": 2}}
    for i in range(3):
        fr.record({"rid": f"gen-{i}", "outcome": "ok", "tokens": i})
    assert fr.note_kv_exhausted() is None
    spike = fr.note_kv_exhausted()
    again = fr.dump("kv_exhausted_spike")           # on cooldown
    p = fr.dump("watchdog_abort", context={"stage": "abort"},
                path=str(path))
    with open(p) as f:
        doc = json.load(f)
    return (sorted(doc), doc["schema"], doc["trigger"], doc["context"],
            doc["records"], doc["engine"], spike is not None, again,
            fr.dumps_written, len(fr))


def test_flight_dumps_hold_the_same_record_keys(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
    want = _flight_dump(jflight, tmp_path / "j.json")
    got = _flight_dump(pflight, tmp_path / "p.json")
    assert got[:6] == want[:6]       # keys, schema, trigger, context, ...
    assert got[6:] == want[6:]
    assert got[1] == "dl4jtpu-flight-record/1"


def test_flight_slo_trigger_dumps_on_a_rising_edge(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
    fr = pflight.FlightRecorder()
    fr.attach_slo_trigger()
    try:
        pslo._notify_alert("avail", {"alert": True})
    finally:
        fr.detach_slo_trigger()
    assert fr.dumps_written == 1
    with open(fr.dump_paths[0]) as f:
        doc = json.load(f)
    assert doc["trigger"] == "slo_alert"
    assert doc["context"]["objective"] == "avail"


# -- hot-swap checks ----------------------------------------------------------


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    tree = {"layer0": {"W": rng.normal(size=(5, 4)).astype(np.float32),
                       "b": rng.normal(size=(4,)).astype(np.float32)},
            "layer1": {"attn": {"Wq": rng.normal(size=(4, 4))
                                .astype(np.float32)},
                       "gamma": np.ones(4, np.float32)}}
    port = {k: {kk: ({a: torch.from_numpy(b.copy()) for a, b in vv.items()}
                     if isinstance(vv, dict) else torch.from_numpy(vv.copy()))
                for kk, vv in v.items()} for k, v in tree.items()}
    return tree, port


def test_checksums_agree_across_the_packages():
    jt, pt = _trees()
    crc = jhotswap.weights_checksum(jt)
    assert photswap.weights_checksum(pt) == crc
    photswap.verify_weights(pt, pt, checksum=crc)
    jhotswap.verify_weights(jt, jt, checksum=photswap.weights_checksum(pt))


def _verdict(mod, staged, live, checksum=None):
    try:
        mod.verify_weights(staged, live, checksum=checksum)
    except mod.SwapVerifyError as exc:
        return exc.reason
    return "ok"


@pytest.mark.parametrize("case", ["ok", "truncate", "corrupt", "shape",
                                  "dtype", "checksum", "keys"])
def test_verify_weights_rejects_what_the_jax_package_rejects(case):
    jt, pt = _trees()
    jlive, plive = _trees(1)
    crc = None
    if case in ("truncate", "corrupt"):
        jt = jhotswap.apply_fault_action(case, jt)
        pt = photswap.apply_fault_action(case, pt)
    elif case == "shape":
        jt["layer0"]["b"] = np.zeros(5, np.float32)
        pt["layer0"]["b"] = torch.zeros(5)
    elif case == "dtype":
        jt["layer0"]["b"] = jt["layer0"]["b"].astype(np.float64)
        pt["layer0"]["b"] = pt["layer0"]["b"].double()
    elif case == "checksum":
        crc = jhotswap.weights_checksum(jt) ^ 1
    elif case == "keys":
        jt["layer2"] = jt.pop("layer1")
        pt["layer2"] = pt.pop("layer1")
    want = _verdict(jhotswap, jt, jlive, crc)
    got = _verdict(photswap, pt, plive, crc)
    assert got == want
    assert got == {"truncate": "structure", "corrupt": "nonfinite",
                   "keys": "structure", "dtype": "shape"}.get(case, case)


def test_corrupt_action_leaves_the_pushed_tree_untouched():
    _, pt = _trees()
    before = pt["layer0"]["W"].clone()
    bad = photswap.apply_fault_action("corrupt", pt)
    assert torch.isnan(bad["layer0"]["W"]).any()
    assert torch.equal(pt["layer0"]["W"], before)


# -- crash reports -----------------------------------------------------------


def test_memory_report_and_oom_detection(tmp_path):
    p = pcrash.write_memory_report(str(tmp_path / "m.txt"), header="TRIGGER")
    with open(p) as f:
        text = f.read()
    assert "device memory report" in text and "TRIGGER" in text
    assert "live CUDA tensors" in text
    assert pcrash.is_oom_error(torch.cuda.OutOfMemoryError("x"))
    assert pcrash.is_oom_error(RuntimeError("CUDA out of memory. Tried"))
    assert not pcrash.is_oom_error(RuntimeError("shape mismatch"))
    assert pcrash.maybe_write_oom_report(ValueError("no")) is None


# -- flags and the counters deferred to the serving plane --------------------


def test_sequence_bucket_reads_the_same_variable(monkeypatch):
    from deeplearning4j_tpu.runtime import flags as jflags
    from deeplearning4j_tpu_torch.runtime import flags as pflags

    for env in ({}, {"DL4J_TPU_SEQUENCE_BUCKET": "32"}):
        monkeypatch.delenv("DL4J_TPU_SEQUENCE_BUCKET", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        j = jflags.Environment.from_env().sequence_bucket_size
        assert pflags.sequence_bucket_size() == j
        assert [pflags.bucket_length(n) for n in (1, 31, 33, 64, 65)] == \
            [jflags.bucket_length(n, j) for n in (1, 31, 33, 64, 65)]


def test_fault_fires_are_counted_by_site():
    fam = pmetrics.registry().counter("dl4jtpu_faults_injected_total")
    before = fam.value(site="test.site")
    pfaults.arm("test.site:corrupt:every=2")
    try:
        got = [pfaults.maybe_fail("test.site") for _ in range(5)]
    finally:
        pfaults.disarm()
    assert got == [None, "corrupt", None, "corrupt", None]
    assert fam.value(site="test.site") - before == 2


def test_checkpoint_verify_failures_are_counted(tmp_path):
    from deeplearning4j_tpu_torch.train.checkpoint import (
        CheckpointVerifyError, ModelSerializer)
    from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

    m = TransformerEncoder(vocab_size=11, d_model=32, n_heads=2,
                           n_layers=1).init_model(device="cpu")
    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(m, path)
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    raw[len(raw) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(raw))
    fam = pmetrics.registry().counter("dl4jtpu_ckpt_verify_failures_total")
    before = fam.value(reason="corrupt")
    with pytest.raises(CheckpointVerifyError):
        ModelSerializer.verify(path)
    assert fam.value(reason="corrupt") - before == 1
