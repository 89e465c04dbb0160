"""The port's generation engine with the serving plane attached, against
the JAX package's engine, on the CPU: a causal transformer of 2 layers,
d_model 64, f32, the port's weights carried from the JAX model by
`convert.params_from_jax`.

The same streams are queued in both engines before they start, so both
admit them together and dispatch the same batches.  For every case —
greedy, sampled, speculative, an injected ``serving.decode`` raise, and
the ``kv.alloc`` fault plans (``every=1`` and ``nth=2``) — both give:

- the same outcome for every stream and the same tokens for the streams
  that finish, and a clean `leak_check()` with every page back;
- the same metric families, label sets and counter values (durations
  excluded: histograms compare their counts), among them
  ``dl4jtpu_serving_shed_total{reason="kv_exhausted"}``;
- the same span-name chain for every stream, each one causal.

The ``kv.alloc`` cases hold the repair of the port's `PagedKVCache.alloc`,
which did not consult the site: there the JAX engine ended the streams as
``kv_exhausted`` and the port served them.

A watchdog abort is driven through ``poll(now=...)`` on an injected
clock while a step is held inside its arm: both engines fail the
in-flight streams as ``wedged``, give back every page, write a flight
dump with the same record keys, count the ladder's stages, and serve the
next streams with the same tokens.
"""

import json
import threading

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.observe import metrics as jmetrics
from deeplearning4j_tpu.observe import trace as jtrace
from deeplearning4j_tpu.runtime import faults as jfaults
from deeplearning4j_tpu.runtime import watchdog as jwatchdog
from deeplearning4j_tpu.serving.generation import (
    GenerationConfig as JaxGenerationConfig,
)
from deeplearning4j_tpu.serving.generation import (
    GenerationEngine as JaxGenerationEngine,
)
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.convert import params_from_jax
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.observe import metrics as pmetrics
from deeplearning4j_tpu_torch.observe import trace as ptrace
from deeplearning4j_tpu_torch.runtime import faults as pfaults
from deeplearning4j_tpu_torch.runtime import watchdog as pwatchdog
from deeplearning4j_tpu_torch.serving.admission import ServingRejected
from deeplearning4j_tpu_torch.serving.generation import (
    GEN_BREAKDOWN_SEGMENTS,
    GenerationConfig,
    GenerationEngine,
)
from deeplearning4j_tpu_torch.serving.kv_cache import (
    KVPoolExhausted,
    PagedKVCache,
)
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

# small shapes: one intra-op thread keeps these files from competing with
# the multi-process tests that share the host under pytest-xdist
torch.set_num_threads(1)

VOCAB, D, HEADS, LAYERS = 41, 64, 2, 2
CFG = dict(slots=4, page_size=8, num_pages=64, max_pages_per_seq=4,
           max_queue=32)

PKG = {"jax": (JaxGenerationEngine, JaxGenerationConfig, jfaults, jmetrics,
               jtrace, jwatchdog),
       "port": (GenerationEngine, GenerationConfig, pfaults, pmetrics,
                ptrace, pwatchdog)}

#: histogram families whose SUM is a count, not a duration
COUNT_HISTOGRAMS = ("dl4jtpu_spec_tokens_per_dispatch",)
#: gauges compared by value (the others hold rates or durations)
GAUGES = ("dl4jtpu_kv_pages_used", "dl4jtpu_kv_pages_total",
          "dl4jtpu_decode_batch_occupancy", "dl4jtpu_spec_acceptance_ratio",
          "dl4jtpu_flight_records")
#: counted where only one package has the code that counts
SKIP = ("dl4jtpu_paged_attention_total", "dl4jtpu_trace_spans_dropped_total",
        "dl4jtpu_compile_")


@pytest.fixture(scope="module")
def models():
    kw = dict(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS,
              causal=True, seed=13)
    jm = JaxTE(**kw).init_model()
    port = SequentialModel(TransformerEncoder(**kw).conf(), device="cpu")
    return jm, params_from_jax(jax.tree.map(np.asarray, jm.params), port)


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _loopy(n, seed):
    base = _prompt(3, seed)
    return np.tile(base, n // 3 + 1)[:n].astype(np.int32)


def _metrics(metrics_mod) -> dict:
    """(family, labels, field) -> value for every counter series, every
    histogram's count (and the sum of count-valued ones), and the
    compared gauges."""
    reg = metrics_mod.registry()
    with reg._lock:
        fams = dict(reg._metrics)
    out = {}
    for name, fam in fams.items():
        if name.startswith(SKIP):
            continue
        if isinstance(fam, metrics_mod.Histogram):
            out[(name, (), "count")] = fam.count
            if name in COUNT_HISTOGRAMS:
                out[(name, (), "sum")] = round(fam._sum, 6)
        elif isinstance(fam, metrics_mod.Counter):
            with fam._lock:
                for key, v in fam._series.items():
                    out[(name, key, "value")] = v
        elif name in GAUGES:
            with fam._lock:
                for key, v in fam._series.items():
                    out[(name, key, "gauge")] = v
    return out


def _delta(before: dict, after: dict) -> dict:
    out = {}
    for k, v in after.items():
        if k[2] == "gauge":
            out[k] = v
        elif v != before.get(k, 0):
            out[k] = v - before.get(k, 0)
    return out


def _serve(which, model, streams, plan=None, **cfg):
    """Queue every (prompt, max_new, kwargs) stream, then start the
    engine.  Returns (per-stream (outcome, tokens, error reason), metric
    deltas, per-stream span chains, stats)."""
    Engine, Config, faults, metrics, trace, _ = PKG[which]
    rec = trace.tracer()
    rec.clear()
    rec.enable()
    # the compared gauges hold what this run sets, not what an engine of
    # an earlier test in this process left there
    for name in GAUGES:
        metrics.registry().gauge(name).clear()
    before = _metrics(metrics)
    try:
        eng = Engine(model=model, config=Config(**{**CFG, **cfg}))
        reqs = [eng.submit(p, m, **kw) for p, m, kw in streams]
        if plan is not None:
            faults.arm(plan)
        eng.start()
        out = []
        try:
            for r in reqs:
                try:
                    toks = np.asarray(r.result(timeout=120)).tolist()
                    out.append((r.outcome, toks, None))
                except Exception as exc:     # noqa: BLE001 - compared below
                    out.append((r.outcome, None,
                                getattr(exc, "reason", type(exc).__name__)))
            assert eng.drain(30.0)
            assert eng.kv.leak_check() is None
            assert eng.kv.used_pages == 0
            st = eng.stats()
        finally:
            eng.stop()
            faults.disarm()
        chains = []
        for r in reqs:
            chain = rec.trace_chain(r.trace_id)
            chains.append(([s["name"] for s in chain],
                           trace.chain_is_causal(chain)))
    finally:
        rec.disable()
        rec.clear()
    return out, _delta(before, _metrics(metrics)), chains, st


def _both(models, streams, plan=None, **cfg):
    jm, port = models
    want = _serve("jax", jm, streams, plan, **cfg)
    got = _serve("port", port, streams, plan, **cfg)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert all(causal for _, causal in got[2])
    return got


GREEDY = [(_prompt(n, 100 + n), m, {}) for n, m in
          ((5, 8), (11, 6), (17, 9), (3, 7), (9, 5), (13, 8))]
SAMPLED = [(_prompt(n, 200 + n), 7,
            dict(temperature=t, top_k=k, seed=s))
           for n, t, k, s in ((6, 0.0, 0, 0), (9, 0.8, 5, 1), (4, 1.3, 0, 7),
                              (12, 0.6, 20, 3), (7, 0.0, 0, 0))]
SPEC = [(_loopy(n, 300 + n), 12, {}) for n in (6, 9, 12, 7)] + [
    (_prompt(5, 7), 10, dict(temperature=0.9, top_k=8, seed=4)),
    (_loopy(8, 9), 9, dict(spec_k=0))]

CASES = {
    "greedy": (GREEDY, None, {}),
    "sampled": (SAMPLED, None, {}),
    "spec": (SPEC, None, dict(spec_k=3, spec_drafter="ngram")),
    "decode_raise": (GREEDY, "serving.decode:raise:nth=3", {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_with_the_plane_matches_the_jax_engine(models, case):
    streams, plan, cfg = CASES[case]
    out, delta, chains, st = _both(models, streams, plan, **cfg)
    outcomes = [o for o, _, _ in out]
    if case == "decode_raise":
        assert "error" in outcomes and "ok" in outcomes
        assert delta[("dl4jtpu_faults_injected_total",
                      (("site", "serving.decode"),), "value")] == 1
    else:
        assert outcomes == ["ok"] * len(streams)
    n_tok = sum(len(t) - len(p) for (_, t, _), (p, _, _) in zip(out, streams)
                if t is not None)
    assert delta[("dl4jtpu_decode_tokens_total", (), "value")] >= n_tok
    assert st["tokens_generated"] == delta[
        ("dl4jtpu_decode_tokens_total", (), "value")]
    for seg in GEN_BREAKDOWN_SEGMENTS[:2]:
        assert delta[(f"dl4jtpu_generation_{seg}_seconds", (), "count")] > 0
    # every stream's chain: admit, prefill, handoff, its steps, the root
    for (names, _), (outcome, toks, _), (p, _, _) in zip(chains, out, streams):
        assert names[0] == "generation.stream"
        assert names[1:4] == ["generation.admit", "generation.prefill",
                              "generation.kv_handoff"]
        if outcome == "ok" and case != "spec":
            assert names.count("generation.decode_step") == len(toks) - len(p) - 1
    if case == "spec":
        assert st["speculative"]["verify_dispatches"] > 0
        assert any(k[0] == "dl4jtpu_spec_tokens_total" for k in delta)


@pytest.mark.parametrize("plan", ["kv.alloc:raise:every=1",
                                  "kv.alloc:raise:nth=2"])
def test_kv_alloc_fault_plan_ends_streams_as_the_jax_engine_does(models, plan):
    out, delta, chains, st = _both(models, GREEDY, plan)
    outcomes = [o for o, _, _ in out]
    n_rejected = outcomes.count("kv_exhausted")
    assert n_rejected == (len(GREEDY) if "every" in plan else 1)
    assert [r for o, _, r in out if o == "kv_exhausted"] == \
        ["kv_exhausted"] * n_rejected
    assert delta[("dl4jtpu_serving_shed_total",
                  (("reason", "kv_exhausted"),), "value")] == n_rejected
    assert st["streams"]["outcomes"].get("kv_exhausted") == n_rejected
    for (names, causal), (o, _, _) in zip(chains, out):
        if o == "kv_exhausted":
            assert names == ["generation.stream", "generation.admit"]


def test_the_port_cache_consults_the_kv_alloc_site():
    kv = PagedKVCache(n_layers=1, n_heads=2, head_dim=16, num_pages=8,
                      page_size=8, device="cpu")
    pfaults.arm("kv.alloc:raise:every=1")
    try:
        with pytest.raises(KVPoolExhausted, match="injected exhaustion"):
            kv.alloc("r", 2)
    finally:
        pfaults.disarm()
    assert kv.leak_check() is None and kv.used_pages == 0
    assert kv.alloc("r", 2) == [1, 2]
    assert kv.occupancy() == pytest.approx(2 / 7)


# -- a watchdog abort through poll(now=...) --------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _hold_step(which, eng, n):
    """Hold the engine's n-th step inside its watchdog arm until
    ``gate`` is set; ``entered`` is set when it gets there."""
    entered, gate = threading.Event(), threading.Event()
    calls = [0]

    def hold():
        calls[0] += 1
        if calls[0] == n:
            entered.set()
            assert gate.wait(60.0)

    if which == "jax":
        make = eng._make_step

        def make_held():
            fn = make()

            def step(*a):
                hold()
                return fn(*a)
            return step

        eng._make_step = make_held
    else:
        inputs = eng._inputs

        def inputs_held(*a):
            hold()
            return inputs(*a)

        eng._inputs = inputs_held
    return entered, gate


def _abort(which, model, tmp_path, monkeypatch):
    Engine, Config, faults, metrics, trace, wd_mod = PKG[which]
    monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path / which))
    before = _metrics(metrics)
    eng = Engine(model=model, config=Config(**CFG))
    clk = _Clock()
    eng.watchdog = wd_mod.StepWatchdog(
        floor_s=1.0, cold_floor_s=1.0, k=10.0, abort=eng._on_wedged,
        threaded=False, clock=clk, name="generation")
    entered, gate = _hold_step(which, eng, 3)
    first = [eng.submit(_prompt(n, 400 + n), 10) for n in (5, 9, 14)]
    eng.start()
    try:
        assert entered.wait(60.0)
        eng.watchdog.poll(now=clk.t + 100.0)       # warn, stack dump, abort
        stages = [e["stage"] for e in eng.watchdog.events]
        fates = []
        for r in first:
            with pytest.raises(Exception, match="wedged"):
                r.result(timeout=60)
            fates.append((r.outcome, len(r.tokens_so_far())))
        assert eng.kv.leak_check() is None and eng.kv.used_pages == 0
        gate.set()                                  # the stale step returns
        nxt = [np.asarray(eng.generate(_prompt(n, 500 + n), 6,
                                       timeout=120)).tolist()
               for n in (4, 10)]
        assert eng.drain(30.0)
        assert eng.kv.leak_check() is None and eng.kv.used_pages == 0
        with open(eng.flight.dump_paths[-1]) as f:
            doc = json.load(f)
    finally:
        gate.set()
        eng.stop()
    shape = (sorted(doc), doc["trigger"], sorted(doc["engine"]["stats"]),
             [sorted(r) for r in doc["records"]],
             [r["outcome"] for r in doc["records"]])
    return stages, fates, nxt, shape, _delta(before, _metrics(metrics))


def test_watchdog_abort_fails_streams_and_the_next_ones_match(models, tmp_path,
                                                              monkeypatch):
    jm, port = models
    want = _abort("jax", jm, tmp_path, monkeypatch)
    got = _abort("port", port, tmp_path, monkeypatch)
    stages, fates, nxt, shape, delta = got
    assert stages == ["warn", "stack_dump", "abort"] == want[0]
    assert fates == want[1]
    assert all(o == "wedged" for o, _ in fates)
    assert nxt == want[2]
    assert shape[:2] == want[3][:2]
    assert shape[3:] == want[3][3:]
    assert set(want[3][2]) <= set(shape[2])   # the port's stats add keys
    assert shape[1] == "watchdog_abort"
    assert delta == want[4]
    assert delta[("dl4jtpu_watchdog_stalls_total",
                  (("stage", "abort"),), "value")] == 1
    assert delta[("dl4jtpu_generation_streams_total",
                  (("outcome", "wedged"),), "value")] == 3
    assert delta[("dl4jtpu_flight_dumps_total",
                  (("trigger", "watchdog_abort"),), "value")] == 1


def test_a_capture_is_armed_cold_from_the_snapshot_it_runs_on(models,
                                                               monkeypatch):
    """On the graph route, the dispatch decides from the parameter
    snapshot it runs on whether it captures: a new tree landing between
    a step's warm arm and its dispatch re-arms the step with the cold
    floor and feeds no sample to the EWMA; a replay keeps its warm arm
    and feeds one, and waits for the previous input copy before it
    writes the pinned buffer again."""
    from deeplearning4j_tpu_torch.runtime import kernels
    from deeplearning4j_tpu_torch.serving import generation as gen_mod

    _, port = models
    eng = GenerationEngine(port, GenerationConfig(**CFG))
    eng.submit(_prompt(6, 1), 8)
    eng._admit_to_slot(eng._loop_gen, 0,
                       eng.queue.take_batch(1, 0.0, eng._stop)[0])
    n_rows = CFG["slots"]

    class Program:                  # a capture whose replay emits token 0
        def __init__(self, fn, inputs, keep):
            self.inputs, self.keep = inputs, keep

        def replay(self):
            return torch.zeros(n_rows, VOCAB), torch.zeros(n_rows, dtype=torch.long)

    waits = []

    class Event:
        def record(self):
            pass

        def synchronize(self):
            waits.append(1)

    empty = torch.empty
    monkeypatch.setattr(gen_mod, "CapturedProgram", Program)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch, "empty",
                        lambda *a, pin_memory=False, **k: empty(*a, **k))
    monkeypatch.setattr(kernels, "route", lambda device: "kernel")
    log = []
    arm, disarm = eng.watchdog.arm, eng.watchdog.disarm
    monkeypatch.setattr(eng.watchdog, "arm", lambda it, n_steps=1, cold=False: (
        log.append(("arm", cold)), arm(it, n_steps=n_steps, cold=cold)))
    monkeypatch.setattr(eng.watchdog, "disarm", lambda dur=None: (
        log.append(("disarm", dur is not None)), disarm(dur)))
    inputs = eng._inputs
    swap = [False]

    def swapping_inputs(*a):
        if swap[0]:                         # a new tree after the warm arm
            port._compute = None
        return inputs(*a)

    monkeypatch.setattr(eng, "_inputs", swapping_inputs)
    eng._decode_step(eng._loop_gen)         # the first capture
    eng._decode_step(eng._loop_gen)         # a replay
    swap[0] = True
    eng._decode_step(eng._loop_gen)         # the swap: a capture again
    swap[0] = False
    eng._decode_step(eng._loop_gen)         # a replay of the new graph
    capture = [("arm", False), ("arm", True), ("disarm", False)]
    replay = [("arm", False), ("disarm", True)]
    assert log == capture + replay + capture + replay
    st = eng.stats()
    assert (st["graph_captures"], st["graph_recaptures"]) == (2, 1)
    assert len(waits) == 2
    eng.kv.release(eng._slot_req[0].rid)


def test_a_stale_loop_neither_writes_nor_disarms_after_an_abort(models,
                                                                tmp_path,
                                                                monkeypatch):
    """The held step's loop wakes after the abort: it enqueues nothing
    (the pools keep the new loop's rows) and leaves the new loop's
    watchdog arm in place."""
    monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
    _, port = models
    eng = GenerationEngine(port, GenerationConfig(**CFG))
    clk = _Clock()
    eng.watchdog = pwatchdog.StepWatchdog(
        floor_s=1.0, cold_floor_s=1.0, abort=eng._on_wedged, threaded=False,
        clock=clk, name="generation")
    entered, gate = _hold_step("port", eng, 2)
    req = eng.submit(_prompt(6, 1), 8)
    dispatched = []
    run = eng._run
    eng._run = lambda c, host, **kw: dispatched.append(c) or run(c, host, **kw)
    eng.start()
    try:
        assert entered.wait(60.0)
        old_gen = eng._loop_gen
        eng.watchdog.poll(now=100.0)
        assert req.outcome == "wedged"
        n_before = len(dispatched)
        eng._wd_arm(eng._loop_gen)            # the new loop's arm
        gate.set()
        for _ in range(200):                  # the stale thread finishes
            if not any(t.is_alive() and t is not eng._thread
                       for t in threading.enumerate()
                       if t.name == "dl4j-torch-generation"):
                break
            threading.Event().wait(0.01)
        assert len(dispatched) == n_before
        assert eng._wd_owner == eng._loop_gen != old_gen
        assert eng.watchdog._armed
        eng._wd_disarm(eng._loop_gen, None)
    finally:
        gate.set()
        eng.stop()
    assert eng.kv.leak_check() is None


def test_concurrent_clients_keep_every_count(models):
    """Eight client threads, a short switch interval, and a ``kv.alloc``
    plan that rejects some admissions: every stream settles exactly
    once, the engine's outcome counts equal the registry's, and no page
    leaks."""
    import sys

    eng = GenerationEngine(models[1], GenerationConfig(**CFG)).start()
    fam = pmetrics.registry().counter("dl4jtpu_generation_streams_total")
    before = {o: fam.value(outcome=o) for o in ("ok", "kv_exhausted")}
    results, lock = [], threading.Lock()

    def client(i):
        for j in range(5):
            try:
                eng.generate(_prompt(3 + (i + j) % 7, 10 * i + j), 4, timeout=60)
                outcome = "ok"
            except ServingRejected as exc:
                outcome = exc.reason
            with lock:
                results.append(outcome)

    pfaults.arm("kv.alloc:raise:p=0.3,seed=3")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        pfaults.disarm()
        eng.stop()
    assert len(results) == 40 and set(results) <= {"ok", "kv_exhausted"}
    st = eng.stats()["streams"]
    assert st["settled"] == 40
    for o in ("ok", "kv_exhausted"):
        assert (fam.value(outcome=o) - before[o] == results.count(o)
                == st["outcomes"].get(o, 0))
    assert results.count("kv_exhausted") > 0
    assert eng.kv.leak_check() is None and eng.kv.used_pages == 0


def test_engine_takes_exactly_one_of_model_and_server(models):
    with pytest.raises(ValueError, match="exactly one"):
        GenerationEngine()
    with pytest.raises(ValueError, match="exactly one"):
        GenerationEngine(models[1], server=object())


def test_slow_streams_and_health_summary(models):
    eng = GenerationEngine(models[1], GenerationConfig(**CFG)).start()
    try:
        for n in (3, 7, 11):
            eng.generate(_prompt(n, n), 5, timeout=60)
    finally:
        eng.stop()
    slow = eng.slow_streams()
    assert len(slow) == 3
    assert [e["latency_s"] for e in slow] == sorted(
        (e["latency_s"] for e in slow), reverse=True)
    assert set(slow[0]["breakdown_s"]) == set(GEN_BREAKDOWN_SEGMENTS)
    h = eng.health_summary()
    assert h["stream_outcomes"] == {"ok": 3} and h["kv_occupancy"] == 0.0
    st = eng.stats()
    assert st["streams"] == {"settled": 3, "outcomes": {"ok": 3}}
    assert st["flight"]["records"] == 3
    assert st["latency_breakdown"]["sampling"]["seconds_total"] > 0
