"""The port's `runtime/compile_stats.py` and `observe/cost.py` on the CPU.

- `CompileStats` arithmetic (``-``, ``fresh_backend_compiles``,
  ``as_dict``) is the JAX package's.  The port's hooks count what it
  compiles: `kernels.build_all` counts an ``nvcc`` run with its seconds
  and a written library, then on a second call every library as a hit
  with the seconds recorded beside it (a stand-in compiler writes the
  libraries here: this host has no ``nvcc``); a `CapturedProgram` (on
  stand-in CUDA stream and graph objects) counts one capture; the
  registry's collector bridges both into the ``dl4jtpu_compile_*``
  families.
- `observe.cost`: a dense product program counts exactly 2 M N K FLOPs,
  and a transformer's training step exactly its dense products (2 M N K
  forward, 4 M N K backward), its chunked head and its flash kernels'
  work from their shapes — the plain versions the CPU runs are left out
  of the op count.  The MFU, FLOPs and roofline gauges flow after
  analysis with a monkeypatched peak; a program run k steps a dispatch
  counts k; the roofline class follows the ridge; `program_table` has
  the JAX package's keys; the registry prunes a dead model and an
  evicted program.  The peak table has no TPU row.
"""

import gc
import os
import stat
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import SequentialModel as JaxSequentialModel
from deeplearning4j_tpu.nn.activations import Activation
from deeplearning4j_tpu.nn.conf import InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu.nn.losses import Loss
from deeplearning4j_tpu.observe import cost as jcost
from deeplearning4j_tpu.runtime import compile_stats as jcs
from deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.observe import cost, registry, tracer
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.runtime import compile_stats, graphs, kernels
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

torch.set_num_threads(1)

FIELDS = ("jit_cache_misses", "backend_compiles", "compile_secs",
          "persistent_cache_hits", "persistent_cache_puts", "compile_secs_saved")


# -- compile stats ---------------------------------------------------------------


@pytest.mark.parametrize("a,b", [((7, 5, 2.5, 3, 2, 1.25), (2, 1, 0.5, 1, 0, 0.25)),
                                 ((0,) * 6, (1, 2, 0.123456, 0, 1, 0.00004))])
def test_compile_stats_arithmetic_is_the_jax_packages(a, b):
    pa, pb = (compile_stats.CompileStats(*v) for v in (a, b))
    ja, jb = (jcs.CompileStats(*v) for v in (a, b))
    assert (pa - pb).as_dict() == (ja - jb).as_dict()
    assert pa.fresh_backend_compiles == ja.fresh_backend_compiles == a[1] - a[3]
    assert list(pa.as_dict()) == list(ja.as_dict())


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in compiler that writes the ``-o`` file, and a fresh build
    directory."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\nimport sys\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "open(out, 'wb').write(b'lib')\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(kernels, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "build_dir", lambda: tmp_path / "build")
    return tmp_path / "build"


def test_builds_and_up_to_date_libraries_count(fake_nvcc):
    n = len(kernels.SIGNATURES)
    s0 = compile_stats.snapshot()
    paths = kernels.build_all()
    built = compile_stats.snapshot() - s0
    assert built.backend_compiles == built.persistent_cache_puts == n
    assert built.fresh_backend_compiles == n and built.persistent_cache_hits == 0
    assert built.compile_secs > 0 and built.jit_cache_misses == 0
    recorded = sum(float(p.with_suffix(".secs").read_text()) for p in paths.values())
    assert recorded == pytest.approx(built.compile_secs, rel=1e-5)
    s1 = compile_stats.snapshot()
    kernels.build_all()
    warm = compile_stats.snapshot() - s1
    assert warm.fresh_backend_compiles == 0 and warm.persistent_cache_hits == n
    assert warm.compile_secs == 0 and warm.persistent_cache_puts == 0
    assert warm.compile_secs_saved == pytest.approx(recorded, rel=1e-5)
    reg = registry()
    reg.collect()
    snap = compile_stats.snapshot()
    assert reg.counter("dl4jtpu_compile_backend_compiles_total").value() == \
        snap.backend_compiles
    assert reg.counter("dl4jtpu_compile_persistent_cache_hits_total").value() == \
        snap.persistent_cache_hits
    assert "dl4jtpu_compile_seconds_saved_total" in reg.to_prometheus_text()


class _Stream:
    cuda_stream = 0          # the raw handle a capture holds launches by

    def wait_stream(self, other):
        pass


class _Graph:
    def capture_begin(self, pool=None, capture_error_mode=None):
        assert capture_error_mode == "thread_local"

    def capture_end(self):
        pass

    def replay(self):
        pass


def test_a_capture_counts_one_jit_cache_miss(monkeypatch):
    """`CapturedProgram` on stand-in CUDA objects (this host has no
    card): one construction is one capture, replays are not."""
    import contextlib

    monkeypatch.setattr(torch.cuda, "Stream", lambda device: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    s0 = compile_stats.snapshot()
    prog = graphs.CapturedProgram(lambda x: x * 2, [torch.ones(3)])
    prog.replay()
    prog.replay()
    spent = compile_stats.snapshot() - s0
    assert spent.jit_cache_misses == 1 and spent.backend_compiles == 0
    registry().collect()
    assert registry().counter("dl4jtpu_compile_jit_cache_misses_total").value() == \
        compile_stats.snapshot().jit_cache_misses


# -- cost ---------------------------------------------------------------------------


class _Owner:
    params = None


def test_dense_product_program_counts_exactly_2mnk():
    m, k, n = 64, 256, 128
    owner = _Owner()
    fn = cost.registry().register(owner, "probe", ("probe",),
                                  lambda x, w: x @ w, live=lambda: True)
    x, w = torch.randn(m, k), torch.randn(k, n)
    fn(x, w)
    rec = fn._cost_record
    rec.ensure_analysis()
    assert rec.analysis == "ok" and rec.flops == 2 * m * n * k
    # x and w read, y written, once each (f32)
    assert rec.bytes_accessed == 4 * (m * k + k * n + m * n)
    assert rec.signature == f"float32[{m}, {k}] float32[{k}, {n}]"
    assert rec.dispatches == 1 and rec.kernel_work == {}


VOCAB, D, HEADS, LAYERS, B, T, CHUNK = 50, 32, 2, 2, 2, 16, 64


def _model(seed=1):
    return TransformerEncoder(vocab_size=VOCAB, d_model=D, n_heads=HEADS,
                              n_layers=LAYERS, causal=True, chunked_vocab_loss=True,
                              vocab_chunk=CHUNK, seed=seed).init_model(device="cpu")


def _batch(seed=0):
    ids = np.random.default_rng(seed).integers(0, VOCAB, (B, T))
    return DataSet(ids, np.roll(ids, -1, axis=1))


def _train_records(model):
    return [r for r in cost.analyze_model(model) if r.kind == "train"]


def test_training_step_counts_its_products_and_kernels_exactly():
    model = _model()
    model.fit_batch(_batch())
    rec, = _train_records(model)
    m, dh = B * T, D // HEADS
    dense = LAYERS * (4 * D * D + 2 * D * 4 * D)
    head = 8 * m * D * (-(-VOCAB // CHUNK) * CHUNK)
    pairs = B * HEADS * T * (T + 1) // 2
    work = {"flash_fwd": (4 * dh * pairs), "flash_bwd_dq": 6 * dh * pairs,
            "flash_bwd_dkdv": 8 * dh * pairs}
    assert rec.flops == 6 * m * dense + head + LAYERS * sum(work.values())
    for name, flops in work.items():
        calls, got, _ = rec.kernel_work[name]
        assert calls == LAYERS and got == LAYERS * flops
    assert rec.kernel_work["flash_fwd"][2] == LAYERS * fa.flash_fwd_work(
        B * HEADS, T, dh, True, 4)[0][2]
    assert rec.signature.startswith("float32[") and rec.dispatches == 1


def test_the_plain_route_counts_the_kernels_work_not_its_ops():
    q = torch.randn(4, 32, 16)
    owner = _Owner()
    fn = cost.registry().register(owner, "probe", ("fa",),
                                  lambda q: fa.flash_fwd(q, q, q, causal=False)[0],
                                  live=lambda: True)
    fn(q)
    rec = fn._cost_record
    rec.ensure_analysis()
    (_, flops, nbytes), = fa.flash_fwd_work(4, 32, 16, False, 4)
    assert rec.flops == flops and rec.bytes_accessed == nbytes
    assert rec.kernel_work == {"flash_fwd": [1, float(flops), float(nbytes)]}


def test_mfu_and_flops_gauges_flow_after_analysis(monkeypatch):
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("DL4J_TPU_PEAK_MEMBW", "1e11")
    model = _model()
    model.fit_batch(_batch())
    rec, = _train_records(model)
    reg = registry()
    flops_before = reg.counter("dl4jtpu_step_model_flops_total").value()
    steps_before = reg.counter("dl4jtpu_train_steps_total").value()
    for i in range(3):
        model.fit_batch(_batch(i + 1))
    assert reg.counter("dl4jtpu_step_model_flops_total").value() - flops_before == \
        pytest.approx(3 * rec.flops)
    assert reg.counter("dl4jtpu_train_steps_total").value() - steps_before == 3
    ach = reg.gauge("dl4jtpu_step_achieved_flops_per_sec").value()
    assert ach > 0
    assert reg.gauge("dl4jtpu_step_mfu").value() == pytest.approx(ach / 1e12)
    assert reg.gauge("dl4jtpu_step_bytes_per_sec").value() > 0
    assert reg.gauge("dl4jtpu_step_membw_util").value() > 0
    assert rec.dispatches == 4 and rec.last_dispatch_seconds > 0


def test_a_program_of_k_steps_counts_k_steps_of_flops():
    model = _model()
    model.fit_batch(_batch())
    rec, = _train_records(model)
    reg = registry()
    before = reg.counter("dl4jtpu_step_model_flops_total").value()
    args = {}
    cost.note_step(rec, 0.5, args, n_steps=4)
    assert reg.counter("dl4jtpu_step_model_flops_total").value() - before == \
        pytest.approx(4 * rec.flops)
    assert args["roofline"] in ("compute-bound", "memory-bound")


def test_roofline_follows_the_ridge_and_lands_on_the_step_span(monkeypatch):
    model = _model()
    model.fit_batch(_batch())
    rec, = _train_records(model)
    ai = rec.arithmetic_intensity()
    assert ai > 0
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("DL4J_TPU_PEAK_MEMBW", str(1e12 / (ai / 10)))
    assert rec.roofline() == "compute-bound"
    monkeypatch.setenv("DL4J_TPU_PEAK_MEMBW", str(1e12 / (ai * 10)))
    assert rec.roofline() == "memory-bound"
    t = tracer()
    t.enable()
    try:
        t.clear()
        model.fit_batch(_batch(1))
        steps = [ev for ev in t.to_chrome_trace()["traceEvents"]
                 if ev["name"] == "train_step"]
        assert steps and steps[-1]["args"]["roofline"] == "memory-bound"
    finally:
        t.disable()
        t.clear()


def test_program_table_has_the_jax_packages_keys():
    model = _model()
    model.fit_batch(_batch())
    row = next(r for r in cost.program_table(analyze=True)
               if r["kind"] == "train" and r["flops"])
    jconf = (NeuralNetConfiguration.builder().seed(1).list()
             .layer(OutputLayer(n_out=8, loss=Loss.MSE, activation=Activation.IDENTITY))
             .set_input_type(InputType.feed_forward(16)).build())
    jm = JaxSequentialModel(jconf).init()
    rng = np.random.default_rng(0)
    jm.fit([JaxDataSet(rng.normal(size=(4, 16)).astype(np.float32),
                       rng.normal(size=(4, 8)).astype(np.float32))], epochs=1)
    jrow = next(r for r in jcost.program_table(analyze=True)
                if r["kind"] == "train" and r["flops"])
    assert list(row) == list(jrow)
    rec, = _train_records(model)
    rec.ensure_analysis(memory=True)
    d = rec.as_dict()
    assert d["argument_bytes"] > 0 and d["output_bytes"] > 0
    assert d["analysis"].startswith("partial")      # peak memory: the card's


def test_registry_prunes_dead_models_and_evicted_programs():
    model = _model()
    model.fit_batch(_batch())
    model.fit_batch(_batch(1))
    rec, = _train_records(model)
    assert rec.dispatches == 2
    model._step_fns.clear()
    assert [r for r in cost.registry().programs() if r.owner_ref() is model] == []
    model.fit_batch(_batch(2))
    rec2, = _train_records(model)
    assert rec2.dispatches == 1 and rec2.program_id != rec.program_id
    mid = id(model)
    del model, rec, rec2
    gc.collect()
    assert not any(id(r.owner_ref()) == mid for r in cost.registry().programs()
                   if r.owner_ref() is not None)


def test_peak_table_holds_the_h100_and_the_cpu_nominal_only(monkeypatch, caplog):
    assert set(cost.PEAKS_BY_DEVICE_KIND) == {"NVIDIA H100 80GB HBM3", "cpu"}
    assert cost.PEAKS_BY_DEVICE_KIND["NVIDIA H100 80GB HBM3"] == (989.0e12, 3.35e12)
    monkeypatch.delenv("DL4J_TPU_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("DL4J_TPU_PEAK_MEMBW", raising=False)
    assert cost.peaks(refresh=True) == cost.PEAKS_BY_DEVICE_KIND["cpu"]
    monkeypatch.setattr(cost, "_device_kind", lambda: "Some Card 9000")
    with caplog.at_level("WARNING", logger="deeplearning4j_tpu_torch"):
        cost.peaks(refresh=True)
        cost.peaks(refresh=True)
    assert sum("Some Card 9000" in r.message for r in caplog.records) == 1
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "5e13")
    assert cost.peaks()[0] == 5e13
    assert os.environ["DL4J_TPU_PEAK_FLOPS"] == "5e13"
