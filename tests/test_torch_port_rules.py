"""Rules the port keeps, checked without a GPU.

- The port never imports jax, optax, google.protobuf or the JAX package (a fresh
  interpreter imports every module of it, `utils/`, `train/`,
  `observe/` and the serving plane and fleet included, takes a training
  step and analyses its cost, runs the CPU engine, the server with an
  attached engine behind its HTTP front, a prefill/decode fleet and the
  fleet aggregator, and a quantized ``output()``, writes and restores a
  checkpoint zip of each model, trains a masked MoE step, fine-tunes a
  graph with a frozen prefix under listeners and a recovery policy that
  rolls a NaN batch back from a checkpoint store, takes a ZeRO-1
  data-parallel step in a world of one, imports a TF GraphDef through
  its own wire codec and fine-tunes it with SameDiff, then lists its
  modules).
- Entry points default to CUDA and raise when there is none, checkpoint
  restore included; only an explicit ``device="cpu"`` runs on the CPU.
- A kernel wrapper never answers a CUDA tensor with its plain version:
  it launches the kernel or raises.  The bf16 flash forward reads its
  inputs through TMA and raises on inputs TMA cannot read.
- A kernel library's name hashes every header its source includes.
- The speculative verify's chunk attention launches the paged-attention
  kernel on S x C pseudo-slots for a CUDA tensor, or raises; the engine's
  captured step raises when its capture fails, never rerunning eagerly;
  a capture's launches are held and counted once a replay.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.ops import dequant_matmul as dm
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import paged_attention as pa
from deeplearning4j_tpu_torch.quant import quantize
from deeplearning4j_tpu_torch.runtime import backend, kernels
from deeplearning4j_tpu_torch.serving.kv_cache import PagedKVCache
from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

# small shapes: one intra-op thread keeps these files from competing with
# the multi-process tests that share the host under pytest-xdist
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    script = textwrap.dedent("""
        import importlib
        import pkgutil
        import sys
        import numpy as np
        import deeplearning4j_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(
            deeplearning4j_tpu_torch.__path__, "deeplearning4j_tpu_torch.")]
        for name in mods:
            importlib.import_module(name)
        for need in ("quant.ptq", "train.checkpoint", "utils.serde",
                     "nn.weights", "nn.schedules", "serving.speculative",
                     "runtime.faults", "runtime.graphs", "observe",
                     "observe.metrics", "observe.trace", "observe.slo",
                     "runtime.crash", "runtime.watchdog", "serving.flight",
                     "serving.breaker", "serving.batching", "serving.hotswap",
                     "serving.server", "serving.http", "serving.router",
                     "serving.fleet", "observe.fleet", "observe.cost",
                     "runtime.compile_stats", "models.model", "models._cast",
                     "ops.conv", "evaluation.evaluation", "data.normalizers",
                     "data.builtin", "zoo.zoo_model", "zoo.lenet",
                     "zoo.simplecnn", "entry", "bench_lenet",
                     "parallel.expert", "nn.conf.moe", "nn.conf.graph_conf",
                     "nn.conf.layers_nd", "models.computation_graph",
                     "zoo.resnet", "data.prefetch", "train.listeners",
                     "train.early_stopping", "train.transfer",
                     "train.recovery", "train.preemption", "data.quarantine",
                     "observe.health", "evaluation.roc",
                     "evaluation.regression", "evaluation.binary",
                     "runtime.distributed", "runtime.mesh", "parallel.context",
                     "parallel.strategy", "parallel.data_parallel", "parallel.zero",
                     "parallel.compression", "parallel.wrapper",
                     "parallel.collectives", "parallel.pipeline", "parallel.planner",
                     "autodiff.samediff", "autodiff.ops_registry", "autodiff.validation",
                     "modelimport.tensorflow", "modelimport._tf.wire",
                     "modelimport._tf.synthetic", "nlp.wordpiece", "utils.pytree"):
            assert "deeplearning4j_tpu_torch." + need in mods, mods
        from deeplearning4j_tpu_torch.quant import quantize
        from deeplearning4j_tpu_torch.convert import params_from_jax
        from deeplearning4j_tpu_torch.data.dataset import DataSet
        from deeplearning4j_tpu_torch.ops.generation import generate
        from deeplearning4j_tpu_torch.serving.generation import (
            GenerationConfig, GenerationEngine)
        from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder
        m = TransformerEncoder(vocab_size=17, d_model=32, n_heads=2, n_layers=1,
                               chunked_vocab_loss=True).init_model(device="cpu")
        ids = np.arange(12).reshape(2, 6) % 17
        m.fit_batch(DataSet(ids, np.roll(ids, -1, axis=1)))
        assert np.isfinite(m.score_value) and m.iteration == 1
        eng = GenerationEngine(m, GenerationConfig(
            slots=2, page_size=8, num_pages=8, max_pages_per_seq=2)).start()
        try:
            out = eng.generate(np.arange(5) % 17, 3, timeout=60)
        finally:
            eng.stop()
        assert out.shape == (8,)
        from deeplearning4j_tpu_torch.serving.http import ServingHTTPServer
        from deeplearning4j_tpu_torch.serving.server import InferenceServer
        srv = InferenceServer(m).start()
        eng = GenerationEngine(server=srv, config=GenerationConfig(
            slots=2, page_size=8, num_pages=8, max_pages_per_seq=2)).start()
        http = ServingHTTPServer(srv).start()
        try:
            assert srv.infer(ids[0]).shape == (6, 32)
            assert eng.generate(np.arange(5) % 17, 3, timeout=60).shape == (8,)
            from deeplearning4j_tpu_torch.observe import registry
            assert "dl4jtpu_generation_streams_total" in (
                registry().to_prometheus_text())
        finally:
            http.stop()
            eng.stop()
            srv.stop()
        from deeplearning4j_tpu_torch.observe import cost
        from deeplearning4j_tpu_torch.observe.fleet import FleetAggregator
        from deeplearning4j_tpu_torch.serving.fleet import ServingFleet
        assert cost.analyze_model(m)[0].flops > 0
        fleet = ServingFleet(
            lambda: TransformerEncoder(vocab_size=17, d_model=32, n_heads=2,
                                       n_layers=1).init_model(device="cpu"),
            n_replicas=2, roles=["prefill", "decode"],
            generation_config=GenerationConfig(
                slots=2, page_size=8, num_pages=8, max_pages_per_seq=2)).start()
        try:
            assert fleet.generate(np.arange(5) % 17, 3, timeout=60).shape == (8,)
            assert fleet.infer(ids[0]).shape == (6, 17)
        finally:
            fleet.stop()
        FleetAggregator().ingest("w0", {"prom": registry().to_prometheus_text()})
        q = quantize(m)
        p = q.output(ids)
        assert p.shape == (2, 6, 32) and bool(np.isfinite(p.numpy()).all())
        import os, tempfile
        from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer
        for i, model in enumerate((m, q)):
            path = os.path.join(tempfile.mkdtemp(), f"m{i}.zip")
            ModelSerializer.write_model(model, path)
            back = ModelSerializer.restore(path, device="cpu")
            assert back.iteration == 1
        from deeplearning4j_tpu_torch.entry import entry
        from deeplearning4j_tpu_torch.zoo.lenet import LeNet
        lm = LeNet().init_model(device="cpu")
        x = np.zeros((4, 28, 28, 1), np.float32)
        y = np.eye(10, dtype=np.float32)[[0, 1, 2, 3]]
        lm.fit([DataSet(x, y)] * 2, steps_per_execution=2)
        assert lm.iteration == 2 and np.isfinite(lm.score_value)
        assert tuple(quantize(lm).output(x).shape) == (4, 10)
        fwd, args = entry(device="cpu")
        assert tuple(fwd(*args).shape) == (8, 10)
        moe = TransformerEncoder(vocab_size=17, d_model=32, n_heads=2, n_layers=1,
                                 causal=False, moe_experts=2).init_model(device="cpu")
        fm = np.ones(ids.shape, np.float32)
        fm[1, 4:] = 0
        moe.fit_batch(DataSet(ids, np.roll(ids, -1, axis=1), features_mask=fm))
        assert np.isfinite(moe.score_value) and moe.net_state == {}
        assert tuple(moe.output(ids, fm).shape) == (2, 6, 17)
        from deeplearning4j_tpu_torch.data.prefetch import PrefetchIterator
        from deeplearning4j_tpu_torch.zoo.resnet import ResNet50
        class Tiny(ResNet50):
            STAGES, FILTERS = (1,), (4,)
        g = Tiny(num_classes=3, height=8, width=8).init_model(device="cpu")
        xs = np.zeros((2, 8, 8, 3), np.float32)
        ys = np.eye(3, dtype=np.float32)[[0, 2]]
        g.fit(PrefetchIterator([DataSet(xs, ys)], device="cpu"))
        assert g.iteration == 1 and np.isfinite(g.score_value)
        assert tuple(quantize(g).output(xs).shape) == (2, 3)
        # the training tooling: a listener, a frozen layer, a recovery
        # policy over a checkpoint store that rolls back a NaN batch
        from deeplearning4j_tpu_torch.runtime import faults
        from deeplearning4j_tpu_torch.train import (
            CheckpointStore, CollectScoresListener, RecoveryPolicy,
            TrainingListener, TransferLearning)
        tl = TransferLearning.GraphBuilder(g).set_feature_extractor("s0b0_out").build()
        store = CheckpointStore(tempfile.mkdtemp(), keep_last=2, device="cpu")
        class Saver(TrainingListener):
            def iteration_done(self, model, it, epoch, score):
                if it == 1:
                    store.save(model, step=it)
        scores = CollectScoresListener()
        tl.set_listeners(scores, Saver())
        policy = RecoveryPolicy(store, skip_window=0).attach(tl)
        os.environ["DL4JTPU_CRASH_DIR"] = tempfile.mkdtemp()
        faults.arm("data.decode:corrupt:nth=2")
        tl.fit([DataSet(xs, ys)] * 3)
        faults.disarm()
        assert policy.rollbacks == 1 and tl.iteration == 2, policy.events
        assert len(scores.scores) == 3 and np.isfinite(tl.score_value)
        # data parallelism: a world of one, ZeRO-1, through the wrapper
        from deeplearning4j_tpu_torch.parallel import ParallelConfig, ParallelWrapper
        from deeplearning4j_tpu_torch.runtime import distributed
        dpm = Tiny(num_classes=3, height=8, width=8).init_model(device="cpu")
        ParallelWrapper(dpm, ParallelConfig(zero=1)).fit([DataSet(xs, ys)])
        assert dpm.iteration == 1 and dpm._zero_placement is not None
        distributed.shutdown()
        # SameDiff over an imported TF graph: the port's codec, no protobuf
        from deeplearning4j_tpu_torch.autodiff import TrainingConfig
        from deeplearning4j_tpu_torch.modelimport._tf.synthetic import (
            build_bert_classifier_graphdef)
        from deeplearning4j_tpu_torch.modelimport.tensorflow import import_graph
        from deeplearning4j_tpu_torch.nn.updaters import Adam
        sd = import_graph(build_bert_classifier_graphdef(
            vocab=16, d_model=8, n_layers=1, n_heads=2, seq_len=4, batch=2),
            trainable=True, device="cpu")
        sd.loss.softmax_cross_entropy(sd["logits"], sd.placeholder("y"), name="loss")
        sd.set_training_config(TrainingConfig(updater=Adam(1e-3), loss_variable="loss"))
        assert np.isfinite(sd.fit_batch({"ids": np.ones((2, 4), np.int32),
                                         "y": np.eye(2, dtype=np.float32)}))
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib", "optax",
                                            "deeplearning4j_tpu")
                     or n == "google.protobuf" or n.startswith("google.protobuf."))
        print("FORBIDDEN", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "FORBIDDEN []" in res.stdout, res.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda_and_raises_without_it(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        backend.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerEncoder(vocab_size=11, d_model=32, n_heads=2,
                           n_layers=1).init_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(n_layers=1, n_heads=2, head_dim=16, num_pages=4,
                     page_size=8)
    model = TransformerEncoder(vocab_size=11, d_model=32, n_heads=2,
                               n_layers=1).init_model(device="cpu")
    path = str(tmp_path / "m.zip")
    ModelSerializer.write_model(model, path)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelSerializer.restore(path)
    assert backend.resolve_device("cpu").type == "cpu"
    assert not backend.backend("cpu").is_cuda


def test_compute_dtype_follows_the_device():
    conf = TransformerEncoder(vocab_size=11, d_model=32, n_heads=2,
                              n_layers=1).conf()
    assert SequentialModel(conf, device="cpu").compute_dtype == torch.float32
    assert backend.backend("cpu").compute_dtype == torch.float32


def test_route_sends_cuda_to_the_kernel_and_cpu_to_the_plain_version():
    assert kernels.route(torch.device("cpu")) == "plain"
    assert kernels.route(torch.device("cuda")) == "kernel"
    with pytest.raises(ValueError):
        kernels.route(torch.device("meta"))


class _FakeLib:
    """Stands in for a loaded kernel library: records calls, returns a
    given cudaError_t."""

    def __init__(self, rc=0):
        self.rc, self.calls = rc, []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append(name)
            return self.rc
        return fn


@pytest.fixture
def claims_cuda(monkeypatch):
    """Every tensor routes to the kernel; the plain versions explode."""
    monkeypatch.setattr(kernels, "route", lambda device: "kernel")
    monkeypatch.setattr(kernels, "current_stream", lambda device: 0)

    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")

    monkeypatch.setattr(fa, "flash_fwd_plain", boom)
    monkeypatch.setattr(fa, "flash_bwd_plain", boom)
    monkeypatch.setattr(pa, "paged_attention_plain", boom)
    monkeypatch.setattr(dm, "dequant_matmul_plain", boom)


def _paged_args(quant=False):
    pools = (torch.zeros((4, 8, 2, 32), dtype=torch.int8 if quant else torch.float32)
             for _ in range(2))
    args = [torch.zeros((2, 2, 32)), *pools,
            torch.zeros((2, 3), dtype=torch.int32),
            torch.tensor([3, 0], dtype=torch.int32)]
    if quant:
        args += [torch.ones((4, 8, 2)), torch.ones((4, 8, 2))]
    return args


def test_wrappers_launch_for_cuda_tensors(claims_cuda, monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "library", lambda stem: lib)
    before = kernels.launches()
    q = torch.zeros((2, 16, 32))
    out, lse = fa.flash_fwd(q, q, q, causal=True)
    assert out.shape == q.shape and lse.shape == (2, 16)
    pa.paged_attention_fwd(*_paged_args())
    pa.paged_attention_fwd(*_paged_args(quant=True))
    assert lib.calls == ["dl4j_flash_fwd", "dl4j_paged_attention",
                         "dl4j_paged_attention"]
    after = kernels.launches()
    for name in ("flash_fwd", "paged_attention_fwd", "paged_attention_fwd_int8"):
        assert after.get(name, 0) == before.get(name, 0) + 1


def test_wrappers_raise_instead_of_falling_back(claims_cuda, monkeypatch):
    q = torch.zeros((2, 16, 32))
    monkeypatch.setattr(kernels, "library", lambda stem: _FakeLib(rc=98))
    with pytest.raises(RuntimeError, match="error 98"):
        fa.flash_fwd(q, q, q, causal=False)
    with pytest.raises(RuntimeError, match="error 98"):
        pa.paged_attention_fwd(*_paged_args())

    def no_nvcc(stem):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernels, "library", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        fa.flash_fwd(q, q, q, causal=True)
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros((2, 16, 24))
        fa.flash_fwd(x, x, x, causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((2, 32, 16)).transpose(1, 2)
        fa.flash_fwd(t, t, t, causal=True)


def test_bf16_flash_fwd_takes_the_views_tma_reads(claims_cuda, monkeypatch):
    """bf16 B1 reads q, k, v through TMA: contiguous, from 16-byte aligned
    starts; anything else raises before a launch."""
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "library", lambda stem: lib)
    bf = torch.bfloat16
    q = torch.zeros((2, 16, 32), dtype=bf)
    out, lse = fa.flash_fwd(q, q, q, causal=True)
    assert out.shape == (2, 16, 32) and out.is_contiguous() and lse.shape == (2, 16)
    assert lib.calls == ["dl4j_flash_fwd"]
    off = torch.zeros(2 * 16 * 32 + 1, dtype=bf)[1:].view(2, 16, 32)   # 2 bytes off
    rows = torch.zeros((2, 16, 40), dtype=bf)[..., :32]                 # padded rows
    cols = torch.zeros((2, 32, 16), dtype=bf).transpose(1, 2)
    for bad, match in ((off, "16-byte"), (rows, "contiguous"), (cols, "contiguous")):
        for args in ((bad, q, q), (q, bad, q), (q, q, bad)):
            with pytest.raises(ValueError, match=match):
                fa.flash_fwd(*args, causal=False)
    assert lib.calls == ["dl4j_flash_fwd"]
    # f32 reads plain loads: a 4-byte aligned start is enough
    x = torch.zeros(2 * 16 * 32 + 1)[1:].view(2, 16, 32)
    fa.flash_fwd(x, x, x, causal=True)
    assert lib.calls == ["dl4j_flash_fwd"] * 2


def test_library_name_hashes_the_headers_its_source_includes(tmp_path,
                                                            monkeypatch):
    assert kernels.sources("flash_fwd")[1:] == [kernels.CSRC / "wgmma.cuh"]
    monkeypatch.setattr(kernels, "CSRC", tmp_path)
    (tmp_path / "a.cu").write_text('#include <stdint.h>\n#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text('#pragma once\n #  include "g.cuh"\n')
    (tmp_path / "g.cuh").write_text('#include "h.cuh"\nint g;\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    assert kernels.sources("a") == [tmp_path / n for n in ("a.cu", "h.cuh", "g.cuh")]
    before = {stem: kernels._lib_path(stem) for stem in ("a", "b")}
    (tmp_path / "g.cuh").write_text('#include "h.cuh"\nint g = 1;\n')
    assert kernels._lib_path("a") != before["a"]
    assert kernels._lib_path("b") == before["b"]


def _bwd_args(t=16, d=32):
    q = torch.zeros((2, t, d))
    return q, q, q, q, torch.zeros((2, t)), torch.ones((2, t, d))


def test_flash_bwd_launches_both_kernels_for_cuda_tensors(claims_cuda,
                                                          monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "library", lambda stem: lib)
    before = kernels.launches()
    dq, dk, dv = fa.flash_bwd(*_bwd_args(), causal=True)
    assert dq.shape == dk.shape == dv.shape == (2, 16, 32)
    assert lib.calls == ["dl4j_flash_bwd_dq", "dl4j_flash_bwd_dkdv"]
    after = kernels.launches()
    for name in ("flash_bwd_dq", "flash_bwd_dkdv"):
        assert after.get(name, 0) == before.get(name, 0) + 1
    # the autograd Function reaches both kernels through its backward
    q = torch.zeros((2, 16, 32), requires_grad=True)
    out, _ = fa.FlashAttention.apply(q, q, q, True)
    out.sum().backward()
    assert lib.calls[2:] == ["dl4j_flash_fwd", "dl4j_flash_bwd_dq",
                             "dl4j_flash_bwd_dkdv"]


def test_flash_bwd_raises_instead_of_falling_back(claims_cuda, monkeypatch):
    lib = _FakeLib(rc=98)
    monkeypatch.setattr(kernels, "library", lambda stem: lib)
    with pytest.raises(RuntimeError, match="flash_bwd_dq.*error 98"):
        fa.flash_bwd(*_bwd_args(), causal=False)
    assert lib.calls == ["dl4j_flash_bwd_dq"]

    def no_nvcc(stem):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernels, "library", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        fa.flash_bwd(*_bwd_args(), causal=True)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_bwd(*_bwd_args(d=24), causal=True)
    with pytest.raises(ValueError, match="contiguous"):
        q, k, v, out, lse, g = _bwd_args()
        fa.flash_bwd(q, k, v.transpose(1, 2).contiguous().transpose(1, 2),
                     out, lse, g, causal=True)


def test_a_host_without_nvcc_cannot_build(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setattr(kernels.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.nvcc_path()


def _dm_args(m=5, k=32, n=24):
    return (torch.zeros((2, m, k)), torch.zeros((k, n), dtype=torch.int8),
            torch.ones(n))


def test_dequant_matmul_launches_for_cuda_tensors(claims_cuda, monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "library", lambda stem: lib)
    before = kernels.launches().get("dequant_matmul", 0)
    y = dm.dequant_matmul(*_dm_args())
    assert y.shape == (2, 5, 24) and y.dtype == torch.float32
    assert lib.calls == ["dl4j_dequant_matmul"]
    assert kernels.launches()["dequant_matmul"] == before + 1


def test_quantized_output_launches_one_dequant_matmul_per_product(
        claims_cuda, monkeypatch):
    """The chip check's count: six products a block plus the head, one
    flash forward a block; the quantized embedding launches nothing."""
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "library", lambda stem: lib)
    model = quantize(TransformerEncoder(
        vocab_size=23, d_model=32, n_heads=2, n_layers=3).init_model(device="cpu"))
    kernels.reset_launches()
    model.output(torch.zeros((2, 7), dtype=torch.int64))
    assert kernels.launches() == {"dequant_matmul": 6 * 3 + 1, "flash_fwd": 3}


def test_dequant_matmul_raises_instead_of_falling_back(claims_cuda, monkeypatch):
    monkeypatch.setattr(kernels, "library", lambda stem: _FakeLib(rc=98))
    before = kernels.launches().get("dequant_matmul", 0)
    with pytest.raises(RuntimeError, match="dequant_matmul.*error 98"):
        dm.dequant_matmul(*_dm_args())
    assert kernels.launches().get("dequant_matmul", 0) == before

    def no_nvcc(stem):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(kernels, "library", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        dm.dequant_matmul(*_dm_args())
    with pytest.raises(ValueError, match="contiguous"):
        x, q, scale = _dm_args()
        dm.dequant_matmul(x, q.t().contiguous().t(), scale)


def test_paged_attention_takes_every_multiple_of_16_head_dim(claims_cuda,
                                                             monkeypatch):
    """B4 is built for every head dim that is a multiple of 16 from 16 to
    256; any other raises before a launch, and says why."""
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "library", lambda stem: lib)
    assert pa.PAGED_HEAD_DIMS == tuple(range(16, 257, 16))
    for dh in (16, 48, 80, 256):
        pools = [torch.zeros((4, 8, 2, dh)) for _ in range(2)]
        pa.paged_attention_fwd(torch.zeros((2, 2, dh)), *pools,
                               torch.zeros((2, 3), dtype=torch.int32),
                               torch.tensor([3, 0], dtype=torch.int32))
    assert lib.calls == ["dl4j_paged_attention"] * 4
    for dh in (8, 24, 272):
        pools = [torch.zeros((4, 8, 2, dh)) for _ in range(2)]
        with pytest.raises(ValueError, match="multiple of 16"):
            pa.paged_attention_fwd(torch.zeros((2, 2, dh)), *pools,
                                   torch.zeros((2, 3), dtype=torch.int32),
                                   torch.tensor([3, 0], dtype=torch.int32))
    assert lib.calls == ["dl4j_paged_attention"] * 4


class _ArgLib:
    """A fake kernel library that keeps each call's arguments."""

    def __init__(self):
        self.args = []

    def __getattr__(self, name):
        def fn(*args):
            self.args.append(args)
            return 0
        return fn


@pytest.mark.parametrize("m,n,route", [(64, 48, 0), (65, 48, 1), (65, 40, 0),
                                       (200, 320, 1), (1, 4096, 0)])
def test_dequant_matmul_picks_its_route_by_shape(claims_cuda, monkeypatch,
                                                 m, n, route):
    """More than 64 rows with N a multiple of 16 (TMA's row stride) take
    the tensor-core route with x's bf16 parts as scratch; the rest take
    the rows route, with partial sums as scratch when K is split."""
    lib = _ArgLib()
    monkeypatch.setattr(kernels, "library", lambda stem: lib)
    k = 64
    y = dm.dequant_matmul(torch.zeros((m, k)), torch.zeros((k, n), dtype=torch.int8),
                          torch.ones(n))
    assert y.shape == (m, n)
    (args,) = lib.args
    x_parts, partial, mm, nn, kk, got, splits = args[4:11]
    assert (mm, nn, kk, got) == (m, n, k, route)
    if route:
        assert x_parts is not None and partial is None and splits == 1
    else:
        assert x_parts is None and splits == dm.row_splits(m, n, k)
        assert (partial is not None) == (splits > 1)


def test_paged_attention_passes_its_split_and_workspace(claims_cuda, monkeypatch):
    """B4's wrapper hands the kernel `split_plan`'s head group and chunk,
    a partials workspace of S x chunks x H x (Dh + 2) floats and the ticket
    counters, without reading seq_lens."""
    lib = _ArgLib()
    monkeypatch.setattr(kernels, "library", lambda stem: lib)
    for quant in (False, True):
        args = _paged_args(quant)
        pa.paged_attention_fwd(*args)
        (call,) = lib.args[-1:]
        s, h, dh, n_pages, ps, mp, hg, ppc, int8 = call[10:19]
        assert (s, h, dh, n_pages, ps, mp, int8) == (2, 2, 32, 4, 8, 3, int(quant))
        assert (hg, ppc) == pa.split_plan(2, 32, 8, quant)
        assert call[8] is not None and call[9] is not None


def test_paged_attention_rejects_what_the_copies_cannot_read(claims_cuda, monkeypatch):
    """Pools, scales and q must start 16-byte aligned (cp.async.bulk and
    TMA read 16-byte units); int8 pools need page_size x heads a multiple
    of 4 (a page's scales in 16-byte units); pages of more than 256 rows
    pass a TMA box."""
    lib = _FakeLib()
    monkeypatch.setattr(kernels, "library", lambda stem: lib)
    q, kp, vp, tbl, lens = _paged_args()
    shifted = torch.zeros(kp.numel() + 1)[1:].view(kp.shape)     # 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_attention_fwd(q, shifted, vp, tbl, lens)
    pools = [torch.zeros((4, 6, 3, 32), dtype=torch.int8) for _ in range(2)]
    scales = [torch.ones((4, 6, 3)) for _ in range(2)]
    with pytest.raises(ValueError, match="multiple of 4"):
        pa.paged_attention_fwd(torch.zeros((2, 3, 32)), *pools, tbl, lens, *scales)
    pools = [torch.zeros((2, 264, 2, 32)) for _ in range(2)]
    with pytest.raises(ValueError, match="TMA box"):
        pa.paged_attention_fwd(q, *pools, tbl, lens)
    assert lib.calls == []


def test_chunk_attention_launches_on_pseudo_slots(claims_cuda, monkeypatch):
    """S x C pseudo-slots: the table's rows repeated C times, the lengths
    flattened, one launch counted as ``paged_attention_chunk``; inside a
    `ticket_scope` the launch takes the scope's counters."""
    lib = _ArgLib()
    monkeypatch.setattr(kernels, "library", lambda stem: lib)
    q, kp, vp, tbl, _ = _paged_args()
    tbl = torch.tensor([[1, 2, 0], [3, 0, 0]], dtype=torch.int32)
    attend = torch.tensor([[4, 5, 6], [0, 0, 0]], dtype=torch.int32)
    before = kernels.launches()
    tickets = torch.zeros(pa.tickets_needed(6, 2, 32, 8, False), dtype=torch.int32)
    with pa.ticket_scope(tickets):
        out = pa.paged_attention_chunk(torch.zeros((2, 3, 2, 32)), kp, vp, tbl, attend)
    assert out.shape == (2, 3, 2, 32)
    (call,) = lib.args
    assert call[10] == 6                                # slots
    assert call[9] == tickets.data_ptr()
    after = kernels.launches()
    assert after.get("paged_attention_chunk", 0) == before.get("paged_attention_chunk", 0) + 1
    assert after.get("paged_attention_fwd", 0) == before.get("paged_attention_fwd", 0)
    with pytest.raises(ValueError, match="ticket counters"):
        with pa.ticket_scope(torch.zeros(2, dtype=torch.int32)):
            pa.paged_attention_chunk(torch.zeros((2, 3, 2, 32)), kp, vp, tbl, attend)


def test_chunk_attention_raises_instead_of_falling_back(claims_cuda, monkeypatch):
    monkeypatch.setattr(kernels, "library", lambda stem: _FakeLib(rc=98))
    q, kp, vp, tbl, _ = _paged_args()
    attend = torch.ones((2, 3), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="error 98"):
        pa.paged_attention_chunk(torch.zeros((2, 3, 2, 32)), kp, vp, tbl, attend)
    with pytest.raises(RuntimeError, match="error 98"):
        pa.paged_attention_chunk(
            torch.zeros((2, 3, 2, 32)),
            *[torch.zeros((4, 8, 2, 32), dtype=torch.int8) for _ in range(2)], tbl,
            attend, k_scale=torch.ones((4, 8, 2)), v_scale=torch.ones((4, 8, 2)))


def test_a_capture_holds_its_launches_and_each_replay_counts_them():
    before = kernels.launches().get("probe_kernel", 0)
    with kernels.holding_launches() as held:
        kernels.check_launch("probe_kernel", 0)
        kernels.check_launch("probe_kernel", 0)
        with pytest.raises(RuntimeError, match="nest"):
            with kernels.holding_launches():
                pass
    assert held == {"probe_kernel": 2}
    assert kernels.launches().get("probe_kernel", 0) == before
    kernels.count_replay(held)
    kernels.count_replay(held)
    assert kernels.launches()["probe_kernel"] == before + 4


def test_a_failing_capture_raises_and_never_reruns_eagerly(monkeypatch):
    """On CUDA the engine's steps are graph replays; when the capture
    fails the step raises, and the stream's dispatch fails with it —
    the eager program is not run in its place."""
    from deeplearning4j_tpu_torch.serving import generation as gen_mod

    m = TransformerEncoder(vocab_size=17, d_model=32, n_heads=2,
                           n_layers=1).init_model(device="cpu")
    eng = gen_mod.GenerationEngine(m, gen_mod.GenerationConfig(
        slots=2, page_size=8, num_pages=8, max_pages_per_seq=2, spec_k=2))
    req = eng.submit(np.arange(6) % 17, 5)
    eng._admit_to_slot(eng._loop_gen, 0, eng.queue.take_batch(1, 0.0, eng._stop)[0])

    class RefusedCapture:
        def __init__(self, *a, **k):
            raise RuntimeError("operation not permitted when stream is capturing")

    eager = []
    monkeypatch.setattr(gen_mod, "CapturedProgram", RefusedCapture)
    monkeypatch.setattr(eng, "_run_eager", lambda *a: eager.append(a))
    monkeypatch.setattr(kernels, "route", lambda device: "kernel")
    for c in (1, 3):
        toks = np.zeros((2, c), np.int32)
        with pytest.raises(RuntimeError, match="capturing"):
            eng._run(c, eng._inputs(eng._page_tbl, eng._seq_lens, toks))
    eng._decode_step(eng._loop_gen)
    assert eager == []
    assert req.outcome == "error"
    with pytest.raises(Exception, match="decode step failed"):
        req.result(timeout=1)
    assert eng.kv.leak_check() is None and eng.kv.used_pages == 0


def test_a_capture_collects_first_and_runs_with_the_collector_off(monkeypatch):
    """`CapturedProgram` runs the garbage collector before capturing and
    keeps it off during the capture (a dead graph torn down by a
    collection mid-capture would invalidate it), and turns it back on
    after, also when the capture fails."""
    import contextlib
    import gc

    from deeplearning4j_tpu_torch.runtime import graphs

    seen = []

    class FakeStream:
        cuda_stream = 0

        def wait_stream(self, other):
            pass

    class FakeGraph:
        def capture_begin(self, pool=None, capture_error_mode=None):
            seen.append(("begin", gc.isenabled(), capture_error_mode))

        def capture_end(self):
            seen.append(("end", gc.isenabled()))

    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: FakeStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    collected = []
    real_collect = gc.collect
    monkeypatch.setattr(gc, "collect", lambda *a: collected.append(1) or real_collect(*a))
    assert gc.isenabled()
    prog = graphs.CapturedProgram(lambda x: x + 1, (torch.zeros(2),))
    assert collected and seen == [("begin", False, "thread_local"), ("end", False)]
    assert torch.equal(prog.outputs, torch.ones(2)) and gc.isenabled()

    def failing(x):
        if seen and seen[-1][0] == "begin":      # inside the capture
            raise RuntimeError("capture failed")
        return x

    seen.clear()
    with pytest.raises(RuntimeError, match="capture failed"):
        graphs.CapturedProgram(failing, (torch.zeros(2),))
    assert seen[-1] == ("end", False) and gc.isenabled()
