"""Rules the port keeps, checked without a GPU.

- The port never imports jax or the JAX package (a fresh interpreter
  imports every module of it, takes a training step, runs the CPU
  engine and a quantized ``output()``, then lists its modules).
- Entry points default to CUDA and raise when there is none; only an
  explicit ``device="cpu"`` runs on the CPU.
- A kernel wrapper never answers a CUDA tensor with its plain version:
  it launches the kernel or raises.  The bf16 flash forward reads its
  inputs through TMA and raises on inputs TMA cannot read.
- A kernel library's name hashes every header its source includes.
"""

import os
import subprocess
import sys
import textwrap

import pytest
import torch

from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.ops import dequant_matmul as dm
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.ops import paged_attention as pa
from deeplearning4j_tpu_torch.quant import quantize
from deeplearning4j_tpu_torch.runtime import backend, kernels
from deeplearning4j_tpu_torch.serving.kv_cache import PagedKVCache
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
        assert "deeplearning4j_tpu_torch.quant.ptq" in mods, mods
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
        p = quantize(m).output(ids)
        assert p.shape == (2, 6, 32) and bool(np.isfinite(p.numpy()).all())
        bad = sorted(n for n in sys.modules
                     if n.split(".")[0] in ("jax", "jaxlib", "deeplearning4j_tpu"))
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


def test_default_device_is_cuda_and_raises_without_it(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        backend.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerEncoder(vocab_size=11, d_model=32, n_heads=2,
                           n_layers=1).init_model()
    with pytest.raises(RuntimeError, match="CUDA"):
        PagedKVCache(n_layers=1, n_heads=2, head_dim=16, num_pages=4,
                     page_size=8)
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
