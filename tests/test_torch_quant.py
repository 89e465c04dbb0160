"""The port's int8 quantization slice against the JAX package, on the CPU.

Inputs are made from numpy seeds and handed to both packages; JAX
outputs pass through ``np.array`` before ``torch.from_numpy``.  The JAX
side runs its Pallas dequant-matmul kernel (B5) in interpret mode
(``DL4JTPU_QUANT_KERNEL=pallas``), the port its plain dequantize-then-dot
version.  Tolerances, with their reasons:

- `quantize_array`: bit identity (the same numpy arithmetic), ties at
  exactly .5 included;
- `dequant_matmul`: max |port - JAX| / max |JAX| < 1e-5, the JAX
  package's own gate between its implementations (f32 both sides, sums
  in another order);
- the quantized transformer (vocab 256, d 64, 4 heads, 2 layers, causal,
  both heads): max |port - JAX| <= 1e-5 * max |JAX|, for the same reason;
  the quantized trees are bit-identical, so a tree carried from JAX and
  one quantized in the port give the same output bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.ops.dequant_matmul import dequant_matmul as jax_dequant_matmul
from deeplearning4j_tpu.quant import dequantize_tree as jax_dequantize_tree
from deeplearning4j_tpu.quant import parity_check as jax_parity_check
from deeplearning4j_tpu.quant import quantize as jax_quantize
from deeplearning4j_tpu.quant import quantized_bytes as jax_quantized_bytes
from deeplearning4j_tpu.quant.qtensor import quantize_array as jax_quantize_array
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.convert import params_from_jax, params_to_numpy
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.ops.dequant_matmul import (
    dequant_matmul,
    dequant_matmul_plain,
)
from deeplearning4j_tpu_torch.quant import (
    QuantizedTensor,
    SCHEME,
    dequantize_tree,
    is_quantized,
    parity_check,
    quantize,
    quantized_bytes,
)
from deeplearning4j_tpu_torch.quant.qtensor import quantize_array
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

# small shapes: one intra-op thread keeps these files from competing with
# the multi-process tests that share the host under pytest-xdist
torch.set_num_threads(1)

VOCAB, D, HEADS, LAYERS = 256, 64, 4, 2
REL = 1e-5


def _host(x):
    return np.array(x)


# -- quantize_array -------------------------------------------------------------


def _assert_same_quantization(w):
    ref = jax_quantize_array(w)
    got = quantize_array(w)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), _host(ref.q))
    np.testing.assert_array_equal(got.scale.numpy().view(np.uint32),
                                  _host(ref.scale).view(np.uint32))
    return got


@pytest.mark.parametrize("shape", [(64, 48), (3, 17, 9), (1000, 7)])
def test_quantize_array_is_bit_identical_on_random_weights(shape):
    w = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    got = _assert_same_quantization(w)
    assert int(got.q.abs().max()) == 127


def test_quantize_array_all_zero_channel_gets_scale_one():
    w = np.random.default_rng(1).standard_normal((32, 6)).astype(np.float32)
    w[:, 2] = 0.0
    got = _assert_same_quantization(w)
    assert got.scale[2].item() == 1.0 and int(got.q[:, 2].abs().max()) == 0
    np.testing.assert_array_equal(got.dequant()[:, 2].numpy(), 0.0)


def test_quantize_array_rounds_exact_ties_to_even():
    # amax 127 gives scale 1.0 and amax 127/8 gives 0.125, both exact, so
    # w / scale lands exactly on the .5 ties below
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -3.5],
                    dtype=np.float32)
    w = np.zeros((9, 2), np.float32)
    w[:8, 0] = ties
    w[8, 0] = 127.0
    w[:8, 1] = ties / 8
    w[8, 1] = 127.0 / 8
    got = _assert_same_quantization(w)
    want = np.array([0, 2, 2, 0, -2, -2, 126, -4, 127])
    np.testing.assert_array_equal(got.q[:, 0].numpy(), want)
    np.testing.assert_array_equal(got.q[:, 1].numpy(), want)


def test_quantize_array_refuses_other_widths_and_scalars():
    with pytest.raises(ValueError, match="int8"):
        quantize_array(np.ones((2, 2), np.float32), bits=4)
    with pytest.raises(ValueError, match="scalar"):
        quantize_array(np.float32(1.0))


# -- dequant_matmul -------------------------------------------------------------


DM_CASES = [((8, 256), 128), ((3, 512), 384), ((1, 1024), 512),
            ((2, 7, 256), 128), ((4, 100), 64)]


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("x_shape,n", DM_CASES)
def test_dequant_matmul_matches_jax(x_shape, n, impl):
    rng = np.random.default_rng(x_shape[-1] + n)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = rng.standard_normal((x_shape[-1], n)).astype(np.float32)
    jq = jax_quantize_array(w)
    ref = _host(jax_dequant_matmul(jax.numpy.asarray(x), jq.q, jq.scale,
                                   impl=impl, interpret=True))
    qt = quantize_array(w)
    out = dequant_matmul(torch.from_numpy(x), qt.q, qt.scale)
    assert out.dtype == torch.float32 and tuple(out.shape) == x_shape[:-1] + (n,)
    rel = np.abs(out.numpy() - ref).max() / np.abs(ref).max()
    assert rel < REL, (impl, x_shape, n, rel)


def test_dequant_matmul_plain_is_dequantize_then_dot():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    qt = quantize_array(rng.standard_normal((64, 24)).astype(np.float32))
    assert torch.equal(dequant_matmul_plain(x, qt.q, qt.scale), x @ qt.dequant())


@pytest.mark.parametrize("case,err,match", [
    ("q_float", TypeError, "int8"),
    ("scale_f64", TypeError, "scale"),
    ("scale_shape", TypeError, "scale"),
    ("k_mismatch", ValueError, "meet q"),
    ("x_bf16", TypeError, "f32"),
])
def test_dequant_matmul_refuses_what_the_kernel_does_not_take(case, err, match):
    x = torch.zeros((4, 32))
    q = torch.zeros((32, 16), dtype=torch.int8)
    scale = torch.ones(16)
    if case == "q_float":
        q = q.float()
    elif case == "scale_f64":
        scale = scale.double()
    elif case == "scale_shape":
        scale = torch.ones(15)
    elif case == "k_mismatch":
        x = torch.zeros((4, 33))
    else:
        x = x.bfloat16()
    with pytest.raises(err, match=match):
        dequant_matmul(x, q, scale)


# -- the slice: quantize, then output() -------------------------------------------


def _zoo(cls, chunked):
    return cls(vocab_size=VOCAB, d_model=D, n_heads=HEADS, n_layers=LAYERS,
               causal=True, seed=7, chunked_vocab_loss=chunked)


def _ids():
    return np.random.default_rng(11).integers(0, VOCAB, (2, 32))


def _hidden():
    return np.random.default_rng(12).standard_normal((2, 32, D)).astype(np.float32)


@pytest.fixture(scope="module", params=[False, True], ids=["rnn_head", "chunked_head"])
def pair(request):
    """A JAX model, its JAX-quantized twin and their outputs on `_ids`,
    with B5 forced to its Pallas kernel (interpret mode on the CPU)."""
    chunked = request.param
    jm = _zoo(JaxTE, chunked).init_model()
    ids = _ids()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DL4JTPU_QUANT_KERNEL", "pallas")
        jq = jax_quantize(jm)
        ref_q = _host(jq.output(ids.astype(np.float32)))
        head = jq.conf.layers[-1]
        hp, h = jq.params[head.name], jax.numpy.asarray(_hidden())
        ref_logits = _host(head.logits(hp, h) if chunked
                           else head.apply(hp, {}, h)[0])
        jparity = jax_parity_check(jm, jq, ids.astype(np.float32))
    port = params_from_jax(jax.tree.map(np.asarray, jm.params),
                           SequentialModel(_zoo(TransformerEncoder, chunked).conf(),
                                           device="cpu"))
    return dict(chunked=chunked, jm=jm, jq=jq, ids=ids, ref_q=ref_q,
                ref_logits=ref_logits, jparity=jparity, port=port,
                pq=quantize(port))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, p))
        else:
            out[p] = v
    return out


def test_quantized_tree_matches_jax_key_for_key_bit_for_bit(pair):
    want = _flat(pair["jq"].params)
    got = _flat(pair["pq"].params)
    assert set(got) == set(want)
    n_quantized = 0
    for path, leaf in want.items():
        mine = got[path]
        if hasattr(leaf, "q"):
            n_quantized += 1
            assert isinstance(mine, QuantizedTensor), path
            np.testing.assert_array_equal(mine.q.numpy(), _host(leaf.q))
            np.testing.assert_array_equal(mine.scale.numpy(), _host(leaf.scale))
        else:
            assert not isinstance(mine, QuantizedTensor), path
            np.testing.assert_array_equal(mine.detach().numpy(), _host(leaf))
    # the embedding, six products per block and the head
    assert n_quantized == 1 + 6 * LAYERS + 1
    assert is_quantized(pair["pq"]) and not is_quantized(pair["port"])
    assert pair["pq"]._quantized == {"scheme": SCHEME, "min_elements": 0}


def test_quantized_output_matches_jax_pallas_kernel(pair):
    out = pair["pq"].output(pair["ids"])
    ref = pair["ref_q"]
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert np.abs(out.numpy() - ref).max() <= REL * np.abs(ref).max()


def test_quantized_jax_tree_carries_across_unchanged(pair):
    carried = params_from_jax(
        jax.tree.map(np.asarray, pair["jq"].params),
        SequentialModel(_zoo(TransformerEncoder, pair["chunked"]).conf(),
                        device="cpu"))
    assert is_quantized(carried) and carried.compute_dtype == torch.float32
    assert torch.equal(carried.output(pair["ids"]), pair["pq"].output(pair["ids"]))
    # and back out: params_to_numpy hands the same q / scale arrays back
    back = _flat(params_to_numpy(carried))
    for path, leaf in _flat(pair["jq"].params).items():
        if hasattr(leaf, "q"):
            np.testing.assert_array_equal(back[path].q, _host(leaf.q))
            np.testing.assert_array_equal(back[path].scale, _host(leaf.scale))


def test_quantized_head_logits_match_jax(pair):
    """`ChunkedSoftmaxOutputLayer.logits` (the generation head) and the
    `RnnOutputLayer` projection on the same hidden states."""
    head = pair["pq"].conf.layers[-1]
    got = head.logits(pair["pq"].compute_params()[head.name],
                      torch.from_numpy(_hidden()))
    ref = pair["ref_logits"]
    assert np.abs(got.numpy() - ref).max() <= REL * np.abs(ref).max()


def test_quantized_bytes_match_jax(pair):
    got = quantized_bytes(pair["pq"].params)
    assert got == jax_quantized_bytes(pair["jq"].params)
    assert 0.25 < got["ratio"] < 0.27
    assert quantized_bytes(pair["port"].params)["ratio"] is None


def test_dequantize_tree_matches_jax(pair):
    want = _flat(jax_dequantize_tree(pair["jq"].params))
    got = _flat(dequantize_tree(pair["pq"].params))
    assert set(got) == set(want)
    for path, leaf in want.items():
        assert got[path].dtype == torch.float32
        np.testing.assert_array_equal(got[path].detach().numpy(), _host(leaf))


def test_parity_check_matches_jax(pair):
    res = parity_check(pair["port"], pair["pq"], pair["ids"])
    want = pair["jparity"]
    assert res["n"] == want["n"] == pair["ids"].size
    assert abs(res["top1_agreement"] - want["top1_agreement"]) <= 1.0 / res["n"]
    assert res["pass"] == (res["top1_delta"] <= 0.01)
    labels = np.roll(pair["ids"], -1, axis=1)
    with_labels = parity_check(pair["port"], pair["pq"], pair["ids"], labels)
    assert {"top1_ref", "top1_quant", "f1_ref", "f1_quant",
            "f1_delta"} <= set(with_labels)


def test_quantize_copy_leaves_the_source_alone_and_in_place_converts():
    model = _zoo(TransformerEncoder, True).init_model(device="cpu")
    ids = _ids()
    before = model.output(ids)
    q = quantize(model)
    assert not is_quantized(model) and torch.equal(model.output(ids), before)
    q_out = q.output(ids)
    # the source keeps training; its quantized copy does not follow
    model.fit_batch(DataSet(ids, np.roll(ids, -1, axis=1)))
    assert torch.equal(q.output(ids), q_out)
    same = quantize(model, copy=False)
    assert same is model and is_quantized(model) and model.opt_state is None
    # a weight below min_elements stays f32
    small = quantize(_zoo(TransformerEncoder, True).init_model(device="cpu"),
                     min_elements=D * D + 1)
    assert not isinstance(small.params["layer2"]["attn"]["Wq"], QuantizedTensor)
    assert isinstance(small.params["layer2"]["W1"], QuantizedTensor)
    assert small._quantized["min_elements"] == D * D + 1


def test_quantized_model_keeps_int8_buffers_and_computes_in_f32():
    conf = TransformerEncoder(vocab_size=VOCAB, d_model=D, n_heads=HEADS,
                              n_layers=1, bf16_compute=True).conf()
    q = quantize(SequentialModel(conf, device="cpu").init())
    buffers = dict(q.named_buffers())
    assert buffers["layers.layer2.attn.Wq.q"].dtype == torch.int8
    assert buffers["layers.layer2.attn.Wq.scale"].dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in q.parameters())
    assert q.compute_dtype == torch.float32
    cp = q.compute_params()
    assert cp["layer2"]["b1"].dtype == torch.float32
    assert isinstance(cp["layer2"]["attn"]["Wq"], QuantizedTensor)
    assert q.output(_ids()).dtype == torch.float32


# -- probes that raise ------------------------------------------------------------


@pytest.fixture(scope="module")
def qmodel():
    return quantize(_zoo(TransformerEncoder, True).init_model(device="cpu"))


def test_fit_batch_on_a_quantized_model_raises(qmodel):
    ids = _ids()
    with pytest.raises(RuntimeError, match="quantized"):
        qmodel.fit_batch(DataSet(ids, np.roll(ids, -1, axis=1)))
    with pytest.raises(RuntimeError, match="quantized"):
        qmodel.fit(DataSet(ids, np.roll(ids, -1, axis=1)))


def test_load_params_refuses_a_malformed_quantized_leaf():
    model = _zoo(TransformerEncoder, True).init_model(device="cpu")
    tree = params_to_numpy(quantize(model))
    qt = tree["layer2"]["W1"]
    tree["layer2"]["W1"] = QuantizedTensor(qt.q.astype(np.float32), qt.scale)
    with pytest.raises(TypeError, match="int8"):
        SequentialModel(model.conf, device="cpu").load_params(tree)
    tree["layer2"]["W1"] = QuantizedTensor(qt.q, qt.scale[:-1])
    with pytest.raises(ValueError, match="scale shape"):
        SequentialModel(model.conf, device="cpu").load_params(tree)
