"""The port's verified hot-swap over int8-quantized trees against the JAX
package's, on the CPU (ROADMAP C17).

In the JAX package a `QuantizedTensor` is a pytree node that flattens to
its int8 ``q`` and then its f32 ``scale``; `verify_weights`,
`weights_checksum` and `apply_fault_action` walk those two leaves.  The
port's trees hold the same pairs as one object, and its hot-swap must
flatten them the same way.  Every tree below is the JAX package's,
carried into the port by `params_from_jax`, and every verdict, checksum
and poisoned leaf is compared with the JAX package's on the same tree:

- verdicts (`SwapVerifyError.reason`, or a clean pass): a quantized twin
  with its checksum, with a wrong checksum; every int8 value at 127; a
  NaN scale; an f32 tree onto a quantized live tree and the reverse; a
  tree quantized with another ``min_elements``; another vocabulary; the
  ``truncate`` and ``corrupt`` fault actions;
- `weights_checksum` of quantized trees equals the JAX CRC32, bit for
  bit, whether the port's leaves are tensors or numpy arrays;
- ``corrupt`` poisons the same flattened leaf (a scale) as the JAX
  package, and nothing else.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.quant import QuantizedTensor as JaxQT
from deeplearning4j_tpu.quant import quantize as jax_quantize
from deeplearning4j_tpu.serving.hotswap import SwapVerifyError as JaxSwapError
from deeplearning4j_tpu.serving.hotswap import apply_fault_action as jax_fault
from deeplearning4j_tpu.serving.hotswap import verify_weights as jax_verify
from deeplearning4j_tpu.serving.hotswap import weights_checksum as jax_checksum
from deeplearning4j_tpu.zoo.transformer import TransformerEncoder as JaxTE
from deeplearning4j_tpu_torch.convert import params_from_jax, params_to_numpy
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.quant import QuantizedTensor
from deeplearning4j_tpu_torch.serving.hotswap import (
    SwapVerifyError,
    apply_fault_action,
    verify_weights,
    weights_checksum,
)
from deeplearning4j_tpu_torch.zoo.transformer import TransformerEncoder

torch.set_num_threads(1)

VOCAB, D, HEADS, LAYERS = 256, 64, 4, 2


def _kw(seed, vocab=VOCAB):
    return dict(vocab_size=vocab, d_model=D, n_heads=HEADS, n_layers=LAYERS,
                causal=True, seed=seed)


def _port(jax_params, vocab=VOCAB):
    model = SequentialModel(TransformerEncoder(**_kw(0, vocab)).conf(),
                            device="cpu")
    return params_from_jax(jax.tree.map(np.asarray, jax_params), model).params


@pytest.fixture(scope="module")
def trees():
    """Each case's (staged, live) pair in both packages: JAX trees, and
    the same trees carried into the port."""
    jm = JaxTE(**_kw(42)).init_model()
    jq = jax_quantize(jm)
    jtwin = jax_quantize(JaxTE(**_kw(43)).init_model())
    jmin = jax_quantize(jm, min_elements=D * D + 1)
    jwide = jax_quantize(JaxTE(**_kw(44, vocab=128)).init_model())
    pq, ptwin, pf32 = _port(jq.params), _port(jtwin.params), _port(jm.params)
    pmin = _port(jmin.params)
    pwide = _port(jwide.params, vocab=128)

    def extreme_jax(tree):
        return jax.tree.map(lambda l: jnp.full_like(l, 127)
                            if l.dtype == jnp.int8 else l, tree)

    def extreme_port(tree):
        return {k: extreme_port(v) if isinstance(v, dict)
                else QuantizedTensor(torch.full_like(v.q, 127), v.scale)
                if isinstance(v, QuantizedTensor) else v for k, v in tree.items()}

    def nan_scale_jax(tree):
        w = tree["layer0"]["W"]
        return {**tree, "layer0": {**tree["layer0"], "W": JaxQT(
            w.q, w.scale.at[0].set(jnp.nan))}}

    def nan_scale_port(tree):
        w = tree["layer0"]["W"]
        scale = w.scale.clone()
        scale[0] = float("nan")
        return {**tree, "layer0": {**tree["layer0"],
                                   "W": QuantizedTensor(w.q, scale)}}

    jcrc, pcrc = jax_checksum(jtwin.params), weights_checksum(ptwin)
    return {
        "twin_with_checksum": ((jtwin.params, jq.params, jcrc),
                               (ptwin, pq, pcrc)),
        "wrong_checksum": ((jtwin.params, jq.params, jcrc ^ 1),
                           (ptwin, pq, pcrc ^ 1)),
        "extreme_int8": ((extreme_jax(jq.params), jq.params, None),
                         (extreme_port(pq), pq, None)),
        "nan_scale": ((nan_scale_jax(jtwin.params), jq.params, None),
                      (nan_scale_port(ptwin), pq, None)),
        "f32_onto_quantized": ((jm.params, jq.params, None), (pf32, pq, None)),
        "quantized_onto_f32": ((jq.params, jm.params, None), (pq, pf32, None)),
        "other_min_elements": ((jmin.params, jq.params, None), (pmin, pq, None)),
        "other_vocab": ((jwide.params, jq.params, None), (pwide, pq, None)),
        "truncate": ((jax_fault("truncate", jtwin.params), jq.params, None),
                     (apply_fault_action("truncate", ptwin), pq, None)),
        "corrupt": ((jax_fault("corrupt", jtwin.params), jq.params, None),
                    (apply_fault_action("corrupt", ptwin), pq, None)),
        "_host": (jtwin.params, ptwin),
    }


def _reason(verify, err, staged, live, checksum):
    try:
        verify(staged, live, checksum=checksum)
    except err as exc:
        return exc.reason
    return None


WANT = {"twin_with_checksum": None, "wrong_checksum": "checksum",
        "extreme_int8": None, "nan_scale": "nonfinite",
        "f32_onto_quantized": "structure", "quantized_onto_f32": "structure",
        "other_min_elements": "structure", "other_vocab": "shape",
        "truncate": "structure", "corrupt": "nonfinite"}


@pytest.mark.parametrize("case", sorted(WANT))
def test_verdicts_equal_the_jax_packages(trees, case):
    jax_case, port_case = trees[case]
    want = _reason(jax_verify, JaxSwapError, *jax_case)
    got = _reason(verify_weights, SwapVerifyError, *port_case)
    assert got == want == WANT[case]


def test_checksum_of_a_quantized_tree_is_the_jax_crc(trees):
    jtree, ptree = trees["_host"]
    want = jax_checksum(jtree)
    assert weights_checksum(ptree) == want
    # the host form (`params_to_numpy`: QuantizedTensor of numpy arrays)
    model = SequentialModel(TransformerEncoder(**_kw(0)).conf(), device="cpu")
    assert weights_checksum(params_to_numpy(model.load_params(ptree))) == want
    # a NaN scale's bytes enter the CRC where the JAX package reads them
    assert weights_checksum(trees["nan_scale"][1][0]) == jax_checksum(
        trees["nan_scale"][0][0])


def test_corrupt_poisons_the_jax_packages_leaf(trees):
    jax_leaves = [np.asarray(l) for l in jax.tree.leaves(trees["corrupt"][0][0])]
    port_leaves = _leaves(trees["corrupt"][1][0])
    assert len(port_leaves) == len(jax_leaves)
    jbad = [i for i, l in enumerate(jax_leaves)
            if np.issubdtype(l.dtype, np.floating) and np.isnan(l).any()]
    pbad = [i for i, l in enumerate(port_leaves)
            if l.is_floating_point() and bool(torch.isnan(l).any())]
    assert pbad == jbad and len(pbad) == 1
    i = pbad[0]
    assert port_leaves[i].dtype == torch.float32
    assert port_leaves[i - 1].dtype == torch.int8      # the scale after its q
    np.testing.assert_array_equal(np.isnan(port_leaves[i].numpy()),
                                  np.isnan(jax_leaves[i]))
    # the staged tree is a copy: the source keeps its finite scales
    src = _leaves(trees["_host"][1])
    assert bool(torch.isfinite(src[i]).all())


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, QuantizedTensor):
        return [tree.q, tree.scale]
    return [tree]
