"""Post-training quantization — `quantize(model)` for the port, the
counterpart of `deeplearning4j_tpu/quant/ptq.py`.

Rewrites the matmul, conv and embedding weights of a built model into
`QuantizedTensor` pairs (symmetric per-output-channel int8,
`qtensor.quantize_array`; a conv kernel's channels are HWIO's last
axis), keyed exactly as the JAX package keys its quantized tree.
Biases, norm parameters and BatchNorm's state stay f32.  The quantized
layer set comes from the configuration (layer types), limited to the
layer types the port has: `Conv1D`, `Conv2D`, `Conv3D`, `Dense` and `OutputLayer`,
`Embedding`, `ChunkedSoftmaxOutputLayer`, `RnnOutputLayer`,
`SelfAttentionLayer` (Wq, Wk, Wv, Wo) and `TransformerEncoderBlock` (W1,
W2 and the attention projections).  `MoELayer` and
`LearnedSelfAttentionLayer` stay f32, as in the JAX package.  A
quantized Dense or OutputLayer product runs B5 on the card
(`quantf.matmul`); a quantized conv dequantizes its kernel and convolves
in f32 (`quantf.conv_weight`), as the JAX layer does.

The transform is inference-only: the optimizer state is dropped (an int8
tree takes no updates, and `fit_batch` refuses a quantized model) and
``model._quantized`` carries the scheme marker, which a checkpoint's
``meta.json`` records.  A quantized model computes in f32, as the JAX
package's does (`models/sequential.py`).  `requantize_structure`
rebuilds the quantized tree's structure when a checkpoint restores.

Telemetry, as in the JAX package: `quantize` sets
``dl4jtpu_quant_params_bytes{kind=quantized|f32_equiv}`` from the new
tree, and `parity_check` counts its verdict on
``dl4jtpu_quant_parity_checks_total{result=pass|fail}``.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from deeplearning4j_tpu_torch.quant.qtensor import QuantizedTensor, quantize_array

log = logging.getLogger("deeplearning4j_tpu_torch")

SCHEME = "int8-perchannel-symmetric/1"


def _quantizable_types():
    """(layer type, quantized-param spec) pairs, resolved lazily: the
    layer modules import `quant.functional`, so a module-level table here
    would be a circular import.  A spec is ``{group: names}``: ``""``
    names params at the layer's top level, any other key a nested group
    (the block keeps its attention projections under ``params["attn"]``)."""
    from deeplearning4j_tpu_torch.nn.conf import attention as A
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.conf import layers_nd as LN
    from deeplearning4j_tpu_torch.nn.conf import recurrent as R

    qkv = ("Wq", "Wk", "Wv", "Wo")
    return (
        (L.SeparableConv2D, {"": ("depthW", "pointW")}),
        (L.Conv2D, {"": ("W",)}),
        (L.Deconv2D, {"": ("W",)}),
        (L.Dense, {"": ("W",)}),             # OutputLayer subclasses Dense
        (L.Embedding, {"": ("W",)}),
        (L.ChunkedSoftmaxOutputLayer, {"": ("W",)}),
        (LN.Conv1D, {"": ("W",)}),
        (LN.Conv3D, {"": ("W",)}),
        (R.RnnOutputLayer, {"": ("W",)}),
        (A.SelfAttentionLayer, {"": qkv}),
        (A.TransformerEncoderBlock, {"": ("W1", "W2"), "attn": qkv}),
    )


def _layer_configs(conf) -> dict:
    """Node or layer name -> layer config, for sequential and graph
    configurations (a graph's vertices quantize nothing)."""
    layers = getattr(conf, "layers", None)
    if layers is not None:
        return {l.name: l for l in layers}
    return {n.name: n.layer for n in conf.nodes if n.layer is not None}


def _quant_spec(layer) -> dict:
    for cls, spec in _quantizable_types():
        if isinstance(layer, cls):
            return spec
    return {}


def _quantize_group(group: dict, names, *, min_elements: int) -> dict:
    new = {}
    for pname, arr in group.items():
        if (pname in names and isinstance(arr, torch.Tensor)
                and arr.dim() >= 2 and arr.numel() >= min_elements):
            new[pname] = quantize_array(arr)
        else:
            new[pname] = arr
    return new


def quantize_params(conf, params: dict, *, min_elements: int = 0) -> dict:
    """The params tree with every quantizable weight replaced by a
    `QuantizedTensor` (CPU tensors); everything else is carried by
    reference."""
    configs = _layer_configs(conf)
    out = {}
    for lname, lp in params.items():
        layer = configs.get(lname)
        spec = _quant_spec(layer) if layer is not None else {}
        if not spec or not isinstance(lp, dict):
            out[lname] = lp
            continue
        new = dict(lp)
        for group, names in spec.items():
            if group == "":
                new.update(_quantize_group(lp, names, min_elements=min_elements))
            elif isinstance(lp.get(group), dict):
                new[group] = _quantize_group(lp[group], names,
                                             min_elements=min_elements)
        out[lname] = new
    return out


def _copy_tree(tree: dict) -> dict:
    """Detached copies of the float leaves: the source model may go on
    training in place, and its quantized copy must not follow."""
    return {k: _copy_tree(v) if isinstance(v, dict)
            else v if isinstance(v, QuantizedTensor) else v.detach().clone()
            for k, v in tree.items()}


def quantize(model, *, min_elements: int = 0, copy: bool = True):
    """Int8-quantize a built model's weights for inference.

    ``copy=True`` (default) returns a new model over the same
    configuration and device; the f32 original is untouched.
    ``copy=False`` converts in place.  Either way the optimizer state is
    gone and ``output()`` runs every quantized product through
    `ops.dequant_matmul` (kernel B5 on CUDA)."""
    if model.params is None:
        model.init()
    qparams = quantize_params(model.conf, model.params, min_elements=min_elements)
    if copy:
        target = type(model)(model.conf, device=model.device)
        target.iteration = model.iteration
        target.epoch = model.epoch
        qparams = _copy_tree(qparams)
        target.net_state = _copy_tree(model.net_state or {})
    else:
        target = model
    target._install(qparams)              # drops opt_state, the compute cache, the graphs
    target._quantized = {"scheme": SCHEME, "min_elements": min_elements}
    _gauge_bytes(qparams)
    return target


def requantize_structure(model, meta: dict | None = None):
    """Rebuild the quantized tree's structure on a freshly initialised
    model (checkpoint restore: structure from code, data from the file).
    The values quantized here are placeholders that the positional load
    overwrites; ``meta`` is the checkpoint's recorded quantization, whose
    ``min_elements`` decides which weights are int8 (another value
    would misalign the leaves).  An unknown scheme raises."""
    meta = meta or {}
    scheme = meta.get("scheme", SCHEME)
    if scheme != SCHEME:
        raise ValueError(f"checkpoint quantization scheme {scheme!r} is not "
                         f"supported by this build (expected {SCHEME!r})")
    return quantize(model, copy=False,
                    min_elements=int(meta.get("min_elements", 0)))


def _leaves(params):
    for v in params.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def is_quantized(model) -> bool:
    return getattr(model, "_quantized", None) is not None


def dequantize_tree(params: dict) -> dict:
    """The f32 tree a quantized params tree stands for (parity tooling;
    ``output()`` never materializes it)."""
    return {k: dequantize_tree(v) if isinstance(v, dict)
            else v.dequant() if isinstance(v, QuantizedTensor) else v
            for k, v in params.items()}


def quantized_bytes(params: dict) -> dict:
    """Byte accounting of a (possibly) quantized tree: actual bytes, the
    f32-equivalent bytes of the quantized weights, and their ratio."""
    total = quantized = f32_equiv = 0
    for leaf in _leaves(params):
        total += int(leaf.nbytes)
        if isinstance(leaf, QuantizedTensor):
            quantized += leaf.nbytes
            f32_equiv += int(np.prod(leaf.shape)) * 4
    return {
        "tree_bytes": total,
        "quantized_bytes": quantized,
        "f32_equiv_bytes": f32_equiv,
        "ratio": (quantized / f32_equiv) if f32_equiv else None,
    }


def _macro_f1(y_true, y_pred, n_classes: int) -> float:
    f1s = []
    for c in range(n_classes):
        tp = int(np.sum((y_pred == c) & (y_true == c)))
        fp = int(np.sum((y_pred == c) & (y_true != c)))
        fn = int(np.sum((y_pred != c) & (y_true == c)))
        denom = 2 * tp + fp + fn
        f1s.append((2 * tp / denom) if denom else 1.0)
    return float(np.mean(f1s))


def parity_check(reference, quantized, features, labels=None, *,
                 top1_tol: float = 0.01, f1_tol: float = 0.02) -> dict:
    """The evaluation-parity gate of the JAX package.  Runs both models'
    ``output()`` on ``features`` and compares argmax predictions: without
    ``labels``, the top-1 disagreement between the two models must stay
    within ``top1_tol``; with integer ``labels``, the top-1 accuracy
    delta gates on ``top1_tol`` and the macro-F1 delta on ``f1_tol``.
    The verdict is counted on ``dl4jtpu_quant_parity_checks_total``."""
    ref_out = reference.output(features)
    q_out = quantized.output(features)
    n_classes = int(ref_out.shape[-1])
    # argmax on the device: the (N, vocab) outputs never cross to the host
    ref_pred = ref_out.argmax(dim=-1).reshape(-1).cpu().numpy()
    q_pred = q_out.argmax(dim=-1).reshape(-1).cpu().numpy()
    result = {
        "n": int(ref_pred.size),
        "top1_agreement": float((ref_pred == q_pred).mean()),
    }
    result["top1_delta"] = 1.0 - result["top1_agreement"]
    ok = result["top1_delta"] <= top1_tol
    if labels is not None:
        y = np.asarray(labels).ravel().astype(np.int64)
        result["top1_ref"] = float((ref_pred == y).mean())
        result["top1_quant"] = float((q_pred == y).mean())
        result["top1_delta"] = abs(result["top1_ref"] - result["top1_quant"])
        result["f1_ref"] = _macro_f1(y, ref_pred, n_classes)
        result["f1_quant"] = _macro_f1(y, q_pred, n_classes)
        result["f1_delta"] = abs(result["f1_ref"] - result["f1_quant"])
        ok = result["top1_delta"] <= top1_tol and result["f1_delta"] <= f1_tol
    result["pass"] = bool(ok)
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        registry().counter("dl4jtpu_quant_parity_checks_total").inc(
            result="pass" if ok else "fail")
    except Exception as e:
        log.debug("quant parity metric failed: %s", e)
    return result


def _gauge_bytes(params: dict) -> None:
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        b = quantized_bytes(params)
        g = registry().gauge("dl4jtpu_quant_params_bytes")
        g.set(b["quantized_bytes"], kind="quantized")
        g.set(b["f32_equiv_bytes"], kind="f32_equiv")
    except Exception as e:
        log.debug("quant params-bytes gauge failed: %s", e)
