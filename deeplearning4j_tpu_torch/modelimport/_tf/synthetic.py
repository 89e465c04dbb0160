"""Frozen-GraphDef writer — the port's counterpart of
`deeplearning4j_tpu/modelimport/_tf/synthetic.py`, over the port's own
wire codec (`wire.py`), so it needs neither TensorFlow nor
``google.protobuf``.

`FrozenGraphWriter` assembles NodeDefs; `build_bert_classifier_graphdef`
writes the frozen BERT-shaped classifier of BASELINE config 4 from a
seed.  The same arguments give the same bytes' message as the JAX
package's writer: the same nodes, attributes and weights (numpy's
``default_rng(seed)`` draws every weight in the same order, and no
weight's shape depends on the batch, so a batch-2 graph holds the
weights of the batch-32 one).  The graph uses only standard TF ops
(GatherV2, MatMul, BatchMatMulV2, Softmax, Erf-gelu, the
Mean / SquaredDifference / Rsqrt layer-norm decomposition).
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.modelimport._tf import wire as pb

_NP_TO_DT = {
    np.dtype(np.float32): 1,
    np.dtype(np.float64): 2,
    np.dtype(np.int32): 3,
    np.dtype(np.int64): 9,
    np.dtype(np.bool_): 10,
}


class FrozenGraphWriter:
    """Tiny NodeDef assembler.  Every helper returns the node name."""

    def __init__(self):
        self.g = pb.GraphDef()
        self.g.versions.producer = 1087    # a modern, widely-accepted stamp
        self._n = 0

    def _uniq(self, prefix: str) -> str:
        self._n += 1
        return f"{prefix}_{self._n}"

    def node(self, op: str, name: str, inputs=(), types=None, **attrs) -> str:
        """types: {attr_key: DataType enum} — real TF's import_graph_def
        rejects NodeDefs missing non-defaulted dtype attrs (T, Tidx, ...),
        so every typed op must stamp them explicitly."""
        n = self.g.node.add()
        n.name = name
        n.op = op
        n.input.extend(inputs)
        for k, enum in (types or {}).items():
            n.attr[k].type = enum
        for k, v in attrs.items():
            a = n.attr[k]
            if isinstance(v, bool):
                a.b = v
            elif isinstance(v, int):
                a.i = v
            elif isinstance(v, float):
                a.f = v
            elif isinstance(v, str):
                a.s = v.encode()
            elif isinstance(v, pb.TensorProto):
                a.tensor.CopyFrom(v)
            else:
                raise TypeError(f"attr {k}: {type(v)}")
        return name

    def placeholder(self, name: str, np_dtype, shape) -> str:
        n = self.g.node.add()
        n.name = name
        n.op = "Placeholder"
        n.attr["dtype"].type = _NP_TO_DT[np.dtype(np_dtype)]
        sh = n.attr["shape"].shape
        for s in shape:
            sh.dim.add().size = -1 if s is None else int(s)
        return name

    def const(self, name: str, arr: np.ndarray) -> str:
        arr = np.asarray(arr)
        enum = _NP_TO_DT[arr.dtype]
        n = self.g.node.add()
        n.name = name
        n.op = "Const"
        n.attr["dtype"].type = enum
        t = n.attr["value"].tensor
        t.dtype = enum
        for s in arr.shape:
            t.tensor_shape.dim.add().size = int(s)
        t.tensor_content = arr.tobytes()
        return name

    # typed wrappers (attrs must satisfy real TF's op registry, which the
    # golden test exercises via tf1.import_graph_def)
    _F = {"T": 1}          # DT_FLOAT

    def binop(self, op: str, a: str, b: str, name=None) -> str:
        return self.node(op, name or self._uniq(op.lower()), [a, b],
                         types=self._F)

    def unary(self, op: str, x: str, name=None) -> str:
        return self.node(op, name or self._uniq(op.lower()), [x],
                         types=self._F)

    def matmul(self, a: str, b: str, name=None, transpose_b=False) -> str:
        return self.node(
            "MatMul", name or self._uniq("matmul"), [a, b], types=self._F,
            transpose_a=False, transpose_b=transpose_b,
        )

    def batch_matmul(self, a: str, b: str, name=None, adj_y=False) -> str:
        return self.node(
            "BatchMatMulV2", name or self._uniq("bmm"), [a, b], types=self._F,
            adj_x=False, adj_y=adj_y,
        )

    def reshape(self, x: str, shape, name=None) -> str:
        s = self.const(self._uniq("shape"), np.asarray(shape, np.int32))
        return self.node(
            "Reshape", name or self._uniq("reshape"), [x, s],
            types={"T": 1, "Tshape": 3},
        )

    def transpose(self, x: str, perm, name=None) -> str:
        p = self.const(self._uniq("perm"), np.asarray(perm, np.int32))
        return self.node(
            "Transpose", name or self._uniq("transpose"), [x, p],
            types={"T": 1, "Tperm": 3},
        )

    def mean(self, x: str, axes, keep_dims=True, name=None) -> str:
        a = self.const(self._uniq("axes"), np.asarray(axes, np.int32))
        return self.node(
            "Mean", name or self._uniq("mean"), [x, a],
            types={"T": 1, "Tidx": 3}, keep_dims=keep_dims,
        )

    def gather(self, params: str, indices: str, name=None) -> str:
        ax = self.const(self._uniq("axis"), np.asarray(0, np.int32))
        return self.node(
            "GatherV2", name or self._uniq("gather"), [params, indices, ax],
            types={"Tparams": 1, "Tindices": 3, "Taxis": 3}, batch_dims=0,
        )

    def scalar(self, v: float) -> str:
        return self.const(self._uniq("c"), np.asarray(v, np.float32))

    def serialize(self) -> bytes:
        return self.g.SerializeToString()


def build_bert_classifier_graphdef(
    vocab: int = 30522,
    d_model: int = 768,
    n_layers: int = 12,
    n_heads: int = 12,
    seq_len: int = 128,
    batch: int = 32,
    n_classes: int = 2,
    seed: int = 0,
) -> bytes:
    """Serialize a frozen BERT-shaped sequence classifier as GraphDef bytes.

    ids (B,T) int32 -> embedding + positions -> n_layers x (post-LN
    transformer encoder block: MHA + gelu MLP) -> mean-pool -> classifier
    logits 'logits' (B, n_classes).  Weights are seeded-random (frozen
    graphs carry weights inline, exactly like a real export)."""
    w = FrozenGraphWriter()
    rng = np.random.default_rng(seed)
    B, T, D, H = batch, seq_len, d_model, n_heads
    hd = D // H

    def dense(x2d, n_in, n_out, tag):
        W = w.const(f"{tag}/W", rng.normal(0, 0.02, (n_in, n_out)).astype(np.float32))
        b = w.const(f"{tag}/b", np.zeros(n_out, np.float32))
        return w.node("BiasAdd", f"{tag}/out",
                      [w.matmul(x2d, W, name=f"{tag}/mm"), b], types={"T": 1})

    def layer_norm(x, tag):
        mu = w.mean(x, [-1], name=f"{tag}/mu")
        var = w.mean(w.binop("SquaredDifference", x, mu), [-1], name=f"{tag}/var")
        inv = w.unary("Rsqrt", w.binop("AddV2", var, w.scalar(1e-12)))
        xn = w.binop("Mul", w.binop("Sub", x, mu), inv)
        g = w.const(f"{tag}/gamma", np.ones((D,), np.float32))
        bta = w.const(f"{tag}/beta", np.zeros((D,), np.float32))
        return w.binop("AddV2", w.binop("Mul", xn, g), bta, name=f"{tag}/out")

    def gelu(x):
        # 0.5 * x * (1 + erf(x / sqrt(2))) — the exact-BERT gelu
        e = w.unary("Erf", w.binop("Mul", x, w.scalar(1.0 / np.sqrt(2.0))))
        return w.binop(
            "Mul",
            w.binop("Mul", x, w.scalar(0.5)),
            w.binop("AddV2", e, w.scalar(1.0)),
        )

    ids = w.placeholder("ids", np.int32, (B, T))
    emb_table = w.const(
        "embeddings/word", rng.normal(0, 0.02, (vocab, D)).astype(np.float32)
    )
    x = w.gather(emb_table, ids, name="embeddings/lookup")
    pos = w.const(
        "embeddings/position", rng.normal(0, 0.02, (1, T, D)).astype(np.float32)
    )
    x = w.binop("AddV2", x, pos, name="embeddings/out")

    for li in range(n_layers):
        tag = f"layer_{li}"
        x2d = w.reshape(x, (B * T, D))
        heads = []
        for proj in ("q", "k", "v"):
            p = dense(x2d, D, D, f"{tag}/attn/{proj}")
            p = w.reshape(p, (B, T, H, hd))
            heads.append(w.transpose(p, (0, 2, 1, 3)))  # (B,H,T,hd)
        q, k, v = heads
        scores = w.binop(
            "Mul",
            w.batch_matmul(q, k, adj_y=True, name=f"{tag}/attn/scores"),
            w.scalar(1.0 / np.sqrt(hd)),
        )
        probs = w.unary("Softmax", scores, name=f"{tag}/attn/probs")
        ctx = w.batch_matmul(probs, v, name=f"{tag}/attn/ctx")  # (B,H,T,hd)
        ctx = w.reshape(w.transpose(ctx, (0, 2, 1, 3)), (B * T, D))
        attn_out = dense(ctx, D, D, f"{tag}/attn/o")
        x = layer_norm(
            w.binop("AddV2", w.reshape(attn_out, (B, T, D)), x),
            f"{tag}/ln1",
        )
        h2d = dense(w.reshape(x, (B * T, D)), D, 4 * D, f"{tag}/mlp/up")
        h2d = gelu(h2d)
        mlp_out = dense(h2d, 4 * D, D, f"{tag}/mlp/down")
        x = layer_norm(
            w.binop("AddV2", w.reshape(mlp_out, (B, T, D)), x),
            f"{tag}/ln2",
        )

    pooled = w.reshape(w.mean(x, [1], keep_dims=False, name="pool"), (B, D))
    logits_pre = dense(pooled, D, n_classes, "classifier")
    w.node("Identity", "logits", [logits_pre], types={"T": 1})
    return w.serialize()
