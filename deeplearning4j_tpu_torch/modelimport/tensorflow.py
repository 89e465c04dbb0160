"""TF frozen-GraphDef import — the port's counterpart of
`deeplearning4j_tpu/modelimport/tensorflow.py` (the reference's
``TFGraphMapper``): a frozen GraphDef becomes a `SameDiff` with per-op
mapping rules.  This is BASELINE config 4's entry path (a BERT-base
classifier imported with ``trainable=True`` and fine-tuned).

The bytes are decoded by the port's own wire codec (`_tf/wire.py`; no
TensorFlow, no ``google.protobuf``).  TF's const-fed "attribute tensors"
(reshape shapes, reduction axes, pad amounts ...) are folded in numpy at
import time, so the graph keeps static shapes.  Constants keep the JAX
package's dtypes with x64 off (int64 -> int32, float64 -> float32).
With ``trainable=True`` every frozen float weight of rank >= 1 becomes a
trainable f32 variable, copied once from the input buffer to the device.

Control flow in both TF representations:

- V1 frames (Switch / Merge / Enter / Exit / NextIteration / LoopCond)
  are rebuilt structurally into `SameDiff.while_loop` / `if_cond`,
  recursively, so nested frames import;
- V2 functional While / If / PartitionedCall run their FunctionDef
  bodies as sub-interpreters (`_SubgraphFn`).

A loop whose trip count is provable at import (`_static_trip_count`:
counter-driven predicates, counted on the CPU with the same
``DL4JTPU_LOOP_TRIP_CAP`` cap) runs exactly that many times and is
differentiable; ``loop_trip_bound`` bounds the others the same way,
else they run as host loops over their predicate (forward-only in the
JAX package).  A graph whose loop bodies hold host-side control flow
runs eagerly on the card (`SameDiff.host_controlled`).

Serde: an imported graph checkpoints with `SameDiff.save`; with control
flow the original bytes ship inside the zip and `SameDiff.load`
re-imports them.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff, SDVariable, _pred, as_tensor

# the static-trip-count probe gives up past this many iterations
_TRIP_CAP = int(os.environ.get("DL4JTPU_LOOP_TRIP_CAP", "16384"))


class TFImportError(ValueError):
    pass


_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 7: np.dtype("S1"), 9: np.int64, 10: np.bool_, 14: np.float16,
}


def _tensor_to_np(tensor_proto) -> np.ndarray:
    """Decode a TensorProto without importing tensorflow's session machinery."""
    shape = [d.size for d in tensor_proto.tensor_shape.dim]
    dtype = _DTYPES.get(tensor_proto.dtype)
    if dtype is None:
        raise TFImportError(f"unsupported tensor dtype enum {tensor_proto.dtype}")
    if tensor_proto.tensor_content:
        arr = np.frombuffer(tensor_proto.tensor_content, dtype=dtype)
        return arr.reshape(shape)
    # scalar/splat encodings
    if list(tensor_proto.half_val):  # fp16 stores raw uint16 bit patterns
        arr = np.array(tensor_proto.half_val, np.uint16).view(np.float16)
        if shape:
            arr = np.full(shape, arr[0], np.float16) if arr.size == 1 else arr.reshape(shape)
        elif arr.size == 1:
            arr = arr.reshape(())
        return arr
    for field in ("float_val", "double_val", "int_val", "int64_val", "bool_val"):
        vals = list(getattr(tensor_proto, field, []))
        if vals:
            arr = np.asarray(vals, dtype=dtype)
            if shape:
                if arr.size == 1:
                    arr = np.full(shape, arr[0], dtype=dtype)
                else:
                    arr = arr.reshape(shape)
            elif arr.size == 1:
                arr = arr.reshape(())
            return arr
    return np.zeros(shape, dtype=dtype)


def _input_name(raw: str) -> tuple[str, int]:
    """'node:1' → ('node', 1); '^node' (control dep) → ('node', -1)."""
    if raw.startswith("^"):
        return raw[1:], -1
    if ":" in raw:
        name, idx = raw.rsplit(":", 1)
        return name, int(idx)
    return raw, 0


def _backward_slice_bases(nodes, outputs) -> set:
    """Base node names reachable backward from `outputs` through `nodes`
    (data edges only).  Names not in `nodes` are kept as leaves — they are
    the slice's external inputs."""
    by_name = {n.name: n for n in nodes}
    seen: set = set()
    stack = [_input_name(o)[0] for o in outputs]
    while stack:
        b = stack.pop()
        if b in seen:
            continue
        seen.add(b)
        node = by_name.get(b)
        if node is None:
            continue
        for raw in node.input:
            if raw.startswith("^"):
                continue
            stack.append(_input_name(raw)[0])
    return seen


class _Importer:
    def __init__(self, graph_def, trainable: bool = False,
                 loop_trip_bound: int | None = None, device=None):
        self.gd = graph_def
        self.sd = SameDiff(device=device)
        self.trainable = trainable
        # user-supplied bound for loops whose trip count can't be proven
        # static: runs them as a bounded masked loop (differentiable)
        # instead of a host loop, valid while true trips never exceed it
        self.loop_trip_bound = loop_trip_bound
        self.vars: Dict[str, SDVariable] = {}      # tf node name -> SDVariable
        self.consts: Dict[str, np.ndarray] = {}    # static-value table for attr-feeding
        self._promoted: Dict[str, SDVariable] = {}  # const node -> its ONE trainable var

    # --- static-value resolution ------------------------------------
    def static_value(self, name: str) -> np.ndarray:
        if name not in self.consts:
            raise TFImportError(
                f"op input {name!r} must be a compile-time constant "
                "(graph feeds it dynamically; the importer needs static shapes)"
            )
        return self.consts[name]

    def in_var(self, raw: str) -> SDVariable:
        name, idx = _input_name(raw)
        if idx > 0:
            name = f"{name}:{idx}"
        if name not in self.vars:
            base, _ = _input_name(raw)
            if base in self.consts and base not in self.vars:
                self.vars[base] = self._const_var(base, self.consts[base])
                return self.vars[base]
            raise TFImportError(f"input {raw!r} resolves to unknown node {name!r}")
        return self.vars[name]

    def data_inputs(self, node) -> List[str]:
        return [i for i in node.input if not i.startswith("^")]

    # --- attr helpers ------------------------------------------------
    @staticmethod
    def attr(node, key, default=None):
        if key not in node.attr:
            return default
        a = node.attr[key]
        kind = a.WhichOneof("value")
        if kind == "i":
            return a.i
        if kind == "f":
            return a.f
        if kind == "b":
            return a.b
        if kind == "s":
            return a.s.decode()
        if kind == "list":
            if a.list.i:
                return list(a.list.i)
            if a.list.f:
                return list(a.list.f)
            if a.list.s:
                return [s.decode() for s in a.list.s]
            if a.list.type:
                return list(a.list.type)   # e.g. While/If Tin/Tout
            return []
        if kind == "shape":
            return [d.size for d in a.shape.dim]
        if kind == "type":
            return a.type
        if kind == "tensor":
            return a.tensor
        if kind == "func":
            return a.func
        return default

    def nhwc(self, node):
        fmt = self.attr(node, "data_format", "NHWC")
        if fmt != "NHWC":
            raise TFImportError(f"{node.name}: only NHWC supported (got {fmt})")

    # --- main loop ----------------------------------------------------
    def run(self) -> SameDiff:
        # auto-generated names (op decompositions, _lift consts) must never
        # collide with a TF node name that imports later
        self.sd.reserve_names(n.name for n in self.gd.node)
        lib = getattr(self.gd, "library", None)
        self._funcs = (
            {f.signature.name: f for f in lib.function} if lib is not None else {}
        )
        nodes = list(self.gd.node)
        # V1 frame-based control flow (Switch/Merge/Enter/Exit/
        # NextIteration/LoopCond — the reference's VarId frames):
        # reconstructed structurally into while_loop / if_cond rather than
        # imported op-by-op.  The same pass runs RECURSIVELY
        # inside loop-body subgraphs, so nested while frames import too.
        self._run_structured(nodes)
        return self.sd

    def _run_structured(self, nodes) -> None:
        """Dispatch a node list with V1 control-flow reconstruction: frame
        and cond structures fire as macro-nodes; everything else goes
        through the op_* handlers."""
        frames = self._find_v1_frames(nodes)
        top = {
            fname: fr for fname, fr in frames.items()
            if not any(
                fname != other and fr["members"] < frames[other]["members"]
                for other in frames
            )
        }
        conds = self._find_v1_conds(nodes, top)
        skip: Dict[str, tuple] = {}          # node name -> ("frame"|"cond", key)
        trigger: Dict[str, tuple] = {}       # first node of a structure
        for fname, fr in top.items():
            for nm in fr["members"]:
                skip[nm] = ("frame", fname)
            trigger[fr["trigger"]] = ("frame", fname)
        for mname, cp in conds.items():
            for nm in cp["members"]:
                if nm not in skip:
                    skip[nm] = ("cond", mname)
            trigger[mname] = ("cond", mname)
        for node in nodes:
            if node.name in trigger:
                kind, key = trigger[node.name]
                if kind == "frame":
                    self._import_v1_frame(top[key], frames)
                else:
                    self._import_v1_cond(conds[key])
                continue
            if node.name in skip:
                continue
            op = node.op
            handler = getattr(self, f"op_{op}", None)
            if handler is None:
                if op.startswith("TensorArray"):
                    raise TFImportError(
                        f"{node.name}: {op!r} not supported — re-export the "
                        "loop with stacked tensors (control-flow-v2 "
                        "while_loop accumulating via concat) instead of "
                        "TensorArrays"
                    )
                raise TFImportError(f"{node.name}: unsupported TF op {op!r}")
            handler(node)

    def _promotable(self, value: np.ndarray) -> bool:
        """True when `value` is a frozen float weight that trainable import
        promotes to a variable — such values are NOT static (they change
        during fine-tuning)."""
        return (
            self.trainable
            and np.issubdtype(value.dtype, np.floating)
            and value.ndim >= 1
        )

    def _const_var(self, name: str, value: np.ndarray, base: str | None = None) -> SDVariable:
        """Materialize a static value as a graph node, honoring trainable
        promotion: frozen float weights become SameDiff variables on request
        (the reference's import-then-fine-tune path, BASELINE config 4).
        Used by both in_var and op_Identity so the standard frozen-graph
        pattern Const -> Identity('w/read') -> consumer promotes too.

        `base` is the underlying Const node the value came from; a given
        Const is promoted to at most ONE trainable variable — if both 'w'
        and 'w/read' are consumed as tensors, the second becomes an identity
        view of the first (two independent vars would drift during
        fine-tune)."""
        if self._promotable(value):
            key = base or name
            prior = self._promoted.get(key)
            if prior is not None:
                return self.sd.apply("identity", prior, name=name)
            v = self.sd.var(name, value)
            self._promoted[key] = v
            return v
        return self.sd.constant(name, value)

    def _bind(self, node, var: SDVariable, static: Optional[np.ndarray] = None):
        self.vars[node.name] = var
        if static is not None:
            self.consts[node.name] = static

    # --- sources -----------------------------------------------------
    def op_Placeholder(self, node):
        shape = self.attr(node, "shape")
        self._bind(node, self.sd.placeholder(node.name, shape=shape))

    op_PlaceholderV2 = op_Placeholder

    def op_Const(self, node):
        value = _tensor_to_np(self.attr(node, "value"))
        self.consts[node.name] = value
        # defer creating the graph constant until something consumes it as a
        # tensor (most consts only feed static attrs)

    def op_Identity(self, node):
        src = self.data_inputs(node)[0]
        base, _ = _input_name(src)
        if base in self.consts:
            self.consts[node.name] = self.consts[base]
            # also addressable as a fetchable graph node (cheap: a value,
            # not an op); goes through _const_var so trainable promotion
            # fires for the Const -> Identity('w/read') -> consumer pattern
            if node.name not in self.sd._vars:
                self.vars[node.name] = self._const_var(node.name, self.consts[base], base=base)
        else:
            # a real graph node, so the TF name stays addressable in output()
            self._bind(node, self.sd.apply("identity", self.in_var(src), name=node.name))

    op_CheckNumerics = op_Identity

    def op_StopGradient(self, node):
        """Like Identity but must NEVER promote to trainable — the graph
        author explicitly froze this tensor (so not aliased to op_Identity)."""
        src = self.data_inputs(node)[0]
        base, _ = _input_name(src)
        if base in self.consts:
            self.consts[node.name] = self.consts[base]
            if node.name not in self.sd._vars:
                self.vars[node.name] = self.sd.constant(node.name, self.consts[base])
        else:
            self._bind(node, self.sd.apply("stop_gradient", self.in_var(src), name=node.name))

    op_PreventGradient = op_StopGradient

    def op_NoOp(self, node):
        pass

    # --- elementwise binary ------------------------------------------
    def _binary(self, node, sd_op):
        a, b = self.data_inputs(node)[:2]
        self._bind(node, self.sd.apply(sd_op, self.in_var(a), self.in_var(b), name=node.name))

    def op_Add(self, node):
        self._binary(node, "add")

    op_AddV2 = op_Add

    def op_BiasAdd(self, node):
        self.nhwc(node)
        self._binary(node, "bias_add")

    def op_Sub(self, node):
        self._binary(node, "sub")

    def op_Mul(self, node):
        self._binary(node, "mul")

    def op_RealDiv(self, node):
        self._binary(node, "div")

    op_Div = op_RealDiv

    def op_Maximum(self, node):
        self._binary(node, "maximum")

    def op_Minimum(self, node):
        self._binary(node, "minimum")

    def op_Pow(self, node):
        self._binary(node, "pow")

    def op_SquaredDifference(self, node):
        self._binary(node, "squared_difference")

    def op_Greater(self, node):
        self._binary(node, "greater")

    def op_GreaterEqual(self, node):
        self._binary(node, "greater_equal")

    def op_Less(self, node):
        self._binary(node, "less")

    op_LessEqual = lambda self, node: self._binary(node, "less_equal")
    op_Equal = lambda self, node: self._binary(node, "equal")
    op_NotEqual = lambda self, node: self._binary(node, "not_equal")
    op_FloorDiv = lambda self, node: self._binary(node, "floor_div")
    op_FloorMod = lambda self, node: self._binary(node, "mod")

    def op_AddN(self, node):
        ins = [self.in_var(i) for i in self.data_inputs(node)]
        acc = ins[0]
        for v in ins[1:-1]:
            acc = self.sd.apply("add", acc, v)
        if len(ins) > 1:
            self._bind(node, self.sd.apply("add", acc, ins[-1], name=node.name))
        else:
            self._bind(node, self.sd.apply("identity", acc, name=node.name))

    def op_Select(self, node):
        c, x, y = (self.in_var(i) for i in self.data_inputs(node)[:3])
        self._bind(node, self.sd.apply("where", c, x, y, name=node.name))

    op_SelectV2 = op_Select

    # --- elementwise unary -------------------------------------------
    def _unary(self, node, sd_op, **attrs):
        self._bind(
            node,
            self.sd.apply(sd_op, self.in_var(self.data_inputs(node)[0]), name=node.name, **attrs),
        )

    def op_Relu(self, node):
        self._unary(node, "relu")

    def op_Relu6(self, node):
        self._unary(node, "relu6")

    def op_Elu(self, node):
        self._unary(node, "elu")

    def op_Selu(self, node):
        self._unary(node, "selu")

    def op_LeakyRelu(self, node):
        self._unary(node, "leaky_relu", alpha=float(self.attr(node, "alpha", 0.2)))

    def op_Sigmoid(self, node):
        self._unary(node, "sigmoid")

    def op_Tanh(self, node):
        self._unary(node, "tanh")

    def op_Softplus(self, node):
        self._unary(node, "softplus")

    def op_Erf(self, node):
        self._unary(node, "erf")

    def op_Exp(self, node):
        self._unary(node, "exp")

    def op_Log(self, node):
        self._unary(node, "log")

    def op_Sqrt(self, node):
        self._unary(node, "sqrt")

    def op_Rsqrt(self, node):
        self._unary(node, "rsqrt")

    def op_Square(self, node):
        self._unary(node, "square")

    def op_Neg(self, node):
        self._unary(node, "neg")

    def op_Abs(self, node):
        self._unary(node, "abs")

    def op_Floor(self, node):
        self._unary(node, "floor")

    def op_Ceil(self, node):
        self._unary(node, "ceil")

    def op_Sign(self, node):
        self._unary(node, "sign")

    def op_Sin(self, node):
        self._unary(node, "sin")

    def op_Cos(self, node):
        self._unary(node, "cos")

    def op_Reciprocal(self, node):
        self._unary(node, "reciprocal")

    def op_Cast(self, node):
        dt = _DTYPES.get(self.attr(node, "DstT"))
        if dt is None:
            raise TFImportError(f"{node.name}: unsupported Cast target")
        self._unary(node, "cast", dtype=np.dtype(dt).name)

    def op_Softmax(self, node):
        self._unary(node, "softmax", axis=-1)

    def op_LogSoftmax(self, node):
        self._unary(node, "log_softmax", axis=-1)

    # --- matmul family ------------------------------------------------
    def op_MatMul(self, node):
        a_raw, b_raw = self.data_inputs(node)[:2]
        a, b = self.in_var(a_raw), self.in_var(b_raw)
        if self.attr(node, "transpose_a", False):
            a = self.sd.apply("matrix_transpose", a)
        if self.attr(node, "transpose_b", False):
            b = self.sd.apply("matrix_transpose", b)
        self._bind(node, self.sd.apply("matmul", a, b, name=node.name))

    def op_Einsum(self, node):
        # modern TF exports tf.einsum as a single Einsum node (N inputs +
        # an equation attr) rather than lowering to matmul chains
        eq = self.attr(node, "equation")
        ins = [self.in_var(i) for i in self.data_inputs(node)]
        self._bind(
            node, self.sd.apply("einsum", *ins, name=node.name, equation=eq)
        )

    def op_BatchMatMulV2(self, node):
        a_raw, b_raw = self.data_inputs(node)[:2]
        a, b = self.in_var(a_raw), self.in_var(b_raw)
        if self.attr(node, "adj_x", False):
            a = self.sd.apply("matrix_transpose", a)
        if self.attr(node, "adj_y", False):
            b = self.sd.apply("matrix_transpose", b)
        self._bind(node, self.sd.apply("matmul", a, b, name=node.name))

    op_BatchMatMul = op_BatchMatMulV2

    # --- shape ops (const-folded) ------------------------------------
    def op_Reshape(self, node):
        x_raw, shape_raw = self.data_inputs(node)[:2]
        shape = [int(v) for v in self.static_value(_input_name(shape_raw)[0]).reshape(-1)]
        self._unary_on(node, x_raw, "reshape", shape=shape)

    def _unary_on(self, node, x_raw, sd_op, **attrs):
        self._bind(node, self.sd.apply(sd_op, self.in_var(x_raw), name=node.name, **attrs))

    def op_Transpose(self, node):
        x_raw, perm_raw = self.data_inputs(node)[:2]
        perm = [int(v) for v in self.static_value(_input_name(perm_raw)[0]).reshape(-1)]
        self._unary_on(node, x_raw, "transpose", axes=perm)

    def op_ExpandDims(self, node):
        x_raw, ax_raw = self.data_inputs(node)[:2]
        axis = int(self.static_value(_input_name(ax_raw)[0]))
        self._unary_on(node, x_raw, "expand_dims", axis=axis)

    def op_Squeeze(self, node):
        dims = self.attr(node, "squeeze_dims", []) or None
        self._unary(node, "squeeze", axis=tuple(dims) if dims else None)

    def op_ConcatV2(self, node):
        ins = self.data_inputs(node)
        axis = int(self.static_value(_input_name(ins[-1])[0]))
        vs = [self.in_var(i) for i in ins[:-1]]
        self._bind(node, self.sd.apply("concat", *vs, name=node.name, axis=axis))

    def op_Pack(self, node):
        axis = int(self.attr(node, "axis", 0))
        vs = [self.in_var(i) for i in self.data_inputs(node)]
        self._bind(node, self.sd.apply("stack", *vs, name=node.name, axis=axis))

    def op_Pad(self, node):
        ins = self.data_inputs(node)
        paddings = [tuple(int(v) for v in row) for row in self.static_value(_input_name(ins[1])[0])]
        cv = 0.0
        if len(ins) > 2:  # PadV2 carries constant_values as a third input
            cv = float(self.static_value(_input_name(ins[2])[0]))
        self._unary_on(node, ins[0], "pad", paddings=paddings, constant_values=cv)

    op_PadV2 = op_Pad

    def op_Tile(self, node):
        x_raw, reps_raw = self.data_inputs(node)[:2]
        reps = [int(v) for v in self.static_value(_input_name(reps_raw)[0]).reshape(-1)]
        self._unary_on(node, x_raw, "tile", reps=tuple(reps))

    def op_Slice(self, node):
        x_raw, b_raw, s_raw = self.data_inputs(node)[:3]
        begin = [int(v) for v in self.static_value(_input_name(b_raw)[0]).reshape(-1)]
        size = [int(v) for v in self.static_value(_input_name(s_raw)[0]).reshape(-1)]
        self._unary_on(node, x_raw, "slice", begin=tuple(begin), size=tuple(size))

    def op_GatherV2(self, node):
        ins = self.data_inputs(node)
        axis = int(self.static_value(_input_name(ins[2])[0])) if len(ins) > 2 else 0
        self._bind(
            node,
            self.sd.apply("gather", self.in_var(ins[0]), self.in_var(ins[1]),
                          name=node.name, axis=axis),
        )

    op_Gather = op_GatherV2
    op_ResourceGather = op_GatherV2

    def op_OneHot(self, node):
        ins = self.data_inputs(node)
        depth = int(self.static_value(_input_name(ins[1])[0]))
        on = float(self.static_value(_input_name(ins[2])[0])) if len(ins) > 2 else 1.0
        off = float(self.static_value(_input_name(ins[3])[0])) if len(ins) > 3 else 0.0
        axis = int(self.attr(node, "axis", -1))
        self._bind(
            node,
            self.sd.apply("one_hot", self.in_var(ins[0]), name=node.name,
                          depth=depth, on_value=on, off_value=off, axis=axis),
        )

    # --- reductions ---------------------------------------------------
    def _reduction(self, node, sd_op):
        x_raw, ax_raw = self.data_inputs(node)[:2]
        axes = [int(v) for v in self.static_value(_input_name(ax_raw)[0]).reshape(-1)]
        keep = bool(self.attr(node, "keep_dims", False))
        self._unary_on(node, x_raw, sd_op, axis=tuple(axes), keepdims=keep)

    def op_Mean(self, node):
        self._reduction(node, "mean")

    def op_Sum(self, node):
        self._reduction(node, "sum")

    def op_Max(self, node):
        self._reduction(node, "max")

    def op_Min(self, node):
        self._reduction(node, "min")

    def op_Prod(self, node):
        self._reduction(node, "prod")

    def op_ArgMax(self, node):
        x_raw, ax_raw = self.data_inputs(node)[:2]
        axis = int(self.static_value(_input_name(ax_raw)[0]))
        self._unary_on(node, x_raw, "argmax", axis=axis)

    # --- nn -----------------------------------------------------------
    def _conv(self, node, sd_op):
        self.nhwc(node)
        strides = self.attr(node, "strides", [1, 1, 1, 1])
        dil = self.attr(node, "dilations", [1, 1, 1, 1])
        padding = self.attr(node, "padding", "SAME")
        if padding not in ("SAME", "VALID"):
            raise TFImportError(f"{node.name}: padding {padding!r} unsupported")
        x_raw, w_raw = self.data_inputs(node)[:2]
        self._bind(
            node,
            self.sd.apply(sd_op, self.in_var(x_raw), self.in_var(w_raw),
                          name=node.name, stride=(int(strides[1]), int(strides[2])),
                          padding=padding, dilation=(int(dil[1]), int(dil[2]))),
        )

    def op_Conv2D(self, node):
        self._conv(node, "conv2d")

    def op_DepthwiseConv2dNative(self, node):
        self._conv(node, "depthwise_conv2d")

    def _pool(self, node, sd_op):
        self.nhwc(node)
        k = self.attr(node, "ksize", [1, 2, 2, 1])
        s = self.attr(node, "strides", [1, 2, 2, 1])
        self._unary(node, sd_op, kernel=(int(k[1]), int(k[2])),
                    stride=(int(s[1]), int(s[2])),
                    padding=self.attr(node, "padding", "VALID"))

    def op_MaxPool(self, node):
        self._pool(node, "max_pool2d")

    def op_AvgPool(self, node):
        self._pool(node, "avg_pool2d")

    def op_FusedBatchNormV3(self, node):
        # inference form: (x - mean) * rsqrt(var + eps) * gamma + beta
        # NB: TF's op-def default for is_training is True, so a stripped attr
        # (strip_default_attrs) means training mode — default True here too.
        if bool(self.attr(node, "is_training", True)):
            raise TFImportError(
                f"{node.name}: FusedBatchNorm with is_training=True — the "
                "mean/var inputs are not populated in training graphs, so the "
                "import would be silently wrong; re-export a frozen/inference "
                "graph (e.g. convert_variables_to_constants of an inference fn)"
            )
        ins = self.data_inputs(node)
        x, gamma, beta, mean, var = (self.in_var(i) for i in ins[:5])
        eps = float(self.attr(node, "epsilon", 1e-3))
        sd = self.sd
        inv = sd.apply("rsqrt", sd.apply("add", var, sd._lift(eps)))
        scaled = sd.apply("mul", sd.apply("mul", sd.apply("sub", x, mean), inv), gamma)
        self._bind(node, sd.apply("add", scaled, beta, name=node.name))

    op_FusedBatchNorm = op_FusedBatchNormV3
    op_FusedBatchNormV2 = op_FusedBatchNormV3

    # --- shape/array tail (round 4) -----------------------------------
    def op_StridedSlice(self, node):
        ins = self.data_inputs(node)
        begin = [int(v) for v in
                 self.static_value(_input_name(ins[1])[0]).reshape(-1)]
        end = [int(v) for v in
               self.static_value(_input_name(ins[2])[0]).reshape(-1)]
        strides = [int(v) for v in
                   self.static_value(_input_name(ins[3])[0]).reshape(-1)]
        self._unary_on(
            node, ins[0], "strided_slice",
            begin=tuple(begin), end=tuple(end), strides=tuple(strides),
            begin_mask=int(self.attr(node, "begin_mask", 0)),
            end_mask=int(self.attr(node, "end_mask", 0)),
            ellipsis_mask=int(self.attr(node, "ellipsis_mask", 0)),
            new_axis_mask=int(self.attr(node, "new_axis_mask", 0)),
            shrink_axis_mask=int(self.attr(node, "shrink_axis_mask", 0)),
        )

    def op_Shape(self, node):
        base, _ = _input_name(self.data_inputs(node)[0])
        if base not in self.consts:
            raise TFImportError(
                f"{node.name}: Shape of a non-constant tensor is dynamic — "
                "the importer needs static shapes; re-export with shapes folded "
                "(freeze with constant inputs)"
            )
        self.consts[node.name] = np.asarray(
            self.consts[base].shape, np.int32)

    def op_Fill(self, node):
        ins = self.data_inputs(node)
        dims = [int(v) for v in
                self.static_value(_input_name(ins[0])[0]).reshape(-1)]
        value = self.static_value(_input_name(ins[1])[0])
        self.consts[node.name] = np.full(dims, value.reshape(()))

    def op_Range(self, node):
        ins = self.data_inputs(node)
        start, limit, delta = (
            self.static_value(_input_name(i)[0]).reshape(()) for i in ins[:3]
        )
        self.consts[node.name] = np.arange(start, limit, delta)

    def op_Unpack(self, node):
        # gather-with-scalar-index squeezes the axis (numpy take semantics),
        # which is exactly unstack — and handles negative axes, where a
        # begin/end/mask slice spec would need the (untracked) input rank
        axis = int(self.attr(node, "axis", 0))
        num = int(self.attr(node, "num"))
        src = self.in_var(self.data_inputs(node)[0])
        for i in range(num):
            nm = node.name if i == 0 else f"{node.name}:{i}"
            idx = self.sd._lift(np.int32(i))
            self.vars[nm] = self.sd.apply(
                "gather", src, idx, name=nm, axis=axis
            )
        self.vars.setdefault(f"{node.name}:0", self.vars[node.name])

    def op_Cumsum(self, node):
        ins = self.data_inputs(node)
        axis = int(self.static_value(_input_name(ins[1])[0]))
        if self.attr(node, "exclusive", False) or self.attr(
            node, "reverse", False
        ):
            raise TFImportError(
                f"{node.name}: exclusive/reverse Cumsum not supported"
            )
        self._unary_on(node, ins[0], "cumsum", axis=axis)

    def op_Round(self, node):
        self._unary(node, "round")

    def op_ZerosLike(self, node):
        self._unary(node, "zeros_like")

    def op_OnesLike(self, node):
        self._unary(node, "ones_like")

    def op_L2Loss(self, node):
        self._unary(node, "l2_loss")

    def op_Split(self, node):
        ins = self.data_inputs(node)
        axis = int(self.static_value(_input_name(ins[0])[0]))
        num = int(self.attr(node, "num_split"))
        src = self.in_var(ins[1])
        for i in range(num):
            nm = node.name if i == 0 else f"{node.name}:{i}"
            self.vars[nm] = self.sd.apply(
                "split_part", src, name=nm, index=i, num=num, axis=axis)
        self.vars.setdefault(f"{node.name}:0", self.vars[node.name])

    def op_SplitV(self, node):
        ins = self.data_inputs(node)
        src = self.in_var(ins[0])
        sizes = [int(v) for v in
                 self.static_value(_input_name(ins[1])[0]).reshape(-1)]
        axis = int(self.static_value(_input_name(ins[2])[0]))
        if any(s < 0 for s in sizes):
            raise TFImportError(
                f"{node.name}: SplitV with -1 (inferred) size needs shape "
                "inference; re-export with explicit sizes"
            )
        off = 0
        for i, s in enumerate(sizes):
            nm = node.name if i == 0 else f"{node.name}:{i}"
            self.vars[nm] = self.sd.apply(
                "slice_axis", src, name=nm, begin=off, size=s, axis=axis)
            off += s
        self.vars.setdefault(f"{node.name}:0", self.vars[node.name])

    def op_GatherNd(self, node):
        a, b = self.data_inputs(node)[:2]
        self._bind(node, self.sd.apply(
            "gather_nd", self.in_var(a), self.in_var(b), name=node.name))

    def _resize(self, node, method):
        if bool(self.attr(node, "align_corners", False)) or not bool(
            self.attr(node, "half_pixel_centers", False)
        ):
            raise TFImportError(
                f"{node.name}: only half_pixel_centers=True resize imports "
                "(the sampling grid the resize ops reproduce; other modes would "
                "be silently shifted)"
            )
        ins = self.data_inputs(node)
        size = [int(v) for v in
                self.static_value(_input_name(ins[1])[0]).reshape(-1)]
        self._unary_on(node, ins[0], method, size=tuple(size))

    def op_ResizeBilinear(self, node):
        self._resize(node, "resize_bilinear")

    def op_ResizeNearestNeighbor(self, node):
        self._resize(node, "resize_nearest")

    # --- control flow -------------------------------------------------
    # Both the V1 frame representation and the V2 functional one
    # (While/If + FunctionDef library) rebuild into SameDiff's while_loop /
    # if_cond / py_call; loop bodies are sub-interpreters (_SubgraphFn)
    # over the same op handlers.

    def _sub(self, *args, **kw) -> "_SubgraphFn":
        """A `_SubgraphFn` on this import's device; host-side control flow
        inside it makes the whole graph run eagerly."""
        kw.setdefault("device", self.sd.device)
        fn = _SubgraphFn(*args, **kw)
        if fn.host_controlled:
            self.sd._host_control = True
        return fn

    # -- V1 frames (Switch/Merge/Enter/Exit/NextIteration/LoopCond) --
    def _find_v1_frames(self, nodes) -> Dict[str, dict]:
        enters = [n for n in nodes if n.op == "Enter"]
        if not enters:
            return {}
        by_name = {n.name: n for n in nodes}
        consumers: Dict[str, list] = {}
        for n in nodes:
            for raw in n.input:
                base, _ = _input_name(raw)
                consumers.setdefault(base, []).append(n)
        frames: Dict[str, dict] = {}
        for n in enters:
            fr = frames.setdefault(
                self.attr(n, "frame_name"),
                {"enters": [], "cap_enters": []},
            )
            if self.attr(n, "is_constant", False):
                fr["cap_enters"].append(n)
            else:
                fr["enters"].append(n)
        for fname, fr in frames.items():
            members = {n.name for n in fr["enters"] + fr["cap_enters"]}
            stack = list(members)
            while stack:
                cur = stack.pop()
                node = by_name[cur]
                if node.op == "Exit":
                    # OUR Exit pops the frame (its output lives outside);
                    # an INNER frame's Exit is interior and propagation
                    # continues through it.  Ownership: an Exit belongs to
                    # the frame whose Enter feeds the Merge behind its
                    # Switch.
                    sw_base = _input_name(node.input[0])[0]
                    sw = by_name.get(sw_base)
                    ours = False
                    if sw is not None and sw.op == "Switch":
                        mg = by_name.get(_input_name(sw.input[0])[0])
                        if mg is not None and mg.op == "Merge":
                            ent_names = {
                                n.name for n in fr["enters"] + fr["cap_enters"]
                            }
                            ours = any(
                                _input_name(i)[0] in ent_names
                                for i in mg.input
                            )
                    if ours:
                        continue  # OUR Exit pops the frame
                for c in consumers.get(cur, []):
                    if c.name not in members:
                        members.add(c.name)
                        stack.append(c.name)
            fr["members"] = members
            fr["trigger"] = next(n.name for n in nodes if n.name in members)
            fr["order"] = [n for n in nodes if n.name in members]
            fr["name"] = fname
        return frames

    # -- static trip-count inference: a loop whose predicate is driven by
    # statically seeded counters provably runs a fixed number of times and
    # runs that many, differentiably, so imported models whose loss
    # depends on a loop output fine-tune end to end ---------------------
    def _static_trip_count(self, cond_nodes, cond_inputs, pred_ref,
                           body_nodes, body_inputs, body_outputs,
                           statics, static_inits, label):
        """Return the exact trip count of the loop, or None when it cannot
        be proven at import time.

        Method: dependency-slice the predicate to the loop-var positions
        it reads; close that set under the body's update dependencies; if
        every position in the closure has a statically-known initial value
        (consts — NOT promotable weights), the counter subsystem is fully
        determined at import time.  A loop over sub-interpreters on the
        CPU then runs the counters to termination and returns the count.  Bails (None) past _TRIP_CAP
        iterations, on any structural surprise, or on evaluation error —
        inference must never break an import that worked as while_loop."""
        try:
            return self._static_trip_count_inner(
                cond_nodes, cond_inputs, pred_ref, body_nodes,
                body_inputs, body_outputs, statics, static_inits, label)
        except Exception:
            return None

    def _static_trip_count_inner(self, cond_nodes, cond_inputs, pred_ref,
                                 body_nodes, body_inputs, body_outputs,
                                 statics, static_inits, label):
        n = len(cond_inputs)
        cond_bases = [_input_name(c)[0] for c in cond_inputs]
        body_bases = [_input_name(b)[0] for b in body_inputs]
        known = set(statics)

        def closed_slice(nodes, outputs, input_bases):
            """Backward slice from `outputs`: (positions touched, ok), ok
            False when a leaf is neither an interior node, a static nor a
            loop-var input (not evaluable at import)."""
            names = {nd.name for nd in nodes}
            seen = _backward_slice_bases(nodes, outputs)
            in_set = set(input_bases)
            ok = all(b in names or b in known or b in in_set for b in seen)
            pos = {p for p in range(n) if input_bases[p] in seen}
            return pos, ok

        pred_deps, ok = closed_slice(cond_nodes, [pred_ref], cond_bases)
        if not ok:
            return None
        out_deps = []
        for p in range(n):
            deps, ok = closed_slice(body_nodes, [body_outputs[p]], body_bases)
            out_deps.append(deps if ok else None)
        S = set(pred_deps)
        while True:
            grow = set()
            for p in S:
                if out_deps[p] is None:
                    return None
                grow |= out_deps[p]
            if grow <= S:
                break
            S |= grow
        if any(static_inits[p] is None for p in S):
            return None

        S_sorted = sorted(S)
        probe_label = label + " (trip probe)"
        # the probe's sub-interpreters run on the CPU: a device loop would
        # wait for the card once an iteration
        cond_sub = _SubgraphFn(cond_nodes, cond_inputs, [pred_ref],
                               statics=statics, funcs=self._funcs,
                               label=probe_label, device="cpu")
        body_sub = _SubgraphFn(body_nodes, body_inputs,
                               [body_outputs[p] for p in S_sorted],
                               statics=statics, funcs=self._funcs,
                               label=probe_label, device="cpu")
        dummy = torch.zeros((), dtype=torch.float32)

        def full(vs):
            out = [dummy] * n
            for i, p in enumerate(S_sorted):
                out[p] = vs[i]
            return out

        vs = tuple(as_tensor(static_inits[p], "cpu") for p in S_sorted)
        trip = 0
        with torch.no_grad():
            while trip < _TRIP_CAP and bool(_pred(cond_sub(*full(vs))[0])):
                vs = tuple(body_sub(*full(vs)))
                trip += 1
        if trip >= _TRIP_CAP:
            return None
        return trip

    def _import_v1_frame(self, fr: dict, all_frames: dict) -> None:
        by_name = {n.name: n for n in fr["order"]}
        # nested frames: nodes of strictly-contained child frames are part
        # of the INTERIOR (the body sub-pass reconstructs them); only THIS
        # frame's LOOP structure is stripped.  Cond diamonds inside the
        # body (tf.cond in a while body) keep their Switch/Merge nodes in
        # the interior too — the recursive sub-pass rebuilds them.
        child_names: set = set()
        for other, ofr in all_frames.items():
            if other != fr["name"] and ofr["members"] < fr["members"]:
                child_names |= ofr["members"]
        own = lambda n: n.name not in child_names
        enter_names = {n.name for n in fr["enters"]}
        loopconds = [n for n in fr["order"]
                     if n.op == "LoopCond" and own(n)]
        if len(loopconds) != 1:
            raise TFImportError(
                f"frame {fr['name']!r}: expected exactly one LoopCond, "
                f"found {len(loopconds)}"
            )
        loopcond = loopconds[0]
        pred_ref = loopcond.input[0]
        # THIS frame's loop plumbing: merges fed by our Enters, switches
        # gated by our LoopCond, their NextIterations and Exits.  Any
        # other Merge/Switch in the frame is a cond diamond -> interior.
        merge_of_enter: Dict[str, Any] = {}
        next_of_merge: Dict[str, Any] = {}
        loop_structural: set = {loopcond.name}
        for m in fr["order"]:
            if m.op != "Merge" or not own(m):
                continue
            srcs = [_input_name(i)[0] for i in m.input]
            ent = next((s for s in srcs if s in enter_names), None)
            if ent is None:
                continue               # cond-diamond Merge: body interior
            merge_of_enter[ent] = m
            loop_structural.add(m.name)
            nxt = next(
                (s for s in srcs
                 if s in by_name and by_name[s].op == "NextIteration"),
                None,
            )
            next_of_merge[m.name] = nxt
            if nxt is not None:
                loop_structural.add(nxt)
        switch_of_merge = {}
        for s in fr["order"]:
            if s.op != "Switch" or not own(s):
                continue
            if _input_name(s.input[1])[0] != loopcond.name:
                continue               # cond-diamond Switch: body interior
            switch_of_merge[_input_name(s.input[0])[0]] = s
            loop_structural.add(s.name)
        exit_of_switch = {}
        loop_switch_names = {s.name for s in switch_of_merge.values()}
        for e in fr["order"]:
            if e.op != "Exit" or not own(e):
                continue
            sw = _input_name(e.input[0])[0]
            if sw in loop_switch_names:
                exit_of_switch[sw] = e
                loop_structural.add(e.name)
        loop_structural |= {n.name for n in fr["enters"] + fr["cap_enters"]}
        interior = [
            n for n in fr["order"] if n.name not in loop_structural
        ]

        # loop-invariant captures (Enter is_constant=true): static parent
        # values seed the body's const table (so shape/axis consumers keep
        # working); dynamic ones ride along as extra loop variables.
        # Under trainable import, promotable float weights captured by the
        # loop must ride as DYNAMIC captures too — baking them static
        # would freeze the in-loop copy while the promoted variable
        # trains, and would cut the gradient path through the loop body.
        statics: Dict[str, np.ndarray] = {}
        dyn_caps = []
        for cap in fr["cap_enters"]:
            base, _ = _input_name(cap.input[0])
            if base in self.consts and not self._promotable(self.consts[base]):
                statics[cap.name] = self.consts[base]
            else:
                dyn_caps.append(cap)

        cond_inputs, body_inputs, body_outputs, init_vars = [], [], [], []
        static_inits: List[Optional[np.ndarray]] = []
        exits = []
        for ent in fr["enters"]:
            m = merge_of_enter.get(ent.name)
            sw = switch_of_merge.get(m.name) if m is not None else None
            nxt = next_of_merge.get(m.name) if m is not None else None
            if m is None or sw is None or nxt is None:
                raise TFImportError(
                    f"frame {fr['name']!r}: loop var {ent.name} lacks the "
                    "Merge/Switch/NextIteration chain"
                )
            cond_inputs.append(m.name)
            body_inputs.append(f"{sw.name}:1")
            body_outputs.append(by_name[nxt].input[0])
            init_vars.append(self.in_var(ent.input[0]))
            base, _ = _input_name(ent.input[0])
            sv = self.consts.get(base)
            static_inits.append(
                None if sv is None or self._promotable(sv) else sv)
            exits.append(exit_of_switch.get(sw.name))
        for cap in dyn_caps:
            cond_inputs.append(cap.name)
            body_inputs.append(cap.name)
            body_outputs.append(cap.name)  # pass through unchanged
            init_vars.append(self.in_var(cap.input[0]))
            static_inits.append(None)

        label = f"while frame {fr['name']!r}"
        cond_fn = self._sub(interior, cond_inputs, [pred_ref],
                              statics=statics, funcs=self._funcs, label=label,
                              loop_trip_bound=self.loop_trip_bound)
        body_fn = self._sub(interior, body_inputs, body_outputs,
                              statics=statics, funcs=self._funcs, label=label,
                              loop_trip_bound=self.loop_trip_bound)
        trip = self._static_trip_count(
            interior, cond_inputs, pred_ref,
            interior, body_inputs, body_outputs,
            statics, static_inits, label)
        bound = trip if trip is not None else self.loop_trip_bound
        # bounded lowering inherits SameDiff.while_loop's masked-scan
        # contract: the body must be total on the INITIAL loop values (a
        # zero-trip loop still executes it once, result discarded) — see
        # the at-least-one-iteration note in that docstring
        outs = self.sd.while_loop(
            lambda *vs: cond_fn(*vs)[0],
            lambda *vs: body_fn(*vs),
            *init_vars,
            max_trip=bound, exact_trip=trip is not None,
        )
        for i, ex in enumerate(exits):
            if ex is not None:
                # keep the TF name addressable for output()/consumers
                self.vars[ex.name] = self.sd.apply(
                    "identity", outs[i], name=ex.name
                )

    # -- V1 conds (Switch/Merge diamonds outside any frame) --
    def _find_v1_conds(self, nodes, frames) -> Dict[str, dict]:
        in_frame = set()
        for fr in frames.values():
            in_frame |= fr["members"]
        switch_names = {
            n.name for n in nodes
            if n.op == "Switch" and n.name not in in_frame
        }
        merges = [
            n for n in nodes
            if n.op == "Merge" and n.name not in in_frame
        ]
        if not switch_names and not merges:
            return {}
        if not merges:
            raise TFImportError(
                "graph has Switch nodes outside any while frame but no "
                "matching Merge (unrecognized control-flow structure)"
            )
        by_name = {n.name: n for n in nodes}
        # pivot switches (Switch(pred, pred)) and their control-pivot
        # identities exist only to carry branch control deps; skip them
        pivots = {
            s for s in switch_names
            if _input_name(by_name[s].input[0])[0]
            == _input_name(by_name[s].input[1])[0]
        }
        pivot_ids = {
            n.name for n in nodes
            if n.op == "Identity" and n.name not in in_frame
            and _input_name(n.input[0])[0] in pivots
        }

        def trace(raw):
            """Walk back from a merge input to the feeding Switches."""
            interior, used, votes = set(), [], set()
            stack = [_input_name(raw)]
            while stack:
                b, i = stack.pop()
                if b in switch_names:
                    if b not in used:
                        used.append(b)
                    if b not in pivots:
                        votes.add(1 if i >= 1 else 0)
                    continue
                node = by_name.get(b)
                if node is None or b in interior:
                    continue
                if node.op == "Merge":
                    raise TFImportError(
                        f"nested V1 tf.cond (Merge {b} inside a branch) "
                        "not supported"
                    )
                interior.add(b)
                for r in node.input:
                    if r.startswith("^"):
                        # control deps vote via the pivot identities
                        base, _ = _input_name(r)
                        piv = by_name.get(base)
                        if piv is not None and base in pivot_ids:
                            _, pidx = _input_name(piv.input[0])
                            votes.add(1 if pidx >= 1 else 0)
                        continue
                    stack.append(_input_name(r))
            return interior, used, votes

        plans: Dict[str, dict] = {}
        first = True
        for m in merges:
            ins = [i for i in m.input if not i.startswith("^")][:2]
            sides = {}
            members = {m.name}
            switches: List[str] = []
            for raw in ins:
                interior, used, votes = trace(raw)
                members |= interior
                for s in used:
                    if s not in switches and s not in pivots:
                        switches.append(s)
                if len(votes) == 1:
                    sides[votes.pop()] = raw
                elif len(votes) > 1:
                    raise TFImportError(
                        f"Merge {m.name}: branch mixes both Switch outputs"
                    )
                else:
                    sides.setdefault(None, raw)
            if None in sides:  # constant branch: it is the other side
                known = [k for k in sides if k is not None]
                if len(known) != 1:
                    raise TFImportError(
                        f"Merge {m.name}: cannot attribute branches to "
                        "Switch outputs"
                    )
                sides[1 - known[0]] = sides.pop(None)
            if 0 not in sides or 1 not in sides:
                raise TFImportError(
                    f"Merge {m.name}: could not identify both cond branches"
                )
            some_sw = by_name[switches[0]] if switches else by_name[
                next(iter(pivots))
            ]
            members |= set(switches)
            if first:  # pivots are shared across all merges of one cond
                members |= pivots | pivot_ids
                first = False
            plans[m.name] = {
                "merge": m,
                "members": members,
                "true_ref": sides[1],
                "false_ref": sides[0],
                "switches": switches,
                "switch_nodes": [by_name[s] for s in switches],
                "pred_ref": some_sw.input[1],
                "interior_order": [
                    n for n in nodes
                    if n.name in members and n.op not in
                    ("Switch", "Merge", "Identity") or
                    (n.name in members and n.op == "Identity"
                     and n.name not in pivot_ids)
                ],
            }
        return plans

    def _import_v1_cond(self, plan: dict) -> None:
        m = plan["merge"]
        interior = [
            n for n in plan["interior_order"]
            if n.op not in ("Switch", "Merge")
        ]
        args = [
            self.in_var(
                next(i for i in sw_node.input if not i.startswith("^"))
            )
            for sw_node in plan["switch_nodes"]
        ]
        true_fn = self._sub(
            interior, [f"{sw}:1" for sw in plan["switches"]],
            [plan["true_ref"]], funcs=self._funcs,
            label=f"cond {m.name!r} true branch",
        )
        false_fn = self._sub(
            interior, [sw for sw in plan["switches"]],
            [plan["false_ref"]], funcs=self._funcs,
            label=f"cond {m.name!r} false branch",
        )
        pred = self.in_var(plan["pred_ref"])
        out = self.sd.if_cond(
            pred,
            lambda *a: true_fn(*a)[0],
            lambda *a: false_fn(*a)[0],
            *args,
            name=m.name,
        )
        self.vars[m.name] = out

    # -- V2 functional control flow (While/If + FunctionDef library) --
    @staticmethod
    def _norm_fref(raw: str) -> str:
        """FunctionDef node inputs are 'node:out_arg:idx'; normalize to the
        GraphDef 'node[:idx]' form the op handlers expect.  (Assumes
        single-tensor output args — true for every op this importer maps.)"""
        if raw.startswith("^"):
            return raw
        parts = raw.split(":")
        if len(parts) == 3:
            name, _arg, idx = parts
            return name if idx == "0" else f"{name}:{idx}"
        return raw

    def _func_fn(self, fref, label: str) -> "_SubgraphFn":
        fname = getattr(fref, "name", None) or str(fref)
        fd = self._funcs.get(fname)
        if fd is None:
            raise TFImportError(
                f"{label}: function {fname!r} not found in the GraphDef "
                "library"
            )
        in_names = [a.name for a in fd.signature.input_arg]
        nodes = []
        for nd in fd.node_def:
            c = type(nd)()
            c.CopyFrom(nd)
            norm = [self._norm_fref(i) for i in nd.input]
            del c.input[:]
            c.input.extend(norm)
            nodes.append(c)
        outs = [self._norm_fref(fd.ret[a.name])
                for a in fd.signature.output_arg]
        return self._sub(nodes, in_names, outs, funcs=self._funcs,
                           label=f"function {fname!r}",
                           loop_trip_bound=self.loop_trip_bound)

    def _bind_multi(self, node, outs) -> None:
        self.vars[node.name] = outs[0]
        for i, o in enumerate(outs):
            self.vars[f"{node.name}:{i}"] = o

    def op_StatelessWhile(self, node):
        cond_fn = self._func_fn(self.attr(node, "cond"), node.name)
        body_fn = self._func_fn(self.attr(node, "body"), node.name)
        ins = self.data_inputs(node)
        init = [self.in_var(i) for i in ins]
        static_inits = []
        for i in ins:
            base, idx = _input_name(i)
            sv = self.consts.get(base) if idx == 0 else None
            static_inits.append(
                None if sv is None or self._promotable(sv) else sv)
        c_nodes, c_in, c_out = cond_fn.src
        b_nodes, b_in, b_out = body_fn.src
        trip = self._static_trip_count(
            c_nodes, c_in, c_out[0], b_nodes, b_in, b_out,
            {}, static_inits, f"While {node.name!r}")
        bound = trip if trip is not None else self.loop_trip_bound
        outs = self.sd.while_loop(
            lambda *vs: cond_fn(*vs)[0],
            lambda *vs: body_fn(*vs),
            *init,
            max_trip=bound, exact_trip=trip is not None,
        )
        self._bind_multi(node, outs)

    op_While = op_StatelessWhile

    def op_StatelessIf(self, node):
        ins = self.data_inputs(node)
        pred = self.in_var(ins[0])
        args = [self.in_var(i) for i in ins[1:]]
        then_fn = self._func_fn(self.attr(node, "then_branch"), node.name)
        else_fn = self._func_fn(self.attr(node, "else_branch"), node.name)
        n_out = max(len(self.attr(node, "Tout", []) or []), 1)

        def fn(p, *a):
            # the predicate is read on the host: the graph runs eagerly
            return tuple(then_fn(*a) if bool(_pred(p)) else else_fn(*a))

        outs = self.sd.py_call(fn, pred, *args, n_out=n_out, name=node.name)
        self._bind_multi(node, outs)

    op_If = op_StatelessIf

    def op_PartitionedCall(self, node):
        fn = self._func_fn(self.attr(node, "f"), node.name)
        args = [self.in_var(i) for i in self.data_inputs(node)]
        outs = self.sd.py_call(
            lambda *a: fn(*a), *args, n_out=len(fn.out_keys), name=node.name
        )
        self._bind_multi(node, outs)

    op_StatefulPartitionedCall = op_PartitionedCall


class _SubgraphFn:
    """A TF subgraph as a Python callable over tensors: the body of an
    imported while_loop / if_cond / py_call.  Built once at import: the
    named inputs become placeholders of a private SameDiff (on
    ``device``), the node list is backward-sliced from the outputs and
    imported through the same op_* handlers, and each call interprets
    that sub-SameDiff (`SameDiff._execute`)."""

    def __init__(self, nodes, inputs: List[str], outputs: List[str], *,
                 statics: Optional[Dict[str, np.ndarray]] = None,
                 funcs: Optional[dict] = None, label: str = "",
                 loop_trip_bound: Optional[int] = None, device=None):
        imp = _Importer.__new__(_Importer)
        imp.gd = None
        imp.sd = SameDiff(device=device)
        imp.trainable = False
        imp.vars = {}
        imp.consts = dict(statics or {})
        imp._promoted = {}
        imp._funcs = funcs or {}
        # a user-supplied dynamic-loop bound applies to nested loops too
        imp.loop_trip_bound = loop_trip_bound
        self._imp = imp
        # source structure, kept for static trip-count inference over
        # functional (V2) loops
        self.src = (list(nodes), list(inputs), list(outputs))
        self.in_keys: List[str] = []
        for i, nm in enumerate(inputs):
            ph = imp.sd.placeholder(f"arg{i}")
            imp.vars[nm] = ph
            self.in_keys.append(ph.name)
        imp.sd.reserve_names(n.name for n in nodes)
        needed = self._slice(nodes, outputs)
        try:
            imp._run_structured([n for n in nodes if n.name in needed])
        except TFImportError as exc:
            raise TFImportError(f"{label}: {exc}") from exc
        self.out_keys = [imp.in_var(r).name for r in outputs]
        self.host_controlled = imp.sd.host_controlled()

    @staticmethod
    def _slice(nodes, outputs) -> set:
        # the shared backward slice, restricted to nodes in this subgraph
        # (external leaves are the slice's inputs, not members)
        return _backward_slice_bases(nodes, outputs) & {n.name for n in nodes}

    def __call__(self, *args):
        env = dict(self._imp.sd._values)
        env.update(zip(self.in_keys, args))
        return self._imp.sd._execute(env, tuple(self.out_keys))


def import_graph(path_or_graphdef, trainable: bool = False,
                 loop_trip_bound: int | None = None, device=None) -> SameDiff:
    """Import a frozen TF GraphDef (a binary .pb path, bytes, a file
    object, or a `wire.GraphDef`) onto ``device`` (None: CUDA).

    Reference entry: `TFGraphMapper.importGraph(File)`.  ``trainable=True``
    promotes frozen float weight tensors to trainable variables, so the
    graph can be fine-tuned (attach a loss with `set_loss` and
    `set_training_config`, then `fit`).  Loops whose trip count is
    provable run exactly that many times and are differentiable; for a
    data-dependent loop ``loop_trip_bound=N`` gives a differentiable
    bounded loop, correct while it never runs more than N times."""
    from deeplearning4j_tpu_torch.modelimport._tf import wire

    gd = path_or_graphdef
    if isinstance(gd, (str, bytes, bytearray, memoryview)) or hasattr(gd, "read"):
        if isinstance(gd, str):
            with open(gd, "rb") as f:
                raw = f.read()
        elif hasattr(gd, "read"):
            raw = gd.read()
        else:
            raw = gd
        gd = wire.GraphDef()
        gd.ParseFromString(raw)
    else:
        raw = gd.SerializeToString()
    sd = _Importer(gd, trainable=trainable, loop_trip_bound=loop_trip_bound,
                   device=device).run()
    # source-backed serde: the original bytes ARE the graph serialization
    # for imported control flow (SameDiff.save re-imports them on load)
    sd.import_source = {"kind": "tf", "raw": raw, "trainable": trainable,
                        "loop_trip_bound": loop_trip_bound}
    sd._import_op_count = len(sd._ops)
    sd._import_value_names = set(sd._values)
    return sd


def import_onnx(path, trainable: bool = False) -> SameDiff:
    """ONNX import is not ported yet (the JAX package's
    `modelimport/onnx.py`)."""
    raise NotImplementedError("ONNX import is not ported yet; it waits in ROADMAP A13")


class TFGraphMapper:
    """Static facade matching the reference entry-point naming."""

    import_graph = staticmethod(import_graph)
