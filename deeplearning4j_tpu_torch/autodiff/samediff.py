"""SameDiff — the port's counterpart of `deeplearning4j_tpu/autodiff/
samediff.py`: the reference's declarative autodiff graph (named
variables, placeholders and constants, op namespaces, operator
overloading on `SDVariable`, a `TrainingConfig`), run by PyTorch.

Execution.  `_execute` interprets the recorded ops in construction order
(topological) over an environment of torch tensors: `output` runs it
under ``no_grad``, `grad` differentiates the loss with
``torch.autograd.grad``, and `fit_batch` runs the whole training step —
forward, backward, the updater (`nn/updaters.py`, optax's arithmetic)
and the parameters updated in place.

The step on the card.  A graph without host-side control flow (no
``_cond``, no unbounded ``_while``, no ``_pyfunc``, at any depth of an
imported graph's loop bodies) runs each `fit_batch` as the replay of one
CUDA graph per placeholder signature (`runtime/graphs.py`
`CapturedProgram`): its first step is the graph's eager warm-up, and
the placeholders, the step's random key and the updater's step values
are the graph's static inputs, refilled before each replay; the
parameters, the optimizer state and the constants are read and written
in place.  ``capture_steps = False`` runs the same program eagerly on
the same device inputs: the same bits.  `set_value`,
`set_training_config`, `load`, a new loss or a new op drop the graphs.
Graphs with host-side control flow run eagerly on the card: ``_cond``
reads its predicate on the host, an unbounded ``_while`` is a host loop
over its predicate, and ``_pyfunc`` is Python.

Mixed precision (``TrainingConfig.bf16_compute``): every floating value
of the environment — placeholders, constants, frozen values and the
trainables — is cast to bf16 inside the step, while the masters, the
gradients and the updater state stay f32; `mha` then takes its bf16
route (kernels B1-B3).

Dtypes follow the JAX package with x64 off: int64 values (constants,
placeholders) are held as int32 and float64 as float32, trainables as
float32.

Serialization is the JAX package's zip: ``graph.json``, ``values.npz``,
``rng_state.json`` and ``opt_state.npz`` (optax's state leaves in
``jax.tree.leaves`` order), or, for an imported graph with control flow,
``import_manifest.json`` and ``import_source.bin`` (the original bytes,
re-imported on load).  A zip written by either package loads in the
other.
"""

from __future__ import annotations

import dataclasses
import io
import json
import zipfile
import zlib
from typing import Any

import numpy as np
import torch

from deeplearning4j_tpu_torch.autodiff.ops_registry import device_scope, get_op
from deeplearning4j_tpu_torch.nn.updaters import (
    Sgd,
    Updater,
    advance_counts,
    load_state_leaves,
    state_leaves,
)
from deeplearning4j_tpu_torch.runtime import rng as rng_mod
from deeplearning4j_tpu_torch.runtime.backend import resolve_device
from deeplearning4j_tpu_torch.utils import serde

_NARROW_NP = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32,
              np.dtype(np.uint64): np.int32, np.dtype(np.complex128): np.complex64}
_NARROW_T = {torch.int64: torch.int32, torch.float64: torch.float32,
             torch.complex128: torch.complex64}


def as_tensor(value, device, dtype=None) -> torch.Tensor:
    """``value`` as a tensor on ``device`` the way ``jnp.asarray`` holds
    it with x64 off (int64 -> int32, float64 -> float32), or in ``dtype``."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        t = t.to(dtype if dtype is not None else _NARROW_T.get(t.dtype, t.dtype))
        return t.to(device)
    arr = np.asarray(value)
    if dtype is None:
        to = _NARROW_NP.get(arr.dtype)
        if to is not None:
            arr = arr.astype(to)
    # torch.tensor copies (a read-only numpy view is fine) straight to the device
    t = torch.tensor(arr, device=device)
    return t if dtype is None else t.to(dtype)


@dataclasses.dataclass
class SDVariable:
    """Symbolic handle to a graph value (reference SDVariable)."""

    sd: "SameDiff"
    name: str
    kind: str  # "variable" | "placeholder" | "constant" | "op"

    # -- operator overloading (the sd.math namespace) ----------------------
    def _bin(self, other, op):
        other = self.sd._lift(other)
        return self.sd.apply(op, self, other)

    def __add__(self, o):
        return self._bin(o, "add")

    def __radd__(self, o):
        return self.sd._lift(o)._bin(self, "add")

    def __sub__(self, o):
        return self._bin(o, "sub")

    def __rsub__(self, o):
        return self.sd._lift(o)._bin(self, "sub")

    def __mul__(self, o):
        return self._bin(o, "mul")

    def __rmul__(self, o):
        return self.sd._lift(o)._bin(self, "mul")

    def __truediv__(self, o):
        return self._bin(o, "div")

    def __rtruediv__(self, o):
        return self.sd._lift(o)._bin(self, "div")

    def __pow__(self, o):
        return self._bin(o, "pow")

    def __neg__(self):
        return self.sd.apply("neg", self)

    def __matmul__(self, o):
        return self._bin(o, "matmul")

    def sum(self, axis=None, keepdims=False):
        return self.sd.apply("sum", self, axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return self.sd.apply("mean", self, axis=axis, keepdims=keepdims)

    def reshape(self, shape):
        return self.sd.apply("reshape", self, shape=tuple(shape))

    def transpose(self, axes=None):
        return self.sd.apply("transpose", self, axes=axes)

    def eval(self, placeholders: dict[str, Any] | None = None):
        """Concrete value of this variable (reference SDVariable.eval())."""
        return self.sd.output(placeholders or {}, self.name)

    def __repr__(self):
        return f"SDVariable({self.name!r}, {self.kind})"


@dataclasses.dataclass
class _OpNode:
    op: str
    inputs: tuple[str, ...]
    output: str
    attrs: dict[str, Any]


class _Namespace:
    """sd.nn / sd.loss / sd.math ... function namespaces."""

    def __init__(self, sd: "SameDiff", ops: tuple[str, ...]):
        self._sd = sd
        self._ops = set(ops)

    def __getattr__(self, op: str):
        if op.startswith("_") or op not in self._ops:
            raise AttributeError(op)

        def call(*args, name: str | None = None, **attrs):
            vars_ = [self._sd._lift(a) for a in args]
            return self._sd.apply(op, *vars_, name=name, **attrs)

        return call


_NN_OPS = (
    "relu", "relu6", "leaky_relu", "elu", "selu", "gelu", "silu", "sigmoid",
    "tanh", "softmax", "log_softmax", "softplus", "conv2d", "max_pool2d",
    "avg_pool2d", "layer_norm", "bias_add", "dropout", "one_hot",
    "multi_head_dot_product_attention", "softsign", "hard_sigmoid",
    "hard_tanh", "rationaltanh", "prelu", "thresholded_relu", "log_sigmoid",
    "mish", "swish", "standardize", "xw_plus_b",
    "hard_swish", "celu", "glu", "softshrink", "hardshrink", "tanhshrink",
)
_LOSS_OPS = (
    "softmax_cross_entropy", "sparse_softmax_cross_entropy",
    "sigmoid_cross_entropy", "mse_loss", "l1_loss",
    "huber_loss", "hinge_loss", "log_loss", "absolute_difference",
    "poisson_loss", "kl_divergence", "cosine_proximity_loss",
    "weighted_cross_entropy_with_logits", "log_cosh_loss",
)
_MATH_OPS = (
    "add", "sub", "mul", "div", "pow", "neg", "abs", "exp", "log", "sqrt",
    "square", "rsqrt", "sign", "floor", "ceil", "clip", "maximum", "minimum",
    "greater", "less", "equal", "where", "matmul", "transpose", "einsum",
    "tensordot", "reshape", "concat", "stack", "squeeze", "expand_dims",
    "gather", "one_hot", "tile", "pad", "sum", "mean", "max", "min", "prod",
    "var", "std", "argmax", "argmin", "norm2", "cumsum", "sin", "cos",
    "tan", "asin", "acos", "atan", "sinh", "cosh", "asinh", "acosh",
    "atanh", "round", "trunc", "is_nan", "is_inf", "is_finite", "log1p",
    "expm1", "erf", "erfc", "cube", "logsumexp", "cumprod", "sort",
    "argsort", "top_k_values", "top_k_indices", "segment_sum",
    "segment_max", "segment_min", "segment_mean", "reverse", "roll",
    "dot", "cosine_similarity", "cosine_distance", "euclidean_distance",
    "manhattan_distance", "hamming_distance", "jaccard_distance",
    "norm1", "norm_max", "squared_norm", "count_nonzero", "count_zero",
    "amean", "amax", "amin", "entropy", "shannon_entropy", "log_entropy",
    "moments", "percentile", "median", "iamax", "iamin",
    "first_index_nonzero", "last_index_nonzero",
    "scatter_add", "scatter_sub", "scatter_mul", "scatter_update",
    "scatter_max", "scatter_min", "gather_nd", "scatter_nd",
    "zeros_like", "ones_like", "full_like", "eye", "linspace", "range",
    "fill", "reverse_sequence", "sequence_mask",
    "lgamma", "digamma", "igamma", "igammac", "zeta", "polygamma",
    "betainc", "truncate_div", "floor_mod", "clip_by_norm",
    "confusion_matrix",
    "all", "any", "cumulative_logsumexp", "cummax", "cummin",
    "unsorted_segment_sum", "unsorted_segment_max", "unsorted_segment_min",
    "unsorted_segment_mean", "unsorted_segment_prod", "segment_prod",
    "unique_with_pad", "bincount", "searchsorted", "invert_permutation",
    "histogram_fixed_width", "nan_to_num", "nansum", "nanmean", "nanmax",
    "nanmin", "nanstd", "ptp", "rint", "heaviside", "copysign", "nextafter",
    "deg2rad", "rad2deg", "sinc", "logaddexp", "logaddexp2", "hypot",
    "signbit", "ldexp", "logit", "erfinv", "ndtr", "ndtri", "lerp",
    "popcount", "isclose", "fake_quant",
)
_CNN_OPS = (
    "conv1d", "conv2d", "conv3d", "depthwise_conv2d", "deconv2d",
    "max_pool2d", "avg_pool2d", "batch_norm", "im2col", "space_to_depth",
    "depth_to_space",
)
_RNN_OPS = ("lstm_cell", "gru_cell")
_IMAGE_OPS = (
    "resize", "crop", "flip_lr", "flip_ud", "adjust_brightness",
    "adjust_contrast", "rgb_to_grayscale", "normalize_image",
    "rgb_to_hsv", "hsv_to_rgb", "adjust_hue", "adjust_saturation",
    "crop_and_resize", "non_max_suppression", "extract_image_patches",
    "space_to_batch", "batch_to_space",
    "image_gradients", "sobel_edges", "total_variation", "psnr", "ssim",
    "rot90", "grayscale_to_rgb", "central_crop",
)
_LINALG_OPS = (
    "matmul", "inv", "det", "cholesky", "solve", "svd", "qr", "matrix_trace",
    "diag", "diag_part", "matrix_transpose", "lstsq", "triu", "tril",
    "tensordot", "einsum", "matrix_band_part", "matrix_diag",
    "matrix_set_diag",
    "eigh_values", "eigh_vectors", "logdet", "slogdet_sign", "pinv",
    "triangular_solve", "matrix_power", "kron", "matrix_rank", "expm",
    "lu_factor", "outer", "cross", "vander", "diagflat", "matrix_norm",
    "cond_number",
)
_BITWISE_OPS = (
    "bitwise_and", "bitwise_or", "bitwise_xor", "bitwise_not",
    "left_shift", "right_shift",
)
_RANDOM_OPS = (
    "random_normal", "random_uniform", "random_bernoulli",
    "random_exponential",
    "random_gamma", "random_poisson", "random_truncated_normal",
    "random_shuffle", "random_categorical", "random_laplace",
    "random_cauchy", "random_rademacher", "random_beta",
)
_SIGNAL_OPS = (
    "hann_window", "hamming_window", "blackman_window", "frame", "stft",
    "istft", "fft", "ifft", "rfft", "irfft", "fft2", "ifft2", "real",
    "imag", "complex_abs", "angle",
)


@serde.register
@dataclasses.dataclass(frozen=True)
class TrainingConfig:
    """The reference's org.nd4j.autodiff.samediff.TrainingConfig.

    bf16_compute: cast every floating value to bfloat16 inside the step
    while the masters, the gradients and the updater state stay f32 (see
    the module docstring).  Off by default: imported graphs keep exact
    f32."""

    updater: Updater = dataclasses.field(default_factory=Sgd)
    l2: float = 0.0
    loss_variable: str = ""
    bf16_compute: bool = False


def _pred(x) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return t.to(torch.bool).reshape(())


class SameDiff:
    """The autodiff graph; see the module docstring.  ``device``: where
    values live and the graph runs (None: CUDA, raising without it)."""

    _CF_OPS = ("_cond", "_while", "_pyfunc")

    def __init__(self, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self._vars: dict[str, SDVariable] = {}
        self._values: dict[str, torch.Tensor] = {}   # variables + constants
        self._trainable: set[str] = set()
        self._placeholders: set[str] = set()
        self._ops: list[_OpNode] = []
        self._loss_var: str | None = None
        self._training_config: TrainingConfig | None = None
        self._opt_state = None
        self._stream = rng_mod.SeedStream(seed)
        self._captured: dict = {}          # placeholder signature -> CapturedProgram
        self._counter = 0
        self._updating = False
        #: set by an importer whose loop bodies hold host-side control flow
        self._host_control = False
        #: run the card's steps as CUDA graph replays (False: eagerly)
        self.capture_steps = True
        self.nn = _Namespace(self, _NN_OPS)
        self.loss = _Namespace(self, _LOSS_OPS)
        self.math = _Namespace(self, _MATH_OPS)
        self.cnn = _Namespace(self, _CNN_OPS)
        self.rnn = _Namespace(self, _RNN_OPS)
        self.image = _Namespace(self, _IMAGE_OPS)
        self.linalg = _Namespace(self, _LINALG_OPS)
        self.bitwise = _Namespace(self, _BITWISE_OPS)
        self.random = _Namespace(self, _RANDOM_OPS)
        self.signal = _Namespace(self, _SIGNAL_OPS)

    # -- graph construction ------------------------------------------------
    def _fresh(self, base: str) -> str:
        # skip names taken or reserved: imported graphs share this namespace
        reserved = getattr(self, "_reserved", ())
        while True:
            self._counter += 1
            name = f"{base}_{self._counter}"
            if name not in self._vars and name not in reserved:
                return name

    def reserve_names(self, names) -> None:
        """Mark names as taken so auto-generated op names never collide
        (graph importers reserve every node name first)."""
        if not hasattr(self, "_reserved"):
            self._reserved = set()
        self._reserved.update(names)

    def _register(self, name: str, kind: str) -> SDVariable:
        if name in self._vars:
            raise ValueError(f"variable {name!r} already exists")
        v = SDVariable(self, name, kind)
        self._vars[name] = v
        return v

    def placeholder(self, name: str, shape=None, dtype=None) -> SDVariable:
        v = self._register(name, "placeholder")
        self._placeholders.add(name)
        return v

    def var(self, name: str, value) -> SDVariable:
        """Trainable f32 variable with an initial value (reference sd.var())."""
        v = self._register(name, "variable")
        self._values[name] = as_tensor(value, self.device, torch.float32)
        self._trainable.add(name)
        return v

    def constant(self, name: str, value) -> SDVariable:
        v = self._register(name, "constant")
        self._values[name] = as_tensor(value, self.device)
        return v

    def _lift(self, x) -> SDVariable:
        if isinstance(x, SDVariable):
            return x
        return self.constant(self._fresh("const"), x)

    def apply(self, op: str, *inputs: SDVariable, name: str | None = None, **attrs) -> SDVariable:
        get_op(op)  # validate eagerly
        out_name = name or self._fresh(op)
        v = self._register(out_name, "op")
        self._ops.append(_OpNode(op, tuple(i.name for i in inputs), out_name, attrs))
        self._captured.clear()
        return v

    def set_loss(self, v: SDVariable) -> None:
        self._loss_var = v.name
        self._captured.clear()

    # -- control flow -------------------------------------------------------
    def if_cond(self, pred: SDVariable, true_fn, false_fn, *inputs: SDVariable,
                name: str | None = None) -> SDVariable:
        """``true_fn(*inputs)`` or ``false_fn(*inputs)`` (tensors in, one
        tensor out) by ``pred``, read on the host when the graph runs."""
        out = name or self._fresh("cond")
        v = self._register(out, "op")
        self._ops.append(_OpNode(
            "_cond", (pred.name,) + tuple(i.name for i in inputs), out,
            {"true_fn": true_fn, "false_fn": false_fn},
        ))
        self._captured.clear()
        return v

    def while_loop(self, cond_fn, body_fn, *loop_vars: SDVariable,
                   name: str | None = None, max_trip: int | None = None,
                   exact_trip: bool = False) -> tuple[SDVariable, ...]:
        """``cond_fn(*vars) -> bool scalar``, ``body_fn(*vars) -> tuple of
        same-shaped vars``; returns the final loop variables.

        - ``max_trip=T, exact_trip=True``: the body runs exactly T times,
          no predicate.
        - ``max_trip=T`` alone: T steps; each evaluates the predicate and
          keeps the carried values once it is false.  After it turns
          false the body still runs, on the INITIAL values, its result
          discarded (the JAX package's double ``where``, which keeps a
          body that goes NaN outside the predicate's domain out of the
          gradient).  Correct while the true trip count is at most T; a
          zero-trip loop still runs the body once on its initial values.
        - no ``max_trip``: a host loop over the predicate (the JAX
          package's ``lax.while_loop``, forward-only there); the graph
          then runs eagerly.
        Both bounded forms are differentiable."""
        base = name or self._fresh("while")
        tuple_name = base + "#tuple"
        self._register(tuple_name, "op")
        self._ops.append(_OpNode(
            "_while", tuple(v.name for v in loop_vars), tuple_name,
            {"cond_fn": cond_fn, "body_fn": body_fn,
             "max_trip": max_trip, "exact_trip": exact_trip},
        ))
        outs = []
        for i in range(len(loop_vars)):
            nm = f"{base}_{i}"
            vv = self._register(nm, "op")
            self._ops.append(_OpNode("_tuple_get", (tuple_name,), nm, {"index": i}))
            outs.append(vv)
        self._captured.clear()
        return tuple(outs)

    def py_call(self, fn, *inputs: SDVariable, n_out: int = 1,
                name: str | None = None) -> tuple[SDVariable, ...]:
        """``fn(*tensors) -> tuple of n_out tensors`` spliced into the
        graph as one node (the TF importer's functional If and
        PartitionedCall).  A graph holding one runs eagerly and, like
        if_cond / while_loop, serializes only as an imported graph."""
        base = name or self._fresh("call")
        tuple_name = base + "#tuple"
        self._register(tuple_name, "op")
        self._ops.append(_OpNode(
            "_pyfunc", tuple(v.name for v in inputs), tuple_name,
            {"fn": fn, "n_out": n_out},
        ))
        outs = []
        for i in range(n_out):
            nm = base if n_out == 1 else f"{base}_{i}"
            vv = self._register(nm, "op")
            self._ops.append(_OpNode("_tuple_get", (tuple_name,), nm, {"index": i}))
            outs.append(vv)
        self._captured.clear()
        return tuple(outs)

    def host_controlled(self) -> bool:
        """True when running the graph reads values on the host (a
        ``_cond``, an unbounded ``_while``, a ``_pyfunc``, here or in an
        imported loop body): such a graph is never captured."""
        return self._host_control or any(
            n.op in ("_cond", "_pyfunc")
            or (n.op == "_while" and n.attrs.get("max_trip") is None)
            for n in self._ops)

    # -- execution ---------------------------------------------------------
    def _execute(self, values: dict, requested: tuple[str, ...], rng=None):
        """Interpret the ops in construction order (topological) over
        ``values``; ``rng``: the step's key (two 32-bit words, Python
        ints or a (2,) int64 tensor) for dropout, None for inference."""
        env = dict(values)
        needed = set(requested)
        with device_scope(self.device):
            for node in self._ops:
                if node.output in env:
                    continue
                if any(i not in env for i in node.inputs):
                    # depends on an unfed placeholder: legal when the
                    # requested outputs do not need it (checked below)
                    continue
                args = [env[i] for i in node.inputs]
                attrs = node.attrs
                if node.op == "_cond":
                    fn = attrs["true_fn"] if bool(_pred(args[0])) else attrs["false_fn"]
                    env[node.output] = fn(*args[1:])
                elif node.op == "_while":
                    env[node.output] = self._run_while(attrs, tuple(args))
                elif node.op == "_pyfunc":
                    out = attrs["fn"](*args)
                    env[node.output] = tuple(out) if isinstance(out, (tuple, list)) else (out,)
                elif node.op == "_tuple_get":
                    env[node.output] = args[0][attrs["index"]]
                elif node.op == "dropout" and rng is not None:
                    env[node.output] = self._dropout(node, args[0], rng)
                else:
                    env[node.output] = get_op(node.op)(*args, **attrs)
        missing = needed - set(env)
        if missing:
            raise KeyError(f"variables never computed: {sorted(missing)}")
        return tuple(env[r] for r in requested)

    @staticmethod
    def _run_while(attrs: dict, init: tuple) -> tuple:
        body, cond = attrs["body_fn"], attrs["cond_fn"]
        max_trip = attrs.get("max_trip")

        def step(vs):
            out = body(*vs)
            return tuple(out) if isinstance(out, (tuple, list)) else (out,)

        vs = init
        if max_trip is None:
            while bool(_pred(cond(*vs))):
                vs = step(vs)
            return vs
        if attrs.get("exact_trip"):
            for _ in range(int(max_trip)):
                vs = step(vs)
            return vs
        for _ in range(int(max_trip)):
            pred = _pred(cond(*vs))
            # double where: past termination the body runs on the initial
            # values (body-safe for any loop that iterates), not the carry
            safe = tuple(torch.where(pred, v, v0) for v, v0 in zip(vs, init))
            new = step(safe)
            vs = tuple(torch.where(pred, n, o) for n, o in zip(new, vs))
        return vs

    @staticmethod
    def _dropout(node: _OpNode, x: torch.Tensor, key):
        """Inverted dropout with the JAX package's mask: the step key
        folded with crc32 of the node's name, ``bernoulli(1 - rate)``."""
        keep = 1.0 - node.attrs.get("rate", 0.5)
        k = rng_mod.fold_in((key[0], key[1]), zlib.crc32(node.output.encode()))
        m = rng_mod.bernoulli(k, keep, tuple(x.shape), device=x.device)
        return torch.where(m, x / torch.full((), keep, dtype=x.dtype, device=x.device),
                           0.0).to(x.dtype)

    def _required_placeholders(self, outputs: tuple[str, ...]) -> set[str]:
        """Placeholders reachable walking backward from the outputs."""
        producers = {n.output: n for n in self._ops}
        needed: set[str] = set()
        stack = list(outputs)
        seen: set[str] = set()
        while stack:
            name = stack.pop()
            if name in seen:
                continue
            seen.add(name)
            if name in self._placeholders:
                needed.add(name)
            elif name in producers:
                stack.extend(producers[name].inputs)
        return needed

    def _feed(self, placeholders: dict) -> dict:
        return {k: as_tensor(v, self.device) for k, v in placeholders.items()}

    def output(self, placeholders: dict[str, Any], *outputs: str):
        """Forward pass (reference SameDiff.output()): a tensor, or a
        tuple of them for several outputs."""
        missing = self._required_placeholders(outputs) - set(placeholders)
        if missing:
            raise ValueError(f"missing placeholder values: {sorted(missing)}")
        with torch.no_grad():
            res = self._execute({**self._values, **self._feed(placeholders)}, outputs)
        return res if len(outputs) > 1 else res[0]

    def grad(self, placeholders: dict[str, Any], *wrt: str) -> dict:
        """Gradients of the loss variable with respect to the given (or
        all) trainable variables."""
        if self._loss_var is None:
            raise ValueError("no loss variable set; call set_loss()")
        wrt = wrt or tuple(sorted(self._trainable))
        with torch.enable_grad():
            leaves = {n: self._values[n].detach().requires_grad_(True) for n in wrt}
            env = {**self._values, **leaves, **self._feed(placeholders)}
            (loss,) = self._execute(env, (self._loss_var,))
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return {n: (g if g is not None else torch.zeros_like(leaves[n])).detach()
                for n, g in zip(wrt, grads)}

    # -- training ----------------------------------------------------------
    def set_training_config(self, cfg: TrainingConfig) -> None:
        self._training_config = cfg
        if cfg.loss_variable:
            self._loss_var = cfg.loss_variable
        self._opt_state = None
        self._captured.clear()

    def _step(self, tx, names, ph: dict, key, vals):
        """One training step on the live values: loss, gradients of the
        trainables, the updater and the trainables updated in place.
        Returns the f32 loss and the updater's new state."""
        cfg = self._training_config
        train = [self._values[n] for n in names]
        frozen = {k: v for k, v in self._values.items() if k not in self._trainable}
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in train]
            env = {**frozen, **dict(zip(names, leaves)), **ph}
            if cfg.bf16_compute:
                env = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
                       for k, v in env.items()}
            (loss,) = self._execute(env, (self._loss_var,), rng=key)
            loss = loss.float()
            if cfg.l2:
                for v in leaves:
                    loss = loss + 0.5 * cfg.l2 * torch.sum(torch.square(v))
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(p) for g, p in zip(grads, train)]
        # from here the live values are written in place
        self._updating = True
        updates, state = tx.update(grads, self._opt_state, train, vals)
        with torch.no_grad():
            for p, u in zip(train, updates):
                p.add_(u.to(p.dtype))
        self._updating = False
        return loss.detach(), state

    def fit_batch(self, placeholders: dict[str, Any], sync: bool = True):
        """One training step (the TrainingSession.trainingIteration role).

        ``sync=True`` returns the loss as a Python float; ``sync=False``
        the device scalar, so back-to-back steps queue without a wait.

        Failure: a step that fails after it began writing the trainables
        or the optimizer state in place (inside the updater, or during a
        graph replay) leaves them torn, and raises a RuntimeError saying
        the instance is no longer retryable, chained to the cause;
        errors before that leave the instance intact."""
        if self._training_config is None:
            raise ValueError("call set_training_config() first")
        if self._loss_var is None:
            raise ValueError("no loss variable set")
        tx = self._training_config.updater.to_tx()
        names = sorted(self._trainable)
        if self._opt_state is None:
            self._opt_state = tx.init([self._values[n] for n in names])
            self._captured.clear()
        ph = self._feed(placeholders)
        key = self._stream.next()
        try:
            if self.device.type == "cuda":
                loss = self._fit_cuda(tx, names, ph, key)
            else:
                loss, self._opt_state = self._step(tx, names, ph, key, None)
        except Exception as exc:
            if self._updating:
                self._updating = False
                raise RuntimeError(
                    f"fit_batch failed after it began updating {len(names)} trainable "
                    "tensor(s) and the optimizer state in place; this SameDiff "
                    "instance is no longer retryable — restore from a checkpoint or "
                    "re-import") from exc
            raise
        return float(loss) if sync else loss

    def _fit_cuda(self, tx, names, ph: dict, key) -> torch.Tensor:
        """The step on the card from device inputs: the key and the
        updater's step values staged as tensors; a graph replay unless
        the graph reads values on the host or ``capture_steps`` is off."""
        host_vals = np.asarray(tx.values(self._opt_state), np.float32).reshape(-1)
        key_t = torch.tensor(key, dtype=torch.int64).pin_memory().to(
            self.device, non_blocking=True)
        vals_t = torch.from_numpy(host_vals).pin_memory().to(self.device, non_blocking=True)
        ph_names = tuple(sorted(ph))
        if not self.capture_steps or self.host_controlled():
            loss, _ = self._step(tx, names, ph, (key_t[0], key_t[1]),
                                 [vals_t[i] for i in range(vals_t.shape[0])])
            self._opt_state = advance_counts(self._opt_state)
            return loss
        sig = tuple((k, tuple(ph[k].shape), ph[k].dtype) for k in ph_names)
        prog = self._captured.get(sig)
        if prog is None:
            prog = self._capture(tx, names, ph_names, [ph[k] for k in ph_names] + [key_t, vals_t])
            self._captured[sig] = prog
        else:
            for dst, src in zip(prog.inputs, [ph[k] for k in ph_names] + [key_t, vals_t]):
                dst.copy_(src)
            self._updating = True
            prog.replay()
            self._updating = False
        self._opt_state = advance_counts(self._opt_state)
        return prog.inputs[-1].clone()

    def _capture(self, tx, names, ph_names, inputs):
        """The step as a CUDA graph over static copies of ``inputs``
        (placeholders, key, step values) and a loss slot; the warm-up is
        this step itself."""
        from deeplearning4j_tpu_torch.runtime.graphs import CapturedProgram

        n_ph = len(ph_names)

        def step(*args):
            ph = dict(zip(ph_names, args[:n_ph]))
            key_t, vals_t, slot = args[n_ph:]
            loss, _ = self._step(tx, names, ph, (key_t[0], key_t[1]),
                                 [vals_t[i] for i in range(vals_t.shape[0])])
            slot.copy_(loss)
            return ()

        static = tuple(t.clone() for t in inputs)
        slot = torch.empty((), dtype=torch.float32, device=self.device)
        other = next(iter(self._captured.values()), None)
        try:
            return CapturedProgram(
                step, static + (slot,),
                keep=(dict(self._values), state_leaves(self._opt_state)),
                pool=other and other.graph.pool(), stream=other and other.stream)
        except BaseException:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            raise

    def fit(self, batches, epochs: int = 1) -> list[float]:
        if epochs > 1 and not isinstance(batches, (list, tuple)):
            batches = list(batches)    # a generator would be spent after epoch 1
        losses = []
        for _ in range(epochs):
            for ph in batches:
                losses.append(self.fit_batch(ph))
        return losses

    # -- introspection -----------------------------------------------------
    def variables(self) -> list[str]:
        return sorted(self._trainable)

    def get_value(self, name: str) -> np.ndarray:
        return self._values[name].detach().cpu().numpy().copy()

    def set_value(self, name: str, value) -> None:
        if name not in self._values:
            raise KeyError(name)
        self._values[name] = as_tensor(value, self.device, self._values[name].dtype)
        # a source-backed save must keep values changed at run time
        self._mutated_values = getattr(self, "_mutated_values", set())
        self._mutated_values.add(name)
        self._captured.clear()

    # -- serialization -------------------------------------------------------
    def _host_values(self, names) -> dict:
        return {n: self._values[n].detach().cpu().numpy() for n in names}

    def save(self, path: str) -> None:
        """Write the zip.  A graph with control flow must be an imported
        one and saves source-backed (its original bytes, re-imported on
        load); every other graph saves its ops and values."""
        cf_idx = [i for i, n in enumerate(self._ops) if n.op in self._CF_OPS]
        if cf_idx:
            src = getattr(self, "import_source", None)
            n_imp = getattr(self, "_import_op_count", None)
            if src is None or n_imp is None:
                raise ValueError(
                    "graphs containing control-flow lambdas (if_cond/"
                    "while_loop/py_call) hold Python callables and cannot be "
                    "serialized; rebuild the graph in code after load "
                    "(IMPORTED graphs save fine — the TF importer attaches "
                    "the source bytes and save() re-imports on load)")
            if any(i >= n_imp for i in cf_idx):
                raise ValueError(
                    "control-flow ops added AFTER import cannot be "
                    "serialized; keep post-import additions to plain "
                    "registry ops")
            return self._save_source_backed(path, src, n_imp)
        graph = {
            "placeholders": sorted(self._placeholders),
            "trainable": sorted(self._trainable),
            "constants": sorted(set(self._values) - self._trainable),
            "loss_var": self._loss_var,
            "counter": self._counter,
            "ops": [_node_json(n) for n in self._ops],
            "training_config": serde.to_jsonable(self._training_config)
            if self._training_config else None,
        }
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("graph.json", json.dumps(graph, indent=2))
            buf = io.BytesIO()
            np.savez(buf, **self._host_values(sorted(self._values)))
            zf.writestr("values.npz", buf.getvalue())
            self._save_opt_state(zf)

    # the Adam moments and the RNG stream's position go into the zip, so
    # the resumed step is the one the uninterrupted run would have taken
    def _save_opt_state(self, zf) -> None:
        zf.writestr("rng_state.json", json.dumps(self._stream.state_dict()))
        if self._opt_state is None:
            return
        buf = io.BytesIO()
        np.savez(buf, *[x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                        else np.asarray(x) for x in state_leaves(self._opt_state)])
        zf.writestr("opt_state.npz", buf.getvalue())

    def _load_opt_state(self, zf) -> None:
        names = zf.namelist()
        if "rng_state.json" in names:
            self._stream.load_state_dict(json.loads(zf.read("rng_state.json")))
        if "opt_state.npz" not in names or self._training_config is None:
            return
        data = np.load(io.BytesIO(zf.read("opt_state.npz")), allow_pickle=False)
        tx = self._training_config.updater.to_tx()
        ref = tx.init([self._values[n] for n in sorted(self._trainable)])
        try:
            # a changed trainable set (count or shapes) starts a fresh state
            self._opt_state = load_state_leaves(ref, [data[k] for k in data.files])
        except ValueError:
            self._opt_state = None

    def _save_source_backed(self, path: str, src: dict, n_imp: int) -> None:
        """Checkpoint an imported graph with control flow: the original
        bytes are the graph; the zip adds the fine-tuned values and the
        post-import plain ops (loss heads), replayed on load."""
        imported_names = getattr(self, "_import_value_names", set())
        extra_values = sorted(
            (set(self._values) - set(imported_names))
            | self._trainable | getattr(self, "_mutated_values", set()))
        manifest = {
            "kind": src["kind"],
            "trainable": bool(src.get("trainable", False)),
            "loop_trip_bound": src.get("loop_trip_bound"),
            "placeholders": sorted(self._placeholders),
            "trainable_names": sorted(self._trainable),
            "loss_var": self._loss_var,
            "counter": self._counter,
            "post_ops": [_node_json(n) for n in self._ops[n_imp:]],
            "training_config": serde.to_jsonable(self._training_config)
            if self._training_config else None,
        }
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
            zf.writestr("import_manifest.json", json.dumps(manifest, indent=2))
            zf.writestr("import_source.bin", bytes(src["raw"]))
            buf = io.BytesIO()
            np.savez(buf, **self._host_values(extra_values))
            zf.writestr("values.npz", buf.getvalue())
            self._save_opt_state(zf)

    @staticmethod
    def _load_source_backed(zf, device) -> "SameDiff":
        man = json.loads(zf.read("import_manifest.json"))
        raw = zf.read("import_source.bin")
        if man["kind"] == "tf":
            from deeplearning4j_tpu_torch.modelimport.tensorflow import import_graph

            sd = import_graph(raw, trainable=man["trainable"],
                              loop_trip_bound=man.get("loop_trip_bound"), device=device)
        elif man["kind"] == "onnx":
            raise NotImplementedError(
                "ONNX import is not ported yet; it waits in ROADMAP A13")
        else:
            raise ValueError(f"unknown import_source kind {man['kind']!r}")
        data = np.load(io.BytesIO(zf.read("values.npz")), allow_pickle=False)
        for name in man["placeholders"]:
            if name not in sd._placeholders:
                sd.placeholder(name)
        # post-import values (head weights ...) that re-import did not make
        for name in data.files:
            if name not in sd._values:
                if name in man["trainable_names"]:
                    sd.var(name, data[name])
                else:
                    sd.constant(name, data[name])
        for n in man["post_ops"]:
            node = _OpNode(n["op"], tuple(n["inputs"]), n["output"],
                           _unjsonify_attrs(n["attrs"]))
            sd._ops.append(node)
            if node.output not in sd._vars:
                sd._vars[node.output] = SDVariable(sd, node.output, "op")
        # fine-tuned values overwrite the re-imported ones; marked mutated
        # so a second save of this graph keeps them too
        for name in data.files:
            sd._values[name] = as_tensor(data[name], sd.device)
        sd._mutated_values = set(data.files)
        sd._loss_var = man.get("loss_var")
        sd._counter = max(man.get("counter", 0), sd._counter)
        if man.get("training_config"):
            sd.set_training_config(serde.from_jsonable(man["training_config"]))
        sd._load_opt_state(zf)
        return sd

    @staticmethod
    def load(path: str, device=None) -> "SameDiff":
        """A graph from a zip either package wrote, on ``device`` (None:
        CUDA)."""
        with zipfile.ZipFile(path, "r") as zf:
            if "import_manifest.json" in zf.namelist():
                return SameDiff._load_source_backed(zf, device)
            sd = SameDiff(device=device)
            graph = json.loads(zf.read("graph.json"))
            data = np.load(io.BytesIO(zf.read("values.npz")), allow_pickle=False)
            for name in graph["placeholders"]:
                sd.placeholder(name)
            for name in graph["trainable"]:
                sd.var(name, data[name])
            for name in graph["constants"]:
                sd.constant(name, data[name])
            for n in graph["ops"]:
                node = _OpNode(n["op"], tuple(n["inputs"]), n["output"],
                               _unjsonify_attrs(n["attrs"]))
                sd._ops.append(node)
                sd._vars[node.output] = SDVariable(sd, node.output, "op")
            sd._loss_var = graph.get("loss_var")
            sd._counter = graph.get("counter", len(sd._vars))
            if graph.get("training_config"):
                sd.set_training_config(serde.from_jsonable(graph["training_config"]))
            sd._load_opt_state(zf)
        return sd

    def __getitem__(self, name: str) -> SDVariable:
        return self._vars[name]


def _node_json(n: _OpNode) -> dict:
    return {"op": n.op, "inputs": list(n.inputs), "output": n.output,
            "attrs": _jsonify_attrs(n.attrs)}


def _jsonify_attrs(attrs: dict) -> dict:
    return {k: list(v) if isinstance(v, tuple) else v for k, v in attrs.items()}


def _unjsonify_attrs(attrs: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in attrs.items()}
