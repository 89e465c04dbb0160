"""Recurrent layers — `deeplearning4j_tpu/nn/conf/recurrent.py`: the
cells (`LSTM`, `GravesLSTM`, `GRU`, `SimpleRnn`), their wrappers
(`Bidirectional`, `LastTimeStep`, `TimeDistributed`), `ConvLSTM2D` and
the per-timestep head `RnnOutputLayer`.

The JAX package scans each cell over time with ``lax.scan``, the input
projection ``x @ Wx + b`` of the whole sequence hoisted out of the scan
as one product; only ``h @ Wh`` stays in the loop.  Here the loop is a
Python loop of torch ops over the time-major steps, the same hoisted
projection before it: autograd records it, and on the card the model
captures the whole loop, forward and backward, into its step's CUDA
graph, so a replay launches no Python.  The JAX package has no kernel of
its own here (XLA compiles the scan), and the products stay plain
``torch.matmul``: cuDNN's fused RNN has no peepholes and no carry
pass-through on masked steps, and keeps another weight layout.

Masking (variable-length batches): a masked step passes the carry
through unchanged and outputs zeros (``h_new * m``).  With no mask the
blend is skipped entirely, as the JAX package skips it.

Stacks: `fused_rnn_scan` steps a run of recurrent layers in one time
loop, each layer after the first with one ``[h_below; h] @ [Wx; Wh]``
product where its projections add (LSTM, GravesLSTM, SimpleRnn).  That
sums in another order than two products, so the model fuses exactly
the runs the JAX package fuses (`SequentialModel._find_rnn_runs`).

Layout: (B, T, F) batch-major in the API, time-major inside the loop.
Weights are drawn from the layer's ``SeedStream`` key with the JAX
package's splits, so a seed gives its weights bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.activations import Activation
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import LayerConfig, _dense, _dense_init, _dropout
from deeplearning4j_tpu_torch.nn.losses import Loss
from deeplearning4j_tpu_torch.nn.weights import WeightInit
from deeplearning4j_tpu_torch.ops import conv as conv_ops
from deeplearning4j_tpu_torch.runtime import rng as rng_mod
from deeplearning4j_tpu_torch.utils import serde

#: output activation a loss implies when the layer declares none
CANONICAL_ACTIVATION = {
    Loss.MCXENT: Activation.SOFTMAX,
    Loss.NEGATIVELOGLIKELIHOOD: Activation.SOFTMAX,
    Loss.SPARSE_MCXENT: Activation.SOFTMAX,
    Loss.XENT: Activation.SIGMOID,
}


def _gate_bias(n: int, n_gates: int, forget: float, device) -> torch.Tensor:
    """Zeros of (n_gates * n,) with the forget gate's slice [n, 2n) set."""
    b = torch.zeros(n_gates * n, device=device)
    b[n:2 * n] = forget
    return b


class RecurrentLayerConfig(LayerConfig):
    """Base of the layers with a time carry.  Subclasses give
    ``init_carry``, the hoisted input projection and ``cell_step`` (one
    step of the recurrence); `apply_with_carry` runs the cell over time
    from a given carry and returns the final one, and `apply` starts from
    zeros and drops it.  ``fused_cell_step`` is one step fed by the lower
    layer's raw output, for `fused_rnn_scan`."""

    EXPECTS = "rnn"
    REGULARIZED = ("Wx", "Wh")
    ACCEPTS_MASK = True
    # tensors in the carry: (h,), or (h, c) for the LSTMs
    CARRY = 1

    def output_type(self, itype: InputType) -> InputType:
        return InputType.recurrent(self.n_out, itype.shape[0])

    def init_carry(self, batch: int, dtype, device=None) -> tuple:
        raise NotImplementedError

    def _cast(self, params: dict, dtype) -> dict:
        return {k: v.to(dtype) for k, v in params.items()}

    def input_projection(self, cp: dict, x: torch.Tensor) -> torch.Tensor:
        """The whole sequence's input product: (B, T, F) -> (B, T, G)."""
        return x @ cp["Wx"] + cp["b"]

    def project_step(self, cp: dict, h: torch.Tensor) -> torch.Tensor:
        """One step's input product (fused stacks): (B, F) -> (B, G)."""
        return h @ cp["Wx"] + cp["b"]

    def cell_step(self, cp: dict, carry: tuple, zin: torch.Tensor, mt):
        """One step from the projected input ``zin`` (B, G) and the (B, 1)
        mask ``mt`` (None: unmasked).  Returns (new carry, output (B, H))."""
        raise NotImplementedError

    def fused_cell_step(self, cp: dict, carry: tuple, h_below: torch.Tensor, mt):
        """One step fed by the lower layer's output: project, then step
        (two products); the additive cells override it with one."""
        return self.cell_step(cp, carry, self.project_step(cp, h_below), mt)

    def apply_with_carry(self, params: dict, x: torch.Tensor, carry: tuple, *,
                         mask=None, training: bool = False, rng=None):
        """(outputs (B, T, H), final carry) from ``carry``."""
        x = _dropout(x, self.dropout_rate or 0.0, training, rng)
        cp = self._cast(params, x.dtype)
        xproj = self.input_projection(cp, x)
        return _scan_time_major(lambda c, xt, mt: self.cell_step(cp, c, xt, mt),
                                carry, xproj, mask)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        carry = self.init_carry(x.shape[0], x.dtype, x.device)
        y, _ = self.apply_with_carry(params, x, carry, mask=mask,
                                     training=training, rng=rng)
        return y, state


def fused_rnn_scan(layers, params_list, x, carries, mask, *, training=False,
                   rng=None):
    """A stack of recurrent layers stepped in ONE time loop.  Only the
    first layer's dropout applies (to the whole sequence, before its
    hoisted projection), drawn from ``rng``; the model never fuses across
    a later layer with dropout.  Layer k > 0 projects its input step by
    step, in one ``[h_below; h] @ [Wx; Wh]`` product where it can.
    Returns (the last layer's outputs, [final carry of each layer])."""
    x = _dropout(x, layers[0].dropout_rate or 0.0, training, rng)
    cps = [l._cast(p, x.dtype) for l, p in zip(layers, params_list)]
    xproj = layers[0].input_projection(cps[0], x)
    for cp in cps[1:]:
        if "Wx" in cp and "Wh" in cp:
            cp["WxWh"] = torch.cat([cp["Wx"], cp["Wh"]], dim=0)

    def cell(cs, xt, mt):
        new_cs, h = [], None
        for k, (layer, cp) in enumerate(zip(layers, cps)):
            if k == 0:
                ck, h = layer.cell_step(cp, cs[k], xt, mt)
            else:
                ck, h = layer.fused_cell_step(cp, cs[k], h, mt)
            new_cs.append(ck)
        return tuple(new_cs), h

    ys, finals = _scan_time_major(cell, tuple(carries), xproj, mask)
    return ys, list(finals)


def _scan_time_major(cell, carry, x: torch.Tensor, mask):
    """``cell(carry, x_t, m_t)`` over the time axis of x (B, T, ...).
    Returns (outputs (B, T, H), final carry).  ``mask`` None reaches the
    cell as None, which skips the masked blend.  The steps are `unbind`
    views, whose backward stacks the steps' gradients once (indexing
    step by step would add T full-size gradients)."""
    xs = x.unbind(dim=1)
    ms = ((None,) * len(xs) if mask is None
          else mask.to(x.dtype)[..., None].unbind(dim=1))      # (B, 1) each
    ys = []
    for xt, mt in zip(xs, ms):
        carry, y = cell(carry, xt, mt)
        ys.append(y)
    return torch.stack(ys, dim=1), carry


def _blend(mt, new, old):
    return mt * new + (1 - mt) * old


@serde.register
@dataclasses.dataclass(frozen=True)
class LSTM(RecurrentLayerConfig):
    """Standard LSTM: gate order [i, f, g, o] in the fused weights; the
    forget gate's bias starts at ``forget_gate_bias`` (1.0)."""

    n_out: int = 0
    forget_gate_bias: float = 1.0
    gate_activation: Activation = Activation.SIGMOID

    CARRY = 2

    def init(self, key, itype, device):
        n_in, n_out = itype.size, self.n_out
        k1, k2 = rng_mod.split(key, 2)
        wi = self._winit(WeightInit.XAVIER)
        return {
            "Wx": wi.init(k1, (n_in, 4 * n_out), fan_in=n_in, fan_out=n_out,
                          device=device),
            "Wh": wi.init(k2, (n_out, 4 * n_out), fan_in=n_out, fan_out=n_out,
                          device=device),
            "b": _gate_bias(n_out, 4, self.forget_gate_bias, device),
        }, {}

    def init_carry(self, batch, dtype, device=None):
        z = torch.zeros((batch, self.n_out), dtype=dtype, device=device)
        return (z, z.clone())

    def _gates(self, cp, z, carry, mt):
        h, c = carry
        act, gate = self._act(Activation.TANH), self.gate_activation
        # split, not four slices: its backward is one concatenation
        zi, zf, zg, zo = z.split(self.n_out, dim=-1)
        i, f, g, o = gate(zi), gate(zf), act(zg), gate(zo)
        c_new = f * c + i * g
        h_new = o * act(c_new)
        if mt is None:
            return (h_new, c_new), h_new
        c_new = _blend(mt, c_new, c)
        h_new = _blend(mt, h_new, h)
        return (h_new, c_new), h_new * mt

    def cell_step(self, cp, carry, zin, mt):
        return self._gates(cp, zin + carry[0] @ cp["Wh"], carry, mt)

    def fused_cell_step(self, cp, carry, h_below, mt):
        z = torch.cat([h_below, carry[0]], dim=-1) @ cp["WxWh"] + cp["b"]
        return self._gates(cp, z, carry, mt)


@serde.register
@dataclasses.dataclass(frozen=True)
class GravesLSTM(LSTM):
    """LSTM with diagonal peepholes (Graves 2013; BASELINE config 3):
    c(t-1) feeds the i and f gates, c(t) the o gate."""

    def init(self, key, itype, device):
        params, state = super().init(key, itype, device)
        for k in ("pI", "pF", "pO"):
            params[k] = torch.zeros(self.n_out, device=device)
        return params, state

    def _gates(self, cp, z, carry, mt):
        h, c = carry
        act, gate = self._act(Activation.TANH), self.gate_activation
        zi, zf, zg, zo = z.split(self.n_out, dim=-1)
        i = gate(zi + cp["pI"] * c)
        f = gate(zf + cp["pF"] * c)
        g = act(zg)
        c_new = f * c + i * g
        o = gate(zo + cp["pO"] * c_new)
        h_new = o * act(c_new)
        if mt is None:
            return (h_new, c_new), h_new
        c_new = _blend(mt, c_new, c)
        h_new = _blend(mt, h_new, h)
        return (h_new, c_new), h_new * mt


@serde.register
@dataclasses.dataclass(frozen=True)
class GRU(RecurrentLayerConfig):
    """GRU, gate order [r, z, n].  The gates are sigmoids whatever the
    configuration says, and an optional recurrent bias ``bh`` (Keras'
    ``reset_after``) applies inside the reset gating of the candidate."""

    n_out: int = 0

    def init(self, key, itype, device):
        n_in, n_out = itype.size, self.n_out
        k1, k2 = rng_mod.split(key, 2)
        wi = self._winit(WeightInit.XAVIER)
        return {
            "Wx": wi.init(k1, (n_in, 3 * n_out), fan_in=n_in, fan_out=n_out,
                          device=device),
            "Wh": wi.init(k2, (n_out, 3 * n_out), fan_in=n_out, fan_out=n_out,
                          device=device),
            "b": torch.zeros(3 * n_out, device=device),
        }, {}

    def init_carry(self, batch, dtype, device=None):
        return (torch.zeros((batch, self.n_out), dtype=dtype, device=device),)

    def cell_step(self, cp, carry, zin, mt):
        (h,) = carry
        act = self._act(Activation.TANH)
        hz = h @ cp["Wh"]
        if "bh" in cp:
            hz = hz + cp["bh"]
        xr, xz, xn = zin.split(self.n_out, dim=-1)
        hr, hz_, hn = hz.split(self.n_out, dim=-1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz_)
        cand = act(xn + r * hn)
        h_new = (1 - z) * cand + z * h
        if mt is None:
            return (h_new,), h_new
        h_new = _blend(mt, h_new, h)
        return (h_new,), h_new * mt


@serde.register
@dataclasses.dataclass(frozen=True)
class SimpleRnn(RecurrentLayerConfig):
    """Elman RNN: h = act(x Wx + b + h Wh)."""

    n_out: int = 0

    def init(self, key, itype, device):
        n_in, n_out = itype.size, self.n_out
        k1, k2 = rng_mod.split(key, 2)
        wi = self._winit(WeightInit.XAVIER)
        return {
            "Wx": wi.init(k1, (n_in, n_out), fan_in=n_in, fan_out=n_out, device=device),
            "Wh": wi.init(k2, (n_out, n_out), fan_in=n_out, fan_out=n_out,
                          device=device),
            "b": torch.zeros(n_out, device=device),
        }, {}

    def init_carry(self, batch, dtype, device=None):
        return (torch.zeros((batch, self.n_out), dtype=dtype, device=device),)

    def _out(self, h, h_new, mt):
        if mt is None:
            return (h_new,), h_new
        h_new = _blend(mt, h_new, h)
        return (h_new,), h_new * mt

    def cell_step(self, cp, carry, zin, mt):
        (h,) = carry
        return self._out(h, self._act(Activation.TANH)(zin + h @ cp["Wh"]), mt)

    def fused_cell_step(self, cp, carry, h_below, mt):
        (h,) = carry
        z = torch.cat([h_below, h], dim=-1) @ cp["WxWh"] + cp["b"]
        return self._out(h, self._act(Activation.TANH)(z), mt)


def _last_unmasked(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """x (B, T, H) at each example's LAST nonzero mask entry (the first
    maximum of the flipped mask; a count would be wrong for a mask that
    is not contiguous)."""
    t = x.shape[1]
    idx = t - 1 - torch.argmax(torch.flip(mask, dims=(1,)), dim=1)
    idx = idx.clamp(0, t - 1).to(torch.int64)
    return torch.take_along_dim(x, idx[:, None, None], dim=1)[:, 0, :]


@serde.register
@dataclasses.dataclass(frozen=True)
class Bidirectional(LayerConfig):
    """Runs the wrapped recurrent layer forward and on the time-reversed
    sequence and combines the two (``mode`` concat, add, mul or ave).
    ``return_sequences=False`` combines each half's final step: the
    forward half's last unmasked step and the backward half's own last
    step, which is original index 0 (so it is not `LastTimeStep`).  Both
    halves draw their dropout from the same key."""

    layer: Optional[RecurrentLayerConfig] = None
    mode: str = "concat"
    return_sequences: bool = True

    EXPECTS = "rnn"
    ACCEPTS_MASK = True
    REGULARIZED = ()

    def output_type(self, itype):
        inner = self.layer.output_type(itype)
        size = inner.size * 2 if self.mode == "concat" else inner.size
        if not self.return_sequences:
            return InputType.feed_forward(size)
        return InputType.recurrent(size, itype.shape[0])

    def init(self, key, itype, device):
        k1, k2 = rng_mod.split(key, 2)
        fwd, _ = self.layer.init(k1, itype, device)
        bwd, _ = self.layer.init(k2, itype, device)
        return {"fwd": fwd, "bwd": bwd}, {}

    def regularizable_params(self, lp):
        out = []
        for half in ("fwd", "bwd"):
            if half in lp:
                out.extend(self.layer.regularizable_params(lp[half]))
        return out

    def regularization_terms(self, lp):
        # the wrapper's own coefficients win when set (builder defaults
        # land on it); else the inner layer's
        l1 = self.l1 if self.l1 is not None else (self.layer.l1 or 0.0)
        l2 = self.l2 if self.l2 is not None else (self.layer.l2 or 0.0)
        if not l1 and not l2:
            return []
        return [(l1, l2, w) for w in self.regularizable_params(lp)]

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        carry = self.layer.init_carry(x.shape[0], x.dtype, x.device)
        yf, _ = self.layer.apply_with_carry(params["fwd"], x, carry, mask=mask,
                                            training=training, rng=rng)
        xr = torch.flip(x, dims=(1,))
        mr = None if mask is None else torch.flip(mask, dims=(1,))
        yb, _ = self.layer.apply_with_carry(params["bwd"], xr, carry, mask=mr,
                                            training=training, rng=rng)
        yb = torch.flip(yb, dims=(1,))
        if not self.return_sequences:
            yf = yf[:, -1, :] if mask is None else _last_unmasked(yf, mask)
            yb = yb[:, 0, :]
        if self.mode == "concat":
            return torch.cat([yf, yb], dim=-1), state
        if self.mode == "add":
            return yf + yb, state
        if self.mode == "mul":
            return yf * yb, state
        if self.mode == "ave":
            return (yf + yb) / 2, state
        raise ValueError(f"unknown Bidirectional mode {self.mode}")


@serde.register
@dataclasses.dataclass(frozen=True)
class LastTimeStep(LayerConfig):
    """(B, T, H) -> (B, H) at each example's last unmasked step."""

    EXPECTS = "rnn"
    HAS_PARAMS = False
    REGULARIZED = ()
    ACCEPTS_MASK = True

    def output_type(self, itype):
        return InputType.feed_forward(itype.size)

    def apply(self, params, state, x, *, training=False, rng=None, mask=None):
        if mask is None:
            return x[:, -1, :], state
        return _last_unmasked(x, mask), state


@serde.register
@dataclasses.dataclass(frozen=True)
class RnnOutputLayer(LayerConfig):
    """(B, T, H) -> (B, T, n_out) logits; ``output()`` applies the
    activation the loss implies (softmax for ``mcxent``), and the loss
    masks padded steps through the labels mask."""

    SEQ_LOCAL = True

    n_out: int = 0
    loss: Loss = Loss.MCXENT
    has_bias: bool = True

    EXPECTS = "rnn"

    def output_type(self, itype):
        return InputType.recurrent(self.n_out, itype.shape[0])

    def init(self, key, itype, device):
        return _dense_init(self, key, itype.size, device), {}

    def apply(self, params, state, x, *, training=False, rng=None):
        x = _dropout(x, self.dropout_rate or 0.0, training, rng)
        return self.logits(params, x), state

    def logits(self, params, x):
        return _dense(self, params, x)


@serde.register
@dataclasses.dataclass(frozen=True)
class TimeDistributed(LayerConfig):
    """A feed-forward layer applied at every step of (B, T, F), its
    parameters shared across steps (one inner init).  A feed-forward
    layer is pointwise over the leading axes, so the sequence passes
    straight through it."""

    layer: Optional[LayerConfig] = None

    EXPECTS = "rnn"

    def __post_init__(self):
        super().__post_init__()
        if self.layer is not None and self.layer.EXPECTS not in ("ff", "any"):
            raise ValueError(
                "TimeDistributed wraps feed-forward layers; got a layer "
                f"expecting {self.layer.EXPECTS!r}")

    def output_type(self, itype):
        inner = self.layer.output_type(InputType.feed_forward(itype.size))
        return InputType.recurrent(inner.size, itype.shape[0])

    def init(self, key, itype, device):
        return self.layer.init(key, InputType.feed_forward(itype.size), device)

    def regularizable_params(self, lp):
        return self.layer.regularizable_params(lp)

    def regularization_terms(self, lp):
        return self.layer.regularization_terms(lp)

    def apply(self, params, state, x, *, training=False, rng=None):
        return self.layer.apply(params, state, x, training=training, rng=rng)


@serde.register
@dataclasses.dataclass(frozen=True)
class ConvLSTM2D(LayerConfig):
    """Convolutional LSTM over image sequences (Keras ConvLSTM2D): input
    (B, T, H, W, C), gates ``conv(x_t, Wx) + conv(h, Wh) + b`` in the
    order [i, f, g, o] with sigmoid gates and tanh.  The input
    convolution honours ``padding`` and ``stride``; the recurrent one is
    always SAME at stride 1, so the state keeps the output's size.  The
    convolutions are `ops/conv.py`'s (cuDNN on the card, in exact f32)."""

    n_out: int = 0
    kernel: tuple[int, int] = (3, 3)
    stride: tuple[int, int] = (1, 1)
    padding: str = "valid"
    return_sequences: bool = False
    forget_gate_bias: float = 1.0

    EXPECTS = "cnn3d"

    def _out_hw(self, h: int, w: int) -> tuple[int, int]:
        kh, kw = self.kernel
        sh, sw = self.stride
        if self.padding == "same":
            return -(-h // sh), -(-w // sw)
        return (h - kh) // sh + 1, (w - kw) // sw + 1

    def output_type(self, itype):
        t, h, w, _ = itype.shape
        oh, ow = self._out_hw(h, w)
        if self.return_sequences:
            return InputType.convolutional3d(t, oh, ow, self.n_out)
        return InputType.convolutional(oh, ow, self.n_out)

    def init(self, key, itype, device):
        c_in = itype.shape[-1]
        kh, kw = self.kernel
        k1, k2 = rng_mod.split(key, 2)
        wi = self._winit(WeightInit.XAVIER)
        f = self.n_out
        return {
            "Wx": wi.init(k1, (kh, kw, c_in, 4 * f), fan_in=kh * kw * c_in,
                          fan_out=kh * kw * f, device=device),
            "Wh": wi.init(k2, (kh, kw, f, 4 * f), fan_in=kh * kw * f,
                          fan_out=kh * kw * f, device=device),
            "b": _gate_bias(f, 4, self.forget_gate_bias, device),
        }, {}

    def apply(self, params, state, x, *, training=False, rng=None):
        x = _dropout(x, self.dropout_rate or 0.0, training, rng)
        f = self.n_out
        wx, wh, b = (params[k].to(x.dtype) for k in ("Wx", "Wh", "b"))
        pad = "same" if self.padding == "same" else "valid"
        B, _, H, W, _ = x.shape
        oh, ow = self._out_hw(H, W)
        h = torch.zeros((B, oh, ow, f), dtype=x.dtype, device=x.device)
        c, ys = h, []
        for xt in x.unbind(dim=1):
            z = (conv_ops.conv2d_nhwc(xt, wx, stride=self.stride, padding=pad)
                 + conv_ops.conv2d_nhwc(h, wh, stride=(1, 1), padding="same") + b)
            zi, zf, zg, zo = z.split(f, dim=-1)
            i, fg, g, o = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg), torch.sigmoid(zo)
            c = fg * c + i * g
            h = o * torch.tanh(c)
            ys.append(h)
        if self.return_sequences:
            return torch.stack(ys, dim=1), state
        return h, state
