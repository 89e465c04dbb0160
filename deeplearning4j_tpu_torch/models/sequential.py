"""A minimal `SequentialModel` — the inference side of
`deeplearning4j_tpu/models/sequential.py` for the transformer stack.

The model is an `nn.Module` on one explicit device.  Its parameters keep
the JAX package's tree: ``model.params["layer2"]["attn"]["Wq"]`` is the
same (n_in, n_out) array there and here, so weights carry across by
layer name (`convert.params_from_jax`).  They are stored in f32; the
compute dtype (bf16 on CUDA, f32 on the CPU, or ``conf.bf16_compute``)
applies to a cast copy made once and cached (`compute_params`), instead
of a cast of every weight at every step.  ``fit()`` arrives with the
training slice.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.runtime.backend import backend, resolve_device


class ParamTree(nn.Module):
    """A nested parameter dict as a module: tensors become (frozen)
    parameters, dicts become child modules."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            else:
                self.register_parameter(
                    key, nn.Parameter(val, requires_grad=False))

    def tree(self) -> dict:
        out = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


def as_tensor(x, device) -> torch.Tensor:
    """A tensor on ``device``; array-likes are copied first, so read-only
    numpy arrays (a JAX array's ``np.asarray`` view) are fine."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


class SequentialModel(nn.Module):
    """Sequential layer stack on one device (``"cuda"`` by default)."""

    def __init__(self, conf, device=None):
        super().__init__()
        self.conf = conf
        self.device = resolve_device(device)
        self._bf16 = (conf.bf16_compute if conf.bf16_compute is not None
                      else backend(self.device).is_cuda)
        self.layers = nn.ModuleDict()
        self._compute = None

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self._bf16 else torch.float32

    @property
    def params(self):
        """The f32 parameter tree (None before `init`)."""
        if not self.layers:
            return None
        return {name: m.tree() for name, m in self.layers.items()}

    @torch.no_grad()
    def init(self) -> "SequentialModel":
        """Random weights from ``conf.seed`` (a `torch.Generator` on the
        model's device)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.conf.seed)
        tree = {}
        sizes = self.conf.layer_input_sizes()
        for layer, n_in in zip(self.conf.layers, sizes):
            p = layer.init(gen, n_in, self.device)
            if p:
                tree[layer.name] = p
        self._install(tree)
        return self

    @torch.no_grad()
    def load_params(self, tree: dict) -> "SequentialModel":
        """Install a parameter tree of array-likes, checked name for name
        and shape for shape against what `init` would create."""
        if self.params is None:
            self.init()
        want = self.params

        def walk(w, got, path):
            if set(w) != set(got):
                raise ValueError(
                    f"parameter names differ at {path or '<root>'}: "
                    f"want {sorted(w)}, got {sorted(got)}")
            out = {}
            for k, v in w.items():
                p = f"{path}/{k}" if path else k
                if isinstance(v, dict):
                    out[k] = walk(v, got[k], p)
                    continue
                t = got[k]
                t = (t.detach().float() if isinstance(t, torch.Tensor)
                     else torch.from_numpy(np.array(t, dtype=np.float32)))
                if tuple(t.shape) != tuple(v.shape):
                    raise ValueError(f"{p}: shape {tuple(t.shape)} != "
                                     f"{tuple(v.shape)}")
                out[k] = t.to(self.device).contiguous()
            return out

        self._install(walk(want, tree, ""))
        return self

    def _install(self, tree: dict) -> None:
        self.layers = nn.ModuleDict(
            {name: ParamTree(p) for name, p in tree.items()})
        self._compute = None

    def compute_params(self) -> dict:
        """The parameter tree in the compute dtype (cached; rebuilt after
        `init` / `load_params`)."""
        if self._compute is None:
            dt = self.compute_dtype
            self._compute = _tree_map(lambda t: t.detach().to(dt), self.params)
        return self._compute

    @torch.no_grad()
    def output(self, features) -> torch.Tensor:
        """Forward pass with the output activation applied, in f32
        (reference `MultiLayerNetwork.output()`): class probabilities for
        an `RnnOutputLayer` head, hidden states for a
        `ChunkedSoftmaxOutputLayer` head (its projection lives in the
        loss)."""
        if self.params is None:
            self.init()
        params = self.compute_params()
        x = as_tensor(features, self.device)
        if x.is_floating_point():
            x = x.to(self.compute_dtype)
        for layer in self.conf.layers:
            x = layer.apply(params.get(layer.name, {}), x)
        return self.conf.layers[-1].output_activation()(x.float())
