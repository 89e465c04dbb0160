"""Verified weight hot-swap — new params into a live server, or nothing;
the port's counterpart of `deeplearning4j_tpu/serving/hotswap.py`.

A torn transfer (half the leaves), a poisoned checkpoint (finite CRC but
NaN weights) or a shape drift must leave the server serving its old
params, with the rejection counted — never a crash, never a silently
wrong model.  The server stages the pushed tree, calls
`verify_weights(staged, live, checksum=...)`, and only a clean pass
reaches the atomic install.  Checks, in rejection-cost order:

1. **structure** — the staged tree's nesting and keys equal the live
   tree's (a torn push that dropped leaves, another architecture);
2. **shape/dtype** — leaf by leaf;
3. **checksum** — optional CRC32 over the leaves' host bytes, computed
   at the SOURCE (`weights_checksum`) and carried with the push;
4. **finiteness** — every floating leaf all-finite (integer leaves are
   skipped: NaN cannot live there).

Leaves are torch tensors (any device) or numpy arrays; a tree is nested
dicts.  Leaves are visited in the JAX package's ``jax.tree.flatten``
order — dict keys sorted at every level, a `QuantizedTensor` as its int8
``q`` then its f32 ``scale`` under a node of its own, as the JAX pytree
node flattens it — so a checksum computed by one package verifies in the
other (the leaves have the same bytes in both), a NaN scale fails the
finiteness check, and a quantized tree pushed onto an f32 model (or the
reverse) fails the structure check.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from deeplearning4j_tpu_torch.quant.qtensor import QuantizedTensor


class SwapVerifyError(RuntimeError):
    """The pushed weights failed verification; `reason` is one of
    structure / shape / checksum / nonfinite / fault."""

    def __init__(self, reason: str, detail: str):
        self.reason = reason
        super().__init__(f"hot-swap rejected ({reason}): {detail}")


def _flatten(tree) -> tuple[list, object]:
    """(leaves, structure): leaves in ``jax.tree.flatten`` order; the
    structure is a hashable description of the nesting."""
    if isinstance(tree, dict):
        leaves, defs = [], []
        for k in sorted(tree):
            sub, d = _flatten(tree[k])
            leaves += sub
            defs.append((k, d))
        return leaves, ("dict", tuple(defs))
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for v in tree:
            sub, d = _flatten(v)
            leaves += sub
            defs.append(d)
        return leaves, (type(tree).__name__, tuple(defs))
    if isinstance(tree, QuantizedTensor):
        return [tree.q, tree.scale], ("QuantizedTensor", ("*", "*"))
    return [tree], "*"


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _host_bytes(leaf) -> bytes:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().contiguous().numpy()
    return np.ascontiguousarray(np.asarray(leaf)).tobytes()


def _nonfinite(leaves) -> list[int]:
    """Indices of the floating leaves holding NaN/Inf.  Tensor leaves are
    reduced on their device and read back once a device, not once a
    leaf: a push must not wait on the card ~100 times."""
    bad, by_device = [], {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point():
                by_device.setdefault(leaf.device, []).append(i)
            continue
        a = np.asarray(leaf)
        if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all():
            bad.append(i)
    for idx in by_device.values():
        ok = torch.stack([torch.isfinite(leaves[i].detach()).all() for i in idx])
        bad += [i for i, good in zip(idx, ok.cpu().tolist()) if not good]
    return sorted(bad)


def weights_checksum(tree) -> int:
    """CRC32 over every leaf's raw bytes in flattened-tree order.
    Compute at the push SOURCE and pass to ``push_weights``."""
    crc = 0
    for leaf in _flatten(tree)[0]:
        crc = zlib.crc32(_host_bytes(leaf), crc)
    return crc


def verify_weights(staged, live, checksum: int | None = None) -> None:
    """Raise `SwapVerifyError` unless `staged` can safely replace
    `live` (see the module docstring for the check order)."""
    staged_leaves, staged_def = _flatten(staged)
    live_leaves, live_def = _flatten(live)
    if staged_def != live_def:
        raise SwapVerifyError(
            "structure",
            f"staged tree has {len(staged_leaves)} leaves, live model "
            f"expects {len(live_leaves)} (or other keys)")
    for i, (s, l) in enumerate(zip(staged_leaves, live_leaves)):
        s_shape, l_shape = tuple(s.shape), tuple(l.shape)
        if s_shape != l_shape or _dtype_name(s) != _dtype_name(l):
            raise SwapVerifyError(
                "shape",
                f"leaf {i}: staged {s_shape}/{_dtype_name(s)} vs live "
                f"{l_shape}/{_dtype_name(l)}")
    if checksum is not None:
        got = weights_checksum(staged)
        if got != checksum:
            raise SwapVerifyError(
                "checksum",
                f"CRC32 {got:#010x} != pushed {checksum:#010x} "
                "(torn or corrupted transfer)")
    bad = _nonfinite(staged_leaves)
    if bad:
        raise SwapVerifyError(
            "nonfinite", f"leaf {bad[0]} holds NaN/Inf (pushed mid-divergence?)")


def apply_fault_action(action: str, staged):
    """Cooperative fault-site mutations for ``serving.hotswap``:
    ``truncate`` simulates a torn transfer (the last leaf is dropped ->
    the structure check fails); ``corrupt`` NaN-poisons the first
    floating leaf of a copy in flatten order (the finiteness check
    fails; in a quantized tree that leaf is a scale).  Returns the
    mutated tree."""
    if action == "truncate":
        return _flatten(staged)[0][:-1]   # no longer the live structure
    if action == "corrupt":
        poisoned = [False]

        def leaf(t):
            if isinstance(t, torch.Tensor):
                t = t.detach().clone()
                if not poisoned[0] and t.is_floating_point() and t.numel():
                    t.view(-1)[0] = float("nan")
                    poisoned[0] = True
                return t
            a = np.array(np.asarray(t), copy=True)
            if not poisoned[0] and np.issubdtype(a.dtype, np.floating) and a.size:
                a.reshape(-1)[0] = np.nan
                poisoned[0] = True
            return a

        def walk(t):
            if isinstance(t, dict):
                return {k: walk(t[k]) for k in sorted(t)}
            if isinstance(t, QuantizedTensor):
                return QuantizedTensor(leaf(t.q), leaf(t.scale))
            return leaf(t)

        return walk(staged)
    return staged
