"""Op / gradient validation — the port's counterpart of
`deeplearning4j_tpu/autodiff/validation.py` (the reference's
``OpValidation`` / ``TestCase`` and DL4J's ``GradientCheckUtil``).

`gradient_check` holds ``torch.autograd.grad`` of a scalar loss of a
parameter tree (dicts, lists, tuples of tensors; integer leaves pass
through) against central finite differences on a sampled subset of each
float array's entries.  `OpValidation.validate` runs a `TestCase`: the
graph's forward outputs against expectations, then the gradient check
of its loss with respect to its trainables.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.model import tree_unflatten
from deeplearning4j_tpu_torch.utils.pytree import tree_flatten_with_paths


@dataclasses.dataclass
class GradCheckResult:
    passed: bool
    max_rel_error: float
    failures: list[str]

    def __bool__(self) -> bool:
        return self.passed


def _as_tensor(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach()
    return torch.as_tensor(np.array(leaf))


def gradient_check(
    loss_fn: Callable[[Any], Any],
    params: Any,
    eps: float = 1e-3,
    rtol: float = 5e-2,
    atol: float = 1e-4,
    max_checks_per_array: int = 16,
    seed: int = 0,
) -> GradCheckResult:
    """Central finite differences against autograd on a scalar loss of a
    parameter tree; ``max_checks_per_array`` entries of each float leaf,
    picked by a numpy generator seeded with ``seed``."""
    flat = tree_flatten_with_paths(params)
    paths = [p for p, _ in flat]
    leaves = [_as_tensor(leaf) for _, leaf in flat]
    float_idx = [i for i, t in enumerate(leaves) if t.is_floating_point()]

    def loss_of_floats(float_leaves):
        rebuilt = list(leaves)
        for i, fl in zip(float_idx, float_leaves):
            rebuilt[i] = fl
        return loss_fn(tree_unflatten(params, rebuilt))

    with torch.enable_grad():
        probes = [leaves[i].clone().requires_grad_(True) for i in float_idx]
        analytic = torch.autograd.grad(loss_of_floats(probes), probes, allow_unused=True)
    rng = np.random.default_rng(seed)
    failures: list[str] = []
    max_rel = 0.0
    with torch.no_grad():
        for pos, leaf_i in enumerate(float_idx):
            arr = leaves[leaf_i].cpu().numpy()
            g = (np.zeros_like(arr) if analytic[pos] is None
                 else analytic[pos].float().cpu().numpy())
            n = arr.size
            k = min(max_checks_per_array, n)
            for fi in rng.choice(n, size=k, replace=False):
                idx = np.unravel_index(fi, arr.shape)
                current = [leaves[i] for i in float_idx]

                def probe(delta):
                    moved = np.array(arr)
                    moved[idx] += delta
                    current[pos] = torch.from_numpy(moved.astype(arr.dtype)).to(
                        leaves[leaf_i].device)
                    return float(loss_of_floats(current))

                numeric = (probe(eps) - probe(-eps)) / (2 * eps)
                a = float(g[idx])
                denom = max(abs(numeric), abs(a), 1e-8)
                rel = abs(numeric - a) / denom
                if abs(numeric - a) > atol and rel > rtol:
                    failures.append(
                        f"{paths[leaf_i]}{list(idx)}: analytic {a:.6g} vs numeric "
                        f"{numeric:.6g} (rel {rel:.3g})")
                max_rel = max(max_rel, rel if abs(numeric - a) > atol else 0.0)
    return GradCheckResult(passed=not failures, max_rel_error=max_rel, failures=failures)


@dataclasses.dataclass
class TestCase:
    """One op / graph validation case (``org.nd4j.autodiff.validation.
    TestCase`` role): forward expectations and a gradient check on a
    SameDiff graph."""

    __test__ = False  # not a pytest class despite the name

    sd: Any
    placeholders: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    expected: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    gradient_check: bool = True
    wrt: Optional[list[str]] = None
    eps: float = 1e-3
    rtol: float = 5e-2
    atol: float = 1e-4
    forward_rtol: float = 1e-4
    forward_atol: float = 1e-5
    max_checks_per_array: int = 8


class OpValidation:
    """Validates TestCases; collects per-op coverage like the reference's
    unvalidated-op report."""

    _validated_ops: set[str] = set()

    @staticmethod
    def validate(tc: TestCase) -> list[str]:
        """A list of failure strings; empty means the case passed."""
        errors: list[str] = []
        sd = tc.sd
        if tc.expected:
            outs = sd.output(tc.placeholders, *tc.expected.keys())
            if not isinstance(outs, tuple):
                outs = (outs,)
            for (name, exp), got in zip(tc.expected.items(), outs):
                got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
                    else np.asarray(got)
                exp = np.asarray(exp)
                if got.shape != exp.shape:
                    errors.append(f"{name}: shape {got.shape} != expected {exp.shape}")
                elif not np.allclose(got, exp, rtol=tc.forward_rtol, atol=tc.forward_atol):
                    err = float(np.max(np.abs(got - exp)))
                    errors.append(f"{name}: forward mismatch, max abs err {err:.3g}")
        if tc.gradient_check:
            if sd._loss_var is None:
                errors.append("gradient_check requested but no loss set")
            else:
                wrt = tc.wrt or sorted(sd._trainable)
                base = {name: sd._values[name].detach() for name in wrt}
                ph = sd._feed(tc.placeholders)

                def loss_of(vars_dict):
                    values = dict(sd._values)
                    values.update(vars_dict)
                    values.update(ph)
                    (out,) = sd._execute(values, (sd._loss_var,))
                    return out

                res = gradient_check(
                    loss_of, base, eps=tc.eps, rtol=tc.rtol, atol=tc.atol,
                    max_checks_per_array=tc.max_checks_per_array)
                errors.extend(f"grad {f}" for f in res.failures)
        if not errors:
            for node in sd._ops:
                OpValidation._validated_ops.add(node.op)
        return errors

    @staticmethod
    def coverage_report() -> str:
        from deeplearning4j_tpu_torch.autodiff.ops_registry import OPS

        validated = OpValidation._validated_ops & set(OPS)
        unvalidated = sorted(set(OPS) - validated)
        return (f"op validation coverage: {len(validated)}/{len(OPS)}\n"
                f"unvalidated: {', '.join(unvalidated)}")
