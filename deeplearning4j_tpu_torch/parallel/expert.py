"""Mixture-of-Experts FFN on one device — `deeplearning4j_tpu/parallel/expert.py`.

`moe_apply` routes each token to its ``top_k`` experts by router
probability, keeps at most ``capacity`` (token, choice) pairs an expert,
runs each expert's ReLU FFN over its slots, and sums the kept choices'
outputs weighted by their gate values; it returns the output and the
Switch-style load-balancing loss.

The JAX function dispatches and combines through one-hot tensors of
shape (N, E, C) and einsums over them.  Each (expert, slot) holds at most
one (token, choice), and each (token, choice) at most one slot, so every
other term of those einsums is an exact zero: this port gathers instead.
Row ``e * C + p`` of an (E * C + 1)-row buffer is expert e's slot p, and
a dropped choice points at the last row, which stays zero.  Shapes are
fixed by (N, E, C) and nothing reads a count back to the host, so a
training step over the layer stays one CUDA graph.  The sums equal the
einsums' for finite inputs (an inf or NaN input is multiplied by zero
there and not here).

The JAX function's order is kept:

- the router's subnormal probabilities are flushed to zero, as XLA
  flushes them on the CPU and the TPU: a saturated router's tail is
  exact zeros there, so its top-k choice among them (and the capacity
  counts after it) goes by index, not by which tiny value is largest;
- ties in the top-k go to the lower expert index (`jax.lax.top_k`), here
  by a stable descending sort;
- slots fill by a running count over the (token, choice) pairs taken
  token-major (a token's choices interleave with the next token's), so
  earlier tokens win, and a choice at position >= C is dropped;
- the router and the expert products run in f32 whatever the input
  dtype, and the output takes the input's dtype;
- the auxiliary loss counts each token's first choice only.

The dispatch's backward gathers each token's gradient from its slots and
sums its ``top_k`` rows in choice order, so the step's bits do not depend
on the order of atomic adds.

Under a mesh the layer computes the JAX function of the global batch:

- **the data axis** (a training step's `parallel/context.py` scope):
  the capacity comes from the global token count, and a (token, choice)'s
  slot position adds the earlier data ranks' per-expert counts (one
  all-gather of E counts a layer), so slots fill in global (b, t) order;
  the auxiliary loss's means are over the global batch.  The sequence
  reaches the layer gathered over the seq axis (`models/sequential.py`);
- **the expert axis**: ``Wi`` / ``Wo`` hold experts ``r E / x`` to
  ``(r + 1) E / x - 1``; every rank routes the same tokens, runs its
  experts' slots of the (E * C + 1)-row buffer, and the partial outputs
  are summed over the expert group (`collectives.reduce_from`), the
  tokens and gate weights entering by `collectives.copy_to` so the
  router and the input get the whole gradient on every rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from deeplearning4j_tpu_torch.runtime import rng
from deeplearning4j_tpu_torch.runtime.mesh import leaf_axis


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    d_model: int = 512
    d_hidden: int = 2048
    top_k: int = 2
    capacity_factor: float = 1.25


def capacity(cfg: MoEConfig, n_tok: int) -> int:
    """Slots an expert holds for ``n_tok`` tokens (the JAX formula)."""
    return max(1, int(cfg.capacity_factor * n_tok * cfg.top_k / cfg.n_experts))


def init_moe(key, cfg: MoEConfig, device=None) -> dict:
    """``router`` (D, E), ``Wi`` (E, D, H), ``Wo`` (E, H, D): standard
    normals from the three subkeys of ``key`` (`runtime/rng.py`, the bits
    of ``jax.random.normal``), scaled by sqrt(2 / fan-in) in f32."""
    k1, k2, k3 = rng.split(key, 3)
    s1 = float(np.float32((2.0 / cfg.d_model) ** 0.5))
    s2 = float(np.float32((2.0 / cfg.d_hidden) ** 0.5))
    e, d, h = cfg.n_experts, cfg.d_model, cfg.d_hidden
    return {
        "router": rng.normal(k1, (d, e), device) * s1,
        "Wi": rng.normal(k2, (e, d, h), device) * s1,
        "Wo": rng.normal(k3, (e, h, d), device) * s2,
    }


def router_probs(xf: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """softmax(xf @ router) in f32, (N, E), with subnormal values flushed
    to zero as XLA computes them."""
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    return probs.masked_fill(probs < torch.finfo(torch.float32).tiny, 0.0)


def _one_hot(idx: torch.Tensor, e: int) -> torch.Tensor:
    """(..., e) int64 one-hot rows of ``idx`` (compared on the device: no
    check reads a value back, so a CUDA graph can capture it)."""
    return (idx[..., None] == torch.arange(e, device=idx.device)).long()


def route(probs: torch.Tensor, cfg: MoEConfig, cap: int):
    """Top-k choices and their slots.  probs: (N, E) f32.  Returns
    (gate values (N, k), expert ids (N, k), slot of each choice (N * k,)
    in token-major order, the trash row E * cap for a dropped one, and
    the kept flags (N * k,))."""
    n, e, k = probs.shape[0], cfg.n_experts, cfg.top_k
    gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    gate_vals = probs.gather(1, gate_idx)
    choice = _one_hot(gate_idx.reshape(n * k), e)
    # the running count of each expert's choices, scanned along the
    # innermost dim of an (E, N * k) copy (a scan over the outer dim of
    # (N * k, E) runs one thread a column)
    counts = torch.cumsum(choice.t().contiguous(), dim=1).t()
    pos = (counts * choice).sum(-1) - 1                           # 0-based
    kept = pos < cap
    slot = torch.where(kept, gate_idx.reshape(n * k) * cap + pos,
                       torch.full_like(pos, e * cap))
    return gate_vals, gate_idx, slot, kept


class _Dispatch(torch.autograd.Function):
    """Token rows into expert slots: ``out[s] = x[src[s]]`` (``src[s] =
    N``: an empty slot, zeros).  The backward gathers: token n's gradient
    is the sum of its ``top_k`` slots' rows in choice order (``slot``,
    the trash row reading zeros)."""

    @staticmethod
    def forward(ctx, x, src, slot, k: int):
        ctx.save_for_backward(slot)
        ctx.k = k
        xpad = torch.cat([x, x.new_zeros((1, x.shape[1]))])
        return xpad.index_select(0, src)

    @staticmethod
    def backward(ctx, g):
        (slot,) = ctx.saved_tensors
        gpad = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        rows = gpad.index_select(0, slot).view(-1, ctx.k, g.shape[1])
        dx = rows[:, 0]
        for j in range(1, ctx.k):
            dx = dx + rows[:, j]
        return dx, None, None, None


def _data_ranks() -> int:
    """The data-axis ranks whose tokens one routing spans: those of a
    training step's scope, else 1 (inference routes what it is given)."""
    from deeplearning4j_tpu_torch.parallel import collectives, context

    return 1 if context.current() is None else collectives.axis_size("data")


def _earlier_counts(choice: torch.Tensor) -> torch.Tensor:
    """(E,) choices of each expert made by the data ranks before this
    one (their tokens come first in global order)."""
    from deeplearning4j_tpu_torch.parallel import collectives

    counts = choice.sum(0)
    every = collectives.gather(counts[None], 0, "data").detach()    # (n, E)
    r = collectives.axis_rank("data")
    return every[:r].sum(0)


def global_route(probs: torch.Tensor, cfg: MoEConfig):
    """`route` of this rank's tokens within the global batch of the data
    ranks (`_data_ranks`): the global capacity, and slot positions
    counted after the earlier ranks' choices.  Returns (capacity, gate
    values, expert ids, slots, kept)."""
    n, e, k = probs.shape[0], cfg.n_experts, cfg.top_k
    nd = _data_ranks()
    cap = capacity(cfg, n * nd)
    if nd == 1:
        return (cap, *route(probs, cfg, cap))
    gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :k]
    gate_vals = probs.gather(1, gate_idx)
    choice = _one_hot(gate_idx.reshape(n * k), e)
    counts = torch.cumsum(choice.t().contiguous(), dim=1).t() + _earlier_counts(choice)
    pos = (counts * choice).sum(-1) - 1
    kept = pos < cap
    slot = torch.where(kept, gate_idx.reshape(n * k) * cap + pos,
                       torch.full_like(pos, e * cap))
    return cap, gate_vals, gate_idx, slot, kept


def _global_mean(t: torch.Tensor, nd: int) -> torch.Tensor:
    """The mean over the rows of ``t`` and of every data rank's
    (differentiable: its backward sums the ranks' gradients)."""
    from deeplearning4j_tpu_torch.parallel import collectives

    if nd == 1:
        return t.mean(0)
    return collectives.all_reduce_sum(t.sum(0), "data") / (t.shape[0] * nd)


def moe_apply(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """x: (B, T, d_model) -> (y in x's dtype, f32 aux loss)."""
    from deeplearning4j_tpu_torch.parallel import collectives

    b, t, d = x.shape
    n, e, k = b * t, cfg.n_experts, cfg.top_k
    xf = x.reshape(n, d).float()
    probs = router_probs(xf, params["router"])                   # (N, E)
    cap, gate_vals, gate_idx, slot, kept = global_route(probs, cfg)
    w = kept.view(n, k).float() * gate_vals                      # (N, k)

    split = leaf_axis(params["Wi"]) == "expert"
    el = params["Wi"].shape[0]                 # this rank's experts
    if split:
        # the expert axis: this rank's experts' slots, the trash row for
        # every other choice; tokens and gates enter the split region
        lo = collectives.axis_rank("expert") * el * cap
        mine = (slot >= lo) & (slot < lo + el * cap)
        slot = torch.where(mine, slot - lo, torch.full_like(slot, el * cap))
        xf_in = collectives.copy_to(xf, "expert")
        w = collectives.copy_to(w, "expert")
    else:
        xf_in = xf
    # slot -> token (N: empty); a dropped choice lands on the trash row
    tok = torch.arange(n * k, device=x.device) // k
    src = torch.full((el * cap + 1,), n, dtype=torch.long, device=x.device)
    src = src.scatter(0, slot, tok)[: el * cap]
    expert_in = _Dispatch.apply(xf_in, src, slot, k).view(el, cap, d)
    h = torch.relu(torch.bmm(expert_in, params["Wi"].float()))
    expert_out = torch.bmm(h, params["Wo"].float()).reshape(el * cap, d)
    out_pad = torch.cat([expert_out, expert_out.new_zeros((1, d))])
    picked = out_pad.index_select(0, slot).view(n, k, d) * w[..., None]
    y = picked[:, 0]
    for j in range(1, k):
        y = y + picked[:, j]
    if split:
        y = collectives.reduce_from(y, "expert")

    # Switch-style load-balancing loss over the global batch
    nd = _data_ranks()
    frac_tokens = _global_mean(_one_hot(gate_idx[:, 0], e).float(), nd).detach()
    frac_probs = _global_mean(probs, nd)
    aux = e * torch.sum(frac_tokens * frac_probs)
    return y.reshape(b, t, d).to(x.dtype), aux


def dropped_share(params: dict, x: torch.Tensor, cfg: MoEConfig) -> float:
    """The share of (token, choice) pairs ``moe_apply`` would drop for
    want of capacity on input ``x`` (B, T, d_model), routed as the layer
    routes it (within a step's global batch under a data-parallel
    scope); a host read."""
    n = x.shape[0] * x.shape[1]
    with torch.no_grad():
        probs = router_probs(x.reshape(n, -1), params["router"])
        kept = global_route(probs, cfg)[4].float()
        dropped = _global_mean(1.0 - kept[:, None], _data_ranks())
    return float(dropped[0])
