"""The autosharding planner — `deeplearning4j_tpu/parallel/planner.py`:
`plan()` and ``distribute(model, auto=True)``.

1. **enumerate** candidate `ParallelConfig`s over the divisors of the
   world's width (data x pipe x seq x expert, zero in {0, 1, 2}),
   underfilled ones included, every illegal one recorded with its
   reason, never raised;
2. **price** each survivor without a device run: the model's step
   program is counted once from an abstract signature
   (`observe/cost.py` `analyze_signature`: fake tensors, no launch, no
   ``nvcc``) for its FLOPs and bytes, against the peak table
   (`observe/cost.py` `peaks`), plus the closed-form terms: the data
   axis's gradient exchange, the pipeline bubble, a per-partition hop
   and the update epilogue;
3. **gate** each candidate on its memory a rank (parameters, gradients,
   optimizer state, an activation estimate) against a cap;
4. `distribute(auto=True)` installs the cheapest.

The JAX package's constraint of jax 0.4.x (no data axis around a manual
pipeline ``shard_map`` body) has no counterpart here.  The port's own
rule: a pipe axis beside the seq axis is rejected with its reason (the
JAX package prices it, but its step fails, ROADMAP C29).

The capacity model is the JAX package's: on the CPU the aggregate peak
stays that of one device whatever the width (the ranks share the host's
cores); on the card each rank adds its device's peaks.  The per-hop
seconds are ``DEFAULT_HOP_SECONDS``: the CPU value is the JAX
package's, the ``cuda`` one is measured (`chip_smoke.py`'s ``mp``
phase: a pipelined step's time over its priced terms, per extra rank,
on NCCL cards); ``DL4J_TPU_PLAN_HOP_S`` overrides both.

    report = plan(model, batch=example_batch)
    print(report.summary())
    distribute(model, auto=True, batch=example_batch)   # plan + install
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.parallel.strategy import ParallelConfig

log = logging.getLogger("deeplearning4j_tpu_torch")

# Adam-shaped FLOPs a parameter of the update epilogue; the seconds of
# each partition beyond the first.  Both env-overridable.  The ``cuda``
# hop is measured (`chip_smoke.py` mp phase (g)): the bf16 flagship's
# captured pipe=4 GPipe step (90.07 ms) over its priced terms, per extra
# rank, on four NVIDIA H100 80GB HBM3 cards at 700 W, one NCCL rank a
# card.  Two gloo ranks sharing one card measure 0.87-1.34 s a hop (their
# handoffs and gradient sum through host memory).
UPDATE_FLOPS_PER_PARAM = 12.0
DEFAULT_HOP_SECONDS = {"cpu": 2e-3, "cuda": 0.02467573}


class PlanError(RuntimeError):
    """No feasible candidate, or a pick the world cannot install: the
    message lists every candidate's reason (or names the pick)."""

    def __init__(self, message: str, report: "PlanReport" = None):
        super().__init__(message)
        self.report = report


@dataclasses.dataclass
class Candidate:
    """One enumerated ParallelConfig with its verdict: priced (terms,
    predicted step seconds, memory estimate) or rejected (reason)."""

    config: ParallelConfig
    devices_used: int
    verdict: str = "priced"            # "priced" | "rejected"
    reason: Optional[str] = None
    terms: dict = dataclasses.field(default_factory=dict)
    predicted_step_seconds: Optional[float] = None
    mem_bytes_per_replica: Optional[int] = None

    def label(self) -> str:
        c = self.config
        parts = [f"data={c.data}"]
        for name in ("pipe", "seq", "expert"):
            v = getattr(c, name)
            if v != 1:
                parts.append(f"{name}={v}")
        parts.append(f"zero={c.zero or 0}")
        return " ".join(parts)

    def as_dict(self) -> dict:
        c = self.config
        return {
            "label": self.label(),
            "data": c.data, "pipe": c.pipe, "seq": c.seq,
            "expert": c.expert, "zero": c.zero or 0,
            "devices_used": self.devices_used,
            "verdict": self.verdict,
            "reason": self.reason,
            "terms": {k: round(v, 9) for k, v in self.terms.items()},
            "predicted_step_seconds": (
                round(self.predicted_step_seconds, 9)
                if self.predicted_step_seconds is not None else None),
            "mem_bytes_per_replica": self.mem_bytes_per_replica,
        }


@dataclasses.dataclass
class PlanReport:
    """The whole plan: the base analysis, every candidate with its price
    or reason, and the pick.  `as_dict()` is the JAX package's
    ``/api/plan`` payload (the port serves none yet, ROADMAP A13)."""

    n_devices: int
    batch_size: int
    model_name: str
    signature: str
    base: dict                         # flops / bytes / params / opt numbers
    candidates: list
    pick: Optional[ParallelConfig]
    plan_seconds: float

    @property
    def priced(self) -> list:
        return [c for c in self.candidates if c.verdict == "priced"]

    @property
    def rejected(self) -> list:
        return [c for c in self.candidates if c.verdict == "rejected"]

    def pick_candidate(self) -> Optional[Candidate]:
        if self.pick is None:
            return None
        for c in self.priced:
            if c.config == self.pick:
                return c
        return None

    def summary(self) -> str:
        pc = self.pick_candidate()
        lines = [f"plan: {len(self.priced)} priced / {len(self.rejected)} rejected "
                 f"over {self.n_devices} devices ({self.plan_seconds * 1e3:.1f}ms, "
                 "dispatch-free)"]
        for c in sorted(self.priced, key=lambda c: c.predicted_step_seconds):
            mark = " <-- pick" if pc is not None and c is pc else ""
            lines.append(f"  {c.label():<28} predicted "
                         f"{c.predicted_step_seconds * 1e3:8.3f}ms  "
                         f"mem/replica {c.mem_bytes_per_replica or 0:>12,}B{mark}")
        for c in self.rejected:
            lines.append(f"  {c.label():<28} rejected: {c.reason}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        pc = self.pick_candidate()
        return {
            "schema": "plan-report/1",
            "n_devices": self.n_devices,
            "batch_size": self.batch_size,
            "model": self.model_name,
            "signature": self.signature,
            "base": self.base,
            "candidates": [c.as_dict() for c in self.candidates],
            "pick": pc.as_dict() if pc is not None else None,
            "plan_seconds": round(self.plan_seconds, 6),
        }


_LAST_REPORT: Optional[PlanReport] = None
_LAST_LOCK = threading.Lock()


def last_report() -> Optional[PlanReport]:
    """The most recent `plan()` result in this process."""
    with _LAST_LOCK:
        return _LAST_REPORT


def _divisors(n: int) -> list:
    return [d for d in range(1, n + 1) if n % d == 0]


# -- model introspection -------------------------------------------------------

def _conf_layer_types(conf) -> list:
    if hasattr(conf, "layers"):
        return [type(l).__name__ for l in conf.layers]
    return [type(n.layer).__name__ for n in conf.nodes if n.layer is not None]


@dataclasses.dataclass(frozen=True)
class Spec:
    """The shape and numpy dtype of a batch array (JAX
    ``ShapeDtypeStruct``)."""

    shape: tuple
    dtype: np.dtype

    def __str__(self) -> str:
        return f"{np.dtype(self.dtype).name}{list(self.shape)}"


def _batch_signature(model, batch, batch_size):
    """(features Spec, labels Spec, B): from an example batch when given,
    else from the model's input type and output layer.  Raises PlanError
    with the fix when neither tells it."""
    if batch is not None:
        feats = getattr(batch, "features", None)
        labs = getattr(batch, "labels", None)
        if feats is None and isinstance(batch, (tuple, list)):
            feats, labs = batch[0], batch[1]
        if feats is None or labs is None:
            raise PlanError(
                f"cannot read features/labels off {type(batch).__name__}; pass a "
                "DataSet or an (x, y) tuple as batch=")
        f, l = tuple(np.shape(feats)), tuple(np.shape(labs))
        return (Spec(f, _np_dtype(feats)), Spec(l, _np_dtype(labs)), int(f[0]))
    b = int(batch_size or os.environ.get("DL4J_TPU_PLAN_BATCH", "64"))
    itypes = getattr(model, "_itypes", None)
    layers = getattr(model.conf, "layers", None)
    if not itypes or not layers:
        raise PlanError(
            f"cannot derive the batch signature for {type(model).__name__}; pass "
            "an example batch= to plan()/distribute(auto=True)")
    shape = tuple(int(d) for d in itypes[0].shape)
    if any(d <= 0 for d in shape):
        raise PlanError(f"input type {itypes[0]} has variable dims; pass an example "
                        "batch= to fix the signature")
    n_out = getattr(layers[-1], "n_out", None)
    if not n_out:
        raise PlanError("cannot derive the label shape (last layer has no n_out); "
                        "pass an example batch=")
    return (Spec((b,) + shape, np.dtype(np.float32)),
            Spec((b, int(n_out)), np.dtype(np.float32)), b)


def _np_dtype(a) -> np.dtype:
    dt = getattr(a, "dtype", np.float32)
    if not isinstance(dt, np.dtype) and hasattr(dt, "is_floating_point"):
        import torch

        dt = torch.empty((), dtype=dt).numpy().dtype
    return np.dtype(dt)


def _tree_bytes(tree) -> int:
    """Bytes of a tree's tensors; an updater's step count (a host int)
    counts as the int32 the checkpoint and optax hold."""
    import torch

    from deeplearning4j_tpu_torch.models.model import tree_leaves

    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, (int, np.integer)) and not isinstance(t, bool):
            total += 4
    return total


def _param_count(tree) -> int:
    from deeplearning4j_tpu_torch.models.model import tree_leaves

    return sum(int(t.numel()) for t in tree_leaves(tree))


def _opt_state_bytes(model) -> int:
    """The inner updater state's bytes (a ZeRO-2 accumulator is gradient
    state, priced per candidate), or a fresh state's, built on fake
    tensors, when the model has none yet."""
    from deeplearning4j_tpu_torch.parallel.zero import unwrap_opt_state

    # a ZeRO model holds its slices; the plan prices whole trees
    if model.opt_state is not None and model._zero_placement is None:
        return _tree_bytes(unwrap_opt_state(model.opt_state)[0])
    return _tree_bytes(_fake_full_state(model))


def _fake_full_state(model):
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = FakeTensorMode()
    leaves = [mode.from_tensor(t) for t in model._trainable_leaves(model.params)]
    with mode:
        return model._tx.init(leaves)


def _lower_args(model, feat_sig: Spec, lab_sig: Spec):
    """(the model's step program, its abstract positional arguments): the
    step's batch arrays as placeholders of the signature (`_TensorSpec`s,
    made fake by the analysis; no mask, as the fit paths stage an
    unmasked batch), the trees and the keys of its next step."""
    import torch

    from deeplearning4j_tpu_torch.observe.cost import _TensorSpec

    def spec(s: Spec):
        t = _TensorSpec(torch.empty(0, dtype=torch.from_numpy(np.zeros(0, s.dtype)).dtype))
        t.shape, t.device = tuple(s.shape), model.device
        return t

    fn = model._step_program()
    masks = (None, None) if hasattr(model.conf, "layers") else (None,)
    return fn, (model.params, model.net_state, spec(feat_sig), spec(lab_sig), *masks,
                model._layer_keys(model.iteration))


# -- capacity model ---------------------------------------------------------------

def _platform() -> str:
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def _capacity(devices_used: int) -> tuple:
    """(aggregate peak FLOP/s, aggregate peak bytes/s, collective bytes/s,
    per-hop seconds, platform) of a candidate on ``devices_used`` ranks:
    on the CPU the ranks share the host's cores (one device's peaks), on
    the card each rank adds its device's."""
    from deeplearning4j_tpu_torch.observe.cost import peaks

    per_dev_f, per_dev_b = peaks()
    platform = _platform()
    if platform == "cpu":
        agg_f, agg_b = per_dev_f, per_dev_b
    else:
        agg_f, agg_b = per_dev_f * devices_used, per_dev_b * devices_used
    env_bw = os.environ.get("DL4J_TPU_PLAN_COLL_BW", "")
    coll_bw = float(env_bw) if env_bw else agg_b
    env_hop = os.environ.get("DL4J_TPU_PLAN_HOP_S", "")
    hop_s = float(env_hop) if env_hop else DEFAULT_HOP_SECONDS.get(platform, 1e-4)
    return agg_f, agg_b, coll_bw, hop_s, platform


# -- enumeration and legality -------------------------------------------------------

def _check_legal(model, cand: Candidate, B: int, feat_ndim: int, layer_types: list,
                 n_devices: int) -> Optional[str]:
    """Why this candidate is illegal, or None; recorded, never raised."""
    c = cand.config
    d, p, s, e = c.data, c.pipe, c.seq, c.expert
    zero = c.zero or 0
    if B % d:
        return f"batch {B} not divisible by data={d}"
    if zero >= 1:
        if d == 1:
            return f"zero={zero} is redundant at data=1 (no shards)"
        if p > 1 or s > 1 or e > 1:
            return f"zero={zero} composes with pure data parallelism only"
    if p > 1:
        if not hasattr(model, "_setup_pipeline"):
            return (f"{type(model).__name__} has no pipelineable segment (pipeline "
                    "runs over a SequentialModel's repeated blocks)")
        from deeplearning4j_tpu_torch.parallel.pipeline import plan_sequential_pipeline

        try:
            plan_sequential_pipeline(model.conf.layers, model.params, model._itypes, p,
                                     c.microbatches, net_state=model.net_state)
        except Exception as exc:
            return f"pipeline plan failed for pipe={p}: {exc}"
        if s > 1:
            return ("pipeline parallelism beside the seq axis: the JAX package's "
                    "step cannot run it either (ROADMAP C29)")
    if s > 1:
        if not any("Attention" in t for t in layer_types):
            return ("sequence parallelism needs attention layers (the seq axis "
                    "shards the time dim of attention ops)")
        if feat_ndim < 3:
            return "batch has no time axis to shard over seq"
    if e > 1 and not any(t == "MoELayer" for t in layer_types):
        return "expert parallelism needs MoE layers"
    return None


def enumerate_candidates(model, n_devices: int, B: int, feat_ndim: int) -> list:
    """Every (data x pipe x seq x expert, zero) combination over the
    divisors of the width, underfilled shapes included (a narrower mesh
    is a legal answer where partition overhead outruns the parallel
    win); illegal ones come back rejected with their reasons."""
    layer_types = _conf_layer_types(model.conf)
    out = []
    divs = _divisors(n_devices)
    for d in divs:
        for p in divs:
            for s in divs:
                for e in divs:
                    if d * p * s * e > n_devices:
                        continue
                    # ZeRO stages vary only where they mean something:
                    # pure DP with real shards
                    zeros = (0, 1, 2) if (d > 1 and p == 1 and s == 1 and e == 1) else (0,)
                    for z in zeros:
                        cand = Candidate(
                            config=ParallelConfig(data=d, pipe=p, seq=s, expert=e, zero=z),
                            devices_used=d * p * s * e)
                        reason = _check_legal(model, cand, B, feat_ndim, layer_types,
                                              n_devices)
                        if reason is not None:
                            cand.verdict = "rejected"
                            cand.reason = reason
                        out.append(cand)
    return out


# -- pricing ---------------------------------------------------------------------------

def _price(cand: Candidate, base: dict, memory_cap_bytes: Optional[int]) -> None:
    """Fill the candidate's closed-form price terms and memory estimate,
    or reject it on the memory gate (the one analysis ran in `plan`)."""
    c = cand.config
    d, p = c.data, c.pipe
    n_used = cand.devices_used
    zero = c.zero or 0
    F = base["flops"]
    Bb = base["bytes_accessed"] or 0.0
    P = base["params_bytes"]
    opt_full = base["opt_state_bytes"]
    n_params = base["param_count"]
    agg_f, agg_b, coll_bw, hop_s, _ = base["_capacity_fn"](n_used)

    compute_s = F / agg_f if agg_f else 0.0
    memory_s = Bb / agg_b if agg_b else 0.0
    roofline_s = max(compute_s, memory_s)
    bound = "compute" if compute_s >= memory_s else "memory"

    # the pipeline bubble: with m microbatches and p stages (p-1)/(m+p-1)
    # of the schedule idles
    bubble_frac = 0.0
    if p > 1:
        m = c.microbatches or 2 * p
        bubble_frac = (p - 1) / (m + p - 1)
        roofline_s = roofline_s / (1.0 - bubble_frac)

    # the data axis's gradient exchange: an all-reduce (zero=0) or the
    # reduce-scatter and all-gather pair (zero>=1), the same ring bytes
    coll_bytes = 2.0 * (d - 1) / d * P if d > 1 else 0.0
    coll_s = coll_bytes / coll_bw if coll_bw else 0.0
    hop_penalty_s = (n_used - 1) * hop_s

    # the update: replicated runs it whole on every replica, sharded
    # 1/d a replica; ZeRO-2 adds the accumulator's add
    update_flops = UPDATE_FLOPS_PER_PARAM * n_params
    if zero >= 1:
        update_total = update_flops
        if zero == 2:
            update_total += n_params / d
    else:
        update_total = update_flops * d
    update_s = update_total / agg_f if agg_f else 0.0

    predicted = roofline_s + coll_s + hop_penalty_s + update_s

    grads_b = P / d if zero == 2 else P
    opt_b = opt_full / d if zero >= 1 else opt_full
    act_b = Bb / n_used
    mem = int(P + grads_b + opt_b + act_b)

    cand.terms = {
        "compute_seconds": compute_s,
        "memory_seconds": memory_s,
        "bound_" + bound: 1.0,
        "bubble_fraction": bubble_frac,
        "collective_seconds": coll_s,
        "hop_penalty_seconds": hop_penalty_s,
        "update_seconds": update_s,
    }
    cand.predicted_step_seconds = predicted
    cand.mem_bytes_per_replica = mem
    if memory_cap_bytes is not None and mem > memory_cap_bytes:
        cand.verdict = "rejected"
        cand.reason = (
            f"memory infeasible: ~{mem:,}B/replica > cap {memory_cap_bytes:,}B "
            f"(params {int(P):,} + grads {int(grads_b):,} + opt {int(opt_b):,} + "
            f"act {int(act_b):,})")


# -- the entry point ------------------------------------------------------------------

def _default_width(model) -> int:
    """The ranks a plan prices by default: the running world's, else the
    visible cards for a model on the card, else 1."""
    import torch

    from deeplearning4j_tpu_torch.runtime import distributed

    if distributed.is_initialized():
        return distributed.process_count()
    if model.device.type == "cuda":
        return max(1, torch.cuda.device_count())
    return 1


def plan(model, n_devices: Optional[int] = None, devices=None, batch=None,
         batch_size: Optional[int] = None,
         memory_cap_bytes: Optional[int] = None) -> PlanReport:
    """Enumerate, price and rank the placements of ``model`` on
    ``n_devices`` ranks without running anything on a device (one
    abstract count of the undistributed step).  Returns the PlanReport;
    raises PlanError listing every candidate's reason when none is
    feasible.  ``memory_cap_bytes`` defaults to DL4J_TPU_PLAN_MEM_CAP."""
    t0 = time.perf_counter()
    if model.params is None:
        model.init()
    if devices is not None:
        n = n_devices or len(devices)
    else:
        n = n_devices or _default_width(model)
    if memory_cap_bytes is None:
        cap_env = os.environ.get("DL4J_TPU_PLAN_MEM_CAP", "")
        memory_cap_bytes = int(cap_env) if cap_env else None

    feat_sig, lab_sig, B = _batch_signature(model, batch, batch_size)

    analysis_reason = None
    ana = None
    try:
        from deeplearning4j_tpu_torch.observe import cost

        with model.undistributed():
            fn, args = _lower_args(model, feat_sig, lab_sig)
            ana = cost.analyze_signature(fn, args)
        if not ana.ok:
            analysis_reason = ana.reason
    except Exception as e:
        analysis_reason = f"step lowering failed ({type(e).__name__}: {e})"

    base = {
        "flops": ana.flops if ana is not None and ana.ok else None,
        "bytes_accessed": ana.bytes_accessed if ana is not None else None,
        "params_bytes": _tree_bytes(model.params),
        "opt_state_bytes": _opt_state_bytes(model),
        "param_count": _param_count(model.params),
        "analysis_reason": analysis_reason,
        "_capacity_fn": _capacity,
    }

    candidates = enumerate_candidates(model, n, B, len(feat_sig.shape))
    for cand in candidates:
        if cand.verdict == "rejected":
            continue
        if analysis_reason is not None:
            cand.verdict = "rejected"
            cand.reason = f"analysis: {analysis_reason}"
            continue
        _price(cand, base, memory_cap_bytes)

    priced = [c for c in candidates if c.verdict == "priced"]
    pick = min(priced, key=lambda c: c.predicted_step_seconds).config if priced else None
    report = PlanReport(
        n_devices=n, batch_size=B, model_name=type(model).__name__,
        signature=f"{feat_sig} {lab_sig}",
        base={k: v for k, v in base.items() if not k.startswith("_")},
        candidates=candidates, pick=pick, plan_seconds=time.perf_counter() - t0)
    global _LAST_REPORT
    with _LAST_LOCK:
        _LAST_REPORT = report
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        reg = registry()
        cnt = reg.counter("dl4jtpu_plan_candidates_total")
        cnt.inc(len(report.priced), verdict="priced")
        cnt.inc(len(report.rejected), verdict="rejected")
        reg.gauge("dl4jtpu_plan_seconds").set(report.plan_seconds)
        pc = report.pick_candidate()
        if pc is not None:
            reg.gauge("dl4jtpu_plan_predicted_step_seconds").set(pc.predicted_step_seconds)
    except Exception as e:          # telemetry never fails a plan
        log.debug("plan metrics failed: %s", e)
    log.info("%s", report.summary())
    if pick is None:
        raise PlanError(
            f"no feasible placement for {type(model).__name__} on {n} devices:\n"
            + "\n".join(f"  {c.label()}: {c.reason}" for c in report.rejected),
            report=report)
    return report
