"""Rank bodies of the port's pipeline tests: each runs on every rank of a
gloo world of spawned CPU processes
(`deeplearning4j_tpu_torch.runtime.distributed.spawn`) and returns numpy
results for the test to hold against the JAX package's pipeline on its
virtual CPU devices.  This module imports nothing of JAX."""

from __future__ import annotations

import os

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.runtime import distributed
from torch_mp_ranks import _np, batch, full_table
from torch_dp_ranks import seq_model


def _toy_stage(w, h):
    return torch.tanh(h @ w)


def _toy_loss(y, lab):
    return ((y - lab) ** 2).sum(-1).mean()


def toy_world(case: dict) -> dict:
    """`tests/test_pipeline_1f1b.py`'s toy stack (stage s: tanh(h @ W_s))
    through `pipeline_apply` (its gradients by autograd) and
    `pipeline_train_1f1b` on a pipe axis of the world's width."""
    from deeplearning4j_tpu_torch.parallel import pipeline_apply, pipeline_train_1f1b
    from deeplearning4j_tpu_torch.parallel.pipeline import split_microbatches
    from deeplearning4j_tpu_torch.runtime.mesh import MeshSpec, active_mesh_scope, make_mesh

    k = distributed.process_count()
    ws, x, labels = (torch.from_numpy(np.asarray(a)) for a in case["arrays"])
    n_micro = case["n_micro"]
    mesh = make_mesh(MeshSpec.of(pipe=k))
    s = mesh.axis_index("pipe")
    out = {}
    with active_mesh_scope(mesh):
        w = ws[s].clone().requires_grad_()
        xm = split_microbatches(x, n_micro).clone().requires_grad_()
        lm = split_microbatches(labels, n_micro)
        y = pipeline_apply(_toy_stage, w, xm, axis="pipe")
        loss = torch.stack([_toy_loss(y[m], lm[m]) for m in range(n_micro)]).mean()
        loss.backward()
        out["gpipe"] = (_np(y), float(loss.detach()), _np(w.grad), _np(xm.grad))

        def loss_grad(yy, m):
            yy = yy.detach().requires_grad_()
            lv = _toy_loss(yy, lm[m])
            return lv.detach(), torch.autograd.grad(lv, yy)[0]

        mean, grads, dx = pipeline_train_1f1b(
            _toy_stage, ws[s].clone(), split_microbatches(x, n_micro), loss_grad,
            axis="pipe")
        out["1f1b"] = (float(mean), _np(grads), _np(dx))
    out["stage"] = s
    return out


def fit_world(case: dict) -> dict:
    """The narrow flagship pipelined on this world, for each case of its
    width: the losses of each step, the parameters after, ``output()``,
    a zip restored undistributed, the plan, and the refusals inside a
    world (masks, truncated BPTT)."""
    from deeplearning4j_tpu_torch.parallel import ParallelConfig, distribute
    from deeplearning4j_tpu_torch.parallel.data_parallel import local_rows
    from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

    n = distributed.process_count()
    out = {}
    conf, params = case["model"]
    for name, cfg in case["configs"].items():
        if int(np.prod([cfg.get(a, 1) for a in ("data", "pipe", "model", "seq",
                                                 "expert")])) != n:
            continue
        m = seq_model(conf, params)
        distribute(m, ParallelConfig(**cfg))
        losses = []
        for x, y in case["batches"]:
            m.fit_batch(batch(m, x, y))
            losses.append(m.score_value)
        out[f"{name}_losses"] = losses
        out[name] = full_table(m)
        out[f"{name}_out"] = _np(m.output(case["batches"][0][0]))
        out[f"{name}_programs"] = sorted(str(k) for k in m._step_fns)
        out[f"{name}_plan"] = (m._pipeline_plan.start, m._pipeline_plan.end,
                               m._pipeline_plan.k, m._pipeline_plan.n_micro)
        if name == case.get("zip"):
            path = os.path.join(case["tmp"], f"pp{n}.zip")
            if distributed.is_chief():
                # the parameters are whole on every rank: one writer
                ModelSerializer.write_model(m, path)
                back = ModelSerializer.restore(path, device="cpu")
                out["zip"] = {k: np.array(v) for k, v in back.param_table().items()}
                out["zip_out"] = _np(back.output(case["batches"][0][0]))
        if name in case.get("refusals", ()):
            x, y = case["batches"][0]
            fmask = np.ones(x.shape[:2], np.float32)
            for what, run in (
                    ("mask_output", lambda: m.output(x, fmask)),
                    ("mask_fit", lambda: m.fit_batch(DataSet(
                        local_rows(m, x), local_rows(m, y), local_rows(m, fmask))))):
                try:
                    run()
                    out[f"{name}_{what}"] = None
                except ValueError as e:
                    out[f"{name}_{what}"] = str(e)
    return out


def tbptt_world(case: dict) -> dict:
    """Truncated BPTT of a pipelined recurrent stack raises."""
    from deeplearning4j_tpu_torch.parallel import ParallelConfig, distribute

    conf, params, x, y = case
    m = seq_model(conf, params)
    distribute(m, ParallelConfig(pipe=distributed.process_count()))
    try:
        m.fit_batch(batch(m, x, y))
    except ValueError as e:
        return {"tbptt": str(e)}
    return {"tbptt": None}


def plan_world(case: dict) -> dict:
    """``distribute(auto=True)`` in this world: the installed pick, or
    the refusal of a pick narrower than the world (ROADMAP C28)."""
    from deeplearning4j_tpu_torch.parallel import ParallelConfig, PlanError, distribute, plan
    from deeplearning4j_tpu_torch.runtime.flags import environment

    conf, params, x, y = case
    m = seq_model(conf, params)
    try:
        distribute(m, auto=True, batch=(x, y))
    except PlanError as e:
        # a ZeRO-2 model's re-plan prices the optimizer state whole
        z = seq_model(conf, params)
        distribute(z, ParallelConfig(zero=2))
        return {"raised": str(e), "pick": m._plan_report.pick_candidate().label(),
                "zero2_opt_bytes": plan(z, n_devices=8, batch_size=64).base[
                    "opt_state_bytes"],
                "fresh_opt_bytes": plan(seq_model(conf, params), n_devices=8,
                                        batch_size=64).base["opt_state_bytes"]}
    m.fit_batch(batch(m, x, y))
    env = seq_model(conf, params)
    environment().auto_plan = True
    distribute(env)                 # no config: the knob asks the planner
    return {"raised": None, "pick": m._plan_report.pick_candidate().label(),
            "mesh": dict(m._mesh.shape), "score": m.score_value,
            "env_pick": env._plan_report.pick_candidate().label()}
