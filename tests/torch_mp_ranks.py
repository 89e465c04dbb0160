"""Rank bodies of the port's model-parallel tests (the mesh axes, tensor,
sequence and expert parallelism): each runs on every rank of a gloo
world of spawned CPU processes
(`deeplearning4j_tpu_torch.runtime.distributed.spawn`) and returns numpy
results for the test to hold against the JAX package's mesh.  A rank
feeds the rows of its data-axis block of each global batch, whole in
time (`parallel/data_parallel.py` `local_rows`).  This module imports
nothing of JAX (each rank imports it)."""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.models.model import tree_leaves
from deeplearning4j_tpu_torch.runtime import distributed
from torch_dp_ranks import graph_model, seq_model


def rank() -> int:
    return distributed.process_index()


def distribute(m, **cfg):
    from deeplearning4j_tpu_torch.parallel import ParallelConfig
    from deeplearning4j_tpu_torch.parallel import distribute as dist_fn

    return dist_fn(m, ParallelConfig(**cfg))


def rows(m, a):
    from deeplearning4j_tpu_torch.parallel.data_parallel import local_rows

    return None if a is None else local_rows(m, a)


def batch(m, x, y, lmask=None, fmask=None) -> DataSet:
    return DataSet(rows(m, x), rows(m, y), rows(m, fmask), rows(m, lmask))


def full_table(m) -> dict:
    """Every leaf of the whole (gathered) parameter tree, by path."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}.{k}" if path else k)
        else:
            out[path] = node.detach().cpu().numpy().copy()

    walk(m.full_params(), "")
    return out


def local_table(m) -> dict:
    """This rank's leaves as it holds them (slices under a split)."""
    return {k: np.array(v) for k, v in m.param_table().items()}


def fit(m, batches) -> list:
    losses = []
    for b in batches:
        m.fit_batch(batch(m, *b))
        losses.append(m.score_value)
    return losses


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


# -- tests/test_torch_mesh_axes.py ---------------------------------------------

def mesh_world(case: dict) -> dict:
    """The mesh's layout and groups, and each collective's forward and
    backward, on a (data=2, model=2) mesh of four ranks."""
    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.runtime.mesh import (
        MeshSpec,
        active_mesh_scope,
        make_mesh,
    )

    r = rank()
    out = {}
    mesh = make_mesh(MeshSpec.of(data=2, model=2))
    out["coords"] = mesh.coords(r)
    out["index"] = {a: mesh.axis_index(a) for a in ("data", "model", "seq")}
    out["lines"] = {a: dist.get_process_group_ranks(mesh.axis_group(a))
                    for a in ("data", "model")}
    out["seq_group"] = mesh.axis_group("seq")
    x0 = torch.arange(6.0).reshape(2, 3) + 10 * r
    w = float(r + 1)
    with active_mesh_scope(mesh):
        out["size_rank"] = (C.axis_size("model"), C.axis_rank("model"),
                            C.axis_size(("data", "model")))
        for name, fn in (
                ("copy_to", lambda x: C.copy_to(x, "model")),
                ("reduce_from", lambda x: C.reduce_from(x, "model")),
                ("all_reduce_sum", lambda x: C.all_reduce_sum(x, "data")),
                ("gather_slice", lambda x: C.gather(x, 1, "model")),
                ("gather_sum", lambda x: C.gather(x, 1, "model", grad="sum")),
                ("block", lambda x: C.block(x, 1, "data")),
                ("ppermute", lambda x: C.ppermute(x, "data")),
                ("all_to_all", lambda x: C.all_to_all(x, "model", 0, 1))):
            x = x0.clone().requires_grad_()
            y = fn(x)
            (y * w * torch.ones_like(y)).sum().backward()
            out[name] = (_np(y), _np(x.grad))
        out["world_sum"] = _np(C.all_reduce_sum(x0, ("data", "model")))
    with active_mesh_scope(None):
        out["no_mesh"] = _np(C.gather(x0, 0, "model"))
    return out


def mesh_world_of_one(case: dict) -> dict:
    from deeplearning4j_tpu_torch.runtime.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec.of(data=-1, model=1, seq=1))
    return {"shape": mesh.shape, "group": mesh.axis_group("data"),
            "index": mesh.axis_index("data")}


# -- tests/test_torch_tensor_parallel.py ----------------------------------------

def grad_of(m, x, y) -> dict:
    """One SGD(1.0) step's parameter change (minus the gradient) of this
    rank's leaves, then the step undone."""
    before = [t.detach().clone() for t in tree_leaves(m.params)]
    opt, it = m.opt_state, m.iteration
    m.fit_batch(batch(m, x, y))
    g = {}
    for i, t in enumerate(tree_leaves(m.params)):
        g[i] = _np(before[i] - t)
        with torch.no_grad():
            t.copy_(before[i])
    m.opt_state, m.iteration = opt, it
    return g


def tp_world(case: dict) -> dict:
    """Every tensor-parallel case of one world (its size is the
    product of each case's axes)."""
    from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

    out = {}
    n = distributed.process_count()
    for name, (conf, params, cfg, batches, probe) in case["seq"].items():
        if np.prod(list(cfg.values())) != n:
            continue
        m = seq_model(conf, params)
        distribute(m, **cfg)
        out[f"{name}_losses"] = fit(m, batches)
        out[name] = full_table(m)
        out[f"{name}_local"] = local_table(m)
        out[f"{name}_out"] = _np(m.output(probe))
        if name == "mlp":
            out["mlp_score"] = m.score(DataSet(*batches[0]))
            out["mlp_eval"] = m.evaluate(DataSet(*batches[0])).accuracy()
            path = os.path.join(case["tmp"], f"tp{n}.zip")
            ModelSerializer.write_model(m, path)
            if distributed.is_chief():
                back = ModelSerializer.restore(path, device="cpu")
                out["zip"] = {k: np.array(v) for k, v in back.param_table().items()}
                out["zip_out"] = _np(back.output(probe))
    if "grad" in case and n == case["grad"][2]:
        conf, params, _, x, y = case["grad"]
        plain = seq_model(conf, params)
        gp = grad_of(plain, x, y)
        m = seq_model(conf, params)
        distribute(m, **case["grad_cfg"])
        out["grad"] = grad_of(m, x, y)
        out["grad_plain"] = gp
        out["grad_splits"] = [None if s is None else tuple(s)
                              for s in m._shard_placement.splits]
        out["grad_coords"] = m._mesh.coords(rank())
        out["grad_shape"] = m._mesh.shape
    for name, (conf, cfg, batches) in case.get("graph", {}).items():
        if np.prod(list(cfg.values())) != n:
            continue
        m = graph_model(conf)
        distribute(m, **cfg)
        losses = []
        for x, y in batches:
            m.fit_batch(MultiDataSet((rows(m, x),), (rows(m, y),)))
            losses.append(m.score_value)
        out[f"{name}_losses"] = losses
        out[name] = full_table(m)
        out[f"{name}_out"] = _np(m.output(batches[0][0]))
    return out


# -- tests/test_torch_seq_parallel.py --------------------------------------------

def _blocks(a, r, s, dim=1):
    c = a.shape[dim] // s
    return np.take(a, range(r * c, (r + 1) * c), axis=dim)


def attention_ops(case: dict) -> dict:
    """Ring and Ulysses attention on this rank's time blocks: outputs and
    the gradients of sum(out ** 2) (summed over the ranks)."""
    from deeplearning4j_tpu_torch.ops.attention import ring_attention, ulysses_attention
    from deeplearning4j_tpu_torch.runtime.mesh import (
        MeshSpec,
        active_mesh_scope,
        make_mesh,
    )

    mesh = make_mesh(MeshSpec.of(data=1, seq=-1))
    s, r = mesh.shape["seq"], mesh.axis_index("seq")
    out = {}
    with active_mesh_scope(mesh):
        for name, (kind, q, k, v, mask, causal) in case["ops"].items():
            qt, kt, vt = (torch.from_numpy(_blocks(a, r, s)).requires_grad_()
                          for a in (q, k, v))
            mt = None if mask is None else torch.from_numpy(_blocks(mask, r, s))
            core = ring_attention if kind == "ring" else ulysses_attention
            o = core(qt, kt, vt, axis="seq", causal=causal, mask=mt)
            (o ** 2).sum().backward()
            out[name] = [_np(o), _np(qt.grad), _np(kt.grad), _np(vt.grad)]
    return out


def sp_world(case: dict) -> dict:
    """Every sequence-parallel training case of one world."""
    out = {}
    n = distributed.process_count()
    if "ops" in case:
        out["ops"] = attention_ops(case)
    for name, (conf, params, cfg, batches, probe) in case["seq"].items():
        if np.prod(list(cfg.values())) != n:
            continue
        m = seq_model(conf, params)
        distribute(m, **cfg)
        out[f"{name}_losses"] = fit(m, batches)
        out[name] = full_table(m)
        out[f"{name}_out"] = _np(m.output(probe))
        out[f"{name}_ff"] = [_np(a) for a in m.feed_forward(probe)]
        whole = seq_model(conf)
        whole.load_params(m.full_params())
        out[f"{name}_ff_whole"] = [_np(a) for a in whole.feed_forward(probe)]
        if name == "tf_ring":
            x, y = batches[0]
            out["tf_ring_score"] = m.score(DataSet(x, y))
    return out


# -- tests/test_torch_expert_parallel.py ------------------------------------------

def moe_apply_split(case: dict) -> dict:
    """`moe_apply` with the experts split over the expert axis of a world
    of its own, and its gradients, against the same function whole."""
    from deeplearning4j_tpu_torch.parallel.expert import MoEConfig, init_moe, moe_apply
    from deeplearning4j_tpu_torch.runtime import rng
    from deeplearning4j_tpu_torch.runtime.mesh import (
        MeshSpec,
        active_mesh_scope,
        make_mesh,
    )

    cfg = MoEConfig(**case["moe_cfg"])
    x = torch.from_numpy(case["moe_x"])
    mesh = make_mesh(MeshSpec.of(data=1, expert=-1))
    el = cfg.n_experts // mesh.shape["expert"]
    e0 = mesh.axis_index("expert") * el
    out = {}
    for split in (False, True):
        p = init_moe(rng.key(1), cfg)
        if split:
            p = {**p, "Wi": p["Wi"][e0:e0 + el].clone(), "Wo": p["Wo"][e0:e0 + el].clone()}
        p = {k: v.requires_grad_() for k, v in p.items()}
        xx = x.clone().requires_grad_()
        splits = {id(p["Wi"]): "expert", id(p["Wo"]): "expert"} if split else None
        with active_mesh_scope(mesh if split else None, splits):
            y, aux = moe_apply(p, xx, cfg)
            ((y ** 2).sum() + 0.01 * aux).backward()
        out["split" if split else "whole"] = {
            "y": _np(y), "aux": float(aux), "dx": _np(xx.grad),
            "router": _np(p["router"].grad), "Wi": _np(p["Wi"].grad),
            "Wo": _np(p["Wo"].grad)}
    out["e0"], out["el"] = e0, el
    return out


def ep_world(case: dict) -> dict:
    """Every expert-parallel (and data-parallel MoE) case of one world."""
    from deeplearning4j_tpu_torch.parallel.context import DataParallelContext, dp_scope
    from deeplearning4j_tpu_torch.parallel.expert import dropped_share

    out = {}
    n = distributed.process_count()
    if "moe_x" in case and n == 2:
        out["apply"] = moe_apply_split(case)
    for name, (conf, params, cfg, batches, probe) in case["seq"].items():
        if np.prod(list(cfg.values())) != n:
            continue
        m = seq_model(conf, params)
        distribute(m, **cfg)
        if name.startswith("c27"):
            # the first MoE layer's dropped share on the first batch's
            # embedded tokens, routed as the step routes them
            moe = next(l for l in m.conf.layers if type(l).__name__ == "MoELayer")
            emb = m.conf.layers[0]
            x, _ = batches[0]
            lp = m.compute_params()
            with m.mesh_scope(), dp_scope(DataParallelContext(
                    m._batch_sharding.rank, m._batch_sharding.n)):
                h = emb.apply(lp[emb.name], {}, rows(m, x))[0].float()
                out[f"{name}_dropped"] = dropped_share(lp[moe.name], h, moe._cfg())
        out[f"{name}_losses"] = fit(m, batches)
        out[name] = full_table(m)
        out[f"{name}_out"] = _np(m.output(probe))
    return out


# -- tests/test_torch_zoo_parallel.py ----------------------------------------------

def zoo_tp_world(case: dict) -> dict:
    """Each zoo graph of ``case`` (configuration JSON, weights, layer
    state, the batch) under ``model=n``: ``output()`` of the batch, then
    one step and the whole tree after it, and the split each leaf
    took."""
    from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphConfiguration

    out = {}
    for name, (conf, params, state, x, y) in case.items():
        m = GraphModel(GraphConfiguration.from_json(conf), device="cpu")
        m.load_params(params).load_net_state(state)
        distribute(m, model=distributed.process_count())
        out[f"{name}_splits"] = [None if s is None else tuple(s)
                                 for s in m._shard_placement.splits]
        out[f"{name}_out"] = _np(m.output(x))
        m.fit_batch(MultiDataSet((rows(m, x),), (rows(m, y),)))
        out[f"{name}_loss"] = m.score_value
        out[name] = full_table(m)
    return out
