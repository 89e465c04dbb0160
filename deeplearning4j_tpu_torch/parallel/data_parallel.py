"""`distribute` — `deeplearning4j_tpu/parallel/data_parallel.py`.

The JAX package replicates a model's trees over a device mesh, places
each batch with ``P("data")``, and its jitted step becomes an SPMD
program with GSPMD's gradient all-reduce.  The port runs one process per
device (`runtime/distributed.py`): `distribute` attaches the world's
data axis to a model on each rank, makes its replicas equal (one
broadcast from rank 0), and from then on each rank's ``fit`` takes its
rows of every global batch and its step (`models/model.py`) computes the
global step:

- the loss is normalised by the global count and the gradients are
  summed across ranks in one flat all-reduce a step (the loss rides in
  the same bucket), then the updater runs, replicated (``zero=0``) or on
  the rank's slices (``zero=1/2``, `parallel/zero.py`);
- BatchNorm's statistics and dropout's masks are the global batch's
  (`parallel/context.py`);
- ``grad_compression="int8"`` exchanges the gradients as error-feedback
  int8 (`parallel/compression.py`) with the JAX compressed step's
  per-shard semantics; a world of one takes the plain step.

The other axes of `ParallelConfig` split the model inside the step:

- ``model=m``: the parameters the JAX partition rules split
  (`parallel/strategy.py` `param_specs`) become the rank's slices;
  Dense, Embedding and the convolutions compute their output-feature
  slice and all-gather it, and the chunked vocabulary head computes a
  vocabulary-parallel loss (`ops/chunked_xent.py`);
- ``expert=x``: a MoE layer's experts are split over the expert axis,
  each rank runs its experts' slots and the partial outputs are summed
  (`parallel/expert.py`);
- ``seq=s``: the step runs on the rank's time block, attention runs as
  ring or Ulysses attention (the layers' ``seq_parallel``), and a layer
  that needs the whole sequence runs on it gathered
  (`models/sequential.py`).

Every rank of a model, expert or seq line feeds the same rows (whole in
time); a gradient is summed over the ranks that hold the same slice and
see different rows (the data and seq axes), BatchNorm's statistics and
a masked loss's count likewise.

On CUDA the step stays one captured graph a batch signature with its
NCCL collectives inside (the warm-up runs each communicator's first
collectives eagerly).  Gloo collectives cannot be captured, so a model
on the card in a gloo world steps eagerly (``capture_steps`` False).

``pipe=k`` pipelines a `SequentialModel`'s run of identical blocks
over the pipe axis (`parallel/pipeline.py`): each rank runs its stage's
blocks on microbatches, GPipe inside the ordinary step or the 1F1B step
(``schedule``).  The blocks' parameters stay whole on every rank, as in
the JAX package, and every rank of a pipe line feeds the same rows; the
step sums the gradients over the data and pipe axes together, each
stage's blocks' from their rank and the other layers' from the last
stage.  It composes with the data, model and expert axes; beside the
seq axis it raises, as the JAX package's step fails there (ROADMAP C29).

``auto=True`` (or ``DL4J_TPU_AUTO_PLAN`` with no config) prices the
placements with the planner (`parallel/planner.py`) and installs its
pick.  The port's mesh spans the whole world, so a pick narrower than
the running world raises a `PlanError` that names it (ROADMAP C28).

Works for `SequentialModel` and `GraphModel` (pipelining for the first
only)::

    distribute(model, ParallelConfig(data=-1))   # every rank
    model.fit(my_rows)                           # each rank its rows
"""

from __future__ import annotations

import logging

from deeplearning4j_tpu_torch.parallel.strategy import (
    ParallelConfig,
    ShardPlacement,
    batch_sharding,
    param_specs,
    replicate,
    shard_params,
)
from deeplearning4j_tpu_torch.runtime.mesh import (
    DATA_AXIS,
    EXPERT_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQ_AXIS,
)

log = logging.getLogger("deeplearning4j_tpu_torch")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP A11: the port's parallelism is "
        "data, tensor, sequence, expert and pipeline parallelism, the "
        "planner, ZeRO-1/2 and int8 gradient compression)")


# layer types whose forward computes the whole function from slices
# split by the model axis (`nn/conf/layers.py`, `nn/conf/layers_nd.py`)
_TP_LAYERS = {"Dense", "Embedding", "Conv2D", "Conv1D", "Conv3D", "SeparableConv2D",
              "Deconv2D", "CenterLossOutputLayer", "ChunkedSoftmaxOutputLayer",
              "MoELayer"}


def _check_model_parallel(model, specs, sp: bool) -> None:
    """Raise for what the split step cannot run: a split leaf of a layer
    whose forward does not gather it (recurrent layers under the model
    axis, ROADMAP A11), or a graph under the seq axis."""
    from deeplearning4j_tpu_torch.nn.conf.recurrent import RecurrentLayerConfig
    from deeplearning4j_tpu_torch.parallel.strategy import (
        layer_types,
        spec_dim,
        spec_leaves,
    )

    types = layer_types(model.conf)
    layers = {l.name: l for l in getattr(model.conf, "layers", ())}
    for lname, spec in specs.items():
        if all(spec_dim(s) is None for s in spec_leaves(spec)):
            continue
        if isinstance(layers.get(lname), RecurrentLayerConfig) or \
                types.get(lname) == "Bidirectional":
            raise _not_ported(
                f"tensor parallelism of recurrent layer {lname!r} (per-step "
                "gate gathers inside the captured window steps)")
        if types.get(lname) not in _TP_LAYERS:
            raise _not_ported(
                f"tensor parallelism of {types.get(lname)} layer {lname!r}")
    if sp and not hasattr(model.conf, "layers"):
        raise _not_ported("sequence parallelism of a computation graph")


def distribute(model, config: ParallelConfig | None = None, devices=None,
               mesh=None, auto: bool = False, batch=None,
               memory_cap_bytes: int | None = None):
    """Attach the world's data axis to ``model`` (every rank calls it on
    its replica) and make its fits data-parallel.  Forms a world of one
    when none is initialized.  Returns the model."""
    from deeplearning4j_tpu_torch.parallel import zero as zero_mod
    from deeplearning4j_tpu_torch.runtime import distributed
    from deeplearning4j_tpu_torch.runtime.flags import environment

    if model.params is None:
        model.init()
    if not auto and config is None:
        auto = environment().auto_plan
    if auto:
        config = _planned_config(model, config, mesh, devices, batch,
                                 memory_cap_bytes)
    config = config or ParallelConfig.data_parallel()
    split = any(getattr(config, a) != 1 for a in ("model", "seq", "expert", "pipe"))
    zero = config.zero
    if zero is None:
        zero = environment().zero
    if zero not in (0, 1, 2):
        raise ValueError(
            f"unknown zero stage {zero!r}; options: 0 (replicated update), 1 "
            "(sharded opt state + update), 2 (ZeRO-1 + persistently sharded "
            "gradients)")
    if zero >= 1 and (split or config.grad_compression != "none"):
        raise ValueError(
            f"zero={zero} composes with pure data parallelism only (the "
            "weight-update shards ride the data axis); drop the "
            "model/pipe/seq/expert axes and grad_compression, or the zero stage")
    if config.grad_accum > 1:
        if zero != 2:
            raise ValueError(
                f"grad_accum={config.grad_accum} is the ZeRO-2 microbatch-"
                "accumulation knob; set zero=2 (the sharded accumulator is what "
                "makes accumulation memory-safe)")
        from deeplearning4j_tpu_torch.nn.conf.recurrent import RecurrentLayerConfig

        conf = model.conf
        if getattr(conf, "backprop_type", "") == "tbptt" or any(
                isinstance(l, RecurrentLayerConfig) for l in getattr(conf, "layers", ())):
            raise NotImplementedError(
                "grad_accum > 1 applies to the single-batch feed-forward/CNN "
                "step; TBPTT and recurrent carry-threading fits do not run the "
                "accumulation scan — drop grad_accum (zero=2 itself still works "
                "there)")
    if config.grad_compression not in ("none", "int8"):
        raise ValueError(
            f"unknown grad_compression {config.grad_compression!r}; options: "
            "'none', 'int8'")
    if config.grad_compression != "none" and split:
        raise ValueError(
            "grad_compression composes with pure data parallelism only "
            "(the reference's compression was DP-only too); drop the "
            "model/pipe/seq/expert axes or the compression")

    if config.pipe != 1:
        _check_pipeline(model, config)
    if not distributed.is_initialized():
        distributed.initialize(distributed.DistributedConfig(
            platform="cpu" if model.device.type == "cpu" else None))
    rank_dev = distributed.device()
    if rank_dev.type != model.device.type:
        raise ValueError(
            f"the model lives on {model.device} but this rank's device is "
            f"{rank_dev}; build the model on the rank's device")
    # a previous distribution's slices come back whole first (every rank)
    _undistribute(model)
    mesh = mesh or config.build_mesh(devices)
    if mesh.size != distributed.process_count():
        raise ValueError(
            f"the mesh has {mesh.size} ranks but the world "
            f"{distributed.process_count()}: the port's mesh spans the whole world")
    pp = mesh.shape.get(PIPE_AXIS, 1) > 1
    tp = mesh.shape.get(MODEL_AXIS, 1) > 1
    ep = mesh.shape.get(EXPERT_AXIS, 1) > 1
    sp = mesh.shape.get(SEQ_AXIS, 1) > 1
    specs = None
    if tp or ep:
        specs = param_specs(model.params, model.conf,
                            model_axis=MODEL_AXIS if tp else None,
                            expert_axis=EXPERT_AXIS if ep else None,
                            warn_unsharded=tp)
    _check_model_parallel(model, specs or {}, sp)

    # the replicas start equal: every rank takes rank 0's trees
    replicate([t.data for t in _all_leaves(model.params)])
    replicate(model.net_state)
    if model.opt_state is None:
        model.opt_state = model._init_opt_state()
    inner, _ = zero_mod.unwrap_opt_state(model.opt_state)
    replicate(inner)
    model._shard_placement = None
    if specs is not None:
        placement = ShardPlacement.build(model.params, specs, mesh)
        index = _trainable_index(model)
        model._install(shard_params(model.params, mesh, specs))
        inner = placement.shard_state(inner, index)
        model._shard_placement = placement
    leaves = model._trainable_leaves(model.params)
    rank = distributed.process_index()
    if zero == 2:
        placement = zero_mod.Zero2Placement.build(
            leaves, mesh, rank, accum=max(1, int(config.grad_accum)))
        model.opt_state = zero_mod.wrap_opt_state(
            [placement.shard(i, t) for i, t in enumerate(leaves)],
            placement.shard_state(inner))
    elif zero == 1:
        placement = zero_mod.Zero1Placement.build(leaves, mesh, rank)
        model.opt_state = placement.shard_state(inner)
    else:
        placement = None
        model.opt_state = inner
    model._zero_placement = placement
    zero_mod.gauge_opt_state_bytes(
        model, {0: "replicated", 1: "sharded", 2: "zero2"}[zero])

    model._pipeline_plan = None
    if pp:
        model._setup_pipeline(mesh, config.microbatches, config.schedule)
        _warm_pipe_group(model, mesh)
    # a re-distribution starts without the old compression state
    model._grad_compression = None
    model._grad_residual = None
    model._mesh = mesh
    model._batch_sharding = batch_sharding(mesh, seq_axis=SEQ_AXIS)
    if config.grad_compression != "none":
        model._setup_grad_compression(mesh)
    # step programs and graphs were built for the old layout
    model._step_fns.clear()
    model._drop_graphs()
    model._compute = None
    if model.device.type == "cuda" and distributed.backend_name() != "nccl":
        if model.capture_steps:
            log.info("a %s world's collectives cannot be captured: the model "
                     "steps eagerly on the card", distributed.backend_name())
        model.capture_steps = False
    return model


def _check_pipeline(model, config: ParallelConfig) -> None:
    """The refusals of a pipe axis, before any world forms: a model
    without a pipelineable stack (a graph, or a stack with no run of
    ``pipe`` identical blocks: `plan_sequential_pipeline`'s reasons), an
    unknown schedule, and the seq axis beside it (ROADMAP C29)."""
    if not hasattr(model, "_setup_pipeline"):
        raise NotImplementedError(
            f"{type(model).__name__} does not support pipeline parallelism; GPipe "
            "runs over a SequentialModel's repeated-block segment")
    from deeplearning4j_tpu_torch.models.sequential import check_schedule
    from deeplearning4j_tpu_torch.parallel.pipeline import plan_sequential_pipeline

    check_schedule(config.schedule)
    if config.pipe > 1:
        plan_sequential_pipeline(model.conf.layers, model.params, model._types(),
                                 config.pipe, config.microbatches,
                                 net_state=model.net_state)
    if config.seq != 1:
        # the JAX package takes this configuration but its step fails (a
        # shard_map nested in the pipe's manual region, ROADMAP C29)
        raise NotImplementedError(
            "pipeline parallelism beside the seq axis: the JAX package's step "
            "cannot run it either (ROADMAP C29); drop the pipe or the seq axis")


def _warm_pipe_group(model, mesh) -> None:
    """One all-reduce on the pipe line's group, so that its
    communicator exists before a tick's point-to-point transfers, in
    which only some of its ranks take part."""
    import torch
    import torch.distributed as dist

    t = torch.zeros(1, device=model.device)
    dist.all_reduce(t, group=mesh.axis_group(PIPE_AXIS))


def _planned_config(model, config, mesh, devices, batch, memory_cap_bytes):
    """``distribute(auto=True)``: the planner's pick for the running
    world (JAX ``data_parallel.py:59-90``), kept on ``model._plan_report``.
    A pick narrower than the world raises: the port's mesh spans the
    whole world (ROADMAP C28)."""
    from deeplearning4j_tpu_torch.parallel import planner
    from deeplearning4j_tpu_torch.runtime import distributed

    if config is not None:
        raise ValueError(
            "distribute(auto=True) derives the ParallelConfig — pass one or the "
            "other, not both")
    if mesh is not None:
        raise ValueError(
            "distribute(auto=True) sizes the mesh to the planned pick — an explicit "
            "mesh= would silently override the priced placement; pass devices= to "
            "bound the search instead")
    n = len(devices) if devices is not None else (
        distributed.process_count() if distributed.is_initialized() else 1)
    report = planner.plan(model, n_devices=n, batch=batch,
                          memory_cap_bytes=memory_cap_bytes)
    model._plan_report = report
    used = report.pick_candidate().devices_used
    if used != n:
        raise planner.PlanError(
            f"the plan's pick {report.pick_candidate().label()} uses {used} of the "
            f"{n} ranks, but the port's mesh spans the whole world (ROADMAP C28): "
            f"run a world of {used} ranks and distribute(auto=True) there, or pass "
            "the pick as the config", report=report)
    return report.pick


def _all_leaves(tree) -> list:
    from deeplearning4j_tpu_torch.models.model import tree_leaves

    return [t for t in tree_leaves(tree) if hasattr(t, "data")]


def _trainable_index(model) -> list:
    """The positions, among all the parameter tree's leaves, of the
    trainable ones (`_trainable_leaves` order)."""
    from deeplearning4j_tpu_torch.models.model import tree_leaves

    ids = {id(t): i for i, t in enumerate(tree_leaves(model.params))}
    return [ids[id(t)] for t in model._trainable_leaves(model.params)]


def _undistribute(model) -> None:
    """A distributed model's trees whole again, on every rank: ZeRO's
    sliced updater state gathered, split parameters and their updater
    state gathered and installed (a collective of the old mesh)."""
    from deeplearning4j_tpu_torch.parallel import zero as zero_mod

    prev = getattr(model, "_zero_placement", None)
    if prev is not None and model.opt_state is not None:
        inner, _ = zero_mod.unwrap_opt_state(model.opt_state)
        model.opt_state = prev.gather_state(inner)
    model._zero_placement = None
    sp = getattr(model, "_shard_placement", None)
    if sp is not None:
        index = _trainable_index(model)
        opt = model.opt_state
        opt = None if opt is None else sp.gather_state(opt, index)
        model._install(sp.gather_tree(model.params))
        model.opt_state = opt
        model._shard_placement = None


def place_batch(model, arr, is_mask: bool = False, is_label: bool = False):
    """This rank's rows of a batch array on the model's device (``arr``
    as it is when the model was never distributed): each rank feeds its
    local rows (`runtime/distributed.py` `put_global`)."""
    if getattr(model, "_batch_sharding", None) is None or arr is None:
        return arr
    from deeplearning4j_tpu_torch.runtime.distributed import put_global

    return put_global(arr, device=model.device)


def local_rows(model, arr):
    """This rank's rows of a global batch array (every rank passes the
    same one): its block along the data axis, whole in time, on the
    model's device; ``arr`` itself when the model is not distributed."""
    bs = getattr(model, "_batch_sharding", None)
    if bs is None or arr is None:
        return arr
    from deeplearning4j_tpu_torch.runtime.distributed import put_global

    return put_global(arr, full_value=True, device=model.device,
                      block=(bs.rank, bs.n))
