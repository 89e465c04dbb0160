"""Rank bodies of the port's data-parallel tests: each runs on every rank
of a gloo world of spawned CPU processes
(`deeplearning4j_tpu_torch.runtime.distributed.spawn`) and returns
numpy results for the test to hold against the JAX package's mesh.
This module imports nothing of JAX (each rank imports it)."""

from __future__ import annotations

import os

import numpy as np
import torch

from deeplearning4j_tpu_torch.convert import net_state_to_numpy, params_from_jax
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.runtime import distributed


def rank() -> int:
    return distributed.process_index()


def rows(a):
    """This rank's rows of a global batch array (None stays None)."""
    if a is None:
        return None
    return distributed.put_global(a, full_value=True, device="cpu")


def rank_batch(x, y, lmask=None, fmask=None) -> DataSet:
    return DataSet(rows(x), rows(y), rows(fmask), rows(lmask))


def seq_model(conf_json: str, params=None):
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        SequentialConfiguration,
    )

    m = SequentialModel(SequentialConfiguration.from_json(conf_json), device="cpu").init()
    if params is not None:
        params_from_jax(params, m)
    return m


def graph_model(conf_json: str):
    from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
    from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphConfiguration

    return GraphModel(GraphConfiguration.from_json(conf_json), device="cpu").init()


def table(m) -> dict:
    return {k: np.array(v) for k, v in m.param_table().items()}


def state(m) -> dict:
    return {f"{k}/{kk}": np.array(vv) for k, v in net_state_to_numpy(m).items()
            for kk, vv in v.items()}


def fit_epochs(m, epochs, **kw) -> list:
    """Fit each epoch's global batches, this rank's rows; the losses."""
    losses = []
    for batches in epochs:
        for b in batches:
            m.fit_batch(rank_batch(*b))
            losses.append(m.score_value)
    return losses


def accuracy(m, x, y) -> float:
    pred = m.output(x).argmax(dim=-1).numpy()
    return float((pred == np.asarray(y).argmax(-1)).mean())


def distribute(m, **cfg):
    from deeplearning4j_tpu_torch.parallel import ParallelConfig
    from deeplearning4j_tpu_torch.parallel import distribute as dist_fn

    return dist_fn(m, ParallelConfig(**cfg))


# -- tests/test_torch_parallel.py ---------------------------------------------

def parallel_world(case: dict) -> dict:
    """Every case of the data-parallel file on one world."""
    from deeplearning4j_tpu_torch.nn.conf.layers import _dropout
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.context import DataParallelContext, dp_scope

    out = {}
    m = seq_model(case["mlp_conf"], case["mlp_params"])
    distribute(m, data=-1)
    fit_epochs(m, case["mlp_epochs"])
    out["mlp"] = table(m)
    # the cost analysis counts this rank's work: the undistributed step's
    # on the rank's rows
    from deeplearning4j_tpu_torch.observe import cost

    x, y = case["mlp_epochs"][0][0]
    plain = seq_model(case["mlp_conf"])
    plain.fit_batch(rank_batch(x, y))
    out["flops"] = [[r.flops for r in cost.analyze_model(mm) if r.kind == "train"]
                    for mm in (m, plain)]
    if "learn" in case:
        x, y, epochs = case["learn"]
        m = seq_model(case["mlp_conf"])
        distribute(m)
        fit_epochs(m, epochs)
        out["learn_acc"] = accuracy(m, x, y)
        m = seq_model(case["mlp_conf"])
        pw = ParallelWrapper(m)
        for batches in case["wrapper_epochs"]:
            pw.fit([rank_batch(*b) for b in batches])
        out["wrapper_acc"] = accuracy(m, x, y)
        out["wrapper_out"] = pw.output(x[:8]).numpy()
    if "cnn" in case:
        conf, batches = case["cnn"]
        m = seq_model(conf)
        distribute(m)
        out["cnn_losses"] = fit_epochs(m, [batches])
        out["cnn"], out["cnn_state"] = table(m), state(m)
    if "masked" in case:
        conf, batches = case["masked"]
        m = seq_model(conf)
        distribute(m)
        out["masked_losses"] = fit_epochs(m, [batches])
        out["masked"] = table(m)
    if "penalty" in case:
        conf, batches = case["penalty"]
        m = seq_model(conf)
        distribute(m)
        out["penalty_losses"] = fit_epochs(m, [batches])
        out["penalty"] = table(m)
    if "grouped" in case:
        m = seq_model(case["mlp_conf"])
        distribute(m)
        m.fit([rank_batch(*b) for b in case["grouped"]], steps_per_execution=2)
        out["grouped"] = table(m)
        out["grouped_scores"] = np.asarray(m._last_score)
    if "graph" in case:
        conf, batches = case["graph"]
        m = graph_model(conf)
        distribute(m)
        out["graph_losses"] = [None] * 0
        for x, y in batches:
            m.fit_batch(MultiDataSet((rows(x),), (rows(y),)))
            out["graph_losses"].append(m.score_value)
        out["graph"] = table(m)
    if "tbptt" in case:
        conf, batches = case["tbptt"]
        m = seq_model(conf)
        distribute(m)
        losses = []
        for b in batches:
            m.fit_batch(rank_batch(*b))
            losses.extend(np.asarray(m._last_score).ravel().tolist())
        out["tbptt_losses"], out["tbptt"] = losses, table(m)
    if "mask_draw" in case:
        key, rate, shape = case["mask_draw"]
        n = distributed.process_count()
        local = (shape[0] // n,) + tuple(shape[1:])
        with dp_scope(DataParallelContext(rank(), n)):
            y = _dropout(torch.ones(local), rate, True, key)
        out["mask_rows"] = (y != 0).numpy()
    if "indivisible" in case:
        try:
            rows(np.zeros((case["indivisible"], 3), np.float32))
            out["indivisible"] = None
        except ValueError as e:
            out["indivisible"] = str(e)
    return out


def world_of_one(conf_json: str, params, epochs) -> dict:
    """The distributed model against the undistributed one in a world of
    one: the same bits."""
    plain = seq_model(conf_json, params)
    dp = seq_model(conf_json, params)
    distribute(dp)
    lp, ld = [], []
    for batches in epochs:
        for x, y in batches:
            plain.fit_batch(DataSet(x, y))
            dp.fit_batch(DataSet(x, y))
            lp.append(plain.score_value)
            ld.append(dp.score_value)
    return {"plain": table(plain), "dp": table(dp), "lp": lp, "ld": ld}


# -- tests/test_torch_zero.py -------------------------------------------------

def _opt_shapes(m) -> list:
    from deeplearning4j_tpu_torch.nn.updaters import state_leaves
    from deeplearning4j_tpu_torch.parallel.zero import unwrap_opt_state

    return [tuple(t.shape) for t in state_leaves(unwrap_opt_state(m.opt_state)[0])
            if isinstance(t, torch.Tensor)]


def zero_world(case: dict) -> dict:
    from deeplearning4j_tpu_torch.nn.updaters import state_leaves
    from deeplearning4j_tpu_torch.observe.metrics import registry
    from deeplearning4j_tpu_torch.parallel import zero as zmod
    from deeplearning4j_tpu_torch.runtime.flags import environment
    from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

    conf, epochs = case["conf"], case["epochs"]
    out = {}
    for stage in (0, 1, 2):
        m = seq_model(conf)
        distribute(m, zero=stage)
        if stage == 1:
            out["bytes_gauge"] = registry().gauge("dl4jtpu_opt_state_bytes").value(
                mode="sharded")
            out["bytes_1"] = zmod.opt_state_bytes_per_replica(m.opt_state)
            out["shapes_1"] = _opt_shapes(m)
            out["dims_1"] = list(m._zero_placement.dims)
        if stage == 0:
            out["bytes_0"] = zmod.opt_state_bytes_per_replica(m.opt_state)
        fit_epochs(m, epochs)
        out[f"zero{stage}"] = table(m)
        out[f"keys{stage}"] = [str(k) for k in m._step_fns]
        if stage == 2:
            out["grad_bytes_2"] = zmod.grad_state_bytes_per_replica(m)
            out["wrapped_2"] = zmod.is_wrapped(m.opt_state)
            out["acc_zero_2"] = all(float(a.abs().max()) == 0.0
                                    for a in m.opt_state["grad_accum"])
        if stage == 1:
            out["bytes_1_after"] = zmod.opt_state_bytes_per_replica(m.opt_state)
            c = registry().counter("dl4jtpu_update_seconds_total")
            before = c.value(mode="sharded")
            out["update_secs"] = zmod.measure_update_seconds(m, iters=2)
            out["update_counter"] = c.value(mode="sharded") - before
            # the zip of a ZeRO model: whole optimizer state, chief writes
            ModelSerializer.write_model_distributed(m, case["zip_out"])
            out["zero1_opt_full"] = [np.array(t) for t in state_leaves(
                m._zero_placement.gather_state(m.opt_state))
                if isinstance(t, torch.Tensor)]
            # re-distribute without zero: the placement goes, state whole
            distribute(m, zero=0)
            out["redist_placement"] = m._zero_placement is None
            out["redist_shapes"] = _opt_shapes(m)
    # grad_accum 2
    m = seq_model(conf)
    distribute(m, zero=2, grad_accum=2)
    fit_epochs(m, epochs)
    out["accum2"] = table(m)
    out["accum_keys"] = [str(k) for k in m._step_fns]
    m = seq_model(conf)
    distribute(m, zero=2, grad_accum=3)
    try:
        m.fit_batch(rank_batch(*epochs[0][0]))
        out["accum_indivisible"] = None
    except ValueError as e:
        out["accum_indivisible"] = str(e)
    # the env knob
    env = environment()
    prev = env.zero
    env.zero = 1
    try:
        m = seq_model(conf)
        distribute(m)
        out["env_placement"] = m._zero_placement is not None
        m2 = seq_model(conf)
        distribute(m2, zero=0)
        out["env_override"] = m2._zero_placement is None
    finally:
        env.zero = prev
    # clip_by_global_norm over slices
    cconf = case["clip_conf"]
    for stage in (0, 1):
        m = seq_model(cconf)
        distribute(m, zero=stage)
        fit_epochs(m, epochs)
        out[f"clip{stage}"] = table(m)
    # a JAX zip restored into a ZeRO world, then one more step
    m = seq_model(conf)
    distribute(m, zero=1)
    ModelSerializer.restore_into(m, case["jax_zip"])
    out["restored_iteration"] = m.iteration
    out["restored_shards"] = [np.array(t) for t in state_leaves(m.opt_state)
                              if isinstance(t, torch.Tensor)]
    m.fit_batch(rank_batch(*case["next_batch"]))
    out["restored_next"] = table(m)
    out["restored_next_loss"] = m.score_value
    out.update(_zero_guards(conf, epochs))
    out.update(_zero_recovery(case))
    return out


def _zero_guards(conf, epochs) -> dict:
    from deeplearning4j_tpu_torch.train.listeners import TrainingListener

    class Stasher(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score):
            self.stash = model.opt_state

    class ShardStasher(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score):
            # a view of one slice of Adam's first moment
            self.stash = model.opt_state[-1][0][1][0][:1]

    class Copier(TrainingListener):
        def iteration_done(self, model, iteration, epoch, score):
            from deeplearning4j_tpu_torch.models.model import tree_leaves

            self.snapshot = [np.array(t) for t in tree_leaves(model.opt_state)
                             if isinstance(t, torch.Tensor)]

    out = {}
    for name, cls in (("stash", Stasher), ("view", ShardStasher), ("copy", Copier)):
        m = seq_model(conf)
        distribute(m, zero=1)
        m.set_listeners(cls())
        try:
            m.fit([rank_batch(*b) for b in epochs[0]])
            out[f"guard_{name}"] = None
        except RuntimeError as e:
            out[f"guard_{name}"] = str(e)
    return out


def _zero_recovery(case) -> dict:
    """A rollback in a ZeRO world: every rank sees the same NaN score,
    rolls back from its store in place and trains on."""
    from deeplearning4j_tpu_torch.train.checkpoint import CheckpointStore
    from deeplearning4j_tpu_torch.train.recovery import RecoveryPolicy

    conf, epochs = case["conf"], case["epochs"]
    # the health listener's divergence report lands beside the stores
    os.environ["DL4JTPU_CRASH_DIR"] = os.path.join(case["store_dir"], "crash")
    m = seq_model(conf)
    distribute(m, zero=2)
    fit_epochs(m, [epochs[0][:1]])
    store = CheckpointStore(os.path.join(case["store_dir"], f"rank{rank()}"),
                            device="cpu")
    store.save(m)
    saved = table(m)
    live = [id(t) for t in m.opt_state["opt"][-1][0][1]]
    policy = RecoveryPolicy(store, skip_window=0).attach(m)
    x, y = epochs[0][1]
    m.fit([rank_batch(np.full_like(x, np.nan), y)])
    out = {"rollbacks": policy.rollbacks,
           "after_rollback": table(m),
           "saved": saved,
           "in_place": [id(t) for t in m.opt_state["opt"][-1][0][1]] == live,
           "still_wrapped": isinstance(m.opt_state, dict)}
    m.fit([rank_batch(*epochs[0][2])])
    out["rollback_next_loss"] = m.score_value
    return out


# -- tests/test_torch_compression.py ------------------------------------------

def compression_world(case: dict) -> dict:
    from deeplearning4j_tpu_torch.parallel.compression import (
        quantized_allreduce_tree,
        quantized_psum,
    )
    from deeplearning4j_tpu_torch.runtime import rng

    r = rank()
    out = {}
    shards = case["psum_shards"]
    x = torch.from_numpy(shards[r])
    out["psum"] = quantized_psum(x, key=rng.key(0))[0].numpy()
    acc = np.zeros(case["unbiased_shards"].shape[1], np.float64)
    xu = torch.from_numpy(case["unbiased_shards"][r])
    for s in range(case["unbiased_reps"]):
        acc += quantized_psum(xu, key=rng.key(s))[0].numpy()
    out["unbiased"] = acc / case["unbiased_reps"]
    g = torch.from_numpy(case["resid_shards"][r])
    synced, res = quantized_allreduce_tree([g], [torch.zeros_like(g)], key=rng.key(7))
    out["resid_synced"], out["resid"] = synced[0].numpy(), res[0].numpy()
    conf, epochs = case["conf"], case["epochs"]
    exact = seq_model(conf)
    distribute(exact)
    fit_epochs(exact, epochs)
    comp = seq_model(conf)
    distribute(comp, grad_compression="int8")
    out["comp_mode"] = comp._grad_compression
    out["comp_losses"] = fit_epochs(comp, epochs)
    out["exact_score"], out["comp_score"] = exact.score_value, comp.score_value
    out["comp_params"] = table(comp)
    learn = seq_model(conf)
    distribute(learn, grad_compression="int8")
    fit_epochs(learn, case["learn_epochs"])
    out["comp_acc"] = accuracy(learn, *case["eval"])
    # the JAX compressed step's first steps
    m = seq_model(conf)
    distribute(m, grad_compression="int8")
    out["first_losses"] = fit_epochs(m, [epochs[0][:3]])
    out["first_params"] = table(m)
    # a re-distribute without compression drops it
    distribute(m)
    out["cleared"] = m._grad_compression is None and m._grad_residual is None
    fit_epochs(m, [epochs[0][:1]])
    out["cleared_score"] = m.score_value
    # TBPTT refuses compression
    t = seq_model(case["tbptt_conf"])
    distribute(t, grad_compression="int8")
    try:
        t.fit_batch(rank_batch(*case["tbptt_batch"]))
        out["tbptt_refusal"] = None
    except ValueError as e:
        out["tbptt_refusal"] = str(e)
    return out


# -- tests/test_torch_distributed.py ------------------------------------------

def two_process_dp(conf_json: str, batches, zip_path: str) -> dict:
    from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

    m = seq_model(conf_json)
    distribute(m)
    for x, y in batches:
        m.fit_batch(rank_batch(x, y))
    ModelSerializer.write_model_distributed(m, zip_path)
    x = batches[0][0]
    return {"params": table(m), "iteration": m.iteration,
            "zip_seen": os.path.exists(zip_path),
            "fetched": distributed.fetch_global(rows(x)), "buckets": buckets()}


def buckets() -> dict:
    """The flat-bucket collectives on tensors of several shapes that
    differ by rank."""
    import torch

    r = rank()
    ts = [torch.full((2, 3), r + 1.0), torch.arange(4, dtype=torch.float64) * (r + 1),
          torch.tensor(r + 0.5)]
    summed = distributed.all_reduce_flat(ts)
    gathered = distributed.all_gather_flat([ts[0], ts[2].float()])
    own = [torch.full((3,), float(r)), torch.full((1, 2), 10.0 * r)]
    distributed.broadcast_flat(own, src=1)
    return {"summed": [(t.dtype, t.numpy().copy()) for t in summed],
            "gathered": [[t.numpy().copy() for t in part] for part in gathered],
            "broadcast": [t.numpy() for t in own]}


def fail_on_rank_one() -> None:
    if rank() == 1:
        raise ValueError("rank one fails on purpose")
    # rank 0 waits in a collective its peer never joins
    distributed.barrier()


def hang_on_rank_one() -> None:
    import time

    if rank() == 1:
        time.sleep(600)
    distributed.barrier()


# -- tests/test_torch_cuda_kernels.py (on the card) ---------------------------

def narrow_cnn_conf(bf16: bool):
    from deeplearning4j_tpu_torch.nn.activations import Activation
    from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import BatchNorm, Conv2D, Dense, OutputLayer
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        NeuralNetConfiguration,
    )
    from deeplearning4j_tpu_torch.nn.losses import Loss
    from deeplearning4j_tpu_torch.nn.updaters import Nesterovs

    return (NeuralNetConfiguration.builder().seed(11).updater(Nesterovs(0.01, 0.9))
            .bf16_compute(bf16).activation(Activation.RELU).list()
            .layer(Conv2D(n_out=16, kernel=(3, 3))).layer(BatchNorm())
            .layer(Dense(n_out=32, dropout_rate=0.25))
            .layer(OutputLayer(n_out=10, loss=Loss.MCXENT, activation=Activation.SOFTMAX))
            .set_input_type(InputType.convolutional(16, 16, 3)).build())


def narrow_batches(n: int, rows: int) -> list:
    g = np.random.default_rng(12)
    return [(g.normal(size=(rows, 16, 16, 3)).astype(np.float32),
             np.eye(10, dtype=np.float32)[g.integers(0, 10, rows)]) for _ in range(n)]


def _card_state(m) -> list:
    from deeplearning4j_tpu_torch.models.model import tree_leaves
    from deeplearning4j_tpu_torch.nn.updaters import state_leaves

    return ([t.detach().clone() for t in tree_leaves(m.params)]
            + [t.detach().clone() for t in tree_leaves(m.net_state)]
            + [t.detach().clone() if isinstance(t, torch.Tensor) else int(t)
               for t in state_leaves(m.opt_state)])


def _load_card_state(m, snap) -> None:
    from deeplearning4j_tpu_torch.models.model import tree_leaves
    from deeplearning4j_tpu_torch.nn.updaters import load_state_leaves

    p, s = tree_leaves(m.params), tree_leaves(m.net_state)
    with torch.no_grad():
        for dst, src in zip(p + s, snap):
            dst.copy_(src)
    m.opt_state = load_state_leaves(m.opt_state, snap[len(p) + len(s):])


def cuda_world_of_one() -> dict:
    """A world of one NCCL rank: the distributed model's captured steps
    against the undistributed model's, then against the same steps run
    eagerly from one snapshot."""
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel

    conf = narrow_cnn_conf(bf16=True)
    plain = SequentialModel(conf).init()
    dp = SequentialModel(conf).init()
    distribute(dp)
    batches = [DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())
               for x, y in narrow_batches(3, 32)]
    lp, ld = [], []
    for b in batches:
        plain.fit_batch(b)
        dp.fit_batch(b)
        lp.append(plain.score_value)
        ld.append(dp.score_value)
    gap = max(float((a - b).abs().max()) for a, b in
              zip(_card_state(plain)[:8], _card_state(dp)[:8]))
    snap = _card_state(dp)
    cap = []
    for b in batches[:2]:
        dp.fit_batch(b)
        cap.append(dp.score_value)
    after_cap = _card_state(dp)
    _load_card_state(dp, snap)
    dp.iteration -= 2
    dp.capture_steps = False
    eag = []
    for b in batches[:2]:
        dp.fit_batch(b)
        eag.append(dp.score_value)
    same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(after_cap, _card_state(dp)))
    return {"backend": distributed.backend_name(), "lp": lp, "ld": ld, "gap": gap,
            "cap": cap, "eag": eag, "same_state": same,
            "graphs": dp.compile_stats()["step_programs"]}


def cuda_gloo_pair() -> dict:
    """Two gloo ranks on one card, f32, 8 rows each; rank 0 also trains the
    undistributed model on the 16-row concatenation."""
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel

    conf = narrow_cnn_conf(bf16=False)
    dp = SequentialModel(conf).init()
    distribute(dp)
    batches = narrow_batches(3, 16)
    losses = []
    for x, y in batches:
        dp.fit_batch(DataSet(rows(x).cuda(), rows(y).cuda()))
        losses.append(dp.score_value)
    out = {"backend": distributed.backend_name(), "capture": dp.capture_steps,
           "losses": losses, "params": table(dp), "state": state(dp)}
    if rank() == 0:
        single = SequentialModel(conf).init()
        sl = []
        for x, y in batches:
            single.fit_batch(DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()))
            sl.append(single.score_value)
        out.update(single_losses=sl, single_params=table(single),
                   single_state=state(single))
    return out
