"""The port's planner (`parallel/planner.py`, ``distribute(auto=True)``)
against the JAX package's on `tests/test_planner.py`'s scenarios, the
same model on both sides (weights carried by name).

The port counts its step program on fake tensors (`observe/cost.py`
`analyze_signature`): matmuls by their FLOP formulas, every other op by
its bytes.  XLA's cost analysis also counts elementwise FLOPs and the
updater inside the step, so JAX's FLOPs are at least the port's, and
the prices differ by those terms; everything closed-form (the bubble,
the collectives, the hop, the update, the parameter and optimizer
bytes) is equal.
"""

import numpy as np
import pytest

import jax

import torch_pp_ranks as ranks
from deeplearning4j_tpu.models import SequentialModel
from deeplearning4j_tpu.nn import Adam
from deeplearning4j_tpu.nn.activations import Activation
from deeplearning4j_tpu.nn.conf import Dense, InputType, NeuralNetConfiguration, OutputLayer
from deeplearning4j_tpu.nn.losses import Loss
from deeplearning4j_tpu.parallel import plan as jax_plan
from deeplearning4j_tpu.parallel import PlanError as JaxPlanError
from deeplearning4j_tpu_torch.parallel import PlanError, plan
from deeplearning4j_tpu_torch.runtime import distributed

N_DEV = 8
IN = 64
CLOSED_FORM = ("bubble_fraction", "collective_seconds", "hop_penalty_seconds",
               "update_seconds")


def mlp_conf(hidden=(64, 32), n_out=8, seed=9):
    b = (NeuralNetConfiguration.builder().seed(seed).updater(Adam(1e-2))
         .activation(Activation.RELU).list())
    for h in hidden:
        b = b.layer(Dense(n_out=h))
    return (b.layer(OutputLayer(n_out=n_out, loss=Loss.MCXENT,
                                activation=Activation.SOFTMAX))
            .set_input_type(InputType.feed_forward(IN)).build())


def pair(conf):
    """The JAX model and the port's, from the same weights."""
    from deeplearning4j_tpu_torch.convert import params_from_jax
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel as TSeq
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        SequentialConfiguration,
    )

    jm = SequentialModel(conf).init()
    pm = TSeq(SequentialConfiguration.from_json(conf.to_json()), device="cpu").init()
    params_from_jax(jax.tree.map(np.asarray, jm.params), pm)
    return jm, pm


def verdicts(report):
    return [(c.label(), c.verdict) for c in report.candidates]


def hand_flops(hidden, n_out=8, b=64):
    """The step's products by hand: each layer's forward and weight
    gradient, and the input gradient of every layer but the first."""
    dims = [IN, *hidden, n_out]
    prods = [2 * b * a * c for a, c in zip(dims, dims[1:])]
    return 2 * sum(prods) + sum(prods[1:])


@pytest.mark.parametrize("hidden", [(64, 32), (16,), (256, 256)])
def test_candidates_verdicts_and_pick_are_jaxs(hidden):
    """The same candidate labels in the same order, the same verdicts,
    the same reasons, the same pick; every closed-form term and the
    parameter and optimizer bytes equal."""
    jm, pm = pair(mlp_conf(hidden=hidden))
    jr = jax_plan(jm, n_devices=N_DEV, batch_size=64)
    pr = plan(pm, n_devices=N_DEV, batch_size=64)
    assert verdicts(pr) == verdicts(jr)
    assert [c.reason for c in pr.candidates] == [c.reason for c in jr.candidates]
    assert pr.pick_candidate().label() == jr.pick_candidate().label()
    for key in ("params_bytes", "opt_state_bytes", "param_count"):
        assert pr.base[key] == jr.base[key], key
    jp = {c.label(): c for c in jr.priced}
    for c in pr.priced:
        for term in CLOSED_FORM:
            assert c.terms[term] == pytest.approx(jp[c.label()].terms[term], rel=1e-12)
    assert pr.signature == jr.signature and pr.batch_size == jr.batch_size == 64


@pytest.mark.parametrize("hidden", [(64, 32), (256, 256)])
def test_flops_are_the_products_by_hand(hidden):
    jm, pm = pair(mlp_conf(hidden=hidden))
    jr = jax_plan(jm, n_devices=N_DEV, batch_size=64)
    pr = plan(pm, n_devices=N_DEV, batch_size=64)
    assert pr.base["flops"] == hand_flops(hidden)
    assert jr.base["flops"] >= pr.base["flops"]
    assert pr.base["bytes_accessed"] > 0


def test_plan_runs_nothing_and_changes_nothing():
    """No kernel launch, no ``nvcc`` run, no capture, no dispatch of a
    registered program; the parameters, the optimizer state, the step
    count and the random stream are as they were."""
    import torch

    from deeplearning4j_tpu_torch.observe import cost
    from deeplearning4j_tpu_torch.runtime import compile_stats, kernels

    _, pm = pair(mlp_conf())
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    it, opt, cpu_rng = pm.iteration, pm.opt_state, torch.get_rng_state()
    launches, stats = kernels.launches(), compile_stats.snapshot()
    report = plan(pm, n_devices=N_DEV, batch_size=64)
    again = plan(pm, n_devices=N_DEV, batch_size=64)
    spent = compile_stats.snapshot() - stats
    assert kernels.launches() == launches
    assert spent.backend_compiles == 0 and spent.jit_cache_misses == 0
    assert all(r.dispatches == 0 for r in cost.registry().programs()
               if r.owner_ref() is pm)
    for k, v in pm.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert pm.iteration == it and pm.opt_state is opt
    assert torch.equal(torch.get_rng_state(), cpu_rng)
    assert report.priced and report.pick is not None
    # JAX's budget for a candidate set, once the first plan has loaded
    # the fake-tensor machinery
    assert again.plan_seconds < 2.0


def test_an_abstract_run_counts_a_kernel_on_the_card_without_launching_it():
    """Fake CUDA tensors (the analysis's) take the plain version: B1 is
    counted by its ``*_work`` function and nothing is launched, so a
    planner on the card runs no kernel and no ``nvcc``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from deeplearning4j_tpu_torch.observe.cost import _OpCounter
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.runtime import kernels

    assert kernels.route(torch.device("cuda")) == "kernel"
    launched = kernels.launches()
    counter = _OpCounter()
    with FakeTensorMode():
        assert kernels.route(torch.device("cuda")) == "plain"
        q = torch.empty((8, 256, 64), device="cuda")

        # the forward's wrapper alone: a CPU build of torch runs not every
        # op on fake CUDA tensors (the backward's plain version, an
        # autograd thread for the device); the card's phase runs the step
        out, lse = counter.run(lambda q: fa.flash_fwd(q, q, q, causal=True), (q,))
    assert out.shape == q.shape and out.device.type == "cuda" and lse.shape == (8, 256)
    want = fa.flash_fwd_work(8, 256, 64, True, 4)
    assert {k: v[1] for k, v in counter.kernels.items()} == {n: f for n, f, _ in want}
    assert all(v[0] == 1 for v in counter.kernels.values())
    assert kernels.launches() == launched


def test_analysis_failure_flows_into_rejection_reasons():
    from deeplearning4j_tpu_torch.observe import cost

    ana = cost.analyze_signature(object(), ())
    assert not ana.ok and "lower" in ana.reason
    _, pm = pair(mlp_conf())
    pm._step_program = None
    with pytest.raises(PlanError) as ei:
        plan(pm, n_devices=N_DEV, batch_size=64)
    rep = ei.value.report
    assert rep is not None and all(c.verdict == "rejected" for c in rep.candidates)
    assert any("analysis" in (c.reason or "") for c in rep.candidates)


def test_tight_memory_cap_forces_zero_stage():
    """JAX `TestKnownScenarioPicks`: a cap between the replicated and the
    sharded footprints leaves zero >= 1 candidates, gated with the
    arithmetic in the reason, on both sides."""
    jm, pm = pair(mlp_conf(hidden=(256, 256)))
    for fn, m in ((jax_plan, jm), (plan, pm)):
        unlimited = fn(m, n_devices=N_DEV, batch_size=64)
        full = max(c.mem_bytes_per_replica for c in unlimited.priced
                   if (c.config.zero or 0) == 0)
        sharded_min = min(c.mem_bytes_per_replica for c in unlimited.priced
                          if (c.config.zero or 0) >= 1)
        report = fn(m, n_devices=N_DEV, batch_size=64,
                    memory_cap_bytes=(full + sharded_min) // 2)
        assert (report.pick.zero or 0) >= 1
        gated = [c for c in report.rejected if "memory infeasible" in (c.reason or "")]
        assert gated and all("cap" in c.reason for c in gated)


def test_infeasible_everywhere_raises_a_plan_error_listing_every_reason():
    jm, pm = pair(mlp_conf())
    with pytest.raises(JaxPlanError) as je:
        jax_plan(jm, n_devices=N_DEV, batch_size=64, memory_cap_bytes=1024)
    with pytest.raises(PlanError) as pe:
        plan(pm, n_devices=N_DEV, batch_size=64, memory_cap_bytes=1024)
    msg = str(pe.value)
    assert "memory infeasible" in msg and "data=8" in msg and "data=1" in msg
    assert pe.value.report.pick is None
    jl = [line.split(":")[0] for line in str(je.value).splitlines()[1:]]
    pl = [line.split(":")[0] for line in msg.splitlines()[1:]]
    assert pl == jl


def test_batch_divisibility_and_redundant_zero():
    _, pm = pair(mlp_conf())
    report = plan(pm, n_devices=N_DEV, batch_size=60)
    bad = [c for c in report.rejected if "not divisible" in (c.reason or "")]
    assert any(c.config.data == 8 for c in bad)
    report = plan(pm, n_devices=N_DEV, batch_size=64)
    assert not any(c.config.data == 1 and (c.config.zero or 0) >= 1 for c in report.priced)
    assert any(c.devices_used < N_DEV for c in report.priced)


def test_batch_example_fixes_signature():
    from deeplearning4j_tpu.data import DataSet

    jm, pm = pair(mlp_conf())
    rng = np.random.default_rng(0)
    ds = DataSet(rng.normal(size=(96, IN)).astype(np.float32),
                 np.eye(8, dtype=np.float32)[rng.integers(0, 8, 96)])
    jr, pr = jax_plan(jm, n_devices=N_DEV, batch=ds), plan(pm, n_devices=N_DEV, batch=ds)
    assert pr.batch_size == jr.batch_size == 96
    assert pr.signature == jr.signature
    assert verdicts(pr) == verdicts(jr)


def test_report_surface_and_metric_families():
    from deeplearning4j_tpu_torch.observe.metrics import registry
    from deeplearning4j_tpu_torch.parallel.planner import last_report

    _, pm = pair(mlp_conf())
    reg = registry()
    c = reg.counter("dl4jtpu_plan_candidates_total")
    before = c.value(verdict="priced")
    report = plan(pm, n_devices=N_DEV, batch_size=64)
    assert c.value(verdict="priced") == before + len(report.priced)
    assert reg.gauge("dl4jtpu_plan_seconds").value() > 0
    assert reg.gauge("dl4jtpu_plan_predicted_step_seconds").value() == pytest.approx(
        report.pick_candidate().predicted_step_seconds)
    d = report.as_dict()
    assert d["schema"] == "plan-report/1" and d["pick"]["verdict"] == "priced"
    assert all(set(x) >= {"label", "verdict", "predicted_step_seconds"}
               for x in d["candidates"])
    assert all(x["terms"].get("compute_seconds") is not None
               for x in d["candidates"] if x["verdict"] == "priced")
    assert last_report() is report
    s = report.summary()
    assert "<-- pick" in s and "rejected" in s


def test_flagship_plan_prices_the_pipe_axis_as_jax_does():
    """The narrow flagship on two ranks: the same candidates and
    verdicts (pipe=2 legal), the same bubble for pipe=2, and both
    FLOP counts hold the attention and vocabulary products."""
    from deeplearning4j_tpu.zoo.transformer import TransformerEncoder

    conf = TransformerEncoder(vocab_size=16, d_model=16, n_heads=2, n_layers=4,
                              causal=True, seed=11).conf()
    jm, pm = pair(conf)
    ids = np.zeros((8, 8), np.float32)
    y = np.zeros((8, 8, 16), np.float32)
    jr, pr = jax_plan(jm, n_devices=2, batch=(ids, y)), plan(pm, n_devices=2, batch=(ids, y))
    assert verdicts(pr) == verdicts(jr)
    assert [c.reason for c in pr.candidates] == [c.reason for c in jr.candidates]
    pp = [c for c in pr.priced if c.config.pipe == 2]
    assert pp and pp[0].terms["bubble_fraction"] == pytest.approx(1 / 5)
    assert jr.base["flops"] >= pr.base["flops"] > 0


def test_pipe_beside_seq_is_a_recorded_port_rejection():
    """Four ranks: JAX prices pipe=2 with seq=2, but its step cannot run
    it (ROADMAP C29); the port rejects it with that reason, and every
    other verdict is JAX's."""
    from deeplearning4j_tpu.zoo.transformer import TransformerEncoder

    conf = TransformerEncoder(vocab_size=16, d_model=16, n_heads=2, n_layers=4,
                              causal=True, seed=11).conf()
    jm, pm = pair(conf)
    batch = (np.zeros((8, 8), np.float32), np.zeros((8, 8, 16), np.float32))
    jr, pr = jax_plan(jm, n_devices=4, batch=batch), plan(pm, n_devices=4, batch=batch)
    for jc, pc in zip(jr.candidates, pr.candidates):
        assert jc.label() == pc.label()
        if pc.config.pipe > 1 and pc.config.seq > 1:
            assert pc.verdict == "rejected" and "ROADMAP C29" in pc.reason
        else:
            assert pc.verdict == jc.verdict, pc.label()


# -- distribute(auto=True) in worlds --------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jm = SequentialModel(mlp_conf(hidden=(16,))).init()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, IN)).astype(np.float32)
    y = np.eye(8, dtype=np.float32)[rng.integers(0, 8, 64)]
    return jm.conf.to_json(), jax.tree.map(np.asarray, jm.params), x, y


def test_auto_installs_a_pick_of_the_worlds_width(tiny):
    """The tiny model's pick is narrow DP (JAX's too); in a world of its
    width it is installed and trains, and the env knob asks the planner
    when no config is given."""
    (r,) = distributed.spawn(ranks.plan_world, 1, tiny, platform="cpu", timeout=300)
    assert r["raised"] is None and r["pick"] == "data=1 zero=0"
    assert r["mesh"] == {"data": 1} and np.isfinite(r["score"])
    assert r["env_pick"] == "data=1 zero=0"


def test_auto_in_a_wider_world_raises_c28(tiny):
    """ROADMAP C28: the port's mesh spans the whole world, so a pick
    narrower than a world of two raises, naming the pick and its width;
    a ZeRO-2 model's re-plan prices the fresh optimizer state."""
    for r in distributed.spawn(ranks.plan_world, 2, tiny, platform="cpu", timeout=300):
        assert r["raised"] is not None and "ROADMAP C28" in r["raised"]
        assert "data=1 zero=0" in r["raised"] and "uses 1 of the 2 ranks" in r["raised"]
        assert r["zero2_opt_bytes"] == r["fresh_opt_bytes"]


def test_auto_with_an_explicit_config_or_mesh_raises():
    from deeplearning4j_tpu_torch.parallel import ParallelConfig, distribute
    from deeplearning4j_tpu_torch.runtime.mesh import MeshSpec, make_mesh

    _, pm = pair(mlp_conf())
    with pytest.raises(ValueError, match="auto"):
        distribute(pm, ParallelConfig(data=2), auto=True)
    with pytest.raises(ValueError, match="mesh"):
        distribute(pm, auto=True, mesh=make_mesh(MeshSpec.data_parallel()))
    assert not distributed.is_initialized()
