"""Self-healing training in the port on the CPU (`train/recovery.py`,
`data/quarantine.py`, `train/checkpoint.py` `CheckpointStore`, the fit's
step watchdog), against the JAX package.

- bench.py's chaos drill (``bench_chaos``: its configuration, warm-up,
  save cadence and seeded fault plan: a ``device.sync`` hang, a decode
  failure, a NaN batch) runs through both packages: the recovery
  ledgers are equal (final iteration, rollbacks, quarantined,
  ``lr_scale``, steps to recover, batches skipped) and the final
  parameters agree within 1e-5 of their scale.
- The grouped chokepoint (``steps_per_execution`` 4): a NaN batch inside
  a group rolls back, in both packages alike.
- `CheckpointStore` pinning, ``gc`` and ``latest_valid`` over a
  truncated newest zip (``checkpoint.write:truncate``); a ``kill`` at
  ``checkpoint.fsync`` leaves only a ``.tmp`` orphan, which gc removes.
- A rollback copies the checkpoint into the live tensors in place: the
  parameters equal the checkpoint's bit for bit and no tensor object
  changes; the learning rate scales through the staged step values.
- The JAX package's recovery cases (`tests/test_recovery.py`, all but
  the elastic supervisor's, which is ROADMAP A11's) on the port.  A
  test that waits on the watchdog's monitor thread runs its fit under a
  deadline of its own (`_bounded`) and asserts on events, not seconds.
"""

import glob
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.runtime import faults as jfaults
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterator import DataSetIterator
from deeplearning4j_tpu_torch.models.model import tree_leaves
from deeplearning4j_tpu_torch.models.sequential import SequentialModel
from deeplearning4j_tpu_torch.nn.conf.input_type import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import Dense, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
    NeuralNetConfiguration,
)
from deeplearning4j_tpu_torch.observe.metrics import registry
from deeplearning4j_tpu_torch.runtime import faults
from deeplearning4j_tpu_torch.runtime.flags import environment
from deeplearning4j_tpu_torch.runtime.watchdog import STAGES, StepWatchdog
from deeplearning4j_tpu_torch.train.checkpoint import (
    CheckpointStore,
    ModelSerializer,
)
from deeplearning4j_tpu_torch.train.listeners import TrainingListener
from deeplearning4j_tpu_torch.train.recovery import RecoveryPolicy, _LrScaledTx

pytestmark = pytest.mark.faults

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    jfaults.disarm()


def _conf(seed=3, n_in=4, n_out=2, hidden=8):
    return (NeuralNetConfiguration.builder().seed(seed).list()
            .layer(Dense(n_out=hidden)).layer(OutputLayer(n_out=n_out))
            .set_input_type(InputType.feed_forward(n_in)).build())


def _model(seed=3, n_in=4, n_out=2):
    return SequentialModel(_conf(seed, n_in, n_out), device="cpu").init()


def _feed(n=10, batch=8, n_in=4, n_out=2, seed=0, jax_feed=False):
    """``n`` seeded batches; ``jax_feed``: the JAX package's iterator and
    `DataSet` classes, the same arrays."""
    base, cls = DataSetIterator, DataSet
    if jax_feed:
        from deeplearning4j_tpu.data.dataset import DataSet as cls
        from deeplearning4j_tpu.data.iterator import DataSetIterator as base

    class Feed(base):
        def reset(self):
            pass

        def __iter__(self):
            rng = np.random.default_rng(seed)
            for _ in range(n):
                x = rng.normal(size=(batch, n_in)).astype(np.float32)
                y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, batch)]
                yield cls(x, y)

    return Feed()


def _saver(store, every=4, base=TrainingListener):
    class Saver(base):
        def iteration_done(self, model, iteration, epoch, score):
            if iteration and iteration % every == 0:
                store.save(model, step=iteration)

    return Saver()


def _counter(name, **labels):
    return registry().counter(name).value(**labels)


def _bounded(fn, secs=120.0):
    """Run ``fn`` on a thread under a deadline of its own: a wedged fit
    fails this test instead of the run."""
    out = {}

    def run():
        try:
            fn()
        except BaseException as e:       # re-raised on the test's thread
            out["exc"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(secs)
    if t.is_alive():
        pytest.fail(f"the fit did not finish within {secs} s")
    if "exc" in out:
        raise out["exc"]


# -- bench.py's chaos drill through both packages ----------------------------------

PLAN = ("device.sync:delay:nth=6,secs=0.4;"
        "data.decode:raise:nth=10,exc=runtime;"
        "data.decode:corrupt:nth=16")


def _ledger(model, policy, warmup_iters, total):
    rb = next((e for e in policy.events if e["kind"] == "rollback"), None)
    return {
        "final_iteration": int(model.iteration),
        "rollbacks": policy.rollbacks,
        "quarantined": policy.quarantined,
        "lr_scale": policy.lr_scale,
        "steps_to_recover": (rb["from_iteration"] - rb["restored_iteration"]
                             + rb["skip_window"]) if rb else None,
        "batches_skipped": sum(e["kind"] == "batch_skipped" for e in policy.events),
        "recovered_step_fraction": round((model.iteration - warmup_iters) / total, 3),
    }


def _chaos_jax(tmp):
    from deeplearning4j_tpu.models import SequentialModel as JaxSM
    from deeplearning4j_tpu.nn.conf import (
        Dense as JDense, InputType as JIT, NeuralNetConfiguration as JNNC,
        OutputLayer as JOut,
    )
    from deeplearning4j_tpu.runtime.flags import environment as jenv
    from deeplearning4j_tpu.train.checkpoint import CheckpointStore as JStore
    from deeplearning4j_tpu.train.listeners import TrainingListener as JTL
    from deeplearning4j_tpu.train.recovery import RecoveryPolicy as JPolicy

    conf = (JNNC.builder().seed(7).list().layer(JDense(n_out=32))
            .layer(JOut(n_out=4)).set_input_type(JIT.feed_forward(16)).build())
    model = JaxSM(conf).init()
    store = JStore(os.path.join(tmp, "jck"), keep_last=3)
    model.add_listener(_saver(store, base=JTL))
    policy = JPolicy(store, skip_window=2,
                     quarantine_dir=os.path.join(tmp, "jq")).attach(model)
    env = jenv()
    floor = env.watchdog_floor_s
    env.watchdog_floor_s = 0.06
    try:
        model.fit(_feed(16, 16, 16, 4, seed=5, jax_feed=True), epochs=1)
        warm = int(model.iteration)
        jfaults.arm(PLAN)
        model.fit(_feed(28, 16, 16, 4, seed=11, jax_feed=True), epochs=1)
    finally:
        jfaults.disarm()
        env.watchdog_floor_s = floor
    return model, policy, warm


def _chaos_port(tmp, conf_json):
    from deeplearning4j_tpu_torch.nn.conf.neural_net_configuration import (
        SequentialConfiguration,
    )

    model = SequentialModel(SequentialConfiguration.from_json(conf_json),
                            device="cpu").init()
    store = CheckpointStore(os.path.join(tmp, "pck"), keep_last=3, device="cpu")
    model.add_listener(_saver(store))
    policy = RecoveryPolicy(store, skip_window=2,
                            quarantine_dir=os.path.join(tmp, "pq")).attach(model)
    env = environment()
    floor = env.watchdog_floor_s
    env.watchdog_floor_s = 0.06
    try:
        model.fit(_feed(16, 16, 16, 4, seed=5), epochs=1)
        warm = int(model.iteration)
        faults.arm(PLAN)
        model.fit(_feed(28, 16, 16, 4, seed=11), epochs=1)
    finally:
        faults.disarm()
        env.watchdog_floor_s = floor
    return model, policy, warm


def test_the_chaos_drill_gives_the_jax_packages_ledger(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path / "crash"))
    holder = {}

    def run():
        jm, jp, jwarm = _chaos_jax(str(tmp_path))
        pm, pp, pwarm = _chaos_port(str(tmp_path), jm.conf.to_json())
        holder.update(j=(jm, jp, jwarm), p=(pm, pp, pwarm))

    _bounded(run, 240)
    jm, jp, jwarm = holder["j"]
    pm, pp, pwarm = holder["p"]
    jl, pl = _ledger(jm, jp, jwarm, 28), _ledger(pm, pp, pwarm, 28)
    assert pl == jl, (pl, jl)
    assert pl["rollbacks"] == 1 and pl["quarantined"] == 1 and pl["lr_scale"] == 0.5
    for a, b in zip(tree_leaves(pm.params), jax.tree.leaves(jm.params)):
        a, b = a.detach().numpy().astype(np.float64), np.asarray(b, np.float64)
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0)
    assert abs(pm.score_value - float(jm.score_value)) <= 1e-5


def test_a_grouped_fit_recovers_as_the_jax_package_does(tmp_path, monkeypatch):
    """steps_per_execution 4: the NaN batch's group rolls back, the
    policy's ledger and the final parameters follow the JAX model's."""
    from deeplearning4j_tpu.models import SequentialModel as JaxSM
    from deeplearning4j_tpu.nn.conf.neural_net_configuration import (
        SequentialConfiguration as JSC,
    )
    from deeplearning4j_tpu.train.checkpoint import CheckpointStore as JStore
    from deeplearning4j_tpu.train.listeners import TrainingListener as JTL
    from deeplearning4j_tpu.train.recovery import RecoveryPolicy as JPolicy

    monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path / "crash"))
    pm = _model()
    jm = JaxSM(JSC.from_json(pm.conf.to_json())).init()
    ps = CheckpointStore(str(tmp_path / "p"), keep_last=3, device="cpu")
    js = JStore(str(tmp_path / "j"), keep_last=3)
    pm.add_listener(_saver(ps))
    jm.add_listener(_saver(js, base=JTL))
    pp = RecoveryPolicy(ps, skip_window=1).attach(pm)
    jp = JPolicy(js, skip_window=1).attach(jm)
    faults.arm("data.decode:corrupt:nth=10")
    jfaults.arm("data.decode:corrupt:nth=10")
    pm.fit(_feed(20), epochs=1, steps_per_execution=4)
    jm.fit(_feed(20, jax_feed=True), epochs=1, steps_per_execution=4)
    assert _ledger(pm, pp, 0, 20) == _ledger(jm, jp, 0, 20)
    assert pp.rollbacks == 1 and np.isfinite(pm.score_value)
    for a, b in zip(tree_leaves(pm.params), jax.tree.leaves(jm.params)):
        a, b = a.detach().numpy().astype(np.float64), np.asarray(b, np.float64)
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0)


def test_a_rollback_installs_in_place_and_scales_the_staged_rate(tmp_path,
                                                                  monkeypatch):
    monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
    m = _model()
    store = CheckpointStore(str(tmp_path / "ck"), keep_last=3, device="cpu")
    m.add_listener(_saver(store))
    policy = RecoveryPolicy(store, skip_window=0).attach(m)
    m.fit(_feed(4), epochs=1)
    ids = [id(t) for t in tree_leaves(m.params)]
    ckpt = ModelSerializer.restore(store.path_for(4), device="cpu")
    vals = m._tx.values(m.opt_state)
    faults.arm("data.decode:corrupt:nth=2")
    m.fit(_feed(2, seed=1), epochs=1)       # the NaN step diverges, rolls back
    faults.disarm()
    assert policy.rollbacks == 1 and m.iteration == 4
    assert [id(t) for t in tree_leaves(m.params)] == ids
    for a, b in zip(tree_leaves(m.params), tree_leaves(ckpt.params)):
        assert torch.equal(a.detach(), b.detach())
    assert isinstance(m._tx, _LrScaledTx) and not m._tx.recapture
    scaled = m._tx.values(m.opt_state)
    assert scaled[-1] == np.float32(vals[-1]) * np.float32(0.5)
    assert scaled[:-1] == vals[:-1]


# -- CheckpointStore ---------------------------------------------------------------

def test_latest_valid_skips_a_truncated_newest_zip_and_gc_keeps_pins(tmp_path):
    store = CheckpointStore(str(tmp_path), keep_last=2, device="cpu")
    m = _model()
    store.save(m, step=1)
    m.fit_batch(next(iter(_feed(1))))
    store.save(m, step=2)
    before = _counter("dl4jtpu_ckpt_verify_failures_total", reason="corrupt")
    faults.arm("checkpoint.write:truncate:nth=1")
    store.save(m, step=3)
    faults.disarm()
    assert store.all_steps() == [2, 3]
    entry = store.latest_valid()
    assert entry["step"] == 2 and entry["meta"]["iteration"] == 1
    assert _counter("dl4jtpu_ckpt_verify_failures_total", reason="corrupt") > before
    back = store.restore_latest()
    for a, b in zip(tree_leaves(back.params), tree_leaves(m.params)):
        assert torch.equal(a.detach(), b.detach())
    store.pin(2)
    for step in (4, 5):
        store.save(m, step=step)
    assert store.all_steps() == [2, 4, 5]
    store.unpin(2)
    store.gc()
    assert store.all_steps() == [4, 5]


def test_a_kill_at_fsync_leaves_only_a_tmp_orphan(tmp_path, monkeypatch):
    store = CheckpointStore(str(tmp_path), keep_last=2, device="cpu")
    m = _model()
    store.save(m, step=1)

    def killed(site):
        if site == "checkpoint.fsync":
            raise KeyboardInterrupt("killed mid-write")

    monkeypatch.setattr(faults, "maybe_fail", killed)
    with pytest.raises(KeyboardInterrupt):
        store.save(m, step=2)
    monkeypatch.undo()
    assert store.all_steps() == [1]
    assert glob.glob(str(tmp_path / "*.tmp"))
    store.gc()
    assert not glob.glob(str(tmp_path / "*.tmp"))
    assert store.latest_valid()["step"] == 1


# -- the JAX package's cases: StepWatchdog (fake clock, no monitor thread) ----------

class TestStepWatchdogUnit:
    def _wd(self, **kw):
        self.now = [0.0]
        kw.setdefault("clock", lambda: self.now[0])
        kw.setdefault("threaded", False)
        return StepWatchdog(**kw)

    def test_deadline_is_cold_floor_without_ewma_then_k_times_ewma(self):
        wd = self._wd(floor_s=1.0, cold_floor_s=100.0, k=10.0)
        assert wd.deadline_s() == 100.0
        wd.arm(0)
        self.now[0] = 2.0
        wd.disarm(2.0)
        assert wd.ewma == 2.0
        assert wd.deadline_s() == 20.0
        wd.arm(1)
        self.now[0] = 2.1
        wd.disarm(0.0)
        assert wd.deadline_s() == max(1.0, 10.0 * wd.ewma)

    def test_failed_steps_do_not_feed_the_ewma(self):
        wd = self._wd()
        wd.arm(0)
        wd.disarm(None)
        assert wd.ewma is None

    def test_escalation_ladder_warn_dump_abort(self, tmp_path, monkeypatch):
        monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
        aborts = []
        wd = self._wd(floor_s=1.0, cold_floor_s=1.0, k=10.0, dump_after=2.0,
                      abort_after=3.0, abort=aborts.append)
        wd.arm(7, n_steps=1)
        wd.poll()
        assert wd.events == []
        self.now[0] = 1.01
        wd.poll()
        assert [e["stage"] for e in wd.events] == ["warn"]
        self.now[0] = 2.01
        wd.poll()
        assert [e["stage"] for e in wd.events] == ["warn", "stack_dump"]
        assert wd.report_paths and os.path.exists(wd.report_paths[0])
        with open(wd.report_paths[0]) as f:
            text = f.read()
        assert "threads (" in text and "iteration: 7" in text
        self.now[0] = 3.01
        wd.poll()
        assert [e["stage"] for e in wd.events] == list(STAGES)
        assert aborts and aborts[0]["iteration"] == 7

    def test_escalated_steps_do_not_feed_the_ewma(self):
        wd = self._wd(floor_s=1.0, cold_floor_s=1.0)
        wd.arm(0)
        self.now[0] = 1.01
        wd.poll()
        assert [e["stage"] for e in wd.events] == ["warn"]
        self.now[0] = 1.2
        wd.disarm(1.2)
        assert wd.ewma is None

    def test_disarm_cancels_pending_escalation(self):
        aborts = []
        wd = self._wd(floor_s=1.0, cold_floor_s=1.0, abort=aborts.append)
        wd.arm(0)
        wd.disarm(0.5)
        self.now[0] = 100.0
        wd.poll()
        assert wd.events == [] and not aborts

    def test_raising_abort_does_not_kill_the_shared_monitor(self, tmp_path,
                                                            monkeypatch):
        import sys

        monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))

        def bad_abort(event):
            sys.exit(25)

        wd = StepWatchdog(floor_s=0.02, cold_floor_s=0.02, dump_after=1.5,
                          abort_after=2.0, abort=bad_abort)
        wd.arm(0)
        deadline = time.monotonic() + 30.0
        while not wd.events or wd.events[-1]["stage"] != "abort":
            assert time.monotonic() < deadline, wd.events
            time.sleep(0.01)
        wd.disarm(None)
        assert wd._mon.is_alive()
        wd2 = StepWatchdog(floor_s=0.02, cold_floor_s=0.02)
        assert wd2._mon is wd._mon
        wd2.arm(1)
        deadline = time.monotonic() + 30.0
        while not wd2.events:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        wd2.disarm(None)

    def test_grouped_programs_scale_the_deadline_by_n_steps(self):
        wd = self._wd(floor_s=0.1, cold_floor_s=0.1, k=10.0)
        wd.arm(0)
        self.now[0] = 0.4
        wd.disarm(0.4)
        wd.arm(1, n_steps=8)
        self.now[0] = 20.0
        wd.poll()
        assert wd.events == []
        wd.disarm(None)


# -- hang injection through the real fit loop ----------------------------------------

class TestWatchdogHangInjection:
    def test_injected_device_sync_hang_fires_within_deadline(self, tmp_path,
                                                             monkeypatch):
        """A ``device.sync`` delay 40 times the floor: the watchdog's
        monitor warns and dumps the stacks while the step is wedged."""
        monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
        m = _model()
        m._watchdog = StepWatchdog(floor_s=0.05, cold_floor_s=0.05, k=10.0)
        warns_before = _counter("dl4jtpu_watchdog_stalls_total", stage="warn")
        faults.arm("device.sync:delay:nth=2,secs=2.0")
        _bounded(lambda: m.fit(_feed(4), epochs=1))
        faults.disarm()
        wd = m._watchdog
        # the wedged step (the second: iteration 1 when it was armed)
        stages = {e["stage"] for e in wd.events if e["iteration"] == 1}
        assert {"warn", "stack_dump"} <= stages
        reports = glob.glob(str(tmp_path / "dl4jtpu-hang-report-*"))
        assert reports and wd.report_paths
        with open(reports[0]) as f:
            text = f.read()
        assert "maybe_fail" in text or "sync" in text
        assert _counter("dl4jtpu_watchdog_stalls_total", stage="warn") >= warns_before + 1
        assert m.iteration == 4

    def test_fit_with_empty_plan_leaves_watchdog_silent(self):
        m = _model()
        m.fit(_feed(6), epochs=1)
        assert m._watchdog is not None
        assert m._watchdog.events == []
        assert m._watchdog.ewma is not None

    def test_the_environment_sets_the_fit_watchdog(self, monkeypatch):
        from deeplearning4j_tpu_torch.runtime.flags import Environment

        monkeypatch.setenv("DL4J_TPU_WATCHDOG", "0")
        monkeypatch.setenv("DL4J_TPU_WATCHDOG_FLOOR", "3.5")
        monkeypatch.setenv("DL4J_TPU_WATCHDOG_K", "4")
        env = Environment.from_env()
        assert (env.watchdog_enabled, env.watchdog_floor_s, env.watchdog_k) == (
            False, 3.5, 4.0)
        live = environment()
        saved = (live.watchdog_enabled, live.watchdog_floor_s, live.watchdog_k)
        try:
            live.watchdog_enabled = False
            m = _model()
            m.fit(_feed(2), epochs=1)
            assert m._watchdog is None
            live.watchdog_enabled, live.watchdog_floor_s, live.watchdog_k = True, 3.5, 4.0
            m.fit(_feed(2), epochs=1)
            assert (m._watchdog.floor_s, m._watchdog.k) == (3.5, 4.0)
        finally:
            live.watchdog_enabled, live.watchdog_floor_s, live.watchdog_k = saved


# -- the quarantine store ------------------------------------------------------------

class TestQuarantineStore:
    def test_roundtrip_bytes_and_metadata(self, tmp_path):
        from deeplearning4j_tpu_torch.data.quarantine import QuarantineStore

        q = QuarantineStore(str(tmp_path), cap=4)
        ds = DataSet(np.full((2, 3), np.nan, np.float32), np.ones((2, 2), np.float32))
        path = q.put("nonfinite_input", batch=ds)
        assert path and os.path.exists(path)
        [rec] = q.entries()
        assert rec["reason"] == "nonfinite_input" and rec["has_bytes"]
        loaded = np.load(path.replace(".json", ".npz"))
        assert np.isnan(loaded["features"]).all()
        assert loaded["labels"].shape == (2, 2)

    def test_cap_bounds_disk_and_survives_restart(self, tmp_path):
        from deeplearning4j_tpu_torch.data.quarantine import QuarantineStore

        q = QuarantineStore(str(tmp_path), cap=2)
        assert q.put("decode_error", error=ValueError("x"))
        assert q.put("decode_error", error=ValueError("y"))
        assert q.put("decode_error") is None
        q2 = QuarantineStore(str(tmp_path), cap=2)
        assert q2.full and q2.put("decode_error") is None
        assert len(q2.entries()) == 2

    def test_a_tensor_batch_is_written_from_the_host(self, tmp_path):
        from deeplearning4j_tpu_torch.data.quarantine import QuarantineStore

        q = QuarantineStore(str(tmp_path), cap=2)
        ds = DataSet(torch.arange(6.0).reshape(2, 3), torch.ones(2, 2))
        path = q.put("decode_error", batch=ds)
        np.testing.assert_array_equal(np.load(path.replace(".json", ".npz"))[
            "features"], np.arange(6.0, dtype=np.float32).reshape(2, 3))


# -- checkpoint pinning ---------------------------------------------------------------

class TestCheckpointPinning:
    def test_gc_never_collects_the_pinned_rollback_target(self, tmp_path):
        store = CheckpointStore(str(tmp_path), keep_last=2)
        m = _model()
        for step in (1, 2, 3, 4, 5):
            store.save(m, step=step)
        assert store.all_steps() == [4, 5]
        store.pin(4)
        for step in (6, 7, 8):
            store.save(m, step=step)
        assert store.all_steps() == [4, 7, 8]
        store.unpin(4)
        store.gc()
        assert store.all_steps() == [7, 8]

    def test_policy_pins_its_rollback_target_through_rotation(self, tmp_path):
        store = CheckpointStore(str(tmp_path / "ck"), keep_last=1)
        m = _model()
        store.save(m, step=2)
        policy = RecoveryPolicy(store).attach(m)
        assert store.pinned_steps() == {2}
        store.save(m, step=3)
        assert store.pinned_steps() == {3}
        faults.arm("checkpoint.write:truncate:every=1")
        try:
            for step in (4, 5):
                store.save(m, step=step)
        finally:
            faults.disarm()
        assert store.pinned_steps() == {3}
        assert 3 in store.all_steps()
        entry = store.latest_valid()
        assert entry is not None and entry["step"] == 3
        policy.detach(m)
        store.gc()
        assert 3 not in store.all_steps()


# -- divergence -> rollback + LR backoff + skip window -----------------------------------

class TestRollback:
    def _healing_model(self, tmp_path, **policy_kw):
        m = _model()
        store = CheckpointStore(str(tmp_path / "ck"), keep_last=3, device="cpu")
        m.add_listener(_saver(store, every=4))
        policy = RecoveryPolicy(store, quarantine_dir=str(tmp_path / "q"),
                                **policy_kw).attach(m)
        return m, store, policy

    def test_nan_step_rolls_back_with_lr_backoff_and_finishes_finite(
            self, tmp_path, monkeypatch):
        monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
        m, store, policy = self._healing_model(tmp_path, skip_window=2)
        rb_before = _counter("dl4jtpu_recovery_events_total", kind="rollback")
        faults.arm("data.decode:corrupt:nth=10")
        m.fit(_feed(16), epochs=1)
        faults.disarm()
        assert policy.rollbacks == 1
        assert policy.lr_scale == 0.5
        assert isinstance(m._tx, _LrScaledTx)
        rollback = next(e for e in policy.events if e["kind"] == "rollback")
        assert rollback["restored_step"] <= rollback["from_iteration"]
        skipped = [e for e in policy.events if e["kind"] == "batch_skipped"]
        assert len(skipped) == 2
        assert np.isfinite(m.score_value)
        assert np.isfinite(list(m.param_table().values())[0]).all()
        assert _counter("dl4jtpu_recovery_events_total", kind="rollback") == \
            rb_before + 1

    def test_rollback_budget_exhausts_into_divergence_error(self, tmp_path,
                                                            monkeypatch):
        from deeplearning4j_tpu_torch.observe.health import DivergenceError

        monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
        m, store, policy = self._healing_model(tmp_path, max_rollbacks=1,
                                               skip_window=0)
        faults.arm("data.decode:corrupt:nth=6;data.decode:corrupt:nth=8")
        with pytest.raises(DivergenceError):
            m.fit(_feed(16), epochs=1)
        faults.disarm()
        assert policy.rollbacks == 2

    def test_rollback_skips_a_checkpoint_saved_with_nan_params(self, tmp_path,
                                                               monkeypatch):
        monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
        m, store, policy = self._healing_model(tmp_path)
        m.fit(_feed(10), epochs=1)          # finite saves at steps 4, 8
        good = [t.detach().clone() for t in tree_leaves(m.params)]
        with torch.no_grad():
            for t in tree_leaves(m.params):
                t.fill_(float("nan"))
        store.save(m, step=12)
        with torch.no_grad():
            for t, g in zip(tree_leaves(m.params), good):
                t.copy_(g)
        assert policy._pinned == 8
        faults.arm("data.decode:corrupt:nth=2")
        m.fit(_feed(8, seed=1), epochs=1)
        faults.disarm()
        assert policy.rollbacks == 1
        rollback = next(e for e in policy.events if e["kind"] == "rollback")
        assert rollback["restored_step"] == 8
        assert any(e["kind"] == "poisoned_checkpoint_skipped" and e["step"] == 12
                   for e in policy.events)
        assert np.isfinite(m.score_value)
        assert np.isfinite(list(m.param_table().values())[0]).all()

    def test_divergence_without_checkpoint_propagates(self, tmp_path, monkeypatch):
        from deeplearning4j_tpu_torch.observe.health import DivergenceError

        monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path))
        m = _model()
        RecoveryPolicy(None).attach(m)
        faults.arm("data.decode:corrupt:nth=3")
        with pytest.raises(DivergenceError):
            m.fit(_feed(6), epochs=1)
        faults.disarm()


# -- device OOM -> microbatch split ------------------------------------------------------

def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 1234 bytes")


class TestOomMicrobatchSplit:
    def _oomify(self, m, threshold):
        real = m.fit_batch
        sizes = []

        def oomy(batch):
            sizes.append(batch.num_examples)
            if batch.num_examples > threshold:
                raise _oom()
            real(batch)

        m.fit_batch = oomy
        return sizes

    def test_split_doubles_until_it_fits_then_sticks(self):
        m = _model()
        policy = RecoveryPolicy(None, max_split=8).attach(m)
        sizes = self._oomify(m, threshold=8)
        m.fit(_feed(4, batch=32), epochs=1)
        assert sizes[:3] == [32, 16, 8]
        assert policy.split_factor == 4
        assert m.iteration == 16
        assert set(sizes[2:]) == {8}
        assert [e["kind"] for e in policy.events] == ["oom_split"]
        assert np.isfinite(m.score_value)

    def test_partial_split_resumes_without_refitting(self):
        m = _model()
        policy = RecoveryPolicy(None, max_split=8).attach(m)
        policy.split_factor = 2
        real = m.fit_batch
        calls = []

        def oomy(batch):
            calls.append(batch.num_examples)
            if batch.num_examples == 16 and calls.count(16) == 2:
                raise _oom()
            real(batch)

        m.fit_batch = oomy
        m.fit(_feed(1, batch=32), epochs=1)
        assert calls == [16, 16, 8, 8]
        assert m.iteration == 3
        assert policy.split_factor == 4

    def test_oom_past_the_split_cap_reraises(self):
        m = _model()
        RecoveryPolicy(None, max_split=4).attach(m)
        self._oomify(m, threshold=1)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            m.fit(_feed(2, batch=16), epochs=1)

    def test_grouped_oom_disables_grouped_dispatch_for_the_fit(self):
        m = _model()
        policy = RecoveryPolicy(None).attach(m)
        batches = list(_feed(4))
        runner_calls = []

        def oom_runner(bs):
            runner_calls.append(len(bs))
            raise _oom()

        policy.run_group(m, batches[:2], oom_runner)
        assert runner_calls == [2]
        assert m.iteration == 2
        policy.run_group(m, batches[2:], oom_runner)
        assert runner_calls == [2]
        assert m.iteration == 4
        assert policy.split_factor == 1

    def test_non_oom_errors_pass_straight_through(self):
        m = _model()
        RecoveryPolicy(None).attach(m)

        def broken(batch):
            raise ValueError("not an OOM")

        m.fit_batch = broken
        with pytest.raises(ValueError, match="not an OOM"):
            m.fit(_feed(2), epochs=1)

    def test_an_oom_that_tore_the_trees_restores_them_first(self, tmp_path):
        """An OOM inside the updater's in-place writes: the trees come back
        from the store and the whole batch refits from the restore."""
        m = _model()
        store = CheckpointStore(str(tmp_path), keep_last=2, device="cpu")
        m.fit(_feed(2), epochs=1)
        store.save(m, step=m.iteration)
        saved = [t.detach().clone() for t in tree_leaves(m.params)]
        policy = RecoveryPolicy(store, max_split=4).attach(m)
        real_update = m._tx.update
        fired = []

        def tearing(grads, state, params=None, vals=None):
            if not fired:
                fired.append(1)
                with torch.no_grad():
                    params[0].add_(1.0)        # a torn write
                raise _oom()
            return real_update(grads, state, params, vals)

        m._tx = m._tx._replace(update=tearing)
        calls = []
        real = m.fit_batch
        m.fit_batch = lambda b: (calls.append(b.num_examples), real(b))
        m.fit(_feed(1, batch=16, seed=9), epochs=1)
        assert calls == [16, 8, 8] and m.iteration == 4
        assert [e["kind"] for e in policy.events] == ["oom_restore", "oom_split"]
        assert not torch.equal(saved[0], tree_leaves(m.params)[0].detach())


# -- poison batches -> quarantine --------------------------------------------------------

class TestPoisonBatchQuarantine:
    def test_corrupt_batch_is_screened_quarantined_and_fit_completes(self, tmp_path):
        m = _model()
        policy = RecoveryPolicy(None, quarantine_dir=str(tmp_path / "q"),
                                scan_inputs=True).attach(m)
        q_before = _counter("dl4jtpu_quarantined_batches_total",
                            reason="nonfinite_input")
        faults.arm("data.decode:corrupt:nth=3")
        m.fit(_feed(8), epochs=1)
        faults.disarm()
        assert policy.quarantined == 1
        assert m.iteration == 7
        [rec] = policy.quarantine.entries()
        assert rec["reason"] == "nonfinite_input" and rec["has_bytes"]
        assert np.isnan(np.load(rec["path"].replace(".json", ".npz"))["features"]).all()
        assert _counter("dl4jtpu_quarantined_batches_total",
                        reason="nonfinite_input") == q_before + 1
        assert np.isfinite(m.score_value)

    def test_decode_failure_is_quarantined_with_the_pulled_bytes(self, tmp_path):
        m = _model()
        policy = RecoveryPolicy(None, quarantine_dir=str(tmp_path / "q")).attach(m)
        faults.arm("data.decode:raise:nth=2,exc=runtime")
        m.fit(_feed(6), epochs=1)
        faults.disarm()
        assert policy.quarantined == 1 and m.iteration == 5
        [rec] = policy.quarantine.entries()
        assert rec["reason"] == "decode_error" and "InjectedError" in rec["error"]
        assert rec["has_bytes"]
        npz = np.load(rec["path"].replace(".json", ".npz"))
        assert npz["features"].shape == (8, 4)

    def test_pull_failure_is_quarantined_without_bytes(self, tmp_path):
        m = _model()
        policy = RecoveryPolicy(None, quarantine_dir=str(tmp_path / "q")).attach(m)
        faults.arm("data.next_batch:raise:nth=2,exc=runtime")
        m.fit(_feed(6), epochs=1)
        faults.disarm()
        assert policy.quarantined == 1 and m.iteration == 6
        [rec] = policy.quarantine.entries()
        assert rec["reason"] == "decode_error" and not rec["has_bytes"]
        assert "InjectedError" in rec["error"]

    def test_quarantine_budget_exhaustion_fails_loudly(self, tmp_path):
        m = _model()
        RecoveryPolicy(None, quarantine_dir=str(tmp_path / "q"),
                       quarantine_cap=2).attach(m)
        faults.arm("data.decode:raise:every=1,exc=runtime")
        with pytest.raises(faults.InjectedError):
            m.fit(_feed(8), epochs=1)
        faults.disarm()

    def test_restarted_run_inherits_spent_quarantine_budget(self, tmp_path):
        from deeplearning4j_tpu_torch.data.quarantine import QuarantineStore

        qdir = str(tmp_path / "q")
        prior = QuarantineStore(qdir, cap=2)
        prior.put("decode_error")
        prior.put("decode_error")
        policy = RecoveryPolicy(None, quarantine_dir=qdir, quarantine_cap=2)
        assert policy.quarantined == 2
        assert not policy.quarantine_pull_failure(object(), RuntimeError("x"))

    def test_programming_errors_in_the_feed_are_not_quarantined(self, tmp_path):
        m = _model()
        policy = RecoveryPolicy(None, quarantine_dir=str(tmp_path / "q")).attach(m)

        class Broken(DataSetIterator):
            def reset(self):
                pass

            def __iter__(self):
                yield from _feed(2)
                raise TypeError("a bug in iterator code, not corrupt data")

        with pytest.raises(TypeError, match="a bug"):
            m.fit(Broken(), epochs=1)
        assert policy.quarantined == 0

    def test_without_policy_decode_failures_still_raise(self):
        m = _model()
        faults.arm("data.decode:raise:nth=2,exc=runtime")
        with pytest.raises(faults.InjectedError):
            m.fit(_feed(4), epochs=1)
        faults.disarm()


# -- the chaos acceptance run ---------------------------------------------------------------

class TestChaosEndToEnd:
    def test_hang_nan_and_poison_batch_in_one_fit(self, tmp_path, monkeypatch):
        monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path / "crash"))
        m = _model()
        store = CheckpointStore(str(tmp_path / "ck"), keep_last=3, device="cpu")
        m.add_listener(_saver(store, every=3))
        policy = RecoveryPolicy(store, skip_window=1,
                                quarantine_dir=str(tmp_path / "q")).attach(m)
        m._watchdog = StepWatchdog(floor_s=0.05, cold_floor_s=0.05, k=10.0)
        before = {
            "warn": _counter("dl4jtpu_watchdog_stalls_total", stage="warn"),
            "rollback": _counter("dl4jtpu_recovery_events_total", kind="rollback"),
            "quarantine": _counter("dl4jtpu_quarantined_batches_total",
                                   reason="decode_error"),
        }
        faults.arm("device.sync:delay:nth=4,secs=2.0;"
                   "data.decode:raise:nth=7,exc=runtime;"
                   "data.decode:corrupt:nth=11")
        _bounded(lambda: m.fit(_feed(16), epochs=1))
        faults.disarm()
        assert "warn" in [e["stage"] for e in m._watchdog.events]
        assert policy.rollbacks == 1 and policy.lr_scale == 0.5
        assert policy.quarantined == 1
        assert np.isfinite(m.score_value)
        text = registry().to_prometheus_text()
        assert 'dl4jtpu_watchdog_stalls_total{stage="warn"}' in text
        assert 'dl4jtpu_recovery_events_total{kind="rollback"}' in text
        assert 'dl4jtpu_quarantined_batches_total{reason="decode_error"}' in text
        assert _counter("dl4jtpu_watchdog_stalls_total", stage="warn") >= \
            before["warn"] + 1
        assert _counter("dl4jtpu_recovery_events_total", kind="rollback") == \
            before["rollback"] + 1
        assert _counter("dl4jtpu_quarantined_batches_total",
                        reason="decode_error") == before["quarantine"] + 1

    def test_grouped_fit_routes_through_recovery_chokepoint(self, tmp_path,
                                                            monkeypatch):
        monkeypatch.setenv("DL4JTPU_CRASH_DIR", str(tmp_path / "crash"))
        m = _model()
        store = CheckpointStore(str(tmp_path / "ck"), keep_last=3, device="cpu")
        m.add_listener(_saver(store, every=4))
        policy = RecoveryPolicy(store, skip_window=0).attach(m)
        faults.arm("data.decode:corrupt:nth=9")
        m.fit(_feed(16), epochs=1, steps_per_execution=2)
        faults.disarm()
        assert policy.rollbacks == 1
        assert np.isfinite(m.score_value)
