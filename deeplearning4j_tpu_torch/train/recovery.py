"""Closed-loop training recovery — `deeplearning4j_tpu/train/recovery.py`.

`RecoveryPolicy` sits at the fit loops' chokepoints
(`Model._fit_one` / `Model._fit_group`) and turns three run-killing
failures into bounded, observable recoveries:

- **divergence → rollback + LR backoff + skip window.**  The attached
  `HealthListener` (``raise_on_divergence=True``) raises
  `DivergenceError` on a NaN / Inf score, non-finite parameters or a
  norm explosion; the policy copies the newest valid, finite checkpoint
  of its `CheckpointStore` into the live model's tensors in place
  (`ModelSerializer.restore_into`: the step graphs keep reading the same
  tensors, so a rollback captures nothing), multiplies the learning
  rate by ``lr_backoff`` (`_LrScaledTx`: the rate is one of the
  updater's staged step values, so the graphs read the new rate with no
  new capture), and skips the next ``skip_window`` batches.  It keeps
  its rollback target pinned in the store, so ``keep_last`` rotation
  cannot collect it.

- **device OOM → microbatch split.**  An OOM escaping a step (a
  `torch.cuda.OutOfMemoryError`, `runtime/crash.py` `is_oom_error`) is
  caught, the batch is split along the example axis and the pieces are
  stepped one by one; the factor doubles a retry up to ``max_split`` and
  then sticks for the rest of the fit.  Pieces are ceil(B / 2^i) long,
  so the retries add at most log2(max_split) step graphs.  A piece that
  already stepped is never refitted.  An OOM in the updater's in-place
  writes leaves the trees torn (`Model._updating`): they are restored
  from the store first.  A grouped program that OOMs turns grouped
  dispatch off for the rest of the fit.

- **poison batch → quarantine.**  A failure at the batch pull or decode
  and (``scan_inputs``) a batch with non-finite features or labels go
  to a bounded on-disk `data.quarantine.QuarantineStore` and are counted
  (``dl4jtpu_quarantined_batches_total``); past the cap the policy fails
  loudly.

After a rollback or an OOM a truncated-BPTT model's carries start from
zeros again (`SequentialModel._reset_carries`).  Every event is counted
under ``dl4jtpu_recovery_events_total{kind}``.
A data-parallel model (`parallel/data_parallel.py`) rolls back on every
rank together: the global score and the replicated parameters raise the
same divergence on each, and the restore copies in place (a ZeRO model
takes its own slices of the saved optimizer state), so each rank's
captured step is kept.  What one rank alone would do, quarantining its
batch or splitting it after an OOM, would leave the ranks running
different steps and raises instead (`_world_local`).
"""

from __future__ import annotations

import gc
import logging
import math
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import updaters

log = logging.getLogger("deeplearning4j_tpu_torch")

#: pull / decode failures that are never poison batches: host memory
#: pressure, and programming errors in iterator or decoder code (a bug to
#: fix, not a record to skip up to the cap; corrupt data raises
#: ValueError / OSError / RuntimeError flavours)
NON_POISON_ERRORS = (MemoryError, TypeError, AttributeError, NameError)


def _is_oom(exc: BaseException) -> bool:
    from deeplearning4j_tpu_torch.runtime.crash import is_oom_error

    seen = 0
    while exc is not None and seen < 8:
        if is_oom_error(exc):
            return True
        exc = exc.__cause__ or exc.__context__
        seen += 1
    return False


def _num_examples(batch) -> int:
    try:
        return int(batch.num_examples)
    except Exception:
        return 0


def _chunk_batch(batch, chunk: int) -> Optional[list]:
    """Example-axis chunks of ``chunk`` (the last ragged), or None for a
    type that does not split."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet

    if isinstance(batch, (DataSet, MultiDataSet)):
        return batch.split_batches(chunk)
    return None


def _slice_examples(batch, start: int):
    """``batch[start:]`` along the example axis, masks included: the part
    of a partly fitted split that has not stepped."""
    from deeplearning4j_tpu_torch.data.dataset import map_batch

    return map_batch(batch, lambda a: a[start:])


def _batch_nonfinite(batch) -> bool:
    """True when a float feature or label array holds NaN / Inf (a tensor
    is checked where it lies; one scalar comes back)."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet

    if isinstance(batch, DataSet):
        arrays = (batch.features, batch.labels)
    elif isinstance(batch, MultiDataSet):
        arrays = tuple(batch.features) + tuple(batch.labels)
    else:
        return False
    for a in arrays:
        if isinstance(a, torch.Tensor):
            if a.is_floating_point() and not bool(torch.isfinite(a).all()):
                return True
        elif a is not None:
            a = np.asarray(a)
            if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all():
                return True
    return False


def _checkpoint_params_nonfinite(path: str) -> bool:
    from deeplearning4j_tpu_torch.train.checkpoint import params_nonfinite

    return params_nonfinite(path)


def _world_local(model, what: str) -> None:
    """Raise when ``model`` steps in a world of several ranks: ``what``
    would change this rank's steps alone and wedge the others in their
    next collective."""
    sharding = getattr(model, "_batch_sharding", None)
    if sharding is not None and sharding.n > 1:
        raise RuntimeError(
            f"{what} on one rank of a data-parallel world of {sharding.n} would "
            "leave the ranks running different steps; fix the feed or the "
            "batch size on every rank")


def _reset_carries(model) -> None:
    """A truncated-BPTT model's carries start again from zeros (JAX: the
    policy resets the model's TBPTT state after a rollback or a failed
    step)."""
    reset = getattr(model, "_reset_carries", None)
    if reset is not None:
        reset()


def _release_cached(model) -> None:
    """After a device OOM: hand the allocator's cached blocks back before
    a retry."""
    device = getattr(model, "device", None)
    if device is not None and device.type == "cuda":
        gc.collect()
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


class _LrScaledTx:
    """A facade over the model's updater whose learning rate is scaled by
    ``factor``, its state identical to the inner one's (a checkpointed
    optimizer state keeps restoring).  The rate is a staged step value
    (`nn/updaters.py` `scale_rate`), so a captured step reads the new
    rate from its inputs and nothing is captured again.  An updater
    without a rate (AdaDelta, NoOp) has its updates scaled by a
    constant instead, which changes the step program: ``recapture`` is
    then True and the policy drops the model's step graphs."""

    def __init__(self, inner, factor: float):
        self.inner = inner
        self.factor = float(factor)
        tx = updaters.scale_rate(inner, self.factor)
        self.recapture = tx is None
        if tx is None:
            f = float(np.float32(self.factor))
            tx = updaters.chain(inner, updaters.Transform(
                lambda params: (),
                lambda g, s, p=None, v=None: (torch._foreach_mul(g, f), s)))
        self._tx = tx

    def init(self, params):
        return self._tx.init(params)

    def update(self, grads, state, params=None, vals=None):
        return self._tx.update(grads, state, params, vals)

    def values(self, state):
        return self._tx.values(state)


class RecoveryPolicy:
    """Divergence, OOM and poison-batch recovery wired into a model's fit
    loops.  One policy serves one model:

        store = CheckpointStore(ckpt_dir)
        policy = RecoveryPolicy(store, quarantine_dir=qdir)
        policy.attach(model)
        model.fit(data, ...)        # now self-healing

    store: rollback source; None disables rollback (divergence then
      re-raises) and the repair of torn trees after an OOM.
    lr_backoff: factor on the learning rate a rollback.
    max_rollbacks: past it the `DivergenceError` propagates.
    skip_window: batches skipped after each rollback.
    max_split: OOM microbatch split cap (a power of two).
    quarantine_dir / quarantine_cap: the poison-batch quarantine; no
      directory keeps count without writing anything.
    scan_inputs: check every batch for non-finite values before its step
      (off by default: the HealthListener sees what slips through one
      step later).
    """

    def __init__(self, store=None, *, lr_backoff: float = 0.5,
                 max_rollbacks: int = 3, skip_window: int = 2,
                 max_split: int = 8, quarantine_dir: Optional[str] = None,
                 quarantine_cap: int = 16, scan_inputs: bool = False,
                 health_frequency: int = 1):
        if not 0.0 < lr_backoff <= 1.0:
            raise ValueError("lr_backoff must be in (0, 1]")
        if max_split < 2:
            raise ValueError("max_split must be >= 2")
        self.store = store
        self.lr_backoff = float(lr_backoff)
        self.max_rollbacks = int(max_rollbacks)
        self.skip_window = int(skip_window)
        self.max_split = int(max_split)
        self.quarantine_cap = int(quarantine_cap)
        self.scan_inputs = bool(scan_inputs)
        self.health_frequency = int(health_frequency)
        self.quarantine = None
        self.rollbacks = 0
        self.quarantined = 0
        if quarantine_dir is not None:
            from deeplearning4j_tpu_torch.data.quarantine import QuarantineStore

            self.quarantine = QuarantineStore(quarantine_dir, cap=quarantine_cap)
            # a restarted run inherits the directory's spent budget
            self.quarantined = len(self.quarantine)
        self.lr_scale = 1.0
        self.split_factor = 1
        # a grouped program that OOM'd once will again: groups step batch
        # by batch for the rest of the fit
        self._grouped_oom = False
        self.events: list[dict] = []
        self.health = None
        self._skip_remaining = 0
        self._base_tx = None
        self._pinned: Optional[int] = None

    # -- lifecycle ---------------------------------------------------------
    def attach(self, model) -> "RecoveryPolicy":
        """Route ``model``'s fit chokepoints through this policy, make sure
        a raising HealthListener watches every step, and pin the newest
        good checkpoint of the store."""
        from deeplearning4j_tpu_torch.observe.health import HealthListener

        model._recovery = self
        self._base_tx = model._tx
        hl = next((l for l in model.listeners if isinstance(l, HealthListener)),
                  None)
        if hl is None:
            hl = HealthListener(frequency=self.health_frequency,
                                raise_on_divergence=True)
            model.add_listener(hl)
        else:
            hl.raise_on_divergence = True
        self.health = hl
        if self.store is not None:
            for entry in self.store.iter_valid():
                if self._pin_poisoned(entry["step"], entry["path"]):
                    continue
                self._repin(entry["step"])
                break
            # the pin advances with each verified, finite save
            self.store.add_save_listener(self._on_save)
        return self

    def detach(self, model) -> None:
        if getattr(model, "_recovery", None) is self:
            model._recovery = None
        if self.store is not None:
            self.store.remove_save_listener(self._on_save)
            if self._pinned is not None:
                self.store.unpin(self._pinned)
                self._pinned = None

    def _on_save(self, step: int, path: str) -> None:
        from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

        try:
            ModelSerializer.verify(path)
        except Exception as e:
            log.warning("freshly saved checkpoint %s failed verification (%s); "
                        "rollback pin stays at step %s", path, e, self._pinned)
            return
        # an intact save of non-finite parameters must not hold the pin
        if self._pin_poisoned(step, path):
            return
        self._repin(step)

    def _pin_poisoned(self, step: int, path: str) -> bool:
        """True when ``path`` must not hold the rollback pin (non-finite
        parameters, or unreadable during the check)."""
        try:
            nonfinite = _checkpoint_params_nonfinite(path)
        except Exception as e:
            log.warning("could not screen checkpoint step %d for finiteness "
                        "(%s); not pinning it", step, e)
            return True
        if nonfinite:
            from deeplearning4j_tpu_torch.train.checkpoint import (
                count_skipped_checkpoint,
            )

            self._event("poisoned_checkpoint_skipped", step=step)
            count_skipped_checkpoint(path, "nonfinite")
            log.warning("checkpoint step %d is intact but holds non-finite "
                        "params; rollback pin stays at step %s", step, self._pinned)
            return True
        return False

    def _repin(self, step: int) -> None:
        if self.store is None or step == self._pinned:
            return
        if self._pinned is not None:
            self.store.unpin(self._pinned)
        self.store.pin(step)
        self._pinned = step

    # -- the chokepoints (Model._fit_one / Model._fit_group) ---------------
    def run_step(self, model, batch) -> None:
        """One pulled batch through the whole envelope."""
        from deeplearning4j_tpu_torch.observe.health import DivergenceError

        if self._skip_remaining > 0:
            self._skip_remaining -= 1
            self._event("batch_skipped", skipped_remaining=self._skip_remaining)
            return
        if self.scan_inputs and _batch_nonfinite(batch):
            if not self._absorb(model, "nonfinite_input", batch=batch):
                raise RuntimeError(
                    f"quarantine budget exhausted ({self.quarantined}/"
                    f"{self.quarantine_cap}) and the feed keeps producing "
                    "non-finite batches")
            return
        try:
            self._fit_split(model, batch)
        except DivergenceError as exc:
            self._rollback(model, exc)

    def run_group(self, model, batches, runner) -> None:
        """A grouped program through the envelope.  Skip windows, sticky
        splits and input scans step the group batch by batch: the grouped
        program cannot skip or split a member."""
        from deeplearning4j_tpu_torch.observe.health import DivergenceError

        if (self._skip_remaining > 0 or self.split_factor > 1
                or self.scan_inputs or self._grouped_oom):
            for b in batches:
                self.run_step(model, b)
            return
        try:
            runner(batches)
            return
        except DivergenceError as exc:
            self._rollback(model, exc)
            return
        except Exception as exc:
            if not _is_oom(exc) or (self._buffers_deleted(model)
                                    and self.store is None):
                raise
        # out of the handler: the failed program's frames (and the device
        # memory they hold) are gone
        log.warning("grouped step program OOM'd; retrying %d batches one by "
                    "one (grouped dispatch stays off for the rest of the fit)",
                    len(batches))
        self._grouped_oom = True
        self._cold_watchdog(model)   # a per-batch program: a new capture
        _release_cached(model)
        _reset_carries(model)
        if self._buffers_deleted(model) and not self._restore_arrays(model):
            raise RuntimeError("a grouped OOM tore the live trees and no valid "
                               "checkpoint can restore them")
        for b in batches:
            self.run_step(model, b)

    # -- poison batches ----------------------------------------------------
    def quarantine_pull_failure(self, model, exc: BaseException,
                                batch=None) -> bool:
        """Called by `Model._timed_batches` when a pull or decode raised:
        True = absorbed (the feed goes on), False = not poison or the
        budget is spent (the caller re-raises).  ``batch``: the pulled
        data when the failure hit the decode boundary (the record then
        carries its bytes)."""
        if isinstance(exc, NON_POISON_ERRORS):
            return False
        return self._absorb(model, "decode_error", batch=batch, error=exc)

    def _absorb(self, model, reason: str, batch=None,
                error: Optional[BaseException] = None) -> bool:
        _world_local(model, f"quarantining a poison batch ({reason})")
        if self.quarantined >= self.quarantine_cap:
            return False
        self.quarantined += 1
        path = None
        if self.quarantine is not None:
            try:
                path = self.quarantine.put(reason, batch=batch, error=error)
            except Exception:
                log.exception("quarantine write failed (batch dropped)")
        self._count_quarantined(reason)
        self._event("quarantined", reason=reason, path=path,
                    error=None if error is None else repr(error))
        log.warning("poison batch quarantined (%s, %d/%d absorbed)%s", reason,
                    self.quarantined, self.quarantine_cap,
                    f" -> {path}" if path else "")
        return True

    # -- divergence --------------------------------------------------------
    def _rollback(self, model, exc) -> None:
        from deeplearning4j_tpu_torch.observe.trace import tracer

        self.rollbacks += 1
        if self.rollbacks > self.max_rollbacks:
            log.error("divergence after %d rollbacks (budget %d): giving up",
                      self.rollbacks - 1, self.max_rollbacks)
            raise exc
        if self.store is None:
            raise exc
        from_iteration = int(model.iteration)
        with tracer().span("recovery_rollback", cat="recovery"):
            entry = self._restore_finite(model)
        if entry is None:
            log.error("divergence with no finite valid checkpoint to roll back to")
            raise exc
        self._repin(entry["step"])
        _reset_carries(model)
        self.lr_scale *= self.lr_backoff
        model._tx = tx = _LrScaledTx(self._base_tx, self.lr_scale)
        if tx.recapture:
            model._drop_graphs()
            self._cold_watchdog(model)
        self._skip_remaining = self.skip_window
        # the health listener's caches describe the parameters before the
        # rollback
        if self.health is not None:
            self.health._last_seen_params = None
            self.health._prev_params = None
        self._gauge_lr()
        self._event("rollback", divergence_kind=exc.event.get("kind"),
                    from_iteration=from_iteration, restored_step=entry["step"],
                    restored_iteration=int(model.iteration),
                    lr_scale=self.lr_scale, skip_window=self.skip_window)
        log.warning("ROLLBACK: %s at iteration %d -> restored step %d, lr_scale "
                    "%.4g, skipping next %d batches", exc.event.get("kind"),
                    from_iteration, entry["step"], self.lr_scale, self.skip_window)

    @staticmethod
    def _cold_watchdog(model) -> None:
        """The next step captures a new graph: drop the watchdog's latency
        EWMA so that step gets the cold floor, not a deadline calibrated
        on replays."""
        wd = getattr(model, "_watchdog", None)
        if wd is not None:
            wd.ewma = None

    @staticmethod
    def _install(model, path: str) -> None:
        """Copy the checkpoint at ``path`` into the live model in place
        (parameters, layer state, optimizer state, ``iteration``)."""
        from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

        ModelSerializer.restore_into(model, path, verify=False)
        model._updating = False

    # -- device OOM --------------------------------------------------------
    @staticmethod
    def _buffers_deleted(model) -> bool:
        """The failed step was writing the live trees in place: they are
        torn (JAX: a donated buffer the failed program consumed)."""
        return bool(getattr(model, "_updating", False))

    def _restore_arrays(self, model) -> bool:
        """Repair torn trees from the newest valid checkpoint (no rate
        change: this is a repair, not a divergence)."""
        if self.store is None:
            return False
        entry = self._restore_finite(model)
        if entry is None:
            return False
        self._repin(entry["step"])
        self._event("oom_restore", restored_step=entry["step"])
        return True

    def _restore_finite(self, model):
        """Restore the newest checkpoint that is intact and all finite into
        ``model``; returns its store entry, or None.  An intact file of
        NaN parameters would re-diverge at once and burn the budget on
        itself while older finite ones sit in the store."""
        for entry in self.store.iter_valid():
            try:
                nonfinite = _checkpoint_params_nonfinite(entry["path"])
            except Exception as e:
                log.warning("could not screen checkpoint step %d for finiteness "
                            "(%s); skipping it as a restore target",
                            entry["step"], e)
                continue
            if nonfinite:
                from deeplearning4j_tpu_torch.train.checkpoint import (
                    count_skipped_checkpoint,
                )

                self._event("poisoned_checkpoint_skipped", step=entry["step"])
                count_skipped_checkpoint(entry["path"], "nonfinite")
                log.warning("checkpoint step %d is intact but holds non-finite "
                            "params; skipping it as a restore target",
                            entry["step"])
                continue
            self._install(model, entry["path"])
            return entry
        return None

    def _fit_split(self, model, batch) -> None:
        """Fit ``batch`` under the sticky split factor, doubling it on an
        OOM, never refitting examples that already stepped (a partly
        fitted split resumes at its first unfitted example)."""
        from deeplearning4j_tpu_torch.observe.health import DivergenceError

        n = _num_examples(batch)
        factor = max(1, self.split_factor)
        start = 0                    # examples [0, start) already stepped
        while True:
            rest = batch if start == 0 else _slice_examples(batch, start)
            chunk = n if factor <= 1 else math.ceil(n / factor)
            pieces = (_chunk_batch(rest, chunk)
                      if 0 < chunk < _num_examples(rest) else None) or [rest]
            try:
                for p in pieces:
                    model.fit_batch(p)
                    start += _num_examples(p)
                break
            except DivergenceError:
                raise                          # run_step rolls back
            except Exception as exc:
                if not _is_oom(exc):
                    raise
                _world_local(model, "splitting a batch after an OOM")
                nxt = max(2, factor * 2)
                if nxt > self.max_split or chunk <= 1 or n < 2:
                    log.error("OOM not recoverable by splitting (factor cap %d, "
                              "batch %d examples, %d already stepped)",
                              self.max_split, n, start)
                    raise
                if self._buffers_deleted(model) and self.store is None:
                    log.error("an OOM tore the live trees and no checkpoint "
                              "store can restore them: cannot retry")
                    raise
            # out of the handler: the failed step's frames (and the device
            # memory they hold) are gone
            _release_cached(model)
            _reset_carries(model)
            if self._buffers_deleted(model):
                if not self._restore_arrays(model):
                    raise RuntimeError("an OOM tore the live trees and no valid "
                                       "checkpoint can restore them")
                # the restore rewound the pieces that stepped too
                start = 0
            factor = nxt
            self._cold_watchdog(model)   # a new piece shape: a capture
        if factor > 1 and factor > self.split_factor:
            self.split_factor = factor    # sticky: later batches pre-split
            self._event("oom_split", split_factor=factor,
                        microbatch=math.ceil(n / factor) if n else None)
            log.warning("OOM recovered: batch of %d split %dx (microbatch %d); "
                        "split sticks for the rest of the fit", n, factor,
                        math.ceil(n / factor) if n else -1)

    # -- accounting --------------------------------------------------------
    def _event(self, kind: str, **fields) -> None:
        ev = {"kind": kind, **fields}
        self.events.append(ev)
        if len(self.events) > 256:
            del self.events[:-256]
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().counter("dl4jtpu_recovery_events_total").inc(kind=kind)
        except Exception as e:
            log.debug("recovery event metric failed: %s", e)

    def _count_quarantined(self, reason: str) -> None:
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().counter("dl4jtpu_quarantined_batches_total").inc(
                reason=reason)
        except Exception as e:
            log.debug("quarantine metric failed: %s", e)

    def _gauge_lr(self) -> None:
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().gauge("dl4jtpu_recovery_lr_scale").set(self.lr_scale)
        except Exception as e:
            log.debug("lr-scale gauge failed: %s", e)
