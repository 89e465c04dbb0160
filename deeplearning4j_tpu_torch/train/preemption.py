"""Preemption-aware checkpointing — `deeplearning4j_tpu/train/preemption.py`.

A preempted machine receives SIGTERM with a short grace period, so the
state is saved inside the doomed process.  `PreemptionHandler` installs
signal handlers that only set a flag; the training loop (its listener,
called between steps, never inside a replay) sees the flag at the next
iteration boundary, writes a final checkpoint, notifies a coordinator
when one is given, and raises `PreemptionError` to stop the loop (or
goes on, with ``raise_after_save=False``).  Python runs a signal handler
on the main thread between bytecodes, so a SIGTERM that arrives during a
long step is seen at the next listener call.

    handler = PreemptionHandler(CheckpointStore("/ckpts/run"))
    model.set_listeners(handler.listener(), ...)
    model.fit(data, epochs=...)     # SIGTERM -> checkpoint -> PreemptionError
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

log = logging.getLogger("deeplearning4j_tpu_torch")


class PreemptionError(RuntimeError):
    """Raised by the listener after the preemption checkpoint landed."""


class PreemptionHandler:
    """Signal-flag + checkpoint-on-next-step-boundary.

    checkpointer: anything with save(model) + wait()
    (train.checkpoint.CheckpointStore: manifest verification and
    last-good fallback on the restore side), or a save-like callable via
    `on_preempt`.  The signal handler itself only sets a
    flag — async-signal-safe by construction; all real work happens on
    the training thread at the next iteration boundary.
    """

    def __init__(self, checkpointer=None, *, signals=(signal.SIGTERM,),
                 coordinator=None, raise_after_save: bool = True,
                 on_preempt=None):
        self.checkpointer = checkpointer
        self.coordinator = coordinator
        self.raise_after_save = raise_after_save
        self.on_preempt = on_preempt
        self._flag = threading.Event()
        self._signals = tuple(signals)
        self._prev: dict = {}
        self._installed = False

    # -- signal plumbing ---------------------------------------------------
    @staticmethod
    def _require_main_thread(what: str) -> None:
        # CPython only allows signal.signal on the main thread; without
        # this guard the caller gets a cryptic ValueError from deep inside
        # listener() instead of an actionable message
        if threading.current_thread() is not threading.main_thread():
            raise RuntimeError(
                f"PreemptionHandler.{what} must be called from the main "
                "thread (signal handlers can only be (un)installed there); "
                "install() on the main thread before handing the listener "
                "to a worker thread"
            )

    def install(self) -> "PreemptionHandler":
        if self._installed:
            return self
        self._require_main_thread("install()")
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        """Restore the previous signal handlers.  Idempotent: safe to call
        from a listener's on_fit_end AND again afterwards — the second and
        later calls are no-ops."""
        if not self._installed and not self._prev:
            return
        self._require_main_thread("uninstall()")
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        self._installed = False

    def _on_signal(self, signum, frame):
        log.warning("signal %s received: checkpointing at next step boundary",
                    signum)
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def trigger(self) -> None:
        """Programmatic preemption (tests / external watchers)."""
        self._flag.set()

    # -- training-loop side ------------------------------------------------
    def check(self, model) -> bool:
        """Call between steps: if preempted, save + notify; returns True
        (or raises PreemptionError when raise_after_save)."""
        if not self._flag.is_set():
            return False
        # handled once: without clearing, raise_after_save=False would
        # re-checkpoint on EVERY remaining step
        self._flag.clear()
        if self.on_preempt is not None:
            self.on_preempt(model)
        if self.checkpointer is not None:
            step = self.checkpointer.save(model)
            self.checkpointer.wait()
            log.warning("preemption checkpoint saved at step %s", step)
        if self.coordinator is not None:
            try:
                self.coordinator.report_preemption()
            except Exception:   # notification is best-effort by design
                log.exception("coordinator preemption notification failed")
        if self.raise_after_save:
            raise PreemptionError("preempted; checkpoint saved")
        return True

    def listener(self) -> "PreemptionListener":
        self.install()
        return PreemptionListener(self)


class PreemptionListener:
    """TrainingListener adapter: checks the flag after every iteration."""

    def __init__(self, handler: PreemptionHandler):
        self.handler = handler

    def iteration_done(self, model, iteration, epoch, score):
        self.handler.check(model)

    def on_epoch_start(self, model, epoch):
        pass

    def on_epoch_end(self, model, epoch):
        pass

    def on_fit_end(self, model):
        pass
