"""Training listeners — `deeplearning4j_tpu/train/listeners.py`, the
`org.deeplearning4j.optimize.api.TrainingListener` SPI.

A model calls ``iteration_done(model, iteration, epoch, score)`` once a
step (``iteration`` counts from 1 after the first step), inside the
step's scope, with a lazy score: converting it (``float(score)``,
formatting, comparing) fetches the program's losses once, so a listener
that reads no score never waits for the card.  ``fit`` calls
``on_epoch_start`` / ``on_epoch_end`` around each epoch and
``on_fit_end`` once.

The step graphs write the live tensors in place: a listener keeps
copies, never the tensors (`_HostSnapshot` takes host copies on the
training thread, before the next step).
"""

from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np
import torch

log = logging.getLogger("deeplearning4j_tpu_torch")


class TrainingListener:
    def iteration_done(self, model, iteration: int, epoch: int, score) -> None:
        pass

    def on_epoch_start(self, model, epoch: int) -> None:
        pass

    def on_epoch_end(self, model, epoch: int) -> None:
        pass

    def on_fit_end(self, model) -> None:
        """Called once when a ``fit()`` call returns (all epochs done)."""


class ScoreIterationListener(TrainingListener):
    """Logs the score every ``print_every`` iterations; the other steps
    read no score, so they never wait for the card."""

    def __init__(self, print_every: int = 10):
        self.print_every = max(1, print_every)

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.print_every == 0:
            log.info("Score at iteration %d is %s", iteration, float(score))


class CollectScoresListener(TrainingListener):
    def __init__(self):
        self.scores: list[tuple[int, float]] = []

    def iteration_done(self, model, iteration, epoch, score):
        self.scores.append((iteration, float(score)))


class PerformanceListener(TrainingListener):
    """samples/s and batches/s with a warm-up-excluded steady rate, the
    seconds ``fit`` sat blocked on its input iterator (`etl_wait_seconds`,
    `etl_wait_fraction`) and the compile taxes since the listener was
    made (`compile_stats`: CUDA-graph captures and ``nvcc`` runs,
    `runtime/compile_stats.py`)."""

    def __init__(self, frequency: int = 10, warmup_iterations: int = 10):
        from deeplearning4j_tpu_torch.runtime import compile_stats as _cs

        self.frequency = max(1, frequency)
        self.warmup = warmup_iterations
        self._count = 0
        self._samples = 0
        self._t0: float | None = None
        self._steady_t0: float | None = None
        self._steady_samples = 0
        self._steady_batches = 0
        self._compile_base = _cs.snapshot()
        self._etl_wait = 0.0
        self._steady_etl_wait = 0.0
        self._model_wait_seen: float | None = None

    def _track_etl_wait(self, model) -> None:
        total = getattr(model, "etl_wait_s", None)
        if total is None:
            return
        if self._model_wait_seen is None:
            # first observation: credit the wait of the batch that just
            # ran, not any history from before the listener
            self._model_wait_seen = max(
                0.0, total - getattr(model, "last_etl_wait_s", 0.0))
        delta = max(0.0, total - self._model_wait_seen)
        self._model_wait_seen = total
        self._etl_wait += delta
        # strictly after the warm-up boundary: the wait of the batch that
        # set _steady_t0 happened before it
        if self._count > self.warmup and self._steady_t0 is not None:
            self._steady_etl_wait += delta

    def iteration_done(self, model, iteration, epoch, score):
        now = time.perf_counter()
        batch = getattr(model, "last_batch_size", 0)
        if self._t0 is None:
            self._t0 = now
        self._count += 1
        self._samples += batch
        if self._count == self.warmup:
            self._steady_t0 = now
        elif self._count > self.warmup and self._steady_t0 is not None:
            self._steady_samples += batch
            self._steady_batches += 1
        self._track_etl_wait(model)
        if self._count % self.frequency == 0 and self._count > 1:
            total_dt = now - self._t0
            msg = (f"iteration {iteration}: {self._samples / total_dt:.1f} "
                   "samples/sec overall")
            if self._steady_batches:
                msg += f", {self.samples_per_sec():.1f} samples/sec steady-state"
            if self._etl_wait > 0:
                msg += f", etl-wait {100.0 * self._etl_wait / total_dt:.0f}%"
            cs = self.compile_stats()
            if cs["jit_cache_misses"]:
                msg += (f", {cs['jit_cache_misses']} recompiles"
                        f" ({cs['compile_secs']:.1f}s compile)")
            log.info(msg)

    def samples_per_sec(self) -> float:
        """Steady-state (post-warm-up) samples/s."""
        if not self._steady_batches or self._steady_t0 is None:
            return 0.0
        dt = time.perf_counter() - self._steady_t0
        return self._steady_samples / dt if dt > 0 else 0.0

    def batches_per_sec(self) -> float:
        if not self._steady_batches or self._steady_t0 is None:
            return 0.0
        dt = time.perf_counter() - self._steady_t0
        return self._steady_batches / dt if dt > 0 else 0.0

    def etl_wait_seconds(self) -> float:
        """Seconds the loop was blocked on its input iterator while this
        listener was attached."""
        return self._etl_wait

    def etl_wait_fraction(self) -> float:
        """Share of steady-state wall time spent blocked on the iterator."""
        if self._steady_t0 is None:
            return 0.0
        dt = time.perf_counter() - self._steady_t0
        return self._steady_etl_wait / dt if dt > 0 else 0.0

    def compile_stats(self) -> dict:
        """Graph captures, ``nvcc`` seconds and library hits since this
        listener was made."""
        from deeplearning4j_tpu_torch.runtime import compile_stats as _cs

        return (_cs.snapshot() - self._compile_base).as_dict()


class TimeIterationListener(TrainingListener):
    """ETA logging: given the expected total iteration count, logs the
    remaining time."""

    def __init__(self, total_iterations: int, frequency: int = 10):
        self.total = total_iterations
        self.frequency = max(1, frequency)
        self._start: float | None = None
        self._done = 0

    def iteration_done(self, model, iteration, epoch, score):
        now = time.perf_counter()
        if self._start is None:
            self._start = now
        self._done += 1
        if self._done % self.frequency == 0:
            elapsed = now - self._start
            per_iter = elapsed / self._done
            remaining = max(0, self.total - self._done) * per_iter
            log.info("iteration %d/%d, %.1fs elapsed, ~%.1fs remaining",
                     self._done, self.total, elapsed, remaining)

    def remaining_seconds(self) -> float:
        if self._start is None or self._done == 0:
            return float("nan")
        per_iter = (time.perf_counter() - self._start) / self._done
        return max(0, self.total - self._done) * per_iter


class EvaluativeListener(TrainingListener):
    """Periodic evaluation on held-out data; ``frequency`` counts
    iterations (``ITERATION``) or epochs (``EPOCH_END``)."""

    ITERATION = "iteration"
    EPOCH_END = "epoch_end"

    def __init__(self, data, frequency: int = 100, invocation: str = ITERATION,
                 evaluation_factory=None, callback=None):
        from deeplearning4j_tpu_torch.evaluation import Evaluation

        self.data = data
        self.frequency = max(1, frequency)
        self.invocation = invocation
        self._factory = evaluation_factory or Evaluation
        self.callback = callback
        self.evaluations: list = []

    def _evaluate(self, model) -> None:
        ev = self._factory()
        for batch in self.data:
            if batch.features_mask is not None:
                out = model.output(batch.features, batch.features_mask)
            else:
                out = model.output(batch.features)
            ev.eval(np.asarray(batch.labels), out.float().cpu().numpy(),
                    mask=batch.labels_mask)
        self.evaluations.append(ev)
        if self.callback is not None:
            self.callback(model, ev)
        else:
            log.info("EvaluativeListener:\n%s", ev.stats())

    def iteration_done(self, model, iteration, epoch, score):
        # iteration arrives 1-based, so a bare modulo fires every
        # `frequency` completed updates
        if self.invocation == self.ITERATION and iteration % self.frequency == 0:
            self._evaluate(model)

    def on_epoch_end(self, model, epoch):
        if self.invocation == self.EPOCH_END and (epoch + 1) % self.frequency == 0:
            self._evaluate(model)


def _host_copy(tree):
    """``tree`` with every tensor copied to the host (a new CPU tensor,
    never a view of the live one); counts and other leaves kept."""
    if isinstance(tree, dict):
        return {k: _host_copy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_host_copy(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_host_copy(v) for v in tree)
    if isinstance(tree, list):
        return [_host_copy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        return t.to("cpu", copy=True) if t.is_cuda else t.clone()
    return tree


class _HostSnapshot:
    """Host copies of a model's serializable state, taken on the training
    thread before the next step overwrites the live tensors; enough of a
    model for `ModelSerializer.write_model`."""

    def __init__(self, model):
        from deeplearning4j_tpu_torch.train.checkpoint import _updater_state

        self.params = _host_copy(model.params)
        self.net_state = _host_copy(model.net_state)
        self.opt_state = _host_copy(_updater_state(model))
        self.conf = model.conf
        self.iteration = model.iteration
        self.epoch = model.epoch
        self._quantized = model._quantized
        self._serialize_class_name = type(model).__name__


def _host_snapshot(model) -> _HostSnapshot:
    return _HostSnapshot(model)


class CheckpointListener(TrainingListener):
    """Rolling checkpoints: the model saved every N iterations or epochs
    into ``directory`` with a ``checkpoint.txt`` index; retention by
    ``keep_last`` / ``keep_every``.  ``async_save``: the host snapshot is
    taken on the training thread, the zip written on a writer thread
    (one in flight; `flush` waits for it and raises its failure)."""

    def __init__(self, directory: str, save_every_n_iterations: int | None = None,
                 save_every_n_epochs: int | None = None, keep_last: int | None = None,
                 keep_every: int = 1, async_save: bool = False):
        if (save_every_n_iterations is None) == (save_every_n_epochs is None):
            raise ValueError(
                "set exactly one of save_every_n_iterations / save_every_n_epochs")
        self.directory = directory
        self.every_iters = save_every_n_iterations
        self.every_epochs = save_every_n_epochs
        self.keep_last = keep_last
        self.keep_every = max(1, keep_every)
        self.async_save = async_save
        self._pending = None
        self._pending_error = None
        self._saved: list[tuple[int, str]] = []  # (checkpoint number, path)
        self._num = 0
        os.makedirs(directory, exist_ok=True)

    def _index_path(self) -> str:
        return os.path.join(self.directory, "checkpoint.txt")

    def _save(self, model, iteration: int, epoch: int) -> None:
        path = os.path.join(self.directory, f"checkpoint_{self._num}_Model.zip")
        num = self._num
        self._num += 1
        if not self.async_save:
            model.save(path)
            self._finish(num, path, iteration, epoch)
            return
        self.flush()                       # one in-flight save at a time
        snap = _host_snapshot(model)

        def writer():
            from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

            try:
                # write_model publishes atomically: the index only ever
                # names whole files
                ModelSerializer.write_model(snap, path)
                self._finish(num, path, iteration, epoch)
            except BaseException as exc:   # raised by the next flush()
                self._pending_error = exc

        self._pending = threading.Thread(target=writer, daemon=True)
        self._pending.start()

    def flush(self) -> None:
        """Wait for an in-flight async save; a failed one raises here."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        err = self._pending_error
        if err is not None:
            self._pending_error = None
            raise RuntimeError(f"async checkpoint save failed: {err}") from err

    def _finish(self, num: int, path: str, iteration: int, epoch: int) -> None:
        self._saved.append((num, path))
        with open(self._index_path(), "a") as f:
            f.write(f"{num},{iteration},{epoch},{time.time():.0f},"
                    f"{os.path.basename(path)}\n")
        if self.keep_last is not None:
            removable = [(n, p) for (n, p) in self._saved[: -self.keep_last]
                         if n % self.keep_every != 0 or self.keep_every == 1]
            for n, p in removable:
                if os.path.exists(p):
                    os.remove(p)
                self._saved.remove((n, p))

    def iteration_done(self, model, iteration, epoch, score):
        if self.every_iters and iteration % self.every_iters == 0:
            self._save(model, iteration, epoch)

    def on_epoch_end(self, model, epoch):
        if self.every_epochs and (epoch + 1) % self.every_epochs == 0:
            self._save(model, model.iteration, epoch)

    def on_fit_end(self, model):
        # the last async save lands (or raises) before fit() returns
        self.flush()

    def __del__(self):
        try:
            self.flush()
        except Exception:
            # a finalizer at interpreter exit: logging may be gone
            pass

    # -- loaders (the reference's lastCheckpoint(dir) and friends) ---------
    @staticmethod
    def available_checkpoints(directory: str) -> list[str]:
        index = os.path.join(directory, "checkpoint.txt")
        if not os.path.exists(index):
            return []
        names = []
        with open(index) as f:
            for line in f:
                name = line.strip().split(",")[-1]
                if os.path.exists(os.path.join(directory, name)):
                    names.append(os.path.join(directory, name))
        return names

    @staticmethod
    def last_checkpoint(directory: str, device=None):
        """The newest indexed checkpoint, restored on ``device`` (CUDA
        unless the caller asks for the CPU)."""
        from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

        paths = CheckpointListener.available_checkpoints(directory)
        if not paths:
            raise FileNotFoundError(f"no checkpoints in {directory}")
        return ModelSerializer.restore(paths[-1], device=device)
