"""The model base — `deeplearning4j_tpu/models/model.py`: what every
model class shares.  The fit loop's batch pull with its fault sites and
ETL accounting, the last score, parameter accounting, ``save`` and
``compile_stats``.

The pull (`_timed_batches`) consults the fault sites where the JAX
package does: ``data.next_batch`` before each ``next()``, and
``data.decode`` after it (``corrupt`` NaN-fills the batch's float
arrays, a decoder emitting garbage; ``raise`` fails the pull).  Without
a recovery policy (ROADMAP A9) a failed pull ends the fit, as in the
JAX package.  The seconds ``fit`` waits on its iterator land on
``etl_wait_s`` and on ``dl4jtpu_etl_wait_seconds_total``.

Listeners, the step watchdog's arming and the quarantine path are ROADMAP
A9's; asking for a listener raises, naming it.
"""

from __future__ import annotations

import time

import numpy as np
from torch import nn

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.runtime import compile_stats as _cs
from deeplearning4j_tpu_torch.runtime import faults


def _poison_batch(batch: DataSet) -> DataSet:
    """The ``data.decode`` 'corrupt' action: a copy of the batch with
    every float feature and label array NaN-filled, shapes and dtypes
    kept; masks are left alone (a corrupt record keeps its framing)."""
    def bad(a):
        a = np.array(a, copy=True)
        if np.issubdtype(a.dtype, np.floating):
            a.fill(np.nan)
        return a

    return DataSet(bad(batch.features), bad(batch.labels), batch.features_mask,
                   batch.labels_mask)


class Model(nn.Module):
    """The surface `SequentialModel` shares with the JAX package's model
    classes."""

    def __init__(self):
        super().__init__()
        self.opt_state = None
        self.net_state = None          # non-trained state (BatchNorm stats)
        self.iteration = 0
        self.epoch = 0
        self.last_batch_size = 0
        self._last_score = None
        # seconds fit() sat blocked on its input iterator
        self.etl_wait_s = 0.0
        self.last_etl_wait_s = 0.0
        self._compile_snap = _cs.snapshot()   # baseline at model creation

    # -- listeners (ROADMAP A9) -----------------------------------------------
    def set_listeners(self, *listeners) -> None:
        raise NotImplementedError(
            "training listeners are not ported yet (ROADMAP A9: train/"
            "listeners.py, the watchdog and recovery)")

    add_listener = set_listeners

    # -- the fit loop's batch pull ----------------------------------------------
    def _timed_batches(self, iterator):
        """Iterate ``iterator`` through the fault sites, charging the time
        blocked on ``next()`` to ``etl_wait_s``."""
        from deeplearning4j_tpu_torch.observe.metrics import registry

        reg = registry()
        wait_total = reg.counter("dl4jtpu_etl_wait_seconds_total")
        batches_total = reg.counter("dl4jtpu_etl_batches_total")
        it = iter(iterator)
        while True:
            t0 = time.perf_counter()
            faults.maybe_fail("data.next_batch")
            try:
                batch = next(it)
            except StopIteration:
                return
            # after the pull, so a raise never tears the iterator's frame
            if faults.maybe_fail("data.decode") == "corrupt":
                batch = _poison_batch(batch)
            wait = time.perf_counter() - t0
            self.last_etl_wait_s = wait
            self.etl_wait_s += wait
            wait_total.inc(wait)
            batches_total.inc()
            yield batch

    # -- accounting ---------------------------------------------------------------
    @property
    def score_value(self) -> float:
        """Last training loss, penalty included (reference `Model.score()`);
        synchronises with the device.  A grouped fit's score is the
        group's last step's."""
        if self._last_score is None:
            return float("nan")
        s = self._last_score.detach().float().cpu().numpy()
        return float(s.ravel()[-1])

    def num_params(self) -> int:
        if self.params is None:
            raise RuntimeError("model not initialized; call init()")
        return sum(int(np.prod(t.shape)) for t in _leaves(self.params))

    def param_table(self) -> dict[str, np.ndarray]:
        """Flattened ``"layer.param"`` -> array view (the reference's
        ``paramTable()``), keys as the JAX package writes them, in its
        path order."""
        out = {}

        def walk(node, path):
            for k in sorted(node):
                v, p = node[k], f"{path}.{k}" if path else k
                if isinstance(v, dict):
                    walk(v, p)
                elif hasattr(v, "q") and hasattr(v, "scale"):
                    out[p + ".q"] = v.q.detach().cpu().numpy()
                    out[p + ".scale"] = v.scale.detach().cpu().numpy()
                else:
                    out[p] = v.detach().cpu().numpy()

        walk(self.params, "")
        return out

    def compile_stats(self) -> dict:
        """Compile taxes since this model was built (`runtime/
        compile_stats.py`: graph captures, ``nvcc`` runs, library hits),
        plus ``step_programs``: the CUDA graphs this model holds for its
        training step, one a batch signature."""
        d = (_cs.snapshot() - self._compile_snap).as_dict()
        d["step_programs"] = len(getattr(self, "_captured", {}))
        return d

    def save(self, path: str, save_updater: bool = True) -> None:
        from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

        ModelSerializer.write_model(self, path, save_updater)


def _leaves(tree):
    """Array leaves; a quantized weight as its ``q`` and ``scale``."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        elif hasattr(v, "q") and hasattr(v, "scale"):
            yield from (v.q, v.scale)
        else:
            yield v
