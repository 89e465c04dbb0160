"""`ParallelWrapper` — `deeplearning4j_tpu/parallel/wrapper.py`.

The reference's ParallelWrapper clones a model per GPU and merges their
updates.  Here, as in the JAX package, it is a facade over `distribute`:
the first ``fit`` or ``output`` distributes the model over the world's
data axis, then each rank's ``fit`` trains on its rows of the global
batch with the exact gradient all-reduce every step.

``ParallelInference`` (request coalescing over a sharded forward) waits
for the served mesh model (ROADMAP A11) and raises.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.parallel.data_parallel import distribute
from deeplearning4j_tpu_torch.parallel.strategy import ParallelConfig


class ParallelWrapper:
    def __init__(self, model, config: ParallelConfig | None = None, devices=None):
        self.model = model
        self._config = config or ParallelConfig.data_parallel()
        self._devices = devices
        self._distributed = False

    def _ensure(self):
        if not self._distributed:
            distribute(self.model, self._config, self._devices)
            self._distributed = True

    def fit(self, data, epochs: int = 1, **kw) -> None:
        """``model.fit`` on this rank's rows, data-parallel."""
        self._ensure()
        self.model.fit(data, epochs=epochs, **kw)

    def output(self, *features, **kw):
        """The model's ``output`` of ``features`` on this rank (the
        replicas are equal, so every rank answers the same)."""
        self._ensure()
        return self.model.output(*features, **kw)


class ParallelInference:
    """Multi-device serving with request coalescing: not ported yet."""

    def __init__(self, model, *args, **kwargs):
        raise NotImplementedError(
            "ParallelInference is not ported yet (ROADMAP A11: the served mesh "
            "model); serve one replica a card through serving.InferenceServer or "
            "serving.ServingFleet")
