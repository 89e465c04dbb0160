"""The ZooModel SPI — `deeplearning4j_tpu/zoo/zoo_model.py`: each zoo
entry builds a ready-to-train configuration for a named architecture.
``init_pretrained`` (the checksummed local registry of checkpoint zips)
is ROADMAP A13's."""

from __future__ import annotations


class ZooModel:
    """Subclasses define ``conf()`` and ``NAME``."""

    NAME = "zoo"

    def __init__(self, num_classes: int = 10, seed: int = 123):
        self.num_classes = num_classes
        self.seed = seed

    def conf(self):
        raise NotImplementedError

    def init_model(self, device=None):
        """A freshly initialised model on ``device`` (CUDA by default): a
        `GraphModel` for a graph configuration, else a `SequentialModel`;
        the JAX package's weights for the same seed."""
        from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
        from deeplearning4j_tpu_torch.models.sequential import SequentialModel
        from deeplearning4j_tpu_torch.nn.conf.graph_conf import GraphConfiguration

        conf = self.conf()
        cls = GraphModel if isinstance(conf, GraphConfiguration) else SequentialModel
        return cls(conf, device=device).init()

    def init_pretrained(self, pretrained_type: str = "default",
                        path: str | None = None):
        raise NotImplementedError(
            "pretrained weights are not ported yet (ROADMAP A13: "
            "zoo/pretrained.py); restore a checkpoint zip with "
            "train.checkpoint.ModelSerializer.restore")
