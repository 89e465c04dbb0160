"""The ZooModel SPI — `deeplearning4j_tpu/zoo/zoo_model.py`: each zoo
entry builds a ready-to-train configuration for a named architecture;
``init_pretrained`` restores weights from the checksummed local registry
of checkpoint zips (`zoo/pretrained.py`)."""

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
                        path: str | None = None, device=None):
        """Pretrained weights (ZooModel.initPretrained(PretrainedType)) on
        ``device`` (CUDA by default): the checkpoint zip at ``path``, else
        the registry's entry for (NAME, ``pretrained_type``), checksum
        verified."""
        from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer
        from deeplearning4j_tpu_torch.zoo.pretrained import PretrainedRegistry

        if path is None:
            registry = PretrainedRegistry()
            try:
                path = registry.resolve(self.NAME, pretrained_type)
            except FileNotFoundError:
                # the layout before the registry: a bare {NAME}.zip with no
                # index, for the default type of a model with no entries;
                # a typed request or a corrupt registry's miss is raised
                legacy = registry.root / f"{self.NAME}.zip"
                if (pretrained_type != "default" or registry.available(self.NAME)
                        or not legacy.exists()):
                    raise
                path = str(legacy)
        return ModelSerializer.restore(str(path), device=device)
