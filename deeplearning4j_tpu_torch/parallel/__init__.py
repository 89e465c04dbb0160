"""Parallelism over the port's process world — `deeplearning4j_tpu/parallel/`:
data parallelism (`distribute`, `ParallelWrapper`), ZeRO-1/2 and int8
compressed gradients, and the model, seq and expert axes inside the
step (`collectives`, `strategy`'s partition rules, `expert`).  Names
resolve on first use, so the layers' `parallel.context` imports nothing
of the models."""

__all__ = ["distribute", "place_batch", "ParallelConfig", "ParallelWrapper",
           "ParallelInference"]


def __getattr__(name):
    if name in ("distribute", "place_batch"):
        from deeplearning4j_tpu_torch.parallel import data_parallel

        return getattr(data_parallel, name)
    if name == "ParallelConfig":
        from deeplearning4j_tpu_torch.parallel.strategy import ParallelConfig

        return ParallelConfig
    if name in ("ParallelWrapper", "ParallelInference"):
        from deeplearning4j_tpu_torch.parallel import wrapper

        return getattr(wrapper, name)
    raise AttributeError(name)
