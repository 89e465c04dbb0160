"""Parallelism over the port's process world — `deeplearning4j_tpu/parallel/`:
data parallelism (`distribute`, `ParallelWrapper`), ZeRO-1/2 and int8
compressed gradients, the model, seq and expert axes inside the step
(`collectives`, `strategy`'s partition rules, `expert`), pipeline
parallelism (`pipeline`) and the planner (`planner`, ``auto=True``).
Names resolve on first use, so the layers' `parallel.context` imports
nothing of the models."""

__all__ = ["distribute", "place_batch", "ParallelConfig", "ParallelWrapper",
           "ParallelInference", "pipeline_apply", "pipeline_train_1f1b", "plan",
           "PlanError"]


def __getattr__(name):
    if name in ("distribute", "place_batch"):
        from deeplearning4j_tpu_torch.parallel import data_parallel

        return getattr(data_parallel, name)
    if name == "ParallelConfig":
        from deeplearning4j_tpu_torch.parallel.strategy import ParallelConfig

        return ParallelConfig
    if name in ("pipeline_apply", "pipeline_train_1f1b"):
        from deeplearning4j_tpu_torch.parallel import pipeline

        return getattr(pipeline, name)
    if name in ("plan", "PlanError"):
        from deeplearning4j_tpu_torch.parallel import planner

        return getattr(planner, name)
    if name in ("ParallelWrapper", "ParallelInference"):
        from deeplearning4j_tpu_torch.parallel import wrapper

        return getattr(wrapper, name)
    raise AttributeError(name)
