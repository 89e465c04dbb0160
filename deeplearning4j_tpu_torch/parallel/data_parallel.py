"""`distribute` of `deeplearning4j_tpu/parallel/data_parallel.py`: the
entry point to data, ZeRO-1/2, pipeline, tensor, expert and
compressed-gradient parallelism.  None of them is ported yet, so it
raises instead of training on one device as if it had spread the model.
"""

from __future__ import annotations


def distribute(model, config=None, devices=None, **kwargs):
    raise NotImplementedError(
        "parallel training (data parallelism, ZeRO-1/2, pipelining, "
        "compressed gradients, the planner) is not ported yet (ROADMAP "
        "A11: parallel/)")
