"""LeNet training at the repo's ``bench.py`` ``bench_lenet``
configuration, through the port's normal entry points.

    python -m deeplearning4j_tpu_torch.bench_lenet --device cpu [--f32]

`MnistDataSetIterator` (train, 30,000 examples; the procedural digits
when no IDX files are found) in batches of 512, the first 40 batches
cycled; LeNet (seed 123, Adam 1e-3) trained ``WARMUP`` steps, then
``STEPS`` measured steps, all through ``fit(steps_per_execution=50)``;
then `evaluate` on 5,000 test images in batches of 1,000.  Prints one
JSON object: every loss's summary, the measured seconds, samples/s and
the accuracy.  ``chip_smoke.py``'s ``lenet`` phase runs the same
functions on the card; a run on the CPU gives its accuracy floor.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

BATCH, EXAMPLES, BATCHES = 512, 30000, 40
SPE, WARMUP, STEPS = 50, 100, 1000
EVAL_EXAMPLES, EVAL_BATCH = 5000, 1000


def lenet_conf(f32: bool = False):
    """LeNet of the zoo (seed 123); ``f32`` sets ``bf16_compute=False``
    (on the card the default is bf16)."""
    from deeplearning4j_tpu_torch.zoo.lenet import LeNet

    conf = LeNet().conf()
    return dataclasses.replace(conf, bf16_compute=False) if f32 else conf


def lenet(device=None, f32: bool = False):
    """`lenet_conf` built and initialised on ``device``."""
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel

    return SequentialModel(lenet_conf(f32), device=device).init()


def train_batches(batch: int = BATCH, examples: int = EXAMPLES,
                  n: int = BATCHES):
    """(is_synthetic, the first ``n`` training batches)."""
    from deeplearning4j_tpu_torch.data.builtin import MnistDataSetIterator

    it = MnistDataSetIterator(batch, train=True, num_examples=examples)
    return it.is_synthetic, list(it)[:n]


def train(model, batches, steps: int, spe: int = SPE) -> torch.Tensor:
    """``steps`` steps over ``batches`` cycled, ``fit(...,
    steps_per_execution=spe)`` a group; returns every step's loss (on
    the model's device, not synchronised)."""
    losses = []
    for g in range(0, steps, spe):
        group = [batches[(g + i) % len(batches)] for i in range(min(spe, steps - g))]
        model.fit(group, steps_per_execution=spe)
        losses.append(model._last_score.reshape(-1))
    return torch.cat(losses)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def accuracy(model, examples: int = EVAL_EXAMPLES, batch: int = EVAL_BATCH):
    from deeplearning4j_tpu_torch.data.builtin import MnistDataSetIterator

    test = MnistDataSetIterator(batch, train=False, num_examples=examples)
    return model.evaluate(test).accuracy()


def run(device=None, f32: bool = False, warmup: int = WARMUP,
        steps: int = STEPS) -> dict:
    """The whole configuration; see the module docstring."""
    synthetic, batches = train_batches()
    model = lenet(device, f32)
    first = train(model, batches, warmup)
    sync(model.device)
    t0 = time.perf_counter()
    measured = train(model, batches, steps)
    sync(model.device)
    secs = time.perf_counter() - t0
    losses = torch.cat([first, measured]).float().cpu().numpy()
    return {
        "device": str(model.device), "compute": str(model.compute_dtype),
        "is_synthetic": synthetic, "batch": BATCH, "warmup_steps": warmup,
        "steps": steps, "steps_per_execution": SPE, "seconds": secs,
        "ms_per_step": secs / steps * 1e3,
        "samples_per_s": steps * BATCH / secs,
        "finite": bool(np.isfinite(losses).all()),
        "first50_mean": float(losses[:50].mean()),
        "last50_mean": float(losses[-50:].mean()),
        "accuracy": accuracy(model), "model": model, "losses": losses,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cpu or cuda (the default)")
    ap.add_argument("--f32", action="store_true", help="bf16_compute=False")
    args = ap.parse_args(argv)
    res = run(args.device, args.f32)
    del res["model"], res["losses"]
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
