"""Shape quantization for the serving plane — the port's copy of
`deeplearning4j_tpu/serving/batching.py`.

- **batch axis**: a coalesced batch of n requests pads up to the next
  power of two (capped at `max_batch`), so the server sees at most
  ``log2(max_batch) + 1`` batch shapes per input signature.  Padding
  rows are zeros; the real rows are sliced back out of the output.
- **time axis** (rank >= 2 single-input features, e.g. (T, F)
  sequences): padded up to `flags.bucket_length`'s quantum, with a
  features mask marking the real steps.

Both are pure host-side numpy; the padded batch is what crosses H2D.
"""

from __future__ import annotations

import numpy as np

from deeplearning4j_tpu_torch.runtime import flags


def batch_bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch (n <= max_batch)."""
    if n > max_batch:
        raise ValueError(f"batch of {n} exceeds max_batch={max_batch}")
    b = 1
    while b < n:
        b <<= 1
    return min(b, max_batch)


def bucket_signature(features: tuple, quantum: int | None,
                     sequence_axis: bool) -> tuple:
    """The signature a request batches under: per-input (shape sans
    batch, dtype), with the time axis already bucketed when sequence
    padding is on — requests of length 37 and 52 share the 64-bucket
    program."""
    sig = []
    for a in features:
        shape = tuple(a.shape)
        if sequence_axis and len(shape) >= 2:
            shape = (flags.bucket_length(shape[0], quantum),) + shape[1:]
        sig.append((shape, str(a.dtype)))
    return tuple(sig)


def pad_sequence(a: np.ndarray, quantum: int | None):
    """Pad ONE example's leading (time) axis up to its bucket; returns
    (padded, mask) where mask is 1.0 on real steps.  Rank-1 inputs and
    already-bucketed lengths pass through (mask still returned so the
    batcher can mix exact and padded requests in one batch)."""
    t = a.shape[0]
    tb = flags.bucket_length(t, quantum)
    mask = np.zeros((tb,), np.float32)
    mask[:t] = 1.0
    if tb == t:
        return a, mask
    pad_width = [(0, tb - t)] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad_width), mask


def stack_batch(rows: list[tuple], n_inputs: int,
                bucket: int) -> list[np.ndarray]:
    """Stack per-request examples into per-input batch arrays, padded
    with zero rows up to `bucket`.  `rows[i]` is request i's per-input
    tuple; every row shares a signature (the admission queue grouped
    them), so plain stacking is safe."""
    cols = []
    for j in range(n_inputs):
        col = np.stack([r[j] for r in rows])
        if bucket > len(rows):
            pad = np.zeros((bucket - len(rows),) + col.shape[1:], col.dtype)
            col = np.concatenate([col, pad])
        cols.append(col)
    return cols
