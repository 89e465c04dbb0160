"""Fixed-shape programs captured as CUDA graphs — the port's counterpart
of `jax.jit` for the generation engine's decode and verify steps.

A decode step is some 340 small launches whose host cost dwarfs their
device time.  `CapturedProgram` runs ``fn(*inputs)`` once eagerly on a
side stream (cuBLAS handles, kernel attributes and workspaces come into
being there), captures it as a CUDA graph on that stream, and from then
on every call is one `replay`.

- ``inputs`` are static device tensors the graph reads: the caller
  fills them (``copy_``, outside the graph) before each replay.  A
  pageable host-to-device copy cannot be captured, so nothing inside
  ``fn`` may copy from the host.
- `outputs` are the tensors ``fn`` returned at capture; every replay
  overwrites them in place.  `warmup_outputs` are what the eager warm-up
  returned: that run is a real call, and its results are its caller's.
- ``keep`` holds what the graph read at capture (parameter tensors,
  kernel scratch): a graph replayed over freed memory reads garbage, so
  the owner re-captures when those objects change, and holds them until
  then.
- ``pool`` and ``stream``: another graph's `graph.pool()` and `stream`,
  to capture into that graph's private memory pool on its stream.  The
  allocator hands a capture only blocks freed on its own stream, so a
  pool is shared only with the stream.  Graphs that share a pool must
  never run at the same time, and a tensor ``fn`` returns (an output)
  lives in the pool, so only graphs whose outputs the caller no longer
  reads may share one.
- Capture runs with ``capture_error_mode="thread_local"``: other threads
  may use the card meanwhile.  It leaves the allocator's cache as it is.
  The garbage collector runs just before a capture and is off during it
  (a dead graph torn down mid-capture would invalidate the capture).
- Launch counters: the kernels a capture enqueues are held, not counted
  (they do not run then), and each replay counts them once; a
  backward's, which autograd enqueues from its own thread on the
  capture stream, too.
- Nothing falls back: a failing capture or replay raises.
- Each capture counts as one ``jit_cache_misses`` in `compile_stats`.
"""

from __future__ import annotations

import gc

import torch

from deeplearning4j_tpu_torch.runtime import compile_stats, kernels


class CapturedProgram:
    """``fn(*inputs)`` as one CUDA graph; see the module docstring."""

    def __init__(self, fn, inputs, *, keep=(), pool=None, stream=None):
        self.inputs = tuple(inputs)
        self.keep = tuple(keep)
        device = self.inputs[0].device
        self.stream = stream if stream is not None else torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            # warm-up: it runs, and counts
            self.warmup_outputs = fn(*self.inputs)
        # capture_begin / capture_end, not the `torch.cuda.graph` context:
        # that one empties the allocator's cache first, and every eager
        # allocation after it (the next prefills) pays cudaMalloc again.
        # Its collection is kept, and the collector stays off during the
        # capture: a collection there can destroy a dead model's graph,
        # whose teardown is a call a capturing thread may not make, and
        # the capture is lost
        self.graph = torch.cuda.CUDAGraph()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with kernels.holding_launches(self.stream.cuda_stream) as held, \
                    torch.cuda.stream(self.stream):
                self.graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    self.outputs = fn(*self.inputs)
                finally:
                    self.graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        self.held = held
        current.wait_stream(self.stream)
        compile_stats.note_capture()

    def replay(self):
        """Run the graph on the current stream; returns `outputs`."""
        self.graph.replay()
        kernels.count_replay(self.held)
        return self.outputs
