"""Device prefetch — `deeplearning4j_tpu/data/prefetch.py`: the fit
loops' software-pipelining stage.

A fit loop that pulls and stages batch N+1 only after step N leaves the
card idle while the host works.  `PrefetchIterator` breaks that
serialisation: a background thread pulls the next batches from the base
iterator and stages them onto the device while the current step runs,
feeding a bounded queue the training thread drains.  The fit loops wrap
a lazily produced feed in one (`Model._prefetch_feed`,
``environment().prefetch_depth`` deep, default 2; 0 disables it).
Contract, the JAX package's:

- **order and bytes**: batches come out in base-iterator order with
  identical values (staging moves bytes, never transforms them: uint8
  stays uint8);
- **bounded depth**: at most ``depth`` staged batches wait in the queue,
  so prefetching never holds more than that of device memory;
- **clean shutdown**: abandoning the iteration (an exception in the
  training loop, `close`) stops the producer thread and joins it;
- **errors in place**: a producer-side exception (a decode error, an
  armed ``data.prefetch`` fault) is raised on the training thread at the
  queue position where it happened, after every batch staged before it;
- **overlap accounting**: each staged batch carries the producer's
  seconds spent pulling and staging it (``_prefetch_stage_s``); the fit
  loop subtracts its own wait to count what was hidden behind the step
  (`Model._timed_batches`).

On the card, staging (`stage_to_device`) copies each array from pinned
host memory on the producer thread's own CUDA stream and records an
event after the copies; before the consumer gets the batch, its current
stream waits on that event and the staged tensors are marked as used on
that stream (``record_stream``), so the host never synchronises and the
allocator never hands their memory back while the step still reads it.
Pinning, the side stream and the event either work or raise: nothing
falls back to a pageable copy.  On the CPU staging is a copy into torch
tensors.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.data.iterator import DataSetIterator
from deeplearning4j_tpu_torch.runtime.backend import resolve_device

_SIDE = threading.local()


def _side_stream(device: torch.device):
    """The calling thread's copy stream on ``device`` (made once a
    thread)."""
    streams = getattr(_SIDE, "streams", None)
    if streams is None:
        streams = _SIDE.streams = {}
    s = streams.get(device.index)
    if s is None:
        s = streams[device.index] = torch.cuda.Stream(device)
    return s


def _map_arrays(batch, fn):
    """``batch`` with ``fn`` applied to every array (None passes); a batch
    of another type comes back as it is."""
    def ap(a):
        return None if a is None else fn(a)

    def apt(arrays):
        return None if arrays is None else tuple(ap(a) for a in arrays)

    if isinstance(batch, MultiDataSet):
        return MultiDataSet(apt(batch.features), apt(batch.labels),
                            apt(batch.features_masks), apt(batch.labels_masks))
    if isinstance(batch, DataSet):
        return DataSet(ap(batch.features), ap(batch.labels),
                       ap(batch.features_mask), ap(batch.labels_mask))
    return batch


def _tensors(batch) -> list:
    out = []
    _map_arrays(batch, lambda a: out.append(a) if isinstance(a, torch.Tensor) else None)
    return out


def stage_to_device(batch, device=None):
    """A copy of ``batch`` (a `DataSet` or `MultiDataSet`; another type
    passes as it is) with every array on ``device`` (CUDA by default),
    values unchanged.  On the card: from pinned host memory on this
    thread's side stream, with the event that ends the copies kept as
    ``_ready`` (`wait_staged` fences on it)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return _map_arrays(batch, lambda a: a.to(dev) if isinstance(a, torch.Tensor)
                           else torch.from_numpy(np.array(a)))
    stream = _side_stream(dev)

    def put(a):
        if isinstance(a, torch.Tensor) and a.is_cuda:
            return a
        host = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        # the host allocator keeps the pinned block until the copy is done
        return host.pin_memory().to(dev, non_blocking=True)

    with torch.cuda.stream(stream):
        staged = _map_arrays(batch, put)
        ready = torch.cuda.Event()
        ready.record(stream)
    if staged is not batch:
        staged._ready = ready
    return staged


def wait_staged(batch) -> None:
    """Make the current stream wait for ``batch``'s staging copies (a
    no-op for a batch not staged on the card), and mark its tensors as
    used there."""
    ready = getattr(batch, "_ready", None)
    if ready is None:
        return
    tensors = _tensors(batch)
    current = torch.cuda.current_stream(tensors[0].device)
    current.wait_event(ready)
    for t in tensors:
        t.record_stream(current)
    batch._ready = None


class PrefetchIterator(DataSetIterator):
    """Background-thread prefetch onto a device with a bounded queue.

    ``stage``: called as ``stage(batch, device)`` on the producer thread
    (default `stage_to_device`); None pulls ahead without moving
    anything.  ``device``: where to stage (CUDA by default)."""

    _END = object()

    def __init__(self, base, depth: int = 2,
                 stage: Optional[Callable] = stage_to_device, device=None):
        self._base = base
        self._depth = max(1, int(depth))
        self._stage = stage
        self._device = resolve_device(device) if stage is not None else None
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def batch_size(self) -> int:
        return getattr(self._base, "batch_size", 0)

    def reset(self) -> None:
        self.close()
        if hasattr(self._base, "reset"):
            self._base.reset()

    def close(self) -> None:
        """Stop and join the active producer thread (idempotent).  The
        fit loops call this in a ``finally``."""
        stop, thread = self._stop, self._thread
        self._stop, self._thread = None, None
        if stop is not None:
            stop.set()
        if thread is not None and thread.is_alive():
            thread.join(timeout=10.0)

    def __iter__(self) -> Iterator:
        from deeplearning4j_tpu_torch.runtime import faults

        self.close()                      # one producer per iteration
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up once the consumer is gone, so
            # the thread (and the batches it holds) never outlives it
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            from deeplearning4j_tpu_torch.observe.metrics import registry

            staged_total = registry().counter("dl4jtpu_prefetch_batches_total")
            try:
                it = iter(self._base)
                while True:
                    t0 = time.perf_counter()
                    faults.maybe_fail("data.prefetch")
                    try:
                        batch = next(it)
                    except StopIteration:
                        return
                    if self._stage is not None:
                        batch = self._stage(batch, self._device)
                    try:
                        batch._prefetch_stage_s = time.perf_counter() - t0
                    except AttributeError:
                        pass              # a slotted batch type
                    staged_total.inc()
                    if not put(batch):
                        return
            except BaseException as e:
                # raised in order on the consumer side: batches staged
                # before the failure still train
                put((self._END, e))
                return
            finally:
                put((self._END, None))

        t = threading.Thread(target=produce, name="dl4jtpu-prefetch", daemon=True)
        self._stop, self._thread = stop, t
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, tuple) and len(item) == 2 and item[0] is self._END:
                    if item[1] is not None:
                        raise item[1]
                    return
                wait_staged(item)
                yield item
        finally:
            stop.set()
            t.join(timeout=10.0)
            if self._thread is t:
                self._stop, self._thread = None, None
