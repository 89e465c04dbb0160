"""The process world — `deeplearning4j_tpu/runtime/distributed.py`.

The JAX package scales out as one SPMD program whose devices span every
host process (``jax.distributed``); a process feeds its local rows of a
batch and GSPMD inserts the collectives.  The port's process model is
PyTorch's own: **one process per device** in a `torch.distributed`
world, NCCL between cards and gloo on the CPU.  A world of N ranks is
the counterpart of the JAX package's N-device data axis: each rank's
``fit`` takes that rank's rows of the global batch, as a JAX process
does in a multi-process world (`put_global`).

- `DistributedConfig` / `from_env`: how a process joins (the JAX
  package's ``DL4JTPU_*`` variables; the JAX CPU simulator's
  ``DL4JTPU_LOCAL_DEVICES`` has no counterpart: a rank is one device).
  ``DistributedConfig.backend`` "gloo" puts CUDA tensors on gloo, so
  two ranks may share one card, which NCCL refuses.
- `initialize` calls ``init_process_group`` (NCCL on CUDA, gloo on the
  CPU) and sets the rank's device.  With nothing configured it forms a
  world of one on a free local port, so a lone process still runs its
  collectives (the JAX package's single process forms no world).  A
  configured world never drops to one rank: a missing coordinator
  raises.
- `put_global` takes a rank's rows; `fetch_global` all-gathers them.
- `all_reduce_flat`, `all_gather_flat`, `broadcast_flat`: several
  tensors through one collective of a flat bucket.
- `DistributedDataSetIterator`: the rank-strided view of an iterator.
- `spawn(fn, n, ...)`: ``fn`` on n ranks of a fresh world, each a
  process of its own, on a free port the OS picks.  A rank that raises,
  dies or outlives the time limit fails the whole world, and every rank
  process is stopped before `spawn` returns or raises.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import socket
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("deeplearning4j_tpu_torch")

ENV_COORDINATOR = "DL4JTPU_COORDINATOR"       # host:port of rank 0
ENV_NUM_PROCESSES = "DL4JTPU_NUM_PROCESSES"
ENV_PROCESS_ID = "DL4JTPU_PROCESS_ID"
ENV_PLATFORM = "DL4JTPU_PLATFORM"             # "cpu" for gloo on the CPU


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """How this process joins the world: rank 0's ``host:port``, the
    world size and this process's rank.  ``platform`` "cpu" makes a
    gloo world of CPU ranks; otherwise each rank takes the card
    ``rank % device_count`` and NCCL, unless ``backend`` says "gloo"
    (CUDA tensors over gloo: several ranks may share one card).
    ``heartbeat_timeout_seconds``: how long a collective may wait for a
    peer before the world fails (default 600)."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    platform: Optional[str] = None
    heartbeat_timeout_seconds: Optional[int] = None
    backend: Optional[str] = None

    @staticmethod
    def from_env() -> "DistributedConfig":
        def _int(name):
            v = os.environ.get(name)
            return int(v) if v not in (None, "") else None

        return DistributedConfig(
            coordinator_address=os.environ.get(ENV_COORDINATOR) or None,
            num_processes=_int(ENV_NUM_PROCESSES),
            process_id=_int(ENV_PROCESS_ID),
            platform=os.environ.get(ENV_PLATFORM) or None,
        )


_initialized = False
_device: Optional[torch.device] = None


def free_port() -> int:
    """A TCP port on the loopback interface that the OS picked free."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(config: DistributedConfig | None = None) -> None:
    """Join (or form) the world: ``init_process_group`` with the rank's
    backend, and the rank's device set.  A no-op once initialized.  With
    neither a world size nor a coordinator configured, forms a world of
    one on a free loopback port."""
    global _initialized, _device
    if _initialized:
        return
    config = config or DistributedConfig.from_env()
    n, rank, addr = config.num_processes, config.process_id, config.coordinator_address
    if n is None and addr is None:
        n, rank, addr = 1, 0, f"127.0.0.1:{free_port()}"
    if n is None or addr is None or (n > 1 and rank is None):
        raise ValueError(
            "a distributed world needs the coordinator address, the number "
            f"of processes and this process's id; got coordinator={addr!r}, "
            f"num_processes={n!r}, process_id={rank!r}")
    rank = 0 if rank is None else int(rank)
    n = int(n)
    if not 0 <= rank < n:
        raise ValueError(f"process_id {rank} outside a world of {n}")
    if config.platform == "cpu":
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA world was requested but torch.cuda.is_available() is "
                "False; pass DistributedConfig(platform='cpu') for gloo on "
                "the CPU")
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = config.backend or ("gloo" if device.type == "cpu" else "nccl")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("NCCL needs CUDA ranks")
    timeout = datetime.timedelta(seconds=config.heartbeat_timeout_seconds or 600)
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=n,
                            rank=rank, timeout=timeout, **kwargs)
    _device = device
    _initialized = True


def shutdown() -> None:
    global _initialized, _device
    from deeplearning4j_tpu_torch.runtime import mesh

    mesh._GROUPS.clear()
    if _initialized and dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception as e:          # peers may be gone already
            log.debug("destroy_process_group failed: %s", e)
    _initialized = False
    _device = None


def is_initialized() -> bool:
    return _initialized


def device() -> torch.device:
    """This rank's device (the CPU, or its card)."""
    if _device is None:
        raise RuntimeError("the distributed world is not initialized")
    return _device


def backend_name() -> str:
    return dist.get_backend() if _initialized else "none"


def process_index() -> int:
    return dist.get_rank() if _initialized else 0


def process_count() -> int:
    return dist.get_world_size() if _initialized else 1


def is_chief() -> bool:
    """True on the rank that owns the world's singleton work
    (checkpoint writes)."""
    return process_index() == 0


def barrier(name: str = "dl4jtpu") -> None:
    """Block until every rank reaches this point."""
    if _initialized:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def put_global(arr, *, full_value: bool = False, device=None, block=None):
    """This rank's rows as a tensor on its device.  ``full_value=False``:
    ``arr`` is already the rank's local rows (each rank feeds disjoint
    data, JAX ``make_array_from_process_local_data``).  ``full_value=
    True``: every rank passes the same global batch and takes its own
    rows of it; a global batch the world does not divide raises.
    ``block``: (index, count) of the rows to take instead of (this
    rank, the world size): a rank's coordinate on the data axis of a
    mesh with other axes (a model's ``_batch_sharding``)."""
    if arr is None:
        return None
    dev = device if device is not None else (_device or torch.device("cpu"))
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.array(arr))
    if full_value:
        n, r = process_count(), process_index()
        if block is not None:
            r, n = block
        rows = t.shape[0] if t.dim() else 0
        if t.dim() == 0 or rows % n:
            raise ValueError(
                f"a global batch of {rows} rows does not divide over a world of "
                f"{n} ranks (the data axis shards the batch dim evenly); pick "
                f"a batch divisible by {n}")
        c = rows // n
        t = t[r * c:(r + 1) * c]
    return t.to(dev)


def fetch_global(t) -> np.ndarray:
    """Every rank's rows of ``t`` (rank order, concatenated on dim 0) on
    this host: an all-gather, so every rank must call it."""
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(np.array(t))
    if not _initialized or process_count() == 1:
        return t.detach().cpu().numpy()
    dev = _device if dist.get_backend() == "nccl" else t.device
    src = t.detach().to(dev).contiguous()
    parts = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(parts, src)
    return torch.cat(parts).cpu().numpy()



# -- flat buckets: several tensors through one collective ----------------------------

def _pack(tensors, dtype=None) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(dtype or t.dtype) for t in tensors])


def _unpack(flat: torch.Tensor, like) -> list:
    """Views of ``flat`` in the shapes of ``like``, in order."""
    out, at = [], 0
    for t in like:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def all_reduce_flat(tensors, dtype=torch.float32, group=None) -> list:
    """Each tensor summed over the world (or ``group``), in one
    all-reduce of a flat ``dtype`` bucket: views of the bucket in the
    tensors' shapes."""
    flat = _pack(tensors, dtype)
    dist.all_reduce(flat, group=group)
    return _unpack(flat, tensors)


def all_gather_flat(tensors) -> list:
    """Every rank's ``tensors`` (of one dtype and the same shapes on every
    rank), in one all-gather of a flat bucket: ``out[j]`` holds rank j's,
    as views in the tensors' shapes."""
    flat = _pack(tensors)
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, flat)
    return [_unpack(p, tensors) for p in parts]


@torch.no_grad()
def broadcast_flat(tensors, src: int = 0) -> None:
    """Rank ``src``'s ``tensors`` (of one dtype) copied into every rank's,
    in place, in one broadcast of a flat bucket."""
    flat = _pack(tensors)
    dist.broadcast(flat, src)
    for t, v in zip(tensors, _unpack(flat, tensors)):
        t.copy_(v)


from deeplearning4j_tpu_torch.data.iterator import DataSetIterator as _DataSetIterator  # noqa: E402


class DistributedDataSetIterator(_DataSetIterator):
    """Rank-strided view of a DataSetIterator: rank k of N yields batches
    k, N+k, 2N+k, ... (each rank reads disjoint data).

    A ragged tail (total batches not divisible by the world size) is
    dropped on every rank: each step is a collective, so unequal
    per-rank step counts would wedge the world on the last step.
    Wrap the same underlying iterator construction on every rank."""

    def __init__(self, inner, rank: int | None = None,
                 world_size: int | None = None):
        self.inner = inner
        self.rank = process_index() if rank is None else rank
        self.world = process_count() if world_size is None else world_size
        self._consumed = False
        if not (0 <= self.rank < self.world):
            raise ValueError(f"rank {self.rank} outside world {self.world}")

    @property
    def batch_size(self):
        return getattr(self.inner, "batch_size", None)

    def _one_shot(self) -> bool:
        """True when the inner can serve exactly one pass (a generator:
        its own iterator, no reset)."""
        return not hasattr(self.inner, "reset") and iter(self.inner) is self.inner

    def __iter__(self):
        # a second pass over a one-shot inner would yield nothing, or
        # resume mid-stream after a partial pass
        if self._consumed and self._one_shot():
            raise NotImplementedError(
                f"{type(self.inner).__name__} is a one-shot iterator; wrap "
                "a resettable DataSetIterator (or a list) for multi-epoch use")
        self._consumed = True          # armed at start: partial passes count
        group = []
        for batch in self.inner:
            group.append(batch)
            if len(group) == self.world:
                yield group[self.rank]
                group = []

    def reset(self) -> None:
        if hasattr(self.inner, "reset"):
            self.inner.reset()
            self._consumed = False
        elif not self._one_shot():     # re-iterable (e.g. a list)
            self._consumed = False


# -- spawning a world ------------------------------------------------------------

def _rank_main(fn, rank, n, addr, platform, backend, threads, args, queue):
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize(DistributedConfig(coordinator_address=addr, num_processes=n,
                                     process_id=rank, platform=platform,
                                     backend=backend))
        out = fn(*args)
        queue.put((rank, True, out))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def spawn(fn, n: int, *args, platform: str | None = None,
          backend: str | None = None, timeout: float = 600.0,
          threads: int | None = 1) -> list:
    """Run ``fn(*args)`` on each of ``n`` ranks of a fresh world (one
    spawned process a rank, ``initialize`` done, ``threads`` intra-op
    threads) and return the ranks' results in rank order.  ``fn`` and
    its results must pickle (a module-level function).  A rank that
    raises fails the world with its traceback, a rank that dies or a
    world that outlives ``timeout`` seconds fails it too; every rank
    process is stopped before this returns or raises."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    addr = f"127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, addr, platform, backend, threads,
                               args, queue))
             for r in range(n)]
    results: dict = {}
    done = False
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(results) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"a world of {n} ranks did not finish within {timeout:.0f} s "
                    f"(ranks done: {sorted(results)})")
            try:
                rank, ok, out = queue.get(timeout=min(left, 0.5))
            except Exception:               # queue.Empty: look for the dead
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results]
                if dead:
                    # a rank that put its result may exit before we read it
                    try:
                        rank, ok, out = queue.get(timeout=2.0)
                    except Exception:
                        raise RuntimeError(
                            f"rank {dead[0]} of {n} died (exit code "
                            f"{procs[dead[0]].exitcode}) without a result") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{out}")
            results[rank] = out
        done = True
        return [results[r] for r in range(n)]
    finally:
        if done:                            # the ranks are shutting down
            for p in procs:
                p.join(timeout=10.0)
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        queue.close()
        queue.join_thread()
