"""The model base — `deeplearning4j_tpu/models/model.py`: what every
model class shares.  The fit loop's batch pull with its fault sites,
ETL and prefetch-overlap accounting, the last score, parameter
accounting, ``save`` and ``compile_stats``; and the training-step
machinery `SequentialModel` and `GraphModel` both run.

The pull (`_timed_batches`) consults the fault sites where the JAX
package does: ``data.next_batch`` before each ``next()``, and
``data.decode`` after it (``corrupt`` NaN-fills the batch's float
arrays, a decoder emitting garbage; ``raise`` fails the pull).  Without
a recovery policy (`train/recovery.py`) a failed pull ends the fit, as in the
JAX package.  The seconds ``fit`` waits on its iterator land on
``etl_wait_s`` and on ``dl4jtpu_etl_wait_seconds_total`` (a batch the
cache tier replays, tagged ``_etl_source``, on that source's series
instead, and not on ``etl_wait_s``); its bytes on
``dl4jtpu_h2d_bytes_total``, by ``feed`` ("raw" for the fused decode's
undecoded batches, "decoded" otherwise).  A batch a
`data.prefetch.PrefetchIterator` staged carries the producer's seconds
for it; what of them the consumer did not wait for is the overlap the
pipeline bought (``overlap_s``,
``dl4jtpu_prefetch_overlap_seconds_total``, ``overlap_seconds`` on the
``train_step`` span).  ``fit`` wraps a lazily produced feed in one
(`_prefetch_feed`, ``environment().prefetch_depth`` deep; in-memory
feeds are exempt).

The step machinery.  A model keeps its parameters as a tree of
`ParamTree` modules keyed by layer (or graph ``param_key``), f32
masters; `compute_params` is their detached compute-dtype cast, and the
training step differentiates through the cast (`cast_tree`).  A model
class supplies how a batch splits into the step's device inputs
(`_batch_arrays`: a flat tuple of arrays, None for an absent mask), the
step's objective (`_step_loss`), the per-node dropout keys
(`_layer_keys`) and its own checks; the base runs the steps:

- on the CPU eagerly, the updater's step values as Python floats;
- on the card from staged inputs (`_Staged`: a group's K batches, keys
  and step values on the card in one copy each), each step a replay of
  one CUDA graph for each batch signature (`_capture`: the first step of
  a signature runs eagerly as the graph's warm-up, on the capture
  stream, and is captured after), or with ``capture_steps = False`` the
  same program eagerly on the same device inputs: the same kernels, so
  the same bits.  A capture that fails raises; nothing reruns the step
  eagerly instead.  A model's step graphs share one memory pool and one
  capture stream.  The graphs read the live parameter, optimizer and
  state tensors, so whatever installs new ones (`init`, `load_params`,
  `load_net_state`, a fresh optimizer state) drops them (`_drop_graphs`);
  copying values into the live tensors in place keeps them.

The device data pipeline (`datavec/device.py`, JAX
``_device_decode_feed``).  When ``fit``'s iterator advertises a
transform chain that lowers (and ``environment().device_decode`` is on),
the fit pulls its raw batches instead and each step runs the chain as
its first stage: the step's inputs are the raw features and labels and
the decode keys of the batch's augmentation index, and on the card the
chain is captured into the step's graph, one graph a raw-batch
signature.  A fit variant that cannot fuse (`_fused_decode_reason`) or a
chain that does not lower logs the reason, counts it on
``dl4jtpu_device_decode_fallbacks_total`` and trains on the iterator's
own host-decoded batches; a raw batch that carries masks is decoded on
the host.  A fused dispatch counts its batches on
``dl4jtpu_device_decode_batches_total`` and the standalone decode's
calibrated seconds on ``dl4jtpu_device_decode_seconds_total``.

``fit(..., steps_per_execution=K)`` groups K batches of one signature
(JAX ``_fit_epoch_multi``): each step keeps its own loss; a group whose
shapes differ, and a short tail, step batch by batch.

Frozen layers (``frozen=True``, `train/transfer.py`): the step
differentiates only the trainable leaves (`_trainable_leaves`), and the
updater sees only them, so a frozen leaf gets no gradient, no update
and no weight decay, and its optimizer state is absent, as optax's
``masked`` keeps none (JAX ``mask_frozen_tx``).  A frozen prefix runs
forward only.  The forward is unchanged: a frozen BatchNorm still
updates its running statistics in training mode and a frozen layer's
dropout still applies, as in the JAX package.

Listeners (`train/listeners.py`).  After every step program the model
dispatches ``iteration_done`` once a step, in order, with lazy scores
(`_LazyScores`: the program's K losses are fetched to the host at most
once, by the first listener that reads a score), inside the step's
scope (its watchdog arm covers them) and the ``listeners`` span; a
listener that raises leaves ``iteration`` counting every step that ran.
The scores are read from the program's own loss tensor, never a graph's
static slot, which the next replay overwrites.  ``fit`` calls
``on_epoch_start`` / ``on_epoch_end`` around each epoch and
``on_fit_end`` once (a duck-typed listener without it is tolerated).
The step graphs write the live parameter, optimizer and state tensors
in place, so a listener that keeps one of them after its first
dispatch of a fit raises (`_check_donation_aliases`): it must snapshot.

Self-healing hooks.  Every per-batch fit routes through `_fit_one` and
every grouped one through `_fit_group`, where an attached
`train.recovery.RecoveryPolicy` wraps the step; a pull that fails at
``data.next_batch`` / ``data.decode`` goes to the policy's quarantine
(`_timed_batches`) before it ends the fit.  ``fit`` creates the step
watchdog at entry (`_ensure_watchdog`, `runtime/flags.py`), which the
step scope arms around each program.
"""

from __future__ import annotations

import functools
import logging
import threading
import time

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.data.dataset import map_batch
from deeplearning4j_tpu_torch.nn.updaters import advance_counts
from deeplearning4j_tpu_torch.observe.trace import step_scope, tracer
from deeplearning4j_tpu_torch.ops.dequant_matmul import counting_selections
from deeplearning4j_tpu_torch.quant.ptq import SCHEME
from deeplearning4j_tpu_torch.quant.qtensor import QuantizedTensor
from deeplearning4j_tpu_torch.runtime import compile_stats as _cs
from deeplearning4j_tpu_torch.runtime import faults

log = logging.getLogger("deeplearning4j_tpu_torch")


class _LazyScores:
    """The K losses of one step program, fetched to the host at most
    once: by the first listener that reads a score (one copy for the
    group), never when no listener reads one.  Holds the program's own
    loss tensor, which no later step writes."""

    __slots__ = ("_device", "_host")

    def __init__(self, device_losses):
        self._device = device_losses
        self._host = None

    def fetch(self) -> np.ndarray:
        if self._host is None:
            self._host = self._device.detach().float().cpu().numpy().reshape(-1)
            self._device = None
        return self._host

    def __getitem__(self, i: int) -> "_LazyScore":
        return _LazyScore(self, i)


class _LazyScore:
    """One step's score of a `_LazyScores` group: it converts, formats,
    compares and does arithmetic like the float a listener expects, and
    fetches the group at the first such read."""

    __slots__ = ("_group", "_i")

    def __init__(self, group: _LazyScores, i: int):
        self._group = group
        self._i = i

    def __float__(self) -> float:
        return float(self._group.fetch()[self._i])

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self._group.fetch()[self._i])
        return a.astype(dtype) if dtype is not None else a

    def __format__(self, spec: str) -> str:
        return format(float(self), spec)

    def __repr__(self) -> str:
        return repr(float(self))

    def __bool__(self) -> bool:
        return bool(float(self))

    def __int__(self) -> int:
        return int(float(self))

    def __lt__(self, other):
        return float(self) < other

    def __le__(self, other):
        return float(self) <= other

    def __gt__(self, other):
        return float(self) > other

    def __ge__(self, other):
        return float(self) >= other

    def __eq__(self, other):
        return float(self) == other

    def __ne__(self, other):
        return float(self) != other

    def __hash__(self):
        return hash(float(self))

    def __add__(self, other):
        return float(self) + other

    __radd__ = __add__

    def __sub__(self, other):
        return float(self) - other

    def __rsub__(self, other):
        return other - float(self)

    def __mul__(self, other):
        return float(self) * other

    __rmul__ = __mul__

    def __truediv__(self, other):
        return float(self) / other

    def __rtruediv__(self, other):
        return other / float(self)

    def __neg__(self):
        return -float(self)

    def __abs__(self):
        return abs(float(self))


# -- parameter trees -------------------------------------------------------------

class QuantizedLeaf(nn.Module):
    """One `QuantizedTensor` of the tree: int8 ``q`` and f32 ``scale`` as
    buffers (an int8 tensor cannot be a parameter that requires grad)."""

    def __init__(self, qt: QuantizedTensor):
        super().__init__()
        self.register_buffer("q", qt.q)
        self.register_buffer("scale", qt.scale)

    def tree(self) -> QuantizedTensor:
        return QuantizedTensor(self.q, self.scale)


class ParamTree(nn.Module):
    """A nested parameter dict as a module: tensors become parameters,
    `QuantizedTensor` leaves `QuantizedLeaf` buffers, dicts child
    modules."""

    def __init__(self, tree: dict):
        super().__init__()
        for key, val in tree.items():
            if isinstance(val, dict):
                self.add_module(key, ParamTree(val))
            elif isinstance(val, QuantizedTensor):
                self.add_module(key, QuantizedLeaf(val))
            else:
                self.register_parameter(key, nn.Parameter(val))

    def tree(self) -> dict:
        out = dict(self._parameters)
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


def as_tensor(x, device) -> torch.Tensor:
    """A tensor on ``device``; array-likes are copied first, so read-only
    numpy arrays (a JAX array's ``np.asarray`` view) are fine."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)


def _tree_map(fn, tree: dict) -> dict:
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, lists and tuples in ``jax.tree.leaves``
    order: dict keys sorted at every level, a `QuantizedTensor` as its
    ``q`` then its ``scale``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    if isinstance(tree, QuantizedTensor):
        return [tree.q, tree.scale]
    return [tree]


def tree_unflatten(tree, leaves):
    """``tree`` with its leaves replaced, in `tree_leaves` order, by
    ``leaves``."""
    it = iter(leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if isinstance(node, QuantizedTensor):
            return QuantizedTensor(next(it), next(it))
        return next(it)

    return walk(tree)


def _has_quantized(tree: dict) -> bool:
    return any(_has_quantized(v) if isinstance(v, dict)
               else isinstance(v, QuantizedTensor) for v in tree.values())


def _as_quantized(leaf, path: str) -> QuantizedTensor:
    """A `QuantizedTensor` from any leaf with ``.q`` and ``.scale``
    arrays, its bits unchanged: ``q`` must be int8 and ``scale`` f32 of
    shape ``(q.shape[-1],)``.  Tensors stay on their device (a staged
    push on the card is not copied through the host)."""
    q, scale = (x.detach() if isinstance(x, torch.Tensor)
                else torch.from_numpy(np.array(x)) for x in (leaf.q, leaf.scale))
    if q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"{path}: a quantized leaf needs int8 q and f32 scale, "
                        f"got {q.dtype} and {scale.dtype}")
    if q.dim() < 1 or tuple(scale.shape) != (q.shape[-1],):
        raise ValueError(f"{path}: scale shape {tuple(scale.shape)} does not "
                         f"match q {tuple(q.shape)}")
    return QuantizedTensor(q.contiguous(), scale.contiguous())


def _batch_nbytes(batch) -> int:
    """The array bytes of a `DataSet` / `MultiDataSet` (a metadata read
    of numpy arrays and tensors alike: nothing is copied or synced)."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet

    def nb(a):
        return int(getattr(a, "nbytes", 0) or 0) if a is not None else 0

    if isinstance(batch, DataSet):
        return (nb(batch.features) + nb(batch.labels)
                + nb(batch.features_mask) + nb(batch.labels_mask))
    if isinstance(batch, MultiDataSet):
        total = sum(nb(a) for a in batch.features) + sum(nb(a) for a in batch.labels)
        for group in (batch.features_masks, batch.labels_masks):
            if group is not None:
                total += sum(nb(a) for a in group)
        return total
    return 0


def _copy_state(dst: dict, src: dict) -> None:
    """Write the layers' new state ``src`` over ``dst`` in place (the
    tensors a captured step reads stay the same objects)."""
    for name, leaves in src.items():
        for k, v in leaves.items():
            dst[name][k].copy_(v)


def _clone_state(state):
    if isinstance(state, dict):
        return {k: _clone_state(v) for k, v in state.items()}
    if isinstance(state, tuple):
        return tuple(_clone_state(s) for s in state)
    if isinstance(state, list):
        return [_clone_state(s) for s in state]
    if isinstance(state, torch.Tensor):
        return state.clone()
    return state


class _Staged:
    """A step group's inputs on the card: each of the step's arrays
    (`Model._batch_arrays`) stacked over the group's K batches, and the
    nodes' keys (n, nodes, 2) and the updater's step values (n, ...) of
    its n optimizer steps (K, or K x the windows of a truncated-BPTT
    batch), one host-to-device copy each.  The copies are made from
    pinned memory without waiting on the card (a pageable copy would
    wait for every step queued before it); arrays already on the card
    are stacked there.  With a lowered ``decode`` (the fused step) a
    batch's arrays are its raw features and labels and its decode keys
    (`Model._step_arrays`)."""

    def __init__(self, model, batches, n_steps: int | None = None, decode=None):
        dev = model.device

        def upload(t: torch.Tensor) -> torch.Tensor:
            if dev.type != "cuda":
                return t.to(dev)
            return t.pin_memory().to(dev, non_blocking=True)

        def stack(arrays):
            if arrays[0] is None:
                return None
            if isinstance(arrays[0], torch.Tensor):
                if all(a.device.type == dev.type for a in arrays):
                    return torch.stack([a.to(dev) for a in arrays])
                return upload(torch.stack([a.cpu() for a in arrays]))
            return upload(torch.from_numpy(np.stack([np.asarray(a) for a in arrays])))

        self.arrays = [stack(col) for col in zip(*(
            model._step_arrays(b, decode, model.iteration + i)
            for i, b in enumerate(batches)))]
        keys, vals, state = [], [], model.opt_state
        n = len(batches) if n_steps is None else n_steps
        for i in range(n):
            keys.append(model._step_keys(model.iteration + i))
            vals.append(model._tx.values(state))
            state = advance_counts(state)
        self.keys = upload(torch.tensor(keys, dtype=torch.int64))
        self.vals = upload(torch.from_numpy(np.asarray(vals, np.float32).reshape(
            n, len(vals[0]))))

    def step(self, i: int) -> tuple:
        """Step i's arrays (None where absent), keys and step values."""
        return tuple(None if a is None else a[i] for a in self.arrays) + (
            self.keys[i], self.vals[i])


def _poison_batch(batch):
    """The ``data.decode`` 'corrupt' action: a copy of the batch with
    every float feature and label array NaN-filled, shapes, dtypes and
    devices kept (a prefetched batch's tensors stay where they were
    staged); masks are left alone (a corrupt record keeps its framing)."""
    def bad(a):
        if isinstance(a, torch.Tensor):
            a = a.clone()
            if a.is_floating_point():
                a.fill_(float("nan"))
            return a
        a = np.array(a, copy=True)
        if np.issubdtype(a.dtype, np.floating):
            a.fill(np.nan)
        return a

    return map_batch(batch, bad, masks=False)


class Model(nn.Module):
    """The surface and the step machinery `SequentialModel` and
    `GraphModel` share with the JAX package's model classes."""

    # data parallelism (parallel/data_parallel.py `distribute`): the mesh,
    # this rank's rows, the ZeRO placement and the compressed exchange's
    # state; None on an undistributed model
    _mesh = None
    _batch_sharding = None
    _zero_placement = None
    _shard_placement = None
    _grad_compression = None
    _grad_residual = None
    # pipeline parallelism (parallel/pipeline.py): the plan of the
    # pipelined segment and the schedule; None on a model without a pipe
    # axis
    _pipeline_plan = None
    _pipeline_schedule = "gpipe"

    def __init__(self):
        super().__init__()
        self.opt_state = None
        self.net_state = None          # non-trained state (BatchNorm stats)
        self.iteration = 0
        self.epoch = 0
        self.last_batch_size = 0
        self._last_score = None
        # seconds fit() sat blocked on its input iterator
        self.etl_wait_s = 0.0
        self.last_etl_wait_s = 0.0
        # prefetch producer seconds the consumer did not wait for: the
        # total, the last batch's, and what the next step span drains
        self.overlap_s = 0.0
        self.last_overlap_s = 0.0
        self._overlap_accum = 0.0
        self._compile_snap = _cs.snapshot()   # baseline at model creation
        self.layers = nn.ModuleDict()
        # layers whose weights stay f32 in the compute tree (the MoE layer)
        self.f32_layers = frozenset()
        self._compute = None
        self._quantized = None         # the scheme marker of a quantized tree
        # top-level tree keys of frozen layers (set by the model class)
        self._frozen = frozenset()
        # the training step's CUDA graphs, one a batch signature; on the
        # card a step replays one unless `capture_steps` is False
        self._captured: dict = {}
        self.capture_steps = True
        # programs registered with the cost registry (observe/cost.py) on
        # first use; `_cost_program`: the record of the last program
        # dispatched (StepScope.sync() snapshots it)
        self._step_fns: dict = {}
        self._cost_program = None
        # (program kind, int8?, input signature) of every program run so
        # far: where the JAX package would trace (`program_run`)
        self._program_signatures: set = set()
        self._signatures_lock = threading.Lock()
        self.listeners: list = []
        # one check a fit: no listener keeps a live tree (re-armed by fit)
        self._donation_checked = True
        # the StepWatchdog the step scopes arm (made at fit entry), and
        # the RecoveryPolicy the fit chokepoints route through
        self._watchdog = None
        self._recovery = None
        # step programs run so far (a grouped program counts once): what
        # a listener compares to tell a new update from a group's next
        # dispatch
        self.step_programs_run = 0
        # True while the updater writes the live trees in place: a
        # failure then leaves them torn (RecoveryPolicy restores them)
        self._updating = False
        # the lowered transform chain of the running fit's raw feed
        self._device_decode = None

    # -- listeners ------------------------------------------------------------
    def set_listeners(self, *listeners) -> None:
        self.listeners = list(listeners)

    def add_listener(self, listener) -> None:
        self.listeners.append(listener)

    def _dispatch_iteration(self, score) -> None:
        for lst in self.listeners:
            lst.iteration_done(self, self.iteration, self.epoch, score)
        if not self._donation_checked:
            # after the first dispatch of a fit: a stash a listener just
            # took still holds the live tensors, and the next step has
            # not overwritten them yet
            self._donation_checked = True
            if self.listeners:
                self._check_donation_aliases()

    def _finish_steps(self, losses: torch.Tensor, k: int) -> None:
        """Bookkeeping after a program of k optimizer steps (JAX
        ``_finish_grouped_steps``): the score, ``iteration``, and one
        listener dispatch a step with lazy scores over ``losses`` (the
        program's own (k,) loss tensor).  A listener that raises leaves
        ``iteration`` counting all k steps: they ran."""
        last = losses if k > 1 else losses[0]
        self._last_score = last
        self.step_programs_run += 1
        if not self.listeners:
            self.iteration += k
            return
        lazy = _LazyScores(losses)
        done = 0
        try:
            with tracer().span("listeners", cat="step_phase"):
                for w in range(k):
                    self._last_score = lazy[w]
                    self.iteration += 1
                    done += 1
                    self._dispatch_iteration(lazy[w])
        finally:
            self.iteration += k - done
            self._last_score = last

    def _check_donation_aliases(self) -> None:
        """The JAX package's donation guard, for in-place replays: the
        next step writes the live parameter, optimizer and state tensors
        in place, so a listener that keeps one of them (or a view of its
        storage) in a public attribute after its first dispatch would
        read later steps' values as its own.  Private (underscore)
        attributes are trusted to copy (`HealthListener` does)."""
        live_ids, live_ptrs = set(), set()
        trees = (self.params, self.net_state, self.opt_state)
        for t in _tensors(trees):
            live_ids.add(id(t))
            if t.numel():
                live_ptrs.add(t.untyped_storage().data_ptr())
        for lst in self.listeners:
            attrs = getattr(lst, "__dict__", None) or {}
            for attr, value in attrs.items():
                if attr.startswith("_"):
                    continue
                for t in _tensors(value):
                    if id(t) in live_ids or (
                            t.numel() and t.untyped_storage().data_ptr() in live_ptrs):
                        raise RuntimeError(
                            f"listener {type(lst).__name__}.{attr} holds the "
                            "model's live parameter / optimizer / state tensors; "
                            "the next training step overwrites them in place, "
                            "so it would read later steps' values.  Copy "
                            "instead (t.detach().clone(), .cpu().numpy()) or "
                            "snapshot with train.listeners._host_snapshot.")

    # -- the fit loop's batch pull ----------------------------------------------
    def _timed_batches(self, iterator):
        """Iterate ``iterator`` through the fault sites, charging the time
        blocked on ``next()`` to ``etl_wait_s`` and a prefetched batch's
        hidden producer seconds to ``overlap_s``."""
        from deeplearning4j_tpu_torch.observe.metrics import registry

        reg = registry()
        wait_total = reg.counter("dl4jtpu_etl_wait_seconds_total")
        batches_total = reg.counter("dl4jtpu_etl_batches_total")
        h2d_total = reg.counter("dl4jtpu_h2d_bytes_total")
        overlap_total = reg.counter("dl4jtpu_prefetch_overlap_seconds_total")
        it = iter(iterator)
        absorbed_pull_failure = False
        no_batch = object()
        while True:
            t0 = time.perf_counter()
            batch = no_batch
            try:
                faults.maybe_fail("data.next_batch")
                batch = next(it)
                # after the pull, so a raise never tears the iterator's frame
                if faults.maybe_fail("data.decode") == "corrupt":
                    batch = _poison_batch(batch)
                absorbed_pull_failure = False
            except StopIteration:
                if absorbed_pull_failure:
                    # a generator cannot resume after raising: the
                    # quarantined pull may have ended the feed early
                    log.warning(
                        "feed ended right after a quarantined pull failure; "
                        "a generator-backed iterator cannot resume, so any "
                        "batches left in this epoch were skipped")
                return
            except Exception as exc:
                # the policy declines failures that are not poison
                # (recovery.NON_POISON_ERRORS) and they re-raise; a failure
                # at the decode boundary hands it the pulled batch, so the
                # quarantine record carries its bytes
                recov = self._recovery
                if recov is not None and recov.quarantine_pull_failure(
                        self, exc, batch=None if batch is no_batch else batch):
                    absorbed_pull_failure = True
                    continue
                raise
            wait = time.perf_counter() - t0
            batches_total.inc()
            source = getattr(batch, "_etl_source", None)
            if source is not None:
                # a cache replay's pull is page-cache time, not a starved
                # pipeline: its own series, not the ETL wait
                self.last_etl_wait_s = 0.0
                wait_total.inc(wait, source=source)
            else:
                self.last_etl_wait_s = wait
                self.etl_wait_s += wait
                wait_total.inc(wait)
            nbytes = _batch_nbytes(batch)
            if nbytes:
                h2d_total.inc(nbytes, feed="raw" if getattr(
                    batch, "_raw_for_device_decode", False) else "decoded")
            stage_s = getattr(batch, "_prefetch_stage_s", None)
            if stage_s is not None:
                # producer work not paid again as consumer wait
                overlap = max(0.0, stage_s - wait)
                self.last_overlap_s = overlap
                self.overlap_s += overlap
                self._overlap_accum += overlap
                if overlap > 0:
                    overlap_total.inc(overlap)
            else:
                self.last_overlap_s = 0.0
            yield batch

    def _fit_one(self, batch) -> None:
        """The one-batch chokepoint every per-batch fit routes through:
        `fit_batch`, or the attached `RecoveryPolicy`'s envelope (skip
        window, input scan, OOM split, divergence rollback)."""
        recov = self._recovery
        if recov is None:
            self.fit_batch(batch)
        else:
            recov.run_step(self, batch)

    def _fit_group(self, batches, runner) -> None:
        """The grouped chokepoint (``steps_per_execution``):
        ``runner(batches)`` runs the K-step program, wrapped by the
        attached `RecoveryPolicy`."""
        recov = self._recovery
        if recov is None:
            runner(batches)
        else:
            recov.run_group(self, batches, runner)

    def _ensure_watchdog(self):
        """This model's `StepWatchdog`, made at fit entry (once) when
        ``environment().watchdog_enabled``; the step scopes arm it around
        every program.  One monitor thread serves every watchdog."""
        if self._watchdog is None:
            from deeplearning4j_tpu_torch.runtime.flags import environment

            env = environment()
            if env.watchdog_enabled:
                from deeplearning4j_tpu_torch.runtime.watchdog import StepWatchdog

                self._watchdog = StepWatchdog(
                    floor_s=env.watchdog_floor_s, k=env.watchdog_k,
                    name=type(self).__name__)
        return self._watchdog

    # -- the device data pipeline -------------------------------------------------
    def _fused_decode_reason(self, steps_per_execution: int = 1) -> str | None:
        """Why this model's fit cannot run a transform chain inside its
        step, or None (the model classes name their variants)."""
        return None

    def _device_decode_feed(self, iterator, unsupported_reason=None):
        """``(feed, decode)`` at fit entry: the raw feed and the lowered
        `DeviceDecode` when ``iterator`` advertises a chain that lowers
        and the fit can fuse it; else ``(iterator, None)``, whose own
        iteration applies the chain on the host.  Flag off is silent;
        every other fallback logs its reason and counts it."""
        from deeplearning4j_tpu_torch.datavec import device as dv
        from deeplearning4j_tpu_torch.runtime.flags import environment

        if not environment().device_decode:
            return iterator, None
        chain = dv.chain_of(iterator)
        if chain is None:
            return iterator, None
        reason, decode = unsupported_reason, None
        if reason is None:
            decode, reason = dv.try_lower(chain)
        if decode is None:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            log.info("device decode fallback (transforms stay on the host): %s", reason)
            registry().counter("dl4jtpu_device_decode_fallbacks_total").inc(reason=reason)
            return iterator, None
        return dv.raw_feed(iterator, decode), decode

    def _count_device_decode(self, decode, feats, labs, k: int = 1) -> None:
        """A fused dispatch's accounting: k batches, and k times the
        standalone decode's calibrated seconds for this signature (a
        calibration that fails is logged, never raised: it is
        attribution)."""
        from deeplearning4j_tpu_torch.observe.metrics import registry

        reg = registry()
        reg.counter("dl4jtpu_device_decode_batches_total").inc(k)
        try:
            secs = decode.calibrated_seconds(feats, labs)
        except Exception as e:
            log.debug("device-decode calibration skipped: %s", e)
            return
        reg.counter("dl4jtpu_device_decode_seconds_total").inc(secs * k)

    def _route(self, batch):
        """``(batch, decode)`` for a step: a raw-tagged batch of the fused
        fit as it is, with the lowered decode; a raw batch that carries
        masks decoded on the host (the fused step stages features and
        labels only); any other through `_as_batch`, with None."""
        from deeplearning4j_tpu_torch.data.dataset import DataSet

        decode = self._device_decode
        if decode is not None and getattr(batch, "_raw_for_device_decode", False):
            if not isinstance(batch, DataSet):
                raise TypeError("raw device-decode batch must be a DataSet, got "
                                f"{type(batch).__name__}")
            if batch.features_mask is None and batch.labels_mask is None:
                return batch, decode
            batch = decode.host(getattr(batch, "_decode_step", self.iteration), batch)
        return self._as_batch(batch), None

    def _step_arrays(self, batch, decode, step: int) -> tuple:
        """A step's array inputs: `_batch_arrays`, or for the fused step
        the raw features and labels and the decode keys of the batch's
        augmentation index (``step`` where it has none)."""
        if decode is None:
            return self._batch_arrays(batch)
        return (batch.features, batch.labels,
                decode.keys(getattr(batch, "_decode_step", step)))

    def _decoded_arrays(self, feats, labs, fmask, lmask) -> tuple:
        """`_batch_arrays` of a decoded batch (the model classes)."""
        raise NotImplementedError

    def _decode_inputs(self, decode, arrays) -> tuple:
        """The fused step's first stage: the raw features and labels and
        the staged decode keys in, the step's decoded arrays out.  A
        data-parallel rank decodes its block of the global batch (its
        first global row: the flip coins' offset)."""
        raw_f, raw_l, dkeys = (as_tensor(a, self.device) for a in arrays)
        bs = self._batch_sharding
        offset = 0 if bs is None else bs.rank * raw_f.shape[0]
        return self._decoded_arrays(*decode.fn(None, raw_f, raw_l, keys=dkeys,
                                               row_offset=offset))

    def _prefetch_feed(self, iterator):
        """``iterator`` wrapped in a `PrefetchIterator` staging onto this
        model's device, ``environment().prefetch_depth`` deep (0: no
        wrap).  The caller closes a returned feed that is not
        ``iterator``.  Already pipelined feeds, and in-memory ones
        (`ExistingDataSetIterator`, `NumpyDataSetIterator`, lists and
        tuples: every ``fit([batch, ...])`` or ``fit((x, y))``), are
        returned as they are: they have no per-batch decode to hide.
        Wrap such a feed yourself to overlap its host-to-device copies."""
        from deeplearning4j_tpu_torch.data.iterator import (
            AsyncDataSetIterator,
            ExistingDataSetIterator,
            NumpyDataSetIterator,
        )
        from deeplearning4j_tpu_torch.data.prefetch import PrefetchIterator
        from deeplearning4j_tpu_torch.runtime.flags import environment

        depth = environment().prefetch_depth
        if depth <= 0 or isinstance(iterator, (
                PrefetchIterator, AsyncDataSetIterator, ExistingDataSetIterator,
                NumpyDataSetIterator, list, tuple)):
            return iterator
        return PrefetchIterator(iterator, depth=depth, device=self.device)

    # -- accounting ---------------------------------------------------------------
    @property
    def score_value(self) -> float:
        """Last training loss, penalty included (reference `Model.score()`);
        synchronises with the device.  A grouped fit's score is the
        group's last step's."""
        s = self._last_score
        if s is None:
            return float("nan")
        if isinstance(s, _LazyScore):
            return float(s)
        return float(s.detach().float().cpu().numpy().ravel()[-1])

    def num_params(self) -> int:
        if self.params is None:
            raise RuntimeError("model not initialized; call init()")
        return sum(int(np.prod(t.shape)) for t in tree_leaves(self.params))

    def param_table(self) -> dict[str, np.ndarray]:
        """Flattened ``"layer.param"`` -> array view (the reference's
        ``paramTable()``), keys as the JAX package writes them, in its
        path order."""
        out = {}

        def walk(node, path):
            for k in sorted(node):
                v, p = node[k], f"{path}.{k}" if path else k
                if isinstance(v, dict):
                    walk(v, p)
                elif hasattr(v, "q") and hasattr(v, "scale"):
                    out[p + ".q"] = v.q.detach().cpu().numpy()
                    out[p + ".scale"] = v.scale.detach().cpu().numpy()
                else:
                    out[p] = v.detach().cpu().numpy()

        walk(self.params, "")
        return out

    def compile_stats(self) -> dict:
        """Compile taxes since this model was built (`runtime/
        compile_stats.py`: graph captures, ``nvcc`` runs, library hits),
        plus ``step_programs``: the CUDA graphs this model holds for its
        training step, one a batch signature."""
        d = (_cs.snapshot() - self._compile_snap).as_dict()
        d["step_programs"] = len(self._captured)
        return d

    def save(self, path: str, save_updater: bool = True) -> None:
        from deeplearning4j_tpu_torch.train.checkpoint import ModelSerializer

        ModelSerializer.write_model(self, path, save_updater)

    # -- the parameter tree -------------------------------------------------------
    @property
    def compute_dtype(self) -> torch.dtype:
        if self._bf16 and self._quantized is None:
            return torch.bfloat16
        return torch.float32

    @property
    def params(self):
        """The parameter tree: f32 tensors, and `QuantizedTensor` leaves
        in a quantized model (None before `init`)."""
        if not self.layers:
            return None
        return {name: m.tree() for name, m in self.layers.items()}

    @torch.no_grad()
    def load_params(self, tree: dict):
        """Install a parameter tree of array-likes, checked name for name
        and shape for shape against what `init` would create.  A leaf
        with ``.q`` and ``.scale`` arrays (a `QuantizedTensor`, or the
        JAX package's after ``jax.tree.map(np.asarray, ...)``) is
        installed bit for bit as an int8 weight and its f32 scales."""
        if self.params is None:
            self.init()
        self._install(self._checked(self.params, tree, quantized_ok=True))
        return self

    @torch.no_grad()
    def load_net_state(self, tree: dict):
        """Install a layer-state tree (BatchNorm's running stats) of
        array-likes, checked against what `init` creates."""
        if self.params is None:
            self.init()
        self.net_state = _tree_map(lambda t: t.to(self.device),
                                   self._checked(self.net_state, tree))
        self._drop_graphs()
        return self

    def _checked(self, want: dict, got: dict, quantized_ok=False) -> dict:
        def walk(w, g, path):
            if set(w) != set(g):
                raise ValueError(
                    f"names differ at {path or '<root>'}: "
                    f"want {sorted(w)}, got {sorted(g)}")
            out = {}
            for k, v in w.items():
                p = f"{path}/{k}" if path else k
                if isinstance(v, dict):
                    out[k] = walk(v, g[k], p)
                    continue
                t = g[k]
                if quantized_ok and hasattr(t, "q") and hasattr(t, "scale"):
                    t = _as_quantized(t, p)
                else:
                    t = (t.detach().float() if isinstance(t, torch.Tensor)
                         else torch.from_numpy(np.array(t, dtype=np.float32))
                         ).contiguous()
                if tuple(t.shape) != tuple(v.shape):
                    raise ValueError(f"{p}: shape {tuple(t.shape)} != "
                                     f"{tuple(v.shape)}")
                out[k] = t
            return out

        return walk(want, got, "")

    def _install(self, tree: dict) -> None:
        """Make ``tree`` the model's parameters (`init`, `load_params`,
        a restore): the compute copy, the optimizer state and the step
        graphs belonged to the old tensors and go."""
        tree = _tree_map(lambda t: t.to(self.device), tree)
        self.layers = nn.ModuleDict(
            {name: ParamTree(p) for name, p in tree.items()})
        self._compute = None
        self.opt_state = None
        self._drop_graphs()
        self._quantized = ({"scheme": SCHEME} if _has_quantized(tree)
                           else None)

    def _drop_graphs(self) -> None:
        """Forget the step graphs: they read tensors that are no longer
        the model's.  The next step of each signature captures anew."""
        self._captured = {}

    def compute_params(self) -> dict:
        """The parameter tree in the compute dtype, detached (cached;
        rebuilt after `init`, `load_params` and every training step).
        `QuantizedTensor` leaves stay as they are."""
        if self._compute is None:
            self._compute = self.cast_tree(self.params)
        return self._compute

    def cast_tree(self, tree: dict, detach: bool = True) -> dict:
        """``tree`` cast to the compute dtype, as the layers see it: the
        ``F32_PARAMS`` layers (the MoE layer) keep f32 and `QuantizedTensor`
        leaves stay as they are (a quantized model computes in f32).
        Detached unless ``detach`` is False (the training step
        differentiates through the cast)."""
        def cast(dt):
            def leaf(t):
                if isinstance(t, QuantizedTensor):
                    return t
                return (t.detach() if detach else t).to(dt)
            return leaf

        return {k: _tree_map(cast(torch.float32 if k in self.f32_layers
                                  else self.compute_dtype), v)
                for k, v in tree.items()}

    def program_run(self, kind: str, *signature):
        """The scope of one run of program ``kind`` at input ``signature``
        (shapes only) over this model's kind of tree (int8 or float).
        Its quantized sites count their implementation on the first run
        only: where the JAX package traces the program."""
        key = (kind, self._quantized is not None) + signature
        with self._signatures_lock:
            first = key not in self._program_signatures
            self._program_signatures.add(key)
        return counting_selections(first)

    def clone(self):
        """A model of the same configuration and device with copies of
        the parameters, layer state, optimizer state and counters."""
        m = type(self)(self.conf, device=self.device)
        if self.params is not None:
            m._install(_tree_map(lambda t: t if isinstance(t, QuantizedTensor)
                                 else t.detach().clone(), self.params))
            m._quantized = self._quantized
            m.net_state = _tree_map(lambda t: t.clone(), self.net_state)
            if self.opt_state is not None:
                m.opt_state = _clone_state(self.opt_state)
        m.iteration, m.epoch = self.iteration, self.epoch
        return m

    # -- training -------------------------------------------------------------
    def _step_program(self, decode=None):
        """The training step's pure device program, `_grad_step`,
        registered with the cost registry on first use (as the JAX
        package's ``_get_step_fn`` registers its jitted step), under
        ``("train",)`` and `_step_key_suffix`; a fused fit's under
        ``("train_fused", the chain's fingerprint)`` (its decode stage
        is the ``"decode"`` program, `DeviceDecode.program`)."""
        key = (("train",) if decode is None
               else ("train_fused", decode.fingerprint)) + self._step_key_suffix()
        fn = self._step_fns.get(key)
        if fn is None:
            from deeplearning4j_tpu_torch.observe import cost

            fn = self._step_fns[key] = cost.register_step_program(
                self, key, self._grad_step)
        return fn

    def _step_key_suffix(self) -> tuple:
        """Program-key markers of step variants (JAX
        ``_step_key_suffix``): ``zero1``, or ``zero2x{m}`` for ZeRO-2
        with m microbatches."""
        zero = self._zero_placement
        if zero is None:
            return ()
        accum = getattr(zero, "accum", None)
        return (f"zero2x{accum}",) if accum is not None else ("zero1",)

    def _step_keys(self, step: int) -> list:
        """The random keys of optimizer step ``step``: the nodes' dropout
        keys (`_layer_keys`).  Under ZeRO-2 with m microbatches, m sets
        of them, microbatch i's from ``fold(fold(root, step), i)`` (JAX
        ``scan_accumulate``'s); under the compressed exchange, this
        rank's keys from ``fold_in(fold(root, step), rank)`` and the
        quantizer's key ``fold_in(that, 0x51)`` last (JAX's
        per-shard keys)."""
        from deeplearning4j_tpu_torch.runtime import rng

        if self._grad_compression:
            base = rng.fold_in(rng.SeedStream.fold(self._stream.root, step),
                               self._batch_sharding.rank)
            return self._keys_from(base) + [rng.fold_in(base, 0x51)]
        accum = getattr(self._zero_placement, "accum", 1)
        if accum > 1:
            base = rng.SeedStream.fold(self._stream.root, step)
            return [k for i in range(accum)
                    for k in self._keys_from(rng.SeedStream.fold(base, i))]
        return self._layer_keys(step)

    def _keys_from(self, key) -> list:
        """The nodes' keys derived from one step key: node i's is
        ``fold_in(key, i)``."""
        from deeplearning4j_tpu_torch.runtime import rng

        return [rng.fold_in(key, i) for i in range(len(self._layer_keys(0)))]

    def _trainable_leaves(self, params: dict) -> list:
        """The leaves the optimizer trains, in ``jax.tree.leaves`` order:
        every leaf but the frozen layers' (the leaves optax's ``masked``
        keeps state for)."""
        if not self._frozen:
            return tree_leaves(params)
        return tree_leaves({k: v for k, v in params.items()
                            if k not in self._frozen})

    def _init_opt_state(self):
        """A fresh optimizer state over the trainable leaves."""
        return self._tx.init(self._trainable_leaves(self.params))

    def _grad_step(self, params: dict, net_state: dict, *inputs, loss=None):
        """Loss, gradients of the trainable leaves (`_trainable_leaves`
        order, zeros for an unused leaf) and the layers' new state on one
        batch (``inputs``: `_batch_arrays`, then the keys): the step's
        forward and backward, and no state changed — the update applies
        them.  A frozen layer's leaves enter the forward detached, so
        nothing before the first trainable layer records a backward.
        ``loss``: the objective (`_step_loss` by default); whatever it
        returns after the loss and the state (a truncated-BPTT window's
        new carries, detached) is returned after them.  Pure, so the cost
        analysis can run it again."""
        plist = self._trainable_leaves(params)
        if self._frozen:
            params = {k: _tree_map(torch.Tensor.detach, v) if k in self._frozen
                      else v for k, v in params.items()}
        with torch.enable_grad(), self.mesh_scope():
            value, new_state, *extra = (loss or self._step_loss)(
                params, net_state, *inputs)
            grads = torch.autograd.grad(value, plist, allow_unused=True)
        return (value, [torch.zeros_like(p) if g is None else g
                        for p, g in zip(plist, grads)],
                _tree_map(lambda t: t.detach(), new_state), *extra)

    def _train_step(self, *inputs, grad_step=None, decode=None):
        """One whole step on the live trees: `_grad_step`, the updater,
        the parameters and the layer state updated in place.
        ``inputs``: the batch's arrays (`_step_arrays`), the nodes'
        dropout keys (`_layer_keys`, or their (nodes, 2) int64 device
        tensor) and the updater's step values (None: the updater computes
        them as Python floats; else a device tensor).  ``decode``: the
        fused step's lowered chain, run first on the raw arrays
        (`_decode_inputs`).  ``grad_step``: the forward and backward to
        run (the registered `_step_program`, which counts a dispatch, by
        default).  Returns the loss and the updater's new state (its
        counts advanced), then whatever else the grad step returned."""
        *arrays, keys, vals = inputs
        if decode is not None:
            arrays = self._decode_inputs(decode, arrays)
        if isinstance(keys, torch.Tensor):
            keys = [(k[0], k[1]) for k in keys]
        if vals is not None:
            vals = [vals[i] for i in range(vals.shape[0])]
        params = self.params
        plist = self._trainable_leaves(params)
        grad_step = grad_step or self._step_program(decode)
        accumulated = False
        if self._mesh is None:
            loss, grads, new_state, *extra = grad_step(
                params, self.net_state, *arrays, keys)
        else:
            loss, grads, new_state, extra, accumulated = self._dp_grads(
                grad_step, params, arrays, keys)
        # from here the live trees are written in place: a failure
        # leaves them torn until `_updating` clears
        self._updating = True
        opt_state = self._apply_grads(plist, self.opt_state, grads, vals,
                                      accumulated)
        with torch.no_grad():
            _copy_state(self.net_state, new_state)
        self._updating = False
        return (loss.detach(), opt_state, *extra)

    def _apply_grads(self, plist, opt_state, grads, vals=None, accumulated=False):
        """The update epilogue every step runs (JAX ``_apply_grads``): the
        updater, and ``plist`` updated in place; under ZeRO the sharded
        epilogue (`parallel/zero.py`).  Returns the new updater state."""
        zero = self._zero_placement
        if zero is not None:
            return zero.apply(self._tx, plist, opt_state, grads, vals, accumulated)
        updates, opt_state = self._tx.update(grads, opt_state, plist, vals)
        with torch.no_grad():
            for p, u in zip(plist, updates):
                p.add_(u.to(p.dtype))
        return opt_state

    # -- data parallelism ---------------------------------------------------------
    def mesh_scope(self, *trees):
        """The model's mesh as the active one (`runtime/mesh.py`): the
        layers' collectives run over its axes' groups, and a layer reads
        which axis splits a leaf of ``trees`` (parameter trees: the
        masters, or a compute copy of them) with `leaf_axis`."""
        from deeplearning4j_tpu_torch.runtime.mesh import active_mesh_scope

        splits = {}
        for tree in trees:
            splits.update(self._split_axes(tree) or {})
        return active_mesh_scope(self._mesh, splits)

    def _split_axes(self, params) -> dict | None:
        """{id of a leaf of ``params``: the axis that splits it} under
        tensor or expert parallelism, else None."""
        sp = self._shard_placement
        if sp is None:
            return None
        return {id(t): s[0] for t, s in zip(tree_leaves(params), sp.splits)
                if s is not None}

    def undistributed(self):
        """A scope in which the model runs as one process would: no mesh,
        no rows, no pipeline plan (the planner counts the undistributed
        step); everything is as it was after it."""
        import contextlib

        names = ("_mesh", "_batch_sharding", "_pipeline_plan")

        @contextlib.contextmanager
        def scope():
            saved = {k: self.__dict__[k] for k in names if k in self.__dict__}
            for k in names:
                setattr(self, k, None)
            try:
                yield self
            finally:
                for k in names:
                    if k in saved:
                        setattr(self, k, saved[k])
                    else:
                        self.__dict__.pop(k, None)

        return scope()

    def full_params(self) -> dict:
        """The parameter tree whole: a model-parallel model's slices
        gathered over their axes (a collective: every rank calls it),
        else `params` itself."""
        if self._shard_placement is None:
            return self.params
        with torch.no_grad():
            return self._shard_placement.gather_tree(self.params)

    def _dp_grads(self, grad_step, params, arrays, keys):
        """The data-parallel step's forward, backward and gradient
        exchange on this rank's rows.  The exact step runs the grad step
        in a global `parallel.context` (global BatchNorm statistics,
        the rank's rows of the global dropout masks, the loss normalised
        by the global count), then sums the gradients and the loss over
        the ranks in one flat all-reduce; ZeRO-2 with m microbatches
        does so a microbatch, into its sharded accumulator.  The
        compressed step keeps the JAX package's per-shard semantics: the
        int8 exchange of the gradients, the loss and the layers' new
        state averaged over the ranks.  Returns (loss, grads, new state,
        extra outputs, accumulated)."""
        from deeplearning4j_tpu_torch.parallel.context import ROWS as dp_rows
        from deeplearning4j_tpu_torch.parallel.context import (
            DataParallelContext,
            dp_scope,
        )

        bs = self._batch_sharding
        rank, n = bs.rank, bs.n
        pipe = self._pipe_stage()
        # under a pipe axis the sum runs over the pipe line too: each
        # stage's blocks have their gradients on its rank
        rows = self._mesh.axes_group(dp_rows + (("pipe",) if pipe else ()))
        if self._grad_compression:
            from deeplearning4j_tpu_torch.parallel.compression import (
                quantized_allreduce_tree,
            )

            # no scope: local statistics and masks, per-rank keys
            *keys, qkey = keys
            loss, grads, new_state, *extra = grad_step(
                params, self.net_state, *arrays, keys)
            grads, res = quantized_allreduce_tree(grads, self._grad_residual, key=qkey)
            with torch.no_grad():
                for r, x in zip(self._grad_residual, res):
                    r.copy_(x)
            loss, new_state = _mean_over_ranks(loss, new_state, n)
            return loss, grads, new_state, extra, False
        ctx = DataParallelContext(rank, n, bs.seq_rank, bs.seq,
                                  pipe_last=pipe is None or pipe[0] == pipe[1] - 1)
        zp = self._zero_placement
        accum = getattr(zp, "accum", 1)
        if accum > 1:
            from deeplearning4j_tpu_torch.parallel.zero import (
                split_accum_microbatches,
            )

            per = len(keys) // accum

            def loss_grad_fn(state, micro, i):
                with dp_scope(ctx):
                    loss, grads, new_state = grad_step(
                        params, state, *micro, keys[i * per:(i + 1) * per])
                loss, grads = _sum_over_ranks(loss, grads, rows)
                return loss, {**state, **new_state}, grads

            loss, state = zp.scan_accumulate(
                loss_grad_fn, self.net_state,
                split_accum_microbatches(arrays, accum),
                self.opt_state["grad_accum"])
            return loss, None, state, [], True
        with dp_scope(ctx):
            loss, grads, new_state, *extra = grad_step(
                params, self.net_state, *arrays, keys)
        if pipe is not None and not ctx.pipe_last:
            loss, grads = self._pipe_share(loss, grads)
        loss, grads = _sum_over_ranks(loss, grads, rows)
        return loss, grads, new_state, extra, False

    def _pipe_stage(self):
        """(this rank's stage, the stage count) under pipeline
        parallelism, else None."""
        plan = self._pipeline_plan
        if plan is None or self._mesh is None or self._mesh.shape.get("pipe", 1) < 2:
            return None
        return self._mesh.axis_index("pipe"), plan.k

    def _pipe_share(self, loss, grads):
        """What a pipe rank off the last stage adds to the step's sum:
        its gradients of the pipelined blocks (its own stage's; zeros for
        the others') and nothing of the loss or the other layers'
        gradients, which every rank of the line computed alike (the last
        stage's count)."""
        blocks = self._block_leaf_index()
        return torch.zeros_like(loss), [
            g if i in blocks else torch.zeros_like(g) for i, g in enumerate(grads)]

    def _block_leaf_index(self) -> frozenset:
        """The positions, among the trainable leaves, of the pipelined
        blocks' leaves."""
        names = set(self._pipeline_plan.block_names)
        tree = self.params
        flags = tree_leaves({k: _tree_map(lambda t, b=(k in names): b, v)
                             for k, v in tree.items() if k not in self._frozen})
        return frozenset(i for i, b in enumerate(flags) if b)

    def _setup_grad_compression(self, mesh) -> None:
        """``distribute(ParallelConfig(grad_compression="int8"))``: the
        step exchanges gradients as error-feedback int8 from now on, with
        this rank's residual; a world of one keeps the plain step."""
        from deeplearning4j_tpu_torch.parallel.compression import zeros_residual
        from deeplearning4j_tpu_torch.runtime.mesh import DATA_AXIS

        if mesh.shape[DATA_AXIS] < 2:
            return
        self._grad_compression = "int8"
        self._grad_residual = zeros_residual(self._trainable_leaves(self.params))
        self._step_fns.clear()

    def fit_batch(self, batch) -> None:
        """One optimizer step on ``batch`` (`_route`: the fused step for a
        raw batch of a fused fit)."""
        batch, decode = self._route(batch)
        if decode is not None:
            self._fit_batch_fused(batch, decode)
        else:
            self._run_steps([batch])

    def _fit_batch_fused(self, batch, decode) -> None:
        """One fused step (JAX ``_run_step_fused`` / graph
        ``_fit_batch_fused``): the raw batch staged, the chain the step's
        first stage."""
        self._run_steps([batch], decode)

    def _check_trainable(self) -> None:
        """A model class's checks before its first step (none here)."""

    def _prepare(self, batches) -> None:
        if self.params is None:
            self.init()
        if self._quantized is not None:
            raise RuntimeError(
                "this model is int8-quantized for inference and takes no "
                "training step; train the f32 model, then quantize it again")
        self._check_trainable()
        if self.opt_state is None:
            self.opt_state = self._init_opt_state()
            self._drop_graphs()

    def _run_steps(self, batches: list, decode=None) -> None:
        """len(batches) optimizer steps in order, one loss each: on the
        card from staged inputs (graph replays, or the same program
        eagerly), on the CPU eagerly.  With ``decode``, fused steps on
        raw batches (the ``data.device_decode`` fault site is their host
        boundary)."""
        self._prepare(batches)
        k = len(batches)
        with step_scope(self, k) as scope:
            if decode is not None:
                faults.maybe_fail("data.device_decode")
            if self.device.type == "cuda":
                losses_k, raw = self._run_steps_cuda(batches, decode)
            else:
                out = []
                for i, b in enumerate(batches):
                    loss, self.opt_state = self._train_step(
                        *self._step_arrays(b, decode, self.iteration + i),
                        self._step_keys(self.iteration + i), None, decode=decode)
                    out.append(loss)
                losses_k = torch.stack(out)
                raw = (batches[0].features, batches[0].labels)
            scope.sync(losses_k)
            self._compute = None       # output() and the engine read new weights
            self.last_batch_size = batches[-1].num_examples
            if decode is not None:
                self._count_device_decode(decode, *raw, k=k)
            self._finish_steps(losses_k, k)

    @staticmethod
    def _signature(inputs: tuple) -> tuple:
        """A step's graph key: the shape and dtype of each input (None
        where a mask is absent)."""
        return tuple(None if t is None else (tuple(t.shape), t.dtype)
                     for t in inputs)

    def _new_graph(self, inputs: tuple, program=None, bare=None, decode=None, key=None):
        """`_capture` of the step at ``inputs``, kept under ``key`` (its
        signature by default).  A failed warm-up or capture (a device
        OOM) leaves no half-built program: the capture stream is drained
        and its cached blocks go back before the error goes on."""
        try:
            prog = self._capture(inputs, program, bare, decode)
        except BaseException:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
            raise
        self._captured[self._signature(inputs) if key is None else key] = prog
        return prog

    def _run_steps_cuda(self, batches: list, decode=None):
        """The steps on the card; returns their (k,) losses and the first
        step's staged raw features and labels (for the decode's
        calibration)."""
        staged = _Staged(self, batches, decode=decode)
        out = torch.empty(len(batches), dtype=torch.float32, device=self.device)
        first = 0
        if self.capture_steps:
            # a fused step's graph: one a raw-batch signature and chain
            key = self._signature(staged.step(0)) + (
                () if decode is None else (("fused", decode.fingerprint),))
            prog = self._captured.get(key)
            if prog is None:
                prog = self._new_graph(staged.step(0), self._step_program(decode),
                                       decode=decode, key=key)
                first = 1
                out[0].copy_(prog.inputs[-1])
                self.opt_state = advance_counts(self.opt_state)
            rec = self._step_program(decode)._cost_record
        for i in range(first, len(batches)):
            if not self.capture_steps:
                out[i].copy_(self._train_step(*staged.step(i), decode=decode)[0])
            else:
                for dst, src in zip(prog.inputs, staged.step(i)):
                    if dst is not None:
                        dst.copy_(src)
                prog.replay()
                out[i].copy_(prog.inputs[-1])
                self._cost_program = rec
                rec.dispatches += 1
            self.opt_state = advance_counts(self.opt_state)
        return out, [a[0] for a in staged.arrays[:2]]

    def _capture(self, inputs: tuple, program=None, bare=None, decode=None):
        """The step program as a CUDA graph over static copies of
        ``inputs`` (a staged step's), in the pool and on the stream of
        the model's other step graphs.  Its warm-up (`CapturedProgram`)
        is that step itself, run eagerly on the capture stream, and
        counts as the step's dispatch; the capture records the step
        without running it, so it calls the bare grad step (``bare``,
        `_grad_step` by default, where ``program``, `_step_program` by
        default, is its registered form).  ``decode``: the fused step's
        chain, captured as the graph's first stage (its keys are the
        staged inputs, so every replay draws its own step's).  Every run's loss lands in the
        last input, a static slot; what else the grad step returns (a
        window's new carries) is the graph's static outputs.  The
        warm-up's cached activations are released before the capture, so
        the card does not hold a step's memory twice."""
        from deeplearning4j_tpu_torch.runtime.graphs import CapturedProgram

        def step(*args):
            *step_inputs, slot = args
            capturing = torch.cuda.is_current_stream_capturing()
            loss, _, *extra = self._train_step(
                *step_inputs, grad_step=(bare or self._grad_step) if capturing
                else program, decode=decode)
            slot.copy_(loss)
            if not capturing:
                # the warm-up's activations are free now: hand their
                # blocks back, or the graph's own pool holds them again
                torch.cuda.empty_cache()
            return tuple(extra)

        inputs = tuple(None if t is None else t.clone() for t in inputs)
        slot = torch.empty((), dtype=torch.float32, device=self.device)
        other = next(iter(self._captured.values()), None)
        return CapturedProgram(
            step, inputs + (slot,), keep=(tree_leaves(self.params), self.opt_state,
                                          self.net_state),
            pool=other and other.graph.pool(), stream=other and other.stream)

    def fit(self, data, epochs: int = 1, batch_size: int | None = None,
            steps_per_execution: int = 1) -> None:
        """``epochs`` passes over ``data`` (what `_as_iterator` takes).
        ``steps_per_execution`` K groups K batches of one signature into
        one staged run of K steps (graph replays on the card), each step
        with its own loss; a group of mixed signatures, and a short tail,
        step batch by batch.  A lazily produced feed is prefetched
        (`_prefetch_feed`).  An iterator that advertises a transform
        chain feeds raw batches to fused steps where the fit can fuse
        (`_device_decode_feed`)."""
        if steps_per_execution < 1:
            raise ValueError(f"steps_per_execution must be >= 1, got "
                             f"{steps_per_execution}")
        if self.params is None:
            self.init()
        iterator = self._as_iterator(data, batch_size)
        self._donation_checked = False     # re-arm the one-time alias check
        self._ensure_watchdog()
        feed_src, self._device_decode = self._device_decode_feed(
            iterator, self._fused_decode_reason(steps_per_execution))
        feed = self._prefetch_feed(feed_src)
        try:
            for _ in range(epochs):
                for lst in self.listeners:
                    lst.on_epoch_start(self, self.epoch)
                if steps_per_execution > 1:
                    self._fit_epoch_multi(feed, steps_per_execution)
                else:
                    for batch in self._timed_batches(feed):
                        self._fit_one(batch)
                for lst in self.listeners:
                    lst.on_epoch_end(self, self.epoch)
                self.epoch += 1
                if hasattr(iterator, "reset"):
                    iterator.reset()
        finally:
            self._device_decode = None
            if feed is not feed_src:
                feed.close()
        for lst in self.listeners:
            # a duck-typed listener written against the first three hooks
            # has no on_fit_end
            getattr(lst, "on_fit_end", lambda m: None)(self)

    def _group_runner(self, batches, decode=None):
        """The program that runs ``batches`` as one group, or None: step
        them batch by batch.  A group stages its masks beside its
        batches; one whose shapes differ, or whose batches differ in
        having a mask, steps batch by batch (the JAX package steps every
        masked batch alone: the same steps).  ``decode``: a group of raw
        batches, run as fused steps (JAX's fused grouped step)."""
        def sig(b):
            return tuple(None if a is None else tuple(np.shape(a))
                         for a in self._step_arrays(b, decode, 0))

        first = sig(batches[0])
        if all(sig(b) == first for b in batches):
            return (self._run_steps if decode is None
                    else functools.partial(self._run_steps, decode=decode))
        return None

    def _fit_epoch_multi(self, iterator, spe: int) -> None:
        """JAX ``_fit_epoch_multi``: groups of ``spe`` batches, each run
        by `_group_runner`'s program or batch by batch.  A group mixing
        raw and decoded batches steps batch by batch (JAX ``group_ok``):
        each is routed again there."""
        buf: list = []
        for batch in self._timed_batches(iterator):
            buf.append(self._route(batch))
            if len(buf) == spe:
                batches = [b for b, _ in buf]
                decodes = {id(d) for _, d in buf}
                runner = (self._group_runner(batches, buf[0][1])
                          if len(decodes) == 1 else None)
                if runner is not None:
                    self._fit_group(batches, runner)
                else:
                    for b in batches:
                        self._fit_one(b)
                buf = []
        for b, _ in buf:                    # ragged tail group
            self._fit_one(b)


def _sum_over_ranks(loss, grads, group):
    """The loss and the gradients summed over ``group`` (the ranks that
    see different rows of the same slices: the data and seq axes) in
    one all-reduce of a flat f32 bucket (the gradients, then the loss);
    as they are when the group is None (one rank)."""
    from deeplearning4j_tpu_torch.runtime.distributed import all_reduce_flat

    if group is None:
        return loss, list(grads)
    *sums, total = all_reduce_flat(list(grads) + [loss.detach()], group=group)
    return total.to(loss.dtype), [s.to(g.dtype) for s, g in zip(sums, grads)]


def _mean_over_ranks(loss, new_state: dict, n: int):
    """The loss and the layers' new state averaged over the world (JAX
    ``pmean``) in one all-reduce of a flat f32 bucket."""
    from deeplearning4j_tpu_torch.runtime.distributed import all_reduce_flat

    leaves = tree_leaves(new_state)
    total, *sums = all_reduce_flat([loss.detach()] + leaves)
    return (total / n).to(loss.dtype), tree_unflatten(
        new_state, [(s / n).to(t.dtype) for s, t in zip(sums, leaves)])


def _tensors(obj, depth: int = 0):
    """The tensors in ``obj``: itself, or inside dicts, lists, tuples and
    `QuantizedTensor` leaves (a few levels deep; other objects are not
    trees)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif depth > 6:
        return
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v, depth + 1)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v, depth + 1)
    elif isinstance(obj, QuantizedTensor):
        yield obj.q
        yield obj.scale
