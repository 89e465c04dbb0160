"""The device data pipeline — `deeplearning4j_tpu/datavec/device.py`: the
common DataVec transform chain run as the first stage of the training
step, on the card.

The host's per-batch job shrinks to slicing raw bytes: a uint8 image
batch crosses to the card at a quarter of its f32 size, and the chain
(scale, standardize, crop, flip, pool, one-hot, pad) runs inside the
step.  On the card the step is one CUDA graph a raw-batch signature
(`models/model.py`): the chain's ops are captured with the forward,
backward and update, and replayed every step.

Three pieces, as in the JAX package:

- **Transform specs** (`Scale`, `Standardize`, `MinMaxScale`,
  `CenterCrop`, `RandomCrop`, `RandomFlip`, `MeanPool`, `OneHot`,
  `PadToBucket`, `Custom`): each has a numpy ``host_apply`` (the
  fallback path and the parity reference) and a torch ``device_apply``
  (run inside the step).  The random specs draw from a key folded from
  the chain's seed and the batch's augmentation index, with the port's
  `runtime/rng.py` (jax.random's bits): the host and the card draw the
  same crop offsets and flip coins, and so does the JAX package.
- **`TransformChain`** and **`try_lower`**: a chain whose every spec
  lowers becomes a `DeviceDecode`; any other (a `Custom` transform not
  marked ``@device_transform``) gives a reason, and the fit paths keep
  the host transforms: the same numerics, not fused.
- **`DeviceTransformIterator`** and the advertisement protocol
  (`chain_of` / `raw_feed`): an iterator advertises its chain as
  ``device_chain`` and its raw batches through ``raw()``; iterating it
  applies the chain on the host, so it works anywhere, and ``fit``
  switches to the raw feed when it can fuse.

Keys inside a captured step.  A step's decode keys (one a spec, from
``fold_in(fold_in(key(seed), step), salt + i)``, `DeviceDecode.keys`)
are computed on the host and staged to the card with the step's other
inputs, as the dropout keys are: the graph reads them, so every replay
draws its own step's augmentation.  `RandomCrop` draws its offsets on
the card (`rng.randint` on those key words) and gathers the window with
``arange + offset``: nothing inside the step reads a device value on the
host.  `PadToBucket`'s target length is a shape, worked out from the
shapes on the host.  Constants (`Standardize`'s statistics) are copied
to the device once, on the step's eager warm-up, before any capture.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet, as_numpy, copy_tags
from deeplearning4j_tpu_torch.data.iterator import DataSetIterator
from deeplearning4j_tpu_torch.runtime import rng

#: the key salt of the label-side specs (the feature side starts at 0)
LABEL_SALT = 1000

# calibrated decode seconds by (chain fingerprint, input signature,
# device): a chain lowered again (a fit over a fresh NormalizingIterator)
# reuses its measurement instead of capturing and timing once more
_CALIBRATED: dict = {}


def device_transform(fn: Callable) -> Callable:
    """Mark ``fn(x, key)`` (torch tensors in, a tensor out; ``key`` a
    pair of 32-bit key words) as safe to run inside the captured step:
    pure torch on the device, no host reads, no host copies.  `try_lower`
    checks the mark on `Custom` transforms."""
    fn._dl4jtpu_device_transform = True
    return fn


def _array_fp(a) -> tuple:
    """Stable fingerprint of a constant array the step bakes in."""
    a = np.asarray(a)
    return (a.shape, str(a.dtype), zlib.crc32(np.ascontiguousarray(a).tobytes()))


def _f32(v) -> float:
    """``v`` rounded to f32, as a Python float (exact in any op)."""
    return float(np.float32(v))


class NotLowerable(Exception):
    """A spec (or chain) with no device application; ``reason`` says
    why — the fit paths log it and keep the host transforms."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class DeviceTransform:
    """One stage of a decode chain.  Both applications take and return
    ``(array, mask)``, so mask-producing stages (`PadToBucket`) compose
    with the others; ``key`` is None unless ``needs_key``."""

    needs_key = False

    def host_apply(self, x, mask, key):
        raise NotImplementedError

    def device_apply(self, x, mask, key):
        raise NotImplementedError

    def fingerprint(self) -> tuple:
        return (type(self).__name__,) + self._fp()

    def _fp(self) -> tuple:
        return ()

    def check_lowerable(self) -> None:
        """Raise NotLowerable when this spec cannot run on the device."""


class _Constants:
    """Device copies of a spec's constant arrays, made once a device
    (outside any capture: the step's eager warm-up makes them)."""

    def __init__(self, **arrays):
        self._host = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
        self._dev: dict = {}

    def host(self, name: str) -> np.ndarray:
        return self._host[name]

    def on(self, device) -> dict:
        got = self._dev.get(device)
        if got is None:
            got = self._dev[device] = {
                k: torch.from_numpy(v.copy()).to(device) for k, v in self._host.items()}
        return got


@dataclasses.dataclass
class Scale(DeviceTransform):
    """``x.to(f32) * scale + offset`` — the ImagePreProcessingScaler
    lowering (uint8 [0, 255] to [lo, hi] floats); scale and offset are
    rounded to f32 first, as ``jnp.float32`` rounds them."""

    scale: float = 1.0 / 255.0
    offset: float = 0.0

    def device_apply(self, x, mask, key):
        return x.to(torch.float32) * _f32(self.scale) + _f32(self.offset), mask

    def host_apply(self, x, mask, key):
        return (x.astype(np.float32) * np.float32(self.scale)
                + np.float32(self.offset)), mask

    def _fp(self):
        return (float(self.scale), float(self.offset))


@dataclasses.dataclass
class Standardize(DeviceTransform):
    """``(x - mean) / std`` with per-feature statistics — the
    NormalizerStandardize lowering (statistics fit on the host, applied
    on the device as constants)."""

    mean: np.ndarray = None
    std: np.ndarray = None

    def __post_init__(self):
        self._consts = _Constants(mean=self.mean, std=self.std)

    def device_apply(self, x, mask, key):
        c = self._consts.on(x.device)
        return (x.to(torch.float32) - c["mean"]) / c["std"], mask

    def host_apply(self, x, mask, key):
        return ((x.astype(np.float32) - self._consts.host("mean"))
                / self._consts.host("std")), mask

    def _fp(self):
        return (_array_fp(self.mean), _array_fp(self.std))


@dataclasses.dataclass
class MinMaxScale(DeviceTransform):
    """Per-feature min / max scale into [lo, hi] — the
    NormalizerMinMaxScaler lowering (the same epsilon and order of
    operations)."""

    min: np.ndarray = None
    max: np.ndarray = None
    lo: float = 0.0
    hi: float = 1.0

    def __post_init__(self):
        mn = np.asarray(self.min, np.float32)
        self._consts = _Constants(
            min=mn, range=np.maximum(np.asarray(self.max, np.float32) - mn, 1e-12))

    def device_apply(self, x, mask, key):
        c = self._consts.on(x.device)
        return ((x.to(torch.float32) - c["min"]) / c["range"]
                * _f32(self.hi - self.lo) + _f32(self.lo)), mask

    def host_apply(self, x, mask, key):
        return ((x.astype(np.float32) - self._consts.host("min"))
                / self._consts.host("range")
                * np.float32(self.hi - self.lo) + np.float32(self.lo)), mask

    def _fp(self):
        return (_array_fp(self.min), _array_fp(self.max),
                float(self.lo), float(self.hi))


@dataclasses.dataclass
class CenterCrop(DeviceTransform):
    """Center crop of the two spatial axes of an NHWC batch (offsets
    from the shapes alone)."""

    height: int = 0
    width: int = 0

    def _window(self, x):
        top = (x.shape[1] - self.height) // 2
        left = (x.shape[2] - self.width) // 2
        return x[:, top:top + self.height, left:left + self.width]

    def device_apply(self, x, mask, key):
        return self._window(x), mask

    def host_apply(self, x, mask, key):
        return self._window(x), mask

    def _fp(self):
        return (int(self.height), int(self.width))


@dataclasses.dataclass
class RandomCrop(DeviceTransform):
    """Random crop of the spatial axes: one offset pair a batch, drawn
    from the step's key with ``randint`` after a ``split`` (jax's
    draws).  On the device the offsets stay on the device: the window
    is gathered at ``arange + offset``."""

    height: int = 0
    width: int = 0
    needs_key = True

    def offsets(self, x_shape, key, device=None):
        """(top, left): int32 0-dim tensors on ``device``."""
        kt, kl = rng.split(key)
        top = rng.randint(kt, (), 0, x_shape[1] - self.height + 1, device)
        left = rng.randint(kl, (), 0, x_shape[2] - self.width + 1, device)
        return top, left

    def device_apply(self, x, mask, key):
        top, left = self.offsets(x.shape, key, x.device)
        rows = torch.arange(self.height, device=x.device) + top
        cols = torch.arange(self.width, device=x.device) + left
        return x.index_select(1, rows).index_select(2, cols), mask

    def host_apply(self, x, mask, key):
        top, left = (int(t) for t in self.offsets(x.shape, key))
        return x[:, top:top + self.height, left:left + self.width], mask

    def _fp(self):
        return (int(self.height), int(self.width))


@dataclasses.dataclass
class RandomFlip(DeviceTransform):
    """Per-example coin-flip reversal of one axis (the horizontal flip
    at the default ``axis=2`` of NHWC); the coins are
    ``bernoulli(key, prob, (B,))``.  ``row_offset`` (a data-parallel
    rank's first global row) picks the rank's coins of the global batch."""

    prob: float = 0.5
    axis: int = 2
    needs_key = True

    def coins(self, n: int, key, device=None, row_offset: int = 0):
        return rng.bernoulli(key, self.prob, (n,), device=device, offset=row_offset)

    def device_apply(self, x, mask, key, row_offset: int = 0):
        coin = self.coins(x.shape[0], key, x.device, row_offset)
        sel = coin.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(sel, x.flip(self.axis), x), mask

    def host_apply(self, x, mask, key, row_offset: int = 0):
        coin = self.coins(x.shape[0], key, row_offset=row_offset).numpy()
        sel = coin.reshape((-1,) + (1,) * (x.ndim - 1))
        return np.where(sel, np.flip(x, self.axis), x), mask

    def _fp(self):
        return (float(self.prob), int(self.axis))


@dataclasses.dataclass
class MeanPool(DeviceTransform):
    """Average-pool downscale of the spatial axes of an NHWC batch (the
    window (wh, ww) must divide H and W), an f32 mean;
    ``collapse_channels`` also means over C and keeps one channel."""

    window: tuple = (2, 2)
    collapse_channels: bool = False

    def device_apply(self, x, mask, key):
        b, h, w, c = x.shape
        wh, ww = self.window
        x = x.to(torch.float32).reshape(b, h // wh, wh, w // ww, ww, c)
        if self.collapse_channels:
            return x.mean(dim=(2, 4, 5)).unsqueeze(-1), mask
        return x.mean(dim=(2, 4)), mask

    def host_apply(self, x, mask, key):
        b, h, w, c = x.shape
        wh, ww = self.window
        x = x.astype(np.float32).reshape(b, h // wh, wh, w // ww, ww, c)
        if self.collapse_channels:
            return x.mean(axis=(2, 4, 5), dtype=np.float32)[..., None], mask
        return x.mean(axis=(2, 4), dtype=np.float32), mask

    def _fp(self):
        return (tuple(self.window), bool(self.collapse_channels))


@dataclasses.dataclass
class OneHot(DeviceTransform):
    """Integer class ids -> one-hot float32 rows (label side).  On the
    device an id outside [0, num_classes) gives a zero row, as
    ``jax.nn.one_hot`` does (no device-side assert)."""

    num_classes: int = 0

    def device_apply(self, x, mask, key):
        ids = x if x.is_floating_point() else x.long()
        classes = torch.arange(self.num_classes, device=x.device, dtype=ids.dtype)
        return (ids.unsqueeze(-1) == classes).to(torch.float32), mask

    def host_apply(self, x, mask, key):
        ids = np.asarray(x).astype(np.int64)
        return np.eye(self.num_classes, dtype=np.float32)[ids], mask

    def _fp(self):
        return (int(self.num_classes),)


@dataclasses.dataclass
class PadToBucket(DeviceTransform):
    """Pad the time axis up to the bucketing quantum
    (`runtime.flags.bucket_length`) and emit or extend the mask of real
    steps.  ``quantum=None`` resolves ``flags.sequence_bucket_size()``
    once; an explicit 0 reaches `bucket_length`'s check.  The target is
    a shape: it is worked out from the shapes, on the host."""

    quantum: Optional[int] = None
    axis: int = 1
    _resolved: Optional[int] = dataclasses.field(default=None, repr=False)

    def resolved_quantum(self) -> int:
        if self._resolved is None:
            from deeplearning4j_tpu_torch.runtime.flags import sequence_bucket_size

            self._resolved = (sequence_bucket_size() if self.quantum is None
                              else int(self.quantum))
        return self._resolved

    def _target(self, length: int) -> int:
        from deeplearning4j_tpu_torch.runtime.flags import bucket_length

        return bucket_length(length, self.resolved_quantum())

    def device_apply(self, x, mask, key):
        t = x.shape[self.axis]
        pad = self._target(t) - t
        if mask is None:
            mask = torch.ones((x.shape[0], t), dtype=torch.float32, device=x.device)
        if pad == 0:
            return x, mask
        shape = list(x.shape)
        shape[self.axis] = pad
        return (torch.cat([x, x.new_zeros(shape)], dim=self.axis),
                torch.cat([mask, mask.new_zeros((mask.shape[0], pad))], dim=1))

    def host_apply(self, x, mask, key):
        t = x.shape[self.axis]
        pad = self._target(t) - t
        if mask is None:
            mask = np.ones((x.shape[0], t), np.float32)
        if pad == 0:
            return x, mask
        widths = [(0, 0)] * x.ndim
        widths[self.axis] = (0, pad)
        return np.pad(x, widths), np.pad(mask, ((0, 0), (0, pad)))

    def _fp(self):
        return (self.resolved_quantum(), int(self.axis))


@dataclasses.dataclass
class Custom(DeviceTransform):
    """A user transform ``fn(x, key) -> x`` on torch tensors.  Lowerable
    only when ``fn`` is marked ``@device_transform``; its host
    application runs it on a CPU tensor of the batch."""

    fn: Callable = None
    needs_key = True

    def check_lowerable(self) -> None:
        if not getattr(self.fn, "_dl4jtpu_device_transform", False):
            name = getattr(self.fn, "__qualname__", repr(self.fn))
            raise NotLowerable(f"custom transform {name} is not marked @device_transform")

    def device_apply(self, x, mask, key):
        return self.fn(x, key), mask

    def host_apply(self, x, mask, key):
        return as_numpy(self.fn(torch.from_numpy(np.array(x)), key)), mask

    def _fp(self):
        # the qualname alone collides for closures of one factory, and the
        # step programs key on this: id(fn) tells them apart (a live
        # program keeps its decode, and so fn, alive)
        code = getattr(self.fn, "__code__", None)
        return (getattr(self.fn, "__module__", "?"),
                getattr(self.fn, "__qualname__", repr(self.fn)),
                zlib.crc32(code.co_code) if code is not None else 0,
                id(self.fn))


@dataclasses.dataclass
class TransformChain:
    """An ordered feature-transform list and label-transform list, and
    the augmentation seed the step keys fold from."""

    features: tuple = ()
    labels: tuple = ()
    seed: int = 0

    def __post_init__(self):
        self.features = tuple(self.features)
        self.labels = tuple(self.labels)

    @property
    def specs(self) -> tuple:
        return self.features + self.labels

    def needs_key(self) -> bool:
        return any(s.needs_key for s in self.specs)

    def fingerprint(self) -> tuple:
        return (tuple(s.fingerprint() for s in self.features),
                tuple(s.fingerprint() for s in self.labels),
                int(self.seed))


def spec_keys(chain: TransformChain, step_i: int) -> np.ndarray:
    """The decode keys of augmentation step ``step_i``: an (n specs, 2)
    int64 array, row i ``fold_in(fold_in(key(seed), step_i), salt + j)``
    for the spec's position j on its side (salt 0 for the features,
    `LABEL_SALT` for the labels) where the spec needs a key, zeros
    elsewhere — the JAX package's per-spec keys."""
    out = np.zeros((len(chain.specs), 2), np.int64)
    if not chain.needs_key():
        return out
    base = rng.fold_in(rng.key(chain.seed), step_i)
    for i, spec in enumerate(chain.features):
        if spec.needs_key:
            out[i] = rng.fold_in(base, i)
    n = len(chain.features)
    for i, spec in enumerate(chain.labels):
        if spec.needs_key:
            out[n + i] = rng.fold_in(base, LABEL_SALT + i)
    return out


def _apply_chain(chain: TransformChain, keys, feats, labs, *, device: bool,
                 fmask0=None, lmask0=None, row_offset: int = 0):
    """The traversal both applications share.  ``keys``: `spec_keys`'
    rows, as numpy (the host) or an int64 tensor (staged on the card:
    each row's words stay 0-dim device tensors).  fmask0 / lmask0 seed
    the masks: the host path threads the batch's own masks through
    (mask-producing specs extend them); the fused path never sees a
    masked raw batch (the fit routing does not fuse those)."""
    def key_of(j):
        row = keys[j]
        if isinstance(row, torch.Tensor):
            return row[0], row[1]
        return int(row[0]), int(row[1])

    def run(specs, x, first, mask):
        for i, spec in enumerate(specs):
            k = key_of(first + i) if spec.needs_key else None
            extra = {"row_offset": row_offset} if isinstance(spec, RandomFlip) else {}
            apply = spec.device_apply if device else spec.host_apply
            x, mask = apply(x, mask, k, **extra)
        return x, mask

    feats, fmask = run(chain.features, feats, 0, fmask0)
    labs, lmask = run(chain.labels, labs, len(chain.features), lmask0)
    return feats, labs, fmask, lmask


class DeviceDecode:
    """A lowered chain.  ``fn`` is the device application the fit paths
    run as the first stage of the step; ``host`` the numpy reference
    (the fallback path's semantics); ``program`` the standalone decode,
    registered with the cost registry as a program of kind
    ``"decode"``; ``calibrated_seconds`` its time once a raw-batch
    signature (the fused step hides the stage, so attribution charges
    this per batch)."""

    def __init__(self, chain: TransformChain):
        self.chain = chain
        self.fingerprint = chain.fingerprint()
        self._program = None

    def keys(self, step_i: int) -> np.ndarray:
        """`spec_keys` of augmentation step ``step_i``."""
        return spec_keys(self.chain, step_i)

    def fn(self, step_i, raw_feats, raw_labels, *, keys=None, row_offset: int = 0):
        """The device application on torch tensors: (features, labels,
        features mask, labels mask).  ``keys``: the step's staged decode
        keys (an int64 tensor of `keys` rows); None computes them for
        augmentation step ``step_i`` on the host."""
        if keys is None:
            keys = self.keys(step_i)
        return _apply_chain(self.chain, keys, raw_feats, raw_labels, device=True,
                            row_offset=row_offset)

    def host(self, step_i: int, batch: DataSet, row_offset: int = 0) -> DataSet:
        """The numpy application (the fallback path).  The batch's own
        masks thread through the chain; the attribution tags carry over,
        and the result is marked decoded."""
        f, y = as_numpy(batch.features), as_numpy(batch.labels)
        fm0 = None if batch.features_mask is None else as_numpy(batch.features_mask)
        lm0 = None if batch.labels_mask is None else as_numpy(batch.labels_mask)
        feats, labs, fmask, lmask = _apply_chain(
            self.chain, self.keys(step_i), f, y, device=False, fmask0=fm0,
            lmask0=lm0, row_offset=row_offset)
        out = copy_tags(batch, DataSet(
            np.asarray(feats), np.asarray(labs),
            None if fmask is None else np.asarray(fmask),
            None if lmask is None else np.asarray(lmask)))
        # the tags survive; the raw-routing one must not: this IS the
        # decoded batch
        out._raw_for_device_decode = False
        return out

    def _run(self, raw_feats, raw_labels, keys):
        return self.fn(None, raw_feats, raw_labels, keys=keys)

    def program(self):
        """The standalone decode ``(raw features, raw labels, keys)``,
        registered with the cost registry (kind ``"decode"``) on first
        use, so the program table attributes the decode stage's work
        beside the step programs."""
        if self._program is None:
            from deeplearning4j_tpu_torch.observe import cost

            self._program = cost.register_attr_program(
                self, "_program", "decode", ("decode", self.fingerprint), self._run)
        return self._program

    def calibrated_seconds(self, feats, labs) -> float:
        """Seconds of the standalone decode on inputs of this signature
        (measured once a chain fingerprint, signature and device).  On the
        card as the fused step runs it: captured into a
        CUDA graph of its own (the random specs' key arithmetic is many
        small kernels, which an eager call spends on the host), one warm
        replay, then one timed by CUDA events; on the CPU one warm run,
        then one timed by the host clock.  Numpy inputs (a CPU step's)
        become tensors only when a signature is timed.  The decode's
        program is registered either way."""
        fn = self.program()
        key = (self.fingerprint, str(getattr(feats, "device", "cpu"))) + tuple(
            (tuple(x.shape), str(x.dtype).removeprefix("torch.")) for x in (feats, labs))
        t = _CALIBRATED.get(key)
        if t is None:
            feats, labs = (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
                           for x in (feats, labs))
            keys = torch.from_numpy(self.keys(0)).to(feats.device)
            if feats.device.type == "cuda":
                from deeplearning4j_tpu_torch.runtime.graphs import CapturedProgram

                prog = CapturedProgram(fn, (feats.clone(), labs.clone(), keys))
                prog.replay()                               # warm
                start, end = torch.cuda.Event(True), torch.cuda.Event(True)
                start.record()
                prog.replay()
                end.record()
                end.synchronize()
                t = start.elapsed_time(end) / 1e3
                del prog
            else:
                fn(feats, labs, keys)                       # warm
                t0 = time.perf_counter()
                fn(feats, labs, keys)
                t = time.perf_counter() - t0
            _CALIBRATED[key] = t
        return t


def try_lower(chain: TransformChain):
    """``(DeviceDecode, None)`` for a chain whose every spec lowers, else
    ``(None, reason)``.  Memoised on the chain object: every fit asks
    again, and a fresh decode would time its calibration again for a
    result that cannot change."""
    if not isinstance(chain, TransformChain):
        return None, f"not a TransformChain: {type(chain).__name__}"
    cached = getattr(chain, "_lowered", None)
    if cached is not None:
        return cached, None
    try:
        for spec in chain.specs:
            if not isinstance(spec, DeviceTransform):
                raise NotLowerable(f"unknown transform type {type(spec).__name__}")
            spec.check_lowerable()
    except NotLowerable as e:
        return None, e.reason
    decode = DeviceDecode(chain)
    chain._lowered = decode
    return decode, None


# -- the iterator protocol ------------------------------------------------------

class DeviceTransformIterator(DataSetIterator):
    """A `TransformChain` attached to a raw-batch iterator.  Iterating it
    applies the chain on the host (one augmentation index a batch), so
    it goes anywhere a DataSetIterator goes; it also advertises the
    chain (``device_chain``) and the raw feed (``raw()``), which ``fit``
    keys on to run the chain inside the step on raw bytes."""

    def __init__(self, base: DataSetIterator, chain: TransformChain):
        self._base = base
        self._chain = chain
        self._decode = DeviceDecode(chain)
        self._step = 0

    @property
    def device_chain(self) -> TransformChain:
        return self._chain

    def raw(self) -> DataSetIterator:
        return self._base

    def next_decode_step(self) -> int:
        """The iterator's one augmentation counter: host iteration and
        the raw feed both draw from it, so the fused step and the host
        path fold the same keys however fits, evaluations and raw pulls
        interleave."""
        s = self._step
        self._step += 1
        return s

    @property
    def batch_size(self) -> int:
        return getattr(self._base, "batch_size", 0)

    def reset(self) -> None:
        if hasattr(self._base, "reset"):
            self._base.reset()

    def __iter__(self):
        for batch in self._base:
            yield self._decode.host(self.next_decode_step(), batch)


def chain_of(iterator) -> Optional[TransformChain]:
    """The `TransformChain` an iterator advertises (a ``device_chain``
    attribute and a ``raw()`` method), or None."""
    chain = getattr(iterator, "device_chain", None)
    if isinstance(chain, TransformChain) and hasattr(iterator, "raw"):
        return chain
    return None


class _RawFeed(DataSetIterator):
    """The raw feed of an advertising iterator: shallow copies of the
    base's batches tagged ``_raw_for_device_decode`` (and their
    augmentation index, ``_decode_step``), which the fit routes to the
    fused step.  A masked or non-`DataSet` batch is decoded on the host
    here instead: once the feed is raw, an untagged raw batch must never
    reach the step undecoded."""

    def __init__(self, owner, decode: Optional[DeviceDecode] = None):
        self._owner = owner
        self._raw = owner.raw()
        self._decode = decode
        self._step = 0

    def _next_step(self) -> int:
        nxt = getattr(self._owner, "next_decode_step", None)
        if nxt is not None:
            return nxt()
        s = self._step
        self._step += 1
        return s

    @property
    def batch_size(self) -> int:
        return getattr(self._owner, "batch_size", 0)

    def reset(self) -> None:
        if hasattr(self._owner, "reset"):
            self._owner.reset()

    def _host_decode(self) -> DeviceDecode:
        if self._decode is None:
            self._decode = DeviceDecode(chain_of(self._owner))
        return self._decode

    def __iter__(self):
        for batch in self._raw:
            i = self._next_step()
            if (isinstance(batch, DataSet) and batch.features_mask is None
                    and batch.labels_mask is None):
                # a shallow copy, never the base's object: in-memory bases
                # yield the same objects again, and a sticky tag would count
                # their bytes as raw on a later unfused fit
                batch = copy_tags(batch, DataSet(batch.features, batch.labels))
                batch._raw_for_device_decode = True
                batch._decode_step = i
            else:
                batch = self._host_decode().host(i, batch)
            yield batch


def raw_feed(iterator, decode: Optional[DeviceDecode] = None) -> DataSetIterator:
    return _RawFeed(iterator, decode)
