"""Model serialization — `ModelSerializer` of
`deeplearning4j_tpu/train/checkpoint.py`: the JAX package's checkpoint
zip, read and written with numpy and `zipfile` alone.

A checkpoint is one zip:

- ``configuration.json``: ``{"model_class", "conf"}``, the configuration
  in the serde JSON (`utils/serde.py`);
- ``params.npz``, ``netstate.npz``, ``updater.npz``: positional arrays
  ``arr_0, arr_1, ...``, the leaves in ``jax.tree.leaves`` order (dict
  keys sorted at every level, so ``layer10`` before ``layer2``; a
  quantized weight as ``q`` then ``scale``; the layers' state, such as
  BatchNorm's ``mean`` and ``var``; the optimizer state as optax
  flattens it, `nn/updaters.py` `state_leaves`);
- ``meta.json``: format version, iteration, epoch and the quantization
  scheme of an int8 model;
- ``manifest.json``: CRC32, size and leaf count of every entry.

`write_model` publishes atomically (``path + ".tmp"``, fsync, then
``os.replace``); `verify` proves a file intact before it is trusted;
`restore` rebuilds the model from its configuration (structure from
code, data from the file), on the card unless the caller asks for the
CPU.  A zip written here restores in the JAX package and the other way
round.

A data-parallel model (`parallel/data_parallel.py`) writes with
`write_model_distributed`: every rank takes part (under ZeRO the
optimizer state's slices are gathered, a collective) and the chief
writes one zip with the entries of an undistributed model's, the
optimizer state whole.  `restore_into` a ZeRO model copies each rank's
slices of the saved state into its live slices.

A failed verify is logged and counted under
``dl4jtpu_ckpt_verify_failures_total{reason="corrupt"}``.  The fault
sites ``checkpoint.write`` (``truncate`` chops the published bytes) and
``checkpoint.fsync`` (a ``kill`` there is kill -9 mid-write: a ``.tmp``
orphan stays) are consulted where the JAX package consults them.  A
``GraphModel`` (computation graph) checkpoint has the same entries, its
trees keyed by ``param_key``.  A model with frozen layers keeps
optimizer state for its trainable leaves only, as optax's ``masked``
does, so its ``updater.npz`` is the JAX package's.

`CheckpointStore` is a directory of rolling ``ckpt_<step>.zip`` files:
atomic saves, verification, last-good fallback (a truncated newest file
is skipped and counted), pins that ``gc`` never collects (a
`RecoveryPolicy`'s rollback target), save listeners, and ``serve_into``
(every save pushed to servers as a verified hot-swap).
`restore_into` copies a checkpoint into a live model's tensors in place
(a rollback: the step graphs stay valid).  Not ported:
``write_model_distributed`` (ROADMAP A11).
"""

from __future__ import annotations

import io
import json
import logging
import os
import re
import zipfile
import zlib
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.model import tree_leaves, tree_unflatten
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.runtime import faults
from deeplearning4j_tpu_torch.utils import serde

log = logging.getLogger("deeplearning4j_tpu_torch")

# v2 adds manifest.json; v1 files (no manifest) still restore, verify()
# falling back to the zip's own per-entry CRC check for them
FORMAT_VERSION = 2

MANIFEST_NAME = "manifest.json"
_REQUIRED_ENTRIES = ("configuration.json", "params.npz", "netstate.npz",
                     "meta.json")


class CheckpointVerifyError(RuntimeError):
    """The checkpoint file failed integrity verification (truncated zip,
    CRC mismatch, missing entries, leaf-count drift)."""


def _count_verify_failure(path: str, reason: str,
                          kind: str = "corrupt") -> None:
    log.warning("checkpoint %s failed verification: %s", path, reason)
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        registry().counter("dl4jtpu_ckpt_verify_failures_total").inc(
            reason=kind)
    except Exception as e:
        # best-effort: the verify failure itself must propagate
        log.debug("ckpt verify-failure metric failed: %s", e)


def params_nonfinite(path: str) -> bool:
    """True when the checkpoint's params.npz holds NaN or Inf, read from
    the zip without building a model.  Verification cannot see this: a
    save taken at the diverging step has good CRCs, and such a file must
    never become a rollback or serving target."""
    with zipfile.ZipFile(path, "r") as zf:
        npz = np.load(io.BytesIO(zf.read("params.npz")), allow_pickle=False)
        for name in npz.files:
            a = npz[name]
            if np.issubdtype(a.dtype, np.floating) and not np.isfinite(a).all():
                return True
    return False


def count_skipped_checkpoint(path: str, reason: str) -> None:
    """Log and count a checkpoint passed over as a restore, rollback or
    serving target for a reason verify() cannot see (``nonfinite``:
    intact bytes holding NaN / Inf), under
    ``dl4jtpu_ckpt_verify_failures_total{reason=...}``."""
    log.warning("checkpoint %s skipped as a restore target: %s", path, reason)
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        registry().counter("dl4jtpu_ckpt_verify_failures_total").inc(
            reason=reason)
    except Exception as e:
        log.debug("ckpt skip metric failed: %s", e)


def _count_push_error() -> None:
    """One ``serve_into`` target's push raised."""
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        registry().counter("dl4jtpu_serving_hotswap_total").inc(
            result="push_error")
    except Exception as e:
        log.debug("serve_into push-error metric failed: %s", e)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _npz_bytes(leaves: list) -> tuple[bytes, int]:
    buf = io.BytesIO()
    np.savez(buf, *[_host(x) for x in leaves])
    return buf.getvalue(), len(leaves)


def _npz_leaves(zf: zipfile.ZipFile, name: str, want: int) -> list:
    data = np.load(io.BytesIO(zf.read(name)), allow_pickle=False)
    leaves = [data[k] for k in data.files]
    if len(leaves) != want:
        raise ValueError(
            f"{name}: checkpoint has {len(leaves)} arrays, model expects {want}")
    return leaves


def _unflatten_like(tree: dict, leaves: list) -> dict:
    """``tree`` with its leaves replaced, in `tree_leaves` order, by host
    tensors of ``leaves`` cast to each old leaf's dtype."""
    return tree_unflatten(tree, [
        torch.from_numpy(np.asarray(x).astype(str(ref.dtype).removeprefix("torch."),
                                              copy=True))
        for x, ref in zip(leaves, tree_leaves(tree))])


def _updater_state(model):
    """The optimizer state a checkpoint holds: the model's, or the fresh
    state the JAX package's model carries from ``init`` on; none for an
    int8 model, which takes no updates.  A ZeRO model's inner state,
    gathered whole from every rank's slices: a collective, so every rank
    calls it (`write_model_distributed`)."""
    if model._quantized is not None:
        return model.opt_state
    if model.opt_state is None:
        return model._init_opt_state()
    from deeplearning4j_tpu_torch.parallel.zero import unwrap_opt_state

    inner, _ = unwrap_opt_state(model.opt_state)
    zp = getattr(model, "_zero_placement", None)
    if zp is not None:
        return zp.gather_state(inner)
    sp = getattr(model, "_shard_placement", None)
    if sp is not None:
        from deeplearning4j_tpu_torch.parallel.data_parallel import _trainable_index

        return sp.gather_state(inner, _trainable_index(model))
    return inner


# the configuration class each model class is built from
_CONF_OF = {"SequentialModel": "SequentialConfiguration",
            "GraphModel": "GraphConfiguration"}


def _model_classes() -> dict:
    from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel

    return {"SequentialModel": SequentialModel, "GraphModel": GraphModel}


class ModelSerializer:
    @staticmethod
    def write_model_distributed(model, path: str, save_updater: bool = True) -> None:
        """Checkpoint a distributed model: every rank calls it and takes
        part in the gathers (a chief-only write would wedge the chief in a
        ZeRO gather, or in the gather of a tensor-, expert-split tree),
        the chief writes the zip an undistributed model writes, and every
        rank returns once it is published."""
        from deeplearning4j_tpu_torch.runtime import distributed

        if model.params is None:
            raise RuntimeError("model not initialized")
        opt = _updater_state(model) if save_updater else None
        params = getattr(model, "full_params", lambda: model.params)()
        if distributed.is_chief():
            ModelSerializer._write(model, path, opt, params)
        distributed.barrier()

    @staticmethod
    def write_model(model, path: str, save_updater: bool = True) -> None:
        """Write the checkpoint zip atomically: the bytes land in
        ``path + ".tmp"``, are fsynced, and only then renamed over
        ``path``, so a reader sees the old file or the new one, never a
        torn write.  ``model`` may be a host snapshot
        (`train.listeners._HostSnapshot`).  Fault sites:
        ``checkpoint.write`` at entry (``truncate`` corrupts the
        published bytes: corruption that slipped past the fsync) and
        ``checkpoint.fsync`` between the zip landing and the publish."""
        if model.params is None:
            raise RuntimeError("model not initialized")
        if getattr(model, "_shard_placement", None) is not None:
            # split parameters: a collective of every rank
            return ModelSerializer.write_model_distributed(model, path, save_updater)
        ModelSerializer._write(model, path,
                               _updater_state(model) if save_updater else None)

    @staticmethod
    def _write(model, path: str, opt, params=None) -> None:
        """`write_model` with the optimizer state ``opt`` (whole; None:
        no ``updater.npz``) and the parameter tree ``params`` (whole; the
        model's by default)."""
        action = faults.maybe_fail("checkpoint.write")
        manifest_entries: dict[str, dict] = {}
        leaf_counts: dict[str, int] = {}

        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            zf = zipfile.ZipFile(f, "w", zipfile.ZIP_DEFLATED)

            def put(name: str, data: bytes, leaves: Optional[int] = None):
                # one entry's bytes alive at a time
                zf.writestr(name, data)
                manifest_entries[name] = {"crc32": zlib.crc32(data),
                                          "size": len(data)}
                if leaves is not None:
                    leaf_counts[name] = leaves

            put("configuration.json", json.dumps(
                {"model_class": getattr(model, "_serialize_class_name",
                                        type(model).__name__),
                 "conf": serde.to_jsonable(model.conf)}, indent=2).encode())
            put("params.npz", *_npz_bytes(tree_leaves(
                model.params if params is None else params)))
            put("netstate.npz", *_npz_bytes(tree_leaves(model.net_state or {})))
            if opt is not None:
                put("updater.npz", *_npz_bytes(updaters.state_leaves(opt)))
            meta = {"format_version": FORMAT_VERSION,
                    "iteration": model.iteration, "epoch": model.epoch}
            if model._quantized is not None:
                # restore rebuilds the (int8, scale) structure with the
                # same knobs before the leaves stream in
                meta["quantized"] = model._quantized
            put("meta.json", json.dumps(meta).encode())
            zf.writestr(MANIFEST_NAME, json.dumps({
                "format_version": FORMAT_VERSION,
                "entries": manifest_entries,
                "leaf_counts": leaf_counts,
            }))
            zf.close()
            if action == "truncate":
                # injected corruption that survives the publish
                f.flush()
                f.truncate(max(1, f.tell() // 2))
            faults.maybe_fail("checkpoint.fsync")
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)       # atomic publish

    @staticmethod
    def verify(path: str) -> dict:
        """Prove ``path`` an intact checkpoint without building a model:
        the zip opens, the required entries exist, every manifest entry
        decompresses to its recorded CRC32 and size, and the npz leaf
        counts match the manifest.  A file without a manifest (format 1)
        falls back to the zip's own CRCs.  Returns ``meta.json``; raises
        `CheckpointVerifyError` on any defect."""
        try:
            with zipfile.ZipFile(path, "r") as zf:
                names = set(zf.namelist())
                missing = [n for n in _REQUIRED_ENTRIES if n not in names]
                if missing:
                    raise ValueError(f"missing entries: {missing}")
                if MANIFEST_NAME in names:
                    manifest = json.loads(zf.read(MANIFEST_NAME))
                    leaf_counts = manifest.get("leaf_counts", {})
                    for name in leaf_counts:
                        if name not in names:
                            raise ValueError(f"{name}: in manifest, not in zip")
                    # one read an entry serves the CRC, the size and the
                    # leaf count
                    for name, ent in manifest.get("entries", {}).items():
                        data = zf.read(name)
                        if len(data) != ent["size"]:
                            raise ValueError(f"{name}: size {len(data)} != "
                                             f"manifest {ent['size']}")
                        if zlib.crc32(data) != ent["crc32"]:
                            raise ValueError(f"{name}: CRC32 mismatch")
                        want = leaf_counts.get(name)
                        if want is not None:
                            npz = np.load(io.BytesIO(data), allow_pickle=False)
                            if len(npz.files) != want:
                                raise ValueError(
                                    f"{name}: {len(npz.files)} leaves, "
                                    f"manifest says {want}")
                else:
                    bad = zf.testzip()
                    if bad is not None:
                        raise ValueError(f"{bad}: zip CRC check failed")
                return json.loads(zf.read("meta.json"))
        except CheckpointVerifyError:
            raise
        except (zipfile.BadZipFile, zlib.error, KeyError, ValueError,
                OSError, json.JSONDecodeError) as e:
            _count_verify_failure(path, f"{type(e).__name__}: {e}")
            raise CheckpointVerifyError(
                f"checkpoint {path} failed verification: {e}") from e

    @staticmethod
    def restore(path: str, verify: bool = True, device=None):
        """Rebuild a saved model on ``device`` (CUDA unless the caller
        asks for the CPU): its configuration, then its parameters,
        optimizer state and counters.  Verifies the file first unless
        ``verify=False``."""
        if verify:
            ModelSerializer.verify(path)
        with zipfile.ZipFile(path, "r") as zf:
            cfg = json.loads(zf.read("configuration.json"))
            model_class = cfg["model_class"]
            cls = _model_classes().get(model_class)
            if cls is None:
                raise ValueError(f"unknown model class in checkpoint: {model_class}")
            conf = serde.from_jsonable(cfg["conf"])
            if type(conf).__name__ != _CONF_OF[model_class]:
                raise ValueError(f"checkpoint's model class {model_class} does not "
                                 f"take its {type(conf).__name__}")
            model = cls(conf, device=device).init()
            meta = json.loads(zf.read("meta.json"))
            quantized = meta.get("quantized")
            if quantized is not None:
                from deeplearning4j_tpu_torch.quant.ptq import requantize_structure

                model = requantize_structure(model, quantized)
            ref = model.params
            model._install(_unflatten_like(
                ref, _npz_leaves(zf, "params.npz", len(tree_leaves(ref)))))
            model._quantized = quantized
            state = model.net_state
            model.load_net_state(_unflatten_like(
                state, _npz_leaves(zf, "netstate.npz", len(tree_leaves(state)))))
            if "updater.npz" in zf.namelist():
                state = model._init_opt_state() if quantized is None else ()
                want = len(updaters.state_leaves(state))
                model.opt_state = updaters.load_state_leaves(
                    state, _npz_leaves(zf, "updater.npz", want)) or None
            model.iteration = meta.get("iteration", 0)
            model.epoch = meta.get("epoch", 0)
        return model

    @staticmethod
    @torch.no_grad()
    def restore_into(model, path: str, verify: bool = True) -> dict:
        """Copy a checkpoint of ``model``'s own configuration into its live
        tensors in place: parameters, layer state, the optimizer state
        (when both sides have one) and ``iteration`` (JAX
        `RecoveryPolicy._install`).  The tensors a captured step reads
        stay the same objects, so its graphs stay valid.  Returns the
        checkpoint's ``meta.json``; raises `ValueError` when the leaves'
        count or shapes differ."""
        meta = ModelSerializer.verify(path) if verify else None
        with zipfile.ZipFile(path, "r") as zf:
            if meta is None:
                meta = json.loads(zf.read("meta.json"))

            def copy_into(live, name):
                saved = _npz_leaves(zf, name, len(live))
                for dst, src in zip(live, saved):
                    if tuple(dst.shape) != tuple(src.shape):
                        raise ValueError(f"{name}: leaf shape {tuple(src.shape)} "
                                         f"!= {tuple(dst.shape)}")
                    dst.copy_(torch.from_numpy(np.asarray(src)).to(dst.dtype))

            copy_into(tree_leaves(model.params), "params.npz")
            copy_into(tree_leaves(model.net_state or {}), "netstate.npz")
            if "updater.npz" in zf.namelist() and model.opt_state is not None:
                from deeplearning4j_tpu_torch.parallel.zero import unwrap_opt_state

                # a slice has its leaf's place in the state: the same count
                want = len(updaters.state_leaves(unwrap_opt_state(model.opt_state)[0]))
                model.opt_state = _load_opt_into(
                    model, _npz_leaves(zf, "updater.npz", want))
        model.iteration = meta.get("iteration", 0)
        model._compute = None
        model._last_score = None
        return meta


def _load_opt_into(model, leaves):
    """The saved optimizer leaves copied into the model's live state in
    place (its counts from the file): whole, or under ZeRO this rank's
    slices (a ZeRO-2 accumulator stays, zeroed)."""
    from deeplearning4j_tpu_torch.parallel.zero import unwrap_opt_state

    inner, acc = unwrap_opt_state(model.opt_state)
    zp = getattr(model, "_zero_placement", None)
    if zp is None:
        return updaters.load_state_leaves(inner, leaves)
    full = updaters.load_state_leaves(model._init_opt_state(), leaves)
    inner = zp.load_state(inner, full)
    if acc is None:
        return inner
    for a in acc:
        a.zero_()
    return {"opt": inner, "grad_accum": acc}


class CheckpointStore:
    """A directory of rolling ``ckpt_<step>.zip`` files with
    verification, last-good fallback and garbage collection (JAX
    `CheckpointStore`).

    Single writer; readers may scan meanwhile.  `save` publishes
    atomically and collects; `latest_valid` walks the directory newest
    first and returns the first checkpoint that passes verification (a
    corrupt newest file is skipped and counted, not fatal).  It is also
    a `PreemptionHandler` checkpointer (``save(model)`` + ``wait()``).
    ``device``: where `restore_latest` / `restore_model` build the model
    (CUDA unless the caller asks for the CPU).
    """

    def __init__(self, directory: str, keep_last: int = 3,
                 prefix: str = "ckpt_", device=None):
        if keep_last < 1:
            raise ValueError("keep_last must be >= 1")
        self.directory = directory
        self.keep_last = keep_last
        self.prefix = prefix
        self.device = device
        self._name_re = re.compile(re.escape(prefix) + r"(\d+)\.zip$")
        # steps gc() never collects: a live RecoveryPolicy's rollback target
        self._pins: set[int] = set()
        # (step, path) callables run after each publish, before gc
        self._save_listeners: list = []

    # -- naming / scanning -------------------------------------------------
    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}{step:08d}.zip")

    def _scan(self) -> list[tuple[int, str]]:
        """[(step, path)] on disk, newest first; ``.tmp`` orphans and
        foreign files ignored."""
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        out = []
        for n in names:
            m = self._name_re.match(n)
            if m:
                out.append((int(m.group(1)), os.path.join(self.directory, n)))
        out.sort(reverse=True)
        return out

    def all_steps(self) -> list[int]:
        """Steps on disk (unverified), ascending."""
        return sorted(s for s, _ in self._scan())

    # -- write side --------------------------------------------------------
    def save(self, model, step: Optional[int] = None) -> int:
        """Write ``model`` at ``step`` (default: its iteration), publish
        atomically, notify the save listeners, collect.  Returns the
        step."""
        step = int(model.iteration if step is None else step)
        os.makedirs(self.directory, exist_ok=True)
        ModelSerializer.write_model(model, self.path_for(step))
        for cb in list(self._save_listeners):
            try:
                cb(step, self.path_for(step))
            except Exception:
                log.exception("checkpoint save listener failed")
        self.gc()
        return step

    def add_save_listener(self, cb) -> None:
        """Register a ``(step, path)`` callable run after every publish,
        before gc."""
        if cb not in self._save_listeners:
            self._save_listeners.append(cb)

    def remove_save_listener(self, cb) -> None:
        if cb in self._save_listeners:
            self._save_listeners.remove(cb)

    def wait(self) -> None:
        """The `PreemptionHandler` checkpointer contract: writes are
        synchronous."""

    def pin(self, step: int) -> None:
        """Keep ``step``'s checkpoint from gc() until unpinned."""
        self._pins.add(int(step))

    def unpin(self, step: int) -> None:
        self._pins.discard(int(step))

    def pinned_steps(self) -> set[int]:
        return set(self._pins)

    def gc(self) -> None:
        """Delete checkpoints beyond the newest ``keep_last``, except
        pinned steps, and any ``.tmp`` orphan (a dead writer's torn file:
        this is the only writer)."""
        kept = 0
        for step, path in self._scan():
            if kept < self.keep_last:
                kept += 1
                continue
            if step in self._pins:
                continue
            try:
                os.remove(path)
            except OSError:
                pass
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return
        for n in names:
            if n.startswith(self.prefix) and n.endswith(".tmp"):
                try:
                    os.remove(os.path.join(self.directory, n))
                except OSError:
                    pass

    # -- read side ---------------------------------------------------------
    def iter_valid(self, check_finite: bool = False):
        """Yield ``{"step", "path", "meta"}`` for every checkpoint that
        passes verification, newest first.  A corrupt file is skipped,
        logged with its defect and counted (verify's ``corrupt``), never
        raised; ``check_finite`` also skips files whose params hold NaN /
        Inf (``nonfinite``)."""
        for step, path in self._scan():
            try:
                meta = ModelSerializer.verify(path)
            except CheckpointVerifyError as e:
                log.warning("CheckpointStore skipping step %d (%s): %s",
                            step, path, e)
                continue
            if check_finite:
                try:
                    nonfinite = params_nonfinite(path)
                except Exception as e:
                    count_skipped_checkpoint(
                        path, f"unreadable_params:{type(e).__name__}")
                    continue
                if nonfinite:
                    count_skipped_checkpoint(path, "nonfinite")
                    continue
            yield {"step": step, "path": path, "meta": meta}

    def latest_valid(self, check_finite: bool = False) -> Optional[dict]:
        """The newest checkpoint that passes verification (and the
        NaN / Inf screen with ``check_finite``), or None."""
        return next(self.iter_valid(check_finite=check_finite), None)

    def restore_latest(self, check_finite: bool = False):
        """The newest valid checkpoint restored on ``device``, or None."""
        entry = self.latest_valid(check_finite=check_finite)
        if entry is None:
            return None
        return ModelSerializer.restore(entry["path"], verify=False,
                                       device=self.device)

    # -- serving hook ------------------------------------------------------
    def serve_into(self, *servers):
        """Push every newly published checkpoint to each target as a
        verified hot-swap (``push_checkpoint(path, source=...)``: an
        `serving.InferenceServer` or a `serving.ServingFleet`).  One
        target's push raising is logged and counted
        (``dl4jtpu_serving_hotswap_total{result="push_error"}``) and never
        stops the others.  Returns the save listener (pass it to
        `remove_save_listener` to detach)."""
        if not servers:
            raise ValueError("serve_into needs at least one target")
        targets = list(servers)

        def _push(step: int, path: str) -> None:
            for target in targets:
                try:
                    target.push_checkpoint(path, source=f"ckpt_step_{step}")
                except Exception:
                    log.exception("serve_into push to %r failed at step %d",
                                  target, step)
                    _count_push_error()

        self.add_save_listener(_push)
        return _push

    def restore_model(self, step: int):
        """Restore a given step (verifying it first) on ``device``."""
        return ModelSerializer.restore(self.path_for(step), device=self.device)
