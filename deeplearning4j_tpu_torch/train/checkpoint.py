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

A failed verify is logged and counted under
``dl4jtpu_ckpt_verify_failures_total{reason="corrupt"}``.  Not ported
yet: the fault-injection sites ``checkpoint.write`` and
``checkpoint.fsync`` and `CheckpointStore` (ROADMAP A9), and
``write_model_distributed`` (A11).  A ``GraphModel`` (computation
graph) checkpoint has the same entries, its trees keyed by ``param_key``.
"""

from __future__ import annotations

import io
import json
import logging
import os
import zipfile
import zlib
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.models.model import tree_leaves
from deeplearning4j_tpu_torch.nn import updaters
from deeplearning4j_tpu_torch.quant.qtensor import QuantizedTensor
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
    it = iter(leaves)

    def take(ref):
        return torch.from_numpy(np.asarray(next(it)).astype(
            str(ref.dtype).removeprefix("torch."), copy=True))

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, QuantizedTensor):
            return QuantizedTensor(take(node.q), take(node.scale))
        return take(node)

    return walk(tree)


def _updater_state(model):
    """The optimizer state a checkpoint holds: the model's, or the fresh
    state the JAX package's model carries from ``init`` on; none for an
    int8 model, which takes no updates."""
    if model._quantized is not None:
        return model.opt_state
    if model.opt_state is None:
        return model._tx.init(tree_leaves(model.params))
    return model.opt_state


# the configuration class each model class is built from
_CONF_OF = {"SequentialModel": "SequentialConfiguration",
            "GraphModel": "GraphConfiguration"}


def _model_classes() -> dict:
    from deeplearning4j_tpu_torch.models.computation_graph import GraphModel
    from deeplearning4j_tpu_torch.models.sequential import SequentialModel

    return {"SequentialModel": SequentialModel, "GraphModel": GraphModel}


class ModelSerializer:
    @staticmethod
    def write_model(model, path: str, save_updater: bool = True) -> None:
        """Write the checkpoint zip atomically: the bytes land in
        ``path + ".tmp"``, are fsynced, and only then renamed over
        ``path``, so a reader sees the old file or the new one, never a
        torn write."""
        if model.params is None:
            raise RuntimeError("model not initialized")
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
                {"model_class": type(model).__name__,
                 "conf": serde.to_jsonable(model.conf)}, indent=2).encode())
            put("params.npz", *_npz_bytes(tree_leaves(model.params)))
            put("netstate.npz", *_npz_bytes(tree_leaves(model.net_state or {})))
            opt = _updater_state(model) if save_updater else None
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
                state = (model._tx.init(tree_leaves(model.params))
                         if quantized is None else ())
                want = len(updaters.state_leaves(state))
                model.opt_state = updaters.load_state_leaves(
                    state, _npz_leaves(zf, "updater.npz", want)) or None
            model.iteration = meta.get("iteration", 0)
            model.epoch = meta.get("epoch", 0)
        return model
