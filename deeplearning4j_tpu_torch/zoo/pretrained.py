"""Pretrained-weights registry — `deeplearning4j_tpu/zoo/pretrained.py`,
the `ZooModel.initPretrained()` and `PretrainedType` roles.

The reference downloads checksummed weight archives per (model,
PretrainedType).  This registry is a local directory of ModelSerializer
zips with the same integrity contract: a `registry.json` index mapping
(model, type) -> {file, sha256}, the digest verified on every load.
Weights are registered from local files (a training run, a copied
artifact) instead of downloaded.  The directory, its index, its file
names and its environment variables are the JAX package's, and both
packages read and write one zip format, so a zip either package
registered loads in the other.

    registry = PretrainedRegistry()               # $DL4JTPU_PRETRAINED_DIR
    registry.register("resnet50", "imagenet", "/path/run_final.zip")
    model = ResNet50().init_pretrained("imagenet")
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from pathlib import Path
from typing import Optional

ENV_PRETRAINED_DIR = "DL4JTPU_PRETRAINED_DIR"
_LEGACY_ENV = "DL4J_TPU_PRETRAINED_DIR"      # pre-registry spelling
_DEFAULT_DIR = "~/.dl4j_tpu/models"


class ChecksumMismatchError(IOError):
    pass


def _sha256(path: str | Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class PretrainedRegistry:
    def __init__(self, root: Optional[str] = None):
        self.root = Path(
            root
            or os.environ.get(ENV_PRETRAINED_DIR)
            or os.environ.get(_LEGACY_ENV)
            or _DEFAULT_DIR
        ).expanduser()
        self.index_path = self.root / "registry.json"

    def _load_index(self) -> dict:
        if self.index_path.exists():
            return json.loads(self.index_path.read_text())
        return {}

    def _save_index(self, idx: dict) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        tmp = self.index_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(idx, indent=2, sort_keys=True))
        os.replace(tmp, self.index_path)

    def register(self, model_name: str, pretrained_type: str,
                 file_path: str) -> dict:
        """Copy a ModelSerializer zip into the registry under
        (model, type) and record its sha256."""
        src = Path(file_path)
        if not src.exists():
            raise FileNotFoundError(src)
        self.root.mkdir(parents=True, exist_ok=True)
        dest = self.root / f"{model_name}_{pretrained_type}.zip"
        if src.resolve() != dest.resolve():
            shutil.copyfile(src, dest)
        entry = {"file": dest.name, "sha256": _sha256(dest)}
        idx = self._load_index()
        idx.setdefault(model_name, {})[pretrained_type] = entry
        self._save_index(idx)
        return entry

    def available(self, model_name: Optional[str] = None) -> dict:
        idx = self._load_index()
        return idx.get(model_name, {}) if model_name else idx

    def resolve(self, model_name: str, pretrained_type: str) -> str:
        """Checksum-verified path for (model, type)."""
        idx = self._load_index()
        entry = idx.get(model_name, {}).get(pretrained_type)
        if entry is None:
            have = sorted(idx.get(model_name, {}))
            raise FileNotFoundError(
                f"no pretrained weights registered for {model_name!r} type "
                f"{pretrained_type!r} in {self.root} (registered: {have}). "
                "Register local weights with PretrainedRegistry().register()."
            )
        path = self.root / entry["file"]
        if not path.exists():
            raise FileNotFoundError(
                f"registry entry for {model_name}/{pretrained_type} points "
                f"at missing file {path}"
            )
        got = _sha256(path)
        if got != entry["sha256"]:
            raise ChecksumMismatchError(
                f"{path}: sha256 {got} != registered {entry['sha256']} — "
                "file corrupted or replaced; re-register it"
            )
        return str(path)
