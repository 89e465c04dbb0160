"""Bounded on-disk quarantine for poison batches —
`deeplearning4j_tpu/data/quarantine.py`.

One corrupt record — a decoder emitting NaNs, a truncated image, a
shape-drifted example — used to kill an entire run: the fit loop either
raised out of the batch pull or trained a NaN into the params.  The
`RecoveryPolicy` (train/recovery.py) diverts such batches HERE instead:
the bytes (when the batch object survived) plus a JSON metadata record
land in a directory a human can replay offline, the run continues, and
``dl4jtpu_quarantined_batches_total{reason=...}`` says how often.

Bounded by design: at most ``cap`` entries are ever written (a fully
poisoned feed must fill a quota, not a disk), after which `put()`
returns None and the caller decides whether to keep dropping or to
fail loudly — `RecoveryPolicy` fails loudly.

Layout per entry (``q_<seq>`` naming, seq monotonic per store)::

    q_00000.json   {"reason", "error", "time", "shapes", "has_bytes"}
    q_00000.npz    features/labels/masks arrays (only when a batch
                   object was available — pull-time failures have no
                   bytes to save)
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import numpy as np

log = logging.getLogger("deeplearning4j_tpu_torch")


class QuarantineStore:
    """Directory of quarantined batches, capped at `cap` entries.

    Single-writer (the fit thread's RecoveryPolicy); `entries()` may be
    read any time.  Existing ``q_*.json`` files found at construction
    count against the cap — a restarted run does not get a fresh disk
    budget for the same poisoned feed.
    """

    def __init__(self, directory: str, cap: int = 16):
        if cap < 1:
            raise ValueError("quarantine cap must be >= 1")
        self.directory = directory
        self.cap = int(cap)
        self._seq = 0
        try:
            existing = [
                n for n in os.listdir(directory)
                if n.startswith("q_") and n.endswith(".json")
            ]
        except FileNotFoundError:
            existing = []
        if existing:
            self._seq = 1 + max(
                int(n[2:-5]) for n in existing if n[2:-5].isdigit()
            )

    def __len__(self) -> int:
        try:
            return sum(
                1 for n in os.listdir(self.directory)
                if n.startswith("q_") and n.endswith(".json")
            )
        except FileNotFoundError:
            return 0

    @property
    def full(self) -> bool:
        return len(self) >= self.cap

    def put(self, reason: str, batch=None,
            error: Optional[BaseException] = None,
            meta: Optional[dict] = None) -> Optional[str]:
        """Quarantine one batch; returns the metadata path, or None when
        the cap is reached (nothing written — the caller escalates)."""
        from deeplearning4j_tpu_torch.data.dataset import named_arrays

        if self.full:
            return None
        os.makedirs(self.directory, exist_ok=True)
        stem = os.path.join(self.directory, f"q_{self._seq:05d}")
        self._seq += 1
        arrays = named_arrays(batch) if batch is not None else {}
        record = {
            "reason": reason,
            "error": (f"{type(error).__name__}: {error}"
                      if error is not None else None),
            "time": time.time(),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "has_bytes": bool(arrays),
        }
        if meta:
            record.update(meta)
        if arrays:
            with open(stem + ".npz", "wb") as f:
                np.savez(f, **arrays)
        path = stem + ".json"
        with open(path, "w") as f:
            json.dump(record, f, indent=1, default=str)
        log.warning("quarantined batch -> %s (%s)", path, reason)
        return path

    def entries(self) -> list[dict]:
        """Metadata records on disk, oldest first (each carries its
        ``path``; sibling ``.npz`` holds the bytes when has_bytes)."""
        try:
            names = sorted(
                n for n in os.listdir(self.directory)
                if n.startswith("q_") and n.endswith(".json")
            )
        except FileNotFoundError:
            return []
        out = []
        for n in names:
            p = os.path.join(self.directory, n)
            try:
                with open(p) as f:
                    rec = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                log.debug("unreadable quarantine record %s: %s", p, e)
                continue
            rec["path"] = p
            out.append(rec)
        return out
