"""Serving flight recorder — post-mortem dumps for the generation plane.

`runtime/crash.py` answers "why did the TRAINING step hang" with a
hang report written at abort time; nothing answered the serving twin:
"what was every recent stream doing when the decode plane went bad?".
This module is that answer.  The engine appends one bounded record per
settled stream (timings breakdown, KV pages held, outcome, trace id),
and the ring is snapshotted to a JSON dump whenever one of four
triggers fires:

- ``watchdog_abort``  — the decode watchdog aborted a wedged dispatch
- ``breaker_open``    — the shared circuit breaker tripped open
- ``kv_exhausted_spike`` — KV-pool 429s clustered inside a short window
- ``slo_alert``       — a burn-rate alert crossed its rising edge
  (wired via `observe.slo.add_alert_listener`; observe/ never imports
  serving/)

Dumps land next to hang reports (``DL4JTPU_CRASH_DIR``, default cwd)
as ``dl4jtpu-flight-record-<ms>-<seq>.json`` with schema
``dl4jtpu-flight-record/1``: trigger, trigger context, the per-stream
records, and whatever engine/KV state the caller attaches.  Per-trigger
cooldowns keep a flapping breaker from filling the disk; every write
is best-effort — the recorder must never take the serving plane down
with it.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
import weakref
from collections import deque
from typing import Callable, Optional

from deeplearning4j_tpu_torch.runtime.crash import ENV_CRASH_DIR

log = logging.getLogger("deeplearning4j_tpu_torch")

#: settled-stream records retained (oldest evicted first)
FLIGHT_RING_CAP = 256
#: trailing window (s) over which KV-exhaustion 429s count as a spike
KV_SPIKE_WINDOW_S = 5.0
#: 429s inside the window that constitute a spike
KV_SPIKE_THRESHOLD = 3
#: default per-trigger dump cooldown (s)
DUMP_COOLDOWN_S = 30.0

_dump_seq = itertools.count()


class FlightRecorder:
    """Bounded ring of per-stream records + triggered JSON dumps.

    Thread-safe: `record`/`note_kv_exhausted` run on the decode loop,
    `dump` can arrive from the watchdog monitor thread or an SLO
    evaluation tick concurrently.
    """

    def __init__(self, capacity: int = FLIGHT_RING_CAP,
                 cooldown_s: float = DUMP_COOLDOWN_S,
                 spike_window_s: float = KV_SPIKE_WINDOW_S,
                 spike_threshold: int = KV_SPIKE_THRESHOLD):
        self._records: deque = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self.cooldown_s = cooldown_s
        self.spike_window_s = spike_window_s
        self.spike_threshold = max(1, int(spike_threshold))
        self._rejects: deque = deque(maxlen=64)   # 429 timestamps
        self._last_dump: dict = {}                # trigger -> monotonic t
        self.dumps_written = 0
        self.dump_paths: list = []
        #: callable returning extra context merged into every dump
        #: (the owning engine attaches its stats/KV snapshot here)
        self.context_fn: Optional[Callable[[], dict]] = None
        self._slo_listener = None

    # -- the ring ------------------------------------------------------------
    def record(self, rec: dict) -> None:
        """Append one settled-stream record (oldest evicted at cap)."""
        with self._lock:
            self._records.append(rec)
            n = len(self._records)
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().gauge("dl4jtpu_flight_records").set(float(n))
        except Exception as e:
            log.debug("flight ring gauge failed: %s", e)

    def snapshot(self) -> list:
        with self._lock:
            return list(self._records)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    # -- triggers ------------------------------------------------------------
    def note_kv_exhausted(self) -> Optional[str]:
        """Count one KV-pool 429; dump when they cluster (>= threshold
        inside the trailing spike window).  Returns the dump path when
        a spike fired."""
        now = time.monotonic()
        with self._lock:
            self._rejects.append(now)
            cutoff = now - self.spike_window_s
            recent = sum(1 for t in self._rejects if t >= cutoff)
        if recent >= self.spike_threshold:
            return self.dump("kv_exhausted_spike",
                             context={"rejects_in_window": recent,
                                      "window_s": self.spike_window_s})
        return None

    def dump(self, trigger: str, context: Optional[dict] = None,
             path: Optional[str] = None, force: bool = False,
             ) -> Optional[str]:
        """Snapshot the ring to a post-mortem JSON file.  Per-trigger
        cooldown unless `force`; returns the path, or None when on
        cooldown or the write failed (best-effort by contract)."""
        now = time.monotonic()
        with self._lock:
            last = self._last_dump.get(trigger)
            if (not force and last is not None
                    and now - last < self.cooldown_s):
                return None
            self._last_dump[trigger] = now
            records = list(self._records)
        doc = {
            "schema": "dl4jtpu-flight-record/1",
            "trigger": trigger,
            "time": time.time(),
            "context": context or {},
            "records": records,
        }
        try:
            if self.context_fn is not None:
                doc["engine"] = self.context_fn()
        except Exception as e:
            doc["engine"] = {"error": str(e)}
        try:
            from deeplearning4j_tpu_torch.observe.slo import active_engine

            eng = active_engine()
            if eng is not None:
                doc["slo"] = eng.state()      # last tick, no resample
        except Exception as e:
            log.debug("flight dump slo join failed: %s", e)
        if path is None:
            path = os.path.join(
                os.environ.get(ENV_CRASH_DIR, "."),
                f"dl4jtpu-flight-record-{int(time.time() * 1000)}"
                f"-{next(_dump_seq)}.json",
            )
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, default=str)
            os.replace(tmp, path)
        except Exception as e:
            log.warning("flight-recorder dump failed: %s", e)
            return None
        with self._lock:
            self.dumps_written += 1
            self.dump_paths.append(path)
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().counter("dl4jtpu_flight_dumps_total").inc(
                trigger=trigger)
        except Exception as e:
            log.debug("flight dump counter failed: %s", e)
        log.warning("flight recorder dumped %d stream records to %s "
                    "(trigger=%s)", len(records), path, trigger)
        return path

    # -- SLO wiring ----------------------------------------------------------
    def attach_slo_trigger(self) -> None:
        """Register a process-wide rising-edge listener that dumps this
        ring on any SLO alert.  Holds only a weakref to the recorder;
        `detach_slo_trigger` (or recorder GC) unhooks it."""
        from deeplearning4j_tpu_torch.observe import slo

        if self._slo_listener is not None:
            return
        ref = weakref.ref(self)

        def _on_alert(name: str, state: dict) -> None:
            rec = ref()
            if rec is None:
                slo.remove_alert_listener(_on_alert)
                return
            rec.dump("slo_alert",
                     context={"objective": name, "state": state})

        self._slo_listener = _on_alert
        slo.add_alert_listener(_on_alert)

    def detach_slo_trigger(self) -> None:
        if self._slo_listener is None:
            return
        from deeplearning4j_tpu_torch.observe import slo

        slo.remove_alert_listener(self._slo_listener)
        self._slo_listener = None
