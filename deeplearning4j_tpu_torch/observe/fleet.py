"""Fleet-wide metrics & trace aggregation — the cluster view; the port's
copy of `deeplearning4j_tpu/observe/fleet.py` (host Python: it merges
text and JSON, touches no tensor).

- **worker side** (`FleetReporter`): pushes a compact snapshot — the
  process's full Prometheus text exposition, a step-latency summary
  (histogram sum/count), its serving summary (replica health and router
  state), its SLO state and (when tracing is enabled) the new spans of
  its Chrome-trace ring — through ``client.push_metrics(payload)``, any
  object with that method.
- **aggregator side** (`FleetAggregator`): ingests per-worker payloads
  and serves a merged Prometheus exposition (every worker's families
  re-labeled with ``worker="..."`` plus the fleet meta-families: worker
  count, per-worker recent step latency, skew, straggler count), the
  same fleet gauges into the local registry (`make_collector`), the
  serving, SLO and generation views, and one merged cluster timeline
  (``observe.trace.merge_chrome_traces``, pid = worker rank).

The JAX package wires these into its coordinator and serves them on its
UI server (``/metrics/cluster``, ``/api/trace/cluster``); the port has
neither yet (ROADMAP A11 and A13), so nothing here is wired to an
endpoint.

Skew accounting: each worker's RECENT mean step latency is the delta of
its histogram sum/count between consecutive pushes (falling back to the
lifetime mean on the first push).  ``skew`` = slowest/fastest recent
mean; a worker is a straggler when its recent mean exceeds
``DL4J_TPU_STRAGGLER_FACTOR`` (default 1.5) times the fleet median.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

log = logging.getLogger("deeplearning4j_tpu_torch")


def straggler_factor() -> float:
    try:
        return float(os.environ.get("DL4J_TPU_STRAGGLER_FACTOR", "1.5"))
    except ValueError:
        return 1.5


def worker_ttl() -> float:
    """Seconds after a worker's last push before its snapshot stops
    counting (and is dropped): a dead generation-1 worker must not set
    the straggler median — or keep a frozen skew alarm — forever on a
    long-lived coordinator."""
    try:
        return float(os.environ.get("DL4J_TPU_FLEET_WORKER_TTL", "120"))
    except ValueError:
        return 120.0


def _median(vals: list) -> float:
    """True median (mean of the two middles for even n).  The upper
    median would make a 2-worker fleet's straggler check impossible to
    trip: the slow worker IS the upper median, so it can never exceed
    factor x itself."""
    n = len(vals)
    mid = n // 2
    if n % 2:
        return vals[mid]
    return (vals[mid - 1] + vals[mid]) / 2.0


# -- Prometheus text merge --------------------------------------------------

def _inject_label(sample: str, label: str) -> Optional[tuple[str, str]]:
    """('name', rewritten sample line) with `label` injected into the
    sample's label set; None for lines that don't parse as samples."""
    brace = sample.find("{")
    if brace >= 0:
        close = sample.rfind("}")
        if close < brace:
            return None
        name = sample[:brace]
        labels = sample[brace + 1:close]
        rest = sample[close + 1:]
        if labels.startswith('worker="') or ',worker="' in labels:
            # a pushing process that itself aggregates (a coordinator's
            # own heartbeat-age series) already carries a worker label;
            # a duplicate label name would be invalid exposition
            return name, sample
        labels = f"{labels},{label}" if labels else label
        return name, f"{name}{{{labels}}}{rest}"
    parts = sample.split(None, 1)
    if len(parts) != 2:
        return None
    name, value = parts
    return name, f"{name}{{{label}}} {value}"


def merge_prometheus_texts(texts: dict) -> str:
    """Merge per-worker Prometheus expositions into one document: every
    sample gains a ``worker`` label; HELP/TYPE emitted once per family
    with all workers' samples grouped under it (the text format forbids
    interleaved families).  ``texts`` maps worker id -> exposition."""
    from deeplearning4j_tpu_torch.observe.metrics import _escape_label

    families: dict = {}          # family -> {"help":, "type":, "samples": []}
    order: list = []
    sample_owner: dict = {}      # sample name -> family name

    def family(name: str) -> dict:
        if name not in families:
            families[name] = {"help": None, "type": None, "samples": []}
            order.append(name)
        return families[name]

    for worker in sorted(texts):
        label = f'worker="{_escape_label(str(worker))}"'
        for line in (texts[worker] or "").splitlines():
            if not line.strip():
                continue
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                parts = line.split(None, 3)
                if len(parts) < 3:
                    continue
                fam = family(parts[2])
                kind = "help" if parts[1] == "HELP" else "type"
                if fam[kind] is None:
                    fam[kind] = line
                if kind == "type" and len(parts) == 4 and (
                    parts[3].strip() == "histogram"
                ):
                    for suffix in ("_bucket", "_sum", "_count"):
                        sample_owner[parts[2] + suffix] = parts[2]
                continue
            if line.startswith("#"):
                continue
            parsed = _inject_label(line, label)
            if parsed is None:
                continue
            name, rewritten = parsed
            family(sample_owner.get(name, name))["samples"].append(rewritten)

    out: list = []
    for name in order:
        fam = families[name]
        if fam["help"]:
            out.append(fam["help"])
        if fam["type"]:
            out.append(fam["type"])
        out.extend(fam["samples"])
    return "\n".join(out) + "\n" if out else ""


# -- aggregator -------------------------------------------------------------

class FleetAggregator:
    """Coordinator-side store of per-worker telemetry pushes."""

    def __init__(self):
        self._lock = threading.Lock()
        self._workers: dict = {}     # worker id -> state dict
        self.snapshots = 0

    # -- ingestion ---------------------------------------------------------
    def ingest(self, worker: str, payload: dict) -> None:
        """Accept one pushed snapshot.  Payload keys (all optional):
        ``rank``, ``prom`` (text exposition), ``step_latency_sum``,
        ``step_latency_count``, ``trace`` (Chrome trace doc),
        ``serving`` (replica/router health summary), ``slo`` (the
        worker's SLO burn-rate state)."""
        now = time.time()
        with self._lock:
            st = self._workers.setdefault(worker, {
                "rank": None, "prom": "", "trace": None, "serving": None,
                "slo": None,
                "sum": 0.0, "count": 0, "recent_mean": None,
                "first_push": now, "last_push": now,
            })
            if payload.get("rank") is not None:
                st["rank"] = int(payload["rank"])
            if payload.get("prom") is not None:
                st["prom"] = str(payload["prom"])
            if payload.get("serving") is not None:
                st["serving"] = payload["serving"]
            if payload.get("slo") is not None:
                st["slo"] = payload["slo"]
            if payload.get("trace") is not None:
                doc = payload["trace"]
                prev = st["trace"]
                if prev is None:
                    st["trace"] = {
                        "traceEvents": list(doc.get("traceEvents", [])),
                        "metadata": doc.get("metadata") or {},
                    }
                else:
                    # pushes are INCREMENTAL (the reporter's span
                    # cursor): append the new events, keep a bounded
                    # tail, take the freshest metadata (its drop count
                    # is cumulative)
                    merged = (prev.get("traceEvents", [])
                              + list(doc.get("traceEvents", [])))
                    prev["traceEvents"] = merged[-TRACE_EVENTS_PER_WORKER:]
                    if doc.get("metadata"):
                        prev["metadata"] = doc["metadata"]
            s = payload.get("step_latency_sum")
            c = payload.get("step_latency_count")
            if s is not None and c is not None:
                s, c = float(s), int(c)
                dc = c - st["count"]
                if dc > 0:
                    # windowed mean over the batches since the last push
                    # (a restarted worker resets below zero: fall back to
                    # the lifetime mean)
                    st["recent_mean"] = (s - st["sum"]) / dc
                elif c > 0:
                    st["recent_mean"] = s / c
                st["sum"], st["count"] = s, c
            st["last_push"] = now
            self.snapshots += 1

    def _prune_locked(self) -> None:
        """With the lock held: drop workers whose last push is older
        than the TTL — departed/dead workers must not pollute the skew
        median or keep serving frozen series."""
        cutoff = time.time() - worker_ttl()
        for w in [w for w, st in self._workers.items()
                  if st["last_push"] < cutoff]:
            # every caller (workers, latency_view, to_prometheus_text,
            # to_cluster_trace) holds self._lock; the name says so
            del self._workers[w]

    def workers(self) -> list[str]:
        with self._lock:
            self._prune_locked()
            return sorted(self._workers)

    # -- skew / straggler view ---------------------------------------------
    def latency_view(self) -> dict:
        """{worker: recent mean step latency}, plus ``skew`` (slowest /
        fastest) and ``stragglers`` (workers above factor x the true
        median)."""
        with self._lock:
            self._prune_locked()
            means = {
                w: st["recent_mean"]
                for w, st in self._workers.items()
                if st["recent_mean"] is not None and st["recent_mean"] > 0
            }
        out = {"workers": means, "skew": None, "stragglers": []}
        if not means:
            return out
        vals = sorted(means.values())
        out["skew"] = vals[-1] / vals[0] if vals[0] > 0 else None
        median = _median(vals)
        factor = straggler_factor()
        out["stragglers"] = sorted(
            w for w, m in means.items() if m > factor * median
        )
        return out

    def serving_view(self) -> dict:
        """{worker: last pushed serving summary} — the cluster's
        replica/router health in one place (each worker's router
        metrics already ride its ``prom`` text into the merged scrape;
        this is the structured view the dashboard joins on)."""
        with self._lock:
            self._prune_locked()
            return {w: st["serving"] for w, st in self._workers.items()
                    if st.get("serving") is not None}

    def slo_view(self) -> dict:
        """{worker: last pushed SLO burn-rate state} — the coordinator
        sees every replica's burn rate (served at ``GET /api/slo``),
        so a fleet-wide objective breach is one read, not N scrapes."""
        with self._lock:
            self._prune_locked()
            return {w: st["slo"] for w, st in self._workers.items()
                    if st.get("slo") is not None}

    def generation_view(self) -> dict:
        """{worker: [per-replica generation health]} — the generation
        plane across the fleet in one read.  Each replica's
        ``health()`` payload carries a ``generation`` block (stream
        outcomes, tokens/s, KV occupancy, flight-dump count) when
        token generation is enabled; this filters the pushed serving
        summaries down to those blocks so "which replica's decode
        plane is sick" needs no per-worker scrape."""
        out: dict = {}
        for w, summary in self.serving_view().items():
            gens = [s["generation"] for s in summary.get("servers", ())
                    if isinstance(s, dict) and "generation" in s]
            if gens:
                out[w] = gens
        return out

    # -- merged expositions -------------------------------------------------
    def _fleet_text(self) -> str:
        """The fleet meta-families, rendered directly (these describe the
        FLEET, so they carry no worker label except the per-worker
        latency gauge)."""
        from deeplearning4j_tpu_torch.observe.metrics import _escape_label

        view = self.latency_view()          # prunes expired workers
        with self._lock:
            n = len(self._workers)
        lines = [
            "# HELP dl4jtpu_fleet_workers Workers that have pushed a "
            "telemetry snapshot",
            "# TYPE dl4jtpu_fleet_workers gauge",
            f"dl4jtpu_fleet_workers {n}",
            "# HELP dl4jtpu_fleet_snapshots_total Telemetry snapshots "
            "ingested from workers",
            "# TYPE dl4jtpu_fleet_snapshots_total counter",
            f"dl4jtpu_fleet_snapshots_total {self.snapshots}",
            "# HELP dl4jtpu_fleet_step_latency_seconds Recent mean step "
            "latency per worker (windowed between pushes)",
            "# TYPE dl4jtpu_fleet_step_latency_seconds gauge",
        ]
        for w, m in sorted(view["workers"].items()):
            lines.append(
                f'dl4jtpu_fleet_step_latency_seconds'
                f'{{worker="{_escape_label(w)}"}} {m:.6g}'
            )
        lines += [
            "# HELP dl4jtpu_fleet_step_latency_skew Slowest/fastest "
            "worker recent mean step latency",
            "# TYPE dl4jtpu_fleet_step_latency_skew gauge",
        ]
        if view["skew"] is not None:
            lines.append(f"dl4jtpu_fleet_step_latency_skew "
                         f"{view['skew']:.6g}")
        lines += [
            "# HELP dl4jtpu_fleet_stragglers Workers whose recent mean "
            "step latency exceeds the straggler threshold",
            "# TYPE dl4jtpu_fleet_stragglers gauge",
            f"dl4jtpu_fleet_stragglers {len(view['stragglers'])}",
        ]
        return "\n".join(lines) + "\n"

    def to_prometheus_text(self) -> str:
        """The merged cluster exposition: fleet meta-families first, then
        every worker's own families with ``worker`` labels.  Pushed
        ``dl4jtpu_fleet_*`` samples are dropped — the aggregator is the
        authority for those, and a process that both coordinates and
        pushes (single-host drives) would otherwise echo stale copies
        of its own skew gauges under a worker label."""
        with self._lock:
            self._prune_locked()
            texts = {w: st["prom"] for w, st in self._workers.items()
                     if st["prom"]}
        merged = merge_prometheus_texts(texts)
        kept: list = []
        dropping = False
        for line in merged.splitlines():
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                dropping = line.split(None, 3)[2].startswith(
                    "dl4jtpu_fleet_"
                )
            elif not line.startswith("#"):
                if line.startswith("dl4jtpu_fleet_"):
                    continue
            if not dropping:
                kept.append(line)
        body = "\n".join(kept)
        return self._fleet_text() + (body + "\n" if body else "")

    def to_cluster_trace(self) -> dict:
        """One merged Chrome trace: pid = worker rank (fallback: sorted
        index), process_name metadata per worker."""
        from deeplearning4j_tpu_torch.observe.trace import merge_chrome_traces

        with self._lock:
            self._prune_locked()
            traces = {w: st["trace"] for w, st in self._workers.items()
                      if st["trace"]}
            pids = {w: st["rank"] for w, st in self._workers.items()
                    if st["rank"] is not None}
        return merge_chrome_traces(traces, pids=pids)

    # -- local-registry bridge ----------------------------------------------
    def make_collector(self):
        """A pull collector for the LOCAL metrics registry: sets the
        fleet gauges at scrape time so the coordinator's plain /metrics
        carries the skew/straggler signal.  Returns (collector,
        cleanup) — cleanup drops this aggregator's per-worker series."""
        from deeplearning4j_tpu_torch.observe.metrics import registry

        reg = registry()
        workers_g = reg.gauge("dl4jtpu_fleet_workers")
        snaps = reg.counter("dl4jtpu_fleet_snapshots_total")
        lat = reg.gauge("dl4jtpu_fleet_step_latency_seconds")
        skew = reg.gauge("dl4jtpu_fleet_step_latency_skew")
        strag = reg.gauge("dl4jtpu_fleet_stragglers")
        seen: set = set()
        seen_lock = threading.Lock()

        def collect() -> None:
            view = self.latency_view()      # prunes expired workers
            with self._lock:
                n = len(self._workers)
            workers_g.set(n)
            snaps.set_total(self.snapshots)
            with seen_lock:
                for w in seen - set(view["workers"]):
                    lat.remove(worker=w)
                seen.clear()
                seen.update(view["workers"])
                for w, m in view["workers"].items():
                    lat.set(m, worker=w)
            if view["skew"] is not None:
                skew.set(view["skew"])
            else:
                # no live comparison: DROP the series instead of
                # freezing the last fleet's skew as a permanent alarm
                skew.remove()
            strag.set(len(view["stragglers"]))

        def cleanup() -> None:
            with seen_lock:
                for w in seen:
                    lat.remove(worker=w)
                seen.clear()
            workers_g.set(0)
            skew.remove()
            strag.set(0)

        return collect, cleanup


# -- active-aggregator hook (the UIServer's lookup point) -------------------

_ACTIVE: Optional[FleetAggregator] = None
_ACTIVE_LOCK = threading.Lock()


def set_active_aggregator(agg: Optional[FleetAggregator]) -> None:
    global _ACTIVE
    with _ACTIVE_LOCK:
        _ACTIVE = agg


def clear_active_aggregator(agg: FleetAggregator) -> None:
    """Drop `agg` iff it is still the active one (a newer coordinator's
    aggregator must not be clobbered by an older one's stop())."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        if _ACTIVE is agg:
            _ACTIVE = None


def active_aggregator() -> Optional[FleetAggregator]:
    with _ACTIVE_LOCK:
        return _ACTIVE


# -- worker side ------------------------------------------------------------

def _serving_summary() -> Optional[dict]:
    """Compact serving-plane summary for the worker push: per-replica
    health payloads + per-router routing state.  None when this
    process serves nothing (training-only workers pay zero)."""
    try:
        from deeplearning4j_tpu_torch.serving.router import active_routers
        from deeplearning4j_tpu_torch.serving.server import active_servers

        servers = active_servers()
        routers = active_routers()
        if not servers and not routers:
            return None
        return {
            "servers": [s.health() for s in servers],
            "routers": [r.stats() for r in routers],
        }
    except Exception as e:
        # a broken serving plane must not take the telemetry push down
        log.debug("serving summary failed: %s", e)
        return None


def _slo_state() -> Optional[dict]:
    """The active SLO engine's state for the worker push (one fresh
    sample — the coordinator must see burn rates even if nobody scrapes
    this worker's /metrics).  None when no engine is installed."""
    from deeplearning4j_tpu_torch.observe.slo import sample_active_state

    return sample_active_state()


#: cap on trace events shipped per push — the control-plane transport is
#: JSON-lines; a full 16k ring would be a multi-MB line
TRACE_EVENTS_PER_PUSH = 4096
#: per-worker cap on the aggregator's accumulated cluster-trace tail
TRACE_EVENTS_PER_WORKER = 16384


class FleetReporter:
    """Worker-side telemetry pusher.  ``maybe_push()`` is called from the
    elastic heartbeat thread (time-gated); ``push()`` forces one (the
    worker's final snapshot before leaving).

    Trace pushes are INCREMENTAL: an APPEND-ORDER span cursor (spans
    complete out of timestamp order — an umbrella span starts before
    but lands after its sub-spans, so a timestamp cursor would drop
    spans straddling a push) keeps steady-state payloads proportional
    to new activity, not to the ring size — the aggregator appends.
    The Prometheus text is cheap by comparison and always carries full
    totals, so a lost push costs nothing."""

    def __init__(self, client, rank: Optional[int] = None,
                 every_s: float = 2.0):
        self.client = client
        self.rank = rank
        self.every_s = float(every_s)
        self._last = 0.0
        self._trace_cursor = 0          # spans acknowledged (append order)
        self._pending_cursor: Optional[int] = None

    def payload(self) -> dict:
        from deeplearning4j_tpu_torch.observe.metrics import registry
        from deeplearning4j_tpu_torch.observe.trace import tracer

        reg = registry()
        hist = reg.histogram("dl4jtpu_step_latency_seconds")
        out = {
            "rank": self.rank,
            "prom": reg.to_prometheus_text(),
            "step_latency_sum": hist.sum,
            "step_latency_count": hist.count,
        }
        serving = _serving_summary()
        if serving is not None:
            out["serving"] = serving
        slo = _slo_state()
        if slo is not None:
            out["slo"] = slo
        self._pending_cursor = None
        t = tracer()
        if t.enabled:
            if t.appended_total() < self._trace_cursor:
                self._trace_cursor = 0          # ring was clear()ed
            # ONE coherent snapshot: separate total/tail reads of the
            # live ring would shift the window under concurrent appends
            events, total = t.events_since(
                self._trace_cursor, TRACE_EVENTS_PER_PUSH
            )
            if events:
                doc = {
                    "traceEvents": events,
                    "displayTimeUnit": "ms",
                    "metadata": {
                        "spans_dropped": t.spans_dropped,
                        "capacity": t.capacity,
                    },
                }
                if total - self._trace_cursor > TRACE_EVENTS_PER_PUSH:
                    doc["metadata"]["truncated_to"] = (
                        TRACE_EVENTS_PER_PUSH
                    )
                out["trace"] = doc
                self._pending_cursor = total
        return out

    def maybe_push(self) -> bool:
        now = time.time()
        if now - self._last < self.every_s:
            return False
        return self.push()

    def push(self) -> bool:
        self._last = time.time()
        try:
            self.client.push_metrics(self.payload())
        except Exception as e:
            # telemetry must never take down the worker it describes;
            # the next interval retries (the span cursor only advances
            # on a SUCCESSFUL push, so nothing is lost)
            log.debug("fleet metrics push failed: %s", e)
            return False
        if self._pending_cursor is not None:
            self._trace_cursor = self._pending_cursor
        return True
