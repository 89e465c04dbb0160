"""Step-timeline tracing — the host-side half a device profiler cannot
see; the port's copy of `deeplearning4j_tpu/observe/trace.py`.

``torch.profiler`` captures the DEVICE timeline.  What it cannot show is
where the HOST spends a step or a request: blocked on input, staging,
dispatching, or syncing on results.

`TraceRecorder` is a low-overhead ring-buffer span store (fixed
capacity, oldest spans evicted) with a context-manager + decorator API,
emitting Chrome trace-event JSON (`chrome://tracing` / Perfetto `Load
trace`).  Disabled (the default) it costs one attribute check per
call site; enabled it costs two `perf_counter` reads and a deque append
per span — no locks on the hot path beyond the GIL-atomic append.

`StepScope` is the fit loops' per-step scope, arming the model's step
watchdog around the program and its listeners: ``sync`` keeps the
``device.sync`` fault site
and blocks on the card (``torch.cuda.synchronize``) ONLY while tracing
is enabled, so the default (untraced) path keeps host/device overlap.

**Causally-linked request traces** (the serving plane): spans may carry
``trace`` / ``span`` / ``parent`` ids (allocated with `next_id()`,
recorded via the ordinary ``add_complete(..., trace=..., span=...,
parent=...)``).  One inference request emits a linked chain — router
pick -> retry/hedge hops -> per-replica admit -> queue wait -> batch
form -> dispatch — that crosses threads and replicas.  The Chrome
export emits, per linked span, the thread-track "X" slice PLUS an
async ``b``/``e`` pair keyed by the trace id (Perfetto draws the whole
request on one lane), and `to_chrome_trace` adds flow arrows
(``s``/``f``) binding each child slice to its parent.  `trace_chain`
returns one request's spans for programmatic audit (the span-count
ledger), and `chain_is_causal` / `chain_coverage` are the assertions
the serving tests and bench build on.

    from deeplearning4j_tpu_torch.observe import tracer
    t = tracer(); t.enable()
    engine.generate(prompt, 16)
    t.save("step_timeline.json")           # open in Perfetto
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from functools import wraps
from typing import Optional

log = logging.getLogger("deeplearning4j_tpu_torch")


# -- causal ids --------------------------------------------------------------
# one process-wide id sequence for trace AND span ids: a span id can never
# collide with a trace id, so a chain reader needs no namespace bookkeeping.
# next() on itertools.count is a single C call — atomic under the GIL, no
# lock on the request path.
_IDS = itertools.count(1)


def next_id() -> int:
    """Allocate a process-unique trace/span id."""
    return next(_IDS)


def trace_args(trace: Optional[int], span: Optional[int],
               parent: Optional[int] = None) -> dict:
    """The causal-link args for `add_complete` (empty when tracing is
    off / no ids were allocated — call sites don't branch)."""
    if trace is None or span is None:
        return {}
    out = {"trace": trace, "span": span}
    if parent is not None:
        out["parent"] = parent
    return out


def chain_is_causal(chain: list) -> bool:
    """True when `chain` (a `trace_chain` result) is one complete causal
    tree: exactly one root (no parent), and every other span's parent id
    is present in the chain — no orphan spans."""
    if not chain:
        return False
    ids = {s["span"] for s in chain}
    roots = [s for s in chain if s.get("parent") is None]
    if len(roots) != 1:
        return False
    return all(s.get("parent") in ids
               for s in chain if s.get("parent") is not None)


def chain_coverage(chain: list) -> Optional[float]:
    """Fraction of the root span's wall time covered by the UNION of its
    direct children's intervals — "how much of the client-observed
    latency do the recorded hops account for".  None when the chain has
    no usable root."""
    roots = [s for s in chain if s.get("parent") is None]
    if len(roots) != 1 or roots[0]["dur"] <= 0:
        return None
    root = roots[0]
    kids = sorted(
        ((s["t0"], s["t0"] + s["dur"]) for s in chain
         if s.get("parent") == root["span"]),
    )
    covered, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in kids:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                covered += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        covered += cur_hi - cur_lo
    return min(1.0, covered / root["dur"])


class _NullSpan:
    """Shared no-op context manager — the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_rec", "name", "cat", "args", "_t0")

    def __init__(self, rec: "TraceRecorder", name: str, cat: str, args):
        self._rec = rec
        self.name = name
        self.cat = cat
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._rec.add_complete(
            self.name, self._t0, time.perf_counter() - self._t0,
            cat=self.cat, **(self.args or {}),
        )
        return False


class TraceRecorder:
    """Ring buffer of completed spans, Chrome trace-event JSON out."""

    def __init__(self, capacity: int = 16384):
        self.capacity = int(capacity)
        self._spans: deque = deque(maxlen=self.capacity)
        self._enabled = False
        self._pid = os.getpid()
        # spans evicted by ring wrap-around, process lifetime.  A wrapped
        # ring silently truncates the timeline's past — this count is the
        # reader's "how much is missing" signal (exported as
        # dl4jtpu_trace_spans_dropped_total and stamped into the Chrome
        # trace metadata).
        self.spans_dropped = 0

    # -- control -----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def enable(self, capacity: Optional[int] = None) -> "TraceRecorder":
        if capacity is not None and capacity != self.capacity:
            self.capacity = int(capacity)
            self._spans = deque(self._spans, maxlen=self.capacity)
        self._enabled = True
        return self

    def disable(self) -> "TraceRecorder":
        self._enabled = False
        return self

    def clear(self) -> None:
        self._spans.clear()

    def __len__(self) -> int:
        return len(self._spans)

    # -- recording ---------------------------------------------------------
    def span(self, name: str, cat: str = "step", **args):
        """Context manager recording one complete ("X") span.  Returns a
        shared no-op when disabled — call sites don't branch."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args)

    def add_complete(self, name: str, t0: float, dur: float,
                     cat: str = "step", **args) -> None:
        """Record an already-measured span (t0/dur in perf_counter
        seconds) — for call sites that timed the work themselves (the
        fit loops' ETL-wait accounting)."""
        if not self._enabled:
            return
        # deque.append is GIL-atomic; no lock on the hot path.  A full
        # ring evicts its oldest span — count the loss (plain int +=,
        # bridged to the metrics counter by a pull collector so the hot
        # path never takes the registry lock).
        if len(self._spans) >= self.capacity:
            self.spans_dropped += 1
        self._spans.append((
            name, cat, t0, dur, threading.get_ident(), args or None,
        ))

    def traced(self, name: Optional[str] = None, cat: str = "func"):
        """Decorator form: `@tracer().traced()` wraps a function in a
        span named after it."""
        def deco(fn):
            span_name = name or fn.__qualname__

            @wraps(fn)
            def wrapper(*a, **kw):
                if not self._enabled:
                    return fn(*a, **kw)
                with self.span(span_name, cat=cat):
                    return fn(*a, **kw)

            return wrapper

        return deco

    # -- exposition --------------------------------------------------------
    def _event(self, span) -> dict:
        name, cat, t0, dur, tid, args = span
        ev = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": round(t0 * 1e6, 3),
            "dur": round(dur * 1e6, 3),
            "pid": self._pid,
            "tid": tid,
        }
        if args:
            ev["args"] = args
        return ev

    def _expand(self, span) -> list:
        """Chrome events for one span: the thread-track "X" slice, plus —
        for causally-linked spans (args carry a trace id) — an async
        ``b``/``e`` pair keyed by the trace id, so Perfetto shows the
        whole request on one lane even as it hops threads/replicas."""
        ev = self._event(span)
        out = [ev]
        args = span[5]
        if args and "trace" in args:
            rid = f"{args['trace']:x}"
            base = {"name": ev["name"], "cat": "request", "id": rid,
                    "pid": ev["pid"], "tid": ev["tid"]}
            out.append({**base, "ph": "b", "ts": ev["ts"]})
            out.append({**base, "ph": "e", "ts": ev["ts"] + ev["dur"]})
        return out

    def appended_total(self) -> int:
        """Spans ever appended (ring contents + wrap evictions) — the
        monotonic cursor base for incremental consumers (the fleet
        reporter ships only spans appended since its last push).
        APPEND order, not timestamp order: an umbrella span starts
        before but completes after its sub-spans, so a timestamp cursor
        would silently drop any span straddling a push."""
        return len(self._spans) + self.spans_dropped

    def events_since(self, cursor: int, limit: int) -> tuple:
        """(chrome events, new_cursor) for spans appended after
        append-order position `cursor`, newest `limit` of them.  ONE
        coherent read: deriving the total and the events from separate
        reads of a live ring would shift the window under a concurrent
        recorder — the oldest unacked spans would be skipped forever.
        The drop count is read BEFORE the ring snapshot, so a racing
        wrap at worst re-sends a span (the aggregator tolerates
        duplicates), never loses one."""
        dropped = self.spans_dropped
        spans = list(self._spans)
        total = dropped + len(spans)
        new_n = total - cursor
        if new_n <= 0:
            return [], max(cursor, total)
        # `limit` bounds EXPANDED events: a causally-linked span emits 3
        # (X + async b/e), so slicing spans by `limit` would let a push
        # carry 3x the events its transport cap was sized for.  Newest
        # spans win; the first span is always taken so a tiny limit
        # still makes progress.
        window = spans[-min(new_n, len(spans)):]
        selected: list = []
        used = 0
        for s in reversed(window):
            n_ev = 3 if (s[5] and "trace" in s[5]) else 1
            if selected and used + n_ev > limit:
                break
            selected.append(s)
            used += n_ev
            if used >= limit:
                break
        events = [
            ev for s in reversed(selected) for ev in self._expand(s)
        ]
        events.sort(key=lambda e: e["ts"])
        return events, total

    def tail_events(self, n: int) -> list:
        """Chrome events for the last `n` appended spans (ts-sorted
        among themselves)."""
        if n <= 0:
            return []
        events = [
            ev for s in list(self._spans)[-n:] for ev in self._expand(s)
        ]
        events.sort(key=lambda e: e["ts"])
        return events

    def _flow_events(self, spans: list) -> list:
        """Flow ``s``/``f`` arrow pairs binding each causally-linked
        child slice to its parent slice (both ends must be in `spans`;
        a parent evicted by ring wrap simply draws no arrow)."""
        by_id = {}
        for s in spans:
            args = s[5]
            if args and "span" in args:
                by_id[args["span"]] = s
        out = []
        for s in spans:
            args = s[5]
            parent_id = args.get("parent") if args else None
            p = by_id.get(parent_id) if parent_id is not None else None
            if p is None:
                continue
            # the "s" end must land INSIDE the parent slice: clamp the
            # child's start into the parent's interval
            ts = min(max(s[2], p[2]), p[2] + p[3]) * 1e6
            fid = f"{args['trace']:x}.{args['span']:x}"
            out.append({"name": "link", "cat": "request", "ph": "s",
                        "id": fid, "ts": round(ts, 3),
                        "pid": self._pid, "tid": p[4]})
            out.append({"name": "link", "cat": "request", "ph": "f",
                        "bp": "e", "id": fid,
                        "ts": round(s[2] * 1e6, 3),
                        "pid": self._pid, "tid": s[4]})
        return out

    def trace_chain(self, trace_id: int) -> list:
        """All recorded spans of one causal trace, t0-sorted: dicts with
        ``name``/``cat``/``t0``/``dur`` (perf_counter seconds)/``tid``/
        ``span``/``parent``/``args``.  The programmatic view behind the
        slow-request exemplars and the span-ledger tests."""
        out = []
        for s in list(self._spans):
            name, cat, t0, dur, tid, args = s
            if not args or args.get("trace") != trace_id:
                continue
            extra = {k: v for k, v in args.items()
                     if k not in ("trace", "span", "parent")}
            out.append({
                "name": name, "cat": cat, "t0": t0, "dur": dur,
                "tid": tid, "span": args.get("span"),
                "parent": args.get("parent"), "args": extra,
            })
        out.sort(key=lambda s: s["t0"])
        return out

    def trace_ids(self) -> set:
        """Distinct trace ids currently in the ring — enumerate chains
        (tests, bench sweeps) without poking at the raw span tuples."""
        return {s[5]["trace"] for s in list(self._spans)
                if s[5] and "trace" in s[5]}

    def to_chrome_trace(self, limit: Optional[int] = None,
                        name: Optional[str] = None) -> dict:
        """Chrome trace-event JSON object (the Perfetto-loadable schema:
        phase "X" complete events, microsecond timestamps; linked spans
        additionally emit async lanes and flow arrows).  ``limit`` keeps
        only the newest N spans, ``name`` substring-filters span names —
        the mid-incident escape hatches for a big ring
        (``GET /api/trace?limit=&name=``)."""
        spans = list(self._spans)
        total = len(spans)
        if name:
            spans = [s for s in spans if name in s[0]]
        if limit is not None and limit >= 0:
            # spans[-0:] is the WHOLE list — limit=0 must mean zero
            spans = spans[-limit:] if limit > 0 else []
        events = [ev for s in spans for ev in self._expand(s)]
        events.extend(self._flow_events(spans))
        events.sort(key=lambda e: e["ts"])
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            # a wrapped ring silently truncated the timeline's past;
            # readers (and the cluster merge) get the loss count here
            "metadata": {
                "spans_dropped": self.spans_dropped,
                "capacity": self.capacity,
                "pid": self._pid,
                "spans_total": total,
                "spans_selected": len(spans),
            },
        }

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path


# -- process-global recorder ------------------------------------------------

_TRACER: Optional[TraceRecorder] = None
_TRACER_LOCK = threading.Lock()


def tracer() -> TraceRecorder:
    """The process-global recorder (created disabled).  Its ring-wrap
    loss count is bridged to ``dl4jtpu_trace_spans_dropped_total`` by a
    pull collector installed here — the recording hot path stays
    lock-free."""
    global _TRACER
    with _TRACER_LOCK:
        if _TRACER is None:
            _TRACER = TraceRecorder()
            from deeplearning4j_tpu_torch.observe.metrics import registry

            reg = registry()
            dropped = reg.counter("dl4jtpu_trace_spans_dropped_total")

            def _collect(t=_TRACER, c=dropped):
                c.set_total(t.spans_dropped)

            reg.register_collector(_collect)
    return _TRACER


def merge_chrome_traces(traces: dict, pids: Optional[dict] = None) -> dict:
    """Merge per-worker Chrome traces into ONE cluster timeline:
    ``traces`` maps worker id -> a `to_chrome_trace()` document; every
    worker's events land under its own pid (``pids[worker]`` — normally
    the worker's rank — else a stable sorted index), with a
    ``process_name`` metadata event so Perfetto shows the worker id.
    Per-worker drop counts are summed into the merged metadata."""
    events: list = []
    dropped_total = 0
    per_worker: dict = {}
    # every worker gets its OWN pid: fallback pids stay disjoint from
    # the explicit ranks, and a DUPLICATE explicit rank (an elastic
    # respawn reusing a dead worker's rank inside the fleet TTL) is
    # honored only for the first worker carrying it — anything else
    # silently fuses two timelines under one Perfetto process
    desired = set(pids.values()) if pids else set()
    used: set = set()
    next_free = 0
    for worker in sorted(traces):
        doc = traces[worker] or {}
        pid = pids.get(worker) if pids else None
        if pid is None or pid in used:
            while next_free in desired or next_free in used:
                next_free += 1
            pid = next_free
        used.add(pid)
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": str(worker)},
        })
        for ev in doc.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            events.append(ev)
        meta = doc.get("metadata") or {}
        d = int(meta.get("spans_dropped", 0) or 0)
        dropped_total += d
        per_worker[str(worker)] = {"pid": pid, "spans_dropped": d}
    events.sort(key=lambda e: e.get("ts", 0))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {
            "workers": per_worker,
            "spans_dropped": dropped_total,
        },
    }


# -- fit-loop step instrumentation ------------------------------------------

_STEP_FAMILIES = None


def _step_families():
    """(histogram, counter) for the step engine, resolved once — the
    per-step path must not pay registry lookups/locks."""
    global _STEP_FAMILIES
    if _STEP_FAMILIES is None:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        reg = registry()
        _STEP_FAMILIES = (
            reg.histogram("dl4jtpu_step_latency_seconds"),
            reg.counter("dl4jtpu_train_steps_total"),
        )
    return _STEP_FAMILIES


class StepScope:
    """One training-step-program observation: a context manager the fit
    loops wrap each dispatched program in.

    - always: observes `dl4jtpu_step_latency_seconds` (host wall per
      program) and `dl4jtpu_train_steps_total` (+n_steps) — the scrape
      path's step-rate signal costs two perf_counter reads per program;
    - tracing enabled: `.phase(name)` sub-spans land in the ring buffer
      and `.sync(x)` blocks on the step's output so `device_sync` is a
      real measured span instead of async-dispatch noise.
    """

    __slots__ = ("_rec", "_hist", "_steps", "_n", "_iteration", "_t0",
                 "_dispatched", "_overlap", "_watchdog", "_model",
                 "_cost_rec")

    def __init__(self, iteration: int, n_steps: int = 1,
                 overlap_s: float = 0.0, watchdog=None, model=None):
        self._rec = tracer()
        self._hist, self._steps = _step_families()
        self._n = n_steps
        self._iteration = iteration
        self._dispatched = False
        self._overlap = overlap_s
        self._watchdog = watchdog
        # performance attribution: sync() snapshots the ProgramRecord the
        # dispatch wrapper routed through the model (observe/cost.py)
        self._model = model
        self._cost_rec = None

    def __enter__(self) -> "StepScope":
        self._t0 = time.perf_counter()
        if self._watchdog is not None:
            # hang detection: the deadline covers host_stage ->
            # dispatch -> device_sync -> listeners (everything between
            # scope enter and exit)
            self._watchdog.arm(self._iteration, self._n)
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        failed = bool(exc) and exc[0] is not None
        if self._watchdog is not None:
            # failed steps disarm but do not feed the EWMA — an aborted
            # dispatch's wall time says nothing about healthy latency
            self._watchdog.disarm(None if failed else dur)
        if not failed or self._dispatched:
            # count a step once its program reached the device (sync()
            # ran): a listener throwing AFTER the update (DivergenceError)
            # must not make /metrics disagree with model.iteration.  A
            # pre-sync failure (OOM mid-dispatch) is NOT an optimizer
            # step and stays out of the counter and the histogram.
            self._hist.observe(dur)
            self._steps.inc(self._n)
        args = {"iteration": self._iteration, "n_steps": self._n}
        if self._cost_rec is not None and (not failed or self._dispatched):
            # MFU / roofline attribution for the program this scope
            # dispatched (no-op until the record has been cost-analyzed;
            # a telemetry failure must never fail the step)
            try:
                from deeplearning4j_tpu_torch.observe import cost

                cost.note_step(self._cost_rec, dur, args, self._n)
            except Exception as e:
                log.debug("step cost attribution failed: %s", e)
        if self._overlap > 0:
            # the prefetch pipeline's win for this step: producer-thread
            # staging seconds that ran concurrently with compute
            args["overlap_seconds"] = round(self._overlap, 6)
        if failed:
            args["error"] = exc[0].__name__
        self._rec.add_complete("train_step", self._t0, dur, cat="step",
                               **args)
        return False

    def phase(self, name: str):
        return self._rec.span(name, cat="step_phase")

    def sync(self, x) -> None:
        """Block until the step's outputs are ready — ONLY while tracing
        (the untraced path must keep host/device dispatch overlap).
        Reaching sync() marks the program as dispatched: later failures
        (a throwing listener) no longer void the step metrics."""
        from deeplearning4j_tpu_torch.runtime import faults

        # fault site: the device_sync barrier — an armed 'delay' here is
        # the simulated wedged step the watchdog escalation is tested
        # against (disarmed: one global load + None check)
        faults.maybe_fail("device.sync")
        self._dispatched = True
        if self._model is not None:
            # the dispatch wrapper (observe/cost.py) set this during the
            # step call just above; snapshot it HERE
            self._cost_rec = getattr(self._model, "_cost_program", None)
        if self._rec.enabled and x is not None:
            import torch

            if isinstance(x, torch.Tensor) and x.is_cuda:
                torch.cuda.synchronize(x.device)


def step_scope(model, n_steps: int = 1) -> StepScope:
    """StepScope for a model's next dispatched program.  Drains the
    model's accumulated prefetch-overlap seconds (everything hidden
    since the previous scope) onto this step's span."""
    overlap = getattr(model, "_overlap_accum", 0.0)
    if overlap:
        model._overlap_accum = 0.0
    return StepScope(getattr(model, "iteration", 0), n_steps, overlap,
                     watchdog=getattr(model, "_watchdog", None), model=model)
