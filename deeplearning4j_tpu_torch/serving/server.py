"""InferenceServer — continuous batching over the port's `output()`,
built to degrade instead of die; the port's counterpart of
`deeplearning4j_tpu/serving/server.py`.

Concurrent requests coalesce into bucketed batches (`batching.py`),
dispatch through the model's own forward (`SequentialModel.output`
under ``torch.inference_mode()``, on the card the flash-forward kernel
for each attention layer), and params stay device-resident between
requests.  Engineering priority is the unhappy path:

- admission is BOUNDED (`admission.py`): queue full -> explicit 429,
  deadline unmeetable -> shed at the door, breaker open -> 503;
- every batch dispatch runs under a `StepWatchdog` (one shared monitor
  thread): a wedged device fails the batch's requests explicitly and
  trips the breaker instead of pinning the server;
- outputs are screened for NaN/Inf — a diverged weight push cannot
  silently serve garbage;
- weight hot-swap (`hotswap.py`) stages a device copy, verifies
  structure + checksum + finiteness and installs ATOMICALLY between
  batches (`SequentialModel.load_params` under the weights lock); a
  torn push rolls back with zero dropped in-flight requests;
- `warm_start()` runs every batch bucket once at boot (cuBLAS handles
  and the allocator's blocks come into being there; nothing compiles).

Every signal lands on the telemetry spine (`observe/metrics`): latency
histogram, queue depth, batch occupancy, shed / breaker / hot-swap
counters, and the per-request breakdown (queue_wait, batch_form,
dispatch, pad_overhead).  With tracing enabled each request emits a
causally-linked span chain: ``serving.request`` (root) ->
``serving.admit`` -> ``serving.queue_wait`` -> ``serving.batch_form`` ->
``serving.dispatch``.  The slowest completed requests are kept in a
bounded exemplar ring (`slow_requests()`).

An int8-quantized model (`quant.quantize`) serves through kernel B5
(`ops/dequant_matmul.py`) and swaps quantized trees.  Not ported yet: a
model with a mesh (A11), a `GraphModel` (A13).  Time padding: a
padded batch's mask column (each request's own mask, or ones over its
real steps) goes to ``output(..., features_mask=)``, as the JAX server
passes it to its masked infer program, so padding and a mask's holes
reach no real row.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import weakref
from collections import deque
from typing import Optional

import numpy as np

import torch

from deeplearning4j_tpu_torch.observe import trace as otrace
from deeplearning4j_tpu_torch.quant.qtensor import QuantizedTensor
from deeplearning4j_tpu_torch.runtime import faults
from deeplearning4j_tpu_torch.serving import batching
from deeplearning4j_tpu_torch.serving.admission import (
    AdmissionQueue, PendingRequest, ServingError, ServingRejected,
)
from deeplearning4j_tpu_torch.serving.breaker import CircuitBreaker
from deeplearning4j_tpu_torch.serving.hotswap import (
    SwapVerifyError, apply_fault_action, verify_weights,
)

log = logging.getLogger("deeplearning4j_tpu_torch")

#: slowest-request exemplars kept per server (bounded: the ring must
#: stay readable mid-incident, not become a second unbounded queue)
SLOW_RING_CAP = 16

_BREAKDOWN_FAMILIES = None


def _breakdown_families():
    """(queue_wait, batch_form, dispatch, pad_overhead histograms,
    batch-examples counter), resolved once — per-request attribution
    must not pay registry lookups/locks."""
    global _BREAKDOWN_FAMILIES
    if _BREAKDOWN_FAMILIES is None:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        reg = registry()
        _BREAKDOWN_FAMILIES = (
            reg.histogram("dl4jtpu_serving_queue_wait_seconds"),
            reg.histogram("dl4jtpu_serving_batch_form_seconds"),
            reg.histogram("dl4jtpu_serving_dispatch_seconds"),
            reg.histogram("dl4jtpu_serving_pad_overhead_seconds"),
            reg.counter("dl4jtpu_serving_batch_examples_total"),
        )
    return _BREAKDOWN_FAMILIES


#: the per-request latency segments, in chain order (the breakdown dict
#: keys, the histogram families and the docs all share this vocabulary)
BREAKDOWN_SEGMENTS = ("queue_wait", "batch_form", "dispatch",
                      "pad_overhead")


@dataclasses.dataclass
class ServingConfig:
    """Knobs of the serving plane (the JAX package's fields and
    defaults)."""

    max_batch: int = 8             # coalescing cap; also the top bucket
    max_queue: int = 256           # admission bound (backpressure past it)
    linger_s: float = 0.002        # wait for stragglers once a batch opens
    default_deadline_s: float = 1.0
    admit_safety: float = 1.5      # shed-estimate multiplier (conservative)
    breaker_threshold: int = 3     # consecutive dispatch failures to trip
    breaker_probe_after_s: float = 0.5
    dispatch_timeout_s: float = 10.0   # per-batch watchdog floor (warm)
    cold_dispatch_timeout_s: float = 600.0  # first dispatch: first-use costs
    bucket_sequences: bool = False  # time-axis bucketing (sequence models)
    sequence_quantum: Optional[int] = None  # None = flags.sequence_bucket_size


class InferenceServer:
    """Continuous-batching server over one port `SequentialModel`.

        server = InferenceServer(model, config=ServingConfig(max_batch=16))
        server.warm_start(example)          # run every batch bucket once
        server.start()
        out = server.submit(features).result()
        server.push_weights(new_params, checksum=crc)   # verified hot-swap
        server.stop()
    """

    def __init__(self, model, config: Optional[ServingConfig] = None):
        if model.params is None:
            model.init()
        self.model = model
        self.config = config or ServingConfig()
        self.n_inputs = len(getattr(
            getattr(model, "conf", None), "network_inputs", (),
        )) or 1
        self.n_outputs = len(getattr(
            getattr(model, "conf", None), "network_outputs", (),
        )) or 1
        # an int8-quantized model (quant/ptq.py), advertised on the
        # status surfaces; dispatch, hot-swap and warm start take its
        # tree as they take an f32 one (a QuantizedTensor flattens to
        # its int8 and f32 leaves)
        self.quantized = bool(getattr(model, "_quantized", None))
        self.queue = AdmissionQueue(self.config.max_queue)
        self.breaker = CircuitBreaker(
            threshold=self.config.breaker_threshold,
            probe_after_s=self.config.breaker_probe_after_s,
        )
        # hot-swap atomicity: dispatch SNAPSHOTS the compute params
        # under this lock and runs the forward against the snapshot;
        # an install takes the same lock to assign.  Swaps land exactly
        # between snapshot reads, in-flight requests always complete on
        # the weights they dispatched with, and a wedged device call
        # can never pin the lock (pushes stay possible while the
        # watchdog deals with the wedge)
        self._weights_lock = threading.Lock()
        self.generation = 0            # bumps on every installed swap
        # batch-latency EWMA drives the admission shed estimate and the
        # stats view; the watchdog keeps its own for deadlines
        self._stats_lock = threading.Lock()
        self._batch_ewma: Optional[float] = None
        self._latencies: deque = deque(maxlen=4096)   # recent request secs
        # request-level attribution: running segment totals (stats()'s
        # breakdown view) + the bounded slowest-request exemplar ring
        self._lat_totals: dict[str, float] = {
            k: 0.0 for k in BREAKDOWN_SEGMENTS
        }
        self._slow: list[dict] = []        # latency-desc, <= SLOW_RING_CAP
        self._rec = otrace.tracer()        # cached: no lock per request
        self._counts: dict[str, int] = {
            "admitted": 0, "completed": 0, "errors": 0, "timeouts": 0,
            "shed": 0, "batches": 0, "wedged_batches": 0,
            "swaps_installed": 0, "swaps_rolled_back": 0,
        }
        self._last_occupancy = 0.0
        # per-batch watchdog: floor = the configured dispatch timeout,
        # cold floor = the first dispatch's allowance (cuBLAS handles, the
        # kernels' build at first use); abort fails the in-flight
        # batch and trips the breaker (the wedged call's eventual return
        # value is discarded by token)
        from deeplearning4j_tpu_torch.runtime.watchdog import StepWatchdog

        self._watchdog = StepWatchdog(
            floor_s=self.config.dispatch_timeout_s,
            cold_floor_s=max(self.config.cold_dispatch_timeout_s,
                             self.config.dispatch_timeout_s),
            k=1.0,                      # deadline IS the configured timeout
            abort=self._on_wedged,
            name="serving",
        )
        self._inflight_lock = threading.Lock()
        self._inflight: Optional[dict] = None      # {"token", "reqs"}
        self._dispatch_token = 0
        # batcher generation: bumped ATOMICALLY with the inflight pop in
        # _on_wedged, so an abandoned (wedge-respawned) thread whose
        # claim failed always observes the bump at its next loop check
        # and exits — two batchers can never take from the queue
        # concurrently
        self._batcher_gen = 0
        # the watchdog is SHARED across batcher generations: after a
        # wedge-respawn, the abandoned thread eventually wakes inside
        # its old dispatch and must NOT disarm the deadline the
        # replacement batcher armed for ITS dispatch — disarm is gated
        # on still owning the arm
        self._wd_lock = threading.Lock()
        self._wd_owner: Optional[int] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.warmed_signatures: list[tuple] = []
        # a serving.generation.GenerationEngine attaches itself here;
        # /v1/generate and the shed_pressure KV term read through it
        self.generation_engine = None
        _register_server(self)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "InferenceServer":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            with self._inflight_lock:
                gen = self._batcher_gen
            self._thread = threading.Thread(
                target=self._batcher_loop, args=(gen,),
                name="dl4jtpu-serving", daemon=True,
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the batcher and fail every still-queued request with an
        explicit `shutdown` rejection (never a silent drop)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        for req in self.queue.drain():
            self._shed(req, "shutdown")

    # -- admission ---------------------------------------------------------
    def submit(self, features, deadline_s: Optional[float] = None,
               features_mask=None, trace_ctx=None) -> PendingRequest:
        """Admit ONE example (no batch dim; a tuple of arrays for
        multi-input graphs).  Returns a `PendingRequest` whose
        ``result()`` blocks until completion or the deadline.  Raises
        `ServingRejected` synchronously when the request cannot be
        admitted — queue full, breaker open, or the deadline is already
        unmeetable at the current queue depth.

        ``trace_ctx``: optional ``(trace_id, parent_span_id)`` from an
        upstream hop (the router's try span) — the request's span chain
        joins that trace instead of starting a fresh one."""
        t0_pc = time.perf_counter()
        try:
            action = faults.maybe_fail("serving.admit")
        except Exception as exc:
            # an admission path that raises (injected or real) is a
            # failing FRONT DOOR, not a failing request: convert it to
            # an explicit rejection the client can retry against
            self._count_shed("admit_fault")
            raise ServingRejected("admit_fault", str(exc)) from exc
        if action is not None:
            # cooperative kinds at admit mean the same thing — reject
            # explicitly, count the shed
            self._count_shed("admit_fault")
            raise ServingRejected("admit_fault", f"injected {action}")
        if not self.breaker.admits():
            self._count_shed("breaker_open")
            raise ServingRejected(
                "breaker_open",
                f"circuit breaker is {self.breaker.state}",
            )
        try:
            req = self._admit(features, deadline_s, features_mask,
                              t0_pc=t0_pc, trace_ctx=trace_ctx)
        except BaseException:
            # admits() may have consumed the HALF_OPEN probe slot; a
            # rejection on the way to the queue (deadline shed, queue
            # full, bad arity) means that probe will never dispatch —
            # release it or the breaker waits forever on a dead probe
            self.breaker.probe_reset()
            raise
        self._trace_admitted(req, t0_pc)
        return req

    def _trace_admitted(self, req: PendingRequest, t0_pc: float) -> None:
        """Record the ``serving.admit`` span (submit entry -> enqueued).
        The ids were allocated in `_admit` BEFORE the offer — a batcher
        taking the request immediately must already see them.  The root
        span itself is recorded at completion, when its duration is
        known."""
        if req.trace_id is None or not self._rec.enabled:
            return
        self._rec.add_complete(
            "serving.admit", t0_pc, req.t_enq_pc - t0_pc, cat="request",
            **otrace.trace_args(req.trace_id, otrace.next_id(),
                                req.root_span),
        )

    def _admit(self, features, deadline_s, features_mask,
               t0_pc=None, trace_ctx=None) -> PendingRequest:
        feats = self._as_feature_tuple(features)
        deadline_s = (self.config.default_deadline_s
                      if deadline_s is None else float(deadline_s))
        fmask = (None if features_mask is None
                 else self._checked_mask(features_mask, feats[0]))
        orig_len = padded_len = None
        if self._sequence_mode(feats):
            orig_len = int(feats[0].shape[0])
            padded, seq_mask = batching.pad_sequence(
                feats[0], self.config.sequence_quantum
            )
            padded_len = int(padded.shape[0])
            feats = (padded,)
            if fmask is None:
                fmask = seq_mask
            else:
                m = np.zeros_like(seq_mask)
                m[: len(fmask)] = fmask
                fmask = m
        sig = batching.bucket_signature(
            feats, self.config.sequence_quantum,
            self._sequence_mode(feats),
        )
        # deadline-aware shedding AT ADMIT: with `depth` requests ahead,
        # this one completes after ~floor(depth / max_batch) + 1
        # dispatches (the +1 is its own batch); if that (times a safety
        # factor) already exceeds its deadline, it would only burn a
        # batch slot to time out in — reject now.  NEVER at depth 0: an
        # empty queue means this request dispatches in the very next
        # batch, and dispatching it is the ONLY way the latency EWMA can
        # refresh — a compile-tainted cold sample would otherwise shed
        # every future request at admit, freeze the estimate, and take
        # the replica out of the fleet forever (the cold-replica
        # deadlock; regression-tested in test_serving_trace.py)
        depth = self.queue.depth
        est = self._estimated_wait(depth)
        if depth > 0 and est is not None and est > deadline_s:
            self._count_shed("deadline")
            raise ServingRejected(
                "deadline",
                f"estimated wait {est:.3f}s exceeds deadline "
                f"{deadline_s:.3f}s at queue depth {depth}",
            )
        req = PendingRequest(
            feats, sig, time.monotonic() + deadline_s, fmask=fmask,
            orig_len=orig_len, padded_len=padded_len,
        )
        if t0_pc is not None:
            req.t0_pc = t0_pc
        # causal ids BEFORE the offer: a batcher can take the request
        # the instant it lands in the queue, and its queue_wait/dispatch
        # segments must already see the chain ids — allocating after the
        # offer dropped segments (or forged a second root) under a fast
        # batcher
        if self._rec.enabled:
            if trace_ctx is not None:
                req.trace_id, req.root_parent = trace_ctx
            else:
                req.trace_id = otrace.next_id()
            req.root_span = otrace.next_id()
        if not self.queue.offer(req):
            self._count_shed("queue_full")
            raise ServingRejected(
                "queue_full", f"admission queue at {self.queue.max_queue}"
            )
        req.t_enq_pc = time.perf_counter()
        with self._stats_lock:
            self._counts["admitted"] += 1
        self._gauge_depth()
        return req

    def infer(self, features, deadline_s: Optional[float] = None,
              features_mask=None):
        """Blocking convenience: ``submit(...).result()``."""
        return self.submit(
            features, deadline_s=deadline_s, features_mask=features_mask,
        ).result()

    def _as_feature_tuple(self, features) -> tuple:
        if isinstance(features, (tuple, list)):
            feats = tuple(np.asarray(f) for f in features)
        else:
            feats = (np.asarray(features),)
        if len(feats) != self.n_inputs:
            raise ValueError(
                f"model has {self.n_inputs} input(s), request carries "
                f"{len(feats)}"
            )
        return feats

    @staticmethod
    def _checked_mask(features_mask, x: np.ndarray) -> np.ndarray:
        """A request's features mask as f32 per-step flags, or ValueError
        before it is queued: it must be 1-D, finite and as long as the
        request's own time axis.  A bad mask that reached the batch would
        fail every request dispatched with it and count against the
        breaker."""
        m = np.asarray(features_mask, np.float32)
        steps = x.shape[0] if x.ndim else None
        if m.ndim != 1 or m.shape[0] != steps or not np.isfinite(m).all():
            raise ValueError(f"features_mask must be {steps} finite per-step "
                             f"flags, one for each step of the features; got "
                             f"shape {m.shape}")
        return m

    def _sequence_mode(self, feats: tuple) -> bool:
        return (self.config.bucket_sequences and self.n_inputs == 1
                and feats[0].ndim >= 2)

    def _estimated_wait(self, depth: int) -> Optional[float]:
        with self._stats_lock:
            ewma = self._batch_ewma
        if ewma is None or ewma <= 0.0:
            # no sample yet — OR a coarse clock measured a 0.0s batch
            # (possible on Windows-resolution monotonic clocks): both
            # mean "no usable latency signal", so admit optimistically
            # instead of advertising a certain zero wait
            return None
        dispatches = depth // self.config.max_batch + 1
        return self.config.admit_safety * ewma * dispatches

    # -- the batcher thread ------------------------------------------------
    def _batcher_loop(self, my_gen: int) -> None:
        while not self._stop.is_set():
            with self._inflight_lock:
                alive = self._batcher_gen == my_gen
            if not alive:
                # replaced after a wedged dispatch (_on_wedged bumped
                # the generation atomically with discarding our batch);
                # bow out before touching the queue
                return
            reqs = self.queue.take_batch(
                self.config.max_batch, self.config.linger_s, self._stop,
            )
            t_taken_pc = time.perf_counter()
            self._gauge_depth()
            if not reqs:
                continue
            live = []
            now = time.monotonic()
            for r in reqs:
                # queue_wait closes for every taken request — linger
                # included — whatever its fate next
                r.lat["queue_wait"] = t_taken_pc - r.t_enq_pc
                self._trace_segment(r, "serving.queue_wait", r.t_enq_pc,
                                    t_taken_pc - r.t_enq_pc)
                if r.cancelled:
                    # the client already timed out waiting; counting it
                    # keeps "admitted == completed+errors+timeouts+shed"
                    with self._stats_lock:
                        self._counts["timeouts"] += 1
                    self._count_outcome("timeout")
                    self._trace_finish(r, "timeout")
                elif r.deadline <= now:
                    # backstop shed: admitted when it looked meetable,
                    # doomed by the time a slot opened — reject
                    # explicitly instead of dispatching a corpse
                    self._shed(r, "deadline")
                else:
                    live.append(r)
            if not live:
                # a fully-shed take must not wedge a half-open breaker
                # waiting on a probe that will never dispatch
                self.breaker.probe_reset()
                continue
            self._dispatch(live, t_taken_pc)

    def _dispatch(self, reqs: list[PendingRequest],
                  t_taken_pc: Optional[float] = None) -> None:
        bucket = batching.batch_bucket(len(reqs), self.config.max_batch)
        for r in reqs:
            r.bucket = bucket
        t_form_pc = time.perf_counter()
        if t_taken_pc is not None:
            for r in reqs:
                r.lat["batch_form"] = t_form_pc - t_taken_pc
                self._trace_segment(r, "serving.batch_form", t_taken_pc,
                                    t_form_pc - t_taken_pc,
                                    batch=len(reqs), bucket=bucket)
        with self._inflight_lock:
            self._dispatch_token += 1
            token = self._dispatch_token
            self._inflight = {"token": token, "reqs": reqs,
                              "t0_pc": t_form_pc, "bucket": bucket}
        t0 = time.monotonic()
        try:
            outs = self._run_program(reqs, bucket, token)
        except Exception as exc:
            self._finish_failed(token, reqs, exc)
            return
        self._finish_ok(token, reqs, outs, bucket, time.monotonic() - t0)

    def _run_program(self, reqs: list[PendingRequest], bucket: int,
                     token: int):
        """Stack -> (maybe injected fault) -> jitted program -> rows.
        Raises on dispatch failure OR non-finite outputs; the watchdog
        is armed across the device call under `token` — the one
        _dispatch allocated, NOT a re-read of the counter (a concurrent
        warm_start() also draws from it, and a desynced owner would
        leave one of the two device calls deadline-less).  The dispatch
        latency segment is recorded here iff this call still OWNED the
        watchdog at disarm — a wedge-abandoned thread's eventual return
        must not double-record a batch the monitor thread already
        accounted."""
        t_d_pc = time.perf_counter()
        err_name = None
        try:
            return self._run_program_inner(reqs, bucket, token)
        except BaseException as exc:
            err_name = type(exc).__name__
            raise
        finally:
            if self._claim_trace(token):
                self._note_dispatch(
                    reqs, t_d_pc, time.perf_counter() - t_d_pc, bucket,
                    err_name,
                )

    def _claim_trace(self, token: int) -> bool:
        """Consume the ONE dispatch-segment record for `token`'s batch.
        True while the batch is still the live inflight one AND nobody
        recorded it yet — the flag is consumed under the lock, so a
        dispatch returning at the same instant the watchdog aborts can
        never double-record the segment (the monitor side checks the
        same flag on the inflight dict it pops)."""
        with self._inflight_lock:
            if (self._inflight is None
                    or self._inflight["token"] != token
                    or self._inflight.get("trace_done")):
                return False
            self._inflight["trace_done"] = True
            return True

    def _run_program_inner(self, reqs: list[PendingRequest], bucket: int,
                           token: int):
        cols = batching.stack_batch(
            [r.features for r in reqs], self.n_inputs, bucket,
        )
        fmask_col = None
        if any(r.fmask is not None for r in reqs):
            # unmasked requests in a masked batch get all-ones masks,
            # shaped like the first request that HAS one (the first
            # request overall may be the unmasked one)
            ref = next(r.fmask for r in reqs if r.fmask is not None)
            masks = [
                r.fmask if r.fmask is not None
                else np.ones(ref.shape, np.float32)
                for r in reqs
            ]
            fmask_col = np.stack(masks)
            if bucket > len(reqs):
                pad = np.zeros(
                    (bucket - len(reqs),) + fmask_col.shape[1:], np.float32,
                )
                fmask_col = np.concatenate([fmask_col, pad])
        # snapshot the weights UNDER the lock, dispatch OUTSIDE it: a
        # truly wedged device call must not pin the lock (push_weights
        # would deadlock and a replacement batcher could never dispatch)
        with self._weights_lock:
            params, net_state = self.model.compute_params(), None
        self._wd_arm(token)
        t0 = time.monotonic()
        try:
            action = faults.maybe_fail("serving.infer")
            out = self._call_model(cols, fmask_col, params, net_state)
            rows = [o.cpu().numpy() for o in out]
            if action == "corrupt":
                # injected divergence: the device answered NaN — the
                # finiteness screen below must catch it
                rows = [np.full_like(r, np.nan) for r in rows]
        finally:
            self._wd_disarm(token, time.monotonic() - t0)
        n = len(reqs)
        for r in rows:
            if not np.isfinite(r[:n]).all():
                raise ServingError(
                    "non-finite values in inference output "
                    "(diverged weights or corrupted dispatch)"
                )
        return rows

    def _wd_arm(self, token: int) -> None:
        with self._wd_lock:
            self._wd_owner = token
            self._watchdog.arm(token)

    def _wd_disarm(self, token: int, dur: Optional[float]) -> None:
        """Disarm only if this dispatch still owns the watchdog.  An
        abandoned (wedge-respawned) thread waking after the replacement
        batcher armed for a NEWER dispatch must leave that deadline in
        place — clobbering it let a follow-on hang run unwatched.
        disarm() itself drops the duration when the ladder escalated on
        the arm (a stall must not inflate the EWMA)."""
        with self._wd_lock:
            if self._wd_owner == token:
                self._wd_owner = None
                self._watchdog.disarm(dur)

    def _call_model(self, cols: list, fmask_col, params,
                    net_state) -> tuple:
        """One batched forward through the model's own `output()`
        against an explicit compute-params SNAPSHOT — the model's live
        trees are only touched under the weights lock, never from
        inside the (possibly long) device call."""
        model = self.model
        if getattr(model, "_mesh", None) is not None:
            raise NotImplementedError(
                "serving a model with a device mesh is not ported yet "
                "(ROADMAP A11)")
        with torch.inference_mode():
            return (model.output(cols[0], fmask_col, params=params),)

    def _finish_ok(self, token: int, reqs: list[PendingRequest],
                   rows: list[np.ndarray], bucket: int,
                   dur: float) -> None:
        if not self._claim_inflight(token):
            return          # the watchdog already failed this batch
        self.breaker.record_success()
        now = time.monotonic()
        with self._stats_lock:
            a = 0.3
            self._batch_ewma = dur if self._batch_ewma is None else (
                (1 - a) * self._batch_ewma + a * dur
            )
            self._counts["batches"] += 1
            self._counts["completed"] += len(reqs)
            self._last_occupancy = len(reqs) / bucket
            for r in reqs:
                self._latencies.append(now - r.t_admit)
                for k in BREAKDOWN_SEGMENTS:
                    self._lat_totals[k] += r.lat.get(k, 0.0)
        for i, r in enumerate(reqs):
            result = tuple(
                self._slice_sequence(rows[j][i], r)
                for j in range(len(rows))
            )
            r.complete(result if len(result) > 1 else result[0])
            lat = now - r.t_admit
            self._observe_latency(lat)
            self._observe_breakdown(r)
            self._count_outcome("ok")
            self._trace_finish(r, "ok")
            self._note_slow(r, "ok", lat)
        self._gauge_batch(len(reqs), bucket)

    @staticmethod
    def _slice_sequence(row: np.ndarray, req: PendingRequest) -> np.ndarray:
        """Undo the time-axis padding on time-distributed outputs: a
        bucketed (T_pad, C) row is sliced back to the request's real
        length.  Rank-1 rows (e.g. LastTimeStep heads) and rows whose
        leading dim is not the padded length pass through untouched."""
        if (req.orig_len is not None and req.orig_len != req.padded_len
                and row.ndim >= 2 and row.shape[0] == req.padded_len):
            return row[: req.orig_len]
        return row

    def _finish_failed(self, token: int, reqs: list[PendingRequest],
                       exc: Exception) -> None:
        if not self._claim_inflight(token):
            return
        self.breaker.record_failure()
        log.warning("serving dispatch failed (%d request(s)): %s",
                    len(reqs), exc)
        err = exc if isinstance(exc, ServingError) else ServingError(
            f"dispatch failed: {type(exc).__name__}: {exc}"
        )
        with self._stats_lock:
            self._counts["errors"] += len(reqs)
        now = time.monotonic()
        for r in reqs:
            r.fail(err)
            self._count_outcome("error")
            self._trace_finish(r, "error", error=type(exc).__name__)
            self._note_slow(r, "error", now - r.t_admit)

    def _claim_inflight(self, token: int) -> bool:
        with self._inflight_lock:
            if self._inflight is None or self._inflight["token"] != token:
                return False
            self._inflight = None
            return True

    # -- request-level attribution (trace spans + breakdown) ---------------
    def _trace_segment(self, req: PendingRequest, name: str, t0_pc: float,
                       dur: float, **args) -> None:
        """One linked latency segment of `req`'s chain (no-op unless
        tracing is on AND the request was admitted while it was on)."""
        if req.trace_id is None or not self._rec.enabled:
            return
        self._rec.add_complete(
            name, t0_pc, dur, cat="request",
            **otrace.trace_args(req.trace_id, otrace.next_id(),
                                req.root_span),
            **args,
        )

    def _note_dispatch(self, reqs: list[PendingRequest], t0_pc: float,
                       dur: float, bucket: int,
                       err_name: Optional[str]) -> None:
        """Close the dispatch segment for every request of one batch:
        the shared wall (stack + weights snapshot + device call +
        finiteness screen) plus each request's pad-overhead share —
        dispatch x (bucket - real) / bucket, the compute the padding
        rows burned on its behalf."""
        pad_frac = (bucket - len(reqs)) / bucket if bucket else 0.0
        extra = {"bucket": bucket, "batch": len(reqs)}
        if err_name is not None:
            extra["error"] = err_name
        for r in reqs:
            r.lat["dispatch"] = dur
            r.lat["pad_overhead"] = dur * pad_frac
            self._trace_segment(r, "serving.dispatch", t0_pc, dur, **extra)

    def _trace_finish(self, req: PendingRequest, outcome: str,
                      **args) -> None:
        """Record the request's ROOT span (admit -> now) — the chain's
        umbrella every segment parents under.  Called exactly once per
        admitted request, on whichever thread settles its fate."""
        if req.trace_id is None or not self._rec.enabled:
            return
        self._rec.add_complete(
            "serving.request", req.t0_pc,
            time.perf_counter() - req.t0_pc, cat="request",
            **otrace.trace_args(req.trace_id, req.root_span,
                                req.root_parent),
            outcome=outcome, **args,
        )

    def _note_slow(self, req: PendingRequest, outcome: str,
                   latency_s: float) -> None:
        """Offer one finished request to the slowest-request exemplar
        ring (bounded, latency-descending).  Caller holds nothing; the
        ring is under the stats lock."""
        entry = {
            "trace": (f"{req.trace_id:x}" if req.trace_id is not None
                      else None),
            "trace_id": req.trace_id,
            "outcome": outcome,
            "latency_s": round(latency_s, 6),
            "t_wall": time.time(),
            "breakdown_s": {k: round(v, 6) for k, v in req.lat.items()},
        }
        with self._stats_lock:
            slow = self._slow
            if len(slow) >= SLOW_RING_CAP and \
                    latency_s <= slow[-1]["latency_s"]:
                return
            slow.append(entry)
            slow.sort(key=lambda e: -e["latency_s"])
            del slow[SLOW_RING_CAP:]

    def slow_requests(self, spans: bool = True) -> list[dict]:
        """The slowest-request exemplars (latency-descending), each with
        its breakdown and — when tracing is on and the spans are still
        in the ring — its full causal span chain.  Served at
        ``GET /api/serving/slow``."""
        with self._stats_lock:
            out = [dict(e) for e in self._slow]
        if spans and self._rec.enabled:
            for e in out:
                if e["trace_id"] is not None:
                    e["spans"] = self._rec.trace_chain(e["trace_id"])
        for e in out:
            e.pop("trace_id", None)
        return out

    def _on_wedged(self, event: dict) -> None:
        """Watchdog abort stage (monitor thread): the dispatch blew
        `dispatch_timeout_s` x abort_after.  Fail the batch's requests
        explicitly, trip the breaker, and leave a token behind so the
        wedged call's eventual return is discarded."""
        with self._inflight_lock:
            inflight, self._inflight = self._inflight, None
            if inflight is not None:
                # atomic with the pop: the abandoned batcher's claim
                # fails under this same lock, so its next loop check
                # MUST see the new generation and exit — never two
                # batchers on the queue at once
                self._batcher_gen += 1
        if inflight is None:
            return
        log.error("serving dispatch wedged (%.3fs past deadline); "
                  "failing %d request(s)",
                  event["stalled_s"] - event["deadline_s"],
                  len(inflight["reqs"]))
        self.breaker.record_failure()
        err = ServingError(
            f"dispatch wedged past {event['deadline_s']:.3f}s deadline"
        )
        with self._stats_lock:
            self._counts["wedged_batches"] += 1
            self._counts["errors"] += len(inflight["reqs"])
        # the wedged thread never reached its dispatch-segment record
        # (and will be denied it by the inflight pop above): close each
        # request's chain HERE on the monitor thread — an aborted
        # request still yields one complete, causally-linked trace.
        # Unless the dispatch thread won the race and already consumed
        # the record (trace_done) — the segment is recorded exactly once
        if not inflight.get("trace_done"):
            t0_pc = inflight.get("t0_pc", time.perf_counter())
            dur_pc = time.perf_counter() - t0_pc
            self._note_dispatch(
                inflight["reqs"], t0_pc, dur_pc,
                inflight.get("bucket", len(inflight["reqs"])), "Wedged",
            )
        now = time.monotonic()
        for r in inflight["reqs"]:
            r.fail(err)
            self._count_outcome("error")
            self._trace_finish(r, "error", error="wedged")
            self._note_slow(r, "wedged", now - r.t_admit)
        # the wedged call may NEVER return: abandon its (daemon) thread
        # and hand the queue to a fresh batcher, or the server would be
        # pinned — no dispatches, no breaker probe, no recovery
        self._respawn_batcher()

    def _respawn_batcher(self) -> None:
        if self._stop.is_set():
            return
        with self._inflight_lock:
            gen = self._batcher_gen
        t = threading.Thread(
            target=self._batcher_loop, args=(gen,),
            name="dl4jtpu-serving", daemon=True,
        )
        # start BEFORE publishing: a stop() racing the respawn must
        # never join() a thread that was assigned but not yet started
        t.start()
        self._thread = t

    # -- weight hot-swap ---------------------------------------------------
    def push_weights(self, params, net_state=None,
                     checksum: Optional[int] = None,
                     source: str = "api") -> bool:
        """Verified atomic weight swap: stage a device copy -> verify
        (structure, shape, optional CRC, finiteness) -> install between
        batches and between decode steps.  Returns True on install;
        False = rolled back (the server keeps serving its current params
        untouched).  The port's models carry no net state: a non-empty
        ``net_state`` is rejected as a structure mismatch."""
        try:
            action = faults.maybe_fail("serving.hotswap")
        except Exception as exc:
            return self._swap_rejected(source, "fault", str(exc))
        staged = self._stage(params)
        if action is not None:
            staged = apply_fault_action(action, staged)
        try:
            verify_weights(staged, self.model.params, checksum=checksum)
            if net_state:
                raise SwapVerifyError(
                    "structure", "the port's models carry no net state")
        except SwapVerifyError as exc:
            return self._swap_rejected(source, exc.reason, str(exc))
        with self._weights_lock:
            # between batches by construction: dispatch snapshots the
            # compute params under this lock before every forward, and
            # an attached generation engine before every decode step
            self.model.load_params(staged)
            self.generation += 1
            gen = self.generation
        with self._stats_lock:
            self._counts["swaps_installed"] += 1
        log.info("serving weights swapped (generation %d, source=%s)",
                 gen, source)
        self._count_swap("installed")
        self._gauge_generation(gen)
        return True

    def _stage(self, tree):
        """A private f32 copy of a pushed tree on the model's device
        (the installed weights never alias the caller's tensors); a
        `QuantizedTensor` is copied as its int8 ``q`` and f32 ``scale``;
        any other nesting passes through for `verify_weights` to
        reject."""
        if isinstance(tree, dict):
            return {k: self._stage(v) for k, v in tree.items()}
        if isinstance(tree, QuantizedTensor):
            return QuantizedTensor(self._stage(tree.q), self._stage(tree.scale))
        if isinstance(tree, (list, tuple)):
            return tree
        t = (tree.detach() if isinstance(tree, torch.Tensor)
             else torch.from_numpy(np.array(tree)))
        if t.is_floating_point():
            t = t.float()
        return t.to(self.model.device, copy=True)

    def push_checkpoint(self, path: str, source: Optional[str] = None,
                        include_net_state: bool = True) -> bool:
        """Hot-swap from a checkpoint zip (written by either package):
        the manifest CRC check (`ModelSerializer.verify`) rejects
        torn/corrupt files BEFORE the params are staged, then the tree
        goes through the same verified install as `push_weights`."""
        from deeplearning4j_tpu_torch.train.checkpoint import (
            CheckpointVerifyError, ModelSerializer,
        )

        source = source or f"checkpoint:{path}"
        try:
            restored = ModelSerializer.restore(path, verify=True,
                                               device=self.model.device)
        except CheckpointVerifyError as exc:
            return self._swap_rejected(source, "checkpoint", str(exc))
        except Exception as exc:
            # unreadable file, class mismatch, leaf-count drift — same
            # contract: the live params keep serving
            return self._swap_rejected(source, "restore", str(exc))
        return self.push_weights(restored.params, source=source)

    def _swap_rejected(self, source: str, reason: str,
                       detail: str) -> bool:
        log.warning(
            "hot-swap from %s ROLLED BACK (%s): %s — serving params "
            "generation %d unchanged", source, reason, detail,
            self.generation,
        )
        with self._stats_lock:
            self._counts["swaps_rolled_back"] += 1
        self._count_swap("rolled_back")
        return False

    # -- warm start --------------------------------------------------------
    def warm_start(self, example=None, lengths=None) -> list[tuple]:
        """Run a zero batch through every (batch bucket [x time bucket])
        signature once at boot, so the first real request does not pay
        first-use costs (cuBLAS handles and workspaces, the allocator's
        blocks, the kernels' build).  Nothing compiles: the port's
        forward is eager.  `example` is one request's features (no batch
        dim); `lengths` optionally lists sequence lengths to cover when
        `bucket_sequences` is on.  Returns the warmed signatures."""
        feats = self._as_feature_tuple(example)
        variants = [feats]
        if self._sequence_mode(feats) and lengths:
            variants = []
            for t in lengths:
                a = feats[0]
                v = np.zeros((int(t),) + a.shape[1:], a.dtype)
                variants.append((v,))
        warmed = []
        buckets, b = [], 1
        while b < self.config.max_batch:
            buckets.append(b)
            b <<= 1
        buckets.append(self.config.max_batch)
        for var in variants:
            var_f, fmask = var, None
            if self._sequence_mode(var):
                padded, fmask = batching.pad_sequence(
                    var[0], self.config.sequence_quantum
                )
                var_f = (padded,)
            sig = batching.bucket_signature(
                var_f, self.config.sequence_quantum,
                self._sequence_mode(var_f),
            )
            for bucket in buckets:
                cols = [
                    np.zeros((bucket,) + a.shape, a.dtype) for a in var_f
                ]
                fcol = (
                    np.tile(fmask, (bucket, 1)) if fmask is not None
                    else None
                )
                with self._weights_lock:
                    params, net_state = self.model.compute_params(), None
                with self._inflight_lock:
                    self._dispatch_token += 1
                    token = self._dispatch_token
                self._wd_arm(token)
                try:
                    self._call_model(cols, fcol, params, net_state)
                finally:
                    # dur=None: first-use warm-up durations must NOT
                    # seed the watchdog EWMA — with k=1 they would
                    # stretch the wedge-abort deadline far past
                    # dispatch_timeout_s for the first real batches
                    self._wd_disarm(token, None)
                warmed.append((sig, bucket))
        with self._stats_lock:
            self.warmed_signatures = warmed
        log.info("serving warm start: %d signature(s) run", len(warmed))
        return warmed

    # -- introspection -----------------------------------------------------
    def shed_pressure(self) -> float:
        """Advertised shed pressure in [0, 1] — the replica's own view of
        how close it is to rejecting traffic, published on ``/healthz``
        and ``/v1/status`` so a router (or any external LB) can stop
        sending BEFORE the 429/503s start.  Three components, max-combined:

        - queue depth fraction (``depth / max_queue`` — 1.0 = the next
          offer is a queue_full rejection);
        - the admission shed estimate for a default-deadline request
          (``admit_safety x batch EWMA x dispatches`` over
          ``default_deadline_s`` — exactly the quantity `_admit` sheds
          on, so pressure ≈ 1 precisely when deadline sheds begin);
        - breaker state (open = 1.0: everything is rejected; half-open
          = 0.75: only the single probe gets through);
        - KV-pool occupancy, when a `serving.generation.GenerationEngine`
          is attached (1.0 = the next stream admission is a
          ``kv_exhausted`` 429) — this is how a role-aware router
          steers token traffic away from a decode replica whose page
          pool is filling.

        Cold start (no batch-latency sample yet, or a coarse clock
        measured 0.0): the latency term is simply absent — the queue
        fraction still reports real backlog, and `_admit` guarantees a
        depth-0 request always dispatches, so the estimate can never
        freeze a replica out of the fleet."""
        depth = self.queue.depth
        q = depth / self.config.max_queue
        lat = 0.0
        est = self._estimated_wait(depth)
        if est is not None:
            lat = est / self.config.default_deadline_s
        b = {"closed": 0.0, "half_open": 0.75, "open": 1.0}.get(
            self.breaker.state, 1.0,
        )
        kv = 0.0
        engine = getattr(self, "generation_engine", None)
        if engine is not None:
            try:
                kv = float(engine.kv.occupancy())
            except Exception:     # a dying engine must not break health
                kv = 0.0
        return min(1.0, max(q, lat, b, kv))

    def health(self) -> dict:
        """The pull-based health payload (``GET /healthz`` body, and what
        a `serving.router.Router` polls in-process): enough signal for a
        load balancer to stop sending to a replica BEFORE it sheds.
        Schema documented in docs/serving.md."""
        state = self.breaker.state
        with self._stats_lock:
            ewma = self._batch_ewma
        out = {
            "status": "breaker_open" if state == "open" else "serving",
            "shed_pressure": round(self.shed_pressure(), 6),
            "breaker_state": state,
            "batch_latency_ewma_s": ewma,
            "weights_generation": self.generation,
            "queue_depth": self.queue.depth,
            "quantized": self.quantized,
        }
        engine = getattr(self, "generation_engine", None)
        if engine is not None:
            try:
                # rides the fleet push for free: observe/fleet's
                # _serving_summary ships health() verbatim
                out["generation"] = engine.health_summary()
            except Exception as e:  # dying engine must not break health
                log.debug("generation health join failed: %s", e)
        return out

    def stats(self) -> dict:
        with self._stats_lock:
            lats = sorted(self._latencies)
            counts = dict(self._counts)
            ewma = self._batch_ewma
            occupancy = self._last_occupancy
            totals = dict(self._lat_totals)
            slow_n = len(self._slow)

        def pct(p: float):
            if not lats:
                return None
            return lats[min(len(lats) - 1, int(p * len(lats)))]

        # the request-time decomposition (docs/serving.md): cumulative
        # seconds per segment over completed requests, plus the same as
        # fractions — "where does a served request's time go" straight
        # off /v1/status.  pad_overhead is an OVERLAY (a share of the
        # dispatch segment, not a sibling): it stays out of the
        # denominator so queue_wait/batch_form/dispatch partition to 1
        # and its own fraction reads as "share of request wall time"
        seg_sum = sum(v for k, v in totals.items() if k != "pad_overhead")
        breakdown = {
            "seconds_total": {k: round(v, 6) for k, v in totals.items()},
            "fraction": (
                {k: round(v / seg_sum, 4) for k, v in totals.items()}
                if seg_sum > 0 else None
            ),
        }
        return {
            "queue_depth": self.queue.depth,
            "generation": self.generation,
            "weights_generation": self.generation,
            "quantized": self.quantized,
            "shed_pressure": round(self.shed_pressure(), 6),
            "breaker_state": self.breaker.state,
            "batch_latency_ewma_s": ewma,
            "batch_occupancy": occupancy,
            "p50_s": pct(0.50),
            "p99_s": pct(0.99),
            "breaker": self.breaker.stats(),
            "warmed_programs": len(self.warmed_signatures),
            "latency_breakdown": breakdown,
            "slow_exemplars": slow_n,
            **counts,
        }

    def reset_latency_window(self) -> None:
        """Drop the percentile reservoir (bench phase boundaries)."""
        with self._stats_lock:
            self._latencies.clear()

    # -- telemetry helpers (never on the request's critical error path) ---
    def _shed(self, req: PendingRequest, reason: str) -> None:
        req.fail(ServingRejected(reason))
        self._count_shed(reason)
        self._trace_finish(req, "shed", reason=reason)

    def _count_shed(self, reason: str) -> None:
        with self._stats_lock:
            self._counts["shed"] += 1
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().counter("dl4jtpu_serving_shed_total").inc(
                reason=reason
            )
        except Exception as e:
            log.debug("serving shed metric failed: %s", e)

    def _count_outcome(self, outcome: str) -> None:
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().counter("dl4jtpu_serving_requests_total").inc(
                outcome=outcome
            )
        except Exception as e:
            log.debug("serving outcome metric failed: %s", e)

    def _count_swap(self, result: str) -> None:
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().counter("dl4jtpu_serving_hotswap_total").inc(
                result=result
            )
        except Exception as e:
            log.debug("serving hotswap metric failed: %s", e)

    def _observe_latency(self, secs: float) -> None:
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().histogram(
                "dl4jtpu_serving_request_latency_seconds"
            ).observe(secs)
        except Exception as e:
            log.debug("serving latency metric failed: %s", e)

    def _observe_breakdown(self, req: PendingRequest) -> None:
        """Per-request latency attribution into the histogram families
        (completed requests only: a failed dispatch's wall says nothing
        about where a SERVED request's time goes)."""
        try:
            queue_h, form_h, disp_h, pad_h, _ = _breakdown_families()
            lat = req.lat
            if "queue_wait" in lat:
                queue_h.observe(lat["queue_wait"])
            if "batch_form" in lat:
                form_h.observe(lat["batch_form"])
            if "dispatch" in lat:
                disp_h.observe(lat["dispatch"])
            if "pad_overhead" in lat:
                pad_h.observe(lat["pad_overhead"])
        except Exception as e:
            log.debug("serving breakdown metric failed: %s", e)

    def _gauge_depth(self) -> None:
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().gauge("dl4jtpu_serving_queue_depth").set(
                self.queue.depth
            )
        except Exception as e:
            log.debug("serving depth gauge failed: %s", e)

    def _gauge_batch(self, real: int, bucket: int) -> None:
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            reg = registry()
            reg.counter("dl4jtpu_serving_batches_total").inc()
            reg.gauge("dl4jtpu_serving_batch_occupancy").set(real / bucket)
            examples = _breakdown_families()[4]
            examples.inc(real, kind="real")
            if bucket > real:
                examples.inc(bucket - real, kind="pad")
        except Exception as e:
            log.debug("serving batch metric failed: %s", e)

    def _gauge_generation(self, gen: int) -> None:
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().gauge("dl4jtpu_serving_weights_generation").set(gen)
        except Exception as e:
            log.debug("serving generation gauge failed: %s", e)


# -- process-global server listing (the UI's /api/serving) -----------------

_SERVERS_LOCK = threading.Lock()
_SERVERS: "weakref.WeakSet[InferenceServer]" = weakref.WeakSet()


def _register_server(server: InferenceServer) -> None:
    with _SERVERS_LOCK:
        _SERVERS.add(server)


def active_servers() -> list[InferenceServer]:
    with _SERVERS_LOCK:
        return list(_SERVERS)
