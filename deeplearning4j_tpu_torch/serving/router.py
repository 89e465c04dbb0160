"""Front-door Router — health-aware load balancing over serving
replicas; the port's copy of `deeplearning4j_tpu/serving/router.py`.

The replicas are the port's `InferenceServer` objects (or anything with
their ``health()`` / ``submit()`` contract); the router itself touches
no tensor, so it is host Python with threads and locks, as in the JAX
package.  Its four jobs, in the order a request meets them:

- **pull-based balancing**: every replica advertises shed pressure
  (`InferenceServer.health()`: queue-depth fraction, breaker state,
  batch-latency EWMA and KV occupancy folded into one [0,1] number) and
  the router sends each request to the least-pressured live replica —
  it stops sending to a loaded replica *before* that replica starts
  answering 429/503.
- **ejection + probation**: a replica that fails consecutively
  (`eject_threshold`), blows the per-try deadline (a wedged dispatch),
  or drops its connection is EJECTED into probation — the circuit
  breaker's OPEN/HALF_OPEN ladder at fleet scope.  After `probation_s`
  exactly one probe request is routed to it; success re-admits, failure
  restarts the timer.  Ejections are counted by reason
  (`dl4jtpu_replica_ejections_total`), never silent.
- **bounded retries**: inference is idempotent (a pure forward pass),
  so a failed or rejected try is retried on a DIFFERENT replica under
  an explicit per-request `retry_budget`.  Every retry is counted; on
  budget exhaustion the ORIGINAL error surfaces.
- **one optional hedge**: with `hedge_after_s` set, a try that has not
  completed by then gets ONE duplicate dispatch on another replica;
  the first result wins and the slower duplicate is cancelled (the
  server counts it as a timeout, so its ledger still balances).
  Counted under `dl4jtpu_router_hedges_total`.

`pick_for_role` steers a generation stream's prefill and decode hops
to the replica groups of `ServingFleet`'s roles.

Fault site ``serving.route`` is consulted at submit entry: ``raise``
becomes an explicit ``route_fault`` rejection (the front door fails
closed), ``delay`` a slow front door.  Every routed try lands on the
telemetry spine as ``dl4jtpu_router_requests_total{router,replica,
outcome}``, and a registry collector refreshes
``dl4jtpu_router_replica_pressure{router,replica}`` at scrape time
from the live routers (a weak set: a router nobody holds drops out,
and so do its series).

With tracing enabled, a routed request emits ONE causal chain rooted at
``router.request`` — each try is a ``router.try`` span (args: replica,
outcome), the hedge a ``router.hedge`` span, and every replica-side
chain (admit -> queue wait -> batch form -> dispatch) parents under the
try that submitted it.  Always on: ``dl4jtpu_router_overhead_seconds``
observes, per successful request, client wall MINUS the winning try's
service time — the retry + hedge + pick tax the front door added.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
import weakref
from typing import Optional

from deeplearning4j_tpu_torch.observe import trace as otrace
from deeplearning4j_tpu_torch.runtime import faults
from deeplearning4j_tpu_torch.serving.admission import (
    ServingError, ServingRejected, ServingTimeout,
)

log = logging.getLogger("deeplearning4j_tpu_torch")

ACTIVE = "active"
PROBATION = "probation"

#: rejection reasons that mean "this replica never ran the request" —
#: always safe to retry elsewhere (the failure classes that DO count
#: toward ejection are handled separately)
_RETRYABLE_REJECTS = frozenset((
    "queue_full", "deadline", "breaker_open", "admit_fault",
    "shutdown", "replica_dead",
))


@dataclasses.dataclass
class RouterConfig:
    """Front-door knobs (the JAX package's fields and defaults)."""

    eject_threshold: int = 3       # consecutive try failures to eject
    probation_s: float = 1.0       # ejected -> single-probe window
    retry_budget: int = 1          # cross-replica retries per request
    hedge_after_s: Optional[float] = None   # None = hedging off
    pressure_ceiling: float = 0.9  # avoid replicas advertising >= this
    health_refresh_s: float = 0.05  # per-replica health pull cache
    default_deadline_s: float = 1.0
    try_timeout_s: Optional[float] = None  # per-try cap (wedge detector)


#: replica roles for prefill/decode disaggregation: ``prefill`` runs
#: only prompt prefill programs, ``decode`` only the continuous decode
#: batch, ``both`` serves everything (the default single-group fleet)
ROLES = ("prefill", "decode", "both")


class ReplicaHandle:
    """One routable replica: an in-process `InferenceServer` today (the
    HTTP frontend wraps the same object, so a remote handle only needs
    to speak `/healthz` + `/v1/infer` — same payloads, same contract).
    Caches the pulled health for `refresh_s` so a hot router does not
    hammer the replica's locks on every request.

    ``role`` assigns the replica to a generation serving group
    (prefill / decode / both); `Router.pick_for_role` steers token
    traffic by it, while classic `/v1/infer` routing stays
    role-agnostic."""

    def __init__(self, name: str, server, refresh_s: float = 0.05,
                 role: str = "both"):
        if role not in ROLES:
            raise ValueError(f"role must be one of {ROLES}, got {role!r}")
        self.name = name
        self.server = server
        self.role = role
        self.refresh_s = float(refresh_s)
        self._lock = threading.Lock()
        self._cached: Optional[dict] = None
        self._cached_at = 0.0
        self._dead = False

    @property
    def dead(self) -> bool:
        with self._lock:
            return self._dead

    def kill(self) -> None:
        """Mark the replica dead (the fleet's hard-kill: a real process
        would answer connection-refused).  Routed submits fail fast with
        an explicit ``replica_dead`` rejection."""
        with self._lock:
            self._dead = True
            self._cached = None

    def revive(self) -> None:
        with self._lock:
            self._dead = False
            self._cached = None

    def health(self) -> dict:
        with self._lock:
            if self._dead:
                return {"status": "dead", "shed_pressure": 1.0,
                        "breaker_state": "dead"}
            now = time.monotonic()
            if (self._cached is not None
                    and now - self._cached_at < self.refresh_s):
                return self._cached
        h = self.server.health()       # replica locks: outside ours
        with self._lock:
            if not self._dead:
                self._cached = h
                self._cached_at = time.monotonic()
        return h

    def pressure(self) -> float:
        return float(self.health().get("shed_pressure", 1.0))

    def submit(self, features, deadline_s: float, trace_ctx=None):
        if self.dead:
            raise ServingRejected("replica_dead", self.name)
        return self.server.submit(features, deadline_s=deadline_s,
                                  trace_ctx=trace_ctx)


class Router:
    """The fleet's front door.  Thread-safe: many client threads route
    concurrently while the health collector scrapes."""

    def __init__(self, replicas: list, config: Optional[RouterConfig] = None):
        if not replicas:
            raise ValueError("router needs at least one replica")
        self.replicas = list(replicas)
        self.config = config or RouterConfig()
        # process-unique router name: two fleets in one process must
        # not merge their per-replica metric series (replica names are
        # only unique WITHIN a fleet)
        self.name = _next_router_name()
        self._lock = threading.Lock()
        # per-replica routing state: the fleet-scope breaker ladder
        self._state: dict[str, dict] = {
            h.name: {
                "state": ACTIVE, "fails": 0, "ejected_at": 0.0,
                "probe_inflight": False, "ejections": 0,
            }
            for h in self.replicas
        }
        if len(self._state) != len(self.replicas):
            raise ValueError("replica names must be unique")
        self._counts: dict[str, int] = {
            "requests": 0, "ok": 0, "failed": 0, "client_errors": 0,
            "retries": 0, "hedges": 0, "ejections": 0, "readmissions": 0,
        }
        self._rr = 0                    # tie-break rotation
        self._rec = otrace.tracer()     # cached: no lock per request
        _register_router(self)

    # -- routing state ------------------------------------------------------
    def replica_states(self) -> dict:
        with self._lock:
            return {
                name: {"state": st["state"], "fails": st["fails"],
                       "ejections": st["ejections"]}
                for name, st in self._state.items()
            }

    def stats(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
        return {
            "name": self.name,
            "replicas": self.replica_states(),
            "pressure": {h.name: round(h.pressure(), 6)
                         for h in self.replicas},
            **counts,
        }

    def _pick(self, exclude: frozenset = frozenset()):
        """Choose the next replica: an open probation probe wins (timed
        single-probe re-admission), else the least-pressured ACTIVE
        replica under the ceiling, else the least-pressured ACTIVE one
        at all.  Raises ``ServingRejected(no_replicas)`` when nothing
        is routable."""
        # pull health OUTSIDE the router lock (handles lock themselves)
        pressures = {
            h.name: h.pressure() for h in self.replicas
            if h.name not in exclude and not h.dead
        }
        dead = [h.name for h in self.replicas if h.dead]
        now = time.monotonic()
        newly_ejected = []
        if dead:
            # a dead handle (connection refused) is ejected the moment
            # the router notices — no try wasted on it, still counted
            with self._lock:
                for name in dead:
                    st = self._state[name]
                    if st["state"] == ACTIVE:
                        st["state"] = PROBATION
                        st["ejected_at"] = now
                        st["probe_inflight"] = False
                        st["ejections"] += 1
                        self._counts["ejections"] += 1
                        newly_ejected.append(name)
        for name in newly_ejected:
            log.warning("router ejected replica %s into probation (dead)",
                        name)
            _count_ejection("dead")
        with self._lock:
            probe = None
            candidates = []
            for h in self.replicas:
                if h.name not in pressures:
                    continue
                st = self._state[h.name]
                if st["state"] == PROBATION:
                    if (not st["probe_inflight"]
                            and now - st["ejected_at"]
                            >= self.config.probation_s):
                        probe = probe or h
                    continue
                candidates.append(h)
            if probe is not None:
                self._state[probe.name]["probe_inflight"] = True
                return probe, True
            if not candidates:
                raise ServingRejected(
                    "no_replicas",
                    f"no routable replica ({len(self.replicas)} total, "
                    f"{len(exclude)} excluded this request)",
                )
            under = [h for h in candidates
                     if pressures[h.name] < self.config.pressure_ceiling]
            pool = under or candidates
            best = min(pressures[h.name] for h in pool)
            ties = [h for h in pool if pressures[h.name] <= best + 1e-9]
            self._rr += 1
            return ties[self._rr % len(ties)], False

    def pick_for_role(self, need: str, trace_ctx=None):
        """Least-pressured live ACTIVE replica whose role serves
        ``need`` (``prefill`` or ``decode``; ``both`` replicas serve
        either).  Pressure includes the KV-occupancy term
        (`InferenceServer.shed_pressure`), so a decode replica whose
        page pool is filling sheds token traffic here — BEFORE its
        admissions start answering ``kv_exhausted`` 429s.  Raises
        ``ServingRejected(no_replicas)`` when the role group is empty
        or fully ejected.  `trace_ctx` is a generation stream's
        ``(trace_id, root_span)``: the pick records a ``router.pick``
        span into that chain, so the cluster timeline shows WHY a
        stream landed on its prefill/decode replicas."""
        if need not in ("prefill", "decode"):
            raise ValueError(f"need must be prefill|decode, got {need!r}")
        t0_pc = time.perf_counter()
        pressures = {
            h.name: h.pressure() for h in self.replicas
            if not h.dead and h.role in (need, "both")
        }
        with self._lock:
            candidates = [
                h for h in self.replicas
                if h.name in pressures
                and self._state[h.name]["state"] == ACTIVE
            ]
            if not candidates:
                raise ServingRejected(
                    "no_replicas",
                    f"no routable {need} replica "
                    f"({len(self.replicas)} total)",
                )
            under = [h for h in candidates
                     if pressures[h.name] < self.config.pressure_ceiling]
            pool = under or candidates
            best = min(pressures[h.name] for h in pool)
            ties = [h for h in pool if pressures[h.name] <= best + 1e-9]
            self._rr += 1
            chosen = ties[self._rr % len(ties)]
        self._trace_pick(need, chosen.name, trace_ctx, t0_pc)
        return chosen

    def _trace_pick(self, need: str, replica: str, trace_ctx,
                    t0_pc: float) -> None:
        """One ``router.pick`` span in a generation stream's chain
        (no-op without a context or with tracing off)."""
        try:
            rec = otrace.tracer()
            if trace_ctx is None or not rec.enabled:
                return
            trace_id, parent = trace_ctx
            rec.add_complete(
                "router.pick", t0_pc, time.perf_counter() - t0_pc,
                cat="generation",
                **otrace.trace_args(trace_id, otrace.next_id(), parent),
                role=need, replica=replica,
            )
        except Exception as e:
            log.debug("router pick span failed: %s", e)

    def _record(self, handle, outcome: str, probe: bool,
                eject_reason: Optional[str] = None) -> None:
        """Fold one try's outcome into the replica's routing state.
        ``outcome``: ok | error | timeout | client_timeout | rejected |
        dead.  Ejection:
        immediately for dead tries (connection refused is unambiguous),
        after `eject_threshold` consecutive errors/timeouts otherwise —
        the reason records ``wedged`` when the per-try deadline was the
        last straw (a single short-deadline client must not eject a
        healthy replica).  Sheds (``rejected``) are load signals, not
        failures — the pressure pull handles those."""
        ejected = readmitted = None
        with self._lock:
            st = self._state[handle.name]
            if probe:
                st["probe_inflight"] = False
            if outcome == "ok":
                st["fails"] = 0
                # ONLY the designated probe re-admits: a straggler ok
                # from a request dispatched before the ejection (e.g. a
                # dying replica draining its queue) must not flap the
                # replica back into rotation
                if st["state"] == PROBATION and probe:
                    st["state"] = ACTIVE
                    self._counts["readmissions"] += 1
                    readmitted = True
            elif outcome in ("error", "timeout", "dead"):
                st["fails"] += 1
                fails = st["fails"]
                reason = eject_reason or (
                    "wedged" if outcome == "timeout"
                    else "dead" if outcome == "dead"
                    else "consecutive_failures"
                )
                if st["state"] == PROBATION:
                    # failed probe: restart the timer
                    st["ejected_at"] = time.monotonic()
                elif (outcome == "dead"
                      or fails >= self.config.eject_threshold):
                    st["state"] = PROBATION
                    st["ejected_at"] = time.monotonic()
                    st["probe_inflight"] = False
                    st["ejections"] += 1
                    self._counts["ejections"] += 1
                    ejected = (reason, fails)
            elif outcome == "client_timeout":
                # the CLIENT's deadline expired mid-try with no per-try
                # cap binding: says nothing about the replica's health
                # (a short-deadline client must not eject a healthy
                # fleet) — counted in the metric, no failure streak
                pass
            # "rejected": neither a success streak nor a failure streak
        if ejected:
            log.warning("router ejected replica %s into probation (%s, "
                        "%d consecutive failure(s))",
                        handle.name, ejected[0], ejected[1])
            ejected = ejected[0]
            _count_ejection(ejected)
        if readmitted:
            log.info("router re-admitted replica %s (probe succeeded)",
                     handle.name)
        _count_try(
            self.name, handle.name,
            {"dead": "rejected", "client_timeout": "timeout"}.get(
                outcome, outcome,
            ),
        )

    # -- the request path ---------------------------------------------------
    def infer(self, features, deadline_s: Optional[float] = None):
        """Route one request: pick by pulled pressure, retry idempotent
        failures on a different replica under the retry budget, hedge
        the latency tail once when configured.  Raises the ORIGINAL
        error when the budget runs out — every retry and hedge is
        counted, never silent."""
        try:
            action = faults.maybe_fail("serving.route")
        except Exception as exc:
            # a front door that raises is a failing ROUTER, not a failing
            # request: explicit rejection, client may retry
            raise ServingRejected("route_fault", str(exc)) from exc
        if action is not None:
            raise ServingRejected("route_fault", f"injected {action}")
        deadline_s = (self.config.default_deadline_s
                      if deadline_s is None else float(deadline_s))
        deadline = time.monotonic() + deadline_s
        t_req0 = time.monotonic()
        t0_pc = time.perf_counter()
        # one causal chain per routed request: every try/hedge span and
        # every replica-side chain parents under this root
        trace_id = root_span = None
        if self._rec.enabled:
            trace_id, root_span = otrace.next_id(), otrace.next_id()
        with self._lock:
            self._counts["requests"] += 1
        budget = int(self.config.retry_budget)
        tried: set[str] = set()
        original: Optional[BaseException] = None
        retries = 0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                # exclude already-tried replicas first; once every
                # ROUTABLE replica has had a try, a remaining budget
                # may re-try anywhere (the transient may have cleared)
                # — counted against replicas _pick can actually route
                # to (active, or a probe-ready probation), not the
                # roster, or one dead/ejected replica would pin the
                # exclusion and surface errors with budget unspent
                exclude = (frozenset(tried)
                           if len(tried) < max(self._routable_count(), 1)
                           else frozenset())
                handle, probe = self._pick(exclude)
            except ServingRejected as exc:
                if original is None:
                    original = exc
                break
            tried.add(handle.name)
            try:
                out, service_s = self._try_one(
                    handle, probe, features, remaining,
                    trace_id, root_span,
                )
                with self._lock:
                    self._counts["ok"] += 1
                # retry + hedge + pick tax: the client's wall minus the
                # winning try's own service time (always-on attribution)
                _observe_overhead(
                    max(0.0, (time.monotonic() - t_req0) - service_s)
                )
                self._trace_root(trace_id, root_span, t0_pc, "ok",
                                 retries=retries)
                return out
            except (ServingRejected, ServingTimeout, ServingError) as exc:
                if original is None:
                    original = exc
                if not self._retryable(exc):
                    break
                if budget <= 0:
                    break
                budget -= 1
                retries += 1
                with self._lock:
                    self._counts["retries"] += 1
                _count_retry()
                continue
            except BaseException:
                # a non-serving failure (malformed request raising
                # before it enqueues) exits through here: close the
                # ledger — requests == ok + failed + client_errors
                # must always balance
                with self._lock:
                    self._counts["client_errors"] += 1
                self._trace_root(trace_id, root_span, t0_pc,
                                 "client_error", retries=retries)
                raise
        with self._lock:
            self._counts["failed"] += 1
        if original is None:
            original = ServingTimeout(
                f"request deadline {deadline_s:.3f}s expired before any "
                "replica could be tried"
            )
        self._trace_root(trace_id, root_span, t0_pc, "failed",
                         retries=retries,
                         error=type(original).__name__)
        raise original

    # ``submit`` would hand back a PendingRequest pinned to ONE replica,
    # which defeats retries/hedging — the router's unit of work is the
    # whole routed request, so only the blocking form is offered.
    __call__ = infer

    def _routable_count(self) -> int:
        """Replicas `_pick` could route to right now: active ones plus
        probation replicas whose probe window is open."""
        now = time.monotonic()
        n = 0
        with self._lock:
            for h in self.replicas:
                if h.dead:
                    continue
                st = self._state[h.name]
                if st["state"] == ACTIVE:
                    n += 1
                elif (not st["probe_inflight"]
                      and now - st["ejected_at"]
                      >= self.config.probation_s):
                    n += 1
        return n

    @staticmethod
    def _retryable(exc: BaseException) -> bool:
        if isinstance(exc, ServingRejected):
            return exc.reason in _RETRYABLE_REJECTS
        # ServingError: idempotent dispatch failure -> another replica
        # may be healthy.  ServingTimeout: the per-try cap fired with
        # client deadline left, or the client deadline itself expired —
        # the remaining-time check in the loop settles which.
        return isinstance(exc, (ServingError, ServingTimeout))

    def _try_one(self, handle, probe: bool, features, remaining: float,
                 trace_id: Optional[int] = None,
                 root_span: Optional[int] = None):
        """One routed try against `handle`, with the optional hedge.
        Returns ``(result, service_s)`` — the winning dispatch's own
        wall, for the router-overhead attribution — or raises; ALWAYS
        records the try's outcome on the replica's routing state.  With
        tracing on, the try (and hedge) each get a span under the
        request root, and the replica-side chain parents under it."""
        cap = remaining
        # a timeout only counts as a WEDGE strike when the router's own
        # per-try cap was the binding constraint — a client deadline
        # expiring says nothing about the replica's health
        wedge = (self.config.try_timeout_s is not None
                 and self.config.try_timeout_s < remaining)
        if self.config.try_timeout_s is not None:
            cap = min(cap, self.config.try_timeout_s)
        t_try0 = time.monotonic()
        # ids allocated BEFORE the submit: the replica-side spans must
        # be able to parent under the try while it is still in flight
        tinfo = None
        if trace_id is not None and self._rec.enabled:
            tinfo = _TryTrace(trace_id, otrace.next_id(), root_span,
                              "router.try", handle.name,
                              time.perf_counter())
        try:
            req = handle.submit(features, deadline_s=cap,
                                trace_ctx=tinfo.ctx if tinfo else None)
        except ServingRejected as exc:
            self._record(
                handle, "dead" if exc.reason == "replica_dead"
                else "rejected", probe,
            )
            self._trace_try(tinfo, "rejected", reason=exc.reason)
            raise
        except BaseException:
            # a NON-serving failure (e.g. wrong input arity raising
            # ValueError before the request ever enqueues) is a client
            # error, not a replica outcome: leave the routing state
            # untouched but RELEASE the probe slot, or a probation
            # replica whose probe drew a malformed request could never
            # be probed again
            if probe:
                self._release_probe(handle)
            self._trace_try(tinfo, "client_error")
            raise
        hedge_after = self.config.hedge_after_s
        if (hedge_after is None or hedge_after >= cap
                or len(self.replicas) < 2):
            return (self._resolve(handle, probe, req, cap, wedge, tinfo),
                    time.monotonic() - t_try0)
        if req._event.wait(min(hedge_after, cap)):
            return (self._resolve(handle, probe, req, 0.0, wedge, tinfo),
                    time.monotonic() - t_try0)
        # latency tail: ONE duplicate on a different replica
        try:
            alt, alt_probe = self._pick(frozenset((handle.name,)))
        except ServingRejected:
            return (self._resolve(handle, probe, req, cap, wedge, tinfo),
                    time.monotonic() - t_try0)
        t_left = cap - min(hedge_after, cap)
        hinfo = None
        if tinfo is not None:
            hinfo = _TryTrace(trace_id, otrace.next_id(), root_span,
                              "router.hedge", alt.name,
                              time.perf_counter())
        t_hedge0 = time.monotonic()
        try:
            hreq = alt.submit(features, deadline_s=max(t_left, 0.001),
                              trace_ctx=hinfo.ctx if hinfo else None)
        except ServingRejected as exc:
            self._record(alt, "rejected", alt_probe)
            self._trace_try(hinfo, "rejected", reason=exc.reason)
            return (self._resolve(handle, probe, req, cap, wedge, tinfo),
                    time.monotonic() - t_try0)
        with self._lock:
            self._counts["hedges"] += 1
        _count_hedge()
        end = time.monotonic() + t_left
        while time.monotonic() < end:
            if req.done:
                winner, wprobe, loser, lprobe = handle, probe, alt, alt_probe
                wreq, lreq = req, hreq
                break
            if hreq.done:
                winner, wprobe, loser, lprobe = alt, alt_probe, handle, probe
                wreq, lreq = hreq, req
                break
            req._event.wait(0.001)
        else:
            winner, wprobe, loser, lprobe = handle, probe, alt, alt_probe
            wreq, lreq = req, hreq
        winfo, linfo = (tinfo, hinfo) if wreq is req else (hinfo, tinfo)
        w_t0 = t_try0 if wreq is req else t_hedge0
        l_t0 = t_hedge0 if wreq is req else t_try0
        try:
            out = self._resolve(winner, wprobe, wreq, 0.0, wedge, winfo)
        except (ServingRejected, ServingTimeout, ServingError):
            # the faster completion FAILED: the slower duplicate is the
            # request's remaining hope — await it for the time left.
            # Only the PRIMARY had the full per-try cap by now; the
            # hedge only got the residual window, so a timeout there
            # must not count as a wedge strike against it
            return (self._resolve(loser, lprobe, lreq,
                                  end - time.monotonic(),
                                  wedge and loser is handle, linfo),
                    time.monotonic() - l_t0)
        # dedup: the slower duplicate is DISCARDED — cancelled so the
        # losing replica counts it (timeout) and its ledger balances,
        # and its routing state is left untouched (it did nothing wrong)
        lreq.cancelled = True
        if lprobe:
            self._release_probe(loser)
        self._trace_try(linfo, "discarded")
        return out, time.monotonic() - w_t0

    def _release_probe(self, handle) -> None:
        """Free a probe slot whose try resolved without a recordable
        outcome (discarded hedge loser, malformed request)."""
        with self._lock:
            self._state[handle.name]["probe_inflight"] = False

    def _resolve(self, handle, probe: bool, req, timeout: float,
                 wedge: bool = False, tinfo=None):
        """Await one try's PendingRequest and record the outcome.
        `wedge` = the per-try cap (not the client deadline) bounds this
        wait, so a timeout indicts the replica."""
        try:
            out = req.result(timeout=max(timeout, 0.0))
        except ServingRejected as exc:
            self._record(handle, "rejected", probe)
            self._trace_try(tinfo, "rejected", reason=exc.reason)
            raise
        except ServingTimeout:
            # wedge detector: the per-try deadline fired — the replica
            # took the request and never answered.  A bare client
            # deadline expiring is recorded WITHOUT a failure strike.
            self._record(handle, "timeout" if wedge else "client_timeout",
                         probe)
            self._trace_try(tinfo, "timeout")
            raise
        except ServingError:
            self._record(handle, "error", probe)
            self._trace_try(tinfo, "error")
            raise
        self._record(handle, "ok", probe)
        self._trace_try(tinfo, "ok")
        return out

    # -- request-trace helpers ---------------------------------------------
    def _trace_root(self, trace_id: Optional[int],
                    root_span: Optional[int], t0_pc: float, outcome: str,
                    **args) -> None:
        if trace_id is None or not self._rec.enabled:
            return
        self._rec.add_complete(
            "router.request", t0_pc, time.perf_counter() - t0_pc,
            cat="request",
            **otrace.trace_args(trace_id, root_span),
            router=self.name, outcome=outcome, **args,
        )

    def _trace_try(self, tinfo: Optional["_TryTrace"], outcome: str,
                   **args) -> None:
        """Close one try/hedge span (no-op when the request is
        untraced).  Recorded ONCE, at the try's terminal outcome."""
        if tinfo is None or not self._rec.enabled:
            return
        self._rec.add_complete(
            tinfo.name, tinfo.t0_pc, time.perf_counter() - tinfo.t0_pc,
            cat="request",
            **otrace.trace_args(tinfo.trace_id, tinfo.span_id,
                                tinfo.parent),
            replica=tinfo.replica, outcome=outcome, **args,
        )


class _TryTrace:
    """Span bookkeeping for one routed try/hedge: ids allocated before
    the submit so the replica-side chain can parent under it."""

    __slots__ = ("trace_id", "span_id", "parent", "name", "replica",
                 "t0_pc")

    def __init__(self, trace_id: int, span_id: int, parent: Optional[int],
                 name: str, replica: str, t0_pc: float):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent = parent
        self.name = name
        self.replica = replica
        self.t0_pc = t0_pc

    @property
    def ctx(self) -> tuple:
        return (self.trace_id, self.span_id)


# -- telemetry helpers (never on the request's critical path) ---------------

_OVERHEAD_HIST = None


def _observe_overhead(secs: float) -> None:
    """Per successful routed request — the family is resolved once
    (like server.py's `_breakdown_families`): the front door's hot path
    must not pay a registry lock + lookup per request."""
    global _OVERHEAD_HIST
    try:
        if _OVERHEAD_HIST is None:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            _OVERHEAD_HIST = registry().histogram(
                "dl4jtpu_router_overhead_seconds"
            )
        _OVERHEAD_HIST.observe(secs)
    except Exception as e:
        log.debug("router overhead metric failed: %s", e)


def _count_try(router: str, replica: str, outcome: str) -> None:
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        registry().counter("dl4jtpu_router_requests_total").inc(
            router=router, replica=replica, outcome=outcome,
        )
    except Exception as e:
        log.debug("router try metric failed: %s", e)


def _count_retry() -> None:
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        registry().counter("dl4jtpu_router_retries_total").inc()
    except Exception as e:
        log.debug("router retry metric failed: %s", e)


def _count_hedge() -> None:
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        registry().counter("dl4jtpu_router_hedges_total").inc()
    except Exception as e:
        log.debug("router hedge metric failed: %s", e)


def _count_ejection(reason: str) -> None:
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        registry().counter("dl4jtpu_replica_ejections_total").inc(
            reason=reason,
        )
    except Exception as e:
        log.debug("router ejection metric failed: %s", e)


# -- process-global router listing + pressure collector ---------------------

_ROUTERS_LOCK = threading.Lock()
_ROUTERS: "weakref.WeakSet[Router]" = weakref.WeakSet()
_COLLECTOR_INSTALLED = False
_PRESSURE_SEEN: set = set()
_ROUTER_SEQ = 0


def _next_router_name() -> str:
    global _ROUTER_SEQ
    with _ROUTERS_LOCK:
        _ROUTER_SEQ += 1
        return f"router{_ROUTER_SEQ}"


def _register_router(router: Router) -> None:
    global _COLLECTOR_INSTALLED
    with _ROUTERS_LOCK:
        _ROUTERS.add(router)
        need_install = not _COLLECTOR_INSTALLED
        _COLLECTOR_INSTALLED = True
    if need_install:
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().register_collector(_pressure_collector)
        except Exception as e:
            log.debug("router pressure collector install failed: %s", e)
            with _ROUTERS_LOCK:
                _COLLECTOR_INSTALLED = False


def active_routers() -> list:
    with _ROUTERS_LOCK:
        return list(_ROUTERS)


def _pressure_collector() -> None:
    """Registry pull collector: refresh the per-replica pressure gauge
    from every live router at scrape time (and drop series for replicas
    that no longer exist — a dead fleet must not freeze its last
    pressure on /metrics forever)."""
    from deeplearning4j_tpu_torch.observe.metrics import registry

    gauge = registry().gauge("dl4jtpu_router_replica_pressure")
    live = {}
    for router in active_routers():
        for h in router.replicas:
            # replica names are only unique WITHIN a fleet: key (and
            # label) by router too, or two fleets' r0 series merge
            live[(router.name, h.name)] = h.pressure()
    with _ROUTERS_LOCK:
        for router_name, name in _PRESSURE_SEEN - set(live):
            gauge.remove(router=router_name, replica=name)
        _PRESSURE_SEEN.clear()
        _PRESSURE_SEEN.update(live)
    for (router_name, name), p in live.items():
        gauge.set(p, router=router_name, replica=name)
