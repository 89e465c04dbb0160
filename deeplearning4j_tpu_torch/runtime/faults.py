"""Deterministic fault injection — the port's copy of
`deeplearning4j_tpu/runtime/faults.py`, plan grammar and semantics
unchanged.

Named sites consult ``maybe_fail(site)``, and an armed `FaultPlan`
decides — deterministically — whether that call raises, delays, dies,
or asks the site to corrupt its own output.

Sites the port consults, where the JAX package consults them:

  ``serving.prefill``    the generation engine's per-stream prefill
                         (``raise`` ⇒ the stream fails explicitly, its
                         pages released; in `prefill_detached` a
                         `ServingError`)
  ``serving.decode``     the generation engine, before each batched
                         decode step, inside the step's watchdog arm
                         (``raise`` ⇒ every in-flight stream fails and
                         releases its pages; ``delay`` ⇒ a wedged step
                         the watchdog aborts)
  ``serving.draft``      the speculative drafter, per drafting stream
                         (``raise`` ⇒ that stream falls back to plain
                         decode for good; ``corrupt`` ⇒ garbage drafts
                         that must all be rejected, output unchanged)
  ``kv.alloc``           `PagedKVCache.alloc` (``raise`` ⇒ injected
                         exhaustion: an explicit ``kv_exhausted`` 429)
  ``serving.admit``      `InferenceServer.submit` entry (any kind ⇒ an
                         explicit ``admit_fault`` rejection)
  ``serving.infer``      the server's batched dispatch (``delay`` ⇒ a
                         wedged dispatch; ``raise`` ⇒ a failed one;
                         ``corrupt`` ⇒ NaN outputs the screen rejects)
  ``serving.hotswap``    `InferenceServer.push_weights` (``truncate`` /
                         ``corrupt`` ⇒ a torn or poisoned push that
                         rolls back)
  ``device.sync``        `observe.trace.StepScope.sync`, every fit
                         step (``delay`` ⇒ a wedged step the model's
                         watchdog escalates on)
  ``data.next_batch``    the fit loops' batch pull (``raise`` ⇒ a failed
                         pull: quarantined under a RecoveryPolicy, else
                         the fit ends)
  ``data.decode``        after the pull (``corrupt`` NaN-fills the
                         batch; ``raise`` a decode failure, quarantined
                         with the pulled bytes under a RecoveryPolicy)
  ``checkpoint.write``   `ModelSerializer.write_model` entry
                         (``truncate`` chops the published bytes)
  ``checkpoint.fsync``   between the zip landing in the tmp file and its
                         publish (``kill`` ⇒ kill -9 mid-write)

Every fire bumps ``dl4jtpu_faults_injected_total{site=...}``.  `SITES`
lists every site of the JAX package; the port's other modules consult
theirs as they are ported.

Plan grammar (also the ``DL4J_TPU_FAULT_PLAN`` env value, so subprocess
workers inherit the plan from their spawner's environment)::

    plan    := clause (";" clause)*
    clause  := SITE ":" KIND [":" param ("," param)*]
    KIND    := raise | delay | truncate | corrupt | kill
    param   := nth=N     fire exactly once, on the Nth consult (1-based)
             | every=N   fire on every Nth consult
             | p=F       fire with probability F per consult (seeded)
             | seed=N    RNG seed for p-triggers (default 0: deterministic)
             | max=N     stop firing after N fires
             | secs=F    sleep length for delay (default 0.05)
             | exc=NAME  exception for raise: connection (default) | timeout
                         | runtime

    DL4J_TPU_FAULT_PLAN="serving.draft:corrupt:every=1"

Zero overhead disarmed: ``maybe_fail`` is one module-global load and a
``None`` check per site.  Armed, each consult takes a small lock, bumps
the site counter, and evaluates the site's rules (`FaultPlan.stats`
counts consults and fires per site).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Optional

_ENV_VAR = "DL4J_TPU_FAULT_PLAN"

_KINDS = ("raise", "delay", "truncate", "corrupt", "kill")

# The site registry, the JAX package's table name for name: a plan
# written for one package arms the same sites in the other.  Plans may
# still name ad-hoc sites (tests do); this table is the contract for
# production call sites, not a runtime gate.  The module docstring lists
# the sites the port consults; the others wait for the modules that
# consult them.
SITES: dict = {
    "coordinator.rpc": "every CoordinatorClient request attempt",
    "heartbeat.send": "the worker heartbeat, before the rpc",
    "checkpoint.write": "ModelSerializer.write_model entry (may return "
                        "'truncate' — the site chops published bytes)",
    "checkpoint.fsync": "between the zip landing in the tmp file and "
                        "its atomic publish (kill here = kill-9 "
                        "mid-write)",
    "data.next_batch": "the fit loops' batch pull",
    "data.prefetch": "the PrefetchIterator producer thread, before each "
                     "base-iterator pull + device staging",
    "data.decode": "the fit loops' per-batch decode boundary, after the "
                   "pull ('corrupt' NaN-poisons the batch; 'raise' is a "
                   "per-record decode failure)",
    "device.sync": "the fit loops' device_sync barrier ('delay' "
                   "simulates a wedged step under the watchdog)",
    "data.device_decode": "the fused-decode fit paths' host boundary, "
                          "before staging raw bytes and dispatching the "
                          "decode+step program",
    "serving.admit": "InferenceServer.submit entry ('delay' = a slow "
                     "admission path; 'raise'/other kinds reject the "
                     "request explicitly as admit_fault)",
    "serving.infer": "the serving batcher, before each batched infer "
                     "dispatch ('delay' = a wedged dispatch under the "
                     "serving watchdog; 'raise' = a failed dispatch; "
                     "'corrupt' NaN-poisons the outputs — the "
                     "finiteness screen + breaker path)",
    "serving.hotswap": "InferenceServer.push_weights entry ('truncate' "
                       "= a torn push that dropped leaves; 'corrupt' "
                       "NaN-poisons the staged params; both must roll "
                       "back to the serving weights)",
    "serving.route": "the fleet Router's submit entry ('raise' = a "
                     "misrouted request the front door rejects "
                     "explicitly as route_fault; 'delay' = a slow "
                     "front door)",
    "serving.canary": "FleetDeployer's per-replica canary verification "
                      "('corrupt' perturbs the observed canary outputs "
                      "— the golden mismatch must roll the whole "
                      "deploy back)",
    "serving.prefill": "the generation engine's per-stream prefill "
                       "dispatch ('raise' = the stream fails "
                       "explicitly and its KV pages are released)",
    "serving.decode": "the generation engine, before each batched "
                      "decode step ('raise' = a failed step that "
                      "fails every in-flight stream and releases "
                      "their pages; 'delay' = a wedged step under "
                      "the generation watchdog)",
    "serving.draft": "the speculative drafter, once per drafting "
                     "stream per step ('raise' = the stream's drafter "
                     "latches OFF and it falls back to plain decode, "
                     "overhang pages truncated; 'corrupt' = garbage "
                     "drafts the verify pass must fully reject with "
                     "output unchanged)",
    "kv.alloc": "PagedKVCache page allocation ('raise' = injected "
                "pool exhaustion — the request is rejected with an "
                "explicit kv_exhausted 429, never a silent stall)",
}


class InjectedFault(ConnectionError):
    """Raised at a fault site by an armed plan (transient-shaped: subclasses
    ConnectionError/OSError so retry policies treat it like the real thing)."""


class InjectedTimeout(TimeoutError):
    """`exc=timeout` variant (TimeoutError is an OSError — still retryable)."""


class InjectedError(RuntimeError):
    """`exc=runtime` variant — NOT retryable; exercises give-up paths."""


_EXC_BY_NAME = {
    "connection": InjectedFault,
    "timeout": InjectedTimeout,
    "runtime": InjectedError,
}


class FaultRule:
    """One clause of a plan: a trigger + an action bound to a site."""

    def __init__(self, site: str, kind: str, *, nth: Optional[int] = None,
                 every: Optional[int] = None, p: Optional[float] = None,
                 seed: int = 0, max_fires: Optional[int] = None,
                 secs: float = 0.05, exc: str = "connection"):
        if kind not in _KINDS:
            raise ValueError(f"unknown fault kind {kind!r} (one of {_KINDS})")
        if exc not in _EXC_BY_NAME:
            raise ValueError(
                f"unknown exc {exc!r} (one of {sorted(_EXC_BY_NAME)})"
            )
        triggers = sum(x is not None for x in (nth, every, p))
        if triggers > 1:
            raise ValueError("pick ONE trigger per clause: nth=, every= or p=")
        if triggers == 0:
            nth = 1                       # default: one-shot on first consult
        self.site = site
        self.kind = kind
        self.nth = nth
        self.every = every
        self.p = p
        self.seed = int(seed)
        self.max_fires = max_fires
        self.secs = float(secs)
        self.exc = exc
        # runtime state (reset by FaultPlan.arm)
        self.fires = 0
        self._rng = None

    def reset(self) -> None:
        self.fires = 0
        if self.p is not None:
            import random

            self._rng = random.Random(self.seed)

    def should_fire(self, consult_no: int) -> bool:
        """consult_no is 1-based, per-site.  Caller holds the plan lock."""
        if self.max_fires is not None and self.fires >= self.max_fires:
            return False
        if self.nth is not None:
            return consult_no == self.nth
        if self.every is not None:
            return consult_no % self.every == 0
        return self._rng.random() < self.p

    def spec(self) -> str:
        params = []
        if self.nth is not None and self.nth != 1:
            params.append(f"nth={self.nth}")
        elif self.nth == 1:
            params.append("nth=1")
        if self.every is not None:
            params.append(f"every={self.every}")
        if self.p is not None:
            params.append(f"p={self.p}")
            params.append(f"seed={self.seed}")
        if self.max_fires is not None:
            params.append(f"max={self.max_fires}")
        if self.kind == "delay":
            params.append(f"secs={self.secs}")
        if self.exc != "connection":
            params.append(f"exc={self.exc}")
        head = f"{self.site}:{self.kind}"
        return head + (":" + ",".join(params) if params else "")


class FaultPlan:
    """A seedable registry of rules keyed by site, with per-site consult
    counters.  Thread-safe: heartbeat threads and the training loop consult
    concurrently."""

    def __init__(self, rules: list[FaultRule]):
        self._rules: dict[str, list[FaultRule]] = {}
        for r in rules:
            self._rules.setdefault(r.site, []).append(r)
        self._lock = threading.Lock()
        self._consults: dict[str, int] = {}
        for r in rules:
            r.reset()

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        rules = []
        for clause in text.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            parts = clause.split(":")
            if len(parts) < 2:
                raise ValueError(
                    f"bad fault clause {clause!r}: want site:kind[:params]"
                )
            site, kind = parts[0].strip(), parts[1].strip()
            kw: dict = {}
            if len(parts) > 2:
                for param in ":".join(parts[2:]).split(","):
                    param = param.strip()
                    if not param:
                        continue
                    if param == "once":
                        kw["nth"] = 1
                        continue
                    k, _, v = param.partition("=")
                    k = k.strip()
                    v = v.strip()
                    if k in ("nth", "every", "seed"):
                        kw[k] = int(v)
                    elif k == "max":
                        kw["max_fires"] = int(v)
                    elif k in ("p", "secs"):
                        kw[k] = float(v)
                    elif k == "exc":
                        kw["exc"] = v
                    else:
                        raise ValueError(
                            f"unknown fault param {k!r} in clause {clause!r}"
                        )
            rules.append(FaultRule(site, kind, **kw))
        if not rules:
            raise ValueError(f"empty fault plan {text!r}")
        return cls(rules)

    def spec(self) -> str:
        """Serialize back to the grammar — hand this to a subprocess's
        ``DL4J_TPU_FAULT_PLAN`` so the fleet inherits the plan."""
        return ";".join(
            r.spec() for rs in self._rules.values() for r in rs
        )

    def sites(self) -> list[str]:
        return sorted(self._rules)

    def stats(self) -> dict:
        """{site: {"consults": n, "fires": n}} — assert on these in tests."""
        with self._lock:
            return {
                site: {
                    "consults": self._consults.get(site, 0),
                    "fires": sum(r.fires for r in rs),
                }
                for site, rs in self._rules.items()
            }

    def consult(self, site: str) -> Optional[str]:
        rules = self._rules.get(site)
        if not rules:
            return None
        fired: Optional[FaultRule] = None
        with self._lock:
            n = self._consults.get(site, 0) + 1
            self._consults[site] = n
            for r in rules:
                if r.should_fire(n):
                    r.fires += 1
                    fired = r
                    break
        if fired is None:
            return None
        _count_fire(site)
        if fired.kind == "delay":
            time.sleep(fired.secs)
            return None
        if fired.kind == "kill":
            # the real thing: no atexit, no finally blocks, no flush —
            # exactly what a preemption or OOM-killer does to a worker
            os.kill(os.getpid(), signal.SIGKILL)
            return None                           # pragma: no cover
        if fired.kind == "raise":
            raise _EXC_BY_NAME[fired.exc](
                f"injected fault at {site} (consult #{n})"
            )
        return fired.kind                 # cooperative: "truncate"/"corrupt"


def _count_fire(site: str) -> None:
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        registry().counter("dl4jtpu_faults_injected_total").inc(site=site)
    except Exception:
        pass             # telemetry must never mask the injected fault —
        # and this path runs INSIDE the injected failure, where even a
        # logging call can recurse into a faulted subsystem


# -- process-global arming --------------------------------------------------

_PLAN: Optional[FaultPlan] = None


def arm(plan) -> FaultPlan:
    """Arm a plan process-wide (str in the grammar, or a FaultPlan).
    Counters reset on every arm()."""
    global _PLAN
    if isinstance(plan, str):
        plan = FaultPlan.parse(plan)
    for rs in plan._rules.values():
        for r in rs:
            r.reset()
    with plan._lock:
        plan._consults.clear()
    _PLAN = plan
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


def is_armed() -> bool:
    return _PLAN is not None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def maybe_fail(site: str) -> Optional[str]:
    """The per-site hook.  Disarmed (the default): one global load + None
    check — nothing else.  Armed: consult the plan; may raise, sleep, kill
    the process, or return an action string ("truncate") the site applies
    to its own output."""
    plan = _PLAN
    if plan is None:
        return None
    return plan.consult(site)


# Subprocess inheritance: workers spawned with DL4J_TPU_FAULT_PLAN in their
# environment arm themselves at import time, before any site is consulted.
_env_plan = os.environ.get(_ENV_VAR, "").strip()
if _env_plan:
    arm(_env_plan)
del _env_plan
