"""ServingFleet — N `InferenceServer` replicas behind one front door;
the port's copy of `deeplearning4j_tpu/serving/fleet.py`.

The fleet owns the replicas (each the port's full serving plane:
continuous batching, bounded admission, breaker, watchdog, verified
hot-swap), a `Router` front door routes by pulled health, and a
`FleetDeployer` rolls weight pushes out replica by replica with canary
verification.  A replica failure costs the client at most one counted
retry.

    fleet = ServingFleet(lambda: SequentialModel(conf).init(), n_replicas=2)
    fleet.warm_start(example)
    fleet.start()
    out = fleet.infer(features, deadline_s=0.25)     # routed + retried
    result = fleet.deployer.deploy(new_params)       # rolling + canary
    fleet.stop()

The replicas run where their models run (the factory's device, CUDA by
default); every replica shares the process and, on the card, the one
device: each engine captures its decode graph on its own side stream,
with ``capture_error_mode="thread_local"``, so one replica re-captures
while the other launches.

Rolling deploys: each replica is swapped through the verified hot-swap
(structure, shape, checksum, finiteness), then probed with the golden
inputs through its REAL serving path.  The expected outputs are computed
from the staged params' compute copy (the dtype the replica serves in:
bf16 on the card) at the batch bucket the probe dispatched in, so the
comparison at ``tolerance`` 1e-4 holds the replica to the same program
at the same shape, not to another product shape's rounding.  Any
failure rolls the WHOLE fleet back to the pre-deploy params.  Fault
site ``serving.canary`` (``corrupt`` perturbs the observed canary
outputs) makes the mismatch path provokable;
`dl4jtpu_canary_failures_total` and `dl4jtpu_fleet_deploy_generation`
land on the telemetry spine.

Token generation rides the same fleet: ``roles=`` assigns each replica
to the prefill or decode group (default ``both``),
``generation_config=`` attaches one `GenerationEngine` per replica, and
`generate` routes each stream's prompt pass to a prefill replica
(`prefill_detached`: the prompt's K/V come back as host f32 arrays, the
portable handoff) and adopts the handoff into a decode replica's
continuous batch (`join_prefilled`).

One divergence from the JAX package: `revive_replica` restarts the
decode loop of a decode-capable replica's engine, which `kill_replica`
stopped (the JAX fleet restarts only the server, so a revived decode
replica never decodes again; ROADMAP C14).
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

import numpy as np

from deeplearning4j_tpu_torch.observe import trace as otrace
from deeplearning4j_tpu_torch.runtime import faults
from deeplearning4j_tpu_torch.serving.router import (
    ReplicaHandle, Router, RouterConfig,
)
from deeplearning4j_tpu_torch.serving.server import (
    InferenceServer, ServingConfig,
)

log = logging.getLogger("deeplearning4j_tpu_torch")


class ServingFleet:
    """N in-process replicas + the router front door.

    ``model_factory`` builds one model per replica (replicas must not
    share a live model object: each snapshots its own params under its
    own swap lock).  Replicas are named ``r0..rN-1``; the fleet's
    ``infer`` goes through the router (health-aware pick, retries,
    optional hedge), and ``push_weights``/``push_checkpoint`` go
    through the rolling deployer."""

    def __init__(self, model_factory: Callable, n_replicas: int = 2,
                 config: Optional[ServingConfig] = None,
                 router_config: Optional[RouterConfig] = None,
                 golden_inputs: Optional[list] = None,
                 roles: Optional[list] = None,
                 generation_config=None):
        if n_replicas < 1:
            raise ValueError("fleet needs at least one replica")
        if roles is None:
            roles = ["both"] * n_replicas
        if len(roles) != n_replicas:
            raise ValueError(
                f"roles must name every replica: got {len(roles)} "
                f"role(s) for {n_replicas} replica(s)"
            )
        self.replicas: list[InferenceServer] = []
        for _ in range(n_replicas):
            cfg = ServingConfig(**vars(config)) if config is not None \
                else ServingConfig()
            self.replicas.append(InferenceServer(model_factory(), cfg))
        self.handles = [
            ReplicaHandle(f"r{i}", srv,
                          refresh_s=(router_config or RouterConfig())
                          .health_refresh_s,
                          role=roles[i])
            for i, srv in enumerate(self.replicas)
        ]
        self.router = Router(self.handles, router_config)
        self.deployer = FleetDeployer(self, golden_inputs=golden_inputs)
        # token-generation engines, one per replica, keyed by handle
        # name — populated by `enable_generation`
        self.engines: dict = {}
        if generation_config is not None:
            self.enable_generation(generation_config)

    # -- lifecycle ---------------------------------------------------------
    def warm_start(self, example=None, lengths=None) -> "ServingFleet":
        for srv in self.replicas:
            srv.warm_start(example, lengths=lengths)
        return self

    def start(self) -> "ServingFleet":
        for srv in self.replicas:
            srv.start()
        for h in self.handles:
            self._start_engine(h)
        return self

    def _start_engine(self, h: ReplicaHandle) -> None:
        # prefill-only replicas never run the decode loop: their engine
        # exists for the prefill programs alone
        eng = self.engines.get(h.name)
        if eng is not None and h.role in ("decode", "both"):
            eng.start()

    def stop(self, timeout: float = 10.0) -> None:
        for eng in self.engines.values():
            eng.stop(timeout)
        for srv in self.replicas:
            srv.stop(timeout)

    def kill_replica(self, index: int) -> None:
        """Hard-kill one replica mid-traffic (the chaos scenario): its
        handle answers ``replica_dead`` immediately — exactly what a
        dead process's connection-refused looks like from the router —
        and its batcher stops WITHOUT draining; queued requests on it
        fail explicitly at shutdown, in-flight routing retries them on
        the survivors."""
        h = self.handles[index]
        h.kill()
        eng = self.engines.get(h.name)
        if eng is not None:
            eng.stop(timeout=1.0)
        self.replicas[index].stop(timeout=1.0)
        log.warning("fleet replica %s hard-killed", h.name)

    def revive_replica(self, index: int) -> bool:
        """Bring a killed replica back: restart it, RE-SYNC it onto the
        last successfully deployed weights (a deploy that ran while it
        was dead skipped it), canary-verify, restart its decode loop,
        and only then mark the handle routable.  Returns False (handle
        stays dead, router keeps avoiding it) when the re-sync or canary
        fails."""
        self.replicas[index].start()
        if not self.deployer.sync_replica(index):
            log.warning("fleet replica r%d revive ABORTED: re-sync onto "
                        "the deployed weights failed — handle stays "
                        "dead", index)
            return False
        self._start_engine(self.handles[index])
        self.handles[index].revive()
        return True

    # -- the request path (the router IS the front door) -------------------
    def infer(self, features, deadline_s: Optional[float] = None):
        return self.router.infer(features, deadline_s=deadline_s)

    # -- token generation (prefill/decode disaggregation) ------------------
    def enable_generation(self, config=None) -> "ServingFleet":
        """Attach one `GenerationEngine` per replica (sharing the
        replica's model, swap lock, and breaker).  Engines on
        decode-capable replicas (`role` decode/both) get their decode
        loop started by `start()`; prefill-only replicas keep just the
        prefill programs."""
        from deeplearning4j_tpu_torch.serving.generation import (
            GenerationConfig, GenerationEngine,
        )

        for h, srv in zip(self.handles, self.replicas):
            if h.name in self.engines:
                continue
            cfg = GenerationConfig(**vars(config)) if config is not None \
                else GenerationConfig()
            self.engines[h.name] = GenerationEngine(server=srv, config=cfg)
        return self

    def generate(self, prompt, max_new_tokens: Optional[int] = None, *,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 stop_tokens: tuple = (), on_token=None,
                 spec_k: Optional[int] = None,
                 timeout: Optional[float] = 120.0) -> np.ndarray:
        """One disaggregated stream through the fleet: the router picks
        a PREFILL-role replica (least pressure, KV occupancy included)
        whose engine runs the prompt pass and emits a portable handoff,
        then a DECODE-role replica's engine adopts the handoff into its
        continuous decode batch.  On a fleet of all-``both`` replicas
        this degenerates to least-pressure placement of the whole
        stream."""
        if not self.engines:
            raise RuntimeError(
                "generation is not enabled on this fleet — construct it "
                "with generation_config= or call enable_generation()"
            )
        # One trace id for the WHOLE stream, allocated at the front
        # door: the prefill replica's spans, the kv handoff, and the
        # decode replica's step spans all parent onto the same root.
        rec = otrace.tracer()
        ctx = (otrace.next_id(), otrace.next_id()) if rec.enabled else None
        h_pre = self.router.pick_for_role("prefill", trace_ctx=ctx)
        handoff = self.engines[h_pre.name].prefill_detached(
            prompt, max_new_tokens if max_new_tokens is not None
            else self.engines[h_pre.name].config.default_max_new,
            temperature=temperature, top_k=top_k, seed=seed,
            stop_tokens=stop_tokens, spec_k=spec_k, trace_ctx=ctx,
        )
        h_dec = self.router.pick_for_role("decode", trace_ctx=ctx)
        log.debug("fleet generate: prefill on %s, decode on %s",
                  h_pre.name, h_dec.name)
        req = self.engines[h_dec.name].join_prefilled(
            handoff, on_token=on_token,
        )
        return req.result(timeout)

    # -- weight deploys ----------------------------------------------------
    def push_weights(self, params, net_state=None,
                     checksum: Optional[int] = None,
                     source: str = "api") -> bool:
        """Rolling deploy of `params` (duck-types the single-server
        `push_weights` contract so fleet and replica are drop-in for
        each other).  True = installed fleet-wide; False = rolled back
        everywhere."""
        return self.deployer.deploy(
            params, net_state=net_state, checksum=checksum, source=source,
        )["installed"]

    def push_checkpoint(self, path: str, source: Optional[str] = None,
                        include_net_state: bool = True) -> bool:
        return self.deployer.deploy_checkpoint(
            path, source=source, include_net_state=include_net_state,
        )["installed"]

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        return {
            "replicas": {h.name: srv.stats()
                         for h, srv in zip(self.handles, self.replicas)},
            "router": self.router.stats(),
            "deploy_generation": self.deployer.generation,
        }

    def health(self) -> dict:
        """Fleet-level health: the MINIMUM replica pressure is the
        front door's headroom (one idle replica = the fleet can take
        traffic)."""
        per = {h.name: h.health() for h in self.handles}
        live = [p["shed_pressure"] for p in per.values()
                if p.get("status") == "serving"]
        return {
            "status": "serving" if live else "unavailable",
            "shed_pressure": min(live) if live else 1.0,
            "replicas": per,
            "deploy_generation": self.deployer.generation,
        }


class CanaryError(RuntimeError):
    """A swapped replica failed its golden-pair verification."""


class FleetDeployer:
    """Rolling weight deploys with canary verification + fleet rollback.

    The deploy ladder, per replica in order:

    1. **verified hot-swap**: structure / shape / checksum / finiteness
       — a torn or poisoned push rolls back HERE and the deploy aborts;
    2. **canary probe**: every recorded golden input is routed through
       the replica's REAL serving path and the outputs must be finite
       and within `tolerance` of the expected outputs computed from the
       staged params at the probe's batch bucket;
    3. only then does the next replica swap.

    ANY failure rolls every already-swapped replica back to its
    pre-deploy params (verified hot-swaps again).  At most one replica
    ever held bad weights, and only between its swap and its canary
    check.  The port's models carry no net state: ``net_state`` passes
    through to each replica's `push_weights`, which rejects a non-empty
    one."""

    def __init__(self, fleet: ServingFleet,
                 golden_inputs: Optional[list] = None,
                 tolerance: float = 1e-4):
        self.fleet = fleet
        self.tolerance = float(tolerance)
        self._lock = threading.Lock()
        # deploys are SERIALIZED: two interleaved rolling deploys would
        # capture each other's mid-roll params as rollback snapshots
        # and a rollback could leave the fleet on a MIX of both pushes
        self._deploy_lock = threading.Lock()
        self._goldens: list = list(golden_inputs or [])
        # the last successfully deployed (params, net_state): what a
        # revived replica must be re-synced onto before re-admission
        self._last_good: Optional[tuple] = None
        self.generation = 0            # completed fleet-wide deploys
        self.canary_failures = 0
        self.rollbacks = 0

    def set_goldens(self, inputs: list) -> None:
        """Replace the golden input set (one example per entry, no
        batch dim — the serving request shape)."""
        with self._lock:
            self._goldens = list(inputs)

    def golden_inputs(self) -> list:
        with self._lock:
            return list(self._goldens)

    # -- expected outputs (from the staged params) --------------------------
    def _expected_outputs(self, server: InferenceServer, params,
                          net_state, bucket: int = 1) -> list:
        """Run each golden input through the replica's batched program
        with the STAGED params directly (no replica touched): the golden
        as row 0 of a zero-padded ``bucket``-row batch, on the staged
        tree in the compute dtype the replica serves in (its
        `compute_params` after the install).  A row's output does not
        depend on the other rows of its batch, so this is the row the
        probe must read when it dispatched in a ``bucket``-row batch."""
        del net_state                  # the port's models carry none
        model = server.model
        staged = server._stage(params)
        tree = model.cast_tree(staged)
        out = []
        for x in self.golden_inputs():
            feats = server._as_feature_tuple(x)
            cols = [np.concatenate(
                [np.asarray(f)[None],
                 np.zeros((bucket - 1,) + np.shape(f), np.asarray(f).dtype)])
                for f in feats]
            rows = server._call_model(cols, None, tree, None)
            out.append(tuple(r[0].float().cpu().numpy() for r in rows))
        return out

    def _canary_check(self, name: str, server: InferenceServer,
                      params, net_state) -> None:
        """Probe one freshly-swapped replica with the golden inputs
        through its REAL serving path, each against the expected output
        at the bucket it dispatched in.  Raises `CanaryError` on any
        non-finite or out-of-tolerance output.  Fault site
        ``serving.canary``: ``corrupt`` perturbs the OBSERVED outputs —
        the deterministic way to provoke the mismatch path."""
        action = faults.maybe_fail("serving.canary")
        expected: dict = {}
        for i, x in enumerate(self.golden_inputs()):
            req = server.submit(x, deadline_s=30.0)
            got = req.result()
            bucket = req.bucket or 1
            if bucket not in expected:
                expected[bucket] = self._expected_outputs(
                    server, params, net_state, bucket)
            want = expected[bucket][i]
            rows = got if isinstance(got, tuple) else (got,)
            if action == "corrupt":
                rows = tuple(np.asarray(r) + 1.0 for r in rows)
            for j, (g, w) in enumerate(zip(rows, want)):
                g = np.asarray(g)
                if not np.isfinite(g).all():
                    raise CanaryError(
                        f"canary {name}: non-finite output {j}"
                    )
                if not np.allclose(g, w, rtol=self.tolerance,
                                   atol=self.tolerance):
                    err = float(np.max(np.abs(g - np.asarray(w))))
                    raise CanaryError(
                        f"canary {name}: output {j} off by {err:.3g} "
                        f"(tolerance {self.tolerance:g})"
                    )

    # -- the rolling deploy ------------------------------------------------
    def deploy(self, params, net_state=None,
               checksum: Optional[int] = None,
               source: str = "api") -> dict:
        """Roll `params` across the fleet replica-by-replica.  Returns
        ``{"installed", "replicas_updated", "rolled_back", "reason",
        "generation"}`` — installed=False means the WHOLE fleet is back
        on its pre-deploy params."""
        with self._deploy_lock:
            return self._deploy_locked(
                params, net_state, checksum, source,
            )

    def _deploy_locked(self, params, net_state, checksum,
                       source: str) -> dict:
        fleet = self.fleet
        live = [(h, srv) for h, srv in zip(fleet.handles, fleet.replicas)
                if not h.dead]
        for h in fleet.handles:
            if h.dead:
                log.warning("fleet deploy %s skipping dead replica %s",
                            source, h.name)
        if not live:
            log.warning("fleet deploy %s touched no replica (all dead)",
                        source)
            return self._result(False, 0, 0, "no_live_replicas")
        check_canary = bool(self.golden_inputs())
        if check_canary:
            try:
                # pre-flight on the first LIVE replica: staged params
                # that cannot even run must never reach a swap
                self._expected_outputs(live[0][1], params, net_state)
            except Exception as exc:
                log.warning("fleet deploy %s aborted before any swap: "
                            "golden eval failed: %s", source, exc)
                return self._result(False, 0, 0, f"golden_eval: {exc}")
        swapped: list[tuple] = []       # (handle, server, old params)
        for h, srv in live:
            # rollback snapshot under the replica's swap lock: a
            # concurrent DIRECT push_weights on this server must not
            # interleave with the read
            with srv._weights_lock:
                old = srv.model.params
            ok = srv.push_weights(
                params, net_state=net_state, checksum=checksum,
                source=f"{source}/deploy:{h.name}",
            )
            if not ok:
                # the verified hot-swap already rolled THIS replica
                # back; undo the rest of the fleet
                return self._roll_back(
                    swapped, source, f"hotswap_rejected:{h.name}",
                )
            swapped.append((h, srv, old))
            if check_canary:
                try:
                    self._canary_check(h.name, srv, params, net_state)
                except Exception as exc:
                    with self._lock:
                        self.canary_failures += 1
                    _count_canary_failure()
                    log.warning("fleet deploy %s canary FAILED on %s: %s",
                                source, h.name, exc)
                    return self._roll_back(
                        swapped, source, f"canary:{h.name}: {exc}",
                    )
        with self._lock:
            self.generation += 1
            gen = self.generation
            self._last_good = (params, net_state)
        _gauge_deploy_generation(gen)
        log.info("fleet deploy %s installed on %d replica(s) "
                 "(generation %d)", source, len(swapped), gen)
        return self._result(True, len(swapped), 0, None)

    def sync_replica(self, index: int) -> bool:
        """Bring ONE replica onto the last successfully deployed
        weights (the revive path): verified hot-swap + canary check,
        like a one-replica rolling deploy.  True when the replica is
        safe to re-admit (also when no deploy has completed yet — the
        factory weights ARE the fleet's weights then)."""
        with self._lock:
            last = self._last_good
        if last is None:
            return True
        params, net_state = last
        srv = self.fleet.replicas[index]
        name = self.fleet.handles[index].name
        if not srv.push_weights(params, net_state=net_state,
                                source=f"revive:{name}"):
            return False
        if self.golden_inputs():
            try:
                self._canary_check(name, srv, params, net_state)
            except Exception as exc:
                with self._lock:
                    self.canary_failures += 1
                _count_canary_failure()
                log.warning("replica %s revive canary FAILED: %s",
                            name, exc)
                return False
        return True

    def deploy_checkpoint(self, path: str, source: Optional[str] = None,
                          include_net_state: bool = True) -> dict:
        """Rolling deploy from a checkpoint zip (written by either
        package): verified + restored ONCE (manifest CRC via
        `ModelSerializer.restore`, on the first replica's device), then
        the params roll out like any other deploy.  A torn/corrupt file
        aborts before any replica is touched."""
        from deeplearning4j_tpu_torch.train.checkpoint import (
            ModelSerializer,
        )

        del include_net_state          # the port's models carry none
        source = source or f"checkpoint:{path}"
        try:
            restored = ModelSerializer.restore(
                path, verify=True,
                device=self.fleet.replicas[0].model.device)
        except Exception as exc:
            log.warning("fleet deploy %s aborted: checkpoint failed "
                        "verification/restore: %s", source, exc)
            return self._result(False, 0, 0, f"checkpoint: {exc}")
        return self.deploy(restored.params, source=source)

    def _roll_back(self, swapped: list, source: str, reason: str) -> dict:
        """Push every already-swapped replica back to its pre-deploy
        params (verified hot-swaps: the rollback is protected like the
        rollout).  The fleet ends exactly where it started."""
        rolled = 0
        for h, srv, old_params in reversed(swapped):
            if srv.push_weights(
                old_params, source=f"{source}/rollback:{h.name}",
            ):
                rolled += 1
            else:
                # the old params were serving moments ago; a rejected
                # rollback means the replica itself is broken — leave it
                # to the router
                log.error("fleet rollback REJECTED on %s — replica left "
                          "for the router to eject", h.name)
        with self._lock:
            self.rollbacks += 1
        log.warning("fleet deploy %s ROLLED BACK (%s): %d replica(s) "
                    "restored", source, reason, rolled)
        return self._result(False, 0, rolled, reason)

    def _result(self, installed: bool, updated: int, rolled: int,
                reason: Optional[str]) -> dict:
        return {
            "installed": installed,
            "replicas_updated": updated,
            "rolled_back": rolled,
            "reason": reason,
            "generation": self.generation,
        }


# -- telemetry helpers ------------------------------------------------------

def _count_canary_failure() -> None:
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        registry().counter("dl4jtpu_canary_failures_total").inc()
    except Exception as e:
        log.debug("canary failure metric failed: %s", e)


def _gauge_deploy_generation(gen: int) -> None:
    try:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        registry().gauge("dl4jtpu_fleet_deploy_generation").set(gen)
    except Exception as e:
        log.debug("deploy generation metric failed: %s", e)
