"""Token-level continuous-batching generation serving — the engine of
`deeplearning4j_tpu/serving/generation.py` in eager PyTorch.

- **one decode step, fixed slot batch** — `GenerationEngine` advances
  ``slots`` sequences one token per step; requests join and leave the
  running batch between steps, never inside one.
- **paged KV** — K/V live in `serving/kv_cache.py` pool pages indexed by
  per-slot page tables; `ops/paged_attention.py` attends one query row
  per slot against them (the paged-attention kernel on CUDA).  An idle
  slot points its whole table at the scratch page and carries seq_len 0.
- **bucketed prefill** — the prompt is padded to a `flags.bucket_length`
  bucket (quantum = a page-size multiple, so prompt K/V lands page
  aligned), runs one dense forward (the flash-forward kernel on CUDA),
  emits the first token (the TTFT moment) and hands its K/V rows to the
  pool.  Prefill returns K/V in f32 whatever the compute dtype, and the
  decode step casts q to f32 before attention, so pages stay f32 (or
  int8) under bf16 compute — as in the JAX engine.
- **the ladder** — admission is a bounded queue (429 when full) and
  KV-pool exhaustion is an explicit ``kv_exhausted`` 429.

- **speculative decoding** (``spec_k`` > 0) — a drafter
  (`serving/speculative.py`) proposes up to k tokens a stream; one
  verify-once dispatch scores the (k + 1)-row chunk of every slot
  through the same pools (`ops.paged_attention.paged_attention_chunk`,
  the paged-attention kernel on S x C pseudo-slots on CUDA) and emits
  the accepted prefix plus the target's own token at the first
  mismatch.  Row ``j`` samples with the plain step's key
  ``fold_in(key(seed), gen_count + j)``, so the output is plain
  decode's token for token.  A drafter that raises latches its stream
  to plain decode; the ``serving.draft`` and ``serving.prefill`` fault
  sites (`runtime/faults.py`) make those paths provokable.
- **the prefill handoff** — `prefill_detached` runs only the prefill and
  returns K/V as host f32 arrays with the first token and the sampling
  state; `join_prefilled` on another engine (f32 or int8 pages) decodes
  the stream on from there.
- **captured steps** — on CUDA the plain step and the verify step are
  each one CUDA graph (`runtime/graphs.py`), captured at the first
  dispatch (again when the model's compute parameters are rebuilt) and
  replayed after: the step's inputs are copied into the graph's static
  buffers, and the tokens, and the host sampler's rows, are read from
  its outputs.  Prefill stays eager (its bucket varies).  On the CPU
  both steps run eagerly.

- **the plane** (as the JAX engine attaches it) — one `StepWatchdog`
  a engine is armed around every dispatch (a verify dispatch with
  ``n_steps = C``, a dispatch that captures a graph with the cold floor
  and disarmed without a sample); its abort (`_on_wedged`) fails every
  in-flight stream, gives back all of their pages and respawns the loop
  under a new generation.  The ``serving.decode`` fault site is
  consulted at the top of every step, inside the arm (``raise`` = a
  failed step, ``delay`` = a wedged one).  Every stream settles through
  ONE fate point (`_finish`): the ``generation.stream`` root span, the
  per-outcome counter, the six-segment latency breakdown (queue /
  prefill / handoff / decode_queue / decode_compute / sampling — the
  host sampler's time is ``sampling``), the slow-stream ring and a
  flight-recorder record (`serving/flight.py`).  Span taxonomy per
  stream: ``generation.admit`` -> ``generation.prefill`` ->
  ``generation.kv_handoff`` -> one ``generation.decode_step`` a step a
  co-resident stream -> ``generation.stream``; the trace context rides
  the `prefill_detached` handoff.
- **``server=``** — attached to an `InferenceServer`, the engine
  snapshots the compute params under the server's weights lock before
  every step (a hot-swap lands between steps; the step after it
  captures a new graph), feeds the shared breaker and answers
  ``/v1/generate``.

Numerics: greedy decode is token-identical to `ops.generation.generate`
at f32 on the CPU (same per-position math), and sampled streams draw on
the same ``(seed, g)`` schedule with the JAX engine's random bits, so a
stream's tokens do not depend on its slot or its neighbours.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.observe import trace as otrace
from deeplearning4j_tpu_torch.ops.generation import (
    _block_prefill,
    _embed,
    _head_logits,
    _ln,
    _pe_rows,
    _plan,
    _sample,
)
from deeplearning4j_tpu_torch.ops.paged_attention import (
    paged_attention,
    paged_attention_chunk,
    ticket_scope,
    tickets_needed,
)
from deeplearning4j_tpu_torch.quant import functional as quantf
from deeplearning4j_tpu_torch.runtime import faults, kernels
from deeplearning4j_tpu_torch.runtime.flags import bucket_length
from deeplearning4j_tpu_torch.runtime.graphs import CapturedProgram
from deeplearning4j_tpu_torch.runtime.watchdog import StepWatchdog
from deeplearning4j_tpu_torch.serving.admission import (
    AdmissionQueue,
    ServingError,
    ServingRejected,
    ServingTimeout,
)
from deeplearning4j_tpu_torch.serving.flight import FlightRecorder
from deeplearning4j_tpu_torch.serving.kv_cache import (
    SCRATCH_PAGE,
    KVPoolExhausted,
    PagedKVCache,
)
from deeplearning4j_tpu_torch.serving import speculative

log = logging.getLogger("deeplearning4j_tpu_torch")

#: slowest-stream exemplars kept per engine
GEN_SLOW_RING_CAP = 16

#: the per-stream latency segments, in lifecycle order (breakdown dict
#: keys, histogram families and the JAX engine share this vocabulary);
#: decode_queue is the residual: slot residency not spent in decode
#: compute or sampling
GEN_BREAKDOWN_SEGMENTS = ("queue", "prefill", "handoff", "decode_queue",
                          "decode_compute", "sampling")

_GEN_BREAKDOWN_FAMILIES = None


def _gen_breakdown_families() -> dict:
    """Segment-name -> histogram, resolved once."""
    global _GEN_BREAKDOWN_FAMILIES
    if _GEN_BREAKDOWN_FAMILIES is None:
        from deeplearning4j_tpu_torch.observe.metrics import registry

        reg = registry()
        _GEN_BREAKDOWN_FAMILIES = {
            seg: reg.histogram(f"dl4jtpu_generation_{seg}_seconds")
            for seg in GEN_BREAKDOWN_SEGMENTS
        }
    return _GEN_BREAKDOWN_FAMILIES


@dataclass
class GenerationConfig:
    """Engine knobs.  ``page_size * max_pages_per_seq`` bounds a stream's
    total length (prompt bucket plus generated tokens)."""

    slots: int = 8                 # decode batch width
    page_size: int = 16            # KV page rows
    num_pages: int = 128           # pool size (page 0 is scratch)
    max_pages_per_seq: int = 8     # page-table width
    kv_dtype: str = "f32"          # f32 | int8 pages
    prefill_quantum: Optional[int] = None   # default: page_size
    max_queue: int = 128
    default_max_new: int = 32
    watchdog_floor_s: float = 30.0
    watchdog_cold_floor_s: float = 600.0   # a dispatch that captures a graph
    watchdog_k: float = 10.0
    poll_s: float = 0.02           # idle-queue poll granularity
    # speculative decoding: draft length per stream per step (0 = off;
    # None = DL4J_TPU_SPEC_K), the drafter (None = DL4J_TPU_SPEC_DRAFTER,
    # default "ngram"), and the small zoo model the "model" drafter runs
    spec_k: Optional[int] = None
    spec_drafter: Optional[str] = None
    spec_draft_model: object = None


class GenerationRequest:
    """One admitted stream.  The client waits on `result()`."""

    _next = [0]
    _next_lock = threading.Lock()

    def __init__(self, prompt, max_new: int, *, temperature: float = 0.0,
                 top_k: int = 0, seed: int = 0, stop_tokens: tuple = (),
                 on_token=None, prefilled=None, spec_k: Optional[int] = None):
        with GenerationRequest._next_lock:
            GenerationRequest._next[0] += 1
            self.rid = f"gen-{GenerationRequest._next[0]}"
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new = int(max_new)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.stop_tokens = tuple(int(t) for t in stop_tokens)
        self.on_token = on_token
        self.prefilled = prefilled     # the `prefill_detached` handoff
        self.pages = 0                 # KV pages funded at admission
        # speculative decode: this stream's draft length (None = the
        # engine's, 0 = plain), the fallback latch, acceptance counts
        self.spec_k = None if spec_k is None else max(0, int(spec_k))
        self.spec_disabled = False
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.tokens: list[int] = []
        self.error: Optional[BaseException] = None
        self.cancelled = False
        self.signature = ("generate",)     # AdmissionQueue grouping key
        self.seq = 0
        self.t_submit = time.perf_counter()
        self.ttft_s: Optional[float] = None
        # observability riders (engine-written; see _finish): trace
        # linkage, latency segments, fate bookkeeping
        self.trace_id: Optional[int] = None
        self.root_span: Optional[int] = None
        self.root_parent: Optional[int] = None
        self.lat: dict = {}            # segment -> seconds
        self.outcome: Optional[str] = None
        self.trace_done = False        # fate settled exactly once
        self.t_offer: Optional[float] = None
        self.t_slot: Optional[float] = None
        self._event = threading.Event()
        self._lock = threading.Lock()

    def _record(self, token: int) -> None:
        with self._lock:
            if self.ttft_s is None:
                self.ttft_s = time.perf_counter() - self.t_submit
            self.tokens.append(int(token))
            idx = len(self.tokens) - 1
        if self.on_token is not None:
            try:
                self.on_token(int(token), idx)
            except Exception:
                log.exception("on_token callback raised")

    def tokens_so_far(self) -> list[int]:
        with self._lock:
            return list(self.tokens)

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def cancel(self) -> None:
        self.cancelled = True

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block for completion; returns prompt + generated tokens."""
        if not self._event.wait(timeout):
            self.cancelled = True
            raise ServingTimeout(
                f"generation {self.rid} incomplete after {timeout}s")
        if self.error is not None:
            raise self.error
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens_so_far(), np.int32)])


def _sample_token(logits, temp: float, top_k: int, seed: int, g: int) -> int:
    """`ops.generation._sample` for one (V,) logits row with this
    stream's parameters; ``g`` is the index of the token generated.  The
    (1, V) noise is the JAX engine's (V,) noise: threefry's partitionable
    layout numbers the elements the same way in both shapes."""
    return int(_sample(logits[None], temperature=temp, top_k=top_k,
                       seed=seed, g=g)[0])


class GenerationEngine:
    """Continuous-batching decode engine over a paged KV pool::

        engine = GenerationEngine(model, GenerationConfig()).start()
        req = engine.submit(prompt_ids, max_new_tokens=32)
        out = req.result(timeout=30)        # prompt + generated tokens
        engine.stop()

    Pass exactly one of ``model`` and ``server=``: attached to an
    `InferenceServer`, the engine snapshots params under the server's
    weights lock (a hot-swap lands between decode steps), feeds the
    shared breaker, and ``server.shed_pressure`` folds in KV occupancy.
    Runs on the model's device; the decode loop is one background
    thread that owns every device call after `start`.
    """

    def __init__(self, model=None, config: Optional[GenerationConfig] = None,
                 *, server=None):
        if (model is None) == (server is None):
            raise ValueError("pass exactly one of model= or server=")
        self.server = server
        self.model = model = server.model if server is not None else model
        if model.params is None:
            model.init()
        self.device = model.device
        self.config = cfg = config or GenerationConfig()
        self._weights_lock = (server._weights_lock if server is not None
                              else threading.Lock())
        self.breaker = server.breaker if server is not None else None
        embed, pos, blocks, head = _plan(model)
        self._stack = (embed, pos, tuple(blocks), head)
        names = [l.name for l in model.conf.layers]
        self._embed_name, self._head_name = names[0], names[-1]
        self._pos_name = pos.name if pos is not None else None
        self._d = embed.n_out
        self._n_heads = blocks[0].n_heads
        self._head_dim = blocks[0].d_model // blocks[0].n_heads

        self.kv = PagedKVCache(
            n_layers=len(blocks), n_heads=self._n_heads,
            head_dim=self._head_dim, num_pages=cfg.num_pages,
            page_size=cfg.page_size, kv_dtype=cfg.kv_dtype,
            device=self.device,
        )
        self._quantum = cfg.prefill_quantum or self.kv.page_size
        if self._quantum % self.kv.page_size:
            raise ValueError(
                f"prefill_quantum {self._quantum} must be a multiple of the "
                f"page size {self.kv.page_size} (prompt KV must land "
                "page-aligned)")

        s, mp = cfg.slots, cfg.max_pages_per_seq
        # host slot state; a step reads copies, so changing it BETWEEN
        # steps is the continuous-batching join
        self._page_tbl = np.full((s, mp), SCRATCH_PAGE, np.int32)
        self._seq_lens = np.zeros(s, np.int32)
        self._last_tok = np.zeros(s, np.int32)
        self._gen_counts = np.zeros(s, np.int32)
        self._temps = np.zeros(s, np.float32)
        self._top_ks = np.zeros(s, np.int32)
        self._seeds = np.zeros(s, np.int64)
        self._slot_req: list[Optional[GenerationRequest]] = [None] * s

        # speculative decode: the engine's draft length and drafter,
        # resolved once; spec_k 0 keeps the verify program unbuilt
        k = (cfg.spec_k if cfg.spec_k is not None
             else speculative.spec_k_from_env(0))
        self.spec_k = max(0, int(k))
        self.drafter: Optional[speculative.DraftSource] = None
        if self.spec_k > 0:
            self.drafter = speculative.make_drafter(
                cfg.spec_drafter or speculative.drafter_from_env(),
                draft_model=cfg.spec_draft_model)
        self._spec_counts = {"drafted": 0, "accepted": 0, "rejected": 0,
                             "bonus": 0, "emitted": 0,
                             "verify_dispatches": 0,
                             "plain_dispatches": 0, "fallbacks": 0}
        # chunk width -> (CapturedProgram, pinned host inputs, the event
        # after their last copy up); CUDA only
        self._captured: dict = {}
        self._captures = 0
        self._recaptures = 0
        self._last_capture_s: Optional[float] = None   # host wall, enqueue

        self.queue = AdmissionQueue(cfg.max_queue)
        self._mu = threading.Lock()        # slot state + loop generation
        self._stop = threading.Event()
        self._loop_gen = 0
        self._thread: Optional[threading.Thread] = None
        self.watchdog = StepWatchdog(
            floor_s=cfg.watchdog_floor_s,
            cold_floor_s=cfg.watchdog_cold_floor_s,
            k=cfg.watchdog_k, abort=self._on_wedged, name="generation")
        # the loop generation that armed the watchdog: a stale loop
        # (wedged, then respawned) must not disarm its successor's step
        self._wd_lock = threading.Lock()
        self._wd_owner: Optional[int] = None
        self._steps = 0
        self._tokens_out = 0
        self._prefills = 0
        self._prefill_s = 0.0          # wall seconds in prefill (host clock)
        self._decode_s = 0.0           # wall seconds in decode steps
        # observability: trace recorder handle, slow-stream ring,
        # breakdown totals, and the flight recorder with its SLO-alert
        # trigger (detached at stop())
        self._rec = otrace.tracer()
        self._stats_lock = threading.Lock()
        self._slow: list[dict] = []
        self._lat_totals = {k: 0.0 for k in GEN_BREAKDOWN_SEGMENTS}
        self._stream_outcomes: dict[str, int] = {}
        self._streams_settled = 0
        self._rate_samples: deque = deque(maxlen=64)  # (t, tokens_out)
        self.flight = FlightRecorder()
        self.flight.context_fn = self._flight_context
        self.flight.attach_slo_trigger()
        if server is not None:
            server.generation_engine = self

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "GenerationEngine":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        with self._mu:
            self._loop_gen += 1
            gen = self._loop_gen
        self._thread = threading.Thread(
            target=self._loop, args=(gen,), name="dl4j-torch-generation",
            daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        for req in self.queue.drain():
            self._finish(req, "shutdown",
                         ServingRejected("shutdown", "engine stopped"))
        with self._mu:
            self._fail_active_locked(
                ServingRejected("shutdown", "engine stopped"),
                outcome="shutdown")
        self.flight.detach_slo_trigger()

    # -- admission ---------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None, *,
               temperature: float = 0.0, top_k: int = 0, seed: int = 0,
               stop_tokens: tuple = (), on_token=None, trace_ctx=None,
               spec_k: Optional[int] = None) -> GenerationRequest:
        """Admit one stream.  Raises `ServingRejected` on a full queue
        or an open breaker; a stream longer than the page table holds is
        a `ValueError`.  ``trace_ctx`` is an upstream ``(trace_id,
        root_span)`` pair; None allocates fresh ids when tracing is on.
        ``spec_k`` lowers the engine's draft length for this stream (0 =
        plain decode; never above the engine's: the verify chunk's width
        is fixed)."""
        max_new = int(max_new_tokens if max_new_tokens is not None
                      else self.config.default_max_new)
        req = GenerationRequest(
            prompt, max_new, temperature=temperature, top_k=top_k,
            seed=seed, stop_tokens=stop_tokens, on_token=on_token,
            spec_k=spec_k)
        self._validate(req)
        self._init_trace(req, trace_ctx)
        self._offer_counted(req)
        return req

    def _offer(self, req: GenerationRequest) -> None:
        if self.breaker is not None and not self.breaker.admits():
            raise ServingRejected(
                "breaker_open", f"circuit breaker is {self.breaker.state}")
        if not self.queue.offer(req):
            raise ServingRejected(
                "queue_full",
                f"generation queue at capacity ({self.queue.max_queue})")

    def _offer_counted(self, req: GenerationRequest) -> None:
        """Offer + admission bookkeeping: a synchronous reject counts as
        a stream outcome (its reason); an accepted stream bumps the
        demand counter and stamps the enqueue mark."""
        try:
            self._offer(req)
        except ServingRejected as exc:
            self._count_stream(exc.reason)
            raise
        req.t_offer = time.perf_counter()
        self._count_admitted()

    def _init_trace(self, req: GenerationRequest, trace_ctx=None) -> None:
        """Allocate (or adopt) the stream's trace linkage BEFORE the
        queue sees it.  No-op when tracing is off."""
        if not self._rec.enabled:
            return
        if trace_ctx is not None:
            req.trace_id, req.root_span = trace_ctx
        else:
            req.trace_id = otrace.next_id()
            req.root_span = otrace.next_id()

    def _trace_segment(self, req: GenerationRequest, name: str,
                       t0_pc: float, dur: float, **args) -> None:
        """One child span of the stream's root chain (no-op untraced)."""
        if req.trace_id is None or not self._rec.enabled:
            return
        self._rec.add_complete(
            name, t0_pc, dur, cat="generation",
            **otrace.trace_args(req.trace_id, otrace.next_id(),
                                req.root_span),
            **args)

    def _validate(self, req: GenerationRequest) -> None:
        t_p = req.prompt.shape[0]
        if t_p < 1:
            raise ValueError("empty prompt")
        if req.max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if req.prompt.min() < 0 or req.prompt.max() >= self._vocab():
            raise ValueError(f"prompt ids must lie in [0, {self._vocab()})")
        span = max(bucket_length(t_p, self._quantum), t_p + req.max_new)
        if self.kv.pages_for(span) > self.config.max_pages_per_seq:
            cap = self.config.max_pages_per_seq * self.kv.page_size
            raise ValueError(
                f"stream needs {span} KV positions; the page table holds "
                f"{cap} (max_pages_per_seq x page_size)")
        _, pos, _, _ = self._stack
        if pos is not None and pos.learned and span > pos.max_length:
            raise ValueError(
                f"stream needs {span} positions; learned PositionalEncoding "
                f"max_length is {pos.max_length}")

    def _vocab(self) -> int:
        return self._stack[0].n_in

    def generate(self, prompt, max_new_tokens: int, *,
                 temperature: float = 0.0, top_k: int = 0, seed: int = 0,
                 stop_tokens: tuple = (),
                 timeout: Optional[float] = 120.0) -> np.ndarray:
        """Submit one stream, wait, return prompt + generated tokens."""
        return self.submit(
            prompt, max_new_tokens, temperature=temperature, top_k=top_k,
            seed=seed, stop_tokens=stop_tokens).result(timeout)

    # -- the prefill handoff between engines --------------------------------
    def prefill_detached(self, prompt, max_new_tokens: int, *,
                         temperature: float = 0.0, top_k: int = 0,
                         seed: int = 0, stop_tokens: tuple = (),
                         trace_ctx=None,
                         spec_k: Optional[int] = None) -> dict:
        """Run only the prefill here, in the caller's thread, and return
        the handoff another engine's `join_prefilled` resumes the stream
        from: the prompt's K/V rows as host f32 arrays (n_layers,
        t_bucket, H, Dh), the first token, the sampling state, and the
        stream's trace context and timing marks (the decoding engine
        extends the same causal chain).  K/V land in whatever pages the
        decoding engine keeps, so an f32 engine can prefill for an
        int8-page one.  Fault site ``serving.prefill``: ``raise`` is a
        `ServingError`."""
        req = GenerationRequest(
            prompt, int(max_new_tokens), temperature=temperature,
            top_k=top_k, seed=seed, stop_tokens=stop_tokens)
        self._validate(req)
        self._init_trace(req, trace_ctx)
        try:
            faults.maybe_fail("serving.prefill")
        except Exception as exc:
            raise ServingError(f"injected prefill fault: {exc}") from exc
        t_pre0 = time.perf_counter()
        k, v, first = self._run_prefill(req)
        k, v = k.cpu().numpy(), v.cpu().numpy()
        pre_s = time.perf_counter() - t_pre0
        self._trace_segment(req, "generation.prefill", t_pre0, pre_s,
                            bucket=int(k.shape[1]), detached=True)
        out = {
            "prompt": req.prompt, "k": k, "v": v,
            "first_token": int(first), "max_new": req.max_new,
            "temperature": req.temperature, "top_k": req.top_k,
            "seed": req.seed, "stop_tokens": req.stop_tokens,
            "t_submit": req.t_submit,      # the stream's TTFT counts from here
            "prefill_s": pre_s,
            "t_done_pc": time.perf_counter(),
        }
        if spec_k is not None:
            out["spec_k"] = max(0, int(spec_k))
        if req.trace_id is not None:
            out["trace"] = (req.trace_id, req.root_span)
        return out

    def join_prefilled(self, handoff: dict, on_token=None) -> GenerationRequest:
        """Admit a stream whose prefill ran elsewhere (`prefill_detached`);
        its first token is already in the handoff.  Adopts the handoff's
        trace context and its prefill timing."""
        req = GenerationRequest(
            handoff["prompt"], handoff["max_new"],
            temperature=handoff["temperature"], top_k=handoff["top_k"],
            seed=handoff["seed"], stop_tokens=handoff["stop_tokens"],
            on_token=on_token, prefilled=handoff,
            spec_k=handoff.get("spec_k"))
        req.t_submit = handoff.get("t_submit", req.t_submit)
        self._validate(req)
        self._init_trace(req, handoff.get("trace"))
        if "prefill_s" in handoff:
            req.lat["prefill"] = float(handoff["prefill_s"])
        self._offer_counted(req)
        return req

    # -- device programs ---------------------------------------------------
    def _compute_params(self) -> dict:
        """The compute-params snapshot a dispatch runs on, taken under
        the weights lock: a hot-swap installs under the same lock, so it
        lands between dispatches."""
        with self._weights_lock:
            return self.model.compute_params()

    @torch.no_grad()
    def _prefill(self, prompt_pad, prompt_len: int, req: GenerationRequest):
        """Bucketed prompt forward; returns (k, v, first_token) with k, v
        (n_layers, t_bucket, H, Dh) f32.  Rows past ``prompt_len`` are
        padding: causal attention keeps them out of every earlier row,
        and their K/V rows sit past seq_len (masked at decode, then
        overwritten as the stream grows into them)."""
        embed, pos, blocks, head = self._stack
        params = self._compute_params()
        with self.model.program_run("prefill", tuple(prompt_pad.shape)):
            x = _embed(embed, params[self._embed_name], prompt_pad)
            if pos is not None:
                x = pos.apply(params.get(self._pos_name, {}), {}, x)[0]
            ks, vs = [], []
            for cfg_b in blocks:
                x, k, v = _block_prefill(cfg_b, params[cfg_b.name], x, None)
                ks.append(k[0])
                vs.append(v[0])
            # (1, D) @ W: the same product shape as the dense reference's
            logits = _head_logits(head, params[self._head_name],
                                  x[:, prompt_len - 1])[0]
        first = _sample_token(logits, req.temperature, req.top_k, req.seed, 0)
        return torch.stack(ks).float(), torch.stack(vs).float(), first

    def _run_prefill(self, req: GenerationRequest):
        # the JAX engine holds seeds as uint32 and converts this one
        # inside its prefill ``try``: outside [0, 2^32) the stream ends
        # there, as a prefill error
        if not 0 <= req.seed < 2**32:
            raise OverflowError(
                f"Python integer {req.seed} out of bounds for uint32")
        t_p = req.prompt.shape[0]
        t_b = bucket_length(t_p, self._quantum)
        pad = np.zeros((1, t_b), np.int64)
        pad[0, :t_p] = req.prompt
        return self._prefill(torch.from_numpy(pad).to(self.device), t_p, req)

    def _inputs(self, page_tbl, seq_lens, toks) -> np.ndarray:
        """The host side of a step of C = ``toks.shape[1]`` rows a slot:
        one int32 vector of positions, pages, rows, tokens and attended
        lengths (each S x C, row s * C + j), then the (S, maxP) table.
        Row ``j`` of slot ``s`` writes position ``seq_len + j``; a row
        past the table's capacity writes row 0 of the scratch page
        (never a clamped index into a live page — only rejected draft
        rows get there), and an idle slot attends nothing."""
        s, c = toks.shape
        mp, ps = page_tbl.shape[1], self.kv.page_size
        cap = mp * ps
        pos2 = seq_lens.astype(np.int64)[:, None] + np.arange(c)[None, :]
        pos = pos2.reshape(-1)
        ok = pos < cap
        page_of = np.where(
            ok, page_tbl[np.repeat(np.arange(s), c), np.minimum(pos // ps, mp - 1)],
            SCRATCH_PAGE)
        row_of = np.where(ok, pos % ps, 0)
        attend = np.where((seq_lens > 0)[:, None], np.minimum(pos2 + 1, cap), 0)
        return np.concatenate([pos, page_of, row_of, toks.reshape(-1),
                               attend.reshape(-1),
                               page_tbl.reshape(-1)]).astype(np.int32)

    @torch.no_grad()
    def _program(self, params, buf, c: int):
        """The device side of a step: ``buf`` is `_inputs` on the device;
        every slot's C rows go through the stack, each layer writing all
        of them into the pools before it attends.  C = 1 is the plain
        step (`paged_attention`), C > 1 the verify (`paged_attention_chunk`).
        Returns (logits (S * C, V) f32, their argmax).  Reads nothing
        from the host, so it can be captured."""
        embed, pos, blocks, head = self._stack
        n_slots, mp = self.config.slots, self.config.max_pages_per_seq
        n = n_slots * c
        h_, dh = self._n_heads, self._head_dim
        quant = self.kv.kv_dtype == "int8"
        pos_idx, page_of, row_of, tok, attend = buf[:5 * n].view(5, n)
        tbl = buf[5 * n:].view(n_slots, mp)
        mm = quantf.matmul
        x_t = _embed(embed, params[self._embed_name], tok.long())
        x_t = x_t + _pe_rows(pos, params.get(self._pos_name, {}), pos_idx,
                             self._d).to(x_t.dtype)
        idx = (page_of.long(), row_of.long())
        for li, cfg_b in enumerate(blocks):
            lp = params[cfg_b.name]
            ap = lp["attn"]
            hh = _ln(lp["ln1"], x_t)
            q = mm(hh, ap["Wq"]).reshape(n, h_, dh)
            k_t = mm(hh, ap["Wk"]).reshape(n, h_, dh)
            v_t = mm(hh, ap["Wv"]).reshape(n, h_, dh)
            self.kv.write_rows(li, *idx, k_t, v_t)
            pools = (self.kv.k_pages[li], self.kv.v_pages[li])
            scales = dict(k_scale=self.kv.k_scales[li] if quant else None,
                          v_scale=self.kv.v_scales[li] if quant else None)
            if c == 1:
                attn = paged_attention(q.float().contiguous(), *pools, tbl,
                                       attend, **scales)
            else:
                attn = paged_attention_chunk(
                    q.float().reshape(n_slots, c, h_, dh).contiguous(), *pools,
                    tbl, attend.view(n_slots, c), **scales)
            x_t = x_t + mm(attn.reshape(n, h_ * dh).to(x_t.dtype), ap["Wo"])
            hh = _ln(lp["ln2"], x_t)
            hh = cfg_b.ffn_activation(mm(hh, lp["W1"]) + lp["b1"])
            x_t = x_t + (mm(hh, lp["W2"]) + lp["b2"])
        logits = _head_logits(head, params[self._head_name], x_t).float()
        return logits, torch.argmax(logits, dim=-1)

    def _step_run(self, c: int):
        """The scope of one run of the step program at C rows a slot
        (`SequentialModel.program_run`): eager, or a capture's warm-up and
        capture.  Its quantized sites count on the first only, as the JAX
        engine's step counts when it is traced; a re-capture after a
        hot-swap counts nothing, as the JAX step is not traced again."""
        return self.model.program_run("step", self.config.slots, c,
                                      self.kv.kv_dtype)

    def _run_eager(self, c: int, host: np.ndarray):
        buf = torch.from_numpy(host).to(self.device)
        with self._step_run(c):
            return self._program(self._compute_params(), buf, c)

    def _replay(self, c: int, host: np.ndarray, on_capture=None):
        """One graph replay for `_inputs` vector ``host``: ((logits,
        argmax), captured).  The graph is captured at the first call for
        C, and again when the model's compute parameters are other
        tensors than the ones it read (`init`, `load_params` — a
        hot-swap — and every training step rebuild them); the decision
        reads the same snapshot the step runs on, and ``on_capture`` is
        called just before a capture.  The stale graph holds the old tree
        until it is dropped here, after its last replay was read back.
        It keeps ticket counters of its own for the paged-attention
        kernel.  The returned tensors are the graph's outputs: the next
        replay overwrites them.  The inputs go up by an asynchronous copy
        from a pinned buffer, so enqueueing a step never waits on the
        card; an event recorded after the copy is waited on before the
        buffer is written again."""
        params = self._compute_params()
        entry = self._captured.get(c)
        if entry is not None and entry[0].keep[0] is not params:
            del self._captured[c]          # frees the stale graph first
            entry = None
            self._recaptures += 1
        if entry is not None:
            prog, pinned, copied = entry
            copied.synchronize()           # the previous copy has read it
            pinned.numpy()[:] = host
            prog.inputs[0].copy_(pinned, non_blocking=True)
            copied.record()
            return prog.replay(), False
        if on_capture is not None:
            on_capture()
        static = torch.from_numpy(host).to(self.device)
        tickets = torch.zeros(
            tickets_needed(self.config.slots * c, self._n_heads,
                           self._head_dim, self.kv.page_size,
                           self.kv.kv_dtype == "int8"),
            dtype=torch.int32, device=self.device)

        def fn(buf):
            with ticket_scope(tickets), self._step_run(c):
                return self._program(params, buf, c)

        t0 = time.perf_counter()
        prog = CapturedProgram(fn, [static], keep=(params, tickets))
        pinned = torch.empty(host.shape, dtype=torch.int32, pin_memory=True)
        self._captured[c] = (prog, pinned, torch.cuda.Event())
        self._captures += 1
        self._last_capture_s = time.perf_counter() - t0
        return prog.replay(), True

    def _run(self, c: int, host: np.ndarray, on_capture=None):
        """One graph replay on CUDA, the eager program on the CPU:
        ((logits, argmax), captured)."""
        if kernels.route(self.device) == "kernel":
            return self._replay(c, host, on_capture)
        return self._run_eager(c, host), False

    def _dispatch(self, my_gen: int, c: int, host: np.ndarray):
        """Enqueue one step under ``_mu``, unless the loop went stale:
        ((logits, argmax) on the device, captured), or None.  Checking
        the loop generation and enqueueing under one lock is what keeps
        a stale loop (wedged, then respawned past) from writing K/V into
        pages `_on_wedged` gave back: either its step was enqueued before
        the release, and so before any write of the new loop on the same
        CUDA stream, or it is never enqueued.  A dispatch that captures a
        graph — the port's compile — is re-armed with the cold floor
        first, and its caller disarms it without a sample.  On CUDA the
        lock covers the enqueue only; the CPU runs the step in it."""
        with self._mu:
            if self._loop_gen != my_gen:
                return None
            return self._run(c, host, on_capture=lambda: self._wd_arm(
                my_gen, n_steps=c, cold=True, step=self._steps))

    # -- the decode loop ---------------------------------------------------
    def _loop(self, my_gen: int) -> None:
        try:
            while not self._stop.is_set():
                with self._mu:
                    if self._loop_gen != my_gen:
                        return
                    n_active = sum(r is not None for r in self._slot_req)
                self._refill(my_gen, block=(n_active == 0))
                with self._mu:
                    if self._loop_gen != my_gen:
                        return
                    n_active = sum(r is not None for r in self._slot_req)
                if n_active:
                    self._decode_step(my_gen)
        except Exception as exc:                      # never die silently
            log.exception("generation loop died")
            with self._mu:
                if self._loop_gen == my_gen:
                    self._fail_active_locked(
                        ServingError(f"generation loop died: {exc}"))

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def _refill(self, my_gen: int, block: bool) -> None:
        """Admit queued streams into free slots, strictly between steps."""
        free = self._free_slots()
        if not free or (self.queue.depth == 0 and not block):
            return
        batch = self.queue.take_batch(len(free), linger_s=0.0,
                                      stop=self._stop,
                                      poll_s=self.config.poll_s)
        t_taken = time.perf_counter()
        for req in batch:
            q0 = req.t_offer if req.t_offer is not None else req.t_submit
            wait = max(0.0, t_taken - q0)
            first_take = "queue" not in req.lat
            req.lat["queue"] = wait
            if first_take:
                # cancelled streams keep the segment too
                self._trace_segment(req, "generation.admit", q0, wait)
            if req.cancelled:
                self._finish(req, "cancelled",
                             ServingRejected("shutdown", "cancelled"))
                continue
            slot = self._free_slots()
            if not slot:
                if not self.queue.offer(req):
                    self._finish(req, "queue_full",
                                 ServingRejected("queue_full", "requeue failed"))
                continue
            self._admit_to_slot(my_gen, slot[0], req)

    def _admit_to_slot(self, my_gen: int, slot: int,
                       req: GenerationRequest) -> None:
        t_p = req.prompt.shape[0]
        t_b = (bucket_length(t_p, self._quantum) if req.prefilled is None
               else int(req.prefilled["k"].shape[1]))
        span = max(t_b, t_p + req.max_new)
        try:
            self.kv.alloc(req.rid, self.kv.pages_for(span))
        except KVPoolExhausted as exc:
            # the explicit 429 — the stream never stalls waiting on pages
            self._finish(req, "kv_exhausted",
                         ServingRejected("kv_exhausted", str(exc)))
            try:
                self.flight.note_kv_exhausted()
            except Exception as e:
                log.debug("kv spike note failed: %s", e)
            return
        req.pages = self.kv.pages_for(span)
        if self._req_spec_k(req) > 0:
            # best-effort overhang so draft rows land in real pages; a
            # short pool sends them to the scratch page instead, never a 429
            table_cap = self.config.max_pages_per_seq * self.kv.page_size
            self.kv.reserve_speculative(
                req.rid, min(span + self.spec_k, table_cap))
        try:
            if req.prefilled is None:
                faults.maybe_fail("serving.prefill")
                t_pre0 = time.perf_counter()
                k, v, first = self._run_prefill(req)
                t_pre1 = time.perf_counter()
                req.lat["prefill"] = t_pre1 - t_pre0
                self._trace_segment(req, "generation.prefill", t_pre0,
                                    t_pre1 - t_pre0, bucket=t_b)
                with self._stats_lock:
                    self._prefills += 1
                    self._prefill_s += t_pre1 - t_pre0
                hand_t0 = None
            else:
                k, v = req.prefilled["k"], req.prefilled["v"]
                first = int(req.prefilled["first_token"])
                hand_t0 = req.prefilled.get("t_done_pc")
            t_w0 = time.perf_counter()
            tbl = self.kv.write_prefill(req.rid, k, v)
            t_w1 = time.perf_counter()
            # a handoff spans from the prefill engine's completion mark;
            # the lat entry leaves out the queue wait "queue" owns
            transfer = (max(0.0, req.t_offer - hand_t0)
                        if hand_t0 is not None and req.t_offer is not None
                        else 0.0)
            req.lat["handoff"] = transfer + (t_w1 - t_w0)
            span_t0 = hand_t0 if hand_t0 is not None else t_w0
            self._trace_segment(req, "generation.kv_handoff", span_t0,
                                max(0.0, t_w1 - span_t0), pages=len(tbl))
        except Exception as exc:
            log.exception("prefill failed")
            self.kv.release(req.rid)
            self._finish(req, "error", ServingError(f"prefill failed: {exc}"))
            return
        req._record(first)
        self._observe_ttft(req)
        self._count_tokens(1)
        if req.max_new <= 1 or first in req.stop_tokens:
            self.kv.release(req.rid)
            self._finish(req, "ok")
            return
        with self._mu:
            if self._loop_gen != my_gen:
                self.kv.release(req.rid)
                self._finish(req, "error",
                             ServingError("engine respawned during admit"))
                return
            row = np.full(self.config.max_pages_per_seq, SCRATCH_PAGE, np.int32)
            row[: len(tbl)] = tbl
            self._page_tbl[slot] = row
            self._seq_lens[slot] = t_p
            self._last_tok[slot] = first
            self._gen_counts[slot] = 1
            self._temps[slot] = req.temperature
            self._top_ks[slot] = req.top_k
            self._seeds[slot] = req.seed
            self._slot_req[slot] = req
            req.t_slot = time.perf_counter()
        self._gauge_occupancy()

    # -- the watchdog's arm, owned by one loop generation --------------------
    def _wd_arm(self, my_gen: int, n_steps: int = 1, cold: bool = False,
                step: Optional[int] = None) -> None:
        """Arm for this loop's next dispatch (``step``, by default the one
        after the last counted) — unless the loop is stale (`_on_wedged`
        bumps the generation under the same lock)."""
        with self._wd_lock:
            if self._loop_gen != my_gen:
                return
            self._wd_owner = my_gen
            self.watchdog.arm(self._steps + 1 if step is None else step,
                              n_steps=n_steps, cold=cold)

    def _wd_disarm(self, my_gen: int, dur: Optional[float]) -> None:
        """Disarm only while this loop still owns the arm: a stale loop
        waking after `_on_wedged` must leave its successor's deadline in
        place."""
        with self._wd_lock:
            if self._wd_owner == my_gen:
                self._wd_owner = None
                self.watchdog.disarm(dur)

    def _decode_step(self, my_gen: int) -> None:
        """One dispatch for every live slot — a verify of drafted chunks
        when any stream drafted, else one plain token — then harvest:
        stop conditions, page release, slot free.  The watchdog is armed
        from the ``serving.decode`` consult to the step's read-back."""
        self._wd_arm(my_gen)
        try:
            faults.maybe_fail("serving.decode")
        except Exception as exc:
            self._wd_disarm(my_gen, None)
            self._step_failed(my_gen, exc)
            return
        if self.drafter is not None:
            drafts = self._gather_drafts(my_gen)
            if drafts is not None:
                self._verify_step(my_gen, drafts)
                return
            with self._stats_lock:
                self._spec_counts["plain_dispatches"] += 1
        with self._mu:
            if self._loop_gen != my_gen:
                self._wd_disarm(my_gen, None)
                return
            page_tbl, seq_lens = self._page_tbl.copy(), self._seq_lens.copy()
            last_tok, seeds = self._last_tok.copy(), self._seeds.copy()
            gen_counts, temps = self._gen_counts.copy(), self._temps.copy()
            top_ks = self._top_ks.copy()
        t_in = time.perf_counter()
        host = self._inputs(page_tbl, seq_lens, last_tok[:, None])
        self._steps += 1
        t0 = time.perf_counter()
        try:
            out = self._dispatch(my_gen, 1, host)
            if out is None:
                self._wd_disarm(my_gen, None)
                return                     # wedged + respawned: stale
            (logits, greedy), captured = out
            nxt = greedy.cpu().numpy().astype(np.int32)
        except Exception as exc:
            self._wd_disarm(my_gen, None)
            self._step_failed(my_gen, exc)
            return
        step_s = time.perf_counter() - t0
        self._wd_disarm(my_gen, None if captured else step_s)
        t_h0 = time.perf_counter()
        active = seq_lens > 0
        for s in np.flatnonzero(active & (temps > 0.0)):
            # the host sampler (`ops.generation._sample`): jax's threefry
            # and Gumbel bits, charged to the "sampling" segment
            nxt[s] = _sample_token(logits[s], float(temps[s]), int(top_ks[s]),
                                   int(seeds[s]), int(gen_counts[s]))
        nxt = np.where(active, nxt, 0)
        # decode_seconds: the step's inputs, dispatch and read-back, and
        # the host sampler
        decode_s = time.perf_counter() - t_in
        finished: list[tuple[GenerationRequest, bool]] = []
        stepped: list[tuple[GenerationRequest, int]] = []
        n_live = 0
        with self._mu:
            if self._loop_gen != my_gen:
                return                     # wedged + respawned: stale
            for s, req in enumerate(self._slot_req):
                if req is None:
                    continue
                if req.cancelled:
                    self._clear_slot(s)
                    finished.append((req, False))
                    continue
                n_live += 1
                tok = int(nxt[s])
                req._record(tok)
                self._seq_lens[s] += 1
                self._gen_counts[s] += 1
                self._last_tok[s] = tok
                stepped.append((req, int(self._gen_counts[s])))
                if self._gen_counts[s] >= req.max_new or tok in req.stop_tokens:
                    self._clear_slot(s)
                    finished.append((req, True))
            if stepped and self._rec.enabled:
                # batch composition: every co-resident stream gets this
                # step's span, tagged with who shared the dispatch
                rids = [r.rid for r, _ in stepped]
                counts = {r.rid: c for r, c in stepped}
                for req, _ in stepped:
                    self._trace_segment(
                        req, "generation.decode_step", t0, step_s,
                        step=self._steps, batch=rids, batch_tokens=counts)
        samp_s = max(0.0, time.perf_counter() - t_h0)
        for req, _ in stepped:
            # each co-resident stream is charged the full step plus the
            # host sampling and harvest
            req.lat["decode_compute"] = req.lat.get("decode_compute", 0.0) + step_s
            req.lat["sampling"] = req.lat.get("sampling", 0.0) + samp_s
        with self._stats_lock:
            self._decode_s += decode_s
        if self.breaker is not None:
            self.breaker.record_success()
        self._count_tokens(n_live)
        self._settle(finished)

    def _settle(self, finished) -> None:
        for req, ok in finished:
            self.kv.release(req.rid)
            if ok:
                self._finish(req, "ok")
            else:
                self._finish(req, "cancelled",
                             ServingRejected("shutdown", "cancelled"))
        self._gauge_occupancy()

    # -- speculative decode ------------------------------------------------
    def _req_spec_k(self, req: GenerationRequest) -> int:
        """A stream's draft length: the engine's, lowered per request,
        zeroed by the fallback latch."""
        if self.drafter is None or req.spec_disabled:
            return 0
        k = self.spec_k if req.spec_k is None else min(req.spec_k, self.spec_k)
        return max(0, k)

    def _gather_drafts(self, my_gen: int) -> Optional[list]:
        """Draft proposals for every live slot (engine thread, between
        dispatches): a per-slot list of int32 arrays, or None when no
        stream drafted.  Fault site ``serving.draft``, once per drafting
        stream: ``raise`` latches the stream to plain decode and gives
        back its overhang pages; ``corrupt`` swaps the proposal for
        deterministic garbage the verify must reject."""
        with self._mu:
            if self._loop_gen != my_gen:
                return None
            live = list(enumerate(self._slot_req))
            gens = self._gen_counts.copy()
        drafts: list = [None] * self.config.slots
        any_draft = False
        for s, req in live:
            if req is None or req.cancelled:
                continue
            # a draft past the remaining budget could never be emitted
            k = min(self._req_spec_k(req), req.max_new - int(gens[s]) - 1)
            if k <= 0:
                continue
            try:
                action = faults.maybe_fail("serving.draft")
            except Exception as exc:
                log.warning("drafter disabled for %s: %s", req.rid, exc)
                self._disable_spec(s, req)
                continue
            hist = np.concatenate(
                [req.prompt, np.asarray(req.tokens_so_far(), np.int32)])
            if action == "corrupt":
                d = ((int(hist[-1]) + 1 + np.arange(k, dtype=np.int32) * 17)
                     % self._vocab()).astype(np.int32)
            else:
                try:
                    d = np.asarray(self.drafter.draft(hist, k),
                                   np.int32).reshape(-1)[:k]
                except Exception as exc:
                    log.warning("drafter failed for %s: %s", req.rid, exc)
                    self._disable_spec(s, req)
                    continue
            if d.size:
                drafts[s] = d
                any_draft = True
        return drafts if any_draft else None

    def _disable_spec(self, s: int, req: GenerationRequest) -> None:
        """Latch one stream to plain decode and give back its overhang
        pages."""
        req.spec_disabled = True
        with self._stats_lock:
            self._spec_counts["fallbacks"] += 1
        freed = self.kv.truncate_to(req.rid, req.pages * self.kv.page_size)
        if freed:
            with self._mu:
                if self._slot_req[s] is req:
                    self._page_tbl[s, req.pages:] = SCRATCH_PAGE

    def _verify_step(self, my_gen: int, drafts: list) -> None:
        """One verify-once dispatch: score every slot's chunk (its last
        token, then its drafts), then emit each stream's accepted prefix
        plus the target's token at the first mismatch (or the bonus
        token after a fully accepted chunk) — 1 to k + 1 tokens a stream,
        plain decode's tokens.  Row ``j`` of a sampled stream draws with
        ``fold_in(key(seed), gen_count + j)``, on the host, and only for
        rows the walk reaches.  The watchdog re-arms with the chunk
        width, so its EWMA stays per token."""
        c = self.spec_k + 1
        n_slots = self.config.slots
        self._wd_arm(my_gen, n_steps=c)
        with self._mu:
            if self._loop_gen != my_gen:
                self._wd_disarm(my_gen, None)
                return
            chunk = np.zeros((n_slots, c), np.int32)
            chunk[:, 0] = self._last_tok
            dl = np.zeros(n_slots, np.int32)
            for s in range(n_slots):
                d = drafts[s]
                if d is None or d.size == 0:
                    continue
                m = min(int(d.size), self.spec_k)
                chunk[s, 1:1 + m] = d[:m]
                dl[s] = m
            gen0 = self._gen_counts.copy()
            seeds, temps, top_ks = (self._seeds.copy(), self._temps.copy(),
                                    self._top_ks.copy())
            page_tbl, seq_lens = self._page_tbl.copy(), self._seq_lens.copy()
        t_in = time.perf_counter()
        host = self._inputs(page_tbl, seq_lens, chunk)
        self._steps += 1
        t0 = time.perf_counter()
        try:
            out = self._dispatch(my_gen, c, host)
            if out is None:
                self._wd_disarm(my_gen, None)
                return                     # wedged + respawned: stale
            (logits, greedy), captured = out
            greedy = greedy.cpu().numpy().astype(np.int32)
        except Exception as exc:
            self._wd_disarm(my_gen, None)
            self._step_failed(my_gen, exc)
            return
        step_s = time.perf_counter() - t0
        self._wd_disarm(my_gen, None if captured else step_s)
        t_h0 = time.perf_counter()

        def token(s: int, j: int) -> int:
            if temps[s] <= 0.0:
                return int(greedy[s * c + j])
            return _sample_token(logits[s * c + j], float(temps[s]),
                                 int(top_ks[s]), int(seeds[s]),
                                 int(gen0[s]) + j)

        sp = {"drafted": 0, "accepted": 0, "rejected": 0, "bonus": 0}
        emitted_total = 0
        finished: list[tuple[GenerationRequest, bool]] = []
        stepped: list[tuple[GenerationRequest, int, int]] = []
        with self._mu:
            if self._loop_gen != my_gen:
                return                     # wedged + respawned: stale
            for s, req in enumerate(self._slot_req):
                if req is None:
                    continue
                if req.cancelled:
                    self._clear_slot(s)
                    finished.append((req, False))
                    continue
                d_len, budget = int(dl[s]), req.max_new - int(gen0[s])
                # walk the chunk: row j is what plain decode emits at
                # that position; a row equal to its draft accepts it and
                # the walk goes on; a stop token ends the stream there
                toks, accepted, fin = [], 0, False
                for j in range(min(d_len + 1, budget)):
                    t = token(s, j)
                    toks.append(t)
                    match = j < d_len and t == int(chunk[s, j + 1])
                    accepted += match
                    if t in req.stop_tokens:
                        fin = True
                        break
                    if not match:
                        break
                emit = len(toks)
                for t in toks:
                    req._record(t)
                self._seq_lens[s] += emit
                self._gen_counts[s] += emit
                self._last_tok[s] = toks[-1]
                sp["drafted"] += d_len
                sp["accepted"] += accepted
                sp["rejected"] += d_len - accepted
                sp["bonus"] += emit - accepted
                req.spec_drafted += d_len
                req.spec_accepted += accepted
                emitted_total += emit
                stepped.append((req, int(self._gen_counts[s]), emit))
                if self._gen_counts[s] >= req.max_new or fin:
                    self._clear_slot(s)
                    finished.append((req, True))
            # decode_seconds: the step's inputs, dispatch and read-back,
            # and the walk
            decode_s = time.perf_counter() - t_in
            if stepped and self._rec.enabled:
                rids = [r.rid for r, _, _ in stepped]
                counts = {r.rid: n for r, n, _ in stepped}
                emits = {r.rid: e for r, _, e in stepped}
                for req, _, _ in stepped:
                    self._trace_segment(
                        req, "generation.decode_step", t0, step_s,
                        step=self._steps, batch=rids, batch_tokens=counts,
                        emitted=emits, speculative=True)
        samp_s = max(0.0, time.perf_counter() - t_h0)
        for req, _, _ in stepped:
            req.lat["decode_compute"] = req.lat.get("decode_compute", 0.0) + step_s
            req.lat["sampling"] = req.lat.get("sampling", 0.0) + samp_s
        with self._stats_lock:
            self._decode_s += decode_s
        if self.breaker is not None:
            self.breaker.record_success()
        self._count_tokens(emitted_total)
        self._count_spec(sp, emitted_total)
        self._settle(finished)

    def _count_spec(self, sp: dict, emitted: int) -> None:
        """One verify dispatch's speculative accounting: host counters
        for stats() plus the ``dl4jtpu_spec_*`` families."""
        with self._stats_lock:
            for kind, v in sp.items():
                self._spec_counts[kind] += v
            self._spec_counts["emitted"] += emitted
            self._spec_counts["verify_dispatches"] += 1
            drafted = self._spec_counts["drafted"]
            ratio = (self._spec_counts["accepted"] / drafted
                     if drafted else 0.0)
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            reg = registry()
            ctr = reg.counter("dl4jtpu_spec_tokens_total")
            for kind, v in sp.items():
                if v:
                    ctr.inc(v, kind=kind)
            reg.gauge("dl4jtpu_spec_acceptance_ratio").set(round(ratio, 4))
            reg.histogram("dl4jtpu_spec_tokens_per_dispatch").observe(emitted)
        except Exception as e:
            log.debug("spec metric failed: %s", e)

    def _clear_slot(self, s: int) -> None:
        """Caller holds self._mu; the caller releases the pages."""
        self._slot_req[s] = None
        self._page_tbl[s, :] = SCRATCH_PAGE
        self._seq_lens[s] = 0
        self._last_tok[s] = 0
        self._gen_counts[s] = 0
        self._temps[s] = 0.0
        self._top_ks[s] = 0
        self._seeds[s] = 0

    # -- failure paths -----------------------------------------------------
    def _step_failed(self, my_gen: int, exc: BaseException) -> None:
        log.error("generation decode step failed: %s", exc)
        tripped = False
        if self.breaker is not None:
            was = self.breaker.state
            self.breaker.record_failure()
            tripped = was != "open" and self.breaker.state == "open"
        with self._mu:
            if self._loop_gen != my_gen:
                return
            self._fail_active_locked(ServingError(f"decode step failed: {exc}"))
        self._gauge_occupancy()
        if tripped:
            try:
                self.flight.dump("breaker_open", context={"error": str(exc)})
            except Exception as e:
                log.debug("breaker flight dump failed: %s", e)

    def _fail_active_locked(self, exc: BaseException,
                            outcome: str = "error") -> None:
        """Caller holds self._mu: fail every in-flight stream and release
        all of their pages.  Every stream settles through `_finish`."""
        for s, req in enumerate(self._slot_req):
            if req is None:
                continue
            self._clear_slot(s)
            self.kv.release(req.rid)
            self._finish(req, outcome, exc)

    def _on_wedged(self, event: dict) -> None:
        """Watchdog abort: the dispatched step never returned.  Fail
        every in-flight stream, release all of their pages, trip the
        breaker, and respawn the loop under a new generation — the
        wedged thread's eventual return sees a stale generation and
        drops its harvest."""
        log.error("generation decode step wedged: %s", event)
        if self.breaker is not None:
            self.breaker.record_failure()
        with self._mu:
            with self._wd_lock:
                self._loop_gen += 1
                gen = self._loop_gen
                self._wd_owner = None
                self.watchdog.disarm(None)
            # The pools are written in place, so a freed page may still
            # have a write of the wedged step ahead of it.  That is safe:
            # `_dispatch` enqueues under this lock after checking the
            # generation, so the stale step either was enqueued before
            # this release — and so, on the one CUDA stream every loop
            # and prefill writes on, runs before any write of the new
            # loop into these pages — or is never enqueued.  The new loop
            # captures fresh graphs (own static inputs and pinned buffer),
            # so the stale thread's replay shares nothing with it.
            self._fail_active_locked(
                ServingError(f"decode step wedged: {event.get('stage')}"),
                outcome="wedged")
            if self._captured:
                self._recaptures += len(self._captured)
                self._captured = {}
        self._gauge_occupancy()
        try:
            self.flight.dump("watchdog_abort", context=dict(event))
        except Exception as e:
            log.debug("watchdog flight dump failed: %s", e)
        if not self._stop.is_set():
            self._thread = threading.Thread(
                target=self._loop, args=(gen,), name="dl4j-torch-generation",
                daemon=True)
            self._thread.start()

    # -- the fate point ----------------------------------------------------
    def _finish(self, req: GenerationRequest, outcome: str,
                exc: Optional[BaseException] = None) -> None:
        """Settle one stream EXACTLY ONCE: finalize the latency
        breakdown, record the ``generation.stream`` root span, bump the
        per-outcome counter, offer the stream to the slow ring, append
        the flight record, then release the client.  Racing settlers
        claim via `trace_done` under the request lock."""
        with req._lock:
            if req.trace_done:
                return
            req.trace_done = True
            req.outcome = outcome
        t_fate = time.perf_counter()
        latency = max(0.0, t_fate - req.t_submit)
        if req.t_slot is not None:
            resid = (t_fate - req.t_slot
                     - req.lat.get("decode_compute", 0.0)
                     - req.lat.get("sampling", 0.0))
            req.lat["decode_queue"] = max(0.0, resid)
        self._observe_breakdown(req.lat)
        self._count_stream(outcome)
        if req.trace_id is not None and self._rec.enabled:
            args = dict(otrace.trace_args(req.trace_id, req.root_span,
                                          req.root_parent))
            if exc is not None:
                args["error"] = str(exc)
            self._rec.add_complete(
                "generation.stream", req.t_submit, latency,
                cat="generation", outcome=outcome, rid=req.rid,
                tokens=len(req.tokens), **args)
        self._note_slow(req, outcome, latency)
        self._flight_record(req, outcome, latency, exc)
        if exc is not None:
            req.error = exc
        req._event.set()

    def _note_slow(self, req: GenerationRequest, outcome: str,
                   latency_s: float) -> None:
        """Offer one settled stream to the slowest-streams ring (bounded,
        latency-descending)."""
        entry = {
            "kind": "generate",
            "rid": req.rid,
            "trace": (f"{req.trace_id:x}" if req.trace_id is not None
                      else None),
            "trace_id": req.trace_id,
            "outcome": outcome,
            "latency_s": round(latency_s, 6),
            "ttft_s": (round(req.ttft_s, 6) if req.ttft_s is not None
                       else None),
            "tokens": len(req.tokens),
            "t_wall": time.time(),
            "breakdown_s": {k: round(v, 6) for k, v in req.lat.items()},
        }
        with self._stats_lock:
            slow = self._slow
            if len(slow) >= GEN_SLOW_RING_CAP and \
                    latency_s <= slow[-1]["latency_s"]:
                return
            slow.append(entry)
            slow.sort(key=lambda e: -e["latency_s"])
            del slow[GEN_SLOW_RING_CAP:]

    def slow_streams(self, spans: bool = True) -> list[dict]:
        """The slowest-stream exemplars (latency-descending), each with
        its breakdown and — when tracing is on — its causal span chain."""
        with self._stats_lock:
            out = [dict(e) for e in self._slow]
        if spans and self._rec.enabled:
            for e in out:
                if e["trace_id"] is not None:
                    e["spans"] = self._rec.trace_chain(e["trace_id"])
        for e in out:
            e.pop("trace_id", None)
        return out

    def _flight_record(self, req: GenerationRequest, outcome: str,
                       latency_s: float,
                       exc: Optional[BaseException]) -> None:
        try:
            self.flight.record({
                "rid": req.rid,
                "trace": (f"{req.trace_id:x}"
                          if req.trace_id is not None else None),
                "outcome": outcome,
                "error": str(exc) if exc is not None else None,
                "prompt_len": int(req.prompt.shape[0]),
                "max_new": req.max_new,
                "tokens": len(req.tokens),
                "ttft_s": req.ttft_s,
                "latency_s": round(latency_s, 6),
                "pages_held": req.pages,
                "breakdown_s": {k: round(v, 6) for k, v in req.lat.items()},
                "t_wall": time.time(),
            })
        except Exception as e:
            log.debug("flight record failed: %s", e)

    def _flight_context(self) -> dict:
        """Engine/KV snapshot merged into every flight dump."""
        return {"stats": self.stats()}

    # -- introspection -----------------------------------------------------
    def active_streams(self) -> int:
        with self._mu:
            return sum(r is not None for r in self._slot_req)

    def drain(self, timeout: float = 30.0) -> bool:
        """True when no stream is in flight and the queue is empty
        within ``timeout``."""
        t_end = time.monotonic() + timeout
        while time.monotonic() < t_end:
            if self.active_streams() == 0 and self.queue.depth == 0:
                return True
            time.sleep(self.config.poll_s)
        return False

    def stats(self) -> dict:
        active = self.active_streams()
        with self._stats_lock:
            totals = dict(self._lat_totals)
            outcomes = dict(self._stream_outcomes)
            settled = self._streams_settled
            slow_n = len(self._slow)
            spec = dict(self._spec_counts)
        total_s = sum(totals.values())
        # per-token view: a speculative step emits 1..k+1 tokens a
        # dispatch, so comparisons read seconds_per_token
        n_tok = max(1, self._tokens_out)
        breakdown = {
            k: {
                "seconds_total": round(v, 6),
                "fraction": round(v / total_s, 4) if total_s > 0 else 0.0,
                "seconds_per_token": round(v / n_tok, 9),
            }
            for k, v in totals.items()
        }
        drafted, verifies = spec["drafted"], spec["verify_dispatches"]
        return {
            "slots": self.config.slots,
            "active_streams": active,
            "queue_depth": self.queue.depth,
            "decode_steps": self._steps,
            "decode_seconds": self._decode_s,
            "prefills": self._prefills,
            "prefill_seconds": self._prefill_s,
            "tokens_generated": self._tokens_out,
            "tokens_per_s": round(self.tokens_per_s(), 4),
            "graph_captures": self._captures,
            "graph_recaptures": self._recaptures,
            "last_capture_s": self._last_capture_s,
            "outcomes": outcomes,
            "streams": {"settled": settled, "outcomes": outcomes},
            "latency_breakdown": breakdown,
            "slow_streams": slow_n,
            "flight": {"records": len(self.flight),
                       "dumps": self.flight.dumps_written},
            "kv": self.kv.stats(),
            "speculative": {
                "enabled": self.spec_k > 0,
                "k": self.spec_k,
                "drafter": (self.drafter.name
                            if self.drafter is not None else None),
                "drafted": drafted,
                "accepted": spec["accepted"],
                "rejected": spec["rejected"],
                "bonus": spec["bonus"],
                "acceptance_ratio": (round(spec["accepted"] / drafted, 4)
                                     if drafted else 0.0),
                "verify_dispatches": verifies,
                "plain_dispatches": spec["plain_dispatches"],
                "tokens_per_dispatch": (round(spec["emitted"] / verifies, 4)
                                        if verifies else 0.0),
                "fallbacks": spec["fallbacks"],
            },
        }

    def health_summary(self) -> dict:
        """Compact generation block for `InferenceServer.health()`."""
        active = self.active_streams()
        with self._stats_lock:
            outcomes = dict(self._stream_outcomes)
            drafted = self._spec_counts["drafted"]
            accepted = self._spec_counts["accepted"]
        out = {
            "active_streams": active,
            "queue_depth": self.queue.depth,
            "kv_occupancy": round(self.kv.occupancy(), 4),
            "tokens_per_s": round(self.tokens_per_s(), 4),
            "stream_outcomes": outcomes,
            "flight_dumps": self.flight.dumps_written,
        }
        if self.spec_k > 0:
            out["spec_acceptance_ratio"] = (
                round(accepted / drafted, 4) if drafted else 0.0)
        return out

    def tokens_per_s(self) -> float:
        """Recent aggregate decode rate over the trailing rate-sample
        window (0.0 until two samples exist)."""
        with self._stats_lock:
            if len(self._rate_samples) < 2:
                return 0.0
            t0, n0 = self._rate_samples[0]
            t1, n1 = self._rate_samples[-1]
        dt = t1 - t0
        return (n1 - n0) / dt if dt > 0 else 0.0

    # -- telemetry ---------------------------------------------------------
    def _count_tokens(self, n: int) -> None:
        if n <= 0:
            return
        now = time.perf_counter()
        with self._stats_lock:
            self._tokens_out += n
            self._rate_samples.append((now, self._tokens_out))
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            reg = registry()
            reg.counter("dl4jtpu_decode_tokens_total").inc(n)
            reg.gauge("dl4jtpu_generation_tokens_per_s").set(
                round(self.tokens_per_s(), 4))
        except Exception as e:
            log.debug("decode token metric failed: %s", e)

    def _count_stream(self, outcome: str) -> None:
        """One settled (or synchronously rejected) stream, by outcome."""
        with self._stats_lock:
            self._streams_settled += 1
            self._stream_outcomes[outcome] = (
                self._stream_outcomes.get(outcome, 0) + 1)
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().counter("dl4jtpu_generation_streams_total").inc(
                outcome=outcome)
        except Exception as e:
            log.debug("stream outcome metric failed: %s", e)

    def _count_admitted(self) -> None:
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            registry().counter(
                "dl4jtpu_generation_streams_admitted_total").inc()
        except Exception as e:
            log.debug("admitted stream metric failed: %s", e)

    def _observe_breakdown(self, lat: dict) -> None:
        try:
            fams = _gen_breakdown_families()
            with self._stats_lock:
                for seg in GEN_BREAKDOWN_SEGMENTS:
                    v = lat.get(seg)
                    if v is None:
                        continue
                    self._lat_totals[seg] += v
                    fams[seg].observe(v)
        except Exception as e:
            log.debug("generation breakdown observe failed: %s", e)

    def _observe_ttft(self, req: GenerationRequest) -> None:
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            if req.ttft_s is not None:
                registry().histogram("dl4jtpu_ttft_seconds").observe(req.ttft_s)
        except Exception as e:
            log.debug("ttft metric failed: %s", e)

    def _gauge_occupancy(self) -> None:
        try:
            from deeplearning4j_tpu_torch.observe.metrics import registry

            active = self.active_streams()
            registry().gauge("dl4jtpu_decode_batch_occupancy").set(
                active / max(1, self.config.slots))
        except Exception as e:
            log.debug("occupancy gauge failed: %s", e)
